"""
The port's span-and-counter recorder (libdmet_preview_tpu_torch/utils/
timer.py) on the CPU: the span tree of a two-iteration run_dmet on a small
Hubbard chain with its job and iteration ids, the span counts against the
program's own counters (FCI.n_sigma, FCI.n_run, _cg_engine.steps), no
synchronise while a recording is open (one per device at its close, with
fake CUDA events standing in for the card's), nothing recorded and the
same values read with the recorder off, the profiler's clock shared with
the spans (utils.profile.device_trace writes both into one trace), and the
benchmark's six readers of the recording.
"""

import json
import math

import numpy as np
import pytest
import torch

from libdmet_preview_tpu_torch.utils import timer

torch.set_num_threads(1)
CPU = torch.device("cpu")
N_ITER = 2

# (span, its parent) along run_dmet's tree
TREE = [("mean field", "dmet iteration"), ("bath", "dmet iteration"),
        ("H1", "dmet iteration"), ("H2", "dmet iteration"),
        ("impurity solves", "dmet iteration"), ("energy", "dmet iteration"),
        ("vcor fit", "dmet iteration"), ("mu step", "impurity solves"),
        ("davidson iteration", "mu step"),
        ("fci sigma", "davidson iteration"), ("cg step", "vcor fit")]

READERS = ["mu_solves_per_iter", "solver_reads_per_iter",
           "fit_reads_per_iter", "solver_host_self_s_per_iter",
           "fit_host_self_s_per_iter", "fci_sigma_span_roofline"]


def _run_dmet(n_iter=N_ITER):
    import libdmet_preview_tpu_torch.dmet.hubbard as dmet
    from libdmet_preview_tpu_torch.dmet.loop import run_dmet
    from libdmet_preview_tpu_torch.ops import fit
    from libdmet_preview_tpu_torch.solvers import FCI
    from libdmet_preview_tpu_torch.utils.config import DmetConfig
    Lat = dmet.ChainLattice(8, 2)
    Lat.set_Ham(dmet.Ham(Lat, 4.0), use_hcore_as_emb_ham=True, device=CPU)
    vcor = dmet.PMInitGuess([2], 4.0, 0.5)
    cfg = DmetConfig(filling=0.5, restricted=False, int_bath=False,
                     max_iter=n_iter)
    fci = FCI(restricted=False, tol=1e-10, device=CPU)
    fit._cg_engine.steps = 0
    res = run_dmet(Lat, vcor, cfg, solver=fci)
    return res, fci, fit._cg_engine.steps


@pytest.fixture(scope="module")
def recorded():
    """(recording, result, solver, CG steps) of one two-iteration job."""
    with timer.recording() as rec:
        res, fci, steps = _run_dmet()
    assert timer.last() is rec
    return rec, res, fci, steps


def test_one_dmet_iteration_span_per_iteration(recorded):
    rec, res, _, _ = recorded
    its = rec.named("dmet iteration")
    assert len(its) == len(res.history) == N_ITER
    assert [s.iteration for s in its] == list(range(N_ITER))
    assert all(s.parent is None for s in its)
    assert len({s.job for s in its}) == 1 and its[0].job is not None
    assert len(rec["dmet iteration"]) == N_ITER


@pytest.mark.parametrize("child,parent", TREE)
def test_span_tree_and_ids(recorded, child, parent):
    """Every span of a name sits under its parent in the tree, carries the
    job id and the iteration of the dmet iteration above it, and began and
    ended inside its parent on the host clock."""
    rec = recorded[0]
    spans = rec.named(child)
    assert spans
    for s in spans:
        assert s.parent.name == parent
        top = s
        while top.parent is not None:
            top = top.parent
        assert top.name == "dmet iteration"
        assert (s.job, s.iteration) == (top.job, top.iteration)
        assert s.parent.t0 <= s.t0 <= s.t1 <= s.parent.t1
        assert s.seconds == pytest.approx(s.host_s) and not s.device_timed
    assert len(rec[child]) == len(spans)


@pytest.mark.parametrize("span,counter", [
    ("fci sigma", "n_sigma"), ("mu step", "n_run"), ("cg step", "steps")])
def test_span_counts_equal_the_program_counters(recorded, span, counter):
    rec, _, fci, steps = recorded
    expect = steps if counter == "steps" else getattr(fci, counter)
    assert expect > 0 and len(rec.named(span)) == expect


def test_sigma_spans_carry_the_ci_space(recorded):
    s = recorded[0].named("fci sigma")[0]
    assert s.attrs == {"norb": 4, "nelec_a": 2, "nelec_b": 2}
    assert isinstance(recorded[0].named("mu step")[0].attrs["dmu"], float)


def test_reads_are_counted_where_they_happen(recorded):
    """Host reads: the CG's step decision and Armijo trials, the Davidson's
    subspace matrix and norms; each with the seconds it blocked."""
    rec = recorded[0]
    for s in rec.named("cg step"):
        assert s.counts[timer.READS] >= 2
    assert all(s.counts[timer.READS] >= 2
               for s in rec.named("davidson iteration"))
    inner = rec.total(timer.READS, within="impurity solves") \
        + rec.total(timer.READS, within="vcor fit")
    assert 0 < inner < rec.total(timer.READS)
    assert 0.0 < rec.read_seconds(within="vcor fit") \
        < rec.host_seconds("vcor fit")


def _fake_card(monkeypatch, calls):
    """CUDA events and synchronize stood in for on the CPU: an event
    stamps a counter when recorded; synchronize appends to `calls`."""
    ticks = iter(range(1, 10 ** 6))

    class Event(object):
        def __init__(self, enable_timing=False):
            assert enable_timing

        def record(self, stream=None):
            self.ms = next(ticks)

        def elapsed_time(self, end):
            return float(end.ms - self.ms)

    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None: None)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda dev=None: calls.append((dev, timer._rec)))


def _no_sync(monkeypatch):
    def fail(*a, **k):
        raise AssertionError("synchronised while recording")
    monkeypatch.setattr(torch.cuda, "synchronize", fail)
    monkeypatch.setattr(timer, "_sync", fail)


@pytest.mark.parametrize("case", ["run_dmet", "card events"])
def test_no_span_synchronises(monkeypatch, case):
    """run_dmet's spans never synchronise; spans on a CUDA device record a
    pair of events and their recording resolves them with one synchronize
    per device, at its close, into device seconds."""
    if case == "run_dmet":
        _no_sync(monkeypatch)
        with timer.recording() as rec:
            _run_dmet(1)
        assert len(rec["dmet iteration"]) == 1
        return
    calls = []
    _fake_card(monkeypatch, calls)
    with timer.recording() as rec:
        with timer.stage("outer", "cuda"):
            with timer.stage("inner", torch.device("cuda", 0)):
                timer.count("launches", 3)
            with timer.stage("host", None):
                pass
        assert calls == [] and rec == {}
    assert calls == [(0, None)]
    assert rec == {"outer": [pytest.approx(3e-3)],
                   "inner": [pytest.approx(1e-3)],
                   "host": [pytest.approx(rec.named("host")[0].host_s)]}
    assert [s.device_timed for s in rec.spans] == [True, True, False]
    assert rec.total("launches") == 3 == rec.named("inner")[0].counts[
        "launches"]


@pytest.mark.parametrize("read,expect", [
    (None, np.array([1.5, -2.0])), (float, None), (bool, None),
    (torch.Tensor.tolist, [1.5, -2.0])])
def test_off_path_records_nothing_and_reads_the_same(read, expect):
    x = torch.tensor([1.5, -2.0], dtype=torch.float64)
    if read in (float, bool):
        x = x[0]
        expect = read(x)
    args = () if read is None else (read,)
    before = timer.last()
    assert not timer.is_recording()
    with timer.stage("nothing", CPU):
        timer.count("n")
        off = timer.to_host(x, *args)
    assert timer.last() is before and timer._rec is None \
        and timer._span is None
    with timer.recording() as rec:
        with timer.stage("read", CPU):
            on = timer.to_host(x, *args)
    np.testing.assert_array_equal(off, expect)
    np.testing.assert_array_equal(on, expect)
    assert type(off) is type(on)
    assert rec.named("read")[0].counts == {timer.READS: 1}


def test_nested_recordings_share_spans():
    with timer.recording() as outer:
        with timer.stage("a"):
            pass
        with timer.recording() as inner:
            with timer.stage("b"):
                timer.count("c")
        assert list(inner) == ["b"] and outer == {}
    assert list(outer) == ["a", "b"] and timer.last() is outer
    assert outer.total("c") == inner.total("c") == 1


def test_spans_share_the_profilers_clock(tmp_path):
    """A span around a matrix product encloses the profiler's aten::mm
    event on one time base; device_trace writes the span into the same
    Chrome trace around it."""
    from torch.profiler import ProfilerActivity, profile
    from libdmet_preview_tpu_torch.utils import profile as prof_mod
    a = torch.randn(64, 64, dtype=torch.float64)
    with timer.recording() as rec:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with timer.stage("around", CPU):
                a @ a
    span = rec.named("around")[0]
    mm = [e for e in prof.profiler.kineto_results.events()
          if e.name() == "aten::mm"]
    assert len(mm) == 1
    assert span.t0 <= mm[0].start_ns()
    assert mm[0].start_ns() + mm[0].duration_ns() <= span.t1

    with prof_mod.device_trace(str(tmp_path)):
        with timer.stage("around", CPU):
            a @ a
    with open(tmp_path / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    span = [e for e in events if e.get("cat") == "program span"]
    mm = [e for e in events if e.get("name") == "aten::mm"]
    assert len(span) == 1 and len(mm) == 1
    assert span[0]["name"] == "around"
    assert span[0]["ts"] <= mm[0]["ts"]
    assert mm[0]["ts"] + mm[0]["dur"] <= span[0]["ts"] + span[0]["dur"]


@pytest.mark.parametrize("name", READERS)
def test_benchmark_readers_of_the_recording(monkeypatch, recorded, name):
    """Each reader gives a finite value per iteration from the recording,
    consistent with the program's counters; the roofline share reads only
    spans the card timed, and nothing reads without iterations or without
    its span."""
    from perfbench import harness
    rec, _, fci, steps = recorded
    read = harness.reader(name)
    monkeypatch.setattr(timer, "_last", rec)
    value = read({"iterations": N_ITER})
    if name == "fci_sigma_span_roofline":
        assert value is None
    else:
        assert value is not None and math.isfinite(value) and value > 0
    if name == "mu_solves_per_iter":
        assert value * N_ITER == fci.n_run
    assert read({"window_s": 1.0}) is None
    monkeypatch.setattr(timer, "_last", timer.Recording(None))
    assert read({"iterations": N_ITER}) is None


def test_span_roofline_reader_of_card_spans(monkeypatch):
    """The roofline share from spans the card timed: the summed bound of
    each span's sigma work over their device seconds."""
    from perfbench import harness, roofline
    rec = timer.Recording(None)
    for key, seconds in [((12, 6, 6), 0.01), ((12, 6, 6), 0.02),
                         ((4, 2, 2), 0.001)]:
        s = timer.Span("fci sigma", None, 0, 0, dict(
            zip(("norb", "nelec_a", "nelec_b"), key)))
        s.device_timed, s.seconds = True, seconds
        rec.spans.append(s)
    monkeypatch.setattr(timer, "_last", rec)
    bound = 2 * roofline.bound_s(*roofline.sigma_work(12, 6, 6)) \
        + roofline.bound_s(*roofline.sigma_work(4, 2, 2))
    value = harness.reader("fci_sigma_span_roofline")({"iterations": 3})
    assert value == pytest.approx(100.0 * bound / 0.031, rel=1e-12)
