"""The harness: BENCHMARK.json against its contract, every file of every
cell found by name, a whole run on the CPU test cell (the chip look
skipped), the run refused with a JAX module loaded, and correct coming out
false with the timed path broken underneath."""

import json
import re
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench import faults, harness
from perfbench.protocols import closed_jobs

PKG = Path(__file__).resolve().parents[1]
REPO = PKG.parent
DATA = Path(__file__).resolve().parent / "data"
CPU = torch.device("cpu")
TEST_CELL = "threeband_hanke_6x6.dmet_loop"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(autouse=True)
def _one_thread():
    """One host thread, as run.py sets it: the runs are many small host
    operations, and the thread pools of several test workers spinning
    against each other slow them fifty-fold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def bench():
    with open(REPO / "BENCHMARK.json") as f:
        return json.load(f)


def test_manifest_keys_and_names(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["perfbench"]
    assert bench["command"] == ["python3", "perfbench/run.py"]
    names = []
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("perfbench/") and (REPO / c["file"]) \
            .is_file()
        names.append(c["name"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        names.append(w["name"])
    metrics = bench["end_to_end"] + bench["per_layer"]
    for m in metrics:
        allowed = {"name", "unit", "better", "source", "workloads"}
        allowed |= {"bound"} if m in bench["end_to_end"] else {"layer",
                                                               "moves"}
        assert set(m) <= allowed and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        names.append(m["name"])
    for n in names + [w["traffic"] for w in bench["workloads"]]:
        assert NAME.match(n), n
    assert len(set(names)) == len(names)
    assert [m["name"] for m in bench["end_to_end"]] == [
        "dmet_iter_s", "peak_mem_gib", "setup_s"]
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert m["moves"] == "dmet_iter_s"
    assert len(json.dumps(bench)) < 64 * 1024


def test_run_seconds_fits_the_check_with_24_cells(bench):
    rs = bench["run_seconds"]
    assert 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_every_cell_finds_its_files(bench):
    files = harness.Files()
    used = set()
    for w in bench["workloads"]:
        cfg = files.config(w["config"])
        assert cfg["name"] == w["config"]
        used.add(w["config"])
        mix = files.mix(w["traffic"])
        assert 0.0 < mix["filling"] < 1.0 and mix["max_iter"] >= 1
        assert callable(harness.protocol(mix).run)
        limits = files.limits(w["name"])
        assert all(v["limit"] > 0 for v in limits.values())
        assert callable(harness.adapter(cfg).judge)
        for kind in ("end_to_end", "per_layer"):
            assert files.metrics(kind, w["name"])
            for m in files.metrics(kind, w["name"]):
                assert callable(harness.reader(m["name"]))
    assert used == {c["name"] for c in bench["configs"]}


def test_config_files_hold_the_source(bench):
    for c in bench["configs"]:
        with open(REPO / c["file"]) as f:
            cfg = json.load(f)
        assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]


def test_metric_readers_leave_out_what_they_cannot_read():
    empty = {"window_s": 1.0, "busy_s": 0.0, "spans": {}, "counters": {},
             "sigma": {}}
    for path in sorted((PKG / "metrics").glob("*.py")):
        if path.stem != "__init__":
            assert harness.reader(path.stem)(empty) is None, path.stem


def test_every_seed_meets_the_same_starts_in_its_own_order():
    cj = closed_jobs
    mix = harness.Files().mix("dmet_loop")
    s = cj.starts(mix, 42)
    assert len(s) == 3 and not np.array_equal(s[0], s[1])
    assert all(np.array_equal(a, b) for a, b in zip(s, cj.starts(mix, 42)))
    orders = {tuple(cj.round_order(3, 2 ** 31 + k)) for k in range(20)}
    assert len(orders) > 1 and all(sorted(o) == [0, 1, 2] for o in orders)
    assert 0 <= cj.judged_job(3, -5) < 3
    assert cj.judged_iterations(7, 2 ** 40, 3)[-1] == 6


def _run(trace=False, seconds=0.0):
    files = harness.Files(DATA / "BENCHMARK.json", DATA)
    return harness.run_cell(files, TEST_CELL, 2 ** 31 + 11, seconds, trace,
                            CPU, time.perf_counter())


def test_a_whole_run_on_the_cpu_test_cell():
    res = _run()
    assert res["correct"] is True and res["failed"] == 0
    assert list(res)[-1] == "checks"
    # no card: no device peak to read
    assert set(res["metrics"]) == {"dmet_iter_s", "setup_s"}
    assert all(c["value"] <= c["limit"] for c in res["checks"].values())


def test_a_traced_run_reads_the_spans_and_counters():
    res = _run(trace=True)
    m = res["metrics"]
    for key in ("meanfield_s_per_iter", "embham_s_per_iter",
                "solver_s_per_iter", "fit_s_per_iter",
                "sigma_builds_per_iter", "fit_cg_steps_per_iter"):
        assert m[key]["value"] > 0, key
    # no card: no device time, so no roofline and no idle share
    assert "fci_sigma_roofline" not in m and "device_idle" not in m
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


def test_a_loaded_jax_module_refuses_the_run(monkeypatch):
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client",
                        types.ModuleType("jaxlib.xla_client"))
    assert harness.forbidden_modules() == ["jaxlib"]
    assert _run() is None


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_a_broken_timed_path_is_not_correct(fault):
    """correct comes out false; where the fault drives the program into a
    failure (half the k points: the fit's eigensolver meets NaN), the run
    prints no result, which the check refuses as well."""
    with faults.FAULTS[fault]():
        try:
            res = _run()
        except (RuntimeError, ValueError, FloatingPointError):
            return
    assert res["correct"] is False and res["failed"] == 1


def test_run_without_a_card_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, str(PKG / "run.py"), "--workload",
                          "threeband_hanke_20x20.dmet_loop", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.cuda
def test_a_short_run_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run([sys.executable, str(PKG / "run.py"), "--workload",
                          "threeband_hanke_20x20.dmet_loop", "--seed", "3",
                          "--seconds", "1", "--trace", "0"], cwd=REPO,
                         capture_output=True, text=True, timeout=360)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True and res["device"]["platform"] == "gpu"


def test_calibrate_reads_program_control_and_fault(tmp_path):
    """calibrate.py on the CPU test cell: the program within its limits,
    the fault that returns the input vcor at a fit shortfall of 1."""
    from perfbench import calibrate
    out = tmp_path / "cal.json"
    assert calibrate.main([
        "--workload", TEST_CELL, "--seeds", "5", "--control-seeds", "6",
        "--faults", "fit_unchanged", "--fault-seeds", "7", "--device",
        "cpu", "--data", str(DATA), "--out", str(out)]) == 0
    rec = json.loads(out.read_text())
    with open(DATA / "limits" / (TEST_CELL + ".json")) as f:
        limits = json.load(f)
    sound = rec["program"][0]["readings"]
    assert all(sound[k] <= limits[k]["limit"] for k in limits)
    assert rec["control"][0]["readings"]["e_site"] > limits["e_site"]["limit"]
    assert rec["faults"][0]["readings"]["fit_short"] == 1.0
    assert len(rec["program"][0]["fits"]) == 7


def test_windows_times_each_round(capsys):
    from perfbench import windows
    assert windows.main(["--workload", TEST_CELL, "--seed", "3", "--rounds",
                         "2", "--device", "cpu", "--data", str(DATA)]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert [r["iterations"] for r in line["rounds"]] == [21, 21]
    assert all(r["seconds"] > 0 for r in line["rounds"])
