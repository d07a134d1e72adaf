"""The plain reference against an independent brute force and against the
port, on the CPU at small sizes; the sigma work count against a count of
the contraction's non-zero entries."""

import itertools
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench import roofline
from perfbench.reference import fci, loop
from perfbench.reference.model import DMET, Fit, vcor_matrix

PKG = Path(__file__).resolve().parents[1]
DATA = Path(__file__).resolve().parent / "data"
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _one_thread():
    """One host thread, as run.py sets it: the runs are many small host
    operations, and the thread pools of several test workers spinning
    against each other slow them fifty-fold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config(path):
    with open(path) as f:
        return json.load(f)


def _random_ints(n, seed):
    rng = np.random.default_rng(seed)
    h = [rng.standard_normal((n, n)) for _ in range(2)]
    h = [0.5 * (x + x.T) for x in h]

    def eri():
        g = rng.standard_normal((n,) * 4)
        g = g + g.transpose(1, 0, 2, 3)
        g = g + g.transpose(0, 1, 3, 2)
        return g + g.transpose(2, 3, 0, 1)
    gaa, gbb = eri(), eri()
    gab = rng.standard_normal((n,) * 4)
    gab = gab + gab.transpose(1, 0, 2, 3)
    gab = gab + gab.transpose(0, 1, 3, 2)
    return h, (gaa, gbb, gab)


def _jordan_wigner_h(n, nelec, h, g):
    """H in the Fock space of 2n spin orbitals (alpha 0..n-1, beta
    n..2n-1), restricted to the sector nelec = (na, nb)."""
    dim = 2 ** (2 * n)

    def ann(k):
        a = np.zeros((dim, dim))
        for s in range(dim):
            if s >> k & 1:
                sign = (-1) ** bin(s & ((1 << k) - 1)).count("1")
                a[s ^ (1 << k), s] = sign
        return a
    a = [ann(k) for k in range(2 * n)]
    c = [x.T for x in a]
    H = np.zeros((dim, dim))
    blocks = {(0, 0): g[0], (1, 1): g[1], (0, 1): g[2], (1, 0):
              g[2].transpose(2, 3, 0, 1)}
    for s in range(2):
        o = s * n
        for p, q in itertools.product(range(n), repeat=2):
            H += h[s][p, q] * c[o + p] @ a[o + q]
    for (s, t), gs in blocks.items():
        o, u = s * n, t * n
        for p, q, r, w in itertools.product(range(n), repeat=4):
            if gs[p, q, r, w]:
                H += 0.5 * gs[p, q, r, w] * (c[o + p] @ c[u + r] @ a[u + w]
                                             @ a[o + q])
    keep = [s for s in range(dim)
            if bin(s & ((1 << n) - 1)).count("1") == nelec[0]
            and bin(s >> n).count("1") == nelec[1]]
    return H[np.ix_(keep, keep)]


@pytest.mark.parametrize("n, nelec", [(3, (1, 2)), (4, (2, 2)), (4, (3, 1))])
def test_fci_matches_jordan_wigner(n, nelec):
    h, g = _random_ints(n, 7 * n + nelec[0])
    exact = np.linalg.eigvalsh(_jordan_wigner_h(n, nelec, h, g))[0]
    space = fci.Space(n, nelec, CPU)
    H = fci.Hamiltonian(space, h, g, ecore=0.25)
    E, c = fci.davidson(H)
    assert abs(E - 0.25 - exact) < 1e-9
    # the sigma matrix is symmetric and its diagonal is diagonal()
    na, nb = space.shape
    M = torch.stack([H.sigma(torch.eye(na * nb, dtype=torch.float64)[k]
                             .reshape(na, nb)).reshape(-1)
                     for k in range(na * nb)])
    assert torch.allclose(M, M.T, atol=1e-12)
    assert torch.allclose(torch.diagonal(M), H.diagonal().reshape(-1),
                          atol=1e-12)
    assert abs(float(torch.linalg.eigvalsh(M)[0]) - exact) < 1e-10


def test_fci_agrees_with_the_port():
    from libdmet_preview_tpu_torch.solvers import fci as port_fci
    n, nelec = 6, (3, 3)
    h, g = _random_ints(n, 3)
    space = fci.Space(n, nelec, CPU)
    H = fci.Hamiltonian(space, h, g)
    E, c = fci.davidson(H)
    E_port, _ = port_fci.fci_kernel(tuple(h), (g[0], g[2], g[1]), n, nelec,
                                    device=CPU)
    assert abs(E - E_port) < 1e-9


@pytest.mark.parametrize("norb, na, nb", [(2, 1, 1), (4, 2, 1), (5, 2, 3),
                                         (6, 3, 3)])
def test_sigma_work_count(norb, na, nb):
    """FLOPs: a column of the (nn x nn) integral matrix per non-zero
    entry of the excitation intermediates, twice per spin."""
    nn = norb * norb
    nnz = 0
    for ne, other in ((na, nb), (nb, na)):
        src, _ = fci.excitation_table(norb, ne)
        nnz += int((src < src.shape[0]).sum()) * len(fci.strings(norb,
                                                                  other))
    flops, nbytes = roofline.sigma_work(norb, na, nb)
    assert flops == 2 * 2 * nn * nnz
    ndet = len(fci.strings(norb, na)) * len(fci.strings(norb, nb))
    assert nbytes == 8 * (2 * ndet + 3 * nn * nn)


def test_sigma_work_at_the_cells_shape():
    flops, _ = roofline.sigma_work(12, 6, 6)
    assert flops == 4 * 144 * 853776 * 84


def _port_lattice(cfg):
    from perfbench.models import three_band_emery
    return three_band_emery.Program(cfg, CPU)


def _afm_config(size):
    cfg = _config(PKG / "configs" / "threeband_hanke_20x20.json")
    cfg["lattice"].update(size=[size, size])
    return cfg


@pytest.mark.parametrize("cfg_path, filling", [
    (DATA / "configs" / "threeband_hanke_6x6.json", 5.0 / 6.0),
    ("afm4", 5.0 / 6.0), ("afm4", 4.875 / 6.0)])
def test_steps_agree_with_the_port(cfg_path, filling):
    """Mean field, bath projector, embedding H1 and H2 and the fit error at
    a random vcor, against the port's HartreeFock / ConstructImpHam /
    FitVcor on the same lattice."""
    import libdmet_preview_tpu_torch.dmet.hubbard as dmet
    cfg = _afm_config(4) if cfg_path == "afm4" else _config(cfg_path)
    prog = _port_lattice(cfg)
    Lat, n = prog.lattice, prog.nsc
    p = 0.3 * np.random.default_rng(5).standard_normal(prog.nparam)
    vcor = dmet.VcorLocal(False, False, n)
    vcor.update(p)
    rho, mu, _ = dmet.HartreeFock(Lat, vcor, filling, None, ires=True)
    ImpHam, _, basis = dmet.ConstructImpHam(Lat, rho, vcor, matching=False,
                                            int_bath=False)
    dm = DMET(cfg, CPU)
    assert np.abs(np.concatenate(list(np.asarray(Lat.getH1(kspace=False))))
                  - dm.lat.h[:, :n]).max() == 0.0
    assert np.abs(np.asarray(Lat.getH2()) - dm.lat.eri).max() == 0.0
    v = vcor_matrix(p, n)
    rr, mur = dm.mean_field(v, filling)
    assert abs(mu - mur) < 1e-10
    rho = np.asarray(rho)
    cols = np.concatenate([rho[:, R] for R in range(rho.shape[1])], axis=1)
    assert np.abs(rr[:, :, :n].numpy() - cols).max() < 1e-10
    B = dm.bath(rr)
    bp = basis.reshape(2, -1, basis.shape[-1])
    assert bp.shape == B.shape
    proj = bp @ bp.transpose(1, 2) - B @ B.transpose(1, 2)
    assert float(proj.abs().max()) < 1e-9
    h1 = dm.emb_h1(B, v)
    H1p = ImpHam.H1["cd"]
    lat_h1 = bp @ H1p @ bp.transpose(1, 2) - B @ h1 @ B.transpose(1, 2)
    assert float(lat_h1.abs().max()) < 1e-9
    assert float((ImpHam.H2["ccdd"][0] - dm.emb_eri(B.shape[-1])).abs()
                 .max()) == 0.0
    # the fit error of the port's fitted vcor against one target density
    target = torch.stack([torch.eye(B.shape[-1], dtype=torch.float64)
                          * 0.5] * 2)
    vnew, err = dmet.FitVcor(target, Lat, basis, vcor, np.inf, filling,
                             MaxIter1=50, MaxIter2=0)
    assert abs(Fit(dm, B, target).err(vnew.param) - err) < 1e-9


def _job_and_start(seed=12345):
    from perfbench import harness
    cfg = _config(DATA / "configs" / "threeband_hanke_6x6.json")
    mix = harness.Files(DATA / "BENCHMARK.json", DATA).mix("dmet_loop")
    prog = _port_lattice(cfg)
    start = harness.protocol(mix).start_vcor(mix, prog.nparam, seed)
    return cfg, mix, prog, start


# the numbers on which the program and the reference must agree; the
# others hold what the program's dmu search and fit settled on
AGREE = ("e_site", "rdm_imp", "nelec", "fit_err", "vcor", "mu")


def test_the_port_passes_and_the_control_fails():
    """Through run_dmet: the reference's readings of the port's job are
    within the test cell's limits; the float32 control's are far above
    them on every number of agreement.  The control's dmu search and fit
    settle as the program's do: the faults are what exceed those numbers
    (test_perfbench_harness)."""
    from perfbench.models import three_band_emery as model
    cfg, mix, prog, start = _job_and_start()
    job = dict(prog.job(start, mix["filling"], mix["max_iter"]),
               start=start)
    sound = model.judge(cfg, mix, job, CPU)
    ctrl = model.judge(cfg, mix, model.control(cfg, mix, start, CPU), CPU)
    with open(DATA / "limits" / "threeband_hanke_6x6.dmet_loop.json") as f:
        limits = json.load(f)
    assert set(sound) == set(loop.NUMBERS) == set(limits)
    for key in loop.NUMBERS:
        assert sound[key] <= limits[key]["limit"], key
    for key in AGREE:
        assert ctrl[key] >= 3 * limits[key]["limit"], key


def test_the_reference_loop_judges_itself_exact():
    from perfbench.models import three_band_emery as model
    cfg, mix, prog, start = _job_and_start(7)
    ref = model.control(cfg, mix, start, CPU, torch.float64)
    readings = model.judge(cfg, mix, ref, CPU)
    assert max(readings[k] for k in AGREE) < 1e-12
    # its own fit is the minimum the judge finds from the same input
    assert readings["fit_short"] < 1e-6
    assert readings["nelec_target"] < 1e-5


def test_the_fit_shortfall():
    assert loop.fit_shortfall(0.5, 0.5, 0.1) == 1.0
    assert loop.fit_shortfall(0.1, 0.5, 0.1) == 0.0
    assert loop.fit_shortfall(0.09, 0.5, 0.1) == 0.0
    assert abs(loop.fit_shortfall(0.2, 0.5, 0.1) - 0.25) < 1e-15
    # pooled: a late iteration's small possible decrease weighs little
    pooled = loop.fit_shortfall([0.11, 0.05002], [0.5, 0.05004], [0.1, 0.05])
    assert abs(pooled - (0.01 + 0.00002) / (0.4 + 0.00004)) < 1e-12
