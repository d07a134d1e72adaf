"""The CCSD configuration's reference (perfbench/reference/three_band_cc.py)
against an independent check and against the port, on the CPU at small
sizes: the hole-picture lattice, CCSD against the reference FCI where
CCSD is exact, the program's CCSD on random problems, the UHF
determinant of an embedding problem, a traced run of the CPU test cell
judged correct, and the float32 control and planted faults refused."""

import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench import harness
from perfbench.reference import fci
from perfbench.reference import three_band_cc as ref

PKG = Path(__file__).resolve().parents[1]
REPO = PKG.parent
DATA = Path(__file__).resolve().parent / "data_cc"
CPU = torch.device("cpu")
TEST_CELL = "threeband_hanke_2x2_ccsd_3x3.dmet_loop_2x2_hole"
TOL = ref._TOL[torch.float64]


@pytest.fixture(autouse=True)
def _few_threads():
    """Four host threads: the CCSD of 48 spin orbitals is a few hundred
    contractions of 24^4 tensors a step."""
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(n)


def _config(path):
    with open(path) as f:
        return json.load(f)


def _main_config(size):
    cfg = _config(PKG / "configs" / "threeband_hanke_2x2_ccsd.json")
    cfg["lattice"].update(size=[size, size])
    return cfg


def _integral(h, g):
    from libdmet_preview_tpu_torch.models.integral import Integral
    h = torch.as_tensor(np.asarray(h))
    g = torch.as_tensor(np.asarray(g))
    return Integral(h.shape[-1], False, False, 0.0, {"cd": h},
                    {"ccdd": torch.stack([g, g, g])})


def _random_problem(n, seed):
    """A random embedding-like problem: a spin-dependent one-body term
    with a gap-opening staggered field and on-site plus nearest-pair
    density interactions."""
    rng = np.random.default_rng(seed)
    t = 0.4 * rng.standard_normal((n, n))
    t = 0.5 * (t + t.T)
    stag = np.diag([(-1.0) ** p for p in range(n)])
    h = np.asarray([t + 1.5 * stag, t - 1.5 * stag]) \
        + 0.1 * np.asarray([np.diag(rng.standard_normal(n))
                            for _ in range(2)])
    g = np.zeros((n,) * 4)
    for p in range(n):
        g[p, p, p, p] = 2.0 + rng.random()
        q = (p + 1) % n
        v = 0.3 * rng.random()
        g[p, p, q, q] += v
        g[q, q, p, p] += v
    return h, g


def test_the_hole_lattice_matches_the_program():
    """One-body term and unit-cell ERI of the reference against
    Hubbard3band_ref(hole_rep=True) on Square3BandSymm(2, 2), exactly."""
    from perfbench.models import three_band_cc
    cfg = _main_config(2)
    prog = three_band_cc.Program(cfg, CPU)
    lat = ref.HoleLattice(cfg)
    n = prog.nsc
    assert n == lat.nsc == 12
    assert [i for i, s in enumerate(lat.names) if s == "Cu"] == [0, 3, 6, 9]
    h = np.asarray(prog.lattice.getH1(kspace=False))
    assert np.abs(np.concatenate(list(h)) - lat.h[:, :n]).max() == 0.0
    assert np.abs(np.asarray(prog.lattice.getH2()) - lat.eri).max() == 0.0
    # the hole picture: e_d = -D_pd on the copper, hoppings of the table
    assert lat.h[0, 0] == -cfg["parameters"]["D_pd"]
    assert np.isclose(np.abs(lat.h[0, :n]).max(), cfg["parameters"]["D_pd"])
    with pytest.raises(ValueError):
        ref.HoleLattice(_config(PKG / "configs"
                                / "threeband_hanke_20x20.json"))


@pytest.mark.parametrize("n, seed", [(3, 1), (4, 2), (5, 3)])
def test_ccsd_is_exact_for_two_particles(n, seed):
    """One particle of each spin: CCSD is exact, so its energy and its
    response density are the reference FCI's."""
    h, g = _random_problem(n, seed)
    ht, gt = torch.as_tensor(h), torch.as_tensor(g)
    Ca, Cb = ref.uhf(ht, gt, (1, 1), TOL)
    E, rdm = ref.ccsd(ht, gt, Ca, Cb, (1, 1), TOL)
    H = fci.Hamiltonian(fci.Space(n, (1, 1), CPU), (ht[0], ht[1]),
                        (gt, gt, gt))
    E_fci, c = fci.davidson(H)
    assert abs(E - E_fci) < 1e-10
    assert float((rdm - torch.stack(H.rdm1(c))).abs().max()) < 1e-9


@pytest.mark.parametrize("n, na, nb", [(8, 3, 3), (10, 4, 4), (10, 5, 3),
                                       (12, 6, 6)])
def test_ccsd_matches_the_program(n, na, nb):
    """The program's CCSD and the reference's on the same UHF orbitals:
    E and the response rdm1 to 1e-8.  Both stop their amplitude and
    adjoint iterations at residuals of 1e-10 to 1e-11, which moves E and
    the density by ~1e-10 each; 1e-8 leaves two orders for the summation
    order of ~10^2 contractions."""
    from libdmet_preview_tpu_torch.solvers import CCSD
    h, g = _random_problem(n, 10 * n + na + nb)
    solver = CCSD(restricted=False, Sz=na - nb, tol=1e-11, device=CPU)
    rdm, E = solver.run(_integral(h, g), nelec=na + nb)
    Ca, Cb = (torch.as_tensor(c) for c in solver.scfsolver.mo_coeff)
    E_ref, rdm_ref = ref.ccsd(torch.as_tensor(h), torch.as_tensor(g), Ca,
                              Cb, (na, nb), TOL)
    assert abs(E - E_ref) < 1e-8
    assert float((rdm - rdm_ref).abs().max()) < 1e-8
    # and the reference's own UHF lands on the program's determinant
    Ca2, Cb2 = ref.uhf(torch.as_tensor(h), torch.as_tensor(g), (na, nb),
                       TOL)
    for C, C2, k in ((Ca, Ca2, na), (Cb, Cb2, nb)):
        d = C[:, :k] @ C[:, :k].T - C2[:, :k] @ C2[:, :k].T
        assert float(d.abs().max()) < 1e-6


@pytest.fixture(scope="module")
def embedding():
    """The program's embedding problem of the CPU test cell at its start,
    and the reference's of the same lattice."""
    import libdmet_preview_tpu_torch.dmet.hubbard as dmet
    from perfbench.models import three_band_cc
    from perfbench.reference.model import vcor_matrix
    files = harness.Files(DATA / "BENCHMARK.json", DATA)
    cell = files.cell(TEST_CELL)
    cfg, mix = files.config(cell["config"]), files.mix(cell["traffic"])
    prog = three_band_cc.Program(cfg, CPU)
    start = harness.protocol(mix).start_vcor(mix, prog.nparam, 1)
    vcor = dmet.VcorLocal(False, False, prog.nsc)
    vcor.update(start)
    rho, _, _ = dmet.HartreeFock(prog.lattice, vcor, mix["filling"], None,
                                 ires=True)
    ImpHam, _, basis = dmet.ConstructImpHam(prog.lattice, rho, vcor,
                                            matching=False)
    dm = ref.DMET(cfg, CPU)
    v = vcor_matrix(start, dm.nsc)
    rr, _ = dm.mean_field(v, mix["filling"])
    B = dm.bath(rr)
    return {"cfg": cfg, "prog": prog, "ImpHam": ImpHam, "basis": basis,
            "dm": dm, "B": B, "h1": dm.emb_h1(B, v),
            "g": dm.emb_eri(B.shape[-1])}


# the dmu of the test cell's first iteration, where its search ends
DMU = 1.93


def _program_readings(emb, dmu=DMU):
    """(E per site, nelec per site, rho_imp) of the program's solve at
    dmu, through the DMET path's solve and transformResults."""
    import libdmet_preview_tpu_torch.dmet.hubbard as dmet
    from libdmet_preview_tpu_torch.solvers import CCSD
    lat, basis = emb["prog"].lattice, emb["basis"]
    solver = CCSD(restricted=False, tol=emb["cfg"]["dmet"]["solver_tol"],
                  device=CPU)
    nelec = (lat.ncore + lat.nval) * 2
    rdm, E = dmet.SolveImpHam_with_dmu(lat, emb["ImpHam"], basis, dmu,
                                       solver, {"nelec": nelec})
    rimp, e, ne = dmet.transformResults(rdm, E, basis, emb["ImpHam"], None,
                                        lattice=lat, last_dmu=dmu)
    return e, ne, rimp


def _readings(prog, reference):
    (e, ne, rimp), (er, ner, rr) = prog, reference
    return {"e_site": abs(e - er), "nelec": abs(ne - ner),
            "rdm_imp": float((torch.as_tensor(np.asarray(rimp)) - rr.cpu())
                             .abs().max())}


@pytest.fixture(scope="module")
def reference_readings(embedding):
    dm, h1, g = embedding["dm"], embedding["h1"], embedding["g"]
    E, rdm = dm.solve(h1, g, DMU)
    return dm.energy(h1, rdm, E, DMU)


@pytest.fixture(scope="module")
def limits():
    return _config(DATA / "limits" / (TEST_CELL + ".json"))


def test_the_program_solve_agrees_and_lands_on_the_same_determinant(
        embedding, reference_readings, limits):
    from libdmet_preview_tpu_torch.solvers import scf
    out = _readings(_program_readings(embedding), reference_readings)
    for key, value in out.items():
        assert value <= limits[key]["limit"] / 100.0, (key, value)
    # the UHF determinants in the two bath gauges: the same density in
    # the lattice's orbitals
    import libdmet_preview_tpu_torch.dmet.hubbard as dmet
    dm, h1, g = embedding["dm"], embedding["h1"], embedding["g"]
    n = dm.nsc
    h = h1.clone()
    h[:, :n, :n] -= DMU * torch.eye(n, dtype=h.dtype)
    Ca, Cb = ref.uhf(h, g, (n, n), TOL)
    ham = embedding["ImpHam"]
    lat, basis = embedding["prog"].lattice, embedding["basis"]
    dmet.apply_dmu(lat, ham, basis, DMU)
    mf = scf.SCF(device=CPU)
    mf.set_system(2 * n, 0, False, False)
    mf.set_integral(ham)
    mf.HF(tol=1e-10, MaxIter=200)
    dmet.apply_dmu(lat, ham, basis, -DMU)
    Bp = basis.reshape(2, -1, basis.shape[-1])
    for s, C in enumerate((Ca, Cb)):
        occ_p = Bp[s] @ torch.as_tensor(mf.mo_coeff[s])[:, :n]
        occ_r = embedding["B"][s] @ C[:, :n]
        d = occ_p @ occ_p.T - occ_r @ occ_r.T
        assert float(d.abs().max()) < 1e-7


@contextlib.contextmanager
def _lambda_dropped():
    """The adjoint returns no Lambda: the density loses its Lambda
    terms."""
    from libdmet_preview_tpu_torch.solvers import cc
    orig = cc._solve_adjoint

    def none(h_so, W, nocc, t1, t2, w1, w2, **k):
        return torch.zeros_like(w1), torch.zeros_like(w2)
    cc._solve_adjoint = none
    try:
        yield
    finally:
        cc._solve_adjoint = orig


@contextlib.contextmanager
def _t1_dropped():
    """The correlation energy, and so the response density, leave out the
    singles."""
    from libdmet_preview_tpu_torch.solvers import cc
    orig = cc._ecorr

    def no_t1(t1, t2, h_so, W, nocc):
        return orig(torch.zeros_like(t1), t2, h_so, W, nocc)
    cc._ecorr = no_t1
    try:
        yield
    finally:
        cc._ecorr = orig


@contextlib.contextmanager
def _dmu_sign_flipped():
    """The impurity's chemical potential enters with the wrong sign."""
    import libdmet_preview_tpu_torch.dmet.hubbard as dmet
    orig = dmet.apply_dmu

    def flipped(lattice, ImpHam, basis, dmu, **k):
        return orig(lattice, ImpHam, basis, -dmu, **k)
    dmet.apply_dmu = flipped
    try:
        yield
    finally:
        dmet.apply_dmu = orig


@pytest.mark.parametrize("fault", [_lambda_dropped, _t1_dropped,
                                   _dmu_sign_flipped])
def test_a_planted_fault_fails_the_limits(fault, embedding,
                                          reference_readings, limits):
    with fault():
        out = _readings(_program_readings(embedding), reference_readings)
    assert any(out[k] > limits[k]["limit"] for k in out), out


def test_the_float32_solve_fails_the_limits(embedding, reference_readings,
                                            limits):
    dm32 = ref.DMET(embedding["cfg"], CPU, torch.float32)
    h1, g = embedding["h1"].float(), embedding["g"].float()
    E, rdm = dm32.solve(h1, g, DMU)
    e, ne, rimp = dm32.energy(h1, rdm, E, DMU)
    out = _readings((e, ne, rimp.double()), reference_readings)
    assert out["e_site"] > 3 * limits["e_site"]["limit"], out
    assert out["rdm_imp"] > 3 * limits["rdm_imp"]["limit"], out


def test_a_traced_run_of_the_cpu_test_cell():
    """One run_dmet iteration (after the warm-up's), judged by the
    reference's follow: correct, and every per-layer metric of the cell
    read from the program's spans and counters."""
    files = harness.Files(DATA / "BENCHMARK.json", DATA)
    res = harness.run_cell(files, TEST_CELL, 2 ** 31 + 11, 0.0, True, CPU,
                           time.perf_counter())
    assert res["correct"] is True and res["failed"] == 0, res["checks"]
    m = res["metrics"]
    names = [x["name"] for x in files.metrics("per_layer", TEST_CELL)]
    assert len(names) == 7 and set(m) == set(names)
    assert all(m[k]["value"] > 0 for k in names)
    assert m["cc_solves_per_iter"]["value"] == int(
        m["cc_solves_per_iter"]["value"])


def test_the_control_is_refused_by_follow():
    from perfbench.models import three_band_cc as model
    files = harness.Files(DATA / "BENCHMARK.json", DATA)
    cell = files.cell(TEST_CELL)
    cfg, mix = files.config(cell["config"]), files.mix(cell["traffic"])
    limits = files.limits(TEST_CELL)
    start = harness.protocol(mix).start_vcor(mix, 156, 1)
    ctrl = model.judge(cfg, mix, model.control(cfg, mix, start, CPU), CPU)
    assert ctrl["e_site"] > 3 * limits["e_site"]["limit"]
    assert ctrl["rdm_imp"] > 3 * limits["rdm_imp"]["limit"]


def test_the_adapter_and_reference_load_no_forbidden_module():
    code = ("import sys; sys.path.insert(0, %r); "
            "import perfbench.models.three_band_cc, "
            "perfbench.reference.three_band_cc; "
            "from perfbench import harness; "
            "print(','.join(harness.forbidden_modules()))" % str(REPO))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == ""
