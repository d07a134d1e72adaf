"""
The PyTorch port's coupled-cluster solver classes (CCSD, MP2, CCD, LCCSD,
LCCD, CCSD_ITE, BCCSD of libdmet_preview_tpu_torch/solvers/cc.py) against
the JAX package's on the systems of tests/test_cc.py (restricted,
unrestricted, Hubbard, spin-polarized, ghf=True), against the port's own
FCI where CCSD is exact, and through run_dmet on the 1D Hubbard chain.
On the CPU.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from test_cc import hubbard_integral, random_integral, spin_polarized_integral

jax.config.update("jax_enable_x64", True)

torch.set_num_threads(1)

CPU = torch.device("cpu")


def port_integral(Ham):
    from libdmet_preview_tpu_torch import interop
    return interop.integral_from_numpy(
        Ham.norb, Ham.restricted, Ham.H0, np.asarray(Ham.H1["cd"]),
        np.asarray(Ham.H2["ccdd"]), CPU)


CASES = {
    "ccsd-restricted": ("CCSD", lambda: random_integral(4, True, seed=1), 2,
                        dict(restricted=True, tol=1e-11)),
    "ccsd-unrestricted": ("CCSD", lambda: random_integral(4, False, seed=2),
                          2, dict(restricted=False, tol=1e-11)),
    "ccsd-hubbard": ("CCSD", lambda: hubbard_integral(4, 2.0, True), 4,
                     dict(restricted=True, tol=1e-10)),
    "ccsd-spin-polarized": ("CCSD",
                            lambda: spin_polarized_integral(4, 4.0, 0.3), 4,
                            dict(restricted=False, tol=1e-10)),
    "ccsd-ghf": ("CCSD", lambda: random_integral(4, True, seed=3), 3,
                 dict(restricted=True, ghf=True, tol=1e-10)),
    "mp2": ("MP2", lambda: hubbard_integral(4, 1.0, False), 4,
            dict(restricted=False)),
    "ccd": ("CCD", lambda: hubbard_integral(4, 2.0, True), 4,
            dict(restricted=True, tol=1e-10)),
    "lccsd": ("LCCSD", lambda: random_integral(4, True, seed=7), 4,
              dict(restricted=True, tol=1e-11, lambda_sweeps=4)),
    "lccd": ("LCCD", lambda: random_integral(4, True, seed=7), 4,
             dict(restricted=True, tol=1e-11)),
    "ccsd-ite": ("CCSD_ITE", lambda: random_integral(4, True, seed=5), 4,
                 dict(restricted=True, tol=1e-10, ite_dtau=0.4,
                      max_cycle=500)),
    "bccsd": ("BCCSD", lambda: hubbard_integral(4, 4.0, True), 2,
              dict(restricted=True, tol=1e-11, bcc_tol=1e-7)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_solver_matches_jax(case):
    """run() in both packages: E 1e-8, rdm1 and rdm2 1e-6; the stored RDMs
    reproduce E through run_dmet_ham (1e-8)."""
    from libdmet_preview_tpu.solvers import cc as jcc
    from libdmet_preview_tpu_torch import solvers
    name, make, nelec, kw = CASES[case]
    Ham = make()
    js = getattr(jcc, name)(**kw)
    r1j, Ej = js.run(Ham, nelec=nelec)
    ts = getattr(solvers, name)(device=CPU, **kw)
    Ht = port_integral(Ham)
    r1t, Et = ts.run(Ht, nelec=nelec)
    assert isinstance(r1t, torch.Tensor) and isinstance(Et, float)
    assert abs(Et - Ej) < 1e-8
    assert tuple(r1t.shape) == np.shape(r1j)
    assert np.abs(r1t.numpy() - np.asarray(r1j)).max() < 1e-6
    r2t = ts.make_rdm2(Ht)
    assert tuple(r2t.shape) == np.shape(js.twopdm)
    assert np.abs(r2t.numpy() - np.asarray(js.twopdm)).max() < 1e-6
    assert abs(ts.run_dmet_ham(Ht) - Et) < 1e-8
    assert abs(ts.run_dmet_ham(Ht) - js.run_dmet_ham(Ham)) < 1e-8


@pytest.mark.parametrize("name,make", [
    ("CCSD", lambda: random_integral(4, True, seed=1)),
    ("CCSD", lambda: random_integral(4, False, seed=2)),
    ("CCSD", lambda: hubbard_integral(4, 4.0, True)),
    ("BCCSD", lambda: hubbard_integral(4, 4.0, True))],
    ids=["restricted", "unrestricted", "hubbard", "bccsd-hubbard"])
def test_two_electron_ccsd_equals_port_fci(name, make):
    """CCSD is exact for two electrons: E against the port's own FCI at
    1e-7, rdm1 at 1e-6, run_dmet_ham reproduces E, tr(rdm1) = nelec."""
    from libdmet_preview_tpu_torch import solvers
    Ham = port_integral(make())
    fci = solvers.FCI(restricted=Ham.restricted, tol=1e-12, device=CPU)
    r1f, E_fci = fci.run(Ham, nelec=2)
    cc = getattr(solvers, name)(restricted=Ham.restricted, tol=1e-11,
                                device=CPU)
    r1, E = cc.run(Ham, nelec=2)
    assert abs(E - E_fci) < 1e-7
    assert float(torch.abs(r1 - r1f).max()) < 1e-6
    assert abs(cc.run_dmet_ham(Ham) - E_fci) < 1e-7
    ntot = float(torch.sum(torch.diagonal(r1, dim1=-2, dim2=-1)))
    assert abs(ntot * (2.0 if Ham.restricted else 1.0) - 2.0) < 1e-8


def test_lambda_sweeps_converge_to_the_exact_response():
    """LCCSD: the energy is CCSD's; rdm1 approaches the exact-adjoint one
    geometrically with the sweep count."""
    from libdmet_preview_tpu_torch import solvers
    Ham = port_integral(random_integral(4, True, seed=7))
    rdm_exact, E_exact = solvers.CCSD(restricted=True, tol=1e-11,
                                      device=CPU).run(Ham, nelec=4)
    errs = []
    for k in (1, 4):
        rdm_k, E_k = solvers.LCCSD(restricted=True, tol=1e-11,
                                   lambda_sweeps=k,
                                   device=CPU).run(Ham, nelec=4)
        assert abs(E_k - E_exact) < 1e-9
        errs.append(float(torch.abs(rdm_k - rdm_exact).max()))
    assert errs[0] < 1e-3
    assert errs[1] < errs[0] * 0.2


def test_default_device_is_cuda_and_tccsd_names_its_slice():
    """The solvers' default device is CUDA, with no CPU fallback: here,
    without a card, run() raises.  TCCSD, which came with the CAS solvers
    (Slice 5a), is no stub any more and defaults to CUDA too."""
    from libdmet_preview_tpu_torch import solvers
    for name in ("CCSD", "MP2", "CCD", "LCCSD", "LCCD", "CCSD_ITE", "BCCSD"):
        assert getattr(solvers, name)().device.type == "cuda"
    tcc = solvers.TCCSD(ncas=2, nelecas=2)
    assert tcc.device.type == "cuda"
    if not torch.cuda.is_available():
        Ham = port_integral(hubbard_integral(2, 1.0, True))
        for solver in (solvers.CCSD(restricted=True), tcc):
            with pytest.raises((RuntimeError, AssertionError)):
                solver.run(Ham, nelec=2)


# ----------------------------------------------------------------------
# through run_dmet
# ----------------------------------------------------------------------

@pytest.mark.parametrize("solver", ["CCSD", "MP2"])
def test_run_dmet_two_iterations_match_jax(solver):
    """run_dmet(solver=...) on ChainLattice(18, 2), U = 4, unrestricted,
    non-interacting bath, two iterations of each package's own loop from
    the common start (this fit has no flat valley, so the second iteration
    needs no restart from the other package's vcor): E and nelec 1e-7,
    fit error and accumulated dmu 1e-6, the fitted vcor 1e-5, rhoImp
    1e-6."""
    import libdmet_preview_tpu.dmet.hubbard as jdmet
    from libdmet_preview_tpu.dmet.loop import run_dmet as jrun
    from libdmet_preview_tpu.utils.config import DmetConfig as JConfig
    import libdmet_preview_tpu_torch.dmet.hubbard as tdmet
    from libdmet_preview_tpu_torch import interop
    from libdmet_preview_tpu_torch.dmet.loop import run_dmet as trun
    U, filling = 4.0, 0.5
    cfg = JConfig(filling=filling, restricted=False, int_bath=False,
                  solver=solver, solver_tol=1e-10, max_iter=2)

    def lattice(dmet, **kw):
        Lat = dmet.ChainLattice(18, 2)
        Lat.set_Ham(dmet.Ham(Lat, U), use_hcore_as_emb_ham=True, **kw)
        return Lat, dmet.PMInitGuess([2], U, filling)

    res_j = jrun(*lattice(jdmet), cfg)
    cfg_t = interop.dmet_config_from_dict(dataclasses.asdict(cfg))
    res_t = trun(*lattice(tdmet, device=CPU), cfg_t)
    assert len(res_t.history) == len(res_j.history) == 2
    for h_j, h_t in zip(res_j.history, res_t.history):
        assert abs(h_t["E"] - h_j["E"]) < 1e-7
        assert abs(h_t["nelec"] - h_j["nelec"]) < 1e-7
        assert abs(h_t["fit_err"] - h_j["fit_err"]) < 1e-6
    assert abs(res_t.last_dmu - res_j.last_dmu) < 1e-6
    assert np.abs(res_t.vcor.param - res_j.vcor.param).max() < 1e-5
    assert np.abs(res_t.rho_imp - np.asarray(res_j.rho_imp)).max() < 1e-6
