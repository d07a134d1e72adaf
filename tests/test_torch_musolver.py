"""
The PyTorch port's chemical-potential fit
(libdmet_preview_tpu_torch/dmet/quad_fit.py, dmet/hubbard.py apply_dmu /
MuSolver) against the JAX package's on the CPU, on one embedding
Hamiltonian of the 1D Hubbard chain carried across as NumPy
(interop.integral_from_numpy) so that both FCI solvers see the same
problem in the same basis.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

CPU = torch.device("cpu")
U = 4.0


def test_quad_fit_mu_exact():
    """quad_fit_mu: the JAX package's numbers exactly, on the exact
    parabola of its own test and on seeded histories that reach the
    linear fallback and the step clamps."""
    from libdmet_preview_tpu.dmet.quad_fit import quad_fit_mu as jq
    from libdmet_preview_tpu_torch.dmet.quad_fit import quad_fit_mu as tq

    def n_of(mu):
        return 1.0 + 0.8 * (mu - 0.3) - 0.2 * (mu - 0.3) ** 2
    mus = np.asarray([0.0, 0.1, 0.2])
    ns = np.asarray([n_of(m) for m in mus])
    assert tq(mus, ns, 0.5, step=1.0) == jq(mus, ns, 0.5, step=1.0)
    assert abs(n_of(tq(mus, ns, 0.5, step=1.0)) - 1.0) < 1e-6
    rng = np.random.RandomState(0)
    for _ in range(20):
        mus = rng.randn(4) * 0.05
        ns = 1.0 + rng.randn(4) * 0.01
        assert tq(mus, ns, 0.5, 0.05) == jq(mus, ns, 0.5, 0.05)


def _imp_problem(filling):
    """JAX lattice, embedding Hamiltonian and basis of the chain at
    `filling`, and the same carried into the port."""
    import libdmet_preview_tpu.dmet.hubbard as jdmet
    import libdmet_preview_tpu_torch.dmet.hubbard as tdmet
    from libdmet_preview_tpu_torch import interop
    Lat = jdmet.ChainLattice(18, 2)
    Lat.set_Ham(jdmet.Ham(Lat, U), use_hcore_as_emb_ham=True)
    vcor = jdmet.PMInitGuess([2], U, 0.5)
    rho, mu = jdmet.RHartreeFock(Lat, vcor, filling, U * 0.5)
    ImpHam, _, basis = jdmet.ConstructImpHam(Lat, rho, vcor, matching=False,
                                             int_bath=False)
    lat_t = tdmet.ChainLattice(18, 2)
    lat_t.set_Ham(tdmet.Ham(lat_t, U), use_hcore_as_emb_ham=True, device=CPU)
    ImpHam_t = interop.integral_from_numpy(
        ImpHam.norb, True, ImpHam.H0, ImpHam.H1["cd"], ImpHam.H2["ccdd"], CPU)
    return (Lat, ImpHam, np.asarray(basis)), \
        (lat_t, ImpHam_t, torch.as_tensor(np.array(basis)))


def test_apply_dmu_round_trip():
    """apply_dmu matches the JAX package (1e-14), works in place, and
    +dmu then -dmu restores H1 (1e-15)."""
    import libdmet_preview_tpu.dmet.hubbard as jdmet
    import libdmet_preview_tpu_torch.dmet.hubbard as tdmet
    (Lat, ImpHam, basis), (lat_t, ImpHam_t, basis_t) = _imp_problem(0.5)
    H1_before = ImpHam_t.H1["cd"].clone()
    held = ImpHam_t.H1["cd"]
    jdmet.apply_dmu(Lat, ImpHam, basis, 0.07)
    out = tdmet.apply_dmu(lat_t, ImpHam_t, basis_t, 0.07)
    assert out is ImpHam_t and ImpHam_t.H1["cd"] is held
    assert np.abs(held.numpy() - ImpHam.H1["cd"]).max() < 1e-14
    assert torch.max(torch.abs(held - H1_before)) > 1e-2
    tdmet.apply_dmu(lat_t, ImpHam_t, basis_t, -0.07)
    assert torch.max(torch.abs(held - H1_before)) < 1e-15


@pytest.mark.parametrize("filling", [0.5, 4.0 / 9.0])
def test_mu_solver_call_matches_jax(filling):
    """Two MuSolver calls in a row (the second uses predict on the first
    one's history) on the same ImpHam: dmu, electron count, E and rdm1
    1e-8.  At half filling the count is right at dmu = 0; at 8/9 of it
    the fit takes its secant and quadratic steps."""
    import libdmet_preview_tpu.dmet.hubbard as jdmet
    from libdmet_preview_tpu.solvers import FCI as JFCI
    import libdmet_preview_tpu_torch.dmet.hubbard as tdmet
    from libdmet_preview_tpu_torch.solvers import FCI as TFCI
    (Lat, ImpHam, basis), (lat_t, ImpHam_t, basis_t) = _imp_problem(filling)
    args = {"nelec": (Lat.ncore + Lat.nval) * 2}
    jmu, tmu = jdmet.MuSolver(adaptive=True), tdmet.MuSolver(adaptive=True)
    jsol = JFCI(restricted=True, tol=1e-11)
    tsol = TFCI(restricted=True, tol=1e-11, device=CPU)
    for call in range(2):
        rho_j, E_j, ImpHam, dmu_j = jmu(Lat, filling, ImpHam, basis, jsol,
                                        args)
        rho_t, E_t, ImpHam_t, dmu_t = tmu(lat_t, filling, ImpHam_t, basis_t,
                                          tsol, args)
        assert abs(dmu_t - dmu_j) < 1e-8
        assert abs(E_t - E_j) < 1e-8
        assert np.abs(rho_t.numpy() - np.asarray(rho_j)).max() < 1e-8
        n_j = jdmet.transformResults(rho_j, None, basis, None, None,
                                     lattice=Lat)
        n_t = tdmet.transformResults(rho_t, None, basis_t, None, None,
                                     lattice=lat_t)
        assert abs(n_t - n_j) < 1e-8
        assert len(tmu.history[-1]) == len(jmu.history[-1])
    if filling != 0.5:
        assert len(tmu.history[0]) >= 3 and abs(dmu_t) > 0.0
    assert np.abs(ImpHam_t.H1["cd"].numpy() - ImpHam.H1["cd"]).max() < 1e-8


def test_mu_solver_save_load(tmp_path):
    import libdmet_preview_tpu_torch.dmet.hubbard as tdmet
    m = tdmet.MuSolver()
    m.history = [[(0.0, 0.9), (0.02, 0.95)]]
    m.save(str(tmp_path / "mu.pkl"))
    m2 = tdmet.MuSolver()
    m2.load(str(tmp_path / "mu.pkl"))
    assert m2.history == m.history
    assert m2.predict(0.9, 1.0) == m.predict(0.9, 1.0) is not None
