"""
The rest of the PyTorch port's vcor fit (libdmet_preview_tpu_torch/ops/
fit.py: FitVcorFull with its gradient and Powell branches, FitVcorTwoStep
with MaxIter2 > 0, the P_act / C_act hooks of FitVcorEmb with the
active-space projectors, the non-local get_dV_dparam, cvx_frac and
minimize(method="AH")) against the JAX package on the CPU.

Both packages get the SAME embedding basis (the JAX one, as NumPy) and
the same starting parameters: errors agree to 1e-8 and fitted parameters
to 1e-6.
"""

import copy

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

CPU = torch.device("cpu")


def _t(x):
    return torch.as_tensor(np.asarray(x), dtype=torch.float64)


def _pkgs():
    import libdmet_preview_tpu.dmet.hubbard as jdmet
    import libdmet_preview_tpu_torch.dmet.hubbard as tdmet
    return jdmet, tdmet


def _square_workload(beta, size=(6, 6), U=4.0):
    """6 x 6 Hubbard lattice with an AF vcor in both packages, the JAX
    package's bath basis and a perturbed target density."""
    from libdmet_preview_tpu.ops import mfd as jmfd, embham as jembham
    jdmet, tdmet = _pkgs()
    Lj, Lt = jdmet.SquareLattice(*size, 2, 2), tdmet.SquareLattice(*size, 2, 2)
    Lj.set_Ham(jdmet.Ham(Lj, U), use_hcore_as_emb_ham=False)
    Lt.set_Ham(tdmet.Ham(Lt, U), use_hcore_as_emb_ham=False, device=CPU)
    vj, vt = (d.AFInitGuess((2, 2), U, 0.5) for d in (jdmet, tdmet))
    rho, mu, E = jmfd.HF(Lj, vj, 0.5, False, beta=beta)
    basis = np.asarray(jembham.get_emb_basis(Lj, np.asarray(rho)))
    neo = basis.shape[-1]
    rho_emb = np.asarray(jembham.foldRho_k(Lj.R2k(np.asarray(rho)),
                                           Lj.R2k_basis(basis)))
    t = np.random.RandomState(3).randn(2, neo, neo) * 0.03
    target = rho_emb + 0.5 * (t + t.transpose(0, 2, 1))
    return (Lj, vj), (Lt, vt), basis, target


@pytest.mark.parametrize("imp_fit", [False, True])
def test_full_fit_objective_value_and_gradient(imp_fit):
    """The whole-lattice objective and its backward() gradient against
    the JAX package's value_and_grad program (through FitVcorFull's
    starting error) and central differences (1e-6 relative)."""
    from libdmet_preview_tpu.ops import fit as jfit
    from libdmet_preview_tpu_torch.ops import fit as tfit
    (Lj, vj), (Lt, vt), basis, target = _square_workload(30.0)
    fg = tfit.full_fit_objective(_t(target), Lt, _t(basis), vt, 30.0, 0.5,
                                 imp_fit=imp_fit)
    e0, g = fg(vt.param)
    _, eb_j, _ = jfit.FitVcorFull(target, Lj, basis, copy.deepcopy(vj), 30.0,
                                  0.5, MaxIter=0, imp_fit=imp_fit,
                                  gtol=1e9)
    assert abs(e0 - eb_j) < 1e-10
    rng = np.random.RandomState(0)
    for _ in range(3):
        d = rng.randn(len(g))
        d /= np.linalg.norm(d)
        eps = 1e-5
        num = (fg(vt.param + eps * d)[0] - fg(vt.param - eps * d)[0]) / (2 * eps)
        assert abs(g @ d - num) < 1e-6 * max(1.0, abs(num))


@pytest.mark.parametrize("bfgs", [False, True])
def test_fit_vcor_full_gradient_branch_matches_jax(bfgs):
    """FitVcorFull at finite temperature (minimize_cg, then the scipy CG /
    BFGS check) from identical starts: err_begin / err_end at 1e-8, the
    parameters at 1e-6.  The BFGS case fits the impurity block, as the
    6 x 6 Fock-embedding anchor does; the CG case fits the whole
    embedding density: with imp_fit the uniform diagonal shift is a flat
    direction (mu absorbs it), and CG's stopping point along it moves by
    1e-5 in the parameters between the packages."""
    from libdmet_preview_tpu.ops import fit as jfit
    from libdmet_preview_tpu_torch.ops import fit as tfit
    (Lj, vj), (Lt, vt), basis, target = _square_workload(30.0)
    kw = dict(MaxIter=40, imp_fit=bfgs, BFGS=bfgs, CG_check=not bfgs)
    vj2, ebj, eej = jfit.FitVcorFull(target, Lj, basis, vj, 30.0, 0.5, **kw)
    tfit.FitVcorFull.n_eval = 0
    vt2, ebt, eet = tfit.FitVcorFull(_t(target), Lt, _t(basis), vt, 30.0, 0.5,
                                     **kw)
    assert tfit.FitVcorFull.n_eval > 2
    assert abs(ebt - ebj) < 1e-8 and abs(eet - eej) < 1e-8
    assert eet < ebt
    assert np.abs(vt2.param - vj2.param).max() < 1e-6


def _chain_fci_workload():
    """The JAX package's test_fit_vcor_full_stage inputs: 12-site chain,
    restricted, the FCI density of the non-interacting-bath problem."""
    from libdmet_preview_tpu.solvers import FCI
    jdmet, tdmet = _pkgs()
    Lj, Lt = jdmet.ChainLattice(12, 2), tdmet.ChainLattice(12, 2)
    Lj.set_Ham(jdmet.Ham(Lj, 4.0), use_hcore_as_emb_ham=True)
    Lt.set_Ham(tdmet.Ham(Lt, 4.0), use_hcore_as_emb_ham=True, device=CPU)
    vj, vt = (d.PMInitGuess([2], 4.0, 0.5) for d in (jdmet, tdmet))
    rho, mu = jdmet.RHartreeFock(Lj, vj, 0.5, None)
    ImpHam, H1e, basis = jdmet.ConstructImpHam(Lj, rho, vj, matching=False,
                                               int_bath=False)
    rhoEmb, E = FCI(restricted=True, tol=1e-11).run(
        ImpHam, nelec=(Lj.ncore + Lj.nval) * 2)
    return (Lj, vj), (Lt, vt), np.asarray(basis), np.asarray(rhoEmb)


def test_fit_vcor_full_powell_branch_and_two_step_match_jax():
    """The derivative-free branch (zero temperature) and FitVcorTwoStep
    with MaxIter2 > 0: errors at 1e-8, parameters at 1e-6; the full stage
    never worsens its own objective."""
    from libdmet_preview_tpu.ops import fit as jfit
    from libdmet_preview_tpu_torch.ops import fit as tfit
    jdmet, tdmet = _pkgs()
    (Lj, vj), (Lt, vt), basis, rhoEmb = _chain_fci_workload()
    vj2, ebj, eej = jfit.FitVcorFull(rhoEmb, Lj, basis, copy.deepcopy(vj),
                                     np.inf, 0.5, MaxIter=8)
    vt2, ebt, eet = tfit.FitVcorFull(_t(rhoEmb), Lt, _t(basis),
                                     copy.deepcopy(vt), np.inf, 0.5,
                                     MaxIter=8)
    assert abs(ebt - ebj) < 1e-8 and abs(eet - eej) < 1e-8
    assert eet <= ebt + 1e-12
    assert np.abs(vt2.param - vj2.param).max() < 1e-6

    v2j, e2j = jdmet.FitVcor(rhoEmb, Lj, basis, vj, np.inf, 0.5,
                             MaxIter1=150, MaxIter2=5)
    v2t, e2t = tdmet.FitVcor(_t(rhoEmb), Lt, _t(basis), vt, np.inf, 0.5,
                             MaxIter1=150, MaxIter2=5)
    assert abs(e2t - e2j) < 1e-8
    assert np.abs(v2t.param - v2j.param).max() < 1e-6


def test_fit_vcor_full_nonlocal_vcor_runs_powell():
    """A non-local vcor at finite temperature takes the Powell branch
    over HF's k-resolved potential, as in the JAX package: 1e-8 / 1e-6."""
    from libdmet_preview_tpu.ops import fit as jfit
    from libdmet_preview_tpu_torch.ops import fit as tfit
    jdmet, tdmet = _pkgs()
    (Lj, _), (Lt, _), basis, rhoEmb = _chain_fci_workload()
    out = []
    for dmet, fit, Lat, conv in ((jdmet, jfit, Lj, np.asarray),
                                 (tdmet, tfit, Lt, _t)):
        v = dmet.VcorNonLocal(True, False, Lat, rcells=[0, 1])
        v.update(np.full(v.length(), 0.01))
        out.append(fit.FitVcorFull(conv(rhoEmb), Lat, conv(basis), v, 20.0,
                                   0.5, MaxIter=2))
    (vj, ebj, eej), (vt, ebt, eet) = out
    assert abs(ebt - ebj) < 1e-8 and abs(eet - eej) < 1e-8
    assert np.abs(vt.param - vj.param).max() < 1e-6


@pytest.mark.parametrize("restricted", [True, False])
def test_get_dv_dparam_nonlocal_matches_jax(restricted):
    """dV_emb/dparam of a VcorNonLocal through k space: 1e-10."""
    from libdmet_preview_tpu.ops import fit as jfit
    from libdmet_preview_tpu_torch.ops import fit as tfit
    jdmet, tdmet = _pkgs()
    Lj, Lt = jdmet.ChainLattice(12, 2), tdmet.ChainLattice(12, 2)
    vj = jdmet.VcorNonLocal(restricted, False, Lj, rcells=[0, 1, 4])
    vt = tdmet.VcorNonLocal(restricted, False, Lt, rcells=[0, 1, 4])
    spin = 1 if restricted else 2
    basis = np.random.RandomState(1).randn(spin, 6, 2, 4)
    ref = jfit.get_dV_dparam(vj, basis, basis_k=Lj.R2k_basis(basis),
                             kmesh=Lj.kmesh)
    out = tfit.get_dV_dparam(vt, _t(basis), basis_k=Lt.R2k_basis(_t(basis)),
                             kmesh=Lt.kmesh)
    assert out.shape == ref.shape
    assert np.abs(out.numpy() - ref).max() < 1e-10
    out2 = tfit.get_dV_dparam(vt, _t(basis), kmesh=Lt.kmesh)
    assert np.abs(out2.numpy() - ref).max() < 1e-10


def test_cvx_frac_matches_jax():
    from libdmet_preview_tpu.ops.fit import cvx_frac as cj
    from libdmet_preview_tpu_torch.ops.fit import cvx_frac as ct
    rng = np.random.RandomState(3)
    A = rng.randn(6, 6)
    _, C = np.linalg.eigh(A + A.T)
    d0 = np.array([1.0, 0.8, 0.6, 0.4, 0.2, 0.0])
    rho = C @ np.diag(d0) @ C.T
    for r, n in ((rho, d0.sum()), (3.0 * rho, 3.0)):
        w = ct(C, r, n)
        assert np.abs(w - cj(C, r, n)).max() < 1e-12
        assert abs(w.sum() - n) < 1e-8
        assert w.min() >= -1e-12 and w.max() <= 1 + 1e-12
    assert np.allclose(np.sort(ct(C, rho, d0.sum())), np.sort(d0), atol=1e-7)


def test_minimize_ah_with_torch_hvp_matches_jax():
    """minimize(method="AH") on the JAX test's quartic bowl, the
    Hessian-vector product from torch.autograd.functional.jvp through the
    gradient where the JAX test uses jax.jvp: same minimizer (1e-8) and
    value (1e-10); without hvp (finite differences) it lands there too."""
    import jax
    import jax.numpy as jnp
    from libdmet_preview_tpu.ops.fit import minimize as mj
    from libdmet_preview_tpu_torch.ops.fit import minimize as mt
    rng = np.random.RandomState(0)
    n = 12
    A = rng.randn(n, n)
    A = A @ A.T + np.eye(n)
    b = rng.randn(n)

    def cost_j(x):
        return 0.5 * x @ (A @ x) - b @ x + 0.05 * jnp.sum(x ** 4)

    vg = jax.jit(jax.value_and_grad(cost_j))
    grad_j = jax.jit(jax.grad(cost_j))

    def fg_j(x):
        f, g = vg(jnp.asarray(x))
        return float(f), np.asarray(g)

    def hvp_j(x, p):
        return np.asarray(jax.jvp(grad_j, (jnp.asarray(x),),
                                  (jnp.asarray(p),))[1])

    At, bt = _t(A), _t(b)

    def cost_t(x):
        return 0.5 * x @ (At @ x) - bt @ x + 0.05 * torch.sum(x ** 4)

    def grad_t(x):
        return torch.autograd.functional.jacobian(cost_t, x,
                                                  create_graph=True)

    def fg_t(x):
        x = _t(x).requires_grad_(True)
        f = cost_t(x)
        (g,) = torch.autograd.grad(f, x)
        return float(f), g.numpy()

    def hvp_t(x, p):
        return torch.autograd.functional.jvp(grad_t, _t(x), _t(p))[1].numpy()

    xj, fj = mj(fg_j, np.zeros(n), method="AH", max_iter=50, hvp=hvp_j,
                gtol=1e-9)
    xt, ft = mt(fg_t, np.zeros(n), method="AH", max_iter=50, hvp=hvp_t,
                gtol=1e-9)
    assert np.abs(fg_t(xt)[1]).max() < 1e-8
    assert np.abs(xt - xj).max() < 1e-8 and abs(ft - fj) < 1e-10
    x_fd, f_fd = mt(fg_t, np.zeros(n), method="NEWTON", max_iter=50,
                    gtol=1e-7)
    assert np.abs(x_fd - xt).max() < 1e-5
    # second-order convergence beats plain CG at an equal iteration budget
    _, f_cg = mt(fg_t, np.zeros(n), method="CG", max_iter=8)
    _, f_ah = mt(fg_t, np.zeros(n), method="AH", max_iter=8, hvp=hvp_t)
    assert f_ah <= f_cg + 1e-12


def _active_workload():
    from libdmet_preview_tpu.ops import mfd as jmfd, embham as jembham
    jdmet, tdmet = _pkgs()
    Lj, Lt = jdmet.ChainLattice(8, 2), tdmet.ChainLattice(8, 2)
    Lj.set_Ham(jdmet.Ham(Lj, 4.0), use_hcore_as_emb_ham=True)
    Lt.set_Ham(tdmet.Ham(Lt, 4.0), use_hcore_as_emb_ham=True, device=CPU)
    vj, vt = (d.PMInitGuess((2,), 4.0, 0.0) for d in (jdmet, tdmet))
    # filling 3/8 keeps the discrete chain spectrum gapped
    rho, mu, E = jmfd.HF(Lj, vj, 3.0 / 8.0, True)
    basis = np.asarray(jembham.embBasis(Lj, rho))
    neo = basis.shape[-1]
    t = np.random.RandomState(7).randn(1, neo, neo) * 0.05
    target = np.eye(neo)[None] * 0.5 + 0.5 * (t + t.transpose(0, 2, 1))
    return (Lj, vj), (Lt, vt), np.asarray(rho), basis, target


def test_active_projectors_match_jax():
    """get_active_projector, make_rdm1_P and get_active_projector_full on
    the chain's mean-field density: 1e-10 (the projector columns through
    P P^T, which is gauge free)."""
    from libdmet_preview_tpu.ops import fit as jfit
    from libdmet_preview_tpu_torch.ops import fit as tfit
    (Lj, _), (Lt, _), rho, _, _ = _active_workload()
    rho_full = Lj.expand(rho)
    assert np.abs(Lt.expand(rho) - rho_full).max() < 1e-12
    fock_full = Lj.expand(np.asarray(Lj.getH1(kspace=False)))[None]
    for act in (range(rho_full.shape[-1]), [0, 1, 2, 3]):
        Pj, nj = jfit.get_active_projector(act, rho_full)
        Pt, nt = tfit.get_active_projector(act, rho_full)
        assert np.array_equal(nt, nj) and Pt.shape == Pj.shape
        assert np.abs(tfit.get_active_projector_full(Pt)
                      - jfit.get_active_projector_full(Pj)).max() < 1e-10
        assert np.abs(Pt[0].T @ Pt[0] - np.eye(Pt.shape[-1])).max() < 1e-10
        for back in (True, False):
            rj = jfit.make_rdm1_P(fock_full, None, Pj, nj, project_back=back)
            rt = tfit.make_rdm1_P(fock_full, None, Pj, nj, project_back=back)
            assert np.abs(rt - rj).max() < 1e-10


@pytest.mark.parametrize("beta", [400.0, np.inf])
def test_fit_vcor_emb_active_space_hooks_match_jax(beta):
    """FitVcorEmb with P_act / C_act: the full-space projector reproduces
    the plain fit's starting error, and the restricted subspace fit (also
    at zero temperature, through the beta = 1e6 Fermi op) agrees with the
    JAX package: errors 1e-8, parameters 1e-6."""
    from libdmet_preview_tpu.ops import fit as jfit
    from libdmet_preview_tpu_torch.ops import fit as tfit
    (Lj, vj), (Lt, vt), rho, basis, target = _active_workload()
    rho_full = Lj.expand(rho)
    neo = basis.shape[-1]
    P, _ = jfit.get_active_projector(range(rho_full.shape[-1]), rho_full)
    P2, _ = jfit.get_active_projector([0, 1, 2, 3], rho_full)
    Bf = basis[0].reshape(-1, neo)
    C_act = Bf.T @ (jfit.get_active_projector_full(P2)[0] @ Bf)
    w, V = np.linalg.eigh(C_act @ C_act.T)
    C_cols = V[:, w > 1e-8]

    _, e0_plain, _ = tfit.FitVcorEmb(_t(target), Lt, _t(basis),
                                     copy.deepcopy(vt), beta, MaxIter=80)
    _, e0_act, _ = tfit.FitVcorEmb(_t(target), Lt, _t(basis),
                                   copy.deepcopy(vt), beta, MaxIter=80,
                                   P_act=P, C_act=np.eye(neo)[None])
    assert abs(e0_act - e0_plain) < (1e-10 if beta < np.inf else 1e-6)

    vj3, e0j, e1j = jfit.FitVcorEmb(target, Lj, basis, copy.deepcopy(vj),
                                    beta, MaxIter=60, P_act=P2,
                                    C_act=C_cols[None])
    vt3, e0t, e1t = tfit.FitVcorEmb(_t(target), Lt, _t(basis),
                                    copy.deepcopy(vt), beta, MaxIter=60,
                                    P_act=P2, C_act=C_cols[None])
    assert abs(e0t - e0j) < 1e-8 and abs(e1t - e1j) < 1e-8
    assert e1t < e0t
    assert np.abs(vt3.param - vj3.param).max() < 1e-6
    assert np.linalg.norm(vt3.param - vt.param) > 1e-8
