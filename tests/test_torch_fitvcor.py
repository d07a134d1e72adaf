"""
The PyTorch port's vcor fit (libdmet_preview_tpu_torch/ops/fit.py:
get_dV_dparam, _fit_err_grad, FitVcorEmb, the vcor helpers) against the
JAX package's (libdmet_preview_tpu/ops/fit.py) on the CPU.

Workloads: ChainLattice(18, 2) with a restricted vcor and
SquareLattice(8, 8, 2, 2) with the antiferromagnetic guess, built natively
in each package.  Both fits run in the JAX package's bath basis (carried
across as NumPy) against the same target, the mean-field density at a
vcor perturbed with a seeded NumPy draw, folded into that basis.
"""

from functools import lru_cache

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

CPU = torch.device("cpu")
U, FILLING = 4.0, 0.5


def _build(dmet, kind, **set_ham_kwargs):
    if kind == "chain":
        Lat = dmet.ChainLattice(18, 2)
        vcor = dmet.PMInitGuess([2], U, FILLING)
    else:
        Lat = dmet.SquareLattice(8, 8, 2, 2)
        vcor = dmet.AFInitGuess((2, 2), U, FILLING)
    Lat.set_Ham(dmet.Ham(Lat, U), use_hcore_as_emb_ham=True,
                **set_ham_kwargs)
    return Lat, vcor


@lru_cache(maxsize=None)
def workload(kind, beta):
    """((JAX lattice, vcor), (port lattice, vcor), basis, target): the
    JAX package's bath basis at the starting vcor and the folded
    mean-field density at a perturbed vcor, both NumPy."""
    import libdmet_preview_tpu.dmet.hubbard as jdmet
    from libdmet_preview_tpu.ops import embham as jembham
    import libdmet_preview_tpu_torch.dmet.hubbard as tdmet
    Lat, vcor = _build(jdmet, kind)
    lat_t, vcor_t = _build(tdmet, kind, device=CPU)
    assert np.array_equal(vcor_t.param, vcor.param)
    rho, mu = jdmet.HartreeFock(Lat, vcor, FILLING, U * FILLING, beta=beta)
    basis = np.array(jembham.embBasis(Lat, rho))
    pert = jdmet.AFInitGuess((2, 2), U, FILLING) if kind == "square" \
        else jdmet.PMInitGuess([2], U, FILLING)
    dp = np.random.RandomState(5).randn(vcor.length()) * 0.2
    pert.update(vcor.param + dp)
    _, _, res = jdmet.HartreeFock(Lat, pert, FILLING, U * FILLING,
                                  beta=beta, ires=True)
    target = np.array(jembham.foldRho_k(res["rho_k"],
                                        Lat.R2k_basis(basis)))
    return (Lat, vcor), (lat_t, vcor_t), basis, target


def _objective_args(kind):
    """The zero-T objective's arguments as NumPy, from the JAX side."""
    from libdmet_preview_tpu.ops import embham as jembham, fit as jfit
    (Lat, vcor), _, basis, target = workload(kind, np.inf)
    spin, neo = basis.shape[0], basis.shape[-1]
    embH1 = np.asarray(jembham.transform_h1(Lat.getH1(kspace=True),
                                            Lat.R2k_basis(basis)))
    dV = jfit.get_dV_dparam(vcor, basis)
    Li = np.stack([np.eye(neo)] * spin)
    mask = np.ones((spin, neo, neo))
    nelec = (Lat.nval,) * spin
    return vcor, basis, embH1, dV, Li, mask, target, nelec


@pytest.mark.parametrize("kind", ["chain", "square"])
def test_get_dV_dparam_matches_jax(kind):
    """1e-12."""
    from libdmet_preview_tpu_torch.ops import fit as tfit
    vcor, basis, _, dV, _, _, _, _ = _objective_args(kind)
    _, (_, vcor_t), _, _ = workload(kind, np.inf)
    dV_t = tfit.get_dV_dparam(vcor_t, torch.as_tensor(basis))
    assert dV_t.shape == dV.shape
    assert np.abs(dV_t.numpy() - dV).max() < 1e-12


@pytest.mark.parametrize("kind", ["chain", "square"])
def test_fit_err_grad_matches_jax_and_finite_differences(kind):
    """Value 1e-10 and gradient 1e-8 against the JAX package; gradient
    against central differences of the port's own value, 1e-6."""
    import jax.numpy as jnp
    from libdmet_preview_tpu.ops import fit as jfit
    from libdmet_preview_tpu_torch.ops import fit as tfit
    vcor, _, embH1, dV, Li, mask, target, nelec = _objective_args(kind)
    p = vcor.param + np.random.RandomState(2).randn(vcor.length()) * 0.05
    arrs = (embH1, dV, Li, mask, target)
    e_j, g_j = jfit._fit_err_grad(jnp.asarray(p),
                                  *[jnp.asarray(a) for a in arrs],
                                  nelec=nelec)
    args_t = [torch.as_tensor(np.array(a)) for a in arrs]
    e_t, g_t = tfit._fit_err_grad(torch.as_tensor(p), *args_t, nelec=nelec)
    assert abs(float(e_t) - float(e_j)) < 1e-10
    assert np.abs(g_t.numpy() - np.asarray(g_j)).max() < 1e-8
    eps = 1e-6
    for k in range(len(p)):
        pp, pm = p.copy(), p.copy()
        pp[k] += eps
        pm[k] -= eps
        fd = (float(tfit._fit_err(torch.as_tensor(pp), *args_t, nelec))
              - float(tfit._fit_err(torch.as_tensor(pm), *args_t, nelec))) \
            / (2 * eps)
        assert abs(float(g_t[k]) - fd) < 1e-6


@pytest.mark.parametrize("kind,beta,kwargs", [
    ("chain", np.inf, {}), ("chain", 50.0, {}),
    ("square", np.inf, {}), ("square", 50.0, {}),
    ("square", np.inf, {"imp_fit": True}),
    ("chain", 50.0, {"method": "LM"})])
def test_fit_vcor_emb_matches_jax(kind, beta, kwargs):
    """The whole fit from the same start, basis and target: begin and end
    errors 1e-8, fitted parameters 1e-6.  method="LM" at finite beta is
    the Levenberg-Marquardt engine in both packages."""
    import copy
    from libdmet_preview_tpu.ops import fit as jfit
    from libdmet_preview_tpu_torch.ops import fit as tfit
    (Lat, vcor), (lat_t, vcor_t), basis, target = workload(kind, beta)
    v_j, e0_j, e1_j = jfit.FitVcorEmb(target, Lat, basis,
                                      copy.deepcopy(vcor), beta, **kwargs)
    v_t, e0_t, e1_t = tfit.FitVcorEmb(torch.as_tensor(target), lat_t,
                                      torch.as_tensor(basis),
                                      copy.deepcopy(vcor_t), beta, **kwargs)
    assert abs(e0_t - e0_j) < 1e-8
    assert abs(e1_t - e1_j) < 1e-8
    assert e1_t < e0_t
    assert np.abs(v_t.param - v_j.param).max() < 1e-6


def test_lm_at_zero_temperature_runs_cg():
    """method="LM" with beta = inf takes the CG engine, as in the JAX
    package: same result as method="CG", exactly."""
    import copy
    from libdmet_preview_tpu_torch.ops import fit as tfit
    _, (lat_t, vcor_t), basis, target = workload("chain", np.inf)
    out = [tfit.FitVcorEmb(torch.as_tensor(target), lat_t,
                           torch.as_tensor(basis), copy.deepcopy(vcor_t),
                           np.inf, method=m)[0].param for m in ("CG", "LM")]
    assert np.array_equal(out[0], out[1])


def test_vcor_helpers_exact():
    """addDiag, vcor_diag_average, make_vcor_trace_unchanged and
    keep_vcor_trace_fixed give the JAX package's parameters exactly."""
    import libdmet_preview_tpu.dmet.hubbard as jdmet
    from libdmet_preview_tpu.ops import fit as jfit
    import libdmet_preview_tpu_torch.dmet.hubbard as tdmet
    from libdmet_preview_tpu_torch.ops import fit as tfit
    out = []
    for dmet, fit in ((jdmet, jfit), (tdmet, tfit)):
        old = dmet.AFInitGuess((2, 2), U, FILLING)
        new = dmet.AFInitGuess((2, 2), U, FILLING)
        new.update(old.param
                   + np.random.RandomState(3).randn(old.length()) * 0.1)
        fit.addDiag(new, 0.25)
        avg = fit.vcor_diag_average(new)
        fit.make_vcor_trace_unchanged(new, old)
        fixed = fit.keep_vcor_trace_fixed(
            dmet.AFInitGuess((2, 2), U, 0.3), old)
        out.append((new.param.copy(), avg, fixed.param.copy()))
    for a, b in zip(*out):
        assert np.array_equal(a, b)


def test_unported_fit_branches_raise():
    """The fit branches that used to raise (the whole-lattice stage of
    FitVcorTwoStep, the C_act hook of FitVcorEmb) now run; what the fit
    module still cannot do is a Bogoliubov non-local vcor, which raises
    and names its slice."""
    import copy
    from libdmet_preview_tpu_torch.ops import fit as tfit
    from libdmet_preview_tpu_torch.ops.vcor import VcorNonLocal
    _, (lat_t, vcor_t), basis, target = workload("chain", np.inf)
    B, T = torch.as_tensor(basis), torch.as_tensor(target)
    v2, err2 = tfit.FitVcorTwoStep(T, lat_t, B, copy.deepcopy(vcor_t), np.inf,
                                   FILLING, MaxIter1=20, MaxIter2=2)
    assert np.isfinite(err2)
    _, e0, e1 = tfit.FitVcorEmb(T, lat_t, B, copy.deepcopy(vcor_t), np.inf,
                                MaxIter=20, C_act=np.eye(4))
    assert np.isfinite(e0) and e1 <= e0
    with pytest.raises(NotImplementedError, match="Slice 4"):
        VcorNonLocal(True, True, lat_t)
