"""
The PyTorch port's vcor-fit engines (libdmet_preview_tpu_torch/ops/fit.py:
_cg_engine, _lm_engine_ft) against the JAX package's
(libdmet_preview_tpu/ops/fit.py) on identical embH1 / dV_emb / target.
Tolerances: p 1e-7, err 1e-9.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

torch.set_num_threads(1)

BETA, NELEC2 = 400.0, 8      # 4 electrons in 8 orbitals per spin


def _problem(spin, seed=5, n=8, P=10):
    from libdmet_preview_tpu.ops.zlinalg import rho_fermi_real
    rng = np.random.RandomState(seed)
    embH1 = rng.randn(spin, n, n)
    embH1 = embH1 + embH1.transpose(0, 2, 1)
    dV = rng.randn(P, spin, n, n) * 0.3
    dV = dV + dV.transpose(0, 1, 3, 2)
    p_true = rng.randn(P) * 0.2
    Ht = embH1 + np.einsum("P, Psij -> sij", p_true, dV)
    target = np.stack([np.asarray(rho_fermi_real(jnp.asarray(Ht[s]), NELEC2,
                                                 BETA)[0])
                       for s in range(spin)])
    # a perturbed target: the fit cannot reach zero residual
    target = target + 0.01 * rng.randn(*target.shape)
    return embH1, dV, target


def _err_jax(embH1, dV, target):
    from libdmet_preview_tpu.ops.zlinalg import rho_fermi_real
    spin = embH1.shape[0]

    def err(p):
        Heff = embH1 + jnp.einsum("P, Psij -> sij", p, dV)
        errs = 0.0
        for s in range(spin):
            r1, _ = rho_fermi_real(Heff[s], NELEC2, BETA)
            errs = errs + jnp.sum((r1 - target[s]) ** 2)
        return jnp.sqrt(errs / spin)
    return err


def _fg_port(embH1, dV, target):
    from libdmet_preview_tpu_torch.ops.zlinalg import rho_fermi_real
    spin = embH1.shape[0]

    def fg(p):
        p = p.detach().requires_grad_(True)
        Heff = embH1 + torch.einsum("P, Psij -> sij", p, dV)
        errs = 0.0
        for s in range(spin):
            r1, _ = rho_fermi_real(Heff[s], NELEC2, BETA)
            errs = errs + torch.sum((r1 - target[s]) ** 2)
        f = torch.sqrt(errs / spin)
        g, = torch.autograd.grad(f, p)
        return f.detach(), g
    return fg


@pytest.mark.parametrize("spin", [1, 2])
@pytest.mark.parametrize("engine", ["cg", "lm"])
def test_fit_engine_matches_jax(engine, spin):
    from libdmet_preview_tpu.ops import fit as fit_j
    from libdmet_preview_tpu_torch.ops import fit as fit_t
    embH1, dV, target = _problem(spin)
    P = dV.shape[0]
    p0 = np.zeros(P)
    tt = [torch.as_tensor(x, dtype=torch.float64)
          for x in (p0, embH1, dV, target)]
    if engine == "cg":
        fg_j = jax.value_and_grad(_err_jax(jnp.asarray(embH1),
                                           jnp.asarray(dV),
                                           jnp.asarray(target)))
        p_j, err_j, _ = fit_j._cg_engine(fg_j, jnp.asarray(p0), 40, 1e-10,
                                         1e-6)
        p_t, err_t, _ = fit_t._cg_engine(_fg_port(*tt[1:]), tt[0], 40,
                                         1e-10, 1e-6)
    else:
        p_j, err_j, _ = fit_j._lm_engine_ft(
            jnp.asarray(p0), jnp.asarray(embH1), jnp.asarray(dV),
            jnp.asarray(target), NELEC2, BETA, 40, 1e-10, 1e-6)
        p_t, err_t, _ = fit_t._lm_engine_ft(*tt, NELEC2, BETA, 40, 1e-10,
                                            1e-6)
    err_start = float(_err_jax(jnp.asarray(embH1), jnp.asarray(dV),
                               jnp.asarray(target))(jnp.asarray(p0)))
    assert float(err_j) < 0.5 * err_start          # the fit made progress
    assert np.max(np.abs(p_t.numpy() - np.asarray(p_j))) < 1e-7
    assert abs(float(err_t) - float(err_j)) < 1e-9


def _traced(module, engine, args):
    """Run `engine(*args)` with module._lm_loop's state function wrapped:
    returns (result, [err of every state evaluation])."""
    errs = []
    loop = module._lm_loop

    def traced_loop(state, *a, **k):
        def traced_state(p):
            out = state(p)
            errs.append(float(out[0]))
            return out
        return loop(traced_state, *a, **k)

    module._lm_loop = traced_loop
    try:
        return engine(*args), errs
    finally:
        module._lm_loop = loop


def test_lm_fit_steps_on_the_bench_workload_match_jax():
    """The LM fit of the fused iteration at the bench workload (Nk=27,
    nlo=16, neo=32, 20 steps allowed; chip_smoke.make_bench_workload with
    the target carried into the fit basis) takes the same steps in both
    packages: 3, each accepted, stopped by max|grad err| < 0.1 gtol and
    not by two small or rejected steps in a row.  Run with -s for the
    trace."""
    import chip_smoke as cs
    from libdmet_preview_tpu.ops import fit as jfit
    from libdmet_preview_tpu_torch.ops import fastpath
    from libdmet_preview_tpu_torch.ops import fit as tfit
    cpu = torch.device("cpu")
    Lat, vcor, rho_t, L = cs.make_bench_workload(naux=4)
    captured = []
    engine = fastpath._lm_engine_ft
    fastpath._lm_engine_ft = lambda *a: captured.append(a) or engine(*a)
    try:
        step, p0 = fastpath.make_dmet_iteration(
            Lat, vcor, cs.FILLING, beta=cs.BETA,
            fit_max_iter=cs.N_FIT_STEPS, chol_L=L, engine="lm", device=cpu)
        dp = np.random.RandomState(7).randn(len(vcor.param)) * 0.1
        tgt = cs.target_in_fit_basis(step, p0, torch.as_tensor(dp),
                                     torch.as_tensor(rho_t), cs.bench_target)
        captured.clear()
        step(p0, tgt)
    finally:
        fastpath._lm_engine_ft = engine
    (args,) = captured
    max_iter, ytol, gtol = args[6:9]
    (p_t, err_t, g_t), errs_t = _traced(tfit, tfit._lm_engine_ft, args)
    args_j = [jnp.asarray(a.numpy()) if isinstance(a, torch.Tensor) else a
              for a in args]
    with jax.disable_jit():         # the while_loop then runs in Python
        (p_j, err_j, g_j), errs_j = _traced(jfit, jfit._lm_engine_ft, args_j)

    def steps(errs):
        best, seq = errs[0], []
        for e in errs[1:]:
            seq.append("accept" if e < best else "reject")
            best = min(best, e)
        return seq

    print("port: err per state evaluation %s, steps %s, max|grad| %.3e"
          % (errs_t, steps(errs_t), float(g_t)))
    print("jax:  err per state evaluation %s, steps %s, max|grad| %.3e; "
          "max|p_port - p_jax| %.3e"
          % (errs_j, steps(errs_j), float(g_j),
             float(np.abs(p_t.numpy() - np.asarray(p_j)).max())))
    assert steps(errs_t) == steps(errs_j) == ["accept"] * 3
    assert len(errs_t) - 1 < max_iter
    assert np.abs(np.asarray(errs_t) - np.asarray(errs_j)).max() < 1e-10
    assert float(g_t) < 0.1 * gtol and float(g_j) < 0.1 * gtol
    assert errs_t[-2] - errs_t[-1] > ytol       # not the small-step rule
    assert np.abs(p_t.numpy() - np.asarray(p_j)).max() < 1e-10
