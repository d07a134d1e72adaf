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
