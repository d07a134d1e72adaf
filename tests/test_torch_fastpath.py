"""
The PyTorch port's fused DMET lattice iteration
(libdmet_preview_tpu_torch/ops/fastpath.py) against the JAX package's
(libdmet_preview_tpu/ops/fastpath.py) on the same 1D Hubbard workload,
with DF factors, on the CPU.

The bath columns are fixed by eigh only up to sign/rotation, and the two
packages' LAPACK calls need not pick the same gauge, so the comparisons
are of gauge-invariant quantities: rho_R, the bath projector, the embH1
spectrum, the fitted parameters and error (each side builds its fit
target and carries it into its own fit basis), and eri_emb after mapping with
O = B_jax^T B_port.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import jax.numpy as jnp

torch.set_num_threads(1)

CPU = torch.device("cpu")
BETA = 1000.0
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_workload(restricted):
    import libdmet_preview_tpu.dmet.hubbard as dmet
    Lat = dmet.ChainLattice(18, 2)
    Lat.set_Ham(dmet.Ham(Lat, 4.0), use_hcore_as_emb_ham=True)
    if restricted:
        vcor = dmet.PMInitGuess((2,), 4.0, 0.5)
    else:
        vcor = dmet.AFInitGuess((2,), 4.0, 0.5)
    rng = np.random.RandomState(3)
    vcor.update(vcor.param + rng.randn(len(vcor.param)) * 0.05)
    return Lat, vcor


def _chol(nsites, naux=12, seed=4):
    rng = np.random.RandomState(seed)
    L = rng.randn(naux, nsites, nsites) * 0.1
    return 0.5 * (L + L.transpose(0, 2, 1))


def _port_from_jax(Lat, vcor):
    from libdmet_preview_tpu_torch import interop
    lat_t = interop.lattice_from_numpy(
        Lat.kmesh, Lat.nscsites, Lat.hcore_lo_R, Lat.fock_lo_R,
        Lat.ovlp_lo_R, Lat.val_idx, Lat.virt_idx, Lat.core_idx,
        Lat.use_hcore_as_emb_ham)
    vcor_t = interop.vcor_local_from_numpy(vcor.restricted, Lat.nscsites,
                                           vcor.param)
    return lat_t, vcor_t


def _target_in_step_basis(step, p0, dp, spin, rho, dummy):
    """Fit target: the Fermi density `rho` of the embedding H1 at p0 + dp,
    carried from that step's bath basis B1 into the bath basis B0 of the
    step at p0, where the fit runs: T0 = (B0^T B1) T1 (B1^T B0).  Under
    a gauge change of either basis T0 turns with B0 alone, so the fitted
    p and err do not depend on the gauge eigh picked."""
    _, _, embH1_p, _, B1 = step(p0 + dp, dummy)[:5]
    B0 = step(p0, dummy)[4]
    T = []
    for s in range(spin):
        O = B0[s].T @ B1[s]
        T.append(O @ rho(embH1_p[s]) @ O.T)
    return T


def _targets_jax(step, p0, spin, nelec2, dp):
    from libdmet_preview_tpu.ops.zlinalg import rho_fermi_real
    T = _target_in_step_basis(
        step, jnp.asarray(p0), jnp.asarray(dp), spin,
        lambda h: rho_fermi_real(h, nelec2, BETA)[0],
        jnp.zeros((spin, 4, 4)))
    return np.stack([np.asarray(t) for t in T])


def _targets_port(step, p0, spin, nelec2, dp):
    from libdmet_preview_tpu_torch.ops.zlinalg import rho_fermi_real
    T = _target_in_step_basis(
        step, p0, torch.as_tensor(dp), spin,
        lambda h: rho_fermi_real(h, nelec2, BETA)[0],
        torch.zeros((spin, 4, 4), dtype=torch.float64))
    return torch.stack(T)


@pytest.mark.parametrize("engine, restricted", [
    ("lm", True), ("cg", True), ("lm", False), ("cg", False)])
def test_fused_iteration_matches_jax(monkeypatch, engine, restricted):
    from libdmet_preview_tpu.ops.fastpath import \
        make_dmet_iteration as make_jax
    from libdmet_preview_tpu_torch.ops.fastpath import \
        make_dmet_iteration as make_port

    Lat, vcor = _jax_workload(restricted)
    spin = 1 if restricted else 2
    nelec2 = 2 * (Lat.ncore + Lat.nval)
    L = _chol(Lat.nsites)
    # the JAX step reads its engine when it first traces
    monkeypatch.setenv("LIBDMET_TPU_FIT_ENGINE", engine)
    step_j, p0_j = make_jax(Lat, vcor, 0.5, beta=BETA, fit_max_iter=30,
                            chol_L=L)
    lat_t, vcor_t = _port_from_jax(Lat, vcor)
    step_t, p0_t = make_port(lat_t, vcor_t, 0.5, beta=BETA, fit_max_iter=30,
                             chol_L=L, engine=engine, device=CPU)
    np.testing.assert_array_equal(p0_t.numpy(), p0_j)

    dp = np.random.RandomState(11).randn(len(p0_j)) * 0.1
    tgt_j = _targets_jax(step_j, p0_j, spin, nelec2, dp)
    tgt_t = _targets_port(step_t, p0_t, spin, nelec2, dp)

    p_j, err_j, embH1_j, rho_j, B_j, eri_j = (
        np.asarray(x) for x in step_j(jnp.asarray(p0_j), jnp.asarray(tgt_j)))
    p_t, err_t, embH1_t, rho_t, B_t, eri_t = (
        x.numpy() for x in step_t(p0_t, tgt_t))

    assert np.max(np.abs(rho_t - rho_j)) < 1e-8
    P_j = np.einsum("spi, sqi -> spq", B_j, B_j)
    P_t = np.einsum("spi, sqi -> spq", B_t, B_t)
    assert np.max(np.abs(P_t - P_j)) < 1e-8
    assert np.max(np.abs(np.linalg.eigvalsh(embH1_t)
                         - np.linalg.eigvalsh(embH1_j))) < 1e-8
    assert float(err_j) > 1e-6          # the fit had work to do
    assert np.max(np.abs(p_t - p_j)) < 1e-7
    assert abs(float(err_t) - float(err_j)) < 1e-9
    O = B_j[0].T @ B_t[0]
    eri_map = np.einsum("pi, qj, rk, sl, ijkl -> pqrs", O, O, O, O, eri_t,
                        optimize=True)
    assert np.abs(eri_map - eri_j).max() / np.abs(eri_j).max() < 1e-8


def test_chain_iterations_matches_sequential_steps():
    from libdmet_preview_tpu_torch.ops.fastpath import (chain_iterations,
                                                        make_dmet_iteration)
    Lat, vcor = _jax_workload(True)
    lat_t, vcor_t = _port_from_jax(Lat, vcor)
    step, p0 = make_dmet_iteration(lat_t, vcor_t, 0.5, beta=BETA,
                                   chol_L=_chol(Lat.nsites), device=CPU)
    tgt = _targets_port(step, p0, 1, 4, np.full(len(p0), 0.05))
    p_c, err_c = chain_iterations(step, 3)(p0, tgt)
    p = p0
    for _ in range(3):
        p, err = step(p, tgt)[:2]
    assert torch.max(torch.abs(p_c - p)) < 1e-12
    assert abs(float(err_c) - float(err)) < 1e-12


def test_native_and_interop_routes_agree():
    """The workload built through the port's own ChainLattice / Ham /
    PMInitGuess gives the same tensors as the one carried over from the
    JAX package's objects."""
    import libdmet_preview_tpu_torch.dmet.hubbard as dmet_t
    from libdmet_preview_tpu_torch.ops.fastpath import make_dmet_iteration
    Lat, vcor = _jax_workload(True)
    lat_i, vcor_i = _port_from_jax(Lat, vcor)
    lat_n = dmet_t.ChainLattice(18, 2)
    lat_n.set_Ham(dmet_t.Ham(lat_n, 4.0), use_hcore_as_emb_ham=True)
    vcor_n = dmet_t.PMInitGuess((2,), 4.0, 0.5)
    rng = np.random.RandomState(3)
    vcor_n.update(vcor_n.param + rng.randn(len(vcor_n.param)) * 0.05)

    np.testing.assert_array_equal(lat_n.hcore_lo_R, Lat.hcore_lo_R)
    for a, b in zip(lat_n.getH1(kspace=True), lat_i.getH1(kspace=True)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(lat_n._neg_map, lat_i._neg_map)
    L = _chol(Lat.nsites)
    step_n, p0_n = make_dmet_iteration(lat_n, vcor_n, 0.5, chol_L=L,
                                       device=CPU)
    step_i, p0_i = make_dmet_iteration(lat_i, vcor_i, 0.5, chol_L=L,
                                       device=CPU)
    assert torch.equal(p0_n, p0_i)
    bufs_i = dict(step_i.named_buffers())
    for name, b in step_n.named_buffers():
        assert torch.equal(b, bufs_i[name]), name


def test_port_import_leaves_jax_out():
    code = ("import sys, libdmet_preview_tpu_torch.interop, "
            "libdmet_preview_tpu_torch.ops.fastpath, "
            "libdmet_preview_tpu_torch.dmet.hubbard; "
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m.startswith('libdmet_preview_tpu.') "
            "or m == 'libdmet_preview_tpu']; "
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
