"""
The PyTorch port's entry points (libdmet_preview_tpu_torch/entry.py)
against the JAX package's (__graft_entry__.py) on the CPU: entry()'s fused
iteration on the 1D Hubbard flagship, and dryrun_multichip in a fresh
process on a gloo group.

The bath columns are fixed only up to a rotation, so the step's outputs
are compared gauge-invariantly: the fitted parameters and error (the
target, half the identity, is gauge-invariant), rho_R, the bath projector
and the embH1 spectrum.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

torch.set_num_threads(1)


def test_entry_step_matches_jax(monkeypatch):
    import __graft_entry__ as graft
    from libdmet_preview_tpu_torch.entry import entry
    # the JAX step reads its fit engine when it first traces; the port's
    # is Levenberg-Marquardt
    monkeypatch.setenv("LIBDMET_TPU_FIT_ENGINE", "lm")
    step_j, (p0_j, tgt_j) = graft.entry()
    step_t, (p0_t, tgt_t) = entry(device="cpu")
    assert p0_t.device.type == "cpu"
    np.testing.assert_array_equal(p0_t.numpy(), np.asarray(p0_j))
    np.testing.assert_array_equal(tgt_t.numpy(), np.asarray(tgt_j))
    p_j, err_j, embH1_j, rho_j, B_j = (np.asarray(x)
                                       for x in step_j(p0_j, tgt_j))
    p_t, err_t, embH1_t, rho_t, B_t = (x.numpy() for x in step_t(p0_t, tgt_t))
    assert np.max(np.abs(rho_t - rho_j)) < 1e-8
    P_j = np.einsum("spi, sqi -> spq", B_j, B_j)
    P_t = np.einsum("spi, sqi -> spq", B_t, B_t)
    assert np.max(np.abs(P_t - P_j)) < 1e-8
    assert np.max(np.abs(np.linalg.eigvalsh(embH1_t)
                         - np.linalg.eigvalsh(embH1_j))) < 1e-8
    assert np.max(np.abs(p_t - p_j)) < 1e-8
    assert abs(float(err_t) - float(err_j)) < 1e-8


def test_entry_defaults_to_the_card():
    """entry() puts its tensors on CUDA unless asked for the CPU: on a
    machine without a card it raises."""
    from libdmet_preview_tpu_torch.entry import entry
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises((RuntimeError, AssertionError)):
        entry()


def test_dryrun_multichip_two_gloo_ranks(capsys):
    from libdmet_preview_tpu_torch.entry import dryrun_multichip
    out = dryrun_multichip(2, backend="gloo", device="cpu", timeout=300)
    ranks = out["dryrun"]["ranks"]
    assert [r["rank"] for r in ranks] == [0, 1]
    it = ranks[0]["iteration"]
    assert it["mesh"] == [2, 1]
    assert abs(it["nelec_imp"] - 1.0) < 1e-5
    assert max(it["err_mf"], it["err_h1"], it["err_eri"]) < 1e-8
    assert "dryrun_multichip(2, gloo on cpu)" in capsys.readouterr().out


def test_dryrun_multichip_raises_when_the_run_fails():
    """NCCL with more ranks than cards is refused inside the subprocess,
    which then exits non-zero."""
    from libdmet_preview_tpu_torch.entry import dryrun_multichip
    if torch.cuda.device_count() >= 2:
        pytest.skip("this host has cards for two NCCL ranks")
    with pytest.raises(RuntimeError, match="rc="):
        dryrun_multichip(2, backend="nccl", device="cuda", timeout=300)
