"""
Checkpoint / resume for the DMET self-consistency loop (port of
libdmet_preview_tpu/utils/chkfile.py): one NumPy .npz file per run holding
[mu, last_dmu, vcor.param, rhoEmb, basis, rhoImp] of the last iteration.
Tensors are read to the host before they are written.
"""

import os

import numpy as np
import torch

from libdmet_preview_tpu_torch.utils import logger as log


def _host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def save_dmet_iter(filename, mu, last_dmu, vcor_param, rho_emb=None,
                   basis=None, rho_imp=None, extra=None):
    """Write one DMET iteration's restartable state to an npz file."""
    data = {"mu": _host(mu), "last_dmu": _host(last_dmu),
            "vcor_param": _host(vcor_param)}
    if rho_emb is not None:
        data["rho_emb"] = _host(rho_emb)
    if basis is not None:
        data["basis"] = _host(basis)
    if rho_imp is not None:
        data["rho_imp"] = _host(rho_imp)
    if extra:
        for k, v in extra.items():
            data["extra_" + k] = _host(v)
    np.savez(filename, **data)


def load_dmet_iter(filename):
    """Read a DMET iteration checkpoint -> dict (missing keys absent)."""
    if not os.path.exists(filename):
        if os.path.exists(filename + ".npz"):
            filename = filename + ".npz"
        else:
            raise FileNotFoundError(filename)
    with np.load(filename) as f:
        out = {k: f[k] for k in f.files}
    return out


def restart_from_dmet_iter(vcor, filename):
    """Restore a Vcor object's parameters; returns (mu, last_dmu)."""
    data = load_dmet_iter(filename)
    vcor.update(np.asarray(data["vcor_param"]))
    log.info("DMET restart from %s: mu = %s, last_dmu = %s", filename,
             data["mu"], data["last_dmu"])
    return float(data["mu"]), float(data["last_dmu"])
