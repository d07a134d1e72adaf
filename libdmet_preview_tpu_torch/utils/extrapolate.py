"""
DMRG bond-dimension extrapolation + misc numerical extrapolations
(PyTorch port of libdmet_preview_tpu/utils/extrapolate.py, host only;
reference analog: the reference libdmet's utils/extrapolate_M.py).
"""

import numpy as np


def extrapolate_M(Ms, Es, deg=1, use_inverse=True):
    """Extrapolate DMRG energies to infinite bond dimension.

    Fits E(M) = E_inf + a / M (+ b / M^2 ...) and returns
    (E_inf, coeffs)."""
    Ms = np.asarray(Ms, dtype=float)
    Es = np.asarray(Es, dtype=float)
    x = 1.0 / Ms if use_inverse else Ms
    coeffs = np.polyfit(x, Es, deg)
    return float(np.polyval(coeffs, 0.0)), coeffs


def extrapolate_dw(dws, Es, deg=1):
    """Extrapolate vs discarded weight: E(dw) -> E(0) (standard DMRG
    practice; linear in dw)."""
    coeffs = np.polyfit(np.asarray(dws, float), np.asarray(Es, float), deg)
    return float(np.polyval(coeffs, 0.0)), coeffs
