"""
SCDM localization, selected columns of the density matrix (port of
libdmet_preview_tpu/lo/scdm.py: scdm, scdm_smear and scdm_k).

Host NumPy / SciPy: torch has no QR with column pivoting, and the
matrices localized here (bath columns, (ncells * nso, nso)) are small.
"""

import numpy as np
import scipy.linalg as sla


def _scdm(C, Cw, return_piv):
    """Pivoted QR on Cw^T selects nmo rows; the orthogonal Procrustes
    rotation of C onto Cw's selected rows localizes C."""
    Q, R, piv = sla.qr(Cw.T, pivoting=True)
    sel = piv[:C.shape[1]]
    u, _, vt = np.linalg.svd(Cw[sel, :].T, full_matrices=False)
    C_loc = C @ (u @ vt)
    if return_piv:
        return C_loc, sel
    return C_loc


def scdm(C, return_piv=False):
    """Localize orbitals C (nao, nmo) by QR with column pivoting on C^T
    (orthonormal metric assumed; apply to Lowdin-basis coefficients)."""
    C = np.asarray(C)
    return _scdm(C, C, return_piv)


def scdm_smear(C, mo_energy, mu, sigma, kind="erfc", return_piv=False):
    """SCDM with smearing weights for entangled / metallic bands: columns
    are weighted by an occupation-like window before the pivoted QR, so the
    selected columns favour the occupied manifold.

    kind: 'erfc' -> 0.5*erfc((e - mu)/sigma); 'gauss' ->
    exp(-((e - mu)/sigma)^2); 'fermi' -> Fermi function."""
    from scipy.special import erfc
    x = (np.asarray(mo_energy) - mu) / sigma
    if kind == "erfc":
        w = 0.5 * erfc(x)
    elif kind == "gauss":
        w = np.exp(-x ** 2)
    elif kind == "fermi":
        w = 1.0 / (np.exp(np.clip(x, -100, 100)) + 1.0)
    else:
        raise ValueError("unknown smearing kind %s" % kind)
    C = np.asarray(C)
    return _scdm(C, C * w[None, :], return_piv)


def scdm_k(C_k, return_piv=False):
    """k-point SCDM: one COMMON pivot set chosen from the k-summed orbital
    weight (so the localized gauge is translationally consistent), then a
    per-k orthogonal Procrustes onto the selected rows.

    C_k: complex (nk, nao, nmo) array or a (re, im) pair.  Returns complex
    (nk, nao, nmo) localized coefficients."""
    if isinstance(C_k, (tuple, list)):
        C_k = np.asarray(C_k[0]) + 1j * np.asarray(C_k[1])
    C_k = np.asarray(C_k)
    nk, nao, nmo = C_k.shape
    dens = np.sum(np.abs(C_k) ** 2, axis=0)               # (nao, nmo)
    Q, R, piv = sla.qr(dens.T, pivoting=True)
    sel = piv[:nmo]
    out = np.empty_like(C_k)
    for k in range(nk):
        u, _, vt = np.linalg.svd(C_k[k][sel, :].conj().T,
                                 full_matrices=False)
        out[k] = C_k[k] @ (u @ vt)
    if return_piv:
        return out, sel
    return out
