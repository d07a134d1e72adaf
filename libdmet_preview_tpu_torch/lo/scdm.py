"""
SCDM localization, selected columns of the density matrix (port of scdm
of libdmet_preview_tpu/lo/scdm.py).

Host NumPy / SciPy: torch has no QR with column pivoting, and the
matrices localized here (bath columns, (ncells * nso, nso)) are small.
"""

import numpy as np
import scipy.linalg as sla


def scdm(C, return_piv=False):
    """Localize orbitals C (nao, nmo) by QR with column pivoting on C^T
    (orthonormal metric assumed; apply to Lowdin-basis coefficients)."""
    C = np.asarray(C)
    Q, R, piv = sla.qr(C.T, pivoting=True)
    sel = piv[:C.shape[1]]
    X = C[sel, :]           # (nmo, nmo)
    # orthogonal Procrustes: rotate C onto the selected-column frame
    u, _, vt = np.linalg.svd(X.T, full_matrices=False)
    C_loc = C @ (u @ vt)
    if return_piv:
        return C_loc, sel
    return C_loc
