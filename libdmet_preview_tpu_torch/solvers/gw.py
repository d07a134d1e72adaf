"""
Static GW-type self-energy for embedding double counting (PyTorch port of
libdmet_preview_tpu/solvers/gw.py).

The quantity DMET needs is the static (QSGW-Hermitianized) self-energy of
the embedded mean field, to be subtracted from the embedding H1 when the
lattice mean field is a GW / QSGW one.  The exact static limit (COHSEX)
with RPA screening at omega = 0, evaluated in a Cholesky auxiliary space
on the device:

    chi0_xy = 4 sum_ia L[x,i,a] L[y,i,a] / (e_i - e_a)   (restricted)
    W       = (I - chi0)^{-1}                            (aux space)
    SEX_pq  = - sum_i  L[x,p,i] W_xy L[y,q,i]            (screened exchange)
    COH_pq  = 0.5 sum_r L[x,p,r] (W - I)_xy L[y,q,r]     (Coulomb hole)

W is never formed: one torch.linalg.solve of (I - chi0) against the MO
factors gives W L, and (W - I) L = W L - L.

Exact-limit oracle: with screening off (chi0 = 0), W = I, COH = 0 and SEX
is minus the restricted HF exchange -- vsig == fock - hcore - J.
"""

import numpy as np
import torch

from libdmet_preview_tpu_torch.utils.misc import as_f64
from libdmet_preview_tpu_torch.ops.eri_transform import cholesky_eri


def _chi0_static(L_ov, e_occ, e_vir):
    """chi0_xy(0) = 4 sum_ia L[x,i,a] L[y,i,a] / (e_i - e_a)."""
    naux = L_ov.shape[0]
    denom = e_occ[:, None] - e_vir[None, :]
    return 4.0 * (L_ov / denom).reshape(naux, -1) @ L_ov.reshape(naux, -1).T


def _sex_coh(L_mo, chi0, nocc):
    """Screened exchange + Coulomb hole in the MO basis; chi0 None is the
    bare limit W = I."""
    naux, n, _ = L_mo.shape
    L_po = L_mo[:, :, :nocc]
    if chi0 is None:
        WL = L_mo
    else:
        eye = torch.eye(naux, dtype=L_mo.dtype, device=L_mo.device)
        WL = torch.linalg.solve(eye - chi0,
                                L_mo.reshape(naux, -1)).reshape(L_mo.shape)
    WL_po = WL[:, :, :nocc]
    sex = -torch.einsum("xpi, xqi -> pq", L_po, WL_po)
    coh = 0.5 * torch.einsum("xpr, xqr -> pq", L_mo, WL - L_mo)
    return sex + coh


def _mo_factors(L, C):
    """L[x] -> C^T L[x] C as two batched GEMMs."""
    return torch.matmul(C.T, torch.matmul(L, C))


def get_vsig_emb(fock, eri, nelec, ovlp=None, chol_tol=1e-8, screened=True,
                 device=torch.device("cuda")):
    """Static (COHSEX) self-energy of an embedding mean field, on
    `device`.

    fock: (spin, n, n); eri: (spin_pair, n, n, n, n) chemist (restricted:
    one block); arrays or tensors; nelec: total electrons (or per-spin
    counts); ovlp: optional metric.  Returns vsig (spin, n, n), a
    symmetric tensor on `device`, in the input orbital basis."""
    device = torch.device(device)
    fock = as_f64(fock, device)
    if fock.ndim == 2:
        fock = fock[None]
    spin = fock.shape[0]
    n = fock.shape[-1]
    eri = as_f64(eri, device)
    if eri.ndim == 4:
        eri = eri[None]
    if ovlp is None:
        S = torch.eye(n, dtype=torch.float64, device=device)
    else:
        S = as_f64(ovlp, device)
        if S.ndim == 3:
            S = S[0]
    w, v = torch.linalg.eigh(S)
    A = (v * w ** -0.5) @ v.T

    def canonical(F):
        e, c = torch.linalg.eigh(A @ F @ A)
        return e, A @ c

    def to_input_basis(vs_mo, C):
        Cinv = C.T @ S
        vsig = Cinv.T @ vs_mo @ Cinv
        return 0.5 * (vsig + vsig.T)

    # spin-blocked ERIs [aa, bb, ab]: screening needs one shared aux space
    # -- the aa-block factors serve both spins (valid when the spatial ERI
    # is spin-independent, the DMET embedding case)
    L = cholesky_eri(eri[0], tol=chol_tol)
    if spin == 1:
        nocc = nelec // 2
        e, C = canonical(fock[0])
        L_mo = _mo_factors(L, C)
        chi0 = None
        if screened and 0 < nocc < n:
            chi0 = _chi0_static(L_mo[:, :nocc, nocc:], e[:nocc], e[nocc:])
        return to_input_basis(_sex_coh(L_mo, chi0, int(nocc)), C)[None]

    # unrestricted: chi0 sums both spin channels (factor 2 per spin); the
    # exchange carries the full same-spin sum
    nocc_s = ((nelec + 1) // 2, nelec // 2) if np.isscalar(nelec) \
        else tuple(nelec)
    ecs = [canonical(fock[s]) for s in range(2)]
    L_mos = [_mo_factors(L, C) for _, C in ecs]
    chi0 = None
    if screened:
        chi0 = torch.zeros((L.shape[0],) * 2, dtype=torch.float64,
                           device=device)
        for s, no in enumerate(nocc_s):
            if 0 < no < n:
                e = ecs[s][0]
                chi0 = chi0 + 0.5 * _chi0_static(L_mos[s][:, :no, no:],
                                                 e[:no], e[no:])
    return torch.stack([to_input_basis(_sex_coh(L_mos[s], chi0, int(no)),
                                       ecs[s][1])
                        for s, no in enumerate(nocc_s)])
