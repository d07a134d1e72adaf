"""
Schmidt bath construction and embedding-Hamiltonian transforms (PyTorch
port of libdmet_preview_tpu/ops/embham.py: transform_h1 / foldRho_k,
transform_local, transform_imp, transform_eri_local, unit2emb, get_veff,
the SVD bath with basis matching, get_emb_Ham for the 'local' and
'cholesky' H2 formats with the interacting and the non-interacting bath).

Everything runs on the device of its tensor inputs (the lattice's device).
The k-space identity

    H_emb = (1/Nk) sum_k C_k^H H_k C_k

is one batched complex GEMM chain; the two-body part is
eri_transform.get_emb_eri_chol for Cholesky factors (hand-written DF syrk
kernels on CUDA) and two einsum chains over the cell axis for a local
lattice ERI.
"""

import numpy as np
import torch

from libdmet_preview_tpu_torch.utils import logger as log
from libdmet_preview_tpu_torch.utils.misc import as_f64
from libdmet_preview_tpu_torch.utils.timer import stage
from libdmet_preview_tpu_torch.models.integral import Integral
from libdmet_preview_tpu_torch.ops.eri_transform import get_emb_eri_chol


# ----------------------------------------------------------------------
# basic transforms
# ----------------------------------------------------------------------

def transform_h1(H1_k, basis_k):
    """Embedding transform of a k-space one-body operator.

    H1_k: (re, im) pair of shape ((spin,) nk, n, n), arrays or tensors;
    basis_k: (re, im) tensor pair (spin, nk, n, neo).
    Returns the real (spin, neo, neo) tensor on the basis' device."""
    Cr, Ci = basis_k
    spin = Cr.shape[0]
    nkpts = Cr.shape[1]
    Hr, Hi = as_f64(H1_k[0], Cr.device), as_f64(H1_k[1], Cr.device)
    if Hr.ndim == 3:
        Hr, Hi = Hr[None], Hi[None]
    Hr = Hr[:spin] if Hr.shape[0] == spin else Hr[:1]
    Hi = Hi[:spin] if Hi.shape[0] == spin else Hi[:1]
    C = torch.complex(Cr, Ci)
    H = torch.complex(Hr, Hi).expand(spin, *Hr.shape[1:])
    res = torch.sum(C.conj().transpose(-1, -2) @ H @ C, dim=1)
    return res.real / nkpts


foldRho_k = transform_h1  # rdm1_lo_k folded to embedding space


def transform_local(basis_R, H):
    """Local (single-cell) operator to embedding space:
    sum_R basis[R].T H basis[R].  basis_R: (ncells, nlo, neo), H: (nlo, nlo)."""
    return torch.einsum("Rpi, pq, Rqj -> ij", basis_R, H, basis_R)


def transform_imp(basis_R, H):
    """Impurity-cell-only operator: basis[0].T H basis[0]."""
    return basis_R[0].T @ H @ basis_R[0]


def transform_eri_local(basis_R, H2):
    """Local lattice ERI to embedding space, interacting-bath formalism.

    basis_R: (spin, ncells, nlo, neo) tensor; H2: (nlo,)*4 (same for both
    spins) or (3, nlo^4) spin-blocked, on the basis' device.  Returns
    (spin*(spin+1)/2, neo^4) in the order [aa, bb, ab]."""
    spin = basis_R.shape[0]
    if H2.ndim == 4:
        H2aa = H2bb = H2ab = H2
    else:
        H2aa, H2bb, H2ab = H2[0], H2[1], H2[2]

    def t4(H, ba, bb):
        # sum over cells R: (pqrs, Rpi, Rqj, Rrk, Rsl -> ijkl) in two steps
        tmp = torch.einsum("pqrs, Rpi, Rqj -> Rijrs", H, ba, ba)
        return torch.einsum("Rijrs, Rrk, Rsl -> ijkl", tmp, bb, bb)

    if spin == 1:
        return t4(H2aa, basis_R[0], basis_R[0])[None]
    return torch.stack([t4(H2aa, basis_R[0], basis_R[0]),
                        t4(H2bb, basis_R[1], basis_R[1]),
                        t4(H2ab, basis_R[0], basis_R[1])])


def unit2emb(H2_unit, neo):
    """Pad a unit-cell ERI (spin_pair, n, n, n, n) tensor into the impurity
    corner of the embedding ERI."""
    n = H2_unit.shape[-1]
    H2 = torch.zeros((H2_unit.shape[0],) + (neo,) * 4, dtype=H2_unit.dtype,
                     device=H2_unit.device)
    H2[:, :n, :n, :n, :n] = H2_unit
    return H2


# ----------------------------------------------------------------------
# JK builders from embedding ERI
# ----------------------------------------------------------------------

def _get_veff_rhf(rdm1_tot, eri):
    """Restricted veff = J(rho_tot) - 0.5 K(rho_tot); rdm1_tot is the
    spin-traced density."""
    vj = torch.einsum("ijkl, kl -> ij", eri, rdm1_tot)
    vk = torch.einsum("ilkj, kl -> ij", eri, rdm1_tot)
    return (vj - vk * 0.5)[None]


def _get_veff_uhf(rdm1, eri_aa, eri_bb, eri_ab):
    """Unrestricted veff; rdm1 (2, neo, neo), eri blocks in chemists'
    notation (ij|kl)."""
    rho_a, rho_b = rdm1[0], rdm1[1]
    vj_aa = torch.einsum("ijkl, kl -> ij", eri_aa, rho_a)
    vj_bb = torch.einsum("ijkl, kl -> ij", eri_bb, rho_b)
    vj_ab = torch.einsum("ijkl, kl -> ij", eri_ab, rho_b)  # alpha feels beta
    vj_ba = torch.einsum("klij, kl -> ij", eri_ab, rho_a)  # beta feels alpha
    vk_aa = torch.einsum("ilkj, kl -> ij", eri_aa, rho_a)
    vk_bb = torch.einsum("ilkj, kl -> ij", eri_bb, rho_b)
    va = vj_aa + vj_ab - vk_aa
    vb = vj_bb + vj_ba - vk_bb
    return torch.stack([va, vb])


def get_veff(rdm1, eri):
    """Dispatch on spin structure.  rdm1: (spin, neo, neo); eri: (1 or 3,
    neo^4) tensors on one device."""
    if rdm1.ndim == 2:
        rdm1 = rdm1[None]
    if rdm1.shape[0] == 1:
        return _get_veff_rhf(rdm1[0], eri[0])
    return _get_veff_uhf(rdm1, eri[0], eri[1], eri[2])


# ----------------------------------------------------------------------
# bath construction
# ----------------------------------------------------------------------

def get_emb_basis(lattice, rdm1=None, local=True, kind="svd", **kwargs):
    """Embedding basis C_lo_eo, a (spin, ncells, nlo, neo) tensor on the
    device of rdm1 when it is a tensor, else on the lattice's device."""
    if rdm1 is None:
        rdm1 = lattice.rdm1_lo_R
    rdm1 = as_f64(rdm1, rdm1.device if isinstance(rdm1, torch.Tensor)
                  else lattice.device)
    if kind == "svd":
        return _get_emb_basis_svd(lattice, rdm1, **kwargs)
    raise ValueError("unknown bath kind %s" % kind)


embBasis = get_emb_basis


def _bath_vectors(A):
    """Left singular vectors + singular values of the tall (spin, nenv,
    ncol) environment-impurity RDM block.

    Fast path: the ncol x ncol Gram matrix eigendecomposition (sigma^2 =
    eig(A^T A), u = A V / sigma, + two Newton-Schulz orthonormalization
    steps).  Falls back to the exact SVD per spin channel whenever a
    singular value is small enough (< 1e-6 * sigma_max) that the Gram
    square would lose the truncation decision."""
    spin, nenv, ncol = A.shape
    if ncol == 0 or nenv == 0:
        return (torch.zeros((spin, nenv, ncol), dtype=A.dtype, device=A.device),
                torch.zeros((spin, ncol), dtype=A.dtype, device=A.device))
    G = A.transpose(-1, -2) @ A
    w, V = torch.linalg.eigh(G)
    w = torch.flip(w, dims=[-1])
    V = torch.flip(V, dims=[-1])
    sigma = torch.sqrt(torch.clamp(w, min=0.0))
    smax = torch.clamp(sigma[:, 0], min=1e-300)
    # one host read decides the rule for every spin channel
    ill = (sigma[:, -1] < 1e-6 * smax).tolist()
    eye = torch.eye(ncol, dtype=A.dtype, device=A.device)
    us, sigmas = [], []
    for s in range(spin):
        if ill[s]:
            # ill-conditioned: exact thin SVD keeps sigma to full precision
            u_s, sig_s, _ = torch.linalg.svd(A[s], full_matrices=False)
            us.append(u_s)
            sigmas.append(sig_s)
            continue
        u = A[s] @ V[s] / sigma[s][None, :]
        for _ in range(2):   # Newton-Schulz cleanup of roundoff
            u = u @ (1.5 * eye - 0.5 * (u.T @ u))
        us.append(u)
        sigmas.append(sigma[s])
    return torch.stack(us), torch.stack(sigmas)


def _get_emb_basis_svd(lattice, rdm1, **kwargs):
    imp_idx = list(kwargs.get("imp_idx", lattice.imp_idx))
    val_idx = list(kwargs.get("val_idx", lattice.val_idx))
    valence_bath = kwargs.get("valence_bath", True)
    orth = kwargs.get("orth", True)
    tol_bath = kwargs.get("tol_bath", 1e-9)
    nbath = kwargs.get("nbath", None)

    ncells = lattice.ncells
    nlo = lattice.nscsites
    imp_idx_bath = val_idx if valence_bath else imp_idx
    log.eassert(len(imp_idx_bath) == 0 or max(imp_idx_bath) < nlo,
                "bath columns outside the reference cell are not ported")
    imp_set = set(imp_idx)
    bath_set = set(imp_idx_bath)
    env_idx = [i for i in range(ncells * nlo) if i not in bath_set]
    virt_mask = np.asarray([i in imp_set for i in env_idx], dtype=bool)
    nimp = len(imp_idx)

    if rdm1.ndim == 3:
        rdm1 = rdm1[None]
    spin = rdm1.shape[0]
    dev = rdm1.device
    env_t = torch.as_tensor(env_idx, device=dev)
    bath_t = torch.as_tensor(imp_idx_bath, device=dev)
    rdm1_env_imp = rdm1.reshape(spin, ncells * nlo, nlo)[:, env_t][:, :, bath_t]

    nbath_cols = len(imp_idx_bath)
    u, sigma = _bath_vectors(rdm1_env_imp)
    sigma_h = sigma.cpu().numpy()

    basis = torch.zeros((spin, ncells * nlo, nimp + nbath_cols),
                        dtype=rdm1.dtype, device=dev)
    imp_t = torch.as_tensor(imp_idx, device=dev)
    virt_t = torch.as_tensor(np.nonzero(virt_mask)[0], device=dev)
    nbath_final = nbath_cols
    for s in range(spin):
        if nbath is None:
            nbath_s = int((sigma_h[s] >= tol_bath).sum())
        else:
            nbath_s = nbath
        if nbath_s < nbath_cols:
            log.warn("bath: %d singular values below tol %.1e discarded",
                     nbath_cols - nbath_s, tol_bath)
        B = u[s][:, :nbath_s].clone()
        if nbath_s > 0 and orth and virt_mask.any():
            B[virt_t] = 0.0
            B = vec_lowdin(B)
        basis[s, imp_t, :nimp] = torch.eye(nimp, dtype=rdm1.dtype, device=dev)
        basis[s, env_t, nimp:nimp + nbath_s] = B
        nbath_final = min(nbath_final, nbath_s)

    return basis[:, :, :nimp + nbath_final].reshape(
        spin, ncells, nlo, nimp + nbath_final)


def vec_lowdin(B):
    """Symmetric (Lowdin) orthogonalization of column vectors."""
    w, v = torch.linalg.eigh(B.T @ B)
    w = torch.clamp(w, min=1e-14)
    return B @ (v * (w ** -0.5)) @ v.T


def basis_matching(basis):
    """Rotate alpha/beta bath columns for maximal overlap via SVD.
    basis: (2, ..., nbath) tensor with the bath-column axis last; all
    leading axes are contracted in the overlap."""
    basisA, basisB = basis[0], basis[1]
    nb = basisA.shape[-1]
    S = basisA.reshape(-1, nb).T @ basisB.reshape(-1, nb)
    u, gamma, vt = torch.linalg.svd(S)
    log.debug(0, "basis matching overlap: mean %.6f min %.6f",
              float(gamma.mean()), float(gamma.min()))
    return torch.stack([basisA @ u, basisB @ vt.T])


# ----------------------------------------------------------------------
# embedding Hamiltonian
# ----------------------------------------------------------------------

def get_emb_Ham(lattice, basis, vcor, local=True, int_bath=True, **kwargs):
    """Build the embedding Hamiltonian Integral: H1 (spin, neo, neo), H2
    (spin_pair, neo, neo, neo, neo) and the overlap, tensors on the
    basis' device."""
    spin = basis.shape[0]
    neo = basis.shape[-1]
    with stage("H2", basis.device):
        H2 = _emb_H2(lattice, basis, vcor, int_bath=int_bath, **kwargs)
    with stage("H1", basis.device):
        H1, ovlp_emb = _emb_H1(lattice, basis, vcor, H2, int_bath=int_bath,
                               **kwargs)
    ImpHam = Integral(neo, spin == 1, False, lattice.getH0(), {"cd": H1},
                      {"ccdd": H2}, ovlp=ovlp_emb)
    return ImpHam, None


embHam = get_emb_Ham


def _emb_H2(lattice, basis, vcor, int_bath=True, **kwargs):
    spin = basis.shape[0]
    neo = basis.shape[-1]
    npair = spin * (spin + 1) // 2
    dev = basis.device
    if lattice.H2_format == "cholesky":
        if int_bath:
            # ab initio path: factorized ERI transform on the factors'
            # device
            return get_emb_eri_chol(lattice.getH2(), basis)
        eri_imp = as_f64(lattice.Ham.eri_imp, dev)
        if eri_imp.ndim == 5:     # spin-blocked (aa, bb, ab) unit-cell ERI
            return unit2emb(eri_imp, neo)
        return unit2emb(eri_imp[None].expand((npair,) + eri_imp.shape), neo)
    if lattice.H2_format == "local":
        LatH2 = as_f64(lattice.getH2(kspace=False), dev)
        if int_bath:
            return transform_eri_local(basis, LatH2)
        return unit2emb(LatH2[None].expand((npair,) + LatH2.shape), neo)
    raise NotImplementedError(
        "embedding H2: the %r format is not ported ('nearest', 'full' and "
        "'spin local' come with the rest of the model-lattice slice, 'aft' "
        "with the GDF/AFT slice)" % lattice.H2_format)


def _emb_H1(lattice, basis, vcor, H2_emb, int_bath=True, add_vcor=False,
            **kwargs):
    if getattr(lattice, "xc_dc", None) is not None:
        raise NotImplementedError(
            "embedding H1: the DFT double counting (xc_dc) is not ported")
    spin = basis.shape[0]
    basis_k = lattice.R2k_basis(basis)
    hcore_emb = transform_h1(lattice.getH1(kspace=True), basis_k)
    ovlp_emb = transform_h1(lattice.get_ovlp(kspace=True), basis_k)
    if ovlp_emb.shape[0] == 1:
        ovlp_emb = ovlp_emb[0]

    if int_bath:
        rdm1_emb = foldRho_k(lattice.rdm1_lo_k, basis_k)
        H1 = transform_h1(lattice.getFock(kspace=True), basis_k)
        H1 = H1 - get_veff(rdm1_emb, H2_emb)
        lattice.JK_core = H1 - hcore_emb
    else:
        add_vcor = True
        if lattice.use_hcore_as_emb_ham:
            H1 = hcore_emb
            lattice.JK_core = None
        else:
            H1 = transform_h1(lattice.getFock(kspace=True), basis_k)
            JK_imp = lattice.getImpJK()
            if JK_imp is not None:
                JK_imp = as_f64(JK_imp, basis.device)
                if JK_imp.ndim == 2:
                    JK_imp = JK_imp[None].expand(spin, -1, -1)
                JK_emb = torch.stack([transform_imp(basis[s], JK_imp[s])
                                      for s in range(spin)])
            else:
                rdm1_emb = foldRho_k(lattice.rdm1_lo_k, basis_k)
                JK_emb = get_veff(rdm1_emb, H2_emb)
            H1 = H1 - JK_emb
            lattice.JK_core = H1 - hcore_emb

    if add_vcor:
        log.eassert(vcor.islocal(), "nonlocal vcor not supported here")
        vmat = as_f64(vcor.get(), basis.device)
        H1 = H1.clone()
        for s in range(spin):
            # vcor acts on the environment only: add everywhere, subtract
            # the impurity-cell copy
            H1[s] += transform_local(basis[s], vmat[s])
            if not kwargs.get("fitting", False):
                H1[s] -= transform_imp(basis[s], vmat[s])
    return H1, ovlp_emb
