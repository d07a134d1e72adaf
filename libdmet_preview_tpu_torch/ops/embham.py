"""
Schmidt bath construction and embedding-Hamiltonian transforms (PyTorch
port of libdmet_preview_tpu/ops/embham.py: the one- and two-body
transforms for the 'local', 'nearest', 'full', 'spin local' and 'cholesky'
H2 formats with the interacting and the non-interacting bath, the SVD bath
with basis matching, the democratic global density matrices and the
charge-self-consistency update).

Everything runs on the device of its tensor inputs (the lattice's device).
The k-space identity

    H_emb = (1/Nk) sum_k C_k^H H_k C_k

is one batched complex GEMM chain; the two-body part is
eri_transform.get_emb_eri_chol for Cholesky factors (hand-written DF syrk
kernels on CUDA) and two einsum chains over the cell axis for a local
lattice ERI ('nearest' blocks are gathered by the lattice's cell-addition
table and contracted in one batched einsum).  Functions that update the
lattice (get_rho_glob_R, get_rdm1_idem, update_lattice_csc) return host
NumPy stripes like the lattice operators they feed.
"""

import numpy as np
import torch

from libdmet_preview_tpu_torch.utils import logger as log
from libdmet_preview_tpu_torch.utils.misc import as_f64
from libdmet_preview_tpu_torch.utils.timer import stage, to_host
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


def _spin_pairs(spin):
    """ccdd channel order (aa,) or (aa, bb, ab)."""
    return [(0, 0)] if spin == 1 else [(0, 0), (1, 1), (0, 1)]


def _add_table(lattice, ncells, device):
    """(C, R) -> index of cell C + R as a device tensor.  A 2D/3D mesh is
    not 1D-cyclic in its flattened order, so the lattice's own table is
    used whenever a lattice is given."""
    if lattice is not None:
        add = np.asarray(lattice._add_tab)
    else:
        add = (np.arange(ncells)[:, None] + np.arange(ncells)[None, :]) % ncells
    return torch.as_tensor(add, dtype=torch.long, device=device)


def _transform_eri_nearest_loop(basis, eri_R, lattice=None):
    """transform_eri_nearest as the plain loop over every cell R, one
    einsum each: the check of the batched version."""
    spin, ncells, nlo, neo = basis.shape
    add = _add_table(lattice, ncells, basis.device)
    P1 = torch.einsum("sCpi, sCqj -> sCpqij", basis, basis)
    out = []
    for s1, s2 in _spin_pairs(spin):
        acc = torch.zeros((neo,) * 4, dtype=basis.dtype, device=basis.device)
        for R in range(ncells):
            half = torch.einsum("Cpqij, pqrs -> Crsij", P1[s1], eri_R[R])
            acc += torch.einsum("Crsij, Crskl -> ijkl", half,
                                P1[s2][add[:, R]])
        out.append(acc)
    return torch.stack(out)


def transform_eri_nearest(basis, eri_R, lattice=None, max_bytes=2 ** 28):
    """Interacting-bath embedding transform of the 'nearest' H2 format
    (blocks (0p 0q | Rr Rs) = eri_R[R], translation invariant):

      H2_emb[ijkl] = sum_{C, R} B[C,p,i] B[C,q,j]
                     B[C+R,r,k] B[C+R,s,l] eri_R[R,p,q,r,s].

    basis: (spin, ncells, nlo, neo) tensor; eri_R: (ncells, nlo^4) tensor
    on its device.  Only the cells R whose block is non-zero are visited
    (one host read finds them): the pair products of cell C + R are
    gathered through the lattice's cell-addition table and contracted in
    one einsum per group of R, the group sized so that the gathered
    operand stays under max_bytes.  Returns (spin_pair, neo^4) in the
    order [aa, bb, ab].

    lattice: required for multi-dimensional cell meshes; 1D-cyclic
    addition is assumed without it."""
    spin, ncells, nlo, neo = basis.shape
    add = _add_table(lattice, ncells, basis.device)
    nz = torch.nonzero(torch.amax(torch.abs(eri_R), dim=(1, 2, 3, 4)) > 0.0
                       )[:, 0]
    # P1[s][C, p, q, i, j] = B[s,C,p,i] B[s,C,q,j]
    P1 = torch.einsum("sCpi, sCqj -> sCpqij", basis, basis)
    group = max(1, int(max_bytes // (8 * ncells * (nlo * neo) ** 2)))
    out = torch.zeros((len(_spin_pairs(spin)),) + (neo,) * 4,
                      dtype=basis.dtype, device=basis.device)
    for Rs in torch.split(nz, group):
        cells = add[:, Rs]                                  # (C, nR): C + R
        for m, (s1, s2) in enumerate(_spin_pairs(spin)):
            half = torch.einsum("Cpqij, Rpqrs -> CRrsij", P1[s1], eri_R[Rs])
            out[m] += torch.einsum("CRrsij, CRrskl -> ijkl", half,
                                   P1[s2][cells])
    return out


def transform_eri_full(basis, eri_F, lattice=None):
    """Interacting-bath embedding transform of the 'full' H2 format
    (eri_F[R1, R2, R3] = (0p R1q | R2r R3s), translation invariant):

      H2_emb[ijkl] = sum_{C, R1, R2, R3} B[C,p,i] B[C+R1,q,j]
                     B[C+R2,r,k] B[C+R3,s,l] eri_F[R1,R2,R3,p,q,r,s].

    One einsum per non-zero (R1, R2, R3) block.  lattice: required for
    multi-dimensional cell meshes (see transform_eri_nearest)."""
    spin, ncells, nlo, neo = basis.shape
    add = _add_table(lattice, ncells, basis.device)
    nz = to_host(torch.nonzero(
        torch.amax(torch.abs(eri_F), dim=(3, 4, 5, 6)) > 0.0),
        torch.Tensor.tolist)
    out = []
    for s1, s2 in _spin_pairs(spin):
        acc = torch.zeros((neo,) * 4, dtype=basis.dtype, device=basis.device)
        for R1, R2, R3 in nz:
            left = torch.einsum("Cpi, Cqj, pqrs -> Cijrs", basis[s1],
                                basis[s1][add[:, R1]], eri_F[R1, R2, R3])
            acc += torch.einsum("Cijrs, Crk, Csl -> ijkl", left,
                                basis[s2][add[:, R2]], basis[s2][add[:, R3]])
        out.append(acc)
    return torch.stack(out)


def transform_eri_spin_local(basis, eri_S):
    """Interacting-bath embedding transform of the 'spin local' H2 format
    (per-channel local ERIs (aa, bb, ab), same cell only):

      H2_emb[m][ijkl] = sum_C B[s1,C,p,i] B[s1,C,q,j]
                        B[s2,C,r,k] B[s2,C,s,l] eri_S[m,p,q,r,s]."""
    spin = basis.shape[0]
    out = []
    for m, (s1, s2) in enumerate(_spin_pairs(spin)):
        g = eri_S[min(m, eri_S.shape[0] - 1)]
        left = torch.einsum("pqrs, Cpi, Cqj -> Cijrs", g, basis[s1], basis[s1])
        out.append(torch.einsum("Cijrs, Crk, Csl -> ijkl", left, basis[s2],
                                basis[s2]))
    return torch.stack(out)


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

def _get_vjk_rhf(rdm1_tot, eri):
    """Separate (J, K) of the spin-traced density."""
    vj = torch.einsum("ijkl, kl -> ij", eri, rdm1_tot)
    vk = torch.einsum("ilkj, kl -> ij", eri, rdm1_tot)
    return vj, vk


def _get_veff_rhf(rdm1_tot, eri):
    """Restricted veff = J(rho_tot) - 0.5 K(rho_tot); rdm1_tot is the
    spin-traced density."""
    vj, vk = _get_vjk_rhf(rdm1_tot, eri)
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
    ill = to_host(sigma[:, -1] < 1e-6 * smax, torch.Tensor.tolist)
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
    imp_set = set(imp_idx)
    bath_set = set(imp_idx_bath)
    env_idx = [i for i in range(ncells * nlo) if i not in bath_set]
    virt_mask = np.asarray([i in imp_set for i in env_idx], dtype=bool)
    nimp = len(imp_idx)

    if rdm1.ndim == 3:
        rdm1 = rdm1[None]
    spin = rdm1.shape[0]
    dev = rdm1.device
    env_t = torch.as_tensor(env_idx, dtype=torch.long, device=dev)
    bath_t = torch.as_tensor(imp_idx_bath, dtype=torch.long, device=dev)
    if len(imp_idx_bath) > 0 and max(imp_idx_bath) >= nlo:
        # bath columns outside the reference cell: the full density matrix
        big = as_f64(lattice.expand(to_host(rdm1)), dev)
        rdm1_env_imp = big[:, env_t][:, :, bath_t]
    else:
        rdm1_env_imp = rdm1.reshape(spin, ncells * nlo,
                                    nlo)[:, env_t][:, :, bath_t]

    nbath_cols = len(imp_idx_bath)
    u, sigma = _bath_vectors(rdm1_env_imp)
    sigma_h = to_host(sigma)

    basis = torch.zeros((spin, ncells * nlo, nimp + nbath_cols),
                        dtype=rdm1.dtype, device=dev)
    imp_t = torch.as_tensor(imp_idx, dtype=torch.long, device=dev)
    virt_t = torch.as_tensor(np.nonzero(virt_mask)[0], dtype=torch.long,
                             device=dev)
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
              to_host(gamma.mean(), float), to_host(gamma.min(), float))
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
    if lattice.H2_format in ("cholesky", "aft"):
        if int_bath:
            if lattice.H2_format == "aft":
                return _emb_H2_aft(lattice.Ham, basis)
            # ab initio path: factorized ERI transform on the factors'
            # device
            return get_emb_eri_chol(lattice.getH2(), basis)
        eri_imp = as_f64(lattice.Ham.eri_imp, dev)
        if eri_imp.ndim == 5:     # spin-blocked (aa, bb, ab) unit-cell ERI
            return unit2emb(eri_imp, neo)
        return unit2emb(eri_imp[None].expand((npair,) + eri_imp.shape), neo)
    LatH2 = as_f64(lattice.getH2(kspace=False), dev)
    nsc = lattice.nscsites
    if lattice.H2_format == "local":
        if int_bath:
            return transform_eri_local(basis, LatH2)
        unit = LatH2[None].expand((npair,) + LatH2.shape)
    elif lattice.H2_format == "nearest":
        if int_bath:
            return transform_eri_nearest(basis, LatH2, lattice=lattice)
        unit = LatH2[0][None].expand((npair,) + (nsc,) * 4)
    elif lattice.H2_format == "full":
        if int_bath:
            return transform_eri_full(basis, LatH2, lattice=lattice)
        unit = LatH2[0, 0, 0][None].expand((npair,) + (nsc,) * 4)
    elif lattice.H2_format == "spin local":
        if int_bath:
            return transform_eri_spin_local(basis, LatH2)
        unit = LatH2[:npair]
    else:
        raise ValueError("unknown H2 format %s" % lattice.H2_format)
    return unit2emb(unit, neo)


def _emb_H2_aft(Ham, basis):
    """The 'aft' interacting-bath H2: one driver call per spin on the
    embedding coefficients C_ao_lo @ B_s (the cell's df_mode driver:
    get_emb_eri_aft / _fft / _rs), plus its cross form for ab.  A float64
    tensor (npair, neo, neo, neo, neo) on the cell's device; no supercell
    two-body object is formed."""
    cell = Ham.aft_cell
    spin, neo = basis.shape[0], basis.shape[-1]
    drv = {"aft": cell.get_emb_eri_aft, "fft": cell.get_emb_eri_fft,
           "rs": cell.get_emb_eri_rs}[Ham.df_mode]
    drv_x = {"aft": cell.get_emb_eri_aft_cross,
             "fft": cell.get_emb_eri_fft_cross,
             "rs": cell.get_emb_eri_rs_cross}[Ham.df_mode]
    C = as_f64(Ham.C_ao_lo, cell.device)
    Cs = [C @ as_f64(basis[s], cell.device).reshape(-1, neo)
          for s in range(spin)]
    out = [drv(c) for c in Cs]
    if spin == 2:
        out.append(drv_x(Cs[0], Cs[1]))
    return torch.stack(out)


def _emb_H1(lattice, basis, vcor, H2_emb, int_bath=True, add_vcor=False,
            **kwargs):
    spin = basis.shape[0]
    basis_k = lattice.R2k_basis(basis)
    hcore_emb = transform_h1(lattice.getH1(kspace=True), basis_k)
    ovlp_emb = transform_h1(lattice.get_ovlp(kspace=True), basis_k)
    if ovlp_emb.shape[0] == 1:
        ovlp_emb = ovlp_emb[0]

    if int_bath:
        rdm1_emb = foldRho_k(lattice.rdm1_lo_k, basis_k)
        H1 = transform_h1(lattice.getFock(kspace=True), basis_k)
        xc_dc = getattr(lattice, "xc_dc", None)
        if xc_dc is not None:
            # DFT-in-DMET double counting: the lattice Fock is a KS Fock
            # (hcore + J + vxc [+ hyb HF exchange]); remove the mean field
            # the embedded electrons generate for themselves: Coulomb,
            # hybrid HF exchange and the xc potential at the folded
            # density (hyb = 1 with vxc = 0 is the standard interacting
            # bath exactly)
            hyb = float(getattr(lattice, "xc_hyb", 0.0))
            log.eassert(spin == 1, "DFT-in-DMET dc: restricted path")
            vj, vk = _get_vjk_rhf(rdm1_emb[0], H2_emb[0])
            B = basis[0].reshape(-1, basis.shape[-1])
            vxc_lo = as_f64(xc_dc(B @ rdm1_emb[0] @ B.T), basis.device)
            JK_emb = (vj - 0.5 * hyb * vk + B.T @ vxc_lo @ B)[None]
        else:
            JK_emb = get_veff(rdm1_emb, H2_emb)
        H1 = H1 - JK_emb
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


# ----------------------------------------------------------------------
# global density matrices and charge self-consistency
# ----------------------------------------------------------------------

def _basis_tensor(basis, lattice):
    """basis as a float64 tensor: where it lies when it is a tensor, on
    the lattice's device otherwise."""
    if isinstance(basis, torch.Tensor):
        return basis.to(torch.float64)
    return as_f64(basis, lattice.device)


def get_rho_glob_R(basis, lattice, rho_emb):
    """Global lattice density matrix from the embedded rdm1 by democratic
    partitioning over translated impurities:

      rho_glob[0p, Rq] = 1/2 (B_0 rho B_R^T + B_{-R} rho B_0^T)_pq

    basis: (spin, ncells, nlo, neo); rho_emb: (spin, neo, neo).  Contracted
    on the basis' device; returns the host stripe (spin, ncells, nlo, nlo).
    The fragment translation uses the lattice's cell-index algebra."""
    b = _basis_tensor(basis, lattice)
    r = as_f64(rho_emb, b.device)
    if r.ndim == 2:
        r = r[None]
    neg = torch.as_tensor(np.asarray(lattice._neg_map), dtype=torch.long,
                          device=b.device)
    row = torch.einsum("spi, sij, sRqj -> sRqp", b[:, 0], r, b)
    col = torch.einsum("sRpi, sij, sqj -> sRqp", b[:, neg], r, b[:, 0])
    return to_host(0.5 * (row + col))


def get_veff_from_rdm1_emb(lattice, rdm1_emb, basis):
    """Lattice veff in the LO basis rebuilt from the embedded rdm1 through
    the democratic global density: the charge-self-consistency (DMET-CSC)
    update, on the device of the lattice's Cholesky factors.

    Returns host (veff_stripe (spin, ncells, nlo, nlo), rho_glob_stripe).
    Requires the 'cholesky' H2 format (ab initio lattices)."""
    log.eassert(lattice.H2_format == "cholesky",
                "veff rebuild implemented for the cholesky H2 format")
    rho_glob = get_rho_glob_R(basis, lattice, rdm1_emb)
    spin = rho_glob.shape[0]
    L = lattice.getH2()
    rho_full = as_f64(lattice.expand(rho_glob), L.device)
    if spin == 1:
        # restricted convention: rho is the per-spin density
        dm_tot = rho_full[0] * 2.0
        w = torch.einsum("xpq, qp -> x", L, dm_tot)
        vj = torch.einsum("x, xpq -> pq", w, L)
        vk = torch.einsum("xpr, rs, xsq -> pq", L, dm_tot, L)
        veff_full = (vj - 0.5 * vk)[None]
    else:
        w = torch.einsum("xpq, sqp -> x", L, rho_full)
        vj = torch.einsum("x, xpq -> pq", w, L)
        vk = torch.einsum("xpr, srt, xtq -> spq", L, rho_full, L)
        veff_full = vj[None] - vk
    veff_stripe = np.asarray(lattice.extract_stripe(to_host(veff_full)))
    return veff_stripe, rho_glob


def update_lattice_csc(lattice, rdm1_emb, basis):
    """One charge-self-consistency step: fock <- hcore + veff(rho_glob).
    Updates the lattice in place and returns (max fock change, veff
    stripe); the veff can be fed to the DMET energy functional
    (get_H_dmet(veff=...))."""
    veff_stripe, rho_glob = get_veff_from_rdm1_emb(lattice, rdm1_emb, basis)
    spin = veff_stripe.shape[0]
    hcore = np.asarray(lattice.hcore_lo_R)
    if hcore.ndim == 3:
        hcore = hcore[None] if spin == 1 else np.asarray([hcore, hcore])
    fock_new = hcore[:spin] + veff_stripe
    if spin == 1:
        fock_new = fock_new[0]
    dfock = float(np.max(np.abs(fock_new - np.asarray(lattice.fock_lo_R))))
    lattice.fock_lo_R = fock_new
    lattice.fock_lo_k = lattice.R2k(fock_new)
    lattice.rdm1_lo_R = rho_glob * (2.0 if spin == 1 else 1.0)
    lattice.rdm1_lo_k = lattice.R2k(lattice.rdm1_lo_R)
    return dfock, veff_stripe


def get_E1_from_glob(lattice, rdm1_emb, basis):
    """Fragment 1-body energy from the democratic global rdm:
    E1 = sum_R tr(h(R) rho_glob(R)) per cell (restricted: rho_glob is
    per-spin, factor 2)."""
    rho_glob = get_rho_glob_R(basis, lattice, rdm1_emb)
    spin = rho_glob.shape[0]
    h = np.asarray(lattice.getH1(kspace=False))
    if h.ndim == 3:
        h = h[None] if spin == 1 else np.asarray([h, h])
    E1 = np.einsum("sRpq, sRpq ->", h[:spin], rho_glob)
    return float(E1) * (2.0 if spin == 1 else 1.0)


def get_rdm1_idem(rho_glob_R, nelec_tot, kmesh, device=torch.device("cuda")):
    """Project the (non-idempotent) democratic global rdm onto the nearest
    idempotent density with the same electron count: the pDMET step.

    rho_glob_R: (spin, ncells, nlo, nlo) stripe, per-spin convention for
    spin == 1 (nelec_tot then counts PER-SPIN electrons).  Diagonalizes in
    k space on `device` (translation invariance) and refills by aufbau on
    the host.  Returns the idempotent host stripe."""
    from libdmet_preview_tpu_torch.ops import fourier, mfd, zlinalg
    rho_glob_R = np.asarray(rho_glob_R)
    spin = rho_glob_R.shape[0]
    if np.isscalar(nelec_tot):
        nelec_tot = [nelec_tot] * spin
    kmesh = tuple(int(x) for x in kmesh)
    r_re, r_im = fourier.R2k(rho_glob_R, kmesh)
    ew2, V = zlinalg.zeigh(as_f64(r_re, device), as_f64(r_im, device))
    ew2 = to_host(ew2)
    # occupy the LARGEST natural occupations (doubled spectrum: 2x count)
    occ2 = np.asarray([mfd.assignocc(-ew2[s], int(round(2 * nelec_tot[s])),
                                     np.inf, 0.0)[0] for s in range(spin)])
    rho_re, rho_im = zlinalg.zfunc_from_eig(V, as_f64(occ2, device))
    return fourier.k2R((to_host(rho_re), to_host(rho_im)), kmesh)


def add_bath(lattice, basis, ew, ev, nocc, nfrac, tol_bath=1e-6):
    """Enlarge the embedding basis with bath orbitals built from the
    nfrac*2 mean-field levels around the Fermi level: the real span of the
    frontier Bloch orbitals, orthogonalized against the current basis
    (host NumPy: a handful of vectors, Gram-Schmidt one by one).

    basis: (spin, ncells, nlo, neo) or (ncells, nlo, neo), tensor or array;
    ew: (nk, n) per-k mo energies (physical, undoubled);
    ev: per-k mo coefficients, complex (nk, n, n) or a (re, im) pair;
    nocc: total occupied count over the lattice; nfrac: half-window size.
    Returns the enlarged basis (a tensor on the input's device for a
    tensor, else an array) with <= 2*nfrac extra orthonormal columns
    (vectors already inside the embedding span are dropped)."""
    from libdmet_preview_tpu_torch.ops.zlinalg import dft_tables
    dev = basis.device if isinstance(basis, torch.Tensor) else None
    basis = to_host(basis) if dev is not None else np.asarray(basis)
    squeeze = basis.ndim == 3
    if squeeze:
        basis = basis[None]
    spin, ncells, nlo, neo = basis.shape
    ew = np.asarray(ew)
    nk, n = ew.shape
    if isinstance(ev, (tuple, list)):
        ev = np.asarray(ev[0]) + 1j * np.asarray(ev[1])
    else:
        ev = np.asarray(ev)

    # frontier window on the global spectrum
    idx = np.argsort(ew, axis=None, kind="mergesort")
    sel = idx[max(nocc - nfrac, 0):nocc + nfrac]
    k_idx, m_idx = np.divmod(sel, n)
    e_sel = ew.ravel()[sel]

    # lattice-space Bloch vectors V[(R, p), i] = e^{+ik.R} v_p(k) / sqrt(nk)
    cos_t, sin_t = dft_tables(tuple(int(x) for x in lattice.kmesh))
    ph = (cos_t + 1j * sin_t) / np.sqrt(nk)          # [k, R]
    V = np.empty((ncells * nlo, len(sel)), dtype=complex)
    for i, (k, m) in enumerate(zip(k_idx, m_idx)):
        V[:, i] = np.kron(ph[k], ev[k][:, m])

    # real frontier subspace: spectral projector weighted to keep ordering
    shift = e_sel.min() - 0.1
    h = (V * (e_sel - shift)) @ V.conj().T
    if np.abs(h.imag).max() > tol_bath:
        log.warn("add_bath: projector has imaginary part %.2e "
                 "(frontier window breaks time reversal)",
                 np.abs(h.imag).max())
    w, u = np.linalg.eigh(h.real)
    u = u[:, w > tol_bath][:, -len(sel):]

    out = []
    for s in range(spin):
        B = basis[s].reshape(ncells * nlo, neo)
        for i in range(u.shape[1]):
            v = u[:, i]
            v = v - B @ (B.T @ v)
            nv = np.linalg.norm(v)
            if nv > tol_bath:
                B = np.hstack([B, (v / nv)[:, None]])
        out.append(B)
    nmax = min(b.shape[1] for b in out)
    basis_out = np.asarray([b[:, :nmax] for b in out]).reshape(
        spin, ncells, nlo, nmax)
    if squeeze:
        basis_out = basis_out[0]
    return basis_out if dev is None else as_f64(basis_out, dev)


def get_rdm2_glob_R(basis, lattice, rdm2_emb):
    """Global lattice rdm2 stripe from the embedded rdm2 by 4-anchor
    democratic partitioning:

      G[J,K,L]_{ijkl} = 1/4 sum_{anchor in (0,J,K,L)}
          (B_{0-a} x B_{J-a} x B_{K-a} x B_{L-a}) . rdm2_emb

    basis: (spin, ncells, nlo, neo) or (ncells, nlo, neo) (restricted /
    one species); rdm2_emb: (neo,)*4 chemist.  Contracted on the basis'
    device, one einsum per (J, K, L, anchor); returns the host array
    (ncells, ncells, ncells, nlo, nlo, nlo, nlo)."""
    b = _basis_tensor(basis, lattice)
    if b.ndim == 4:
        b = b[0]
    ncells, nlo, neo = b.shape
    r2 = as_f64(rdm2_emb, b.device)
    sub = lattice.subtract
    out = torch.zeros((ncells,) * 3 + (nlo,) * 4, dtype=b.dtype,
                      device=b.device)
    # the first index transform depends on the anchor alone
    first = [torch.einsum("pqrs, ip -> iqrs", r2, b[sub(0, a)])
             for a in range(ncells)]
    for J in range(ncells):
        for K in range(ncells):
            for L in range(ncells):
                for a in (0, J, K, L):
                    out[J, K, L] += torch.einsum(
                        "iqrs, jq, kr, ls -> ijkl", first[a], b[sub(J, a)],
                        b[sub(K, a)], b[sub(L, a)])
    return to_host(0.25 * out)
