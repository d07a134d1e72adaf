"""
GSO / spinless formalism: the partial particle-hole transform (PyTorch
port of libdmet_preview_tpu/ops/spinless.py).

The spin-beta sector is particle-hole transformed (b_i = beta_i^dagger), so
superconducting pairing becomes a NUMBER-CONSERVING one-body term in a
2*nao "generalized spin orbital" (GSO) space.  The mean field is GHF over
k; the embedded problem is a single-species FCI / CC problem.

Conventions (as in the JAX package):
  compact H1 = [HA, -HB, HD] with GH0 = sum_k tr(HB)/nk
  combined GH1(k) = [[HA(k), HD(k)], [HD(k)^H, -HB(k)]]
  compact rdm = [rho_A, I - rho_B, kappa_AB], kappa_AB[p,q] = <b_q a_p>
  physical electron count n_phys = tr(G_aa) - tr(G_bb) + nao (per cell)

The one-body transforms of lattice operators (transform_H1_k,
combine_H1_k, transform_H2_local, transform_rdm1_k, mu_matrix,
combine_vcor) are host NumPy on set-up-sized arrays, as in the JAX
package.  The mean field (GHF, GHF_mu_fit), the bath, the embedding
Hamiltonians, the vcor fit and the results transform run on the lattice's
device: the GSO Fock is one batched complex128 eigh over k, its
occupations are assigned on the device with the JAX package's rules on
the DOUBLED spectrum (each level twice, nelec2 twice the count), and the
mu fit reads one scalar (the physical electron count) per step.  The
interacting-bath ERI goes through eri_transform.get_emb_eri_gso_chol and
so through the hand-written symmetric DF syrk kernel on CUDA.
"""

import copy

import numpy as np
import torch

from libdmet_preview_tpu_torch.utils import logger as log
from libdmet_preview_tpu_torch.utils.misc import as_f64
from libdmet_preview_tpu_torch.utils.timer import stage
from libdmet_preview_tpu_torch.models.integral import Integral
from libdmet_preview_tpu_torch.ops import embham, fourier
from libdmet_preview_tpu_torch.ops.zlinalg import _bisect_mu, _fermi


# ----------------------------------------------------------------------
# particle-hole transforms (host, set-up sized)
# ----------------------------------------------------------------------

def transform_H1_k(H1_k):
    """k-space H1 -> spinless compact form.

    H1_k: (re, im) pair, shape ((spin,) nk, nao, nao); spin components are
    [HA] or [HA, HB] or [HA, HB, HD].
    Returns (GH1_re, GH1_im) shape (3, nk, nao, nao) = [HA, -HB, HD] and
    the constant GH0 = mean_k tr(HB(k)) (real)."""
    re, im = np.asarray(H1_k[0]), np.asarray(H1_k[1])
    if re.ndim == 3:
        re, im = re[None], im[None]
    spin = re.shape[0]
    nk = re.shape[1]
    HA_re, HA_im = re[0], im[0]
    HB_re, HB_im = (re[1], im[1]) if spin > 1 else (re[0], im[0])
    HD_re = re[2] if spin > 2 else np.zeros_like(HA_re)
    HD_im = im[2] if spin > 2 else np.zeros_like(HA_im)
    GH1_re = np.asarray([HA_re, -HB_re, HD_re])
    GH1_im = np.asarray([HA_im, -HB_im, HD_im])
    GH0 = float(np.einsum("kii ->", HB_re)) / nk
    return (GH1_re, GH1_im), GH0


def combine_H1_k(GH1):
    """compact (3, nk, nao, nao) pair -> full (nk, nso, nso) pair:
    [[A, D], [D^H, B]] (B already carries the -HB sign)."""
    re, im = np.asarray(GH1[0]), np.asarray(GH1[1])
    nk, nao = re.shape[1], re.shape[-1]
    nso = 2 * nao
    out_re = np.zeros((nk, nso, nso))
    out_im = np.zeros((nk, nso, nso))
    out_re[:, :nao, :nao] = re[0]
    out_im[:, :nao, :nao] = im[0]
    out_re[:, nao:, nao:] = re[1]
    out_im[:, nao:, nao:] = im[1]
    out_re[:, :nao, nao:] = re[2]
    out_im[:, :nao, nao:] = im[2]
    out_re[:, nao:, :nao] = re[2].transpose(0, 2, 1)
    out_im[:, nao:, :nao] = -im[2].transpose(0, 2, 1)
    return out_re, out_im


def transform_H2_local(H2):
    """Local (restricted-storage) H2 -> spinless form.

    Returns GV2 (3, nao, nao, nao, nao) = [aa, bb, ab] blocks over the two
    GSO species, GV1 (3, nao, nao) one-body correction [on A, on B, on D],
    GV0 constant per cell."""
    H2 = np.asarray(H2)
    nao = H2.shape[-1]
    vj = np.einsum("ijkk -> ij", H2)
    vk = np.einsum("ikkj -> ij", H2)
    GV2 = np.asarray([H2, H2, -H2])
    GV1 = np.zeros((3, nao, nao))
    GV1[0] = vj
    GV1[1] = vk - vj
    GV0 = 0.5 * float(np.trace(vj)) - 0.5 * float(np.trace(vk))
    return GV2, GV1, GV0


def get_GV1_GV0_from_chol(L):
    """Particle-hole normal ordering of a DF-factorized FULL-lattice
    interaction against the filled-beta sea (orthonormal LOs, where the
    sea density is the identity).

    L: (naux, nsites, nsites) float64 tensor, the Cholesky / GDF factors
    of the supercell ERI in the LO basis, on its device.  Returns GV1
    (3, nsites, nsites) = [on A, on B, on D] supercell one-body
    corrections (host NumPy) and the constant GV0 per SUPERCELL:

      vj = sum_x L_x tr(L_x),   vk = sum_x L_x @ L_x
      GV1 = [vj, vk - vj, 0],   GV0 = (tr vj - tr vk) / 2

    vk is one GEMM over the stacked (x, r) axis."""
    naux, n, _ = L.shape
    trL = torch.diagonal(L, dim1=-2, dim2=-1).sum(-1)
    vj = (trL @ L.reshape(naux, n * n)).reshape(n, n)
    # vk[p, q] = sum_{x r} L[x, p, r] L[x, r, q]
    vk = L.transpose(1, 2).reshape(naux * n, n).T @ L.reshape(naux * n, n)
    vj, vk = vj.cpu().numpy(), vk.cpu().numpy()
    GV1 = np.zeros((3,) + vj.shape)
    GV1[0] = vj
    GV1[1] = vk - vj
    GV0 = 0.5 * float(np.trace(vj) - np.trace(vk))
    return GV1, GV0


def get_veff_ghf(GRho, g):
    """GHF-frame veff J - K from a dense (chemist) ERI over the full GSO
    index space.  GRho: (n, n) tensor; g: (n, n, n, n) tensor with
    g[p,q,r,s] = (pq|rs), on one device."""
    vj = torch.einsum("pqrs, sr -> pq", g, GRho)
    vk = torch.einsum("prsq, rs -> pq", g, GRho)
    return vj - vk


def transform_rdm1_k(rdm1_k):
    """Physical k-space rdm1 (spin comps [rA, rB(, kBA)]) -> GSO compact
    [rho_A, I - rho_B, kappa_AB]."""
    re, im = np.asarray(rdm1_k[0]), np.asarray(rdm1_k[1])
    if re.ndim == 3:
        re, im = re[None], im[None]
    spin = re.shape[0]
    nk, nao = re.shape[1], re.shape[-1]
    eye = np.tile(np.eye(nao), (nk, 1, 1))
    rB_re, rB_im = (re[1], im[1]) if spin > 1 else (re[0], im[0])
    kap_re = re[2] if spin > 2 else np.zeros_like(re[0])
    kap_im = im[2] if spin > 2 else np.zeros_like(im[0])
    G_re = np.asarray([re[0], eye - rB_re, kap_re])
    G_im = np.asarray([im[0], -rB_im, kap_im])
    return G_re, G_im


def extract_rdm(GRho):
    """Full R=0 (or embedding) GSO density (nso, nso), array or tensor ->
    (rho_A, rho_B, kappa_AB) physical blocks of the same kind.
    GRho = [[rho_A, kappa_AB], [kappa_AB^T, I - rho_B^T]]."""
    nao = GRho.shape[-1] // 2
    if isinstance(GRho, torch.Tensor):
        eye = torch.eye(nao, dtype=GRho.dtype, device=GRho.device)
    else:
        GRho = np.asarray(GRho)
        eye = np.eye(nao)
    rho_A = GRho[:nao, :nao]
    rho_B = eye - GRho[nao:, nao:].T
    kappa_AB = GRho[:nao, nao:]
    return rho_A, rho_B, kappa_AB


def mu_matrix(mu, nao):
    """Physical chemical potential in the GSO rep: -mu*n_a + mu*n_b
    (constant -mu*nao per cell tracked by the caller)."""
    return np.diag(np.concatenate([np.full(nao, -mu), np.full(nao, mu)]))


def n_phys_from_GRho(GRho_R0_trace_a, GRho_R0_trace_b, nao):
    return GRho_R0_trace_a - GRho_R0_trace_b + nao


def combine_vcor(vcor_mat3):
    """[va, vb, D] physical blocks -> combined GSO local matrix
    [[va, D], [D^T, -vb^T]] (the ph transform of the vcor operator; the
    per-cell constant tr(vb) carries zero democratic weight and is
    dropped)."""
    va, vb, D = np.asarray(vcor_mat3)
    nao = va.shape[-1]
    out = np.zeros((2 * nao, 2 * nao))
    out[:nao, :nao] = va
    out[nao:, nao:] = -vb.T
    out[:nao, nao:] = D
    out[nao:, :nao] = D.T
    return out


# ----------------------------------------------------------------------
# GHF mean field on the combined GSO Hamiltonian
# ----------------------------------------------------------------------

def _cplx(pair, device):
    return torch.complex(as_f64(pair[0], device), as_f64(pair[1], device))


def _occupations(ew2, nelec2, beta, fix_mu=False, thr_deg=1e-6):
    """Occupations of the doubled spectrum ew2 (any shape) holding nelec2
    particles, on its device, by the JAX package's mfd.assignocc rules
    started from its default mu (the midpoint of the nelec2-th and the
    next sorted level): zero T fills the levels below it and spreads the
    rest equally over the levels within thr_deg of it; finite T is the
    Fermi function at the mu that holds nelec2 (at the default mu with
    fix_mu).  Returns (occ2, mu, nerr) tensors."""
    s = torch.sort(ew2.reshape(-1)).values
    if nelec2 <= 0:
        mu = s[0]
    elif nelec2 >= s.numel():
        mu = s[-1]
    else:
        mu = 0.5 * (s[nelec2 - 1] + s[nelec2])
    if beta < np.inf:
        if not fix_mu:
            mu = _bisect_mu(ew2, float(nelec2), beta, n_sweep=7, grid=128)
        occ = _fermi(ew2, mu, beta)
        return occ, mu, torch.abs(torch.sum(occ) - nelec2)
    occ = (ew2 < mu - thr_deg).to(ew2.dtype)
    nremain = nelec2 - torch.sum(occ)
    remain = ((ew2 <= mu + thr_deg) & (ew2 >= mu - thr_deg)).to(ew2.dtype)
    nrem_orb = torch.clamp(torch.sum(remain), min=1.0)
    occ = occ + torch.where(nremain > 0, nremain / nrem_orb,
                            torch.zeros_like(nremain)) * remain
    return occ, mu, torch.zeros_like(mu)


def _ghf_state(F, filling_T, beta, fix_mu=False):
    """Diagonalize the (nk, nso, nso) complex GSO Fock F on its device and
    fill round(ew2.size * filling_T) levels of the doubled spectrum.
    Returns (ew2, occ2, mu_T, nerr, rho_k complex)."""
    GHF.calls += 1
    ew, V = torch.linalg.eigh(F)
    ew2 = torch.repeat_interleave(ew, 2, dim=-1)
    nelec2 = int(np.round(ew2.numel() * filling_T))
    occ2, mu_T, nerr = _occupations(ew2, nelec2, beta, fix_mu)
    occ = (0.5 * (occ2[..., 0::2] + occ2[..., 1::2])).to(V.dtype)
    rho = (V * occ[..., None, :]) @ V.conj().transpose(-1, -2)
    return ew2, occ2, mu_T, nerr, rho


def GHF(GFock_k, filling_T=0.5, beta=np.inf, mu0=0.0, fix_mu=False,
        device=torch.device("cuda"), **kwargs):
    """Diagonalize the (nk, nso, nso) GSO Fock and fill with the
    TRANSFORMED filling (0.5 at Sz=0), on `device`.  Returns (GRho_k_re,
    mu_T, E, res).

    GFock_k: (re, im) pair of arrays or tensors.  E is the
    transformed-frame one-body energy sum_k tr(F rho)/nk (no H0).
    res["rho_k"] is the (re, im) tensor pair of the density over k,
    res["e"] the doubled spectrum, res["mo_occ"] its occupations.
    GHF.calls counts the diagonalizations since the caller last set it
    to 0."""
    F = _cplx(GFock_k, torch.device(device))
    nk = F.shape[0]
    ew2, occ2, mu_T, nerr, rho = _ghf_state(F, filling_T, beta, fix_mu)
    E = float(torch.sum(F.conj() * rho).real) / nk
    res = {"e": ew2, "rho_k": (rho.real, rho.imag), "nerr": float(nerr),
           "E": E, "mo_occ": occ2}
    return rho.real, float(mu_T), E, res


GHF.calls = 0


def _n_phys_t(rho, nao):
    """Physical electrons per cell of the k-space GSO density (tensor)."""
    d = torch.diagonal(rho.real, dim1=-2, dim2=-1)      # (nk, nso)
    nk = rho.shape[0]
    return (torch.sum(d[:, :nao]) - torch.sum(d[:, nao:])) / nk + nao


def GHF_mu_fit(lattice, GH1_k, vcor_mat, filling_phys, mu0=0.0,
               beta=np.inf, tol=1e-9, max_iter=80, **kwargs):
    """Fit the physical chemical potential so that the physical electron
    count matches filling_phys, on the lattice's device.

    GH1_k: combined (nk, nso, nso) pair; vcor_mat: (nso, nso) local GSO
    correlation potential (already combined).  Brackets and bisects mu
    (the count is monotone in mu) with the JAX package's steps; each step
    is one batched eigh and occupation on the device and one scalar read.
    Returns (GRho_R, mu, res) with GRho_R the real host stripe (ncells,
    nso, nso) and res as GHF's, plus res["mu"] and res["nelec_phys"]."""
    device = lattice.device
    nso = np.asarray(GH1_k[0]).shape[-1]
    nao = nso // 2
    target = filling_phys * 2.0 * nao   # physical electrons per cell
    F0 = _cplx((np.asarray(GH1_k[0]) + np.asarray(vcor_mat), GH1_k[1]),
               device)
    nk = F0.shape[0]
    dmu = torch.as_tensor(np.concatenate([-np.ones(nao), np.ones(nao)]),
                          dtype=F0.dtype, device=device)

    def n_phys(mu):
        F = F0 + torch.diag_embed(mu * dmu).expand(nk, -1, -1)
        ew2, occ2, mu_T, nerr, rho = _ghf_state(F, 0.5, beta)
        return float(_n_phys_t(rho, nao)), (F, ew2, occ2, mu_T, nerr, rho)

    lo, hi = mu0 - 1.0, mu0 + 1.0
    n_lo = n_phys(lo)[0]
    n_hi = n_phys(hi)[0]
    it = 0
    while n_lo > target and it < 30:
        lo -= 2.0
        n_lo = n_phys(lo)[0]
        it += 1
    it = 0
    while n_hi < target and it < 30:
        hi += 2.0
        n_hi = n_phys(hi)[0]
        it += 1
    mu = mu0
    for _ in range(max_iter):
        mu = 0.5 * (lo + hi)
        n_mu = n_phys(mu)[0]
        if abs(n_mu - target) < tol:
            break
        if n_mu < target:
            lo = mu
        else:
            hi = mu
    n_mu, (F, ew2, occ2, mu_T, nerr, rho) = n_phys(mu)
    E = float(torch.sum(F.conj() * rho).real) / nk
    res = {"e": ew2, "rho_k": (rho.real, rho.imag), "nerr": float(nerr),
           "E": E, "mo_occ": occ2, "mu": mu, "nelec_phys": n_mu}
    GRho_R = fourier.k2R(res["rho_k"], lattice.kmesh).cpu().numpy()
    return GRho_R, mu, res


def GKS_mu_fit(lattice, GH1_k, filling_phys, xc_eval, vcor_mat=None,
               mu0=0.0, beta=np.inf, max_cycle=50, conv_tol=1e-8,
               mix=0.5, **kwargs):
    """Generalized Kohn-Sham in the spinless (GSO) frame: self-consistent
    mean field where a density functional potential acts on the PHYSICAL
    per-spin densities.

    xc_eval(rho_a, rho_b) -> (vxc_a, vxc_b) with rho_s the (nao, nao)
    physical per-spin cell densities (host NumPy); the potential enters
    the GSO frame through the partial particle-hole transform,
    V_gso = diag(vxc_a, -vxc_b^T).  xc_eval == None reduces EXACTLY to
    GHF_mu_fit.  Returns (GRho_R, mu, res) like GHF_mu_fit, with
    res["cycles"] and res["dGRho"]."""
    nso = np.asarray(GH1_k[0]).shape[-1]
    nao = nso // 2
    base = np.zeros((nso, nso)) if vcor_mat is None else np.asarray(vcor_mat)
    v_gso = np.array(base, copy=True)
    GRho_old = None
    mu = mu0
    dG = np.inf
    for it in range(max_cycle):
        GRho_R, mu, res = GHF_mu_fit(lattice, GH1_k, v_gso, filling_phys,
                                     mu0=mu, beta=beta, **kwargs)
        if xc_eval is None:
            res["cycles"] = it + 1
            res["dGRho"] = 0.0
            return GRho_R, mu, res
        rA, rB, _ = extract_rdm(GRho_R[0] if GRho_R.ndim == 3 else GRho_R)
        vxc_a, vxc_b = xc_eval(np.asarray(rA), np.asarray(rB))
        v_new = np.array(base, copy=True)
        v_new[:nao, :nao] += vxc_a
        v_new[nao:, nao:] -= np.asarray(vxc_b).T
        if GRho_old is not None:
            dG = float(np.max(np.abs(GRho_R - GRho_old)))
            if dG < conv_tol:
                res["cycles"] = it + 1
                res["dGRho"] = dG
                return GRho_R, mu, res
        GRho_old = GRho_R
        v_gso = (1.0 - mix) * v_gso + mix * v_new
    log.warn("GKS_mu_fit: not converged, dGRho = %.2e", dG)
    res["cycles"] = max_cycle
    res["dGRho"] = dG
    return GRho_R, mu, res


# ----------------------------------------------------------------------
# embedding: bath, Hamiltonian
# ----------------------------------------------------------------------

def get_emb_basis(lattice, GRho_R, localize_bath=None, **kwargs):
    """Schmidt bath for the GSO density: SVD of the environment block
    against the impurity-cell columns (all nso of cell 0), on the
    lattice's device.  GRho_R: (ncells, nso, nso) stripe (array or
    tensor).

    localize_bath='scdm' rotates the bath columns by SCDM (a unitary
    rotation of the bath block leaves the embedding space, hence the DMET
    solution, invariant).  Returns the basis tensor (1, ncells, nso, neo),
    neo = 2*nso.  The bath columns' signs and rotation are the SVD's
    gauge, which differs between libraries."""
    device = lattice.device
    GRho_R = as_f64(GRho_R, device)
    if GRho_R.ndim == 4:
        GRho_R = GRho_R[0]
    ncells, nso = GRho_R.shape[0], GRho_R.shape[-1]
    flat = GRho_R.reshape(ncells * nso, nso)
    env = flat[nso:]                        # environment rows
    u = torch.linalg.svd(env, full_matrices=False)[0]
    if localize_bath == "scdm":
        from libdmet_preview_tpu_torch.lo.scdm import scdm
        u = as_f64(scdm(u.cpu().numpy()), device)
    neo = 2 * nso
    basis = torch.zeros((ncells * nso, neo), dtype=torch.float64,
                        device=device)
    basis[:nso, :nso] = torch.eye(nso, dtype=torch.float64, device=device)
    basis[nso:, nso:] = u
    return basis.reshape(1, ncells, nso, neo)


def transform_eri_local_gso(basis_Ra, basis_Rb, GV2):
    """Embedding ERI from the LOCAL species-blocked spinless interaction.

    basis_Ra/b: (ncells, nao, neo) species sub-blocks of the bath basis
    (tensors); GV2: (3, nao, nao, nao, nao) = [aa, bb, ab] (array or
    tensor).  Returns g_emb (neo,)*4 chemist tensor, symmetric under
    (pq)<->(rs)."""
    Ra, Rb = basis_Ra, basis_Rb
    vaa, vbb, vab = as_f64(GV2, Ra.device)

    def t4(V, B1, B2):
        # sum_R (B1[R] B1[R] | B2[R] B2[R]) with local V, in two steps
        tmp = torch.einsum("pqrs, Rpi, Rqj -> Rijrs", V, B1, B1)
        return torch.einsum("Rijrs, Rrk, Rsl -> ijkl", tmp, B2, B2)

    g = t4(vaa, Ra, Ra) + t4(vbb, Rb, Rb)
    gab = t4(vab, Ra, Rb)
    return g + gab + gab.permute(2, 3, 0, 1)


def _local(bR, mat):
    return embham.transform_local(bR, as_f64(mat, bR.device))


def _imp(bR, mat):
    return embham.transform_imp(bR, as_f64(mat, bR.device))


def get_emb_Ham(lattice, basis, GH1_k, GV2, GV1, H0, mu, last_dmu=0.0,
                vcor_gso=None, **kwargs):
    """GSO embedding Hamiltonian (non-interacting-bath flavour: lattice
    hcore + local interaction on the impurity cell), on the basis'
    device.

    GH1_k: combined (nk, nso, nso) pair (WITHOUT mu, WITHOUT GV1);
    GV1: (3, nao, nao) local one-body from the H2 transform, added on the
    impurity cell's species blocks.  Returns an Integral over neo
    spinless orbitals (restricted storage, ghf semantics; tensors) with
    nelec_emb = neo // 2 transformed particles at Sz = 0."""
    ncells, nso, neo = basis.shape[1], basis.shape[2], basis.shape[3]
    nao = nso // 2
    bR = basis[0]
    basis_k = lattice.R2k_basis(basis)
    H1_emb = embham.transform_h1(GH1_k, basis_k)[0]

    # mu on every cell (part of the transformed lattice H1)
    H1_emb = H1_emb + _local(bR, mu_matrix(mu, nao))

    # local one-body from the H2 ph-transform: IMPURITY CELL ONLY -- it
    # is the transform of the (impurity-truncated, NIB) interaction
    gv1_mat = np.zeros((nso, nso))
    gv1_mat[:nao, :nao] = GV1[0]
    gv1_mat[nao:, nao:] = GV1[1]
    gv1_mat[:nao, nao:] = GV1[2]
    gv1_mat[nao:, :nao] = GV1[2].T
    H1_emb = H1_emb + _imp(bR, gv1_mat)

    # correlation potential in the ENVIRONMENT only (the Slater NIB
    # convention: add everywhere, subtract the impurity copy)
    if vcor_gso is not None:
        H1_emb = H1_emb + _local(bR, vcor_gso) - _imp(bR, vcor_gso)

    # two-body on the impurity cell only (non-interacting bath)
    g_emb = transform_eri_local_gso(bR[:1, :nao, :], bR[:1, nao:, :], GV2)
    return Integral(neo, True, False, H0, {"cd": H1_emb[None]},
                    {"ccdd": g_emb[None]})


def get_emb_Ham_ib(lattice, basis, GFock_k, GH1_full_k, chol_L, H0, mu,
                   GRho_k_mf, vcor_gso=None):
    """INTERACTING-BATH GSO embedding Hamiltonian:

      H2  = full ph-transformed lattice ERI in the embedding basis,
            sum_x (La_x - Lb_x) (x) (La_x - Lb_x)  (the DF syrk kernel)
      H1  = emb[GFock(k)] - (J-K)[GRho_emb_mf; H2] + local(mu)
      JK_core = emb[GFock] - JK_emb - emb[GH1_full]   (for the energy
            functional; GH1_full = ph hcore INCLUDING the GV1
            normal-ordering term)

    GFock_k / GH1_full_k: combined (nk, nso, nso) pairs; chol_L:
    (naux, nsites, nsites) supercell DF factors (tensor); GRho_k_mf:
    mean-field GSO density pair over k.  Returns (ImpHam, JK_core)."""
    from libdmet_preview_tpu_torch.ops.eri_transform import (
        get_emb_eri_gso_chol)
    nso, neo = basis.shape[2], basis.shape[3]
    nao = nso // 2
    dev = basis.device
    basis_k = lattice.R2k_basis(basis)

    with stage("H2", dev):
        g_emb = get_emb_eri_gso_chol(chol_L, basis)

    with stage("H1", dev):
        fock_emb = embham.transform_h1(GFock_k, basis_k)[0]
        hcore_emb = embham.transform_h1(GH1_full_k, basis_k)[0]
        GRho_emb_mf = embham.foldRho_k(GRho_k_mf, basis_k)[0]
        JK_emb = get_veff_ghf(GRho_emb_mf, g_emb)

        H1_emb = fock_emb - JK_emb
        JK_core = H1_emb - hcore_emb

        bR = basis[0]
        H1_emb = H1_emb + _local(bR, mu_matrix(mu, nao))
        if vcor_gso is not None:
            H1_emb = H1_emb + _local(bR, vcor_gso) - _imp(bR, vcor_gso)

    ImpHam = Integral(neo, True, False, H0, {"cd": H1_emb[None]},
                      {"ccdd": g_emb[None]})
    return ImpHam, JK_core


def get_H_dmet_ib(lattice, basis, GH1_full_k, JK_core, ImpHam, H0):
    """Democratically scaled GSO Hamiltonian for the INTERACTING-BATH
    energy functional:

      H1_scaled = emb[GH1_full(k)] + JK_core/2   -> democratic scaling
      H2_scaled = democratic scaling of the full GSO embedding ERI
      H0        = physical + ph-transform constants (caller supplies)

    Evaluate with solver.run_dmet_ham (the stored GSO 1/2-RDMs)."""
    from libdmet_preview_tpu_torch.dmet.hubbard import (get_H1_scaled,
                                                        get_H2_scaled)
    nso, neo = basis.shape[2], basis.shape[3]
    basis_k = lattice.R2k_basis(basis)
    hcore_emb = embham.transform_h1(GH1_full_k, basis_k)[0]
    H1_scaled = hcore_emb + 0.5 * JK_core
    imp_idx = np.arange(nso)
    env_idx = np.arange(nso, neo)
    H1_scaled = get_H1_scaled(H1_scaled[None], imp_idx, env_idx)
    H2_scaled = get_H2_scaled(ImpHam.H2["ccdd"], imp_idx, env_idx)
    return Integral(neo, True, False, H0, {"cd": H1_scaled},
                    {"ccdd": H2_scaled})


def get_E_dmet_ib(lattice, basis, GH1_full_k, JK_core, ImpHam, H0,
                  solver, solver_args=None):
    Ham_scaled = get_H_dmet_ib(lattice, basis, GH1_full_k, JK_core,
                               ImpHam, H0)
    return solver.run_dmet_ham(Ham_scaled, **(solver_args or {}))


def apply_dmu(lattice, ImpHam, basis, dmu):
    """Add -dmu on the impurity-cell PHYSICAL electron count:
    -dmu*(n_a - n_b)_imp in the GSO rep."""
    nao = basis.shape[2] // 2
    dH = _imp(basis[0], mu_matrix(dmu, nao))
    ImpHam.H1["cd"] = ImpHam.H1["cd"] + dH[None]
    return ImpHam


def FitVcorGSOEmb(GRhoEmb, lattice, basis, vcor, GH1_k, mu, MaxIter=300,
                  imp_fit=False, **kwargs):
    """Correlation-potential fit in the GSO frame, fixed embedding basis,
    on the basis' device.

    vcor: a Bogoliubov Vcor ([va, vb, D] components); the fit cost is
    || GRho_mf(param) - GRhoEmb || with GRho_mf from the eigenbasis of
      embH1 + sum_P param_P dV_P,   embH1 = emb[GH1(k) + mu_mat]
    at fixed transformed particle number neo/2.  The zero-T objective and
    gradient and the CG engine are the Slater fit's (ops/fit.py).
    Returns (a fitted copy of vcor, fit error)."""
    from libdmet_preview_tpu_torch.ops.fit import (_fit_cg_zero_t,
                                                   _nelec_column)
    dev = basis.device
    nso, neo = basis.shape[2], basis.shape[3]
    nao = nso // 2
    GRhoEmb = as_f64(GRhoEmb, dev)
    if GRhoEmb.ndim == 3:
        GRhoEmb = GRhoEmb[0]

    basis_k = lattice.R2k_basis(basis)
    f_re = np.asarray(GH1_k[0]) + mu_matrix(mu, nao)
    embH1 = embham.transform_h1((f_re, GH1_k[1]), basis_k)

    # dV/dparam: combine each gradient component and rotate to the
    # embedding basis
    grad3 = np.asarray(vcor.gradient())          # (P, 3, nao, nao)
    dV_gso = as_f64(np.asarray([combine_vcor(g) for g in grad3]), dev)
    dV = torch.einsum("sRpi, Ppq, sRqj -> Psij", basis, dV_gso, basis)

    mask = torch.ones((1, neo, neo), dtype=torch.float64, device=dev)
    if imp_fit:
        mask.zero_()
        mask[:, :nso, :nso] = 1.0
    Li = torch.eye(neo, dtype=torch.float64, device=dev)[None]
    target = GRhoEmb[None]
    p0 = as_f64(np.array(vcor.param, copy=True), dev)
    p_new, err, _ = _fit_cg_zero_t(p0, embH1, dV, Li, mask, target, 1e-7,
                                   1e-3, _nelec_column((neo // 2,), dev),
                                   1e-3, int(MaxIter))
    vcor_new = copy.deepcopy(vcor)
    vcor_new.update(p_new.cpu().numpy())
    return vcor_new, float(err)


def transform_results(GRhoEmb, E_emb, basis, ImpHam, lattice, mu,
                      last_dmu=0.0, JK_core=None, **kwargs):
    """Embedded GSO results -> (GRhoImp tensor, Efrag per cell, n_phys per
    cell) with the fragment-energy convention

      E2 = E_solver - tr(H1_emb GRho) - H0        (pure 2-body part)
      H1_scaled = H1_emb + imp(cancel last_dmu) + local(cancel mu)
                  [- JK_core/2 in the interacting-bath flavour],
                  then democratic partitioning (imp-env x 0.5, env-env 0)
      Efrag = tr(H1_scaled GRho) + E2 + H0
    """
    nso, neo = basis.shape[2], basis.shape[3]
    nao = nso // 2
    GRhoEmb = as_f64(GRhoEmb, basis.device)
    if GRhoEmb.ndim == 3:
        GRhoEmb = GRhoEmb[0]
    b00 = basis[0, 0]
    GRhoImp = b00 @ GRhoEmb @ b00.T
    # physical electron count on the impurity cell
    n_phys = float(torch.trace(GRhoImp[:nao, :nao])
                   - torch.trace(GRhoImp[nao:, nao:])) + nao

    if E_emb is None:
        return GRhoImp, None, n_phys / nao

    H1_emb = ImpHam.H1["cd"][0]
    H0 = float(ImpHam.H0)
    E2 = E_emb - float(torch.sum(H1_emb * GRhoEmb.T)) - H0

    # cancel the mu (global) and last_dmu (impurity) terms in H1
    bR = basis[0]
    H1_scaled = H1_emb + _imp(bR, mu_matrix(-last_dmu, nao)) \
        + _local(bR, mu_matrix(-mu, nao))

    # interacting bath: the core JK potential is double-counted between
    # H1 and the democratic 2-body partitioning; remove half
    if JK_core is not None:
        H1_scaled = H1_scaled - 0.5 * JK_core

    # democratic partitioning: impurity = first nso embedding orbitals
    H1_scaled[:nso, nso:] *= 0.5
    H1_scaled[nso:, :nso] *= 0.5
    H1_scaled[nso:, nso:] = 0.0

    E1 = float(torch.sum(H1_scaled * GRhoEmb.T))
    Efrag = E1 + E2 + H0
    return GRhoImp, Efrag / nao, n_phys / nao
