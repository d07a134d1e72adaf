"""
Embedding-ERI transforms from Cholesky / density-fitting factors (PyTorch
port of libdmet_preview_tpu/ops/eri_transform.py: cholesky_eri,
_rotate_chol, get_emb_eri_chol, get_emb_eri_gso_chol, get_emb_eri_mol,
make_gdf_factors, get_emb_eri_gdf, get_emb_eri_gso_gdf and the dispatcher
get_emb_eri).

    L_emb[x, i, j] = C[p, i] L[x, p, q] C[q, j]       (LO -> EO rotation)
    eri[s]         = sum_x La[x, ij] Lb[x, kl]         (DF syrk)

The rotation is two batched f64 GEMMs (torch.matmul).  Each spin's factors
are s4-packed once; the syrk is eri_kernels.syrk_df: on CUDA tensors the
hand-written Hopper kernels (the symmetric one for the aa and bb blocks,
the cross one for ab), on CPU tensors their plain versions.  Each piece is
a utils.timer stage.  The JAX package's size rule for
choosing its Pallas kernel and its HDF5 `outcore` mode are not ported.
The GSO ERI (the particle-hole transformed spinless interaction) is one
symmetric syrk of the packed species difference La - Lb: on CUDA the
hand-written kernel, where the JAX package runs a plain einsum.

The k-resolved GDF path works on complex128 tensors: per momentum transfer
q the factors F_q rotate into the embedding basis with momentum
conservation, all transfers of equal rank in one batched einsum, and the
ERI is one real GEMM over the stacked real and imaginary parts.  Its
rotated factors G and H are not pair-symmetric, so that GEMM is
torch.matmul, not the DF syrk.
"""

import numpy as np
import torch

from libdmet_preview_tpu_torch.utils.misc import as_f64
from libdmet_preview_tpu_torch.utils.timer import stage
from libdmet_preview_tpu_torch.ops.eri_kernels import (pack_tril, syrk_df,
                                                       unpack_s4)


def cholesky_eri(eri, tol=1e-9, max_rank=None):
    """Pivoted (modified) Cholesky factorization of a (n, n, n, n) chemist
    ERI: eri ~= sum_x L[x] (x) L[x], L (naux, n, n).  Host NumPy."""
    eri = np.asarray(eri)
    n = eri.shape[0]
    M = eri.reshape(n * n, n * n).copy()
    diag = np.diag(M).copy()
    if max_rank is None:
        max_rank = n * n
    Ls = []
    for _ in range(max_rank):
        p = int(np.argmax(diag))
        dmax = diag[p]
        if dmax < tol:
            break
        l = M[:, p] / np.sqrt(dmax)
        Ls.append(l)
        M -= np.outer(l, l)
        diag = np.maximum(np.diag(M), 0.0)
    L = np.asarray(Ls).reshape(len(Ls), n, n)
    # symmetrize (pq) since eri has (pq|rs) = (qp|rs) for real orbitals
    return 0.5 * (L + L.transpose(0, 2, 1))


def _rotate_chol(L, C):
    """(naux, n, n) x (n, neo) -> (naux, neo, neo): C^T L_x C as two
    batched GEMMs."""
    return torch.matmul(C.T, torch.matmul(L, C))


def _flat_basis(L, basis):
    """(spin, ncells, nlo, neo) basis -> (spin, nsites, neo) tensor on L's
    device."""
    basis = as_f64(basis, L.device)
    spin, ncells, nlo, neo = basis.shape
    return basis.reshape(spin, ncells * nlo, neo)


def get_emb_eri_chol(L, basis):
    """Embedding ERI from Cholesky/DF factors.

    L: (naux, nsites, nsites) float64 tensor in the (LO, full-lattice)
    site basis; basis: (spin, ncells, nlo, neo) embedding basis (R
    stripe), tensor or array.  Returns the (spin_pair, neo, neo, neo, neo)
    tensor on L's device with blocks [aa] or [aa, bb, ab] (chemist),
    matching embham._emb_H2's contract."""
    C = _flat_basis(L, basis)
    spin, _, neo = C.shape
    dev = L.device
    with stage("ERI rotation", dev):
        Ls = [_rotate_chol(L, C[s]) for s in range(spin)]
    with stage("ERI pack", dev):
        Fs = [pack_tril(Lemb) for Lemb in Ls]
    del Ls
    pairs = [(0, None)] if spin == 1 else [(0, None), (1, None), (0, 1)]
    out = torch.empty((len(pairs),) + (neo,) * 4, dtype=L.dtype, device=dev)
    for m, (s1, s2) in enumerate(pairs):
        name = "syrk (tri kernel)" if s2 is None else "syrk ab (cross kernel)"
        with stage(name, dev):
            s4 = syrk_df(Fs[s1], None if s2 is None else Fs[s2])
        with stage("ERI unpack", dev):
            unpack_s4(s4, neo, out=out[m])
    return out


def get_emb_eri_gso_chol(L, basis):
    """GSO (particle-hole transformed) embedding ERI from Cholesky / DF
    factors.  The transformed two-body [aa: +g, bb: +g, ab: -g] of one
    spatial ERI g = sum_x L_x (x) L_x factorizes exactly:

        g_gso = sum_x (La_x - Lb_x) (x) (La_x - Lb_x)

    with La / Lb the factors rotated by the a / b species blocks of the GSO
    embedding basis: the two rotations, one subtraction, and one launch of
    the symmetric DF syrk on the s4-packed difference (on CUDA the
    hand-written kernel, on the CPU its plain version).

    L: (naux, nsites, nsites) float64 tensor in the (LO, full-lattice)
    site basis of one species; basis: ((1,) ncells, nso, neo) GSO basis,
    tensor or array, rows [:nao] = a species, [nao:] = b species per cell.
    Returns the (neo,)*4 chemist tensor on L's device."""
    dev = L.device
    basis = as_f64(basis, dev)
    if basis.ndim == 4:
        basis = basis[0]
    ncells, nso, neo = basis.shape
    nao = nso // 2
    Ca = basis[:, :nao, :].reshape(ncells * nao, neo)
    Cb = basis[:, nao:, :].reshape(ncells * nao, neo)
    with stage("ERI rotation", dev):
        Ld = _rotate_chol(L, Ca) - _rotate_chol(L, Cb)
    with stage("ERI pack", dev):
        F = pack_tril(Ld)
    del Ld
    with stage("syrk (tri kernel)", dev):
        s4 = syrk_df(F)
    with stage("ERI unpack", dev):
        return unpack_s4(s4, neo)


def get_emb_eri_mol(eri_full, basis):
    """Direct (un-factorized) embedding transform of a dense (n,)*4 ERI
    tensor; brute-force oracle for get_emb_eri_chol."""
    g = eri_full
    C = _flat_basis(g, basis)

    def t4(Cp, Cq):
        return torch.einsum("pqrs, pi, qj, rk, sl -> ijkl", g, Cp, Cp, Cq, Cq)

    if C.shape[0] == 1:
        return t4(C[0], C[0])[None]
    return torch.stack([t4(C[0], C[0]), t4(C[1], C[1]), t4(C[0], C[1])])


# ----------------------------------------------------------------------
# k-resolved GDF factors
# ----------------------------------------------------------------------

def _cplx(pair, device):
    """(re, im) pair of arrays or tensors -> complex128 tensor on device."""
    return torch.complex(as_f64(pair[0], device), as_f64(pair[1], device))


def _dft_phase(ncells, device):
    """P[k, A] = e^{-2 pi i f_k A}, f = fftfreq(ncells), on the flattened
    cell index A of a 1D cyclic mesh."""
    f = np.fft.fftfreq(ncells)
    P = np.exp(-2j * np.pi * np.outer(f, np.arange(ncells)))
    return torch.as_tensor(P, dtype=torch.complex128, device=device)


def _eri_R_to_k8(eri_lo, ncells, nlo, device):
    """Translation-invariant supercell LO ERI -> Ek[k1, p, k2, q, k3, r,
    k4, s] = (k1 p, k2 q | k3 r, k4 s) for every k-quadruple, as four
    one-index transforms on `device`; creation legs (1st, 3rd) carry
    e^{-ikR}, annihilation legs the conjugate."""
    E = as_f64(eri_lo, device).reshape((ncells, nlo) * 4)
    P = _dft_phase(ncells, device)
    Ek = torch.einsum("kA, ApBqCrDs -> kpBqCrDs", P, E.to(torch.complex128))
    Ek = torch.einsum("lB, kpBqCrDs -> kplqCrDs", P.conj(), Ek)
    Ek = torch.einsum("mC, kplqCrDs -> kplqmrDs", P, Ek)
    Ek = torch.einsum("nD, kplqmrDs -> kplqmrns", P.conj(), Ek)
    return Ek / ncells ** 2


def make_gdf_factors(eri_lo, ncells, nlo, tol=1e-10,
                     device=torch.device("cuda")):
    """k-resolved density-fitting factors of a translation-invariant LO
    ERI, grouped by momentum transfer, on `device`.

    For each transfer q the Hermitian PSD matrix
        M_q[(k1, p, a), (k3, s, r)] = (k1 p, k1+q a | k3+q r, k3 s)
    is factorized M_q = F_q F_q^H (eigendecomposition; rank-revealing; the
    eigenvector gauge is free, so compare M_q, not F_q).
    Conventions: creation legs carry e^{+ikR} phases.  The momentum
    algebra k + q is taken on the flattened cell index, which is the
    lattice's own on a 1D cyclic mesh only; the function takes `ncells`,
    not a mesh.

    Returns {q: (F_re, F_im)} of float64 tensors with F shaped (ncells,
    nlo, nlo, naux_q)."""
    device = torch.device(device)
    Ek = _eri_R_to_k8(eri_lo, ncells, nlo, device)
    Ek = Ek.permute(0, 2, 4, 6, 1, 3, 5, 7)        # [k1, k2, k3, k4, p,a,r,s]
    k = torch.arange(ncells, device=device)
    nn = nlo * nlo
    out = {}
    for q in range(ncells):
        kq = (k + q) % ncells
        # blk[k1, k3, p, a, r, s] = Ek[k1, k1+q, k3+q, k3]
        blk = Ek[k[:, None], kq[:, None], kq[None, :], k[None, :]]
        # rows (k1, p, a), columns (k3, s, r)
        M = blk.permute(0, 2, 3, 1, 5, 4).reshape(ncells * nn, ncells * nn)
        M = 0.5 * (M + M.conj().T)
        w, v = torch.linalg.eigh(M)
        keep = w > tol
        F = (v[:, keep] * torch.sqrt(w[keep])).reshape(ncells, nlo, nlo, -1)
        out[q] = (F.real.contiguous(), F.imag.contiguous())
    return out


def _q_groups(factors, items, device):
    """The (q, w) items as batches of equal rank: a list of (qs, ws, F)
    with F the stacked complex factors (nq, nk, nlo, nlo, naux).  Analytic
    factors have one rank for all transfers and give one batch."""
    by_rank = {}
    for q, w in items:
        by_rank.setdefault(int(factors[q][0].shape[-1]), []).append((q, w))
    return [([q for q, _ in qw], [w for _, w in qw],
             torch.stack([_cplx(factors[q], device) for q, _ in qw]))
            for qw in by_rank.values()]


def get_emb_eri_gdf(factors, basis_k, ncells, nlo, tr_symm=False,
                    device=torch.device("cuda")):
    """Embedding ERI from k-resolved GDF factors with momentum
    conservation, on `device`.

    tr_symm=True exploits time reversal (real R-space orbitals): the -q
    transfer contributes the complex conjugate, so only the irreducible
    transfers are computed with weight 2.

    k + q and -q are taken on the flattened k index ((k + q) % ncells,
    (ncells - q) % ncells): the lattice's momentum algebra on a 1D cyclic
    mesh only.  The function takes `ncells`, not a mesh.

    factors: {q: (F_re, F_im)} from make_gdf_factors, arrays or tensors;
    basis_k: (re, im) pair (1, nk, nlo, neo).
    Returns the real (1, neo, neo, neo, neo) chemist embedding ERI tensor
    on `device`."""
    device = torch.device(device)
    C = torch.complex(as_f64(basis_k[0], device)[0],
                      as_f64(basis_k[1], device)[0])
    neo = C.shape[-1]
    if tr_symm:
        items = [(q, 2.0 if (ncells - q) % ncells != q else 1.0)
                 for q in factors if q <= (ncells - q) % ncells]
    else:
        items = [(q, 1.0) for q in factors]
    k = torch.arange(ncells, device=device)
    Cc = C.conj()
    eri = torch.zeros((neo * neo, neo * neo), dtype=torch.float64,
                      device=device)
    for qs, ws, F in _q_groups(factors, items, device):
        qv = torch.as_tensor(qs, device=device)
        Cq = C[(k[None, :] + qv[:, None]) % ncells]      # C(k + q)
        with stage("GDF rotation", device):
            # G_x[i, j] = sum_{k p a} F[k,p,a,x] C*(k)_pi C(k+q)_aj
            G = torch.einsum("qkpax, kpi, qkaj -> qxij", F, Cc, Cq)
            # H_x[m, l] = sum_{k s r} F[k,s,r,x] C(k+q)_rm C*(k)_sl
            H = torch.einsum("qksrx, qkrm, ksl -> qxml", F, Cq, Cc)
        with stage("GDF contraction", device):
            # eri += w_q Re[G_x[i,j] conj(H_x[k,l])]
            wv = torch.as_tensor(ws, dtype=torch.float64,
                                 device=device)[:, None, None, None]
            G = (G * wv).reshape(-1, neo * neo)
            H = H.reshape(-1, neo * neo)
            eri += torch.cat([G.real, G.imag]).T @ torch.cat([H.real, H.imag])
    return eri.reshape((1,) + (neo,) * 4) / ncells ** 2


def get_emb_eri_gso_gdf(factors, basis_k, ncells, nao, tr_symm=False,
                        device=torch.device("cuda")):
    """GSO (particle-hole transformed) embedding ERI from k-resolved GDF
    factors, on `device`.  With La / Lb the factors rotated by the a / b
    species blocks of the GSO basis, g_gso = sum_x (La - Lb) (x)
    (La - Lb)^*: the rotated factors G and H of get_emb_eri_gdf are taken
    as the species differences, with the same momentum conservation on
    the flattened k index (a 1D cyclic mesh).

    factors: {q: (F_re, F_im)} from make_gdf_factors over nao spatial LOs,
    arrays or tensors; basis_k: (re, im) pair (1, nk, 2*nao, neo) GSO
    basis, rows [:nao] = a species, [nao:] = b species per cell.
    Returns the real (neo, neo, neo, neo) chemist GSO embedding ERI
    tensor on `device`."""
    device = torch.device(device)
    C = torch.complex(as_f64(basis_k[0], device)[0],
                      as_f64(basis_k[1], device)[0])
    Cs = (C[:, :nao, :], C[:, nao:, :])
    neo = C.shape[-1]
    if tr_symm:
        items = [(q, 2.0 if (ncells - q) % ncells != q else 1.0)
                 for q in factors if q <= (ncells - q) % ncells]
    else:
        items = [(q, 1.0) for q in factors]
    k = torch.arange(ncells, device=device)
    eri = torch.zeros((neo * neo, neo * neo), dtype=torch.float64,
                      device=device)
    for qs, ws, F in _q_groups(factors, items, device):
        qv = torch.as_tensor(qs, device=device)
        G = H = 0.0
        with stage("GDF rotation", device):
            for sign, Cx in zip((1.0, -1.0), Cs):
                Cq = Cx[(k[None, :] + qv[:, None]) % ncells]    # C(k + q)
                Cc = Cx.conj()
                G = G + sign * torch.einsum("qkpax, kpi, qkaj -> qxij", F,
                                            Cc, Cq)
                H = H + sign * torch.einsum("qksrx, qkrm, ksl -> qxml", F,
                                            Cq, Cc)
        with stage("GDF contraction", device):
            wv = torch.as_tensor(ws, dtype=torch.float64,
                                 device=device)[:, None, None, None]
            G = (G * wv).reshape(-1, neo * neo)
            H = H.reshape(-1, neo * neo)
            eri += torch.cat([G.real, G.imag]).T @ torch.cat([H.real, H.imag])
    return eri.reshape((neo,) * 4) / ncells ** 2


def get_emb_eri(source, basis, df_type=None, device=torch.device("cuda"),
                **kwargs):
    """Unified embedding-ERI dispatch by density-fitting type.  The routing
    key is either inferred from `source` or named explicitly:

      df_type      source                         routine
      ---------    ----------------------------   -------------------------
      "chol"       (naux, n, n) Cholesky/DF L      get_emb_eri_chol
      "gdf"        {q: (F_re, F_im)} k-factors     get_emb_eri_gdf
      "mol"        dense (n,)*4 chemist ERI        get_emb_eri_mol
      "aft"        cell object                     source.get_emb_eri_aft
      "fft"        cell object                     source.get_emb_eri_fft
      "mdf"/"rs"   cell object                     source.get_emb_eri_rs

    For the cell routines `basis` is the (nao, neo) AO->EO coefficient
    matrix and the call goes to the method on `source`; for the array
    routines it is the (spin, ncells, nlo, neo) stripe embedding basis
    (get_emb_eri_gdf additionally needs ncells/nlo via kwargs) and the
    work runs on `device`.  Extra kwargs pass through to the routine."""
    if df_type is None:
        if hasattr(source, "get_emb_eri_aft"):
            df_type = "aft"
        elif isinstance(source, dict):
            df_type = "gdf"
        else:
            ndim = source.ndim if isinstance(source, torch.Tensor) \
                else np.ndim(source)
            if ndim == 3:
                df_type = "chol"
            elif ndim >= 4:
                df_type = "mol"
            else:
                raise ValueError("cannot infer df_type from source shape "
                                 f"{tuple(np.shape(source))}")
    df_type = df_type.lower()
    if df_type == "chol":
        return get_emb_eri_chol(as_f64(source, device), basis, **kwargs)
    if df_type == "gdf":
        return get_emb_eri_gdf(source, basis, device=device, **kwargs)
    if df_type in ("mol", "incore"):
        return get_emb_eri_mol(as_f64(source, device), basis)
    if df_type in ("aft", "fft", "mdf", "rs"):
        name = {"aft": "get_emb_eri_aft", "fft": "get_emb_eri_fft",
                "mdf": "get_emb_eri_rs", "rs": "get_emb_eri_rs"}[df_type]
        return getattr(source, name)(basis, **kwargs)
    raise ValueError(f"unknown df_type {df_type!r}")
