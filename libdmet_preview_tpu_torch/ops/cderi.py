"""
CDERI interop (PyTorch port of libdmet_preview_tpu/ops/cderi.py): ingest
externally prepared density-fitting factors into the per-transfer GDF
factors the embedding-ERI transforms consume, and export ours in the same
layout.  Host NumPy.

The JAX package reads and writes the PySCF GDF HDF5 file; the port keeps
that file's layout, key for key, in a NumPy .npz archive (no h5py):

  j3c-kptij : (npair, 2, 3) absolute k-points of each stored (ki, kj)
              pair (where only ki <= kj is stored, the reverse pair is
              the conjugate transpose)
  j3c/<idx>/<seg> : aux x row-chunk arrays, concatenated over <seg>; real
              s2 (packed tril) when ki == kj and the k-point is real
              (gamma-like), complex s1 (nao*nao) otherwise

  contraction convention: (p_ki q_kj | r_kk s_kl) =
      sum_x L[ki,kj][x, p, q] * L[kl,kk][x, s, r]
  with momentum conservation kj - ki = kk - kl (mod G).
"""

import numpy as np
import torch

from libdmet_preview_tpu_torch.utils import logger as log


def _kpt_index(kpts, k, tol=1e-8):
    d = np.abs(kpts - np.asarray(k)[None, :]).sum(axis=1)
    i = int(np.argmin(d))
    if d[i] > tol:
        raise ValueError("k-point %s not in the mesh" % (k,))
    return i


def _q_index(kpts_scaled, ki, kj, tol=1e-6):
    """Index q with kpts_scaled[q] == kpts_scaled[kj] - kpts_scaled[ki]
    (mod 1)."""
    d = kpts_scaled[kj] - kpts_scaled[ki]
    d = d - np.round(d)
    for q in range(len(kpts_scaled)):
        r = kpts_scaled[q] - d
        if np.abs(r - np.round(r)).max() < tol:
            return q
    raise ValueError("no transfer index for pair (%d, %d)" % (ki, kj))


def _host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def write_cderi(fname, factors, kpts, kpts_scaled, nao):
    """Export per-transfer factors {q: (F_re, F_im)} (F shaped (nk, nao,
    nao, naux_q), arrays or tensors) as a CDERI .npz archive at `fname`
    (written as given, no suffix added).

    All (ki, kj) pairs are stored explicitly (the layout permits an
    arbitrary kptij list): the ki <= kj + conjugate convention presumes one
    globally shared real auxiliary basis, which per-transfer eigen factors
    do not have -- conjugate-filling across transfers would mix aux
    gauges."""
    nk = len(kpts)
    kpts_scaled = np.asarray(kpts_scaled, dtype=float)
    factors = {q: (_host(f[0]), _host(f[1])) for q, f in factors.items()}
    data = {}
    pairs = []
    ix, jx = np.tril_indices(nao)
    for ki in range(nk):
        for kj in range(nk):
            q = _q_index(kpts_scaled, ki, kj)
            F_re, F_im = factors[q]
            L = np.moveaxis(F_re[ki] + 1j * F_im[ki], -1, 0)  # (naux, nao, nao)
            # gamma-like diagonal pairs are stored real s2-packed; eigen
            # factors are only real there if the aux gauge is real, so
            # store s2 only when actually real
            gamma_like = (ki == kj
                          and np.abs(kpts_scaled[ki]
                                     - np.round(kpts_scaled[ki])).max() < 1e-8
                          and np.abs(L.imag).max() < 1e-12)
            naux = L.shape[0]
            Ls = L.real[:, ix, jx] if gamma_like \
                else L.reshape(naux, nao * nao)
            # two segments, as the HDF5 writers chunk the aux axis
            cut = max(1, naux // 2)
            idx = len(pairs)
            data["j3c/%d/0" % idx] = Ls[:cut]
            data["j3c/%d/1" % idx] = Ls[cut:]
            pairs.append((kpts[ki], kpts[kj]))
    data["j3c-kptij"] = np.asarray(pairs)
    with open(fname, "wb") as f:
        np.savez(f, **data)


def read_cderi(fname, kpts, kpts_scaled, nao, tol_kpt=1e-8):
    """Ingest a CDERI .npz archive into the per-transfer GDF factors
    {q: (F_re, F_im)} (NumPy arrays) consumed by
    ops.eri_transform.get_emb_eri_gdf."""
    nk = len(kpts)
    kpts = np.asarray(kpts, dtype=float)
    kpts_scaled = np.asarray(kpts_scaled, dtype=float)
    pair_L = {}
    with np.load(fname) as f:
        kptij = np.asarray(f["j3c-kptij"])
        segs_of = {}
        for key in f.files:
            if key.startswith("j3c/"):
                _, idx, seg = key.split("/")
                segs_of.setdefault(int(idx), []).append(int(seg))
        for idx in range(kptij.shape[0]):
            ki = _kpt_index(kpts, kptij[idx, 0], tol_kpt)
            kj = _kpt_index(kpts, kptij[idx, 1], tol_kpt)
            L = np.concatenate([f["j3c/%d/%d" % (idx, s)]
                                for s in sorted(segs_of[idx])], axis=0)
            if L.ndim == 2 and L.shape[1] == nao * (nao + 1) // 2 \
                    and not np.iscomplexobj(L):
                # s2 packed tril -> full symmetric
                full = np.zeros((L.shape[0], nao, nao))
                ix, jx = np.tril_indices(nao)
                full[:, ix, jx] = L
                full[:, jx, ix] = L
                L = full.astype(complex)
            else:
                L = np.asarray(L, dtype=complex).reshape(-1, nao, nao)
            pair_L[(ki, kj)] = L
    # conjugate-transpose fills the unstored reverse pairs
    for (ki, kj) in list(pair_L.keys()):
        if (kj, ki) not in pair_L:
            pair_L[(kj, ki)] = pair_L[(ki, kj)].conj().transpose(0, 2, 1)
    factors = {}
    for q in range(nk):
        Fs = []
        naux_q = None
        for ki in range(nk):
            kj = None
            for cand in range(nk):
                if _q_index(kpts_scaled, ki, cand) == q:
                    kj = cand
                    break
            if kj is None or (ki, kj) not in pair_L:
                raise ValueError("missing CDERI pair for transfer %d "
                                 "at k %d" % (q, ki))
            L = pair_L[(ki, kj)]
            if naux_q is None:
                naux_q = L.shape[0]
            log.eassert(L.shape[0] == naux_q,
                        "inconsistent naux across pairs of transfer %d",
                        q)
            Fs.append(np.moveaxis(L, 0, -1))       # (nao, nao, naux)
        F = np.asarray(Fs)                         # (nk, nao, nao, naux)
        factors[q] = (np.ascontiguousarray(F.real),
                      np.ascontiguousarray(F.imag))
    return factors
