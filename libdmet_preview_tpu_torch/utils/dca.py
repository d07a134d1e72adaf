"""
Dynamical cluster approximation (DCA) coarse graining of a lattice
dispersion (the port's own copy of libdmet_preview_tpu/utils/dca.py; host
NumPy).

The Brillouin zone is tiled into patches around the cluster momenta K;
the DCA cluster hopping is the patch average of the lattice dispersion:

    t_DCA(K) = (Nc / N) sum_{k in patch(K)} H(k)
"""

import itertools as it

import numpy as np

from libdmet_preview_tpu_torch.ops import fourier


def dca_coarse_grain(H1_k, kmesh, cmesh):
    """Coarse-grain H1(k) on the fine `kmesh` onto cluster momenta of
    `cmesh` (each dividing the corresponding kmesh dim).

    H1_k: (re, im) pair shaped (nk, n, n) on the C-ordered fine mesh.
    Returns (re, im) on the cluster mesh (nK, n, n)."""
    re, im = np.asarray(H1_k[0]), np.asarray(H1_k[1])
    kmesh = [int(x) for x in kmesh]
    cmesh = [int(x) for x in cmesh]
    assert all(km % cm == 0 for km, cm in zip(kmesh, cmesh))
    kfracs = np.asarray(list(it.product(*[np.fft.fftfreq(m)
                                          for m in kmesh])))
    Kfracs = np.asarray(list(it.product(*[np.fft.fftfreq(m)
                                          for m in cmesh])))
    nK = len(Kfracs)
    out_re = np.zeros((nK,) + re.shape[1:])
    out_im = np.zeros((nK,) + im.shape[1:])
    counts = np.zeros(nK, dtype=int)
    for ik, kf in enumerate(kfracs):
        # nearest cluster momentum (periodic distance)
        d = Kfracs - kf[None, :]
        d -= np.round(d)
        iK = int(np.argmin(np.sum(d * d, axis=1)))
        out_re[iK] += re[ik]
        out_im[iK] += im[ik]
        counts[iK] += 1
    out_re /= counts[:, None, None]
    out_im /= counts[:, None, None]
    return out_re, out_im


def dca_cluster_H1R(H1_k, kmesh, cmesh):
    """Coarse-grained cluster-model H1 in R space (real stripe)."""
    GK = dca_coarse_grain(H1_k, kmesh, cmesh)
    return np.asarray(fourier.k2R(GK, tuple(cmesh)))
