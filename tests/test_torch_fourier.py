"""
The rest of the PyTorch port's ops/fourier.py (FFTtoK, FFTtoT, get_phase,
k2gamma, gamma2k, wigner_seitz_images, band_velocity, fold_mo_k2gamma)
against the JAX package's ops/fourier.py on identical NumPy-seeded inputs:
1e-12, on 1D, 2D and 3D meshes.
"""

import numpy as np
import pytest

MESHES = [(5,), (3, 2), (2, 2, 3)]


def herm_stripe(kmesh, n, seed):
    """A real stripe A(R) with A(-R) = A(R)^T, so that A(k) is Hermitian."""
    import itertools as it
    rng = np.random.RandomState(seed)
    cells = list(it.product(*[range(m) for m in kmesh]))
    idx = {c: i for i, c in enumerate(cells)}
    A = rng.randn(len(cells), n, n)
    for c, i in idx.items():
        j = idx[tuple((-np.asarray(c)) % kmesh)]
        if j == i:
            A[i] = 0.5 * (A[i] + A[i].T)
        elif j > i:
            A[j] = A[i].T
    return A


def close(a, b, tol=1e-12):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and np.abs(a - b).max() < tol


@pytest.mark.parametrize("kmesh", MESHES)
def test_fft_and_phase(kmesh):
    from libdmet_preview_tpu.ops import fourier as jf
    from libdmet_preview_tpu_torch.ops import fourier as tf
    A = np.random.RandomState(0).randn(2, int(np.prod(kmesh)), 3, 4)
    kj, kt = jf.FFTtoK(A, kmesh), tf.FFTtoK(A, kmesh)
    close(kt[0], kj[0])
    close(kt[1], kj[1])
    close(tf.FFTtoT(kt, kmesh), jf.FFTtoT(kj, kmesh))
    close(tf.FFTtoT(kt, kmesh), A)
    close(tf.get_phase(kmesh), jf.get_phase(kmesh))


@pytest.mark.parametrize("kmesh", MESHES)
def test_k2gamma_gamma2k(kmesh):
    from libdmet_preview_tpu.ops import fourier as jf
    from libdmet_preview_tpu_torch.ops import fourier as tf
    n = 2
    A = herm_stripe(kmesh, n, 1)[None]
    Ak = tf.R2k(A, kmesh)
    sc_t, sc_j = tf.k2gamma(Ak, kmesh), jf.k2gamma(jf.R2k(A, kmesh), kmesh)
    close(sc_t, sc_j)
    assert np.abs(sc_t - np.swapaxes(sc_t, -1, -2)).max() < 1e-12
    bk_t, bk_j = tf.gamma2k(sc_t, kmesh, n), jf.gamma2k(sc_j, kmesh, n)
    close(bk_t[0], bk_j[0])
    close(bk_t[1], bk_j[1])
    close(bk_t[0], Ak[0])
    close(bk_t[1], Ak[1])


@pytest.mark.parametrize("kmesh", [(4,), (5,), (4, 3), (2, 2, 2)])
def test_wigner_seitz_images(kmesh):
    from libdmet_preview_tpu.ops import fourier as jf
    from libdmet_preview_tpu_torch.ops import fourier as tf
    Rj, wj = jf.wigner_seitz_images(kmesh)
    Rt, wt = tf.wigner_seitz_images(kmesh)
    close(wt, wj)
    assert len(Rt) == len(Rj)
    for a, b in zip(Rt, Rj):
        close(a, b)


@pytest.mark.parametrize("kmesh", [(6,), (4, 3)])
def test_band_velocity(kmesh):
    from libdmet_preview_tpu.ops import fourier as jf
    from libdmet_preview_tpu_torch.ops import fourier as tf
    H_R = herm_stripe(kmesh, 3, 2)
    kpts = np.random.RandomState(3).rand(5, len(kmesh))
    bj, vj = jf.band_velocity(H_R, kmesh, kpts)
    bt, vt = tf.band_velocity(H_R, kmesh, kpts)
    close(bt, bj)
    close(vt, vj)
    assert vt.shape == (5, len(kmesh), 3)


@pytest.mark.parametrize("make_real", [True, False])
@pytest.mark.parametrize("kmesh", [(4,), (3, 2)])
def test_fold_mo_k2gamma(kmesh, make_real):
    """Folded MO energies, and the folded orbitals through their
    projector onto each degenerate group (the real gauge inside a group is
    eigh's choice): 1e-10."""
    from libdmet_preview_tpu.ops import fourier as jf
    from libdmet_preview_tpu_torch.ops import fourier as tf
    n = 3
    H_R = herm_stripe(kmesh, n, 4)
    Hk = tf.R2k(H_R, kmesh)
    ew, ev = np.linalg.eigh(Hk[0] + 1j * Hk[1])
    C_k = (ev.real, ev.imag)
    Cj, ej, okj = jf.fold_mo_k2gamma(C_k, ew, kmesh, make_real=make_real)
    Ct, et, okt = tf.fold_mo_k2gamma(C_k, ew, kmesh, make_real=make_real)
    close(et, ej)
    if make_real:
        assert okt.all() and np.array_equal(okt, okj)
        assert not np.iscomplexobj(Ct)
    else:
        assert okt is None and okj is None
    close(Ct @ Ct.conj().T, Cj @ Cj.conj().T, 1e-10)
    H_sc = tf.k2gamma((Hk[0][None], Hk[1][None]), kmesh)[0]
    assert np.abs(Ct.conj().T @ H_sc @ Ct - np.diag(et)).max() < 1e-8
