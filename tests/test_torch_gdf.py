"""
The PyTorch port's k-resolved GDF path (make_gdf_factors, get_emb_eri_gdf,
the get_emb_eri dispatcher of ops/eri_transform.py; eri_R_to_eri_7d,
get_jk_from_eri_7d, get_jk_from_gdf, eri_to_gdf of ops/pbc_helper.py; the
.npz CDERI archive of ops/cderi.py) against the JAX package's on identical
inputs, on the CPU: the 3-cell, 2-atom H ring (sto-6g) of the JAX package's
host integral engine and the translation-invariant model ERI of
tests/test_pbc_helper.py.  All meshes are 1D (the functions' contract).
"""

from functools import lru_cache

import numpy as np
import pytest
import torch

from test_pbc_helper import (_dm_k_from_stripe, _full_to_k, _jk_supercell,
                             _trans_inv_eri)

torch.set_num_threads(1)

CPU = torch.device("cpu")


@lru_cache(maxsize=1)
def hring():
    """(ncells, nlo, supercell LO ERI) of the H ring, NumPy arrays from
    the JAX package's host engine."""
    from libdmet_preview_tpu.models.abinitio import make_h_ring_lattice
    Lat, meta = make_h_ring_lattice(ncells=3, atoms_per_cell=2, r_bond=1.8,
                                    basis="sto-6g")
    return Lat.ncells, Lat.nscsites, np.array(meta["eri_lo"])


@lru_cache(maxsize=1)
def hring_factors():
    from libdmet_preview_tpu.ops.eri_transform import make_gdf_factors
    from libdmet_preview_tpu_torch.ops import eri_transform as te
    nc, nlo, eri = hring()
    return (make_gdf_factors(eri, nc, nlo),
            te.make_gdf_factors(eri, nc, nlo, device=CPU))


def _cplx(pair):
    re, im = (x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
              for x in pair)
    return re + 1j * im


def test_make_gdf_factors_matches_jax():
    """M_q = F_q F_q^H of both packages (the eigenvector gauge of F is
    free): 1e-10; equal ranks; eri_to_gdf is the same function."""
    from libdmet_preview_tpu_torch.ops.pbc_helper import eri_to_gdf
    nc, nlo, eri = hring()
    fj, ft = hring_factors()
    f2 = eri_to_gdf(eri, nc, nlo, device=CPU)
    assert sorted(ft) == sorted(fj) == list(range(nc))
    for q in fj:
        Fj = _cplx(fj[q]).reshape(nc * nlo * nlo, -1)
        Ft = _cplx(ft[q]).reshape(nc * nlo * nlo, -1)
        assert ft[q][0].shape == (nc, nlo, nlo, Fj.shape[1])
        assert np.abs(Ft @ Ft.conj().T - Fj @ Fj.conj().T).max() < 1e-10
        assert torch.equal(f2[q][0], ft[q][0])


@pytest.mark.parametrize("tr_symm", [False, True])
@pytest.mark.parametrize("source", ["port factors", "jax factors"])
def test_get_emb_eri_gdf_matches_jax_and_mol(source, tr_symm):
    """get_emb_eri_gdf, from the port's own factors and from the JAX
    package's carried over by interop.gdf_factors_from_numpy, against the
    JAX function and against the port's brute-force get_emb_eri_mol:
    1e-10."""
    from libdmet_preview_tpu.ops import eri_transform as je
    from libdmet_preview_tpu.ops import fourier as jf
    from libdmet_preview_tpu_torch import interop
    from libdmet_preview_tpu_torch.ops import eri_transform as te
    from libdmet_preview_tpu_torch.ops import fourier as tf
    nc, nlo, eri = hring()
    fj, ft = hring_factors()
    basis = np.random.RandomState(4).randn(1, nc, nlo, 4)
    ref = je.get_emb_eri_gdf(fj, jf.R2k(basis, (nc,)), nc, nlo,
                             tr_symm=tr_symm)
    factors = ft if source == "port factors" \
        else interop.gdf_factors_from_numpy(fj, CPU)
    g = te.get_emb_eri_gdf(factors, tf.R2k(basis, (nc,)), nc, nlo,
                           tr_symm=tr_symm, device=CPU)
    assert tuple(g.shape) == (1, 4, 4, 4, 4) and g.dtype == torch.float64
    assert np.abs(g.numpy() - ref).max() < 1e-10
    mol = te.get_emb_eri_mol(torch.as_tensor(eri), basis)
    assert float(torch.abs(g - mol).max()) < 1e-10


def test_gdf_batches_transfers_of_unequal_rank():
    """Factors whose ranks differ between transfers (one truncated) go
    through separate batches and give the sum over transfers of the
    per-transfer results: 1e-12."""
    from libdmet_preview_tpu_torch.ops import eri_transform as te
    from libdmet_preview_tpu_torch.ops import fourier as tf
    nc, nlo, _ = hring()
    _, ft = hring_factors()
    cut = {q: (f[0][..., :-1], f[1][..., :-1]) if q == 1 else f
           for q, f in ft.items()}
    assert len({f[0].shape[-1] for f in cut.values()}) == 2
    bk = tf.R2k(np.random.RandomState(5).randn(1, nc, nlo, 3), (nc,))
    whole = te.get_emb_eri_gdf(cut, bk, nc, nlo, device=CPU)
    parts = sum(te.get_emb_eri_gdf({q: cut[q]}, bk, nc, nlo, device=CPU)
                for q in cut)
    assert float(torch.abs(whole - parts).max()) < 1e-12


def test_get_emb_eri_dispatch():
    """The df_type routing, inferred from the source's rank or named,
    agrees with the named routines; a (3, 3) array is refused; a cell
    object's own method is called for 'aft'."""
    from libdmet_preview_tpu_torch.ops import eri_transform as te
    from libdmet_preview_tpu_torch.ops import fourier as tf
    rng = np.random.RandomState(1)
    n, neo = 6, 4
    A = rng.randn(12, n, n)
    A = A + A.transpose(0, 2, 1)
    eri = np.einsum("xpq, xrs -> pqrs", A, A)
    L = te.cholesky_eri(eri, tol=1e-12)
    basis = rng.randn(1, 2, 3, neo)
    ref_c = te.get_emb_eri_chol(torch.as_tensor(L), basis)
    ref_m = te.get_emb_eri_mol(torch.as_tensor(eri), basis)
    assert torch.equal(te.get_emb_eri(L, basis, device=CPU), ref_c)
    assert torch.equal(te.get_emb_eri(eri, basis, device=CPU), ref_m)
    assert torch.equal(te.get_emb_eri(torch.as_tensor(L), basis,
                                      df_type="chol", device=CPU), ref_c)
    assert float(torch.abs(ref_c - ref_m).max()) < 1e-8
    with pytest.raises(ValueError):
        te.get_emb_eri(np.zeros((3, 3)), basis, device=CPU)
    with pytest.raises(ValueError):
        te.get_emb_eri(L, basis, df_type="nope", device=CPU)
    nc, nlo, _ = hring()
    _, ft = hring_factors()
    bk = tf.R2k(rng.randn(1, nc, nlo, neo), (nc,))
    assert torch.equal(
        te.get_emb_eri(ft, bk, ncells=nc, nlo=nlo, device=CPU),
        te.get_emb_eri_gdf(ft, bk, nc, nlo, device=CPU))

    class Cell:
        def get_emb_eri_aft(self, C, **kw):
            return ("aft", C.shape, kw)

        def get_emb_eri_rs(self, C, **kw):
            return ("rs", C.shape, kw)

    C = np.zeros((5, 2))
    assert te.get_emb_eri(Cell(), C, kmesh=3) == ("aft", (5, 2), {"kmesh": 3})
    assert te.get_emb_eri(Cell(), C, df_type="mdf")[0] == "rs"


def test_eri_7d_and_jk_match_jax_and_supercell():
    """eri_R_to_eri_7d and get_jk_from_eri_7d against the JAX package
    (1e-12) and J, K against the supercell brute force carried to k
    (1e-9), on the 4-cell model ERI."""
    from libdmet_preview_tpu.ops import pbc_helper as jp
    from libdmet_preview_tpu_torch.ops import pbc_helper as tp
    ncells, nlo = 4, 2
    eri = _trans_inv_eri(ncells, nlo)
    e7j = jp.eri_R_to_eri_7d(eri, ncells, nlo)
    e7t = tp.eri_R_to_eri_7d(eri, ncells, nlo, device=CPU)
    assert e7t.dtype == torch.complex128
    assert np.abs(e7t.numpy() - e7j).max() < 1e-12 * np.abs(e7j).max()
    _, dm_k, dm_full = _dm_k_from_stripe(ncells, nlo)
    vj, vk = tp.get_jk_from_eri_7d(e7t, dm_k, device=CPU)
    vjj, vkj = jp.get_jk_from_eri_7d(e7j, dm_k)
    assert np.abs(vj.numpy() - vjj).max() < 1e-12 * np.abs(vjj).max()
    assert np.abs(vk.numpy() - vkj).max() < 1e-12 * np.abs(vkj).max()
    vj_ref, vk_ref = _jk_supercell(eri, dm_full)
    assert np.abs(vj.numpy() - _full_to_k(vj_ref, ncells, nlo)).max() < 1e-9
    assert np.abs(vk.numpy() - _full_to_k(vk_ref, ncells, nlo)).max() < 1e-9


def test_jk_from_gdf_matches_jax_and_eri_7d():
    """get_jk_from_gdf (one batched K build over the transfers) against
    the JAX function on the same factors (1e-10) and against the 7d
    function (1e-8), two spins."""
    from libdmet_preview_tpu.ops import pbc_helper as jp
    from libdmet_preview_tpu_torch.ops import pbc_helper as tp
    ncells, nlo = 4, 2
    eri = _trans_inv_eri(ncells, nlo)
    fj = jp.eri_to_gdf(eri, ncells, nlo, tol=1e-12)
    _, dm_k, _ = _dm_k_from_stripe(ncells, nlo, spin=2, seed=9)
    vjj, vkj = jp.get_jk_from_gdf(fj, dm_k)
    vj, vk = tp.get_jk_from_gdf(fj, dm_k, device=CPU)
    assert tuple(vk.shape) == (2, ncells, nlo, nlo)
    assert np.abs(vj.numpy() - vjj).max() < 1e-10
    assert np.abs(vk.numpy() - vkj).max() < 1e-10
    ft = tp.eri_to_gdf(eri, ncells, nlo, tol=1e-12, device=CPU)
    e7 = tp.eri_R_to_eri_7d(eri, ncells, nlo, device=CPU)
    vj7, vk7 = tp.get_jk_from_eri_7d(e7, dm_k, device=CPU)
    vj2, vk2 = tp.get_jk_from_gdf(ft, torch.as_tensor(dm_k), device=CPU)
    assert float(torch.abs(vj2 - vj7).max()) < 1e-8
    assert float(torch.abs(vk2 - vk7).max()) < 1e-8


def test_cderi_npz_roundtrip_and_ingestion(tmp_path):
    """The CDERI archive as .npz: the port's factors written and read back
    (k-pair matching, segment concatenation, the complex s1 branch) are
    bit-identical and reproduce the brute-force embedding ERI; a
    gamma-only real factorization takes the real s2-packed branch."""
    from libdmet_preview_tpu_torch import interop
    from libdmet_preview_tpu_torch.ops import eri_transform as te
    from libdmet_preview_tpu_torch.ops import fourier as tf
    from libdmet_preview_tpu_torch.ops.cderi import read_cderi, write_cderi
    nc, nlo, eri = hring()
    _, ft = hring_factors()
    kpts_scaled = np.asarray([[0.0, 0.0, f] for f in np.fft.fftfreq(nc)])
    kpts = 2.0 * np.pi * kpts_scaled / 3.7        # arbitrary cell length
    fname = str(tmp_path / "cderi.npz")
    write_cderi(fname, ft, kpts, kpts_scaled, nlo)
    fac2 = read_cderi(fname, kpts, kpts_scaled, nlo)
    host = interop.gdf_factors_to_numpy(ft)
    for q in host:
        if q != 0:      # q = 0 holds the symmetrized gamma-like pair
            assert np.array_equal(fac2[q][0], host[q][0])
            assert np.array_equal(fac2[q][1], host[q][1])
        assert np.abs(fac2[q][0] - host[q][0]).max() < 1e-12
    basis = np.random.RandomState(11).randn(1, nc, nlo, 4)
    ref = te.get_emb_eri_mol(torch.as_tensor(eri), basis)
    g = te.get_emb_eri_gdf(fac2, tf.R2k(basis, (nc,)), nc, nlo, device=CPU)
    assert float(torch.abs(g - ref).max()) < 1e-9
    # the real s2 branch
    L0 = te.cholesky_eri(eri[:nlo, :nlo, :nlo, :nlo], tol=1e-12)
    fac_g = {0: (np.moveaxis(L0, 0, -1)[None],
                 np.zeros((1, nlo, nlo, L0.shape[0])))}
    kpts_g = np.zeros((1, 3))
    fname_g = str(tmp_path / "cderi_gamma.npz")
    write_cderi(fname_g, fac_g, kpts_g, kpts_g, nlo)
    with np.load(fname_g) as f:
        d = f["j3c/0/0"]
        assert not np.iscomplexobj(d) and d.shape[1] == nlo * (nlo + 1) // 2
        assert f["j3c-kptij"].shape == (1, 2, 3)
    Fr, Fi = read_cderi(fname_g, kpts_g, kpts_g, nlo)[0]
    assert np.array_equal(Fr, fac_g[0][0]) and not Fi.any()
    with pytest.raises(ValueError):
        read_cderi(fname_g, kpts_g + 0.1, kpts_g, nlo)
