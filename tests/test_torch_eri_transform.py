"""
The PyTorch port's embedding-ERI transform
(libdmet_preview_tpu_torch/ops/eri_transform.py) against the JAX package's
(libdmet_preview_tpu/ops/eri_transform.py) on the same Cholesky factors
and bases, on the CPU, where the port's syrk runs its plain version.
"""

from functools import lru_cache

import numpy as np
import pytest
import torch

torch.set_num_threads(1)


def _rel(a, b):
    return np.abs(a - b).max() / np.abs(b).max()


@lru_cache(maxsize=1)
def _ring_eri():
    """The LO ERI of the 3-cell, 2-atom H ring (sto-6g) and its Cholesky
    factors from the JAX package's lattice builder."""
    from libdmet_preview_tpu.models.abinitio import make_h_ring_lattice
    Lat, meta = make_h_ring_lattice(ncells=3, atoms_per_cell=2,
                                    r_bond=1.8, basis="sto-6g")
    return Lat, np.array(meta["eri_lo"]), np.array(Lat.Ham.getH2())


def test_cholesky_eri_matches_jax():
    """The host pivoted Cholesky is the same NumPy code: exact."""
    from libdmet_preview_tpu.ops import eri_transform as jet
    from libdmet_preview_tpu_torch.ops import eri_transform as tet
    _, eri, _ = _ring_eri()
    np.testing.assert_array_equal(tet.cholesky_eri(eri, tol=1e-10),
                                  jet.cholesky_eri(eri, tol=1e-10))


@pytest.mark.parametrize("spin", [1, 2])
def test_get_emb_eri_chol_matches_jax(spin):
    """aa (and bb, ab for spin 2) blocks from the same factors and a
    random basis; 1e-12 relative.  The spin-2 bases differ, so ab is
    neither aa nor symmetric."""
    from libdmet_preview_tpu.ops import eri_transform as jet
    from libdmet_preview_tpu_torch.ops import eri_transform as tet
    Lat, _, L = _ring_eri()
    rng = np.random.RandomState(spin)
    basis = rng.randn(spin, Lat.ncells, Lat.nscsites, 5)
    ref = jet.get_emb_eri_chol(L, basis)
    out = tet.get_emb_eri_chol(torch.as_tensor(L), basis).numpy()
    assert out.shape == ref.shape == (2 * spin - 1,) + (5,) * 4
    assert _rel(out, ref) < 1e-12
    if spin == 2:
        ab = out[2].reshape(25, 25)
        assert np.abs(ab - ab.T).max() > 1e-6
        assert np.abs(out[2] - out[0]).max() > 1e-6


def test_get_emb_eri_chol_matches_dense_transform():
    """Port chol path vs the port's dense oracle get_emb_eri_mol on the
    ring's exact ERI (Cholesky at tol 1e-10): 1e-10 relative."""
    from libdmet_preview_tpu_torch.ops import eri_transform as tet
    Lat, eri, L = _ring_eri()
    rng = np.random.RandomState(7)
    basis = rng.randn(2, Lat.ncells, Lat.nscsites, 4) * 0.5
    out = tet.get_emb_eri_chol(torch.as_tensor(L), basis).numpy()
    ref = tet.get_emb_eri_mol(torch.as_tensor(eri), basis).numpy()
    assert _rel(out, ref) < 1e-10


def test_get_emb_eri_chol_stages():
    """While utils.timer records, the spin-2 transform reports one
    rotation, one pack, two symmetric syrks, one cross syrk and three
    unpacks; outside a recording nothing is kept."""
    from libdmet_preview_tpu_torch.ops import eri_transform as tet
    from libdmet_preview_tpu_torch.utils import timer
    Lat, _, L = _ring_eri()
    basis = np.random.RandomState(3).randn(2, Lat.ncells, Lat.nscsites, 4)
    with timer.recording() as sec:
        tet.get_emb_eri_chol(torch.as_tensor(L), basis)
    counts = {k: len(v) for k, v in sec.items()}
    assert counts == {"ERI rotation": 1, "ERI pack": 1,
                      "syrk (tri kernel)": 2, "syrk ab (cross kernel)": 1,
                      "ERI unpack": 3}
    assert all(t >= 0.0 for v in sec.values() for t in v)
    tet.get_emb_eri_chol(torch.as_tensor(L), basis)
    assert sum(len(v) for v in sec.values()) == 8
    assert timer._rec is None


def test_set_Ham_abinitio_keeps_the_factors_on_the_lattice():
    """set_Ham_abinitio copies the factors to the lattice's device and
    leaves the Hamiltonian object as it was."""
    from libdmet_preview_tpu_torch.models.abinitio import AbInitioHam
    from libdmet_preview_tpu_torch.models.lattice import ChainLattice
    ncells, nlo = 3, 2
    rng = np.random.RandomState(4)
    h = rng.randn(ncells, nlo, nlo)
    L = rng.randn(5, ncells * nlo, ncells * nlo).astype(np.float32)
    Ham = AbInitioHam(h, h, L, None, 0.0)
    Lat = ChainLattice(ncells * nlo, nlo)
    Lat.set_Ham_abinitio(Ham, device="cpu")
    assert Ham.chol_L is L and Ham.getH2().dtype == np.float32
    got = Lat.getH2()
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), L.astype(np.float64))
    Lat.set_Ham_abinitio(Ham, rdm1=None, device="cpu")
    assert Lat.getH2() is got
