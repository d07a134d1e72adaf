"""
The PyTorch port's embedding Hamiltonian on model lattices
(libdmet_preview_tpu_torch/ops/embham.py: transform_eri_local, unit2emb,
the 'local' H2 with both baths and the non-interacting-bath H1;
models/lattice.py update_Ham) against the JAX package's on the CPU.

The bath columns come out of an eigensolver, so each package may pick
another gauge.  ConstructImpHam is compared through gauge-free
quantities: the per-spin bath projector B B^T, the spectrum of each
spin's H1, and the H2 blocks carried into the JAX basis by
O_s = B_s,jax^T B_s,port.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

CPU = torch.device("cpu")
U, FILLING = 4.0, 0.5


def both_lattices(kind, use_hcore=True):
    """((JAX lattice, vcor), (port lattice, vcor)) built natively."""
    import libdmet_preview_tpu.dmet.hubbard as jdmet
    import libdmet_preview_tpu_torch.dmet.hubbard as tdmet
    out = []
    for dmet, kw in ((jdmet, {}), (tdmet, {"device": CPU})):
        if kind == "chain":
            Lat = dmet.ChainLattice(18, 2)
            vcor = dmet.PMInitGuess([2], U, FILLING)
        else:
            Lat = dmet.SquareLattice(8, 8, 2, 2)
            vcor = dmet.AFInitGuess((2, 2), U, FILLING)
        Lat.set_Ham(dmet.Ham(Lat, U), use_hcore_as_emb_ham=use_hcore, **kw)
        out.append((Lat, vcor))
    return out


def test_square_lattice_matches_jax():
    """SquareLattice geometry, the Hubbard stripe and its k-space pair:
    exactly equal."""
    (Lat, _), (lat_t, _) = both_lattices("square")
    assert lat_t.ncells == Lat.ncells == 16 and lat_t.nscsites == 4
    assert np.array_equal(lat_t.sites, Lat.sites)
    assert np.array_equal(lat_t.hcore_lo_R, Lat.hcore_lo_R)
    for a, b in zip(lat_t.hcore_lo_k, Lat.hcore_lo_k):
        assert np.abs(a - np.asarray(b)).max() < 1e-13
    assert lat_t.device == CPU


def test_square_afm_matches_jax():
    """SquareAFM (the rotated two-site cell): sites, cells and the
    Hubbard stripe exactly equal."""
    import libdmet_preview_tpu.dmet.hubbard as jdmet
    import libdmet_preview_tpu_torch.dmet.hubbard as tdmet
    Lat, lat_t = jdmet.SquareAFM(4, 4, 1, 1), tdmet.SquareAFM(4, 4, 1, 1)
    assert lat_t.nscsites == Lat.nscsites == 2
    assert np.array_equal(lat_t.sites, Lat.sites)
    assert np.array_equal(lat_t.cells, Lat.cells)
    assert np.array_equal(tdmet.Ham(lat_t, U).getH1(),
                          jdmet.Ham(Lat, U).getH1())


def test_set_ham_defaults_to_the_card():
    """set_Ham without a device records the card, and the mean field then
    raises on a machine without one instead of running on the CPU."""
    import libdmet_preview_tpu_torch.dmet.hubbard as tdmet
    Lat = tdmet.ChainLattice(6, 2)
    Lat.set_Ham(tdmet.Ham(Lat, U))
    assert Lat.device == torch.device("cuda")
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            tdmet.HartreeFock(Lat, tdmet.PMInitGuess([2], U, FILLING),
                              FILLING)


@pytest.mark.parametrize("spin", [1, 2])
def test_transform_eri_local_and_unit2emb_match_jax(spin):
    """Random basis and a random local ERI (one block, and three
    spin-blocked ones): 1e-12; unit2emb exact."""
    import jax.numpy as jnp
    from libdmet_preview_tpu.ops import embham as jembham
    from libdmet_preview_tpu_torch.ops import embham as tembham
    rng = np.random.RandomState(spin)
    basis = rng.randn(spin, 5, 3, 6)
    for H2 in (rng.randn(3, 3, 3, 3), rng.randn(3, 3, 3, 3, 3)):
        ref = np.asarray(jembham.transform_eri_local(jnp.asarray(basis),
                                                     jnp.asarray(H2)))
        out = tembham.transform_eri_local(torch.as_tensor(basis),
                                          torch.as_tensor(H2))
        assert out.shape == ref.shape == (spin * (spin + 1) // 2,) + (6,) * 4
        assert np.abs(out.numpy() - ref).max() < 1e-12
    unit = rng.randn(3, 2, 2, 2, 2)
    assert np.array_equal(tembham.unit2emb(torch.as_tensor(unit), 5).numpy(),
                          jembham.unit2emb(unit, 5))


def _compare_imp_ham(jax_out, port_out, spin, tol=1e-10):
    ImpHam, _, basis = jax_out
    ImpHam_t, _, basis_t = port_out
    nb = np.shape(basis)[-1]
    B = np.asarray(basis).reshape(spin, -1, nb)
    Bt = basis_t.numpy().reshape(spin, -1, nb)
    assert Bt.shape == B.shape
    assert np.abs(np.einsum("spi, sqi -> spq", Bt, Bt)
                  - np.einsum("spi, sqi -> spq", B, B)).max() < tol
    H1, H1t = np.asarray(ImpHam.H1["cd"]), ImpHam_t.H1["cd"].numpy()
    assert H1t.shape == H1.shape
    assert np.abs(np.linalg.eigvalsh(H1t) - np.linalg.eigvalsh(H1)).max() < tol
    O = np.einsum("spi, spj -> sij", B, Bt)
    H2, H2t = np.asarray(ImpHam.H2["ccdd"]), ImpHam_t.H2["ccdd"].numpy()
    assert H2t.shape == H2.shape
    pairs = [(0, 0)] if spin == 1 else [(0, 0), (1, 1), (0, 1)]
    for m, (a, b) in enumerate(pairs):
        mapped = np.einsum("ip, jq, kr, ls, pqrs -> ijkl",
                           O[a], O[a], O[b], O[b], H2t[m])
        assert np.abs(mapped - H2[m]).max() < tol
    assert abs(float(ImpHam_t.H0) - float(ImpHam.H0)) < 1e-14


@pytest.mark.parametrize("kind,int_bath,use_hcore", [
    ("chain", False, True), ("chain", True, True),
    ("square", False, True), ("square", True, True),
    ("square", False, False)])
def test_construct_imp_ham_model_matches_jax(kind, int_bath, use_hcore):
    """NIB and IB ConstructImpHam on the chain (restricted) and the 8x8
    square (AF, unrestricted), after update_Ham for the interacting bath;
    the last case is the non-interacting bath on the updated Fock
    (use_hcore_as_emb_ham=False, JK from the folded density): 1e-10."""
    import libdmet_preview_tpu.dmet.hubbard as jdmet
    import libdmet_preview_tpu_torch.dmet.hubbard as tdmet
    (Lat, vcor), (lat_t, vcor_t) = both_lattices(kind, use_hcore)
    spin = 1 if vcor.restricted else 2
    outs = []
    for dmet, L, v in ((jdmet, Lat, vcor), (tdmet, lat_t, vcor_t)):
        rho, mu = dmet.HartreeFock(L, v, FILLING, U * FILLING)
        if int_bath or not use_hcore:
            L.update_Ham(np.asarray(rho) * (2.0 if spin == 1 else 1.0))
        outs.append(dmet.ConstructImpHam(L, rho, v, matching=False,
                                         int_bath=int_bath))
    assert np.abs(lat_t.fock_lo_R - Lat.fock_lo_R).max() < 1e-12
    _compare_imp_ham(outs[0], outs[1], spin)
    if int_bath or not use_hcore:
        assert np.abs(lat_t.JK_core.numpy()).max() > 1e-3
    else:
        assert lat_t.JK_core is None and Lat.JK_core is None


@pytest.mark.parametrize("spin", [1, 2])
def test_update_ham_fock_matches_jax(spin):
    """update_Ham from a seeded random density: Fock stripe and its
    k-space pair 1e-12; a format that update_Ham does not know fails its
    check (the 'nearest' format is held in test_torch_models_extra.py)."""
    (Lat, _), (lat_t, _) = both_lattices("square")
    rng = np.random.RandomState(9)
    rdm1 = rng.rand(spin, Lat.ncells, 4, 4)
    Lat.update_Ham(rdm1)
    lat_t.update_Ham(rdm1)
    assert lat_t.fock_lo_R.shape == Lat.fock_lo_R.shape
    assert np.abs(lat_t.fock_lo_R - Lat.fock_lo_R).max() < 1e-12
    for a, b in zip(lat_t.fock_lo_k, Lat.fock_lo_k):
        assert np.abs(a - np.asarray(b)).max() < 1e-12
    assert np.abs(lat_t.fock_lo_R - lat_t.hcore_lo_R).max() > 1e-2
    lat_t.H2_format = "full"
    with pytest.raises(AssertionError, match="local and nearest"):
        lat_t.update_Ham(rdm1)
