"""
The PyTorch port's interacting-bath embedding Hamiltonian
(libdmet_preview_tpu_torch/dmet/hubbard.py ConstructImpHam ->
ops/embham.py) against the JAX package's on the AFM H ring
(tests/test_torch_mfd.py builds it), on the CPU.

The bath columns come out of an eigensolver and basis_matching rotates
them by an SVD, so each package may pick another gauge.  The comparisons
are of gauge-free quantities: the per-spin bath projector B B^T, the
spectrum of each spin's H1, and the aa/bb/ab H2 blocks carried into the
JAX basis by O_s = B_s,jax^T B_s,port.
"""

import numpy as np
import torch

from test_torch_mfd import CPU, both_hf

torch.set_num_threads(1)


def both_imp_ham():
    """Unrestricted HF on both lattices, its density stored on each
    lattice (as make_cuo2_afm_lattice stores its UHF density), then
    ConstructImpHam(int_bath=True, matching=True) in both packages."""
    import libdmet_preview_tpu.dmet.hubbard as jdmet
    import libdmet_preview_tpu_torch.dmet.hubbard as tdmet
    (Lat, vcor, (rho, _, _, _)), (lat_t, vcor_t, (rho_t, _, _, _)) = \
        both_hf(restricted=False)
    Lat.set_Ham_abinitio(Lat.Ham, rdm1=rho)
    lat_t.set_Ham_abinitio(lat_t.Ham, rdm1=rho_t, device=CPU)
    jax_out = jdmet.ConstructImpHam(Lat, rho, vcor, matching=True,
                                    int_bath=True)
    port_out = tdmet.ConstructImpHam(lat_t, rho_t, vcor_t, matching=True,
                                     int_bath=True)
    return (Lat, vcor, rho) + tuple(jax_out), \
        (lat_t, vcor_t, rho_t) + tuple(port_out)


def _flat(basis):
    return np.asarray(basis).reshape(2, -1, np.shape(basis)[-1])


def test_construct_imp_ham_matches_jax():
    (_, _, _, ImpHam, _, basis), (_, _, _, ImpHam_t, _, basis_t) = \
        both_imp_ham()
    B, Bt = _flat(basis), _flat(basis_t.numpy())
    assert B.shape == Bt.shape == (2, 6, 4)
    P = np.einsum("spi, sqi -> spq", B, B)
    Pt = np.einsum("spi, sqi -> spq", Bt, Bt)
    assert np.abs(Pt - P).max() < 1e-10
    H1 = np.asarray(ImpHam.H1["cd"])
    H1t = ImpHam_t.H1["cd"].numpy()
    assert np.abs(np.linalg.eigvalsh(H1t) - np.linalg.eigvalsh(H1)).max() \
        < 1e-10
    O = np.einsum("spi, spj -> sij", B, Bt)
    H2 = np.asarray(ImpHam.H2["ccdd"])
    H2t = ImpHam_t.H2["ccdd"].numpy()
    assert H2t.shape == H2.shape == (3, 4, 4, 4, 4)
    for m, (a, b) in enumerate([(0, 0), (1, 1), (0, 1)]):
        mapped = np.einsum("ip, jq, kr, ls, pqrs -> ijkl",
                           O[a], O[a], O[b], O[b], H2t[m])
        assert np.abs(mapped - H2[m]).max() / np.abs(H2[m]).max() < 1e-10
    # the spin-split bases make ab differ from aa
    assert np.abs(H2[2] - H2[0]).max() > 1e-3


def test_bath_vectors_exact_svd_rule():
    """A rank-deficient env-imp block takes the exact-SVD branch: the
    port's singular values match NumPy's SVD, including the zero."""
    from libdmet_preview_tpu_torch.ops import embham
    rng = np.random.RandomState(2)
    A = rng.randn(2, 9, 3)
    A[1, :, 2] = A[1, :, 0]          # rank 2 in the beta channel
    u, sigma = embham._bath_vectors(torch.as_tensor(A))
    ref = np.linalg.svd(A, compute_uv=False)
    assert np.abs(sigma.numpy() - ref).max() < 1e-12
    g = u[0].T @ u[0]
    assert torch.max(torch.abs(g - torch.eye(3, dtype=g.dtype))) < 1e-12
