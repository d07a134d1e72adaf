"""
The PyTorch port's lattice mean field (libdmet_preview_tpu_torch/ops/
mfd.py) against the JAX package's (libdmet_preview_tpu/ops/mfd.py) on the
3-cell, 2-atom H ring (sto-6g) of the JAX package's ab initio builder,
carried across with interop.abinitio_lattice_from_numpy, on the CPU.

The AFM case adds a staggered on-site field of opposite sign per spin
(VcorLocal(False, False, nlo)), so the alpha and beta densities differ.
The helpers here build that workload for the other ab initio parity
tests too.
"""

from functools import lru_cache

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

CPU = torch.device("cpu")
FILLING = 0.5
DELTA = 0.3


@lru_cache(maxsize=1)
def jax_ring():
    from libdmet_preview_tpu.models.abinitio import make_h_ring_lattice
    Lat, _ = make_h_ring_lattice(ncells=3, atoms_per_cell=2, r_bond=1.8,
                                 basis="sto-6g")
    return Lat


def afm_vcor(vcor_cls, nlo, restricted=False):
    """Staggered +-DELTA on the two atoms of a cell, opposite per spin
    (unrestricted), or a uniform shift (restricted)."""
    v = vcor_cls(restricted, False, nlo)
    stag = np.diag([DELTA if i % 2 == 0 else -DELTA for i in range(nlo)])
    if restricted:
        v.assign(np.asarray([np.eye(nlo) * DELTA] * 2))
    else:
        v.assign(np.asarray([stag, -stag]))
    return v


def port_lattice(Lat, device=CPU):
    """The JAX lattice's arrays in a port ab initio lattice on `device`."""
    from libdmet_preview_tpu_torch import interop
    return interop.abinitio_lattice_from_numpy(
        Lat.kmesh, Lat.nscsites, Lat.hcore_lo_R, Lat.fock_lo_R,
        np.array(Lat.Ham.getH2()), Lat.Ham.eri_imp, Lat.Ham.H0,
        rdm1_R=Lat.rdm1_lo_R, val_idx=Lat.val_idx, virt_idx=Lat.virt_idx,
        core_idx=Lat.core_idx, device=device)


def both_hf(restricted):
    """(JAX lattice, vcor, HF result), (port lattice, vcor, HF result)."""
    from libdmet_preview_tpu.ops import mfd as jmfd
    from libdmet_preview_tpu.ops.vcor import VcorLocal
    from libdmet_preview_tpu_torch import interop
    from libdmet_preview_tpu_torch.ops import mfd as tmfd
    Lat = jax_ring()
    vcor = afm_vcor(VcorLocal, Lat.nscsites, restricted)
    lat_t = port_lattice(Lat)
    vcor_t = interop.vcor_local_from_numpy(restricted, Lat.nscsites,
                                           vcor.param)
    out_j = jmfd.HF(Lat, vcor, FILLING, restricted, ires=True)
    out_t = tmfd.HF(lat_t, vcor_t, FILLING, restricted, ires=True)
    return (Lat, vcor, out_j), (lat_t, vcor_t, out_t)


@pytest.mark.parametrize("restricted", [True, False])
def test_hf_matches_jax(restricted):
    """rho_R, mu, E and the doubled spectrum res["e"]: 1e-10."""
    (_, _, (rho, mu, E, res)), (_, _, (rho_t, mu_t, E_t, res_t)) = \
        both_hf(restricted)
    assert rho_t.shape == rho.shape == ((1 if restricted else 2), 3, 2, 2)
    assert np.abs(rho_t - rho).max() < 1e-10
    assert abs(float(mu_t) - float(mu)) < 1e-10
    assert abs(E_t - E) < 1e-10
    assert res_t["e"].shape == res["e"].shape
    assert np.abs(res_t["e"] - res["e"]).max() < 1e-10
    if not restricted:
        # the field splits the spins
        assert np.abs(rho[0] - rho[1]).max() > 1e-2


def test_zeigh_doubled_spectrum_and_density():
    """zeigh returns each level twice in ascending order, and
    zfunc_from_eig rebuilds the matrix from the doubled values."""
    from libdmet_preview_tpu_torch.ops import zlinalg
    rng = np.random.RandomState(0)
    a = rng.randn(2, 5, 5) + 1j * rng.randn(2, 5, 5)
    h = a + a.conj().transpose(0, 2, 1)
    w2, V = zlinalg.zeigh(torch.as_tensor(h.real), torch.as_tensor(h.imag))
    w = np.linalg.eigvalsh(h)
    assert np.abs(w2.numpy() - np.repeat(w, 2, axis=-1)).max() < 1e-12
    re, im = zlinalg.zfunc_from_eig(V, w2)
    assert np.abs(re.numpy() + 1j * im.numpy() - h).max() < 1e-12
