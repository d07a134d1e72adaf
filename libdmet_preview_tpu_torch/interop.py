"""
Carry the JAX package's state into the port.

The JAX package keeps its lattice operators, vcor parameters and DF
factors as arrays that convert to NumPy; these functions take those NumPy
arrays and return the port's objects, so a workload built in one package
runs in the other on identical inputs.
"""

import numpy as np
import torch

from libdmet_preview_tpu_torch.models.abinitio import AbInitioHam
from libdmet_preview_tpu_torch.models.hamiltonian import HamNonInt
from libdmet_preview_tpu_torch.models.lattice import MeshLattice
from libdmet_preview_tpu_torch.ops.vcor import VcorLocal


def lattice_from_numpy(kmesh, nscsites, hcore_R, fock_R, ovlp_R=None,
                       val_idx=None, virt_idx=(), core_idx=(),
                       use_hcore_as_emb_ham=True):
    """A port LatticeModel on `kmesh` with `nscsites` orbitals per cell,
    carrying the stripe operators hcore_R / fock_R ((spin,) ncells, n, n)
    and the overlap ovlp_R (identity when None), with the given orbital
    partition (all orbitals valence when val_idx is None)."""
    lat = MeshLattice(kmesh, nscsites)
    hcore_R = np.asarray(hcore_R, dtype=float)
    ham = HamNonInt(lat, hcore_R, np.zeros((nscsites,) * 4),
                    Fock=np.asarray(fock_R, dtype=float))
    lat.set_Ham_model(ham, ovlp=None if ovlp_R is None
                      else np.asarray(ovlp_R, dtype=float),
                      use_hcore_as_emb_ham=use_hcore_as_emb_ham)
    if val_idx is None:
        val_idx = list(range(nscsites))
    lat.set_val_virt_core(list(val_idx), list(virt_idx), list(core_idx))
    return lat


def abinitio_lattice_from_numpy(kmesh, nscsites, hcore_R, fock_R, chol_L,
                                eri_imp, H0, rdm1_R=None, val_idx=None,
                                virt_idx=(), core_idx=(),
                                device=torch.device("cuda")):
    """A port ab initio lattice on `kmesh` with `nscsites` LOs per cell,
    holding an AbInitioHam built from the JAX lattice's arrays as NumPy:
    hcore_R / fock_R ((spin,) ncells, n, n) stripes, the Cholesky factors
    chol_L (naux, nsites, nsites; moved to `device` once), the unit-cell
    ERI eri_imp, the constant H0 per cell, the stored density rdm1_R
    ((spin,) ncells, n, n) and the orbital partition (all orbitals valence
    when val_idx is None).  The mean field and embedding run on
    `device`."""
    lat = MeshLattice(kmesh, nscsites)
    ham = AbInitioHam(np.asarray(hcore_R, dtype=float),
                      np.asarray(fock_R, dtype=float),
                      np.asarray(chol_L, dtype=np.float64),
                      np.asarray(eri_imp, dtype=float), float(H0))
    lat.set_Ham_abinitio(ham, rdm1=None if rdm1_R is None
                         else np.asarray(rdm1_R, dtype=float), device=device)
    if val_idx is None:
        val_idx = list(range(nscsites))
    lat.set_val_virt_core(list(val_idx), list(virt_idx), list(core_idx))
    return lat


def vcor_local_from_numpy(restricted, nscsites, param):
    """A port VcorLocal (non-Bogoliubov) holding the parameter vector
    `param` of the JAX package's VcorLocal with the same layout."""
    v = VcorLocal(restricted, False, nscsites)
    param = np.asarray(param, dtype=float)
    if param.shape != (v.length(),):
        raise ValueError("vcor param shape %s, expected (%d,)"
                         % (param.shape, v.length()))
    v.update(param)
    return v


def chol_from_numpy(L, device):
    """DF / Cholesky factors (naux, nsites, nsites) as a float64 tensor on
    `device`."""
    return torch.as_tensor(np.asarray(L, dtype=np.float64),
                           dtype=torch.float64, device=device)
