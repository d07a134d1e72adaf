"""
Carry the JAX package's state into the port.

The JAX package keeps its lattice operators, vcor parameters and DF
factors as arrays that convert to NumPy; these functions take those NumPy
arrays and return the port's objects, so a workload built in one package
runs in the other on identical inputs.
"""

import numpy as np
import torch

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
