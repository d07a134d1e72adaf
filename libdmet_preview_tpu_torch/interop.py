"""
Carry the JAX package's state into the port.

The JAX package keeps its lattice operators, vcor parameters, DF factors,
embedding Hamiltonians and loop settings as arrays and plain values that
convert to NumPy; these functions take those and return the port's
objects, so a workload built in one package runs in the other on identical
inputs.
"""

import dataclasses

import numpy as np
import torch

from libdmet_preview_tpu_torch.models.abinitio import AbInitioHam
from libdmet_preview_tpu_torch.models.hamiltonian import HamNonInt
from libdmet_preview_tpu_torch.models.integral import Integral
from libdmet_preview_tpu_torch.models.lattice import MeshLattice
from libdmet_preview_tpu_torch.ops.vcor import VcorLocal, VcorNonLocal
from libdmet_preview_tpu_torch.utils.config import DmetConfig
from libdmet_preview_tpu_torch.utils.misc import as_f64


def lattice_from_numpy(kmesh, nscsites, hcore_R, fock_R, ovlp_R=None,
                       val_idx=None, virt_idx=(), core_idx=(),
                       use_hcore_as_emb_ham=True, H2=None, rdm1_R=None,
                       spin_dim_H2=None, device=torch.device("cuda")):
    """A port model LatticeModel on `kmesh` with `nscsites` orbitals per
    cell, carrying the stripe operators hcore_R / fock_R ((spin,) ncells,
    n, n; the Fock and density as they stand after the JAX lattice's
    update_Ham), the overlap ovlp_R (identity when None), the two-body
    term H2 (zero when None) and the stored density rdm1_R, with the given
    orbital partition (all orbitals valence when val_idx is None).  H2's
    format follows its shape: 'local' (n,)*4, 'nearest' (ncells, n^4),
    'full' (ncells^3, n^4), or with spin_dim_H2 'spin local'
    (spin_dim_H2, n^4).  The mean field and embedding run on `device`."""
    lat = MeshLattice(kmesh, nscsites)
    hcore_R = np.asarray(hcore_R, dtype=float)
    H2 = np.zeros((nscsites,) * 4) if H2 is None \
        else np.asarray(H2, dtype=float)
    ham = HamNonInt(lat, hcore_R, H2, Fock=np.asarray(fock_R, dtype=float),
                    spin_dim_H2=spin_dim_H2)
    lat.set_Ham_model(ham, ovlp=None if ovlp_R is None
                      else np.asarray(ovlp_R, dtype=float),
                      rdm1=None if rdm1_R is None
                      else np.asarray(rdm1_R, dtype=float),
                      use_hcore_as_emb_ham=use_hcore_as_emb_ham,
                      device=device)
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


def vcor_local_from_numpy(restricted, nscsites, param, bogoliubov=False,
                          bogo_res=False):
    """A port VcorLocal holding the parameter vector `param` of the JAX
    package's VcorLocal with the same layout (bogoliubov / bogo_res as
    given there: the GSO path's Bogoliubov vcor, hubbard_bcs.VcorSC)."""
    v = VcorLocal(restricted, bogoliubov, nscsites, bogo_res=bogo_res)
    param = np.asarray(param, dtype=float)
    if param.shape != (v.length(),):
        raise ValueError("vcor param shape %s, expected (%d,)"
                         % (param.shape, v.length()))
    v.update(param)
    return v


def vcor_nonlocal_from_numpy(restricted, lattice, param, rcells=None):
    """A port VcorNonLocal on the port lattice `lattice` holding the
    parameter vector `param` and the cell list `rcells` of the JAX
    package's VcorNonLocal (same layout)."""
    v = VcorNonLocal(restricted, False, lattice, rcells=rcells)
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


def integral_from_numpy(norb, restricted, H0, H1, H2, device, ovlp=None):
    """A port Integral holding an embedding Hamiltonian of the JAX
    package as float64 tensors on `device`: H1 (spin, n, n), H2
    (spin_pair, n, n, n, n) in the block order [aa, bb, ab].  The blocks
    are copies: apply_dmu works in place on them."""
    def copy(x):
        return as_f64(np.array(x, dtype=np.float64), device)

    return Integral(int(norb), bool(restricted), False, float(H0),
                    {"cd": copy(H1)}, {"ccdd": copy(H2)},
                    ovlp=None if ovlp is None else copy(ovlp))


def gdf_factors_from_numpy(factors, device):
    """The JAX package's per-transfer GDF factors {q: (F_re, F_im)} (F
    shaped (ncells, nlo, nlo, naux_q)) as float64 tensors on `device`, in
    the same dict layout."""
    return {int(q): (as_f64(np.asarray(f[0]), device),
                     as_f64(np.asarray(f[1]), device))
            for q, f in factors.items()}


def gdf_factors_to_numpy(factors):
    """The port's GDF factors back as the {q: (F_re, F_im)} dict of NumPy
    arrays that the JAX package and ops.cderi take."""
    return {int(q): tuple(x.detach().cpu().numpy() if
                          isinstance(x, torch.Tensor) else np.asarray(x)
                          for x in f)
            for q, f in factors.items()}


def cc_amplitudes_from_numpy(t1, t2, device):
    """Coupled-cluster amplitudes of the JAX package (t1 (nocc, nvir), t2
    (nocc, nocc, nvir, nvir), spin-orbital order [occ_a, occ_b, vir_a,
    vir_b]) as float64 tensors on `device`, for solvers.cc._residual and
    _solve_adjoint."""
    return (as_f64(np.asarray(t1, dtype=np.float64), device),
            as_f64(np.asarray(t2, dtype=np.float64), device))


def dmet_config_from_dict(settings):
    """A port DmetConfig from the fields of the JAX package's DmetConfig
    (dataclasses.asdict of it); unknown fields raise."""
    known = {f.name for f in dataclasses.fields(DmetConfig)}
    unknown = set(settings) - known
    if unknown:
        raise ValueError("DmetConfig has no field(s) %s" % sorted(unknown))
    return DmetConfig(**settings)
