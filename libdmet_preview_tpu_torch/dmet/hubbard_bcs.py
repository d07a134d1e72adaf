"""
BCS / Hartree-Fock-Bogoliubov DMET facade (PyTorch port of
libdmet_preview_tpu/dmet/hubbard_bcs.py).

The HFB / BdG problem is a GHF problem in the particle-hole transformed
(GSO) frame: the pairing Delta a^dag b^dag becomes the number-conserving
one-body block [[v_a, D], [D^T, -v_b^T]].  So this facade drives the
spinless machinery (ops/spinless.py) with a Bogoliubov vcor, and the
embedded problem is a number-conserving FCI / CC solve.
"""

import numpy as np

from libdmet_preview_tpu_torch.ops import spinless
from libdmet_preview_tpu_torch.ops.vcor import VcorLocal
from libdmet_preview_tpu_torch.dmet.hubbard_gso import (  # noqa: F401
    GSOHam, GHartreeFock, ConstructImpHam, SolveImpHam_with_fitting,
    transformResults, copy_integral, apply_dmu)
from libdmet_preview_tpu_torch.models.lattice import (  # noqa: F401
    ChainLattice, SquareLattice, CubicLattice)
from libdmet_preview_tpu_torch.models.hamiltonian import (  # noqa: F401
    HubbardHamiltonian as Ham)

extractRdm = spinless.extract_rdm


def HartreeFockBogoliubov(gham, vcor, filling, mu0=0.0, beta=np.inf,
                          **kwargs):
    """HFB mean field: GHF of the transformed frame with the Bogoliubov
    vcor combined into the GSO one-body.  Returns (GRho_R, mu, res);
    extract (rho_A, rho_B, kappa) with extractRdm(GRho_R[0])."""
    vmat = spinless.combine_vcor(np.asarray(vcor.get()))
    return GHartreeFock(gham, filling, mu0=mu0, vcor_mat=vmat, beta=beta,
                        **kwargs)


def VcorSC(nao, restricted=True):
    """Local Bogoliubov vcor [v, v, D]: full symmetric pairing block
    (s-wave onsite AND bond-wise d-wave structures)."""
    return VcorLocal(restricted, True, nao)


def FitVcor(GRhoEmb, lattice, basis, vcor, gham, mu, MaxIter=300,
            **kwargs):
    return spinless.FitVcorGSOEmb(GRhoEmb, lattice, basis, vcor,
                                  gham.GH1_k, mu, MaxIter=MaxIter, **kwargs)
