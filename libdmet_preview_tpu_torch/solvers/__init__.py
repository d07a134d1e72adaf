"""Impurity solvers."""

from libdmet_preview_tpu_torch.solvers.scf import (SCF, SCFSolver,  # noqa: F401
                                                   GGHF, GGHF_mu, ao2mo_Ham,
                                                   restore_Ham)
from libdmet_preview_tpu_torch.solvers.fci import FCI  # noqa: F401
from libdmet_preview_tpu_torch.solvers.cc import (  # noqa: F401
    LCCSD, LCCD, CCSD_ITE, CCSD, CCD, MP2, BCCSD, TCCSD, RCCSD, UCCSD, GCCSD,
    UCCD, GCCD, UTCCSD, GTCCSD)
from libdmet_preview_tpu_torch.solvers.oo import OOMP2, OOCCD  # noqa: F401
from libdmet_preview_tpu_torch.solvers.casci import (  # noqa: F401
    CASCI, CASSCF, UCASCI, UCASSCF, GCASCI, GCASSCF, project_active_space)
from libdmet_preview_tpu_torch.solvers.ci_to_cc import (  # noqa: F401
    ci_to_cc_so)
from libdmet_preview_tpu_torch.solvers.dmrg import (  # noqa: F401
    BlockDMRG, Schedule)
from libdmet_preview_tpu_torch.solvers.external import (  # noqa: F401
    ExternalFCIDUMPSolver, Block2Solver, SHCISolver, AFQMCSolver, DQMCSolver)
from libdmet_preview_tpu_torch.solvers.gw import get_vsig_emb  # noqa: F401
from libdmet_preview_tpu_torch.solvers.ksdft import RKS, UKS  # noqa: F401
