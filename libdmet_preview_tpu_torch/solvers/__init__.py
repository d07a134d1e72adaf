"""Impurity solvers."""

from libdmet_preview_tpu_torch.solvers.scf import (SCF, SCFSolver,  # noqa: F401
                                                   ao2mo_Ham, restore_Ham)
from libdmet_preview_tpu_torch.solvers.fci import FCI  # noqa: F401
from libdmet_preview_tpu_torch.solvers.cc import (  # noqa: F401
    LCCSD, LCCD, CCSD_ITE, CCSD, CCD, MP2, BCCSD, TCCSD, RCCSD, UCCSD, GCCSD,
    UCCD, GCCD, UTCCSD, GTCCSD)
