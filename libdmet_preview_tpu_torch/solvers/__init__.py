"""Impurity solvers."""

from libdmet_preview_tpu_torch.solvers.scf import SCF, SCFSolver  # noqa: F401
from libdmet_preview_tpu_torch.solvers.fci import FCI  # noqa: F401
