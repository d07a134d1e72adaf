"""Impurity solvers."""

from libdmet_preview_tpu_torch.solvers.scf import SCF, SCFSolver  # noqa: F401
