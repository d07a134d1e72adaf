"""Orbital localization (the port has SCDM; the rest of the JAX package's
lo/ is still to port)."""

from libdmet_preview_tpu_torch.lo.scdm import scdm  # noqa: F401
