"""
libdmet_preview_tpu_torch: the PyTorch + CUDA port of the JAX package
libdmet_preview_tpu/.

The port keeps the JAX package's layout (models/, ops/, dmet/, utils/) and
function names.  It never imports jax or the JAX package.  Tensors are
float64 / complex128, passed explicitly; every entry point that makes
tensors from host data takes an explicit `device` (an ab initio lattice
keeps the one given to set_Ham_abinitio, and what runs on it follows).
Hand-written CUDA kernels live in csrc/ and are built with nvcc at first
use (ops/_build.py).
"""

__version__ = "0.1.0"

from libdmet_preview_tpu_torch import utils  # noqa: F401
from libdmet_preview_tpu_torch import models  # noqa: F401
from libdmet_preview_tpu_torch import ops  # noqa: F401
from libdmet_preview_tpu_torch import dmet  # noqa: F401
from libdmet_preview_tpu_torch import solvers  # noqa: F401
from libdmet_preview_tpu_torch import lo  # noqa: F401
from libdmet_preview_tpu_torch import ints  # noqa: F401
from libdmet_preview_tpu_torch import parallel  # noqa: F401
