"""Host utilities: logging, helpers, analysis, checkpoints, settings,
profiling, structure I/O, extrapolation and DCA coarse graining (the JAX
package's utils/__init__ exports)."""

from libdmet_preview_tpu_torch.utils import logger  # noqa: F401
from libdmet_preview_tpu_torch.utils.misc import (  # noqa: F401
    max_abs, mdot, add_spin_dim, Iterable, pack_tril, unpack_tril,
    tril_diag_indices, triu_diag_indices, format_idx,
)
from libdmet_preview_tpu_torch.utils import analysis  # noqa: F401
from libdmet_preview_tpu_torch.utils import chkfile  # noqa: F401
from libdmet_preview_tpu_torch.utils import config  # noqa: F401
from libdmet_preview_tpu_torch.utils import profile  # noqa: F401
from libdmet_preview_tpu_torch.utils import iotools  # noqa: F401
from libdmet_preview_tpu_torch.utils import extrapolate  # noqa: F401
from libdmet_preview_tpu_torch.utils import dca  # noqa: F401
