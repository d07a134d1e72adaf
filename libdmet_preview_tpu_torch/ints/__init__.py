"""Gaussian integral engine (port of libdmet_preview_tpu/ints/): the
s-shell engine gto with its native C++ core, the general-l
McMurchie-Davidson engine md, the Becke grid and AO values on the device,
the XC functionals with autograd potentials, the periodic cell pbc (G-space
work on the device, the native short-range core on the host), the GTH
pseudopotentials gth and the generated valence bases basisopt."""

from libdmet_preview_tpu_torch.ints import gto  # noqa: F401
from libdmet_preview_tpu_torch.ints import md  # noqa: F401
from libdmet_preview_tpu_torch.ints import native  # noqa: F401
from libdmet_preview_tpu_torch.ints import grid  # noqa: F401
from libdmet_preview_tpu_torch.ints import xc  # noqa: F401
from libdmet_preview_tpu_torch.ints import gth  # noqa: F401
from libdmet_preview_tpu_torch.ints import pbc  # noqa: F401
from libdmet_preview_tpu_torch.ints import basisopt  # noqa: F401
