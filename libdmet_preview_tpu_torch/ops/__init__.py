"""Tensor operators, fit engines, kernels and the fused iteration.  No
module here builds a kernel at import: ops._build compiles csrc/ at the
first launch on a CUDA tensor."""

from libdmet_preview_tpu_torch.ops import fourier  # noqa: F401
from libdmet_preview_tpu_torch.ops import zlinalg  # noqa: F401
from libdmet_preview_tpu_torch.ops import mfd  # noqa: F401
from libdmet_preview_tpu_torch.ops import embham  # noqa: F401
from libdmet_preview_tpu_torch.ops import eri_transform  # noqa: F401
from libdmet_preview_tpu_torch.ops import fit  # noqa: F401
from libdmet_preview_tpu_torch.ops import ftsystem  # noqa: F401
from libdmet_preview_tpu_torch.ops import vcor  # noqa: F401
from libdmet_preview_tpu_torch.ops import diis  # noqa: F401
from libdmet_preview_tpu_torch.ops import spinless  # noqa: F401
