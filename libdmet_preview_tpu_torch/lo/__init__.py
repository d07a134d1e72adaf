"""Orbital localization (PyTorch port of libdmet_preview_tpu/lo/)."""

from libdmet_preview_tpu_torch.lo.lowdin import (  # noqa: F401
    lowdin_orth, vec_lowdin, check_orthonormal)
from libdmet_preview_tpu_torch.lo.iao import get_iao, get_iao_virt  # noqa: F401
from libdmet_preview_tpu_torch.lo.scdm import scdm  # noqa: F401
from libdmet_preview_tpu_torch.lo.localize import (  # noqa: F401
    localize_pm, localize_er)
from libdmet_preview_tpu_torch.lo.mo_match import (  # noqa: F401
    find_closest_mo, get_mo_ovlp, trans_mo)
from libdmet_preview_tpu_torch.lo.wannier import (  # noqa: F401
    proj_wannier, get_C_ao_lo_wannier, W90)
