"""DMET vocabulary for Hubbard-family models, and the DMET loop."""

from libdmet_preview_tpu_torch.dmet import hubbard as Hubbard  # noqa: F401
from libdmet_preview_tpu_torch.dmet import hubbard_gso as HubbardGSO  # noqa: F401,E501
from libdmet_preview_tpu_torch.dmet import hubbard_bcs as HubbardBCS  # noqa: F401,E501
from libdmet_preview_tpu_torch.dmet import quad_fit  # noqa: F401
from libdmet_preview_tpu_torch.dmet.loop import run_dmet, DmetResult  # noqa: F401,E501
