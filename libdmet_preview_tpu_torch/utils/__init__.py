from libdmet_preview_tpu_torch.utils import logger, misc  # noqa: F401
