"""
Scale-out over torch.distributed (PyTorch port of
libdmet_preview_tpu/parallel/): kmesh, the sharded DMET operations on a
(k, aux) grid of ranks, and dryrun, which starts the ranks and runs one
DMET iteration on them.
"""

from libdmet_preview_tpu_torch.parallel import kmesh  # noqa: F401
