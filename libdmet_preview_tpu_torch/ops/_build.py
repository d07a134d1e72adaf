"""
Build and load the port's hand-written CUDA kernels.

Each kernel source under libdmet_preview_tpu_torch/csrc/ exposes a plain C
function; it is compiled with nvcc for sm_90a into a shared library and
loaded with ctypes (no PyTorch headers, so a build takes seconds).  The
library goes to build/kernels/ beside the package, keyed by a hash of the
source and the flags, and is built at first use.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR.parent / "build" / "kernels"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# C signature of every entry point of each kernel library:
# {library: {symbol: (argtypes, restype)}}
_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "syrk_df": {
        # (F, out, ws, naux, npair, tile, n_whole, n_split, k_per_split,
        #  stream)
        "syrk_df_tri_f64": ([_P, _P, _P, _I, _I, _I, _I, _I, _I, _P], _I),
        # (F, F2, out, ws, naux, npair, tile, n_whole, n_split,
        #  k_per_split, stream)
        "syrk_df_cross_f64": ([_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
                              _I),
        # (symmetric, copy mode, tile, int info[3])
        "syrk_df_occupancy": ([_I, _I, _I, _P], _I),
    },
    "fci_sigma": {
        # (c, out, ws, A, B, int64 side_a[30], int64 side_b[30],
        #  int64 common[11], stream)
        "fci_sigma_f64": ([_P, _P, _P, _P, _P, _P, _P, _P, _P], _I),
        # (k-step bound, dynamic shared memory bytes, int info[3])
        "fci_sigma_occupancy": ([_I, _I, _P], _I),
    },
}

_loaded = {}


def find_nvcc():
    """nvcc from $CUDA_HOME/bin, else from PATH; raises if absent."""
    cuda_home = os.environ.get("CUDA_HOME")
    if cuda_home:
        cand = Path(cuda_home) / "bin" / "nvcc"
        if cand.is_file():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on "
                           "PATH to build the CUDA kernels")
    return found


def build(name):
    """Compile csrc/<name>.cu unless the library for this source hash
    exists.  Returns (path, seconds, compiler log); seconds is 0.0 when the
    library was already built, and the log is then the one kept beside it
    from that build."""
    src = CSRC_DIR / (name + ".cu")
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / ("lib%s-%s.so" % (name, digest))
    log_path = out.with_suffix(".log")
    if out.is_file():
        return out, 0.0, (log_path.read_text() if log_path.is_file() else "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(".so.tmp%d" % os.getpid())
    cmd = [find_nvcc()] + NVCC_FLAGS + ["-o", str(tmp), str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError("nvcc failed for %s (rc=%d):\n%s%s"
                           % (src, proc.returncode, proc.stdout, proc.stderr))
    log_path.write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out, seconds, proc.stdout + proc.stderr


def load(name, symbol):
    """Entry point `symbol` of kernel library `name` as a ctypes function,
    building the library at first use."""
    key = (name, symbol)
    if key not in _loaded:
        path, _, _ = build(name)
        argtypes, restype = _SIGNATURES[name][symbol]
        fn = getattr(ctypes.CDLL(str(path)), symbol)
        fn.argtypes = argtypes
        fn.restype = restype
        _loaded[key] = fn
    return _loaded[key]


def entry_points(name):
    """The C entry points of kernel library `name`."""
    return list(_SIGNATURES[name])


_n_sm = {}


def sm_count(device):
    """Streaming multiprocessors of CUDA `device` (asked once)."""
    if device.index not in _n_sm:
        import torch
        _n_sm[device.index] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _n_sm[device.index]
