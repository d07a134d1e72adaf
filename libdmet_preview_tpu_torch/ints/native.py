"""
Build and ctypes binding of the native integral core, csrc/_gto_core.cpp
(PyTorch port of libdmet_preview_tpu/ints/native.py: get_lib and
eri_s_shells).

The O(nao^4) s-shell ERI loop runs in C++, compiled at first use with
`g++ -O3 -shared -fPIC` into build/native/ beside the package (never into
the package directory).  The library's name carries a hash of the source
read when this module is imported, so a process always loads a binary
built from the source that shipped with its Python code; the build writes
a private temporary file and renames it into place, which is atomic, so
concurrent processes see either no library or a complete one.  When g++
fails the core warns and the caller uses the NumPy loop
(ints.gto.eri_s_numpy); `get_lib() is not None` says which one ran.
"""

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

from libdmet_preview_tpu_torch.utils import logger as log

_PKG_DIR = Path(__file__).resolve().parent.parent
BUILD_DIR = _PKG_DIR.parent / "build" / "native"
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-x", "c++"]


def _src_snapshot(src):
    """(source bytes, content-keyed library path), taken at import."""
    data = Path(src).read_bytes()
    digest = hashlib.sha256(data + " ".join(GXX_FLAGS).encode()).hexdigest()
    return data, BUILD_DIR / ("%s.%s.so" % (Path(src).stem, digest[:16]))


_GTO_SRC_DATA, _SO = _src_snapshot(_PKG_DIR / "csrc" / "_gto_core.cpp")
_LIB = None
_TRIED = False


def _build_snapshot(src_data, so, timeout=120):
    """Compile the import-time source snapshot to a private temporary file
    and rename it into place.  Returns True on success."""
    tmp_src = so.with_name("%s.tmp%d.cpp" % (so.name, os.getpid()))
    tmp = so.with_name("%s.tmp%d" % (so.name, os.getpid()))
    try:
        so.parent.mkdir(parents=True, exist_ok=True)
        tmp_src.write_bytes(src_data)
        subprocess.run(["g++"] + GXX_FLAGS + ["-o", str(tmp), str(tmp_src)],
                       check=True, capture_output=True, timeout=timeout)
        os.rename(tmp, so)
        return True
    except Exception as e:  # compiler missing or build dir not writable
        log.warn("native integral core build failed (%s); using the NumPy "
                 "path", e)
        return False
    finally:
        for f in (tmp, tmp_src):
            try:
                f.unlink()
            except OSError:
                pass


def get_lib():
    """The loaded native library, or None (the NumPy loop is used)."""
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    if not _SO.is_file() and not _build_snapshot(_GTO_SRC_DATA, _SO):
        return None
    try:
        lib = ctypes.CDLL(str(_SO))
    except OSError as e:
        log.warn("native integral core load failed (%s)", e)
        return None
    f8 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    lib.eri_s_shells.argtypes = [
        ctypes.c_int64, np.ctypeslib.ndpointer(np.int64,
                                               flags="C_CONTIGUOUS"),
        f8, f8, f8, f8]
    lib.eri_s_shells.restype = None
    _LIB = lib
    return _LIB


def eri_s_shells(shells):
    """Native ERI for a list of contracted s shells
    [(center_xyz, [(exp, coeff), ...]), ...]; returns (nao,)*4, or None
    when the native core is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    nao = len(shells)
    nprim = np.asarray([len(prims) for _, prims in shells], dtype=np.int64)
    exps = np.ascontiguousarray(
        np.concatenate([[a for a, _ in prims] for _, prims in shells]),
        dtype=np.float64)
    cofs = np.ascontiguousarray(
        np.concatenate([[c for _, c in prims] for _, prims in shells]),
        dtype=np.float64)
    cens = np.ascontiguousarray(
        np.asarray([xyz for xyz, _ in shells], dtype=np.float64))
    out = np.zeros((nao,) * 4)
    lib.eri_s_shells(nao, nprim, exps, cofs, cens.reshape(-1),
                     out.reshape(-1))
    return out
