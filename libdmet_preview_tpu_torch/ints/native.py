"""
Build and ctypes binding of the native integral cores (PyTorch port of
libdmet_preview_tpu/ints/native.py): csrc/_gto_core.cpp (get_lib,
eri_s_shells) and csrc/_sr_core.cpp, the periodic engine's short-range
lattice sums (get_sr_lib, sr_hermite_sum, sr_cand_sum and the
erfc_eri_rows_batch entry point that ints.pbc calls directly, on
num_threads() threads).

The O(nao^4) s-shell ERI loop runs in C++, compiled at first use with
`g++ -O3 -shared -fPIC` into build/native/ beside the package (never into
the package directory).  The library's name carries a hash of the source
read when this module is imported, so a process always loads a binary
built from the source that shipped with its Python code; the build writes
a private temporary file and renames it into place, which is atomic, so
concurrent processes see either no library or a complete one.  When g++
fails the core warns and the caller uses the NumPy loop
(ints.gto.eri_s_numpy); `get_lib() is not None` says which one ran.
The short-range core is built the same way; without it ints.pbc takes its
NumPy branches (`get_sr_lib() is not None` says which one ran).
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
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-pthread", "-x", "c++"]


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


def num_threads():
    """Threads of the short-range core: the intra-op threads PyTorch has
    been given (torch.get_num_threads(), which a process sets with
    torch.set_num_threads), at most the CPUs this process may run on."""
    import torch
    return max(1, min(torch.get_num_threads(),
                      len(os.sched_getaffinity(0))))


_SR_SRC_DATA, _SR_SO = _src_snapshot(_PKG_DIR / "csrc" / "_sr_core.cpp")
_SR_LIB = None
_SR_TRIED = False


def get_sr_lib():
    """The loaded short-range core (csrc/_sr_core.cpp), or None (the
    NumPy branches of ints.pbc are used)."""
    global _SR_LIB, _SR_TRIED
    if _SR_LIB is not None or _SR_TRIED:
        return _SR_LIB
    _SR_TRIED = True
    if not _SR_SO.is_file() and not _build_snapshot(_SR_SRC_DATA, _SR_SO,
                                                    timeout=180):
        return None
    try:
        lib = ctypes.CDLL(str(_SR_SO))
    except OSError as e:
        log.warn("native short-range core load failed (%s)", e)
        return None
    f8 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    i8 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    i64, dbl = ctypes.c_int64, ctypes.c_double
    lib.sr_hermite_sum.argtypes = [i64, i64, i64, f8, f8, i8, dbl, dbl,
                                   i64, f8, f8]
    lib.sr_hermite_sum.restype = None
    lib.sr_cand_sum.argtypes = [i64, i64, i64, f8, i8, i8, i8, f8, f8,
                                dbl, dbl, dbl, i64, i64, f8, f8]
    lib.sr_cand_sum.restype = None
    lib.erfc_eri_rows_batch.argtypes = [
        i64, i8, f8, f8, i64, i8, i8, i64, i8, f8, f8, f8, f8, f8,
        dbl, dbl, i64, i64, i64, i64, ctypes.c_void_p]
    lib.erfc_eri_rows_batch.restype = None
    _SR_LIB = lib
    return _SR_LIB


def sr_hermite_sum(lsum, PC, wz, kimg, nimg, alpha, kernel):
    """S[(t,u,v) flat, img] = sum_k wz_k R_tuv(alpha; PC_k) (kernel 0:
    Coulomb, 1: Gaussian; alpha may be complex); returns (S_re, S_im), or
    None when the core is unavailable or lsum > 4."""
    lib = get_sr_lib()
    if lib is None or lsum > 4:
        return None
    PC = np.ascontiguousarray(PC, dtype=np.float64)
    wz = np.ascontiguousarray(wz, dtype=np.float64)
    kimg = np.ascontiguousarray(kimg, dtype=np.int64)
    if wz.shape != (PC.shape[0],) or kimg.shape != (PC.shape[0],):
        raise ValueError("sr_hermite_sum: PC, wz and kimg disagree")
    if kimg.size and not (0 <= kimg.min() and kimg.max() < nimg):
        raise ValueError("sr_hermite_sum: image index out of range")
    dim = (lsum + 1) ** 3
    S_re = np.zeros((dim, nimg))
    S_im = np.zeros((dim, nimg))
    a = complex(alpha)
    lib.sr_hermite_sum(lsum, PC.shape[0], nimg, PC.reshape(-1), wz, kimg,
                       float(a.real), float(a.imag), int(kernel),
                       S_re.reshape(-1), S_im.reshape(-1))
    return S_re, S_im


def sr_cand_sum(lsum, P, inv, cand_img, cand_c, ctrs, Zs, rng2, alpha,
                kernel, low=False):
    """Fused candidate screen + Hermite kernel sum (sr_cand_sum in
    csrc/_sr_core.cpp): for each candidate (image, center) pair whose image
    this primitive pair keeps (inv[image] >= 0) and whose |P - C|^2 <
    rng2, adds Zs[center] R_tuv(alpha; P - C) to that image's row.  The
    arrays must be C-contiguous float64 / int64.  Returns (S_re, S_im) of
    shape ((lsum+1)^3, nimg_p), or None when the core is unavailable or
    lsum > 4.  low=True fills only the entries t + u + v <= lsum (the
    rest stay 0), which is all a Hermite -> Cartesian transform of order
    lsum reads."""
    lib = get_sr_lib()
    if lib is None or lsum > 4:
        return None
    nimg_p = P.shape[0]
    if cand_img.shape != cand_c.shape or Zs.shape[0] != ctrs.shape[0]:
        raise ValueError("sr_cand_sum: candidate arrays disagree")
    dim = (lsum + 1) ** 3
    S_re = np.zeros((dim, nimg_p))
    S_im = np.zeros((dim, nimg_p))
    a = complex(alpha)
    lib.sr_cand_sum(lsum, cand_img.shape[0], nimg_p, P.reshape(-1),
                    inv, cand_img, cand_c, ctrs.reshape(-1), Zs,
                    float(rng2), float(a.real), float(a.imag),
                    int(kernel), int(bool(low)), S_re.reshape(-1),
                    S_im.reshape(-1))
    return S_re, S_im


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
