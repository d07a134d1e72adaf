"""
Integral file I/O and the small helpers of the PyTorch port
(libdmet_preview_tpu_torch/models/integral.py: FCIDUMP, .npz, HDF5, mmap;
utils/misc.py) against the JAX package's, on the CPU.

FCIDUMP is text: each package writes, the other reads, and the blocks
agree at 1e-12 (the %19.12E format keeps 13 significant digits); the port
writes the same text as JAX, line for line.  The archives round-trip
exactly.  The misc helpers equal JAX's exactly.
"""

import os
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(2)


def _eri_s1(rng, n, nfac=3):
    A = rng.randn(nfac, n, n)
    A = A + A.transpose(0, 2, 1)
    return np.einsum("xpq, xrs -> pqrs", A, A) * 0.1


def _sym(rng, n):
    A = rng.randn(n, n)
    return A + A.T


def _integrals(pkg, restricted, n=4, seed=0, tensors=False):
    """The same restricted or unrestricted Integral in either package;
    tensors=True gives the port's blocks as torch tensors."""
    rng = np.random.RandomState(seed)
    if restricted:
        H1 = np.stack([_sym(rng, n)])
        H2 = np.stack([_eri_s1(rng, n)])
    else:
        H1 = np.stack([_sym(rng, n), _sym(rng, n)])
        H2 = np.stack([_eri_s1(rng, n) for _ in range(3)])
    if tensors:
        H1, H2 = torch.as_tensor(H1), torch.as_tensor(H2)
    return pkg.Integral(n, restricted, False, 0.731, {"cd": H1},
                        {"ccdd": H2})


def _pkgs():
    from libdmet_preview_tpu.models import integral as ji
    from libdmet_preview_tpu_torch.models import integral as pi
    return ji, pi


@pytest.mark.parametrize("restricted", [True, False])
def test_dump_fcidump_same_text_as_jax(tmp_path, restricted):
    ji, pi = _pkgs()
    ji.dump_FCIDUMP(str(tmp_path / "j"), _integrals(ji, restricted), nelec=4)
    pi.dump_FCIDUMP(str(tmp_path / "p"),
                    _integrals(pi, restricted, tensors=True), nelec=4)
    assert (tmp_path / "j").read_text() == (tmp_path / "p").read_text()


def test_dump_fcidump_s4_input(tmp_path):
    """An s4-packed H2 block is restored to s1 before writing, in both."""
    ji, pi = _pkgs()
    ints_j = _integrals(ji, True)
    ints_p = _integrals(pi, True)
    s4 = ji.restore_eri(ints_j.H2["ccdd"][0], 4, 4)
    ints_j.H2["ccdd"] = s4[None]
    ints_p.H2["ccdd"] = torch.as_tensor(s4)[None]
    ji.dump_FCIDUMP(str(tmp_path / "j"), ints_j)
    pi.dump_FCIDUMP(str(tmp_path / "p"), ints_p)
    assert (tmp_path / "j").read_text() == (tmp_path / "p").read_text()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_fcidump_cross_read(tmp_path, writer):
    """Written by one package, read by the other: equal at 1e-12."""
    ji, pi = _pkgs()
    src, dst = (ji, pi) if writer == "jax" else (pi, ji)
    ints = _integrals(src, True, n=5, seed=3)
    path = str(tmp_path / "FCIDUMP")
    src.dump_FCIDUMP(path, ints, nelec=6)
    back = dst.read_FCIDUMP(path)
    assert back.norb == 5 and back.nelec == 6
    assert abs(back.H0 - 0.731) < 1e-12
    assert np.abs(back.H1["cd"] - np.asarray(ints.H1["cd"])).max() < 1e-12
    assert np.abs(back.H2["ccdd"] - np.asarray(ints.H2["ccdd"])).max() < 1e-12
    mine = src.read_FCIDUMP(path)
    assert np.array_equal(mine.H2["ccdd"], back.H2["ccdd"])
    assert np.array_equal(mine.H1["cd"], back.H1["cd"])


def test_dump_fcidump_ghf_same_text_as_jax(tmp_path):
    """The spin-orbital (GSO) writer: same text; read back as a restricted
    FCIDUMP of norb spin orbitals by both packages."""
    ji, pi = _pkgs()
    ji.dump_FCIDUMP_ghf(str(tmp_path / "j"), _integrals(ji, True, n=6, seed=2))
    pi.dump_FCIDUMP_ghf(str(tmp_path / "p"),
                        _integrals(pi, True, n=6, seed=2, tensors=True))
    text = (tmp_path / "p").read_text()
    assert (tmp_path / "j").read_text() == text
    assert "IGENERAL=1" in text and "NELEC= 3" in text
    a, b = ji.read_FCIDUMP(str(tmp_path / "j")), pi.read_FCIDUMP(
        str(tmp_path / "p"))
    assert np.array_equal(a.H2["ccdd"], b.H2["ccdd"])


def _same_integral(a, b):
    assert (a.norb, a.restricted, a.bogoliubov) == \
        (b.norb, b.restricted, b.bogoliubov)
    assert float(a.H0) == float(b.H0)
    for d1, d2 in ((a.H1, b.H1), (a.H2, b.H2)):
        assert sorted(d1) == sorted(d2)
        for k in d1:
            assert np.array_equal(np.asarray(d1[k]), np.asarray(d2[k]))
    assert (a.ovlp is None) == (b.ovlp is None)
    if a.ovlp is not None:
        assert np.array_equal(np.asarray(a.ovlp), np.asarray(b.ovlp))


@pytest.mark.parametrize("fmt", ["mmap", "npz", "h5"])
def test_archive_round_trips(tmp_path, fmt):
    """save/load round trips exactly (the port's tensors come back as
    arrays); mmap blocks stay memory-mapped; the HDF5 file is readable by
    the JAX package's load_h5."""
    ji, pi = _pkgs()
    ints = _integrals(pi, False, n=3, seed=4, tensors=True)
    ints.ovlp = torch.eye(3)[None].expand(2, 3, 3).clone()
    path = str(tmp_path / "ints")
    if fmt == "mmap":
        pi.save_mmap(path, ints)
        back = pi.load_mmap(path)
        assert isinstance(back.H2["ccdd"], np.memmap)
        _same_integral(ints, ji.load_mmap(path))
    elif fmt == "npz":
        pi.save_npz(path + ".npz", ints)
        back = pi.load_npz(path + ".npz")
    else:
        pytest.importorskip("h5py")
        pi.save_h5(path + ".h5", ints)
        back = pi.load_h5(path + ".h5")
        _same_integral(ints, ji.load_h5(path + ".h5"))
    _same_integral(ints, back)


def test_h5_without_h5py_names_npz(tmp_path, monkeypatch):
    """Where h5py is missing, save_h5 / load_h5 raise an ImportError that
    points to save_npz / load_npz (h5py is imported only inside them)."""
    _, pi = _pkgs()
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="save_npz"):
        pi.save_h5(str(tmp_path / "x.h5"), _integrals(pi, True))
    with pytest.raises(ImportError, match="load_npz"):
        pi.load_h5(str(tmp_path / "x.h5"))


def test_no_h5py_import_at_module_level():
    src = open(os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "libdmet_preview_tpu_torch", "models",
        "integral.py")).read()
    top = [ln for ln in src.splitlines() if ln.startswith(("import",
                                                           "from"))]
    assert not any("h5py" in ln for ln in top)


def test_misc_helpers_match_jax():
    from libdmet_preview_tpu.utils import misc as jm
    from libdmet_preview_tpu_torch.utils import misc as pm
    rng = np.random.RandomState(5)
    A = rng.randn(3, 5, 5)
    A = A + A.transpose(0, 2, 1)
    for x in (A, A * 1j, np.zeros(0), -np.abs(A)):
        assert pm.max_abs(x) == jm.max_abs(x)
    assert pm.max_abs(torch.as_tensor(A)) == jm.max_abs(A)
    B, C = rng.randn(5, 4), rng.randn(4, 3)
    assert np.array_equal(pm.mdot(A[0], B, C), jm.mdot(A[0], B, C))
    assert np.array_equal(pm.mdot(*map(torch.as_tensor, (A[0], B, C))).numpy(),
                          jm.mdot(A[0], B, C))
    for n in (1, 4, 7):
        assert all(np.array_equal(x, y) for x, y in
                   zip(pm.tril_indices(n), jm.tril_indices(n)))
        assert np.array_equal(pm.tril_diag_indices(n),
                              jm.tril_diag_indices(n))
    P = jm.pack_tril(A)
    assert np.array_equal(pm.pack_tril(A), P)
    assert np.array_equal(pm.pack_tril(torch.as_tensor(A)).numpy(), P)
    assert np.array_equal(pm.unpack_tril(P), jm.unpack_tril(P))
    assert np.array_equal(pm.unpack_tril(torch.as_tensor(P)).numpy(),
                          jm.unpack_tril(P))
    assert np.array_equal(pm.unpack_tril(P, 5), A)
    assert pm.format_idx([1, 2, 5]) == jm.format_idx([1, 2, 5])
