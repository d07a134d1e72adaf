"""
The PyTorch port's host utilities against the JAX package's, on the
oracles of the JAX suite's tests/test_utils_io.py: POSCAR / XYZ written
by one package and read by the other, DMRG extrapolation, lattice plots
(matplotlib imported only inside the call), the profiling hooks
(utils/profile.py: per-phase clocks, torch.profiler labels, the trace
file), and the HDF5 `outcore=` mode of get_emb_eri_chol against the
in-core embedding ERI (1e-14; h5py imported only by that call).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)
CPU = torch.device("cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CELL = np.diag([4.0, 5.0, 6.0])
SYMBOLS = ["Cu", "O", "O"]
FRAC = np.asarray([[0.0, 0.0, 0.0], [0.5, 0.0, 0.0], [0.0, 0.5, 0.0]])


@pytest.mark.parametrize("writer,reader", [
    ("libdmet_preview_tpu_torch", "libdmet_preview_tpu"),
    ("libdmet_preview_tpu", "libdmet_preview_tpu_torch"),
    ("libdmet_preview_tpu_torch", "libdmet_preview_tpu_torch"),
])
def test_poscar_and_xyz_across_packages(tmp_path, writer, reader):
    import importlib
    W = importlib.import_module(writer + ".utils.iotools")
    R = importlib.import_module(reader + ".utils.iotools")
    path = str(tmp_path / "POSCAR")
    W.write_poscar(path, CELL, SYMBOLS, FRAC, comment="CuO2")
    cell2, sym2, frac2 = R.read_poscar(path)
    assert np.array_equal(cell2, CELL) and sym2 == SYMBOLS
    assert np.array_equal(frac2, FRAC)
    coords = np.asarray([[0.0, 0.0, 0.0], [0.0, 0.0, 0.74]])
    path = str(tmp_path / "h2.xyz")
    W.write_xyz(path, ["H", "H"], coords, comment="H2")
    sym2, coords2 = R.read_xyz(path)
    assert sym2 == ["H", "H"] and np.array_equal(coords2, coords)


def test_files_are_byte_identical(tmp_path):
    from libdmet_preview_tpu.utils import iotools as J
    from libdmet_preview_tpu_torch.utils import iotools as T
    for mod, tag in ((J, "j"), (T, "t")):
        mod.write_poscar(str(tmp_path / ("P" + tag)), CELL, SYMBOLS, FRAC,
                         comment="c")
        mod.write_xyz(str(tmp_path / ("x" + tag)), SYMBOLS, FRAC, "c")
    for a in ("P", "x"):
        assert (tmp_path / (a + "j")).read_bytes() == \
            (tmp_path / (a + "t")).read_bytes()


def test_read_cartesian_poscar(tmp_path):
    from libdmet_preview_tpu.utils.iotools import read_poscar as jread
    from libdmet_preview_tpu_torch.utils.iotools import read_poscar
    path = tmp_path / "POSCAR"
    path.write_text("c\n2.0\n1 0 0\n0 1 0\n0 0 2\nNi O\n1 1\nCartesian\n"
                    "0 0 0\n1.0 1.0 2.0\n")
    cell, sym, frac = read_poscar(str(path))
    assert sym == ["Ni", "O"] and np.allclose(frac[1], [0.5, 0.5, 0.5])
    for a, b in zip(jread(str(path)), (cell, sym, frac)):
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_extrapolate_matches_jax():
    from libdmet_preview_tpu.utils import extrapolate as J
    from libdmet_preview_tpu_torch.utils import extrapolate as T
    Ms = np.asarray([400, 800, 1600, 3200])
    Es = -1.2345 + 0.8 / Ms
    E_fit, coeffs = T.extrapolate_M(Ms, Es)
    assert abs(E_fit + 1.2345) < 1e-10
    Ej, cj = J.extrapolate_M(Ms, Es, deg=2)
    Et, ct = T.extrapolate_M(Ms, Es, deg=2)
    assert Ej == Et and np.array_equal(cj, ct)
    dws = np.asarray([1e-5, 2e-5, 4e-5])
    Es = -2.0 + 3.0 * dws
    E0, _ = T.extrapolate_dw(dws, Es)
    assert abs(E0 + 2.0) < 1e-10 and E0 == J.extrapolate_dw(dws, Es)[0]


def test_lattice_plot_smoke(tmp_path):
    pytest.importorskip("matplotlib")
    from libdmet_preview_tpu_torch.utils.lattice_plot import (plot_lattice,
                                                              plot_dos)
    coords = np.asarray([[0, 0], [1, 0], [0, 1], [1, 1]], dtype=float)
    plot_lattice(coords, charges=[1, 1, 1, 1], spins=[0.3, -0.3, -0.3, 0.3],
                 bonds=[(0, 1, 0.5), (0, 2, 0.5)],
                 filename=str(tmp_path / "latt.png"))
    assert (tmp_path / "latt.png").stat().st_size > 0
    plot_dos(torch.linspace(-2, 2, 20, dtype=torch.float64),
             filename=str(tmp_path / "dos.png"))
    assert (tmp_path / "dos.png").stat().st_size > 0


def test_importing_the_port_loads_no_optional_module():
    """Importing the package (and utils.lattice_plot, utils.profile)
    imports neither matplotlib nor h5py nor jax."""
    code = ("import sys, libdmet_preview_tpu_torch; "
            "import libdmet_preview_tpu_torch.utils.lattice_plot; "
            "import libdmet_preview_tpu_torch.ops.eri_transform; "
            "print([m for m in ('matplotlib', 'h5py', 'jax', "
            "'libdmet_preview_tpu') if m in sys.modules])")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, text=True,
                         capture_output=True, check=True,
                         env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert out.stdout.strip() == "[]"


def test_profile_phases_and_trace(tmp_path):
    from libdmet_preview_tpu_torch.utils import profile
    profile.report(reset=True)
    a = torch.randn(32, 32, dtype=torch.float64)
    for _ in range(3):
        with profile.phase("gemm", device=CPU):
            a = a @ a.T / 32.0
    with profile.phase("other"):
        pass
    out = profile.report(reset=True)
    assert out["gemm"]["calls"] == 3 and out["other"]["calls"] == 1
    assert out["gemm"]["total_s"] >= 0.0 and profile.report() == {}
    with profile.device_trace(str(tmp_path / "tr")) as prof:
        with profile.phase("traced"):
            a @ a
    assert (tmp_path / "tr" / "trace.json").stat().st_size > 0
    assert any(e.key == "traced" for e in prof.key_averages())
    profile.report(reset=True)


def _chol_case(seed, n=3, ncells=2, neo=4, spin=1):
    from libdmet_preview_tpu_torch.ops.eri_transform import cholesky_eri
    rng = np.random.RandomState(seed)
    A = rng.randn(5, ncells * n, ncells * n)
    A = A + A.transpose(0, 2, 1)
    g = np.einsum("xpq, xrs -> pqrs", A, A)
    L = cholesky_eri(torch.as_tensor(g), tol=1e-12)
    return L, rng.randn(spin, ncells, n, neo)


@pytest.mark.parametrize("spin", [1, 2])
def test_emb_eri_chol_outcore(tmp_path, spin):
    """outcore=path writes the (pairs, neo^4) dataset "eri" and returns it
    open for reading; it equals the in-core result (1e-14) and JAX's
    outcore dataset on the same factors."""
    from libdmet_preview_tpu.ops.eri_transform import \
        get_emb_eri_chol as jget
    from libdmet_preview_tpu_torch.ops.eri_transform import get_emb_eri_chol
    L, basis = _chol_case(2 + spin, spin=spin)
    incore = get_emb_eri_chol(L, basis).numpy()
    dset = get_emb_eri_chol(L, basis, outcore=str(tmp_path / "eri.h5"))
    try:
        assert dset.name == "/eri" and dset.shape == incore.shape
        assert dset.file.mode == "r"
        assert np.abs(dset[()] - incore).max() < 1e-14
        dj = jget(L.numpy(), basis, outcore=str(tmp_path / "jax.h5"))
        assert np.abs(dj[()] - dset[()]).max() < 1e-12
        dj.file.close()
    finally:
        dset.file.close()
