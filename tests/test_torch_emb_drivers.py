"""
The PyTorch port's streamed embedding-ERI drivers (libdmet_preview_tpu_
torch/ints/pbc.py PbcCell.get_emb_eri_aft / _fft / _rs and their cross
forms, grid_coords, eval_ao_pbc, the short-range rows) and the 'aft' H2
format (models/abinitio.AbInitioHam, ops/embham._emb_H2) against the JAX
package on the CPU, on tests/test_pbc_3d.py's fixtures:

  * the H2 crystal on a 2 x 2 x 1 mesh (workloads.h2_crystal_geometry),
    with and without translations,
  * the GTH H2 cell (the GTH-optimised valence basis of ints/basisopt),
  * the two-cell s + p stripe of test_emb_eri_rs_general_l,

each driver on the same NumPy coefficients held to 1e-12 relative;
_emb_H2 on an 'aft' lattice for every df_mode, restricted and
unrestricted, against the JAX _emb_H2 (1e-12 relative); every route of
ops.eri_transform.get_emb_eri; the JAX suite's oracles on the port alone
(aft and its cross form against the dense-ERI transform 1e-8, FFT-DF on
twice the mesh against aft 2e-4, the grid overlap 1e-5, rs against aft at
omega = 1.0 with the cross form 5e-7, rs with p shells 5e-6 relative);
the short-range rows kept on the cell per (omega, pair_tol); and the
threaded native core bit-identical to one thread.  The JAX sides run once
per module, one case at a time.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)
CPU = torch.device("cpu")
TOL = 1e-12
DF_MODES = ("aft", "fft", "rs")


def _n(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _kw(M):
    return {"device": CPU} if M.__name__.startswith(
        "libdmet_preview_tpu_torch") else {}


def _crystal(M, with_translations=True, precision=1e-10):
    from libdmet_preview_tpu_torch import workloads as wl
    return wl.h2_crystal_cell(M, (2, 2, 1), with_translations, precision,
                              **_kw(M))


def _gth_cell(M):
    from libdmet_preview_tpu_torch import workloads as wl
    return wl.gth_h2_cell(M, **_kw(M))


def _sp_cell(M):
    from libdmet_preview_tpu_torch import workloads as wl
    return wl.sp_stripe_cell(M, **_kw(M))


def _coefs(n, seed=3):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, 3)), rng.normal(size=(n, 2))


def _basis(spin, seed=5):
    """A (spin, 4, 2, 3) stripe embedding basis of the crystal."""
    return np.random.default_rng(seed).normal(size=(spin, 4, 2, 3)) * 0.5


def _aft_lattice(M, cell, df_mode):
    """The minimal lattice _emb_H2 reads on the 'aft' format."""
    from types import SimpleNamespace
    abinitio = __import__(M.__name__.replace("ints.pbc", "models.abinitio"),
                          fromlist=["AbInitioHam"])
    C = np.random.default_rng(11).normal(size=(cell.nao, cell.nao)) * 0.4
    Ham = abinitio.AbInitioHam(None, None, None, None, 0.0, aft_cell=cell,
                               C_ao_lo=C, df_mode=df_mode)
    assert Ham.H2_format == "aft"
    return SimpleNamespace(Ham=Ham, H2_format=Ham.H2_format, nscsites=2)


def _emb_h2(M, lat, spin):
    embham = __import__(M.__name__.replace("ints.pbc", "ops.embham"),
                        fromlist=["_emb_H2"])
    basis = _basis(spin)
    if M.__name__.startswith("libdmet_preview_tpu_torch"):
        basis = torch.as_tensor(basis)
    return embham._emb_H2(lat, basis, None, int_bath=True)


def _values(M, case):
    out = {}
    if case == "crystal":
        cell = _crystal(M)
        Ca, Cb = _coefs(cell.nao)
        out["aft"] = cell.get_emb_eri_aft(Ca)
        out["aft_x"] = cell.get_emb_eri_aft_cross(Ca, Cb)
        out["rs1"] = cell.get_emb_eri_rs(Ca, omega=1.0)
        out["rs05"] = cell.get_emb_eri_rs(Ca)
        out["rs1_x"] = cell.get_emb_eri_rs_cross(Ca, Cb, omega=1.0)
        out["rs05_x"] = cell.get_emb_eri_rs_cross(Ca, Cb)
        out["sr_rows"] = cell._sr_ao_eri_rows(1.0)
        pts = cell.grid_coords()
        out["grid"] = pts
        out["ao"] = cell.eval_ao_pbc(pts[::7])
    elif case == "crystal_dense":
        cell = _crystal(M, False, precision=1e-6)
        Ca, _ = _coefs(cell.nao)
        out["aft"] = cell.get_emb_eri_aft(Ca)
        out["rs1"] = cell.get_emb_eri_rs(Ca, omega=1.0)
    elif case == "gth":
        cell = _gth_cell(M)
        C = np.random.default_rng(0).normal(size=(cell.nao, 2))
        out["aft"] = cell.get_emb_eri_aft(C)
        out["fft2"] = cell.get_emb_eri_fft(
            C, mesh=tuple(2 * n + 1 for n in cell.mesh))
    elif case == "sp":
        cell = _sp_cell(M)
        C = np.random.default_rng(1).normal(size=(cell.nao, 3))
        out["aft"] = cell.get_emb_eri_aft(C)
        out["rs08"] = cell.get_emb_eri_rs(C, omega=0.8)
    else:                                   # "emb_<df_mode>"
        cell = _crystal(M, precision=1e-6)
        lat = _aft_lattice(M, cell, case[4:])
        out["R"] = _emb_h2(M, lat, 1)
        out["U"] = _emb_h2(M, lat, 2)
    return {k: _n(v) for k, v in out.items()}


CASES = ["crystal", "crystal_dense", "gth", "sp"] + [
    "emb_" + m for m in DF_MODES]


@pytest.fixture(scope="module")
def values():
    from libdmet_preview_tpu.ints import pbc as jpbc
    from libdmet_preview_tpu_torch.ints import pbc as tpbc
    # one case at a time: the JAX package's short-range rows make one
    # native call per bra pair, and beside the port's cases in another
    # thread they took minutes under a loaded test run
    jax = {c: _values(jpbc, c) for c in CASES}
    port = {c: _values(tpbc, c) for c in CASES}
    return jax, port


def _keys(case):
    return {"crystal": ["aft", "aft_x", "rs1", "rs05", "rs1_x", "rs05_x",
                        "sr_rows", "grid", "ao"],
            "crystal_dense": ["aft", "rs1"],
            "gth": ["aft", "fft2"], "sp": ["aft", "rs08"]}.get(
                case, ["R", "U"])


@pytest.mark.parametrize("case,key", [(c, k) for c in CASES
                                      for k in _keys(c)])
def test_driver_matches_jax(values, case, key):
    jax, port = values
    a, b = jax[case][key], port[case][key]
    assert a.shape == b.shape
    err = np.abs(a - b).max() / max(np.abs(a).max(), 1e-300)
    assert err < TOL, err


@pytest.fixture(scope="module")
def sp_cell():
    from libdmet_preview_tpu_torch.ints import pbc
    return _sp_cell(pbc)


def test_drivers_return_device_tensors(sp_cell):
    cell = sp_cell
    Ca, Cb = _coefs(cell.nao)
    for eri in (cell.get_emb_eri_aft(Ca), cell.get_emb_eri_rs_cross(Ca, Cb),
                cell.get_emb_eri_fft(torch.as_tensor(Ca)),
                cell.get_emb_eri_fft_cross(Ca, Cb)):
        assert isinstance(eri, torch.Tensor) and eri.dtype == torch.float64
        assert eri.device == CPU
    assert cell.eval_ao_pbc(cell.grid_coords()[:3]).shape == (3, cell.nao)


@pytest.mark.parametrize("df_type,method", [
    ("aft", "get_emb_eri_aft"), ("fft", "get_emb_eri_fft"),
    ("mdf", "get_emb_eri_rs"), ("rs", "get_emb_eri_rs"),
    (None, "get_emb_eri_aft")])
def test_get_emb_eri_routes_reach_the_drivers(sp_cell, df_type, method):
    from libdmet_preview_tpu_torch.ops.eri_transform import get_emb_eri
    C = np.random.default_rng(2).normal(size=(sp_cell.nao, 2))
    got = get_emb_eri(sp_cell, C, df_type=df_type, device=CPU)
    assert torch.equal(got, getattr(sp_cell, method)(C))


# ----------------------------------------------------------------------
# the JAX suite's oracles (tests/test_pbc_3d.py:111-219), port alone
# ----------------------------------------------------------------------

ORACLES = ["aft vs the dense transform", "aft cross vs the dense transform",
           "rs vs aft (omega 1.0)", "rs cross vs aft cross (omega 1.0)",
           "FFT-DF (twice the mesh) vs aft", "the grid overlap",
           "rs with p shells vs aft (relative)"]


@pytest.fixture(scope="module")
def oracles():
    from libdmet_preview_tpu_torch import workloads as wl
    return wl.emb_driver_oracles(CPU)[1]


@pytest.mark.parametrize("name", ORACLES)
def test_driver_oracle(oracles, name):
    value, bound, ok = oracles[name]
    assert ok, (value, bound)


# ----------------------------------------------------------------------
# the short-range rows: kept per (omega, pair_tol); the threaded core
# ----------------------------------------------------------------------

def test_sr_rows_are_made_once_per_omega(monkeypatch):
    from libdmet_preview_tpu_torch.ints import pbc
    cell = _crystal(pbc)
    calls = []
    real = pbc.PbcCell._sr_rows

    def counted(self, omega, prec, nthreads=None):
        calls.append((omega, prec))
        return real(self, omega, prec, nthreads)

    monkeypatch.setattr(pbc.PbcCell, "_sr_rows", counted)
    Ca, Cb = _coefs(cell.nao)
    r1 = cell._sr_ao_eri_rows(1.0)
    e1 = cell.get_emb_eri_rs(Ca)
    e2 = cell.get_emb_eri_rs(Ca)                 # no new rows
    cell.get_emb_eri_rs_cross(Ca, Cb)
    cell.eri_trans_full_rs(omega=1.0)
    assert cell._sr_ao_eri_rows(1.0) is r1
    assert torch.equal(e1, e2)
    assert calls == [(1.0, 1e-10), (0.5, 1e-10)]
    cell._sr_ao_eri_rows(0.5, pair_tol=1e-8)
    assert calls[-1] == (0.5, 1e-8) and len(calls) == 3


@pytest.mark.parametrize("case", ["crystal", "sp", "diamond"])
def test_native_rows_threaded_equal_one_thread(case):
    from libdmet_preview_tpu_torch.ints import native, pbc
    from libdmet_preview_tpu_torch.models.abinitio import diamond_cell
    if native.get_sr_lib() is None:
        pytest.fail("the native short-range core did not build")
    cell = {"crystal": lambda: _crystal(pbc), "sp": lambda: _sp_cell(pbc),
            "diamond": lambda: diamond_cell((1, 1, 2), precision=1e-4,
                                            device=CPU)}[case]()
    one = cell._sr_rows(0.7, cell.precision, nthreads=1)
    many = cell._sr_rows(0.7, cell.precision, nthreads=4)
    assert np.abs(one).max() > 0.0 and np.array_equal(one, many)


def test_threaded_one_body_sums_equal_one_thread(monkeypatch):
    """The nuclear short range and the GTH local terms (sr_cand_sum per
    shell pair, in a thread pool)."""
    from libdmet_preview_tpu_torch.ints import native
    from libdmet_preview_tpu_torch.models.abinitio import diamond_cell
    cell = diamond_cell((1, 1, 1), precision=1e-4, device=CPU)
    out = []
    for n in (1, 4):
        monkeypatch.setattr(native, "num_threads", lambda n=n: n)
        out.append(cell._nuc_np())
    assert np.array_equal(out[0], out[1])


@pytest.mark.parametrize("lsum", [0, 1, 2, 4])
def test_native_low_order_sums_equal_the_full_table(lsum):
    """sr_cand_sum(low=True), which the 1-body sums use, against the full
    Hermite table on the entries t + u + v <= lsum (the rest stay 0), for
    the Coulomb kernel and the complex-step Gaussian."""
    from libdmet_preview_tpu_torch.ints import native
    rng = np.random.RandomState(7 + lsum)
    nimg = 5
    P = rng.uniform(-1.0, 1.0, size=(nimg, 3))
    ctrs = rng.uniform(-2.0, 2.0, size=(7, 3))
    Zs = rng.uniform(0.5, 3.0, size=7)
    inv = np.array([0, -1, 1, 2, 3, 4, -1], dtype=np.int64)
    cand_img = rng.randint(0, inv.size, size=40).astype(np.int64)
    cand_c = rng.randint(0, 7, size=40).astype(np.int64)
    t, u, v = np.meshgrid(*[np.arange(lsum + 1)] * 3, indexing="ij")
    keep = (t + u + v <= lsum).ravel()
    for kernel, alpha in ((0, 0.8), (1, 0.9 + 1e-3j)):
        full = native.sr_cand_sum(lsum, P, inv, cand_img, cand_c, ctrs, Zs,
                                  6.0, alpha, kernel)
        low = native.sr_cand_sum(lsum, P, inv, cand_img, cand_c, ctrs, Zs,
                                 6.0, alpha, kernel, low=True)
        for a, b in zip(full, low):
            assert not b[~keep].any()
            assert np.abs(a[keep] - b[keep]).max() \
                <= 1e-13 * max(np.abs(a).max(), 1e-300)
