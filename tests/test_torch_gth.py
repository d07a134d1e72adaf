"""
The PyTorch port's GTH pseudopotentials (libdmet_preview_tpu_torch/ints/
gth.py, host NumPy) and the periodic cell's pseudopotential terms
(ints/pbc.py: the erfc and Gaussian short range with the complex-step r^2
derivative through the native core, the C3/C4 polynomial kernels through
NumPy, the lattice-summed projectors) against the JAX package on the CPU:

  * _h_full, projector_cart, gauss_block (real and complex exponent),
    gth_loc_sr_block (C1..C4) and gth_nl_block (s with two radial
    projectors, p, d) on s, p and d shells, and gth_pp_molecular on a CH2
    fragment in GTH-SZV: 1e-12 absolute;
  * a GTH-PADE carbon cell in GTH-SZV (intor_nuc, intor_hcore) and
    tests/test_gth.py's general-l species with C3/C4 (_pp_sr_matrix),
    each in a 2-cell stripe and dense: against JAX 1e-12, and the port's
    stripe against its dense assembly 1e-12;
  * on the port alone, tests/test_gth.py's quadrature oracles: the C1 and
    complex-step C2 terms and the nonlocal s/p/d channels (1e-9 / 1e-8).
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

torch.set_num_threads(1)
CPU = torch.device("cpu")
TOL = 1e-12
A = np.array([0.2, -0.1, 0.3])
B = np.array([-0.4, 0.5, 0.1])
C0 = np.array([0.1, 0.2, -0.2])
CS = np.array([[0.1, 0.2, -0.2], [0.9, -0.3, 0.4], [-0.5, 0.6, 1.1]])
_XBASIS = {("C", "mini"): [(0, [(1.4, 1.0), (0.8, 0.6)]),
                           (1, [(0.9, 1.0)])]}
# (l, radial index) of the projectors: degree l + 2(i-1) <= 4
PROJ = [(0, 1), (0, 2), (0, 3), (1, 1), (1, 2), (2, 1), (2, 2)]
CH2 = [("C", (0.0, 0.0, 0.0)), ("H", (0.0, 0.0, 2.05)),
       ("H", (1.95, 0.0, -0.62))]


def _fake(gth):
    """tests/test_gth.py's general-l species: C1..C4, s (2 radial), p, d."""
    return {"zion": 4.0, "rloc": 0.45, "cloc": [-6.0, 1.1, -0.3, 0.05],
            "nl": [(0, 0.42, gth._h_full(0, [5.9, 3.2])),
                   (1, 0.48, gth._h_full(1, [2.7])),
                   (2, 0.40, gth._h_full(2, [-4.0]))]}


def _blocks(md, gth):
    out = {}
    for l, i in PROJ:
        L, alpha, W = gth.projector_cart(l, i, 0.43)
        out["projector_cart", l, i] = np.concatenate([[L, alpha],
                                                      W.ravel()])
    for l in (0, 1, 2):
        out["_h_full", l] = gth._h_full(l, [1.3, -0.7, 0.4])
    pp = _fake(gth)
    for l1 in (0, 1, 2):
        for l2 in (0, 1):
            s1 = md.Shell(A, l1, [(0.9, 1.0), (0.35, 0.5)])
            s2 = md.Shell(B, l2, [(0.6, 1.0)])
            g = gth.gauss_block(s1, s2, 1.7 + 1e-3j, CS)
            out["gauss_block", l1, l2] = np.concatenate(
                [g.real.ravel(), g.imag.ravel(),
                 gth.gauss_block(s1, s2, 0.8, C0).ravel()])
            out["gth_loc_sr_block", l1, l2] = gth.gth_loc_sr_block(
                s1, s2, pp, CS)
            out["gth_nl_block", l1, l2] = gth.gth_nl_block(s1, s2, pp, C0)
    mol = md.MoleGeneral(CH2, basis="gth-szv")
    V, zions = gth.gth_pp_molecular(mol)
    out["gth_pp_molecular"] = np.concatenate([V.ravel(), zions])
    return out


def _pp_cell(pbc, species, stripe, kw):
    """Two carbons 2 bohr apart along z in a (8, 8, 4) bohr box, as one
    cell or a 2-cell stripe."""
    L = 4.0
    atoms = [("C", (0.0, 0.0, 0.15)), ("C", (0.0, 0.0, L / 2 + 0.15))]
    if species == "gth-pade":
        cell = pbc.PbcCell(atoms, np.diag([8.0, 8.0, L]), basis="gth-szv",
                           pseudo="gth-pade", precision=1e-9, **kw)
    else:
        cell = pbc.PbcCell(atoms, np.diag([10.0, 10.0, L]), basis="mini",
                           basis_data=_XBASIS, precision=1e-10, **kw)
        from importlib import import_module
        fake = _fake(import_module(pbc.__name__.replace(".pbc", ".gth")))
        cell.pps = [fake, fake]
        cell.charges = np.asarray([fake["zion"]] * 2)
    if stripe:
        cell.set_translations(2, np.array([[0.0, 0.0, 0.0],
                                           [0.0, 0.0, L / 2]]))
    return cell


CELL_CASES = [(sp, st) for sp in ("gth-pade", "fake") for st in (True,
                                                                  False)]


def _cell_values(pbc, kw):
    out = {}
    for sp, st in CELL_CASES:
        cell = _pp_cell(pbc, sp, st, kw)
        if sp == "gth-pade":
            out[sp, st] = np.array(cell.intor_hcore())
        else:
            out[sp, st] = cell._pp_sr_matrix()
    return out


@pytest.fixture(scope="module")
def values():
    from libdmet_preview_tpu.ints import gth as jgth, md as jmd
    from libdmet_preview_tpu.ints import pbc as jpbc
    from libdmet_preview_tpu_torch.ints import gth as tgth, md as tmd
    from libdmet_preview_tpu_torch.ints import pbc as tpbc
    with ThreadPoolExecutor(2) as ex:
        fj = ex.submit(_blocks, jmd, jgth)
        fc = ex.submit(_cell_values, jpbc, {})
        port = (_blocks(tmd, tgth), _cell_values(tpbc, {"device": CPU}))
        jax = (fj.result(), fc.result())
    return jax, port


BLOCK_KEYS = ([("projector_cart", l, i) for l, i in PROJ]
              + [("_h_full", l) for l in (0, 1, 2)]
              + [(f, l1, l2) for f in ("gauss_block", "gth_loc_sr_block",
                                       "gth_nl_block")
                 for l1 in (0, 1, 2) for l2 in (0, 1)]
              + ["gth_pp_molecular"])


@pytest.mark.parametrize("key", BLOCK_KEYS, ids=str)
def test_gth_blocks_match_jax(values, key):
    a, b = values[0][0][key], values[1][0][key]
    assert set(values[1][0]) == set(BLOCK_KEYS)
    assert a.shape == b.shape and np.abs(a - b).max() < TOL


@pytest.mark.parametrize("species,stripe", CELL_CASES)
def test_pseudo_cell_matches_jax(values, species, stripe):
    a, b = values[0][1][species, stripe], values[1][1][species, stripe]
    assert np.abs(a - b).max() < TOL, np.abs(a - b).max()


@pytest.mark.parametrize("species", ["gth-pade", "fake"])
def test_pseudo_cell_stripe_equals_dense(values, species):
    port = values[1][1]
    d = np.abs(port[species, True] - port[species, False]).max()
    assert d < TOL, d


def test_pseudo_cell_uses_the_native_core():
    from libdmet_preview_tpu_torch.ints import native
    assert native.get_sr_lib() is not None


# ----------------------------------------------------------------------
# tests/test_gth.py's quadrature oracles, on the port alone
# (workloads.gth_quadrature_errors, which chip_smoke.py phase 14a runs)
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def quadrature():
    from libdmet_preview_tpu_torch import workloads as wl
    return wl.gth_quadrature_errors()


def test_local_gaussian_terms_vs_quadrature(quadrature):
    """C1 Gaussian and complex-step C2 r^2 terms (s and p bras)."""
    assert quadrature[0] < 1e-9


def test_nonlocal_channels_vs_quadrature(quadrature):
    """s (two radial projectors), p and d channels (s and p bras)."""
    assert quadrature[1] < 1e-8
