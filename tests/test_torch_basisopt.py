"""
The PyTorch port's generated GTH valence bases (libdmet_preview_tpu_torch/
ints/basisopt.py, host NumPy over the port's MoleGeneral and GTH
pseudopotentials) against the JAX package's ints/basisopt.py on the CPU,
and against the generated sets the repository ships
(libdmet_preview_tpu_torch/ints/_basis_cache/, copies of the JAX
package's):

  * _even_tempered for every element, atomic_rhf_frac (energy and
    contraction columns) for H and Li, make_gth_valence_basis(cache=
    False) for H, Li, O and make_gth_dzvp_basis(cache=False) for H and O,
    and _pol_exponent: 1e-12 against JAX;
  * the H and Li tpu-szv and the H tpu-dzvp sets regenerated against the
    shipped JSONs (1e-12); the port's JSONs byte-equal to the JAX
    package's (the C, N, O and Si sets were written by an earlier
    generator: the current one moves their coefficients by up to 0.8, in
    the JAX package as well, so the files are read, not regenerated);
  * on the port alone, tests/test_basisopt_dzvp.py's oracles
    (workloads.gth_rhf, the GTH RHF that chip_smoke.py phase 14a runs): on
    H2 with GTH, the DZVP set lies more than 10 mHa below the SZV set, below
    -1.105 Ha, with a well-conditioned overlap, and its structure (one
    free outer zeta per channel, one polarization shell of l_max + 1 with
    a dipole-rule exponent in (0.3, 3)).
"""

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

torch.set_num_threads(1)
TOL = 1e-12
ATOMIC = ("H", "Li")       # O's atomic HF runs inside its SZV and DZVP
SZV = ("H", "Li", "O")
DZVP = ("H", "O")


def _flat(shells):
    return np.asarray([x for l, prims in shells for p in prims
                       for x in (l,) + tuple(p)])


def _values(bo):
    out = {}
    for sym in sorted(bo.VALENCE_CONF):
        for floor in (None, 0.15):
            et = bo._even_tempered(sym, floor=floor)
            out["even_tempered", sym, floor] = np.concatenate(
                [np.r_[l, es] for l, es in sorted(et.items())])
    for sym in ATOMIC:
        E, contr = bo.atomic_rhf_frac(sym, bo._even_tempered(sym))
        out["atomic_rhf_frac", sym] = np.concatenate(
            [[E]] + [np.r_[l, es, cols.ravel()] for l, es, cols in contr])
    for sym in SZV:
        out["szv", sym] = _flat(bo.make_gth_valence_basis(sym, cache=False))
    for sym in DZVP:
        out["dzvp", sym] = _flat(bo.make_gth_dzvp_basis(sym, cache=False))
    out["pol_exponent"] = np.asarray([bo._pol_exponent(
        1, [0.3, 1.1, 4.0], [0.5, 0.4, 0.2], 2)])
    return out


KEYS = ([("even_tempered", s, f) for s in
         ("C", "Cu", "H", "Li", "N", "Ni", "O", "Si") for f in (None, 0.15)]
        + [("atomic_rhf_frac", s) for s in ATOMIC] + [("szv", s) for s in SZV]
        + [("dzvp", s) for s in DZVP] + ["pol_exponent"])


@pytest.fixture(scope="module")
def values():
    from libdmet_preview_tpu.ints import basisopt as jbo
    from libdmet_preview_tpu_torch.ints import basisopt as tbo
    with ThreadPoolExecutor(1) as ex:
        fj = ex.submit(_values, jbo)
        port = _values(tbo)
        return fj.result(), port


@pytest.mark.parametrize("key", KEYS, ids=str)
def test_basisopt_matches_jax(values, key):
    jax, port = values
    assert set(port) == set(KEYS)
    assert jax[key].shape == port[key].shape
    assert np.abs(jax[key] - port[key]).max() < TOL


@pytest.mark.parametrize("kind,sym", [("szv", "H"), ("szv", "Li"),
                                      ("dzvp", "H")])
def test_generated_sets_match_the_shipped_json(values, kind, sym):
    from libdmet_preview_tpu_torch.ints import basisopt as bo
    make = bo.make_gth_valence_basis if kind == "szv" \
        else bo.make_gth_dzvp_basis
    shipped = _flat(make(sym))              # read from _basis_cache
    assert shipped.shape == values[1][kind, sym].shape
    assert np.abs(shipped - values[1][kind, sym]).max() < TOL


def test_shipped_json_equal_the_jax_package_files():
    from libdmet_preview_tpu import ints as jints
    from libdmet_preview_tpu_torch.ints import basisopt as bo
    jdir = os.path.join(os.path.dirname(jints.__file__), "_basis_cache")
    names = sorted(os.listdir(jdir))
    assert names == sorted(os.listdir(bo._CACHE_DIR))
    for name in names:
        with open(os.path.join(jdir, name), "rb") as a, \
                open(os.path.join(bo._CACHE_DIR, name), "rb") as b:
            assert a.read() == b.read(), name


def test_dzvp_h2_variational():
    from libdmet_preview_tpu_torch import workloads as wl
    from libdmet_preview_tpu_torch.ints.basisopt import (
        make_gth_dzvp_basis, make_gth_valence_basis)
    atoms = [("H", (0.0, 0.0, 0.0)), ("H", (0.0, 0.0, 1.4))]
    E_szv, _ = wl.gth_rhf(atoms, {("H", "tpu-szv"):
                                  make_gth_valence_basis("H")}, 2)
    E_dzvp, S = wl.gth_rhf(atoms, {("H", "tpu-dzvp"):
                                   make_gth_dzvp_basis("H")}, 2)
    assert E_dzvp < E_szv - 0.010
    assert E_dzvp < -1.105
    assert np.linalg.eigvalsh(S).min() > 1e-6


@pytest.mark.parametrize("sym,l_pol", [("H", 1), ("O", 2)])
def test_dzvp_structure(sym, l_pol):
    from libdmet_preview_tpu_torch.ints.basisopt import (
        make_gth_dzvp_basis, make_gth_valence_basis)
    szv, dz = make_gth_valence_basis(sym), make_gth_dzvp_basis(sym)
    n_channels = len({l for l, _ in szv})
    assert len(dz) == len(szv) + n_channels + 1
    assert dz[-1][0] == l_pol and len(dz[-1][1]) == 1
    assert 0.3 < dz[-1][1][0][0] < 3.0
    assert len([p for l, p in dz if len(p) == 1 and l != l_pol]) \
        == n_channels
