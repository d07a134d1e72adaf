"""
The engine-array files of the PyTorch port (libdmet_preview_tpu_torch/
data/*.npz, the input of its ab initio lattice builders) against the JAX
package's integral engine as it stands: each file's arrays are rebuilt
with scripts/dump_engine_ints_torch.py's builders and must agree to 1e-12.
A change to libdmet_preview_tpu/ints/ then fails here, and the files are
regenerated with

    JAX_PLATFORMS=cpu python scripts/dump_engine_ints_torch.py
"""

import importlib.util
import os

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _script():
    spec = importlib.util.spec_from_file_location(
        "dump_engine_ints_torch",
        os.path.join(ROOT, "scripts", "dump_engine_ints_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SCRIPT = _script()


@pytest.mark.parametrize("name", sorted(SCRIPT.FILES))
def test_engine_array_file_matches_the_engine(name):
    from libdmet_preview_tpu_torch.models.engine_ints import (DATA_DIR,
                                                              load_engine_ints)
    stored = load_engine_ints(name)
    assert os.path.dirname(os.path.abspath(
        os.path.join(DATA_DIR, name))) == os.path.join(
            ROOT, "libdmet_preview_tpu_torch", "data")
    fresh = SCRIPT.FILES[name]()
    assert SCRIPT.max_diff(fresh, stored) <= 1e-12
    # the layout the factories rely on
    assert stored.natom * stored.nao_atom == stored.nao
    assert stored.natom % stored.ncells == 0
    assert stored.S12.shape == (stored.nao, stored.S2.shape[0])
    assert np.allclose(stored.eri, stored.eri.transpose(1, 0, 2, 3))
    assert np.allclose(stored.eri, stored.eri.transpose(2, 3, 0, 1))


def test_engine_ints_round_trip(tmp_path):
    from libdmet_preview_tpu_torch.models.engine_ints import (
        EngineInts, load_engine_ints, save_engine_ints)
    rng = np.random.RandomState(0)
    a = EngineInts(S=np.eye(2), hcore=rng.randn(2, 2),
                   eri=rng.randn(2, 2, 2, 2), e_nuc=0.5, nelectron=2,
                   natom=2, nao_atom=1, ncells=2, source="random")
    path = str(tmp_path / "x.npz")
    save_engine_ints(path, a)
    b = load_engine_ints(path)
    assert b.S12 is None and b.S2 is None and b.source == "random"
    assert SCRIPT.max_diff(a, b) == 0.0
    for k in ("S", "hcore", "eri"):
        assert np.array_equal(getattr(a, k), getattr(b, k))
    assert (b.e_nuc, b.nelectron, b.natom, b.nao_atom, b.ncells) == \
        (0.5, 2, 2, 1, 2)
