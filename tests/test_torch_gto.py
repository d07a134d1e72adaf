"""
The PyTorch port's s-shell Gaussian engine (libdmet_preview_tpu_torch/
ints/gto.py and its native core ints/native.py + csrc/_gto_core.cpp)
against the JAX package's ints/gto.py, on H2, the H atom and the 3-cell x
2-atom H ring.  Host NumPy on both sides.

Tolerances: S, T, V, hcore, ERI, cross_ovlp, boys0, h_ring 1e-13 against
JAX; the native ERI against the NumPy loop eri_s_numpy 1e-13; the port's
engine against the ring arrays the JAX engine wrote to
libdmet_preview_tpu_torch/data/ (hring_3x2_r1.8_{sto-6g,3-21g}.npz) 1e-12.
"""

import numpy as np
import pytest

TOL = 1e-13

SYSTEMS = {
    "h2-sto-6g": ([("H", (0, 0, 0)), ("H", (0, 0, 1.4))], "sto-6g"),
    "h2-3-21g": ([("H", (0.1, -0.2, 0)), ("H", (0.3, 0.2, 1.4))], "3-21g"),
    "h-minao": ([("H", (0, 0, 0))], "minao"),
    "ring6-3-21g": (None, "3-21g"),
}


def _atoms(key):
    from libdmet_preview_tpu_torch.ints.gto import h_ring
    atoms, basis = SYSTEMS[key]
    return (h_ring(6, 1.8) if atoms is None else atoms), basis


@pytest.mark.parametrize("key", sorted(SYSTEMS))
def test_mole_integrals_match_jax(key):
    from libdmet_preview_tpu.ints import gto as jg
    from libdmet_preview_tpu_torch.ints import gto as tg
    atoms, basis = _atoms(key)
    mj, mt = jg.Mole(atoms, basis), tg.Mole(atoms, basis)
    assert (mt.nao, mt.nelectron) == (mj.nao, mj.nelectron)
    for name in ("intor_ovlp", "intor_kin", "intor_nuc", "intor_hcore",
                 "intor_eri"):
        a, b = getattr(mj, name)(), getattr(mt, name)()
        assert np.abs(a - b).max() < TOL, name
    assert abs(mj.energy_nuc() - mt.energy_nuc()) < TOL
    # the first call's result is kept: a second call and a caller's edit
    # of the returned copy change nothing
    S = mt.intor_ovlp()
    S[0, 0] = 7.0
    assert np.abs(mt.intor_ovlp() - mj.intor_ovlp()).max() < TOL


def test_native_core_matches_numpy_loop():
    from libdmet_preview_tpu_torch.ints import gto, native
    atoms, basis = _atoms("ring6-3-21g")
    mol = gto.Mole(atoms, basis)
    assert native.get_lib() is not None, "g++ could not build the core"
    eri_n = native.eri_s_shells(mol.shells)
    eri_p = gto.eri_s_numpy(mol.shells)
    assert np.abs(eri_n - eri_p).max() < TOL
    # 8-fold symmetry
    assert np.abs(eri_n - eri_n.transpose(1, 0, 2, 3)).max() == 0.0
    assert np.abs(eri_n - eri_n.transpose(2, 3, 0, 1)).max() == 0.0


def test_cross_ovlp_boys_h_ring_match_jax():
    from libdmet_preview_tpu.ints import gto as jg
    from libdmet_preview_tpu_torch.ints import gto as tg
    atoms = tg.h_ring(6, 1.8)
    assert np.abs(np.asarray([x for _, x in atoms])
                  - np.asarray([x for _, x in jg.h_ring(6, 1.8)])).max() \
        < TOL
    S12j = jg.cross_ovlp(jg.Mole(atoms, "3-21g"), jg.Mole(atoms, "sto-6g"))
    S12t = tg.cross_ovlp(tg.Mole(atoms, "3-21g"), tg.Mole(atoms, "sto-6g"))
    assert np.abs(S12j - S12t).max() < TOL
    x = np.concatenate([[0.0, 1e-14, 1e-12, 1e-6], np.logspace(-3, 2, 40)])
    assert np.abs(jg.boys0(x) - tg.boys0(x)).max() < TOL
    mt = tg.h_ring_mole(6, 1.8, "sto-6g")
    assert mt.basis_name == "sto-6g" and mt.nao == 6


@pytest.mark.parametrize("basis", ["sto-6g", "3-21g"])
def test_engine_reproduces_the_stored_ring_arrays(basis):
    """mole_engine_ints of the port's ring == the .npz the JAX engine
    wrote (1e-12): a port user no longer needs the files for the ring."""
    from libdmet_preview_tpu_torch.ints.gto import h_ring_mole
    from libdmet_preview_tpu_torch.models.engine_ints import (
        load_engine_ints, mole_engine_ints)
    ref = load_engine_ints("hring_3x2_r1.8_%s.npz" % basis)
    got = mole_engine_ints(h_ring_mole(6, 1.8, basis), ncells=3,
                           minimal_ref="sto-6g")
    for k in ("e_nuc", "nelectron", "natom", "nao_atom", "ncells"):
        assert abs(float(getattr(got, k)) - float(getattr(ref, k))) < 1e-12
    for k in ("S", "hcore", "eri", "S12", "S2"):
        assert getattr(got, k).shape == getattr(ref, k).shape
        assert np.abs(getattr(got, k) - getattr(ref, k)).max() < 1e-12, k


def test_molecule_lattice_from_a_mole_matches_jax():
    """make_molecule_lattice of a port Mole == of its EngineInts, and the
    JAX package's of the same molecule (E_hf 1e-10); the Mole is kept in
    meta["mole"]."""
    import torch
    from libdmet_preview_tpu.ints.gto import Mole as JMole
    from libdmet_preview_tpu.models.abinitio import make_molecule_lattice as J
    from libdmet_preview_tpu_torch.ints.gto import Mole
    from libdmet_preview_tpu_torch.models.abinitio import (
        make_molecule_lattice, mole_engine_ints)
    cpu = torch.device("cpu")
    atoms, basis = _atoms("h2-3-21g")
    mol = Mole(atoms, basis)
    Lat, meta = make_molecule_lattice(mol, device=cpu)
    _, meta_i = make_molecule_lattice(mole_engine_ints(mol), device=cpu)
    _, meta_j = J(JMole(atoms, basis))
    assert meta["mole"] is mol and "mole" not in meta_i
    assert abs(meta["E_hf"] - meta_i["E_hf"]) < 1e-12
    assert abs(meta["E_hf"] - meta_j["E_hf"]) < 1e-10
