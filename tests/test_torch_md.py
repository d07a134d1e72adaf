"""
The PyTorch port's general-l McMurchie-Davidson engine
(libdmet_preview_tpu_torch/ints/md.py, host NumPy) against the JAX
package's ints/md.py: the MoleGeneral matrices of H2O / STO-3G, the shell
blocks of the p/d derivative oracle of tests/test_md.py, image sums over
lattice translations, and the H2O / STO-3G RHF anchor through the port's
SCF on the CPU.

Tolerances: every block and matrix 1e-12 against JAX; the s-only limit
against the port's s engine 1e-13; the RHF anchor -74.9611711378677 at
the JAX suite's 1e-8.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)
A_BOHR = 1.0 / 0.52917720859
H2O = [("O", (0, 0, 0)), ("H", (0, 0, A_BOHR)), ("H", (0, A_BOHR, 0))]
TOL = 1e-12


@pytest.fixture(scope="module")
def h2o():
    from libdmet_preview_tpu.ints.md import MoleGeneral as J
    from libdmet_preview_tpu_torch.ints.md import MoleGeneral as T
    return J(H2O, basis="sto-3g"), T(H2O, basis="sto-3g")


def test_molegeneral_matrices_match_jax(h2o):
    mj, mt = h2o
    assert (mt.nao, mt.nelectron) == (mj.nao, mj.nelectron) == (7, 10)
    assert mt.shell_slices == mj.shell_slices
    assert mt.ao_slices_by_atom() == mj.ao_slices_by_atom()
    for name in ("intor_ovlp", "intor_kin", "intor_nuc", "intor_eri",
                 "intor_dipole"):
        assert np.abs(getattr(mj, name)() - getattr(mt, name)()).max() \
            < TOL, name
    assert abs(mj.energy_nuc() - mt.energy_nuc()) < TOL


def test_s_limit_equals_the_s_engine():
    from libdmet_preview_tpu_torch.ints.gto import Mole
    from libdmet_preview_tpu_torch.ints.md import MoleGeneral
    atoms = [("H", (0.1, -0.2, 0)), ("H", (0.3, 0.2, 1.4))]
    m1, m2 = Mole(atoms, basis="3-21g"), MoleGeneral(atoms, basis="3-21g")
    for name in ("intor_ovlp", "intor_kin", "intor_nuc", "intor_eri"):
        assert np.abs(getattr(m1, name)() - getattr(m2, name)()).max() \
            < 1e-13, name


def _shells(md):
    A = np.array([0.1, -0.3, 0.2])
    return [md.Shell(A, l, [(0.8, 1.0), (0.3, 0.4)]) for l in (0, 1, 2)], \
        md.Shell(np.array([1.0, 0.5, -0.4]), 1, [(0.5, 1.0)]), \
        md.Shell(np.array([-0.6, 0.8, 1.1]), 0, [(1.2, 1.0)]), \
        md.Shell(np.array([0.4, -0.9, 0.3]), 2, [(0.9, 1.0)])


def test_shell_blocks_match_jax():
    """Every block of the derivative oracle (S, T, V, V erf-screened, ERI)
    and the dipole / Gaussian-power blocks, s, p and d on one centre."""
    from libdmet_preview_tpu.ints import md as jmd
    from libdmet_preview_tpu_torch.ints import md as tmd
    charges = [1.0, 2.0]
    coords = [np.array([0.5, 0.5, 0.5]), np.array([-1.0, 0.0, 0.0])]
    sa_j, (sb_j, sc_j, sd_j) = _shells(jmd)[0], _shells(jmd)[1:]
    sa_t, (sb_t, sc_t, sd_t) = _shells(tmd)[0], _shells(tmd)[1:]
    for sj, st in zip(sa_j, sa_t):
        pairs = [
            (jmd.ovlp_block(sj, sb_j), tmd.ovlp_block(st, sb_t)),
            (jmd.kin_block(sj, sb_j), tmd.kin_block(st, sb_t)),
            (jmd.nuc_block(sj, sb_j, charges, coords),
             tmd.nuc_block(st, sb_t, charges, coords)),
            (jmd.nuc_block(sj, sb_j, charges, coords, eta=0.7,
                           screen="erf"),
             tmd.nuc_block(st, sb_t, charges, coords, eta=0.7,
                           screen="erf")),
            (jmd.eri_block(sj, sb_j, sc_j, sd_j),
             tmd.eri_block(st, sb_t, sc_t, sd_t)),
            (jmd.dipole_block(sj, sb_j), tmd.dipole_block(st, sb_t)),
            (jmd.gauss_pow_block(sj, sb_j, 0.6, coords[0], k=2),
             tmd.gauss_pow_block(st, sb_t, 0.6, coords[0], k=2)),
        ]
        for a, b in pairs:
            assert np.abs(np.asarray(a) - np.asarray(b)).max() < TOL
    assert np.abs(jmd.boys(3, np.logspace(-4, 2, 30))
                  - tmd.boys(3, np.logspace(-4, 2, 30))).max() < TOL


def test_image_sums_match_jax():
    """The lattice image sums the periodic engine builds on: overlap,
    kinetic and nuclear attraction summed over 27 translations."""
    from libdmet_preview_tpu.ints import md as jmd
    from libdmet_preview_tpu_torch.ints import md as tmd
    a = 3.5
    shifts = np.array([[i, j, k] for i in (-1, 0, 1) for j in (-1, 0, 1)
                       for k in (-1, 0, 1)], dtype=float) * a
    charges = [1.0, 1.0]
    coords = [np.zeros(3), np.array([0.0, 0.0, 1.4])]
    sa_j, sb_j = _shells(jmd)[0][1], _shells(jmd)[3]
    sa_t, sb_t = _shells(tmd)[0][1], _shells(tmd)[3]
    for fj, ft in (
            (lambda: jmd.ovlp_block_imgs(sa_j, sb_j, shifts),
             lambda: tmd.ovlp_block_imgs(sa_t, sb_t, shifts)),
            (lambda: jmd.kin_block_imgs(sa_j, sb_j, shifts),
             lambda: tmd.kin_block_imgs(sa_t, sb_t, shifts)),
            (lambda: jmd.nuc_block_imgs(sa_j, sb_j, charges, coords, shifts),
             lambda: tmd.nuc_block_imgs(sa_t, sb_t, charges, coords,
                                        shifts))):
        a_, b_ = np.asarray(fj()), np.asarray(ft())
        assert a_.shape == b_.shape
        assert np.abs(a_ - b_).max() < TOL


def test_h2o_sto3g_rhf_anchor(h2o):
    from libdmet_preview_tpu_torch.models.integral import Integral
    from libdmet_preview_tpu_torch.solvers.scf import SCF
    mol = h2o[1]
    Ham = Integral(mol.nao, True, False, mol.energy_nuc(),
                   {"cd": mol.intor_hcore()[None]},
                   {"ccdd": mol.intor_eri()[None]}, ovlp=mol.intor_ovlp())
    m = SCF(device=torch.device("cpu"))
    m.set_system(10, 0, False, True)
    m.set_integral(Ham)
    E, _ = m.HF(tol=1e-12, MaxIter=200)
    assert abs(E - (-74.9611711378677)) < 1e-8
