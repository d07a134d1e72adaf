"""
The periodic H chain built by the PyTorch port's own cell
(libdmet_preview_tpu_torch/ints/pbc.py make_hchain_supercell ->
models/engine_ints.cell_engine_ints -> models/abinitio's H-chain
factories) against the engine arrays the JAX engine wrote
(libdmet_preview_tpu_torch/data/hchain_nk3_nH2_R1.5_vac10_3-21g.npz), on
the CPU:

  * cell_engine_ints at nk = 3: S, hcore, the range-separated ERI, S12 and
    S2 against MINAO within 1e-12 of the file, e_nuc 1e-12, the layout
    equal, and the JAX engine's recorded norms (workloads.PBC_JAX) 1e-10
    relative;
  * make_hchain_pbc_lattice(cell) == make_hchain_pbc_lattice(the file):
    E_hf and the LO density stripes within 1e-10; with IAOs, the h / Fock
    stripes and the Cholesky factors by their ERI within SCF_TOL = 5e-8,
    and the same for the UHF lattice.  The IAOs follow the SCF's occupied
    space, which both routes leave at ||[F, D]|| < 1e-6: the one-ulp
    differences of the two integral sets (2e-16) move them by 1e-8 (the
    same route run twice is bit-identical).  With Lowdin orbitals, which
    do not follow the SCF, the h stripes agree to 1e-12;
  * the interacting-bath FCI loop from the cell at the reference anchor
    (1e-4) and the JAX loop's value (workloads.IB_JAX_TOL), and the UHF
    non-interacting bath at its anchor (5e-5).
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(2)
CPU = torch.device("cpu")
TOL = 1e-10
SCF_TOL = 5e-8     # what follows the SCF's occupied space (docstring)


def _n(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


@pytest.fixture(scope="module")
def cell():
    from libdmet_preview_tpu_torch import workloads as wl
    return wl.hchain_cell(3, CPU)


@pytest.fixture(scope="module")
def npz():
    from libdmet_preview_tpu_torch import workloads as wl
    from libdmet_preview_tpu_torch.models.engine_ints import load_engine_ints
    return load_engine_ints(wl.HCHAIN_FILE)


def test_cell_engine_ints_equal_the_jax_engine_file(cell, npz):
    from libdmet_preview_tpu_torch import workloads as wl
    from libdmet_preview_tpu_torch.models.engine_ints import cell_engine_ints
    ints = cell_engine_ints(cell)
    for k in ("S", "hcore", "eri", "S12", "S2"):
        a, b = getattr(ints, k), getattr(npz, k)
        assert a.shape == b.shape and np.abs(a - b).max() < 1e-12, k
    assert abs(ints.e_nuc - npz.e_nuc) < 1e-12
    for k in ("nelectron", "natom", "nao_atom", "ncells"):
        assert getattr(ints, k) == getattr(npz, k), k
    ref = wl.PBC_JAX[3]
    got = {"nao": ints.nao, "e_nuc": ints.e_nuc,
           "S_fro": np.linalg.norm(ints.S),
           "hcore_fro": np.linalg.norm(ints.hcore),
           "eri_fro": np.linalg.norm(ints.eri.reshape(-1))}
    for k, v in got.items():
        assert abs(v - ref[k]) <= TOL * abs(ref[k]), k


def _chol_eri(L):
    L = _n(L)
    return np.einsum("xpq, xrs -> pqrs", L, L)


@pytest.mark.parametrize("uhf", [False, True])
def test_lattice_from_the_cell_equals_the_file_route(cell, npz, uhf):
    from libdmet_preview_tpu_torch import workloads as wl
    Lc, mc = wl.hchain_lattice(cell, CPU, uhf=uhf)
    Lf, mf = wl.hchain_lattice(npz, CPU, uhf=uhf)
    assert mc["cell"] is cell and "cell" not in mf
    assert abs(mc["E_hf"] - mf["E_hf"]) < TOL
    for k, tol in (("hcore_lo_R", SCF_TOL), ("fock_lo_R", SCF_TOL),
                   ("rdm1_lo_R", TOL)):
        assert np.abs(_n(getattr(Lc, k)) - _n(getattr(Lf, k))).max() \
            < tol, k
    if uhf:
        assert Lc.chol_L is None and Lf.chol_L is None
        for a, b in zip(mc["eri_lo"], mf["eri_lo"]):
            assert np.abs(_n(a) - _n(b)).max() < SCF_TOL
    else:
        assert np.abs(_chol_eri(Lc.chol_L) - _chol_eri(Lf.chol_L)).max() \
            < SCF_TOL
    if not uhf:
        # the JAX engine's supercell RHF energy on its own integrals
        assert abs(mc["E_hf"] - wl.PBC_JAX[3]["E_hf"]) < TOL


def test_lowdin_lattice_from_the_cell_equals_the_file_route(cell, npz):
    from libdmet_preview_tpu_torch.models.abinitio import \
        make_hchain_pbc_lattice
    Lc, mc = make_hchain_pbc_lattice(cell, localization="lowdin", device=CPU)
    Lf, mf = make_hchain_pbc_lattice(npz, localization="lowdin", device=CPU)
    assert abs(mc["E_hf"] - mf["E_hf"]) < TOL
    assert np.abs(_n(Lc.hcore_lo_R) - _n(Lf.hcore_lo_R)).max() < 1e-12


def test_ib_fci_loop_from_the_cell(cell):
    from libdmet_preview_tpu_torch import workloads as wl
    Lat, meta = wl.hchain_lattice(cell, CPU)
    E, recs = wl.run_hchain_dmet(Lat, meta, wl.hchain_solver("FCI", CPU),
                                 wl.IB_PROTOCOL)
    ref, tol = wl.HCHAIN_ANCHORS["IB FCI"]
    assert abs(E - ref) < tol
    assert abs(E - wl.HCHAIN_JAX["IB FCI"]) <= wl.IB_JAX_TOL
    assert len(recs) == wl.PBC_JAX[3]["iterations"]


def test_nib_uhf_from_the_cell(cell):
    from libdmet_preview_tpu_torch import workloads as wl
    E, afm, hf_err = wl.run_hchain_nib_uhf(cell, CPU)
    ref, tol = wl.HCHAIN_ANCHORS["NIB UHF"]
    assert abs(E - ref) < tol
    assert afm > 0.3 and hf_err < 1e-7
