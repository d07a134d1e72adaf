"""
The PyTorch port's host analysis (libdmet_preview_tpu_torch/utils/
analysis.py) against the JAX package's utils/analysis.py on the same
NumPy inputs, and on the oracles of the JAX suite's tests/test_analysis.py
and tests/test_molecule.py (Mulliken, bond orders, DOS, order parameters,
spin correlations, bond pairs, bands, Fermi surface, ELF, symmetry
orbitals, MO composition, molecular populations, dipoles and fragments).
Each function's output equals JAX's to 1e-12 (the same NumPy code but
for the ELF's AO values, which the port evaluates with torch); a tensor
input gives the array result.  get_bands raises for array stripes with a
2D or 3D k-path, where the JAX package's docstring promises a mesh order
its code does not build.  Last, each package facade exports the JAX
package's names.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)
CPU = torch.device("cpu")
TOL = 1e-12


def _both(name):
    from libdmet_preview_tpu.utils import analysis as J
    from libdmet_preview_tpu_torch.utils import analysis as T
    return getattr(J, name), getattr(T, name)


def _close(a, b, tol=TOL):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _close(a[k], b[k], tol)
    elif isinstance(a, (tuple, list)) and not np.isscalar(a):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _close(x, y, tol)
    else:
        assert isinstance(b, (np.ndarray, float, int, np.floating,
                              np.integer, str)), type(b)
        assert np.shape(a) == np.shape(b)
        if isinstance(a, str):
            assert a == b
        else:
            assert np.max(np.abs(np.asarray(a) - np.asarray(b)),
                          initial=0.0) <= tol


RDM = np.asarray([np.diag([0.9, 0.1]), np.diag([0.1, 0.9])])


@pytest.mark.parametrize("case", [
    ("mulliken_lo", (RDM,), {}),
    ("mulliken_lo", (RDM[0],), {}),
    ("mulliken_lo", (RDM[:1],), {"labels": ["a", "b"]}),
    ("get_order_param_afm", (RDM,), {}),
    ("bond_order", (RDM, 0, 1), {}),
    ("bond_order", (RDM[0], 0, 0), {}),
    ("spin_corr_mean_field", (RDM, 0, 1), {}),
    ("spin_corr_mean_field", (RDM, 1, 1), {}),
    ("get_dos", (np.asarray([-1.0, 0.0, 1.0]),), {"sigma": 0.05,
                                                   "nw": 2000}),
    ("get_fermi_surface", (np.asarray([[0.0, 1.0], [0.5, 2.0]]),),
     {"mu": 0.0, "sigma": 0.1}),
    ("k_path", (np.asarray([[0.0, 0.0], [0.5, 0.0], [0.5, 0.5]]),),
     {"n_per_seg": 7}),
], ids=lambda c: c[0] + "/" + str(len(c[2])) + str(np.shape(c[1][0])))
def test_small_functions_match_jax(case):
    name, args, kw = case
    fj, ft = _both(name)
    _close(fj(*args, **kw), ft(*args, **kw))
    targs = tuple(torch.as_tensor(a) if isinstance(a, np.ndarray) else a
                  for a in args)
    _close(fj(*args, **kw), ft(*targs, **kw))


def test_mulliken_and_orders_oracles():
    """tests/test_analysis.py::test_mulliken_and_orders on the port."""
    from libdmet_preview_tpu_torch.utils.analysis import (
        mulliken_lo, get_order_param_afm, bond_order, get_dos,
        spin_corr_mean_field)
    pop, charge, spin_d = mulliken_lo(torch.as_tensor(RDM))
    assert np.allclose(charge, [1.0, 1.0])
    assert np.allclose(spin_d, [0.8, -0.8])
    assert abs(get_order_param_afm(RDM) - 0.4) < 1e-12
    ws, dos = get_dos(np.asarray([-1.0, 0.0, 1.0]), sigma=0.05, nw=2000)
    assert abs(np.trapezoid(dos, ws) - 3.0) < 1e-3
    c = np.ones((2, 1)) / np.sqrt(2)
    d = c @ c.T
    assert abs(bond_order(np.asarray([d, d]), 0, 1) - 1.0) < 1e-12
    assert spin_corr_mean_field(RDM, 0, 1) < 0


def test_sc_order_param_matches_jax():
    fj, ft = _both("get_order_param_sc")
    nao = 2
    kappa = np.diag([0.3, 0.3])
    GRho = np.zeros((2 * nao, 2 * nao))
    GRho[:nao, nao:] = kappa
    GRho[nao:, :nao] = kappa.T
    assert abs(ft(torch.as_tensor(GRho)) - 0.3) < 1e-12
    assert abs(ft(GRho) - fj(GRho)) < TOL


def test_spin_corr_from_rdm2_fci():
    """<Sz_0 Sz_1> of the 2-site Hubbard dimer from the port's FCI RDMs:
    the analytic ground-state value, the singlet limit at large U, and
    the JAX function on the same RDMs."""
    from libdmet_preview_tpu_torch import workloads as wl
    from libdmet_preview_tpu_torch.solvers.fci import FCI, make_rdm2s
    fj, ft = _both("spin_corr_from_rdm2")
    for U in (4.0, 40.0):
        fci = FCI(restricted=True, tol=1e-12, device=CPU)
        rdm1, _ = fci.run(wl.hubbard_integral(2, U=U), nelec=2)
        rdm2 = torch.stack(list(make_rdm2s(fci.ci, fci.norb, fci.nelec)))
        rdm1 = torch.cat([rdm1, rdm1]) if rdm1.shape[0] == 1 else rdm1
        w, v = np.linalg.eigh(np.array([[0.0, 2.0], [2.0, U]]))
        got = ft(rdm1, rdm2, 0, 1)
        assert abs(got - (-0.25 * v[0, 0] ** 2)) < 1e-8
        assert abs(got - fj(rdm1.numpy(), rdm2.numpy(), 0, 1)) < TOL
        if U == 40.0:
            assert got < -0.2


SQUARE = (np.array([[0., 0.], [1., 0.], [0., 1.], [1., 1.]]),
          np.diag([2.0, 2.0]), ["Cu"] * 4)


def test_bond_pairs_and_dwave_order_match_jax():
    """tests/test_analysis.py's torus bonds (8, 4 along x) and d-wave
    order (8 sqrt2 kappa; the s-wave cancels), in both packages."""
    fj, ft = _both("get_bond_pairs")
    oj, ot = _both("get_order_ab_initio")
    coords, cell, species = SQUARE
    kw = dict(cell=cell, species=species, bond_type=[("Cu", "Cu")],
              length_range=(0.5, 1.3))
    bj, bt = fj(coords, **kw), ft(coords, **kw)
    assert len(bt) == 8
    assert sum(1 for (_, _, v, _) in bt if abs(v[0]) > 1e-8) == 4
    _close([(i, j, v, d) for i, j, v, d in bj],
           [(i, j, v, d) for i, j, v, d in bt])
    kappa = 0.07
    rdm1_d = np.zeros((4, 4))
    for (i, j, v, _) in bt:
        rdm1_d[i, j] = rdm1_d[j, i] = (1.0 if abs(v[0]) > 1e-8 else -1.0) \
            * kappa
    offsets = [np.array([i]) for i in range(4)]
    for s_wave in (False, True):
        kw = dict(cell=cell, length_range=(0.5, 1.3), s_wave=s_wave)
        rj = oj(rdm1_d, coords, species, offsets, **kw)
        rt = ot(torch.as_tensor(rdm1_d), coords, species, offsets, **kw)
        _close(rj, rt)
    assert abs(ot(rdm1_d, coords, species, offsets, cell=cell,
                  length_range=(0.5, 1.3))["m_tot"]
               - 8 * np.sqrt(2) * kappa) < 1e-12


def test_checkerboard_order_matches_jax():
    fj, ft = _both("get_checkerboard_order")
    m = 0.31
    coords = np.array([[0., 0.], [1., 0.], [0., 1.], [1., 1.],
                       [0.5, 0.], [0.5, 1.]])
    species = ["Cu"] * 4 + ["O"] * 2
    offsets = [np.array([i]) for i in range(6)]
    na = np.array([0.5 + m, 0.5 - m, 0.5 - m, 0.5 + m, 0.95, 0.95])
    nb = np.array([0.5 - m, 0.5 + m, 0.5 + m, 0.5 - m, 0.95, 0.95])
    rdm1 = np.asarray([np.diag(na), np.diag(nb)])
    rj = fj(rdm1, coords, species, offsets, d_dd=1.0)
    rt = ft(torch.as_tensor(rdm1), coords, species, offsets, d_dd=1.0)
    _close(rj, rt)
    assert abs(rt["m_AFM"] - m) < 1e-12 and abs(rt["m_FM_Cu"]) < 1e-12
    assert np.allclose(rt["charge_O"], 1.9)
    # with an anomalous block: a Cu chain along x (its bonds are x bonds)
    line = np.array([[0., 0.], [1., 0.], [2., 0.], [3., 0.]])
    rdm1_d = np.zeros((4, 4))
    rdm1_d[0, 1] = rdm1_d[1, 0] = 0.05
    rdm1_d[2, 3] = rdm1_d[3, 2] = 0.02
    args = (line, ["Cu"] * 4, offsets[:4])
    rt = ft(rdm1[:, :4, :4], *args, d_dd=1.0, rdm1_d=torch.as_tensor(rdm1_d))
    _close(fj(rdm1[:, :4, :4], *args, d_dd=1.0, rdm1_d=rdm1_d), rt)
    assert abs(rt["m_SC"] - 0.07 * np.sqrt(2)) < 1e-12


def _tb_chain(N, t=1.0):
    h_R = np.zeros((N, 1, 1))
    h_R[1, 0, 0] = h_R[N - 1, 0, 0] = -t
    return h_R


def test_get_bands_matches_jax_and_the_tight_binding_band():
    fj, ft = _both("get_bands")
    kf = np.linspace(0.0, 0.5, 23)[:, None]
    h_R = _tb_chain(8)
    ew = ft(torch.as_tensor(h_R), kf)
    assert np.abs(ew[:, 0] + 2.0 * np.cos(2 * np.pi * kf[:, 0])).max() \
        < 1e-12
    _close(fj(h_R, kf), ew)
    rng = np.random.RandomState(0)
    h0 = rng.randn(2, 2)
    h_R = np.zeros((6, 2, 2))
    h_R[0] = h0 + h0.T
    s_R = np.zeros((6, 2, 2))
    s_R[0] = 2.0 * np.eye(2)
    kf = np.linspace(0, 1, 7)[:, None]
    e2 = ft(h_R, kf, ovlp_R=s_R)
    assert np.abs(e2 - ft(h_R, kf) / 2.0).max() < 1e-12
    _close(fj(h_R, kf, ovlp_R=s_R), e2)


def test_get_bands_2d_dict_matches_jax():
    """A 2D square lattice given as {R: block}: the band -2t (cos kx +
    cos ky) at off-mesh k, equal to JAX's dict branch."""
    fj, ft = _both("get_bands")
    h = {(0, 0): np.zeros((1, 1))}
    for R in ((1, 0), (-1, 0), (0, 1), (0, -1)):
        h[R] = -np.ones((1, 1))
    kf = np.random.RandomState(1).rand(9, 2)
    ew = ft(h, kf)
    ref = -2.0 * (np.cos(2 * np.pi * kf[:, 0]) + np.cos(2 * np.pi * kf[:, 1]))
    assert np.abs(ew[:, 0] - ref).max() < 1e-12
    _close(fj(h, kf), ew)


@pytest.mark.parametrize("dim", [2, 3])
def test_get_bands_raises_for_array_stripes_off_1d(dim):
    from libdmet_preview_tpu_torch.utils.analysis import get_bands
    with pytest.raises(ValueError, match="1D chain"):
        get_bands(np.zeros((4, 1, 1)), np.zeros((5, dim)))


def test_kdis_and_plot_bands(tmp_path):
    from libdmet_preview_tpu_torch.utils.analysis import (
        get_bands, k_path, get_kdis, plot_bands)
    kj, kt = _both("get_kdis")
    path = k_path(np.array([[0.0], [0.5]]), n_per_seg=12)
    kdis, kdis_sp = kt(path, kpts_sp=np.array([[0.0], [0.5]]))
    assert abs(kdis[-1] - 0.5) < 1e-12 and np.allclose(kdis_sp, [0.0, 0.5])
    _close(kj(path, kpts_sp=np.array([[0.0], [0.5]])), (kdis, kdis_sp))
    ew = get_bands(_tb_chain(6), path)
    out = plot_bands(str(tmp_path / "bands.png"), kdis, ew,
                     kdis_sp=kdis_sp, labels_sp=["G", "X"], e_fermi=0.0)
    if out is not None:
        assert (tmp_path / "bands.png").stat().st_size > 0


def test_dos_k_matches_jax():
    fj, ft = _both("get_dos_k")
    rng = np.random.RandomState(0)
    nk, nao = 4, 3
    e = rng.randn(nk, nao)
    ws, dos = ft(torch.as_tensor(e), sigma=0.05, nw=3000)
    assert np.allclose(dos.sum(axis=1) * (ws[1] - ws[0]), nao, atol=1e-2)
    _close(fj(e, sigma=0.05, nw=3000), (ws, dos))
    C = np.linalg.qr(rng.randn(nao, nao))[0]
    Ck = np.broadcast_to(C, (nk, nao, nao))
    _, dos2 = ft(e, Ck, ws=ws, sigma=0.05)
    assert np.abs(dos2 - dos).max() < 1e-8
    es = np.stack([e, e + 0.1])
    Cs = np.stack([Ck, Ck])
    _close(fj(es, Cs, ws=ws, sigma=0.05, idx=[0, 2]),
           ft(es, Cs, ws=ws, sigma=0.05, idx=[0, 2]))


def test_symm_orb_and_mo_composition_match_jax():
    sj, st = _both("get_symm_orb")
    perms = [np.roll(np.arange(6), 1), np.arange(6)[::-1]]   # C6v ring
    bj, bt = sj(perms), st(perms)
    assert [b.shape for b in bj] == [b.shape for b in bt]
    for b in bt:   # each block is invariant under every permutation
        for p in perms:
            P = np.eye(6)[p]
            proj = b @ b.T
            assert np.abs(P @ proj @ P.T - proj).max() < 1e-9
    _close([b @ b.T for b in bj], [b @ b.T for b in bt], 1e-10)
    cj, ct = _both("mo_composition")
    C = np.linalg.qr(np.random.RandomState(2).randn(5, 5))[0]
    groups = {"a": [0, 1], "b": [2, 3, 4]}
    wt = ct(torch.as_tensor(C), groups)
    assert np.allclose(wt["a"] + wt["b"], 1.0)
    _close(cj(C, groups), wt)
    _close(cj((C, 0.5 * C), groups), ct((C, 0.5 * C), groups))


def _h2o(pkg):
    import importlib
    md = importlib.import_module(pkg + ".ints.md")
    r, th = 1.809, np.deg2rad(104.52)
    atoms = [("O", (0.0, 0.0, 0.0)),
             ("H", (r * np.sin(th / 2), 0.0, r * np.cos(th / 2))),
             ("H", (-r * np.sin(th / 2), 0.0, r * np.cos(th / 2)))]
    return md.MoleGeneral(atoms, basis="sto-3g")


@pytest.fixture(scope="module")
def h2o_rhf():
    """H2O / STO-3G and its RHF density from the port's SCF on the CPU
    (tests/test_molecule.py's system)."""
    from libdmet_preview_tpu_torch.models.integral import Integral
    from libdmet_preview_tpu_torch.solvers.scf import SCF
    mol = _h2o("libdmet_preview_tpu_torch")
    Ham = Integral(mol.nao, True, False, mol.energy_nuc(),
                   {"cd": mol.intor_hcore()[None]},
                   {"ccdd": mol.intor_eri()[None]}, ovlp=mol.intor_ovlp())
    scf = SCF(device=CPU)
    scf.set_system(mol.nelectron, 0, False, True)
    scf.set_integral(Ham)
    _, dm = scf.HF(tol=1e-12, MaxIter=200)
    dm = torch.as_tensor(np.asarray(dm[0] + dm[1]))
    return mol, _h2o("libdmet_preview_tpu"), dm


def test_molecule_mulliken_and_fragments_match_jax(h2o_rhf):
    """tests/test_molecule.py::test_molecule_mulliken_and_equivalence on
    the port's MoleGeneral, and JAX's functions on its own molecule with
    the same density."""
    mol, mol_j, dm = h2o_rhf
    mj, mt = _both("mulliken_mol")
    pops, charges = mt(mol, dm)
    assert abs(charges.sum()) < 1e-9 and charges[0] < -0.2
    assert abs(charges[1] - charges[2]) < 1e-8
    _close(mj(mol_j, dm.numpy()), (pops, charges))
    ej, et = _both("equivalent_atoms")
    assert sorted(map(sorted, et(mol))) == [[0], [1, 2]]
    assert et(mol) == ej(mol_j)
    fj, ft = _both("molecule_fragments")
    frags = ft(mol)
    assert frags[0][1] == list(range(5)) and sorted(frags[1][1]) == [5, 6]
    assert frags == fj(mol_j)
    assert ft(mol, [[0, 1], [2]]) == fj(mol_j, [[0, 1], [2]])


def test_molecule_dipole_matches_jax(h2o_rhf):
    mol, mol_j, dm = h2o_rhf
    dj, dt = _both("dipole_mol")
    d = dt(mol, dm)
    assert abs(d[0]) < 1e-8 and abs(d[1]) < 1e-8 and 0.4 < d[2] < 0.9
    _close(dj(mol_j, dm.numpy()), d)
    _close(dj(mol_j, dm.numpy(), origin=np.zeros(3)),
           dt(mol, dm, origin=np.zeros(3)))


def test_elf_matches_jax_and_its_oracles():
    """ELF == 1 for one occupied orbital (He), 0 < ELF < 1 on the H4
    chain, and equal to JAX's ELF on the same points (1e-10: the AO
    values are evaluated by each package's own code)."""
    from libdmet_preview_tpu.ints.gto import Mole as JMole
    from libdmet_preview_tpu_torch.ints.gto import Mole
    fj, ft = _both("eval_elf")
    pts = np.random.RandomState(3).randn(40, 3)
    he = [("He", (0, 0, 0))]
    elf = ft(Mole(he, basis="sto-3g"), np.array([[2.0]]), pts, device=CPU)
    assert np.abs(elf - 1.0).max() < 1e-8
    h4 = [("H", (0, 0, z)) for z in (0.0, 1.4, 2.8, 4.2)]
    mol = Mole(h4, basis="sto-6g")
    S = np.asarray(mol.intor_ovlp())
    w, v = np.linalg.eigh(S)
    A = v @ np.diag(w ** -0.5) @ v.T
    _, c = np.linalg.eigh(A @ np.asarray(mol.intor_hcore()) @ A)
    C = A @ c
    dm = 2.0 * C[:, :2] @ C[:, :2].T
    line = np.array([[0.0, 0.0, z] for z in np.linspace(0.5, 3.5, 9)])
    elf = ft(mol, dm, torch.as_tensor(line))
    assert np.all(elf < 1.0 - 1e-6) and np.all(elf > 0.0)
    _close(fj(JMole(h4, basis="sto-6g"), dm, line), elf, 1e-10)
    dmu = np.stack([0.6 * dm, 0.4 * dm])
    _close(fj(JMole(h4, basis="sto-6g"), dmu, pts, restricted=False),
           ft(mol, dmu, pts, restricted=False, device=CPU), 1e-10)


def _public(mod):
    return {n for n in vars(mod) if not n.startswith("_")}


FACADES = ["", ".utils", ".dmet", ".models", ".ops"]


@pytest.fixture(scope="module")
def jax_facade_names():
    """The public names of the JAX package's facades in a fresh
    interpreter: a submodule that another test in this process imported
    (ops.pallas_eri, say) is an attribute of its package there, not a name
    the facade exports."""
    import json
    import os
    import subprocess
    import sys
    code = ("import importlib, json, sys; print(json.dumps({m: sorted(n for "
            "n in vars(importlib.import_module('libdmet_preview_tpu' + m)) "
            "if not n.startswith('_')) for m in sys.argv[1:]}))")
    proc = subprocess.run([sys.executable, "-c", code] + FACADES,
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert proc.returncode == 0, proc.stderr
    return {m: set(v) for m, v in
            json.loads(proc.stdout.strip().splitlines()[-1]).items()}


@pytest.mark.parametrize("name", FACADES)
def test_facades_export_the_jax_names(name, jax_facade_names):
    """Each facade module exports the names of the JAX package's; the
    top level lacks only `jax`, and importing it opens no CUDA context."""
    import importlib
    J = importlib.import_module("libdmet_preview_tpu" + name)
    T = importlib.import_module("libdmet_preview_tpu_torch" + name)
    missing = jax_facade_names[name] - _public(T)
    assert missing == ({"jax"} if name == "" else set())
    for n in jax_facade_names[name] - {"jax"}:
        a, b = getattr(J, n), getattr(T, n)
        if hasattr(a, "__name__") and hasattr(b, "__name__"):
            assert a.__name__.rsplit(".", 1)[-1] == \
                b.__name__.rsplit(".", 1)[-1]
    if torch.cuda.is_available():   # pragma: no cover - the card
        assert not torch.cuda.is_initialized()
