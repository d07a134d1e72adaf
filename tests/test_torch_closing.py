"""
The last public names and call forms of the JAX package in the PyTorch
port, against the JAX package on the CPU with the same NumPy inputs:

  * Vcor.show(): the strings are equal;
  * utils.logger.Timer: with the clock replaced, the log line and the
    returned seconds are equal;
  * LatticeModel.FFTtoK / FFTtoT on ChainLattice(18, 2) and
    SquareLattice(4, 4, 2, 2): 1e-12;
  * entry.dmet_forward on entry._hubbard_fock_k(4, 2, 4.0, 0.5) (and the
    9-cell flagship) at beta = 1000: E_mf and rho_R 1e-10; the bath is an
    SVD whose column gauge may differ between libraries, so embH1 is held
    by its impurity block and its spectrum, with fit_err, 1e-10;
  * the JAX call form of the ab initio factories: the H ring against the
    JAX factory's same call (E_hf, the LO Fock spectrum: 1e-8), the H chain
    against the port's two-step form (cell, then lattice) on identical
    tensors, the molecule's mol=;
  * each keyword the port takes for the JAX package's sake (newton_ah,
    neg_map, blksize, n_devices / axis / devices, step_fn, nelec, t2, tol,
    keep_complex) leaves its results bit-identical to the call without it.
"""

import io

import numpy as np
import pytest
import torch

torch.set_num_threads(1)
CPU = torch.device("cpu")


def _n(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _d(a, b):
    return float(np.max(np.abs(_n(a) - _n(b))))


# ----------------------------------------------------------------------
# Vcor.show, Timer
# ----------------------------------------------------------------------

@pytest.mark.parametrize("restricted", [True, False])
def test_vcor_show_equals_jax(restricted):
    from libdmet_preview_tpu.ops import vcor as jv
    from libdmet_preview_tpu_torch.ops import vcor as tv
    vj = jv.VcorLocal(restricted, False, 3)
    vt = tv.VcorLocal(restricted, False, 3)
    p = np.random.RandomState(3).randn(vj.length())
    vj.update(p)
    vt.update(p)
    assert vt.show() == vj.show()
    assert vt.show().startswith("Vcor(nparam=%d, spin_comp=2, nao=3)\n[["
                                % vj.length())


@pytest.mark.parametrize("device", [None, "cpu"])
def test_timer_log_equals_jax(monkeypatch, device):
    import time
    from libdmet_preview_tpu.utils import logger as jlog
    from libdmet_preview_tpu_torch.utils import logger as tlog
    lines = {}
    for name, log in (("jax", jlog), ("port", tlog)):
        ticks = iter([10.0, 12.5, 13.75])
        # both loggers read time.perf_counter of the one time module
        monkeypatch.setattr(time, "perf_counter", lambda: next(ticks))
        out = io.StringIO()
        monkeypatch.setattr(log, "stdout", out)
        monkeypatch.setattr(log, "clock", False)
        monkeypatch.setattr(log, "verbose", "INFO")
        timer = log.Timer("fit") if name == "jax" \
            else log.Timer("fit", device=device)
        seconds = timer.log("step 3")
        lines[name] = (out.getvalue(), seconds)
    assert lines["port"] == lines["jax"]
    assert lines["port"] == ("INFO    timer fit step 3: 2.5000 s\n", 3.75)


# ----------------------------------------------------------------------
# LatticeModel.FFTtoK / FFTtoT, the fourier keywords
# ----------------------------------------------------------------------

def _lattices(name):
    from libdmet_preview_tpu.models import lattice as jl
    from libdmet_preview_tpu_torch.models import lattice as tl
    args = {"chain": ("ChainLattice", (18, 2)),
            "square": ("SquareLattice", (4, 4, 2, 2))}[name]
    return getattr(jl, args[0])(*args[1]), getattr(tl, args[0])(*args[1])


@pytest.mark.parametrize("name", ["chain", "square"])
def test_lattice_fft_methods_equal_jax(name):
    Lj, Lt = _lattices(name)
    n = Lt.nscsites
    A = np.random.RandomState(5).randn(2, Lt.ncells, n, n)
    kj = Lj.FFTtoK(A)
    for arg in (A, torch.as_tensor(A)):
        kt = Lt.FFTtoK(arg)
        assert isinstance(kt[0], type(arg))
        assert _d(kt[0], kj[0]) < 1e-12 and _d(kt[1], kj[1]) < 1e-12
    B = (np.array(kj[0]), np.array(kj[1]))
    Rj = Lj.FFTtoT(B)
    Rt = Lt.FFTtoT(B)
    assert _d(Rt, Rj) < 1e-12 and _d(Rt, A) < 1e-12
    Bt = tuple(torch.as_tensor(x) for x in B)
    assert torch.equal(Lt.FFTtoT(Bt, tol=1e-3), Lt.FFTtoT(Bt))
    assert np.array_equal(Lt.k2R(B, tol=1e-3), Lt.k2R(B))
    assert np.array_equal(Lt.FFTtoT(B), Lt.k2R(B))


def test_fourier_keywords_leave_results_unchanged():
    from libdmet_preview_tpu_torch.ops import fourier
    A = np.random.RandomState(6).randn(2, 6, 3, 3)
    k = fourier.R2k(A, (6,))
    for a, b in zip(fourier.R2k(A, (6,), keep_complex=False), k):
        assert np.array_equal(a, b)
    assert np.array_equal(fourier.k2R(k, (6,), tol=0.1), fourier.k2R(k, (6,)))
    assert np.array_equal(fourier.k2R(k, (6,), 0.1, True),
                          fourier.k2R(k, (6,), real=True))
    assert np.array_equal(fourier.FFTtoT(k, (6,), tol=0.1),
                          fourier.FFTtoT(k, (6,)))
    assert fourier.IMAG_DISCARD_TOL == 1e-5


# ----------------------------------------------------------------------
# entry.dmet_forward
# ----------------------------------------------------------------------

@pytest.mark.parametrize("ncells, nlo", [(4, 2), (9, 2)])
def test_dmet_forward_matches_jax(ncells, nlo):
    import __graft_entry__ as graft
    from libdmet_preview_tpu.ops.zlinalg import dft_tables
    from libdmet_preview_tpu_torch.entry import _hubbard_fock_k, dmet_forward
    U, filling, beta = 4.0, 0.5, 1000.0
    f_j = [np.asarray(x) for x in graft._hubbard_fock_k(ncells, nlo, U,
                                                         filling)]
    f_t = _hubbard_fock_k(ncells, nlo, U, filling)
    assert all(np.array_equal(a, b) for a, b in zip(f_t, f_j))
    cos_t, sin_t = dft_tables((ncells,))
    nval = nlo
    neo = nlo + nval
    env_idx = np.arange(nlo, ncells * nlo)
    nelec2 = ncells * 2 * nlo * filling
    v = np.random.RandomState(9).randn(1, nlo, nlo) * 0.1
    vmat = v + v.transpose(0, 2, 1)
    rho_target = np.tile(np.eye(neo)[None] * filling, (1, 1, 1))
    args = (vmat, rho_target, cos_t, sin_t, env_idx, nelec2, beta, nval)
    E_j, rho_j, h_j, err_j = (np.asarray(x) for x in graft.dmet_forward(
        *f_j, *args))
    out = dmet_forward(*f_t, *args, device=CPU)
    assert all(isinstance(x, torch.Tensor) and x.device == CPU for x in out)
    E_t, rho_t, h_t, err_t = (_n(x) for x in out)
    assert rho_t.shape == rho_j.shape == (1, ncells, nlo, nlo)
    assert h_t.shape == h_j.shape == (1, neo, neo) and E_t.shape == ()
    assert abs(E_t - E_j) < 1e-10 and _d(rho_t, rho_j) < 1e-10
    assert abs(err_t - err_j) < 1e-10
    assert _d(h_t[:, :nlo, :nlo], h_j[:, :nlo, :nlo]) < 1e-10
    assert _d(np.linalg.eigvalsh(h_t), np.linalg.eigvalsh(h_j)) < 1e-10
    # tensors in, on their device: the same step
    out2 = dmet_forward(*(torch.as_tensor(x) for x in f_t), *args,
                        device=CPU)
    assert all(torch.equal(a, b) for a, b in zip(out, out2))


# ----------------------------------------------------------------------
# the ab initio factories' JAX call form
# ----------------------------------------------------------------------

def _lo_fock_spectrum(meta):
    return np.linalg.eigvalsh(_n(meta["fock_lo"]))


@pytest.mark.parametrize("positional", [False, True])
def test_h_ring_jax_call_form_matches_jax(positional):
    from libdmet_preview_tpu.models import abinitio as ja
    from libdmet_preview_tpu_torch.models import abinitio as pa
    if positional:
        # tests/test_units.py's form: ncells, atoms_per_cell, r_bond
        Lt, mt = pa.make_h_ring_lattice(3, 2, 1.8, basis="sto-6g",
                                        device=CPU)
    else:
        Lt, mt = pa.make_h_ring_lattice(3, atoms_per_cell=2, r_bond=1.8,
                                        basis="sto-6g", device=CPU)
    Lj, mj = ja.make_h_ring_lattice(3, atoms_per_cell=2, r_bond=1.8,
                                    basis="sto-6g")
    assert abs(mt["E_hf"] - mj["E_hf"]) < 1e-8
    assert _d(_lo_fock_spectrum(mt), _lo_fock_spectrum(mj)) < 1e-8
    assert (Lt.ncells, Lt.nscsites) == (Lj.ncells, Lj.nscsites) == (3, 2)
    assert len(mt["mole"].atoms) == 6


def test_h_ring_jax_call_form_equals_the_mole_form():
    from libdmet_preview_tpu_torch.ints.gto import h_ring_mole
    from libdmet_preview_tpu_torch.models import abinitio as pa
    kw = dict(localization="iao", minimal_ref="sto-6g", device=CPU)
    Lj, mj = pa.make_h_ring_lattice(ncells=3, atoms_per_cell=2, r_bond=1.8,
                                    basis="3-21g", **kw)
    Lm, mm = pa.make_h_ring_lattice(h_ring_mole(6, 1.8, "3-21g"), ncells=3,
                                    **kw)
    assert mj["E_hf"] == mm["E_hf"]
    for k in ("C_ao_lo", "fock_lo", "rdm1_lo"):
        assert torch.equal(mj[k], mm[k]), k
    assert torch.equal(Lj.chol_L, Lm.chol_L)
    with pytest.raises(TypeError):
        pa.make_h_ring_lattice(3, ncells=4, device=CPU)
    with pytest.raises(TypeError):
        pa.make_h_ring_lattice(device=CPU)


def test_molecule_lattice_takes_mol():
    from libdmet_preview_tpu_torch.ints.gto import Mole
    from libdmet_preview_tpu_torch.models import abinitio as pa
    atoms = [("H", (0.0, 0.0, 1.8 * i)) for i in range(4)]
    mol = Mole(atoms, basis="sto-6g")
    Lk, mk = pa.make_molecule_lattice(mol=mol, device=CPU)
    Lp, mp = pa.make_molecule_lattice(mol, device=CPU)
    assert mk["E_hf"] == mp["E_hf"] and mk["mole"] is mol
    assert torch.equal(mk["fock_lo"], mp["fock_lo"])
    with pytest.raises(TypeError):
        pa.make_molecule_lattice(mol, mol=mol, device=CPU)


@pytest.fixture(scope="module")
def hchain_jax_form():
    """make_hchain_pbc_lattice(nk=3) in the JAX call form: the one cell
    build of this file."""
    from libdmet_preview_tpu_torch.models import abinitio as pa
    return pa.make_hchain_pbc_lattice(nk=3, device=CPU)


def _same_lattice(a, b):
    (La, ma), (Lb, mb) = a, b
    assert ma["E_hf"] == mb["E_hf"]
    for k in ("hcore_lo_R", "fock_lo_R", "rdm1_lo_R"):
        assert np.array_equal(_n(getattr(La, k)), _n(getattr(Lb, k))), k
    for k in ("C_ao_lo", "h_lo", "fock_lo", "rdm1_lo"):
        assert np.array_equal(_n(ma[k]), _n(mb[k])), k


def test_hchain_jax_call_form_equals_the_two_step_form(hchain_jax_form):
    """The JAX form builds workloads.hchain_cell(3)'s cell (the same
    constructor arguments), and the lattice made from that cell is the
    two-step form's to the bit."""
    from libdmet_preview_tpu_torch import workloads as wl
    from libdmet_preview_tpu_torch.models import abinitio as pa
    Lat, meta = hchain_jax_form
    cell, ref = meta["cell"], wl.hchain_cell(3, CPU)
    assert cell.basis == ref.basis and cell.ncells_tr == ref.ncells_tr == 3
    assert np.array_equal(cell.a, ref.a) and cell.mesh == ref.mesh
    assert all(s1 == s2 and np.array_equal(x1, x2) for (s1, x1), (s2, x2)
               in zip(cell.atoms, ref.atoms))
    _same_lattice((Lat, meta), pa.make_hchain_pbc_lattice(cell, device=CPU))
    assert torch.equal(Lat.chol_L, pa.make_hchain_pbc_lattice(
        cell, device=CPU)[0].chol_L)
    with pytest.raises(TypeError):
        pa.make_hchain_pbc_lattice(cell, nk=3, device=CPU)


@pytest.mark.parametrize("uhf", [False, True])
def test_hchain_jax_call_form_passes_jax_defaults(monkeypatch,
                                                  hchain_jax_form, uhf):
    """The JAX form hands JAX's defaults (or the given values) to
    make_hchain_supercell and minao_ref to the IAOs; the cell is the
    fixture's, so no second build."""
    from libdmet_preview_tpu_torch.ints import pbc
    from libdmet_preview_tpu_torch.models import abinitio as pa
    cell = hchain_jax_form[1]["cell"]
    seen = []

    def fake(**kw):
        seen.append(kw)
        return cell

    monkeypatch.setattr(pbc, "make_hchain_supercell", fake)
    make = pa.make_hchain_pbc_lattice_uhf if uhf \
        else pa.make_hchain_pbc_lattice
    got = make(device=CPU)
    assert seen == [dict(nk=3, nH=2, R=1.5, vac=10.0, basis="3-21g",
                         gmax=None, device=CPU)]
    ref = make(cell, device=CPU)
    if uhf:
        assert got[1]["E_hf"] == ref[1]["E_hf"]
        assert all(np.array_equal(_n(a), _n(b)) for a, b in
                   zip(got[1]["eri_lo"], ref[1]["eri_lo"]))
    else:
        _same_lattice(got, ref)
    make(5, R=1.4, device=CPU, minao_ref="sto-3g")
    assert seen[-1]["nk"] == 5 and seen[-1]["R"] == 1.4
    assert "minimal sto-3g" in make(
        device=CPU, minao_ref="sto-3g")[1]["ints"].source


# ----------------------------------------------------------------------
# the other keywords: accepted, results unchanged
# ----------------------------------------------------------------------

def test_scf_newton_ah_is_stored_and_changes_nothing():
    from libdmet_preview_tpu_torch.models.integral import Integral
    from libdmet_preview_tpu_torch.solvers.scf import SCF
    rng = np.random.RandomState(2)
    n = 4
    h = rng.randn(n, n)
    h = h + h.T
    g = rng.randn(n, n, n, n) * 0.05
    g = g + g.transpose(1, 0, 2, 3)
    g = g + g.transpose(0, 1, 3, 2)
    g = g + g.transpose(2, 3, 0, 1)
    out = []
    for kw in ({}, {"newton_ah": True}):
        scf = SCF(device=CPU, **kw)
        assert scf.newton_ah is kw.get("newton_ah", False)
        scf.set_system(4, 0, False, True)
        scf.set_integral(Integral(n, True, False, 0.0, {"cd": h[None]},
                                  {"ccdd": g[None]}))
        out.append(scf.HF(tol=1e-10, MaxIter=100))
    assert out[0][0] == out[1][0]
    assert np.array_equal(_n(out[0][1]), _n(out[1][1]))


def test_get_jk_nearest_neg_map():
    from libdmet_preview_tpu_torch.models.lattice import SquareLattice
    from libdmet_preview_tpu_torch.ops.pbc_helper import get_jk_nearest
    Lat = SquareLattice(4, 4, 2, 2)
    rng = np.random.RandomState(4)
    eri_R = rng.randn(Lat.ncells, 4, 4, 4, 4)
    dm = rng.randn(2, Lat.ncells, 4, 4)
    ref = get_jk_nearest(eri_R, dm, CPU)
    got = get_jk_nearest(eri_R, dm, CPU, neg_map=Lat._neg_map)
    assert all(np.array_equal(a, b) for a, b in zip(ref, got))
    for bad in (np.roll(Lat._neg_map, 1), Lat._neg_map[:-1],
                np.arange(Lat.ncells)[::-1]):
        with pytest.raises(ValueError):
            get_jk_nearest(eri_R, dm, CPU, neg_map=bad)


def test_pbc_eri_blksize_changes_nothing():
    from libdmet_preview_tpu_torch.ints.pbc import make_hchain_supercell
    cell = make_hchain_supercell(nk=2, nH=1, R=1.5, vac=6.0, basis="sto-3g",
                                 device=CPU)
    for name in ("intor_eri", "intor_eri_rs", "eri_trans_full",
                 "eri_trans_full_rs"):
        f = getattr(cell, name)
        assert torch.equal(f(blksize=7), f()), name


@pytest.fixture
def one_rank_group(tmp_path):
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method="file://%s"
                            % (tmp_path / "group"), world_size=1, rank=0)
    yield
    dist.destroy_process_group()


def test_kmesh_jax_call_forms(one_rank_group):
    from libdmet_preview_tpu_torch.parallel import kmesh
    for mesh in (kmesh.make_mesh(n_devices=1, axis="aux", device=CPU),
                 kmesh.make_mesh(1, "aux", device=CPU)):
        assert mesh.shape == {"aux": 1} and mesh.axes == ("aux",)
    assert kmesh.make_mesh(device=CPU).shape == {"k": 1}
    with pytest.raises(ValueError, match="process"):
        kmesh.make_mesh(n_devices=1, devices=["cpu"], device=CPU)
    mesh = kmesh.make_mesh(device=CPU)
    rng = np.random.RandomState(8)
    nocc, nso = 2, 6
    t1 = torch.as_tensor(rng.randn(nocc, nso - nocc) * 0.1)
    t2 = torch.as_tensor(rng.randn(nocc, nocc, nso - nocc, nso - nocc) * 0.1)
    h = torch.as_tensor(rng.randn(nso, nso))
    W = torch.as_tensor(rng.randn(nso, nso, nso, nso) * 0.1)
    ref = kmesh.ccsd_residual_sharded(mesh, t1, t2, h, W, nocc)
    for kw in ({"t2": t2}, {"t2_local": t2}):
        got = kmesh.ccsd_residual_sharded(mesh, t1, h_so=h, W=W, nocc=nocc,
                                          **kw)
        assert all(torch.equal(a, b) for a, b in zip(ref, got))


def test_renamed_parameters_take_both_names():
    from libdmet_preview_tpu_torch.ops import zlinalg
    from libdmet_preview_tpu_torch.ops.fastpath import chain_iterations

    def step(p, t):
        return p * 0.5 + t, torch.sum(p)

    p0, t = torch.arange(3.0), torch.ones(3)
    ref = chain_iterations(step, 4)(p0, t)
    for kw in ({"step_fn": step}, {"step": step}):
        got = chain_iterations(n_chain=4, **kw)(p0, t)
        assert all(torch.equal(a, b) for a, b in zip(ref, got))
    with pytest.raises(TypeError):
        chain_iterations(step_fn=step, step=step, n_chain=4)
    a = torch.as_tensor(np.random.RandomState(1).randn(3, 4, 4))
    h_re, h_im = a + a.transpose(1, 2), a - a.transpose(1, 2)
    w = torch.tensor([1.0, 2.0, 1.0])
    ref = zlinalg.zrho_fermi(h_re, h_im, 10.0, 30.0)
    ref_w = zlinalg.zrho_fermi_w(h_re, h_im, 10.0, 30.0, w)
    for name in ("nelec", "nelec2"):
        got = zlinalg.zrho_fermi(h_re, h_im, beta=30.0, **{name: 10.0})
        assert all(torch.equal(x, y) for x, y in zip(ref, got))
        got = zlinalg.zrho_fermi_w(h_re, h_im, beta=30.0, weights=w,
                                   **{name: 10.0})
        assert all(torch.equal(x, y) for x, y in zip(ref_w, got))
