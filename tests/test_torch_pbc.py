"""
The PyTorch port's periodic Gaussian cell (libdmet_preview_tpu_torch/
ints/pbc.py: G-space work on the cell's device, real-space lattice sums in
host NumPy and the native short-range core) against the JAX package's
ints/pbc.py on the CPU, on the same NumPy geometries:

  * the 2-cell H chain in STO-6G (make_hchain_supercell),
  * the 2 x 2 H plane in STO-3G (make_hplane_supercell),
  * the H2 crystal on a 2 x 2 x 1 mesh with and without translations
    (tests/test_pbc_3d.py's fixture),
  * a p-shell cell (tests/test_gth.py's C basis) for the general-l pair
    Fourier transform,

each integral method, ft_aopair (column and expanded), energy_nuc,
tr_diff and cross_ovlp_pbc held to 1e-12 absolute; the native
sr_hermite_sum / sr_cand_sum against the NumPy R_table branch (1e-12
relative); and the JAX suite's independent oracles on the port alone:
the NaCl Madelung constant (1e-9), the rotated chain against the plane
(1e-8 / 1e-9), stripe against dense (1e-10 / 1e-8), the PBC-HF molecular
limit (5e-3, and the Ewald self energy 1e-4), and intor_eri_rs converged
on a sharp pair (1e-7).  The JAX sides run once per module, each case in
its own thread, at most two at a time.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

torch.set_num_threads(1)
CPU = torch.device("cpu")
TOL = 1e-12

_PBASIS = {("C", "mini"): [(0, [(1.4, 1.0), (0.8, 0.6)]),
                           (1, [(0.9, 1.0)])]}


def _n(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _kw(M):
    return {"device": CPU} if M.__name__.startswith(
        "libdmet_preview_tpu_torch") else {}


def _crystal(M, km, with_translations):
    """tests/test_pbc_3d.py's H2 crystal (workloads.h2_crystal_geometry)."""
    from libdmet_preview_tpu_torch import workloads as wl
    atoms, a, t_vecs = wl.h2_crystal_geometry(km)
    cell = M.PbcCell(atoms, a, basis="tight", basis_data=wl.H2_CRYSTAL_BASIS,
                     precision=1e-10, **_kw(M))
    if with_translations:
        cell.set_translations(int(np.prod(km)), t_vecs)
    return cell


def _pcell(M):
    """Two C atoms with an s + p basis in a 2-cell stripe (p shells in the
    pair FT, the Ewald nuclear attraction and the ERI)."""
    L = 4.0
    atoms = [("C", (0.0, 0.0, 0.15)), ("C", (0.0, 0.0, L / 2 + 0.15))]
    cell = M.PbcCell(atoms, np.diag([8.0, 8.0, L]), basis="mini",
                     basis_data=_PBASIS, precision=1e-8, **_kw(M))
    return cell.set_translations(2, np.array([[0.0, 0.0, 0.0],
                                              [0.0, 0.0, L / 2]]))


CELLS = {
    "chain2": lambda M: M.make_hchain_supercell(nk=2, basis="sto-6g",
                                                **_kw(M)),
    "plane": lambda M: M.make_hplane_supercell(nkx=2, nky=2, Rx=2.0, Ry=2.4,
                                               vac=8.0, **_kw(M)),
    "crystal": lambda M: _crystal(M, (2, 2, 1), True),
    "crystal_dense": lambda M: _crystal(M, (2, 2, 1), False),
    "p_cell": _pcell,
}
_ALL = ["intor_ovlp", "intor_kin", "intor_nuc", "intor_hcore", "intor_eri",
        "ft_col", "ft_full", "energy_nuc"]
_RS = ["intor_eri_rs", "eri_trans_full", "eri_trans_full_rs"]
OPS = {"chain2": _ALL + ["eri_trans_full", "tr_diff", "cross_ovlp"],
       "plane": _ALL + _RS + ["tr_diff"],
       "crystal": _ALL + _RS + ["tr_diff"],
       "crystal_dense": _ALL + ["intor_eri_rs"],
       "p_cell": _ALL + ["eri_trans_full", "intor_eri_rs"]}


def _values(M, case):
    cell = CELLS[case](M)
    out = {}
    for op in OPS[case]:
        if op.startswith("ft_"):
            Gv, _ = cell.coulG()
            v = cell._ft_aopair_impl(Gv, expand=op == "ft_full")
        elif op == "tr_diff":
            v = cell.tr_diff
        elif op == "cross_ovlp":
            # the periodized minimal reference basis of the IAOs
            c_min = M.PbcCell(cell.atoms, cell.a, basis="minao", unit="B",
                              **_kw(M))
            v = M.cross_ovlp_pbc(cell, c_min)
        else:
            v = getattr(cell, op)()
        out[op] = _n(v)
    return out


@pytest.fixture(scope="module")
def values():
    from libdmet_preview_tpu.ints import pbc as jpbc
    from libdmet_preview_tpu_torch.ints import pbc as tpbc
    with ThreadPoolExecutor(min(2, len(CELLS))) as ex:
        futs = {c: ex.submit(_values, jpbc, c) for c in CELLS}
        port = {c: _values(tpbc, c) for c in CELLS}
        jax = {c: f.result() for c, f in futs.items()}
    return jax, port


@pytest.mark.parametrize("case,op", [(c, op) for c in CELLS
                                     for op in OPS[c]])
def test_cell_matches_jax(values, case, op):
    jax, port = values
    a, b = jax[case][op], port[case][op]
    assert a.shape == b.shape
    if op == "tr_diff":
        assert np.array_equal(a, b)
    else:
        assert np.abs(a - b).max() < TOL, np.abs(a - b).max()


def test_integrals_are_device_tensors_kept_on_the_cell():
    from libdmet_preview_tpu_torch.ints import pbc
    cell = _crystal(pbc, (2, 2, 1), True)
    S = cell.intor_ovlp()
    assert S.dtype == torch.float64 and S.device == CPU
    S[0, 0] = 7.0                    # the caller's copy, not the cell's
    assert float(cell.intor_ovlp()[0, 0]) != 7.0
    eri = cell.intor_eri()
    assert cell.intor_eri() is not eri and "eri" in cell._cache
    # ft_aopair keeps one mesh: the long-range mesh of intor_eri_rs does
    # not reuse the cell mesh's transform
    Gv, _ = cell.coulG()
    f = cell.ft_aopair(Gv)
    assert cell.ft_aopair(Gv) is f
    assert cell.ft_aopair(Gv, expand=False).shape[2] == cell.nao_cell
    Gl, _ = cell.coulG_rs(1.0)
    assert cell.ft_aopair(Gl).shape[0] == Gl.shape[0] != Gv.shape[0]


@pytest.mark.parametrize("lsum", [0, 2, 4])
def test_native_sr_sums_match_the_numpy_branch(lsum):
    """sr_hermite_sum (Coulomb, and the Gaussian kernel at complex alpha)
    and the fused sr_cand_sum against R_table summed per image."""
    from libdmet_preview_tpu_torch.ints import md, native
    if native.get_sr_lib() is None:
        pytest.fail("the native short-range core did not build")
    rng = np.random.RandomState(lsum)
    nimg, nk = 5, 40
    PC = rng.uniform(-2.0, 2.0, size=(nk, 3))
    wz = rng.uniform(0.5, 2.0, size=nk)
    kimg = rng.randint(0, nimg, size=nk)
    dim = (lsum + 1,) * 3

    def per_image(R):
        return np.stack([np.bincount(kimg, weights=r, minlength=nimg)
                         for r in R.reshape(-1, nk)])

    for kernel, alpha in ((0, 0.7), (1, 0.9 + 1e-3j)):
        S_re, S_im = native.sr_hermite_sum(lsum, PC, wz, kimg, nimg, alpha,
                                           kernel)
        R = md.R_table(lsum, lsum, lsum, alpha, PC,
                       kernel="coulomb" if kernel == 0 else "gauss")
        ref = per_image(R.real * wz) + 1j * per_image(R.imag * wz)
        got = S_re + 1j * S_im
        assert np.abs(got - ref).max() < TOL * np.abs(ref).max()
    # fused screen: images of this primitive pair via inv, centres ctrs
    P = rng.uniform(-1.0, 1.0, size=(nimg, 3))
    ctrs = rng.uniform(-2.0, 2.0, size=(7, 3))
    Zs = rng.uniform(0.5, 3.0, size=7)
    inv = np.array([0, -1, 1, 2, 3, 4, -1], dtype=np.int64)
    cand_img = rng.randint(0, inv.size, size=30).astype(np.int64)
    cand_c = rng.randint(0, 7, size=30).astype(np.int64)
    rng2 = 6.0
    S_re, _ = native.sr_cand_sum(lsum, P, inv, cand_img, cand_c, ctrs, Zs,
                                 rng2, 0.8, 0)
    loc = inv[cand_img]
    ok = loc >= 0
    PCc = P[loc[ok]] - ctrs[cand_c[ok]]
    act = np.einsum("ki, ki -> k", PCc, PCc) < rng2
    R = md.R_table(lsum, lsum, lsum, 0.8, PCc[act]) * Zs[cand_c[ok]][act]
    ref = np.stack([np.bincount(loc[ok][act], weights=r, minlength=nimg)
                    for r in R.reshape(int(np.prod(dim)), -1)])
    assert np.abs(S_re - ref).max() < TOL * np.abs(ref).max()


# ----------------------------------------------------------------------
# the JAX suite's independent oracles, on the port alone
# ----------------------------------------------------------------------

def test_madelung_constant():
    """The Ewald sum reproduces the NaCl Madelung constant."""
    from libdmet_preview_tpu_torch.ints.pbc import PbcCell
    fcc = [(0, 0, 0), (0, 1, 1), (1, 0, 1), (1, 1, 0)]
    coords = [np.array(p, float) for p in fcc] \
        + [np.array(p, float) + np.array([1.0, 0, 0]) for p in fcc]
    cell = PbcCell([("H", c) for c in coords], np.eye(3) * 2.0,
                   basis="sto-3g", unit="B", device=CPU)
    cell.charges = np.asarray([1.0] * 4 + [-1.0] * 4)
    assert abs(-cell.energy_nuc() / 4.0 - 1.7475645946) < 1e-9


def test_plane_matches_rotated_chain():
    """A [2, 1] plane of single-H cells == the 2-cell chain with the
    periodic axis rotated x <-> z."""
    from libdmet_preview_tpu_torch.ints import pbc
    plane = pbc.make_hplane_supercell(nkx=2, nky=1, Rx=1.8, Ry=8.0, vac=8.0,
                                      device=CPU)
    chain = pbc.make_hchain_supercell(nk=2, nH=1, R=1.8, vac=8.0,
                                      basis="sto-3g", device=CPU)
    for op in ("intor_ovlp", "intor_hcore"):
        assert np.abs(_n(getattr(plane, op)())
                      - _n(getattr(chain, op)())).max() < 1e-8, op
    assert abs(plane.energy_nuc() - chain.energy_nuc()) < 1e-9


@pytest.mark.parametrize("factory", ["plane", "crystal"])
def test_stripe_equals_dense(factory):
    from libdmet_preview_tpu_torch.ints import pbc
    if factory == "plane":
        cs = pbc.make_hplane_supercell(nkx=2, nky=2, Rx=2.0, Ry=2.4,
                                       vac=8.0, device=CPU)
        cd = pbc.PbcCell(cs.atoms, cs.a, basis="sto-3g", device=CPU)
    else:
        cs, cd = _crystal(pbc, (2, 2, 1), True), _crystal(pbc, (2, 2, 1),
                                                          False)
    assert np.abs(_n(cs.intor_ovlp()) - _n(cd.intor_ovlp())).max() < 1e-10
    assert np.abs(_n(cs.intor_hcore()) - _n(cd.intor_hcore())).max() < 1e-8
    if factory == "crystal":
        # eri_trans_full == the dense ERI reindexed into the full format
        N, m = cs.ncells_tr, cs.nao_cell
        eriF = _n(cs.eri_trans_full())
        db = _n(cd.intor_eri()).reshape(N, m, N, m, N, m, N, m)
        ref = db[0].transpose(1, 3, 5, 0, 2, 4, 6)
        assert np.abs(eriF - ref).max() < 1e-9


def test_pbc_hf_molecular_limit():
    """PBC HF + the exchange-Madelung correction converges to the
    molecular RHF energy as the box grows; the single-charge Ewald self
    energy is -1.41865 / L (cubic)."""
    from libdmet_preview_tpu_torch.ints.gto import Mole
    from libdmet_preview_tpu_torch.ints.pbc import PbcCell
    from libdmet_preview_tpu_torch.models.integral import Integral
    from libdmet_preview_tpu_torch.solvers.scf import SCF

    def hf(S, h, eri, enuc):
        Ham = Integral(S.shape[0], True, False, enuc, {"cd": h[None]},
                       {"ccdd": eri[None]}, ovlp=S)
        m = SCF(device=CPU)
        m.set_system(2, 0, False, True)
        m.set_integral(Ham)
        return m.HF(tol=1e-12, MaxIter=200)[0]

    atoms = [("H", (0, 0, 0)), ("H", (0, 0, 1.4))]
    mol = Mole(atoms, basis="3-21g")
    E_mol = hf(mol.intor_ovlp(), mol.intor_hcore(), mol.intor_eri(),
               mol.energy_nuc())
    L = 15.0
    cell = PbcCell(atoms, np.eye(3) * L, basis="3-21g", unit="B", device=CPU)
    xi = PbcCell([("H", (0, 0, 0))], np.eye(3) * L, basis="sto-3g",
                 unit="B", device=CPU).energy_nuc()
    E_pbc = hf(_n(cell.intor_ovlp()), _n(cell.intor_hcore()),
               _n(cell.intor_eri()), cell.energy_nuc())
    assert abs((E_pbc + 2 * xi) - E_mol) < 5e-3
    assert abs(xi * L - (-1.41865)) < 1e-4


def test_intor_eri_rs_sharp_converged():
    """On a sharp-exponent pair the bare-mesh intor_eri is underconverged
    while the range-separated ERI matches a 3x-gmax G sum."""
    from libdmet_preview_tpu_torch.ints.pbc import PbcCell
    bd = {("H", "sharp"): [(0, [(5.4, 1.0)]), (0, [(0.2, 1.0)])]}
    atoms = [("H", (0, 0, 0)), ("H", (1.5, 0, 0))]
    kw = dict(basis="sharp", basis_data=bd, unit="B", precision=1e-8,
              device=CPU)
    cell = PbcCell(atoms, np.eye(3) * 12.0, **kw)
    e_rs = _n(cell.intor_eri_rs(omega=1.0))
    assert np.abs(e_rs - _n(cell.intor_eri())).max() > 1e-3
    cell_hi = PbcCell(atoms, np.eye(3) * 12.0, gmax=3 * cell.gmax, **kw)
    assert np.abs(e_rs - _n(cell_hi.intor_eri())).max() < 1e-7
