"""
The PyTorch port's quadrature grid and XC functionals
(libdmet_preview_tpu_torch/ints/grid.py, ints/xc.py) against the JAX
package's on the CPU: the Becke grid of H2 and of the 6-atom H ring, AO
values and gradients of the s-shell Mole and of a p/d MoleGeneral, every
functional elementwise, and E_xc / v_xc (torch.autograd against
jax.grad) for every xc key, restricted and unrestricted, including the
fully spin-polarized H atom (rho_b = 0, zeta = 1, where the clamps and the
zero-base powers decide the gradient).

Tolerances: grid points exactly, weights 1e-14 relative to max |w|, AO
values and gradients 1e-14; the functionals 1e-13 relative; E_xc 1e-12,
v_xc 1e-11; v_xc against central differences of E_xc (step 1e-5) 1e-8.
The JAX package's evaluations (one jit compile each) run once, each in
its own thread, at most two at a time (a module-scoped fixture).
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

torch.set_num_threads(1)
CPU = torch.device("cpu")
H2 = [("H", (0, 0, 0)), ("H", (0, 0, 1.4))]
XC_KEYS = ("lsda", "lda", "slater", "lda_pw", "pw92", "pbe", "pbe,pbe")
# each key's functional (both packages map the aliases to the same one)
XC_CANON = {"lda": "lsda", "pw92": "lda_pw", "pbe,pbe": "pbe"}


def _mols(atoms, basis):
    from libdmet_preview_tpu.ints.gto import Mole as J
    from libdmet_preview_tpu_torch.ints.gto import Mole as T
    return J(atoms, basis), T(atoms, basis)


@pytest.fixture(scope="module")
def h2_grid():
    """JAX and port grids and AO values of H2 / STO-6G (n_rad = 40)."""
    from libdmet_preview_tpu.ints import grid as jg
    from libdmet_preview_tpu_torch.ints import grid as tg
    mj, mt = _mols(H2, "sto-6g")
    cj, wj = jg.becke_grid(mj, n_rad=40)
    ct, wt = tg.becke_grid(mt, n_rad=40, device=CPU)
    return {"j": (cj, wj, jg.eval_ao(mj, cj), jg.eval_ao_grad(mj, cj)),
            "t": (ct, wt, tg.eval_ao(mt, ct), tg.eval_ao_grad(mt, ct))}


@pytest.mark.parametrize("system", ["h2", "ring6"])
def test_becke_grid_matches_jax(system, h2_grid):
    from libdmet_preview_tpu.ints import grid as jg
    from libdmet_preview_tpu_torch.ints import grid as tg
    from libdmet_preview_tpu_torch.ints.gto import h_ring
    if system == "h2":
        cj, wj = h2_grid["j"][:2]
        ct, wt = h2_grid["t"][:2]
    else:
        mj, mt = _mols(h_ring(6, 1.8), "sto-6g")
        cj, wj = jg.becke_grid(mj, n_rad=20, n_theta=8, n_phi=16)
        ct, wt = tg.becke_grid(mt, n_rad=20, n_theta=8, n_phi=16,
                               device=CPU)
    assert ct.dtype == torch.float64 and ct.shape == cj.shape
    assert np.abs(ct.numpy() - cj).max() == 0.0
    assert np.abs(wt.numpy() - wj).max() <= 1e-14 * np.abs(wj).max()


def test_eval_ao_and_grad_match_jax(h2_grid):
    """The s-shell Mole on the H2 grid, and a p/d MoleGeneral (the JAX
    suite's tests/test_dft.py case) on random points."""
    from libdmet_preview_tpu.ints import grid as jg
    from libdmet_preview_tpu.ints.md import MoleGeneral as JG
    from libdmet_preview_tpu_torch.ints import grid as tg
    from libdmet_preview_tpu_torch.ints.md import MoleGeneral as TG
    aj, gj = h2_grid["j"][2:]
    at, gt = h2_grid["t"][2:]
    assert np.abs(at.numpy() - aj).max() <= 1e-14
    assert np.abs(gt.numpy() - gj).max() <= 1e-14
    bd = {("H", "pd"): [(1, [(0.8, 1.0), (0.3, 0.5)]), (2, [(0.6, 1.0)])]}
    atoms = [("H", (0.1, 0.0, -0.2))]
    mj = JG(atoms, basis="pd", basis_data=bd)
    mt = TG(atoms, basis="pd", basis_data=bd)
    pts = np.random.RandomState(2).randn(20, 3) * 1.5
    assert np.abs(tg.eval_ao(mt, pts, device=CPU).numpy()
                  - jg.eval_ao(mj, pts)).max() <= 1e-14
    gt = tg.eval_ao_grad(mt, torch.as_tensor(pts)).numpy()
    assert np.abs(gt - jg.eval_ao_grad(mj, pts)).max() <= 1e-14


def test_functionals_elementwise_match_jax():
    import jax.numpy as jnp
    from libdmet_preview_tpu.ints import xc as jx
    from libdmet_preview_tpu_torch.ints import xc as tx
    rng = np.random.RandomState(1)
    ra = np.concatenate([rng.rand(40) * 2.0 + 1e-3, [1e-12, 0.3, 0.0]])
    rb = np.concatenate([rng.rand(40) * 2.0 + 1e-3, [1e-12, 0.0, 0.0]])
    saa, sbb = rng.rand(43) * 0.5, rng.rand(43) * 0.5
    sab = np.sqrt(saa * sbb) * (rng.rand(43) - 0.5)
    rs = rng.rand(43) * 10 + 0.1
    zeta = np.clip(rng.rand(43) * 2 - 1, -0.999, 0.999)

    def rel(a, b):
        a, b = np.asarray(a), np.asarray(b)
        return np.abs(a - b).max() / max(np.abs(a).max(), 1e-300)

    T = torch.as_tensor
    for name in ("lsda_exc_density", "slater_exc_density",
                 "ldapw_exc_density"):
        assert rel(getattr(jx, name)(jnp.asarray(ra), jnp.asarray(rb)),
                   getattr(tx, name)(T(ra), T(rb))) < 1e-13, name
    assert rel(jx.pbe_exc_density(*map(jnp.asarray, (ra, rb, saa, sab, sbb))),
               tx.pbe_exc_density(*map(T, (ra, rb, saa, sab, sbb)))) < 1e-13
    assert rel(jx.pw92_eps_c(jnp.asarray(rs), jnp.asarray(zeta)),
               tx.pw92_eps_c(T(rs), T(zeta))) < 1e-13
    for key in ("P", "F", "A"):
        assert rel(jx._vwn_eps(jnp.asarray(rs), key),
                   tx._vwn_eps(T(rs), key)) < 1e-13
    assert rel(jx._f_zeta(jnp.asarray(zeta)), tx._f_zeta(T(zeta))) < 1e-13
    assert rel(jx._pbe_x_channel(jnp.asarray(ra), jnp.asarray(saa)),
               tx._pbe_x_channel(T(ra), T(saa))) < 1e-13
    for key in XC_KEYS + ("PBE", None):
        assert tx.is_gga(key) == jx.is_gga(key)


def _dm(nao, seed, spin):
    rng = np.random.RandomState(seed)
    A = rng.randn(nao, nao)
    D = A @ A.T * 0.3 + 0.4 * np.eye(nao)
    return D if spin == 1 else np.stack([0.6 * D, 0.4 * D])


H_ATOM_XC = ("lsda", "pbe", "lda_pw")


def _h_atom(pkg):
    """The fully polarized H atom: grid, AO values and gradients."""
    import importlib
    grid = importlib.import_module(pkg + ".ints.grid")
    gto = importlib.import_module(pkg + ".ints.gto")
    mol = gto.Mole([("H", (0, 0, 0))], "sto-6g")
    kw = {"device": CPU} if pkg.endswith("torch") else {}
    c, w = grid.becke_grid(mol, n_rad=50, **kw)
    return w, grid.eval_ao(mol, c), grid.eval_ao_grad(mol, c)


@pytest.fixture(scope="module")
def jax_exc(h2_grid):
    """The JAX package's (E_xc, v_xc): on H2 for each functional and spin,
    and on the fully polarized H atom; each evaluation (a jit compile) in
    its own thread, at most two at a time."""
    from libdmet_preview_tpu.ints import xc as jx
    cj, wj, aj, gj = h2_grid["j"]
    wa, aa, ga = _h_atom("libdmet_preview_tpu")
    jobs = {(xc, spin): (_dm(2, 0, spin), aj, wj, spin == 1, xc, gj)
            for xc in sorted(set(XC_KEYS) - set(XC_CANON))
            for spin in (1, 2)}
    jobs.update({("H atom", xc): (np.array([[[1.0]], [[0.0]]]), aa, wa,
                                  False, xc, ga) for xc in H_ATOM_XC})
    with ThreadPoolExecutor(min(2, len(jobs))) as ex:
        futures = {k: ex.submit(jx.eval_exc_vxc, *a) for k, a in jobs.items()}
        return {k: (f.result()[0], np.asarray(f.result()[1]))
                for k, f in futures.items()}


@pytest.mark.parametrize("xc", sorted(set(XC_KEYS) - set(XC_CANON)))
def test_eval_exc_vxc_matches_jax(xc, h2_grid, jax_exc):
    """Each functional against JAX; each alias of it (XC_CANON) gives the
    port's same numbers bit for bit."""
    from libdmet_preview_tpu_torch.ints import xc as tx
    ct, wt, at, gt = h2_grid["t"]
    aliases = [k for k, v in XC_CANON.items() if v == xc]
    for spin in (1, 2):
        D = _dm(2, 0, spin)
        ej, vj = jax_exc[(xc, spin)]
        et, vt = tx.eval_exc_vxc(torch.as_tensor(D), at, wt,
                                 restricted=spin == 1, xc=xc, ao_grad=gt)
        assert isinstance(et, float) and vt.shape == np.shape(vj)
        assert abs(et - ej) < 1e-12
        assert np.abs(vt.numpy() - vj).max() < 1e-11
        for key in aliases + [xc.upper()]:
            ea, va = tx.eval_exc_vxc(torch.as_tensor(D), at, wt,
                                     restricted=spin == 1, xc=key,
                                     ao_grad=gt)
            assert ea == et and torch.equal(va, vt)
    if tx.is_gga(xc):
        with pytest.raises(ValueError):
            tx.eval_exc_vxc(torch.as_tensor(_dm(2, 0, 1)), at, wt, xc=xc)


def test_fully_polarized_h_atom_matches_jax(jax_exc):
    """rho_b = 0 everywhere: LSDA and PBE E_xc and v_xc (both spins)
    finite and equal to JAX's."""
    from libdmet_preview_tpu_torch.ints import xc as tx
    wt, at, gt = _h_atom("libdmet_preview_tpu_torch")
    D = torch.as_tensor(np.array([[[1.0]], [[0.0]]]))
    for xc in H_ATOM_XC:
        ej, vj = jax_exc[("H atom", xc)]
        et, vt = tx.eval_exc_vxc(D, at, wt, restricted=False, xc=xc,
                                 ao_grad=gt)
        assert np.all(np.isfinite(vt.numpy()))
        assert abs(et - ej) < 1e-12
        assert np.abs(vt.numpy() - vj).max() < 1e-11, xc


@pytest.mark.parametrize("xc", ["lsda", "pbe"])
def test_vxc_central_differences(xc, h2_grid):
    """v_xc = dE_xc/dD against central differences (restricted and
    unrestricted), on the port alone."""
    from libdmet_preview_tpu_torch.ints import xc as tx
    ct, wt, at, gt = h2_grid["t"]
    eps = 1e-5
    for spin in (1, 2):
        D = torch.as_tensor(_dm(2, 0, spin))
        _, v = tx.eval_exc_vxc(D, at, wt, restricted=spin == 1, xc=xc,
                               ao_grad=gt)
        fd = torch.zeros_like(D)
        for idx in np.ndindex(*D.shape):
            Dp, Dm = D.clone(), D.clone()
            Dp[idx] += eps
            Dm[idx] -= eps
            fd[idx] = (tx.eval_exc_vxc(Dp, at, wt, spin == 1, xc, gt)[0]
                       - tx.eval_exc_vxc(Dm, at, wt, spin == 1, xc, gt)[0]) \
                / (2 * eps)
        fd = 0.5 * (fd + fd.transpose(-1, -2))
        assert (fd - v).abs().max() < 1e-8
