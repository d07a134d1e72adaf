"""
The PyTorch port's molecular KS-DFT (RKS, UKS, RKSpU, UKSpU of
libdmet_preview_tpu_torch/solvers/ksdft.py) and lattice +U
(ops/dftu.py: hub_u_correction, HF_plus_U) against the JAX package's on
the systems of tests/test_dft.py, tests/test_dftu_ks.py and
tests/test_units.py:386-424, on the CPU; plus the identities the JAX
suite holds: RKS(xc=None, hyb=1) is RHF, the Dudarev energy's oracles,
v_U = dE_U/dD, and the GW bare-exchange limit of tests/test_gw.py:21-35
with the port's RKS.

Tolerances: E 1e-9, dm 1e-7 and the same SCF iteration count against JAX;
RKS(None, hyb=1) against the port's SCF RHF 1e-9; the Dudarev oracles
1e-12; v_U against central differences 1e-7; hub_u_correction 1e-12 and
HF_plus_U (rho 1e-8, E 1e-9) against JAX; the bare GW limit 1e-9.
The JAX drivers of the cases run once, each in its own thread, at most
two at a time (a module-scoped fixture).
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

torch.set_num_threads(1)
CPU = torch.device("cpu")
H2 = [("H", (0, 0, 0)), ("H", (0, 0, 1.4))]


def _ring(n=6, r=2.0):
    ang = 2 * np.pi * np.arange(n) / n
    R = r / (2 * np.sin(np.pi / n))
    return [("H", (R * np.cos(a), R * np.sin(a), 0.0)) for a in ang]


def _lowdin(S):
    w, v = np.linalg.eigh(S)
    return v @ np.diag(w ** -0.5) @ v.T


def _counted(solver):
    """Count a JAX driver's calls of _plus_u: once per SCF iteration (and
    once more after an RKS loop)."""
    calls = []
    plain = solver._plus_u

    def wrapped(dm):
        calls.append(1)
        return plain(dm)
    solver._plus_u = wrapped
    return calls


# name: (atoms, basis, class, kwargs, kernel kwargs); U drivers get the
# Lowdin orbitals of their molecule as their first argument
CASES = {
    "rks-lsda-h2": (H2, "RKS", dict(xc="lsda"), {}),
    "rks-pbe-h2": (H2, "RKS", dict(xc="pbe", n_rad=50), {}),
    "rks-hf-h2": (H2, "RKS", dict(xc=None, hyb=1.0), {}),
    "rks-lsda-hyb-ring6": (_ring(6), "RKS", dict(xc="lsda", hyb=0.25,
                                                  n_rad=30), {}),
    "uks-lsda-h": ([("H", (0, 0, 0))], "UKS",
                   dict(xc="lsda", nelec=(1, 0), n_rad=50), {}),
    "uks-pbe-h": ([("H", (0, 0, 0))], "UKS",
                  dict(xc="pbe", nelec=(1, 0), n_rad=50), {}),
    "rkspu-ring6": (_ring(6), "RKSpU", dict(U_idx=[[0]], U_val=[3.0],
                                            xc="lsda", n_rad=40), {}),
    "ukspu-stretched-h2": (
        [("H", (0, 0, 0)), ("H", (0, 0, 3.2))], "UKSpU",
        dict(U_idx=[[0], [1]], U_val=[2.0, 2.0], xc="lsda", n_rad=40,
             nelec=(1, 1)),
        {"dm0": np.array([[[1.0, 0.0], [0.0, 0.0]],
                          [[0.0, 0.0], [0.0, 1.0]]])}),
}


def _case(case):
    """(atoms, class name, driver args, kwargs, kernel kwargs)."""
    from libdmet_preview_tpu_torch.ints.gto import Mole
    atoms, cls, kw, run_kw = CASES[case]
    kw = dict(kw)
    args = ()
    if cls.endswith("pU"):
        args = (_lowdin(Mole(atoms, "sto-6g").intor_ovlp()),
                kw.pop("U_idx"), kw.pop("U_val"))
    return atoms, cls, args, kw, run_kw


def _jax_ks(case):
    from libdmet_preview_tpu.ints.gto import Mole as JMole
    from libdmet_preview_tpu.solvers import ksdft as jks
    atoms, cls, args, kw, run_kw = _case(case)
    js = getattr(jks, cls)(JMole(atoms, "sto-6g"), *args, **kw)
    calls = _counted(js)
    E, dm = js.kernel(**run_kw)
    out = {"E": E, "dm": np.asarray(dm), "converged": js.converged,
           "calls": len(calls)}
    if cls.startswith("R"):
        out.update({k: np.asarray(getattr(js, k))
                    for k in ("vj", "vk", "vxc", "fock")})
        out.update(exc=js.exc, E_U=js.E_U)
    return out


@pytest.fixture(scope="module")
def jax_ks():
    """{case: the JAX driver's results}, each case in its own thread, at
    most two at a time."""
    with ThreadPoolExecutor(min(2, len(CASES))) as ex:
        futures = {case: ex.submit(_jax_ks, case) for case in CASES}
        return {case: f.result() for case, f in futures.items()}


@pytest.mark.parametrize("case", sorted(CASES))
def test_ks_matches_jax(case, jax_ks):
    from libdmet_preview_tpu_torch.ints.gto import Mole
    from libdmet_preview_tpu_torch.solvers import ksdft as tks
    atoms, cls, args, kw, run_kw = _case(case)
    mt = Mole(atoms, "sto-6g")
    ref = jax_ks[case]
    Ej, dmj = ref["E"], ref["dm"]
    ts = getattr(tks, cls)(mt, *args, device=CPU, **kw)
    Et, dmt = ts.kernel(**run_kw)
    assert ts.converged and ref["converged"]
    assert ts.cycles == ref["calls"] - (1 if cls.startswith("R") else 0)
    assert abs(Et - Ej) < 1e-9
    assert np.abs(dmt.numpy() - dmj).max() < 1e-7
    if cls.startswith("R"):
        for name in ("vj", "vk", "vxc", "fock"):
            assert np.abs(getattr(ts, name).numpy() - ref[name]).max() < 1e-7
        assert abs(ts.exc - ref["exc"]) < 1e-9
        assert abs(ts.E_U - ref["E_U"]) < 1e-9
    if cls == "RKSpU":
        # +U pushes charge off the U site and costs energy (E_U > 0)
        SC = torch.as_tensor(mt.intor_ovlp() @ args[0])[:, 0]
        E0, dm0 = tks.RKS(mt, xc="lsda", n_rad=40, device=CPU).kernel()
        assert float(SC @ dmt @ SC) < float(SC @ dm0 @ SC) - 1e-3
        assert ts.E_U > 0.0 and Et > E0
    if cls == "UKSpU":
        SC = torch.as_tensor(mt.intor_ovlp() @ args[0])
        m = [float(SC[:, i] @ (dmt[0] - dmt[1]) @ SC[:, i]) for i in (0, 1)]
        assert m[0] > 0.3 and m[1] < -0.3 and abs(m[0] + m[1]) < 1e-6


def test_rks_hf_limit_is_the_ports_rhf():
    from libdmet_preview_tpu_torch.ints.gto import Mole
    from libdmet_preview_tpu_torch.models.integral import Integral
    from libdmet_preview_tpu_torch.solvers import RKS
    from libdmet_preview_tpu_torch.solvers.scf import SCF
    mol = Mole(H2, "sto-6g")
    hf = RKS(mol, xc=None, hyb=1.0, device=CPU)
    E_ks, _ = hf.kernel()
    Ham = Integral(mol.nao, True, False, mol.energy_nuc(),
                   {"cd": mol.intor_hcore()[None]},
                   {"ccdd": mol.intor_eri()[None]}, ovlp=mol.intor_ovlp())
    myscf = SCF(device=CPU)
    myscf.set_system(mol.nelectron, 0, False, True)
    myscf.set_integral(Ham)
    E_hf, _ = myscf.HF(tol=1e-12)
    assert hf.converged and abs(E_ks - E_hf) < 1e-9


def test_gw_bare_limit_with_the_ports_rks():
    """tests/test_gw.py:21-35: with screening off, get_vsig_emb on the
    converged RHF pieces is exactly -K/2."""
    from libdmet_preview_tpu_torch.ints.gto import Mole
    from libdmet_preview_tpu_torch.solvers import RKS
    from libdmet_preview_tpu_torch.solvers.gw import get_vsig_emb
    mol = Mole(H2, "sto-6g")
    hf = RKS(mol, xc=None, hyb=1.0, device=CPU)
    hf.kernel()
    vj, vk = hf._jk(hf.dm)
    fock = torch.as_tensor(mol.intor_hcore()) + vj - 0.5 * vk
    vsig = get_vsig_emb(fock, mol.intor_eri(), mol.nelectron,
                        ovlp=mol.intor_ovlp(), screened=False, device=CPU)
    assert (vsig[0] + 0.5 * vk).abs().max() < 1e-9


def test_dudarev_oracles_and_vu_gradient():
    """The Dudarev energy's oracles of tests/test_dftu_ks.py, and v_U ==
    dE_U/dD by central differences for RKSpU and UKSpU."""
    from libdmet_preview_tpu_torch.ints.gto import Mole
    from libdmet_preview_tpu_torch.solvers.ksdft import (RKSpU, UKSpU,
                                                         _dudarev)
    U = 4.0
    T = torch.as_tensor
    E_idem, _ = _dudarev(T(np.diag([1.0, 0.0])), U)
    E_half, _ = _dudarev(T(np.diag([0.5, 0.5])), U)
    assert abs(float(E_idem) - U / 4.0) < 1e-12
    assert abs(float(E_half) - (U / 4.0 + U / 4.0 * 0.5)) < 1e-12
    Q = np.linalg.qr(np.random.RandomState(0).randn(3, 3))[0]
    P = np.diag([0.9, 0.4, 0.1])
    assert abs(float(_dudarev(T(P), U)[0])
               - float(_dudarev(T(Q @ P @ Q.T), U)[0])) < 1e-12

    mol = Mole(_ring(4), "sto-6g")
    C = _lowdin(mol.intor_ovlp())
    n = mol.nao
    rng = np.random.RandomState(0)
    A = rng.randn(n, n)
    dm = A @ A.T * 0.1 + 0.5 * np.eye(n)
    eps = 1e-6
    for drv, D in ((RKSpU(mol, C, [[0, 1], [2]], [0.7, 0.3], xc=None,
                          n_rad=10, device=CPU), dm),
                   (UKSpU(mol, C, [[0, 3]], [0.9], xc=None, n_rad=10,
                          device=CPU), np.stack([dm * 0.6, dm * 0.4]))):
        _, vU = drv._plus_u(D)
        fd = np.zeros_like(D)
        for idx in np.ndindex(*D.shape):
            Dp, Dm = D.copy(), D.copy()
            Dp[idx] += eps
            Dm[idx] -= eps
            fd[idx] = (drv._plus_u(Dp)[0] - drv._plus_u(Dm)[0]) / (2 * eps)
        fd = 0.5 * (fd + np.swapaxes(fd, -1, -2))
        assert np.abs(fd - vU.numpy()).max() < 1e-7


def test_hub_u_correction_and_hf_plus_u_match_jax():
    """tests/test_units.py:386-424: the +U potential and energy on a random
    k-resolved density, and the self-consistent HF+U on the 3-cell x
    2-atom H ring (U = 0 is plain HF; U = 1 raises E)."""
    from libdmet_preview_tpu.models.abinitio import make_h_ring_lattice as JL
    from libdmet_preview_tpu.ops import dftu as jd
    from libdmet_preview_tpu_torch.ints.gto import h_ring_mole
    from libdmet_preview_tpu_torch.models.abinitio import make_h_ring_lattice
    from libdmet_preview_tpu_torch.ops import dftu as td
    rng = np.random.RandomState(16)
    r_re = rng.rand(1, 3, 4, 4) * 0.3
    r_re = 0.5 * (r_re + r_re.transpose(0, 1, 3, 2))
    r_im = rng.rand(1, 3, 4, 4) * 0.1
    r_im = 0.5 * (r_im - r_im.transpose(0, 1, 3, 2))
    for args in (((r_re, r_im), [[0, 1]], [2.0]),
                 ((r_re[0], r_im[0]), [[0, 1], [3]], [2.0, 0.5]),
                 ((np.concatenate([r_re, 0.5 * r_re]),
                   np.concatenate([r_im, r_im])), [[1, 2]], [1.5])):
        (vj_re, vj_im), Ej = jd.hub_u_correction(*args)
        (vt_re, vt_im), Et = td.hub_u_correction(*args)
        assert abs(Et - Ej) < 1e-12
        assert np.abs(vt_re - vj_re).max() < 1e-12
        assert np.abs(vt_im - vj_im).max() < 1e-12
    Lj, mj = JL(3, 2, 1.8, basis="sto-6g")
    Lt, mt = make_h_ring_lattice(h_ring_mole(6, 1.8, "sto-6g"), ncells=3,
                                 device=CPU)
    filling = mt["mole"].nelectron / (2.0 * mt["mole"].nao)
    E0 = None
    for U in (0.0, 1.0):
        rho_j, mu_j, E_j = jd.HF_plus_U(Lj, None, filling, True, [[0, 1]],
                                        [U])
        rho_t, mu_t, E_t = td.HF_plus_U(Lt, None, filling, True, [[0, 1]],
                                        [U])
        assert abs(E_t - E_j) < 1e-9 and abs(mu_t - mu_j) < 1e-8
        assert np.abs(np.asarray(rho_t) - np.asarray(rho_j)).max() < 1e-8
        if U == 0.0:
            assert abs(E_t - mt["E_hf"] / Lt.ncells) < 1e-8
            E0 = E_t
    assert E_t > E0 and np.all(np.isfinite(rho_t))
