"""
The PyTorch port's coupled-cluster core (libdmet_preview_tpu_torch/solvers/
cc.py: spin-orbital assembly, residual, energy, denominators, amplitude
fixed point, adjoint solve, the autograd energy) and ao2mo_Ham /
restore_Ham against the JAX package's (libdmet_preview_tpu/solvers/cc.py,
solvers/scf.py) on identical NumPy-seeded inputs, on the CPU.  At most 8
spin orbitals.
"""

from functools import lru_cache

import numpy as np
import pytest
import torch

import jax

jax.config.update("jax_enable_x64", True)

torch.set_num_threads(1)

CPU = torch.device("cpu")
N, NA, NB = 4, 2, 2          # spatial orbitals, alpha / beta electrons
NOCC = NA + NB


def T(x):
    return torch.as_tensor(np.array(x, dtype=np.float64))


@lru_cache(maxsize=None)
def blocks(seed=0, n=N):
    """Gapped one-body blocks, PSD two-body blocks [aa, bb, ab] and
    orthogonal MO coefficients, NumPy from `seed`."""
    rng = np.random.RandomState(seed)
    h = rng.randn(2, n, n) * 0.1
    h = h + h.transpose(0, 2, 1) + np.diag(np.arange(n, dtype=float))
    naux = n * (n + 1) // 2
    A = rng.randn(2, naux, n, n) * (0.5 / n)
    A = A + A.transpose(0, 1, 3, 2)
    g = [np.einsum("Lpq, Lrs -> pqrs", A[i], A[j])
         for i, j in ((0, 0), (1, 1), (0, 1))]
    Ca = np.linalg.qr(rng.randn(n, n))[0]
    Cb = np.linalg.qr(rng.randn(n, n))[0]
    return h, g, Ca, Cb


@lru_cache(maxsize=None)
def so_integrals(canonical):
    """(h_so, W) of both packages; with `canonical` the MO coefficients
    diagonalize a mean-field-like one-body operator (so the fixed point
    contracts), else they are random rotations."""
    from libdmet_preview_tpu.solvers import cc as jcc
    from libdmet_preview_tpu_torch.solvers import cc as tcc
    h, g, Ca, Cb = blocks()
    if canonical:
        Ca = np.linalg.eigh(h[0])[1]
        Cb = np.linalg.eigh(h[1])[1]
    hj, gj = jcc._mo_so_integrals((h[0], h[1]), g, Ca, Cb, NA, NB)
    ht, gt = tcc._mo_so_integrals((T(h[0]), T(h[1])), [T(x) for x in g],
                                  T(Ca), T(Cb), NA, NB)
    return (hj, jcc._antisymmetrize(gj), gj), (ht, tcc._antisymmetrize(gt), gt)


def amplitudes(seed=3):
    rng = np.random.RandomState(seed)
    nvir = 2 * N - NOCC
    t2 = rng.randn(NOCC, NOCC, nvir, nvir) * 0.1
    t2 = t2 - t2.transpose(1, 0, 2, 3)
    t2 = t2 - t2.transpose(0, 1, 3, 2)
    return rng.randn(NOCC, nvir) * 0.1, t2


def close(a, b, tol):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.detach().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape
    assert np.abs(a - b).max() < tol


def test_mo_so_integrals_and_antisymmetrize():
    """h_so, g_so and W = <pq||rs>: 1e-12."""
    (hj, Wj, gj), (ht, Wt, gt) = so_integrals(False)
    close(ht, hj, 1e-12)
    close(gt, gj, 1e-12)
    close(Wt, Wj, 1e-12)
    assert tuple(Wt.shape) == (2 * N,) * 4


@pytest.mark.parametrize("mp2", [False, True])
def test_residual(mp2):
    """R1 and R2 at random antisymmetric amplitudes: 1e-12."""
    from libdmet_preview_tpu.solvers import cc as jcc
    from libdmet_preview_tpu_torch.solvers import cc as tcc
    (hj, Wj, _), (ht, Wt, _) = so_integrals(False)
    t1, t2 = amplitudes()
    Rj = jcc._residual(t1, t2, hj, Wj, NOCC, mp2=mp2)
    Rt = tcc._residual(T(t1), T(t2), ht, Wt, NOCC, mp2=mp2)
    close(Rt[0], Rj[0], 1e-12)
    close(Rt[1], Rj[1], 1e-12)


def test_ecorr_and_denominators():
    """The correlation energy at random amplitudes and D1, D2: 1e-12."""
    from libdmet_preview_tpu.solvers import cc as jcc
    from libdmet_preview_tpu_torch.solvers import cc as tcc
    (hj, Wj, _), (ht, Wt, _) = so_integrals(False)
    t1, t2 = amplitudes()
    assert abs(float(jcc._ecorr(t1, t2, hj, Wj, NOCC))
               - float(tcc._ecorr(T(t1), T(t2), ht, Wt, NOCC))) < 1e-12
    for Dj, Dt in zip(jcc._denominators(hj, Wj, NOCC),
                      tcc._denominators(ht, Wt, NOCC)):
        close(Dt, Dj, 1e-12)


@lru_cache(maxsize=None)
def jax_fixed_point(freeze_t1=False):
    from libdmet_preview_tpu.solvers import cc as jcc
    (hj, Wj, _), _ = so_integrals(True)
    t1, t2, conv = jcc._solve_amplitudes(hj, Wj, NOCC, tol=1e-11,
                                         freeze_t1=freeze_t1)
    assert conv
    return np.asarray(t1), np.asarray(t2)


@pytest.mark.parametrize("kw", [{}, {"freeze_t1": True},
                                {"level_shift": 0.3},
                                {"ite_dtau": 0.3, "max_cycle": 400}],
                         ids=["ccsd", "ccd", "level_shift", "ite"])
def test_solve_amplitudes(kw):
    """The converged amplitudes: 1e-8 (the fixed point does not depend on
    level_shift or on the imaginary-time update)."""
    from libdmet_preview_tpu_torch.solvers import cc as tcc
    _, (ht, Wt, _) = so_integrals(True)
    t1j, t2j = jax_fixed_point(freeze_t1=kw.get("freeze_t1", False))
    t1, t2, conv = tcc._solve_amplitudes(ht, Wt, NOCC, tol=1e-11, **kw)
    assert conv and tcc._solve_amplitudes.last["converged"]
    assert tcc._solve_amplitudes.last["max|R|"] < 1e-11
    close(t1, t1j, 1e-8)
    close(t2, t2j, 1e-8)
    assert float(torch.abs(t2 + t2.permute(1, 0, 2, 3)).max()) < 1e-12


@pytest.mark.parametrize("kw", [{}, {"freeze_t1": True},
                                {"lambda_sweeps": 2},
                                {"freeze_t1": True, "lambda_sweeps": 2}],
                         ids=["exact", "freeze_t1", "lambda_sweeps",
                              "freeze_t1+lambda_sweeps"])
def test_solve_adjoint_from_jax_amplitudes(kw):
    """lambda from the JAX package's converged amplitudes (carried over
    with interop.cc_amplitudes_from_numpy), right-hand side dE_corr/dt:
    1e-7."""
    from libdmet_preview_tpu.solvers import cc as jcc
    from libdmet_preview_tpu_torch import interop
    from libdmet_preview_tpu_torch.solvers import cc as tcc
    (hj, Wj, _), (ht, Wt, _) = so_integrals(True)
    t1j, t2j = jax_fixed_point(freeze_t1=kw.get("freeze_t1", False))
    w1j, w2j = jax.grad(jcc._ecorr, argnums=(0, 1))(t1j, t2j, hj, Wj, NOCC)
    l1j, l2j = jcc._solve_adjoint(hj, Wj, NOCC, t1j, t2j, w1j, w2j,
                                  tol=1e-11, **kw)
    t1, t2 = interop.cc_amplitudes_from_numpy(t1j, t2j, CPU)
    l1, l2 = tcc._solve_adjoint(ht, Wt, NOCC, t1, t2, T(w1j), T(w2j),
                                tol=1e-11, **kw)
    close(l1, l1j, 1e-7)
    close(l2, l2j, 1e-7)
    assert np.abs(np.asarray(l2j)).max() > 1e-3
    last = tcc._solve_adjoint.last
    assert last["branch"] == ("lambda_sweeps" if "lambda_sweeps" in kw
                              else "diis-richardson")


def test_adjoint_rmatvec_is_the_transpose():
    """The least-squares fallback's transpose product (forward mode)
    against the matvec (reverse mode): <y, A x> = <A^T y, x>, 1e-12, with
    and without the pinned t1 sector."""
    from libdmet_preview_tpu_torch.solvers import cc as tcc
    _, (ht, Wt, _) = so_integrals(True)
    t1j, t2j = jax_fixed_point()
    D1, D2 = tcc._denominators(ht, Wt, NOCC)
    for freeze in (False, True):
        mv, rmv = tcc._adjoint_operators(ht, Wt, NOCC, T(t1j), T(t2j), D1,
                                         D2, freeze_t1=freeze)
        x, y = amplitudes(5), amplitudes(6)
        Ax = mv(T(x[0]), T(x[1]))
        Aty = rmv(T(y[0]), T(y[1]))
        lhs = sum(float(torch.sum(T(a) * b)) for a, b in zip(y, Ax))
        rhs = sum(float(torch.sum(a * T(b))) for a, b in zip(Aty, x))
        assert abs(lhs - rhs) < 1e-12


def test_adjoint_dense_fallback_matches_richardson():
    """The scipy fallbacks (GMRES, then the dense solve of a small
    system) on the converged system give the same lambda: 1e-7."""
    from libdmet_preview_tpu_torch.solvers import cc as tcc
    _, (ht, Wt, _) = so_integrals(True)
    t1j, t2j = jax_fixed_point()
    t1, t2 = T(t1j), T(t2j)
    w1, w2 = T(amplitudes(8)[0]), T(amplitudes(8)[1])
    l1, l2 = tcc._solve_adjoint(ht, Wt, NOCC, t1, t2, w1, w2, tol=1e-11)
    # two Richardson sweeps leave a residual far above 1e-8: the fallback
    # chain runs
    m1, m2 = tcc._solve_adjoint(ht, Wt, NOCC, t1, t2, w1, w2, tol=1e-11,
                                max_cycle=2)
    assert tcc._solve_adjoint.last["branch"] in ("gmres", "dense")
    close(m1, l1, 1e-7)
    close(m2, l2, 1e-7)


def test_e_tot_cc_gradient_against_central_differences():
    """dE/dh1a (all entries) and one dE/dg_ab element from the autograd
    Function against central differences of the energy: 1e-6."""
    from libdmet_preview_tpu_torch.solvers import cc as tcc
    h, g, _, _ = blocks()
    Ca, Cb = np.linalg.eigh(h[0])[1], np.linalg.eigh(h[1])[1]
    opts = (("tol", 1e-12), ("max_cycle", 100), ("diis_space", 8))

    def energy(h1a, g_ab):
        return tcc._e_tot_cc(h1a, T(h[1]), T(g[0]), T(g[1]), g_ab, T(Ca),
                             T(Cb), NA, NB, opts)

    h1a = T(h[0]).requires_grad_(True)
    g_ab = T(g[2]).requires_grad_(True)
    gh, gg = torch.autograd.grad(energy(h1a, g_ab), (h1a, g_ab))
    eps = 1e-5
    for i, j in [(0, 0), (0, 2), (3, 1)]:
        d = torch.zeros(N, N, dtype=torch.float64)
        d[i, j] = eps
        with torch.no_grad():
            fd = (energy(T(h[0]) + d, T(g[2]))
                  - energy(T(h[0]) - d, T(g[2]))) / (2 * eps)
        assert abs(float(fd) - float(gh[i, j])) < 1e-6
    idx = np.unravel_index(int(torch.argmax(torch.abs(gg))), gg.shape)
    d = torch.zeros((N,) * 4, dtype=torch.float64)
    d[idx] = eps
    with torch.no_grad():
        fd = (energy(T(h[0]), T(g[2]) + d)
              - energy(T(h[0]), T(g[2]) - d)) / (2 * eps)
    assert abs(float(fd) - float(gg[idx])) < 1e-6
    assert abs(float(gg[idx])) > 1e-2


def test_amp_diis_matches_host_diis():
    """_AmpDIIS on tensors against ops.diis.DIIS on the same sequence
    (more updates than the space holds): 1e-12; the scalars come back
    beside the one read."""
    from libdmet_preview_tpu_torch.ops.diis import DIIS
    from libdmet_preview_tpu_torch.solvers.cc import _AmpDIIS
    rng = np.random.RandomState(2)
    host, dev = DIIS(space=3), _AmpDIIS([(2, 3), (4,)], space=3)
    for it in range(6):
        x, e = rng.randn(10), rng.randn(10) * 0.5 ** it
        ref = host.update(x, xerr=e)
        (a, b), (s,) = dev.update([T(x[:6].reshape(2, 3)), T(x[6:])],
                                  [T(e[:6].reshape(2, 3)), T(e[6:])],
                                  scalars=(T(1.5 * it),))
        close(torch.cat([a.reshape(-1), b]), ref, 1e-12)
        assert s == 1.5 * it


@pytest.mark.parametrize("restricted", [True, False])
def test_ao2mo_and_restore_ham(restricted):
    """ao2mo_Ham against the JAX package's at 1e-12, and the round trip
    restore_Ham(ao2mo_Ham(H, C), C) == H at 1e-12, with per-spin
    rotations on the unrestricted Hamiltonian."""
    from libdmet_preview_tpu.models.integral import Integral as JIntegral
    from libdmet_preview_tpu.solvers import scf as jscf
    from libdmet_preview_tpu_torch import interop
    from libdmet_preview_tpu_torch.solvers import ao2mo_Ham, restore_Ham
    h, g, Ca, Cb = blocks()
    if restricted:
        H1, H2, C = h[:1], np.asarray(g[:1]), Ca
    else:
        H1, H2, C = h, np.asarray(g), np.asarray([Ca, Cb])
    Hj = JIntegral(N, restricted, False, 0.3, {"cd": H1}, {"ccdd": H2})
    Ht = interop.integral_from_numpy(N, restricted, 0.3, H1, H2, CPU)
    mo_j = jscf.ao2mo_Ham(Hj, C)
    mo_t = ao2mo_Ham(Ht, C, device=CPU)
    close(mo_t.H1["cd"], mo_j.H1["cd"], 1e-12)
    close(mo_t.H2["ccdd"], mo_j.H2["ccdd"], 1e-12)
    assert mo_t.H0 == 0.3 and mo_t.restricted == restricted
    back = restore_Ham(mo_t, C, device=CPU)
    close(back.H1["cd"], H1, 1e-12)
    close(back.H2["ccdd"], H2, 1e-12)
