"""
The PyTorch port's FCI solver (libdmet_preview_tpu_torch/solvers/fci.py)
against the JAX package's (libdmet_preview_tpu/solvers/fci.py) on the CPU:
link tables, sigma, the Hamiltonian diagonal, the Davidson ground state
with its rdm1/rdm2, and the solver class, on integrals made with NumPy
from seeds.  The dense oracle is the matrix the port's sigma builds from
the identity, diagonalized with NumPy.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

CPU = torch.device("cpu")


def random_ints(norb, seed, spin_dep=False):
    """Random s8-symmetric integrals: (h1, eri), or with spin_dep
    ((h1a, h1b), (g_aa, g_ab, g_bb))."""
    rng = np.random.RandomState(seed)

    def sym1():
        h = rng.rand(norb, norb) - 0.5
        return h + h.T

    def sym2():
        npair = norb * (norb + 1) // 2
        m = rng.rand(npair, npair) - 0.5
        m = m + m.T
        tril = np.tril_indices(norb)
        half = np.zeros((norb, norb, npair))
        half[tril[0], tril[1]] = m
        half[tril[1], tril[0]] = m
        eri = np.zeros((norb,) * 4)
        eri[:, :, tril[0], tril[1]] = half
        eri[:, :, tril[1], tril[0]] = half
        return eri

    if not spin_dep:
        return sym1(), sym2()
    return (sym1(), sym1()), (sym2(), sym2(), sym2())


def hubbard_ring_ints(norb, U):
    """Spin-swap-symmetric integrals in the unrestricted layout: a Hubbard
    ring, the same h1 and on-site U for both spins."""
    h1 = np.zeros((norb, norb))
    for i in range(norb):
        h1[i, (i + 1) % norb] = h1[(i + 1) % norb, i] = -1.0
    eri = np.zeros((norb,) * 4)
    for i in range(norb):
        eri[i, i, i, i] = U
    return (h1, h1.copy()), (eri, eri.copy(), eri.copy())


def dense_hamiltonian(h1e, eri, norb, nelec):
    """H as a dense matrix: the port's sigma applied to the identity."""
    from libdmet_preview_tpu_torch.solvers import fci as tfci
    sigma, _ = tfci.make_sigma(h1e, eri, norb, nelec, CPU)
    na = tfci.num_strings(norb, nelec[0])
    nb = tfci.num_strings(norb, nelec[1])
    eye = torch.eye(na * nb, dtype=torch.float64)
    cols = [sigma(eye[i].reshape(na, nb)).reshape(-1) for i in range(na * nb)]
    return torch.stack(cols, dim=1).numpy()


@pytest.mark.parametrize("norb,nelec", [(4, 2), (5, 3), (6, 3), (6, 0)])
def test_link_tables_equal_jax(norb, nelec):
    """Strings, the link table and the flat link arrays: exactly equal."""
    from libdmet_preview_tpu.solvers import fci as jfci
    from libdmet_preview_tpu_torch.solvers import fci as tfci
    assert np.array_equal(tfci.make_strings(norb, nelec),
                          jfci.make_strings(norb, nelec))
    assert np.array_equal(tfci.make_link_table(norb, nelec),
                          jfci.make_link_table(norb, nelec))
    for a, b in zip(tfci._flat_links(norb, nelec),
                    jfci._flat_links(norb, nelec)):
        assert np.array_equal(a, b)
    assert tfci.num_strings(norb, nelec) == jfci.num_strings(norb, nelec)


@pytest.mark.parametrize("norb,nelec", [(4, 2), (5, 3), (6, 2)])
def test_incoming_table_consistent(norb, nelec):
    """Every outgoing link (I, pq, J, sign) appears once among the
    incoming links of J, and every string has nlink of them."""
    from libdmet_preview_tpu_torch.solvers import fci as tfci
    I, pq, J, sign = tfci._flat_links(norb, nelec)
    pq_in, I_in, sign_in = tfci.make_incoming_table(norb, nelec)
    nstr, nlink = pq_in.shape
    assert nstr == tfci.num_strings(norb, nelec)
    assert nlink == nelec * (norb - nelec + 1)
    out = sorted(zip(J.tolist(), pq.tolist(), I.tolist(), sign.tolist()))
    inc = sorted((j, int(pq_in[j, l]), int(I_in[j, l]), float(sign_in[j, l]))
                 for j in range(nstr) for l in range(nlink))
    assert out == inc


@pytest.mark.parametrize("norb,nelec,spin_dep", [
    (4, (2, 2), False), (5, (3, 2), False), (6, (3, 3), False),
    (4, (2, 2), True), (5, (2, 3), True), (6, (3, 3), True)])
def test_sigma_and_hdiag_match_jax(norb, nelec, spin_dep):
    """sigma on a random CI vector and the diagonal: 1e-12; two sigma
    calls bit-identical."""
    import jax.numpy as jnp
    from libdmet_preview_tpu.solvers import fci as jfci
    from libdmet_preview_tpu_torch.solvers import fci as tfci
    h1e, eri = random_ints(norb, seed=norb + 7 * sum(nelec), spin_dep=spin_dep)
    la = tuple(jnp.asarray(x) for x in jfci._flat_links(norb, nelec[0]))
    lb = tuple(jnp.asarray(x) for x in jfci._flat_links(norb, nelec[1]))
    na = jfci.num_strings(norb, nelec[0])
    nb = jfci.num_strings(norb, nelec[1])
    ci = np.random.RandomState(1).randn(na, nb)
    if spin_dep:
        ha, hab, hb = jfci.absorb_h1e_uhf(h1e, eri, norb, sum(nelec))
        ref = jfci._sigma_uhf(jnp.asarray(ha), jnp.asarray(hab),
                              jnp.asarray(hb), jnp.asarray(ci), la, lb, norb)
        hd_ref = jfci.make_hdiag(h1e, eri, norb, nelec)
    else:
        h2e = jfci.absorb_h1e_rhf(h1e, eri, norb, sum(nelec))
        ref = jfci._sigma_rhf(jnp.asarray(h2e), jnp.asarray(ci), la, lb, norb)
        hd_ref = jfci.make_hdiag((h1e,) * 2, (eri,) * 3, norb, nelec)
    sigma, hdiag = tfci.make_sigma(h1e, eri, norb, nelec, CPU)
    out = sigma(torch.as_tensor(ci))
    assert np.abs(out.numpy() - np.asarray(ref)).max() < 1e-12
    assert torch.equal(out, sigma(torch.as_tensor(ci)))
    assert np.abs(hdiag.numpy() - hd_ref).max() < 1e-12


def _rdms(mod, ci, norb, nelec):
    return ([np.asarray(x) for x in mod.make_rdm1s(ci, norb, nelec)],
            [np.asarray(x) for x in mod.make_rdm2s(ci, norb, nelec)])


@pytest.mark.parametrize("case", ["restricted", "unrestricted",
                                  "spin-swap symmetric"])
def test_fci_kernel_matches_jax_and_dense(case):
    """Ground-state energy 1e-10 against the JAX FCI and against dense
    eigh of the sigma-built matrix; rdm1 and rdm2 1e-8.  The spin-swap
    symmetric case (a half-filled Hubbard ring in the unrestricted
    layout) is the one where a Davidson without noise and guard roots
    converges, with zero residual, to the lowest triplet."""
    from libdmet_preview_tpu.solvers import fci as jfci
    from libdmet_preview_tpu_torch.solvers import fci as tfci
    if case == "restricted":
        norb, nelec = 5, (3, 2)
        h1e, eri = random_ints(norb, seed=3)
    elif case == "unrestricted":
        norb, nelec = 5, (2, 2)
        h1e, eri = random_ints(norb, seed=4, spin_dep=True)
    else:
        norb, nelec = 4, (2, 2)
        h1e, eri = hubbard_ring_ints(norb, U=4.0)
    e_j, ci_j = jfci.fci_kernel(h1e, eri, norb, nelec, tol=1e-12)
    e_t, ci_t = tfci.fci_kernel(h1e, eri, norb, nelec, tol=1e-12, device=CPU)
    assert isinstance(e_t, float) and ci_t.shape == ci_j.shape
    assert abs(e_t - e_j) < 1e-10
    w = np.linalg.eigvalsh(dense_hamiltonian(h1e, eri, norb, nelec))
    assert abs(e_t - w[0]) < 1e-10
    r1_j, r2_j = _rdms(jfci, ci_j, norb, nelec)
    r1_t, r2_t = _rdms(tfci, ci_t, norb, nelec)
    for a, b in zip(r1_t + r2_t, r1_j + r2_j):
        assert np.abs(a - b).max() < 1e-8
    if case == "spin-swap symmetric":
        # a singlet: the triplet of this ring lies well above it
        assert w[1] - w[0] > 1e-3
        assert abs(np.trace(r1_t[0]) - 2.0) < 1e-10


@pytest.mark.parametrize("restricted", [True, False])
def test_solver_class_matches_jax(restricted):
    """FCI.run (rdm1 1e-8, E 1e-10), the warm-started second run on a
    shifted Hamiltonian, and run_dmet_ham on a scaled one (1e-10), from
    the same Integral carried across with interop.integral_from_numpy."""
    from libdmet_preview_tpu.models.integral import Integral
    from libdmet_preview_tpu.solvers import FCI as JFCI
    from libdmet_preview_tpu_torch import interop
    from libdmet_preview_tpu_torch.solvers import FCI as TFCI
    norb, nelec = 4, 4
    if restricted:
        h1, eri = random_ints(norb, seed=11)
        H1, H2 = h1[None], eri[None]
    else:
        (ha, hb), (gaa, gab, gbb) = random_ints(norb, seed=12, spin_dep=True)
        H1, H2 = np.stack([ha, hb]), np.stack([gaa, gbb, gab])
    jsol = JFCI(restricted=restricted, tol=1e-11)
    tsol = TFCI(restricted=restricted, tol=1e-11, device=CPU)
    for shift in (0.0, 0.05):
        H1s = H1 + shift * np.eye(norb)
        Ham = Integral(norb, restricted, False, 0.3, {"cd": H1s.copy()},
                       {"ccdd": H2.copy()})
        Ham_t = interop.integral_from_numpy(norb, restricted, 0.3, H1s, H2,
                                            CPU)
        r_j, e_j = jsol.run(Ham, nelec=nelec)
        r_t, e_t = tsol.run(Ham_t, nelec=nelec)
        assert abs(e_t - e_j) < 1e-10
        assert np.abs(r_t.numpy() - np.asarray(r_j)).max() < 1e-8
    assert tsol.n_run == 2 and tsol.n_sigma > 0
    scaled = Integral(norb, restricted, False, 0.1, {"cd": 0.5 * H1},
                      {"ccdd": 0.25 * H2})
    scaled_t = interop.integral_from_numpy(norb, restricted, 0.1, 0.5 * H1,
                                           0.25 * H2, CPU)
    assert abs(tsol.run_dmet_ham(scaled_t) - jsol.run_dmet_ham(scaled)) < 1e-10
    r2_j = np.asarray(jsol.twopdm)
    assert np.abs(tsol.twopdm.numpy() - r2_j).max() < 1e-8


def test_ghf_branch_raises():
    from libdmet_preview_tpu_torch.solvers import FCI
    with pytest.raises(NotImplementedError):
        FCI(restricted=True, ghf=True, device=CPU)
