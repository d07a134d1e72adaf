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
    """FCI(ghf=True), which raised before the GSO slice, now solves: one
    species with nelec = (n, 0).  Without a two-body term E is the sum of
    the n lowest levels of h plus H0 and rdm1 their projector (1e-10)."""
    from libdmet_preview_tpu_torch.models.integral import Integral
    from libdmet_preview_tpu_torch.solvers import FCI
    h = random_ints(6, 11)[0]
    ham = Integral(6, True, False, 0.25, {"cd": h[None]},
                   {"ccdd": np.zeros((1,) + (6,) * 4)})
    rdm1, E = FCI(restricted=True, ghf=True, tol=1e-12,
                  device=CPU).run(ham, nelec=2)
    ew, ev = np.linalg.eigh(h)
    assert abs(E - (ew[0] + ew[1] + 0.25)) < 1e-10
    assert np.abs(np.asarray(rdm1[0]) - ev[:, :2] @ ev[:, :2].T).max() < 1e-10


# ----------------------------------------------------------------------
# the FCI sigma kernel (csrc/fci_sigma.cu) through its plan and mirror
# ----------------------------------------------------------------------

def _absorbed_blocks(h1e, eri, norb, nelec, spin_dep):
    from libdmet_preview_tpu_torch.solvers import fci as tfci
    if spin_dep:
        return tfci.absorb_h1e_uhf(tuple(torch.as_tensor(x) for x in h1e),
                                   tuple(torch.as_tensor(x) for x in eri),
                                   norb, sum(nelec))
    h2e = tfci.absorb_h1e_rhf(torch.as_tensor(h1e), torch.as_tensor(eri),
                              norb, sum(nelec))
    return h2e, h2e, h2e


# RHF and UHF integrals; GHF shapes (nb = 1: no beta links); odd norb and
# unequal spins; a plan split along the strings and an unsplit one; 12
# orbitals (nn = 144, two passes of 5 + 4 m-tiles) at (3, 3), the largest
# 12-orbital filling whose plain sigma fits the test's time and memory
@pytest.mark.parametrize("norb, nelec, spin_dep, nsplit", [
    (4, (2, 2), False, None), (5, (3, 2), True, None),
    (5, (2, 3), True, 3), (6, (3, 3), True, 1), (6, (3, 3), False, 4),
    (6, (4, 0), False, None), (7, (3, 0), False, 2), (3, (3, 2), True, None),
    (2, (1, 1), True, None), (5, (1, 1), True, None), (8, (4, 4), True, None),
    (10, (5, 5), True, None), (12, (3, 3), True, None)])
def test_sigma_mirror_matches_plain(norb, nelec, spin_dep, nsplit):
    """The kernel's plan run in PyTorch (ops/fci_sigma.sigma_mirror: the
    batches, tiles, splits, passes, packed link words, target rows and the
    pieces' sum) equals the plain sigma to 1e-12 relative; its adds of
    one step never meet (the mirror raises otherwise)."""
    from libdmet_preview_tpu_torch.ops import fci_sigma as fs
    from libdmet_preview_tpu_torch.solvers import fci as tfci
    h1e, eri = random_ints(norb, seed=norb + 3 * nelec[0], spin_dep=spin_dep)
    na = tfci.num_strings(norb, nelec[0])
    nb = tfci.num_strings(norb, nelec[1])
    c = torch.as_tensor(np.random.RandomState(norb).randn(na, nb))
    ref = tfci.make_sigma(h1e, eri, norb, nelec, CPU)[0](c)
    W = fs.prepare_w(*_absorbed_blocks(h1e, eri, norb, nelec, spin_dep),
                     norb)
    plan = fs.sigma_plan(norb, nelec, nsplit=nsplit)
    if nsplit is not None:
        assert plan.nsplit == nsplit
    out = fs.sigma_mirror(W, c, norb, nelec, plan)
    assert float((out - ref).abs().max() / ref.abs().max()) < 1e-12


@pytest.mark.parametrize("norb, nelec", [(4, 2), (6, 3), (8, 4), (10, 5),
                                         (12, 6), (12, 5), (7, 1), (5, 5)])
def test_string_batches_share_no_target(norb, nelec):
    """Every string in exactly one batch; no two strings of a batch reach
    a common string by one excitation each (the kernel's adds of a batch
    never meet); batches padded at their end."""
    from libdmet_preview_tpu_torch.ops import fci_sigma as fs
    from libdmet_preview_tpu_torch.solvers import fci as tfci
    perm, bs, nbatch = fs.string_batches(norb, nelec)
    n = tfci.num_strings(norb, nelec)
    assert bs == min(fs.JB, n) and len(perm) == bs * nbatch
    assert sorted(perm[perm >= 0].tolist()) == list(range(n))
    targets = tfci.make_link_table(norb, nelec)[:, :, 1]
    for b in perm.reshape(nbatch, bs):
        real = b[b >= 0]
        assert np.all(b[:len(real)] >= 0)
        # a string's own targets repeat only through E_pp |J> = |J>
        per = [np.unique(targets[j]) for j in real]
        assert len(np.unique(np.concatenate(per))) == sum(map(len, per))


@pytest.mark.parametrize("norb, nelec", [(4, 2), (5, 3), (6, 3), (12, 6),
                                         (16, 8)])
def test_link_tables_hold_the_links(norb, nelec):
    """The packed words decode to each string's incoming links (the
    integral row through w_rows), with padding words invalid and naming a
    row whose bank class the k-step lacks where one is free; the target
    rows hold each outgoing link at row_positions[pq]; the diagonal rows
    E_pp sit at the rows of MMA lane g = 0."""
    from libdmet_preview_tpu_torch.ops import fci_sigma as fs
    from libdmet_preview_tpu_torch.solvers import fci as tfci
    words, out, nk = fs.link_tables(norb, nelec)
    valid, sign, row, src = fs._decode(words)
    phi, nrow = fs.w_rows(norb)
    pos, nnp = fs.row_positions(norb)
    assert sorted(phi.tolist()) == sorted(set(phi.tolist()))
    assert phi.max() < nrow <= 511 and nnp % 16 == 0
    pq_in, I_in, sign_in = tfci.make_incoming_table(norb, nelec)
    inv = {int(p): q for q, p in enumerate(phi)}
    for J in range(len(words)):
        got = sorted((inv[int(r)], int(i), float(s)) for r, i, s, v in
                     zip(row[J], src[J], sign[J], valid[J]) if v)
        assert got == sorted(zip(pq_in[J].tolist(), I_in[J].tolist(),
                                 sign_in[J].tolist()))
    assert valid.sum() == pq_in.size and words.shape[1] == 4 * nk
    tab = tfci.make_link_table(norb, nelec)
    for J in range(len(out)):
        expect = np.zeros(nnp, dtype=np.int64)
        expect[pos[tab[J, :, 0]]] = (tab[J, :, 1] + 1) * tab[J, :, 2]
        assert np.array_equal(out[J].astype(np.int64), expect)
    diag = pos[np.arange(norb) * (norb + 1)]
    assert np.all(diag % 16 < 2)


@pytest.mark.parametrize("norb, nelec", [(12, (6, 6)), (12, (7, 5)),
                                         (8, (4, 4)), (16, (8, 0)),
                                         (4, (2, 2)), (3, (0, 0)),
                                         (13, (6, 6)), (16, (8, 8))])
def test_sigma_plan(norb, nelec):
    """The plan fits the card's shared memory; each side's tiles cover its
    columns and its splits its batches, one block each; the tile narrows
    where 16 columns of sigma rows do not fit (8 at 13 orbitals, 6 + 6; 1
    at 16, 8 + 8); at the three-band shape it runs one wave of 120 blocks
    (tiles of 16 columns), two passes of 5 + 4 m-tiles and ~9% padding
    over sigma_work's count."""
    from libdmet_preview_tpu_torch.ops import fci_sigma as fs
    plan = fs.sigma_plan(norb, nelec)
    assert plan.smem <= fs.SMEM_MAX
    assert plan.npass * plan.mt >= plan.nmt
    for s in plan.sides:
        if not s.same:
            assert s.blocks == 0
            continue
        assert (s.ntile - 1) * s.cs < s.npad_oth <= s.ntile * s.cs
        assert s.bps * plan.nsplit >= s.nbatch_own
        assert s.blocks == s.ntile * plan.nsplit
    widths = {(13, (6, 6)): 8, (16, (8, 8)): 1, (12, (6, 6)): 16}
    if (norb, nelec) in widths:
        assert [s.cs for s in plan.sides] == [widths[norb, nelec]] * 2
    if (norb, nelec) == (12, (6, 6)):
        assert (plan.nsplit, plan.mt, plan.npass) == (1, 5, 2)
        assert [s.blocks for s in plan.sides] == [60, 60]
        counted, run, least = fs.sigma_work(norb, nelec)
        assert counted == 41309097984 and 1.0 < run / counted < 1.1
        assert least == 2 * 924 * 924 * 84 ** 2


def test_sigma_plan_limits():
    """Beyond the kernel's limits the plan raises: 17 orbitals, an
    electron count above norb or below 0."""
    from libdmet_preview_tpu_torch.ops import fci_sigma as fs
    for norb, nelec in [(17, (2, 2)), (4, (5, 1)), (4, (2, -1))]:
        with pytest.raises(ValueError):
            fs.sigma_plan(norb, nelec)


def test_fci_sigma_wrapper_checks():
    """A CPU tensor takes the plain version; elsewhere the wrapper raises
    on a float32 c, on a c of another shape, on a non-contiguous c and
    on a device that is not CUDA, before any launch; the orbital limit
    raises at construction."""
    from libdmet_preview_tpu_torch.ops.fci_sigma import FciSigma
    meta = torch.device("meta")
    blocks = (torch.zeros((4,) * 4, device=meta),) * 3
    calls = []

    def plain(c):
        calls.append(c)
        return c
    op = FciSigma(*blocks, 4, (2, 2), meta, plain)
    c = torch.ones((6, 6), dtype=torch.float64)
    assert op(c) is c and len(calls) == 1
    launches = FciSigma.launches
    bad = [torch.ones((6, 6), dtype=torch.float32, device=meta),
           torch.ones((6, 5), dtype=torch.float64, device=meta),
           torch.ones((6, 12), dtype=torch.float64, device=meta)[:, ::2],
           torch.ones((6, 6), dtype=torch.float64, device=meta)]
    for x, word in zip(bad, ["float64", "shape", "contiguous", "meta"]):
        with pytest.raises(ValueError, match=word):
            op(x)
    assert FciSigma.launches == launches and len(calls) == 1
    with pytest.raises(ValueError, match="norb"):
        FciSigma(*(torch.zeros((17,) * 4, device=meta),) * 3, 17, (2, 2),
                 meta, plain)


@pytest.mark.parametrize("restricted", [True, False])
def test_fci_kernel_calls_make_sigma_through_the_module(monkeypatch,
                                                        restricted):
    """fci_kernel builds its sigma through the module attribute
    solvers.fci.make_sigma, so a wrap of it (the benchmark's adapter, its
    CUDA events) sees every build that FCI.n_sigma counts."""
    from libdmet_preview_tpu_torch import interop
    from libdmet_preview_tpu_torch.solvers import FCI
    from libdmet_preview_tpu_torch.solvers import fci as tfci
    norb = 4
    if restricted:
        h1, eri = random_ints(norb, seed=21)
        H1, H2 = h1[None], eri[None]
    else:
        (ha, hb), (gaa, gab, gbb) = random_ints(norb, seed=22, spin_dep=True)
        H1, H2 = np.stack([ha, hb]), np.stack([gaa, gbb, gab])
    seen = {"make": 0, "build": 0}
    orig = tfci.make_sigma

    def wrapped(*args, **kwargs):
        seen["make"] += 1
        sigma, hdiag = orig(*args, **kwargs)

        def counted(c):
            seen["build"] += 1
            return sigma(c)
        return counted, hdiag
    monkeypatch.setattr(tfci, "make_sigma", wrapped)
    solver = FCI(restricted=restricted, tol=1e-11, device=CPU)
    for shift in (0.0, 0.1):
        Ham = interop.integral_from_numpy(norb, restricted, 0.0,
                                          H1 + shift * np.eye(norb), H2, CPU)
        solver.run(Ham, nelec=4)
    assert seen["make"] == solver.n_run == 2
    assert seen["build"] == solver.n_sigma > 0


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernel has no "
                    "CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("norb, nelec, spin_dep", [
    (12, (6, 6), True), (12, (6, 6), False), (8, (4, 4), True),
    (16, (8, 0), False), (5, (3, 2), True), (4, (4, 3), True),
    (13, (6, 6), True), (14, (6, 1), False), (16, (8, 1), True)])
def test_cuda_fci_sigma_matches_plain(cuda_device, norb, nelec, spin_dep):
    """The kernel vs the plain sigma on the card: 1e-12 relative to max
    |sigma|, two calls bit-identical, three launches a build."""
    from libdmet_preview_tpu_torch.ops import fci_sigma as fs
    from libdmet_preview_tpu_torch.solvers import fci as tfci
    h1e, eri = random_ints(norb, seed=norb, spin_dep=spin_dep)
    na = tfci.num_strings(norb, nelec[0])
    nb = tfci.num_strings(norb, nelec[1])
    c = torch.as_tensor(np.random.RandomState(1).randn(na, nb),
                        device=cuda_device)
    sigma, _ = tfci.make_sigma(h1e, eri, norb, nelec, cuda_device)
    before = fs.FciSigma.launches
    a, b = sigma(c), sigma(c)
    torch.cuda.synchronize()
    assert fs.FciSigma.launches == before + 2 * fs.LAUNCHES
    assert torch.equal(a, b)
    ref = tfci.make_sigma(h1e, eri, norb, nelec, CPU)[0](c.cpu())
    assert float((a.cpu() - ref).abs().max() / ref.abs().max()) < 1e-12
