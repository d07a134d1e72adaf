"""
Orbital localization in the PyTorch port (libdmet_preview_tpu_torch/lo/:
lowdin, iao, mo_match, localize, maxloc, wannier) against the JAX
package's lo/ on the CPU, on the same NumPy-seeded inputs.

Tolerances: the linear-algebra helpers (Lowdin, IAO, MO matching) 1e-12;
the localizers maximize a metric whose optimum is a point but whose
rotation gauge is free, so the metric value at the optimum is held to
1e-8 and the projector C C^T of the localized space to 1e-6; the Wannier
b-vector weights and the B1 condition exactly (the same host arithmetic),
the spread functional 1e-12, the analytic MV gradient against
torch.autograd 1e-10, the minimized spread against JAX 1e-8; the wannier90
text files byte for byte.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

torch.set_num_threads(2)
CPU = torch.device("cpu")


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _n(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _spd(rng, n, scale=0.2):
    A = rng.randn(n, n)
    return np.eye(n) + scale * (A + A.T) / np.sqrt(n)


# ----------------------------------------------------------------------
# lowdin / iao / mo_match
# ----------------------------------------------------------------------

def test_lowdin_helpers_match_jax():
    from libdmet_preview_tpu.lo import lowdin as jl
    from libdmet_preview_tpu_torch.lo import lowdin as pl
    rng = np.random.RandomState(0)
    S = _spd(rng, 7)
    C = rng.randn(7, 4)
    assert np.abs(_n(pl.lowdin_orth(_t(S))) - jl.lowdin_orth(S)).max() < 1e-12
    assert np.abs(_n(pl.vec_lowdin(_t(C), _t(S)))
                  - jl.vec_lowdin(C, S)).max() < 1e-12
    assert np.abs(_n(pl.vec_lowdin(_t(C))) - jl.vec_lowdin(C)).max() < 1e-12
    Co = jl.vec_lowdin(C, S)
    assert pl.check_orthonormal(_t(Co), _t(S)) == jl.check_orthonormal(Co, S)
    assert not pl.check_orthonormal(_t(C)) and not jl.check_orthonormal(C)
    with pytest.raises(ValueError):
        pl.lowdin_orth(_t(np.diag([1.0, 1e-14])))


def test_lowdin_kpair_helpers_match_jax():
    from libdmet_preview_tpu.lo import lowdin as jl
    from libdmet_preview_tpu_torch.lo import lowdin as pl
    rng = np.random.RandomState(1)
    nk, n, m = 6, 5, 3
    C_re, C_im = rng.randn(nk, n, m), rng.randn(nk, n, m)
    neg = (-np.arange(nk)) % nk
    a = jl.symmetrize_lo_kpair(C_re, C_im, neg)
    b = pl.symmetrize_lo_kpair(_t(C_re), _t(C_im), neg)
    for x, y in zip(a, b):
        assert np.abs(_n(y) - x).max() < 1e-12
    assert abs(pl.check_lo_time_reversal(_t(C_re), _t(C_im), neg)
               - jl.check_lo_time_reversal(C_re, C_im, neg)) < 1e-12
    assert pl.check_lo_time_reversal(*b, neg) < 1e-15
    # real columns up to a phase: the gauge fix recovers them
    R = rng.randn(nk, n, m)
    ph = np.exp(1j * rng.uniform(0, 2 * np.pi, (nk, 1, m)))
    Z = R * ph
    Z[:, :, -1] += 0.3j * rng.randn(nk, n)     # one column stays complex
    ja = jl.make_real_columns(Z.real, Z.imag)
    pb = pl.make_real_columns(_t(Z.real), _t(Z.imag))
    assert np.abs(_n(pb[0]) - ja[0]).max() < 1e-12
    assert np.abs(_n(pb[1]) - ja[1]).max() < 1e-12
    assert np.array_equal(_n(pb[2]), ja[2])
    assert _n(pb[2])[:, :-1].all() and not _n(pb[2])[:, -1].any()


@pytest.fixture(scope="module")
def h_ring_321g_ints():
    from libdmet_preview_tpu_torch.models.engine_ints import load_engine_ints
    return load_engine_ints("hring_3x2_r1.8_3-21g.npz")


def _occupied(ints):
    S, h = ints.S, ints.hcore
    w, v = np.linalg.eigh(S)
    X = (v / np.sqrt(w)) @ v.T
    e, c = np.linalg.eigh(X @ h @ X)
    return X @ c[:, :ints.nelectron // 2]


def test_iao_and_pao_match_jax(h_ring_321g_ints):
    """IAOs of the 3-21G H ring against the sto-6g reference (the
    engine's S, S12, S2), and the PAOs both ways (selected AOs and the
    complement eigenbasis)."""
    from libdmet_preview_tpu.lo import iao as ji
    from libdmet_preview_tpu_torch.lo import iao as pi
    ints = h_ring_321g_ints
    C_occ = _occupied(ints)
    a = ji.get_iao(ints.S, ints.S12, ints.S2, C_occ)
    b = pi.get_iao(_t(ints.S), _t(ints.S12), _t(ints.S2), _t(C_occ))
    assert np.abs(_n(b) - a).max() < 1e-12
    idx = [k * ints.nao_atom + 1 for k in range(ints.natom)]
    pa = ji.get_iao_virt(ints.S, a, virt_ao_idx=idx)
    pb = pi.get_iao_virt(_t(ints.S), b, virt_ao_idx=idx)
    assert np.abs(_n(pb) - pa).max() < 1e-12
    # the complement's eigenbasis: its gauge is eigh's, compare projectors
    qa = ji.get_iao_virt(ints.S, a)
    qb = _n(pi.get_iao_virt(_t(ints.S), b))
    assert qb.shape == qa.shape
    assert np.abs(qb @ qb.T - qa @ qa.T).max() < 1e-12


def test_mo_match_matches_jax():
    from libdmet_preview_tpu.lo import mo_match as jm
    from libdmet_preview_tpu_torch.lo import mo_match as pm
    rng = np.random.RandomState(2)
    S = _spd(rng, 6)
    mo_ref = np.linalg.qr(rng.randn(6, 4))[0]
    mo_new = mo_ref @ np.linalg.qr(rng.randn(4, 4))[0] \
        + 0.01 * rng.randn(6, 4)
    assert np.abs(_n(pm.get_mo_ovlp(_t(mo_new), _t(mo_ref), _t(S)))
                  - jm.get_mo_ovlp(mo_new, mo_ref, S)).max() < 1e-12
    a, ua = jm.find_closest_mo(mo_new, mo_ref, S, return_rotmat=True)
    b, ub = pm.find_closest_mo(_t(mo_new), _t(mo_ref), _t(S),
                               return_rotmat=True)
    assert np.abs(_n(b) - a).max() < 1e-12
    assert np.abs(_n(ub) - ua).max() < 1e-12
    # a leading spin axis batches
    two_new, two_ref = np.stack([mo_new, mo_ref]), np.stack([mo_ref, mo_new])
    a2 = jm.find_closest_mo(two_new, two_ref)
    b2 = pm.find_closest_mo(_t(two_new), _t(two_ref))
    assert np.abs(_n(b2) - a2).max() < 1e-12
    u2 = rng.randn(2, 4, 4)
    assert np.abs(_n(pm.trans_mo(_t(two_new), _t(u2)))
                  - jm.trans_mo(two_new, u2)).max() < 1e-12
    assert np.abs(_n(pm.get_mo_ovlp(_t(two_new), _t(two_ref)))
                  - jm.get_mo_ovlp(two_new, two_ref)).max() < 1e-12


def _host_input_outputs(dev):
    """Every entry point of lo.lowdin / iao / mo_match and the stripe and
    Lowdin helpers of models/abinitio.py, given NumPy arrays and
    `device=dev`; returns the tensors they give back."""
    from libdmet_preview_tpu_torch.lo import iao as pi
    from libdmet_preview_tpu_torch.lo import lowdin as pl
    from libdmet_preview_tpu_torch.lo import mo_match as pm
    from libdmet_preview_tpu_torch.models import abinitio as pa
    from libdmet_preview_tpu_torch.models.lattice import MeshLattice
    rng = np.random.RandomState(6)
    S = _spd(rng, 6)
    C = rng.randn(6, 3)
    C_re, C_im = rng.randn(4, 6, 3), rng.randn(4, 6, 3)
    neg = np.array([0, 3, 2, 1])
    out = [pl.lowdin_orth(S, device=dev), pl.vec_lowdin(C, S, device=dev)]
    out += pl.symmetrize_lo_kpair(C_re, C_im, neg, device=dev)
    out += pl.make_real_columns(C_re, C_im, device=dev)
    assert pl.check_orthonormal(out[1], S, device=dev)
    assert pl.check_lo_time_reversal(*out[2:4], neg, device=dev) < 1e-15
    S2 = _spd(rng, 3)
    S12 = S[:, :3]
    C_occ = np.linalg.qr(rng.randn(6, 2))[0]
    out.append(pi.get_iao(S, S12, S2, C_occ, device=dev))
    out.append(pi.get_iao_virt(S, _n(out[-1]), virt_ao_idx=[3, 4, 5],
                               device=dev))
    out += [pm.get_mo_ovlp(C, C, S, device=dev),
            pm.trans_mo(C, np.eye(3), device=dev)]
    out += pm.find_closest_mo(C, C, S, return_rotmat=True, device=dev)
    tr = MeshLattice((2, 1, 1), 3)._sub_tab
    out += [pa.lowdin(S, device=dev), pa._stripe_symm(S, 2, 3, device=dev),
            pa._stripe_symm_tr(S, tr, 3, device=dev),
            pa._expand_stripe_tr(rng.randn(2, 3, 3), tr, device=dev)]
    out += pa.make_jk_tables(rng.randn(2, 2, 2, 3, 3, 3, 3), tr, device=dev)
    return out


@pytest.mark.parametrize("dev", [
    "cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_host_input_lands_on_the_device_given(dev):
    """NumPy input goes to the `device=` given, for every helper of the
    slice that takes host arrays."""
    if dev == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = _host_input_outputs(torch.device(dev))
    assert len(out) == 19
    assert all(isinstance(x, torch.Tensor) and x.device.type == dev
               for x in out)


def test_host_input_defaults_to_the_card():
    """Without `device=`, NumPy input goes to CUDA: it lands there when
    there is a card, and raises when there is none (no CPU fallback)."""
    from libdmet_preview_tpu_torch.lo import lowdin as pl
    from libdmet_preview_tpu_torch.models import abinitio as pa
    S = _spd(np.random.RandomState(7), 4)
    for fn in (pl.lowdin_orth, pa.lowdin,
               lambda x: pa._stripe_symm(x, 2, 2)):
        if torch.cuda.is_available():
            assert fn(S).device.type == "cuda"
        else:
            with pytest.raises((AssertionError, RuntimeError)):
                fn(S)


# ----------------------------------------------------------------------
# localize (PM / ER / IBO)
# ----------------------------------------------------------------------

def _ring_lowdin_occ(ints):
    """Occupied MOs of the sto-6g H ring in its Lowdin basis."""
    w, v = np.linalg.eigh(ints.S)
    X = (v / np.sqrt(w)) @ v.T
    e, c = np.linalg.eigh(X @ ints.hcore @ X)
    return c[:, :ints.nelectron // 2], X


def _check_localized(a, b):
    Ca, ma = a
    Cb, mb = np.asarray(b[0]), b[1]
    Ca = np.asarray(Ca)
    assert abs(ma - mb) < 1e-8
    assert np.abs(Ca @ Ca.T - _n(b[0]) @ _n(b[0]).T).max() < 1e-6


def test_localize_pm_er_ibo_match_jax():
    from libdmet_preview_tpu.lo import localize as jloc
    from libdmet_preview_tpu.lo import iao as ji
    from libdmet_preview_tpu_torch.lo import localize as ploc
    from libdmet_preview_tpu_torch.models.engine_ints import load_engine_ints
    ints = load_engine_ints("hring_3x2_r1.8_sto-6g.npz")
    C_occ, X = _ring_lowdin_occ(ints)
    slices = [[a] for a in range(ints.natom)]
    a = jloc.localize_pm(C_occ, slices)
    b = ploc.localize_pm(C_occ, slices, device=CPU)
    _check_localized(a, b)
    # Mulliken charges in a non-orthogonal AO basis
    C_ao = X @ C_occ
    a = jloc.localize_pm(C_ao, slices, S=ints.S)
    b = ploc.localize_pm(C_ao, slices, S=ints.S, device=CPU)
    _check_localized(a, b)
    # Edmiston-Ruedenberg on the Lowdin-basis ERI
    eri_lo = np.einsum("pqrs, pi, qj, rk, sl -> ijkl", ints.eri, X, X, X, X,
                       optimize=True)
    a = jloc.localize_er(C_occ, eri_lo)
    b = ploc.localize_er(C_occ, eri_lo, device=CPU)
    _check_localized(a, b)
    # IBO: the quartic IAO-charge metric (minimal basis: IAOs = span)
    C_iao = ji.get_iao(ints.S, ints.S12, ints.S2, C_ao)
    atoms = [(a_, a_ + 1) for a_ in range(ints.natom)]
    a = jloc.localize_ibo(C_ao, C_iao, ints.S, atoms)
    b = ploc.localize_ibo(C_ao, C_iao, ints.S, atoms, device=CPU)
    _check_localized(a, b)


def test_localize_metrics_match_jax():
    """The metrics themselves, on one random rotation, at 1e-12."""
    from libdmet_preview_tpu.lo import localize as jloc
    from libdmet_preview_tpu_torch.lo import localize as ploc
    rng = np.random.RandomState(3)
    C = np.linalg.qr(rng.randn(6, 3))[0]
    S = _spd(rng, 6)
    slices = [[0, 1], [2, 3], [4, 5]]
    eri = rng.randn(6, 6, 6, 6)
    C_iao = np.linalg.qr(rng.randn(6, 4))[0]
    pairs = [
        (jloc.pm_metric(jnp.asarray(C), slices),
         ploc.pm_metric(_t(C), slices)),
        (jloc.pm_metric(jnp.asarray(C), slices, S=S),
         ploc.pm_metric(_t(C), slices, S=S)),
        (jloc.er_metric(jnp.asarray(C), eri), ploc.er_metric(_t(C), eri)),
        (jloc.ibo_metric(jnp.asarray(C), C_iao, S, [(0, 2), (2, 4)]),
         ploc.ibo_metric(_t(C), C_iao, S, [(0, 2), (2, 4)]))]
    for a, b in pairs:
        assert abs(float(a) - float(b)) < 1e-12 * max(1.0, abs(float(a)))


# ----------------------------------------------------------------------
# maxloc / W90
# ----------------------------------------------------------------------

def _ssh(nkx, frac=0.4):
    from test_wannier import ssh_bands
    return ssh_bands(nkx=nkx, frac=frac)


@pytest.mark.parametrize("latt, kmesh", [
    (np.diag([1.0, 9.0, 9.0]), (6, 1, 1)),
    (np.diag([1.0, 2.0, 9.0]), (4, 3, 1)),
    (np.diag([1.3, 1.3, 1.3]), (3, 3, 3)),
    (np.array([[1.0, 0, 0], [0.5, 0.9, 0], [0.1, 0.2, 1.4]]), (2, 2, 2))])
def test_kmesh_bvectors_match_jax(latt, kmesh):
    """Weights, b vectors and neighbor tables equal JAX's exactly; the B1
    condition holds on the periodic dims."""
    from libdmet_preview_tpu.lo import maxloc as jm
    from libdmet_preview_tpu_torch.lo import maxloc as pm
    a = jm.kmesh_bvectors(latt, kmesh)
    b = pm.kmesh_bvectors(latt, kmesh)
    for k in ("b_cart", "w_b", "b_int", "nb_idx", "recip"):
        assert np.array_equal(a[k], b[k]), k
    assert a["pdims"] == b["pdims"]
    assert np.array_equal(jm.kmesh_kpts_frac(kmesh), pm.kmesh_kpts_frac(kmesh))
    outer = np.einsum("b, bi, bj -> ij", b["w_b"], b["b_cart"], b["b_cart"])
    pd = b["pdims"]
    assert np.allclose(outer[np.ix_(pd, pd)], np.eye(len(pd)), atol=1e-8)


def _rand_gauge(rng, nk, nw, amp):
    A = rng.randn(nk, nw, nw) + 1j * rng.randn(nk, nw, nw)
    W = (A - A.conj().swapaxes(-2, -1)) / 2 * amp
    from scipy.linalg import expm
    return np.asarray([expm(w) for w in W])


def test_spread_and_rotation_match_jax():
    from libdmet_preview_tpu.lo import maxloc as jm
    from libdmet_preview_tpu_torch.lo import maxloc as pm
    C, kmesh, latt, tau = _ssh(6)
    M0j, bv = jm.mmn_from_C(C, kmesh, latt, tau=tau)
    M0p, _ = pm.mmn_from_C(C, kmesh, latt, tau=tau, device=CPU)
    assert np.abs(_n(M0p) - M0j).max() < 1e-12
    U = _rand_gauge(np.random.RandomState(4), 6, 2, 0.4)
    w, b, nb = pm._bv_tensors(bv, CPU)
    Mj = jm._rotate_M(jnp.asarray(M0j), jnp.asarray(U), bv["nb_idx"])
    Mp = pm._rotate_M(M0p, _t(U), nb)
    assert np.abs(_n(Mp) - np.asarray(Mj)).max() < 1e-12
    tj, partj = jm.spread_from_M(Mj, jnp.asarray(bv["w_b"]),
                                 jnp.asarray(bv["b_cart"]))
    tp, partp = pm.spread_from_M(Mp, w, b)
    assert abs(float(tj) - float(tp)) < 1e-12
    for k in ("I", "OD", "D"):
        assert abs(float(partj[k]) - float(partp[k])) < 1e-12
    assert np.abs(np.asarray(partj["centers"])
                  - _n(partp["centers"])).max() < 1e-12
    Gj = jm.mv_gradient(Mj, jnp.asarray(bv["w_b"]), jnp.asarray(bv["b_cart"]))
    Gp = pm.mv_gradient(Mp, w, b)
    assert np.abs(_n(Gp) - np.asarray(Gj)).max() < 1e-12


def test_mv_gradient_vs_autograd():
    """d/dt Omega(U expm(t dW)) at t0 from torch.autograd == Re tr[G dW]
    of the analytic gradient, 1e-10; +G is a descent direction."""
    from libdmet_preview_tpu_torch.lo import maxloc as pm
    rng = np.random.RandomState(3)
    C, kmesh, latt, tau = _ssh(6)
    M0, bv = pm.mmn_from_C(C, kmesh, latt, tau=tau, device=CPU)
    w, b, nb = pm._bv_tensors(bv, CPU)
    U = _t(_rand_gauge(rng, 6, 2, 0.3))
    B = rng.randn(6, 2, 2) + 1j * rng.randn(6, 2, 2)
    dW = _t((B - B.conj().swapaxes(-2, -1)) / 2)
    t = torch.tensor(0.05, dtype=torch.float64, requires_grad=True)
    om = pm.spread_from_M(pm._rotate_M(
        M0, U @ pm._expm_antiherm(t.to(torch.complex128) * dW), nb), w, b)[0]
    fd, = torch.autograd.grad(om, t)
    Ut = U @ pm._expm_antiherm(0.05 * dW)
    G = pm.mv_gradient(pm._rotate_M(M0, Ut, nb), w, b)
    inner = float(torch.einsum("kij, kji ->", G, dW).real)
    assert abs(float(fd) - inner) < 1e-10 * max(1.0, abs(float(fd)))
    assert float(torch.einsum("kij, kji ->", G, G).real) < 0


@pytest.mark.parametrize("case", ["complete", "occupied", "square"])
def test_max_loc_matches_jax(case):
    """max_loc_U from the same random gauge: the minimized spread equals
    JAX's (1e-8); the complete basis reaches 0 and the occupied band
    Omega_I."""
    from libdmet_preview_tpu.lo import maxloc as jm
    from libdmet_preview_tpu_torch.lo import maxloc as pm
    rng = np.random.RandomState(0)
    if case == "square":
        from test_wannier import rand_gauge
        n = 3
        latt = np.diag([1.0, 1.0, 8.0])
        kmesh = (n, n, 1)
        kf = jm.kmesh_kpts_frac(kmesh)
        tau = np.array([[0.1, 0.2, 0], [0.6, 0.7, 0]])
        C = np.zeros((n * n, 2, 2), dtype=complex)
        for i, k in enumerate(kf):
            phx = np.exp(2j * np.pi * k[0])
            h = np.array([[0.3, 0.8 + 0.2 * phx],
                          [0.8 + 0.2 * np.conj(phx), -0.3]])
            C[i] = np.linalg.eigh(h)[1]
        U0 = np.asarray(rand_gauge(np.random.RandomState(5), n * n, 2,
                                   amp=0.05))
        max_iter = 5000
    else:
        C, kmesh, latt, tau = _ssh(8)
        if case == "occupied":
            C, U0 = C[:, :, :1], None
        else:
            U0 = _rand_gauge(rng, 8, 2, 0.3)
        max_iter = 3000
    M0, bv = jm.mmn_from_C(C, kmesh, latt, tau=tau)
    Uj, ij = jm.max_loc_U(M0, bv, U0=U0, max_iter=max_iter)
    Up, ip = pm.max_loc_U(M0, bv, U0=U0, max_iter=max_iter, device=CPU)
    assert abs(ij["omega"] - ip["omega"]) < 1e-8
    assert abs(ij["omega_I"] - ip["omega_I"]) < 1e-8
    if case == "occupied":
        assert abs(ip["omega"] - ip["omega_I"]) < 1e-10
    else:
        assert ip["omega"] < 1e-7
        UhU = torch.einsum("kmi, kmj -> kij", Up.conj(), Up)
        assert torch.allclose(UhU, torch.eye(2, dtype=UhU.dtype),
                              atol=1e-10)
    # the driver with a projected starting gauge
    Cl_j, _, inf_j = jm.max_loc(C, kmesh, latt, tau=tau,
                                guess=np.eye(C.shape[1])[:, :C.shape[2]],
                                max_iter=max_iter)
    Cl_p, _, inf_p = pm.max_loc(C, kmesh, latt, tau=tau,
                                guess=np.eye(C.shape[1])[:, :C.shape[2]],
                                max_iter=max_iter, device=CPU)
    assert abs(inf_j["omega"] - inf_p["omega"]) < 1e-8
    Pj = np.einsum("kpm, kqm -> kpq", Cl_j, Cl_j.conj())
    Pp = _n(torch.einsum("kpm, kqm -> kpq", Cl_p, Cl_p.conj()))
    assert np.abs(Pj - Pp).max() < 1e-10


def test_max_loc_cubic_eigensolver_gauge_stalls_as_in_jax():
    """The 3D cubic bands of chip_smoke.py 11e (6x6x6 mesh) in numpy's
    eigh gauge: max_loc_U from there stalls in both packages at the same
    Omega (an Im ln branch minimum, 1e-8; the port reports it as not
    converged after 3000 iterations), and max_loc from the projection on
    mixed point orbitals reaches the exact minimum in both (1e-8)."""
    from libdmet_preview_tpu.lo import maxloc as jm
    from libdmet_preview_tpu_torch.lo import maxloc as pm
    n = 6
    kmesh, latt = (n, n, n), np.eye(3)
    tau = np.array([[0.1, 0.2, 0.3], [0.6, 0.7, 0.8]])
    C = []
    for k in jm.kmesh_kpts_frac(kmesh):
        t = 0.8 + 0.1 * np.sum(np.exp(2j * np.pi * k))
        C.append(np.linalg.eigh(np.array([[0.3, t], [np.conj(t), -0.3]]))[1])
    C = np.array(C)
    M0, bv = jm.mmn_from_C(C, kmesh, latt, tau=tau)
    _, ij = jm.max_loc_U(M0, bv, max_iter=3000)
    _, ip = pm.max_loc_U(M0, bv, max_iter=3000, device=CPU)
    assert abs(ij["omega"] - ip["omega"]) < 1e-8
    assert ip["omega"] > 1.0 and not ip["converged"]
    guess = np.array([[1.0, 0.3], [-0.2, 1.0]])
    _, _, gj = jm.max_loc(C, kmesh, latt, tau=tau, guess=guess, max_iter=3000)
    _, _, gp = pm.max_loc(C, kmesh, latt, tau=tau, guess=guess, max_iter=3000,
                          device=CPU)
    assert gp["omega_init"] > 1e-2 and gp["converged"]
    assert abs(gj["omega"]) < 1e-8 and abs(gp["omega"]) < 1e-8
    print("eigensolver gauge, 3000 iterations: Omega JAX %.6f, port %.6f "
          "(grad norm %.3e); projected start: Omega %.3e -> %.3e in %d "
          "iterations (JAX %d)" % (ij["omega"], ip["omega"],
                                   ip["grad_norm"], gp["omega_init"],
                                   gp["omega"], gp["n_iter"], gj["n_iter"]))


def test_proj_wannier_matches_jax():
    from libdmet_preview_tpu.lo import wannier as jw
    from libdmet_preview_tpu_torch.lo import wannier as pw
    rng = np.random.RandomState(6)
    nk, nao, nmo, nlo = 4, 5, 5, 3
    C = rng.randn(nk, nao, nmo) + 1j * rng.randn(nk, nao, nmo)
    guess = rng.randn(nao, nlo)
    S = np.asarray([_spd(rng, nao) for _ in range(nk)]).astype(complex)
    a = jw.proj_wannier((C.real, C.imag), guess, ovlp_k=S, band_idx=[0, 2, 4])
    b = pw.proj_wannier((C.real, C.imag), guess, ovlp_k=S,
                        band_idx=[0, 2, 4], device=CPU)
    assert np.abs(_n(b) - a).max() < 1e-12
    ra, ia = jw.get_C_ao_lo_wannier(None, C, guess)
    rb, ib = pw.get_C_ao_lo_wannier(None, C, guess, device=CPU)
    assert rb.shape == ra.shape == (1, nk, nao, nlo)
    assert np.abs(_n(rb) - ra).max() < 1e-12
    assert np.abs(_n(ib) - ia).max() < 1e-12


def test_w90_kernel_and_files_match_jax(tmp_path):
    """W90.kernel's spread and per-function spreads equal JAX's; make_win
    and export_AME write the same bytes."""
    from libdmet_preview_tpu.lo.wannier import W90 as JW90
    from libdmet_preview_tpu_torch.lo.wannier import W90 as PW90
    C, kmesh, latt, tau = _ssh(4)
    wj = JW90(C, kmesh, latt, num_wann=2, tau=tau, guess=np.eye(2))
    wp = PW90(C, kmesh, latt, num_wann=2, tau=tau, guess=np.eye(2),
              device=CPU)
    Cj = wj.kernel(max_iter=3000)
    Cp = wp.kernel(max_iter=3000)
    assert abs(wj.omega - wp.omega) < 1e-8
    assert np.abs(np.asarray(wj.wann_spreads) - wp.wann_spreads).max() < 1e-8
    assert abs(np.sum(wp.wann_spreads) - wp.omega) < 1e-8
    Pj = np.einsum("kpm, kqm -> kpq", Cj, Cj.conj())
    Pp = _n(torch.einsum("kpm, kqm -> kpq", Cp, Cp.conj()))
    assert np.abs(Pj - Pp).max() < 1e-10
    eig = np.random.RandomState(7).randn(4, 2)
    wj.mo_energy_kpts = wp.mo_energy_kpts = eig
    wj.export_AME(prefix=str(tmp_path / "j"))
    wp.export_AME(prefix=str(tmp_path / "p"))
    for ext in ("amn", "mmn", "eig"):
        assert (tmp_path / ("j." + ext)).read_bytes() \
            == (tmp_path / ("p." + ext)).read_bytes(), ext
    assert wj.make_win() == wp.make_win(str(tmp_path / "p.win"))
    assert (tmp_path / "p.win").read_text() == wj.make_win()
    with pytest.raises(ValueError):
        PW90(C, kmesh, latt, num_wann=1, device=CPU)


# ----------------------------------------------------------------------
# SCDM with smearing weights and the k-point SCDM
# ----------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["erfc", "gauss", "fermi"])
def test_scdm_smear_matches_jax(kind):
    """scdm_smear against JAX (1e-12, same pivots) and the oracles of
    tests/test_extras2.py:371-386: orthonormal, span preserved."""
    from libdmet_preview_tpu.lo.scdm import scdm_smear as jss
    from libdmet_preview_tpu_torch.lo.scdm import scdm_smear
    rng = np.random.RandomState(0)
    C = np.linalg.qr(rng.randn(10, 6))[0]
    e = np.array([-2.0, -1.5, -1.0, 5.0, 6.0, 7.0])
    C_loc, piv = scdm_smear(C, e, mu=0.0, sigma=0.2, kind=kind,
                            return_piv=True)
    Cj, pj = jss(C, e, mu=0.0, sigma=0.2, kind=kind, return_piv=True)
    assert np.array_equal(piv, pj)
    assert np.abs(C_loc - Cj).max() < 1e-12
    assert np.allclose(C_loc.T @ C_loc, np.eye(6), atol=1e-10)
    assert np.allclose(C_loc @ C_loc.T, C @ C.T, atol=1e-10)
    with pytest.raises(ValueError):
        scdm_smear(C, e, 0.0, 0.2, kind="box")


@pytest.mark.parametrize("pair", [False, True])
def test_scdm_k_matches_jax(pair):
    """scdm_k against JAX (1e-12, one shared pivot set) on complex
    coefficients or their (re, im) pair, and the oracles of
    tests/test_extras2.py:389-403: per-k projector and orthonormality."""
    from libdmet_preview_tpu.lo.scdm import scdm_k as jsk
    from libdmet_preview_tpu_torch.lo.scdm import scdm_k
    rng = np.random.RandomState(1)
    nk, nao, nmo = 4, 8, 3
    C = np.linalg.qr(rng.randn(nk, nao, nao)
                     + 1j * rng.randn(nk, nao, nao))[0][:, :, :nmo]
    arg = (C.real, C.imag) if pair else C
    C_loc, piv = scdm_k(arg, return_piv=True)
    Cj, pj = jsk(arg, return_piv=True)
    assert np.array_equal(piv, pj) and len(set(piv.tolist())) == nmo
    assert np.abs(C_loc - Cj).max() < 1e-12
    for k in range(nk):
        assert np.abs(C[k] @ C[k].conj().T
                      - C_loc[k] @ C_loc[k].conj().T).max() < 1e-10
        assert np.abs(C_loc[k].conj().T @ C_loc[k]
                      - np.eye(nmo)).max() < 1e-10
