"""
The PyTorch port's scale-out layer (libdmet_preview_tpu_torch/parallel:
kmesh on torch.distributed, the dry run) against the JAX package's
(libdmet_preview_tpu/parallel) on the CPU.

The port's side runs in one spawn of a gloo group of 1, 2 and 4 ranks
(the 4-rank grid is 2 x 2 over (k, aux)), one process per rank with one
thread, from one module fixture: every rank runs the dry-run iteration and
workloads.kmesh_cases at its Tier-1 size, which also holds each sharded
result to the serial port path and, on a mesh of the whole world on the
aux axis, runs the veff and GDF cases where some ranks hold only padding.
The JAX side runs each kmesh function once, in the main thread, on
kmesh.make_mesh over conftest's virtual CPU devices, on the same NumPy
inputs.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

torch.set_num_threads(1)

WORLDS = (1, 2, 4)
SPAWN_TIMEOUT_S = 240


@pytest.fixture(scope="module")
def port_runs():
    from libdmet_preview_tpu_torch.parallel import dryrun
    return {n: dryrun.spawn(dryrun._rank_run, n, ("tier1", True),
                            backend="gloo", device="cpu",
                            timeout=SPAWN_TIMEOUT_S)
            for n in WORLDS}


def _ranks(port_runs, n):
    return [(r["rank"], r["cases"]["results"]) for r in port_runs[n]]


def _jax_fit(m):
    """The dry run's fit residual and its vcor gradient through the JAX
    package's sharded Fermi-density op on a 4-device k mesh."""
    from jax import lax, shard_map
    from jax.sharding import PartitionSpec as P
    from libdmet_preview_tpu.parallel import kmesh
    mesh = kmesh.make_mesh(4)
    zrho = kmesh.make_zrho_fermi_sharded(m["nelec2"], m["beta"], axis="k")
    spec_k = P(None, "k", None, None)

    def fit_shard(h_re, h_im, br, bi, tgt):
        r_re, r_im, _ = zrho(h_re, h_im)
        nk = lax.psum(h_re.shape[1], "k")
        rho_emb = lax.psum(
            (jnp.einsum("skpi, skpq, skqj -> sij", br, r_re, br)
             + jnp.einsum("skpi, skpq, skqj -> sij", bi, r_re, bi)
             + jnp.einsum("skpi, skpq, skqj -> sij", bi, r_im, br)
             - jnp.einsum("skpi, skpq, skqj -> sij", br, r_im, bi)) / nk,
            "k")
        return jnp.sum((rho_emb - tgt) ** 2)

    def loss(v):
        h = jnp.asarray(m["f_re"]) + v[:, None]
        return shard_map(fit_shard, mesh=mesh,
                         in_specs=(spec_k, spec_k, spec_k, spec_k, P()),
                         out_specs=P())(h, jnp.asarray(m["f_im"]),
                                        jnp.asarray(m["b_re"]),
                                        jnp.asarray(m["b_im"]),
                                        jnp.asarray(m["target"]))

    val, g = jax.value_and_grad(loss)(jnp.asarray(m["vmat"]))
    return float(val), np.asarray(g)


@pytest.fixture(scope="module")
def jax_ref():
    """Each JAX kmesh function once, on the inputs the ranks rebuild."""
    from libdmet_preview_tpu.models.abinitio import AbInitioHam
    from libdmet_preview_tpu.models.lattice import ChainLattice
    from libdmet_preview_tpu.parallel import kmesh
    from libdmet_preview_tpu.parallel.dryrun import \
        run_dmet_iteration_sharded
    from libdmet_preview_tpu_torch import interop
    from libdmet_preview_tpu_torch import workloads as wl
    dims = wl.KMESH_SIZES["tier1"]
    ref = {}
    m = wl.kmesh_model_inputs(dims["square"], dims["neo"])
    h_re = m["f_re"] + m["vmat"][:, None]
    mesh4 = kmesh.make_mesh(4)
    rho_R, mu, nchk = kmesh.hf_rho_sharded(mesh4, h_re, m["f_im"],
                                           m["kmesh"], m["nelec2"], m["beta"])
    ref["rho_R"] = np.asarray(rho_R)
    ref["embH1"] = np.asarray(kmesh.transform_h1_sharded(
        mesh4, (h_re, m["f_im"]), (m["b_re"], m["b_im"])))
    ref["fit_err"], ref["grad"] = _jax_fit(m)
    ref["nelec2"] = m["nelec2"]

    L, basis = wl.kmesh_chol_inputs(dims["chol"])
    ref["eri"] = kmesh.get_emb_eri_chol_sharded(
        kmesh.make_mesh(8, axis="aux"), L, basis)

    (hcore, fock, Lv, eri_imp), vb, vr = wl.kmesh_veff_inputs(dims["veff"])
    ncells, nlo = hcore.shape[-3], hcore.shape[-1]
    Lat = ChainLattice(ncells * nlo, nlo)
    Lat.set_Ham_abinitio(AbInitioHam(hcore, fock, Lv, eri_imp, 0.0))
    mesh_aux = kmesh.make_mesh(8, axis="aux")
    for spin in (2, 1):
        v, g = kmesh.get_veff_from_rdm1_emb_sharded(mesh_aux, Lat,
                                                    vr[:spin], vb[:spin])
        ref["veff s%d" % spin] = np.asarray(v)
        ref["rho_glob s%d" % spin] = np.asarray(g)

    factors, basis_k, ncells, nlo = wl.kmesh_gdf_inputs(
        dims["gdf"], torch.device("cpu"))
    factors = interop.gdf_factors_to_numpy(factors)
    basis_k = tuple(x.numpy() for x in basis_k)
    for tr in (False, True):
        ref["gdf tr_symm=%s" % tr] = kmesh.get_emb_eri_gdf_sharded(
            mesh_aux, factors, basis_k, ncells, nlo, tr_symm=tr)

    t1, t2, h, W = wl.ccsd_residual_problem()
    mesh8 = kmesh.make_mesh(8)
    R1, R2 = kmesh.ccsd_residual_sharded(mesh8, t1, t2, h, W, t1.shape[0])
    ref["R1"], ref["R2"] = np.asarray(R1), np.asarray(R2)
    nocc = dims["ccsd"][0]
    h, W = wl.ccsd_problem(*dims["ccsd"])
    t1, t2, e, conv = kmesh.ccsd_solve_sharded(mesh8, h, W, nocc, tol=1e-10)
    assert conv
    ref["t1"], ref["t2"], ref["E_corr"] = np.asarray(t1), np.asarray(t2), e
    ref["dryrun"] = run_dmet_iteration_sharded(4)
    return ref


def _rows(rank_of, n, nrows):
    """The rows of a k shard: the grid is (n / 2, 2) for n = 4."""
    k_size = n // 2 if n >= 4 else n
    k_idx = rank_of // 2 if n >= 4 else rank_of
    m = nrows // k_size
    return slice(k_idx * m, (k_idx + 1) * m)


@pytest.mark.parametrize("n", WORLDS)
def test_hf_rho_sharded_matches_jax(port_runs, jax_ref, n):
    for _, res in _ranks(port_runs, n):
        assert np.max(np.abs(res["rho_R"] - jax_ref["rho_R"])) < 1e-10
        assert abs(float(res["nelec_check"]) - jax_ref["nelec2"]) < 1e-6


@pytest.mark.parametrize("n", WORLDS)
def test_transform_h1_sharded_matches_jax(port_runs, jax_ref, n):
    for _, res in _ranks(port_runs, n):
        assert np.max(np.abs(res["embH1"] - jax_ref["embH1"])) < 1e-10


@pytest.mark.parametrize("n", WORLDS)
def test_vcor_gradient_matches_jax_and_one_rank(port_runs, jax_ref, n):
    """The gradient of the replicated vcor through the sharded Fermi
    density is summed over k exactly once: equal at 1, 2 and 4 ranks and
    equal to jax.grad through the JAX package's sharded op."""
    g_ref = jax_ref["grad"]
    g1 = _ranks(port_runs, 1)[0][1]["grad"]
    for _, res in _ranks(port_runs, n):
        scale = np.max(np.abs(g_ref))
        assert np.max(np.abs(res["grad"] - g_ref)) / scale < 1e-10
        assert np.max(np.abs(res["grad"] - g1)) / scale < 1e-10
        assert abs(res["fit_err"] - jax_ref["fit_err"]) \
            / jax_ref["fit_err"] < 1e-10


@pytest.mark.parametrize("n", WORLDS)
def test_eri_chol_sharded_matches_jax(port_runs, jax_ref, n):
    ref = jax_ref["eri"]
    for _, res in _ranks(port_runs, n):
        assert np.max(np.abs(res["eri"] - ref)) / np.max(np.abs(ref)) < 1e-12


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("spin", (2, 1))
def test_veff_sharded_matches_jax(port_runs, jax_ref, n, spin):
    for flat in ("", " flat"):
        for _, res in _ranks(port_runs, n):
            assert np.max(np.abs(res["veff s%d%s" % (spin, flat)]
                                 - jax_ref["veff s%d" % spin])) < 1e-10
            assert np.max(np.abs(res["rho_glob s%d%s" % (spin, flat)]
                                 - jax_ref["rho_glob s%d" % spin])) < 1e-12


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("tr", (False, True))
def test_gdf_sharded_matches_jax(port_runs, jax_ref, n, tr):
    ref = jax_ref["gdf tr_symm=%s" % tr]
    for flat in ("", " flat"):
        for _, res in _ranks(port_runs, n):
            got = res["gdf tr_symm=%s%s" % (tr, flat)]
            assert np.max(np.abs(got - ref)) / np.max(np.abs(ref)) < 1e-11


def test_a_rank_holding_only_padding_adds_zero(port_runs):
    """At 4 ranks on the aux axis the veff factors (naux 5 -> 8) leave rank
    3 only padding, and the GDF transfers (3, or 2 under tr_symm -> 4)
    leave rank 3 (ranks 2 and 3) only padding: their results still equal
    the serial path's (checked on every rank) and the JAX package's."""
    from libdmet_preview_tpu_torch import workloads as wl
    dims = wl.KMESH_SIZES["tier1"]
    naux = dims["veff"][2]
    assert 3 * (-(-naux // 4)) >= naux      # rank 3's first row
    assert dims["gdf"][0] == 3
    for _, res in _ranks(port_runs, 4):
        for key in ("veff s2 flat", "gdf tr_symm=True flat"):
            assert np.all(np.isfinite(res[key]))
    errs = [r["cases"]["errors"] for r in port_runs[4]]
    for key in ("veff s2 flat", "veff s1 flat", "rho_glob s2 flat",
                "gdf tr_symm=False flat (rel)", "gdf tr_symm=True flat (rel)"):
        assert max(e[key] for e in errs) < 1e-12


@pytest.mark.parametrize("n", WORLDS)
def test_ccsd_residual_sharded_matches_jax(port_runs, jax_ref, n):
    nocc = jax_ref["R1"].shape[0]
    for rank, res in _ranks(port_runs, n):
        assert np.max(np.abs(res["R1"] - jax_ref["R1"])) < 1e-12
        rows = _rows(rank, n, nocc)
        assert np.max(np.abs(res["R2_local"] - jax_ref["R2"][rows])) < 1e-12


@pytest.mark.parametrize("n", WORLDS)
def test_ccsd_solve_sharded_matches_jax(port_runs, jax_ref, n):
    nocc, nvir = jax_ref["t1"].shape
    k_size = n // 2 if n >= 4 else n
    for rank, res in _ranks(port_runs, n):
        assert abs(res["E_corr"] - jax_ref["E_corr"]) < 1e-9
        assert np.max(np.abs(res["t1"] - jax_ref["t1"])) < 1e-7
        rows = _rows(rank, n, nocc)
        assert np.max(np.abs(res["t2_local"] - jax_ref["t2"][rows])) < 1e-7
        # t2 stayed sharded in every iteration
        assert res["t2_local_shapes"] == [(nocc // k_size, nocc, nvir, nvir)]


def test_dryrun_iteration_matches_jax(port_runs, jax_ref):
    """The 4-rank dry run on the 2 x 2 grid against the JAX package's on
    its 4-device (2 x 2) mesh."""
    ref = jax_ref["dryrun"]
    for r in port_runs[4]:
        it = r["iteration"]
        assert it["mesh"] == [2, 2] and tuple(ref["mesh"]) == (2, 2)
        for key in ("E_mf", "E_imp", "nelec_imp", "fit_err"):
            assert abs(it[key] - ref[key]) < 1e-8, key
        assert max(it["err_mf"], it["err_h1"], it["err_eri"]) < 1e-8


@pytest.mark.parametrize("n", WORLDS)
def test_every_rank_ran_every_case(port_runs, n):
    from libdmet_preview_tpu_torch import workloads as wl
    assert [r["rank"] for r in port_runs[n]] == list(range(n))
    for r in port_runs[n]:
        errs = r["cases"]["errors"]
        assert r["cases"]["launches"] == 0 and r["cases"]["plain_cuda"] == 0
        assert len(errs) == 23
        assert all(v <= max(wl.KMESH_TOL.values()) for v in errs.values())


def test_a_failing_rank_fails_the_run():
    """A rank that raises ends the run with RuntimeError (here a rank's
    check fails on every rank)."""
    from libdmet_preview_tpu_torch.parallel import dryrun
    with pytest.raises(RuntimeError, match="deviates"):
        dryrun.spawn(dryrun._check, 2, (1.0, 0.0), backend="gloo",
                     device="cpu", timeout=SPAWN_TIMEOUT_S)


def test_nccl_refuses_more_ranks_than_cards():
    from libdmet_preview_tpu_torch.parallel import dryrun
    with pytest.raises(ValueError):
        dryrun.spawn(dryrun._check, 2, (0.0, 1.0), backend="nccl",
                     device="cpu")
    if torch.cuda.device_count() < 2:
        with pytest.raises(ValueError, match="NCCL"):
            dryrun.spawn(dryrun._check, 2, (0.0, 1.0), backend="nccl",
                         device="cuda")


def test_uneven_axis_raises():
    """naux or nk that does not split over the axis raises, as shard_map
    requires."""
    from libdmet_preview_tpu_torch.parallel import kmesh

    class _Mesh:
        device = torch.device("cpu")

        def size(self, axis):
            return 4

        def index(self, axis):
            return 0

    with pytest.raises(ValueError, match="does not split"):
        kmesh.shard(6, _Mesh(), "aux")
    with pytest.raises(ValueError, match="does not split"):
        kmesh.get_emb_eri_chol_sharded(_Mesh(), np.zeros((6, 2, 2)),
                                       np.zeros((1, 1, 2, 2)))
    with pytest.raises(ValueError, match="restricted"):
        kmesh.get_emb_eri_chol_sharded(_Mesh(), np.zeros((4, 2, 2)),
                                       np.zeros((2, 1, 2, 2)))
