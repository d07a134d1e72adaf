"""
The PyTorch port's AFM-oxide factories (libdmet_preview_tpu_torch/models/
abinitio.py: make_nio_afm_lattice, make_nio_fm_lattice,
make_cuo2_afm_lattice, their shared _afm_oxide_tail) against the JAX
package's, at the CPU tests' width workloads.OXIDE_TIER1: one cell at
precision 1e-4, the cheapest precision at which the supercell UHFs still
run every step (at 1e-3 NiO's no longer converges).  One cell has no
bath: the port's bath matching returns an empty bath as it is (the JAX
package's raises; its recorder does not match there).

The values of the JAX factories come from scripts/oxide_reference_jax.py
(workloads.OXIDE_JAX), never from a live JAX build (the JAX package's
short-range rows take minutes): the cell integrals' fingerprints (1e-10
relative), E_hf per cell (1e-9, the UHF's own energy stop), (n_alpha,
n_beta) and the embedding's counts (exact).  At one cell the NiO UHFs stop
on flat landscapes, where the two packages' densities differ by ~1e-5, so
what follows the SCF density is held step by step on the same inputs,
the JAX side live and cheap: eight supercell-UHF cycles from the
factory's guess (plus a fixed perturbation) on the port's integrals
(1e-10), and _afm_oxide_tail on the port's converged density (the LO
operators, the LO ERI, the stripes and the d moments, 1e-10; the
Cholesky factors of one shared LO ERI exactly).  The JAX suite's
identities are held where one cell keeps them (the moments and counts of
tests/test_nio_afm.py; the one-shot of tests/test_cuo2_afm.py through
workloads.oxide_one_shot: the lattice mean field, ConstructImpHam(
matching=True, int_bath=True), the impurity UHF); also the cache file
(the JAX package's key and .npz layout), NiO FM built from NiO AFM's
file, the HDF5 outcore ERI against the in-core one (1e-14), and JAX's
signatures and meta keys.  The launch counts of the oxide
ConstructImpHam need the card.
"""

import inspect
import os

import numpy as np
import pytest
import torch

torch.set_num_threads(1)
CPU = torch.device("cpu")

from libdmet_preview_tpu_torch import workloads as wl  # noqa: E402

KINDS = ("nio_afm", "nio_fm", "cuo2_afm")


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    return str(tmp_path_factory.mktemp("oxide_cache"))


@pytest.fixture(scope="module")
def built(cache):
    """{kind: (Lat, meta, one-shot result)} at OXIDE_TIER1; NiO FM reads
    the integrals NiO AFM wrote (its cell's ERI method is not called)."""
    from libdmet_preview_tpu_torch.ints.pbc import PbcCell
    from libdmet_preview_tpu_torch.utils import logger as log
    level, log.verbose = log.verbose, "WARNING"
    out = {}
    try:
        for kind in KINDS:
            if kind == "nio_fm":
                eri_rs = PbcCell.intor_eri_rs
                PbcCell.intor_eri_rs = None     # must come from the cache
            try:
                Lat, meta = wl.oxide_lattice(kind, CPU, cache_file=cache,
                                             **wl.OXIDE_TIER1)
            finally:
                if kind == "nio_fm":
                    PbcCell.intor_eri_rs = eri_rs
            # the one-shot where one cell keeps the identities: NiO's
            # UHFs stop on flat landscapes there (NiO FM's does not
            # converge in either package)
            res = wl.oxide_one_shot(Lat, meta, kind, CPU, mp2=False) \
                if kind == "cuo2_afm" else None
            out[kind] = (Lat, meta, res)
    finally:
        log.verbose = level
    return out


@pytest.mark.parametrize("kind", KINDS)
def test_factory_matches_jax(built, cache, kind):
    """The cell integrals (their fingerprints, 1e-10 relative; e_nuc
    1e-10), E_hf per cell (1e-9; not NiO FM, whose UHF stops unconverged in
    both packages) and (n_alpha, n_beta) (exact) against the JAX
    package's recorded values."""
    _, meta, _ = built[kind]
    ref = wl.OXIDE_JAX[kind]
    nk, prec = wl.OXIDE_TIER1["nk"], wl.OXIDE_TIER1["precision"]
    fp = wl.oxide_fingerprint(os.path.join(
        cache, wl.oxide_cache_name(kind, nk, prec)))
    for k in ("S", "hcore", "eri"):
        for a, b in zip(fp[k], ref["ints"][k]):
            assert abs(a - b) <= wl.OXIDE_INTS_TOL * abs(b), k
    assert abs(fp["e_nuc"] - ref["ints"]["e_nuc"]) < 1e-10
    if kind != "nio_fm":
        assert abs(meta["E_hf"] / nk - ref["E_hf"]) < wl.OXIDE_E_HF_TOL
    if "nelec_ab" in ref:
        assert list(meta["nelec_ab"]) == ref["nelec_ab"]


def test_one_shot_counts_match_jax(built):
    """The embedding's electron count, S_z and size (exact) against the
    JAX package's."""
    kind = "cuo2_afm"
    res = built[kind][2]
    ref = wl.OXIDE_JAX[kind]
    for k in ("nelec_emb", "sz_emb", "neo"):
        assert res[k] == ref[k], k


def _guess(kind, meta):
    from libdmet_preview_tpu_torch.models import abinitio as T
    occs = T._cuo2_occs if kind == "cuo2_afm" else \
        T._nio_occs(kind.split("_")[1])
    return T._diag_guess(meta["cell"].atoms, occs)


@pytest.mark.parametrize("kind", KINDS)
def test_supercell_uhf_cycles_match_jax(built, cache, kind):
    """Eight cycles of the supercell UHF (_uhf_incore: DIIS, level shift,
    damping) on the port's cached integrals, in both packages, from the
    factory's guess plus a fixed symmetric perturbation (1e-2): the
    diagonal guess leaves degenerate levels at the Fermi level, where the
    occupied set depends on rounding.  The energy and the density
    (1e-10)."""
    from libdmet_preview_tpu.models import abinitio as J
    from libdmet_preview_tpu_torch.models import abinitio as T
    _, meta, _ = built[kind]
    nk, prec = wl.OXIDE_TIER1["nk"], wl.OXIDE_TIER1["precision"]
    dat = np.load(os.path.join(cache, wl.oxide_cache_name(kind, nk, prec)))
    P = np.random.RandomState(3).randn(2, 30, 30) * 1e-2
    args = (dat["S"], dat["hcore"], dat["eri"],
            _guess(kind, meta) + P + P.transpose(0, 2, 1),
            *meta.get("nelec_ab", (meta["cell"].nelectron // 2,) * 2))
    kw = {"e_nuc": float(dat["e_nuc"]), "tol": 1e-9, "max_cycle": 8}
    Ej, dmj = J._uhf_incore(*args, **kw)
    Et, dmt = T._uhf_incore(*args, device=CPU, **kw)
    assert abs(Et - Ej) < wl.OXIDE_STEP_TOL
    assert np.abs(np.asarray(dmt) - np.asarray(dmj)).max() \
        < wl.OXIDE_STEP_TOL


@pytest.mark.parametrize("kind", ["nio_afm", "cuo2_afm"])
def test_oxide_tail_matches_jax(built, cache, kind):
    """_afm_oxide_tail of both packages on the same integrals and the
    port's converged AO density: the LO operators, the LO ERI, the
    Cholesky factors, the lattice stripes and the d moments (1e-10)."""
    from libdmet_preview_tpu.models import abinitio as J
    from libdmet_preview_tpu_torch.models import abinitio as T
    Lat, meta, _ = built[kind]
    nk, prec = wl.OXIDE_TIER1["nk"], wl.OXIDE_TIER1["precision"]
    dat = np.load(os.path.join(cache, wl.oxide_cache_name(kind, nk, prec)))
    C = meta["C_ao_lo"]
    dm = torch.stack([C @ r @ C.T for r in meta["rdm1_lo"]]).numpy()
    nlo = meta["nlo"]
    mag = T._d_slices(meta["cell"].atoms, {"Ni": 11, "Cu": 7, "O": 4},
                      "Cu" if kind == "cuo2_afm" else "Ni",
                      1 if kind == "cuo2_afm" else 5)
    args = (nk, nlo, dat["S"], dat["hcore"], dat["eri"],
            float(dat["e_nuc"]), dm, meta["E_hf"], 1e-8, mag)
    Lj, mj = J._afm_oxide_tail(None, *args)
    Lt, mt = T._afm_oxide_tail(meta["cell"], *args, device=CPU)
    for k in ("h_lo", "fock_lo", "rdm1_lo", "eri_lo", "mag_d"):
        assert np.abs(np.asarray(mt[k]) - np.asarray(mj[k])).max() \
            < wl.OXIDE_STEP_TOL, k
    assert np.abs(np.asarray(mt["mag_d"]) - meta["mag_d"]).max() < 1e-10
    # the pivoted Cholesky of the same LO ERI array is the same in both
    # packages; the ERI at precision 1e-4 has near-tied pivots, so factors
    # of the two packages' LO ERIs (1e-14 apart) may pivot differently
    from libdmet_preview_tpu.ops.eri_transform import cholesky_eri as jchol
    from libdmet_preview_tpu_torch.ops.eri_transform import cholesky_eri
    e = mt["eri_lo"]
    assert np.array_equal(np.asarray(jchol(e.numpy(), tol=1e-8)),
                          cholesky_eri(e, tol=1e-8).numpy())
    assert torch.equal(Lt.chol_L, cholesky_eri(e, tol=1e-8))
    assert np.asarray(Lj.Ham.getH2()).shape == tuple(Lt.chol_L.shape)
    for name in ("fock_lo_R", "hcore_lo_R", "rdm1_lo_R"):
        assert np.abs(np.asarray(getattr(Lt, name))
                      - np.asarray(getattr(Lj, name))).max() \
            < wl.OXIDE_STEP_TOL, name


@pytest.mark.parametrize("kind", KINDS)
def test_oxide_identities(built, kind):
    """The JAX suite's identities where one cell keeps them: FM at S_z = 2
    per Ni with aligned moments, AFM staggered; for CuO2 the embedding is
    the whole cell (no bath) with the cell's electrons, and the lattice
    mean field (5e-5) and the interacting-bath HF (1e-5) reproduce the
    supercell UHF (tests/test_cuo2_afm.py's bounds)."""
    Lat, meta, res = built[kind]
    cell = meta["cell"]
    mag = meta["mag_d"]
    if kind == "nio_fm":
        na, nb = meta["nelec_ab"]
        assert na - nb == 4
        rdm1 = meta["rdm1_lo"]
        assert abs(float(torch.trace(rdm1[0] - rdm1[1])) - 4) < 1e-8
        assert mag[0] > 0.5 and mag[1] > 0.5
        return
    assert abs(mag[0] + mag[1]) < 1e-4
    if kind == "nio_afm":
        assert mag[0] > 1.0 and meta["nelec_ab"] == (24, 24)
        return
    assert res["sz_emb"] == 0 and cell.nelectron == 50
    assert res["neo"] == Lat.nscsites == meta["nlo"] == cell.nao
    assert res["nelec_emb"] == cell.nelectron
    assert abs(res["E_mf"] - res["E_hf"]) < 5e-5
    assert abs(res["E_ibhf"] - res["E_hf"]) < 1e-5


@pytest.mark.parametrize("kind", KINDS)
def test_lattice_layout(built, kind):
    """What set_Ham_abinitio received: per-spin stripes, the unit-cell ERI
    as (aa, bb, ab), the pivoted Cholesky factors of the LO ERI (at
    precision 1e-4 the cell ERI is not positive semidefinite, so they do
    not rebuild it)."""
    Lat, meta, _ = built[kind]
    nlo = meta["nlo"]
    nk = wl.OXIDE_TIER1["nk"]
    assert Lat.fock_lo_R.shape == (2, nk, nlo, nlo)
    assert Lat.hcore_lo_R.shape == (2, nk, nlo, nlo)
    assert np.array_equal(Lat.hcore_lo_R[0], Lat.hcore_lo_R[1])
    assert np.asarray(Lat.rdm1_lo_R).shape == (2, nk, nlo, nlo)
    eri_imp = Lat.Ham.eri_imp
    assert eri_imp.shape == (3,) + (nlo,) * 4
    assert torch.equal(eri_imp[0], eri_imp[2])
    from libdmet_preview_tpu_torch.ops.eri_transform import cholesky_eri
    assert torch.equal(Lat.chol_L, cholesky_eri(meta["eri_lo"], tol=1e-8))
    assert Lat.chol_L.shape[1:] == (nlo, nlo)
    assert Lat.H0 == meta["e_nuc"] / nk
    C, S = meta["C_ao_lo"], meta["S"]
    assert float((C.T @ S @ C - torch.eye(nlo, dtype=C.dtype)).abs().max()) \
        < 1e-10


def test_cache_file_keys_and_round_trip(built, cache):
    """The JAX package's key and .npz layout (S, hcore, eri, e_nuc); a
    second build reads the file and gives the same lattice."""
    nk, prec = wl.OXIDE_TIER1["nk"], wl.OXIDE_TIER1["precision"]
    names = sorted(os.listdir(cache))
    assert names == ["cuo2_rs1_%d_3.8_solid_%.0e.npz" % (nk, prec),
                     "nio_rs1_%d_4.17_solid_%.0e.npz" % (nk, prec)]
    dat = np.load(os.path.join(cache, names[1]))
    assert sorted(dat.files) == ["S", "e_nuc", "eri", "hcore"]
    meta = built["nio_afm"][1]
    assert np.array_equal(dat["S"], meta["S"].numpy())
    _, meta2 = wl.oxide_lattice("nio_afm", CPU,
                                cache_file=os.path.join(cache, names[1]),
                                **wl.OXIDE_TIER1)
    assert meta2["E_hf"] == meta["E_hf"]
    assert torch.equal(meta2["rdm1_lo"], meta["rdm1_lo"])


def test_outcore_eri_on_the_oxide_embedding(built, tmp_path):
    """get_emb_eri_chol(outcore=) on the CuO2 factors and embedding basis:
    the HDF5 dataset equals the in-core ERI (1e-14)."""
    from libdmet_preview_tpu_torch.ops.eri_transform import get_emb_eri_chol
    Lat, _, res = built["cuo2_afm"]
    basis = res["basis"]
    incore = get_emb_eri_chol(Lat.chol_L, basis)
    dset = get_emb_eri_chol(Lat.chol_L, basis,
                            outcore=str(tmp_path / "eri.h5"))
    try:
        assert dset.shape == tuple(incore.shape) == (3,) + (res["neo"],) * 4
        assert np.abs(dset[()] - incore.numpy()).max() < 1e-14
        H2 = res["ImpHam"].H2["ccdd"]
        assert np.abs(dset[()] - np.asarray(H2)).max() < 1e-14
    finally:
        dset.file.close()


def test_signatures_and_meta_keys_match_jax(built):
    """JAX's arguments in JAX's order (the port adds device=) and JAX's
    meta keys."""
    from libdmet_preview_tpu.models import abinitio as J
    from libdmet_preview_tpu_torch.models import abinitio as T
    for name in wl.OXIDE_FACTORIES.values():
        pj = list(inspect.signature(getattr(J, name)).parameters.items())
        pt = list(inspect.signature(getattr(T, name)).parameters.items())
        assert pt[-1][0] == "device"
        assert [(k, v.default) for k, v in pj] == \
            [(k, v.default) for k, v in pt[:-1]]
    tail = {"cell", "E_hf", "E_hf_elec", "e_nuc", "C_ao_lo", "eri_lo",
            "h_lo", "fock_lo", "rdm1_lo", "nlo", "S", "mag_d"}
    for kind in KINDS:
        extra = {"mag_ni", "nelec_ab"} if kind.startswith("nio") else set()
        assert set(built[kind][1]) == tail | extra


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a CUDA "
                    "device: the hand-written syrk kernels")
@pytest.mark.parametrize("kind", KINDS)
def test_oxide_construct_imp_ham_launches_on_card(kind):
    """On the card, each oxide ConstructImpHam makes exactly 2 tri and 1
    cross syrk launches and calls no plain version; its ERI equals the
    CPU's (1e-10)."""
    import libdmet_preview_tpu_torch.dmet.hubbard as dmet
    from libdmet_preview_tpu_torch.ops import eri_kernels as ek
    from libdmet_preview_tpu_torch.ops.vcor import VcorLocal
    dev = torch.device("cuda")
    Lat, meta = wl.oxide_lattice(kind, dev, **wl.OXIDE_TIER1)
    nsc = Lat.nscsites
    vcor = VcorLocal(False, False, nsc)
    vcor.assign(np.zeros((2, nsc, nsc)))
    if kind == "nio_fm":
        na, nb = meta["nelec_ab"]
        filling = (na / nsc, nb / nsc)
    else:
        filling = meta["cell"].nelectron / (2.0 * nsc)
    rho, _, _ = dmet.HartreeFock(Lat, vcor, filling, None, ires=True)
    plain = ek.syrk_df_plain
    ek.syrk_df_plain = None          # a plain-version call would raise
    try:
        ek.syrk_df.launches = ek.syrk_df.cross_launches = 0
        ImpHam, _, basis = dmet.ConstructImpHam(Lat, rho, vcor,
                                                matching=True, int_bath=True)
        torch.cuda.synchronize()
        assert (ek.syrk_df.launches, ek.syrk_df.cross_launches) == (2, 1)
    finally:
        ek.syrk_df_plain = plain
    from libdmet_preview_tpu_torch.ops.eri_transform import get_emb_eri_chol
    ref = get_emb_eri_chol(Lat.chol_L.cpu(), basis.cpu())
    got = torch.as_tensor(np.asarray(ImpHam.H2["ccdd"].cpu()))
    assert float((got - ref).abs().max()) < 1e-10
