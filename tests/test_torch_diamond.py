"""
The PyTorch port's diamond factories (libdmet_preview_tpu_torch/models/
abinitio.py make_diamond_lattice, the nk-cell chain on the Cholesky
format, and make_diamond_lattice3, the 3D k-mesh on the 'aft' format with
the range-separated driver) on the CPU, run alone at the arguments of
workloads.DIAMOND_TIER1 (the cheapest precision that runs every step) and
held to the JAX package's values at the same arguments
(workloads.DIAMOND_JAX, scripts/diamond_reference_jax.py):

  * E_hf per cell within DIAMOND_E_HF_TOL = 1e-10; the lattice mean field,
    the IB-HF identity, the one-shot DMET(CCSD) energy and the impurity
    electron count, and the energies of the self-consistent CCSD loop of
    tests/test_diamond333.py, within DIAMOND_SCF_TOL = 5e-8 (both SCFs
    stop at ||[F, D]|| < 1e-6);
  * the two factories agree on E_hf at kmesh (1, 1, 2) (a dense supercell
    RHF against the k-space HF), and the port's own identities hold;
  * the H2 formats: Cholesky factors on the chain (no cell), 'aft' with
    df_mode 'rs' on the mesh, whose impurity ERI is the driver's;
  * make_diamond_lattice3's cache file round trip (the JAX keys).

A full-precision diamond build costs minutes on a CPU, so the precision
here is 1e-4; chip_smoke.py phase 15 runs nk = 2 and the 2 x 2 x 2 solid at
precision 1e-12 on the card.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)
CPU = torch.device("cpu")


def _n(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _run(kind, **kw):
    from libdmet_preview_tpu_torch import workloads as wl
    Lat, meta = wl.diamond_lattice(kind, CPU, **wl.DIAMOND_TIER1[kind], **kw)
    res = wl.diamond_one_shot(Lat, meta, CPU)
    if kind == "mesh":
        E, n, conv, recs = wl.run_diamond_dmet(Lat, CPU)
        res.update(loop=[r["E"] for r in recs], loop_n=n,
                   loop_converged=conv)
    return Lat, meta, res


@pytest.fixture(scope="module")
def chain():
    return _run("chain")


@pytest.fixture(scope="module")
def cache_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("diamond_cache")


@pytest.fixture(scope="module")
def mesh(cache_dir):
    return _run("mesh", cache_file=str(cache_dir))


KEYS = ["E_hf", "E_mf", "E_ibhf", "E_cc", "n_cc", "nelec_emb"]


@pytest.mark.parametrize("kind,key", [(k, key) for k in ("chain", "mesh")
                                      for key in KEYS])
def test_one_shot_matches_jax(request, kind, key):
    from libdmet_preview_tpu_torch import workloads as wl
    res = request.getfixturevalue(kind)[2]
    ref = wl.DIAMOND_JAX["tier1_" + kind][key]
    tol = wl.DIAMOND_E_HF_TOL if key == "E_hf" else wl.DIAMOND_SCF_TOL
    if key == "nelec_emb":
        assert res[key] == ref
    else:
        assert abs(res[key] - ref) < tol, res[key] - ref


def test_loop_matches_jax(mesh):
    from libdmet_preview_tpu_torch import workloads as wl
    res = mesh[2]
    ref = wl.DIAMOND_JAX["tier1_mesh"]
    assert res["loop_converged"] and ref["loop_converged"]
    assert len(res["loop"]) == len(ref["loop"])
    assert np.abs(np.asarray(res["loop"]) - ref["loop"]).max() \
        < wl.DIAMOND_SCF_TOL
    assert abs(res["loop_n"] - ref["loop_n"]) < wl.DIAMOND_SCF_TOL


@pytest.mark.parametrize("kind", ["chain", "mesh"])
def test_identities(request, kind):
    """Lattice mean field == SCF, IB-HF == lattice HF (at this precision
    the IB identity holds to 3.1e-8 in both packages), impurity filling."""
    res = request.getfixturevalue(kind)[2]
    assert abs(res["E_mf"] - res["E_hf"]) < 1e-7
    assert abs(res["E_ibhf"] - res["E_hf"]) < 1e-6
    assert abs(res["n_cc"] - 1.0) < 0.05
    assert -0.3 < res["E_cc"] - res["E_hf"] < -0.05


def test_chain_and_mesh_agree(chain, mesh):
    """Dense supercell RHF (chain) == k-space stripe HF (mesh) on the same
    two-cell torus."""
    assert abs(chain[1]["E_hf"] - mesh[1]["E_hf"]) < 1e-10


def test_h2_formats(chain, mesh):
    from libdmet_preview_tpu_torch.ints.pbc import PbcCell
    Lat, meta, _ = chain
    assert Lat.H2_format == "cholesky" and Lat.Ham.aft_cell is None
    assert Lat.chol_L.device == CPU and Lat.chol_L.dtype == torch.float64
    assert set(meta) == {"cell", "E_hf", "E_hf_elec", "e_nuc", "C_ao_lo",
                         "eri_lo", "h_lo", "fock_lo", "rdm1_lo", "nlo", "S"}
    Lat, meta, res = mesh
    assert Lat.H2_format == "aft" and Lat.Ham.df_mode == "rs"
    assert isinstance(Lat.Ham.aft_cell, PbcCell) and Lat.getH2() is None
    assert set(meta) == {"cell", "E_hf", "E_hf_elec", "e_nuc", "C_ao_lo",
                         "nlo", "h_lo_R", "fock_lo_R", "rdm1_lo_R", "S_st",
                         "C_k", "h_st", "W", "Y", "kmesh", "tr_diff"}
    nlo = meta["nlo"]
    ref = meta["cell"].get_emb_eri_rs(meta["C_ao_lo"][:, :nlo])
    assert torch.equal(Lat.Ham.eri_imp, ref)
    # the 'aft' H2 of the one-shot is a float64 tensor on the cell's device
    H2 = res["ImpHam"].H2["ccdd"]
    neo = res["basis"].shape[-1]
    assert isinstance(H2, torch.Tensor) and H2.shape == (1,) + (neo,) * 4
    assert H2.dtype == torch.float64 and H2.device == CPU


def test_mesh_cache_file_round_trip(mesh, cache_dir):
    """make_diamond_lattice3(cache_file=a directory) wrote the JAX
    package's keys under its key-named file, and a second build reads it
    back to the same lattice."""
    import os
    from libdmet_preview_tpu_torch import workloads as wl
    from libdmet_preview_tpu_torch.models import abinitio
    files = os.listdir(cache_dir)
    assert files == ["diamond3_rs1_1x1x2_3.567_gth-szv_gth-pade_1e-04.npz"]
    with np.load(os.path.join(cache_dir, files[0])) as dat:
        assert set(dat.files) == {"h_st", "S_st", "eriF", "e_nuc", "Gv",
                                  "fcol_re", "fcol_im"}
    meta = mesh[1]
    Lat2, meta2 = abinitio.make_diamond_lattice3(
        cache_file=str(cache_dir), device=CPU, **wl.DIAMOND_TIER1["mesh"])
    assert abs(meta2["E_hf"] - meta["E_hf"]) < 1e-12
    assert np.abs(meta2["fock_lo_R"] - meta["fock_lo_R"]).max() < 1e-12
    assert torch.equal(Lat2.Ham.eri_imp, mesh[0].Ham.eri_imp)
