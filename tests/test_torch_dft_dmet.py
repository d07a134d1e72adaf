"""
DFT-in-DMET in the PyTorch port (models/abinitio.attach_ks, the xc double
counting of ops/embham._emb_H1, the DFT-in-DMET loop of
libdmet_preview_tpu_torch/workloads.run_dft_dmet) against the JAX
package's on the 3-cell x 2-atom STO-6G H ring of tests/test_dft.py
(Lowdin LOs), on the CPU: attach_ks's KS Fock and density stripes, the
embedding H1 with the LSDA / PBE double counting in the JAX package's
bath basis, the HF-limit identity, the LSDA- and PBE-in-DMET loops of
tests/test_dft.py:139-182, and the PBE double-counting identity of
tests/test_dft.py:317-336.

Tolerances: the KS energy 1e-9, the stripes 1e-8 (each SCF stops at
|dE| < 1e-9); H1 with the double counting 1e-10; the HF-limit identity
(xc_dc = 0, hyb = 1 against the standard interacting bath) 1e-11; the
loops' E per cell, nelecImp and rhoImp 1e-8; the PBE dc identity 1e-12.
The JAX side of each functional runs once, in its own thread.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

torch.set_num_threads(1)
CPU = torch.device("cpu")


def _jax_lattice():
    from libdmet_preview_tpu.models.abinitio import make_h_ring_lattice
    return make_h_ring_lattice(ncells=3, atoms_per_cell=2, r_bond=1.8,
                               basis="sto-6g")


def _port_lattice():
    from libdmet_preview_tpu_torch.ints.gto import h_ring_mole
    from libdmet_preview_tpu_torch.models.abinitio import make_h_ring_lattice
    return make_h_ring_lattice(h_ring_mole(6, 1.8, "sto-6g"), ncells=3,
                               device=CPU)


def _jax_loop(Lat, meta):
    """tests/test_dft.py:139-182 in the JAX package; also returns the
    embedding problem it built (ImpHam before the loop, basis, vcor)."""
    import libdmet_preview_tpu.dmet.hubbard as dmet
    from libdmet_preview_tpu.solvers import FCI
    from libdmet_preview_tpu_torch.workloads import DFT_DMET
    nlo = meta["nlo"]
    vcor = dmet.VcorLocal(True, False, nlo)
    vcor.update(np.zeros(vcor.length()))
    filling = meta["mole"].nelectron / (2.0 * meta["mole"].nao)
    rho, mu = dmet.RHartreeFock(Lat, vcor, filling, None)
    ImpHam, H1e, basis = dmet.ConstructImpHam(Lat, rho, vcor, matching=False,
                                              int_bath=True)
    H1_0 = np.array(ImpHam.H1["cd"], copy=True)
    solver = FCI(restricted=True, tol=1e-12)
    mu_solver = dmet.MuSolver(adaptive=True)
    solver_args = {"nelec": (Lat.ncore + Lat.nval) * 2}
    last_dmu = 0.0
    for it in range(DFT_DMET["max_iter"]):
        rhoEmb, E_emb, ImpHam, dmu = mu_solver(
            Lat, filling, ImpHam, basis, solver, solver_args)
        last_dmu += dmu
        rhoImp, EnergyImp, nelecImp = dmet.transformResults(
            rhoEmb, E_emb, basis, ImpHam, H1e, lattice=Lat,
            last_dmu=last_dmu, int_bath=True, solver=solver,
            solver_args=solver_args)
        if abs(nelecImp - 2 * filling) < DFT_DMET["nelec_tol"]:
            break
    return {"E": float(EnergyImp) * nlo, "nelecImp": float(nelecImp),
            "rhoImp": np.asarray(rhoImp), "steps": it + 1, "H1": H1_0,
            "basis": np.asarray(basis), "vcor": vcor}


def _jax_side(xc):
    from libdmet_preview_tpu.models.abinitio import attach_ks
    Lj, mj = _jax_lattice()
    ksj = attach_ks(Lj, mj, xc=xc)
    return Lj, mj, ksj, _jax_loop(Lj, mj)


@pytest.fixture(scope="module")
def jax_side():
    """{xc: the JAX package's lattice, meta, RKS and loop}, each functional
    in its own thread."""
    with ThreadPoolExecutor(2) as ex:
        futures = {xc: ex.submit(_jax_side, xc) for xc in ("lsda", "pbe")}
        return {xc: f.result() for xc, f in futures.items()}


@pytest.fixture(scope="module", params=["lsda", "pbe"])
def dft(request, jax_side):
    """Both packages: the ring, attach_ks(xc) and the DFT-in-DMET loop."""
    from libdmet_preview_tpu_torch import workloads as wl
    from libdmet_preview_tpu_torch.models.abinitio import attach_ks
    from libdmet_preview_tpu_torch.solvers import FCI
    xc = request.param
    Lt, mt = _port_lattice()
    kst = attach_ks(Lt, mt, xc=xc)
    loop_t = wl.run_dft_dmet(Lt, mt, FCI(restricted=True, tol=1e-12,
                                         device=CPU))
    return {"xc": xc, "j": jax_side[xc], "t": (Lt, mt, kst, loop_t)}


def test_attach_ks_matches_jax(dft):
    Lj, mj, ksj, _ = dft["j"]
    Lt, mt, kst, _ = dft["t"]
    assert kst.converged and abs(kst.e_tot - ksj.e_tot) < 1e-9
    assert kst.cycles > 2 and Lt.xc_hyb == Lj.xc_hyb == 0.0
    assert Lt.use_hcore_as_emb_ham is False
    assert np.abs(np.asarray(Lt.fock_lo_R)
                  - np.asarray(Lj.fock_lo_R)).max() < 1e-8
    assert np.abs(np.asarray(Lt.rdm1_lo_R)
                  - np.asarray(Lj.rdm1_lo_R)).max() < 1e-8
    # the stored k-space Fock is the stripes' transform
    fk = Lt.R2k(Lt.fock_lo_R)
    assert np.abs(np.asarray(fk[0]) - np.asarray(Lt.fock_lo_k[0])).max() \
        < 1e-14


def test_emb_h1_with_xc_dc_matches_jax(dft):
    """The port's _emb_H1 (J - hyb K / 2 + B^T v_xc[B rho B^T] B removed
    from the KS Fock) in the JAX package's bath basis == JAX's H1."""
    from libdmet_preview_tpu_torch.ops import embham
    from libdmet_preview_tpu_torch.ops.vcor import VcorLocal
    Lt, mt = dft["t"][:2]
    loop_j = dft["j"][3]
    basis = torch.as_tensor(loop_j["basis"])
    vcor = VcorLocal(True, False, mt["nlo"])
    vcor.update(np.zeros(vcor.length()))
    H2 = embham._emb_H2(Lt, basis, vcor, int_bath=True)
    H1, _ = embham._emb_H1(Lt, basis, vcor, H2, int_bath=True)
    assert np.abs(H1.numpy() - loop_j["H1"]).max() < 1e-10


def test_hf_limit_identity():
    """xc_dc == 0 with hyb = 1 gives the standard interacting-bath H1."""
    import libdmet_preview_tpu_torch.dmet.hubbard as dmet
    Lat, meta = _port_lattice()
    vcor = dmet.VcorLocal(True, False, meta["nlo"])
    vcor.update(np.zeros(vcor.length()))
    filling = meta["mole"].nelectron / (2.0 * meta["mole"].nao)
    rho, _ = dmet.RHartreeFock(Lat, vcor, filling, None)
    std, _, _ = dmet.ConstructImpHam(Lat, rho, vcor, matching=False,
                                     int_bath=True)
    Lat.xc_dc = lambda rho_lo: torch.zeros_like(rho_lo)
    Lat.xc_hyb = 1.0
    dc, _, _ = dmet.ConstructImpHam(Lat, rho, vcor, matching=False,
                                    int_bath=True)
    assert (dc.H1["cd"] - std.H1["cd"]).abs().max() < 1e-11


def test_dft_in_dmet_loop_matches_jax(dft):
    """tests/test_dft.py:139-182 in both packages: E per cell, nelecImp
    and rhoImp (1e-8); the filling is held and the impurity density stays
    within 0.05 of the KS lattice's (the JAX suite's checks)."""
    Lt, mt, _, lt = dft["t"]
    lj = dft["j"][3]
    filling = mt["mole"].nelectron / (2.0 * mt["mole"].nao)
    assert lt["steps"] == lj["steps"]
    assert abs(lt["E"] - lj["E"]) < 1e-8
    assert abs(lt["nelecImp"] - lj["nelecImp"]) < 1e-8
    assert np.abs(lt["rhoImp"] - lj["rhoImp"]).max() < 1e-8
    assert abs(lt["nelecImp"] - 2 * filling) < 1e-6
    rho_ks_imp = np.asarray(Lt.rdm1_lo_R)[0, 0]
    assert np.abs(lt["rhoImp"][0] * 2.0 - rho_ks_imp).max() < 0.05


def test_xc_dc_reproduces_the_molecular_vxc(dft):
    """tests/test_dft.py:317-336: Lat.xc_dc at the KS density is the
    molecular v_xc rotated to the LOs (1e-12), a tensor on the lattice's
    device."""
    from libdmet_preview_tpu_torch.ints.xc import eval_exc_vxc
    Lt, mt, ks, _ = dft["t"]
    C = mt["C_ao_lo"]
    SC = torch.as_tensor(mt["mole"].intor_ovlp()) @ C
    v_dc = Lt.xc_dc(SC.T @ ks.dm @ SC)
    _, vxc_ao = eval_exc_vxc(ks.dm, ks.ao_g, ks.grid[1], restricted=True,
                             xc=dft["xc"], ao_grad=ks.ao_grad_g)
    assert isinstance(v_dc, torch.Tensor) and v_dc.device == CPU
    assert (v_dc - C.T @ vxc_ao @ C).abs().max() < 1e-12
