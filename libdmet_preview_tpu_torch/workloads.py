"""
The ab initio workloads and DMET protocols that chip_smoke.py phase 11
drives on the card and tests/test_torch_abinitio_lattices.py holds to the
JAX package on the CPU, in one place so that both run the same protocol:

* the periodic H chain (3 k-points, 3-21G; the engine arrays of
  data/hchain_nk3_nH2_R1.5_vac10_3-21g.npz, or the port's own cell,
  hchain_cell, whose integrals equal them): the reference's anchors, the
  JAX package's values on the same integrals, the self-consistent
  interacting-bath loop of tests/test_hchain_pbc.py / tests/
  test_anchors.py (run_hchain_dmet, one iteration replayable from its
  recorded state), and the UHF non-interacting bath; the same chain at
  HCHAIN_FULL_NK k-points from the port's cell, held to the JAX engine's
  values PBC_JAX (chip_smoke.py phase 14);
* the k-space stripe HF on random translation-symmetric integrals at
  make_diamond_lattice3's width (make_kscf_workload, run_kscf) and its
  dense-supercell check at a small mesh;
* the systems of the correlated solvers' oracles (the CAS family, tailored
  CC, OO-CCD, static GW) as port Integrals with the JAX suite's NumPy
  draws, and the fake executables of the external-solver bridges, which
  chip_smoke.py phase 12 runs on the card and the tests hold to the JAX
  suite's systems and fakes.
"""

import copy
import os
import textwrap

import numpy as np
import torch

from libdmet_preview_tpu_torch.lo.lowdin import _h
from libdmet_preview_tpu_torch.utils.misc import to_host

HCHAIN_FILE = "hchain_nk3_nH2_R1.5_vac10_3-21g.npz"
# the reference's HChain cell (Angstrom; tests/test_hchain_pbc.py), which
# HCHAIN_FILE holds at nk = 3, and the k-points of the full-width chain
HCHAIN_CELL = {"nH": 2, "R": 1.5, "vac": 10.0, "basis": "3-21g"}
HCHAIN_FULL_NK = 6
# the JAX engine's values on the chain at nk k-points, from
#     JAX_PLATFORMS=cpu python scripts/pbc_reference_jax.py --nk 6
# on the CPU: the Ewald energy, the supercell RHF energy, the Frobenius
# norms of S, hcore and the range-separated ERI (held at PBC_JAX_RTOL),
# and the IB FCI loop's E/cell under IB_PROTOCOL with its iteration count
# (held at IB_JAX_TOL: the loop stops at dE < 1e-6)
PBC_JAX = {
    3: {"nao": 12, "e_nuc": 0.9962407464773955, "E_hf": -2.60244743963303,
        "S_fro": 4.548334460238303, "hcore_fro": 3.828145162202471,
        "eri_fro": 5.445591760842514, "E_ib_fci": -1.2430652635834325,
        "iterations": 7},
    6: {"nao": 24, "e_nuc": 1.992481492954795, "E_hf": -5.315609163705615,
        "S_fro": 6.432311456940024, "hcore_fro": 5.413793359820447,
        "eri_fro": 8.607913548479884, "E_ib_fci": -1.275461590897076,
        "iterations": 6},
}
PBC_JAX_RTOL = 1e-9
# the reference's H-chain anchors (README, tests/test_hchain_pbc.py,
# tests/test_anchors.py) and the tolerance each is held to
HCHAIN_ANCHORS = {"IB FCI": (-1.243085261466, 1e-4),
                  "NIB UHF": (-1.238248899089, 5e-5),
                  "CCSD": (-1.242988933742, 1e-4),
                  "CCD": (-1.242043057334, 1e-4),
                  "BCCSD": (-1.243042935207, 1e-4),
                  "csc_glob": (-1.242180528205, 1e-4),
                  "det": (-1.243371414161, 1e-4),
                  "idem_fit": (-1.243085261466, 1e-4),
                  # the JAX suite holds this one to 1.5e-4: on these
                  # integrals its own loop ends 8.6e-5 from the anchor
                  # (tests/test_anchors.py:145-158)
                  "E1 from glob": (-1.242066325237, 1.5e-4)}
# the JAX package's E/cell on the same integrals, the same protocols, run
# on the CPU at commit 68728fc (IB FCI: tests/test_hchain_pbc.py:106-158;
# the rest: tests/test_anchors.py run_hchain_dmet on fresh lattices); the
# port is held to them at IB_JAX_TOL / VARIANT_TOL (the loops stop at
# dE < 1e-6 / 5e-6)
HCHAIN_JAX = {"IB FCI": -1.243065263583, "CCSD": -1.242969507283,
              "CCD": -1.242021580926, "BCCSD": -1.243023684155,
              "csc_glob": -1.242171924379, "det": -1.243350254220,
              "idem_fit": -1.243066856700, "E1 from glob": -1.242152499420}
IB_JAX_TOL = 1e-6           # the IB FCI loop against the JAX package
VARIANT_TOL = 1e-5     # the variants (the fit's flat valley moves the end)
# tests/test_hchain_pbc.py:106-158 (IB FCI) and tests/test_anchors.py:24-112
# (the variants): iterations, fit steps, fit ytol, the dV measure, stops
IB_PROTOCOL = {"max_iter": 12, "fit_iter": 500, "ytol": 1e-7, "dv": "norm",
               "u_tol": 1e-5, "e_tol": 1e-6}
ANCHOR_PROTOCOL = {"max_iter": 14, "fit_iter": 300, "ytol": 1e-8,
                   "dv": "max", "u_tol": 5e-5, "e_tol": 5e-6}
# the CC solvers (beta 1000) and the FCI protocol variants
HCHAIN_VARIANTS = [("CCSD", "CCSD", {"beta": 1000.0}),
                   ("CCD", "CCD", {"beta": 1000.0}),
                   ("BCCSD", "BCCSD", {"beta": 1000.0}),
                   ("csc_glob", "FCI", {"charge_sc": False,
                                        "csc_glob": True}),
                   ("det", "FCI", {"det": True}),
                   ("idem_fit", "FCI", {"idem_fit": True}),
                   ("E1 from glob", "FCI", {"e1_from_glob": True})]
# the k-space stripe HF at make_diamond_lattice3's default width (27 cells x
# 8 orbitals, 8 electrons per cell) on random integrals
KSCF = {"kmesh": (3, 3, 3), "nlo": 8, "nelec_cell": 8, "nfac": 8,
        "check_kmesh": (2, 2, 1), "seed": 17}


def hchain_cell(nk, device):
    """The port's PbcCell of the H chain at nk k-points (HCHAIN_CELL)."""
    from libdmet_preview_tpu_torch.ints.pbc import make_hchain_supercell
    return make_hchain_supercell(nk=nk, device=device, **HCHAIN_CELL)


def hchain_lattice(ints, device, uhf=False):
    """The H-chain lattice (RHF or UHF) of `ints`: its EngineInts, or the
    PbcCell (hchain_cell), whose integrals the factory then makes."""
    from libdmet_preview_tpu_torch.models import abinitio
    if uhf:
        return abinitio.make_hchain_pbc_lattice_uhf(ints, device=device)
    return abinitio.make_hchain_pbc_lattice(ints, device=device)


def hchain_solver(name, device):
    from libdmet_preview_tpu_torch import solvers
    if name == "FCI":
        return solvers.FCI(restricted=True, tol=1e-12, device=device)
    return getattr(solvers, name)(restricted=True, tol=1e-9, device=device)


def _hchain_vcor(nsc, det):
    from libdmet_preview_tpu_torch.ops.vcor import VcorLocal, VcorRestricted
    # the det protocol fits a diagonal-only restricted vcor
    vcor = (VcorRestricted(True, False, [], range(nsc)) if det
            else VcorLocal(True, False, nsc))
    vcor.assign(np.zeros((2, nsc, nsc)))
    return vcor


def hchain_iteration(Lat, meta, vcor, state, solver, proto, beta=np.inf,
                     charge_sc=True, csc_glob=False, e1_from_glob=False,
                     det=False, idem_fit=False):
    """One iteration of the H-chain interacting-bath loop (mean field ->
    update_ham_dense -> ConstructImpHam -> apply_dmu -> MuSolver ->
    transformResults -> FitVcor), each step a utils.timer stage.  state
    {"Mu", "last_dmu", "mu_solver"} is advanced in place, and "neo" set to
    the embedding basis' width.  Returns
    (E_cell, nelec_cell, dmu, fit error, fitted vcor)."""
    import libdmet_preview_tpu_torch.dmet.hubbard as dmet
    from libdmet_preview_tpu_torch.models.abinitio import update_ham_dense
    from libdmet_preview_tpu_torch.ops import embham
    from libdmet_preview_tpu_torch.utils.timer import stage
    dev = Lat.device
    nsc = Lat.nscsites
    filling = 6 / (nsc * 2.0 * 3)
    with stage("mean field", dev):
        rho, state["Mu"], _ = dmet.RHartreeFock(Lat, vcor, filling,
                                                state["Mu"], beta=beta,
                                                ires=True)
    if charge_sc:
        with stage("update_ham_dense", dev):
            update_ham_dense(Lat, meta, np.asarray(rho)[0] * 2.0)
    ImpHam, H1e, basis = dmet.ConstructImpHam(Lat, rho, vcor, matching=False,
                                              int_bath=True)
    ImpHam = dmet.apply_dmu(Lat, ImpHam, basis, state["last_dmu"])
    state["neo"] = int(basis.shape[-1])
    solver_args = {"nelec": (Lat.ncore + Lat.nval) * 2}
    with stage("impurity solves", dev):
        rhoEmb, EnergyEmb, ImpHam, dmu = state["mu_solver"](
            Lat, filling, ImpHam, basis, solver, solver_args,
            thrnelec=1e-6, delta=0.01, step=0.1)
    state["last_dmu"] += dmu
    extra = {}
    with stage("energy", dev):
        if csc_glob:
            # charge self-consistency from the correlated global rdm: the
            # same veff replaces JK_core in the energy functional
            _, veff_st = embham.update_lattice_csc(Lat, rhoEmb, basis)
            extra["veff"] = veff_st
        if e1_from_glob:
            veff_st, rho_glob = embham.get_veff_from_rdm1_emb(Lat, rhoEmb,
                                                              basis)
            h1_k = np.asarray(Lat.getH1(kspace=True))
            v_k = np.asarray(Lat.R2k(veff_st))
            g_k = np.asarray(Lat.R2k(rho_glob))
            A_re = h1_k[0] + 0.5 * v_k[0]
            A_im = h1_k[1] + 0.5 * v_k[1]
            if A_re.ndim == 3:
                A_re, A_im = A_re[None], A_im[None]
            E1 = (np.einsum("skpq, skqp ->", A_re, g_k[0])
                  - np.einsum("skpq, skqp ->", A_im, g_k[1])) / 3.0
            extra = {"E1": E1 * 2.0 / rhoEmb.shape[0], "rdm1_emb": rhoEmb}
        _, EnergyImp, nelecImp = dmet.transformResults(
            rhoEmb, EnergyEmb, basis, ImpHam, H1e, lattice=Lat,
            last_dmu=state["last_dmu"], int_bath=True, solver=solver,
            solver_args=solver_args, **extra)
    with stage("vcor fit", dev):
        vcor_new, err = dmet.FitVcor(rhoEmb, Lat, basis, vcor, beta, filling,
                                     MaxIter1=proto["fit_iter"], MaxIter2=0,
                                     ytol=proto["ytol"], gtol=1e-4, det=det,
                                     idem_fit=idem_fit)
    return (float(EnergyImp) * nsc, float(nelecImp) * nsc, float(dmu),
            float(err), vcor_new)


def run_hchain_dmet(Lat, meta, solver, proto, beta=np.inf, **variant):
    """The self-consistent H-chain loop of the JAX suite (protocol `proto`,
    variant flags of hchain_iteration) on Lat's device: trace fix from
    iteration 3, DIIS from 4.  Returns (E_cell, records); each record holds
    the iteration's outputs and the state it started from (vcor, Mu,
    last_dmu, MuSolver history, the lattice's Fock and density), enough to
    replay it with replay_hchain_iteration."""
    import libdmet_preview_tpu_torch.dmet.hubbard as dmet
    from libdmet_preview_tpu_torch.ops.diis import DIIS
    from libdmet_preview_tpu_torch.ops.fit import make_vcor_trace_unchanged
    vcor = _hchain_vcor(Lat.nscsites, variant.get("det", False))
    state = {"Mu": 0.0, "last_dmu": 0.0,
             "mu_solver": dmet.MuSolver(adaptive=True)}
    adiis = DIIS(space=4)
    E_old, E_cell, records = 0.0, None, []
    for it in range(proto["max_iter"]):
        start = {"vcor": vcor.param.copy(), "Mu": state["Mu"],
                 "last_dmu": state["last_dmu"],
                 "mu_history": copy.deepcopy(state["mu_solver"].history),
                 "fock_R": np.array(Lat.fock_lo_R, copy=True),
                 "rdm1_R": np.array(Lat.rdm1_lo_R, copy=True)}
        E_cell, nelec, dmu, err, vcor_new = hchain_iteration(
            Lat, meta, vcor, state, solver, proto, beta=beta, **variant)
        if it >= 3:
            vcor_new = make_vcor_trace_unchanged(vcor_new, vcor)
        pvcor = np.hstack(vcor_new.param)
        fitted = pvcor.copy()
        if it >= 4:
            pvcor = adiis.update(pvcor)
        if proto["dv"] == "norm":
            dV = np.linalg.norm(pvcor - vcor.param) / len(vcor.param)
        else:
            dV = np.max(np.abs(pvcor - np.hstack(vcor.param)))
        vcor.update(np.asarray(pvcor))
        dE, E_old = E_cell - E_old, E_cell
        records.append({"iter": it, "E": E_cell, "nelec": nelec, "dmu": dmu,
                        "fit_err": err, "fitted": fitted, "dV": dV,
                        "neo": state["neo"], "start": start})
        if dV < proto["u_tol"] and abs(dE) < proto["e_tol"] and it > 4:
            break
    return E_cell, records


def replay_hchain_iteration(Lat, meta, solver, proto, rec, beta=np.inf,
                            **variant):
    """Iteration rec["iter"] of run_hchain_dmet again on Lat's device, from
    the state it started from.  Returns (E_cell, nelec, dmu, fit error,
    fitted parameters before the trace fix)."""
    import libdmet_preview_tpu_torch.dmet.hubbard as dmet
    st = rec["start"]
    Lat.update_Ham(st["rdm1_R"], fock_lo_k=Lat.R2k(st["fock_R"]))
    Lat.fock_lo_R = st["fock_R"]
    vcor = _hchain_vcor(Lat.nscsites, variant.get("det", False))
    vcor.update(st["vcor"])
    mu_solver = dmet.MuSolver(adaptive=True)
    mu_solver.history = copy.deepcopy(st["mu_history"])
    state = {"Mu": st["Mu"], "last_dmu": st["last_dmu"],
             "mu_solver": mu_solver}
    E, nelec, dmu, err, vcor_new = hchain_iteration(
        Lat, meta, vcor, state, solver, proto, beta=beta, **variant)
    return E, nelec, dmu, err, np.hstack(vcor_new.param)


def run_hchain_nib_uhf(ints, device):
    """The NIB UHF protocol of tests/test_hchain_pbc.py:161-198 on
    `device`: AFM UHF lattice, one MuSolver'd FCI.  Returns (E_cell, max
    |rho_a - rho_b|, HF energy error per cell)."""
    import libdmet_preview_tpu_torch.dmet.hubbard as dmet
    from libdmet_preview_tpu_torch.models.abinitio import update_ham_dense_uhf
    from libdmet_preview_tpu_torch.ops.vcor import VcorLocal
    from libdmet_preview_tpu_torch.solvers import FCI
    Lat, meta = hchain_lattice(ints, device, uhf=True)
    nsc = Lat.nscsites
    filling = 6 / (nsc * 2.0 * 3)
    vcor = VcorLocal(False, False, nsc)
    vcor.assign(np.zeros((2, nsc, nsc)))
    solver = FCI(restricted=False, tol=1e-12, device=device)
    rho, Mu, res = dmet.HartreeFock(Lat, vcor, filling, None, ires=True)
    afm = float(np.abs(np.asarray(rho)[0] - np.asarray(rho)[1]).max())
    hf_err = abs(res["E"] - meta["E_hf_elec"] / 3)
    update_ham_dense_uhf(Lat, meta, np.asarray(rho))
    ImpHam, H1e, basis = dmet.ConstructImpHam(Lat, rho, vcor, matching=True,
                                              int_bath=False)
    solver_args = {"nelec": (Lat.ncore + Lat.nval) * 2}
    rhoEmb, EnergyEmb, ImpHam, dmu = dmet.MuSolver(adaptive=True)(
        Lat, filling, ImpHam, basis, solver, solver_args, thrnelec=5e-6,
        delta=0.01, step=0.1)
    _, EnergyImp, _ = dmet.transformResults(
        rhoEmb, EnergyEmb, basis, ImpHam, H1e, lattice=Lat, last_dmu=dmu,
        int_bath=False, solver=solver, solver_args=solver_args)
    return float(EnergyImp) * nsc, afm, hf_err


def _tr_stripe_mesh(rng, lat, n, scale):
    """Random time-reversal-symmetric stripe on a mesh lattice (st[-R] =
    st[R]^T), decaying with the cell's distance from the origin."""
    neg = lat._neg_map
    pos = lat.cells
    dist = np.linalg.norm(np.minimum(pos, lat.csize - pos), axis=1)
    st = np.zeros((lat.ncells, n, n))
    for R in range(lat.ncells):
        if neg[R] < R:
            continue
        blk = rng.randn(n, n) * scale / (1.0 + dist[R]) ** 2
        if neg[R] == R:
            blk = 0.5 * (blk + blk.T)
        st[R] = blk
        st[neg[R]] = blk.T
    return st


def make_kscf_workload(kmesh, nlo=KSCF["nlo"], nfac=KSCF["nfac"],
                       seed=KSCF["seed"], device=torch.device("cuda")):
    """Random translation-symmetric integrals on a 3D mesh, NumPy from
    `seed`: nfac random symmetric real-space DF factors l_x on the
    supercell (decaying with each cell's distance from the origin) and all
    their translations T give (IJ|KL) = sum_{x,T} l_x[I-T, J-T] l_x[K-T,
    L-T]; the 'full' format eriF[D, E, F] = ((0)p (D)q | (E)r (F)s) is one
    GEMM over (x, T), with no supercell four-index tensor.  hcore has a gap
    between the lower and upper halves of each cell's orbitals; the
    overlap is the identity plus a small stripe.  Returns (lattice, h_st,
    S_st, eriF on `device`, the translated factors B (nfac * N, N, N, n,
    n) on `device`, nelec of the supercell)."""
    from libdmet_preview_tpu_torch.models.lattice import MeshLattice
    lat = MeshLattice(kmesh, nlo)
    N, sub = lat.ncells, lat._sub_tab
    rng = np.random.RandomState(seed)
    h_st = _tr_stripe_mesh(rng, lat, nlo, 0.2)
    h_st[0] += np.diag([-2.0] * (nlo // 2) + [2.0] * (nlo - nlo // 2))
    S_st = 0.05 * _tr_stripe_mesh(rng, lat, nlo, 1.0)
    S_st[0] += np.eye(nlo)
    pos = lat.cells
    dist = np.linalg.norm(np.minimum(pos, lat.csize - pos), axis=1)
    decay = 1.0 / (1.0 + dist) ** 2
    l = rng.randn(nfac, N, nlo, N, nlo) * 0.15
    l = 0.5 * (l + l.transpose(0, 3, 4, 1, 2))
    l = l * decay[None, :, None, None, None] * decay[None, None, None, :,
                                                     None]
    lt = torch.as_tensor(l.transpose(0, 1, 3, 2, 4), device=device)
    # B[x, T, I, J] = l_x[I - T, J - T] (the factor translated by T)
    subT = torch.as_tensor(sub, dtype=torch.long, device=device)  # [I, T]
    B = lt[:, subT.T[:, :, None], subT.T[:, None, :]]   # (x, T, I, J, p, q)
    B = B.reshape(nfac * N, N, N, nlo, nlo)
    G = B[:, 0].reshape(nfac * N, -1)                   # (X, D p q)
    H = B.reshape(nfac * N, -1)                         # (X, E F r s)
    eriF = (G.T @ H).reshape(N, nlo, nlo, N, N, nlo, nlo)
    eriF = eriF.permute(0, 3, 4, 1, 2, 5, 6).contiguous()
    return lat, h_st, S_st, eriF, B, N * KSCF["nelec_cell"]


def kscf_dense_check(kmesh=KSCF["check_kmesh"],
                     device=torch.device("cuda")):
    """kscf_stripe_hf against the dense supercell RHF (solvers.scf.SCF with
    the overlap) of the same construction; returns |E_k - E_dense|."""
    from libdmet_preview_tpu_torch.models.abinitio import kscf_stripe_hf
    from libdmet_preview_tpu_torch.models.integral import Integral
    from libdmet_preview_tpu_torch.solvers.scf import SCF
    lat, h_st, S_st, eriF, B, nelec = make_kscf_workload(kmesh,
                                                         device=device)
    E_k, _, _ = kscf_stripe_hf(h_st, S_st, eriF, lat._sub_tab, kmesh, nelec,
                               tol=1e-12, device=device)
    X, N, _, m, _ = B.shape
    Bf = B.permute(0, 1, 3, 2, 4).reshape(X, N * m * N * m)
    eri = (Bf.T @ Bf).reshape((N * m,) * 4)
    h, S = lat.expand(h_st), lat.expand(S_st)
    Ham = Integral(N * m, True, False, 0.0, {"cd": h[None]},
                   {"ccdd": eri[None]}, ovlp=S)
    scf = SCF(device=device)
    scf.set_system(nelec, 0, False, True)
    scf.set_integral(Ham)
    E_d, _ = scf.HF(tol=1e-12, MaxIter=200)
    return abs(E_k - E_d), E_k, E_d


def run_kscf(work, device, info=None):
    """The JK tables, kscf_stripe_hf over them on `device` and one
    update_ham_eriF on the converged LO density, each a utils.timer stage
    (info receives kscf_stripe_hf's).  Returns (E, rho_st, fock_st,
    updated LO Fock stripes, the converged Fock in the LO basis)."""
    from libdmet_preview_tpu_torch import interop
    from libdmet_preview_tpu_torch.models import abinitio
    from libdmet_preview_tpu_torch.utils.timer import stage
    lat, h_st, S_st, eriF, _, nelec = work
    kmesh = tuple(int(x) for x in lat.kmesh)
    m = h_st.shape[-1]
    eriF = eriF.to(device)
    with stage("JK tables", device):
        W, Y = abinitio.make_jk_tables(eriF, lat._sub_tab)
    with stage("k-space SCF", device):
        E, rho_st, fock_st = abinitio.kscf_stripe_hf(
            h_st, S_st, eriF, lat._sub_tab, kmesh, nelec, tol=1e-11,
            device=device, info=info, jk_tables=(W, Y))
    with stage("LO basis + update_ham_eriF", device):
        C_k, Sh_k = abinitio.lowdin_k(torch.as_tensor(S_st, device=device),
                                      kmesh)
        R2k, k2R = abinitio._fft_pair(kmesh, m)
        rho_lo = k2R(_h(Sh_k) @ R2k(rho_st) @ Sh_k).real
        f_lo = k2R(_h(C_k) @ R2k(fock_st) @ C_k).real
        Lat = interop.lattice_from_numpy(kmesh, m, to_host(f_lo),
                                         to_host(f_lo), device=device)
        meta = {"kmesh": kmesh, "nlo": m, "C_k": C_k, "W": W, "Y": Y,
                "tr_diff": lat._sub_tab, "h_st": h_st}
        abinitio.update_ham_eriF(Lat, meta, to_host(rho_lo))
    return E, rho_st, fock_st, meta["fock_lo_R"], to_host(f_lo)


# ----------------------------------------------------------------------
# the correlated solvers' oracle systems and the bridges' fake executables
# ----------------------------------------------------------------------

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def np_integral(h1, g, H0=0.0):
    """A port Integral of NumPy blocks: one block restricted, else per
    spin ([h_a, h_b], [g_aa, g_bb, g_ab])."""
    from libdmet_preview_tpu_torch.models.integral import Integral
    h1, g = np.asarray(h1, dtype=float), np.asarray(g, dtype=float)
    if h1.ndim == 2:
        return Integral(h1.shape[0], True, False, H0, {"cd": h1[None]},
                        {"ccdd": g[None]})
    return Integral(h1.shape[-1], False, False, H0, {"cd": h1},
                    {"ccdd": g})


def hubbard_integral(n, U, stag=0.0, ring=False, onsite=None):
    """Open (or ring) n-site Hubbard chain (tests/test_cc.py's
    hubbard_integral); a staggered field of opposite sign per spin makes it
    unrestricted (its spin_polarized_integral), `onsite` adds a diagonal
    (tests/test_solvers_extra.py's symmetry-broken UCASSCF ring)."""
    h = np.zeros((n, n))
    for i in range(n - (0 if ring else 1)):
        h[i, (i + 1) % n] = h[(i + 1) % n, i] = -1.0
    if onsite is not None:
        h += np.diag(onsite)
    g = np.zeros((n,) * 4)
    for i in range(n):
        g[i, i, i, i] = U
    if not stag:
        return np_integral(h, g)
    s = np.diag([stag * (-1) ** i for i in range(n)])
    return np_integral([h + s, h - s], [g, g, g])


def random_integral(n, seed, u=0.12):
    """tests/test_cc.py's random restricted embedded Hamiltonian (the same
    NumPy draws)."""
    rng = np.random.RandomState(seed)
    h = rng.randn(n, n) * 0.1
    h = h + h.T + np.diag(np.arange(n, dtype=float))
    A = rng.randn(n * (n + 1) // 2, n, n) * (u / n)
    A = A + A.transpose(0, 2, 1)
    return np_integral(h, np.einsum("Lpq, Lrs -> pqrs", A, A), 0.3)


def oo_integral(n=4, U=2.0, H0=0.3):
    """tests/test_oo.py's restricted Hamiltonian (the same NumPy draws)."""
    rng = np.random.RandomState(7)
    h = np.zeros((n, n))
    for i in range(n - 1):
        h[i, i + 1] = h[i + 1, i] = -1.0
    h += np.diag([0.0, 0.4, -0.3, 0.2][:n])
    g = np.zeros((n, n, n, n))
    for i in range(n):
        g[i, i, i, i] = U
    p = 0.1 * rng.rand(n, n, n, n)
    p = p + p.transpose(1, 0, 2, 3)
    p = p + p.transpose(0, 1, 3, 2)
    p = p + p.transpose(2, 3, 0, 1)
    return np_integral(h, g + 0.05 * p, H0)


def spin_orbital_integral(Ham):
    """The spin-orbital (GHF-frame) expansion of a restricted Integral
    (tests/test_oo.py's GHF case)."""
    n = Ham.norb
    h, g = np.asarray(Ham.H1["cd"][0]), np.asarray(Ham.H2["ccdd"][0])
    H1 = np.zeros((2 * n, 2 * n))
    H1[:n, :n] = H1[n:, n:] = h
    G = np.zeros((2 * n,) * 4)
    for a in (slice(0, n), slice(n, 2 * n)):
        for b in (slice(0, n), slice(n, 2 * n)):
            G[a, a, b, b] = g
    return np_integral(H1, G, float(Ham.H0))


def gso_ring(nao=4, U=3.0):
    """The ph-transformed Hubbard ring of tests/test_solvers_extra.py's
    GCASCI / GCASSCF tests, through the port's ops.spinless."""
    from libdmet_preview_tpu_torch.ops import spinless
    h = hubbard_integral(nao, 0.0, ring=True).H1["cd"][0]
    g = np.zeros((nao,) * 4)
    for i in range(nao):
        g[i, i, i, i] = U
    mu = U / 2.0
    GH1_c, GH0 = spinless.transform_H1_k((h[None], np.zeros_like(h)[None]))
    GH1 = spinless.combine_H1_k(GH1_c)
    GV2, GV1, GV0 = spinless.transform_H2_local(g)
    nso = 2 * nao
    H1 = np.array(GH1[0][0])
    H1[:nao, :nao] += GV1[0]
    H1[nao:, nao:] += GV1[1]
    H1 += spinless.mu_matrix(mu, nao)
    eye = torch.eye(nso, dtype=torch.float64).reshape(1, nso, nso)
    g_so = spinless.transform_eri_local_gso(eye[:, :nao, :], eye[:, nao:, :],
                                            GV2).numpy()
    return np_integral(H1, g_so, GH0 + GV0 - mu * nao)


def random_uhf_fock():
    """tests/test_gw.py's random unrestricted Fock matrices and ERI (the
    same draws): (fock (2, 4, 4), eri (4,)*4) for 2 alpha and 1 beta
    electrons."""
    rng = np.random.RandomState(2)
    n = 4
    A = rng.randn(6, n, n)
    A = A + A.transpose(0, 2, 1)
    eri = np.einsum("xpq, xrs -> pqrs", A, A)
    h = rng.randn(n, n)
    h = h + h.T
    dm = []
    for no in (2, 1):
        c = np.linalg.eigh(h)[1]
        dm.append(c[:, :no] @ c[:, :no].T)
    vj = np.einsum("pqrs, rs -> pq", eri, dm[0] + dm[1])
    return np.asarray([h + vj - np.einsum("prqs, rs -> pq", eri, dm[s])
                       for s in range(2)]), eri


def bare_exchange(fock, eri, nocc_s):
    """-K of each spin's Fock eigen-orbitals (tensors): the bare limit of
    get_vsig_emb."""
    out = []
    for F, no in zip(fock, nocc_s):
        c = torch.linalg.eigh(F)[1][:, :no]
        out.append(-torch.einsum("prqs, rs -> pq", eri, c @ c.T))
    return torch.stack(out)


def write_fake(tmp, name, body):
    """An executable script `name` in the directory `tmp`, run by this
    interpreter, from a body with a %(repo)r slot; returns its path."""
    import sys
    path = os.path.join(tmp, name)
    with open(path, "w") as f:
        f.write("#!%s\n" % sys.executable)
        f.write(body % {"repo": REPO})
    os.chmod(path, 0o755)
    return path


# tests/test_dmrg_bridge.py's fake Block binary as it is there (held equal
# to it by tests/test_torch_casci.py)
FAKE_BLOCK = textwrap.dedent("""\
    #!/usr/bin/env python
    # Self-contained fake Block binary: parses dmrg.conf + FCIDUMP and
    # solves the problem with an INDEPENDENT dense numpy FCI (no jax, no
    # package import -- a genuine cross-check of the bridge, and ~10 s
    # faster per call than importing the library stack).
    import sys, os, re, itertools
    import numpy as np

    conf_path = sys.argv[-1]
    conf = open(conf_path).read()
    nelec = int(re.search(r"nelec (\\d+)", conf).group(1))
    spin = int(re.search(r"spin (\\d+)", conf).group(1))
    assert "schedule" in conf and "sweep_tol" in conf
    assert "onepdm" in conf
    fcidump = re.search(r"orbitals (.*)", conf).group(1).strip()
    prefix = re.search(r"prefix (.*)", conf).group(1).strip()

    # --- minimal FCIDUMP reader (chemist notation, 8-fold symm) ---
    txt = open(fcidump).read()
    m = re.search(r"NORB\\s*=\\s*(\\d+)", txt)
    norb = int(m.group(1))
    body = txt[txt.upper().index("&END") + 4:].split()
    h1 = np.zeros((norb, norb))
    eri = np.zeros((norb,) * 4)
    ecore = 0.0
    for off in range(0, len(body), 5):
        v, i, j, k, l = (float(body[off]),) + tuple(
            int(x) for x in body[off + 1:off + 5])
        if i == j == k == l == 0:
            ecore = v
        elif k == l == 0:
            p, q = i - 1, j - 1
            h1[p, q] = h1[q, p] = v
        else:
            p, q, r, s = i - 1, j - 1, k - 1, l - 1
            for (a, b) in ((p, q), (q, p)):
                for (c, d) in ((r, s), (s, r)):
                    eri[a, b, c, d] = eri[c, d, a, b] = v

    # --- dense FCI over (na, nb) determinants ---
    na = (nelec + spin) // 2
    nb = nelec - na
    def strings(n, k):
        return [frozenset(c) for c in itertools.combinations(range(n), k)]
    SA, SB = strings(norb, na), strings(norb, nb)
    det = [(a, b) for a in SA for b in SB]
    idx = {d: i for i, d in enumerate(det)}
    nd = len(det)

    def sign_excite(occ, p, q):
        # remove q, add p in the SORTED occupation list; fermion sign
        occ = sorted(occ)
        iq = occ.index(q)
        occ2 = occ[:iq] + occ[iq + 1:]
        ip = sum(1 for x in occ2 if x < p)
        return (-1) ** (iq + ip), frozenset(occ2 + [p])

    H = np.zeros((nd, nd))
    for I, (a, b) in enumerate(det):
        # diagonal
        e = sum(h1[p, p] for p in a) + sum(h1[p, p] for p in b)
        occs = [(a, a), (b, b)]
        for p in a:
            for q in a:
                e += 0.5 * (eri[p, p, q, q] - eri[p, q, q, p])
            for q in b:
                e += eri[p, p, q, q]
        for p in b:
            for q in b:
                e += 0.5 * (eri[p, p, q, q] - eri[p, q, q, p])
        H[I, I] = e
        # single excitations (same spin channel)
        for chan, occ, other in (("a", a, b), ("b", b, a)):
            for q in occ:
                for p in range(norb):
                    if p in occ:
                        continue
                    sgn, occ2 = sign_excite(occ, p, q)
                    d2 = (occ2, b) if chan == "a" else (a, occ2)
                    J = idx[d2]
                    val = h1[p, q]
                    for r in occ:
                        if r == q:
                            continue
                        val += eri[p, q, r, r] - eri[p, r, r, q]
                    for r in other:
                        val += eri[p, q, r, r]
                    H[J, I] += sgn * val
        # double excitations: same-spin (aa, bb)
        for chan, occ in (("a", a), ("b", b)):
            for q in occ:
                for s in occ:
                    if s <= q:
                        continue
                    for p in range(norb):
                        if p in occ:
                            continue
                        for r in range(norb):
                            if r in occ or r <= p:
                                continue
                            s1, o1 = sign_excite(occ, p, q)
                            s2, o2 = sign_excite(o1, r, s)
                            d2 = (o2, b) if chan == "a" else (a, o2)
                            J = idx[d2]
                            val = eri[p, q, r, s] - eri[r, q, p, s]
                            H[J, I] += s1 * s2 * val
        # opposite-spin doubles
        for q in a:
            for p in range(norb):
                if p in a:
                    continue
                s1, a2 = sign_excite(a, p, q)
                for s in b:
                    for r in range(norb):
                        if r in b:
                            continue
                        s2, b2 = sign_excite(b, r, s)
                        J = idx[(a2, b2)]
                        H[J, I] += s1 * s2 * eri[p, q, r, s]

    ew, ev = np.linalg.eigh(H)
    e = ew[0] + ecore
    c = ev[:, 0]
    # spin-resolved 1-pdm <p+ q>
    rdm_a = np.zeros((norb, norb))
    rdm_b = np.zeros((norb, norb))
    for I, (a, b) in enumerate(det):
        for p in a:
            rdm_a[p, p] += c[I] * c[I]
        for p in b:
            rdm_b[p, p] += c[I] * c[I]
        for chan, occ in (("a", a), ("b", b)):
            for q in occ:
                for p in range(norb):
                    if p in occ:
                        continue
                    sgn, occ2 = sign_excite(occ, p, q)
                    d2 = (occ2, b) if chan == "a" else (a, occ2)
                    J = idx[d2]
                    if chan == "a":
                        rdm_a[p, q] += sgn * c[J] * c[I]
                    else:
                        rdm_b[p, q] += sgn * c[J] * c[I]

    so = np.zeros((2 * norb, 2 * norb))
    so[::2, ::2] = rdm_a
    so[1::2, 1::2] = rdm_b
    os.makedirs(os.path.join(prefix, "node0"), exist_ok=True)
    with open(os.path.join(prefix, "node0", "onepdm.0.0.bin"), "wb") as f:
        f.write(b"HDR!")               # binary reader takes the TAIL
        f.write(so.astype(np.float64).tobytes())

    if "twopdm" in conf:
        # 2-pdm via dense operator matrices A_pq = p+ q per channel:
        # same-spin chemist G[p,q,r,s] = <p+q r+s> - d_qr <p+s>,
        # opposite-spin G_ab[p,q,r,s] = <p+q_a r+s_b> (channels commute)
        def op_mats(chan):
            A = np.zeros((norb, norb, nd, nd))
            for I, (a, b) in enumerate(det):
                occ = a if chan == "a" else b
                for q in occ:
                    A[q, q, I, I] += 1.0
                    for p in range(norb):
                        if p in occ:
                            continue
                        sgn, occ2 = sign_excite(occ, p, q)
                        d2 = (occ2, b) if chan == "a" else (a, occ2)
                        A[p, q, idx[d2], I] += sgn
            return A
        Aa, Ab = op_mats("a"), op_mats("b")
        ca = np.einsum("pqJI, I -> pqJ", Aa, c)     # A_pq |c>
        cb = np.einsum("pqJI, I -> pqJ", Ab, c)
        caT = np.einsum("pqJI, J -> pqI", Aa, c)    # A_pq^T |c>
        cbT = np.einsum("pqJI, J -> pqI", Ab, c)
        r1a = np.einsum("J, pqJ -> pq", c, ca)
        r1b = np.einsum("J, pqJ -> pq", c, cb)
        Gaa = (np.einsum("pqJ, rsJ -> pqrs", caT, ca)
               - np.einsum("qr, ps -> pqrs", np.eye(norb), r1a))
        Gbb = (np.einsum("pqJ, rsJ -> pqrs", cbT, cb)
               - np.einsum("qr, ps -> pqrs", np.eye(norb), r1b))
        if nb == 0:
            out2 = Gaa[None]           # single-species (GSO) block
        else:
            Gab = np.einsum("pqJ, rsJ -> pqrs", caT, cb)
            out2 = np.stack([Gaa, Gbb, Gab])
        np.save(os.path.join(prefix, "2pdm.npy"), out2)
    print("Sweep Energy = %%.12f" %% e)
""")
# a fake SHCI (Dice-style) binary: the port's FCI on the CPU behind the
# bridge's config.json / FCIDUMP in and result.json / 1rdm.csv / 2rdm.csv
# out
SHCI_FAKE = r"""
import json, sys
import numpy as np
sys.path.insert(0, %(repo)r)
import torch
from libdmet_preview_tpu_torch.models.integral import read_FCIDUMP
from libdmet_preview_tpu_torch.solvers import FCI
conf = json.load(open("config.json"))
Ham = read_FCIDUMP("FCIDUMP")
fci = FCI(restricted=True, tol=1e-12, device=torch.device("cpu"))
rdm1, E = fci.run(Ham, nelec=conf["n_up"] + conf["n_dn"])
json.dump({"energy_total": E}, open("result.json", "w"))
r = rdm1[0].numpy()
with open("1rdm.csv", "w") as f:
    f.write("i,j,val\n")
    for i in range(Ham.norb):
        for j in range(i + 1):
            f.write("%%d,%%d,%%.14g\n" %% (i, j, 2 * r[i, j]))
if conf["get_2rdm_csv"]:
    G = fci.make_rdm2(Ham)[0].numpy()
    with open("2rdm.csv", "w") as f:
        f.write("p,q,r,s,val\n")
        for idx in np.argwhere(np.abs(G) > 1e-14):
            f.write("%%d,%%d,%%d,%%d,%%.14g\n"
                    %% (tuple(idx) + (G[tuple(idx)],)))
"""

# a fake AFQMC binary: the port's FCI behind the bridge's model_param.dat /
# method_param.json, an AR(1) energy series around E (measurements.dat)
# and the FCI rdm1 as the mixed estimator (cicj.dat)
AFQMC_FAKE = r"""
import json, sys
import numpy as np
sys.path.insert(0, %(repo)r)
import torch
from libdmet_preview_tpu_torch.models.integral import Integral
from libdmet_preview_tpu_torch.solvers import FCI
from libdmet_preview_tpu_torch.solvers.external import read_afqmc_ham
H1, U, H0 = read_afqmc_ham("model_param.dat")
n = H1.shape[-1]
H2 = np.zeros((3, n, n, n, n))
for i in range(n):
    H2[:, i, i, i, i] = U[i]
opts = json.load(open("method_param.json"))
rdm1, E = FCI(restricted=False, tol=1e-12, device=torch.device("cpu")).run(
    Integral(n, False, False, H0, {"cd": H1}, {"ccdd": H2}),
    nelec=opts["nelec"])
rng = np.random.default_rng(opts["seed"] %% (2 ** 31))
x = np.zeros(4096)
for t in range(1, 4096):
    x[t] = 0.8 * x[t - 1] + rng.normal(0, 0.05)
with open("measurements.dat", "w") as f:
    for t in range(4096):
        f.write("%%d %%.12f %%.6f\n"
                %% (t, E + x[t], 1.0 + 0.1 * rng.random()))
with open("cicj.dat", "w") as f:
    for v in rdm1.numpy().ravel():
        f.write("%%.12f 0.0 1e-4\n" %% v)
"""


# ----------------------------------------------------------------------
# phase 13: KS-DFT and DFT-in-DMET on the H ring (ints.gto.h_ring_mole)
# ----------------------------------------------------------------------

# the ring: 2 atoms per cell, 3-21G, IAO + PAO against STO-6G (4 LOs per
# cell); H22 is held to the JAX package's values, H50 runs at full width
DFT_RING = {"r_bond": 1.8, "basis": "3-21g", "minimal_ref": "sto-6g",
            "atoms_per_cell": 2}
DFT_NATOM_JAX = 22
# the ring of chip_smoke.py's full-width DFT runs (phase 13): 34 atoms,
# nao 68, 587,520 grid points; it was 50 (nao 100, 864,000 points) until
# the oxide phase needed the script's time (a depth cut: the ring is
# longer, every cell the same)
DFT_NATOM_FULL = 34
DFT_XC = ("lsda", "pbe")
# the DFT-in-DMET loop of tests/test_dft.py:139-182: at most 20 MuSolver
# steps, stopped when the impurity's electrons per LO are within 1e-6
DFT_DMET = {"max_iter": 20, "nelec_tol": 1e-6}
# the JAX package's values on the H22 ring at its default grid (60 x 12 x
# 24 points per atom), from
#     JAX_PLATFORMS=cpu python scripts/dft_reference_jax.py
# on the CPU: the RKS energy, SCF iterations and the grid's electron count
# sum_g w_g rho(r_g) for each functional, and the DFT-in-DMET loop's
# impurity energy per cell, electrons per LO, impurity rdm1 (spin-traced /
# 2, as transformResults gives it) and MuSolver steps
DFT_JAX = {
    'lsda': {
        'E_ks': -12.224815707758076,
        'ks_cycles': 7,
        'n_grid': 21.99999917566877,
        'E': -1.0907773199327635,
        'nelecImp': 0.500000004400965,
        'rhoImp': [[[ 4.9930678699882491e-01,  3.0346765523893293e-01,
               -1.4130779360859141e-03, -3.6001384773072954e-03],
              [ 3.0346765523893293e-01,  4.9930676392709172e-01,
               -3.6001315694133111e-03, -1.4130583986690583e-03],
              [-1.4130779360859141e-03, -3.6001315694133111e-03,
                6.9322884815941103e-04,  4.4488503637530002e-04],
              [-3.6001384773072954e-03, -1.4130583986690583e-03,
                4.4488503637530002e-04,  6.9322902785403837e-04]]],
        'steps': 1,
        'neo': 6,
    },
    'pbe': {
        'E_ks': -12.450596081065882,
        'ks_cycles': 7,
        'n_grid': 21.999999402776552,
        'E': -1.089581753813651,
        'nelecImp': 0.5000000210593805,
        'rhoImp': [[[ 4.9930649780956254e-01,  3.0320176837337709e-01,
               -1.3296951025810267e-03, -3.5362834101665508e-03],
              [ 3.0320176837337709e-01,  4.9930650328806558e-01,
               -3.5362760112333910e-03, -1.3296692881159273e-03],
              [-1.3296951025810267e-03, -3.5362760112333910e-03,
                6.9352034551497718e-04,  4.4428837535378179e-04],
              [-3.5362834101665508e-03, -1.3296692881159273e-03,
                4.4428837535378179e-04,  6.9352067561772885e-04]]],
        'steps': 1,
        'neo': 6,
    },
}

def dft_ring_mole(natom):
    """The DFT_RING ring of `natom` H atoms (a port Mole)."""
    from libdmet_preview_tpu_torch.ints.gto import h_ring_mole
    return h_ring_mole(natom, DFT_RING["r_bond"], DFT_RING["basis"])


def dft_lattice(mol, device):
    """make_h_ring_lattice of the ring, IAO + PAO against STO-6G."""
    from libdmet_preview_tpu_torch.models.abinitio import make_h_ring_lattice
    return make_h_ring_lattice(
        mol, localization="iao", device=device,
        ncells=len(mol.atoms) // DFT_RING["atoms_per_cell"],
        minimal_ref=DFT_RING["minimal_ref"])


def grid_electrons(ks):
    """sum_g w_g rho(r_g) of a converged RKS's density."""
    ao = ks.ao_g
    return float(ks.grid[1] @ (ao * (ks.dm @ ao)).sum(dim=0))


def integral_to(ImpHam, device):
    """A copy of an embedding Integral with its tensors on `device`."""
    from libdmet_preview_tpu_torch.models.integral import Integral

    def mv(x):
        return x if x is None else torch.as_tensor(x).to(device).clone()
    return Integral(ImpHam.norb, ImpHam.restricted, ImpHam.bogoliubov,
                    ImpHam.H0, {k: mv(v) for k, v in ImpHam.H1.items()},
                    {k: mv(v) for k, v in ImpHam.H2.items()},
                    ovlp=mv(ImpHam.ovlp))


def dft_dmet_step(Lat, filling, ImpHam, basis, H1e, solver, solver_args,
                  mu_solver, last_dmu):
    """One MuSolver step of the DFT-in-DMET loop and its transformResults.
    Returns (ImpHam, last_dmu, rhoImp, EnergyImp, nelecImp)."""
    import libdmet_preview_tpu_torch.dmet.hubbard as dmet
    from libdmet_preview_tpu_torch.utils.timer import stage
    with stage("impurity solves", basis.device):
        rhoEmb, E_emb, ImpHam, dmu = mu_solver(
            Lat, filling, ImpHam, basis, solver, solver_args)
    last_dmu += dmu
    with stage("energy", basis.device):
        rhoImp, EnergyImp, nelecImp = dmet.transformResults(
            rhoEmb, E_emb, basis, ImpHam, H1e, lattice=Lat,
            last_dmu=last_dmu, int_bath=True, solver=solver,
            solver_args=solver_args)
    return ImpHam, last_dmu, rhoImp, float(EnergyImp), float(nelecImp)


def run_dft_dmet(Lat, meta, solver, proto=DFT_DMET):
    """The DFT-in-DMET loop of tests/test_dft.py:139-182 on a lattice that
    attach_ks made a KS lattice: RHartreeFock with a zero vcor ->
    ConstructImpHam(int_bath=True) (the xc double counting in _emb_H1) ->
    MuSolver -> transformResults, until the impurity's electrons per LO
    are within proto["nelec_tol"] of the filling.  Returns a dict: E (per
    cell), nelecImp, rhoImp (host), steps, and "last", the state the last
    MuSolver step started from (enough to replay it with dft_dmet_step)."""
    import libdmet_preview_tpu_torch.dmet.hubbard as dmet
    from libdmet_preview_tpu_torch.utils.timer import stage
    nlo = meta["nlo"]
    mol = meta["mole"]
    dev = Lat.device
    vcor = dmet.VcorLocal(True, False, nlo)
    vcor.update(np.zeros(vcor.length()))
    filling = mol.nelectron / (2.0 * mol.nao)
    with stage("mean field", dev):
        rho, _ = dmet.RHartreeFock(Lat, vcor, filling, None)
    ImpHam, H1e, basis = dmet.ConstructImpHam(Lat, rho, vcor, matching=False,
                                              int_bath=True)
    solver_args = {"nelec": (Lat.ncore + Lat.nval) * 2}
    mu_solver = dmet.MuSolver(adaptive=True)
    last_dmu = 0.0
    for it in range(proto["max_iter"]):
        last = {"ImpHam": integral_to(ImpHam, dev), "last_dmu": last_dmu,
                "history": copy.deepcopy(mu_solver.history)}
        ImpHam, last_dmu, rhoImp, E, nelecImp = dft_dmet_step(
            Lat, filling, ImpHam, basis, H1e, solver, solver_args,
            mu_solver, last_dmu)
        if abs(nelecImp - 2 * filling) < proto["nelec_tol"]:
            break
    last.update({"basis": basis, "H1e": H1e, "filling": filling,
                 "solver_args": solver_args})
    return {"E": E * nlo, "nelecImp": nelecImp, "rhoImp": to_host(rhoImp),
            "steps": it + 1, "neo": int(basis.shape[-1]), "last": last}


def replay_dft_dmet_step(Lat, res, solver, device):
    """The last MuSolver step of run_dft_dmet again on `device`, from the
    state it started from (the embedding Hamiltonian, basis and H1e, the
    MuSolver history; the lattice's JK_core moved to `device`).  Returns
    (E per cell, nelecImp, rhoImp)."""
    import libdmet_preview_tpu_torch.dmet.hubbard as dmet
    st = res["last"]
    Lc = copy.copy(Lat)
    Lc.JK_core = torch.as_tensor(Lat.JK_core).to(device)
    mu_solver = dmet.MuSolver(adaptive=True)
    mu_solver.history = copy.deepcopy(st["history"])
    H1e = st["H1e"]
    if isinstance(H1e, torch.Tensor):
        H1e = H1e.to(device)
    _, _, rhoImp, E, nelecImp = dft_dmet_step(
        Lc, st["filling"], integral_to(st["ImpHam"], device),
        st["basis"].to(device), H1e, solver, st["solver_args"], mu_solver,
        st["last_dmu"])
    return E * Lat.nscsites, nelecImp, to_host(rhoImp)


# ----------------------------------------------------------------------
# the periodic cell's oracles (chip_smoke.py phase 14a,
# tests/test_torch_{pbc,gth,basisopt}.py)
# ----------------------------------------------------------------------

H2_CRYSTAL_BASIS = {("H", "tight"): [(0, [(1.3, 1.0), (0.5, 0.4)])]}


def h2_crystal_geometry(kmesh, L=4.0):
    """tests/test_pbc_3d.py's H2 crystal: one H2 (1.4 bohr, along z) per
    cubic L-bohr cell on a kmesh of cells, cell-major.  Returns (atoms,
    supercell lattice vectors, cell translations), in bohr; the basis is
    H2_CRYSTAL_BASIS ("tight")."""
    t_vecs, atoms = [], []
    for cx in range(kmesh[0]):
        for cy in range(kmesh[1]):
            for cz in range(kmesh[2]):
                T = np.array([cx * L, cy * L, cz * L])
                t_vecs.append(T)
                for xyz in ((0.0, 0.0, 0.0), (0.0, 0.0, 1.4)):
                    atoms.append(("H", np.asarray(xyz) + T))
    return atoms, np.diag(np.array(kmesh, float) * L), np.asarray(t_vecs)


def gth_quadrature_errors():
    """tests/test_gth.py's quadrature oracles on the port's ints/gth.py:
    the C1 Gaussian and complex-step C2 r^2 terms of GTH-PADE carbon, and
    s (two radial projectors), p and d nonlocal channels built from
    independent Y_lm formulas, for s and p_x bra shells, on a 90^3 grid
    of a 7-bohr box.  Returns the largest error of each (local,
    nonlocal)."""
    from scipy.special import gamma
    from libdmet_preview_tpu_torch.ints.gth import (GTH_PADE, _h_full,
                                                    gauss_block,
                                                    gth_nl_block)
    from libdmet_preview_tpu_torch.ints.md import Shell, norm_cart
    A, B = np.array([0.2, -0.1, 0.3]), np.array([-0.4, 0.5, 0.1])
    C0 = np.array([0.1, 0.2, -0.2])
    n, L = 90, 7.0
    x = (np.arange(n) + 0.5) / n * L - L / 2
    pts = np.stack(np.meshgrid(x, x, x, indexing="ij"), -1).reshape(-1, 3)
    w = (L / n) ** 3

    def chi(ctr, e, l):
        d = pts - ctr
        g = np.exp(-e * (d ** 2).sum(-1))
        return norm_cart(e, (l, 0, 0)) * (d[:, 0] if l else 1.0) * g

    def ylm(l, m, d):
        """r^l Y_lm from hand-coded formulas (not gth.SOLID_HARM)."""
        x_, y_, z_ = d[:, 0], d[:, 1], d[:, 2]
        if l == 0:
            return np.full(len(d), 0.5 / np.sqrt(np.pi))
        if l == 1:
            return np.sqrt(3.0 / (4 * np.pi)) * (x_, y_, z_)[m]
        c = np.sqrt(15.0 / (4 * np.pi))
        return (c * x_ * y_, c * y_ * z_, np.sqrt(5.0 / (16 * np.pi))
                * (2 * z_ * z_ - x_ * x_ - y_ * y_), c * x_ * z_,
                0.5 * c * (x_ * x_ - y_ * y_))[m]

    def proj(l, m, i, rl):
        d = pts - C0
        r2 = (d ** 2).sum(-1)
        nrm = np.sqrt(2.0) / (rl ** (l + 2 * i - 0.5)
                              * np.sqrt(gamma(l + 2 * i - 0.5)))
        return nrm * r2 ** (i - 1) * ylm(l, m, d) \
            * np.exp(-r2 / (2 * rl * rl))

    rloc = GTH_PADE["C"]["rloc"]
    beta = 1 / (2 * rloc ** 2)
    rC2 = ((pts - C0) ** 2).sum(-1)
    gsm = np.exp(-beta * rC2)
    h = 1e-200
    pp = {"zion": 6.0, "rloc": 0.3, "cloc": [],
          "nl": [(0, 0.35, _h_full(0, [8.0, 2.5])),
                 (1, 0.42, _h_full(1, [3.0])),
                 (2, 0.38, _h_full(2, [-5.0]))]}
    err_loc = err_nl = 0.0
    for l in (0, 1):
        s1, s2 = Shell(A, l, [(0.9, 1.0)]), Shell(B, 0, [(0.6, 1.0)])
        chi_a, chi_b = chi(A, 0.9, l), chi(B, 0.6, 0)
        g = gauss_block(s1, s2, beta + 1j * h, C0)
        err_loc = max(err_loc,
                      abs(g.real[0, 0] - w * np.sum(chi_a * chi_b * gsm)),
                      abs(-(g.imag / h)[0, 0] / rloc ** 2
                          - w * np.sum(chi_a * chi_b * rC2 / rloc ** 2
                                       * gsm)))
        ref = 0.0
        for lch, rl, hm in pp["nl"]:
            nr = np.atleast_2d(hm).shape[0]
            for m in range(2 * lch + 1):
                pa = [w * np.sum(chi_a * proj(lch, m, i + 1, rl))
                      for i in range(nr)]
                pb = [w * np.sum(chi_b * proj(lch, m, i + 1, rl))
                      for i in range(nr)]
                ref += np.asarray(pa) @ np.atleast_2d(hm) @ np.asarray(pb)
        err_nl = max(err_nl, abs(gth_nl_block(s1, s2, pp, C0)[0, 0] - ref))
    return err_loc, err_nl


def gth_rhf(atoms, basis_data, nelec):
    """Closed-shell GTH-PADE RHF of a molecule on the port's MoleGeneral
    integrals (host NumPy; tests/test_basisopt_dzvp.py's oracle engine):
    symmetric orthogonalization, 0.7 / 0.3 density damping from the third
    iteration, |dE| < 1e-10.  Returns (E, S)."""
    from libdmet_preview_tpu_torch.ints.gth import gth_pp_molecular
    from libdmet_preview_tpu_torch.ints.md import MoleGeneral
    name = next(iter(basis_data))[1]
    mol = MoleGeneral(atoms, basis=name, basis_data=basis_data)
    S, eri = mol.intor_ovlp(), mol.intor_eri()
    V, zions = gth_pp_molecular(mol)
    hcore = mol.intor_kin() + V
    R = np.asarray(mol.coords)
    e_nuc = sum(zions[i] * zions[j] / np.linalg.norm(R[i] - R[j])
                for i in range(len(atoms)) for j in range(i))
    s_val, s_vec = np.linalg.eigh(S)
    X = s_vec[:, s_val > 1e-9] / np.sqrt(s_val[s_val > 1e-9])
    dm, e_old = np.zeros_like(S), np.inf
    for it in range(200):
        F = hcore + np.einsum("pqrs, rs -> pq", eri, dm) \
            - 0.5 * np.einsum("prqs, rs -> pq", eri, dm)
        C = X @ np.linalg.eigh(X.T @ F @ X)[1]
        dm_new = 2.0 * C[:, :nelec // 2] @ C[:, :nelec // 2].T
        dm = dm_new if it < 2 else 0.7 * dm_new + 0.3 * dm
        E = 0.5 * np.einsum("pq, pq ->", hcore + F, dm) + e_nuc
        if abs(E - e_old) < 1e-10 and it > 4:
            break
        e_old = E
    return E, S


# ----------------------------------------------------------------------
# diamond, the north-star solid (BASELINE.json configs[3]: GTH-SZV +
# GTH-PADE, 8 orbitals per cell): tests/test_diamond.py's nk-cell chain on
# the Cholesky format (make_diamond_lattice) and tests/test_diamond333.py's
# 3D k-mesh on the 'aft' format with the range-separated driver
# (make_diamond_lattice3)
# ----------------------------------------------------------------------

# tests/test_diamond333.py:13-19 (JAX package, CPU): (value, bound)
DIAMOND333_ANCHORS = {"E_hf": (-10.0930031640, 1e-6),
                      "one-shot": (-10.2082668828, 1e-5),
                      "loop": (-10.2122587074, 5e-4)}
# tests/test_diamond333.py:39-93: CCSD solver, FitVcor(MaxIter1=300,
# MaxIter2=0), DIIS from iteration 2, stop at dE < 1e-5 and dV < 5e-4
DIAMOND_PROTOCOL = {"max_iter": 8, "diis_from": 2, "diis_space": 8,
                    "fit_iter": 300, "e_tol": 1e-5, "v_tol": 5e-4,
                    "cc_tol": 1e-8}
# the factories' arguments of the CPU tests: the cheapest that still run
# every step (the precision sets the image sums and the meshes)
DIAMOND_TIER1 = {"chain": {"nk": 2, "precision": 1e-4},
                 "mesh": {"kmesh": (1, 1, 2), "precision": 1e-4}}
# the JAX package's values (scripts/diamond_reference_jax.py): per cell
# the supercell RHF, the lattice mean field, the IB-HF identity and the
# one-shot DMET(CCSD) energies, the one-shot impurity electron count;
# "loop" the first iterations of DIAMOND_PROTOCOL
DIAMOND_JAX = {
    "tier1_chain": {"E_hf": -8.649672094899946, "E_mf": -8.649672096666809,
                    "nelec_emb": 10, "E_ibhf": -8.649672126687545,
                    "E_cc": -8.79340763794487, "n_cc": 1.0002551523268188},
    "tier1_mesh": {"E_hf": -8.649672094899952, "E_mf": -8.64967209490424,
                   "nelec_emb": 10, "E_ibhf": -8.649672094916717,
                   "E_cc": -8.787734815046749, "n_cc": 1.0002437499910162,
                   "loop": [-8.787734815046749, -8.790400954077548,
                            -8.790466656527492, -8.790466656527492],
                   "loop_n": 1.0000627024521584, "loop_converged": True},
    "chain_nk2": {"E_hf": -8.652102756934324, "E_mf": -8.65210276281371,
                  "nelec_emb": 10, "E_ibhf": -8.652102761183736,
                  "E_cc": -8.796746550523967, "n_cc": 1.0003158715599585},
    "mesh221_hf": {"E_hf": -9.266291679278272},
}
# make_diamond_lattice3 at precision 1e-12 on the card (chip_smoke.py
# phase 15c; NVIDIA H100 80GB HBM3, 700 W): E_hf and the one-shot CCSD per
# cell, the converged loop.  3 x 3 x 3: E_hf and the one-shot lie 2.96e-4
# and 7.53e-4 below DIAMOND333_ANCHORS, which were recorded before the JAX
# package switched its builders to the range-separated ERIs; the loop lies
# 4.4e-4 below its anchor (bound 5e-4)
DIAMOND_RECORDED = {
    (2, 2, 2): {"E_hf": -9.5705123235, "E_cc": -9.6851751066,
                "loop": -9.6881993002},
    (3, 3, 3): {"E_hf": -10.0932991696, "E_cc": -10.2090201079,
                "loop": -10.2126999208},
}
DIAMOND_E_HF_TOL = 1e-10     # E_hf against DIAMOND_JAX (CPU tests)
DIAMOND_SCF_TOL = 5e-8       # what follows the SCF density (both SCFs stop
                             # at ||[F, D]|| < 1e-6)


def diamond_lattice(kind, device, **kwargs):
    """make_diamond_lattice ("chain", tests/test_diamond.py) or
    make_diamond_lattice3 ("mesh", tests/test_diamond333.py) on
    `device`; kwargs go to the factory."""
    from libdmet_preview_tpu_torch.models import abinitio
    if kind == "chain":
        return abinitio.make_diamond_lattice(device=device, **kwargs)
    return abinitio.make_diamond_lattice3(device=device, **kwargs)


def _diamond_nelec(Lat, basis):
    from libdmet_preview_tpu_torch.ops import embham
    rho_mf = to_host(embham.foldRho_k(Lat.rdm1_lo_k, Lat.R2k_basis(basis)))
    nel = int(round(np.trace(rho_mf[0])))
    return nel + nel % 2


def diamond_one_shot(Lat, meta, device, cc=True):
    """tests/test_diamond.py / test_diamond333.py:49-67 at vcor = 0: the
    lattice mean field, ConstructImpHam(int_bath=True), the HF impurity
    solver (the IB-HF identity) and, with cc, CCSD -> transformResults.
    Energies per cell."""
    import libdmet_preview_tpu_torch.dmet.hubbard as dmet
    from libdmet_preview_tpu_torch.ops.vcor import VcorLocal
    from libdmet_preview_tpu_torch.solvers import CCSD, SCFSolver
    nsc = Lat.nscsites
    vcor = VcorLocal(True, False, nsc)
    vcor.assign(np.zeros((2, nsc, nsc)))
    rho, _, res = dmet.RHartreeFock(Lat, vcor, 0.5, None, ires=True)
    ImpHam, H1e, basis = dmet.ConstructImpHam(Lat, rho, vcor, matching=False,
                                              int_bath=True)
    nel = _diamond_nelec(Lat, basis)
    out = {"E_hf": meta["E_hf"] / Lat.ncells, "E_mf": float(res["E"]),
           "nelec_emb": nel, "ImpHam": ImpHam, "basis": basis}
    hf = SCFSolver(restricted=True, device=device)
    rhoEmb, EEmb = hf.run(ImpHam, nelec=nel)
    _, E, _ = dmet.transformResults(rhoEmb, EEmb, basis, ImpHam, H1e,
                                    lattice=Lat, last_dmu=0.0, int_bath=True,
                                    solver=hf, solver_args={"nelec": nel})
    out["E_ibhf"] = float(E) * nsc
    if cc:
        solver = CCSD(restricted=True, tol=DIAMOND_PROTOCOL["cc_tol"],
                      device=device)
        rhoEmb, EEmb = solver.run(ImpHam, nelec=nel)
        _, E, n = dmet.transformResults(
            rhoEmb, EEmb, basis, ImpHam, H1e, lattice=Lat, last_dmu=0.0,
            int_bath=True, solver=solver, solver_args={"nelec": nel})
        out["E_cc"] = float(E) * nsc
        out["n_cc"] = float(n)
    return out


def run_diamond_dmet(Lat, device, proto=DIAMOND_PROTOCOL, max_iter=None):
    """tests/test_diamond333.py:69-93: vcor self-consistency with CCSD
    (no charge self-consistency), each step a utils.timer stage ("mean
    field", "impurity solve", "energy", "vcor fit"; ConstructImpHam adds
    "bath" and "H2").  Returns (E_cell, n_imp, converged, records)."""
    import libdmet_preview_tpu_torch.dmet.hubbard as dmet
    from libdmet_preview_tpu_torch.ops.diis import DIIS
    from libdmet_preview_tpu_torch.ops.vcor import VcorLocal
    from libdmet_preview_tpu_torch.solvers import CCSD
    from libdmet_preview_tpu_torch.utils.timer import stage
    nsc = Lat.nscsites
    vcor = VcorLocal(True, False, nsc)
    vcor.assign(np.zeros((2, nsc, nsc)))
    solver = CCSD(restricted=True, tol=proto["cc_tol"], device=device)
    adiis = DIIS(space=proto["diis_space"])
    E_old, E, n, conv, records = None, None, None, False, []
    for it in range(proto["max_iter"] if max_iter is None else max_iter):
        with stage("mean field", device):
            rho, _, _ = dmet.RHartreeFock(Lat, vcor, 0.5, None, ires=True)
        ImpHam, H1e, basis = dmet.ConstructImpHam(Lat, rho, vcor,
                                                  matching=False,
                                                  int_bath=True)
        nel = _diamond_nelec(Lat, basis)
        with stage("impurity solve", device):
            rhoEmb, EEmb = solver.run(ImpHam, nelec=nel)
        with stage("energy", device):
            _, E, n = dmet.transformResults(
                rhoEmb, EEmb, basis, ImpHam, H1e, lattice=Lat, last_dmu=0.0,
                int_bath=True, solver=solver, solver_args={"nelec": nel})
        with stage("vcor fit", device):
            vcor_new, err = dmet.FitVcor(rhoEmb, Lat, basis, vcor, np.inf,
                                         0.5, MaxIter1=proto["fit_iter"],
                                         MaxIter2=0)
        p_new = np.hstack(vcor_new.param)
        dV = float(np.max(np.abs(p_new - np.hstack(vcor.param))))
        dE = abs(float(E) * nsc - E_old) if E_old is not None else np.inf
        vcor.update(np.asarray(adiis.update(p_new)
                               if it >= proto["diis_from"] else p_new))
        E_old = float(E) * nsc
        records.append({"iter": it, "E": E_old, "n": float(n), "dE": dE,
                        "dV": dV, "fit_err": float(err)})
        if dE < proto["e_tol"] and dV < proto["v_tol"]:
            conv = True
            break
    return float(E) * nsc, float(n), conv, records


# the cells of tests/test_pbc_3d.py's driver oracles besides the H2
# crystal: the GTH H2 cell (its GTH-optimised valence basis) and a
# two-cell s + p stripe
GTH_H2_CELL = {"atoms": [("H", (0.0, 0.0, 0.0)), ("H", (1.6, 0.0, 0.0))],
               "a": np.eye(3) * 3.2, "basis": "tpu-szv", "unit": "B",
               "pseudo": "gth-pade", "precision": 1e-8}
SP_CELL_BASIS = {("H", "sp"): [(0, [(0.9, 1.0)]), (1, [(0.6, 1.0)])]}


def gth_h2_cell(pbc_module, **kwargs):
    """GTH_H2_CELL built by `pbc_module` (either package's ints.pbc)."""
    from libdmet_preview_tpu_torch.ints.basisopt import make_gth_valence_basis
    bd = {("H", "tpu-szv"): make_gth_valence_basis("H")}
    return pbc_module.PbcCell(basis_data=bd, **GTH_H2_CELL, **kwargs)


def sp_stripe_cell(pbc_module, **kwargs):
    """Two cells of two H with an s + p basis along x, built by
    `pbc_module`."""
    L = 5.0
    atoms, tvs = [], []
    for cx in range(2):
        T = np.array([cx * L, 0.0, 0.0])
        tvs.append(T)
        atoms += [("H", T), ("H", T + np.array([0.0, 0.0, 1.4]))]
    cell = pbc_module.PbcCell(atoms, np.diag([2 * L, L, L]), basis="sp",
                              basis_data=SP_CELL_BASIS, precision=1e-9,
                              **kwargs)
    return cell.set_translations(2, np.asarray(tvs))


def h2_crystal_cell(pbc_module, kmesh=(2, 2, 1), translations=True,
                    precision=1e-10, **kwargs):
    """The H2 crystal (h2_crystal_geometry) built by `pbc_module`."""
    atoms, a, t_vecs = h2_crystal_geometry(kmesh)
    cell = pbc_module.PbcCell(atoms, a, basis="tight",
                              basis_data=H2_CRYSTAL_BASIS,
                              precision=precision, **kwargs)
    if translations:
        cell.set_translations(int(np.prod(kmesh)), t_vecs)
    return cell


def emb_driver_oracles(device):
    """tests/test_pbc_3d.py:111-219 on the port's drivers on `device`:
    aft (and its cross form) against the dense-ERI transform, FFT-DF on
    twice the mesh against aft and the grid overlap on the GTH H2 cell, rs
    against aft at omega = 1.0 with its cross form, rs with p shells.
    Returns ({name: tensor} for a card-vs-CPU comparison, {check: (value,
    bound, ok)})."""
    from libdmet_preview_tpu_torch.ints import pbc
    from libdmet_preview_tpu_torch.models.abinitio import _rot4
    vals, checks = {}, {}

    def check(name, v, bound):
        checks[name] = (float(v), bound, bool(float(v) < bound))

    cs = h2_crystal_cell(pbc, device=device)
    cd = h2_crystal_cell(pbc, translations=False, device=device)
    rng = np.random.default_rng(3)
    Ca = torch.as_tensor(rng.normal(size=(cs.nao, 3)), device=device)
    Cb = torch.as_tensor(rng.normal(size=(cs.nao, 2)), device=device)
    dense = cd.intor_eri()
    vals["aft"] = cs.get_emb_eri_aft(Ca)
    vals["aft_cross"] = cs.get_emb_eri_aft_cross(Ca, Cb)
    check("aft vs the dense transform", (vals["aft"] - _rot4(
        dense, Ca, Ca, Ca, Ca)).abs().max(), 1e-8)
    check("aft cross vs the dense transform", (vals["aft_cross"] - _rot4(
        dense, Ca, Ca, Cb, Cb)).abs().max(), 1e-8)
    vals["rs"] = cs.get_emb_eri_rs(Ca, omega=1.0)
    vals["rs_cross"] = cs.get_emb_eri_rs_cross(Ca, Cb, omega=1.0)
    check("rs vs aft (omega 1.0)", (vals["rs"] - vals["aft"]).abs().max(),
          5e-7)
    check("rs cross vs aft cross (omega 1.0)",
          (vals["rs_cross"] - vals["aft_cross"]).abs().max(), 5e-7)

    gc = gth_h2_cell(pbc, device=device)
    C = torch.as_tensor(np.random.default_rng(0).normal(size=(gc.nao, 2)),
                        device=device)
    mesh2 = tuple(2 * n + 1 for n in gc.mesh)
    vals["gth_aft"] = gc.get_emb_eri_aft(C)
    vals["gth_fft"] = gc.get_emb_eri_fft(C, mesh=mesh2)
    check("FFT-DF (twice the mesh) vs aft",
          (vals["gth_fft"] - vals["gth_aft"]).abs().max(), 2e-4)
    pts = gc.grid_coords(mesh2)
    ao = gc.eval_ao_pbc(pts)
    vals["S_grid"] = ao.T @ ao * (gc.vol / len(pts))
    check("the grid overlap", (vals["S_grid"] - gc.intor_ovlp()).abs().max(),
          1e-5)

    sc = sp_stripe_cell(pbc, device=device)
    C = torch.as_tensor(np.random.default_rng(1).normal(size=(sc.nao, 3)),
                        device=device)
    vals["sp_aft"] = sc.get_emb_eri_aft(C)
    vals["sp_rs"] = sc.get_emb_eri_rs(C, omega=0.8)
    check("rs with p shells vs aft (relative)",
          (vals["sp_rs"] - vals["sp_aft"]).abs().max()
          / max(1.0, float(vals["sp_aft"].abs().max())), 5e-6)
    return vals, checks


def cell_on(cell, device):
    """A copy of a PbcCell whose G-space work runs on `device`, with the
    integrals the cell kept (the short-range rows, the pair-FT column)
    carried over: a second device can replay the drivers from the same
    inputs."""
    new = copy.copy(cell)
    new.device = torch.device(device)
    new._cache = {k: (v.to(device) if isinstance(v, torch.Tensor) else v)
                  for k, v in cell._cache.items()}
    if cell._ft_cache is not None:
        Gv, f, expand = cell._ft_cache
        new._ft_cache = (Gv, f.to(device), expand)
    return new


# ----------------------------------------------------------------------
# the AFM oxides (tests/test_nio_afm.py, tests/test_cuo2_afm.py):
# models/abinitio's make_nio_afm_lattice, make_nio_fm_lattice and
# make_cuo2_afm_lattice, and their interacting-bath UHF one-shot
# ----------------------------------------------------------------------

OXIDE_FACTORIES = {"nio_afm": "make_nio_afm_lattice",
                   "nio_fm": "make_nio_fm_lattice",
                   "cuo2_afm": "make_cuo2_afm_lattice"}
# the CPU tests' width: one cell at the cheapest precision that runs every
# step of the protocol (the JAX package's single-threaded short-range rows
# set the recorder's pace)
OXIDE_TIER1 = {"nk": 1, "precision": 1e-4}
# the JAX suite's RUN_SLOW anchors at nk = 2, precision 1e-10 (E_hf per
# cell, the staggered d moment).  NiO's was taken when its factory still
# used the bare G-mesh ERI (cell.intor_eri), before the JAX package
# switched its factories to the range-separated ERI: the port and the JAX
# package now agree where both run (the CPU tests), and the card holds
# NiO to OXIDE_RECORDED.  CuO2's was taken on the range-separated ERI.
OXIDE_ANCHORS = {"nio_afm": {"E_hf": -331.72488001, "mag": 1.43,
                             "bare_g_mesh_eri": True},
                 "cuo2_afm": {"E_hf": -150.39975274, "mag": 0.298,
                              "bare_g_mesh_eri": False}}
# what the card recorded at nk = 2, precision 1e-10 (chip_smoke.py phase
# 16, NVIDIA H100 80GB HBM3): per cell E_hf, the d moments, the IB-HF
# energy and, for NiO AFM, the MP2 one-shot
OXIDE_RECORDED = {
    "nio_afm": {"E_hf": -333.452357254431, "mag": [0.96787771, -0.96787761],
                "E_ibhf": -333.452357161375, "E_mp2": -333.506856720088},
    "nio_fm": {"E_hf": -333.455569780054, "mag": [0.99383832, 0.99383895],
               "E_ibhf": -333.455855265789},
    "cuo2_afm": {"E_hf": -150.399752736333,
                 "mag": [0.29837085, -0.29837085],
                 "E_ibhf": -150.399751854196},
}
OXIDE_RECORDED_TOL = {"E_hf": 1e-8, "mag": 1e-6, "E_ibhf": 1e-7,
                      "E_mp2": 1e-7}
# the JAX package at nk = 2, precision 1e-10 on the port's integrals: the
# card built them (scripts/oxide_ints_card.py, NVIDIA H100 80GB HBM3) and
# scripts/oxide_reference_jax.py --ints ran the JAX package's supercell
# UHF, _afm_oxide_tail and the protocol on them on the CPU.  Its NiO d
# moments are |m| = 0.968 (AFM) and 0.994 (FM): the JAX suite's |m| > 1.2
# (tests/test_nio_afm.py:50, :118) was set on the bare G-mesh ERI, as was
# its 1.43 anchor.  Phase 16 holds the card's E_hf and moments to these
# (the two UHFs stop at |dE| < 1e-9; their moments differ by ~2e-7) and
# |m| to OXIDE_MAG_FLOOR, these moments rounded down to 0.01
OXIDE_JAX_NK2 = {
    "nio_afm": {"E_hf": -333.4523572543182,
                "mag": [0.9678775928706234, -0.9678776898187733],
                "E_mf": -333.4523572629557, "nelec_emb": 60, "sz_emb": 0,
                "neo": 42, "nelec_ab": [48, 48],
                "E_ibhf": -333.45235725764087, "E_mp2": -333.506856831456},
    "nio_fm": {"E_hf": -333.4555697801837,
               "mag": [0.9938384737248089, 0.9938387570109928],
               "E_mf": -333.45556954679193, "nelec_emb": 56, "sz_emb": 4,
               "neo": 38, "nelec_ab": [52, 44],
               "E_ibhf": -333.45585672682597},
}
OXIDE_JAX_NK2_TOL = {"E_hf": 1e-9, "mag": 1e-6}
OXIDE_MAG_FLOOR = {"nio_afm": 0.96, "nio_fm": 0.99}
OXIDE_INTS_TOL = 1e-10        # the integral fingerprints, relative
# E_hf against OXIDE_JAX: the supercell UHF stops at |dE| < 1e-9 (JAX's
# _uhf_incore tol), so two implementations agree to that
OXIDE_E_HF_TOL = 1e-9
OXIDE_STEP_TOL = 1e-10        # one step on the same inputs, JAX live
# the JAX package's values (scripts/oxide_reference_jax.py) at OXIDE_TIER1:
# the fingerprints of the cell integrals (oxide_fingerprint), and per cell
# E_hf, the d moments, (n_alpha, n_beta), the lattice mean field, the
# embedding's electron count, S_z and size, the IB-HF energy and (NiO
# AFM) the MP2 one-shot.  At one cell the NiO UHFs stop on flat
# landscapes: the two packages' densities differ by ~1e-5 there (NiO FM
# does not converge in 300 cycles in either), so the CPU tests hold
# the integrals, E_hf, the counts, and the steps after the integrals on
# the same inputs (JAX live), not these density-following values
OXIDE_JAX = {
    "nio_afm": {
        "ints": {"e_nuc": -239.32675665128806,
                 "S": [53.72357995271954, 6.294146245152854,
                        2.5358992289358513],
                 "hcore": [-214.45440060191544, 30.477708583276748,
                        -26.210991207658907],
                 "eri": [395.4042654548444, 12.225605196515113,
                        5.188601906125113]},
        "E_hf": -331.4453142533559,
        "mag": [1.196616971684736, -1.1966131415747165],
        "E_mf": -331.44580858598044,
        "nelec_emb": 48,
        "sz_emb": 0,
        "neo": 30,
        "nelec_ab": [24, 24],
        "E_ibhf": -331.4453091919954,
        "E_mp2": -318.38023764235874,
    },
    "nio_fm": {
        "ints": {"e_nuc": -239.32675665128806,
                 "S": [53.72357995271954, 6.294146245152854,
                        2.5358992289358513],
                 "hcore": [-214.45440060191544, 30.477708583276748,
                        -26.210991207658907],
                 "eri": [395.4042654548444, 12.225605196515113,
                        5.188601906125113]},
        "E_hf": -331.74653942239377,
        "mag": [0.9879123701111228, 1.01973948123387],
        "E_mf": -331.74657636080894,
        "nelec_emb": 48,
        "sz_emb": 4,
        "neo": 30,
        "nelec_ab": [26, 22],
        "E_ibhf": -331.82787343429294,
    },
    "cuo2_afm": {
        "ints": {"e_nuc": -0.6133471516976599,
                 "S": [32.17959481976027, 5.662348457754607,
                        6.721812835126064],
                 "hcore": [-171.45373119861426, 31.054196011701492,
                        -35.41907686116649],
                 "eri": [178.51936206713103, 7.385481931302882,
                        -8.96444635686078]},
        "E_hf": -149.0279313894041,
        "mag": [6.723556174037526e-07, -6.334381561501345e-07],
        "E_mf": -149.02793116448646,
        "nelec_emb": 50,
        "sz_emb": 0,
        "neo": 30,
        "E_ibhf": -149.02793138835753,
    },
}


def oxide_cache_name(kind, nk, precision):
    """The cache file name a factory of OXIDE_FACTORIES keys its integrals
    by at its default geometry and basis (the JAX package's key)."""
    stem, a = ("cuo2", 3.80) if kind == "cuo2_afm" else ("nio", 4.17)
    return "%s_rs1_%d_%s_solid_%.0e.npz" % (stem, nk, a, precision)


def oxide_fingerprint(cache_npz):
    """Three numbers per cell integral of an oxide cache file (S, hcore,
    eri: the sum, the Frobenius norm, the sum weighted by a fixed
    pseudo-random array) and e_nuc."""
    dat = np.load(cache_npz)
    out = {"e_nuc": float(dat["e_nuc"])}
    for name in ("S", "hcore", "eri"):
        x = np.asarray(dat[name], dtype=float)
        w = np.random.RandomState(7).randn(*x.shape)
        out[name] = [float(x.sum()), float(np.linalg.norm(x)),
                     float((w * x).sum())]
    return out


def oxide_lattice(kind, device, **kwargs):
    """The factory of OXIDE_FACTORIES[kind] on `device`."""
    from libdmet_preview_tpu_torch.models import abinitio
    return getattr(abinitio, OXIDE_FACTORIES[kind])(device=device, **kwargs)


def oxide_one_shot(Lat, meta, kind, device, mp2=None, solve=True):
    """tests/test_nio_afm.py:35-149 / tests/test_cuo2_afm.py:27-72 at vcor
    = 0: the lattice mean field (HartreeFock; the FM state at its
    spin-resolved filling), ConstructImpHam(matching=True, int_bath=True),
    SCFSolver(restricted=False, Sz=the embedding S_z) from the folded
    mean-field density -> transformResults (the IB-HF identity) and, with
    mp2 (default: NiO AFM), MP2(restricted=False) -> transformResults.
    Energies per cell; also the pieces (ImpHam, basis, H1e, rho_mf, and the
    lattice density rho and vcor ConstructImpHam took).  solve=False stops
    after ConstructImpHam (no impurity solver)."""
    import libdmet_preview_tpu_torch.dmet.hubbard as dmet
    from libdmet_preview_tpu_torch.ops import embham
    from libdmet_preview_tpu_torch.ops.vcor import VcorLocal
    from libdmet_preview_tpu_torch.solvers import MP2, SCFSolver
    from libdmet_preview_tpu_torch.utils.timer import stage
    nsc = Lat.nscsites
    nk = Lat.ncells
    na, nb = meta.get("nelec_ab", (None, None))
    if kind == "nio_fm":
        filling = (na / (nk * nsc), nb / (nk * nsc))
    else:
        filling = meta["cell"].nelectron / (2 * nk * nsc)
    vcor = VcorLocal(False, False, nsc)
    vcor.assign(np.zeros((2, nsc, nsc)))
    with stage("mean field", device):
        rho, _, res = dmet.HartreeFock(Lat, vcor, filling, None, ires=True)
    ImpHam, H1e, basis = dmet.ConstructImpHam(Lat, rho, vcor, matching=True,
                                              int_bath=True)
    basis_k = Lat.R2k_basis(basis)
    rho_mf = embham.foldRho_k(Lat.rdm1_lo_k, basis_k)
    tr = [float(torch.trace(torch.as_tensor(rho_mf[s]))) for s in range(2)]
    nel = int(round(tr[0] + tr[1]))
    sz = int(round(tr[0] - tr[1]))
    out = {"E_hf": meta["E_hf"] / nk, "mag": [float(m) for m in
                                              meta["mag_d"]],
           "E_mf": float(res["E"]), "nelec_emb": nel, "sz_emb": sz,
           "neo": int(basis.shape[-1]), "ImpHam": ImpHam, "basis": basis,
           "H1e": H1e, "rho_mf": rho_mf, "rho": rho, "vcor": vcor}
    if na is not None:
        out["nelec_ab"] = [int(na), int(nb)]
    if not solve:
        return out
    hf = SCFSolver(restricted=False, Sz=sz, device=device)
    with stage("impurity UHF", device):
        rhoEmb, EEmb = hf.run(ImpHam, nelec=nel, dm0=rho_mf, MaxIter=500)
    _, E, _ = dmet.transformResults(rhoEmb, EEmb, basis, ImpHam, H1e,
                                    lattice=Lat, last_dmu=0.0, int_bath=True,
                                    solver=hf, solver_args={"nelec": nel})
    out["E_ibhf"] = float(E) * nsc
    if mp2 if mp2 is not None else kind == "nio_afm":
        mp = MP2(restricted=False, Sz=sz, device=device)
        with stage("MP2", device):
            rhoMP, EMP = mp.run(ImpHam, nelec=nel, dm0=rho_mf)
        _, E, _ = dmet.transformResults(rhoMP, EMP, basis, ImpHam, H1e,
                                        lattice=Lat, last_dmu=0.0,
                                        int_bath=True, solver=mp,
                                        solver_args={"nelec": nel})
        out["E_mp2"] = float(E) * nsc
    return out


# ----------------------------------------------------------------------
# the ab initio one-shot workload of chip_smoke.py phase 6 (the width of
# the CuO2 AFM plane) and the GDF workload of phase 9c; phase 17's
# scale-out cases rebuild them on every rank from the same seeds
# ----------------------------------------------------------------------

# sqrt2 x sqrt2 AFM double cell in the JAX package's tpu-szv basis:
# 2 Cu x (4s + 6 d) + 4 O x (2s + 2p) = 30 LOs, 25 electrons per formula
# unit and two formula units per cell; a BvK chain of 8 cells
AI_NCELLS = 8
AI_NLO = 30
AI_NAUX = 2400              # ~10 x nsites: a pivoted-Cholesky rank
AI_FILLING = 50.0 / 60.0
AI_DELTA = 2.0              # staggered on-site field on the Cu d shells
AI_CU_S = [0, 7]            # 4s of Cu A, Cu B
AI_CU_A_UP = [1, 2, 3]      # d orbitals of Cu A raised for alpha
AI_CU_B_UP = [8, 9, 10]     # d orbitals of Cu B raised for beta
AI_O = list(range(14, 30))


def _tr_stripe(rng, ncells, n, scale):
    """Random time-reversal-symmetric stripe h[R] (h[-R] = h[R]^T),
    decaying with the cell distance."""
    h = np.zeros((ncells, n, n))
    for R in range(ncells // 2 + 1):
        d = min(R, ncells - R)
        blk = rng.randn(n, n) * scale / (1.0 + d) ** 2
        if R == 0 or 2 * R == ncells:
            blk = 0.5 * (blk + blk.T)
        h[R] = blk
        h[(-R) % ncells] = blk.T
    return h


def make_abinitio_workload(seed=5, ncells=AI_NCELLS, nlo=AI_NLO,
                           naux=AI_NAUX):
    """hcore/fock per-spin stripes (2, ncells, nlo, nlo), chol_L (naux,
    nsites, nsites) symmetric in (p, q) with ERI entries O(0.1-1), and
    the unit-cell ERI, all NumPy from `seed`.  The staggered +-Delta field
    on the Cu d shells, of opposite sign per spin, opens a gap at 25
    electrons per spin and cell."""
    rng = np.random.RandomState(seed)
    onsite = np.zeros(nlo)
    onsite[[i for i in AI_O if i < nlo]] = -1.0
    onsite[[i for i in AI_CU_S if i < nlo]] = 3.0
    stag = np.zeros(nlo)
    stag[[i for i in AI_CU_A_UP if i < nlo]] = AI_DELTA
    stag[[i for i in AI_CU_B_UP if i < nlo]] = -AI_DELTA
    hop = _tr_stripe(rng, ncells, nlo, 0.1)
    hcore = np.stack([hop, hop])
    hcore[0, 0] += np.diag(onsite + stag)
    hcore[1, 0] += np.diag(onsite - stag)
    fock = hcore + _tr_stripe(rng, ncells, nlo, 0.05)[None]
    nsites = ncells * nlo
    L = np.empty((naux, nsites, nsites))
    for x0 in range(0, naux, 200):
        blk = rng.randn(min(200, naux - x0), nsites, nsites)
        L[x0:x0 + len(blk)] = 0.01 * (blk + blk.transpose(0, 2, 1))
    L0 = L[:, :nlo, :nlo].reshape(naux, nlo * nlo)
    eri_imp = (L0.T @ L0).reshape((nlo,) * 4)
    return hcore, fock, L, eri_imp



GDF = {"ncells": AI_NCELLS, "nlo": AI_NLO, "nfac": 300, "neo": 2 * AI_NLO,
       "dense": {"ncells": 6, "nlo": 4, "nfac": 5}}

def make_gdf_workload(device, seed=13, ncells=GDF["ncells"], nlo=GDF["nlo"],
                      nfac=GDF["nfac"]):
    """A translation-invariant ERI in factorized form, with no dense
    tensor: nfac random symmetric real-space factors l_x (nsites, nsites)
    that decay with the cell distance, NumPy from `seed`, and all ncells
    translations of each.  Returns (L, factors): the Cholesky vectors L
    (nfac * ncells, nsites, nsites) and the k-resolved factors {q: (F_re,
    F_im)} that follow analytically, F_q[k, p, a, x] = lt_x[k p, (k + q) a]
    / sqrt(ncells) with lt_x the double Fourier transform of l_x
    (make_gdf_factors' convention), tensors on `device`.  The gamma-like
    block F_0[0] is made exactly real-symmetric."""
    from libdmet_preview_tpu_torch.ops.eri_transform import _dft_phase
    rng = np.random.RandomState(seed)
    nsites = ncells * nlo
    dist = np.abs(np.arange(ncells)[:, None] - np.arange(ncells)[None, :])
    decay = 1.0 / (1.0 + np.minimum(dist, ncells - dist)) ** 2
    l = rng.randn(nfac, nsites, nsites)
    l = (0.01 * (l + l.transpose(0, 2, 1))).reshape(nfac, ncells, nlo,
                                                    ncells, nlo)
    l5 = torch.as_tensor(l * decay[None, :, None, :, None], device=device)
    L = torch.cat([torch.roll(l5, (R, R), dims=(1, 3))
                   for R in range(ncells)]).reshape(-1, nsites, nsites)
    P = _dft_phase(ncells, device)
    lt = torch.einsum("kA, xApBq -> xkpBq", P, l5.to(torch.complex128))
    lt = torch.einsum("lB, xkpBq -> xkplq", P.conj(), lt)
    k = torch.arange(ncells, device=device)
    factors = {}
    for q in range(ncells):
        F = lt[:, k, :, (k + q) % ncells, :]           # (k, x, p, a)
        F = F.permute(0, 2, 3, 1) / np.sqrt(ncells)
        F_re, F_im = F.real.contiguous(), F.imag.contiguous()
        if q == 0:
            F_re[0] = 0.5 * (F_re[0] + F_re[0].transpose(0, 1))
            F_im[0] = 0.0
        factors[q] = (F_re, F_im)
    return L, factors


# ----------------------------------------------------------------------
# the scale-out cases (parallel/kmesh): every sharded function against the
# serial port path on each rank's device, at a Tier-1 size (held to the
# JAX package by tests/test_torch_parallel.py) or at the card's widths
# (chip_smoke.py phase 17: SquareLattice(40, 40, 2, 2), phase 6's factors
# and lattice, phase 9c's GDF factors)
# ----------------------------------------------------------------------

KMESH_MODEL = {"imp": (2, 2), "U": 4.0, "filling": 0.5, "beta": 1000.0,
               "seed": 31}
KMESH_SIZES = {
    # square: the model lattice; chol: (ncells, nlo, naux, neo) of random
    # factors (None: phase 6's); veff: (ncells, nlo, naux, neo) of a small
    # phase-6 workload (None: phase 6's); gdf: (ncells, nlo, nfac, neo)
    # (None: phase 9c's); ccsd: (nocc, nvir) of tests/test_parallel.py's
    # solve's problem (the residual's is always its (8, 4))
    "tier1": {"square": (4, 4), "neo": 4, "chol": (2, 3, 16, 4),
              "veff": (2, 3, 5, 4), "gdf": (3, 3, 5, 4), "ccsd": (8, 6)},
    "card": {"square": (40, 40), "neo": 8, "chol": None, "veff": None,
             "gdf": None, "ccsd": (8, 6)},
}
KMESH_TOL = {"rho_R": 1e-8, "nelec": 1e-6, "embH1": 1e-8, "grad (rel)": 1e-8,
             "eri (rel)": 1e-12, "veff": 1e-10, "rho_glob": 1e-12,
             "gdf (rel)": 1e-10, "R1": 1e-12, "R2": 1e-12, "E_corr": 1e-9,
             "t1": 1e-7, "t2": 1e-7}


def kmesh_model_inputs(size, neo):
    """The model case as host arrays: the Fock pair f (1, nk, n, n) of
    SquareLattice(*size, 2, 2) at U = 4 and the PM seed vcor moved by
    seeded noise (vmat (1, n, n)), a random real-space basis carried to k
    (b_re, b_im (1, nk, n, neo)) and a random symmetric fit target."""
    import libdmet_preview_tpu_torch.dmet.hubbard as dmet
    from libdmet_preview_tpu_torch.ops import fourier
    p = KMESH_MODEL
    Lat = dmet.SquareLattice(*size, *p["imp"])
    Lat.set_Ham(dmet.Ham(Lat, p["U"]), use_hcore_as_emb_ham=True,
                device="cpu")
    vcor = dmet.PMInitGuess(p["imp"], p["U"], p["filling"])
    rng = np.random.RandomState(p["seed"])
    vcor.update(vcor.param + rng.randn(len(vcor.param)) * 0.05)
    f_re, f_im = (np.asarray(x) for x in Lat.getFock(kspace=True))
    if f_re.ndim == 3:
        f_re, f_im = f_re[None], f_im[None]
    kmesh = tuple(int(x) for x in Lat.kmesh)
    nk, n = f_re.shape[1], f_re.shape[-1]
    b = rng.randn(1, nk, n, neo) / np.sqrt(nk * n)
    b_re, b_im = fourier.R2k(b, kmesh)
    t = rng.randn(1, neo, neo) * 0.1
    return {"f_re": f_re, "f_im": f_im, "vmat": np.asarray(vcor.get())[:1],
            "kmesh": kmesh, "nelec2": int(round(2 * nk * n * p["filling"])),
            "beta": p["beta"], "b_re": np.asarray(b_re),
            "b_im": np.asarray(b_im),
            "target": 0.5 * (t + t.transpose(0, 2, 1))
            + 0.5 * np.eye(neo)[None]}


def kmesh_chol_inputs(dims):
    """tests/test_parallel.py's random factors L (naux, n, n) and basis
    (1, ncells, nlo, neo) at dims = (ncells, nlo, naux, neo)."""
    ncells, nlo, naux, neo = dims
    rng = np.random.RandomState(3)
    n = ncells * nlo
    L = rng.randn(naux, n, n)
    return L + L.transpose(0, 2, 1), rng.randn(1, ncells, nlo, neo)


def kmesh_veff_inputs(dims):
    """A small phase-6 workload lattice's arrays (hcore, fock, L, eri_imp)
    at dims = (ncells, nlo, naux, neo), a random unrestricted basis (2,
    ncells, nlo, neo) and a random symmetric rdm1_emb (2, neo, neo)."""
    ncells, nlo, naux, neo = dims
    work = make_abinitio_workload(seed=7, ncells=ncells, nlo=nlo, naux=naux)
    rng = np.random.RandomState(2)
    basis = rng.randn(2, ncells, nlo, neo) / np.sqrt(ncells * nlo)
    r = rng.randn(2, neo, neo) * 0.1
    rdm1 = 0.5 * (r + r.transpose(0, 2, 1)) + 0.5 * np.eye(neo)[None]
    return work, basis, rdm1


def abinitio_lattice(hcore, fock, L, eri_imp, device):
    """The phase-6 lattice of those arrays on `device` (no mean field)."""
    import libdmet_preview_tpu_torch.dmet.hubbard as dmet
    from libdmet_preview_tpu_torch.models.abinitio import AbInitioHam
    nlo = hcore.shape[-1]
    Lat = dmet.ChainLattice(hcore.shape[-3] * nlo, nlo)
    Lat.set_Ham_abinitio(AbInitioHam(hcore, fock, L, eri_imp, 0.0),
                         device=device)
    return Lat


def kmesh_gdf_inputs(dims, device):
    """make_gdf_workload's analytic factors at dims = (ncells, nlo, nfac,
    neo) (None: phase 9c's) on `device` and gdf_against_cholesky's random
    basis, carried to k: (factors, basis_k, ncells, nlo)."""
    from libdmet_preview_tpu_torch.ops import fourier
    if dims is None:
        dims = (GDF["ncells"], GDF["nlo"], GDF["nfac"], GDF["neo"])
    ncells, nlo, nfac, neo = dims
    _, factors = make_gdf_workload(device, ncells=ncells, nlo=nlo, nfac=nfac)
    rng = np.random.RandomState(21)
    basis = rng.randn(1, ncells, nlo, neo) / np.sqrt(ncells * nlo)
    basis_k = fourier.R2k(torch.as_tensor(basis, device=device), (ncells,))
    return factors, basis_k, ncells, nlo


def _antisym_W(rng, nso, scale):
    A = rng.randn(nso * nso, nso * nso) * scale
    W = (A - A.T).reshape(nso, nso, nso, nso)
    W = W - W.transpose(1, 0, 2, 3)
    W = W - W.transpose(0, 1, 3, 2)
    return 0.5 * (W + W.transpose(2, 3, 0, 1))


def ccsd_problem(nocc=8, nvir=6):
    """tests/test_parallel.py::test_ccsd_solve_fully_sharded's (h_so, W):
    a gapped diagonal Fock with seeded couplings and an antisymmetrized
    interaction."""
    rng = np.random.RandomState(1)
    nso = nocc + nvir
    h = np.diag(np.concatenate([-2.0 - np.arange(nocc)[::-1] * 0.3,
                                1.0 + np.arange(nvir) * 0.3]))
    m = rng.randn(nso, nso)
    h = h + 0.02 * (m + m.T)
    return h, _antisym_W(rng, nso, 0.03)


def ccsd_residual_problem(nocc=8, nvir=4):
    """tests/test_parallel.py::test_ccsd_residual_sharded's (t1, t2, h_so,
    W)."""
    rng = np.random.RandomState(0)
    nso = nocc + nvir
    h = rng.randn(nso, nso) * 0.1
    h = h + h.T
    W = _antisym_W(rng, nso, 0.05)
    t1 = rng.randn(nocc, nvir) * 0.05
    t2 = rng.randn(nocc, nocc, nvir, nvir) * 0.05
    t2 = t2 - t2.transpose(1, 0, 2, 3)
    t2 = t2 - t2.transpose(0, 1, 3, 2)
    return t1, t2, h, W


def _rel(a, b):
    return float(torch.max(torch.abs(a - b)) / torch.max(torch.abs(b)))


def _abs(a, b):
    return float(torch.max(torch.abs(torch.as_tensor(a)
                                     - torch.as_tensor(b))))


def _card_abinitio(mesh):
    """Phase 6's lattice on the rank's device, its mean field and the bath
    of that density; the basis is broadcast from rank 0 so that every rank
    shards one basis.  Returns (Lat, basis (2, ncells, nlo, neo))."""
    import torch.distributed as dist
    import libdmet_preview_tpu_torch.dmet.hubbard as dmet
    from libdmet_preview_tpu_torch.ops import embham
    hcore, fock, L, eri_imp = make_abinitio_workload()
    Lat = abinitio_lattice(hcore, fock, L, eri_imp, mesh.device)
    vcor = dmet.VcorLocal(False, False, hcore.shape[-1])
    vcor.assign(np.zeros((2,) + hcore.shape[-2:]))
    rho, _ = dmet.HartreeFock(Lat, vcor, AI_FILLING, None)
    basis = embham.embBasis(Lat, rho).contiguous()
    dist.broadcast(basis, 0)
    return Lat, basis


def kmesh_cases(mesh, size, prebuilt=None, keep=False):
    """Every parallel.kmesh function on `mesh` (axes "k" and "aux")
    against the serial port path on the rank's device, at `size` ("tier1"
    or "card"; KMESH_SIZES).  prebuilt may carry the card's objects:
    "square" (the model inputs), "abinitio" ((Lat, basis, rdm1_emb)),
    "gdf" ((factors, basis_k, ncells, nlo)), "ccsd" ({"h_so", "W",
    "nocc"})); what it lacks is rebuilt from the seeds.  Raises past
    KMESH_TOL.  Returns {"errors": {case: max deviation}, "launches": the
    symmetric syrk launches of the sharded ERI call, "plain_cuda": plain
    syrk calls on CUDA tensors in it, "results": the sharded results as
    host arrays (keep=True)}."""
    import libdmet_preview_tpu_torch.dmet.hubbard as dmet
    from libdmet_preview_tpu_torch.ops import eri_kernels as ek
    from libdmet_preview_tpu_torch.ops import embham, fourier, zlinalg
    from libdmet_preview_tpu_torch.ops.eri_transform import (
        get_emb_eri_chol, get_emb_eri_gdf)
    from libdmet_preview_tpu_torch.parallel import kmesh as km
    from libdmet_preview_tpu_torch.parallel.dryrun import fit_loss_and_grad
    from libdmet_preview_tpu_torch.solvers import cc
    from libdmet_preview_tpu_torch.utils.misc import as_f64
    dims = KMESH_SIZES[size]
    pre = dict(prebuilt or {})
    dev = mesh.device
    errs, out, bad = {}, {}, []

    def hold(name, err, tol_key):
        errs[name] = float(err)
        if not err <= KMESH_TOL[tol_key]:
            bad.append("%s %.3e > %.0e" % (name, err, KMESH_TOL[tol_key]))

    def t(x):
        return as_f64(x, dev)

    # -- the model lattice: mean field, embedding H1, the vcor gradient --
    m = pre.get("square") or kmesh_model_inputs(dims["square"], dims["neo"])
    h_re = m["f_re"] + m["vmat"][:, None]
    rho_R, mu, nchk = km.hf_rho_sharded(mesh, h_re, m["f_im"], m["kmesh"],
                                        m["nelec2"], m["beta"])
    r_re, r_im, _ = zlinalg.zrho_fermi(t(h_re), t(m["f_im"]), m["nelec2"],
                                       m["beta"])
    hold("hf_rho rho_R", _abs(rho_R, fourier.k2R((r_re, r_im), m["kmesh"])),
         "rho_R")
    hold("hf_rho nelec_check", abs(float(nchk) - m["nelec2"]), "nelec")
    basis_k = (m["b_re"], m["b_im"])
    h1 = km.transform_h1_sharded(mesh, (h_re, m["f_im"]), basis_k)
    hold("transform_h1", _abs(h1, embham.transform_h1(
        (t(h_re), t(m["f_im"])), (t(m["b_re"]), t(m["b_im"])))), "embH1")
    args = (m["f_re"], m["f_im"], m["vmat"], t(m["b_re"]), t(m["b_im"]),
            t(m["target"]), m["nelec2"], m["beta"])
    loss, g = fit_loss_and_grad(mesh, *args)
    loss_s, g_s = fit_loss_serial(*args, device=dev)
    hold("zrho loss", abs(loss - loss_s) / abs(loss_s), "grad (rel)")
    hold("zrho gradient (rel)", float(np.max(np.abs(g - g_s))
                                      / np.max(np.abs(g_s))), "grad (rel)")
    out.update({"rho_R": rho_R, "mu": mu, "nelec_check": nchk,
                "embH1": h1, "fit_err": loss, "grad": g})

    # -- the sharded ERI (the hand-written kernel on CUDA) --
    if "abinitio" in pre:
        Lat_ai, basis_ai, rdm1_ai = pre["abinitio"]
        L = Lat_ai.getH2()
    elif dims["chol"] is None:
        Lat_ai, basis_ai = _card_abinitio(mesh)
        L = Lat_ai.getH2()
        rng = np.random.RandomState(2)
        r = rng.randn(*((2,) + basis_ai.shape[-1:] * 2)) * 0.1
        rdm1_ai = 0.5 * (r + r.transpose(0, 2, 1)) \
            + 0.5 * np.eye(r.shape[-1])[None]
    else:
        L, basis_ai = kmesh_chol_inputs(dims["chol"])
        L = t(L)
    b1 = basis_ai[:1]
    plain = {"cuda": 0}
    plain_fn = ek.syrk_df_plain

    def counted(F, F2=None):
        if F.device.type == "cuda":
            plain["cuda"] += 1
        return plain_fn(F, F2)

    ek.syrk_df.launches = 0
    ek.syrk_df_plain = counted
    try:
        eri = km.get_emb_eri_chol_sharded(mesh, L, b1)
        launches = ek.syrk_df.launches
    finally:
        ek.syrk_df_plain = plain_fn
    hold("eri_chol (rel)", _rel(eri, get_emb_eri_chol(L, b1)), "eri (rel)")
    out["eri"] = eri

    # -- the sharded veff rebuild --
    def veff_case(msh, Lat, basis, rdm1, tag):
        v, g_ = km.get_veff_from_rdm1_emb_sharded(msh, Lat, rdm1, basis)
        v_s, g_s = embham.get_veff_from_rdm1_emb(Lat, rdm1, basis)
        hold("veff%s" % tag, _abs(v, v_s), "veff")
        hold("rho_glob%s" % tag, _abs(g_, g_s), "rho_glob")
        return v, g_

    if dims["veff"] is None:
        Lat_v, basis_v, rdm1_v = Lat_ai, basis_ai, rdm1_ai
    else:
        work, basis_v, rdm1_v = kmesh_veff_inputs(dims["veff"])
        Lat_v = abinitio_lattice(*work, dev)
    for spin in (2, 1):
        out["veff s%d" % spin], out["rho_glob s%d" % spin] = veff_case(
            mesh, Lat_v, basis_v[:spin], rdm1_v[:spin], " s%d" % spin)

    # -- the transfer-sharded GDF ERI --
    factors, gbasis_k, ncells, nlo = pre.get("gdf") or kmesh_gdf_inputs(
        dims["gdf"], dev)

    def gdf_case(msh, tag):
        for tr in (False, True):
            e = km.get_emb_eri_gdf_sharded(msh, factors, gbasis_k, ncells,
                                           nlo, tr_symm=tr)
            hold("gdf tr_symm=%s%s (rel)" % (tr, tag), _rel(e, get_emb_eri_gdf(
                factors, gbasis_k, ncells, nlo, tr_symm=tr, device=dev)),
                "gdf (rel)")
            out["gdf tr_symm=%s%s" % (tr, tag)] = e

    gdf_case(mesh, "")

    # -- uneven shards: the whole world on the aux axis, where some ranks
    # hold only padding at the Tier-1 sizes --
    if size == "tier1":
        import torch.distributed as dist
        flat = km.make_mesh((dist.get_world_size(),), ("aux",), dev)
        for spin in (2, 1):
            out["veff s%d flat" % spin], out["rho_glob s%d flat" % spin] = \
                veff_case(flat, Lat_v, basis_v[:spin], rdm1_v[:spin],
                          " s%d flat" % spin)
        gdf_case(flat, " flat")

    # -- CCSD: the residual and the whole solve, t2 sharded over occ --
    nocc, nvir = dims["ccsd"]
    t1r, t2r, hr, Wr = (t(x) for x in ccsd_residual_problem())
    nr = t1r.shape[0]
    rows = km.shard(nr, mesh, "k")
    R1, R2 = km.ccsd_residual_sharded(mesh, t1r, t2r[rows], hr, Wr, nr)
    with torch.no_grad():
        R1_s, R2_s = cc._residual(t1r, t2r, hr, Wr, nr)
    hold("ccsd residual R1", _abs(R1, R1_s), "R1")
    hold("ccsd residual R2", _abs(R2, R2_s[rows]), "R2")
    out.update({"R1": R1, "R2_local": R2})
    if "ccsd" in pre:
        h_so, W, nocc = pre["ccsd"]["h_so"], pre["ccsd"]["W"], \
            pre["ccsd"]["nocc"]
    else:
        h_so, W = (t(x) for x in ccsd_problem(nocc, nvir))
    rows = km.shard(nocc, mesh, "k")
    t1, t2, e, conv = km.ccsd_solve_sharded(mesh, h_so, W, nocc, tol=1e-10)
    shapes = km.ccsd_solve_sharded.last["t2_local_shapes"]
    t1_s, t2_s, conv_s = cc._solve_amplitudes(h_so, W, nocc, tol=1e-10)
    with torch.no_grad():
        e_s = float(cc._ecorr(t1_s, t2_s, h_so, W, nocc))
    hold("ccsd E_corr", abs(e - e_s), "E_corr")
    hold("ccsd t1", _abs(t1, t1_s), "t1")
    hold("ccsd t2", _abs(t2, t2_s[rows]), "t2")
    want = {(rows.stop - rows.start,) + tuple(t2_s.shape[1:])}
    if not (conv and conv_s) or shapes != want:
        bad.append("ccsd: converged %s / %s, local t2 shapes %s (want %s)"
                   % (conv, conv_s, shapes, want))
    out.update({"E_corr": e, "t1": t1, "t2_local": t2,
                "t2_local_shapes": sorted(shapes),
                "ccsd_iterations": km.ccsd_solve_sharded.last["iterations"]})
    if dev.type == "cuda" and (launches != 1 or plain["cuda"]):
        bad.append("sharded ERI: %d tri launches, %d plain calls on CUDA "
                   "(want 1, 0)" % (launches, plain["cuda"]))
    if bad:
        raise AssertionError("rank %d: kmesh cases failed: %s"
                             % (mesh.rank, "; ".join(bad)))
    res = {"errors": errs, "launches": launches, "plain_cuda": plain["cuda"]}
    if keep:
        res["results"] = {k: to_host(v) if isinstance(v, torch.Tensor) else v
                          for k, v in out.items()}
    return res


def fit_loss_serial(f_re, f_im, vmat, b_re, b_im, target, nelec2, beta,
                    device):
    """parallel.dryrun.fit_loss_and_grad on one process: the Fermi density
    of every k point by ops.zlinalg.zrho_fermi.  Returns (float, array)."""
    from libdmet_preview_tpu_torch.ops import zlinalg
    v = torch.as_tensor(np.asarray(vmat, dtype=np.float64),
                        device=device).requires_grad_(True)
    h_re = torch.as_tensor(f_re, device=device) + v[:, None]
    r_re, r_im, _ = zlinalg.zrho_fermi(h_re, torch.as_tensor(f_im,
                                                             device=device),
                                       nelec2, beta)
    nk = f_re.shape[1]
    ein = torch.einsum
    rho_emb = (ein("skpi, skpq, skqj -> sij", b_re, r_re, b_re)
               + ein("skpi, skpq, skqj -> sij", b_im, r_re, b_im)
               + ein("skpi, skpq, skqj -> sij", b_im, r_im, b_re)
               - ein("skpi, skpq, skqj -> sij", b_re, r_im, b_im)) / nk
    loss = torch.sum((rho_emb - target) ** 2)
    (g,) = torch.autograd.grad(loss, v)
    return float(loss.detach()), g.cpu().numpy()
