"""
CAS solver family (PyTorch port of libdmet_preview_tpu/solvers/casci.py):
CASCI / UCASCI / GCASCI (FCI in an active space with a frozen
mean-field core) and their orbital-optimized versions CASSCF / UCASSCF /
GCASSCF, plus project_active_space.

The reference determinant's orbitals are found on the solver's device
(solvers/scf.py: the J/K builds there, the n x n steps on the host).  The
four-index transforms of the CAS Integral and the back-transforms of the
active 2-RDM are four GEMMs each (models/abinitio._rot4); the active FCI
is the port's sigma/Davidson on the device.  Any solver with the
run / make_rdm2 contract drops in as fcisolver (the Block-DMRG bridge of
solvers/dmrg.py for DMRG-CI / DMRG-SCF): what it returns is taken as
arrays or tensors.

The orbital optimizers minimize the exact fixed-CI energy functional

    E(kappa) = Tr[h(kappa) D] + 1/2 sum G g(kappa),  C -> C exp(kappa)

over the nonredundant rotations with ops.fit.minimize(method="NEWTON"):
E and its gradient from torch.autograd through torch.linalg.matrix_exp and
the four-GEMM integral rotation, Hessian-vector products by a double
backward (create_graph=True) through the same graph.
"""

import numpy as np
import scipy.linalg as sla
import torch

from libdmet_preview_tpu_torch.utils import logger as log
from libdmet_preview_tpu_torch.utils.misc import as_f64, to_host
from libdmet_preview_tpu_torch.utils.timer import stage
from libdmet_preview_tpu_torch.models.abinitio import _rot4
from libdmet_preview_tpu_torch.models.integral import Integral
from libdmet_preview_tpu_torch.solvers.scf import (SCF, GGHF, _s1_block,
                                                   _veff_uhf)
from libdmet_preview_tpu_torch.solvers.fci import FCI


def _outer(A, B):
    """einsum("pq, rs -> pqrs", A, B)."""
    return A[:, :, None, None] * B[None, None, :, :]


def _exch(A, B):
    """einsum("ps, rq -> pqrs", A, B)."""
    return A[:, None, None, :] * B.T[None, :, :, None]


def _back(G, C1, C2):
    """einsum("pqrs, ip, jq, kr, ls -> ijkl", G, C1, C1, C2, C2): an
    active-space 2-RDM block in the full basis."""
    return _rot4(G, C1.T, C1.T, C2.T, C2.T)


def _cas_terms(Dc, Da, x):
    """The mean-field 2-RDM terms of a frozen core Dc and an active
    density Da (exchange coefficient x: 0.5 spin-summed, 1 per species)."""
    return (_outer(Dc, Dc) - x * _exch(Dc, Dc) + _outer(Dc, Da)
            + _outer(Da, Dc) - x * _exch(Dc, Da) - x * _exch(Da, Dc))


def _ints_restricted(Ham, device):
    """(h1, s1 ERI) of a one-block Integral as tensors on `device`."""
    return (as_f64(Ham.H1["cd"][0], device),
            _s1_block(Ham.H2["ccdd"][0], Ham.norb, device))


def _unpack_uhf(Ham, device):
    """(h1a, h1b, g_aa, g_bb, g_ab) of a one- or three-block Integral as s1
    tensors on `device`."""
    n = Ham.norb
    H1 = as_f64(Ham.H1["cd"], device)
    h1a = H1[0]
    h1b = H1[1] if H1.shape[0] == 2 else H1[0]
    H2 = Ham.H2["ccdd"]
    if len(H2) == 1:
        g = _s1_block(H2[0], n, device)
        return h1a, h1b, g, g, g
    return (h1a, h1b) + tuple(_s1_block(H2[i], n, device) for i in range(3))


def _core_embed_uhf(blocks, Cca, Ccb, H0):
    """Per-spin frozen core: (h1a + va, h1b + vb, e_core, dmca, dmcb) with
    the core densities of the columns Cca / Ccb (tensors)."""
    h1a, h1b, g_aa, g_bb, g_ab = blocks
    dmca, dmcb = Cca @ Cca.T, Ccb @ Ccb.T
    va, vb = _veff_uhf(dmca, dmcb, g_aa, g_bb, g_ab)
    e_core = float(torch.sum((h1a + 0.5 * va) * dmca)
                   + torch.sum((h1b + 0.5 * vb) * dmcb)) + float(H0)
    return h1a + va, h1b + vb, e_core, dmca, dmcb


def _cas_eri_uhf(gs, Aa, Ab):
    """The active (aa, bb, ab) ERI blocks of the site blocks gs = (g_aa,
    g_bb, g_ab) in the active columns Aa, Ab."""
    g_aa, g_bb, g_ab = gs
    return (_rot4(g_aa, Aa, Aa, Aa, Aa), _rot4(g_bb, Ab, Ab, Ab, Ab),
            _rot4(g_ab, Aa, Aa, Ab, Ab))


def mp2_natural_orbitals(h_mo, g_mo, nocc):
    """Spin-restricted MP2 natural-orbital occupations and rotation, on
    the device of h_mo (tensors).

    h_mo/g_mo in the canonical MO basis (chemist).  Returns (occ, U)
    with U the MO->NO rotation, occupations descending."""
    n = h_mo.shape[0]
    f = h_mo + 2.0 * torch.einsum("pqii -> pq", g_mo[:, :, :nocc, :nocc]) \
        - torch.einsum("piiq -> pq", g_mo[:, :nocc, :nocc, :])
    eps = torch.diagonal(f)
    eo, ev = eps[:nocc], eps[nocc:]
    # t2[i,j,a,b] = (ia|jb) / (ei + ej - ea - eb)
    g_ovov = g_mo[:nocc, nocc:, :nocc, nocc:]
    denom = (eo[:, None, None, None] + eo[None, None, :, None]
             - ev[None, :, None, None] - ev[None, None, None, :])
    t2 = g_ovov / denom                      # (i, a, j, b)
    # MP2 1-RDM correction (unrelaxed)
    doo = -(2.0 * torch.einsum("iajb, kajb -> ik", t2, t2)
            - torch.einsum("iajb, kbja -> ik", t2, t2))
    dvv = (2.0 * torch.einsum("iajb, icjb -> ac", t2, t2)
           - torch.einsum("iajb, ibjc -> ac", t2, t2))
    dm = torch.zeros((n, n), dtype=h_mo.dtype, device=h_mo.device)
    dm[:nocc, :nocc] = 2.0 * torch.eye(nocc, dtype=h_mo.dtype,
                                       device=h_mo.device) + doo + doo.T
    dm[nocc:, nocc:] = dvv + dvv.T
    w, v = torch.linalg.eigh(dm)
    return torch.flip(w, (0,)), torch.flip(v, (1,))


class CASCI(object):
    """run(ImpHam, nelec) -> (rdm1 (1, n, n) tensor on `device`, E) with an
    (ncas, nelecas) active space; orbitals = RHF canonical -> MP2 natural
    orbitals."""

    def __init__(self, ncas, nelecas, restricted=True, Sz=0,
                 fcisolver=None, tol=1e-10, device=torch.device("cuda"),
                 **kwargs):
        assert restricted, "CASCI implemented for restricted references"
        self.ncas = ncas
        self.nelecas = nelecas
        self.Sz = Sz
        self.tol = tol
        self.device = torch.device(device)
        self.fcisolver = fcisolver or FCI(restricted=True, Sz=Sz, tol=tol,
                                          device=self.device)
        self.onepdm = None
        self.twopdm = None
        self.e_tot = None

    def run(self, Ham, nelec=None, **kwargs):
        if nelec is None:
            raise ValueError("CASCI.run requires nelec")
        dev = self.device
        n = Ham.norb
        nocc = nelec // 2
        ncore = (nelec - self.nelecas) // 2
        ncas = self.ncas
        assert ncore >= 0 and ncore + ncas <= n

        myscf = SCF(device=dev)
        myscf.set_system(nelec, 0, False, True)
        myscf.set_integral(Ham)
        with stage("CAS reference SCF", dev):
            myscf.HF(tol=1e-11)
        C = as_f64(myscf.mo_coeff[0], dev)

        with stage("CAS transform", dev):
            h1, g = _ints_restricted(Ham, dev)
            h_mo = C.T @ h1 @ C
            g_mo = _rot4(g, C, C, C, C)
            # MP2 natural orbitals; keep core/active split by occupation
            _, U = mp2_natural_orbitals(h_mo, g_mo, nocc)
            del g_mo
            C_no = C @ U
            C_core = C_no[:, :ncore]
            C_cas = C_no[:, ncore:ncore + ncas]
            Ham_cas, dm_core = _core_embed_restricted(h1, g, Ham.H0, C_core,
                                                      C_cas)
        with stage("CAS FCI", dev):
            rdm_cas, E = self.fcisolver.run(Ham_cas, nelec=self.nelecas)
        # back-transform rdm1 to the site basis (per-spin convention)
        rdm1 = C_cas @ as_f64(rdm_cas[0], dev) @ C_cas.T + 0.5 * dm_core
        self.onepdm = rdm1[None]
        self.e_tot = E
        self._cas = (C_core, C_cas, Ham_cas)
        return self.onepdm, E

    def make_rdm2(self, Ham=None):
        """Full-space spin-summed 2-RDM (chemist (pq|rs), the FCI
        convention E2 = 0.5 sum G_pqrs (pq|rs)): the active twopdm
        back-transformed with C_cas plus the analytic closed-shell core
        contributions (G = G_act + Dc Dc - Dc Dc / 2 (exch) + Dc Da cross
        terms, Dc / Da the spin-summed core / active 1-RDMs)."""
        if self.onepdm is None:
            raise RuntimeError("run CASCI before make_rdm2")
        dev = self.device
        C_core, C_cas, Ham_cas = self._cas
        with stage("CAS rdm2", dev):
            G_act = as_f64(self.fcisolver.make_rdm2(Ham_cas), dev)[0]
            G = _back(G_act, C_cas, C_cas)
            Dc = 2.0 * C_core @ C_core.T
            Da = 2.0 * C_cas @ as_f64(self.fcisolver.onepdm, dev)[0] @ C_cas.T
            G = G + _cas_terms(Dc, Da, 0.5)
        self.twopdm = G[None]
        return self.twopdm

    def run_dmet_ham(self, Ham, **kwargs):
        """Energy of the scaled DMET Hamiltonian with the stored
        rdm1 / rdm2."""
        self.make_rdm2()
        h1, h2 = _ints_restricted(Ham, self.device)
        E1 = torch.sum(h1 * self.onepdm[0].T) * 2.0
        E2 = torch.sum(h2 * self.twopdm[0]) * 0.5
        return float(E1 + E2) + float(Ham.H0)

    def cleanup(self):
        pass


def _core_embed_restricted(h1, g, H0, C_core, C_cas):
    """Closed-shell frozen core: (the active Integral, the spin-summed core
    density)."""
    ncas = C_cas.shape[1]
    dm_core = 2.0 * C_core @ C_core.T
    v_core = _veff_uhf(0.5 * dm_core, 0.5 * dm_core, g, g, g)[0]
    e_core = float(torch.sum((h1 + 0.5 * v_core) * dm_core)) + float(H0)
    h_cas = C_cas.T @ (h1 + v_core) @ C_cas
    g_cas = _rot4(g, C_cas, C_cas, C_cas, C_cas)
    return Integral(ncas, True, False, e_core, {"cd": h_cas[None]},
                    {"ccdd": g_cas[None]}), dm_core


class UCASCI(object):
    """Unrestricted CASCI: UHF reference, per-spin canonical orbitals, an
    (ncas, nelecas) active window straddling the Fermi level in each spin
    channel, spin-dependent FCI in the active space.  The static-correlation
    solver for spin-polarized d-block embeddings (NiO / cuprates) where
    single-reference UCCSD stalls on the near-degenerate d manifold."""

    def __init__(self, ncas, nelecas, Sz=0, fcisolver=None, tol=1e-10,
                 device=torch.device("cuda"), **kwargs):
        self.ncas = ncas
        if isinstance(nelecas, (tuple, list)):
            self.na_cas, self.nb_cas = nelecas
        else:
            self.na_cas = (nelecas + Sz) // 2
            self.nb_cas = nelecas - self.na_cas
        self.Sz = Sz
        self.tol = tol
        self.device = torch.device(device)
        self.fcisolver = fcisolver or FCI(
            restricted=False, Sz=self.na_cas - self.nb_cas, tol=tol,
            device=self.device)
        self.onepdm = None
        self.twopdm = None
        self.e_tot = None
        self.scf = None

    def _ham_cas(self, blocks, H0, Cca, Ccb, Aa, Ab):
        """The active Integral of per-spin core and active columns, and the
        core densities."""
        ha, hb, e_core, dmca, dmcb = _core_embed_uhf(blocks, Cca, Ccb, H0)
        g_cas = _cas_eri_uhf(blocks[2:], Aa, Ab)
        Ham_cas = Integral(self.ncas, False, False, e_core,
                           {"cd": torch.stack([Aa.T @ ha @ Aa,
                                               Ab.T @ hb @ Ab])},
                           {"ccdd": torch.stack(g_cas)})
        return Ham_cas, dmca, dmcb

    def _solve_cas(self, Ham_cas, Aa, Ab, dmca, dmcb):
        dev = self.device
        with stage("CAS FCI", dev):
            rdm_cas, E = self.fcisolver.run(
                Ham_cas, nelec=self.na_cas + self.nb_cas)
        rdm_cas = as_f64(rdm_cas, dev)
        self.onepdm = torch.stack([Aa @ rdm_cas[0] @ Aa.T + dmca,
                                   Ab @ rdm_cas[1] @ Ab.T + dmcb])
        self._cas = (Aa, Ab, dmca, dmcb, Ham_cas, rdm_cas[0], rdm_cas[1])
        self.twopdm = None
        return E

    def run(self, Ham, nelec=None, dm0=None, **kwargs):
        if nelec is None:
            raise ValueError("UCASCI.run requires nelec")
        dev = self.device
        n = Ham.norb
        na = (nelec + self.Sz) // 2
        nb = nelec - na
        ncas = self.ncas
        nca, ncb = na - self.na_cas, nb - self.nb_cas
        log.eassert(nca >= 0 and ncb >= 0 and max(nca, ncb) + ncas <= n,
                    "active window (%d, (%d,%d)) incompatible with "
                    "nelec=(%d,%d), norb=%d", ncas, self.na_cas,
                    self.nb_cas, na, nb, n)

        self.scf = myscf = SCF(device=dev)
        myscf.set_system(nelec, self.Sz, False, False)
        myscf.set_integral(Ham)
        with stage("CAS reference SCF", dev):
            myscf.HF(tol=min(self.tol, 1e-10), MaxIter=500, InitGuess=dm0)
        mo = myscf.mo_coeff
        Ca = as_f64(mo[0], dev)
        Cb = as_f64(mo[1] if mo.shape[0] == 2 else mo[0], dev)

        with stage("CAS transform", dev):
            blocks = _unpack_uhf(Ham, dev)
            Aa = Ca[:, nca:nca + ncas]
            Ab = Cb[:, ncb:ncb + ncas]
            Ham_cas, dmca, dmcb = self._ham_cas(blocks, Ham.H0, Ca[:, :nca],
                                                Cb[:, :ncb], Aa, Ab)
        E = self._solve_cas(Ham_cas, Aa, Ab, dmca, dmcb)
        self.e_tot = E
        return self.onepdm, E

    def make_rdm2(self, Ham=None):
        """Spin-resolved full-space 2-RDM blocks [Gaa, Gbb, Gab] (chemist,
        the unrestricted run_dmet_ham convention E2 = 0.5 Gaa g_aa + 0.5
        Gbb g_bb + Gab g_ab): active blocks back-transformed +
        idempotent-core / core-active mean-field terms."""
        if self.onepdm is None:
            raise RuntimeError("run UCASCI before make_rdm2")
        dev = self.device
        Aa, Ab, dmca, dmcb, Ham_cas, da, db = self._cas
        with stage("CAS rdm2", dev):
            Gaa_c, Gbb_c, Gab_c = as_f64(self.fcisolver.make_rdm2(Ham_cas),
                                         dev)
            Daa = Aa @ da @ Aa.T
            Dab = Ab @ db @ Ab.T
            Gaa = _back(Gaa_c, Aa, Aa) + _cas_terms(dmca, Daa, 1.0)
            Gbb = _back(Gbb_c, Ab, Ab) + _cas_terms(dmcb, Dab, 1.0)
            Gab = _back(Gab_c, Aa, Ab) + _outer(dmca, dmcb) \
                + _outer(dmca, Dab) + _outer(Daa, dmcb)
        self.twopdm = torch.stack([Gaa, Gbb, Gab])
        return self.twopdm

    def run_dmet_ham(self, Ham, last_aabb=True, **kwargs):
        """Scaled-DMET-Hamiltonian energy with the stored RDMs
        (unrestricted solver contract, as cc.py run_dmet_ham)."""
        if self.twopdm is None:
            self.make_rdm2()
        h1a, h1b, g_aa, g_bb, g_ab = _unpack_uhf(Ham, self.device)
        r1, r2 = self.onepdm, self.twopdm
        E1 = torch.sum(h1a * r1[0]) + torch.sum(h1b * r1[1])
        E2 = (0.5 * torch.sum(g_aa * r2[0]) + 0.5 * torch.sum(g_bb * r2[1])
              + torch.sum(g_ab * r2[2]))
        return float(E1 + E2) + float(Ham.H0)

    def cleanup(self):
        pass


def project_active_space(Ham, nelec, ncas, nelecas, mo_coeff=None,
                         device=torch.device("cuda")):
    """Active-space projection of an embedding Integral: fold the HF core
    into an effective (ncas, nelecas) Integral, on `device`.

    Returns (Ham_cas, info) with info = {C_core, C_cas, e_core, dm_core}
    (tensors but e_core) for back-transforming solver RDMs:
        rdm1_full = C_cas rdm1_cas C_cas^T + 0.5 * dm_core   (per spin)
    """
    device = torch.device(device)
    n = Ham.norb
    ncore = (nelec - nelecas) // 2
    assert ncore >= 0 and ncore + ncas <= n
    if mo_coeff is None:
        myscf = SCF(device=device)
        myscf.set_system(nelec, 0, False, True)
        myscf.set_integral(Ham)
        myscf.HF(tol=1e-11)
        mo_coeff = myscf.mo_coeff[0]
    C = as_f64(mo_coeff, device)
    h1, g = _ints_restricted(Ham, device)
    C_core = C[:, :ncore]
    C_cas = C[:, ncore:ncore + ncas]
    Ham_cas, dm_core = _core_embed_restricted(h1, g, Ham.H0, C_core, C_cas)
    info = {"C_core": C_core, "C_cas": C_cas, "e_core": float(Ham_cas.H0),
            "dm_core": dm_core}
    return Ham_cas, info


# ----------------------------------------------------------------------
# orbital optimization: E(kappa) through matrix_exp, Newton with HVPs
# ----------------------------------------------------------------------

def _rot_pairs(nc, ncas, n):
    """Nonredundant rotations (core-active, core-virtual, active-virtual)
    as (rows, cols) index arrays."""
    pairs = [(i, j) for i in range(nc) for j in range(nc, nc + ncas)]
    pairs += [(i, j) for i in range(nc) for j in range(nc + ncas, n)]
    pairs += [(i, j) for i in range(nc, nc + ncas) for j in range(nc + ncas,
                                                                   n)]
    rows = np.array([p[0] for p in pairs], dtype=int)
    cols = np.array([p[1] for p in pairs], dtype=int)
    return rows, cols


def _full_C(C0, n):
    """[C0 | an orthonormal complement] (host arrays)."""
    w, v = np.linalg.eigh(np.eye(n) - C0 @ C0.T)
    nvirt = n - C0.shape[1]
    C_virt = v[:, -nvirt:] if nvirt > 0 else np.zeros((n, 0))
    return np.hstack([C0, C_virt])


def _mo_cas_rdms(n, nc, ncas, d_act, G_act, x, dev):
    """Full-space (D, G, Dc, Da) in an MO basis (core | act | virt) of a
    frozen core of nc orbitals and the active (d_act, G_act); exchange
    coefficient x, core occupation 1 / x (x = 0.5 spin-summed, 1 per
    species)."""
    a = slice(nc, nc + ncas)
    Dc = torch.zeros((n, n), dtype=torch.float64, device=dev)
    Dc[:nc, :nc] = torch.eye(nc, dtype=torch.float64, device=dev) / x
    Da = torch.zeros_like(Dc)
    Da[a, a] = d_act
    G = torch.zeros((n,) * 4, dtype=torch.float64, device=dev)
    G[a, a, a, a] = G_act
    return Dc + Da, G + _cas_terms(Dc, Da, x), Dc, Da


def _rdm_energy(h1, g, H0, state):
    """The orbital functional of the restricted and the GSO CASSCF:
    E(C) = tr(C^T h C D^T) + 1/2 sum (CC|CC) G + H0 at the MO-basis RDMs
    (state["D"], state["G"]) of the current macro iteration."""
    def energy(Cs):
        C = Cs[0]
        return (torch.sum((C.T @ h1 @ C) * state["D"].T)
                + 0.5 * torch.sum(_rot4(g, C, C, C, C) * state["G"]) + H0)
    return energy


class _OrbitalNewton(object):
    """E(kappa) over a set of rotation generators for each spin channel,
    its gradient (autograd) and Hessian-vector products (double
    backward)."""

    def __init__(self, energy, pairs, n, dev):
        self.energy = energy            # (list of C_s) -> 0-d tensor
        self.host_pairs = pairs
        self.pairs = [tuple(torch.as_tensor(a, device=dev) for a in rc)
                      for rc in pairs]
        self.sizes = [len(rc[0]) for rc in pairs]
        self.n = n
        self.dev = dev

    def _E(self, p, Cs):
        out, k = [], 0
        for (rows, cols), sz, C in zip(self.pairs, self.sizes, Cs):
            K = torch.zeros((self.n, self.n), dtype=p.dtype, device=p.device)
            K = K.index_put((rows, cols), p[k:k + sz])
            out.append(C @ torch.linalg.matrix_exp(K - K.T))
            k += sz
        return self.energy(out)

    def grad(self, x, Cs):
        p = as_f64(x, self.dev).requires_grad_(True)
        E = self._E(p, Cs)
        (g,) = torch.autograd.grad(E, p)
        return float(E.detach()), g.cpu().numpy()

    def hvp(self, x, v, Cs):
        p = as_f64(x, self.dev).requires_grad_(True)
        (g,) = torch.autograd.grad(self._E(p, Cs), p, create_graph=True)
        (Hv,) = torch.autograd.grad(g, p, as_f64(v, self.dev))
        return Hv.cpu().numpy()

    def generators(self, p_opt):
        out, k = [], 0
        for (rows, cols), sz in zip(self.host_pairs, self.sizes):
            K = np.zeros((self.n, self.n))
            K[rows, cols] = p_opt[k:k + sz]
            out.append(K - K.T)
            k += sz
        return out


def _optimize_orbitals(opt, Cs, gtol, counts):
    """One Newton orbital minimization at fixed CI, from kappa = 0.
    Returns the rotated host orbitals, or None when the gradient test
    passes at kappa = 0.  Adds to counts the minimization ("newton"), the
    evaluations with a gradient ("grad") and the Hessian-vector products
    ("hvp")."""
    from libdmet_preview_tpu_torch.ops.fit import minimize
    npar = sum(opt.sizes)
    Cs_t = [as_f64(C, opt.dev) for C in Cs]
    counts["grad"] += 1
    if not npar or np.max(np.abs(opt.grad(np.zeros(npar), Cs_t)[1])) \
            < gtol * 10:
        return None

    def fun_grad(x):
        counts["grad"] += 1
        return opt.grad(x, Cs_t)

    def hvp(x, v):
        counts["hvp"] += 1
        return opt.hvp(x, v, Cs_t)

    with stage("orbital steps", opt.dev):
        p_opt, _ = minimize(fun_grad, np.zeros(npar), method="NEWTON",
                            max_iter=30, hvp=hvp, gtol=gtol,
                            trust_radius=0.4)
    counts["newton"] += 1
    return [to_host(C) @ sla.expm(K)
            for C, K in zip(Cs, opt.generators(p_opt))]


class CASSCF(object):
    """Orbital-optimized CASCI with second-order orbital steps:
    macro-iterate CAS solve -> analytic orbital optimization of the exact
    fixed-CI energy functional with the CASCI full-space RDMs (D, G) held
    fixed, over the nonredundant rotations (core-active, core-virtual,
    active-virtual).  Any solver with the run / make_rdm2 contract works
    as the CAS solver (the Block-DMRG bridge for DMRG-SCF).  n_macro counts
    the macro iterations of the last run; counts adds up, over the runs
    since the solver was made, the Newton minimizations ("newton"), the
    orbital gradients ("grad") and the Hessian-vector products ("hvp")."""

    def __init__(self, ncas, nelecas, restricted=True, tol=1e-8,
                 max_cycle=30, fcisolver=None, device=torch.device("cuda")):
        assert restricted
        self.ncas = ncas
        self.nelecas = nelecas
        self.tol = tol
        self.max_cycle = max_cycle
        self.fcisolver = fcisolver
        self.device = torch.device(device)
        self.onepdm = None
        self.e_tot = None
        self.mo_coeff = None
        self.converged = False
        self.n_macro = 0
        self.orbital = None
        self.counts = {"newton": 0, "grad": 0, "hvp": 0}

    def run(self, Ham, nelec=None, **kwargs):
        if nelec is None:
            raise ValueError("CASSCF.run requires nelec")
        dev = self.device
        n = Ham.norb
        ncore = (nelec - self.nelecas) // 2
        ncas = self.ncas
        nvirt = n - ncore - ncas
        assert ncore >= 0 and nvirt >= 0

        # start from the CASCI solution's orbitals (HF -> MP2 NOs)
        cas = CASCI(self.ncas, self.nelecas, fcisolver=self.fcisolver,
                    device=dev)
        _, E = cas.run(Ham, nelec=nelec)
        C_core, C_cas, _ = cas._cas
        C_full = _full_C(np.hstack([to_host(C_core), to_host(C_cas)]), n)

        h1, g = _ints_restricted(Ham, dev)
        H0 = float(Ham.H0)
        state = {}
        self.orbital = opt = _OrbitalNewton(
            _rdm_energy(h1, g, H0, state), [_rot_pairs(ncore, ncas, n)], n,
            dev)
        self.converged = False
        for macro in range(self.max_cycle):
            self.n_macro = macro + 1
            G_act = as_f64(cas.fcisolver.make_rdm2(cas._cas[2]), dev)[0]
            d_act = 2.0 * as_f64(cas.fcisolver.onepdm, dev)[0]
            state["D"], state["G"], _, _ = _mo_cas_rdms(n, ncore, ncas, d_act,
                                                        G_act, 0.5, dev)
            C_new = _optimize_orbitals(opt, [C_full], self.tol,
                                       self.counts)
            if C_new is None:
                self.converged = True
                break
            C_full = C_new[0]
            # re-solve the CAS problem in the rotated orbitals
            Ham_cas, info = project_active_space(
                Ham, nelec, ncas, self.nelecas, mo_coeff=C_full, device=dev)
            with stage("CAS FCI", dev):
                rdm_cas, E = cas.fcisolver.run(Ham_cas, nelec=self.nelecas)
            cas._cas = (info["C_core"], info["C_cas"], Ham_cas)
            cas.onepdm = (info["C_cas"] @ as_f64(rdm_cas[0], dev)
                          @ info["C_cas"].T + 0.5 * info["dm_core"])[None]

        C_full_t = as_f64(C_full, dev)
        cas.e_tot = float(E)
        self._casci = cas
        self.onepdm = cas.onepdm
        self.e_tot = float(E)
        self.mo_coeff = C_full
        self._cas = (C_full_t[:, :ncore], C_full_t[:, ncore:ncore + ncas],
                     cas._cas[2])
        self.fcisolver = cas.fcisolver
        return self.onepdm, self.e_tot

    def make_rdm2(self, Ham=None):
        """The full-space 2-RDM at the optimized orbitals (CASCI's)."""
        self.twopdm = self._casci.make_rdm2(Ham)
        return self.twopdm

    def run_dmet_ham(self, Ham, **kwargs):
        return self._casci.run_dmet_ham(Ham, **kwargs)

    def cleanup(self):
        pass


def _gso_core_embed(h1, g, H0, C_core, C_cas):
    """Freeze-core embedding for a single-species (generalized spin
    orbital) Hamiltonian: closed-core mean field v_core = J - K with
    exchange coefficient 1, core energy, and the active-window Integral
    (shared by GCASCI and GCASSCF); tensors on one device."""
    ncas = C_cas.shape[1]
    rho_c = C_core @ C_core.T
    v_core = torch.einsum("pqrs, sr -> pq", g, rho_c) \
        - torch.einsum("psrq, sr -> pq", g, rho_c)
    e_core = float(torch.sum((h1 + 0.5 * v_core) * rho_c)) + float(H0)
    h_cas = C_cas.T @ (h1 + v_core) @ C_cas
    g_cas = _rot4(g, C_cas, C_cas, C_cas, C_cas)
    return Integral(ncas, True, False, e_core,
                    {"cd": h_cas[None]}, {"ccdd": g_cas[None]})


class GCASCI(object):
    """GSO-frame CASCI on generalized spin orbitals (BCS DMET runs in the
    GSO frame after the particle-hole transform, so the quasiparticle
    CASCI is this class on the transformed Integral).

    All orbital counts are spin-orbital counts: an (ncas, nelecas) window
    holds ncas spin orbitals and nelecas particles.  The reference GHF
    determinant comes from solvers/scf.GGHF; the active window is chosen by
    canonical orbital energies around the Fermi level, or (nat_orb=True)
    by natural occupations of a supplied dm0.  Any solver with the FCI
    contract (run / make_rdm2 on a restricted-storage spin-orbital
    Integral) drops in as fcisolver -- FCI(ghf=True) in-process, or the
    Block bridge for the DMRG-CI composition."""

    def __init__(self, ncas, nelecas, fcisolver=None, tol=1e-10,
                 nat_orb=False, device=torch.device("cuda"), **kwargs):
        self.ncas = ncas
        self.nelecas = nelecas
        self.tol = tol
        self.nat_orb = nat_orb
        self.device = torch.device(device)
        self.fcisolver = fcisolver or FCI(restricted=True, ghf=True,
                                          tol=tol, device=self.device)
        self.onepdm = None
        self.twopdm = None
        self.e_tot = None

    def _solve(self, h1, g, H0, C_core, C_cas, **kwargs):
        dev = self.device
        Ham_cas = _gso_core_embed(h1, g, H0, C_core, C_cas)
        with stage("CAS FCI", dev):
            rdm_cas, E = self.fcisolver.run(Ham_cas, nelec=self.nelecas,
                                            **kwargs)
        self.onepdm = (C_core @ C_core.T
                       + C_cas @ as_f64(rdm_cas[0], dev) @ C_cas.T)[None]
        self._cas = (C_core, C_cas, Ham_cas)
        return float(E)

    def run(self, Ham, nelec=None, dm0=None, **kwargs):
        if nelec is None:
            raise ValueError("GCASCI.run requires nelec")
        dev = self.device
        n = Ham.norb
        ncas, nelecas = self.ncas, self.nelecas
        ncore = nelec - nelecas
        assert ncore >= 0 and ncore + ncas <= n
        h1, g = _ints_restricted(Ham, dev)

        with stage("CAS reference SCF", dev):
            e_hf, rho_hf, C, mo_e = GGHF(Ham, nelec, dm0=dm0, tol=self.tol,
                                         device=dev)
        if self.nat_orb:
            # natural orbitals of the mean-field density (dm0 if given):
            # occupations descending, core = most occupied
            src = to_host(dm0) if dm0 is not None else rho_hf
            w, v = np.linalg.eigh(src)
            C = v[:, ::-1]
        C = as_f64(np.ascontiguousarray(C), dev)
        self.e_tot = self._solve(h1, g, Ham.H0, C[:, :ncore],
                                 C[:, ncore:ncore + ncas], **kwargs)
        return self.onepdm, self.e_tot

    def make_rdm2(self, Ham=None):
        """Full-space spin-orbital 2-RDM, chemist (pq|rs) pairing
        (E2 = 0.5 sum G_pqrs (pq|rs)): embedded active twopdm + the
        single-species HF core / cross terms (exchange coefficient 1)."""
        if self.onepdm is None:
            raise RuntimeError("run GCASCI before make_rdm2")
        dev = self.device
        C_core, C_cas, Ham_cas = self._cas
        with stage("CAS rdm2", dev):
            G_act = as_f64(self.fcisolver.make_rdm2(Ham_cas), dev)[0]
            Dc = C_core @ C_core.T
            Da = C_cas @ as_f64(self.fcisolver.onepdm, dev)[0] @ C_cas.T
            G = _back(G_act, C_cas, C_cas) + _cas_terms(Dc, Da, 1.0)
        self.twopdm = G[None]
        return self.twopdm

    def run_dmet_ham(self, Ham, **kwargs):
        """Scaled-Hamiltonian energy from the stored rdm1 / rdm2 (single
        species: E = sum h rho + 0.5 sum g G + H0)."""
        self.make_rdm2()
        h1, h2 = _ints_restricted(Ham, self.device)
        E1 = torch.sum(h1 * self.onepdm[0].T)
        E2 = torch.sum(h2 * self.twopdm[0]) * 0.5
        return float(E1 + E2) + float(Ham.H0)

    def cleanup(self):
        pass


class GCASSCF(object):
    """GSO-frame orbital-optimized CASCI with second-order orbital steps on
    generalized spin orbitals: macro-iterate GCASCI solve -> exact fixed-CI
    orbital minimization over the nonredundant rotations of the
    spin-orbital space.  Any FCI-contract solver drops in as fcisolver --
    FCI(ghf=True) in-process, or the Block bridge for GSO DMRG-SCF."""

    def __init__(self, ncas, nelecas, tol=1e-8, max_cycle=30,
                 fcisolver=None, device=torch.device("cuda"), **kwargs):
        self.ncas = ncas
        self.nelecas = nelecas
        self.tol = tol
        self.max_cycle = max_cycle
        self.fcisolver = fcisolver
        self.device = torch.device(device)
        self.onepdm = None
        self.twopdm = None
        self.e_tot = None
        self.mo_coeff = None
        self.converged = False
        self.n_macro = 0
        self.orbital = None
        self.counts = {"newton": 0, "grad": 0, "hvp": 0}

    def run(self, Ham, nelec=None, dm0=None, **kwargs):
        if nelec is None:
            raise ValueError("GCASSCF.run requires nelec")
        dev = self.device
        n = Ham.norb
        ncas, nelecas = self.ncas, self.nelecas
        ncore = nelec - nelecas
        nvirt = n - ncore - ncas
        assert ncore >= 0 and nvirt >= 0

        cas = GCASCI(ncas, nelecas, fcisolver=self.fcisolver, device=dev)
        _, E = cas.run(Ham, nelec=nelec, dm0=dm0, **kwargs)
        C_core, C_cas, _ = cas._cas
        C_full = _full_C(np.hstack([to_host(C_core), to_host(C_cas)]), n)

        h1, g = _ints_restricted(Ham, dev)
        H0 = float(Ham.H0)
        state = {}
        self.orbital = opt = _OrbitalNewton(
            _rdm_energy(h1, g, H0, state), [_rot_pairs(ncore, ncas, n)], n,
            dev)
        self.converged = False
        for macro in range(self.max_cycle):
            self.n_macro = macro + 1
            G_act = as_f64(cas.fcisolver.make_rdm2(cas._cas[2]), dev)[0]
            d_act = as_f64(cas.fcisolver.onepdm, dev)[0]
            state["D"], state["G"], _, _ = _mo_cas_rdms(n, ncore, ncas, d_act,
                                                        G_act, 1.0, dev)
            C_new = _optimize_orbitals(opt, [C_full], self.tol,
                                       self.counts)
            if C_new is None:
                self.converged = True
                break
            C_full = C_new[0]
            # re-solve the active problem in the rotated orbitals
            Ct = as_f64(C_full, dev)
            E = cas._solve(h1, g, H0, Ct[:, :ncore],
                           Ct[:, ncore:ncore + ncas])

        cas.e_tot = float(E)
        self._gcas = cas
        self._cas = cas._cas
        self.onepdm = cas.onepdm
        self.e_tot = float(E)
        self.mo_coeff = C_full
        self.fcisolver = cas.fcisolver
        return self.onepdm, self.e_tot

    def make_rdm2(self, Ham=None):
        self.twopdm = self._gcas.make_rdm2(Ham)
        return self.twopdm

    def run_dmet_ham(self, Ham, **kwargs):
        return self._gcas.run_dmet_ham(Ham, **kwargs)

    def cleanup(self):
        pass


class UCASSCF(object):
    """Unrestricted orbital-optimized CASCI with second-order orbital
    steps: macro-iterate UCASCI solve -> exact fixed-CI orbital
    minimization over per-spin nonredundant rotations,

        E(ka, kb) = sum_s Tr[h_s(k) D_s] + 1/2 Gaa.g_aa(k)
                    + 1/2 Gbb.g_bb(k) + Gab.g_ab(k),   C_s -> C_s e^{k_s},

    with the UCASCI full-space spin-resolved RDMs held fixed.  The
    static-correlation refinement for spin-polarized d-block embeddings
    where the UHF orbital window is not optimal."""

    def __init__(self, ncas, nelecas, Sz=0, tol=1e-8, max_cycle=30,
                 fcisolver=None, device=torch.device("cuda"), **kwargs):
        self.ncas = ncas
        self.nelecas = nelecas
        self.Sz = Sz
        self.tol = tol
        self.max_cycle = max_cycle
        self.fcisolver = fcisolver
        self.device = torch.device(device)
        self.onepdm = None
        self.twopdm = None
        self.e_tot = None
        self.mo_coeff = None
        self.converged = False
        self.n_macro = 0
        self.orbital = None
        self.counts = {"newton": 0, "grad": 0, "hvp": 0}

    @staticmethod
    def _core_cols(dm, nc):
        """Recover core orbital columns from the idempotent per-spin core
        density (occupied eigenvectors); host arrays."""
        if nc == 0:
            return np.zeros((dm.shape[0], 0))
        w, v = np.linalg.eigh(dm)
        return v[:, -nc:]

    def run(self, Ham, nelec=None, dm0=None, **kwargs):
        if nelec is None:
            raise ValueError("UCASSCF.run requires nelec")
        dev = self.device
        n = Ham.norb
        ncas = self.ncas
        cas = UCASCI(ncas, self.nelecas, Sz=self.Sz,
                     fcisolver=self.fcisolver, device=dev)
        _, E = cas.run(Ham, nelec=nelec, dm0=dm0, **kwargs)
        na = (nelec + self.Sz) // 2
        nb = nelec - na
        nca, ncb = na - cas.na_cas, nb - cas.nb_cas
        Aa, Ab, dmca, dmcb, _, _, _ = cas._cas
        C_full = [_full_C(np.hstack([self._core_cols(to_host(dmca), nca),
                                     to_host(Aa)]), n),
                  _full_C(np.hstack([self._core_cols(to_host(dmcb), ncb),
                                     to_host(Ab)]), n)]
        blocks = _unpack_uhf(Ham, dev)
        h1a, h1b, g_aa, g_bb, g_ab = blocks
        H0 = float(Ham.H0)
        state = {}

        def energy(Cs):
            Ca, Cb = Cs
            Da, Db, Gaa, Gbb, Gab = state["rdms"]
            return (torch.sum((Ca.T @ h1a @ Ca) * Da.T)
                    + torch.sum((Cb.T @ h1b @ Cb) * Db.T)
                    + 0.5 * torch.sum(_rot4(g_aa, Ca, Ca, Ca, Ca) * Gaa)
                    + 0.5 * torch.sum(_rot4(g_bb, Cb, Cb, Cb, Cb) * Gbb)
                    + torch.sum(_rot4(g_ab, Ca, Ca, Cb, Cb) * Gab) + H0)

        self.orbital = opt = _OrbitalNewton(
            energy, [_rot_pairs(nca, ncas, n), _rot_pairs(ncb, ncas, n)], n,
            dev)

        def mo_rdms():
            """Full-space spin-resolved (Da, Db, Gaa, Gbb, Gab) in the
            current per-spin MO bases (core | act | virt); the same CAS
            decomposition as UCASCI.make_rdm2 in the MO frame."""
            Gaa_c, Gbb_c, Gab_c = as_f64(cas.fcisolver.make_rdm2(cas._cas[4]),
                                         dev)
            da, db = cas._cas[5], cas._cas[6]
            Da, Gaa, DcA, DaA = _mo_cas_rdms(n, nca, ncas, da, Gaa_c, 1.0,
                                             dev)
            Db, Gbb, DcB, DaB = _mo_cas_rdms(n, ncb, ncas, db, Gbb_c, 1.0,
                                             dev)
            # opposite-spin block: no exchange across species
            Gab = torch.zeros((n,) * 4, dtype=torch.float64, device=dev)
            Gab[nca:nca + ncas, nca:nca + ncas,
                ncb:ncb + ncas, ncb:ncb + ncas] = Gab_c
            Gab = Gab + _outer(DcA, DcB) + _outer(DcA, DaB) \
                + _outer(DaA, DcB)
            return Da, Db, Gaa, Gbb, Gab

        self.converged = False
        for macro in range(self.max_cycle):
            self.n_macro = macro + 1
            state["rdms"] = mo_rdms()
            C_new = _optimize_orbitals(opt, C_full, self.tol,
                                       self.counts)
            if C_new is None:
                self.converged = True
                break
            C_full = C_new
            # re-solve the active problem in the rotated orbitals
            Ca, Cb = as_f64(C_full[0], dev), as_f64(C_full[1], dev)
            Aa = Ca[:, nca:nca + ncas]
            Ab = Cb[:, ncb:ncb + ncas]
            with stage("CAS transform", dev):
                Ham_cas, dmca, dmcb = cas._ham_cas(blocks, H0, Ca[:, :nca],
                                                   Cb[:, :ncb], Aa, Ab)
            E = cas._solve_cas(Ham_cas, Aa, Ab, dmca, dmcb)

        cas.e_tot = float(E)
        self._ucas = cas
        self._cas = cas._cas
        self.onepdm = cas.onepdm
        self.e_tot = float(E)
        self.mo_coeff = np.asarray(C_full)
        self.fcisolver = cas.fcisolver
        return self.onepdm, self.e_tot

    def make_rdm2(self, Ham=None):
        self.twopdm = self._ucas.make_rdm2(Ham)
        return self.twopdm

    def run_dmet_ham(self, Ham, **kwargs):
        return self._ucas.run_dmet_ham(Ham, **kwargs)

    def cleanup(self):
        pass
