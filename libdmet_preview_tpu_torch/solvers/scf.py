"""
Embedded mean field on an `Integral` (PyTorch port of
libdmet_preview_tpu/solvers/scf.py: _veff_uhf, _eigh_gen, SCF.HF,
SCFSolver, ao2mo_Ham, restore_Ham, and the GSO mean field _veff_ghf,
GGHF, separate_basis, GGHF_mu).

The Fock builds (J/K from the spin-blocked embedding ERIs, n^4 work) run on
the solver's device; the tiny n x n steps around them (generalized eigh,
DIIS, aufbau densities) run on the host in NumPy, as in the JAX package.
The orbital-rotation minimization takes its gradient from torch.autograd
through torch.linalg.matrix_exp on the device and steps with scipy's BFGS
on the host: one device-to-host read per energy evaluation.  The embedded
HF counts "scf roothaan steps" (one per Roothaan iteration) and "scf
rotation steps" (one per energy evaluation of the rotation minimization)
through utils.timer.
"""

import numpy as np
import scipy.linalg as sla
import torch

from libdmet_preview_tpu_torch.utils import logger as log
from libdmet_preview_tpu_torch.utils import timer
from libdmet_preview_tpu_torch.utils.misc import as_f64, host_blas_threads
from libdmet_preview_tpu_torch.ops.diis import DIIS
from libdmet_preview_tpu_torch.models.integral import Integral, restore_eri


def _veff_uhf(dma, dmb, eri_aa, eri_bb, eri_ab):
    """Per-spin veff from blocked ERIs (chemist (pq|rs); eri_ab = (aa|bb))."""
    ja = torch.einsum("pqrs, sr -> pq", eri_aa, dma)
    jb = torch.einsum("pqrs, sr -> pq", eri_bb, dmb)
    jab = torch.einsum("pqrs, sr -> pq", eri_ab, dmb)   # J on alpha from beta
    jba = torch.einsum("pqrs, qp -> rs", eri_ab, dma)   # J on beta from alpha
    ka = torch.einsum("prqs, sr -> pq", eri_aa, dma)
    kb = torch.einsum("prqs, sr -> pq", eri_bb, dmb)
    return ja + jab - ka, jb + jba - kb


def _eigh_gen(F, S=None):
    if S is None:
        return np.linalg.eigh(F)
    L = np.linalg.cholesky(S)
    Li = np.linalg.inv(L)
    w, c = np.linalg.eigh(Li @ F @ Li.T)
    return w, Li.T @ c


def _host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _s1_block(b, n, device):
    """One H2 block as an s1 (n,)*4 float64 tensor on `device`."""
    if not (isinstance(b, torch.Tensor) and b.ndim == 4):
        b = restore_eri(_host(b), n, symmetry=1)
    return as_f64(b, device)


class SCF(object):
    """Embedded HF engine on `device`.

    Usage (mirrors the reference scf.SCF contract):
        myscf = SCF(device=...)
        myscf.set_system(nelec, spin, bogoliubov, restricted)
        myscf.set_integral(Ham)
        E, rho = myscf.HF(tol=1e-10)

    newton_ah is stored and read nowhere, as in the JAX package.
    """

    def __init__(self, newton_ah=False, device=torch.device("cuda")):
        self.newton_ah = newton_ah
        self.device = torch.device(device)
        self.nelec = None
        self.spin = 0          # 2*Sz
        self.restricted = True
        self.bogoliubov = False
        self.integral = None
        self.mo_coeff = None
        self.mo_energy = None
        self.mo_occ = None
        self.e_tot = None
        self.rdm1 = None
        self.converged = False
        self.cycles = 0            # Roothaan iterations of the last HF
        self.oo_iterations = []    # BFGS iterations of each rotation solve
        self.oo_evaluations = []   # and its energy evaluations

    def set_system(self, nelec, spin, bogoliubov, restricted):
        assert not bogoliubov, "use HFB path for Bogoliubov"
        self.nelec = nelec
        self.spin = spin
        self.restricted = restricted

    def set_integral(self, integral):
        self.integral = integral

    # ------------------------------------------------------------------
    def _dev(self, x):
        return as_f64(x, self.device)

    def _eris_s1(self):
        """The s1 (n,)*4 ERI blocks ([eri] or [aa, bb, ab]) on the device."""
        H2 = self.integral.H2["ccdd"]
        return tuple(_s1_block(H2[i], self.integral.norb, self.device)
                     for i in range(1 if len(H2) == 1 else 3))

    def _fock(self, dm, h1, eris):
        """Per-spin Fock matrices (host) from the (2, n, n) host density."""
        dma, dmb = self._dev(dm[0]), self._dev(dm[1])
        if len(eris) == 1:
            va, vb = _veff_uhf(dma, dmb, eris[0], eris[0], eris[0])
        else:
            va, vb = _veff_uhf(dma, dmb, *eris)
        h1a = h1[0]
        h1b = h1[1] if h1.shape[0] == 2 else h1[0]
        return h1a + _host(va), h1b + _host(vb)

    def _energy(self, dm, Fa, Fb, h1):
        h1a = h1[0]
        h1b = h1[1] if h1.shape[0] == 2 else h1[0]
        return 0.5 * (np.sum((h1a + Fa) * dm[0])
                      + np.sum((h1b + Fb) * dm[1])) \
            + float(self.integral.H0)

    def _oo_minimize(self, dm0, h1, eris, na, nb, S, same_spin, tol):
        """Direct orbital-rotation minimization E(C0 exp(K)) with torch
        autograd gradients + scipy BFGS (robust where Roothaan+DIIS
        oscillates; plays the role of the reference's newton_ah path)."""
        from scipy.optimize import minimize as sp_minimize
        n = h1.shape[-1]
        Fa, Fb = self._fock(dm0, h1, eris)
        wa, Ca0 = _eigh_gen(Fa, S)
        wb, Cb0 = _eigh_gen(Fb, S)
        h1a = self._dev(h1[0])
        h1b = self._dev(h1[1] if h1.shape[0] == 2 else h1[0])
        tri = np.tril_indices(n, -1)
        tri_t = tuple(torch.as_tensor(t, device=self.device) for t in tri)
        nrot = len(tri[0])
        Ca0t, Cb0t = self._dev(Ca0), self._dev(Cb0)
        e_aa = eris[0]
        e_bb = eris[0] if len(eris) == 1 else eris[1]
        e_ab = eris[0] if len(eris) == 1 else eris[2]

        def unpack(p):
            K = torch.zeros((n, n), dtype=p.dtype, device=p.device)
            K = K.index_put(tri_t, p)
            return K - K.T

        def energy(params):
            Ka = unpack(params[:nrot])
            Kb = Ka if same_spin else unpack(params[nrot:])
            Ca = Ca0t @ torch.linalg.matrix_exp(Ka)
            Cb = Cb0t @ torch.linalg.matrix_exp(Kb)
            dma = Ca[:, :na] @ Ca[:, :na].T
            dmb = Cb[:, :nb] @ Cb[:, :nb].T
            va, vb = _veff_uhf(dma, dmb, e_aa, e_bb, e_ab)
            return 0.5 * (torch.sum((2 * h1a + va) * dma)
                          + torch.sum((2 * h1b + vb) * dmb))

        def fun(p):
            timer.count("scf rotation steps")
            pt = self._dev(p).requires_grad_(True)
            E = energy(pt)
            (g,) = torch.autograd.grad(E, pt)
            return float(E.detach()), _host(g)

        nparam = nrot if same_spin else 2 * nrot
        # small deterministic start offset: lets BFGS escape exact saddles
        x0 = np.random.RandomState(7).randn(nparam) * 1e-3
        with host_blas_threads():
            res = sp_minimize(fun, x0, jac=True, method="BFGS",
                              options={"gtol": max(tol * 10, 1e-9),
                                       "maxiter": 2000})
        self.oo_iterations.append(int(res.nit))
        self.oo_evaluations.append(int(res.nfev))
        p = res.x
        Ka = _host(unpack(self._dev(p[:nrot])))
        Kb = Ka if same_spin else _host(unpack(self._dev(p[nrot:])))
        Ca = Ca0 @ sla.expm(Ka)
        Cb = Cb0 @ sla.expm(Kb)
        dm = np.asarray([Ca[:, :na] @ Ca[:, :na].T,
                         Cb[:, :nb] @ Cb[:, :nb].T])
        return dm, res.fun + float(self.integral.H0), bool(res.success)

    def HF(self, tol=1e-10, MaxIter=100, InitGuess=None, DiisDim=8,
           damping=0.0, level_shift=0.0):
        Ham = self.integral
        n = Ham.norb
        nelec = self.nelec
        na = (nelec + self.spin) // 2
        nb = nelec - na
        tol = max(tol, 1e-12)
        S = None if Ham.ovlp is None else _host(Ham.ovlp)
        if S is not None and S.ndim == 3:
            S = S[0]
        if S is not None and np.allclose(S, np.eye(n), atol=1e-12):
            S = None
        Seye = np.eye(n) if S is None else S

        h1 = _host(Ham.H1["cd"])
        eris = self._eris_s1()
        restricted = self.restricted and len(eris) == 1 and na == nb \
            and h1.shape[0] == 1

        if InitGuess is not None:
            dm = _host(InitGuess)
            if dm.ndim == 2:
                dm = np.asarray([dm * 0.5, dm * 0.5])
        else:
            h1a_g, h1b_g = h1[0], h1[1] if h1.shape[0] == 2 else h1[0]
            if not restricted:
                # seed symmetry breaking: alternating on-site staggered
                # field with opposite sign per spin (AFM-like); a symmetric
                # UHF solution is recovered if it is the true minimum
                pol = 0.1 * np.diag([(-1.0) ** i for i in range(n)])
                h1a_g = h1a_g + pol
                h1b_g = h1b_g - pol
            wa, ca = _eigh_gen(h1a_g, S)
            dm_a = (ca[:, :na] @ ca[:, :na].T)
            wb, cb = _eigh_gen(h1b_g, S)
            dm_b = (cb[:, :nb] @ cb[:, :nb].T)
            dm = np.asarray([dm_a, dm_b])

        diis = DIIS(space=DiisDim)
        e_old = np.inf
        conv = False
        wa = wb = None
        ca = cb = None
        for it in range(MaxIter):
            timer.count("scf roothaan steps")
            self.cycles = it + 1
            Fa, Fb = self._fock(dm, h1, eris)
            if restricted:
                Fb = Fa = 0.5 * (Fa + Fb)
            E = self._energy(dm, Fa, Fb, h1)

            erra = Fa @ dm[0] @ Seye - Seye @ dm[0] @ Fa
            errb = Fb @ dm[1] @ Seye - Seye @ dm[1] @ Fb
            err_norm = max(np.max(np.abs(erra)), np.max(np.abs(errb)))
            if err_norm < 1.0:  # DIIS only once errors are sane
                F_flat = diis.update(
                    np.hstack([Fa.ravel(), Fb.ravel()]),
                    xerr=np.hstack([erra.ravel(), errb.ravel()]))
                Fa = F_flat[:n * n].reshape(n, n)
                Fb = F_flat[n * n:].reshape(n, n)
            if level_shift > 0:
                Fa = Fa + level_shift * (Seye - Seye @ dm[0] @ Seye)
                Fb = Fb + level_shift * (Seye - Seye @ dm[1] @ Seye)

            wa, ca = _eigh_gen(Fa, S)
            wb, cb = _eigh_gen(Fb, S)
            dm_new = np.asarray([ca[:, :na] @ ca[:, :na].T,
                                 cb[:, :nb] @ cb[:, :nb].T])
            if damping > 0:
                dm_new = (1 - damping) * dm_new + damping * dm
            dm = dm_new
            if abs(E - e_old) < tol and err_norm < np.sqrt(tol):
                conv = True
                e_old = E
                break
            e_old = E

        if not conv:
            # second chance: direct orbital optimization (always lands on a
            # stationary point; Roothaan oscillation-proof).  If the result
            # is non-aufbau (a saddle), restart from the aufbau density of
            # its canonical Fock -- each restart lowers the energy.
            log.info("embedded HF: Roothaan+DIIS stalled, switching to "
                     "orbital-rotation minimization")
            for attempt in range(6):
                dm, E, ok = self._oo_minimize(dm, h1, eris, na, nb, S,
                                              same_spin=restricted, tol=tol)
                Fa, Fb = self._fock(dm, h1, eris)
                if restricted:
                    Fa = Fb = 0.5 * (Fa + Fb)
                wa, ca = _eigh_gen(Fa, S)
                wb, cb = _eigh_gen(Fb, S)
                dm_chk = np.asarray([ca[:, :na] @ ca[:, :na].T,
                                     cb[:, :nb] @ cb[:, :nb].T])
                ddm = np.max(np.abs(dm_chk - dm))
                if ddm < 1e-5:
                    dm = dm_chk
                    conv = ok
                    break
                log.info("embedded HF: non-aufbau stationary point "
                         "(ddm = %.2e), restarting from aufbau filling", ddm)
                dm = dm_chk
            else:
                log.warn("embedded HF: stuck on a non-aufbau stationary "
                         "point (ddm = %.2e)", ddm)
                conv = ok
            e_old = self._energy(dm, *self._fock(dm, h1, eris), h1)

        if conv and not restricted:
            # UHF stability refinement: Roothaan happily converges to the
            # spin-symmetric SADDLE; re-minimize orbital rotations from the
            # solution and adopt any lower symmetry-broken minimum
            dm2, E2, ok2 = self._oo_minimize(dm, h1, eris, na, nb, S,
                                             same_spin=False, tol=tol)
            if ok2 and E2 < e_old - 1e-9:
                log.info("embedded UHF: found lower symmetry-broken "
                         "solution (dE = %.3e)", E2 - e_old)
                dm = dm2
                Fa, Fb = self._fock(dm, h1, eris)
                wa, ca = _eigh_gen(Fa, S)
                wb, cb = _eigh_gen(Fb, S)
                dm_chk = np.asarray([ca[:, :na] @ ca[:, :na].T,
                                     cb[:, :nb] @ cb[:, :nb].T])
                if np.max(np.abs(dm_chk - dm)) < 1e-5:
                    dm = dm_chk
                e_old = self._energy(dm, *self._fock(dm, h1, eris), h1)

        self.converged = conv
        if not conv:
            log.warn("embedded HF not converged")
        self.mo_energy = np.asarray([wa, wb])
        self.mo_coeff = np.asarray([ca, cb])
        occa = np.zeros(n)
        occa[:na] = 1
        occb = np.zeros(n)
        occb[:nb] = 1
        self.mo_occ = np.asarray([occa, occb])
        self.e_tot = e_old
        self.rdm1 = dm if not restricted else dm[:1] * 2.0
        if restricted:
            self.mo_energy = self.mo_energy[:1]
            self.mo_coeff = self.mo_coeff[:1]
            self.mo_occ = self.mo_occ[:1] * 2.0
        return e_old, dm


class SCFSolver(object):
    """HF-as-impurity-solver: run(ImpHam, nelec) -> (rdm1 (spin, n, n)
    tensor on `device`, E)."""

    def __init__(self, restricted=False, Sz=0, tol=1e-10, max_cycle=200,
                 device=torch.device("cuda"), **kwargs):
        self.restricted = restricted
        self.Sz = Sz
        self.tol = tol
        self.max_cycle = max_cycle
        self.device = torch.device(device)
        self.scf = None
        self.onepdm = None
        self.twopdm = None

    def run(self, Ham, nelec=None, dm0=None, **kwargs):
        if nelec is None:
            raise ValueError("SCFSolver.run requires nelec")
        self.scf = SCF(device=self.device)
        self.scf.set_system(nelec, self.Sz, False, self.restricted)
        self.scf.set_integral(Ham)
        E, dm = self.scf.HF(tol=self.tol, MaxIter=self.max_cycle,
                            InitGuess=dm0)
        dm = as_f64(dm, self.device)
        if Ham.restricted:
            self.onepdm = (0.5 * (dm[0] + dm[1]))[None]
        else:
            self.onepdm = dm
        return self.onepdm, E

    def make_rdm2(self, Ham=None):
        """HF 2-RDM from the 1-RDM (for run_dmet_ham)."""
        dm = self.onepdm
        if dm.shape[0] == 1:
            # restricted combined-block convention (matches FCI solver)
            d = dm[0] * 2.0  # total density
            G = (torch.einsum("pq, rs -> pqrs", d, d)
                 - 0.5 * torch.einsum("ps, rq -> pqrs", d, d))
            self.twopdm = G[None]
        else:
            da, db = dm[0], dm[1]
            Gaa = (torch.einsum("pq, rs -> pqrs", da, da)
                   - torch.einsum("ps, rq -> pqrs", da, da))
            Gbb = (torch.einsum("pq, rs -> pqrs", db, db)
                   - torch.einsum("ps, rq -> pqrs", db, db))
            Gab = torch.einsum("pq, rs -> pqrs", da, db)
            self.twopdm = torch.stack([Gaa, Gbb, Gab])
        return self.twopdm

    def run_dmet_ham(self, Ham, **kwargs):
        self.make_rdm2()
        r1, r2 = self.onepdm, self.twopdm
        dev = r1.device
        n = Ham.norb

        def s1(b):
            return _s1_block(b, n, dev)

        H1 = as_f64(Ham.H1["cd"], dev)
        H2 = Ham.H2["ccdd"]
        if Ham.restricted:
            h2 = s1(H2[0])
            E1 = 2.0 * torch.sum(H1[0] * r1[0])
            # restricted combined-block convention: G_tot with 0.5 prefactor
            d = r1[0] * 2.0
            Gtot = (torch.einsum("pq, rs -> pqrs", d, d)
                    - 0.5 * torch.einsum("ps, rq -> pqrs", d, d))
            E2 = 0.5 * torch.sum(h2 * Gtot)
        else:
            E1 = torch.sum(H1[0] * r1[0]) + torch.sum(H1[1] * r1[1])
            E2 = 0.5 * torch.sum(s1(H2[0]) * r2[0]) \
                + 0.5 * torch.sum(s1(H2[1]) * r2[1]) \
                + torch.sum(s1(H2[2]) * r2[2])
        return float(E1 + E2) + float(Ham.H0)

    def cleanup(self):
        pass


def ao2mo_Ham(Ham, C, device=torch.device("cuda")):
    """Rotate an Integral into an MO basis on `device`: H1/H2 transformed
    per spin; H0 unchanged.  The result's blocks are tensors on `device`.

    C: (nao, nmo) or (spin, nao, nmo).  Restricted Integrals stay
    restricted; unrestricted rotate each spin block (H2 spin order
    [aa, bb, ab])."""
    device = torch.device(device)
    n = Ham.norb
    H1 = as_f64(Ham.H1["cd"], device)
    spin = H1.shape[0]
    C = as_f64(C, device)
    if C.ndim == 2:
        C = C[None].expand(spin, -1, -1)
    nmo = C.shape[-1]

    def t4(g, ca, cb):
        return torch.einsum("pqrs, pi, qj, rk, sl -> ijkl", g, ca, ca, cb, cb)

    h1 = C.transpose(-1, -2) @ H1 @ C
    H2 = Ham.H2["ccdd"]
    if len(H2) == 1:
        g_mo = t4(_s1_block(H2[0], n, device), C[0], C[0])[None]
    else:
        gs = [_s1_block(H2[i], n, device) for i in range(3)]
        g_mo = torch.stack([t4(gs[0], C[0], C[0]), t4(gs[1], C[1], C[1]),
                            t4(gs[2], C[0], C[1])])
    return Integral(nmo, Ham.restricted, Ham.bogoliubov, Ham.H0,
                    {"cd": h1}, {"ccdd": g_mo})


def restore_Ham(Ham_mo, C, ovlp=None, device=torch.device("cuda")):
    """Back-rotate an MO-basis Integral to the original basis (inverse of
    ao2mo_Ham for S-orthonormal C): X_ao = (S C) X_mo (S C)^T, i.e.
    ao2mo_Ham with the rotation (S C)^T."""
    C = _host(C)
    n = C.shape[-2]
    S = np.eye(n) if ovlp is None else _host(ovlp)
    return ao2mo_Ham(Ham_mo, np.swapaxes(S @ C, -1, -2), device=device)


# ----------------------------------------------------------------------
# GSO (generalized spin-orbital) mean field
# ----------------------------------------------------------------------

def _veff_ghf(dm, eri):
    """Single-species (generalized spin-orbital) veff: J - K with full
    exchange; tensors on one device."""
    vj = torch.einsum("pqrs, sr -> pq", eri, dm)
    vk = torch.einsum("psrq, sr -> pq", eri, dm)
    return vj - vk


def _ghf_eri(Ham, device):
    return _s1_block(Ham.H2["ccdd"][0], Ham.norb, device)


def _aufbau(F, nelec):
    """(rho, C, mo_energy) of the nelec lowest levels of the host F."""
    ew, ev = np.linalg.eigh(F)
    return ev[:, :nelec] @ ev[:, :nelec].T, ev, ew


def GGHF(Ham, nelec, dm0=None, tol=1e-11, max_cycle=200, diis_dim=8,
         v_ext=None, device=torch.device("cuda")):
    """Generalized HF on a dense spin-orbital Integral: one fermion species
    over all norb spin orbitals, F = h + J(rho) - K(rho), aufbau occupation
    of nelec orbitals, Pulay DIIS on the Fock commutator.  The J - K
    builds run on `device`, the n x n steps on the host.

    v_ext: optional static one-body addition (e.g. a fitted -mu*Na+mu*Nb).
    Returns (E, rho, C, mo_energy) with host arrays; E includes Ham.H0 and
    the v_ext one-body contribution."""
    device = torch.device(device)
    n = Ham.norb
    h1 = _host(Ham.H1["cd"][0])
    if v_ext is not None:
        h1 = h1 + _host(v_ext)
    g = _ghf_eri(Ham, device)

    def veff(rho):
        return _veff_ghf(as_f64(rho, device), g).cpu().numpy()

    if dm0 is None:
        rho = _aufbau(h1, nelec)[0]
    else:
        rho = _host(dm0)
    diis = DIIS(space=diis_dim)
    E_old = np.inf
    for it in range(max_cycle):
        F = h1 + veff(rho)
        err = F @ rho - rho @ F
        if np.abs(err).max() < 1.0:
            F = diis.update(F.ravel(), xerr=err.ravel()).reshape(n, n)
        rho, ev, ew = _aufbau(F, nelec)
        E = float(np.sum(h1 * rho) + 0.5 * np.sum(veff(rho) * rho))
        if abs(E - E_old) < tol and np.abs(err).max() < np.sqrt(tol):
            E_old = E
            break
        E_old = E
    return E_old + float(Ham.H0), rho, ev, ew


def separate_basis(basis):
    """Split a GSO embedding basis (ncells, nso, neo) into the particle
    (alpha-LO) and hole (beta-LO) row blocks."""
    nao = basis.shape[-2] // 2
    return basis[..., :nao, :], basis[..., nao:, :]


def GGHF_mu(Ham, nelec, nelec_target, mu0=0.0, basis=None, dm0=None,
            tol=1e-11, tol_nelec=1e-8, max_cycle=200, mu_bracket=2.0,
            device=torch.device("cuda")):
    """GSO HF with in-loop chemical-potential fitting: the determinant
    holds a FIXED number of transformed particles (nelec spin orbitals
    occupied) while the physical electron count

        n_phys(rho) = tr_a(rho_LO) - tr_b(rho_LO) + nao * ncells

    is driven to nelec_target by a monotone bisection over mu at every SCF
    step, with v_mu = (-mu on particle rows, +mu on hole rows) transformed
    to the embedding basis.  The J - K builds run on `device`, the n x n
    eighs of the bisection on the host.

    basis: GSO embedding basis (ncells, nso, neo), array or tensor; when
    None, the Hamiltonian orbitals are themselves the particle / hole
    blocks.  Returns (E, rho, C, mo_energy, mu) with host arrays."""
    device = torch.device(device)
    n = Ham.norb
    h1 = _host(Ham.H1["cd"][0])
    g = _ghf_eri(Ham, device)

    def veff(rho):
        return _veff_ghf(as_f64(rho, device), g).cpu().numpy()

    if basis is None:
        nao = n // 2
        Na = np.diag(np.r_[np.ones(nao), np.zeros(n - nao)])
        Nb = np.diag(np.r_[np.zeros(nao), np.ones(n - nao)])
        n_offset = float(nao)
    else:
        Ra, Rb = separate_basis(_host(basis))
        ncells, nao = Ra.shape[0], Ra.shape[1]
        Na = np.einsum("rap, raq -> pq", Ra, Ra)
        Nb = np.einsum("rap, raq -> pq", Rb, Rb)
        n_offset = float(nao * ncells)
    v_unit = -Na + Nb                      # dv/dmu

    def n_phys(rho):
        return float(np.sum(rho * Na) - np.sum(rho * Nb)) + n_offset

    def fit_mu(F, mu_guess):
        """Monotone bisection: n_phys of the aufbau density of
        F + mu*v_unit is non-decreasing in mu."""
        def n_of(mu):
            return n_phys(_aufbau(F + mu * v_unit, nelec)[0])
        lo, hi = mu_guess - mu_bracket, mu_guess + mu_bracket
        k = 0
        while n_of(lo) > nelec_target and k < 30:
            lo -= mu_bracket * 2
            k += 1
        k = 0
        while n_of(hi) < nelec_target and k < 30:
            hi += mu_bracket * 2
            k += 1
        mu = mu_guess
        for _ in range(100):
            mu = 0.5 * (lo + hi)
            nm = n_of(mu)
            if abs(nm - nelec_target) < tol_nelec:
                break
            if nm < nelec_target:
                lo = mu
            else:
                hi = mu
        return mu

    if dm0 is None:
        mu = fit_mu(h1, mu0)
        rho, ev, ew = _aufbau(h1 + mu * v_unit, nelec)
    else:
        rho, mu = _host(dm0), mu0
    diis = DIIS(space=8)
    E_old = np.inf
    for it in range(max_cycle):
        F0 = h1 + veff(rho)
        mu = fit_mu(F0, mu)
        F = F0 + mu * v_unit
        err = F @ rho - rho @ F
        if np.abs(err).max() < 1.0:
            F0 = diis.update(F0.ravel(), xerr=err.ravel()).reshape(n, n)
            mu = fit_mu(F0, mu)
            F = F0 + mu * v_unit
        rho, ev, ew = _aufbau(F, nelec)
        # energy of the mu-free Hamiltonian (mu is a constraint device)
        E = float(np.sum(h1 * rho) + 0.5 * np.sum(veff(rho) * rho))
        if abs(E - E_old) < tol and np.abs(err).max() < np.sqrt(tol):
            E_old = E
            break
        E_old = E
    return E_old + float(Ham.H0), rho, ev, ew, mu
