"""
Plain reference of UHF-DMET with a non-interacting bath and a coupled-
cluster (CCSD) impurity solver on the three-band (Emery) lattice in the
hole picture, in PyTorch and NumPy at a chosen dtype.  The mean field,
bath, embedding Hamiltonian, fit, trace fix and DIIS are those of
reference/model.py (imported); this module adds the hole-picture lattice
and replaces the impurity solve.  It imports nothing of the program.

The conventions it states (they define the method and the benchmark holds
the program to them):
  * hole picture of the published table, as it stands: e_d = -D_pd on the
    Cu, e_p = 0; Cu-O hopping +t_pd * s, s the sign of the larger
    component of the vector from Cu to O; O-O hopping +t_pp * sign(dx *
    dy); U_d / U_p on site and V_pd on the Cu-O bonds inside the impurity
    cell, as in the electron picture of reference/model.py; the lattice
    holds `filling` holes per spin-orbital;
  * the chemical potential of the impurity: -dmu on every impurity
    orbital of the embedding one-body term, so dmu > 0 draws holes onto
    the impurity; the dmu search and the energy are reference/loop.py's;
  * the embedding problem holds as many holes of each spin as impurity
    orbitals.

The solve, in the order it runs:
  1. UHF of the embedding problem (orthonormal basis): the start is the
     aufbau density of h1 + P per spin, P = +0.1 diag((-1)^p) for alpha
     and -P for beta over the embedding orbitals p (impurity first);
     then Roothaan steps with Pulay DIIS on the commutators F D - D F of
     both spins, until the energy changes by less than 1e-12 and the
     commutators are below 1e-10 (float64);
  2. its stability: the Hessian of the UHF energy in the occupied-virtual
     rotations of both spins, at the solution, from a second-order
     expansion of exp(K); where its lowest eigenvalue is negative the
     determinant is rotated along that eigenvector (the step of lowest
     energy of a few lengths) and step 1 is repeated from there, until
     the Hessian has no negative eigenvalue;
  3. spin-orbital CCSD (Stanton and Gauss, J. Chem. Phys. 94, 4334
     (1991), in the non-canonical form of Crawford and Schaefer, Rev.
     Comp. Chem. 14, 33 (2000)) on the orbitals [occ a, occ b, vir a,
     vir b]: Jacobi steps t <- t + R / D, D the orbital-energy
     differences of the diagonal Fock, with Pulay DIIS, until max |R| <
     1e-11;
  4. the Lambda equations dE/dt + lambda dR/dt = 0 in the unique
     amplitudes (t1, t2[i<j, a<b]), by Jacobi steps with DIIS on vector-
     Jacobian products of the residual (torch.autograd);
  5. the one-body density as the derivative of the CC Lagrangian
     L = E(t) + lambda R(t) with respect to the MO one-body integrals at
     fixed t and lambda, taken back to the embedding basis per spin.

Where the density departs from the textbook's (1 + Lambda) expectation
value: none in value, since dL/dh is that expectation value; it is the
unrelaxed density (the orbitals do not respond to the integrals, so no
orbital-response term), symmetrized as (gamma + gamma^T) / 2, in a non-
canonical UHF basis (the Fock's off-diagonal occupied-virtual block
vanishes, the others need not).
"""

import numpy as np
import torch

from perfbench.reference import model

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# (float64, float32): tolerances of each solve at the reference's dtype
_TOL = {torch.float64: {"e": 1e-12, "comm": 1e-10, "amp": 1e-11,
                        "lam": 1e-11, "hess": 1e-6},
        torch.float32: {"e": 1e-6, "comm": 1e-5, "amp": 3e-5,
                        "lam": 3e-5, "hess": 1e-3}}


def hole_params(p):
    """The published (hole-picture) table as the lattice's terms."""
    return {"ed": -p["D_pd"], "tpd": p["tpd"], "tpp": p["tpp"],
            "tpp1": p.get("tpp1", 0.0), "Ud": p["Ud"], "Up": p["Up"],
            "Vpd": p["Vpd"]}


class HoleLattice(model.Lattice):
    """The three-band lattice of a hole-picture configuration: the
    geometry and the bond rules of model.Lattice with the table's
    hole-picture terms."""

    def __init__(self, cfg):
        ref = cfg["reference"]
        if (list(cfg["lattice"]["supercell"]) != [1, 1]
                or cfg["representation"] != "hole"
                or not cfg["ignore_intercell"]
                or not cfg["dmet"]["use_hcore_as_emb_ham"]):
            raise ValueError("the reference holds the impurity = one cell,"
                             " the hole picture, V_pd inside the cell and"
                             " the bare embedding H1 only")
        self.a = np.asarray(ref["cell_vectors"], dtype=float)
        self.names = [s[0] for s in ref["sites"]]
        self.pos = np.asarray([s[1] for s in ref["sites"]], dtype=float)
        self.mesh = tuple(int(x) for x in cfg["lattice"]["size"])
        self.nsc = len(self.names)
        self.ncells = int(np.prod(self.mesh))
        self.N = self.ncells * self.nsc
        self.p = hole_params(cfg["parameters"])
        cells = np.array([(i, j) for i in range(self.mesh[0])
                          for j in range(self.mesh[1])], dtype=float)
        self.r = ((cells @ self.a)[:, None, :] + self.pos[None]) \
            .reshape(-1, 2)
        self.site_name = self.names * self.ncells
        self.h = self._one_body()
        self.eri = self._unit_eri()


# ----------------------------------------------------------------------
# UHF of the embedding problem
# ----------------------------------------------------------------------

def _veff(g, da, db):
    """Per-spin J - K of chemist integrals g (one block for both spins)."""
    j = torch.einsum("pqrs,rs->pq", g, da + db)
    return (j - torch.einsum("prsq,rs->pq", g, da),
            j - torch.einsum("prsq,rs->pq", g, db))


def _uhf_energy(h, g, da, db):
    va, vb = _veff(g, da, db)
    return 0.5 * (torch.sum((2.0 * h[0] + va) * da)
                  + torch.sum((2.0 * h[1] + vb) * db))


def _aufbau(F, ne):
    e, C = torch.linalg.eigh(F)
    return C[:, :ne] @ C[:, :ne].T, C


class _Pulay(object):
    """Pulay DIIS on flat vectors: extrapolates x from the stored (x,
    err) pairs."""

    def __init__(self, space=8):
        self.space, self.xs, self.errs = space, [], []

    def __call__(self, x, err):
        self.xs = (self.xs + [x])[-self.space:]
        self.errs = (self.errs + [err])[-self.space:]
        n = len(self.xs)
        E = torch.stack(self.errs)
        B = torch.zeros((n + 1, n + 1), dtype=torch.float64)
        B[:n, :n] = (E @ E.T).double().cpu()
        B[n, :n] = B[:n, n] = -1.0
        rhs = torch.zeros(n + 1, dtype=torch.float64)
        rhs[n] = -1.0
        try:
            c = torch.linalg.solve(B, rhs)[:n]
        except RuntimeError:
            return x
        if not torch.isfinite(c).all():
            return x
        return c.to(x.dtype).to(x.device) @ torch.stack(self.xs)


def roothaan(h, g, ne, d0, tol, max_iter=500):
    """Roothaan steps with DIIS from the densities d0 (2, n, n): the
    converged densities and canonical orbitals (Ca, Cb)."""
    n = h.shape[-1]
    da, db = d0
    diis = _Pulay()
    e_old = None
    for _ in range(max_iter):
        va, vb = _veff(g, da, db)
        Fa, Fb = h[0] + va, h[1] + vb
        e = float(0.5 * (torch.sum((h[0] + Fa) * da)
                         + torch.sum((h[1] + Fb) * db)))
        ra, rb = Fa @ da - da @ Fa, Fb @ db - db @ Fb
        comm = float(max(ra.abs().max(), rb.abs().max()))
        if (e_old is not None and abs(e - e_old) < tol["e"]
                and comm < tol["comm"]):
            break
        e_old = e
        F = diis(torch.cat([Fa.reshape(-1), Fb.reshape(-1)]),
                 torch.cat([ra.reshape(-1), rb.reshape(-1)]))
        (da, Ca), (db, Cb) = (_aufbau(F[:n * n].reshape(n, n), ne[0]),
                              _aufbau(F[n * n:].reshape(n, n), ne[1]))
    else:
        raise RuntimeError("reference UHF: no convergence in %d steps"
                           % max_iter)
    va, vb = _veff(g, da, db)
    Ca = torch.linalg.eigh(h[0] + va)[1]
    Cb = torch.linalg.eigh(h[1] + vb)[1]
    return (da, db), (Ca, Cb)


def _rotated(C, no, kappa, order=None):
    """C exp(K) with K antisymmetric, its occupied-virtual block kappa
    (no, n - no); order=2 takes exp(K) to second order."""
    n = C.shape[-1]
    K = torch.zeros((n, n), dtype=C.dtype, device=C.device)
    K[:no, no:] = kappa
    K = K - K.T
    U = torch.linalg.matrix_exp(K) if order is None else \
        torch.eye(n, dtype=C.dtype, device=C.device) + K + 0.5 * K @ K
    return C @ U


def _energy_of_rotation(h, g, Ca, Cb, ne, x, order=None):
    n = h.shape[-1]
    ka = x[:ne[0] * (n - ne[0])].reshape(ne[0], n - ne[0])
    kb = x[ne[0] * (n - ne[0]):].reshape(ne[1], n - ne[1])
    A = _rotated(Ca, ne[0], ka, order)[:, :ne[0]]
    B = _rotated(Cb, ne[1], kb, order)[:, :ne[1]]
    return _uhf_energy(h, g, A @ A.T, B @ B.T)


def uhf(h, g, ne, tol, max_rounds=10):
    """The stable UHF of (h (2, n, n), g (n,)*4) with ne = (na, nb)
    particles: (Ca, Cb) canonical orbitals, occupied first."""
    n = h.shape[-1]
    pol = 0.1 * torch.diag(torch.tensor([(-1.0) ** p for p in range(n)],
                                        dtype=h.dtype, device=h.device))
    d0 = (_aufbau(h[0] + pol, ne[0])[0], _aufbau(h[1] - pol, ne[1])[0])
    nrot = ne[0] * (n - ne[0]) + ne[1] * (n - ne[1])
    for _ in range(max_rounds):
        (da, db), (Ca, Cb) = roothaan(h, g, ne, d0, tol)
        x0 = torch.zeros(nrot, dtype=h.dtype, device=h.device)
        H = torch.autograd.functional.hessian(
            lambda x: _energy_of_rotation(h, g, Ca, Cb, ne, x, order=2), x0,
            vectorize=True)
        w, V = torch.linalg.eigh(0.5 * (H + H.T))
        if float(w[0]) > -tol["hess"]:
            return Ca, Cb
        e0 = float(_uhf_energy(h, g, da, db))
        best = None
        for step in (0.05, 0.1, 0.2, 0.4, 0.8):
            e = float(_energy_of_rotation(h, g, Ca, Cb, ne, step * V[:, 0]))
            if best is None or e < best[0]:
                best = (e, step)
        if best[0] >= e0:
            raise RuntimeError("reference UHF: a negative Hessian "
                               "eigenvalue %.3e with no lower step"
                               % float(w[0]))
        x = best[1] * V[:, 0]
        A = _rotated(Ca, ne[0], x[:ne[0] * (n - ne[0])]
                     .reshape(ne[0], n - ne[0]))[:, :ne[0]]
        B = _rotated(Cb, ne[1], x[ne[0] * (n - ne[0]):]
                     .reshape(ne[1], n - ne[1]))[:, :ne[1]]
        d0 = (A @ A.T, B @ B.T)
    raise RuntimeError("reference UHF: unstable after %d rounds"
                       % max_rounds)


# ----------------------------------------------------------------------
# spin-orbital CCSD, Lambda and the response density
# ----------------------------------------------------------------------

def spin_orbital_integrals(h, g, Ca, Cb, ne):
    """h_mo (2n, 2n) and the antisymmetrized <pq||rs> (2n,)*4 over the
    spin orbitals [occ a, occ b, vir a, vir b], with the MO coefficients
    C (2n sites of both spins, 2n spin orbitals)."""
    n = h.shape[-1]
    na, nb = ne
    z = torch.zeros((n, n), dtype=h.dtype, device=h.device)
    cols = [torch.cat([Ca[:, :na], z[:, :na]]),
            torch.cat([z[:, :nb], Cb[:, :nb]]),
            torch.cat([Ca[:, na:], z[:, na:]]),
            torch.cat([z[:, nb:], Cb[:, nb:]])]
    C = torch.cat(cols, dim=1)
    hs = torch.zeros((2 * n, 2 * n), dtype=h.dtype, device=h.device)
    hs[:n, :n], hs[n:, n:] = h[0], h[1]
    gs = torch.zeros((2 * n,) * 4, dtype=h.dtype, device=h.device)
    for s in (slice(0, n), slice(n, 2 * n)):
        for t in (slice(0, n), slice(n, 2 * n)):
            gs[s, s, t, t] = g
    gmo = torch.einsum("pqrs,pi,qj,rk,sl->ijkl", gs, C, C, C, C)
    phys = gmo.permute(0, 2, 1, 3)
    return C, C.T @ hs @ C, phys - phys.permute(0, 1, 3, 2)


def _fock(hmo, W, no):
    return hmo + torch.einsum("pmqm->pq", W[:, :no, :, :no])


def residual(t1, t2, hmo, W, no):
    """(R1, R2), zero at the CCSD solution: the right-hand sides of
    Crawford and Schaefer's equations less D * t."""
    e = torch.einsum
    o, v = slice(None, no), slice(no, None)
    f = _fock(hmo, W, no)
    fd = torch.diagonal(f)
    foo = f[o, o] - torch.diag(fd[o])
    fvv = f[v, v] - torch.diag(fd[v])
    fov = f[o, v]
    D1 = fd[o][:, None] - fd[v][None, :]
    D2 = (fd[o][:, None, None, None] + fd[o][None, :, None, None]
          - fd[v][None, None, :, None] - fd[v][None, None, None, :])
    oovv, ooov, ovvv = W[o, o, v, v], W[o, o, o, v], W[o, v, v, v]
    tt = e("ia,jb->ijab", t1, t1)
    tt = tt - tt.permute(0, 1, 3, 2)
    tau_s, tau = t2 + 0.5 * tt, t2 + tt

    Fae = fvv - 0.5 * e("me,ma->ae", fov, t1) \
        + e("mf,mafe->ae", t1, ovvv) - 0.5 * e("mnaf,mnef->ae", tau_s, oovv)
    Fmi = foo + 0.5 * e("ie,me->mi", t1, fov) \
        + e("ne,mnie->mi", t1, ooov) + 0.5 * e("inef,mnef->mi", tau_s, oovv)
    Fme = fov + e("nf,mnef->me", t1, oovv)
    x = e("je,mnie->mnij", t1, ooov)
    Wmnij = W[o, o, o, o] + x - x.permute(0, 1, 3, 2) \
        + 0.25 * e("ijef,mnef->mnij", tau, oovv)
    x = e("mb,amef->abef", t1, W[v, o, v, v])
    Wabef = W[v, v, v, v] - x + x.permute(1, 0, 2, 3) \
        + 0.25 * e("mnab,mnef->abef", tau, oovv)
    Wmbej = W[o, v, v, o] + e("jf,mbef->mbej", t1, ovvv) \
        - e("nb,mnej->mbej", t1, W[o, o, v, o]) \
        - e("jnfb,mnef->mbej", 0.5 * t2 + e("jf,nb->jnfb", t1, t1), oovv)

    r1 = fov + e("ie,ae->ia", t1, Fae) - e("ma,mi->ia", t1, Fmi) \
        + e("imae,me->ia", t2, Fme) - e("nf,naif->ia", t1, W[o, v, o, v]) \
        - 0.5 * e("imef,maef->ia", t2, ovvv) \
        - 0.5 * e("mnae,nmei->ia", t2, W[o, o, v, o])

    x = e("ijae,be->ijab", t2, Fae - 0.5 * e("mb,me->be", t1, Fme))
    r2 = oovv + x - x.permute(0, 1, 3, 2)
    x = e("imab,mj->ijab", t2, Fmi + 0.5 * e("je,me->mj", t1, Fme))
    r2 = r2 - x + x.permute(1, 0, 2, 3)
    r2 = r2 + 0.5 * e("mnab,mnij->ijab", tau, Wmnij) \
        + 0.5 * e("ijef,abef->ijab", tau, Wabef)
    x = e("imae,mbej->ijab", t2, Wmbej) \
        - e("ie,ma,mbej->ijab", t1, t1, W[o, v, v, o])
    r2 = r2 + x - x.permute(1, 0, 2, 3) - x.permute(0, 1, 3, 2) \
        + x.permute(1, 0, 3, 2)
    x = e("ie,abej->ijab", t1, W[v, v, v, o])
    r2 = r2 + x - x.permute(1, 0, 2, 3)
    x = e("ma,mbij->ijab", t1, W[o, v, o, o])
    r2 = r2 - x + x.permute(0, 1, 3, 2)
    return r1 - D1 * t1, r2 - D2 * t2


def cc_energy(t1, t2, hmo, W, no):
    """E_HF + E_corr of the spin-orbital integrals."""
    o, v = slice(None, no), slice(no, None)
    f = _fock(hmo, W, no)
    e_hf = torch.einsum("ii->", hmo[o, o]) \
        + 0.5 * torch.einsum("ijij->", W[o, o, o, o])
    return e_hf + torch.sum(f[o, v] * t1) \
        + 0.25 * torch.sum(W[o, o, v, v] * t2) \
        + 0.5 * torch.einsum("ijab,ia,jb->", W[o, o, v, v], t1, t1)


class _Unique(object):
    """The unique amplitudes (t1, t2[i<j, a<b]) as one flat vector."""

    def __init__(self, no, nv, device):
        self.no, self.nv = no, nv
        io, jo = torch.triu_indices(no, no, 1, device=device)
        av, bv = torch.triu_indices(nv, nv, 1, device=device)
        self.i = io[:, None].expand(-1, len(av)).reshape(-1)
        self.j = jo[:, None].expand(-1, len(av)).reshape(-1)
        self.a = av[None, :].expand(len(io), -1).reshape(-1)
        self.b = bv[None, :].expand(len(io), -1).reshape(-1)
        self.n1 = no * nv

    def pack(self, t1, t2):
        return torch.cat([t1.reshape(-1),
                          t2[self.i, self.j, self.a, self.b]])

    def unpack(self, x):
        no, nv = self.no, self.nv
        t1 = x[:self.n1].reshape(no, nv)
        y = x[self.n1:]
        t2 = torch.zeros((no, no, nv, nv), dtype=x.dtype, device=x.device)
        t2 = t2.index_put((self.i, self.j, self.a, self.b), y)
        t2 = t2.index_put((self.j, self.i, self.a, self.b), -y)
        t2 = t2.index_put((self.i, self.j, self.b, self.a), -y)
        t2 = t2.index_put((self.j, self.i, self.b, self.a), y)
        return t1, t2


def _jacobi_diis(step, x, tol, max_iter, what):
    """x <- x + step(x) with DIIS, until max |step * D| (the residual
    step returns beside the update) is below tol."""
    diis = _Pulay()
    for _ in range(max_iter):
        dx, res = step(x)
        if res < tol:
            return x
        if not np.isfinite(res):
            break
        x = diis(x + dx, dx)
    raise RuntimeError("reference %s: no convergence (max |R| = %.3e)"
                       % (what, res))


def ccsd(h, g, Ca, Cb, ne, tol, max_iter=500):
    """(E, rdm1 (2, n, n)) of CCSD on the UHF orbitals (Ca, Cb)."""
    n = h.shape[-1]
    no = sum(ne)
    nv = 2 * n - no
    C, hmo, W = spin_orbital_integrals(h, g, Ca, Cb, ne)
    u = _Unique(no, nv, h.device)
    fd = torch.diagonal(_fock(hmo, W, no))
    D1 = fd[:no, None] - fd[None, no:]
    D2 = D1[:, None, :, None] + D1[None, :, None, :]
    D = u.pack(D1, D2)

    def r_of(x, hm=hmo):
        return u.pack(*residual(*u.unpack(x), hm, W, no))

    with torch.no_grad():
        x0 = u.pack(torch.zeros_like(D1), W[:no, :no, no:, no:] / D2)

        def amp_step(x):
            r = r_of(x)
            return r / D, float(r.abs().max())
        t = _jacobi_diis(amp_step, x0, tol["amp"], max_iter, "CCSD")

    # Lambda: (dE/dt + lambda dR/dt) = 0, dR/dt ~ -D on its diagonal
    tg = t.detach().requires_grad_(True)
    with torch.enable_grad():
        E = cc_energy(*u.unpack(tg), hmo, W, no)
        (w,) = torch.autograd.grad(E, tg)
        _, vjp = torch.func.vjp(r_of, t)

    def lam_step(lam):
        (jt,) = vjp(lam)
        r = jt + w
        return r / D, float(r.abs().max())
    lam = _jacobi_diis(lam_step, w / D, tol["lam"], max_iter, "Lambda")

    hl = hmo.detach().requires_grad_(True)
    with torch.enable_grad():
        L = cc_energy(*u.unpack(t), hl, W, no) \
            + torch.dot(lam, r_of(t, hl))
        (gam,) = torch.autograd.grad(L, hl)
    gam = 0.5 * (gam + gam.T)
    site = C @ gam @ C.T
    return float(E.detach()), torch.stack([site[:n, :n], site[n:, n:]])


class DMET(model.DMET):
    """model.DMET's steps on the hole-picture lattice, with the CCSD
    solve."""

    def __init__(self, cfg, device, dtype=torch.float64):
        self.lat = HoleLattice(cfg)
        self.device, self.dtype = torch.device(device), dtype
        self.np_dtype = np.float64 if dtype == torch.float64 else np.float32
        self.h = torch.as_tensor(self.lat.h, device=self.device).to(dtype)
        self.nsc = self.lat.nsc
        self.tol = _TOL[dtype]

    def solve(self, h1, g, dmu):
        """UHF + CCSD of the embedding problem with -dmu on the impurity
        and as many holes of each spin as impurity orbitals: (E, rdm1 (2,
        neo, neo))."""
        n = self.nsc
        h = h1.clone()
        idx = torch.arange(n, device=self.device)
        h[:, idx, idx] -= dmu
        Ca, Cb = uhf(h, g, (n, n), self.tol)
        return ccsd(h, g, Ca, Cb, (n, n), self.tol)
