"""
Plain reference of UHF-DMET with a non-interacting bath on a three-band
(Emery) lattice, in PyTorch and NumPy at a chosen dtype.  Built from the
configuration file alone: the lattice from its cell vectors and site
positions, the Hamiltonian from the published parameter table, and each
DMET step written out in real space (one dense eigenproblem of the whole
lattice per spin, no k points).  It imports nothing of the program.

The conventions it states (they define the method and the benchmark holds
the program to them):
  * electron representation of the hole-picture table: t_pd -> -t_pd,
    t_pp -> -t_pp, e_d = D_pd - U_d - 4 V_pd + U_p, e_p = 0;
  * Cu-O hopping -t_pd * s, s the sign of the larger component of the
    vector from Cu to O; O-O hopping -t_pp * sign(dx * dy); every periodic
    image within the bond length contributes;
  * U_d / U_p on site; V_pd on the Cu-O bonds inside the impurity cell;
  * vcor: per spin the upper triangle of a symmetric cell matrix, row by
    row, alpha then beta, added to every cell in the mean field and to the
    environment cells in the embedding one-body term;
  * zero-temperature occupations over both spins with one chemical
    potential: the previous mu is kept when it still separates the count,
    else mu is the mid-gap; levels within 1e-6 of mu share what is left;
  * the Schmidt bath: the left singular vectors of the environment-impurity
    block of each spin's density matrix;
  * the energy per site by democratic partitioning of the one-body term;
  * the vcor fit: || rho_mf(embedding H1 + vcor on every cell) - rho_FCI ||
    over both spins / sqrt(2), mu mid-gap at as many electrons per spin as impurity orbitals,
    levels within 1e-3 of it sharing; the trace fix and Pulay DIIS on
    successive differences as the DMET loop of the configuration states.
"""

import numpy as np
import torch
from scipy import optimize

from perfbench.reference import fci


def electron_params(p):
    """Hole-picture table -> electron-representation terms."""
    return {"ed": p["D_pd"] - p["Ud"] - 4.0 * p["Vpd"] + p["Up"],
            "tpd": -p["tpd"], "tpp": -p["tpp"], "tpp1": -p.get("tpp1", 0.0),
            "Ud": p["Ud"], "Up": p["Up"], "Vpd": p["Vpd"]}


class Lattice(object):
    """The three-band lattice of a configuration: real-space one-body
    matrix h (N, N) over N = ncells * nsc sites (cell-major, cells in
    C order over the mesh, cell 0 the impurity) and the unit-cell ERI."""

    def __init__(self, cfg):
        ref = cfg["reference"]
        # what this reference implements of the configuration's keys
        if (list(cfg["lattice"]["supercell"]) != [1, 1]
                or cfg["representation"] != "electron"
                or not cfg["ignore_intercell"]
                or not cfg["dmet"]["use_hcore_as_emb_ham"]):
            raise ValueError("the reference holds the impurity = one cell,"
                             " the electron representation, V_pd inside"
                             " the cell and the bare embedding H1 only")
        self.a = np.asarray(ref["cell_vectors"], dtype=float)
        self.names = [s[0] for s in ref["sites"]]
        self.pos = np.asarray([s[1] for s in ref["sites"]], dtype=float)
        self.mesh = tuple(int(x) for x in cfg["lattice"]["size"])
        self.nsc = len(self.names)
        self.ncells = int(np.prod(self.mesh))
        self.N = self.ncells * self.nsc
        self.p = electron_params(cfg["parameters"])
        cells = np.array([(i, j) for i in range(self.mesh[0])
                          for j in range(self.mesh[1])], dtype=float)
        self.r = (cells @ self.a)[:, None, :] + self.pos[None]
        self.r = self.r.reshape(-1, 2)
        self.site_name = self.names * self.ncells
        self.h = self._one_body()
        self.eri = self._unit_eri()

    def _images(self, search=2):
        L = np.diag(self.mesh) @ self.a
        for sx in range(-search, search + 1):
            for sy in range(-search, search + 1):
                yield np.array([sx, sy]) @ L

    def _one_body(self):
        p, N = self.p, self.N
        h = np.zeros((N, N))
        cu = np.array([n == "Cu" for n in self.site_name])
        ox = ~cu
        for T in self._images():
            d = self.r[None, :, :] + T - self.r[:, None, :]
            dist = np.linalg.norm(d, axis=-1)
            # Cu-O at distance 1: oriented from the copper to the oxygen
            pd = (np.abs(dist - 1.0) < 1e-5) & (cu[:, None] ^ cu[None, :])
            i, j = np.nonzero(pd)
            v = np.where(cu[i][:, None], d[i, j], -d[i, j])
            ax = np.argmax(np.abs(v), axis=1)
            s = np.sign(v[np.arange(len(ax)), ax])
            np.add.at(h, (i, j), p["tpd"] * s)
            pp = (np.abs(dist - np.sqrt(2.0)) < 1e-5) \
                & ox[:, None] & ox[None, :]
            i, j = np.nonzero(pp)
            s = np.where(d[i, j, 0] * d[i, j, 1] > 0, 1.0, -1.0)
            np.add.at(h, (i, j), p["tpp"] * s)
            if abs(p["tpp1"]) > 1e-10:
                pp1 = (np.abs(dist - 2.0) < 1e-5) & ox[:, None] & ox[None, :]
                i, j = np.nonzero(pp1)
                np.add.at(h, (i, j), p["tpp1"])
        if abs(p["ed"]) > 1e-10:
            h[np.nonzero(cu)[0], np.nonzero(cu)[0]] += p["ed"]
        return h

    def _unit_eri(self):
        n, p = self.nsc, self.p
        g = np.zeros((n,) * 4)
        for s in range(n):
            g[s, s, s, s] = p["Ud"] if self.names[s] == "Cu" else p["Up"]
        if abs(p["Vpd"]) > 1e-10:
            for T in self._images():
                for i in range(n):
                    for q in range(n):
                        if {self.names[i], self.names[q]} != {"Cu", "O"}:
                            continue
                        if abs(np.linalg.norm(self.pos[q] + T - self.pos[i])
                               - 1.0) < 1e-5:
                            g[q, q, i, i] += 0.5 * p["Vpd"]
                            g[i, i, q, q] += 0.5 * p["Vpd"]
        return g


def vcor_matrix(param, nsc):
    """(2, nsc, nsc) symmetric matrices from the vcor parameters."""
    iu = np.triu_indices(nsc)
    npair = len(iu[0])
    v = np.zeros((2, nsc, nsc), dtype=np.asarray(param).dtype)
    for s in range(2):
        v[s][iu] = param[s * npair:(s + 1) * npair]
        v[s] = v[s] + v[s].T - np.diag(np.diag(v[s]))
    return v


def vcor_param(v):
    iu = np.triu_indices(v.shape[-1])
    return np.concatenate([v[0][iu], v[1][iu]])


def occupy(e, nelec, thr, mu0=None):
    """Zero-temperature occupations of the levels e (any shape) with nelec
    electrons: mu0 kept when it separates the count, else the mid-gap;
    levels within thr of mu share the remainder.  Returns (occ, mu)."""
    es = np.sort(e, axis=None)
    if (mu0 is not None and np.sum(e < mu0 - thr) <= nelec
            and np.sum(e <= mu0 + thr) >= nelec):
        mu = mu0
    else:
        mu = 0.5 * (es[nelec - 1] + es[nelec])
    occ = (e < mu - thr).astype(e.dtype)
    rest = nelec - occ.sum()
    if rest > 0:
        deg = (e <= mu + thr) & (e >= mu - thr)
        occ = occ + (rest / deg.sum()) * deg
    return occ, mu


class DMET(object):
    """The steps of one DMET iteration on a Lattice, on `device` at
    `dtype`."""

    def __init__(self, cfg, device, dtype=torch.float64):
        self.lat = Lattice(cfg)
        self.device, self.dtype = torch.device(device), dtype
        self.np_dtype = np.float64 if dtype == torch.float64 else np.float32
        self.h = torch.as_tensor(self.lat.h, device=self.device).to(dtype)
        self.nsc = self.lat.nsc
        self.space = None

    def t(self, x):
        return torch.as_tensor(np.asarray(x), device=self.device) \
            .to(self.dtype)

    def fock(self, vmat, cells="all"):
        """h plus vcor on every cell (cells='all') or on the environment
        cells ('env'), per spin: (2, N, N)."""
        lat = self.lat
        out = []
        for s in range(2):
            blocks = self.t(vmat[s])[None].expand(lat.ncells, -1, -1).clone()
            if cells == "env":
                blocks[0] = 0.0
            out.append(self.h + torch.block_diag(*blocks))
        return torch.stack(out)

    def mean_field(self, vmat, filling, mu0=None):
        """Lattice mean field: rho (2, N, N), mu."""
        F = self.fock(vmat)
        e, C = torch.linalg.eigh(F)
        nelec = int(round(2 * self.lat.N * filling))
        occ, mu = occupy(e.cpu().numpy(), nelec, 1e-6, mu0)
        occ = self.t(occ)
        rho = (C * occ[:, None, :]) @ C.transpose(1, 2)
        return rho, float(mu)

    def bath(self, rho, tol=1e-9):
        """Embedding basis (2, N, neo): the impurity cell, then the left
        singular vectors of rho[env, imp] per spin."""
        n = self.nsc
        us, keep = [], []
        for s in range(2):
            u, sig, _ = torch.linalg.svd(rho[s, n:, :n], full_matrices=False)
            us.append(u)
            keep.append(int((sig >= tol).sum()))
        nb = min(keep)
        B = torch.zeros((2, self.lat.N, n + nb), dtype=self.dtype,
                        device=self.device)
        for s in range(2):
            B[s, :n, :n] = torch.eye(n, dtype=self.dtype, device=self.device)
            B[s, n:, n:] = us[s][:, :nb]
        return B

    def emb_h1(self, B, vmat):
        """Embedding one-body term: B^T (h + vcor on the environment) B."""
        F = self.fock(vmat, cells="env")
        return B.transpose(1, 2) @ F @ B

    def emb_eri(self, neo):
        """The unit-cell ERI in the impurity corner (aa, bb, ab alike)."""
        n = self.nsc
        g = torch.zeros((neo,) * 4, dtype=self.dtype, device=self.device)
        g[:n, :n, :n, :n] = self.t(self.lat.eri)
        return g

    def solve(self, h1, g, dmu):
        """FCI of the embedding problem with -dmu on the impurity and as
        many electrons of each spin as impurity orbitals: (E, rdm1 (2, neo,
        neo))."""
        neo = h1.shape[-1]
        n = self.nsc
        if self.space is None or self.space.norb != neo:
            self.space = fci.Space(neo, (n, n), self.device, self.dtype)
        h = h1.clone()
        idx = torch.arange(n, device=self.device)
        h[:, idx, idx] -= dmu
        H = fci.Hamiltonian(self.space, (h[0], h[1]), (g, g, g))
        E, c = fci.davidson(H)
        ga, gb = H.rdm1(c)
        return E, torch.stack([ga, gb])

    def energy(self, h1, rdm, E, dmu):
        """transformResults: (E per site, nelec per site, rho_imp)."""
        n = self.nsc
        neo = h1.shape[-1]
        hd = h1.clone()
        idx = torch.arange(n, device=self.device)
        hd[:, idx, idx] -= dmu
        w = torch.zeros((neo, neo), dtype=self.dtype, device=self.device)
        w[:n, :n] = 1.0
        w[:n, n:] = w[n:, :n] = 0.5
        e1 = float(torch.sum(h1 * w * rdm))
        e2 = E - float(torch.sum(hd * rdm))
        nelec = float(torch.diagonal(rdm[:, :n, :n], dim1=1, dim2=2).sum())
        return (e1 + e2) / n, nelec / n, rdm[:, :n, :n]


class Fit(object):
    """The vcor fit of one iteration in NumPy at the DMET's dtype: the
    embedding H1 without vcor, the projections P_s[i, j] = sum_R
    B_R[i]^T B_R[j], and the target; as many electrons of each spin as
    impurity orbitals."""

    def __init__(self, dm, B, target):
        self.dt = dm.np_dtype
        n, lat = dm.nsc, dm.lat
        neo = B.shape[-1]
        Bc = B.reshape(2, lat.ncells, n, neo)
        self.H0 = (B.transpose(1, 2) @ dm.h @ B).cpu().numpy().astype(self.dt)
        self.P = torch.einsum("sRie,sRjf->sijef", Bc, Bc).cpu().numpy() \
            .astype(self.dt)
        self.target = np.asarray(target.cpu().numpy(), dtype=self.dt)
        self.n, self.ne = n, n

    def _rho(self, param):
        v = vcor_matrix(np.asarray(param, dtype=self.dt), self.n)
        H = self.H0 + np.einsum("sij,sijef->sef", v, self.P)
        e, V = np.linalg.eigh(H)
        rho = np.empty_like(H)
        for s in range(2):
            ne = self.ne
            # a full space takes its top level for both
            mu = 0.5 * (e[s, ne - 1] + e[s, min(ne, e.shape[1] - 1)])
            occ = (e[s] < mu - 1e-3).astype(self.dt)
            deg = np.abs(e[s] - mu) <= 1e-3
            if deg.any():
                occ = occ + deg * (ne - occ.sum()) / deg.sum()
            rho[s] = (V[s] * occ) @ V[s].T
        return rho, e, V

    def err(self, param):
        rho = self._rho(param)[0]
        return float(np.linalg.norm(rho - self.target) / np.sqrt(2.0))

    def err_grad(self, param):
        rho, e, V = self._rho(param)
        D = rho - self.target
        nrm = max(float(np.linalg.norm(D)), 1e-30)
        W = D / (nrm * np.sqrt(2.0))
        ne = self.ne
        G = np.empty_like(D)
        for s in range(2):
            eo, ev = e[s, :ne], e[s, ne:]
            M = np.zeros_like(D[s])
            M[ne:, :ne] = 1.0 / (eo[None, :] - ev[:, None])
            M = M + M.T
            G[s] = V[s] @ (M * (V[s].T @ W[s] @ V[s])) @ V[s].T
        g = np.einsum("sef,sijef->sij", G, self.P)
        g = g + g.transpose(0, 2, 1) - g * np.eye(self.n)[None]
        return nrm / np.sqrt(2.0), vcor_param(g)

    def minimize(self, x0):
        res = optimize.minimize(self.err_grad, np.asarray(x0, float),
                                jac=True, method="BFGS",
                                options={"gtol": 1e-10, "maxiter": 2000})
        return res.x, float(res.fun)


def trace_fix(v_new, v_old):
    """Remove the average diagonal change over both spins."""
    d = np.mean([np.diag(v_new[s] - v_old[s]) for s in range(2)])
    return v_new - d * np.eye(v_new.shape[-1])[None]


class Pulay(object):
    """Pulay DIIS over successive differences of the extrapolated
    sequence: the first call returns its input."""

    def __init__(self, space, dtype=np.float64):
        self.space, self.dt = space, dtype
        self.x, self.err, self.prev = [], [], None

    def __call__(self, x):
        x = np.asarray(x, dtype=self.dt).copy()
        if self.prev is None:
            self.prev = x
            return x.copy()
        self.x.append(x)
        self.err.append(x - self.prev)
        self.x, self.err = self.x[-self.space:], self.err[-self.space:]
        n = len(self.x)
        B = np.zeros((n + 1, n + 1), dtype=self.dt)
        B[:n, :n] = [[np.dot(a, b) for b in self.err] for a in self.err]
        B[n, :n] = B[:n, n] = -1.0
        rhs = np.zeros(n + 1, dtype=self.dt)
        rhs[n] = -1.0
        try:
            c = np.linalg.solve(B, rhs)[:n]
        except np.linalg.LinAlgError:
            # a singular system extrapolates nothing
            self.prev = x.copy()
            return x.copy()
        out = sum(ci * xi for ci, xi in zip(c, self.x))
        self.prev = out.copy()
        return out
