"""
Model Hamiltonians (PyTorch port of libdmet_preview_tpu/models/hamiltonian.py).

Host NumPy containers: stripe H1/Fock + H2 in the 'local', 'nearest',
'full' or 'spin local' format; the factories build Hubbard-family
Hamiltonians from lattice geometry.
"""

import itertools as it

import numpy as np

from libdmet_preview_tpu_torch.utils import logger as log


class HamNonInt(object):
    """Non-interacting lattice Hamiltonian + local two-body interaction.

    H1 shape ((spin,) ncells, nao, nao) stripe; H2 format is detected from
    its shape: 'local' (nao^4), 'nearest' (ncells, nao^4), 'full'
    (ncells^3, nao^4), 'spin local' (spin_dim, nao^4).
    """

    def __init__(self, lattice, H1, H2, Fock=None, ImpJK=None,
                 kspace_input=False, spin_dim_H2=None, H0=0.0):
        ncells = lattice.ncells
        nao = lattice.nao
        H1 = np.asarray(H1)
        H2 = np.asarray(H2)
        log.eassert(H1.shape[-3:] == (ncells, nao, nao),
                    "H1 shape %s not compatible with lattice", H1.shape)
        if kspace_input:
            H1 = np.asarray(lattice.k2R(H1))
        self.H1 = H1
        if Fock is None:
            self.Fock = self.H1
        else:
            Fock = np.asarray(Fock)
            if kspace_input:
                Fock = np.asarray(lattice.k2R(Fock))
            self.Fock = Fock

        self.spin_dim_H2 = spin_dim_H2
        nao_pair = nao * (nao + 1) // 2
        if spin_dim_H2 is None:
            if H2.shape == (nao,) * 4 or H2.shape == (nao_pair, nao_pair):
                self.H2_format = "local"
            elif H2.shape == (ncells,) + (nao,) * 4 \
                    or H2.shape == (ncells, nao_pair, nao_pair):
                self.H2_format = "nearest"
            elif H2.shape == (ncells,) * 3 + (nao,) * 4 \
                    or H2.shape == (ncells,) * 3 + (nao_pair, nao_pair):
                self.H2_format = "full"
            else:
                raise ValueError("H2 shape %s not compatible" % str(H2.shape))
        else:
            if H2.shape == (spin_dim_H2,) + (nao,) * 4:
                self.H2_format = "spin local"
            elif H2.shape == (spin_dim_H2, ncells) + (nao,) * 4:
                self.H2_format = "spin nearest"
            else:
                raise ValueError("H2 shape %s not compatible" % str(H2.shape))
        self.H2 = H2
        self.ImpJK = ImpJK
        self.H0 = H0

    def getH0(self):
        return self.H0

    def getH1(self):
        return self.H1

    def getH2(self):
        return self.H2

    def getFock(self):
        return self.Fock

    def getImpJK(self):
        return self.ImpJK


def HubbardHamiltonian(lattice, U, tlist=(1.0,), obc=False, tol=1e-10,
                       return_H1=False):
    """1-band Hubbard model: H = -t <ij> - t' <<ij>> ... + U n_up n_dn."""
    ncells = lattice.ncells
    nsc = lattice.nscsites
    H1 = np.zeros((ncells, nsc, nsc))
    search_range = 0 if obc else 1
    for order, t in enumerate(tlist):
        if abs(t) < tol:
            continue
        log.eassert(order < len(lattice.neighborDist),
                    "%dth neighbor distance unspecified", order + 1)
        dis = lattice.neighborDist[order]
        pairs = lattice.neighbor(dis=dis, sitesA=range(nsc),
                                 search_range=search_range)
        for i, j in pairs:
            H1[j // nsc, j % nsc, i] = -t
    if return_H1:
        return H1
    H2 = np.zeros((nsc,) * 4)
    np.fill_diagonal(H2, U)
    return HamNonInt(lattice, H1, H2)


def HubbardExtended(lattice, U, V, tlist=(1.0,), tol=1e-10):
    """Extended Hubbard model: onsite U + nearest-neighbour density-density
    V, stored in the 'nearest' H2 format (ncells, nao^4)."""
    ncells = lattice.ncells
    nsc = lattice.nscsites
    H1 = HubbardHamiltonian(lattice, U, tlist=tlist, tol=tol, return_H1=True)
    H2 = np.zeros((ncells,) + (nsc,) * 4)
    for i in range(nsc):
        H2[0, i, i, i, i] = U
    dis = lattice.neighborDist[0]
    pairs = lattice.neighbor(dis=dis, sitesA=range(nsc), search_range=1)
    for i, j in pairs:
        R, jj = j // nsc, j % nsc
        # V n_i n_j: chemist (ii|jj) with 0.5 for restricted double count
        H2[R, i, i, jj, jj] += 0.5 * V
        H2[lattice._neg_map[R], jj, jj, i, i] += 0.5 * V
    return HamNonInt(lattice, H1, H2)


def Hubbard3band(lattice, Ud, Up, ed, tpd, tpp, tpp1=0.0, Vpd=0.0,
                 ignore_intercell=True, tol=1e-10):
    """3-band (Emery) Hubbard model for cuprates.

    Site name convention from the lattice factories: "Cu" = d orbital,
    "O" = p orbital. Hole representation with positive t as input sign
    conventions (t, ed negative typically).
    """
    ncells = lattice.ncells
    nsc = lattice.nscsites
    names = lattice.supercell.names
    H1 = np.zeros((ncells, nsc, nsc))
    intercell = not ignore_intercell
    if intercell:
        # 'nearest' H2 format (ops/embham.py):
        # H2[R, p, q, r, s] = (0p 0q | Rr Rs)
        H2 = np.zeros((ncells,) + (nsc,) * 4)
        if abs(Vpd) < 1e-5:
            log.warn("Vpd=%s tiny; ignore_intercell=True is cheaper", Vpd)
    else:
        H2 = np.zeros((nsc,) * 4)

    def H2loc(p, q, r, s):
        return (0, p, q, r, s) if intercell else (p, q, r, s)

    d_pd = lattice.neighborDist[0]
    d_pp = lattice.neighborDist[1]
    d_pp1 = lattice.neighborDist[2] if len(lattice.neighborDist) > 2 else None

    # on-site energies and U
    for s in range(nsc):
        if names[s] == "Cu":
            H2[H2loc(s, s, s, s)] = Ud
            H1[0, s, s] = ed if abs(ed) > tol else 0.0
        else:
            H2[H2loc(s, s, s, s)] = Up

    def _bonds(dis, search_range=2):
        """Image-resolved bonds (i in cell 0, j global, dvec): unlike
        lattice.neighbor, keeps the geometric displacement of EACH
        periodic image: the d-p/p-p phase is a bond property, and a
        Hermitian matrix element must get the same sign from both scan
        directions."""
        shifts = np.asarray(list(it.product(
            range(-search_range, search_range + 1), repeat=lattice.dim)))
        shift_vecs = shifts @ lattice.size
        out = []
        for i in range(nsc):
            ri = lattice.sites[i]
            for j in range(lattice.nsites):
                dv = lattice.sites[j] + shift_vecs - ri   # (nshift, dim)
                dd = np.linalg.norm(dv, axis=-1)
                for k in np.nonzero(np.abs(dd - dis) < 1e-5)[0]:
                    out.append((i, j, dv[k]))
        return out

    def phase_pd(dvec, ni_name):
        # +- alternation of the d-p hopping (standard Emery model),
        # oriented from the copper to the oxygen
        d = dvec if ni_name == "Cu" else -dvec
        ax = int(np.argmax(np.abs(d)))
        return 1.0 if d[ax] > 0 else -1.0

    # tpd between nearest Cu-O; Vpd density-density on the same bonds.
    # Intercell pairs populate the 'nearest' H2 format; each unordered
    # bond is enumerated in both scan directions, so the 0.5 weights sum
    # to Vpd per ordered entry.  The mirrored entry sits at the cell -R
    # of the lattice's index algebra, so that (pq|rs) = (rs|pq) holds on
    # 2D meshes too (the JAX package's (-R) % ncells is that cell on a 1D
    # mesh only).
    if abs(tpd) > tol or abs(Vpd) > tol:
        for i, j, dvec in _bonds(d_pd):
            nj_name = lattice.supercell.names[j % nsc]
            ni_name = names[i]
            if {ni_name, nj_name} == {"Cu", "O"}:
                if abs(tpd) > tol:
                    H1[j // nsc, j % nsc, i] += tpd * phase_pd(dvec, ni_name)
                if abs(Vpd) > tol:
                    R, q = j // nsc, j % nsc
                    if intercell:
                        H2[R, i, i, q, q] += 0.5 * Vpd
                        H2[lattice._neg_map[R], q, q, i, i] += 0.5 * Vpd
                    elif R == 0:
                        H2[q, q, i, i] += 0.5 * Vpd
                        H2[i, i, q, q] += 0.5 * Vpd

    # tpp between nearest O-O
    if abs(tpp) > tol:
        for i, j, dvec in _bonds(d_pp):
            if names[i] == "O" and lattice.supercell.names[j % nsc] == "O":
                sgn = 1.0 if dvec[0] * dvec[1] > 0 else -1.0
                H1[j // nsc, j % nsc, i] += tpp * sgn

    # tpp' between next-nearest O-O (same sublattice)
    if d_pp1 is not None and abs(tpp1) > tol:
        for i, j, dvec in _bonds(d_pp1):
            if names[i] == "O" and lattice.supercell.names[j % nsc] == "O":
                H1[j // nsc, j % nsc, i] += tpp1

    return HamNonInt(lattice, H1, H2)


def Hubbard3band_ref(lattice, name="Hanke", min_model=False, hole_rep=False,
                     factor=1.0, ignore_intercell=True):
    """Literature parameter sets for the 3-band model, stored in the
    HOLE representation as (Ud, tpd, D_pd, Up, tpp, tpp1, Vpd):
    hole rep -> ed = -D_pd; electron rep -> all t's flip sign and
    ed = D_pd - Ud - 4 Vpd + Up (particle-hole transform of the
    density-density terms).  `name` may also be a parameter dict with
    those keys."""
    params = {
        "hybertsen": dict(Ud=10.5, tpd=1.3, D_pd=3.6, Up=4.0, tpp=0.65,
                          tpp1=0.0, Vpd=1.2),
        "martin":    dict(Ud=16.5, tpd=1.8, D_pd=5.4, Up=0.0, tpp=0.6,
                          tpp1=0.0, Vpd=0.0),
        "hanke":     dict(Ud=12.0, tpd=1.5, D_pd=4.5, Up=5.25, tpp=0.75,
                          tpp1=0.0, Vpd=0.75),
        "wagner":    dict(Ud=8.4,  tpd=1.2, D_pd=4.4, Up=2.0, tpp=0.7,
                          tpp1=0.0, Vpd=0.0),
    }
    if isinstance(name, str):
        key = name.lower().strip()
        log.eassert(key in params, "unknown 3-band parameter set %s", name)
        p = dict(params[key])
    else:
        known = {"Ud", "tpd", "D_pd", "Up", "tpp", "tpp1", "Vpd"}
        log.eassert(set(name.keys()).issubset(known),
                    "unknown 3-band parameter names %s", set(name) - known)
        p = {"Up": 0.0, "tpp": 0.0, "tpp1": 0.0, "Vpd": 0.0, **name}
    if min_model:
        p["tpp"] = p["tpp1"] = p["Up"] = p["Vpd"] = 0.0
    if hole_rep:
        ed = -p["D_pd"]
        tpd, tpp, tpp1 = p["tpd"], p["tpp"], p["tpp1"]
    else:
        tpd, tpp, tpp1 = -p["tpd"], -p["tpp"], -p["tpp1"]
        ed = p["D_pd"] - p["Ud"] - 4.0 * p["Vpd"] + p["Up"]
    return Hubbard3band(lattice, p["Ud"] * factor, p["Up"] * factor,
                        ed * factor, tpd * factor, tpp * factor,
                        tpp1 * factor, Vpd=p["Vpd"] * factor,
                        ignore_intercell=ignore_intercell)


def HubbardDCA(lattice, lattice_fine, U, tlist=(1.0,), tol=1e-8):
    """DCA-coarse-grained Hubbard model: the cluster hopping is the Brillouin-zone patch average
    of the FINE-mesh dispersion (utils/dca.dca_coarse_grain), so the
    cluster model reproduces the lattice band structure at the cluster
    momenta instead of simple truncation.

    lattice: the cluster-mesh lattice the DMET calculation runs on;
    lattice_fine: a lattice of the same geometry on a finer mesh (each
    cluster dim dividing the fine dim).  Onsite U is unchanged by the
    coarse graining (it is k-independent)."""
    from libdmet_preview_tpu_torch.utils.dca import dca_cluster_H1R
    from libdmet_preview_tpu_torch.ops import fourier
    H1_fine = HubbardHamiltonian(lattice_fine, U, tlist=tlist,
                                 return_H1=True)
    kmesh_f = tuple(int(x) for x in lattice_fine.kmesh)
    H1_fine_k = fourier.R2k(np.asarray(H1_fine), kmesh_f)
    cmesh = tuple(int(x) for x in lattice.kmesh)
    H1 = np.ascontiguousarray(dca_cluster_H1R(H1_fine_k, kmesh_f, cmesh))
    nsc = lattice.nscsites
    H2 = np.zeros((nsc,) * 4)
    for i in range(nsc):
        H2[i, i, i, i] = U
    return HamNonInt(lattice, H1, H2)
