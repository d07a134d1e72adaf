"""
Lattice geometry and the model-lattice container (PyTorch port of
libdmet_preview_tpu/models/lattice.py).

Everything here is host NumPy computed once per lattice: geometry, index
maps, and the stripe operators with their k-space (re, im) pairs.  The
fused iteration (ops/fastpath.py) moves what it needs to its device.
set_Ham_model and set_Ham_abinitio record the lattice's device (the card
unless the caller names another): the mean field, the embedding, the
solvers and the vcor fit follow it; an ab initio lattice also moves its
Cholesky factors there once.

Conventions (match the JAX package):
  H(k) = sum_R e^{-i k.R} H(R)
  A(R) = (1/Nk) sum_k e^{+i k.R} A(k)
Stripe block meaning: A[R] = <R q| A |0 p> with row index in cell R.
"""

import itertools as it
import numpy as np
import torch

from libdmet_preview_tpu_torch.utils import logger as log
from libdmet_preview_tpu_torch.utils.misc import as_f64
from libdmet_preview_tpu_torch.ops import fourier


class UnitCell(object):
    """Unit cell: lattice vectors (dim x dim) + fractional site positions."""

    def __init__(self, size, sites):
        self.size = np.array(size, dtype=float)
        log.eassert(self.size.shape[0] == self.size.shape[1],
                    "Invalid unitcell constants")
        self.dim = self.size.shape[0]
        self.sites = []
        self.names = []
        for pos, name in sites:
            pos = np.asarray(pos, dtype=float)
            log.eassert(pos.shape == (self.dim,), "Invalid position for site")
            self.sites.append(pos)
            self.names.append(name)
        self.nsites = len(self.sites)


class SuperCell(object):
    """Supercell = unit cell replicated csize times along each axis."""

    def __init__(self, uc, size):
        self.unitcell = uc
        self.dim = uc.dim
        self.csize = np.array(size, dtype=int)
        self.size = np.dot(np.diag(self.csize), uc.size)
        self.ncells = int(np.prod(self.csize))
        self.nsites = uc.nsites * self.ncells
        self.cells, self.sites = translate_sites(uc.sites, uc.size, self.csize)
        self.names = list(uc.names) * self.ncells
        self.sitedict = {tuple(s): i for i, s in enumerate(map(tuple, self.sites))}


def translate_sites(base_sites, usize, csize):
    """Replicate sites over a C-ordered grid of cells."""
    cells = [np.asarray(x) for x in it.product(*map(range, csize))]
    sites = [np.dot(c, usize) + s for c in cells for s in base_sites]
    return cells, sites


def BipartiteSquare(impsize):
    """Split a rectangular impurity into even/odd sublattices."""
    subA, subB = [], []
    for idx, pos in enumerate(it.product(*map(range, impsize))):
        (subA if np.sum(pos) % 2 == 0 else subB).append(idx)
    log.eassert(len(subA) == len(subB),
                "The impurity cannot be divided into two sublattices")
    return subA, subB


class LatticeModel(object):
    """
    Model lattice: supercell tiled over a cell grid, with a Hubbard-family
    Hamiltonian attached through set_Ham_model.  Cells are enumerated
    C-order over `csize`, so stripe arrays reshape directly to the k mesh.
    """

    is_model = True

    def __init__(self, sc, size):
        self.supercell = sc
        self.dim = sc.dim
        self.csize = np.asarray(size, dtype=int)
        self.kmesh = self.csize.copy()
        self.size = np.dot(np.diag(self.csize), sc.size)
        self.ncells = int(np.prod(self.csize))
        self.nkpts = self.ncells
        self.nao = self.nscsites = sc.nsites
        self.nsites = sc.nsites * self.ncells
        self.neighborDist = []

        self.cells, self.sites = translate_sites(sc.sites, sc.size, self.csize)
        self.cells = np.asarray(self.cells)
        self.sites = np.asarray(self.sites)
        self.celldict = {tuple(c): i for i, c in enumerate(map(tuple, self.cells))}

        # orbital partition (all valence by default)
        self.val_idx = list(range(self.nao))
        self.virt_idx = []
        self.core_idx = []

        # static cell-index algebra tables
        self._build_cell_maps()

        self.Ham = None
        self.has_Ham = False
        self.use_hcore_as_emb_ham = False
        self.JK_imp = None
        self.JK_emb = None
        self.JK_core = None
        self.H0 = 0.0
        # device of the mean field and embedding (set_Ham_model,
        # set_Ham_abinitio), and the device copy of the Cholesky/DF factors
        self.device = None
        self.chol_L = None

        # k-points (scaled, units of 2*pi / cell)
        self.kpts_scaled = np.array(
            list(it.product(*[np.fft.fftfreq(n) for n in self.csize])))

    # ------------------------------------------------------------------
    # orbital bookkeeping
    # ------------------------------------------------------------------
    @property
    def ncore(self):
        return len(self.core_idx)

    @property
    def nval(self):
        return len(self.val_idx)

    @property
    def nvirt(self):
        return len(self.virt_idx)

    @property
    def nimp(self):
        return self.nval + self.nvirt

    @property
    def imp_idx(self):
        return list(self.val_idx) + list(self.virt_idx)

    def set_val_virt_core(self, val, virt, core):
        if isinstance(core, (list, tuple, np.ndarray)):
            self.core_idx = list(core)
        else:
            self.core_idx = list(range(0, core))
        if isinstance(val, (list, tuple, np.ndarray)):
            self.val_idx = list(val)
        else:
            self.val_idx = list(range(self.ncore, self.ncore + val))
        if isinstance(virt, (list, tuple, np.ndarray)):
            self.virt_idx = list(virt)
        else:
            self.virt_idx = list(range(self.ncore + self.nval,
                                       self.ncore + self.nval + virt))

    # ------------------------------------------------------------------
    # cell-index algebra
    # ------------------------------------------------------------------
    def _build_cell_maps(self):
        nc = self.ncells
        pos = self.cells  # (ncells, dim)
        csz = self.csize
        add_tab = np.empty((nc, nc), dtype=np.int32)
        sub_tab = np.empty((nc, nc), dtype=np.int32)
        ravel = {tuple(p): i for i, p in enumerate(pos)}
        for i in range(nc):
            a = (pos[i][None, :] + pos) % csz
            s = (pos[i][None, :] - pos) % csz
            add_tab[i] = [ravel[tuple(x)] for x in a]
            sub_tab[i] = [ravel[tuple(x)] for x in s]
        self._add_tab = add_tab
        self._sub_tab = sub_tab
        # negation map: idx of -R
        self._neg_map = np.array(
            [ravel[tuple((-pos[i]) % csz)] for i in range(nc)], dtype=np.int32)

    def add(self, i, j):
        return int(self._add_tab[i, j])

    def subtract(self, i, j):
        return int(self._sub_tab[i, j])

    def cell_idx2pos(self, idx):
        return self.cells[idx]

    def cell_pos2idx(self, pos):
        return self.celldict[tuple(np.asarray(pos) % self.csize)]

    # ------------------------------------------------------------------
    # Fourier transforms (stripe <-> k, (re, im) pairs)
    # ------------------------------------------------------------------
    def FFTtoK(self, A):
        """Stripe R -> k on this lattice's mesh; returns (re, im) pair."""
        return fourier.FFTtoK(A, self.kmesh)

    def FFTtoT(self, B, tol=fourier.IMAG_DISCARD_TOL):
        """k pair -> stripe R (real part) on this lattice's mesh."""
        return fourier.FFTtoT(B, self.kmesh, tol=tol)

    def R2k(self, A):
        """Stripe R -> k; returns (re, im) pair."""
        return fourier.R2k(A, self.kmesh)

    def k2R(self, B, tol=fourier.IMAG_DISCARD_TOL):
        """k pair -> stripe R (real); tol as in fourier.k2R."""
        return fourier.k2R(B, self.kmesh, tol=tol)

    def R2k_basis(self, basis_R):
        """Embedding basis R -> k pair: no 1/Nk factor."""
        return fourier.R2k(basis_R, self.kmesh)

    def k2R_basis(self, basis_k):
        return fourier.k2R(basis_k, self.kmesh)

    # ------------------------------------------------------------------
    # stripe <-> full supercell matrices
    # ------------------------------------------------------------------
    def expand(self, A):
        """Stripe (.., ncells, n, n) -> full (.., ncells*n, ncells*n);
        block (I, J) = A[I - J]."""
        A = np.asarray(A)
        n = A.shape[-1]
        nc = self.ncells
        blocks = A[..., self._sub_tab, :, :]  # (.., I, J, n, n)
        blocks = np.moveaxis(blocks, -3, -2)  # (.., I, n, J, n)
        return blocks.reshape(A.shape[:-3] + (nc * n, nc * n))

    def extract_stripe(self, A):
        A = np.asarray(A)
        nc = self.ncells
        n = A.shape[-1] // nc
        return A.reshape(A.shape[:-2] + (nc, n, nc, n))[..., :, :, 0, :]

    def transpose_stripe(self, A):
        A = np.asarray(A)
        return np.swapaxes(A[..., self._neg_map, :, :], -1, -2)

    # ------------------------------------------------------------------
    # neighbor search (geometry)
    # ------------------------------------------------------------------
    def neighbor(self, dis=1.0, sitesA=None, sitesB=None, search_range=1):
        if sitesA is None:
            sitesA = range(self.nsites)
        if sitesB is None:
            sitesB = range(self.nsites)
        sitesA = np.asarray(list(sitesA))
        sitesB = np.asarray(list(sitesB))
        shifts = np.asarray(list(it.product(
            range(-search_range, search_range + 1), repeat=self.dim)))
        shift_vecs = shifts @ self.size  # (nshift, dim)
        rA = self.sites[sitesA]  # (na, dim)
        rB = self.sites[sitesB]  # (nb, dim)
        diff = rA[:, None, None, :] - rB[None, :, None, :] - shift_vecs[None, None, :, :]
        dist = np.linalg.norm(diff, axis=-1)
        hit = np.abs(dist - dis).min(axis=-1) < 1e-5
        ia, ib = np.nonzero(hit)
        return list(zip(sitesA[ia].tolist(), sitesB[ib].tolist()))

    # ------------------------------------------------------------------
    # Hamiltonian attachment
    # ------------------------------------------------------------------
    def set_Ham_model(self, Ham, rdm1=None, fock=None, ovlp=None,
                      eri_symmetry=4, use_hcore_as_emb_ham=True,
                      device=torch.device("cuda")):
        """Attach a model Hamiltonian (stripe H1/Fock; H2 'local',
        'nearest', 'full' or 'spin local').  The
        mean field and the embedding built on this lattice run on
        `device`."""
        self.device = torch.device(device)
        self.Ham = Ham
        self.hcore_lo_R = np.asarray(Ham.getH1())
        self.hcore_lo_k = self.R2k(self.hcore_lo_R)
        if ovlp is None:
            self.ovlp_lo_R = np.zeros((self.ncells, self.nao, self.nao))
            self.ovlp_lo_R[0] = np.eye(self.nao)
        else:
            self.ovlp_lo_R = np.asarray(ovlp)
        self.ovlp_lo_k = self.R2k(self.ovlp_lo_R)
        if fock is None:
            self.fock_lo_R = np.asarray(Ham.getFock())
        else:
            self.fock_lo_R = np.asarray(fock)
        self.fock_lo_k = self.R2k(self.fock_lo_R)
        self.rdm1_lo_R = rdm1
        if rdm1 is not None:
            self.rdm1_lo_k = self.R2k(np.asarray(rdm1))
        self.eri_symmetry = eri_symmetry
        self.use_hcore_as_emb_ham = use_hcore_as_emb_ham
        self.has_Ham = True
        self.H2_format = Ham.H2_format
        self.H0 = Ham.getH0()

    set_Ham = setHam = setHam_model = set_Ham_model

    def set_Ham_abinitio(self, Ham, rdm1=None, use_hcore_as_emb_ham=False,
                         device=torch.device("cuda")):
        """Ingest an ab initio Hamiltonian: hcore/fock in the LO basis as
        ((spin,) ncells, n, n) R stripes, two-body as Cholesky/DF factors
        (H2_format 'cholesky').  The lattice keeps its own copy of the
        factors on `device`, made once (Ham is left as it was); the mean
        field and the embedding run on `device`.  A Ham without factors
        (chol_L None) serves the non-interacting bath through its
        unit-cell ERI eri_imp."""
        self.device = torch.device(device)
        if Ham.getH2() is None:
            self.chol_L = None
        elif (self.chol_L is None or self.Ham is not Ham
                or self.chol_L.device != self.device):
            self.chol_L = as_f64(Ham.getH2(), self.device)
        self.Ham = Ham
        self.hcore_lo_R = np.asarray(Ham.getH1())
        self.hcore_lo_k = self.R2k(self.hcore_lo_R)
        self.ovlp_lo_R = np.zeros((self.ncells, self.nao, self.nao))
        self.ovlp_lo_R[0] = np.eye(self.nao)
        self.ovlp_lo_k = self.R2k(self.ovlp_lo_R)
        self.fock_lo_R = np.asarray(Ham.getFock())
        self.fock_lo_k = self.R2k(self.fock_lo_R)
        self.rdm1_lo_R = rdm1
        if rdm1 is not None:
            self.rdm1_lo_k = self.R2k(np.asarray(rdm1))
        self.use_hcore_as_emb_ham = use_hcore_as_emb_ham
        self.has_Ham = True
        self.is_model = False
        self.H2_format = Ham.H2_format
        self.H0 = Ham.getH0()

    def update_Ham(self, rdm1_lo_R, fock_lo_k=None):
        """DMET charge self-consistency: rebuild the lattice Fock from a
        new rdm1 ((spin,) ncells, n, n; spin-traced when restricted).

        With a local lattice ERI the J/K from the cell-averaged density
        are k-independent, so the Fock update touches only the R = 0
        stripe block.  The J/K contraction runs on the lattice's device."""
        from libdmet_preview_tpu_torch.ops import pbc_helper
        rdm1_lo_R = np.asarray(rdm1_lo_R)
        if rdm1_lo_R.ndim == 3:
            rdm1_lo_R = rdm1_lo_R[None]
        self.rdm1_lo_R = rdm1_lo_R
        self.rdm1_lo_k = self.R2k(rdm1_lo_R)
        if fock_lo_k is not None:
            self.fock_lo_k = fock_lo_k
            self.fock_lo_R = np.asarray(self.k2R(fock_lo_k))
            return
        if self.H2_format == "nearest":
            self._update_Ham_nearest(rdm1_lo_R)
            return
        log.eassert(self.H2_format == "local",
                    "update_Ham implemented for local and nearest H2")
        eri = np.asarray(self.getH2(kspace=False))
        dm0 = rdm1_lo_R[:, 0]  # cell-averaged density = rho(R=0)
        vj, vk = pbc_helper.get_jk_local(eri, dm0, self.device)
        spin = rdm1_lo_R.shape[0]
        if spin == 1:
            JK = vj[0] - vk[0] * 0.5
            fock_R = np.array(self.hcore_lo_R, copy=True)
            if self.hcore_lo_R.ndim == 3:
                fock_R[0] = fock_R[0] + JK
            else:
                fock_R[:, 0] = fock_R[:, 0] + JK
        else:
            JK = (vj[0] + vj[1])[None] - vk
            hcore = self.hcore_lo_R
            if hcore.ndim == 3:
                hcore = np.asarray([hcore, hcore])
            fock_R = np.array(hcore, copy=True)
            fock_R[:, 0] = fock_R[:, 0] + JK
        self.fock_lo_R = fock_R
        self.fock_lo_k = self.R2k(self.fock_lo_R)

    def _update_Ham_nearest(self, rdm1_lo_R):
        """Fock of the 'nearest' H2 format: J is local (uniform density),
        K is a stripe.  get_jk_nearest's vk[R] is the exchange block
        (0, R), so the stripe block K_stripe[R] = block(R, 0) is vk[R]^T
        (K is symmetric).  The JAX package takes vk[(-R) % ncells]^T, the
        block (-R, 0): the same for a model whose exchange has
        K(R) = K(-R), as the extended Hubbard chain's."""
        from libdmet_preview_tpu_torch.ops import pbc_helper
        eri_R = np.asarray(self.getH2(kspace=False))
        vj, vk = pbc_helper.get_jk_nearest(eri_R, rdm1_lo_R, self.device)
        spin = rdm1_lo_R.shape[0]
        hcore = self.hcore_lo_R
        if spin == 1:       # spin-traced storage
            K = np.swapaxes(vk[0], -1, -2)
            fock_R = np.array(hcore if hcore.ndim == 3 else hcore[0],
                              copy=True)
            fock_R[0] += vj[0]
            fock_R -= 0.5 * K
        else:
            if hcore.ndim == 3:
                hcore = np.asarray([hcore, hcore])
            fock_R = np.array(hcore, copy=True)
            fock_R[:, 0] += vj[0] + vj[1]
            fock_R -= np.swapaxes(vk, -1, -2)
        self.fock_lo_R = fock_R
        self.fock_lo_k = self.R2k(self.fock_lo_R)

    # ------------------------------------------------------------------
    # getters
    # ------------------------------------------------------------------
    def getH1(self, kspace=True):
        return self.hcore_lo_k if kspace else self.hcore_lo_R

    def getFock(self, kspace=True):
        return self.fock_lo_k if kspace else self.fock_lo_R

    def get_ovlp(self, kspace=True):
        return self.ovlp_lo_k if kspace else self.ovlp_lo_R

    def getH2(self, compact=False, kspace=False):
        assert not kspace
        if self.chol_L is not None:
            return self.chol_L
        return self.Ham.getH2()

    def getH0(self):
        return self.H0

    def getImpJK(self):
        if self.JK_imp is not None:
            return self.JK_imp
        if self.Ham is not None:
            return self.Ham.getImpJK()
        return None

    def get_JK_emb(self):
        return self.JK_emb

    def get_JK_core(self):
        return self.JK_core

    def __str__(self):
        return ("LatticeModel dim=%d csize=%s nscsites=%d ncells=%d nsites=%d"
                % (self.dim, self.csize, self.nscsites, self.ncells, self.nsites))


def ChainLattice(length, scsites):
    """1D 1-band chain."""
    log.eassert(length % scsites == 0, "incompatible lattice/supercell sizes")
    uc = UnitCell(np.eye(1), [(np.array([0.0]), "X")])
    sc = SuperCell(uc, np.asarray([scsites]))
    lat = LatticeModel(sc, np.asarray([length // scsites]))
    lat.neighborDist = [1.0, 2.0, 3.0]
    return lat


def SquareLattice(lx, ly, scx, scy):
    """2D 1-band square lattice."""
    log.eassert(lx % scx == 0 and ly % scy == 0,
                "incompatible lattice/supercell sizes")
    uc = UnitCell(np.eye(2), [(np.array([0.0, 0.0]), "X")])
    sc = SuperCell(uc, np.asarray([scx, scy]))
    lat = LatticeModel(sc, np.asarray([lx // scx, ly // scy]))
    lat.neighborDist = [1.0, np.sqrt(2.0), 2.0]
    return lat


def SquareAFM(lx, ly, scx, scy):
    """2D 1-band square, rotated 2-site AFM cell."""
    log.eassert(lx % scx == 0 and ly % scy == 0,
                "incompatible lattice/supercell sizes")
    uc = UnitCell(np.eye(2) * np.sqrt(2.0),
                  [(np.zeros(2), "X1"),
                   (np.ones(2) * (np.sqrt(2.0) * 0.5), "X2")])
    sc = SuperCell(uc, np.asarray([scx, scy]))
    lat = LatticeModel(sc, np.asarray([lx // scx, ly // scy]))
    lat.neighborDist = [1.0, np.sqrt(2.0), 2.0]
    return lat


def _square_lattice(uc, lx, ly, scx, scy):
    sc = SuperCell(uc, np.asarray([scx, scy]))
    lat = LatticeModel(sc, np.asarray([lx // scx, ly // scy]))
    lat.neighborDist = [1.0, np.sqrt(2.0), 2.0]
    return lat


def Square3Band(lx, ly, scx, scy):
    """2D 3-band (CuO2) lattice, 1 CuO2 per cell."""
    log.eassert(lx % scx == 0 and ly % scy == 0,
                "incompatible lattice/supercell sizes")
    uc = UnitCell(np.eye(2) * 2.0,
                  [(np.array([0.0, 0.0]), "Cu"),
                   (np.array([1.0, 0.0]), "O"),
                   (np.array([0.0, 1.0]), "O")])
    return _square_lattice(uc, lx, ly, scx, scy)


def Square3BandAFM(lx, ly, scx, scy, symm=True):
    """2D 3-band lattice, AFM cell with 2 CuO2 units."""
    log.eassert(lx % scx == 0 and ly % scy == 0,
                "incompatible lattice/supercell sizes")
    if symm:
        oxygens = [[2.0, -2.0], [2.0, 0.0], [1.0, 1.0], [3.0, 1.0]]
    else:
        oxygens = [[0.0, 0.0], [2.0, 0.0], [1.0, 1.0], [1.0, -1.0]]
    uc = UnitCell(np.array([[2.0, -2.0], [2.0, 2.0]]),
                  [(np.array([1.0, 0.0]), "Cu"),
                   (np.array([3.0, 0.0]), "Cu")]
                  + [(np.array(pos), "O") for pos in oxygens])
    return _square_lattice(uc, lx, ly, scx, scy)


def Square3BandSymm(lx, ly, scx=1, scy=1):
    """2D 3-band lattice, 2x2 symmetric supercell (12 orbitals)."""
    uc = UnitCell(np.eye(2) * 4.0, [
        (np.array([1.0, 1.0]), "Cu"),
        (np.array([0.0, 1.0]), "O"),
        (np.array([1.0, 2.0]), "O"),
        (np.array([1.0, 3.0]), "Cu"),
        (np.array([1.0, 4.0]), "O"),
        (np.array([2.0, 3.0]), "O"),
        (np.array([3.0, 3.0]), "Cu"),
        (np.array([4.0, 3.0]), "O"),
        (np.array([3.0, 2.0]), "O"),
        (np.array([3.0, 1.0]), "Cu"),
        (np.array([3.0, 0.0]), "O"),
        (np.array([2.0, 1.0]), "O"),
    ])
    sc = SuperCell(uc, np.asarray([scx, scy]))
    lat = LatticeModel(sc, np.asarray([lx, ly]))
    lat.neighborDist = [1.0, np.sqrt(2.0), 2.0]
    return lat


def CubicLattice(lx, ly, lz, scx, scy, scz):
    """3D 1-band cubic lattice."""
    log.eassert(lx % scx == 0 and ly % scy == 0 and lz % scz == 0,
                "incompatible lattice/supercell sizes")
    uc = UnitCell(np.eye(3), [(np.array([0.0, 0.0, 0.0]), "X")])
    sc = SuperCell(uc, np.asarray([scx, scy, scz]))
    lat = LatticeModel(sc, np.asarray([lx // scx, ly // scy, lz // scz]))
    lat.neighborDist = [1.0, np.sqrt(2.0), np.sqrt(3.0)]
    return lat


def HoneycombLattice(lx, ly, scx, scy):
    """2D honeycomb (graphene) lattice, 2 sites per unit cell."""
    log.eassert(lx % scx == 0 and ly % scy == 0,
                "incompatible lattice/supercell sizes")
    a = np.array([[1.5, 0.5 * np.sqrt(3.0)], [1.5, -0.5 * np.sqrt(3.0)]])
    uc = UnitCell(a, [(np.array([0.0, 0.0]), "A"),
                      (np.array([1.0, 0.0]), "B")])
    sc = SuperCell(uc, np.asarray([scx, scy]))
    lat = LatticeModel(sc, np.asarray([lx // scx, ly // scy]))
    lat.neighborDist = [1.0, np.sqrt(3.0), 2.0]
    return lat


def MeshLattice(kmesh, nsites_cell):
    """Generic d-dimensional mesh lattice with `nsites_cell` abstract
    orbitals per cell: the translation algebra for operators given as
    arrays on a k mesh."""
    kmesh = tuple(int(x) for x in kmesh)
    dim = len(kmesh)
    sites = [(np.full(dim, (i + 1.0) / (nsites_cell + 1.0)), "X")
             for i in range(nsites_cell)]
    uc = UnitCell(np.eye(dim), sites)
    sc = SuperCell(uc, np.ones(dim, dtype=int))
    return LatticeModel(sc, np.asarray(kmesh, dtype=int))
