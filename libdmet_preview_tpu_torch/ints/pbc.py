"""
Periodic Gaussian integrals on the Born-von-Karman torus (PyTorch port of
libdmet_preview_tpu/ints/pbc.py: the cell, its integrals and the
embedding-ERI drivers aft / fft / rs).

A k-mesh calculation is formulated on the BvK SUPERCELL torus: periodized
orbitals, the Ewald-periodized Coulomb kernel
v(r) = (4 pi / Omega) sum_{G != 0} e^{iGr} / G^2 (uniform-background
compensated; PySCF's exxdiv=None + G=0-dropped convention for neutral
systems), and analytic Fourier transforms of Gaussian pair densities.

Quantities (all real, supercell AO basis):
  ovlp, kin       -- real-space lattice sums of molecular formulas
  nuc             -- Ewald split: G-space long range
                     -(1/Omega) sum_G w_lr(G) Re[SF(G) f_IJ(G)^*]
                     + real-space erfc short range + its G=0 term
                     (+ the GTH short range with pseudo='gth-pade')
  eri             -- (1/Omega) sum_G w(G) f_IJ(G)^* f_KL(G); or by range
                     separation (intor_eri_rs): real-space erfc rows + the
                     erf long range on a coarse mesh
  e_nuc           -- point-charge Ewald energy with background

with w(G) = 4 pi / G^2 (w=0 at G=0) and f_IJ(G) the torus pair FT.

Where the work runs.  On the cell's device (float64 / complex128): the
pair Fourier transform ft_aopair (exp(-G^2/4p), the image phases
exp(-iG.P), the separable Hermite contraction against (-iG)^t, the stripe
expansion by exp(-iG.T_D)), the nuclear structure factor and long-range
contraction of intor_nuc, the weighted G-space Grams of intor_eri,
intor_eri_rs's long range and eri_trans_full (plain torch.matmul; the Gram
is Ar^T Ar + Ai^T Ai of the sqrt(w)-scaled parts), and the embedding
drivers (the embedding pair transforms, the pair FFTs, the contraction of
the short-range rows).  On the host, in NumPy and the native core
(ints/native.py, csrc/_sr_core.cpp, on every host core), in the JAX
package's terms: the real-space lattice sums (overlap, kinetic, the erfc
and GTH short range with its complex-step derivative, the projector
overlaps, the short-range ERI rows) and the Ewald energy.

The integral methods (intor_*, eri_trans_full*) return float64 tensors on
`device` (default CUDA) and keep their result on the cell after the first
evaluation, as ints.gto.Mole does; they return a copy each time.  The
mesh helpers (Gv, coulG, coulG_rs) return NumPy arrays.  Under
utils.timer.recording() the stages are timed: "cell 1-body (host)",
"pair FT (device)", "nuclear LR (device)", "nuclear SR (host)", "GTH
(host)", "SR ERI rows (host)", "LR ERI Gram (device)", "eri_trans_full
Gram (device)", "Ewald (host)", "SR emb contraction (device)" and "emb
ERI Gram (device)".
"""

import itertools as it
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
from scipy.special import erfc

from libdmet_preview_tpu_torch.ints import md
from libdmet_preview_tpu_torch.ints import native
from libdmet_preview_tpu_torch.utils.misc import as_f64
from libdmet_preview_tpu_torch.utils.timer import stage

BOHR_PER_ANGSTROM = 1.0 / 0.52917720859  # PySCF's BOHR constant

# bytes of the (terms x G) temporaries of one G block of ft_aopair and of
# the row blocks of the G-space Grams
_BLOCK_BYTES = 1 << 28


def _mesh_vectors(mesh, b):
    """All reciprocal vectors of a mesh (fftfreq ordering, G=0 first, the
    first axis slowest), (nG, 3)."""
    fracs = [np.fft.fftfreq(n, 1.0 / n) for n in mesh]
    ns = np.stack(np.meshgrid(*fracs, indexing="ij"), axis=-1)
    return ns.reshape(-1, 3) @ b


def _rows_per_block(row_bytes):
    return max(1024, _BLOCK_BYTES // max(int(row_bytes), 1))


def _wgram(F, w, F2=None):
    """Re[(F.conj() * w[:, None]).T @ F2] of (nG, M) / (nG, M2) complex
    tensors (F2 defaults to F) with non-negative weights w (nG,):
    Ar^T Br + Ai^T Bi of the sqrt(w)-scaled real and imaginary parts, in
    row blocks, on F's device."""
    nG, M = F.shape
    M2 = M if F2 is None else F2.shape[1]
    sw = torch.sqrt(w)
    out = torch.zeros((M, M2), dtype=torch.float64, device=F.device)
    blk = _rows_per_block(16 * (M + M2))
    for g0 in range(0, nG, blk):
        Fb = F[g0:g0 + blk]
        s = sw[g0:g0 + blk, None]
        Ar = Fb.real * s
        Ai = Fb.imag * s
        if F2 is None:
            Br, Bi = Ar, Ai
        else:
            F2b = F2[g0:g0 + blk]
            Br, Bi = F2b.real * s, F2b.imag * s
        out += Ar.T @ Br
        out += Ai.T @ Bi
    return out


def _expi(mag, ang):
    """mag * e^{i ang} of real tensors (mag may be negative)."""
    return torch.complex(mag * torch.cos(ang), mag * torch.sin(ang))


def _symm8(eri):
    """Enforce the 8-fold symmetry of a real chemist ERI (nao,)*4."""
    eri = 0.5 * (eri + eri.permute(1, 0, 2, 3))
    eri = 0.5 * (eri + eri.permute(0, 1, 3, 2))
    return 0.5 * (eri + eri.permute(2, 3, 0, 1))


class PbcCell(object):
    """BvK supercell torus with Gaussian AOs of arbitrary Cartesian l
    (general-l blocks from ints/md.py).

    atoms: [(symbol, xyz)], a: (3, 3) lattice vectors (rows), both in
    bohr unless unit='A'.  pseudo='gth-pade' replaces the bare nuclei by
    GTH pseudopotentials (ints/gth.py): point charges Z_ion in the Ewald
    machinery + short-ranged local remainder + projectors.  device: where
    the G-space work runs and the integrals are returned."""

    def __init__(self, atoms, a, basis="3-21g", unit="B", gmax=None,
                 precision=1e-12, pseudo=None, basis_data=None,
                 device=torch.device("cuda")):
        scale = BOHR_PER_ANGSTROM if unit.upper().startswith("A") else 1.0
        atoms = [(sym, np.asarray(xyz, float) * scale) for sym, xyz in atoms]
        self.mole = md.MoleGeneral(atoms, basis=basis, basis_data=basis_data)
        self.atoms = atoms
        self.basis = basis
        self.device = torch.device(device)
        self.a = np.asarray(a, float) * scale
        self.b = 2.0 * np.pi * np.linalg.inv(self.a).T   # reciprocal rows
        self.vol = abs(np.linalg.det(self.a))
        self.shells = self.mole.shells
        self.shell_slices = self.mole.shell_slices
        self.nao = self.mole.nao
        self.coords = self.mole.coords
        self.pseudo = pseudo
        if pseudo is None:
            self.pps = None
            self.charges = self.mole.charges
        else:
            from libdmet_preview_tpu_torch.ints.gth import GTH_PADE
            if pseudo != "gth-pade":
                raise ValueError("unknown pseudopotential %s" % pseudo)
            self.pps = [GTH_PADE[sym] for sym, _ in atoms]
            self.charges = np.asarray([pp["zion"] for pp in self.pps])
        self.nelectron = int(round(self.charges.sum()))
        self.precision = float(precision)
        # exponent floors set the real-space image cutoff (Gaussian
        # product decay exp(-mu |A-B|^2), mu >= a_min/2) and the
        # reciprocal cutoff (pair FT decay exp(-G^2/(4p)), p >= 2 a_min)
        exps = np.concatenate([sh.exps for sh in self.shells])
        self.min_exp = float(exps.min())
        logt = -np.log(self.precision)
        mu_min = 0.5 * self.min_exp
        self.rcut = np.sqrt(logt / mu_min) * 1.5
        p_pair_min = 2.0 * self.min_exp
        self.gmax = gmax if gmax is not None else \
            1.2 * np.sqrt(4.0 * p_pair_min * logt)
        self.mesh = self._mesh_from_gmax(self.gmax)
        self.ncells_tr = None
        self._cache = {}
        self._ft_cache = None

    def _mesh_from_gmax(self, gmax):
        mesh = []
        for i in range(3):
            # grid spacing along b_i covers |G| up to gmax
            db = np.linalg.norm(self.b[i])
            mesh.append(int(np.ceil(gmax / db)) * 2 + 1)
        return tuple(mesh)

    def _memo(self, key, fn):
        """fn()'s value, computed once per key and kept on the cell."""
        if key not in self._cache:
            self._cache[key] = fn()
        return self._cache[key]

    def _dev(self, x):
        return torch.as_tensor(np.ascontiguousarray(x), device=self.device)

    # ------------------------------------------------------------------
    def lattice_images(self, rcut=None):
        """Translation vectors T with |T| <= rcut + cell diameter."""
        rcut = self.rcut if rcut is None else rcut
        # bound the integer ranges via the inverse metric
        ainv = np.linalg.inv(self.a)
        nmax = [int(np.ceil(rcut * np.linalg.norm(ainv[:, i]))) + 1
                for i in range(3)]
        ns = np.array(list(it.product(*[range(-n, n + 1) for n in nmax])))
        return ns @ self.a

    def Gv(self):
        """All reciprocal vectors of the mesh (nG, 3), fftfreq ordering,
        G=0 first."""
        return _mesh_vectors(self.mesh, self.b)

    def coulG(self):
        """4 pi / G^2, zero at G=0 (background-compensated kernel)."""
        Gv = self.Gv()
        G2 = np.einsum("gi, gi -> g", Gv, Gv)
        w = np.zeros_like(G2)
        nz = G2 > 1e-12
        w[nz] = 4.0 * np.pi / G2[nz]
        return Gv, w

    def coulG_rs(self, omega, gmax=None):
        """Long-range Coulomb weights w(G) = 4pi/G^2 exp(-G^2/(4 w^2))
        on a coarse mesh (G=0 dropped, background convention): the
        Gaussian damping kills the kernel at G ~ 2 w sqrt(-ln prec),
        independent of the basis spectrum."""
        if gmax is None:
            gmax = 2.0 * omega * np.sqrt(-np.log(self.precision))
        Gv = _mesh_vectors(self._mesh_from_gmax(gmax), self.b)
        G2 = np.einsum("gi, gi -> g", Gv, Gv)
        w = np.zeros_like(G2)
        nz = G2 > 1e-12
        w[nz] = 4.0 * np.pi / G2[nz] * np.exp(-G2[nz]
                                              / (4.0 * omega ** 2))
        return Gv, w

    # ------------------------------------------------------------------
    # real-space lattice-summed 1-body integrals (host)
    # ------------------------------------------------------------------

    def _pair_images(self):
        return self._memo("images", self.lattice_images)

    def _pair_image_list(self, shi, shj):
        """Images T with non-negligible Gaussian pair overlap."""
        logt = -np.log(self.precision) * 1.5
        mu_min = (shi.exps.min() * shj.exps.min()
                  / (shi.exps.min() + shj.exps.min()))
        Ts = self._pair_images()
        d = shi.center - shj.center - Ts
        keep = np.einsum("ti, ti -> t", d, d) * mu_min < logt
        return Ts[keep]

    def set_translations(self, ncells, t_vecs):
        """Declare the BvK cell structure: the supercell consists of
        `ncells` identical cells (cell-major AO ordering) related by the
        translations t_vecs (ncells, 3), t_vecs[0] = 0.  Enables the
        STRIPE fast path: 1-body matrices are assembled for the first
        block column only and expanded by translation symmetry;
        ft_aopair reconstructs the remaining columns with e^{-iG.T}
        phases.  Drops the integrals the cell kept."""
        t_vecs = np.asarray(t_vecs, float)
        if self.nao % ncells != 0 or not np.allclose(t_vecs[0], 0.0):
            raise ValueError("set_translations: %d cells do not tile %d "
                             "AOs from T_0 = 0" % (ncells, self.nao))
        nshell_cell = len(self.shells) // ncells
        # verify the cell-major shell structure matches the translations
        for c in range(ncells):
            for s in range(nshell_cell):
                sh0 = self.shells[s]
                shc = self.shells[c * nshell_cell + s]
                if sh0.l != shc.l or not np.allclose(
                        shc.center - sh0.center, t_vecs[c], atol=1e-10):
                    raise ValueError("shells are not cell-major translates")
        self.ncells_tr = ncells
        self.t_vecs = t_vecs
        self.nshell_cell = nshell_cell
        self.nao_cell = self.nao // ncells
        # general (possibly 3D) translation-group difference table:
        # tr_diff[C, D] = index E with T_E = T_C - T_D (mod supercell);
        # for a 1D cyclic group this is (C - D) mod N
        frac = t_vecs @ np.linalg.inv(self.a)
        frac -= np.floor(frac + 1e-8)
        key = {tuple(np.round(f, 6)): i for i, f in enumerate(frac)}
        diff = np.empty((ncells, ncells), dtype=np.int64)
        for C in range(ncells):
            d = frac[C][None, :] - frac
            d -= np.floor(d + 1e-8)
            for D in range(ncells):
                diff[C, D] = key[tuple(np.round(d[D], 6))]
        self.tr_diff = diff
        self._cache = {}
        self._ft_cache = None
        return self

    def _expand_stripe_col(self, col):
        """First block column (nao, nao_cell) -> full (nao, nao) via
        <(C)s|V|(D)t> = <(C-D)s|V|(0)t> (cell-major ordering)."""
        N = self.ncells_tr
        m = self.nao_cell
        colb = col.reshape(N, m, m)
        out = np.empty((self.nao, self.nao))
        for D in range(N):
            # block rows C: source block index of T_C - T_D
            src = colb[self.tr_diff[:, D]]
            out[:, D * m:(D + 1) * m] = src.reshape(self.nao, m)
        return out

    def _fill_lattice(self, block_imgs_fn):
        """Generic lattice-summed 1-body assembly over shell pairs;
        block_imgs_fn(shi, shj, shifts) returns the IMAGE-SUMMED block.
        With set_translations, only the first block column is computed.
        The blocks are computed in a pool of native.num_threads() threads
        (each block alone, so the result does not depend on the count; the
        native sums release the interpreter lock)."""
        nao = self.nao
        stripe = bool(self.ncells_tr)
        if stripe:
            pairs = [(i, j) for i in range(len(self.shells))
                     for j in range(self.nshell_cell)]
        else:
            pairs = [(i, j) for i in range(len(self.shells))
                     for j in range(i + 1)]
        self._pair_images()

        def block(ij):
            shi, shj = self.shells[ij[0]], self.shells[ij[1]]
            return block_imgs_fn(shi, shj, self._pair_image_list(shi, shj))

        with ThreadPoolExecutor(native.num_threads()) as ex:
            blocks = list(ex.map(block, pairs))
        out = np.zeros((nao, self.nao_cell if stripe else nao))
        for (i, j), acc in zip(pairs, blocks):
            i0, i1 = self.shell_slices[i]
            j0, j1 = self.shell_slices[j]
            out[i0:i1, j0:j1] = acc
            if not stripe and i != j:
                out[j0:j1, i0:i1] = acc.T
        if stripe:
            out = self._expand_stripe_col(out)
        # i == j off-diagonal-image asymmetry: symmetrize
        return 0.5 * (out + out.T)

    def _one_body(self, block_imgs):
        logt = -np.log(self.precision) * 1.5
        with stage("cell 1-body (host)"):
            return self._fill_lattice(
                lambda a, b, T: block_imgs(a, b, T, logt=logt))

    def _ovlp_np(self):
        return self._memo("ovlp_np",
                          lambda: self._one_body(md.ovlp_block_imgs))

    def _kin_np(self):
        return self._memo("kin_np",
                          lambda: self._one_body(md.kin_block_imgs))

    def intor_ovlp(self):
        return self._memo("ovlp", lambda: self._dev(self._ovlp_np())).clone()

    def intor_kin(self):
        return self._memo("kin", lambda: self._dev(self._kin_np())).clone()

    # ------------------------------------------------------------------
    # torus pair Fourier transforms (device)
    # ------------------------------------------------------------------

    def ft_aopair(self, Gv, expand=True):
        """f_IJ(G) = sum_T FT[chi_I chi_J(. - T)](G), (nG, nao, nao)
        complex128 on the device (the periodized pair density's Fourier
        coefficients).  The last result is kept for its mesh (compared by
        shape, its first 8 vectors and `expand`).  With set_translations
        and expand=False, returns only the FIRST BLOCK COLUMN
        (nG, nao, nao_cell): the full tensor follows from
        f[(C)s,(D)t] = f[(C-D)s,(0)t] e^{-iG.T_D}."""
        cached = self._ft_cache
        if cached is not None and cached[0].shape == Gv.shape \
                and np.array_equal(cached[0][:8], Gv[:8]) \
                and cached[2] == expand:
            return cached[1]
        self._ft_cache = None           # free the old tensor first
        with stage("pair FT (device)", self.device):
            f = self._ft_aopair_impl(Gv, expand=expand)
        self._ft_cache = (np.array(Gv), f, expand)
        return f

    def _ft_terms(self, shi, shj, logt):
        """The Hermite pair data of one shell pair, every primitive pair's
        images stacked on one axis of M terms: (pref (M,), p (M,),
        P (M, 3), [E_x, E_y, E_z] each (l1+1, l2+1, lsum+1, M)) with
        pref = c12 (pi/p)^{3/2}; None when no image survives."""
        imgs = self._pair_image_list(shi, shj)
        terms = md._pair_E3_imgs(shi, shj, imgs, logt)
        if not terms:
            return None
        lsum = shi.l + shj.l
        pref = np.concatenate([np.full(P.shape[0], c12 * (np.pi / p) ** 1.5)
                               for p, c12, P, _, _ in terms])
        ps = np.concatenate([np.full(P.shape[0], p)
                             for p, _, P, _, _ in terms])
        Ps = np.concatenate([P for _, _, P, _, _ in terms])
        Es = [np.concatenate([E[d][:, :, :lsum + 1] for _, _, _, E, _
                              in terms], axis=-1) for d in range(3)]
        return pref, ps, Ps, Es

    def _ft_aopair_impl(self, Gv, expand=True):
        """General-l pair FT: the Hermite-expanded Fourier transform
        FT[Lambda_tuv](G) = (-iGx)^t (-iGy)^u (-iGz)^v (pi/p)^{3/2}
                            e^{-G^2/4p} e^{-iG.P},
        so  f_IJ(G) = sum_{imgs, prims} c12 sum_tuv E^x_t E^y_u E^z_v
                      (-iG)^{tuv} (pi/p)^{3/2} e^{-G^2/4p} e^{-iG.P}.
        Per shell pair, all primitive pairs and their images form one
        batch of M terms, contracted against blocks of G; the Hermite
        index is contracted per direction (separable), then the three
        directions are combined for every Cartesian pair at once."""
        dev = self.device
        nao = self.nao
        nG = Gv.shape[0]
        stripe = bool(self.ncells_tr)
        col_only = stripe and not expand
        ncol = self.nao_cell if col_only else nao
        f = torch.zeros((nG, nao, ncol), dtype=torch.complex128, device=dev)
        G = self._dev(Gv)
        G2 = torch.einsum("gi, gi -> g", G, G)
        lmax2 = 2 * max(sh.l for sh in self.shells)
        # powers (-i G_d)^k, (3, lmax2+1, nG)
        miG = torch.empty((3, lmax2 + 1, nG), dtype=torch.complex128,
                          device=dev)
        miG[:, 0] = 1.0
        for k in range(1, lmax2 + 1):
            miG[:, k] = miG[:, k - 1] * (-1j * G.T)
        if stripe:
            # first block column only; the remaining columns follow from
            # translation symmetry with e^{-iG.T_D} phases below
            pair_iter = [(i, j) for i in range(len(self.shells))
                         for j in range(self.nshell_cell)]
        else:
            pair_iter = [(i, j) for i in range(len(self.shells))
                         for j in range(i + 1)]
        logt_ft = -np.log(self.precision) * 1.5
        for i, j in pair_iter:
            shi, shj = self.shells[i], self.shells[j]
            i0, i1 = self.shell_slices[i]
            j0, j1 = self.shell_slices[j]
            data = self._ft_terms(shi, shj, logt_ft)
            if data is None:
                continue
            pref, ps, Ps, Es = data
            lsum = shi.l + shj.l
            M = pref.size
            # Cartesian pair (ii, jj) -> row of the (l1+1)(l2+1) E rows
            w2 = shj.l + 1
            idx = [self._dev(np.asarray([c1[d] * w2 + c2[d]
                                         for c1 in md.CART[shi.l]
                                         for c2 in md.CART[shj.l]]))
                   for d in range(3)]
            npair = shi.nc * shj.nc
            if lsum == 0:
                # s-s pair: the E tables are constants, folded into pref
                pref = pref * Es[0][0, 0, 0] * Es[1][0, 0, 0] \
                    * Es[2][0, 0, 0]
            pref_t, inv4p = self._dev(pref), self._dev(0.25 / ps)
            P_t = self._dev(Ps)
            E_t = [self._dev(E.reshape(-1, lsum + 1, M)).to(
                torch.complex128) for E in Es]
            gblk = _rows_per_block(16 * M * (npair + 4))
            for g0 in range(0, nG, gblk):
                gs = slice(g0, min(g0 + gblk, nG))
                # (M, nGb): radial decay x image phases
                mag = pref_t[:, None] * torch.exp(-G2[gs][None, :]
                                                  * inv4p[:, None])
                ang = -(P_t @ G[gs].T)
                if lsum == 0:
                    blk = torch.complex((mag * torch.cos(ang)).sum(dim=0),
                                        (mag * torch.sin(ang)).sum(dim=0))
                    f[gs, i0, j0] = blk
                    if not stripe and i != j:
                        f[gs, j0, i0] = blk
                    continue
                # separable Hermite FT per direction:
                # A_d[ab, m, g] = sum_t E_d[ab, t, m] (-i G_d)^t
                acc = _expi(mag, ang)[None]
                for d in range(3):
                    Ad = torch.einsum("atm, tg -> amg", E_t[d],
                                      miG[d, :lsum + 1, gs])
                    acc = acc * Ad[idx[d]]
                blk = acc.sum(dim=1).reshape(shi.nc, shj.nc, -1)
                f[gs, i0:i1, j0:j1] = blk.permute(2, 0, 1)
                if not stripe and i != j:
                    # the periodized pair function is a pointwise product
                    # and the image sum covers both signs: f_JI = f_IJ^T
                    f[gs, j0:j1, i0:i1] = blk.permute(2, 1, 0)
        if stripe and not col_only:
            # f[(C)s, (D)t](G) = f[(C-D)s, (0)t](G) e^{-iG.T_D}
            N = self.ncells_tr
            m = self.nao_cell
            ang = -(G @ self._dev(self.t_vecs).T)
            phases = _expi(torch.ones_like(ang), ang)
            colb = f[:, :, :m].reshape(nG, N, m, m)
            for D in range(1, N):
                src = colb[:, self._dev(self.tr_diff[:, D])].reshape(
                    nG, nao, m)
                f[:, :, D * m:(D + 1) * m] = src * phases[:, D, None, None]
        return f

    # ------------------------------------------------------------------
    # nuclear attraction: Ewald split
    # ------------------------------------------------------------------

    def intor_nuc(self, eta=None):
        """Electron-nucleus attraction with the G=0 term of the FULL
        kernel dropped (background-compensated; PySCF exxdiv=None / AFT
        get_nuc convention), by Ewald splitting:

          V = V_LR(G != 0, damped kernel 4 pi e^{-G^2/4 eta}/G^2)
            + V_SR(real-space erfc attraction over images)
            + (pi / (eta Omega)) Z_tot S_IJ        [G=0 of the SR split]
            (+ the GTH short range), then symmetrized.

        The long range (structure factor and G contraction) runs on the
        device, the rest on the host."""
        return self._memo(("nuc", eta), lambda: self._dev(
            self._nuc_np(eta))).clone()

    def _nuc_np(self, eta=None):
        logt = -np.log(self.precision)
        if eta is None:
            # LR branch must be converged on the existing mesh
            eta = (self.gmax ** 2) / (4.0 * logt)
        with stage("nuclear LR (device)", self.device):
            V = self._nuc_lr(eta)
        with stage("nuclear SR (host)"):
            V = self._nuc_sr(V, eta)
        # GTH short range: local remainder and projectors, lattice-summed
        # (the -Z_ion/r tail is in the Ewald point charges above)
        if self.pps is not None:
            with stage("GTH (host)"):
                V = V + self._pp_sr_matrix()
        return 0.5 * (V + V.T)

    def _nuc_lr(self, eta):
        """-Re sum_g wlr SF conj(f) / Omega on the device (with
        set_translations through the first block column), as a host
        (nao, nao) array."""
        Gv, w = self.coulG()
        G2 = np.einsum("gi, gi -> g", Gv, Gv)
        wlr = self._dev(w * np.exp(-G2 / (4.0 * eta)))
        G = self._dev(Gv)
        ang = -(G @ self._dev(self.coords).T)
        SF = _expi(torch.ones_like(ang), ang) @ self._dev(
            self.charges).to(torch.complex128)
        f = self.ft_aopair(Gv, expand=not self.ncells_tr)
        v = (wlr * SF)[None, :]
        Vcol = -(v @ f.reshape(f.shape[0], -1).conj()).real / self.vol
        V = Vcol.reshape(f.shape[1:]).cpu().numpy()
        if self.ncells_tr:
            V = self._expand_stripe_col(V)
        return V

    def _nuc_sr(self, V, eta):
        """V + the real-space erfc short range + its G=0 term, on the
        host, in the JAX package's order."""
        logt = -np.log(self.precision)
        # SR: real-space erfc attraction (general l, image-batched),
        # images of both the pair and the nuclei
        rcut_eta = np.sqrt(logt / eta) + 2.0
        ainv = np.linalg.inv(self.a)
        nmax = [int(np.ceil((rcut_eta + self.rcut)
                            * np.linalg.norm(ainv[:, i]))) + 1
                for i in range(3)]
        Tn = np.array(list(it.product(*[range(-n, n + 1) for n in nmax])))
        Tall = Tn @ self.a
        nuc_imgs = (self.coords[:, None, :]
                    + Tall[None, :, :]).reshape(-1, 3)
        Zs = np.repeat(self.charges, Tall.shape[0])

        p_min = 2.0 * self.min_exp
        rng_sr = np.sqrt(logt * 1.5 / min(eta, p_min)) + 2.0

        def sr_block(shi, shj, imgs):
            return self._sr_flat_block(shi, shj, imgs, Zs, nuc_imgs,
                                       [("erfc", eta, 1.0)],
                                       rng_sr, logt * 1.5)

        native.get_sr_lib()
        V = V + self._fill_lattice(sr_block)
        # G=0 term of the SR reciprocal branch (pyscf's charged-background
        # correction): +(pi/(eta Omega)) Z_tot S_IJ
        return V + (np.pi / (eta * self.vol)) * self.charges.sum() \
            * self._ovlp_np()

    def _sr_flat_block(self, shi, shj, imgs, Zs, ctrs, kernels, rng,
                       logt):
        """Short-ranged kernel block with FLAT (pair-image, center)
        active-pair batching: per primitive pair, only the (T, C)
        combinations with |P(T) - C| < rng survive.

        kernels: list of ('erfc', eta, wz) -> wz * sum_C Z_C erfc-attr,
                 ('gauss', beta, (c1, c2, rloc)) -> Gaussian + r^2
                 polynomial terms (complex step for r^2), or
                 ('gauss_pow', beta, (ck, k, rloc)) -> exact polynomial-
                 kernel term; Zs ignored for the Gaussian kernels.
        The native core takes lsum <= 4 except 'gauss_pow'; the rest runs
        in NumPy."""
        CART, R_table = md.CART, md.R_table
        out = np.zeros((shi.nc, shj.nc))
        rng2 = rng * rng
        # shell-level candidate (image, center) pairs: P always lies on
        # the A..B+T segment, so |mid - C| < rng + halfspan is a valid
        # superset screen evaluated ONCE (not per primitive)
        imgs = np.atleast_2d(np.asarray(imgs, float))
        Bimg = shj.center[None, :] + imgs
        mids = 0.5 * (shi.center[None, :] + Bimg)
        half = 0.5 * np.linalg.norm(shi.center[None, :] - Bimg, axis=1)
        lim2 = (rng + half) ** 2
        # |mid - c|^2 via the Gram expansion
        m2 = np.einsum("ki, ki -> k", mids, mids)
        ci_list, cc_list = [], []
        for c0 in range(0, ctrs.shape[0], 8192):   # bounded buffers
            cch = ctrs[c0:c0 + 8192]
            d2m = (m2[:, None]
                   + np.einsum("ci, ci -> c", cch, cch)[None, :]
                   - 2.0 * (mids @ cch.T))
            ki, kc = np.nonzero(d2m < lim2[:, None])
            ci_list.append(ki)
            cc_list.append(kc + c0)
        if not ci_list or sum(x.size for x in ci_list) == 0:
            return out
        cand_img = np.ascontiguousarray(np.concatenate(ci_list),
                                        dtype=np.int64)
        cand_c = np.ascontiguousarray(np.concatenate(cc_list),
                                      dtype=np.int64)
        ctrs_c = np.ascontiguousarray(ctrs, dtype=np.float64)
        Zs_c = np.ascontiguousarray(Zs, dtype=np.float64)
        ones_c = np.ones(ctrs.shape[0])
        lsum = shi.l + shj.l
        use_fused = lsum <= 4 and native.get_sr_lib() is not None
        kern_fused = [kk for kk in kernels
                      if use_fused and kk[0] != "gauss_pow"]
        kern_np = [kk for kk in kernels
                   if not use_fused or kk[0] == "gauss_pow"]
        shp = (lsum + 1, lsum + 1, lsum + 1)

        # the E rows of every Cartesian pair (i, j), per direction
        cart = [(a, b) for a in CART[shi.l] for b in CART[shj.l]]
        rows = [(np.asarray([a[d] for a, _ in cart]),
                 np.asarray([b[d] for _, b in cart])) for d in range(3)]

        def _accum(S, fac, Ex, Ey, Ez):
            # out[i, j] += fac sum_{tuv, img} Ex[t] Ey[u] Ez[v] S[t, u, v]
            # (E is zero beyond each pair's own t / u / v range)
            Es = [E[r1, r2, :lsum + 1] for E, (r1, r2)
                  in zip((Ex, Ey, Ez), rows)]
            val = np.einsum("ptk, puk, pvk, tuvk -> p", *Es, S,
                            optimize=True)
            out[...] += fac * val.reshape(shi.nc, shj.nc)

        for p, c12, P, (Ex, Ey, Ez), sel in md._pair_E3_imgs(shi, shj, imgs,
                                                             logt):
            nimg_p = P.shape[0]
            if kern_fused:
                # native fused pass: image remap + range screen + kernel
                # sums in C (sr_cand_sum)
                inv = np.full(imgs.shape[0], -1, dtype=np.int64)
                inv[sel] = np.arange(sel.size, dtype=np.int64)
                Pc = np.ascontiguousarray(P)
                for kind, par, extra in kern_fused:
                    if kind == "erfc":
                        sf = par / (p + par)
                        fac = -extra * c12 * (2.0 * np.pi / p)
                        S1 = native.sr_cand_sum(
                            lsum, Pc, inv, cand_img, cand_c, ctrs_c,
                            Zs_c, rng2, p, 0, low=True)[0]
                        S2 = native.sr_cand_sum(
                            lsum, Pc, inv, cand_img, cand_c, ctrs_c,
                            Zs_c, rng2, p * sf, 0, low=True)[0]
                        S = (S1 - np.sqrt(sf) * S2).reshape(shp + (nimg_p,))
                    elif kind == "gauss":
                        c1, c2, rloc = extra
                        h = 1e-200
                        beta = par + 1j * h
                        pref = (np.pi / (p + beta)) ** 1.5
                        fac = c12
                        gam = p * beta / (p + beta)
                        Sr, Si = native.sr_cand_sum(
                            lsum, Pc, inv, cand_img, cand_c, ctrs_c,
                            ones_c, rng2, gam, 1, low=True)
                        Sc = (Sr + 1j * Si) * pref
                        S = (c1 * Sc.real
                             + (c2 * (-(Sc.imag / h)) / (rloc * rloc)
                                if c2 != 0.0 else 0.0)).reshape(
                            shp + (nimg_p,))
                    else:
                        raise ValueError(kind)
                    _accum(S, fac, Ex, Ey, Ez)
            if not kern_np:
                continue

            # NumPy branch (lsum > 4, gauss_pow, or no native core):
            # explicit candidate mapping onto this primitive's image set
            inv = np.full(imgs.shape[0], -1, dtype=int)
            inv[sel] = np.arange(sel.size)
            loc = inv[cand_img]
            ok = loc >= 0
            if not np.any(ok):
                continue
            loc = loc[ok]
            cc = cand_c[ok]
            PCc = P[loc] - ctrs[cc]
            exact = np.einsum("ki, ki -> k", PCc, PCc) < rng2
            if not np.any(exact):
                continue
            k_img = loc[exact]
            PC = PCc[exact]                              # (nact, 3)
            Zk = Zs[cc[exact]]
            for kind, par, extra in kern_np:
                S = None
                if kind == "erfc":
                    sf = par / (p + par)
                    fac = -extra * c12 * (2.0 * np.pi / p)
                    nat = native.sr_hermite_sum(lsum, PC, Zk, k_img,
                                                nimg_p, p, 0)
                    if nat is not None:
                        S2 = native.sr_hermite_sum(lsum, PC, Zk, k_img,
                                                   nimg_p, p * sf, 0)[0]
                        S = (nat[0] - np.sqrt(sf) * S2).reshape(
                            shp + (nimg_p,))
                    else:
                        R = R_table(lsum, lsum, lsum, p, PC) \
                            - np.sqrt(sf) * R_table(lsum, lsum, lsum,
                                                    p * sf, PC)
                        Rw = R * Zk
                elif kind == "gauss":
                    c1, c2, rloc = extra
                    h = 1e-200
                    beta = par + 1j * h
                    pref = (np.pi / (p + beta)) ** 1.5
                    fac = c12
                    gam = p * beta / (p + beta)
                    nat = native.sr_hermite_sum(
                        lsum, PC, np.ones(len(PC)), k_img, nimg_p, gam, 1)
                    if nat is not None:
                        Sc = (nat[0] + 1j * nat[1]) * pref
                        S = (c1 * Sc.real
                             + (c2 * (-(Sc.imag / h)) / (rloc * rloc)
                                if c2 != 0.0 else 0.0)).reshape(
                            shp + (nimg_p,))
                    else:
                        Rg = pref * R_table(lsum, lsum, lsum, gam, PC,
                                            kernel="gauss")
                        R = c1 * Rg.real
                        if c2 != 0.0:
                            R = R + c2 * (-(Rg.imag / h)) / (rloc * rloc)
                        Rw = R
                elif kind == "gauss_pow":
                    # exact polynomial-kernel term C_k (r/rloc)^{2k}
                    # e^{-beta r^2} (GTH C3/C4 local coefficients)
                    ck, kpow, rloc = extra
                    beta = par
                    gam = p * beta / (p + beta)
                    pref = (np.pi / (p + beta)) ** 1.5
                    fac = c12
                    Rw = (ck / rloc ** (2 * kpow)) * pref * R_table(
                        lsum, lsum, lsum, gam, PC, kernel="gauss",
                        poly=md.gauss_pow_poly(kpow, p, beta))
                else:
                    raise ValueError(kind)
                if S is None:
                    # reduce actives to PER-IMAGE sums
                    S = np.zeros(shp + (nimg_p,))
                    for t in range(lsum + 1):
                        for u in range(lsum + 1):
                            for v in range(lsum + 1):
                                S[t, u, v] = np.bincount(
                                    k_img, weights=Rw[t, u, v],
                                    minlength=nimg_p)
                _accum(S, fac, Ex, Ey, Ez)
        return out

    def _pp_sr_matrix(self):
        """Short-ranged GTH terms, lattice-summed (image-batched): the
        local remainder, and the nonlocal part sum_{A,T,lm,ij}
        <a|p_i^lm,A+T> h^l_ij <p_j^lm,A+T|b> with the FULL projector-AO
        overlap lattice sums (general l <= 2 channels; p_i expands into
        Cartesian monomials of degree l + 2(i-1), ints/gth.py
        projector_cart)."""
        from scipy.linalg import block_diag

        from libdmet_preview_tpu_torch.ints.gth import gth_channels
        nao = self.nao
        logt = -np.log(self.precision) * 1.5
        Ts = self._pair_images()

        # group atoms by pseudopotential species (batch their images)
        groups = {}
        for A, pp in enumerate(self.pps):
            groups.setdefault(id(pp), (pp, []))[1].append(A)
        p_min = 2.0 * self.min_exp

        def loc_block(shi, shj, imgs):
            out = np.zeros((shi.nc, shj.nc))
            for _, (pp, idxA) in groups.items():
                eta_A = 1.0 / (2.0 * pp["rloc"] ** 2)
                zion = pp["zion"]
                cloc = list(pp["cloc"]) + [0.0, 0.0]
                ctrs = (np.asarray([self.coords[A] for A in idxA])
                        [:, None, :] + Ts[None, :, :]).reshape(-1, 3)
                rng = np.sqrt(logt / min(eta_A, p_min)) + 2.0
                Zk = np.full(len(ctrs), zion)
                # erfc remainder (+Z_ion erfc/r: extra = -1 flips the
                # attraction sign) + Gaussian polynomial terms (C1/C2 on
                # the complex-step path, C3/C4 exact polynomial kernels)
                kernels = [("erfc", eta_A, -1.0),
                           ("gauss", eta_A,
                            (cloc[0], cloc[1], pp["rloc"]))]
                for kpow in range(2, len(pp["cloc"])):
                    if pp["cloc"][kpow] != 0.0:
                        kernels.append(("gauss_pow", eta_A,
                                        (pp["cloc"][kpow], kpow,
                                         pp["rloc"])))
                out += self._sr_flat_block(shi, shj, imgs, Zk, ctrs,
                                           kernels, rng, logt)
            return out

        native.get_sr_lib()
        V = self._fill_lattice(loc_block)

        # nonlocal: per atom, rows = stacked (channel, i, m) projector
        # components; <chi~_I | p-row> as image-batched overlap sums of
        # the raw Cartesian monomial shells contracted with W
        stripe = bool(self.ncells_tr)
        natm_calc = (len(self.pps) // self.ncells_tr if stripe
                     else len(self.pps))
        rows = []        # (nrow_total, nao) projector-AO overlaps
        hblocks = []     # per-atom coupling H = blockdiag kron(h, I_m)
        for A in range(natm_calc):
            chans = gth_channels(self.pps[A], self.coords[A])
            if not chans:
                continue
            arow = []
            ahb = []
            for h, l, comps in chans:
                for shp, W in comps:
                    ov_raw = np.zeros((shp.nc, nao))
                    for i, shi in enumerate(self.shells):
                        i0, i1 = self.shell_slices[i]
                        mu_min = (shp.exps.min() * shi.exps.min()
                                  / (shp.exps.min() + shi.exps.min()))
                        d = shi.center + Ts - shp.center
                        keep = np.einsum("ti, ti -> t", d,
                                         d) * mu_min < logt
                        if not np.any(keep):
                            continue
                        ov_raw[:, i0:i1] = md.ovlp_block_imgs(
                            shp, shi, Ts[keep])
                    arow.append(W @ ov_raw)          # (2l+1, nao)
                # coupling between radial components of this channel,
                # diagonal in m: rows ordered (i, m) -> kron(h, I)
                ahb.append(np.kron(h, np.eye(2 * l + 1)))
            rows.append(np.concatenate(arow, axis=0))
            hblocks.append(block_diag(*ahb))
        if rows:
            ov0 = np.concatenate(rows, axis=0)
            H0 = block_diag(*hblocks)
            if stripe:
                # roll cell-0 projector overlaps to every cell C:
                # <p in cell C | chi in cell D> = cell-0 block (D - C)
                N = self.ncells_tr
                m = self.nao_cell
                npc = ov0.shape[0]
                blocks = ov0.reshape(npc, N, m)
                for C in range(N):
                    ovC = blocks[:, self.tr_diff[:, C]].reshape(npc, nao)
                    V = V + ovC.T @ (H0 @ ovC)
            else:
                V = V + ov0.T @ (H0 @ ov0)
        return V

    def intor_hcore(self):
        return self.intor_kin() + self.intor_nuc()

    # ------------------------------------------------------------------
    # two-electron integrals
    # ------------------------------------------------------------------

    def intor_eri(self, blksize=None):
        """(IJ|KL) = (1/Omega) sum_G w(G) f_IJ(G)^* f_KL(G), chemist
        notation, real, (nao,)*4 on the device.  blksize: the JAX
        package's G rows per block, accepted and not read: the port sizes
        its G blocks by bytes (_rows_per_block), so the values do not
        depend on it (the same holds for the other ERI methods)."""
        return self._memo("eri", self._eri).clone()

    def _eri(self):
        Gv, w = self.coulG()
        f = self.ft_aopair(Gv)
        nao = self.nao
        with stage("LR ERI Gram (device)", self.device):
            eri = _wgram(f.reshape(f.shape[0], nao * nao), self._dev(w))
        return _symm8((eri / self.vol).reshape(nao, nao, nao, nao))

    def intor_eri_rs(self, omega=None, gmax_lr=None, blksize=None,
                     pair_tol=None):
        """Dense torus ERI by RANGE SEPARATION: real-space erfc short
        range (native lattice-summed quadruples, host) + coarse-G-mesh
        erf long range (device) + G=0 correction.

        The CONVERGED dense-ERI path for bases with sharp exponents: the
        bare G-space sum (intor_eri) converges like exp(-gmax^2/(2 p_max))
        with the TIGHTEST pair exponent, while here sharp pairs are summed
        exactly in real space and the G mesh only carries the
        Gaussian-damped erf kernel (gmax ~ 2 w sqrt(-ln prec))."""
        if omega is None:
            # SR image range ~ sqrt(lntol)/w vs LR mesh ~ 2 w sqrt(lntol)
            omega = 1.0
        return self._memo(("eri_rs", omega, gmax_lr, pair_tol),
                          lambda: self._eri_rs(omega, gmax_lr,
                                               pair_tol)).clone()

    def _eri_rs(self, omega, gmax_lr, pair_tol):
        eri = self._sr_dense(omega, pair_tol)
        nao = self.nao
        # LR: Gaussian-damped Coulomb on the coarse mesh
        Gv, w = self.coulG_rs(omega, gmax=gmax_lr)
        f = self.ft_aopair(Gv)
        with stage("LR ERI Gram (device)", self.device):
            lr = _wgram(f.reshape(f.shape[0], nao * nao), self._dev(w))
        eri = self._dev(eri) + lr.reshape((nao,) * 4) / self.vol
        # G=0 of the SR kernel (pi/w^2), removed to match the
        # G=0-dropped background convention
        S = self._dev(self._ovlp_np())
        eri -= (np.pi / (omega ** 2 * self.vol)) \
            * torch.einsum("ij, kl -> ijkl", S, S)
        return _symm8(eri)

    def _sr_dense(self, omega, pair_tol):
        """The short-range rows expanded by translation symmetry to the
        dense (nao,)*4 ERI (host):
        (Ci, Jq | Kr, Ls) = (0i, (J-C)q | (K-C)r, (L-C)s)."""
        eri = self._sr_ao_eri_rows(omega, pair_tol=pair_tol)
        N = self.ncells_tr or 1
        if N == 1:
            return eri
        nao = self.nao
        m = self.nao_cell
        e0 = eri.reshape(m, N, m, N, m, N, m)
        dense = np.empty((N, m, nao, nao, nao))
        for C in range(N):
            perm = self.tr_diff[:, C]
            dense[C] = e0[:, perm][:, :, :, perm][:, :, :, :, :,
                                                  perm].reshape(
                m, nao, nao, nao)
        return dense.reshape(nao, nao, nao, nao)

    def eri_trans_full(self, blksize=None, Gw=None):
        """Translation-symmetric supercell ERI in the 'full' H2 format
        (models/hamiltonian.py): eri_F[R1, R2, R3, p, q, r, s] =
        (0p R1q | R2r R3s), (N,)*3 + (m,)*4 on the device, assembled from
        the FIRST FT BLOCK COLUMN only:

          (0p R1q | R2r R3s) = (1/Omega) sum_G w(G)
              conj(f[G, R1q, 0p]) e^{-iG.T_R2} f[G, (R3-R2)s, 0r]

        one complex GEMM per G block for all R2 at once.  Gw: optional
        (Gv, w) kernel override (eri_trans_full_rs passes the coarse
        damped-erf mesh)."""
        if not self.ncells_tr:
            raise ValueError("eri_trans_full requires set_translations")
        if Gw is not None:
            return self._eri_trans_full(Gw)
        return self._memo("eri_F", lambda: self._eri_trans_full(
            self.coulG())).clone()

    def _eri_trans_full(self, Gw):
        N = self.ncells_tr
        m = self.nao_cell
        Gv, w = Gw
        nG = Gv.shape[0]
        fcol = self.ft_aopair(Gv, expand=False)       # (nG, nao, m)
        # Bra[G, R1, p, q] = f[G, R1q, 0p];  Ket[G, D, r, s] = f[G, Ds, 0r]
        K = N * m * m
        Bra = fcol.reshape(nG, N, m, m).transpose(2, 3).reshape(nG, K)
        w_t = self._dev(w)
        ang = -(self._dev(Gv) @ self._dev(self.t_vecs).T)
        phases = _expi(torch.ones_like(ang), ang)
        acc = torch.zeros((K, N * K), dtype=torch.complex128,
                          device=self.device)
        blk = _rows_per_block(16 * (N + 1) * K)
        with stage("eri_trans_full Gram (device)", self.device):
            for g0 in range(0, nG, blk):
                sl = slice(g0, g0 + blk)
                Bs = Bra[sl]
                # X[g, R2, D r s] = Ket[g, D r s] w(g) e^{-iG.T_R2}
                wp = w_t[sl, None] * phases[sl]
                X = (Bs[:, None, :] * wp[:, :, None]).reshape(-1, N * K)
                acc += Bs.conj().T @ X
        # blk[R1, p, q, R2, D, r, s] -> out[R1, R2, R3] at D = R3 - R2
        full = (acc.real / self.vol).reshape(N, m, m, N, N, m, m).permute(
            0, 3, 4, 1, 2, 5, 6)
        R2 = torch.arange(N, device=self.device)[:, None].expand(N, N)
        D = self._dev(self.tr_diff.T)                 # D[R2, R3]
        return full[:, R2, D].contiguous()

    def eri_trans_full_rs(self, omega=1.0, gmax_lr=None, blksize=None,
                          pair_tol=None):
        """Translation-'full' supercell ERI by RANGE SEPARATION: the
        native short-range rows (host) reindexed into the full format +
        the erf long range on the coarse damped mesh (device) + the G=0
        correction.  The CONVERGED eri_trans_full for bases whose sharp
        pairs exceed the default G mesh."""
        if not self.ncells_tr:
            raise ValueError("eri_trans_full_rs requires set_translations")
        return self._memo(("eri_F_rs", omega, gmax_lr, pair_tol),
                          lambda: self._eri_trans_full_rs(
                              omega, gmax_lr, pair_tol)).clone()

    def _eri_trans_full_rs(self, omega, gmax_lr, pair_tol):
        N = self.ncells_tr
        m = self.nao_cell
        eri0 = self._sr_ao_eri_rows(omega, pair_tol=pair_tol)
        # (0p, Jq | Kr, Ls) -> eri_F[J, K, L, p, q, r, s]
        out = self._dev(eri0).reshape(m, N, m, N, m, N, m).permute(
            1, 3, 5, 0, 2, 4, 6)
        out = out + self._eri_trans_full(self.coulG_rs(omega, gmax=gmax_lr))
        # G=0 of the SR kernel in the full format:
        #   -(pi/(w^2 Omega)) S[0p, R1q] S[R2r, R3s]
        S = self._dev(self._ovlp_np()).reshape(N, m, N, m)
        Scol = S[0].transpose(0, 1)                   # (N, m, m): [J, p, q]
        c = np.pi / (omega ** 2 * self.vol)
        D = self._dev(self.tr_diff)                   # D[R3, R2]
        for R2 in range(N):
            out[:, R2] -= c * torch.einsum("Jpq, Lrs -> JLpqrs", Scol,
                                           Scol[D[:, R2]])
        return out

    def _sr_ao_eri_rows(self, omega, pair_tol=None):
        """SHORT-RANGE AO ERI first-block rows (host), kept on the cell per
        (omega, pair_tol) (the lattice build and the embedding drivers
        each ask for their omega again): the torus lattice sum of
        real-space erfc(w r)/r AO quadruples, bra first index pinned to
        cell 0: eri0[p, Jq, Kr, Ls] = (0p Jq | erfc | Kr Ls), shape
        (nao_cell, nao, nao, nao) for stripe cells, (nao,)*4 otherwise.
        Includes the kernel's G=0 average (pi/w^2); RS callers subtract
        it.  The native core (erfc_eri_rows_batch, on
        native.num_threads() threads) takes max l <= 2 and at most 16,384
        images; otherwise md.eri_block_erfc_tsum runs per quadruple.
        Callers must not write to the array they get."""
        prec = self.precision if pair_tol is None else pair_tol

        def rows():
            with stage("SR ERI rows (host)"):
                return self._sr_rows(omega, prec)
        return self._memo(("sr_rows", float(omega), float(prec)), rows)

    def _sr_rows(self, omega, prec, nthreads=None):
        nao = self.nao
        rcut_k = np.sqrt(-np.log(prec)) / omega
        shells = self.shells
        nsh = len(shells)
        N = self.ncells_tr or 1
        nsh_bra = self.nshell_cell if N > 1 else nsh
        m = self.nao_cell if N > 1 else nao

        def ext(sh):
            return np.sqrt(-np.log(prec) / sh.exps.min())

        def pair_groups(row_shells, canonical=False):
            """Per shell pair (i, j): its images T and ket-swap flags.
            canonical=True keeps one member of each {(k,l,T), (l,k,-T)}
            orbit (real orbitals: the two give transposed ket blocks,
            (pq|rs) = (pq|sr)) with dup=True, self pairs (k==l, T==0,
            symmetric block) dup=False; in the JAX package's order."""
            out = []
            for i in row_shells:
                for j in range(nsh):
                    if canonical and j < i:
                        continue
                    Ts = self._pair_image_list(shells[i], shells[j])
                    dup = np.ones(len(Ts), dtype=bool)
                    if canonical and j == i:
                        # keep round(T) >= round(-T) lexicographically
                        key, mkey = np.round(Ts, 8), np.round(-Ts, 8)
                        ne = key != mkey
                        first = np.argmax(ne, axis=1)
                        rows_ = np.arange(len(Ts))
                        less = ne.any(axis=1) & (key[rows_, first]
                                                 < mkey[rows_, first])
                        dup = ne.any(axis=1)[~less]
                        Ts = Ts[~less]
                    if len(Ts):
                        out.append((i, j, Ts, dup))
            return out

        bras = pair_groups(range(nsh_bra))
        kets = pair_groups(range(nsh), canonical=True)
        Tks = np.ascontiguousarray(self.lattice_images(
            rcut_k + 2.0 * max(ext(sh) for sh in shells)), dtype=float)
        eri0 = np.zeros((m, nao, nao, nao))
        lib = native.get_sr_lib()
        if lib is not None and max(sh.l for sh in shells) <= 2 \
                and len(Tks) <= 16384:
            self._sr_rows_native(lib, bras, kets, omega, prec, eri0,
                                 nthreads)
            return eri0
        for (i, j, TJs, _) in bras:
            shi, shj = shells[i], shells[j]
            i0, i1 = self.shell_slices[i]
            j0, j1 = self.shell_slices[j]
            for TJ in TJs:
                Pm = 0.5 * (shi.center + shj.center + TJ)
                Pr = (0.5 * np.linalg.norm(shi.center - shj.center - TJ)
                      + max(ext(shi), ext(shj)))
                for (k, l, TLs, dups) in kets:
                    shk, shl = shells[k], shells[l]
                    k0, k1 = self.shell_slices[k]
                    l0, l1 = self.shell_slices[l]
                    for TL, dup in zip(TLs, dups):
                        Qm = 0.5 * (shk.center + shl.center + TL)
                        Qr = (0.5 * np.linalg.norm(shk.center - shl.center
                                                   - TL)
                              + max(ext(shk), ext(shl)))
                        d = Pm - Qm - Tks
                        keep = np.einsum("ti, ti -> t", d, d) \
                            < (rcut_k + Pr + Qr) ** 2
                        if not np.any(keep):
                            continue
                        blk = md.eri_block_erfc_tsum(
                            shi, shj, shk, shl, (TJ, None, TL),
                            Tks[keep], omega, tol=prec)
                        eri0[i0:i1, j0:j1, k0:k1, l0:l1] += blk
                        if dup:   # (pq|rs) = (pq|sr): ket-swap partner
                            eri0[i0:i1, j0:j1, l0:l1, k0:k1] += \
                                blk.transpose(0, 1, 3, 2)
        return eri0

    def _sr_rows_native(self, lib, bras, kets, omega, prec, eri0,
                        nthreads):
        """Pack the bra and ket pairs (every image of a shell pair at once)
        and run csrc/_sr_core.cpp erfc_eri_rows_batch into eri0.  Kets
        whose magnitude bound fails for every bra are left out before
        packing; the core skips the same kets per bra (exact)."""
        import ctypes
        shells = self.shells
        nao = self.nao
        lntol = -np.log(prec)
        s0, s1, s2 = nao ** 3, nao ** 2, nao
        two_pi_2_5 = 2.0 * 17.493418327624862

        def mag(pc):
            """(max |c| max|E| / p, min p) per pair image."""
            return ((np.abs(pc[..., 1]) * pc[..., 5] / pc[..., 0]).max(-1),
                    pc[..., 0].min(-1))

        bmeta, bpc, bE, goff, gcost = [], [], [], [0], []
        p_off = e_off = 0
        for (i, j, TJs, _) in bras:
            pc, E = md.pair_prim_dense_imgs(shells[i], shells[j], TJs)
            nimg, npr = pc.shape[:2]
            blk = E[0].size
            i0, j0 = self.shell_slices[i][0], self.shell_slices[j][0]
            for t in range(nimg):
                bmeta.append((shells[i].l + shells[j].l, shells[i].nc,
                              shells[j].nc, p_off + t * npr, npr,
                              e_off + t * blk, i0 * s0 + j0 * s1))
            bpc.append(pc.reshape(-1, 6))
            bE.append(E.ravel())
            p_off += nimg * npr
            e_off += E.size
            goff.append(goff[-1] + nimg)
            gcost.append(nimg * E[0].size)
        bpc = np.ascontiguousarray(np.concatenate(bpc))
        bmax, pmin = mag(bpc[None])
        bmax, pmin = float(bmax[0]), float(pmin[0])

        kmeta, kpc, kE = [], [], []
        p_off = e_off = 0
        for (k, l, TLs, dups) in kets:
            pc, E = md.pair_prim_dense_imgs(shells[k], shells[l], TLs)
            kmax, qmin = mag(pc)
            with np.errstate(divide="ignore"):
                live = np.log(two_pi_2_5 * bmax * kmax
                              / np.sqrt(pmin + qmin)) + 1e-6 + lntol > 0.0
            if not live.any():
                continue
            pc, E, dups = pc[live], E[live], dups[live]
            nimg, npr = pc.shape[:2]
            blk = E[0].size
            k0, l0 = self.shell_slices[k][0], self.shell_slices[l][0]
            for t in range(nimg):
                kmeta.append((shells[k].l + shells[l].l, shells[k].nc,
                              shells[l].nc, p_off + t * npr, npr,
                              e_off + t * blk, k0 * nao + l0,
                              l0 * nao + k0 if dups[t] else -1))
            kpc.append(pc.reshape(-1, 6))
            kE.append(E.ravel())
            p_off += nimg * npr
            e_off += E.size
        if not kmeta:
            return
        Amat = np.ascontiguousarray(self.a, dtype=float)
        Ainv = np.ascontiguousarray(np.linalg.inv(Amat))
        lib.erfc_eri_rows_batch(
            len(bmeta), np.ascontiguousarray(bmeta, dtype=np.int64),
            bpc, np.ascontiguousarray(np.concatenate(bE)),
            len(gcost), np.asarray(goff, dtype=np.int64),
            np.ascontiguousarray(np.argsort(gcost)[::-1], dtype=np.int64),
            len(kmeta), np.ascontiguousarray(kmeta, dtype=np.int64),
            np.ascontiguousarray(np.concatenate(kpc)),
            np.ascontiguousarray(np.concatenate(kE)),
            Amat, Ainv, np.ascontiguousarray(np.linalg.norm(Ainv, axis=0)),
            float(omega), float(lntol), s0, s1, s2,
            native.num_threads() if nthreads is None else int(nthreads),
            ctypes.c_void_p(eri0.ctypes.data))

    # ------------------------------------------------------------------
    # embedding-space ERI drivers: the supercell AO ERI is never formed.
    # Chemist notation, real, float64 tensors (neo,)*4 on the device; the
    # same symmetrization averages and 1/Omega as the JAX package.
    # ------------------------------------------------------------------

    def _tr_add(self):
        """add[R, c] = E with tr_diff[E, c] == R (T_E = T_R + T_c), a
        long tensor on the device."""
        def make():
            N = self.ncells_tr
            add = np.empty_like(self.tr_diff)
            add[self.tr_diff, np.arange(N)[None, :]] = np.arange(N)[:, None]
            return torch.as_tensor(add, device=self.device)
        return self._memo("tr_add", make)

    def _emb_g(self, C, Gv, w):
        """The embedding pair transforms g[G] = C^T f(G) C (nG, neo*neo)
        of a dense cell, built per G block (blocks with w == 0 are
        skipped, as their Gram term is zero)."""
        neo = C.shape[1]
        Cc = C.to(torch.complex128)
        g = torch.zeros((Gv.shape[0], neo * neo), dtype=torch.complex128,
                        device=self.device)
        blk = _rows_per_block(16 * self.nao * self.nao * 2)
        for g0 in range(0, Gv.shape[0], blk):
            if not np.any(w[g0:g0 + blk]):
                continue
            f = self._ft_aopair_impl(Gv[g0:g0 + blk])
            g[g0:g0 + blk] = (Cc.T @ f @ Cc).reshape(f.shape[0], -1)
        return g

    def _emb_g_aft(self, C_emb, Gv, blksize=8192):
        """g[G, i, j] = (C^T f(G) C)_ij (nG, neo, neo) from the CACHED
        first-block-column pair FT of a stripe cell:
          g[G] = sum_D e^{-iG.T_D} Crow_D^T fcol(G) C_D,
        Crow_D the rows of C permuted by +D.  The permuted row blocks are
        gathered once as an (N, nao, neo) tensor, and each G block is one
        batched contraction over D."""
        C = as_f64(C_emb, self.device)
        nao, neo = C.shape
        N = self.ncells_tr
        m = self.nao_cell
        fcol = self.ft_aopair(Gv, expand=False)     # (nG, nao, m)
        G = self._dev(Gv)
        ang = -(G @ self._dev(self.t_vecs).T)
        phases = _expi(torch.ones_like(ang), ang)    # (nG, N)
        Cb = C.reshape(N, m, neo).to(torch.complex128)
        Crow = Cb[self._tr_add().T].reshape(N, nao, neo)   # [D] = Cb[add[:, D]]
        nG = Gv.shape[0]
        g = torch.empty((nG, neo, neo), dtype=torch.complex128,
                        device=self.device)
        blk = min(blksize, _rows_per_block(16 * N * neo * (m + neo)))
        for g0 in range(0, nG, blk):
            sl = slice(g0, g0 + blk)
            # t1[D, g, i, t] = sum_p Crow[D, p, i] fcol[g, p, t]
            t1 = torch.einsum("Dpi, gpt -> Dgit", Crow, fcol[sl])
            t2 = t1 @ Cb[:, None]                    # (N, nb, neo, neo)
            g[sl] = torch.einsum("gD, Dgij -> gij", phases[sl], t2)
        return g

    def get_emb_eri_aft(self, C_emb, blksize=8192):
        """Embedding-space ERI directly from the AFT factors, G-block
        streamed:
          eri_emb[ijkl] = (1/Omega) sum_G w(G) g*[G,ij] g[G,kl],
          g[G] = C^T f(G) C.
        C_emb: (nao, neo) AO -> embedding coefficients."""
        C = as_f64(C_emb, self.device)
        neo = C.shape[1]
        Gv, w = self.coulG()
        if self.ncells_tr:
            g = self._emb_g_aft(C, Gv, blksize).reshape(-1, neo * neo)
        else:
            g = self._emb_g(C, Gv, w)
        with stage("emb ERI Gram (device)", self.device):
            eri = _wgram(g, self._dev(w))
        return _symm8(eri.reshape((neo,) * 4) / self.vol)

    def get_emb_eri_aft_cross(self, C_a, C_b, blksize=8192):
        """Cross-spin embedding ERI (ij_a | kl_b) from the AFT factors
        (stripe cells): (1/Omega) sum_G w g_a*[G,ij] g_b[G,kl]."""
        if not self.ncells_tr:
            raise ValueError("get_emb_eri_aft_cross: stripe cells only")
        Gv, w = self.coulG()
        C_a, C_b = as_f64(C_a, self.device), as_f64(C_b, self.device)
        na, nb = C_a.shape[1], C_b.shape[1]
        ga = self._emb_g_aft(C_a, Gv, blksize).reshape(-1, na * na)
        gb = self._emb_g_aft(C_b, Gv, blksize).reshape(-1, nb * nb)
        eri = (_wgram(ga, self._dev(w), gb) / self.vol).reshape(
            na, na, nb, nb)
        eri = 0.5 * (eri + eri.permute(1, 0, 2, 3))
        return 0.5 * (eri + eri.permute(0, 1, 3, 2))

    # FFT-DF: AO products on the uniform cell grid, FFT to rho_ij(G)

    def grid_coords(self, mesh=None):
        """Uniform real-space grid over the cell (fractional fftfreq
        layout matching Gv ordering): (npts, 3) bohr, row-major."""
        mesh = self.mesh if mesh is None else tuple(mesh)
        fracs = [np.arange(n) / float(n) for n in mesh]
        ns = np.stack(np.meshgrid(*fracs, indexing="ij"), axis=-1)
        return ns.reshape(-1, 3) @ self.a

    def eval_ao_pbc(self, coords, rcut=None):
        """Periodic AO values phi_I(r) = sum_T chi_I(r - T) on arbitrary
        points (general l, image sum bounded by the cell rcut), summed on
        the host by utils.cubegen.eval_ao; a float64 tensor on the
        device."""
        from libdmet_preview_tpu_torch.utils.cubegen import eval_ao
        coords = np.asarray(coords, float)
        out = np.zeros((len(coords), self.nao))
        for T in self.lattice_images(rcut):
            out += eval_ao(self.mole, coords - T)
        return self._dev(out)

    def _grid_ao(self, mesh):
        """eval_ao_pbc on grid_coords(mesh), kept on the cell per mesh."""
        return self._memo(("grid_ao", tuple(mesh)), lambda: self.eval_ao_pbc(
            self.grid_coords(mesh)))

    def _fft_mesh(self, mesh):
        """(npts, dV, w) of a uniform grid: the Coulomb weights 4 pi / G^2
        (0 at G = 0) on the device."""
        npts = int(np.prod(mesh))
        Gv = _mesh_vectors(mesh, self.b)
        G2 = np.einsum("gi, gi -> g", Gv, Gv)
        w = np.where(G2 > 1e-12, 4.0 * np.pi / np.maximum(G2, 1e-12), 0.0)
        return npts, self.vol / npts, self._dev(w)

    def _pair_fft(self, mo_a, mo_b, mesh, dV):
        """rho_ij(G) = FFT[mo_a_i mo_b_j](G) dV, (npts, na * nb)."""
        npts, na = mo_a.shape
        nb = mo_b.shape[1]
        pair = (mo_a[:, :, None] * mo_b[:, None, :]).reshape(
            tuple(mesh) + (na * nb,))
        return (torch.fft.fftn(pair, dim=(0, 1, 2)) * dV).reshape(
            npts, na * nb)

    def get_emb_eri_fft(self, C_emb, mesh=None, max_memory_mb=2048):
        """Embedding-space ERI via FFT density fitting: AO products
        sampled on the uniform cell grid, FFTed to rho_ij(G), then
        (ij|kl) = (1/Omega) sum_G w(G) rho_ij(G)^* rho_kl(G).  Same
        contract as get_emb_eri_aft; accuracy is set by the mesh
        resolving the orbital-PAIR spectrum (default: the cell mesh).
        The pair FFTs run in column blocks bounded by max_memory_mb."""
        mesh = self.mesh if mesh is None else tuple(mesh)
        C = as_f64(C_emb, self.device)
        neo = C.shape[1]
        npts, dV, w = self._fft_mesh(mesh)
        mo = self._grid_ao(mesh) @ C                        # (npts, neo)
        blk = max(1, int(max_memory_mb * 1e6 / (16 * npts * neo)))
        rho = torch.empty((npts, neo, neo), dtype=torch.complex128,
                          device=self.device)
        for j0 in range(0, neo, blk):
            j1 = min(neo, j0 + blk)
            rho[:, :, j0:j1] = self._pair_fft(mo, mo[:, j0:j1], mesh,
                                              dV).reshape(npts, neo, -1)
        with stage("emb ERI Gram (device)", self.device):
            eri = _wgram(rho.reshape(npts, neo * neo), w)
        return _symm8(eri.reshape((neo,) * 4) / self.vol)

    def get_emb_eri_fft_cross(self, C_a, C_b, mesh=None):
        """Cross-spin FFT-DF embedding ERI (ij_a | kl_b): the two pair
        densities share one grid; (1/Omega) sum_G w rho_a^* rho_b."""
        mesh = self.mesh if mesh is None else tuple(mesh)
        C_a, C_b = as_f64(C_a, self.device), as_f64(C_b, self.device)
        na, nb = C_a.shape[1], C_b.shape[1]
        npts, dV, w = self._fft_mesh(mesh)
        ao = self._grid_ao(mesh)
        ma, mb = ao @ C_a, ao @ C_b
        ra = self._pair_fft(ma, ma, mesh, dV)
        rb = self._pair_fft(mb, mb, mesh, dV)
        eri = (_wgram(ra, w, rb) / self.vol).reshape(na, na, nb, nb)
        eri = 0.5 * (eri + eri.permute(1, 0, 2, 3))
        return 0.5 * (eri + eri.permute(0, 1, 3, 2))

    # range separation: real-space erfc short range + G-space erf long
    # range on the coarse damped mesh

    def _sr_rows_dev(self, omega, pair_tol):
        """_sr_ao_eri_rows on the device, moved there once per
        (omega, pair_tol)."""
        prec = self.precision if pair_tol is None else pair_tol
        return self._memo(("sr_rows_dev", float(omega), float(prec)),
                          lambda: self._dev(self._sr_ao_eri_rows(
                              omega, pair_tol=pair_tol)))

    def _sr_emb_eri(self, C_emb, omega, pair_tol=None, C_ket=None):
        """Short-range embedding ERI: the SR rows expanded by translation
        symmetry into the embedding contraction, on the device as
        successive GEMMs per bra cell (contract L, then K, then J, then
        the bra)."""
        C = as_f64(C_emb, self.device)
        Ck = C if C_ket is None else as_f64(C_ket, self.device)
        nao, neo = C.shape
        nk = Ck.shape[1]
        e0 = self._sr_rows_dev(omega, pair_tol)
        N = self.ncells_tr or 1
        m = self.nao_cell if N > 1 else nao
        if N > 1:
            add = self._tr_add()
            Cb, Ckb = C.reshape(N, m, neo), Ck.reshape(N, m, nk)
        else:
            add = torch.zeros((1, 1), dtype=torch.long, device=self.device)
            Cb, Ckb = C[None], Ck[None]
        out = torch.zeros((neo, neo, nk, nk), dtype=torch.float64,
                          device=self.device)
        with stage("SR emb contraction (device)", self.device):
            for c in range(N):
                Cp = Cb[add[:, c]].reshape(nao, neo)
                Cq = Ckb[add[:, c]].reshape(nao, nk)
                t = (e0.reshape(-1, nao) @ Cq).reshape(m, nao, nao, nk)
                t = torch.einsum("pJKl, Kk -> pJkl", t, Cq)
                t = torch.einsum("pJkl, Jj -> pjkl", t, Cp)
                out += torch.einsum("pi, pjkl -> ijkl", Cb[c], t)
        return out

    def _lr_emb_gram(self, C_a, C_b, Gv, w):
        """(1/Omega) Re sum_G w g_a*[G] g_b[G], (na*na, nb*nb), of the
        embedding pair transforms on the mesh Gv."""
        na, nb = C_a.shape[1], C_b.shape[1]
        if self.ncells_tr:
            ga = self._emb_g_aft(C_a, Gv).reshape(-1, na * na)
            gb = ga if C_b is C_a else \
                self._emb_g_aft(C_b, Gv).reshape(-1, nb * nb)
        else:
            ga = self._emb_g(C_a, Gv, w)
            gb = ga if C_b is C_a else self._emb_g(C_b, Gv, w)
        with stage("emb ERI Gram (device)", self.device):
            return _wgram(ga, self._dev(w), None if gb is ga else gb) \
                / self.vol

    def get_emb_eri_rs(self, C_emb, omega=0.5, gmax_lr=None,
                       pair_tol=None):
        """Embedding-space ERI by RANGE SEPARATION:

            eri = SR(erfc, real space) + LR(erf, coarse G mesh)
                  - (pi/(w^2 Omega)) S_emb x S_emb   [G=0 of the SR
                    kernel, removed to match the G=0-dropped AFT/FFT
                    convention]

        Same contract as get_emb_eri_aft; == get_emb_eri_aft to the AFT
        mesh accuracy for any omega.  The SR rows are made once per
        (omega, pair_tol) and kept on the cell."""
        C = as_f64(C_emb, self.device)
        neo = C.shape[1]
        eri = self._sr_emb_eri(C, omega, pair_tol=pair_tol)
        Gv, w = self.coulG_rs(omega, gmax=gmax_lr)
        eri += self._lr_emb_gram(C, C, Gv, w).reshape((neo,) * 4)
        S_emb = C.T @ self.intor_ovlp() @ C
        eri -= (np.pi / (omega ** 2 * self.vol)) \
            * torch.einsum("ij, kl -> ijkl", S_emb, S_emb)
        return _symm8(eri)

    def get_emb_eri_rs_cross(self, C_a, C_b, omega=0.5, gmax_lr=None,
                             pair_tol=None):
        """Cross-spin range-separated embedding ERI (ij_a | kl_b); same
        split as get_emb_eri_rs."""
        if not self.ncells_tr:
            raise ValueError("get_emb_eri_rs_cross: stripe cells only")
        C_a, C_b = as_f64(C_a, self.device), as_f64(C_b, self.device)
        na, nb = C_a.shape[1], C_b.shape[1]
        eri = self._sr_emb_eri(C_a, omega, pair_tol=pair_tol, C_ket=C_b)
        Gv, w = self.coulG_rs(omega, gmax=gmax_lr)
        eri += self._lr_emb_gram(C_a, C_b, Gv, w).reshape(na, na, nb, nb)
        S = self.intor_ovlp()
        Sa, Sb = C_a.T @ S @ C_a, C_b.T @ S @ C_b
        eri -= (np.pi / (omega ** 2 * self.vol)) \
            * torch.einsum("ij, kl -> ijkl", Sa, Sb)
        eri = 0.5 * (eri + eri.permute(1, 0, 2, 3))
        return 0.5 * (eri + eri.permute(0, 1, 3, 2))

    # ------------------------------------------------------------------
    # Ewald nuclear energy (with neutralizing background), host
    # ------------------------------------------------------------------

    def energy_nuc(self, eta=None):
        """Point-charge Ewald energy with the neutralizing background."""
        with stage("Ewald (host)"):
            return self._ewald(eta)

    def _ewald(self, eta):
        Z = self.charges
        R = self.coords
        vol = self.vol
        if eta is None:
            eta = (np.pi / vol ** (2.0 / 3.0))  # decent default split
        # real-space sum
        rcut = np.sqrt(-np.log(1e-16)) / np.sqrt(eta) + 1.0
        ainv = np.linalg.inv(self.a)
        nmax = [int(np.ceil(rcut * np.linalg.norm(ainv[:, i]))) + 1
                for i in range(3)]
        ns = np.array(list(it.product(*[range(-n, n + 1) for n in nmax])))
        Ts = ns @ self.a
        ewovrl = 0.0
        for A in range(len(Z)):
            for B in range(len(Z)):
                d = R[A] - R[B] + Ts                     # (nT, 3)
                r = np.linalg.norm(d, axis=1)
                mask = r > 1e-10
                ewovrl += 0.5 * Z[A] * Z[B] * np.sum(
                    erfc(np.sqrt(eta) * r[mask]) / r[mask])
        # self + background
        Qtot = Z.sum()
        ewself = -np.sum(Z ** 2) * np.sqrt(eta / np.pi) \
            - np.pi * Qtot ** 2 / (2.0 * eta * vol)
        # reciprocal sum
        gmax = np.sqrt(4.0 * eta * -np.log(1e-16))
        mesh = []
        for i in range(3):
            db = np.linalg.norm(self.b[i])
            mesh.append(int(np.ceil(gmax / db)) * 2 + 1)
        Gv = _mesh_vectors(mesh, self.b)
        G2 = np.einsum("gi, gi -> g", Gv, Gv)
        nz = G2 > 1e-12
        SF = np.einsum("a, ga -> g", Z, np.exp(1j * (Gv[nz] @ R.T)))
        ewg = (2.0 * np.pi / vol) * np.sum(
            np.exp(-G2[nz] / (4.0 * eta)) / G2[nz] * np.abs(SF) ** 2)
        return float(ewovrl + ewself + ewg)


def cross_ovlp_pbc(cell1, cell2):
    """Periodized cross overlap between the AOs of two PbcCell objects on
    the same torus: S12[i, j] = <chi~_i^{(1)} | chi~_j^{(2)}> (general l,
    image-summed on the host), a float64 tensor on cell1's device."""
    if not np.allclose(cell1.a, cell2.a):
        raise ValueError("cross_ovlp_pbc: the cells are on different tori")
    Ts = cell1.lattice_images(max(cell1.rcut, cell2.rcut))
    prec = min(cell1.precision, cell2.precision)
    logt = -np.log(prec) * 1.5
    S = np.zeros((cell1.nao, cell2.nao))
    for i, shi in enumerate(cell1.shells):
        i0, i1 = cell1.shell_slices[i]
        for j, shj in enumerate(cell2.shells):
            j0, j1 = cell2.shell_slices[j]
            mu_min = (shi.exps.min() * shj.exps.min()
                      / (shi.exps.min() + shj.exps.min()))
            d = shi.center - shj.center - Ts
            keep = np.einsum("ti, ti -> t", d, d) * mu_min < logt
            acc = np.zeros((shi.nc, shj.nc))
            for Tvec in Ts[keep]:
                acc += md.ovlp_block(shi, shj, shift=Tvec)
            S[i0:i1, j0:j1] = acc
    return cell1._dev(S)


def make_hchain_supercell(nk=3, nH=2, R=1.5, vac=10.0, basis="3-21g",
                          **kwargs):
    """BvK supercell of the reference's HChain cell (libdmet
    system/lattice.py:1262: nH H atoms spaced R along z, cell length
    nH*R, vacuum `vac` on x/y; all in Angstrom), replicated nk times
    along z (the [1, 1, nk] k-mesh torus).  kwargs go to PbcCell (device,
    gmax, precision, ...)."""
    length = nH * R
    atoms = []
    for c in range(nk):
        for i in range(nH):
            atoms.append(("H", (0.0, 0.0, c * length + i * R)))
    a = np.diag([vac, vac, nk * length])
    cell = PbcCell(atoms, a, basis=basis, unit="A", **kwargs)
    t_vecs = np.zeros((nk, 3))
    t_vecs[:, 2] = np.arange(nk) * length * BOHR_PER_ANGSTROM
    cell.set_translations(nk, t_vecs)
    return cell


def make_hplane_supercell(nkx=2, nky=2, nHx=1, nHy=1, Rx=2.0, Ry=2.0,
                          vac=10.0, basis="sto-3g", **kwargs):
    """BvK supercell of the reference's HPlane cell (libdmet
    system/lattice.py:1284: nHx x nHy hydrogens on a rectangular xy grid
    with spacings Rx/Ry, vacuum `vac` along z; all Angstrom), tiled on
    the [nkx, nky, 1] k-mesh torus (nkx*nky cells, cell-major, x-major)."""
    lx, ly = nHx * Rx, nHy * Ry
    atoms, t_vecs = [], []
    for cx in range(nkx):
        for cy in range(nky):
            t_vecs.append((cx * lx, cy * ly, 0.0))
            for i in range(nHx):
                for j in range(nHy):
                    atoms.append(("H", (cx * lx + i * Rx,
                                        cy * ly + j * Ry, 0.0)))
    a = np.diag([nkx * lx, nky * ly, vac])
    cell = PbcCell(atoms, a, basis=basis, unit="A", **kwargs)
    cell.set_translations(nkx * nky,
                          np.asarray(t_vecs) * BOHR_PER_ANGSTROM)
    return cell
