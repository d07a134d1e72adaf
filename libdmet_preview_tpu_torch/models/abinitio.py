"""
Ab initio lattices (PyTorch port of libdmet_preview_tpu/models/abinitio.py,
its array tier and its k-space tier).

Each factory takes the engine's arrays as an EngineInts record
(models/engine_ints.py); make_molecule_lattice and make_h_ring_lattice
also take a port molecule (ints.gto.Mole / ints.md.MoleGeneral), whose
record they make with mole_engine_ints and which they keep in
meta["mole"], and make_hchain_pbc_lattice / make_hchain_pbc_lattice_uhf a
port cell (ints.pbc.PbcCell, e.g. make_hchain_supercell), whose record
they make with cell_engine_ints against minao_ref (MINAO by default) and
keep in meta["cell"], as the JAX factories do.  They also take the JAX
package's call forms, make_h_ring_lattice(ncells, atoms_per_cell, r_bond,
basis, ...), make_hchain_pbc_lattice(nk, nH, R, vac, basis, ...) and
make_molecule_lattice(mol=...), which build that ring or cell first.
From there the pipeline is the JAX package's, on `device`:

    S, hcore, ERI (EngineInts)
    molecular / supercell RHF or UHF     (solvers.scf.SCF, Fock on device)
    C_ao_lo = S^{-1/2} (Lowdin) or IAO + PAO (lo.iao)
    LO operators: h, rdm1, fock; ERI by four GEMMs on the device
    stripes <R|X|0> (one gather + a mean), Cholesky of the LO ERI

The k-space tier (make_jk_tables, jk_stripes, kscf_stripe_hf,
update_ham_eriF) works on translation-symmetric stripes of a general 3D
group: torch.fft.fftn for R -> k, one gather for the JK tables, a batched
Cholesky of S(k) and one batched complex eigh per SCF iteration, aufbau by
one argsort on the device, and one host read per iteration for the
stopping test.  The translation difference table tr_diff[C, D] = index of
T_C - T_D is the lattice's own subtraction map (LatticeModel._sub_tab).

The antiferromagnetic oxides (make_nio_afm_lattice, make_nio_fm_lattice,
make_cuo2_afm_lattice) build their cell, take its S, hcore,
range-separated ERI and Ewald energy (or read them from the JAX
package's .npz cache keys), run the supercell UHF (_uhf_incore) and hand
it to _afm_oxide_tail: Lowdin LOs, per-spin LO operators, the LO ERI and
its Cholesky factors, the staggered d moments.

Energies and densities follow the JAX package: make_h_ring_lattice and
make_hchain_pbc_lattice store the SPIN-TRACED rdm1 stripes on the lattice,
as the JAX factories do (with an unrestricted embedding basis, _emb_H1
then folds the total density into both spins; ROADMAP Queue 3).
"""

import numbers

import numpy as np
import scipy.linalg as sla
import torch

from libdmet_preview_tpu_torch.lo.lowdin import _h, lowdin_orth
from libdmet_preview_tpu_torch.utils import logger as log
from libdmet_preview_tpu_torch.utils.misc import as_f64, as_tensor, to_host
from libdmet_preview_tpu_torch.utils.timer import stage
from libdmet_preview_tpu_torch.models.engine_ints import (  # noqa: F401
    EngineInts, cell_engine_ints, load_engine_ints, mole_engine_ints,
    save_engine_ints)


class AbInitioHam(object):
    """Duck-typed Ham object for LatticeModel.set_Ham_abinitio.

    H1_R / fock_R: ((spin,) ncells, nlo, nlo) LO-basis R stripes;
    eri_imp: the unit-cell LO ERI ((n,)*4, or the (aa, bb, ab) blocks of a
    spin-dependent LO basis); H0: the constant energy per cell.  H2
    representations:
      'cholesky' -- chol_L (naux, nsites, nsites) Cholesky/DF factors of
                    the supercell LO ERI (set_Ham_abinitio copies them to
                    the lattice's device and leaves this object as it
                    was), or None for a lattice that only runs the
                    non-interacting bath;
      'aft'      -- no two-body object: the embedding ERIs are streamed
                    from the periodic cell aft_cell (ints.pbc.PbcCell)
                    with the AO -> EO coefficients C_ao_lo @ basis, by
                    the driver df_mode names: 'aft' (analytic pair FT),
                    'fft' (FFT density fitting) or 'rs' (range
                    separation).  Chosen when chol_L is None and aft_cell
                    is given."""

    def __init__(self, H1_R, fock_R, chol_L, eri_imp, H0, aft_cell=None,
                 C_ao_lo=None, df_mode="aft"):
        if df_mode not in ("aft", "fft", "rs"):
            raise ValueError("unknown df_mode %s" % df_mode)
        self.df_mode = df_mode
        self.H1_R = H1_R
        self.fock_R = fock_R
        self.chol_L = chol_L
        self.eri_imp = eri_imp
        self.H0 = H0
        self.aft_cell = aft_cell
        self.C_ao_lo = C_ao_lo
        self.H2_format = "aft" if (chol_L is None
                                   and aft_cell is not None) else "cholesky"
        self.ImpJK = None

    def getH1(self):
        return self.H1_R

    def getFock(self):
        return self.fock_R

    def getH2(self):
        return self.chol_L

    def getH0(self):
        return self.H0

    def getImpJK(self):
        return self.ImpJK


def lowdin(S, device=torch.device("cuda")):
    """S^{-1/2} of an overlap matrix: lo.lowdin.lowdin_orth under the JAX
    package's name and singularity threshold."""
    return lowdin_orth(S, tol=1e-10, device=device)


def _rot4(g, ci, cj, ck, cl):
    """einsum("pqrs, pi, qj, rk, sl -> ijkl") as four GEMMs: each step
    contracts the last axis and moves the new one to the front."""
    for c in (cl, ck, cj, ci):
        n = g.shape[-1]
        g = (g.reshape(-1, n) @ c).reshape(g.shape[:-1] + (c.shape[1],))
        g = g.movedim(-1, 0)
    return g.contiguous()


def _stripe_symm(M, ncells, nlo, device=torch.device("cuda")):
    """Translation-symmetrized stripes <R|M|0> of a supercell matrix:
    stripe[R] = (1/N) sum_c M[(R+c) block, c block], one gather and a mean
    on M's device (an array goes to `device`)."""
    M = as_tensor(M, device)
    c = torch.arange(ncells, device=M.device)
    r = (c[:, None] + c[None, :]) % ncells
    blocks = M.reshape(ncells, nlo, ncells, nlo).permute(0, 2, 1, 3)
    return blocks[r, c[None, :]].mean(dim=1)


def _first_column_stripes(M, ncells, nlo):
    """<R|M|0> read off the first block column (no symmetrization)."""
    return M[:, :nlo].reshape(ncells, nlo, nlo)


def _rhf_ao(ints, device, tol=1e-12, MaxIter=200):
    """RHF of the whole system in the AO basis (general overlap)."""
    from libdmet_preview_tpu_torch.models.integral import Integral
    from libdmet_preview_tpu_torch.solvers.scf import SCF
    Ham = Integral(ints.nao, True, False, ints.e_nuc,
                   {"cd": ints.hcore[None]}, {"ccdd": ints.eri[None]},
                   ovlp=ints.S)
    myscf = SCF(device=device)
    myscf.set_system(ints.nelectron, 0, False, True)
    myscf.set_integral(Ham)
    E_hf, dm = myscf.HF(tol=tol, MaxIter=MaxIter)
    return myscf, E_hf, dm


def _iao_pao_columns(ints, S, C_occ, cells_per, atoms_per_cell):
    """IAO + PAO coefficients of the whole system in cell-major column
    order: per cell its IAOs (atom-major), then its PAOs."""
    from libdmet_preview_tpu_torch.lo.iao import get_iao, get_iao_virt
    dev = S.device
    natom, nao_atom = ints.natom, ints.nao_atom
    nmin = ints.nmin_atom
    S12 = as_f64(ints.S12, dev)
    S2 = as_f64(ints.S2, dev)
    C_iao = get_iao(S, S12, S2, C_occ)
    virt_idx = [a * nao_atom + s for a in range(natom)
                for s in range(nmin, nao_atom)]
    # minimal basis: IAOs already span everything, no PAOs
    C_pao = (S.new_zeros((S.shape[0], 0)) if len(virt_idx) == 0
             else get_iao_virt(S, C_iao, virt_ao_idx=virt_idx))
    npao = nao_atom - nmin
    cols = []
    for c in range(cells_per):
        for a in range(atoms_per_cell):
            cols += [(c * atoms_per_cell + a) * nmin + s
                     for s in range(nmin)]
        for a in range(atoms_per_cell):
            cols += [C_iao.shape[1] + (c * atoms_per_cell + a) * npao + s
                     for s in range(npao)]
    idx = torch.as_tensor(cols, dtype=torch.long, device=dev)
    return torch.cat([C_iao, C_pao], dim=1)[:, idx], nmin * atoms_per_cell


def _lo_operators(ints, C, dm, device):
    """h, ERI, spin-traced rdm1 and Fock in the (spin-independent) LO
    basis C, from the AO density dm (2, nao, nao)."""
    from libdmet_preview_tpu_torch.solvers.scf import _veff_uhf
    hcore = as_f64(ints.hcore, device)
    eri = as_f64(ints.eri, device)
    S = as_f64(ints.S, device)
    dm = as_f64(dm, device)
    h_lo = C.T @ hcore @ C
    eri_lo = _rot4(eri, C, C, C, C)
    SC = S @ C
    dma, dmb = SC.T @ dm[0] @ SC, SC.T @ dm[1] @ SC
    rdm1_lo = dma + dmb
    va = _veff_uhf(dma, dmb, eri_lo, eri_lo, eri_lo)[0]
    return h_lo, eri_lo, rdm1_lo, h_lo + va


def _leading_count(ints, n, name):
    """The count that leads the JAX package's call form: `ints` when it is
    an int (JAX's first positional argument), else the keyword `n`."""
    if isinstance(ints, numbers.Integral):
        if n is not None and n != ints:
            raise TypeError("%s given twice (%r and %r)" % (name, ints, n))
        return int(ints)
    return n


def _hchain_cell(ints, nk, nH, R, vac, basis, gmax, device):
    """`ints` as it is, or in the JAX call form (ints an int or None) the
    H chain's cell ints.pbc.make_hchain_supercell(nk, ...) on `device`."""
    if ints is not None and not isinstance(ints, numbers.Integral):
        if nk is not None:
            raise TypeError("nk= is the JAX call form's; with ints given, "
                            "the cells come from ints")
        return ints
    from libdmet_preview_tpu_torch.ints.pbc import make_hchain_supercell
    nk = _leading_count(ints, nk, "nk")
    return make_hchain_supercell(nk=3 if nk is None else nk, nH=nH, R=R,
                                 vac=vac, basis=basis, gmax=gmax,
                                 device=device)


def _as_engine_ints(ints, ncells, minimal_ref):
    """(EngineInts, the molecule or cell, or None) of a factory's input."""
    from libdmet_preview_tpu_torch.ints.pbc import PbcCell
    if isinstance(ints, EngineInts):
        return ints, None
    if isinstance(ints, PbcCell):
        return cell_engine_ints(ints, minimal_ref=minimal_ref), ints
    mol = ints
    return mole_engine_ints(mol, ncells=ncells or len(mol.atoms),
                            minimal_ref=minimal_ref), mol


def make_molecule_lattice(ints=None, chol_tol=1e-10,
                          device=torch.device("cuda"), mol=None):
    """Molecular (non-PBC) DMET: a single-cell 'lattice' whose fragments
    are orbital subsets.  ints: the molecule's EngineInts, or the molecule
    (ints.gto.Mole / ints.md.MoleGeneral; kept in meta["mole"]); mol= is
    the JAX package's name for the molecule.

    Returns (Lat, meta) in the Lowdin-LO basis; run DMET with
    imp_idx/val_idx fragment subsets of the LOs.  meta's matrices are
    tensors on `device`."""
    from libdmet_preview_tpu_torch.models.integral import Integral
    from libdmet_preview_tpu_torch.models.lattice import ChainLattice
    from libdmet_preview_tpu_torch.ops.eri_transform import cholesky_eri
    from libdmet_preview_tpu_torch.solvers.scf import SCF, _veff_uhf
    if (ints is None) == (mol is None):
        raise TypeError("make_molecule_lattice takes one of ints and mol")
    ints, mol = _as_engine_ints(mol if ints is None else ints, 1, None)
    nsite = ints.nao
    C = lowdin(as_f64(ints.S, device))
    h_lo = C.T @ as_f64(ints.hcore, device) @ C
    eri_lo = _rot4(as_f64(ints.eri, device), C, C, C, C)
    Ham_mol = Integral(nsite, True, False, ints.e_nuc, {"cd": h_lo[None]},
                       {"ccdd": eri_lo[None]})
    myscf = SCF(device=device)
    myscf.set_system(ints.nelectron, 0, False, True)
    myscf.set_integral(Ham_mol)
    E_hf, dm = myscf.HF(tol=1e-12, MaxIter=200)
    dm = as_f64(dm, device)
    rdm1_lo = dm[0] + dm[1]
    fock_lo = h_lo + _veff_uhf(dm[0], dm[1], eri_lo, eri_lo, eri_lo)[0]

    chol_L = cholesky_eri(eri_lo, tol=chol_tol)
    Lat = ChainLattice(nsite, nsite)      # one cell holding all LOs
    Ham = AbInitioHam(to_host(h_lo)[None], to_host(fock_lo)[None], chol_L,
                      eri_lo, ints.e_nuc)
    Lat.set_Ham_abinitio(Ham, rdm1=to_host(rdm1_lo)[None, None], device=device)
    meta = {"ints": ints, "E_hf": E_hf, "C_ao_lo": C, "eri_lo": eri_lo,
            "h_lo": h_lo, "fock_lo": fock_lo, "rdm1_lo": rdm1_lo,
            "nlo": nsite}
    if mol is not None:
        meta["mole"] = mol
    return Lat, meta


def make_h_ring_lattice(ints=None, atoms_per_cell=1, r_bond=1.8,
                        basis="sto-6g", chol_tol=1e-10, localization="lowdin",
                        minimal_ref="sto-6g", device=torch.device("cuda"),
                        ncells=None):
    """An ab initio DMET lattice from an H ring's EngineInts (ncells cells
    of atoms_per_cell atoms, AO order cell-major), or from the ring itself
    (ints.gto.Mole, e.g. ints.gto.h_ring_mole(n, r_bond, basis)) cut into
    `ncells` cells (default: one atom per cell); the IAOs are then taken
    against `minimal_ref`, and the molecule is kept in meta["mole"] (what
    attach_ks reads).

    The JAX package's call form, make_h_ring_lattice(ncells,
    atoms_per_cell=1, r_bond=1.8, basis="sto-6g", ...) (ints an int, or
    ncells= alone), builds that ring, h_ring_mole(ncells * atoms_per_cell,
    r_bond, basis), and goes on as for a Mole; atoms_per_cell, r_bond and
    basis are read only in that form.

    localization:
      'lowdin' -- S^{-1/2} LOs, all valence (minimal-basis workflow)
      'iao'    -- Knizia IAOs (valence) + projected-AO virtuals, for split
                  bases like 3-21G (needs ints.S12 / ints.S2)
    Returns (Lat, meta) with hcore/fock/rdm1 in the LO basis (R stripes of
    the first block column), Cholesky ERI factors, and the molecular
    results in meta (tensors on `device`)."""
    from libdmet_preview_tpu_torch.models.lattice import ChainLattice
    from libdmet_preview_tpu_torch.ops.eri_transform import cholesky_eri
    if ints is None or isinstance(ints, numbers.Integral):
        from libdmet_preview_tpu_torch.ints.gto import h_ring_mole
        ncells = _leading_count(ints, ncells, "ncells")
        if ncells is None:
            raise TypeError("make_h_ring_lattice takes ints or ncells")
        ints = h_ring_mole(ncells * atoms_per_cell, r_bond, basis)
    ints, mol = _as_engine_ints(
        ints, ncells, minimal_ref if localization == "iao" else None)
    ncells, apc = ints.ncells, ints.atoms_per_cell
    nlo = ints.nao_atom * apc                # LOs per cell
    myscf, E_hf, dm = _rhf_ao(ints, device)
    S = as_f64(ints.S, device)
    if localization == "lowdin":
        # S^-1/2 of the circulant overlap is circulant -> the LOs are
        # translationally symmetric; AO order is already cell-major
        C = lowdin(S)
        nval_cell, nvirt_cell = nlo, 0
    elif localization == "iao":
        C_occ = as_f64(myscf.mo_coeff[0][:, :ints.nelectron // 2], device)
        C, nval_cell = _iao_pao_columns(ints, S, C_occ, ncells, apc)
        nvirt_cell = nlo - nval_cell
    else:
        raise ValueError("unknown localization %s" % localization)
    h_lo, eri_lo, rdm1_lo, fock_lo = _lo_operators(ints, C, dm, device)

    # lattice convention: A[R] = <R | M | 0> block (block (ci, cj) of the
    # full matrix = stripe[(ci - cj) mod N])
    h_R, fock_R, rdm1_R = [to_host(_first_column_stripes(M, ncells, nlo))
                           for M in (h_lo, fock_lo, rdm1_lo)]
    chol_L = cholesky_eri(eri_lo, tol=chol_tol)
    eri_imp = eri_lo[:nlo, :nlo, :nlo, :nlo].clone()

    Lat = ChainLattice(ncells * nlo, nlo)
    Ham = AbInitioHam(h_R, fock_R, chol_L, eri_imp, ints.e_nuc / ncells)
    Lat.set_Ham_abinitio(Ham, rdm1=rdm1_R[None], device=device)
    if nvirt_cell > 0:
        Lat.set_val_virt_core(nval_cell, nvirt_cell, 0)
    meta = {"ints": ints, "E_hf": E_hf, "C_ao_lo": C, "eri_lo": eri_lo,
            "h_lo": h_lo, "fock_lo": fock_lo, "rdm1_lo": rdm1_lo,
            "nlo": nlo, "nval": nval_cell, "nvirt": nvirt_cell}
    if mol is not None:
        meta["mole"] = mol
    return Lat, meta


def attach_ks(Lat, meta, xc="lsda", hyb=0.0, n_rad=60, n_theta=12,
              n_phi=24):
    """Turn an H-ring HF lattice (make_h_ring_lattice of a Mole) into a
    KS-DFT lattice for DFT-in-DMET: run the molecular RKS on the lattice's
    device, replace the lattice Fock and rdm1 by the KS ones (LO stripes
    of the first block column), and install the xc double counting that
    ops.embham._emb_H1 applies: Lat.xc_dc maps a spin-traced supercell LO
    density (a tensor) to the LO matrix of v_xc at that density (a tensor
    on the same device; C, the AO grid and its weights stay there), and
    Lat.xc_hyb is the fraction of HF exchange.

    Returns the converged RKS object."""
    from libdmet_preview_tpu_torch.ints.xc import eval_exc_vxc
    from libdmet_preview_tpu_torch.solvers.ksdft import RKS
    mol = meta["mole"]
    dev = Lat.device
    C = as_f64(meta["C_ao_lo"], dev)
    nlo = meta["nlo"]
    ks = RKS(mol, xc=xc, hyb=hyb, n_rad=n_rad, n_theta=n_theta,
             n_phi=n_phi, device=dev)
    ks.kernel()
    assert ks.converged
    SC = as_f64(mol.intor_ovlp(), dev) @ C
    rdm1_lo = SC.T @ ks.dm @ SC                   # spin-traced total
    fock_lo = C.T @ ks.fock @ C
    fock_R, rdm1_R = [to_host(_first_column_stripes(M, Lat.ncells, nlo))
                      for M in (fock_lo, rdm1_lo)]
    Lat.update_Ham(rdm1_R, fock_lo_k=Lat.R2k(fock_R))
    Lat.fock_lo_R = fock_R
    Lat.use_hcore_as_emb_ham = False

    ao_g, ao_grad_g, wts = ks.ao_g, ks.ao_grad_g, ks.grid[1]

    def xc_dc(rho_lo_tot):
        rho_ao = C @ as_f64(rho_lo_tot, dev) @ C.T
        _, vxc_ao = eval_exc_vxc(rho_ao, ao_g, wts, restricted=True, xc=xc,
                                 ao_grad=ao_grad_g)
        return C.T @ vxc_ao @ C

    Lat.xc_dc = xc_dc
    Lat.xc_hyb = hyb
    return ks


def make_hchain_pbc_lattice(ints=None, nH=2, R=1.5, vac=10.0,
                            basis="3-21g", localization="iao",
                            minao_ref="minao", chol_tol=1e-9, gmax=None,
                            device=torch.device("cuda"), nk=None):
    """Ab initio DMET lattice for the periodic H chain (the BvK torus of
    ints.ncells cells): `ints` is the cell, ints.pbc.make_hchain_supercell
    (its integrals are made with cell_engine_ints, the IAO reference being
    `minao_ref`, and the cell is kept in meta["cell"]), or its EngineInts,
    e.g. load_engine_ints("hchain_nk3_nH2_R1.5_vac10_3-21g.npz"), which
    the JAX engine wrote.  RHF, IAO(+PAO) localization against the
    periodized minimal basis (or Lowdin), stripes symmetrized over the
    translations.

    The JAX package's call form, make_hchain_pbc_lattice(nk=3, nH=2,
    R=1.5, vac=10.0, basis="3-21g", ..., gmax=None) (ints an int, the nk,
    or not given), builds that cell on `device` first; nH, R, vac, basis
    and gmax are read only in that form.

    Energies are ELECTRONIC-only (H0 = 0), the reference's E(DMET)
    convention.  Returns (Lat, meta); meta['eri_lo'] (a device tensor)
    drives charge self-consistency through update_ham_dense."""
    from libdmet_preview_tpu_torch.models.lattice import ChainLattice
    from libdmet_preview_tpu_torch.ops.eri_transform import cholesky_eri
    ints, cell = _as_engine_ints(
        _hchain_cell(ints, nk, nH, R, vac, basis, gmax, device), None,
        minao_ref if localization == "iao" else None)
    nk, nH = ints.ncells, ints.atoms_per_cell
    nlo = ints.nao_atom * nH                  # LOs per unit cell
    myscf, E_hf, dm = _rhf_ao(ints, device, MaxIter=300)
    S = as_f64(ints.S, device)
    if localization == "iao":
        C_occ = as_f64(myscf.mo_coeff[0][:, :ints.nelectron // 2], device)
        C, nval_cell = _iao_pao_columns(ints, S, C_occ, nk, nH)
        nvirt_cell = nlo - nval_cell
    elif localization == "lowdin":
        C = lowdin(S)
        nval_cell, nvirt_cell = nlo, 0
    else:
        raise ValueError("unknown localization %s" % localization)
    h_lo, eri_lo, rdm1_lo, fock_lo = _lo_operators(ints, C, dm, device)
    h_R, fock_R, rdm1_R = [to_host(_stripe_symm(M, nk, nlo))
                           for M in (h_lo, fock_lo, rdm1_lo)]
    chol_L = cholesky_eri(eri_lo, tol=chol_tol)
    eri_imp = eri_lo[:nlo, :nlo, :nlo, :nlo].clone()

    Lat = ChainLattice(nk * nlo, nlo)
    # ELECTRONIC energy convention: H0 = 0 (reference E(DMET))
    Ham = AbInitioHam(h_R, fock_R, chol_L, eri_imp, 0.0)
    Lat.set_Ham_abinitio(Ham, rdm1=rdm1_R[None], device=device)
    if nvirt_cell > 0:
        Lat.set_val_virt_core(nval_cell, nvirt_cell, 0)
    meta = {"ints": ints, "E_hf": E_hf, "E_hf_elec": E_hf - ints.e_nuc,
            "e_nuc": ints.e_nuc, "C_ao_lo": C, "eri_lo": eri_lo,
            "h_lo": h_lo, "fock_lo": fock_lo, "rdm1_lo": rdm1_lo,
            "nlo": nlo, "nval": nval_cell, "nvirt": nvirt_cell, "S": S}
    if cell is not None:
        meta["cell"] = cell
    return Lat, meta


def make_hchain_pbc_lattice_uhf(ints=None, nH=2, R=1.5, vac=10.0,
                                basis="3-21g", minao_ref="minao", gmax=None,
                                device=torch.device("cuda"), nk=None):
    """Spin-polarized (UHF) variant of make_hchain_pbc_lattice (`ints`: the
    cell or its EngineInts, or the JAX call form's nk; the IAOs against
    `minao_ref`): AFM-seeded supercell UHF, PER-SPIN IAO(+PAO)
    localization, all lattice operators and the unit-cell ERI blocks
    (aa, bb, ab) in the spin-dependent LO bases.  Supports the NIB
    workflow (spin-blocked eri_imp; no Cholesky interacting-bath
    factors)."""
    from libdmet_preview_tpu_torch.models.integral import Integral
    from libdmet_preview_tpu_torch.models.lattice import ChainLattice
    from libdmet_preview_tpu_torch.solvers.scf import SCF, _veff_uhf
    ints, cell = _as_engine_ints(
        _hchain_cell(ints, nk, nH, R, vac, basis, gmax, device), None,
        minao_ref)
    nk, nH = ints.ncells, ints.atoms_per_cell
    natom, nao_atom = ints.natom, ints.nao_atom
    nlo = nao_atom * nH
    nsite = ints.nao

    # AFM initial guess: alternate atoms alpha/beta
    dm0 = np.zeros((2, nsite, nsite))
    for a in range(natom):
        for ao in range(nao_atom):
            i = a * nao_atom + ao
            dm0[a % 2, i, i] = 1.0 / nao_atom
    Ham_mol = Integral(nsite, True, False, ints.e_nuc,
                       {"cd": ints.hcore[None]}, {"ccdd": ints.eri[None]},
                       ovlp=ints.S)
    myscf = SCF(device=device)
    myscf.set_system(ints.nelectron, 0, False, False)
    myscf.set_integral(Ham_mol)
    E_hf, dm = myscf.HF(tol=1e-12, MaxIter=500, InitGuess=dm0)

    # per-spin IAO + PAO localization
    S = as_f64(ints.S, device)
    nocc = ints.nelectron // 2
    C = torch.stack([
        _iao_pao_columns(ints, S, as_f64(myscf.mo_coeff[s][:, :nocc],
                                         device), nk, nH)[0]
        for s in range(2)])
    niao_cell = ints.nmin_atom * nH

    # LO operators, per spin (basis is spin-dependent)
    hcore = as_f64(ints.hcore, device)
    eri = as_f64(ints.eri, device)
    dm = as_f64(dm, device)
    h_lo = torch.stack([C[s].T @ hcore @ C[s] for s in range(2)])
    SC = torch.stack([S @ C[s] for s in range(2)])
    rdm1_lo = torch.stack([SC[s].T @ dm[s] @ SC[s] for s in range(2)])
    eri_aa = _rot4(eri, C[0], C[0], C[0], C[0])
    eri_bb = _rot4(eri, C[1], C[1], C[1], C[1])
    eri_ab = _rot4(eri, C[0], C[0], C[1], C[1])
    va, vb = _veff_uhf(rdm1_lo[0], rdm1_lo[1], eri_aa, eri_bb, eri_ab)
    fock_lo = torch.stack([h_lo[0] + va, h_lo[1] + vb])

    h_R, fock_R, rdm1_R = [
        to_host(torch.stack([_stripe_symm(M[s], nk, nlo) for s in range(2)]))
        for M in (h_lo, fock_lo, rdm1_lo)]
    n4 = (slice(None, nlo),) * 4
    eri_imp = torch.stack([eri_aa[n4], eri_bb[n4], eri_ab[n4]])

    Lat = ChainLattice(nk * nlo, nlo)
    Ham = AbInitioHam(h_R, fock_R, None, eri_imp, 0.0)
    Lat.set_Ham_abinitio(Ham, rdm1=rdm1_R, device=device)
    Lat.set_val_virt_core(niao_cell, nlo - niao_cell, 0)
    meta = {"ints": ints, "E_hf": E_hf, "E_hf_elec": E_hf - ints.e_nuc,
            "e_nuc": ints.e_nuc, "C_ao_lo": C, "h_lo": h_lo,
            "fock_lo": fock_lo, "rdm1_lo": rdm1_lo, "nlo": nlo, "S": S,
            "eri_lo": (eri_aa, eri_bb, eri_ab)}
    if cell is not None:
        meta["cell"] = cell
    return Lat, meta


def update_ham_dense_uhf(Lat, meta, rdm1_lo_R):
    """Spin-dependent-LO charge self-consistency: per-spin Fock rebuild
    from the (2, R, n, n) per-spin LO density stripes with the (aa, bb, ab)
    dense ERI blocks, on the ERI's device."""
    from libdmet_preview_tpu_torch.solvers.scf import _veff_uhf
    rdm1_lo_R = to_host(rdm1_lo_R)
    ncells, nlo = rdm1_lo_R.shape[1], rdm1_lo_R.shape[-1]
    eri_aa, eri_bb, eri_ab = meta["eri_lo"]
    dma, dmb = as_f64(Lat.expand(rdm1_lo_R), eri_aa.device)
    va, vb = _veff_uhf(dma, dmb, eri_aa, eri_bb, eri_ab)
    h_lo = meta["h_lo"]
    fock_R = to_host(torch.stack([_stripe_symm(h_lo[0] + va, ncells, nlo),
                              _stripe_symm(h_lo[1] + vb, ncells, nlo)]))
    Lat.update_Ham(rdm1_lo_R, fock_lo_k=Lat.R2k(fock_R))
    Lat.fock_lo_R = fock_R


def update_ham_dense(Lat, meta, rdm1_lo_R):
    """Charge self-consistency for dense-ERI ab initio lattices (the
    reference's Lat.update_Ham for the H2_format='cholesky' case): rebuild
    the lattice Fock from the LO density stripes using the full supercell
    ERI, on its device.

    rdm1_lo_R: (R, n, n) spin-TRACED density (restricted workflow) or
    (2, R, n, n) per-spin densities (unrestricted)."""
    from libdmet_preview_tpu_torch.solvers.scf import _veff_uhf
    rdm1_lo_R = to_host(rdm1_lo_R)
    eri_lo = meta["eri_lo"]
    dev = eri_lo.device
    restricted = rdm1_lo_R.ndim == 3
    ncells, nlo = rdm1_lo_R.shape[-3], rdm1_lo_R.shape[-1]
    if restricted:
        dma = dmb = as_f64(Lat.expand(rdm1_lo_R[None])[0] * 0.5, dev)
    else:
        dma, dmb = as_f64(Lat.expand(rdm1_lo_R), dev)
    va, vb = _veff_uhf(dma, dmb, eri_lo, eri_lo, eri_lo)
    h_lo = meta["h_lo"]
    if restricted:
        fock_R = to_host(_stripe_symm(h_lo + va, ncells, nlo))
        Lat.update_Ham(rdm1_lo_R[None], fock_lo_k=Lat.R2k(fock_R))
    else:
        fock_R = to_host(torch.stack([_stripe_symm(h_lo + va, ncells, nlo),
                                  _stripe_symm(h_lo + vb, ncells, nlo)]))
        Lat.update_Ham(rdm1_lo_R, fock_lo_k=Lat.R2k(fock_R))
    Lat.fock_lo_R = fock_R


def diamond_cell(kmesh=(1, 1, 2), a_ang=3.567, basis="gth-szv",
                 pseudo="gth-pade", gmax=None, precision=1e-12,
                 device=torch.device("cuda")):
    """The BvK supercell of diamond (the north-star solid): the fcc
    primitive cell (2 C at 0 and a/4 (1, 1, 1), lattice constant a_ang
    Angstrom) tiled on a kmesh of cells along its primitive vectors,
    cell-major with the first axis slowest, GTH-SZV + GTH-PADE by default
    (8 orbitals per cell).  kmesh (1, 1, nk) is the nk-cell chain along
    the third primitive vector.  A ints.pbc.PbcCell with its translations
    set."""
    import itertools as it
    from libdmet_preview_tpu_torch.ints.pbc import PbcCell, BOHR_PER_ANGSTROM
    kmesh = tuple(int(x) for x in kmesh)
    a0 = a_ang * BOHR_PER_ANGSTROM
    P = 0.5 * a0 * np.asarray([[0.0, 1.0, 1.0],
                               [1.0, 0.0, 1.0],
                               [1.0, 1.0, 0.0]])
    basis_cell = [np.zeros(3), 0.25 * a0 * np.ones(3)]
    t_vecs, atoms = [], []
    for cx, cy, cz in it.product(*[range(n) for n in kmesh]):
        T = cx * P[0] + cy * P[1] + cz * P[2]
        t_vecs.append(T)
        for pos in basis_cell:
            atoms.append(("C", pos + T))
    a_sc = np.asarray([kmesh[0] * P[0], kmesh[1] * P[1], kmesh[2] * P[2]])
    cell = PbcCell(atoms, a_sc, basis=basis, unit="B", pseudo=pseudo,
                   gmax=gmax, precision=precision, device=device)
    return cell.set_translations(int(np.prod(kmesh)), np.asarray(t_vecs))


def make_diamond_lattice(nk=2, a_ang=3.567, basis="gth-szv",
                         pseudo="gth-pade", gmax=None, chol_tol=1e-8,
                         precision=1e-12, device=torch.device("cuda")):
    """Ab initio DMET lattice for diamond on the BvK torus of nk cells
    along the third primitive vector (diamond_cell((1, 1, nk))): the
    cell's integrals (S, hcore, the range-separated ERI, the Ewald
    energy), supercell RHF, Lowdin LOs (SZV is minimal: all valence), the
    LO ERI by four GEMMs, Cholesky factors of it, H0 = the Ewald ion
    energy per cell.  Returns (Lat, meta)."""
    from libdmet_preview_tpu_torch.models.lattice import ChainLattice
    from libdmet_preview_tpu_torch.ops.eri_transform import cholesky_eri
    cell = diamond_cell((1, 1, nk), a_ang, basis, pseudo, gmax, precision,
                        device)
    nlo = cell.nao // nk
    ints = cell_engine_ints(cell, minimal_ref=None)
    _, E_hf, dm = _rhf_ao(ints, device, tol=1e-11, MaxIter=300)
    S = as_f64(ints.S, device)
    C = lowdin(S)
    h_lo, eri_lo, rdm1_lo, fock_lo = _lo_operators(ints, C, dm, device)
    h_R, fock_R, rdm1_R = [to_host(_stripe_symm(M, nk, nlo))
                           for M in (h_lo, fock_lo, rdm1_lo)]
    chol_L = cholesky_eri(eri_lo, tol=chol_tol)
    eri_imp = eri_lo[:nlo, :nlo, :nlo, :nlo].clone()

    Lat = ChainLattice(nk * nlo, nlo)
    Ham = AbInitioHam(h_R, fock_R, chol_L, eri_imp, ints.e_nuc / nk)
    Lat.set_Ham_abinitio(Ham, rdm1=rdm1_R[None], device=device)
    meta = {"cell": cell, "E_hf": E_hf, "E_hf_elec": E_hf - ints.e_nuc,
            "e_nuc": ints.e_nuc, "C_ao_lo": C, "eri_lo": eri_lo,
            "h_lo": h_lo, "fock_lo": fock_lo, "rdm1_lo": rdm1_lo,
            "nlo": nlo, "S": S}
    return Lat, meta


# ----------------------------------------------------------------------
# 3D k-mesh machinery: translation-ERI JK, k-space SCF (the scaling path
# of the north-star diamond 3x3x3 workload)
# ----------------------------------------------------------------------

def _tr_add_from_diff(tr_diff):
    """Invert the difference table: add[R, c] = E with T_E = T_R + T_c
    (tr_diff[E, c] == R)."""
    tr_diff = np.asarray(tr_diff)
    N = tr_diff.shape[0]
    add = np.empty_like(tr_diff)
    add[tr_diff, np.arange(N)[None, :]] = np.arange(N)[:, None]
    return add


def _index(tab, device):
    return torch.as_tensor(np.asarray(tab), dtype=torch.long, device=device)


def _stripe_symm_tr(M, tr_diff, nlo, device=torch.device("cuda")):
    """Translation-symmetrized stripes <(R)|M|(0)> for a GENERAL (possibly
    3D) translation group: stripe[R] = (1/N) sum_c M[add(R,c) block,
    c block], one gather and a mean on M's device (an array goes to
    `device`)."""
    M = as_tensor(M, device)
    N = len(tr_diff)
    add = _index(_tr_add_from_diff(tr_diff), M.device)
    c = torch.arange(N, device=M.device)
    blocks = M.reshape(N, nlo, N, nlo).permute(0, 2, 1, 3)
    return blocks[add, c[None, :]].mean(dim=1)


def _expand_stripe_tr(stripe, tr_diff, device=torch.device("cuda")):
    """Stripes -> full supercell matrix: M[(C),(D)] = stripe[C - D], on
    the stripe's device (an array goes to `device`)."""
    st = as_tensor(stripe, device)
    N, m, m2 = st.shape
    return st[_index(tr_diff, st.device)].permute(0, 2, 1, 3).reshape(
        N * m, N * m2)


def make_jk_tables(eriF, tr_diff, device=torch.device("cuda")):
    """Contraction tables for translation-symmetric JK from the 'full' ERI
    format eriF[D, E, F] = ((0)p (D)q | (E)r (F)s), (N, N, N, m, m, m, m):
        W[D, d] = sum_E eriF[D, E, E - d]  (Coulomb),
        Y[D, d] = sum_E eriF[E, D, E - d]  (exchange),
    each one gather of eriF and a sum, on eriF's device (an array goes to
    `device`)."""
    eriF = as_tensor(eriF, device)
    N = eriF.shape[0]
    F = _index(tr_diff, eriF.device)                  # F[E, d] = E - d
    E = torch.arange(N, device=eriF.device)[:, None]
    W = eriF[:, E, F].sum(dim=1)
    Y = eriF.transpose(0, 1)[:, E, F].sum(dim=1)
    return W, Y


def jk_stripes(rho_st, W, Y, tr_diff):
    """J and K stripes <(R)|J|(0)> from a density stripe rho_st[R] =
    D[(C+R), (C)] (spin-summed).  Chemist convention:
    J_IJ = sum_KL (IJ|KL) D_KL, K_IJ = sum_KL (IK|JL) D_KL.  The first
    block row X0[(0)p, (D)q] lands on stripe -D."""
    rho_st = as_f64(rho_st, W.device)
    J0 = torch.einsum("DNpqrs, Nrs -> Dpq", W, rho_st)
    K0 = torch.einsum("DNprqs, Nrs -> Dpq", Y, rho_st)
    neg = _index(np.asarray(tr_diff)[0], W.device)    # neg[D] = -D
    Jst = torch.empty_like(J0)
    Kst = torch.empty_like(K0)
    Jst[neg] = J0
    Kst[neg] = K0
    return Jst, Kst


def _fft_pair(kmesh, m):
    """R2k / k2R of (N, m, m) stripes over the k mesh (fftn: H(k) =
    sum_R e^{-ikR} H(R))."""
    N = int(np.prod(kmesh))
    dims = tuple(range(len(kmesh)))

    def R2k(st):
        return torch.fft.fftn(st.reshape(kmesh + (m, m)).to(
            torch.complex128), dim=dims).reshape(N, m, m)

    def k2R(bk):
        return torch.fft.ifftn(bk.reshape(kmesh + (m, m)),
                               dim=dims).reshape(N, m, m)
    return R2k, k2R


def kscf_stripe_hf(h_st, S_st, eriF, tr_diff, kmesh, nelec, tol=1e-10,
                   max_cycle=150, dm0_st=None, damp=0.3,
                   device=torch.device("cuda"), info=None, jk_tables=None):
    """Restricted k-space supercell HF with translation-ERI JK on `device`:
    per-iteration cost O(ncells^2 nao_cell^4) for JK + ncells small eighs
    -- never touches an O(nao_sc^4) object.  All inputs/outputs are
    <(R)|X|(0)> stripes.  jk_tables: make_jk_tables(eriF, tr_diff) when
    the caller has them (eriF is then not read); info: a dict that
    receives the iteration count ("n_iter") and the tables ("jk_tables",
    for update_ham_eriF).  Returns (E_elec, rho_st, fock_st); the stripes
    are tensors on `device`."""
    kmesh = tuple(int(x) for x in kmesh)
    h_st = as_f64(h_st, device)
    S_st = as_f64(S_st, device)
    m = h_st.shape[-1]
    R2k, k2R = _fft_pair(kmesh, m)
    W, Y = jk_tables if jk_tables is not None else make_jk_tables(
        as_f64(eriF, device), tr_diff)
    h_k = R2k(h_st)
    S_k = R2k(S_st)
    Sk = 0.5 * (S_k + _h(S_k))
    L_inv = torch.linalg.inv(torch.linalg.cholesky(Sk))   # per-k S^-1/2 frame
    nocc = nelec // 2
    assert nelec % 2 == 0
    nkm = S_k.shape[0] * m

    def solve(F_k):
        """Aufbau density of F(k) C = S(k) C e over all (k, band), and the
        HOMO-LUMO gap as a 0-d tensor."""
        Ft = L_inv @ F_k @ _h(L_inv)
        ew, v = torch.linalg.eigh(0.5 * (Ft + _h(Ft)))
        ev = _h(L_inv) @ v
        flat = ew.reshape(-1)
        order = torch.argsort(flat, stable=True)
        occ = torch.zeros(nkm, dtype=torch.float64, device=flat.device)
        occ[order[:nocc]] = 2.0
        gap = (flat[order[nocc]] - flat[order[nocc - 1]] if nocc < nkm
               else flat.new_tensor(np.inf))
        rho_k = (ev * occ.reshape(ew.shape)[:, None, :].to(ev.dtype)) @ _h(ev)
        return rho_k, gap

    def energy(F_k, rho_k):
        return 0.5 * torch.einsum("kpq, kqp ->", h_k + F_k, rho_k).real

    def fock(rho_k):
        rho_st = k2R(rho_k).real
        Jst, Kst = jk_stripes(rho_st, W, Y, tr_diff)
        return rho_st, h_st + Jst - 0.5 * Kst

    if dm0_st is None:
        rho_k, gap = solve(h_k)
    else:
        rho_k = R2k(as_f64(dm0_st, device))
    E_old = 0.0
    n_it = 0
    for it in range(max_cycle):
        n_it = it + 1
        _, F_st = fock(rho_k)
        F_k = R2k(F_st)
        rho_new, gap = solve(F_k)
        E, gap_h = torch.stack([energy(F_k, rho_k), gap]).tolist()
        if gap_h < 1e-8:
            log.warn("kscf: (near-)degenerate Fermi level, gap=%.2e", gap_h)
        if abs(E - E_old) < tol and it > 3:
            rho_k = rho_new
            break
        rho_k = rho_new if it < 2 else (1.0 - damp) * rho_new + damp * rho_k
        E_old = E
    rho_st, F_st = fock(rho_k)
    E = float(energy(R2k(F_st), R2k(rho_st)))
    if info is not None:
        info["n_iter"] = n_it
        info["jk_tables"] = (W, Y)
    return E, rho_st, F_st


def lowdin_k(S_st, kmesh):
    """Per-k Lowdin frames of a stripe overlap tensor S_st (N, m, m):
    (C_k = S(k)^{-1/2}, S(k)^{1/2}), each (N, m, m) complex128 on S_st's
    device (the Hermitian inverse square root keeps the LO stripes
    real)."""
    kmesh = tuple(int(x) for x in kmesh)
    R2k, _ = _fft_pair(kmesh, S_st.shape[-1])
    w, v = torch.linalg.eigh(R2k(S_st))
    assert float(w.min()) > 1e-9, "k-block overlap not positive definite"
    w = w.to(v.dtype)
    return (v / torch.sqrt(w)[:, None, :]) @ _h(v), \
        (v * torch.sqrt(w)[:, None, :]) @ _h(v)


def make_diamond_lattice3(kmesh=(3, 3, 3), a_ang=3.567, basis="gth-szv",
                          pseudo="gth-pade", gmax=None, precision=1e-10,
                          scf_tol=1e-11, cache_file=None,
                          device=torch.device("cuda")):
    """Diamond on a full 3D k-mesh (diamond_cell(kmesh)), never forming an
    O(nao_sc^4) object: stripe 1-body integrals -> the translation-'full'
    ERI by range separation (eri_trans_full_rs) -> k-space HF
    (kscf_stripe_hf) -> per-k Lowdin LOs (lowdin_k) -> embedding ERIs
    streamed by the range-separated driver (H2 format 'aft', df_mode
    'rs'; the impurity ERI eri_imp from get_emb_eri_rs).

    cache_file: an .npz path, or a directory for a name keyed by the
    arguments; when it exists the stripe integrals, eriF, e_nuc and the
    pair-FT column are read from it (the JAX package's keys), else they
    are written there.  Returns (Lat, meta)."""
    import os
    from libdmet_preview_tpu_torch.models.lattice import MeshLattice
    kmesh = tuple(int(x) for x in kmesh)
    cell = diamond_cell(kmesh, a_ang, basis, pseudo, gmax, precision,
                        device)
    N = cell.ncells_tr
    nlo = cell.nao // N
    key = "diamond3_rs1_%s_%s_%s_%s_%.0e" % ("x".join(map(str, kmesh)),
                                             a_ang, basis, pseudo,
                                             precision)
    cfile = None
    if cache_file is not None:
        cfile = cache_file if cache_file.endswith(".npz") \
            else os.path.join(cache_file, key + ".npz")
    if cfile is not None and os.path.exists(cfile):
        log.result("diamond3 %s: loading cached integrals %s", kmesh, cfile)
        dat = np.load(cfile)
        h_st, S_st, eriF, e_nuc = (dat["h_st"], dat["S_st"], dat["eriF"],
                                   float(dat["e_nuc"]))
        # pre-seed the pair-FT column cache
        cell._ft_cache = (dat["Gv"], torch.complex(
            as_f64(dat["fcol_re"], device), as_f64(dat["fcol_im"], device)),
            False)
    else:
        h_st = _stripe_symm_tr(cell.intor_hcore(), cell.tr_diff, nlo)
        S_st = _stripe_symm_tr(cell.intor_ovlp(), cell.tr_diff, nlo)
        eriF = cell.eri_trans_full_rs()
        e_nuc = cell.energy_nuc()
        if cfile is not None:
            os.makedirs(os.path.dirname(cfile) or ".", exist_ok=True)
            Gv_c, fcol_c, _ = cell._ft_cache
            fcol_c = to_host(fcol_c)
            tmp = cfile + ".tmp.npz"
            np.savez(tmp, h_st=to_host(h_st), S_st=to_host(S_st),
                     eriF=to_host(eriF), e_nuc=e_nuc, Gv=Gv_c,
                     fcol_re=fcol_c.real, fcol_im=fcol_c.imag)
            os.replace(tmp, cfile)
    info = {}
    with stage("k-HF", device):
        E_elec, rho_st, fock_st = kscf_stripe_hf(
            h_st, S_st, eriF, cell.tr_diff, kmesh, cell.nelectron,
            tol=scf_tol, device=device, info=info)
    E_hf = E_elec + e_nuc
    log.result("diamond3: k-HF done E/cell = %.10f", E_hf / N)

    with stage("Lowdin", device):
        R2k, k2R = _fft_pair(kmesh, nlo)
        S_st = as_f64(S_st, device)
        h_st = as_f64(h_st, device)
        C_k, Sh_k = lowdin_k(S_st, kmesh)
        h_lo_R = k2R(_h(C_k) @ R2k(h_st) @ C_k)
        f_lo_R = k2R(_h(C_k) @ R2k(fock_st) @ C_k)
        r_lo_R = k2R(_h(Sh_k) @ R2k(rho_st) @ Sh_k)
        for name, arr in (("h", h_lo_R), ("fock", f_lo_R),
                          ("rdm1", r_lo_R)):
            im = float(torch.abs(arr.imag).max())
            log.eassert(im < 1e-8, "LO %s stripe imaginary %.2e", name, im)
        h_lo_R, f_lo_R, r_lo_R = (to_host(h_lo_R.real), to_host(f_lo_R.real),
                                  to_host(r_lo_R.real))
        # supercell AO -> LO matrix (columns cell-major) for the drivers
        C_R = k2R(C_k)
        log.eassert(float(torch.abs(C_R.imag).max()) < 1e-8,
                    "C_ao_lo stripes imaginary")
        C_full = _expand_stripe_tr(C_R.real.contiguous(), cell.tr_diff)
    eri_imp = cell.get_emb_eri_rs(C_full[:, :nlo])

    Lat = MeshLattice(kmesh, nlo)
    Ham = AbInitioHam(h_lo_R, f_lo_R, None, eri_imp, e_nuc / N,
                      aft_cell=cell, C_ao_lo=C_full, df_mode="rs")
    Lat.set_Ham_abinitio(Ham, rdm1=r_lo_R[None], device=device)
    Lat.set_val_virt_core(nlo, 0, 0)
    W, Y = info["jk_tables"]
    meta = {"cell": cell, "E_hf": E_hf, "E_hf_elec": E_elec,
            "e_nuc": e_nuc, "C_ao_lo": C_full, "nlo": nlo,
            "h_lo_R": h_lo_R, "fock_lo_R": f_lo_R, "rdm1_lo_R": r_lo_R,
            "S_st": S_st, "C_k": C_k, "h_st": h_st, "W": W, "Y": Y,
            "kmesh": kmesh, "tr_diff": cell.tr_diff}
    return Lat, meta


def update_ham_eriF(Lat, meta, rdm1_lo_R):
    """Charge self-consistency for translation-ERI lattices: rebuild the
    lattice Fock stripes from new LO density stripes with the
    translation-symmetric JK tables (AO basis), then rotate back.

    meta: kmesh, nlo, C_k (per-k AO -> LO, lowdin_k), W / Y
    (make_jk_tables), tr_diff and h_st (the AO hcore stripes); the work
    runs on the device of C_k."""
    kmesh = tuple(int(x) for x in meta["kmesh"])
    m = meta["nlo"]
    C_k = meta["C_k"]
    dev = C_k.device
    R2k, k2R = _fft_pair(kmesh, m)
    rdm1_lo_R = to_host(rdm1_lo_R)
    if rdm1_lo_R.ndim == 4:
        rdm1_lo_R = rdm1_lo_R.sum(axis=0)
    r_lo_k = R2k(as_f64(rdm1_lo_R, dev))
    # density transforms contravariantly: rho_AO = C rho_LO C^dagger
    r_ao_st = k2R(C_k @ r_lo_k @ _h(C_k)).real
    Jst, Kst = jk_stripes(r_ao_st, meta["W"], meta["Y"], meta["tr_diff"])
    F_k = R2k(as_f64(meta["h_st"], dev) + Jst - 0.5 * Kst)
    f_lo_R = k2R(_h(C_k) @ F_k @ C_k)
    im = float(torch.abs(f_lo_R.imag).max())
    log.eassert(im < 1e-7, "updated fock stripes imaginary")
    f_lo_R = to_host(f_lo_R.real)
    Lat.update_Ham(rdm1_lo_R[None] if rdm1_lo_R.ndim == 3 else rdm1_lo_R,
                   fock_lo_k=Lat.R2k(f_lo_R))
    Lat.fock_lo_R = f_lo_R
    meta["fock_lo_R"] = f_lo_R


def _uhf_incore(S, hcore, eri, dm0, na, nb, e_nuc=0.0, tol=1e-9,
                max_cycle=300, level_shift=0.3, damping=0.1,
                diis_space=10, device=torch.device("cuda")):
    """Lean in-core UHF with DIIS + level shift + damping for supercell
    builders: the J/K build (n^4) on `device`, the n x n steps around it
    (DIIS, level shift, generalized eigh) on the host."""
    from libdmet_preview_tpu_torch.ops.diis import DIIS
    n = S.shape[0]
    S = to_host(S)
    hcore = to_host(hcore)
    g = as_f64(eri, device)
    hc = as_f64(hcore, device)

    def fock(dma, dmb):
        dma, dmb = as_f64(dma, device), as_f64(dmb, device)
        J = torch.einsum("pqrs, rs -> pq", g, dma + dmb)
        Ka = torch.einsum("prqs, rs -> pq", g, dma)
        Kb = torch.einsum("prqs, rs -> pq", g, dmb)
        return to_host(hc + J - Ka), to_host(hc + J - Kb)

    diis = DIIS(space=diis_space)
    dm = np.asarray(to_host(dm0), dtype=float).copy()
    e_old = np.inf
    E = 0.0
    conv = False
    for it in range(max_cycle):
        Fa, Fb = fock(dm[0], dm[1])
        E = 0.5 * (np.einsum("pq, qp ->", hcore + Fa, dm[0])
                   + np.einsum("pq, qp ->", hcore + Fb, dm[1]))
        erra = Fa @ dm[0] @ S - S @ dm[0] @ Fa
        errb = Fb @ dm[1] @ S - S @ dm[1] @ Fb
        en = max(np.abs(erra).max(), np.abs(errb).max())
        if en < 0.5:
            Ff = diis.update(np.hstack([Fa.ravel(), Fb.ravel()]),
                             xerr=np.hstack([erra.ravel(), errb.ravel()]))
            Fa = Ff[:n * n].reshape(n, n)
            Fb = Ff[n * n:].reshape(n, n)
        if level_shift > 0:
            Fa = Fa + level_shift * (S - S @ dm[0] @ S)
            Fb = Fb + level_shift * (S - S @ dm[1] @ S)
        wa, ca = sla.eigh(Fa, S)
        wb, cb = sla.eigh(Fb, S)
        dmn = np.asarray([ca[:, :na] @ ca[:, :na].T,
                          cb[:, :nb] @ cb[:, :nb].T])
        dm = (1.0 - damping) * dmn + damping * dm
        if abs(E - e_old) < tol and en < 5e-6:
            conv = True
            break
        e_old = E
    if not conv:
        log.warn("_uhf_incore not converged: dE=%.2e err=%.2e",
                 E - e_old, en)
    return E + e_nuc, dm


# ----------------------------------------------------------------------
# antiferromagnetic transition-metal oxides (NiO AFM-II / FM, the CuO2
# plane): supercell UHF on the range-separated cell ERI, Lowdin LOs
# ----------------------------------------------------------------------

def make_nio_afm_lattice(nk=2, a_ang=4.17, gmax=None, chol_tol=1e-8,
                         precision=1e-10, basis_variant="solid",
                         cache_file=None, device=torch.device("cuda")):
    """Ab initio DMET lattice for ANTIFERROMAGNETIC NiO (the reference's
    examples/dmet/03-dmet-nio-afm): the rhombohedral AFM-II double cell
    (2 Ni + 2 O; the two Ni carry opposite spins), GTH-PADE
    pseudopotentials with s/p/d nonlocal projectors and the tpu-szv
    minimal valence basis (30 orbitals per cell), on a BvK torus of nk
    cells along the third primitive vector.

    Spin-polarized supercell UHF from an AFM guess, Lowdin LOs, per-spin
    lattice operators, the dense LO ERI and its Cholesky factors for the
    interacting bath (_afm_oxide_tail).  cache_file: an .npz path, or a
    directory for the JAX package's key nio_rs1_<nk>_<a>_<variant>_<prec>;
    its S / hcore / eri / e_nuc are read when it exists, else written.
    Returns (Lat, meta)."""
    return _make_nio_lattice("afm", nk, a_ang, gmax, chol_tol, precision,
                             basis_variant, cache_file, device)


def make_nio_fm_lattice(nk=2, a_ang=4.17, gmax=None, chol_tol=1e-8,
                        precision=1e-10, basis_variant="solid",
                        cache_file=None, device=torch.device("cuda")):
    """FERROMAGNETIC NiO (the reference's examples/dmet/04-dmet-nio-fm,
    cell.spin = 4 per double cell): make_nio_afm_lattice's cell and
    integrals (the same cache key), both Ni majority-alpha and the
    supercell UHF at fixed S_z = 2 per Ni (n_alpha - n_beta = 4 nk).
    meta["nelec_ab"] holds (n_alpha, n_beta).  Returns (Lat, meta)."""
    return _make_nio_lattice("fm", nk, a_ang, gmax, chol_tol, precision,
                             basis_variant, cache_file, device)


def _oxide_cell(atoms, a_sc, t_vecs, basis_syms, basis_variant, gmax,
                precision, device):
    """The oxide supercell: the tpu-szv basis of each species, GTH-PADE,
    translations t_vecs.  Returns (cell, nao per atom by species)."""
    from libdmet_preview_tpu_torch.ints.basisopt import \
        make_gth_valence_basis
    from libdmet_preview_tpu_torch.ints.pbc import PbcCell
    basis_data = {(sym, "tpu-szv"): make_gth_valence_basis(
        sym, variant=basis_variant) for sym in basis_syms}
    cell = PbcCell(atoms, a_sc, basis="tpu-szv", basis_data=basis_data,
                   unit="B", pseudo="gth-pade", gmax=gmax,
                   precision=precision, device=device)
    cell.set_translations(len(t_vecs), np.asarray(t_vecs))
    nao_atom = {sym: sum({0: 1, 1: 3, 2: 6}[l] for l, _ in
                         basis_data[(sym, "tpu-szv")])
                for sym in basis_syms}
    return cell, nao_atom


def _oxide_integrals(cell, cache_file, key, name):
    """S, hcore, the range-separated ERI (intor_eri_rs: the bare G mesh
    underconverges the sharp d-shell pairs) and e_nuc of an oxide cell,
    read from or written to cache_file (an .npz path, or a directory for
    `key`) with the JAX package's layout."""
    import os
    cfile = None
    if cache_file is not None:
        cfile = cache_file if cache_file.endswith(".npz") \
            else os.path.join(cache_file, key)
    if cfile is not None and os.path.exists(cfile):
        log.result("%s: loading cached integrals %s", name, cfile)
        dat = np.load(cfile)
        return (dat["S"], dat["hcore"], dat["eri"], float(dat["e_nuc"]))
    S = cell.intor_ovlp()
    hcore = cell.intor_hcore()
    eri = cell.intor_eri_rs()
    e_nuc = cell.energy_nuc()
    if cfile is not None:
        os.makedirs(os.path.dirname(cfile) or ".", exist_ok=True)
        tmp = cfile + ".tmp.npz"
        np.savez(tmp, S=to_host(S), hcore=to_host(hcore), eri=to_host(eri),
                 e_nuc=e_nuc)
        os.replace(tmp, cfile)
    return S, hcore, eri, e_nuc


def _diag_guess(atoms, occs):
    """(2, n, n) diagonal density guess: occs(sym, k) gives the alpha and
    beta occupations, in shell order, of the k-th atom of species sym."""
    da, db, seen = [], [], {}
    for sym, _ in atoms:
        k = seen.get(sym, 0)
        seen[sym] = k + 1
        oa, ob = occs(sym, k)
        da += oa
        db += ob
    return np.asarray([np.diag(da), np.diag(db)])


def _nio_occs(order):
    """The NiO guess occupations (for _diag_guess): AFM, Ni sublattice A
    majority-alpha d and B majority-beta; FM, both majority-alpha; O
    closed shell.  Ni shell order 3s, 4s, p, d."""
    def occs(sym, k):
        if sym == "Ni":
            up = k % 2 == 0 if order == "afm" else True
            da, db = (0.85, 0.55) if up else (0.55, 0.85)
            return ([1.0, 0.5] + [1.0] * 3 + [da] * 6,
                    [1.0, 0.5] + [1.0] * 3 + [db] * 6)
        return [1.0] + [2.0 / 3.0] * 3, [1.0] + [2.0 / 3.0] * 3
    return occs


def _cuo2_occs(sym, k):
    """The CuO2 d9 guess occupations (for _diag_guess): Cu sublattice A
    majority-alpha d, B majority-beta; O^2- 2s2 2p6.  Cu shell order 4s,
    d."""
    if sym == "Cu":
        da, db = (0.88, 0.62) if k % 2 == 0 else (0.62, 0.88)
        return [0.25] + [da] * 6, [0.25] + [db] * 6
    return [1.0] * 4, [1.0] * 4


def _d_slices(atoms, nao_atom, magnetic, d0):
    """The d-orbital index ranges of the `magnetic` atoms among `atoms`
    (the first cell), d0 orbitals into each atom (shell order)."""
    out, p = [], 0
    for sym, _ in atoms:
        if sym == magnetic:
            out.append(slice(p + d0, p + d0 + 6))
        p += nao_atom[sym]
    return out


def _make_nio_lattice(order, nk, a_ang, gmax, chol_tol, precision,
                      basis_variant, cache_file, device):
    from libdmet_preview_tpu_torch.ints.pbc import BOHR_PER_ANGSTROM
    a0 = a_ang * BOHR_PER_ANGSTROM
    # AFM-II rhombohedral double cell (the reference's NiO-AFM-417 POSCAR)
    P = 0.5 * a0 * np.asarray([[2.0, 1.0, 1.0],
                               [1.0, 2.0, 1.0],
                               [1.0, 1.0, 2.0]])
    fracs = [("Ni", np.array([0.0, 0.0, 0.0])),       # Ni (spin up)
             ("Ni", np.array([0.5, 0.5, 0.5])),       # Ni (spin down)
             ("O", np.array([0.25, 0.25, 0.25])),
             ("O", np.array([0.75, 0.75, 0.75]))]
    atoms = [(sym, f @ P + c * P[2]) for c in range(nk) for sym, f in fracs]
    cell, nao_atom = _oxide_cell(
        atoms, np.asarray([P[0], P[1], nk * P[2]]),
        np.arange(nk)[:, None] * P[2][None, :], ("Ni", "O"), basis_variant,
        gmax, precision, device)
    nlo = cell.nao // nk
    log.result("NiO %s cell: nao = %d (%d per cell), nelec = %d",
               order.upper(), cell.nao, nlo, cell.nelectron)
    key = "nio_rs1_%d_%s_%s_%.0e.npz" % (nk, a_ang, basis_variant, precision)
    S, hcore, eri, e_nuc = _oxide_integrals(cell, cache_file, key, "NiO")

    if order == "afm":
        na = nb = cell.nelectron // 2
    else:
        sz2 = 4 * nk          # 2 unpaired electrons per Ni, 2 Ni per cell
        na = (cell.nelectron + sz2) // 2
        nb = cell.nelectron - na
    with stage("supercell UHF", device):
        E_hf, dm = _uhf_incore(S, hcore, eri,
                               _diag_guess(atoms, _nio_occs(order)), na, nb,
                               e_nuc=e_nuc, tol=1e-9, device=device)
    Lat, meta = _afm_oxide_tail(
        cell, nk, nlo, S, hcore, eri, e_nuc, dm, E_hf, chol_tol,
        _d_slices(atoms[:len(fracs)], nao_atom, "Ni", 5), device)
    meta["mag_ni"] = meta["mag_d"]
    meta["nelec_ab"] = (na, nb)
    return Lat, meta


def _afm_oxide_tail(cell, nk, nlo, S, hcore, eri, e_nuc, dm, E_hf,
                    chol_tol, mag_slices, device=torch.device("cuda")):
    """The oxide lattice from its supercell UHF, on `device`: Lowdin LOs,
    per-spin LO operators, the dense LO ERI (four GEMMs) and its Cholesky
    factors, stripes, and the staggered d moments over `mag_slices` (LO
    ranges of the magnetic atoms in the first cell)."""
    from libdmet_preview_tpu_torch.models.lattice import ChainLattice
    from libdmet_preview_tpu_torch.ops.eri_transform import cholesky_eri
    from libdmet_preview_tpu_torch.solvers.scf import _veff_uhf
    with stage("LO transform", device):
        S = as_f64(S, device)
        C = lowdin(S)
        h_lo = C.T @ as_f64(hcore, device) @ C
        SC = S @ C
        dm = as_f64(dm, device)
        rdm1_lo = torch.stack([SC.T @ dm[s] @ SC for s in range(2)])
        eri_lo = _rot4(as_f64(eri, device), C, C, C, C)
        va, vb = _veff_uhf(rdm1_lo[0], rdm1_lo[1], eri_lo, eri_lo, eri_lo)
        fock_lo = torch.stack([h_lo + va, h_lo + vb])
        h_R = to_host(_stripe_symm(h_lo, nk, nlo))
        h_R = np.asarray([h_R, h_R])
        fock_R, rdm1_R = [to_host(torch.stack([_stripe_symm(M[s], nk, nlo)
                                               for s in range(2)]))
                          for M in (fock_lo, rdm1_lo)]
    with stage("LO ERI Cholesky", device):
        chol_L = cholesky_eri(eri_lo, tol=chol_tol)
    n4 = (slice(None, nlo),) * 4
    eri_imp = torch.stack([eri_lo[n4]] * 3)    # aa, bb, ab equal (same C)

    Lat = ChainLattice(nk * nlo, nlo)
    Ham = AbInitioHam(h_R, fock_R, chol_L, eri_imp, e_nuc / nk)
    Lat.set_Ham_abinitio(Ham, rdm1=rdm1_R, device=device)
    Lat.set_val_virt_core(nlo, 0, 0)
    mag = [float(torch.trace(rdm1_lo[0][b, b] - rdm1_lo[1][b, b]))
           for b in mag_slices]
    meta = {"cell": cell, "E_hf": E_hf, "E_hf_elec": E_hf - e_nuc,
            "e_nuc": e_nuc, "C_ao_lo": C, "eri_lo": eri_lo, "h_lo": h_lo,
            "fock_lo": fock_lo, "rdm1_lo": rdm1_lo, "nlo": nlo, "S": S,
            "mag_d": np.asarray(mag)}
    return Lat, meta


def make_cuo2_afm_lattice(nk=2, a_ang=3.80, vac_ang=8.0, gmax=None,
                          chol_tol=1e-8, precision=1e-10,
                          basis_variant="solid", cache_file=None,
                          device=torch.device("cuda")):
    """Ab initio DMET lattice for the ANTIFERROMAGNETIC CuO2 plane, the
    cuprate parent compound's active layer: the square plane (lattice
    constant a_ang) in its sqrt2 x sqrt2 AFM double cell (2 Cu + 4 O) with
    vac_ang of vacuum along z, on a BvK torus of nk cells along the first
    AFM vector.  The plane is (CuO2)^2- per formula unit (Cu^2+ d9, O^2-
    closed shell); a uniform background compensates the two extra
    electrons (the G = 0 Coulomb terms are dropped), so cell.nelectron is
    set to 25 per formula after the cell is built.  Cu carries the q11
    GTH-PADE pseudopotential (4s / 3d valence) and the tpu-szv basis.

    Supercell UHF from a staggered d9 guess, then _afm_oxide_tail.
    cache_file as in make_nio_afm_lattice (key cuo2_rs1_...).  Returns
    (Lat, meta) with meta["mag_d"] the staggered Cu d moments."""
    from libdmet_preview_tpu_torch.ints.pbc import BOHR_PER_ANGSTROM
    a0 = a_ang * BOHR_PER_ANGSTROM
    c0 = vac_ang * BOHR_PER_ANGSTROM
    # A1 = (a, a), A2 = (a, -a); Cu at (0, 0) and (a, 0) carry opposite
    # spins; 4 bridging O at the half-integer sites
    A = np.asarray([[a0, a0, 0.0], [a0, -a0, 0.0], [0.0, 0.0, c0]])
    sites = [("Cu", (0.0, 0.0)), ("Cu", (1.0, 0.0)),
             ("O", (0.5, 0.0)), ("O", (0.0, 0.5)),
             ("O", (1.5, 0.0)), ("O", (1.0, 0.5))]
    atoms = [(sym, np.asarray([x * a0, y * a0, 0.0]) + c * A[0])
             for c in range(nk) for sym, (x, y) in sites]
    cell, nao_atom = _oxide_cell(
        atoms, np.asarray([nk * A[0], A[1], A[2]]),
        np.arange(nk)[:, None] * A[0][None, :], ("Cu", "O"), basis_variant,
        gmax, precision, device)
    # (CuO2)^2- per formula: 11 + 2 * 6 + 2 = 25 electrons
    cell.nelectron = 25 * 2 * nk
    nlo = cell.nao // nk
    log.result("CuO2 AFM plane: nao = %d (%d per cell), nelec = %d "
               "(charged, jellium-compensated)", cell.nao, nlo,
               cell.nelectron)
    key = "cuo2_rs1_%d_%s_%s_%.0e.npz" % (nk, a_ang, basis_variant,
                                          precision)
    S, hcore, eri, e_nuc = _oxide_integrals(cell, cache_file, key, "CuO2")

    na = nb = cell.nelectron // 2
    with stage("supercell UHF", device):
        E_hf, dm = _uhf_incore(S, hcore, eri,
                               _diag_guess(atoms, _cuo2_occs), na, nb,
                               e_nuc=e_nuc, tol=1e-9, device=device)
    return _afm_oxide_tail(cell, nk, nlo, S, hcore, eri, e_nuc, dm, E_hf,
                           chol_tol,
                           _d_slices(atoms[:len(sites)], nao_atom, "Cu", 1),
                           device)
