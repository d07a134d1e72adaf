"""
Population / correlation analysis, order parameters, bands, DOS and the
ELF (PyTorch port of libdmet_preview_tpu/utils/analysis.py; reference
analogs: the reference libdmet's system/analyze.py:185-258 Mulliken
populations, the reference libdmet's utils/get_order_param.py:18-576
AFM / SC order parameters, utils/plot.py bands, DOS and ELF).

Host post-processing: every function takes arrays or tensors (a tensor is
read to the host first) and returns NumPy, as in the JAX package.  Only
eval_elf evaluates AO values, on `device`.
"""

import numpy as np
import torch

from libdmet_preview_tpu_torch.utils import logger as log
from libdmet_preview_tpu_torch.utils.misc import to_host


def _np(x):
    """An array of x (a tensor is read to the host)."""
    return to_host(x) if isinstance(x, torch.Tensor) else np.asarray(x)


def mulliken_lo(rdm1_lo, labels=None):
    """Mulliken populations in an orthonormal LO basis: pop_i = rho_ii.

    rdm1_lo: ((spin,) nlo, nlo) impurity-cell density; restricted input is
    interpreted as the per-spin density (reference analyze.py:185-258).
    Returns (pop (spin, nlo), charges (nlo,), spin_density (nlo,))."""
    rdm1_lo = _np(rdm1_lo)
    if rdm1_lo.ndim == 2:
        rdm1_lo = np.asarray([rdm1_lo, rdm1_lo])
    elif rdm1_lo.shape[0] == 1:
        rdm1_lo = np.asarray([rdm1_lo[0], rdm1_lo[0]])
    pop = np.asarray([np.diag(rdm1_lo[0]), np.diag(rdm1_lo[1])])
    charge = pop[0] + pop[1]
    spin_dens = pop[0] - pop[1]
    if labels is not None:
        for i, lab in enumerate(labels):
            log.result("%-10s charge %10.6f  spin %10.6f", lab,
                       charge[i], spin_dens[i])
    return pop, charge, spin_dens


def get_order_param_afm(rdm1_imp, stag=None):
    """Staggered (AFM) magnetization of the impurity cell:
    m = (1/nimp) sum_i (-1)^i (n_i^a - n_i^b) / 2
    (reference get_order_param.py AFM order)."""
    rdm1_imp = _np(rdm1_imp)
    assert rdm1_imp.ndim == 3 and rdm1_imp.shape[0] == 2
    nimp = rdm1_imp.shape[-1]
    if stag is None:
        stag = np.asarray([(-1.0) ** i for i in range(nimp)])
    sz = 0.5 * (np.diag(rdm1_imp[0]) - np.diag(rdm1_imp[1]))
    return float(np.sum(stag * sz)) / nimp


def get_order_param_sc(GRho_imp):
    """s-wave superconducting order: mean |kappa_ii| over the impurity
    (anomalous <a_i b_i>) from a GSO/BCS generalized density."""
    from libdmet_preview_tpu_torch.ops.spinless import extract_rdm
    _, _, kappa = extract_rdm(_np(GRho_imp))
    return float(np.mean(np.abs(np.diag(kappa))))


def bond_order(rdm1_lo, i, j):
    """Simple LO-basis bond order: sum_s rho_s[i, j]
    (reference analyze.py:598-740 simplified to the orthonormal case)."""
    rdm1_lo = _np(rdm1_lo)
    if rdm1_lo.ndim == 2:
        return 2.0 * rdm1_lo[i, j]
    return float(np.sum(rdm1_lo[:, i, j]))


def get_dos(mo_energy, ws=None, sigma=0.05, nw=400):
    """Broadened density of states from (possibly k-resolved) orbital
    energies (reference utils/plot.py:825-1006 get_dos core).

    mo_energy: any-shape array of levels.  Returns (ws, dos)."""
    e = _np(mo_energy).ravel()
    if ws is None:
        ws = np.linspace(e.min() - 10 * sigma, e.max() + 10 * sigma, nw)
    diff = ws[:, None] - e[None, :]
    dos = np.sum(np.exp(-0.5 * (diff / sigma) ** 2), axis=1) \
        / (sigma * np.sqrt(2 * np.pi))
    return ws, dos


def get_dos_k(mo_energy_k, mo_coeff_k=None, ws=None, sigma=0.05, nw=400,
              idx=None):
    """k-resolved / orbital-projected density of states (reference
    utils/plot.py:825-1006 get_dos_k): per-k broadened DOS and, when
    mo_coeff_k (k, nao, nmo) is given, the projected DOS on orbitals
    `idx` weighted by |C[p, m]|^2.

    mo_energy_k: (nk, nmo) [or (spin, nk, nmo)].  Returns (ws, dos) with
    dos shaped (nk, nw) [or (spin, nk, nw)]."""
    e = _np(mo_energy_k)
    if e.ndim == 3:
        out = [get_dos_k(e[s], None if mo_coeff_k is None
                         else _np(mo_coeff_k)[s], ws=ws,
                         sigma=sigma, nw=nw, idx=idx) for s in range(e.shape[0])]
        return out[0][0], np.asarray([o[1] for o in out])
    nk, nmo = e.shape
    if ws is None:
        ws = np.linspace(e.min() - 10 * sigma, e.max() + 10 * sigma, nw)
    diff = ws[None, :, None] - e[:, None, :]          # (nk, nw, nmo)
    g = np.exp(-0.5 * (diff / sigma) ** 2) / (sigma * np.sqrt(2 * np.pi))
    if mo_coeff_k is not None:
        C = _np(mo_coeff_k)
        if idx is None:
            idx = np.arange(C.shape[1])
        wmo = np.sum(np.abs(C[:, idx, :]) ** 2, axis=1)  # (nk, nmo)
        dos = np.einsum("kwm, km -> kw", g, wmo)
    else:
        dos = g.sum(axis=-1)
    return ws, dos


def spin_corr_mean_field(rdm1, i, j):
    """<S^z_i S^z_j> at the single-determinant level from the per-spin
    rdm1 (Wick): (reference utils/plot.py:684-824 mean-field path)."""
    rdm1 = _np(rdm1)
    assert rdm1.ndim == 3 and rdm1.shape[0] == 2
    na_i, nb_i = rdm1[0, i, i], rdm1[1, i, i]
    na_j, nb_j = rdm1[0, j, j], rdm1[1, j, j]
    if i == j:
        szi_szj = 0.25 * (na_i + nb_i - 2.0 * na_i * nb_i)
    else:
        szi_szj = 0.25 * ((na_i - nb_i) * (na_j - nb_j)) \
            - 0.25 * (rdm1[0, i, j] * rdm1[0, j, i]
                      + rdm1[1, i, j] * rdm1[1, j, i])
    return float(szi_szj)


def get_symm_orb(perms, nsites=None, tol=1e-9, seed=11):
    """Point-group symmetry-adapted orbitals from site permutations
    (reference system/analyze.py:539 get_symm_orb capability).

    perms: list of length-n index arrays (site i -> perm[i]) generating the
    group action.  Returns a list of (n, d) orthonormal blocks, each an
    invariant subspace of every permutation (irrep blocks, possibly split
    further when the commutant is larger).

    Method: eigenspaces of a random matrix symmetrized over the group --
    a generic element of the commutant, whose eigenspaces are exactly the
    invariant subspaces."""
    perms = [np.asarray(p, dtype=int) for p in perms]
    if nsites is None:
        nsites = len(perms[0])
    rng = np.random.RandomState(seed)
    M = rng.randn(nsites, nsites)
    M = M + M.T
    # average over the generated group (close the generators first)
    mats = {tuple(range(nsites)): np.eye(nsites)}
    frontier = [np.eye(nsites)[p] for p in perms]
    while frontier:
        P = frontier.pop()
        key = tuple(int(x) for x in np.argmax(P, axis=1))
        if key in mats:
            continue
        mats[key] = P
        for Q in [np.eye(nsites)[p] for p in perms]:
            frontier.append(P @ Q)
    group = list(mats.values())
    Mbar = sum(P @ M @ P.T for P in group) / len(group)
    w, v = np.linalg.eigh(Mbar)
    blocks = []
    start = 0
    for i in range(1, nsites + 1):
        if i == nsites or w[i] - w[start] > tol * max(1.0, abs(w[start])):
            blocks.append(v[:, start:i])
            start = i
    return blocks


def mo_composition(C_lo_mo, groups):
    """Per-MO composition over LO groups (reference analyze.py:354 k-MO
    composition analysis): fraction of each (orthonormal-LO-basis) MO on
    each group of LO indices.

    C_lo_mo: (..., nlo, nmo) real, or a (re, im) pair for k orbitals;
    groups: {name: [lo indices]}.  Returns {name: (..., nmo) weights};
    weights over a complete partition sum to 1 per MO."""
    if isinstance(C_lo_mo, (tuple, list)):
        w2 = _np(C_lo_mo[0]) ** 2 + _np(C_lo_mo[1]) ** 2
    else:
        w2 = np.abs(_np(C_lo_mo)) ** 2
    return {name: w2[..., idx, :].sum(axis=-2)
            for name, idx in groups.items()}


def spin_corr_from_rdm2(rdm1, rdm2, i, j):
    """Correlated <S^z_i S^z_j> from spin-blocked RDMs (reference
    utils/plot.py:684-824 correlated path).

    rdm1: (2, n, n) per spin; rdm2: (3, n, n, n, n) chemist blocks
    [aa, bb, ab] with G[p,q,r,s] = <p+ r+ s q>.  Uses
    <n^s_i n^t_j> = G^{st}[i,i,j,j] + delta_st delta_ij n^s_i."""
    rdm1 = _np(rdm1)
    rdm2 = _np(rdm2)
    na_i, nb_i = rdm1[0, i, i], rdm1[1, i, i]
    naa = rdm2[0, i, i, j, j] + (na_i if i == j else 0.0)
    nbb = rdm2[1, i, i, j, j] + (nb_i if i == j else 0.0)
    nab = rdm2[2, i, i, j, j]
    nba = rdm2[2, j, j, i, i]
    return float(0.25 * (naa + nbb - nab - nba))


# ----------------------------------------------------------------------
# molecular analysis (reference system/molecule.py + analyze.py roles:
# population analysis, dipole moments, symmetry-equivalent fragments)
# ----------------------------------------------------------------------

def mulliken_mol(mol, dm):
    """Mulliken populations/charges per atom for a MoleGeneral molecule:
    q_A = Z_A - sum_{mu in A} (D S)_mumu with D the spin-summed AO
    density (reference analyze.py:185-258 lattice analog, molecular AO
    variant)."""
    dm = _np(dm)
    if dm.ndim == 3:
        dm = dm.sum(axis=0)
    S = mol.intor_ovlp()
    ps = np.diag(dm @ S)
    pops = []
    charges = []
    for (p0, p1), Z in zip(mol.ao_slices_by_atom(), mol.charges):
        pop = float(ps[p0:p1].sum())
        pops.append(pop)
        charges.append(float(Z) - pop)
    return np.asarray(pops), np.asarray(charges)


def dipole_mol(mol, dm, origin=None):
    """Molecular dipole moment (a.u.): nuclear - electronic, with the
    charge center as the default origin."""
    dm = _np(dm)
    if dm.ndim == 3:
        dm = dm.sum(axis=0)
    if origin is None:
        origin = (mol.charges[:, None]
                  * mol.coords).sum(axis=0) / mol.charges.sum()
    r_ints = mol.intor_dipole(origin=origin)
    d_el = -np.einsum("xpq, qp -> x", r_ints, dm)
    d_nuc = np.einsum("a, ax -> x", mol.charges, mol.coords - origin)
    return d_el + d_nuc


def equivalent_atoms(mol, tol=1e-6):
    """Partition atoms into point-group orbits by geometric fingerprint
    (sorted distances to all atoms, weighted by charges): atoms related
    by ANY symmetry operation of the molecule share a fingerprint.
    Returns a list of index lists (reference get_symm_orb role for
    molecular fragments)."""
    coords = mol.coords
    Z = np.asarray(mol.charges)
    n = len(coords)
    fps = []
    for i in range(n):
        d = np.linalg.norm(coords - coords[i][None, :], axis=1)
        fp = np.sort(np.round(np.stack([d, np.broadcast_to(Z, d.shape)],
                                       axis=1) / tol) * tol, axis=0)
        fps.append((float(Z[i]), fp))
    groups = []
    used = set()
    for i in range(n):
        if i in used:
            continue
        grp = [i]
        used.add(i)
        for j in range(i + 1, n):
            if j in used:
                continue
            if fps[i][0] == fps[j][0] and np.allclose(
                    fps[i][1], fps[j][1], atol=10 * tol):
                grp.append(j)
                used.add(j)
        groups.append(grp)
    return groups


def molecule_fragments(mol, atom_lists=None):
    """Orbital index lists per fragment for molecular DMET
    (make_molecule_lattice flows): atom_lists = explicit atom-index
    groups, or None to use the point-group orbits of equivalent_atoms.
    Returns [(atoms, orb_idx)] with orb_idx the AO/LO indices of the
    fragment (Lowdin LOs inherit the AO atom assignment)."""
    slices = mol.ao_slices_by_atom()
    if atom_lists is None:
        atom_lists = equivalent_atoms(mol)
    out = []
    for atoms in atom_lists:
        idx = []
        for a in atoms:
            p0, p1 = slices[a]
            idx.extend(range(p0, p1))
        out.append((list(atoms), idx))
    return out


# ----------------------------------------------------------------------
# ab initio order parameters (reference get_order_param.py:65-576)
# ----------------------------------------------------------------------

def get_bond_pairs(coords, cell=None, species=None, bond_type=None,
                   length_range=(0.1, 3.0), nimgs=1, tol=1e-8):
    """Species-filtered atom-pair bonds within a distance window,
    periodic-image aware (reference Lat.get_bond_pairs role inside
    get_order_param.py:349-352).

    coords: Cartesian atom positions (natm, dim); cell: (dim, dim)
    lattice-vector rows (None = open boundary); species: per-atom
    labels; bond_type: iterable of (spec_a, spec_b) pairs to keep.

    Returns a list of (i, j, vec, dist) with vec = r_j(+image) - r_i,
    each physical bond counted once (canonical orientation)."""
    coords = np.asarray(coords, dtype=float)
    natm, dim = coords.shape
    if cell is None:
        shifts = [np.zeros(dim)]
    else:
        cell = np.asarray(cell, dtype=float)
        rng = range(-nimgs, nimgs + 1)
        import itertools as it
        shifts = [np.asarray(n) @ cell for n in it.product(rng, repeat=dim)]
    if bond_type is not None and species is not None:
        allowed = set()
        for a, b in bond_type:
            allowed.add((a, b))
            allowed.add((b, a))
    else:
        allowed = None
    out = []
    for i in range(natm):
        for j in range(i, natm):
            if allowed is not None and (species[i], species[j]) not in allowed:
                continue
            for s in shifts:
                vec = coords[j] + s - coords[i]
                d = float(np.linalg.norm(vec))
                if not (length_range[0] <= d <= length_range[1]):
                    continue
                if i == j:
                    # self-bonds through images come in +-s pairs; keep
                    # the lexicographically positive one
                    nz = vec[np.abs(vec) > tol]
                    if nz.size == 0 or nz[0] < 0:
                        continue
                out.append((i, j, vec, d))
    return out


def _dwave_sign(vec, tol=1e-8):
    """+1 for x-dominated bonds, -1 for y-dominated (reference
    get_order_param.py:370-387 sign rule on the bond direction)."""
    ax, ay = abs(vec[0]), abs(vec[1])
    if ax > tol and ay <= tol:
        return 1
    if ay > tol and ax <= tol:
        return -1
    raise ValueError("bond %s is neither x- nor y-directed" % (vec,))


def get_order_ab_initio(rdm1_d, coords, species, offsets, cell=None,
                        bond_type=(("Cu", "Cu"),), length_range=(3.0, 4.5),
                        s_wave=False, nimgs=1, tol=1e-8):
    """Ab initio pairing order over species-filtered bonds (reference
    get_order_param.py:289-576 essentials, array-first).

    rdm1_d: anomalous LO-basis density block <c_a c_b> (nlo, nlo);
    offsets: per-atom orbital index arrays (offsets[i] = LO indices of
    atom i); bonds along x count +, along y - (d-wave rule) unless
    s_wave.  Each bond contributes
    (rdm1_d[oi, oj] + rdm1_d[oj, oi].T) / sqrt(2).

    Returns dict: m (signed block sum over bonds), m_tot (element-abs
    sum, the reference norm='abs'), pairs, signs, orders."""
    rdm1_d = _np(rdm1_d)
    bonds = get_bond_pairs(coords, cell=cell, species=species,
                           bond_type=bond_type, length_range=length_range,
                           nimgs=nimgs, tol=tol)
    factor = 0.5 ** 0.5
    m_sum = 0.0
    pairs, signs, orders = [], [], []
    for (i, j, vec, d) in bonds:
        oi = np.asarray(offsets[i], dtype=int)
        oj = np.asarray(offsets[j], dtype=int)
        sign = 1 if s_wave else _dwave_sign(vec, tol=tol)
        order = (rdm1_d[np.ix_(oi, oj)]
                 + rdm1_d[np.ix_(oj, oi)].T) * factor
        m_sum = m_sum + order * sign
        pairs.append((i, j))
        signs.append(sign)
        orders.append(order)
        log.debug(1, "bond %s-%s  d=%.3f sign=%+d order=%.6g",
                  species[i], species[j], d, sign, float(np.sum(order)))
    m_sum = np.asarray(m_sum)
    m_tot = float(np.sum(np.abs(m_sum)))
    log.result("total pairing order (%s) = %.8g",
               "s-wave" if s_wave else "d-wave", m_tot)
    return {"m": m_sum, "m_tot": m_tot, "pairs": pairs,
            "signs": np.asarray(signs), "orders": orders}


def get_checkerboard_order(rdm1, coords, species, offsets, d_dd,
                           magnetic="Cu", ligand="O", rdm1_d=None,
                           cell=None, tol=1e-8):
    """Checkerboard AFM + charge orders for CuO2-type cells, model or
    ab initio (reference get_order_param.py:65-276).

    rdm1: (2, nlo, nlo) per-spin LO density (or (1,...) restricted);
    coords/species/offsets as in get_order_ab_initio; d_dd = magnetic
    nearest-neighbor distance setting the checkerboard phase grid.

    Returns dict with per-atom charge/spin, m_AFM_<magnetic> (staggered
    average), m_AFM_<ligand>, m_FM, and (with rdm1_d) the d-wave m_SC
    over magnetic-magnetic bonds."""
    rdm1 = _np(rdm1)
    if rdm1.ndim == 2:
        rdm1 = rdm1[None]
    if rdm1.shape[0] == 1:
        rdm1_a = rdm1_b = rdm1[0]
    else:
        rdm1_a, rdm1_b = rdm1
    coords = np.asarray(coords, dtype=float)
    natm = len(species)
    charge = np.asarray([np.sum(rdm1_a[offsets[i], offsets[i]])
                         + np.sum(rdm1_b[offsets[i], offsets[i]])
                         for i in range(natm)])
    sz = np.asarray([0.5 * (np.sum(rdm1_a[offsets[i], offsets[i]])
                            - np.sum(rdm1_b[offsets[i], offsets[i]]))
                     for i in range(natm)])
    res = {"charge": charge, "spin_density": sz}

    mag_idx = [i for i in range(natm) if species[i] == magnetic]
    lig_idx = [i for i in range(natm) if species[i] == ligand]
    mag_xy = coords[mag_idx]
    mag_xy = mag_xy - mag_xy[int(np.argmin(np.linalg.norm(mag_xy, axis=1)))]
    grid = np.rint(mag_xy / d_dd).astype(int)
    phase = np.where(grid.sum(axis=1) % 2 == 1, -1, 1)
    m_list = sz[mag_idx]
    res["phase_AFM"] = phase
    res["m_AFM_%s_list" % magnetic] = m_list
    res["m_AFM_%s" % magnetic] = float(np.average(m_list * phase))
    res["m_AFM"] = abs(res["m_AFM_%s" % magnetic])
    res["m_FM_%s" % magnetic] = float(np.average(m_list))
    res["charge_%s" % magnetic] = charge[mag_idx]
    log.result("charge (%s): %s", magnetic, charge[mag_idx])
    log.result("m_AFM  (%s): %s -> %.6f", magnetic, m_list, res["m_AFM"])
    if lig_idx:
        res["m_AFM_%s_list" % ligand] = sz[lig_idx]
        res["m_AFM_%s" % ligand] = float(np.average(np.abs(sz[lig_idx])))
        res["charge_%s" % ligand] = charge[lig_idx]
        log.result("charge (%s): %s", ligand, charge[lig_idx])
    if rdm1_d is not None:
        sc = get_order_ab_initio(rdm1_d, coords, species, offsets,
                                 cell=cell, bond_type=((magnetic, magnetic),),
                                 length_range=(0.5 * d_dd, 1.5 * d_dd),
                                 tol=tol)
        res["m_SC"] = sc["m_tot"]
        res["m_SC_detail"] = sc
    return res


# ---------------------------------------------------------------------
# Band structure along arbitrary k-paths, Fermi surface, ELF
# (reference utils/plot.py:1095-1326 plot_bands/get_kdis/
# get_fermi_surface/plot_fermi_surface and plot.py:324-633 ELF family).


def get_kdis(kpts, kpts_sp=None):
    """Cumulative distance along a k-path (reference plot.py:1133):
    kpts (nk, d) Cartesian reciprocal coordinates.  Returns (kdis,
    kdis_sp) with kdis_sp the positions of the special points (None if
    kpts_sp not given)."""
    kpts = np.asarray(kpts, dtype=float)
    seg = np.linalg.norm(np.diff(kpts, axis=0), axis=1)
    kdis = np.concatenate([[0.0], np.cumsum(seg)])
    kdis_sp = None
    if kpts_sp is not None:
        kdis_sp = []
        for ksp in np.asarray(kpts_sp, dtype=float):
            i = int(np.argmin(np.linalg.norm(kpts - ksp, axis=1)))
            kdis_sp.append(kdis[i])
        kdis_sp = np.asarray(kdis_sp)
    return kdis, kdis_sp


def k_path(points, n_per_seg=30):
    """Linear interpolation through special points: (nk, d) fractional
    k-path (endpoints included once)."""
    points = np.asarray(points, dtype=float)
    path = [points[0][None]]
    for a, b in zip(points[:-1], points[1:]):
        t = np.linspace(0.0, 1.0, n_per_seg + 1)[1:, None]
        path.append(a[None] * (1 - t) + b[None] * t)
    return np.concatenate(path)


def get_bands(h_R, kpts_frac, ovlp_R=None):
    """Band energies along an ARBITRARY k-path by Fourier interpolation
    of the stripe Hamiltonian (reference role: plot_bands input,
    plot.py:1095; the stripe h(k) = sum_R e^{-2*pi*i k.R} h_R is exact
    for any continuous k, not just the BvK mesh).

    h_R: a dict {tuple(R): block} of translation blocks with integer
    cell offsets R in fractional multiples of the lattice vectors (any
    dimension d), or an (ncells, n, n) array of the stripes of a 1D chain
    in the order 0 .. N-1 (taken at the minimal images -N/2 .. N/2).  An
    array carries no offsets of a 2D or 3D lattice: with a k-path of
    d > 1 it raises ValueError (pass the dict).
    kpts_frac: (nk, d) fractional coordinates; ovlp_R: the overlap
    blocks, an array in the order of h_R's blocks.

    Returns ew (nk, n) ascending eigenvalues (generalized when ovlp_R
    is given)."""
    kpts = np.asarray(kpts_frac, dtype=float)
    if kpts.ndim == 1:
        kpts = kpts[:, None]
    d = kpts.shape[1]
    if isinstance(h_R, dict):
        keys = list(h_R.keys())
        Rs = np.asarray(keys, dtype=float).reshape(len(keys), -1)
        blocks = np.asarray([_np(h_R[R]) for R in keys])
    else:
        if d != 1:
            raise ValueError(
                "array stripes are a 1D chain's (offsets 0 .. N-1); a "
                "%dD lattice needs h_R as a dict {R: block}" % d)
        blocks = _np(h_R)
        ncells = blocks.shape[0]
        R = np.arange(ncells, dtype=float)
        Rs = np.where(R > ncells / 2, R - ncells, R)[:, None]
    if Rs.shape[1] != d:
        raise ValueError("k-path dim %d != stripe offset dim %d"
                         % (d, Rs.shape[1]))
    phase = np.exp(-2.0j * np.pi * (kpts @ Rs.T))       # (nk, ncells)
    h_k = np.einsum("kR, Rpq -> kpq", phase, blocks)
    h_k = 0.5 * (h_k + np.conj(np.swapaxes(h_k, -1, -2)))
    if ovlp_R is None:
        return np.linalg.eigvalsh(h_k)
    s_k = np.einsum("kR, Rpq -> kpq",
                    phase, _np(ovlp_R))
    s_k = 0.5 * (s_k + np.conj(np.swapaxes(s_k, -1, -2)))
    ew = []
    for hk, sk in zip(h_k, s_k):
        w, v = np.linalg.eigh(sk)
        A = v @ np.diag(np.maximum(w, 1e-12) ** -0.5) @ v.conj().T
        ew.append(np.linalg.eigvalsh(A.conj().T @ hk @ A))
    return np.asarray(ew)


def plot_bands(fname, kdis, ew, kdis_sp=None, labels_sp=None,
               e_fermi=None):
    """Band-structure plot (reference plot.py:1095; matplotlib-gated)."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        log.warn("matplotlib not available; plotting disabled")
        return None
    fig, ax = plt.subplots(figsize=(5, 4))
    ew = np.asarray(ew)
    for b in range(ew.shape[1]):
        ax.plot(kdis, ew[:, b], color="C0", lw=1.2)
    if kdis_sp is not None:
        for x in kdis_sp:
            ax.axvline(x, color="gray", lw=0.5)
        if labels_sp is not None:
            ax.set_xticks(kdis_sp)
            ax.set_xticklabels(labels_sp)
    if e_fermi is not None:
        ax.axhline(e_fermi, color="red", ls="--", lw=0.8)
    ax.set_ylabel("E (a.u.)")
    fig.tight_layout()
    fig.savefig(fname, dpi=150)
    plt.close(fig)
    return fname


def get_fermi_surface(mo_energy_k, mu=0.0, sigma=0.1):
    """Fermi-surface weight per k-point (reference plot.py:1204):
    w(k) = sum_m exp(-((e_km - mu)/sigma)^2).  mo_energy_k (nk, nmo)
    [or (spin, nk, nmo) -> per-spin weights]."""
    e = _np(mo_energy_k)
    return np.sum(np.exp(-(((e - mu) / sigma) ** 2)), axis=-1)


def eval_elf(mol, dm, coords, restricted=True, elf_reg=1e-10,
             device=torch.device("cuda")):
    """Electron localization function on a set of points (reference
    plot.py:324-633 plot_elf family, computed natively):

        ELF = 1 / (1 + (D / D_h)^2),
        D   = tau - |grad rho|^2 / (8 rho)   (per spin channel summed),
        D_h = (3/10) (3 pi^2)^{2/3} rho^{5/3} (spin-scaled),

    with tau = 1/2 sum_occ |grad phi|^2 evaluated from the density
    matrix as tau = 1/2 sum_x grad_x ao^T D grad_x ao.

    dm: total density matrix (restricted) or (2, nao, nao).  The AO values
    and the contractions run on the device of `coords` (a tensor) or on
    `device`.  Returns ELF values (npts,), an array."""
    from libdmet_preview_tpu_torch.ints.grid import eval_ao, eval_ao_grad
    from libdmet_preview_tpu_torch.utils.misc import as_f64
    ao = eval_ao(mol, coords, device=device)           # (nao, npts)
    aog = eval_ao_grad(mol, coords, device=device)     # (3, nao, npts)
    dm = as_f64(dm, ao.device)
    dms = [0.5 * dm, 0.5 * dm] if restricted else [dm[0], dm[1]]
    D_tot = 0.0
    Dh_tot = 0.0
    cf = 0.3 * (3.0 * np.pi ** 2) ** (2.0 / 3.0)
    for d in dms:
        dao = d @ ao
        rho = torch.einsum("pg, pg -> g", ao, dao)
        grad = 2.0 * torch.einsum("xqg, qg -> xg", aog, dao)
        tau = 0.5 * torch.einsum("xpg, pq, xqg -> g", aog, d, aog)
        rho_s = torch.clamp(rho, min=elf_reg)
        D_tot = D_tot + (tau - torch.sum(grad ** 2, dim=0)
                         / (8.0 * rho_s))
        # spin-scaled Thomas-Fermi kinetic density: 2^{2/3} cf rho^{5/3}
        Dh_tot = Dh_tot + cf * 2.0 ** (2.0 / 3.0) * rho_s ** (5.0 / 3.0)
    chi = D_tot / torch.clamp(Dh_tot, min=elf_reg)
    return to_host(1.0 / (1.0 + chi ** 2))
