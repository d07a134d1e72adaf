"""
Molecular quadrature grids and AO values on them (PyTorch port of
libdmet_preview_tpu/ints/grid.py), on the device.

Atom-centred grids: a Gauss-Legendre radial map r = R0 x / (1 - x) times a
Gauss-Legendre (cos theta) x uniform (phi) sphere product rule, with Becke
fuzzy-cell partition weights.  The sphere and radial rules are small and
built on the host exactly as in the JAX package; the Becke partition, which
takes n^2 atom-pair passes over every grid point, runs as tensor ops on the
device: one pass per atom j multiplies the cell functions of all atoms i
by s(mu_ij), so each point's product runs over j in the JAX package's
order.  eval_ao / eval_ao_grad evaluate the s-shell ints.gto.Mole and the
general-l ints.md.MoleGeneral on the grid's device.  Grid points are
processed in chunks of _CHUNK, which bounds the (points, atoms) and
(AOs, points) temporaries.
"""

import numpy as np
import torch

from libdmet_preview_tpu_torch.utils.misc import as_f64

BRAGG = {"H": 0.35, "He": 0.93}   # Bohr-ish radial scale per element
_CHUNK = 1 << 16


def _sphere_rule(n_theta, n_phi):
    """Product quadrature on the unit sphere: weights sum to 4*pi."""
    mu, wmu = np.polynomial.legendre.leggauss(n_theta)
    phi = 2.0 * np.pi * (np.arange(n_phi) + 0.5) / n_phi
    wphi = 2.0 * np.pi / n_phi
    st = np.sqrt(1.0 - mu ** 2)
    pts = np.array([[s * np.cos(p), s * np.sin(p), m]
                    for m, s, w in zip(mu, st, wmu) for p in phi])
    wts = np.array([w * wphi for w in wmu for _ in phi])
    return pts, wts


def _radial_rule(n_rad, r0):
    """Gauss-Legendre on x in (0, 1) mapped to r = r0 x / (1 - x)."""
    x, w = np.polynomial.legendre.leggauss(n_rad)
    x = 0.5 * (x + 1.0)
    w = 0.5 * w
    r = r0 * x / (1.0 - x)
    dr = r0 / (1.0 - x) ** 2
    return r, w * dr * r ** 2          # includes r^2 volume factor


def _dist(coords, centers):
    """|r_g - A| for every point and centre, (npts, ncentres)."""
    d = coords[:, None, :] - centers[None, :, :]
    return torch.sqrt(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
                      + d[..., 2] * d[..., 2])


def _becke_weights(coords, centers, owner, k=3):
    """Becke fuzzy-cell weight of each grid point for the atom that owns
    it.  coords (N, 3) tensor, centers (n, 3) array, owner (N,) long
    tensor on coords' device."""
    n = len(centers)
    if n == 1:
        return torch.ones(len(coords), dtype=coords.dtype,
                          device=coords.device)
    R = np.linalg.norm(centers[:, None, :] - centers[None, :, :], axis=-1)
    dev = coords.device
    R = torch.as_tensor(R, device=dev)
    eye = torch.eye(n, dtype=torch.bool, device=dev)
    cen = torch.as_tensor(centers, device=dev)
    out = torch.empty(len(coords), dtype=coords.dtype, device=dev)
    for c0 in range(0, len(coords), _CHUNK):
        sl = slice(c0, c0 + _CHUNK)
        d = _dist(coords[sl], cen)
        P = torch.ones_like(d)
        for j in range(n):
            # column i: s(mu_ij) of cell i against atom j; 1 at i == j
            f = (d - d[:, j:j + 1]) / R[:, j]
            for _ in range(k):
                f = 1.5 * f - 0.5 * f ** 3
            P = P * torch.where(eye[j], 1.0, 0.5 * (1.0 - f))
        out[sl] = (P / P.sum(dim=1, keepdim=True)).gather(
            1, owner[sl, None])[:, 0]
    return out


def becke_grid(mol, n_rad=50, n_theta=12, n_phi=24,
               device=torch.device("cuda")):
    """Molecular integration grid: (coords (N, 3), weights (N,)), float64
    tensors on `device`."""
    sph_pts, sph_wts = _sphere_rule(n_theta, n_phi)
    centers = np.asarray(mol.coords)
    coords, weights, owner = [], [], []
    for a, (sym, xyz) in enumerate(mol.atoms):
        r, wr = _radial_rule(n_rad, BRAGG.get(sym, 1.0) * 2.0)
        pts = (r[:, None, None] * sph_pts[None, :, :]).reshape(-1, 3) + xyz
        wts = (wr[:, None] * sph_wts[None, :]).reshape(-1)
        coords.append(pts)
        weights.append(wts)
        owner.append(np.full(len(wts), a))
    coords = torch.as_tensor(np.concatenate(coords), device=device)
    weights = torch.as_tensor(np.concatenate(weights), device=device)
    owner = torch.as_tensor(np.concatenate(owner), device=device)
    return coords, weights * _becke_weights(coords, centers, owner)


def _s_shell_table(mol, dev):
    """Centres (nao, 3), exponents and coefficients (nao, maxprim) of a
    Mole's s shells, padded with zero coefficients."""
    nprim = max(len(prims) for _, prims in mol.shells)
    exps = np.zeros((mol.nao, nprim))
    cofs = np.zeros((mol.nao, nprim))
    for p, (_, prims) in enumerate(mol.shells):
        for k, (a, c) in enumerate(prims):
            exps[p, k], cofs[p, k] = a, c
    cens = np.asarray([cen for cen, _ in mol.shells])
    return (torch.as_tensor(cens, device=dev), torch.as_tensor(exps, device=dev),
            torch.as_tensor(cofs, device=dev))


def _offsets(coords, cen):
    """(dx, dy, dz, r^2) of every point from each centre, (ncen, npts)."""
    dx = coords[None, :, 0] - cen[:, 0:1]
    dy = coords[None, :, 1] - cen[:, 1:2]
    dz = coords[None, :, 2] - cen[:, 2:3]
    return dx, dy, dz, dx * dx + dy * dy + dz * dz


def _general_shell_terms(mol, coords, grad):
    """AO values (nao, npts), and with grad their gradients (3, nao, npts),
    of a MoleGeneral: one pass per shell."""
    from libdmet_preview_tpu_torch.ints.md import CART
    ng = coords.shape[0]
    val = coords.new_zeros((mol.nao, ng))
    der = coords.new_zeros((3, mol.nao, ng)) if grad else None
    for sh, (i0, _) in zip(mol.shells, mol.shell_slices):
        cen = torch.as_tensor(np.asarray(sh.center)[None], device=coords.device)
        dx, dy, dz, r2 = _offsets(coords, cen)
        d = (dx[0], dy[0], dz[0])
        R = torch.zeros_like(r2[0])
        Ra = torch.zeros_like(r2[0])
        for alpha, c in zip(sh.exps, sh.coefs):
            e = c * torch.exp(-alpha * r2[0])
            R = R + e
            Ra = Ra + alpha * e
        for comp, lmn in enumerate(CART[sh.l]):
            mono = (d[0] ** lmn[0]) * (d[1] ** lmn[1]) * (d[2] ** lmn[2])
            val[i0 + comp] = mono * R
            if not grad:
                continue
            for ax in range(3):
                li = lmn[ax]
                poly_d = torch.zeros_like(R)
                if li > 0:
                    lm = list(lmn)
                    lm[ax] = li - 1
                    poly_d = li * (d[0] ** lm[0]) * (d[1] ** lm[1]) \
                        * (d[2] ** lm[2])
                der[ax, i0 + comp] = poly_d * R - 2.0 * d[ax] * mono * Ra
    return val, der


def _coords_tensor(coords, device):
    return as_f64(coords, coords.device if isinstance(coords, torch.Tensor)
                  else device)


def eval_ao(mol, coords, device=torch.device("cuda")):
    """AO values on grid points, (nao, ngrid) on the device of `coords` (a
    tensor) or on `device`.  Handles the s-shell ints.gto.Mole and the
    general-l ints.md.MoleGeneral."""
    coords = _coords_tensor(coords, device)
    out = coords.new_zeros((mol.nao, coords.shape[0]))
    general = hasattr(mol, "shell_slices")
    if not general:
        cen, exps, cofs = _s_shell_table(mol, coords.device)
    for c0 in range(0, coords.shape[0], _CHUNK):
        sl = slice(c0, c0 + _CHUNK)
        if general:
            out[:, sl] = _general_shell_terms(mol, coords[sl], False)[0]
            continue
        r2 = _offsets(coords[sl], cen)[3]
        acc = torch.zeros_like(r2)
        for k in range(exps.shape[1]):
            acc = acc + cofs[:, k:k + 1] * torch.exp(-exps[:, k:k + 1] * r2)
        out[:, sl] = acc
    return out


def eval_ao_grad(mol, coords, device=torch.device("cuda")):
    """Cartesian AO gradients on grid points: (3, nao, ngrid), the nabla
    chi_p of the GGA functionals (sigma = |nabla rho|^2), on the device of
    `coords` (a tensor) or on `device`.

    Analytic: for a Cartesian primitive x^l y^m z^n e^{-a r^2} the x
    derivative is (l x^{l-1} - 2 a x^{l+1}) y^m z^n e^{-a r^2}; the
    contracted-shell form keeps one radial sum R(r^2) = sum_i c_i
    e^{-a_i r^2} and its primitive-weighted companion
    Ra(r^2) = sum_i c_i a_i e^{-a_i r^2}."""
    coords = _coords_tensor(coords, device)
    out = coords.new_zeros((3, mol.nao, coords.shape[0]))
    general = hasattr(mol, "shell_slices")
    if not general:
        cen, exps, cofs = _s_shell_table(mol, coords.device)
    for c0 in range(0, coords.shape[0], _CHUNK):
        sl = slice(c0, c0 + _CHUNK)
        if general:
            out[:, :, sl] = _general_shell_terms(mol, coords[sl], True)[1]
            continue
        dx, dy, dz, r2 = _offsets(coords[sl], cen)
        Ra = torch.zeros_like(r2)
        for k in range(exps.shape[1]):
            Ra = Ra + exps[:, k:k + 1] * cofs[:, k:k + 1] \
                * torch.exp(-exps[:, k:k + 1] * r2)
        for ax, d in enumerate((dx, dy, dz)):
            out[ax, :, sl] = -2.0 * d * Ra
    return out
