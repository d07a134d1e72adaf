"""
LDA / LSDA and PBE exchange-correlation functionals with autograd
potentials (PyTorch port of libdmet_preview_tpu/ints/xc.py).

v_xc is never hand-coded: E_xc[D] is a function of the density matrix
through rho(r) (and sigma = |nabla rho|^2 for the GGA) on a quadrature
grid, and the potential matrix is dE_xc/dD by torch.autograd.grad on the
tensors' device, symmetrized, as the JAX package takes jax.value_and_grad.
Functional and potential can therefore never disagree.

Functionals: Slater exchange + VWN5 or PW92 correlation (LDA / LSDA), and
the PBE GGA (exchange + correlation, written in sigma so that the autograd
potential, with its -div[de/d(nabla rho)] term, is smooth).  Standard
public parametrizations.  Every function below works elementwise on
float64 tensors.
"""

import numpy as np
import torch

_TINY = 1e-30

# Slater exchange constant: ex = -Cx * rho^{4/3} (per spin: spin-scaling)
_CX = (3.0 / 4.0) * (3.0 / np.pi) ** (1.0 / 3.0)

# VWN5 parameters: (A, x0, b, c) for paramagnetic / ferromagnetic /
# spin-stiffness fits (standard published constants)
_VWN = {
    "P": (0.0310907, -0.10498, 3.72744, 12.9352),
    "F": (0.01554535, -0.325, 7.06042, 18.0578),
    "A": (-1.0 / (6.0 * np.pi ** 2), -0.00475840, 1.13107, 13.0045),
}


def _vwn_eps(rs, key):
    A, x0, b, c = _VWN[key]
    x = torch.sqrt(rs)
    X = x * x + b * x + c
    X0 = x0 * x0 + b * x0 + c
    Q = np.sqrt(4.0 * c - b * b)
    atn = torch.arctan(Q / (2.0 * x + b))
    return A * (torch.log(x * x / X) + 2.0 * b / Q * atn
                - b * x0 / X0 * (torch.log((x - x0) ** 2 / X)
                                 + 2.0 * (b + 2.0 * x0) / Q * atn))


def _f_zeta(zeta):
    return (torch.pow(1.0 + zeta, 4.0 / 3.0)
            + torch.pow(1.0 - zeta, 4.0 / 3.0) - 2.0) \
        / (2.0 ** (4.0 / 3.0) - 2.0)


_FPP0 = 4.0 / (9.0 * (2.0 ** (1.0 / 3.0) - 1.0))   # f''(0)


def lsda_exc_density(rho_a, rho_b):
    """e_xc(r) * rho(r) for the LSDA (Slater X + VWN5 C); elementwise."""
    rho_a = torch.clamp(rho_a, min=_TINY)
    rho_b = torch.clamp(rho_b, min=_TINY)
    rho = rho_a + rho_b
    # exchange (exact spin scaling)
    ex = -_CX * (2.0 ** (1.0 / 3.0)) * (rho_a ** (4.0 / 3.0)
                                        + rho_b ** (4.0 / 3.0))
    # correlation (VWN5 interpolation)
    rs = (3.0 / (4.0 * np.pi * rho)) ** (1.0 / 3.0)
    zeta = (rho_a - rho_b) / rho
    eP = _vwn_eps(rs, "P")
    eF = _vwn_eps(rs, "F")
    eA = _vwn_eps(rs, "A")
    f = _f_zeta(zeta)
    z4 = zeta ** 4
    ec = eP + eA * f / _FPP0 * (1.0 - z4) + (eF - eP) * f * z4
    return ex + ec * rho


def slater_exc_density(rho_a, rho_b):
    """Exchange-only (Slater / Dirac) energy density."""
    rho_a = torch.clamp(rho_a, min=_TINY)
    rho_b = torch.clamp(rho_b, min=_TINY)
    return -_CX * (2.0 ** (1.0 / 3.0)) * (rho_a ** (4.0 / 3.0)
                                          + rho_b ** (4.0 / 3.0))


# ---------------------------------------------------------------------
# PW92 LDA correlation (Perdew-Wang 1992; the uniform limit PBE
# correlation is built on).  Standard published constants.
_PW92 = {
    # (A, alpha1, beta1, beta2, beta3, beta4)
    "ec0": (0.031091, 0.21370, 7.5957, 3.5876, 1.6382, 0.49294),
    "ec1": (0.015545, 0.20548, 14.1189, 6.1977, 3.3662, 0.62517),
    "mac": (0.016887, 0.11125, 10.357, 3.6231, 0.88026, 0.49671),
}


def _pw92_G(rs, key):
    A, a1, b1, b2, b3, b4 = _PW92[key]
    srs = torch.sqrt(rs)
    den = 2.0 * A * (b1 * srs + b2 * rs + b3 * rs * srs + b4 * rs * rs)
    return -2.0 * A * (1.0 + a1 * rs) * torch.log1p(1.0 / den)


def pw92_eps_c(rs, zeta):
    """PW92 correlation energy per electron eps_c(rs, zeta)."""
    e0 = _pw92_G(rs, "ec0")
    e1 = _pw92_G(rs, "ec1")
    mac = _pw92_G(rs, "mac")          # MINUS the spin stiffness alpha_c
    f = _f_zeta(zeta)
    z4 = zeta ** 4
    return e0 + mac * f / _FPP0 * (z4 - 1.0) + (e1 - e0) * f * z4


def ldapw_exc_density(rho_a, rho_b):
    """Slater X + PW92 C energy density (the PBE's own LDA limit)."""
    rho_a = torch.clamp(rho_a, min=_TINY)
    rho_b = torch.clamp(rho_b, min=_TINY)
    rho = rho_a + rho_b
    rs = (3.0 / (4.0 * np.pi * rho)) ** (1.0 / 3.0)
    zeta = torch.clamp((rho_a - rho_b) / rho, -1.0 + 1e-12, 1.0 - 1e-12)
    return slater_exc_density(rho_a, rho_b) + pw92_eps_c(rs, zeta) * rho


# ---------------------------------------------------------------------
# PBE (Perdew-Burke-Ernzerhof 1996) GGA, in terms of sigma = |nabla rho|^2
# (never |nabla rho|), so that the autograd potential is smooth through
# sigma -> 0.
_PBE_KAPPA = 0.804
_PBE_MU = 0.2195149727645171
_PBE_BETA = 0.06672455060314922
_PBE_GAMMA = (1.0 - np.log(2.0)) / np.pi ** 2


def _pbe_x_channel(rho, sigma):
    """Spin-channel PBE exchange: ex_unif(rho) * F_x(s^2) for a FULLY
    spin-polarized density rho (callers pass 2*rho_sigma and 4*sigma_ss
    per the exact spin-scaling relation)."""
    rho = torch.clamp(rho, min=_TINY)
    ex_unif = -_CX * rho ** (4.0 / 3.0)
    # s^2 = sigma / (4 (3 pi^2)^{2/3} rho^{8/3})
    s2 = sigma / (4.0 * (3.0 * np.pi ** 2) ** (2.0 / 3.0)
                  * rho ** (8.0 / 3.0))
    Fx = 1.0 + _PBE_KAPPA - _PBE_KAPPA / (1.0 + _PBE_MU * s2 / _PBE_KAPPA)
    return ex_unif * Fx


def pbe_exc_density(rho_a, rho_b, sigma_aa, sigma_ab, sigma_bb):
    """PBE exchange-correlation energy density e_xc(r) (per volume)."""
    rho_a = torch.clamp(rho_a, min=_TINY)
    rho_b = torch.clamp(rho_b, min=_TINY)
    rho = rho_a + rho_b
    # exchange by spin scaling: Ex[ra, rb] = (Ex[2ra] + Ex[2rb]) / 2
    ex = 0.5 * (_pbe_x_channel(2.0 * rho_a, 4.0 * sigma_aa)
                + _pbe_x_channel(2.0 * rho_b, 4.0 * sigma_bb))
    # correlation: PW92 uniform part + gradient correction H
    rs = (3.0 / (4.0 * np.pi * rho)) ** (1.0 / 3.0)
    zeta = torch.clamp((rho_a - rho_b) / rho, -1.0 + 1e-12, 1.0 - 1e-12)
    eps_c = pw92_eps_c(rs, zeta)
    phi = 0.5 * (torch.pow(1.0 + zeta, 2.0 / 3.0)
                 + torch.pow(1.0 - zeta, 2.0 / 3.0))
    phi3 = phi ** 3
    kf = (3.0 * np.pi ** 2 * rho) ** (1.0 / 3.0)
    ks2 = 4.0 * kf / np.pi
    sigma = sigma_aa + 2.0 * sigma_ab + sigma_bb
    t2 = sigma / torch.clamp(4.0 * phi * phi * ks2 * rho * rho, min=_TINY)
    bg = _PBE_BETA / _PBE_GAMMA
    expo = torch.exp(-eps_c / (_PBE_GAMMA * phi3))
    A = bg / torch.clamp(expo - 1.0, min=_TINY)
    At2 = A * t2
    H = _PBE_GAMMA * phi3 * torch.log1p(
        bg * t2 * (1.0 + At2) / (1.0 + At2 + At2 * At2))
    return ex + (eps_c + H) * rho


_XC_FUNCS = {"lsda": lsda_exc_density, "lda": lsda_exc_density,
             "slater": slater_exc_density, "lda_pw": ldapw_exc_density,
             "pw92": ldapw_exc_density}
_GGA_FUNCS = {"pbe": pbe_exc_density, "pbe,pbe": pbe_exc_density}


def is_gga(xc):
    """True when `xc` names a gradient-corrected functional (the caller
    must then supply AO gradients to eval_exc_vxc)."""
    return xc is not None and xc.lower() in _GGA_FUNCS


def _rho(ao, d):
    """rho_g = sum_pq chi_p(g) D_pq chi_q(g), and D @ chi for the GGA."""
    Dao = d @ ao
    return (ao * Dao).sum(dim=0), Dao


def _exc_from_dm(dm, ao, w, restricted, xc="lsda", ao_grad=None):
    """E_xc of a density matrix (a 0-dim tensor): dm (nao, nao) spin-traced
    total if restricted, else (2, nao, nao) per spin.  ao_grad (3, nao,
    ngrid) enables the GGA functionals (sigma from nabla rho)."""
    xc = xc.lower()
    dms = (0.5 * dm,) if restricted else (dm[0], dm[1])
    if xc in _GGA_FUNCS:
        rho, grad = [], []
        for d in dms:
            r, Dao = _rho(ao, d)
            rho.append(r)
            # nabla rho = 2 sum_pq D_pq chi_p nabla chi_q (D symmetric)
            grad.append(2.0 * (ao_grad * Dao).sum(dim=1))
        if restricted:
            rho, grad = rho * 2, grad * 2
        sig_aa = (grad[0] * grad[0]).sum(dim=0)
        sig_ab = (grad[0] * grad[1]).sum(dim=0)
        sig_bb = (grad[1] * grad[1]).sum(dim=0)
        return (w * _GGA_FUNCS[xc](rho[0], rho[1], sig_aa, sig_ab,
                                   sig_bb)).sum()
    func = _XC_FUNCS[xc]
    rho = [_rho(ao, d)[0] for d in dms]
    if restricted:
        return (w * func(rho[0], rho[0])).sum()
    return (w * func(rho[0], rho[1])).sum()


def eval_exc_vxc(dm, ao, w, restricted=True, xc="lsda", ao_grad=None,
                 device=torch.device("cuda")):
    """(E_xc, v_xc) with v_xc = dE_xc/dD by torch.autograd.

    Runs on the device of ao when it is a tensor, else on `device` (arrays
    go there); E_xc is a float and v_xc a tensor on that device.

    restricted: dm is the spin-traced TOTAL density matrix; v_xc is the
    per-spin potential (the derivative with respect to the total D already
    gives the spin potential because E depends on D/2 per channel).

    For GGA functionals (is_gga(xc)) pass ao_grad = (3, nao, ngrid) from
    ints.grid.eval_ao_grad; the gradient-correction term of the potential
    (the -div[de/d(nabla rho)] piece of the textbook GGA vxc) falls out of
    autograd -- no hand-derived divergence."""
    dev = ao.device if isinstance(ao, torch.Tensor) else torch.device(device)
    ao = torch.as_tensor(ao, dtype=torch.float64, device=dev)
    w = torch.as_tensor(w, dtype=torch.float64, device=ao.device)
    dm = torch.as_tensor(dm, dtype=torch.float64, device=ao.device)
    if is_gga(xc):
        if ao_grad is None:
            raise ValueError("GGA functional '%s' needs ao_grad "
                             "(ints.grid.eval_ao_grad)" % xc)
        ao_grad = torch.as_tensor(ao_grad, dtype=torch.float64,
                                  device=ao.device)
    dm = dm.detach().requires_grad_(True)
    with torch.enable_grad():
        exc = _exc_from_dm(dm, ao, w, restricted, xc, ao_grad)
        (vxc,) = torch.autograd.grad(exc, dm)
    # symmetrize the gradient with respect to the symmetric-matrix argument
    vxc = 0.5 * (vxc + vxc.transpose(-1, -2))
    return float(exc.detach()), vxc
