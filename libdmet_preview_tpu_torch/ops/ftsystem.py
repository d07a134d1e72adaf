"""
Finite-temperature occupations and chemical-potential search (port of the
host NumPy part of libdmet_preview_tpu/ops/ftsystem.py; its jnp versions
belong to the fit, which the port runs in ops/zlinalg.py).
"""

import numpy as np
from scipy.optimize import brentq

FIT_TOL = 1e-12


def fermi_smearing_occ(mu, mo_energy, beta):
    """Fermi-Dirac occupations, numpy, overflow-safe."""
    mo_energy = np.asarray(mo_energy)
    mu_arr = np.asarray(mu).reshape(-1, *([1] * (mo_energy.ndim - 1))) \
        if np.ndim(mu) > 0 else mu
    de = beta * (mo_energy - mu_arr)
    occ = np.zeros_like(mo_energy, dtype=float)
    idx = de < 100
    occ[idx] = 1.0 / (np.exp(de[idx]) + 1.0)
    return occ


def gaussian_smearing_occ(mu, mo_energy, beta):
    from scipy.special import erfc
    mo_energy = np.asarray(mo_energy)
    return 0.5 * erfc((mo_energy - mu) * beta)


def find_mu(nelec, mo_energy, beta, mu0=None, f_occ=fermi_smearing_occ,
            tol=FIT_TOL):
    """Brentq mu search on sorted energies."""
    mo_energy = np.sort(np.asarray(mo_energy).ravel())

    def cost(mu):
        return f_occ(mu, mo_energy, beta).sum() - nelec

    nelec_int = int(np.round(nelec))
    if nelec_int >= len(mo_energy):
        lval = mo_energy[-1] - 1.0 / beta
        rval = mo_energy[-1] + max(10.0, 1.0 / beta)
    elif nelec_int <= 0:
        lval = mo_energy[0] - max(10.0, 1.0 / beta)
        rval = mo_energy[0] + 1.0 / beta
    else:
        lval = mo_energy[nelec_int - 1] - 1.0 / beta
        rval = mo_energy[nelec_int] + 1.0 / beta
    if cost(lval) * cost(rval) > 0:
        lval -= max(100.0, 1.0 / beta)
        rval += max(100.0, 1.0 / beta)
    return brentq(cost, lval, rval, xtol=tol, rtol=tol, maxiter=10000)


def make_rdm1(mo_coeff, mo_occ):
    return (mo_coeff * mo_occ).dot(mo_coeff.conj().T)
