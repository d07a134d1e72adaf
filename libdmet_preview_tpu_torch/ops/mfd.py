"""
Lattice mean field: batched k-point diagonalization + occupation assignment
(PyTorch port of libdmet_preview_tpu/ops/mfd.py).

The per-k Hermitian eigenproblems are one batched complex eigh over
(spin, k) on the lattice's device (zlinalg.zeigh).  The occupation logic
runs on the host on the DOUBLED spectrum, as in the JAX package (every
physical level appears twice, electron counts double too), so its zero-T
degeneracy rule and mu make the same decisions; rho(k) = V f V^H takes each
level's value from its pair.
"""

import numpy as np

from libdmet_preview_tpu_torch.utils import logger as log
from libdmet_preview_tpu_torch.utils.misc import (Iterable, add_spin_dim,
                                                  as_f64)
from libdmet_preview_tpu_torch.ops import ftsystem, zlinalg
from libdmet_preview_tpu_torch.utils.timer import to_host


def check_nelec(nelec, ncells=None, tol=1e-5):
    """Round nelec to integer."""
    nelec_round = int(np.round(nelec))
    if abs(nelec - nelec_round) > tol:
        log.warn("HF: nelec rounded to %d (original %.5f)", nelec_round, nelec)
    nelec_per_cell = None
    if ncells is not None:
        nelec_per_cell = nelec_round / float(ncells)
    return nelec_round, nelec_per_cell


def assignocc(ew, nelec, beta, mu0=0.0, fix_mu=False, thr_deg=1e-6,
              f_occ=ftsystem.fermi_smearing_occ):
    """
    Assign occupations (host NumPy).

    Zero-T: prefer keeping mu0 when compatible; spread electrons equally
    across levels degenerate with mu.  Finite-T: Fermi smearing with brentq
    mu search.
    """
    ew = np.asarray(ew)
    if isinstance(nelec, Iterable):
        assert ew.shape[0] == 2
        if not isinstance(mu0, Iterable):
            mu0 = [mu0, mu0]
        ewocc = np.empty_like(ew)
        mu = np.zeros(2)
        nerr = np.zeros(2)
        for s in range(2):
            ewocc[s], mu[s], nerr[s] = assignocc(ew[s], nelec[s], beta, mu0[s],
                                                 fix_mu=fix_mu,
                                                 thr_deg=thr_deg, f_occ=f_occ)
        return ewocc, mu, nerr

    if beta < np.inf:
        if fix_mu:
            mu = mu0
        else:
            mu = ftsystem.find_mu(nelec, ew, beta, mu0=mu0, f_occ=f_occ)
        ewocc = f_occ(mu, ew, beta)
        nerr = abs(np.sum(ewocc) - nelec)
        return ewocc, mu, nerr

    ew_sorted = np.sort(ew, axis=None, kind="mergesort")
    nelec = check_nelec(nelec)[0]
    if np.sum(ew < mu0 - thr_deg) <= nelec and np.sum(ew <= mu0 + thr_deg) >= nelec:
        mu = mu0  # prefer not to move mu
    else:
        mu = 0.5 * (ew_sorted[nelec - 1] + ew_sorted[nelec])
    ewocc = 1.0 * (ew < mu - thr_deg)
    nremain = nelec - ewocc.sum()
    if nremain > 0:
        remain = np.logical_and(ew <= mu + thr_deg, ew >= mu - thr_deg)
        nremain_orb = remain.sum()
        log.warn("degenerate HOMO-LUMO, fractional occupation: "
                 "%s electrons over %s orbitals", nremain, nremain_orb)
        ewocc = ewocc + (float(nremain) / nremain_orb) * remain
    return ewocc, mu, 0.0


def HF(lattice, vcor, filling, restricted, mu0=None, beta=np.inf, ires=False,
       use_hcore=None, **kwargs):
    """
    One-shot lattice RHF/UHF on the lattice's device.

    Returns (rho_R, mu, E) or + res dict, host NumPy like the JAX package:
    rho_R (spin, ncells, n, n); res["e"] the doubled spectrum
    (spin, nk, 2n); res["coef"] the complex eigenvectors (spin, nk_diag,
    n, n) of the diagonalized k-points (the IBZ when time reversal holds).
    """
    log.eassert(beta >= 0, "beta cannot be negative")
    device = lattice.device
    if device is None:
        raise ValueError("HF: the lattice has no device (attach its "
                         "Hamiltonian with set_Ham(..., device=...))")
    if use_hcore is None:
        use_hcore = lattice.use_hcore_as_emb_ham
    if use_hcore:
        Fock_k = lattice.getH1(kspace=True)
        FockT = H1T = np.asarray(lattice.getH1(kspace=False))
    else:
        Fock_k = lattice.getFock(kspace=True)
        FockT = np.asarray(lattice.getFock(kspace=False))
        H1T = np.asarray(lattice.getH1(kspace=False))

    f_re, f_im = np.asarray(Fock_k[0]), np.asarray(Fock_k[1])
    if f_re.ndim == 3:
        f_re, f_im = f_re[None], f_im[None]
    nkpts = f_re.shape[-3]

    spin = 1 if restricted else 2
    f_re = add_spin_dim(f_re, spin, non_spin_dim=3)
    f_im = add_spin_dim(f_im, spin, non_spin_dim=3)
    if vcor is None:
        vmat = None
    elif vcor.islocal():
        vmat = np.asarray(vcor.get())
        f_re = f_re + vmat[:spin, None, :, :]
    else:
        # non-local vcor: k-resolved Hermitian pair
        v_re, v_im = vcor.get(kspace=True)
        vmat = None
        f_re = f_re + np.asarray(v_re)[:spin]
        f_im = f_im + np.asarray(v_im)[:spin]

    # time-reversal reduction: H(-k) = H(k)* -> diagonalize only the
    # irreducible half mesh and mirror
    neg = getattr(lattice, "_neg_map", None)
    tr_ok = (kwargs.get("tr_symm", True) and neg is not None
             and np.allclose(f_re[:, neg], f_re, atol=1e-10)
             and np.allclose(f_im[:, neg], -f_im, atol=1e-10))
    ibz = (np.asarray([k for k in range(nkpts) if k <= neg[k]]) if tr_ok
           else np.arange(nkpts))

    ew2_i, V = zlinalg.zeigh(as_f64(f_re[:, ibz], device),
                             as_f64(f_im[:, ibz], device))
    ew2_i = to_host(ew2_i)
    ew2 = np.empty((spin, nkpts, ew2_i.shape[-1]))
    ew2[:, ibz] = ew2_i
    if tr_ok:
        ew2[:, neg[ibz]] = ew2_i

    # occupation on the doubled spectrum: electron counts double too
    if isinstance(filling, Iterable):
        nelec2 = [check_nelec(ew2[s].size * filling[s])[0] for s in range(2)]
        ew_sorted = [np.sort(ew2[s], axis=None) for s in range(2)]
        if mu0 is None:
            mu0 = [_default_mu(ew_sorted[s], nelec2[s]) for s in range(2)]
    else:
        nelec2 = check_nelec(ew2.size * filling)[0]
        ew_sorted = np.sort(ew2, axis=None)
        if mu0 is None:
            mu0 = _default_mu(ew_sorted, nelec2)

    fix_mu = kwargs.get("fix_mu", False)
    tol_deg = kwargs.get("tol_deg", 1e-6)
    ewocc2, mu, nerr = assignocc(ew2, nelec2, beta, mu0, fix_mu=fix_mu,
                                 thr_deg=tol_deg)

    r_re_i, r_im_i = zlinalg.zfunc_from_eig(V, as_f64(ewocc2[:, ibz],
                                                      device))
    r_re_i, r_im_i = to_host(r_re_i), to_host(r_im_i)
    nlo = r_re_i.shape[-1]
    rho_re = np.empty((spin, nkpts, nlo, nlo))
    rho_im = np.empty((spin, nkpts, nlo, nlo))
    rho_re[:, ibz] = r_re_i
    rho_im[:, ibz] = r_im_i
    if tr_ok:
        # rho(-k) = rho(k)*
        rho_re[:, neg[ibz]] = r_re_i
        rho_im[:, neg[ibz]] = -r_im_i
    rhoT = np.asarray(lattice.k2R((rho_re, rho_im)))

    # energy
    FockT = add_spin_dim(FockT, spin, non_spin_dim=3)
    H1T = add_spin_dim(H1T, spin, non_spin_dim=3)
    if spin == 1:
        E0 = np.sum((FockT + H1T) * rhoT) + lattice.getH0()
        E = E0 if vmat is None else E0 + np.sum(vmat[0] * rhoT[0, 0])
    else:
        E0 = 0.5 * np.sum((FockT + H1T) * rhoT) + lattice.getH0()
        if vmat is None:
            E = E0
        else:
            E = E0 + 0.5 * np.sum(vmat[0] * rhoT[0, 0] + vmat[1] * rhoT[1, 0])
    E = float(np.real(E))

    if not ires:
        return rhoT, mu, E
    if isinstance(filling, Iterable):
        gap, homo, lumo = [], [], []
        for s in range(2):
            h, l = _homo_lumo(ew_sorted[s], mu[s])
            homo.append(h)
            lumo.append(l)
            gap.append(l - h)
        gap = np.asarray(gap)
    else:
        homo, lumo = _homo_lumo(ew_sorted, mu)
        gap = lumo - homo
    res = {"gap": gap, "e": ew2, "coef": to_host(V), "nerr": nerr,
           "rho_k": (rho_re, rho_im),
           "E0": float(np.real(E0)), "E": E, "mo_occ": ewocc2,
           "homo": homo, "lumo": lumo}
    return rhoT, mu, E, res


def HF_scf(lattice, vcor, filling, restricted, mu0=None, beta=np.inf,
           max_cycle=50, conv_tol=1e-10, ires=False, **kwargs):
    """Self-consistent lattice HF for model Hamiltonians: alternate the
    one-shot k diagonalization with the JK rebuild of the lattice Fock.

    Requires a local H2 (update_Ham support).  Returns like HF()."""
    log.eassert(lattice.H2_format == "local",
                "HF_scf implemented for local lattice H2")
    E_old = np.inf
    out = None
    for it in range(max_cycle):
        out = HF(lattice, vcor, filling, restricted, mu0=mu0, beta=beta,
                 ires=True, use_hcore=False, **kwargs)
        rhoT, mu, E, res = out
        spin = rhoT.shape[0]
        lattice.update_Ham(rhoT * (2.0 if spin == 1 else 1.0))
        if abs(E - E_old) < conv_tol:
            break
        E_old = E
    log.info("HF_scf: converged in %d cycles, E = %.12f", it + 1, E)
    if ires:
        return out
    return out[:3]


def _default_mu(ew_sorted, nelec):
    if nelec <= 0:
        return ew_sorted[0]
    if nelec >= len(ew_sorted):
        return ew_sorted[-1]
    return 0.5 * (ew_sorted[nelec - 1] + ew_sorted[nelec])


def _homo_lumo(ew_sorted, mu):
    homo_idx = max(np.searchsorted(ew_sorted, mu, side="right") - 1, 0)
    lumo_idx = min(np.searchsorted(ew_sorted, mu, side="left"),
                   len(ew_sorted) - 1)
    return ew_sorted[homo_idx], ew_sorted[lumo_idx]


def GHF(lattice, vcor, filling, mu0=None, beta=np.inf, ires=False, **kwargs):
    """Generalized HF over spin-orbitals: one complex eigh of the
    (2nao x 2nao) blocks [[F_a + v_a, D], [D^T, F_b + v_b]] per k on the
    lattice's device, occupations on the doubled spectrum.  vcor.get() is
    (3, nao, nao): v_a, v_b and the off-diagonal block D.  res["coef"] are
    the complex eigenvectors (1, nk, 2nao, 2nao)."""
    device = lattice.device
    if device is None:
        raise ValueError("GHF: the lattice has no device (attach its "
                         "Hamiltonian with set_Ham(..., device=...))")
    Fock_k = lattice.getFock(kspace=True)
    f_re, f_im = np.asarray(Fock_k[0]), np.asarray(Fock_k[1])
    if f_re.ndim == 3:
        f_re, f_im = f_re[None], f_im[None]
    f_re = add_spin_dim(f_re, 2, non_spin_dim=3)
    f_im = add_spin_dim(f_im, 2, non_spin_dim=3)
    nao = lattice.nao
    nkpts = f_re.shape[-3]
    vmat = np.asarray(vcor.get()) if vcor is not None else np.zeros((3, nao, nao))
    GF_re = np.zeros((1, nkpts, 2 * nao, 2 * nao))
    GF_im = np.zeros_like(GF_re)
    GF_re[0, :, :nao, :nao] = f_re[0] + vmat[0]
    GF_im[0, :, :nao, :nao] = f_im[0]
    GF_re[0, :, nao:, nao:] = f_re[1] + vmat[1]
    GF_im[0, :, nao:, nao:] = f_im[1]
    GF_re[0, :, :nao, nao:] = vmat[2]
    GF_re[0, :, nao:, :nao] = vmat[2].T
    ew2, V = zlinalg.zeigh(as_f64(GF_re, device), as_f64(GF_im, device))
    ew2 = to_host(ew2)
    nelec2 = check_nelec(ew2.size * filling)[0]
    ew_sorted = np.sort(ew2, axis=None)
    if mu0 is None:
        mu0 = _default_mu(ew_sorted, nelec2)
    ewocc2, mu, nerr = assignocc(ew2, nelec2, beta, mu0,
                                 fix_mu=kwargs.get("fix_mu", False),
                                 thr_deg=kwargs.get("tol_deg", 1e-6))
    rho_re, rho_im = zlinalg.zfunc_from_eig(V, as_f64(ewocc2, device))
    rho_re, rho_im = to_host(rho_re), to_host(rho_im)
    rhoT = np.asarray(lattice.k2R((rho_re[0], rho_im[0])))
    E = float(np.sum(GF_re[0] * rho_re[0] + GF_im[0] * rho_im[0])) / nkpts
    if ires:
        res = {"e": ew2, "coef": to_host(V),
               "rho_k": (rho_re[0], rho_im[0]),
               "mo_occ": ewocc2, "nerr": nerr}
        return rhoT, mu, E, res
    return rhoT, mu, E
