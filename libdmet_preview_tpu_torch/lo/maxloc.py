"""
Maximally-localized Wannier functions (PyTorch port of
libdmet_preview_tpu/lo/maxloc.py).

The Marzari-Vanderbilt spread functional and its minimization over the
per-k gauge U(k), as batched complex128 algebra over the whole (nk, nb)
tensor of overlap matrices on the device.

* `kmesh_bvectors`  : finite-difference b-shells of a Monkhorst-Pack mesh
                      with weights satisfying the B1 completeness
                      condition sum_b w_b b_a b_b = delta_ab (Mostofi et
                      al., CPC 178 (2008) 685, Sec. 3.2), rank-aware for
                      1D/2D lattices (host NumPy, tiny).
* `mmn_from_C`      : M^{(k,b)} = C(k)^H diag(e^{-i b.tau}) C(k+b) for an
                      orthonormal per-cell basis with orbital centers tau.
* `spread_from_M`   : Omega = Omega_I + Omega_D + Omega_OD and the Wannier
                      centers, all from the M tensor (MV Eqs. 18-36).
* `max_loc_U`       : minimize Omega over U(k) by steepest descent with
                      backtracking; a loop on the device that reads one
                      convergence flag per iteration.  The analytic MV
                      gradient G(k) = 4 sum_b w_b (A[R] - S[T]) is tested
                      against torch.autograd of `spread_from_M`.
"""

import itertools as it

import numpy as np
import torch


# ----------------------------------------------------------------------
# k-mesh and b-vector machinery (host-side, tiny)
# ----------------------------------------------------------------------

def kmesh_kpts_frac(kmesh):
    """Fractional k-points of a Gamma-centered MP mesh, in the package's
    row-major cell ordering (itertools.product over mesh axes)."""
    kmesh = [int(x) for x in kmesh]
    pts = list(it.product(*[range(m) for m in kmesh]))
    return np.array([[i / m for i, m in zip(p, kmesh)] for p in pts],
                    dtype=float)


def kmesh_bvectors(latt_vec, kmesh, max_shells=8, tol=1e-6):
    """Finite-difference b-vectors + weights for an MP mesh.

    Returns dict with
      b_cart : (nb, 3) Cartesian b vectors (all shell members, +/- pairs)
      w_b    : (nb,) weights, B1: sum_b w_b b_a b_b = delta_ab on the
               periodic dims (kmesh[i] > 1)
      b_int  : (nb, 3) integer steps on the mesh (for neighbor indexing)
      nb_idx : (nk, nb) index of k+b (periodically folded) in the
               kmesh_kpts_frac ordering
    """
    latt_vec = np.asarray(latt_vec, dtype=float).reshape(3, 3)
    kmesh = [int(x) for x in kmesh]
    recip = 2 * np.pi * np.linalg.inv(latt_vec).T      # rows g_i
    pdims = [d for d in range(3) if kmesh[d] > 1]
    if not pdims:
        raise ValueError("kmesh_bvectors: no periodic dim with mesh > 1")
    # candidate integer steps (only along periodic dims)
    rng = [range(-2, 3) if d in pdims else (0,) for d in range(3)]
    cands = [np.array(n) for n in it.product(*rng) if any(n)]

    def b_of(n):
        return (n / np.array(kmesh, dtype=float)) @ recip

    norms = np.array([np.linalg.norm(b_of(n)) for n in cands])
    order = np.argsort(norms)
    # group into shells by |b|
    shells, cur, cur_r = [], [], None
    for idx in order:
        r = norms[idx]
        if cur_r is None or abs(r - cur_r) < tol * max(1.0, cur_r):
            cur.append(cands[idx])
            cur_r = r if cur_r is None else cur_r
        else:
            shells.append(cur)
            cur, cur_r = [cands[idx]], r
    if cur:
        shells.append(cur)
    shells = shells[:max_shells]
    # B1 condition rows: for each (a <= b) pair of periodic dims
    pairs = [(a, b) for i, a in enumerate(pdims) for b in pdims[i:]]
    target = np.array([1.0 if a == b else 0.0 for a, b in pairs])
    A_rows = []
    for sh in shells:
        bs = np.array([b_of(n) for n in sh])
        A_rows.append([np.sum(bs[:, a] * bs[:, b]) for a, b in pairs])
    A_rows = np.array(A_rows)           # (nshell, npair)
    chosen, w = [], None
    for s in range(len(shells)):
        trial = chosen + [s]
        At = A_rows[trial].T            # (npair, ntrial)
        wt, *_ = np.linalg.lstsq(At, target, rcond=None)
        if np.linalg.norm(At @ wt - target) < 1e-10:
            chosen, w = trial, wt
            break
        # keep the shell only if it reduces the residual (skips shells
        # parallel to ones already taken)
        res_new = np.linalg.norm(At @ wt - target)
        res_old = (np.inf if not chosen else np.linalg.norm(
            A_rows[chosen].T @ np.linalg.lstsq(
                A_rows[chosen].T, target, rcond=None)[0] - target))
        if res_new < res_old - 1e-12:
            chosen = trial
    if w is None:
        raise RuntimeError("kmesh_bvectors: B1 condition not satisfiable "
                           "with %d shells" % len(shells))
    b_int = np.concatenate([np.array(shells[s]) for s in chosen])
    w_b = np.concatenate([np.full(len(shells[s]), w[i])
                          for i, s in enumerate(chosen)])
    b_cart = (b_int / np.array(kmesh, dtype=float)) @ recip
    # neighbor index table
    pts = np.array(list(it.product(*[range(m) for m in kmesh])))
    strides = np.array([kmesh[1] * kmesh[2], kmesh[2], 1])
    nb_idx = np.empty((len(pts), len(b_int)), dtype=np.int32)
    for j, n in enumerate(b_int):
        shifted = (pts + n) % np.array(kmesh)
        nb_idx[:, j] = shifted @ strides
    return {"b_cart": b_cart, "w_b": w_b, "b_int": b_int, "nb_idx": nb_idx,
            "recip": recip, "pdims": pdims}


def _bv_tensors(bv, device):
    """(w_b, b_cart, nb_idx) of a b-vector dict as tensors on `device`."""
    return (torch.as_tensor(bv["w_b"], dtype=torch.float64, device=device),
            torch.as_tensor(bv["b_cart"], dtype=torch.float64,
                            device=device),
            torch.as_tensor(bv["nb_idx"], dtype=torch.long, device=device))


def _as_complex(A, device):
    """A complex128 tensor on `device` from a complex array / tensor or a
    (re, im) pair."""
    if isinstance(A, (tuple, list)):
        return torch.complex(torch.as_tensor(np.array(A[0], dtype=float),
                                             device=device),
                             torch.as_tensor(np.array(A[1], dtype=float),
                                             device=device))
    if isinstance(A, torch.Tensor):
        return A.to(device=device, dtype=torch.complex128)
    return torch.as_tensor(np.array(A, dtype=complex), device=device)


# ----------------------------------------------------------------------
# overlap (M) matrices
# ----------------------------------------------------------------------

def mmn_from_C(C_k, kmesh, latt_vec, tau=None, bv=None,
               device=torch.device("cuda")):
    """M^{(k,b)}_mn = <u_mk | e^{-i b.r} | u_{n,k+b}> for Bloch states
    built on an ORTHONORMAL per-cell basis (Bloch phases e^{ik.T} on cells
    only, so C(k) is periodic in k and the orbital centers enter through
    the explicit e^{-i b.tau_p} factor).

    C_k : (nk, norb, nband) complex, rows over per-cell orbitals in the
          kmesh_kpts_frac ordering.  tau : (norb, 3) orbital centers in
          Cartesian coords (default: all at the cell origin).
    Returns (M (nk, nb, nband, nband) complex128 tensor on `device`, bv)."""
    C_k = _as_complex(C_k, device)
    if bv is None:
        bv = kmesh_bvectors(latt_vec, kmesh)
    norb = C_k.shape[1]
    tau = np.zeros((norb, 3)) if tau is None else \
        np.asarray(tau, dtype=float).reshape(norb, 3)
    phase = torch.as_tensor(np.exp(-1j * (bv["b_cart"] @ tau.T)),
                            device=C_k.device)             # (nb, norb)
    Cb = C_k[torch.as_tensor(bv["nb_idx"], dtype=torch.long,
                             device=C_k.device)]           # (nk, nb, p, n)
    M = torch.matmul(C_k.conj().transpose(-2, -1)[:, None],
                     phase[None, :, :, None] * Cb)
    return M, bv


# ----------------------------------------------------------------------
# spread functional (torch; autograd-able)
# ----------------------------------------------------------------------

def _rotate_M(M0, U, nb_idx):
    """M^{(k,b)} -> U(k)^H M0^{(k,b)} U(k+b), batched over (k, b)."""
    Ub = U[nb_idx]                                        # (nk, nb, nw, nw)
    return U.conj().transpose(-2, -1)[:, None] @ M0 @ Ub


def wannier_centers(M, w_b, b_cart):
    """r_n = -(1/nk) sum_{k,b} w_b b Im ln M^{(k,b)}_nn   (MV Eq. 31)."""
    nk = M.shape[0]
    ang = torch.angle(torch.diagonal(M, dim1=-2, dim2=-1))  # (nk, nb, nw)
    return -torch.einsum("b, bx, kbn -> nx", w_b, b_cart, ang) / nk


def spread_from_M(M, w_b, b_cart):
    """Total MV spread and its invariant/diagonal/off-diagonal split.

    Omega_I  = (1/nk) sum_kb w_b (nw - sum_mn |M_mn|^2)      [gauge inv]
    Omega_OD = (1/nk) sum_kb w_b sum_{m != n} |M_mn|^2
    Omega_D  = (1/nk) sum_kb w_b sum_n (Im ln M_nn + b.r_n)^2
    Returns (omega_tot, dict) with 0-d tensors."""
    nk, nw = M.shape[0], M.shape[-1]
    d = torch.diagonal(M, dim1=-2, dim2=-1)
    absM2 = torch.sum(torch.abs(M) ** 2, dim=(-2, -1))    # (nk, nb)
    absd2 = torch.sum(torch.abs(d) ** 2, dim=-1)
    omega_I = torch.einsum("b, kb ->", w_b, nw - absM2) / nk
    omega_OD = torch.einsum("b, kb ->", w_b, absM2 - absd2) / nk
    r_n = wannier_centers(M, w_b, b_cart)
    q = torch.angle(d) + torch.einsum("bx, nx -> bn", b_cart, r_n)[None]
    omega_D = torch.einsum("b, kbn ->", w_b, q ** 2) / nk
    tot = omega_I + omega_OD + omega_D
    return tot, {"I": omega_I, "OD": omega_OD, "D": omega_D,
                 "centers": r_n}


def mv_gradient(M, w_b, b_cart):
    """Analytic MV gradient G(k) = dOmega/dW(k): anti-Hermitian, with
    dOmega = sum_k tr[G(k)^T dW(k)] for U -> U e^{dW}  (MV Eqs. 47-52,
    w90 conventions).  G = 4 sum_b w_b ( A[R] - S[T] ),
      R_mn = M_mn conj(M_nn),  T_mn = (M_mn / M_nn) q_n,
      A[B] = (B - B^H)/2,  S[B] = (B + B^H)/(2i)."""
    nk = M.shape[0]
    d = torch.diagonal(M, dim1=-2, dim2=-1)               # (nk, nb, nw)
    r_n = wannier_centers(M, w_b, b_cart)
    q = torch.angle(d) + torch.einsum("bx, nx -> bn", b_cart, r_n)[None]
    R = M * d.conj()[:, :, None, :]
    T = (M / d[:, :, None, :]) * q[:, :, None, :]
    A = (R - R.conj().transpose(-2, -1)) / 2
    S = (T + T.conj().transpose(-2, -1)) / 2j
    return 4.0 * torch.einsum("b, kbij -> kij", w_b.to(M.dtype),
                              A - S) / nk


def _expm_antiherm(W):
    """expm of a batch of anti-Hermitian matrices (unitary)."""
    return torch.linalg.matrix_exp(W)


def max_loc_U(M0, bv, U0=None, max_iter=500, step=1.0, tol=1e-10,
              device=torch.device("cuda")):
    """Minimize the MV spread over the per-k gauge.

    Steepest descent with the step shared across k (w90's fixed-step
    scheme plus halving on uphill moves), every decision taken on the
    device with torch.where; the host reads one flag per iteration (the
    gradient norm and step tests).  M0 on `device` unless it is a tensor
    already.  Returns (U (nk, nw, nw) tensor, info dict with
    omega/omega_I/centers/n_iter/grad_norm, and converged: the gradient
    test grad_norm <= tol stopped the loop, not max_iter or a collapsed
    step)."""
    if isinstance(M0, torch.Tensor):
        device = M0.device
    M0 = _as_complex(M0, device)
    w_b, b_cart, nb_idx = _bv_tensors(bv, device)
    nk, nw = M0.shape[0], M0.shape[-1]
    if U0 is None:
        U = torch.eye(nw, dtype=M0.dtype, device=device).expand(
            nk, nw, nw).clone()
    else:
        U = _as_complex(U0, device)
    wsum = torch.sum(w_b)

    def omega_of(U):
        return spread_from_M(_rotate_M(M0, U, nb_idx), w_b, b_cart)[0]

    om0 = omega_of(U)
    om = om0
    stp = torch.tensor(step, dtype=torch.float64, device=device)
    gnorm = torch.tensor(np.inf, dtype=torch.float64, device=device)
    n_it = 0
    while n_it < max_iter:
        M = _rotate_M(M0, U, nb_idx)
        G = mv_gradient(M, w_b, b_cart)
        gnorm = torch.sqrt(torch.sum(torch.abs(G) ** 2))
        # +G is the descent direction: Re tr(G G) = -|G|^2 < 0
        dW = (stp / (4.0 * wsum)).to(G.dtype) * G * nk
        U_new = U @ _expm_antiherm(dW)
        om_new = omega_of(U_new)
        ok = om_new < om + 1e-14
        U = torch.where(ok, U_new, U)
        om = torch.where(ok, om_new, om)
        stp = torch.where(ok, torch.minimum(stp * 1.05, stp.new_tensor(
            step * 4)), stp * 0.5)
        n_it += 1
        if not bool((gnorm > tol) & (stp > 1e-8)):
            break
    Mf = _rotate_M(M0, U, nb_idx)
    tot, parts = spread_from_M(Mf, w_b, b_cart)
    info = {"omega": float(tot), "omega_I": float(parts["I"]),
            "omega_D": float(parts["D"]), "omega_OD": float(parts["OD"]),
            "centers": parts["centers"].cpu().numpy(),
            "n_iter": n_it, "grad_norm": float(gnorm),
            "converged": bool(gnorm <= tol), "omega_init": float(om0)}
    return U, info


def max_loc(C_k, kmesh, latt_vec, tau=None, guess=None,
            device=torch.device("cuda"), **kwargs):
    """High-level driver: projected-gauge initialization (when `guess`
    given) + MV minimization on `device`.  Returns (C_loc_k (nk, norb, nw)
    complex tensor, U (nk, nw, nw) tensor, info)."""
    C_k = _as_complex(C_k, device)
    bv = kmesh_bvectors(latt_vec, kmesh)
    M0, _ = mmn_from_C(C_k, kmesh, latt_vec, tau=tau, bv=bv, device=device)
    U0 = None
    if guess is not None:
        from libdmet_preview_tpu_torch.lo.wannier import proj_wannier
        # proj_wannier returns C U_proj; recover U_proj = C^H (C U)
        U0 = C_k.conj().transpose(-2, -1) @ proj_wannier(C_k, guess)
    U, info = max_loc_U(M0, bv, U0=U0, device=device, **kwargs)
    return C_k @ U, U, info
