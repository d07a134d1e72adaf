"""
Orbital localization by metric maximization over orthogonal rotations
(PyTorch port of libdmet_preview_tpu/lo/localize.py: Pipek-Mezey / IBO
with IAO charges, Edmiston-Ruedenberg).

One generic maximizer: the rotation is C exp(K) with K antisymmetric,
the metric is a torch function on the device, torch.autograd gives its
gradient through torch.linalg.matrix_exp, and scipy's BFGS steps on the
host (one device-to-host read of the value and gradient per evaluation).
"""

import numpy as np
import scipy.linalg as sla
import torch

from libdmet_preview_tpu_torch.utils.misc import as_f64


def _maximize_rotation(C0, metric_fn, tol=1e-9, maxiter=2000, seed=7,
                       n_start=1):
    """Maximize metric_fn(C0 @ exp(K)) over antisymmetric K; C0 a float64
    tensor on the metric's device.

    n_start > 1 runs a pool of random starting rotations and keeps the
    best maximum -- localization landscapes have spurious stationary
    points.  Returns (C_loc tensor, metric)."""
    from scipy.optimize import minimize as sp_minimize
    nmo = C0.shape[1]
    tri = torch.tril_indices(nmo, nmo, -1, device=C0.device)
    nrot = tri.shape[1]

    def unpack(p):
        K = torch.zeros((nmo, nmo), dtype=C0.dtype, device=C0.device)
        K = K.index_put((tri[0], tri[1]), p)
        return K - K.T

    def fun(p):
        pt = torch.tensor(p, dtype=C0.dtype, device=C0.device,
                          requires_grad=True)
        val = -metric_fn(C0 @ torch.linalg.matrix_exp(unpack(pt)))
        g, = torch.autograd.grad(val, pt)
        return float(val.detach()), g.cpu().numpy()

    rng = np.random.RandomState(seed)
    best = None
    for trial in range(max(1, int(n_start))):
        scale = 1e-3 if trial == 0 else 0.5
        x0 = rng.randn(nrot) * scale
        res = sp_minimize(fun, x0, jac=True, method="BFGS",
                          options={"gtol": tol, "maxiter": maxiter})
        if best is None or res.fun < best.fun:
            best = res
    K = unpack(torch.as_tensor(best.x, dtype=C0.dtype, device=C0.device))
    U = torch.as_tensor(sla.expm(K.cpu().numpy()), device=C0.device)
    return C0 @ U, -float(best.fun)


def pm_metric(C, ao_slices, S=None, power=2):
    """Pipek-Mezey metric sum_{i,A} Q_A(i)^power with Mulliken charges.

    ao_slices: list of AO index arrays per atom/fragment.  For an
    orthonormal (Lowdin/IAO) basis S = None -> Q_A(i) = sum_{mu in A}
    C_mu_i^2, which is the IBO construction when C is expressed in IAOs."""
    total = 0.0
    SC = None if S is None else as_f64(S, C.device) @ C
    for A in ao_slices:
        idx = torch.as_tensor(np.asarray(A), dtype=torch.long,
                              device=C.device)
        if S is None:
            Q = torch.sum(C[idx] ** 2, dim=0)
        else:
            Q = torch.sum(C[idx] * SC[idx], dim=0)
        total = total + torch.sum(Q ** power)
    return total


def er_metric(C, eri):
    """Edmiston-Ruedenberg metric sum_i (ii|ii)."""
    eri = as_f64(eri, C.device)
    n = C.shape[0]
    # D[pq, i] = C_pi C_qi; sum_i D_i^T (pq|rs) D_i: one GEMM and a sum
    D = (C[:, None, :] * C[None, :, :]).reshape(n * n, -1)
    return torch.sum(D * (eri.reshape(n * n, n * n) @ D))


def ibo_metric(C, C_iao, S, atom_slices, power=4):
    """IBO metric: PM charges computed from IAO populations, quartic power
    (Knizia's IBO choice).

    C: (nao, nmo) occupied MOs; C_iao: (nao, niao) S-orthonormal IAOs;
    atom_slices: list of (start, stop) IAO index ranges per atom."""
    proj = as_f64(C_iao, C.device).T @ as_f64(S, C.device) @ C
    val = 0.0
    for (a, b) in atom_slices:
        Q = torch.sum(proj[a:b] ** 2, dim=0)
        val = val + torch.sum(Q ** power)
    return val


def localize_pm(C_occ, ao_slices, S=None, device=torch.device("cuda"),
                **kwargs):
    """Pipek-Mezey (or IBO when the basis is IAO) localization of the
    occupied orbitals on `device`.  Returns (C_loc tensor, metric)."""
    return _maximize_rotation(as_f64(C_occ, device),
                              lambda C: pm_metric(C, ao_slices, S=S),
                              **kwargs)


def localize_er(C_occ, eri, device=torch.device("cuda"), **kwargs):
    """Edmiston-Ruedenberg localization on `device`.  Returns (C_loc
    tensor, metric)."""
    eri = as_f64(eri, device)
    return _maximize_rotation(as_f64(C_occ, device),
                              lambda C: er_metric(C, eri), **kwargs)


def localize_ibo(C_occ, C_iao, S, atom_slices, device=torch.device("cuda"),
                 **kwargs):
    """Intrinsic bond orbitals: maximize the quartic IAO-charge metric
    over orthogonal rotations of the occupied space, on `device`."""
    C_iao, S = as_f64(C_iao, device), as_f64(S, device)
    return _maximize_rotation(
        as_f64(C_occ, device),
        lambda C: ibo_metric(C, C_iao, S, atom_slices), **kwargs)
