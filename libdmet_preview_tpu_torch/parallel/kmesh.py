"""
k-point and auxiliary-axis sharded DMET operations over torch.distributed
(PyTorch port of libdmet_preview_tpu/parallel/kmesh.py).

The JAX package shards its k loop and its density-fitting axis over a
jax.sharding.Mesh inside shard_map and reduces with lax.psum.  Here a Mesh
is a grid of torch.distributed ranks with one process group per named axis
("k", "aux"); every function takes the whole (replicated) input, works on
the rank's shard of the axis it names and reduces over that axis' group.
The ranks of the other axis hold copies.

Only all_reduce (with SUM) is used, because it is the one collective that
NCCL across cards, gloo on CPU tensors and gloo on CUDA tensors (ranks that
share one card) all support.  The JAX package's all_gather of the spectrum
becomes an all_reduce of a zero-filled (axis size, ...) buffer in which
each rank fills its own slot: adding zeros is exact, so every rank sees the
gathered values bit for bit.

Gradients: psum's backward is the identity and pvary's backward is an
all_reduce, as lax.psum and the broadcast of a replicated value transpose
under shard_map.  A loss computed identically on every rank from psum'ed
values then gives every rank the gradient of the global function, and a
replicated leaf (the vcor) fed to a k shard through pvary gets its k sum
once.
"""

import datetime

import numpy as np
import torch
import torch.distributed as dist

from libdmet_preview_tpu_torch.ops import zlinalg
from libdmet_preview_tpu_torch.ops.eri_kernels import (pack_tril, syrk_df,
                                                       unpack_s4)
from libdmet_preview_tpu_torch.ops.eri_transform import _cplx, _rotate_chol
from libdmet_preview_tpu_torch.utils import logger as log
from libdmet_preview_tpu_torch.utils.misc import as_f64, keyword_aliases

K_AXIS = "k"
AUX_AXIS = "aux"
# seconds a collective may wait before the group raises
TIMEOUT_S = 600


# ----------------------------------------------------------------------
# the mesh
# ----------------------------------------------------------------------

class Mesh(object):
    """A grid of the default group's ranks (row-major, rank = flat index)
    with one process group per named axis.

    shape / coord: {axis: size} and {axis: this rank's index}; device: the
    device this rank computes on.  An axis as large as the world uses the
    world group; an axis of size 1 on a larger world has no group and its
    reductions are the identity."""

    def __init__(self, shape, axes, device, timeout=TIMEOUT_S):
        world = dist.get_world_size()
        rank = dist.get_rank()
        shape = tuple(int(s) for s in shape)
        if len(shape) != len(axes) or int(np.prod(shape)) != world:
            raise ValueError("mesh %s over axes %s does not cover %d ranks"
                             % (shape, tuple(axes), world))
        self.axes = tuple(axes)
        self.shape = dict(zip(self.axes, shape))
        self.device = torch.device(device)
        self.rank = rank
        grid = np.arange(world).reshape(shape)
        self.coord = dict(zip(self.axes,
                              (int(c) for c in np.argwhere(grid == rank)[0])))
        self.groups = {}
        for a, ax in enumerate(self.axes):
            if shape[a] == world:
                self.groups[ax] = dist.group.WORLD
            elif shape[a] == 1:
                self.groups[ax] = None
            else:
                # every rank creates every group of the axis, in one order
                lines = np.moveaxis(grid, a, -1).reshape(-1, shape[a])
                for line in lines:
                    g = dist.new_group(
                        line.tolist(),
                        timeout=datetime.timedelta(seconds=timeout))
                    if rank in line:
                        self.groups[ax] = g

    def size(self, axis):
        return self.shape[axis]

    def index(self, axis):
        return self.coord[axis]

    def all_reduce(self, t, axis):
        """Sum `t` over the ranks of `axis`, in place; returns t.  (NCCL
        takes contiguous tensors only: a strided t goes through a
        contiguous copy.)"""
        g = self.groups[axis]
        if g is None:
            return t
        if t.is_contiguous():
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=g)
        else:
            c = t.contiguous()
            dist.all_reduce(c, op=dist.ReduceOp.SUM, group=g)
            t.copy_(c)
        return t

    def __repr__(self):
        return "Mesh(%s, rank %d at %s, %s)" % (self.shape, self.rank,
                                                 self.coord, self.device)


def make_mesh(shape=None, axes=(K_AXIS,), device=torch.device("cuda"),
              timeout=TIMEOUT_S, n_devices=None, axis=None, devices=None):
    """Mesh over the initialised default group: `shape` (default: the
    world on one axis) over the named `axes`, computing on `device`.

    The JAX package's call form make_mesh(n_devices, axis) is the 1D mesh
    shape=(n_devices,), axes=(axis,); its devices= has no counterpart,
    since a rank is a process with its own device, and raises."""
    if devices is not None:
        raise ValueError("make_mesh: devices= has no meaning here: a rank "
                         "is a process with its own device; start one "
                         "rank per device and pass device=")
    if n_devices is not None:
        if shape is not None:
            raise TypeError("make_mesh: give shape or n_devices, not both")
        shape = n_devices
    if isinstance(shape, int):
        shape = (shape,)
    if axis is not None:
        axes = (axis,)
    elif isinstance(axes, str):
        axes = (axes,)
    if shape is None:
        shape = (dist.get_world_size(),)
    return Mesh(shape, axes, device, timeout)


def mesh_shape(n):
    """The dry run's (k, aux) grid of n ranks: (n / 2, 2) for even n >= 4,
    else (n, 1)."""
    if n >= 4 and n % 2 == 0:
        return (n // 2, 2)
    return (n, 1)


# ----------------------------------------------------------------------
# shards and collectives
# ----------------------------------------------------------------------

def shard(n, mesh, axis):
    """This rank's slice of an axis of length n split evenly over `axis`
    (n must be divisible by its size, as shard_map requires)."""
    size = mesh.size(axis)
    if n % size:
        raise ValueError("an axis of %d does not split over %d ranks of %r"
                         % (n, size, axis))
    m = n // size
    return slice(mesh.index(axis) * m, (mesh.index(axis) + 1) * m)


def gather(x, mesh, axis):
    """(axis size, *x.shape): every rank's x in its slot, from one
    all_reduce of a zero-filled buffer (exact: the other slots add zeros).
    Not differentiable."""
    buf = x.new_zeros((mesh.size(axis),) + tuple(x.shape))
    buf[mesh.index(axis)] = x.detach()
    return mesh.all_reduce(buf, axis)


def gather_rows(x, mesh, axis):
    """The rows of every rank's shard x, stacked in rank order."""
    return gather(x, mesh, axis).reshape((-1,) + tuple(x.shape[1:]))


class _PSum(torch.autograd.Function):
    """Sum over an axis; the cotangent of the replicated result passes
    through unchanged (lax.psum's transpose)."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        return mesh.all_reduce(x.clone(), axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _PVary(torch.autograd.Function):
    """A replicated value used on each rank's shard; its cotangent is
    summed over the axis."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce(g.clone(), ctx.axis), None, None


def psum(x, mesh, axis=K_AXIS):
    """Differentiable sum over `axis` for a loss replicated on every rank."""
    return _PSum.apply(x, mesh, axis)


def pvary(x, mesh, axis=K_AXIS):
    """Differentiable use of a replicated tensor on this rank's shard."""
    return _PVary.apply(x, mesh, axis)


# ----------------------------------------------------------------------
# sharded differentiable Fermi density (global chemical potential)
# ----------------------------------------------------------------------

class _ZRhoFermiSharded(torch.autograd.Function):
    """ops.zlinalg._ZRhoFermi on this rank's k shard with the chemical
    potential global over the k axis: the spectrum is gathered for the
    serial grid bisection (one collective; every rank finds the same mu),
    and in the backward the two k sums of the mu feedback, sum_k sum_i
    f'_ki Re We_kii and sum_k sum_i f'_ki, are all-reduced (the JAX
    package's two psums).  w_mu, the cotangent of the replicated mu, is
    the same on every rank and is counted once."""

    @staticmethod
    def forward(ctx, h_re, h_im, nelec2, beta, mesh, axis):
        ew, V, mu, _, rho = zlinalg._zrho_eig(
            h_re, h_im, nelec2, beta, gather=lambda e: gather(e, mesh, axis))
        ctx.beta, ctx.mesh, ctx.axis = beta, mesh, axis
        ctx.save_for_backward(ew, V, mu)
        return rho.real.contiguous(), rho.imag.contiguous(), mu

    @staticmethod
    def backward(ctx, w_re, w_im, w_mu):
        ew, V, mu = ctx.saved_tensors
        g_re, g_im = zlinalg._zrho_vjp(
            ew, V, mu, ctx.beta, w_re, w_im, w_mu,
            reduce=lambda t: ctx.mesh.all_reduce(t, ctx.axis))
        return g_re, g_im, None, None, None, None


def make_zrho_fermi_sharded(mesh, nelec, beta, axis=K_AXIS):
    """Shard-aware ops.zlinalg.zrho_fermi: a function (h_re, h_im) ->
    (rho_re, rho_im, mu) of this rank's k shard (..., nk_local, n, n), with
    mu global over `axis` and the degenerate-safe backward.  nelec counts
    the doubled spectrum (twice the physical count), as in the JAX
    package."""
    nelec = float(nelec)
    beta = float(beta)

    def rho_fn(h_re, h_im):
        return _ZRhoFermiSharded.apply(h_re, h_im, nelec, beta, mesh, axis)

    return rho_fn


# ----------------------------------------------------------------------
# sharded mean field
# ----------------------------------------------------------------------

def hf_rho_sharded(mesh, f_re, f_im, kmesh, nelec2, beta, axis=K_AXIS):
    """k-sharded lattice mean field -> (rho_R, mu, nelec_check).

    f_re / f_im: (spin, nk, n, n) Fock pair (vcor added), arrays or
    tensors; kmesh: the cell mesh (prod = nk); nelec2: the electron count
    on the DOUBLED spectrum (2x physical); Fermi smearing at `beta`.  Each
    rank diagonalises its k shard once (complex eigh), the chemical
    potential is global, and one all_reduce sums rho_R = (1/nk) sum_k
    e^{+ikR} rho(k) and the count.  Returns rho_R (spin, nR, n, n), mu and
    nelec_check (on the doubled spectrum), replicated on every rank."""
    nk = f_re.shape[1]
    sl = shard(nk, mesh, axis)
    dev = mesh.device
    _, _, mu, occ, rho = zlinalg._zrho_eig(
        as_f64(f_re[:, sl], dev), as_f64(f_im[:, sl], dev), nelec2, beta,
        gather=lambda e: gather(e, mesh, axis))
    cos_t, sin_t = zlinalg.dft_tables(tuple(int(x) for x in kmesh))
    c = torch.as_tensor(cos_t[sl], device=dev)
    s = torch.as_tensor(sin_t[sl], device=dev)
    re = (torch.einsum("kR, skpq -> sRpq", c, rho.real)
          - torch.einsum("kR, skpq -> sRpq", s, rho.imag)) / nk
    out = torch.cat([re.reshape(-1), (2.0 * torch.sum(occ)).reshape(1)])
    mesh.all_reduce(out, axis)
    return out[:-1].reshape(re.shape), mu, out[-1]


# ----------------------------------------------------------------------
# sharded embedding-ERI transform (auxiliary axis)
# ----------------------------------------------------------------------

def get_emb_eri_chol_sharded(mesh, L, basis, axis=AUX_AXIS):
    """Embedding ERI from Cholesky / DF factors sharded over the auxiliary
    index: each rank rotates its rows of L into the embedding basis,
    s4-packs them and runs eri_kernels.syrk_df (on CUDA the hand-written
    symmetric kernel); the packed (npair, npair) results are all-reduced
    and unpacked.  Restricted (spin = 1) basis only; naux must divide
    evenly over `axis`.  Returns the (1, neo, neo, neo, neo) tensor."""
    spin, ncells, nlo, neo = basis.shape
    if spin != 1:
        raise ValueError("get_emb_eri_chol_sharded: restricted basis only, "
                         "got spin %d" % spin)
    dev = mesh.device
    sl = shard(L.shape[0], mesh, axis)
    C = as_f64(basis, dev).reshape(ncells * nlo, neo)
    F = pack_tril(_rotate_chol(as_f64(L[sl], dev), C))
    s4 = mesh.all_reduce(syrk_df(F), axis)
    return unpack_s4(s4, neo)[None]


# ----------------------------------------------------------------------
# sharded embedding-H1 transform
# ----------------------------------------------------------------------

def transform_h1_sharded(mesh, H1_k, basis_k, axis=K_AXIS):
    """k-sharded embedding transform (1/nk) sum_k C(k)^H H(k) C(k) of a
    1-body lattice operator.  H1_k, basis_k: (re, im) pairs shaped (spin,
    nk, n, n) and (spin, nk, n, neo).  Returns (spin, neo, neo)."""
    dev = mesh.device
    b_re, b_im = basis_k
    nk = b_re.shape[1]
    sl = shard(nk, mesh, axis)
    C = torch.complex(as_f64(b_re[:, sl], dev), as_f64(b_im[:, sl], dev))
    H = torch.complex(as_f64(H1_k[0][:, sl], dev),
                      as_f64(H1_k[1][:, sl], dev))
    out = torch.sum(C.mH @ H @ C, dim=1).real.contiguous()
    return mesh.all_reduce(out, axis) / nk


# ----------------------------------------------------------------------
# sharded global-veff rebuild (charge self-consistency)
# ----------------------------------------------------------------------

def _padded_rows(L, mesh, axis, dev):
    """This rank's rows of L with L zero-padded to a multiple of the axis
    size (a shard may be all padding)."""
    naux = L.shape[0]
    m = -(-naux // mesh.size(axis))
    lo = min(naux, mesh.index(axis) * m)
    hi = min(naux, lo + m)
    rows = as_f64(L[lo:hi], dev)
    if hi - lo < m:
        rows = torch.cat([rows, rows.new_zeros((m - (hi - lo),)
                                               + tuple(rows.shape[1:]))])
    return rows


def get_veff_from_rdm1_emb_sharded(mesh, lattice, rdm1_emb, basis,
                                   axis=AUX_AXIS):
    """Sharded ops.embham.get_veff_from_rdm1_emb: the lattice's Cholesky
    factors are split over `axis` (zero-padded to a multiple of its size:
    the contractions are additive over aux) and J and K are all-reduced.
    Returns host (veff_stripe, rho_glob_stripe), like the serial path."""
    from libdmet_preview_tpu_torch.ops.embham import get_rho_glob_R
    log.eassert(lattice.H2_format == "cholesky",
                "veff rebuild implemented for the cholesky H2 format")
    dev = mesh.device
    rho_glob = get_rho_glob_R(basis, lattice, rdm1_emb)
    spin = rho_glob.shape[0]
    rho_full = as_f64(lattice.expand(rho_glob), dev)
    # restricted: the stored per-spin density -> total
    dms = rho_full * 2.0 if spin == 1 else rho_full
    L = _padded_rows(lattice.getH2(), mesh, axis, dev)
    w = torch.einsum("xpq, sqp -> x", L, dms)
    vj = torch.einsum("x, xpq -> pq", w, L)
    vk = torch.einsum("xpr, srt, xtq -> spq", L, dms, L)
    v = mesh.all_reduce(torch.cat([vj.reshape(-1), vk.reshape(-1)]), axis)
    vj, vk = v[:vj.numel()].reshape(vj.shape), v[vj.numel():].reshape(vk.shape)
    if spin == 1:
        veff_full = (vj - 0.5 * vk[0])[None]
    else:
        veff_full = vj[None] - vk
    veff_stripe = np.asarray(lattice.extract_stripe(veff_full.cpu().numpy()))
    return veff_stripe, rho_glob


# ----------------------------------------------------------------------
# sharded CCSD (t2 / R2 / DIIS history split over the leading occupied
# index)
# ----------------------------------------------------------------------

@keyword_aliases(t2_local="t2")
def ccsd_residual_sharded(mesh, t1, t2, h_so, W, nocc, axis=K_AXIS):
    """CCSD (R1, R2_local) for t2 sharded over its leading occupied index.

    t2: this rank's rows (nocc / size, nocc, nvir, nvir) of t2 (nocc must
    divide evenly over `axis`; the keyword t2_local= is taken too), or the
    whole t2 (nocc, nocc, nvir, nvir), as the JAX package's callers pass
    it, whose rows for this rank are then taken.  The intermediates are
    formed from the t2 assembled by one all_reduce; the rank keeps its own
    rows of R2.  t1, h_so and W are replicated."""
    if nocc % mesh.size(axis):
        raise ValueError("ccsd_residual_sharded: nocc %d does not split "
                         "over %d ranks" % (nocc, mesh.size(axis)))
    t2_local = t2[shard(nocc, mesh, axis)] if t2.shape[0] == nocc else t2
    if t2_local.shape[0] != nocc // mesh.size(axis):
        raise ValueError("ccsd_residual_sharded: t2_local has %d rows, "
                         "not nocc / %d" % (t2_local.shape[0],
                                            mesh.size(axis)))
    from libdmet_preview_tpu_torch.solvers.cc import _residual
    dev = mesh.device
    t2_all = gather_rows(as_f64(t2_local, dev), mesh, axis)
    R1, R2 = _residual(as_f64(t1, dev), t2_all, as_f64(h_so, dev),
                       as_f64(W, dev), nocc)
    return R1, R2[shard(nocc, mesh, axis)].contiguous()


def ccsd_solve_sharded(mesh, h_so, W, nocc, tol=1e-9, max_cycle=100,
                       diis_space=8, axis=K_AXIS):
    """The whole CCSD amplitude solve with t2, R2 and the DIIS history of
    t2 sharded over the leading occupied index (the fixed point
    t <- t + R / D with Pulay DIIS, as the JAX package's).  Each B-matrix
    row is the replicated t1 dot products plus the local t2 dot products,
    summed by one all_reduce that also carries each rank's max |R2|.

    Returns (t1, t2_local, e_corr, converged).  ccsd_solve_sharded.last
    holds the iterations, the final max |R| and the set of t2_local shapes
    seen in the iterations of the latest call."""
    from libdmet_preview_tpu_torch.solvers.cc import _denominators, _ecorr
    dev = mesh.device
    size = mesh.size(axis)
    with torch.no_grad():
        h_so = as_f64(h_so, dev)
        W = as_f64(W, dev)
        rows = shard(nocc, mesh, axis)
        D1, D2 = _denominators(h_so, W, nocc)
        D2 = D2[rows]
        nvir = h_so.shape[0] - nocc
        t1 = torch.zeros((nocc, nvir), dtype=h_so.dtype, device=dev)
        t2 = W[:nocc, :nocc, nocc:, nocc:][rows] / D2
        hist_t, hist_e = [], []
        B = np.zeros((0, 0))
        shapes = set()
        conv = False
        rnorm = float("inf")
        it = -1
        for it in range(max_cycle):
            shapes.add(tuple(t2.shape))
            R1, R2 = ccsd_residual_sharded(mesh, t1, t2, h_so, W, nocc, axis)
            s1, s2 = R1 / D1, R2 / D2
            hist_t.append((t1 + s1, t2 + s2))
            hist_e.append((s1, s2))
            if len(hist_t) > diis_space:
                hist_t.pop(0)
                hist_e.pop(0)
                B = B[1:, 1:]
            m = len(hist_e)
            d1 = torch.stack([torch.sum(e[0] * s1) for e in hist_e])
            d2 = torch.stack([torch.sum(e[1] * s2) for e in hist_e])
            rmax = torch.zeros(size, dtype=R2.dtype, device=dev)
            rmax[mesh.index(axis)] = torch.max(torch.abs(R2))
            red = mesh.all_reduce(torch.cat([d2, rmax]), axis)
            read = torch.cat([d1 + red[:m], torch.max(torch.abs(R1))[None],
                              torch.max(red[m:])[None]]).cpu().numpy()
            rnorm = float(read[m] + read[m + 1])
            Bn = np.empty((m, m))
            Bn[:m - 1, :m - 1] = B
            Bn[m - 1, :] = Bn[:, m - 1] = read[:m]
            B = Bn
            if m > 1:
                A = np.empty((m + 1, m + 1))
                A[:m, :m] = B
                A[m, :m] = A[:m, m] = -1.0
                A[m, m] = 0.0
                rhs = np.zeros(m + 1)
                rhs[m] = -1.0
                try:
                    c = np.linalg.solve(A, rhs)[:m]
                except np.linalg.LinAlgError:
                    c = np.zeros(m)
                    c[-1] = 1.0
                t1 = sum(float(ci) * h[0] for ci, h in zip(c, hist_t))
                t2 = sum(float(ci) * h[1] for ci, h in zip(c, hist_t))
            else:
                t1, t2 = hist_t[0]
            if rnorm < tol:
                conv = True
                break
        e_corr = float(_ecorr(t1, gather_rows(t2, mesh, axis), h_so, W,
                              nocc))
    if not conv:
        log.warn("sharded CCSD amplitudes not converged: max|R| = %.3e",
                 rnorm)
    ccsd_solve_sharded.last = {"iterations": it + 1, "max|R|": rnorm,
                               "converged": conv, "t2_local_shapes": shapes}
    return t1, t2, e_corr, conv


ccsd_solve_sharded.last = None


# ----------------------------------------------------------------------
# transfer-sharded k-resolved GDF embedding-ERI transform
# ----------------------------------------------------------------------

def get_emb_eri_gdf_sharded(mesh, factors, basis_k, ncells, nlo,
                            axis=AUX_AXIS, tr_symm=False):
    """Sharded ops.eri_transform.get_emb_eri_gdf: the momentum transfers
    (each with its weight: 1, or 2 for a transfer and its time-reversed
    partner under tr_symm) are split over `axis`, padded to a multiple of
    its size with weight-0 transfers whose factors are zero and whose
    rolled basis is C itself; every factor is zero-padded to the largest
    rank.  Each rank contracts its transfers; the ERI is all-reduced.
    Returns the real (1, neo, neo, neo, neo) tensor."""
    dev = mesh.device
    C = torch.complex(as_f64(basis_k[0], dev)[0], as_f64(basis_k[1], dev)[0])
    neo = C.shape[-1]
    if tr_symm:
        items = [(q, f, 2.0 if (ncells - q) % ncells != q else 1.0)
                 for q, f in factors.items()
                 if q <= (ncells - q) % ncells]
    else:
        items = [(q, f, 1.0) for q, f in factors.items()]
    naux_max = max(int(f[0].shape[-1]) for _, f, _ in items)
    size = mesh.size(axis)
    m = -(-len(items) // size)
    first = mesh.index(axis) * m
    F = torch.zeros((m, ncells, nlo, nlo, naux_max), dtype=torch.complex128,
                    device=dev)
    qs = [0] * m
    w = torch.zeros(m, dtype=torch.float64, device=dev)
    for i, (q, f, wq) in enumerate(items[first:first + m]):
        F[i, ..., :f[0].shape[-1]] = _cplx(f, dev)
        qs[i] = q
        w[i] = wq
    k = torch.arange(ncells, device=dev)
    qv = torch.as_tensor(qs, device=dev)
    Cq = C[(k[None, :] + qv[:, None]) % ncells]        # C(k + q); C if pad
    Cc = C.conj()
    G = torch.einsum("qkpax, kpi, qkaj -> qxij", F, Cc, Cq)
    H = torch.einsum("qksrx, qkrm, ksl -> qxml", F, Cq, Cc)
    G = (G * w[:, None, None, None]).reshape(-1, neo * neo)
    H = H.reshape(-1, neo * neo)
    eri = torch.cat([G.real, G.imag]).T @ torch.cat([H.real, H.imag])
    mesh.all_reduce(eri, axis)
    return eri.reshape((1,) + (neo,) * 4) / ncells ** 2
