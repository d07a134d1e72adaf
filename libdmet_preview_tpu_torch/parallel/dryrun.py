"""
Multi-rank dry run: one DMET iteration with the sharded operations of
parallel.kmesh on a (k, aux) grid of torch.distributed ranks (PyTorch port
of libdmet_preview_tpu/parallel/dryrun.py).

    python -m libdmet_preview_tpu_torch.parallel.dryrun N \
        [--backend nccl|gloo] [--device cuda|cpu] [--cases tier1|card]

starts N ranks (one process each, joined by a TCP store on localhost).
With N >= 4 and even the grid is (N / 2) x 2 over (k, aux), else N x 1.
NCCL needs a card per rank; gloo runs on CPU tensors, or on CUDA tensors
with the ranks sharing the cards.  Nothing switches backend by itself.

The iteration mirrors the JAX package's six stages:

  1. lattice mean field        -> kmesh.hf_rho_sharded        (k axis)
  2. Schmidt bath              -> embham.embBasis (replicated; small)
  3. embedding H1 transform    -> kmesh.transform_h1_sharded  (k axis)
  4. embedding ERI             -> kmesh.get_emb_eri_chol_sharded (aux axis,
     on the Cholesky factors of the 4-cell sto-6g H ring)
  5. FCI impurity solve + mu fit + energy (replicated)
  6. the vcor fit gradient through kmesh.make_zrho_fermi_sharded -> one
     update

and holds each sharded result to the serial port path at 1e-8.  --cases
also runs workloads.kmesh_cases on every rank at that size.  The last line
printed is a JSON object with every rank's results.
"""

import argparse
import datetime
import json
import os
import queue
import socket
import sys
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from libdmet_preview_tpu_torch.parallel import kmesh

# seconds the parent waits for its ranks
SPAWN_TIMEOUT_S = 1200


def _check(name, err, tol):
    if not err <= tol:
        raise AssertionError("sharded %s deviates from the serial path: "
                             "%.3e > %.0e" % (name, err, tol))


def dmet_iteration(mesh):
    """One DMET iteration on `mesh` (axes "k" and "aux"), every sharded
    stage against the serial port path on the rank's device.  Returns a
    dict of host floats (energies, errors) with the symmetric syrk
    launches of the sharded ERI call."""
    import libdmet_preview_tpu_torch.dmet.hubbard as dmet
    from libdmet_preview_tpu_torch.ints.gto import h_ring_mole
    from libdmet_preview_tpu_torch.models.abinitio import make_h_ring_lattice
    from libdmet_preview_tpu_torch.ops import embham, mfd
    from libdmet_preview_tpu_torch.ops.eri_kernels import syrk_df
    from libdmet_preview_tpu_torch.ops.eri_transform import get_emb_eri_chol
    from libdmet_preview_tpu_torch.ops.zlinalg import dft_tables
    from libdmet_preview_tpu_torch.solvers import FCI
    dev = mesh.device
    k_size = mesh.size("k")

    # ---- lattice: 1D Hubbard, 2-site impurity, nk = 2 * k_size cells ----
    U, Filling, beta = 4.0, 0.5, 1000.0
    nlo = 2
    ncells = 2 * k_size
    nsites = ncells * nlo
    Lat = dmet.ChainLattice(nsites, nlo)
    Lat.set_Ham(dmet.Ham(Lat, U), use_hcore_as_emb_ham=True, device=dev)
    vcor = dmet.PMInitGuess((nlo,), U, Filling)

    # ---- 1. sharded lattice mean field (vs serial mfd.HF) ----
    f_re, f_im = (np.asarray(x) for x in Lat.getFock(kspace=True))
    if f_re.ndim == 3:
        f_re, f_im = f_re[None], f_im[None]
    vmat = np.asarray(vcor.get())[:1]
    h_re = f_re + vmat[:, None]
    # occupation count on the DOUBLED spectrum (restricted: 2 x filling)
    nelec2 = int(round(2 * nsites * Filling))
    rho_R, mu, nchk = kmesh.hf_rho_sharded(mesh, h_re, f_im, (ncells,),
                                           nelec2, beta)
    _check("electron count", abs(float(nchk) - nelec2), 1e-6)
    rho_serial, mu_serial, E_serial = mfd.HF(Lat, vcor, Filling, True,
                                             beta=beta)
    rho_R = rho_R.cpu().numpy()
    err_mf = float(np.max(np.abs(rho_R - np.asarray(rho_serial))))
    _check("mean field", err_mf, 1e-8)

    # ---- 2. Schmidt bath (small; replicated) ----
    basis = embham.embBasis(Lat, rho_R)
    spin = basis.shape[0]
    basis_k = Lat.R2k_basis(basis)

    # ---- 3. sharded embedding-H1 transform (vs serial) ----
    H1_k = (np.broadcast_to(h_re, (spin,) + h_re.shape[1:]),
            np.broadcast_to(f_im, (spin,) + f_im.shape[1:]))
    embH1_sh = kmesh.transform_h1_sharded(mesh, H1_k, basis_k)
    embH1_serial = embham.transform_h1(H1_k, basis_k)
    err_h1 = float(torch.max(torch.abs(embH1_sh - embH1_serial.to(dev))))
    _check("embedding H1", err_h1, 1e-8)

    # ---- 4. sharded embedding ERI on the Cholesky factors of an ab initio
    # H ring (full rank, non-diagonal) with its own Schmidt bath ----
    Lat_ai, meta_ai = make_h_ring_lattice(h_ring_mole(8, 1.8, "sto-6g"),
                                          ncells=4, device=dev)
    rho_ai, _mu_ai = dmet.RHartreeFock(Lat_ai, dmet.PMInitGuess(
        (Lat_ai.nscsites,), 0.0, 0.5), 0.5, None)
    basis_ai = embham.embBasis(Lat_ai, np.asarray(rho_ai))
    L_ai = Lat_ai.getH2()
    syrk_df.launches = 0
    eri_sh = kmesh.get_emb_eri_chol_sharded(mesh, L_ai, basis_ai[:1])
    eri_launches = syrk_df.launches
    eri_serial = get_emb_eri_chol(L_ai, basis_ai[:1])
    err_eri = float(torch.max(torch.abs(eri_sh - eri_serial.to(dev))))
    _check("embedding ERI", err_eri, 1e-8)
    if dev.type == "cuda" and eri_launches != 1:
        raise AssertionError("sharded ERI: %d symmetric syrk launches on the "
                             "card, want 1" % eri_launches)

    # ---- 5. impurity solve + mu fit + energy (replicated) ----
    ImpHam, H1e, basis = dmet.ConstructImpHam(Lat, rho_R, vcor,
                                              matching=False,
                                              int_bath=False)
    solver = FCI(restricted=True, tol=1e-10, device=dev)
    mu_solver = dmet.MuSolver(adaptive=True)
    solver_args = {"nelec": (Lat.ncore + Lat.nval) * 2}
    rhoEmb, EnergyEmb, ImpHam, dmu = mu_solver(Lat, Filling, ImpHam, basis,
                                               solver, solver_args)
    rhoImp, EnergyImp, nelecImp = dmet.transformResults(
        rhoEmb, EnergyEmb, basis, ImpHam, H1e, lattice=Lat, last_dmu=dmu,
        int_bath=False)

    # ---- 6. vcor fit gradient through the sharded Fermi-density op ----
    cos_t, sin_t = dft_tables((ncells,))
    b = torch.as_tensor(np.asarray(basis.cpu()), device=dev)
    b_re = torch.einsum("kR, sRpj -> skpj",
                        torch.as_tensor(cos_t.T, device=dev), b)
    b_im = torch.einsum("kR, sRpj -> skpj",
                        torch.as_tensor(sin_t.T, device=dev), b)
    target = torch.as_tensor(np.asarray(rhoEmb[:1].cpu()), device=dev)
    fit_err, g = fit_loss_and_grad(mesh, f_re, f_im, vmat, b_re, b_im,
                                   target, nelec2, beta)
    vmat_new = vmat - 0.05 * g
    if not np.all(np.isfinite(vmat_new)):
        raise AssertionError("non-finite vcor update")
    return {"mesh": [mesh.size("k"), mesh.size("aux")],
            "E_mf": float(E_serial), "E_imp": float(EnergyImp),
            "nelec_imp": float(nelecImp), "fit_err": fit_err,
            "grad_norm": float(np.linalg.norm(g)),
            "err_mf": err_mf, "err_h1": err_h1, "err_eri": err_eri,
            "eri_launches": eri_launches}


def fit_loss_and_grad(mesh, f_re, f_im, vmat, b_re, b_im, target, nelec2,
                      beta):
    """The dry run's fit residual sum((rho_emb(v) - target)^2) and its
    gradient in v on every rank: h(k) = f(k) + v on the rank's k shard,
    rho(k) from the sharded Fermi-density op, rho_emb = (1/nk) sum_k
    C(k)^H rho(k) C(k) summed over the k axis.

    f_re / f_im: (1, nk, n, n); vmat: (1, n, n); b_re / b_im: (spin, nk, n,
    neo) basis in k space; target: (1, neo, neo).  Returns (float, array
    like vmat)."""
    dev = mesh.device
    nk = f_re.shape[1]
    sl = kmesh.shard(nk, mesh, "k")
    zrho = kmesh.make_zrho_fermi_sharded(mesh, nelec2, beta, axis="k")
    v = torch.as_tensor(np.asarray(vmat, dtype=np.float64),
                        device=dev).requires_grad_(True)
    h_re = torch.as_tensor(np.ascontiguousarray(f_re[:, sl]), device=dev) \
        + kmesh.pvary(v, mesh, "k")[:, None]
    h_im = torch.as_tensor(np.ascontiguousarray(f_im[:, sl]), device=dev)
    r_re, r_im, _ = zrho(h_re, h_im)
    br, bi = b_re[:, sl], b_im[:, sl]
    ein = torch.einsum
    loc = (ein("skpi, skpq, skqj -> sij", br, r_re, br)
           + ein("skpi, skpq, skqj -> sij", bi, r_re, bi)
           + ein("skpi, skpq, skqj -> sij", bi, r_im, br)
           - ein("skpi, skpq, skqj -> sij", br, r_im, bi)) / nk
    rho_emb = kmesh.psum(loc, mesh, "k")
    loss = torch.sum((rho_emb - target) ** 2)
    (g,) = torch.autograd.grad(loss, v)
    return float(loss.detach()), g.cpu().numpy()


# ----------------------------------------------------------------------
# ranks
# ----------------------------------------------------------------------

def _free_port():
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def rank_device(rank, backend, device):
    """The device of `rank`: its own card under NCCL, the cards shared in
    turn under gloo with CUDA tensors, else the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        if backend == "nccl":
            return torch.device("cuda", rank)
        return torch.device("cuda", rank % torch.cuda.device_count())
    return device


def _rank_main(fn, rank, n, backend, device, port, timeout, args, results):
    try:
        # small host work per rank; a pool of intra-op threads per rank
        # would only contend for the shared cores
        torch.set_num_threads(1)
        dev = rank_device(rank, backend, device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(
            backend, init_method="tcp://localhost:%d" % port, rank=rank,
            world_size=n, timeout=datetime.timedelta(seconds=timeout))
        mesh = kmesh.make_mesh(kmesh.mesh_shape(n), ("k", "aux"), dev,
                               timeout)
        out = fn(mesh, *args)
        dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        # a rank that failed leaves its peers waiting in a collective: its
        # group is not destroyed, the parent ends them
        results.close()
        results.join_thread()
        os._exit(1)


def spawn(fn, n, args=(), backend="nccl", device=torch.device("cuda"),
          timeout=SPAWN_TIMEOUT_S):
    """Run fn(mesh, *args) on n ranks, each a fresh process, on the dry
    run's (k, aux) grid; returns the n results in rank order.

    fn and args are pickled (fn by import path).  backend "nccl" needs a
    card per rank and raises otherwise; "gloo" runs on CPU tensors or on
    CUDA tensors, the ranks sharing the cards.  The kernel library is
    built here first, so that the ranks load it.  Each rank runs PyTorch's
    CPU work on one thread.  A rank that raises, a rank that dies and a run
    past `timeout` seconds end every rank and raise RuntimeError."""
    import multiprocessing as mp
    device = torch.device(device)
    if backend not in ("nccl", "gloo"):
        raise ValueError("unknown backend %r" % backend)
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError("the NCCL backend needs CUDA tensors")
        if n > torch.cuda.device_count():
            raise ValueError("NCCL refuses two ranks on one card: %d ranks, "
                             "%d cards (use backend='gloo' to share them)"
                             % (n, torch.cuda.device_count()))
    if device.type == "cuda":
        from libdmet_preview_tpu_torch.ops import _build
        _build.build("syrk_df")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, n, backend, str(device), port,
                               timeout, args, results), daemon=True)
             for r in range(n)]
    for p in procs:
        p.start()
    got, failed = {}, []
    deadline = time.monotonic() + timeout
    try:
        while len(got) < n and not failed:
            left = deadline - time.monotonic()
            if left <= 0:
                failed.append("timed out after %d s" % timeout)
                break
            try:
                rank, ok, out = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in got]
                if dead:
                    # give its message a moment to arrive
                    try:
                        rank, ok, out = results.get(timeout=5.0)
                    except queue.Empty:
                        failed.append("rank(s) %s died with exit codes %s"
                                      % (dead, [procs[r].exitcode
                                                for r in dead]))
                        break
                else:
                    continue
            if ok:
                got[rank] = out
            else:
                failed.append("rank %d:\n%s" % (rank, out))
        for p in procs:
            p.join(timeout=30.0 if not failed else 1.0)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10.0)
    if failed:
        raise RuntimeError("%d-rank %s run failed: %s"
                           % (n, backend, "\n".join(failed)))
    return [got[r] for r in range(n)]


def _rank_run(mesh, cases, keep=False):
    """A rank's share of main(): the dry-run iteration, then, when asked,
    the kmesh cases at that size with the rank's syrk_df launches (and the
    sharded results as host arrays, keep=True)."""
    out = {"rank": mesh.rank, "device": str(mesh.device),
           "iteration": dmet_iteration(mesh)}
    if cases:
        from libdmet_preview_tpu_torch import workloads
        out["cases"] = workloads.kmesh_cases(mesh, cases, keep=keep)
    return out


def run_dmet_iteration_sharded(n_devices, backend="nccl",
                               device=torch.device("cuda"), cases=None,
                               timeout=SPAWN_TIMEOUT_S):
    """One DMET iteration on n_devices ranks (see the module docstring);
    returns every rank's result dict, in rank order."""
    from libdmet_preview_tpu_torch.ints import native
    # the H ring's integrals need the native core: build it once here
    native.get_lib()
    return spawn(_rank_run, n_devices, (cases,), backend=backend,
                 device=device, timeout=timeout)


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m libdmet_preview_tpu_torch.parallel.dryrun")
    ap.add_argument("n", type=int, nargs="?", default=8)
    ap.add_argument("--backend", default="nccl", choices=("nccl", "gloo"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--cases", default=None, choices=("tier1", "card"))
    ap.add_argument("--timeout", type=float, default=SPAWN_TIMEOUT_S)
    a = ap.parse_args(argv)
    t0 = time.perf_counter()
    ranks = run_dmet_iteration_sharded(a.n, a.backend, a.device, a.cases,
                                       a.timeout)
    res = ranks[0]["iteration"]
    print("dryrun_multichip(%d, %s on %s): mesh=%dx%d E_mf=%.8f E_imp=%.8f "
          "fit_err=%.3e  (mf|h1|eri dev: %.1e %.1e %.1e) OK in %.1f s"
          % (a.n, a.backend, a.device, res["mesh"][0], res["mesh"][1],
             res["E_mf"], res["E_imp"], res["fit_err"], res["err_mf"],
             res["err_h1"], res["err_eri"], time.perf_counter() - t0))
    print(json.dumps({"dryrun": {"n": a.n, "backend": a.backend,
                                 "device": a.device, "ranks": ranks}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
