"""
The port's entry points (the counterparts of the JAX package's
__graft_entry__.dmet_forward, entry and dryrun_multichip):

  dmet_forward(...)        one DMET forward step on tensors: mean field,
                           SVD bath, embedding H1, fit residual;
  entry(device)            the fused DMET lattice iteration
                           (ops/fastpath.make_dmet_iteration) on the 1D
                           Hubbard flagship, with its example arguments;
  dryrun_multichip(n, ...) the multi-rank dry run
                           (parallel/dryrun.py) in a fresh process.
"""

import json
import os
import signal
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _hubbard_fock_k(ncells, nlo, U, filling):
    """1D Hubbard ring Fock(k) as a (spin, nk, n, n) real pair (host
    NumPy): hopping -1 between neighbouring sites of the ring of ncells *
    nlo sites, plus the restricted mean-field U * filling on the
    diagonal."""
    from libdmet_preview_tpu_torch.ops.zlinalg import dft_tables
    nsites = ncells * nlo
    H = np.zeros((ncells, nlo, nlo))
    # the first cell's rows: <0 i| h |R j> of the ring's neighbours
    for a in range(nlo):
        for b in ((a + 1) % nsites, (a - 1) % nsites):
            H[b // nlo, a, b % nlo] = -1.0
    cos_t, sin_t = dft_tables((ncells,))
    f_re = np.einsum("kR, Rij -> kij", cos_t, H) + np.eye(nlo) * (U * filling)
    f_im = -np.einsum("kR, Rij -> kij", sin_t, H)
    return f_re[None], f_im[None]


def dmet_forward(f_re, f_im, vmat, rho_target, cos_t, sin_t, env_idx,
                 nelec2, beta, nval, device=torch.device("cuda")):
    """One DMET forward step on `device`.

    f_re / f_im: (spin, nk, n, n) lattice Fock (re, im) pair; vmat: (spin,
    n, n) correlation potential; rho_target: (spin, neo, neo) correlated
    embedding 1-RDM to match; cos_t / sin_t: the (nk, nR) DFT tables
    (ops.zlinalg.dft_tables); env_idx: the environment rows of the
    flattened (R, p) site index; nelec2: the electron count on the doubled
    spectrum (2x physical); beta: inverse temperature; nval: bath orbitals
    (neo = n + nval).  Arrays or tensors.

    The mean field is the Fermi density of the complex Hermitian H(k) =
    f(k) + vmat (ops.zlinalg.zrho_fermi, mu over every spin and k); the
    bath is the left singular vectors of the environment-valence block of
    rho_R; embH1 and the mean-field embedding density are
    sum_k B(k)^H X(k) B(k) / nk.  Returns (E_mf, rho_R (spin, nR, n, n),
    embH1 (spin, neo, neo), fit_err = ||rho_emb - rho_target||), tensors
    on `device`."""
    from libdmet_preview_tpu_torch.ops.zlinalg import zrho_fermi
    from libdmet_preview_tpu_torch.utils.misc import as_f64
    device = torch.device(device)
    f_re, f_im, vmat, rho_target, cos_t, sin_t = (
        as_f64(x, device)
        for x in (f_re, f_im, vmat, rho_target, cos_t, sin_t))
    env_idx = torch.as_tensor(env_idx, device=device)
    spin, nk, n, _ = f_re.shape
    h_re = f_re + vmat[:, None]
    rho_kre, rho_kim, _ = zrho_fermi(h_re, f_im, nelec2, beta)
    rho_R = (torch.einsum("kR, skpq -> sRpq", cos_t, rho_kre)
             - torch.einsum("kR, skpq -> sRpq", sin_t, rho_kim)) / nk
    E_mf = (torch.sum(h_re * rho_kre) + torch.sum(f_im * rho_kim)) / nk

    # Schmidt bath: SVD of the environment-valence block of rho_R
    nR = rho_R.shape[1]
    env = rho_R.reshape(spin, nR * n, n)[:, env_idx, :nval]
    u = torch.linalg.svd(env, full_matrices=False)[0]
    neo = n + nval
    basis = torch.zeros((spin, nR * n, neo), dtype=f_re.dtype, device=device)
    basis[:, :n, :n] = torch.eye(n, dtype=f_re.dtype, device=device)
    basis[:, env_idx, n:] = u

    # B(k) = sum_R e^{i k.R} B(R) (the tables' transpose, as in the JAX
    # package); X(k) -> sum_k B^H X B / nk
    phase = torch.complex(cos_t.T, sin_t.T)
    B = torch.einsum("kR, sRpj -> skpj", phase,
                     basis.reshape(spin, nR, n, neo).to(phase.dtype))
    Bh = B.conj().transpose(-1, -2)
    embH1 = (Bh @ torch.complex(h_re, f_im) @ B).sum(dim=1).real / nk
    rho_emb = (Bh @ torch.complex(rho_kre, rho_kim) @ B).sum(dim=1).real / nk
    fit_err = torch.linalg.norm(rho_emb - rho_target)
    return E_mf, rho_R, embH1, fit_err


def entry(device=torch.device("cuda")):
    """The fused lattice iteration (IBZ mean field -> Gram bath ->
    embedding transforms -> Levenberg-Marquardt vcor fit) on the 1D
    Hubbard flagship: ChainLattice(18, 2), U = 4, half filling, the PM
    seed vcor, beta = 1000, 20 fit steps.  Returns (step, (p0,
    rho_target)) on `device`: step(p0, rho_target) -> (p_new, fit_err,
    embH1, rho_R, basis); rho_target is half the identity on the 4
    embedding orbitals."""
    import libdmet_preview_tpu_torch.dmet.hubbard as dmet
    from libdmet_preview_tpu_torch.ops.fastpath import make_dmet_iteration
    device = torch.device(device)
    ncells, nlo, U, filling = 9, 2, 4.0, 0.5
    Lat = dmet.ChainLattice(ncells * nlo, nlo)
    Lat.set_Ham(dmet.Ham(Lat, U), use_hcore_as_emb_ham=True, device=device)
    vcor = dmet.PMInitGuess((nlo,), U, filling)
    step, p0 = make_dmet_iteration(Lat, vcor, filling, beta=1000.0,
                                   fit_max_iter=20, device=device)
    neo = 2 * nlo
    rho_target = torch.as_tensor(np.eye(neo)[None] * filling, device=device)
    return step, (p0, rho_target)


def dryrun_multichip(n_devices, backend="nccl", device=torch.device("cuda"),
                     cases=None, timeout=1800):
    """Run `python -m libdmet_preview_tpu_torch.parallel.dryrun` on
    n_devices ranks in a fresh process (NCCL: one card per rank; gloo: CPU
    tensors, or CUDA tensors with the ranks sharing the cards), with the
    kmesh cases at size `cases` when given.  Echoes its output but the
    last line; raises RuntimeError if it fails or outlasts `timeout`
    seconds.  Returns the JSON object of that last line ({"dryrun": {...,
    "ranks": [...]}})."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    cmd = [sys.executable, "-m", "libdmet_preview_tpu_torch.parallel.dryrun",
           str(int(n_devices)), "--backend", backend, "--device",
           str(torch.device(device)), "--timeout", str(max(60, timeout - 60))]
    if cases:
        cmd += ["--cases", cases]
    # a session of its own, so that a timeout ends its ranks too
    proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired as e:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise RuntimeError("multichip dryrun outlasted %d s" % timeout) \
            from e
    lines = out.strip().splitlines()
    sys.stderr.write(err)
    if proc.returncode != 0:
        sys.stdout.write(out)
        raise RuntimeError("multichip dryrun subprocess failed (rc=%d)"
                           % proc.returncode)
    # its output but the last line, which is returned
    sys.stdout.write("".join(ln + "\n" for ln in lines[:-1]))
    return json.loads(lines[-1])
