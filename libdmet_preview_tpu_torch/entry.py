"""
The port's entry points (the counterparts of the JAX package's
__graft_entry__.entry and dryrun_multichip):

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
