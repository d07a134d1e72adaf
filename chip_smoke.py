#!/usr/bin/env python3
"""
Smoke run of the PyTorch port (libdmet_preview_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the process exits non-zero:

  1. device: require CUDA; print the card's name and power limit as
     nvidia-smi reports them;
  2. build: compile every hand-written kernel from the sources in the
     checkout (nvcc, sm_90a) into build/kernels/;
  3. kernels against their plain versions on the card: syrk_df vs F^T F at
     (naux, neo) = (512, 32), (300, 45), (7, 2); 1e-12 relative, exactly
     symmetric; times of both at (512, 32) and (1024, 96);
  4. the main path at the bench workload (Nk=27, nlo=16, neo=32,
     naux=512, beta=1000, 20 LM fit steps; inputs made with NumPy from the
     same seeds as bench.py): one step on the card against the same step
     on the CPU, then 10 chained iterations on the card, counting kernel
     launches;
  5. the 1D Hubbard flagship (ChainLattice(18, 2), U=4, PMInitGuess): one
     step on the card against the CPU.

The line before the last is a JSON summary of the kernels; the last line
is {"ok": true, "device": {...}}.
"""

import json
import subprocess
import time

import numpy as np
import torch

# bench workload (bench.py): Nk=27 k-points, 16 local orbitals per cell,
# 16 valence -> embedding dim 32, DF rank 512
NK = 27
NLO = 16
NVAL = NLO
NEO = NLO + NVAL
BETA = 1000.0
FILLING = 0.5
N_FIT_STEPS = 20
NAUX = 512
N_CHAIN = 10

KERNEL_SHAPES = [(512, 32), (300, 45), (7, 2)]
TIMING_SHAPES = [(512, 32), (1024, 96)]

# gauge-invariant CUDA-vs-CPU tolerances of the main path
TOL = {"rho_R": 1e-8, "bath projector": 1e-8, "embH1 spectrum": 1e-8,
       "p": 1e-7, "err": 1e-9, "eri_emb (mapped, rel)": 1e-8}


def phase_device():
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke needs a CUDA device; "
                           "torch.cuda.is_available() is False")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60,
                         check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print("torch %s, CUDA %s, %d device(s)"
          % (torch.__version__, torch.version.cuda, torch.cuda.device_count()))
    return torch.device("cuda", 0), card


def phase_build():
    from libdmet_preview_tpu_torch.ops import _build
    path, seconds, log = _build.build("syrk_df")
    print("build syrk_df: %.2f s -> %s" % (seconds, path.name))
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            print("  ptxas: " + line.strip())


def _packed_factors(naux, neo, seed, device):
    from libdmet_preview_tpu_torch.ops.eri_kernels import pack_tril
    rng = np.random.RandomState(seed)
    L = rng.randn(naux, neo, neo)
    L = 0.5 * (L + L.transpose(0, 2, 1)) * 0.3
    return pack_tril(torch.as_tensor(L, device=device))


def _time_ms(fn, reps=20):
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def phase_kernels(device):
    from libdmet_preview_tpu_torch.ops.eri_kernels import (syrk_df,
                                                           syrk_df_plain)
    max_abs = 0.0
    for naux, neo in KERNEL_SHAPES:
        F = _packed_factors(naux, neo, seed=neo, device=device)
        out = syrk_df(F)
        torch.cuda.synchronize()
        ref = syrk_df_plain(F)
        err = torch.max(torch.abs(out - ref)).item()
        rel = err / torch.max(torch.abs(ref)).item()
        sym = torch.equal(out, out.T)
        print("syrk_df (naux=%d, neo=%d, npair=%d): max_abs_err %.3e "
              "rel %.3e symmetric=%s" % (naux, neo, F.shape[1], err, rel, sym))
        if not (rel <= 1e-12 and sym):
            raise AssertionError("syrk_df disagrees with F^T F at (%d, %d)"
                                 % (naux, neo))
        max_abs = max(max_abs, err)
    times = {}
    for naux, neo in TIMING_SHAPES:
        F = _packed_factors(naux, neo, seed=1, device=device)
        # alternate plain, kernel, kernel, plain
        tp = [_time_ms(lambda: syrk_df_plain(F))]
        tk = [_time_ms(lambda: syrk_df(F)), _time_ms(lambda: syrk_df(F))]
        tp.append(_time_ms(lambda: syrk_df_plain(F)))
        times[(naux, neo)] = (float(np.mean(tk)), float(np.mean(tp)))
        flop = naux * F.shape[1] * (F.shape[1] + 1)   # lower triangle
        print("syrk_df timing (naux=%d, neo=%d): kernel %.4f ms "
              "(%.2f TFLOP/s on the triangle), plain F.T@F %.4f ms"
              % (naux, neo, times[(naux, neo)][0],
                 flop / times[(naux, neo)][0] * 1e-9, times[(naux, neo)][1]))
    return max_abs, times


# ----------------------------------------------------------------------
# bench workload (bench.py make_lattice / _VcorFixed, same NumPy seeds)
# ----------------------------------------------------------------------

class _Ham:
    H2_format = "local"

    def __init__(self, h_R):
        self.h_R = h_R

    def getH1(self):
        return self.h_R

    def getFock(self):
        return self.h_R

    def getH2(self):
        return np.zeros((NLO,) * 4)

    def getH0(self):
        return 0.0


class _VcorFixed:
    """Restricted local vcor with one parameter per lower-triangle entry
    of a symmetric NLO x NLO matrix (bench.py's parametrization)."""

    restricted = True

    def __init__(self, vmat):
        self._tri = np.tril_indices(NLO)
        self.param = np.asarray(vmat[0][self._tri])

    def islocal(self):
        return True

    def gradient(self):
        g = np.zeros((len(self.param), 1, NLO, NLO))
        for P, (i, j) in enumerate(zip(*self._tri)):
            g[P, 0, i, j] = 1.0
            g[P, 0, j, i] = 1.0
        return g


def make_bench_workload(seed=0):
    from libdmet_preview_tpu_torch.models.lattice import ChainLattice
    rng = np.random.RandomState(seed)
    h_R = rng.randn(NK, NLO, NLO) * 0.2
    h_R[0] = (h_R[0] + h_R[0].T) / 2
    for R in range(1, NK // 2 + 1):
        h_R[(-R) % NK] = h_R[R].T
    Lat = ChainLattice(NK * NLO, NLO)
    Lat.set_Ham_model(_Ham(h_R))
    vmat = rng.randn(1, NLO, NLO) * 0.05
    vmat = (vmat + vmat.transpose(0, 2, 1)) / 2
    rho_t = np.tile(np.eye(NEO)[None] * FILLING, (1, 1, 1))
    nsites = NK * NLO
    L = rng.randn(NAUX, nsites, nsites) * 0.02
    L = 0.5 * (L + L.transpose(0, 2, 1))
    return Lat, _VcorFixed(vmat), rho_t, L


def bench_target(embH1_p):
    """bench.py's correlated target: the beta=1000 density of embH1 at a
    perturbed vcor, occupied up to the median level."""
    w, V = np.linalg.eigh(embH1_p)
    occ = 1.0 / (np.exp(np.clip(BETA * (w - np.median(w)), -100, 100)) + 1)
    return np.einsum("spi, si, sqi -> spq", V, occ, V)


def target_in_fit_basis(step, p0, dp, placeholder, make_target):
    """The fit target built at p0 + dp, carried from that step's bath
    basis B1 into the basis B0 of the step at p0 where the fit runs,
    T0 = (B0^T B1) T1 (B1^T B0): then the fitted p and err do not depend
    on the sign/rotation gauge that eigh picks for the bath."""
    out1 = step(p0 + dp, placeholder)
    B0 = step(p0, placeholder)[4]
    T1 = torch.as_tensor(make_target(out1[2].cpu().numpy()),
                         device=B0.device)
    O = B0.transpose(-1, -2) @ out1[4]
    return O @ T1 @ O.transpose(-1, -2)


def compare_steps(out_d, out_c, label):
    """Gauge-invariant comparison of one step on the card (out_d) and on
    the CPU (out_c); raises past the TOL bounds."""
    d = [x.cpu().numpy() for x in out_d]
    c = [x.numpy() for x in out_c]
    P_d = np.einsum("spi, sqi -> spq", d[4], d[4])
    P_c = np.einsum("spi, sqi -> spq", c[4], c[4])
    diffs = {
        "rho_R": np.abs(d[3] - c[3]).max(),
        "bath projector": np.abs(P_d - P_c).max(),
        "embH1 spectrum": np.abs(np.linalg.eigvalsh(d[2])
                                 - np.linalg.eigvalsh(c[2])).max(),
        "p": np.abs(d[0] - c[0]).max(),
        "err": abs(float(d[1]) - float(c[1])),
    }
    if len(d) > 5:
        O = c[4][0].T @ d[4][0]
        eri_map = np.einsum("pi, qj, rk, sl, ijkl -> pqrs", O, O, O, O, d[5],
                            optimize=True)
        diffs["eri_emb (mapped, rel)"] = (np.abs(eri_map - c[5]).max()
                                          / np.abs(c[5]).max())
    for k, v in diffs.items():
        print("%s: cuda vs cpu %-22s %.3e (tol %.0e)" % (label, k, v, TOL[k]))
    bad = [k for k, v in diffs.items() if not v <= TOL[k]]
    for x in d:
        if not np.all(np.isfinite(x)):
            bad.append("non-finite output")
    if bad:
        raise AssertionError("%s: cuda and cpu disagree on %s" % (label, bad))
    print("%s: fit err %.6e" % (label, float(d[1])))


def phase_bench(device):
    from libdmet_preview_tpu_torch.ops.eri_kernels import syrk_df
    from libdmet_preview_tpu_torch.ops.fastpath import (chain_iterations,
                                                        make_dmet_iteration)
    Lat, vcor, rho_t, L = make_bench_workload()
    dp = np.random.RandomState(7).randn(len(vcor.param)) * 0.1
    runs = []
    for dev in (device, torch.device("cpu")):
        t0 = time.perf_counter()
        step, p0 = make_dmet_iteration(Lat, vcor, FILLING, beta=BETA,
                                       fit_max_iter=N_FIT_STEPS, chol_L=L,
                                       engine="lm", device=dev)
        ph = torch.as_tensor(rho_t, device=dev)
        tgt = target_in_fit_basis(step, p0, torch.as_tensor(dp, device=dev),
                                  ph, bench_target)
        runs.append((step, p0, tgt))
        print("bench workload on %s: set-up and target %.2f s"
              % (dev.type, time.perf_counter() - t0))
    del L
    step_c, p0_c, tgt_c = runs.pop()
    out_c = step_c(p0_c, tgt_c)

    step, p0, tgt = runs.pop()
    chained = chain_iterations(step, N_CHAIN)
    torch.cuda.synchronize()
    # the main path: counts start at 0 here
    syrk_df.launches = 0
    out_d = step(p0, tgt)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p_fin, err_fin = chained(p0, tgt)
    torch.cuda.synchronize()
    ms_iter = (time.perf_counter() - t0) / N_CHAIN * 1e3
    launches = syrk_df.launches
    print("bench main path: syrk_df launches %d over 1 + %d iterations"
          % (launches, N_CHAIN))
    print("bench main path: %.3f ms per iteration (%d chained, host clock "
          "around synchronize)" % (ms_iter, N_CHAIN))
    compare_steps(out_d, out_c, "bench")
    if not (torch.all(torch.isfinite(p_fin)) and bool(torch.isfinite(err_fin))):
        raise AssertionError("chained iterations gave non-finite output")
    if out_d[5].shape != (NEO,) * 4:
        raise AssertionError("eri_emb shape %s" % (tuple(out_d[5].shape),))
    if launches < 1 + N_CHAIN:
        raise AssertionError("the main path launched syrk_df %d times"
                             % launches)
    print("bench chained: final fit err %.6e" % float(err_fin))
    return launches, ms_iter


def phase_hubbard(device):
    import libdmet_preview_tpu_torch.dmet.hubbard as dmet
    from libdmet_preview_tpu_torch.ops.fastpath import make_dmet_iteration
    from libdmet_preview_tpu_torch.ops.zlinalg import rho_fermi_real
    ncells, nlo, U, filling = 9, 2, 4.0, 0.5
    Lat = dmet.ChainLattice(ncells * nlo, nlo)
    Lat.set_Ham(dmet.Ham(Lat, U), use_hcore_as_emb_ham=True)
    vcor = dmet.PMInitGuess((nlo,), U, filling)
    dp = np.random.RandomState(11).randn(len(vcor.param)) * 0.1
    nelec2 = 2 * (Lat.ncore + Lat.nval)

    def target(embH1_p):
        return np.stack([rho_fermi_real(torch.as_tensor(h), nelec2, BETA)[0]
                         .numpy() for h in embH1_p])

    outs = []
    for dev in (device, torch.device("cpu")):
        step, p0 = make_dmet_iteration(Lat, vcor, filling, beta=BETA,
                                       fit_max_iter=N_FIT_STEPS,
                                       engine="lm", device=dev)
        ph = torch.zeros((1, 2 * nlo, 2 * nlo), dtype=torch.float64,
                         device=dev)
        tgt = target_in_fit_basis(step, p0, torch.as_tensor(dp, device=dev),
                                  ph, target)
        outs.append(step(p0, tgt))
    torch.cuda.synchronize()
    compare_steps(outs[0], outs[1], "hubbard")


def main():
    device, card = phase_device()
    phase_build()
    max_abs, times = phase_kernels(device)
    launches, ms_iter = phase_bench(device)
    phase_hubbard(device)
    k_ms, p_ms = times[(512, 32)]
    print("card: %s" % card)
    print(json.dumps({"kernels": [{
        "name": "syrk_df",
        "route": "cuda",
        "source": "libdmet_preview_tpu_torch/csrc/syrk_df.cu",
        "replaces": "libdmet_preview_tpu/ops/pallas_eri.py:163",
        "launches": launches,
        "max_abs_err": max_abs,
        "ms": k_ms,
        "plain_ms": p_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
