#!/usr/bin/env python3
"""
Smoke run of the PyTorch port (libdmet_preview_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the process exits non-zero:

  1. device: require CUDA; print the card's name and power limit as
     nvidia-smi reports them;
  2. build: compile every hand-written kernel from the sources in the
     checkout (nvcc, sm_90a) into build/kernels/; print each kernel's
     ptxas registers, spills and shared memory, each instantiation's
     dynamic shared memory and resident blocks per SM (the card's
     occupancy query, which must equal the schedule's RESIDENT), and at
     each timing shape the schedule's blocks and waves;
  3. kernels against their plain versions on the card: syrk_df vs F^T F at
     (naux, neo) = (512, 32), (300, 45), (7, 2), (2400, 60), 1e-12
     relative and exactly symmetric; the cross kernel syrk_df(F, F2) vs
     F^T F2 at (96, 18), (300, 45), (7, 2), (2400, 60), 1e-12 relative;
     each kernel launched twice at (2400, 60) gives bit-identical output;
     then at the timing shapes (512, 32), (2400, 60) (the phase-6 path's)
     and (1024, 96) each kernel is checked the same way and timed against
     its plain version, which is one cuBLAS call (torch.mm), beside its
     bound; at the timing shapes whose 64 x 64 grid ends in a short wave,
     each kernel is checked and timed with that wave split into 1 .. 8
     pieces, in rising then falling order, against the schedule's choice;
  4. the main path at the bench workload (Nk=27, nlo=16, neo=32,
     naux=512, beta=1000, 20 LM fit steps; inputs made with NumPy from the
     same seeds as bench.py): one step on the card against the same step
     on the CPU, then 10 chained iterations on the card, counting kernel
     launches;
  5. the 1D Hubbard flagship (ChainLattice(18, 2), U=4, PMInitGuess): one
     step on the card against the CPU;
  6. the unrestricted ab initio path, one-shot interacting-bath UHF-DMET
     at the width of the CuO2 AFM plane (8 cells x 30 LOs, neo=60,
     naux=2400; inputs made with NumPy from fixed seeds): HartreeFock ->
     ConstructImpHam(int_bath=True, matching=True) -> SCFSolver(UHF) ->
     transformResults, once on the card and once on the CPU, compared
     gauge-invariantly; on the card the ab block against the einsum of
     the rotated factors, the aa/bb blocks exactly symmetric, and >= 2
     symmetric and >= 1 cross syrk launches counted on the path; the
     stages of that run, each timed with the card synchronised around it
     (utils.timer);
  7. the self-consistent DMET loop on the card, through dmet.hubbard and
     dmet.loop.run_dmet:
     7a. 2D Hubbard, SquareLattice(40, 40, 2, 2), half filling,
         AFInitGuess, UHF + FCI(tol=1e-10), to convergence: the
         non-interacting bath at U=6 (E/site -0.652114179764) and the
         interacting bath with charge self-consistency at U=2
         (-1.179836342898), both to 1e-4 with one electron per site; the
         stages of each run (utils.timer) with the FCI.run, sigma and CG
         step counts per iteration, and the card's idle share over one
         iteration (torch.profiler); the first two iterations of the
         non-interacting-bath run on the card against the CPU (E, nelec,
         accumulated dmu, vcor.param, rhoImp: 1e-8); FCI on one embedding
         problem of that run against dense eigh of the 4900 x 4900 matrix
         its sigma builds (E 1e-9, rdm1 1e-7), two sigma calls
         bit-identical;
     7b. the same loop over the symmetric syrk kernel: run_dmet(
         int_bath=True, restricted=True, FCI) on a Cholesky chain (8
         cells x 4 LOs, neo=8, naux=256, NumPy from fixed seeds), three
         iterations on the card, with >= 3 launches of the kernel counted
         and no call of its plain version there; the same three iterations
         on the CPU, each started from the vcor the card started it from
         (E, nelec, accumulated dmu, fit error: 1e-8; the fitted
         vcor.param: 1e-3, because this fit's CG stops in a flat valley
         where 1e-12 in its input moves the stopping point by up to
         4e-4); the kernel at that shape against its plain version, timed
         beside its bound.

  8. the rest of the model-lattice DMET on the card, through dmet.hubbard,
     ops.mfd, ops.embham and ops.fit (hand-written loops, as a user of
     these entry points writes them):
     8a. pDMET (global-density-matrix self-consistency, no vcor fit):
         SquareLattice(40, 40, 2, 2), U=4, half filling, beta=1000, HF_scf
         from the AFInitGuess seed, UHF + FCI, interacting bath,
         update_Ham(rho_glob) each iteration, DIIS on the global density,
         to convergence with the Fock update (E/site -0.876942444093 at
         1e-6) and with the idempotent projection (-0.86455325 at 2e-4);
         two iterations of the first case on the card against the CPU (E,
         nelec, accumulated dmu, rho_glob: 1e-8);
     8b. the finite-temperature Fock-embedding loop with the whole-lattice
         vcor fit: 6 x 6, U=8, 2 x 2 impurity, beta=1000,
         use_hcore_as_emb_ham=False, HF_scf, FitVcor(MaxIter1=0,
         MaxIter2=300, imp_fit=True, BFGS=True) to convergence (E/site
         -0.51685 at 1e-4), with the fit's evaluations and seconds per
         iteration; then the same FitVcorFull once on the 40 x 40 lattice
         of 8a (800 Hermitian 4 x 4 blocks per evaluation): seconds per
         evaluation, and the gradient against central differences in
         three random directions (1e-6 relative);
     8c. the three-band cuprate model at full width: Square3BandAFM(20,
         20, 1, 1) (400 k-points of 6 x 6 blocks, two CuO2 units per
         cell), Hubbard3band_ref("Hanke") in the electron representation,
         filling 5/6, UHF, non-interacting bath, FCI on 12 embedding
         orbitals with 12 electrons (924^2 = 853,776 determinants), the
         dmu loop (MuSolver, step=0.3) followed by FitVcor and a vcor
         update, two DMET iterations; nelec per site, the cluster's
         mirror-related occupations and the hole count are held, and the
         first iteration's impurity problem is checked against the CPU
         (one sigma application at 1e-10; the whole solve, E 1e-8 and
         rdm1 1e-7, when the CPU can do it in about 90 s); stage seconds,
         sigma builds, peak device memory and the idle share of one
         iteration;
     8d. (i) the 'nearest' H2 format: Square3Band(20, 20, 1, 1),
         Hubbard3band_ref("Hybertsen", ignore_intercell=False),
         restricted, update_Ham(rho * 2) -> ConstructImpHam(int_bath=True)
         -> FCI -> transformResults on the card against the CPU (1e-8),
         the batched transform_eri_nearest against its loop over all
         cells (1e-11); (ii) charge self-consistency on phase 6's
         workload: update_lattice_csc -> a second ConstructImpHam(
         int_bath=True) -> get_E_dmet(veff=), with 2 symmetric and 1 cross
         syrk launches at (2400, 60) counted in that ConstructImpHam and
         no call of a plain version on the card; the card against the CPU
         (1e-8).

  9. coupled cluster and the k-resolved GDF path:
     9a. CCSD on the ab initio embedding problem of phase 6 (neo = 60, 120
         spin orbitals; run right after phase 6, before 8d (ii) updates
         that lattice's Fock): ConstructImpHam (2 symmetric + 1 cross syrk
         launches counted, no plain-version call on the card) ->
         CCSD(restricted=False).run from the folded mean-field density ->
         transformResults with the CC solver; run_dmet_ham reproduces E
         (1e-8), tr(rdm1) = nelec (1e-8), rdm1 symmetric; amplitude and
         adjoint iterations, the branch that ended the adjoint, stage
         seconds, ms per residual and per adjoint matvec (CUDA events),
         peak device memory, the idle share of a second, profiled
         amplitude solve; one residual and one adjoint matvec at the
         card's amplitudes against the CPU (1e-10 relative);
     9b. run_dmet with DmetConfig(solver="CCSD") on SquareLattice(40, 40,
         2, 2), U=2, interacting bath, three iterations: E/site of each
         within 1e-3 of the FCI loop's same iteration in 7a; the first two
         iterations on the card against the CPU (1e-8);
     9c. the GDF path at the ab initio width: 300 random symmetric
         real-space factors on 8 cells x 30 LOs, decaying with the cell
         distance, and all 8 translations of each (2400 Cholesky
         vectors); their k-resolved factors analytically (a double
         Fourier transform, 300 per momentum transfer);
         get_emb_eri_gdf (with and without tr_symm) against
         get_emb_eri_chol of the same integrals for a random real (1, 8,
         30, 60) basis (1e-10 relative); get_jk_from_gdf against J, K
         from einsums over the Cholesky vectors (1e-10); both on the card
         against the CPU (1e-10); write_cderi -> read_cderi of the
         factors bit-identical; on a 6-cell, 4-orbital dense case
         make_gdf_factors' M_q = F F^H against the analytic factors'
         (1e-10).

  10. the superconducting / GSO formalism (dmet.loop.run_dmet_sc,
     dmet.hubbard_gso, dmet.hubbard_bcs, ops.spinless):
     10a. the repulsive doped d-wave anchor: SquareLattice(4, 4, 2, 2),
          U=4, filling 0.4375, VcorSC with a +-0.1 d-wave pairing seed,
          run_dmet_sc(mixing=0.5, diis_start=10) to convergence: E/site
          -0.9352863316 (1e-6), |kappa_x| 0.0952150 (1e-4), d-wave signs,
          C4-equal magnitudes (1e-5), nelec (1e-4);
     10b. the doped spinless anchor at full width: SquareLattice(60, 60,
          2, 2) (900 cells, nso = 8, neo = 16, FCI(ghf) on 12,870
          determinants), U=6, filling 0.4, AFInitGuess(bogoliubov=True,
          bogo_res=True, rand=0.001), beta=1000, SCDM bath, trace fix from
          iteration 3, to convergence in at most 30 iterations: E/site
          -1.001725641814 (2e-4), nelec (1e-4); stage seconds, GHF
          diagonalizations, FCI.run calls, sigma builds and CG steps per
          iteration, peak memory; the first two iterations replayed on the
          CPU from the states the card started them from (E, nelec, dmu,
          the impurity GSO density: 1e-8); the idle share of one
          iteration;
     10c. the ab initio GSO interacting bath on phase 6's lattice (run
          right after 9a): GSOHam(int_bath=True) -> GHartreeFock ->
          ConstructImpHam at neo = 120, with exactly 1 symmetric and 0
          cross syrk launches and no plain-version call on the card; the
          GSO ERI against the einsum of the rotated species difference
          (1e-12 relative, exactly symmetric); mu, the H1 and JK_core
          spectra, the bath projector and the mean-field energy of
          get_H_dmet_ib on the folded mean-field GSO density, card against
          CPU (1e-8); the symmetric kernel at (naux, neo) = (2400, 120)
          against its plain version, timed beside cuBLAS and its bound;
          and, inside 9c, get_emb_eri_gso_gdf against get_emb_eri_gso_chol
          on the same factors for a random GSO basis (1e-10 relative).

The line before the last is a JSON summary of the kernels; the last line
is {"ok": true, "device": {...}}.
"""

import contextlib
import json
import os
import subprocess
import tempfile
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

KERNEL_SHAPES = [(512, 32), (300, 45), (7, 2), (2400, 60)]
CROSS_SHAPES = [(96, 18), (300, 45), (7, 2), (2400, 60)]
# (naux, neo): the bench path's tri shape, the ab initio path's, a large one
TIMING_SHAPES = [(512, 32), (2400, 60), (1024, 96)]
PATH_SHAPE = (2400, 60)     # shape of the kernels on the phase-6 path
MAX_SCAN_SPLIT = 8          # pieces per last-wave tile in the split scan
DESIGN = ("DMMA mma.sync m16n8k4 f64; 64x64 tiles, 4 warps of 32x32, 3 "
          "blocks/SM (32x32 tiles where 64x64 fill under one wave); 4-stage "
          "cp.async ring of 16 aux rows; last wave split along aux, pieces "
          "summed in order")
# stage times on the phase-6 path of the earlier CUDA-core FMA kernels (ms;
# NVIDIA H100 80GB HBM3, 700 W; PERF.md)
FMA_STAGE_MS = {"syrk (tri kernel)": 1.544, "syrk ab (cross kernel)": 1.216}

# H100 SXM data sheet peaks (700 W): FP64 on the tensor cores, HBM3
PEAK_FP64_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12

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
    """Build every kernel library; report each kernel's registers, spills
    and shared memory from ptxas, each instantiation's occupancy, and the
    schedule's blocks and waves at the timing shapes."""
    from libdmet_preview_tpu_torch.ops import _build
    from libdmet_preview_tpu_torch.ops import eri_kernels as ek
    path, seconds, log = _build.build("syrk_df")
    print("build syrk_df: %.2f s -> %s" % (seconds, path.name))
    kernel = None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            kernel = line.split("'")[1] if "'" in line else line.strip()
        elif kernel and ("registers" in line or "spill" in line
                         or "smem" in line):
            print("  ptxas %s: %s" % (kernel, line.split(":", 1)[-1].strip()))
    for symbol in _build.entry_points("syrk_df"):
        _build.load("syrk_df", symbol)
        print("  entry point %s loaded" % symbol)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    for sym in (True, False):
        for tile in ek.TILES:
            for copy, mode in ek.COPY_MODES.items():
                blocks, threads, smem = ek.syrk_df_occupancy(sym, copy, tile)
                print("  %s kernel, %dx%d tiles (%s copies): %d threads, %d "
                      "B dynamic shared memory, %d resident blocks per SM"
                      % ("tri" if sym else "cross", tile, tile, mode, threads,
                         smem, blocks))
                if blocks != ek.RESIDENT[tile]:
                    raise AssertionError("the schedule assumes %d resident "
                                         "blocks per SM" % ek.RESIDENT[tile])
    for naux, neo in TIMING_SHAPES:
        npair = neo * (neo + 1) // 2
        for sym in (True, False):
            sch = ek.syrk_schedule(naux, npair, sym, n_sm=n_sm)
            tail = (sch.n_blocks - sch.n_whole) // sch.n_split
            resident = ek.RESIDENT[sch.tile_m]
            print("  schedule %s (naux=%d, neo=%d): %dx%d tiles, %d blocks = "
                  "%d whole tiles + %d tiles x %d pieces, %.2f waves of "
                  "%d x %d"
                  % ("tri" if sym else "cross", naux, neo, sch.tile_m,
                     sch.tile_n, sch.n_blocks, sch.n_whole,
                     tail if sch.n_split > 1 else 0, sch.n_split,
                     sch.n_blocks / (n_sm * resident), n_sm, resident))


def _packed_factors(naux, neo, seed, device):
    from libdmet_preview_tpu_torch.ops.eri_kernels import pack_tril
    rng = np.random.RandomState(seed)
    L = rng.randn(naux, neo, neo)
    L = 0.5 * (L + L.transpose(0, 2, 1)) * 0.3
    return pack_tril(torch.as_tensor(L, device=device))


def _time_ms(fn, reps=20):
    """Device ms per call: the reps launches are queued while the card
    sleeps, so the host's launch rate does not enter."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(4_000_000)
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def kernel_bound(kind, naux, npair):
    """Least time (ms) the card could take for the syrk, and what bounds
    it: FP64 operations over the tensor-core peak, or bytes (each input
    read once, the full square output written once) over HBM bandwidth.
    kind 'tri' counts the triangle's operations, 'cross' the square's."""
    if kind == "tri":
        flops = naux * npair * (npair + 1)
        nbytes = 8 * (naux * npair + npair * npair)
    else:
        flops = 2 * naux * npair * npair
        nbytes = 8 * (2 * naux * npair + npair * npair)
    t_ops, t_bytes = flops / PEAK_FP64_FLOPS, nbytes / PEAK_HBM_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", flops)


def _check_kernel(name, out, ref, symmetric):
    err = torch.max(torch.abs(out - ref)).item()
    rel = err / torch.max(torch.abs(ref)).item()
    sym = torch.equal(out, out.T)
    print("%s (npair=%d): max_abs_err %.3e rel %.3e symmetric=%s"
          % (name, out.shape[0], err, rel, sym))
    if not rel <= 1e-12 or (symmetric and not sym):
        raise AssertionError("%s disagrees with its plain version" % name)
    return err


def phase_kernels(device):
    """Each kernel against its plain version at the check shapes and the
    timing shapes, and the timings.  The plain version is one cuBLAS call
    (torch.mm), so it is also the library call.  Returns ({kernel:
    max_abs_err}, {(kernel, naux, neo): (ms, plain_ms)})."""
    from libdmet_preview_tpu_torch.ops.eri_kernels import (syrk_df,
                                                           syrk_df_plain)
    max_abs = {"syrk_df": 0.0, "syrk_df_cross": 0.0}
    for naux, neo in KERNEL_SHAPES:
        F = _packed_factors(naux, neo, seed=neo, device=device)
        out = syrk_df(F)
        torch.cuda.synchronize()
        err = _check_kernel("syrk_df (naux=%d, neo=%d)" % (naux, neo), out,
                            syrk_df_plain(F), symmetric=True)
        max_abs["syrk_df"] = max(max_abs["syrk_df"], err)
    for naux, neo in CROSS_SHAPES:
        F = _packed_factors(naux, neo, seed=neo, device=device)
        F2 = _packed_factors(naux, neo, seed=neo + 1000, device=device)
        out = syrk_df(F, F2)
        torch.cuda.synchronize()
        err = _check_kernel("syrk_df_cross (naux=%d, neo=%d)" % (naux, neo),
                            out, syrk_df_plain(F, F2), symmetric=False)
        max_abs["syrk_df_cross"] = max(max_abs["syrk_df_cross"], err)
    # determinism: two launches at the path's shape, bit for bit
    naux, neo = PATH_SHAPE
    F = _packed_factors(naux, neo, seed=3, device=device)
    F2 = _packed_factors(naux, neo, seed=4, device=device)
    for name, args in [("syrk_df", (F,)), ("syrk_df_cross", (F, F2))]:
        same = torch.equal(syrk_df(*args), syrk_df(*args))
        print("%s (naux=%d, neo=%d): two launches bit-identical: %s"
              % (name, naux, neo, same))
        if not same:
            raise AssertionError("%s is not deterministic" % name)
    times = {}
    for naux, neo in TIMING_SHAPES:
        F = _packed_factors(naux, neo, seed=1, device=device)
        F2 = _packed_factors(naux, neo, seed=2, device=device)
        npair = F.shape[1]
        cases = [("syrk_df", "tri", lambda: syrk_df(F),
                  lambda: syrk_df_plain(F)),
                 ("syrk_df_cross", "cross", lambda: syrk_df(F, F2),
                  lambda: syrk_df_plain(F, F2))]
        for name, kind, kern, plain in cases:
            out = kern()
            torch.cuda.synchronize()
            err = _check_kernel("%s (naux=%d, neo=%d)" % (name, naux, neo),
                                out, plain(), symmetric=kind == "tri")
            max_abs[name] = max(max_abs[name], err)
            del out
            # alternate plain, kernel, kernel, plain
            tp = [_time_ms(plain)]
            tk = [_time_ms(kern), _time_ms(kern)]
            tp.append(_time_ms(plain))
            t = (float(np.mean(tk)), float(np.mean(tp)))
            times[(name, naux, neo)] = t
            bound, by, flops = kernel_bound(kind, naux, npair)
            print("%s timing (naux=%d, neo=%d, npair=%d): kernel %.4f ms "
                  "(%.2f TFLOP/s), plain (cuBLAS torch.mm) %.4f ms, "
                  "kernel/cuBLAS %.3f, bound %.4f ms (%s), kernel at %.1f%% "
                  "of bound"
                  % (name, naux, neo, npair, t[0], flops / t[0] * 1e-9,
                     t[1], t[0] / t[1], bound, by, 100.0 * bound / t[0]))
    return max_abs, times


def phase_split_scan(device):
    """At each timing shape whose 64 x 64 grid ends in a short wave, each
    kernel with that wave in n = 1 ..
    MAX_SCAN_SPLIT pieces: checked against its plain version, then timed
    for n rising and again for n falling; the schedule's n against the
    fastest, beside the spread between the two readings of each n."""
    from libdmet_preview_tpu_torch.ops import eri_kernels as ek
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    for naux, neo in TIMING_SHAPES:
        F = _packed_factors(naux, neo, seed=1, device=device)
        F2 = _packed_factors(naux, neo, seed=2, device=device)
        npair = F.shape[1]
        for name, sym, args in [("syrk_df", True, (F, None)),
                                ("syrk_df_cross", False, (F, F2))]:
            sch = ek.syrk_schedule(naux, npair, sym, n_sm=n_sm)
            n_tail = ek.n_tiles(npair, sym, 64) % (n_sm * ek.RESIDENT[64])
            if sch.tile_m != 64 or n_tail == 0:
                continue
            ref = ek.syrk_df_plain(*args)
            runs = {}
            for n in range(1, MAX_SCAN_SPLIT + 1):
                try:
                    runs[n] = ek.syrk_schedule(naux, npair, sym, n_sm=n_sm,
                                               tile=64, n_split=n)
                except ValueError:
                    continue
                _check_kernel("%s (naux=%d, neo=%d) split %d" % (
                    name, naux, neo, n), ek.syrk_df_launch(*args, runs[n]),
                    ref, symmetric=sym)
            ms = {n: [] for n in runs}
            for order in (sorted(runs), sorted(runs, reverse=True)):
                for n in order:
                    ms[n].append(_time_ms(
                        lambda: ek.syrk_df_launch(*args, runs[n])))
            mean = {n: float(np.mean(t)) for n, t in ms.items()}
            spread = max(abs(t[0] - t[1]) / np.mean(t) for t in ms.values())
            best = min(mean, key=mean.get)
            print("%s split scan (naux=%d, neo=%d, %d last-wave tiles): %s"
                  % (name, naux, neo, n_tail,
                     ", ".join("%d: %.4f ms" % (n, mean[n]) for n in mean)))
            print("%s split scan (naux=%d, neo=%d): schedule n_split %d "
                  "%.4f ms, fastest n_split %d %.4f ms (schedule +%.1f%%), "
                  "spread of two readings up to %.1f%%"
                  % (name, naux, neo, sch.n_split, mean[sch.n_split], best,
                     mean[best], 100.0 * (mean[sch.n_split] / mean[best] - 1),
                     100.0 * spread))


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


def make_bench_workload(seed=0, naux=NAUX):
    """bench.py's lattice, vcor, target placeholder and DF factors; a
    smaller `naux` gives the same lattice and vcor (the factors are drawn
    last) for work that does not need the ERI."""
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
    L = rng.randn(naux, nsites, nsites) * 0.02
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
    syrk_df.cross_launches = 0
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


# ----------------------------------------------------------------------
# phase 6: one-shot interacting-bath UHF-DMET at the CuO2 AFM plane's width
# ----------------------------------------------------------------------

# sqrt2 x sqrt2 AFM double cell in the JAX package's tpu-szv basis:
# 2 Cu x (4s + 6 d) + 4 O x (2s + 2p) = 30 LOs, 25 electrons per formula
# unit and two formula units per cell; a BvK chain of 8 cells
AI_NCELLS = 8
AI_NLO = 30
AI_NAUX = 2400              # ~10 x nsites: a pivoted-Cholesky rank
AI_FILLING = 50.0 / 60.0
AI_DELTA = 2.0              # staggered on-site field on the Cu d shells
AI_CU_S = [0, 7]            # 4s of Cu A, Cu B
AI_CU_A_UP = [1, 2, 3]      # d orbitals of Cu A raised for alpha
AI_CU_B_UP = [8, 9, 10]     # d orbitals of Cu B raised for beta
AI_O = list(range(14, 30))

AI_TOL = {"HF E": 1e-8, "HF rho_R": 1e-8, "bath projector": 1e-8,
          "H1 spectrum": 1e-8, "H2 aa (mapped, rel)": 1e-10,
          "H2 bb (mapped, rel)": 1e-10, "H2 ab (mapped, rel)": 1e-10,
          "SCF E": 1e-8, "E per cell": 1e-8, "nelec per cell": 1e-8}


def _tr_stripe(rng, ncells, n, scale):
    """Random time-reversal-symmetric stripe h[R] (h[-R] = h[R]^T),
    decaying with the cell distance."""
    h = np.zeros((ncells, n, n))
    for R in range(ncells // 2 + 1):
        d = min(R, ncells - R)
        blk = rng.randn(n, n) * scale / (1.0 + d) ** 2
        if R == 0 or 2 * R == ncells:
            blk = 0.5 * (blk + blk.T)
        h[R] = blk
        h[(-R) % ncells] = blk.T
    return h


def make_abinitio_workload(seed=5, ncells=AI_NCELLS, nlo=AI_NLO,
                           naux=AI_NAUX):
    """hcore/fock per-spin stripes (2, ncells, nlo, nlo), chol_L (naux,
    nsites, nsites) symmetric in (p, q) with ERI entries O(0.1-1), and
    the unit-cell ERI, all NumPy from `seed`.  The staggered +-Delta field
    on the Cu d shells, of opposite sign per spin, opens a gap at 25
    electrons per spin and cell."""
    rng = np.random.RandomState(seed)
    onsite = np.zeros(nlo)
    onsite[[i for i in AI_O if i < nlo]] = -1.0
    onsite[[i for i in AI_CU_S if i < nlo]] = 3.0
    stag = np.zeros(nlo)
    stag[[i for i in AI_CU_A_UP if i < nlo]] = AI_DELTA
    stag[[i for i in AI_CU_B_UP if i < nlo]] = -AI_DELTA
    hop = _tr_stripe(rng, ncells, nlo, 0.1)
    hcore = np.stack([hop, hop])
    hcore[0, 0] += np.diag(onsite + stag)
    hcore[1, 0] += np.diag(onsite - stag)
    fock = hcore + _tr_stripe(rng, ncells, nlo, 0.05)[None]
    nsites = ncells * nlo
    L = np.empty((naux, nsites, nsites))
    for x0 in range(0, naux, 200):
        blk = rng.randn(min(200, naux - x0), nsites, nsites)
        L[x0:x0 + len(blk)] = 0.01 * (blk + blk.transpose(0, 2, 1))
    L0 = L[:, :nlo, :nlo].reshape(naux, nlo * nlo)
    eri_imp = (L0.T @ L0).reshape((nlo,) * 4)
    return hcore, fock, L, eri_imp


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_abinitio_uhf(hcore, fock, L, eri_imp, device, ncells=AI_NCELLS):
    """The user's one-shot driver on `device`; returns its results and the
    host-clock seconds of each entry point and of the stages inside
    ConstructImpHam, the device synchronised around each
    ({name: [seconds]}, in the order run)."""
    import libdmet_preview_tpu_torch.dmet.hubbard as dmet
    from libdmet_preview_tpu_torch.models.abinitio import AbInitioHam
    from libdmet_preview_tpu_torch.ops import embham
    from libdmet_preview_tpu_torch.solvers import SCFSolver
    from libdmet_preview_tpu_torch.utils import timer
    nlo = hcore.shape[-1]
    with timer.recording() as sec:
        with timer.stage("set-up (factors to the device)", device):
            Lat = dmet.ChainLattice(ncells * nlo, nlo)
            Ham = AbInitioHam(hcore, fock, L, eri_imp, 0.0)
            Lat.set_Ham_abinitio(Ham, device=device)
            vcor = dmet.VcorLocal(False, False, nlo)
            vcor.assign(np.zeros((2, nlo, nlo)))
        with timer.stage("HF", device):
            rho, mu, res = dmet.HartreeFock(Lat, vcor, AI_FILLING, None,
                                            ires=True)
            Lat.set_Ham_abinitio(Ham, rdm1=rho, device=device)
        with timer.stage("ConstructImpHam", device):
            ImpHam, H1e, basis = dmet.ConstructImpHam(
                Lat, rho, vcor, matching=True, int_bath=True)
        with timer.stage("SCF", device):
            rho_mf = embham.foldRho_k(Lat.rdm1_lo_k, Lat.R2k_basis(basis))
            nel = int(round(float(torch.trace(rho_mf[0])
                                  + torch.trace(rho_mf[1]))))
            hf = SCFSolver(restricted=False, device=device)
            rdm1, E_scf = hf.run(ImpHam, nelec=nel, dm0=rho_mf)
        with timer.stage("energy", device):
            _, E_cell, n_cell = dmet.transformResults(
                rdm1, E_scf, basis, ImpHam, H1e, lattice=Lat, last_dmu=0.0,
                int_bath=True, solver=hf, solver_args={"nelec": nel})
    return {"Lat": Lat, "rho": rho, "E_hf": res["E"], "gap": res["gap"],
            "vcor": vcor, "solver": hf,
            "basis": basis, "ImpHam": ImpHam, "nel": nel, "rdm1": rdm1,
            "E_scf": E_scf, "E_cell": E_cell, "n_cell": n_cell,
            "bfgs": list(hf.scf.oo_iterations),
            "converged": hf.scf.converged}, sec


def compare_abinitio(d, c):
    """Gauge-invariant card (d) vs CPU (c) differences of the phase-6
    results; the H2 blocks are carried into the CPU run's basis with
    O_s = B_s,cpu^T B_s,card on the card."""
    dev = d["basis"].device
    nb = d["basis"].shape[-1]
    Bd = d["basis"].reshape(2, -1, nb)
    Bc = c["basis"].to(dev).reshape(2, -1, nb)
    Pd = Bd @ Bd.transpose(-1, -2)
    Pc = Bc @ Bc.transpose(-1, -2)
    ev_d = torch.linalg.eigvalsh(d["ImpHam"].H1["cd"])
    ev_c = torch.linalg.eigvalsh(c["ImpHam"].H1["cd"].to(dev))
    O = Bc.transpose(-1, -2) @ Bd
    diffs = {
        "HF E": abs(d["E_hf"] - c["E_hf"]),
        "HF rho_R": float(np.abs(d["rho"] - c["rho"]).max()),
        "bath projector": float(torch.max(torch.abs(Pd - Pc))),
        "H1 spectrum": float(torch.max(torch.abs(ev_d - ev_c))),
    }
    H2d = d["ImpHam"].H2["ccdd"]
    for m, (a, b, name) in enumerate([(0, 0, "aa"), (1, 1, "bb"),
                                      (0, 1, "ab")]):
        ref = c["ImpHam"].H2["ccdd"][m].to(dev)
        mp = torch.einsum("ip, pqrs -> iqrs", O[a], H2d[m])
        mp = torch.einsum("jq, iqrs -> ijrs", O[a], mp)
        mp = torch.einsum("kr, ijrs -> ijks", O[b], mp)
        mp = torch.einsum("ls, ijks -> ijkl", O[b], mp)
        diffs["H2 %s (mapped, rel)" % name] = float(
            torch.max(torch.abs(mp - ref)) / torch.max(torch.abs(ref)))
    diffs["SCF E"] = abs(d["E_scf"] - c["E_scf"])
    diffs["E per cell"] = abs(d["E_cell"] - c["E_cell"])
    diffs["nelec per cell"] = abs(d["n_cell"] - c["n_cell"])
    return diffs


def phase_abinitio_uhf(device):
    from libdmet_preview_tpu_torch.ops.eri_kernels import syrk_df
    from libdmet_preview_tpu_torch.ops.eri_transform import _rotate_chol
    t0 = time.perf_counter()
    hcore, fock, L, eri_imp = make_abinitio_workload()
    print("ab initio workload: %d cells x %d LOs, naux=%d, chol_L %.2f GB "
          "(made in %.1f s)" % (AI_NCELLS, AI_NLO, L.shape[0],
                                L.nbytes / 1e9, time.perf_counter() - t0))
    # the main path: counts start at 0 here
    _sync(device)
    syrk_df.launches = 0
    syrk_df.cross_launches = 0
    d, sec_d = run_abinitio_uhf(hcore, fock, L, eri_imp, device)
    _sync(device)
    launches = {"syrk_df": syrk_df.launches,
                "syrk_df_cross": syrk_df.cross_launches}
    print("abinitio main path: syrk_df launches %d, cross launches %d"
          % (launches["syrk_df"], launches["syrk_df_cross"]))
    for k, v in sec_d.items():
        print("abinitio on the card: %-32s %.6f s (%d call%s)"
              % (k, sum(v), len(v), "" if len(v) == 1 else "s"))
    for k, fma in FMA_STAGE_MS.items():
        print("abinitio on the card: stage %s %.3f ms (FMA kernels: %.3f ms)"
              % (k, 1e3 * sum(sec_d.get(k, [0.0])), fma))
    print("abinitio on the card: neo=%d, nelec=%d, HF E/cell %.10f, gap %s, "
          "SCF E %.10f (converged %s, BFGS iterations %s), E/cell "
          "%.10f, nelec/cell %.10f"
          % (d["basis"].shape[-1], d["nel"], d["E_hf"], d["gap"], d["E_scf"],
             d["converged"], d["bfgs"], d["E_cell"], d["n_cell"]))

    c, sec_c = run_abinitio_uhf(hcore, fock, L, eri_imp, torch.device("cpu"))
    for k, v in sec_c.items():
        print("abinitio on the CPU:  %-32s %.6f s (%d call%s)"
              % (k, sum(v), len(v), "" if len(v) == 1 else "s"))
    diffs = compare_abinitio(d, c)
    for k, v in diffs.items():
        print("abinitio: cuda vs cpu %-22s %.3e (tol %.0e)" % (k, v, AI_TOL[k]))
    bad = [k for k, v in diffs.items() if not v <= AI_TOL[k]]

    # card-only checks: the main path's aa, bb and ab blocks against the
    # einsum of its rotated factors, exact symmetry of aa and bb
    H2 = d["ImpHam"].H2["ccdd"]
    nb = H2.shape[-1]
    C = d["basis"].reshape(2, -1, nb)
    Lt = d["Lat"].getH2()
    Lr = [_rotate_chol(Lt, C[0]), _rotate_chol(Lt, C[1])]
    for m, (a, b, name) in enumerate([(0, 0, "aa"), (1, 1, "bb"),
                                      (0, 1, "ab")]):
        ref = torch.einsum("xij, xkl -> ijkl", Lr[a], Lr[b])
        rel = float(torch.max(torch.abs(H2[m] - ref))
                    / torch.max(torch.abs(ref)))
        del ref
        print("abinitio: %s block vs einsum(L%s, L%s) rel %.3e (tol 1e-12)"
              % (name, name[0], name[1], rel))
        if not rel <= 1e-12:
            bad.append("%s block vs einsum" % name)
    del Lr
    for m in (0, 1):
        M = H2[m].reshape(nb * nb, nb * nb)
        if not torch.equal(M, M.T):
            bad.append("H2 block %d not exactly symmetric" % m)
    for name, v in [("E", d["E_cell"]), ("nelec", d["n_cell"])]:
        if not np.isfinite(v):
            bad.append("non-finite %s" % name)
    if tuple(H2.shape) != (3,) + (nb,) * 4 or nb != 2 * AI_NLO:
        bad.append("H2 shape %s" % (tuple(H2.shape),))
    if launches["syrk_df"] < 2 or launches["syrk_df_cross"] < 1:
        bad.append("launch counts %s" % launches)
    if bad:
        raise AssertionError("abinitio phase failed: %s" % bad)
    return launches, d, c


# ----------------------------------------------------------------------
# phase 7: the self-consistent DMET loop on the card
# ----------------------------------------------------------------------

HUB2D = {"size": (40, 40), "imp": (2, 2), "filling": 0.5, "max_iter": 20,
         "runs": [("NIB U=6", False, 6.0, -0.652114179764),
                  ("IB U=2", True, 2.0, -1.179836342898)]}
LOOP_TOL = 1e-8             # card vs CPU, per iteration
CHOL_CHAIN = {"ncells": 8, "nlo": 4, "naux": 256, "iters": 3}
CHOL_SHAPE = (CHOL_CHAIN["naux"], 2 * CHOL_CHAIN["nlo"])   # (naux, neo)


@contextlib.contextmanager
def _quiet():
    """The port's logger at WARNING inside the block: the loop's RESULT
    lines would push this script's own out of a short tail."""
    from libdmet_preview_tpu_torch.utils import logger as log
    level, log.verbose = log.verbose, "WARNING"
    try:
        yield
    finally:
        log.verbose = level


@contextlib.contextmanager
def _counted_plain_calls():
    """Count the calls of the syrk's plain version on CUDA tensors inside
    the block; yields {"cuda": n}."""
    from libdmet_preview_tpu_torch.ops import eri_kernels as ek
    calls = {"cuda": 0}
    plain = ek.syrk_df_plain

    def counted_plain(F, F2=None):
        if F.device.type == "cuda":
            calls["cuda"] += 1
        return plain(F, F2)

    ek.syrk_df_plain = counted_plain
    try:
        yield calls
    finally:
        ek.syrk_df_plain = plain


def run_hub2d(U, int_bath, device, max_iter=HUB2D["max_iter"],
              size=HUB2D["size"], profile_iteration=False, solver="FCI"):
    """run_dmet on the 2D Hubbard anchor on `device`, with the FCI solver
    or the one DmetConfig builds from the name `solver`; returns (result,
    stage seconds, counts, idle share of one profiled iteration or None).
    counts: FCI.run calls, sigma builds and CG steps of the whole run."""
    import libdmet_preview_tpu_torch.dmet.hubbard as dmet
    from libdmet_preview_tpu_torch.dmet.loop import run_dmet
    from libdmet_preview_tpu_torch.ops.fit import _cg_engine
    from libdmet_preview_tpu_torch.solvers import FCI
    from libdmet_preview_tpu_torch.utils import timer
    from libdmet_preview_tpu_torch.utils.config import DmetConfig

    def prepare(n_iter):
        Lat = dmet.SquareLattice(*size, *HUB2D["imp"])
        Lat.set_Ham(dmet.Ham(Lat, U), use_hcore_as_emb_ham=True,
                    device=device)
        vcor = dmet.AFInitGuess(HUB2D["imp"], U, HUB2D["filling"])
        cfg = DmetConfig(filling=HUB2D["filling"], restricted=False,
                         int_bath=int_bath, solver=solver, solver_tol=1e-10,
                         max_iter=n_iter)
        return Lat, vcor, cfg, (FCI(restricted=False, tol=1e-10,
                                    device=device)
                                if solver == "FCI" else None)

    Lat, vcor, cfg, fci = prepare(max_iter)
    _cg_engine.steps = 0
    with timer.recording() as sec:
        res = run_dmet(Lat, vcor, cfg, solver=fci)
    counts = {"FCI.run": getattr(fci, "n_run", 0),
              "sigma": getattr(fci, "n_sigma", 0),
              "CG steps": _cg_engine.steps}
    idle = None
    if profile_iteration:
        idle = _idle_share(lambda: run_dmet(*prepare(1)[:3]))
    return res, sec, counts, idle


class _Profiled(object):
    """Context manager: torch.profiler over the block, the card
    synchronised at its end.  Afterwards .idle is the share of the block's
    wall time (taken before the profiler processes its trace) in which the
    card ran no kernel: one minus the length of the union of the device
    events' time ranges over the wall time; None when the profiler
    reports no device event."""

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        from torch.autograd import DeviceType
        torch.cuda.synchronize()
        wall = time.perf_counter() - self._t0
        self._prof.__exit__(*exc)
        spans = sorted((ev.time_range.start, ev.time_range.end)
                       for ev in self._prof.events()
                       if ev.device_type == DeviceType.CUDA)
        busy_us, end = 0.0, None
        for t0, t1 in spans:
            if end is None or t0 >= end:
                busy_us += t1 - t0
                end = t1
            elif t1 > end:
                busy_us += t1 - end
                end = t1
        self.idle = (max(0.0, 1.0 - busy_us * 1e-6 / wall)
                     if spans else None)
        return False


def _idle_share(fn):
    """Idle share of the card over fn(), after one unprofiled call that
    warms the tables and the cuSOLVER handles."""
    fn()
    with _Profiled() as prof:
        fn()
    return prof.idle


def _print_loop_stages(label, res, sec, counts, card):
    """Stage seconds of a run_dmet run: the first iteration (which also
    pays for the first use of the card's libraries) apart from the mean of
    the later ones.  The ERI stages run inside stage H2."""
    n_it = len(res.history)
    inner = ("ERI rotation", "ERI pack", "ERI unpack", "syrk (tri kernel)")
    outer = {k: v for k, v in sec.items() if k not in inner}
    first = sum(v[0] for v in outer.values())
    later = sum(sum(v[1:]) for v in outer.values()) / max(n_it - 1, 1)
    print("%s [%s]: %d DMET iterations, converged %s; stages sum to %.4f s "
          "in the first iteration and %.4f s per later iteration"
          % (label, card, n_it, res.converged, first, later))
    for k, v in sec.items():
        print("%s [%s]: stage %-18s first %.6f s, later %.6f s per iteration "
              "(%d calls)" % (label, card, k, v[0],
                              sum(v[1:]) / max(len(v) - 1, 1), len(v)))
    print("%s [%s]: per iteration %.2f FCI.run calls, %.1f sigma builds, "
          "%.1f CG steps of the vcor fit"
          % (label, card, counts["FCI.run"] / n_it, counts["sigma"] / n_it,
             counts["CG steps"] / n_it))


def _compare_histories(label, hist_d, hist_c, tols, n_iter):
    """Per-iteration card (d) vs CPU (c) differences of run_dmet's history
    records; tols {key: tolerance}; raises past them."""
    bad = []
    if len(hist_d) < n_iter or len(hist_c) < n_iter:
        raise AssertionError("%s: fewer than %d iterations" % (label, n_iter))
    for h_d, h_c in list(zip(hist_d, hist_c))[:n_iter]:
        for k, tol in tols.items():
            diff = float(np.max(np.abs(np.asarray(h_d[k])
                                       - np.asarray(h_c[k]))))
            print("%s: iteration %d cuda vs cpu %-10s %.3e (tol %.0e)"
                  % (label, h_d["iter"], k, diff, tol))
            if not diff <= tol:
                bad.append((h_d["iter"], k))
    if bad:
        raise AssertionError("%s: cuda and cpu disagree on %s" % (label, bad))


def phase_fci_dense(device, U=6.0):
    """FCI on the card on the first embedding problem of the NIB run (8
    orbitals, 4 + 4 electrons, 70 x 70 = 4900 determinants) against dense
    eigh of the matrix its sigma builds from the identity; two sigma calls
    bit-identical."""
    import libdmet_preview_tpu_torch.dmet.hubbard as dmet
    from libdmet_preview_tpu_torch.solvers import FCI, fci
    Lat = dmet.SquareLattice(*HUB2D["size"], *HUB2D["imp"])
    Lat.set_Ham(dmet.Ham(Lat, U), use_hcore_as_emb_ham=True, device=device)
    vcor = dmet.AFInitGuess(HUB2D["imp"], U, HUB2D["filling"])
    rho, mu = dmet.HartreeFock(Lat, vcor, HUB2D["filling"], None)
    ImpHam, _, basis = dmet.ConstructImpHam(Lat, rho, vcor, matching=False,
                                            int_bath=False)
    solver = FCI(restricted=False, tol=1e-10, device=device)
    nelec = 2 * Lat.nval
    rdm1, E = solver.run(ImpHam, nelec=nelec)
    norb = ImpHam.norb
    h1e, eri = solver._ints(ImpHam)
    sigma, _ = fci.make_sigma(h1e, eri, norb, solver.nelec, device)
    na, nb = solver.ci.shape
    c = torch.as_tensor(np.random.RandomState(3).randn(na, nb), device=device)
    same = torch.equal(sigma(c), sigma(c))
    eye = torch.eye(na * nb, dtype=torch.float64, device=device)
    H = torch.stack([sigma(eye[i].reshape(na, nb)).reshape(-1)
                     for i in range(na * nb)], dim=1)
    asym = float(torch.max(torch.abs(H - H.T)))
    w, v = torch.linalg.eigh(0.5 * (H + H.T))
    ga, gb = fci.make_rdm1s(v[:, 0].reshape(na, nb), norb, solver.nelec)
    dE = abs(E - (float(w[0]) + float(ImpHam.H0)))
    dr = float(torch.max(torch.abs(torch.stack([ga, gb]) - rdm1)))
    print("FCI on the card: %d determinants, %d sigma builds, E %.12f; "
          "vs dense eigh: |dE| %.3e (tol 1e-9), rdm1 %.3e (tol 1e-7), gap "
          "to the first excited state %.3e; sigma matrix asymmetry %.3e; "
          "two sigma calls bit-identical: %s"
          % (na * nb, solver.n_sigma, E, dE, dr, float(w[1] - w[0]), asym,
             same))
    if not (dE <= 1e-9 and dr <= 1e-7 and asym <= 1e-10 and same):
        raise AssertionError("FCI on the card disagrees with dense eigh")


def phase_dmet_loop_hubbard(device, card):
    cpu = torch.device("cpu")
    results = {}
    for label, int_bath, U, anchor in HUB2D["runs"]:
        t0 = time.perf_counter()
        res, sec, counts, idle = run_hub2d(U, int_bath, device,
                                           profile_iteration=True)
        name = "hub2d 40x40 %s" % label
        print("%s [%s]: E/site %.12f (anchor %.12f, diff %.3e), nelec/site "
              "%.10f, %.2f s in all"
              % (name, card, res.e_per_site, anchor,
                 res.e_per_site - anchor, res.nelec_imp,
                 time.perf_counter() - t0))
        _print_loop_stages(name, res, sec, counts, card)
        print("%s [%s]: idle share of the card over one iteration: %s"
              % (name, card, "not measured (the profiler gave no device "
                 "time)" if idle is None else "%.4f" % idle))
        if not (res.converged and abs(res.e_per_site - anchor) < 1e-4
                and abs(res.nelec_imp - 1.0) < 1e-4
                and res.rho_imp.shape == (2, 4, 4)
                and np.all(np.isfinite(res.rho_imp))):
            raise AssertionError("%s missed its anchor" % name)
        results[label] = res
    # the first two iterations of the NIB run, card vs CPU
    label, int_bath, U, _ = HUB2D["runs"][0]
    res_d = run_hub2d(U, int_bath, device, max_iter=2)[0]
    res_c = run_hub2d(U, int_bath, cpu, max_iter=2)[0]
    _compare_histories("hub2d 40x40 %s" % label, res_d.history,
                       res_c.history,
                       dict.fromkeys(["E", "nelec", "last_dmu", "vcor_param",
                                      "rho_imp"], LOOP_TOL), 2)
    phase_fci_dense(device)
    return results


def make_chol_chain_workload(seed=11, ncells=CHOL_CHAIN["ncells"],
                             nlo=CHOL_CHAIN["nlo"], naux=CHOL_CHAIN["naux"]):
    """A random gapped chain with Cholesky ERIs, NumPy from `seed`:
    spinless hcore/fock stripes (ncells, nlo, nlo) with half of each
    cell's orbitals at -1 and half at +1 (a gap at half filling), chol_L
    (naux, nsites, nsites) symmetric in (p, q) with (pp|pp) ~ 0.4, and the
    unit-cell ERI."""
    rng = np.random.RandomState(seed)
    hcore = _tr_stripe(rng, ncells, nlo, 0.1)
    hcore[0] += np.diag([-1.0 if i < nlo // 2 else 1.0 for i in range(nlo)])
    fock = hcore + _tr_stripe(rng, ncells, nlo, 0.05)
    nsites = ncells * nlo
    L = rng.randn(naux, nsites, nsites)
    L = 0.02 * (L + L.transpose(0, 2, 1))
    L0 = L[:, :nlo, :nlo].reshape(naux, nlo * nlo)
    eri_imp = (L0.T @ L0).reshape((nlo,) * 4)
    return hcore, fock, L, eri_imp


def replay_dmet_iterations(lattice, vcor, config, starts):
    """run_dmet's first len(starts) iterations (at most 3: before the
    trace fix and DIIS begin) written out over the same entry points, with
    iteration i started from the vcor parameters starts[i].  Returns
    run_dmet's history records."""
    import libdmet_preview_tpu_torch.dmet.hubbard as dmet
    from libdmet_preview_tpu_torch.dmet.loop import _make_solver
    if len(starts) > min(config.trace_start, config.diis_start):
        raise ValueError("replay covers the iterations before the trace "
                         "fix and DIIS only")
    solver = _make_solver(config, lattice.device)
    mu_solver = dmet.MuSolver(adaptive=True)
    mu, last_dmu, history = None, 0.0, []
    for it, start in enumerate(starts):
        vcor.update(start)
        rho, mu, _ = dmet.HartreeFock(lattice, vcor, config.filling, mu,
                                      beta=config.beta, ires=True)
        ImpHam, H1e, basis = dmet.ConstructImpHam(
            lattice, rho, vcor, matching=False, int_bath=config.int_bath,
            valence_bath=config.valence_bath, tol_bath=config.tol_bath)
        ImpHam = dmet.apply_dmu(lattice, ImpHam, basis, last_dmu)
        solver_args = {"nelec": (lattice.ncore + lattice.nval) * 2}
        rhoEmb, EnergyEmb, ImpHam, dmu = mu_solver(
            lattice, config.filling, ImpHam, basis, solver, solver_args,
            thrnelec=config.mu_thrnelec, step=config.mu_step)
        last_dmu += dmu
        rhoImp, E, nelec = dmet.transformResults(
            rhoEmb, EnergyEmb, basis, ImpHam, H1e, lattice=lattice,
            last_dmu=last_dmu, int_bath=config.int_bath, solver=solver,
            solver_args=solver_args)
        vcor_new, err = dmet.FitVcor(rhoEmb, lattice, basis, vcor,
                                     config.beta, config.filling,
                                     MaxIter1=config.fit_max_iter, MaxIter2=0,
                                     method=config.fit_method,
                                     imp_fit=config.fit_imp_only)
        history.append({"iter": it, "E": float(E), "nelec": float(nelec),
                        "last_dmu": float(last_dmu), "fit_err": float(err),
                        "vcor_param": np.array(vcor_new.param, copy=True)})
    return history


def run_chol_chain(workload, device, n_iter=CHOL_CHAIN["iters"],
                   starts=None):
    """run_dmet(int_bath=True, restricted=True, FCI) over the Cholesky
    chain on `device`; the lattice's stored density is the mean field of
    its Fock, spin-traced.  With `starts`, replay_dmet_iterations from
    those vcor parameters instead.  Returns (history, stage seconds,
    result or None, solver or None)."""
    from libdmet_preview_tpu_torch import interop
    from libdmet_preview_tpu_torch.dmet.loop import _make_solver, run_dmet
    from libdmet_preview_tpu_torch.ops import mfd
    from libdmet_preview_tpu_torch.utils import timer
    from libdmet_preview_tpu_torch.utils.config import DmetConfig
    hcore, fock, L, eri_imp = workload
    ncells, nlo = hcore.shape[0], hcore.shape[-1]
    Lat = interop.abinitio_lattice_from_numpy(
        (ncells,), nlo, hcore, fock, L, eri_imp, 0.0, device=device)
    rho, _, _ = mfd.HF(Lat, None, 0.5, True)
    Lat.set_Ham_abinitio(Lat.Ham, rdm1=rho * 2.0, device=device)
    vcor = interop.vcor_local_from_numpy(True, nlo,
                                         np.zeros(nlo * (nlo + 1) // 2))
    cfg = DmetConfig(filling=0.5, restricted=True, int_bath=True,
                     solver="FCI", max_iter=n_iter)
    if starts is not None:
        return replay_dmet_iterations(Lat, vcor, cfg, starts), {}, None, None
    solver = _make_solver(cfg, Lat.device)
    with timer.recording() as sec:
        res = run_dmet(Lat, vcor, cfg, solver=solver)
    return res.history, sec, res, solver


def phase_dmet_loop_cholesky(device, card):
    """7b: the loop over the symmetric syrk kernel, card vs CPU.  Returns
    (launches on the card's run, max_abs_err, (ms, plain_ms)) of the
    kernel at this path's shape."""
    from libdmet_preview_tpu_torch.ops import eri_kernels as ek
    from libdmet_preview_tpu_torch.ops.fit import _cg_engine
    workload = make_chol_chain_workload()
    # the main path: counts start at 0 here
    _sync(device)
    ek.syrk_df.launches = 0
    ek.syrk_df.cross_launches = 0
    with _counted_plain_calls() as plain_calls:
        _cg_engine.steps = 0
        hist_d, sec_d, res_d, solver = run_chol_chain(workload, device)
    _sync(device)
    launches = ek.syrk_df.launches
    n_it = len(hist_d)
    print("cholesky chain loop [%s]: %d iterations, syrk_df launches %d, "
          "plain-version calls on CUDA tensors %d, E/cell %.10f, nelec/cell "
          "%.10f" % (card, n_it, launches, plain_calls["cuda"],
                     res_d.e_per_site, res_d.nelec_imp))
    _print_loop_stages("cholesky chain loop", res_d, sec_d,
                       {"FCI.run": solver.n_run, "sigma": solver.n_sigma,
                        "CG steps": _cg_engine.steps}, card)
    # the CPU mirror: every iteration from the vcor the card started it
    # from (zero, then the card's fitted parameters)
    starts = [np.zeros_like(hist_d[0]["vcor_param"])] \
        + [h["vcor_param"] for h in hist_d[:-1]]
    hist_c = run_chol_chain(workload, torch.device("cpu"), starts=starts)[0]
    _compare_histories("cholesky chain loop", hist_d, hist_c,
                       {"E": LOOP_TOL, "nelec": LOOP_TOL,
                        "last_dmu": LOOP_TOL, "fit_err": LOOP_TOL,
                        "vcor_param": 1e-3}, CHOL_CHAIN["iters"])
    if launches < CHOL_CHAIN["iters"] or plain_calls["cuda"] != 0 \
            or not np.isfinite(res_d.e_per_site):
        raise AssertionError("cholesky chain loop: %d kernel launches, %d "
                             "plain-version calls on the card"
                             % (launches, plain_calls["cuda"]))
    # the kernel at this path's shape against its plain version
    naux, neo = CHOL_SHAPE
    F = _packed_factors(naux, neo, seed=21, device=device)
    out = ek.syrk_df(F)
    torch.cuda.synchronize()
    err = _check_kernel("syrk_df (naux=%d, neo=%d)" % (naux, neo), out,
                        ek.syrk_df_plain(F), symmetric=True)
    tp = [_time_ms(lambda: ek.syrk_df_plain(F))]
    tk = [_time_ms(lambda: ek.syrk_df(F)), _time_ms(lambda: ek.syrk_df(F))]
    tp.append(_time_ms(lambda: ek.syrk_df_plain(F)))
    ms, plain_ms = float(np.mean(tk)), float(np.mean(tp))
    bound, by, _ = kernel_bound("tri", naux, F.shape[1])
    print("syrk_df timing (naux=%d, neo=%d, npair=%d) [%s]: kernel %.4f ms, "
          "plain (cuBLAS torch.mm) %.4f ms, bound %.6f ms (%s)"
          % (naux, neo, F.shape[1], card, ms, plain_ms, bound, by))
    return launches, err, (ms, plain_ms)


# ----------------------------------------------------------------------
# phase 8: the rest of the model-lattice DMET
# ----------------------------------------------------------------------

PDMET = {"size": (40, 40), "imp": (2, 2), "U": 4.0, "beta": 1000.0,
         "max_iter": 25,
         "cases": [("Fock update", False, -0.876942444093, 1e-6),
                   ("idempotent projection", True, -0.86455325, 2e-4)]}
IB_FOCK = {"size": (6, 6), "imp": (2, 2), "U": 8.0, "beta": 1000.0,
           "max_iter": 50, "anchor": -0.51685, "tol": 1e-4}
THREE_BAND = {"factory": "Square3BandAFM", "size": (20, 20), "name": "Hanke",
              "filling": 5.0 / 6.0, "iters": 2, "cu": [0, 1],
              # oxygen pairs that the impurity cluster's mirror x -> 4 - x
              # maps onto each other (sites (1, 1) and (3, 1))
              "mirror_pairs": [(4, 5)], "cpu_solve_seconds": 90.0,
              # the iteration run under torch.profiler for the idle share
              "profiled": 1}
NEAREST = {"size": (20, 20), "name": "Hybertsen", "filling": 5.0 / 6.0}


def run_pdmet(idem, device, size=PDMET["size"], max_iter=PDMET["max_iter"],
              n_fixed=None):
    """The pDMET loop on `device`: bath from the global density (idem: its
    idempotent projection, else the mean field of the Fock it gives),
    UHF + FCI with the interacting bath, DIIS on the global density from
    the third iteration.  Runs to convergence, or n_fixed iterations.
    Returns (records, converged, stage seconds)."""
    import libdmet_preview_tpu_torch.dmet.hubbard as dmet
    from libdmet_preview_tpu_torch.ops import embham, mfd
    from libdmet_preview_tpu_torch.ops.diis import DIIS
    from libdmet_preview_tpu_torch.solvers import FCI
    from libdmet_preview_tpu_torch.utils import timer
    U, beta, filling = PDMET["U"], PDMET["beta"], 0.5
    Lat = dmet.SquareLattice(*size, *PDMET["imp"])
    Lat.set_Ham(dmet.Ham(Lat, U), use_hcore_as_emb_ham=False, device=device)
    nsc = Lat.nscsites
    rec, conv = [], False
    with timer.recording() as sec:
        with timer.stage("HF_scf", device):
            seed = dmet.AFInitGuess(PDMET["imp"], U, filling)
            rho, Mu, _, _ = mfd.HF_scf(Lat, seed, filling, False,
                                       mu0=U * filling, beta=beta, ires=True)
        vcor = dmet.VcorLocal(False, False, nsc)
        vcor.update(np.zeros(vcor.length()))
        solver = FCI(restricted=False, tol=1e-12, device=device)
        mu_solver = dmet.MuSolver(adaptive=True)
        adiis = DIIS(space=6)
        rho_glob = np.asarray(rho)
        rho_old = rho_glob.copy()
        last_dmu, E_old = 0.0, 0.0
        for it in range(n_fixed or max_iter):
            with timer.stage("mean field", device):
                Lat.update_Ham(rho_glob)
                if idem:
                    rho_bath = rho_glob
                else:
                    rho_bath, Mu = dmet.HartreeFock(Lat, vcor, filling, Mu,
                                                    beta=beta)
            ImpHam, H1e, basis = dmet.ConstructImpHam(
                Lat, rho_bath, vcor, matching=False, int_bath=True)
            ImpHam = dmet.apply_dmu(Lat, ImpHam, basis, last_dmu)
            solver_args = {"nelec": (Lat.ncore + Lat.nval) * 2}
            with timer.stage("impurity solves", device):
                rhoEmb, EnergyEmb, ImpHam, dmu = mu_solver(
                    Lat, filling, ImpHam, basis, solver, solver_args,
                    thrnelec=1e-5, delta=0.01, step=0.1)
            last_dmu += dmu
            with timer.stage("energy", device):
                _, E, nelec = dmet.transformResults(
                    rhoEmb, EnergyEmb, basis, ImpHam, H1e, lattice=Lat,
                    last_dmu=last_dmu, int_bath=True, solver=solver,
                    solver_args=solver_args)
            with timer.stage("global density", device):
                rho_glob = embham.get_rho_glob_R(basis, Lat, rhoEmb)
                if idem:
                    nel = Lat.ncells * nsc * filling
                    rho_glob = embham.get_rdm1_idem(
                        rho_glob, [nel, nel],
                        tuple(int(x) for x in Lat.kmesh), device=device)
                if it >= 2:
                    rho_glob = adiis.update(rho_glob.ravel()).reshape(
                        rho_glob.shape)
            drho = float(np.max(np.abs(rho_glob - rho_old)))
            rho_old = rho_glob.copy()
            dE, E_old = E - E_old, E
            rec.append({"iter": it, "E": float(E), "nelec": float(nelec),
                        "last_dmu": float(last_dmu), "rho_glob": rho_old})
            if n_fixed is None and drho < 1e-5 and abs(dE) < 1e-6 and it > 3:
                conv = True
                break
    return rec, conv, sec


def _print_stages(label, card, sec, n_it, skip=()):
    for k, v in sec.items():
        if k not in skip:
            print("%s [%s]: stage %-18s %.6f s in all, %.6f s per iteration "
                  "(%d calls)" % (label, card, k, sum(v), sum(v) / n_it,
                                  len(v)))


def phase_pdmet(device, card):
    for label, idem, anchor, tol in PDMET["cases"]:
        t0 = time.perf_counter()
        rec, conv, sec = run_pdmet(idem, device)
        E = rec[-1]["E"]
        name = "pDMET 40x40 U=4 (%s)" % label
        print("%s [%s]: %d iterations, converged %s, E/site %.12f (anchor "
              "%.12f, diff %.3e, tol %.0e), nelec/site %.10f, %.2f s in all"
              % (name, card, len(rec), conv, E, anchor, E - anchor, tol,
                 rec[-1]["nelec"], time.perf_counter() - t0))
        _print_stages(name, card, sec, len(rec))
        if not (conv and abs(E - anchor) < tol
                and abs(rec[-1]["nelec"] - 1.0) < 1e-4):
            raise AssertionError("%s missed its anchor" % name)
    rec_d = run_pdmet(False, device, n_fixed=2)[0]
    rec_c = run_pdmet(False, torch.device("cpu"), n_fixed=2)[0]
    _compare_histories("pDMET 40x40 U=4 (Fock update)", rec_d, rec_c,
                       dict.fromkeys(["E", "nelec", "last_dmu", "rho_glob"],
                                     LOOP_TOL), 2)


def run_ib_fock(device, size=IB_FOCK["size"], max_iter=IB_FOCK["max_iter"]):
    """The finite-temperature Fock-embedding loop with the whole-lattice
    vcor fit (FitVcorFull through FitVcor(MaxIter1=0)) on `device`.
    Returns (records, converged, stage seconds, fit evaluations)."""
    import libdmet_preview_tpu_torch.dmet.hubbard as dmet
    from libdmet_preview_tpu_torch.ops import fit, mfd
    from libdmet_preview_tpu_torch.ops.diis import DIIS
    from libdmet_preview_tpu_torch.solvers import FCI
    from libdmet_preview_tpu_torch.utils import timer
    U, beta, filling = IB_FOCK["U"], IB_FOCK["beta"], 0.5
    Mu, last_dmu = U * filling, 0.0
    Lat = dmet.SquareLattice(*size, *IB_FOCK["imp"])
    Lat.set_Ham(dmet.Ham(Lat, U), use_hcore_as_emb_ham=False, device=device)
    nsc = Lat.nscsites
    vcor = dmet.VcorLocal(False, False, nsc)
    vcor.update(np.zeros(vcor.length()))
    # AFM-seeded self-consistent UHF, then lock the Fock
    rho_seed = np.zeros((2, Lat.ncells, nsc, nsc))
    rho_seed[0, 0] = np.diag([1.0, 0.0, 0.0, 1.0])
    rho_seed[1, 0] = np.diag([0.0, 1.0, 1.0, 0.0])
    Lat.update_Ham(rho_seed)
    rho, Mu, _, _ = mfd.HF_scf(Lat, vcor, filling, False, beta=beta,
                               ires=True)
    Lat.update_Ham(rho)
    solver = FCI(restricted=False, tol=1e-10, device=device)
    mu_solver = dmet.MuSolver(adaptive=True)
    adiis = DIIS(space=4)
    E_old, conv, rec = 0.0, False, []
    fit.FitVcorFull.n_eval = 0
    with timer.recording() as sec:
        for it in range(max_iter):
            with timer.stage("mean field", device):
                rho, Mu, _ = dmet.HartreeFock(Lat, vcor, filling, Mu,
                                              beta=beta, ires=True)
                Lat.update_Ham(rho)
            ImpHam, H1e, basis = dmet.ConstructImpHam(
                Lat, rho, vcor, matching=False, int_bath=True)
            ImpHam = dmet.apply_dmu(Lat, ImpHam, basis, last_dmu)
            solver_args = {"nelec": (Lat.ncore + Lat.nval) * 2}
            with timer.stage("impurity solves", device):
                rhoEmb, EnergyEmb, ImpHam, dmu = mu_solver(
                    Lat, filling, ImpHam, basis, solver, solver_args)
            last_dmu += dmu
            with timer.stage("energy", device):
                _, E, nelec = dmet.transformResults(
                    rhoEmb, EnergyEmb, basis, ImpHam, H1e, lattice=Lat,
                    last_dmu=last_dmu, int_bath=True, solver=solver,
                    solver_args=solver_args)
            with timer.stage("whole-lattice fit", device):
                vcor_new, err = dmet.FitVcor(
                    rhoEmb, Lat, basis, vcor, beta, filling, MaxIter1=0,
                    MaxIter2=300, imp_fit=True, BFGS=True)
            pvcor = np.hstack(vcor_new.param)
            if it >= 4:
                pvcor = adiis.update(pvcor)
            dVcor = np.linalg.norm(pvcor - vcor.param) / len(vcor.param)
            vcor.update(pvcor)
            dE, E_old = E - E_old, E
            rec.append({"iter": it, "E": float(E), "nelec": float(nelec),
                        "fit_err": float(err)})
            if dVcor < 1e-5 and abs(dE) < 1e-6 and it > 3:
                conv = True
                break
    return rec, conv, sec, fit.FitVcorFull.n_eval


def full_fit_check(device, card, size=PDMET["size"]):
    """FitVcorFull once on the pDMET lattice (its HF_scf Fock, the mean
    field's own folded density shifted by a seeded symmetric perturbation
    as the target): seconds per objective evaluation, and the gradient
    against central differences in three random directions."""
    import libdmet_preview_tpu_torch.dmet.hubbard as dmet
    from libdmet_preview_tpu_torch.ops import embham, fit, mfd
    U, beta, filling = PDMET["U"], PDMET["beta"], 0.5
    Lat = dmet.SquareLattice(*size, *PDMET["imp"])
    Lat.set_Ham(dmet.Ham(Lat, U), use_hcore_as_emb_ham=False, device=device)
    vcor = dmet.AFInitGuess(PDMET["imp"], U, filling)
    rho, Mu, _, _ = mfd.HF_scf(Lat, vcor, filling, False, mu0=U * filling,
                               beta=beta, ires=True)
    basis = embham.get_emb_basis(Lat, rho)
    neo = basis.shape[-1]
    rho_emb = embham.foldRho_k(Lat.R2k(rho), Lat.R2k_basis(basis))
    t = np.random.RandomState(3).randn(2, neo, neo) * 0.02
    target = rho_emb + torch.as_tensor(0.5 * (t + t.transpose(0, 2, 1)),
                                       device=device)
    fg = fit.full_fit_objective(target, Lat, basis, vcor, beta, filling,
                                imp_fit=True)
    p0 = vcor.param.copy()
    e0, g = fg(p0)
    rng = np.random.RandomState(0)
    worst = 0.0
    for _ in range(3):
        d = rng.randn(len(g))
        d /= np.linalg.norm(d)
        eps = 1e-5
        num = (fg(p0 + eps * d)[0] - fg(p0 - eps * d)[0]) / (2 * eps)
        worst = max(worst, abs(g @ d - num) / max(1.0, abs(num)))
    fit.FitVcorFull.n_eval = 0
    _sync(device)
    t0 = time.perf_counter()
    _, err0, err1 = fit.FitVcorFull(target, Lat, basis, vcor, beta, filling,
                                    MaxIter=300, imp_fit=True, BFGS=True)
    _sync(device)
    dt = time.perf_counter() - t0
    n_eval = fit.FitVcorFull.n_eval
    nk = Lat.ncells
    print("FitVcorFull %dx%d [%s]: %d Hermitian %dx%d blocks per evaluation, "
          "err %.6e -> %.6e in %d evaluations, %.3f s, %.6f s per evaluation; "
          "gradient vs central differences in 3 directions: %.3e relative "
          "(tol 1e-6)" % (size[0], size[1], card, 2 * nk, Lat.nscsites,
                          Lat.nscsites, err0, err1, n_eval, dt,
                          dt / max(n_eval, 1), worst))
    if not (worst <= 1e-6 and err1 < err0 and abs(e0 - err0) < 1e-12):
        raise AssertionError("FitVcorFull: gradient check or fit failed")


def phase_ib_fock(device, card):
    t0 = time.perf_counter()
    rec, conv, sec, n_eval = run_ib_fock(device)
    E = rec[-1]["E"]
    name = "hub2d 6x6 U=8 Fock embedding, whole-lattice fit"
    n_it = len(rec)
    print("%s [%s]: %d iterations, converged %s, E/site %.10f (anchor %.5f, "
          "diff %.3e, tol %.0e), nelec/site %.10f, fit error %.3e, %.2f s in "
          "all" % (name, card, n_it, conv, E, IB_FOCK["anchor"],
                   E - IB_FOCK["anchor"], IB_FOCK["tol"], rec[-1]["nelec"],
                   rec[-1]["fit_err"], time.perf_counter() - t0))
    _print_stages(name, card, sec, n_it)
    fit_s = sum(sec["whole-lattice fit"])
    print("%s [%s]: %.1f fit evaluations and %.4f s per iteration in the "
          "fit, %.6f s per evaluation"
          % (name, card, n_eval / n_it, fit_s / n_it, fit_s / max(n_eval, 1)))
    if not (abs(E - IB_FOCK["anchor"]) < IB_FOCK["tol"]
            and abs(rec[-1]["nelec"] - 1.0) < 1e-4):
        raise AssertionError("%s missed its anchor" % name)
    full_fit_check(device, card)


def _three_band_lattice(device, factory, size, name, **ham_kw):
    import libdmet_preview_tpu_torch.dmet.hubbard as dmet
    Lat = getattr(dmet, factory)(*size, 1, 1)
    Lat.set_Ham(dmet.Hubbard3band_ref(Lat, name=name, **ham_kw),
                use_hcore_as_emb_ham=True, device=device)
    return Lat


def run_three_band(device, factory=THREE_BAND["factory"],
                   size=THREE_BAND["size"], n_iter=THREE_BAND["iters"],
                   keep_first=False, profile_iteration=None):
    """UHF-DMET on the three-band model with the non-interacting bath:
    per DMET iteration the mean field, the bath, the dmu loop over
    MuSolver (step=0.3) until the impurity filling holds, FitVcor and a
    vcor update.  Iteration profile_iteration runs under torch.profiler.
    Returns (records, stage seconds, solver, first iteration's (ImpHam
    copy, nelec) when keep_first, the profiled iteration's idle share)."""
    import libdmet_preview_tpu_torch.dmet.hubbard as dmet
    from libdmet_preview_tpu_torch.solvers import FCI
    from libdmet_preview_tpu_torch.utils import timer
    filling = THREE_BAND["filling"]
    Lat = _three_band_lattice(device, factory, size, THREE_BAND["name"])
    nlo = Lat.nscsites
    vcor = dmet.VcorLocal(False, False, nlo)
    vcor.update(np.zeros(vcor.length()))
    solver = FCI(restricted=False, tol=1e-11, device=device)
    mu_solver = dmet.MuSolver(adaptive=True)
    solver_args = {"nelec": (Lat.ncore + Lat.nval) * 2}
    Mu, last_dmu, rec, first, idle = None, 0.0, [], None, None
    with timer.recording() as sec:
        for it in range(n_iter):
            prof = _Profiled() if it == profile_iteration \
                else contextlib.nullcontext()
            with prof:
                with timer.stage("mean field", device):
                    rho, Mu, res = dmet.HartreeFock(Lat, vcor, filling, Mu,
                                                    ires=True)
                ImpHam, H1e, basis = dmet.ConstructImpHam(
                    Lat, rho, vcor, matching=False, int_bath=False)
                ImpHam = dmet.apply_dmu(Lat, ImpHam, basis, last_dmu)
                if keep_first and first is None:
                    first = ({"H0": float(ImpHam.H0), "norb": ImpHam.norb,
                              "H1": ImpHam.H1["cd"].cpu().numpy(),
                              "H2": ImpHam.H2["ccdd"].cpu().numpy()},
                             solver_args["nelec"])
                with timer.stage("impurity solves", device):
                    for n_mu in range(1, 26):
                        rhoEmb, E_emb, ImpHam, dmu = mu_solver(
                            Lat, filling, ImpHam, basis, solver, solver_args,
                            step=0.3)
                        last_dmu += dmu
                        rhoImp, E, nelec = dmet.transformResults(
                            rhoEmb, E_emb, basis, ImpHam, H1e, lattice=Lat,
                            last_dmu=last_dmu, int_bath=False, solver=solver,
                            solver_args=solver_args)
                        if abs(nelec - 2 * filling) < 5e-7:
                            break
                with timer.stage("vcor fit", device):
                    vcor_new, err = dmet.FitVcor(
                        rhoEmb, Lat, basis, vcor, np.inf, filling,
                        MaxIter1=300, MaxIter2=0)
            if it == profile_iteration:
                idle = prof.idle
            dVcor = float(np.linalg.norm(vcor_new.param - vcor.param)
                          / len(vcor.param))
            vcor.update(vcor_new.param)
            rec.append({"iter": it, "E": float(E), "nelec": float(nelec),
                        "last_dmu": float(last_dmu), "fit_err": float(err),
                        "dVcor": dVcor, "mu_calls": n_mu,
                        "gap": np.asarray(res["gap"]).tolist(),
                        "occ": rhoImp.sum(dim=0).diagonal().cpu().numpy(),
                        "rho_imp": rhoImp.cpu().numpy()})
    return rec, sec, solver, first, idle


def _check_three_band(rec, nlo):
    """nelec per site, the cluster's mirror-related occupations and the
    hole count of the last iteration; returns the list of failed checks."""
    last = rec[-1]
    occ = last["occ"]
    filling = THREE_BAND["filling"]
    n_cuo2 = nlo // 3
    holes = 2.0 * nlo - occ.sum()
    bad = []
    if not abs(last["nelec"] - 2 * filling) < 1e-4:
        bad.append("nelec per site %.8f" % last["nelec"])
    if n_cuo2 == 2:
        cu = THREE_BAND["cu"]
        if not abs(occ[cu[0]] - occ[cu[1]]) < 1e-3:
            bad.append("Cu occupations %s" % occ[cu])
        for i, j in THREE_BAND["mirror_pairs"]:
            if not abs(occ[i] - occ[j]) < 1e-3:
                bad.append("O occupations %d, %d: %s" % (i, j, occ[[i, j]]))
    elif not abs(occ[1] - occ[2]) < 1e-3:
        bad.append("O occupations %s" % occ[1:])
    if not abs(holes / n_cuo2 - 1.0) < 1e-4:
        bad.append("holes per CuO2 %.8f" % (holes / n_cuo2))
    if not np.all(np.isfinite(last["rho_imp"])) or not np.isfinite(last["E"]):
        bad.append("non-finite output")
    return bad


def fci_card_vs_cpu(first, device, card, budget_s):
    """The first iteration's impurity problem on the card against the CPU
    through the port's own FCI: one sigma application on a seeded random
    vector (1e-10 relative), and the whole solve (E 1e-8, rdm1 1e-7) when
    the CPU's sigma time times the card's sigma count fits budget_s."""
    from libdmet_preview_tpu_torch import interop
    from libdmet_preview_tpu_torch.solvers import FCI, fci
    ham, nelec = first
    cpu = torch.device("cpu")
    out = {}
    for dev in (device, cpu):
        H = interop.integral_from_numpy(ham["norb"], False, ham["H0"],
                                        ham["H1"], ham["H2"], dev)
        solver = FCI(restricted=False, tol=1e-11, device=dev)
        h1e, eri = solver._ints(H)
        ne = (nelec // 2, nelec // 2)
        sigma, _ = fci.make_sigma(h1e, eri, ham["norb"], ne, dev)
        na = fci.num_strings(ham["norb"], ne[0])
        c = torch.as_tensor(np.random.RandomState(3).randn(na, na),
                            device=dev)
        _sync(dev)
        t0 = time.perf_counter()
        s = sigma(c)
        _sync(dev)
        out[dev.type] = (H, solver, s.cpu(), time.perf_counter() - t0)
    rel = float((out["cuda"][2] - out["cpu"][2]).abs().max()
                / out["cpu"][2].abs().max())
    print("three-band FCI [%s]: one sigma application on %d determinants, "
          "card %.4f s, CPU %.3f s, card vs CPU %.3e relative (tol 1e-10)"
          % (card, na * na, out["cuda"][3], out["cpu"][3], rel))
    if not rel <= 1e-10:
        raise AssertionError("sigma on the card disagrees with the CPU")
    H_d, sol_d = out["cuda"][:2]
    rdm_d, E_d = sol_d.run(H_d, nelec=nelec)
    est = out["cpu"][3] * sol_d.n_sigma
    if est > budget_s:
        print("three-band FCI [%s]: card E %.10f in %d sigma builds; the "
              "whole solve on the CPU would take ~%.0f s (> %.0f s): the "
              "sigma application above stands for it"
              % (card, E_d, sol_d.n_sigma, est, budget_s))
        return
    H_c, sol_c = out["cpu"][:2]
    rdm_c, E_c = sol_c.run(H_c, nelec=nelec)
    dE = abs(E_d - E_c)
    dr = float((rdm_d.cpu() - rdm_c).abs().max())
    print("three-band FCI [%s]: whole solve card vs CPU |dE| %.3e (tol "
          "1e-8), rdm1 %.3e (tol 1e-7), %d / %d sigma builds"
          % (card, dE, dr, sol_d.n_sigma, sol_c.n_sigma))
    if not (dE <= 1e-8 and dr <= 1e-7):
        raise AssertionError("FCI on the card disagrees with the CPU")


def phase_three_band(device, card):
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    rec, sec, solver, first, idle = run_three_band(
        device, keep_first=True, profile_iteration=THREE_BAND["profiled"])
    total = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device)
    n_it = len(rec)
    name = "three-band %s(%d, %d, 1, 1) %s" % (
        THREE_BAND["factory"], *THREE_BAND["size"], THREE_BAND["name"])
    nlo = len(rec[-1]["occ"])
    na = int(round(np.sqrt(solver.ci.numel())))
    print("%s [%s]: %d DMET iterations in %.2f s, %d x %d = %d determinants, "
          "%d FCI.run calls, %d sigma builds (%.1f per run), peak device "
          "memory %.3f GB"
          % (name, card, n_it, total, na, na, na * na, solver.n_run,
             solver.n_sigma, solver.n_sigma / solver.n_run, peak / 1e9))
    _print_stages(name, card, sec, n_it)
    for r in rec:
        print("%s [%s]: iteration %d E/site %.10f nelec/site %.10f dmu %.8f "
              "(%d MuSolver calls) fit err %.3e dVcor %.3e mean-field gap %s"
              % (name, card, r["iter"], r["E"], r["nelec"], r["last_dmu"],
                 r["mu_calls"], r["fit_err"], r["dVcor"], r["gap"]))
    occ = rec[-1]["occ"]
    print("%s [%s]: occupations summed over spin %s; holes per CuO2 %.8f; "
          "x-bond minus y-bond oxygen occupation %.3e (not a symmetry of the "
          "two-CuO2 cluster)"
          % (name, card, np.array2string(occ, precision=8),
             (2.0 * nlo - occ.sum()) / (nlo // 3),
             occ[2:4].mean() - occ[4:6].mean() if nlo == 6 else
             occ[1] - occ[2]))
    bad = _check_three_band(rec, nlo)
    if bad or na * na != 853776:
        raise AssertionError("%s: %s" % (name, bad or "CI size %d" % (na * na)))
    print("%s [%s]: idle share of the card over iteration %d (run under "
          "torch.profiler, which adds to its stage seconds): %s"
          % (name, card, THREE_BAND["profiled"], "not measured (the profiler "
             "gave no device time)" if idle is None else "%.4f" % idle))
    fci_card_vs_cpu(first, device, card, THREE_BAND["cpu_solve_seconds"])


def run_nearest_one_shot(device, size=NEAREST["size"]):
    """Restricted one-shot DMET with the intercell-Vpd 'nearest' H2:
    update_Ham (stripe K), the interacting-bath transform, FCI, energy."""
    import libdmet_preview_tpu_torch.dmet.hubbard as dmet
    from libdmet_preview_tpu_torch.solvers import FCI
    Lat = _three_band_lattice(device, "Square3Band", size, NEAREST["name"],
                              ignore_intercell=False)
    nlo = Lat.nscsites
    vcor = dmet.VcorLocal(True, False, nlo)
    vcor.update(np.zeros(vcor.length()))
    rho, mu, res = dmet.RHartreeFock(Lat, vcor, NEAREST["filling"], None,
                                     ires=True)
    Lat.update_Ham(np.asarray(rho) * 2.0)
    ImpHam, H1e, basis = dmet.ConstructImpHam(Lat, rho, vcor, matching=False,
                                              int_bath=True)
    solver = FCI(restricted=True, tol=1e-11, device=device)
    nelec = (Lat.ncore + Lat.nval) * 2
    rhoEmb, E_emb = solver.run(ImpHam, nelec=nelec)
    _, E, nel = dmet.transformResults(
        rhoEmb, E_emb, basis, ImpHam, H1e, lattice=Lat, last_dmu=0.0,
        int_bath=True, solver=solver, solver_args={"nelec": nelec})
    return {"Lat": Lat, "basis": basis, "ImpHam": ImpHam, "E_emb": E_emb,
            "E": E, "nelec": nel, "fock": np.asarray(Lat.fock_lo_R),
            "rho": np.asarray(rho)}


def phase_nearest(device, card):
    from libdmet_preview_tpu_torch.ops import embham
    from libdmet_preview_tpu_torch.utils.misc import as_f64
    t0 = time.perf_counter()
    d = run_nearest_one_shot(device)
    c = run_nearest_one_shot(torch.device("cpu"))
    Lat, B = d["Lat"], d["basis"]
    eri_R = as_f64(Lat.getH2(kspace=False), B.device)
    n_blocks = int((eri_R.abs().amax(dim=(1, 2, 3, 4)) > 0).sum())
    H2 = embham.transform_eri_nearest(B, eri_R, lattice=Lat)
    loop = embham._transform_eri_nearest_loop(B, eri_R, lattice=Lat)
    nb = B.shape[-1]
    Bd = B.reshape(1, -1, nb)
    Bc = c["basis"].to(B.device).reshape(1, -1, nb)
    diffs = {
        "batched vs loop H2": (float((H2 - loop).abs().max()), 1e-11),
        "path H2 vs batched": (float((d["ImpHam"].H2["ccdd"] - H2)
                                     .abs().max()), 0.0),
        "HF rho_R": (float(np.abs(d["rho"] - c["rho"]).max()), 1e-8),
        "updated Fock": (float(np.abs(d["fock"] - c["fock"]).max()), 1e-8),
        "bath projector": (float((Bd @ Bd.transpose(-1, -2)
                                  - Bc @ Bc.transpose(-1, -2)).abs().max()),
                           1e-8),
        "embedding E": (abs(d["E_emb"] - c["E_emb"]), 1e-8),
        "E per site": (abs(d["E"] - c["E"]), 1e-8),
        "nelec per site": (abs(d["nelec"] - c["nelec"]), 1e-8),
    }
    print("nearest H2 Square3Band(%d, %d, 1, 1) [%s]: %d of %d cell blocks "
          "non-zero, neo %d, E/site %.10f, nelec/site %.10f, %.2f s (card "
          "and CPU)" % (*NEAREST["size"], card, n_blocks, Lat.ncells, nb,
                        d["E"], d["nelec"], time.perf_counter() - t0))
    for k, (v, tol) in diffs.items():
        print("nearest H2: cuda vs cpu %-20s %.3e (tol %.0e)" % (k, v, tol))
    bad = [k for k, (v, tol) in diffs.items() if not v <= tol]
    if bad or Lat.H2_format != "nearest" or not np.isfinite(d["E"]):
        raise AssertionError("nearest H2 phase failed: %s" % bad)


def csc_step(r):
    """Charge self-consistency after the one-shot run r of phase 6:
    update_lattice_csc from the embedded UHF density, the next iteration's
    ConstructImpHam on the updated Fock and stored global density, and the
    DMET energy of the solved problem with the rebuilt veff."""
    import libdmet_preview_tpu_torch.dmet.hubbard as dmet
    from libdmet_preview_tpu_torch.ops import embham
    from libdmet_preview_tpu_torch.utils import timer
    Lat = r["Lat"]
    with timer.recording() as sec:
        with timer.stage("update_lattice_csc", Lat.device):
            dfock, veff = embham.update_lattice_csc(Lat, r["rdm1"],
                                                    r["basis"])
        with timer.stage("ConstructImpHam", Lat.device):
            ImpHam2, _, basis2 = dmet.ConstructImpHam(
                Lat, Lat.rdm1_lo_R, r["vcor"], matching=True, int_bath=True)
        with timer.stage("get_E_dmet", Lat.device):
            E = dmet.get_E_dmet(r["basis"], Lat, r["ImpHam"], 0.0,
                                r["solver"], solver_args={"nelec": r["nel"]},
                                veff=veff, rdm1_emb=r["rdm1"])
    ev = torch.linalg.eigvalsh(ImpHam2.H1["cd"]).cpu().numpy()
    return {"dfock": dfock, "veff": veff, "E": E, "H1 spectrum": ev,
            "neo": basis2.shape[-1],
            "fock": np.asarray(Lat.fock_lo_R)}, sec


def phase_abinitio_csc(d, c, device, card):
    """8d (ii) on the card (d) and on the CPU (c); the launches of the
    card's second ConstructImpHam are counted from 0, and its plain
    versions must stay uncalled there."""
    from libdmet_preview_tpu_torch.ops import eri_kernels as ek
    # the path: counts start at 0 here
    _sync(device)
    ek.syrk_df.launches = 0
    ek.syrk_df.cross_launches = 0
    with _counted_plain_calls() as plain_calls:
        out_d, sec = csc_step(d)
    _sync(device)
    launches = {"syrk_df": ek.syrk_df.launches,
                "syrk_df_cross": ek.syrk_df.cross_launches}
    out_c, _ = csc_step(c)
    print("abinitio CSC [%s]: max Fock change %.6e, E/cell with the rebuilt "
          "veff %.10f (one-shot %.10f); second ConstructImpHam: syrk_df "
          "launches %d, cross launches %d, plain-version calls on CUDA "
          "tensors %d"
          % (card, out_d["dfock"], out_d["E"] / AI_NLO, d["E_cell"],
             launches["syrk_df"], launches["syrk_df_cross"],
             plain_calls["cuda"]))
    _print_stages("abinitio CSC", card, sec, 1,
                  skip=("bath", "H1", "H2"))
    tol = 1e-8
    diffs = {"dfock": abs(out_d["dfock"] - out_c["dfock"]),
             "veff": float(np.abs(out_d["veff"] - out_c["veff"]).max()),
             "updated Fock": float(np.abs(out_d["fock"]
                                          - out_c["fock"]).max()),
             "H1 spectrum": float(np.abs(out_d["H1 spectrum"]
                                         - out_c["H1 spectrum"]).max()),
             "E": abs(out_d["E"] - out_c["E"])}
    for k, v in diffs.items():
        print("abinitio CSC: cuda vs cpu %-14s %.3e (tol %.0e)" % (k, v, tol))
    bad = [k for k, v in diffs.items() if not v <= tol]
    if launches != {"syrk_df": 2, "syrk_df_cross": 1} \
            or plain_calls["cuda"] != 0 or out_d["neo"] != PATH_SHAPE[1]:
        bad.append("launch counts %s, plain calls %d"
                   % (launches, plain_calls["cuda"]))
    if bad or not np.isfinite(out_d["E"]):
        raise AssertionError("abinitio CSC failed: %s" % bad)
    return launches


# ----------------------------------------------------------------------
# phase 9: coupled cluster and the k-resolved GDF path
# ----------------------------------------------------------------------

CC_AI = {"tol": 1e-10, "level_shift": 0.0, "max_cycle": 200}
CC_LOOP = {"U": 2.0, "int_bath": True, "iters": 3, "tol_fci": 1e-3}
GDF = {"ncells": AI_NCELLS, "nlo": AI_NLO, "nfac": 300, "neo": 2 * AI_NLO,
       "dense": {"ncells": 6, "nlo": 4, "nfac": 5}}
GDF_TOL = 1e-10


def run_abinitio_ccsd(r, device, **cc_kw):
    """CCSD on the embedding problem of the one-shot run r of phase 6, as a
    user's next step on that lattice: ConstructImpHam, CCSD.run from the
    folded mean-field density, transformResults with the CC solver.
    Returns the results and the stage seconds."""
    import libdmet_preview_tpu_torch.dmet.hubbard as dmet
    from libdmet_preview_tpu_torch.ops import embham
    from libdmet_preview_tpu_torch.solvers import CCSD, cc as tcc
    from libdmet_preview_tpu_torch.utils import timer
    Lat = r["Lat"]
    kw = dict(CC_AI, **cc_kw)
    with timer.recording() as sec:
        with timer.stage("ConstructImpHam", device):
            ImpHam, H1e, basis = dmet.ConstructImpHam(
                Lat, r["rho"], r["vcor"], matching=True, int_bath=True)
        rho_mf = embham.foldRho_k(Lat.rdm1_lo_k, Lat.R2k_basis(basis))
        nel = int(round(float(torch.trace(rho_mf[0])
                              + torch.trace(rho_mf[1]))))
        solver = CCSD(restricted=False, device=device, **kw)
        with timer.stage("CCSD.run", device):
            rdm1, E = solver.run(ImpHam, nelec=nel, dm0=rho_mf)
        amp, adj = dict(tcc._solve_amplitudes.last), dict(tcc._solve_adjoint.last)
        with timer.stage("energy", device):
            _, E_cell, n_cell = dmet.transformResults(
                rdm1, E, basis, ImpHam, H1e, lattice=Lat, last_dmu=0.0,
                int_bath=True, solver=solver, solver_args={"nelec": nel})
    return {"ImpHam": ImpHam, "basis": basis, "nel": nel, "solver": solver,
            "rdm1": rdm1, "E": E, "E_uhf": solver.scfsolver.e_tot,
            "E_cell": E_cell, "n_cell": n_cell, "amplitudes": amp,
            "adjoint": adj}, sec


def _seeded_amplitudes(nocc, nvir, seed, device):
    """Seeded (x1, x2) with x2 antisymmetric in (i, j) and in (a, b)."""
    rng = np.random.RandomState(seed)
    x2 = rng.randn(nocc, nocc, nvir, nvir)
    x2 = x2 - x2.transpose(1, 0, 2, 3)
    x2 = x2 - x2.transpose(0, 1, 3, 2)
    return (torch.as_tensor(rng.randn(nocc, nvir), device=device),
            torch.as_tensor(x2, device=device))


def ccsd_detail(solver, ImpHam, device, card, reps=5):
    """The stages of the CC solve once more, one by one, at the solver's
    orbitals: seconds of the spin-orbital assembly, a profiled amplitude
    solve (idle share), ms per residual and per adjoint matvec (CUDA
    events), then the residual and the matvec at those amplitudes on the
    CPU against the card.  Returns the relative differences."""
    from libdmet_preview_tpu_torch.solvers import cc as tcc
    from libdmet_preview_tpu_torch.utils.misc import as_f64
    Ca, Cb, na, nb = solver._mo
    nocc = na + nb
    opts = dict(solver._opts())
    blocks = solver._unpack(ImpHam)
    _sync(device)
    t0 = time.perf_counter()
    with torch.no_grad():
        h_so, g = tcc._mo_so_integrals(blocks[:2], blocks[2:],
                                       as_f64(Ca, device), as_f64(Cb, device),
                                       na, nb)
        W = tcc._antisymmetrize(g)
        del g
    _sync(device)
    t_ao2mo = time.perf_counter() - t0
    nso = h_so.shape[0]
    if device.type == "cuda":
        with _Profiled() as prof:
            t1, t2, conv = tcc._solve_amplitudes(h_so, W, nocc, **opts)
        idle = prof.idle
    else:
        t1, t2, conv = tcc._solve_amplitudes(h_so, W, nocc, **opts)
        idle = None
    amp = dict(tcc._solve_amplitudes.last)
    D1, D2 = tcc._denominators(h_so, W, nocc)
    mv, _ = tcc._adjoint_operators(h_so, W, nocc, t1, t2, D1, D2)
    x1, x2 = _seeded_amplitudes(nocc, nso - nocc, 17, device)

    def residual():
        with torch.no_grad():
            return tcc._residual(t1, t2, h_so, W, nocc)

    if device.type == "cuda":
        ms_res = _time_ms(residual, reps=reps)
        ms_mv = _time_ms(lambda: mv(x1, x2), reps=reps)
        print("CCSD detail [%s]: %d spin orbitals (nocc %d), W %.2f GB, t2 "
              "%.1f MB; spin-orbital assembly %.4f s; second amplitude "
              "solve (profiled): %d iterations, max|R| %.3e, idle share of "
              "the card %s; %.3f ms per residual, %.3f ms per adjoint "
              "matvec (CUDA events, %d launches queued)"
              % (card, nso, nocc, W.numel() * 8 / 1e9, t2.numel() * 8 / 1e6,
                 t_ao2mo, amp["iterations"], amp["max|R|"],
                 "not measured" if idle is None else "%.4f" % idle, ms_res,
                 ms_mv, reps))
    if not conv:
        raise AssertionError("the second amplitude solve did not converge")
    R_d, A_d = residual(), mv(x1, x2)
    scale_R = float(torch.max(torch.abs(W[:nocc, :nocc, nocc:, nocc:])))
    # the same two evaluations on the CPU
    cpu = torch.device("cpu")
    t0 = time.perf_counter()
    h_c, W_c, t1_c, t2_c = (x.to(cpu) for x in (h_so, W, t1, t2))
    with torch.no_grad():
        R_c = tcc._residual(t1_c, t2_c, h_c, W_c, nocc)
    t_res_c = time.perf_counter() - t0
    t0 = time.perf_counter()
    mv_c, _ = tcc._adjoint_operators(h_c, W_c, nocc, t1_c, t2_c, D1.to(cpu),
                                     D2.to(cpu))
    A_c = mv_c(x1.to(cpu), x2.to(cpu))
    t_mv_c = time.perf_counter() - t0
    diffs = {
        "residual (rel. to max|W_oovv|)": max(
            float(torch.max(torch.abs(a.to(cpu) - b)))
            for a, b in zip(R_d, R_c)) / scale_R,
        "adjoint matvec (rel.)": max(
            float(torch.max(torch.abs(a.to(cpu) - b)))
            for a, b in zip(A_d, A_c))
        / max(float(torch.max(torch.abs(b))) for b in A_c)}
    print("CCSD detail: on the CPU one residual %.2f s, one adjoint matvec "
          "with its graph %.2f s" % (t_res_c, t_mv_c))
    return diffs, idle


def phase_abinitio_ccsd(d, device, card):
    """9a on the card: the launches of its ConstructImpHam are counted
    from 0 and the plain versions must stay uncalled there."""
    from libdmet_preview_tpu_torch.ops.eri_kernels import syrk_df
    torch.cuda.reset_peak_memory_stats()
    # the path: counts start at 0 here
    _sync(device)
    syrk_df.launches = 0
    syrk_df.cross_launches = 0
    with _counted_plain_calls() as plain_calls:
        r, sec = run_abinitio_ccsd(d, device)
    _sync(device)
    launches = {"syrk_df": syrk_df.launches,
                "syrk_df_cross": syrk_df.cross_launches}
    peak = torch.cuda.max_memory_allocated() / 1e9
    solver, ImpHam, nel = r["solver"], r["ImpHam"], r["nel"]
    amp, adj = r["amplitudes"], r["adjoint"]
    print("abinitio CCSD [%s]: neo=%d, nelec=%d, level_shift %.2f, tol "
          "%.0e: amplitudes %d iterations, max|R| %.3e; adjoint %d matvecs, "
          "relative residual %.3e, ended by %s"
          % (card, ImpHam.norb, nel, CC_AI["level_shift"], CC_AI["tol"],
             amp["iterations"], amp["max|R|"], adj["matvecs"],
             adj["residual"], adj["branch"]))
    print("abinitio CCSD [%s]: E(CCSD) %.10f, E(UHF) %.10f, E(CCSD) - "
          "E(UHF) %.10f; E/cell %.10f (UHF one-shot %.10f), nelec/cell "
          "%.10f; peak device memory %.3f GB; syrk_df launches %d, cross "
          "launches %d, plain-version calls on CUDA tensors %d"
          % (card, r["E"], r["E_uhf"], r["E"] - r["E_uhf"], r["E_cell"],
             d["E_cell"], r["n_cell"], peak, launches["syrk_df"],
             launches["syrk_df_cross"], plain_calls["cuda"]))
    for k, v in sec.items():
        print("abinitio CCSD [%s]: stage %-36s %.6f s (%d call%s)"
              % (card, k, sum(v), len(v), "" if len(v) == 1 else "s"))
    grad = sum(sec["CC gradient (adjoint and vjp inside)"])
    print("abinitio CCSD [%s]: %.4f s per amplitude iteration, %.4f s per "
          "adjoint matvec in the solve; the gradient outside the adjoint "
          "and the residual's vjp (ao2mo backward) %.4f s"
          % (card, sum(sec["CC amplitudes"]) / amp["iterations"],
             sum(sec["CC adjoint"]) / max(adj["matvecs"], 1),
             grad - sum(sec["CC adjoint"])
             - sum(sec["CC residual vjp to integrals"])))
    rdm1 = r["rdm1"]
    checks = {
        "E from the RDMs (run_dmet_ham)": (abs(solver.run_dmet_ham(ImpHam)
                                               - r["E"]), 1e-8),
        "tr(rdm1) - nelec": (abs(float(torch.trace(rdm1[0])
                                       + torch.trace(rdm1[1])) - nel), 1e-8),
        "rdm1 asymmetry": (float(torch.max(torch.abs(
            rdm1 - rdm1.transpose(1, 2)))), 1e-12)}
    diffs, idle = ccsd_detail(solver, ImpHam, device, card)
    checks.update({"cuda vs cpu " + k: (v, 1e-10) for k, v in diffs.items()})
    bad = []
    for k, (v, tol) in checks.items():
        print("abinitio CCSD: %-44s %.3e (tol %.0e)" % (k, v, tol))
        if not v <= tol:
            bad.append(k)
    if not (amp["converged"] and adj["residual"] is not None
            and adj["residual"] <= 1e-8):
        bad.append("CCSD did not converge")
    if launches != {"syrk_df": 2, "syrk_df_cross": 1} \
            or plain_calls["cuda"] != 0 or ImpHam.norb != PATH_SHAPE[1]:
        bad.append("launch counts %s, plain calls %d"
                   % (launches, plain_calls["cuda"]))
    if not (np.isfinite(r["E_cell"]) and r["E"] < r["E_uhf"]
            and tuple(rdm1.shape) == (2, ImpHam.norb, ImpHam.norb)):
        bad.append("energy or shape")
    if bad:
        raise AssertionError("abinitio CCSD failed: %s" % bad)
    return launches


def phase_ccsd_loop(device, card, fci_res):
    """9b: run_dmet with the CCSD solver on the IB U=2 case of 7a, three
    iterations, against that FCI loop's history (fci_res) and against the
    CPU."""
    U, int_bath, n_it = CC_LOOP["U"], CC_LOOP["int_bath"], CC_LOOP["iters"]
    t0 = time.perf_counter()
    res, sec, _, _ = run_hub2d(U, int_bath, device, max_iter=n_it,
                               solver="CCSD")
    wall = time.perf_counter() - t0
    bad = []
    for h, h_f in zip(res.history, fci_res.history):
        diff = h["E"] - h_f["E"]
        print("hub2d 40x40 IB U=2 CCSD [%s]: iteration %d E/site %.10f, FCI "
              "loop %.10f, CCSD - FCI %.3e (tol %.0e), nelec/site %.8f"
              % (card, h["iter"], h["E"], h_f["E"], diff,
                 CC_LOOP["tol_fci"], h["nelec"]))
        if not abs(diff) <= CC_LOOP["tol_fci"]:
            bad.append(("E vs FCI", h["iter"]))
    outer = {k: v for k, v in sec.items() if not k.startswith("CC ")
             and not k.startswith("ERI") and not k.startswith("syrk")}
    print("hub2d 40x40 IB U=2 CCSD [%s]: %d iterations in %.2f s; per "
          "iteration: %s; inside the solves: %s"
          % (card, len(res.history), wall,
             ", ".join("%s %.4f s" % (k, sum(v) / n_it)
                       for k, v in outer.items()),
             ", ".join("%s %.4f s (%d calls)" % (k, sum(v) / n_it, len(v))
                       for k, v in sec.items() if k.startswith("CC "))))
    if len(res.history) != n_it or bad:
        raise AssertionError("CCSD loop failed: %s" % bad)
    res_d = run_hub2d(U, int_bath, device, max_iter=2, solver="CCSD")[0]
    res_c = run_hub2d(U, int_bath, torch.device("cpu"), max_iter=2,
                      solver="CCSD")[0]
    _compare_histories("hub2d 40x40 IB U=2 CCSD", res_d.history,
                       res_c.history,
                       dict.fromkeys(["E", "nelec", "last_dmu", "vcor_param",
                                      "rho_imp"], LOOP_TOL), 2)


def make_gdf_workload(device, seed=13, ncells=GDF["ncells"], nlo=GDF["nlo"],
                      nfac=GDF["nfac"]):
    """A translation-invariant ERI in factorized form, with no dense
    tensor: nfac random symmetric real-space factors l_x (nsites, nsites)
    that decay with the cell distance, NumPy from `seed`, and all ncells
    translations of each.  Returns (L, factors): the Cholesky vectors L
    (nfac * ncells, nsites, nsites) and the k-resolved factors {q: (F_re,
    F_im)} that follow analytically, F_q[k, p, a, x] = lt_x[k p, (k + q) a]
    / sqrt(ncells) with lt_x the double Fourier transform of l_x
    (make_gdf_factors' convention), tensors on `device`.  The gamma-like
    block F_0[0] is made exactly real-symmetric."""
    from libdmet_preview_tpu_torch.ops.eri_transform import _dft_phase
    rng = np.random.RandomState(seed)
    nsites = ncells * nlo
    dist = np.abs(np.arange(ncells)[:, None] - np.arange(ncells)[None, :])
    decay = 1.0 / (1.0 + np.minimum(dist, ncells - dist)) ** 2
    l = rng.randn(nfac, nsites, nsites)
    l = (0.01 * (l + l.transpose(0, 2, 1))).reshape(nfac, ncells, nlo,
                                                    ncells, nlo)
    l5 = torch.as_tensor(l * decay[None, :, None, :, None], device=device)
    L = torch.cat([torch.roll(l5, (R, R), dims=(1, 3))
                   for R in range(ncells)]).reshape(-1, nsites, nsites)
    P = _dft_phase(ncells, device)
    lt = torch.einsum("kA, xApBq -> xkpBq", P, l5.to(torch.complex128))
    lt = torch.einsum("lB, xkpBq -> xkplq", P.conj(), lt)
    k = torch.arange(ncells, device=device)
    factors = {}
    for q in range(ncells):
        F = lt[:, k, :, (k + q) % ncells, :]           # (k, x, p, a)
        F = F.permute(0, 2, 3, 1) / np.sqrt(ncells)
        F_re, F_im = F.real.contiguous(), F.imag.contiguous()
        if q == 0:
            F_re[0] = 0.5 * (F_re[0] + F_re[0].transpose(0, 1))
            F_im[0] = 0.0
        factors[q] = (F_re, F_im)
    return L, factors


def _stripe_density(rng, ncells, n, spin):
    """A real stripe with st[-R] = st[R]^T and its supercell matrix
    (spin, nsites, nsites), block (ci, cj) = st[ci - cj]."""
    st = np.stack([_tr_stripe(rng, ncells, n, 0.3) for _ in range(spin)])
    full = np.zeros((spin, ncells * n, ncells * n))
    for ci in range(ncells):
        for cj in range(ncells):
            full[:, ci * n:(ci + 1) * n, cj * n:(cj + 1) * n] = \
                st[:, (ci - cj) % ncells]
    return st, full


def _best_of(fn, device, reps=3):
    """(result, least host-clock seconds of `reps` synchronised calls)."""
    best = np.inf
    for _ in range(reps):
        _sync(device)
        t0 = time.perf_counter()
        out = fn()
        _sync(device)
        best = min(best, time.perf_counter() - t0)
    return out, best


def gdf_against_cholesky(device, ncells=GDF["ncells"], nlo=GDF["nlo"],
                         nfac=GDF["nfac"], neo=GDF["neo"]):
    """get_emb_eri_gdf and get_jk_from_gdf on `device` from the analytic
    factors against get_emb_eri_chol and J, K einsums over the Cholesky
    vectors of the same integrals.  Returns (relative differences, the
    results, the factors)."""
    from libdmet_preview_tpu_torch.ops import fourier
    from libdmet_preview_tpu_torch.ops.eri_transform import (
        _dft_phase, get_emb_eri_chol, get_emb_eri_gdf, get_emb_eri_gso_chol,
        get_emb_eri_gso_gdf)
    from libdmet_preview_tpu_torch.ops.pbc_helper import get_jk_from_gdf
    L, factors = make_gdf_workload(device, ncells=ncells, nlo=nlo, nfac=nfac)
    rng = np.random.RandomState(21)
    basis = rng.randn(1, ncells, nlo, neo) / np.sqrt(ncells * nlo)
    basis_k = fourier.R2k(torch.as_tensor(basis, device=device), (ncells,))
    ref, t_chol = _best_of(lambda: get_emb_eri_chol(L, basis), device)
    out, sec, diffs = {}, {"get_emb_eri_chol": t_chol}, {}
    scale = float(torch.max(torch.abs(ref)))
    for tr in (False, True):
        name = "get_emb_eri_gdf(tr_symm=%s)" % tr
        out[name], sec[name] = _best_of(
            lambda: get_emb_eri_gdf(factors, basis_k, ncells, nlo,
                                    tr_symm=tr, device=device), device)
        diffs[name + " vs chol"] = float(
            torch.max(torch.abs(out[name] - ref))) / scale
    # J and K of a translation-invariant density, from L in the supercell
    # and carried to k: V_k = (1/N) sum_{AB} P[k, A] conj(P[k, B]) V[A, B]
    st, dm_full = _stripe_density(rng, ncells, nlo, 2)
    dm_k = fourier.R2k(torch.as_tensor(st, device=device), (ncells,))
    (vj, vk), sec["get_jk_from_gdf"] = _best_of(
        lambda: get_jk_from_gdf(factors, dm_k, device=device), device)
    out["vj"], out["vk"] = vj, vk
    D = torch.as_tensor(dm_full, device=device)
    w = torch.einsum("xrs, trs -> tx", L, D)
    vj_full = torch.einsum("xpq, tx -> tpq", L, w)
    vk_full = torch.stack([torch.einsum("xpq, rq, xrs -> ps", L, D[t], L)
                           for t in range(2)])
    P = _dft_phase(ncells, device)

    def to_k(V):
        V6 = V.reshape(2, ncells, nlo, ncells, nlo).to(torch.complex128)
        return torch.einsum("kA, kB, tApBq -> tkpq", P, P.conj(), V6) / ncells

    for name, got, full in (("J", vj, vj_full), ("K", vk, vk_full)):
        want = to_k(full)
        diffs["get_jk_from_gdf %s vs einsum over L" % name] = float(
            torch.max(torch.abs(got - want)) / torch.max(torch.abs(want)))
    # 10c: the GSO ERI from the same factors against the Cholesky route,
    # for a random real GSO basis (1, ncells, 2 nlo, neo)
    gbasis = rng.randn(1, ncells, 2 * nlo, neo) / np.sqrt(2 * ncells * nlo)
    gbasis_k = fourier.R2k(torch.as_tensor(gbasis, device=device), (ncells,))
    ref, sec["get_emb_eri_gso_chol"] = _best_of(
        lambda: get_emb_eri_gso_chol(L, gbasis), device)
    out["gso"], sec["get_emb_eri_gso_gdf"] = _best_of(
        lambda: get_emb_eri_gso_gdf(factors, gbasis_k, ncells, nlo,
                                    device=device), device)
    diffs["get_emb_eri_gso_gdf vs gso chol"] = float(
        torch.max(torch.abs(out["gso"] - ref)) / torch.max(torch.abs(ref)))
    return diffs, out, factors, sec


def phase_gdf(device, card):
    """9c."""
    from libdmet_preview_tpu_torch import interop
    from libdmet_preview_tpu_torch.ops.cderi import read_cderi, write_cderi
    from libdmet_preview_tpu_torch.ops.eri_kernels import syrk_df
    from libdmet_preview_tpu_torch.ops.eri_transform import make_gdf_factors
    ncells, nlo = GDF["ncells"], GDF["nlo"]
    syrk_df.launches = 0
    diffs, out_d, factors, sec = gdf_against_cholesky(device)
    launches = syrk_df.launches
    nbytes = sum(f[0].numel() * 16 for f in factors.values())
    print("GDF [%s]: %d cells x %d LOs, %d factors per transfer, %.1f MB of "
          "complex factors, %d Cholesky vectors; syrk_df launches of the "
          "Cholesky side %d (3 timed calls each of get_emb_eri_chol and "
          "get_emb_eri_gso_chol)"
          % (card, ncells, nlo, GDF["nfac"], nbytes / 1e6,
             GDF["nfac"] * ncells, launches))
    for k, v in sec.items():
        print("GDF [%s]: %-32s %.6f s per call (best of 3)" % (card, k, v))
    diffs_c, out_c, _, _ = gdf_against_cholesky(torch.device("cpu"))
    for k in out_d:
        diffs["cuda vs cpu " + k] = float(
            torch.max(torch.abs(out_d[k].cpu() - out_c[k]))
            / torch.max(torch.abs(out_c[k])))
    # the CDERI archive, written and read back
    host = interop.gdf_factors_to_numpy(factors)
    kpts_scaled = np.asarray([[0.0, 0.0, f] for f in np.fft.fftfreq(ncells)])
    kpts = 2.0 * np.pi * kpts_scaled / 7.3
    with tempfile.TemporaryDirectory() as tmp:
        fname = os.path.join(tmp, "cderi.npz")
        t0 = time.perf_counter()
        write_cderi(fname, host, kpts, kpts_scaled, nlo)
        t1 = time.perf_counter()
        back = read_cderi(fname, kpts, kpts_scaled, nlo)
        t2 = time.perf_counter()
        size = os.path.getsize(fname)
    same = all(np.array_equal(back[q][i], host[q][i])
               for q in host for i in (0, 1))
    print("GDF: CDERI archive %.1f MB, write %.2f s, read %.2f s, "
          "bit-identical: %s" % (size / 1e6, t1 - t0, t2 - t1, same))
    # the analytic factors' convention against make_gdf_factors' own
    small = GDF["dense"]
    nc, n = small["ncells"], small["nlo"]
    L, fa = make_gdf_workload(device, ncells=nc, nlo=n, nfac=small["nfac"])
    eri = torch.einsum("xpq, xrs -> pqrs", L, L)
    fm = make_gdf_factors(eri, nc, n, device=device)
    worst = 0.0
    for q in fa:
        Fa = torch.complex(*fa[q]).reshape(nc * n * n, -1)
        Fm = torch.complex(*fm[q]).reshape(nc * n * n, -1)
        Ma, Mm = Fa @ Fa.conj().T, Fm @ Fm.conj().T
        worst = max(worst, float(torch.max(torch.abs(Ma - Mm))
                                 / torch.max(torch.abs(Mm))))
    diffs["dense case: M_q analytic vs make_gdf_factors"] = worst
    for k, v in diffs.items():
        print("GDF: %-52s %.3e (tol %.0e)" % (k, v, GDF_TOL))
    bad = [k for k, v in diffs.items() if not v <= GDF_TOL]
    bad += [k for k, v in diffs_c.items() if not v <= GDF_TOL]
    if not same:
        bad.append("CDERI round trip")
    if launches < 1 or tuple(out_d["vk"].shape) != (2, ncells, nlo, nlo):
        bad.append("launches or shapes")
    if bad:
        raise AssertionError("GDF phase failed: %s" % bad)


# ----------------------------------------------------------------------
# phase 10: the superconducting / GSO formalism on the card
# ----------------------------------------------------------------------

DWAVE = {"size": (4, 4), "imp": (2, 2), "U": 4.0, "filling": 0.4375,
         "max_iter": 20, "anchor": -0.9352863316, "kappa_x": 0.0952150,
         "x_bonds": [(0, 2), (1, 3)], "y_bonds": [(0, 1), (2, 3)]}
DOPED = {"size": (60, 60), "imp": (2, 2), "U": 6.0, "filling": 0.4,
         "beta": 1000.0, "max_iter": 30, "anchor": -1.001725641814,
         "tol": 2e-4, "compare": 2}
GSO_AI_SHAPE = (AI_NAUX, 4 * AI_NLO)   # (naux, neo) of the GSO ERI


def _sc_counts_reset(solver):
    from libdmet_preview_tpu_torch.ops import spinless
    from libdmet_preview_tpu_torch.ops.fit import _cg_engine
    spinless.GHF.calls = 0
    _cg_engine.steps = 0
    solver.n_run = solver.n_sigma = 0


def _sc_counts(solver, n_it):
    """GHF diagonalizations, FCI.run calls, sigma builds and CG steps per
    DMET iteration since _sc_counts_reset."""
    from libdmet_preview_tpu_torch.ops import spinless
    from libdmet_preview_tpu_torch.ops.fit import _cg_engine
    return {"GHF calls": spinless.GHF.calls / n_it,
            "FCI.run calls": solver.n_run / n_it,
            "sigma builds": solver.n_sigma / n_it,
            "CG steps": _cg_engine.steps / n_it}


def _print_sc_run(label, card, res, sec, counts):
    n_it = len(res.history)
    for h in res.history:
        print("%s [%s]: iteration %d E/site %.12f nelec/site %.10f mu %.8f "
              "dmu %.8f fit err %.3e dVcor %.3e"
              % (label, card, h["iter"], h["E"], h["nelec"], h["mu"],
                 h["dmu"], h["fit_err"], h["dVcor"]))
    _print_stages(label, card, sec, n_it)
    print("%s [%s]: per iteration %s" % (label, card, ", ".join(
        "%.1f %s" % (v, k) for k, v in counts.items())))


def run_dwave(device, max_iter=DWAVE["max_iter"]):
    """10a: run_dmet_sc on the repulsive doped d-wave 4 x 4 anchor."""
    import itertools as it
    from libdmet_preview_tpu_torch.dmet import hubbard_bcs as bcs
    from libdmet_preview_tpu_torch.dmet.loop import run_dmet_sc
    from libdmet_preview_tpu_torch.solvers import FCI
    from libdmet_preview_tpu_torch.utils import timer
    U, filling = DWAVE["U"], DWAVE["filling"]
    Lat = bcs.SquareLattice(*DWAVE["size"], *DWAVE["imp"])
    Lat.set_Ham(bcs.Ham(Lat, U), use_hcore_as_emb_ham=True, device=device)
    nao = Lat.nscsites
    vcor = bcs.VcorSC(nao)
    p0 = np.zeros(vcor.length())
    nV = nao * (nao + 1) // 2
    for idx, (i, j) in enumerate(it.combinations_with_replacement(range(nao),
                                                                  2)):
        if i == j:
            p0[idx] = U * filling
        if (i, j) in DWAVE["x_bonds"]:
            p0[nV + idx] = 0.1
        if (i, j) in DWAVE["y_bonds"]:
            p0[nV + idx] = -0.1
    vcor.update(p0)
    solver = FCI(restricted=True, ghf=True, tol=1e-10, device=device)
    _sc_counts_reset(solver)
    with timer.recording() as sec:
        res = run_dmet_sc(Lat, vcor, filling, solver=solver,
                          max_iter=max_iter, mu0=U * filling, mixing=0.5,
                          diis_start=10, conv_tol_E=1e-7, conv_tol_vcor=1e-6,
                          thrnelec=1e-6)
    return res, sec, _sc_counts(solver, len(res.history))


def phase_dwave(device, card):
    """10a."""
    from libdmet_preview_tpu_torch.ops.spinless import extract_rdm
    t0 = time.perf_counter()
    res, sec, counts = run_dwave(device)
    label = "d-wave SC-DMET SquareLattice(4, 4, 2, 2) U=4"
    print("%s [%s]: %d iterations in %.2f s, converged %s, E/site %.12f "
          "(anchor %.10f), nelec/site %.10f"
          % (label, card, len(res.history), time.perf_counter() - t0,
             res.converged, res.e_per_site, DWAVE["anchor"], res.nelec_imp))
    _print_sc_run(label, card, res, sec, counts)
    kap = extract_rdm(res.rho_imp)[2]
    kx = np.mean([kap[i, j] for i, j in DWAVE["x_bonds"]])
    ky = np.mean([kap[i, j] for i, j in DWAVE["y_bonds"]])
    checks = {"E/site - anchor": (abs(res.e_per_site - DWAVE["anchor"]),
                                  1e-6),
              "|kappa_x| - 0.0952150": (abs(abs(kx) - DWAVE["kappa_x"]),
                                        1e-4),
              "|kappa_x| - |kappa_y|": (abs(abs(kx) - abs(ky)), 1e-5),
              "nelec/site - 0.875": (abs(res.nelec_imp
                                         - 2 * DWAVE["filling"]), 1e-4)}
    print("%s [%s]: kappa_x %.8f kappa_y %.8f" % (label, card, kx, ky))
    bad = [k for k, (v, tol) in checks.items() if not v <= tol]
    for k, (v, tol) in checks.items():
        print("%s: %-24s %.3e (tol %.0e)" % (label, k, v, tol))
    if not (res.converged and kx * ky < 0) or bad:
        raise AssertionError("%s failed: converged %s, kx*ky %.3e, %s"
                             % (label, res.converged, kx * ky, bad))


def _doped_setup(device, size=DOPED["size"]):
    import libdmet_preview_tpu_torch.dmet.hubbard as dmet
    from libdmet_preview_tpu_torch.solvers import FCI
    U, filling = DOPED["U"], DOPED["filling"]
    Lat = dmet.SquareLattice(*size, *DOPED["imp"])
    Lat.set_Ham(dmet.Ham(Lat, U), use_hcore_as_emb_ham=True, device=device)
    vcor = dmet.AFInitGuess(DOPED["imp"], U, filling, rand=0.001,
                            bogoliubov=True, bogo_res=True)
    return Lat, vcor, FCI(restricted=True, ghf=True, tol=1e-10,
                          device=device)


def _doped_run(Lat, vcor, solver, max_iter, mu0=None, dmu0=0.0):
    from libdmet_preview_tpu_torch.dmet.loop import run_dmet_sc
    return run_dmet_sc(Lat, vcor, DOPED["filling"], solver=solver,
                       max_iter=max_iter,
                       mu0=DOPED["U"] * DOPED["filling"] if mu0 is None
                       else mu0, dmu0=dmu0, thrnelec=1e-6,
                       beta=DOPED["beta"], localize_bath="scdm",
                       trace_start=3, conv_tol_vcor=5e-5)


def replay_sc_iterations(history, device, n, size=DOPED["size"]):
    """Each of the first n iterations of a doped run, run again on
    `device` from the state that iteration started from (its vcor, mu0 and
    dmu0); returns the records."""
    Lat, vcor, solver = _doped_setup(device, size)
    out = []
    for h in history[:n]:
        vcor.update(h["vcor_start"])
        res = _doped_run(Lat, vcor, solver, 1, mu0=h["mu_start"],
                         dmu0=h["dmu_start"])
        out.append(dict(res.history[0], iter=h["iter"]))
    return out


def phase_doped(device, card, size=DOPED["size"]):
    """10b: the doped spinless anchor at full width on the card, its first
    iterations replayed on the CPU, and the idle share of one
    iteration."""
    from libdmet_preview_tpu_torch.utils import timer
    label = "doped spinless SC-DMET SquareLattice(%d, %d, 2, 2) U=6" % size
    card_run = device.type == "cuda"
    if card_run:
        torch.cuda.reset_peak_memory_stats(device)
    Lat, vcor, solver = _doped_setup(device, size)
    _sc_counts_reset(solver)
    t0 = time.perf_counter()
    with timer.recording() as sec:
        res = _doped_run(Lat, vcor, solver, DOPED["max_iter"])
    total = time.perf_counter() - t0
    n_it = len(res.history)
    peak = torch.cuda.max_memory_allocated(device) / 1e9 if card_run \
        else float("nan")
    print("%s [%s]: %d iterations in %.2f s (%.3f s per iteration), "
          "converged %s, E/site %.12f (anchor %.12f), nelec/site %.10f, "
          "peak device memory %.3f GB"
          % (label, card, n_it, total, total / n_it, res.converged,
             res.e_per_site, DOPED["anchor"], res.nelec_imp, peak))
    _print_sc_run(label, card, res, sec, _sc_counts(solver, n_it))
    t0 = time.perf_counter()
    cpu_hist = replay_sc_iterations(res.history, torch.device("cpu"),
                                    DOPED["compare"], size)
    print("%s: %d iterations replayed on the CPU in %.1f s"
          % (label, len(cpu_hist), time.perf_counter() - t0))
    _compare_histories(label, res.history, cpu_hist,
                        {"E": LOOP_TOL, "nelec": LOOP_TOL, "dmu": LOOP_TOL,
                         "rho_imp": LOOP_TOL}, DOPED["compare"])

    def one_iteration():
        L1, v1, s1 = _doped_setup(device, size)
        v1.update(res.history[-1]["vcor_start"])
        _doped_run(L1, v1, s1, 1, mu0=res.history[-1]["mu_start"],
                   dmu0=res.history[-1]["dmu_start"])

    idle = _idle_share(one_iteration) if card_run else None
    print("%s [%s]: idle share of the card over one iteration: %s"
          % (label, card, "not measured (the profiler gave no device time)"
             if idle is None else "%.4f" % idle))
    bad = []
    if not res.converged:
        bad.append("not converged in %d iterations" % n_it)
    if not abs(res.e_per_site - DOPED["anchor"]) < DOPED["tol"]:
        bad.append("E/site %.12f" % res.e_per_site)
    if not abs(res.nelec_imp - 2 * DOPED["filling"]) < 1e-4:
        bad.append("nelec/site %.10f" % res.nelec_imp)
    if bad:
        raise AssertionError("%s failed: %s" % (label, bad))


def run_gso_ib(Lat, device):
    """10c: GSOHam(int_bath=True) -> GHartreeFock -> ConstructImpHam ->
    get_H_dmet_ib on the folded mean-field GSO density, on `device` (the
    lattice's); returns the results and the stage seconds."""
    from libdmet_preview_tpu_torch.dmet import hubbard_gso as gso
    from libdmet_preview_tpu_torch.ops import embham, spinless
    from libdmet_preview_tpu_torch.utils import timer
    with timer.recording() as sec:
        with timer.stage("GSOHam (GV1 normal ordering)", device):
            gham = gso.GSOHam(Lat, int_bath=True)
        with timer.stage("GHartreeFock", device):
            GRho, mu, res = gso.GHartreeFock(gham, AI_FILLING, mu0=0.0)
        with timer.stage("ConstructImpHam", device):
            ImpHam, _, basis = gso.ConstructImpHam(gham, GRho, mu,
                                                   GRho_k=res["rho_k"])
        with timer.stage("energy functional", device):
            G = embham.foldRho_k(res["rho_k"], Lat.R2k_basis(basis))[0]
            H0 = float(Lat.getH0()) + gham.GH0 + gham.GV0
            Hs = spinless.get_H_dmet_ib(Lat, basis, gham.GH1_full_k,
                                        gham.JK_core, ImpHam, H0)
            h1, g = Hs.H1["cd"][0], Hs.H2["ccdd"][0]
            E_mf = float(torch.einsum("pq, qp", h1, G)
                         + 0.5 * (torch.einsum("pqrs, qp, sr", g, G, G)
                                  - torch.einsum("pqrs, sp, qr", g, G, G))) \
                + H0
    return {"gham": gham, "mu": mu, "ImpHam": ImpHam, "basis": basis,
            "E_mf": E_mf, "n_phys": res["nelec_phys"],
            "H1 spectrum": torch.linalg.eigvalsh(ImpHam.H1["cd"][0]),
            "JK_core spectrum": torch.linalg.eigvalsh(gham.JK_core)}, sec


def phase_gso_abinitio(d, c, device, card):
    """10c on phase 6's lattices (the card's and the CPU's): exactly one
    symmetric syrk launch and no cross launch in ConstructImpHam, no
    plain-version call on the card; the GSO ERI against the einsum of the
    rotated species difference; the card against the CPU; the symmetric
    kernel timed at the GSO shape.  Returns (launches, timing record,
    max_abs_err of the kernel at that shape)."""
    from libdmet_preview_tpu_torch.ops.eri_kernels import (syrk_df,
                                                           syrk_df_plain)
    from libdmet_preview_tpu_torch.ops.eri_transform import _rotate_chol
    label = "abinitio GSO IB (%d cells x %d LOs, naux=%d)" % (
        AI_NCELLS, AI_NLO, AI_NAUX)
    _sync(device)
    syrk_df.launches = 0
    syrk_df.cross_launches = 0
    torch.cuda.reset_peak_memory_stats(device)
    with _counted_plain_calls() as plain_calls:
        r, sec = run_gso_ib(d["Lat"], device)
    _sync(device)
    launches = {"syrk_df": syrk_df.launches,
                "syrk_df_cross": syrk_df.cross_launches}
    peak = torch.cuda.max_memory_allocated(device) / 1e9
    neo = r["basis"].shape[-1]
    print("%s [%s]: neo=%d, mu %.10f, physical electrons per cell %.10f, "
          "E_mf %.10f; syrk_df launches %d, cross launches %d, plain-version "
          "calls on CUDA tensors %d; peak device memory %.3f GB"
          % (label, card, neo, r["mu"], r["n_phys"], r["E_mf"],
             launches["syrk_df"], launches["syrk_df_cross"],
             plain_calls["cuda"], peak))
    for k, v in sec.items():
        print("%s [%s]: stage %-32s %.6f s (%d call%s)"
              % (label, card, k, sum(v), len(v), "" if len(v) == 1 else "s"))
    # the GSO ERI against the einsum of the rotated species difference
    g = r["ImpHam"].H2["ccdd"][0]
    B = r["basis"][0]
    nao = B.shape[1] // 2
    L = d["Lat"].getH2()
    Ld = _rotate_chol(L, B[:, :nao].reshape(-1, neo)) \
        - _rotate_chol(L, B[:, nao:].reshape(-1, neo))
    ref = torch.einsum("xij, xkl -> ijkl", Ld, Ld)
    rel = float(torch.max(torch.abs(g - ref)) / torch.max(torch.abs(ref)))
    del ref, Ld
    M = g.reshape(neo * neo, neo * neo)
    sym = torch.equal(M, M.T)
    print("%s [%s]: GSO ERI vs einsum(Ld, Ld) rel %.3e (tol 1e-12), exactly "
          "symmetric %s" % (label, card, rel, sym))
    rc, sec_c = run_gso_ib(c["Lat"], torch.device("cpu"))
    for k, v in sec_c.items():
        print("%s [CPU]: stage %-32s %.6f s" % (label, k, sum(v)))
    diffs = {"mu": abs(r["mu"] - rc["mu"]), "E_mf": abs(r["E_mf"] - rc["E_mf"])}
    for k in ("H1 spectrum", "JK_core spectrum"):
        diffs[k] = float(torch.max(torch.abs(r[k].cpu() - rc[k])))
    Bd = r["basis"].reshape(-1, neo)
    Bc = rc["basis"].reshape(-1, neo).to(device)
    diffs["bath projector"] = float(torch.max(torch.abs(Bd @ Bd.T
                                                        - Bc @ Bc.T)))
    for k, v in diffs.items():
        print("%s: cuda vs cpu %-18s %.3e (tol 1e-8)" % (label, k, v))
    bad = [k for k, v in diffs.items() if not v <= 1e-8]
    if not rel <= 1e-12 or not sym:
        bad.append("GSO ERI vs einsum")
    if launches != {"syrk_df": 1, "syrk_df_cross": 0} \
            or plain_calls["cuda"] != 0 or neo != GSO_AI_SHAPE[1]:
        bad.append("launches %s, plain calls %d, neo %d"
                   % (launches, plain_calls["cuda"], neo))
    if not np.isfinite(r["E_mf"]):
        bad.append("non-finite E_mf")
    del r, rc
    # the symmetric kernel at the GSO shape against its plain version
    naux, neo = GSO_AI_SHAPE
    F = _packed_factors(naux, neo, seed=neo, device=device)
    err = _check_kernel("syrk_df (naux=%d, neo=%d)" % (naux, neo),
                        syrk_df(F), syrk_df_plain(F), symmetric=True)
    ms = _time_ms(lambda: syrk_df(F))
    plain_ms = _time_ms(lambda: syrk_df_plain(F))
    npair = neo * (neo + 1) // 2
    bound_ms, bound_by, flops = kernel_bound("tri", naux, npair)
    print("syrk_df at the GSO shape (naux=%d, neo=%d, npair=%d) [%s]: %.4f "
          "ms (%.2f TFLOP/s), cuBLAS F^T F %.4f ms, kernel/cuBLAS %.3f, "
          "bound %.4f ms by %s (%.1f%% of bound)"
          % (naux, neo, npair, card, ms, flops / ms / 1e9, plain_ms,
             ms / plain_ms, bound_ms, bound_by, 100.0 * bound_ms / ms))
    if bad:
        raise AssertionError("%s failed: %s" % (label, bad))
    return launches, {"shape": [naux, neo], "launches": launches["syrk_df"],
                      "ms": ms, "plain_ms": plain_ms, "library_ms": plain_ms,
                      "bound_ms": bound_ms, "bound_by": bound_by}, err


def main():
    t_start = time.perf_counter()
    device, card = phase_device()
    phase_build()
    max_abs, times = phase_kernels(device)
    phase_split_scan(device)
    launches_bench, ms_iter = phase_bench(device)
    phase_hubbard(device)
    launches_ai, run_d, run_c = phase_abinitio_uhf(device)
    with _quiet():
        launches_cc = phase_abinitio_ccsd(run_d, device, card)
        launches_gso, at_gso, err_gso = phase_gso_abinitio(run_d, run_c,
                                                           device, card)
        launches_csc = phase_abinitio_csc(run_d, run_c, device, card)
        del run_d, run_c
        hub2d = phase_dmet_loop_hubbard(device, card)
        phase_ccsd_loop(device, card, hub2d["IB U=2"])
        phase_gdf(device, card)
        launches_chol, err_chol, times_chol = phase_dmet_loop_cholesky(
            device, card)
        phase_pdmet(device, card)
        phase_ib_fock(device, card)
        phase_nearest(device, card)
        phase_three_band(device, card)
        phase_dwave(device, card)
        phase_doped(device, card)
    max_abs["syrk_df"] = max(max_abs["syrk_df"], err_chol, err_gso)
    print("card: %s" % card)
    naux, neo = PATH_SHAPE
    npair = neo * (neo + 1) // 2
    kernels = []
    for name, kind, replaces, launches in [
            ("syrk_df", "tri", "libdmet_preview_tpu/ops/pallas_eri.py:163",
             {"bench": launches_bench,
              "abinitio_uhf": launches_ai["syrk_df"],
              "abinitio_csc": launches_csc["syrk_df"],
              "abinitio_ccsd": launches_cc["syrk_df"],
              "dmet_loop_cholesky": launches_chol,
              "abinitio_gso": launches_gso["syrk_df"]}),
            ("syrk_df_cross", "cross",
             "libdmet_preview_tpu/ops/pallas_eri.py:45",
             {"abinitio_uhf": launches_ai["syrk_df_cross"],
              "abinitio_csc": launches_csc["syrk_df_cross"],
              "abinitio_ccsd": launches_cc["syrk_df_cross"],
              "abinitio_gso": launches_gso["syrk_df_cross"]})]:
        ms, plain_ms = times[(name, naux, neo)]
        bound_ms, bound_by, _ = kernel_bound(kind, naux, npair)
        print("%s at the path shape (naux=%d, neo=%d): kernel/cuBLAS %.3f, "
              "%.1f%% of bound" % (name, naux, neo, ms / plain_ms,
                                   100.0 * bound_ms / ms))
        kernels.append({
            "name": name, "route": "cuda",
            "source": "libdmet_preview_tpu_torch/csrc/syrk_df.cu",
            "replaces": replaces,
            "launches": sum(launches.values()),
            "launches_by_path": launches,
            "max_abs_err": max_abs[name],
            "shape": [naux, neo],
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": plain_ms, "design": DESIGN,
            "vs_library": ms / plain_ms,
            "share_of_bound": bound_ms / ms})
    # the symmetric kernel at the shape the DMET loop's path gives it
    naux_c, neo_c = CHOL_SHAPE
    bound_c, by_c, _ = kernel_bound("tri", naux_c, neo_c * (neo_c + 1) // 2)
    kernels[0]["at_dmet_loop_shape"] = {
        "shape": [naux_c, neo_c], "launches": launches_chol,
        "ms": times_chol[0], "plain_ms": times_chol[1],
        "library_ms": times_chol[1], "bound_ms": bound_c, "bound_by": by_c}
    # the symmetric kernel at the shape the ab initio GSO path gives it
    kernels[0]["at_gso_shape"] = at_gso
    print("chip_smoke total: %.1f s [%s]"
          % (time.perf_counter() - t_start, card))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
