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
  5. the 1D Hubbard flagship through the port's entry point
     (libdmet_preview_tpu_torch.entry.entry: ChainLattice(18, 2), U=4,
     PMInitGuess, 20 fit steps): its step on the card against the CPU at
     its own (p0, rho_target) and at a target the fit has work on, timed
     by utils.logger.Timer on the card; the vcor's show(); the lattice's
     FFTtoK / FFTtoT on the flagship and the 40 x 40 lattice, card vs CPU
     (1e-12) and back to the stripe; entry.dmet_forward at the flagship
     (9 cells x 2 sites, beta = 1000) card vs CPU: E_mf, rho_R, fit_err,
     embH1's impurity block and spectrum (1e-10; the SVD bath's column
     gauge is free);
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
         iteration (torch.profiler); the first REPLAY iterations of the
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
         REPLAY iterations of the first case on the card against the CPU
         (E, nelec, accumulated dmu, rho_glob: 1e-8);
     8b. the finite-temperature Fock-embedding loop with the whole-lattice
         vcor fit: 6 x 6, U=8, 2 x 2 impurity, beta=1000,
         use_hcore_as_emb_ham=False, HF_scf, FitVcor(MaxIter1=0,
         MaxIter2=300, imp_fit=True, BFGS=True) to convergence (E/site
         -0.51685 at 1e-4), with the fit's evaluations and seconds per
         iteration; then the same FitVcorFull once on the 40 x 40 lattice
         of 8a (800 Hermitian 4 x 4 blocks per evaluation, 60
         iterations): seconds per evaluation, and the gradient against
         central differences in three random directions (1e-6 relative);
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
         within 1e-3 of the FCI loop's same iteration in 7a; the first
         REPLAY iterations on the card against the CPU (1e-8);
     9c. the GDF path at the ab initio width: 300 random symmetric
         real-space factors on 8 cells x 30 LOs, decaying with the cell
         distance, and all 8 translations of each (2400 Cholesky
         vectors); their k-resolved factors analytically (a double
         Fourier transform, 300 per momentum transfer);
         get_emb_eri_gdf (with and without tr_symm) against
         get_emb_eri_chol of the same integrals for a random real (1, 8,
         30, 60) basis (1e-10 relative); get_jk_from_gdf against J, K
         from einsums over the Cholesky vectors (1e-10); both on the card
         against the CPU (1e-10); on a 6-cell, 4-orbital dense case
         make_gdf_factors' M_q = F F^H against the analytic factors'
         (1e-10), and write_cderi -> read_cderi of those factors
         bit-identical.

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
          iteration, peak memory; the first REPLAY iterations replayed on the
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
 11. ab initio lattices built on the card from the engine arrays shipped
     in libdmet_preview_tpu_torch/data/ (the periodic H chain, 3 k-points,
     3-21G):
     11a. the self-consistent interacting-bath FCI loop of
          tests/test_hchain_pbc.py:106-158 (RHartreeFock ->
          update_ham_dense -> ConstructImpHam(int_bath=True) -> MuSolver
          -> FCI -> transformResults -> FitVcor -> trace fix -> DIIS):
          E/cell within 1e-4 of -1.243085261466 and 1e-6 of the JAX
          package's value on the same integrals; exactly one symmetric
          syrk launch per iteration, none of the cross kernel, no
          plain-version call on the card; the last iteration replayed on
          the CPU from the card's state (E, nelec, dmu, fit error: 1e-8);
          stage seconds and the idle share of one iteration;
     11b. the CC-family anchors (CCSD, CCD, BCCSD) and the FCI protocol
          variants (csc_glob, det, idem_fit, E1 from the global rdm) of
          tests/test_anchors.py:24-112, each within its anchor's
          tolerance and 1e-5 of the JAX package's value;
     11c. the UHF non-interacting bath (make_hchain_pbc_lattice_uhf +
          update_ham_dense_uhf, tests/test_hchain_pbc.py:161-198): within
          5e-5 of -1.238248899089, AFM order max |rho_a - rho_b| > 0.3, no
          syrk launch;
     11d. kscf_stripe_hf and one update_ham_eriF at make_diamond_lattice3's
          width (3x3x3 cells x 8 orbitals, 8 electrons per cell) on random
          translation-symmetric integrals (eriF from random real-space DF
          factors and all their translations, 645 MB): card vs CPU, E 1e-10
          and density stripes 1e-8; the same construction at 2x2x1 against
          a dense supercell RHF (1e-8); s per SCF iteration, peak memory,
          idle share;
     11e. the tight-binding bands of tests/test_wannier.py in the
          eigensolver's gauge: max_loc_U on the SSH chain and the 2D
          square case scrambled by the test's random gauges, max_loc from
          a projected start on a 3D cubic analogue on a 6x6x6 mesh; each
          run stopped by its gradient test (converged), Omega card vs CPU
          1e-8, the complete-basis cases at their exact minimum 0 (1e-8)
          and the occupied SSH band at Omega_I;
     then the symmetric kernel at the H chain's (naux, neo), timed.
 12. the CAS solver family, tailored CC, OO-CCD / OO-MP2, static GW and
     the external-solver bridges:
     12a. (run after 11) the JAX suite's oracles at its own sizes, on the
          card and on the CPU (each 1e-8 apart): CASCI(4, 4) == FCI (1e-9),
          CASSCF(4, 4) == FCI (1e-8), the UCASSCF anchors -2.1477353252387
          (FCI, 1e-8) and -1.8841957321182 (1e-6), the GCASSCF anchors
          -8.42442890089805 and -8.188240873805, OOCCD == FCI at two
          electrons (restricted, unrestricted, GHF), TCCSD on the full CAS
          == FCI and TCCSD(4, 4) closer to FCI than CCSD on the 6-site U=4
          chain, get_vsig_emb's bare limit == -K; the DMRG bridge (with
          the JAX suite's NumPy fake Block binary: BlockDMRG, DMRG-CI,
          GSO DMRG-SCF), the FCIDUMP bridge and the SHCI / AFQMC bridges
          with fake binaries written to a temporary directory;
     12b. (run right after 9a) phase 6's embedding problem (neo = 60, 120
          spin orbitals): ConstructImpHam (exactly 2 symmetric + 1 cross
          syrk launches, no plain-version call on the card) ->
          UCASCI(12, 12) (853,776 determinants) and UTCCSD(8, 8) (CCSD at
          120 spin orbitals with the CAS block frozen, the masked
          adjoint), each from phase 6's converged UHF density and through
          transformResults, run_dmet_ham == E (1e-8); get_vsig_emb on the
          embedding UHF Fock and ERI, its bare limit == -K (1e-10
          relative); stage seconds, sigma builds, amplitude iterations,
          adjoint matvecs and solves, peak memory, the idle share of a
          cold active FCI; UCASCI's active-space FCI on the card's CAS
          Hamiltonian on the card and the CPU, each Davidson started from
          the card's CI vector (E 1e-8, rdm1 1e-7); UTCCSD(4, 4) on
          the card and the CPU at phase 6's construction cut to 4 cells x
          12 LOs (48 spin orbitals; the same tolerances);
     12c. (run after 12a) the H-chain interacting-bath loop of 11a with
          CASCI on the whole embedding space (6 orbitals, 4 electrons):
          one symmetric syrk launch per iteration, every iteration equal
          to FCI from the same state on the card (1e-8), the JAX FCI
          value (1e-6); with CASSCF(4, 4): converged, its orbital work
          (Newton minimizations, gradients, HVPs), the last iteration
          replayed on the CPU (1e-8).

 13. the molecular integral engine, KS-DFT and DFT-in-DMET (ints/,
     solvers/ksdft, ops/dftu, models/abinitio.attach_ks, the xc double
     counting of ops/embham._emb_H1), on the H ring of workloads.DFT_RING
     (2 atoms per cell, 3-21G, IAO + PAO against STO-6G, 4 LOs per cell):
     13a. the JAX suite's DFT oracles at their own sizes on the card and on
          the CPU (tests/test_dft.py, tests/test_dftu_ks.py, the derivative
          oracle and the H2O / STO-3G anchor of tests/test_md.py, the GW
          bare-exchange limit), each at its test's tolerance, card - CPU
          <= 1e-8;
     13b/c at H22 (11 cells): attach_ks with LSDA and with PBE (RKS on the
          default 60 x 12 x 24 grid per atom), then the DFT-in-DMET loop
          of tests/test_dft.py:139-182 (RHartreeFock -> ConstructImpHam(
          int_bath=True) -> MuSolver -> FCI -> transformResults) with
          exactly one symmetric syrk launch, no cross launch and no
          plain-version call on the card: the KS energy (1e-8) and the
          grid's electron count (1e-10), and the loop's E per cell,
          nelecImp and rhoImp against the JAX package's values recorded in
          workloads.DFT_JAX (1e-8, or the embedding H1's asymmetry where
          that is larger: it floors the FCI residual);
     13b/c at H34 (17 cells, nao = 68, 587,520 grid points; H50 with 864,000
          points before the oxide phase needed the script's time), full
          width:
          the native ERI core loaded; the same runs with their SCF
          iterations, stage seconds, seconds per XC evaluation and per SCF
          iteration, peak device memory and the idle share of one
          iteration; the CPU's Becke weights against the card's (1e-14
          relative), one Fock rebuilt on the CPU from the card's converged
          density for LSDA and PBE (1e-10 relative), RKS(None, hyb=1)
          against the lattice builder's RHF (1e-8), each loop's last
          MuSolver step replayed on the CPU from the card's state (1e-8, or
          the H1 asymmetry) and the card's idle share over that step, the
          HF-limit identity of the double counting (1e-11), and the
          symmetric kernel timed at the loop's (naux, neo).
 14. the periodic Gaussian cell (ints/pbc, gth, basisopt, the native
     short-range core): 14a the JAX suite's periodic-engine oracles on the
     card and the CPU; 14b the reference's H chain built by the port's
     cell through the JAX package's call form make_hchain_pbc_lattice(
     nk=3, ...), its integrals against the JAX engine's file and its IB
     FCI loop; 14c the nk = 6 chain and the 3 x 3 x 3 H2 crystal.
 15. the streamed embedding-ERI drivers and diamond (ints/pbc's aft / fft
     / rs drivers, the 'aft' H2 format, models/abinitio's diamond
     factories, the threaded native short-range core; the SR ERI rows of
     15b's and 15c's cells are made in a background thread at nice 19,
     DiamondRows, from the end of 12b on, and phase 15 builds its
     lattices from those cells):
     15a. tests/test_pbc_3d.py's driver oracles (workloads.
          emb_driver_oracles) on the card and the CPU, card - CPU <= 1e-12
          relative;
     15b. make_diamond_lattice(nk=2) at the JAX package's defaults: E_hf
          (1e-8) and the one-shot DMET(CCSD) (1e-6) against workloads.
          DIAMOND_JAX, the mean-field (1e-7) and IB-HF (1e-6) identities,
          exactly one symmetric syrk launch, no cross launch and no
          plain-version call; the kernel timed at the path's shape;
     15c. make_diamond_lattice3 on DIAMOND_MESH (2 x 2 x 2: the 3 x 3 x 3
          build is beyond the phase's budget) at precision 1e-12 through
          tests/test_diamond333.py's protocol (workloads.run_diamond_dmet):
          the identities, one electron per site, no syrk launch, E_hf
          (1e-8), the one-shot (1e-6) and the converged loop (1e-4)
          against the values the phase recorded on the card
          (workloads.DIAMOND_RECORDED; at 3 x 3 x 3 also the loop at its
          JAX anchor, 5e-4); stage seconds (1-body, nuclear LR / SR /
          GTH, SR rows at omega 1.0 and 0.5, Grams, k-HF, Lowdin), seconds
          per iteration and stage, peak memory, the idle share of one
          iteration, and one get_emb_eri_rs replayed on the CPU from the
          same SR rows and G column (1e-12 relative).

 16. the AFM oxides (models/abinitio's make_nio_afm_lattice,
     make_nio_fm_lattice, make_cuo2_afm_lattice; GTH-PADE with d
     projectors, the tpu-szv basis, the range-separated cell ERI, the
     supercell UHF, Lowdin LOs, 30 LOs per cell) at the JAX suite's nk = 2,
     precision 1e-10, the integrals cached in a fresh build/oxide_cache_*
     directory (removed at the end of the phase, passed or not):
     16a. NiO AFM through tests/test_nio_afm.py:35-88: staggered moments
          summing to < 1e-4, the lattice mean field == the UHF (2e-4),
          ConstructImpHam(matching=True, int_bath=True) with exactly 2
          symmetric + 1 cross syrk launches and no plain-version call on
          the card, the IB-HF identity (5e-4), MP2 E_corr in (-3, -0.02);
          E_hf (1e-9) and the moments (1e-6) against the JAX package's on
          the port's integrals (workloads.OXIDE_JAX_NK2), |m| above the
          floor set from them (0.96; the JAX suite's 1.2 and its anchor
          predate the range-separated ERI); E_hf, the moments, E_ibhf and
          MP2 against the values the card recorded (workloads.
          OXIDE_RECORDED); stage seconds and the idle share of one
          ConstructImpHam;
     16d. one of 16a's embedding ERIs written through get_emb_eri_chol(
          outcore=) to an HDF5 file and read back against the in-core one
          (1e-14), where the host has h5py (it says so where not);
     16b. NiO FM on 16a's cached integrals (tests/test_nio_afm.py:91-149):
          n_alpha - n_beta = 8, aligned moments, the spin-resolved mean
          field and SCFSolver(Sz=4)'s IB identity, 2 + 1 launches, E_hf
          and the moments against the JAX package's, |m| above 0.99, the
          recorded values;
     16c. the CuO2 plane (tests/test_cuo2_afm.py:27-72): E_hf at its anchor
          (5e-6) and the recorded values, moments beyond +-0.25, the
          mean-field (5e-5) and IB (1e-5) identities, 2 + 1 launches; the
          mean field and ConstructImpHam replayed on the CPU from the
          same lattice operators and factors (1e-8 on gauge-invariant
          quantities);
     then both kernels timed at the oxide path's (naux, neo) beside cuBLAS
     and their bounds, and the peak device memory of the phase.

  17. the scale-out layer (parallel/kmesh over torch.distributed, the
     dry run of parallel/dryrun), every sharded function against the
     serial port path (workloads.kmesh_cases):
     17a. an NCCL group of one rank in this process (HashStore):
          hf_rho_sharded, transform_h1_sharded and the vcor gradient
          through the sharded Fermi density on SquareLattice(40, 40, 2,
          2) (1e-8); get_emb_eri_chol_sharded on phase 6's factors and
          alpha basis at (naux, neo) = (2400, 60) (1e-12 relative, one
          symmetric syrk launch, no plain-version call);
          get_veff_from_rdm1_emb_sharded on phase 6's lattice and
          impurity density (1e-10); get_emb_eri_gdf_sharded on phase 9c's
          factors, both tr_symm (1e-10 relative); ccsd_residual_sharded
          and ccsd_solve_sharded on phase 9a's spin-orbital integrals (120
          spin orbitals; E_corr 1e-9, amplitudes 1e-7);
     17b. entry.dryrun_multichip(4, backend="gloo") in a subprocess: four
          ranks sharing the card on a 2 x 2 (k, aux) grid, each running
          the dry run at the JAX package's sizes and the 17a cases at the
          same widths rebuilt from the NumPy seeds (the CCSD cases at
          tests/test_parallel.py's nocc = 8, nvir = 6), with one symmetric
          syrk launch per rank in each sharded ERI call; a rank that fails
          or hangs fails the phase.

  18. the FCI sigma kernel (csrc/fci_sigma.cu; built in phase 2 with its
     ptxas lines and occupancy, every CUDA sigma build of phases 3-17
     recorded by shape): at every (norb, nelec) the card's FCI ran and at
     FCI_SIGMA_SHAPES, the kernel against the plain sigma on the card for
     unrestricted and restricted integrals (1e-12 relative to max
     |sigma|), two calls bit-identical, three launches a build; timed at
     the three-band shape (12 orbitals, 6 + 6) beside its bound (the count
     perfbench's roofline reads) and beside the least count the function
     needs, and beside the plain version.  Phase 8c's solve on the card
     counts three launches for every sigma build; the launches and builds
     of phases 3-17 are counted per phase (phase 18's own left out) and
     must come to three launches a build on every phase.

The line before the last is a JSON summary of the kernels; the last line
is {"ok": true, "device": {...}}.
"""

import contextlib
import json
import os
import shutil
import subprocess
import tempfile
import threading
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

# PyTorch's intra-op threads at start (the host's cores): main() runs some
# phases on one thread (see there), the large host GEMMs on these
HOST_THREADS = torch.get_num_threads()

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
    """Phase 5 through the port's entry point entry(): its step on the card
    against the CPU, at its own (p0, rho_target) and at a target that the
    fit has work on (carried into the fit basis); then the flagship's
    vcor summary, lattice transforms and dmet_forward card vs CPU."""
    from libdmet_preview_tpu_torch.entry import entry
    from libdmet_preview_tpu_torch.ops.zlinalg import rho_fermi_real
    from libdmet_preview_tpu_torch.utils.logger import Timer
    # the flagship's doubled count: 2 (ncore + nval) of its 2-site cell
    nelec2, neo = 4, 4

    def target(embH1_p):
        return np.stack([rho_fermi_real(torch.as_tensor(h), nelec2, BETA)[0]
                         .numpy() for h in embH1_p])

    outs, own = [], []
    for dev in (device, torch.device("cpu")):
        timer = Timer("5 entry()", device=dev)
        step, (p0, rho_target) = entry(dev)
        own.append(step(p0, rho_target))
        dp = np.random.RandomState(11).randn(len(p0)) * 0.1
        ph = torch.zeros((1, neo, neo), dtype=torch.float64, device=dev)
        tgt = target_in_fit_basis(step, p0, torch.as_tensor(dp, device=dev),
                                  ph, target)
        outs.append(step(p0, tgt))
        timer.log("on %s: set-up and two steps" % dev.type)
    torch.cuda.synchronize()
    compare_steps(own[0], own[1], "hubbard entry()")
    compare_steps(outs[0], outs[1], "hubbard")
    lattice_fft_checks(device)
    dmet_forward_check(device)


FLAGSHIP = {"ncells": 9, "nlo": 2, "U": 4.0, "filling": 0.5}
CLOSING_TOL = {"FFTtoK": 1e-12, "FFTtoT": 1e-12, "round trip": 1e-12,
               "E_mf": 1e-10, "rho_R": 1e-10, "fit_err": 1e-10,
               "embH1 impurity block": 1e-10, "embH1 spectrum": 1e-10}


def _closing_verdict(label, diffs):
    for k, v in diffs.items():
        print("%s: cuda vs cpu %-22s %.3e (tol %.0e)"
              % (label, k, v, CLOSING_TOL[k]))
    bad = [k for k, v in diffs.items() if not v <= CLOSING_TOL[k]]
    if bad:
        raise AssertionError("%s: cuda and cpu disagree on %s" % (label, bad))


def lattice_fft_checks(device):
    """The flagship's vcor summary (Vcor.show), and LatticeModel.FFTtoK /
    FFTtoT of a random stripe on the flagship chain and on the 40 x 40
    lattice (400 cells): card vs CPU, and back to the stripe on the
    card."""
    import libdmet_preview_tpu_torch.dmet.hubbard as dmet
    f = FLAGSHIP
    vcor = dmet.PMInitGuess((f["nlo"],), f["U"], f["filling"])
    print("hubbard flagship vcor.show(): %s"
          % vcor.show().replace("\n", " "))
    for name, Lat in (("ChainLattice(18, 2)", dmet.ChainLattice(18, 2)),
                      ("SquareLattice(40, 40, 2, 2)",
                       dmet.SquareLattice(40, 40, 2, 2))):
        n = Lat.nscsites
        A = np.random.RandomState(13).randn(2, Lat.ncells, n, n)
        diffs = {}
        k_d = Lat.FFTtoK(torch.as_tensor(A, device=device))
        k_c = Lat.FFTtoK(torch.as_tensor(A))
        diffs["FFTtoK"] = max(float(torch.max(torch.abs(a.cpu() - b)))
                              for a, b in zip(k_d, k_c))
        R_d = Lat.FFTtoT(k_d)
        diffs["FFTtoT"] = float(torch.max(torch.abs(R_d.cpu()
                                                    - Lat.FFTtoT(k_c))))
        diffs["round trip"] = float(np.max(np.abs(R_d.cpu().numpy() - A)))
        if R_d.device.type != device.type:
            raise AssertionError("FFTtoT left the card")
        _closing_verdict("hubbard %s" % name, diffs)


def dmet_forward_check(device):
    """entry.dmet_forward at the flagship (9 cells x 2 sites, U = 4, half
    filling, beta = 1000, a random symmetric vmat) on the card against the
    CPU; embH1 by its impurity block and spectrum (the bath's SVD columns
    carry a free sign)."""
    from libdmet_preview_tpu_torch.entry import _hubbard_fock_k, dmet_forward
    from libdmet_preview_tpu_torch.ops.zlinalg import dft_tables
    f = FLAGSHIP
    ncells, nlo = f["ncells"], f["nlo"]
    f_re, f_im = _hubbard_fock_k(ncells, nlo, f["U"], f["filling"])
    cos_t, sin_t = dft_tables((ncells,))
    neo = 2 * nlo
    v = np.random.RandomState(17).randn(1, nlo, nlo) * 0.1
    args = (f_re, f_im, v + v.transpose(0, 2, 1),
            np.eye(neo)[None] * f["filling"], cos_t, sin_t,
            np.arange(nlo, ncells * nlo), ncells * 2 * nlo * f["filling"],
            BETA, nlo)
    t0 = time.perf_counter()
    out_d = dmet_forward(*args, device=device)
    _sync(device)
    ms = (time.perf_counter() - t0) * 1e3
    E_d, rho_d, h_d, err_d = (x.cpu().numpy() for x in out_d)
    E_c, rho_c, h_c, err_c = (x.numpy() for x in dmet_forward(
        *args, device=torch.device("cpu")))
    if not all(np.all(np.isfinite(x)) for x in (E_d, rho_d, h_d, err_d)):
        raise AssertionError("dmet_forward: non-finite output on the card")
    if rho_d.shape != (1, ncells, nlo, nlo) or h_d.shape != (1, neo, neo):
        raise AssertionError("dmet_forward: shapes %s, %s"
                             % (rho_d.shape, h_d.shape))
    print("hubbard dmet_forward on %s: E_mf %.12f, fit_err %.6e, %.2f ms "
          "(first call)" % (device.type, float(E_d), float(err_d), ms))
    _closing_verdict("hubbard dmet_forward", {
        "E_mf": abs(float(E_d - E_c)),
        "rho_R": float(np.max(np.abs(rho_d - rho_c))),
        "fit_err": abs(float(err_d - err_c)),
        "embH1 impurity block": float(np.max(np.abs(
            h_d[:, :nlo, :nlo] - h_c[:, :nlo, :nlo]))),
        "embH1 spectrum": float(np.max(np.abs(
            np.linalg.eigvalsh(h_d) - np.linalg.eigvalsh(h_c))))})


# ----------------------------------------------------------------------
# phase 6: one-shot interacting-bath UHF-DMET at the CuO2 AFM plane's width
# ----------------------------------------------------------------------

from libdmet_preview_tpu_torch.workloads import (  # noqa: E402
    AI_FILLING, AI_NAUX, AI_NCELLS, AI_NLO, GDF, _tr_stripe,
    make_abinitio_workload, make_gdf_workload)

AI_TOL = {"HF E": 1e-8, "HF rho_R": 1e-8, "bath projector": 1e-8,
          "H1 spectrum": 1e-8, "H2 aa (mapped, rel)": 1e-10,
          "H2 bb (mapped, rel)": 1e-10, "H2 ab (mapped, rel)": 1e-10,
          "SCF E": 1e-8, "E per cell": 1e-8, "nelec per cell": 1e-8}


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
# iterations of a loop replayed on the CPU against the card (7a, 8a, 9b,
# 10b): 2 until the oxide phase needed the script's time, 1 since
REPLAY = 1
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
def _torch_threads(n):
    """PyTorch's intra-op threads set to n inside the block."""
    old = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(old)


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
        self.n_device_events = len(spans)
        return False


def _idle_share(fn):
    """Idle share of the card over fn(), after one unprofiled call that
    warms the tables and the cuSOLVER handles."""
    fn()
    with _Profiled() as prof:
        fn()
    return prof.idle


# utils.timer spans that run inside other spans of the DMET loop: the ERI
# stages inside "H2", the per-step spans inside the solver and the fit,
# and the stages inside "dmet iteration"
NESTED = ("ERI rotation", "ERI pack", "ERI unpack", "syrk (tri kernel)",
          "dmet iteration", "mu step", "davidson iteration", "fci sigma",
          "cg step")


def _print_loop_stages(label, res, sec, counts, card):
    """Stage seconds of a run_dmet run: the first iteration (which also
    pays for the first use of the card's libraries) apart from the mean of
    the later ones; sums leave out the NESTED spans."""
    n_it = len(res.history)
    outer = {k: v for k, v in sec.items() if k not in NESTED}
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


# the FCI sigma kernel (csrc/fci_sigma.cu): the shapes checked against the
# plain version (with the whole script also every (norb, nelec) the card's
# FCI ran, FCI_SIGMA_SEEN; the last four narrow the plan's tile to 8, 4, 2
# and 1 columns), the timed shape (the three-band cells'), and its design
FCI_SIGMA_SHAPES = [(12, (6, 6)), (12, (7, 5)), (8, (4, 4)), (16, (8, 0)),
                    (10, (5, 5)), (8, (4, 0)), (6, (3, 3)), (6, (2, 2)),
                    (5, (3, 2)), (4, (2, 2)), (3, (1, 1)), (2, (1, 1)),
                    (6, (4, 0)), (4, (4, 3)), (13, (6, 6)), (14, (6, 1)),
                    (15, (7, 1)), (16, (8, 1))]
FCI_SIGMA_TIMED = (12, (6, 6))
FCI_SIGMA_DESIGN = (
    "DMMA mma.sync m16n8k4 f64; 8 warps, one block per SM; a block owns a "
    "side, 16 columns and a string range, its sigma rows in shared memory; "
    "strings in batches sharing no excitation target; links gathered from "
    "c, integral rows from a shared-memory slice; 3 launches a build")
FCI_SIGMA_SEEN = set()
FCI_SIGMA_BUILDS = [0]


def record_fci_sigma_shapes():
    """Record the (norb, nelec) of every sigma build the kernel runs from
    here on in FCI_SIGMA_SEEN, and count the builds in FCI_SIGMA_BUILDS."""
    from libdmet_preview_tpu_torch.ops.fci_sigma import FciSigma
    call = FciSigma.__call__

    def recorded(self, c):
        if c.device.type == "cuda":
            FCI_SIGMA_SEEN.add((self.norb, self.nelec))
            FCI_SIGMA_BUILDS[0] += 1
        return call(self, c)
    FciSigma.__call__ = recorded


def _random_fci_ints(norb, seed, spin_dep):
    """Random real integrals with the FCI's symmetries: h1 symmetric, each
    (pq|rs) block symmetric in p <-> q and r <-> s, the same-spin blocks
    also in (pq) <-> (rs); (h1, eri) or ((h1a, h1b), (g_aa, g_ab, g_bb))."""
    rng = np.random.RandomState(seed)

    def h1():
        h = rng.rand(norb, norb) - 0.5
        return h + h.T

    def g(same):
        x = rng.rand(norb, norb, norb, norb) - 0.5
        x = x + x.transpose(1, 0, 2, 3)
        x = x + x.transpose(0, 1, 3, 2)
        if same:
            x = x + x.transpose(2, 3, 0, 1)
        return 0.1 * x

    if not spin_dep:
        return h1(), g(True)
    return (h1(), h1()), (g(True), g(False), g(True))


def fci_sigma_check(norb, nelec, device, spin_dep, seed=0):
    """The kernel against the plain version on the card at (norb, nelec):
    (relative max error, max abs error, two calls bit-identical, launches,
    sigma, plain sigma, c)."""
    from libdmet_preview_tpu_torch.ops.fci_sigma import FciSigma
    from libdmet_preview_tpu_torch.solvers import fci
    from libdmet_preview_tpu_torch.utils.misc import as_f64
    h1e, eri = _random_fci_ints(norb, seed, spin_dep)
    sigma, _ = fci.make_sigma(h1e, eri, norb, nelec, device)
    na = fci.num_strings(norb, nelec[0])
    nb = fci.num_strings(norb, nelec[1])
    c = torch.as_tensor(np.random.RandomState(seed + 1).randn(na, nb),
                        device=device)
    n0 = FciSigma.launches
    s1 = sigma(c)
    s2 = sigma(c)
    launches = FciSigma.launches - n0
    la = fci.links_on(norb, nelec[0], device)
    lb = fci.links_on(norb, nelec[1], device)
    if spin_dep:
        blocks = fci.absorb_h1e_uhf(tuple(as_f64(x, device) for x in h1e),
                                    tuple(as_f64(x, device) for x in eri),
                                    norb, sum(nelec))

        def plain(x):
            return fci._sigma_uhf(*blocks, x, la, lb, norb)
    else:
        h2e = fci.absorb_h1e_rhf(as_f64(h1e, device), as_f64(eri, device),
                                 norb, sum(nelec))

        def plain(x):
            return fci._sigma_rhf(h2e, x, la, lb, norb)
    ref = plain(c)
    torch.cuda.synchronize()
    err = float(torch.max(torch.abs(s1 - ref)))
    rel = err / max(float(torch.max(torch.abs(ref))), 1e-300)
    return rel, err, torch.equal(s1, s2), launches, sigma, plain, c


def phase_fci_sigma_build():
    """Build the FCI sigma kernel; ptxas registers, spills and shared
    memory of each entry; the occupancy of each k-step instantiation at the
    timed shape's shared memory."""
    from libdmet_preview_tpu_torch.ops import _build
    from libdmet_preview_tpu_torch.ops import fci_sigma as fs
    path, seconds, log = _build.build("fci_sigma")
    print("build fci_sigma: %.2f s -> %s" % (seconds, path.name))
    kernel = None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            kernel = line.split("'")[1] if "'" in line else line.strip()
        elif kernel and ("registers" in line or "spill" in line
                         or "smem" in line):
            print("  ptxas %s: %s" % (kernel, line.split(":", 1)[-1].strip()))
    for symbol in _build.entry_points("fci_sigma"):
        _build.load("fci_sigma", symbol)
        print("  entry point %s loaded" % symbol)
    plan = fs.sigma_plan(*FCI_SIGMA_TIMED)
    for nkm in fs.NK_CLASSES:
        blocks, threads, regs = fs.fci_sigma_occupancy(nkm, plan.smem)
        print("  fci sigma kernel, k-steps <= %d: %d threads, %d registers, "
              "%d B dynamic shared memory, %d resident blocks per SM"
              % (nkm, threads, regs, plan.smem, blocks))
        if blocks != 1:
            raise AssertionError("the plan assumes one resident block per "
                                 "SM")


def phase_fci_sigma(device, card, shapes=None):
    """Phase 18: the kernel against the plain version on the card at every
    shape (unrestricted and restricted integrals), 1e-12 relative to max
    |sigma|, two calls bit-identical, three launches a build; then timed
    at the three-band shape beside its bound and the plain version.
    Returns (max_abs_err, {"ms", "plain_ms", "bound_ms", ...})."""
    from libdmet_preview_tpu_torch.ops import fci_sigma as fs
    shapes = sorted(set(shapes or ()) | set(FCI_SIGMA_SHAPES)
                    | {FCI_SIGMA_TIMED})
    max_abs, bad, timed = 0.0, [], None
    for norb, nelec in shapes:
        plan = fs.sigma_plan(norb, nelec)
        for spin_dep in (True, False):
            rel, err, same, launches, sigma, plain, c = fci_sigma_check(
                norb, nelec, device, spin_dep, seed=norb)
            max_abs = max(max_abs, err)
            print("fci sigma kernel (norb %d, nelec %s, %s) [%s]: rel %.3e "
                  "max_abs_err %.3e, bit-identical repeat %s, %d launches "
                  "for 2 builds; plan mt %d x %d passes, split %d, blocks "
                  "%s, %d B shared memory"
                  % (norb, nelec, "uhf" if spin_dep else "rhf", card, rel,
                     err, same, launches, plan.mt, plan.npass, plan.nsplit,
                     [sd.blocks for sd in plan.sides], plan.smem))
            if not (rel <= 1e-12 and same and launches == 2 * fs.LAUNCHES):
                bad.append((norb, nelec, spin_dep))
            if (norb, nelec) == FCI_SIGMA_TIMED and spin_dep:
                ms = _time_ms(lambda: sigma(c))
                plain_ms = _time_ms(lambda: plain(c))
                counted, run, least = fs.sigma_work(norb, nelec)
                bound_ms = 1e3 * counted / PEAK_FP64_FLOPS
                least_ms = 1e3 * least / PEAK_FP64_FLOPS
                timed = {"shape": [norb, list(nelec)], "ms": ms,
                         "plain_ms": plain_ms, "bound_ms": bound_ms,
                         "bound_by": "operations", "flops": counted,
                         "run_flops": run, "share_of_bound": bound_ms / ms,
                         "least_flops": least, "least_bound_ms": least_ms,
                         "share_of_least_bound": least_ms / ms}
                print("fci sigma kernel (norb %d, nelec %s) [%s]: %.4f ms a "
                      "build, plain %.4f ms (%.2fx), bound %.4f ms (%.2e "
                      "FLOP counted at %.0f TFLOP/s): %.1f%% of bound; "
                      "against the least count (%.2e FLOP, %.4f ms) %.1f%%; "
                      "the MMAs run %.2e FLOP (padding %.1f%%)"
                      % (norb, nelec, card, ms, plain_ms, plain_ms / ms,
                         bound_ms, counted, PEAK_FP64_FLOPS / 1e12,
                         100.0 * bound_ms / ms, least, least_ms,
                         100.0 * least_ms / ms, run,
                         100.0 * (run / counted - 1)))
            del sigma, plain, c
            torch.cuda.empty_cache()
    if bad:
        raise AssertionError("fci sigma kernel disagrees with the plain "
                             "version, repeats differently or launches other "
                             "than %d a build at %s" % (fs.LAUNCHES, bad))
    return max_abs, timed


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
    # the first REPLAY iterations of the NIB run, card vs CPU
    label, int_bath, U, _ = HUB2D["runs"][0]
    res_d = run_hub2d(U, int_bath, device, max_iter=REPLAY)[0]
    res_c = run_hub2d(U, int_bath, cpu, max_iter=REPLAY)[0]
    _compare_histories("hub2d 40x40 %s" % label, res_d.history,
                       res_c.history,
                       dict.fromkeys(["E", "nelec", "last_dmu", "vcor_param",
                                      "rho_imp"], LOOP_TOL), REPLAY)
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
    err, ms, plain_ms, _, _ = tri_kernel_at(CHOL_SHAPE, device, card)
    return launches, err, (ms, plain_ms)


def tri_kernel_at(shape, device, card, seed=21, kind="tri"):
    """The symmetric kernel (kind "cross": the cross kernel, on a second
    factor) at a path's (naux, neo) against its plain version, then timed
    beside it (plain, kernel, kernel, plain).  Returns (max_abs_err, ms,
    plain_ms, bound_ms, bound_by)."""
    from libdmet_preview_tpu_torch.ops import eri_kernels as ek
    naux, neo = shape
    F = _packed_factors(naux, neo, seed=seed, device=device)
    Fs = (F,) if kind == "tri" else \
        (F, _packed_factors(naux, neo, seed=seed + 1, device=device))
    name = "syrk_df" if kind == "tri" else "syrk_df_cross"
    out = ek.syrk_df(*Fs)
    torch.cuda.synchronize()
    err = _check_kernel("%s (naux=%d, neo=%d)" % (name, naux, neo), out,
                        ek.syrk_df_plain(*Fs), symmetric=kind == "tri")
    tp = [_time_ms(lambda: ek.syrk_df_plain(*Fs))]
    tk = [_time_ms(lambda: ek.syrk_df(*Fs)), _time_ms(lambda: ek.syrk_df(*Fs))]
    tp.append(_time_ms(lambda: ek.syrk_df_plain(*Fs)))
    ms, plain_ms = float(np.mean(tk)), float(np.mean(tp))
    bound, by, _ = kernel_bound(kind, naux, F.shape[1])
    print("%s timing (naux=%d, neo=%d, npair=%d) [%s]: kernel %.4f ms, "
          "plain (cuBLAS torch.mm) %.4f ms, bound %.6f ms (%s)"
          % (name, naux, neo, F.shape[1], card, ms, plain_ms, bound, by))
    return err, ms, plain_ms, bound, by


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
              # (a warm one: the profiler's cost on the cold first
              # iteration is ~70 s)
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
    rec_d = run_pdmet(False, device, n_fixed=REPLAY)[0]
    rec_c = run_pdmet(False, torch.device("cpu"), n_fixed=REPLAY)[0]
    _compare_histories("pDMET 40x40 U=4 (Fock update)", rec_d, rec_c,
                       dict.fromkeys(["E", "nelec", "last_dmu", "rho_glob"],
                                     LOOP_TOL), REPLAY)


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


# FitVcorFull's iterations on the 40 x 40 lattice: the check is its
# gradient and its seconds per evaluation, not its end point
FULL_FIT_ITER = 60


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
                                    MaxIter=FULL_FIT_ITER, imp_fit=True,
                                    BFGS=True)
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
        # the CPU's sigma is large GEMMs: the host's whole pool
        with _torch_threads(HOST_THREADS):
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
    from libdmet_preview_tpu_torch.ops.fci_sigma import LAUNCHES, FciSigma
    H_d, sol_d = out["cuda"][:2]
    n0, s0 = FciSigma.launches, sol_d.n_sigma
    rdm_d, E_d = sol_d.run(H_d, nelec=nelec)
    builds = sol_d.n_sigma - s0
    launches = FciSigma.launches - n0
    print("three-band FCI [%s]: one solve on the card, %d sigma builds, %d "
          "fci sigma kernel launches (%d a build)"
          % (card, builds, launches, LAUNCHES))
    if launches != LAUNCHES * builds or builds == 0:
        raise AssertionError("a sigma build on the card left the kernel")
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
    CPU against the card.  Returns (the relative differences, the idle
    share, {"h_so", "W", "nocc"}: the spin-orbital integrals, which phase
    17 reuses)."""
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
    return diffs, idle, {"h_so": h_so, "W": W, "nocc": nocc}


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
    diffs, idle, cc_ints = ccsd_detail(solver, ImpHam, device, card)
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
    return launches, r["E"], cc_ints


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
    res_d = run_hub2d(U, int_bath, device, max_iter=REPLAY,
                      solver="CCSD")[0]
    res_c = run_hub2d(U, int_bath, torch.device("cpu"), max_iter=REPLAY,
                      solver="CCSD")[0]
    _compare_histories("hub2d 40x40 IB U=2 CCSD", res_d.history,
                       res_c.history,
                       dict.fromkeys(["E", "nelec", "last_dmu", "vcor_param",
                                      "rho_imp"], LOOP_TOL), REPLAY)


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
                         nfac=GDF["nfac"], neo=GDF["neo"], reps=3):
    """get_emb_eri_gdf and get_jk_from_gdf on `device` from the analytic
    factors against get_emb_eri_chol and J, K einsums over the Cholesky
    vectors of the same integrals.  Returns (relative differences, the
    results, the factors, the seconds, the basis carried to k)."""
    from libdmet_preview_tpu_torch.ops import fourier
    from libdmet_preview_tpu_torch.ops.eri_transform import (
        _dft_phase, get_emb_eri_chol, get_emb_eri_gdf, get_emb_eri_gso_chol,
        get_emb_eri_gso_gdf)
    from libdmet_preview_tpu_torch.ops.pbc_helper import get_jk_from_gdf
    L, factors = make_gdf_workload(device, ncells=ncells, nlo=nlo, nfac=nfac)
    rng = np.random.RandomState(21)
    basis = rng.randn(1, ncells, nlo, neo) / np.sqrt(ncells * nlo)
    basis_k = fourier.R2k(torch.as_tensor(basis, device=device), (ncells,))
    ref, t_chol = _best_of(lambda: get_emb_eri_chol(L, basis), device, reps)
    out, sec, diffs = {}, {"get_emb_eri_chol": t_chol}, {}
    scale = float(torch.max(torch.abs(ref)))
    for tr in (False, True):
        name = "get_emb_eri_gdf(tr_symm=%s)" % tr
        out[name], sec[name] = _best_of(
            lambda: get_emb_eri_gdf(factors, basis_k, ncells, nlo,
                                    tr_symm=tr, device=device), device, reps)
        diffs[name + " vs chol"] = float(
            torch.max(torch.abs(out[name] - ref))) / scale
    # J and K of a translation-invariant density, from L in the supercell
    # and carried to k: V_k = (1/N) sum_{AB} P[k, A] conj(P[k, B]) V[A, B]
    st, dm_full = _stripe_density(rng, ncells, nlo, 2)
    dm_k = fourier.R2k(torch.as_tensor(st, device=device), (ncells,))
    (vj, vk), sec["get_jk_from_gdf"] = _best_of(
        lambda: get_jk_from_gdf(factors, dm_k, device=device), device, reps)
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
        lambda: get_emb_eri_gso_chol(L, gbasis), device, reps)
    out["gso"], sec["get_emb_eri_gso_gdf"] = _best_of(
        lambda: get_emb_eri_gso_gdf(factors, gbasis_k, ncells, nlo,
                                    device=device), device, reps)
    diffs["get_emb_eri_gso_gdf vs gso chol"] = float(
        torch.max(torch.abs(out["gso"] - ref)) / torch.max(torch.abs(ref)))
    return diffs, out, factors, sec, basis_k


def phase_gdf(device, card):
    """9c."""
    from libdmet_preview_tpu_torch import interop
    from libdmet_preview_tpu_torch.ops.cderi import read_cderi, write_cderi
    from libdmet_preview_tpu_torch.ops.eri_kernels import syrk_df
    from libdmet_preview_tpu_torch.ops.eri_transform import make_gdf_factors
    ncells, nlo = GDF["ncells"], GDF["nlo"]
    syrk_df.launches = 0
    diffs, out_d, factors, sec, basis_k = gdf_against_cholesky(device)
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
    # the CPU side once per call (its times are not reported)
    diffs_c, out_c = gdf_against_cholesky(torch.device("cpu"), reps=1)[:2]
    for k in out_d:
        diffs["cuda vs cpu " + k] = float(
            torch.max(torch.abs(out_d[k].cpu() - out_c[k]))
            / torch.max(torch.abs(out_c[k])))
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
    # the CDERI archive of the dense case's factors, written and read back
    host = interop.gdf_factors_to_numpy(fa)
    kpts_scaled = np.asarray([[0.0, 0.0, f] for f in np.fft.fftfreq(nc)])
    kpts = 2.0 * np.pi * kpts_scaled / 7.3
    with tempfile.TemporaryDirectory() as tmp:
        fname = os.path.join(tmp, "cderi.npz")
        write_cderi(fname, host, kpts, kpts_scaled, n)
        back = read_cderi(fname, kpts, kpts_scaled, n)
        size = os.path.getsize(fname)
    same = all(np.array_equal(back[q][i], host[q][i])
               for q in host for i in (0, 1))
    print("GDF: CDERI archive of the dense case (%d cells x %d LOs) %.3f MB, "
          "bit-identical: %s" % (nc, n, size / 1e6, same))
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
    return factors, basis_k, ncells, nlo


# ----------------------------------------------------------------------
# phase 10: the superconducting / GSO formalism on the card
# ----------------------------------------------------------------------

DWAVE = {"size": (4, 4), "imp": (2, 2), "U": 4.0, "filling": 0.4375,
         "max_iter": 20, "anchor": -0.9352863316, "kappa_x": 0.0952150,
         "x_bonds": [(0, 2), (1, 3)], "y_bonds": [(0, 1), (2, 3)]}
DOPED = {"size": (60, 60), "imp": (2, 2), "U": 6.0, "filling": 0.4,
         "beta": 1000.0, "max_iter": 30, "anchor": -1.001725641814,
         "tol": 2e-4, "compare": REPLAY}
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


# ----------------------------------------------------------------------
# phase 11: ab initio lattices from the engine arrays, k-space stripe HF,
# Wannier localization
# ----------------------------------------------------------------------

# 11e: tight-binding bands of tests/test_wannier.py and a 3D mesh.  The
# gradient test stops at 1e-8, not max_loc_U's default 1e-10: the step
# control accepts any move that raises Omega by less than 1e-14, so below a
# gradient norm of ~1e-7 the descent no longer sees Omega and whether it
# reaches 1e-10 depends on rounding (an SSH run missed it in 3000
# iterations on an NVIDIA H100 80GB HBM3 at 700.00 W, where a CPU met it in
# 1825).  At 1e-8 Omega is within ~1e-14 of its minimum.
MAXLOC = {"ssh_nk": 16, "square_n": 12, "cubic_n": 6, "max_iter": 3000,
          "tol": 1e-8, "cubic_guess": np.array([[1.0, 0.3], [-0.2, 1.0]])}


def _print_hchain_stages(label, card, sec, n_it):
    tot = sum(sum(v) for k, v in sec.items() if k not in NESTED)
    print("%s [%s]: %d iterations, %.4f s per iteration in the stages"
          % (label, card, n_it, tot / n_it))
    for k, v in sec.items():
        print("%s [%s]: stage %-18s %.6f s per iteration (%d calls)"
              % (label, card, k, sum(v) / n_it, len(v)))


def phase_hchain_ib(device, card, ints):
    """11a: the interacting-bath FCI loop on the 3-k-point H chain built
    from the engine arrays, on the card: the anchor, the JAX package's
    value, one iteration replayed on the CPU, launches and idle share.
    Returns the tri kernel's launches on this path and its shape."""
    from libdmet_preview_tpu_torch import workloads as wl
    from libdmet_preview_tpu_torch.ops import eri_kernels as ek
    from libdmet_preview_tpu_torch.utils import timer
    Lat, meta = wl.hchain_lattice(ints, device)
    solver = wl.hchain_solver("FCI", device)
    # the main path: counts start at 0 here
    _sync(device)
    ek.syrk_df.launches = 0
    ek.syrk_df.cross_launches = 0
    t0 = time.perf_counter()
    with _counted_plain_calls() as plain_calls, timer.recording() as sec:
        E, recs = wl.run_hchain_dmet(Lat, meta, solver, wl.IB_PROTOCOL)
    _sync(device)
    wall = time.perf_counter() - t0
    launches = ek.syrk_df.launches
    cross = ek.syrk_df.cross_launches
    naux = Lat.chol_L.shape[0]
    neo = recs[-1]["neo"]
    ref, tol = wl.HCHAIN_ANCHORS["IB FCI"]
    jax = wl.HCHAIN_JAX["IB FCI"]
    print("11a H chain IB FCI [%s]: E/cell %.12f, anchor %.12f (diff %.3e, "
          "tol %.0e), JAX package on the same integrals %.12f (diff %.3e, "
          "tol %.0e), %d iterations, %.3f s; syrk_df launches %d (cross %d) "
          "at (naux, neo) = (%d, %d), plain-version calls on CUDA tensors %d"
          % (card, E, ref, E - ref, tol, jax, E - jax, wl.IB_JAX_TOL,
             len(recs), wall, launches, cross, naux, neo,
             plain_calls["cuda"]))
    _print_hchain_stages("11a H chain IB FCI", card, sec, len(recs))
    # the last iteration again on the CPU, from the card's state
    rec = recs[-1]
    Lc, mc = wl.hchain_lattice(ints, torch.device("cpu"))
    out_c = wl.replay_hchain_iteration(Lc, mc, wl.hchain_solver(
        "FCI", torch.device("cpu")), wl.IB_PROTOCOL, rec)
    diffs = {"E": abs(out_c[0] - rec["E"]), "nelec": abs(out_c[1]
                                                         - rec["nelec"]),
             "dmu": abs(out_c[2] - rec["dmu"]),
             "fit_err": abs(out_c[3] - rec["fit_err"])}
    for k, v in diffs.items():
        print("11a replay of iteration %d on the CPU: %-8s |cuda - cpu| "
              "%.3e (tol %.0e)" % (rec["iter"], k, v, LOOP_TOL))
    print("11a replay: fitted vcor |cuda - cpu| %.3e (the fit's flat valley, "
          "ROADMAP Queue 3)" % np.max(np.abs(out_c[4] - rec["fitted"])))
    idle = _idle_share(lambda: wl.replay_hchain_iteration(
        Lat, meta, solver, wl.IB_PROTOCOL, rec))
    print("11a idle share of one iteration [%s]: %s" % (card, idle))
    bad = [k for k, v in diffs.items() if not v <= LOOP_TOL]
    if not abs(E - ref) < tol:
        bad.append("anchor")
    if not abs(E - jax) <= wl.IB_JAX_TOL:
        bad.append("JAX value")
    if launches != len(recs) or cross != 0 or plain_calls["cuda"] != 0:
        bad.append("launches")
    if bad:
        raise AssertionError("11a failed: %s" % bad)
    return launches, (naux, neo)


def phase_hchain_variants(device, card, ints):
    """11b: the CC-family anchors and the FCI protocol variants of the JAX
    suite's run_hchain_dmet, each on a fresh lattice on the card.  Returns
    the tri kernel's launches."""
    from libdmet_preview_tpu_torch import workloads as wl
    from libdmet_preview_tpu_torch.ops import eri_kernels as ek
    bad, launches = [], 0
    for name, solver_name, kw in wl.HCHAIN_VARIANTS:
        Lat, meta = wl.hchain_lattice(ints, device)
        _sync(device)
        ek.syrk_df.launches = 0
        t0 = time.perf_counter()
        with _counted_plain_calls() as plain_calls:
            E, recs = wl.run_hchain_dmet(Lat, meta, wl.hchain_solver(
                solver_name, device), wl.ANCHOR_PROTOCOL, **kw)
        _sync(device)
        ref, tol = wl.HCHAIN_ANCHORS[name]
        jax = wl.HCHAIN_JAX[name]
        launches += ek.syrk_df.launches
        print("11b H chain %-12s [%s]: E/cell %.12f, anchor %.12f (diff "
              "%.3e, tol %.0e), JAX package %.12f (diff %.3e, tol %.0e), %d "
              "iterations, %.3f s, %d syrk_df launches, %d plain-version "
              "calls on CUDA tensors"
              % (name, card, E, ref, E - ref, tol, jax, E - jax,
                 wl.VARIANT_TOL,
                 len(recs), time.perf_counter() - t0, ek.syrk_df.launches,
                 plain_calls["cuda"]))
        if not (abs(E - ref) < tol and abs(E - jax) <= wl.VARIANT_TOL
                and ek.syrk_df.launches == len(recs)
                and plain_calls["cuda"] == 0):
            bad.append(name)
    if bad:
        raise AssertionError("11b failed: %s" % bad)
    return launches


def phase_hchain_nib_uhf(device, card, ints):
    """11c: the UHF non-interacting bath on the card, no syrk launch."""
    from libdmet_preview_tpu_torch import workloads as wl
    from libdmet_preview_tpu_torch.ops import eri_kernels as ek
    _sync(device)
    ek.syrk_df.launches = 0
    ek.syrk_df.cross_launches = 0
    t0 = time.perf_counter()
    E, afm, hf_err = wl.run_hchain_nib_uhf(ints, device)
    _sync(device)
    ref, tol = wl.HCHAIN_ANCHORS["NIB UHF"]
    n_syrk = ek.syrk_df.launches + ek.syrk_df.cross_launches
    print("11c H chain NIB UHF [%s]: E/cell %.12f, anchor %.12f (diff %.3e, "
          "tol %.0e), max |rho_a - rho_b| %.4f, lattice HF vs supercell UHF "
          "%.3e, %.3f s, syrk_df launches %d"
          % (card, E, ref, E - ref, tol, afm, hf_err,
             time.perf_counter() - t0, n_syrk))
    if not (abs(E - ref) < tol and afm > 0.3 and hf_err < 1e-7
            and n_syrk == 0):
        raise AssertionError("11c failed")


def phase_kscf(device, card):
    """11d: the k-space stripe HF at make_diamond_lattice3's width (27
    cells x 8 orbitals, 8 electrons per cell) on random
    translation-symmetric integrals, card against CPU, and the same
    construction at a 2x2x1 mesh against a dense supercell RHF."""
    from libdmet_preview_tpu_torch import workloads as wl
    kmesh = wl.KSCF["kmesh"]
    work = wl.make_kscf_workload(kmesh, device=device)
    eriF = work[3]
    print("11d workload: %d cells x %d orbitals, eriF %s (%.1f MB) on the "
          "card" % (work[0].ncells, wl.KSCF["nlo"], tuple(eriF.shape),
                    eriF.numel() * 8 / 1e6))
    from libdmet_preview_tpu_torch.utils import timer
    torch.cuda.reset_peak_memory_stats(device)
    info = {}
    _sync(device)
    t0 = time.perf_counter()
    E_d, rho_d, fock_d, fupd_d, flo_d = wl.run_kscf(work, device, info)
    _sync(device)
    cold = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device) / 1e9
    n_it = info["n_iter"]
    with timer.recording() as sec:          # the same again, warm
        wl.run_kscf(work, device)
    with timer.recording() as sec_c:
        E_c, rho_c, fock_c, fupd_c, _ = wl.run_kscf(work,
                                                    torch.device("cpu"))
    idle = _idle_share(lambda: wl.run_kscf(work, device))
    dE = abs(E_d - E_c)
    drho = float(torch.max(torch.abs(rho_d.cpu() - rho_c)))
    dupd = float(np.max(np.abs(fupd_d - fupd_c)))
    dself = float(np.max(np.abs(fupd_d - flo_d)))
    err_dense, E_k, E_dense = wl.kscf_dense_check(
        device=torch.device("cpu"))
    print("11d kscf_stripe_hf [%s]: E/cell %.12f, %d SCF iterations, "
          "%.4f s cold with the JK tables and one update_ham_eriF, peak "
          "%.3f GB, idle share %s (warm call)"
          % (card, E_d / work[0].ncells, n_it, cold, peak, idle))
    for k in sec:
        print("11d stage %-27s [%s] %.5f s, CPU %.5f s"
              % (k, card, sec[k][0], sec_c[k][0]))
    per_it = [t["k-space SCF"][0] / n_it for t in (sec, sec_c)]
    print("11d kscf_stripe_hf [%s]: %.6f s per SCF iteration over the JK "
          "tables (CPU %.6f s)" % (card, per_it[0], per_it[1]))
    print("11d card vs CPU: E %.3e (tol 1e-10), density stripes %.3e (tol "
          "1e-8), update_ham_eriF Fock %.3e (tol 1e-8); update_ham_eriF at "
          "the converged density vs the converged Fock %.3e (tol 1e-8)"
          % (dE, drho, dupd, dself))
    print("11d 2x2x1 mesh: kscf_stripe_hf %.12f vs dense supercell RHF "
          "%.12f, |diff| %.3e (tol 1e-8)" % (E_k, E_dense, err_dense))
    if not (dE <= 1e-10 and drho <= 1e-8 and dupd <= 1e-8 and dself <= 1e-8
            and err_dense <= 1e-8):
        raise AssertionError("11d failed")


def _eigh_bands(kmesh, h_of_k):
    """Bloch eigenvectors C(k) (nk, 2, 2) of a 2-orbital tight-binding
    model h(k frac) on the kmesh_kpts_frac ordering, as numpy's eigh gives
    them (tests/test_wannier.py): the gauge is the eigensolver's, random
    per k."""
    from libdmet_preview_tpu_torch.lo import maxloc
    kf = maxloc.kmesh_kpts_frac(kmesh)
    return np.array([np.linalg.eigh(h_of_k(k))[1] for k in kf])


def maxloc_cases():
    """tests/test_wannier.py's tight-binding bands in the eigensolver's
    gauge: the SSH chain (both bands, the complete basis, scrambled by its
    rand_gauge at amplitude 0.3; and its occupied band as eigh leaves it),
    the 2D square case (rand_gauge at 0.05, the test's amplitude), and its
    3D cubic analogue on a 6x6x6 mesh through max_loc's projected start
    (guess: the two point orbitals mixed, so the minimization has work to
    do; from the eigensolver's gauge alone the descent stalls in an Im ln
    branch minimum, in the JAX package too).  Returns [(name, C_k, kmesh,
    latt, tau, random gauge amplitude, rand_gauge seed, complete basis,
    guess or None)]."""
    n1, n2, n3 = MAXLOC["ssh_nk"], MAXLOC["square_n"], MAXLOC["cubic_n"]

    def ssh(k):
        ph = np.exp(2j * np.pi * k[0])
        return np.array([[0, 1.0 + 0.4 * np.conj(ph)], [1.0 + 0.4 * ph, 0]])

    def square(k):
        phx = np.exp(2j * np.pi * k[0])
        return np.array([[0.3, 0.8 + 0.2 * phx],
                         [0.8 + 0.2 * np.conj(phx), -0.3]])

    def cubic(k):
        t = 0.8 + 0.1 * np.sum(np.exp(2j * np.pi * k))
        return np.array([[0.3, t], [np.conj(t), -0.3]])

    C1 = _eigh_bands((n1, 1, 1), ssh)
    tau1 = np.array([[0.0, 0, 0], [0.4, 0, 0]])
    return [
        ("ssh", C1, (n1, 1, 1), np.diag([1.0, 10.0, 10.0]), tau1, 0.3, 0,
         True, None),
        ("ssh occupied", C1[:, :, :1], (n1, 1, 1),
         np.diag([1.0, 10.0, 10.0]), tau1, 0.0, 0, False, None),
        ("square", _eigh_bands((n2, n2, 1), square), (n2, n2, 1),
         np.diag([1.0, 1.0, 8.0]), np.array([[0.1, 0.2, 0], [0.6, 0.7, 0]]),
         0.05, 5, True, None),
        ("cubic", _eigh_bands((n3, n3, n3), cubic), (n3, n3, n3), np.eye(3),
         np.array([[0.1, 0.2, 0.3], [0.6, 0.7, 0.8]]), 0.0, 0, True,
         MAXLOC["cubic_guess"])]


def run_maxloc(case, device):
    """One case on `device`: max_loc_U from the eigensolver's gauge times
    tests/test_wannier.py's rand_gauge, or max_loc from the projection on
    the case's guess.  Returns (info, seconds)."""
    from libdmet_preview_tpu_torch.lo import maxloc
    name, C, kmesh, latt, tau, amp, seed, _, guess = case
    kw = {"max_iter": MAXLOC["max_iter"], "tol": MAXLOC["tol"],
          "device": device}
    _sync(device)
    t0 = time.perf_counter()
    if guess is not None:
        _, _, info = maxloc.max_loc(C, kmesh, latt, tau=tau, guess=guess,
                                    **kw)
    else:
        nk, nw = C.shape[0], C.shape[-1]
        U0 = None
        if amp > 0:
            rng = np.random.RandomState(seed)
            A = rng.randn(nk, nw, nw) + 1j * rng.randn(nk, nw, nw)
            U0 = maxloc._expm_antiherm(torch.as_tensor(
                (A - A.conj().swapaxes(-2, -1)) / 2 * amp, device=device))
        M0, bv = maxloc.mmn_from_C(C, kmesh, latt, tau=tau, device=device)
        _, info = maxloc.max_loc_U(M0, bv, U0=U0, **kw)
    _sync(device)
    return info, time.perf_counter() - t0


def phase_maxloc(device, card):
    """11e: the MV spread minimization on the card against the CPU, each
    run stopped by its gradient test, and the complete-basis cases at
    their exact minimum (Omega = 0)."""
    bad = []
    for case in maxloc_cases():
        name, complete = case[0], case[7]
        info_d, sec_d = run_maxloc(case, device)
        info_c, sec_c = run_maxloc(case, torch.device("cpu"))
        d = abs(info_d["omega"] - info_c["omega"])
        floor = 0.0 if complete else info_d["omega_I"]
        print("11e %-9s %-13s [%s]: kmesh %s, Omega %.3e -> %.12e (floor "
              "%.12e), %d iterations, grad norm %.3e (tol %.0e), converged "
              "%s (CPU %s, %d iterations), %.3f s (%.3f ms per iteration), "
              "CPU %.3f s; card vs CPU Omega %.3e (tol 1e-8)"
              % ("max_loc" if case[8] is not None else "max_loc_U", name,
                 card, case[2], info_d["omega_init"], info_d["omega"], floor,
                 info_d["n_iter"], info_d["grad_norm"], MAXLOC["tol"],
                 info_d["converged"], info_c["converged"], info_c["n_iter"],
                 sec_d, 1e3 * sec_d / info_d["n_iter"], sec_c, d))
        if not (d <= 1e-8 and info_d["omega"] - floor < 1e-8
                and info_d["converged"] and info_c["converged"]):
            bad.append(name)
    if bad:
        raise AssertionError("11e failed: %s" % bad)


def ints_hchain():
    from libdmet_preview_tpu_torch import workloads as wl
    from libdmet_preview_tpu_torch.models.engine_ints import load_engine_ints
    return load_engine_ints(wl.HCHAIN_FILE)


def phase_abinitio_lattices(device, card):
    """Phase 11.  Returns the tri kernel's launches on the H-chain paths,
    and its max_abs_err and timing at the shape it has there."""
    from libdmet_preview_tpu_torch import workloads as wl
    ints = ints_hchain()
    print("11 engine arrays %s: %d AOs, %d electrons, %d cells (%s)"
          % (wl.HCHAIN_FILE, ints.nao, ints.nelectron, ints.ncells,
             ints.source))
    launches, shape = phase_hchain_ib(device, card, ints)
    launches += phase_hchain_variants(device, card, ints)
    phase_hchain_nib_uhf(device, card, ints)
    phase_kscf(device, card)
    phase_maxloc(device, card)
    err, ms, plain_ms, bound, by = tri_kernel_at(shape, device, card)
    return launches, err, {
        "shape": list(shape), "launches": launches, "ms": ms,
        "plain_ms": plain_ms, "library_ms": plain_ms, "bound_ms": bound,
        "bound_by": by}


# ----------------------------------------------------------------------
# phase 12: the CAS solver family, tailored CC, OO-MP2 / OO-CCD, static GW
# and the external-solver bridges
# ----------------------------------------------------------------------

CAS_AI = {"ucasci": (12, 12), "utccsd": (8, 8), "tol": 1e-10,
          # the CPU replay of UTCCSD: phase 6's construction at 4 cells x
          # 12 LOs (48 spin orbitals), UTCCSD(4, 4) on card and CPU
          "replay": {"ncells": 4, "nlo": 12, "naux": 100, "cas": (4, 4)}}
CAS_TOL = {"E": 1e-8, "rdm1": 1e-7, "E from the RDMs": 1e-8}
HCHAIN_CAS = {"casci": (6, 4), "casscf": (4, 4)}


def cas_oracles(device, work=None):
    """12a's oracles on `device`: {name: (value, tolerance)}; a tolerance
    None means the value must be below 0.  work, a dict, receives the
    orbital optimizers' counts (Newton minimizations, gradients and HVPs
    of the CASSCFs; energy-and-gradient evaluations of the OO-CCD BFGS
    runs, one adjoint solve each)."""
    from libdmet_preview_tpu_torch import solvers as S
    from libdmet_preview_tpu_torch import workloads as wl
    dev = dict(device=device)
    out = {}
    work = {} if work is None else work
    H = wl.hubbard_integral(4, 4.0)
    E_fci = S.FCI(restricted=True, tol=1e-12, **dev).run(H, nelec=4)[1]
    out["CASCI(4,4) - FCI, 4-site U=4"] = (
        S.CASCI(4, 4, tol=1e-12, **dev).run(H, nelec=4)[1] - E_fci, 1e-9)
    out["TCCSD(4,4) - FCI, 4-site U=4"] = (
        S.TCCSD(4, 4, restricted=True, tol=1e-10, **dev).run(H, nelec=4)[1]
        - E_fci, 1e-7)
    H = wl.random_integral(4, 11)
    E_fci = S.FCI(restricted=True, tol=1e-12, **dev).run(H, nelec=4)[1]
    out["CASSCF(4,4) - FCI, random seed 11"] = (
        S.CASSCF(4, 4, max_cycle=60, **dev).run(H, nelec=4)[1] - E_fci, 1e-8)
    H = wl.hubbard_integral(4, 4.0, ring=True,
                            onsite=[-0.8, 0.3, -0.1, 0.6])
    E_fci = S.FCI(restricted=False, tol=1e-12, **dev).run(H, nelec=4)[1]
    out["UCASSCF ring: FCI - (-2.1477353252387)"] = (
        E_fci + 2.1477353252387, 1e-8)
    mc = S.UCASSCF(3, 2, Sz=0, tol=1e-7, max_cycle=20, **dev)
    out["UCASSCF(3,2) - (-1.8841957321182)"] = (
        mc.run(H, nelec=4)[1] + 1.8841957321182, 1e-6)
    work["UCASSCF(3,2)"] = mc.counts
    out["UCASSCF(3,2) run_dmet_ham - E"] = (mc.run_dmet_ham(H) - mc.e_tot,
                                           1e-8)
    H = wl.gso_ring()
    E_fci = S.FCI(restricted=True, ghf=True, tol=1e-12, **dev).run(
        H, nelec=4)[1]
    out["GCASSCF ring: FCI(ghf) - (-8.42442890089805)"] = (
        E_fci + 8.42442890089805, 1e-8)
    mc = S.GCASSCF(6, 2, tol=1e-7, max_cycle=15, **dev)
    out["GCASSCF(6,2) - (-8.188240873805)"] = (
        mc.run(H, nelec=4)[1] + 8.188240873805, 1e-6)
    work["GCASSCF(6,2)"] = mc.counts
    H = wl.oo_integral()
    for name, Hx, kw in (("restricted", H, dict(restricted=True)),
                         ("GHF", wl.spin_orbital_integral(H),
                          dict(ghf=True))):
        E_fci = S.FCI(tol=1e-12, **kw, **dev).run(Hx, nelec=2)[1]
        oo = S.OOCCD(oo_gtol=1e-8, **kw, **dev)
        out["OOCCD - FCI, 2 electrons, %s" % name] = (
            oo.run(Hx, nelec=2)[1] - E_fci, 1e-6)
        work["OOCCD %s: evaluations" % name] = oo.n_eval
    H = wl.hubbard_integral(4, 2.0, stag=0.3)
    E_fci = S.FCI(restricted=False, tol=1e-12, **dev).run(H, nelec=2)[1]
    oo = S.OOCCD(restricted=False, oo_gtol=1e-8, **dev)
    out["OOCCD - FCI, 2 electrons, unrestricted"] = (
        oo.run(H, nelec=2)[1] - E_fci, 1e-6)
    work["OOCCD unrestricted: evaluations"] = oo.n_eval
    H = wl.hubbard_integral(6, 4.0)
    E_fci = S.FCI(restricted=True, tol=1e-12, **dev).run(H, nelec=6)[1]
    E_cc = S.CCSD(restricted=True, tol=1e-9, **dev).run(H, nelec=6)[1]
    E_tcc = S.TCCSD(4, 4, restricted=True, tol=1e-9, **dev).run(H,
                                                                nelec=6)[1]
    out["|TCCSD(4,4) - FCI| - |CCSD - FCI|, 6-site U=4"] = (
        abs(E_tcc - E_fci) - abs(E_cc - E_fci), None)
    fock, eri = wl.random_uhf_fock()
    vs = S.get_vsig_emb(fock, eri, (2, 1), screened=False, **dev)
    ref = wl.bare_exchange(torch.as_tensor(fock, device=device),
                           torch.as_tensor(eri, device=device), (2, 1))
    out["get_vsig_emb bare limit + K (max abs)"] = (
        float(torch.max(torch.abs(vs - ref))), 1e-8)
    return out


def bridge_checks(device, tmp):
    """The DMRG, FCIDUMP and QMC bridges with fake executables written to
    `tmp` (workloads.FAKE_BLOCK, the JAX suite's NumPy-only fake Block
    binary; SHCI and AFQMC fakes with the port's FCI on the CPU behind
    their file formats), their
    RDMs read back as tensors on `device`, against the port's FCI there:
    {name: (value, tolerance)}."""
    import sys
    from libdmet_preview_tpu_torch import solvers as S
    from libdmet_preview_tpu_torch import workloads as wl
    from libdmet_preview_tpu_torch.solvers import qmc
    dev = dict(device=device)
    out = {}
    py = sys.executable
    block = [py, wl.write_fake(tmp, "fake_block.py", wl.FAKE_BLOCK),
             "{conf}"]

    def dmrg(wd, **kw):
        s = S.BlockDMRG(block, max_M=600, workdir=os.path.join(tmp, wd),
                        **kw, **dev)
        s.schedule = S.Schedule(sweep_tol=1e-8).gen_initial(100, 600)
        return s

    H = wl.random_integral(4, 7)
    fci = S.FCI(restricted=True, tol=1e-12, **dev)
    r_f, E_f = fci.run(H, nelec=4)
    r_d, E_d = dmrg("block", twopdm=False).run(H, nelec=4)
    out["BlockDMRG E - FCI"] = (E_d - E_f, 1e-8)
    out["BlockDMRG rdm1 - FCI (max abs)"] = (
        float(torch.max(torch.abs(r_d - r_f))), 1e-7)
    r_c, E_c = S.CASCI(2, 2, fcisolver=dmrg("dmrgci", twopdm=False),
                       **dev).run(H, nelec=4)
    r_c2, E_c2 = S.CASCI(2, 2, **dev).run(H, nelec=4)
    out["DMRG-CI(2,2) E - CASCI(2,2)"] = (E_c - E_c2, 1e-7)
    GH = wl.gso_ring(3, 2.0)
    gs = S.GCASSCF(4, 2, tol=1e-6, max_cycle=8, fcisolver=dmrg(
        "dmrgscf", restricted=False, Sz=2, spin_adapted=False, twopdm=True),
        **dev)
    E_g = gs.run(GH, nelec=3)[1]
    E_g2 = S.GCASSCF(4, 2, tol=1e-6, max_cycle=8, **dev).run(GH, nelec=3)[1]
    out["GSO DMRG-SCF E - GCASSCF"] = (E_g - E_g2, 1e-6)

    stub = os.path.join(tmp, "stub_solver.py")
    with open(stub, "w") as f:
        f.write("import sys, numpy as np\n"
                "assert open(sys.argv[1]).readline().startswith(' &FCI')\n"
                "np.savetxt(sys.argv[2] + '/rdm1.txt', np.eye(4) * 0.5)\n"
                "print('converged E = -2.718281828')\n")
    ext = S.ExternalFCIDUMPSolver([py, stub, "{fcidump}", "{workdir}"],
                                  rdm1_file="rdm1.txt",
                                  workdir=os.path.join(tmp, "ext"), **dev)
    r_e, E_e = ext.run(wl.hubbard_integral(4, 1.0), nelec=4)
    out["ExternalFCIDUMPSolver E + 2.718281828"] = (E_e + 2.718281828, 1e-12)
    out["ExternalFCIDUMPSolver rdm1[0, 0, 0] - 0.25"] = (
        float(r_e[0, 0, 0]) - 0.25, 1e-12)

    H = wl.hubbard_integral(4, 4.0)
    r_f, E_f = S.FCI(restricted=True, tol=1e-12, **dev).run(H, nelec=4)
    shci = qmc.SHCI(executable=wl.write_fake(tmp, "fake_shci.py",
                                             wl.SHCI_FAKE),
                    workdir=os.path.join(tmp, "shci"), restricted=True, **dev)
    r_s, E_s = shci.run(H, nelec=4, calc_rdm2=True)
    h1 = torch.as_tensor(H.H1["cd"][0], device=device)
    g = torch.as_tensor(H.H2["ccdd"][0], device=device)
    E_rdm = float(2.0 * torch.sum(h1 * r_s[0])
                  + 0.5 * torch.sum(g * shci.twopdm[0])) + float(H.H0)
    out["SHCI E - FCI"] = (E_s - E_f, 1e-9)
    out["SHCI E from the RDMs read back - FCI"] = (E_rdm - E_f, 1e-8)
    E_uf = S.FCI(restricted=False, tol=1e-12, **dev).run(
        wl.np_integral(np.stack([H.H1["cd"][0]] * 2),
                     np.stack([H.H2["ccdd"][0]] * 3)), nelec=4)[1]
    af = qmc.AFQMC(executable=wl.write_fake(tmp, "fake_afqmc.py",
                                            wl.AFQMC_FAKE),
                   workdir=os.path.join(tmp, "afqmc"), **dev)
    r_a, E_a = af.run(H, nelec=4)
    out["AFQMC |E - FCI| / (6 x its error bar)"] = (
        abs(E_a - E_uf) / (6 * af.e_err) - 1.0, None)
    out["AFQMC tr(rdm1) - nelec"] = (float(torch.sum(torch.diagonal(
        r_a, dim1=1, dim2=2))) - 4.0, 1e-6)
    return out


def phase_cas_oracles(device, card):
    """12a: the JAX suite's oracles of the CAS family, tailored CC, OO-CCD
    and static GW at their own sizes on the card and on the CPU, and the
    three bridges with fake executables."""
    import shutil
    t0 = time.perf_counter()
    work = {}
    res_d = cas_oracles(device, work)
    t_d = time.perf_counter() - t0
    t0 = time.perf_counter()
    res_c = cas_oracles(torch.device("cpu"))
    t_c = time.perf_counter() - t0
    bad = []
    for k, (v, tol) in res_d.items():
        vc = res_c[k][0]
        ok = (v <= 0.0) if tol is None else abs(v) <= tol
        print("12a %-50s card %.3e, CPU %.3e, |card - CPU| %.1e (%s)"
              % (k, v, vc, abs(v - vc),
                 "must be < 0" if tol is None else "tol %.0e" % tol))
        if not ok or (tol is not None and not abs(vc) <= tol) \
                or not abs(v - vc) <= 1e-8:
            bad.append(k)
    print("12a oracles [%s]: %.1f s on the card, %.1f s on the CPU; orbital "
          "work on the card: %s" % (card, t_d, t_c, work))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_bridges_")
    try:
        t0 = time.perf_counter()
        for k, (v, tol) in bridge_checks(device, tmp).items():
            ok = (v <= 0.0) if tol is None else abs(v) <= tol
            print("12a bridge %-44s %.3e (%s)"
                  % (k, v, "must be < 0" if tol is None else "tol %.0e" % tol))
            if not ok:
                bad.append(k)
        print("12a bridges [%s]: %.1f s (each fake binary a subprocess)"
              % (card, time.perf_counter() - t0))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if bad:
        raise AssertionError("12a failed: %s" % bad)


def _cas_counts():
    from libdmet_preview_tpu_torch.solvers import cc
    return {"adjoint": cc._solve_adjoint.calls,
            "masked adjoint": cc._solve_adjoint_masked.calls}


def run_abinitio_cas(r, device):
    """12b's main path on phase 6's lattice: ConstructImpHam, then
    UCASCI and UTCCSD (windows CAS_AI["ucasci"], CAS_AI["utccsd"]) from the
    converged UHF density of phase 6's SCF as dm0, with transformResults
    each, and get_vsig_emb on the embedding UHF Fock and ERI.  Returns the
    results and the stage seconds."""
    import libdmet_preview_tpu_torch.dmet.hubbard as dmet
    from libdmet_preview_tpu_torch import workloads as wl
    from libdmet_preview_tpu_torch.solvers import UCASCI, UTCCSD, get_vsig_emb
    from libdmet_preview_tpu_torch.solvers.scf import _veff_uhf
    from libdmet_preview_tpu_torch.utils import timer
    Lat = r["Lat"]
    out = {}
    with timer.recording() as sec:
        with timer.stage("ConstructImpHam", device):
            ImpHam, H1e, basis = dmet.ConstructImpHam(
                Lat, r["rho"], r["vcor"], matching=True, int_bath=True)
        nel, dm0 = r["nel"], r["rdm1"]
        for name, solver in (
                ("UCASCI", UCASCI(*CAS_AI["ucasci"], tol=CAS_AI["tol"],
                                  device=device)),
                ("UTCCSD", UTCCSD(*CAS_AI["utccsd"], restricted=False,
                                  tol=CAS_AI["tol"], device=device))):
            with timer.stage("%s.run" % name, device):
                rdm1, E = solver.run(ImpHam, nelec=nel, dm0=dm0)
            with timer.stage("%s energy" % name, device):
                _, E_cell, n_cell = dmet.transformResults(
                    rdm1, E, basis, ImpHam, H1e, lattice=Lat, last_dmu=0.0,
                    int_bath=True, solver=solver,
                    solver_args={"nelec": nel})
                E_rdm = solver.run_dmet_ham(ImpHam)
            out[name] = {"solver": solver, "rdm1": rdm1, "E": E,
                         "E_cell": E_cell, "n_cell": n_cell, "E_rdm": E_rdm}
        with timer.stage("get_vsig_emb", device):
            H2 = ImpHam.H2["ccdd"]
            h1 = ImpHam.H1["cd"]
            dm = torch.as_tensor(dm0, device=device)
            fock = h1 + torch.stack(_veff_uhf(dm[0], dm[1], H2[0], H2[1],
                                              H2[2]))
            nocc = tuple(int(round(float(torch.trace(x)))) for x in dm)
            out["vsig"] = get_vsig_emb(fock, H2, nocc, device=device)
            out["vsig bare"] = get_vsig_emb(fock, H2, nocc, screened=False,
                                            chol_tol=1e-12, device=device)
            out["-K"] = wl.bare_exchange(fock, H2[0], nocc)
    out.update({"ImpHam": ImpHam, "nel": nel, "dm0": dm0})
    return out, sec


def _cas_replay(ImpHam, nel, dm0, cls, args, kw, device):
    """One solver's run on `device` from the same Hamiltonian and dm0;
    returns (rdm1, E, E from the RDMs)."""
    from libdmet_preview_tpu_torch.models.integral import Integral
    H = Integral(ImpHam.norb, ImpHam.restricted, False, ImpHam.H0,
                 {"cd": ImpHam.H1["cd"].to(device)},
                 {"ccdd": ImpHam.H2["ccdd"].to(device)})
    solver = cls(*args, device=device, **kw)
    rdm1, E = solver.run(H, nelec=nel, dm0=torch.as_tensor(dm0).to(device))
    return rdm1, E, solver.run_dmet_ham(H)


def tccsd_detail(solver, ImpHam, device, seed=17):
    """UTCCSD's masked path once more at the solver's orbitals and frozen
    CAS amplitudes: the frozen amplitude solve again on `device` (its
    energy against the run's, its frozen entries against the CAS
    amplitudes), then one masked residual and one masked adjoint matvec
    at the converged amplitudes on `device` and on the CPU.  Returns
    ({name: (value, tolerance)}, seconds of the CPU's two evaluations)."""
    from libdmet_preview_tpu_torch.solvers import cc as tcc
    from libdmet_preview_tpu_torch.utils.misc import as_f64
    Ca, Cb, na, nb = solver._mo
    nocc = na + nb
    frozen = solver.frozen
    blocks = solver._unpack(ImpHam)
    with torch.no_grad():
        h_so, g = tcc._mo_so_integrals(blocks[:2], blocks[2:],
                                       as_f64(Ca, device), as_f64(Cb, device),
                                       na, nb)
        W = tcc._antisymmetrize(g)
        del g
        t1, t2, conv = tcc._solve_amplitudes_frozen(
            h_so, W, *frozen, nocc, **dict(solver._opts()))
        E = float(tcc._e_ref(h_so, W, nocc)
                  + tcc._ecorr(t1, t2, h_so, W, nocc)) + float(ImpHam.H0)
    m1, t1f, m2, t2f = frozen
    out = {"UTCCSD E from the amplitudes again - E of the run": (
        E - solver.e_tot, 1e-8)}
    out["frozen entries - CAS amplitudes (max abs)"] = (max(
        float(torch.max(torch.abs(torch.where(m > 0, t - tf, 0.0))))
        for m, t, tf in ((m1, t1, t1f), (m2, t2, t2f))), 0.0)
    x = torch.cat([v.reshape(-1) for v in _seeded_amplitudes(
        nocc, h_so.shape[0] - nocc, seed, device)])

    def evaluate(dev):
        h, Wd, a1, a2 = (v.to(dev) for v in (h_so, W, t1, t2))
        f1, f2 = (v.to(dev) for v in (m1, m2))
        with torch.no_grad():
            R1, R2 = tcc._residual(a1, a2, h, Wd, nocc)
            R = (torch.where(f1 > 0, 0.0, R1), torch.where(f2 > 0, 0.0, R2))
        A = tcc._masked_adjoint_operator(h, Wd, nocc, a1, a2, f1, f2)[0]
        return R, A(x.to(dev))

    R_d, A_d = evaluate(device)
    cpu = torch.device("cpu")
    t0 = time.perf_counter()
    R_c, A_c = evaluate(cpu)
    t_cpu = time.perf_counter() - t0
    scale = float(torch.max(torch.abs(W[:nocc, :nocc, nocc:, nocc:])))
    out["masked residual: max|R| on the relaxed entries"] = (
        max(float(torch.max(torch.abs(r))) for r in R_d), CAS_AI["tol"])
    out["masked residual card - CPU (rel. to max|W_oovv|)"] = (max(
        float(torch.max(torch.abs(a.to(cpu) - b)))
        for a, b in zip(R_d, R_c)) / scale, 1e-10)
    out["masked adjoint matvec card - CPU (rel.)"] = (
        float(torch.max(torch.abs(A_d.to(cpu) - A_c)))
        / float(torch.max(torch.abs(A_c))), 1e-10)
    if not conv:
        out["frozen amplitude solve converged"] = (1.0, 0.0)
    return out, t_cpu


def exchange_spread(ImpHam):
    """The aa block of the embedding ERI: the means of the exchange-type
    (pq|pq) and the Coulomb-type (pp|qq) integrals over p != q, and the
    root mean square of all its entries."""
    g = ImpHam.H2["ccdd"][0]
    off = ~torch.eye(g.shape[0], dtype=torch.bool, device=g.device)
    return (float(torch.einsum("pqpq -> pq", g)[off].mean()),
            float(torch.einsum("ppqq -> pq", g)[off].mean()),
            float(torch.sqrt(torch.mean(g ** 2))))


def phase_abinitio_cas(d, device, card, E_ccsd):
    """12b on phase 6's embedding problem (neo = 60, 120 spin orbitals; run
    right after 9a, whose UCCSD energy is E_ccsd): counts from 0 for the
    path; UTCCSD(8, 8) against UCCSD and its masked residual and adjoint
    matvec at 120 spin orbitals card vs CPU; UCASCI(12, 12) replayed on
    the CPU from the same Hamiltonian and dm0; UTCCSD on the CPU at phase
    6's construction cut to 4 cells x 12 LOs."""
    from libdmet_preview_tpu_torch.ops.eri_kernels import syrk_df
    from libdmet_preview_tpu_torch.solvers import FCI, UCASCI, UTCCSD, cc
    torch.cuda.reset_peak_memory_stats()
    _sync(device)
    syrk_df.launches = 0
    syrk_df.cross_launches = 0
    counts0 = _cas_counts()
    t0 = time.perf_counter()
    with _counted_plain_calls() as plain_calls:
        r, sec = run_abinitio_cas(d, device)
    _sync(device)
    wall = time.perf_counter() - t0
    launches = {"syrk_df": syrk_df.launches,
                "syrk_df_cross": syrk_df.cross_launches}
    counts = {k: v - counts0[k] for k, v in _cas_counts().items()}
    peak = torch.cuda.max_memory_allocated() / 1e9
    ImpHam, nel = r["ImpHam"], r["nel"]
    uc, ut = r["UCASCI"]["solver"], r["UTCCSD"]["solver"]
    amp = dict(cc._solve_amplitudes_frozen.last)
    adj = dict(cc._solve_adjoint_masked.last)
    print("12b abinitio CAS [%s]: neo=%d (%d spin orbitals), nelec=%d; "
          "UCASCI%s active FCI %d determinants, %d sigma builds; UTCCSD%s "
          "CAS FCI %d sigma builds, amplitudes %d iterations (max|R| %.3e), "
          "masked adjoint %d matvecs (residual %.3e, %s), adjoint solves %s; "
          "%.2f s, peak device memory %.3f GB; syrk_df launches %d, cross "
          "launches %d, plain-version calls on CUDA tensors %d"
          % (card, ImpHam.norb, 2 * ImpHam.norb, nel, CAS_AI["ucasci"],
             uc.fcisolver.ci.numel(), uc.fcisolver.n_sigma, CAS_AI["utccsd"],
             ut.cas_counter["sigma"], amp["iterations"], amp["max|R|"],
             adj["matvecs"], adj["residual"], adj["branch"], counts, wall,
             peak, launches["syrk_df"], launches["syrk_df_cross"],
             plain_calls["cuda"]))
    for k, v in sec.items():
        print("12b abinitio CAS [%s]: stage %-32s %.6f s (%d call%s)"
              % (card, k, sum(v), len(v), "" if len(v) == 1 else "s"))
    scf = sum(sec.get("CAS reference SCF", [])) \
        + sum(sec.get("CC reference SCF", []))
    print("12b abinitio CAS [%s]: the two reference UHFs (dm0 = phase 6's "
          "converged density; their host BFGS stability check) %.3f s, "
          "%.1f%% of the path" % (card, scf, 100.0 * scf / wall))
    for name in ("UCASCI", "UTCCSD"):
        x = r[name]
        print("12b %s [%s]: E %.10f (UHF %.10f), E/cell %.10f, nelec/cell "
              "%.10f" % (name, card, x["E"], x["solver"].scfsolver.e_tot
                         if name == "UTCCSD" else x["solver"].scf.e_tot,
                         x["E_cell"], x["n_cell"]))
    # the scale of this Hamiltonian's correlation: 9a's UCCSD on the same
    # embedding problem, the tailoring's shift from it, and the integrals
    # behind it
    E_uhf = ut.scfsolver.e_tot
    K, J, rms = exchange_spread(ImpHam)
    print("12b [%s]: E(UCCSD, 9a) - E(UHF) %.10f; E(UTCCSD%s) - E(UCCSD) "
          "%.10f; E(UCASCI%s) - E(UHF) %.10f; the aa ERI's mean (pq|pq) "
          "%.6f, mean (pp|qq) %.6f (p != q), rms %.6f"
          % (card, E_ccsd - E_uhf, CAS_AI["utccsd"], r["UTCCSD"]["E"]
             - E_ccsd, CAS_AI["ucasci"], r["UCASCI"]["E"] - uc.scf.e_tot, K,
             J, rms))
    checks = {}
    t0 = time.perf_counter()
    detail, t_cpu = tccsd_detail(ut, ImpHam, device)
    print("12b UTCCSD%s masked path again at %d spin orbitals: %.1f s, of "
          "it the CPU's residual and adjoint matvec %.1f s"
          % (CAS_AI["utccsd"], 2 * ImpHam.norb, time.perf_counter() - t0,
             t_cpu))
    checks.update(detail)
    for name in ("UCASCI", "UTCCSD"):
        x = r[name]
        checks["%s run_dmet_ham - E" % name] = (x["E_rdm"] - x["E"], 1e-8)
        checks["%s tr(rdm1) - nelec" % name] = (float(
            torch.trace(x["rdm1"][0]) + torch.trace(x["rdm1"][1])) - nel,
            1e-8)
    vs, vb, mk = r["vsig"], r["vsig bare"], r["-K"]
    checks["get_vsig_emb bare limit + K (rel)"] = (
        float(torch.max(torch.abs(vb - mk)) / torch.max(torch.abs(mk))),
        1e-10)
    checks["get_vsig_emb asymmetry"] = (float(torch.max(torch.abs(
        vs - vs.transpose(1, 2)))), 1e-12)
    print("12b get_vsig_emb [%s]: max|vsig| %.6f, max|vsig - vsig_bare| %.6f"
          % (card, float(torch.max(torch.abs(vs))),
             float(torch.max(torch.abs(vs - vb)))))
    if device.type == "cuda":
        # idle share of the card over one cold active-space FCI of UCASCI
        Ham_cas = uc._cas[4]
        fci = FCI(restricted=False, Sz=uc.na_cas - uc.nb_cas,
                  tol=CAS_AI["tol"], device=device)
        with _Profiled() as prof:
            fci.run(Ham_cas, nelec=uc.na_cas + uc.nb_cas)
        print("12b UCASCI active FCI again, cold, profiled [%s]: %d sigma "
              "builds, idle share of the card %s"
              % (card, fci.n_sigma, "not measured" if prof.idle is None
                 else "%.4f" % prof.idle))

    # the CPU replays: UCASCI from the card's reference UHF (its MOs; the
    # CPU's own UHF, ~37 s, is not rerun: phase 6 holds that UHF card vs
    # CPU): the CAS transform at full width on the CPU, its active-space
    # FCI started from the card's converged vector (a cold start takes
    # ~70 sigma builds of ~3 s on the CPU), the back-transformed rdm1 and
    # run_dmet_ham; UTCCSD on a cut problem
    from libdmet_preview_tpu_torch import workloads as wl
    from libdmet_preview_tpu_torch.solvers.casci import _unpack_uhf
    cpu = torch.device("cpu")
    t0 = time.perf_counter()
    fci_c = FCI(restricted=False, Sz=uc.na_cas - uc.nb_cas,
                tol=CAS_AI["tol"], device=cpu)
    fci_c.ci = uc.fcisolver.ci.cpu()
    uc_c = UCASCI(*CAS_AI["ucasci"], tol=CAS_AI["tol"], fcisolver=fci_c,
                  device=cpu)
    Ham_c = wl.integral_to(ImpHam, cpu)
    n_a = (nel + uc.Sz) // 2
    nca, ncb = n_a - uc.na_cas, nel - n_a - uc.nb_cas
    mo = torch.as_tensor(uc.scf.mo_coeff).cpu()
    Ca, Cb = mo[0], mo[-1]
    Aa, Ab = Ca[:, nca:nca + uc.ncas], Cb[:, ncb:ncb + uc.ncas]
    cas_c, dmca, dmcb = uc_c._ham_cas(_unpack_uhf(Ham_c, cpu), Ham_c.H0,
                                      Ca[:, :nca], Cb[:, :ncb], Aa, Ab)
    Ec = uc_c._solve_cas(cas_c, Aa, Ab, dmca, dmcb)
    Erc = uc_c.run_dmet_ham(Ham_c)
    print("12b UCASCI on the CPU from the card's UHF and CI vector: %.1f s, "
          "%d sigma builds" % (time.perf_counter() - t0, fci_c.n_sigma))
    cas_d, x = uc._cas[4], r["UCASCI"]
    checks["UCASCI CAS transform card - CPU: e_core"] = (
        cas_d.H0 - cas_c.H0, CAS_TOL["E"])
    for k in ("cd", "ccdd"):
        blocks = cas_d.H1 if k == "cd" else cas_d.H2
        blocks_c = cas_c.H1 if k == "cd" else cas_c.H2
        checks["UCASCI CAS transform card - CPU: %s (max abs)" % k] = (
            float(torch.max(torch.abs(torch.as_tensor(blocks[k]).cpu()
                                      - torch.as_tensor(blocks_c[k])))),
            CAS_TOL["E"])
    checks["UCASCI card - CPU: E"] = (x["E"] - Ec, CAS_TOL["E"])
    checks["UCASCI card - CPU: rdm1 (max abs)"] = (float(torch.max(
        torch.abs(x["rdm1"].cpu() - uc_c.onepdm))), CAS_TOL["rdm1"])
    checks["UCASCI card - CPU: run_dmet_ham"] = (x["E_rdm"] - Erc,
                                                 CAS_TOL["E from the RDMs"])
    rp = CAS_AI["replay"]
    t0 = time.perf_counter()
    wl_small = make_abinitio_workload(ncells=rp["ncells"], nlo=rp["nlo"],
                                      naux=rp["naux"])
    # the same embedding problem on both (the bath's SVD gauge differs
    # between the card's and the CPU's runs of the construction)
    rs = run_abinitio_uhf(*wl_small, device, ncells=rp["ncells"])[0]
    (r1d, Ed, Erd), (r1c, Ec, Erc) = (
        _cas_replay(rs["ImpHam"], rs["nel"], rs["rdm1"], UTCCSD, rp["cas"],
                    {"restricted": False, "tol": CAS_AI["tol"]}, dv)
        for dv in (device, cpu))
    print("12b UTCCSD%s at %d cells x %d LOs (%d spin orbitals), card and "
          "CPU on the card's embedding problem: %.1f s"
          % (rp["cas"], rp["ncells"], rp["nlo"], 4 * rp["nlo"],
             time.perf_counter() - t0))
    checks["UTCCSD (cut) card - CPU: E"] = (Ed - Ec, CAS_TOL["E"])
    checks["UTCCSD (cut) card - CPU: rdm1 (max abs)"] = (float(torch.max(
        torch.abs(r1d.cpu() - r1c))), CAS_TOL["rdm1"])
    checks["UTCCSD (cut) card - CPU: run_dmet_ham"] = (
        Erd - Erc, CAS_TOL["E from the RDMs"])
    checks["UTCCSD (cut) run_dmet_ham - E"] = (Erd - Ed, 1e-8)
    bad = []
    for k, (v, tol) in checks.items():
        print("12b %-56s %.3e (tol %.0e)" % (k, v, tol))
        if not abs(v) <= tol:
            bad.append(k)
    if launches != {"syrk_df": 2, "syrk_df_cross": 1} \
            or plain_calls["cuda"] != 0 or ImpHam.norb != PATH_SHAPE[1]:
        bad.append("launch counts %s, plain calls %d"
                   % (launches, plain_calls["cuda"]))
    if not (amp["converged"] and adj["residual"] <= 1e-8
            and r["UTCCSD"]["E"] < ut.scfsolver.e_tot
            and r["UCASCI"]["E"] < uc.scf.e_tot):
        bad.append("convergence or energies")
    # tailoring with the (8, 8) window moves E off UCCSD by less than the
    # whole correlation energy of the larger (12, 12) window
    if not abs(r["UTCCSD"]["E"] - E_ccsd) < uc.scf.e_tot - r["UCASCI"]["E"]:
        bad.append("UTCCSD - UCCSD")
    if bad:
        raise AssertionError("12b failed: %s" % bad)
    return launches


def phase_hchain_cas(device, card, ints):
    """12c: the H-chain interacting-bath loop with CASCI on the whole
    embedding space (each iteration replayed with FCI from the same state
    on the card, 1e-8) and with CASSCF on a smaller active space (converged;
    its last iteration replayed on the CPU, 1e-8).  Returns the tri
    kernel's launches."""
    from libdmet_preview_tpu_torch import workloads as wl
    from libdmet_preview_tpu_torch.ops import eri_kernels as ek
    from libdmet_preview_tpu_torch.solvers import CASCI, CASSCF
    from libdmet_preview_tpu_torch.utils import timer
    bad, launches = [], 0
    runs = [("CASCI%s" % (HCHAIN_CAS["casci"],),
             lambda dv: CASCI(*HCHAIN_CAS["casci"], tol=1e-12, device=dv)),
            ("CASSCF%s" % (HCHAIN_CAS["casscf"],),
             lambda dv: CASSCF(*HCHAIN_CAS["casscf"], tol=1e-8, device=dv))]
    for name, make in runs:
        Lat, meta = wl.hchain_lattice(ints, device)
        solver = make(device)
        # the path: counts start at 0 here
        _sync(device)
        ek.syrk_df.launches = 0
        ek.syrk_df.cross_launches = 0
        t0 = time.perf_counter()
        with _counted_plain_calls() as plain_calls, \
                timer.recording() as sec:
            E, recs = wl.run_hchain_dmet(Lat, meta, solver, wl.IB_PROTOCOL)
        _sync(device)
        wall = time.perf_counter() - t0
        n_l = ek.syrk_df.launches
        launches += n_l
        print("12c H chain IB %s [%s]: E/cell %.12f, %d iterations, %.3f s; "
              "syrk_df launches %d (cross %d), plain-version calls on CUDA "
              "tensors %d" % (name, card, E, len(recs), wall, n_l,
                              ek.syrk_df.cross_launches, plain_calls["cuda"]))
        _print_hchain_stages("12c H chain IB %s" % name, card, sec, len(recs))
        if n_l != len(recs) or ek.syrk_df.cross_launches \
                or plain_calls["cuda"]:
            bad.append("%s launches" % name)
        if name.startswith("CASCI"):
            ref = wl.HCHAIN_JAX["IB FCI"]
            if not abs(E - ref) <= wl.IB_JAX_TOL:
                bad.append("CASCI loop vs the JAX FCI value")
            fci = wl.hchain_solver("FCI", device)
            L2, m2 = wl.hchain_lattice(ints, device)
            for rec in recs:
                out = wl.replay_hchain_iteration(L2, m2, fci, wl.IB_PROTOCOL,
                                                 rec)
                diffs = [abs(out[0] - rec["E"]), abs(out[1] - rec["nelec"]),
                         abs(out[3] - rec["fit_err"])]
                print("12c iteration %d: CASCI loop - FCI from the same "
                      "state: E %.3e, nelec %.3e, fit error %.3e (tol %.0e)"
                      % (rec["iter"], diffs[0], diffs[1], diffs[2], LOOP_TOL))
                if not max(diffs) <= LOOP_TOL:
                    bad.append("CASCI iteration %d" % rec["iter"])
        else:
            if not len(recs) < wl.IB_PROTOCOL["max_iter"]:
                bad.append("CASSCF loop did not converge")
            rec = recs[-1]
            cpu = torch.device("cpu")
            Lc, mc = wl.hchain_lattice(ints, cpu)
            out = wl.replay_hchain_iteration(Lc, mc, make(cpu),
                                             wl.IB_PROTOCOL, rec)
            diffs = [abs(out[0] - rec["E"]), abs(out[1] - rec["nelec"]),
                     abs(out[3] - rec["fit_err"])]
            print("12c CASSCF iteration %d replayed on the CPU: E %.3e, nelec "
                  "%.3e, fit error %.3e (tol %.0e); orbital work of the loop "
                  "on the card: %s"
                  % (rec["iter"], diffs[0], diffs[1], diffs[2], LOOP_TOL,
                     solver.counts))
            if not max(diffs) <= LOOP_TOL:
                bad.append("CASSCF replay")
    if bad:
        raise AssertionError("12c failed: %s" % bad)
    return launches


# ----------------------------------------------------------------------
# phase 13: the molecular integral engine, KS-DFT and DFT-in-DMET
# ----------------------------------------------------------------------

DFT_TOL = {"card vs CPU": 1e-8, "E_ks vs JAX": 1e-8, "n_grid vs JAX": 1e-10,
           "DMET vs JAX": 1e-8, "Becke weights": 1e-14, "Fock rebuild": 1e-10,
           "RKS(None, hyb=1) - RHF": 1e-8, "HF-limit identity": 1e-11,
           "replay": 1e-8}


def _in_range(x, lo, hi):
    """<= 0 when lo < x < hi (a range oracle in the (value, None) form)."""
    return max(lo - x, x - hi)


def _fd_vxc(D, ao, w, xc, aog, eps=1e-6):
    """Forward differences of E_xc (the JAX suite's tests/test_dft.py
    oracle, restricted), symmetrized."""
    from libdmet_preview_tpu_torch.ints.xc import eval_exc_vxc
    e0 = eval_exc_vxc(D, ao, w, True, xc, aog)[0]
    fd = torch.zeros_like(D)
    for i in range(D.shape[0]):
        for j in range(D.shape[1]):
            Dp = D.clone()
            Dp[i, j] += eps
            fd[i, j] = (eval_exc_vxc(Dp, ao, w, True, xc, aog)[0] - e0) / eps
    return 0.5 * (fd + fd.T)


def dft_oracles(device):
    """13a: the JAX suite's DFT oracles at its own sizes on `device`:
    {name: (value, tolerance)}; a tolerance None means the value must be
    below 0.  tests/test_dft.py, tests/test_dftu_ks.py, tests/test_md.py
    and the bare-exchange limit of tests/test_gw.py:21-35."""
    from libdmet_preview_tpu_torch.ints import grid as G, md as MD
    from libdmet_preview_tpu_torch.ints import xc as X
    from libdmet_preview_tpu_torch.ints.gto import Mole
    from libdmet_preview_tpu_torch.models.integral import Integral
    from libdmet_preview_tpu_torch.solvers import ksdft as K
    from libdmet_preview_tpu_torch.solvers.gw import get_vsig_emb
    from libdmet_preview_tpu_torch.solvers.scf import SCF
    dev = dict(device=device)
    out = {}
    h2 = Mole([("H", (0, 0, 0)), ("H", (0, 0, 1.4))], basis="sto-6g")
    hat = Mole([("H", (0, 0, 0))], basis="sto-6g")
    S = torch.as_tensor(h2.intor_ovlp(), device=device)

    def rhf(mol, nelec):
        Ham = Integral(mol.nao, True, False, mol.energy_nuc(),
                       {"cd": mol.intor_hcore()[None]},
                       {"ccdd": mol.intor_eri()[None]},
                       ovlp=mol.intor_ovlp())
        m = SCF(**dev)
        m.set_system(nelec, 0, False, True)
        m.set_integral(Ham)
        return m.HF(tol=1e-12, MaxIter=200)[0]

    # tests/test_dft.py
    g, w = G.becke_grid(h2, n_rad=60, **dev)
    ao = G.eval_ao(h2, g)
    out["grid overlap - S (max abs)"] = (
        float(((ao * w) @ ao.T - S).abs().max()), 1e-6)
    alpha = 0.8
    g1, w1 = G.becke_grid(hat, n_rad=80, n_theta=14, n_phi=28, **dev)
    N = (2 * alpha / np.pi) ** 0.75
    ao1 = (N * torch.exp(-alpha * (g1 ** 2).sum(dim=1)))[None]
    Cx = 0.75 * (3 / np.pi) ** (1 / 3.0)
    I = (N ** 2 / 2) ** (4 / 3.0) * (3 * np.pi / (8 * alpha)) ** 1.5
    ex = X.eval_exc_vxc(torch.ones((1, 1), dtype=torch.float64,
                                   device=device), ao1, w1, xc="slater")[0]
    out["Slater X of a Gaussian - analytic"] = (
        ex + Cx * 2 ** (1 / 3.0) * 2 * I, 1e-12)
    g40, w40 = G.becke_grid(h2, n_rad=40, **dev)
    ao40, aog40 = G.eval_ao(h2, g40), G.eval_ao_grad(h2, g40)
    rng = np.random.RandomState(0)
    A = rng.randn(2, 2)
    D = torch.as_tensor(A @ A.T * 0.3 + 0.4 * np.eye(2), device=device)
    for xc in ("lsda", "pbe"):
        v = X.eval_exc_vxc(D, ao40, w40, True, xc, aog40)[1]
        out["v_xc %s - forward differences" % xc] = (
            float((_fd_vxc(D, ao40, w40, xc, aog40) - v).abs().max()), 1e-6)
    hf = K.RKS(h2, xc=None, hyb=1.0, **dev)
    out["RKS(None, hyb=1) - RHF, H2"] = (hf.kernel()[0] - rhf(h2, 2), 1e-9)
    vj, vk = hf._jk(hf.dm)
    fock = torch.as_tensor(h2.intor_hcore(), device=device) + vj - 0.5 * vk
    vs = get_vsig_emb(fock, h2.intor_eri(), 2, ovlp=h2.intor_ovlp(),
                      screened=False, **dev)
    out["GW bare limit + K/2 (max abs)"] = (
        float((vs[0] + 0.5 * vk).abs().max()), 1e-9)
    ks = K.RKS(h2, xc="lsda", **dev)
    E_l, dm = ks.kernel()
    out["LSDA H2 tr(D S) - 2"] = (float((dm * S).sum()) - 2.0, 1e-9)
    out["LSDA H2 E in (-1.3, -0.9)"] = (_in_range(E_l, -1.3, -0.9), None)
    uks = K.UKS(hat, xc="lsda", nelec=(1, 0), **dev)
    E_u, dmu = uks.kernel()
    out["LSDA H atom E in (-0.6, -0.3)"] = (_in_range(E_u, -0.6, -0.3),
                                           None)
    out["LSDA H atom max |D_beta|"] = (float(dmu[1].abs().max()), 1e-10)
    E_l50 = K.RKS(h2, xc="lsda", n_rad=50, **dev).kernel()[0]
    E_p50 = K.RKS(h2, xc="pbe", n_rad=50, **dev).kernel()[0]
    out["PBE H2: E_PBE - E_LSDA"] = (E_p50 - E_l50, None)
    out["PBE H2: |E_PBE - E_LSDA| - 0.08"] = (abs(E_p50 - E_l50) - 0.08,
                                             None)
    eu = {xc: K.UKS(hat, xc=xc, nelec=(1, 0), n_rad=50, **dev).kernel()[0]
          for xc in ("lsda", "pbe")}
    out["PBE H atom: E_PBE - E_LSDA"] = (eu["pbe"] - eu["lsda"], None)
    out["PBE H atom: |E_PBE + 1/2| - |E_LSDA + 1/2|"] = (
        abs(eu["pbe"] + 0.5) - abs(eu["lsda"] + 0.5), None)
    zeta_rs = torch.as_tensor([0.5, 1.0, 2.0, 5.0, 10.0, 20.0],
                              device=device)
    dev_pw = 0.0
    for z in (0.0, 0.5, 0.999):
        zt = torch.full_like(zeta_rs, z)
        f = X._f_zeta(zt)
        vwn = X._vwn_eps(zeta_rs, "P") + X._vwn_eps(zeta_rs, "A") * f \
            / X._FPP0 * (1.0 - z ** 4) + (X._vwn_eps(zeta_rs, "F")
                                          - X._vwn_eps(zeta_rs, "P")) \
            * f * z ** 4
        dev_pw = max(dev_pw, float((X.pw92_eps_c(zeta_rs, zt)
                                    - vwn).abs().max()))
    out["PW92 - VWN5 (max abs)"] = (dev_pw, 2e-3)
    ra = torch.as_tensor(rng.rand(50) * 2.0 + 1e-3, device=device)
    rb = torch.as_tensor(rng.rand(50) * 2.0 + 1e-3, device=device)
    z0 = torch.zeros_like(ra)
    out["PBE(sigma = 0) - LDA(PW92)"] = (
        float((X.pbe_exc_density(ra, rb, z0, z0, z0)
               - X.ldapw_exc_density(ra, rb)).abs().max()), 1e-12)
    pts = torch.as_tensor(np.random.RandomState(2).randn(20, 3) * 1.5,
                          device=device)
    for name, mol in (
            ("Mole", Mole([("H", (0, 0, 0)), ("H", (0.2, -0.3, 1.4))],
                          basis="sto-6g")),
            ("MoleGeneral p/d", MD.MoleGeneral(
                [("H", (0.1, 0.0, -0.2))], basis="pd",
                basis_data={("H", "pd"): [(1, [(0.8, 1.0), (0.3, 0.5)]),
                                          (2, [(0.6, 1.0)])]}))):
        grad = G.eval_ao_grad(mol, pts)
        err = 0.0
        for ax in range(3):
            dp, dm_ = pts.clone(), pts.clone()
            dp[:, ax] += 1e-5
            dm_[:, ax] -= 1e-5
            fd = (G.eval_ao(mol, dp) - G.eval_ao(mol, dm_)) / 2e-5
            err = max(err, float((fd - grad[ax]).abs().max()))
        out["AO gradient %s - central differences" % name] = (err, 1e-8)
    # tests/test_dftu_ks.py
    ring = [("H", (np.cos(a) * 2.0, np.sin(a) * 2.0, 0.0))
            for a in 2 * np.pi * np.arange(6) / 6]
    mol6 = Mole(ring, basis="sto-6g")
    w6, v6 = np.linalg.eigh(mol6.intor_ovlp())
    C6 = v6 @ np.diag(w6 ** -0.5) @ v6.T
    e0, d0 = K.RKS(mol6, xc="lsda", n_rad=40, **dev).kernel()
    e1, d1 = K.RKSpU(mol6, C6, [[0, 1]], [0.0], xc="lsda", n_rad=40,
                     **dev).kernel()
    out["RKSpU(U = 0) - RKS"] = (e1 - e0, 1e-10)
    out["RKSpU(U = 0) - RKS, max |dD|"] = (float((d1 - d0).abs().max()),
                                          1e-8)
    eu0 = K.UKS(mol6, xc="lsda", n_rad=40, **dev).kernel()[0]
    eu1 = K.UKSpU(mol6, C6, [], [], xc="lsda", n_rad=40, **dev).kernel()[0]
    out["UKSpU(no U) - UKS"] = (eu1 - eu0, 1e-10)
    ksu = K.RKSpU(mol6, C6, [[0]], [3.0], xc="lsda", n_rad=40, **dev)
    eu, dmu6 = ksu.kernel()
    SC0 = torch.as_tensor(mol6.intor_ovlp() @ C6[:, 0], device=device)
    out["+U on site 0: occupation change + 1e-3"] = (
        float(SC0 @ dmu6 @ SC0 - SC0 @ d0 @ SC0) + 1e-3, None)
    out["+U on site 0: -E_U"] = (-ksu.E_U, None)
    out["+U on site 0: E(+U) - E"] = (e0 - eu, None)
    drv = K.RKSpU(mol6, C6, [[0, 1], [2]], [0.7, 0.3], xc=None, n_rad=20,
                  **dev)
    A6 = rng.randn(6, 6)
    dm6 = torch.as_tensor(A6 @ A6.T * 0.1 + 0.5 * np.eye(6), device=device)
    _, vU = drv._plus_u(dm6)
    fd = torch.zeros_like(dm6)
    for i in range(6):
        for j in range(6):
            dp, dn = dm6.clone(), dm6.clone()
            dp[i, j] += 1e-6
            dn[i, j] -= 1e-6
            fd[i, j] = (drv._plus_u(dp)[0] - drv._plus_u(dn)[0]) / 2e-6
    out["v_U - dE_U/dD central differences"] = (
        float((0.5 * (fd + fd.T) - vU).abs().max()), 1e-7)
    mol2 = Mole([("H", (0, 0, 0)), ("H", (0, 0, 3.2))], basis="sto-6g")
    w2, v2 = np.linalg.eigh(mol2.intor_ovlp())
    C2 = v2 @ np.diag(w2 ** -0.5) @ v2.T
    uks = K.UKSpU(mol2, C2, [[0], [1]], [2.0, 2.0], xc="lsda", n_rad=40,
                  nelec=(1, 1), **dev)
    dm0 = np.zeros((2, 2, 2))
    dm0[0, 0, 0] = dm0[1, 1, 1] = 1.0
    dmu2 = uks.kernel(dm0=dm0)[1]
    SC2 = torch.as_tensor(mol2.intor_ovlp() @ C2, device=device)
    m = [float(SC2[:, i] @ (dmu2[0] - dmu2[1]) @ SC2[:, i]) for i in (0, 1)]
    out["UKSpU stretched H2: 0.3 - m_0"] = (0.3 - m[0], None)
    out["UKSpU stretched H2: m_0 + m_1"] = (m[0] + m[1], 1e-6)
    # tests/test_md.py
    A_ = 1.0 / 0.52917720859
    h2o = MD.MoleGeneral([("O", (0, 0, 0)), ("H", (0, 0, A_)),
                          ("H", (0, A_, 0))], basis="sto-3g")
    out["H2O / STO-3G RHF - (-74.9611711378677)"] = (
        rhf(h2o, 10) + 74.9611711378677, 1e-8)
    a_exp = 0.8
    Av = np.array([0.1, -0.3, 0.2])
    shB = MD.Shell(np.array([1.0, 0.5, -0.4]), 0, [(0.5, 1.0)])
    shC = MD.Shell(np.array([-0.6, 0.8, 1.1]), 0, [(1.2, 1.0)])
    shD = MD.Shell(np.array([0.4, -0.9, 0.3]), 0, [(0.9, 1.0)])
    charges = [1.0, 2.0]
    coords = [np.array([0.5, 0.5, 0.5]), np.array([-1.0, 0.0, 0.0])]
    ops = {"S": lambda sh: MD.ovlp_block(sh, shB),
           "T": lambda sh: MD.kin_block(sh, shB),
           "V": lambda sh: MD.nuc_block(sh, shB, charges, coords),
           "ERI": lambda sh: MD.eri_block(sh, shB, shC, shD)}
    scale = MD.norm_cart(a_exp, (1, 0, 0)) / (MD.norm_cart(
        a_exp, (0, 0, 0)) * 2 * a_exp)
    err = 0.0
    for fn in ops.values():
        ana = np.asarray(fn(MD.Shell(Av, 1, [(a_exp, 1.0)])))
        for d in range(3):
            Ap, Am = Av.copy(), Av.copy()
            Ap[d] += 1e-5
            Am[d] -= 1e-5
            num = (np.asarray(fn(MD.Shell(Ap, 0, [(a_exp, 1.0)])))[0]
                   - np.asarray(fn(MD.Shell(Am, 0, [(a_exp, 1.0)])))[0]) \
                / 2e-5 * scale
            err = max(err, float(np.abs(ana[d] - num).max()))
    out["p shells - centre derivatives of s shells"] = (err, 5e-9)
    return out


def phase_dft_oracles(device, card):
    """13a: the DFT oracles on the card and on the CPU (each within its
    tolerance, card - CPU <= 1e-8)."""
    t0 = time.perf_counter()
    res_d = dft_oracles(device)
    t_d = time.perf_counter() - t0
    t0 = time.perf_counter()
    res_c = dft_oracles(torch.device("cpu"))
    t_c = time.perf_counter() - t0
    bad = []
    for k, (v, tol) in res_d.items():
        vc = res_c[k][0]
        ok = (v < 0.0) if tol is None else abs(v) <= tol
        print("13a %-50s card %.3e, CPU %.3e, |card - CPU| %.1e (%s)"
              % (k, v, vc, abs(v - vc),
                 "must be < 0" if tol is None else "tol %.0e" % tol))
        if not ok or (tol is not None and not abs(vc) <= tol) \
                or (tol is None and not vc < 0.0) \
                or not abs(v - vc) <= DFT_TOL["card vs CPU"]:
            bad.append(k)
    print("13a DFT oracles [%s]: %.1f s on the card, %.1f s on the CPU"
          % (card, t_d, t_c))
    if bad:
        raise AssertionError("13a failed: %s" % bad)


def _h1_asym(res):
    H1 = res["last"]["ImpHam"].H1["cd"][0]
    return float((H1 - H1.T).abs().max())


def dft_ring_run(Lat, meta, xc, device):
    """attach_ks(xc) and the DFT-in-DMET loop on `device` with its syrk
    launches counted from 0; returns a dict (ks, loop result, stage
    seconds, seconds, launches)."""
    from libdmet_preview_tpu_torch import workloads as wl
    from libdmet_preview_tpu_torch.models.abinitio import attach_ks
    from libdmet_preview_tpu_torch.ops import eri_kernels as ek
    from libdmet_preview_tpu_torch.solvers import FCI
    from libdmet_preview_tpu_torch.utils import timer
    _sync(device)
    t0 = time.perf_counter()
    with timer.recording() as sec_ks:
        ks = attach_ks(Lat, meta, xc=xc)
    _sync(device)
    t_ks = time.perf_counter() - t0
    solver = FCI(restricted=True, tol=1e-12, device=device)
    # the main path: counts start at 0 here
    _sync(device)
    ek.syrk_df.launches = 0
    ek.syrk_df.cross_launches = 0
    t0 = time.perf_counter()
    with _counted_plain_calls() as plain, timer.recording() as sec:
        res = wl.run_dft_dmet(Lat, meta, solver)
    _sync(device)
    return {"ks": ks, "res": res, "sec_ks": sec_ks, "sec": sec,
            "t_ks": t_ks, "t_loop": time.perf_counter() - t0,
            "launches": ek.syrk_df.launches,
            "cross": ek.syrk_df.cross_launches, "plain": plain["cuda"],
            "solver": solver}


def _print_dft_run(label, card, run):
    ks, res = run["ks"], run["res"]
    n_it = max(ks.cycles, 1)
    per = {k: sum(v) for k, v in run["sec_ks"].items()}
    print("%s [%s]: RKS %s, E %.12f, %d SCF iterations, converged %s, %.3f "
          "s (%.4f s per iteration in the stages: %s); DMET loop %.3f s, %d "
          "MuSolver steps, neo %d, E/cell %.12f, nelecImp %.12f; syrk_df "
          "launches %d (cross %d), plain-version calls on CUDA tensors %d"
          % (label, card, ks.xc, ks.e_tot, ks.cycles, ks.converged,
             run["t_ks"], sum(per.values()) / n_it,
             ", ".join("%s %.4f" % (k, v / n_it) for k, v in per.items()),
             run["t_loop"], res["steps"], res["neo"], res["E"],
             res["nelecImp"], run["launches"], run["cross"], run["plain"]))
    for k, v in run["sec"].items():
        print("%s [%s]: stage %-18s %.6f s (%d calls)"
              % (label, card, k, sum(v), len(v)))


def phase_dft_jax_ring(device, card):
    """13b / 13c at H22 against the JAX package's recorded values (the
    KS energy and grid electrons, the DFT-in-DMET loop).  Returns the tri
    kernel's launches."""
    from libdmet_preview_tpu_torch import workloads as wl
    natom = wl.DFT_NATOM_JAX
    mol = wl.dft_ring_mole(natom)
    Lat, meta = wl.dft_lattice(mol, device)
    bad, launches = [], 0
    for xc in wl.DFT_XC:
        run = dft_ring_run(Lat, meta, xc, device)
        label = "13b/c H%d %s" % (natom, xc)
        _print_dft_run(label, card, run)
        ref = wl.DFT_JAX[xc]
        ks, res = run["ks"], run["res"]
        launches += run["launches"]
        asym = _h1_asym(res)
        tol = max(DFT_TOL["DMET vs JAX"], asym)
        diffs = {"E_ks": (ks.e_tot - ref["E_ks"], DFT_TOL["E_ks vs JAX"]),
                 "n_grid": (wl.grid_electrons(ks) - ref["n_grid"],
                            DFT_TOL["n_grid vs JAX"]),
                 "E/cell": (res["E"] - ref["E"], tol),
                 "nelecImp": (res["nelecImp"] - ref["nelecImp"], tol),
                 "rhoImp": (float(np.abs(res["rhoImp"] - np.asarray(
                     ref["rhoImp"])).max()), tol)}
        for k, (d, t) in diffs.items():
            print("%s: %-8s - JAX package %.3e (tol %.0e)" % (label, k, d, t))
            if not abs(d) <= t:
                bad.append("%s %s" % (xc, k))
        print("%s: SCF iterations %d (JAX %d), MuSolver steps %d (JAX %d), "
              "grid electrons %.12f (N = %d), max |H1_emb - H1_emb^T| %.2e "
              "(the KS Fock stripes' translation asymmetry: the Becke grid "
              "does not turn with the ring; it floors the FCI residual)"
              % (label, ks.cycles, ref["ks_cycles"], res["steps"],
                 ref["steps"], wl.grid_electrons(ks), mol.nelectron, asym))
        if not (ks.converged and run["launches"] == 1 and run["cross"] == 0
                and run["plain"] == 0):
            bad.append("%s convergence / launches" % xc)
    if bad:
        raise AssertionError("13b/c H%d failed: %s" % (natom, bad))
    return launches


def _ks_iteration(ks):
    """One SCF iteration of a converged RKS at its density: J/K, XC, the
    Fock matrix and its commutator, one DIIS step (a host round trip), the
    orthogonalized eigh and the new density."""
    from libdmet_preview_tpu_torch.ops.diis import DIIS
    vj, vk, exc, vxc, eU, vU = ks._fock_parts(ks.dm)
    f = ks._h + vj + vxc + vU - 0.5 * ks.hyb * vk
    err = f @ ks.dm @ ks._S - ks._S @ ks.dm @ f
    f = ks._diis(DIIS(space=8), f, err)
    return ks._occupied_dm(ks._A, f, ks.mol.nelectron // 2)[2]


def phase_dft_full(device, card):
    """13b / 13c at full width (workloads.DFT_NATOM_FULL atoms): KS on the
    card with its iterations,
    seconds, peak memory and idle share; the CPU's Becke weights and one
    Fock rebuilt on the CPU from the card's density; RKS(None, hyb=1)
    against the RHF of the same integrals; the DFT-in-DMET loop with its
    launches, its last MuSolver step replayed on the CPU, the HF-limit
    identity, and the tri kernel timed at the loop's shape.  Returns
    (launches, max_abs_err, the kernel's record at that shape)."""
    from libdmet_preview_tpu_torch import workloads as wl
    from libdmet_preview_tpu_torch.ints import native
    from libdmet_preview_tpu_torch.ints.xc import eval_exc_vxc
    from libdmet_preview_tpu_torch.models.abinitio import attach_ks
    from libdmet_preview_tpu_torch.solvers import FCI
    from libdmet_preview_tpu_torch.solvers.ksdft import RKS
    import libdmet_preview_tpu_torch.dmet.hubbard as dmet
    cpu = torch.device("cpu")
    natom = wl.DFT_NATOM_FULL
    label = "13b/c H%d" % natom
    t0 = time.perf_counter()
    mol = wl.dft_ring_mole(natom)
    mol.intor_hcore()
    mol.intor_eri()
    t_ints = time.perf_counter() - t0
    lib = native.get_lib()
    print("%s: %d atoms, nao %d, %d electrons; host integrals %.2f s, the "
          "native ERI core %s (%s)" % (label, natom, mol.nao, mol.nelectron,
                                     t_ints, "ran" if lib else "MISSING",
                                     native._SO.name))
    if lib is None:
        raise AssertionError("13b: the native ERI core did not load")
    _sync(device)
    t0 = time.perf_counter()
    Lat, meta = wl.dft_lattice(mol, device)
    _sync(device)
    print("%s: make_h_ring_lattice (RHF, IAO + PAO, LO ERI, Cholesky "
          "naux %d) %.2f s" % (label, Lat.chol_L.shape[0],
                               time.perf_counter() - t0))
    bad, launches, runs = [], 0, {}
    torch.cuda.reset_peak_memory_stats()
    for xc in wl.DFT_XC:
        run = dft_ring_run(Lat, meta, xc, device)
        runs[xc] = run
        ks, res = run["ks"], run["res"]
        _print_dft_run("%s %s" % (label, xc), card, run)
        launches += run["launches"]
        if not (ks.converged and run["launches"] == 1 and run["cross"] == 0
                and run["plain"] == 0):
            bad.append("%s convergence / launches" % xc)
        # the last MuSolver step again on the CPU, from the card's state
        rep = wl.replay_dft_dmet_step(Lat, res, FCI(restricted=True,
                                                    tol=1e-12, device=cpu),
                                      cpu)
        idle = _idle_share(lambda: wl.replay_dft_dmet_step(
            Lat, res, run["solver"], device))
        print("%s %s [%s]: idle share of the last MuSolver step (its FCI "
              "solves and transformResults) replayed on the card: %s"
              % (label, xc, card, idle))
        tol = max(DFT_TOL["replay"], _h1_asym(res))
        for k, d in (("E/cell", rep[0] - res["E"]),
                     ("nelecImp", rep[1] - res["nelecImp"]),
                     ("rhoImp", float(np.abs(rep[2]
                                             - res["rhoImp"]).max()))):
            print("%s %s: last MuSolver step replayed on the CPU: %-8s "
                  "|card - CPU| %.3e (tol %.0e)" % (label, xc, k, abs(d),
                                                    tol))
            if not abs(d) <= tol:
                bad.append("%s replay %s" % (xc, k))
    print("%s: peak device memory %.3f GB over the KS and DMET runs"
          % (label, torch.cuda.max_memory_allocated() / 1e9))
    # seconds per XC evaluation (forward + autograd) and per iteration,
    # and the idle share of one SCF iteration
    for xc, run in runs.items():
        ks = run["ks"]
        ts = []
        for _ in range(3):
            _sync(device)
            t0 = time.perf_counter()
            eval_exc_vxc(ks.dm, ks.ao_g, ks.grid[1], restricted=True, xc=xc,
                         ao_grad=ks.ao_grad_g)
            _sync(device)
            ts.append(time.perf_counter() - t0)
        ti = []
        for _ in range(3):
            _sync(device)
            t0 = time.perf_counter()
            _ks_iteration(ks)
            _sync(device)
            ti.append(time.perf_counter() - t0)
        idle = _idle_share(lambda: _ks_iteration(ks))
        print("%s %s [%s]: %d grid points; XC evaluation (forward + "
              "autograd) %.4f s (min of 3), one SCF iteration %.4f s, idle "
              "share of one iteration %s" % (label, xc, card,
                                            ks.grid[0].shape[0], min(ts),
                                            min(ti), idle))
    # the CPU's grid, and one Fock rebuilt there from the card's densities
    t0 = time.perf_counter()
    ks_c = RKS(mol, xc="pbe", device=cpu)
    h_c = torch.as_tensor(mol.intor_hcore())
    ks_c._integrals()
    t_c = time.perf_counter() - t0
    w_d = runs["lsda"]["ks"].grid[1].cpu()
    dw = float((ks_c.grid[1] - w_d).abs().max() / w_d.abs().max())
    print("%s: CPU Becke grid, AO values and gradients, integrals %.2f s; "
          "Becke weights max |card - CPU| / max |w| %.3e (tol %.0e)"
          % (label, t_c, dw, DFT_TOL["Becke weights"]))
    if not dw <= DFT_TOL["Becke weights"]:
        bad.append("Becke weights")
    for xc, run in runs.items():
        ks = run["ks"]
        vj, _, exc, vxc, _, _ = ks._fock_parts(ks.dm)
        f_d = (ks._h + vj + vxc).cpu()
        ks_c.xc = xc
        t0 = time.perf_counter()
        vj, _, exc_c, vxc, _, _ = ks_c._fock_parts(ks.dm.cpu())
        f_c = h_c + vj + vxc
        d = float((f_c - f_d).abs().max() / f_d.abs().max())
        print("%s %s: one Fock (J, E_xc, autograd v_xc) rebuilt on the CPU "
              "from the card's density in %.2f s: max |card - CPU| / max "
              "|F| %.3e, E_xc card - CPU %.3e (tol %.0e)"
              % (label, xc, time.perf_counter() - t0, d, exc - exc_c,
                 DFT_TOL["Fock rebuild"]))
        if not (d <= DFT_TOL["Fock rebuild"]
                and abs(exc - exc_c) <= DFT_TOL["Fock rebuild"]
                * abs(exc)):
            bad.append("%s Fock rebuild" % xc)
    del ks_c
    # RKS(None, hyb=1) is the RHF of the same integrals
    t0 = time.perf_counter()
    hf = RKS(mol, xc=None, hyb=1.0, device=device)
    E_hf_ks = hf.kernel()[0]
    d = E_hf_ks - meta["E_hf"]
    print("%s: RKS(None, hyb=1) %.12f (%d iterations, %.2f s), RHF of the "
          "lattice builder %.12f: diff %.3e (tol %.0e)"
          % (label, E_hf_ks, hf.cycles, time.perf_counter() - t0,
             meta["E_hf"], d, DFT_TOL["RKS(None, hyb=1) - RHF"]))
    if not (hf.converged and abs(d) <= DFT_TOL["RKS(None, hyb=1) - RHF"]):
        bad.append("RKS(None, hyb=1) - RHF")
    del hf
    # the HF-limit identity of the double counting on the KS lattice
    vcor = dmet.VcorLocal(True, False, meta["nlo"])
    vcor.update(np.zeros(vcor.length()))
    rho, _ = dmet.RHartreeFock(Lat, vcor, mol.nelectron / (2.0 * mol.nao),
                               None)
    xc_dc = Lat.xc_dc
    Lat.xc_dc, Lat.xc_hyb = (lambda r: torch.zeros_like(r)), 1.0
    H_dc = dmet.ConstructImpHam(Lat, rho, vcor, matching=False,
                                int_bath=True)[0].H1["cd"]
    Lat.xc_dc = None
    H_std = dmet.ConstructImpHam(Lat, rho, vcor, matching=False,
                                 int_bath=True)[0].H1["cd"]
    Lat.xc_dc, Lat.xc_hyb = xc_dc, 0.0
    d = float((H_dc - H_std).abs().max())
    print("%s: HF-limit identity (xc_dc = 0, hyb = 1 against the standard "
          "interacting bath): max |dH1| %.3e (tol %.0e)"
          % (label, d, DFT_TOL["HF-limit identity"]))
    if not d <= DFT_TOL["HF-limit identity"]:
        bad.append("HF-limit identity")
    shape = (int(Lat.chol_L.shape[0]), runs["lsda"]["res"]["neo"])
    err, ms, plain_ms, bound, by = tri_kernel_at(shape, device, card)
    if bad:
        raise AssertionError("%s failed: %s" % (label, bad))
    return launches, err, {
        "shape": list(shape), "launches": launches, "ms": ms,
        "plain_ms": plain_ms, "library_ms": plain_ms, "bound_ms": bound,
        "bound_by": by}


def phase_dft(device, card):
    """Phase 13.  Returns the tri kernel's launches on the DFT-in-DMET
    path, and its max_abs_err and record at the full ring's path shape."""
    t0 = time.perf_counter()
    phase_dft_oracles(device, card)
    launches = phase_dft_jax_ring(device, card)
    n, err, at = phase_dft_full(device, card)
    at["launches"] = launches + n
    print("13 DFT phase [%s]: %.1f s" % (card, time.perf_counter() - t0))
    return launches + n, err, at

# ----------------------------------------------------------------------
# phase 14: the periodic Gaussian cell (ints.pbc, ints.gth, ints.basisopt)
# and the H-chain lattices built from it
# ----------------------------------------------------------------------

PBC_TOL = {"card vs CPU": 1e-10, "vs file": 1e-10, "eri_trans_full": 1e-10}
PBC_CRYSTAL = (3, 3, 3)        # 14c: the H2 crystal of eri_trans_full


def _h2_crystal(km, with_translations, device):
    from libdmet_preview_tpu_torch import workloads as wl
    from libdmet_preview_tpu_torch.ints.pbc import PbcCell
    atoms, a, t_vecs = wl.h2_crystal_geometry(km)
    cell = PbcCell(atoms, a, basis="tight", basis_data=wl.H2_CRYSTAL_BASIS,
                   precision=1e-10, device=device)
    if with_translations:
        cell.set_translations(int(np.prod(km)), t_vecs)
    return cell


def _full_from_dense(eri, N, m):
    """The dense supercell ERI reindexed into the 'full' format
    eri_F[R1, R2, R3, p, q, r, s] = (0p R1q | R2r R3s)."""
    return eri.reshape(N, m, N, m, N, m, N, m)[0].permute(
        1, 3, 5, 0, 2, 4, 6)


def pbc_oracles(device):
    """14a on `device`: the JAX suite's periodic-engine oracles at their
    own sizes.  Returns ({name: integral on the device} for the card-vs-CPU
    comparison, {oracle: (value, bound, ok)})."""
    from libdmet_preview_tpu_torch import workloads as wl
    from libdmet_preview_tpu_torch.ints import pbc
    from libdmet_preview_tpu_torch.ints.basisopt import (
        make_gth_dzvp_basis, make_gth_valence_basis)
    from libdmet_preview_tpu_torch.ints.gto import Mole
    from libdmet_preview_tpu_torch.models.integral import Integral
    from libdmet_preview_tpu_torch.solvers.scf import SCF
    ints, checks = {}, {}

    def check(name, value, bound, ok=None):
        checks[name] = (float(value), bound,
                        bool(value < bound) if ok is None else ok)

    def dmax(a, b):
        return float((a - b).abs().max())

    # the NaCl Madelung constant from the Ewald sum
    fcc = [(0, 0, 0), (0, 1, 1), (1, 0, 1), (1, 1, 0)]
    coords = [np.array(p, float) for p in fcc] \
        + [np.array(p, float) + np.array([1.0, 0, 0]) for p in fcc]
    nacl = pbc.PbcCell([("H", c) for c in coords], np.eye(3) * 2.0,
                       basis="sto-3g", unit="B", device=device)
    nacl.charges = np.asarray([1.0] * 4 + [-1.0] * 4)
    check("Madelung |M - 1.7475645946|",
          abs(-nacl.energy_nuc() / 4.0 - 1.7475645946), 1e-9)

    # PBC-HF molecular limit (3-21G H2 in a 15-bohr box)
    def hf(S, h, eri, enuc):
        Ham = Integral(S.shape[0], True, False, enuc, {"cd": h[None]},
                       {"ccdd": eri[None]}, ovlp=S)
        m = SCF(device=device)
        m.set_system(2, 0, False, True)
        m.set_integral(Ham)
        return m.HF(tol=1e-12, MaxIter=200)[0]

    atoms = [("H", (0, 0, 0)), ("H", (0, 0, 1.4))]
    mol = Mole(atoms, basis="3-21g")
    E_mol = hf(mol.intor_ovlp(), mol.intor_hcore(), mol.intor_eri(),
               mol.energy_nuc())
    box = pbc.PbcCell(atoms, np.eye(3) * 15.0, basis="3-21g", unit="B",
                      device=device)
    xi = pbc.PbcCell([("H", (0, 0, 0))], np.eye(3) * 15.0, basis="sto-3g",
                     unit="B", device=device).energy_nuc()
    for k in ("intor_ovlp", "intor_hcore", "intor_eri"):
        ints["H2 box " + k] = getattr(box, k)()
    E_pbc = hf(*[ints["H2 box " + k].cpu().numpy() for k in (
        "intor_ovlp", "intor_hcore", "intor_eri")], box.energy_nuc())
    check("molecular limit |E_pbc + 2 xi - E_mol|",
          abs(E_pbc + 2 * xi - E_mol), 5e-3)
    check("Ewald self energy |xi L + 1.41865|", abs(xi * 15.0 + 1.41865),
          1e-4)

    # GTH blocks against quadrature (host)
    err_loc, err_nl = wl.gth_quadrature_errors()
    check("GTH C1 / C2 terms vs quadrature", err_loc, 1e-9)
    check("GTH s/p/d projectors vs quadrature", err_nl, 1e-8)

    # stripe against dense: the 1D chain, the 2 x 2 plane, the 2 x 2 x 1
    # H2 crystal, and a GTH-PADE carbon cell
    cs = pbc.make_hchain_supercell(nk=2, basis="sto-6g", device=device)
    cd = pbc.make_hchain_supercell(nk=2, basis="sto-6g", device=device)
    cd.ncells_tr = None
    for k, bound in (("intor_ovlp", 1e-14), ("intor_kin", 1e-14),
                     ("intor_nuc", 1e-13), ("intor_eri", 1e-13)):
        a, b = getattr(cs, k)(), getattr(cd, k)()
        ints["chain stripe " + k], ints["chain dense " + k] = a, b
        check("1D chain stripe vs dense " + k, dmax(a, b), bound)
    ps = pbc.make_hplane_supercell(nkx=2, nky=2, Rx=2.0, Ry=2.4, vac=8.0,
                                   device=device)
    pd = pbc.PbcCell(ps.atoms, ps.a, basis="sto-3g", device=device)
    for k, bound in (("intor_ovlp", 1e-10), ("intor_hcore", 1e-8)):
        a, b = getattr(ps, k)(), getattr(pd, k)()
        ints["plane stripe " + k], ints["plane dense " + k] = a, b
        check("2x2 plane stripe vs dense " + k, dmax(a, b), bound)
    xs = _h2_crystal((2, 2, 1), True, device)
    xd = _h2_crystal((2, 2, 1), False, device)
    eriF, dense = xs.eri_trans_full(), xd.intor_eri()
    ints["crystal eri_trans_full"], ints["crystal dense eri"] = eriF, dense
    for k, bound in (("intor_ovlp", 1e-10), ("intor_hcore", 1e-8)):
        a, b = getattr(xs, k)(), getattr(xd, k)()
        ints["crystal stripe " + k] = a
        check("2x2x1 crystal stripe vs dense " + k, dmax(a, b), bound)
    check("2x2x1 eri_trans_full vs dense reindexed",
          dmax(eriF, _full_from_dense(dense, xs.ncells_tr, xs.nao_cell)),
          1e-9)
    L = 4.0
    for stripe in (True, False):
        c = pbc.PbcCell([("C", (0.0, 0.0, 0.15)),
                         ("C", (0.0, 0.0, L / 2 + 0.15))],
                        np.diag([8.0, 8.0, L]), basis="gth-szv",
                        pseudo="gth-pade", precision=1e-9, device=device)
        if stripe:
            c.set_translations(2, np.array([[0.0, 0.0, 0.0],
                                            [0.0, 0.0, L / 2]]))
        ints["GTH cell %s hcore" % ("stripe" if stripe else "dense")] = \
            c.intor_hcore()
    check("GTH-PADE C cell stripe vs dense hcore",
          dmax(ints["GTH cell stripe hcore"], ints["GTH cell dense hcore"]),
          1e-12)

    # intor_eri_rs converged on a sharp pair
    bd = {("H", "sharp"): [(0, [(5.4, 1.0)]), (0, [(0.2, 1.0)])]}
    kw = dict(basis="sharp", basis_data=bd, unit="B", precision=1e-8,
              device=device)
    at2 = [("H", (0, 0, 0)), ("H", (1.5, 0, 0))]
    sharp = pbc.PbcCell(at2, np.eye(3) * 12.0, **kw)
    e_rs, e_bare = sharp.intor_eri_rs(omega=1.0), sharp.intor_eri()
    e_hi = pbc.PbcCell(at2, np.eye(3) * 12.0, gmax=3 * sharp.gmax,
                       **kw).intor_eri()
    ints["sharp intor_eri_rs"], ints["sharp 3x gmax eri"] = e_rs, e_hi
    d_bare = dmax(e_rs, e_bare)
    check("sharp pair: bare mesh underconverged |rs - bare| > 1e-3", d_bare,
          1e-3, ok=d_bare > 1e-3)
    check("sharp pair: |rs - 3x gmax|", dmax(e_rs, e_hi), 1e-7)

    # the generated DZVP basis is variational against SZV (host)
    h2 = [("H", (0.0, 0.0, 0.0)), ("H", (0.0, 0.0, 1.4))]
    E_szv = wl.gth_rhf(h2, {("H", "tpu-szv"): make_gth_valence_basis("H")},
                       2)[0]
    E_dzvp, S = wl.gth_rhf(h2, {("H", "tpu-dzvp"): make_gth_dzvp_basis("H")},
                           2)
    smin = float(np.linalg.eigvalsh(S).min())
    check("DZVP H2: E_dzvp - E_szv < -0.010", E_dzvp - E_szv, -0.010)
    check("DZVP H2: E_dzvp < -1.105", E_dzvp, -1.105)
    check("DZVP H2: overlap eigenvalue > 1e-6", smin, 1e-6, ok=smin > 1e-6)
    return ints, checks


def phase_pbc_oracles(device, card):
    """14a: the oracles on the card and on the CPU; every integral card
    vs CPU within 1e-10 relative."""
    from libdmet_preview_tpu_torch.ints import native
    if native.get_sr_lib() is None:
        raise AssertionError("14a: the native short-range core did not "
                             "build (%s)" % native._SR_SO.name)
    print("14a native short-range core: %s" % native._SR_SO.name)
    cpu = torch.device("cpu")
    bad = []
    runs = {}
    for dev, label in ((device, card), (cpu, "cpu")):
        t0 = time.perf_counter()
        runs[label] = pbc_oracles(dev)
        _sync(dev)
        print("14a oracles [%s]: %.2f s" % (label, time.perf_counter() - t0))
        for name, (v, bound, ok) in runs[label][1].items():
            print("14a [%s] %-48s %.6e (bound %.0e) %s"
                  % (label, name, v, bound, "ok" if ok else "FAILED"))
            if not ok:
                bad.append("%s [%s]" % (name, label))
    tol = PBC_TOL["card vs CPU"]
    worst = 0.0
    for name, a in runs[card][0].items():
        b = runs["cpu"][0][name]
        rel = float((a.cpu() - b).abs().max() / b.abs().max())
        worst = max(worst, rel)
        if not rel <= tol:
            bad.append("card vs CPU " + name)
    print("14a card vs CPU: %d integrals, largest relative difference %.3e "
          "(tol %.0e)" % (len(runs[card][0]), worst, tol))
    if bad:
        raise AssertionError("14a failed: %s" % bad)


def _print_cell_stages(label, card, sec):
    for k, v in sec.items():
        print("%s [%s]: stage %-30s %.4f s (%d calls)"
              % (label, card, k, sum(v), len(v)))


def _cell_lattice(nk, device, card, label, jax_form=False):
    """make_hchain_supercell -> make_hchain_pbc_lattice on `device`, or
    with jax_form the one call make_hchain_pbc_lattice(nk=nk, nH=..., R=...,
    vac=..., basis=...) of the JAX package's form, which builds the same
    cell; the cell's integral stages timed.  Returns (Lat, meta, stage
    seconds, build seconds)."""
    from libdmet_preview_tpu_torch import workloads as wl
    from libdmet_preview_tpu_torch.models.abinitio import \
        make_hchain_pbc_lattice
    from libdmet_preview_tpu_torch.utils import timer
    _sync(device)
    t0 = time.perf_counter()
    with timer.recording() as sec:
        if jax_form:
            Lat, meta = make_hchain_pbc_lattice(nk=nk, device=device,
                                                **wl.HCHAIN_CELL)
            cell = meta["cell"]
        else:
            cell = wl.hchain_cell(nk, device)
            Lat, meta = wl.hchain_lattice(cell, device)
    _sync(device)
    wall = time.perf_counter() - t0
    ints = meta["ints"]
    print("%s [%s]: %s: nao %d, mesh %s (%d G), long-range mesh %d G, %.2f "
          "s (E_hf %.12f, Cholesky naux %d)"
          % (label, card, ("make_hchain_pbc_lattice(nk=%d, **HCHAIN_CELL) "
                           "(the JAX call form)" if jax_form else
                           "make_hchain_supercell(nk=%d) -> "
                           "make_hchain_pbc_lattice") % nk,
             ints.nao, cell.mesh, int(np.prod(cell.mesh)),
             cell.coulG_rs(1.0)[0].shape[0], wall, meta["E_hf"],
             Lat.chol_L.shape[0]))
    _print_cell_stages(label, card, sec)
    return Lat, meta, sec, wall


def _run_counted_loop(Lat, meta, device, card, label):
    """The IB FCI loop on the cell's lattice, the syrk launches counted
    from 0.  Returns (E, records, launches, wall)."""
    from libdmet_preview_tpu_torch import workloads as wl
    from libdmet_preview_tpu_torch.ops import eri_kernels as ek
    solver = wl.hchain_solver("FCI", device)
    _sync(device)
    ek.syrk_df.launches = 0
    ek.syrk_df.cross_launches = 0
    t0 = time.perf_counter()
    with _counted_plain_calls() as plain_calls:
        E, recs = wl.run_hchain_dmet(Lat, meta, solver, wl.IB_PROTOCOL)
    _sync(device)
    wall = time.perf_counter() - t0
    launches, cross = ek.syrk_df.launches, ek.syrk_df.cross_launches
    print("%s IB FCI loop [%s]: E/cell %.12f, %d iterations, %.4f s per "
          "iteration; syrk_df launches %d (cross %d) at (naux, neo) = "
          "(%d, %d), plain-version calls on CUDA tensors %d"
          % (label, card, E, len(recs), wall / len(recs), launches, cross,
             Lat.chol_L.shape[0], recs[-1]["neo"], plain_calls["cuda"]))
    if launches != len(recs) or cross != 0 or plain_calls["cuda"] != 0:
        raise AssertionError("%s: syrk launches %d for %d iterations "
                             "(cross %d, plain %d)" % (
                                 label, launches, len(recs), cross,
                                 plain_calls["cuda"]))
    return E, recs, launches, wall


def phase_pbc_hchain(device, card):
    """14b: the reference's H chain (nk = 3) built by the port's cell on
    the card, through the JAX call form make_hchain_pbc_lattice(nk=3,
    ...): its integrals against the JAX engine's file, the IB FCI loop
    at the anchor and the JAX loop's value, the UHF non-interacting bath
    from the cell.  Returns (tri launches, (naux, neo))."""
    from libdmet_preview_tpu_torch import workloads as wl
    from libdmet_preview_tpu_torch.models.engine_ints import load_engine_ints
    label = "14b H chain nk=3"
    bad = []
    # the main path: counts start at 0 in _run_counted_loop
    Lat, meta, _, _ = _cell_lattice(3, device, card, label, jax_form=True)
    E, recs, launches, _ = _run_counted_loop(Lat, meta, device, card, label)
    ints, ref = meta["ints"], load_engine_ints(wl.HCHAIN_FILE)
    for k in ("S", "hcore", "eri", "S12", "S2"):
        d = float(np.abs(getattr(ints, k) - getattr(ref, k)).max())
        print("%s: %-5s |port cell - JAX engine file| %.3e (tol %.0e)"
              % (label, k, d, PBC_TOL["vs file"]))
        if not d <= PBC_TOL["vs file"]:
            bad.append(k)
    d = abs(ints.e_nuc - ref.e_nuc)
    print("%s: e_nuc |port cell - JAX engine file| %.3e" % (label, d))
    if not d <= PBC_TOL["vs file"]:
        bad.append("e_nuc")
    anchor, tol = wl.HCHAIN_ANCHORS["IB FCI"]
    jax = wl.HCHAIN_JAX["IB FCI"]
    print("%s IB FCI: anchor %.12f (diff %.3e, tol %.0e), JAX loop %.12f "
          "(diff %.3e, tol %.0e)" % (label, anchor, E - anchor, tol, jax,
                                     E - jax, wl.IB_JAX_TOL))
    if not abs(E - anchor) < tol:
        bad.append("IB FCI anchor")
    if not abs(E - jax) <= wl.IB_JAX_TOL:
        bad.append("IB FCI JAX value")
    t0 = time.perf_counter()
    E_nib, afm, hf_err = wl.run_hchain_nib_uhf(meta["cell"], device)
    anchor, tol = wl.HCHAIN_ANCHORS["NIB UHF"]
    print("%s NIB UHF from the cell [%s]: E/cell %.12f, anchor %.12f (diff "
          "%.3e, tol %.0e), max |rho_a - rho_b| %.4f, HF energy error "
          "%.3e, %.2f s" % (label, card, E_nib, anchor, E_nib - anchor,
                            tol, afm, hf_err, time.perf_counter() - t0))
    if not (abs(E_nib - anchor) < tol and afm > 0.3 and hf_err < 1e-7):
        bad.append("NIB UHF")
    if bad:
        raise AssertionError("14b failed: %s" % bad)
    return launches, (Lat.chol_L.shape[0], recs[-1]["neo"])


def phase_pbc_full(device, card):
    """14c: the nk = 6 chain (nao 24, 485,875 long-range G vectors) on the
    card: integral stages, peak memory, the long-range stage's idle share
    and device events, the IB FCI loop with its launches, all held to the
    JAX engine's recorded values; the tri kernel at the loop's shape; and
    eri_trans_full on the 3 x 3 x 3 H2 crystal against the card's dense
    ERI reindexed.  Returns (launches, max_abs_err, the kernel's record
    at the loop's shape)."""
    from libdmet_preview_tpu_torch import workloads as wl
    from libdmet_preview_tpu_torch.ints import pbc
    nk = wl.HCHAIN_FULL_NK
    label = "14c H chain nk=%d" % nk
    bad = []
    torch.cuda.reset_peak_memory_stats()
    # the main path: counts start at 0 in _run_counted_loop
    Lat, meta, sec, wall = _cell_lattice(nk, device, card, label)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    E, recs, launches, loop_s = _run_counted_loop(Lat, meta, device, card,
                                                  label)
    print("%s [%s]: peak device memory of the lattice build %.2f GiB"
          % (label, card, peak))
    cell, ints = meta["cell"], meta["ints"]
    # the long-range ERI stage alone, profiled: pair FT on the coarse mesh
    # + the weighted Gram
    Gl, wl_ = cell.coulG_rs(1.0)
    w_t = torch.as_tensor(wl_, device=device)
    cell._ft_cache = None

    def lr_stage():
        f = cell._ft_aopair_impl(Gl)
        return pbc._wgram(f.reshape(f.shape[0], -1), w_t)

    lr_stage()
    with _Profiled() as prof:
        t0 = time.perf_counter()
        lr_stage()
        _sync(device)
        lr_s = time.perf_counter() - t0
    print("%s [%s]: long-range ERI stage (pair FT of %d G x %d x %d + "
          "Gram) %.4f s, %d device events, idle share %s"
          % (label, card, Gl.shape[0], cell.nao, cell.nao, lr_s,
             prof.n_device_events, prof.idle))
    ref = wl.PBC_JAX[nk]
    got = {"nao": ints.nao, "e_nuc": ints.e_nuc, "E_hf": meta["E_hf"],
           "S_fro": float(np.linalg.norm(ints.S)),
           "hcore_fro": float(np.linalg.norm(ints.hcore)),
           "eri_fro": float(np.linalg.norm(ints.eri.reshape(-1)))}
    for k, v in got.items():
        rel = abs(v - ref[k]) / abs(ref[k])
        print("%s: %-9s port %.15g, JAX engine %.15g, relative %.3e (tol "
              "%.0e)" % (label, k, v, ref[k], rel, wl.PBC_JAX_RTOL))
        if not rel <= wl.PBC_JAX_RTOL:
            bad.append(k)
    # the loop stops at dE < 1e-6 and its vcor fit's flat valley moves
    # the end point: held to the JAX loop at IB_JAX_TOL, as in 11a / 14b
    d = E - ref["E_ib_fci"]
    print("%s: E_ib_fci  port %.15g, JAX loop %.15g, diff %.3e (tol %.0e)"
          % (label, E, ref["E_ib_fci"], d, wl.IB_JAX_TOL))
    if not abs(d) <= wl.IB_JAX_TOL:
        bad.append("E_ib_fci")
    print("%s: %d iterations (JAX loop %d)" % (label, len(recs),
                                               ref["iterations"]))
    shape = (Lat.chol_L.shape[0], recs[-1]["neo"])
    err, ms, plain_ms, bound, by = tri_kernel_at(shape, device, card)

    # eri_trans_full on the 3 x 3 x 3 H2 crystal (27 cells)
    _sync(device)
    t0 = time.perf_counter()
    xs = _h2_crystal(PBC_CRYSTAL, True, device)
    eriF = xs.eri_trans_full()
    _sync(device)
    t_f = time.perf_counter() - t0
    t0 = time.perf_counter()
    xd = _h2_crystal(PBC_CRYSTAL, False, device)
    dense = xd.intor_eri()
    _sync(device)
    t_d = time.perf_counter() - t0
    d = float((eriF - _full_from_dense(dense, xs.ncells_tr,
                                       xs.nao_cell)).abs().max())
    print("14c H2 crystal %s (%d cells, nao %d, %d G) [%s]: eri_trans_full "
          "%.3f s, dense intor_eri %.3f s, |full - dense reindexed| %.3e "
          "(tol %.0e)" % ("x".join(map(str, PBC_CRYSTAL)), xs.ncells_tr,
                          xs.nao, int(np.prod(xs.mesh)), card, t_f, t_d, d,
                          PBC_TOL["eri_trans_full"]))
    if not d <= PBC_TOL["eri_trans_full"]:
        bad.append("eri_trans_full")
    if bad:
        raise AssertionError("14c failed: %s" % bad)
    return launches, err, {
        "shape": list(shape), "launches": launches, "ms": ms,
        "plain_ms": plain_ms, "library_ms": plain_ms, "bound_ms": bound,
        "bound_by": by}


def phase_pbc(device, card):
    """Phase 14.  Returns the tri kernel's launches on the cell-built
    H-chain paths, and its max_abs_err and record at the nk = 6 loop's
    shape."""
    t0 = time.perf_counter()
    phase_pbc_oracles(device, card)
    n3, shape3 = phase_pbc_hchain(device, card)
    n6, err, at = phase_pbc_full(device, card)
    at["launches_nk3"] = n3
    at["shape_nk3"] = list(shape3)
    print("14 periodic cell phase [%s]: %.1f s" % (card,
                                                   time.perf_counter() - t0))
    return n3 + n6, err, at


# ----------------------------------------------------------------------
# phase 15: the streamed embedding-ERI drivers and diamond
# ----------------------------------------------------------------------

DIAMOND_TOL = {"card vs CPU": 1e-12, "E_hf vs JAX": 1e-8,
               "mean field == SCF": 1e-7, "IB-HF identity": 1e-6,
               "one-shot vs JAX": 1e-6, "nelec": 0.05, "replay": 1e-12,
               "loop vs recorded": 1e-4}
# 15c: the reference's solid is 3 x 3 x 3; its build costs 352 s on the
# card's host (the host short-range rows, PERF.md section 5), beyond the
# phase's budget, so the phase keeps the width and cuts the depth
DIAMOND_MESH = (2, 2, 2)
DIAMOND_PRECISION = 1e-12     # 15c: tests/test_diamond333.py's precision


class DiamondRows(object):
    """The host short-range ERI rows of phase 15's two diamond cells
    (15b's nk = 2 chain at omega 1.0; 15c's DIAMOND_MESH at omega 1.0 and
    0.5), made by the cells' own native core in a background thread while
    the phases after 12b run: the rows are most of the diamond builds
    (PERF.md section 5).  The thread sets its nice value to 19 before it starts,
    and the core's worker threads inherit it, so the rows take only the
    host cores the earlier phases leave idle (at equal priority they
    slowed those phases by as much as they saved).  The thread uses no
    torch and no stage timer; phase 15 waits for it, builds its lattices
    from these cells (the rows kept on them, as a second call would find
    them) and prints the seconds each set took here."""

    def __init__(self, device, precision=DIAMOND_PRECISION):
        from libdmet_preview_tpu_torch.ints import native
        self.device, self.precision = device, precision
        self.nthreads = native.num_threads()
        self.cells, self.seconds, self.error = {}, {}, None
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        from libdmet_preview_tpu_torch.models.abinitio import diamond_cell
        # Linux: the nice value of this thread alone (threads it starts
        # inherit it)
        os.setpriority(os.PRIO_PROCESS, threading.get_native_id(), 19)
        try:
            for kmesh, omegas in (((1, 1, 2), (1.0,)),
                                  (DIAMOND_MESH, (1.0, 0.5))):
                cell = diamond_cell(kmesh, precision=self.precision,
                                    device=self.device)
                for om in omegas:
                    t0 = time.perf_counter()
                    rows = cell._sr_rows(om, self.precision, self.nthreads)
                    cell._cache[("sr_rows", om, self.precision)] = rows
                    self.seconds[(kmesh, om)] = time.perf_counter() - t0
                self.cells[tuple(kmesh)] = cell
        except Exception as e:      # re-raised by wait() in phase 15
            self.error = e

    def wait(self):
        t0 = time.perf_counter()
        self.thread.join()
        if self.error is not None:
            raise self.error
        for (kmesh, om), sec in self.seconds.items():
            print("15 SR rows of diamond %s at omega %.1f, made in the "
                  "background on %d threads at nice 19: %.2f s"
                  % ("x".join(map(str, kmesh)), om, self.nthreads, sec))
        print("15 waited %.2f s for them" % (time.perf_counter() - t0))

    @contextlib.contextmanager
    def cells_in_use(self):
        """models.abinitio.diamond_cell hands out these cells for their
        (kmesh, precision) at the default geometry."""
        from libdmet_preview_tpu_torch.models import abinitio
        make = abinitio.diamond_cell

        def prewarmed(kmesh, a_ang=3.567, basis="gth-szv",
                      pseudo="gth-pade", gmax=None, precision=1e-12,
                      device=self.device):
            cell = self.cells.get(tuple(kmesh))
            if (cell is not None and (a_ang, basis, pseudo, gmax, precision)
                    == (3.567, "gth-szv", "gth-pade", None, self.precision)
                    and torch.device(device) == torch.device(self.device)):
                return cell
            return make(kmesh, a_ang, basis, pseudo, gmax, precision, device)

        abinitio.diamond_cell = prewarmed
        try:
            yield
        finally:
            abinitio.diamond_cell = make


def phase_diamond_oracles(device, card):
    """15a: tests/test_pbc_3d.py's driver oracles on the card and on the
    CPU (workloads.emb_driver_oracles); every driver output card vs CPU
    within 1e-12 relative."""
    from libdmet_preview_tpu_torch import workloads as wl
    cpu = torch.device("cpu")
    bad, runs = [], {}
    for dev, label in ((device, card), (cpu, "cpu")):
        t0 = time.perf_counter()
        runs[label] = wl.emb_driver_oracles(dev)
        _sync(dev)
        print("15a driver oracles [%s]: %.2f s" % (label,
                                                  time.perf_counter() - t0))
        for name, (v, bound, ok) in runs[label][1].items():
            print("15a [%s] %-40s %.6e (bound %.0e) %s"
                  % (label, name, v, bound, "ok" if ok else "FAILED"))
            if not ok:
                bad.append("%s [%s]" % (name, label))
    worst = 0.0
    for name, a in runs[card][0].items():
        b = runs["cpu"][0][name]
        rel = float((a.cpu() - b).abs().max() / b.abs().max())
        print("15a card vs CPU %-10s relative %.3e" % (name, rel))
        worst = max(worst, rel)
        if not rel <= DIAMOND_TOL["card vs CPU"]:
            bad.append("card vs CPU " + name)
    print("15a card vs CPU: largest relative difference %.3e (tol %.0e)"
          % (worst, DIAMOND_TOL["card vs CPU"]))
    if bad:
        raise AssertionError("15a failed: %s" % bad)


def _diamond_build(kind, device, card, label, **kw):
    """workloads.diamond_lattice on `device` with its stages timed.
    Returns (Lat, meta, stage seconds, wall seconds)."""
    from libdmet_preview_tpu_torch import workloads as wl
    from libdmet_preview_tpu_torch.ints import native
    from libdmet_preview_tpu_torch.utils import timer
    _sync(device)
    t0 = time.perf_counter()
    with timer.recording() as sec:
        Lat, meta = wl.diamond_lattice(kind, device, **kw)
    _sync(device)
    wall = time.perf_counter() - t0
    cell = meta["cell"]
    print("%s [%s]: %d cells, nao %d, mesh %s, precision %.0e, %d host "
          "threads: build %.2f s, E_hf/cell %.10f"
          % (label, card, cell.ncells_tr, cell.nao, cell.mesh,
             cell.precision, native.num_threads(), wall,
             meta["E_hf"] / cell.ncells_tr))
    _print_cell_stages(label, card, sec)
    return Lat, meta, sec, wall


def _diamond_checks(label, res, ref, bad):
    """The identities of one one-shot and, where ref has them, its values
    against ref: {key: (value, tol)}."""
    checks = {"mean field == SCF": (res["E_mf"] - res["E_hf"],
                                    DIAMOND_TOL["mean field == SCF"]),
              "IB-HF identity": (res["E_ibhf"] - res["E_hf"],
                                 DIAMOND_TOL["IB-HF identity"]),
              "one-shot nelec - 1": (res["n_cc"] - 1.0, DIAMOND_TOL["nelec"])}
    checks.update(ref)
    _hold_checks(label, checks, bad)


def _hold_checks(label, checks, bad):
    """checks: {name: (value, bound)}, held as |value| < bound; each
    printed, each miss appended to bad."""
    for k, (v, tol) in checks.items():
        ok = abs(v) < tol
        print("%s: %-34s %.3e (tol %.0e) %s" % (label, k, v, tol,
                                                 "ok" if ok else "FAILED"))
        if not ok:
            bad.append("%s: %s" % (label, k))


def phase_diamond_chain(device, card, nk=2):
    """15b: make_diamond_lattice(nk=2) at the JAX package's defaults on the
    card: the one-shot (RHartreeFock -> ConstructImpHam -> IB-HF -> CCSD)
    held to workloads.DIAMOND_JAX["chain_nk2"], exactly one tri launch per
    ConstructImpHam, no cross launch, no plain-version call on the card.
    Returns (tri launches, max_abs_err, the kernel's record at the path's
    shape)."""
    from libdmet_preview_tpu_torch import workloads as wl
    from libdmet_preview_tpu_torch.ops import eri_kernels as ek
    label = "15b diamond nk=%d" % nk
    bad = []
    Lat, meta, _, _ = _diamond_build("chain", device, card, label, nk=nk)
    # the main path: counts from 0 around the one-shot
    _sync(device)
    ek.syrk_df.launches = 0
    ek.syrk_df.cross_launches = 0
    t0 = time.perf_counter()
    with _counted_plain_calls() as plain_calls:
        res = wl.diamond_one_shot(Lat, meta, device)
    _sync(device)
    launches, cross = ek.syrk_df.launches, ek.syrk_df.cross_launches
    shape = (int(Lat.chol_L.shape[0]), int(res["basis"].shape[-1]))
    print("%s one-shot [%s]: %.2f s, E_hf %.10f, E_mf %.10f, E_ibhf %.10f, "
          "E_cc %.10f, n %.6f; syrk_df launches %d (cross %d) at (naux, neo)"
          " = %s, plain-version calls on CUDA tensors %d"
          % (label, card, time.perf_counter() - t0, res["E_hf"], res["E_mf"],
             res["E_ibhf"], res["E_cc"], res["n_cc"], launches, cross,
             shape, plain_calls["cuda"]))
    ref = wl.DIAMOND_JAX["chain_nk2"]
    _diamond_checks(label, res, {
        "E_hf - JAX": (res["E_hf"] - ref["E_hf"], DIAMOND_TOL["E_hf vs JAX"]),
        "E_cc - JAX": (res["E_cc"] - ref["E_cc"],
                       DIAMOND_TOL["one-shot vs JAX"])}, bad)
    if launches != 1 or cross != 0 or plain_calls["cuda"] != 0:
        bad.append("launches %d cross %d plain %d" % (
            launches, cross, plain_calls["cuda"]))
    err, ms, plain_ms, bound, by = tri_kernel_at(shape, device, card)
    if bad:
        raise AssertionError("15b failed: %s" % bad)
    return launches, err, {
        "shape": list(shape), "launches": launches, "ms": ms,
        "plain_ms": plain_ms, "library_ms": plain_ms, "bound_ms": bound,
        "bound_by": by}


def _per_iteration(label, card, sec, n_it):
    for k in ("mean field", "bath", "H2", "H1", "impurity solve", "energy",
              "vcor fit"):
        if k in sec:
            print("%s [%s]: per iteration %-15s %.4f s" % (
                label, card, k, sum(sec[k]) / n_it))


def phase_diamond_mesh(device, card, kmesh=DIAMOND_MESH,
                       precision=DIAMOND_PRECISION):
    """15c: make_diamond_lattice3(kmesh, precision) on the card through
    tests/test_diamond333.py's protocol (workloads.run_diamond_dmet): E_hf,
    the one-shot and the converged loop at the JAX package's anchors
    (workloads.DIAMOND333_ANCHORS, when `anchors`), the identities, no
    syrk launch, the device half of one get_emb_eri_rs replayed on the CPU
    from the same SR rows and G column; stage seconds, seconds per
    iteration, peak memory and the idle share of one iteration."""
    from libdmet_preview_tpu_torch import workloads as wl
    from libdmet_preview_tpu_torch.ops import eri_kernels as ek
    from libdmet_preview_tpu_torch.utils import timer
    label = "15c diamond %s" % "x".join(map(str, kmesh))
    # held: the identities, and at precision 1e-12 the values this phase
    # recorded on the card (workloads.DIAMOND_RECORDED); at 3 x 3 x 3 the
    # loop also at its JAX anchor (5e-4, the test's own), the E_hf and
    # one-shot anchors printed (they predate the JAX package's switch of
    # its builders to the range-separated ERIs: PERF.md section 6)
    full = precision == 1e-12
    rec = wl.DIAMOND_RECORDED.get(tuple(kmesh)) if full else None
    anchors = full and tuple(kmesh) == (3, 3, 3)
    bad = []
    torch.cuda.reset_peak_memory_stats()
    Lat, meta, sec, wall = _diamond_build("mesh", device, card, label,
                                          kmesh=kmesh, precision=precision)
    if "SR ERI rows (host)" in sec:
        print("%s [%s]: SR rows at omega 1.0, 0.5: %s s" % (
            label, card, ", ".join("%.2f" % x
                                   for x in sec["SR ERI rows (host)"])))
    A = wl.DIAMOND333_ANCHORS
    t0 = time.perf_counter()
    res = wl.diamond_one_shot(Lat, meta, device)
    print("%s one-shot [%s]: %.2f s, E_hf %.10f, E_mf %.10f, E_ibhf %.10f, "
          "E_cc %.10f, n %.6f, neo %d" % (
              label, card, time.perf_counter() - t0, res["E_hf"],
              res["E_mf"], res["E_ibhf"], res["E_cc"], res["n_cc"],
              res["basis"].shape[-1]))
    if anchors:
        print("%s: E_hf - JAX anchor %.3e, one-shot E_cc - JAX anchor %.3e "
              "(the anchors predate the range-separated ERIs)" % (
                  label, res["E_hf"] - A["E_hf"][0],
                  res["E_cc"] - A["one-shot"][0]))
    ref = {}
    if rec is not None:
        ref = {"E_hf - recorded": (res["E_hf"] - rec["E_hf"],
                                   DIAMOND_TOL["E_hf vs JAX"]),
               "E_cc - recorded": (res["E_cc"] - rec["E_cc"],
                                   DIAMOND_TOL["one-shot vs JAX"])}
    _diamond_checks(label, res, ref, bad)
    # the loop: no hand-written kernel on this path
    _sync(device)
    ek.syrk_df.launches = 0
    ek.syrk_df.cross_launches = 0
    t0 = time.perf_counter()
    with timer.recording() as sec_loop:
        E, n, conv, recs = wl.run_diamond_dmet(Lat, device)
    _sync(device)
    loop_s = time.perf_counter() - t0
    launches = ek.syrk_df.launches + ek.syrk_df.cross_launches
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print("%s loop [%s]: E/cell %.10f, n %.6f, converged %s, %d iterations "
          "(%s), %.2f s (%.3f s per iteration), syrk_df launches %d, peak "
          "device memory %.2f GiB" % (
              label, card, E, n, conv, len(recs),
              ", ".join("%.8f" % r["E"] for r in recs), loop_s,
              loop_s / len(recs), launches, peak))
    _per_iteration(label, card, sec_loop, len(recs))
    if not conv:
        bad.append("loop not converged")
    if anchors:
        print("%s: loop - JAX anchor %.3e (tol %.0e)" % (
            label, E - A["loop"][0], A["loop"][1]))
        if not abs(E - A["loop"][0]) < A["loop"][1]:
            bad.append("loop anchor (%.3e)" % (E - A["loop"][0]))
    if rec is not None:
        # the loop stops at dE < 1e-5: its end moves by ~3e-6 between runs
        print("%s: loop - recorded %.3e (tol %.0e)" % (
            label, E - rec["loop"], DIAMOND_TOL["loop vs recorded"]))
        if not abs(E - rec["loop"]) < DIAMOND_TOL["loop vs recorded"]:
            bad.append("loop vs recorded")
    if not abs(n - 1.0) < DIAMOND_TOL["nelec"]:
        bad.append("nelec")
    if launches != 0:
        bad.append("syrk launches %d" % launches)
    with _Profiled() as prof:
        wl.run_diamond_dmet(Lat, device, max_iter=1)
    print("%s [%s]: idle share of one iteration %s (%d device events)"
          % (label, card, prof.idle, prof.n_device_events))
    # the device half of one get_emb_eri_rs replayed on the CPU
    cell = meta["cell"]
    C = meta["C_ao_lo"][:, :meta["nlo"]]
    _sync(device)
    t0 = time.perf_counter()
    a = cell.get_emb_eri_rs(C)
    _sync(device)
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    b = wl.cell_on(cell, torch.device("cpu")).get_emb_eri_rs(C.cpu())
    t_cpu = time.perf_counter() - t0
    rel = float((a.cpu() - b).abs().max() / b.abs().max())
    print("%s: get_emb_eri_rs from the kept SR rows and G column: card "
          "%.3f s, CPU %.3f s, relative difference %.3e (tol %.0e)"
          % (label, t_card, t_cpu, rel, DIAMOND_TOL["replay"]))
    if not rel <= DIAMOND_TOL["replay"]:
        bad.append("replay")
    if bad:
        raise AssertionError("15c failed: %s" % bad)
    return {"iterations": len(recs), "E": E, "peak_GiB": peak,
            "idle": prof.idle, "build_s": wall, "loop_s": loop_s}


def phase_diamond(device, card, rows=None):
    """Phase 15.  rows: a DiamondRows started earlier (its cells are used),
    or None.  Returns the tri kernel's launches on the diamond paths, and
    its max_abs_err and record at 15b's shape."""
    t0 = time.perf_counter()
    phase_diamond_oracles(device, card)
    ctx = contextlib.nullcontext()
    if rows is not None:
        rows.wait()
        ctx = rows.cells_in_use()
    with ctx:
        launches, err, at = phase_diamond_chain(device, card)
        phase_diamond_mesh(device, card)
    print("15 diamond phase [%s]: %.1f s" % (card, time.perf_counter() - t0))
    return launches, err, at


# ----------------------------------------------------------------------
# phase 16: the AFM oxides (NiO AFM / FM, the CuO2 plane) at the JAX
# suite's nk = 2, precision 1e-10 (tests/test_nio_afm.py,
# tests/test_cuo2_afm.py), and the HDF5 outcore embedding ERI
# ----------------------------------------------------------------------

OXIDE = {"nk": 2, "precision": 1e-10}
OXIDE_TOL = {"E_hf vs anchor": 5e-6, "card vs CPU": 1e-8,
             "nio mean field == UHF": 2e-4, "nio IB identity": 5e-4,
             "nio AFM sum": 1e-4, "nio FM equal": 1e-3,
             "cuo2 mean field == UHF": 5e-5, "cuo2 IB identity": 1e-5,
             "cuo2 AFM sum": 1e-3, "outcore": 1e-14}
# the factories' integral cache (NiO FM reads NiO AFM's file): 104 MB per
# file at nk = 2, in a directory of its own under the git-ignored build/,
# made at the start of the phase and removed at its end, passed or not
OXIDE_CACHE_DIR = "build"


def _oxide_build(kind, device, card, label, cache, **kw):
    """workloads.oxide_lattice with its integral cache in `cache` and its
    stages timed.  Returns (Lat, meta, wall seconds)."""
    from libdmet_preview_tpu_torch import workloads as wl
    from libdmet_preview_tpu_torch.ints import native
    from libdmet_preview_tpu_torch.utils import timer
    _sync(device)
    t0 = time.perf_counter()
    with timer.recording() as sec:
        Lat, meta = wl.oxide_lattice(kind, device, cache_file=cache,
                                     **kw)
    _sync(device)
    wall = time.perf_counter() - t0
    cell = meta["cell"]
    print("%s [%s]: nk %d, nao %d (%d per cell), nelec %d, precision %.0e, "
          "%d host threads: build %.2f s, E_hf/cell %.10f, d moments %s"
          % (label, card, cell.ncells_tr, cell.nao, meta["nlo"],
             cell.nelectron, cell.precision, native.num_threads(), wall,
             meta["E_hf"] / cell.ncells_tr, np.round(meta["mag_d"], 6)))
    _print_cell_stages(label, card, sec)
    return Lat, meta, wall


def _oxide_one_shot(Lat, meta, kind, device, card, label, mp2=None):
    """workloads.oxide_one_shot with the syrk counts set to 0 just before
    and read just after, plain-version calls on CUDA tensors counted, and
    the stages timed.  Returns (result, (tri, cross) launches, (naux,
    neo), stage seconds)."""
    from libdmet_preview_tpu_torch import workloads as wl
    from libdmet_preview_tpu_torch.ops import eri_kernels as ek
    from libdmet_preview_tpu_torch.utils import timer
    _sync(device)
    ek.syrk_df.launches = 0
    ek.syrk_df.cross_launches = 0
    t0 = time.perf_counter()
    with _counted_plain_calls() as plain, timer.recording() as sec:
        res = wl.oxide_one_shot(Lat, meta, kind, device, mp2=mp2)
    _sync(device)
    launches = (ek.syrk_df.launches, ek.syrk_df.cross_launches)
    shape = (int(Lat.chol_L.shape[0]), res["neo"])
    print("%s one-shot [%s]: %.2f s, E_hf %.10f, E_mf %.10f, E_ibhf %.10f%s,"
          " nelec_emb %d, S_z %d; syrk_df launches %d tri + %d cross at "
          "(naux, neo) = %s, plain-version calls on CUDA tensors %d"
          % (label, card, time.perf_counter() - t0, res["E_hf"], res["E_mf"],
             res["E_ibhf"], (", E_mp2 %.10f" % res["E_mp2"]
                             if "E_mp2" in res else ""),
             res["nelec_emb"], res["sz_emb"], launches[0], launches[1],
             shape, plain["cuda"]))
    for k in ("bath", "ERI rotation", "ERI pack", "syrk (tri kernel)",
              "syrk ab (cross kernel)", "ERI unpack", "H2", "H1",
              "mean field", "impurity UHF", "CC reference SCF", "MP2"):
        if k in sec:
            print("%s [%s]: stage %-24s %.4f s (%d calls)"
                  % (label, card, k, sum(sec[k]), len(sec[k])))
    if launches != (2, 1) or plain["cuda"]:
        raise AssertionError("%s: launches %s, plain calls %d (want 2 tri "
                             "+ 1 cross, none)" % (label, launches,
                                                   plain["cuda"]))
    return res, launches, shape, sec


def _oxide_against_records(label, kind, res, bad):
    """At nk = 2, precision 1e-10: E_hf per cell against the JAX suite's
    anchor where it was taken on the range-separated ERI (5e-6); E_hf and
    the moments against the JAX package's on the port's integrals
    (workloads.OXIDE_JAX_NK2), and |m| above the floor set from them; the
    card's values against the ones it recorded (workloads.
    OXIDE_RECORDED)."""
    from libdmet_preview_tpu_torch import workloads as wl
    anchor = wl.OXIDE_ANCHORS.get(kind)
    if anchor is not None:
        d = res["E_hf"] - anchor["E_hf"]
        print("%s: E_hf - the JAX suite's anchor %.10f: %.6e; |moment| %.6f "
              "against its %.3f%s" % (
                  label, anchor["E_hf"], d, abs(res["mag"][0]),
                  anchor["mag"], " (the anchor predates the range-separated "
                  "ERI: held to OXIDE_JAX_NK2 and OXIDE_RECORDED instead)"
                  if anchor["bare_g_mesh_eri"] else ""))
        if not anchor["bare_g_mesh_eri"]:
            _hold_checks(label, {"E_hf - anchor": (
                d, OXIDE_TOL["E_hf vs anchor"])}, bad)
    wit = wl.OXIDE_JAX_NK2.get(kind)
    if wit is not None:
        _hold_checks(label, {"%s - JAX package" % k: (float(np.max(np.abs(
            np.asarray(res[k]) - np.asarray(wit[k])))), tol)
            for k, tol in wl.OXIDE_JAX_NK2_TOL.items()}, bad)
        floor = wl.OXIDE_MAG_FLOOR[kind]
        m = min(abs(x) for x in res["mag"])
        print("%s: min |moment| %.6f, floor %.2f (the JAX package's %.6f on "
              "these integrals) %s" % (label, m, floor, min(
                  abs(x) for x in wit["mag"]), "ok" if m > floor
                  else "FAILED"))
        if not m > floor:
            bad.append("%s: |moment| %.6f below %.2f" % (label, m, floor))
    rec = wl.OXIDE_RECORDED.get(kind)
    print("%s values: E_hf %.12f, moments %s, E_ibhf %.12f%s"
          % (label, res["E_hf"], [round(m, 8) for m in res["mag"]],
             res["E_ibhf"], (", E_mp2 %.12f" % res["E_mp2"])
             if "E_mp2" in res else ""))
    if rec is None:
        bad.append("%s: no values recorded for %s" % (label, kind))
        return
    checks = {}
    for k, tol in wl.OXIDE_RECORDED_TOL.items():
        if k in rec:
            v = np.max(np.abs(np.asarray(res[k]) - np.asarray(rec[k])))
            checks["%s - recorded" % k] = (float(v), tol)
    _hold_checks(label, checks, bad)


def _oxide_cpu_replay(Lat, meta, kind, res, label, card, bad):
    """The embedding step on the CPU: the same lattice's operators and
    factors moved to a CPU lattice (ChainLattice.set_Ham_abinitio on
    device=cpu), then the mean field and ConstructImpHam there (not the
    build; not the impurity UHF, whose card-vs-CPU check is phase 6's at
    neo = 60); gauge-invariant quantities against the card's (1e-8)."""
    from libdmet_preview_tpu_torch import workloads as wl
    from libdmet_preview_tpu_torch.models.lattice import ChainLattice
    cpu = torch.device("cpu")
    nlo = meta["nlo"]
    Lat_c = ChainLattice(Lat.nsites, nlo)
    Lat_c.set_Ham_abinitio(Lat.Ham, rdm1=Lat.rdm1_lo_R, device=cpu)
    Lat_c.set_val_virt_core(nlo, 0, 0)
    t0 = time.perf_counter()
    rc = wl.oxide_one_shot(Lat_c, meta, kind, cpu, mp2=False, solve=False)
    print("%s CPU replay of the embedding step: %.2f s"
          % (label, time.perf_counter() - t0))

    def spectrum(M):
        M = torch.as_tensor(M).detach().cpu()
        return torch.linalg.eigvalsh(0.5 * (M + M.transpose(-1, -2)))

    H1d, H1c = res["ImpHam"].H1["cd"], rc["ImpHam"].H1["cd"]
    checks = {"card - CPU E_mf": (res["E_mf"] - rc["E_mf"],
                                  OXIDE_TOL["card vs CPU"]),
              "card - CPU H1_emb spectrum": (
                  float((spectrum(H1d) - spectrum(H1c)).abs().max()),
                  OXIDE_TOL["card vs CPU"]),
              "card - CPU rho_mf spectrum": (
                  float((spectrum(res["rho_mf"])
                         - spectrum(rc["rho_mf"])).abs().max()),
                  OXIDE_TOL["card vs CPU"])}
    for k in ("nelec_emb", "sz_emb", "neo"):
        if res[k] != rc[k]:
            bad.append("%s: card %s %d, CPU %d" % (label, k, res[k], rc[k]))
    _hold_checks(label, checks, bad)


def phase_oxides(device, card, nk=OXIDE["nk"], precision=OXIDE["precision"]):
    """16: the AFM oxides at the JAX suite's nk = 2, precision 1e-10.
    16a NiO AFM (tests/test_nio_afm.py:35-88), 16b NiO FM on 16a's cached
    integrals (:91-149), 16c the CuO2 plane (tests/test_cuo2_afm.py:27-72),
    each one-shot with exactly 2 tri + 1 cross launches and no plain
    version on the card, 16c's embedding step replayed on the CPU; 16d the
    HDF5 outcore ERI of 16a's embedding against the in-core one.  Both
    kernels timed at the oxide path's shape.  Returns (tri launches by
    path, cross launches by path, max_abs_err, the kernels' records at
    the path's shape)."""
    os.makedirs(OXIDE_CACHE_DIR, exist_ok=True)
    cache = tempfile.mkdtemp(prefix="oxide_cache_", dir=OXIDE_CACHE_DIR)
    try:
        return _phase_oxides(device, card, nk, precision, cache)
    finally:
        shutil.rmtree(cache, ignore_errors=True)


def _phase_oxides(device, card, nk, precision, cache):
    from libdmet_preview_tpu_torch.ops.eri_transform import get_emb_eri_chol
    kw = {"nk": nk, "precision": precision, "cache": cache}
    full = (nk, precision) == (OXIDE["nk"], OXIDE["precision"])
    bad, tri, cross, shapes = [], {}, {}, {}
    torch.cuda.reset_peak_memory_stats(device)

    # 16a NiO AFM
    label = "16a NiO AFM"
    Lat, meta, _ = _oxide_build("nio_afm", device, card, label, **kw)
    res, (tri["nio_afm"], cross["nio_afm"]), shapes["nio_afm"], _ = \
        _oxide_one_shot(Lat, meta, "nio_afm", device, card, label)
    mag = res["mag"]
    E_corr = res["E_mp2"] - res["E_ibhf"]
    checks = {"mean field - UHF": (res["E_mf"] - res["E_hf"],
                                   OXIDE_TOL["nio mean field == UHF"]),
              "IB-HF - UHF": (res["E_ibhf"] - res["E_hf"],
                              OXIDE_TOL["nio IB identity"]),
              "m_Ni0 + m_Ni1": (mag[0] + mag[1], OXIDE_TOL["nio AFM sum"])}
    _hold_checks(label, checks, bad)
    if full:
        _oxide_against_records(label, "nio_afm", res, bad)
    print("%s: MP2 E_corr/cell %.6f (bound (-3, -0.02)), moments %s"
          % (label, E_corr, np.round(mag, 6)))
    if full and not -3 < E_corr < -0.02:
        bad.append("%s: E_corr %.4f" % (label, E_corr))
    import libdmet_preview_tpu_torch.dmet.hubbard as dmet
    idle = _idle_share(lambda: dmet.ConstructImpHam(
        Lat, res["rho"], res["vcor"], matching=True, int_bath=True))
    print("%s [%s]: idle share of one ConstructImpHam %s"
          % (label, card, "n/a" if idle is None else "%.3f" % idle))

    # 16d: the outcore ERI of 16a's embedding (needs h5py on this host)
    try:
        import h5py  # noqa: F401
    except ImportError:
        print("16d outcore ERI [%s]: h5py is not installed on this host, so "
              "get_emb_eri_chol(outcore=) cannot run here (the CPU tests "
              "hold it against the in-core ERI)" % card)
    else:
        path = os.path.join(cache, "oxide_eri_outcore.h5")
        t0 = time.perf_counter()
        dset = get_emb_eri_chol(Lat.chol_L, res["basis"], outcore=path)
        try:
            incore = res["ImpHam"].H2["ccdd"]
            diff = float(np.abs(dset[()] - incore.cpu().numpy()).max())
            print("16d outcore ERI [%s]: dataset %s %s written and read in "
                  "%.2f s, max |outcore - in-core| %.3e"
                  % (card, dset.name, dset.shape, time.perf_counter() - t0,
                     diff))
            _hold_checks("16d outcore", {"outcore - in-core": (
                diff, OXIDE_TOL["outcore"])}, bad)
        finally:
            dset.file.close()
            os.remove(path)
    del Lat, meta, res

    # 16b NiO FM on 16a's cached integrals
    label = "16b NiO FM"
    Lat, meta, _ = _oxide_build("nio_fm", device, card, label, **kw)
    res, (tri["nio_fm"], cross["nio_fm"]), _, _ = _oxide_one_shot(
        Lat, meta, "nio_fm", device, card, label, mp2=False)
    na, nb = meta["nelec_ab"]
    mag = res["mag"]
    rdm1 = meta["rdm1_lo"]
    sz2 = float(torch.trace(rdm1[0] - rdm1[1]))
    checks = {"n_a - n_b - 4 nk": (na - nb - 4 * nk, 0.5),
              "tr(rho_a - rho_b) - (n_a - n_b)": (sz2 - (na - nb), 1e-8),
              "embedding S_z - 4": (res["sz_emb"] - 4, 0.5),
              "m_Ni0 - m_Ni1": (mag[0] - mag[1], OXIDE_TOL["nio FM equal"]),
              "mean field - UHF": (res["E_mf"] - res["E_hf"],
                                   OXIDE_TOL["nio mean field == UHF"]),
              "IB-HF - UHF": (res["E_ibhf"] - res["E_hf"],
                              OXIDE_TOL["nio IB identity"])}
    _hold_checks(label, checks, bad)
    if not (mag[0] > 0 and mag[1] > 0):
        bad.append("%s: moments %s not aligned" % (label, mag))
    if full:
        _oxide_against_records(label, "nio_fm", res, bad)
    del Lat, meta, res

    # 16c the CuO2 plane
    label = "16c CuO2 AFM"
    Lat, meta, _ = _oxide_build("cuo2_afm", device, card, label, **kw)
    res, (tri["cuo2_afm"], cross["cuo2_afm"]), _, _ = _oxide_one_shot(
        Lat, meta, "cuo2_afm", device, card, label)
    mag = res["mag"]
    checks = {"mean field - UHF": (res["E_mf"] - res["E_hf"],
                                   OXIDE_TOL["cuo2 mean field == UHF"]),
              "IB-HF - UHF": (res["E_ibhf"] - res["E_hf"],
                              OXIDE_TOL["cuo2 IB identity"]),
              "m_Cu0 + m_Cu1": (mag[0] + mag[1], OXIDE_TOL["cuo2 AFM sum"])}
    _hold_checks(label, checks, bad)
    if full:
        _oxide_against_records(label, "cuo2_afm", res, bad)
        if not (mag[0] > 0.25 and mag[1] < -0.25):
            bad.append("%s: moments %s" % (label, mag))
    _oxide_cpu_replay(Lat, meta, "cuo2_afm", res, label, card, bad)
    del Lat, meta, res
    peak = torch.cuda.max_memory_allocated(device) / 2 ** 30
    print("16 [%s]: peak device memory %.2f GiB" % (card, peak))

    # both kernels at the oxide path's shape
    shape = shapes["nio_afm"]
    e1, ms, plain_ms, bound, by = tri_kernel_at(shape, device, card)
    e2, ms_x, plain_x, bound_x, by_x = tri_kernel_at(shape, device, card,
                                                     seed=23, kind="cross")
    if bad:
        raise AssertionError("16 failed: %s" % bad)
    at = {"tri": {"shape": list(shape), "launches": sum(tri.values()),
                  "ms": ms, "plain_ms": plain_ms, "library_ms": plain_ms,
                  "bound_ms": bound, "bound_by": by},
          "cross": {"shape": list(shape), "launches": sum(cross.values()),
                    "ms": ms_x, "plain_ms": plain_x, "library_ms": plain_x,
                    "bound_ms": bound_x, "bound_by": by_x}}
    return tri, cross, max(e1, e2), at


# ----------------------------------------------------------------------
# phase 17: the scale-out layer (parallel/kmesh, parallel/dryrun)
# ----------------------------------------------------------------------

SCALE_OUT = {"ranks": 4, "timeout": 900}


def _print_kmesh_cases(label, card, res):
    for k, v in res["errors"].items():
        print("%s [%s]: %-30s %.3e" % (label, card, k, v))


def phase_scale_out_inprocess(device, card, prebuilt):
    """17a: an NCCL group of one rank (HashStore) in this process; every
    kmesh function at full width on the card against the serial port path
    (workloads.kmesh_cases at "card": SquareLattice(40, 40, 2, 2) rebuilt
    from its seeds, phase 6's lattice, factors, alpha basis and impurity
    density, phase 9c's GDF factors, phase 9a's spin-orbital integrals).
    Returns the symmetric syrk launches of the sharded ERI call (on a CPU
    device the group is gloo's: a rehearsal)."""
    import datetime
    import torch.distributed as dist
    from libdmet_preview_tpu_torch import workloads as wl
    from libdmet_preview_tpu_torch.parallel import kmesh
    backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1,
                            timeout=datetime.timedelta(seconds=600))
    try:
        mesh = kmesh.make_mesh((1, 1), ("k", "aux"), device)
        _sync(device)
        t0 = time.perf_counter()
        res = wl.kmesh_cases(mesh, "card", prebuilt=prebuilt)
        _sync(device)
        sec = time.perf_counter() - t0
    finally:
        dist.destroy_process_group()
    _print_kmesh_cases("17a 1 NCCL rank", card, res)
    print("17a 1 NCCL rank [%s]: every kmesh case in %.2f s; sharded ERI at "
          "(naux, neo) = (%d, %d): %d tri launches, %d plain-version calls "
          "on CUDA tensors; sharded CCSD %d iterations"
          % (card, sec, prebuilt["abinitio"][0].getH2().shape[0],
             prebuilt["abinitio"][1].shape[-1], res["launches"],
             res["plain_cuda"], kmesh.ccsd_solve_sharded.last["iterations"]))
    return res["launches"]


def phase_scale_out_ranks(device, card):
    """17b: entry.dryrun_multichip(4, backend="gloo") on the card: four
    ranks sharing it on a 2 x 2 (k, aux) grid, each running the dry run at
    the JAX package's sizes and workloads.kmesh_cases at the card's
    widths, rebuilt from the seeds on every rank (the CCSD cases at
    tests/test_parallel.py's nocc = 8, nvir = 6), each against the serial
    port path on its rank; then the symmetric kernel at a rank's shard of
    phase 6's factors, (naux / 2, neo), timed.  Returns (the symmetric
    syrk launches of the sharded ERI calls summed over the ranks, the
    maximum error of the kernel there, its record for the kernels
    line)."""
    from libdmet_preview_tpu_torch.entry import dryrun_multichip
    n = SCALE_OUT["ranks"]
    t0 = time.perf_counter()
    out = dryrun_multichip(n, backend="gloo", device="cuda", cases="card",
                           timeout=SCALE_OUT["timeout"])
    sec = time.perf_counter() - t0
    ranks = out["dryrun"]["ranks"]
    launches, bad = 0, []
    for r in ranks:
        it, cases = r["iteration"], r["cases"]
        launches += it["eri_launches"] + cases["launches"]
        print("17b rank %d of %d (gloo, %s) [%s]: dry run mesh %s E_mf %.10f "
              "E_imp %.10f nelec_imp %.10f fit_err %.6e, deviations mf %.1e "
              "h1 %.1e eri %.1e; worst kmesh case %s %.3e; tri launches %d "
              "(dry run) + %d (cases), plain-version calls on CUDA %d"
              % (r["rank"], n, r["device"], card, it["mesh"], it["E_mf"],
                 it["E_imp"], it["nelec_imp"], it["fit_err"], it["err_mf"],
                 it["err_h1"], it["err_eri"],
                 *max(cases["errors"].items(), key=lambda kv: kv[1]),
                 it["eri_launches"], cases["launches"], cases["plain_cuda"]))
        if it["eri_launches"] != 1 or cases["launches"] != 1 \
                or cases["plain_cuda"] or it["mesh"] != [n // 2, 2]:
            bad.append("rank %d launches or mesh" % r["rank"])
    ref = ranks[0]["iteration"]
    for r in ranks[1:]:
        for k in ("E_mf", "E_imp", "nelec_imp", "fit_err"):
            if abs(r["iteration"][k] - ref[k]) > 1e-12:
                bad.append("rank %d %s differs from rank 0" % (r["rank"], k))
    print("17b %d gloo ranks sharing the card [%s]: %.1f s in all (the "
          "subprocess, its %d ranks' start, their inputs and cases)"
          % (n, card, sec, n))
    if bad or len(ranks) != n:
        raise AssertionError("17b failed: %s" % bad)
    shape = (AI_NAUX // 2, 2 * AI_NLO)
    err, ms, plain_ms, bound, by = tri_kernel_at(shape, device, card)
    return launches, err, {
        "shape": list(shape), "launches": n, "ms": ms, "plain_ms": plain_ms,
        "library_ms": plain_ms, "bound_ms": bound, "bound_by": by}


def main():
    from libdmet_preview_tpu_torch.ops.fci_sigma import LAUNCHES, FciSigma
    t_start = time.perf_counter()
    last = [t_start]
    # the FCI sigma kernel's launches and builds of each phase, counted
    # from 0 at each phase's start
    fci_by_path = {}

    def _tick(label):
        now = time.perf_counter()
        print("phase clock: %-22s %8.1f s (%.1f s since start)"
              % (label, now - last[0], now - t_start), flush=True)
        last[0] = now
        if FciSigma.launches or FCI_SIGMA_BUILDS[0]:
            fci_by_path[label] = {"launches": FciSigma.launches,
                                  "builds": FCI_SIGMA_BUILDS[0]}
        FciSigma.launches = FCI_SIGMA_BUILDS[0] = 0

    device, card = phase_device()
    phase_build()
    phase_fci_sigma_build()
    record_fci_sigma_shapes()
    _tick("2 build")
    max_abs, times = phase_kernels(device)
    _tick("3 kernels")
    phase_split_scan(device)
    _tick("3 split scan")
    launches_bench, ms_iter = phase_bench(device)
    _tick("4 bench")
    phase_hubbard(device)
    _tick("5 hubbard")
    launches_ai, run_d, run_c = phase_abinitio_uhf(device)
    _tick("6 abinitio uhf")
    with _quiet():
        launches_cc, E_ccsd, cc_ints = phase_abinitio_ccsd(run_d, device,
                                                           card)
        _tick("9a ccsd")
        t12 = time.perf_counter()
        launches_cas = phase_abinitio_cas(run_d, device, card, E_ccsd)
        _tick("12b cas")
        t12 = time.perf_counter() - t12
        # phase 15's host short-range rows, in the background from here
        # on: after the last of the host BFGS SCFs (phases 6, 9a, 12b),
        # whose multithreaded dense updates share the host cores' hyper-
        # threads with the rows' workers whatever their nice value
        diamond_rows = DiamondRows(device)
        launches_gso, at_gso, err_gso = phase_gso_abinitio(run_d, run_c,
                                                           device, card)
        launches_csc = phase_abinitio_csc(run_d, run_c, device, card)
        _tick("10c gso + 8d csc")
        # phase 17a reuses phase 6's lattice, basis and impurity density
        # and phase 9a's spin-orbital integrals
        keep17 = {"abinitio": (run_d["Lat"], run_d["basis"], run_d["rdm1"]),
                  "ccsd": cc_ints}
        del run_d, run_c, cc_ints
        # the phases of small host operations run PyTorch's CPU work on
        # one thread beside the rows' native threads: its intra-op pool,
        # spinning against them, made their CPU replays 9-26x slower
        # (scripts/replay_contention.py); the phases of large host GEMMs
        # (10c, 8d csc, 9c, 13, 14) keep the pool (PERF.md section 4)
        with _torch_threads(1):
            hub2d = phase_dmet_loop_hubbard(device, card)
            _tick("7a hubbard loops")
            phase_ccsd_loop(device, card, hub2d["IB U=2"])
            _tick("9b ccsd loop")
        keep17["gdf"] = phase_gdf(device, card)
        _tick("9c gdf")
        with _torch_threads(1):
            launches_chol, err_chol, times_chol = phase_dmet_loop_cholesky(
                device, card)
            _tick("7b cholesky loop")
            phase_pdmet(device, card)
            _tick("8a pdmet")
            phase_ib_fock(device, card)
            _tick("8b ib fock")
            phase_nearest(device, card)
            _tick("8d nearest")
            phase_three_band(device, card)
            _tick("8c three band")
            phase_dwave(device, card)
            _tick("10a dwave")
            launches_hchain, err_hchain, at_hchain = phase_abinitio_lattices(
                device, card)
            _tick("11 abinitio lattices")
            t0 = time.perf_counter()
            phase_cas_oracles(device, card)
            _tick("12a cas oracles")
            launches_hchain_cas = phase_hchain_cas(device, card,
                                                   ints_hchain())
            _tick("12c hchain cas")
            t12 += time.perf_counter() - t0
        t13 = time.perf_counter()
        launches_dft, err_dft, at_dft = phase_dft(device, card)
        _tick("13 dft")
        t13 = time.perf_counter() - t13
        t14 = time.perf_counter()
        launches_pbc, err_pbc, at_pbc = phase_pbc(device, card)
        _tick("14 pbc")
        t14 = time.perf_counter() - t14
        # 10b's CPU replay (FCI sigma builds, 30-47 s) after the rows are
        # made: beside them it took 71.5-107.3 s (PERF.md section 4);
        # phase 15 waits for them anyway
        t0 = time.perf_counter()
        diamond_rows.thread.join()
        print("10b waited %.2f s for phase 15's rows"
              % (time.perf_counter() - t0))
        phase_doped(device, card)
        _tick("10b doped")
        t15 = time.perf_counter()
        launches_diamond, err_diamond, at_diamond = phase_diamond(
            device, card, diamond_rows)
        _tick("15 diamond")
        t15 = time.perf_counter() - t15
        t16 = time.perf_counter()
        tri_ox, cross_ox, err_ox, at_ox = phase_oxides(device, card)
        _tick("16 oxides")
        t16 = time.perf_counter() - t16
        t17 = time.perf_counter()
        launches_17a = phase_scale_out_inprocess(device, card, keep17)
        del keep17
        _tick("17a scale-out 1 rank")
        launches_17b, err_17, at_17 = phase_scale_out_ranks(device, card)
        _tick("17b scale-out 4 ranks")
        t17 = time.perf_counter() - t17
    # the paths' counts and shapes, phase 18's own checks and timing left
    # out
    fci_paths = dict(fci_by_path)
    fci_seen = set(FCI_SIGMA_SEEN)
    err_fs, timed_fs = phase_fci_sigma(device, card, FCI_SIGMA_SEEN)
    _tick("18 fci sigma")
    print("fci sigma kernel launches (builds) by phase [%s]: %s"
          % (card, ", ".join("%s %d (%d)" % (k, v["launches"], v["builds"])
                             for k, v in fci_paths.items())))
    off = {k: v for k, v in fci_paths.items()
           if v["launches"] != LAUNCHES * v["builds"]}
    if off or not fci_paths:
        raise AssertionError("a phase's CUDA sigma builds left the kernel "
                             "(%d launches a build): %s" % (LAUNCHES, off))
    max_abs["syrk_df"] = max(max_abs["syrk_df"], err_chol, err_gso,
                             err_hchain, err_dft, err_pbc, err_diamond,
                             err_ox, err_17)
    max_abs["syrk_df_cross"] = max(max_abs["syrk_df_cross"], err_ox)
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
              "abinitio_gso": launches_gso["syrk_df"],
              "abinitio_hchain": launches_hchain,
              "abinitio_cas": launches_cas["syrk_df"],
              "hchain_cas": launches_hchain_cas,
              "dft_in_dmet": launches_dft,
              "pbc_hchain": launches_pbc,
              "diamond": launches_diamond, **tri_ox,
              "scale_out_1rank": launches_17a,
              "scale_out_4ranks": launches_17b}),
            ("syrk_df_cross", "cross",
             "libdmet_preview_tpu/ops/pallas_eri.py:45",
             {"abinitio_uhf": launches_ai["syrk_df_cross"],
              "abinitio_csc": launches_csc["syrk_df_cross"],
              "abinitio_ccsd": launches_cc["syrk_df_cross"],
              "abinitio_gso": launches_gso["syrk_df_cross"],
              "abinitio_cas": launches_cas["syrk_df_cross"],
              **cross_ox})]:
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
    kernels.append({
        "name": "fci_sigma", "route": "cuda",
        "source": "libdmet_preview_tpu_torch/csrc/fci_sigma.cu",
        "replaces": None,
        "launches": sum(v["launches"] for v in fci_paths.values()),
        "launches_by_path": {k: v["launches"] for k, v in fci_paths.items()},
        "builds_by_path": {k: v["builds"] for k, v in fci_paths.items()},
        "shapes": sorted([n, list(e)] for n, e in fci_seen),
        "max_abs_err": err_fs, **timed_fs, "library_ms": None,
        "design": FCI_SIGMA_DESIGN})
    # the symmetric kernel at the shape the DMET loop's path gives it
    naux_c, neo_c = CHOL_SHAPE
    bound_c, by_c, _ = kernel_bound("tri", naux_c, neo_c * (neo_c + 1) // 2)
    kernels[0]["at_dmet_loop_shape"] = {
        "shape": [naux_c, neo_c], "launches": launches_chol,
        "ms": times_chol[0], "plain_ms": times_chol[1],
        "library_ms": times_chol[1], "bound_ms": bound_c, "bound_by": by_c}
    # the symmetric kernel at the shape the ab initio GSO path gives it
    kernels[0]["at_gso_shape"] = at_gso
    # ... and the shape the H-chain lattices built from the engine arrays
    # give it (phase 11)
    kernels[0]["at_abinitio_hchain_shape"] = at_hchain
    # ... and the shape the full-width DFT-in-DMET ring gives it (phase 13)
    kernels[0]["at_dft_in_dmet_shape"] = at_dft
    # ... and the shape the nk = 6 H chain built by the port's cell gives
    # it (phase 14)
    kernels[0]["at_pbc_hchain_full_shape"] = at_pbc
    # ... and the shape the nk = 2 diamond chain gives it (phase 15)
    kernels[0]["at_diamond_shape"] = at_diamond
    # ... and the shape of a rank's aux shard on the scale-out grid (17b)
    kernels[0]["at_scale_out_shard_shape"] = at_17
    # ... and both kernels at the shape the oxides' interacting bath gives
    # them (phase 16)
    kernels[0]["at_oxide_shape"] = at_ox["tri"]
    kernels[1]["at_oxide_shape"] = at_ox["cross"]
    print("chip_smoke total: %.1f s, of it phase 12 %.1f s, phase 13 %.1f s, "
          "phase 14 %.1f s, phase 15 %.1f s, phase 16 %.1f s, phase 17 %.1f "
          "s [%s]" % (time.perf_counter() - t_start, t12, t13, t14, t15, t16,
                      t17, card))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
