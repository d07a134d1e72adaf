"""
The PyTorch port's embedded UHF (libdmet_preview_tpu_torch/solvers/scf.py
SCFSolver) against the JAX package's on the same embedding Integral: the
JAX-built interacting-bath Hamiltonian of the AFM H ring
(tests/test_torch_embham.py), carried across as NumPy, with the folded
lattice rdm1 as the initial guess, on the CPU.
"""

import numpy as np
import torch

from test_torch_embham import both_imp_ham
from test_torch_mfd import CPU

torch.set_num_threads(1)


def test_uhf_solver_matches_jax():
    from libdmet_preview_tpu.ops import embham as jembham
    from libdmet_preview_tpu.solvers import SCFSolver
    from libdmet_preview_tpu_torch.models.integral import Integral
    from libdmet_preview_tpu_torch.solvers import SCFSolver as TSCFSolver
    (Lat, _, _, ImpHam, _, basis), _ = both_imp_ham()
    rho_mf = np.asarray(jembham.foldRho_k(Lat.rdm1_lo_k,
                                          Lat.R2k_basis(basis)))
    nel = int(round(np.trace(rho_mf[0]) + np.trace(rho_mf[1])))
    rdm1, E = SCFSolver(restricted=False).run(ImpHam, nelec=nel, dm0=rho_mf)

    ham_t = Integral(ImpHam.norb, ImpHam.restricted, False, ImpHam.H0,
                     {"cd": np.asarray(ImpHam.H1["cd"])},
                     {"ccdd": np.asarray(ImpHam.H2["ccdd"])},
                     ovlp=np.asarray(ImpHam.ovlp))
    solver = TSCFSolver(restricted=False, device=CPU)
    rdm1_t, E_t = solver.run(ham_t, nelec=nel, dm0=rho_mf)
    assert solver.scf.converged
    assert rdm1_t.shape == (2, 4, 4)
    assert abs(E_t - E) < 1e-9
    assert np.abs(rdm1_t.numpy() - np.asarray(rdm1)).max() < 1e-7
    # the stability refinement ran its BFGS from the fixed offset
    assert len(solver.scf.oo_iterations) >= 1


def test_run_dmet_ham_matches_jax():
    """The HF energy functional of the solver's rdm1/rdm2 on a given
    Integral: the same number in both packages (1e-9)."""
    from libdmet_preview_tpu.models.integral import Integral as JIntegral
    from libdmet_preview_tpu.solvers import SCFSolver
    from libdmet_preview_tpu_torch.models.integral import Integral
    from libdmet_preview_tpu_torch.solvers import SCFSolver as TSCFSolver
    rng = np.random.RandomState(4)
    n = 4
    h1 = rng.randn(2, n, n)
    h1 = h1 + h1.transpose(0, 2, 1)
    g = rng.randn(3, n, n, n, n) * 0.1
    g = g + g.transpose(0, 2, 1, 3, 4)
    g = g + g.transpose(0, 1, 2, 4, 3)
    g[:2] = g[:2] + g[:2].transpose(0, 3, 4, 1, 2)
    ham_j = JIntegral(n, False, False, 0.3, {"cd": h1}, {"ccdd": g})
    ham_t = Integral(n, False, False, 0.3, {"cd": h1}, {"ccdd": g})
    s_j = SCFSolver(restricted=False)
    s_t = TSCFSolver(restricted=False, device=CPU)
    r_j, _ = s_j.run(ham_j, nelec=4)
    r_t, _ = s_t.run(ham_t, nelec=4)
    assert np.abs(r_t.numpy() - np.asarray(r_j)).max() < 1e-7
    assert abs(s_t.run_dmet_ham(ham_t) - s_j.run_dmet_ham(ham_j)) < 1e-9
