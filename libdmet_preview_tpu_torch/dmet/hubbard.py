"""
DMET vocabulary for Hubbard-family lattice models (PyTorch port of the
parts of libdmet_preview_tpu/dmet/hubbard.py that the fused lattice
iteration needs: the lattice/Hamiltonian re-exports and the vcor initial
guesses).
"""

import numpy as np

from libdmet_preview_tpu_torch.models.lattice import (  # noqa: F401
    ChainLattice, BipartiteSquare)
from libdmet_preview_tpu_torch.models.hamiltonian import (  # noqa: F401
    HubbardHamiltonian as Ham)
from libdmet_preview_tpu_torch.ops.vcor import VcorLocal


def AFInitGuess(ImpSize, U, Filling, polar=None, bogoliubov=False, rand=0.0,
                subA=None, subB=None, trace_zero=False, d_wave=False,
                bogo_res=False):
    if subA is None and subB is None:
        subA, subB = BipartiteSquare(ImpSize)
    nscsites = len(subA) + len(subB)
    shift = U * Filling
    if polar is None:
        polar = shift * Filling
    init_v = np.eye(nscsites) * shift
    if trace_zero:
        init_v[:] = 0.0
    init_p = np.zeros_like(init_v)
    for i in range(nscsites):
        if i in subA:
            init_p[i, i] = polar
        elif i in subB:
            init_p[i, i] = -polar
    v = VcorLocal(False, bogoliubov, nscsites, bogo_res=bogo_res)
    if bogoliubov:
        # the same seeded NumPy stream as the JAX package, so both
        # packages start from the same vcor
        rng = np.random.RandomState(32499823)
        init_d = (rng.rand(nscsites, nscsites) - 0.5) * rand
        v.assign(np.asarray([init_v + init_p, init_v - init_p, init_d]))
    else:
        v.assign(np.asarray([init_v + init_p, init_v - init_p]))
    return v


def PMInitGuess(ImpSize, U, Filling, bogoliubov=False, rand=0.0):
    nscsites = int(np.prod(ImpSize))
    shift = U * Filling
    init_v = np.eye(nscsites) * shift
    v = VcorLocal(True, bogoliubov, nscsites)
    if bogoliubov:
        init_d = np.zeros((nscsites, nscsites))
        v.assign(np.asarray([init_v, init_v, init_d]))
    else:
        v.assign(np.asarray([init_v, init_v]))
    if rand > 0.0:
        rng = np.random.RandomState(32499823)
        v.update(v.param + (rng.rand(v.length()) - 0.5) * rand)
    return v
