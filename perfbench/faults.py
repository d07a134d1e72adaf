"""
Faults planted in the program's timed path, each a context manager that
patches one step of the program and restores it on leaving.  The tests
hold that every one of them comes out not correct, and calibrate.py reads
them on the card at a cell's own size.

    python3 perfbench/calibrate.py ... --fault dmu_search_skipped
"""

import contextlib
import copy

import numpy as np
import torch


@contextlib.contextmanager
def _patched(obj, name, value):
    orig = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield orig
    finally:
        setattr(obj, name, orig)


def _wrap(obj, name, make):
    """Patch obj.name with make(original)."""
    return _patched(obj, name, make(getattr(obj, name)))


def stale_mean_field():
    """The lattice mean field returns its first state on every later
    call."""
    import libdmet_preview_tpu_torch.dmet.hubbard as facade

    def make(orig):
        memo = []

        def stale(*a, **k):
            if not memo:
                memo.append(orig(*a, **k))
            return memo[0]
        return stale
    return _wrap(facade, "HartreeFock", make)


def stale_davidson():
    """The FCI eigensolver returns its start vector unchanged once it has
    one."""
    from libdmet_preview_tpu_torch.solvers import fci

    def make(orig):
        def stale(matvec, hdiag, x0=None, **k):
            if x0 is None:
                return orig(matvec, hdiag, x0=x0, **k)
            x = x0 / torch.linalg.vector_norm(x0)
            return float(x @ matvec(x)), x
        return stale
    return _wrap(fci, "davidson", make)


def energy_altered():
    """The energy per site altered where it is produced, by 1e-5."""
    import libdmet_preview_tpu_torch.dmet.hubbard as facade

    def make(orig):
        def altered(*a, **k):
            out = orig(*a, **k)
            if isinstance(out, tuple):
                return out[0], out[1] + 1e-5, out[2]
            return out
        return altered
    return _wrap(facade, "transformResults", make)


def half_the_kpoints():
    """The lattice density from half of the k points, the mean taken over
    them."""
    from libdmet_preview_tpu_torch.models.lattice import LatticeModel

    def make(orig):
        def half(self, B):
            if isinstance(B, tuple) and np.ndim(B[0]) == 4:
                keep = np.zeros(np.shape(B[0])[1])
                keep[::2] = 2.0
                B = tuple(np.asarray(x) * keep[None, :, None, None]
                          for x in B)
            return orig(self, B)
        return half
    return _wrap(LatticeModel, "k2R", make)


def fit_unchanged():
    """The vcor fit returns its input vcor, with the error at the input:
    a step that returns its state unchanged."""
    import libdmet_preview_tpu_torch.dmet.hubbard as facade
    from libdmet_preview_tpu_torch.ops import fit

    def make(orig):
        def unchanged(rho, lattice, basis, vcor, beta, filling=0.5,
                      MaxIter1=300, MaxIter2=0, **k):
            _, err_in, _ = fit.FitVcorEmb(rho, lattice, basis,
                                          copy.deepcopy(vcor), beta,
                                          MaxIter=1, **k)
            return copy.deepcopy(vcor), err_in
        return unchanged
    return _wrap(facade, "FitVcor", make)


def dmu_search_skipped():
    """The chemical-potential search stops after its first solve, at the
    last iteration's dmu."""
    import libdmet_preview_tpu_torch.dmet.hubbard as facade

    def make(orig):
        def first_solve(self, *a, **k):
            k["thrnelec"] = float("inf")
            return orig(self, *a, **k)
        return first_solve
    return _wrap(facade.MuSolver, "__call__", make)


FAULTS = {f.__name__: f for f in (stale_mean_field, stale_davidson,
                                  energy_altered, half_the_kpoints,
                                  fit_unchanged, dmu_search_skipped)}
