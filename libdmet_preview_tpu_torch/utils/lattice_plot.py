"""
Lattice visualizations (PyTorch port of
libdmet_preview_tpu/utils/lattice_plot.py; reference analog:
the reference libdmet's utils/lattice_plot.py).  matplotlib is imported
inside each call, never at import.
"""

import numpy as np

from libdmet_preview_tpu_torch.utils import logger as log


def _mpl():
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        return plt
    except ImportError:  # pragma: no cover
        log.warn("matplotlib not available; plotting disabled")
        return None


def plot_lattice(coords, charges=None, spins=None, bonds=None,
                 filename=None, ax=None):
    """Scatter plot of lattice sites with optional charge (size), spin
    (up/down color) and bond annotations.  coords: (nsite, 2)."""
    plt = _mpl()
    if plt is None:
        return None
    coords = np.asarray(coords)
    if ax is None:
        fig, ax = plt.subplots(figsize=(5, 5))
    size = 120.0 * (np.asarray(charges) if charges is not None
                    else np.ones(len(coords)))
    color = np.asarray(spins) if spins is not None else np.zeros(len(coords))
    sc = ax.scatter(coords[:, 0], coords[:, 1], s=size, c=color,
                    cmap="coolwarm", vmin=-0.5, vmax=0.5,
                    edgecolors="k", zorder=3)
    if bonds is not None:
        for (i, j, w) in bonds:
            ax.plot([coords[i, 0], coords[j, 0]],
                    [coords[i, 1], coords[j, 1]],
                    lw=2.0 * abs(w), c="gray", zorder=1)
    ax.set_aspect("equal")
    if filename:
        ax.figure.savefig(filename, dpi=150, bbox_inches="tight")
    return ax


def plot_dos(mo_energy, sigma=0.05, filename=None, ax=None, **kwargs):
    """DOS plot from orbital energies (uses utils.analysis.get_dos)."""
    plt = _mpl()
    if plt is None:
        return None
    from libdmet_preview_tpu_torch.utils.analysis import get_dos
    ws, dos = get_dos(mo_energy, sigma=sigma, **kwargs)
    if ax is None:
        fig, ax = plt.subplots(figsize=(6, 3))
    ax.plot(ws, dos)
    ax.set_xlabel("energy")
    ax.set_ylabel("DOS")
    if filename:
        ax.figure.savefig(filename, dpi=150, bbox_inches="tight")
    return ax
