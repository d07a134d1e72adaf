"""Share (%) of the FCI sigma build's roofline bound in its measured time:
the least time the card could take for the window's sigma builds (from
perfbench.roofline, per (norb, nelec_a, nelec_b)) over their time by CUDA
events around each build."""

from perfbench import roofline


def read(obs):
    calls = sum(n for n, _ in obs["sigma"].values())
    seconds = sum(s for _, s in obs["sigma"].values())
    if not calls or seconds <= 0.0:
        return None
    bound = sum(n * roofline.bound_s(*roofline.sigma_work(*key))
                for key, (n, _) in obs["sigma"].items())
    return 100.0 * bound / seconds
