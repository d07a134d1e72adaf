"""FCI sigma builds per DMET iteration (the program's FCI.n_sigma, summed
over the window's solvers)."""


def read(obs):
    n = obs["counters"].get("sigma_builds")
    return None if not n else n / obs["iterations"]
