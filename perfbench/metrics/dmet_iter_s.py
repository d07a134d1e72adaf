"""Seconds per DMET iteration: the whole window over every DMET iteration
completed in it."""


def read(obs):
    n = obs.get("iterations")
    return obs["window_s"] / n if n else None
