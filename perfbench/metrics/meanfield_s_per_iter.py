"""Seconds per DMET iteration in the lattice mean field (the program's
span "mean field" of dmet/loop.run_dmet)."""


def read(obs):
    s = obs["spans"].get("mean field")
    return None if s is None else s / obs["iterations"]
