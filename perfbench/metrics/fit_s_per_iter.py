"""Seconds per DMET iteration in the vcor fit (the program's span "vcor
fit")."""


def read(obs):
    s = obs["spans"].get("vcor fit")
    return None if s is None else s / obs["iterations"]
