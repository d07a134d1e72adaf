"""Seconds per DMET iteration in the impurity solver under the chemical
potential search (the program's span "impurity solves")."""


def read(obs):
    s = obs["spans"].get("impurity solves")
    return None if s is None else s / obs["iterations"]
