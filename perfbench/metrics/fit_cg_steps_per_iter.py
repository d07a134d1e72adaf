"""CG steps of the vcor fit per DMET iteration (the program's counter
ops.fit._cg_engine.steps)."""


def read(obs):
    n = obs["counters"].get("cg_steps")
    return None if not n else n / obs["iterations"]
