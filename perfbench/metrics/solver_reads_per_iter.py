"""Device-to-host reads per DMET iteration in the impurity solver: the
program's counter "host reads" inside its spans "impurity solves" (the
Davidson's subspace matrix, residual and vector norms, the dmu search's
electron counts)."""

from perfbench import spans


def read(obs):
    rec = spans.window(obs)
    if rec is None or not rec.named("impurity solves"):
        return None
    return rec.total("host reads", within="impurity solves") \
        / obs["iterations"]
