"""Device-to-host reads per DMET iteration in the vcor fit: the program's
counter "host reads" inside its spans "vcor fit" (the CG's step decisions
and every Armijo trial)."""

from perfbench import spans


def read(obs):
    rec = spans.window(obs)
    if rec is None or not rec.named("vcor fit"):
        return None
    return rec.total("host reads", within="vcor fit") / obs["iterations"]
