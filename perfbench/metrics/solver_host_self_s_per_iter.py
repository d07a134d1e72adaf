"""The host's own seconds per DMET iteration in the impurity solver: the
host-clock seconds of the program's spans "impurity solves" less the
seconds the host spent blocked in their device-to-host reads (the
Davidson's host algebra, Python and launches, which the card can fill
only by running ahead)."""

from perfbench import spans


def read(obs):
    rec = spans.window(obs)
    if rec is None or not rec.named("impurity solves"):
        return None
    own = rec.host_seconds("impurity solves") \
        - rec.read_seconds(within="impurity solves")
    return own / obs["iterations"]
