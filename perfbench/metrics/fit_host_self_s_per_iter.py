"""The host's own seconds per DMET iteration in the vcor fit: the
host-clock seconds of the program's spans "vcor fit" less the seconds the
host spent blocked in their device-to-host reads."""

from perfbench import spans


def read(obs):
    rec = spans.window(obs)
    if rec is None or not rec.named("vcor fit"):
        return None
    own = rec.host_seconds("vcor fit") - rec.read_seconds(within="vcor fit")
    return own / obs["iterations"]
