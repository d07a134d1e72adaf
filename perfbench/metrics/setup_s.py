"""Seconds from the process's start to the first timed job: imports, the
program's set-up and the protocol's warm-up."""


def read(obs):
    return obs.get("setup_s")
