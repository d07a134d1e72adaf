"""Seconds per DMET iteration in the embedded UHF that every CCSD solve
starts with (solvers/scf: Roothaan with DIIS on the host, then the scipy
BFGS of the rotation refinement): the program's spans "CC reference
SCF", timed by the CUDA events at their ends (host seconds on the CPU)."""

from perfbench import spans


def read(obs):
    rec = spans.window(obs)
    parts = rec.named("CC reference SCF") if rec is not None else []
    if not parts:
        return None
    return sum(s.seconds for s in parts) / obs["iterations"]
