"""Seconds per DMET iteration in the bath and the embedding Hamiltonian
(the program's spans "bath", "H1" and "H2" of ConstructImpHam)."""


def read(obs):
    parts = [obs["spans"][k] for k in ("bath", "H1", "H2")
             if k in obs["spans"]]
    return sum(parts) / obs["iterations"] if parts else None
