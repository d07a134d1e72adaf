"""Lattices and model Hamiltonians (host NumPy)."""
