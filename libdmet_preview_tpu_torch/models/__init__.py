"""Lattices, Hamiltonians and the embedding-Hamiltonian container."""
