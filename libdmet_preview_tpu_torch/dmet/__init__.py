"""DMET vocabulary for Hubbard-family models."""
