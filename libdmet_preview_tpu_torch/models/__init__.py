"""Lattices, Hamiltonians and the embedding-Hamiltonian container."""

from libdmet_preview_tpu_torch.models.lattice import (  # noqa: F401
    UnitCell, SuperCell, LatticeModel, BipartiteSquare,
    ChainLattice, SquareLattice, SquareAFM, Square3Band, Square3BandAFM,
    Square3BandSymm, CubicLattice, HoneycombLattice,
)
from libdmet_preview_tpu_torch.models.hamiltonian import (  # noqa: F401
    HamNonInt, HubbardHamiltonian, Hubbard3band, Hubbard3band_ref,
)
