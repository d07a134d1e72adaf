"""
Ab initio lattice Hamiltonian (PyTorch port of the AbInitioHam class of
libdmet_preview_tpu/models/abinitio.py; the lattice builders and the
integral engine behind them are still to port).
"""


class AbInitioHam(object):
    """Duck-typed Ham object for LatticeModel.set_Ham_abinitio.

    H1_R / fock_R: ((spin,) ncells, nlo, nlo) LO-basis R stripes;
    chol_L: (naux, nsites, nsites) Cholesky/DF factors of the supercell LO
    ERI (H2 format 'cholesky'; set_Ham_abinitio copies them to the lattice's
    device and leaves this object as it was); eri_imp: the unit-cell LO ERI; H0: the constant energy per
    cell.  The JAX package's 'aft' format (embedding ERIs streamed from a
    cell's pair Fourier transform) is not ported."""

    H2_format = "cholesky"

    def __init__(self, H1_R, fock_R, chol_L, eri_imp, H0):
        if chol_L is None:
            raise NotImplementedError(
                "AbInitioHam: the 'aft' format (no Cholesky factors) is "
                "not ported yet: its transforms live in the integral "
                "engine (Slice 7)")
        self.H1_R = H1_R
        self.fock_R = fock_R
        self.chol_L = chol_L
        self.eri_imp = eri_imp
        self.H0 = H0
        self.ImpJK = None

    def getH1(self):
        return self.H1_R

    def getFock(self):
        return self.fock_R

    def getH2(self):
        return self.chol_L

    def getH0(self):
        return self.H0

    def getImpJK(self):
        return self.ImpJK
