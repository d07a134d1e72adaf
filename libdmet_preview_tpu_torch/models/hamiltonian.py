"""
Model Hamiltonians (PyTorch port of libdmet_preview_tpu/models/hamiltonian.py,
HamNonInt and HubbardHamiltonian).

Host NumPy containers: stripe H1/Fock + local-format H2.
"""

import numpy as np

from libdmet_preview_tpu_torch.utils import logger as log


class HamNonInt(object):
    """Non-interacting lattice Hamiltonian + local two-body interaction.

    H1 shape ((spin,) ncells, nao, nao) stripe; H2 format is detected from
    its shape: 'local' (nao^4), 'nearest' (ncells, nao^4), 'full'
    (ncells^3, nao^4), 'spin local' (spin_dim, nao^4).
    """

    def __init__(self, lattice, H1, H2, Fock=None, ImpJK=None,
                 kspace_input=False, spin_dim_H2=None, H0=0.0):
        ncells = lattice.ncells
        nao = lattice.nao
        H1 = np.asarray(H1)
        H2 = np.asarray(H2)
        log.eassert(H1.shape[-3:] == (ncells, nao, nao),
                    "H1 shape %s not compatible with lattice", H1.shape)
        if kspace_input:
            H1 = np.asarray(lattice.k2R(H1))
        self.H1 = H1
        if Fock is None:
            self.Fock = self.H1
        else:
            Fock = np.asarray(Fock)
            if kspace_input:
                Fock = np.asarray(lattice.k2R(Fock))
            self.Fock = Fock

        self.spin_dim_H2 = spin_dim_H2
        nao_pair = nao * (nao + 1) // 2
        if spin_dim_H2 is None:
            if H2.shape == (nao,) * 4 or H2.shape == (nao_pair, nao_pair):
                self.H2_format = "local"
            elif H2.shape == (ncells,) + (nao,) * 4 \
                    or H2.shape == (ncells, nao_pair, nao_pair):
                self.H2_format = "nearest"
            elif H2.shape == (ncells,) * 3 + (nao,) * 4 \
                    or H2.shape == (ncells,) * 3 + (nao_pair, nao_pair):
                self.H2_format = "full"
            else:
                raise ValueError("H2 shape %s not compatible" % str(H2.shape))
        else:
            if H2.shape == (spin_dim_H2,) + (nao,) * 4:
                self.H2_format = "spin local"
            elif H2.shape == (spin_dim_H2, ncells) + (nao,) * 4:
                self.H2_format = "spin nearest"
            else:
                raise ValueError("H2 shape %s not compatible" % str(H2.shape))
        self.H2 = H2
        self.ImpJK = ImpJK
        self.H0 = H0

    def getH0(self):
        return self.H0

    def getH1(self):
        return self.H1

    def getH2(self):
        return self.H2

    def getFock(self):
        return self.Fock

    def getImpJK(self):
        return self.ImpJK


def HubbardHamiltonian(lattice, U, tlist=(1.0,), obc=False, tol=1e-10,
                       return_H1=False):
    """1-band Hubbard model: H = -t <ij> - t' <<ij>> ... + U n_up n_dn."""
    ncells = lattice.ncells
    nsc = lattice.nscsites
    H1 = np.zeros((ncells, nsc, nsc))
    search_range = 0 if obc else 1
    for order, t in enumerate(tlist):
        if abs(t) < tol:
            continue
        log.eassert(order < len(lattice.neighborDist),
                    "%dth neighbor distance unspecified", order + 1)
        dis = lattice.neighborDist[order]
        pairs = lattice.neighbor(dis=dis, sitesA=range(nsc),
                                 search_range=search_range)
        for i, j in pairs:
            H1[j // nsc, j % nsc, i] = -t
    if return_H1:
        return H1
    H2 = np.zeros((nsc,) * 4)
    np.fill_diagonal(H2, U)
    return HamNonInt(lattice, H1, H2)
