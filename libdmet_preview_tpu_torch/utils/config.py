"""
Typed configuration for the DMET self-consistency loop (port of
libdmet_preview_tpu/utils/config.py, a host copy): one declarative config
object in place of settings modules and **kwargs plumbing.
"""

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class DmetConfig:
    # physics
    filling: float = 0.5
    beta: float = np.inf                 # inverse temperature (occupations)
    restricted: bool = False
    int_bath: bool = True
    use_hcore_as_emb_ham: Optional[bool] = None   # None = keep lattice value
    # charge self-consistency (update_Ham of the lattice Fock from the
    # mean-field density each iteration).  None = automatic (on for the
    # interacting bath with local H2); True/False force it.
    charge_sc: Optional[bool] = None

    # self-consistency loop
    max_iter: int = 20
    conv_tol_E: float = 1e-5
    conv_tol_vcor: float = 1e-5
    diis_start: int = 4
    diis_dim: int = 4
    trace_start: int = 3

    # chemical potential fit
    mu_thrnelec: float = 1e-5
    mu_step: float = 0.05

    # vcor fit
    fit_max_iter: int = 300
    fit_method: str = "CG"
    fit_imp_only: bool = False

    # bath
    valence_bath: bool = True
    tol_bath: float = 1e-9

    # solver
    solver: str = "FCI"                  # FCI | CCSD | MP2 | HF | CASCI
    solver_tol: float = 1e-11

    # checkpointing
    chkfile: Optional[str] = None

    def validate(self):
        assert 0.0 < self.filling < 1.0
        assert self.beta > 0
        assert self.max_iter >= 1, "max_iter must be >= 1"
        assert self.solver in ("FCI", "CCSD", "MP2", "HF", "CASCI")
        assert self.fit_method in ("CG", "BFGS", "trust-ncg", "SD")
        return self


# global numerical settings
IMAG_DISCARD_TOL = 1e-5
SAVE_MEM = False
