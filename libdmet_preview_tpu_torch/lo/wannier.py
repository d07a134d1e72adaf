"""
Wannier-style localized orbitals (PyTorch port of
libdmet_preview_tpu/lo/wannier.py): the projection method and the W90
facade over the Marzari-Vanderbilt engine of lo/maxloc.py.

    A(k) = C_mo(k)^H S(k) g        (project guesses onto the bands)
    U(k) = A(k) (A^H A)^{-1/2}     (per-k Lowdin orthonormalization)
    C_lo(k) = C_mo(k) U(k)

All k-points go through one batched complex SVD on the device.  The
wannier90 text files (.win, .amn, .mmn, .eig) are written on the host, in
the JAX package's format, line for line.
"""

import numpy as np
import torch

from libdmet_preview_tpu_torch.utils import logger as log
from libdmet_preview_tpu_torch.lo import maxloc


def _device_of(A, device):
    if isinstance(A, torch.Tensor):
        return A.device
    if isinstance(A, (tuple, list)) and isinstance(A[0], torch.Tensor):
        return A[0].device
    return torch.device(device)


def proj_wannier(C_mo_k, guess, ovlp_k=None, band_idx=None,
                 device=torch.device("cuda")):
    """Projected Wannier gauge.

    C_mo_k: (nk, nao, nmo) complex or (re, im) pair (a tensor keeps its
    device, an array goes to `device`); guess: (nao, nlo) real
    initial-guess orbitals; ovlp_k: optional (nk, nao, nao); band_idx:
    bands to span (default the first nlo).  Returns a complex (nk, nao,
    nlo) tensor."""
    dev = _device_of(C_mo_k, device)
    C = maxloc._as_complex(C_mo_k, dev)
    g = maxloc._as_complex(guess, dev)
    nlo = g.shape[-1]
    if band_idx is None:
        band_idx = np.arange(nlo)
    Cb = C[:, :, torch.as_tensor(np.asarray(band_idx), dtype=torch.long,
                                 device=dev)]
    if ovlp_k is None:
        A = Cb.conj().transpose(-2, -1) @ g
    else:
        A = Cb.conj().transpose(-2, -1) @ maxloc._as_complex(ovlp_k, dev) @ g
    u, s, vt = torch.linalg.svd(A, full_matrices=False)
    smin = s.min(dim=-1).values.cpu().numpy()
    for k in np.nonzero(smin < 1e-8)[0]:
        log.warn("proj_wannier: near-singular projection at k=%d "
                 "(min sv %.2e) -- guesses poorly overlap the bands",
                 k, smin[k])
    return Cb @ (u @ vt)


def get_C_ao_lo_wannier(lattice, C_mo_k, guess, ovlp_k=None, band_idx=None,
                        device=torch.device("cuda")):
    """Lattice-facing wrapper: projected-Wannier C_ao_lo as a (re, im)
    pair of tensors shaped (1, nk, nao, nlo), directly usable as the
    lattice LO basis."""
    C = proj_wannier(C_mo_k, guess, ovlp_k=ovlp_k, band_idx=band_idx,
                     device=device)
    return C.real.contiguous()[None], C.imag.contiguous()[None]


class W90(object):
    """Native maximally-localized-Wannier driver with the reference's W90
    surface (make_win / get_A_mat / get_M_mat / kernel / export_AME) over
    the in-repo Marzari-Vanderbilt engine (lo/maxloc.py), batched over all
    k-points on `device`.

    C_mo_k  : (nk, norb, nband) complex Bloch coefficients on an
              orthonormal per-cell basis (kmesh_kpts_frac ordering), or a
              (re, im) pair.
    kmesh   : mesh sizes (tuple of 3).
    latt_vec: (3, 3) lattice vectors (rows).
    num_wann: number of Wannier functions (must equal nband).
    tau     : (norb, 3) orbital centers in Cartesian coords.
    guess   : (norb, num_wann) initial-guess orbitals for the projected
              starting gauge (default: identity gauge).
    """

    def __init__(self, C_mo_k, kmesh, latt_vec, num_wann, tau=None,
                 guess=None, band_idx=None, device=torch.device("cuda")):
        self.device = _device_of(C_mo_k, device)
        C = maxloc._as_complex(C_mo_k, self.device)
        if band_idx is not None:
            C = C[:, :, torch.as_tensor(np.asarray(band_idx),
                                        dtype=torch.long, device=C.device)]
        if C.shape[-1] != num_wann:
            raise ValueError(
                "W90: nband (%d) != num_wann (%d); select bands with "
                "band_idx or disentangle with lo.scdm.scdm_smear first"
                % (C.shape[-1], num_wann))
        self.C_mo_k = C
        self.kmesh = tuple(int(x) for x in kmesh)
        self.latt_vec = np.asarray(latt_vec, dtype=float).reshape(3, 3)
        self.num_wann = int(num_wann)
        self.tau = tau
        self.guess = guess
        self.bv = maxloc.kmesh_bvectors(self.latt_vec, self.kmesh)
        self.kpts_frac = maxloc.kmesh_kpts_frac(self.kmesh)
        self.U_matrix = None
        self.wann_centers = None
        self.wann_spreads = None
        self.omega = None
        self.mo_energy_kpts = None

    # -- reference-shaped building blocks ------------------------------
    def get_M_mat(self):
        """(nk, nb, nw, nw) overlap tensor M^{(k,b)} (the .mmn content)."""
        M, _ = maxloc.mmn_from_C(self.C_mo_k, self.kmesh, self.latt_vec,
                                 tau=self.tau, bv=self.bv,
                                 device=self.device)
        return M

    def get_A_mat(self):
        """(nk, nw, nw) projection matrices A(k) = C(k)^H g (the .amn
        content; identity-gauge fallback when no guess is set)."""
        nk = self.C_mo_k.shape[0]
        if self.guess is None:
            return torch.eye(self.num_wann, dtype=torch.complex128,
                             device=self.device).expand(
                nk, self.num_wann, self.num_wann).clone()
        g = maxloc._as_complex(self.guess, self.device)
        return self.C_mo_k.conj().transpose(-2, -1) @ g

    def kernel(self, A_matrix=None, M_matrix=None, max_iter=500,
               step=1.0, tol=1e-10):
        """Run the MV minimization.  Returns C_loc_k (nk, norb, nw)."""
        M0 = self.get_M_mat() if M_matrix is None else \
            maxloc._as_complex(M_matrix, self.device)
        U0 = None
        A = A_matrix if A_matrix is not None else (
            self.get_A_mat() if self.guess is not None else None)
        if A is not None:
            # Lowdin-orthonormalize the projection into a unitary gauge
            u, s, vt = torch.linalg.svd(maxloc._as_complex(A, self.device),
                                        full_matrices=False)
            U0 = u @ vt
        U, info = maxloc.max_loc_U(M0, self.bv, U0=U0, max_iter=max_iter,
                                   step=step, tol=tol, device=self.device)
        self.U_matrix = U
        self.omega = info["omega"]
        self.info = info
        self.wann_centers = info["centers"]
        # per-function spreads: diagonal decomposition of Omega
        w_b, b_cart, nb_idx = maxloc._bv_tensors(self.bv, self.device)
        Mf = maxloc._rotate_M(M0, U, nb_idx)
        d = torch.diagonal(Mf, dim1=-2, dim2=-1)
        nk = Mf.shape[0]
        cen = torch.as_tensor(self.wann_centers, device=self.device)
        q = torch.angle(d) + torch.einsum("bx, nx -> bn", b_cart, cen)[None]
        absd2 = torch.abs(d) ** 2
        self.wann_spreads = (
            torch.einsum("b, kbn -> n", w_b, 1.0 - absd2 + q ** 2) / nk
            + torch.einsum("b, kbmn -> n", w_b, torch.abs(Mf) ** 2) / nk
            - torch.einsum("b, kbn -> n", w_b, absd2) / nk).cpu().numpy()
        log.info("W90: Omega %.8f (I %.8f, D %.2e, OD %.2e), %d iters",
                 info["omega"], info["omega_I"], info["omega_D"],
                 info["omega_OD"], info["n_iter"])
        return self.C_mo_k @ U

    # -- wannier90 text-format interop ---------------------------------
    def make_win(self, fname=None):
        """Minimal .win (reference make_win)."""
        lines = ["num_wann = %d" % self.num_wann,
                 "num_bands = %d" % self.C_mo_k.shape[-1],
                 "begin unit_cell_cart"]
        for v in self.latt_vec * 0.529177210903:   # bohr -> angstrom
            lines.append(" %.10f %.10f %.10f" % tuple(v))
        lines += ["end unit_cell_cart",
                  "mp_grid = %d %d %d" % self.kmesh, "begin kpoints"]
        for k in self.kpts_frac:
            lines.append(" %.10f %.10f %.10f" % tuple(k))
        lines.append("end kpoints")
        text = "\n".join(lines) + "\n"
        if fname:
            with open(fname, "w") as f:
                f.write(text)
        return text

    def export_AME(self, prefix="wannier90"):
        """Write .amn / .mmn / .eig in the wannier90 text format, so a real
        wannier90 binary elsewhere can consume this build's overlaps."""
        nk, nb = self.C_mo_k.shape[0], self.C_mo_k.shape[-1]
        nw, nnb = self.num_wann, len(self.bv["w_b"])
        A = self.get_A_mat().cpu().numpy()
        with open(prefix + ".amn", "w") as f:
            f.write("generated by libdmet_preview_tpu\n")
            f.write("%d %d %d\n" % (nb, nk, nw))
            for k in range(nk):
                for n in range(nw):
                    for m in range(nb):
                        z = A[k, m, n]
                        f.write("%5d %4d %4d  %17.12f %17.12f\n"
                                % (m + 1, n + 1, k + 1, z.real, z.imag))
        M = self.get_M_mat().cpu().numpy()
        kmesh = np.array(self.kmesh)
        with open(prefix + ".mmn", "w") as f:
            f.write("generated by libdmet_preview_tpu\n")
            f.write("%d %d %d\n" % (nb, nk, nnb))
            pts = self.kpts_frac * kmesh
            for k in range(nk):
                for b in range(nnb):
                    k2 = self.bv["nb_idx"][k, b]
                    # reciprocal-lattice shift when k+b wraps the BZ
                    g = np.rint((pts[k] + self.bv["b_int"][b] - pts[k2])
                                / kmesh).astype(int)
                    f.write("%5d %5d  %3d %3d %3d\n"
                            % (k + 1, k2 + 1, g[0], g[1], g[2]))
                    for n in range(nb):
                        for m in range(nb):
                            z = M[k, b, m, n]
                            f.write("  %17.12f %17.12f\n"
                                    % (z.real, z.imag))
        if self.mo_energy_kpts is not None:
            with open(prefix + ".eig", "w") as f:
                for k in range(nk):
                    for m in range(nb):
                        f.write("%5d %5d  %17.12f\n"
                                % (m + 1, k + 1,
                                   self.mo_energy_kpts[k][m]))
