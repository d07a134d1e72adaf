"""
Fused DMET lattice iteration (PyTorch port of
libdmet_preview_tpu/ops/fastpath.py: make_dmet_iteration,
chain_iterations).

One iteration runs five stages on one device:

  1. mean field on the time-reversal-irreducible half mesh through the
     weighted Fermi-density op (zlinalg.zrho_fermi_w, complex eigh);
  2. Gram-eigh Schmidt bath with two Newton-Schulz orthonormality steps;
  3. embedding H1 and dV/dparam transforms;
  4. the vcor fit in the fixed embedding basis, by Levenberg-Marquardt
     (engine="lm", default) or Polak-Ribiere CG (engine="cg");
  5. with chol_L, the embedding-ERI transform: rotate the DF factors into
     the embedding basis (two GEMMs), s4-pack, and the syrk kernel
     (eri_kernels.syrk_df: the hand-written CUDA kernel on the card).

Scope as in the JAX package: model lattices with orthonormal LOs and a
local vcor, restricted or unrestricted, finite beta.
"""

import numpy as np
import torch
from torch import nn

from libdmet_preview_tpu_torch.ops import zlinalg
from libdmet_preview_tpu_torch.ops.eri_kernels import (pack_tril, syrk_df,
                                                       unpack_s4)
from libdmet_preview_tpu_torch.ops.fit import _cg_engine, _lm_engine_ft
from libdmet_preview_tpu_torch.ops.zlinalg import rho_fermi_real, zrho_fermi_w
from libdmet_preview_tpu_torch.utils.misc import keyword_aliases

ENGINES = ("lm", "cg")


class DmetIteration(nn.Module):
    """One fused DMET lattice iteration with its constant tensors held as
    buffers on one device.

    forward(vparam, rho_target) ->
        (vparam_new, fit_err, embH1, rho_R, basis[, eri_emb])

    vparam: (P,) vcor parameters; rho_target: (spin, neo, neo) correlated
    embedding 1-RDM to fit.  eri_emb (neo, neo, neo, neo) is returned
    when the iteration was built with chol_L."""

    def __init__(self, lattice, vcor, filling, beta, fit_max_iter, ytol,
                 gtol, chol_L, engine, device):
        super().__init__()
        if engine not in ENGINES:
            raise ValueError("engine must be one of %s, got %r"
                             % (ENGINES, engine))
        # same operator convention as the JAX package's mean field
        if lattice.use_hcore_as_emb_ham:
            fock_k = lattice.getH1(kspace=True)
        else:
            fock_k = lattice.getFock(kspace=True)
        f_re = np.asarray(fock_k[0])
        f_im = np.asarray(fock_k[1])
        if f_re.ndim == 3:
            f_re, f_im = f_re[None], f_im[None]
        spin = 1 if vcor.restricted else 2
        if f_re.shape[0] == 1 and spin == 2:
            f_re = np.broadcast_to(f_re, (2,) + f_re.shape[1:])
            f_im = np.broadcast_to(f_im, (2,) + f_im.shape[1:])
        nk = f_re.shape[1]
        nlo = f_re.shape[-1]
        if nk != lattice.ncells:
            raise ValueError("k mesh (%d) and cell count (%d) differ"
                             % (nk, lattice.ncells))

        ovlp = np.asarray(lattice.get_ovlp(kspace=False))
        if not (np.allclose(ovlp[0], np.eye(nlo), atol=1e-12)
                and np.max(np.abs(ovlp[1:])) < 1e-12):
            raise ValueError("fastpath assumes orthonormal LOs")
        if not vcor.islocal():
            raise ValueError("fastpath assumes a local vcor")

        # time-reversal irreducible half mesh + weights; the full mesh
        # when the Fock matrix breaks time reversal
        neg = lattice._neg_map
        ibz = np.asarray([k for k in range(nk) if k <= neg[k]])
        wk = np.asarray([1.0 if neg[k] == k else 2.0 for k in ibz])
        tr_ok = (np.allclose(f_re[:, neg], f_re, atol=1e-10)
                 and np.allclose(f_im[:, neg], -f_im, atol=1e-10))
        if not tr_ok:
            ibz = np.arange(nk)
            wk = np.ones(nk)

        cos_t, sin_t = zlinalg.dft_tables(tuple(int(x) for x in lattice.kmesh))
        imp_idx = np.asarray(lattice.imp_idx, dtype=int)
        val_idx = np.asarray(lattice.val_idx, dtype=int) \
            if getattr(lattice, "val_idx", None) is not None else imp_idx
        val_set = set(val_idx.tolist())
        env_idx = np.asarray([i for i in range(nk * nlo) if i not in val_set],
                             dtype=int)

        def buf(name, array, dtype=torch.float64):
            self.register_buffer(name, torch.as_tensor(
                np.ascontiguousarray(array), dtype=dtype, device=device))

        buf("cos_i", cos_t[ibz] * wk[:, None])
        buf("sin_i", sin_t[ibz] * wk[:, None])
        buf("cosT_i", cos_t.T[ibz])      # rows of the k <- R transform
        buf("sinT_i", sin_t.T[ibz])
        buf("f_re_i", f_re[:, ibz])
        buf("f_im_i", f_im[:, ibz])
        buf("wk", wk)
        buf("dv", np.asarray(vcor.gradient())[:, :spin])      # (P,s,n,n)
        buf("imp_idx", imp_idx, torch.long)
        buf("val_idx", val_idx, torch.long)
        buf("env_idx", env_idx, torch.long)
        # the DF factors (764 MB at the bench shape) go to the device once,
        # here, never per call
        self.register_buffer("chol_L", None if chol_L is None else
                             torch.as_tensor(chol_L, dtype=torch.float64,
                                             device=device))

        self.spin = spin
        self.nk = nk
        self.nlo = nlo
        self.nimp = len(imp_idx)
        self.neo = len(imp_idx) + len(val_idx)
        # occupations on the DOUBLED spectrum (the JAX package's public
        # convention), per spin channel; the mu search runs over all
        # channels jointly
        self.nelec2_lat = float(2 * nk * nlo * filling)
        self.nelec2_emb = 2 * int(lattice.ncore + lattice.nval)
        self.beta = float(beta)
        self.fit_max_iter = int(fit_max_iter)
        self.ytol = float(ytol)
        self.gtol = float(gtol)
        self.engine = engine

    def mean_field(self, vparam):
        vmat = torch.einsum("P, Psij -> sij", vparam, self.dv)
        h_re = self.f_re_i + vmat[:, None]
        return zrho_fermi_w(h_re, self.f_im_i, self.spin * self.nelec2_lat,
                            self.beta, self.wk)

    def bath(self, rho_R):
        """Gram-eigh Schmidt bath: (spin, nk*nlo, neo) embedding basis."""
        spin, nk, nlo, nimp = self.spin, self.nk, self.nlo, self.nimp
        flat = rho_R.reshape(spin, nk * nlo, nlo)
        env = flat[:, self.env_idx][:, :, self.val_idx]
        G = env.transpose(-1, -2) @ env
        w, V = torch.linalg.eigh(G)
        w = torch.maximum(w, 1e-14 * torch.max(w, dim=-1, keepdim=True).values)
        u = (env @ V) / torch.sqrt(w)[:, None, :]
        eye_b = torch.eye(u.shape[-1], dtype=u.dtype, device=u.device)
        for _ in range(2):      # Newton-Schulz orthonormality cleanup
            g2 = u.transpose(-1, -2) @ u
            u = u @ (1.5 * eye_b - 0.5 * g2)
        basis = torch.zeros((spin, nk * nlo, self.neo), dtype=u.dtype,
                            device=u.device)
        basis[:, self.imp_idx, :nimp] = torch.eye(nimp, dtype=u.dtype,
                                                  device=u.device)
        basis[:, self.env_idx, nimp:] = u
        return basis

    def embedding(self, basis):
        """BARE Fock in the embedding basis (the vcor enters only through
        p * dV during the fit) and dV/dparam in the embedding basis."""
        bR = basis.reshape(self.spin, self.nk, self.nlo, self.neo)
        # b(k) = sum_R e^{-ikR} b_R
        b_re = torch.einsum("kR, sRpj -> skpj", self.cosT_i, bR)
        b_im = -torch.einsum("kR, sRpj -> skpj", self.sinT_i, bR)
        hb_re = self.f_re_i @ b_re - self.f_im_i @ b_im
        hb_im = self.f_re_i @ b_im + self.f_im_i @ b_re
        embH1 = (torch.einsum("k, skpi, skpj -> sij", self.wk, b_re, hb_re)
                 + torch.einsum("k, skpi, skpj -> sij", self.wk, b_im, hb_im)
                 ) / self.nk
        # two-step dV contraction: (dv . bR) then (bR^T .)
        dvb = torch.einsum("Pspq, sRqj -> PsRpj", self.dv, bR)
        dV_emb = torch.einsum("sRpi, PsRpj -> Psij", bR, dvb)
        return embH1, dV_emb

    def fit(self, vparam, embH1, dV_emb, rho_target):
        if self.engine == "lm":
            return _lm_engine_ft(vparam, embH1, dV_emb, rho_target,
                                 self.nelec2_emb, self.beta,
                                 self.fit_max_iter, self.ytol, self.gtol)

        def err_plain(p):
            Heff = embH1 + torch.einsum("P, Psij -> sij", p, dV_emb)
            errs = 0.0
            for s in range(self.spin):
                r1, _ = rho_fermi_real(Heff[s], self.nelec2_emb, self.beta)
                errs = errs + torch.sum((r1 - rho_target[s]) ** 2)
            return torch.sqrt(errs / self.spin)

        def fg(p):
            with torch.enable_grad():
                p = p.detach().requires_grad_(True)
                f = err_plain(p)
                g, = torch.autograd.grad(f, p)
            return f.detach(), g

        return _cg_engine(fg, vparam, self.fit_max_iter, self.ytol,
                          self.gtol)

    def eri(self, basis):
        """Embedding ERI from the DF factors: L_emb = B^T L_x B, s4 pack,
        syrk; unpacked to (neo, neo, neo, neo)."""
        Bf = basis[0]                                  # (nsites, neo)
        LB = self.chol_L @ Bf                          # (naux, nsites, neo)
        L_emb = Bf.T @ LB                              # (naux, neo, neo)
        return unpack_s4(syrk_df(pack_tril(L_emb)), self.neo)

    def forward(self, vparam, rho_target):
        r_re, r_im, _ = self.mean_field(vparam)
        # rho_R stripe fold over the weighted IBZ (exact under TR symmetry)
        rho_R = (torch.einsum("kR, skpq -> sRpq", self.cos_i, r_re)
                 - torch.einsum("kR, skpq -> sRpq", self.sin_i, r_im)) \
            / self.nk
        basis = self.bath(rho_R)
        embH1, dV_emb = self.embedding(basis)
        p_new, err_end, _ = self.fit(vparam, embH1, dV_emb, rho_target)
        if self.chol_L is None:
            return p_new, err_end, embH1, rho_R, basis
        return p_new, err_end, embH1, rho_R, basis, self.eri(basis)


def make_dmet_iteration(lattice, vcor, filling, beta=1000.0,
                        fit_max_iter=20, ytol=1e-7, gtol=1e-3,
                        chol_L=None, *, engine="lm",
                        device=torch.device("cuda")):
    """Build the fused lattice iteration for `lattice` + `vcor` on `device`.

    Returns (step, params0): step is a DmetIteration module,

      step(vparam, rho_target) ->
          (vparam_new, fit_err, embH1, rho_R, basis[, eri_emb])

    and params0 the vcor parameters as a float64 tensor on `device`.

    chol_L: optional (naux, nsites, nsites) Cholesky/DF factors of the
    supercell ERI (numpy array or tensor), moved to `device` once here.
    engine: "lm" (Levenberg-Marquardt) or "cg" (Polak-Ribiere CG)."""
    step = DmetIteration(lattice, vcor, filling, beta, fit_max_iter, ytol,
                         gtol, chol_L, engine, device)
    params0 = torch.as_tensor(np.asarray(vcor.param, dtype=float),
                              dtype=torch.float64, device=device)
    return step, params0


@keyword_aliases(step="step_fn")
def chain_iterations(step_fn, n_chain):
    """Chain n_chain iterations of step_fn (make_dmet_iteration's step; the
    keyword step= is taken too) with a data dependency (the fitted vcor
    feeds the next iteration).  Returns (vparam0, rho_target) ->
    (vparam_final, last_err)."""

    def chained(vparam, rho_target):
        p, err = vparam, None
        for _ in range(n_chain):
            out = step_fn(p, rho_target)
            p, err = out[0], out[1]
        return p, err

    return chained
