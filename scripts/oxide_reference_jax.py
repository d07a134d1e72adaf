#!/usr/bin/env python3
"""
The JAX package's AFM-oxide values that the PyTorch port is held to
(libdmet_preview_tpu_torch/workloads.py: OXIDE_JAX).

    JAX_PLATFORMS=cpu python scripts/oxide_reference_jax.py [--kind K]
        [--nk N] [--precision P] [--port] [--ints FILE]

It builds NiO AFM, NiO FM and the CuO2 plane with the JAX package's
factories (make_nio_afm_lattice, make_nio_fm_lattice,
make_cuo2_afm_lattice) at workloads.OXIDE_TIER1 (one cell at precision
1e-4) unless told otherwise, and runs the protocol of
tests/test_nio_afm.py:35-149 and tests/test_cuo2_afm.py:27-72
(workloads.oxide_one_shot): per cell the supercell UHF, the staggered d
moments, the lattice mean field, the embedding's electron count and S_z,
the interacting-bath HF energy and, for NiO AFM, the MP2 one-shot; and
the fingerprints of the cell integrals in its cache file
(workloads.oxide_fingerprint).  NiO FM
reads the integrals NiO AFM wrote to a temporary cache directory, as the
JAX suite's tests share theirs.  The JAX package's short-range ERI rows
run on one thread: the three one-cell cases take several minutes.

It prints the OXIDE_JAX entries to paste into workloads.py; with --port it
also runs the port's factory (its own integrals) and protocol on the CPU
and prints the differences.  With --ints FILE (the port's integrals as
scripts/oxide_ints_card.py writes them on the card, at the --nk and
--precision they were built at) the JAX factories load those integrals
from their cache instead of building their own, and run the supercell UHF,
the lattice tail and the protocol on them: the OXIDE_JAX_NK2 witness
entries, with the port's E_hf and moments from FILE beside them (and
with --port, the port's protocol on the CPU on the same integrals).  This is a developer tool: it imports
libdmet_preview_tpu (the port never does).
"""

import argparse
import os
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from libdmet_preview_tpu_torch import workloads as wl  # noqa: E402

KEYS = ("E_hf", "mag", "nelec_ab", "E_mf", "nelec_emb", "sz_emb", "neo",
        "E_ibhf", "E_mp2")


def one_shot(Lat, meta, kind):
    """workloads.oxide_one_shot in the JAX package."""
    import libdmet_preview_tpu.dmet.hubbard as dmet
    from libdmet_preview_tpu.ops import embham
    from libdmet_preview_tpu.ops.vcor import VcorLocal
    from libdmet_preview_tpu.solvers import MP2, SCFSolver
    nsc = Lat.nscsites
    nk = Lat.ncells
    na, nb = meta.get("nelec_ab", (None, None))
    if kind == "nio_fm":
        filling = (na / (nk * nsc), nb / (nk * nsc))
    else:
        filling = meta["cell"].nelectron / (2 * nk * nsc)
    vcor = VcorLocal(False, False, nsc)
    vcor.assign(np.zeros((2, nsc, nsc)))
    rho, _, res = dmet.HartreeFock(Lat, vcor, filling, None, ires=True)
    # one cell has no bath, and the JAX package's bath matching raises on
    # an empty bath (the port's returns it as it is): match only when
    # there is a bath
    ImpHam, H1e, basis = dmet.ConstructImpHam(Lat, rho, vcor,
                                              matching=Lat.ncells > 1,
                                              int_bath=True)
    rho_mf = np.asarray(embham.foldRho_k(Lat.rdm1_lo_k,
                                         Lat.R2k_basis(basis)))
    nel = int(round(np.trace(rho_mf[0]) + np.trace(rho_mf[1])))
    sz = int(round(np.trace(rho_mf[0]) - np.trace(rho_mf[1])))
    out = {"E_hf": float(meta["E_hf"]) / nk,
           "mag": [float(m) for m in meta["mag_d"]],
           "E_mf": float(res["E"]), "nelec_emb": nel, "sz_emb": sz,
           "neo": int(np.shape(basis)[-1])}
    if na is not None:
        out["nelec_ab"] = [int(na), int(nb)]
    hf = SCFSolver(restricted=False, Sz=sz)
    rhoEmb, EEmb = hf.run(ImpHam, nelec=nel, dm0=rho_mf, MaxIter=500)
    _, E, _ = dmet.transformResults(rhoEmb, EEmb, basis, ImpHam, H1e,
                                    lattice=Lat, last_dmu=0.0, int_bath=True,
                                    solver=hf, solver_args={"nelec": nel})
    out["E_ibhf"] = float(E) * nsc
    if kind == "nio_afm":
        mp = MP2(restricted=False, Sz=sz)
        rhoMP, EMP = mp.run(ImpHam, nelec=nel, dm0=rho_mf)
        _, E, _ = dmet.transformResults(rhoMP, EMP, basis, ImpHam, H1e,
                                        lattice=Lat, last_dmu=0.0,
                                        int_bath=True, solver=mp,
                                        solver_args={"nelec": nel})
        out["E_mp2"] = float(E) * nsc
    return out


def unpack_s8(s8, n):
    """The (n, n, n, n) ERI of its 8-fold packing (oxide_ints_card.py)."""
    i, j = np.tril_indices(n)
    npair = len(i)
    s4 = np.zeros((npair, npair))
    s4[np.tril_indices(npair)] = s8
    s4 = s4 + s4.T - np.diag(np.diag(s4))
    half = np.zeros((n, n, npair))
    half[i, j] = s4
    half[j, i] = s4
    eri = np.zeros((n, n, n, n))
    eri[:, :, i, j] = half
    eri[:, :, j, i] = half
    return eri


def seed_cache(cache, ints, kinds, nk, precision):
    """Write FILE's integrals under each kind's cache key in JAX's layout;
    returns the port's values FILE carries."""
    dat = np.load(ints)
    eri = unpack_s8(dat["eri_s8"], dat["S"].shape[0])
    for kind in kinds:
        np.savez(os.path.join(cache, wl.oxide_cache_name(kind, nk,
                                                         precision)),
                 S=dat["S"], hcore=dat["hcore"], eri=eri,
                 e_nuc=dat["e_nuc"])
    return {"E_hf": float(dat["E_hf"]) / nk,
            "mag": [float(m) for m in dat["mag_d"]]}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--kind", choices=sorted(wl.OXIDE_FACTORIES),
                    action="append")
    ap.add_argument("--nk", type=int, default=wl.OXIDE_TIER1["nk"])
    ap.add_argument("--precision", type=float,
                    default=wl.OXIDE_TIER1["precision"])
    ap.add_argument("--port", action="store_true")
    ap.add_argument("--ints")
    args = ap.parse_args()
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from libdmet_preview_tpu.models import abinitio
    kw = {"nk": args.nk, "precision": args.precision}
    cache = tempfile.mkdtemp(prefix="oxide_ref_")
    os.makedirs(cache + "_port")
    kinds = args.kind or ["nio_afm", "nio_fm", "cuo2_afm"]
    if args.ints:
        port = seed_cache(cache, args.ints, kinds, args.nk, args.precision)
        if args.port:
            seed_cache(cache + "_port", args.ints, kinds, args.nk,
                       args.precision)
        print("# the port's integrals from %s; its values there: %r"
              % (args.ints, port))
    for kind in kinds:
        t0 = time.time()
        Lat, meta = getattr(abinitio, wl.OXIDE_FACTORIES[kind])(
            cache_file=cache, **kw)
        t1 = time.time()
        name = wl.oxide_cache_name(kind, args.nk, args.precision)
        out = {"ints": wl.oxide_fingerprint(os.path.join(cache, name))}
        out.update(one_shot(Lat, meta, kind))
        print("# %s %r: build %.1f s, protocol %.1f s" % (
            kind, kw, t1 - t0, time.time() - t1))
        print("    %r: %r," % (kind, out), flush=True)
        if args.port:
            import torch
            cpu = torch.device("cpu")
            # the port's own integrals (its own cache, for NiO FM)
            Lat_t, meta_t = wl.oxide_lattice(kind, cpu,
                                             cache_file=cache + "_port", **kw)
            port = wl.oxide_one_shot(Lat_t, meta_t, kind, cpu)
            diff = {k: np.max(np.abs(np.asarray(port[k], float)
                                     - np.asarray(out[k], float)))
                    for k in KEYS if k in out}
            pf = wl.oxide_fingerprint(os.path.join(cache + "_port", name))
            diff["ints"] = max(
                abs(a - b) / max(abs(b), 1e-300)
                for k in ("S", "hcore", "eri")
                for a, b in zip(pf[k], out["ints"][k]))
            print("# port - JAX %s: %r" % (kind, diff), flush=True)


if __name__ == "__main__":
    main()
