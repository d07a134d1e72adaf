"""
The PyTorch port's static GW self-energy (get_vsig_emb of
libdmet_preview_tpu_torch/solvers/gw.py, with the device path of
ops/eri_transform.cholesky_eri) and its host bridges (solvers/dmrg.py,
external.py, qmc.py) against the JAX package's, with the fake Block binary
of tests/test_dmrg_bridge.py and fake SHCI / AFQMC / DQMC binaries that
run the port's FCI behind the bridges' file formats (no JAX in their
processes).  On the CPU.

Tolerances: GW 1e-10; the files a bridge writes byte for byte equal to
the JAX package's; energies and RDMs read back against the port's FCI at
the JAX suite's own tolerances.
"""

import os
import stat
import sys

import numpy as np
import pytest
import torch

import jax

from test_cc import hubbard_integral
from test_dmrg_bridge import FAKE
from test_torch_casci import gso_ring, port_integral

from libdmet_preview_tpu_torch import workloads as wl

jax.config.update("jax_enable_x64", True)

torch.set_num_threads(1)

CPU = torch.device("cpu")
GW_TOL = 1e-10


# ----------------------------------------------------------------------
# static GW
# ----------------------------------------------------------------------

def _h2_rhf():
    """H2 / sto-6g from the JAX engine and its converged RHF (arrays)."""
    from libdmet_preview_tpu.ints.gto import Mole
    from libdmet_preview_tpu.solvers.ksdft import RKS
    mol = Mole([("H", (0, 0, 0)), ("H", (0, 0, 1.4))], basis="sto-6g")
    hf = RKS(mol, xc=None, hyb=1.0)
    hf.kernel()
    vj, vk = hf._jk(hf.dm)
    return (np.asarray(mol.intor_hcore()), np.asarray(mol.intor_ovlp()),
            np.asarray(mol.intor_eri()), np.asarray(vj), np.asarray(vk),
            np.asarray(hf.fock), mol.nelectron)


@pytest.mark.parametrize("screened", [False, True])
def test_vsig_restricted_matches_jax(screened):
    """H2 / sto-6g: the port against the JAX package (1e-10); the bare
    limit is -K / 2 of the converged RHF (1e-9, the JAX suite's)."""
    from libdmet_preview_tpu.solvers.gw import get_vsig_emb as jvsig
    from libdmet_preview_tpu_torch.solvers import get_vsig_emb
    h, S, eri, vj, vk, fock, nel = _h2_rhf()
    if not screened:
        fock = h + vj - 0.5 * vk
    vj_ = jvsig(fock, eri, nel, ovlp=S, screened=screened)
    vt = get_vsig_emb(fock, eri, nel, ovlp=S, screened=screened, device=CPU)
    assert isinstance(vt, torch.Tensor) and tuple(vt.shape) == (1, 2, 2)
    assert np.abs(vt.numpy() - vj_).max() < GW_TOL
    if not screened:
        assert np.abs(vt.numpy()[0] + 0.5 * vk).max() < 1e-9
    else:
        assert torch.max(torch.abs(vt - vt.transpose(1, 2))) < 1e-12


@pytest.mark.parametrize("screened", [False, True])
def test_vsig_unrestricted_matches_jax(screened):
    from libdmet_preview_tpu.solvers.gw import get_vsig_emb as jvsig
    from libdmet_preview_tpu_torch.solvers import get_vsig_emb
    focks, eri = wl.random_uhf_fock()
    vj_ = jvsig(focks, eri, (2, 1), screened=screened)
    vt = get_vsig_emb(torch.as_tensor(focks), torch.as_tensor(eri), (2, 1),
                      screened=screened, device=CPU)
    assert np.abs(vt.numpy() - vj_).max() < GW_TOL
    if not screened:
        for s, no in enumerate((2, 1)):
            e, c = np.linalg.eigh(focks[s])
            K = np.einsum("prqs, rs -> pq", eri, c[:, :no] @ c[:, :no].T)
            assert np.abs(vt.numpy()[s] + K).max() < 1e-8


def test_cholesky_eri_of_a_tensor_matches_jax():
    """cholesky_eri of a tensor returns a tensor on its device with the
    JAX package's pivots: the same rank and factors (exact), and the
    factors rebuild the ERI (1e-9, the decomposition's tolerance)."""
    from libdmet_preview_tpu.ops.eri_transform import cholesky_eri as jchol
    from libdmet_preview_tpu_torch.ops.eri_transform import cholesky_eri
    _, eri = wl.random_uhf_fock()
    Lj = jchol(eri, tol=1e-10)
    Lt = cholesky_eri(torch.as_tensor(eri), tol=1e-10)
    assert isinstance(Lt, torch.Tensor) and Lt.device == CPU
    np.testing.assert_array_equal(Lt.numpy(), Lj)
    assert torch.max(torch.abs(torch.einsum("xpq, xrs -> pqrs", Lt, Lt)
                               - torch.as_tensor(eri))) < 1e-9


# ----------------------------------------------------------------------
# DMRG bridge
# ----------------------------------------------------------------------

def _fake_block(tmp_path):
    exe = tmp_path / "fake_block2"
    exe.write_text(FAKE % {"repo": os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))})
    exe.chmod(exe.stat().st_mode | stat.S_IEXEC)
    return [sys.executable, str(exe), "{conf}"]


def _small_ham(seed=0, diag=None, U=2.0, H0=0.3):
    from libdmet_preview_tpu.models.integral import Integral
    rng = np.random.RandomState(seed)
    n = 4
    h1 = rng.randn(n, n) * (0.5 if diag is None else 0.4)
    h1 = h1 + h1.T
    if diag is not None:
        h1 = h1 + np.diag(diag)
    eri = np.zeros((n,) * 4)
    np.fill_diagonal(eri, U)
    return Integral(n, True, False, H0, {"cd": h1[None]}, {"ccdd": eri[None]})


def test_block_bridge_files_and_results(tmp_path):
    """The port's BlockDMRG with the fake Block binary: dmrg.conf and
    FCIDUMP byte for byte the JAX bridge's, E and rdm1 against the port's
    FCI (1e-8 / 1e-7, the JAX suite's), the rdm1 a tensor on the device;
    the schedules' text equal to the JAX package's."""
    from libdmet_preview_tpu.solvers.dmrg import (BlockDMRG as JBlock,
                                                  Schedule as JSchedule)
    from libdmet_preview_tpu_torch.solvers import BlockDMRG, FCI, Schedule
    Ham = _small_ham()
    Ht = port_integral(Ham)
    exe = _fake_block(tmp_path)
    wd_t = tmp_path / "wd"
    solver = BlockDMRG(exe, max_M=600, workdir=str(wd_t), twopdm=False,
                       device=CPU)
    solver.schedule = Schedule(sweep_tol=1e-7).gen_initial(100, 600)
    rdm1, E = solver.run(Ht, nelec=4)
    assert isinstance(rdm1, torch.Tensor)
    rdm1_ref, E_ref = FCI(restricted=True, tol=1e-11, device=CPU).run(
        Ht, nelec=4)
    assert abs(E - E_ref) < 1e-8
    assert torch.max(torch.abs(rdm1[0] - rdm1_ref[0])) < 1e-7
    # the JAX bridge writes the same files for the same Hamiltonian
    wd_j = tmp_path / "wd_jax"
    os.makedirs(wd_j)
    js = JBlock(exe, max_M=600, workdir=str(wd_j), twopdm=False)
    js.schedule = JSchedule(sweep_tol=1e-7).gen_initial(100, 600)
    from libdmet_preview_tpu.models.integral import dump_FCIDUMP as jdump
    jdump(str(wd_j / "FCIDUMP"), Ham, nelec=4, spin_sz=0)
    js.write_conf(str(wd_j / "dmrg.conf"), str(wd_t / "FCIDUMP"), 4,
                  Ham.norb, prefix=str(wd_t))
    solver.optimized = False
    solver.write_conf(str(wd_t / "dmrg.conf.again"), str(wd_t / "FCIDUMP"),
                      4, Ham.norb, prefix=str(wd_t))
    assert (wd_t / "FCIDUMP").read_bytes() == (wd_j / "FCIDUMP").read_bytes()
    assert (wd_t / "dmrg.conf.again").read_bytes() \
        == (wd_j / "dmrg.conf").read_bytes()
    for gen in (lambda S: S(max_iter=30, sweep_tol=1e-6).gen_initial(250,
                                                                      1500),
                lambda S: S(sweep_tol=1e-7).gen_restart(600),
                lambda S: S().gen_extrapolate(2000)):
        assert gen(Schedule).get_schedule() == gen(JSchedule).get_schedule()


def test_pdm_readers_match_jax(tmp_path):
    from libdmet_preview_tpu.solvers import dmrg as jd
    from libdmet_preview_tpu_torch.solvers import dmrg as td
    rng = np.random.RandomState(1)
    norb = 3
    p1 = tmp_path / "onepdm.bin"
    p1.write_bytes(b"junkhdr" + rng.randn(2 * norb, 2 * norb).tobytes())
    p2 = tmp_path / "twopdm.bin"
    p2.write_bytes(rng.randn(*(2 * norb,) * 4).tobytes())
    assert np.array_equal(td.read1pdm_bin(str(p1), norb),
                          jd.read1pdm_bin(str(p1), norb))
    assert np.array_equal(td.read2pdm_bin(str(p2), norb),
                          jd.read2pdm_bin(str(p2), norb))


def test_dmrgci_and_dmrgscf_compositions(tmp_path):
    """CASCI(2, 2) with the Block bridge == with the port's FCI (1e-7);
    GCASCI and GCASSCF (two-pdm) with the bridge == with FCI(ghf) (1e-7 /
    1e-6), the JAX suite's tests/test_dmrg_bridge.py compositions."""
    from libdmet_preview_tpu_torch.solvers import (BlockDMRG, CASCI, GCASCI,
                                                   GCASSCF, Schedule)
    exe = _fake_block(tmp_path)
    Ht = port_integral(_small_ham(seed=3, diag=[-2.0, -1.0, 0.5, 1.0],
                                  U=1.5, H0=0.1))
    dmrg = BlockDMRG(exe, max_M=600, workdir=str(tmp_path / "wd"),
                     twopdm=False, device=CPU)
    dmrg.schedule = Schedule(sweep_tol=1e-7).gen_initial(100, 600)
    r_d, E_d = CASCI(ncas=2, nelecas=2, fcisolver=dmrg, device=CPU).run(
        Ht, nelec=4)
    r_f, E_f = CASCI(ncas=2, nelecas=2, device=CPU).run(Ht, nelec=4)
    assert abs(E_d - E_f) < 1e-7
    assert torch.max(torch.abs(r_d - r_f)) < 1e-6

    GHt = port_integral(gso_ring(3, 2.0))
    nao, nso = 3, 6
    for ncas, cls, kw, twopdm, tol in (
            (nso - 1, GCASCI, {}, False, 1e-7),
            (nso - 2, GCASSCF, {"tol": 1e-6, "max_cycle": 8}, True, 1e-6)):
        dm = BlockDMRG(exe, max_M=400, workdir=str(tmp_path / cls.__name__),
                       restricted=False, Sz=nao - 1, spin_adapted=False,
                       twopdm=twopdm, device=CPU)
        dm.schedule = Schedule(sweep_tol=1e-8).gen_initial(100, 400)
        sd = cls(ncas=ncas, nelecas=nao - 1, fcisolver=dm, device=CPU, **kw)
        rdm_d, E_d = sd.run(GHt, nelec=nao)
        sf = cls(ncas=ncas, nelecas=nao - 1, device=CPU,
                 **(kw or {"tol": 1e-12}))
        rdm_f, E_f = sf.run(GHt, nelec=nao)
        assert abs(E_d - E_f) < tol
        assert torch.max(torch.abs(rdm_d - rdm_f)) < 10 * tol
        assert abs(float(torch.trace(rdm_d[0])) - nao) < 1e-7


# ----------------------------------------------------------------------
# FCIDUMP bridge and the QMC bridges
# ----------------------------------------------------------------------

def test_external_bridge_roundtrip(tmp_path):
    """tests/test_solvers_extra.py's stub solver through the port's bridge
    and the JAX package's: the same FCIDUMP bytes, E, and the rdm1 read
    back as a tensor."""
    from libdmet_preview_tpu.solvers.external import (
        ExternalFCIDUMPSolver as JExt)
    from libdmet_preview_tpu_torch.solvers import ExternalFCIDUMPSolver
    script = tmp_path / "fake_solver.py"
    script.write_text(
        "import sys, numpy as np\n"
        "assert open(sys.argv[1]).readline().startswith(' &FCI')\n"
        "np.savetxt(sys.argv[2] + '/rdm1.txt', np.eye(4) * 0.5)\n"
        "print('converged E = -2.718281828')\n")
    Ham = hubbard_integral(4, U=1.0, restricted=True)
    argv = [sys.executable, str(script), "{fcidump}", "{workdir}"]
    out = {}
    for name, cls, H, kw in (("port", ExternalFCIDUMPSolver,
                              port_integral(Ham), {"device": CPU}),
                             ("jax", JExt, Ham, {})):
        solver = cls(argv, rdm1_file="rdm1.txt",
                     workdir=str(tmp_path / name), **kw)
        out[name] = solver.run(H, nelec=4)
    rdm1, E = out["port"]
    assert abs(E - (-2.718281828)) < 1e-12 and E == out["jax"][1]
    assert isinstance(rdm1, torch.Tensor) and tuple(rdm1.shape) == (1, 4, 4)
    assert np.array_equal(rdm1.numpy(), out["jax"][0])
    assert (tmp_path / "port" / "FCIDUMP").read_bytes() \
        == (tmp_path / "jax" / "FCIDUMP").read_bytes()


def test_afqmc_dqmc_dumps_match_jax(tmp_path):
    """The sparse AFQMC text dump byte for byte; the DQMC Cholesky HDF5's
    arrays (1e-12) and rank equal to the JAX package's."""
    from libdmet_preview_tpu.solvers import external as je
    from libdmet_preview_tpu_torch.solvers import external as te
    Ham = hubbard_integral(4, U=4.0, restricted=True)
    Ht = port_integral(Ham)
    U_t = te.dump_afqmc_ham(str(tmp_path / "t.txt"), Ht)
    U_j = je.dump_afqmc_ham(str(tmp_path / "j.txt"), Ham)
    assert np.array_equal(U_t, U_j)
    assert (tmp_path / "t.txt").read_bytes() == (tmp_path / "j.txt").read_bytes()
    r_t = te.dump_dqmc_cholesky(str(tmp_path / "t.h5"), Ht, tol=1e-12)
    r_j = je.dump_dqmc_cholesky(str(tmp_path / "j.h5"), Ham, tol=1e-12)
    assert r_t == r_j
    for a, b in zip(te.read_dqmc_cholesky(str(tmp_path / "t.h5")),
                    je.read_dqmc_cholesky(str(tmp_path / "j.h5"))):
        assert np.abs(np.asarray(a) - np.asarray(b)).max() < 1e-12


def test_shci_bridge_matches_jax_and_fci(tmp_path):
    """SHCI through the fake binary: config.json and FCIDUMP byte for byte
    the JAX bridge's; E against the port's FCI (1e-9) and the energy of
    the RDMs read back (1e-8), tensors on the device."""
    from libdmet_preview_tpu.solvers.qmc import SHCI as JSHCI
    from libdmet_preview_tpu_torch.solvers import FCI
    from libdmet_preview_tpu_torch.solvers.qmc import SHCI
    exe = wl.write_fake(str(tmp_path), "shci", wl.SHCI_FAKE)
    Ham = hubbard_integral(4, U=4.0, restricted=True)
    Ht = port_integral(Ham)
    solver = SHCI(executable=exe, workdir=str(tmp_path / "wd"),
                  restricted=True, device=CPU)
    rdm1, E = solver.run(Ht, nelec=4, calc_rdm2=True)
    JSHCI(executable=exe, workdir=str(tmp_path / "wdj"),
          restricted=True).run(Ham, nelec=4, calc_rdm2=True)
    for f in ("config.json", "FCIDUMP"):
        assert (tmp_path / "wd" / f).read_bytes() \
            == (tmp_path / "wdj" / f).read_bytes()
    fci = FCI(restricted=True, tol=1e-12, device=CPU)
    _, E_fci = fci.run(Ht, nelec=4)
    assert abs(E - E_fci) < 1e-9
    assert isinstance(rdm1, torch.Tensor)
    assert abs(float(torch.trace(rdm1[0])) * 2 - 4) < 1e-8
    h1 = torch.as_tensor(np.asarray(Ham.H1["cd"][0]))
    g = torch.as_tensor(np.asarray(Ham.H2["ccdd"][0]))
    E_rdm = (2.0 * torch.sum(h1 * rdm1[0]) + 0.5 * torch.sum(
        g * solver.twopdm[0])) + float(Ham.H0)
    assert abs(float(E_rdm) - E_fci) < 1e-8


DQMC_FAKE = r"""
import json, sys
import h5py
import numpy as np
sys.path.insert(0, %(repo)r)
import torch
from libdmet_preview_tpu_torch.models.integral import Integral
from libdmet_preview_tpu_torch.solvers import FCI
conf = json.load(open(sys.argv[-1]))
with h5py.File(conf["integrals"], "r") as f:
    n = int(f["norb"][()])
    L = f["chol"][()].reshape(-1, n, n)
    H1 = np.asarray([f["hcore_a"][()], f["hcore_b"][()]])
    e0 = float(f["e0"][()])
g = np.einsum("xpq, xrs -> pqrs", L, L)
rdm1, E = FCI(restricted=False, tol=1e-12, device=torch.device("cpu")).run(
    Integral(n, False, False, e0, {"cd": H1}, {"ccdd": np.asarray([g, g, g])}),
    nelec=conf["nelec"])
rdm1 = rdm1.numpy()
rng = np.random.default_rng(7)
with open("samples.dat", "w") as f:
    for t in range(2048):
        f.write("%%d %%.12f 1.0\n" %% (t, E + rng.normal(0, 0.01)))
d = 0.01 * np.eye(n)
d[0, 1] = d[1, 0] = 0.004
for s, tag in ((0, "up"), (1, "dn")):
    for rank, (w, sgn) in enumerate(((3.0, 1.0), (1.0, -3.0))):
        with open("rdm_%%s_%%d.dat" %% (tag, rank), "w") as f:
            f.write("%%.6f\n" %% w)
            np.savetxt(f, rdm1[s] + sgn * d)
"""


def test_afqmc_and_dqmc_bridges(tmp_path):
    """AFQMC: the reblocked mean within its error bar of the port's FCI
    and 0.02; DQMC: the weighted per-rank rdm1 equal to FCI's (1e-8) and
    the extrapolation 2 D - D_mf (1e-8); the statistics equal the JAX
    package's on the same series (1e-12)."""
    from libdmet_preview_tpu.solvers import qmc as jq
    from libdmet_preview_tpu_torch.solvers import FCI
    from libdmet_preview_tpu_torch.solvers import qmc as tq
    Ht = port_integral(hubbard_integral(4, U=4.0, restricted=True))
    fci = FCI(restricted=False, tol=1e-12, device=CPU)
    rdm1_fci, E_fci = fci.run(Ht, nelec=4)

    af = tq.AFQMC(executable=wl.write_fake(str(tmp_path), "afqmc",
                                           wl.AFQMC_FAKE),
                  workdir=str(tmp_path / "af"), device=CPU)
    rdm1, E = af.run(Ht, nelec=4)
    assert af.e_err > 0 and abs(E - E_fci) < 6 * af.e_err
    assert abs(E - E_fci) < 0.02
    assert isinstance(rdm1, torch.Tensor) and tuple(rdm1.shape) == (2, 4, 4)
    vals, wts = tq.read_meas_series(str(tmp_path / "af" / "measurements.dat"))
    neql = int(len(vals) * af.therm_frac)
    mj, ej, tj = jq.blocking_analysis(vals, wts, neql=neql)
    assert abs(mj - E) < 1e-12 and abs(ej - af.e_err) < 1e-12

    dq = tq.DQMC(executable=wl.write_fake(str(tmp_path), "DQMC", DQMC_FAKE),
                 workdir=str(tmp_path / "dq"), device=CPU)
    rdm1, E = dq.run(Ht, nelec=4)
    assert abs(E - E_fci) < 0.005
    assert torch.max(torch.abs(rdm1 - rdm1_fci)) < 1e-8
    rdm1_x, _ = dq.run(Ht, nelec=4, rdm1_mf=rdm1_fci, extrap=True)
    assert torch.max(torch.abs(rdm1_x - rdm1_fci)) < 1e-8
