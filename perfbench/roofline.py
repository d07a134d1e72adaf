"""
Peaks of the card and the work of the kernels the per-layer rooflines
read.  Peaks: NVIDIA H100 SXM5 data sheet, dense rates at the 700 W
limit: FP64 on the tensor cores 67 TFLOP/s, HBM3 3.35 TB/s.
"""

from math import comb

PEAK_FP64_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12


def nlink(norb, nelec):
    """Non-zero single excitations E_pq |I> of one string, the diagonal
    E_pp included."""
    return nelec * (norb - nelec) + nelec


def sigma_work(norb, nelec_a, nelec_b):
    """(FLOPs, bytes) of one FCI sigma build H c by the Knowles-Handy
    resolution over determinants (na x nb):
        D^s[pq, I] = (E^s_pq c)[I],   G = h2e . D,   sigma = sum E^s_pq G[pq],
    with spin-dependent integrals (aa, ab, bb).  FLOPs: a multiply-add of
    a column of the (nn x nn) integral matrix for every non-zero entry of
    D^a and D^b, twice each (D^a meets the aa and the ab block, D^b the
    bb and the ab block); entries that are zero by the excitation
    structure are not counted, so any implementation of this resolution
    does at least this work.  Bytes: c read and sigma written once, the
    three integral blocks read once (float64)."""
    nn = norb * norb
    ndet = comb(norb, nelec_a) * comb(norb, nelec_b)
    nnz = ndet * (nlink(norb, nelec_a) + nlink(norb, nelec_b))
    flops = 2 * 2 * nn * nnz
    nbytes = 8 * (2 * ndet + 3 * nn * nn)
    return flops, nbytes


def bound_s(flops, nbytes):
    """Least seconds the card could take for the work."""
    return max(flops / PEAK_FP64_FLOPS, nbytes / PEAK_HBM_BYTES)
