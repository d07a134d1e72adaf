"""
CI -> CC amplitude extraction (PyTorch port of
libdmet_preview_tpu/solvers/ci_to_cc.py): read T1/T2 cluster amplitudes
out of an FCI wave function, the tailored-CC ingredient.

Host NumPy over the determinant strings and link tables of the port's
solvers/fci.py (pyscf cistring order, the same sign convention).  The CI
vector is an (na, nb) array or tensor, possibly on the card; it is read to
the host once.  Output is in the spin-orbital layout of solvers/cc.py
([occ_a, occ_b, vir_a, vir_b]).
"""

import numpy as np

from libdmet_preview_tpu_torch.solvers.fci import make_strings, make_link_table
from libdmet_preview_tpu_torch.utils.misc import to_host


def _apply_E(tab, addr, I, a, i, norb):
    """E_{a i} |I> = sign |J> via the link table row of I; returns
    (J, sign) or None if the excitation annihilates the string."""
    for (pq, J, sign) in tab[addr[I]]:
        if pq == a * norb + i:
            return J, sign
    return None


def ci_amplitudes(ci, norb, nelec):
    """Extract c0, single and double excitation CI coefficients.

    ci: (na_str, nb_str) FCI vector (pyscf string order), array or tensor;
    nelec = (na, nb).  Returns (c0, c1a, c1b, c2aa, c2bb, c2ab) with
      c1s[i, a]        = <ref(i->a)|Psi> * sign
      c2ss[i, j, a, b] = <ref(i->a, j->b)|Psi> * sign   (same spin)
      c2ab[i, j, a, b] = alpha i->a with beta j->b
    occupied = 0..ne-1, virtual = ne..norb-1 within each spin."""
    ci = to_host(ci)
    na, nb = nelec
    sa = make_strings(norb, na)
    sb = make_strings(norb, nb)
    addr_a = {int(s): k for k, s in enumerate(sa)}
    addr_b = {int(s): k for k, s in enumerate(sb)}
    tab_a = make_link_table(norb, na)
    tab_b = make_link_table(norb, nb)
    ref_a = (1 << na) - 1
    ref_b = (1 << nb) - 1
    ia, ib = addr_a[ref_a], addr_b[ref_b]
    c0 = float(ci[ia, ib])
    nva, nvb = norb - na, norb - nb

    # singles: E_ai |ref>
    c1a = np.zeros((na, nva))
    exc_a = {}   # (i, a) -> (J, sign)
    for i in range(na):
        for a_ in range(na, norb):
            r = _apply_E(tab_a, addr_a, ref_a, a_, i, norb)
            if r is None:
                continue
            J, sgn = r
            exc_a[(i, a_)] = (J, sgn)
            c1a[i, a_ - na] = sgn * ci[J, ib]
    c1b = np.zeros((nb, nvb))
    exc_b = {}
    for i in range(nb):
        for a_ in range(nb, norb):
            r = _apply_E(tab_b, addr_b, ref_b, a_, i, norb)
            if r is None:
                continue
            J, sgn = r
            exc_b[(i, a_)] = (J, sgn)
            c1b[i, a_ - nb] = sgn * ci[ia, J]

    # same-spin doubles: E_ai E_bj |ref>  (i != j, a != b)
    def doubles_same(tab, addr, strings, ref, ne, ci_vec):
        nv = norb - ne
        c2 = np.zeros((ne, ne, nv, nv))
        for j in range(ne):
            for b_ in range(ne, norb):
                r1 = _apply_E(tab, addr, ref, b_, j, norb)
                if r1 is None:
                    continue
                J1, s1 = r1
                str_J1 = int(strings[J1])
                for i in range(ne):
                    for a_ in range(ne, norb):
                        if i == j or a_ == b_:
                            continue
                        r2 = _apply_E(tab, addr, str_J1, a_, i, norb)
                        if r2 is None:
                            continue
                        J2, s2 = r2
                        c2[i, j, a_ - ne, b_ - ne] = s1 * s2 * ci_vec[J2]
        return c2

    c2aa = doubles_same(tab_a, addr_a, sa, ref_a, na, ci[:, ib])
    c2bb = doubles_same(tab_b, addr_b, sb, ref_b, nb, ci[ia, :])

    # mixed doubles: alpha single x beta single
    c2ab = np.zeros((na, nb, nva, nvb))
    for (i, a_), (Ja, sa_) in exc_a.items():
        for (j, b_), (Jb, sb_) in exc_b.items():
            c2ab[i, j, a_ - na, b_ - nb] = sa_ * sb_ * ci[Ja, Jb]
    return c0, c1a, c1b, c2aa, c2bb, c2ab


def ci_to_cc_so(ci, norb, nelec):
    """FCI vector -> spin-orbital (t1, t2) cluster amplitudes in the
    cc.py layout [occ_a, occ_b, vir_a, vir_b] over 2*norb spin orbitals
    (host arrays).

    t1 = c1/c0;  t2 = c2/c0 - (t1 t1 - t1 t1) (antisymmetrized)."""
    na, nb = nelec
    c0, c1a, c1b, c2aa, c2bb, c2ab = ci_amplitudes(ci, norb, nelec)
    assert abs(c0) > 1e-8, "vanishing reference weight: not CC-taylorable"
    t1a = c1a / c0
    t1b = c1b / c0
    nva, nvb = norb - na, norb - nb
    nocc, nvir = na + nb, nva + nvb
    t1 = np.zeros((nocc, nvir))
    t1[:na, :nva] = t1a
    t1[na:, nva:] = t1b

    t2 = np.zeros((nocc, nocc, nvir, nvir))
    # same spin: t2 = c2/c0 - (t1_ia t1_jb - t1_ib t1_ja)
    T2aa = c2aa / c0 - (np.einsum("ia, jb -> ijab", t1a, t1a)
                        - np.einsum("ib, ja -> ijab", t1a, t1a))
    T2bb = c2bb / c0 - (np.einsum("ia, jb -> ijab", t1b, t1b)
                        - np.einsum("ib, ja -> ijab", t1b, t1b))
    T2ab = c2ab / c0 - np.einsum("ia, jb -> ijab", t1a, t1b)
    t2[:na, :na, :nva, :nva] = T2aa
    t2[na:, na:, nva:, nva:] = T2bb
    t2[:na, na:, :nva, nva:] = T2ab
    # antisymmetry partners of the mixed block
    t2[na:, :na, nva:, :nva] = T2ab.transpose(1, 0, 3, 2)
    t2[:na, na:, nva:, :nva] = -T2ab.transpose(0, 1, 3, 2)
    t2[na:, :na, :nva, nva:] = -T2ab.transpose(1, 0, 2, 3)
    return t1, t2
