"""salt's sampled suffix array and its locate walks, written plainly.

salt-idx keeps no full suffix array.  Of the genome's (C part) it keeps
the value of every rank k with k % C_sa_intv == 0 (C_sa_intv = 8,
Index_src/index1.c:44; bwt_cal_sa, Align_src/bwt.c:48-66, with its
sa[0] = -1), and of the SNP patterns' text (R part) only the value of
each '#' rank (saValueSharp, Align_src/rbwt.c:298-333).  A locate
(alnse_locate_alt) resolves every candidate rank by a walk:

  * C: bwt_sa (bwt.c:89-102): while k % intv != 0, one inverse-Psi (LF)
    step and one more to add; then that count plus sa[k / intv];
  * R: Rbwt_back_bwt_sa (rbwt.c:316-333): LF steps until a '#' rank;
    the coordinate is that '#''s value plus the steps.

`SaltLocate` builds those structures from an index bundle's cbwt, csa,
c_l2, rbwt, r_cumfreq and sharp_bases (index/build.SaltIndex) and walks
them with occurrence counts taken from plain cumulative counts.  It
imports nothing of the port's device code: the port samples the C part
by text position with a select structure, and stops R walks at every
coordinate that is a multiple of intv too (pipeline/device_index.py,
ops/locate.resolve_sampled), so this is an independent route to the
same values.

Departures from salt, each for the bundle's layout:

  * the BWTs keep their sentinel in band (rank 0 is the sentinel's
    suffix), so LF of the row that holds the sentinel is rank 0, where
    bwt_invPsi tests k == primary;
  * a '#' rank holds the coordinate base of the segment after it
    (sharp_bases: coordinate = base + steps), as the bundle stores it;
  * a rank on a '#', and R rank 0, read UINT32_MAX, as r_coord holds:
    no genome position lies there, and no seed interval reaches them;
  * the walks step all ranks together, each until its own stop; no
    walk is bounded.
"""

from __future__ import annotations

import numpy as np

from ..constants import C_SENTINEL, R_SENTINEL, UINT32_MAX

U32 = np.int64(UINT32_MAX)


def _occ_table(bwt: np.ndarray, n_sym: int) -> np.ndarray:
    """occ[c, k]: occurrences of symbol c in bwt[:k], for k in 0..len."""
    occ = np.zeros((n_sym, len(bwt) + 1), dtype=np.uint32)
    for c in range(n_sym):
        np.cumsum(bwt == c, dtype=np.uint32, out=occ[c, 1:])
    return occ


class _Family:
    """One BWT with its cumulative counts: LF(k) = 1 + cfreq[c] +
    occ[c, k] for c = bwt[k], and 0 where bwt[k] is the sentinel."""

    def __init__(self, bwt: np.ndarray, cfreq: np.ndarray, sentinel: int):
        self.bwt = np.asarray(bwt, dtype=np.uint8)
        self.cfreq = np.asarray(cfreq, dtype=np.int64)[:sentinel]
        self.sentinel = sentinel
        self.occ = _occ_table(self.bwt, sentinel)

    def lf(self, k: np.ndarray) -> np.ndarray:
        c = self.bwt[k].astype(np.int64)
        text = c != self.sentinel
        out = np.zeros_like(k)
        ck, kk = c[text], k[text]
        out[text] = 1 + self.cfreq[ck] + self.occ[ck, kk]
        return out


class SaltLocate:
    """salt's locate structures of one index, sampled every `intv` ranks
    in the C part and at the '#' ranks in the R part."""

    def __init__(self, idx, intv: int = 8):
        self.intv = int(intv)
        self.c = _Family(idx.cbwt, idx.c_l2, C_SENTINEL)
        # bwt_cal_sa: sa[k / intv] for every k % intv == 0, sa[0] = -1
        self.c_samples = np.asarray(idx.csa[:: self.intv], dtype=np.int64)
        self.r = _Family(idx.rbwt, idx.r_cumfreq, R_SENTINEL)
        # '#' ranks: [cumfreq['#'] + 1, cumfreq[sentinel] + 1)
        self.sharp_lo = int(idx.r_cumfreq[4]) + 1
        self.sharp_hi = int(idx.r_cumfreq[5]) + 1
        self.sharp_values = np.asarray(idx.sharp_bases, dtype=np.int64)
        if len(self.sharp_values) != self.sharp_hi - self.sharp_lo:
            raise ValueError(
                f"{self.sharp_hi - self.sharp_lo} '#' ranks in the R BWT but "
                f"{len(self.sharp_values)} sharp_bases entries")

    def _walk(self, fam: _Family, k: np.ndarray, stop) -> tuple:
        """(stop rank, LF steps taken) of each rank in `k`."""
        k = k.copy()
        steps = np.zeros_like(k)
        live = ~stop(k)
        while live.any():
            k[live] = fam.lf(k[live])
            steps[live] += 1
            live[live] = ~stop(k[live])
        return k, steps

    def c_values(self, ranks) -> np.ndarray:
        """C suffix-array values (uint32 in int64) as bwt_sa gives them."""
        k = np.asarray(ranks, dtype=np.int64)
        k, steps = self._walk(self.c, k, lambda r: r % self.intv == 0)
        return (self.c_samples[k // self.intv] + steps) & U32

    def r_values(self, ranks) -> np.ndarray:
        """R genome coordinates (uint32 in int64) as Rbwt_back_bwt_sa gives
        them; UINT32_MAX on a '#' rank and on rank 0."""
        k0 = np.asarray(ranks, dtype=np.int64)

        def on_sharp(r):
            return (r >= self.sharp_lo) & (r < self.sharp_hi)

        none = on_sharp(k0) | (k0 == 0)
        k, steps = self._walk(self.r, k0[~none], on_sharp)
        out = np.full(k0.shape, U32, dtype=np.int64)
        out[~none] = (self.sharp_values[k - self.sharp_lo] + steps) & U32
        return out

    def values(self, ranks, is_r) -> np.ndarray:
        """Each rank's value in its own family (`is_r` per rank)."""
        ranks = np.asarray(ranks, dtype=np.int64)
        is_r = np.asarray(is_r, dtype=bool)
        out = np.empty(ranks.shape, dtype=np.int64)
        out[~is_r] = self.c_values(ranks[~is_r])
        out[is_r] = self.r_values(ranks[is_r])
        return out
