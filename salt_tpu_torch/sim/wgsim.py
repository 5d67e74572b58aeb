"""Short-read simulator, output-compatible with wgsim (the test-harness
generator vendored by the reference at
Test/Simulator/wgsim-master/wgsim.c).

Behavioral model (wgsim.c:104-157 wgsim_mut_diref, :229-370 wgsim_core):

* Per contig, a diploid pair of mutated haplotypes: each base mutates
  with probability ``mut_rate``; of mutations, ``indel_frac`` are
  indels (half deletions, half insertions, geometric extension
  ``indel_extend``, insertions capped at 4bp), the rest substitutions;
  each mutation is hom with probability 1/3 (always hom in -h haploid
  mode), het on a random haplotype otherwise.
* Truth table on stdout in wgsim's mutations.txt format:
  ``chrom  pos  ref  alt  +|-`` with het substitutions shown as IUPAC
  codes and indels as ``-``-marked rows (wgsim.c:159-226).
* Pairs sampled per contig proportional to length; insert ~ N(d, s)
  clamped to the max read length; read 2 is the reverse strand end;
  a coin flip swaps which end goes to which file (R1/R2).
* Sequencing errors: each base with probability ``err_rate`` is
  replaced by ``(c+1)&3`` ("recurrent" errors, wgsim.c:342).
* Read names carry the truth: ``@chrom_left_right_e:s:i_e:s:i_HEX/1|2``
  (wgsim.c:359-363); base quality is constant Q from the error rate.

This is a NumPy re-implementation, not a port: mutation plans and error
masks are drawn vectorized per contig / per batch of pairs.  RNG
sequences therefore differ from the C tool (it uses drand48); outputs
are format- and distribution-compatible, not bit-identical.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass
from typing import List, Optional, TextIO

import numpy as np

_NT = "ACGTN"
# IUPAC code for the unordered pair {a, b}: index (1<<a | 1<<b)
_IUPAC = "XACMGRSVTWYHKDBN"

NOCHANGE, INSERT, SUBSTITUTE, DELETE = 0, 0x1000, 0xE000, 0xF000
MUTMSK = 0xF000

_CODE = np.full(256, 4, dtype=np.uint8)
for _i, _c in enumerate("ACGT"):
    _CODE[ord(_c)] = _i
    _CODE[ord(_c.lower())] = _i


@dataclass
class SimParams:
    err_rate: float = 0.02
    mut_rate: float = 0.001
    indel_frac: float = 0.15
    indel_extend: float = 0.3
    max_n_ratio: float = 0.05
    dist: int = 500
    std_dev: int = 50
    n_pairs: int = 1000000
    size_l: int = 70
    size_r: int = 70
    is_hap: bool = False
    seed: int = -1


def _mutate_contig(codes: np.ndarray, p: SimParams, rng: np.random.Generator):
    """Return the two haplotype mut-arrays (uint16, wgsim's encoding:
    low 4 bits base code, bits 4..11 insertion bases, top 4 bits type)."""
    L = len(codes)
    hap = [codes.astype(np.uint16), codes.astype(np.uint16).copy()]
    # sequential pass: deletion runs couple adjacent positions
    mut_pos = np.nonzero((codes < 4) & (rng.random(L) < p.mut_rate))[0]
    deleting = 0
    mut_set = set(mut_pos.tolist())
    i = 0
    while i < L:
        if deleting:
            if rng.random() < p.indel_extend:
                if deleting & 1:
                    hap[0][i] = (hap[0][i] & 0xF) | DELETE
                if deleting & 2:
                    hap[1][i] = (hap[1][i] & 0xF) | DELETE
                i += 1
                continue
            deleting = 0
        if i in mut_set:
            c = int(codes[i])
            if rng.random() >= p.indel_frac:  # substitution
                alt = (c + int(rng.random() * 3.0 + 1)) & 3
                if p.is_hap or rng.random() < 0.333333:
                    hap[0][i] = hap[1][i] = SUBSTITUTE | alt
                else:
                    hap[0 if rng.random() < 0.5 else 1][i] = SUBSTITUTE | alt
            elif rng.random() < 0.5:  # deletion
                if p.is_hap or rng.random() < 0.333333:
                    hap[0][i] = hap[1][i] = DELETE
                    deleting = 3
                else:
                    deleting = 1 if rng.random() < 0.5 else 2
                    hap[deleting - 1][i] = DELETE
            else:  # insertion
                num_ins, ins = 0, 0
                while True:
                    num_ins += 1
                    ins = (ins << 2) | int(rng.random() * 4.0)
                    if num_ins >= 4 or rng.random() >= p.indel_extend:
                        break
                val = (num_ins << 12) | (ins << 4) | c
                if p.is_hap or rng.random() < 0.333333:
                    hap[0][i] = hap[1][i] = val
                else:
                    hap[0 if rng.random() < 0.5 else 1][i] = val
        i += 1
    return hap


def _print_mutref(name: str, codes: np.ndarray, hap1, hap2, out: TextIO):
    """Truth-table rows for every mutated position (wgsim.c:159-226)."""
    L = len(codes)
    changed = np.nonzero((hap1 != codes) | (hap2 != codes))[0]
    for i in changed.tolist():
        c0 = int(codes[i])
        c1, c2 = int(hap1[i]), int(hap2[i])
        m1, m2 = c1 & MUTMSK, c2 & MUTMSK
        if c1 == c2:  # hom
            if m1 == SUBSTITUTE:
                out.write(f"{name}\t{i+1}\t{_NT[c0]}\t{_NT[c1 & 0xF]}\t-\n")
            elif m1 == DELETE:
                out.write(f"{name}\t{i+1}\t{_NT[c0]}\t-\t-\n")
            elif (m1 >> 12) <= 4 and m1 != NOCHANGE:  # insertion
                n, ins = c1 >> 12, (c1 >> 4) & 0xFF
                bases = "".join(_NT[(ins >> (2 * k)) & 3] for k in range(n - 1, -1, -1))
                out.write(f"{name}\t{i+1}\t-\t{bases}\t-\n")
        else:  # het
            if m1 == SUBSTITUTE or m2 == SUBSTITUTE:
                code = _IUPAC[(1 << (c1 & 3)) | (1 << (c2 & 3))]
                out.write(f"{name}\t{i+1}\t{_NT[c0]}\t{code}\t+\n")
            elif m1 == DELETE or m2 == DELETE:
                out.write(f"{name}\t{i+1}\t{_NT[c0]}\t-\t+\n")
            else:  # het insertion on one haplotype
                c = c1 if m1 not in (NOCHANGE,) else c2
                n, ins = c >> 12, (c >> 4) & 0xFF
                if n and n <= 4:
                    bases = "".join(
                        _NT[(ins >> (2 * k)) & 3] for k in range(n - 1, -1, -1)
                    )
                    out.write(f"{name}\t{i+1}\t-\t{bases}\t+\n")


def _gen_read(target: np.ndarray, start: int, step: int, size: int):
    """Walk the mutated haplotype from `start` by `step`, emitting size
    bases (wgsim.c __gen_read): deletions consume reference, insertions
    append; returns (codes, ext_coor, n_sub, n_indel) or None."""
    L = len(target)
    seq = np.empty(size, dtype=np.uint8)
    k = 0
    ext = -10
    n_sub = n_indel = 0
    i = start
    while 0 <= i < L and k < size:
        c = int(target[i])
        mt = c & MUTMSK
        if ext < 0:
            if mt != NOCHANGE and mt != SUBSTITUTE:
                i += step
                continue
            ext = i
        if mt == DELETE:
            n_indel += 1
        elif mt in (NOCHANGE, SUBSTITUTE):
            seq[k] = c & 0xF
            k += 1
            if mt == SUBSTITUTE:
                n_sub += 1
        else:  # insertion
            n_indel += 1
            seq[k] = c & 0xF
            k += 1
            n, ins = c >> 12, c >> 4
            while n > 0 and k < size:
                seq[k] = ins & 3
                k += 1
                n -= 1
                ins >>= 2
        i += step
    if k != size:
        return None
    return seq, ext, n_sub, n_indel


def simulate(
    fasta_path: str,
    out1: TextIO,
    out2: TextIO,
    params: SimParams = None,
    mut_out: TextIO = None,
) -> int:
    """Simulate params.n_pairs read pairs; truth table to `mut_out`
    (default stdout).  Returns the number of pairs written."""
    from ..io.fasta import read_records

    p = params or SimParams()
    mut_out = mut_out or sys.stdout
    rng = np.random.default_rng(None if p.seed <= 0 else p.seed)

    recs = [(r.name, r.seq) for r in read_records(fasta_path)]
    tot_len = sum(len(s) for _, s in recs)
    max_size = max(p.size_l, p.size_r)
    q_char = (
        "I" if p.err_rate == 0.0
        else chr(int(-10.0 * np.log10(p.err_rate) + 0.499) + 33)
    )
    sizes = (p.size_l, p.size_r)
    n_written = 0
    for name, seq in recs:
        L = len(seq)
        n_pairs = int(L / tot_len * p.n_pairs + 0.5)
        if L < p.dist + 3 * p.std_dev:
            print(f"[wgsim] skip sequence '{name}' (too short)", file=sys.stderr)
            continue
        codes = _CODE[np.frombuffer(seq.encode("latin1"), dtype=np.uint8)]
        hap1, hap2 = _mutate_contig(codes, p, rng)
        _print_mutref(name, codes, hap1, hap2, mut_out)
        ii = 0
        while ii < n_pairs:
            d = int(rng.normal(p.dist, p.std_dev) + 0.5)
            d = max(d, max_size)
            if L - d + 1 <= 0:
                continue
            pos = int((L - d + 1) * rng.random())
            if pos < 0 or pos + d - 1 >= L:
                continue
            is_flip = rng.random() < 0.5
            target = hap1 if rng.random() < 0.5 else hap2
            r0 = _gen_read(target, pos, +1, sizes[0])
            r1 = _gen_read(target, pos + d - 1, -1, sizes[1])
            if r0 is None or r1 is None:
                continue
            seq0, ext0, sub0, ind0 = r0
            seq1, ext1, sub1, ind1 = r1
            seq1 = np.where(seq1 < 4, 3 - seq1, 4).astype(np.uint8)  # revcomp
            # sequencing errors (recurrent model) + N-ratio filter
            reads = [seq0, seq1]
            n_err = [0, 0]
            bad = False
            for j in (0, 1):
                r = reads[j]
                nmask = r >= 4
                if nmask.sum() / len(r) > p.max_n_ratio:
                    bad = True
                    break
                emask = (~nmask) & (rng.random(len(r)) < p.err_rate)
                r[emask] = (r[emask] + 1) & 3
                n_err[j] = int(emask.sum())
            if bad:
                continue
            fpo = (out1, out2) if not is_flip else (out2, out1)
            ends = (1, 2) if not is_flip else (2, 1)
            for j in (0, 1):
                rstr = "".join(_NT[c] for c in reads[j])
                fpo[j].write(
                    f"@{name}_{ext0+1}_{ext1+1}_{n_err[0]}:{sub0}:{ind0}_"
                    f"{n_err[1]}:{sub1}:{ind1}_{ii:x}/{ends[j]}\n"
                    f"{rstr}\n+\n{q_char * len(rstr)}\n"
                )
            ii += 1
            n_written += 1
    return n_written


class _RanNormal:
    """wgsim.c:66-85 ran_normal (Box-Muller with the C static state)."""

    def __init__(self, r48):
        self.r = r48
        self.iset = 0
        self.gset = 0.0

    def __call__(self) -> float:
        import math

        if self.iset == 0:
            while True:
                v1 = 2.0 * self.r.drand48() - 1.0
                v2 = 2.0 * self.r.drand48() - 1.0
                rsq = v1 * v1 + v2 * v2
                if not (rsq >= 1.0 or rsq == 0.0):
                    break
            fac = math.sqrt(-2.0 * math.log(rsq) / rsq)
            self.gset = v1 * fac
            self.iset = 1
            return v2 * fac
        self.iset = 0
        return self.gset


def _mut_diref_exact(codes, is_hap: bool, r48):
    """wgsim_mut_diref (wgsim.c:104-157), drand48-call-exact."""
    L = len(codes)
    hap1 = [0] * L
    hap2 = [0] * L
    deleting = 0
    MUT_RATE, INDEL_FRAC, INDEL_EXTEND = (
        _EXACT_P.mut_rate, _EXACT_P.indel_frac, _EXACT_P.indel_extend)
    d48 = r48.drand48
    for i in range(L):
        c = int(codes[i])
        hap1[i] = hap2[i] = c
        if deleting:
            if d48() < INDEL_EXTEND:
                if deleting & 1:
                    hap1[i] |= DELETE
                if deleting & 2:
                    hap2[i] |= DELETE
                continue
            deleting = 0
        if c < 4 and d48() < MUT_RATE:
            if d48() >= INDEL_FRAC:       # substitution
                r = d48()
                c = (c + int(r * 3.0 + 1)) & 3
                if is_hap or d48() < 0.333333:
                    hap1[i] = hap2[i] = SUBSTITUTE | c
                else:
                    if d48() < 0.5:
                        hap1[i] = SUBSTITUTE | c
                    else:
                        hap2[i] = SUBSTITUTE | c
            else:                          # indel
                if d48() < 0.5:            # deletion
                    if is_hap or d48() < 0.333333:
                        hap1[i] = hap2[i] = DELETE
                        deleting = 3
                    else:
                        deleting = 1 if d48() < 0.5 else 2
                        (hap1 if deleting == 1 else hap2)[i] = DELETE
                else:                      # insertion
                    num_ins = 0
                    ins = 0
                    while True:
                        num_ins += 1
                        ins = (ins << 2) | int(d48() * 4.0)
                        if not (num_ins < 4 and d48() < INDEL_EXTEND):
                            break
                    val = (num_ins << 12) | (ins << 4) | c
                    if is_hap or d48() < 0.333333:
                        hap1[i] = hap2[i] = val
                    else:
                        (hap1 if d48() < 0.5 else hap2)[i] = val
    return hap1, hap2


def _print_mutref_exact(name, codes, hap1, hap2, out):
    """wgsim_print_mutref (wgsim.c:159-226), byte-exact."""
    L = len(codes)
    j = 0
    for i in range(L):
        c0 = int(codes[i])
        c1 = hap1[i]
        c2 = hap2[i]
        if c0 >= 4:
            continue
        if (c1 & MUTMSK) == NOCHANGE and (c2 & MUTMSK) == NOCHANGE:
            continue
        if c1 == c2:   # hom
            if (c1 & MUTMSK) == SUBSTITUTE:
                out.write(f"{name}\t{i+1}\t{_NT[c0]}\t{_NT[c1 & 0xF]}\t-\n")
            elif (c1 & MUTMSK) == DELETE:
                if i >= j:
                    out.write(f"{name}\t{i+1}\t")
                    j = i
                    while (j < L and hap1[j] == hap2[j]
                           and (hap1[j] & MUTMSK) == DELETE):
                        out.write(_NT[int(codes[j])])
                        j += 1
                    out.write("\t-\t-\n")
            elif ((c1 & MUTMSK) >> 12) <= 4:   # ins
                out.write(f"{name}\t{i+1}\t-\t")
                n = (c1 & MUTMSK) >> 12
                ins = c1 >> 4
                while n > 0:
                    out.write(_NT[ins & 0x3])
                    ins >>= 2
                    n -= 1
                out.write("\t-\n")
        else:          # het
            if ((c1 & MUTMSK) == SUBSTITUTE or (c2 & MUTMSK) == SUBSTITUTE):
                out.write(
                    f"{name}\t{i+1}\t{_NT[c0]}\t"
                    f"{_IUPAC[1 << (c1 & 0x3) | 1 << (c2 & 0x3)]}\t+\n")
            elif (c1 & MUTMSK) == DELETE:
                if i >= j:
                    out.write(f"{name}\t{i+1}\t")
                    j = i
                    while (j < L and hap1[j] != hap2[j]
                           and (hap1[j] & MUTMSK) == DELETE):
                        out.write(_NT[int(codes[j])])
                        j += 1
                    out.write("\t-\t-\n")
            elif (c2 & MUTMSK) == DELETE:
                if i >= j:
                    out.write(f"{name}\t{i+1}\t")
                    j = i
                    while (j < L and hap1[j] != hap2[j]
                           and (hap2[j] & MUTMSK) == DELETE):
                        out.write(_NT[int(codes[j])])
                        j += 1
                    out.write("\t-\t-\n")
            elif ((c1 & MUTMSK) >> 12) <= 4 and ((c1 & MUTMSK) >> 12) > 0:
                out.write(f"{name}\t{i+1}\t-\t")
                n = (c1 & MUTMSK) >> 12
                ins = c1 >> 4
                while n > 0:
                    out.write(_NT[ins & 0x3])
                    ins >>= 2
                    n -= 1
                out.write("\t+\n")
            elif ((c2 & MUTMSK) >> 12) <= 4 or ((c2 & MUTMSK) >> 12) > 0:
                # reference quirk: `||` makes this branch catch every
                # remaining het case (wgsim.c:217) — kept as-is
                out.write(f"{name}\t{i+1}\t-\t")
                n = (c2 & MUTMSK) >> 12
                ins = c2 >> 4
                while n > 0:
                    out.write(_NT[ins & 0x3])
                    ins >>= 2
                    n -= 1
                out.write("\t+\n")


def _gen_read_exact(target, L, start, step, size):
    """__gen_read macro (wgsim.c:303-321)."""
    out = []
    ext = -10
    n_sub = 0
    n_indel = 0
    i = start
    while 0 <= i < L and len(out) < size:
        c = target[i]
        mut = c & MUTMSK
        if ext < 0:
            if mut != NOCHANGE and mut != SUBSTITUTE:
                i += step
                continue
            ext = i
        if mut == DELETE:
            n_indel += 1
        elif mut == NOCHANGE or mut == SUBSTITUTE:
            out.append(c & 0xF)
            if mut == SUBSTITUTE:
                n_sub += 1
        else:
            n_indel += 1
            out.append(c & 0xF)
            n = mut >> 12
            ins = c >> 4
            while n > 0 and len(out) < size:
                out.append(ins & 0x3)
                n -= 1
                ins >>= 2
        i += step
    if len(out) != size:
        ext = -10
    return out, ext, n_sub, n_indel


_EXACT_P = None


def simulate_exact(
    fasta_path: str,
    out1: TextIO,
    out2: TextIO,
    params: SimParams = None,
    mut_out: TextIO = None,
) -> int:
    """drand48-sequence-exact replay of wgsim_core (wgsim.c:229-370):
    byte-identical R1/R2/mutations output to the vendored C tool for the
    same seed.  Per-base/per-pair python loops — use the vectorized
    `simulate` unless replaying reference-generated fixtures."""
    global _EXACT_P
    import math

    from ..constants import NST_NT4_TABLE
    from ..io.fasta import read_records
    from ..utils.rand48 import Rand48

    p = params or SimParams()
    _EXACT_P = p
    mut_out = mut_out or sys.stdout
    seed = p.seed if p.seed > 0 else 42
    r48 = Rand48(seed)
    ran_normal = _RanNormal(r48)
    d48 = r48.drand48

    recs = [(r.name, r.seq) for r in read_records(fasta_path)]
    tot_len = sum(len(s) for _, s in recs)
    max_size = max(p.size_l, p.size_r)
    sizes = [p.size_l, p.size_r]
    Q = ("I" if p.err_rate == 0.0
         else chr(int(-10.0 * math.log(p.err_rate) / math.log(10.0) + 0.499)
                  + 33))
    n_written = 0
    for name, seq in recs:
        L = len(seq)
        n_pairs = int(L / tot_len * p.n_pairs + 0.5)
        if L < p.dist + 3 * p.std_dev:
            print(f"[wgsim] skip sequence '{name}' as it is shorter than "
                  f"{p.dist + 3 * p.std_dev}!", file=sys.stderr)
            continue
        codes = NST_NT4_TABLE[np.frombuffer(seq.encode("latin1"), np.uint8)]
        hap1, hap2 = _mut_diref_exact(codes, p.is_hap, r48)
        _print_mutref_exact(name, codes, hap1, hap2, mut_out)
        ii = 0
        while ii < n_pairs:
            while True:
                ran = ran_normal() * p.std_dev + p.dist
                d = int(ran + 0.5)
                d = d if d > max_size else max_size
                pos = int((L - d + 1) * d48())
                if not (pos < 0 or pos >= L or pos + d - 1 >= L):
                    break
            if d48() < 0.5:
                fpo = (out1, out2)
                s = (sizes[0], sizes[1])
                is_flip = 0
            else:
                fpo = (out2, out1)
                s = (sizes[1], sizes[0])
                is_flip = 1
            target = hap1 if d48() < 0.5 else hap2
            r0, ext0, sub0, ind0 = _gen_read_exact(target, L, pos, +1, s[0])
            r1, ext1, sub1, ind1 = _gen_read_exact(target, L, pos + d - 1,
                                                   -1, s[1])
            r1 = [(3 - c if c < 4 else 4) for c in r1]   # complement
            if ext0 < 0 or ext1 < 0:
                continue
            reads = [r0, r1]
            n_err = [0, 0]
            jfail = 2
            for j in (0, 1):
                n_n = 0
                r = reads[j]
                for i in range(s[j]):
                    c = r[i]
                    if c >= 4:
                        c = 4
                        n_n += 1
                    elif d48() < p.err_rate:
                        c = (c + 1) & 3
                        n_err[j] += 1
                    r[i] = c
                if n_n / s[j] > p.max_n_ratio:
                    jfail = j
                    break
            if jfail < 2:
                continue
            for j in (0, 1):
                rstr = "".join(_NT[c] for c in reads[j])
                fpo[j].write(
                    f"@{name}_{ext0+1}_{ext1+1}_{n_err[0]}:{sub0}:{ind0}_"
                    f"{n_err[1]}:{sub1}:{ind1}_{ii:x}/"
                    f"{is_flip + 1 if j == 0 else 2 - is_flip}\n"
                    f"{rstr}\n+\n{Q * s[j]}\n"
                )
            ii += 1
            n_written += 1
    return n_written


def wgsim_main(argv: Optional[List[str]] = None) -> int:
    import argparse

    # -h is wgsim's haploid flag, so argparse's default help is disabled
    ap = argparse.ArgumentParser(
        prog="salt-tpu wgsim", description="wgsim-compatible read simulator",
        add_help=False,
    )
    ap.add_argument("--help", action="help")
    ap.add_argument("-e", type=float, default=0.02, help="base error rate")
    ap.add_argument("-d", type=int, default=500, help="outer distance")
    ap.add_argument("-s", type=int, default=50, help="stdev")
    ap.add_argument("-N", type=int, default=1000000, help="number of pairs")
    ap.add_argument("-1", dest="size_l", type=int, default=70)
    ap.add_argument("-2", dest="size_r", type=int, default=70)
    ap.add_argument("-r", type=float, default=0.001, help="mutation rate")
    ap.add_argument("-R", type=float, default=0.15, help="indel fraction")
    ap.add_argument("-X", type=float, default=0.3, help="indel extension prob")
    ap.add_argument("-A", type=float, default=0.05, help="max N ratio")
    ap.add_argument("-S", type=int, default=-1, help="seed")
    ap.add_argument("-h", dest="haploid", action="store_true",
                    help="haploid mode")
    ap.add_argument("--exact", action="store_true",
                    help="drand48-sequence-exact mode: byte-identical "
                         "output to the C wgsim for the same -S seed "
                         "(slower python loops)")
    ap.add_argument("ref_fa")
    ap.add_argument("read1_fq")
    ap.add_argument("read2_fq")
    args = ap.parse_args(argv)
    p = SimParams(
        err_rate=args.e, mut_rate=args.r, indel_frac=args.R,
        indel_extend=args.X, max_n_ratio=args.A, dist=args.d,
        std_dev=args.s, n_pairs=args.N, size_l=args.size_l,
        size_r=args.size_r, is_hap=args.haploid, seed=args.S,
    )
    sim = simulate_exact if args.exact else simulate
    with open(args.read1_fq, "w") as f1, open(args.read2_fq, "w") as f2:
        sim(args.ref_fa, f1, f2, p)
    return 0


if __name__ == "__main__":
    raise SystemExit(wgsim_main())
