"""The plain reference that decides `correct`: NumPy and plain PyTorch,
importing nothing of the program.

It works out again, from the genome, the known-SNP table and the reads
alone, what a SAM record of salt's aligner has to say:

* the allele mask of every reference position (the reference base and
  each known SNP's alleles; none at N) and the 2-bit reference with N
  replaced as salt's index does (srand48(11), lrand48() & 3 per N);
* for every checked read, every ungapped locus on either strand with at
  most `max_diff` mismatches against the allele mask, by an exhaustive
  search over the whole genome (one matrix product per block of
  positions against the reads' one-hot patterns);
* salt's choice among those loci (candidates in position order, strand 0
  then strand 1, a hit being a locus no worse than every locus before
  it; the primary is the winning strand's first best, strand 1 winning
  ties; XA and MAPQ from the per-strand hit lists, query.c
  query_set_hits and gen_mapq), and so the whole expected SAM line of
  every read with such a locus;
* for the other reads, the SNP-aware edit distance of the read against
  the reference from its true locus (a banded semi-global DP), which
  bounds what a gapped alignment may cost;
* for a PE end with no ungapped hit whose mate sits at its own unique
  locus, the window salt's SW rescue searches next to the mate
  (alnpe.c:395-480) and a lower bound on the rescue's score there: the
  best local stretch of the end's true alignment, scored by both of the
  rescue's matrices at their least;
* the MD, NM and XV tags of any CIGAR at any position, and the mate
  fields, TLEN and proper-pair flag of a pair (sam.c alnpe_sam);
* which reads lie in repeats: a read one of whose seeds (its windows of
  l_seed bases every l_overlap, on either strand) occurs more than
  max_seed times, SNP-aware, in the genome.  There salt extends the seed
  greedily to the left (alnse.c:246-258) and sees a subset of the loci;
* the contig of every locus and its position there (bns_coor_pac2real):
  a genome of several contigs is searched as salt's index searches it,
  over the contigs laid end to end, and a record names the contig its
  locus falls in; mates on two contigs name each other's contig, with
  TLEN 0 and no proper flag (sam.c alnpe_sam).

`Judge` compares the records the program returned against these and
counts the faults: `fields_wrong`, a record that contradicts the genome
or itself (tags, sequence, mate fields); `hits_wrong`, a read outside
repeats whose locus, MAPQ or XA differ from salt's choice over the
exhaustive loci, whose gapped alignment is worse than its true locus
allows, or a PE end that rescue should have placed and did not;
`records_wrong`, the reads (pairs) with either.  `repeat_hits_wrong`
counts hit faults of reads in repeats apart; it is reported and not
held to a limit (PERF.md says why).
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional

import numpy as np
import torch

_BASES = "ACGTN"
_LUT = np.frombuffer(b"ACGTN", dtype=np.uint8)
_COMP = np.array([3, 2, 1, 0, 4], dtype=np.uint8)
_CIGAR = re.compile(r"(\d+)([MIDS])")
NO_HIT = 100000
# SSW's scores in salt's rescue (alnpe.c:58-73, aln.h:141-142)
SW_MISMATCH = 3
SW_GAP_OPEN = 3
SW_GAP_EXTEND = 1
SW_FILTER_DIST = 20
# the gapped step's reference window: the read and 4 bases (alnse.c:373)
GAP_WINDOW_PAD = 4


def revcomp(codes: np.ndarray) -> np.ndarray:
    return _COMP[codes[..., ::-1]]


def lrand48_codes(n: int, seed: int = 11) -> np.ndarray:
    """lrand48() & 3 for the first n draws after srand48(seed)."""
    a, c, mask = 0x5DEECE66D, 0xB, (1 << 48) - 1
    x = ((seed & 0xFFFFFFFF) << 16) | 0x330E
    out = np.empty(n, dtype=np.uint8)
    for i in range(n):
        x = (a * x + c) & mask
        out[i] = (x >> 17) & 3
    return out


def gen_mapq(b0: int, b1: int) -> int:
    if b0 == 0:
        return 0
    q = int(255.0 * (abs(b0 - b1) / float(b0)))
    return q if q < 254 else 254


class RefGenome:
    """Allele masks and the 2-bit reference of a genome's contigs laid
    end to end, and its contig table: `names`, `offsets`, `lengths`."""

    def __init__(self, genome, snp_aware: bool = True):
        codes = genome.codes
        self.names = list(genome.contig_names)
        self.offsets = np.asarray(genome.contig_offsets, dtype=np.int64)
        self.lengths = np.asarray(genome.contig_lengths, dtype=np.int64)
        self.contig = {nm: i for i, nm in enumerate(self.names)}
        self.n = len(codes)
        mask = np.where(codes < 4, 1 << np.minimum(codes, 3), 0).astype(np.uint8)
        if snp_aware and len(genome.snp_pos):
            mask[genome.snp_pos] |= (1 << genome.snp_alt).astype(np.uint8)
        self.mask = mask
        pac = codes.copy()
        amb = np.nonzero(codes >= 4)[0]
        pac[amb] = lrand48_codes(len(amb))
        self.pac = pac

    def mask_at(self, pos: int, n: int) -> np.ndarray:
        """Allele masks of [pos, pos + n), 0 past the end."""
        out = np.zeros(n, dtype=np.uint8)
        lo, hi = max(pos, 0), min(pos + n, self.n)
        if hi > lo:
            out[lo - pos:hi - pos] = self.mask[lo:hi]
        return out

    def mismatches(self, read: np.ndarray, pos: int) -> int:
        return int(((self.mask_at(pos, len(read)) >> read) & 1 == 0).sum())

    def locus(self, pos: int):
        """(contig name, 1-based position in it) of genome position `pos`:
        the last contig whose offset is at or below it, as
        bns_coor_pac2real (Align_src/bntseq.c:269-280) finds it."""
        c = int(np.searchsorted(self.offsets, pos, side="right")) - 1
        return self.names[c], int(pos - self.offsets[c]) + 1

    def at(self, rname: str, pos: int) -> Optional[int]:
        """The genome position of a record's RNAME and POS, or None where
        RNAME is no contig or POS lies outside it."""
        c = self.contig.get(rname)
        if c is None or not 1 <= pos <= self.lengths[c]:
            return None
        return int(self.offsets[c]) + pos - 1


def _planes(ref: RefGenome, device, pad: int = 256):
    """The genome's allele masks as one-hot planes (n + pad, 4) on the
    device, zero past the end; made once a device."""
    key = (str(torch.device(device)), pad)
    cache = ref.__dict__.setdefault("_planes_cache", {})
    if key not in cache:
        dt = torch.float16 if torch.device(device).type == "cuda" else torch.float32
        planes = torch.zeros(ref.n + pad, 4, dtype=dt, device=device)
        m = torch.from_numpy(ref.mask).to(device)
        for b in range(4):
            planes[:ref.n, b] = ((m >> b) & 1).to(dt)
        cache.clear()
        cache[key] = planes
    return cache[key]


def _one_hot(pats: np.ndarray, planes) -> torch.Tensor:
    """(P, l) codes as (P, 4 l) one-hot rows in the planes' type."""
    P, l = pats.shape
    w = np.zeros((P, l, 4), dtype=np.float32)
    w[np.arange(P)[:, None], np.arange(l)[None, :], pats] = 1
    return torch.from_numpy(w.reshape(P, 4 * l)).to(planes.device, planes.dtype)


def _block(ref: RefGenome, cols: int, device) -> int:
    """Genome positions a block, so that a block's product stays small."""
    budget = 1 << (30 if torch.device(device).type == "cuda" else 24)
    return int(min(max(budget // max(cols, 1), 1024), max(ref.n, 1)))


def _windows(planes, s0: int, c: int, l: int):
    win = planes[s0:s0 + c + l - 1].unfold(0, l, 1)          # (c, 4, l)
    return win.transpose(1, 2).reshape(c, 4 * l)


def exhaustive_hits(ref: RefGenome, reads: np.ndarray, max_diff: int,
                    device, block: int = None) -> List[Dict]:
    """Every (strand, pos) with at most max_diff mismatches for each read
    of `reads` (R, L): a dict {0: [(pos, count)], 1: [...]} per read,
    ascending by position."""
    R, L = reads.shape
    if (reads > 3).any():
        raise ValueError("the reference search takes reads without N")
    planes = _planes(ref, device, pad=max(256, L))
    w = _one_hot(np.concatenate([reads, revcomp(reads)]), planes)  # (2R, 4L)
    out: List[Dict] = [{0: [], 1: []} for _ in range(R)]
    found = []
    block = block or _block(ref, 2 * R + 4 * L, device)
    for s0 in range(0, ref.n, block):
        c = min(block, ref.n - s0)
        matches = _windows(planes, s0, c, L) @ w.T           # (c, 2R)
        p, f = torch.nonzero(matches >= L - max_diff - 0.5, as_tuple=True)
        cnt = L - torch.round(matches[p, f]).long()
        found.append(torch.stack([p + s0, f, cnt], 1).cpu())
        del matches
    if found:
        for pos, f, cnt in torch.cat(found).numpy().tolist():
            out[f % R][f // R].append((pos, cnt))
    for o in out:
        o[0].sort()
        o[1].sort()
    return out


def seed_occurrences(ref: RefGenome, reads: np.ndarray, l_seed: int,
                     l_overlap: int, device, block: int = None) -> np.ndarray:
    """SNP-aware exact occurrences in the genome of the seeds salt takes
    from each read (windows of l_seed bases every l_overlap, of the read
    and of its reverse complement): (R, 2, S) counts."""
    R, L = reads.shape
    starts = list(range(0, L - l_seed + 1, l_overlap))
    S = len(starts)
    both = np.concatenate([reads, revcomp(reads)])           # (2R, L)
    seeds = np.stack([both[:, p:p + l_seed] for p in starts], 1)
    planes = _planes(ref, device, pad=max(256, L))
    w = _one_hot(seeds.reshape(2 * R * S, l_seed), planes)
    counts = torch.zeros(2 * R * S, dtype=torch.int64, device=planes.device)
    block = block or _block(ref, 2 * R * S + 4 * l_seed, device)
    for s0 in range(0, ref.n, block):
        c = min(block, ref.n - s0)
        matches = _windows(planes, s0, c, l_seed) @ w.T
        counts += (matches >= l_seed - 0.5).sum(0)
        del matches
    return counts.reshape(2, R, S).permute(1, 0, 2).cpu().numpy()


def salt_choice(hits: Dict, max_diff: int, k_hits: int, max_hits: int):
    """Salt's primary, MAPQ and XA over one read's loci: None when the read
    has no hit, else (strand, pos, n_diff, mapq, [(strand, pos, nd)])."""
    t = max_diff
    hs = {0: [], 1: []}
    for s in (0, 1):
        for pos, cnt in hits[s]:
            if cnt <= t:
                hs[s].append((pos, cnt))
            t = min(t, cnt)
    if not hs[0] and not hs[1]:
        return None
    s = 1 if hs[1] else 0
    best = min(c for _p, c in hs[s])
    pos = next(p for p, c in hs[s] if c == best)
    b0, b1, xa = best, NO_HIT, []
    for st in (0, 1):
        if not hs[st]:
            continue
        a0 = hs[st][0][1]
        for p, c in hs[st][:k_hits]:
            if p == pos:
                continue
            if a0 <= b0:
                b1 = min(b1, a0)
                xa.append((st, p, c))
            if len(xa) == max_hits:
                break
        if len(xa) == max_hits:
            break
    return s, pos, best, gen_mapq(b0, b1), xa


def parse_cigar(cigar: str):
    ops = [(int(n), op) for n, op in _CIGAR.findall(cigar)]
    if "".join(f"{n}{op}" for n, op in ops) != cigar or not ops:
        return None
    return ops


def md_nm_xv(ref: RefGenome, pos: int, read: np.ndarray, ops) -> str:
    """MD, NM and XV tags (sam.c sam_add_md_nm) of `read` (strand
    applied) aligned at `pos` by `ops`; a leading clip is skipped, a
    trailing one ignored, XV lists clip-relative offsets of mismatches
    that match a known allele (at most 64)."""
    nm, run, md, xv = 0, 0, [], []
    rp = pos
    si = ops[0][0] if ops[0][1] == "S" else 0
    start = si
    for n, op in ops:
        if op == "M":
            for _ in range(n):
                b = int(ref.pac[rp]) if rp < ref.n else 4
                if b == read[si]:
                    run += 1
                else:
                    if rp < ref.n and (ref.mask[rp] >> read[si]) & 1 and len(xv) < 64:
                        xv.append(si - start)
                    nm += 1
                    if run:
                        md.append(str(run))
                    run = 0
                    md.append(_BASES[min(b, 4)])
                rp += 1
                si += 1
        elif op == "I":
            nm += n
            si += n
        elif op == "D":
            if run:
                md.append(str(run))
            run = 0
            nm += n
            md.append("^" + "".join(_BASES[min(int(ref.pac[rp + j]), 4)]
                                    for j in range(n)))
            rp += n
    if run:
        md.append(str(run))
    tag = f"\tMD:Z:{''.join(md)}\tNM:i:{nm}"
    if xv:
        tag += "\tXV:i:" + ",".join(map(str, xv))
    return tag


def cigar_cost(ref: RefGenome, pos: int, read: np.ndarray, ops) -> int:
    """SNP-aware edit cost of an alignment: mismatches against the allele
    masks plus inserted and deleted bases."""
    cost, rp, si = 0, pos, 0
    for n, op in ops:
        if op == "M":
            m = ref.mask_at(rp, n)
            cost += int(((m >> read[si:si + n]) & 1 == 0).sum())
            rp += n
            si += n
        elif op == "I":
            cost += n
            si += n
        elif op == "D":
            cost += n
            rp += n
        else:
            si += n
    return cost


def rescue_window(pos: int, strand: int, l_anchor: int, l_other: int,
                  min_tlen: int, max_tlen: int, n: int):
    """The reference stretch [start, end] (inclusive) and strand in which
    salt's SW rescue looks for the other end of a pair whose anchor end
    lies at (pos, strand) (alnpe.c:395-480)."""
    l2 = l_anchor + l_other
    lo = min_tlen - l2 if min_tlen > l2 else 0
    hi = max_tlen - l2 if max_tlen > l2 else 0
    if strand == 0:
        return (min(pos + lo + l_anchor, n - 1),
                min(pos + hi + l_anchor + l_other, n - 1), 1)
    start = pos - hi - l_other if pos > hi + l_other else 0
    end = pos - lo if pos > lo else 0
    return min(start, n - 1), min(end, n - 1), 0


def _gap(n: int) -> int:
    """SSW's affine gap: open 3 (the first base), extend 1."""
    return -(SW_GAP_OPEN + (n - 1) * SW_GAP_EXTEND)


def sw_score(ref: RefGenome, pos: int, read: np.ndarray, ops) -> int:
    """An upper bound on the score either rescue matrix gives the
    alignment `ops` of `read` (strand applied, leading clip skipped) at
    `pos`: +1 where the read base is an allele or the 2-bit base there,
    else -3; gaps as SSW's."""
    score, rp = 0, pos
    si = ops[0][0] if ops[0][1] == "S" else 0
    for n, op in ops:
        if op == "M":
            m = ref.mask_at(rp, n)
            b = ref.pac[max(rp, 0):max(rp, 0) + n]
            b = np.concatenate([b, np.full(n - len(b), 9, np.uint8)])
            hit = (((m >> read[si:si + n]) & 1) != 0) | (b == read[si:si + n])
            score += int(hit.sum()) - SW_MISMATCH * int((~hit).sum())
            rp += n
            si += n
        elif op == "I":
            score += _gap(n)
            si += n
        elif op == "D":
            score += _gap(n)
            rp += n
    return score


def rescue_bound(ref: RefGenome, pos: int, read: np.ndarray, ops):
    """A lower bound on the best score salt's SW rescue finds for `read`
    (strand applied) in a window that holds its alignment `ops` at
    `pos`: the best local stretch of that alignment, scored +1 where the
    read base equals the reference base at a position without a SNP or
    an N, else -3 (the least that either of the rescue's matrices
    gives), gaps as SSW's."""
    units, rp, si = [], pos, 0
    for n, op in ops:
        if op == "M":
            m = ref.mask_at(rp, n)
            one = (m != 0) & ((m & (m - 1)) == 0)
            hit = one & (((m >> read[si:si + n]) & 1) != 0)
            units.extend(np.where(hit, 1, -SW_MISMATCH).tolist())
            rp += n
            si += n
        elif op == "I":
            units.append(_gap(n))
            si += n
        elif op == "D":
            units.append(_gap(n))
            rp += n
    best = cur = 0
    for u in units:
        cur = max(cur, 0) + u
        best = max(best, cur)
    return best


def edit_dp(ref: RefGenome, read: np.ndarray, pos: int, pad: int = 4):
    """Semi-global SNP-aware edit distance of the whole read against the
    reference from `pos` on (text start fixed, end free within L + pad)
    and one optimal alignment: (distance, start, ops, longest run of
    matching bases in it)."""
    L = len(read)
    text = ref.mask_at(pos, L + pad)
    T = len(text)
    D = np.empty((L + 1, T + 1), dtype=np.int64)
    D[0] = np.arange(T + 1)
    j = np.arange(T + 1)
    for i in range(1, L + 1):
        sub = ((text >> read[i - 1]) & 1 == 0).astype(np.int64)
        tmp = np.empty(T + 1, dtype=np.int64)
        tmp[0] = i
        tmp[1:] = np.minimum(D[i - 1, :-1] + sub, D[i - 1, 1:] + 1)
        D[i] = np.minimum.accumulate(tmp - j) + j
    jb = int(np.argmin(D[L]))
    dist = int(D[L, jb])
    ops, i, jj, run, longest = [], L, jb, 0, 0
    while i > 0 or jj > 0:
        hit = i > 0 and jj > 0 and (text[jj - 1] >> read[i - 1]) & 1
        if i > 0 and jj > 0 and D[i, jj] == D[i - 1, jj - 1] + (0 if hit else 1):
            ops.append("M")
            run = run + 1 if hit else 0
            i, jj = i - 1, jj - 1
        elif i > 0 and D[i, jj] == D[i - 1, jj] + 1:
            ops.append("I")
            run = 0
            i -= 1
        else:
            ops.append("D")
            run = 0
            jj -= 1
        longest = max(longest, run)
    ops.reverse()
    # leading deletions are a shift of the start, never part of a CIGAR
    lead = 0
    while ops and ops[0] == "D":
        ops.pop(0)
        lead += 1
    runs = []
    for op in ops:
        if runs and runs[-1][1] == op:
            runs[-1][0] += 1
        else:
            runs.append([1, op])
    return dist, pos + lead, [(n, op) for n, op in runs], longest


def lv_distance(ref: RefGenome, read: np.ndarray, pos: int, k: int,
                pad: int = GAP_WINDOW_PAD) -> Optional[int]:
    """salt's gapped edit distance (LandauVishkin.c computeEditDistance)
    of `read` (strand applied) against the allele masks from `pos`, the
    text L + pad long and its end free; None past k.  A diagonal's run of
    matches goes on while the read base is an allele of the position,
    but after an edit a run starts only where the position holds that
    base alone: at a SNP position the edit goes on."""
    p = (1 << read.astype(np.int64)).astype(np.uint8)
    t = ref.mask_at(pos, len(read) + pad)
    pl, tl = len(p), len(t)
    zero = np.zeros(k + 1, np.uint8)
    pp = np.concatenate([p, np.zeros(k + 2, np.uint8)])
    tp = np.concatenate([zero, t, np.zeros(pl + 2 * k + 2, np.uint8)])

    def run(i: int, d: int, endl: int) -> int:
        """The first base from i on that does not match on diagonal d,
        at most endl."""
        if i >= endl:
            return endl
        a = pp[i:endl] & tp[k + 1 + d + i:k + 1 + d + endl]
        z = np.flatnonzero(a == 0)
        return i + int(z[0]) if len(z) else endl

    endl = min(pl, tl)
    first = run(0, 0, endl)
    if first == endl:
        return pl - endl if pl > endl else 0
    prev = {0: first}
    for e in range(1, k + 1):
        cur = {}
        for d in [0] + [x for j in range(1, e + 1) for x in (j, -j)]:
            best = max(prev.get(d, -2) + 1, prev.get(d - 1, -2),
                       prev.get(d + 1, -2) + 1)
            if best >= 0 and pp[min(best, len(pp) - 1)] == \
                    tp[k + 1 + d + best]:
                best = run(best, d, min(pl, tl - d))
            if best == pl:
                return e
            cur[d] = best
        prev = cur
    return None


def best_near(ref: RefGenome, read: np.ndarray, locus: int, slack: int = 3):
    """The least edit_dp over starts within `slack` of the true locus."""
    return min((edit_dp(ref, read, p) for p in
                range(max(locus - slack, 0), locus + slack + 1)),
               key=lambda r: (r[0], -r[3]))


def seeded_best(ref: RefGenome, read: np.ndarray, locus: int, l_seed: int,
                l_overlap: int, k: int):
    """The least gapped distance (lv_distance) within k over the loci
    salt's seeds imply for the read's true alignment; None when none is
    within k or the alignment holds no seed.  Seeds are the read's
    windows of l_seed bases every l_overlap; one whose bases all match
    (SNP-aware) without an indel in the true alignment implies the locus
    where the read would start if it had no indel."""
    _d, p0, ops, _run = best_near(ref, read, locus)
    L = len(read)
    coord = np.full(L, -1, dtype=np.int64)
    rp, si = p0, 0
    for n, op in ops:
        if op == "M":
            coord[si:si + n] = np.arange(rp, rp + n)
            rp += n
            si += n
        elif op == "I":
            si += n
        else:
            rp += n
    ok = np.zeros(L, dtype=bool)
    inside = (coord >= 0) & (coord < ref.n)
    ok[inside] = (ref.mask[coord[inside]] >> read[inside]) & 1 != 0
    loci = set()
    for w in range(0, L - l_seed + 1, l_overlap):
        c = coord[w:w + l_seed]
        if ok[w:w + l_seed].all() and (np.diff(c) == 1).all():
            loci.add(int(c[0]) - w)
    got = [d for d in (lv_distance(ref, read, q, k) for q in loci if q >= 0)
           if d is not None]
    return min(got) if got else None


def _seq_qual(read: np.ndarray, qual: str, strand: int):
    if strand:
        return _LUT[revcomp(read)].tobytes().decode(), qual[::-1]
    return _LUT[read].tobytes().decode(), qual


def xa_tag(ref: RefGenome, xa) -> str:
    if not xa:
        return ""
    out = []
    for s, p, nd in xa:
        name, local = ref.locus(p)
        out.append(f"{name},{'+-'[s]}{local},*,{nd};")
    return "\tXA:Z:" + "".join(out)


def se_line(ref: RefGenome, name, read, qual, choice) -> str:
    """The SAM line salt prints for an ungapped choice (or unmapped)."""
    if choice is None:
        return "\t".join([name, "4", "*", "0", "0", "*", "*", "0", "0",
                          _LUT[read].tobytes().decode(), qual])
    s, pos, _nd, mapq, xa = choice
    seq, q = _seq_qual(read, qual, s)
    strand_read = revcomp(read) if s else read
    L = len(read)
    rname, local = ref.locus(pos)
    return ("\t".join([name, str(16 if s else 0), rname, str(local),
                       str(mapq), f"{L}M", "*", "0", "0", seq, q])
            + xa_tag(ref, xa) + md_nm_xv(ref, pos, strand_read, [(L, "M")]))


class Record:
    """The fields of one SAM line, or None fields when it does not parse.
    `at` is the genome position of its RNAME and POS in `ref` (POS - 1
    where RNAME is no contig of it, or where no `ref` is given)."""

    def __init__(self, line: str, ref: RefGenome = None):
        f = line.rstrip("\n").split("\t")
        self.ok = len(f) >= 11
        if not self.ok:
            return
        self.fields = f
        self.qname, self.rname, self.cigar = f[0], f[2], f[5]
        self.rnext, self.seq, self.qual = f[6], f[9], f[10]
        try:
            self.flag, self.pos, self.mapq = int(f[1]), int(f[3]), int(f[4])
            self.pnext, self.tlen = int(f[7]), int(f[8])
        except ValueError:
            self.ok = False
            return
        at = ref.at(self.rname, self.pos) if ref is not None else None
        self.at = self.pos - 1 if at is None else at
        self.tags = {t[:2]: t[5:] for t in f[11:] if len(t) > 5}
        self.tag_text = "".join("\t" + t for t in f[11:] if t[:2] != "XA")
        self.ops = parse_cigar(self.cigar) if self.cigar != "*" else None

    def clips(self):
        lead = self.ops[0][0] if self.ops[0][1] == "S" else 0
        tail = self.ops[-1][0] if self.ops[-1][1] == "S" else 0
        return lead, tail


def pair_tlen(a: Record, b: Record, min_tlen: int, max_tlen: int) -> int:
    """sam.c alnpe_sam's template length of the pair of read 1's record a
    and read 2's record b, both mapped (with its quirk: a's aligned end
    less b's clip when a lies right of b), 0 when out of the pair bounds
    or on two contigs."""
    if a.rname != b.rname:
        return 0
    _la, ta = a.clips()
    lb, tb = b.clips()
    L = len(a.seq)
    if a.pos < b.pos:
        t = b.pos + (L - 1 - tb) - lb + 1 - a.pos
    else:
        t = a.pos + (L - 1 - ta) - lb + 1 - b.pos
    t &= 0xFFFFFFFF
    return t if min_tlen <= t <= max_tlen else 0


class Judge:
    """Counts the faults of the records of checked reads against the
    reference.  `max_diff` and `gap_k` are the ungapped and gapped limits
    of the configuration's SE aligner (a PE end keeps max_diff as its
    gapped limit, alnse.c:1027); `min_tlen`, `max_tlen` its pair bounds;
    `k_hits`, `max_hits` the width of its hit lists and XA; `l_seed`,
    `l_overlap`, `max_seed` its seeding."""

    def __init__(self, ref: RefGenome, device, max_diff=3, gap_k=10,
                 k_hits=8, max_hits=5, min_tlen=250, max_tlen=550,
                 l_seed=25, l_overlap=25, max_seed=50):
        self.ref = ref
        self.l_seed = l_seed
        self.l_overlap = l_overlap
        self.max_seed = max_seed
        self.device = device
        self.max_diff = max_diff
        self.gap_k = gap_k
        self.k_hits = k_hits
        self.max_hits = max_hits
        self.min_tlen = min_tlen
        self.max_tlen = max_tlen
        self.fields_wrong = 0
        self.hits_wrong = 0
        self.repeat_hits_wrong = 0
        self.wrong = set()
        self.fault_names = set()
        self.checked = 0
        self.in_repeats = 0
        self.rescue_checked = 0
        self.examples: List[str] = []
        self.repeat_examples: List[str] = []

    def _fault(self, kind: str, name: str, why: str,
               repeat: bool = False) -> None:
        self.fault_names.add(name)
        if kind == "hits" and repeat:
            self.repeat_hits_wrong += 1
            if len(self.repeat_examples) < 8:
                self.repeat_examples.append(f"repeat {name}: {why}")
            return
        self.wrong.add(name)
        if kind == "fields":
            self.fields_wrong += 1
        else:
            self.hits_wrong += 1
        if len(self.examples) < 8:
            self.examples.append(f"{kind} {name}: {why}")

    def repeats(self, reads: np.ndarray) -> np.ndarray:
        """Whether each read (R, L) lies in repeats: one of its seeds
        occurs more than max_seed times."""
        occ = seed_occurrences(self.ref, reads, self.l_seed, self.l_overlap,
                               self.device)
        rep = occ.reshape(len(reads), -1).max(1) > self.max_seed
        self.in_repeats += int(rep.sum())
        return rep

    # ---- checks of one record against the genome ----
    def _fields(self, rec: Record, name, read, qual) -> Optional[str]:
        """Why a record contradicts the genome or the read, or None."""
        if not rec.ok or rec.qname != name:
            return "missing or malformed record"
        L = len(read)
        strand = 1 if rec.flag & 16 else 0
        seq, q = _seq_qual(read, qual, strand)
        if rec.seq != seq or rec.qual != q:
            return "SEQ/QUAL are not the read on its strand"
        if rec.flag & 4:
            return None
        if self.ref.at(rec.rname, rec.pos) is None:
            return f"locus {rec.rname}:{rec.pos} outside the genome"
        if rec.ops is None or sum(n for n, op in rec.ops if op in "MIS") != L:
            return f"CIGAR {rec.cigar} does not cover the read"
        sread = revcomp(read) if strand else read
        want = md_nm_xv(self.ref, rec.at, sread, rec.ops)
        if rec.tag_text != want:
            return f"tags {rec.tag_text!r} != {want!r}"
        return None

    def _xa_counts(self, rec: Record, read) -> Optional[str]:
        for ent in filter(None, rec.tags.get("XA", "").split(";")):
            chrom, sp, _cig, nd = ent.split(",")
            s, p = (1 if sp[0] == "-" else 0), int(sp[1:]) - 1
            at = self.ref.at(chrom, p + 1)
            got = self.ref.mismatches(revcomp(read) if s else read,
                                      p if at is None else at)
            if chrom not in self.ref.contig or got != int(nd):
                return f"XA {ent} reads {got} mismatches"
        return None

    def _cost(self, rec: Record, read) -> int:
        """SNP-aware edit cost of a mapped record's alignment."""
        lead, _tail = rec.clips()
        sread = revcomp(read) if rec.flag & 16 else read
        return cigar_cost(self.ref, rec.at, sread[lead:],
                          [o for o in rec.ops if o[1] != "S"])

    def _gapped_ok(self, rec: Record, read, locus: int, strand: int,
                   limit: int) -> Optional[str]:
        """A read with no ungapped hit: mapped no worse than its true
        locus allows, within the gapped limit; left unmapped only where
        the true alignment costs more than the limit or holds no exact
        seed (l_seed matching bases in a row), which salt needs to find
        a locus at all."""
        best = seeded_best(self.ref, revcomp(read) if strand else read,
                           locus, self.l_seed, self.l_overlap, limit)
        if best is None:
            best = limit + 1
        if rec.flag & 4:
            return (f"unmapped, a seeded locus at distance {best}"
                    if best <= limit else None)
        cost = self._cost(rec, read)
        if cost > limit or cost > best or rec.clips() != (0, 0):
            return f"gapped {rec.cigar} cost {cost}, a seeded locus at distance {best}"
        return None

    def check_se(self, lines, names, reads, quals, loci, reverse) -> None:
        """SE records of reads (R, L) with their truth."""
        hits = exhaustive_hits(self.ref, reads, self.max_diff, self.device)
        rep = self.repeats(reads)
        for i, line in enumerate(lines):
            self.checked += 1
            rec = Record(line, self.ref)
            why = self._fields(rec, names[i], reads[i], quals[i])
            if why is None and rec.ok and not rec.flag & 4 and rec.ops \
                    and rec.cigar == f"{len(reads[i])}M" \
                    and self.ref.mismatches(
                        revcomp(reads[i]) if rec.flag & 16 else reads[i],
                        rec.at) <= self.max_diff:
                why = self._xa_counts(rec, reads[i])
            if why:
                self._fault("fields", names[i], why)
            choice = salt_choice(hits[i], self.max_diff, self.k_hits,
                                 self.max_hits)
            if choice is not None:
                want = se_line(self.ref, names[i], reads[i], quals[i], choice)
                why = None if line == want else f"{line!r} != {want!r}"
            elif not rec.ok or (rec.ops is None and not rec.flag & 4):
                why = "malformed record"
            else:
                why = self._gapped_ok(rec, reads[i], int(loci[i]),
                                      int(reverse[i]), self.gap_k)
            if why:
                self._fault("hits", names[i], why, repeat=bool(rep[i]))

    # ---- pairs ----
    def _mate_fields(self, recs) -> Optional[str]:
        for i in (0, 1):
            r, m = recs[i], recs[1 - i]
            if not r.flag & 1 or bool(r.flag & 0x40) != (i == 0) \
                    or bool(r.flag & 0x80) != (i == 1):
                return "pair flags"
            if bool(r.flag & 8) != bool(m.flag & 4):
                return "mate-unmapped flag"
            if not m.flag & 4:
                if bool(r.flag & 0x20) != bool(m.flag & 0x10):
                    return "mate-reverse flag"
                want = "=" if r.flag & 4 or r.rname == m.rname else m.rname
                if r.rnext != want or r.pnext != m.pos:
                    return f"mate fields {r.rnext}:{r.pnext} != {want}{m.pos}"
                if r.flag & 4 and (r.rname != m.rname or r.pos != m.pos):
                    return "unmapped end not placed at its mate"
            elif r.rnext != "*" or r.pnext != 0:
                return "mate fields of an unmapped mate"
        a, b = recs
        t = 0 if (a.flag & 4 or b.flag & 4) else \
            pair_tlen(a, b, self.min_tlen, self.max_tlen)
        for i in (0, 1):
            r, m = recs[i], recs[1 - i]
            want = 0 if t == 0 else (-t if r.pos >= m.pos else t)
            if r.tlen != want or bool(r.flag & 2) != (t != 0):
                return f"TLEN {r.tlen} / proper flag, expected {want}"
        return None

    def _window_of(self, rec: Record, L: int):
        """The rescue window next to a mapped record, for its mate."""
        return rescue_window(rec.at, 1 if rec.flag & 16 else 0, L, L,
                             self.min_tlen, self.max_tlen, self.ref.n)

    def _pe_end_ok(self, recs, e: int, reads, loci, reverse,
                   mate_hits) -> Optional[str]:
        """An end with no ungapped hit.  Where a gapped alignment within
        the PE limit (max_diff) holds a seed, it is mapped, and no worse
        than that unless rescue placed it next to its mate.  Where its
        mate sits at the mate's own unique locus and the end's true
        alignment lies in the rescue window there with a score that
        passes the rescue's filter, it is mapped in that window: by the
        SE stage within max_diff, or by rescue with a score no lower than
        that alignment's."""
        rec, mate = recs[e], recs[1 - e]
        read, L = reads[e], reads.shape[-1]
        strand = int(reverse[e])
        sread = revcomp(read) if strand else read
        in_win = None
        if not mate.flag & 4:
            a, b, _s = self._window_of(mate, L)
            in_win = (not rec.flag & 4) and a <= rec.at <= b
        best = seeded_best(self.ref, sread, int(loci[e]), self.l_seed,
                           self.l_overlap, self.max_diff)
        if best is not None and best <= self.max_diff:
            if rec.flag & 4:
                return f"end {e + 1} unmapped, a seeded locus at distance {best}"
            cost = self._cost(rec, read)
            if not in_win and (cost > best or rec.clips() != (0, 0)):
                return (f"end {e + 1} {rec.cigar} cost {cost} outside its "
                        f"mate's window, a seeded locus at distance {best}")
        m = 1 - e
        uniq = mate_hits[0] + mate_hits[1]
        ms = int(reverse[m])
        if len(uniq) != 1 or mate.flag & 4 or uniq[0][0] != int(loci[m]) \
                or (0 if mate_hits[0] else 1) != ms \
                or (1 if mate.flag & 16 else 0, mate.at) != (ms, int(loci[m])):
            return None
        a, b, want_strand = rescue_window(int(loci[m]), ms, L, L,
                                          self.min_tlen, self.max_tlen,
                                          self.ref.n)
        _d, p0, ops, _run = best_near(self.ref, sread, int(loci[e]))
        span = sum(n for n, op in ops if op in "MD")
        bound = rescue_bound(self.ref, p0, sread, ops)
        if want_strand != strand or p0 < a or p0 + span - 1 > b \
                or bound < SW_FILTER_DIST:
            return None
        self.rescue_checked += 1
        if rec.flag & 4:
            return (f"end {e + 1} unmapped, its true alignment scores "
                    f"{bound} in the rescue window [{a}, {b}]")
        if in_win and rec.clips() == (0, 0) \
                and self._cost(rec, read) <= self.max_diff:
            return None         # the SE stage's gapped alignment, paired
        got = sw_score(self.ref, rec.at,
                       revcomp(read) if rec.flag & 16 else read, rec.ops)
        if not in_win or got < bound:
            return (f"end {e + 1} at {rec.at} {rec.cigar} scores {got}; "
                    f"its true alignment at {p0} scores {bound} in the "
                    f"rescue window [{a}, {b}]")
        return None

    def check_pe(self, pair_lines, names, reads, quals, loci, reverse) -> None:
        """PE records: pair_lines[i] = (read 1 line, read 2 line); reads
        (2, R, L), loci and reverse (2, R)."""
        R, L = reads.shape[1], reads.shape[-1]
        flat = reads.reshape(2 * R, -1)
        hits = exhaustive_hits(self.ref, flat, self.max_diff, self.device)
        rep = self.repeats(flat)
        for i in range(R):
            self.checked += 1
            recs = [Record(x, self.ref) for x in pair_lines[i]]
            why = None
            for e in (0, 1):
                why = why or self._fields(recs[e], names[i], reads[e, i],
                                          quals[i])
            why = why or self._mate_fields(recs)
            if why:
                self._fault("fields", names[i], why)
            why = None
            repeat = bool(rep[i] or rep[R + i])
            if not all(r.ok for r in recs):
                self._fault("hits", names[i], "malformed record", repeat)
                continue
            h = [hits[i], hits[R + i]]
            for e in (0, 1):
                if (h[e][0] or h[e][1]) and recs[e].flag & 4:
                    why = f"end {e + 1} unmapped with an ungapped hit"
            uniq = [h[e][0] + h[e][1] for e in (0, 1)]
            if why is None and len(uniq[0]) == 1 and len(uniq[1]) == 1:
                want = [(0 if h[e][0] else 1, uniq[e][0][0]) for e in (0, 1)]
                a, b = want[0][1], want[1][1]
                span = (max(a, b) + L - min(a, b))
                if self.min_tlen <= span <= self.max_tlen and \
                        want[0][0] != want[1][0]:
                    got = [(1 if r.flag & 16 else 0, r.at) for r in recs]
                    if got != want or any(r.cigar != f"{L}M" for r in recs):
                        why = f"pair at {got}, its unique loci are {want}"
            for e in (0, 1):
                if why is None and not (h[e][0] or h[e][1]):
                    why = self._pe_end_ok(recs, e, reads[:, i], loci[:, i],
                                          reverse[:, i], h[1 - e])
            if why:
                self._fault("hits", names[i], why, repeat)

    def numbers(self) -> Dict[str, int]:
        """The numbers a cell's limits may name."""
        return {"fields_wrong": self.fields_wrong,
                "hits_wrong": self.hits_wrong,
                "records_wrong": len(self.wrong)}

    def reported(self) -> Dict[str, int]:
        """What the check saw besides: not held to a limit."""
        return {"repeat_hits_wrong": self.repeat_hits_wrong,
                "reads_in_repeats": self.in_repeats,
                "rescue_checked": self.rescue_checked}


# ---- the reference in the program's place (the control) ----

def aligned_se(ref: RefGenome, names, reads, quals, loci, reverse, max_diff,
               gap_k, device, k_hits=8, max_hits=5) -> List[str]:
    """SE lines written by the reference itself: salt's choice over the
    exhaustive ungapped loci, else the best alignment near the read's
    true locus within gap_k, else unmapped."""
    hits = exhaustive_hits(ref, reads, max_diff, device)
    out = []
    for i in range(len(reads)):
        choice = salt_choice(hits[i], max_diff, k_hits, max_hits)
        if choice is not None:
            out.append(se_line(ref, names[i], reads[i], quals[i], choice))
            continue
        s = int(reverse[i])
        sread = revcomp(reads[i]) if s else reads[i]
        d, pos, ops, _run = best_near(ref, sread, int(loci[i]))
        if d > gap_k:
            out.append(se_line(ref, names[i], reads[i], quals[i], None))
            continue
        seq, q = _seq_qual(reads[i], quals[i], s)
        cig = "".join(f"{n}{op}" for n, op in ops)
        rname, local = ref.locus(pos)
        out.append("\t".join([names[i], str(16 if s else 0), rname,
                              str(local), "0", cig, "*", "0", "0", seq, q])
                   + md_nm_xv(ref, pos, sread, ops))
    return out


def aligned_pe(ref: RefGenome, names, reads, quals, loci, reverse, max_diff,
               gap_k, device, min_tlen=250, max_tlen=550):
    """PE line pairs written by the reference itself: each end as
    aligned_se places it, the pair's fields as sam.c alnpe_sam sets
    them (RNEXT the mate's contig where the two differ)."""
    R = reads.shape[1]
    ends = [aligned_se(ref, names, reads[e], quals, loci[e], reverse[e],
                       max_diff, gap_k, device) for e in (0, 1)]
    out = []
    for i in range(R):
        f = [ends[e][i].split("\t") for e in (0, 1)]
        recs = [Record(ends[e][i]) for e in (0, 1)]
        mapped = [not r.flag & 4 for r in recs]
        t = pair_tlen(recs[0], recs[1], min_tlen, max_tlen) if all(mapped) else 0
        pair = []
        for e in (0, 1):
            r, m = recs[e], recs[1 - e]
            flag = 1 | (0x40 if e == 0 else 0x80) | (r.flag & 0x14)
            flag |= (0 if mapped[1 - e] else 8) | (0x20 if m.flag & 16 else 0)
            flag |= 2 if t else 0
            g = list(f[e])
            g[1] = str(flag)
            if not mapped[e] and mapped[1 - e]:
                g[2], g[3], g[4], g[5] = m.rname, str(m.pos), "255", "*"
            if mapped[1 - e]:
                same = not mapped[e] or r.rname == m.rname
                g[6], g[7] = "=" if same else m.rname, str(m.pos)
            g[8] = str(0 if t == 0 else (-t if r.pos >= m.pos else t))
            pair.append("\t".join(g))
        out.append(pair)
    return out
