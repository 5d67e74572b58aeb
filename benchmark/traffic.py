"""Read traffic: wgsim's model, generated in memory from the run's seed.

A traffic mix is a JSON file of parameters (benchmark/traffic/<mix>.json)
that this one generator reads:

  mode            "se" or "pe"
  read_len        bases a read (both ends of a pair)
  err_rate        wgsim -e: each base becomes (c + 1) & 3 (wgsim's
                  recurrent sequencing error)
  mut_rate        wgsim -r: novel mutations of the sample, a base
  indel_frac      wgsim -R: the share of them that are indels
  indel_extend    wgsim -X: the chance an indel grows by one more base
  snp_alt_prob    the chance a haplotype carries a known SNP's alt allele
  dist, std_dev   wgsim -d, -s: the insert of a pair (pe)
  per_call        reads (se) or pairs (pe) handed to the aligner a call
  check_sample    reads (se) or pairs (pe) the reference checks a run

and, optionally, distortions drawn from a stream of their own (a mix
without them has the same reads):

  burst_frac, burst_subs   the share of reads (pe: of ends) that carry
                           burst_subs more substitutions, at distinct
                           positions
  far_frac, far_dist       the share of pairs whose insert is drawn around
                           far_dist (same std_dev) instead (pe)
  aln_args                 options of the port's `aln` for this mix (read
                           by benchmark/run.py, not here)

The sample (two haplotypes of the configuration's genome, with its
mutations) is made from the seed once a run; each call's reads are made
from (seed, call index).  Reads lie wholly on non-N sequence of a
haplotype, drawn uniformly, on both strands; a read (se) or a template
(pe) lies on one contig.  Each read keeps its truth (`Call.locus`,
`Call.reverse`, in the coordinates of the contigs laid end to end).
"""

from __future__ import annotations

import numpy as np

_LUT = np.frombuffer(b"ACGTN", dtype=np.uint8)
_COMP = np.array([3, 2, 1, 0, 4], dtype=np.uint8)


def revcomp(codes: np.ndarray) -> np.ndarray:
    return _COMP[codes[..., ::-1]]


def _rng(*key) -> np.random.Generator:
    return np.random.default_rng([int(k) % (1 << 64) for k in key])


class Haplotype:
    """A mutated copy of the genome: codes and, for every base, the
    reference coordinate it came from (an inserted base takes its
    anchor's); `contig_of`, the genome's map from coordinates to contigs
    where it has more than one contig."""

    def __init__(self, codes: np.ndarray, ref_coord: np.ndarray,
                 contig_of=None):
        self.codes = codes
        self.ref_coord = ref_coord
        self.contig_of = contig_of
        # starts of windows free of N, by prefix sums of N counts
        self.n_prefix = np.concatenate(
            [[0], np.cumsum(codes >= 4, dtype=np.int64)])


def make_sample(genome, mix: dict, seed: int):
    """The sample's two haplotypes: known SNP alleles carried with
    probability snp_alt_prob each, and novel mutations as wgsim draws
    them (substitutions, deletions and insertions of 1-4 bases; a
    third homozygous, the rest on one haplotype)."""
    rng = _rng(seed, 1)
    g = genome.codes
    n = len(g)
    n_mut = int(rng.binomial(n, mix["mut_rate"]))
    mpos = np.unique(rng.integers(0, n, n_mut))
    mpos = mpos[g[mpos] < 4]
    m = len(mpos)
    kind = rng.random(m)
    is_indel = kind < mix["indel_frac"]
    is_del = is_indel & (rng.random(m) < 0.5)
    is_ins = is_indel & ~is_del
    hom = rng.random(m) < 1 / 3
    which = rng.integers(0, 2, m)
    sub_alt = ((g[mpos].astype(np.int64) + rng.integers(1, 4, m)) & 3).astype(np.uint8)
    # lengths: one base, and one more with probability indel_extend each
    ext = rng.geometric(1.0 - mix["indel_extend"], m)
    ins_len = np.minimum(ext, 4)
    ins_bases = rng.integers(0, 4, (m, 4)).astype(np.uint8)
    contig_of = genome.contig_of if len(genome.contig_names) > 1 else None
    haps = []
    for h in (0, 1):
        on = hom | (which == h)
        codes = g.copy()
        if len(genome.snp_pos):
            carry = rng.random(len(genome.snp_pos)) < mix["snp_alt_prob"]
            codes[genome.snp_pos[carry]] = genome.snp_alt[carry]
        sub = on & ~is_indel
        codes[mpos[sub]] = sub_alt[sub]
        count = np.ones(n, dtype=np.int64)
        for p, ln in zip(mpos[on & is_del].tolist(), ext[on & is_del].tolist()):
            count[p:p + ln] = 0
        ins = on & is_ins & (count[mpos] > 0)
        count[mpos[ins]] += ins_len[ins]
        ref_coord = np.repeat(np.arange(n, dtype=np.int64), count)
        out = np.repeat(codes, count)
        # an insertion's bases follow its anchor base
        first = np.concatenate([[0], np.cumsum(count)[:-1]])
        for p, ln, bases in zip(mpos[ins].tolist(), ins_len[ins].tolist(),
                                ins_bases[ins]):
            out[first[p] + 1:first[p] + 1 + ln] = bases[:ln]
        haps.append(Haplotype(out, ref_coord, contig_of))
    return haps


def _starts(hap: Haplotype, span: np.ndarray, rng) -> np.ndarray:
    """A start for each template length in `span`, uniform over the
    windows of the haplotype that hold no N and lie on one contig."""
    out = np.empty(len(span), dtype=np.int64)
    todo = np.arange(len(span))
    n = len(hap.codes)
    while len(todo):
        s = rng.integers(0, n - span[todo] + 1)
        ok = hap.n_prefix[s + span[todo]] == hap.n_prefix[s]
        if hap.contig_of is not None:
            ok &= hap.contig_of(hap.ref_coord[s]) == \
                hap.contig_of(hap.ref_coord[s + span[todo] - 1])
        out[todo[ok]] = s[ok]
        todo = todo[~ok]
    return out


def _errors(reads: np.ndarray, rate: float, rng) -> np.ndarray:
    m = rng.random(reads.shape) < rate
    return np.where(m, (reads + 1) & 3, reads).astype(np.uint8)


class Call:
    """One call's reads: codes (n, L) for SE, or (2, n, L) for read 1 and
    read 2 of PE pairs, and each read's truth: `locus`, the reference
    coordinate of the first base of the haplotype window it was read
    from, and `reverse`, whether the read is that window's reverse
    complement."""

    def __init__(self, codes, names, locus, reverse):
        self.codes = codes
        self.names = names
        self.locus = locus
        self.reverse = reverse


def _bursts(reads: np.ndarray, mix: dict, rng) -> np.ndarray:
    frac, k = mix.get("burst_frac", 0.0), int(mix.get("burst_subs", 0))
    if not frac or not k:
        return reads
    flat = reads.reshape(-1, reads.shape[-1]).copy()
    rows = np.nonzero(rng.random(len(flat)) < frac)[0]
    at = np.argsort(rng.random((len(rows), flat.shape[1])), 1)[:, :k]
    r = rows[:, None]
    flat[r, at] = ((flat[r, at].astype(np.int64)
                    + rng.integers(1, 4, at.shape)) & 3).astype(np.uint8)
    return flat.reshape(reads.shape)


def make_call(haps, mix: dict, seed: int, call: int) -> Call:
    rng = _rng(seed, 2, call)
    extra = _rng(seed, 4, call)      # the mix's distortions
    L = int(mix["read_len"])
    n = int(mix["per_call"])
    hap_of = rng.integers(0, 2, n)
    pe = mix["mode"] == "pe"
    if pe:
        span = np.maximum(np.rint(rng.normal(mix["dist"], mix["std_dev"], n))
                          .astype(np.int64), L)
        if mix.get("far_frac", 0.0):
            far = extra.random(n) < mix["far_frac"]
            span[far] = np.maximum(np.rint(extra.normal(
                mix["far_dist"], mix["std_dev"], int(far.sum())))
                .astype(np.int64), L)
    else:
        span = np.full(n, L, dtype=np.int64)
    locus = np.empty((2, n), dtype=np.int64)
    ends = np.empty((2, n, L), dtype=np.uint8)
    for h in (0, 1):
        sel = np.nonzero(hap_of == h)[0]
        hp = haps[h]
        s = _starts(hp, span[sel], rng)
        e = s + span[sel] - L
        locus[0, sel] = hp.ref_coord[s]
        locus[1, sel] = hp.ref_coord[e]
        ends[0, sel] = hp.codes[s[:, None] + np.arange(L)]
        ends[1, sel] = hp.codes[e[:, None] + np.arange(L)]
    names = [f"c{call}_{i}" for i in range(n)]
    if not pe:
        rev = rng.random(n) < 0.5
        reads = np.where(rev[:, None], revcomp(ends[0]), ends[0])
        return Call(_bursts(_errors(reads, mix["err_rate"], rng), mix, extra),
                    names, locus[0], rev)
    # FR pairs: the left end forward, the right end reverse-complemented;
    # a coin decides which end is read 1
    fwd, back = ends[0], revcomp(ends[1])
    swap = rng.random(n) < 0.5
    r1 = np.where(swap[:, None], back, fwd)
    r2 = np.where(swap[:, None], fwd, back)
    codes = _bursts(_errors(np.stack([r1, r2]), mix["err_rate"], rng), mix,
                    extra)
    loc = np.stack([np.where(swap, locus[1], locus[0]),
                    np.where(swap, locus[0], locus[1])])
    return Call(codes, names, loc, np.stack([swap, ~swap]))


def records(call: Call, record_type):
    """The call's reads as the aligner's records: a list (se) or the
    lists of read 1 and read 2 (pe)."""
    L = call.codes.shape[-1]
    qual = "2" * L       # wgsim's constant quality at -e 0.02 (Q17)

    def one(codes):
        raw = _LUT[codes].tobytes().decode("ascii")
        return [record_type(nm, None, raw[i * L:(i + 1) * L], qual)
                for i, nm in enumerate(call.names)]

    if call.codes.ndim == 2:
        return one(call.codes)
    return one(call.codes[0]), one(call.codes[1])
