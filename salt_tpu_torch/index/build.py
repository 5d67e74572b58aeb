"""SNP-aware index construction (host side).

Replaces the reference's `salt-idx` (Index_src/index1.c) with a
vectorized numpy build producing device-friendly arrays:

  * `pac`      uint8[L]    2-bit genome codes, N -> deterministic random
                           (Index_src/bntseq.c:178,222: srand48(11))
  * `mixref`   uint8[L]    4-bit one-hot allele mask per position with SNP
                           alternates OR-ed in (Index_src/mixRef.c:131-149)
  * `lkt`      uint32[4^12+1]  12-mer prefix-sum lookup table
                           (Index_src/LookUpTable.c:66-148, incl. the
                           A-padded tail quirk)
  * C-part BWT (bwt syms with in-band sentinel, L2 counts, full SA with
    the reference's sa[0] = 0xFFFFFFFF quirk, bwt.c:66)
  * R-part local-pattern text (localPattern.c ss_core_alt semantics),
    backward-search BWT, and a per-rank genome-coordinate table that
    reproduces Rbwt_back_bwt_sa (rbwt.c:316-333) with a single gather.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from ..constants import (
    C_SENTINEL,
    MAX_LOOKUP_LEN,
    NST_NT4_TABLE,
    NT5_4BIT_TABLE,
    R_SENTINEL,
    UINT32_MAX,
    WIN_MAX_SNP_NUM,
    BNS_RANDOM_SEED,
    DEFAULT_L_SEED,
)
from ..io.fasta import read_records
from ..io.snp import SnpBlock, read_snp_blocks, allele_codes
from ..utils.alloc import tune_allocator
from ..utils.rand48 import Rand48
from .suffix import bwt_from_sa, suffix_array

tune_allocator()  # genome-scale numpy temporaries: see utils/alloc.py

# elements (segments, for the R coordinate fill) a step of the loops that
# would otherwise hold int64 temporaries of the whole genome or pattern
# text at once (tens of GB at 3.1 G bases)
CHUNK = 1 << 20


@dataclass
class Contig:
    name: str
    anno: str
    offset: int
    length: int
    n_ambs: int = 0


@dataclass
class SaltIndex:
    """All arrays needed at alignment time."""

    l_seed: int
    contigs: List[Contig]
    l_pac: int

    pac: np.ndarray        # uint8[L] codes 0..3 (N randomized)
    mixref: np.ndarray     # uint8[L] one-hot nibbles
    lkt: np.ndarray        # uint32[4^12 + 1]

    # C part (genome BWT)
    cbwt: np.ndarray       # uint8[L+1], 0..3 + C_SENTINEL
    c_l2: np.ndarray       # uint32[5]: L2[c] = # chars < c (BWA bwt->L2)
    c_primary: int
    csa: np.ndarray        # uint32[L+1] full SA; csa[0] = 0xFFFFFFFF quirk

    # R part (local-pattern BWT, backward search flavor)
    r_text_len: int
    rbwt: np.ndarray       # uint8[T+1], 0..4 + R_SENTINEL
    r_cumfreq: np.ndarray  # uint32[6]: cumulativeFreq[c] = # chars < c
    r_primary: int
    r_coord: np.ndarray    # uint32[T+1] genome coord per rank (or UINT32_MAX)
    # exact 12-mer jump table for the R text (sp/ep per kmer) — a
    # device-side addition (no reference counterpart): skips 12 of the
    # l_seed LF steps per seed.  Exact-parity safe: equals 12 backward
    # LF steps from the full interval.
    r_lkt_sp: np.ndarray = None   # uint32[4^12]
    r_lkt_ep: np.ndarray = None   # uint32[4^12]

    # sampled-SA locate support (device_index.build_sampled_sa): the
    # coordinate base per '#' rank (coord = base + LF-walk steps) and
    # the walk bound (longest local-pattern segment)
    sharp_bases: Optional[np.ndarray] = None   # uint32 [n_sharp]
    max_seg_len: int = 0

    # kept for debugging / tests
    r_text: Optional[np.ndarray] = None

    def contig_arrays(self):
        offs = np.array([c.offset for c in self.contigs], dtype=np.int64)
        lens = np.array([c.length for c in self.contigs], dtype=np.int64)
        return offs, lens


def index_from_arrays(src) -> SaltIndex:
    """A SaltIndex made from the fields of `src`, any object that carries
    SaltIndex's attributes (an index built elsewhere, or loaded by other
    code): arrays are taken as numpy arrays without copying, contigs are
    rebuilt from their five fields."""
    kw = {}
    for f in dataclasses.fields(SaltIndex):
        v = getattr(src, f.name)
        if f.name == "contigs":
            v = [Contig(c.name, c.anno, int(c.offset), int(c.length),
                        int(c.n_ambs)) for c in v]
        elif v is not None and not isinstance(v, (int, np.integer)):
            v = np.asarray(v)
        kw[f.name] = v
    return SaltIndex(**kw)


def _counts(codes: np.ndarray, n: int) -> np.ndarray:
    """np.bincount(codes, minlength=n)[:n], CHUNK codes at a time."""
    out = np.zeros(n, dtype=np.int64)
    for s0 in range(0, len(codes), CHUNK):
        out += np.bincount(codes[s0 : s0 + CHUNK], minlength=n)[:n]
    return out


def encode_seq(seq: str) -> np.ndarray:
    """ASCII -> 2-bit-ish codes (A0 C1 G2 T3, '-'=5, other=4)."""
    return NST_NT4_TABLE[np.frombuffer(seq.encode("latin1"), dtype=np.uint8)]


def _randomize_ns(codes: np.ndarray, rng: Rand48) -> np.ndarray:
    out = codes.copy()
    amb = np.nonzero(codes >= 4)[0]
    if len(amb):
        vals = rng.lrand48_many(len(amb))
        out[amb] = np.array(vals, dtype=np.uint64).astype(np.uint8) & 3
    return out


def build_lookup_table(pac: np.ndarray, k: int = MAX_LOOKUP_LEN) -> np.ndarray:
    """12-mer prefix-sum table with the reference's tail quirk: after the
    last full window it keeps left-shifting (A-padding) k more times,
    counting each shifted value (LookUpTable.c:114-135)."""
    n_item = (1 << (2 * k)) + 1
    l_ref = len(pac)
    if l_ref < k:
        raise ValueError("reference shorter than lookup k-mer")
    # rolling big-endian base-4 values of all full windows via k shifted
    # adds (4^12 < 2^32 so the whole key fits uint32; a matmul over a
    # sliding_window_view hits BLAS's strided slow path and is ~40x
    # slower at genome scale)
    n_win = l_ref - k + 1
    kmers = pac[:n_win].astype(np.uint32)
    for j in range(1, k):
        np.left_shift(kmers, 2, out=kmers)
        np.add(kmers, pac[j : j + n_win], out=kmers)
    # chunked bincount: avoids materializing an int64 copy of the whole
    # kmer stream (8 B/base of transient peak RSS at genome scale)
    counts = np.zeros(n_item, dtype=np.uint32)
    CH = 1 << 26
    for s0 in range(0, n_win, CH):
        ck = np.bincount(
            kmers[s0 : s0 + CH].astype(np.int64), minlength=n_item - 1
        )
        counts[1 : 1 + len(ck)] += ck.astype(np.uint32)
    # tail: continue shifting in zeros k times from the last full window
    mask = n_item - 2
    it = int(kmers[-1])
    for _ in range(k):
        it = (it << 2) & mask
        counts[it + 1] += 1
    return np.cumsum(counts, dtype=np.uint32).astype(np.uint32)


def lkt_lookup(lkt: np.ndarray, kmer: int) -> tuple[int, int]:
    """SA interval [sp, ep] of a 12-mer (lookup.h:39-53)."""
    return int(lkt[kmer]), int(lkt[kmer + 1]) - 1


@dataclass
class _Segment:
    text_start: int     # offset of first char within the R text
    length: int
    genome_start: int   # anchor - length + 1
    record: int         # .lp record (window) index owning this segment


def _gen_local_patterns(
    contig_seqs: List[str],
    contig_names: List[str],
    blocks: List[SnpBlock],
    l_seed: int,
):
    """ss_core_alt (Index_src/localPattern.c:171-324).

    Returns (text_chars: bytes, segments: List[_Segment]).  The text starts
    with a lone '#' (first-record quirk, localPattern.c:269-271) and each
    segment is terminated by '#'.
    """
    dist = l_seed - 1
    out = bytearray()
    segments: List[_Segment] = []
    anchors: List[int] = []   # per-record (window) header anchor
    first = True
    tot_l = 0
    bi = 0
    for ci, seq in enumerate(contig_seqs):
        l = len(seq)
        if bi < len(blocks):
            blk = blocks[bi]
            bi += 1
            if blk.chrom != contig_names[ci] or len(blk.pos) == 0:
                tot_l += l
                continue
        else:
            tot_l += l
            continue
        pos = blk.pos.astype(np.int64)
        stype = blk.stype
        nsnp = len(pos)
        # ss_core_alt substitutes alleles into the contig sequence in place
        # and never restores (localPattern.c:295), so later windows see the
        # previous window's final combination at already-processed SNP
        # positions — replicated via this mutable working copy.
        work = np.asarray(seq, dtype=np.uint8).copy()
        mid = 0
        while mid < nsnp:
            # comparisons are uint32 in the reference (localPattern.c:241,
            # 255): a negative position delta wraps and fails `<= dist`
            end = mid + 1
            while end < nsnp and 0 <= pos[end] - pos[mid] <= dist:
                end += 1
            win_n = end - mid
            if win_n > WIN_MAX_SNP_NUM:
                mid += 1
                continue
            win_start = max(int(pos[mid]) - dist, 0)
            if mid > 0 and 0 <= pos[mid] - pos[mid - 1] <= dist:
                win_start = int(pos[mid - 1]) + 1
            win_end = min(int(pos[mid]) + dist, l - 1)
            anchor = int(pos[mid]) + tot_l + dist
            seg_len = win_end - win_start + 1
            alleles = [allele_codes(int(stype[j])) for j in range(mid, end)]
            counts = [len(a) for a in alleles]
            total = 1
            for c in counts:
                total *= c
            snp_abs = pos[mid:end]
            record = len(anchors)
            anchors.append(anchor)
            if first:
                out.append(ord("#"))
                first = False
            base = "ACGTN"
            for combo in range(total):
                k = combo
                f1 = 1
                for j in range(win_n):
                    f1 *= counts[j]
                    f2 = total // f1
                    ai = k // f2
                    k -= ai * f2
                    work[snp_abs[j]] = ord(base[alleles[j][ai]])
                seg_start = len(out)
                out.extend(work[win_start : win_end + 1].tobytes())
                out.append(ord("#"))
                segments.append(
                    _Segment(
                        text_start=seg_start,
                        length=seg_len,
                        # true genome start (the reference's anchor-based
                        # arithmetic would give anchor-len+1, which drifts
                        # when win_end is clamped at a contig end)
                        genome_start=tot_l + win_start,
                        record=record,
                    )
                )
            mid += 1
        tot_l += l
    return bytes(out), segments, anchors


def build_r_lkt(r_codes: np.ndarray, rsa: np.ndarray, k: int = MAX_LOOKUP_LEN):
    """Exact k-mer SA-interval table over the 5-letter local-pattern text.

    Suffix keys are the first k chars base-6 (digit = code+1, 0 pads past
    the text end), which orders identically to the suffix array at k-char
    granularity; intervals come from two vectorized searchsorteds.
    """
    T = len(r_codes)
    ext = np.zeros(T + k, dtype=np.uint32)
    ext[:T] = r_codes
    ext[:T] += 1
    # 6^12 < 2^32: the whole key space fits uint32.  Rolling Horner over
    # k shifted adds (a sliding_window_view matmul is ~40x slower).
    keys_by_pos = ext[: T + 1].copy()
    for j in range(1, k):
        np.multiply(keys_by_pos, 6, out=keys_by_pos)
        np.add(keys_by_pos, ext[j : j + T + 1], out=keys_by_pos)
    del ext
    keys_rank = keys_by_pos[rsa]                        # ascending
    del keys_by_pos

    # query keys for all 4^k k-mers, digitwise base-4 -> base-6(+1).
    # Built from two half-size tables with one broadcasted add: the naive
    # k-pass digit loop over 4^k entries is first-touch/bandwidth bound.
    def _half(n: int) -> np.ndarray:
        ms = np.arange(4 ** n, dtype=np.uint32)
        kq = np.zeros_like(ms)
        for j in range(n):
            c = (ms >> np.uint32(2 * (n - 1 - j))) & np.uint32(3)
            kq = kq * np.uint32(6) + c + np.uint32(1)
        return kq

    kh, kl = k // 2, k - (k // 2)
    hi = _half(kh) * np.uint32(6 ** kl)
    lo = _half(kl)
    kq = (hi[:, None] + lo[None, :]).ravel()
    sp = np.searchsorted(keys_rank, kq, side="left").astype(np.uint32)
    del keys_rank, kq
    # ep = sp + multiplicity - 1: a right-searchsorted is redundant since
    # the number of keys equal to kq(m) is the number of text positions
    # whose first k chars are exactly that ACGT k-mer
    if T >= k:
        n_win = T - k + 1
        kmers4 = (r_codes[:n_win] & np.uint8(3)).astype(np.uint32)
        npure = r_codes[:n_win] >= 4
        tmp = np.empty(n_win, dtype=np.uint8)
        for j in range(1, k):
            np.left_shift(kmers4, 2, out=kmers4)
            np.bitwise_and(r_codes[j : j + n_win], 3, out=tmp)
            np.add(kmers4, tmp, out=kmers4)
            np.greater_equal(r_codes[j : j + n_win], 4, out=tmp.view(bool))
            np.logical_or(npure, tmp.view(bool), out=npure)
        kmers4 = kmers4[~npure]
    else:
        kmers4 = np.zeros(0, dtype=np.uint32)
    # chunked bincount, as build_lookup_table: no int64 copy of the stream
    mult = np.zeros(4 ** k, dtype=np.uint32)
    for s0 in range(0, len(kmers4), 1 << 26):
        mult += np.bincount(kmers4[s0 : s0 + (1 << 26)],
                            minlength=4 ** k).astype(np.uint32)
    ep = sp + mult - np.uint32(1)
    return sp, ep


def build_index(
    fasta_path: str,
    snp_path: str,
    l_seed: int = DEFAULT_L_SEED,
    keep_r_text: bool = False,
    r_anchor_mode: str = "exact",
) -> SaltIndex:
    contigs = [(rec.name, rec.comment or "(null)", rec.seq)
               for rec in read_records(fasta_path)]
    blocks = list(read_snp_blocks(snp_path))
    return build_index_from_data(
        contigs, blocks, l_seed=l_seed, keep_r_text=keep_r_text,
        r_anchor_mode=r_anchor_mode,
    )


def build_index_from_data(
    contig_data,
    blocks,
    l_seed: int = DEFAULT_L_SEED,
    keep_r_text: bool = False,
    r_anchor_mode: str = "exact",
) -> SaltIndex:
    """Build the full alignment index.

    r_anchor_mode:
      * "exact" (default): R-part locate returns the true genome
        coordinate of every local-pattern position — SNP-aware seeding
        actually works.
      * "reference_compat": reproduces the reference's buggy
        '#'-anchor bookkeeping (Align_src/rbwt.c:424-475 `Rbwt_gen_sa`
        direction=-1 assigns `sharp2Ri_array[i+1] - l_alt_seq` with the
        index shifted by one window and an out-of-bounds read for the
        last segment): every segment's coordinates come out 2 too low,
        each window's last segment takes the NEXT window's anchor, and
        the text's final segment reads past the anchor array (emulated
        as 0, the observed glibc heap value).  Only useful for
        bit-parity scoring against the reference binary.
    """
    contigs: List[Contig] = []
    contig_seqs: List[np.ndarray] = []   # uint8 ASCII char arrays
    offset = 0
    for name, anno, seq in contig_data:
        # whole-genome builds pass raw uint8 char arrays to skip the
        # 1 byte/char python-str detour (3.1GB at GRCh38 scale)
        if isinstance(seq, str):
            seq = np.frombuffer(seq.encode("latin1"), dtype=np.uint8)
        else:
            seq = np.asarray(seq, dtype=np.uint8)
        contig_seqs.append(seq)
        contigs.append(
            Contig(name=name, anno=anno, offset=offset, length=len(seq))
        )
        offset += len(seq)
    l_pac = offset
    # coordinates are uint32 end to end, matching the reference's
    # bwtint_t limit (Align_src/bwt.h:41); headroom keeps pos+read_len
    # arithmetic un-wrapped for any plausible read length
    if l_pac >= 2**32 - 2**16:
        raise ValueError(
            f"genome too long for uint32 coordinates ({l_pac} bases); "
            "shard the reference (parallel/sharded.py) instead"
        )
    gchars = (contig_seqs[0] if len(contig_seqs) == 1
              else np.concatenate(contig_seqs)) if contig_seqs else \
        np.zeros(0, np.uint8)
    raw_codes = NST_NT4_TABLE[gchars]

    # --- pac with deterministic N randomization (srand48(11)) ---
    pac = _randomize_ns(raw_codes, Rand48(BNS_RANDOM_SEED))
    # count amb holes per contig for parity bookkeeping
    for ci, c in enumerate(contigs):
        seg = raw_codes[c.offset : c.offset + c.length]
        chars = gchars[c.offset : c.offset + c.length]
        amb = seg >= 4
        if amb.any():
            # runs of identical raw chars (bntseq.c:204-218)
            idx = np.nonzero(amb)[0]
            breaks = np.nonzero(
                (np.diff(idx) != 1)
                | (chars[idx[1:]] != chars[idx[:-1]])
            )[0]
            c.n_ambs = 1 + len(breaks)
    del raw_codes

    # --- mixRef (mixRef.c: FASTA chars -> nibbles, OR SNP alleles per
    #     block applied to contigs in file order, no name check) ---
    mixref = NT5_4BIT_TABLE[gchars]
    for ci, c in enumerate(contigs):
        if ci >= len(blocks):
            break
        blk = blocks[ci]
        if len(blk.pos) == 0:
            continue
        gpos = blk.pos.astype(np.int64) + c.offset
        np.bitwise_or.at(mixref, gpos, blk.stype & 15)

    # --- lookup table ---
    lkt = build_lookup_table(pac)

    # --- C part BWT + full SA ---
    csa64 = suffix_array(pac)
    cbwt, c_primary = bwt_from_sa(pac, csa64, C_SENTINEL)
    counts = _counts(pac, 4)
    c_l2 = np.zeros(5, dtype=np.uint32)
    c_l2[1:] = np.cumsum(counts).astype(np.uint32)
    # int32 SA reinterprets as uint32 zero-copy (values are positive),
    # uint32 (whole-genome u32 SA-IS) passes through; the astype on the
    # int64 path is the only transient
    if csa64.dtype == np.uint32:
        csa = csa64
    elif csa64.dtype == np.int32:
        csa = csa64.view(np.uint32)
    else:
        csa = csa64.astype(np.uint32)
    del csa64
    csa[0] = UINT32_MAX  # bwt_cal_sa sets sa[0] = -1 (bwt.c:66)

    # --- R part ---
    text_bytes, segments, anchors = _gen_local_patterns(
        contig_seqs, [c.name for c in contigs], blocks, l_seed
    )
    r_chars = np.frombuffer(text_bytes, dtype=np.uint8)
    # nst_nt5_table: ACGT->0..3, '#'->4, N->5, other->7; codes >=5 randomized
    nt5 = np.full(256, 7, dtype=np.uint8)
    for ch, code in (("A", 0), ("C", 1), ("G", 2), ("T", 3), ("#", 4), ("N", 5)):
        nt5[ord(ch)] = code
        if ch.isalpha():
            nt5[ord(ch.lower())] = code
    r_codes = nt5[r_chars]
    amb = np.nonzero(r_codes >= 5)[0]
    if len(amb):
        rng = Rand48(BNS_RANDOM_SEED)
        vals = rng.lrand48_many(len(amb))
        r_codes = r_codes.copy()
        r_codes[amb] = np.array(vals, dtype=np.uint64).astype(np.uint8) & 3
    r_text_len = len(r_codes)

    rsa64 = suffix_array(r_codes)
    rbwt, r_primary = bwt_from_sa(r_codes, rsa64, R_SENTINEL)
    r_counts = _counts(r_codes, 5)
    r_cumfreq = np.zeros(6, dtype=np.uint32)
    r_cumfreq[1:] = np.cumsum(r_counts).astype(np.uint32)

    # per-text-position genome coordinate, then gather through the SA.
    # Filled segment-parallel with one repeat/cumsum ramp a CHUNK of
    # segments (a per-segment python loop costs ~40s at 300k segments on
    # chr21 scale).
    pos2coord = np.full(r_text_len + 1, UINT32_MAX, dtype=np.uint32)
    seg_start = np.array([s.text_start for s in segments], dtype=np.int64)
    seg_len = np.array([s.length for s in segments], dtype=np.int64)
    if r_anchor_mode == "reference_compat":
        # sharp j precedes segment j (segment index == sharp index thanks
        # to the leading '#'); the reference assigns that sharp the anchor
        # of the record owning sharp j+2, minus (len_j + 1); coordinate of
        # offset o is then that value + o.
        sharp_record = np.array(
            [0] + [seg.record for seg in segments], dtype=np.int64
        )
        anchors_arr = np.asarray(anchors, dtype=np.int64)
        j = np.arange(2, len(segments) + 2)
        # arr[N] out-of-bounds reads observe 0 on the reference's heap
        a = np.where(
            j < len(sharp_record),
            anchors_arr[sharp_record[np.minimum(j, len(sharp_record) - 1)]],
            0,
        )
        value = (a - seg_len - 1) & 0xFFFFFFFF
    else:
        value = np.array([s.genome_start for s in segments], dtype=np.int64)
    for a in range(0, len(segments), CHUNK):
        sl = seg_len[a : a + CHUNK]
        ends = np.cumsum(sl)
        ramp = np.arange(int(ends[-1]), dtype=np.int64) - np.repeat(ends - sl, sl)
        tpos = np.repeat(seg_start[a : a + CHUNK], sl) + ramp
        pos2coord[tpos] = ((np.repeat(value[a : a + CHUNK], sl) + ramp)
                           & 0xFFFFFFFF).astype(np.uint32)
    r_coord = pos2coord[rsa64]
    r_lkt_sp, r_lkt_ep = build_r_lkt(r_codes, rsa64)

    # '#'-rank coordinate bases for the sampled-SA locate: within a
    # segment the coordinate is affine in the text position, so
    # coord(p) = pos2coord[sharp_pos + 1] - 1 + (p - sharp_pos).  '#'
    # ranks form the contiguous rank interval [cumfreq[4]+1,
    # cumfreq[5]+1) (the in-band sentinel is rank 0).
    sharp_lo = int(r_cumfreq[4]) + 1
    sharp_hi = int(r_cumfreq[5]) + 1
    sp = rsa64[sharp_lo:sharp_hi]
    nxt = np.minimum(sp + 1, r_text_len)
    nxt_coord = pos2coord[nxt]
    ok = (sp + 1 < r_text_len) & (nxt_coord != UINT32_MAX)
    # unreachable bases (final '#', degenerate segments) get a value
    # whose +steps stays far out of [0, l_pac] without wrapping small
    sharp_bases = np.where(
        ok, (nxt_coord.astype(np.int64) - 1) & 0xFFFFFFFF, 0x80000000
    ).astype(np.uint32)
    max_seg_len = max((seg.length for seg in segments), default=0)

    return SaltIndex(
        l_seed=l_seed,
        contigs=contigs,
        l_pac=l_pac,
        pac=pac,
        mixref=mixref,
        lkt=lkt,
        cbwt=cbwt,
        c_l2=c_l2,
        c_primary=c_primary,
        csa=csa,
        r_text_len=r_text_len,
        rbwt=rbwt,
        r_cumfreq=r_cumfreq,
        r_primary=r_primary,
        r_coord=r_coord,
        r_lkt_sp=r_lkt_sp,
        r_lkt_ep=r_lkt_ep,
        sharp_bases=sharp_bases,
        max_seg_len=max_seg_len,
        r_text=r_codes if keep_r_text else None,
    )
