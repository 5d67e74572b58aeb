"""Host-side SE alignment engine: batching, device dispatch, hit
finalization (query_set_hits semantics) and SAM record assembly.
Port of salt_tpu/pipeline/engine.py in full and in sampled suffix-array
mode, with Landau-Vishkin or Smith-Waterman (-X 1) extension.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from ..constants import (
    DEFAULT_MAX_LOCATE,
    DEFAULT_MAX_SEED,
    NST_NT4_TABLE,
    SE_MAX_N_AMBIGUOUS,
    SW_GAP_EXTEND,
    SW_GAP_OPEN,
    UINT32_MAX,
)
from ..index.build import SaltIndex
from ..io.fasta import read_records, trim_readno
from ..io.sam import build_xa, emit_se, md_nm_tags_batch, sam_header
from ..utils.metrics import count, device_trace, progress, stage, to_host

from ..ops.locate import Loci
from ..ops.lv import NT2BIT_NP, lv_cigar_batch, lv_cigar_host
from ..ops.ssw import SCORE_MAT16, ssw_align
from ..ops.sw_batch import sw_score
from .device_index import to_device_index
from .se import (
    pack_result,
    se_gapped,
    se_ungapped,
    se_ungapped_full,
    unpack_result,
)

# reads per full-width re-run: bounds its 2 * rows * cap LV candidates
FULL_WIDTH_BATCH = 8


@dataclass
class SEOptions:
    l_overlap: int = 1
    max_seed: int = DEFAULT_MAX_SEED
    max_locate: int = DEFAULT_MAX_LOCATE
    max_hits: int = 5           # aln_opt->max_hits (aln.h:133)
    print_xa_cigar: bool = False
    print_nm_md: bool = False
    rg_id: Optional[str] = None
    batch_size: int = 4096
    gap_batch: int = 64
    k_hits: int = 16
    # shrink the per-strand hit-list width to 8 when max_hits is small
    # (set_hits consumes at most max_hits+1 entries per strand,
    # query.c:297-333)
    auto_k_hits: bool = True
    cap_margin: int = 128
    verify_width: int = 64   # compact unique-candidate width (u)
    # > 0: locate slots a read and strand in the first pass (rounded up to
    # 64, at most full_cap()); reads whose candidate stream exceeds them
    # are seeded and located again at full_cap().  0: one tier.  With
    # stride-1 overlap seeding each locus appears in about 2 * l_seed seed
    # streams, so small caps overflow on most reads.
    fast_cap: int = 0
    pe_locate: bool = False  # alnse_locate (PE) vs alnse_locate_alt caps
    gap_k: Optional[int] = None  # gapped threshold; None -> l_seq // 10
    # -X 1: Smith-Waterman extension instead of Landau-Vishkin for reads
    # with no ungapped hit (alnse_overlap_sw, alnse.c:1105-1164).  NOTE:
    # the reference binary aborts on its own -X 1 path (is_gap=-1 feeds
    # k=-1 into computeEditDistanceWithCigar's assert), so byte-parity is
    # undefined; this implements the evident intent: best SW locus wins,
    # SW cigar with soft clips, MAPQ from (score1, score2).
    extend_algo: str = "lv"  # "lv" | "sw"
    # index residency: "full" = one-gather locate (4 bytes a rank on the
    # device); "sampled" = bounded LF-walk locate over much smaller
    # tables (device_index.SampledSA), sampled every sa_intv positions
    sa_mode: str = "full"
    sa_intv: int = 8
    # locate column-block size (ops/locate.py): None = 128 columns in
    # sampled mode and all slots at once in full mode; 0 = all at once
    locate_chunk: Optional[int] = None
    sw_thres_score: int = 50     # aln_opt->thres_score (aln.h:144)
    sw_filterd: int = 20         # aln_opt->filterd (aln.h:142)
    # batched device SW pre-filter (ops/sw_batch.py): candidates whose
    # textbook score cannot win are skipped before the exact host SSW.
    # "auto" = on when the aligner's device is CUDA and the batch has at
    # least device_sw_min_batch candidates; off on the CPU.
    device_sw: str = "auto"      # "auto" | "on" | "off"
    device_sw_min_batch: int = 32

    def full_cap(self) -> int:
        """Locate slots per read and strand that no read overflows by the
        per-strand push cap alone."""
        c = self.max_locate + self.cap_margin
        return ((c + 63) // 64) * 64

    def cap(self) -> int:
        """Locate slots per read and strand in the first pass."""
        if self.fast_cap <= 0:
            return self.full_cap()
        return min(self.full_cap(), ((self.fast_cap + 63) // 64) * 64)


def encode_reads(seqs: List[str]) -> np.ndarray:
    """Encode a uniform-length group of reads (callers group mixed-length
    input by exact length first — see group_by_length)."""
    L = len(seqs[0])
    arr = np.zeros((len(seqs), L), dtype=np.uint8)
    for i, s in enumerate(seqs):
        if len(s) != L:
            raise ValueError(
                f"encode_reads needs uniform lengths (got {len(s)} vs {L}); "
                "group mixed-length reads with group_by_length first"
            )
        arr[i] = NST_NT4_TABLE[np.frombuffer(s.encode("latin1"), dtype=np.uint8)]
    return arr


def group_by_length(seqs) -> List[tuple]:
    """[(length, [orig_index, ...])], ascending by length; each group is
    aligned as one uniform batch and scattered back into input order."""
    by_len = {}
    for i, s in enumerate(seqs):
        by_len.setdefault(len(s), []).append(i)
    return sorted(by_len.items())


def revcomp(codes: np.ndarray) -> np.ndarray:
    r = codes[:, ::-1].copy()
    return np.where(r < 4, 3 - r, r).astype(np.uint8)


def gen_mapq(b0: int, b1: int) -> int:
    """query.c:270-281."""
    if b0 == 0:
        return 0
    mapq = int(255.0 * (abs(b0 - b1) / float(b0)))
    return mapq if mapq < 254 else 254


def set_hits_batch(primary_pos, n_diff, n_hits, first_hit_ndiff, hits_pos,
                   hits_ndiff, max_hits):
    """Vectorized query_set_hits (query.c:297-333) over a batch of
    reads: primary_pos (M,), n_diff (M,), n_hits (M,2),
    first_hit_ndiff (M,2), hits_pos (M,2,K), hits_ndiff (M,2,K).
    Returns (b1 (M,), appended (M,2,K) bool) where `appended` marks the
    XA entries the sequential reference loop records (strand-0 entries
    first, j order, pos != primary, a[0]-n_diff filter, max_hits cap
    with the early return) and b1 is min(a0) over strands that
    contributed at least one entry (100000 otherwise)."""
    M, S, K = hits_pos.shape
    pp = np.asarray(primary_pos, dtype=np.int64)
    nd = np.asarray(n_diff, dtype=np.int64)
    a0 = np.asarray(first_hit_ndiff, dtype=np.int64)
    hp = np.asarray(hits_pos, dtype=np.int64)
    j = np.arange(K)
    valid = j[None, None, :] < np.minimum(n_hits, K)[:, :, None]
    elig = (valid & (hp != pp[:, None, None])
            & (a0 <= nd[:, None])[:, :, None])
    cum = np.cumsum(elig.reshape(M, 2 * K), axis=1)
    appended = (elig.reshape(M, 2 * K)
                & (cum <= max_hits)).reshape(M, 2, K)
    contrib = appended.any(axis=2)
    b1 = np.where(contrib, a0, 100000).min(axis=1)
    return b1, appended


def gen_mapq_batch(b0, b1):
    """Vectorized gen_mapq (query.c:270-281)."""
    b0 = np.asarray(b0, dtype=np.int64)
    b1 = np.asarray(b1, dtype=np.int64)
    return np.where(
        b0 == 0, 0,
        np.minimum((255.0 * np.abs(b0 - b1)
                    / np.maximum(b0, 1)).astype(np.int64), 254))


def set_hits(
    primary_pos: int,
    primary_ndiff: int,
    n_hits: np.ndarray,          # (2,)
    first_hit_ndiff: np.ndarray, # (2,)
    hits_pos: np.ndarray,        # (2, K)
    hits_ndiff: np.ndarray,      # (2, K)
    max_hits: int,
):
    """query_set_hits (query.c:297-333) including the reference's use of
    the FIRST hit's n_diff (`a->n_diff`, i.e. a[0]) for the filter and b1.
    Returns (b1, xa_entries [(strand,pos,ndiff)...])."""
    b0 = primary_ndiff
    b1 = 100000
    tot = 0
    xa = []
    K = hits_pos.shape[1]
    for s in (0, 1):
        n = int(n_hits[s])
        if n == 0:
            continue
        a0 = int(first_hit_ndiff[s])
        for j in range(min(n, K)):
            pos = int(hits_pos[s, j])
            if pos == primary_pos:
                continue
            if a0 <= b0:
                if a0 <= b1:
                    b1 = a0
                xa.append((s, pos, int(hits_ndiff[s, j])))
                tot += 1
            if tot == max_hits:
                return b1, xa
    return b1, xa


def checked_options(opts: SEOptions) -> SEOptions:
    """`opts`, or a ValueError naming the option no aligner takes."""
    if opts.extend_algo not in ("lv", "sw"):
        raise ValueError(f"extend_algo={opts.extend_algo!r}: "
                         "expected 'lv' or 'sw'")
    if opts.device_sw not in ("auto", "on", "off"):
        raise ValueError(f"device_sw={opts.device_sw!r}: expected "
                         "'auto', 'on' or 'off'")
    if opts.sa_mode not in ("full", "sampled"):
        raise ValueError(f"sa_mode={opts.sa_mode!r}: expected "
                         "'full' or 'sampled'")
    return opts


def checked_device(device) -> torch.device:
    """torch.device(device); asking for CUDA without a card raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' was asked for but no CUDA "
                           "device is available")
    return dev


def loci_rows(out, sel):
    """Rows `sel` of both strands' located loci of an ungapped step."""
    return (Loci(*(a[sel] for a in out.loci0)),
            Loci(*(a[sel] for a in out.loci1)))


class SEAligner:
    """SE aligner whose index and batches live on `device`."""

    def __init__(self, index: SaltIndex, opts: SEOptions = None,
                 device="cuda"):
        self.index = index
        self.opts = checked_options(opts or SEOptions())
        self.device = checked_device(device)
        if self.opts.auto_k_hits and self.opts.max_hits <= 6:
            # the caller's options object may be shared: copy, not mutate
            self.opts = dataclasses.replace(
                self.opts, k_hits=min(self.opts.k_hits, 8))
        self.sampled = None
        if self.opts.sa_mode == "sampled":
            self.dix, self.sampled = to_device_index(
                index, self.device, "sampled", self.opts.sa_intv)
        else:
            self.dix = to_device_index(index, self.device)

    # ---------------- device steps ----------------
    # The four steps a batch is made of.  The sharded aligner
    # (parallel/sharded_engine.py) replaces them and keeps the row
    # bookkeeping of _complete_batch.

    def _ungapped(self, fwd, rev, cap: int, u: int):
        """Seed, locate and ungapped check of a batch at `cap` locate
        slots and verify width `u`.  Returns (out, packed): `out` keeps
        the located loci for the later steps, `packed` is the result with
        the needs_gap and overflow flags."""
        o = self.opts
        out = se_ungapped(
            self.dix, fwd, rev,
            l_overlap=o.l_overlap, max_seed=o.max_seed,
            max_locate=o.max_locate, cap=cap, u=u, k_hits=o.k_hits,
            pe_mode=o.pe_locate, sampled=self.sampled, chunk=o.locate_chunk,
        )
        return out, pack_result(out.res, (out.needs_gap, out.overflow))

    def _rerun_overflowed(self, fwd, rev, out, sel):
        """Rows `sel` of a batch, whose locate or compact verify was
        truncated, checked again in full.  Returns (packed, out_f): out_f
        holds the rows' loci from now on, row i of it being sel[i], and is
        None while they are still those of `out`."""
        o = self.opts
        if o.fast_cap > 0:
            # the narrow first pass may have cut the candidate stream:
            # seed and locate again at the full cap
            out_f, packed = self._ungapped(fwd[sel], rev[sel], o.full_cap(),
                                           o.full_cap())
            return packed, out_f
        # one locate tier: the located loci are complete, verify them all
        return pack_result(se_ungapped_full(
            self.dix, fwd[sel], rev[sel], *loci_rows(out, sel),
            k_hits=o.k_hits)), None

    def _gapped(self, fwd, rev, out, sel, k: int, u: int):
        """Packed gapped (Landau-Vishkin) check of the reads fwd / rev
        against rows `sel` of the loci of `out`, at verify width `u`."""
        g = se_gapped(self.dix, fwd, rev, *loci_rows(out, sel), k=k, u=u,
                      k_hits=self.opts.k_hits)
        return pack_result(g.res, (g.overflow,))

    def _loci_host(self, out, sel):
        """[(pos, pushed)] as numpy arrays, one entry a strand: rows `sel`
        of the loci of `out`, ascending by position."""
        return [(to_host(part.pos), to_host(part.pushed))
                for part in loci_rows(out, sel)]

    # ---------------- device dispatch ----------------

    def _dispatch_batch(self, codes: np.ndarray):
        """Start the ungapped step for one batch of (B, L) uint8 codes;
        returns a handle for _complete_batch.  CUDA work is queued
        asynchronously while the host finalizes the previous batch."""
        o = self.opts
        with stage("device.dispatch"):
            fwd = torch.from_numpy(codes).to(self.device)
            rev = torch.from_numpy(revcomp(codes)).to(self.device)
            out, packed_dev = self._ungapped(fwd, rev, o.cap(), o.verify_width)
        return fwd, rev, out, packed_dev

    def _complete_batch(self, handle):
        """Read a batch's ungapped result back, re-run its truncated rows
        and check the rows without an ungapped hit with gaps (span
        device.complete)."""
        with stage("device.complete"):
            o = self.opts
            K = o.k_hits
            fwd, rev, out, packed_dev = handle
            L = fwd.shape[1]
            with stage("device.ungapped"):
                packed = to_host(packed_dev)
            res = unpack_result(packed, K)
            needs_gap = res["n_extra"][:, 0].astype(bool)
            overflow = res["n_extra"][:, 1].astype(bool)

            def on_device(rows):
                return torch.as_tensor(rows, device=self.device)

            def unpack_rows(rows, packed_rows, into):
                fr = unpack_result(to_host(packed_rows), K)
                into.update((r, {kk: v[i] for kk, v in fr.items()})
                            for i, r in enumerate(rows))

            # rows whose locate or compact verify was truncated: checked again
            # in full (rare).  `moved` says where such a row's loci went:
            # (ungapped output, row in it); every other row's are in `out`.
            full_res, moved = {}, {}
            ovf_rows = np.nonzero(overflow)[0].tolist()
            count("rows.overflow", len(ovf_rows))   # 0 counts too
            if ovf_rows:
                with stage("device.ungapped_full"):
                    for s0 in range(0, len(ovf_rows), o.gap_batch):
                        rr = ovf_rows[s0 : s0 + o.gap_batch]
                        packed_f, out_f = self._rerun_overflowed(
                            fwd, rev, out, on_device(rr))
                        unpack_rows(rr, packed_f, full_res)
                        if out_f is not None:
                            moved.update((r, (out_f, i))
                                         for i, r in enumerate(rr))
            for r, fr in full_res.items():
                needs_gap[r] = not fr["found"]

            def by_source(rows):
                """[(ungapped output, rows whose loci it holds, their rows in
                it)]."""
                groups = {}
                for r in rows:
                    src, i = moved.get(r, (out, r))
                    g = groups.setdefault(id(src), (src, [], []))
                    g[1].append(r)
                    g[2].append(i)
                return list(groups.values())

            gap_rows = np.nonzero(needs_gap)[0].tolist()
            if o.extend_algo == "sw":
                sw_res = {}
                if gap_rows:
                    with stage("host.sw_extend"):
                        strands = {}
                        for src, rows, at in by_source(gap_rows):
                            host = self._loci_host(src, on_device(at))
                            strands.update(
                                (r, [(ps[i], ks[i]) for ps, ks in host])
                                for i, r in enumerate(rows))
                        self._sw_extend(gap_rows, strands, int(L), fwd, rev,
                                        sw_res)
                return res, needs_gap, sw_res, full_res

            gap_res = {}
            if gap_rows:
                k = o.gap_k if o.gap_k is not None else max(int(L) // 10, 0)

                def gapped(src, rows, at, u, size):
                    for s0 in range(0, len(rows), size):
                        rr = on_device(rows[s0 : s0 + size])
                        count("rows.gapped", len(rr))
                        unpack_rows(rows[s0 : s0 + size], self._gapped(
                            fwd[rr], rev[rr], src,
                            on_device(at[s0 : s0 + size]), k, u), gap_res)

                normal = [r for r in gap_rows if r not in full_res]
                if normal:
                    with stage("device.gapped"):
                        gapped(out, normal, normal, o.verify_width,
                               o.gap_batch)
                # rows with more gapped candidates than the compact width, and
                # the overflow rows: check every candidate
                wide = [r for r in gap_rows
                        if r in full_res or gap_res[r]["n_extra"][0]]
                if wide:
                    with stage("device.gapped_full"):
                        for src, rows, at in by_source(wide):
                            gapped(src, rows, at,
                                   o.cap() if src is out else o.full_cap(),
                                   FULL_WIDTH_BATCH)
            return res, needs_gap, gap_res, full_res

    def _device_sw_on(self, n_items: int) -> bool:
        """Whether the batched SW pre-filter runs for n_items candidates."""
        o = self.opts
        if o.device_sw == "off" or n_items == 0:
            return False
        if o.device_sw == "auto":
            return (self.device.type == "cuda"
                    and n_items >= o.device_sw_min_batch)
        return True

    def _sw_scores(self, refs: np.ndarray, reads: np.ndarray,
                   lens: np.ndarray, snp_mode: bool) -> np.ndarray:
        """Textbook SW scores of host-assembled uint8 windows and reads,
        scored on the aligner's device; one read-back."""
        with stage("device.sw_score"):
            return to_host(sw_score(
                torch.from_numpy(refs).to(self.device),
                torch.from_numpy(reads).to(self.device),
                torch.from_numpy(lens).to(self.device),
                snp_mode, SW_GAP_OPEN, SW_GAP_EXTEND))

    def _sw_extend(self, rows, strands, L, fwd, rev, sw_res):
        """Host SW extension over each gap-read's deduped loci
        (alnse_check_sw/sw_snp semantics; native SSW), with an optional
        batched device pre-filter: a locus whose textbook SW score is
        below the current best cannot displace it (SSW's score never
        exceeds the textbook score, ops/sw_batch.py).  `strands[row]` is
        [(pos, pushed)] of the row's loci, one entry a strand, ascending."""
        o = self.opts
        mix = self.index.mixref
        sel = torch.as_tensor(rows, device=self.device)
        codes_f_rows = to_host(fwd[sel])
        codes_r_rows = to_host(rev[sel])

        # phase A: per read, the deduped in-range loci in scan order
        per_read = []   # (ri, codes_f, codes_r, [(strand, pos), ...])
        for i, ri in enumerate(rows):
            cand = []
            for strand, (ps, ks) in enumerate(strands[ri]):
                prev = None
                for pos, pushed in zip(ps.tolist(), ks.tolist()):
                    if not pushed:
                        continue
                    if pos == prev or pos + L + 4 >= len(mix):
                        continue
                    prev = pos
                    cand.append((strand, pos))
            per_read.append((ri, codes_f_rows[i], codes_r_rows[i], cand))

        pre = self._sw_extend_prefilter(per_read, L)

        for pi, (ri, codes_f, codes_r, cand) in enumerate(per_read):
            if not cand:
                continue
            reads = (NT2BIT_NP[np.minimum(codes_f, 4)].astype(np.int8),
                     NT2BIT_NP[np.minimum(codes_r, 4)].astype(np.int8))
            best = None
            done = False
            if pre is not None:
                # common path: ONE host SSW call.  The reference's loop
                # (accept if score1 >= running-best && span >= filterd)
                # ends on the LAST max-score candidate; the device
                # textbook scores bound SSW's (ssw <= textbook,
                # sw_batch.py), so the last textbook-argmax is the only
                # possible final winner.  Verify the assumption on the
                # winner itself (ssw score == device score, span passes)
                # and fall back to the exact sequential loop otherwise.
                sc = pre[pi]
                M = max(sc)
                if M > 0:
                    w = len(sc) - 1 - sc[::-1].index(M)
                    strand, pos = cand[w]
                    window = mix[pos : pos + L + 5].astype(np.int8)
                    rr = ssw_align(reads[strand], window, SCORE_MAT16,
                                   SW_GAP_OPEN, SW_GAP_EXTEND, L // 2)
                    if (rr.score1 == M and
                            rr.read_end1 - rr.read_begin1 + 1 >= o.sw_filterd):
                        best = (rr, pos, strand)
                        done = True
            if not done:
                b0 = -1
                for k, (strand, pos) in enumerate(cand):
                    if pre is not None and pre[pi][k] < max(b0, 0):
                        continue  # cannot reach the accept threshold
                    window = mix[pos : pos + L + 5].astype(np.int8)
                    rr = ssw_align(reads[strand], window, SCORE_MAT16,
                                   SW_GAP_OPEN, SW_GAP_EXTEND, L // 2)
                    if (rr.score1 >= b0 and
                            rr.read_end1 - rr.read_begin1 + 1 >= o.sw_filterd):
                        b0 = rr.score1
                        best = (rr, pos, strand)
            if best is not None:
                rr, pos, strand = best
                cig = ""
                if rr.read_begin1 != 0:
                    cig += f"{rr.read_begin1}S"
                cig += "".join(f"{c}{op}" for c, op in (rr.cigar or []))
                if rr.read_end1 != L - 1:
                    cig += f"{L - rr.read_end1 - 1}S"
                sw_res[ri] = {
                    "sw": True,
                    "found": True,
                    "pos": np.uint32(rr.ref_begin1 + pos),
                    "strand": strand,
                    "mapq": gen_mapq(rr.score1, rr.score2),
                    "cigar": cig,
                    "seq_start": rr.read_begin1,
                }

    def _sw_extend_prefilter(self, per_read, L):
        """Textbook SW scores for every (read, locus) SW-extension
        candidate, batched on the device.  Returns [scores per read] or
        None when disabled."""
        n_items = sum(len(c[3]) for c in per_read)
        if not self._device_sw_on(n_items):
            return None
        mix = self.index.mixref
        W = L + 5
        refs = np.zeros((n_items, W), np.uint8)
        reads = np.zeros((n_items, L), np.uint8)
        lens = np.full(n_items, W, np.int32)
        k = 0
        for _ri, codes_f, codes_r, cand in per_read:
            oh = (NT2BIT_NP[np.minimum(codes_f, 4)],
                  NT2BIT_NP[np.minimum(codes_r, 4)])
            for strand, pos in cand:
                w = mix[pos : pos + W]
                refs[k, : len(w)] = w
                reads[k] = oh[strand]
                k += 1
        sc = self._sw_scores(refs, reads, lens, snp_mode=True)
        out = []
        k = 0
        for _ri, _cf, _cr, cand in per_read:
            out.append(sc[k : k + len(cand)].tolist())
            k += len(cand)
        return out

    # ---------------- per-read finalization ----------------

    def _emit_sw(self, name, seq, rseq, qual, r) -> str:
        o = self.opts
        return emit_se(
            self.index, name, seq, rseq, qual, int(r["pos"]),
            int(r["strand"]), int(r["mapq"]), r["cigar"], "",
            o.print_nm_md, o.rg_id, seq_start=int(r["seq_start"]),
        )

    def _finalize_read(
        self, name, seq, rseq, qual, found, pos, strand, n_diff, is_gap,
        n_hits, first_hit_ndiff, hits_pos, hits_ndiff, md_tag=None,
        pre_hits=None, pre_cigar=None,
    ) -> str:
        """One read's SAM line.  md_tag, pre_hits and pre_cigar are what a
        batched step already computed: the plain row's MD/NM/XV tag, the
        read's query_set_hits, and a gapped read's (cigar, tag, XA
        cigars) from _gapped_cigars; each is computed here when None."""
        o = self.opts
        idx = self.index
        L = len(seq)
        if not found:
            return emit_se(idx, name, seq, rseq, qual, UINT32_MAX, 3, 0, "", "",
                           o.print_nm_md, o.rg_id)
        if pre_hits is not None:
            b1, xa_entries = pre_hits
        else:
            b1, xa_entries = set_hits(
                pos, n_diff, n_hits, first_hit_ndiff, hits_pos, hits_ndiff,
                o.max_hits,
            )
        mapq = gen_mapq(n_diff, b1)
        # primary cigar (query_gen_cigar, query.c:282-296)
        xa_cigars = None
        if is_gap and pre_cigar is not None:
            cigar, md_tag, xa_cigars = pre_cigar
        elif is_gap:
            e, cigar = self._lv_cigar(pos, seq if strand == 0 else rseq, n_diff)
            md_tag = None
        else:
            cigar = f"{L}M"
        # XA cigars
        xa_with_cig = []
        for n, (s, p, nd) in enumerate(xa_entries):
            cig = None
            if o.print_xa_cigar and is_gap:
                if xa_cigars is not None:
                    cig = xa_cigars[n]
                else:
                    _, cig = self._lv_cigar(p, seq if s == 0 else rseq, nd)
            xa_with_cig.append((s, p, nd, cig))
        xa = build_xa(idx, pos, L, xa_with_cig, o.print_xa_cigar)
        return emit_se(idx, name, seq, rseq, qual, pos, strand, mapq, cigar,
                       xa, o.print_nm_md, o.rg_id, md_tag=md_tag)

    def _gapped_cigars(self, start, nb, codes, rcodes, n_amb, needs_gap,
                       gap_res):
        """The LV CIGARs and MD/NM/XV tags of a batch's found gapped reads,
        and with -c the CIGARs of their XA entries, in one native call
        (ops/lv.lv_cigar_batch, span host.cigar).  Returns {row:
        (pre_hits, pre_cigar)} for _finalize_read."""
        o = self.opts
        rows = [i for i in range(nb)
                if n_amb[start + i] <= SE_MAX_N_AMBIGUOUS and needs_gap[i]
                and i in gap_res and not gap_res[i].get("sw")
                and bool(gap_res[i]["found"])]
        if not rows:
            return {}
        pos, reads, ks, want, hits = [], [], [], [], []
        for i in rows:
            r = gap_res[i]
            p, nd = int(r["pos"]), int(r["n_diff"])
            strands = (codes[start + i], rcodes[start + i])
            h = set_hits(p, nd, r["n_hits"], r["first_hit_ndiff"],
                         r["hits_pos"], r["hits_ndiff"], o.max_hits)
            hits.append(h)
            pos.append(p)
            reads.append(strands[int(r["strand"])])
            ks.append(nd)
            want.append(o.print_nm_md)
            if o.print_xa_cigar:
                for s, xp, xnd in h[1]:
                    pos.append(xp)
                    reads.append(strands[s])
                    ks.append(xnd)
                    want.append(False)
        with stage("host.cigar"):
            got = lv_cigar_batch(self.index.mixref, self.index.pac, pos,
                                 np.stack(reads), ks, want)
        out = {}
        j = 0
        for i, h in zip(rows, hits):
            _e, cigar, tag = got[j]
            n_xa = len(h[1]) if o.print_xa_cigar else 0
            xa_cigars = [c for _e, c, _t in got[j + 1 : j + 1 + n_xa]]
            out[i] = (h, (cigar, tag, xa_cigars))
            j += 1 + n_xa
        return out

    def _lv_cigar(self, pos, strand_seq, k):
        L = len(strand_seq)
        text = self.index.mixref[pos : pos + L + 4]
        pattern = NT2BIT_NP[np.minimum(strand_seq, 4)]
        return lv_cigar_host(text, pattern, int(k))

    # ---------------- file-level entry points ----------------

    def align_records(self, records) -> List[str]:
        """records: list of SeqRecord.  Returns SAM record strings
        (one per read, no newline; empty string for skipped reads).
        Mixed-length input is aligned one length group at a time and
        re-scattered in input order.  Under SALT_TPU_TRACE each call is
        one Chrome trace (utils/metrics.device_trace)."""
        with device_trace("align_records", self.device):
            groups = group_by_length([r.seq for r in records])
            if len(groups) <= 1:
                return self._align_records_uniform(records)
            out: List[str] = [""] * len(records)
            for _L, idxs in groups:
                for i, line in zip(idxs, self._align_records_uniform(
                        [records[i] for i in idxs])):
                    out[i] = line
            return out

    def _align_records_uniform(self, records) -> List[str]:
        o = self.opts
        names = [trim_readno(r.name) for r in records]
        seqs = [r.seq for r in records]
        quals = [r.qual for r in records]
        codes = encode_reads(seqs)
        rcodes = revcomp(codes)
        n_amb = (codes > 3).sum(axis=1)

        B = o.batch_size
        n = len(records)
        out_records: List[str] = [""] * n
        starts = list(range(0, n, B))
        inflight: List = []  # [(start, nb, handle)] 2-deep software pipeline

        def dispatch(start):
            chunk = codes[start : start + B]
            inflight.append((start, len(chunk), self._dispatch_batch(chunk)))

        if starts:
            dispatch(starts[0])
        for si in range(len(starts)):
            if si + 1 < len(starts):
                dispatch(starts[si + 1])  # device works while host finalizes
            start, nb, handle = inflight.pop(0)
            res, needs_gap, gap_res, full_res = self._complete_batch(handle)
            with stage("host.finalize"):
                self._finalize_batch(
                    start, nb, names, codes, rcodes, quals, n_amb, res,
                    needs_gap, gap_res, full_res, out_records)
        return out_records

    def _finalize_batch(self, start, nb, names, codes, rcodes, quals, n_amb,
                        res, needs_gap, gap_res, full_res, out_records):
        o = self.opts
        # batch the pure-match MD/NM/XV tags: one pac gather + one
        # mismatch scan for every plain-path found read
        md_tags = {}
        if o.print_nm_md:
            plain = []
            for i in range(nb):
                gi = start + i
                if n_amb[gi] > SE_MAX_N_AMBIGUOUS:
                    continue
                if needs_gap[i] and i in gap_res:
                    continue
                r = full_res[i] if i in full_res else None
                found = bool(r["found"]) if r else bool(res["found"][i])
                if not found:
                    continue
                p = int(r["pos"]) if r else int(res["pos"][i])
                st = int(r["strand"]) if r else int(res["strand"][i])
                plain.append((i, p, st))
            if plain:
                pos_a = np.array([p for _i, p, _s in plain], np.int64)
                rd = np.stack([
                    (rcodes if s else codes)[start + i]
                    for i, _p, s in plain
                ])
                for (i, _p, _s), tag in zip(
                    plain, md_nm_tags_batch(self.index, pos_a, rd)
                ):
                    md_tags[i] = tag
        # batched query_set_hits for the plain-path found rows
        plain_rows = np.array([
            i for i in range(nb)
            if n_amb[start + i] <= SE_MAX_N_AMBIGUOUS
            and not (needs_gap[i] and i in gap_res)
            and i not in full_res and bool(res["found"][i])
        ], dtype=np.int64)
        pre_map = {}
        if len(plain_rows):
            b1v, appv = set_hits_batch(
                res["pos"][plain_rows], res["n_diff"][plain_rows],
                res["n_hits"][plain_rows],
                res["first_hit_ndiff"][plain_rows],
                res["hits_pos"][plain_rows],
                res["hits_ndiff"][plain_rows], o.max_hits,
            )
            hpv = res["hits_pos"][plain_rows]
            hnv = res["hits_ndiff"][plain_rows]
            any_xa = appv.any(axis=(1, 2))
            xa_map = {m: [] for m in np.nonzero(any_xa)[0]}
            for m, s, jj in zip(*(a.tolist() for a in np.nonzero(appv))):
                xa_map[m].append((s, int(hpv[m, s, jj]),
                                  int(hnv[m, s, jj])))
            for m, i in enumerate(plain_rows.tolist()):
                pre_map[i] = (int(b1v[m]), xa_map.get(m, []))
        # the per-read loop: MAPQ, XA and each read's SAM line, after one
        # native call for the gapped reads' LV CIGARs and tags
        with stage("host.emit"):
            gapped = self._gapped_cigars(start, nb, codes, rcodes, n_amb,
                                         needs_gap, gap_res)
            for i in range(nb):
                gi = start + i
                if n_amb[gi] > SE_MAX_N_AMBIGUOUS:
                    out_records[gi] = ""  # reference emits a blank line
                    continue
                if needs_gap[i] and i in gap_res:
                    r = gap_res[i]
                    if r.get("sw"):
                        out_records[gi] = self._emit_sw(
                            names[gi], codes[gi], rcodes[gi], quals[gi], r)
                        continue
                    is_gap = True
                elif i in full_res:
                    r = full_res[i]
                    is_gap = False
                else:
                    r = {k: v[i] for k, v in res.items()}
                    is_gap = False
                pre_hits, pre_cigar = gapped.get(i, (pre_map.get(i), None))
                out_records[gi] = self._finalize_read(
                    names[gi], codes[gi], rcodes[gi], quals[gi],
                    bool(r["found"]), int(r["pos"]), int(r["strand"]),
                    int(r["n_diff"]), is_gap, r["n_hits"],
                    r["first_hit_ndiff"], r["hits_pos"], r["hits_ndiff"],
                    md_tag=md_tags.get(i), pre_hits=pre_hits,
                    pre_cigar=pre_cigar,
                )

    def align_file(self, fastq_path: str, out_fh, cmd: str = "salt-tpu-torch"):
        print(sam_header(self.index, cmd, self.opts.rg_id), file=out_fh)
        batch = []
        n_done = 0
        for rec in read_records(fastq_path):
            batch.append(rec)
            if len(batch) >= 100000:
                for line in self.align_records(batch):
                    print(line, file=out_fh)
                n_done += len(batch)
                progress(n_done)
                batch = []
        if batch:
            for line in self.align_records(batch):
                print(line, file=out_fh)
            n_done += len(batch)
            progress(n_done)
