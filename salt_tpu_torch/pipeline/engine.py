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
from ..ops.lv import NT2BIT_NP, lv_cigar_batch
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
    # (parallel/sharded_engine.py) replaces them and keeps the result
    # table of _complete_batch.

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
        """Packed result of rows `sel` of a batch, whose locate or compact
        verify was truncated, checked again over every locus the one
        locate pass (at full_cap()) found for them."""
        return pack_result(se_ungapped_full(
            self.dix, fwd[sel], rev[sel], *loci_rows(out, sel),
            k_hits=self.opts.k_hits))

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
            out, packed_dev = self._ungapped(fwd, rev, o.full_cap(),
                                             o.verify_width)
        return fwd, rev, out, packed_dev

    def _complete_batch(self, handle):
        """Read a batch's ungapped result back, re-run its truncated rows
        and check the rows without an ungapped hit with gaps (span
        device.complete).

        Returns the batch's result table: unpack_result's per-row arrays
        (found, pos, strand, n_diff, n_hits, first_hit_ndiff, hits_pos,
        hits_ndiff), `is_gap`, whether a row's result is the gapped
        check's, and `sw`, {row: SW record} of the rows that -X 1 found.
        A row holds its ungapped result, overwritten by its full-width
        re-run where it overflowed, and that by its gapped result where it
        was checked with gaps."""
        with stage("device.complete"):
            o = self.opts
            W = 8 + 4 * o.k_hits     # the result columns of a packed matrix
            fwd, rev, out, packed_dev = handle
            L = fwd.shape[1]
            with stage("device.ungapped"):
                table = to_host(packed_dev)
            needs_gap = table[:, W].astype(bool)
            overflow = table[:, W + 1].astype(bool)
            is_gap = np.zeros(len(table), bool)
            sw = {}

            def on_device(rows):
                return torch.as_tensor(rows, device=self.device)

            def overlay(rows, packed_rows):
                """Rows `rows` of the table from packed_rows; returns their
                flags past the result columns."""
                got = to_host(packed_rows)
                table[rows, :W] = got[:, :W]
                return got[:, W:]

            # rows whose locate or compact verify was truncated: checked
            # again in full (rare)
            ovf_rows = np.nonzero(overflow)[0].tolist()
            count("rows.overflow", len(ovf_rows))   # 0 counts too
            if ovf_rows:
                with stage("device.ungapped_full"):
                    for s0 in range(0, len(ovf_rows), o.gap_batch):
                        rr = ovf_rows[s0 : s0 + o.gap_batch]
                        overlay(rr, self._rerun_overflowed(fwd, rev, out,
                                                           on_device(rr)))
                needs_gap[ovf_rows] = table[ovf_rows, 0] == 0

            gap_rows = np.nonzero(needs_gap)[0].tolist()
            if gap_rows and o.extend_algo == "sw":
                with stage("host.sw_extend"):
                    host = self._loci_host(out, on_device(gap_rows))
                    strands = {r: [(ps[i], ks[i]) for ps, ks in host]
                               for i, r in enumerate(gap_rows)}
                    self._sw_extend(gap_rows, strands, int(L), fwd, rev, sw)
            elif gap_rows:
                k = o.gap_k if o.gap_k is not None else max(int(L) // 10, 0)
                gap_ovf = np.zeros(len(table), bool)

                def gapped(rows, u, size):
                    for s0 in range(0, len(rows), size):
                        rr = rows[s0 : s0 + size]
                        sel = on_device(rr)
                        count("rows.gapped", len(rr))
                        gap_ovf[rr] = overlay(rr, self._gapped(
                            fwd[sel], rev[sel], out, sel, k, u))[:, 0]

                normal = [r for r in gap_rows if not overflow[r]]
                if normal:
                    with stage("device.gapped"):
                        gapped(normal, o.verify_width, o.gap_batch)
                # rows with more gapped candidates than the compact width, and
                # the overflow rows: check every candidate
                wide = [r for r in gap_rows if overflow[r] or gap_ovf[r]]
                if wide:
                    with stage("device.gapped_full"):
                        gapped(wide, o.full_cap(), FULL_WIDTH_BATCH)
                is_gap[gap_rows] = True
            res = unpack_result(table[:, :W], o.k_hits)
            del res["n_extra"]
            res["is_gap"] = is_gap
            res["sw"] = sw
            return res

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

    def _finalize_read(self, name, seq, rseq, qual, pos, strand, n_diff, b1,
                       xa_entries, cigar, md_tag, xa_cigars) -> str:
        """One found read's SAM line from what its batch computed: b1 and
        the XA entries [(strand, pos, n_diff)] of query_set_hits, the
        primary CIGAR (query_gen_cigar, query.c:282-296), the MD/NM/XV tag
        (None: emit_se makes it) and the XA entries' CIGARs (None: none
        printed)."""
        o = self.opts
        xa = build_xa(self.index, pos, len(seq), [
            (s, p, nd, None if xa_cigars is None else xa_cigars[n])
            for n, (s, p, nd) in enumerate(xa_entries)], o.print_xa_cigar)
        return emit_se(self.index, name, seq, rseq, qual, pos, strand,
                       gen_mapq(n_diff, b1), cigar, xa, o.print_nm_md,
                       o.rg_id, md_tag=md_tag)

    def _gapped_cigars(self, rows, res, hits, codes, rcodes):
        """The LV CIGARs and MD/NM/XV tags of the found gapped rows `rows`
        of a batch's result table, and with -c the CIGARs of their XA
        entries (hits[row][1]), in one native call (ops/lv.lv_cigar_batch,
        span host.cigar).  Returns {row: (cigar, tag, XA cigars or None)}
        for _finalize_read."""
        o = self.opts
        if not rows:
            return {}
        ps, reads, ks, want = [], [], [], []
        for i in rows:
            strands = (codes[i], rcodes[i])
            ps.append(int(res["pos"][i]))
            reads.append(strands[int(res["strand"][i])])
            ks.append(int(res["n_diff"][i]))
            want.append(o.print_nm_md)
            if o.print_xa_cigar:
                for s, xp, xnd in hits[i][1]:
                    ps.append(xp)
                    reads.append(strands[s])
                    ks.append(xnd)
                    want.append(False)
        with stage("host.cigar"):
            got = iter(lv_cigar_batch(self.index.mixref, self.index.pac, ps,
                                      np.stack(reads), ks, want))
        out = {}
        for i in rows:
            _e, cigar, tag = next(got)
            xa_cigars = None
            if o.print_xa_cigar:
                xa_cigars = [next(got)[1] for _ in hits[i][1]]
            out[i] = (cigar, tag, xa_cigars)
        return out

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
            res = self._complete_batch(handle)
            with stage("host.finalize"):
                self._finalize_batch(start, nb, names, codes, rcodes, quals,
                                     n_amb, res, out_records)
        return out_records

    def _finalize_batch(self, start, nb, names, codes, rcodes, quals, n_amb,
                        res, out_records):
        """SAM lines of a batch's reads from its result table.  Each read
        is one of: blank (more than SE_MAX_N_AMBIGUOUS Ns), SW (found by
        -X 1), unmapped, found plain or found gapped.  query_set_hits runs
        once over the found rows, the MD/NM/XV tags once over the found
        plain rows, and the gapped rows' CIGARs in one native call."""
        o = self.opts
        codes, rcodes = codes[start : start + nb], rcodes[start : start + nb]
        blank = n_amb[start : start + nb] > SE_MAX_N_AMBIGUOUS
        pos, strand, n_diff = res["pos"], res["strand"], res["n_diff"]
        found = np.nonzero(res["found"] & ~blank)[0]
        b1, appended = set_hits_batch(
            pos[found], n_diff[found], res["n_hits"][found],
            res["first_hit_ndiff"][found], res["hits_pos"][found],
            res["hits_ndiff"][found], o.max_hits)
        hp, hn = res["hits_pos"][found], res["hits_ndiff"][found]
        xa = [[] for _ in found]
        for m, s, j in zip(*(a.tolist() for a in np.nonzero(appended))):
            xa[m].append((s, int(hp[m, s, j]), int(hn[m, s, j])))
        hits = dict(zip(found.tolist(), zip(b1.tolist(), xa)))
        gap = res["is_gap"][found]
        plain, gapped = found[~gap], found[gap].tolist()
        # the pure-match MD/NM/XV tags of the found plain rows: one pac
        # gather and one mismatch scan
        md_tags = {}
        if o.print_nm_md and len(plain):
            rd = np.where(strand[plain, None] != 0, rcodes[plain], codes[plain])
            md_tags = dict(zip(plain.tolist(), md_nm_tags_batch(
                self.index, pos[plain].astype(np.int64), rd)))
        # the per-read loop: MAPQ, XA and each read's SAM line, after one
        # native call for the gapped reads' LV CIGARs and tags
        plain_cigar = f"{codes.shape[1]}M"
        with stage("host.emit"):
            cigars = self._gapped_cigars(gapped, res, hits, codes, rcodes)
            for i in range(nb):
                gi = start + i
                if blank[i]:
                    out_records[gi] = ""  # reference emits a blank line
                elif i in res["sw"]:
                    out_records[gi] = self._emit_sw(
                        names[gi], codes[i], rcodes[i], quals[gi],
                        res["sw"][i])
                elif i not in hits:
                    out_records[gi] = emit_se(
                        self.index, names[gi], codes[i], rcodes[i], quals[gi],
                        UINT32_MAX, 3, 0, "", "", o.print_nm_md, o.rg_id)
                else:
                    cigar, md_tag, xa_cigars = cigars.get(
                        i, (plain_cigar, md_tags.get(i), None))
                    out_records[gi] = self._finalize_read(
                        names[gi], codes[i], rcodes[i], quals[gi],
                        int(pos[i]), int(strand[i]), int(n_diff[i]),
                        *hits[i], cigar, md_tag, xa_cigars)

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
