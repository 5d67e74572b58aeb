"""Paired-end alignment engine.  Port of salt_tpu/pipeline/pe_engine.py.

Per-pair flow mirrors alnpe_core1 (Align_src/alnpe.c:482-521): both ends
run the SE stack (alnse_overlap flavor: PE locate, gapped threshold
stays at the ungapped 3 — alnse.c:985-1043), then:

  * both ends mapped      -> pairing2 (primary insert check, hit-list
                             cross product, SNP-aware SSW rescue)
  * exactly one mapped    -> pairing_singleton (plain-reference SSW)
  * none                  -> emit unmapped pair

SAM emission ports alnpe_sam (sam.c:331-457) byte-for-byte, including
its TLEN quirk (q0.seq_end - q1.seq_start, sam.c:356).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np

from ..constants import (
    DEFAULT_MAX_TLEN,
    DEFAULT_MIN_TLEN,
    NST_NT4_TABLE,
    PE_MAX_N_AMBIGUOUS,
    SW_FILTER_DIST,
    SW_FILTER_SCORE,
    SW_GAP_EXTEND,
    SW_GAP_OPEN,
    UINT32_MAX,
)
from ..index.build import SaltIndex
from ..io.fasta import read_records, trim_readno
from ..io.sam import emit_pe, md_nm_tags_batch, sam_header
from ..ops.lv import NT2BIT_NP, lv_cigar_host
from ..ops.ssw import SCORE_MAT5, SCORE_MAT16, ssw_align
from ..utils.metrics import count, device_trace, stage
from .engine import (
    SEAligner,
    SEOptions,
    gen_mapq,
    gen_mapq_batch,
    group_by_length,
    revcomp,
    set_hits,
    set_hits_batch,
)


@dataclass
class PEOptions(SEOptions):
    min_tlen: int = DEFAULT_MIN_TLEN
    max_tlen: int = DEFAULT_MAX_TLEN
    use_sw_singleton: bool = True  # pairing_singleton always runs (alnpe.c:513)
    # device_sw / device_sw_min_batch (the batched rescue pre-filter)
    # are inherited from SEOptions: a rescue candidate whose
    # textbook-affine score is below thres_score cannot pass SSW's
    # threshold either (sw_batch.py), so only survivors run the exact
    # host SSW.  "auto" = on when the aligner's device is CUDA and the
    # batch has enough candidates to amortize the dispatch.


class _End:
    """query_t-like mutable per-end state."""

    __slots__ = (
        "name", "seq", "rseq", "qual", "l_seq", "pos", "strand", "n_diff",
        "is_gap", "b0", "b1", "mapq", "cigar", "seq_start", "seq_end",
        "hits", "first_hit_ndiff", "n_hits", "hits_pos", "hits_ndiff",
    )

    def __init__(self, name, seq, rseq, qual):
        self.name = name
        self.seq = seq
        self.rseq = rseq
        self.qual = qual
        self.l_seq = len(seq)
        self.pos = UINT32_MAX
        self.strand = 3
        self.n_diff = 255
        self.is_gap = 0
        self.b0 = -1
        self.b1 = -1
        self.mapq = 0
        self.cigar = ""
        self.seq_start = 0
        self.seq_end = self.l_seq - 1
        self.hits = ([], [])  # per strand: list of (pos, n_diff, is_gap)


class PEAligner:
    """PE aligner whose index and batches live on `device`."""

    def __init__(self, index: SaltIndex, opts: PEOptions = None,
                 device="cuda", se_aligner=None):
        """`se_aligner(se_opts)` builds the aligner of the per-end SE
        stage; the default is an SEAligner of `index` on `device`."""
        self.index = index
        self.opts = opts or PEOptions()
        if self.opts.extend_algo != "lv":
            raise ValueError("paired-end alignment extends with Landau-"
                             "Vishkin only (extend_algo='lv')")
        # reuse the SE device machinery with PE locate flavor; the gapped
        # threshold stays at the ungapped 3 in the PE path (alnse.c:1027)
        se_opts = SEOptions(**{
            k: getattr(self.opts, k) for k in SEOptions.__dataclass_fields__
        })
        se_opts.pe_locate = True
        se_opts.gap_k = 3
        se_opts.auto_k_hits = False  # pairing2 crosses full hit lists
        if se_aligner is None:
            self._se = SEAligner(index, se_opts, device=device)
        else:
            self._se = se_aligner(se_opts)
        self.device = self._se.device

    # ---------------- host pairing ----------------

    def _sw_snpaware(self, q: _End, start, end, strand) -> bool:
        """snpaln_sw_snpaware (alnpe.c:261-327)."""
        if start >= self.index.l_pac:
            return False  # reference would exit(1)
        ref = self.index.mixref[int(start) : int(end) + 1].astype(np.int8)
        seq = q.rseq if strand else q.seq
        read = NT2BIT_NP[np.minimum(seq, 4)].astype(np.int8)
        r = ssw_align(read, ref, SCORE_MAT16, SW_GAP_OPEN, SW_GAP_EXTEND,
                      q.l_seq // 2)
        if r.score1 >= SW_FILTER_SCORE and r.read_end1 - r.read_begin1 + 1 >= SW_FILTER_DIST:
            q.b0 = r.score1
            q.b1 = r.score2
            q.mapq = gen_mapq(q.b0, q.b1)
            q.pos = r.ref_begin1 + int(start)
            q.strand = strand
            q.seq_start = r.read_begin1
            q.seq_end = r.read_end1
            q.cigar = "".join(f"{c}{op}" for c, op in r.cigar)
            return True
        return False

    def _sw_plain(self, q: _End, start, end, strand) -> bool:
        """snpaln_sw (alnpe.c:330-393): plain 2-bit reference, 5x5 matrix."""
        if start >= self.index.l_pac:
            return False
        ref = self.index.pac[int(start) : int(end) + 1].astype(np.int8)
        seq = (q.rseq if strand else q.seq).astype(np.int8)
        r = ssw_align(seq, ref, SCORE_MAT5, SW_GAP_OPEN, SW_GAP_EXTEND,
                      q.l_seq // 2)
        if r.score1 >= SW_FILTER_SCORE and r.read_end1 - r.read_begin1 + 1 >= SW_FILTER_DIST:
            q.b0 = r.score1
            q.b1 = r.score2
            q.mapq = gen_mapq(q.b0, q.b1)
            q.pos = r.ref_begin1 + int(start)
            q.strand = strand
            q.seq_start = r.read_begin1
            q.seq_end = r.read_end1
            q.cigar = "".join(f"{c}{op}" for c, op in r.cigar)
            return True
        return False

    def _gen_cigar(self, q: _End):
        """query_gen_cigar (query.c:282-296)."""
        q.seq_start = 0
        q.seq_end = q.l_seq - 1
        if q.pos == UINT32_MAX:
            return
        if q.is_gap:
            seq = q.seq if q.strand == 0 else q.rseq
            text = self.index.mixref[q.pos : q.pos + q.l_seq + 4]
            pattern = NT2BIT_NP[np.minimum(seq, 4)]
            _, q.cigar = lv_cigar_host(text, pattern, int(q.n_diff))
        else:
            q.cigar = f"{q.l_seq}M"

    def _pairing2_fast(self, q0: _End, q1: _End) -> bool:
        """pairing2 minus the SW rescue: primary insert/orientation
        check and the hit-list cross product (alnpe.c:94-203)."""
        o = self.opts
        l2 = q0.l_seq + q1.l_seq
        min_isize = o.min_tlen - l2 if o.min_tlen > l2 else 0
        max_isize = o.max_tlen - l2 if o.max_tlen > l2 else 0

        def in_range(a, b):
            # CHECK_IN_RANGE (alnpe.c:76-81), uint32 semantics
            a &= 0xFFFFFFFF
            b &= 0xFFFFFFFF
            r = b - a if a < b else a - b
            if a > b or r < min_isize:
                return -1
            if r > max_isize:
                return 1
            return 0

        if q0.strand == 0 and q1.strand == 1 and q0.pos < q1.pos:
            if in_range(q0.pos + q0.l_seq, q1.pos) == 0:
                self._gen_cigar(q0)
                self._gen_cigar(q1)
                return True
        elif q1.strand == 0 and q0.strand == 1 and q1.pos < q0.pos:
            if in_range(q1.pos + q1.l_seq, q0.pos) == 0:
                self._gen_cigar(q0)
                self._gen_cigar(q1)
                return True

        min_err = None
        best = None  # (b0 tuple for q0, b1 tuple for q1)
        for fwd_q, bwd_q, order in ((q0, q1, 0), (q1, q0, 1)):
            fl = fwd_q.hits[0]
            bl = bwd_q.hits[1]
            if fl and bl:
                l0 = fwd_q.l_seq
                for (p0, nd0, g0) in fl:
                    for (p1, nd1, g1) in bl:
                        rr = in_range(p0 + l0, p1)
                        if rr == 0:
                            tot = nd0 + nd1
                            if min_err is None or tot < min_err:
                                min_err = tot
                                if order == 0:
                                    best = ((p0, 0, nd0, g0), (p1, 1, nd1, g1))
                                else:
                                    best = ((p1, 1, nd1, g1), (p0, 0, nd0, g0))
                        elif rr == 1:
                            break
        if best is not None:
            for q, b in ((q0, best[0]), (q1, best[1])):
                q.pos, q.strand, q.n_diff, q.is_gap = b
            self._gen_cigar(q0)
            self._gen_cigar(q1)
            return True
        return False

    def _pairing2_requests(self, q0: _End, q1: _End):
        """The SW-rescue windows pairing2 would try, in order
        (alnpe.c:204-252): [(anchor, other, start, end, strand)]."""
        o = self.opts
        l2 = q0.l_seq + q1.l_seq
        min_isize = o.min_tlen - l2 if o.min_tlen > l2 else 0
        max_isize = o.max_tlen - l2 if o.max_tlen > l2 else 0
        l_pac = self.index.l_pac
        reqs = []
        for anchor, other in ((q0, q1), (q1, q0)):
            if anchor.strand == 0:
                start = anchor.pos + min_isize + anchor.l_seq
                end = anchor.pos + max_isize + anchor.l_seq + other.l_seq
                end = l_pac if end >= l_pac else end
                strand = 1
            else:
                start = (anchor.pos - max_isize - other.l_seq
                         if anchor.pos > max_isize + other.l_seq else 0)
                end = anchor.pos - min_isize if anchor.pos > min_isize else 0
                end = l_pac if end >= l_pac else end
                strand = 0
            reqs.append((anchor, other, int(start), int(end), strand))
        return reqs

    def _run_rescue(self, q0, q1, reqs, scores, snp: bool) -> bool:
        """Try the rescue windows in order; `scores` (if given) are the
        device textbook-SW scores aligned with reqs — a candidate below
        thres_score is skipped without touching the host SSW (sound:
        SSW's score never exceeds the textbook score).  Each window the
        host SSW runs is counted as pe.rescue_windows."""
        for k, (anchor, other, start, end, strand) in enumerate(reqs):
            if scores is not None and scores[k] < SW_FILTER_SCORE:
                continue
            count("pe.rescue_windows")
            hit = (self._sw_snpaware(other, start, end, strand) if snp
                   else self._sw_plain(other, start, end, strand))
            if hit:
                self._gen_cigar(anchor)
                return True
        if q0.pos != UINT32_MAX:
            self._gen_cigar(q0)
        if q1.pos != UINT32_MAX:
            self._gen_cigar(q1)
        return False

    def _singleton_requests(self, q0: _End, q1: _End):
        """pairing_singleton's plain-reference SW windows, in order
        (alnpe.c:395-480)."""
        o = self.opts
        l2 = q0.l_seq + q1.l_seq
        min_isize = o.min_tlen - l2 if o.min_tlen > l2 else 0
        max_isize = o.max_tlen - l2 if o.max_tlen > l2 else 0
        l_pac = self.index.l_pac
        reqs = []
        for anchor, other in ((q0, q1), (q1, q0)):
            if anchor.pos == UINT32_MAX:
                continue
            if anchor.strand == 0:
                start = min(anchor.pos + min_isize + anchor.l_seq, l_pac - 1)
                end = min(anchor.pos + max_isize + anchor.l_seq + other.l_seq,
                          l_pac - 1)
                strand = 1
            else:
                start = (anchor.pos - max_isize - other.l_seq
                         if anchor.pos > max_isize + other.l_seq else 0)
                start = min(start, l_pac - 1)
                end = anchor.pos - min_isize if anchor.pos > min_isize else 0
                end = min(end, l_pac - 1)
                strand = 0
            reqs.append((anchor, other, int(start), int(end), strand))
        return reqs

    # ---------------- entry points ----------------

    def align_pairs(self, recs1, recs2) -> List[str]:
        """SAM lines of both ends of each pair.  Under SALT_TPU_TRACE each
        call is one Chrome trace (utils/metrics.device_trace)."""
        with device_trace("align_pairs", self.device):
            return self._align_pairs(recs1, recs2)

    def _align_pairs(self, recs1, recs2) -> List[str]:
        o = self.opts
        n = len(recs1)
        if len(recs2) != n:
            raise ValueError(f"{n} first-end records but {len(recs2)} "
                             "second-end records")
        names = [trim_readno(r.name) for r in recs1 + recs2]
        seqs = [r.seq for r in recs1] + [r.seq for r in recs2]
        quals = [r.qual for r in recs1] + [r.qual for r in recs2]
        codes_list = [
            NST_NT4_TABLE[np.frombuffer(s.encode("latin1"), np.uint8)]
            for s in seqs
        ]
        rcodes_list = [revcomp(c[None])[0] for c in codes_list]
        n_amb = np.array([(c > 3).sum() for c in codes_list])

        if n > 0 and len({len(s) for s in seqs}) == 1:
            # uniform read length (the common case): chunk pairs so each
            # device batch holds BOTH ends of a contiguous pair range,
            # and run pairing/rescue/SAM for chunk k while chunk k+1 is
            # on the device, so the host stages overlap the device's.
            return self._align_pairs_uniform(
                names, quals, codes_list, rcodes_list, n_amb, n)

        # device SE stage for all 2n ends: one pass per distinct read
        # length, batched; 2-deep software pipeline
        # (dispatch batch i+1 before completing batch i)
        B = o.batch_size
        ends = {}   # end -> (its batch's result table, its row there)
        for _L, idxs in group_by_length(seqs):
            starts = list(range(0, len(idxs), B))
            inflight = []

            def dispatch(s0):
                sub = idxs[s0 : s0 + B]
                chunk = np.stack([codes_list[i] for i in sub])
                inflight.append((sub, self._se._dispatch_batch(chunk)))

            if starts:
                dispatch(starts[0])
            for si in range(len(starts)):
                if si + 1 < len(starts):
                    dispatch(starts[si + 1])
                sub, handle = inflight.pop(0)
                res = self._se._complete_batch(handle)
                ends.update((gi, (res, i)) for i, gi in enumerate(sub))

        states = []   # (e0, e1, mode, reqs)
        for pi in range(n):
            states.append(self._make_state(
                names[pi], names[n + pi], quals[pi], quals[n + pi],
                codes_list[pi], rcodes_list[pi],
                codes_list[n + pi], rcodes_list[n + pi],
                n_amb[pi], n_amb[n + pi], ends[pi], ends[n + pi],
            ))
        return self._finalize_states(states)

    def _fill_states_fast(self, states, rows, p0, P, names, quals,
                          codes_list, rcodes_list, n_amb, n, res):
        """Vectorized _make_state for pairs of rows `rows` and P + rows of
        the result table `res` with neither end gapped (the vast
        majority).  Semantics identical to the per-pair path:
        query_set_hits (query.c:297-333) and the pairing2 fast stage
        (primary insert check + hit-list cross product, alnpe.c:94-203)
        are computed as numpy array ops over the whole chunk; only
        pairs that need SW rescue fall back to per-pair request
        assembly."""
        o = self.opts
        K = res["hits_pos"].shape[2]
        H = o.max_hits
        idx0 = np.asarray(rows, dtype=np.int64)
        M = len(rows)
        rows2 = np.concatenate([idx0, P + idx0])          # ends stacked
        amb = np.concatenate([n_amb[p0 + idx0], n_amb[n + p0 + idx0]])
        found = res["found"][rows2] & (amb <= PE_MAX_N_AMBIGUOUS)
        pos = res["pos"][rows2].astype(np.int64)
        strand = res["strand"][rows2].astype(np.int64)
        nd = res["n_diff"][rows2].astype(np.int64)
        nh = res["n_hits"][rows2]
        a0 = res["first_hit_ndiff"][rows2].astype(np.int64)   # (2M, 2)
        hp = res["hits_pos"][rows2].astype(np.int64)          # (2M, 2, K)
        hnd = res["hits_ndiff"][rows2].astype(np.int64)

        # --- vectorized query_set_hits ---
        j = np.arange(K)
        b1, appended = set_hits_batch(pos, nd, nh, a0, hp, hnd, H)
        appended = appended & found[:, None, None]
        mapq = gen_mapq_batch(nd, b1)

        # --- vectorized pairing2 fast stage (both-mapped pairs) ---
        L0 = np.array([len(codes_list[p0 + i]) for i in idx0], np.int64)
        L1 = np.array([len(codes_list[n + p0 + i]) for i in idx0], np.int64)
        l2 = L0 + L1
        min_is = np.where(o.min_tlen > l2, o.min_tlen - l2, 0)
        max_is = np.where(o.max_tlen > l2, o.max_tlen - l2, 0)

        def in_range(a, b, mn, mx):
            # CHECK_IN_RANGE (alnpe.c:76-81), uint32 semantics
            a = a & 0xFFFFFFFF
            b = b & 0xFFFFFFFF
            r = np.abs(b - a)
            neg = (a > b) | (r < mn)
            return np.where(neg, -1, np.where(r > mx, 1, 0))

        p0e, p1e = pos[:M], pos[M:]
        s0e, s1e = strand[:M], strand[M:]
        both = found[:M] & found[M:]
        prim_a = (both & (s0e == 0) & (s1e == 1) & (p0e < p1e)
                  & (in_range(p0e + L0, p1e, min_is, max_is) == 0))
        prim_b = (both & ~prim_a & (s1e == 0) & (s0e == 1) & (p1e < p0e)
                  & (in_range(p1e + L1, p0e, min_is, max_is) == 0))
        prim = prim_a | prim_b

        # cross product over appended hit lists, both orders.  order 0:
        # end0 strand-0 list x end1 strand-1 list; order 1: end1
        # strand-0 x end0 strand-1.  First minimal (nd0+nd1) in
        # (order, j0, j1) iteration order wins (strict < replacement).
        # The reference loop breaks its inner scan at the first
        # too-far-right hit; computing the FULL cross product is
        # equivalent because hit lists are position-ascending (sorted
        # loci -> order-preserving compaction, ops/verify.py) — the
        # invariant tests/test_pe_fast_path.py encodes.
        fl_pos = np.stack([hp[:M, 0], hp[M:, 0]])             # (2, M, K)
        fl_nd = np.stack([hnd[:M, 0], hnd[M:, 0]])
        fl_ok = np.stack([appended[:M, 0], appended[M:, 0]])
        fl_len = np.stack([L0, L1])                           # (2, M)
        bl_pos = np.stack([hp[M:, 1], hp[:M, 1]])
        bl_nd = np.stack([hnd[M:, 1], hnd[:M, 1]])
        bl_ok = np.stack([appended[M:, 1], appended[:M, 1]])
        rr = in_range(
            fl_pos[:, :, :, None] + fl_len[:, :, None, None],
            bl_pos[:, :, None, :],
            min_is[None, :, None, None], max_is[None, :, None, None])
        ok = (rr == 0) & fl_ok[:, :, :, None] & bl_ok[:, :, None, :]
        tot = fl_nd[:, :, :, None] + bl_nd[:, :, None, :]
        lin = (np.arange(2)[:, None, None, None] * K * K
               + j[None, None, :, None] * K + j[None, None, None, :])
        key = np.where(ok, tot * (2 * K * K) + lin, np.int64(1) << 60)
        kf = key.transpose(1, 0, 2, 3).reshape(M, -1)
        best_flat = kf.argmin(axis=1)
        has_best = both & ~prim & (np.take_along_axis(
            kf, best_flat[:, None], axis=1)[:, 0] < (np.int64(1) << 60))
        b_ord = best_flat // (K * K)
        b_j0 = (best_flat // K) % K
        b_j1 = best_flat % K

        # --- materialize states ---
        UINT = UINT32_MAX
        app_r, app_s, app_j = np.nonzero(appended)
        hit_lists = [([], []) for _ in range(2 * M)]
        for r_, s_, j_ in zip(app_r.tolist(), app_s.tolist(), app_j.tolist()):
            hit_lists[r_][s_].append((int(hp[r_, s_, j_]),
                                      int(hnd[r_, s_, j_]), 0))
        pos_l = pos.tolist()
        for m, i in enumerate(idx0.tolist()):
            pi = p0 + i
            e0 = _End(names[pi], codes_list[pi], rcodes_list[pi], quals[pi])
            e1 = _End(names[n + pi], codes_list[n + pi],
                      rcodes_list[n + pi], quals[n + pi])
            for em, r_ in ((e0, m), (e1, M + m)):
                if not found[r_]:
                    continue
                em.pos = pos_l[r_]
                em.strand = int(strand[r_])
                em.n_diff = int(nd[r_])
                em.is_gap = 0
                em.b0 = em.n_diff
                em.b1 = int(b1[r_])
                em.mapq = int(mapq[r_])
                em.hits = hit_lists[r_]
            if prim[m]:
                self._gen_cigar(e0)
                self._gen_cigar(e1)
                states[i] = (e0, e1, "done", None)
            elif has_best[m]:
                od, j0_, j1_ = int(b_ord[m]), int(b_j0[m]), int(b_j1[m])
                fwd, bwd = (e0, e1) if od == 0 else (e1, e0)
                fr = m if od == 0 else M + m
                br = M + m if od == 0 else m
                fwd.pos = int(hp[fr, 0, j0_]); fwd.strand = 0
                fwd.n_diff = int(hnd[fr, 0, j0_]); fwd.is_gap = 0
                bwd.pos = int(hp[br, 1, j1_]); bwd.strand = 1
                bwd.n_diff = int(hnd[br, 1, j1_]); bwd.is_gap = 0
                self._gen_cigar(e0)
                self._gen_cigar(e1)
                states[i] = (e0, e1, "done", None)
            elif both[m]:
                states[i] = (e0, e1, "pair2", self._pairing2_requests(e0, e1))
            elif e0.pos != UINT or e1.pos != UINT:
                states[i] = (e0, e1, "single",
                             self._singleton_requests(e0, e1))
            else:
                states[i] = (e0, e1, "none", None)

    def _make_state(self, name0, name1, qual0, qual1, c0, rc0, c1, rc1,
                    amb0, amb1, end0, end1):
        """Per-pair state: the ends' SE results, each (result table of
        SEAligner._complete_batch, row), -> _End pair + pairing
        mode/requests (alnpe_core1 flow)."""
        o = self.opts
        e0 = _End(name0, c0, rc0, qual0)
        e1 = _End(name1, c1, rc1, qual1)
        for amb, e, (r, i) in ((amb0, e0, end0), (amb1, e1, end1)):
            if amb > PE_MAX_N_AMBIGUOUS:
                continue  # end stays unmapped (alnpe.c:495)
            if r["found"][i]:
                e.pos = int(r["pos"][i])
                e.strand = int(r["strand"][i])
                e.n_diff = int(r["n_diff"][i])
                e.is_gap = int(r["is_gap"][i])
                b1, xa = set_hits(
                    e.pos, e.n_diff, r["n_hits"][i], r["first_hit_ndiff"][i],
                    r["hits_pos"][i], r["hits_ndiff"][i], o.max_hits,
                )
                e.b0 = e.n_diff
                e.b1 = b1
                e.mapq = gen_mapq(e.b0, b1)
                hits0 = [(p, nd, e.is_gap) for (s, p, nd) in xa if s == 0]
                hits1 = [(p, nd, e.is_gap) for (s, p, nd) in xa if s == 1]
                e.hits = (hits0, hits1)
        if e0.pos != UINT32_MAX and e1.pos != UINT32_MAX:
            if self._pairing2_fast(e0, e1):
                return (e0, e1, "done", None)
            return (e0, e1, "pair2", self._pairing2_requests(e0, e1))
        if e0.pos != UINT32_MAX or e1.pos != UINT32_MAX:
            return (e0, e1, "single", self._singleton_requests(e0, e1))
        return (e0, e1, "none", None)

    def _finalize_states(self, states) -> List[str]:
        """Rescue + batched MD/NM + SAM emission for a list of pair
        states, in order."""
        o = self.opts
        out: List[str] = []
        # holds the nested device.sw_score stage
        with stage("host.rescue_prefilter"):
            scores_map = self._device_sw_scores(states)

        with stage("host.rescue"):
            for pi, (e0, e1, mode, reqs) in enumerate(states):
                if mode in ("pair2", "single"):
                    self._run_rescue(
                        e0, e1, reqs,
                        scores_map.get(pi) if scores_map else None,
                        snp=mode == "pair2",
                    )
        with stage("host.sam"):
            # batch the pure-match MD/NM/XV tags over all finalized ends
            md_map = {}
            if o.print_nm_md:
                items = []
                for pi, (e0, e1, _m, _r) in enumerate(states):
                    for ei, e in ((0, e0), (1, e1)):
                        if (e.pos != UINT32_MAX and e.seq_start == 0
                                and e.seq_end == e.l_seq - 1
                                and e.cigar == f"{e.l_seq}M"
                                and int(e.pos) + e.l_seq <= self.index.l_pac):
                            items.append((pi, ei, e))
                if items:
                    Ls = {e.l_seq for _p, _e, e in items}
                    for L in Ls:
                        grp = [it for it in items if it[2].l_seq == L]
                        pos_a = np.array([int(e.pos) for _p, _e, e in grp],
                                         np.int64)
                        rd = np.stack([
                            (e.rseq if e.strand else e.seq)[:L]
                            for _p, _e, e in grp
                        ])
                        for (pi, ei, _e), tag in zip(
                            grp, md_nm_tags_batch(self.index, pos_a, rd)
                        ):
                            md_map[(pi, ei)] = tag

            for pi, (e0, e1, _mode, _reqs) in enumerate(states):
                out.extend(
                    emit_pe(self.index, e0, e1, o.min_tlen, o.max_tlen,
                            o.print_xa_cigar, o.print_nm_md, o.rg_id,
                            lv_cigar=self._xa_cigar,
                            md_tags=(md_map.get((pi, 0)), md_map.get((pi, 1))))
                )
        return out

    def _align_pairs_uniform(self, names, quals, codes_list, rcodes_list,
                             n_amb, n) -> List[str]:
        """Uniform-length pipelined loop: device batch k+1 runs while
        chunk k's pairing/rescue/SAM happens on the host."""
        o = self.opts
        B = o.batch_size
        P = max(B // 2, 1)               # pairs per chunk (2 ends each)
        starts = list(range(0, n, P))
        inflight = []

        def dispatch(p0):
            # rows [0, cnt) hold end 0 and rows [cnt, 2 cnt) end 1: a
            # short last chunk carries no padding rows
            cnt = min(P, n - p0)
            chunk = np.stack(codes_list[p0 : p0 + cnt]
                             + codes_list[n + p0 : n + p0 + cnt])
            inflight.append((p0, cnt, self._se._dispatch_batch(chunk)))

        out: List[str] = []
        if starts:
            dispatch(starts[0])
        for si in range(len(starts)):
            if si + 1 < len(starts):
                dispatch(starts[si + 1])
            p0, cnt, handle = inflight.pop(0)
            res = self._se._complete_batch(handle)
            gap = res["is_gap"][:cnt] | res["is_gap"][cnt:]
            states = [None] * cnt
            fast_rows = np.nonzero(~gap)[0].tolist()
            with stage("host.pairing"):
                # pairs with a gapped end: the per-pair path, whose ends
                # carry is_gap into the pairing and their LV CIGARs
                for i in np.nonzero(gap)[0].tolist():
                    pi = p0 + i
                    states[i] = self._make_state(
                        names[pi], names[n + pi], quals[pi], quals[n + pi],
                        codes_list[pi], rcodes_list[pi],
                        codes_list[n + pi], rcodes_list[n + pi],
                        n_amb[pi], n_amb[n + pi], (res, i), (res, cnt + i),
                    )
                if fast_rows:
                    self._fill_states_fast(states, fast_rows, p0, cnt, names,
                                           quals, codes_list, rcodes_list,
                                           n_amb, n, res)
            out.extend(self._finalize_states(states))
        return out

    def _device_sw_scores(self, states):
        """Textbook-SW scores for every rescue window, batched on the
        device.  Returns {pair_idx: [score per request]} or None when
        the pre-filter is disabled/not worthwhile."""
        o = self.opts
        items = []   # (pi, k, snp, other, start, end, strand)
        for pi, (_e0, _e1, mode, reqs) in enumerate(states):
            if mode in ("pair2", "single"):
                for k, (anchor, other, start, end, strand) in enumerate(reqs):
                    items.append((pi, k, mode == "pair2", other,
                                  start, end, strand))
        if not self._se._device_sw_on(len(items)):
            return None

        idx = self.index
        l_pac = idx.l_pac
        scores_map: dict = {}
        for pi, (_e0, _e1, mode, reqs) in enumerate(states):
            if mode in ("pair2", "single"):
                scores_map[pi] = [None] * len(reqs)

        for snp_mode in (True, False):
            group = [it for it in items if it[2] == snp_mode]
            if not group:
                continue
            live = []
            for it in group:
                pi, k, _snp, other, start, end, strand = it
                if start >= l_pac or end < start:
                    # host path rejects these without scoring
                    scores_map[pi][k] = -1
                else:
                    live.append(it)
            if not live:
                continue
            W = max(it[5] - it[4] + 1 for it in live)
            W = ((W + 127) // 128) * 128   # bucket the window widths
            L = max(it[3].l_seq for it in live)
            L = ((L + 7) // 8) * 8
            B = len(live)
            refs = np.zeros((B, W), np.uint8)
            reads = np.zeros((B, L), np.uint8)
            lens = np.zeros(B, np.int32)
            src = idx.mixref if snp_mode else idx.pac
            for i, (pi, k, _s, other, start, end, strand) in enumerate(live):
                w = src[start : end + 1]
                refs[i, : len(w)] = w
                lens[i] = len(w)
                seq = other.rseq if strand else other.seq
                if snp_mode:
                    reads[i, : other.l_seq] = NT2BIT_NP[np.minimum(seq, 4)]
                else:
                    # plain mode pads with N (code 4): scores <= -1 so
                    # padding rows never raise the local max
                    reads[i, other.l_seq :] = 4
                    reads[i, : other.l_seq] = seq
            sc = self._se._sw_scores(refs, reads, lens, snp_mode)
            for i, (pi, k, *_rest) in enumerate(live):
                scores_map[pi][k] = int(sc[i])
        return scores_map

    def _xa_cigar(self, pos, strand_seq, k):
        text = self.index.mixref[pos : pos + len(strand_seq) + 4]
        pattern = NT2BIT_NP[np.minimum(strand_seq, 4)]
        return lv_cigar_host(text, pattern, int(k))

    def align_files(self, fq1: str, fq2: str, out_fh, cmd: str = "salt-tpu-torch"):
        print(sam_header(self.index, cmd, self.opts.rg_id), file=out_fh)
        b1, b2 = [], []
        it1, it2 = read_records(fq1), read_records(fq2)
        for r1, r2 in zip(it1, it2):
            b1.append(r1)
            b2.append(r2)
            if len(b1) >= 50000:
                for line in self.align_pairs(b1, b2):
                    print(line, file=out_fh)
                b1, b2 = [], []
        if b1:
            for line in self.align_pairs(b1, b2):
                print(line, file=out_fh)
