"""Host-side SE alignment engine: batching, device dispatch, hit
finalization (query_set_hits semantics) and SAM record assembly.
Port of the SE Landau-Vishkin path of salt_tpu/pipeline/engine.py in
full suffix-array mode.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from salt_tpu.constants import (
    DEFAULT_MAX_LOCATE,
    DEFAULT_MAX_SEED,
    NST_NT4_TABLE,
    SE_MAX_N_AMBIGUOUS,
    UINT32_MAX,
)
from salt_tpu.index.build import SaltIndex
from salt_tpu.io.fasta import read_records, trim_readno
from salt_tpu.io.sam import build_xa, emit_se, md_nm_tags_batch, sam_header
from salt_tpu.utils.metrics import progress, stage

from ..ops.locate import Loci
from ..ops.lv import NT2BIT_NP, lv_cigar_host
from .device_index import to_device_index
from .se import (
    pack_result,
    se_gapped,
    se_ungapped,
    se_ungapped_full,
    unpack_result,
)

_NOT_PORTED = "is not ported to salt_tpu_torch yet (see ROADMAP.md)"
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
    extend_algo: str = "lv"  # "sw" (-X 1) is a later slice
    sa_mode: str = "full"    # "sampled" is a later slice

    def cap(self) -> int:
        """Locate slots per read and strand."""
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


class SEAligner:
    """SE aligner whose index and batches live on `device`."""

    def __init__(self, index: SaltIndex, opts: SEOptions = None,
                 device="cuda"):
        self.index = index
        self.opts = opts or SEOptions()
        if self.opts.extend_algo != "lv":
            raise NotImplementedError(
                f"extend_algo={self.opts.extend_algo!r} {_NOT_PORTED}")
        if self.opts.sa_mode != "full":
            raise NotImplementedError(
                f"sa_mode={self.opts.sa_mode!r} {_NOT_PORTED}")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' was asked for but no CUDA "
                               "device is available")
        if self.opts.auto_k_hits and self.opts.max_hits <= 6:
            # the caller's options object may be shared: copy, not mutate
            self.opts = dataclasses.replace(
                self.opts, k_hits=min(self.opts.k_hits, 8))
        self.dix = to_device_index(index, self.device)

    # ---------------- device dispatch ----------------

    def _dispatch_batch(self, codes: np.ndarray):
        """Start the ungapped step for one batch of (B, L) uint8 codes;
        returns a handle for _complete_batch.  CUDA work is queued
        asynchronously while the host finalizes the previous batch."""
        o = self.opts
        with stage("device.dispatch"):
            fwd = torch.from_numpy(codes).to(self.device)
            rev = torch.from_numpy(revcomp(codes)).to(self.device)
            out = se_ungapped(
                self.dix, fwd, rev,
                l_overlap=o.l_overlap, max_seed=o.max_seed,
                max_locate=o.max_locate, cap=o.cap(), u=o.verify_width,
                k_hits=o.k_hits, pe_mode=o.pe_locate,
            )
            packed_dev = pack_result(out.res, (out.needs_gap, out.overflow))
        return fwd, rev, out, packed_dev

    def _complete_batch(self, handle):
        o = self.opts
        K = o.k_hits
        fwd, rev, out, packed_dev = handle
        L = fwd.shape[1]
        with stage("device.ungapped"):
            packed = packed_dev.cpu().numpy()
        res = unpack_result(packed, K)
        needs_gap = res["n_extra"][:, 0].astype(bool)
        overflow = res["n_extra"][:, 1].astype(bool)

        def sub_batches(rows, size, fn):
            """{row: unpacked result} of fn(sel) -> packed results, over
            sub-batches of at most `size` rows."""
            got = {}
            for s0 in range(0, len(rows), size):
                rr = rows[s0 : s0 + size]
                sel = torch.as_tensor(rr, device=self.device)
                fr = unpack_result(fn(sel).cpu().numpy(), K)
                got.update((r, {kk: v[i] for kk, v in fr.items()})
                           for i, r in enumerate(rr))
            return got

        def loci_rows(sel):
            return (Loci(*(a[sel] for a in out.loci0)),
                    Loci(*(a[sel] for a in out.loci1)))

        # rows whose locate or compact verify was truncated: verify their
        # located loci again at full width (rare)
        ovf_rows = np.nonzero(overflow)[0].tolist()
        full_res = {}
        if ovf_rows:
            def full_width(sel):
                return pack_result(se_ungapped_full(
                    self.dix, fwd[sel], rev[sel], *loci_rows(sel), k_hits=K))

            with stage("device.ungapped_full"):
                full_res = sub_batches(ovf_rows, o.gap_batch, full_width)
            for r, fr in full_res.items():
                needs_gap[r] = not fr["found"]

        gap_res = {}
        gap_rows = np.nonzero(needs_gap)[0].tolist()
        if gap_rows:
            k = o.gap_k if o.gap_k is not None else max(int(L) // 10, 0)

            def gapped(u):
                def fn(sel):
                    g = se_gapped(self.dix, fwd[sel], rev[sel],
                                  *loci_rows(sel), k=k, u=u, k_hits=K)
                    return pack_result(g.res, (g.overflow,))
                return fn

            with stage("device.gapped"):
                gap_res = sub_batches(
                    [r for r in gap_rows if r not in full_res], o.gap_batch,
                    gapped(o.verify_width))
            # rows with more gapped candidates than the compact width, and
            # the overflow rows: check every candidate
            wide = [r for r in gap_rows
                    if r in full_res or gap_res[r]["n_extra"][0]]
            with stage("device.gapped_full"):
                gap_res.update(sub_batches(wide, FULL_WIDTH_BATCH,
                                           gapped(o.cap())))
        return res, needs_gap, gap_res, full_res

    # ---------------- per-read finalization ----------------

    def _finalize_read(
        self, name, seq, rseq, qual, found, pos, strand, n_diff, is_gap,
        n_hits, first_hit_ndiff, hits_pos, hits_ndiff, md_tag=None,
        pre_hits=None,
    ) -> str:
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
        if is_gap:
            e, cigar = self._lv_cigar(pos, seq if strand == 0 else rseq, n_diff)
            md_tag = None
        else:
            cigar = f"{L}M"
        # XA cigars
        xa_with_cig = []
        for s, p, nd in xa_entries:
            cig = None
            if o.print_xa_cigar and is_gap:
                _, cig = self._lv_cigar(p, seq if s == 0 else rseq, nd)
            xa_with_cig.append((s, p, nd, cig))
        xa = build_xa(idx, pos, L, xa_with_cig, o.print_xa_cigar)
        return emit_se(idx, name, seq, rseq, qual, pos, strand, mapq, cigar,
                       xa, o.print_nm_md, o.rg_id, md_tag=md_tag)

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
        re-scattered in input order."""
        groups = group_by_length([r.seq for r in records])
        if len(groups) <= 1:
            return self._align_records_uniform(records)
        out: List[str] = [""] * len(records)
        for _L, idxs in groups:
            for i, line in zip(
                idxs, self._align_records_uniform([records[i] for i in idxs])
            ):
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
        for i in range(nb):
            gi = start + i
            if n_amb[gi] > SE_MAX_N_AMBIGUOUS:
                out_records[gi] = ""  # reference emits a blank line
                continue
            if needs_gap[i] and i in gap_res:
                r = gap_res[i]
                is_gap = True
            elif i in full_res:
                r = full_res[i]
                is_gap = False
            else:
                r = {k: v[i] for k, v in res.items()}
                is_gap = False
            out_records[gi] = self._finalize_read(
                names[gi], codes[gi], rcodes[gi], quals[gi],
                bool(r["found"]), int(r["pos"]), int(r["strand"]),
                int(r["n_diff"]), is_gap, r["n_hits"],
                r["first_hit_ndiff"], r["hits_pos"], r["hits_ndiff"],
                md_tag=md_tags.get(i), pre_hits=pre_map.get(i),
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
