"""SAM emission, byte-for-byte compatible with Align_src/sam.c.

Header (aln_samhead, sam.c:56-84), SE records (aln_samse, sam.c:87-182),
XA alternate-hit tag (sam_add_xa, sam.c:186-240), MD/NM and the custom
XV tag listing read offsets that matched a known SNP allele
(sam_add_md_nm, sam.c:246-328).
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence

import numpy as np

from ..constants import UINT32_MAX
from ..index.build import SaltIndex

BASES = "ACGTN"

SAM_PAIRED = 0x1
SAM_PROPER = 0x2
SAM_UNMAPPED = 0x4
SAM_MATE_UNMAPPED = 0x8
SAM_REVERSE = 0x10
SAM_MATE_REVERSE = 0x20
SAM_READ1 = 0x40
SAM_READ2 = 0x80


def sam_header(index: SaltIndex, cmd: str, rg_id: Optional[str]) -> str:
    out = ["@HD\tVN:ec1fec2\tSO:unsorted"]
    for c in index.contigs:
        out.append(f"@SQ\tSN:{c.name}\tLN:{c.length}")
    # the reference prints the @RG line unconditionally with a NULL id
    out.append(f"@RG\tID:{rg_id if rg_id is not None else '(null)'}")
    t = time.localtime()
    out.append(
        f"@PG\tID:snpaln\tPN:snpaln\tCL:\"{cmd}\"\tDS:{t.tm_year}-{t.tm_mon}-{t.tm_mday}\tVN:0.1beta"
    )
    return "\n".join(out)


_OFFSETS_CACHE: dict = {}


def contig_offsets(index) -> np.ndarray:
    """Per-index cached contig offset array (avoids a per-record alloc).
    An entry holds the contig list it was made from: a later index that
    takes a freed index's id has another list, and gets its own entry."""
    key = id(index)
    entry = _OFFSETS_CACHE.get(key)
    if entry is None or entry[0] is not index.contigs:
        entry = (index.contigs, np.array([c.offset for c in index.contigs]))
        _OFFSETS_CACHE[key] = entry
    return entry[1]


def coor_pac2real(offsets: np.ndarray, n_seqs: int, pos: int) -> int:
    """bns_coor_pac2real binary search (Align_src/bntseq.c:269-280)."""
    left, mid, right = 0, 0, n_seqs
    while left < right:
        mid = (left + right) >> 1
        if pos >= offsets[mid]:
            if mid == n_seqs - 1:
                break
            if pos < offsets[mid + 1]:
                break
            left = mid + 1
        else:
            right = mid
    return mid


_BASE_LUT = np.frombuffer(b"ACGTN", dtype=np.uint8)


def seq_to_str(codes: np.ndarray) -> str:
    return (
        _BASE_LUT[np.minimum(codes, 4)].tobytes().decode("latin1")
    )


def emit_se(
    index: SaltIndex,
    name: str,
    seq: np.ndarray,
    rseq: np.ndarray,
    qual: Optional[str],
    pos: int,
    strand: int,
    mapq: int,
    cigar: str,
    xa: str,
    print_nm_md: bool,
    rg_id: Optional[str],
    seq_start: int = 0,
    md_tag: Optional[str] = None,   # precomputed (md_nm_tags_batch)
) -> str:
    """One SE SAM record (no trailing newline), aln_samse parity."""
    l_seq = len(seq)
    if pos == UINT32_MAX:
        s = [name, "4", "*\t0\t0\t*\t*\t0\t0", seq_to_str(seq)]
        s.append(qual if qual else "*")
        return "\t".join(s)
    offsets = contig_offsets(index)
    rid = coor_pac2real(offsets, len(index.contigs), pos)
    flag = SAM_REVERSE if strand else 0
    out = [
        name,
        str(flag),
        index.contigs[rid].name,
        str(pos - index.contigs[rid].offset + 1),
        str(mapq),
        cigar + "\t*\t0\t0",
    ]
    if strand:
        out.append(seq_to_str(rseq))
        out.append(qual[::-1] if qual else "*")
    else:
        out.append(seq_to_str(seq))
        out.append(qual if qual else "*")
    rec = "\t".join(out)
    if xa:
        rec += xa
    if print_nm_md:
        if md_tag is not None:
            rec += md_tag
        else:
            rec += md_nm_tag(index, pos, strand, seq, rseq, cigar, seq_start)
    if rg_id is not None:
        rec += f"\tRG:Z:{rg_id}"
    return rec


def build_xa(
    index: SaltIndex,
    primary_pos: int,
    l_seq: int,
    hits,  # list of (strand, pos, n_diff, cigar_str or None)
    print_cigar: bool,
) -> str:
    """XA:Z tag (sam_add_xa).  `hits` must already be the recorded hit
    lists in strand-0-then-1 order; entries at primary_pos are skipped."""
    if not hits:
        return ""
    offsets = contig_offsets(index)
    parts = []
    for strand, pos, n_diff, cig in hits:
        if pos == primary_pos:
            continue
        rid = coor_pac2real(offsets, len(index.contigs), pos)
        local = pos - index.contigs[rid].offset + 1
        cigar_field = (cig if cig is not None else f"{l_seq}M") if print_cigar else "*"
        parts.append(
            f"{index.contigs[rid].name},{'+-'[strand]}{local},{cigar_field},{n_diff};"
        )
    if not parts:
        return ""
    return "\tXA:Z:" + "".join(parts)


def emit_pe(index, q0, q1, min_tlen, max_tlen, print_xa_cigar, print_nm_md,
            rg_id, lv_cigar=None, md_tags=(None, None)):
    """alnpe_sam (sam.c:331-457).  q0/q1 are PE _End objects.  Returns two
    record strings, each with the reference's trailing newline (the C
    appends '\\n' to the record and the caller's printf adds another,
    producing a blank line after every record — reproduced by the
    caller printing these strings with a newline)."""
    q = (q0, q1)
    offsets = contig_offsets(index)
    rid = [-1, -1]
    pos = [0, 0]
    is_map = [False, False]
    for i in (0, 1):
        if q[i].pos != UINT32_MAX:
            is_map[i] = True
            rid[i] = coor_pac2real(offsets, len(index.contigs), q[i].pos)
            pos[i] = q[i].pos - index.contigs[rid[i]].offset + 1
    tlen = 0
    if is_map[0] and is_map[1]:
        if rid[0] != rid[1]:
            tlen = 0
        elif pos[0] < pos[1]:
            tlen = pos[1] + q[1].seq_end - q[1].seq_start + 1 - pos[0]
        else:
            # reference quirk: q0.seq_end - q1.seq_start (sam.c:356)
            tlen = pos[0] + q[0].seq_end - q[1].seq_start + 1 - pos[1]
        if (tlen & 0xFFFFFFFF) > max_tlen or (tlen & 0xFFFFFFFF) < min_tlen:
            tlen = 0
    out = []
    for i in (0, 1):
        e = q[i]
        m = q[1 - i]
        s = [e.name]
        flag = SAM_PAIRED
        if not is_map[i]:
            flag |= SAM_UNMAPPED
        if not is_map[1 - i]:
            flag |= SAM_MATE_UNMAPPED
        if e.strand == 1:
            flag |= SAM_REVERSE
        if m.strand == 1:
            flag |= SAM_MATE_REVERSE
        if tlen != 0:
            flag |= SAM_PROPER
        flag |= SAM_READ1 if i == 0 else SAM_READ2
        s.append(str(flag))
        if is_map[i]:
            cig = ""
            if e.seq_start != 0:
                cig += f"{e.seq_start}S"
            cig += e.cigar
            if e.seq_end != e.l_seq - 1:
                cig += f"{e.l_seq - e.seq_end - 1}S"
            s.extend([index.contigs[rid[i]].name, str(pos[i]), str(e.mapq), cig])
        else:
            if is_map[1 - i]:
                s.extend([index.contigs[rid[1 - i]].name, str(pos[1 - i]),
                          "255", "*"])
            else:
                s.extend(["*", "0", "255", "*"])
        if is_map[1 - i]:
            if rid[i] == rid[1 - i] or not is_map[i]:
                s.append("=")
            else:
                s.append(index.contigs[rid[1 - i]].name)
            s.append(str(pos[1 - i]))
        else:
            s.extend(["*", "0"])
        if tlen != 0:
            s.append(f"-{tlen}" if q[i].pos >= q[1 - i].pos else str(tlen))
        else:
            s.append("0")
        if e.strand == 1:
            s.append(seq_to_str(e.rseq))
            s.append(e.qual[::-1] if e.qual else "*")
        else:
            s.append(seq_to_str(e.seq))
            s.append(e.qual if e.qual else "*")
        rec = "\t".join(s)
        # XA (sam_add_xa) — hit lists already exclude the primary
        xa_entries = []
        for strand in (0, 1):
            for (p, nd, g) in e.hits[strand]:
                cigx = None
                if print_xa_cigar and g and lv_cigar is not None:
                    _, cigx = lv_cigar(p, e.seq if strand == 0 else e.rseq, nd)
                xa_entries.append((strand, p, nd, cigx))
        rec += build_xa(index, int(e.pos), e.l_seq, xa_entries, print_xa_cigar)
        if print_nm_md and is_map[i]:
            if md_tags[i] is not None:
                rec += md_tags[i]
            else:
                rec += md_nm_tag(index, int(e.pos), e.strand, e.seq, e.rseq,
                                 e.cigar, e.seq_start)
        if rg_id is not None:
            rec += f"\tRG:Z:{rg_id}"
        rec += "\n"
        out.append(rec)
    return out


def md_nm_tags_batch(
    index: SaltIndex,
    pos: np.ndarray,        # (B,) global positions (all < l_pac - L)
    reads: np.ndarray,      # (B, L) strand-selected read codes
) -> List[str]:
    """Vectorized pure-match-cigar MD/NM/XV tags for a whole batch —
    one pac gather + one mismatch scan instead of B small numpy calls
    (same output as md_nm_tag's fast path)."""
    B, L = reads.shape
    pac = index.pac
    mix = index.mixref
    ref = pac[pos[:, None].astype(np.int64) + np.arange(L)]
    rd = reads.astype(np.uint8)
    mism = ref != rd
    nm = mism.sum(axis=1)
    rows, cols = np.nonzero(mism)
    # SNP-allele hits at the mismatch sites (XV)
    snp_ok = (mix[pos[rows].astype(np.int64) + cols] >> rd[rows, cols]) & 1
    ref_b = ref[rows, cols]
    tags: List[str] = []
    k = 0
    for i in range(B):
        if nm[i] == 0:
            tags.append(f"\tMD:Z:{L}\tNM:i:0")
            continue
        e = k + int(nm[i])
        md = []
        prev = -1
        rs = []
        for j in range(k, e):
            c = int(cols[j])
            gap = c - prev - 1
            if gap:
                md.append(str(gap))
            md.append(BASES[min(int(ref_b[j]), 4)])
            prev = c
            if snp_ok[j] and len(rs) < 64:
                rs.append(c)
        tail = L - 1 - prev
        if tail:
            md.append(str(tail))
        tag = f"\tMD:Z:{''.join(md)}\tNM:i:{int(nm[i])}"
        if rs:
            tag += "\tXV:i:" + ",".join(str(x) for x in rs)
        tags.append(tag)
        k = e
    return tags


def md_nm_tag(
    index: SaltIndex,
    pos: int,
    strand: int,
    seq: np.ndarray,
    rseq: np.ndarray,
    cigar: str,
    seq_start: int,
) -> str:
    """MD/NM + XV tag (sam_add_md_nm, sam.c:246-328)."""
    import re

    pac = index.pac
    mix = index.mixref
    ref_pos = pos
    s = rseq if strand else seq
    si = seq_start

    # fast path: pure-match cigar (the overwhelmingly common case) —
    # vectorized mismatch scan instead of the per-base replay below
    if cigar == f"{len(s) - seq_start}M":
        n = len(s) - seq_start
        ref = pac[ref_pos : ref_pos + n].astype(np.int16)
        rd = np.asarray(s[si : si + n], dtype=np.int16)
        mm = np.nonzero(ref != rd)[0]
        nm = len(mm)
        if nm == 0:
            return f"\tMD:Z:{n}\tNM:i:0"
        md = []
        prev = -1
        for j in mm:
            gap = j - prev - 1
            if gap:
                md.append(str(gap))
            md.append(BASES[min(int(ref[j]), 4)])
            prev = j
        tail = n - 1 - prev
        if tail:
            md.append(str(tail))
        snp_ok = (mix[ref_pos + mm].astype(np.int64) >> rd[mm]) & 1
        rs = mm[snp_ok != 0][:64]
        tag = f"\tMD:Z:{''.join(md)}\tNM:i:{nm}"
        if len(rs):
            tag += "\tXV:i:" + ",".join(str(int(x)) for x in rs)
        return tag
    nm = 0
    n_match = 0
    md = []
    rs: List[int] = []
    for count, op in re.findall(r"(\d+)([MIDS])", cigar):
        n = int(count)
        if op == "M":
            for _ in range(n):
                bt = int(pac[ref_pos])
                if bt == s[si]:
                    n_match += 1
                else:
                    if (int(mix[ref_pos]) & (1 << int(s[si]))) != 0 and len(rs) < 64:
                        rs.append(si - seq_start)
                    nm += 1
                    if n_match != 0:
                        md.append(str(n_match))
                    n_match = 0
                    md.append(BASES[min(bt, 4)])
                ref_pos += 1
                si += 1
        elif op == "I":
            nm += n
            si += n
        elif op == "D":
            if n_match != 0:
                md.append(str(n_match))
            n_match = 0
            nm += n
            md.append("^")
            for _ in range(n):
                md.append(BASES[min(int(pac[ref_pos]), 4)])
                ref_pos += 1
        # 'S': nothing
    if n_match != 0:
        md.append(str(n_match))
    tag = f"\tMD:Z:{''.join(md)}\tNM:i:{nm}"
    if rs:
        tag += "\tXV:i:" + ",".join(str(x) for x in rs)
    return tag
