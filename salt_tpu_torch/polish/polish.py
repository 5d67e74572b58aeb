"""Polish tool: re-score a salt SAM's multi-hits against the plain
reference and re-pair / re-pick primaries.  Port of
salt_tpu/polish/polish.py.

Host Python apart from `score_hits_batched`, which re-scores a chunk's
hits in one call a read length of ops/lv.py:lv_distance_batch over the
equality-encoded reference bytes on `device`: the byte form of the CUDA
LV kernel on a GPU, its plain version on the CPU.  Stages are timed as
the aligners time theirs (utils/metrics.stage): host.polish_parse,
device.polish_score, host.polish_emit.

Follows Polish_src/polish.c (816 LoC) with its observable quirks
preserved:

  * hits = primary + XA entries per strand, converted to global offsets,
    sorted, deduped (rm_repeat_hits, polish.c:125-142)
  * re-scored with Landau-Vishkin (k=13 -> score -d, else -100000) or
    SSW (-s) against the 2-bit pac (polish.c:503-520)
  * PE: merge-scan pairing by offset distance in [350, 650]
    (__pairing, polish.c:156-188); best pair by score sum, else
    per-read best/second (polish.c:577-660)
  * MAPQ 60 if unique else 0 (polish.c:283-285); cigar "*" when the LV
    distance hit the 13 cap (polish.c:232-233); the flag1 bug that sets
    UNMAPPED instead of MATE_UNMAPPED (polish.c:388-389); the
    trailing-tab-after-qual printf quirks.
"""

from __future__ import annotations

import sys
from typing import Optional

import numpy as np
import torch

from ..constants import NST_NT4_TABLE
from ..index.build import SaltIndex
from ..ops.lv import lv_cigar_host, lv_distance_batch, lv_distance_host
from ..ops.ssw import ssw_align
from ..utils.metrics import stage

MAX_DISTANCE = 13
UNMAPPED_SCORE = -100000
MIN_ISIZE = 350
MAX_ISIZE = 650
GAP_OP, GAP_EX = 3, 1

SCORE_MAT_POLISH = np.array(
    [
        [2, -2, -2, -2, 0],
        [-2, 2, -2, -2, 0],
        [-2, -2, 2, -2, 0],
        [-2, -2, -2, 2, 0],
        [0, 0, 0, 0, 0],
    ],
    dtype=np.int8,
)


class SamRec:
    __slots__ = ("name", "flag", "l_seq", "nst_seq", "nst_rseq", "qual",
                 "hits", "strand", "primary", "b0", "b1", "cigar")

    def __init__(self, line: str):
        f = line.rstrip("\n").split("\t")
        self.name = f[0]
        self.flag = int(f[1])
        chrom, pos = f[2], int(f[3])
        seq = f[9]
        self.l_seq = len(seq)
        nst = NST_NT4_TABLE[np.frombuffer(seq.encode("latin1"), np.uint8)].copy()
        rnst = (3 - nst[::-1]).astype(np.uint8)  # N -> 255, as in C
        if self.flag & 0x10:
            nst, rnst = rnst, nst
        self.nst_seq, self.nst_rseq = nst, rnst
        self.qual = f[10]
        self.hits = ([], [])  # per strand: [chrom, pos(local 1-based), offset, score]
        if (self.flag & 0x4) == 0 and chrom != "*":
            s = 1 if (self.flag & 0x10) else 0
            self.hits[s].append([chrom, pos, 0, 0])
        for opt in f[11:]:
            if "XA" in opt:
                data = opt.split(":", 2)[2]
                for aln in data.split(";"):
                    if not aln:
                        break
                    parts = aln.split(",")
                    chrom_a, pos_a = parts[0], parts[1]
                    if pos_a[0] != "-":
                        p = int(pos_a.lstrip("+"))
                        self.hits[0].append([chrom_a, p, 0, 0])
                    else:
                        self.hits[1].append([chrom_a, int(pos_a[1:]), 0, 0])
        self.strand = -1
        self.primary = -1
        self.b0 = UNMAPPED_SCORE
        self.b1 = UNMAPPED_SCORE
        self.cigar = ""


class Polisher:
    """Polisher whose reference bytes and hit batches live on `device`."""

    def __init__(self, index: SaltIndex, use_sw: bool = False,
                 device="cuda"):
        self.index = index
        self.use_sw = use_sw
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' was asked for but no CUDA "
                               "device is available")
        self.tid = {c.name: i for i, c in enumerate(index.contigs)}
        self.offsets = [c.offset for c in index.contigs]
        self.pac = index.pac
        self._eq_pac = None  # equality-encoded pac on the device, made once

    def _refseq(self, offset: int, l: int) -> np.ndarray:
        l_pac = self.index.l_pac
        if offset > l_pac:
            raise SystemExit("[Error]: Out of reference length!")
        end = min(offset + l, l_pac)
        return self.pac[offset:end]

    def _prep_hits(self, sam: SamRec):
        """Global offsets + sort + rm_repeat_hits (polish.c:125-142)."""
        for s in (0, 1):
            for h in sam.hits[s]:
                h[2] = self.offsets[self.tid[h[0]]] + h[1] - 1
            sam.hits[s].sort(key=lambda h: h[2])
            dedup = []
            last = None
            for h in sam.hits[s]:
                if last is None or h[2] != last:
                    dedup.append(h)
                    last = h[2]
            sam.hits[s][:] = dedup

    def _score_hits(self, sam: SamRec):
        self._prep_hits(sam)
        for s in (0, 1):
            query = sam.nst_seq if s == 0 else sam.nst_rseq
            for h in sam.hits[s]:
                ref = self._refseq(h[2], sam.l_seq)
                if self.use_sw:
                    r = ssw_align(query.astype(np.int8), ref.astype(np.int8),
                                  SCORE_MAT_POLISH, GAP_OP, GAP_EX,
                                  sam.l_seq, want_cigar=False)
                    h[3] = r.score1
                else:
                    # LV over plain codes: byte-equality == AND-match only
                    # for one-hot codes; polish compares raw 0..3 codes, so
                    # encode one-hot before the shared LV kernel
                    q = query[: sam.l_seq]
                    d = _lv_plain(ref, q, MAX_DISTANCE)
                    h[3] = UNMAPPED_SCORE if d == -1 else -d

    def _lv_distances(self, pos: np.ndarray, pats: np.ndarray) -> list:
        """LV distances (k = 13, windows of exactly the read length) of
        the (B, L) equality-encoded reads `pats` against the reference at
        `pos`, scored on the polisher's device; one read-back."""
        if self._eq_pac is None:
            self._eq_pac = torch.from_numpy(_EQ_ENCODE[self.pac]).to(self.device)
        d = lv_distance_batch(
            self._eq_pac, torch.from_numpy(pos).to(self.device),
            torch.ones(len(pos), dtype=torch.bool, device=self.device),
            torch.from_numpy(pats).to(self.device),
            k=MAX_DISTANCE, window_pad=0, pat_precoded=True)
        return d.cpu().tolist()

    def score_hits_batched(self, sams):
        """Re-score every hit of a chunk of records with one batched LV
        call a read length (the device path of polish.c:503-520's
        per-hit loop).  Hits whose window is truncated by the reference
        end, and all SW-mode scoring, take the per-hit host path."""
        if self.use_sw:
            for sam in sams:
                self._score_hits(sam)
            return
        l_pac = self.index.l_pac
        by_len: dict = {}
        for sam in sams:
            self._prep_hits(sam)
            for s in (0, 1):
                query = sam.nst_seq if s == 0 else sam.nst_rseq
                for h in sam.hits[s]:
                    if h[2] + sam.l_seq <= l_pac:
                        by_len.setdefault(sam.l_seq, []).append(
                            (h, query[: sam.l_seq])
                        )
                    else:  # truncated window: host path
                        ref = self._refseq(h[2], sam.l_seq)
                        d = _lv_plain(ref, query[: sam.l_seq], MAX_DISTANCE)
                        h[3] = UNMAPPED_SCORE if d == -1 else -d
        for L, items in by_len.items():
            # salt_tpu pads the batch to a power of two for stable jit
            # shapes; eager kernels take the rows as they are
            pos = np.array([h[2] for h, _q in items], dtype=np.int64)
            pats = _EQ_ENCODE[np.stack([q for _h, q in items])]
            for (h, _q), di in zip(items, self._lv_distances(pos, pats)):
                h[3] = UNMAPPED_SCORE if di >= 255 else -di

    def _gen_cigar(self, sam: SamRec):
        s, it = sam.strand, sam.primary
        h = sam.hits[s][it]
        ref = self._refseq(h[2], sam.l_seq)
        query = sam.nst_seq if s == 0 else sam.nst_rseq
        d = h[3]
        if self.use_sw:
            r = ssw_align(query.astype(np.int8), ref.astype(np.int8),
                          SCORE_MAT_POLISH, GAP_OP, GAP_EX, sam.l_seq // 2,
                          want_cigar=True, filters=d)
            cig = ""
            if r.read_begin1 != 0:
                cig += f"{r.read_begin1}S"
            cig += "".join(f"{c}{op}" for c, op in r.cigar)
            if r.read_end1 + 1 != sam.l_seq:
                cig += f"{sam.l_seq - r.read_end1 - 1}S"
            sam.cigar = cig
        else:
            if d == -MAX_DISTANCE:
                sam.cigar = "*"
            else:
                e, cig = _lv_plain_cigar(ref, query[: sam.l_seq], -d)
                sam.cigar = cig

    # ---------------- output ----------------

    def _emit(self, sam: SamRec, flag: int, mate: Optional[SamRec],
              isize: int, out):
        mapped = sam.strand != -1
        parts = [sam.name, str(flag)]
        if not mapped:
            parts += ["*", "0"]
        else:
            h = sam.hits[sam.strand][sam.primary]
            parts += [h[0], str(h[1])]
        parts.append("60" if (sam.b1 == UNMAPPED_SCORE and sam.b0 != UNMAPPED_SCORE) else "0")
        parts.append(sam.cigar if mapped else "*")
        if mate is None:
            parts += ["*", "0", "0"]
        else:
            m_mapped = mate.strand != -1
            if not m_mapped:
                parts += ["*", "0"]
            else:
                mh = mate.hits[mate.strand][mate.primary]
                if not mapped or (mapped and sam.hits[sam.strand][sam.primary][0] != mh[0]):
                    parts += [mh[0], str(mh[1])]
                else:
                    parts += ["=", str(mh[1])]
            if mapped and m_mapped:
                p0 = sam.hits[sam.strand][sam.primary][1]
                p1 = mh[1]
                d = abs(p0 - p1)
                parts.append(str(d if sam.strand == 0 else -d))
            else:
                parts.append("0")
        s = sam.nst_seq if sam.strand == 0 else sam.nst_rseq
        seq_str = "".join("ACGT\x00"[min(c, 4)] for c in np.minimum(s[: sam.l_seq], 4))
        parts.append(seq_str)
        line = "\t".join(parts) + "\t"
        # qual quirk (polish.c:293-304): printf("%s\t") branches add a tab
        q = sam.qual
        orig_rev = bool(sam.flag & 0x10)
        if orig_rev:
            if sam.strand == 0:
                line += q[::-1]
            else:
                line += q + "\t"
        else:
            if sam.strand == 0:
                line += q + "\t"
            else:
                line += q[::-1]
        out.write(line + "\n")

    CHUNK = 4096

    def polish_se(self, sam_lines, out):
        for c0 in range(0, len(sam_lines), self.CHUNK):
            with stage("host.polish_parse"):
                sams = [SamRec(l) for l in sam_lines[c0 : c0 + self.CHUNK]]
            with stage("device.polish_score"):
                self.score_hits_batched(sams)
            with stage("host.polish_emit"):
                for sam in sams:
                    self._polish_se_one(sam, out)

    def _polish_se_one(self, sam: SamRec, out):
        best0 = best1 = UNMAPPED_SCORE
        for s in (0, 1):
            for j, h in enumerate(sam.hits[s]):
                if h[3] == UNMAPPED_SCORE:
                    continue
                if h[3] > best1:
                    best1 = h[3]
                    if best1 > best0:
                        best0, best1 = best1, best0
                        sam.strand, sam.primary = s, j
        sam.b0, sam.b1 = best0, best1
        if sam.strand != -1:
            self._gen_cigar(sam)
        flag = 0x40
        if sam.strand == 1:
            flag |= 0x10
        if sam.strand == -1:
            flag |= 0x4
        self._emit(sam, flag, None, 0, out)

    def polish_pe(self, sam_lines, out):
        n = len(sam_lines) // 2 * 2
        for c0 in range(0, n, self.CHUNK):
            with stage("host.polish_parse"):
                sams = [SamRec(l) for l in sam_lines[c0 : c0 + self.CHUNK]]
            with stage("device.polish_score"):
                self.score_hits_batched(sams)
            with stage("host.polish_emit"):
                for k in range(0, len(sams) - 1, 2):
                    self._polish_pe_one(sams[k], sams[k + 1], out)

    def _polish_pe_one(self, s0: SamRec, s1: SamRec, out):
        npp0 = _pairing(s0.hits[0], s1.hits[1])
        npp1 = _pairing(s1.hits[0], s0.hits[1])
        proper = (npp0 + npp1) != 0
        if not proper:
            for sam in (s0, s1):
                best0 = best1 = UNMAPPED_SCORE
                for s in (0, 1):
                    for j, h in enumerate(sam.hits[s]):
                        if h[3] == UNMAPPED_SCORE:
                            continue
                        if h[3] > best1:
                            best1 = h[3]
                            if best1 > best0:
                                best0, best1 = best1, best0
                                sam.strand, sam.primary = s, j
                sam.b0, sam.b1 = best0, best1
        else:
            best0 = best1 = UNMAPPED_SCORE
            st0 = st1 = -1
            it0 = it1 = -1
            for i in range(npp0):
                sc = s0.hits[0][i][3] + s1.hits[1][i][3]
                if sc == UNMAPPED_SCORE:
                    continue
                if sc > best1:
                    best1 = sc
                    if best1 > best0:
                        best0, best1 = best1, best0
                        st0, st1 = 0, 1
                        it0 = it1 = i
            for i in range(npp1):
                sc = s0.hits[1][i][3] + s1.hits[0][i][3]
                if sc == UNMAPPED_SCORE:
                    continue
                if sc > best1:
                    best1 = sc
                    if best1 > best0:
                        best0, best1 = best1, best0
                        st0, st1 = 1, 0
                        it0 = it1 = i
            s0.strand, s0.primary = st0, it0
            s1.strand, s1.primary = st1, it1
            s0.b0 = s1.b0 = best0
            s0.b1 = s1.b1 = best1
        if s0.strand != -1 and s0.primary != -1:
            self._gen_cigar(s0)
        if s1.strand != -1 and s1.primary != -1:
            self._gen_cigar(s1)
        pp = 0x2 if proper else 0
        f0 = 0x1 | pp | 0x40
        if s0.strand == 1:
            f0 |= 0x10
        if s1.strand == 1:
            f0 |= 0x20
        if s0.strand == -1:
            f0 |= 0x4
        if s1.strand == -1:
            f0 |= 0x8
        f1 = 0x1 | pp | 0x80
        # reference bug: mate-unmapped sets 0x4 again (polish.c:388-389)
        if s1.strand == -1:
            f1 |= 0x4
        if s0.strand == -1:
            f1 |= 0x4
        if s1.strand == 1:
            f1 |= 0x10
        if s0.strand == 1:
            f1 |= 0x20
        s1.name = s0.name  # polish prints sam0's name for both
        self._emit(s0, f0, s1, 0, out)
        self._emit(s1, f1, s0, 0, out)


def _pairing(fwd, bwd) -> int:
    """__pairing merge-scan (polish.c:156-188); reorders both lists in
    place so indices 0..n-1 pair up."""
    n = 0
    i = j = 0
    while i < len(fwd) and j < len(bwd):
        a, b = fwd[i][2], bwd[j][2]
        r = abs(a - b)
        if a > b or r < MIN_ISIZE:
            j += 1
        elif r > MAX_ISIZE:
            i += 1
        else:
            fwd[n], fwd[i] = fwd[i], fwd[n]
            bwd[n], bwd[j] = bwd[j], bwd[n]
            i += 1
            j += 1
            n += 1
    return n


# Polish links the ORIGINAL SNAP Landau-Vishkin (Polish_src/lv.c), whose
# match test is byte EQUALITY (XOR + count-trailing-zeroes), unlike the
# aligner's AND-based SNP-aware variant.  Re-encoding each byte value to a
# distinct power of two makes equality coincide with AND!=0, so the shared
# LV code (host helpers and the device kernel's byte form) reproduces it
# exactly.  Byte domain: codes 0..4 from the
# SAM parser plus 255 (= 3 - N on the revcomp path, samParser.c:139).
_EQ_ENCODE = np.zeros(256, dtype=np.uint8)
for _v, _b in ((0, 1), (1, 2), (2, 4), (3, 8), (4, 16), (255, 32)):
    _EQ_ENCODE[_v] = _b
_EQ_ENCODE[5:255] = 64  # any other stray byte value: self-match only


def _lv_plain(ref: np.ndarray, query: np.ndarray, k: int) -> int:
    return lv_distance_host(_EQ_ENCODE[ref], _EQ_ENCODE[query], k)


def _lv_plain_cigar(ref, query, k):
    return lv_cigar_host(_EQ_ENCODE[ref], _EQ_ENCODE[query], k,
                         straight_shortcut=True)


def polish_main(index: SaltIndex, sam_path: str, paired: bool,
                use_sw: bool = False, out=sys.stdout, device="cuda"):
    """Streams the SAM in CHUNK-sized slices (the reference loads line
    by line, polish.c:471; whole-file buffering would not survive
    100M-read inputs)."""
    p = Polisher(index, use_sw=use_sw, device=device)
    chunk: list = []
    # PE consumes lines two at a time; keep chunks even-sized
    size = Polisher.CHUNK if not paired else Polisher.CHUNK * 2
    with open(sam_path) as fh:
        for line in fh:
            if not line.strip() or line.startswith("@"):
                continue
            chunk.append(line)
            if len(chunk) >= size:
                (p.polish_pe if paired else p.polish_se)(chunk, out)
                chunk = []
    if chunk:
        (p.polish_pe if paired else p.polish_se)(chunk, out)
