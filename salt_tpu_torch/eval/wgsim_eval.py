"""Alignment accuracy evaluation against wgsim truth coordinates.

Re-implements all four modes of the reference's evaluator
(Test/Simulator/wgsim-master/wgsim_eval.pl):

* ``alneval`` (wgsim_eval.pl:32-110): the simulator embeds each read
  pair's true (chrom, left, right) in the read name as
  ``<chrom>_<left>_<right>_...``; an alignment is correct when its
  clip-adjusted coordinate is within ``gap`` (default 20) bp of the
  truth on the same chromosome — forward reads compare POS to the left
  coordinate, reverse reads compare the CIGAR-derived right end to the
  right coordinate, each also allowing the alternate clip adjustment.
  Counting matches the Perl exactly: per-``int(MAPQ/10)`` bucket wrong
  / mapped counts and cumulative totals from the highest bucket down.
* ``unique`` (wgsim_eval.pl:112-180): keep only the top-scoring record
  per read name (score from AS:i or a CIGAR-derived proxy), optionally
  recomputing MAPQ as ``int(f*(best1-best2)/best1 + .499)`` capped 250.
* ``uniqcmp`` (wgsim_eval.pl:182-257): compare two single-hit SAMs,
  bucketing reads into consistent/inconsistent/missing by mapping
  distance and MAPQ confidence.
* ``vareval`` (wgsim_eval.pl:112-150 of the Perl's vareval sub):
  pileup-format variant calls vs simulated truth, cumulative per-qual
  SNP/indel FP counts.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Iterable, List, Optional, Tuple

_NAME_RE = re.compile(r"^(\S+)_(\d+)_(\d+)_")
_CIG_REF = re.compile(r"(\d+)[MDN]")
_CLIP_HEAD = re.compile(r"^(\d+)[SH]")
_CLIP_TAIL = re.compile(r"(\d+)[SH]$")


@dataclass
class AlnEval:
    gap: int = 20
    # per-bucket (MAPQ//10): [mapped, wrong]
    c0: List[int] = field(default_factory=lambda: [0] * 26)
    c1: List[int] = field(default_factory=lambda: [0] * 26)
    n_unmapped: int = 0
    n_records: int = 0
    max_q: int = 0
    wrong_lines: List[str] = field(default_factory=list)
    keep_wrong: bool = False

    def add_sam_line(self, line: str) -> None:
        if line.startswith("@"):
            return
        t = line.rstrip("\n").split("\t")
        if len(t) < 11:
            return
        self.n_records += 1
        flag = int(t[1])
        chrom, left = t[2], int(t[3])
        if (flag & 0x4) or chrom == "*":
            self.n_unmapped += 1
            return
        q = int(t[4]) // 10
        self.max_q = max(self.max_q, q)
        rght = left
        for m in _CIG_REF.finditer(t[5]):
            rght += int(m.group(1))
        rght -= 1
        left0, rght0 = left, rght
        mh = _CLIP_HEAD.search(t[5])
        mt = _CLIP_TAIL.search(t[5])
        if mh:
            left -= int(mh.group(1))
            rght0 += int(mh.group(1))
        if mt:
            rght += int(mt.group(1))
            left0 -= int(mt.group(1))
        m = _NAME_RE.match(t[0])
        if not m:
            return
        tchrom, tleft, trght = m.group(1), int(m.group(2)), int(m.group(3))
        correct = True
        if tchrom != chrom:
            correct = False
        elif flag & 0x10:
            if abs(trght - rght) > self.gap and abs(trght - rght0) > self.gap:
                correct = False
        else:
            if abs(tleft - left) > self.gap and abs(tleft - left0) > self.gap:
                correct = False
        self.c0[q] += 1
        if not correct:
            self.c1[q] += 1
            if self.keep_wrong:
                self.wrong_lines.append(line)

    def table(self) -> List[Tuple[int, int, int, int, float]]:
        """[(qual_bucket, n_wrong, n_mapped, cum_mapped, cum_err_rate)]
        from the highest bucket down — the Perl report's rows."""
        rows = []
        cc0 = cc1 = 0
        for i in range(self.max_q, -1, -1):
            cc0 += self.c0[i]
            cc1 += self.c1[i]
            if cc0:
                rows.append((i, self.c1[i], self.c0[i], cc0, cc1 / cc0))
        return rows

    @property
    def n_mapped(self) -> int:
        return sum(self.c0)

    @property
    def n_wrong(self) -> int:
        return sum(self.c1)

    def report(self) -> str:
        out = ["qual n_wrong / n_mapped  total_mapped  total_error_rate"]
        for i, w, n, cum, rate in self.table():
            out.append(f"{i:02d}x {w:12d} / {n:<12d}  {cum:12d}  {rate:.3e}")
        out.append(
            f"# mapped={self.n_mapped} wrong={self.n_wrong} "
            f"unmapped={self.n_unmapped}"
        )
        return "\n".join(out)


def alneval(
    sam_lines: Iterable[str], gap: int = 20, keep_wrong: bool = False
) -> AlnEval:
    ev = AlnEval(gap=gap, keep_wrong=keep_wrong)
    for line in sam_lines:
        ev.add_sam_line(line)
    return ev


# ---------------------------------------------------------------------------
# unique: keep the top-scoring hit per read (wgsim_eval.pl `unique`)

_AS_RE = re.compile(r"AS:i:(\d+)")
_CIG_GAP = re.compile(r"(\d+)([ID])")
_CIG_M = re.compile(r"(\d+)M")


def _record_score(line: str, t: List[str], a: int, q: int, r: int) -> int:
    """AS:i when present, else matches*a - gaps*q - gaplen*r, floored at 1."""
    m = _AS_RE.search(line)
    if m:
        score = int(m.group(1))
    else:
        go = ge = mm = 0
        for g in _CIG_GAP.finditer(t[5]):
            go += 1
            ge += int(g.group(1))
        for g in _CIG_M.finditer(t[5]):
            mm += int(g.group(1))
        score = mm * a - go * q - ge * r
    return max(score, 1)


def unique(
    sam_lines: Iterable[str],
    out,
    recal_q: bool = False,
    fac: float = 250.0,
    match: int = 1,
    gap_open: int = 5,
    gap_ext: int = 2,
    multi_only: bool = False,
) -> None:
    """Emit one record per read name — the highest-scoring one — with
    optional MAPQ recomputation from (best1, best2)."""
    group: List[Tuple[int, List[str]]] = []
    last = None

    def flush():
        if not group:
            return
        best = best2 = 0
        best_i = -1
        for i, (s, _) in enumerate(group):
            if s > best:
                best2, best, best_i = best, s, i
            elif s > best2:
                best2 = s
        if recal_q and (not multi_only or len(group) > 1):
            mq = int(fac * (best - best2) / best + 0.499)
            group[best_i][1][4] = str(min(mq, 250))
        out.write("\t".join(group[best_i][1]))
        group.clear()

    for line in sam_lines:
        if line.startswith("@"):
            out.write(line)
            continue
        t = line.split("\t")
        if len(t) < 11:
            continue
        if t[0] != last:
            flush()
            last = t[0]
        group.append((_record_score(line, t, match, gap_open, gap_ext), t))
    flush()


# ---------------------------------------------------------------------------
# uniqcmp: compare two single-hit SAMs (wgsim_eval.pl `uniqcmp`)

_NM_RE = re.compile(r"NM:i:(\d+)")
_CIG_MI = re.compile(r"(\d+)[MI]")

UNIQCMP_LABELS = [
    "Consistent (high, high):  ",
    "Consistent (high, low ):  ",
    "Consistent (low , high):  ",
    "Inconsistent (high, high):",
    "Inconsistent (high, low ):",
    "Inconsistent (low , high):",
    "Second missing (high):    ",
    "Second missing (low ):    ",
    "First  missing (high):    ",
    "First  missing (low ):    ",
]


def _uniqcmp_read(lines: Iterable[str], table: dict, which: int, b: int):
    for line in lines:
        t = line.split("\t")
        if len(t) < 11:
            continue
        m = _NM_RE.search(line)
        nm = int(m.group(1)) if m else 0
        x = sum(int(g.group(1)) for g in _CIG_MI.finditer(t[5]))
        rec = (
            1 if int(t[1]) & 0x10 else 0, t[2], int(t[3]), int(t[4]),
            f"{x}:{nm}", x - b * nm,
        )
        table.setdefault(t[0], [None, None])[which] = rec


def uniqcmp(
    lines1: Iterable[str],
    lines2: Iterable[str],
    min_q: int = 20,
    same_dist: int = 100,
    diff_penalty: int = 4,
) -> List[int]:
    """Returns the 10 counters of the Perl report (UNIQCMP_LABELS order)."""
    a: dict = {}
    _uniqcmp_read(lines1, a, 0, diff_penalty)
    _uniqcmp_read(lines2, a, 1, diff_penalty)
    cnt = [0] * 10
    for p in a.values():
        p0, p1 = p
        if p0 is not None and p1 is not None:
            z = 0 if (
                p0[0] == p1[0] and p0[1] == p1[1]
                and abs(p0[2] - p1[2]) < same_dist
            ) else 1
            if p0[3] >= min_q and p1[3] >= min_q:
                cnt[z * 3 + 0] += 1
            elif p0[3] >= min_q:
                cnt[z * 3 + 1] += 1
            elif p1[3] >= min_q:
                cnt[z * 3 + 2] += 1
        elif p0 is not None:
            cnt[6 if p0[3] >= min_q else 7] += 1
        else:
            cnt[8 if p1[3] >= min_q else 9] += 1
    return cnt


# ---------------------------------------------------------------------------
# vareval: pileup variant calls vs simulated truth (wgsim_eval.pl `vareval`)

def vareval(
    truth_lines: Iterable[str],
    pileup_lines: Iterable[str],
    skip: int = 10,
    max_q: int = 200,
) -> List[List[int]]:
    """Returns rows [(q, cum_snp, cum_snp_fp, cum_indel, cum_indel_fp)]
    for q from max_q down to 0."""
    snp: dict = {}
    indel: dict = {}
    for line in truth_lines:
        t = line.split()
        if len(t) != 5 or t[2] == "-" or t[3] == "-":
            if len(t) >= 2:
                indel.setdefault(t[0], set()).add(int(t[1]))
        else:
            snp.setdefault(t[0], {})[int(t[1])] = t[3]
    cnt = [[0] * (max_q + 1) for _ in range(4)]
    for line in pileup_lines:
        t = line.split()
        if len(t) < 6 or t[2] == t[3]:
            continue
        q = min(int(float(t[5])), max_q)
        chrom, pos = t[0], int(t[1])
        if t[2] == "*":
            cnt[2][q] += 1
            ipos = indel.get(chrom, set())
            if not any(p in ipos for p in range(pos - skip, pos + skip + 1)):
                cnt[3][q] += 1
        else:
            cnt[0][q] += 1
            if pos not in snp.get(chrom, {}):
                cnt[1][q] += 1
    for i in range(max_q - 1, -1, -1):
        for j in range(4):
            cnt[j][i] += cnt[j][i + 1]
    return [
        [q, cnt[0][q], cnt[1][q], cnt[2][q], cnt[3][q]]
        for q in range(max_q, -1, -1)
    ]


def _main(argv: Optional[list] = None):
    import argparse
    import sys

    argv = list(argv) if argv is not None else sys.argv[1:]
    # subcommand-style dispatch like the Perl tool; bare args = alneval
    mode = "alneval"
    if argv and argv[0] in ("alneval", "unique", "uniqcmp", "vareval"):
        mode = argv.pop(0)

    if mode == "alneval":
        ap = argparse.ArgumentParser(prog="salt-tpu alneval")
        ap.add_argument("-g", "--gap", type=int, default=20)
        ap.add_argument("-p", "--print-wrong", action="store_true")
        ap.add_argument("sam", nargs="?", default="-")
        args = ap.parse_args(argv)
        fp = sys.stdin if args.sam == "-" else open(args.sam)
        ev = alneval(fp, gap=args.gap, keep_wrong=args.print_wrong)
        print(ev.report())
        if args.print_wrong:
            for line in ev.wrong_lines:
                sys.stderr.write(line)
        return 0

    if mode == "unique":
        ap = argparse.ArgumentParser(prog="salt-tpu alneval unique")
        ap.add_argument("-Q", dest="recal", action="store_true")
        ap.add_argument("-m", dest="multi_only", action="store_true")
        ap.add_argument("-f", type=float, default=250.0)
        ap.add_argument("-a", type=int, default=1)
        ap.add_argument("-q", type=int, default=5)
        ap.add_argument("-r", type=int, default=2)
        ap.add_argument("sam", nargs="?", default="-")
        args = ap.parse_args(argv)
        fp = sys.stdin if args.sam == "-" else open(args.sam)
        unique(fp, sys.stdout, recal_q=args.recal, fac=args.f,
               match=args.a, gap_open=args.q, gap_ext=args.r,
               multi_only=args.multi_only)
        return 0

    if mode == "uniqcmp":
        ap = argparse.ArgumentParser(prog="salt-tpu alneval uniqcmp")
        ap.add_argument("-q", type=int, default=20)
        ap.add_argument("-s", type=int, default=100)
        ap.add_argument("-b", type=int, default=4)
        ap.add_argument("sam1")
        ap.add_argument("sam2")
        args = ap.parse_args(argv)
        cnt = uniqcmp(open(args.sam1), open(args.sam2), min_q=args.q,
                      same_dist=args.s, diff_penalty=args.b)
        for label, c in zip(UNIQCMP_LABELS, cnt):
            print(f"{label} {c}")
        return 0

    if mode == "vareval":
        ap = argparse.ArgumentParser(prog="salt-tpu alneval vareval")
        ap.add_argument("-g", type=int, default=10)
        ap.add_argument("truth")
        ap.add_argument("pileup", nargs="?", default="-")
        args = ap.parse_args(argv)
        pp = sys.stdin if args.pileup == "-" else open(args.pileup)
        for row in vareval(open(args.truth), pp, skip=args.g):
            print("\t".join(str(x) for x in row))
        return 0


if __name__ == "__main__":
    raise SystemExit(_main())
