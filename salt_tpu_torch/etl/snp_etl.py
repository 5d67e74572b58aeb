"""SNP ETL: convert public variant call formats into the aligner's
hapmap-style SNP table (``chrom\\tpos\\talleles\\tref``, 1-based pos,
alleles like ``A/G`` in A<C<G<T order).

Re-expresses the reference's offline tooling
(Index_src/convert_dbsnp.py, Index_src/extract_snp.py,
Index_src/extract_vcf_snp.py — the last is unfinished/broken upstream;
this module implements its evident intent) as working Python 3.

All functions stream: they never hold a whole variant file in memory.
"""

from __future__ import annotations

import gzip
import sys
from typing import Iterable, Iterator, Optional, TextIO

_COMPLEMENT = {"A": "T", "T": "A", "C": "G", "G": "C"}
_NT_ORDER = "ACGT"


def _open_text(path: str) -> TextIO:
    if path == "-":
        return sys.stdin
    if path.endswith(".gz"):
        return gzip.open(path, "rt")
    return open(path, "r")


def _allele_string(present: dict) -> str:
    """Alleles joined '/' in the fixed A,C,G,T order
    (Index_src/convert_dbsnp.py:67-71)."""
    return "/".join(nt for nt in _NT_ORDER if present.get(nt))


def dbsnp_to_hapmap(
    lines: Iterable[str],
    ref_ncbi: bool = False,
    alleles_from_rs: bool = False,
    min_freq: float = 0.1,
) -> Iterator[str]:
    """UCSC dbSNP table dump -> hapmap lines.

    Column layout and filters follow Index_src/convert_dbsnp.py:17-72:
    keep only ``variantType == 'single'`` spanning exactly one base;
    take alleles either from the observed ``A/C`` rs string (strand
    corrected) or from the frequency columns (>= min_freq); the
    reference base is always included.  Output position is the 1-based
    ``chromEnd``.
    """
    for line in lines:
        words = line.rstrip("\n").split("\t")
        if len(words) < 12:
            continue
        chrom = words[1]
        try:
            chrom_start = int(words[2])
            chrom_end = int(words[3])
        except ValueError:
            continue
        if words[11] != "single" or chrom_end - chrom_start != 1:
            continue
        strand = words[6]
        ref = words[7] if ref_ncbi else words[8]
        ref = ref.upper()
        if ref not in _COMPLEMENT:
            continue
        present = {ref: True}
        if alleles_from_rs:
            for nt in words[9].upper().split("/"):
                if len(nt) != 1 or nt not in _COMPLEMENT:
                    continue
                present[nt if strand == "+" else _COMPLEMENT[nt]] = True
        else:
            if len(words) < 26:
                continue
            freqs = words[25].split(",")
            for nt, f in zip(words[23].split(","), freqs):
                nt = nt.upper()
                if len(nt) != 1 or nt not in _COMPLEMENT:
                    continue
                try:
                    if float(f) < min_freq:
                        continue
                except ValueError:
                    continue
                present[nt if strand == "+" else _COMPLEMENT[nt]] = True
        alleles = _allele_string(present)
        if "/" not in alleles:  # monomorphic after filtering: no SNP
            continue
        yield f"{chrom}\t{chrom_end}\t{alleles}\t{ref}"


def vcf_to_hapmap(
    lines: Iterable[str],
    min_qual: Optional[float] = None,
    pass_only: bool = False,
) -> Iterator[str]:
    """VCF -> hapmap lines (bi-/multi-allelic SNPs only; indels are
    skipped — the aligner's SNP overlay is substitution-only).

    This is the working form of Index_src/extract_vcf_snp.py (broken
    upstream): keep records where REF is one base and at least one ALT
    is one base; pos is VCF's 1-based POS.
    """
    for line in lines:
        if not line or line[0] == "#":
            continue
        words = line.rstrip("\n").split("\t")
        if len(words) < 8:
            continue
        chrom, pos_s, _rsid, ref, alt, qual, filt = words[:7]
        ref = ref.upper()
        if len(ref) != 1 or ref not in _COMPLEMENT:
            continue
        if pass_only and filt not in (".", "PASS"):
            continue
        if min_qual is not None:
            try:
                if float(qual) < min_qual:
                    continue
            except ValueError:
                pass
        present = {ref: True}
        for a in alt.upper().split(","):
            if len(a) == 1 and a in _COMPLEMENT:
                present[a] = True
        alleles = _allele_string(present)
        if "/" not in alleles:
            continue
        yield f"{chrom}\t{pos_s}\t{alleles}\t{ref}"


def filter_hapmap_against_genome(
    genome_fa: str,
    hapmap_lines: Iterable[str],
    out_fa: Optional[TextIO] = None,
    wrap: int = 60,
) -> Iterator[str]:
    """Drop hapmap records whose stated position doesn't carry one of
    the listed alleles in the actual genome, and optionally re-emit the
    genome restricted to contigs that have variants
    (Index_src/extract_snp.py:80-104 semantics: the reference checks
    ``seq[pos-1] in alleles``).

    Yields the surviving hapmap lines in input order per contig.
    """
    from ..io.fasta import read_records

    seqs = {}
    order = []
    for rec in read_records(genome_fa):
        seqs[rec.name] = rec.seq.upper()
        order.append(rec.name)

    by_chrom: dict = {}
    for line in hapmap_lines:
        words = line.rstrip("\n").split("\t")
        if len(words) < 3:
            continue
        by_chrom.setdefault(words[0], []).append(words)

    for name in order:
        if name not in by_chrom:
            print(
                f"chrom {name} has no variants",
                file=sys.stderr,
            )
            continue
        if out_fa is not None:
            print(f">{name}", file=out_fa)
            s = seqs[name]
            for i in range(0, len(s), wrap):
                print(s[i : i + wrap], file=out_fa)
        seq = seqs[name]
        for words in by_chrom[name]:
            try:
                pos = int(words[1])
            except ValueError:
                continue
            if not (1 <= pos <= len(seq)):
                continue
            if seq[pos - 1] not in words[2]:
                continue
            yield "\t".join(words[:4] if len(words) >= 4 else words)


def _parse_dbsnp_single(lines: Iterable[str]):
    """Yield (chrom, chromStart, chromEnd, name, strand, refUCSC,
    observed, variantType) for well-formed UCSC dbSNP rows."""
    for line in lines:
        if not line or line[0] == "#":
            continue
        w = line.rstrip("\n").split("\t")
        if len(w) < 12:
            continue
        try:
            start, end = int(w[2]), int(w[3])
        except ValueError:
            continue
        yield w[1], start, end, w[4], w[6], w[8], w[9], w[11]


def snp2bed(genome_fa: str, dbsnp_lines: Iterable[str]) -> Iterator[str]:
    """dbSNP single-base SNPs -> BED rows ``chrom\\tpos-1\\tpos``,
    keeping only positions whose genome base is among the observed
    alleles (Script/snp2bed.py:33-96 semantics, strand-corrected)."""
    from ..io.fasta import read_records

    by_chrom: dict = {}
    for chrom, start, end, _name, strand, _ref, observed, vtype in \
            _parse_dbsnp_single(dbsnp_lines):
        if vtype != "single" or end - start != 1:
            continue
        present = {}
        for nt in observed.upper().split("/"):
            if len(nt) != 1 or nt not in _COMPLEMENT:
                continue
            present[nt if strand == "+" else _COMPLEMENT[nt]] = True
        alleles = _allele_string(present)
        by_chrom.setdefault(chrom, []).append((end, alleles))

    for rec in read_records(genome_fa):
        name = rec.name
        if name not in by_chrom:
            print(f"chrom {name} has no variants", file=sys.stderr)
            continue
        seq = rec.seq
        for pos, alleles in by_chrom[name]:
            if pos - 1 >= len(seq) or seq[pos - 1].upper() not in alleles:
                continue
            yield f"{name}\t{pos - 1}\t{pos}"


def _cigar_t_shift(cigar: str, q_shift: int) -> int:
    """Script/fill_rs.py:65-84 t_shift: read-offset -> reference-offset
    through the CIGAR (soft clips skipped), minus one."""
    import re as _re

    t = q = 0
    for n_s, op in _re.findall(r"(\d+)([SMIDX=])", cigar):
        n = int(n_s)
        if op == "S":
            continue
        if q > q_shift:
            break
        if op == "I":
            q += n
        elif op == "D":
            t += n
        else:  # M, X, =
            d = min(n, q_shift - q + 1)
            t += d
            q += d
    return t - 1


def fill_rs(sam_lines: Iterable[str], dbsnp_lines: Iterable[str],
            strict: bool = True) -> Iterator[str]:
    """Annotate salt SAM records with ``RS:Z:`` rs-id tags resolved from
    their ``XV:i`` SNP-hit read offsets (Script/fill_rs.py main loop).
    With strict=True an XV offset that maps to a position absent from
    the dbSNP table raises (the reference exits 1); otherwise the
    offset is skipped."""
    import re as _re

    rsdb = {}
    for chrom, start, end, name, _s, _r, _o, vtype in \
            _parse_dbsnp_single(dbsnp_lines):
        if vtype == "single" and end - start == 1:
            rsdb[(chrom, end)] = name

    xv_re = _re.compile(r"(?<=XV:i:)\S+")
    for line in sam_lines:
        line = line.rstrip("\n")
        if not line or line[0] == "@":
            yield line
            continue
        fields = line.split()
        if len(fields) > 11:
            m = xv_re.search(line)
            if m is not None:
                rname, pos, cigar = fields[2], int(fields[3]), fields[5]
                rs_ids = []
                for off in m.group(0).split(","):
                    rs_pos = _cigar_t_shift(cigar, int(off)) + pos
                    key = (rname, rs_pos)
                    if key not in rsdb:
                        if strict:
                            raise SystemExit(
                                f"[fill_rs] no rs id at {rname}:{rs_pos}\n{line}"
                            )
                        continue
                    rs_ids.append(rsdb[key])
                if rs_ids:
                    line += "\tRS:Z:" + ",".join(rs_ids)
        yield line


def extract_indel(genome_fa: str, dbsnp_lines: Iterable[str], prefix: str,
                  segment_len: int = 250) -> None:
    """dbSNP insertion/deletion records -> flank-joined segments
    (Script/extract_indel.py): writes ``prefix.fa`` (the genome,
    60-col) and ``prefix.indel.fa`` with one record per indel variant
    carrying ``chrom_start_end_type`` headers."""
    from ..io.fasta import read_records

    by_chrom: dict = {}
    for chrom, start, end, _n, strand, ref, observed, vtype in \
            _parse_dbsnp_single(dbsnp_lines):
        obs = observed.upper().split("/")
        if strand == "-":
            obs = [
                "".join(_COMPLEMENT.get(c, c) for c in reversed(x))
                for x in obs
            ]
        by_chrom.setdefault(chrom, []).append((start, end, vtype, ref, obs))

    with open(prefix + ".fa", "w") as out_fa, \
            open(prefix + ".indel.fa", "w") as out_ind:
        for rec in read_records(genome_fa):
            name, seq = rec.name, rec.seq
            if name not in by_chrom:
                print(f"chrom {name} has no variants", file=sys.stderr)
                continue
            print(f">{name}", file=out_fa)
            for i in range(0, len(seq), 60):
                print(seq[i : i + 60], file=out_fa)
            for start, end, vtype, ref, obs in by_chrom[name]:
                if start - 1 >= len(seq) or seq[start - 1].upper() not in obs:
                    continue
                flank = (
                    seq[max(0, start - 1 - segment_len) : start - 1]
                    + seq[end : min(end + segment_len, len(seq))]
                )
                header = f">{name}_{start}_{end}_{vtype}"
                if vtype == "deletion":
                    print(header, file=out_ind)
                    print(flank, file=out_ind)
                elif vtype == "insertion":
                    for a in obs:
                        if a == ref:
                            continue
                        print(header, file=out_ind)
                        print(flank, file=out_ind)


_SORTVCF_CHROMS = [f"chr{i}" for i in list(range(1, 23)) + ["X", "Y"]]


def sort_vcf(lines: Iterable[str], chroms=None) -> Iterator[str]:
    """Per-chromosome numeric position sort, chromosomes emitted in the
    canonical chr1..chr22,chrX,chrY order (Index_src/SortVcf.sh) —
    records on other contigs are dropped, as the shell script's
    ``grep -w`` loop does."""
    chroms = chroms or _SORTVCF_CHROMS
    want = set(chroms)
    by_chrom: dict = {c: [] for c in chroms}
    for line in lines:
        if not line or line[0] == "#":
            continue
        w = line.rstrip("\n").split("\t")
        if len(w) < 2 or w[0] not in want:
            continue
        try:
            pos = int(w[1])
        except ValueError:
            continue
        by_chrom[w[0]].append((pos, line.rstrip("\n")))
    for c in chroms:
        by_chrom[c].sort(key=lambda t: t[0])
        for _, line in by_chrom[c]:
            yield line


def stat_cov(bed_lines: Iterable[str], sam_lines: Iterable[str]) -> int:
    """Total aligned-base coverage over the BED regions — the native
    equivalent of Script/stat_cov.sh's ``samtools bedcov | awk sum``,
    computed directly from SAM text (M/D/N/=/X consume reference)."""
    import re as _re

    regions: dict = {}
    for line in bed_lines:
        w = line.split()
        if len(w) < 3:
            continue
        regions.setdefault(w[0], []).append((int(w[1]), int(w[2])))
    maxlen: dict = {}
    for c, v in regions.items():
        v.sort()
        maxlen[c] = max((e - s for s, e in v), default=0)
    cig_re = _re.compile(r"(\d+)([MIDNSHP=X])")
    import bisect

    total = 0
    for line in sam_lines:
        if not line or line[0] == "@":
            continue
        f = line.split("\t")
        if len(f) < 11 or f[2] == "*":
            continue
        chrom = f[2]
        if chrom not in regions:
            continue
        start = int(f[3]) - 1  # 0-based
        end = start
        for n_s, op in cig_re.findall(f[5]):
            if op in "MDN=X":
                end += int(n_s)
        regs = regions[chrom]
        # regions whose start is in [start - maxlen, end) can overlap
        lo_i = bisect.bisect_left(regs, (start - maxlen[chrom], -1))
        hi_i = bisect.bisect_right(regs, (end, float("inf")))
        for rs, re_ in regs[lo_i:hi_i]:
            lo, hi = max(rs, start), min(re_, end)
            if hi > lo:
                total += hi - lo
    return total


def _main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(
        prog="salt-tpu-snp-etl",
        description="variant-format converters for the SNP-aware index",
    )
    sub = ap.add_subparsers(dest="cmd", required=True)

    d = sub.add_parser("dbsnp", help="UCSC dbSNP table -> hapmap")
    d.add_argument("-n", "--ncbi", action="store_true")
    d.add_argument("-s", "--rs", action="store_true")
    d.add_argument("-f", "--frequency", type=float, default=0.1)
    d.add_argument("table")

    v = sub.add_parser("vcf", help="VCF -> hapmap (SNPs only)")
    v.add_argument("--min-qual", type=float, default=None)
    v.add_argument("--pass-only", action="store_true")
    v.add_argument("vcf")

    f = sub.add_parser("filter", help="drop hapmap rows contradicting the genome")
    f.add_argument("genome_fa")
    f.add_argument("hapmap")
    f.add_argument("--out-fa", default=None)

    b = sub.add_parser("snp2bed", help="dbSNP singles -> BED (Script/snp2bed.py)")
    b.add_argument("genome_fa")
    b.add_argument("dbsnp")

    r = sub.add_parser("fill-rs", help="annotate SAM XV hits with RS ids")
    r.add_argument("--lenient", action="store_true",
                   help="skip unresolvable XV offsets instead of exiting")
    r.add_argument("sam")
    r.add_argument("dbsnp")

    ix = sub.add_parser("extract-indel",
                        help="dbSNP indels -> flank segments (Script/extract_indel.py)")
    ix.add_argument("--segment-len", type=int, default=250)
    ix.add_argument("genome_fa")
    ix.add_argument("dbsnp")
    ix.add_argument("prefix")

    sv = sub.add_parser("sort-vcf", help="per-chrom position sort (SortVcf.sh)")
    sv.add_argument("vcf")

    sc = sub.add_parser("stat-cov",
                        help="total coverage over BED regions (stat_cov.sh)")
    sc.add_argument("bed")
    sc.add_argument("sam")

    args = ap.parse_args(argv)
    if args.cmd == "dbsnp":
        with _open_text(args.table) as fp:
            for line in dbsnp_to_hapmap(
                fp, ref_ncbi=args.ncbi, alleles_from_rs=args.rs,
                min_freq=args.frequency,
            ):
                print(line)
    elif args.cmd == "vcf":
        with _open_text(args.vcf) as fp:
            for line in vcf_to_hapmap(
                fp, min_qual=args.min_qual, pass_only=args.pass_only
            ):
                print(line)
    elif args.cmd == "filter":
        out_fa = open(args.out_fa, "w") if args.out_fa else None
        with _open_text(args.hapmap) as fp:
            for line in filter_hapmap_against_genome(
                args.genome_fa, fp, out_fa=out_fa
            ):
                print(line)
        if out_fa:
            out_fa.close()
    elif args.cmd == "snp2bed":
        with _open_text(args.dbsnp) as fp:
            for line in snp2bed(args.genome_fa, fp):
                print(line)
    elif args.cmd == "fill-rs":
        with _open_text(args.sam) as sf, _open_text(args.dbsnp) as df:
            for line in fill_rs(sf, df, strict=not args.lenient):
                print(line)
    elif args.cmd == "extract-indel":
        with _open_text(args.dbsnp) as fp:
            extract_indel(args.genome_fa, fp, args.prefix,
                          segment_len=args.segment_len)
    elif args.cmd == "sort-vcf":
        with _open_text(args.vcf) as fp:
            for line in sort_vcf(fp):
                print(line)
    elif args.cmd == "stat-cov":
        with _open_text(args.bed) as bf, _open_text(args.sam) as sf:
            print(stat_cov(bf, sf))
    return 0


if __name__ == "__main__":
    raise SystemExit(_main())
