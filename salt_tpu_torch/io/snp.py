"""SNP table ("hapmap" format) parser.

Format: one SNP per line, tab-separated: `chrom  pos(1-based)  alleles  ref`
where alleles looks like "A/G" (every second char is an allele).  Parsing
mirrors Index_src/hapmap.c:95-158: the per-SNP byte packs the one-hot
allele mask in the low nibble and the reference base code in the high
nibble.  The index-side parser does NOT skip a header line
(Index_src/hapmap.c:55 is commented out).

SNPs are grouped into per-chromosome blocks of consecutive lines sharing
the same chrom field; blocks are consumed in file order and matched
against contigs by name (localPattern.c:223-226).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, List

import numpy as np

from ..constants import NST_NT4_TABLE


@dataclass
class SnpBlock:
    chrom: str
    pos: np.ndarray    # uint32, 0-based positions
    stype: np.ndarray  # uint8, low nibble = allele one-hot, high = ref code


def _parse_line(line: str):
    fields = line.rstrip("\n").split("\t")
    chrom = fields[0]
    pos = int(fields[1]) - 1
    alleles = fields[2]
    ref = fields[3]
    stype = 0
    for j in range(0, len(alleles), 2):
        code = int(NST_NT4_TABLE[ord(alleles[j]) & 0xFF])
        stype |= 1 << code  # codes >3 land above the nibble; masked later
    refcode = int(NST_NT4_TABLE[ord(ref[0]) & 0xFF])
    stype |= refcode << 4
    return chrom, pos, stype & 0xFF


def read_snp_blocks(path: str) -> Iterator[SnpBlock]:
    cur_chrom = None
    pos: List[int] = []
    stype: List[int] = []
    with open(path) as fh:
        for line in fh:
            if not line.strip():
                continue
            chrom, p, t = _parse_line(line)
            if cur_chrom is None:
                cur_chrom = chrom
            elif chrom != cur_chrom:
                yield SnpBlock(cur_chrom, np.array(pos, np.uint32), np.array(stype, np.uint8))
                cur_chrom, pos, stype = chrom, [], []
            pos.append(p)
            stype.append(t)
    if cur_chrom is not None:
        yield SnpBlock(cur_chrom, np.array(pos, np.uint32), np.array(stype, np.uint8))


def allele_count(stype: int) -> int:
    """popcount of the low nibble (hapmap.h:59-62)."""
    return bin(stype & 15).count("1")


def allele_codes(stype: int) -> List[int]:
    """Alleles in ascending base-code order (hapmap.h snptype_map0..3)."""
    return [c for c in range(4) if (stype >> c) & 1]
