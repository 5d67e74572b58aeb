"""FASTA/FASTQ streaming parser with kseq-compatible record splitting.

Semantics mirror klib kseq (Align_src/kseq.h): a record starts at '>' or
'@'; the name is the header up to the first whitespace, the comment is the
rest of that line; sequence lines are concatenated until the next record
marker (FASTA) or the '+' line (FASTQ), and FASTQ quality runs until its
length reaches the sequence length.  Gzip input is auto-detected.
"""

from __future__ import annotations

import gzip
import io
from dataclasses import dataclass
from typing import Iterator, Optional


@dataclass
class SeqRecord:
    name: str
    comment: Optional[str]
    seq: str
    qual: Optional[str]


def _open_maybe_gzip(path: str):
    f = open(path, "rb")
    magic = f.read(2)
    f.seek(0)
    if magic == b"\x1f\x8b":
        return io.TextIOWrapper(gzip.GzipFile(fileobj=f))
    return io.TextIOWrapper(f)


def read_records(path: str) -> Iterator[SeqRecord]:
    with _open_maybe_gzip(path) as fh:
        yield from parse_records(fh)


def parse_records(fh) -> Iterator[SeqRecord]:
    line = fh.readline()
    # scan to the first record marker
    while line and not line.startswith((">", "@")):
        line = fh.readline()
    while line:
        header = line.rstrip("\n").rstrip("\r")
        marker = header[0]
        body = header[1:]
        # kseq: name = up to first whitespace, comment = remainder
        for i, ch in enumerate(body):
            if ch in " \t":
                name, comment = body[:i], body[i + 1 :]
                break
        else:
            name, comment = body, None
        seq_parts = []
        qual: Optional[str] = None
        line = fh.readline()
        while line and not line.startswith((">", "@", "+")):
            seq_parts.append(line.strip())
            line = fh.readline()
        seq = "".join(seq_parts)
        if line.startswith("+") and marker == "@":
            # FASTQ quality: read until length >= len(seq)
            qual_parts = []
            qlen = 0
            line = fh.readline()
            while line and qlen < len(seq):
                part = line.strip()
                qual_parts.append(part)
                qlen += len(part)
                line = fh.readline()
            qual = "".join(qual_parts)
        elif line.startswith("+"):
            # '+' inside a FASTA — treat as sequence end (kseq would too)
            line = fh.readline()
        yield SeqRecord(name=name, comment=comment if comment else None, seq=seq, qual=qual)


def trim_readno(name: str) -> str:
    """Strip a trailing '/1' or '/2' read-number suffix (query.c:140-144)."""
    if len(name) > 2 and name[-2] == "/" and name[-1].isdigit():
        return name[:-2]
    return name
