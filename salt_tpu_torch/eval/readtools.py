"""Read/SAM utility commands mirroring the reference's test helpers.

* ``sample``    — paired-aware FASTQ downsampler
  (Test/Simulator/wgsim-master/sample.py: uniform sample of N reads,
  same indices applied to both mates; that script is python-2 and
  never actually ran — this is the working equivalent, seeded for
  reproducibility).
* ``unmapped``  — dump unmapped records from a SAM
  (Test/Run_test/print_unalnedSam.sh: FLAG & 4; with --fasta also
  covers Test/.../extract_unmappedreads.py's read-sequence dump).
"""

from __future__ import annotations

import sys
from typing import List, Optional

import numpy as np

from ..io.fasta import read_records


def sample_fastq(paths: List[str], n: int, seed: int = 11,
                 suffix: str = ".sample") -> int:
    """Uniformly sample n records (the same positions from every file,
    keeping mates paired).  Writes <path><suffix>; returns n."""
    counts = []
    for p in paths:
        c = sum(1 for _ in read_records(p))
        counts.append(c)
    total = min(counts)
    if n > total:
        print(f"[sample] requested {n} > {total} reads available",
              file=sys.stderr)
        return 1
    rng = np.random.default_rng(seed)
    keep = np.zeros(total, dtype=bool)
    keep[rng.choice(total, size=n, replace=False)] = True
    for p in paths:
        with open(p + suffix, "w") as out:
            for i, rec in enumerate(read_records(p)):
                if i >= total:
                    break
                if keep[i]:
                    q = rec.qual if rec.qual else "I" * len(rec.seq)
                    out.write(f"@{rec.name}\n{rec.seq}\n+\n{q}\n")
    return 0


def dump_unmapped(sam_path: str, out=None, fasta: bool = False) -> int:
    """Unmapped records (FLAG & 4) from a SAM: full records by default
    (print_unalnedSam.sh), read sequences as FASTA with fasta=True
    (extract_unmappedreads.py)."""
    out = out or sys.stdout
    n = 0
    try:
        with open(sam_path) as fh:
            for line in fh:
                if not line.strip() or line.startswith("@"):
                    continue
                f = line.split("\t")
                if int(f[1]) & 4:
                    n += 1
                    if fasta:
                        out.write(f">{f[0]}\n{f[9]}\n")
                    else:
                        out.write(line)
    except BrokenPipeError:  # `| head` downstream: normal termination
        return 0
    print(f"[unmapped] {n} records", file=sys.stderr)
    return 0


def readtools_main(argv: Optional[List[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="salt-tpu readtools")
    sub = ap.add_subparsers(dest="cmd", required=True)
    sp = sub.add_parser("sample", help="downsample FASTQ (paired-aware)")
    sp.add_argument("-N", type=int, default=100000)
    sp.add_argument("-S", type=int, default=11, help="seed")
    sp.add_argument("fastq", nargs="+")
    up = sub.add_parser("unmapped", help="dump unmapped SAM records")
    up.add_argument("--fasta", action="store_true",
                    help="read sequences as FASTA instead of SAM records")
    up.add_argument("sam")
    args = ap.parse_args(argv)
    if args.cmd == "sample":
        return sample_fastq(args.fastq, args.N, seed=args.S)
    return dump_unmapped(args.sam, fasta=args.fasta)
