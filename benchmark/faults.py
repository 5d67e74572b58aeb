"""Faults for the check of `correct` to catch: planted in the program
once it is built (`PLANT`, `plant(aligner)`), or where a call's answers
are produced (`SABOTAGE`, `sabotage(lines, genome)` over a call's SAM
lines, or pairs of lines, and the genome they are aligned to).  The
harness's tests run each of them through a whole run on the CPU;
benchmark/readings.py reads them on the chip at a cell's own size."""

from __future__ import annotations


def drop_half(lines, _genome=None):
    """Half of a call's answers left out."""
    return [("" if isinstance(x, str) else ("", "")) if i % 2 else x
            for i, x in enumerate(lines)]


def _shift(line: str) -> str:
    f = line.split("\t")
    if len(f) > 3 and f[3] not in ("0", "*"):
        f[3] = str(int(f[3]) + 1)
    return "\t".join(f)


def alter(lines, _genome=None):
    """An answer altered where it is produced: every record's position
    one base further on."""
    return [_shift(x) if isinstance(x, str) else (_shift(x[0]), x[1])
            for x in lines]


def wrong_contig(lines, genome):
    """Every mapped record names the genome's first contig, its POS
    kept: a contig lookup that always returns the first."""
    first = genome.contig_names[0]

    def one(line: str) -> str:
        f = line.split("\t")
        if len(f) > 3 and f[1].isdigit() and not int(f[1]) & 4:
            f[2] = first
        return "\t".join(f)

    return [one(x) if isinstance(x, str) else (one(x[0]), one(x[1]))
            for x in lines]


def no_rescue(aligner) -> None:
    """PE rescue left out: the SW windows next to a placed mate are never
    searched, and ends keep what the SE stage gave them."""
    if not hasattr(aligner, "_run_rescue"):
        raise ValueError("no_rescue needs a paired-end aligner")
    run_rescue = aligner._run_rescue
    aligner._run_rescue = (lambda q0, q1, _reqs, scores, snp:
                           run_rescue(q0, q1, [], scores, snp))


SABOTAGE = {"drop_half": drop_half, "alter": alter,
            "wrong_contig": wrong_contig}
PLANT = {"no_rescue": no_rescue}
