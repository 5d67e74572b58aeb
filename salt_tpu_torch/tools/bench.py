"""salt_tpu's own throughput driver (bench.py at the repository root) on
salt_tpu_torch: single-end reads/s on the bundled test genome, paired-end
pairs/s on the same fixture, and single-end reads/s on a 45,000,000-base
repeat-rich genome (the scale rider).

    python -m salt_tpu_torch.tools.bench [--genome PATH |
        --genome-synth BASES [--n-contigs N]] [--device D] [--no-pe]
        [--no-scale]

The fixtures are bench.py's, the same bytes:

  SE     the genome's contigs with a 5% SNP overlay drawn per contig
         (default_rng(42), non-ACGT bases skipped) and 24,576 reads of
         100 bases from the mutated haplotypes; one warm-up batch, then
         the rest in calls of 2 x BATCH reads
  PE     3 x BATCH FR pairs from the SNP haplotypes (default_rng(1234),
         insert N(450, 30) clipped to [110, 640]); a warm-up call of BATCH
         pairs, then 2 x BATCH pairs timed
  scale  synthesize_genome(45,000,000, 1, seed=7, config="repeat"), a SNP
         every 300 bases and 3 x BATCH reads of the haplotype with 0.1%
         substitutions (default_rng(77)); one warm-up batch, then
         2 x BATCH reads timed

BATCH is SALT_TPU_BENCH_BATCH (default 8,192).  Every aligner takes
bench.py's options (l_overlap 1, max_locate 500, NM/MD tags and XA
cigars, gap_batch 128) over build_index_from_data(..., l_seed=19).

--genome is the FASTA of the SE and PE fixtures, by default the reference
tree's bundled test genome (Test/Genome/Genome.fa, where run_accuracy
looks for it); a missing file raises.  --genome-synth BASES writes a
stand-in instead (sim/genome_gen.synthesize_genome, config "uniform", in
--n-contigs contigs, default 4) and reads it back the same way.
--device is the aligners' device (default cuda, an error without a card;
cpu runs the kernels' plain versions).  --no-pe and --no-scale leave out
those runs.

Times are host clock (perf_counter) around the timed calls, ending in a
device synchronize on a card.  Earlier lines go to stderr: the card's name
and power limit, bench.py's own lines, and for each run the seconds a
batch of every stage timer that fired (utils/metrics.stage) and K1's and
K2's launches in the timed calls.  The last line of stdout is bench.py's
JSON line: metric, value, unit, vs_baseline, then pe_pairs_per_sec and
scale45mb_repeat_se_reads_per_sec when those ran.  vs_baseline is the
rate over the C binary's 2,477 reads/s on the bundled genome, and null on
any other genome (a stand-in, or a FASTA of another name).  A failure in
any run raises: there is no partial line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from ..index.build import build_index_from_data
from ..io.fasta import SeqRecord, read_records
from ..io.snp import SnpBlock
from ..ops.lv_cuda import LV
from ..ops.sw_cuda import SW
from ..pipeline.engine import SEAligner, SEOptions, checked_device
from ..pipeline.pe_engine import PEAligner, PEOptions
from ..sim.genome_gen import sample_snps, synthesize_genome, write_fasta
from ..utils.metrics import metrics, metrics_reset
from .bench_configs import card_line
from .run_accuracy import DEFAULT_GENOME

# the C binary on the bundled genome, one thread (bench.py:3-8)
BASELINE_READS_PER_SEC = 2477.0
GENOME = DEFAULT_GENOME
BUNDLED = ("Test", "Genome", "Genome.fa")
READ_LEN = 100
N_READS = 24576
SCALE_GENOME_LEN = 45_000_000
STAGES = ("host.finalize", "device.dispatch", "device.gapped",
          "host.pairing", "host.sam", "host.rescue")
KERNELS = {"K1": LV, "K2": SW}
_T0 = time.perf_counter()


def stderr_line(msg: str) -> None:
    sys.stderr.write(msg + "\n")
    sys.stderr.flush()


def se_options(batch: int) -> SEOptions:
    return SEOptions(l_overlap=1, max_locate=500, print_nm_md=True,
                     print_xa_cigar=True, batch_size=batch, gap_batch=128)


def pe_options(batch: int) -> PEOptions:
    return PEOptions(l_overlap=1, max_locate=500, print_nm_md=True,
                     print_xa_cigar=True, batch_size=batch, gap_batch=128)


def records(seqs, prefix: str):
    return [SeqRecord(name=f"{prefix}{i}", comment=None, seq=s,
                      qual="I" * len(s)) for i, s in enumerate(seqs)]


# ---------------------------------------------------------------- fixtures


def stand_in_genome(n_bases: int, n_contigs: int, directory: str) -> str:
    """Write a uniform synthetic genome of n_bases in n_contigs contigs to
    directory/standin.fa; returns its path."""
    path = os.path.join(directory, "standin.fa")
    write_fasta(synthesize_genome(n_bases, n_contigs, config="uniform"), path)
    return path


def make_fixture(genome: str):
    """bench.py's SNP table and reads for the FASTA `genome` (fixed seed).
    Returns ([(name, comment, seq)], [SnpBlock], [read])."""
    recs = list(read_records(genome))
    contigs = [(r.name, r.comment or "(null)", r.seq) for r in recs]
    rng = np.random.default_rng(42)
    bases = "ACGT"
    blocks = []
    mutated = []
    for name, _, seq in contigs:
        L = len(seq)
        n_snp = int(L * 0.05)
        pos = np.sort(rng.choice(np.arange(L), size=n_snp, replace=False))
        stype = []
        mseq = list(seq)
        keep_pos = []
        for p in pos:
            c = seq[p].upper()
            if c not in bases:
                continue
            ref = bases.index(c)
            alt = (ref + int(rng.integers(1, 4))) % 4
            stype.append((1 << ref) | (1 << alt) | (ref << 4))
            mseq[p] = bases[alt]
            keep_pos.append(p)
        blocks.append(SnpBlock(name, np.array(keep_pos, np.uint32),
                               np.array(stype, np.uint8)))
        mutated.append("".join(mseq))
    reads = []
    for _ in range(N_READS):
        hap = mutated[int(rng.integers(0, len(mutated)))]
        start = int(rng.integers(0, len(hap) - READ_LEN))
        reads.append(hap[start : start + READ_LEN])
    return contigs, blocks, reads


def make_pe_fixture(contigs, blocks, n_pairs, isize=450, sd=30):
    """bench.py's FR read pairs from the SNP haplotypes (each SNP's first
    alt allele).  Returns (first ends, second ends) as strings."""
    rng = np.random.default_rng(1234)
    bases = "ACGT"
    comp = {"A": "T", "C": "G", "G": "C", "T": "A"}
    haps = []
    for (_name, _, seq), blk in zip(contigs, blocks):
        h = list(seq.upper())
        for p, st in zip(blk.pos, blk.stype):
            alts = [b for b in range(4) if (st & (1 << b)) and b != (st >> 4)]
            if alts:
                h[p] = bases[alts[0]]
        haps.append("".join(h))
    r1, r2 = [], []
    for _ in range(n_pairs):
        hap = haps[int(rng.integers(0, len(haps)))]
        tl = int(np.clip(rng.normal(isize, sd), READ_LEN + 10, 640))
        if len(hap) < tl + 2:
            continue
        s = int(rng.integers(0, len(hap) - tl))
        mate = hap[s + tl - READ_LEN : s + tl]
        r1.append(hap[s : s + READ_LEN])
        r2.append("".join(comp.get(c, "N") for c in reversed(mate)))
    return r1, r2


def scale_fixture(genome_len: int, batch: int):
    """The data of bench.py's run_scale: a repeat-rich genome, a SNP every
    300 bases, and 3 x batch reads s{i} of the haplotype with 0.1%
    substitutions.  Returns (contig data, [SnpBlock], read records)."""
    rng = np.random.default_rng(77)
    lut = np.frombuffer(b"ACGTN", dtype=np.uint8)
    (name, codes), = synthesize_genome(genome_len, 1, seed=7, config="repeat")
    gpos, alt, stype = sample_snps(codes, 300, rng)
    contig_data = [(name, "synthetic", lut[codes])]
    blocks = [SnpBlock(name, gpos.astype(np.uint32), stype)]
    hap = codes.copy()
    hap[gpos] = alt
    reads = []
    for s in rng.integers(0, genome_len - READ_LEN, 3 * batch):
        r = hap[s : s + READ_LEN].copy()
        err = rng.random(READ_LEN) < 0.001
        r[err] = rng.integers(0, 4, int(err.sum()))
        reads.append(lut[np.minimum(r, 4)].tobytes().decode("latin1"))
    return contig_data, blocks, records(reads, "s")


# ---------------------------------------------------------------- runs


@dataclass
class Run:
    """One run: its rate over the timed calls, the timed reads (pairs)
    and mapped records, the SAM lines of the warm-up and the timed calls
    in input order, the stage timers {name: (s, calls)} and kernel
    launches of the timed calls, the aligner and its input records (for
    a PE run, the two ends' lists)."""
    rate: float
    n: int
    mapped: int
    sam: list
    stages: dict
    launches: dict
    aligner: object
    records: object


def synchronize(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def mapped_count(lines) -> int:
    return sum(1 for line in lines if line and line.split("\t")[2] != "*")


def timed(fn, dev):
    """fn() between two clock reads that end in a device synchronize, the
    stage timers reset just before.  Returns (its result, seconds, stage
    timers, {kernel: launches in it})."""
    before = {k: kern.launches for k, kern in KERNELS.items()}
    synchronize(dev)
    metrics_reset()
    t0 = time.perf_counter()
    out = fn()
    synchronize(dev)
    dt = time.perf_counter() - t0
    return out, dt, metrics(), {k: kern.launches - before[k]
                                for k, kern in KERNELS.items()}


def report(tag: str, run: Run, log) -> None:
    """The run's stage timers (seconds a batch, of those that fired) and
    kernel launches."""
    fired = [f"{name} {run.stages[name][0] / run.stages[name][1]:.3f} s "
             f"({run.stages[name][1]} calls)"
             for name in STAGES if name in run.stages]
    log(f"[bench] {tag} stages, seconds a batch: {', '.join(fired)}")
    log(f"[bench] {tag} kernel launches in the timed calls: "
        + ", ".join(f"{k} {v}" for k, v in run.launches.items()))


def run_se(idx, reads, batch: int, dev, log=stderr_line) -> Run:
    """bench.py's SE run: one warm-up batch, then the rest of `reads` in
    calls of 2 x batch."""
    dev = checked_device(dev)
    recs = records(reads, "r")
    al = SEAligner(idx, se_options(batch), device=dev)
    warm = al.align_records(recs[:batch])           # warm-up, device load
    log(f"[bench] warmup done at t+{time.perf_counter() - _T0:.0f}s")

    def calls():
        return [al.align_records(recs[s0 : s0 + 2 * batch])
                for s0 in range(batch, len(recs), 2 * batch)]

    outs, dt, stages, launches = timed(calls, dev)
    sam = warm + [line for out in outs for line in out]
    n = len(sam) - len(warm)
    mapped = mapped_count(sam[len(warm):])
    log(f"aligned {n} reads in {dt:.2f}s; {mapped}/{n} mapped")
    run = Run(n / dt, n, mapped, sam, stages, launches, al, recs)
    report("SE", run, log)
    return run


def run_pe(contigs, blocks, idx, batch: int, dev, log=stderr_line) -> Run:
    """bench.py's run_pe: 2 x batch pairs timed after a warm-up call of
    batch pairs, on the SE fixture's haplotypes."""
    dev = checked_device(dev)
    n_pairs = 2 * batch
    r1, r2 = make_pe_fixture(contigs, blocks, n_pairs + batch)
    recs1, recs2 = records(r1, "p"), records(r2, "p")
    al = PEAligner(idx, pe_options(batch), device=dev)
    warm = al.align_pairs(recs1[:batch], recs2[:batch])   # warm-up
    out, dt, stages, launches = timed(
        lambda: al.align_pairs(recs1[batch : batch + n_pairs],
                               recs2[batch : batch + n_pairs]), dev)
    n = min(n_pairs, len(recs1) - batch)
    log(f"PE: {n} pairs in {dt:.2f}s = {n / dt:.0f} pairs/s")
    run = Run(n / dt, n, mapped_count(out), warm + out, stages, launches,
              al, (recs1, recs2))
    report("PE", run, log)
    return run


def run_scale(genome_len: int, batch: int, dev, log=stderr_line,
              idx=None) -> Run:
    """bench.py's run_scale: SE on scale_fixture(genome_len, batch), over
    `idx` when it is given (that fixture's index), else over one built
    here; one warm-up batch, then 2 x batch reads timed."""
    dev = checked_device(dev)
    contig_data, blocks, recs = scale_fixture(genome_len, batch)
    if idx is None:
        t0 = time.perf_counter()
        idx = build_index_from_data(contig_data, blocks, l_seed=19)
        log(f"[bench] scale index ({genome_len / 1e6:g}MB repeat) built "
            f"in {time.perf_counter() - t0:.0f}s")
    del contig_data, blocks
    al = SEAligner(idx, se_options(batch), device=dev)
    warm = al.align_records(recs[:batch])   # warm-up, device residency
    log(f"[bench] scale warmup done at t+{time.perf_counter() - _T0:.0f}s")
    out, dt, stages, launches = timed(
        lambda: al.align_records(recs[batch:]), dev)
    mapped = mapped_count(out)
    log(f"[bench] scale: {len(out)} reads in {dt:.2f}s = "
        f"{len(out) / dt:.0f} reads/s ({mapped} mapped)")
    run = Run(len(out) / dt, len(out), mapped, warm + out, stages,
              launches, al, recs)
    report("scale", run, log)
    return run


def result_line(se_rate: float, pe_rate=None, scale_rate=None,
                baseline: bool = False) -> str:
    """bench.py's JSON line; vs_baseline null unless `baseline` (the run's
    genome is the bundled one)."""
    rec = {"metric": "se_reads_per_sec_per_chip",
           "value": round(se_rate, 1),
           "unit": "reads/s",
           "vs_baseline": (round(se_rate / BASELINE_READS_PER_SEC, 3)
                           if baseline else None)}
    if pe_rate is not None:
        rec["pe_pairs_per_sec"] = round(pe_rate, 1)
    if scale_rate is not None:
        rec["scale45mb_repeat_se_reads_per_sec"] = round(scale_rate, 1)
    return json.dumps(rec)


def parse_args(argv):
    ap = argparse.ArgumentParser(prog="bench")
    src = ap.add_mutually_exclusive_group()
    src.add_argument("--genome", default=GENOME)
    src.add_argument("--genome-synth", type=int, default=0, metavar="BASES")
    ap.add_argument("--n-contigs", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--no-pe", action="store_true")
    ap.add_argument("--no-scale", action="store_true")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    dev = checked_device(args.device)
    if dev.type == "cuda":
        stderr_line(card_line() + f"; torch {torch.__version__}")
    batch = int(os.environ.get("SALT_TPU_BENCH_BATCH", "8192"))
    with tempfile.TemporaryDirectory(prefix="salt_bench_") as tmp:
        genome = (stand_in_genome(args.genome_synth, args.n_contigs, tmp)
                  if args.genome_synth else args.genome)
        contigs, blocks, reads = make_fixture(genome)
    idx = build_index_from_data(contigs, blocks, l_seed=19)
    stderr_line(f"[bench] index built at t+{time.perf_counter() - _T0:.0f}s")
    se = run_se(idx, reads, batch, dev)
    pe = None if args.no_pe else run_pe(contigs, blocks, idx, batch, dev)
    scale = (None if args.no_scale else
             run_scale(SCALE_GENOME_LEN, batch, dev))
    bundled = (not args.genome_synth
               and Path(args.genome).parts[-3:] == BUNDLED)
    print(result_line(se.rate, pe.rate if pe else None,
                      scale.rate if scale else None, bundled), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
