"""BASELINE.md's measurement configs 2 and 3 on salt_tpu_torch, with
tools/bench_configs.py's data and options:

  config 2:  E. coli-scale plain index: a random 4,600,000-base genome
             with no SNP overlay, reads with 0.5% errors
  config 3:  chr21-scale SNP-aware index: 45,000,000 bases, one SNP per
             300 bp, reads drawn from the SNP haplotype with 0.1% errors
  config 3s: config 3 in sampled suffix-array mode

    python -m salt_tpu_torch.tools.bench_configs [all|2|3|3s] [--device D]
        [--genome-len N]

`all` runs 2 and 3.  --device is the aligner's device (default cuda, an
error without a card; cpu runs the kernels' plain versions); --genome-len
replaces the configs' genome length (a quick run at a small size).  Reads
are 100 bp in SALT_TPU_BENCH_BATCH-read batches (default 8,192): one
warm-up batch, then 3 timed.  Prints one line a config: the host build's
seconds, the device load's (the aligner's to_device_index, ending in a
device synchronize), reads/s, and the mapped primaries and the share of
them within 5 bp of the truth; on a card, its name and power limit
first.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import numpy as np
import torch

from ..index.build import build_index_from_data
from ..io.fasta import SeqRecord
from ..io.snp import SnpBlock
from ..pipeline.engine import SEAligner, SEOptions, checked_device

N_BATCHES = 3
L = 100
CONFIGS = {
    "2": ("2: E.coli-scale plain", 4_600_000, 0, 0.005, "full"),
    "3": ("3: chr21-scale SNP-aware", 45_000_000, 300, 0.001, "full"),
    "3s": ("3s: chr21-scale sampled", 45_000_000, 300, 0.001, "sampled"),
}


def make_data(genome_len, snp_every, err, batch):
    """tools/bench_configs.py's genome, SNPs and reads (default_rng(11)).
    Returns (contig data, SNP blocks, read records, read starts)."""
    rng = np.random.default_rng(11)
    lut = np.frombuffer(b"ACGT", dtype=np.uint8)
    codes = rng.integers(0, 4, genome_len, dtype=np.int64).astype(np.uint8)
    blocks = []
    hap = codes.copy()
    if snp_every:
        n_snp = genome_len // snp_every
        pos = np.sort(rng.choice(genome_len, n_snp, replace=False)
                      .astype(np.int64))
        ref_c = codes[pos]
        alt = ((ref_c + rng.integers(1, 4, n_snp)) % 4).astype(np.uint8)
        stype = ((1 << ref_c) | (1 << alt) | (ref_c << 4)).astype(np.uint8)
        blocks = [SnpBlock("chr1", pos.astype(np.uint32), stype)]
        hap[pos] = alt
    n_reads = batch * (N_BATCHES + 1)
    starts = rng.integers(0, genome_len - L, n_reads)
    win = hap[starts[:, None] + np.arange(L)]
    emask = rng.random(win.shape) < err
    win = np.where(emask, (win + 1) & 3, win).astype(np.uint8)
    recs = [SeqRecord(name=f"r{i}_{starts[i]}", comment=None,
                      seq=lut[win[i]].tobytes().decode("latin1"),
                      qual="I" * L)
            for i in range(n_reads)]
    return [("chr1", "synt", lut[codes])], blocks, recs, starts


def synchronize(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def run_config(tag, genome_len, snp_every, err, sa_mode="full",
               device="cuda", batch=8192) -> dict:
    """One config on `device`; prints its line and returns its numbers
    and the timed SAM records."""
    dev = checked_device(device)
    contig_data, blocks, recs, starts = make_data(genome_len, snp_every,
                                                  err, batch)
    t0 = time.time()
    idx = build_index_from_data(contig_data, blocks, l_seed=19)
    t_build = time.time() - t0
    opts = SEOptions(l_overlap=1, max_locate=500, print_nm_md=True,
                     print_xa_cigar=True, batch_size=batch, gap_batch=128,
                     sa_mode=sa_mode)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    al = SEAligner(idx, opts, device=dev)
    synchronize(dev)
    t_load = time.time() - t0
    al.align_records(recs[:batch])           # warm-up
    t0 = time.time()
    out = al.align_records(recs[batch:])
    synchronize(dev)
    dt = time.time() - t0
    n = len(out)
    ok = mapped = 0
    for i, line in enumerate(out):
        f = line.split("\t")
        if f[2] == "*":
            continue
        mapped += 1
        ok += abs(int(f[3]) - 1 - int(starts[batch + i])) <= 5
    index_bytes = al.dix.table_bytes() + (
        al.sampled.table_bytes() if al.sampled is not None else 0)
    peak = (f", peak device memory {torch.cuda.max_memory_allocated()} bytes"
            if dev.type == "cuda" else "")
    print(f"[config {tag}] build {t_build:.1f}s, device load {t_load:.2f}s "
          f"({index_bytes} index bytes on {dev}{peak}), "
          f"{n}/{dt:.2f}s = {n / dt:.0f} reads/s, "
          f"{mapped}/{n} mapped, {100.0 * ok / max(mapped, 1):.2f}% correct",
          flush=True)
    return {"build_s": t_build, "load_s": t_load, "reads_per_s": n / dt,
            "mapped": mapped, "correct": ok, "n": n, "sam": out}


def card_line() -> str:
    return "card: " + subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="bench_configs")
    ap.add_argument("which", nargs="?", default="all",
                    choices=("all", "2", "3", "3s"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--genome-len", type=int, default=0)
    args = ap.parse_args(argv)
    dev = checked_device(args.device)
    if dev.type == "cuda":
        print(card_line() + f"; torch {torch.__version__}", flush=True)
    batch = int(os.environ.get("SALT_TPU_BENCH_BATCH", "8192"))
    which = ("2", "3") if args.which == "all" else (args.which,)
    for key in which:
        tag, genome_len, *rest = CONFIGS[key]
        run_config(tag, args.genome_len or genome_len, *rest, device=dev,
                   batch=batch)
    return 0


if __name__ == "__main__":
    sys.exit(main())
