"""End-to-end accuracy harness of salt_tpu_torch, the port of
tools/run_accuracy.py (itself the port of the reference's
Test/Run_test/run_test.sh flow):

  1. simulate PE reads with wgsim (the reference tree's C wgsim, or
     sim/wgsim.py with --sim internal; zero sequencing error, 5%
     mutation, truth in read names),
  2. feed the simulated substitutions to the indexer as "known SNPs"
     (hapmap conversion of mutations.txt, run_test.sh:27-29),
  3. build the SNP-aware index,
  4. align SE and PE with salt_tpu_torch on --device (default cuda, an
     error without a card; cpu runs the kernels' plain versions),
  5. score with the alneval evaluator (wgsim_eval.pl port).

    python -m salt_tpu_torch.tools.run_accuracy [n_pairs] [--genome FA]
        [--genome-synth BASES] [--genome-config uniform|repeat]
        [--err-rate E] [--indel-frac F] [--sa-mode full|sampled]
        [--se-only] [--max-err X] [--sim vendored|internal] [--device D]

Arguments, defaults and output lines are tools/run_accuracy.py's; on a
card the first line is its name and power limit, and each run adds a line
with the launch counts of K1 (lv_distance) and K2 (sw_score).  Exit code
1 when the worse of the SE and PE error rates exceeds --max-err (0 for
the error-free protocol on a uniform or given genome, report-only
otherwise).  simulate, build, align_se and align_pe are the steps, for
callers that drive them one by one.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass

from ..eval.wgsim_eval import AlnEval, alneval
from ..index.build import SaltIndex, build_index
from ..io.fasta import read_records
from ..ops.lv_cuda import LV
from ..ops.sw_cuda import SW
from ..pipeline.engine import SEAligner, SEOptions, checked_device
from ..pipeline.pe_engine import PEAligner, PEOptions
from .bench_configs import card_line

# the reference tree of weiquan/salt as tools/make_oracle.sh copies and
# builds it
REF_TREE = "/tmp/refbuild"
WGSIM_BIN = f"{REF_TREE}/Test/Simulator/wgsim-master/wgsim"
WGSIM_SRC = f"{REF_TREE}/Test/Simulator/wgsim-master/wgsim.c"
DEFAULT_GENOME = f"{REF_TREE}/Test/Genome/Genome.fa"
DEFAULT_WORKDIR = os.path.join(tempfile.gettempdir(), "salt_tpu_accuracy")

# run_se_test.sh: -d -r 1 -l 100 -n 20 -c -m 500
SE_OPTS = dict(l_overlap=1, max_locate=500, print_nm_md=True,
               print_xa_cigar=True)
# run_pe_test.sh: -d -p -e -l 100 -c -a 350 -b 650 -r 5 (-m 1000)
PE_OPTS = dict(l_overlap=5, max_locate=1000, min_tlen=350, max_tlen=650,
               print_nm_md=True, print_xa_cigar=True)


def ensure_wgsim(workdir: str) -> str:
    for cand in (WGSIM_BIN, os.path.join(workdir, "wgsim")):
        if os.path.exists(cand):
            return cand
    out = os.path.join(workdir, "wgsim")
    subprocess.run(
        ["gcc", "-O2", "-o", out, WGSIM_SRC, "-lz", "-lm"], check=True
    )
    return out


def mutations_to_hapmap(mut_path: str, hap_path: str) -> int:
    """run_test.sh:27-29: keep single-base substitutions, canonicalize
    allele order (ref/alt sorted), emit chrom pos alleles ref."""
    n = 0
    with open(mut_path) as fin, open(hap_path, "w") as fout:
        for line in fin:
            w = line.rstrip("\n").split("\t")
            if len(w) < 4 or w[2] == "-" or w[3] == "-" or len(w[3]) != 1:
                continue
            ref, alt = w[2], w[3]
            alleles = f"{ref}/{alt}" if ref < alt else f"{alt}/{ref}"
            print(f"{w[0]}\t{w[1]}\t{alleles}\t{ref}", file=fout)
            n += 1
    return n


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="run_accuracy")
    ap.add_argument("n_pairs", nargs="?", type=int, default=20000)
    ap.add_argument("--genome", default=DEFAULT_GENOME)
    ap.add_argument("--genome-synth", type=int, default=0, metavar="BASES",
                    help="synthesize a genome of this many bases into the "
                         "workdir and use it (chr21-scale accuracy runs: "
                         "--genome-synth 45000000)")
    ap.add_argument("--genome-config", choices=["uniform", "repeat"],
                    default="repeat",
                    help="synthetic genome composition: 'repeat' plants "
                         "SINE/LINE families, satellite tandem arrays, "
                         "segmental duplications and N runs "
                         "(salt_tpu_torch.sim.genome_gen)")
    ap.add_argument("--n-contigs", type=int, default=1)
    ap.add_argument("--err-rate", type=float, default=0.0,
                    help="wgsim per-base sequencing error rate")
    ap.add_argument("--indel-frac", type=float, default=0.0,
                    help="wgsim fraction of mutations that are indels")
    ap.add_argument("--sa-mode", choices=["full", "sampled"], default="full")
    ap.add_argument("--batch", type=int, default=0,
                    help="override aligner batch size")
    ap.add_argument("--workdir", default=DEFAULT_WORKDIR)
    ap.add_argument("--seed-len", type=int, default=19)
    ap.add_argument("--se-only", action="store_true")
    ap.add_argument("--max-err", type=float, default=None,
                    help="fail if total error rate exceeds this (default: "
                         "0 for error-free sims, report-only otherwise)")
    ap.add_argument("--sim", choices=["vendored", "internal"],
                    default="vendored",
                    help="internal: salt_tpu_torch.sim.wgsim (no reference "
                         "tree or C toolchain needed)")
    ap.add_argument("--device", default="cuda",
                    help="the aligners' device (default cuda; cpu runs the "
                         "kernels' plain versions)")
    args = ap.parse_args(argv)
    if args.max_err is None:
        # strict gate only for the classic error-free protocol; any
        # error/indel/repeat-genome run is report-only by default
        # (genome_config only matters when a genome is synthesized)
        hard = (args.err_rate == 0 and args.indel_frac == 0
                and (not args.genome_synth
                     or args.genome_config == "uniform"))
        args.max_err = 0.0 if hard else 1.0
    return args


@dataclass
class Products:
    """The simulated inputs of one protocol, as files in the workdir."""
    genome: str
    r1: str
    r2: str
    hapmap: str


def simulate(args) -> Products:
    """Steps 1-2: the genome (synthesized with --genome-synth), the read
    pairs and the mutations, and the hapmap of the substitutions.  Files
    already in the workdir are reused: their names hold every knob that
    shapes them.  Switches args.sim to internal for a synthesized genome,
    as the original does."""
    os.makedirs(args.workdir, exist_ok=True)
    wd = args.workdir
    if args.genome_synth:
        args.sim = "internal"
        gfa = (f"{wd}/genome_{args.genome_config}_"
               f"{args.genome_synth}.fa")
        if not os.path.exists(gfa):
            from ..sim.genome_gen import synthesize_genome, write_fasta

            t0 = time.time()
            contigs = synthesize_genome(args.genome_synth, args.n_contigs,
                                        config=args.genome_config)
            write_fasta(contigs, gfa)
            print(f"[harness] {args.genome_synth/1e6:.0f}MB "
                  f"{args.genome_config} genome synthesized in "
                  f"{time.time()-t0:.1f}s", flush=True)
        args.genome = gfa
    # simulation products are keyed by every knob that shapes them, so
    # a rerun with different flags never silently reuses stale reads
    simtag = (f"{args.n_pairs}_{args.err_rate}_{args.indel_frac}_"
              f"{os.path.basename(args.genome)}")
    r1, r2 = f"{wd}/R1_{simtag}.fq", f"{wd}/R2_{simtag}.fq"
    mut = f"{wd}/mutations_{simtag}.txt"
    if not os.path.exists(r1):
        if args.sim == "internal":
            from ..sim.wgsim import SimParams
            from ..sim.wgsim import simulate as wgsim_simulate

            with open(r1, "w") as f1, open(r2, "w") as f2, \
                    open(mut, "w") as m:
                wgsim_simulate(args.genome, f1, f2, SimParams(
                    err_rate=args.err_rate, mut_rate=0.05,
                    indel_frac=args.indel_frac,
                    dist=500, std_dev=50, n_pairs=args.n_pairs,
                    size_l=100, size_r=100, is_hap=True, seed=42,
                ), mut_out=m)
        else:
            wgsim = ensure_wgsim(wd)
            with open(mut, "w") as m:
                subprocess.run(
                    [wgsim, "-S", "42", "-e", "0", "-r", "0.05", "-R", "0",
                     "-d", "500", "-s", "50", "-N", str(args.n_pairs),
                     "-1", "100", "-2", "100", "-h", args.genome, r1, r2],
                    stdout=m, stderr=subprocess.DEVNULL, check=True,
                )
    hap = f"{wd}/hapmap_{simtag}.txt"
    n_snp = mutations_to_hapmap(mut, hap)
    print(f"[harness] {args.n_pairs} pairs simulated, {n_snp} SNPs",
          flush=True)
    return Products(args.genome, r1, r2, hap)


def build(args, prod: Products) -> SaltIndex:
    """Step 3: the SNP-aware index of the genome and the hapmap."""
    t0 = time.time()
    idx = build_index(prod.genome, prod.hapmap, l_seed=args.seed_len)
    print(f"[harness] index built in {time.time()-t0:.1f}s", flush=True)
    return idx


def aligner_extra(args) -> dict:
    """The options --sa-mode and --batch add to both aligners'."""
    extra = {}
    if args.sa_mode == "sampled":
        extra["sa_mode"] = "sampled"
    if args.batch:
        extra["batch_size"] = args.batch
    return extra


@dataclass
class Run:
    """One aligner run: its SAM records (as align_records /
    align_pairs return them), their alneval table, its seconds and the
    launches of each kernel during it."""
    sam: list
    ev: AlnEval
    seconds: float
    launches: dict


def _counted(align):
    """Run align() with the kernels' launch counts set to 0 before it;
    returns (its result, seconds, {kernel: launches})."""
    LV.launches = SW.launches = 0
    t0 = time.time()
    out = align()
    dt = time.time() - t0
    return out, dt, {"lv_distance": LV.launches, "sw_score": SW.launches}


def align_se(idx: SaltIndex, recs1, extra: dict, device) -> Run:
    """Step 4, single-end: the reads of R1 with run_se_test.sh's options.
    The aligner is dropped on return."""
    al = SEAligner(idx, SEOptions(**SE_OPTS, **extra), device=device)
    out, dt, launches = _counted(lambda: al.align_records(recs1))
    return Run(out, alneval(line + "\n" for line in out if line), dt,
               launches)


def align_pe(idx: SaltIndex, recs1, recs2, extra: dict, device) -> Run:
    """Step 4, paired-end: the pairs of R1 and R2 with run_pe_test.sh's
    options.  Records end in a newline and blank ones are skipped by
    alneval."""
    pal = PEAligner(idx, PEOptions(**PE_OPTS, **extra), device=device)
    out, dt, launches = _counted(lambda: pal.align_pairs(recs1, recs2))
    return Run(out, alneval(line for line in out if line.strip()), dt,
               launches)


def report(tag: str, run: Run, n: int, unit: str) -> None:
    """The original's lines of one run, then the launch counts."""
    print(f"[{tag}] {n} {unit} in {run.seconds:.1f}s "
          f"({n/run.seconds:.0f} {unit}/s)")
    print(run.ev.report(), flush=True)
    print(f"[{tag}] kernel launches: lv_distance "
          f"{run.launches['lv_distance']}, sw_score "
          f"{run.launches['sw_score']}", flush=True)


def main(argv=None) -> int:
    args = parse_args(argv)
    dev = checked_device(args.device)
    if dev.type == "cuda":
        print(card_line(), flush=True)
    prod = simulate(args)
    idx = build(args, prod)
    extra = aligner_extra(args)

    recs1 = list(read_records(prod.r1))
    se = align_se(idx, recs1, extra, dev)
    report("SE", se, len(recs1), "reads")
    se_rate = se.ev.n_wrong / max(se.ev.n_mapped, 1)

    pe_rate = 0.0
    if not args.se_only:
        recs2 = list(read_records(prod.r2))
        # align_se dropped its aligner (salt_tpu deletes it here in
        # sampled mode): PE's device index is the only one resident
        pe = align_pe(idx, recs1, recs2, extra, dev)
        report("PE", pe, len(recs1), "pairs")
        pe_rate = pe.ev.n_wrong / max(pe.ev.n_mapped, 1)

    worst = max(se_rate, pe_rate)
    if worst > args.max_err:
        print(f"[harness] FAIL: error rate {worst:.2e} > {args.max_err:.2e}")
        return 1
    print("[harness] PASS")
    return 0


if __name__ == "__main__":
    sys.exit(main())
