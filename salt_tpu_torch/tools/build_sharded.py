"""Whole-genome index built sharded by reference bin, each shard in a
fresh process, with each shard's build time and peak RSS.

    python -m salt_tpu_torch.tools.build_sharded [TOTAL] [N_SHARDS] --prefix P
        [--contigs N] [--monolithic]

Synthesizes TOTAL bases (default 3,100,000,000) in --contigs contigs
(default one a shard: synthesize_genome(TOTAL, N, seed=7, "uniform"))
with one SNP per 300 bases (sample_snps with default_rng(7)), writes them to
P.genome.npy and P.snp.npz, and builds the N_SHARDS (default 8)
sub-indexes of the contiguous bins partition_contigs_contiguous gives.
Each shard builds in its own process, so the RSS it reports is its own;
shards run side by side while the estimate of their peaks
(BYTES_PER_BASE a base) fits in the memory that was available when the
first one started, at most one a core.
Writes what `python -m salt_tpu_torch.cli idx --shards N` writes,
P.shard{i} and P.shards.json, and with --monolithic the whole-genome
bundle P as well (built alone, after the shards).  `cli aln --shards N P`
and `bench_large 0 --load P --shards N` read the result.  Bundles are
stored uncompressed.  Prints one SHARD line a shard and a table of
build seconds, save seconds, peak RSS and bytes a base (peak RSS is nan,
not measured, where /proc/self/status keeps no VmHWM).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

from ..sim.genome_gen import sample_snps, synthesize_genome

# peak RSS of one build a base, kept at what was measured for a
# 387.5 M-base shard of the 3.1 G-base genome (14.27 GB, 36.8 B/base;
# 39.7-43.4 with torch's CUDA libraries loaded beside it, which a build
# does not need), so that side-by-side builds do not run the host out of
# memory
BYTES_PER_BASE = 37
SNP_EVERY = 300
LUT = np.frombuffer(b"ACGTN", np.uint8)


def _mem_available() -> int:
    """Bytes the kernel reports as available (MemAvailable)."""
    with open("/proc/meminfo") as fh:
        for line in fh:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    raise RuntimeError("no MemAvailable in /proc/meminfo")


def _peak_rss() -> float:
    """This process's own peak resident bytes (VmHWM); nan, not measured,
    where /proc/self/status has none.  ru_maxrss is no stand-in: a child
    inherits its parent's peak across fork, and some kernels count it
    otherwise."""
    with open("/proc/self/status") as fh:
        for line in fh:
            if line.startswith("VmHWM:"):
                return int(line.split()[1]) * 1024
    return float("nan")


def _parse(argv):
    ap = argparse.ArgumentParser(prog="build_sharded")
    ap.add_argument("total", nargs="?", type=int, default=3_100_000_000)
    ap.add_argument("n_shards", nargs="?", type=int, default=8)
    ap.add_argument("--prefix", required=True)
    ap.add_argument("--contigs", type=int, default=0,
                    help="contigs of the genome (default: one a shard)")
    ap.add_argument("--monolithic", action="store_true",
                    help="also build the whole-genome bundle at the prefix")
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def _plan_path(prefix: str) -> str:
    return prefix + ".plan.json"


def synthesize(args) -> dict:
    """Write the genome, its SNPs and the plan (contigs, bins); return the
    plan."""
    # torch comes with this import; the builds, in other processes, never
    # import it
    from ..parallel.sharded import partition_contigs_contiguous

    t0 = time.time()
    n_contigs = args.contigs or args.n_shards
    contigs = synthesize_genome(args.total, n_contigs, seed=7,
                                config="uniform")
    lengths = [len(c) for _n, c in contigs]
    genome = np.concatenate([c for _n, c in contigs])
    names = [n for n, _c in contigs]
    del contigs
    np.save(args.prefix + ".genome.npy", genome)
    gpos, _alt, stype = sample_snps(genome, SNP_EVERY,
                                    np.random.default_rng(7))
    np.savez(args.prefix + ".snp.npz", gpos=gpos, stype=stype)
    del genome
    plan = {"names": names, "lengths": lengths,
            "bins": partition_contigs_contiguous(lengths, args.n_shards)}
    with open(_plan_path(args.prefix), "w") as fh:
        json.dump(plan, fh)
    print(f"[shardbuild] {args.total} bases in {n_contigs} contigs, "
          f"{len(gpos)} SNPs synthesized in {time.time() - t0:.1f}s",
          flush=True)
    return plan


def build_child(prefix: str, which: str) -> int:
    """Build one shard (`which` = its number) or the whole genome
    (`which` = "mono") from the files synthesize wrote, save it, and
    print its SHARD line."""
    from ..index.build import build_index_from_data
    from ..index.store import save_index
    from ..io.snp import SnpBlock

    with open(_plan_path(prefix)) as fh:
        plan = json.load(fh)
    starts = np.cumsum([0] + plan["lengths"])
    members = (range(len(plan["names"])) if which == "mono"
               else plan["bins"][int(which)])
    genome = np.load(prefix + ".genome.npy", mmap_mode="r")
    snp = np.load(prefix + ".snp.npz")
    gpos, stype = snp["gpos"], snp["stype"]
    contig_data, blocks = [], []
    for ci in members:
        s0, s1 = int(starts[ci]), int(starts[ci + 1])
        contig_data.append((plan["names"][ci], "synthetic",
                            LUT[np.minimum(genome[s0:s1], 4)]))
        sel = (gpos >= s0) & (gpos < s1)
        blocks.append(SnpBlock(plan["names"][ci],
                               (gpos[sel] - s0).astype(np.uint32), stype[sel]))
    del gpos, stype
    t0 = time.time()
    idx = build_index_from_data(contig_data, blocks, l_seed=19)
    build_s = time.time() - t0
    del contig_data, blocks
    t0 = time.time()
    save_index(idx, prefix if which == "mono" else f"{prefix}.shard{which}",
               compress=False)
    save_s = time.time() - t0
    rss = _peak_rss()
    print(f"SHARD {which} bases {idx.l_pac} build_s {build_s:.1f} "
          f"save_s {save_s:.1f} rss_gb {rss / 1e9:.2f} "
          f"b_per_base {rss / idx.l_pac:.1f} c_sa_len {len(idx.csa)} "
          f"r_text_len {idx.r_text_len} torch {int('torch' in sys.modules)}",
          flush=True)
    return 0


def _spawn(prefix: str, which: str) -> subprocess.Popen:
    """The build of `which` in a fresh interpreter, its output to
    P.build{which}.log."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    with open(f"{prefix}.build{which}.log", "w") as log:
        return subprocess.Popen(
            [sys.executable, "-m", "salt_tpu_torch.tools.build_sharded",
             "--prefix", prefix, "--child", which],
            stdout=log, stderr=subprocess.STDOUT, env=env)


def run_builds(prefix: str, jobs, workers: int):
    """Run the (which, bases) builds, side by side while their estimated
    peaks fit in the memory available now.  Returns the SHARD lines in
    job order; raises (and ends the others) if one fails."""
    budget = 0.9 * _mem_available()
    pending, running, lines = list(jobs), {}, {}
    try:
        while pending or running:
            while pending and len(running) < workers:
                which, n = pending[0]
                need = BYTES_PER_BASE * n
                held = sum(BYTES_PER_BASE * m for _p, m in running.values())
                if running and held + need > budget:
                    break
                running[which] = (_spawn(prefix, which), n)
                pending.pop(0)
            time.sleep(0.5)
            for which, (p, _n) in list(running.items()):
                if p.poll() is None:
                    continue
                del running[which]
                with open(f"{prefix}.build{which}.log") as fh:
                    out = fh.read()
                shard = [l for l in out.splitlines() if l.startswith("SHARD")]
                if p.returncode != 0 or not shard:
                    raise RuntimeError(f"build {which} failed "
                                       f"({p.returncode}):\n{out[-3000:]}")
                print(shard[0], flush=True)
                lines[which] = shard[0]
    finally:
        for p, _n in running.values():
            p.kill()
            p.wait()
    return [lines[w] for w, _n in jobs]


def parse_shard_line(line: str) -> dict:
    """A SHARD line as a dict of its fields."""
    f = line.split()
    out = {"which": f[1]}
    for k, v in zip(f[2::2], f[3::2]):
        out[k] = int(v) if v.isdigit() else float(v)    # nan: not measured
    return out


def main(argv=None) -> int:
    args = _parse(argv)
    if args.child is not None:
        return build_child(args.prefix, args.child)
    os.makedirs(os.path.dirname(os.path.abspath(args.prefix)), exist_ok=True)
    t0 = time.time()
    plan = synthesize(args)
    starts = np.cumsum([0] + plan["lengths"])
    jobs = [(str(i), int(starts[b[-1] + 1] - starts[b[0]]))
            for i, b in enumerate(plan["bins"])]
    print(f"[shardbuild] {len(jobs)} shards of {[n for _w, n in jobs]} bases; "
          f"{_mem_available() / 1e9:.1f} GB available, estimate "
          f"{BYTES_PER_BASE} B/base a build", flush=True)
    rows = run_builds(args.prefix, jobs, os.cpu_count() or 1)
    print(f"[shardbuild] {len(jobs)} shards built in {time.time() - t0:.1f}s "
          "(synthesis included)", flush=True)
    if args.monolithic:
        rows += run_builds(args.prefix, [("mono", args.total)], 1)
    with open(args.prefix + ".shards.json", "w") as fh:
        json.dump({"n_shards": args.n_shards, "bins": plan["bins"]}, fh)
    print(f"{'shard':>6} {'bases':>12} {'build_s':>8} {'save_s':>7} "
          f"{'rss_gb':>7} {'B/base':>7}")
    for r in map(parse_shard_line, rows):
        print(f"{r['which']:>6} {r['bases']:>12} {r['build_s']:>8.1f} "
              f"{r['save_s']:>7.1f} {r['rss_gb']:>7.2f} {r['b_per_base']:>7.1f}")
    print(f"[shardbuild] done in {time.time() - t0:.1f}s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
