"""Large-genome run of salt_tpu_torch: a synthetic genome (chr21- to
GRCh38-scale) with a SNP overlay; index build time and peak RSS, the
index's bytes on the device, and SE reads/s (PE pairs/s with --pe) with
the accuracy of the primaries.  At 3.1 G bases the monolithic build runs
the uint32 SA-IS (csrc/sais.cpp) and every rank, count and position past
2^31; sharded by reference bin (--shards, built by build_sharded.py) each
shard stays under 2^31 and positions pass it where shards are lifted
into the genome.

    python -m salt_tpu_torch.tools.bench_large 3100000000 --build-only --save DIR/idx
    python -m salt_tpu_torch.tools.bench_large 0 --load DIR/idx [--shards 8] [--pe]
    python -m salt_tpu_torch.tools.bench_large 45000000 --genome-config repeat \\
        --read-indels 0.15 --pe

Options as tools/bench_large.py has them (--build-only, --save, --load,
--sa-mode, --snp-every, --genome-config, --read-indels, --pe and
SALT_TPU_BENCH_BATCH, default 4,096), and

  --device D        the aligner's device (default cuda, an error without
                    a card; cpu runs the kernels' plain versions)
  --shards S        align over the S sub-indexes (ShardedSEAligner /
                    ShardedPEAligner, every shard on the one device)
                    that build_sharded.py wrote: P.shard{i} and
                    P.shards.json at the --load prefix
  --sa-mode a,b     several modes in turn on one index and one read set,
                    the SAM of each held against the first's
  --sam-out P       write the timed SAM to P.se.sam (and P.pe.sam)
  --compare P       count the timed records that differ from P.se.sam
                    (P.pe.sam) among reads drawn EDGE bases inside their
                    contig (sharded against monolithic, across runs)
  --cpu-check N     align the first N timed reads (N/2 pairs) again on
                    the CPU with the same aligner and count differences

The data are made as tools/bench_large.py makes them: default_rng(7),
4 contigs at >= 1 G bases, SNPs by sim/genome_gen.sample_snps, l_seed 19,
reads with wgsim-style truth names.  Times are host clock ending in a
device synchronize.  Every line is logged with the time since start and
the peak RSS.
"""

from __future__ import annotations

import argparse
import gc
import io
import os
import resource
import subprocess
import sys
import time

import numpy as np
import torch

from ..constants import GAP_WINDOW_PAD
from ..eval.wgsim_eval import alneval
from ..index.build import build_index_from_data
from ..index.store import load_index, save_index
from ..io.fasta import SeqRecord
from ..io.snp import SnpBlock
from ..ops.lv_cuda import LV
from ..ops.sw_cuda import SW
from ..parallel.sharded import load_sharded_index
from ..parallel.sharded_engine import ShardedPEAligner, ShardedSEAligner
from ..pipeline import engine as engine_mod
from ..pipeline import se as se_mod
from ..pipeline.engine import SEAligner, SEOptions, checked_device
from ..pipeline.pe_engine import PEAligner, PEOptions
from ..sim.genome_gen import sample_snps, synthesize_genome
from ..utils.metrics import metrics_report, metrics_reset

L = 100
LUT = np.frombuffer(b"ACGTN", dtype=np.uint8)
# reads whose span lies this far inside their contig align the same
# sharded and monolithic (the gapped step's window pad and the 10 bases
# it can insert at 100 bp, and 2 spare; parallel/sharded.py)
EDGE = GAP_WINDOW_PAD + L // 10 + 2
TWO31 = 1 << 31
DRAW_CHUNK = 1 << 26     # bases a chunk of the uniform genome's draws


class Log:
    """Lines with the time since start and the peak RSS, to stdout."""

    def __init__(self):
        self.t0 = time.time()

    def __call__(self, msg: str) -> None:
        print(f"[t+{time.time() - self.t0:7.1f}s rss {rss_gb():6.2f}GB] "
              f"{msg}", flush=True)


def rss_gb() -> float:
    """Peak RSS of this process so far, GB."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


def parse_args(argv):
    ap = argparse.ArgumentParser(prog="bench_large")
    ap.add_argument("genome_len", nargs="?", type=int, default=45_000_000)
    ap.add_argument("--build-only", action="store_true")
    ap.add_argument("--save", default=None)
    ap.add_argument("--load", default=None)
    ap.add_argument("--sa-mode", default="full")
    ap.add_argument("--snp-every", type=int, default=300)
    ap.add_argument("--genome-config", default="uniform",
                    choices=("uniform", "repeat"))
    ap.add_argument("--read-indels", type=float, default=0.0)
    ap.add_argument("--pe", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--shards", type=int, default=0)
    ap.add_argument("--sam-out", default=None)
    ap.add_argument("--compare", default=None)
    ap.add_argument("--cpu-check", type=int, default=0)
    args = ap.parse_args(argv)
    if args.shards and not args.load:
        ap.error("--shards reads the shards build_sharded.py wrote: "
                 "give --load")
    args.modes = args.sa_mode.split(",")
    for m in args.modes:
        if m not in ("full", "sampled"):
            ap.error(f"--sa-mode {m!r}: expected full or sampled")
    return args


def uniform_codes(n: int, rng) -> np.ndarray:
    """rng.integers(0, 4, n, dtype=np.int64) as uint8, drawn DRAW_CHUNK at
    a time: the same values as the one call
    (tests/test_torch_bench_large.py), without its 8-byte-a-base
    temporary."""
    codes = np.empty(n, dtype=np.uint8)
    for s0 in range(0, n, DRAW_CHUNK):
        s1 = min(s0 + DRAW_CHUNK, n)
        codes[s0:s1] = rng.integers(0, 4, s1 - s0, dtype=np.int64)
    return codes


def build(args, rng, log):
    """Synthesize, build (and save) the index as tools/bench_large.py
    does.  Returns (idx, codes, gpos, alt)."""
    n = args.genome_len
    n_contig = 4 if n >= 1_000_000_000 else 1
    log(f"synthesizing {n / 1e6:.0f}MB {args.genome_config} genome, "
        f"{n_contig} contigs...")
    if args.genome_config == "uniform":
        codes = uniform_codes(n, rng)
    else:
        codes = np.concatenate([c for _n, c in synthesize_genome(
            n, n_contig, seed=7, config=args.genome_config)])
    gpos, alt, stype_all = sample_snps(codes, args.snp_every, rng)
    clen = n // n_contig
    contig_data, blocks = [], []
    for ci in range(n_contig):
        s0 = ci * clen
        s1 = n if ci == n_contig - 1 else (ci + 1) * clen
        contig_data.append((f"chr{ci + 1}", "synthetic", LUT[codes[s0:s1]]))
        sel = (gpos >= s0) & (gpos < s1)
        blocks.append(SnpBlock(f"chr{ci + 1}",
                               (gpos[sel] - s0).astype(np.uint32),
                               stype_all[sel]))
    log(f"{len(gpos) / 1e6:.2f}M SNPs synthesized")
    t0 = time.time()
    idx = build_index_from_data(contig_data, blocks, l_seed=19)
    build_s = time.time() - t0
    log(f"index built in {build_s:.1f}s "
        f"(text {idx.r_text_len / 1e6:.1f}M local-pattern chars); "
        f"peak RSS {rss_gb():.2f}GB = {rss_gb() * 1e9 / n:.1f} B/base")
    del contig_data, blocks
    if args.save:
        t0 = time.time()
        save_index(idx, args.save, compress=False)
        d = os.path.dirname(os.path.abspath(args.save))
        sz = sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d)
                 if f.startswith(os.path.basename(args.save)))
        log(f"saved to {args.save} in {time.time() - t0:.1f}s "
            f"({sz / 1e9:.2f}GB)")
    return idx, codes, gpos, alt


def load(args, log):
    """Reload a saved bundle (or the shards build_sharded.py wrote) and
    recover the SNP alleles from mixRef, whose nibble holds both: the
    haplotype's base is the bit that is not the reference's.  Returns
    (idx, (shard indexes, bins) or None, codes, gpos, alt)."""
    t0 = time.time()
    shards = None
    if args.shards:
        idx, *shards = load_sharded_index(args.load)
        if len(shards[0]) != args.shards:
            raise ValueError(f"{args.load} holds {len(shards[0])} shards, "
                             f"not {args.shards}")
    else:
        idx = load_index(args.load)
    log(f"bundle loaded in {time.time() - t0:.1f}s "
        f"({idx.l_pac / 1e6:.0f}M bases"
        + (f", {args.shards} shards" if shards else
           f", {idx.r_text_len / 1e6:.1f}M R chars") + ")")
    codes = idx.pac
    alt_mask = (idx.mixref & np.uint8(15)) & ~(np.uint8(1) << codes)
    gpos = np.nonzero(alt_mask)[0]
    am = alt_mask[gpos]
    alt = np.zeros(len(gpos), np.uint8)
    for b in range(4):
        alt[am == (1 << b)] = b
    log(f"{len(gpos) / 1e6:.2f}M SNP positions recovered from mixRef")
    return idx, shards, codes, gpos, alt


def contig_of(contigs, s: int):
    """(offset, name, length) of the contig holding global position s."""
    co = (0, "chr1", 0)
    for c in contigs:
        if c.offset <= s < c.offset + c.length:
            co = (c.offset, c.name, c.length)
    return co


def se_reads(hap, contigs, n_reads, read_indels, rng):
    """tools/bench_large.py's SE reads: both strands, 0.1% errors, one
    indel in a `read_indels` share; truth 'contig_left_right_i'."""
    genome_len = len(hap)
    recs = []
    while len(recs) < n_reads:
        s = int(rng.integers(0, genome_len - L - 8))
        span = L
        r = hap[s : s + L + 8].copy()
        if (r >= 4).any():
            continue
        if read_indels > 0 and rng.random() < read_indels:
            ilen = int(rng.integers(1, 5))
            p = int(rng.integers(8, L - 8))
            if rng.random() < 0.5:
                r = np.concatenate([r[:p], r[p + ilen:]])
                span = L + ilen
            else:
                ins = rng.integers(0, 4, ilen).astype(np.uint8)
                r = np.concatenate([r[:p], ins, r[p:]])
                span = L - ilen
        r = r[:L].copy()
        err = rng.random(L) < 0.001
        r[err] = rng.integers(0, 4, int(err.sum()))
        if rng.random() < 0.5:
            rr = r[::-1]
            r = np.where(rr < 4, 3 - rr, 4).astype(np.uint8)
        co, cn, _ln = contig_of(contigs, s)
        recs.append(SeqRecord(
            name=f"{cn}_{s - co + 1}_{s - co + span}_{len(recs)}",
            comment=None, seq=LUT[np.minimum(r, 4)].tobytes().decode("latin1"),
            qual="I" * L))
    return recs


def pe_pairs(hap, contigs, n_pairs, rng):
    """tools/bench_large.py's pairs: insert ~N(500, 50), proper
    orientation, no errors."""
    genome_len = len(hap)
    r1, r2, names = [], [], []
    while len(r1) < n_pairs:
        s = int(rng.integers(0, genome_len - 700))
        d = int(np.clip(rng.normal(500, 50), 2 * L + 10, 680))
        a = hap[s : s + L]
        bsrc = hap[s + d - L : s + d]
        if (a >= 4).any() or (bsrc >= 4).any():
            continue
        b = np.where(bsrc[::-1] < 4, 3 - bsrc[::-1], 4).astype(np.uint8)
        co, cn, _ln = contig_of(contigs, s)
        r1.append(LUT[a].tobytes().decode("latin1"))
        r2.append(LUT[b].tobytes().decode("latin1"))
        names.append(f"{cn}_{s - co + 1}_{s - co + d}_{len(names)}")
    mk = lambda rs: [SeqRecord(name=names[i], comment=None, seq=s,
                               qual="I" * L) for i, s in enumerate(rs)]
    return mk(r1), mk(r2)


def truth_of(name: str, offs) -> tuple:
    """(global left, global right) of a truth name (1-based span)."""
    cn, left, right = name.split("_")[:3]
    return offs[cn] + int(left) - 1, offs[cn] + int(right) - 1


def inside(name: str, contigs_by_name) -> bool:
    """The read's span lies EDGE bases inside its contig."""
    cn, left, right = name.split("_")[:3]
    return (int(left) - 1 >= EDGE
            and int(right) <= contigs_by_name[cn].length - EDGE)


def sam_body(lines):
    """SAM records without header lines, blank lines or line ends (a PE
    record ends in a newline of its own)."""
    return [l.rstrip("\n") for l in lines
            if l.strip() and not l.startswith("@")]


def accuracy(sam, offs, log, tag):
    """Primaries within 5 bp of the truth (forward left end), and those
    at a global position >= 2^31."""
    ok = tot = past = past_ok = drawn_past = 0
    for line in sam:
        f = line.split("\t")
        left = truth_of(f[0], offs)[0]
        drawn_past += left >= TWO31
        if f[2] == "*":
            continue
        tot += 1
        g = offs[f[2]] + int(f[3]) - 1
        good = abs(g - left) <= 5
        ok += good
        if g >= TWO31:
            past += 1
            past_ok += good
    log(f"{tag} accuracy: {ok}/{tot} primaries within 5bp of truth "
        f"({100.0 * ok / max(tot, 1):.2f}%), {len(sam) - tot} unmapped")
    log(f"{tag} past 2^31: {past} primaries at a global position >= 2^31, "
        f"{past_ok} of them within 5bp of truth ({drawn_past} records drawn "
        "there)")


class Launches:
    """K1 and K2 launch counts and the batch each call was sent, from a
    wrapper of the two call sites while the object is entered (the counts
    are the kernels' own)."""

    def __enter__(self):
        self.lv_sent, self.sw_sent = [], []
        self.saved = lv, sw = se_mod.lv_distance_batch, engine_mod.sw_score

        def lv_noting(words, pos, active, seq, k, **kw):
            self.lv_sent.append(int(pos.shape[0]))
            return lv(words, pos, active, seq, k, **kw)

        def sw_noting(refs, reads, lens, *a, **kw):
            self.sw_sent.append(int(refs.shape[0]))
            return sw(refs, reads, lens, *a, **kw)

        se_mod.lv_distance_batch = lv_noting
        engine_mod.sw_score = sw_noting
        return self

    def __exit__(self, *exc):
        se_mod.lv_distance_batch, engine_mod.sw_score = self.saved

    def reset(self):
        del self.lv_sent[:], self.sw_sent[:]
        LV.launches = SW.launches = 0

    def report(self, log, tag):
        log(f"{tag} kernel launches: K1 {LV.launches} (candidates a call "
            f"{min(self.lv_sent, default=0)}-{max(self.lv_sent, default=0)}, "
            f"{sum(self.lv_sent)} in all), K2 {SW.launches} (pairs a call "
            f"{self.sw_sent})")


def synchronize(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def index_bytes(al) -> int:
    """Bytes of the aligner's index tables on its device(s)."""
    al = getattr(al, "_se", al)      # a PE aligner's SE stage holds them
    if isinstance(al, ShardedSEAligner):
        return sum(d.table_bytes() for d in al.stacked.shards)
    return al.dix.table_bytes() + (al.sampled.table_bytes()
                                   if al.sampled is not None else 0)


def make_aligner(kind, idx, shards, opts, dev):
    """SE or PE aligner over the monolithic index or the shards on `dev`."""
    if shards is None:
        cls = SEAligner if kind == "se" else PEAligner
        return cls(idx, opts, device=dev)
    shard_ixs, bins = shards
    cls = ShardedSEAligner if kind == "se" else ShardedPEAligner
    return cls(idx, shard_ixs, opts, devices=[dev], bins=bins,
               contig_lengths=[c.length for c in idx.contigs])


def aligner_opts(kind, mode, batch):
    """tools/bench_large.py's options (:196-197 SE, :272-275 PE)."""
    if kind == "se":
        return SEOptions(l_overlap=1, max_locate=500, batch_size=batch,
                         gap_batch=128, sa_mode=mode)
    return PEOptions(l_overlap=1, max_locate=500, print_nm_md=True,
                     print_xa_cigar=True, batch_size=batch, gap_batch=128,
                     sa_mode=mode, min_tlen=350, max_tlen=650)


def run(kind, mode, idx, shards, reads, batch, dev, launches, log):
    """One aligner on `dev`: load, warm-up batch, the timed rest.  Returns
    (timed SAM records, aligner)."""
    tag = f"{kind.upper()} {mode}" + (f" S={len(shards[0])}" if shards else "")
    opts = aligner_opts(kind, mode, batch)
    if kind == "se":
        warm, timed = reads[:batch], reads[batch:]
        go = lambda al, rs: al.align_records(rs)
        n_warm, n, unit = len(warm), len(timed), "reads"
    else:
        r1, r2 = reads
        h = batch // 2
        warm, timed = (r1[:h], r2[:h]), (r1[h:], r2[h:])
        go = lambda al, rs: al.align_pairs(*rs)
        n_warm, n, unit = h, len(r1) - h, "pairs"
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    al = make_aligner(kind, idx, shards, opts, dev)
    synchronize(dev)
    log(f"{tag}: device index loaded in {time.time() - t0:.1f}s "
        f"(sa_mode={mode}); index on {dev}: {index_bytes(al)} bytes")
    t0 = time.time()
    go(al, warm)
    synchronize(dev)
    log(f"{tag} warmup {time.time() - t0:.1f}s ({n_warm} {unit})")
    metrics_reset()
    launches.reset()
    t0 = time.time()
    out = go(al, timed)
    synchronize(dev)
    dt = time.time() - t0
    log(f"{tag}: aligned {n} {unit} in {dt:.2f}s -> {n / dt:.0f} {unit}/s")
    if dev.type == "cuda":
        log(f"{tag} peak device memory {torch.cuda.max_memory_allocated()} "
            "bytes")
    launches.report(log, tag)
    log(f"{tag} stages:\n" + metrics_report(out=io.StringIO()))
    return sam_body(out), al


def held_equal(tag, want, got, names_ok, log) -> int:
    """Count the records of reads `names_ok` accepts that differ."""
    if len(want) != len(got):
        raise ValueError(f"{tag}: {len(want)} records against {len(got)}")
    sel = [i for i, l in enumerate(want) if names_ok(l.split("\t", 1)[0])]
    diff = sum(want[i] != got[i] for i in sel)
    log(f"{tag}: {diff} of {len(sel)} records differ")
    return diff


def card_line(dev) -> str:
    if dev.type != "cuda":
        return "card: none (cpu)"
    return "card: " + subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def main(argv=None) -> int:
    args = parse_args(argv)
    dev = checked_device(args.device)
    log = Log()
    log(card_line(dev) + f"; torch {torch.__version__}")
    batch = int(os.environ.get("SALT_TPU_BENCH_BATCH", "4096"))
    rng = np.random.default_rng(7)
    if args.load:
        idx, shards, codes, gpos, alt = load(args, log)
    else:
        shards = None
        idx, codes, gpos, alt = build(args, rng, log)
        if args.build_only:
            return 0
    # the haplotype (in load mode codes is the index's pac: copy it)
    hap = codes.copy() if args.load else codes
    hap[gpos] = alt
    del gpos, alt, codes
    reads = se_reads(hap, idx.contigs, batch * 3, args.read_indels, rng)
    pairs = pe_pairs(hap, idx.contigs, batch * 2 + batch // 2, rng) \
        if args.pe else None
    del hap
    gc.collect()
    with Launches() as launches:
        n_diff = check_runs(args, idx, shards, reads, pairs, batch, dev,
                            launches, log)
    log(f"done; {n_diff} records differ in the checks")
    return 0


def check_runs(args, idx, shards, reads, pairs, batch, dev, launches,
               log) -> int:
    """Every kind (SE, PE) in every mode, with the checks asked for;
    returns the count of records that differ."""
    offs = {c.name: c.offset for c in idx.contigs}
    by_name = {c.name: c for c in idx.contigs}
    n_diff = 0
    kinds = [("se", reads)] + ([("pe", pairs)] if args.pe else [])
    for kind, rs in kinds:
        first = None
        for mode in args.modes:
            sam, al = run(kind, mode, idx, shards, rs, batch, dev, launches,
                          log)
            tag = f"{kind.upper()} {mode}"
            if kind == "se":
                accuracy(sam, offs, log, tag)
            ev = alneval(line + "\n" for line in sam)
            log(f"{tag} per-MAPQ (alneval, 20bp):\n" + ev.report())
            if first is None:
                first = sam
            else:
                n_diff += held_equal(f"{tag} against {args.modes[0]} mode",
                                     first, sam, lambda _n: True, log)
            if args.cpu_check and dev.type == "cuda":
                n_diff += cpu_check(kind, mode, idx, shards, rs, sam, batch,
                                    args.cpu_check, log)
            del al
            gc.collect()
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        if args.sam_out:
            with open(f"{args.sam_out}.{kind}.sam", "w") as fh:
                fh.write("".join(l + "\n" for l in first))
        if args.compare:
            with open(f"{args.compare}.{kind}.sam") as fh:
                other = fh.read().splitlines()
            n_diff += held_equal(
                f"{kind.upper()} against {args.compare} (reads {EDGE} bases "
                "inside their contig)", other, first,
                lambda name: inside(name, by_name), log)
    return n_diff


def cpu_check(kind, mode, idx, shards, reads, sam, batch, n, log) -> int:
    """Align the first n timed reads (n/2 pairs) again on the CPU; count
    the records that differ from the card's."""
    if kind == "se":
        sub = reads[batch : batch + n]
    else:
        h = batch // 2
        sub = (reads[0][h : h + n // 2], reads[1][h : h + n // 2])
    t0 = time.time()
    al = make_aligner(kind, idx, shards, aligner_opts(kind, mode, batch),
                      torch.device("cpu"))
    out = sam_body(al.align_records(sub) if kind == "se"
                   else al.align_pairs(*sub))
    log(f"{kind.upper()} {mode} on the CPU: {len(out)} records in "
        f"{time.time() - t0:.1f}s")
    return held_equal(f"{kind.upper()} {mode} card against CPU", out,
                      sam[: len(out)], lambda _n: True, log)


if __name__ == "__main__":
    sys.exit(main())
