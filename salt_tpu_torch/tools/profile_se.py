"""Stage profile of salt_tpu_torch's SE chain: the port of
tools/profile_se.py, tools/profile_parts.py and the stage rows of
tools/profile_all.py.

    python -m salt_tpu_torch.tools.profile_se [B] [--device D]
        [--genome-synth BASES] [--genome-config uniform|repeat]
        [--n-pairs N] [--workdir W]

The fixture is run_accuracy's error-free protocol (its simulate and build
steps, --sim internal; default a 45,000,000-base uniform genome and
20,000 pairs, files reused from the workdir), where the originals read
/tmp/oracle.  B (default 512) is the batch: the parts run on the first B
reads once (the first call: CUDA module load, kernel builds) and on the
next B reads three times (steady: the least host time, each call ending
in a device synchronize).  Every part is what the aligner's
device.dispatch stage runs (both strands in one 2B-row batch, the 12-mer
tables of both families, the aligner's options), cut after a step:

  seed                 ops/seed.seed_overlap
  seed+locate          + ops/locate.locate, sort_loci
  seed+locate+verify   + ops/verify.checked_mask, compact_loci,
                       mismatch_counts_packed
  ungapped             pipeline/se.se_ungapped + pack_result (the whole
                       of device.dispatch but the reads' host-to-device
                       copy)
  gapped               pipeline/se.se_gapped on 64 rows (K1), over the
                       batch's ungapped loci made beforehand
  ungapped (sampled)   se_ungapped over the sampled SA tables

and a torch.profiler trace of each gives, on a card, the device busy
milliseconds, the kernels run and the device-to-host copies, and the
host's kernel launches, copies and stream synchronizations (a blocking
read-back each: one a greedy seed round, one a call of locate's column
blocks, which run in sampled mode).
Last, the top functions under SEAligner._finalize_batch by cumulative
time, from cProfile around one align_records batch, beside the stage
timers of that batch.
"""

from __future__ import annotations

import argparse
import cProfile
import dataclasses
import pstats
import sys
import time

import torch
from torch.autograd import DeviceType

from ..constants import NOGAP_MAX_DIFF
from ..io.fasta import read_records
from ..ops.locate import locate, sort_loci
from ..ops.seed import seed_overlap
from ..ops.verify import checked_mask, compact_loci, mismatch_counts_packed
from ..pipeline.engine import (
    SEAligner,
    SEOptions,
    checked_device,
    encode_reads,
    loci_rows,
    revcomp,
)
from ..pipeline.se import pack_result, se_gapped, se_ungapped
from ..utils.metrics import metrics, metrics_reset
from . import run_accuracy
from .bench_configs import card_line

GAPPED_ROWS = 64
STEADY_REPS = 3
TOP_FUNCTIONS = 12
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx")
COPY_CALLS = ("cudaMemcpyAsync", "cudaMemcpy")
SYNC_CALLS = ("cudaStreamSynchronize", "cudaEventSynchronize")
TRACE_TRIES = 2
# In a long process the profiler loses the first device events of each
# session (none in a fresh process; 8 after the kernel phases of
# chip_smoke.py, 22 and more after its accuracy phase), which left the
# seed part, three kernels, with none.  Each session therefore opens with
# PRIME_KERNELS kernels of torch.cuda._sleep(0), left out of the counts,
# which take those losses.
PRIME_KERNELS = 256
PRIME_NAME = "spin_kernel"


def synchronize(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def trace_counts(fn, dev) -> dict:
    """torch.profiler counts of fn(): from the device's events, the busy
    ms, the kernels run and the device-to-host copies; from the host's
    CUDA API calls, the kernel launches, the copies either way and the
    stream synchronizations (one a blocking read-back).  The fuller of
    TRACE_TRIES traces (the profiler can drop device events in a long
    process), each opened by PRIME_KERNELS kernels that are not counted.
    None on the CPU, where there is no device to trace."""
    if dev.type != "cuda":
        return None
    from torch.profiler import ProfilerActivity, profile

    best = None
    for _ in range(TRACE_TRIES):
        synchronize(dev)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with torch.cuda.device(dev):
                for _ in range(PRIME_KERNELS):
                    torch.cuda._sleep(0)
            synchronize(dev)
            fn()
            synchronize(dev)
        got = dict.fromkeys(("busy_ms", "kernels", "d2h", "launches",
                             "copies", "syncs"), 0)
        got["launches"] = -PRIME_KERNELS
        for e in prof.key_averages():
            if PRIME_NAME in e.key:
                continue
            if e.device_type == DeviceType.CUDA:
                got["busy_ms"] += e.self_device_time_total / 1e3
                if "DtoH" in e.key:
                    got["d2h"] += e.count
                elif not e.key.startswith(("Memcpy", "Memset")):
                    got["kernels"] += e.count
            elif e.key in LAUNCH_CALLS:
                got["launches"] += e.count
            elif e.key in COPY_CALLS:
                got["copies"] += e.count
            elif e.key in SYNC_CALLS:
                got["syncs"] += e.count
        if best is None or got["busy_ms"] > best["busy_ms"]:
            best = got
    return best


def run_part(name, fn, first, steady, dev, out=print) -> dict:
    """The first call's seconds on `first`, the least steady host ms of
    STEADY_REPS calls on `steady`, and the trace counts of one more."""
    synchronize(dev)
    t0 = time.perf_counter()
    fn(*first)
    synchronize(dev)
    t_first = time.perf_counter() - t0
    best = float("inf")
    for _ in range(STEADY_REPS):
        t0 = time.perf_counter()
        fn(*steady)
        synchronize(dev)
        best = min(best, time.perf_counter() - t0)
    row = {"part": name, "first_s": t_first, "steady_ms": best * 1e3,
           "trace": trace_counts(lambda: fn(*steady), dev)}
    tr = row["trace"]
    counts = ("device busy not measured (no card)" if tr is None else
              f"device busy {tr['busy_ms']:.3f} ms, kernels {tr['kernels']}, "
              f"D2H copies {tr['d2h']}; API: launches {tr['launches']}, "
              f"copies {tr['copies']}, stream syncs {tr['syncs']}")
    out(f"[profile] {name:<20} first call {t_first:7.2f} s, steady "
        f"{best * 1e3:9.2f} ms, {counts}")
    return row


def parts(al: SEAligner, sampled_al: SEAligner) -> list:
    """(name, fn(f, r)) of every part, over the aligner's device index and
    options; the gapped part runs on the first GAPPED_ROWS rows of the
    batch's ungapped loci."""
    dix, o = al.dix, al.opts
    cap = o.full_cap()

    def seed(f, r):
        seq2 = torch.cat([f, r], 0).long()
        return seq2, seed_overlap(
            dix.ri_c, dix.ri_r, dix.lkt, seq2, dix.l_seed, o.l_overlap,
            o.max_seed, r_lkt_sp=dix.r_lkt_sp, r_lkt_ep=dix.r_lkt_ep)

    def seed_locate(f, r):
        seq2, (c, rs) = seed(f, r)
        lo = locate(c, rs, dix.sa_cat, dix.c_sa_len, f.shape[1], dix.l_pac,
                    o.max_locate, cap, chunk=o.locate_chunk)
        return seq2, sort_loci(lo.loci), lo.overflow

    def seed_locate_verify(f, r):
        seq2, lc, _ovf = seed_locate(f, r)
        pos, keep, _ = compact_loci(lc, checked_mask(lc, dix.l_pac),
                                    o.verify_width)
        return mismatch_counts_packed(dix.mixref_words, pos, keep, seq2,
                                      NOGAP_MAX_DIFF + 1)

    def ungapped_on(a):
        def ungapped(f, r):
            out = se_ungapped(
                a.dix, f, r, l_overlap=o.l_overlap, max_seed=o.max_seed,
                max_locate=o.max_locate, cap=cap, u=o.verify_width,
                k_hits=o.k_hits, sampled=a.sampled, chunk=o.locate_chunk)
            return out, pack_result(out.res, (out.needs_gap, out.overflow))
        return ungapped

    ungapped = ungapped_on(al)

    located = {}    # the ungapped loci of each batch, made once

    def gapped(f, r):
        rows = torch.arange(GAPPED_ROWS, device=f.device)
        if f.data_ptr() not in located:
            located[f.data_ptr()] = ungapped(f, r)[0]
        out = located[f.data_ptr()]
        return se_gapped(dix, f[rows], r[rows], *loci_rows(out, rows),
                         k=f.shape[1] // 10, u=o.verify_width,
                         k_hits=o.k_hits)

    rows = [("seed", seed), ("seed+locate", seed_locate),
            ("seed+locate+verify", seed_locate_verify),
            ("ungapped", ungapped), ("gapped", gapped),
            ("ungapped (sampled)", ungapped_on(sampled_al))]
    return rows


def finalize_split(al: SEAligner, recs, top=TOP_FUNCTIONS, out=print):
    """cProfile of SEAligner._finalize_batch over one align_records call
    on `recs`; prints the stage timers of the call and the `top`
    functions under _finalize_batch by cumulative time.  Returns
    [(function, calls, cumulative s, own s)]."""
    prof = cProfile.Profile()
    finalize = al._finalize_batch

    def profiled(*a, **kw):
        prof.enable()
        try:
            return finalize(*a, **kw)
        finally:
            prof.disable()

    al._finalize_batch = profiled
    metrics_reset()
    try:
        t0 = time.perf_counter()
        al.align_records(recs)
        synchronize(al.device)
        wall = time.perf_counter() - t0
    finally:
        del al._finalize_batch
    stages = ", ".join(f"{k} {v[0]:.3f} s" for k, v in
                       sorted(metrics().items(), key=lambda kv: -kv[1][0]))
    out(f"[profile] one batch of {len(recs)} reads under cProfile: wall "
        f"{wall:.3f} s; {stages}")
    rows = []
    for (path, line, func), (_cc, nc, tt, ct, _callers) in \
            pstats.Stats(prof).stats.items():
        if func.startswith("<method 'disable'"):
            continue
        where = f"{path.rsplit('/', 1)[-1]}:{line}" if line else path
        rows.append((f"{where}({func})", nc, ct, tt))
    rows.sort(key=lambda r: -r[2])
    out(f"[profile] top {top} under _finalize_batch by cumulative time "
        "(calls, cumulative s, own s):")
    for name, nc, ct, tt in rows[:top]:
        out(f"[profile]   {ct:8.3f} {tt:8.3f} {nc:8d}  {name[:90]}")
    return rows[:top]


def profile(idx, recs, B: int, dev, out=print) -> dict:
    """Every part at batch B on `dev` over `idx`, then the finalize split.
    Needs 2B records.  Returns {"parts": rows, "finalize": rows}."""
    if len(recs) < 2 * B:
        raise ValueError(f"profile needs {2 * B} reads, got {len(recs)}")
    opts = SEOptions(l_overlap=1, max_locate=500, print_nm_md=True,
                     print_xa_cigar=True, batch_size=B)
    al = SEAligner(idx, opts, device=dev)
    sampled_al = SEAligner(idx, dataclasses.replace(opts, sa_mode="sampled"),
                           device=dev)
    codes = encode_reads([r.seq for r in recs[:2 * B]])

    def batch(s):
        c = codes[s : s + B]
        return (torch.from_numpy(c).to(dev),
                torch.from_numpy(revcomp(c)).to(dev))

    first, steady = batch(0), batch(B)
    rows = {}
    for name, fn in parts(al, sampled_al):
        rows[name] = run_part(name, fn, first, steady, dev, out)
    t = {k: r["steady_ms"] for k, r in rows.items()}
    out(f"[profile] ungapped-only equiv {B / t['ungapped'] * 1e3:9.0f} "
        "reads/s")
    out(f"[profile] (seed {t['seed']:.2f} ms + locate "
        f"{t['seed+locate'] - t['seed']:.2f} ms + verify "
        f"{t['seed+locate+verify'] - t['seed+locate']:.2f} ms of "
        f"{t['ungapped']:.2f} ms; replay/select and packing = rest)")
    out(f"[profile] sampled overhead "
        f"{t['ungapped (sampled)'] / t['ungapped']:9.2f}x")
    del sampled_al
    fin = finalize_split(al, recs[B : 2 * B], out=out)
    return {"parts": list(rows.values()), "finalize": fin}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="profile_se")
    ap.add_argument("B", nargs="?", type=int, default=512)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--genome-synth", type=int, default=45_000_000)
    ap.add_argument("--genome-config", choices=["uniform", "repeat"],
                    default="uniform")
    ap.add_argument("--n-pairs", type=int, default=20000)
    ap.add_argument("--workdir", default=run_accuracy.DEFAULT_WORKDIR)
    args = ap.parse_args(argv)
    dev = checked_device(args.device)
    if dev.type == "cuda":
        print(card_line() + f"; torch {torch.__version__}", flush=True)
    acc = run_accuracy.parse_args([
        str(args.n_pairs), "--genome-synth", str(args.genome_synth),
        "--genome-config", args.genome_config, "--sim", "internal",
        "--workdir", args.workdir])
    prod = run_accuracy.simulate(acc)
    idx = run_accuracy.build(acc, prod)
    recs = list(read_records(prod.r1))
    profile(idx, recs, args.B, dev, out=lambda s: print(s, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
