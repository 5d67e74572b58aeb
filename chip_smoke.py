"""Smoke run of salt_tpu_torch on one CUDA GPU.

    python3 chip_smoke.py

1. Prints the card (nvidia-smi name and power limit), the torch and CUDA
   versions, and builds the LV kernel (csrc/lv.cu) from source.
2. Kernel phase: the CUDA LV kernel against its plain PyTorch version on
   the card, exact equality, over k in {0, 3, 10, 30}, L in {70, 100,
   151, 250}, ragged N, inactive lanes, SNP nibbles, planted
   substitutions and indels, and positions >= 2^31 in a reference of
   more than 2^28 words.  Times both at the aligner's shapes.
3. Slice phase: a chr21-scale SNP-aware index (45M bases, 1 SNP per
   300 bp) built in process, 4 x 8,192 simulated 100 bp reads (0.1%
   substitutions, ~10% with a 1-3 bp indel) aligned by SEAligner on the
   card: one warm-up batch and three timed ones.  Checks the kernel ran,
   the mapped and correct shares, and that the first 1,024 reads give
   byte-identical SAM on the CPU.

Every phase raises on failure.  The last two lines of stdout are the
kernels' JSON record and {"ok": true, "device": {...}}.  Exits non-zero,
printing no result, when no CUDA device is available.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

from salt_tpu.index.build import build_index_from_data
from salt_tpu.io.fasta import SeqRecord
from salt_tpu.io.snp import SnpBlock
from salt_tpu.utils.metrics import metrics, metrics_reset
from salt_tpu_torch.ops.lv import lv_distance_plain
from salt_tpu_torch.ops.lv_cuda import LV, SOURCE, lv_distance_cuda
from salt_tpu_torch.ops.uint import U32, take_u32
from salt_tpu_torch.pipeline.device_index import pack_nibbles
from salt_tpu_torch.pipeline.engine import SEAligner, SEOptions

GENOME_LEN = 45_000_000
SNP_EVERY = 300
READ_LEN = 100
BATCH = 8192
N_TIMED = 3
CPU_CHECK = 1024
SEED = 11


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


# ---------------------------------------------------------------- inputs


def one_hot_reference(rng, n: int) -> np.ndarray:
    """n one-hot nibbles with ~5% SNP nibbles (two bits set)."""
    mix = (1 << rng.integers(0, 4, n)).astype(np.uint8)
    snp = rng.random(n) < 0.05
    mix[snp] |= (1 << rng.integers(0, 4, int(snp.sum()))).astype(np.uint8)
    return mix


def window_nibbles(words: torch.Tensor, pos: torch.Tensor, n: int) -> np.ndarray:
    """The n reference nibbles at each position (uint32 positions, word
    index clamped), on the host."""
    t = ((pos & U32)[:, None] + torch.arange(n, device=pos.device)) & U32
    return ((take_u32(words, t >> 3) >> ((t & 7) * 4)) & 15).cpu().numpy()


def planted_reads(rng, text: np.ndarray, L: int, max_edits: int) -> np.ndarray:
    """Reads drawn from each candidate's text window (lowest set bit of
    each nibble), half with up to max_edits substitutions and indels,
    the other half random."""
    N = text.shape[0]
    bases = np.log2(np.maximum(text & -text, 1)).astype(np.int64)
    seq = rng.integers(0, 4, (N, L))
    for i in range(0, N, 2):
        r = list(bases[i, :L])
        for _ in range(int(rng.integers(0, max_edits + 1))):
            j = int(rng.integers(0, len(r) - 1))
            op = rng.integers(0, 3)
            if op == 0:
                r[j] = (r[j] + 1) % 4
            elif op == 1:
                del r[j]
            else:
                r.insert(j, int(rng.integers(0, 4)))
        seq[i] = (r + list(bases[i, len(r):]))[:L]
    seq[rng.random((N, L)) < 0.002] = 4
    return seq.astype(np.uint8)


# ---------------------------------------------------------------- phase 2


def check_kernel_case(words, pos, k, L, rng, dev, window_pad=4):
    N = pos.shape[0]
    text = window_nibbles(words, pos, L + 8)
    seq = torch.from_numpy(planted_reads(rng, text, L, min(k, 4))).to(dev)
    active = torch.from_numpy(rng.random(N) < 0.9).to(dev)
    got = lv_distance_cuda(words, pos, active, seq, k, window_pad)
    want = lv_distance_plain(words, pos, active, seq, k, window_pad,
                             text_words=True)
    torch.cuda.synchronize()
    err = int((got.long() - want).abs().max()) if N else 0
    if err:
        bad = torch.nonzero(got.long() != want)[:5, 0].tolist()
        raise AssertionError(
            f"LV kernel != plain at k={k} L={L}: lanes {bad}, kernel "
            f"{got[bad].tolist()}, plain {want[bad].tolist()}")
    return err, int(((want > 0) & (want < 255)).sum())


def kernel_phase(dev):
    """K1 against its plain version on the card.  Returns (max_abs_err,
    timings)."""
    rng = np.random.default_rng(SEED)
    n_ref = 2_000_000
    words = torch.from_numpy(pack_nibbles(one_hot_reference(rng, n_ref))
                             .view(np.int32)).to(dev)
    max_err = 0
    for k in (0, 3, 10, 30):
        for L in (70, 100, 151, 250):
            N = 1000 + 37 * k + L          # not a multiple of the block size
            pos = rng.integers(0, n_ref - L - 80, N)
            pos[-2:] = [n_ref - 10, 2**32 - 7]   # clamped / wrapping windows
            pos = torch.from_numpy(pos.astype(np.int64)).to(dev)
            err, n_mid = check_kernel_case(words, pos, k, L, rng, dev)
            max_err = max(max_err, err)
            print(f"[kernel] k={k:2d} L={L:3d} N={N}: equal "
                  f"({n_mid} lanes with 0 < e < 255)", flush=True)

    # positions >= 2^31: a reference of more than 2^28 words (~1 GiB)
    n_words = 2**28 + 2**20
    big = torch.randint(-2**31, 2**31 - 1, (n_words,), dtype=torch.int32,
                        device=dev)
    hi = n_words * 8
    pos = rng.integers(2**31, hi - 400, 4096)
    pos[:3] = [2**31 - 50, hi - 20, 2**32 - 3]
    pos = torch.from_numpy(pos.astype(np.int64)).to(dev)
    for k, L in ((10, 100), (30, 151)):
        err, n_mid = check_kernel_case(big, pos, k, L, rng, dev)
        max_err = max(max_err, err)
        print(f"[kernel] positions >= 2^31, {n_words} words, k={k} L={L}: "
              f"equal ({n_mid} lanes with 0 < e < 255)", flush=True)
    del big
    torch.cuda.empty_cache()
    return max_err, {N: time_kernel(words, N, rng, dev) for N in (8192, 16384)}


def time_kernel(words, N, rng, dev, k=10, L=READ_LEN):
    """Mean ms per call of the kernel and of the plain version at (N, L,
    k), run in turns plain, kernel, kernel, plain."""
    n_ref = words.shape[0] * 8
    pos = torch.from_numpy(rng.integers(0, n_ref - 200, N).astype(np.int64)).to(dev)
    seq = torch.from_numpy(planted_reads(rng, window_nibbles(words, pos, L + 8),
                                         L, 4)).to(dev)
    active = torch.ones(N, dtype=torch.bool, device=dev)

    def timed(fn, reps):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / reps

    def kern():
        return lv_distance_cuda(words, pos, active, seq, k, 4)

    def plain():
        return lv_distance_plain(words, pos, active, seq, k, 4, text_words=True)

    p1, k1, k2, p2 = timed(plain, 5), timed(kern, 50), timed(kern, 50), timed(plain, 5)
    return {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
            "turns_ms": [p1, k1, k2, p2],
            "device_ms": device_ms(kern, 50), "plain_device_ms": device_ms(plain, 5)}


def device_ms(fn, reps):
    """Device time per call summed over every kernel fn runs, from a
    torch.profiler trace (None when the trace holds no device time)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages())
    return us / 1e3 / reps if us else None


# ---------------------------------------------------------------- phase 3


def make_index(genome_len, snp_every, rng):
    lut = np.frombuffer(b"ACGT", dtype=np.uint8)
    codes = rng.integers(0, 4, genome_len, dtype=np.int64).astype(np.uint8)
    n_snp = genome_len // snp_every
    pos = np.sort(rng.choice(genome_len, n_snp, replace=False).astype(np.int64))
    alt = ((codes[pos] + rng.integers(1, 4, n_snp)) % 4).astype(np.uint8)
    stype = ((1 << codes[pos]) | (1 << alt) | (codes[pos] << 4)).astype(np.uint8)
    idx = build_index_from_data([("chr1", "synt", lut[codes])],
                                [SnpBlock("chr1", pos.astype(np.uint32), stype)],
                                l_seed=19)
    hap = codes.copy()
    hap[pos] = alt
    return idx, hap


def simulate_reads(hap, n, L, rng, sub_rate=0.001, indel_frac=0.1):
    """SE reads from the SNP haplotype: substitutions at sub_rate, and a
    1-3 bp insertion or deletion in indel_frac of the reads.  Returns
    (records, true leftmost positions)."""
    starts = rng.integers(0, len(hap) - L - 8, n)
    j = np.arange(L)[None, :]
    src = starts[:, None] + j
    has = rng.random(n) < indel_frac
    m = rng.integers(1, 4, n)[:, None]
    at = rng.integers(10, L - 10, n)[:, None]
    is_del = rng.random(n)[:, None] < 0.5
    src = np.where(has[:, None] & is_del & (j >= at), src + m, src)
    ins = has[:, None] & ~is_del & (j >= at)
    src = np.where(ins, src - m, src)
    win = hap[src]
    win = np.where(ins & (j < at + m), rng.integers(0, 4, (n, L)), win)
    win = np.where(rng.random((n, L)) < sub_rate, (win + 1) & 3, win)
    flip = rng.random(n) < 0.5                   # half from the reverse strand
    win[flip] = 3 - win[flip, ::-1]
    lut = np.frombuffer(b"ACGT", dtype=np.uint8)
    seqs = lut[win.astype(np.uint8)]
    recs = [SeqRecord(f"r{i}_{starts[i]}", None,
                      seqs[i].tobytes().decode("latin1"), "I" * L)
            for i in range(n)]
    return recs, starts


def accuracy(sam, truth):
    mapped = ok = 0
    for line, t in zip(sam, truth):
        f = line.split("\t")
        if f[2] == "*":
            continue
        mapped += 1
        ok += abs(int(f[3]) - 1 - int(t)) <= 5
    return mapped / len(sam), ok / max(mapped, 1)


def slice_phase(dev) -> int:
    """Aligns the chr21-scale cell; returns the LV kernel launches of the
    timed run."""
    rng = np.random.default_rng(SEED)
    batch = BATCH
    t0 = time.perf_counter()
    idx, hap = make_index(GENOME_LEN, SNP_EVERY, rng)
    print(f"[slice] index: {GENOME_LEN} bases, {GENOME_LEN // SNP_EVERY} SNPs, "
          f"host build {time.perf_counter() - t0:.1f} s", flush=True)
    recs, truth = simulate_reads(hap, batch * (1 + N_TIMED), READ_LEN, rng)

    opts = SEOptions(l_overlap=1, max_locate=500, print_nm_md=True,
                     print_xa_cigar=True, batch_size=batch, gap_batch=128)
    t0 = time.perf_counter()
    al = SEAligner(idx, opts, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    print(f"[slice] index to {dev}: {time.perf_counter() - t0:.2f} s", flush=True)
    t0 = time.perf_counter()
    warm = al.align_records(recs[:batch])
    print(f"[slice] warm-up batch: {time.perf_counter() - t0:.2f} s", flush=True)

    metrics_reset()
    LV.launches = 0
    t0 = time.perf_counter()
    out = al.align_records(recs[batch:])
    if dev.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = LV.launches
    stages = metrics()
    n = len(out)
    print(f"[slice] {n} reads in {dt:.3f} s = {n / dt:.1f} reads/s", flush=True)
    for name, (tot, cnt) in sorted(stages.items(), key=lambda kv: -kv[1][0]):
        print(f"[slice]   {name:<22} {tot:9.3f} s  {cnt:5d} calls", flush=True)
    print(f"[slice] LV kernel launches in the timed run: {launches}", flush=True)
    if dev.type == "cuda" and launches == 0:
        raise AssertionError("the timed run never launched the LV kernel")
    mapped, correct = accuracy(out, truth[batch:])
    n_gap = sum(1 for line in out if "I" in line.split("\t")[5]
                or "D" in line.split("\t")[5])
    print(f"[slice] mapped {mapped:.4%}, within 5 bp of truth {correct:.4%} "
          f"of mapped, {n_gap} gapped cigars", flush=True)
    if mapped < 0.9 or correct < 0.9 or n_gap == 0:
        raise AssertionError("alignment accuracy out of bounds")
    if dev.type == "cuda":
        busy_share(al, recs[batch : 2 * batch])

    t0 = time.perf_counter()
    cpu = SEAligner(idx, opts, device="cpu").align_records(recs[:CPU_CHECK])
    diff = [i for i, (a, b) in enumerate(zip(cpu, warm[:CPU_CHECK])) if a != b]
    print(f"[slice] CPU rerun of {CPU_CHECK} reads: {len(diff)} SAM records "
          f"differ ({time.perf_counter() - t0:.1f} s)", flush=True)
    if diff:
        raise AssertionError(f"CPU and {dev} SAM differ, first at read "
                             f"{diff[0]}:\n{cpu[diff[0]]}\n{warm[diff[0]]}")
    return launches


def busy_share(al, recs):
    """Device busy share of one more batch: device time of every kernel
    and copy in a torch.profiler trace over the host-clock wall time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        al.align_records(recs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = sorted(prof.key_averages(), key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in events) / 1e6
    print(f"[slice] profiled batch of {len(recs)} reads: wall {wall:.3f} s, "
          f"device busy {busy:.4f} s = {busy / wall:.2%}", flush=True)
    for e in events[:8]:
        print(f"[slice]   {e.self_device_time_total / 1e3:9.3f} ms  "
              f"{e.count:6d}x  {e.key[:70]}", flush=True)


# ---------------------------------------------------------------- main


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    print(card_line(), flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    t0 = time.perf_counter()
    LV.build()
    print(f"[build] {SOURCE.name}: {time.perf_counter() - t0:.2f} s", flush=True)
    for line in LV.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build] {line.strip()}", flush=True)

    max_err, times = kernel_phase(dev)
    for N, t in times.items():
        print(f"[kernel] N={N} L={READ_LEN} k=10 per call, host clock: "
              f"kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms (turns "
              f"plain, kernel, kernel, plain: {t['turns_ms']}); device time "
              f"(profiler): kernel {t['device_ms']} ms, plain "
              f"{t['plain_device_ms']} ms", flush=True)

    launches = slice_phase(dev)
    t = times[8192]
    print(json.dumps({"kernels": [{
        "name": "lv_distance", "route": "cuda",
        "source": "salt_tpu_torch/csrc/lv.cu",
        "replaces": "salt_tpu/ops/lv_pallas.py:31",
        "launches": launches, "max_abs_err": max_err,
        "ms": t["ms"], "plain_ms": t["plain_ms"]}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
