"""Smoke run of salt_tpu_torch on one CUDA GPU.

    python3 chip_smoke.py

1. Prints the card (nvidia-smi name and power limit), the torch and CUDA
   versions, and builds the four kernel sources (csrc/lv.cu with both
   forms of K1, csrc/sw.cu, csrc/seed.cu, csrc/sa_walk.cu) and the native
   host library, side by side.
2. K1 kernel phase: the CUDA LV kernel against its plain PyTorch version
   on the card, exact equality, over k in {0, 3, 7, 8, 10, 15, 16, 30}
   (every group size of the kernel and the boundaries between them), L in
   {70, 100, 151, 250} and one case at L = 2,047, ragged N, inactive
   lanes, SNP nibbles, planted substitutions and indels, and positions
   >= 2^31 in a reference of more than 2^28 words.  Times both at the
   aligner's shapes, and the kernel on reads that match exactly (its
   set-up and first run alone) and on inactive candidates (the launch
   alone).  K1's byte form (polish's: a byte reference, precoded match
   codes) against its plain version, exact equality, over k in {0, 3, 7,
   13, 15, 16, 30}, L in {70, 100, 151, 250} and N in {1, 7, 129, 4,096}:
   polish's seven codes, planted substitutions and indels up to and past
   k, inactive rows, windows at position 0, ending at the last byte, cut
   by the end and at positions >= 2^31; timed at N = 4,096 and 8,192,
   L = 100, k = 13, window_pad = 0.
3. K2 kernel phase: the CUDA Smith-Waterman score kernel against its
   plain PyTorch version on the card, exact equality, in SNP and plain
   mode over (L, W) in {(100, 105), (104, 512), (152, 512), (250, 768),
   (33, 40), (128, 140), (129, 140), (256, 300), (257, 300), (100, 5),
   (7, 3)} with ragged B, ref_len from 0 to W, multi-bit and 0/15
   reference nibbles, N and padding read codes, planted substitutions and
   indels and unrelated pairs, with the instantiation the shape chooses
   and with each one the shape allows forced (the wavefront with 16 lanes
   a pair, one thread a pair), one case at L = 2,047, and a sample of
   each case against the numpy oracle.  At the two shapes the aligner can
   give it at most (a whole batch, a whole chunk), times the plain
   version and the chosen instantiation against the one-thread-per-pair
   kernel in turns old, new, new, old; times the one-thread kernel at
   L = 2,047.  After the slice phases, the same turns at the batch sizes
   the paths really sent.
4. Device build: the index of the next phases and a 4,600,000-base index
   with no SNP, each in full and in sampled mode, loaded by
   to_device_index (planes, packed words and sampled tables built on the
   card) and by host_route_index (numpy on the host, then copied): every
   tensor bit-equal, both routes' seconds and peak device memory.  In
   phases 6 and 7 the SE reads also go through an aligner over the
   host route's index and the aligner over the card-built one, in turns,
   each mode.
5. K3 phase: the CUDA seeding kernel against seed_overlap_plain on the
   card, every output bit for bit, on the slice index (l_seed 19, 45M
   bases without repeats) and on a 4,000,000-base repeat-rich one
   (sim/genome_gen.py, l_seed 21, 1% N runs), 8,192 rows of both strands
   with N bases, each variant (R jump tables, R without them, seed_only_ref)
   at l_overlap 1 and 21 and max_seed 50 and 2.  Times K3 (CUDA-graph
   replay) and the plain version at 8,192 rows x 4 and x 80 seed starts.
   K3's launches are counted in every path's launch line.
6. Slice phases on one chr21-scale SNP-aware index (45M bases in 8
   contigs, 1 SNP per 300 bp) built in process, the 4 sub-indexes of the
   sharded aligner beside it: SE with Landau-Vishkin extension, SE with
   Smith-Waterman extension (-X 1), and paired-end with mate rescue.  Each
   runs one warm-up batch and timed ones with every launch count set to 0
   just before, checks that its kernels ran, the mapped and correct
   shares, and that a prefix of the reads gives byte-identical SAM on the
   CPU (and, for the SW paths, on the card with the pre-filter off).
7. Sampled suffix-array mode on the same index (sa_intv = 8): the LF-walk
   resolver on 2 x 65,536 random ranks against the host tables, with the
   fused and with standalone rank planes, and there the walk kernel K4
   against its plain version on every lane (every other one inactive);
   one sampled locate of a real batch (4,096 reads, both strands) through
   K4 and through the plain version, every block's values and the loci
   equal, and K4 timed (CUDA-graph replay) beside the plain version on
   its first block of 8,192 x 128 lanes; SE with Landau-Vishkin extension
   on the same reads, SAM byte-identical to full mode, K4 launched in the
   timed batches; one paired-end chunk likewise; the device bytes of the
   locate tables in both modes.
8. Polish on the card over the SE and the PE SAM of phase 6 (Landau-Vishkin
   scoring through K1's byte form), byte-identical to the same call on the
   CPU; SSW scoring (-s) on 512 records; then K1's byte form timed at the
   largest batch that path sent.

9. The index sharded by reference bin (4 shards, all resident on the one
   card): SE with Landau-Vishkin extension on the SE phase's reads (SAM
   byte-identical to the monolithic aligner's, K1 launched in every timed
   batch, the two aligners' rates in turns, device bytes of the four
   sub-indexes, the CPU's SAM on a prefix), one -X 1 batch and one PE
   chunk (SAM equal to the monolithic phases', K2 in both modes); every
   shape K1 and K2 were sent is held against the plain version; the
   ungapped sharded step (sharded_se_step) on its default devices, equal
   to the monolithic ungapped step.
10. The data-parallel step over make_mesh() and over the card named
   twice, equal to the unsplit step.
11. The command line on a 3,000,000-base genome in a temporary directory:
   idx --shards 4, aln, aln --shards 4, aln --part-dir as processes 0 and
   1 of 2 and --merge, all the same SAM; SALT_TPU_TRACE gives a Chrome
   trace that holds CUDA kernel events.

12. Accuracy, by tools/run_accuracy.py's steps (the reference's
   run_test.sh protocol: wgsim read pairs, the simulated substitutions
   fed back as known SNPs, alneval against the truth in the read names).
   Both protocols' simulation and index build start in processes of their
   own at the beginning of the run (about 4 minutes of host work each),
   beside phases 1-11.  Protocol A: a 45,000,000-base uniform genome,
   20,000 error-free pairs, SE and PE on the card with the gate max_err =
   0 (any wrong read fails), and SE again in sampled mode with SAM equal
   to full mode's.  Protocol B, README's config 3b: a 45,000,000-base
   repeat-rich genome, 5,000 pairs with 1% errors and 10% indels, SE and
   PE, report-only; K1 must launch, K2's launches in PE rescue are
   printed, and the first 512 reads and 512 pairs give the same SAM on
   the CPU.
13. The stage profile (tools/profile_se.py) at 8,192 reads over protocol
   A's index: seed, seed+locate, seed+locate+verify, the ungapped step,
   the gapped step on 64 rows and the sampled ungapped step, each with
   its first call, steady host time and a torch.profiler trace (device
   busy time, kernels, launches, copies, synchronizations), then the
   functions under the host finalize by cumulative time.

14. tools/bench.py (salt_tpu's bench.py) at its own sizes: SE (24,576
   reads, a 5% SNP overlay) and PE (3 x 8,192 pairs) on a 96,000-base
   stand-in for the bundled test genome in 4 contigs, and the scale run
   on a 45,000,000-base repeat-rich genome whose index is built in a
   process of its own from the beginning of the run, beside phases 1-13.
   Each run's rate, stage seconds and launches; bench's JSON line printed
   with the prefix "[bench] "; the busy share of one scale batch; the
   first 512 reads (pairs) of each run give the same SAM on the CPU.

15. Past 2^31: a synthetic BWT of 2^31 + 2^26 symbols, 98.5% code 0, so
   that code 0's exclusive count passes 2^31 (and the C-array of every
   later code), its planes built on the card by ops/rank.py:rank_index_on
   and on the host by build_rank_index (peak of its numpy arrays
   measured), bit-equal, both timed; rank_excl and
   lf_step at 2^16 ranks a symbol drawn from [2^31 - 2^20, n + 1] and at
   2^31 - 1, 2^31, 2^31 + 1, n and n + 1, given as wrapped int32 as the
   seed carries them, against counts made independently (count_nonzero
   over 2^24-symbol blocks, a prefix sum over the window) mod 2^32, and
   against the same queries on the CPU tensors.

Every phase raises on failure.  The last two lines of stdout are the
kernels' JSON record and {"ok": true, "device": {...}}.  Exits non-zero,
printing no result, when no CUDA device is available.
"""

import atexit
import contextlib
import dataclasses
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import tracemalloc
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from salt_tpu_torch import cli
from salt_tpu_torch.constants import GAP_WINDOW_PAD, NOGAP_MAX_DIFF
from salt_tpu_torch.index.build import build_index_from_data
from salt_tpu_torch.index.store import load_index, save_index
from salt_tpu_torch.io.fasta import SeqRecord, read_records
from salt_tpu_torch.io.snp import SnpBlock
from salt_tpu_torch.ops import locate as locate_mod
from salt_tpu_torch.ops.locate import locate, resolve_sampled_plain
from salt_tpu_torch.ops.lv import lv_distance_plain, window_nibbles
from salt_tpu_torch.ops.lv_cuda import (
    LV,
    LV_BYTES,
    lv_distance_bytes_cuda,
    lv_distance_cuda,
)
from salt_tpu_torch.ops.rank import (
    build_rank_index,
    lf_step,
    rank_excl,
    rank_index_on,
)
from salt_tpu_torch.ops.sa_walk_cuda import SA_WALK as K4
from salt_tpu_torch.ops.sa_walk_cuda import resolve_sampled_cuda
from salt_tpu_torch.ops.seed import seed_overlap, seed_overlap_plain
from salt_tpu_torch.ops.seed_cuda import SEED as K3
from salt_tpu_torch.ops.seed_cuda import seed_overlap_cuda
from salt_tpu_torch.ops.sw_batch import sw_score_numpy, sw_score_plain
from salt_tpu_torch.ops.sw_cuda import SW, sw_score_cuda, sw_score_launch
from salt_tpu_torch.parallel.mesh import make_mesh, sharded_full_step
from salt_tpu_torch.parallel.sharded import (
    merge_sharded_hits,
    partition_contigs_contiguous,
    sharded_se_step,
    stack_indexes,
)
from salt_tpu_torch.parallel.sharded_engine import (
    ShardedPEAligner,
    ShardedSEAligner,
)
from salt_tpu_torch.pipeline import se as se_mod
from salt_tpu_torch.pipeline.device_index import (
    host_route_index,
    pack_nibbles,
    to_device_index,
)
from salt_tpu_torch.pipeline.engine import (
    SEAligner,
    SEOptions,
    encode_reads,
    revcomp,
)
from salt_tpu_torch.pipeline.pe_engine import PEAligner, PEOptions
from salt_tpu_torch.polish import polish as polish_mod
from salt_tpu_torch.sim.genome_gen import sample_snps, synthesize_genome
from salt_tpu_torch.tools import bench, profile_se, run_accuracy, sa_walk_check
from salt_tpu_torch.utils.metrics import metrics, metrics_reset
from salt_tpu_torch.utils.native import load_native

GENOME_LEN = 45_000_000
N_CONTIGS = 8        # bins of the sharded aligner are runs of contigs
N_SHARDS = 4
CLI_GENOME_LEN = 3_000_000
CLI_READS = 4096
MESH_READS = 2048    # rows of the data-parallel step
SNP_EVERY = 300
READ_LEN = 100
# Reads keep this far from their contig's ends.  The gapped step skips a
# candidate whose window (position + read length + GAP_WINDOW_PAD) reaches
# the end of the index it is checked in: a bin's end in a sharded run, the
# genome's in a monolithic one.  A read the gapped step can accept carries
# at most READ_LEN // 10 inserted bases, so beyond this margin the two
# runs must give the same SAM (tests/test_torch_shard_slice.py pins the
# rule down on reads inside the margin).
EDGE = GAP_WINDOW_PAD + READ_LEN // 10 + 2
BATCH = 8192
N_TIMED = 3          # timed batches of the SE LV phase
N_TIMED_SW = 2       # timed batches of the -X 1 phase, chunks of the PE phase
PE_CHUNK = BATCH // 2
CPU_CHECK = 1024
PE_CPU_CHECK = 512
# share of pairs with both ends within 5 bp of truth: 98.2% in a CPU run
# of this script's PE phase on a 3,000,000-base genome (2,048 pairs); the
# pairs that miss are rescued ends that SW soft-clips by more than 5 bp
PE_CORRECT_FLOOR = 0.95
SEED = 11
# K1's group sizes change after k = 3, 7 and 15 (8, 16, 32 lanes, then two
# diagonals a lane)
LV_KS = (0, 3, 7, 8, 10, 15, 16, 30)
HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
INT32_LANES_PER_SM = 64       # Hopper SM: 64 int32 lanes, one op a clock
PROFILE_TRIES = 2
KERNELS = {"lv_distance": LV, "lv_distance_bytes": LV_BYTES, "sw_score": SW,
           "seed_overlap": K3, "sa_walk": K4}
# K1's byte form: polish's match codes (bases, N, 3 - N of a reverse
# strand read, any stray byte) and its call (k = 13, no window padding)
POLISH_CODES = np.array([1, 2, 4, 8, 16, 32, 64], np.uint8)
LVB_KS = (0, 3, 7, 13, 15, 16, 30)
LVB_BATCHES = (1, 7, 129, 4096)
POLISH_K = 13
N_RESOLVE = 65536    # ranks a family in the sampled resolver check
SW_POLISH = 512      # records of the -s polish run


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def int32_ops_per_s() -> float:
    """The card's peak int32 rate: SMs x 64 lanes x the maximum SM clock
    nvidia-smi reports (one operation per lane and clock)."""
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60).stdout.split()[0])
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    return n_sm * INT32_LANES_PER_SM * mhz * 1e6


def bound(n_bytes: float, n_ops: float, ops_per_s: float) -> dict:
    """The least time the card could take: bytes over the memory rate or
    int32 operations over the int32 rate, whichever is larger."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": n_bytes, "operations": n_ops}


def timed(fn, reps):
    """Mean host-clock ms per call over reps calls, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def time_turns(kern, plain, kern_reps=50, plain_reps=5) -> dict:
    """Kernel and plain version in turns plain, kernel, kernel, plain on
    the host clock, the kernel's device time (device_ms) and the plain
    version's (profiled_ms)."""
    p1, k1, k2, p2 = (timed(plain, plain_reps), timed(kern, kern_reps),
                      timed(kern, kern_reps), timed(plain, plain_reps))
    return {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
            "turns_ms": [p1, k1, k2, p2],
            "device_ms": device_ms(kern, kern_reps),
            "profiler_ms": profiled_ms(kern, kern_reps),
            "plain_device_ms": profiled_ms(plain, plain_reps)}


# ---------------------------------------------------------------- inputs


def one_hot_reference(rng, n: int) -> np.ndarray:
    """n one-hot nibbles with ~5% SNP nibbles (two bits set)."""
    mix = (1 << rng.integers(0, 4, n)).astype(np.uint8)
    snp = rng.random(n) < 0.05
    mix[snp] |= (1 << rng.integers(0, 4, int(snp.sum()))).astype(np.uint8)
    return mix


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
    text = window_nibbles(words, pos, L + 8).cpu().numpy()
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
    {N: timings and bound})."""
    rng = np.random.default_rng(SEED)
    n_ref = 2_000_000
    words = torch.from_numpy(pack_nibbles(one_hot_reference(rng, n_ref))
                             .view(np.int32)).to(dev)
    max_err = 0
    for k in LV_KS:
        for L in (70, 100, 151, 250):
            N = 1000 + 37 * k + L          # not a multiple of the block size
            pos = rng.integers(0, n_ref - L - 80, N)
            pos[-2:] = [n_ref - 10, 2**32 - 7]   # clamped / wrapping windows
            pos = torch.from_numpy(pos.astype(np.int64)).to(dev)
            err, n_mid = check_kernel_case(words, pos, k, L, rng, dev)
            max_err = max(max_err, err)
            print(f"[kernel] k={k:2d} L={L:3d} N={N}: equal "
                  f"({n_mid} lanes with 0 < e < 255)", flush=True)

    pos = torch.from_numpy(rng.integers(0, n_ref - 2200, 300).astype(np.int64)).to(dev)
    for k in (10, 30):
        err, n_mid = check_kernel_case(words, pos, k, 2047, rng, dev)
        max_err = max(max_err, err)
        print(f"[kernel] k={k:2d} L=2047 N=300: equal ({n_mid} lanes with "
              f"0 < e < 255)", flush=True)

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
    ops = int32_ops_per_s()
    return max_err, {N: time_kernel(words, N, rng, dev, ops)
                     for N in (8192, 16384)}


def time_kernel(words, N, rng, dev, ops_per_s, k=10, L=READ_LEN):
    """Times of the LV kernel and of its plain version at (N, L, k), and
    the kernel's bound on these inputs.

    Bytes: each candidate's window words, read, position, flag and
    result.  Operations (an estimate, from the distances this run found):
    a candidate of distance d walks (d' + 1)^2 band cells, d' = min(d, k),
    at about 18 int32 operations a cell, plus one word step per 8 matched
    bases, about L operations."""
    n_ref = words.shape[0] * 8
    pos = torch.from_numpy(rng.integers(0, n_ref - 200, N).astype(np.int64)).to(dev)
    seq = torch.from_numpy(planted_reads(
        rng, window_nibbles(words, pos, L + 8).cpu().numpy(), L, 4)).to(dev)
    active = torch.ones(N, dtype=torch.bool, device=dev)

    def kern():
        return lv_distance_cuda(words, pos, active, seq, k, 4)

    def plain():
        return lv_distance_plain(words, pos, active, seq, k, 4, text_words=True)

    d = torch.clamp(kern().long(), max=k)
    n_ops = float((18 * (d + 1) ** 2 + L).sum())
    n_bytes = N * (((L + 4) // 8 + 2) * 4 + L + 8 + 1 + 4)
    out = {**time_turns(kern, plain), **bound(n_bytes, n_ops, ops_per_s)}

    # the same candidates with reads that match their windows exactly:
    # every group leaves after its set-up and the first run
    text = window_nibbles(words, pos, L).cpu().numpy()
    exact = torch.from_numpy(np.log2(np.maximum(text & -text, 1))
                             .astype(np.uint8)).to(dev)
    if int(lv_distance_cuda(words, pos, active, exact, k, 4).max()) != 0:
        raise AssertionError("LV kernel: exact copies of the window are not "
                             "at distance 0")
    out["setup_device_ms"] = device_ms(
        lambda: lv_distance_cuda(words, pos, active, exact, k, 4), 50)
    # and with every candidate inactive: a launch that loads one flag and
    # stores 255 a group, the floor under any time of this kernel
    idle = torch.zeros(N, dtype=torch.bool, device=dev)
    out["idle_device_ms"] = device_ms(
        lambda: lv_distance_cuda(words, pos, idle, seq, k, 4), 50)
    return out


# ---------------------------------------------------------------- K1, bytes


def byte_reference(rng, n: int) -> np.ndarray:
    """n match codes as polish encodes a reference: bases, 1% N, and a few
    of the two codes that only reads carry."""
    ref = POLISH_CODES[rng.integers(0, 4, n)]
    u = rng.random(n)
    ref[u < 0.01] = 16
    ref[u > 0.999] = POLISH_CODES[rng.integers(5, 7, int((u > 0.999).sum()))]
    return ref


def byte_case(rng, ref, N, L, max_subs):
    """(pos, active, pat) for N candidates.  Even rows are copies of their
    window with 0..max_subs substitutions and, in half of them, a 1-3 byte
    insertion or deletion; odd rows are unrelated.  The first rows sit at
    position 0, end at the last byte, are cut by the end of the reference
    and start at a position >= 2^31 (which reads byte 0 throughout)."""
    n = len(ref)
    pos = rng.integers(0, n - L - 8, N).astype(np.int64)
    edge = [0, n - L, n - L + 5, 2**31 + 11, n - 1, 2**32 - 3]
    pos[: min(N, len(edge))] = edge[:N]
    j = np.arange(L)[None, :]
    kind = rng.integers(0, 4, (N, 1))              # 0 del, 1 ins, 2-3 neither
    m = rng.integers(1, 4, (N, 1))
    at = rng.integers(1, max(L - 1, 2), (N, 1))
    src = pos[:, None] + j + np.where((kind == 0) & (j >= at), m, 0) \
        - np.where((kind == 1) & (j >= at), m, 0)
    src &= 0xFFFFFFFF                               # positions are uint32
    src = np.where(src >= 2**31, 0, np.minimum(src, n - 1))
    pat = ref[src]
    fresh = POLISH_CODES[rng.integers(0, 4, (N, L))]
    pat = np.where((kind == 1) & (j >= at) & (j < at + m), fresh, pat)
    n_sub = rng.integers(0, max_subs + 1, (N, 1))
    order = np.argsort(rng.random((N, L)), axis=1)
    other = POLISH_CODES[(np.log2(pat).astype(np.int64) + 1
                          + rng.integers(0, 3, (N, L))) % 4]
    pat = np.where(order < n_sub, other, pat)
    pat = np.where(np.arange(N)[:, None] % 2 == 0, pat, fresh)
    stray = rng.random((N, L)) < 0.002
    pat = np.where(stray, POLISH_CODES[rng.integers(4, 7, (N, L))], pat)
    active = rng.random(N) < 0.9
    active[:6] = True
    return pos, active, pat.astype(np.uint8)


def byte_kernel_phase(dev, ops_per_s):
    """K1's byte form against its plain version on the card.  Returns
    (max_abs_err, {N: timings and bound})."""
    rng = np.random.default_rng(SEED + 4)
    n_ref = 2_000_003                      # the last word of bytes is ragged
    ref_np = byte_reference(rng, n_ref)
    ref = torch.from_numpy(ref_np).to(dev)
    max_err = 0
    for k in LVB_KS:
        for L in (70, 100, 151, 250):
            mid = big = 0
            for N in LVB_BATCHES:
                pos, active, pat = (torch.from_numpy(a).to(dev) for a in
                                    byte_case(rng, ref_np, N, L, k + 3))
                got = lv_distance_bytes_cuda(ref, pos, active, pat, k, 0)
                want = lv_distance_plain(ref, pos, active, pat, k, 0,
                                         pat_precoded=True)
                torch.cuda.synchronize()
                if not torch.equal(got.long(), want):
                    bad = torch.nonzero(got.long() != want)[:5, 0].tolist()
                    raise AssertionError(
                        f"LV byte form != plain at k={k} L={L} N={N}: rows {bad}, "
                        f"kernel {got[bad].tolist()}, plain {want[bad].tolist()}")
                max_err = max(max_err, int((got.long() - want).abs().max()))
                mid += int(((want > 0) & (want < 255)).sum())
                big += int((want == 255).sum())
            print(f"[kernel] lv bytes k={k:2d} L={L:3d} N={LVB_BATCHES}: equal "
                  f"({mid} rows with 0 < e < 255, {big} at 255)", flush=True)
    times = {}
    for N in (4096, 8192):
        pos, active, pat = (torch.from_numpy(a).to(dev) for a in
                            byte_case(rng, ref_np, N, READ_LEN, 4))
        active[:] = True
        times[N] = time_byte_kernel(ref, pos, active, pat, ops_per_s)
    return max_err, times


def time_byte_kernel(ref, pos, active, pat, ops_per_s, k=POLISH_K):
    """Times of K1's byte form and of its plain version on these
    candidates as polish calls them (window_pad = 0), and the bound.
    Bytes: each candidate's L window bytes and L read bytes, position,
    flag and result.  Operations: as for the nibble form, 18 a band cell of
    the (d' + 1)^2 a candidate of distance d walks, d' = min(d, k), plus
    L."""
    N, L = pat.shape

    def kern():
        return lv_distance_bytes_cuda(ref, pos, active, pat, k, 0)

    def plain():
        return lv_distance_plain(ref, pos, active, pat, k, 0, pat_precoded=True)

    d = kern().long()
    if not torch.equal(d, plain()):
        raise AssertionError(f"LV byte form != plain at the timed N={N} L={L}")
    d = torch.clamp(d, max=k)
    n_ops = float((18 * (d + 1) ** 2 + L).sum())
    n_bytes = N * (2 * L + 8 + 1 + 4)
    return {**time_turns(kern, plain), **bound(n_bytes, n_ops, ops_per_s),
            "shape": {"N": N, "L": L, "k": k, "window_pad": 0}}


def device_ms(fn, reps):
    """Device time per call of a kernel's wrapper: reps calls captured
    into one CUDA graph, which is replayed once to warm up and once
    between two CUDA events.  The kernels run back to back on the card
    with no host in between, so the time holds for kernels far shorter
    than a launch from Python takes."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def profiled_ms(fn, reps):
    """Device time per call summed over every kernel fn runs, from
    torch.profiler traces (for the plain versions, which are many small
    kernels a call).  A trace can come back with events missing, which
    only lowers the sum: the largest of PROFILE_TRIES traces is returned
    (None when none holds device time)."""
    from torch.profiler import ProfilerActivity, profile

    best = 0.0
    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        best = max(best, sum(e.self_device_time_total
                             for e in prof.key_averages()))
    return best / 1e3 / reps if best else None


# ---------------------------------------------------------------- K2 phase

SW_SHAPES = ((100, 105), (104, 512), (152, 512), (250, 768), (33, 40),
             # strip and instantiation boundaries, windows narrower than a
             # group of lanes
             (128, 140), (129, 140), (256, 300), (257, 300), (100, 5), (7, 3))
SW_BATCHES = (1, 7, 129, 4096)
SW_LANES = (16, 1)    # the instantiations the C entry point can force
SW_WAVE_MAX_LEN = 256
SW_OPS_PER_CELL = 9
SW_OPS_PER_CELL_PLAIN_MAX = 12
SW_PATH_SHAPES = (("x1", True, BATCH, READ_LEN, READ_LEN + 5),
                  ("pe", False, 4096, 104, 512))


def sw_case(rng, snp: bool, B: int, L: int, W: int, full_len=False):
    """(refs, reads, ref_len) as uint8, uint8, int32 arrays.  Half of the
    reads are copies of a stretch of their window with ~2% substitutions
    and, in half of those, a 1-6 bp insertion or deletion; the rest are
    unrelated.  Windows carry multi-bit, 0 and 15 nibbles (SNP mode) or N
    codes (plain mode); reads carry N codes, and a third end in padding
    (0 in SNP mode, 4 in plain mode).  ref_len runs from 0 to W unless
    full_len."""
    codes = rng.integers(0, 4, (B, W))
    j = np.arange(L)[None, :]
    at = rng.integers(0, max(W - L - 6, 1), (B, 1))
    m = rng.integers(1, 7, (B, 1))
    cut = rng.integers(5, max(L - 5, 6), (B, 1))
    kind = rng.integers(0, 4, (B, 1))            # 0 del, 1 ins, 2-3 neither
    src = at + j + np.where((kind == 0) & (j >= cut), m, 0) \
        - np.where((kind == 1) & (j >= cut), m, 0)
    read = np.take_along_axis(codes, np.clip(src, 0, W - 1), 1)
    fresh = rng.integers(0, 4, (B, L))
    read = np.where((kind == 1) & (j >= cut) & (j < cut + m), fresh, read)
    read = np.where(rng.random((B, L)) < 0.02, (read + 1) & 3, read)
    read = np.where(rng.random((B, 1)) < 0.5, read, fresh)     # unrelated half
    u = rng.random((B, W))
    v = rng.random((B, L))
    pad = np.where(rng.random((B, 1)) < 0.33, rng.integers(1, 9, (B, 1)), 0)
    if snp:
        refs = 1 << codes
        extra = 1 << rng.integers(0, 4, (B, W))
        refs = np.where(u < 0.05, refs | extra, refs)                # two bits
        refs = np.where(u < 0.01, refs | (1 << ((codes + 2) & 3)), refs)
        refs = np.where(u > 0.995, 0, np.where(u > 0.99, 15, refs))
        reads = np.where(v > 0.995, 15, 1 << read)
        reads = np.where(j >= L - pad, 0, reads)
    else:
        refs = np.where(u > 0.995, 4, codes)
        reads = np.where(v > 0.995, 4, read)
        reads = np.where(j >= L - pad, 4, reads)
    ref_len = rng.integers(0, W + 1, B)
    ref_len[rng.random(B) < 0.3] = W
    if B > 2:
        ref_len[:2] = (0, W)
    if full_len:
        ref_len[:] = W
    return (refs.astype(np.uint8), reads.astype(np.uint8),
            ref_len.astype(np.int32))


def sw_lanes_allowed(L: int) -> tuple:
    """The instantiations that take reads of L bases: the wavefront (16
    lanes a pair, at most 16 rows a lane) and one thread a pair."""
    return tuple(g for g in SW_LANES if g == 1 or L <= SW_WAVE_MAX_LEN)


def check_sw_case(rng, snp, B, L, W, dev, n_oracle=2):
    """The chosen and every allowed instantiation against the plain
    version, a sample against the numpy oracle.  Returns (scores >= 50,
    the lanes the shape chose)."""
    refs, reads, lens = sw_case(rng, snp, B, L, W)
    t = [torch.from_numpy(a).to(dev) for a in (refs, reads, lens)]
    want = sw_score_plain(*t, snp)
    got = sw_score_cuda(*t, snp)
    for lanes in (0,) + sw_lanes_allowed(L):
        out = got if lanes == 0 else sw_score_launch(*t, snp, lanes=lanes)
        torch.cuda.synchronize()
        if not torch.equal(out, want):
            bad = torch.nonzero(out != want)[:5, 0].tolist()
            raise AssertionError(
                f"SW kernel != plain, snp={snp} B={B} L={L} W={W} lanes="
                f"{lanes}: rows {bad}, kernel {out[bad].tolist()}, plain "
                f"{want[bad].tolist()}")
    got = got.cpu().numpy()
    for i in rng.choice(B, min(n_oracle, B), replace=False):
        ref = sw_score_numpy(refs[i, : lens[i]], reads[i], snp)
        if got[i] != ref:
            raise AssertionError(f"SW kernel {got[i]} != numpy oracle {ref}, "
                                 f"snp={snp} B={B} L={L} W={W} row {i}")
    return int((got >= 50).sum()), SW.build().salt_sw_lanes(L, W)


def sw_kernel_phase(dev, ops_per_s):
    """K2 against its plain version (and the numpy oracle) on the card.
    Returns (max_abs_err, {shape name: timings and bound}, timings of the
    long-read instantiation); any disagreement raises, so the error
    returned is 0."""
    rng = np.random.default_rng(SEED + 1)
    for snp in (True, False):
        for L, W in SW_SHAPES:
            done = [check_sw_case(rng, snp, B, L, W, dev) for B in SW_BATCHES]
            print(f"[kernel] sw {'snp  ' if snp else 'plain'} L={L:3d} W={W:3d} "
                  f"B={SW_BATCHES}: equal with lanes {[c for _, c in done]} "
                  f"chosen and {sw_lanes_allowed(L)} forced "
                  f"({sum(h for h, _ in done)} scores >= 50)", flush=True)
    high, lanes = check_sw_case(rng, True, 64, 2047, 2056, dev, n_oracle=1)
    print(f"[kernel] sw snp   L=2047 W=2056 B=64: equal with lanes {lanes} "
          f"({high} scores >= 50)", flush=True)
    times = {name: time_sw_kernel(rng, snp, B, L, W, dev, ops_per_s)
             for name, snp, B, L, W in SW_PATH_SHAPES}
    return 0, times, time_sw_long(rng, dev, ops_per_s)


def sw_bound(lens, B, L, W, ops_per_s):
    """K2's bound: each pair's W + L code bytes, length and score once,
    and ref_len x L cells at 9 int32 operations a cell, what the function
    needs on a card with fused add-max and three-way max-with-zero
    (Hopper's DPX): E a subtraction and an add-max, F the same, the score
    a test and a select, the diagonal's addition, H one three-way maximum,
    the best one maximum.  `bound_ms_12ops` counts the 12 that the cell
    takes with two-operand maxima only, the figure kept in earlier
    records."""
    cells = float(lens.astype(np.int64).sum()) * L
    n_bytes = B * (W + L + 4 + 4)
    out = bound(n_bytes, SW_OPS_PER_CELL * cells, ops_per_s)
    out["bound_ms_12ops"] = bound(
        n_bytes, SW_OPS_PER_CELL_PLAIN_MAX * cells, ops_per_s)["bound_ms"]
    return out


def time_sw_kernel(rng, snp, B, L, W, dev, ops_per_s):
    """Times at (B, L, W) with full windows: the plain version and the
    instantiation the shape chooses (time_turns); that instantiation
    against the one-thread-per-pair kernel, the design before the
    wavefront, in turns old, new, new, old on the host clock and by device
    time; and the bound."""
    refs, reads, lens = sw_case(rng, snp, B, L, W, full_len=True)
    t = [torch.from_numpy(a).to(dev) for a in (refs, reads, lens)]
    chosen = SW.build().salt_sw_lanes(L, W)
    want = sw_score_plain(*t, snp)

    def forced(lanes):
        return lambda: sw_score_launch(*t, snp, lanes=lanes)

    for lanes in sw_lanes_allowed(L):
        if not torch.equal(forced(lanes)(), want):
            raise AssertionError(f"SW kernel with lanes={lanes} != plain at the "
                                 f"path shape B={B} L={L} W={W}")
    out = time_turns(lambda: sw_score_cuda(*t, snp),
                     lambda: sw_score_plain(*t, snp), plain_reps=3)
    old, new = forced(1), forced(chosen)
    turns = [timed(old, 20), timed(new, 50), timed(new, 50), timed(old, 20)]
    dev_turns = [device_ms(old, 20), device_ms(new, 50), device_ms(new, 50),
                 device_ms(old, 20)]
    out.update(sw_bound(lens, B, L, W, ops_per_s))
    out.update({
        "shape": {"B": B, "L": L, "W": W, "snp_mode": snp},
        "lanes": chosen, "old_new_new_old_ms": turns,
        "old_new_new_old_device_ms": dev_turns,
        "earlier_ms": (dev_turns[0] + dev_turns[3]) / 2})
    if not max(turns[1:3]) < min(turns[0], turns[3]) or \
            not max(dev_turns[1:3]) < min(dev_turns[0], dev_turns[3]):
        raise AssertionError(f"SW kernel at {out['shape']}: lanes={chosen} is "
                             f"not faster than one thread a pair: host "
                             f"{turns}, device {dev_turns}")
    return out


def time_sw_long(rng, dev, ops_per_s, B=64, L=2047, W=2056):
    """Device and host-clock time of the long-read instantiation (one
    thread a pair) at the longest read the aligner takes, and its bound."""
    refs, reads, lens = sw_case(rng, True, B, L, W, full_len=True)
    t = [torch.from_numpy(a).to(dev) for a in (refs, reads, lens)]

    def kern():
        return sw_score_cuda(*t, True)

    return {"shape": {"B": B, "L": L, "W": W, "snp_mode": True},
            "lanes": SW.build().salt_sw_lanes(L, W),
            "ms": timed(kern, 3), "device_ms": device_ms(kern, 3),
            **sw_bound(lens, B, L, W, ops_per_s)}


def time_sw_path_batches(sent, dev, ops_per_s):
    """K2 at the batches the paths really sent.  `sent` maps a path to
    the (snp_mode, B, L, W) of each launch of its timed run; for every
    (path, mode, L, W) the median B is timed with full windows: the
    chosen instantiation and one thread a pair, device time in turns old,
    new, new, old, and the bound."""
    rng = np.random.default_rng(SEED + 3)
    out = []
    for path, calls in sent.items():
        for snp, L, W in sorted({(c[0], c[2], c[3]) for c in calls}):
            sizes = sorted(c[1] for c in calls if (c[0], c[2], c[3]) == (snp, L, W))
            B = sizes[len(sizes) // 2]
            refs, reads, lens = sw_case(rng, snp, B, L, W, full_len=True)
            t = [torch.from_numpy(a).to(dev) for a in (refs, reads, lens)]
            chosen = SW.build().salt_sw_lanes(L, W)
            want = sw_score_plain(*t, snp)
            for lanes in (chosen, 1):
                if not torch.equal(sw_score_launch(*t, snp, lanes=lanes), want):
                    raise AssertionError(f"SW kernel with lanes={lanes} != plain "
                                         f"at the {path} batch B={B} L={L} W={W}")
            turns = [device_ms(lambda: sw_score_launch(*t, snp, lanes=n), reps)
                     for n, reps in ((1, 20), (chosen, 50), (chosen, 50), (1, 20))]
            rec = {"path": path, "batches_sent": sizes, "lanes": chosen,
                   "shape": {"B": B, "L": L, "W": W, "snp_mode": snp},
                   "device_ms": (turns[1] + turns[2]) / 2,
                   "earlier_ms": (turns[0] + turns[3]) / 2,
                   "old_new_new_old_device_ms": turns,
                   **sw_bound(lens, B, L, W, ops_per_s)}
            print(f"[kernel] sw on the {path} path: launches of B={sizes} pairs "
                  f"(L={L}, W={W}, {'snp' if snp else 'plain'} mode); at "
                  f"B={B}: lanes {chosen}, device ms old, new, new, old {turns}; "
                  f"bound {rec['bound_ms']:.6f} ms ({rec['bound_ms_12ops']:.6f} "
                  f"at 12 operations a cell)", flush=True)
            out.append(rec)
    return out


# ---------------------------------------------------------------- slices


def make_genome(genome_len, snp_every, rng):
    """A random genome in N_CONTIGS contigs of unequal length with one SNP
    per snp_every bases.  Returns (contig_data, blocks, bounds, hap, codes,
    pos, alt): contig c holds bases bounds[c]..bounds[c + 1], `hap` carries
    every SNP's other allele."""
    lut = np.frombuffer(b"ACGT", dtype=np.uint8)
    codes = rng.integers(0, 4, genome_len, dtype=np.int64).astype(np.uint8)
    n_snp = genome_len // snp_every
    pos = np.sort(rng.choice(genome_len, n_snp, replace=False).astype(np.int64))
    alt = ((codes[pos] + rng.integers(1, 4, n_snp)) % 4).astype(np.uint8)
    stype = ((1 << codes[pos]) | (1 << alt) | (codes[pos] << 4)).astype(np.uint8)
    weight = np.arange(N_CONTIGS) % 3 + 2
    bounds = np.concatenate([[0], np.cumsum(weight) * genome_len
                             // weight.sum()]).astype(np.int64)
    contig_data, blocks = [], []
    for c in range(N_CONTIGS):
        lo, hi = bounds[c], bounds[c + 1]
        own = (pos >= lo) & (pos < hi)
        contig_data.append((f"chr{c + 1}", "synt", lut[codes[lo:hi]]))
        blocks.append(SnpBlock(f"chr{c + 1}", (pos[own] - lo).astype(np.uint32),
                               stype[own]))
    hap = codes.copy()
    hap[pos] = alt
    return contig_data, blocks, bounds, hap, codes, pos, alt


def make_index(genome_len, snp_every, rng):
    """One monolithic index and the N_SHARDS sub-indexes of contiguous
    bins, built side by side in threads (the native suffix sort runs
    outside the interpreter lock).  Returns (index, shard indexes, bins,
    contig bounds, SNP haplotype)."""
    contig_data, blocks, bounds, hap, *_ = make_genome(genome_len, snp_every, rng)
    bins = partition_contigs_contiguous([len(c[2]) for c in contig_data],
                                        N_SHARDS)
    t0 = time.perf_counter()

    def build(members):
        t = time.perf_counter()
        idx = build_index_from_data([contig_data[i] for i in members],
                                    [blocks[i] for i in members], l_seed=19)
        return idx, time.perf_counter() - t

    with ThreadPoolExecutor(1 + N_SHARDS) as pool:
        (idx, dt), *subs = pool.map(build, [list(range(N_CONTIGS))] + bins)
    print(f"[index] {genome_len} bases in {N_CONTIGS} contigs, "
          f"{genome_len // snp_every} SNPs: monolithic host build {dt:.1f} s; "
          f"{N_SHARDS} sub-indexes over contig bins {bins} of "
          f"{[s.l_pac for s, _ in subs]} bases: "
          f"{[round(t, 1) for _, t in subs]} s; all side by side in "
          f"{1 + N_SHARDS} threads {time.perf_counter() - t0:.1f} s", flush=True)
    return idx, [s for s, _ in subs], bins, bounds, hap


def contig_local(starts, bounds):
    """Genome positions as positions within their contig, as SAM gives
    them."""
    return starts - bounds[np.searchsorted(bounds, starts, side="right") - 1]


def keep_inside(starts, span, bounds):
    """`starts` moved so that [start, start + span) lies in one contig,
    EDGE bases from its ends (see EDGE)."""
    c = np.searchsorted(bounds, starts, side="right") - 1
    return np.clip(starts, bounds[c] + EDGE, bounds[c + 1] - span - EDGE)


def read_seqs(hap, starts, flip, L, rng, sub_rate=0.001, indel_frac=0.1,
              heavy=None):
    """Read strings from the SNP haplotype at `starts` (leftmost reference
    positions): substitutions at sub_rate, a 1-3 bp insertion or deletion
    in indel_frac of the reads, 15 substitutions in the reads flagged
    `heavy`, and the reads flagged `flip` reverse-complemented."""
    n = len(starts)
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
    if heavy is not None:
        rank = np.argsort(rng.random((n, L)), axis=1)
        win = np.where(heavy[:, None] & (rank < 15), (win + 1) & 3, win)
    win[flip] = 3 - win[flip, ::-1]
    lut = np.frombuffer(b"ACGT", dtype=np.uint8)
    seqs = lut[win.astype(np.uint8)]
    return [seqs[i].tobytes().decode("latin1") for i in range(n)]


def simulate_reads(hap, bounds, n, L, rng):
    """SE reads, half from the reverse strand, each inside one contig.
    Returns (records, true leftmost positions within the contig)."""
    starts = keep_inside(rng.integers(0, len(hap) - L - 8, n), L + 8, bounds)
    seqs = read_seqs(hap, starts, rng.random(n) < 0.5, L, rng)
    recs = [SeqRecord(f"r{i}_{starts[i]}", None, seqs[i], "I" * L)
            for i in range(n)]
    return recs, contig_local(starts, bounds)


def simulate_pairs(hap, bounds, n, L, rng):
    """FR pairs, each inside one contig, insert size normal(400, 30); 5%
    with one end carrying 15 substitutions (singleton rescue) and 3% with
    the ends 2,000 bp apart (pair2 rescue).  Returns (first-end records,
    second-end records, (n, 2) true leftmost positions within the contig)."""
    ins = np.clip(rng.normal(400, 30, n).round().astype(np.int64), 2 * L, 600)
    kind = rng.random(n)
    far = (kind >= 0.05) & (kind < 0.08)
    span = np.where(far, 2000 + L, ins)
    left = keep_inside(rng.integers(0, len(hap) - 2700, n), 2700, bounds)
    right = left + span - L
    heavy_end = rng.integers(0, 2, n)
    swap = rng.random(n) < 0.5                 # which end is the forward one
    starts = np.stack([np.where(swap, right, left),
                       np.where(swap, left, right)], 1)
    ends = []
    for e in (0, 1):
        seqs = read_seqs(hap, starts[:, e], swap == (e == 0), L, rng,
                         heavy=(kind < 0.05) & (heavy_end == e))
        ends.append([SeqRecord(f"p{i}_{starts[i, 0]}_{starts[i, 1]}/{e + 1}",
                               None, seqs[i], "I" * L) for i in range(n)])
    return ends[0], ends[1], contig_local(starts, bounds)


def accuracy(sam, truth):
    mapped = ok = 0
    for line, t in zip(sam, truth):
        f = line.split("\t")
        if f[2] == "*":
            continue
        mapped += 1
        ok += abs(int(f[3]) - 1 - int(t)) <= 5
    return mapped / len(sam), ok / max(mapped, 1)


def note_sw_batches(al, sent):
    """Wraps the aligner's K2 call so that each launch appends its
    (snp_mode, B, L, W) to the list `sent`."""
    score = al._sw_scores

    def noting(refs, reads, lens, snp_mode):
        sent.append((bool(snp_mode), refs.shape[0], reads.shape[1],
                     refs.shape[1]))
        return score(refs, reads, lens, snp_mode)

    al._sw_scores = noting


LV_SENT = []    # (candidates, L, k) of every K1 call of the gapped step
LV_SHAPES = {}  # report_run's tag -> the distinct shapes of that timed run


def note_lv_batches():
    """Wraps the gapped step's K1 call so that each appends its shape to
    LV_SENT (reset_counts empties it)."""
    lv = se_mod.lv_distance_batch

    def noting(words, pos, active, seq, k, **kw):
        LV_SENT.append((pos.shape[0], seq.shape[1], k))
        return lv(words, pos, active, seq, k, **kw)

    se_mod.lv_distance_batch = noting


def reset_counts():
    metrics_reset()
    del LV_SENT[:]
    for kern in KERNELS.values():
        kern.launches = 0


def report_run(tag, n, unit, dt, need):
    """Prints the rate, the stage table and the launch counts of a timed
    run; raises unless every kernel in `need` launched.  Returns
    {kernel: launches}."""
    counts = {name: kern.launches for name, kern in KERNELS.items()}
    print(f"[{tag}] {n} {unit} in {dt:.3f} s = {n / dt:.1f} {unit}/s", flush=True)
    for name, (tot, cnt) in sorted(metrics().items(), key=lambda kv: -kv[1][0]):
        print(f"[{tag}]   {name:<22} {tot:9.3f} s  {cnt:5d} calls", flush=True)
    print(f"[{tag}] kernel launches in the timed run: {counts}", flush=True)
    LV_SHAPES[tag] = sorted(set(LV_SENT))
    for name in need:
        if counts[name] == 0:
            raise AssertionError(f"the {tag} run never launched {name}")
    return counts


def assert_same_sam(tag, what, want, got):
    diff = [i for i, (a, b) in enumerate(zip(want, got)) if a != b]
    print(f"[{tag}] {what}: {len(diff)} of {len(want)} SAM records differ",
          flush=True)
    if diff or len(want) != len(got):
        raise AssertionError(f"{tag}: {what} SAM differs, first at "
                             f"{diff[:1]}:\n{want[diff[0]]}\n{got[diff[0]]}")


def se_phase(tag, idx, recs, truth, dev, need, n_timed, sent=None,
             same_as=None, **extra):
    """One warm-up and n_timed timed batches of SEAligner on the card;
    accuracy bounds; CPU rerun of the first reads or, with `same_as` (the
    warm-up and timed SAM of another mode on the same reads), equality
    with those.  Returns the timed run's launch counts, the aligner, its
    options and the two SAM lists; `sent` (a list) receives the shape of
    every K2 launch of the timed run."""
    torch.cuda.reset_peak_memory_stats()
    opts = SEOptions(l_overlap=1, max_locate=500, print_nm_md=True,
                     print_xa_cigar=True, batch_size=BATCH, gap_batch=128,
                     **extra)
    t0 = time.perf_counter()
    held = torch.cuda.memory_allocated()
    al = SEAligner(idx, opts, device=dev)
    if sent is not None:
        note_sw_batches(al, sent)
    torch.cuda.synchronize()
    print(f"[{tag}] index to {dev}: {time.perf_counter() - t0:.2f} s, "
          f"{torch.cuda.memory_allocated() - held} bytes of device memory",
          flush=True)
    t0 = time.perf_counter()
    warm = al.align_records(recs[:BATCH])
    print(f"[{tag}] warm-up batch: {time.perf_counter() - t0:.2f} s", flush=True)

    timed_recs = recs[BATCH : BATCH * (1 + n_timed)]
    reset_counts()
    if sent is not None:
        sent.clear()
    t0 = time.perf_counter()
    out = al.align_records(timed_recs)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = report_run(tag, len(out), "reads", dt, need)
    mapped, correct = accuracy(out, truth[BATCH : BATCH + len(out)])
    cig = [line.split("\t")[5] for line in out]
    n_gap = sum(1 for c in cig if "I" in c or "D" in c)
    print(f"[{tag}] mapped {mapped:.4%}, within 5 bp of truth {correct:.4%} "
          f"of mapped, {n_gap} gapped cigars", flush=True)
    if mapped < 0.9 or correct < 0.9 or n_gap == 0:
        raise AssertionError(f"{tag}: alignment accuracy out of bounds")
    print(f"[{tag}] peak device memory {torch.cuda.max_memory_allocated()} "
          f"bytes", flush=True)

    if same_as is not None:
        assert_same_sam(tag, "warm-up batch against full mode", same_as[0], warm)
        assert_same_sam(tag, "timed batches against full mode", same_as[1], out)
        return counts, al, opts, warm, out
    t0 = time.perf_counter()
    cpu = SEAligner(idx, opts, device="cpu").align_records(recs[:CPU_CHECK])
    assert_same_sam(tag, f"CPU rerun of {CPU_CHECK} reads "
                    f"({time.perf_counter() - t0:.1f} s)", cpu, warm[:CPU_CHECK])
    return counts, al, opts, warm, out


def x1_phase(idx, recs, truth, dev, sent):
    counts, _al, opts, warm, _out = se_phase(
        "x1", idx, recs, truth, dev, ("sw_score",), N_TIMED_SW, sent,
        extend_algo="sw", device_sw="auto")
    off = SEAligner(idx, dataclasses.replace(opts, device_sw="off"), device=dev)
    assert_same_sam("x1", f"pre-filter off, {CPU_CHECK} reads on the card",
                    off.align_records(recs[:CPU_CHECK]), warm[:CPU_CHECK])
    return counts, warm


def pe_phase(idx, hap, bounds, dev, sent):
    rng = np.random.default_rng(SEED + 2)
    n = PE_CHUNK * (1 + N_TIMED_SW)
    r1, r2, truth = simulate_pairs(hap, bounds, n, READ_LEN, rng)
    kw = dict(l_overlap=1, max_locate=500, print_nm_md=True,
              print_xa_cigar=True, batch_size=BATCH, gap_batch=128)
    al = PEAligner(idx, PEOptions(device_sw="auto", **kw), device=dev)
    note_sw_batches(al._se, sent)
    t0 = time.perf_counter()
    warm = al.align_pairs(r1[:PE_CHUNK], r2[:PE_CHUNK])
    print(f"[pe] warm-up chunk: {time.perf_counter() - t0:.2f} s", flush=True)

    reset_counts()
    sent.clear()
    t0 = time.perf_counter()
    out = al.align_pairs(r1[PE_CHUNK:], r2[PE_CHUNK:])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = report_run("pe", len(out) // 2, "pairs", dt,
                        ("lv_distance", "sw_score"))
    seen = {c[0] for c in sent}
    if seen != {True, False}:
        raise AssertionError(f"pe: SW kernel ran in modes {seen}, expected the "
                             "SNP mode (pair2) and the plain mode (singleton)")
    t = truth[PE_CHUNK:]
    both = mapped = 0
    for i in range(len(t)):
        f0, f1 = out[2 * i].split("\t"), out[2 * i + 1].split("\t")
        m0, m1 = not int(f0[1]) & 4, not int(f1[1]) & 4
        mapped += m0 + m1
        both += (m0 and m1 and abs(int(f0[3]) - 1 - int(t[i, 0])) <= 5
                 and abs(int(f1[3]) - 1 - int(t[i, 1])) <= 5)
    proper = sum(1 for line in out[::2] if int(line.split("\t")[1]) & 2)
    clipped = sum(1 for line in out if "S" in line.split("\t")[5])
    print(f"[pe] ends mapped {mapped / (2 * len(t)):.4%}, both ends within 5 bp "
          f"of truth {both / len(t):.4%} of pairs, proper pairs "
          f"{proper / len(t):.4%}, {clipped} soft-clipped (rescued) ends",
          flush=True)
    if both / len(t) < PE_CORRECT_FLOOR:
        raise AssertionError("pe: share of correct pairs under "
                             f"{PE_CORRECT_FLOOR}")

    a, b = r1[:PE_CPU_CHECK], r2[:PE_CPU_CHECK]
    off = PEAligner(idx, PEOptions(device_sw="off", **kw), device=dev)
    assert_same_sam("pe", f"pre-filter off, {PE_CPU_CHECK} pairs on the card",
                    off.align_pairs(a, b), warm[: 2 * PE_CPU_CHECK])
    t0 = time.perf_counter()
    cpu = PEAligner(idx, PEOptions(device_sw="auto", **kw),
                    device="cpu").align_pairs(a, b)
    assert_same_sam("pe", f"CPU rerun of {PE_CPU_CHECK} pairs "
                    f"({time.perf_counter() - t0:.1f} s)", cpu,
                    warm[: 2 * PE_CPU_CHECK])
    return counts, (r1[:PE_CHUNK], r2[:PE_CHUNK], kw), warm, out


def busy_share(al, recs, tag="se"):
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
    print(f"[{tag}] profiled batch of {len(recs)} reads: wall {wall:.3f} s, "
          f"device busy {busy:.4f} s = {busy / wall:.2%}, "
          f"{sum(e.count for e in events)} kernels and copies", flush=True)
    for e in events[:8]:
        print(f"[{tag}]   {e.self_device_time_total / 1e3:9.3f} ms  "
              f"{e.count:6d}x  {e.key[:70]}", flush=True)


# ---------------------------------------------------------------- sampled mode


def resolver_check(idx, al, dev):
    """resolve_sampled on N_RESOLVE random ranks a family (rank 0 of each
    among them, 64 R ranks on a '#'), over the aligner's own sampled
    tables with its fused rank planes and with standalone ones, against
    salt's own walk (reference/sa_walk.py), itself held to csa / r_coord
    (tools/sa_walk_check.py)."""
    out = sa_walk_check.check(idx, dev, N_RESOLVE, (al.dix, al.sampled))
    print(f"[sampled] resolve_sampled against salt's walk: {out}",
          flush=True)
    bad = {k: v for k, v in out.items() if k.endswith("_differ") and v}
    if bad or out["on_sharp"] < sa_walk_check.N_SHARP:
        raise AssertionError(f"sampled locate differs: {out}")


SA_WALK_ROWS = 8192   # one 4,096-read batch of the benchmark, both strands


def sa_walk_kernel_check(al, recs, dev):
    """K4 against resolve_sampled_plain in one sampled locate of a real
    batch (SA_WALK_ROWS // 2 reads and their reverse complements, seeded
    with the aligner's options, located at its full cap): one K4 launch a
    block, every block's values and the loci and overflow flags equal.
    Then K4 and the plain version in turns on the first block, K4's
    device time (CUDA-graph replay) and its bound: per lane 32-byte
    sectors for the select row and the stop value, three more a step
    (symbol word, rank row, select row), and its 18 bytes of input and
    output; the steps are K4's own over zeroed stop values.  Returns the
    times."""
    o, dix = al.opts, al.dix
    fwd = encode_reads([r.seq for r in recs[: SA_WALK_ROWS // 2]])
    seq2 = torch.from_numpy(np.concatenate([fwd, revcomp(fwd)])
                            .astype(np.int64)).to(dev)
    c, r = seed_overlap(dix.ri_c, dix.ri_r, dix.lkt, seq2, dix.l_seed,
                        o.l_overlap, o.max_seed, r_lkt_sp=dix.r_lkt_sp,
                        r_lkt_ep=dix.r_lkt_ep)
    blocks = []
    real = locate_mod.resolve_sampled

    def noting(*args):
        blocks.append(args)
        return real(*args)

    def run(resolve):
        locate_mod.resolve_sampled = resolve
        try:
            return locate(c, r, dix.sa_cat, dix.c_sa_len, fwd.shape[1],
                          dix.l_pac, o.max_locate, o.full_cap(),
                          pe_mode=o.pe_locate, sampled=al.sampled,
                          ri_c=dix.ri_c, ri_r=dix.ri_r, chunk=o.locate_chunk)
        finally:
            locate_mod.resolve_sampled = real

    before = K4.launches
    got = run(noting)
    launched = K4.launches - before
    want = run(resolve_sampled_plain)
    torch.cuda.synchronize()
    bad = [name for name, a, b in (
        ("pos", got.loci.pos, want.loci.pos),
        ("pushed", got.loci.pushed, want.loci.pushed),
        ("overflow", got.overflow, want.overflow)) if not torch.equal(a, b)]
    lanes_bad = sum(int((resolve_sampled_cuda(*a) != resolve_sampled_plain(*a))
                        .sum()) for a in blocks)
    print(f"[sampled] locate of {seq2.shape[0]} rows at cap {o.full_cap()}: "
          f"{len(blocks)} blocks of {blocks[0][3].shape[1] if blocks else 0} "
          f"columns, {launched} K4 launches; loci {bad or 'equal'}; "
          f"{lanes_bad} lanes differ from the plain version; "
          f"{int(got.loci.pushed.sum())} loci pushed", flush=True)
    if bad or lanes_bad or not blocks or launched != len(blocks):
        raise AssertionError(f"K4 != plain in a sampled locate: loci {bad}, "
                             f"{lanes_bad} lanes, {launched} launches for "
                             f"{len(blocks)} blocks")
    args = blocks[0]
    sam, rank = args[0], args[3]
    zeroed = dataclasses.replace(sam, samples_cat=torch.zeros_like(
        sam.samples_cat))
    steps = resolve_sampled_cuda(zeroed, *args[1:])
    steps = int(torch.where(steps == 0xFFFFFFFF, 0, steps).sum())
    lanes = rank.numel()
    t = time_turns(lambda: resolve_sampled_cuda(*args),
                   lambda: resolve_sampled_plain(*args),
                   kern_reps=50, plain_reps=3)
    t.update(shape={"rows": rank.shape[0], "columns": rank.shape[1],
                    "intv": sam.intv, "active": int(args[5].sum()),
                    "steps": steps},
             **bound(32 * (3 * steps + 2 * lanes) + 18 * lanes,
                     24 * (steps + lanes), int32_ops_per_s()))
    return t


def rate_turns(tag, first, second, recs):
    """The reads through two warm aligners (name, aligner) in turns first,
    second, second, first within one process: two rates are compared
    here, not across phases that ran minutes apart on a shared host.
    Returns the four rates."""
    rates = []
    for name, al in (first, second, second, first):
        metrics_reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        al.align_records(recs)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        stages = metrics()
        rates.append(len(recs) / dt)
        print(f"[{tag}] turn {name:<10}: {len(recs)} reads in {dt:.3f} s = "
              f"{rates[-1]:.1f} reads/s; device.dispatch "
              f"{stages['device.dispatch'][0]:.3f} s, host.finalize "
              f"{stages['host.finalize'][0]:.3f} s", flush=True)
    print(f"[{tag}] {second[0]} over {first[0]}, means of the turns: "
          f"{(rates[1] + rates[2]) / (rates[0] + rates[3]):.4f}", flush=True)
    return rates


def route_turns(idx, al, opts, recs, dev):
    """The timed reads over al's index (to_device_index's, built on the
    card) and over host_route_index's, in turns, with the same options."""
    host = SEAligner(idx, opts, device=dev)
    built = host_route_index(idx, dev, opts.sa_mode, opts.sa_intv)
    host.dix, host.sampled = (built if opts.sa_mode == "sampled"
                              else (built, None))
    torch.cuda.empty_cache()
    timed_recs = recs[BATCH : BATCH * (1 + N_TIMED)]
    host.align_records(timed_recs[:BATCH])
    rate_turns(f"{opts.sa_mode} index route", ("host route", host),
               ("on card", al), timed_recs)


def mode_turns(idx, al_sampled, opts, recs, dev):
    """Full and sampled mode in turns on the timed reads."""
    al_full = SEAligner(idx, dataclasses.replace(opts, sa_mode="full"),
                        device=dev)
    timed_recs = recs[BATCH : BATCH * (1 + N_TIMED)]
    al_full.align_records(timed_recs[:BATCH])
    rate_turns("sampled", ("full", al_full), ("sampled", al_sampled),
               timed_recs)


def sampled_phase(idx, recs, truth, dev, full_bytes, se_sam, pe_reads, pe_sam):
    """Sampled SA mode on the index of the other phases: the resolver
    check, K4 in a real locate, SE LV on the same reads and one PE chunk,
    each SAM equal to full mode's; the two modes' SE rates in turns.
    Returns ({path: launch counts}, K4's times)."""
    counts, al, opts, _warm, _out = se_phase(
        "sampled", idx, recs, truth, dev, ("lv_distance", "sa_walk"), N_TIMED,
        same_as=se_sam, sa_mode="sampled", sa_intv=8)
    if al.dix.sa_cat.numel() != 2:
        raise AssertionError("sampled mode holds a full sa_cat")
    print(f"[sampled] locate tables on the device: full mode sa_cat "
          f"{full_bytes} bytes; sampled mode sel_cat + samples_cat + syms_cat "
          f"{al.sampled.table_bytes()} bytes (sa_intv = {al.sampled.intv}), "
          f"{al.sampled.table_bytes() / full_bytes:.4f} of it; rank planes "
          f"(one tensor for both families) "
          f"{al.dix.ri_c.bc.numel() * al.dix.ri_c.bc.element_size()} bytes",
          flush=True)
    resolver_check(idx, al, dev)
    k4_times = sa_walk_kernel_check(al, recs, dev)
    mode_turns(idx, al, opts, recs, dev)
    route_turns(idx, al, opts, recs, dev)
    del al
    torch.cuda.empty_cache()

    r1, r2, kw = pe_reads
    pe = PEAligner(idx, PEOptions(device_sw="auto", sa_mode="sampled", **kw),
                   device=dev)
    assert_same_sam("sampled pe", "first chunk against full mode", pe_sam,
                    pe.align_pairs(r1, r2))
    reset_counts()
    t0 = time.perf_counter()
    out = pe.align_pairs(r1, r2)
    torch.cuda.synchronize()
    pe_counts = report_run("sampled pe", len(out) // 2, "pairs",
                           time.perf_counter() - t0,
                           ("lv_distance", "sw_score", "sa_walk"))
    assert_same_sam("sampled pe", "the same chunk again", pe_sam, out)
    return {"se_sampled": counts, "pe_sampled": pe_counts}, k4_times


# ---------------------------------------------------------------- polish


def polish_phase(idx, se_sam, pe_sam, dev):
    """polish_main on the card over the SE and the PE SAM of the aligner
    phases, LV scoring through K1's byte form: output equal to the same
    call on the CPU; -s (host SSW) on SW_POLISH records.  Returns ({path:
    launch counts}, the arguments of the largest launch of the byte form)."""
    sent = []
    lv = polish_mod.lv_distance_batch

    def noting(ref, pos, active, pat, **kw):
        sent.append((ref, pos, active, pat))
        return lv(ref, pos, active, pat, **kw)

    def run(path, paired, use_sw, device):
        out = io.StringIO()
        t0 = time.perf_counter()
        polish_mod.polish_main(idx, path, paired=paired, use_sw=use_sw, out=out,
                               device=device)
        if device != "cpu":
            torch.cuda.synchronize()
        return out.getvalue(), time.perf_counter() - t0

    polish_mod.lv_distance_batch = noting
    launches, largest = {}, None
    try:
        with tempfile.TemporaryDirectory() as tmp:
            for tag, sam, paired in (("polish se", se_sam, False),
                                     ("polish pe", pe_sam, True)):
                path = os.path.join(tmp, tag.replace(" ", "_") + ".sam")
                with open(path, "w") as fh:
                    fh.write("@HD\tVN:1.0\n" + "".join(l + "\n" for l in sam))
                run(path, paired, False, dev)               # warm-up
                reset_counts()
                del sent[:]
                got, dt = run(path, paired, False, dev)
                launches[tag.replace(" ", "_")] = report_run(
                    tag, len(sam), "records", dt, ("lv_distance_bytes",))
                sizes = [tuple(a[3].shape) for a in sent]
                print(f"[{tag}] byte-form launches (hits, L): {sizes}", flush=True)
                if len(sent) != LV_BYTES.launches:
                    raise AssertionError(f"{tag}: {len(sent)} calls but "
                                         f"{LV_BYTES.launches} launches counted")
                top = max(sent, key=lambda a: a[3].shape[0])
                if largest is None or top[3].shape[0] > largest[3].shape[0]:
                    largest = top
                want, dt_cpu = run(path, paired, False, "cpu")
                n_star = sum(l.split("\t")[2] == "*" for l in got.splitlines())
                print(f"[{tag}] {len(got.splitlines())} records out, {n_star} "
                      f"unmapped; the same call on the CPU: {dt_cpu:.2f} s, "
                      f"output {'equal' if got == want else 'DIFFERENT'}",
                      flush=True)
                if got != want or len(got.splitlines()) != len(sam):
                    raise AssertionError(f"{tag}: the card's output differs from "
                                         "the CPU's")
                if not paired:
                    short = os.path.join(tmp, "short.sam")
                    with open(short, "w") as fh:
                        fh.write("".join(l + "\n" for l in sam[:SW_POLISH]))
                    a, dt_sw = run(short, False, True, dev)
                    b, _ = run(short, False, True, "cpu")
                    print(f"[polish se] -s (host SSW) on {SW_POLISH} records: "
                          f"{dt_sw:.2f} s, output "
                          f"{'equal' if a == b else 'DIFFERENT'}", flush=True)
                    if a != b or len(a.splitlines()) != SW_POLISH:
                        raise AssertionError("polish -s: the card's output "
                                             "differs from the CPU's")
    finally:
        polish_mod.lv_distance_batch = lv
    return launches, largest


# ---------------------------------------------------------------- sharded


def sharded_se_phase(idx, shards, bins, recs, truth, dev, se_sam, mono_bytes):
    """The sharded aligner, every shard on the one card, on the SE phase's
    reads: SAM equal to the monolithic aligner's, K1 in every timed batch,
    the two aligners in turns, the busy share of one batch, the CPU's SAM
    on a prefix.  Returns the timed run's launch counts."""
    tag = "sharded se"
    torch.cuda.reset_peak_memory_stats()
    opts = SEOptions(l_overlap=1, max_locate=500, print_nm_md=True,
                     print_xa_cigar=True, batch_size=BATCH, gap_batch=128)
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    al = ShardedSEAligner(idx, shards, opts, devices=[dev], bins=bins)
    torch.cuda.synchronize()
    sizes = [d.table_bytes() for d in al.stacked.shards]
    print(f"[{tag}] {N_SHARDS} sub-indexes to {al.devices}: "
          f"{time.perf_counter() - t0:.2f} s, "
          f"{torch.cuda.memory_allocated() - held} bytes of device memory "
          f"(tables {sizes}, {sum(sizes)} in all; the monolithic index "
          f"{mono_bytes}); base offsets {al.stacked.base_offsets.tolist()}",
          flush=True)
    per_batch, complete = [], al._complete_batch

    def counting(handle):
        before = LV.launches
        done = complete(handle)
        per_batch.append(LV.launches - before)
        return done

    al._complete_batch = counting
    t0 = time.perf_counter()
    warm = al.align_records(recs[:BATCH])
    print(f"[{tag}] warm-up batch: {time.perf_counter() - t0:.2f} s", flush=True)
    timed_recs = recs[BATCH : BATCH * (1 + N_TIMED)]
    reset_counts()
    del per_batch[:]
    t0 = time.perf_counter()
    out = al.align_records(timed_recs)
    torch.cuda.synchronize()
    counts = report_run(tag, len(out), "reads", time.perf_counter() - t0,
                        ("lv_distance",))
    print(f"[{tag}] K1 launches a timed batch: {per_batch}; shapes "
          f"(candidates, L, k): {LV_SHAPES[tag]}", flush=True)
    if len(per_batch) != N_TIMED or min(per_batch) == 0:
        raise AssertionError(f"{tag}: a timed batch never launched K1")
    mapped, correct = accuracy(out, truth[BATCH : BATCH + len(out)])
    print(f"[{tag}] mapped {mapped:.4%}, within 5 bp of truth {correct:.4%} of "
          f"mapped; peak device memory {torch.cuda.max_memory_allocated()} "
          f"bytes", flush=True)
    assert_same_sam(tag, "warm-up batch against the monolithic aligner",
                    se_sam[0], warm)
    assert_same_sam(tag, "timed batches against the monolithic aligner",
                    se_sam[1], out)
    al._complete_batch = complete
    mono = SEAligner(idx, opts, device=dev)
    mono.align_records(timed_recs[:BATCH])
    rate_turns(tag, ("monolithic", mono), ("sharded", al), timed_recs)
    del mono
    busy_share(al, recs[BATCH : 2 * BATCH], tag)
    del al
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cpu = ShardedSEAligner(idx, shards, opts, devices=["cpu"],
                           bins=bins).align_records(recs[:CPU_CHECK])
    assert_same_sam(tag, f"CPU rerun of {CPU_CHECK} reads "
                    f"({time.perf_counter() - t0:.1f} s)", cpu, warm[:CPU_CHECK])
    return counts


def sharded_sw_phases(idx, shards, bins, recs, dev, x1_warm, pe_reads, pe_warm,
                      sent):
    """One -X 1 batch and one PE chunk on the sharded index, SAM equal to
    the monolithic phases'; K2 launched on both, in both modes on PE.
    `sent` receives the K2 shapes.  Returns {path: launch counts}."""
    done = {}
    opts = SEOptions(l_overlap=1, max_locate=500, print_nm_md=True,
                     print_xa_cigar=True, batch_size=BATCH, gap_batch=128,
                     extend_algo="sw", device_sw="auto")
    al = ShardedSEAligner(idx, shards, opts, devices=[dev], bins=bins)
    note_sw_batches(al, sent["sharded_x1"])
    reset_counts()
    t0 = time.perf_counter()
    out = al.align_records(recs[:BATCH])
    torch.cuda.synchronize()
    counts = report_run("sharded x1", len(out), "reads",
                        time.perf_counter() - t0, ("sw_score",))
    assert_same_sam("sharded x1", "one batch against the monolithic -X 1 "
                    "aligner", x1_warm, out)
    done["sharded_x1"] = counts
    del al
    torch.cuda.empty_cache()

    r1, r2, kw = pe_reads
    pe = ShardedPEAligner(idx, shards, PEOptions(device_sw="auto", **kw),
                          devices=[dev], bins=bins)
    note_sw_batches(pe._se, sent["sharded_pe"])
    assert_same_sam("sharded pe", "first chunk against the monolithic PE "
                    "aligner", pe_warm, pe.align_pairs(r1, r2))
    reset_counts()
    del sent["sharded_pe"][:]
    t0 = time.perf_counter()
    out = pe.align_pairs(r1, r2)
    torch.cuda.synchronize()
    counts = report_run("sharded pe", len(out) // 2, "pairs",
                        time.perf_counter() - t0, ("lv_distance", "sw_score"))
    assert_same_sam("sharded pe", "the same chunk again", pe_warm, out)
    if {c[0] for c in sent["sharded_pe"]} != {True, False}:
        raise AssertionError("sharded pe: SW kernel did not run in both modes")
    done["sharded_pe"] = counts
    return done


def sharded_step_phase(idx, shards, bins, bounds, recs, dev):
    """The ungapped sharded step as its callers write it, with the default
    devices (every visible card): the tables land on the card, and the
    merged primaries and hit lists equal the monolithic ungapped step's."""
    codes = encode_reads([r.seq for r in recs[:MESH_READS]])
    fwd, rev = torch.from_numpy(codes), torch.from_numpy(revcomp(codes))
    kw = dict(l_overlap=1, max_seed=50, max_locate=500, cap=640, u=64,
              k_hits=8)
    stacked = stack_indexes(shards, bins, contig_lengths=np.diff(bounds))
    if {d.type for d in stacked.devices} != {"cuda"}:
        raise AssertionError(f"sharded step: tables on {stacked.devices}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    found, pos, strand, n_diff, shard, hpos, hnd, _n, trunc = sharded_se_step(
        stacked, fwd, rev, return_hits=True, **kw)
    dt = time.perf_counter() - t0
    want = se_mod.se_ungapped(to_device_index(idx, dev), fwd.to(dev),
                              rev.to(dev), **kw).res
    merged = merge_sharded_hits(hpos, hnd, NOGAP_MAX_DIFF, kw["k_hits"])
    w_found = want.found.cpu().numpy()
    bad = [name for name, got, keep in (
        ("found", found, slice(None)), ("pos", pos, slice(None)),
        ("n_diff", n_diff, slice(None)), ("strand", strand, w_found),
        ("merged found", merged["found"], slice(None)),
        ("hits_pos", merged["hits_pos"], slice(None)),
        ("hits_ndiff", merged["hits_ndiff"], slice(None)),
        ("n_hits", merged["n_hits"], slice(None)))
        if not np.array_equal(
            np.asarray(got).astype(np.int64)[keep],
            getattr(want, name.split()[-1]).cpu().numpy()[keep])]
    print(f"[sharded step] sharded_se_step on default devices "
          f"{sorted(set(map(str, stacked.devices)))}: {MESH_READS} reads in "
          f"{dt * 1e3:.1f} ms, found {int(found.sum())}, winners a shard "
          f"{np.bincount(shard[found], minlength=N_SHARDS).tolist()}, "
          f"truncated lists {int(trunc.sum())}; differ from the monolithic "
          f"ungapped step: {bad or 'nothing'}", flush=True)
    if bad or trunc.any() or not found.any():
        raise AssertionError(f"sharded step: {bad} differ from monolithic")


def check_lv_shapes(dev):
    """K1 against its plain version at every (candidates, L, k) a sharded
    path's timed run sent it that no monolithic path's had, and at the
    largest the sharded paths sent."""
    by_path = {tag: shapes for tag, shapes in LV_SHAPES.items() if shapes}
    mono = {sh for path, shapes in by_path.items()
            if not path.startswith("sharded") for sh in shapes}
    sharded = {sh for path, shapes in by_path.items()
               if path.startswith("sharded") for sh in shapes}
    rng = np.random.default_rng(SEED + 7)
    n_ref = 2_000_000
    words = torch.from_numpy(pack_nibbles(one_hot_reference(rng, n_ref))
                             .view(np.int32)).to(dev)
    todo = sorted((sharded - mono) | {max(sharded)})
    for N, L, k in todo:
        pos = torch.from_numpy(rng.integers(0, n_ref - L - 80, N)).to(dev)
        check_kernel_case(words, pos, k, L, rng, dev)
    print(f"[kernel] lv shapes (candidates, L, k) by path: {by_path}; sent by "
          f"the sharded paths only: {sorted(sharded - mono)}; held against "
          f"the plain version: {todo}: equal", flush=True)


def mesh_phase(dix, recs, dev):
    """The data-parallel step over make_mesh() (the one card) and over the
    card named twice, each equal to the unsplit step.  Returns the launch
    counts of the run over two entries."""
    codes = encode_reads([r.seq for r in recs[:MESH_READS]])
    fwd = torch.from_numpy(codes).to(dev)
    rev = torch.from_numpy(revcomp(codes)).to(dev)
    kw = dict(l_overlap=1, max_seed=50, max_locate=500, cap=640, u=64,
              k_hits=8)
    want_u = se_mod.se_ungapped(dix, fwd, rev, **kw)
    want_g = se_mod.se_gapped(dix, fwd, rev, want_u.loci0, want_u.loci1, k=10,
                              u=64, k_hits=8)

    def flat(tree):
        if isinstance(tree, torch.Tensor):
            return [tree]
        return [t for field in tree for t in flat(field)]

    want = flat(want_u) + flat(want_g)
    counts = {}
    for name, mesh in (("make_mesh()", make_mesh()), ("the card twice",
                                                      [dev, dev])):
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got_u, got_g = sharded_full_step(mesh, dix, fwd, rev, gap_k=10, **kw)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        got = flat(got_u) + flat(got_g)
        n_bad = sum(not torch.equal(g, w) for g, w in zip(got, want))
        counts = {n: kern.launches for n, kern in KERNELS.items()}
        print(f"[mesh] sharded_full_step over {name} = {mesh}: "
              f"{MESH_READS} reads in {dt * 1e3:.1f} ms, {n_bad} of {len(want)} "
              f"result tensors differ from the unsplit step; K1 launches "
              f"{counts['lv_distance']}, found ungapped "
              f"{int(got_u.res.found.sum())}, gapped {int(got_g.res.found.sum())}",
              flush=True)
        if n_bad or len(got) != len(want) or counts["lv_distance"] != len(mesh):
            raise AssertionError(f"mesh: the step over {name} differs")
    return counts


# ---------------------------------------------------------------- command line


def cli_phase():
    """idx --shards, aln, aln --shards, aln --part-dir twice and --merge,
    and SALT_TPU_TRACE through the command line (default device: the
    card) on a small genome in a temporary directory.  Returns the launch
    counts of `aln --shards`."""
    rng = np.random.default_rng(SEED + 6)
    lut = np.frombuffer(b"ACGT", dtype=np.uint8)
    contig_data, _blocks, bounds, hap, codes, pos, alt = make_genome(
        CLI_GENOME_LEN, SNP_EVERY, rng)
    recs, _truth = simulate_reads(hap, bounds, CLI_READS, READ_LEN, rng)

    def run(argv, **env):
        """The SAM records `argv` prints, with `env` set meanwhile."""
        out = io.StringIO()
        os.environ.update(env)
        try:
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                rc = cli.main(argv)
            torch.cuda.synchronize()
            run.dt = time.perf_counter() - t0
        finally:
            for k in env:
                del os.environ[k]
        if rc != 0:
            raise AssertionError(f"cli {argv} returned {rc}")
        print(f"[cli] {' '.join(argv[:2] + argv[9:-2])}: {run.dt:.2f} s",
              flush=True)
        return [l for l in out.getvalue().splitlines() if not l.startswith("@")]

    with tempfile.TemporaryDirectory() as tmp:
        fa, snps, fq, prefix, parts, traces = (
            os.path.join(tmp, n) for n in ("ref.fa", "snps.txt", "reads.fq",
                                           "idx", "parts", "traces"))
        with open(fa, "wb") as fh:
            for name, anno, seq in contig_data:
                fh.write(f">{name} {anno}\n".encode() + seq.tobytes() + b"\n")
        with open(snps, "w") as fh:
            c = np.searchsorted(bounds, pos, side="right") - 1
            for p, ci, ref, a in zip(pos.tolist(), c.tolist(),
                                     codes[pos].tolist(), alt.tolist()):
                fh.write(f"chr{ci + 1}\t{p - bounds[ci] + 1}\t"
                         f"{'/'.join(sorted('ACGT'[x] for x in (ref, a)))}\t"
                         f"{'ACGT'[ref]}\n")
        with open(fq, "w") as fh:
            for r in recs:
                fh.write(f"@{r.name}\n{r.seq}\n+\n{r.qual}\n")
        aln = ["aln", "-d", "-c", "-r", "1", "-m", "500", "--batch-size", "2048"]
        run(["idx", "-k", "19", "--shards", str(N_SHARDS), fa, snps, prefix])
        plain = run(aln + [prefix, fq])
        if len(plain) != CLI_READS or sum(l.split("\t")[2] != "*"
                                          for l in plain) < 0.9 * CLI_READS:
            raise AssertionError("cli: aln mapped too few reads")
        reset_counts()
        sharded = run(aln + ["--shards", str(N_SHARDS), prefix, fq])
        counts = report_run("cli", len(sharded), "reads (aln --shards, index "
                            "load included)", run.dt, ("lv_distance",))
        assert_same_sam("cli", f"aln --shards {N_SHARDS} against aln", plain,
                        sharded)
        for pid in (0, 1):
            run(aln + ["--part-dir", parts, "--shard-batch", "1024", prefix, fq],
                SALT_TPU_NUM_PROCESSES="2", SALT_TPU_PROCESS_ID=str(pid))
            want = [f"part_{i:08d}.sam" for i in range(4) if i % 2 <= pid]
            if sorted(os.listdir(parts)) != sorted(want):
                raise AssertionError(f"cli: parts {os.listdir(parts)} after "
                                     f"process {pid}")
        assert_same_sam("cli", "--part-dir as processes 0 and 1 of 2, --merge, "
                        "against aln", plain,
                        run(aln + ["--part-dir", parts, "--merge", prefix, fq]))
        traced = run(aln + [prefix, fq], SALT_TPU_TRACE=traces)
        assert_same_sam("cli", "aln under SALT_TPU_TRACE against aln", plain,
                        traced)
        files = sorted(os.listdir(os.path.join(traces, "align_records")))
        n_kernel, spans = 0, set()
        for name in files:
            with open(os.path.join(traces, "align_records", name)) as fh:
                events = json.load(fh)["traceEvents"]
            n_kernel += sum(e.get("cat") == "kernel" for e in events)
            spans |= {e["name"] for e in events if e.get("cat") == "cpu_op"}
        print(f"[cli] SALT_TPU_TRACE: {len(files)} Chrome trace (one a "
              f"call), {n_kernel} CUDA kernel events, spans "
              f"{', '.join(sorted(spans))}", flush=True)
        if len(files) != 1 or n_kernel == 0 or "device.seed" not in spans:
            raise AssertionError("cli: the trace holds no CUDA kernel event "
                                 "or no span of the port")
    return counts


# ---------------------------------------------------------------- main


def build_all():
    """Builds the four kernel sources and the native host library side by
    side (one compiler process each) and prints what ptxas reports; K1's byte
    form is an entry point of lv.cu's library."""
    t0 = time.perf_counter()

    def one(name, build):
        t = time.perf_counter()
        build()
        return name, time.perf_counter() - t

    jobs = [("lv.cu", LV.build), ("sw.cu", SW.build), ("seed.cu", K3.build),
            ("sa_walk.cu", K4.build), ("host library (g++)", load_native)]
    with ThreadPoolExecutor(len(jobs)) as pool:
        for name, dt in pool.map(lambda j: one(*j), jobs):
            print(f"[build] {name}: {dt:.2f} s", flush=True)
    print(f"[build] all five side by side: {time.perf_counter() - t0:.2f} s",
          flush=True)
    LV_BYTES.build()
    for kern in (LV, SW, K3, K4):
        report_ptxas(kern)


def report_ptxas(kern):
    """Prints what `-Xptxas -v` said of every instantiation of a kernel
    (registers, stack frame, spills), one line each, and how often the
    library's machine code uses Hopper's DPX instructions (where the
    toolkit has cuobjdump).  A rebuilt library only: a library that was up
    to date has no log."""
    name, frame = "?", []
    n = worst = 0
    for line in kern.build_log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            base = re.search(r"\d+((?:sw|lv|seed|sa)_\w+?_kernel)",
                             m.group(1))
            args = re.findall(r"L[bi](\d+)E", m.group(1))
            name = f"{base.group(1) if base else m.group(1)}<{', '.join(args)}>"
        elif "bytes stack frame" in line:
            frame = re.findall(r"(\d+) bytes", line)
            worst += sum(int(x) for x in frame)
        elif "registers" in line:
            used = re.search(r"Used (\d+) registers", line)
            n += 1
            print(f"[build] {name}: {used.group(1) if used else '?'} registers, "
                  f"{'/'.join(frame)} bytes stack/spill stores/spill loads",
                  flush=True)
    print(f"[build] {kern.source.name}: {n} instantiations, {worst} bytes of "
          f"stack frame and spills in all", flush=True)
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if os.path.exists(tool):
        sass = subprocess.run([tool, "-sass", str(kern.library)],
                              capture_output=True, text=True, timeout=300).stdout
        counts = {op: len(re.findall(rf"\b{op}\b", sass))
                  for op in ("VIADDMNMX", "VIMNMX3", "VIMNMX", "SHFL", "LDS",
                             "LDL", "STL")}
        print(f"[build] {kern.source.name}: instructions in the machine code: "
              f"{counts}", flush=True)


SHAPE_KEYS = ("path", "batches_sent", "shape", "ms", "plain_ms", "bound_ms",
              "bound_ms_12ops", "bound_by", "device_ms", "plain_device_ms",
              "profiler_ms", "earlier_ms", "setup_device_ms", "idle_device_ms",
              "lanes", "old_new_new_old_ms", "old_new_new_old_device_ms")


def kernel_record(name, kern, replaces, launches, max_err, t, others=()):
    """One kernel's entry of the `kernels` line.  `earlier_ms` is the
    device time, in this run, of K2's design before the wavefront (the
    one-thread-per-pair kernel) at the same shape; `lanes` the K2
    instantiation that ran; the entries with `path` are K2 at the batches
    that path sent in its timed run."""
    rec = {"name": name, "route": "cuda",
           "source": f"salt_tpu_torch/csrc/{kern.source.name}",
           "replaces": replaces, "launches": sum(launches.values()),
           "launches_by_path": launches, "max_abs_err": max_err,
           "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
           "bound_by": t["bound_by"], "library_ms": None}
    rec.update({k: t[k] for k in SHAPE_KEYS if k in t and k not in rec})
    if others:
        rec["other_shapes"] = [{k: o[k] for k in SHAPE_KEYS if k in o}
                               for o in others]
    return rec


def print_times(tag, t):
    print(f"[kernel] {tag} per call, host clock: kernel {t['ms']:.4f} ms, plain "
          f"{t['plain_ms']:.4f} ms (turns plain, kernel, kernel, plain: "
          f"{t['turns_ms']}); device time: kernel {t['device_ms']} ms (CUDA "
          f"graph; {t['profiler_ms']} ms by the profiler), plain "
          f"{t['plain_device_ms']} ms (profiler); bound {t['bound_ms']:.6f} ms by "
          f"{t['bound_by']} ({t['bytes']} bytes, {t['operations']:.0f} int32 "
          f"operations)", flush=True)
    if "setup_device_ms" in t:
        print(f"[kernel] {tag}: device time on reads that match exactly "
              f"(set-up and first run only) {t['setup_device_ms']} ms, with "
              f"every candidate inactive {t['idle_device_ms']} ms", flush=True)
    if "lanes" in t:
        print(f"[kernel] {tag}: lanes a pair chosen {t['lanes']}; turns old (one "
              f"thread a pair), new, new, old: host clock "
              f"{t['old_new_new_old_ms']} ms, device "
              f"{t['old_new_new_old_device_ms']} ms (design before: "
              f"{t['earlier_ms']} ms); bound at 12 operations a cell "
              f"{t['bound_ms_12ops']:.6f} ms", flush=True)


# ---------------------------------------------------------------- device build

ZERO_SNP_LEN = 4_600_000     # config 2's plain genome (tools/bench_configs.py)


def differing(got, want, path="index"):
    """Paths at which two indexes differ: a tensor's dtype, shape or any
    bit, or another field's value."""
    if isinstance(want, torch.Tensor):
        if (got.dtype, got.shape) != (want.dtype, want.shape):
            return [f"{path} ({got.dtype} {tuple(got.shape)} against "
                    f"{want.dtype} {tuple(want.shape)})"]
        return [] if torch.equal(got, want) else [path]
    if isinstance(want, tuple):
        return [p for i, (g, w) in enumerate(zip(got, want))
                for p in differing(g, w, f"{path}[{i}]")]
    if dataclasses.is_dataclass(want):
        return [p for f in dataclasses.fields(want)
                for p in differing(getattr(got, f.name), getattr(want, f.name),
                                   f"{path}.{f.name}")]
    return [] if got == want else [f"{path} ({got} against {want})"]


def timed_build(build):
    """(result, seconds, peak device bytes above what was resident) of
    one index build ending in a synchronize."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = build()
    torch.cuda.synchronize()
    return (out, time.perf_counter() - t0,
            torch.cuda.max_memory_allocated() - base)


def device_build_phase(idx, dev):
    """to_device_index on the card against host_route_index (the numpy
    builders on the host, then copies), full and sampled mode, on the
    chr21 index and on a zero-SNP index: every tensor bit-equal."""
    rng = np.random.default_rng(SEED + 7)
    codes = rng.integers(0, 4, ZERO_SNP_LEN, dtype=np.int64).astype(np.uint8)
    plain = build_index_from_data(
        [("chr1", "synt", np.frombuffer(b"ACGT", dtype=np.uint8)[codes])], [],
        l_seed=19)
    for name, ix in (("chr21", idx), ("zero-SNP", plain)):
        for mode in ("full", "sampled"):
            got, t_dev, peak_dev = timed_build(
                lambda: to_device_index(ix, dev, mode))
            want, t_host, peak_host = timed_build(
                lambda: host_route_index(ix, dev, mode))
            bad = differing(got, want)
            dix = got[0] if mode == "sampled" else got
            n_bytes = dix.table_bytes() + (got[1].table_bytes()
                                           if mode == "sampled" else 0)
            print(f"[device build] {name} ({ix.l_pac} bases, T = "
                  f"{ix.r_text_len}), {mode}: {n_bytes} bytes on the card; "
                  f"built on the card {t_dev:.3f} s, peak {peak_dev} bytes; "
                  f"host route {t_host:.3f} s, peak {peak_host} bytes; "
                  f"{len(bad)} fields differ", flush=True)
            if bad:
                raise AssertionError(f"device build, {name} {mode}: {bad[:5]}")
            if name == "zero-SNP" and mode == "sampled" and (
                    got[1].samples_cat.shape[0] != got[1].c_n_samples + 1):
                raise AssertionError("zero-SNP sampled tables lack the dummy")
            del got, want, dix
    torch.cuda.empty_cache()


# ---------------------------------------------------------------- K3 phase

SEED_VARIANTS = ("r_lkt", "lf_only", "seed_only_ref")
SEED_OPTS = ((1, 50), (1, 2), (21, 50), (21, 2))   # (l_overlap, max_seed)
SEED_ROWS = 8192        # one 4,096-read batch of the benchmark, both strands
REPEAT_LEN = 4_000_000  # the repeat-rich genome of the K3 check
SEED_FIELDS = ("sp", "ep", "offset", "valid")


def repeat_index(rng):
    """A repeat-rich genome (sim/genome_gen.py, 1% N runs) with a SNP
    every SNP_EVERY bases, indexed at l_seed = 21 as the benchmark's
    chr21 is, and SEED_ROWS // 2 reads' codes drawn from it uniformly
    (about half of them in repeats)."""
    ((name, codes),) = synthesize_genome(REPEAT_LEN, 1,
                                         seed=int(rng.integers(1 << 30)))
    gpos, _alt, stype = sample_snps(codes, SNP_EVERY, rng)
    lut = np.frombuffer(b"ACGTN", dtype=np.uint8)
    t0 = time.perf_counter()
    idx = build_index_from_data(
        [(name, "repeat", lut[codes])],
        [SnpBlock(name, gpos.astype(np.uint32), stype)], l_seed=21)
    print(f"[seed] repeat-rich genome of {REPEAT_LEN} bases, {len(gpos)} SNPs: "
          f"host build {time.perf_counter() - t0:.1f} s", flush=True)
    starts = rng.integers(0, REPEAT_LEN - READ_LEN, SEED_ROWS // 2)
    return idx, codes[starts[:, None] + np.arange(READ_LEN)]


def seed_rows(fwd, rng):
    """Both strands of reads (uint8 codes) stacked as the ungapped step
    stacks them, int64, with N at 0.2% of the bases and three N inside
    the 12-mer tails of every 97th row's first seeds."""
    codes = np.concatenate([fwd, revcomp(fwd)])
    codes[rng.random(codes.shape) < 0.002] = 4
    codes[::97, 12:15] = 4
    return torch.from_numpy(codes.astype(np.int64))


def seed_calls(dix, seq, variant, l_overlap, max_seed):
    """(kernel, plain version) of one seeding call."""
    kw = {"seed_only_ref": variant == "seed_only_ref"}
    if variant == "r_lkt":
        kw.update(r_lkt_sp=dix.r_lkt_sp, r_lkt_ep=dix.r_lkt_ep)
    args = (dix.ri_c, dix.ri_r, dix.lkt, seq, dix.l_seed, l_overlap, max_seed)
    return (lambda: seed_overlap_cuda(*args, **kw),
            lambda: seed_overlap_plain(*args, **kw))


def check_seed_case(tag, dix, seq, variant, l_overlap, max_seed):
    kern, plain = seed_calls(dix, seq, variant, l_overlap, max_seed)
    got, want = kern(), plain()
    torch.cuda.synchronize()
    for fam, g, w in zip("CR", got, want):
        for name, a in zip(SEED_FIELDS, g):
            b = getattr(w, name)
            if a.dtype != b.dtype or a.shape != b.shape or not torch.equal(a, b):
                bad = torch.nonzero(a != b)[:3].tolist()
                raise AssertionError(
                    f"K3 != plain: {tag} {variant} l_overlap={l_overlap} "
                    f"max_seed={max_seed} {fam}.{name} ({a.dtype} {tuple(a.shape)}"
                    f" vs {b.dtype} {tuple(b.shape)}) at {bad}: kernel "
                    f"{[a[tuple(i)].item() for i in bad]}, plain "
                    f"{[b[tuple(i)].item() for i in bad]}")
    c, r = want
    p = torch.arange(c.offset.shape[1], device=seq.device) * l_overlap
    ext = [int(((f.offset < p) & f.valid).sum()) for f in want]
    print(f"[seed] {tag} {variant:13s} l_overlap={l_overlap:2d} "
          f"max_seed={max_seed:2d} ({seq.shape[0]} x {c.offset.shape[1]}): equal; "
          f"valid C {c.valid.float().mean().item():.4f}, R "
          f"{r.valid.float().mean().item():.4f}; extended {ext[0]} C and "
          f"{ext[1]} R seeds by {int(extension_rounds(want, p))} bases",
          flush=True)
    return want


def extension_rounds(want, p):
    """Bases the extension added over both families' valid seeds."""
    return sum(((p - f.offset) * f.valid).sum() for f in want)


def seed_kernel_phase(dev, idx, recs, rng):
    """K3 against seed_overlap_plain on the card, bit for bit: on the
    slice index (l_seed 19, no repeats) and on a repeat-rich one (l_seed
    21), reads with N, every variant at l_overlap 1 and 21 and max_seed
    50 and 2.  Times K3 and the plain version at 8,192 rows x 4 and x 80
    starts on the repeat-rich index.  Returns {starts: times}."""
    rep_idx, rep_reads = repeat_index(rng)
    slice_fwd = encode_reads([r.seq for r in recs[: SEED_ROWS // 2]])
    times = {}
    for tag, ix, fwd in (("slice", idx, slice_fwd),
                         ("repeat", rep_idx, rep_reads)):
        dix = to_device_index(ix, dev)
        seq = seed_rows(fwd, rng).to(dev)
        for variant in SEED_VARIANTS:
            for l_overlap, max_seed in SEED_OPTS:
                want = check_seed_case(tag, dix, seq, variant, l_overlap,
                                       max_seed)
                if tag == "repeat" and variant == "r_lkt" and max_seed == 50:
                    S = want[0].sp.shape[1]
                    times[S] = time_seed(dix, seq, l_overlap, want)
        del dix, seq
        torch.cuda.empty_cache()
    ops_per_s = int32_ops_per_s()
    for t in times.values():
        t.update(bound(t["bytes"], t["operations"], ops_per_s))
    return times


def time_seed(dix, seq, l_overlap, want):
    """K3 and its plain version in turns, as the aligner calls them (R jump
    tables, max_seed 50).  Bytes, at most what these inputs need: the
    codes, the outputs, 16 bytes a seed for the four 12-mer table words,
    and two 8-byte rank rows for each extension round and each LF step of
    a family (as if no lane died); operations at about 30 a row."""
    kern, plain = seed_calls(dix, seq, "r_lkt", l_overlap, 50)
    B, S = want[0].sp.shape
    rounds = int(extension_rounds(
        want, torch.arange(S, device=seq.device) * l_overlap))
    n_lf = dix.l_seed - 12
    rows = 2 * (rounds + 2 * n_lf * B * S) + 2 * B * S
    t = time_turns(kern, plain, kern_reps=50, plain_reps=3)
    t.update(shape={"rows": B, "L": seq.shape[1], "starts": S,
                    "l_overlap": l_overlap, "max_seed": 50,
                    "extension_rounds": rounds},
             bytes=seq.numel() * 8 + B * S * 50 + rows * 8,
             operations=30 * rows)
    return t


# ---------------------------------------------------------------- accuracy and profile

ROOT = os.path.dirname(os.path.abspath(__file__))
ACC_GENOME_LEN = 45_000_000
# protocol A: the reference's run_test.sh protocol (error-free reads, the
# simulated substitutions as known SNPs) at chr21 scale, gate max_err = 0
PROTOCOL_A = ["20000", "--genome-synth", str(ACC_GENOME_LEN),
              "--genome-config", "uniform"]
# protocol B: README's config 3b, repeat-rich, 1% errors, 10% indels;
# report-only, as in salt_tpu
PROTOCOL_B = ["5000", "--genome-synth", str(ACC_GENOME_LEN),
              "--genome-config", "repeat", "--err-rate", "0.01",
              "--indel-frac", "0.1"]
ACC_CPU_CHECK = 512     # protocol B's reads and pairs aligned on the CPU too
ACC_MAPPED_FLOOR = 0.9  # protocol A: the share of reads (ends) mapped
PROFILE_BATCH = 8192


def prepare_protocol(argv, prefix):
    """Simulate and build one protocol's index and save it at `prefix`
    (run in a child process by Protocols)."""
    t0 = time.perf_counter()
    args = run_accuracy.parse_args(argv)
    idx = run_accuracy.build(args, run_accuracy.simulate(args))
    save_index(idx, prefix, compress=False)
    print(f"[harness] saved; {time.perf_counter() - t0:.1f} s in all",
          flush=True)


class Protocols:
    """Index builds ({tag: argv}), each in a process of its own that runs
    chip_smoke.<prepare>(argv, prefix), started together at the beginning
    of the run so that they go on beside the earlier phases (host work:
    numpy and the native SA-IS).  By default the accuracy protocols'
    simulation and build (argv: run_accuracy's); `label` tags the lines.
    stop() ends them and removes their directory; it also runs at exit."""

    def __init__(self, argvs, prepare="prepare_protocol", label="accuracy"):
        self.label = label
        self.workdir = tempfile.mkdtemp(prefix="salt_accuracy_")
        self.t0 = time.perf_counter()
        self.procs = {}
        atexit.register(self.stop)
        for tag, argv in argvs.items():
            argv = argv + ["--workdir", self.workdir]
            log = open(os.path.join(self.workdir, f"{tag}.log"), "w")
            code = (f"import chip_smoke; chip_smoke.{prepare}("
                    f"{argv!r}, {self.prefix(tag)!r})")
            self.procs[tag] = (argv, log, subprocess.Popen(
                [sys.executable, "-c", code], cwd=ROOT, stdout=log,
                stderr=subprocess.STDOUT))

    def prefix(self, tag):
        return os.path.join(self.workdir, f"idx_{tag}")

    def wait(self, tag):
        """Wait for `tag`'s process and print what it printed; raises if
        it failed."""
        argv, log, proc = self.procs[tag]
        t0 = time.perf_counter()
        rc = proc.wait()
        log.close()
        text = open(log.name).read().strip()
        print(f"[{self.label} {tag}] {' '.join(argv[:-2])}: waited "
              f"{time.perf_counter() - t0:.1f} s for its process "
              f"(started {t0 - self.t0:.1f} s before), which printed:\n"
              f"{text}", flush=True)
        if rc:
            raise AssertionError(f"{tag}: simulation or build failed with "
                                 f"exit code {rc}")
        return argv

    def get(self, tag):
        """(products, index) of protocol `tag` once its process has ended;
        raises if it failed."""
        argv = self.wait(tag)
        prod = run_accuracy.simulate(run_accuracy.parse_args(argv))
        t0 = time.perf_counter()
        idx = load_index(self.prefix(tag))
        print(f"[accuracy {tag}] index loaded in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        return prod, idx

    def stop(self):
        for _argv, log, proc in self.procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
        shutil.rmtree(self.workdir, ignore_errors=True)


def counted(align, *args):
    """One step (of run_accuracy, of tools/bench.py) with every launch
    count set to 0 just before it; returns (its result, {kernel:
    launches})."""
    reset_counts()
    run = align(*args)
    torch.cuda.synchronize()
    return run, {name: kern.launches for name, kern in KERNELS.items()}


def accuracy_phase(dev, protocols):
    """Protocol A on the card (SE and PE, gate max_err = 0: raises on any
    wrong read), A's SE in sampled mode (SAM equal to full mode's), and
    protocol B (SE and PE, report-only; K1 must launch, K2's launches in
    PE rescue printed, the card's SAM equal to the CPU's on the first
    ACC_CPU_CHECK reads and pairs).  Returns ({path: launches}, A's
    index, A's R1 records)."""
    t_phase = time.perf_counter()
    by_path = {}
    prod, idx = protocols.get("A")
    recs1, recs2 = (list(read_records(prod.r1)),
                    list(read_records(prod.r2)))
    se, by_path["accuracy_a_se"] = counted(run_accuracy.align_se, idx, recs1,
                                           {}, dev)
    run_accuracy.report("accuracy A SE", se, len(recs1), "reads")
    pe, by_path["accuracy_a_pe"] = counted(run_accuracy.align_pe, idx, recs1,
                                           recs2, {}, dev)
    run_accuracy.report("accuracy A PE", pe, len(recs1), "pairs")
    for tag, run, n in (("SE", se, len(recs1)), ("PE", pe, 2 * len(recs1))):
        if run.ev.n_wrong:
            raise AssertionError(f"protocol A {tag}: {run.ev.n_wrong} wrong "
                                 "at max_err = 0")
        if run.ev.n_mapped < ACC_MAPPED_FLOOR * n:
            raise AssertionError(f"protocol A {tag}: {run.ev.n_mapped} of "
                                 f"{n} mapped")
    sampled, by_path["accuracy_a_sampled"] = counted(
        run_accuracy.align_se, idx, recs1, {"sa_mode": "sampled"}, dev)
    run_accuracy.report("accuracy A sampled SE", sampled, len(recs1), "reads")
    assert_same_sam("accuracy A", "sampled SE against full mode", se.sam,
                    sampled.sam)
    print(f"[accuracy A] PASS; {time.perf_counter() - t_phase:.1f} s",
          flush=True)

    t0 = time.perf_counter()
    prod_b, idx_b = protocols.get("B")
    b1, b2 = list(read_records(prod_b.r1)), list(read_records(prod_b.r2))
    se, by_path["accuracy_b_se"] = counted(run_accuracy.align_se, idx_b, b1,
                                           {}, dev)
    run_accuracy.report("accuracy B SE", se, len(b1), "reads")
    pe, by_path["accuracy_b_pe"] = counted(run_accuracy.align_pe, idx_b, b1,
                                           b2, {}, dev)
    run_accuracy.report("accuracy B PE", pe, len(b1), "pairs")
    k1 = se.launches["lv_distance"] + pe.launches["lv_distance"]
    print(f"[accuracy B] K1 launches {k1} (SE {se.launches['lv_distance']}, "
          f"PE {pe.launches['lv_distance']}); K2 launches in PE rescue "
          f"{pe.launches['sw_score']}", flush=True)
    if k1 == 0:
        raise AssertionError("protocol B never launched K1")
    n = ACC_CPU_CHECK
    t1 = time.perf_counter()
    cpu = run_accuracy.align_se(idx_b, b1[:n], {}, "cpu")
    assert_same_sam("accuracy B", f"CPU rerun of {n} SE reads "
                    f"({time.perf_counter() - t1:.1f} s)", cpu.sam, se.sam[:n])
    t1 = time.perf_counter()
    cpu = run_accuracy.align_pe(idx_b, b1[:n], b2[:n], {}, "cpu")
    assert_same_sam("accuracy B", f"CPU rerun of {n} pairs "
                    f"({time.perf_counter() - t1:.1f} s)", cpu.sam,
                    pe.sam[: 2 * n])
    del idx_b
    protocols.stop()
    print(f"[accuracy B] {time.perf_counter() - t0:.1f} s; accuracy phase "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return by_path, idx, recs1


def profile_phase(dev, idx, recs):
    """tools/profile_se.py at B = PROFILE_BATCH over protocol A's index and
    reads: every part printed with its device trace.  Returns the
    launches of the run."""
    t0 = time.perf_counter()
    reset_counts()
    got = profile_se.profile(idx, recs, PROFILE_BATCH, dev,
                             out=lambda line: print(line, flush=True))
    torch.cuda.synchronize()
    counts = {name: kern.launches for name, kern in KERNELS.items()}
    parts = [row["part"] for row in got["parts"]]
    if len(parts) != 6 or any(row["trace"] is None
                              or row["trace"]["kernels"] == 0
                              for row in got["parts"]):
        raise AssertionError(f"profile: parts {parts} without a device trace")
    print(f"[profile] phase {time.perf_counter() - t0:.1f} s; launches "
          f"{counts}", flush=True)
    return counts


# ---------------------------------------------------------------- bench

# the bundled test genome's size (a 97 KB multi-contig FASTA), which the
# stand-in of the bench phase takes
BENCH_GENOME_LEN = 96_000
BENCH_CONTIGS = 4
BENCH_CPU_CHECK = 512   # reads (pairs) of each bench run aligned on the CPU too


def prepare_scale(argv, prefix):
    """Build the index of tools/bench.py's scale run (argv: the genome
    length) and save it at `prefix` (run in a child process by Protocols)."""
    t0 = time.perf_counter()
    contig_data, blocks, _recs = bench.scale_fixture(int(argv[0]), BATCH)
    t1 = time.perf_counter()
    idx = build_index_from_data(contig_data, blocks, l_seed=19)
    t2 = time.perf_counter()
    save_index(idx, prefix, compress=False)
    print(f"[bench] scale fixture {t1 - t0:.1f} s, index built in "
          f"{t2 - t1:.1f} s, saved in {time.perf_counter() - t2:.1f} s",
          flush=True)


def bench_phase(dev, scale_build):
    """tools/bench.py on the card at its own sizes: SE and PE on the
    BENCH_GENOME_LEN-base stand-in, the scale run over the index that
    `scale_build` made beside the earlier phases.  Each run with every
    launch count set to 0 just before it; the card's SAM equal to the
    CPU's on the first BENCH_CPU_CHECK reads (pairs) of each, every rate
    above 0, the busy share of one scale batch.  Returns {path: launches}."""
    t_phase = time.perf_counter()
    out = lambda line: print(line, flush=True)   # noqa: E731
    by_path = {}
    with tempfile.TemporaryDirectory(prefix="salt_bench_") as tmp:
        contigs, blocks, reads = bench.make_fixture(bench.stand_in_genome(
            BENCH_GENOME_LEN, BENCH_CONTIGS, tmp))
    idx = build_index_from_data(contigs, blocks, l_seed=19)
    print(f"[bench] {BENCH_GENOME_LEN}-base stand-in in {BENCH_CONTIGS} "
          f"contigs, {sum(len(b.pos) for b in blocks)} SNPs, "
          f"{len(reads)} reads", flush=True)

    se, by_path["bench_se"] = counted(bench.run_se, idx, reads, BATCH, dev,
                                      out)
    se.aligner = None
    pe, by_path["bench_pe"] = counted(bench.run_pe, contigs, blocks, idx,
                                      BATCH, dev, out)
    pe.aligner = None
    torch.cuda.empty_cache()

    scale_build.wait("scale")
    t0 = time.perf_counter()
    scale_idx = load_index(scale_build.prefix("scale"))
    print(f"[bench] scale index loaded in {time.perf_counter() - t0:.1f} s",
          flush=True)
    scale, by_path["bench_scale"] = counted(
        bench.run_scale, bench.SCALE_GENOME_LEN, BATCH, dev, out, scale_idx)
    busy_share(scale.aligner, scale.records[BATCH : 2 * BATCH],
               tag="bench scale")
    scale.aligner = None
    torch.cuda.empty_cache()
    print(f"[bench] launches: {by_path}", flush=True)
    print("[bench] " + bench.result_line(se.rate, pe.rate, scale.rate),
          flush=True)

    n = BENCH_CPU_CHECK
    opts = bench.se_options(BATCH)
    for tag, index, recs, want in (
            ("SE", idx, se.records, se.sam),
            ("scale", scale_idx, scale.records, scale.sam)):
        t0 = time.perf_counter()
        cpu = SEAligner(index, opts, device="cpu").align_records(recs[:n])
        assert_same_sam("bench", f"{tag}: CPU rerun of {n} reads "
                        f"({time.perf_counter() - t0:.1f} s)", cpu, want[:n])
    t0 = time.perf_counter()
    recs1, recs2 = pe.records
    cpu = PEAligner(idx, bench.pe_options(BATCH),
                    device="cpu").align_pairs(recs1[:n], recs2[:n])
    assert_same_sam("bench", f"PE: CPU rerun of {n} pairs "
                    f"({time.perf_counter() - t0:.1f} s)", cpu,
                    pe.sam[: 2 * n])
    for tag, run in (("SE", se), ("PE", pe), ("scale", scale)):
        if not run.rate > 0:
            raise AssertionError(f"bench {tag}: rate {run.rate}")
    scale_build.stop()
    print(f"[bench] phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    return by_path


PAST_N = 2**31 + 2**26        # symbols of the past-2^31 phase's BWT
PAST_ZERO_SHARE = 0.985       # code 0's share: its count passes 2^31
PAST_QUERIES = 2**16          # ranks a symbol
PAST_BLOCK = 2**24            # symbols a block of the independent count


def past_2g_phase(dev, n=PAST_N, pivot=2**31):
    """rank_excl and lf_step over a rank index whose ranks and code 0's
    exclusive counts pass `pivot` (2^31), on the card and on the CPU,
    against counts made without the index."""
    rng = np.random.default_rng(SEED + 31)
    t0 = time.perf_counter()
    syms = np.zeros(n, dtype=np.uint8)
    k = int(n * (1 - PAST_ZERO_SHARE))
    syms[rng.integers(0, n, k)] = rng.integers(1, 4, k).astype(np.uint8)
    syms[int(rng.integers(0, n))] = 4                  # the in-band sentinel
    counts = [np.count_nonzero(syms == c) for c in range(4)]
    cfreq = np.concatenate([[0], np.cumsum(counts), [0]]).astype(np.int64)
    t_gen = time.perf_counter() - t0
    tracemalloc.start()
    t0 = time.perf_counter()
    ri_cpu = build_rank_index(syms, cfreq)
    t_build = time.perf_counter() - t0
    peak = tracemalloc.get_traced_memory()[1]
    tracemalloc.stop()
    ri, t_dev, peak_dev = timed_build(lambda: rank_index_on(dev, syms, cfreq))
    same = torch.equal(ri.bc, ri_cpu.bc.to(dev))
    # code 0's exclusive count at its plane's last word, read as uint32
    top = int(ri.bc[ri.n_words - 1, 0]) & 0xFFFFFFFF
    plane_bytes = ri.bc.numel() * ri.bc.element_size()
    print(f"[past 2^31] n = {n} symbols, code 0 count {counts[0]} (2^31 = "
          f"{pivot}), C-array {cfreq[:5].tolist()}; made in {t_gen:.1f} s, "
          f"build_rank_index {t_build:.1f} s at a peak of {peak} bytes of "
          f"numpy arrays (symbols {n} bytes apart); rank_index_on on the card "
          f"{t_dev:.2f} s at a peak of {peak_dev} device bytes (planes "
          f"{plane_bytes}); planes bit-equal: {same}; code 0's exclusive "
          f"count at its last word {top}", flush=True)
    if counts[0] <= pivot or top <= pivot:
        raise AssertionError("code 0's count does not pass 2^31")
    if not same:
        raise AssertionError("planes built on the card differ from "
                             "build_rank_index's")

    # independent counts: block sums up to the window, a prefix sum in it
    lo = pivot - (n - pivot) // 64            # 2^31 - 2^20
    edges = np.array([pivot - 1, pivot, pivot + 1, n, n + 1], np.int64)
    t0 = time.perf_counter()
    n_bad = n_checked = 0
    for c in range(5):
        base = sum(np.count_nonzero(syms[b0 : min(b0 + PAST_BLOCK, lo)] == c)
                   for b0 in range(0, lo, PAST_BLOCK))
        cum = np.concatenate([[0], np.cumsum(syms[lo:] == c, dtype=np.int64)])
        cum = np.append(cum, cum[-1])          # rank n + 1 counts no more
        kq = np.concatenate([rng.integers(lo, n + 2, PAST_QUERIES), edges])
        lq = np.minimum(kq + rng.integers(0, 2**20, len(kq)), n)
        want_r = base + cum[kq - lo]
        want_k = cfreq[c] + want_r + 1
        want_l = cfreq[c] + base + cum[lq + 1 - lo]
        cc = np.full(len(kq), c)
        outs = []
        for d, r in ((dev, ri), (torch.device("cpu"), ri_cpu)):
            # ranks as the seed carries them: uint32 read as wrapped int32
            kt = torch.from_numpy((kq + 2**31) % 2**32 - 2**31).to(d)
            lt = torch.from_numpy((lq + 2**31) % 2**32 - 2**31).to(d)
            ct = torch.from_numpy(cc).to(d)
            got = [rank_excl(r, kt, ct)] + list(lf_step(r, kt, lt, ct))
            outs.append([g.cpu().numpy() for g in got])
        for got in outs:
            for g, w in zip(got, (want_r, want_k, want_l)):
                n_bad += int(np.count_nonzero(g % 2**32 != w % 2**32))
        n_bad += sum(int(np.count_nonzero(a != b))
                     for a, b in zip(*outs))         # card == CPU, exactly
        n_checked += 3 * len(kq)
        if c == 0 and not (want_r >= pivot).any():
            raise AssertionError("no query of code 0 counts past 2^31")
    print(f"[past 2^31] rank_excl and lf_step at {n_checked} (rank, symbol) "
          f"results on the card and on the CPU: {n_bad} differ from the "
          f"independent counts mod 2^32 or from each other "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    if n_bad:
        raise AssertionError(f"past 2^31: {n_bad} rank results differ")
    del ri, ri_cpu, syms
    torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    dev = torch.device("cuda")
    protocols = Protocols({"A": PROTOCOL_A, "B": PROTOCOL_B})
    scale_build = Protocols({"scale": [str(bench.SCALE_GENOME_LEN)]},
                            prepare="prepare_scale", label="bench")
    print(card_line(), flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    ops_per_s = int32_ops_per_s()
    print(f"[bound] int32 peak {ops_per_s / 1e12:.3f} Top/s (SMs x "
          f"{INT32_LANES_PER_SM} lanes x max SM clock), memory "
          f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s", flush=True)
    build_all()

    lv_err, lv_times = kernel_phase(dev)
    for N, t in lv_times.items():
        print_times(f"lv N={N} L={READ_LEN} k=10", t)
    lvb_err, lvb_times = byte_kernel_phase(dev, ops_per_s)
    for N, t in lvb_times.items():
        print_times(f"lv bytes N={N} L={READ_LEN} k={POLISH_K}", t)
    sw_err, sw_times, sw_long = sw_kernel_phase(dev, ops_per_s)
    for t in sw_times.values():
        print_times(f"sw {t['shape']}", t)
    print(f"[kernel] sw {sw_long['shape']}: lanes {sw_long['lanes']}, host clock "
          f"{sw_long['ms']:.3f} ms, device {sw_long['device_ms']} ms; bound "
          f"{sw_long['bound_ms']:.6f} ms by {sw_long['bound_by']}", flush=True)

    rng = np.random.default_rng(SEED)
    idx, shards, bins, bounds, hap = make_index(GENOME_LEN, SNP_EVERY, rng)
    device_build_phase(idx, dev)
    recs, truth = simulate_reads(hap, bounds, BATCH * (1 + N_TIMED), READ_LEN,
                                 rng)
    seed_times = seed_kernel_phase(dev, idx, recs,
                                   np.random.default_rng(SEED + 9))
    for S, t in seed_times.items():
        print_times(f"seed {SEED_ROWS} rows x {S} starts", t)

    launches = {name: {} for name in KERNELS}
    note_lv_batches()

    def note(path, counts):
        for name, c in counts.items():
            launches[name][path] = c

    counts, al, se_opts, se_warm, se_out = se_phase(
        "se", idx, recs, truth, dev, ("lv_distance", "seed_overlap"), N_TIMED)
    note("se_lv", counts)
    busy_share(al, recs[BATCH : 2 * BATCH])
    route_turns(idx, al, se_opts, recs, dev)
    full_bytes = al.dix.sa_cat.numel() * al.dix.sa_cat.element_size()
    mono_bytes = al.dix.table_bytes()
    del al
    sent = {"se_x1": [], "pe": [], "sharded_x1": [], "sharded_pe": []}
    counts, x1_warm = x1_phase(idx, recs, truth, dev, sent["se_x1"])
    note("se_x1", counts)
    counts, pe_reads, pe_warm, pe_out = pe_phase(idx, hap, bounds, dev,
                                                 sent["pe"])
    note("pe", counts)
    torch.cuda.empty_cache()
    note("sharded_se", sharded_se_phase(idx, shards, bins, recs, truth, dev,
                                        (se_warm, se_out), mono_bytes))
    for path, counts in sharded_sw_phases(idx, shards, bins, recs, dev, x1_warm,
                                          pe_reads, pe_warm, sent).items():
        note(path, counts)
    sharded_step_phase(idx, shards, bins, bounds, recs, dev)
    del shards
    torch.cuda.empty_cache()
    check_lv_shapes(dev)
    sw_sent = time_sw_path_batches(sent, dev, ops_per_s)
    note("mesh", mesh_phase(SEAligner(idx, device=dev).dix, recs, dev))
    torch.cuda.empty_cache()
    note("cli_shards", cli_phase())
    torch.cuda.empty_cache()
    by_path, k4_times = sampled_phase(idx, recs, truth, dev, full_bytes,
                                      (se_warm, se_out), pe_reads, pe_warm)
    for path, counts in by_path.items():
        note(path, counts)
    print_times(f"sa_walk {k4_times['shape']}", k4_times)
    by_path, largest = polish_phase(idx, se_out, pe_warm + pe_out, dev)
    for path, counts in by_path.items():
        note(path, counts)
    lvb_sent = dict(time_byte_kernel(*largest, ops_per_s), path="polish",
                    batches_sent=[int(largest[3].shape[0])])
    print_times(f"lv bytes at the largest batch polish sent {lvb_sent['shape']}",
                lvb_sent)
    by_path, acc_idx, acc_recs = accuracy_phase(dev, protocols)
    for path, counts in by_path.items():
        note(path, counts)
    note("profile_se", profile_phase(dev, acc_idx, acc_recs))
    del acc_idx, acc_recs
    torch.cuda.empty_cache()
    for path, counts in bench_phase(dev, scale_build).items():
        note(path, counts)
    torch.cuda.empty_cache()
    past_2g_phase(dev)
    torch.cuda.synchronize()
    print(f"[total] {time.perf_counter() - t_start:.1f} s", flush=True)

    print(json.dumps({"kernels": [
        kernel_record("lv_distance", LV, "salt_tpu/ops/lv_pallas.py:31,96,164",
                      launches["lv_distance"], lv_err, lv_times[8192],
                      [dict(lv_times[16384],
                            shape={"N": 16384, "L": READ_LEN, "k": 10})]),
        # a second form of K1: salt_tpu computes it in XLA (ops/lv.py:30 as
        # polish/polish.py:419 jits it), not in a TPU kernel of its own
        kernel_record("lv_distance_bytes", LV_BYTES,
                      "salt_tpu/ops/lv_pallas.py:31,96,164",
                      launches["lv_distance_bytes"], lvb_err, lvb_times[4096],
                      [lvb_times[8192], lvb_sent]),
        kernel_record("sw_score", SW, "salt_tpu/ops/sw_pallas.py:38,101,278",
                      launches["sw_score"], sw_err, sw_times["x1"],
                      [sw_times["pe"], sw_long] + sw_sent),
        # salt_tpu seeds in XLA, not in a TPU kernel of its own
        kernel_record("seed_overlap", K3, "none: XLA, salt_tpu/ops/seed.py",
                      launches["seed_overlap"], 0, seed_times[4],
                      [seed_times[80]]),
        # salt_tpu walks in XLA, not in a TPU kernel of its own
        kernel_record("sa_walk", K4, "none: XLA, salt_tpu/ops/locate.py",
                      launches["sa_walk"], 0, k4_times),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
