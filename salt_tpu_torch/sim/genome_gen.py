"""Repeat-rich synthetic genome generation.

Real mammalian references are ~50% repeats, and that is exactly what
stresses an aligner's locate caps, interval subsampling and MAPQ
calibration (the reference's rand()-subsampled wide R intervals,
Align_src/alnse.c:434-449, and the max_locate/MAX_LOC_POS caps,
alnse.c:42,678).  A uniform-random genome has essentially no repeated
k-mers above chance, so at-scale runs on it never exercise those
paths.  No network is available here, so instead of GRCh38 this module
composes the repeat classes that matter structurally:

  * dispersed SINE-like family  (~300bp unit, ~10% of the genome,
    per-copy 5-15% divergence, frequent 5' truncation)
  * dispersed LINE-like family  (~6kb unit, ~15%, mostly truncated
    copies, 5-20% divergence)
  * satellite tandem arrays     (~171bp unit, centromere-like runs of
    20-2000 units, 1-5% per-copy divergence, ~3%)
  * microsatellites             (2-6bp units, short runs, ~0.5%)
  * segmental duplications      (20-100kb chunks re-inserted elsewhere
    at 1-2% divergence)
  * N runs                      (assembly-gap style, ~1%)

All placement is vectorized numpy with per-copy slice writes; a 45MB
chr21-scale contig generates in seconds and the 3.1G whole-genome
config in a few minutes.
"""

from __future__ import annotations

import numpy as np

_LUT = np.frombuffer(b"ACGTN", dtype=np.uint8)


def _diverge(unit: np.ndarray, rate: float, rng) -> np.ndarray:
    out = unit.copy()
    m = rng.random(len(out)) < rate
    n = int(m.sum())
    if n:
        out[m] = (out[m] + rng.integers(1, 4, n)) % 4
    return out


def synthesize_contig(length: int, rng, config: str = "repeat") -> np.ndarray:
    """One contig of `length` bases as uint8 codes (0-3, 4 = N)."""
    codes = rng.integers(0, 4, length, dtype=np.int64).astype(np.uint8)
    if config == "uniform" or length < 10000:
        return codes

    def place_family(unit_len, frac, div_lo, div_hi, trunc_lo):
        unit = rng.integers(0, 4, unit_len, dtype=np.int64).astype(np.uint8)
        budget = int(length * frac)
        placed = 0
        while placed < budget:
            ul = int(rng.integers(max(int(unit_len * trunc_lo), 30),
                                  unit_len + 1))
            start = int(rng.integers(0, length - ul))
            div = rng.uniform(div_lo, div_hi)
            codes[start:start + ul] = _diverge(unit[unit_len - ul:], div, rng)
            placed += ul

    # dispersed families
    place_family(300, 0.10, 0.05, 0.15, 0.17)    # SINE-like
    place_family(6000, 0.15, 0.05, 0.20, 0.08)   # LINE-like, mostly truncated

    # satellite tandem arrays (few loci, long runs)
    unit = rng.integers(0, 4, 171, dtype=np.int64).astype(np.uint8)
    sat_budget = int(length * 0.03)
    placed = 0
    while placed < sat_budget:
        n_units = int(rng.integers(20, 2000))
        arr = np.concatenate(
            [_diverge(unit, rng.uniform(0.01, 0.05), rng)
             for _ in range(min(n_units, 64))])
        if n_units > 64:  # tile the first 64 divergent copies
            arr = np.tile(arr, (n_units + 63) // 64)[: n_units * 171]
        start = int(rng.integers(0, max(length - len(arr), 1)))
        end = min(start + len(arr), length)
        codes[start:end] = arr[: end - start]
        placed += end - start

    # microsatellites
    ms_budget = int(length * 0.005)
    placed = 0
    while placed < ms_budget:
        u = rng.integers(0, 4, int(rng.integers(2, 7)),
                         dtype=np.int64).astype(np.uint8)
        reps = int(rng.integers(10, 100))
        arr = np.tile(u, reps)
        start = int(rng.integers(0, max(length - len(arr), 1)))
        end = min(start + len(arr), length)
        codes[start:end] = arr[: end - start]
        placed += end - start

    # segmental duplications (copy assembled sequence, light divergence)
    n_segdup = max(length // 20_000_000, 2)
    sd_lo = min(20_000, max(length // 8, 100))
    sd_hi = max(min(100_000, length // 4), sd_lo + 1)
    for _ in range(n_segdup):
        sl = int(rng.integers(sd_lo, sd_hi))
        src = int(rng.integers(0, length - sl))
        dst = int(rng.integers(0, length - sl))
        codes[dst:dst + sl] = _diverge(codes[src:src + sl],
                                       rng.uniform(0.01, 0.02), rng)

    # N runs (assembly gaps)
    n_budget = int(length * 0.01)
    placed = 0
    while placed < n_budget:
        nl = int(rng.integers(1000, 50_000))
        start = int(rng.integers(0, max(length - nl, 1)))
        end = min(start + nl, length)
        codes[start:end] = 4
        placed += end - start
    return codes


def synthesize_genome(length: int, n_contigs: int = 1, seed: int = 7,
                      config: str = "repeat"):
    """[(name, uint8 codes)] for a `length`-base genome."""
    rng = np.random.default_rng(seed)
    clen = length // n_contigs
    out = []
    for ci in range(n_contigs):
        ln = length - clen * (n_contigs - 1) if ci == n_contigs - 1 else clen
        out.append((f"chr{ci + 1}", synthesize_contig(ln, rng, config)))
    return out


def sample_snps(codes: np.ndarray, every: int, rng):
    """SNP overlay for a synthetic genome: ~1 SNP per `every` bases on
    non-N positions.  Returns (gpos int64 sorted, alt uint8, stype
    uint8) with the hapmap stype encoding (1<<ref | 1<<alt | ref<<4).
    Positions are sampled directly and resampled off N runs — no
    nonzero() materialization (a ~25GB int64 array at 3.1G)."""
    n = len(codes)
    n_snp = n // every
    gpos = np.unique(rng.integers(0, n, int(n_snp * 1.1)))
    gpos = gpos[codes[gpos] < 4][:n_snp]
    ref_codes = codes[gpos].astype(np.int64)
    alt = ((ref_codes + rng.integers(1, 4, len(gpos))) % 4).astype(np.uint8)
    stype = ((1 << ref_codes) | (1 << alt)
             | (ref_codes << 4)).astype(np.uint8)
    return gpos.astype(np.int64), alt, stype


def write_fasta(contigs, path: str, width: int = 70) -> None:
    with open(path, "w") as f:
        for name, codes in contigs:
            f.write(f">{name}\n")
            chars = _LUT[np.minimum(codes, 4)].tobytes().decode("latin1")
            for i in range(0, len(chars), width):
                f.write(chars[i:i + width])
                f.write("\n")
