"""The reference genome and known-SNP table of a configuration, made from
the configuration's own seed.

The "repeat" recipe composes the repeat classes of a mammalian
chromosome (dispersed SINE- and LINE-like families, satellite arrays,
microsatellites, segmental duplications, assembly-gap N runs); the
"uniform" recipe is i.i.d. bases, as a bacterial genome with few
repeats.  Both follow the synthetic genomes the port's own tools use,
kept here so that the yardstick does not move with the program.

Known SNPs (the configuration's `snps` of them) sit on non-N positions,
each with one alternate allele.  The genome and the SNP table are cached as one raw
.npz keyed by the configuration file's bytes: both the program's index
build and the reference read them.

A configuration's genome is one contig (`genome.contig_name`, of
`genome_bases` bases, from `genome.seed`), or, where `genome.contigs`
lists them as {"name", "bases", "seed"} in FASTA order, several: each
made by the recipe from its own seed, laid end to end with no separator
as salt's pac lays them out (bntseq offsets), with the SNPs split over
them in proportion to their bases (at least one each: the index pairs
the i-th SNP block with the i-th contig) and drawn from (snp_seed, i).
"""

from __future__ import annotations

import hashlib
import os
from pathlib import Path

import numpy as np

_LUT = np.frombuffer(b"ACGTN", dtype=np.uint8)


def _diverge(unit, rate, rng):
    out = unit.copy()
    m = rng.random(len(out)) < rate
    n = int(m.sum())
    if n:
        out[m] = (out[m] + rng.integers(1, 4, n)) % 4
    return out


def synthesize_contig(length: int, rng, recipe: str,
                      longest: int = None) -> np.ndarray:
    """One contig of `length` bases as uint8 codes (0-3, 4 = N).
    `longest` caps a satellite array and an N run, each drawn as before
    and then cut, so that a contig far shorter than a chromosome (chrM)
    is not one array or one gap."""
    codes = rng.integers(0, 4, length, dtype=np.int64).astype(np.uint8)
    if recipe == "uniform":
        return codes
    if recipe != "repeat":
        raise ValueError(f"unknown genome recipe {recipe!r}")

    def place_family(unit_len, frac, div_lo, div_hi, trunc_lo):
        unit = rng.integers(0, 4, unit_len, dtype=np.int64).astype(np.uint8)
        budget = int(length * frac)
        placed = 0
        while placed < budget:
            ul = int(rng.integers(max(int(unit_len * trunc_lo), 30),
                                  unit_len + 1))
            start = int(rng.integers(0, length - ul))
            codes[start:start + ul] = _diverge(unit[unit_len - ul:],
                                               rng.uniform(div_lo, div_hi), rng)
            placed += ul

    place_family(300, 0.10, 0.05, 0.15, 0.17)    # SINE-like
    place_family(6000, 0.15, 0.05, 0.20, 0.08)   # LINE-like, mostly truncated

    unit = rng.integers(0, 4, 171, dtype=np.int64).astype(np.uint8)
    placed = 0
    while placed < int(length * 0.03):           # satellite arrays
        n_units = int(rng.integers(20, 2000))
        arr = np.concatenate([_diverge(unit, rng.uniform(0.01, 0.05), rng)
                              for _ in range(min(n_units, 64))])
        if n_units > 64:
            arr = np.tile(arr, (n_units + 63) // 64)[: n_units * 171]
        if longest is not None:
            arr = arr[:longest]
        start = int(rng.integers(0, max(length - len(arr), 1)))
        end = min(start + len(arr), length)
        codes[start:end] = arr[: end - start]
        placed += end - start

    placed = 0
    while placed < int(length * 0.005):          # microsatellites
        u = rng.integers(0, 4, int(rng.integers(2, 7)),
                         dtype=np.int64).astype(np.uint8)
        arr = np.tile(u, int(rng.integers(10, 100)))
        start = int(rng.integers(0, max(length - len(arr), 1)))
        end = min(start + len(arr), length)
        codes[start:end] = arr[: end - start]
        placed += end - start

    sd_lo = min(20_000, max(length // 8, 100))   # segmental duplications
    sd_hi = max(min(100_000, length // 4), sd_lo + 1)
    for _ in range(max(length // 20_000_000, 2)):
        sl = int(rng.integers(sd_lo, sd_hi))
        src = int(rng.integers(0, length - sl))
        dst = int(rng.integers(0, length - sl))
        codes[dst:dst + sl] = _diverge(codes[src:src + sl],
                                       rng.uniform(0.01, 0.02), rng)

    placed = 0
    while placed < int(length * 0.01):           # N runs (assembly gaps)
        nl = int(rng.integers(1000, 50_000))
        if longest is not None:
            nl = min(nl, longest)
        start = int(rng.integers(0, max(length - nl, 1)))
        end = min(start + nl, length)
        codes[start:end] = 4
        placed += end - start
    return codes


def sample_snps(codes: np.ndarray, n_snps: int, rng):
    """`n_snps` known SNPs on non-N positions: (pos int64 sorted, alt
    uint8).  Each has the reference base and one other allele."""
    n = len(codes)
    pos = np.unique(rng.integers(0, n, int(n_snps * 1.1) + 16))
    pos = pos[codes[pos] < 4][:n_snps]
    alt = ((codes[pos].astype(np.int64) + rng.integers(1, 4, len(pos))) % 4)
    return pos.astype(np.int64), alt.astype(np.uint8)


class Genome:
    """A genome's codes (uint8, 4 = N), its known SNPs in the same
    coordinates, and its contig table: names, offsets and lengths, one
    entry for a one-contig genome.  `contigs` is [(name, length)] in
    FASTA order, summing to the codes' length; None is one contig,
    `name`."""

    def __init__(self, name, codes: np.ndarray, snp_pos: np.ndarray,
                 snp_alt: np.ndarray, contigs=None):
        self.codes = codes
        self.snp_pos = snp_pos
        self.snp_alt = snp_alt
        table = contigs or [(name, len(codes))]
        self.contig_names = [str(n) for n, _l in table]
        self.contig_lengths = np.array([int(ln) for _n, ln in table],
                                       dtype=np.int64)
        self.contig_offsets = np.concatenate(
            [[0], np.cumsum(self.contig_lengths)[:-1]]).astype(np.int64)
        if int(self.contig_lengths.sum()) != len(codes):
            raise ValueError("the contigs' lengths do not sum to the genome's")
        self.name = self.contig_names[0]

    def contig_of(self, pos: np.ndarray) -> np.ndarray:
        """The contig index of each genome position in `pos`."""
        return np.searchsorted(self.contig_offsets, pos, side="right") - 1

    def chars(self) -> np.ndarray:
        """The genome as uint8 ASCII (A, C, G, T, N)."""
        return _LUT[np.minimum(self.codes, 4)]


def config_key(cfg_bytes: bytes) -> str:
    return hashlib.sha256(cfg_bytes).hexdigest()[:16]


def split_snps(n_snps: int, lengths) -> list:
    """`n_snps` split over contigs of `lengths` in proportion to their
    bases (largest remainders first), at least one each."""
    total = sum(lengths)
    share = [n_snps * ln // total for ln in lengths]
    rest = sorted(range(len(lengths)),
                  key=lambda i: (-(n_snps * lengths[i] % total), i))
    for i in rest[:n_snps - sum(share)]:
        share[i] += 1
    for i in range(len(share)):
        if share[i] == 0:
            share[i] = 1
            share[share.index(max(share))] -= 1
    if n_snps and min(share) < 1:
        raise ValueError(f"{n_snps} SNPs cannot give {len(lengths)} "
                         "contigs one each")
    return share


def make_genome(cfg: dict) -> Genome:
    g = cfg["genome"]
    if g.get("contigs"):
        return _make_contigs(cfg)
    rng = np.random.default_rng(g["seed"])
    codes = synthesize_contig(int(cfg["genome_bases"]), rng, g["recipe"])
    n_snps = int(cfg["snps"])
    if n_snps:
        pos, alt = sample_snps(codes, n_snps,
                               np.random.default_rng(cfg["snp_seed"]))
    else:
        pos, alt = np.zeros(0, np.int64), np.zeros(0, np.uint8)
    return Genome(g["contig_name"], codes, pos, alt)


def _make_contigs(cfg: dict) -> Genome:
    g = cfg["genome"]
    table = [(c["name"], int(c["bases"])) for c in g["contigs"]]
    lengths = [ln for _n, ln in table]
    if sum(lengths) != int(cfg["genome_bases"]):
        raise ValueError("genome.contigs' bases do not sum to genome_bases")
    n_snps = int(cfg["snps"])
    shares = split_snps(n_snps, lengths) if n_snps else [0] * len(table)
    codes, pos, alt, off = [], [], [], 0
    for i, (c, ln) in enumerate(zip(g["contigs"], lengths)):
        one = synthesize_contig(ln, np.random.default_rng(c["seed"]),
                                g["recipe"], longest=max(ln // 8, 1))
        if shares[i]:
            p, a = sample_snps(one, shares[i],
                               np.random.default_rng([cfg["snp_seed"], i]))
            if not len(p):
                raise ValueError(f"contig {c['name']} has no SNP")
            pos.append(p + off)
            alt.append(a)
        codes.append(one)
        off += ln
    return Genome(None, np.concatenate(codes),
                  np.concatenate(pos) if pos else np.zeros(0, np.int64),
                  np.concatenate(alt) if alt else np.zeros(0, np.uint8),
                  contigs=table)


def load_genome(cfg: dict, cfg_bytes: bytes, cache_dir: Path) -> Genome:
    """The configuration's genome, from `cache_dir` when made before."""
    path = cache_dir / f"genome_{config_key(cfg_bytes)}.npz"
    if path.exists():
        z = np.load(path)
        if "contig_names" in z:
            return Genome(None, z["codes"], z["snp_pos"], z["snp_alt"],
                          contigs=list(zip(z["contig_names"].tolist(),
                                           z["contig_lengths"].tolist())))
        return Genome(str(z["name"]), z["codes"], z["snp_pos"], z["snp_alt"])
    gen = make_genome(cfg)
    cache_dir.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.stem + f".{os.getpid()}.tmp.npz")
    if cfg["genome"].get("contigs"):
        np.savez(tmp, codes=gen.codes, snp_pos=gen.snp_pos,
                 snp_alt=gen.snp_alt, contig_names=np.array(gen.contig_names),
                 contig_offsets=gen.contig_offsets,
                 contig_lengths=gen.contig_lengths)
    else:
        np.savez(tmp, name=gen.name, codes=gen.codes, snp_pos=gen.snp_pos,
                 snp_alt=gen.snp_alt)
    os.replace(tmp, path)
    return gen
