"""Shared inputs for the salt_tpu_torch parity tests (tests/test_torch_*.py).

Every fixture is synthesized in the repo from a numpy seed and handed to
both salt_tpu and its port.
"""

import io

import numpy as np
import torch

from salt_tpu.index.build import build_index_from_data
from salt_tpu.io.fasta import SeqRecord, parse_records
from salt_tpu.io.snp import SnpBlock

BASES = "ACGT"

# The tests run in several worker processes that share the cores.  With
# one intra-op thread a worker, torch's thread pools do not spin against
# each other and against jax's (the tensors here are small).
torch.set_num_threads(1)


def tiny_genome(genome_len=4096, n_snps=40, seed=5):
    """The genome, SNP overlay and index of __graft_entry__._tiny_fixture.
    Returns (idx, genome, snp_pos, stype, rng) with rng positioned where
    the fixture draws its reads."""
    rng = np.random.default_rng(seed)
    genome = "".join(BASES[c] for c in rng.integers(0, 4, genome_len))
    snp_pos = np.sort(
        rng.choice(np.arange(50, genome_len - 50), size=n_snps, replace=False)
    ).astype(np.uint32)
    stype = []
    for p in snp_pos:
        ref = BASES.index(genome[p])
        alt = (ref + int(rng.integers(1, 4))) % 4
        stype.append((1 << ref) | (1 << alt) | (ref << 4))
    block = SnpBlock("chr1", snp_pos, np.array(stype, np.uint8))
    idx = build_index_from_data([("chr1", "synthetic", genome)], [block],
                                l_seed=19)
    return idx, genome, snp_pos, stype, rng


def tiny_fixture(n_reads=64, read_len=100):
    """(idx, records): __graft_entry__._tiny_fixture's genome and reads
    (SNP alleles flipped half the time), plus a substitution-heavy and an
    indel-bearing copy of every third read so the gapped path runs."""
    idx, genome, snp_pos, stype, rng = tiny_genome()
    reads = []
    for _ in range(n_reads):
        start = int(rng.integers(0, len(genome) - read_len))
        r = list(genome[start : start + read_len])
        for j, p in enumerate(snp_pos):
            if start <= p < start + read_len and rng.random() < 0.5:
                alleles = [c for c in range(4) if (stype[j] >> c) & 1]
                r[p - start] = BASES[alleles[-1]]
        reads.append("".join(r))
    for i in range(0, n_reads, 3):
        r = list(reads[i])
        for _ in range(5):
            j = int(rng.integers(0, read_len))
            r[j] = BASES[(BASES.index(r[j]) + 1) % 4]
        reads.append("".join(r))
        r = list(reads[i])
        j = int(rng.integers(10, read_len - 10))
        del r[j : j + int(rng.integers(1, 4))]
        reads.append("".join(r + ["A"] * (read_len - len(r))))
    return idx, [SeqRecord(f"t{i}", None, s, "I" * len(s))
                 for i, s in enumerate(reads)]


def port_index(idx):
    """salt_tpu's index carried across into the port's own SaltIndex."""
    from salt_tpu_torch.index.build import index_from_arrays

    return index_from_arrays(idx)


def as_records(named_seqs):
    return [SeqRecord(name, None, s, "I" * len(s)) for name, s in named_seqs]


def revcomp_str(s):
    return s[::-1].translate(str.maketrans("ACGT", "TGCA"))


def planted_pairs(genome, rng, n_pairs=48, read_len=100):
    """(recs1, recs2): FR pairs from `genome` with inserts near 400; every
    fourth pair has one end carrying 15 substitutions (singleton rescue),
    every fifth has its ends 1,500 bp apart (pair2 rescue fails), every
    seventh carries a 2 bp deletion in the second end."""
    r1, r2 = [], []
    for i in range(n_pairs):
        ins = int(rng.integers(340, 460))
        far = i % 5 == 4
        span = 1500 + read_len if far else ins
        start = int(rng.integers(0, len(genome) - span - 8))
        a = list(genome[start : start + read_len])
        b_start = start + span - read_len
        b = list(genome[b_start : b_start + read_len + 4])
        if i % 7 == 6:
            del b[50:52]
        b = b[:read_len]
        if i % 4 == 3:
            for j in rng.choice(read_len, 15, replace=False):
                b[j] = BASES[(BASES.index(b[j]) + 1) % 4]
        a, b = "".join(a), revcomp_str("".join(b))
        if i % 2:
            a, b = b, a
        r1.append((f"p{i}/1", a))
        r2.append((f"p{i}/2", b))
    return as_records(r1), as_records(r2)


def repeat_fixture(tmp_dir, genome_len=50_000, n_reads=192, seed=3,
                   pairs=False):
    """(idx, records): a genome_gen repeat genome with ~1 SNP per 100 bp
    and wgsim reads carrying substitutions and indels.  With pairs=True,
    (idx, first-end records, second-end records)."""
    from salt_tpu.sim.genome_gen import sample_snps, synthesize_genome, write_fasta
    from salt_tpu.sim.wgsim import SimParams, simulate

    rng = np.random.default_rng(seed)
    ((name, codes),) = synthesize_genome(genome_len, 1, seed=seed)
    n = codes == 4   # keep the repeats, drop the assembly-gap runs
    codes[n] = rng.integers(0, 4, int(n.sum()))
    gpos, _alt, stype = sample_snps(codes, 100, rng)
    fa = f"{tmp_dir}/genome.fa"
    write_fasta([(name, codes)], fa)
    idx = build_index_from_data(
        [(name, "repeat", "".join(BASES[c] for c in codes))],
        [SnpBlock(name, gpos.astype(np.uint32), stype)], l_seed=19)
    r1, r2 = io.StringIO(), io.StringIO()
    simulate(fa, r1, r2, SimParams(err_rate=0.01, mut_rate=0.005,
                                   indel_frac=0.4, n_pairs=n_reads,
                                   size_l=100, size_r=100, dist=300,
                                   std_dev=30, seed=seed),
             mut_out=io.StringIO())
    r1.seek(0)
    if pairs:
        r2.seek(0)
        return idx, list(parse_records(r1)), list(parse_records(r2))
    return idx, list(parse_records(r1))


def contig_fixture(n_contigs=8, n_reads=160, read_len=100,
                   repeat_at=(1000,), gapped_repeats=False):
    """(contig_data, blocks, records) of tests/test_sharded_engine.py: 8
    contigs, a 300 bp repeat shared by every other one (XA lists that
    cross shards), 12 SNPs a contig; reads that are exact, carry two
    mismatches, a 3 bp deletion (gapped path), lie inside the repeat, or
    are random (unmapped).  More copies of the repeat a contig
    (`repeat_at`) and repeat reads with a deletion (`gapped_repeats`)
    make reads that overflow small locate and verify widths."""
    rng = np.random.default_rng(21)
    repeat = "".join(BASES[c] for c in rng.integers(0, 4, 300))
    contig_data, blocks = [], []
    for ci in range(n_contigs):
        L = 4000 + 700 * (ci % 3)
        seq = list(BASES[c] for c in rng.integers(0, 4, L))
        if ci % 2 == 0:
            for at in repeat_at:
                seq[at : at + 300] = repeat
        seq = "".join(seq)
        contig_data.append((f"chr{ci}", "syn", seq))
        pos = np.sort(
            rng.choice(np.arange(50, L - 50), 12, replace=False)
        ).astype(np.uint32)
        stype = []
        for p in pos:
            ref = BASES.index(seq[p])
            stype.append((1 << ref) | (1 << ((ref + 1) % 4)) | (ref << 4))
        blocks.append(SnpBlock(f"chr{ci}", pos, np.array(stype, np.uint8)))

    rng2 = np.random.default_rng(77)
    reads = []
    for i in range(n_reads):
        seq = contig_data[int(rng2.integers(0, n_contigs))][2]
        s = int(rng2.integers(0, len(seq) - read_len - 10))
        r = list(seq[s : s + read_len])
        kind = i % 5
        if kind == 1:
            for p in (15, 55):
                r[p] = BASES[(BASES.index(r[p]) + 1) % 4]
        elif kind == 2:
            del r[40:43]
            r += list(seq[s + read_len : s + read_len + 3])
        elif kind == 3:
            r = list(repeat[:read_len])
            if gapped_repeats and i % 10 == 8:
                r = list(repeat[:40] + repeat[43 : read_len + 3])
        elif kind == 4 and i % 10 == 4:
            r = [BASES[c] for c in rng2.integers(0, 4, read_len)]
        reads.append("".join(r))
    return contig_data, blocks, as_records(
        (f"r{i}", s) for i, s in enumerate(reads))


def contig_pairs(contig_data, n_pairs=48, read_len=100):
    """(recs1, recs2): FR pairs within one contig each, inserts 300-460,
    every fourth first end with one mismatch."""
    rng = np.random.default_rng(5)
    r1, r2 = [], []
    for i in range(n_pairs):
        seq = contig_data[int(rng.integers(0, len(contig_data)))][2]
        tl = int(rng.integers(300, 460))
        s = int(rng.integers(0, len(seq) - tl - 1))
        fwd = list(seq[s : s + read_len])
        if i % 4 == 1:
            fwd[30] = BASES[(BASES.index(fwd[30]) + 1) % 4]
        r1.append((f"p{i}", "".join(fwd)))
        r2.append((f"p{i}", revcomp_str(seq[s + tl - read_len : s + tl])))
    return as_records(r1), as_records(r2)


def port_shards(contig_data, blocks, n_shards, l_seed=19):
    """(shard indexes, bins): the port's sub-indexes over contiguous bins,
    built by salt_tpu's host build and carried across."""
    from salt_tpu_torch.parallel.sharded import partition_contigs_contiguous

    bins = partition_contigs_contiguous([len(c[2]) for c in contig_data],
                                        n_shards)
    shards = [port_index(build_index_from_data(
        [contig_data[i] for i in b], [blocks[i] for i in b if i < len(blocks)],
        l_seed=l_seed)) for b in bins]
    return shards, bins


def bin_edge_reads(contig_data, bins, max_off=16, read_len=100):
    """Records named `b{bin}_{head|tail}_{off}_{kind}`: reads that start
    `off` bases (0..max_off) after a bin's first base or end `off` bases
    before its last, exact, with two mismatches, with a 3 bp deletion or
    with a 2 bp insertion, strands alternating."""
    reads = []
    for bi, b in enumerate(bins):
        for off in range(max_off + 1):
            for ki, kind in enumerate(("exact", "mm", "del", "ins")):
                for side in ("head", "tail"):
                    seq = contig_data[b[0] if side == "head" else b[-1]][2]
                    s = off if side == "head" else len(seq) - read_len - off
                    if kind == "del":
                        s -= 3 * (side == "tail")
                        r = seq[s : s + 40] + seq[s + 43 : s + read_len + 3]
                    elif kind == "ins":
                        s += 2 * (side == "tail")
                        r = seq[s : s + 50] + "GT" + seq[s + 50 : s + read_len - 2]
                    else:
                        r = list(seq[s : s + read_len])
                        if kind == "mm":
                            for p in (15, 55):
                                r[p] = BASES[(BASES.index(r[p]) + 1) % 4]
                        r = "".join(r)
                    if (off + ki) % 2:
                        r = revcomp_str(r)
                    reads.append((f"b{bi}_{side}_{off}_{kind}", r))
    return as_records(reads)
