"""parallel/sharded.py and merged_replay of the port against salt_tpu's,
on the same numpy inputs.  Every output is an integer: tolerance 0."""

import numpy as np
import pytest
import torch

from salt_tpu.parallel import sharded as jsh
from salt_tpu_torch.parallel import sharded as tsh

from torch_fixtures import BASES, port_index

U32 = 0xFFFFFFFF


@pytest.mark.parametrize("seed", range(6))
def test_partition_contigs_matches(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 30))
    data = [(f"c{i}", "", "A" * int(rng.integers(1, 5000))) for i in range(n)]
    for n_shards in (1, 2, 3, 8):
        assert tsh.partition_contigs(data, n_shards) == \
            jsh.partition_contigs(data, n_shards)


@pytest.mark.parametrize("seed", range(6))
def test_partition_contigs_contiguous_matches(seed):
    rng = np.random.default_rng(100 + seed)
    n = int(rng.integers(1, 30))
    lengths = [int(x) for x in rng.integers(1, 10**6, n)]
    for n_shards in range(1, n + 1):
        got = tsh.partition_contigs_contiguous(lengths, n_shards)
        assert got == jsh.partition_contigs_contiguous(lengths, n_shards)
        assert len(got) == n_shards and all(got)
        assert [i for b in got for i in b] == list(range(n))


def test_partition_contiguous_must_cut_and_error():
    """One huge contig first: every later contig is needed to fill the
    remaining bins, so each is cut off on its own."""
    lengths = [10**6, 5, 5, 5]
    want = [[0], [1], [2], [3]]
    assert tsh.partition_contigs_contiguous(lengths, 4) == want
    assert jsh.partition_contigs_contiguous(lengths, 4) == want
    assert tsh.partition_contigs_contiguous([1, 1, 10**6, 1], 3) == \
        jsh.partition_contigs_contiguous([1, 1, 10**6, 1], 3)
    with pytest.raises(ValueError, match="cannot split 4 contigs into 5"):
        tsh.partition_contigs_contiguous(lengths, 5)


def _hit_lists(rng, S, B, K, high=False):
    """(hpos uint32, hnd int32) of shape (S, B, 2, K): per shard and strand
    an ascending run of global positions inside the shard's own range
    (ranges past 2^31 with `high`), sentinels behind, counts 0..4 so that
    strands tie, and some reads empty everywhere."""
    span = (U32 - 16) // S if high else 50_000
    hpos = np.full((S, B, 2, K), U32, np.uint32)
    hnd = np.full((S, B, 2, K), 255, np.int32)
    for s in range(S):
        for b in range(B):
            for st in range(2):
                n = int(rng.integers(0, K + 1))
                if b % 7 == 3:
                    n = 0
                p = np.sort(rng.choice(span, n, replace=False)) + s * span
                hpos[s, b, st, :n] = p
                hnd[s, b, st, :n] = rng.integers(0, 5, n)
    return hpos, hnd


@pytest.mark.parametrize("high", [False, True])
@pytest.mark.parametrize("S,K,k_hits", [(1, 8, 8), (4, 8, 8), (3, 16, 4)])
def test_merge_sharded_hits_matches(S, K, k_hits, high):
    rng = np.random.default_rng(S * 10 + K + high)
    hpos, hnd = _hit_lists(rng, S, 40, K, high)
    assert not high or (hpos[hpos != U32] >= 2**31).any()
    want = jsh.merge_sharded_hits(hpos, hnd, 3, k_hits)
    got = tsh.merge_sharded_hits(hpos.astype(np.int64), hnd.astype(np.int64),
                                 3, k_hits)
    assert want.keys() == got.keys()
    for name in want:
        assert np.array_equal(np.asarray(got[name]).astype(np.int64),
                              np.asarray(want[name]).astype(np.int64)), name


@pytest.mark.parametrize("high", [False, True])
@pytest.mark.parametrize("S,K,k_hits,max_diff0",
                         [(1, 8, 8, 3), (4, 8, 8, 3), (3, 16, 4, 10),
                          (8, 4, 16, 3)])
def test_merged_replay_matches(S, K, k_hits, max_diff0, high):
    """merged_replay against salt_tpu's on random (S, B, 2, K) lists with
    empty reads, ties between strands and, with `high`, global positions
    >= 2^31 (which an int32 sort key would put first)."""
    import jax.numpy as jnp

    from salt_tpu.parallel.sharded_engine import merged_replay as jax_replay
    from salt_tpu_torch.parallel.sharded_engine import merged_replay

    rng = np.random.default_rng(1000 + S * 10 + K + high)
    hpos, hnd = _hit_lists(rng, S, 48, K, high)
    assert not high or (hpos[hpos != U32] >= 2**31).any()
    want = jax_replay(jnp.asarray(hpos), jnp.asarray(hnd), max_diff0, k_hits)
    got = merged_replay(torch.from_numpy(hpos.astype(np.int64)),
                        torch.from_numpy(hnd.astype(np.int64)), max_diff0,
                        k_hits)
    for name, g, w in zip(want._fields, got, want):
        assert np.array_equal(g.numpy().astype(np.int64),
                              np.asarray(w).astype(np.int64)), name
    # and the host merge agrees with the device one
    host = tsh.merge_sharded_hits(hpos, hnd, max_diff0, k_hits)
    for name in ("found", "pos", "strand", "n_diff", "hits_pos", "hits_ndiff",
                 "first_hit_ndiff"):
        g = getattr(got, name).numpy().astype(np.int64)
        if name == "strand":   # the host merge leaves it 0 or 1 when unfound
            g, h = g[host["found"]], host[name][host["found"]]
        else:
            h = host[name]
        assert np.array_equal(g, np.asarray(h).astype(np.int64)), name


@pytest.fixture(scope="module")
def four_shards():
    """Four contigs that all hold one 100 bp repeat, a read inside it and
    reads with one mismatch, as tests/test_sharded.py builds them."""
    from salt_tpu.pipeline.engine import encode_reads, revcomp

    rng = np.random.default_rng(17)
    repeat = "".join(BASES[c] for c in rng.integers(0, 4, 100))
    contig_data = []
    for ci in range(4):
        seq = list(BASES[c] for c in rng.integers(0, 4, 2800 + 400 * ci))
        at = 500 + 173 * ci
        seq[at : at + 100] = repeat
        contig_data.append((f"chr{ci}", "syn", "".join(seq)))
    reads = [repeat, "".join(BASES[c] for c in rng.integers(0, 4, 100))]
    for ci in range(4):
        for s in (1200 + 67 * ci, 40 + ci):
            r = list(contig_data[ci][2][s : s + 100])
            r[31] = BASES[(BASES.index(r[31]) + 1) % 4]
            reads.append("".join(r))
    codes = encode_reads(reads)
    shard_indexes, bins = jsh.build_sharded_indexes(contig_data, [], 4)
    return contig_data, shard_indexes, bins, codes, revcomp(codes)


STEP_KW = dict(l_overlap=1, max_seed=50, max_locate=200, cap=256, u=32,
               k_hits=8)


def test_sharded_se_step_matches(four_shards):
    """Primaries, raw hit lists and the trunc flag of sharded_se_step
    against salt_tpu's on its 4-device CPU mesh."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    contig_data, shard_indexes, bins, fwd, rev = four_shards
    want = jsh.sharded_se_step(
        Mesh(np.array(jax.devices()[:4]), ("shard",)),
        jsh.stack_indexes(shard_indexes, bins, contig_data),
        jnp.asarray([ix.l_pac for ix in shard_indexes], dtype=jnp.int32),
        jnp.asarray(fwd.astype(np.int32)), jnp.asarray(rev.astype(np.int32)),
        return_hits=True, **STEP_KW)
    stacked = tsh.stack_indexes([port_index(ix) for ix in shard_indexes], bins,
                                contig_data, devices=["cpu"] * 4)
    assert [d.l_pac for d in stacked.shards] == \
        [ix.l_pac for ix in shard_indexes]         # true sizes, no padding
    got = tsh.sharded_se_step(stacked, torch.from_numpy(fwd),
                              torch.from_numpy(rev), return_hits=True,
                              **STEP_KW)
    assert len(got) == len(want) == 9
    found = np.asarray(want[0])
    assert found.sum() >= 9 and not found.all()
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = np.asarray(g).astype(np.int64), np.asarray(w).astype(np.int64)
        if i in (2, 4):      # strand and shard of an unfound read: shard 0's
            g, w = g[found], w[found]
        assert np.array_equal(g, w), i
    prim = tsh.sharded_se_step(stacked, torch.from_numpy(fwd),
                               torch.from_numpy(rev), **STEP_KW)
    assert len(prim) == 5
    for g, w in zip(prim, got[:5]):
        assert np.array_equal(g, w)
    # the repeat read hits once in every shard
    assert (got[7][:, 0].sum(-1) == 1).all()


def test_sharded_se_step_merge_equals_monolithic(four_shards):
    """merge_sharded_hits of the port's per-shard lists equals the port's
    monolithic ungapped step."""
    from salt_tpu.constants import NOGAP_MAX_DIFF
    from salt_tpu.index.build import build_index_from_data
    from salt_tpu_torch.pipeline.device_index import to_device_index
    from salt_tpu_torch.pipeline.se import se_ungapped

    contig_data, shard_indexes, bins, fwd, rev = four_shards
    stacked = tsh.stack_indexes([port_index(ix) for ix in shard_indexes], bins,
                                contig_data, devices="cpu")
    out = tsh.sharded_se_step(stacked, torch.from_numpy(fwd),
                              torch.from_numpy(rev), return_hits=True,
                              **STEP_KW)
    assert not out[8].any()
    merged = tsh.merge_sharded_hits(out[5], out[6], NOGAP_MAX_DIFF, 8)
    mono = se_ungapped(
        to_device_index(port_index(build_index_from_data(contig_data, [],
                                                         l_seed=19)), "cpu"),
        torch.from_numpy(fwd), torch.from_numpy(rev), **STEP_KW).res
    for name in ("found", "pos", "n_diff", "n_hits", "hits_pos", "hits_ndiff",
                 "first_hit_ndiff"):
        assert np.array_equal(np.asarray(merged[name]).astype(np.int64),
                              getattr(mono, name).numpy()), name


def test_shard_devices_rules():
    assert tsh.shard_devices(4, ["cpu", "cpu"]) == [torch.device("cpu")] * 4
    assert tsh.shard_devices(3, "cpu") == [torch.device("cpu")] * 3
    with pytest.raises(ValueError, match="5 devices for 4 shards"):
        tsh.shard_devices(4, ["cpu"] * 5)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tsh.shard_devices(4)


def test_stack_indexes_defaults_to_the_card(four_shards):
    """With no devices named the tables go to the visible CUDA devices,
    and without one that is an error, never the CPU."""
    contig_data, shard_indexes, bins, _fwd, _rev = four_shards
    shards = [port_index(ix) for ix in shard_indexes]
    if torch.cuda.is_available():
        stacked = tsh.stack_indexes(shards, bins, contig_data)
        assert {d.type for d in stacked.devices} == {"cuda"}
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tsh.stack_indexes(shards, bins, contig_data)
