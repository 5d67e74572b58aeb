"""Rank queries, device-index arrays and overlap seeding of
salt_tpu_torch against salt_tpu on the same numpy-seeded inputs.
Tolerance: exact (integer ranks and intervals)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from salt_tpu.ops import rank as jrank
from salt_tpu.ops.seed import seed_overlap as jax_seed_overlap
from salt_tpu.pipeline.device_index import to_device_index as jax_to_device_index
from salt_tpu_torch.ops import rank
from salt_tpu_torch.ops.seed import seed_overlap
from salt_tpu_torch.pipeline.device_index import to_device_index

from torch_fixtures import tiny_fixture


@pytest.fixture(scope="module")
def fixture():
    idx, records = tiny_fixture()
    return idx, records, jax_to_device_index(idx), to_device_index(idx, "cpu")


@pytest.mark.parametrize("n_sym", [5, 6])
@pytest.mark.parametrize("n", [1, 31, 64, 1000])
def test_rank_excl_matches(n_sym, n):
    rng = np.random.default_rng(n_sym * 1000 + n)
    syms = rng.integers(0, n_sym - 1, n).astype(np.uint8)
    syms[rng.integers(0, n)] = n_sym - 1             # in-band sentinel
    counts = np.bincount(syms, minlength=n_sym)[: n_sym - 1]
    cfreq = np.concatenate([[0], np.cumsum(counts), [0]]).astype(np.uint32)
    want_ri = jrank.build_rank_index(syms, n_sym, cfreq, n_sym - 1)
    got_ri = rank.build_rank_index(syms, cfreq)
    assert got_ri.n_sym == n_sym
    assert np.array_equal(got_ri.bc.numpy(), np.asarray(want_ri.bc))
    idx = np.unique(np.concatenate([
        [0, n, n + 1], np.arange(0, n + 2, 32), np.arange(31, n + 2, 32),
        np.arange(33, n + 2, 32), rng.integers(0, n + 2, 64)]))
    idx = idx[idx <= n + 1]
    for c in range(n_sym):
        cc = np.full(len(idx), c, np.int32)
        want = np.asarray(jrank.rank_excl(want_ri, jnp.asarray(idx, jnp.int32),
                                          jnp.asarray(cc)))
        got = rank.rank_excl(got_ri, torch.from_numpy(idx.astype(np.int64)),
                             torch.from_numpy(cc.astype(np.int64)))
        assert np.array_equal(got.numpy(), want), c
        # against a plain count
        assert np.array_equal(got.numpy(), [(syms[:i] == c).sum() for i in idx])


def test_device_index_arrays_match(fixture):
    _idx, _records, want, got = fixture
    Wc = got.ri_c.n_words
    fused = np.asarray(want.ri_c.bc)            # C planes first, then R
    assert want.ri_r.row_off == 5 * Wc
    assert np.array_equal(got.ri_c.bc.numpy(), fused[: 5 * Wc])
    assert np.array_equal(got.ri_r.bc.numpy(), fused[5 * Wc :])
    for ri_g, ri_w in ((got.ri_c, want.ri_c), (got.ri_r, want.ri_r)):
        assert np.array_equal(ri_g.cfreq.numpy(), np.asarray(ri_w.cfreq))
        assert (ri_g.n, ri_g.n_words) == (ri_w.n, ri_w.n_words)
    for name in ("lkt", "r_lkt_sp", "r_lkt_ep", "mixref_words"):
        assert np.array_equal(getattr(got, name).numpy().view(np.uint32),
                              np.asarray(getattr(want, name))), name
    # sa_cat is csa ++ r_coord.  salt_tpu's small-index path derives it
    # by sampled-SA walks, which give R rank 0 (the sentinel suffix, no
    # genome coordinate) a walk value where the host table keeps
    # UINT32_MAX.  No seed interval holds rank 0 (every LF step lands at
    # C[c] + occ + 1 >= 1; test_seed_overlap_matches checks sp >= 1), so
    # the entry is never read.  Every other entry is equal.
    sa_got = got.sa_cat.numpy().view(np.uint32)
    sa_want = np.asarray(want.sa_cat)
    r0 = got.c_sa_len
    assert sa_got[r0] == 0xFFFFFFFF
    assert np.array_equal(np.delete(sa_got, r0), np.delete(sa_want, r0))
    assert (got.l_pac, got.l_seed, got.c_sa_len) == (
        want.l_pac, want.l_seed, want.c_sa_len)


def _reads_with_ns(records, seed=3):
    from salt_tpu_torch.pipeline.engine import encode_reads

    codes = encode_reads([r.seq for r in records[:48]])
    rng = np.random.default_rng(seed)
    codes[rng.random(codes.shape) < 0.01] = 4        # N
    codes[::11, 40] = 5                              # '-', a code above N
    codes[::7, -15:-10] = 4                          # N inside a 12-mer tail
    return codes.astype(np.int32)


@pytest.mark.parametrize("variant", ["r_lkt", "lf_only", "seed_only_ref"])
@pytest.mark.parametrize("l_overlap,max_seed", [(1, 50), (3, 2)])
def test_seed_overlap_matches(fixture, variant, l_overlap, max_seed):
    _idx, records, want_dix, got_dix = fixture
    seq = _reads_with_ns(records)
    kw = dict(seed_only_ref=variant == "seed_only_ref")
    jkw, tkw = dict(kw), dict(kw)
    if variant == "r_lkt":
        jkw.update(r_lkt_sp=want_dix.r_lkt_sp, r_lkt_ep=want_dix.r_lkt_ep)
        tkw.update(r_lkt_sp=got_dix.r_lkt_sp, r_lkt_ep=got_dix.r_lkt_ep)
    want = jax_seed_overlap(want_dix.ri_c, want_dix.ri_r, want_dix.lkt,
                            jnp.asarray(seq), want_dix.l_seed, l_overlap,
                            max_seed, **jkw)
    # the fused JAX planes are read through standalone views
    got = seed_overlap(got_dix.ri_c, got_dix.ri_r, got_dix.lkt,
                       torch.from_numpy(seq).long(), got_dix.l_seed, l_overlap,
                       max_seed, **tkw)
    for fam_w, fam_g in zip(want, got):
        for name in ("sp", "ep", "offset", "valid"):
            assert np.array_equal(getattr(fam_g, name).numpy(),
                                  np.asarray(getattr(fam_w, name))), name
    assert got[0].valid.any() and (~got[0].valid).any()
    for fam in got:
        assert (fam.sp[fam.valid] >= 1).all()   # rank 0 is never a locus


def test_uint_helpers_match_numpy_uint32():
    from salt_tpu_torch.ops.uint import as_i32, popcount32, ugt, umin

    rng = np.random.default_rng(4)
    a = np.concatenate([rng.integers(0, 2**32, 200, dtype=np.uint64),
                        [0, 1, 2**31 - 1, 2**31, 2**32 - 1]]).astype(np.uint32)
    b = rng.permutation(a)
    ai = torch.from_numpy(a.view(np.int32).astype(np.int64))  # wrapped int32
    bi = torch.from_numpy(b.view(np.int32).astype(np.int64))
    assert np.array_equal(ugt(ai, bi).numpy(), a > b)
    assert np.array_equal(umin(ai, bi).numpy(), np.minimum(a, b).view(np.int32))
    assert np.array_equal(as_i32(torch.from_numpy(a.astype(np.int64))).numpy(),
                          a.view(np.int32))
    want = np.array([bin(int(x)).count("1") for x in a])
    assert np.array_equal(popcount32(ai).numpy(), want)
