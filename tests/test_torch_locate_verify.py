"""locate / sort_loci and the verify stage of salt_tpu_torch against
salt_tpu on the same numpy-seeded inputs.  Tolerance: exact (positions,
flags and counts are integers)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from salt_tpu.ops import locate as jlocate
from salt_tpu.ops import verify as jverify
from salt_tpu.ops.seed import Seeds as JaxSeeds
from salt_tpu.pipeline.device_index import pack_nibbles
from salt_tpu_torch.ops import locate, verify
from salt_tpu_torch.ops.seed import Seeds


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _equal(got, want):
    for name in want._fields:
        g, w = _np(getattr(got, name)), _np(getattr(want, name))
        assert np.array_equal(g.astype(np.int64), w.astype(np.int64)), name


def _rand_seeds(rng, B, S, n_sa, l_seq):
    """Random seed sets as tests/test_locate_fuzz.py builds them."""
    sp = rng.integers(0, n_sa - 80, (B, S)).astype(np.int32)
    width = rng.integers(-1, 40, (B, S)).astype(np.int32)
    # some very wide intervals exercise the PE subsample stride
    wide = rng.random((B, S)) < 0.2
    width = np.where(wide, rng.integers(50, 400, (B, S)), width)
    ep = np.minimum(sp + width, n_sa - 1).astype(np.int32)
    off = rng.integers(0, l_seq, (B, S)).astype(np.int32)
    valid = rng.random((B, S)) < 0.8
    return sp, ep, off, valid


@pytest.mark.parametrize("pe_mode", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_locate_matches(pe_mode, seed):
    rng = np.random.default_rng(seed + (10 if pe_mode else 0))
    B, S = 16, 12
    # a short reference leaves most candidates unpushable, so the SE
    # stream overflows its slots before the push cap is reached
    n_sa, l_mref, l_seq = 4096, (3500, 3500, 300)[seed], 100
    max_locate = 4 if pe_mode else 20
    cap = 64
    sa_c = rng.integers(0, n_sa, n_sa).astype(np.uint32)
    sa_r = rng.integers(0, n_sa, n_sa).astype(np.uint32)
    sa_c[:40] = rng.integers(0, 50, 40)        # sa value < offset: uint32 wrap
    sa_c[0] = sa_r[7] = 0xFFFFFFFF             # the csa[0] quirk / '#' ranks
    sa_cat = np.concatenate([sa_c, sa_r])
    cs = _rand_seeds(rng, B, S, n_sa, l_seq)
    rs = _rand_seeds(rng, B, S, n_sa, l_seq)
    for s in (cs, rs):
        s[0][:2, :3] = 0                       # intervals starting at rank 0
        s[1][:2, :3] = rng.integers(0, 30, (2, 3))
    want = jlocate.locate(*(JaxSeeds(*map(jnp.asarray, s)) for s in (cs, rs)),
                          jnp.asarray(sa_cat), n_sa, l_seq, l_mref,
                          max_locate, cap, pe_mode=pe_mode, chunk=0)
    got = locate.locate(*(Seeds(*(torch.from_numpy(a).long() if a.dtype != bool
                                  else torch.from_numpy(a) for a in s))
                          for s in (cs, rs)),
                        torch.from_numpy(sa_cat.view(np.int32)), n_sa, l_seq,
                        l_mref, max_locate, cap, pe_mode=pe_mode)
    _equal(got.loci, want.loci)
    assert np.array_equal(_np(got.overflow), _np(want.overflow))
    _equal(locate.sort_loci(got.loci), jlocate.sort_loci(want.loci))
    assert _np(got.loci.pushed).any()
    assert _np(got.overflow).any() or not (pe_mode or seed == 2)
    assert (_np(got.loci.pos) > 0x7FFFFFFF).any()   # wrapped positions


def _rand_loci(rng, B, CAP, l_mref):
    pos = np.sort(rng.integers(0, l_mref + 200, (B, CAP)), axis=1).astype(np.uint32)
    pos[:, 1::5] = pos[:, 0::5][:, : pos[:, 1::5].shape[1]]   # duplicates
    pos = np.sort(pos, axis=1)
    pos[:2, -3:] = 0xFFFFFFFF
    pushed = rng.random((B, CAP)) < 0.7
    return pos, pushed


@pytest.mark.parametrize("u", [4, 16, 64])
def test_compact_loci_matches(u):
    rng = np.random.default_rng(u)
    B, CAP, l_mref = 12, 64, 3000
    pos, pushed = _rand_loci(rng, B, CAP, l_mref)
    jl = jlocate.Loci(jnp.asarray(pos), jnp.asarray(pushed))
    tl = locate.Loci(torch.from_numpy(pos.astype(np.int64)), torch.from_numpy(pushed))
    jchk = jverify.checked_mask(jl, l_mref)
    tchk = verify.checked_mask(tl, l_mref)
    assert np.array_equal(_np(tchk), _np(jchk))
    want = jverify.compact_loci(jl, jchk, u)
    got = verify.compact_loci(tl, tchk, u)
    for g, w in zip(got, want):
        assert np.array_equal(_np(g).astype(np.int64), _np(w).astype(np.int64))
    if u < 64:
        assert _np(got[2]).any()                # overflow rows


@pytest.mark.parametrize("L", [70, 100, 151])
def test_mismatch_counts_packed_matches(L):
    rng = np.random.default_rng(L)
    B, U, l_mref = 8, 24, 5000
    mix = (1 << rng.integers(0, 4, l_mref)).astype(np.uint8)
    snp = rng.random(l_mref) < 0.05
    mix[snp] |= (1 << rng.integers(0, 4, snp.sum())).astype(np.uint8)
    mix[100:130] = 0                                       # N run in the ref
    words = pack_nibbles(mix)
    pos = rng.integers(0, l_mref - L, (B, U)).astype(np.uint32)
    pos[0, :3] = [l_mref - 5, 2**31 + 3, 0xFFFFFFFF]       # clamped reads
    keep = rng.random((B, U)) < 0.8
    seq = rng.integers(0, 4, (B, L)).astype(np.int32)
    for b in range(B):                                     # near-matches
        p = int(pos[b, 3])
        seq[b] = [(int(v) & -int(v)).bit_length() - 1 for v in mix[p : p + L]]
        seq[b, rng.integers(0, L, 2)] = 4
    seq[seq < 0] = 0
    want = jverify.mismatch_counts_packed(jnp.asarray(words), jnp.asarray(pos),
                                          jnp.asarray(keep), jnp.asarray(seq), 4)
    got = verify.mismatch_counts_packed(
        torch.from_numpy(words.view(np.int32)), torch.from_numpy(pos.astype(np.int64)),
        torch.from_numpy(keep), torch.from_numpy(seq).long(), 4)
    _equal(got, want)
    assert set(_np(got.counts[keep]).tolist()) >= {0, 4}


@pytest.mark.parametrize("max_diff0,k_hits", [(3, 8), (10, 16), (3, 2)])
def test_replay_and_select_matches(max_diff0, k_hits):
    rng = np.random.default_rng(max_diff0 * 100 + k_hits)
    B, CAP = 32, 40

    def strand():
        counts = rng.integers(0, max_diff0 + 3, (B, CAP)).astype(np.int32)
        checked = rng.random((B, CAP)) < 0.6
        counts[~checked] = 255
        pos = np.sort(rng.integers(0, 10**6, (B, CAP)), axis=1).astype(np.uint32)
        return counts, checked, pos

    s0, s1 = strand(), strand()
    s1[1][:4] = False                              # rows with strand-0 hits only
    s0[1][4:8] = False
    s0[1][8:10] = s1[1][8:10] = False              # rows with no hits
    want = jverify.replay_and_select(
        *(jverify.StrandVerify(*map(jnp.asarray, s)) for s in (s0, s1)),
        max_diff0, k_hits)
    got = verify.replay_and_select(
        *(verify.StrandVerify(torch.from_numpy(s[0]).long(), torch.from_numpy(s[1]),
                              torch.from_numpy(s[2].astype(np.int64)))
          for s in (s0, s1)), max_diff0, k_hits)
    _equal(got, want)
    assert _np(got.found).any() and not _np(got.found).all()
