"""What changes for salt_tpu_torch on a whole genome (3.1 G bases: ranks,
counts and positions past 2^31), held against salt_tpu at small sizes, and
the SSW's answer for a read code outside its score matrix.

- SSW: an N on the reverse strand reaches ssw_align as 3 - 4 (int8 -1, or
  byte 255).  salt_tpu's numpy SSW reads index -1, the N column; the port's
  native and numpy SSW give that answer for either form, and the native
  one reads nothing outside the matrix (the matrix is passed inside a
  poisoned buffer).
- Rank: rank_excl and lf_step on a small RankIndex whose exclusive counts
  and C-array are shifted to just under 2^31 and to just under 2^32 (what
  a whole-genome BWT holds), against salt_tpu's ops/rank.py on the same
  planes, exact mod 2^32.
- Locate: the full-mode gather index of a rank past 2^31 in a C suffix
  array longer than 2^31.
- Build: the BWT of a uint32 suffix array (the whole-genome SA-IS
  branch) made a few rows at a time, against salt_tpu's in one go; the
  whole index with every genome-scale loop of the build cut into steps of
  a few elements (what keeps a 3.1 G-base build's temporaries small),
  against salt_tpu's, array by array.
- Polish's LV form (byte reference): a window at a position past 2^31
  reads ref[0] in every byte, in salt_tpu (its int32 clip) and in the
  port alike: a known difference against C salt, pinned here.
- Sharded step: sharded_se_step with contig lengths declared so that
  three of four bins start past 2^31 (as bins 7 and 8 of a 3.1 G-base
  genome in 8 do), against salt_tpu's on its 4-device CPU mesh.
Tolerance: exact."""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from salt_tpu.index import build as jbuild
from salt_tpu.index.suffix import bwt_from_sa as jax_bwt_from_sa
from salt_tpu.io.snp import SnpBlock as JSnpBlock
from salt_tpu.ops.lv import lv_distance_batch as jax_lv
from salt_tpu.ops import rank as jrank
from salt_tpu.ops import ssw as jssw
from salt_tpu_torch.index import build as tbuild
from salt_tpu_torch.index import suffix
from salt_tpu_torch.io.snp import SnpBlock as TSnpBlock
from salt_tpu_torch.ops import rank, ssw
from salt_tpu_torch.ops.locate import sa_gather_index
from salt_tpu_torch.ops.lv import lv_distance_plain
from salt_tpu_torch.parallel import sharded as tsh

from test_torch_host import _same_index, tiny  # noqa: F401
from test_torch_shard_ops import STEP_KW, four_shards  # noqa: F401
from torch_fixtures import port_index

U32 = 2**32


def _n_on_reverse(seed=3, L=100):
    """A reference window and a read of it whose base 40 is an N read from
    the reverse strand: code 3 - 4, as polish.py makes it."""
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 4, L + 60).astype(np.int8)
    read = ref[25 : 25 + L].astype(np.uint8)
    read[[7, 61]] = (read[[7, 61]] + 1) % 4
    read[40] = np.uint8(255)
    return ref, read


def _fields(r):
    return (r.score1, r.score2, r.ref_begin1, r.ref_end1, r.read_begin1,
            r.read_end1, r.ref_end2, r.cigar)


@pytest.mark.parametrize("mat", [ssw.SCORE_MAT5, ssw.SCORE_MAT16],
                         ids=["plain", "snp"])
@pytest.mark.parametrize("form", ["int8", "uint8"])
def test_ssw_n_on_reverse_strand(mat, form):
    ref, read = _n_on_reverse()
    if mat.shape[0] == 16:      # SNP-aware: one-hot read codes, nibble window
        ref = (1 << ref).astype(np.int8)
        read = np.where(read < 4, 1 << np.minimum(read, 3), 255).astype(np.uint8)
    args = (mat, 5, 2, 50)
    want = _fields(jssw.ssw_align_py(read.astype(np.int8), ref, *args))
    code = read if form == "uint8" else read.astype(np.int8)
    assert _fields(ssw.ssw_align(code, ref, *args)) == want
    assert _fields(ssw.ssw_align_py(code, ref, *args)) == want
    # the code outside the matrix scores as its last code, the N column
    last = np.where(read < mat.shape[0], read, mat.shape[0] - 1)
    assert _fields(ssw.ssw_align_native(last, ref, *args)) == want


def test_native_ssw_reads_inside_its_matrix():
    """The native SSW with its matrix inside a buffer of +100 scores: any
    read before or after the matrix would change the score."""
    ref, read = _n_on_reverse()
    mat = ssw.SCORE_MAT5
    n = mat.shape[0]
    buf = np.full(3 * n * n, 100, dtype=np.int8)
    buf[n * n : 2 * n * n] = mat.ravel()
    fn = ssw._try_load_native()
    out = np.zeros(8, dtype=np.int32)
    cig = np.zeros(4096, dtype=np.uint32)
    code = np.ascontiguousarray(read.astype(np.int8))
    refc = np.ascontiguousarray(ref)
    p8 = lambda a, off=0: ctypes.cast(a.ctypes.data + off,
                                      ctypes.POINTER(ctypes.c_int8))
    rc = fn(p8(code), len(code), p8(refc), len(refc), p8(buf, n * n), n,
            5, 2, 50, 1, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            cig.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), len(cig))
    assert rc == 0
    want = jssw.ssw_align_py(code, ref, mat, 5, 2, 50)
    assert tuple(out[:7]) == _fields(want)[:7]
    assert want.score1 < 100
    assert [(int(v >> 2), "MID"[v & 3]) for v in cig[: out[7]]] == want.cigar


def _shifted_pair(n_sym, n, shift, seed):
    """The same planes in both packages with every exclusive count and
    the C-array raised by `shift` (wrapped to int32 where salt_tpu keeps
    int32): what a BWT with that many symbols before this stretch holds."""
    rng = np.random.default_rng(seed)
    syms = rng.integers(0, n_sym - 1, n).astype(np.uint8)
    syms[rng.integers(0, n)] = n_sym - 1
    counts = np.bincount(syms, minlength=n_sym)[: n_sym - 1]
    cfreq = np.concatenate([[0], np.cumsum(counts), [0]]).astype(np.int64)
    got = rank.build_rank_index(syms, cfreq)
    bc = got.bc.numpy().astype(np.int64)
    bc[:, 0] += shift
    bc32 = bc.astype(np.int32)             # wraps, as uint32 bits
    cf = cfreq + shift
    got.bc = torch.from_numpy(bc32)
    got.cfreq = torch.from_numpy(cf)
    want = jrank.RankIndex(bc=jnp.asarray(bc32),
                           cfreq=jnp.asarray(cf.astype(np.int32)), n=n,
                           n_words=got.n_words)
    return syms, got, want


@pytest.mark.parametrize("shift", [2**31 - 300, 2**32 - 300],
                         ids=["under-2^31", "under-2^32"])
@pytest.mark.parametrize("n_sym", [5, 6])
def test_rank_and_lf_past_2g(n_sym, shift):
    n = 3000
    syms, got, want = _shifted_pair(n_sym, n, shift, seed=n_sym)
    rng = np.random.default_rng(11)
    k = np.concatenate([[0, 1, 31, 32, 33, n - 1, n], rng.integers(0, n, 200)])
    l = np.minimum(k + rng.integers(0, 400, len(k)), n)
    crossed = False
    for c in range(n_sym):
        cc = np.full(len(k), c)
        g = rank.rank_excl(got, torch.from_numpy(k), torch.from_numpy(cc))
        w = jrank.rank_excl(want, jnp.asarray(k, jnp.int32),
                            jnp.asarray(cc, jnp.int32))
        assert np.array_equal(g.numpy() % U32, np.asarray(w).astype(np.int64) % U32)
        # against a plain count
        plain = np.array([(syms[:i] == c).sum() for i in k]) + shift
        assert np.array_equal(g.numpy() % U32, plain % U32)
        crossed |= bool((plain >= (2**31 if shift < 2**31 else U32)).any())
        gk, gl = rank.lf_step(got, torch.from_numpy(k), torch.from_numpy(l),
                              torch.from_numpy(cc))
        wk, wl = jrank.lf_step(want, jnp.asarray(k, jnp.int32),
                               jnp.asarray(l, jnp.int32),
                               jnp.asarray(cc, jnp.int32))
        assert np.array_equal(gk.numpy() % U32, np.asarray(wk).astype(np.int64) % U32)
        assert np.array_equal(gl.numpy() % U32, np.asarray(wl).astype(np.int64) % U32)
    assert crossed          # the counts pass 2^31 (or 2^32) inside the table


def test_full_mode_gather_index_past_2g():
    """A rank past 2^31 arrives as a wrapped int32 (as salt_tpu carries
    it) and indexes a C suffix array of 3.1 G ranks as unsigned; R ranks
    are offset by the C part, both clamped into their part."""
    c_sa_len, n_cat = 3_100_000_001, 3_100_000_001 + 1_500_000_001
    ranks = torch.tensor([0, 2**31 - 1, 2**31, 2**31 + 5, c_sa_len - 1,
                          c_sa_len + 10, 5, 2**31 + 7])
    wrapped = ((ranks + 2**31) & (U32 - 1)) - 2**31
    is_r = torch.tensor([False] * 6 + [True, True])
    got = sa_gather_index(wrapped, is_r, c_sa_len, n_cat)
    want = [0, 2**31 - 1, 2**31, 2**31 + 5, c_sa_len - 1, c_sa_len - 1,
            c_sa_len + 5, c_sa_len + (n_cat - c_sa_len - 1)]
    assert got.tolist() == want


@pytest.mark.parametrize("dtype", [np.int32, np.uint32, np.int64])
def test_bwt_in_chunks(dtype, monkeypatch):
    rng = np.random.default_rng(4)
    text = rng.integers(0, 4, 5000).astype(np.uint8)
    sa = suffix.suffix_array(text).astype(dtype)
    want = jax_bwt_from_sa(text, sa, 4)
    monkeypatch.setattr(suffix, "BWT_CHUNK", 7)
    got = suffix.bwt_from_sa(text, sa, 4)
    assert got[1] == want[1] and np.array_equal(got[0], want[0])


def test_sharded_step_past_2g(four_shards):  # noqa: F811
    import jax
    from jax.sharding import Mesh

    from salt_tpu.parallel import sharded as jsh

    contig_data, shard_indexes, bins, fwd, rev = four_shards
    lengths = [len(c[2]) for c in contig_data]
    lengths[0] += 2**31
    want = jsh.sharded_se_step(
        Mesh(np.array(jax.devices()[:4]), ("shard",)),
        jsh.stack_indexes(shard_indexes, bins, contig_lengths=lengths),
        jnp.asarray([ix.l_pac for ix in shard_indexes], dtype=jnp.int32),
        jnp.asarray(fwd.astype(np.int32)), jnp.asarray(rev.astype(np.int32)),
        return_hits=True, **STEP_KW)
    stacked = tsh.stack_indexes([port_index(ix) for ix in shard_indexes], bins,
                                contig_lengths=lengths, devices=["cpu"] * 4)
    assert (stacked.base_offsets > 2**31).sum() == 3   # every bin but chr0's
    got = tsh.sharded_se_step(stacked, torch.from_numpy(fwd),
                              torch.from_numpy(rev), return_hits=True,
                              **STEP_KW)
    found = np.asarray(want[0])
    gpos = np.asarray(want[1]).astype(np.int64)
    assert (gpos[found] >= 2**31).any() and (gpos[found] < 2**31).any()
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = np.asarray(g).astype(np.int64), np.asarray(w).astype(np.int64)
        if i in (2, 4):      # strand and shard of an unfound read: shard 0's
            g, w = g[found], w[found]
        assert np.array_equal(g, w), i


def test_byte_window_past_2g_reads_ref0():
    """Polish scores against a byte reference; salt_tpu clips the int32
    cast of a window position, so a window at 2^31 or later is ref[0]
    repeated.  The port keeps it (ops/lv.py, csrc/lv.cu's byte form)."""
    rng = np.random.default_rng(8)
    codes = np.array([1, 2, 4, 8], np.uint8)
    ref = codes[rng.integers(0, 4, 4000)]
    L = 60
    pos = np.array([2**31, 2**31 + 7, 2**32 - 100, 17, 17], np.int64)
    pats = np.stack([np.full(L, ref[0]), ref[40 : 40 + L], np.full(L, ref[0]),
                     ref[17 : 17 + L], np.full(L, ref[0])])
    pats[1, 5] = ref[0] ^ 15
    got = lv_distance_plain(torch.from_numpy(ref), torch.from_numpy(pos),
                            torch.ones(5, dtype=torch.bool),
                            torch.from_numpy(pats), 13, window_pad=0,
                            pat_precoded=True).numpy()
    want = np.asarray(jax_lv(jnp.asarray(ref),
                             jnp.asarray(pos.astype(np.uint32).view(np.int32)),
                             jnp.ones(5, bool), jnp.asarray(pats), 13,
                             window_pad=0, pat_precoded=True))
    assert np.array_equal(got, want)
    assert got[0] == got[2] == got[3] == 0 and got[4] > 0   # ref[0] repeated


@pytest.mark.parametrize("mode", ["exact", "reference_compat"])
def test_index_build_in_chunks(tiny, mode, monkeypatch):  # noqa: F811
    monkeypatch.setattr(tbuild, "CHUNK", 3)
    monkeypatch.setattr(suffix, "BWT_CHUNK", 7)
    _want, contigs, blocks = tiny
    want = jbuild.build_index_from_data(
        contigs, [JSnpBlock(*b) for b in blocks], l_seed=19,
        r_anchor_mode=mode)
    got = tbuild.build_index_from_data(
        contigs, [TSnpBlock(*b) for b in blocks], l_seed=19,
        r_anchor_mode=mode)
    _same_index(got, want)
