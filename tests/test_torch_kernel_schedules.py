"""The traps in the schedules of the two CUDA kernels, modelled step by
step in numpy (lanes as an array axis, a warp shuffle as a shift along
it) and held against the package's plain versions.

That the kernels themselves are right rests on chip_smoke.py, which
holds each against its plain version on a GPU; the plain versions are
held to salt_tpu by tests/test_torch_lv.py and tests/test_torch_sw.py.
The models here follow the sources by hand and guard only the arithmetic
a schedule could get wrong without any GPU noticing at the shapes tried:

  * csrc/sw.cu, sw_wave_kernel: 16 lanes a pair, R = ceil(L / 16) rows a
    lane, lane t at column s - t in step s; the bottom row's H and F
    cross lanes as int16 halves of one word (asserted to fit, up to the
    largest gap cost); rows >= L stay out of the maximum in plain mode.
  * csrc/lv.cu, lv_distance_kernel: the window built from word loads and
    one funnel shift a word, equal to ops/lv.py:window_nibbles at every
    pos & 7, at the clamped end of the reference and across 2^32; one
    lane per diagonal (two for k > 15), every reach of step e from step
    e - 1, kNeg outside the band, the walk ended at the smallest e.
  * the same kernel's byte form (polish): 4 match codes a word, the
    window from byte loads clipped one by one (position >= 2^31 reads
    byte 0, past the end reads the last byte), the front mask in bytes,
    the run search on packed words with the 8-bit fold, and the band walk
    over them, equal to lv_distance_plain with pat_precoded and a byte
    reference.

Inputs from a numpy seed; every comparison is exact."""

import numpy as np
import pytest
import torch

from salt_tpu_torch.constants import LV_MAX_K
from salt_tpu_torch.ops.lv import NT2BIT_NP, lv_distance_plain, window_nibbles
from salt_tpu_torch.ops.sw_batch import sw_score_numpy, sw_score_plain
from salt_tpu_torch.pipeline.device_index import pack_nibbles

SW_LANES = 16
K_NEG_F = -(1 << 20)
K_NEG = -2
BIG = 255
U32 = 0xFFFFFFFF


# ------------------------------------------------------------ K2 wavefront


def shuffle_up(v, fill=0):
    """__shfl_up_sync by one lane along the last axis; lane 0 keeps `fill`
    (the kernel ignores what lane 0 receives)."""
    out = np.full_like(v, fill)
    out[..., 1:] = v[..., :-1]
    return out


def shuffle_down(v, fill=0):
    out = np.full_like(v, fill)
    out[..., :-1] = v[..., 1:]
    return out


def wave_model(refs, reads, ref_len, snp, G, go=3, ge=1):
    """sw_wave_kernel for B pairs at once: state arrays are (B, G) a row
    of the strip.  Returns (B,) best scores."""
    B, W = refs.shape
    L = reads.shape[1]
    R = -(-L // G)
    t = np.arange(G)[None, :]
    row0 = t * R
    rows = np.clip(L - row0, 0, R)                         # (1, G)
    padded = np.zeros((B, G * R), np.int64)
    padded[:, :L] = reads
    q = padded.reshape(B, G, R)                            # codes of rows >= L: 0
    hcol = np.zeros((B, G, R), np.int64)
    ecol = np.zeros((B, G, R), np.int64)
    length = np.clip(ref_len.astype(np.int64), 0, W)[:, None]
    best = np.zeros((B, G), np.int64)
    diag_in = np.zeros((B, G), np.int64)
    send = np.zeros((B, G), np.uint32)
    steps = int(length.max()) + G - 1 if length.max() > 0 else 0
    for s in range(steps):
        recv = shuffle_up(send)
        j = s - t
        valid = (j >= 0) & (j < length)                    # (B, G)
        rc = np.take_along_axis(refs.astype(np.int64),
                                np.clip(j, 0, W - 1) + np.zeros((B, 1), np.int64), 1)
        rmask = np.where((rc != 0) & ((rc & (rc - 1)) == 0), rc, 0)
        hup = np.where(t == 0, 0, (recv & 0xFFFF).astype(np.int64))
        f = np.where(t == 0, K_NEG_F,
                     (recv >> 16).astype(np.uint16).astype(np.int16).astype(np.int64))
        diag = diag_in.copy()
        new_diag_in = hup.copy()
        h_new, e_new = hcol.copy(), ecol.copy()
        lane_best = best.copy()
        for r in range(R):
            hl, el, qr = hcol[:, :, r], ecol[:, :, r], q[:, :, r]
            if snp:
                sc = np.where((rmask & qr) != 0, 1, -3)
            else:
                sc = np.where((rc >= 4) | (qr >= 4), -1, np.where(rc == qr, 1, -3))
            e = np.maximum(el - ge, hl - go)
            f = np.maximum(f - ge, hup - go)
            h = np.maximum(np.maximum(0, diag + sc), np.maximum(e, f))
            h_new[:, :, r], e_new[:, :, r] = h, e
            lane_best = np.where(r < rows, np.maximum(lane_best, h), lane_best)
            diag, hup = hl, h
        # what crosses to the next lane must fit the int16 halves exactly
        assert ((hup >= 0) & (hup <= 0x7FFF))[valid].all()
        assert ((f >= -0x8000) & (f <= 0x7FFF))[valid].all()
        packed = ((hup & 0xFFFF) | ((f & 0xFFFF) << 16)).astype(np.uint32)
        # lanes before the start or past ref_len keep their state
        v3 = valid[:, :, None]
        hcol = np.where(v3, h_new, hcol)
        ecol = np.where(v3, e_new, ecol)
        best = np.where(valid, lane_best, best)
        diag_in = np.where(valid, new_diag_in, diag_in)
        send = np.where(valid, packed, send)
    return best.max(1)                                     # __shfl_xor_sync tree


def sw_inputs(rng, snp, B, L, W):
    """Windows and reads with planted copies, N codes, padding at the
    read's end and (SNP mode) multi-bit, 0 and 15 nibbles."""
    codes = rng.integers(0, 4, (B, W))
    at = rng.integers(0, max(W - L, 1), (B, 1))
    read = np.take_along_axis(codes, np.clip(at + np.arange(L)[None, :], 0, W - 1), 1)
    read = np.where(rng.random((B, L)) < 0.04, (read + 1) & 3, read)
    cut = rng.integers(1, max(L - 1, 2), (B, 1))
    shifted = np.roll(read, 2, axis=1)                     # a 2 bp insertion
    read = np.where((np.arange(L)[None, :] >= cut) & (rng.random((B, 1)) < 0.4),
                    shifted, read)
    read = np.where(rng.random((B, 1)) < 0.3, rng.integers(0, 4, (B, L)), read)
    pad = np.where(rng.random((B, 1)) < 0.33, rng.integers(1, 4, (B, 1)), 0)
    tail = np.arange(L)[None, :] >= L - pad
    u, v = rng.random((B, W)), rng.random((B, L))
    if snp:
        refs = 1 << codes
        refs = np.where(u < 0.06, refs | (1 << rng.integers(0, 4, (B, W))), refs)
        refs = np.where(u > 0.99, 0, np.where(u > 0.98, 15, refs))
        reads = np.where(tail, 0, np.where(v > 0.99, 15, 1 << read))
    else:
        refs = np.where(u > 0.99, 4, codes)
        reads = np.where(tail | (v > 0.99), 4, read)
    return refs.astype(np.uint8), reads.astype(np.uint8)


@pytest.mark.parametrize("L,W", [(100, 105), (104, 512), (33, 40), (7, 3)])
@pytest.mark.parametrize("snp", [True, False], ids=["snp", "plain"])
def test_sw_wavefront_schedule(snp, L, W, G=SW_LANES):
    """The wavefront equals sw_score_plain at every ref_len from 0 to W,
    and the textbook recurrence on a sample."""
    rng = np.random.default_rng(1000 * L + 10 * G + snp)
    B = W + 1
    refs, reads = sw_inputs(rng, snp, B, L, W)
    ref_len = np.arange(B, dtype=np.int32)                 # 0 .. W
    got = wave_model(refs, reads, ref_len, snp, G)
    want = sw_score_plain(torch.from_numpy(refs), torch.from_numpy(reads),
                          torch.from_numpy(ref_len), snp).numpy()
    assert (got == want).all(), np.nonzero(got != want)[0][:8]
    assert got[0] == 0                                     # ref_len = 0
    assert got.max() > min(L, W) // 3                      # planted copies score
    for i in rng.choice(B, 3, replace=False):
        assert got[i] == sw_score_numpy(refs[i, : ref_len[i]], reads[i], snp)


@pytest.mark.parametrize("go,ge", [(3, 1), (16384, 0), (5, 5), (1, 0)])
def test_sw_wavefront_inert_rows_and_gaps(go, ge, G=SW_LANES):
    """Rows >= L must stay out of the maximum in plain mode, where the
    padding code 0 is a base that can match: a window of A's against a
    read shorter than the lanes' strips.  Every gap cost the wrapper
    takes keeps F inside its int16 half."""
    L, W = G + 3, 40                                       # R = 2, most rows inert
    refs = np.zeros((4, W), np.uint8)                      # all A
    reads = np.zeros((4, L), np.uint8)
    reads[1, 5:] = 1
    reads[2, :] = 4
    reads[3, ::2] = 2
    lens = np.array([W, W, W, 7], np.int32)
    got = wave_model(refs, reads, lens, False, G, go, ge)
    want = sw_score_plain(torch.from_numpy(refs), torch.from_numpy(reads),
                          torch.from_numpy(lens), False, go, ge).numpy()
    assert (got == want).all(), (got, want)
    assert got[0] == L                                     # not G * R


# ------------------------------------------------------------ K1 window


def funnel_shift_right(lo, hi, shift):
    """__funnelshift_r on uint32 arrays: bits shift .. shift + 31 of
    hi:lo, shift in 0..28."""
    wide = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
    return ((wide >> np.uint64(shift)) & np.uint64(U32)).astype(np.uint32)


def window_model(words, pos, k, TL, nwt, G):
    """The kernel's window assembly for one candidate: word w of T is one
    funnel shift of the reference words at nibble positions start + 8w and
    start + 8w + 8 (start = pos - k, uint32), each word index wrapped and
    clamped on its own; lane w's upper word comes from lane w + 1 by
    shuffle, the last lane of a pass loads its own.  Returns nwt * 8
    nibbles."""
    n_words = len(words)

    def word_at(nib_pos):
        return words[np.minimum((nib_pos & U32) >> 3, n_words - 1)]

    base = int(pos) & U32
    first = (int(word_at(np.int64(base))) >> ((base & 7) * 4)) & 15
    start = (base - k) & U32
    shift = (start & 7) * 4
    out = np.zeros(nwt * 8, np.int64)
    t = np.arange(G, dtype=np.int64)
    for w0 in range(0, nwt, G):
        w = w0 + t
        p = (start + 8 * w) & U32
        lo = word_at(p)
        hi = shuffle_down(lo)
        hi[G - 1] = word_at((p[G - 1] + 8) & U32)
        word = funnel_shift_right(lo, hi, shift).astype(np.int64)
        nib = (word[:, None] >> (4 * np.arange(8))) & 15   # (G, 8)
        j = 8 * w[:, None] + np.arange(8)
        nib = np.where(j < k, first, np.where(j < k + TL, nib, 0))
        keep = w < nwt
        out[j[keep].ravel()] = nib[keep].ravel()
    return out


def window_rule(words_t, pos, k, TL, n):
    """The rule the window follows: k copies of text nibble 0, the TL
    text nibbles (uint32 positions, word index clamped), then zeros."""
    text = window_nibbles(words_t, torch.tensor([int(pos)]), TL)[0].numpy()
    return np.concatenate([np.full(k, text[0]), text,
                           np.zeros(n - k - TL, np.int64)])


def reference_words(rng, n_nibbles):
    mix = (1 << rng.integers(0, 4, n_nibbles)).astype(np.uint8)
    snp = rng.random(n_nibbles) < 0.05
    mix[snp] |= (1 << rng.integers(0, 4, int(snp.sum()))).astype(np.uint8)
    return mix, pack_nibbles(mix)


@pytest.mark.parametrize("k,G", [(0, 8), (3, 8), (10, 32), (30, 32)])
@pytest.mark.parametrize("where", ["inside", "end", "wrap"])
def test_lv_window_by_funnel_shift(where, k, G):
    """Word loads and a funnel shift give the nibbles of one load a
    nibble: at every pos & 7, at the clamped end of the reference and
    where the position wraps past 2^32."""
    rng = np.random.default_rng(7 * k + len(where))
    n_nib = 4096
    _mix, words = reference_words(rng, n_nib)
    words_t = torch.from_numpy(words.view(np.int32))
    L, TL = 100, 104
    nwt = (L + 2 * k) // 8 + 2
    if where == "inside":
        starts = [int(rng.integers(40, 3000)) & ~7 for _ in range(2)] + [0, 8]
    elif where == "end":      # windows that run past the last word
        starts = [n_nib - 104, n_nib - 56, n_nib - 8, n_nib + 16, 2**31]
    else:                     # start = pos - k and pos + t wrap mod 2^32
        starts = [2**32 - 104, 2**32 - 48, 2**32 - 8]
    for s0 in starts:
        for off in range(8):
            pos = (s0 + off) & U32
            got = window_model(words.astype(np.uint32), pos, k, TL, nwt, G)
            want = window_rule(words_t, pos, k, TL, nwt * 8)
            assert (got == want).all(), (pos, np.nonzero(got != want)[0][:8])


# ------------------------------------------------------------ K1 band walk


def lv_lanes(k):
    """(lanes a candidate, diagonals a lane) as csrc/lv.cu picks them."""
    if k <= 3:
        return 8, 1
    if k <= 7:
        return 16, 1
    if k <= 15:
        return 32, 1
    return 32, 2


def lv_model(words, pos, active, seq, k, window_pad):
    """lv_distance_kernel's nibble form for N candidates at once."""
    N, L = seq.shape
    TL = L + window_pad
    k = min(LV_MAX_K - 1, k)
    nwt = (L + 2 * k) // 8 + 2
    T = np.stack([window_model(words, p, k, TL, nwt, lv_lanes(k)[0])
                  for p in pos])
    P = np.zeros((N, 8 * (L // 8 + 2)), np.int64)
    P[:, :L] = NT2BIT_NP[np.clip(seq, 0, 4)]
    return band_walk(P, T, active, L, TL, k)


def band_walk(P, T, active, L, TL, k):
    """The kernel's walk over a pattern stream P and a window stream T
    (one element an entry, either width): reach is (N, G, per),
    neighbours come by a shift along the lane axis."""
    N = P.shape[0]
    G, per = lv_lanes(k)
    D = 2 * k + 1
    assert G * per >= D
    ii = np.arange(L + 1)

    def first_miss(r, dd):
        """first i >= r where P[i] & T[i + dd] == 0, per candidate."""
        miss = (P[:, : L + 1] & np.take_along_axis(T, ii[None, :] + dd[:, None], 1)) == 0
        miss &= ii[None, :] >= r[:, None]
        assert miss.any(1).all()                           # P[L] = 0 ends every run
        return miss.argmax(1)

    zero = np.zeros(N, np.int64)
    run0 = np.minimum(first_miss(zero, zero + k), L)
    result = np.where(run0 >= L, 0, BIG)
    live = run0 < L                                        # groups still walking
    dd = np.arange(G)[:, None] * per + np.arange(per)[None, :]      # (G, per)
    d = dd - k
    reach = np.where(dd[None] == k, run0[:, None, None], K_NEG)      # (N, G, per)
    for e in range(1, k + 1):
        below = shuffle_up(reach[:, :, per - 1], K_NEG)
        above = shuffle_down(reach[:, :, 0], K_NEG)
        nxt = reach.copy()
        done = np.zeros(N, bool)
        for i in range(per):
            cur = reach[:, :, i]
            prev = below if i == 0 else reach[:, :, i - 1]
            up = above if i == per - 1 else reach[:, :, i + 1]
            right = np.where(dd[:, i] + 1 < D, up + 1, K_NEG)
            in_band = np.abs(d[:, i]) <= e                 # (G,)
            best = np.maximum(np.maximum(cur + 1, prev), right)
            r = best.copy()
            for t in np.nonzero(in_band)[0]:               # one lane, all candidates
                bc = np.clip(best[:, t], 0, L)
                dd_t = np.full(N, dd[t, i])
                guard = (best[:, t] >= 0) & (
                    P[np.arange(N), bc] == T[np.arange(N), bc + dd_t])
                ext = np.minimum(first_miss(bc, dd_t), min(L, TL - d[t, i]))
                r[:, t] = np.where(guard, ext, best[:, t])
            nxt[:, :, i] = np.where(in_band[None, :], r, cur)
            done |= (in_band[None, :] & (r >= L)).any(1)   # __any_sync
        result = np.where(live & done, e, result)
        live &= ~done
        reach = nxt
    return np.where(active, result, BIG)


def lv_inputs(rng, N, L, k, n_nib=6000):
    mix, words = reference_words(rng, n_nib)
    pos = rng.integers(0, n_nib - L - 40, N).astype(np.int64)
    seq = rng.integers(0, 4, (N, L))
    for i in range(0, N, 2):                # planted, with up to 4 edits
        window = mix[pos[i] : pos[i] + L + 8].astype(np.int64)
        r = list(np.log2(window & -window).astype(np.int64))
        for _ in range(int(rng.integers(0, min(k, 4) + 1))):
            j = int(rng.integers(0, len(r) - 1))
            op = rng.integers(0, 3)
            if op == 0:
                r[j] = (r[j] + 1) % 4
            elif op == 1:
                del r[j]
            else:
                r.insert(j, int(rng.integers(0, 4)))
        if i % 8 == 0 and k:                # an insertion at the read's start
            r.insert(0, int(rng.integers(0, 4)))
        seq[i] = (r + r)[:L]
    seq[3, 7] = 4                           # an N base
    pos[-3:] = [n_nib - 3, 2**31 + 17, 2**32 - 5]           # clamped / wrapping
    active = rng.random(N) < 0.9
    return words, pos, active, seq.astype(np.uint8)


@pytest.mark.parametrize("L", [37, 100])
@pytest.mark.parametrize("k", [0, 3, 10, 30])
def test_lv_lane_per_diagonal_schedule(k, L):
    """One lane a diagonal (two at k = 30), all reaches from step e - 1,
    kNeg outside the band, exit at the smallest e: equal to
    lv_distance_plain on planted and random candidates."""
    rng = np.random.default_rng(100 * k + L)
    words, pos, active, seq = lv_inputs(rng, 60, L, k)
    got = lv_model(words.astype(np.uint32), pos, active, seq, k, 4)
    want = lv_distance_plain(
        torch.from_numpy(words.view(np.int32)), torch.from_numpy(pos),
        torch.from_numpy(active), torch.from_numpy(seq), k, 4,
        text_words=True).numpy()
    assert (got == want).all(), np.nonzero(got != want)[0][:8]
    if k >= 3:
        assert ((want > 0) & (want <= k)).sum() >= 5       # the band walk ran
    assert (want[~active] == BIG).all()


# ------------------------------------------------------------ K1 byte form

POLISH_CODES = np.array([1, 2, 4, 8, 16, 32, 64], np.uint8)


def byte_window_words(ref, pos, k, TL, nwt):
    """The byte form's window assembly for one candidate, as packed uint32
    words: word w holds the bytes at uint32 positions pos - k + 4w + q,
    each clipped on its own (byte 0 where the int32 cast is negative, else
    at most the last byte), zero outside [k, k + TL), and the k bytes in
    front overwritten with window byte 0 through the byte mask."""
    n = len(ref)

    def byte_at(p):
        p &= U32
        return int(ref[0] if p & 0x80000000 else ref[min(p, n - 1)])

    base = int(pos) & U32
    first = byte_at(base)
    start = (base - k) & U32
    words = np.zeros(nwt, np.uint32)
    for w in range(nwt):
        word = 0
        for q in range(4):
            j = 4 * w + q
            if k <= j < k + TL:
                word |= byte_at(start + j) << (8 * q)
        n_front = min(max(k - 4 * w, 0), 4)
        front = U32 if n_front >= 4 else (1 << (8 * n_front)) - 1
        words[w] = word | ((first * 0x01010101) & front)
    return words


def unpack_bytes(words):
    return ((words[..., None].astype(np.int64) >> (8 * np.arange(4))) & 255
            ).reshape(*words.shape[:-1], -1)


def byte_window_rule(ref_t, pos, k, TL, n):
    """What lv_distance_plain reads with a byte reference: the byte at
    clip(int32(uint32(pos + j)), 0, len - 1)."""
    t = (int(pos) + np.arange(TL)) & U32
    t = np.where(t >= 2**31, 0, np.minimum(t, len(ref_t) - 1))
    text = ref_t[t].astype(np.int64)
    return np.concatenate([np.full(k, text[0]), text,
                           np.zeros(n - k - TL, np.int64)])


@pytest.mark.parametrize("k", [0, 3, 13, 30])
def test_lv_byte_window_by_clipped_loads(k):
    rng = np.random.default_rng(50 + k)
    n = 3001                               # the last word of bytes is ragged
    ref = POLISH_CODES[rng.integers(0, 7, n)]
    L = TL = 100
    nwt = (L + 2 * k) // 4 + 2
    for pos in [0, 1, 2, 3, 5, 1234, n - TL, n - TL + 1, n - 50, n - 1, n + 7,
                2**31 - 40, 2**31 + 5, 2**32 - 60, 2**32 - 1]:
        got = unpack_bytes(byte_window_words(ref, pos, k, TL, nwt))
        want = byte_window_rule(ref, pos, k, TL, nwt * 4)
        assert (got == want).all(), (pos, np.nonzero(got != want)[0][:8])


def packed_first_miss(P, T, r, toff):
    """first_miss on packed byte words: funnel-shifted reads of 4 codes,
    AND, fold each byte's bits to its bit 0, the first clear byte."""
    def read_word(s, at):
        w = at >> 2
        return int(funnel_shift_right(s[w : w + 1], s[w + 1 : w + 2],
                                      (at & 3) * 8)[0])

    i = r
    while True:
        x = read_word(P, i) & read_word(T, i + toff)
        t = x | (x >> 1)
        t |= t >> 2
        t |= t >> 4
        miss = ~t & 0x01010101
        if miss:
            return i + ((miss & -miss).bit_length() - 1 >> 3)
        i += 4


def test_lv_byte_run_search_on_packed_words():
    """The word-wise search gives the first i >= r with P[i] & T[i + toff]
    == 0 for every start and offset, and never passes L (P is zero from L
    on), whatever bits the codes have."""
    rng = np.random.default_rng(9)
    L, k = 37, 13
    nwp, nwt = L // 4 + 2, (L + 2 * k) // 4 + 2
    for trial in range(40):
        pat = np.zeros(nwp * 4, np.int64)
        pat[:L] = rng.choice([1, 2, 4, 8, 16, 32, 64, 3, 0x81, 255], L)
        text = rng.choice([1, 2, 4, 8, 16, 32, 64, 0x81, 0], nwt * 4)
        if trial % 2:                      # long runs: text follows the pattern
            toff0 = int(rng.integers(0, 2 * k + 1))
            text[toff0 : toff0 + L] = pat[:L]
            text[toff0 + int(rng.integers(0, L))] = 128
        pack = lambda a: (a.reshape(-1, 4) << (8 * np.arange(4))).sum(1).astype(np.uint32)
        P, T = pack(pat), pack(text)
        for toff in (0, 1, 2, 3, k, 2 * k):
            for r in (0, 1, 2, 3, 4, 17, L - 1, L):
                miss = (pat[: L + 1] & text[toff : toff + L + 1]) == 0
                miss[:r] = False
                assert packed_first_miss(P, T, r, toff) == miss.argmax()


@pytest.mark.parametrize("L", [37, 100])
@pytest.mark.parametrize("k", [0, 3, 13, 30])
def test_lv_byte_form_schedule(k, L):
    """The byte form end to end (packed window, byte streams, the same
    band walk) against lv_distance_plain with pat_precoded and a byte
    reference, window_pad = 0 as polish calls it: planted reads with
    edits, windows cut by the reference end, positions >= 2^31."""
    rng = np.random.default_rng(300 * k + L)
    n, N = 5003, 60
    ref = POLISH_CODES[rng.integers(0, 4, n)]
    ref[rng.random(n) < 0.01] = 16                       # N in the reference
    pos = rng.integers(0, n - L - 40, N).astype(np.int64)
    pat = POLISH_CODES[rng.integers(0, 4, (N, L))]
    for i in range(0, N, 2):
        r = list(ref[pos[i] : pos[i] + L + 8])
        for _ in range(int(rng.integers(0, min(k, 4) + 1))):
            j = int(rng.integers(0, len(r) - 1))
            op = rng.integers(0, 3)
            if op == 0:
                r[j] = POLISH_CODES[(int(np.log2(r[j])) + 1) % 4]
            elif op == 1:
                del r[j]
            else:
                r.insert(j, POLISH_CODES[rng.integers(0, 4)])
        pat[i] = r[:L]
    pat[3, 7] = 32                                       # 3 - N of a reverse read
    pat[5, 9] = 64                                       # a stray byte
    pos[-4:] = [n - L, n - 3, 2**31 + 17, 2**32 - 5]     # cut / clipped windows
    pat[-4] = ref[n - L :]
    active = rng.random(N) < 0.9
    nwt = (L + 2 * k) // 4 + 2
    T = np.stack([unpack_bytes(byte_window_words(ref, p, k, L, nwt)) for p in pos])
    P = np.zeros((N, 4 * (L // 4 + 2)), np.int64)
    P[:, :L] = pat
    got = band_walk(P, T, active, L, L, min(LV_MAX_K - 1, k))
    want = lv_distance_plain(
        torch.from_numpy(ref), torch.from_numpy(pos), torch.from_numpy(active),
        torch.from_numpy(pat), k, 0, pat_precoded=True).numpy()
    assert (got == want).all(), np.nonzero(got != want)[0][:8]
    if k >= 3:
        assert ((want > 0) & (want <= k)).sum() >= 5
    assert (want[~active] == BIG).all()
