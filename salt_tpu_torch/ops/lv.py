"""Landau-Vishkin banded edit distance, SNP-aware.  Port of
salt_tpu/ops/lv.py.

Device side: batched distances with Align_src/LandauVishkin.c:19-122
`computeEditDistance` semantics:

  * match(i, j)  = (read_onehot[i] & mixref_nibble[j]) != 0
  * the phase-1 run from (0,0) uses AND-matching directly;
  * an (e, d) cell only extends its run when the first byte pair is
    EQUAL (LandauVishkin.c:79 `if (*p == *t)`), then the run continues
    while bytes AND-nonzero;
  * reaches are capped at endl = min(patternLen, textLen - d);
  * the result is the smallest e <= k with reach == patternLen, else
    BIG (255).

`lv_distance_batch` runs the CUDA kernel (ops/lv_cuda.py) on CUDA
tensors and the plain PyTorch version, `lv_distance_plain`, on CPU
tensors.  The kernel has two forms: packed reference words with base
codes (the aligner's gapped check) and a byte reference with precoded
patterns (polish).

Host side: `lv_cigar_host` replicates computeEditDistanceWithCigar
(LandauVishkin.c:176-470), including its d order (0, -1, 1, -2, 2 ...)
and backtrace.  The host helpers are copies of salt_tpu's, whose module
imports jax.  `lv_cigar_batch` runs the same traceback, and the MD/NM/XV
tag over its CIGAR, for a batch of rows in one call to the native host
library (csrc/lv_host.cpp); `lv_cigar_host` is its plain version.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..constants import GAP_WINDOW_PAD, LV_MAX_K

from ..utils.metrics import count
from . import lv_cuda
from .uint import U32, as_i32, take, take_u32

NT2BIT_NP = np.array([1, 2, 4, 8, 15], dtype=np.uint8)
BIG = 255


def lv_distance_batch(
    mixref: torch.Tensor,
    pos: torch.Tensor,
    active: torch.Tensor,
    seq: torch.Tensor,
    k: int,
    window_pad: int = GAP_WINDOW_PAD,
    pat_precoded: bool = False,
    text_words: bool = False,
) -> torch.Tensor:
    """Edit distances; inactive or unalignable -> BIG (255).  The kernel
    on CUDA tensors, the plain version on CPU tensors; either counts its
    rows as k1.rows."""
    if mixref.is_cuda:
        if pat_precoded != (not text_words):
            raise NotImplementedError(
                "the CUDA LV kernel has two forms: packed reference words "
                "with base codes (text_words=True, pat_precoded=False) and a "
                "byte reference with precoded patterns (text_words=False, "
                "pat_precoded=True); the two mixed combinations have no "
                "caller and no kernel")
        if pat_precoded:
            return lv_cuda.lv_distance_bytes_cuda(mixref, pos, active, seq, k,
                                                  window_pad)
        return lv_cuda.lv_distance_cuda(mixref, pos, active, seq, k, window_pad)
    count("k1.rows", seq.shape[0])
    return lv_distance_plain(mixref, pos, active, seq, k, window_pad,
                             pat_precoded, text_words)


def window_nibbles(words: torch.Tensor, pos: torch.Tensor, n: int) -> torch.Tensor:
    """The n reference nibbles from each position of `pos`, (N, n) int64:
    positions are uint32 and wrap, the word index is clamped to the last
    word (ops/uint.py:take_u32), the nibble offset comes from the
    unclamped position."""
    t = ((pos & U32)[:, None] + torch.arange(n, device=pos.device)) & U32
    return (take_u32(words, t >> 3) >> ((t & 7) * 4)) & 15


def lv_distance_plain(
    mixref: torch.Tensor,  # uint8 [l_mref], or uint32-bit words (text_words)
    pos: torch.Tensor,     # int64 (N,) uint32 candidate start positions
    active: torch.Tensor,  # bool  (N,)
    seq: torch.Tensor,     # (N, L) read codes for the right strand
    k: int,
    window_pad: int = GAP_WINDOW_PAD,
    pat_precoded: bool = False,
    text_words: bool = False,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel (int64 result).

    The text window is L + window_pad long (the aligner's gapped check
    uses GAP_WINDOW_PAD, ed_diff editdistance.c:373; polish scores
    windows of exactly the read length).  With `pat_precoded` the rows
    of `seq` are already AND-match codes instead of 0..4 base codes.
    With `text_words` the reference is 4-bit packed words
    (device_index.pack_nibbles)."""
    N, L = seq.shape
    TL = L + window_pad
    k = min(LV_MAX_K - 1, k)
    D = 2 * k + 1  # diagonals -k..k
    dev = seq.device

    base = torch.where(active, pos, 0)
    if text_words:
        text = window_nibbles(mixref, base, TL).to(torch.uint8)
    else:
        tidx = ((base & U32)[:, None] + torch.arange(TL, device=dev)) & U32
        text = take(mixref, as_i32(tidx)).to(torch.uint8)
    if pat_precoded:
        pat = seq.to(torch.uint8)
    else:
        pat = torch.from_numpy(NT2BIT_NP).to(dev)[seq.long().clamp(0, 4)]

    # padded views: pattern index 0..L (P[L] = 0), text index 0..TL+2k
    patp = torch.nn.functional.pad(pat, (0, 1))
    textp = torch.nn.functional.pad(text, (0, 2 * k + 1))

    # per-diagonal AND-match matrix m[:, d, i] = AND(P[i], T[i+d]) != 0
    ii = torch.arange(L + 1, device=dev)
    dd = torch.arange(D, device=dev) - k
    tmat = textp[:, (ii[None, :] + dd[:, None]).clamp(0, TL + 2 * k)]  # (N, D, L+1)
    miss = (patp[:, None, :] & tmat) == 0
    endl = torch.clamp(TL - dd, max=L)

    def first_miss(r):
        """first i >= r with no match, per (N, D); r in [0, L]."""
        cand = miss & (ii >= r[..., None])
        return torch.where(cand.any(-1), torch.argmax(cand.byte(), -1), L + 1)

    NEG = -2
    r0 = torch.zeros((N, D), dtype=torch.long, device=dev)
    run0 = torch.clamp(first_miss(r0)[:, k], max=L)
    Lrow = torch.full((N, D), NEG, dtype=torch.long, device=dev)
    Lrow[:, k] = run0
    result = torch.where(run0 >= L, 0, BIG)
    for e in range(1, k + 1):
        up = Lrow + 1
        left = torch.nn.functional.pad(Lrow[:, :-1], (1, 0), value=NEG)
        right = torch.nn.functional.pad(Lrow[:, 1:] + 1, (0, 1), value=NEG)
        best = torch.maximum(torch.maximum(up, left), right)
        bestc = best.clamp(0, L)
        # equality guard at (best, best+d) (LandauVishkin.c:79)
        pb = torch.gather(patp, 1, bestc)
        tb = torch.gather(tmat, 2, bestc[..., None])[..., 0]
        can_ext = (pb == tb) & (best >= 0)
        reach = torch.where(can_ext, torch.minimum(first_miss(bestc), endl), best)
        Lrow = torch.where(dd.abs() <= e, reach, NEG)
        result = torch.where((Lrow >= L).any(-1) & (result == BIG), e, result)
    return torch.where(active, result, BIG)


# ---------------- host-side exact reimplementation (cigar) ----------------


def _run_match(p: np.ndarray, t: np.ndarray, start: int, endl: int) -> int:
    """8-byte-group run matching of LandauVishkin.c:41-57 from `start`;
    returns the capped reach.  p/t are zero-padded byte arrays."""
    i = start
    # group loop: process in chunks of 8 starting at `start`
    while True:
        g_p = p[i : i + 8]
        g_t = t[i : i + 8]
        if len(g_p) < 8:
            g_p = np.pad(g_p, (0, 8 - len(g_p)))
        if len(g_t) < 8:
            g_t = np.pad(g_t, (0, 8 - len(g_t)))
        if not np.array_equal(g_p, g_t):
            a = (g_p & g_t) != 0
            z = 0
            while z < 8 and a[z]:
                z += 1
            if z < 8:
                return min(i + z, endl)
            i += 8
            continue
        i += 8
        if i >= endl:
            return endl


_LPAD = 64  # stand-in for the bytes before the C buffers (read but never
            # matching: a one-hot pattern byte is nonzero, pad is zero)


def lv_distance_host(text: np.ndarray, pattern: np.ndarray, k: int) -> int:
    """Reference-exact computeEditDistance on byte arrays (one-hot codes)."""
    k = min(LV_MAX_K - 1, k)
    tl, pl = len(text), len(pattern)
    endl = min(pl, tl)
    tpad = np.pad(text.astype(np.uint8), (_LPAD, 64))
    ppad = np.pad(pattern.astype(np.uint8), (0, 64))
    L = {}
    L[(0, 0)] = _run_match(ppad, tpad[_LPAD:], 0, endl)
    if L[(0, 0)] == endl:
        return pl - endl if pl > endl else 0
    for e in range(1, k + 1):
        d = 0
        while d != e + 1:
            up = L.get((e - 1, d), -2) + 1
            left = L.get((e - 1, d - 1), -2)
            right = L.get((e - 1, d + 1), -2) + 1
            best = max(up, left, right)
            if best >= 0 and ppad[best] == tpad[_LPAD + d + best]:
                endl_d = min(pl, tl - d)
                best = _run_match(ppad, tpad[_LPAD + d :], best, endl_d)
            if best == pl:
                return e
            L[(e, d)] = best
            d = -d if d > 0 else -d + 1
    return -1


def lv_cigar_host(text: np.ndarray, pattern: np.ndarray, k: int,
                  straight_shortcut: bool = False):
    """Reference-exact computeEditDistanceWithCigar (useM=1, compact).
    Returns (e, cigar_string) or (-1, "").

    straight_shortcut enables the `straightMismatches` fast path that is
    live in the polish tool's LV (Polish_src/lv.c:279-300) but commented
    out in the aligner's (Align_src/LandauVishkin.c:296-351): when e
    equals the no-indel mismatch count, emit plain '<len>M'."""
    tl, pl = len(text), len(pattern)
    endl = min(pl, tl)
    tpad = np.pad(text.astype(np.uint8), (_LPAD, 64))
    ppad = np.pad(pattern.astype(np.uint8), (0, 64))
    L = {}
    A = {}
    L[(0, 0)] = _run_match(ppad, tpad[_LPAD:], 0, endl)
    if L[(0, 0)] == endl:
        return 0, f"{pl}M"
    for e in range(1, k + 1):
        d = 0
        while d != -(e + 1):
            up = L.get((e - 1, d), -2) + 1
            act = "X"
            best = up
            left = L.get((e - 1, d - 1), -2)
            if left > best:
                best = left
                act = "D"
            right = L.get((e - 1, d + 1), -2) + 1
            if right > best:
                best = right
                act = "I"
            A[(e, d)] = act
            if best >= 0 and ppad[best] == tpad[_LPAD + d + best]:
                endl_d = min(pl, tl - d)
                best = _run_match(ppad, tpad[_LPAD + d :], best, endl_d)
            L[(e, d)] = best
            if best == pl:
                if straight_shortcut:
                    endl0 = min(pl, tl)
                    sm = int(
                        ((ppad[:endl0] & tpad[_LPAD : _LPAD + endl0]) == 0).sum()
                    ) + (pl - endl0)
                    if sm == e:
                        return e, f"{pl}M"
                # backtrace (LandauVishkin.c:380-460, useM path)
                bt_action = {}
                bt_matched = {}
                cur_d = d
                for cur_e in range(e, 0, -1):
                    a = A[(cur_e, cur_d)]
                    bt_action[cur_e] = a
                    if a == "I":
                        nd = cur_d + 1
                        bt_matched[cur_e] = L[(cur_e, cur_d)] - L[(cur_e - 1, nd)] - 1
                    elif a == "D":
                        nd = cur_d - 1
                        bt_matched[cur_e] = L[(cur_e, cur_d)] - L[(cur_e - 1, nd)]
                    else:
                        nd = cur_d
                        bt_matched[cur_e] = L[(cur_e, cur_d)] - L[(cur_e - 1, nd)] - 1
                    cur_d = nd
                out = []
                acc = L[(0, 0)]

                def emit(count, code):
                    if count > 0:
                        out.append(f"{count}{code}")

                ce = 1
                while ce <= e:
                    action = bt_action[ce]
                    count = 1
                    while ce + 1 <= e and bt_matched[ce] == 0 and bt_action[ce + 1] == action:
                        count += 1
                        ce += 1
                    if action in ("=", "X"):
                        acc += count
                    else:
                        if acc != 0:
                            emit(acc, "M")
                            acc = 0
                        emit(count, action)
                    if bt_matched[ce] > 0:
                        acc += bt_matched[ce]
                    ce += 1
                if acc != 0:
                    emit(acc, "M")
                return e, "".join(out)
            d = -(d + 1) if d >= 0 else -d
    return -1, ""


_P = ctypes.c_void_p
_I = ctypes.c_int
_CIGAR_ARGS = [_I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _P,
               _I]


def _cigar_fn():
    """salt_lv_cigar_batch of the host library, its ctypes types set."""
    from ..utils.native import load_native

    fn = load_native().salt_lv_cigar_batch
    if fn.argtypes is None:
        fn.argtypes = _CIGAR_ARGS
        fn.restype = _I
    return fn


def lv_cigar_batch(mixref: np.ndarray, pac: np.ndarray, pos, reads, k,
                   want_tag):
    """For each row i, lv_cigar_host(mixref[pos[i] : pos[i] + L +
    GAP_WINDOW_PAD], one-hot reads[i], k[i]) and, where want_tag[i], the
    MD/NM/XV tag io/sam.md_nm_tag gives that CIGAR at pos[i] (strand-
    selected read, no clip): one native call for the batch.

    reads: (N, L) strand-selected read codes 0..4.  Returns [(e, cigar,
    tag or None)].  A row the native routine hands back (the Python
    version would index past an array there: a window cut short at the
    end of the index, or k past 64) gets lv_cigar_host and tag None, for
    the caller's md_nm_tag.  Counts its rows as lv.cigar_rows."""
    reads = np.ascontiguousarray(reads, dtype=np.uint8)
    N, L = reads.shape
    count("lv.cigar_rows", N)
    if N == 0:
        return []
    pos = np.asarray(pos, dtype=np.int64)
    k = np.ascontiguousarray(k, dtype=np.int32)
    want = np.ascontiguousarray(want_tag, dtype=np.uint8)
    kmax = max(int(k.max()), 0)
    # the window covers the LV text and every reference base the tag
    # replays (at most L + k: one a match or mismatch and a deletion)
    W = L + max(GAP_WINDOW_PAD, kmax)
    cols = pos[:, None] + np.arange(W)
    mix = np.ascontiguousarray(mixref[np.minimum(cols, len(mixref) - 1)],
                               dtype=np.uint8)
    pacw = np.ascontiguousarray(pac[np.minimum(cols, len(pac) - 1)],
                                dtype=np.uint8)
    mix_len = np.clip(len(mixref) - pos, 0, W).astype(np.int32)
    pac_len = np.clip(len(pac) - pos, 0, W).astype(np.int32)
    text_len = np.minimum(mix_len, L + GAP_WINDOW_PAD).astype(np.int32)
    cigar_cap = 16 * (kmax + 2)
    tag_cap = 8 * (L + kmax) + 16 * 64 + 64
    e = np.empty(N, np.int32)
    cig = np.zeros((N, cigar_cap), np.uint8)
    tag = np.zeros((N, tag_cap), np.uint8)
    arrays = (reads, mix, mix_len, text_len, pacw, pac_len, k, want)
    rc = _cigar_fn()(N, L, W, *(a.ctypes.data for a in arrays),
                     e.ctypes.data, cig.ctypes.data, cigar_cap,
                     tag.ctypes.data, tag_cap)
    if rc != 0:
        raise RuntimeError(f"salt_lv_cigar_batch failed ({rc})")
    cigars = cig.view(f"S{cigar_cap}")[:, 0].tolist()
    tags = tag.view(f"S{tag_cap}")[:, 0].tolist()
    out = []
    for i, ei in enumerate(e.tolist()):
        if ei == -2:
            p = int(pos[i])
            ei, c = lv_cigar_host(mixref[p : p + L + GAP_WINDOW_PAD],
                                  NT2BIT_NP[np.minimum(reads[i], 4)],
                                  int(k[i]))
            out.append((ei, c, None))
        else:
            out.append((ei, cigars[i].decode(),
                        tags[i].decode() if want[i] else None))
    return out
