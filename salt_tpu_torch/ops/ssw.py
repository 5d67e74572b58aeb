"""Striped Smith-Waterman, bit-faithful to the vendored SSW 0.1.4
(Align_src/ssw.c, SSE2).  Used for PE mate rescue (alnpe.c:261-393) and
the -X 1 SE extension path.

The SSE register semantics are emulated with 16-lane (byte) / 8-lane
(word) numpy arrays, including the striped layout's stale-E quirk (E is
updated from the pre-Lazy-F H, ssw.c:227-230) and the Lazy-F correction
loops — scores and positions match the C exactly, verified by fuzzing
against the compiled reference in tests/test_ssw.py.

Score matrices: score_mat2 (16x16 over one-hot nibbles, SNP-aware,
alnpe.c:58-73) and score_mat (5x5 plain, alnpe.c:52-56).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

# alnpe.c:52-56
SCORE_MAT5 = np.array(
    [
        [1, -3, -3, -3, -1],
        [-3, 1, -3, -3, -1],
        [-3, -3, 1, -3, -1],
        [-3, -3, -3, 1, -1],
        [-1, -1, -1, -1, -1],
    ],
    dtype=np.int8,
)

# alnpe.c:58-73 score_mat2, reproduced literally (16x16 over one-hot
# nibbles; rows = mixRef nibble, cols = read one-hot)
_raw = [
    [-3] * 16,
    [-3, 1, -3, 1, -3, 1, -3, 1, -3, 1, -3, 1, -3, 1, -3, 1],
    [-3, -3, 1, 1, -3, -3, 1, 1, -3, -3, 1, 1, -3, -3, 1, 1],
    [-3] * 16,
    [-3, -3, -3, -3, 1, 1, 1, 1, -3, -3, -3, -3, 1, 1, 1, 1],
    [-3] * 16,
    [-3] * 16,
    [-3] * 16,
    [-3, -3, -3, -3, -3, -3, -3, -3, 1, 1, 1, 1, 1, 1, 1, 1],
    [-3] * 16,
    [-3] * 16,
    [-3] * 16,
    [-3] * 16,
    [-3] * 16,
    [-3] * 16,
    [-3] * 16,
]
SCORE_MAT16 = np.array(_raw, dtype=np.int8)


@dataclass
class SWResult:
    score1: int
    score2: int
    ref_begin1: int
    ref_end1: int
    read_begin1: int
    read_end1: int
    ref_end2: int
    cigar: Optional[List[Tuple[int, str]]]  # [(count, op)] ops MID


def _qp_byte(read: np.ndarray, mat: np.ndarray, n: int, bias: int) -> np.ndarray:
    """Query profile: (n, segLen, 16) uint8 = mat[nt, read[j + lane*segLen]] + bias."""
    readLen = len(read)
    segLen = (readLen + 15) // 16
    prof = np.full((n, segLen, 16), bias, dtype=np.uint8)
    for j in range(segLen):
        for lane in range(16):
            r = j + lane * segLen
            if r < readLen:
                prof[:, j, lane] = (mat[:, read[r]].astype(np.int16) + bias).astype(np.uint8)
    return prof


def _qp_word(read: np.ndarray, mat: np.ndarray, n: int) -> np.ndarray:
    readLen = len(read)
    segLen = (readLen + 7) // 8
    prof = np.zeros((n, segLen, 8), dtype=np.int16)
    for j in range(segLen):
        for lane in range(8):
            r = j + lane * segLen
            if r < readLen:
                prof[:, j, lane] = mat[:, read[r]]
    return prof


def _adds_epu8(a, b):
    return np.minimum(
        np.asarray(a, np.int16) + np.asarray(b, np.int16), 255
    ).astype(np.uint8)


def _subs_epu8(a, b):
    return np.maximum(
        np.asarray(a, np.int16) - np.asarray(b, np.int16), 0
    ).astype(np.uint8)


def _slli_lane(v, k=1):
    """_mm_slli_si128 by k bytes on a lane vector: lane i <- lane i-k."""
    out = np.zeros_like(v)
    out[k:] = v[:-k]
    return out


def _sw_byte(ref, ref_dir, refLen, readLen, gapO, gapE, prof, terminate, bias, maskLen):
    """sw_sse2_byte (ssw.c:123-345).  prof: (n, segLen, 16) uint8.
    Returns (best, second) as (score, ref, read) tuples."""
    segLen = (readLen + 15) // 16
    maxColumn = np.zeros(refLen, dtype=np.uint8)
    pvHStore = np.zeros((segLen, 16), dtype=np.uint8)
    pvHLoad = np.zeros((segLen, 16), dtype=np.uint8)
    pvE = np.zeros((segLen, 16), dtype=np.uint8)
    pvHmax = np.zeros((segLen, 16), dtype=np.uint8)
    maxv = 0
    end_read = readLen - 1
    end_ref = -1
    vMaxScore = np.zeros(16, dtype=np.uint8)
    vMaxMark = np.zeros(16, dtype=np.uint8)

    rng = range(refLen) if ref_dir == 0 else range(refLen - 1, -1, -1)
    for i in rng:
        vF = np.zeros(16, dtype=np.uint8)
        vMaxColumn = np.zeros(16, dtype=np.uint8)
        vH = _slli_lane(pvHStore[segLen - 1])
        vP = prof[ref[i]]
        pvHLoad, pvHStore = pvHStore, pvHLoad
        for j in range(segLen):
            vH = _subs_epu8(_adds_epu8(vH, vP[j]), bias)
            e = pvE[j].copy()
            vH = np.maximum(vH, e)
            vH = np.maximum(vH, vF)
            vMaxColumn = np.maximum(vMaxColumn, vH)
            pvHStore[j] = vH
            vH2 = _subs_epu8(vH, gapO)
            e = _subs_epu8(e, gapE)
            e = np.maximum(e, vH2)
            pvE[j] = e
            vF = _subs_epu8(vF, gapE)
            vF = np.maximum(vF, vH2)
            vH = pvHLoad[j].copy()
        # Lazy-F
        j = 0
        vH = pvHStore[0].copy()
        vF = _slli_lane(vF)
        while not np.all(_subs_epu8(vF, _subs_epu8(vH, gapO)) == 0):
            vH = np.maximum(vH, vF)
            vMaxColumn = np.maximum(vMaxColumn, vH)
            pvHStore[j] = vH
            vF = _subs_epu8(vF, gapE)
            j += 1
            if j >= segLen:
                j = 0
                vF = _slli_lane(vF)
            vH = pvHStore[j].copy()
        vMaxScore = np.maximum(vMaxScore, vMaxColumn)
        if not np.array_equal(vMaxMark, vMaxScore):
            vMaxMark = vMaxScore.copy()
            temp = int(vMaxScore.max())
            if temp > maxv:
                maxv = temp
                if maxv + bias >= 255:
                    break
                end_ref = i
                pvHmax[:] = pvHStore
        maxColumn[i] = vMaxColumn.max()
        if maxColumn[i] == terminate:
            break

    # read ending position: first (in flat byte order) cell == max
    flat = pvHmax.reshape(-1)  # index i = j*16 + lane
    for fi in range(segLen * 16):
        if flat[fi] == maxv:
            j, lane = fi // 16, fi % 16
            temp = j + lane * segLen
            if temp < end_read:
                end_read = temp
    best = (min(maxv + bias, 255) if maxv + bias >= 255 else maxv, end_ref, end_read)

    second = [0, 0]
    edge = max(end_ref - maskLen, 0)
    for i in range(0, edge):
        if maxColumn[i] > second[0]:
            second = [int(maxColumn[i]), i]
    edge = refLen if end_ref + maskLen > refLen else end_ref + maskLen
    for i in range(edge + 1, refLen):
        if maxColumn[i] > second[0]:
            second = [int(maxColumn[i]), i]
    return best, (second[0], second[1], 0)


def _subs_epu16(a, b):
    return np.maximum(
        np.asarray(a, np.int32) - np.asarray(b, np.int32), 0
    ).astype(np.int16)


def _sw_word(ref, ref_dir, refLen, readLen, gapO, gapE, prof, terminate, maskLen):
    """sw_sse2_word (ssw.c:371-547).  prof: (n, segLen, 8) int16."""
    segLen = (readLen + 7) // 8
    maxColumn = np.zeros(refLen, dtype=np.uint16)
    pvHStore = np.zeros((segLen, 8), dtype=np.int16)
    pvHLoad = np.zeros((segLen, 8), dtype=np.int16)
    pvE = np.zeros((segLen, 8), dtype=np.int16)
    pvHmax = np.zeros((segLen, 8), dtype=np.int16)
    maxv = 0
    end_read = readLen - 1
    end_ref = 0
    vMaxScore = np.zeros(8, dtype=np.int16)
    vMaxMark = np.zeros(8, dtype=np.int16)

    rng = range(refLen) if ref_dir == 0 else range(refLen - 1, -1, -1)
    for i in rng:
        vF = np.zeros(8, dtype=np.int16)
        vMaxColumn = np.zeros(8, dtype=np.int16)
        vH = _slli_lane(pvHStore[segLen - 1])
        vP = prof[ref[i]]
        pvHLoad, pvHStore = pvHStore, pvHLoad
        for j in range(segLen):
            vH = np.clip(vH.astype(np.int32) + vP[j].astype(np.int32), -32768, 32767).astype(np.int16)
            e = pvE[j].copy()
            vH = np.maximum(vH, e)
            vH = np.maximum(vH, vF)
            vMaxColumn = np.maximum(vMaxColumn, vH)
            pvHStore[j] = vH
            vH2 = _subs_epu16(vH, np.int16(gapO))
            e = _subs_epu16(e, np.int16(gapE))
            e = np.maximum(e, vH2)
            pvE[j] = e
            vF = _subs_epu16(vF, np.int16(gapE))
            vF = np.maximum(vF, vH2)
            vH = pvHLoad[j].copy()
        # Lazy-F (word flavor, ssw.c:469-479)
        done = False
        for k in range(8):
            vF = _slli_lane(vF)
            for j in range(segLen):
                vH = pvHStore[j].copy()
                vH = np.maximum(vH, vF)
                pvHStore[j] = vH
                vH2 = _subs_epu16(vH, np.int16(gapO))
                vF = _subs_epu16(vF, np.int16(gapE))
                if not np.any(vF > vH2):
                    done = True
                    break
            if done:
                break
        vMaxScore = np.maximum(vMaxScore, vMaxColumn)
        if not np.array_equal(vMaxMark, vMaxScore):
            vMaxMark = vMaxScore.copy()
            temp = int(vMaxScore.max())
            if temp > maxv:
                maxv = temp
                end_ref = i
                pvHmax[:] = pvHStore
        maxColumn[i] = max(int(vMaxColumn.max()), 0)
        if maxColumn[i] == terminate:
            break

    flat = pvHmax.reshape(-1)  # index = j*8 + lane
    for fi in range(segLen * 8):
        if flat[fi] == maxv:
            j, lane = fi // 8, fi % 8
            temp = j + lane * segLen
            if temp < end_read:
                end_read = temp
    best = (maxv, end_ref, end_read)

    second = [0, 0]
    edge = max(end_ref - maskLen, 0)
    for i in range(0, edge):
        if maxColumn[i] > second[0]:
            second = [int(maxColumn[i]), i]
    edge = refLen if end_ref + maskLen > refLen else end_ref + maskLen
    for i in range(edge, refLen):
        if maxColumn[i] > second[0]:
            second = [int(maxColumn[i]), i]
    return best, (second[0], second[1], 0)


def _banded_sw(ref, read, refLen, readLen, score, gapO, gapE, band_width, mat):
    """banded_sw (ssw.c:549-727): returns [(count, 'M'/'I'/'D'), ...]."""

    def set_u(w, i, j):
        x = i - w
        x = x if x > 0 else 0
        return j - x + 1

    while True:
        width = band_width * 2 + 3
        width_d = band_width * 2 + 1
        h_b = np.zeros(width + 2, dtype=np.int64)
        e_b = np.zeros(width + 2, dtype=np.int64)
        h_c = np.zeros(width + 2, dtype=np.int64)
        direction = np.zeros((readLen, width_d * 3), dtype=np.int8)
        maxv = 0
        for i in range(readLen):
            beg = max(0, i - band_width)
            end = min(refLen - 1, i + band_width)
            edge = min(end + 1, width - 1)
            f = 0
            h_b[0] = e_b[0] = h_b[edge] = e_b[edge] = h_c[0] = 0
            u = 0
            for j in range(beg, end + 1):
                u = set_u(band_width, i, j)
                eu = set_u(band_width, i - 1, j)
                b = set_u(band_width, i, j - 1)
                d = set_u(band_width, i - 1, j - 1)
                x = max(i - band_width, 0)
                de = (j - x) * 3 + 0
                df = (j - x) * 3 + 1
                dh = (j - x) * 3 + 2
                temp1 = -gapO if i == 0 else h_b[eu] - gapO
                temp2 = -gapE if i == 0 else e_b[eu] - gapE
                e_b[u] = max(temp1, temp2)
                direction[i, de] = 3 if temp1 > temp2 else 2
                temp1 = h_c[b] - gapO
                temp2 = f - gapE
                f = max(temp1, temp2)
                direction[i, df] = 5 if temp1 > temp2 else 4
                e1 = max(e_b[u], 0)
                f1 = max(f, 0)
                temp1 = max(e1, f1)
                temp2 = h_b[d] + mat[ref[j], read[i]]
                h_c[u] = max(temp1, temp2)
                if h_c[u] > maxv:
                    maxv = int(h_c[u])
                if temp1 <= temp2:
                    direction[i, dh] = 1
                else:
                    direction[i, dh] = direction[i, de] if e1 > f1 else direction[i, df]
            h_b[1 : u + 1] = h_c[1 : u + 1]
        if maxv >= score:
            break
        band_width *= 2

    # traceback (ssw.c:633-706)
    ops = []  # raw (count, code 0/1/2) reversed-order entries
    i = readLen - 1
    j = refLen - 1
    e = 0
    fcur = 0
    maxop = 0
    temp2 = 2
    while i > 0:
        x = max(i - band_width, 0)
        t1 = (j - x) * 3 + temp2
        d = direction[i, t1]
        if d == 1:
            i -= 1
            j -= 1
            temp2 = 2
            fcur = 0
        elif d == 2:
            i -= 1
            temp2 = 0
            fcur = 1
        elif d == 3:
            i -= 1
            temp2 = 2
            fcur = 1
        elif d == 4:
            j -= 1
            temp2 = 1
            fcur = 2
        elif d == 5:
            j -= 1
            temp2 = 2
            fcur = 2
        else:
            return None  # traceback error
        if fcur == maxop:
            e += 1
        else:
            ops.append((e, maxop))
            maxop = fcur
            e = 1
    if maxop == 0:
        ops.append((e + 1, 0))
    else:
        ops.append((e, maxop))
        ops.append((1, 0))
    ops.reverse()
    return [(c, "MID"[op]) for c, op in ops]


_NATIVE = None
_NATIVE_TRIED = False


def read_codes(read: np.ndarray, n: int) -> np.ndarray:
    """int8 read codes with every code outside 0..n-1 as n - 1, the N
    column.  An N on the reverse strand arrives as 3 - 4 (int8 -1, byte
    255); numpy's index -1 reads that column, and csrc/ssw_native.cpp
    maps such codes the same way."""
    codes = np.asarray(read).astype(np.uint8)
    return np.where(codes < n, codes, n - 1).astype(np.int8)


def _try_load_native():
    """salt_ssw_align of the port's host library (csrc/ssw_native.cpp):
    exact same semantics, ~10^3 faster than the lane emulation below.
    A failed build raises (utils/native.py)."""
    global _NATIVE, _NATIVE_TRIED
    if _NATIVE_TRIED:
        return _NATIVE
    _NATIVE_TRIED = True
    import ctypes

    from ..utils.native import load_native

    lib = load_native()
    if hasattr(lib, "salt_ssw_align"):
        fn = lib.salt_ssw_align
        c = ctypes
        fn.argtypes = [
            c.POINTER(c.c_int8), c.c_int, c.POINTER(c.c_int8), c.c_int,
            c.POINTER(c.c_int8), c.c_int, c.c_int, c.c_int, c.c_int,
            c.c_int, c.POINTER(c.c_int32), c.POINTER(c.c_uint32), c.c_int,
        ]
        fn.restype = c.c_int
        _NATIVE = fn
    return _NATIVE


def ssw_align_native(read, ref, mat, gapO, gapE, maskLen, want_cigar=True):
    import ctypes

    fn = _try_load_native()
    if fn is None:
        return None
    read = np.ascontiguousarray(read, dtype=np.int8)
    ref = np.ascontiguousarray(ref, dtype=np.int8)
    matc = np.ascontiguousarray(mat, dtype=np.int8)
    out = np.zeros(8, dtype=np.int32)
    cig = np.zeros(4096, dtype=np.uint32)
    p8 = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int8))
    rc = fn(
        p8(read), len(read), p8(ref), len(ref), p8(matc), matc.shape[0],
        gapO, gapE, maskLen, 1 if want_cigar else 0,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        cig.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), len(cig),
    )
    if rc != 0:
        return None
    ncig = int(out[7])
    cigar = None
    if want_cigar and ncig > 0:
        cigar = [(int(v >> 2), "MID"[v & 3]) for v in cig[:ncig]]
    elif want_cigar and ncig < 0:
        return None  # traceback error / overflow: fall back to python
    return SWResult(
        score1=int(out[0]), score2=int(out[1]),
        ref_begin1=int(out[2]), ref_end1=int(out[3]),
        read_begin1=int(out[4]), read_end1=int(out[5]),
        ref_end2=int(out[6]), cigar=cigar,
    )


def ssw_align(
    read: np.ndarray,      # int8 codes indexing `mat`
    ref: np.ndarray,
    mat: np.ndarray,       # (n, n) int8
    gapO: int,
    gapE: int,
    maskLen: int,
    want_cigar: bool = True,
    filters: int = 0,
    filterd: int = 0,
) -> SWResult:
    """ssw_align with flag=2 semantics (ssw.c:771-856) — always computes
    begin positions, returns cigar when score1 >= filters.

    Dispatches to the native library when present; the pure-numpy lane
    emulation below is the validation oracle and fallback."""
    r = ssw_align_native(read, ref, mat, gapO, gapE, maskLen, want_cigar)
    if r is not None:
        return r
    return ssw_align_py(read, ref, mat, gapO, gapE, maskLen, want_cigar,
                        filters, filterd)


def ssw_align_py(
    read: np.ndarray,      # int8 codes indexing `mat`
    ref: np.ndarray,
    mat: np.ndarray,       # (n, n) int8
    gapO: int,
    gapE: int,
    maskLen: int,
    want_cigar: bool = True,
    filters: int = 0,
    filterd: int = 0,
) -> SWResult:
    """Pure-numpy reference implementation (lane-exact SSE emulation)."""
    n = mat.shape[0]
    read = read_codes(read, n)
    bias = int(abs(min(0, mat.min())))
    readLen = len(read)
    refLen = len(ref)
    prof = _qp_byte(read, mat, n, bias)
    best, second = _sw_byte(ref, 0, refLen, readLen, gapO, gapE, prof, 0xFF, bias, maskLen)
    word = False
    if best[0] == 255:
        profw = _qp_word(read, mat, n)
        best, second = _sw_word(ref, 0, refLen, readLen, gapO, gapE, profw, 0xFFFF, maskLen)
        word = True
    score1, ref_end1, read_end1 = best
    score2, ref_end2 = second[0], second[1]
    if maskLen < 15:
        score2, ref_end2 = 0, -1

    # reverse pass for begin positions
    read_rev = read[: read_end1 + 1][::-1].copy()
    if not word:
        profr = _qp_byte(read_rev, mat, n, bias)
        bestr, _ = _sw_byte(ref, 1, ref_end1 + 1, read_end1 + 1, gapO, gapE, profr, score1, bias, maskLen)
    else:
        profr = _qp_word(read_rev, mat, n)
        bestr, _ = _sw_word(ref, 1, ref_end1 + 1, read_end1 + 1, gapO, gapE, profr, score1, maskLen)
    ref_begin1 = bestr[1]
    read_begin1 = read_end1 - bestr[2]

    cigar = None
    if want_cigar and score1 >= filters:
        rl = ref_end1 - ref_begin1 + 1
        ql = read_end1 - read_begin1 + 1
        bw = abs(rl - ql) + 1
        cigar = _banded_sw(
            ref[ref_begin1 : ref_end1 + 1], read[read_begin1 : read_end1 + 1],
            rl, ql, score1, gapO, gapE, bw, mat,
        )
    return SWResult(
        score1=score1, score2=score2,
        ref_begin1=ref_begin1, ref_end1=ref_end1,
        read_begin1=read_begin1, read_end1=read_end1,
        ref_end2=ref_end2, cigar=cigar,
    )
