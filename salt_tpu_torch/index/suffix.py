"""Suffix-array construction for index building.

The reference constructs its BWTs with the incremental BWT-SW algorithm
(Index_src/bwt_gen.c, 4bit_bwt_gen.c, QSufSort.c).  We instead build a
plain suffix array (text + implicit terminal sentinel, sentinel smallest)
and derive BWT/rank tables from it — same outputs, simpler and fully
vectorizable.

Two engines:
  * a numpy prefix-doubling sort (always available),
  * the C++ SA-IS of csrc/sais.cpp for large genomes, loaded via ctypes
    and built at first use (utils/native.py).
"""

from __future__ import annotations

import ctypes

import numpy as np

_SAIS = None
_SAIS_TRIED = False
BWT_CHUNK = 1 << 26      # SA rows a step of bwt_from_sa


def _try_load_sais():
    global _SAIS, _SAIS_TRIED
    if _SAIS_TRIED:
        return _SAIS
    _SAIS_TRIED = True
    from ..utils.native import load_native

    lib = load_native()
    if hasattr(lib, "salt_sais_u8"):
        lib.salt_sais_u8.argtypes = [
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64,
        ]
        lib.salt_sais_u8.restype = ctypes.c_int
        if hasattr(lib, "salt_sais_u8_i32"):
            lib.salt_sais_u8_i32.argtypes = [
                ctypes.POINTER(ctypes.c_uint8),
                ctypes.POINTER(ctypes.c_int32),
                ctypes.c_int64,
            ]
            lib.salt_sais_u8_i32.restype = ctypes.c_int
        if hasattr(lib, "salt_sais_u8_u32"):
            lib.salt_sais_u8_u32.argtypes = [
                ctypes.POINTER(ctypes.c_uint8),
                ctypes.POINTER(ctypes.c_uint32),
                ctypes.c_int64,
            ]
            lib.salt_sais_u8_u32.restype = ctypes.c_int
        _SAIS = lib
    return _SAIS


def suffix_array(text: np.ndarray) -> np.ndarray:
    """Suffix array of `text + [sentinel]` where the sentinel is smaller
    than every symbol.  Returns positions of length len(text)+1;
    sa[0] == len(text) always (the sentinel suffix).  dtype is int32 for
    texts under 2^31 symbols (halves index-build peak RSS), int64 above
    (monolithic >2GB-base genomes; the sharded-by-bin build keeps each
    shard under 2^31 so GRCh38-scale stays int32 per shard).

    `text` must be a uint8 array of small symbol codes (0..250ish).
    """
    n = len(text)
    lib = _try_load_sais()
    if lib is not None and n > 1 << 16:
        if n + 1 < (1 << 31) and hasattr(lib, "salt_sais_u8_i32"):
            dt, fname, cptr = np.int32, "salt_sais_u8_i32", ctypes.c_int32
        elif n + 1 < (1 << 32) - 1 and hasattr(lib, "salt_sais_u8_u32"):
            # whole-genome scale (GRCh38 ~3.1G): uint32 storage halves
            # the SA-IS working set vs int64 (~40GB total at 3.1G)
            dt, fname, cptr = np.uint32, "salt_sais_u8_u32", ctypes.c_uint32
        else:
            dt, fname, cptr = np.int64, "salt_sais_u8", ctypes.c_int64
        sa = np.empty(n + 1, dtype=dt)
        sa[0] = n
        if n > 0:
            body = np.ascontiguousarray(text, dtype=np.uint8)
            # written in place: sa[1:] is contiguous (no second SA-sized
            # array, 12 GB at 3.1 G)
            rc = getattr(lib, fname)(
                body.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                sa[1:].ctypes.data_as(ctypes.POINTER(cptr)),
                np.int64(n),
            )
            if rc != 0:
                raise RuntimeError("salt_sais failed")
        return sa
    sa = _suffix_array_doubling(text)
    return sa.astype(np.int32) if n + 1 < (1 << 31) else sa


def _suffix_array_doubling(text: np.ndarray) -> np.ndarray:
    n = len(text)
    if n == 0:
        return np.zeros(1, dtype=np.int64)
    # rank 0 reserved for the sentinel; shift real symbols by +1
    rank = np.zeros(n + 1, dtype=np.int64)
    rank[:n] = text.astype(np.int64) + 1
    k = 1
    idx = np.arange(n + 1, dtype=np.int64)
    while True:
        second = np.zeros(n + 1, dtype=np.int64)
        src = idx + k
        valid = src <= n
        second[valid] = rank[src[valid]]
        order = np.lexsort((second, rank))
        new_rank = np.zeros(n + 1, dtype=np.int64)
        key_r = rank[order]
        key_s = second[order]
        neq = np.ones(n + 1, dtype=np.int64)
        neq[1:] = (key_r[1:] != key_r[:-1]) | (key_s[1:] != key_s[:-1])
        ranks_sorted = np.cumsum(neq) - 1
        new_rank[order] = ranks_sorted
        rank = new_rank
        if ranks_sorted[-1] == n:
            return order
        k <<= 1


def bwt_from_sa(text: np.ndarray, sa: np.ndarray, sentinel_code: int) -> tuple[np.ndarray, int]:
    """BWT symbol array over text+sentinel, keeping the sentinel in-band.

    Returns (bwt_syms, primary) where bwt_syms[r] = text[sa[r]-1] for
    sa[r] > 0 and bwt_syms[primary] = sentinel_code for the row with
    sa[r] == 0.  `primary` equals the reference's inverseSa0 / bwt->primary.
    """
    if len(text) == 0:  # zero-SNP index: R text is just the sentinel
        return np.array([sentinel_code], dtype=np.uint8), 0
    # unsigned-safe (sa may be uint32 at whole-genome scale): clamp the
    # primary row instead of testing prev < 0; BWT_CHUNK rows at a time,
    # so the temporaries stay small next to the SA
    bwt = np.empty(len(sa), dtype=np.uint8)
    primary = -1
    chunk = BWT_CHUNK
    for r0 in range(0, len(sa), chunk):
        part = sa[r0 : r0 + chunk]
        at0 = part == 0
        if primary < 0 and at0.any():
            primary = r0 + int(np.argmax(at0))
        bwt[r0 : r0 + chunk] = text[np.where(at0, 0, part - 1)]
    bwt[primary] = sentinel_code
    return bwt, primary
