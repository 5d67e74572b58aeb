"""Batched BWT rank (occ) queries as bit-plane gathers.

Port of salt_tpu/ops/rank.py.  Per symbol c the index keeps a bit-plane
(one bit per BWT position) fused with the exclusive count at every
32-bit word boundary, so a rank query is one row gather plus a popcount.

rank_excl(idx, c) = #occurrences of c in bwt[0 .. idx-1].

The planes are built on the device the index will live on, from the uint8
symbols sent a chunk at a time (rank_index_on, rank_index_pair_on: the
counterparts of salt_tpu's build_rank_index_device* and
build_rank_index_pair_device_chunked).  build_rank_index is the host
construction in numpy, kept as the reference those are held against.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from .uint import U32, as_i32, popcount32, take


@dataclass
class RankIndex:
    """bc:    int32 [n_sym * W, 2] per symbol plane and 32-symbol word,
                   plane-major: [..,0] exclusive count at the word start,
                   [..,1] the bit word (bit i = sym[32w+i] == c)
    cfreq: int64 [n_sym + 1] C-array: cfreq[c] = #symbols < c
    n:     number of symbols
    n_words: W
    row_off: row of this family's first plane within `bc`.  Two families
           can share one concatenated plane tensor (C rows first, then R
           rows, fuse_rank_index_pair), so that a per-lane mixed-family
           rank query is one gather (ops/locate.resolve_sampled) and the
           planes are held once; a standalone index keeps 0."""

    bc: torch.Tensor
    cfreq: torch.Tensor
    n: int
    n_words: int
    row_off: int = 0

    @property
    def n_sym(self) -> int:
        return self.cfreq.shape[0] - 1

    def to(self, device) -> "RankIndex":
        """This index on `device`.  Views that share one plane tensor go
        through rank_indexes_to together, which copies it once."""
        return rank_indexes_to(device, self)[0]


def rank_indexes_to(device, *ris: RankIndex):
    """The given indexes on `device`; a plane tensor that several of them
    share is copied once and stays shared."""
    moved = {}
    out = []
    for ri in ris:
        if id(ri.bc) not in moved:
            moved[id(ri.bc)] = ri.bc.to(device)
        out.append(replace(ri, bc=moved[id(ri.bc)],
                           cfreq=ri.cfreq.to(device)))
    return tuple(out)


def build_rank_index(syms: np.ndarray, cfreq: np.ndarray) -> RankIndex:
    """Host construction from a uint8 symbol array (sentinel in-band).

    `cfreq` is the (n_sym+1)-long cumulative count array of the
    non-sentinel symbols; the plane count n_sym is taken from it."""
    n = len(syms)
    n_sym = len(cfreq) - 1
    W = n_words(n)
    bc = np.zeros((n_sym, W, 2), dtype=np.int32)
    # pad with a non-symbol so pad bits stay 0 in every plane
    pad = np.full(W * 32, 255, dtype=np.uint8)
    pad[:n] = syms
    for c in range(n_sym):
        mask = pad == c
        bc[c, :, 1] = np.packbits(mask, bitorder="little").view("<i4")
        per_word = mask.reshape(W, 32).sum(axis=1, dtype=np.int64)
        bc[c, 1:, 0] = np.cumsum(per_word)[:-1]
    return RankIndex(
        bc=torch.from_numpy(bc.reshape(n_sym * W, 2)),
        cfreq=torch.from_numpy(np.asarray(cfreq).astype(np.int64)),
        n=n,
        n_words=W,
    )


# symbols past the end are sent as this code: its one-hot bit (6) is read
# by no plane of either family (5 and 6 symbols)
PAD_SYMBOL = 6
FLAG_BYTES = 0x0101010101010101     # bit 0 of each of the 8 bytes


def n_words(n: int) -> int:
    """Words a plane of n symbols: rank queries go up to n + 1."""
    return (n + 2 + 31) // 32 + 1


def chunk_words(device) -> int:
    """32-symbol words a chunk of the device builders.  Their transients
    are about 5 bytes a symbol of one chunk: some 300 MB at 2^26 symbols
    on a card; on the CPU a chunk of 2^21 symbols stays in cache."""
    return 1 << 16 if torch.device(device).type == "cpu" else 1 << 21


def host_chunk(a: np.ndarray, s0: int, s1: int, fill: int,
               device) -> torch.Tensor:
    """a[s0:s1] on `device`, `fill` past the end of `a`."""
    seg = torch.from_numpy(a[s0 : min(s1, len(a))])
    if len(seg) == s1 - s0:
        return seg.to(device)
    out = torch.full((s1 - s0,), fill, dtype=seg.dtype, device=device)
    out[: len(seg)] = seg
    return out


def flag_words(flags: torch.Tensor) -> torch.Tensor:
    """int64 [4m] holding a flag in bit 0 of each byte (others 0) -> int32
    [m] words, bit i of word w = flag 32w + i.  Three folds gather each
    value's 8 flags into its low byte (in place: `flags` is consumed); the
    bytes, little-endian, are the words, so bit 31 needs no signed
    arithmetic."""
    flags |= flags >> 7
    flags |= flags >> 14
    flags |= flags >> 28
    return (flags & 0xFF).to(torch.uint8).view(torch.int32)


def write_rows(rows: torch.Tensor, bits: torch.Tensor,
               carry: torch.Tensor) -> torch.Tensor:
    """rows int32 [m, 2] <- (exclusive count of set bits before each word,
    counted from `carry`, low 32 bits; the word).  Returns the count after
    the last word.  The count stays int64 across chunks: stored, it wraps
    as numpy's int64 cumsum stored into int32 wraps."""
    cnt = popcount32(bits.long())
    cum = torch.cumsum(cnt, 0)
    rows[:, 0] = as_i32(cum - cnt + carry)
    rows[:, 1] = bits
    return carry + cum[-1]


def build_planes(syms: np.ndarray, n_sym: int, bc: torch.Tensor, row0: int,
                 chunk: int = 0) -> None:
    """The n_sym planes of `syms` (uint8, sentinel in-band) written into
    bc[row0 : row0 + n_sym * W] on bc's device, bit-identical to
    build_rank_index.  The symbols go to the device `chunk` words at a
    time; each becomes its one-hot code 1 << sym, and plane c takes bit c
    of eight codes at once from their int64 view."""
    dev = bc.device
    W = n_words(len(syms))
    chunk = chunk or chunk_words(dev)
    carry = [torch.zeros((), dtype=torch.int64, device=dev)] * n_sym
    for w0 in range(0, W, chunk):
        w1 = min(w0 + chunk, W)
        codes = (1 << host_chunk(syms, 32 * w0, 32 * w1, PAD_SYMBOL, dev))
        codes = codes.view(torch.int64)
        for c in range(n_sym):
            flags = codes >> c
            flags &= FLAG_BYTES
            bits = flag_words(flags)
            r0 = row0 + c * W
            carry[c] = write_rows(bc[r0 + w0 : r0 + w1], bits, carry[c])


def _cfreq(cfreq, device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(cfreq).astype(np.int64)).to(device)


def rank_index_on(device, syms: np.ndarray, cfreq: np.ndarray,
                  chunk: int = 0) -> RankIndex:
    """build_rank_index's index, its planes built on `device`."""
    n_sym = len(cfreq) - 1
    W = n_words(len(syms))
    bc = torch.empty((n_sym * W, 2), dtype=torch.int32, device=device)
    build_planes(syms, n_sym, bc, 0, chunk)
    return RankIndex(bc=bc, cfreq=_cfreq(cfreq, device), n=len(syms),
                     n_words=W)


def rank_index_pair_on(device, syms_c: np.ndarray, cfreq_c: np.ndarray,
                       syms_r: np.ndarray, cfreq_r: np.ndarray,
                       chunk: int = 0):
    """Two indexes sharing one plane tensor on `device`, C rows first, as
    fuse_rank_index_pair lays them out: each family's planes are written
    straight into their rows (no concatenation)."""
    n_sym_c = len(cfreq_c) - 1
    Wc, Wr = n_words(len(syms_c)), n_words(len(syms_r))
    row_off = n_sym_c * Wc
    bc = torch.empty((row_off + (len(cfreq_r) - 1) * Wr, 2),
                     dtype=torch.int32, device=device)
    build_planes(syms_c, n_sym_c, bc, 0, chunk)
    build_planes(syms_r, len(cfreq_r) - 1, bc, row_off, chunk)
    return (RankIndex(bc=bc, cfreq=_cfreq(cfreq_c, device), n=len(syms_c),
                      n_words=Wc),
            RankIndex(bc=bc, cfreq=_cfreq(cfreq_r, device), n=len(syms_r),
                      n_words=Wr, row_off=row_off))


def fuse_rank_index_pair(ri_c: RankIndex, ri_r: RankIndex):
    """Two standalone indexes as two views of one concatenated plane
    tensor, C rows first: row_off of the R view is n_sym_c * W_c."""
    if ri_c.row_off or ri_r.row_off:
        raise ValueError("fuse_rank_index_pair takes standalone indexes")
    bc_cat = torch.cat([ri_c.bc, ri_r.bc], 0)
    return (replace(ri_c, bc=bc_cat),
            replace(ri_r, bc=bc_cat, row_off=ri_c.bc.shape[0]))


def planes_fused(ri_c: RankIndex, ri_r: RankIndex) -> bool:
    """Whether the two views share one plane tensor laid out as
    fuse_rank_index_pair lays it out."""
    return (ri_c.bc is ri_r.bc and ri_c.row_off == 0
            and ri_r.row_off == ri_c.n_sym * ri_c.n_words
            and ri_c.bc.shape[0] == ri_r.row_off + ri_r.n_sym * ri_r.n_words)


def rank_excl(ri: RankIndex, idx: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """#c in sym[0..idx-1].  `idx` is a rank in [0, n+1], read through
    uint32 like salt_tpu's wrapped int32 ranks."""
    iu = idx & U32
    row = take(ri.bc, ri.row_off + c * ri.n_words + (iu >> 5)).long()
    r = iu & 31
    mask = (1 << r) - 1
    return row[..., 0] + popcount32(row[..., 1] & mask)


def lf_step(ri: RankIndex, k: torch.Tensor, l: torch.Tensor, c: torch.Tensor):
    """One backward-search step; returns (k', l').  The interval is
    empty when ugt(k', l')."""
    base = take(ri.cfreq, c)
    return base + rank_excl(ri, k, c) + 1, base + rank_excl(ri, l + 1, c)
