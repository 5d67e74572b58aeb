"""Batched BWT rank (occ) queries as bit-plane gathers.

Port of salt_tpu/ops/rank.py.  Per symbol c the index keeps a bit-plane
(one bit per BWT position) fused with the exclusive count at every
32-bit word boundary, so a rank query is one row gather plus a popcount.

rank_excl(idx, c) = #occurrences of c in bwt[0 .. idx-1].
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from .uint import U32, popcount32, take


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
    W = (n + 2 + 31) // 32 + 1  # rank queries at idx up to n+1
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
