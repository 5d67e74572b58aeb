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
    n_words: W"""

    bc: torch.Tensor
    cfreq: torch.Tensor
    n: int
    n_words: int

    @property
    def n_sym(self) -> int:
        return self.cfreq.shape[0] - 1

    def to(self, device) -> "RankIndex":
        return replace(self, bc=self.bc.to(device),
                       cfreq=self.cfreq.to(device))


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


def rank_excl(ri: RankIndex, idx: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """#c in sym[0..idx-1].  `idx` is a rank in [0, n+1], read through
    uint32 like salt_tpu's wrapped int32 ranks."""
    iu = idx & U32
    row = take(ri.bc, c * ri.n_words + (iu >> 5)).long()
    r = iu & 31
    mask = (1 << r) - 1
    return row[..., 0] + popcount32(row[..., 1] & mask)


def lf_step(ri: RankIndex, k: torch.Tensor, l: torch.Tensor, c: torch.Tensor):
    """One backward-search step; returns (k', l').  The interval is
    empty when ugt(k', l')."""
    base = take(ri.cfreq, c)
    return base + rank_excl(ri, k, c) + 1, base + rank_excl(ri, l + 1, c)
