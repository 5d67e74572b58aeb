"""Device-resident index arrays derived from a host SaltIndex (full
suffix-array mode).  Port of salt_tpu/pipeline/device_index.py.

Every table comes from salt_tpu's host index construction and is
copied to the device once.  uint32 tables are stored as int32 tensors holding
the same bits (ops/uint.py).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..index.build import SaltIndex

from ..ops.rank import RankIndex, build_rank_index
from ..ops.uint import u32_table


@dataclass
class DeviceIndex:
    ri_c: RankIndex        # C-part rank structure (5 symbols incl. sentinel)
    ri_r: RankIndex        # R-part rank structure (6 symbols incl. sentinel)
    lkt: torch.Tensor      # uint32 bits [4^12+1] C 12-mer prefix sums
    r_lkt_sp: torch.Tensor # uint32 bits [4^12] exact R 12-mer intervals
    r_lkt_ep: torch.Tensor
    sa_cat: torch.Tensor   # uint32 bits [c_sa_len + T+1]: csa ++ r_coord,
                           # so locate is one gather per slot
    mixref_words: torch.Tensor  # uint32 bits [ceil(L/8)+2], 8 one-hot
                                # nibbles per word, little-endian
    l_pac: int
    l_seed: int
    c_sa_len: int          # length of the csa part within sa_cat


def pack_nibbles(mixref: np.ndarray) -> np.ndarray:
    """uint8 nibbles -> uint32 words, little-endian within the word
    (the mixRef pac layout, metaref.c:54-56)."""
    n = len(mixref)
    W = (n + 7) // 8 + 2
    padded = np.zeros(W * 8, dtype=np.uint32)
    padded[:n] = mixref
    words = np.zeros(W, dtype=np.uint32)
    for j in range(8):
        words |= padded[j::8] << np.uint32(4 * j)
    return words


def canonical_r_lkt(sp: np.ndarray, ep: np.ndarray):
    """The R 12-mer interval tables with every absent k-mer (width
    ep - sp + 1 == 0 mod 2^32) stored as the empty interval (1, 0), as
    salt_tpu's device-built tables store it.  Seeding reads only sp, ep
    and liveness, so this changes no alignment."""
    alive = (ep - sp + np.uint32(1)) != 0
    return (np.where(alive, sp, 1).astype(np.uint32),
            np.where(alive, ep, 0).astype(np.uint32))


def to_device_index(idx: SaltIndex, device) -> DeviceIndex:
    if idx.r_lkt_sp is None:
        raise ValueError("index missing r_lkt tables; rebuild with current "
                         "version")
    dev = torch.device(device)
    r_lkt_sp, r_lkt_ep = canonical_r_lkt(idx.r_lkt_sp, idx.r_lkt_ep)
    return DeviceIndex(
        ri_c=build_rank_index(idx.cbwt, np.append(idx.c_l2, 0)).to(dev),
        ri_r=build_rank_index(idx.rbwt, np.append(idx.r_cumfreq, 0)).to(dev),
        lkt=u32_table(idx.lkt).to(dev),
        r_lkt_sp=u32_table(r_lkt_sp).to(dev),
        r_lkt_ep=u32_table(r_lkt_ep).to(dev),
        sa_cat=u32_table(np.concatenate([idx.csa, idx.r_coord])).to(dev),
        mixref_words=u32_table(pack_nibbles(idx.mixref)).to(dev),
        l_pac=idx.l_pac,
        l_seed=idx.l_seed,
        c_sa_len=len(idx.csa),
    )
