"""Batched candidate location (alnse_locate_alt / alnse_locate,
Align_src/alnse.c:501-731), full suffix-array mode.  Port of the flat
path of salt_tpu/ops/locate.py.

Each locate is one gather from the full SA / coordinate table; the
reference's sequential per-strand push cap is reproduced with prefix
sums over a fixed slot capacity.  Seeds are ordered C first, then R,
each group stably by interval width (alnse.c:307-308).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..constants import MAX_LOC_POS

from .seed import Seeds
from .uint import U32, as_i32, take_u32


class Loci(NamedTuple):
    pos: torch.Tensor     # int64 (B, CAP) uint32 candidate positions
    pushed: torch.Tensor  # bool  (B, CAP) slot holds a pushed locus


class LocateOut(NamedTuple):
    loci: Loci
    overflow: torch.Tensor  # bool (B,) candidate stream exceeded CAP slots


def _family(seeds: Seeds, is_r: bool, pe_mode: bool, max_locate: int):
    """(sort key, candidate count, rank stride) per seed."""
    # ep - sp is mod-2^32 exact; the clamp at 2^28-1 keeps the count
    # arithmetic in int32 while a wrapped (negative) width stays empty
    width = torch.clamp(as_i32(seeds.ep - seeds.sp), max=2**28 - 1)
    one = torch.ones_like(width)
    if pe_mode and is_r:
        n_skip = torch.where(width > max_locate,
                             torch.clamp(width // max_locate, min=1), one)
        count = width // n_skip + 1
    elif pe_mode:
        n_skip = one
        count = torch.clamp(width + 1, max=max_locate)
    elif is_r:
        n_skip = torch.clamp((width + 1) // MAX_LOC_POS, min=1)
        count = width // n_skip + 1
    else:
        n_skip = one
        count = width + 1
    count = torch.where(seeds.valid, count, 0)
    fam = 2**28 if is_r else 0
    # valid C widths < valid R widths < invalid
    key = torch.where(seeds.valid, width + fam, 2**29 + fam)
    return key, count, n_skip


def locate(
    c_seeds: Seeds,
    r_seeds: Seeds,
    sa_cat: torch.Tensor,   # uint32 bits [c_sa_len + Tr+1]: csa ++ r_coord
    c_sa_len: int,
    l_seq: int,
    l_mref: int,
    max_locate: int,
    cap: int,
    pe_mode: bool = False,
) -> LocateOut:
    """Located candidate positions per read, in seed-stream order.

    SE flavor (alnse_locate_alt), uint32 arithmetic:
      C locus pushed  iff  uint32(pos + l_seq) <= l_mref          (:673)
      R locus pushed  iff  pos <= l_mref and uint32(pos+l_seq) <= l_mref  (:717)
    and pushes stop after `max_locate` of them (:678,:719).

    PE flavor (alnse_locate, pe_mode=True): each C seed is capped at
    max_locate ranks, R seeds wider than max_locate are subsampled with
    a deterministic stride, and the global cap is MAX_LOC_POS."""
    B = c_seeds.sp.shape[0]
    key_c, cnt_c, skip_c = _family(c_seeds, False, pe_mode, max_locate)
    key_r, cnt_r, skip_r = _family(r_seeds, True, pe_mode, max_locate)

    key, perm = torch.sort(torch.cat([key_c, key_r], 1), dim=1, stable=True)

    def order(a, b):
        return torch.gather(torch.cat([a, b], 1), 1, perm)

    sp = order(c_seeds.sp, r_seeds.sp)
    off = order(c_seeds.offset, r_seeds.offset)
    # per-seed counts clamp at cap+1: slot ownership below cap and the
    # overflow predicate (total > cap) are unchanged
    cnt = torch.clamp(order(cnt_c, cnt_r), max=cap + 1)
    skip = torch.clamp(order(skip_c, skip_r), max=2**19 - 1)
    is_r = (key & 2**28) != 0
    cum = torch.cumsum(cnt, 1)
    total = cum[:, -1]
    # rank = sp + (slot - cum_ex) * skip, as salt_tpu's int32 arithmetic
    fused = as_i32(sp - (cum - cnt) * skip)

    # slot t belongs to the first seed whose inclusive cumsum exceeds t
    slots = torch.arange(cap, device=cum.device).expand(B, cap).contiguous()
    seed_idx = torch.searchsorted(cum, slots, right=True).clamp(max=cum.shape[1] - 1)

    def at(a):
        return torch.gather(a, 1, seed_idx)

    rank = as_i32(at(fused) + slots * at(skip))
    slot_is_r = at(is_r)
    rank_c = rank.clamp(0, c_sa_len - 1)
    rank_r = rank.clamp(0, sa_cat.shape[0] - c_sa_len - 1) + c_sa_len
    sa_val = take_u32(sa_cat, torch.where(slot_is_r, rank_r, rank_c))
    pos = (sa_val - at(off)) & U32
    ok_c = ((pos + l_seq) & U32) <= l_mref      # uint32 wraparound, as in C
    ok_r = (pos <= l_mref) & ok_c
    valid_push = (slots < total[:, None]) & torch.where(slot_is_r, ok_r, ok_c)

    push_cap = MAX_LOC_POS if pe_mode else max_locate
    n_before = torch.cumsum(valid_push.long(), 1)
    pushed = valid_push & (n_before <= push_cap)
    # the stream exceeded CAP slots and the push cap was not reached:
    # only then could unmaterialized candidates have been pushed
    overflow = (total > cap) & (n_before[:, -1] < push_cap)
    return LocateOut(loci=Loci(pos=pos, pushed=pushed), overflow=overflow)


def sort_loci(loci: Loci) -> Loci:
    """Sort pushed loci ascending per read (ks_introsort, alnse.c:728).
    Un-pushed slots key as 0xFFFFFFFF; a pushed position of exactly
    0xFFFFFFFF is conflated with them, as in salt_tpu (it fails every
    later range check either way)."""
    key = torch.sort(torch.where(loci.pushed, loci.pos, U32), dim=1).values
    return Loci(pos=key, pushed=key != U32)
