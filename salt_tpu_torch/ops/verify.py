"""Batched candidate verification and best-hit selection.  Port of
salt_tpu/ops/verify.py.

Ungapped check (alnse_check_nogap, Align_src/alnse.c:734-782): per
candidate, count read bases whose one-hot code ANDs to zero against the
4-bit mixRef nibble, exact up to the ungapped threshold and clamped
above it.

The reference scans sorted candidates strand 0 then strand 1 with a
shrinking threshold (alnse.c:348-369, 1079-1083), replayed in vector
form:

  t_i   = min(max_diff, exclusive-prefix-min of checked counts)
  hit_i = checked_i and counts_i <= t_i

and the primary is the winning strand's first-minimum hit, where a
strand-1 hit always displaces an equal strand-0 best (the C code resets
`flag_match` per strand, alnse.c:412,751).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .locate import Loci
from .uint import U32, popcount32, take_u32

NT2BIT = (1, 2, 4, 8, 15)
BIG = 255


class StrandVerify(NamedTuple):
    counts: torch.Tensor   # int64 (B, CAP) clamped mismatch counts
    checked: torch.Tensor  # bool  (B, CAP) in-range, deduped
    pos: torch.Tensor      # int64 (B, CAP) uint32 sorted positions


class SEResult(NamedTuple):
    found: torch.Tensor        # bool (B,)
    pos: torch.Tensor          # int64 (B,) uint32
    strand: torch.Tensor       # int64 (B,)
    n_diff: torch.Tensor       # int64 (B,)
    # per-strand hit lists (sorted-candidate order), first K compacted
    hits_pos: torch.Tensor     # int64 (B, 2, K) uint32
    hits_ndiff: torch.Tensor   # int64 (B, 2, K)
    n_hits: torch.Tensor       # int64 (B, 2) total hits (may exceed K)
    first_hit_ndiff: torch.Tensor  # int64 (B, 2) n_diff of each strand's a[0]


def shift_prev(pos: torch.Tensor) -> torch.Tensor:
    """pos shifted right by one slot, UINT32_MAX in front."""
    return torch.cat([torch.full_like(pos[:, :1], U32), pos[:, :-1]], 1)


def checked_mask(loci: Loci, l_mref: int) -> torch.Tensor:
    """In-range + adjacent-dedup mask over sorted loci (alnse.c:762)."""
    return loci.pushed & (loci.pos < l_mref) & (loci.pos != shift_prev(loci.pos))


def _first_k(mask: torch.Tensor, k: int):
    """Source index of the 1st..k-th set slot of each row, whether it
    exists, and the row's set count."""
    csum = torch.cumsum(mask.long(), -1)
    ranks = torch.arange(1, k + 1, device=mask.device).expand(mask.shape[0], k)
    src = torch.searchsorted(csum, ranks.contiguous())
    src = src.clamp(max=mask.shape[-1] - 1)
    n = csum[:, -1]
    return src, ranks <= n[:, None], n


def compact_loci(loci: Loci, checked: torch.Tensor, u: int):
    """Keep the first `u` checked slots per read, in order.
    Returns (pos (B,u), keep (B,u), overflow (B,))."""
    src, keep, n_checked = _first_k(checked, u)
    pos = torch.where(keep, torch.gather(loci.pos, 1, src), U32)
    # a checked pos of exactly 0xFFFFFFFF is conflated with the absent
    # sentinel; its count is unobservable either way (salt_tpu does so)
    return pos, pos != U32, n_checked > u


def mismatch_counts_packed(
    mixref_words: torch.Tensor,  # uint32 bits, 8 little-endian nibbles per word
    pos: torch.Tensor,           # int64 (B, U) compacted candidate positions
    keep: torch.Tensor,          # bool (B, U)
    seq: torch.Tensor,           # (B, L) codes for this strand
    clamp: int,
) -> StrandVerify:
    """Word-packed ed_mismatch: ~L/8 reference words per candidate,
    ANDed with the read's one-hot pattern packed at the candidate's
    nibble alignment (8 alignments packed once per read), any-bit per
    nibble folded to bit 0, masked with 0x11111111 and popcounted.
    Pattern nibbles outside the read are zero, so the mismatch count is
    L - matches."""
    B, U = pos.shape
    L = seq.shape[-1]
    NW = (L + 7 + 7) // 8 + 1          # words covering any alignment
    dev = pos.device
    base = torch.where(keep, pos, 0) & U32
    widx = (base >> 3)[..., None] + torch.arange(NW, device=dev)
    words = take_u32(mixref_words, widx)                   # (B, U, NW)

    bits = torch.tensor(NT2BIT, device=dev)[seq.long().clamp(0, 4)]  # (B, L)
    # pattern nibble stream at alignment a: bits[b, j - a] inside the read
    rel = (torch.arange(NW * 8, device=dev)[None, :]
           - torch.arange(8, device=dev)[:, None])
    inside = (rel >= 0) & (rel < L)
    pat8 = torch.where(inside, bits[:, rel.clamp(0, L - 1)], 0)     # (B, 8, NP)
    sh = torch.arange(8, device=dev) * 4
    pat8w = (pat8.view(B, 8, NW, 8) << sh).sum(-1)          # (B, 8, NW)

    align = (base & 7)[..., None].expand(B, U, NW)
    x = words & torch.gather(pat8w, 1, align)
    t = x | (x >> 1)
    t = (t | (t >> 2)) & 0x11111111
    matches = popcount32(t).sum(-1)
    counts = torch.where(keep, torch.clamp(L - matches, max=clamp), BIG)
    return StrandVerify(counts=counts, checked=keep, pos=pos)


def replay_and_select(
    v0: StrandVerify,
    v1: StrandVerify,
    max_diff0: int,
    k_hits: int,
) -> SEResult:
    """Sequential threshold replay over strand-0-then-strand-1 candidates
    and primary selection."""
    CAP = v0.counts.shape[1]
    counts = torch.cat([v0.counts, v1.counts], -1)
    checked = torch.cat([v0.checked, v1.checked], -1)
    run_min = torch.cummin(torch.clamp(counts, max=BIG), -1).values
    excl_min = torch.cat([torch.full_like(run_min[:, :1], BIG), run_min[:, :-1]], -1)
    hit = checked & (counts <= torch.clamp(excl_min, max=max_diff0))
    hits = (hit[:, :CAP], hit[:, CAP:])

    def strand_best(v, hs):
        val = torch.where(hs, v.counts, BIG).min(-1).values
        first = torch.argmax((hs & (v.counts == val[:, None])).byte(), -1)
        return hs.any(-1), val, torch.gather(v.pos, 1, first[:, None])[:, 0]

    has0, val0, pos0 = strand_best(v0, hits[0])
    has1, val1, pos1 = strand_best(v1, hits[1])
    found = has0 | has1
    # strand 1's first hit displaces an equal strand-0 best (flag reset)
    best_val = torch.where(has1, val1, val0)
    best_pos = torch.where(has1, pos1, pos0)

    def compact(hs, v):
        src, hsel, n = _first_k(hs, k_hits)
        hp = torch.where(hsel, torch.gather(v.pos, 1, src), U32)
        hn = torch.where(hsel, torch.gather(v.counts, 1, src), BIG)
        a0 = torch.gather(v.counts, 1, torch.argmax(hs.byte(), -1)[:, None])[:, 0]
        return hp, hn, n, torch.where(hs.any(-1), a0, BIG)

    hp0, hn0, n0, fh0 = compact(hits[0], v0)
    hp1, hn1, n1, fh1 = compact(hits[1], v1)
    return SEResult(
        found=found,
        pos=torch.where(found, best_pos, U32),
        strand=has1.long(),
        n_diff=torch.where(found, best_val, BIG),
        hits_pos=torch.stack([hp0, hp1], 1),
        hits_ndiff=torch.stack([hn0, hn1], 1),
        n_hits=torch.stack([n0, n1], 1),
        first_hit_ndiff=torch.stack([fh0, fh1], 1),
    )
