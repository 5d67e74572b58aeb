"""Batched candidate location (alnse_locate_alt / alnse_locate,
Align_src/alnse.c:501-731).  Port of salt_tpu/ops/locate.py.

In full suffix-array mode each locate is one gather from the full SA /
coordinate table; in sampled mode it is a bounded LF walk to a sampled
rank (`resolve_sampled`: the CUDA kernel K4 on the card, one launch a
block of slots; `resolve_sampled_plain` on the CPU).  The reference's
sequential per-strand push cap is reproduced with prefix sums over a
fixed slot capacity, over all slots at once or block of columns by
block.  Seeds are ordered C first,
then R, each group stably by interval width (alnse.c:307-308).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..constants import MAX_LOC_POS
from ..utils.metrics import count, stage, to_host

from . import sa_walk_cuda
from .rank import planes_fused, rank_excl
from .seed import Seeds
from .uint import U32, as_i32, popcount32, take, take_u32, umin


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


def resolve_sampled(sampled, ri_c, ri_r, rank: torch.Tensor,
                    is_r: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """Rank -> coordinate (uint32 in int64) of every lane by bounded LF
    walks against the sampled tables: the CUDA kernel K4
    (ops/sa_walk_cuda.py, csrc/sa_walk.cu) on CUDA tensors, one launch a
    call; `resolve_sampled_plain` on CPU tensors.  The two agree on every
    lane."""
    if rank.is_cuda:
        return sa_walk_cuda.resolve_sampled_cuda(sampled, ri_c, ri_r, rank,
                                                 is_r, active)
    return resolve_sampled_plain(sampled, ri_c, ri_r, rank, is_r, active)


def resolve_sampled_plain(sampled, ri_c, ri_r, rank: torch.Tensor,
                          is_r: torch.Tensor,
                          active: torch.Tensor) -> torch.Tensor:
    """Rank -> coordinate (uint32 in int64) by bounded LF walks against
    the sampled tables (pipeline/device_index.SampledSA): both families
    walk to a flagged stop rank within intv - 1 steps.  Reproduces the
    full-table values on active lanes, UINT32_MAX at rank 0 (csa[0]'s
    quirk, and r_coord's sentinel rank) and at '#' positions included;
    reference/sa_walk.py walks salt's own structures to the same values.

    Ranks are uint32 carried in int64 (possibly as wrapped int32): every
    shift, mask, minimum and bound on them goes through `& U32`, so C
    texts of 2^31 ranks and more order correctly.  The C and R select,
    symbol and value tables are concatenated, so a step is one gather a
    structure with a per-lane family offset; when the two rank indexes
    share one plane tensor (rank.planes_fused) the rank query is one such
    gather too, else one a family.  The two branches agree bit for bit.

    salt_tpu ends its loop when every lane is done or after
    max(intv, max_r_walk) + 1 trips.  Here the loop always runs that many
    trips with done lanes masked, which gives the same values: asking the
    device each step whether any lane is left would cost a host
    synchronisation a step, more than the few masked steps it saves."""
    s = sampled
    n1c, n1r = ri_c.n, ri_r.n

    def by_family(r_val: int, c_val: int) -> torch.Tensor:
        return torch.where(is_r, r_val, c_val)

    bound = by_family(n1r - 1, n1c - 1)
    woff = by_family(s.c_words, 0)
    seloff = by_family(s.c_sel_rows, 0)
    sampoff = by_family(s.c_n_samples, 0)

    def sel_row(k):
        """(exclusive count, bit word as uint32) of rank k's select row."""
        row = take(s.sel_cat, ((k & U32) >> 5) + seloff).long()
        return row[..., 0], row[..., 1] & U32

    def is_done(k):
        return ((sel_row(k)[1] >> (k & 31)) & 1) == 1

    fused = planes_fused(ri_c, ri_r)
    k = umin(rank, bound)
    # rank 0, the sentinel's suffix, holds UINT32_MAX in both full tables
    # whatever a walk from it would read; no seed interval reaches it
    at_sentinel = active & (k == 0)
    done = ~active | is_done(k)
    steps = torch.zeros_like(k)
    # the trip bound ends the walk of degenerate lanes too (a zero-SNP
    # index has no R stop rank at all)
    for _ in range(max(int(s.intv), int(s.max_r_walk)) + 1):
        ku = k & U32
        word = take_u32(s.syms_cat, (ku >> 3) + woff)
        sym = (word >> ((ku & 7) * 4)) & 15
        symc, symr = sym.clamp(max=4), sym.clamp(max=5)
        if fused:
            # one rank gather: per-lane (family, symbol, word) row of the
            # shared planes; the arithmetic of rank_excl
            iu = torch.where(is_r, umin(k, n1r), umin(k, n1c)) & U32
            row = take(ri_c.bc, torch.where(
                is_r, ri_r.row_off + symr * ri_r.n_words,
                symc * ri_c.n_words) + (iu >> 5)).long()
            cnt = row[..., 0] + popcount32(row[..., 1] & ((1 << (iu & 31)) - 1))
            base = torch.where(is_r, take(ri_r.cfreq, sym.clamp(max=6)),
                               take(ri_c.cfreq, sym.clamp(max=5)))
            kn = base + cnt + 1
        else:
            kc = take(ri_c.cfreq, sym.clamp(max=5)) + rank_excl(
                ri_c, umin(k, n1c), symc) + 1
            kr = take(ri_r.cfreq, sym.clamp(max=6)) + rank_excl(
                ri_r, umin(k, n1r), symr) + 1
            kn = torch.where(is_r, kr, kc)
        # the sum wraps mod 2^32 inside umin, before the minimum
        k = torch.where(done, k, umin(kn, bound))
        steps = steps + (~done).long()
        done = done | is_done(k)

    excl, bits = sel_row(k)
    slot = excl + popcount32(bits & ((1 << (k & 31)) - 1)) + sampoff
    val = take_u32(s.samples_cat, slot)
    on_sharp = (k >= s.sharp_lo) & (k < s.sharp_hi)
    # a candidate on a '#': the full table holds UINT32_MAX there
    return torch.where(at_sentinel | (is_r & (steps == 0) & on_sharp), U32,
                       (val + steps) & U32)


def sa_gather_index(rank: torch.Tensor, is_r: torch.Tensor, c_sa_len: int,
                    n_cat: int) -> torch.Tensor:
    """Row of sa_cat (csa ++ r_coord) holding a rank's value.  The rank is
    uint32, carried as a wrapped int32: a C rank of a text of 2^31
    symbols or more reads as negative and is taken back through `& U32`
    (salt_tpu clips the int32, which sends it to row 0).  Each family is
    clamped into its own part."""
    ru = rank & U32
    return torch.where(is_r, ru.clamp(max=n_cat - c_sa_len - 1) + c_sa_len,
                       ru.clamp(max=c_sa_len - 1))


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
    sampled=None,           # SampledSA: LF-walk locate instead of sa_cat
    ri_c=None,
    ri_r=None,
    chunk=None,             # columns a block; None: 128 in sampled mode,
                            # all slots at once in full mode; <= 0: all
) -> LocateOut:
    """Located candidate positions per read, in seed-stream order.

    SE flavor (alnse_locate_alt), uint32 arithmetic:
      C locus pushed  iff  uint32(pos + l_seq) <= l_mref          (:673)
      R locus pushed  iff  pos <= l_mref and uint32(pos+l_seq) <= l_mref  (:717)
    and pushes stop after `max_locate` of them (:678,:719).

    PE flavor (alnse_locate, pe_mode=True): each C seed is capped at
    max_locate ranks, R seeds wider than max_locate are subsampled with
    a deterministic stride, and the global cap is MAX_LOC_POS.

    With `chunk` columns a block, only blocks that hold a live slot of
    some read are resolved (live slots are a prefix of each row); the
    slots of the other blocks keep pos = 0xFFFFFFFF, pushed = False, which
    sort_loci keys like any unpushed slot.  It costs one read-back a call
    (the largest stream length) and pays in sampled mode, where a slot is
    a walk of up to intv LF steps."""
    B = c_seeds.sp.shape[0]
    dev = c_seeds.sp.device
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

    def slot_block(first: int, n: int):
        """(pos, valid_push) of the n slots from `first`."""
        # slot t belongs to the first seed whose inclusive cumsum exceeds t
        slots = (first + torch.arange(n, device=dev)).expand(B, n).contiguous()
        seed_idx = torch.searchsorted(cum, slots, right=True).clamp(
            max=cum.shape[1] - 1)

        def at(a):
            return torch.gather(a, 1, seed_idx)

        in_range = (slots < total[:, None]) & (slots < cap)
        rank = as_i32(at(fused) + slots * at(skip))
        slot_is_r = at(is_r)
        if sampled is not None:
            # rows x columns known on the host: no read-back, no launch
            count("sa_walk.blocks")
            count("sa_walk.slots", B * n)
            with stage("device.sa_walk"):
                sa_val = resolve_sampled(sampled, ri_c, ri_r, rank,
                                         slot_is_r, in_range)
        else:
            sa_val = take_u32(sa_cat, sa_gather_index(
                rank, slot_is_r, c_sa_len, sa_cat.shape[0]))
        pos = (sa_val - at(off)) & U32
        ok_c = ((pos + l_seq) & U32) <= l_mref  # uint32 wraparound, as in C
        ok_r = (pos <= l_mref) & ok_c
        return pos, in_range & torch.where(slot_is_r, ok_r, ok_c)

    push_cap = MAX_LOC_POS if pe_mode else max_locate
    if chunk is None:
        chunk = 128 if sampled is not None else 0
    if chunk <= 0 or cap <= chunk:
        pos, valid_push = slot_block(0, cap)
        n_before = torch.cumsum(valid_push.long(), 1)
        pushed = valid_push & (n_before <= push_cap)
        n_pushed = n_before[:, -1]
    else:
        n_blocks = -(-cap // chunk)
        pos = torch.full((B, n_blocks * chunk), U32, dtype=torch.long,
                         device=dev)
        pushed = torch.zeros((B, n_blocks * chunk), dtype=torch.bool,
                             device=dev)
        n_pushed = torch.zeros(B, dtype=torch.long, device=dev)
        need = min(int(to_host(total.max())), cap) if B else 0
        for first in range(0, need, chunk):
            blk = slice(first, first + chunk)
            pos[:, blk], valid_push = slot_block(first, chunk)
            # the push count runs on from the blocks before
            n_before = n_pushed[:, None] + torch.cumsum(valid_push.long(), 1)
            pushed[:, blk] = valid_push & (n_before <= push_cap)
            n_pushed = n_before[:, -1]
        pos, pushed = pos[:, :cap], pushed[:, :cap]
    # the stream exceeded CAP slots and the push cap was not reached:
    # only then could unmaterialized candidates have been pushed
    overflow = (total > cap) & (n_pushed < push_cap)
    return LocateOut(loci=Loci(pos=pos, pushed=pushed), overflow=overflow)


def sort_loci(loci: Loci) -> Loci:
    """Sort pushed loci ascending per read (ks_introsort, alnse.c:728).
    Un-pushed slots key as 0xFFFFFFFF; a pushed position of exactly
    0xFFFFFFFF is conflated with them, as in salt_tpu (it fails every
    later range check either way)."""
    key = torch.sort(torch.where(loci.pushed, loci.pos, U32), dim=1).values
    return Loci(pos=key, pushed=key != U32)
