"""Single-end alignment pipeline: batched device steps.  Port of
salt_tpu/pipeline/se.py.

Mirrors alnse_overlap_alt (Align_src/alnse.c:1045-1104): seed both
strands, locate, ungapped check with the shrinking threshold, and — only
for reads with no ungapped hit on either strand — the gapped
Landau-Vishkin check (alnse_check_withgap, alnse.c:871-901).

Verification is compacted to the first `u` unique in-range candidates
per read; reads with more are flagged and re-run at full width by the
engine, so the result stays reference-exact.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..constants import GAP_WINDOW_PAD, NOGAP_MAX_DIFF

from ..ops.locate import Loci, locate, sort_loci
from ..ops.lv import lv_distance_batch
from ..ops.cuda_build import MAX_READ_LEN
from ..ops.seed import seed_overlap
from ..ops.uint import U32
from ..utils.metrics import stage
from ..ops.verify import (
    SEResult,
    StrandVerify,
    checked_mask,
    compact_loci,
    mismatch_counts_packed,
    replay_and_select,
    shift_prev,
)
from .device_index import DeviceIndex


class UngappedOut(NamedTuple):
    res: SEResult
    needs_gap: torch.Tensor  # bool (B,)
    overflow: torch.Tensor   # bool (B,) verify or locate truncated; the
                             # engine re-runs such reads at full width
    loci0: Loci
    loci1: Loci


class GappedOut(NamedTuple):
    res: SEResult
    overflow: torch.Tensor


def pack_result(res: SEResult, extra=()) -> torch.Tensor:
    """Flatten an SEResult (+ (B,) extra flags) into one int64 matrix so
    the host needs a single device->host copy.  Layout: [found, pos,
    strand, n_diff, n_hits(2), first_hit_ndiff(2), hits_pos(2K),
    hits_ndiff(2K), extras...]."""
    B = res.found.shape[0]
    cols = [
        res.found[:, None],
        res.pos[:, None],
        res.strand[:, None],
        res.n_diff[:, None],
        res.n_hits,
        res.first_hit_ndiff,
        res.hits_pos.reshape(B, -1),
        res.hits_ndiff.reshape(B, -1),
    ]
    cols.extend(e[:, None] for e in extra)
    return torch.cat([c.long() for c in cols], 1)


def unpack_result(arr: np.ndarray, k_hits: int) -> dict:
    """numpy view of a pack_result matrix -> dict of arrays."""
    K = k_hits
    B = arr.shape[0]
    return {
        "found": arr[:, 0].astype(bool),
        "pos": arr[:, 1].astype(np.uint32),
        "strand": arr[:, 2],
        "n_diff": arr[:, 3],
        "n_hits": arr[:, 4:6],
        "first_hit_ndiff": arr[:, 6:8],
        "hits_pos": arr[:, 8 : 8 + 2 * K].reshape(B, 2, K).astype(np.uint32),
        "hits_ndiff": arr[:, 8 + 2 * K : 8 + 4 * K].reshape(B, 2, K),
        "n_extra": arr[:, 8 + 4 * K :],
    }


def _halves(tup, B):
    return (type(tup)(*(a[:B] for a in tup)), type(tup)(*(a[B:] for a in tup)))


def _cat_loci(loci0: Loci, loci1: Loci) -> Loci:
    return Loci(*(torch.cat([a, b], 0) for a, b in zip(loci0, loci1)))


def se_ungapped(
    dix: DeviceIndex,
    seq_f: torch.Tensor,    # (B, L) forward codes
    seq_r: torch.Tensor,    # (B, L) reverse-complement codes
    l_overlap: int,
    max_seed: int,
    max_locate: int,
    cap: int,
    u: int = 64,
    k_hits: int = 16,
    pe_mode: bool = False,
    sampled=None,           # SampledSA: locate by LF walks (sampled mode)
    chunk: int = None,      # locate column-block size (ops/locate.py)
) -> UngappedOut:
    """Seed + locate + sort, compact + word-packed mismatch counts, then
    threshold replay, with both strands in one (2B, ...) batch; spans
    device.seed, device.locate and device.verify."""
    B, L = seq_f.shape
    if L > MAX_READ_LEN:
        raise ValueError(f"reads longer than {MAX_READ_LEN}bp unsupported")
    seq2 = torch.cat([seq_f, seq_r], 0).long()
    with stage("device.seed"):
        c_seeds, r_seeds = seed_overlap(
            dix.ri_c, dix.ri_r, dix.lkt, seq2, dix.l_seed, l_overlap,
            max_seed, r_lkt_sp=dix.r_lkt_sp, r_lkt_ep=dix.r_lkt_ep,
        )
    with stage("device.locate"):
        lo = locate(c_seeds, r_seeds, dix.sa_cat, dix.c_sa_len, L, dix.l_pac,
                    max_locate, cap, pe_mode=pe_mode, sampled=sampled,
                    ri_c=dix.ri_c, ri_r=dix.ri_r, chunk=chunk)
    with stage("device.verify"):
        lc = sort_loci(lo.loci)
        pos, keep, ovf = compact_loci(lc, checked_mask(lc, dix.l_pac), u)
        v = mismatch_counts_packed(dix.mixref_words, pos, keep, seq2,
                                   NOGAP_MAX_DIFF + 1)
        v0, v1 = _halves(v, B)
        ovf = ovf | lo.overflow
        res = replay_and_select(v0, v1, NOGAP_MAX_DIFF, k_hits)
        loci0, loci1 = _halves(lc, B)
    return UngappedOut(res=res, needs_gap=~res.found,
                       overflow=ovf[:B] | ovf[B:], loci0=loci0, loci1=loci1)


def se_ungapped_full(
    dix: DeviceIndex,
    seq_f: torch.Tensor,
    seq_r: torch.Tensor,
    loci0: Loci,
    loci1: Loci,
    k_hits: int = 16,
) -> SEResult:
    """Full-width verify for reads whose unique-candidate count exceeded
    the compact width.  Reuses located loci."""
    B = seq_f.shape[0]
    with stage("device.verify"):
        seq2 = torch.cat([seq_f, seq_r], 0).long()
        lc = _cat_loci(loci0, loci1)
        pos, keep, _ = compact_loci(lc, checked_mask(lc, dix.l_pac),
                                    lc.pos.shape[-1])
        v = mismatch_counts_packed(dix.mixref_words, pos, keep, seq2,
                                   NOGAP_MAX_DIFF + 1)
        return replay_and_select(*_halves(v, B), NOGAP_MAX_DIFF, k_hits)


def _gapped_checked(loci: Loci, L: int, l_mref: int) -> torch.Tensor:
    """Skip rule of alnse_check_withgap (alnse.c:894), uint32 wraparound."""
    end_u = (loci.pos + L + GAP_WINDOW_PAD) & U32
    return loci.pushed & (loci.pos != shift_prev(loci.pos)) & (end_u < l_mref)


def _gapped_verify(dix: DeviceIndex, loci: Loci, seq: torch.Tensor, u: int,
                   k: int):
    B, L = seq.shape
    pos, keep, ovf = compact_loci(loci, _gapped_checked(loci, L, dix.l_pac), u)
    end_u = (pos + L + GAP_WINDOW_PAD) & U32
    in_ref = keep & (pos <= dix.l_pac) & (end_u <= dix.l_pac)
    # the kernel on CUDA tensors, its plain version on CPU tensors
    d = lv_distance_batch(
        dix.mixref_words, pos.reshape(-1), in_ref.reshape(-1),
        seq.repeat_interleave(u, 0), k, text_words=True,
    ).reshape(B, u).long()
    counts = torch.where(keep, torch.clamp(d, max=k + 1), 255)
    return StrandVerify(counts=counts, checked=keep, pos=pos), ovf


def se_gapped(
    dix: DeviceIndex,
    seq_f: torch.Tensor,   # (Bg, L) uint8
    seq_r: torch.Tensor,
    loci0: Loci,           # (Bg, CAP) sorted
    loci1: Loci,
    k: int,
    u: int = 64,
    k_hits: int = 16,
) -> GappedOut:
    """Gapped (Landau-Vishkin) check of both strands."""
    Bg = seq_f.shape[0]
    v, ovf = _gapped_verify(dix, _cat_loci(loci0, loci1),
                            torch.cat([seq_f, seq_r], 0), u, k)
    res = replay_and_select(*_halves(v, Bg), k, k_hits)
    return GappedOut(res=res, overflow=ovf[:Bg] | ovf[Bg:])
