"""Sharded-index SE/PE alignment engine: the full aligner (ungapped +
gapped LV + overflow re-runs + XA/SAM emission, and PE pairing on top)
running against an index sharded by reference bin over a list of devices.
Port of salt_tpu/parallel/sharded_engine.py.

Every shard runs the monolithic device steps (pipeline/se.py) against its
own sub-index; the per-shard survivor lists travel to devices[0], where
the same vectorized threshold replay the monolithic step uses merges
them, and the result plugs into the monolithic host finalize unchanged.
So the sharded path emits byte-identical SAM to the monolithic engine
wherever the reference's own caps don't truncate.

Merge exactness: each shard's replay (ops/verify.replay_and_select,
mirroring alnse.c:348-393) uses shard-local running thresholds >= the
global ones, so every monolithic survivor survives its own shard's
replay; re-running the replay over the position-sorted union reproduces
the monolithic hit lists exactly provided no shard truncated its K-wide
list.  Per-shard lists are kept at the verify width `u`, which bounds
survivors per strand per shard, so truncation cannot happen.

Device layout: shard s's sub-index lives on devices[s % len(devices)]
(sharded.stack_indexes); a read batch goes to every device; hit lists
(n_shards * B * 2 * u positions and counts, a few MB) travel to
devices[0], while the big per-shard locate streams stay on their own
device between the ungapped and the gapped step.  One process drives
every device; on one card the shards' steps are queued one after the
other on it.
"""

from __future__ import annotations

from typing import List

import torch

from ..constants import NOGAP_MAX_DIFF
from ..index.build import SaltIndex, build_index_from_data
from ..ops.uint import U32
from ..ops.verify import BIG, StrandVerify, replay_and_select
from ..pipeline.engine import (
    SEAligner,
    SEOptions,
    checked_options,
    loci_rows,
)
from ..pipeline.pe_engine import PEAligner, PEOptions
from ..pipeline.se import pack_result, se_gapped, se_ungapped, se_ungapped_full
from ..utils.metrics import to_host
from .sharded import (
    lift_to_global,
    partition_contigs_contiguous,
    shard_devices,
    stack_indexes,
)


def merged_replay(hpos: torch.Tensor, hnd: torch.Tensor, max_diff0: int,
                  k_hits: int):
    """Re-run the sequential threshold replay over the union of per-shard
    survivor lists.  hpos: (S, B, 2, K) int64 holding uint32 global
    coordinates (0xFFFFFFFF = empty); hnd: (S, B, 2, K).  Returns an
    SEResult."""
    S, B, _, K = hpos.shape
    cp = hpos.movedim(0, 2).reshape(B, 2, S * K)
    cn = hnd.movedim(0, 2).reshape(B, 2, S * K)
    # position-sort per strand, as unsigned: the int64 values, so a
    # position >= 2^31 sorts after the small ones and the sentinel last.
    # Equal real positions cannot span shards (disjoint bins), so
    # stability is only for determinism of sentinels.
    cp_s, order = torch.sort(cp, dim=2, stable=True)
    cn_s = torch.gather(cn, 2, order)
    valid = cp_s != U32

    def mk(s):
        return StrandVerify(
            counts=torch.where(valid[:, s], cn_s[:, s], BIG),
            checked=valid[:, s],
            pos=cp_s[:, s],
        )

    return replay_and_select(mk(0), mk(1), max_diff0, k_hits)


def _shard_hits_global(res, base_off: int, l_pac: int):
    """Lift a per-shard SEResult's hit lists into global coordinates,
    masking hits that fall past the shard's true l_pac."""
    hok = (res.hits_pos < l_pac) & (res.hits_ndiff < BIG)
    return (lift_to_global(res.hits_pos, hok, base_off),
            torch.where(hok, res.hits_ndiff, BIG))


class ShardedSEAligner(SEAligner):
    """Drop-in SEAligner whose device steps run over a sharded index.

    `index` is the monolithic host index (finalize/SAM only; it is never
    copied to a device); the device tables come from the per-shard
    sub-indexes.  `devices` is a list of torch devices, which may name one
    device more than once (None: every visible CUDA device); shard s lives
    on devices[s % len(devices)], and the merge runs on devices[0]."""

    def __init__(
        self,
        index: SaltIndex,
        shard_indexes: List[SaltIndex],
        opts: SEOptions = None,
        devices=None,
        bins=None,
        contig_lengths=None,
    ):
        self.index = index
        self.opts = checked_options(opts or SEOptions())
        if self.opts.sa_mode == "sampled":
            raise ValueError(
                "sharded mode keeps each shard's full SA (shards are "
                "small by construction); use sa_mode='full'"
            )
        n = len(shard_indexes)
        self.devices = shard_devices(n, devices)
        self.device = self.devices[0]
        self.n_shards = n
        if bins is None:
            bins = [[i] for i in range(n)]
        if contig_lengths is None:
            contig_lengths = [c.length for c in index.contigs]
        # coordinate lifting (global = shard-local + base) requires each
        # bin to be a contiguous run of contigs in global order
        for b in bins:
            if b != list(range(b[0], b[0] + len(b))):
                raise ValueError(
                    "sharded aligner needs contiguous contig bins "
                    "(partition_contigs_contiguous)"
                )
        self.stacked = stack_indexes(shard_indexes, bins,
                                     contig_lengths=contig_lengths,
                                     devices=self.devices)
        self.sampled = None

    def _shards(self):
        """(device index, device, base offset, true l_pac) of every shard."""
        st = self.stacked
        return zip(st.shards, st.devices, st.base_offsets.tolist(),
                   st.l_pac.tolist())

    def _merged(self, results, max_diff0: int):
        """The per-shard SEResults' hit lists on devices[0], merged."""
        hp, hn = [], []
        for (_dix, _dev, base_off, l_pac), r in zip(self._shards(), results):
            hpos, hnd = _shard_hits_global(r, base_off, l_pac)
            hp.append(hpos.to(self.device, non_blocking=True))
            hn.append(hnd.to(self.device, non_blocking=True))
        return merged_replay(torch.stack(hp), torch.stack(hn), max_diff0,
                             self.opts.k_hits)

    def _any_shard(self, flags):
        """The per-shard (B,) flags on devices[0]: set where any shard's is."""
        return torch.stack([f.to(self.device, non_blocking=True)
                            for f in flags]).any(0)

    # ---------------- device steps ----------------
    # Every shard's list is kept at the verify width u (k_hits=u), never
    # truncated; k_hits applies after the merge.

    def _ungapped(self, fwd, rev, cap: int, u: int):
        """`out` is the list of every shard's ungapped output, each on its
        shard's device."""
        o = self.opts
        outs = [
            se_ungapped(
                dix, fwd.to(dev), rev.to(dev),
                l_overlap=o.l_overlap, max_seed=o.max_seed,
                max_locate=o.max_locate, cap=cap, u=u, k_hits=u,
                pe_mode=o.pe_locate, chunk=o.locate_chunk,
            )
            for dix, dev, _base, _l_pac in self._shards()
        ]
        merged = self._merged([x.res for x in outs], NOGAP_MAX_DIFF)
        return outs, pack_result(merged, (
            ~merged.found, self._any_shard([x.overflow for x in outs])))

    def _rerun_overflowed(self, fwd, rev, out, sel):
        """Every shard's located loci of rows `sel` verified at full width,
        its list kept whole (k_hits = full_cap()), then merged, as the
        monolithic engine re-runs them."""
        fc = self.opts.full_cap()
        return pack_result(self._merged([
            se_ungapped_full(dix, fwd[sel].to(dev), rev[sel].to(dev),
                             *loci_rows(shard_out, sel.to(dev)), k_hits=fc)
            for (dix, dev, _base, _l_pac), shard_out in zip(self._shards(), out)
        ], NOGAP_MAX_DIFF))

    def _gapped(self, fwd, rev, out, sel, k: int, u: int):
        gs = [
            se_gapped(dix, fwd.to(dev), rev.to(dev),
                      *loci_rows(shard_out, sel.to(dev)), k=k, u=u, k_hits=u)
            for (dix, dev, _base, _l_pac), shard_out in zip(self._shards(), out)
        ]
        return pack_result(self._merged([g.res for g in gs], k),
                           (self._any_shard([g.overflow for g in gs]),))

    def _loci_host(self, out, sel):
        """The selected rows' per-shard loci, masked to the shard, lifted
        by the shard's base offset and merged on devices[0] into the
        monolithic scan order: ascending global position, sentinels last."""
        strands = []
        for strand in (0, 1):
            parts = []
            for (_dix, dev, base_off, l_pac), shard_out in zip(self._shards(),
                                                               out):
                loci = loci_rows(shard_out, sel.to(dev))[strand]
                ok = loci.pushed & (loci.pos < l_pac)
                parts.append(lift_to_global(loci.pos, ok, base_off)
                             .to(self.device, non_blocking=True))
            # int64 values: positions >= 2^31 order as unsigned
            g = to_host(torch.sort(torch.cat(parts, 1), dim=1).values)
            strands.append((g, g != 0xFFFFFFFF))
        return strands


class ShardedPEAligner(PEAligner):
    """PE alignment over a sharded index: the per-end SE stage runs on
    the shards via ShardedSEAligner; pairing, SSW rescue, and SAM
    emission are the monolithic PE host machinery unchanged (they
    operate on global coordinates against the host index)."""

    def __init__(self, index, shard_indexes, opts: PEOptions = None,
                 devices=None, bins=None, contig_lengths=None):
        super().__init__(
            index, opts,
            se_aligner=lambda se_opts: ShardedSEAligner(
                index, shard_indexes, opts=se_opts, devices=devices,
                bins=bins, contig_lengths=contig_lengths))


def build_sharded_se(contig_data, blocks, n_shards, opts=None, devices=None,
                     l_seed=19, r_anchor_mode="exact", paired=False):
    """Partition (contiguous bins) + build monolithic host index + build
    per-shard sub-indexes + construct the aligner, in one call."""
    lengths = [len(c[2]) for c in contig_data]
    bins = partition_contigs_contiguous(lengths, n_shards)
    index = build_index_from_data(contig_data, blocks, l_seed=l_seed,
                                  r_anchor_mode=r_anchor_mode)
    shard_indexes = []
    for b in bins:
        cd = [contig_data[i] for i in b]
        bl = [blocks[i] for i in b if i < len(blocks)]
        shard_indexes.append(
            build_index_from_data(cd, bl, l_seed=l_seed,
                                  r_anchor_mode=r_anchor_mode)
        )
    cls = ShardedPEAligner if paired else ShardedSEAligner
    return cls(index, shard_indexes, opts=opts, devices=devices, bins=bins,
               contig_lengths=lengths)
