"""Index sharding by reference bin (the whole-human-genome mode).  Port
of salt_tpu/parallel/sharded.py.

The genome's contigs are partitioned into N shards and a complete
sub-index (BWT/SA/LKT/mixRef over that bin) is built per shard.  Shard s
lives on devices[s % len(devices)]: on one card all shards are resident
side by side and their steps are queued one after the other, on several
cards each shard sits on its own.  A read batch goes to every shard,
every shard runs the full seed/locate/verify step against its bin, and
the per-read best candidates are merged on devices[0] by a minimum over
the encoded (n_diff, shard) key.

Every shard keeps its tables at their true size.  salt_tpu pads them to
the largest shard because its shard_map needs one shape; nothing here
does.  The mask that kept candidates out of that padding
(pos < the shard's l_pac) is kept: it is cheap and it is what salt_tpu
computes.

Semantics note: the reference has no multi-index mode; per-seed width
caps (`max_seed`) and per-strand locate caps apply per shard here, so a
sharded run can differ from a monolithic run exactly where the
reference's own caps truncate, by design, never in the common case.
The one range rule that shows on ordinary reads: the gapped step skips a
candidate whose window reaches the end of its index (pipeline/se.py,
_gapped_checked), which here is the end of the shard's bin.  A read that
needs the gapped step and ends within GAP_WINDOW_PAD + its inserted -
deleted bases of an inner bin's last base is therefore skipped where the
monolithic run aligns it.  salt_tpu holds the rule at the padded length,
so only its largest shard shows it; every shard does here.

partition_contigs, build_sharded_indexes (bins that need not be
contiguous) and merge_sharded_hits (the host merge of sharded_se_step's
raw lists) are kept for callers of salt_tpu's that use them; the
aligners of sharded_engine.py call none of them (contiguous bins,
merged_replay on the device).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..index.build import Contig, SaltIndex, build_index_from_data
from ..ops.uint import U32
from ..pipeline.device_index import DeviceIndex, to_device_index
from ..pipeline.engine import checked_device
from ..pipeline.se import se_ungapped

BIG = 255
# the merge key is n_diff * SHARD_KEY + shard: at most this many shards
SHARD_KEY = 1024


def partition_contigs(contig_data: Sequence[Tuple[str, str, str]], n_shards: int):
    """Greedy size-balanced partition of contigs into n_shards bins (not
    contiguous: for sharded_se_step, not for the sharded aligners)."""
    order = sorted(range(len(contig_data)), key=lambda i: -len(contig_data[i][2]))
    bins: List[List[int]] = [[] for _ in range(n_shards)]
    sizes = [0] * n_shards
    for i in order:
        j = int(np.argmin(sizes))
        bins[j].append(i)
        sizes[j] += len(contig_data[i][2])
    return [sorted(b) for b in bins]


def partition_contigs_contiguous(lengths: Sequence[int], n_shards: int):
    """Size-balanced partition into CONTIGUOUS contig runs (bins in
    global order).  Contiguity makes shard-local -> global coordinate
    lifting a single per-shard base offset (global = local + base),
    which the full sharded aligner (sharded_engine.py) relies on."""
    if n_shards > len(lengths):
        raise ValueError(
            f"cannot split {len(lengths)} contigs into {n_shards} "
            "contiguous shards; reduce --shards"
        )
    total = sum(lengths)
    target = total / n_shards
    bins: List[List[int]] = []
    cur: List[int] = []
    acc = 0
    for i, L in enumerate(lengths):
        cur.append(i)
        acc += L
        bins_left = n_shards - len(bins)       # incl. the current one
        contigs_left = len(lengths) - i - 1
        # cut when the running bin reached its share, or when every
        # remaining contig is needed to fill the remaining bins
        must_cut = bins_left > 1 and contigs_left == bins_left - 1
        want_cut = bins_left > 1 and acc >= target
        if must_cut or want_cut:
            bins.append(cur)
            cur = []
            acc = 0
    bins.append(cur)
    return bins


def build_sharded_indexes(contig_data, blocks, n_shards, l_seed=19):
    """One SaltIndex per shard.  SNP blocks are matched to contigs by
    position in the (global) contig order, as the monolithic build does."""
    bins = partition_contigs(contig_data, n_shards)
    shard_indexes = []
    for b in bins:
        cd = [contig_data[i] for i in b]
        bl = [blocks[i] if i < len(blocks) else None for i in b]
        bl = [x for x in bl if x is not None]
        shard_indexes.append(build_index_from_data(cd, bl, l_seed=l_seed))
    return shard_indexes, bins


def shard_devices(n_shards: int, devices=None) -> List[torch.device]:
    """The device of every shard: shard s on devices[s % len(devices)].
    `devices` is a list of devices (one may occur more than once), one
    device, or None for every visible CUDA device; asking for CUDA without
    a card raises."""
    if devices is None:
        checked_device("cuda")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    elif isinstance(devices, (str, torch.device)):
        devices = [devices]
    devices = [checked_device(d) for d in devices]
    if not devices or len(devices) > n_shards:
        raise ValueError(f"mesh has {len(devices)} devices for "
                         f"{n_shards} shards")
    return [devices[s % len(devices)] for s in range(n_shards)]


def host_index(shard_indexes: List[SaltIndex]) -> SaltIndex:
    """The host half of the monolithic index over the shards' bins laid
    end to end in shard order: the contig table at global offsets, pac and
    mixref, which is all that the aligners' host finalize and SAM read.
    It holds no BWT, suffix array or lookup table (those fields are
    empty) and never goes to a device.  An N base of pac is drawn per
    shard, where a monolithic build draws them over the whole genome."""
    contigs, off = [], 0
    for ix in shard_indexes:
        contigs += [Contig(c.name, c.anno, off + c.offset, c.length, c.n_ambs)
                    for c in ix.contigs]
        off += ix.l_pac
    u32, u8 = np.zeros(0, np.uint32), np.zeros(0, np.uint8)
    return SaltIndex(
        l_seed=shard_indexes[0].l_seed, contigs=contigs, l_pac=off,
        pac=np.concatenate([ix.pac for ix in shard_indexes]),
        mixref=np.concatenate([ix.mixref for ix in shard_indexes]),
        lkt=u32, cbwt=u8, c_l2=np.zeros(5, np.uint32), c_primary=0, csa=u32,
        r_text_len=0, rbwt=u8, r_cumfreq=np.zeros(6, np.uint32), r_primary=0,
        r_coord=u32)


def load_sharded_index(prefix: str):
    """(host index, shard indexes, bins) of what `cli idx --shards N`
    writes: prefix.shards.json and prefix.shard{i}.  The host index is the
    monolithic bundle at `prefix` where there is one, else host_index of
    the shards."""
    import json
    import os

    from ..index.store import load_index

    with open(prefix + ".shards.json") as fh:
        man = json.load(fh)
    shard_ixs = [load_index(f"{prefix}.shard{i}")
                 for i in range(man["n_shards"])]
    host = (load_index(prefix) if os.path.exists(prefix + ".salt.json")
            else host_index(shard_ixs))
    return host, shard_ixs, man["bins"]


@dataclass
class StackedIndex:
    """The shards' device indexes, each at its true size on its own
    device, with what lifts a shard's coordinates into the genome's."""

    shards: List[DeviceIndex]
    base_offsets: np.ndarray   # uint32 global offset of each shard's bin
    l_pac: np.ndarray          # int64 true l_pac of each shard

    @property
    def devices(self) -> List[torch.device]:
        return [d.sa_cat.device for d in self.shards]


def stack_indexes(shard_indexes: List[SaltIndex], bins, contig_data=None,
                  contig_lengths=None, devices=None) -> StackedIndex:
    """Every shard's tables on its device (shard_devices): by default the
    visible CUDA devices, and an error where there is none."""
    devs = shard_devices(len(shard_indexes), devices)
    # global offset of each shard's first contig, for coordinate lifting
    if contig_lengths is None:
        contig_lengths = [len(c[2]) for c in contig_data]
    glob_off = np.cumsum([0] + list(contig_lengths))[:-1]
    base = np.array(
        [glob_off[b[0]] if b else 0 for b in bins], dtype=np.uint32
    )
    return StackedIndex(
        shards=[to_device_index(ix, d) for ix, d in zip(shard_indexes, devs)],
        base_offsets=base,
        l_pac=np.array([ix.l_pac for ix in shard_indexes], dtype=np.int64),
    )


def lift_to_global(pos, ok, base_off: int):
    """Shard-local uint32 positions (int64) -> global ones, wrapping as
    uint32 addition does; UINT32_MAX where not `ok`."""
    return torch.where(ok, (pos + int(base_off)) & U32, U32)


def sharded_se_step(
    stacked: StackedIndex,
    seq_f: torch.Tensor,        # (B, L) codes, sent to every shard
    seq_r: torch.Tensor,
    *,
    l_overlap: int,
    max_seed: int,
    max_locate: int,
    cap: int,
    u: int = 64,
    k_hits: int = 16,
    return_hits: bool = False,
):
    """Runs the ungapped SE step on every shard and merges the per-read
    primaries by the lowest n_diff, ties to the lowest shard id.

    Returns numpy arrays (found, global_pos (int64 holding uint32),
    strand, n_diff, shard_id) per read, coordinates lifted into the
    global genome via base_offsets.  With `return_hits=True` additionally
    the raw per-shard hit lists (hits_pos (n_shards, B, 2, K) global
    coordinates, hits_ndiff, n_hits) for an exact cross-shard XA merge via
    `merge_sharded_hits` below, and `trunc`, which flags reads whose
    per-shard survivor list was truncated at K (then the merged replay can
    miss survivors and the caller re-runs wide).
    """
    if len(stacked.shards) > SHARD_KEY:
        raise ValueError(f"at most {SHARD_KEY} shards")
    d0 = stacked.devices[0]
    keys, gpos, strand, hits = [], [], [], []
    for s, dix in enumerate(stacked.shards):
        dev = dix.sa_cat.device
        out = se_ungapped(
            dix, seq_f.to(dev), seq_r.to(dev),
            l_overlap=l_overlap, max_seed=max_seed, max_locate=max_locate,
            cap=cap, u=u, k_hits=k_hits,
        )
        res = out.res
        base_off, l_pac = stacked.base_offsets[s], int(stacked.l_pac[s])
        ok = res.found & (res.pos < l_pac)
        nd = torch.where(ok, res.n_diff, BIG)
        keys.append((nd * SHARD_KEY + s).to(d0))
        gpos.append(lift_to_global(res.pos, ok, base_off).to(d0))
        strand.append(res.strand.to(d0))
        if return_hits:
            hok = (res.hits_pos < l_pac) & (res.hits_ndiff < BIG)
            hits.append((
                lift_to_global(res.hits_pos, hok, base_off).to(d0),
                torch.where(hok, res.hits_ndiff, BIG).to(d0),
                hok.sum(-1).to(d0),
                (res.n_hits > res.hits_pos.shape[-1]).any(-1).to(d0),
            ))
    # the key embeds the shard id, so the minimum names one winner
    best_key, win = torch.stack(keys).min(0)
    nd_best = best_key // SHARD_KEY

    def winner(parts):
        return torch.stack(parts).gather(0, win[None])[0].cpu().numpy()

    prim = (
        (nd_best < BIG).cpu().numpy(), winner(gpos), winner(strand),
        nd_best.cpu().numpy(), (best_key % SHARD_KEY).cpu().numpy(),
    )
    if not return_hits:
        return prim
    return prim + tuple(torch.stack(part).cpu().numpy() for part in zip(*hits))


def merge_sharded_hits(hpos, hnd, max_diff0: int, k_hits: int):
    """Exact cross-shard merge of per-shard SE hit lists.

    Each shard's threshold replay (ops/verify.py replay_and_select,
    mirroring alnse.c:348-393) uses shard-local running minima, which are
    >= the global running minima, so every monolithic survivor survives
    in its own shard, and re-running the replay over the union (sorted by
    global position per strand, strand 0 first) reproduces the monolithic
    hit lists exactly, provided no shard truncated its list at K.

    hpos: uint32 values (n_shards, B, 2, K) global coords (0xFFFFFFFF = empty)
    hnd:  integers      (n_shards, B, 2, K)
    Returns dict(found, pos, strand, n_diff, hits_pos (B,2,k_hits),
    hits_ndiff, n_hits (B,2), first_hit_ndiff (B,2)) in numpy.
    """
    S, B, _, K = hpos.shape
    # (B, 2, S*K) candidate pool per strand, position-sorted
    cp = np.moveaxis(hpos, 0, 2).reshape(B, 2, S * K).astype(np.uint64)
    cn = np.moveaxis(hnd, 0, 2).reshape(B, 2, S * K)
    order = np.argsort(cp, axis=-1, kind="stable")
    cp = np.take_along_axis(cp, order, axis=-1)
    cn = np.take_along_axis(cn, order, axis=-1)
    valid = cp != 0xFFFFFFFF
    cnt = np.where(valid, cn, BIG)
    # strand-0-then-strand-1 sequential threshold replay
    flat_c = cnt.reshape(B, 2 * S * K)
    run = np.minimum.accumulate(flat_c, axis=-1)
    excl = np.concatenate(
        [np.full((B, 1), BIG, dtype=run.dtype), run[:, :-1]], axis=-1
    )
    thr = np.minimum(max_diff0, excl)
    hit = (flat_c <= thr).reshape(B, 2, S * K) & valid

    hits_pos = np.full((B, 2, k_hits), 0xFFFFFFFF, dtype=np.uint32)
    hits_ndiff = np.full((B, 2, k_hits), BIG, dtype=np.int32)
    n_hits = hit.sum(axis=-1).astype(np.int32)
    first_hit_ndiff = np.full((B, 2), BIG, dtype=np.int32)
    for s in range(2):
        hrow = hit[:, s]
        sel = np.argsort(~hrow, axis=-1, kind="stable")[:, :k_hits]
        got = np.take_along_axis(hrow, sel, axis=-1)
        hits_pos[:, s] = np.where(
            got, np.take_along_axis(cp[:, s], sel, axis=-1), 0xFFFFFFFF
        ).astype(np.uint32)
        hits_ndiff[:, s] = np.where(
            got, np.take_along_axis(cn[:, s], sel, axis=-1), BIG
        )
        any_s = hrow.any(axis=-1)
        first = np.argmax(hrow, axis=-1)
        first_hit_ndiff[:, s] = np.where(
            any_s, np.take_along_axis(cnt[:, s], first[:, None], axis=-1)[:, 0],
            BIG,
        )
    # primary selection (replay_and_select semantics: strand 1's first
    # hit displaces an equal strand-0 best).  The min is taken over ALL
    # survivors (the compacted k_hits list may truncate before the min).
    val = np.min(np.where(hit, cnt, BIG), axis=-1)
    use1 = n_hits[:, 1] > 0
    found = (n_hits.sum(axis=-1) > 0)
    strand = np.where(use1, 1, 0)
    n_diff = np.where(use1, val[:, 1], val[:, 0])

    def best_pos(s):
        sel_min = hit[:, s] & (cnt[:, s] == val[:, s][:, None])
        i = np.argmax(sel_min, axis=-1)
        return np.take_along_axis(cp[:, s], i[:, None], axis=-1)[:, 0].astype(
            np.uint32
        )

    pos = np.where(use1, best_pos(1), best_pos(0))
    pos = np.where(found, pos, np.uint32(0xFFFFFFFF))
    return {
        "found": found, "pos": pos, "strand": strand,
        "n_diff": np.where(found, n_diff, BIG),
        "hits_pos": hits_pos, "hits_ndiff": hits_ndiff,
        "n_hits": n_hits, "first_hit_ndiff": first_hit_ndiff,
    }
