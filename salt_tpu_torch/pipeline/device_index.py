"""Device-resident index arrays derived from a host SaltIndex, in full
and in sampled suffix-array mode.  Port of
salt_tpu/pipeline/device_index.py.

uint32 tables are stored as int32 tensors holding the same bits
(ops/uint.py).  to_device_index builds on the device it is given (the
card, or the CPU when the caller asks) what is a pass over the genome:
the rank planes (ops/rank.py, from the uint8 BWTs sent a chunk at a
time), the packed mixRef words, and in sampled mode every sampled locate
table (the select rows and samples from csa and r_coord streamed a chunk
at a time, never resident; the packed BWT symbols).  In full mode csa and
r_coord are copied into the one sa_cat tensor.  The 12-mer tables are
copied from the bundle, which holds them (building the R table is twelve
LF steps over all 4^12 k-mers, which every CPU test that builds an index
would run).  salt_tpu's sa_cat derived by sampled walks is not built
either: it needs the sampled tables first and differs from the bundle's
only at unreachable ranks.

host_route_index is the same index made the way it was before the device
builders, in numpy on the host: the reference they are held against, not
a path of any aligner.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from ..constants import UINT32_MAX
from ..index.build import SaltIndex

from ..ops.rank import (
    RankIndex,
    build_rank_index,
    chunk_words,
    flag_words,
    fuse_rank_index_pair,
    host_chunk,
    rank_index_on,
    rank_index_pair_on,
    rank_indexes_to,
    write_rows,
)
from ..ops.uint import u32_table


@dataclass
class DeviceIndex:
    ri_c: RankIndex        # C-part rank structure (5 symbols incl. sentinel)
    ri_r: RankIndex        # R-part rank structure (6 symbols incl. sentinel)
    lkt: torch.Tensor      # uint32 bits [4^12+1] C 12-mer prefix sums
    r_lkt_sp: torch.Tensor # uint32 bits [4^12] exact R 12-mer intervals
    r_lkt_ep: torch.Tensor
    sa_cat: torch.Tensor   # uint32 bits [c_sa_len + T+1]: csa ++ r_coord,
                           # so locate is one gather per slot; a 2-word
                           # placeholder in sampled mode
    mixref_words: torch.Tensor  # uint32 bits [ceil(L/8)+2], 8 one-hot
                                # nibbles per word, little-endian
    l_pac: int
    l_seed: int
    c_sa_len: int          # length of the csa part within sa_cat

    def to(self, device) -> "DeviceIndex":
        """The same tables on `device` (rank planes that share one tensor
        still share one)."""
        ri_c, ri_r = rank_indexes_to(device, self.ri_c, self.ri_r)
        return replace(
            self, ri_c=ri_c, ri_r=ri_r,
            **{name: getattr(self, name).to(device)
               for name in ("lkt", "r_lkt_sp", "r_lkt_ep", "sa_cat",
                            "mixref_words")})

    def table_bytes(self) -> int:
        """Bytes of every tensor of the index, a shared one counted once."""
        seen = {}
        for t in (self.ri_c.bc, self.ri_c.cfreq, self.ri_r.bc, self.ri_r.cfreq,
                  self.lkt, self.r_lkt_sp, self.r_lkt_ep, self.sa_cat,
                  self.mixref_words):
            seen[t.data_ptr()] = t.numel() * t.element_size()
        return sum(seen.values())


def _pack_words(vals: np.ndarray, W: int) -> np.ndarray:
    """uint8 symbols (< 16) -> W uint32 words, 8 per word, little-endian
    within the word, zero past the end.  Built 2^24 words at a time: a
    whole genome's symbols at once would take a uint32 temporary of 4
    bytes a symbol (12 GB at 3.1 G)."""
    words = np.zeros(W, dtype=np.uint32)
    chunk = 1 << 24
    for w0 in range(0, (len(vals) + 7) // 8, chunk):
        seg = vals[w0 * 8 : (w0 + chunk) * 8]
        nw = (len(seg) + 7) // 8
        padded = np.zeros(nw * 8, dtype=np.uint32)
        padded[: len(seg)] = seg
        acc = words[w0 : w0 + nw]
        for j in range(8):
            acc |= padded[j::8] << np.uint32(4 * j)
    return words


def pack_nibbles(mixref: np.ndarray) -> np.ndarray:
    """uint8 nibbles -> uint32 words, little-endian within the word
    (the mixRef pac layout, metaref.c:54-56), two zero words past the
    end."""
    return _pack_words(mixref, (len(mixref) + 7) // 8 + 2)


def pack_words_into(vals: np.ndarray, words: torch.Tensor,
                    chunk: int = 0) -> torch.Tensor:
    """_pack_words on words' device, into `words` (int32 holding the uint32
    bits) and returned: 8 symbols (< 16) a word, little-endian, zero past
    the end.  The symbols go to the device a chunk at a time; three folds
    of their int64 view (eight symbols, one a byte) gather each eight into
    the low 32 bits."""
    dev = words.device
    step = 4 * (chunk or chunk_words(dev))      # words a chunk
    n_full = (len(vals) + 7) // 8
    for w0 in range(0, n_full, step):
        w1 = min(w0 + step, n_full)
        x = host_chunk(vals, 8 * w0, 8 * w1, 0, dev).view(torch.int64)
        x = (x | (x >> 4)) & 0x00FF00FF00FF00FF
        x = (x | (x >> 8)) & 0x0000FFFF0000FFFF
        x = (x | (x >> 16)) & 0xFFFFFFFF
        words[w0:w1] = x - ((x & 0x80000000) << 1)     # the int32 of its bits
    words[n_full:] = 0
    return words


def canonical_r_lkt(sp: np.ndarray, ep: np.ndarray):
    """The R 12-mer interval tables with every absent k-mer (width
    ep - sp + 1 == 0 mod 2^32) stored as the empty interval (1, 0), as
    salt_tpu's device-built tables store it.  Seeding reads only sp, ep
    and liveness, so this changes no alignment."""
    alive = (ep - sp + np.uint32(1)) != 0
    return (np.where(alive, sp, 1).astype(np.uint32),
            np.where(alive, ep, 0).astype(np.uint32))


@dataclass
class SampledSA:
    """Memory-lean locate tables (sa_mode="sampled").  Instead of the
    full per-rank coordinate table (4 bytes a rank over genome plus
    pattern text) the device holds

      * C part: positions sampled by text position (pos % intv == 0),
        compacted in rank order, plus a fused (count, bit word) select
        structure over ranks: a locate LF-walks at most intv - 1 steps;
      * R part: a stop at every '#' rank (value = the segment's
        coordinate base) and at every rank whose coordinate is a
        multiple of intv (value = that coordinate); coordinates fall by
        one a step inside a segment, so R walks have the same bound;
      * the BWT symbols of both parts, 4 bits each, which a walk step
        reads to apply LF.

    The C and R tables are concatenated (C first), so a walk step is one
    gather a structure with a per-lane family offset
    (ops/locate.resolve_sampled).  On chip_smoke.py's index (45,000,000
    bases, 150,000 SNPs, sa_intv = 8) the three tables take 72,266,860
    bytes on the device where the full table takes 227,689,020."""

    sel_cat: torch.Tensor      # int32 [Wc + Wr, 2] (exclusive count, bits)
    samples_cat: torch.Tensor  # uint32 bits: stop values, C block then R
    syms_cat: torch.Tensor     # uint32 bits: packed BWT symbols, C then R
    c_words: int               # words of the C block in syms_cat
    c_sel_rows: int            # rows of the C block in sel_cat
    c_n_samples: int           # values of the C block in samples_cat
    sharp_lo: int              # first '#' rank (r_cumfreq[4] + 1)
    sharp_hi: int              # one past the last '#' rank
    intv: int
    max_r_walk: int            # walk bound (== intv)

    def to(self, device) -> "SampledSA":
        return replace(self, sel_cat=self.sel_cat.to(device),
                       samples_cat=self.samples_cat.to(device),
                       syms_cat=self.syms_cat.to(device))

    def table_bytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.sel_cat, self.samples_cat, self.syms_cat))


def sampled_from_arrays(sel_cat, samples_cat, syms_cat, **fields) -> SampledSA:
    """A SampledSA from numpy arrays of the same layout (salt_tpu's, for
    instance) and the integer fields by name."""
    def own(a, dtype):
        # a read-only array (a view of another framework's buffer) is copied
        a = np.ascontiguousarray(a, dtype=dtype)
        return a if a.flags.writeable else a.copy()

    return SampledSA(
        sel_cat=torch.from_numpy(own(sel_cat, np.int32)),
        samples_cat=u32_table(own(samples_cat, np.uint32)),
        syms_cat=u32_table(own(syms_cat, np.uint32)),
        **{k: int(v) for k, v in fields.items()})


def _pack4(vals: np.ndarray) -> np.ndarray:
    """uint8 symbols (< 16) -> uint32 words, 8 per word, little-endian,
    one zero word past the end."""
    return _pack_words(vals, (len(vals) + 7) // 8 + 1)


def _select_rows(mask: np.ndarray) -> np.ndarray:
    """int32 [W, 2] fused select structure over a rank mask: the count of
    set ranks before each 32-rank word, and the word's bits."""
    W = (len(mask) + 31) // 32 + 1
    pad = np.zeros(W * 32, dtype=bool)
    pad[: len(mask)] = mask
    sel = np.zeros((W, 2), dtype=np.int32)
    per_word = pad.reshape(W, 32).sum(axis=1, dtype=np.int64)
    sel[1:, 0] = np.cumsum(per_word)[:-1]
    sel[:, 1] = np.packbits(pad, bitorder="little").view("<i4")
    return sel


def sharp_range(idx: SaltIndex):
    """(sharp_lo, sharp_hi), the '#' ranks of the R BWT, checked against
    the index's sharp_bases."""
    # '#' ranks are [cumfreq[4]+1, cumfreq[5]+1) in in-band-sentinel rank
    # coordinates (the sentinel suffix is rank 0)
    sharp_lo = int(idx.r_cumfreq[4]) + 1
    sharp_hi = int(idx.r_cumfreq[5]) + 1
    if (idx.sharp_bases is not None
            and sharp_hi - sharp_lo != len(idx.sharp_bases)):
        # a bundle of a SNP-bearing index saved with an empty sharp_bases
        # would otherwise load as a valid zero-SNP index and blank every
        # R coordinate
        raise ValueError(
            f"inconsistent index bundle: {sharp_hi - sharp_lo} '#' ranks "
            f"in the R BWT but {len(idx.sharp_bases)} sharp_bases entries")
    if idx.sharp_bases is None:
        raise ValueError("index missing sharp_bases; rebuild with current "
                         "version for sa_mode='sampled'")
    return sharp_lo, sharp_hi


def build_sampled_sa(idx: SaltIndex, intv: int = 8) -> SampledSA:
    """The sampled locate tables of a host index, as host tensors."""
    sharp_lo, sharp_hi = sharp_range(idx)
    n1 = len(idx.csa)            # n + 1 ranks
    mask = (idx.csa % np.uint32(intv)) == 0
    # rank 0 holds the sa[0] = 0xFFFFFFFF quirk; its position is n
    mask[0] = (n1 - 1) % intv == 0
    # the stored value keeps the rank-0 quirk byte for byte
    c_samples = idx.csa[mask]

    # an R walk stops at a '#' rank (value = sharp_base: coord(p) = base +
    # steps, rbwt.c:316-333) or at a rank whose coordinate is a multiple
    # of intv (coordinates are affine in text position within a segment,
    # so r_coord[k0] = value + steps there too)
    rc = idx.r_coord
    rmask = (rc != np.uint32(UINT32_MAX)) & (rc % np.uint32(intv) == 0)
    rmask[sharp_lo:sharp_hi] = True
    rvals = rc.copy()
    if sharp_hi > sharp_lo:
        rvals[sharp_lo:sharp_hi] = idx.sharp_bases
    r_samples = rvals[rmask]
    if len(r_samples) == 0:
        # zero-SNP index: no local patterns at all; one dummy slot keeps
        # gathers in bounds (no R lane is ever active)
        r_samples = np.array([0x80000000], dtype=np.uint32)
    c_sel = _select_rows(mask)
    c_words = _pack4(idx.cbwt)
    return sampled_from_arrays(
        np.concatenate([c_sel, _select_rows(rmask)]),
        np.concatenate([c_samples, r_samples]),
        np.concatenate([c_words, _pack4(idx.rbwt)]),
        c_words=len(c_words), c_sel_rows=len(c_sel),
        c_n_samples=len(c_samples), sharp_lo=sharp_lo, sharp_hi=sharp_hi,
        intv=intv, max_r_walk=intv)


def sampled_sa_on(idx: SaltIndex, device, intv: int = 8,
                  chunk: int = 0) -> SampledSA:
    """build_sampled_sa's tables built on `device`, bit-identical: csa and
    r_coord go there a chunk at a time for the stop masks, the select rows
    and the compaction of the samples, and are not kept."""
    sharp_lo, sharp_hi = sharp_range(idx)
    dev = torch.device(device)
    chunk = chunk or chunk_words(dev)
    n1c, n1r = len(idx.csa), len(idx.r_coord)
    Wc, Wr = (n1c + 31) // 32 + 1, (n1r + 31) // 32 + 1
    sel_cat = torch.empty((Wc + Wr, 2), dtype=torch.int32, device=dev)

    def stops(v):
        """Ranks of a chunk whose coordinate (uint32 bits in int32) is a
        multiple of intv; one int64 copy of the chunk, worked in place."""
        return v.long().bitwise_and_(0xFFFFFFFF).remainder_(intv) == 0

    def keep_c(v, r0):
        mask = stops(v)
        if r0 == 0:
            # rank 0 holds the sa[0] = 0xFFFFFFFF quirk; its position is n
            mask[0] = (n1c - 1) % intv == 0
        return mask, v         # the stored value keeps the quirk

    sharp = np.asarray(idx.sharp_bases, dtype=np.uint32)

    def keep_r(v, r0):
        mask = (v != -1) & stops(v)
        a, b = max(sharp_lo, r0), min(sharp_hi, r0 + len(v))
        if a < b:
            mask[a - r0 : b - r0] = True
            v = v.clone()      # the CPU's chunk is a view of r_coord
            v[a - r0 : b - r0] = host_chunk(
                sharp.view(np.int32), a - sharp_lo, b - sharp_lo, 0, dev)
        return mask, v

    c_samples = _compact_rows(idx.csa, keep_c, sel_cat[:Wc], chunk)
    r_samples = _compact_rows(idx.r_coord, keep_r, sel_cat[Wc:], chunk)
    n_c = sum(len(t) for t in c_samples)
    if not sum(len(t) for t in r_samples):
        # zero-SNP index: no local patterns at all; one dummy slot keeps
        # gathers in bounds (no R lane is ever active)
        r_samples = [torch.tensor([-2**31], dtype=torch.int32, device=dev)]
    samples_cat = torch.cat(c_samples + r_samples)
    del c_samples, r_samples
    c_words = (len(idx.cbwt) + 7) // 8 + 1
    syms_cat = torch.empty(c_words + (len(idx.rbwt) + 7) // 8 + 1,
                           dtype=torch.int32, device=dev)
    pack_words_into(idx.cbwt, syms_cat[:c_words], chunk)
    pack_words_into(idx.rbwt, syms_cat[c_words:], chunk)
    return SampledSA(sel_cat=sel_cat, samples_cat=samples_cat,
                     syms_cat=syms_cat, c_words=c_words, c_sel_rows=Wc,
                     c_n_samples=n_c, sharp_lo=sharp_lo, sharp_hi=sharp_hi,
                     intv=intv, max_r_walk=intv)


def _compact_rows(vals: np.ndarray, keep, sel: torch.Tensor, chunk: int):
    """One family of the sampled tables: `vals` (uint32 per rank) sent to
    sel's device 32 * chunk ranks at a time, keep(v, first rank) -> (stop
    mask, values) on each; the mask's select rows are written into `sel`
    and the stops' values, in rank order, returned as a list of int32
    tensors."""
    dev = sel.device
    carry = torch.zeros((), dtype=torch.int64, device=dev)
    out = []
    for w0 in range(0, sel.shape[0], chunk):
        w1 = min(w0 + chunk, sel.shape[0])
        r0 = 32 * w0
        r1 = max(r0, min(32 * w1, len(vals)))
        mask, v = keep(host_chunk(vals.view(np.int32), r0, r1, 0, dev), r0)
        flags = torch.zeros(32 * (w1 - w0), dtype=torch.uint8, device=dev)
        flags[: r1 - r0] = mask
        carry = write_rows(sel[w0:w1],
                           flag_words(flags.view(torch.int64)), carry)
        out.append(v[mask])
    return out


def check_modes(idx: SaltIndex, sa_mode: str) -> None:
    if sa_mode not in ("full", "sampled"):
        raise ValueError(f"sa_mode={sa_mode!r}: expected 'full' or 'sampled'")
    if idx.r_lkt_sp is None:
        raise ValueError("index missing r_lkt tables; rebuild with current "
                         "version")


def to_device_index(idx: SaltIndex, device, sa_mode: str = "full",
                    sa_intv: int = 8):
    """sa_mode="full": one-gather locate, 4 bytes a rank on the device;
    returns a DeviceIndex.  sa_mode="sampled": bounded LF-walk locate
    over the SampledSA tables; the rank planes of the two families share
    one tensor (C planes, then R planes), sa_cat is a placeholder, and
    the result is (DeviceIndex, SampledSA).  Every table but the copied
    ones is built on `device` (module docstring)."""
    check_modes(idx, sa_mode)
    dev = torch.device(device)
    cfreq_c = np.append(idx.c_l2, 0)
    cfreq_r = np.append(idx.r_cumfreq, 0)
    if sa_mode == "sampled":
        # first: its compaction's transient (the samples twice) is then
        # the only thing on the device
        sampled = sampled_sa_on(idx, dev, sa_intv)
        ri_c, ri_r = rank_index_pair_on(dev, idx.cbwt, cfreq_c, idx.rbwt,
                                        cfreq_r)
        sa_cat = torch.zeros(2, dtype=torch.int32, device=dev)  # never read
        c_sa_len = 1
    else:
        ri_c = rank_index_on(dev, idx.cbwt, cfreq_c)
        ri_r = rank_index_on(dev, idx.rbwt, cfreq_r)
        c_sa_len = len(idx.csa)
        sa_cat = full_sa_cat(idx, dev)
    r_lkt_sp, r_lkt_ep = canonical_r_lkt(idx.r_lkt_sp, idx.r_lkt_ep)
    dix = DeviceIndex(
        ri_c=ri_c,
        ri_r=ri_r,
        lkt=u32_table(idx.lkt).to(dev),
        r_lkt_sp=u32_table(r_lkt_sp).to(dev),
        r_lkt_ep=u32_table(r_lkt_ep).to(dev),
        sa_cat=sa_cat,
        mixref_words=pack_words_into(idx.mixref, torch.empty(
            (len(idx.mixref) + 7) // 8 + 2, dtype=torch.int32, device=dev)),
        l_pac=idx.l_pac,
        l_seed=idx.l_seed,
        c_sa_len=c_sa_len,
    )
    return (dix, sampled) if sa_mode == "sampled" else dix


def full_sa_cat(idx: SaltIndex, dev) -> torch.Tensor:
    """csa ++ r_coord on `dev`, the two parts copied into place: no host
    copy of the concatenation (18 GB at 3.1 G bases)."""
    c_sa_len = len(idx.csa)
    sa_cat = torch.empty(c_sa_len + len(idx.r_coord), dtype=torch.int32,
                         device=dev)
    sa_cat[:c_sa_len].copy_(u32_table(idx.csa))
    sa_cat[c_sa_len:].copy_(u32_table(idx.r_coord))
    return sa_cat


def host_route_index(idx: SaltIndex, device="cpu", sa_mode: str = "full",
                     sa_intv: int = 8):
    """to_device_index's result built in numpy on the host and copied to
    `device`: the reference of the device builders."""
    check_modes(idx, sa_mode)
    dev = torch.device(device)
    r_lkt_sp, r_lkt_ep = canonical_r_lkt(idx.r_lkt_sp, idx.r_lkt_ep)
    ri_c = build_rank_index(idx.cbwt, np.append(idx.c_l2, 0))
    ri_r = build_rank_index(idx.rbwt, np.append(idx.r_cumfreq, 0))
    if sa_mode == "sampled":
        sampled = build_sampled_sa(idx, sa_intv).to(dev)
        ri_c, ri_r = fuse_rank_index_pair(ri_c, ri_r)
        sa_cat = np.zeros(2, np.uint32)   # placeholder, never read
        c_sa_len = 1
    else:
        c_sa_len = len(idx.csa)
        sa_cat = full_sa_cat(idx, dev)
    ri_c, ri_r = rank_indexes_to(dev, ri_c, ri_r)
    dix = DeviceIndex(
        ri_c=ri_c,
        ri_r=ri_r,
        lkt=u32_table(idx.lkt).to(dev),
        r_lkt_sp=u32_table(r_lkt_sp).to(dev),
        r_lkt_ep=u32_table(r_lkt_ep).to(dev),
        sa_cat=u32_table(sa_cat).to(dev) if sa_mode == "sampled" else sa_cat,
        mixref_words=u32_table(pack_nibbles(idx.mixref)).to(dev),
        l_pac=idx.l_pac,
        l_seed=idx.l_seed,
        c_sa_len=c_sa_len,
    )
    return (dix, sampled) if sa_mode == "sampled" else dix
