"""Device-resident index arrays derived from a host SaltIndex, in full
and in sampled suffix-array mode.  Port of
salt_tpu/pipeline/device_index.py.

Every table is built on the host and copied to the device once.  uint32
tables are stored as int32 tensors holding the same bits (ops/uint.py).
salt_tpu's functions that make the same tables on the device (planes from
packed symbols, the 12-mer tables, sa_cat derived by sampled walks)
exist to send fewer bytes to a remote device and are not carried over;
what they produce is what matches.
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
    fuse_rank_index_pair,
    rank_indexes_to,
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


def build_sampled_sa(idx: SaltIndex, intv: int = 8) -> SampledSA:
    """The sampled locate tables of a host index, as host tensors."""
    n1 = len(idx.csa)            # n + 1 ranks
    mask = (idx.csa % np.uint32(intv)) == 0
    # rank 0 holds the sa[0] = 0xFFFFFFFF quirk; its position is n
    mask[0] = (n1 - 1) % intv == 0
    # the stored value keeps the rank-0 quirk byte for byte
    c_samples = idx.csa[mask]

    # R: '#' ranks are [cumfreq[4]+1, cumfreq[5]+1) in in-band-sentinel
    # rank coordinates (the sentinel suffix is rank 0)
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


def to_device_index(idx: SaltIndex, device, sa_mode: str = "full",
                    sa_intv: int = 8):
    """sa_mode="full": one-gather locate, 4 bytes a rank on the device;
    returns a DeviceIndex.  sa_mode="sampled": bounded LF-walk locate
    over the SampledSA tables; the rank planes of the two families share
    one tensor (C planes, then R planes), sa_cat is a placeholder, and
    the result is (DeviceIndex, SampledSA)."""
    if sa_mode not in ("full", "sampled"):
        raise ValueError(f"sa_mode={sa_mode!r}: expected 'full' or 'sampled'")
    if idx.r_lkt_sp is None:
        raise ValueError("index missing r_lkt tables; rebuild with current "
                         "version")
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
        # the two parts copied into place: no host copy of csa ++ r_coord
        # (18 GB at 3.1 G bases)
        sa_cat = torch.empty(c_sa_len + len(idx.r_coord), dtype=torch.int32,
                             device=dev)
        sa_cat[:c_sa_len].copy_(u32_table(idx.csa))
        sa_cat[c_sa_len:].copy_(u32_table(idx.r_coord))
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
