"""The sampled-mode locate walk's CUDA kernel K4 (csrc/sa_walk.cu) from the
CPU side: the dispatch of ops/locate.py:resolve_sampled by device, the
binding's refusals, and the kernel's per-lane schedule modelled line by
line in Python and held to the plain version, resolve_sampled_plain.

That the kernel itself computes this rests on chip_smoke.py, which holds
it to the plain version on a GPU; the plain version is held to salt's own
walk by tests/test_torch_sa_walk_reference.py.  The model follows the
source by hand and guards what its schedule could get wrong without any
GPU noticing at the shapes tried: a lane that leaves its loop once done
(the plain version runs every trip with done lanes frozen), the select
row and symbol word loaded together for the next step, inactive lanes
that take no step, the trip bound (a zero-SNP index has no R stop rank),
the sentinel and '#' rules, ranks past 2^31 and past the bound, and
every table index clamped as ops/uint.take clamps it.  It also wraps the
LF sum mod 2^32 before the minimum with the bound, as the kernel does,
which these small indexes never reach.  Every comparison is exact."""

import dataclasses

import numpy as np
import pytest
import torch

from salt_tpu_torch.index.build import build_index_from_data
from salt_tpu_torch.io.snp import SnpBlock
from salt_tpu_torch.ops import locate, sa_walk_cuda
from salt_tpu_torch.ops.rank import build_rank_index, planes_fused
from salt_tpu_torch.pipeline.device_index import to_device_index
from salt_tpu_torch.utils.metrics import counters, metrics_reset

U32 = 0xFFFFFFFF
INTVS = (4, 8, 16)


def _index(snp_every):
    """A 6,001-base genome (not a multiple of any intv, so rank 0 walks)
    with a SNP every `snp_every` bases, or none."""
    rng = np.random.default_rng(20 + snp_every)
    g = rng.integers(0, 4, 6001)
    unit = g[1000:1300].copy()
    g[4000:4300] = unit          # one repeat: ranks with long walks
    snps = []
    if snp_every:
        pos = np.arange(30, 5990, snp_every).astype(np.uint32)
        alt = (g[pos] + rng.integers(1, 4, len(pos))) % 4
        stype = ((1 << g[pos]) | (1 << alt) | (g[pos] << 4)).astype(np.uint8)
        snps = [SnpBlock("chr1", pos, stype)]
    return build_index_from_data(
        [("chr1", "walk", "".join("ACGT"[c] for c in g))], snps, l_seed=19)


@pytest.fixture(scope="module")
def indexes():
    return {"snp": _index(50), "zero_snp": _index(0)}


def _tables(idx, intv, planes):
    _dix, sam = to_device_index(idx, "cpu", "sampled", intv)
    ri = (_dix.ri_c, _dix.ri_r) if planes == "fused" else (
        build_rank_index(idx.cbwt, np.append(idx.c_l2, 0)),
        build_rank_index(idx.rbwt, np.append(idx.r_cumfreq, 0)))
    assert planes_fused(*ri) == (planes == "fused")
    return sam, ri


def _lanes(idx, rng):
    """(rank, is_r, active): random ranks of both families, and ranks 0, 1,
    the bound and past it, '#' ranks and ranks past 2^31 (as wrapped int32
    and as int64 with bits above 32), each once active and once not."""
    n1c, n1r = len(idx.csa), len(idx.r_coord)
    lo, hi = int(idx.r_cumfreq[4]) + 1, int(idx.r_cumfreq[5]) + 1
    wide = [-1, -5, -2**31, 2**31 + 7, 2**32 + 3, 2**33 - 1]
    c = [0, 1, n1c - 1, n1c, n1c + 9] + wide
    r = [0, 1, n1r - 1, n1r] + wide + list(range(lo, min(hi, lo + 40)))
    special = ([(x, False) for x in c] + [(x, True) for x in r])
    rank = [x for x, _ in special] * 2
    is_r = [f for _, f in special] * 2
    active = [True] * len(special) + [False] * len(special)
    n_rand = 400
    rank += list(rng.integers(0, n1c, n_rand)) + list(rng.integers(0, n1r,
                                                                    n_rand))
    is_r += [False] * n_rand + [True] * n_rand
    active += list(rng.random(2 * n_rand) < 0.8)
    return (torch.tensor(rank, dtype=torch.int64),
            torch.tensor(is_r, dtype=torch.bool),
            torch.tensor(active, dtype=torch.bool))


def clamp(x, hi):
    return 0 if x < 0 else min(x, hi)


class Fam:
    """A family's rank index as the kernel's Family struct holds it."""

    def __init__(self, ri):
        self.bc = ri.bc.numpy()
        self.row_off, self.n_words = ri.row_off, ri.n_words
        self.cfreq = [int(x) for x in ri.cfreq]


class Tables:
    """The kernel's Tables struct."""

    def __init__(self, sam, ri_c, ri_r):
        self.sel = sam.sel_cat.numpy()
        self.samples = sam.samples_cat.numpy().view(np.uint32)
        self.syms = sam.syms_cat.numpy().view(np.uint32)
        self.woff = (0, sam.c_words)
        self.seloff = (0, sam.c_sel_rows)
        self.sampoff = (0, sam.c_n_samples)
        self.sharp = (sam.sharp_lo, sam.sharp_hi)
        self.n = (ri_c.n & U32, ri_r.n & U32)
        self.bound = ((ri_c.n - 1) & U32, (ri_r.n - 1) & U32)
        self.trips = max(sam.intv, sam.max_r_walk) + 1
        self.fam = (Fam(ri_c), Fam(ri_r))

    def sel_row(self, k, r):
        return self.sel[clamp((k >> 5) + self.seloff[r], len(self.sel) - 1)]

    def sym_word(self, k, r):
        return int(self.syms[clamp((k >> 3) + self.woff[r],
                                   len(self.syms) - 1)])


def stop_bit(row, k):
    return (int(row[1]) & U32) >> (k & 31) & 1


def count_below(row, k):
    mask = (1 << (k & 31)) - 1
    return int(row[0]) + bin(int(row[1]) & U32 & mask).count("1")


def k4_lane(t, rank, r, on):
    """One thread of sa_walk_kernel.  Returns (out, steps)."""
    bound = t.bound[r]
    k = min(rank & U32, bound)
    at_sentinel = on and k == 0
    sel = t.sel_row(k, r)
    steps = 0
    if on:
        f = t.fam[r]
        rank_sym, cfreq_sym = (5, 6) if r else (4, 5)
        word = t.sym_word(k, r)
        while steps < t.trips and not stop_bit(sel, k):
            sym = (word >> ((k & 7) * 4)) & 15
            iu = min(k, t.n[r])
            row = f.bc[clamp(f.row_off + min(sym, rank_sym) * f.n_words
                             + (iu >> 5), len(f.bc) - 1)]
            base = f.cfreq[clamp(min(sym, cfreq_sym), len(f.cfreq) - 1)]
            k = min((base + count_below(row, iu) + 1) & U32, bound)
            steps += 1
            sel, word = t.sel_row(k, r), t.sym_word(k, r)
    slot = count_below(sel, k) + t.sampoff[r]
    val = int(t.samples[clamp(slot, len(t.samples) - 1)])
    ks = k - 2**32 if k >> 31 else k
    on_sharp = t.sharp[0] <= ks < t.sharp[1]
    if at_sentinel or (r and steps == 0 and on_sharp):
        return U32, steps
    return (val + steps) & U32, steps


def k4_model(sam, ri_c, ri_r, rank, is_r, active):
    """The launch: one k4_lane a lane.  Returns (out, steps) arrays."""
    t = Tables(sam, ri_c, ri_r)
    res = [k4_lane(t, int(x), int(r), bool(a))
           for x, r, a in zip(rank.tolist(), is_r.tolist(), active.tolist())]
    return (np.array([v for v, _ in res], np.int64),
            np.array([s for _, s in res]))


@pytest.mark.parametrize("index", ["snp", "zero_snp"])
@pytest.mark.parametrize("planes", ["fused", "standalone"])
@pytest.mark.parametrize("intv", INTVS)
def test_k4_schedule_matches_plain(indexes, index, planes, intv):
    idx = indexes[index]
    sam, (ri_c, ri_r) = _tables(idx, intv, planes)
    rank, is_r, active = _lanes(idx, np.random.default_rng(intv))
    want = locate.resolve_sampled_plain(sam, ri_c, ri_r, rank, is_r, active)
    got, steps = k4_model(sam, ri_c, ri_r, rank, is_r, active)
    assert np.array_equal(got, want.numpy())
    on = active.numpy()
    # inactive lanes take no step; active ones leave at every count
    assert not steps[~on].any()
    assert set(steps[on]) >= set(range(intv))
    assert want[0] == U32                        # rank 0, active
    fam = is_r.numpy()
    if index == "zero_snp":
        # no R stop rank: R walks end at the trip bound
        assert (steps[on & fam] == intv + 1).all()
    else:
        assert steps.max() < intv
        lo, hi = sam.sharp_lo, sam.sharp_hi
        r = rank.numpy()
        sharp = fam & (r >= lo) & (r < hi)
        assert sharp.sum() >= 40 and (want.numpy()[sharp] == U32).all()


def test_resolve_sampled_runs_plain_on_cpu(indexes):
    idx = indexes["snp"]
    sam, ri = _tables(idx, 8, "fused")
    rank, is_r, active = _lanes(idx, np.random.default_rng(1))
    launches = sa_walk_cuda.SA_WALK.launches
    metrics_reset()
    got = locate.resolve_sampled(sam, *ri, rank, is_r, active)
    assert torch.equal(got, locate.resolve_sampled_plain(sam, *ri, rank, is_r,
                                                         active))
    assert sa_walk_cuda.SA_WALK.launches == launches == 0
    assert "k4.lanes" not in counters()


def _broken(case, sam, ri_c, ri_r, rank, is_r, active):
    """The arguments of one refused call."""
    if case == "dtype":
        rank = rank.int()
    elif case == "shape":
        is_r = is_r[:-1]
    elif case == "device":
        active = active.to("meta")
    elif case == "cfreq":
        ri_c = dataclasses.replace(ri_c, cfreq=torch.zeros(17,
                                                           dtype=torch.int64))
    elif case == "table":
        sam = dataclasses.replace(sam, samples_cat=sam.samples_cat[:0])
    return sam, ri_c, ri_r, rank, is_r, active


@pytest.mark.parametrize("case,match", [
    ("dtype", "rank has dtype"), ("shape", "is_r has shape"),
    ("device", "active is on meta"), ("cfreq", "ri_c.cfreq must hold"),
    ("table", "samples_cat must be a non-empty"), ("cpu", "CUDA tensors")])
def test_sa_walk_binding_refuses(indexes, case, match):
    idx = indexes["snp"]
    sam, (ri_c, ri_r) = _tables(idx, 8, "standalone")
    rank, is_r, active = _lanes(idx, np.random.default_rng(2))
    args = _broken(case, sam, ri_c, ri_r, rank, is_r, active)
    launches = sa_walk_cuda.SA_WALK.launches
    metrics_reset()
    with pytest.raises((ValueError, TypeError), match=match):
        sa_walk_cuda.resolve_sampled_cuda(*args)
    assert sa_walk_cuda.SA_WALK.launches == launches
    assert sa_walk_cuda.SA_WALK._lib is None      # nothing was built
    assert "k4.lanes" not in counters()
