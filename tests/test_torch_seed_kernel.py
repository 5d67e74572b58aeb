"""Overlap seeding's CUDA kernel K3 (csrc/seed.cu) from the CPU side: the
dispatch of ops/seed.py:seed_overlap by device, the binding's refusals,
and the kernel's per-thread schedule modelled line by line in Python
and held to the plain version, seed_overlap_plain.

That the kernel itself computes this rests on chip_smoke.py, which holds
it to the plain version on a GPU; the plain version is held to salt_tpu
by tests/test_torch_rank_seed.py.  The model follows the source by hand
and guards what a schedule could get wrong without any GPU noticing at
the shapes tried: the C and R chains interleaved in one loop (R alone
over the window's last l_lkt bases without jump tables), the steps that
a bad base ends for only the families stepping on it, dead lanes that
load nothing, the two extension loops run as one with an l_ext each,
and the clamps and 32-bit wraps of ops/uint.py and ops/rank.py.  Every
comparison is exact."""

import numpy as np
import pytest
import torch

from salt_tpu_torch.index.build import build_index_from_data
from salt_tpu_torch.io.snp import SnpBlock
from salt_tpu_torch.ops import seed_cuda
from salt_tpu_torch.ops.cuda_build import MAX_READ_LEN
from salt_tpu_torch.ops.rank import fuse_rank_index_pair
from salt_tpu_torch.ops.seed import seed_overlap, seed_overlap_plain
from salt_tpu_torch.pipeline.device_index import to_device_index
from salt_tpu_torch.utils.metrics import counters, metrics_reset

U32 = 0xFFFFFFFF
M64 = (1 << 64) - 1
R_JUMP, R_FULL, SEED_ONLY_REF = 0, 1, 2


BASES = "ACGT"


@pytest.fixture(scope="module")
def fixture():
    """(device index on the CPU, int64 codes (B, L)): a 6,000-base genome
    holding six copies of one 240-base unit, copy i with i substitutions,
    and SNPs every 97 bases; reads from the copies (seeds in repeats, so
    that extension runs and stops where the copies part) and from
    elsewhere, with N, a code above N and N inside 12-mer tails."""
    rng = np.random.default_rng(8)
    g = rng.integers(0, 4, 6000)
    unit = rng.integers(0, 4, 240)
    starts = range(300, 5700, 900)
    for i, at in enumerate(starts):
        copy = unit.copy()
        j = rng.integers(0, 240, i)
        copy[j] = (copy[j] + 1) % 4
        g[at : at + 240] = copy
    pos = np.arange(50, 5950, 97).astype(np.uint32)
    alt = (g[pos] + rng.integers(1, 4, len(pos))) % 4
    stype = ((1 << g[pos]) | (1 << alt) | (g[pos] << 4)).astype(np.uint8)
    genome = "".join(BASES[c] for c in g)
    idx = build_index_from_data([("chr1", "repeat", genome)],
                                [SnpBlock("chr1", pos, stype)], l_seed=19)
    at = [s + int(rng.integers(0, 140)) for s in starts for _ in range(5)]
    at += [int(x) for x in rng.integers(0, 5900, 20)]
    codes = np.stack([g[a : a + 100] for a in at])
    codes[rng.random(codes.shape) < 0.01] = 4        # N
    codes[::11, 40] = 5                              # '-', a code above N
    codes[::7, -15:-10] = 4                          # N inside a 12-mer tail
    return (to_device_index(idx, "cpu"),
            torch.from_numpy(codes.astype(np.int64)))


def signed64(v):
    v &= M64
    return v - (1 << 64) if v >> 63 else v


def clamp(x, hi):
    return 0 if x < 0 else min(x, hi)


class Fam:
    """A family's rank index as the kernel's Family struct holds it."""

    def __init__(self, ri):
        self.bc = ri.bc.numpy()
        self.row_off, self.n_words = ri.row_off, ri.n_words
        self.cfreq = [int(x) for x in ri.cfreq]

    def row(self, idx, c):
        r = signed64(self.row_off + c * self.n_words + ((idx & U32) >> 5))
        return self.bc[clamp(r, self.bc.shape[0] - 1)]

    def base(self, c):
        return self.cfreq[clamp(c, len(self.cfreq) - 1)]


def rank_of(row, idx):
    mask = (1 << (idx & 31)) - 1
    return int(row[0]) + bin(int(row[1]) & U32 & mask).count("1")


def ugt(a, b):
    return (a & U32) > (b & U32)


def lf_apply(lane, rk, rl, base):
    kn = base + rank_of(rk, lane[0]) + 1
    ln = base + rank_of(rl, lane[1] + 1)
    if ugt(kn, ln):
        lane[2] = False
    else:
        lane[0], lane[1] = kn, ln


def table(t, i):
    return int(t[clamp(i, t.shape[0] - 1)])


def k3_thread(q, p, a, fc, fr):
    """One thread of seed_overlap_kernel: the row's codes q, seed start p.
    Returns ((sp, ep, offset, valid) of C, the same of R)."""
    mode, l_seed, l_lkt = a["mode"], a["l_seed"], a["l_lkt"]
    n_lf = l_seed - l_lkt
    two, r_jump = mode != SEED_ONLY_REF, mode == R_JUMP
    w = q[p:]
    has_n, kmer = False, 0
    for j in range(n_lf, l_seed):
        c = int(w[j])
        if c > 3:
            has_n, c = True, 0
        kmer = (kmer * 4 + c) & M64
    km = signed64(kmer)
    sp, ep = table(a["lkt"], km), table(a["lkt"], signed64(kmer + 1))
    C = [1, 0] if has_n else [sp, ep - 1]
    C.append(not ugt(C[0], C[1]))
    if r_jump:
        R = [1, 0] if has_n else [table(a["r_lkt_sp"], km),
                                  table(a["r_lkt_ep"], km)]
        R.append(not ugt(R[0], R[1]))
    else:
        R = [0, a["n_r"], mode == R_FULL]

    for j in range(n_lf - 1 if r_jump or not two else l_seed - 1, -1, -1):
        c_on = j < n_lf and C[2]
        r_on = (j < n_lf or not r_jump) and R[2]
        if not c_on and not r_on:
            if not C[2] and not R[2]:
                break
            continue
        c = int(w[j])
        if c > 3:
            if c_on:
                C[2] = False
            if r_on:
                R[2] = False
            continue
        if c_on:
            ck, cl = fc.row(C[0], c), fc.row(C[1] + 1, c)
        if r_on:
            rk, rl = fr.row(R[0], c), fr.row(R[1] + 1, c)
        if c_on:
            lf_apply(C, ck, cl, fc.base(c))
        if r_on:
            lf_apply(R, rk, rl, fr.base(c))

    ms = a["max_seed"] & U32
    ext = []
    for lane, on, fam, check_n in ((C, True, fc, True), (R, two, fr, False)):
        ext.append([lane[0], lane[1], 0, on and lane[2]
                    and ugt(lane[1] - lane[0], ms) and p > 0, fam, check_n])
    while ext[0][3] or ext[1][3]:
        loads = []
        for e in ext:   # every active family's two rows first
            if e[3]:
                c = int(q[p - e[2] - 1])
                cs = min(c, 4)
                loads.append((c, cs, e[4].row(e[0], cs), e[4].row(e[1] + 1, cs)))
            else:
                loads.append(None)
        for e, ld in zip(ext, loads):
            if ld is None:
                continue
            c, cs, rk, rl = ld
            ok, ol = rank_of(rk, e[0]), rank_of(rl, e[1] + 1)
            if not ok + 1 > ol and (c <= 3 or not e[5]):
                base = e[4].base(cs)
                e[0], e[1], e[2] = base + ok + 1, base + ol, e[2] + 1
                e[3] = ugt(e[1] - e[0], ms) and e[2] < p
            else:
                e[3] = False
    (ck_, cl_, cx, _, _, _), (rk_, rl_, rx, _, _, _) = ext
    c_out = (ck_, cl_, p - cx, C[2])
    r_out = (rk_, rl_, p - rx, R[2]) if two else (1, 0, 0, False)
    return c_out, r_out


def k3_model(ri_c, ri_r, lkt, seq, l_seed, l_overlap, max_seed, l_lkt=12,
             seed_only_ref=False, r_lkt_sp=None, r_lkt_ep=None):
    """The launch: one k3_thread a (row, seed start)."""
    mode = (SEED_ONLY_REF if seed_only_ref
            else R_JUMP if r_lkt_sp is not None else R_FULL)
    a = {"mode": mode, "l_seed": l_seed, "l_lkt": l_lkt, "max_seed": max_seed,
         "n_r": ri_r.n, "lkt": lkt.numpy(),
         "r_lkt_sp": None if r_lkt_sp is None else r_lkt_sp.numpy(),
         "r_lkt_ep": None if r_lkt_ep is None else r_lkt_ep.numpy()}
    fc, fr = Fam(ri_c), Fam(ri_r)
    B, L = seq.shape
    S = (L - l_seed) // l_overlap + 1
    q = seq.numpy()
    out = np.zeros((2, 4, B, S), np.int64)
    for b in range(B):
        for s in range(S):
            for f, vals in enumerate(k3_thread(q[b], s * l_overlap, a, fc, fr)):
                out[f, :, b, s] = vals
    return out


def plain_kwargs(dix, variant):
    kw = {"seed_only_ref": variant == "seed_only_ref"}
    if variant == "r_lkt":
        kw.update(r_lkt_sp=dix.r_lkt_sp, r_lkt_ep=dix.r_lkt_ep)
    return kw


@pytest.mark.parametrize("planes", ["standalone", "fused"])
@pytest.mark.parametrize("variant", ["r_lkt", "lf_only", "seed_only_ref"])
@pytest.mark.parametrize("l_overlap,max_seed", [(1, 50), (3, 2), (21, 0)])
def test_k3_schedule_matches_plain(fixture, variant, planes, l_overlap,
                                   max_seed):
    dix, seq = fixture
    ri_c, ri_r = dix.ri_c, dix.ri_r
    if planes == "fused":
        # one plane tensor, C rows first: a rank row is clamped to both
        # families' rows
        ri_c, ri_r = fuse_rank_index_pair(ri_c, ri_r)
    kw = plain_kwargs(dix, variant)
    want = seed_overlap_plain(ri_c, ri_r, dix.lkt, seq, dix.l_seed, l_overlap,
                              max_seed, **kw)
    got = k3_model(ri_c, ri_r, dix.lkt, seq, dix.l_seed, l_overlap, max_seed,
                   **kw)
    for f, fam in enumerate(want):
        for i, name in enumerate(("sp", "ep", "offset", "valid")):
            assert np.array_equal(got[f, i], getattr(fam, name).long().numpy()), \
                (f, name)
    c = want[0]
    assert c.valid.any() and (~c.valid).any()
    if max_seed < 50:      # extension ran, and so did its early exits
        assert (c.offset < torch.arange(c.offset.shape[1]) * l_overlap).any()


@pytest.mark.parametrize("variant", ["r_lkt", "lf_only", "seed_only_ref"])
def test_seed_overlap_runs_plain_on_cpu(fixture, variant):
    dix, seq = fixture
    kw = plain_kwargs(dix, variant)
    launches = seed_cuda.SEED.launches
    metrics_reset()
    got = seed_overlap(dix.ri_c, dix.ri_r, dix.lkt, seq, dix.l_seed, 1, 50,
                       **kw)
    S = seq.shape[1] - dix.l_seed + 1
    assert counters()["k3.seeds"] == seq.shape[0] * S
    assert seed_cuda.SEED.launches == launches == 0
    want = seed_overlap_plain(dix.ri_c, dix.ri_r, dix.lkt, seq, dix.l_seed, 1,
                              50, **kw)
    for fam_g, fam_w in zip(got, want):
        for name in ("sp", "ep", "offset", "valid"):
            assert torch.equal(getattr(fam_g, name), getattr(fam_w, name)), name


@pytest.mark.parametrize("L,match", [(100, "CUDA tensors"),
                                     (MAX_READ_LEN + 1, "read length"),
                                     (0, "read length"),
                                     (18, "l_seed")])
def test_seed_kernel_binding_refuses(fixture, L, match):
    dix, _seq = fixture
    seq = torch.zeros((4, L), dtype=torch.int64)
    launches = seed_cuda.SEED.launches
    metrics_reset()
    with pytest.raises(ValueError, match=match):
        seed_cuda.seed_overlap_cuda(dix.ri_c, dix.ri_r, dix.lkt, seq,
                                    dix.l_seed, 1, 50)
    assert seed_cuda.SEED.launches == launches
    assert "k3.seeds" not in counters()
