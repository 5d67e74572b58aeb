"""Sampled suffix-array mode of salt_tpu_torch against salt_tpu and
against the full tables, on the same numpy-seeded inputs: the sampled
structures field by field, the LF-walk resolver (fused and standalone
rank planes), the fused plane buffer, the chunked locate loop against
the flat one, and the slice as a whole (SE with Landau-Vishkin and
Smith-Waterman extension, PE).  Tolerance: exact (ranks, positions and
SAM bytes)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from salt_tpu.index.build import build_index_from_data
from salt_tpu.io.snp import SnpBlock
from salt_tpu.ops import locate as jlocate
from salt_tpu.ops.seed import Seeds as JaxSeeds
from salt_tpu.pipeline import device_index as jdi
from salt_tpu.pipeline.engine import SEAligner as JaxAligner
from salt_tpu.pipeline.engine import SEOptions as JaxOptions
from salt_tpu.pipeline.pe_engine import PEAligner as JaxPEAligner
from salt_tpu.pipeline.pe_engine import PEOptions as JaxPEOptions
from salt_tpu_torch.ops import locate, rank
from salt_tpu_torch.ops.seed import Seeds
from salt_tpu_torch.pipeline import device_index as tdi
from salt_tpu_torch.pipeline.engine import SEAligner, SEOptions
from salt_tpu_torch.pipeline.pe_engine import PEAligner, PEOptions
from salt_tpu_torch.utils.metrics import metrics, metrics_reset

from torch_fixtures import (
    BASES,
    planted_pairs,
    port_index,
    repeat_fixture,
    tiny_fixture,
    tiny_genome,
)

ARRAYS = ("sel_cat", "samples_cat", "syms_cat")
FIELDS = ("c_words", "c_sel_rows", "c_n_samples", "sharp_lo", "sharp_hi",
          "intv", "max_r_walk")


def _bits(a):
    """Any integer array or tensor as the uint32 bit patterns it holds."""
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.astype(np.int64) & 0xFFFFFFFF


def _genome(seed, n):
    rng = np.random.default_rng(seed)
    return rng, "".join(BASES[c] for c in rng.integers(0, 4, n))


def _snp_index(seed=17, n=6000, n_snp=60):
    """The 6,000-base, 60-SNP index of salt_tpu's own sampled-mode tests."""
    rng, seq = _genome(seed, n)
    pos = np.sort(rng.choice(np.arange(50, n - 50), n_snp, replace=False)
                  ).astype(np.uint32)
    stype = []
    for p in pos:
        ref = BASES.index(seq[p])
        alt = (ref + int(rng.integers(1, 4))) % 4
        stype.append((1 << ref) | (1 << alt) | (ref << 4))
    return build_index_from_data(
        [("c1", "t", seq)], [SnpBlock("c1", pos, np.array(stype, np.uint8))],
        l_seed=19)


def _index(kind):
    if kind == "exact":
        return _snp_index()
    _rng, seq = _genome(17, 6000)
    if kind == "zero_snp":
        return build_index_from_data([("c1", "t", seq)], [], l_seed=19)
    # the reference's quirky coordinate bases
    return build_index_from_data(
        [("c1", "t", seq)],
        [SnpBlock("c1", np.array([100, 200], np.uint32),
                  np.array([0x13, 0x26], np.uint8))],
        l_seed=19, r_anchor_mode="reference_compat")


@pytest.fixture(scope="module", params=["exact", "reference_compat", "zero_snp"])
def built(request):
    """(salt_tpu index, its sampled device index, the port's, the port's
    standalone rank indexes)."""
    idx = _index(request.param)
    pidx = port_index(idx)
    solo = (rank.build_rank_index(pidx.cbwt, np.append(pidx.c_l2, 0)),
            rank.build_rank_index(pidx.rbwt, np.append(pidx.r_cumfreq, 0)))
    return (request.param, idx, jdi.to_device_index(idx, sa_mode="sampled"),
            tdi.to_device_index(pidx, "cpu", "sampled"), solo)


# ------------------------------------------------------------- structures


@pytest.mark.parametrize("intv", [8, 5])
def test_build_sampled_sa_matches(built, intv):
    _kind, idx, _jax, _port, _solo = built
    want = jdi.build_sampled_sa(idx, intv)
    got = tdi.build_sampled_sa(port_index(idx), intv)
    for name in ARRAYS:
        assert np.array_equal(_bits(getattr(got, name)),
                              _bits(getattr(want, name))), name
    for name in FIELDS:
        assert getattr(got, name) == getattr(want, name), name
    assert got.sel_cat.dtype == got.samples_cat.dtype == torch.int32
    assert got.table_bytes() == sum(
        np.asarray(getattr(want, n)).nbytes for n in ARRAYS)


def test_zero_snp_index_keeps_a_dummy_r_slot(built):
    kind, _idx, _jax, (_dix, sam), _solo = built
    n_r = sam.samples_cat.shape[0] - sam.c_n_samples
    if kind == "zero_snp":
        assert sam.sharp_lo == sam.sharp_hi and n_r == 1
        assert _bits(sam.samples_cat)[-1] == 0x80000000
    else:
        assert n_r >= sam.sharp_hi - sam.sharp_lo > 0


def test_sampled_device_index_layout(built):
    """Sampled mode: sa_cat is the two-word placeholder, the planes of the
    two families share one tensor (C rows, then R rows) equal to
    salt_tpu's, and every other table is the full mode's."""
    _kind, idx, (jdix, _jsam), (dix, _sam), solo = built
    assert dix.sa_cat.shape == (2,) and dix.c_sa_len == 1
    assert dix.ri_c.bc is dix.ri_r.bc
    assert dix.ri_c.row_off == 0 and dix.ri_r.row_off == 5 * dix.ri_c.n_words
    assert rank.planes_fused(dix.ri_c, dix.ri_r)
    assert not rank.planes_fused(*solo)
    assert np.array_equal(dix.ri_c.bc.numpy(), np.asarray(jdix.ri_c.bc))
    assert jdix.ri_r.row_off == dix.ri_r.row_off
    full = tdi.to_device_index(port_index(idx), "cpu")
    for name in ("lkt", "r_lkt_sp", "r_lkt_ep", "mixref_words"):
        assert torch.equal(getattr(dix, name), getattr(full, name)), name
    assert torch.equal(full.ri_c.bc, dix.ri_c.bc[: dix.ri_r.row_off])
    assert torch.equal(full.ri_r.bc, dix.ri_c.bc[dix.ri_r.row_off :])


def test_fused_views_move_together():
    """rank_indexes_to copies a shared plane tensor once: the views that
    come back still share it."""
    ri_c, ri_r = rank.fuse_rank_index_pair(
        rank.build_rank_index(np.array([0, 1, 4, 2], np.uint8),
                              np.array([0, 1, 2, 3, 3, 0])),
        rank.build_rank_index(np.array([5, 1, 0, 4, 3], np.uint8),
                              np.array([0, 1, 2, 2, 3, 4, 0])))
    moved = rank.rank_indexes_to("cpu", ri_c, ri_r)
    assert moved[0].bc is moved[1].bc and rank.planes_fused(*moved)
    assert ri_r.to("cpu").row_off == ri_r.row_off
    with pytest.raises(ValueError):
        rank.fuse_rank_index_pair(ri_c, ri_r)


def test_sampled_sa_refuses_inconsistent_bundles():
    pidx = port_index(_index("exact"))
    with pytest.raises(ValueError, match="inconsistent index bundle"):
        tdi.build_sampled_sa(dataclasses.replace(
            pidx, sharp_bases=np.zeros(0, np.uint32)))
    with pytest.raises(ValueError, match="missing sharp_bases"):
        tdi.build_sampled_sa(dataclasses.replace(pidx, sharp_bases=None))
    with pytest.raises(ValueError, match="sa_mode"):
        tdi.to_device_index(pidx, "cpu", "sparse")


# ------------------------------------------------------------- rank, resolver


@pytest.mark.parametrize("family", ["c", "r"])
def test_fused_rank_excl_equals_standalone(built, family):
    _kind, _idx, _jax, (dix, _sam), solo = built
    fused, alone = ((dix.ri_c, solo[0]) if family == "c"
                    else (dix.ri_r, solo[1]))
    rng = np.random.default_rng(5)
    idx = torch.from_numpy(np.concatenate([
        [0, 1, 31, 32, 33, fused.n, fused.n + 1],
        rng.integers(0, fused.n + 2, 400)]))
    for c in range(fused.n_sym):
        cc = torch.full_like(idx, c)
        assert torch.equal(rank.rank_excl(fused, idx, cc),
                           rank.rank_excl(alone, idx, cc)), c


def _resolver_inputs(idx, sam, rng, B=512):
    """2 x B ranks (C then R, rank 0 left out: no seed reaches it), a
    fifth of the lanes inactive, and ranks on a '#' among the R ones."""
    ranks_c = rng.integers(1, len(idx.csa), B)
    # a zero-SNP index has the sentinel's R rank only
    ranks_r = rng.integers(min(1, len(idx.r_coord) - 1), len(idx.r_coord), B)
    n_sharp = min(sam.sharp_hi - sam.sharp_lo, 40)
    ranks_r[:n_sharp] = sam.sharp_lo + np.arange(n_sharp)
    ranks_c[-3:] = [1, len(idx.csa) - 1, len(idx.csa) - 2]
    active = rng.random(2 * B) < 0.8
    active[B : B + n_sharp] = True
    return ranks_c, ranks_r, np.arange(2 * B) >= B, active


@pytest.mark.parametrize("planes", ["fused", "standalone"])
def test_resolve_sampled_matches(built, planes):
    kind, idx, (jdix, jsam), (dix, sam), solo = built
    rng = np.random.default_rng(3)
    ranks_c, ranks_r, is_r, active = _resolver_inputs(idx, sam, rng)
    if kind == "zero_snp":
        active &= ~is_r               # no R lane is ever active there
    rk = np.concatenate([ranks_c, ranks_r])
    ri = (dix.ri_c, dix.ri_r) if planes == "fused" else solo
    got = locate.resolve_sampled(
        sam, *ri, torch.from_numpy(rk), torch.from_numpy(is_r),
        torch.from_numpy(active)).numpy()
    want = np.asarray(jlocate.resolve_sampled(
        jsam, jdix.ri_c, jdix.ri_r, jnp.asarray(rk.astype(np.int32)),
        jnp.asarray(is_r), jnp.asarray(active)))
    # inactive lanes too: both walk nowhere and read the stop value of
    # the rank they stand on
    assert np.array_equal(got, want.astype(np.int64))
    table = np.concatenate([idx.csa[ranks_c], idx.r_coord[ranks_r]])
    assert np.array_equal(got[active], table[active].astype(np.int64))
    if kind != "zero_snp":
        on_sharp = is_r & (rk >= sam.sharp_lo) & (rk < sam.sharp_hi)
        assert on_sharp.sum() >= 2 and (got[on_sharp] == 0xFFFFFFFF).all()


def test_resolve_sampled_on_salt_tpu_tables(built):
    """The same tables in both packages: salt_tpu's SampledSA carried
    across with sampled_from_arrays gives salt_tpu's values."""
    _kind, idx, (jdix, jsam), (dix, _sam), _solo = built
    carried = tdi.sampled_from_arrays(
        *(np.asarray(getattr(jsam, n)) for n in ARRAYS),
        **{n: getattr(jsam, n) for n in FIELDS})
    rk = np.random.default_rng(4).integers(1, len(idx.csa), 256)
    is_r = np.zeros(256, bool)
    got = locate.resolve_sampled(
        carried, dix.ri_c, dix.ri_r, torch.from_numpy(rk),
        torch.from_numpy(is_r), torch.ones(256, dtype=torch.bool)).numpy()
    want = np.asarray(jlocate.resolve_sampled(
        jsam, jdix.ri_c, jdix.ri_r, jnp.asarray(rk.astype(np.int32)),
        jnp.asarray(is_r), jnp.ones(256, bool)))
    assert np.array_equal(got, want.astype(np.int64))
    assert np.array_equal(got, idx.csa[rk].astype(np.int64))


# ------------------------------------------------------------- chunked locate


def _seed_sets(idx, rng, B, S, l_seq, wide):
    """Random seed intervals inside the index's rank ranges; `wide` makes
    one read's stream overflow any cap."""
    out = []
    for n_sa in (len(idx.csa), len(idx.r_coord)):
        sp = rng.integers(1, n_sa - 60, (B, S))
        width = rng.integers(-1, 12, (B, S))
        width[rng.random((B, S)) < 0.1] = 45
        if wide:
            width[0] = 50
        ep = np.minimum(sp + width, n_sa - 1)
        off = rng.integers(0, l_seq, (B, S))
        valid = rng.random((B, S)) < 0.7
        valid[1] = False                       # a read with no seed at all
        out.append((sp, ep, off, valid))
    return out


def _torch_seeds(s):
    return Seeds(*(torch.from_numpy(a) for a in s))


@pytest.mark.parametrize("pe_mode", [False, True], ids=["se", "pe"])
@pytest.mark.parametrize("mode", ["full", "sampled"])
def test_locate_chunked_equals_flat(mode, pe_mode):
    idx = _snp_index(seed=23)
    pidx = port_index(idx)
    rng = np.random.default_rng(31 + pe_mode)
    B, S, l_seq, cap, max_locate = 12, 10, 100, 320, (30 if pe_mode else 400)
    cs, rs = _seed_sets(idx, rng, B, S, l_seq, wide=True)
    if mode == "sampled":
        dix, sam = tdi.to_device_index(pidx, "cpu", "sampled")
    else:
        dix, sam = tdi.to_device_index(pidx, "cpu"), None

    def run(chunk):
        return locate.locate(
            _torch_seeds(cs), _torch_seeds(rs), dix.sa_cat, dix.c_sa_len,
            l_seq, dix.l_pac, max_locate, cap, pe_mode=pe_mode, sampled=sam,
            ri_c=dix.ri_c, ri_r=dix.ri_r, chunk=chunk)

    flat = run(0)
    assert flat.overflow[0] and not flat.overflow.all()
    assert flat.loci.pushed.any() and not flat.loci.pushed[1].any()
    for chunk in (128, 48, cap, None):        # 48 does not divide 320
        got = run(chunk)
        assert torch.equal(got.overflow, flat.overflow), chunk
        assert torch.equal(got.loci.pushed, flat.loci.pushed), chunk
        # slots that hold no locus keep 0xFFFFFFFF in untouched blocks and
        # a computed value elsewhere; sort_loci keys both alike
        assert torch.equal(got.loci.pos[flat.loci.pushed],
                           flat.loci.pos[flat.loci.pushed]), chunk
        for g, w in zip(locate.sort_loci(got.loci), locate.sort_loci(flat.loci)):
            assert torch.equal(g, w), chunk
    # against salt_tpu: chunked there, flat here
    if mode == "sampled":
        jdix, jsam = jdi.to_device_index(idx, sa_mode="sampled")
    else:
        jdix, jsam = jdi.to_device_index(idx), None
    want = jlocate.locate(
        *(JaxSeeds(*(jnp.asarray(a.astype(np.int32) if a.dtype != bool else a)
                     for a in s)) for s in (cs, rs)),
        jdix.sa_cat, jdix.c_sa_len, l_seq, jdix.l_pac, max_locate, cap,
        pe_mode=pe_mode, sampled=jsam, ri_c=jdix.ri_c, ri_r=jdix.ri_r,
        chunk=128)
    assert np.array_equal(np.asarray(want.overflow), flat.overflow.numpy())
    for g, w in zip(locate.sort_loci(flat.loci), jlocate.sort_loci(want.loci)):
        assert np.array_equal(_bits(g), _bits(w))


def test_locate_chunked_leaves_dead_blocks_untouched():
    idx = _snp_index(seed=23)
    dix, sam = tdi.to_device_index(port_index(idx), "cpu", "sampled")
    cs, rs = _seed_sets(idx, np.random.default_rng(2), 6, 3, 100, wide=False)
    out = locate.locate(_torch_seeds(cs), _torch_seeds(rs), dix.sa_cat, 1, 100,
                        dix.l_pac, 200, 640, sampled=sam, ri_c=dix.ri_c,
                        ri_r=dix.ri_r)
    assert out.loci.pos.shape == (6, 640)
    assert (out.loci.pos[:, 256:] == 0xFFFFFFFF).all()
    assert not out.loci.pushed[:, 256:].any() and out.loci.pushed.any()


# ------------------------------------------------------------- the slice

LV_OPTS = dict(l_overlap=1, max_locate=500, print_nm_md=True,
               print_xa_cigar=True, batch_size=64, gap_batch=16)
# small caps force the overflow and full-width re-runs
REPEAT_OPTS = dict(LV_OPTS, max_locate=16, verify_width=8)
SW_OPTS = dict(LV_OPTS, extend_algo="sw", device_sw="on",
               device_sw_min_batch=1)


def _assert_same(want, got):
    assert len(want) == len(got)
    bad = [(a, b) for a, b in zip(want, got) if a != b]
    assert not bad, f"{len(bad)}/{len(want)} records differ; first: {bad[0]}"


def _se_three_ways(idx, records, opts):
    """SAM of salt_tpu in sampled mode, of the port in full mode and of
    the port in sampled mode, with the port's stage table."""
    pidx = port_index(idx)
    want = JaxAligner(idx, JaxOptions(sa_mode="sampled", **opts)
                      ).align_records(records)
    full = SEAligner(pidx, SEOptions(**opts), device="cpu").align_records(records)
    metrics_reset()
    got = SEAligner(pidx, SEOptions(sa_mode="sampled", **opts),
                    device="cpu").align_records(records)
    return want, full, got, metrics()


@pytest.mark.parametrize("algo", ["lv", "sw"])
def test_tiny_fixture_sampled_sam_identical(algo):
    idx, records = tiny_fixture()
    want, full, got, stages = _se_three_ways(
        idx, records, LV_OPTS if algo == "lv" else SW_OPTS)
    _assert_same(full, got)
    _assert_same(want, got)
    assert sum(1 for line in got if line.split("\t")[2] != "*") > len(got) // 2
    assert stages["device.gapped" if algo == "lv" else "host.sw_extend"][1] > 0


@pytest.mark.parametrize("algo", ["lv", "sw"])
def test_repeat_genome_sampled_sam_identical(algo, tmp_path):
    idx, records = repeat_fixture(str(tmp_path), n_reads=64)
    opts = REPEAT_OPTS if algo == "lv" else dict(SW_OPTS, max_locate=100)
    want, full, got, stages = _se_three_ways(idx, records, opts)
    _assert_same(full, got)
    _assert_same(want, got)
    if algo == "lv":
        assert stages["device.ungapped_full"][1] > 0
        assert any("I" in line.split("\t")[5] or "D" in line.split("\t")[5]
                   for line in got)


def test_planted_pairs_sampled_sam_identical():
    idx, genome, _pos, _stype, rng = tiny_genome()
    r1, r2 = planted_pairs(genome, rng)
    pidx = port_index(idx)
    opts = dict(LV_OPTS, device_sw="on", device_sw_min_batch=1)
    want = JaxPEAligner(idx, JaxPEOptions(sa_mode="sampled", **opts)
                        ).align_pairs(r1, r2)
    full = PEAligner(pidx, PEOptions(**opts), device="cpu").align_pairs(r1, r2)
    al = PEAligner(pidx, PEOptions(sa_mode="sampled", **opts), device="cpu")
    assert al._se.sampled is not None and al._se.dix.c_sa_len == 1
    got = al.align_pairs(r1, r2)
    _assert_same(full, got)
    _assert_same(want, got)
    assert any("S" in line.split("\t")[5] for line in got)       # SW rescue


def test_options_and_unknown_mode():
    o = SEOptions()
    assert (o.sa_mode, o.sa_intv, o.locate_chunk) == ("full", 8, None)
    assert PEOptions(sa_mode="sampled", sa_intv=4).sa_intv == 4
    with pytest.raises(ValueError, match="sa_mode"):
        SEAligner(port_index(_index("exact")), SEOptions(sa_mode="sparse"),
                  device="cpu")


def test_sampled_intervals_and_chunks_agree():
    """Another sampling interval and a flat locate give the same SAM."""
    idx, records = tiny_fixture(n_reads=32)
    pidx = port_index(idx)
    base = SEAligner(pidx, SEOptions(**LV_OPTS), device="cpu").align_records(records)
    for kw in (dict(sa_intv=4, locate_chunk=100),
               dict(sa_intv=16, locate_chunk=0)):
        got = SEAligner(pidx, SEOptions(sa_mode="sampled", **LV_OPTS, **kw),
                        device="cpu").align_records(records)
        _assert_same(base, got)
