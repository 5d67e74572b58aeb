"""Sampled suffix-array mode of salt_tpu_torch against salt's own walk
(salt_tpu_torch/reference/sa_walk.py), with nothing of salt_tpu: the
plain walk against the full tables at every rank, resolve_sampled
against the plain walk (rank 0 and '#' ranks included), `aln --sa-mode
sampled` against `aln`, tools/sa_walk_check, and the walk's span and
counters.  The index is the port's own build of a 40,003-base
repeat-rich genome with a SNP every 100 bases.  Tolerance: exact."""

import io
import json
from contextlib import redirect_stderr, redirect_stdout

import numpy as np
import pytest
import torch

from salt_tpu_torch import cli
from salt_tpu_torch.index.build import build_index_from_data
from salt_tpu_torch.index.store import save_index
from salt_tpu_torch.io.fasta import parse_records
from salt_tpu_torch.io.snp import SnpBlock
from salt_tpu_torch.ops import locate, rank
from salt_tpu_torch.pipeline import device_index as tdi
from salt_tpu_torch.pipeline import se as se_mod
from salt_tpu_torch.pipeline.engine import SEAligner, SEOptions
from salt_tpu_torch.reference.sa_walk import SaltLocate
from salt_tpu_torch.sim.genome_gen import (sample_snps, synthesize_genome,
                                           write_fasta)
from salt_tpu_torch.sim.wgsim import SimParams, simulate
from salt_tpu_torch.tools import sa_walk_check
from salt_tpu_torch.utils.metrics import (counters, metrics, metrics_reset,
                                          spans)

torch.set_num_threads(1)

GENOME_LEN = 40_003          # not a multiple of any intv: rank 0 walks
INTVS = (4, 8, 16)
WALK = "device.sa_walk"
COUNTERS = ("sa_walk.blocks", "sa_walk.slots")


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """The genome as FASTA, the index and its bundle, and 120 wgsim reads
    (1% errors, 40% of mutations indels) as FASTQ."""
    d = tmp_path_factory.mktemp("sa_walk")
    ((name, codes),) = synthesize_genome(GENOME_LEN, 1, seed=3)
    rng = np.random.default_rng(3)
    n = codes == 4                      # keep the repeats, not the N runs
    codes[n] = rng.integers(0, 4, int(n.sum()))
    gpos, _alt, stype = sample_snps(codes, 100, rng)
    write_fasta([(name, codes)], str(d / "genome.fa"))
    idx = build_index_from_data(
        [(name, "repeat", "".join("ACGT"[c] for c in codes))],
        [SnpBlock(name, gpos.astype(np.uint32), stype)], l_seed=19)
    save_index(idx, str(d / "idx"))
    r1, r2 = io.StringIO(), io.StringIO()
    simulate(str(d / "genome.fa"), r1, r2,
             SimParams(err_rate=0.01, mut_rate=0.005, indel_frac=0.4,
                       n_pairs=120, size_l=100, size_r=100, dist=300,
                       std_dev=30, seed=5), mut_out=io.StringIO())
    (d / "reads.fq").write_text(r1.getvalue())
    r1.seek(0)
    return {"idx": idx, "prefix": str(d / "idx"),
            "reads": str(d / "reads.fq"), "records": list(parse_records(r1))}


def _sharp(idx):
    return int(idx.r_cumfreq[4]) + 1, int(idx.r_cumfreq[5]) + 1


# ------------------------------------------------------------- the plain walk


@pytest.mark.parametrize("intv", INTVS)
@pytest.mark.parametrize("family", ["c", "r"])
def test_plain_walk_equals_the_full_tables_at_every_rank(work, family, intv):
    idx = work["idx"]
    walk = SaltLocate(idx, intv)
    if family == "c":
        got = walk.c_values(np.arange(len(idx.csa)))
        want = idx.csa
        assert got[0] == 0xFFFFFFFF          # bwt_cal_sa's sa[0] = -1
    else:
        got = walk.r_values(np.arange(len(idx.r_coord)))
        want = idx.r_coord
        lo, hi = _sharp(idx)
        assert hi - lo > 100 and (got[lo:hi] == 0xFFFFFFFF).all()
    assert np.array_equal(got, want.astype(np.int64))


def test_plain_walk_samples_by_rank_and_stops_at_sharps(work):
    """salt's layout: C values kept at ranks k % intv == 0 only, R values
    at '#' ranks only, and C walks longer than intv - 1 steps (a rank
    sample is no text-position sample)."""
    idx = work["idx"]
    walk = SaltLocate(idx, 8)
    assert len(walk.c_samples) == -(-len(idx.csa) // 8)
    lo, hi = _sharp(idx)
    assert len(walk.sharp_values) == hi - lo
    _k, steps = walk._walk(walk.c, np.arange(len(idx.csa)),
                           lambda r: r % 8 == 0)
    assert steps.max() > 7 and steps.mean() == pytest.approx(7, abs=1.5)


def test_plain_walk_on_a_zero_snp_index():
    rng = np.random.default_rng(8)
    seq = "".join("ACGT"[c] for c in rng.integers(0, 4, 3001))
    idx = build_index_from_data([("c1", "t", seq)], [], l_seed=19)
    walk = SaltLocate(idx, 8)
    assert np.array_equal(walk.c_values(np.arange(len(idx.csa))),
                          idx.csa.astype(np.int64))
    assert np.array_equal(walk.r_values(np.arange(len(idx.r_coord))),
                          idx.r_coord.astype(np.int64))


def test_plain_walk_refuses_an_inconsistent_bundle(work):
    import dataclasses

    with pytest.raises(ValueError, match="sharp_bases"):
        SaltLocate(dataclasses.replace(
            work["idx"], sharp_bases=np.zeros(3, np.uint32)))


# ------------------------------------------------------------- resolve_sampled


@pytest.mark.parametrize("planes", ["fused", "standalone"])
@pytest.mark.parametrize("intv", INTVS)
def test_resolve_sampled_equals_the_plain_walk(work, intv, planes):
    idx = work["idx"]
    ranks, is_r = sa_walk_check.draw_ranks(idx, 3000, 64,
                                           np.random.default_rng(intv))
    lo, hi = _sharp(idx)
    assert ranks[0] == ranks[3000] == 0
    assert np.sum(is_r & (ranks >= lo) & (ranks < hi)) >= 64
    dix, sam = tdi.to_device_index(idx, "cpu", "sampled", intv)
    ri = (dix.ri_c, dix.ri_r) if planes == "fused" else (
        rank.build_rank_index(idx.cbwt, np.append(idx.c_l2, 0)),
        rank.build_rank_index(idx.rbwt, np.append(idx.r_cumfreq, 0)))
    assert rank.planes_fused(*ri) == (planes == "fused")
    got = locate.resolve_sampled(
        sam, *ri, torch.from_numpy(ranks), torch.from_numpy(is_r),
        torch.ones(len(ranks), dtype=torch.bool)).numpy()
    want = SaltLocate(idx, intv).values(ranks, is_r)
    assert np.array_equal(got, want)
    assert got[0] == got[3000] == 0xFFFFFFFF


def test_sa_walk_check_tool(work, capsys):
    """The check of a bundle on the card, here on the CPU: every route
    agrees, exit code 0."""
    rc = sa_walk_check.main([work["prefix"], "--ranks", "2000", "--device",
                             "cpu"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and out["ranks_per_family"] == 2000
    assert out["on_sharp"] >= 64
    assert out["full_tables_differ"] == 0
    assert out["resolve_sampled_fused_differ"] == 0
    assert out["resolve_sampled_standalone_differ"] == 0


def test_sa_walk_check_holds_an_aligners_own_tables(work, monkeypatch):
    """check() given an aligner's (dix, sampled) walks those tensors, not a
    copy it builds, and every route agrees."""
    al = SEAligner(work["idx"], SEOptions(sa_mode="sampled"), device="cpu")
    built = []
    monkeypatch.setattr(sa_walk_check, "to_device_index",
                        lambda *a: built.append(a))
    out = sa_walk_check.check(work["idx"], "cpu", 1000, (al.dix, al.sampled))
    assert built == []
    assert out["intv"] == al.sampled.intv == SEOptions.sa_intv == 8
    assert out["on_sharp"] >= sa_walk_check.N_SHARP
    assert not [k for k, v in out.items() if k.endswith("_differ") and v]


# ------------------------------------------------------------- the aligner


def _aln(argv):
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        rc = cli.main(argv)
    assert rc == 0, err.getvalue()
    return [line for line in out.getvalue().splitlines()
            if not line.startswith("@PG")]


def test_cli_sampled_sam_equals_full(work):
    base = ["aln", "--device", "cpu", "-d", "-c", "--batch-size", "64"]
    full = _aln(base + [work["prefix"], work["reads"]])
    sampled = _aln(base + ["--sa-mode", "sampled", work["prefix"],
                           work["reads"]])
    assert sum(1 for line in full if not line.startswith("@")) == 120
    assert "\n".join(sampled) == "\n".join(full)
    assert sum(1 for line in full if line.startswith("@SQ")) == 1


def _spy_locate(monkeypatch):
    """Wrap the ungapped step's locate: each call's `need`, the largest
    candidate stream of its rows, at most cap (ops/locate.py)."""
    calls = []
    real = se_mod.locate

    def spy(c_seeds, r_seeds, sa_cat, c_sa_len, l_seq, l_mref, max_locate,
            cap, pe_mode=False, **kw):
        cnt = torch.cat([
            locate._family(c_seeds, False, pe_mode, max_locate)[1],
            locate._family(r_seeds, True, pe_mode, max_locate)[1]], 1)
        total = torch.clamp(cnt, max=cap + 1).sum(1)
        calls.append((c_seeds.sp.shape[0], cap,
                      min(int(total.max()), cap)))
        return real(c_seeds, r_seeds, sa_cat, c_sa_len, l_seq, l_mref,
                    max_locate, cap, pe_mode=pe_mode, **kw)

    monkeypatch.setattr(se_mod, "locate", spy)
    return calls


def _se_call(idx, records, mode):
    al = SEAligner(idx, SEOptions(sa_mode=mode, max_locate=500,
                                  batch_size=64, print_nm_md=True),
                   device="cpu")
    metrics_reset()
    lines = al.align_records(records)
    return lines, dict(metrics(), parents=spans()), counters()


def test_sampled_call_counts_its_walk_blocks(work, monkeypatch):
    calls = _spy_locate(monkeypatch)
    full, full_stages, full_counts = _se_call(work["idx"], work["records"],
                                              "full")
    n_full = len(calls)
    sampled, stages, counts = _se_call(work["idx"], work["records"],
                                       "sampled")
    assert sampled == full
    mine = calls[n_full:]
    assert len(mine) == n_full >= 2
    blocks = sum(-(-need // 128) for _b, _cap, need in mine)
    assert all(cap > 128 for _b, cap, _n in mine)
    assert blocks > len(mine)            # repeats take more than one block
    assert counts["sa_walk.blocks"] == blocks
    assert counts["sa_walk.slots"] == sum(
        rows * 128 * -(-need // 128) for rows, _cap, need in mine)
    assert stages[WALK][1] == blocks
    assert stages["device.locate"][1] == len(mine)
    # the walk's span nests under locate, and reads nothing back: the one
    # read-back a locate call more is the chunked loop's total.max()
    assert stages["parents"][WALK][3] == "device.locate"
    assert stages["device.locate"][0] >= stages[WALK][0]
    assert counts["host.sync"] - full_counts["host.sync"] == len(mine)


def test_full_call_opens_no_walk_span_or_counter(work):
    _lines, stages, counts = _se_call(work["idx"], work["records"][:40],
                                      "full")
    assert stages["device.locate"][1] > 0
    assert WALK not in stages
    assert not set(COUNTERS) & set(counts)
