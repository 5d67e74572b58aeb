"""The sharded-by-bin aligner as a slice: on the 8-contig fixture of
tests/test_sharded_engine.py the port's sharded SAM (devices=["cpu"] * S)
is byte-identical to the port's monolithic SAM and to salt_tpu's
monolithic SAM, for SE with Landau-Vishkin extension at 8 and 3 shards,
SE with Smith-Waterman extension and PE at 4, and on a repeat-dense
variant where small widths force the overflow rows (Landau-Vishkin at 4
and 8 shards, Smith-Waterman at 2); and to salt_tpu's own sharded engine at 2 shards, also on reads
within 16 bases of a bin's first and last base, where the one rule that
tells a sharded run from a monolithic one is pinned down.  Tolerance:
exact."""

import pytest
import torch

from salt_tpu.index.build import build_index_from_data
from salt_tpu.pipeline.engine import SEAligner as JaxSE
from salt_tpu.pipeline.engine import SEOptions as JaxSEOptions
from salt_tpu.pipeline.pe_engine import PEAligner as JaxPE
from salt_tpu.pipeline.pe_engine import PEOptions as JaxPEOptions
from salt_tpu_torch.parallel.sharded_engine import (
    ShardedPEAligner,
    ShardedSEAligner,
)
from salt_tpu_torch.pipeline.engine import SEAligner, SEOptions
from salt_tpu_torch.pipeline.pe_engine import PEAligner, PEOptions
from salt_tpu_torch.utils.metrics import metrics, metrics_reset

from torch_fixtures import (
    bin_edge_reads,
    contig_fixture,
    contig_pairs,
    port_index,
    port_shards,
)

OPTS = dict(l_overlap=1, max_seed=50, max_locate=300, print_nm_md=True,
            print_xa_cigar=True, batch_size=64, gap_batch=16, verify_width=32)
PE_OPTS = dict(min_tlen=250, max_tlen=550, **OPTS)
# small widths: locate and the compact verify are truncated for the reads
# inside the repeat, in every shard that holds it
NARROW = dict(max_locate=16, verify_width=4)
DENSE = dict(repeat_at=(600, 1400, 2200, 3000), gapped_repeats=True)

# name -> (fixture arguments, options over OPTS, shards)
SE_CASES = {
    "lv_8": ({}, {}, 8),
    "lv_3_uneven_bins": ({}, {}, 3),
    "x1_4": ({}, dict(extend_algo="sw"), 4),
    "overflow_4": (DENSE, NARROW, 4),
    # a shard of 8 holds at most 4 copies of the repeat: verify width 3
    "overflow_8": (DENSE, dict(NARROW, verify_width=3), 8),
    "overflow_x1_2": (DENSE, dict(extend_algo="sw", **NARROW), 2),
}


def _assert_same(want, got):
    assert len(want) == len(got)
    bad = [(a, b) for a, b in zip(want, got) if a != b]
    assert not bad, f"{len(bad)}/{len(want)} records differ; first: {bad[0]}"


@pytest.fixture(scope="module")
def genomes():
    """{fixture arguments: (contig_data, blocks, records, salt_tpu's
    monolithic index)}, built once a module."""
    made = {}

    def get(**kw):
        key = tuple(sorted(kw.items()))
        if key not in made:
            cd, bl, recs = contig_fixture(**kw)
            made[key] = (cd, bl, recs, build_index_from_data(cd, bl, l_seed=19))
        return made[key]

    return get


@pytest.fixture(scope="module")
def se_runs(genomes):
    """{case: (salt_tpu's monolithic SAM, the port's monolithic SAM, the
    port's sharded SAM, the sharded run's stage counts)}."""
    done = {}

    def get(case):
        if case not in done:
            fix, extra, n_shards = SE_CASES[case]
            cd, bl, recs, idx = genomes(**fix)
            opts = {**OPTS, **extra}
            want = JaxSE(idx, JaxSEOptions(**opts)).align_records(recs)
            mono = SEAligner(port_index(idx), SEOptions(**opts),
                             device="cpu").align_records(recs)
            shards, bins = port_shards(cd, bl, n_shards)
            metrics_reset()
            got = ShardedSEAligner(
                port_index(idx), shards, SEOptions(**opts),
                devices=["cpu"] * n_shards, bins=bins).align_records(recs)
            done[case] = (want, mono, got, {k: v[1] for k, v in metrics().items()})
        return done[case]

    return get


@pytest.mark.parametrize("case", SE_CASES)
def test_sharded_se_equals_port_monolithic(se_runs, case):
    _want, mono, got, _stages = se_runs(case)
    _assert_same(mono, got)
    assert sum(1 for line in got if line.split("\t")[2] != "*") > len(got) // 2


@pytest.mark.parametrize("case", SE_CASES)
def test_sharded_se_equals_salt_tpu_monolithic(se_runs, case):
    want, _mono, got, _stages = se_runs(case)
    _assert_same(want, got)


@pytest.mark.parametrize("case", ["lv_8", "lv_3_uneven_bins"])
def test_sharded_se_runs_the_gapped_step(se_runs, case):
    _want, _mono, got, stages = se_runs(case)
    assert stages["device.gapped"] > 0
    assert any("D" in line.split("\t")[5] for line in got)
    # the repeat reads carry XA hits from other shards' contigs
    assert any("XA:Z:" in line and line.count(";") >= 3 for line in got)


@pytest.mark.parametrize("case", ["overflow_4", "overflow_8"])
def test_sharded_overflow_rows_ran(se_runs, case):
    """The narrow widths send rows through the full-width re-verify of
    the ungapped step and the full-width gapped check."""
    stages = se_runs(case)[3]
    assert stages["device.ungapped_full"] > 0
    assert stages["device.gapped_full"] > 0


def test_sharded_overflow_rows_ran_with_sw_extension(se_runs):
    stages = se_runs("overflow_x1_2")[3]
    assert stages["device.ungapped_full"] > 0 and stages["host.sw_extend"] > 0


@pytest.fixture(scope="module")
def pe_runs(genomes):
    cd, bl, _recs, idx = genomes()
    r1, r2 = contig_pairs(cd)
    want = JaxPE(idx, JaxPEOptions(**PE_OPTS)).align_pairs(r1, r2)
    mono = PEAligner(port_index(idx), PEOptions(**PE_OPTS),
                     device="cpu").align_pairs(r1, r2)
    shards, bins = port_shards(cd, bl, 4)
    al = ShardedPEAligner(port_index(idx), shards, PEOptions(**PE_OPTS),
                          devices=["cpu"] * 4, bins=bins)
    return want, mono, al.align_pairs(r1, r2), al


def test_sharded_pe_equals_port_monolithic(pe_runs):
    _assert_same(pe_runs[1], pe_runs[2])
    assert len(pe_runs[2]) == 96


def test_sharded_pe_equals_salt_tpu_monolithic(pe_runs):
    _assert_same(pe_runs[0], pe_runs[2])


def test_sharded_pe_inner_aligner(pe_runs):
    """The PE aligner's SE stage is the sharded aligner, built by its
    constructor with the PE flavour of the options."""
    al = pe_runs[3]
    assert isinstance(al._se, ShardedSEAligner)
    assert al._se.opts.pe_locate and al._se.opts.gap_k == 3
    assert al._se.opts.k_hits == 16 and al.device == torch.device("cpu")


@pytest.fixture(scope="module")
def two_shards(genomes):
    """A 4-contig cut of the fixture in 2 bins of 14,100 and 4,000 bases:
    (records, salt_tpu's own sharded engine on its CPU mesh, the port's
    sharded aligner, salt_tpu's monolithic aligner, the port's)."""
    from salt_tpu.parallel.sharded_engine import build_sharded_se

    cd, bl, recs, idx = genomes(n_contigs=4, n_reads=64)
    ref = build_sharded_se(cd, bl, 2, opts=JaxSEOptions(**OPTS), l_seed=19)
    shards, bins = port_shards(cd, bl, 2)
    assert bins == [[0, 1, 2], [3]]
    got = ShardedSEAligner(port_index(ref.index), shards, SEOptions(**OPTS),
                           devices=["cpu"], bins=bins)
    return (recs, bin_edge_reads(cd, bins), ref, got,
            JaxSE(idx, JaxSEOptions(**OPTS)),
            SEAligner(port_index(idx), SEOptions(**OPTS), device="cpu"))


def test_sharded_equals_salt_tpu_sharded(two_shards):
    """salt_tpu's own sharded engine (2 shards on its CPU mesh) and the
    port's, on a cut-down fixture."""
    recs, _edge, ref, got, _jax_mono, _mono = two_shards
    _assert_same(ref.align_records(recs), got.align_records(recs))


@pytest.fixture(scope="module")
def edge_runs(two_shards):
    """{aligner: {read name: SAM line}} on reads 0..16 bases from the first
    and last base of each of the two bins."""
    _recs, edge, *aligners = two_shards
    names = ("salt_tpu sharded", "sharded", "salt_tpu monolithic", "monolithic")
    return {n: {line.split("\t")[0]: line for line in al.align_records(edge)}
            for n, al in zip(names, aligners)}


def _differing(a, b):
    return {name for name in a if a[name] != b[name]}


# A gapped candidate is skipped when its window reaches the end of the
# index it is checked in (position + read length + GAP_WINDOW_PAD >= l_pac,
# pipeline/se.py:_gapped_checked).  A sharded run holds that rule at a
# bin's end, the monolithic run only at the genome's.  So they differ on
# the reads that need the gapped step and whose last reference base lies
# within GAP_WINDOW_PAD + inserted - deleted bases of an inner bin's last
# base, and nowhere else.  Here: the reads with a 3 bp deletion 0-1 bases
# and those with a 2 bp insertion 0-6 bases from the end.
AT_INNER_END = ({f"b0_tail_{off}_del" for off in range(2)}
                | {f"b0_tail_{off}_ins" for off in range(7)})
AT_GENOME_END = {name.replace("b0", "b1") for name in AT_INNER_END}


def test_bin_edges_monolithic_equals_salt_tpu(edge_runs):
    assert edge_runs["monolithic"] == edge_runs["salt_tpu monolithic"]
    assert len(edge_runs["monolithic"]) == 2 * 17 * 4 * 2


def test_bin_edges_sharded_differs_from_monolithic_only_at_an_inner_end(
        edge_runs):
    """Reads at the first bases of a bin, ungapped reads anywhere, and
    gapped reads at the genome's end get the monolithic record."""
    assert _differing(edge_runs["sharded"],
                      edge_runs["monolithic"]) == AT_INNER_END


def test_bin_edges_inner_end_is_salt_tpus_own(edge_runs):
    """At the inner bin boundary salt_tpu's sharded engine leaves its
    monolithic result on the same reads, with the same records as the
    port's."""
    ours, theirs = edge_runs["sharded"], edge_runs["salt_tpu sharded"]
    assert all(ours[name] == theirs[name] for name in AT_INNER_END)
    assert AT_INNER_END <= _differing(theirs, edge_runs["salt_tpu monolithic"])


def test_bin_edges_differ_from_salt_tpu_sharded_only_by_its_padding(edge_runs):
    """salt_tpu pads the smaller shard to the larger one's length and holds
    the end rule at the padded length, so it aligns the gapped reads at
    the end of the smaller shard (here the genome's end, where its
    monolithic run skips them); the port holds the rule at every shard's
    own end.  Nothing else differs."""
    assert _differing(edge_runs["sharded"],
                      edge_runs["salt_tpu sharded"]) == AT_GENOME_END
    mapped = [edge_runs["salt_tpu sharded"][n].split("\t")[2] != "*"
              for n in AT_GENOME_END]
    assert all(mapped)


def test_build_sharded_se_with_the_ports_own_index_build(genomes):
    """build_sharded_se (the port's host build of every index) gives the
    SAM of the indexes carried across from salt_tpu."""
    from salt_tpu_torch.io.snp import SnpBlock
    from salt_tpu_torch.parallel.sharded_engine import build_sharded_se

    cd, bl, recs, idx = genomes(n_contigs=4, n_reads=64)
    blocks = [SnpBlock(b.chrom, b.pos, b.stype) for b in bl]
    al = build_sharded_se(cd, blocks, 2, opts=SEOptions(**OPTS),
                          devices=["cpu", "cpu"], l_seed=19)
    assert al.n_shards == 2 and len(al.stacked.shards) == 2
    mono = SEAligner(port_index(idx), SEOptions(**OPTS),
                     device="cpu").align_records(recs)
    _assert_same(mono, al.align_records(recs))


def test_sharded_errors(genomes):
    cd, bl, _recs, idx = genomes()
    shards, bins = port_shards(cd, bl, 2)
    pidx = port_index(idx)
    with pytest.raises(ValueError, match="sharded mode keeps each shard's "
                                         "full SA"):
        ShardedSEAligner(pidx, shards, SEOptions(sa_mode="sampled"),
                         devices=["cpu"], bins=bins)
    with pytest.raises(ValueError, match="3 devices for 2 shards"):
        ShardedSEAligner(pidx, shards, SEOptions(), devices=["cpu"] * 3,
                         bins=bins)
    with pytest.raises(ValueError, match="contiguous contig bins"):
        ShardedSEAligner(pidx, shards, SEOptions(), devices=["cpu"],
                         bins=[[0, 2, 4, 6], [1, 3, 5, 7]])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ShardedSEAligner(pidx, shards, SEOptions(), bins=bins)
