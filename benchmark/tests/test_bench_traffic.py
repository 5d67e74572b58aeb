"""Reads come from (seed, call): the same pair gives the same reads."""

import numpy as np
import pytest

from benchmark import genome, traffic
from benchmark.tests.helpers import tiny


@pytest.fixture(scope="module")
def gen():
    cfg, _b, _m, _l = tiny("chr21_snp144.se_wgsim")
    return genome.make_genome(cfg)


@pytest.mark.parametrize("cell", ["chr21_snp144.se_wgsim",
                                  "chr21_snp144.pe_wgsim"])
def test_same_seed_same_reads(gen, cell):
    _c, _b, mix, _l = tiny(cell)
    a = traffic.make_call(traffic.make_sample(gen, mix, 2**31 + 5), mix,
                          2**31 + 5, 1)
    b = traffic.make_call(traffic.make_sample(gen, mix, 2**31 + 5), mix,
                          2**31 + 5, 1)
    c = traffic.make_call(traffic.make_sample(gen, mix, 2**31 + 6), mix,
                          2**31 + 6, 1)
    d = traffic.make_call(traffic.make_sample(gen, mix, 2**31 + 5), mix,
                          2**31 + 5, 2)
    assert np.array_equal(a.codes, b.codes) and np.array_equal(a.locus, b.locus)
    assert not np.array_equal(a.codes, c.codes)
    assert not np.array_equal(a.codes, d.codes)
    assert a.codes.max() <= 3


def test_error_free_reads_lie_at_their_locus(gen):
    _c, _b, mix, _l = tiny("chr21_snp144.pe_wgsim")
    mix = dict(mix, err_rate=0.0, mut_rate=0.0, snp_alt_prob=0.0)
    call = traffic.make_call(traffic.make_sample(gen, mix, 7), mix, 7, 0)
    L = mix["read_len"]
    for e in (0, 1):
        for i in range(50):
            want = gen.codes[call.locus[e, i]:call.locus[e, i] + L]
            got = call.codes[e, i]
            if call.reverse[e, i]:
                got = traffic.revcomp(got)
            assert np.array_equal(got, want)
    # the pair is FR: exactly one end of each pair is reversed
    assert (call.reverse[0] != call.reverse[1]).all()
    span = np.abs(call.locus[0] - call.locus[1]) + L
    assert abs(np.median(span) - mix["dist"]) < 3 * mix["std_dev"]


def test_sample_carries_known_alleles(gen):
    _c, _b, mix, _l = tiny("chr21_snp144.se_wgsim")
    haps = traffic.make_sample(gen, dict(mix, mut_rate=0.0), 9)
    for h in haps:
        alt = h.codes[gen.snp_pos] == gen.snp_alt
        assert 0.4 < alt.mean() < 0.6


def test_distortions_come_from_the_mix(gen):
    _c, _b, mix, _l = tiny("chr21_snp144.pe_wgsim")
    mix = dict(mix, err_rate=0.0, mut_rate=0.0, snp_alt_prob=0.0)
    haps = traffic.make_sample(gen, mix, 9)
    plain = traffic.make_call(haps, mix, 9, 0)
    far = dict(mix, burst_frac=0.25, burst_subs=15, far_frac=0.5,
               far_dist=2000)
    got = traffic.make_call(haps, far, 9, 0)
    # bursts: a quarter of the ends differ from their template by 15 bases
    L = mix["read_len"]
    diffs = []
    for e in (0, 1):
        for i in range(len(got.names)):
            want = gen.codes[got.locus[e, i]:got.locus[e, i] + L]
            read = got.codes[e, i]
            if got.reverse[e, i]:
                read = traffic.revcomp(read)
            diffs.append(int((read != want).sum()))
    diffs = np.array(diffs)
    assert set(np.unique(diffs)) <= {0, 15}
    assert 0.15 < (diffs == 15).mean() < 0.35
    # far pairs: about half the inserts lie near 2,000
    span = np.abs(got.locus[1] - got.locus[0]) + L
    assert 0.35 < (span > 1500).mean() < 0.65
    # a mix without them keeps its reads
    again = traffic.make_call(haps, mix, 9, 0)
    assert np.array_equal(again.codes, plain.codes)
