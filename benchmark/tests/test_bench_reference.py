"""The reference on tiny genomes: its exhaustive search against a loop,
its tags against hand-worked records, salt's choice on made-up loci, and
the port's SAM on the CPU against it."""

import numpy as np
import pytest

from benchmark import genome, reference, traffic
from benchmark.tests.helpers import tiny


def _genome(codes, snp_pos=(), snp_alt=()):
    return genome.Genome("g", np.asarray(codes, np.uint8),
                         np.asarray(snp_pos, np.int64),
                         np.asarray(snp_alt, np.uint8))


def test_exhaustive_hits_match_a_loop():
    rng = np.random.default_rng(1)
    codes = rng.integers(0, 4, 3000).astype(np.uint8)
    codes[500:520] = 4
    snp_pos = np.array([40, 900, 1500])
    g = _genome(codes, snp_pos, (codes[snp_pos] + 1) % 4)
    ref = reference.RefGenome(g)
    reads = np.stack([codes[p:p + 50] for p in (10, 880, 2950)] +
                     [rng.integers(0, 4, 50).astype(np.uint8)])
    reads[0, 31] = (reads[0, 31] + 1) % 4
    reads[1, 20] = g.snp_alt[1]
    got = reference.exhaustive_hits(ref, reads, 3, "cpu", block=700)
    assert got == reference.exhaustive_hits(ref, reads, 3, "cpu")
    for i, r in enumerate(reads):
        for s, pat in ((0, r), (1, reference.revcomp(r))):
            want = [(p, ref.mismatches(pat, p)) for p in range(ref.n)]
            assert got[i][s] == [(p, c) for p, c in want if c <= 3]
    assert (880, 0) in got[1][0] and (10, 1) in got[0][0]


def test_seed_occurrences_match_a_loop():
    rng = np.random.default_rng(3)
    unit = rng.integers(0, 4, 30).astype(np.uint8)
    codes = np.concatenate([rng.integers(0, 4, 400).astype(np.uint8)]
                           + [unit] * 6 + [rng.integers(0, 4, 400).astype(np.uint8)])
    snp_pos = np.array([10, 700])
    g = _genome(codes, snp_pos, (codes[snp_pos] + 2) % 4)
    ref = reference.RefGenome(g)
    reads = np.stack([codes[400:450], codes[5:55], codes[690:740]])
    reads[2, 10] = g.snp_alt[1]                    # the SNP's allele
    got = reference.seed_occurrences(ref, reads, 8, 10, "cpu", block=97)
    assert got.shape == (3, 2, 5)
    for i, r in enumerate(reads):
        for s, pat in ((0, r), (1, reference.revcomp(r))):
            for k, p in enumerate(range(0, 43, 10)):
                seed = pat[p:p + 8]
                want = sum(ref.mismatches(seed, q) == 0
                           for q in range(ref.n - 7))
                assert got[i, s, k] == want
    assert got[0, 0].min() >= 5                    # inside the tandem array
    judge = reference.Judge(ref, "cpu", l_seed=8, l_overlap=10, max_seed=4)
    assert judge.repeats(reads).tolist() == [True, False, False]
    assert judge.in_repeats == 1


def test_rescue_window_and_scores():
    # anchor forward at 1,000: the mate's reverse end starts 150-450 on
    assert reference.rescue_window(1000, 0, 100, 100, 250, 550, 10**6) == \
        (1150, 1550, 1)
    assert reference.rescue_window(1000, 1, 100, 100, 250, 550, 10**6) == \
        (550, 950, 0)
    assert reference.rescue_window(300, 1, 100, 100, 250, 550, 10**6) == \
        (0, 250, 0)
    rng = np.random.default_rng(4)
    codes = rng.integers(0, 4, 300).astype(np.uint8)
    g = _genome(codes, [120], [(codes[120] + 1) % 4])
    ref = reference.RefGenome(g)
    read = codes[100:150].copy()
    read[5] = (read[5] + 1) % 4                   # a mismatch near the start
    ops = [(50, "M")]
    # the SNP position scores -3 in the bound, +1 in the upper score
    assert reference.rescue_bound(ref, 100, read, ops) == 50 - 4 - 4
    assert reference.sw_score(ref, 100, read, ops) == 49 - 3
    gapped = np.concatenate([codes[100:120], codes[122:150]])
    gops = [(20, "M"), (2, "D"), (28, "M")]
    assert reference.sw_score(ref, 100, gapped, gops) == 48 - 4
    assert reference.sw_score(ref, 100, np.concatenate([[0, 0], gapped]),
                              [(2, "S")] + gops) == 48 - 4


def test_tags_of_a_gapped_alignment():
    codes = np.array([0, 1, 2, 3, 0, 1, 2, 3, 0, 1], np.uint8)   # ACGTACGTAC
    g = _genome(codes, [5], [3])                                  # C/T at 5
    ref = reference.RefGenome(g)
    # read ACG-TTCGTA: deletion of the T at 3 (MD ^T), T at 5 matches the
    # SNP allele (NM counts it, XV lists it), G->C mismatch at 8
    read = np.array([0, 1, 2, 0, 3, 2, 3, 1], np.uint8)
    ops = reference.parse_cigar("3M1D5M")
    assert reference.md_nm_xv(ref, 0, read, ops) == \
        "\tMD:Z:3^T1C2A0\tNM:i:3\tXV:i:4".replace("A0", "A")
    assert reference.cigar_cost(ref, 0, read, ops) == 2


def test_salt_choice_quirks():
    # strand 1's hit wins a tie with strand 0; an XA entry is kept only
    # where its strand's first hit is no worse than the primary
    hits = {0: [(10, 1), (50, 1)], 1: [(30, 1), (70, 2)]}
    s, pos, nd, mapq, xa = reference.salt_choice(hits, 3, 8, 5)
    assert (s, pos, nd) == (1, 30, 1)
    assert xa == [(0, 10, 1), (0, 50, 1)] and mapq == 0
    # a locus after a better one is no hit; the lone best gets MAPQ 254
    s, pos, nd, mapq, xa = reference.salt_choice(
        {0: [(5, 0), (9, 2)], 1: []}, 3, 8, 5)
    assert (s, pos, nd, xa) == (0, 5, 0, []) and mapq == 0
    assert reference.salt_choice({0: [(5, 2)], 1: []}, 3, 8, 5)[3] == 254
    assert reference.salt_choice({0: [], 1: []}, 3, 8, 5) is None


def test_edit_dp_finds_an_indel():
    rng = np.random.default_rng(2)
    codes = rng.integers(0, 4, 400).astype(np.uint8)
    ref = reference.RefGenome(_genome(codes))
    read = np.concatenate([codes[100:140], codes[142:202]])       # 2-base deletion
    d, pos, ops, run = reference.edit_dp(ref, read, 100)
    assert (d, pos) == (2, 100)
    assert [op for _n, op in ops] == ["M", "D", "M"] and ops[1][0] == 2
    assert reference.cigar_cost(ref, pos, read, ops) == 2 and run >= 58
    assert reference.seeded_best(ref, read, 100, 21, 21, 10) == 2
    assert reference.seeded_best(ref, read, 100, 21, 21, 1) is None


def test_lv_distance_is_edit_distance_but_at_snps():
    rng = np.random.default_rng(5)
    codes = rng.integers(0, 4, 2000).astype(np.uint8)
    ref = reference.RefGenome(_genome(codes))
    for trial in range(40):
        p = int(rng.integers(0, 1800))
        read = codes[p:p + 100].copy()
        for _ in range(int(rng.integers(0, 6))):
            j = int(rng.integers(0, 100))
            if rng.random() < 0.5:
                read[j] = (read[j] + 1) % 4
            else:
                read = np.delete(read, j) if rng.random() < 0.5 else \
                    np.insert(read, j, rng.integers(0, 4))
        read = np.resize(read, 100) if len(read) < 100 else read[:100]
        want = reference.edit_dp(ref, read, p)[0]
        got = reference.lv_distance(ref, read, p, 10)
        assert got == (want if want <= 10 else None), (trial, want, got)
    # a mismatch, then a SNP position read with the reference allele: the
    # edit distance is 1, salt's gapped distance 2
    g = _genome(codes, [p + 41], [(codes[p + 41] + 1) % 4])
    ref = reference.RefGenome(g)
    read = codes[p:p + 100].copy()
    read[40] = (read[40] + 1) % 4
    assert reference.edit_dp(ref, read, p)[0] == 1
    assert reference.lv_distance(ref, read, p, 10) == 2


@pytest.mark.parametrize("cell, recipe", [
    ("ecoli_k12.se_wgsim", None), ("chr21_snp144.se_wgsim", "uniform"),
    ("chr21_snp144.pe_wgsim", None), ("chr21_snp144.pe_wgsim", "uniform")])
def test_port_agrees_with_reference(cell, recipe, tmp_path):
    """The port on the CPU, at a tiny size, reads no fault.  A uniform
    genome with the configuration's SNPs keeps most reads out of
    repeats, so that the checks of reads outside them have work."""
    from salt_tpu_torch.io.fasta import SeqRecord

    from benchmark import run

    cfg, cfg_bytes, mix, _l = tiny(cell, bases=120_000)
    if recipe:
        cfg["genome"]["recipe"] = recipe
    gen = genome.make_genome(cfg)
    prefix = tmp_path / "idx"
    run.ensure_index(cfg, gen, prefix)
    al, opts, _t_load, _t_al = run.build_aligner(
        str(prefix), mix["mode"] == "pe", "cpu")
    haps = traffic.make_sample(gen, mix, 11)
    call = traffic.make_call(haps, dict(mix, per_call=150), 11, 0)
    recs = traffic.records(call, SeqRecord)
    judge = run.make_judge(gen, cfg, mix, run.option_values(opts), "cpu")
    quals = ["2" * mix["read_len"]] * len(call.names)
    if mix["mode"] == "pe":
        out = al.align_pairs(*recs)
        pairs = [(out[2 * i].rstrip("\n"), out[2 * i + 1].rstrip("\n"))
                 for i in range(len(call.names))]
        judge.check_pe(pairs, call.names, call.codes, quals, call.locus,
                       call.reverse)
    else:
        judge.check_se(al.align_records(recs), call.names, call.codes, quals,
                       call.locus, call.reverse)
    assert judge.checked == 150
    assert judge.numbers() == {"fields_wrong": 0, "hits_wrong": 0,
                               "records_wrong": 0}, \
        judge.examples
    if recipe:
        assert judge.in_repeats < 15
    if recipe and mix["mode"] == "pe":
        assert judge.rescue_checked > 5
