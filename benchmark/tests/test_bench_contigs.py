"""A genome of several contigs, as every GRCh38 index has: named contigs
laid end to end, reads that stay on one contig, SNP lines contig by
contig, and a judge that names each record's contig.  And a genome of
one contig reads as it did before contigs: the same genome, SNP table,
reads, and the judge's numbers and lines (digests pinned below)."""

import hashlib
import json

import numpy as np
import pytest

from benchmark import faults, genome, readings, reference, run, traffic
from benchmark.tests.helpers import BENCH, bench, tiny

SEED = 2**31 + 2207


def _sha(*parts) -> str:
    h = hashlib.sha256()
    for p in parts:
        h.update(p.encode() if isinstance(p, str)
                 else np.ascontiguousarray(p).tobytes())
    return h.hexdigest()[:16]


def _mix(mode: str, per_call: int) -> dict:
    mix = json.loads((BENCH / "traffic" / f"{mode}_wgsim.json").read_text())
    return dict(mix, per_call=per_call)


def _shift(line: str) -> str:
    f = line.split("\t")
    if f[3] not in ("0", "*"):
        f[3] = str(int(f[3]) + 1)
    return "\t".join(f)


def _judge(gen, cfg, mix, ref=None):
    opts = dict(readings.DEFAULT_OPTIONS,
                l_overlap=int(cfg["index"]["l_seed"]))
    return run.make_judge(gen, cfg, mix, opts, "cpu", ref=ref)


def identity(config: str) -> dict:
    """Digests of the genome and SNP table of `config` cut to 200,000
    bases as helpers.tiny cuts it, of call 0's SE and PE reads and truth,
    of the reference's own lines on a fixed sample of them, and the
    judge's numbers on those lines sound and broken."""
    cfg = json.loads((BENCH / "configs" / f"{config}.json").read_text())
    cfg["snps"] = 200_000 // 300
    cfg["genome_bases"] = 200_000
    gen = genome.make_genome(cfg)
    out = {"name": gen.name,
           "genome": _sha(gen.codes, gen.snp_pos.astype("<i8"), gen.snp_alt)}
    ref = reference.RefGenome(gen)
    md = int(cfg["index"]["max_diff"])
    for mode in ("se", "pe"):
        mix = _mix(mode, 300)
        call = traffic.make_call(traffic.make_sample(gen, mix, SEED), mix,
                                 SEED, 0)
        out[f"{mode}_reads"] = _sha(call.codes, call.locus.astype("<i8"),
                                    call.reverse.astype(np.uint8),
                                    ",".join(call.names))
        n = 40 if mode == "se" else 24
        rows = np.arange(n) * 7
        names = [call.names[i] for i in rows]
        codes = np.take(call.codes, rows, axis=-2)
        locus = np.take(call.locus, rows, axis=-1)
        rev = np.take(call.reverse, rows, axis=-1)
        quals = ["2" * mix["read_len"]] * n
        if mode == "se":
            lines = reference.aligned_se(ref, names, codes, quals, locus, rev,
                                         md, mix["read_len"] // 10, "cpu")
            bad = [_shift(x) if i % 3 == 0 else x
                   for i, x in enumerate(lines)]
        else:
            lines = reference.aligned_pe(ref, names, codes, quals, locus, rev,
                                         md, md, "cpu")
            bad = [(_shift(a), b) if i % 3 == 0
                   else (a, b.replace("\t=\t", "\t*\t")) if i % 3 == 1
                   else ("", b) for i, (a, b) in enumerate(lines)]
        out[f"{mode}_lines"] = _sha("\n".join(
            x if isinstance(x, str) else "|".join(x) for x in lines))
        for tag, ls in (("sound", lines), ("bad", bad)):
            judge = _judge(gen, cfg, mix, ref)
            fn = judge.check_pe if mode == "pe" else judge.check_se
            fn(ls, names, codes, quals, locus, rev)
            out[f"{mode}_{tag}"] = dict(judge.numbers(), **judge.reported())
            out[f"{mode}_{tag}_examples"] = _sha(
                "\n".join(judge.examples + judge.repeat_examples))
    return out


# taken from the tree before contigs (the parent of the change that
# added them), by identity() above
_CHR21 = {
    "name": "chr21", "genome": "6b8f303d346b55f6",
    "se_reads": "788a9c2f9ec90b91", "se_lines": "6be7ead4568a7380",
    "se_sound": {"fields_wrong": 0, "hits_wrong": 0, "records_wrong": 0,
                 "repeat_hits_wrong": 0, "reads_in_repeats": 32,
                 "rescue_checked": 0},
    "se_sound_examples": "e3b0c44298fc1c14",
    "se_bad": {"fields_wrong": 14, "hits_wrong": 3, "records_wrong": 14,
               "repeat_hits_wrong": 11, "reads_in_repeats": 32,
               "rescue_checked": 0},
    "se_bad_examples": "1f9e952b7e2063ef",
    "pe_reads": "6af3e56b71b1dbbb", "pe_lines": "561c6db09aeeea07",
    "pe_sound": {"fields_wrong": 0, "hits_wrong": 0, "records_wrong": 0,
                 "repeat_hits_wrong": 2, "reads_in_repeats": 33,
                 "rescue_checked": 2},
    "pe_sound_examples": "f86be227c1739fbe",
    "pe_bad": {"fields_wrong": 23, "hits_wrong": 0, "records_wrong": 23,
               "repeat_hits_wrong": 10, "reads_in_repeats": 33,
               "rescue_checked": 2},
    "pe_bad_examples": "169d0e9d9612d6b5",
}
PINNED = {
    "chr21_snp144": _CHR21,
    "chr21_snp144_sampled": _CHR21,
    "ecoli_k12": {
        "name": "NC_000913.3", "genome": "ceabbf835586648f",
        "se_reads": "26131deb1e82e02d", "se_lines": "ab14520e49b25d7e",
        "se_sound": {"fields_wrong": 0, "hits_wrong": 0, "records_wrong": 0,
                     "repeat_hits_wrong": 0, "reads_in_repeats": 0,
                     "rescue_checked": 0},
        "se_sound_examples": "e3b0c44298fc1c14",
        "se_bad": {"fields_wrong": 14, "hits_wrong": 14, "records_wrong": 14,
                   "repeat_hits_wrong": 0, "reads_in_repeats": 0,
                   "rescue_checked": 0},
        "se_bad_examples": "f2684dc3aedbaa18",
        "pe_reads": "5236c32b933ef602", "pe_lines": "286156c6f4c4d7ea",
        "pe_sound": {"fields_wrong": 0, "hits_wrong": 5, "records_wrong": 5,
                     "repeat_hits_wrong": 0, "reads_in_repeats": 0,
                     "rescue_checked": 5},
        "pe_sound_examples": "b070b8c0907c7c44",
        "pe_bad": {"fields_wrong": 23, "hits_wrong": 17, "records_wrong": 24,
                   "repeat_hits_wrong": 0, "reads_in_repeats": 0,
                   "rescue_checked": 5},
        "pe_bad_examples": "feb63da3c466980d",
    },
}


@pytest.mark.parametrize("config", sorted(PINNED))
def test_one_contig_reads_as_before(config):
    assert identity(config) == PINNED[config]


def test_one_contig_index_inputs_as_before(tmp_path):
    """The FASTA and SNP file the index is built from, byte for byte
    (digest from the tree before contigs, as identity())."""
    cfg = json.loads((BENCH / "configs" / "chr21_snp144.json").read_text())
    cfg["snps"] = 200_000 // 300
    cfg["genome_bases"] = 200_000
    fa, snp = tmp_path / "g.fa", tmp_path / "g.snp"
    run.write_inputs(genome.make_genome(cfg), fa, snp)
    assert _sha(fa.read_text() + snp.read_text()) == "c72d9cd031f523ef"
    assert snp.read_text().count("\n") == 639


def test_one_contig_cache_holds_no_table(tmp_path):
    cfg, cfg_bytes, _m, _l = tiny("ecoli_k12.se_wgsim", bases=30_000)
    gen = genome.load_genome(cfg, cfg_bytes, tmp_path)
    (path,) = tmp_path.glob("genome_*.npz")
    assert sorted(np.load(path).files) == ["codes", "name", "snp_alt",
                                           "snp_pos"]
    again = genome.load_genome(cfg, cfg_bytes, tmp_path)
    assert again.contig_names == gen.contig_names == ["NC_000913.3"]
    assert again.contig_offsets.tolist() == [0]
    assert again.contig_lengths.tolist() == [30_000]


# ---- a genome of three contigs ----

CONTIGS = [("chrA", 120_000, 19), ("chrB", 80_000, 20), ("chrM", 16_569, 25)]


def three_contigs(idx_args=(), aln_args=()):
    """chr21_snp144's configuration over three contigs (the last of
    chrM's length), cut small for the CPU."""
    cfg = json.loads((BENCH / "configs" / "chr21_snp144.json").read_text())
    cfg["name"] = "three_contigs"
    del cfg["genome"]["contig_name"]
    cfg["genome"]["contigs"] = [{"name": n, "bases": b, "seed": s}
                                for n, b, s in CONTIGS]
    cfg["genome_bases"] = sum(b for _n, b, _s in CONTIGS)
    cfg["snps"] = cfg["genome_bases"] // 300
    if idx_args:
        cfg["idx_args"] = list(idx_args)
    if aln_args:
        cfg["aln_args"] = list(aln_args)
    return cfg, json.dumps(cfg).encode()


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    return tmp_path_factory.mktemp("contigs")


@pytest.fixture(scope="module")
def gen3():
    return genome.make_genome(three_contigs()[0])


def test_contig_table_and_snps(gen3, cache):
    assert gen3.contig_names == ["chrA", "chrB", "chrM"]
    assert gen3.contig_offsets.tolist() == [0, 120_000, 200_000]
    assert gen3.contig_lengths.tolist() == [120_000, 80_000, 16_569]
    assert len(gen3.codes) == 216_569
    # each contig made from its own seed: chrB is the same alone
    alone = genome.synthesize_contig(80_000, np.random.default_rng(20),
                                     "repeat", longest=10_000)
    assert np.array_equal(gen3.codes[120_000:200_000], alone)
    # the cap keeps chrM from being one N run or one satellite array
    assert (gen3.codes[200_000:] < 4).mean() > 0.85
    per = np.bincount(gen3.contig_of(gen3.snp_pos), minlength=3)
    # sample_snps keeps the draws off N, so a share may lose a few
    share = genome.split_snps(216_569 // 300, [120_000, 80_000, 16_569])
    assert share == [400, 266, 55]
    assert (per <= share).all() and (per >= 0.9 * np.array(share)).all()
    assert per.min() >= 1 and (gen3.codes[gen3.snp_pos] < 4).all()
    assert (np.diff(gen3.snp_pos) > 0).all()
    # the cache keeps the table
    cfg, cfg_bytes = three_contigs()
    genome.load_genome(cfg, cfg_bytes, cache / "table")
    got = genome.load_genome(cfg, cfg_bytes, cache / "table")
    assert got.contig_names == gen3.contig_names
    assert got.contig_offsets.tolist() == gen3.contig_offsets.tolist()
    assert np.array_equal(got.codes, gen3.codes)


def test_split_snps():
    assert genome.split_snps(10, [50, 30, 20]) == [5, 3, 2]
    assert genome.split_snps(10, [55, 44, 1]) == [5, 4, 1]
    got = genome.split_snps(735_359, [58_617_616, 64_444_167, 46_709_983,
                                      50_818_468, 16_569])
    assert sum(got) == 735_359 and got[-1] == 55 and min(got) >= 1
    with pytest.raises(ValueError):
        genome.split_snps(2, [10, 10, 10])


def test_snp_file_lists_every_contig_in_fasta_order(gen3, tmp_path):
    fa, snp = tmp_path / "g.fa", tmp_path / "g.snp"
    run.write_inputs(gen3, fa, snp)
    text = fa.read_text().split("\n")
    assert text[0::2][:3] == [">chrA", ">chrB", ">chrM"]
    seqs = dict(zip([t[1:] for t in text[0::2][:3]], text[1::2][:3]))
    assert [len(seqs[n]) for n in gen3.contig_names] == [120_000, 80_000,
                                                         16_569]
    order, n_lines = [], 0
    for line in snp.read_text().splitlines():
        name, pos, alleles, base = line.split("\t")
        if not order or order[-1] != name:
            order.append(name)
        assert seqs[name][int(pos) - 1] == base == alleles[0]
        n_lines += 1
    assert order == gen3.contig_names
    assert n_lines == len(gen3.snp_pos)


def test_no_read_spans_a_boundary():
    """Contigs shorter than a few templates: windows that would cross a
    boundary are drawn again, and each contig still gets reads."""
    rng = np.random.default_rng(3)
    lengths = [1_000, 700, 900]
    gen = genome.Genome(None, rng.integers(0, 4, 2_600).astype(np.uint8),
                        np.zeros(0, np.int64), np.zeros(0, np.uint8),
                        contigs=list(zip(["a", "b", "c"], lengths)))
    edges = np.cumsum(lengths)
    for mode in ("se", "pe"):
        mix = dict(_mix(mode, 2_000), read_len=100, std_dev=100)
        call = traffic.make_call(traffic.make_sample(gen, mix, 5), mix, 5, 0)
        loc = call.locus.reshape(-1, call.locus.shape[-1])
        lo, hi = loc.min(0), loc.max(0) + mix["read_len"] - 1
        # an indel of the sample's 0.1% mutations moves an end a few bases
        c_lo = np.searchsorted(edges, lo, side="right")
        assert (c_lo == np.searchsorted(edges, hi - 8, side="right")).all()
        assert set(c_lo.tolist()) == {0, 1, 2}
    # the same draws without the contig table cross boundaries
    hap = traffic.make_sample(gen, dict(_mix("se", 1), mut_rate=0.0), 5)[0]
    span = np.full(2_000, 500)
    s = traffic._starts(hap, span, np.random.default_rng(1))
    assert (gen.contig_of(s) == gen.contig_of(s + 499)).all()
    hap.contig_of = None
    s = traffic._starts(hap, span, np.random.default_rng(1))
    crossing = np.searchsorted(edges, s, side="right") != \
        np.searchsorted(edges, s + 499, side="right")
    assert crossing.mean() > 0.3


def test_judge_names_each_records_contig(gen3):
    ref = reference.RefGenome(gen3)
    assert ref.locus(0) == ("chrA", 1)
    assert ref.locus(119_999) == ("chrA", 120_000)
    assert ref.locus(120_000) == ("chrB", 1)
    assert ref.locus(216_568) == ("chrM", 16_569)
    assert ref.at("chrB", 1) == 120_000 and ref.at("chrM", 16_569) == 216_568
    assert ref.at("chrB", 80_001) is None and ref.at("chrZ", 5) is None
    rec = reference.Record("r\t0\tchrB\t11\t60\t100M\t*\t0\t0\tA\t2", ref)
    assert rec.at == 120_010


def _unique_reads(ref, gen, contig: int, n: int, rng):
    """Error-free 100-base windows of a contig that the exhaustive search
    finds once, each with its position."""
    off, ln = int(gen.contig_offsets[contig]), int(gen.contig_lengths[contig])
    out = []
    while len(out) < n:
        p = off + int(rng.integers(0, ln - 100))
        read = gen.codes[p:p + 100]
        if (read > 3).any():
            continue
        hits = reference.exhaustive_hits(ref, read[None], 3, "cpu")[0]
        if hits[0] == [(p, 0)] and not hits[1]:
            out.append((p, read.copy()))
    return out


def test_pairs_on_two_contigs(gen3, cache):
    """Pairs whose ends lie on two contigs (traffic makes none): the port
    gives RNEXT the mate's contig, TLEN 0 and no proper flag, as sam.c
    alnpe_sam does; the judge finds no fault there or in the reference's
    own lines, and catches each field written as for one contig."""
    from salt_tpu_torch.io.fasta import SeqRecord

    cfg, _b = three_contigs()
    mix = _mix("pe", 8)
    prefix = cache / "pe_idx"
    run.ensure_index(cfg, gen3, prefix)
    al, opts, _t, _u = run.build_aligner(str(prefix), True, "cpu")
    ref = reference.RefGenome(gen3)
    rng = np.random.default_rng(8)
    ends = [_unique_reads(ref, gen3, c, 4, rng) for c in (0, 2)]
    # read 1 forward on chrA, read 2 reverse on chrM; then swapped
    pairs = list(zip(ends[0], ends[1])) + list(zip(ends[1], ends[0]))
    R = len(pairs)
    codes = np.stack([np.stack([a[1] for a, _b in pairs]),
                      np.stack([traffic.revcomp(b[1]) for _a, b in pairs])])
    locus = np.array([[a[0] for a, _b in pairs], [b[0] for _a, b in pairs]])
    reverse = np.stack([np.zeros(R, bool), np.ones(R, bool)])
    call = traffic.Call(codes, [f"x{i}" for i in range(R)], locus, reverse)
    out = al.align_pairs(*traffic.records(call, SeqRecord))
    lines = [(out[2 * i].rstrip("\n"), out[2 * i + 1].rstrip("\n"))
             for i in range(R)]
    quals = ["2" * 100] * R
    for i, (a, b) in enumerate(lines):
        fa, fb = a.split("\t"), b.split("\t")
        assert {fa[2], fb[2]} == {"chrA", "chrM"}
        assert (fa[6], fb[6]) == (fb[2], fa[2])
        assert fa[8] == fb[8] == "0"
        assert not int(fa[1]) & 2 and not int(fb[1]) & 2
    control = reference.aligned_pe(ref, call.names, codes, quals, locus,
                                   reverse, 3, 3, "cpu")
    assert [tuple(x) for x in control] == lines
    for got in (lines, control):
        judge = _judge(gen3, cfg, mix, ref)
        judge.check_pe(got, call.names, codes, quals, locus, reverse)
        assert judge.numbers() == {"fields_wrong": 0, "hits_wrong": 0,
                                   "records_wrong": 0}, judge.examples

    def one_contig(line: str, tlen: bool) -> str:
        f = line.split("\t")
        if tlen:
            f[8], f[1] = "250", str(int(f[1]) | 2)
        else:
            f[6] = "="
        return "\t".join(f)

    for tlen in (False, True):
        judge = _judge(gen3, cfg, mix, ref)
        judge.check_pe([(one_contig(a, tlen), b) for a, b in lines],
                       call.names, codes, quals, locus, reverse)
        assert judge.fields_wrong == R, judge.examples


# whole runs on the CPU: SE, PE, SE sharded, and the wrong_contig fault
RUNS = [("chr21_snp144.se_wgsim", (), None),
        ("chr21_snp144.pe_wgsim", (), None),
        ("chr21_snp144.se_wgsim", ("--shards", "2"), None),
        ("chr21_snp144.se_wgsim", (), "wrong_contig"),
        ("chr21_snp144.pe_wgsim", (), "wrong_contig")]


@pytest.mark.parametrize("cell, shards, fault", RUNS, ids=[
    "se", "pe", "se_shards2", "se_wrong_contig", "pe_wrong_contig"])
def test_run_on_three_contigs(cell, shards, fault, cache):
    cfg, cfg_bytes = three_contigs(shards, shards)
    _c, _b, mix, limits = tiny(cell, per_call=300, sample=150)
    seen = []

    def spy(lines, gen):
        seen.extend(lines)
        return faults.SABOTAGE[fault](lines, gen) if fault else lines

    res = run.run_cell(cell, cfg, cfg_bytes, mix, limits, bench(), 5, 0.0,
                       False, device="cpu",
                       cache_dir=cache / f"run{'_'.join(shards)}",
                       sabotage=spy)
    assert res["attempted"] == 300
    if fault:
        assert not res["correct"]
        assert res["checks"]["fields_wrong"]["value"] > 20, res["checks"]
        return
    assert res["correct"], res["checks"]
    assert res["failed"] == 0
    assert res["checks"]["fields_wrong"]["value"] == 0
    assert res["checks"]["hits_wrong"]["value"] == 0
    recs = [x for line in seen
            for x in ([line] if isinstance(line, str) else line)]
    names = {r.split("\t")[2] for r in recs}
    assert {"chrA", "chrB", "chrM"} <= names
    if shards:
        idx = sorted(p.name for p in (cache / "run--shards_2").iterdir()
                     if p.name.startswith("idx_"))
        assert any(n.endswith(".shards.json") for n in idx)
        assert any(".shard1." in n for n in idx)
