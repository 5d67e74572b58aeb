"""The port's command line against its own library calls and against
salt_tpu's command line: `idx --shards`, `aln --shards`, `aln --part-dir`
as two processes and `--merge`, the options that are accepted and inert,
the pass-through subcommands (same arguments, same files as salt_tpu's),
and device_trace.  Everything runs with --device cpu.  Tolerance: exact."""

import io
import json
import os
from contextlib import redirect_stderr, redirect_stdout

import pytest

from salt_tpu import cli as jcli
from salt_tpu_torch import cli

from torch_fixtures import BASES, contig_fixture, contig_pairs


def _run(main, argv):
    """(return code, stdout, stderr) of a command line."""
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


def _fastq(path, records):
    with open(path, "w") as fh:
        for r in records:
            fh.write(f"@{r.name}\n{r.seq}\n+\n{r.qual}\n")
    return str(path)


def _body(sam: str):
    return [l for l in sam.splitlines() if not l.startswith("@")]


def _header(sam: str):
    return [l for l in sam.splitlines()
            if l.startswith("@") and not l.startswith("@PG")]


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """A directory with the 8-contig genome as FASTA, its SNPs as a hapmap
    table, SE and PE reads, and an index built by `idx --shards 4`."""
    d = tmp_path_factory.mktemp("cli")
    cd, bl, recs = contig_fixture(n_reads=80)
    with open(d / "ref.fa", "w") as fh:
        for name, anno, seq in cd:
            fh.write(f">{name} {anno}\n{seq}\n")
    with open(d / "snps.txt", "w") as fh:
        for (name, _anno, seq), b in zip(cd, bl):
            for p, t in zip(b.pos.tolist(), b.stype.tolist()):
                alleles = "/".join(BASES[c] for c in range(4) if (t >> c) & 1)
                fh.write(f"{name}\t{p + 1}\t{alleles}\t{seq[p]}\n")
    r1, r2 = contig_pairs(cd, n_pairs=24)
    files = dict(fa=str(d / "ref.fa"), snps=str(d / "snps.txt"),
                 prefix=str(d / "idx"), reads=_fastq(d / "reads.fq", recs),
                 r1=_fastq(d / "r1.fq", r1), r2=_fastq(d / "r2.fq", r2), dir=d)
    rc, out, _err = _run(cli.main, ["idx", "-k", "19", "--shards", "4",
                                    files["fa"], files["snps"],
                                    files["prefix"]])
    assert rc == 0 and out == ""
    return files


ALN = ["aln", "--device", "cpu", "-d", "-c", "-r", "1", "-m", "300",
       "--batch-size", "64"]


@pytest.fixture(scope="module")
def plain(work):
    rc, out, _err = _run(cli.main, ALN + [work["prefix"], work["reads"]])
    assert rc == 0 and len(_body(out)) == 80
    return out


def test_idx_shards_writes_sub_indexes_and_manifest(work):
    from salt_tpu_torch.index.store import load_index

    with open(work["prefix"] + ".shards.json") as fh:
        man = json.load(fh)
    assert man == {"n_shards": 4, "bins": [[0, 1, 2], [3, 4, 5], [6], [7]]}
    whole = load_index(work["prefix"])
    parts = [load_index(f"{work['prefix']}.shard{i}") for i in range(4)]
    assert [len(p.contigs) for p in parts] == [3, 3, 1, 1]
    assert sum(p.l_pac for p in parts) == whole.l_pac
    assert [c.name for p in parts for c in p.contigs] == \
        [c.name for c in whole.contigs]


def test_idx_shards_matches_salt_tpu(work, tmp_path):
    """salt_tpu's `idx --shards` on the same files: the same manifest and
    the same tables in every sub-index."""
    import numpy as np

    from salt_tpu.index.store import load_index

    rc, _out, _err = _run(jcli.main, ["idx", "-k", "19", "--shards", "4",
                                      work["fa"], work["snps"],
                                      str(tmp_path / "j")])
    assert rc == 0
    with open(work["prefix"] + ".shards.json") as a, \
            open(tmp_path / "j.shards.json") as b:
        assert json.load(a) == json.load(b)
    for name in ("idx", "idx.shard0", "idx.shard3"):
        ours = load_index(str(work["dir"] / name))
        theirs = load_index(str(tmp_path / name.replace("idx", "j")))
        for field in ("cbwt", "rbwt", "csa", "r_coord", "mixref", "lkt"):
            assert np.array_equal(getattr(ours, field), getattr(theirs, field))


def test_idx_shards_more_than_contigs_raises(work, tmp_path):
    with pytest.raises(ValueError, match="cannot split 8 contigs into 9"):
        cli.main(["idx", "-k", "19", "--shards", "9", work["fa"], work["snps"],
                  str(tmp_path / "x")])


@pytest.mark.parametrize("extra", [[], ["-X", "1"]])
def test_aln_shards_equals_plain_aln(work, extra):
    rc, want, _ = _run(cli.main, ALN + extra + [work["prefix"], work["reads"]])
    rc2, got, err = _run(cli.main, ALN + extra + ["--shards", "4",
                                                  work["prefix"], work["reads"]])
    assert rc == rc2 == 0 and err.count("sharded") == 0
    assert _body(got) == _body(want) and _header(got) == _header(want)
    assert "--shards 4" in got.splitlines()[len(_header(got))]


def test_aln_shards_pe_equals_plain_aln(work):
    args = ["-p", work["prefix"], work["r1"], work["r2"]]
    _rc, want, _ = _run(cli.main, ALN + args)
    _rc, got, _ = _run(cli.main, ALN + ["--shards", "4"] + args)
    assert _body(got) == _body(want)
    assert sum(1 for line in _body(got) if line) == 48


def test_aln_shards_manifest_count_wins(work, plain):
    rc, got, err = _run(cli.main, ALN + ["--shards", "2", work["prefix"],
                                         work["reads"]])
    assert rc == 0 and _body(got) == _body(plain)
    assert "index was sharded 4-way; using that (requested 2)" in err


def test_aln_shards_sampled_raises(work):
    with pytest.raises(ValueError, match="sharded mode keeps each shard's"):
        cli.main(ALN + ["--shards", "4", "--sa-mode", "sampled",
                        work["prefix"], work["reads"]])


@pytest.mark.parametrize("sharded", [False, True])
def test_aln_part_dir_twice_and_merge(work, plain, tmp_path, monkeypatch,
                                      sharded):
    """Processes 0 and 1 of 2 write their batches' parts; --merge joins
    them into plain aln's SAM."""
    parts = str(tmp_path / "parts")
    args = ALN + (["--shards", "4"] if sharded else []) + [
        "--part-dir", parts, "--shard-batch", "16"]
    monkeypatch.setenv("SALT_TPU_NUM_PROCESSES", "2")
    for pid, mine in ((0, [0, 2, 4]), (1, [1, 3])):
        monkeypatch.setenv("SALT_TPU_PROCESS_ID", str(pid))
        rc, out, _err = _run(cli.main, args + [work["prefix"], work["reads"]])
        assert rc == 0 and out == ""
        names = [f"part_{i:08d}.sam" for i in mine]
        assert set(names) <= set(os.listdir(parts))
        if pid == 0:
            assert sorted(os.listdir(parts)) == names
    rc, got, _err = _run(cli.main, ALN + ["--part-dir", parts, "--merge",
                                          work["prefix"], work["reads"]])
    assert rc == 0
    assert _body(got) == _body(plain) and _header(got) == _header(plain)


def test_aln_part_dir_pe_and_merge(work, tmp_path):
    parts = str(tmp_path / "parts")
    args = ["-p", work["prefix"], work["r1"], work["r2"]]
    _rc, want, _ = _run(cli.main, ALN + args)
    rc, out, _ = _run(cli.main, ALN + ["--part-dir", parts, "--shard-batch",
                                       "10"] + args)
    assert rc == 0 and out == "" and len(os.listdir(parts)) == 3
    _rc, got, _ = _run(cli.main, ALN + ["--part-dir", parts, "--merge"] + args)
    # a part ends every record with a newline, as align_files prints it
    assert got.splitlines()[len(_header(got)) + 1:] == \
        want.splitlines()[len(_header(want)) + 1:]


def test_merge_without_part_dir_is_a_usage_error(work):
    with pytest.raises(SystemExit):
        _run(cli.main, ALN + ["--merge", work["prefix"], work["reads"]])


@pytest.mark.parametrize("flags,note", [
    (["-e"], None), (["-v", "-M", "3", "-O", "5", "-E", "2"], None),
    (["-t", "4"], "-t 4 ignored: batches are data-parallel on the device "
                  "(cpu)"),
    (["-n", "2"], "-n is inert"), (["-l", "150"], "-l is inert")])
def test_aln_inert_options_change_nothing(work, plain, flags, note):
    rc, got, err = _run(cli.main, ALN + flags + [work["prefix"], work["reads"]])
    assert rc == 0 and _body(got) == _body(plain)
    assert (note in err) if note else ("[aln]" not in err)
    assert "TPU" not in err


def test_every_option_of_salt_tpu_is_accepted():
    """The port's parser takes every option string and subcommand that
    salt_tpu's takes."""
    import inspect
    import re

    def options(module, command):
        src = inspect.getsource(module)
        block = src[src.index(f'sub.add_parser("{command}"'):]
        block = block[: block.index("sub.add_parser(", 20)] \
            if "sub.add_parser(" in block[20:] else block
        return set(re.findall(r'add_argument\("(-[^"]+)"(?:, "(--[^"]+)")?',
                              block))

    for command in ("idx", "aln", "polish"):
        theirs = {o for pair in options(jcli, command) for o in pair if o}
        ours = {o for pair in options(cli, command) for o in pair if o}
        assert theirs and theirs <= ours, (command, theirs - ours)
    assert set(cli._PASS_THROUGH) == {"wgsim", "snp-etl", "alneval",
                                      "readtools"}
    assert "_not_ported" not in inspect.getsource(cli)


@pytest.fixture(scope="module")
def tool_inputs(tmp_path_factory, work, plain):
    d = tmp_path_factory.mktemp("tools")
    w = [""] * 26
    rows = []
    for i, (start, strand, ref, observed, freqs) in enumerate([
            (99, "+", "A", "A/G", "0.8,0.2"), (299, "-", "C", "C/T", "0.5,0.5"),
            (499, "+", "G", "G/T", "0.95,0.05"), (49, "+", "T", "A/T", "0.6,0.4")]):
        w[1], w[2], w[3], w[6] = f"chr{i % 2}", str(start), str(start + 1), strand
        w[7] = w[8] = ref
        w[9], w[11] = observed, "single"
        w[23], w[25] = observed.replace("/", ","), freqs
        rows.append("\t".join(w))
    (d / "dbsnp.txt").write_text("\n".join(rows) + "\n")
    (d / "calls.vcf").write_text(
        "##header\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n"
        "chr1\t9\trs2\tG\tA,T\t50\tPASS\t.\n"
        "chr0\t5\trs1\tC\tT\t10\tq10\t.\n"
        "chr0\t2\trs0\tCA\tC\t50\tPASS\t.\n"
        "chr1\t3\trs3\tA\tC\t70\tPASS\t.\n")
    (d / "aln.sam").write_text(plain)
    # names in wgsim's form, so that alneval finds the truth in them
    sim = []
    for i, line in enumerate(_body(plain)):
        f = line.split("\t")
        pos = int(f[3]) + (7 if i % 9 == 0 else 0)
        f[0] = f"{f[2] if f[2] != '*' else 'chr0'}_{pos}_{pos + 300}_0:0:0_0:0:0_{i:x}"
        sim.append("\t".join(f))
    (d / "sim.sam").write_text("\n".join(sim) + "\n")
    return dict(work, tools=d, dbsnp=str(d / "dbsnp.txt"),
                vcf=str(d / "calls.vcf"), sam=str(d / "aln.sam"),
                sim=str(d / "sim.sam"))


PASS_THROUGH_CASES = {
    "snp-etl dbsnp": ["snp-etl", "dbsnp", "-s", "{dbsnp}"],
    "snp-etl dbsnp by frequency": ["snp-etl", "dbsnp", "-f", "0.1", "{dbsnp}"],
    "snp-etl vcf": ["snp-etl", "vcf", "{vcf}"],
    "snp-etl vcf filtered": ["snp-etl", "vcf", "--min-qual", "20",
                             "--pass-only", "{vcf}"],
    "snp-etl filter": ["snp-etl", "filter", "{fa}", "{snps}"],
    "snp-etl sort-vcf": ["snp-etl", "sort-vcf", "{vcf}"],
    "alneval": ["alneval", "{sim}"],
    "alneval with a gap": ["alneval", "-g", "5", "{sim}"],
    "alneval unique": ["alneval", "unique", "{sam}"],
    "alneval uniqcmp": ["alneval", "uniqcmp", "{sam}", "{sim}"],
    "readtools unmapped": ["readtools", "unmapped", "{sam}"],
    "readtools unmapped as fasta": ["readtools", "unmapped", "--fasta",
                                    "{sam}"],
}


@pytest.mark.parametrize("case", PASS_THROUGH_CASES)
def test_pass_through_subcommands_match_salt_tpu(tool_inputs, case):
    argv = [a.format(**tool_inputs) for a in PASS_THROUGH_CASES[case]]
    rc, out, _err = _run(cli.main, argv)
    want_rc, want, _ = _run(jcli.main, argv)
    assert (rc, out) == (want_rc, want)
    assert out.strip(), "the case prints something to compare"


def test_readtools_sample_writes_the_files_salt_tpu_writes(tool_inputs):
    argv = ["readtools", "sample", "-N", "10", "-S", "3", tool_inputs["r1"],
            tool_inputs["r2"]]
    made = []
    for main in (cli.main, jcli.main):
        assert _run(main, argv)[0] == 0
        made.append([open(tool_inputs[k] + ".sample").read()
                     for k in ("r1", "r2")])
        for k in ("r1", "r2"):
            os.remove(tool_inputs[k] + ".sample")
    assert made[0] == made[1] and made[0][0].count("\n") == 40


@pytest.mark.parametrize("exact", [False, True])
def test_wgsim_writes_the_files_salt_tpu_writes(tool_inputs, tmp_path, exact):
    made = {}
    for name, main in (("ours", cli.main), ("theirs", jcli.main)):
        a, b = str(tmp_path / f"{name}_1.fq"), str(tmp_path / f"{name}_2.fq")
        rc, out, _ = _run(main, ["wgsim", "-e", "0.01", "-N", "30", "-1", "70",
                                 "-2", "70", "-d", "300", "-s", "20", "-S", "7"]
                          + (["--exact"] if exact else [])
                          + [tool_inputs["fa"], a, b])
        assert rc == 0
        made[name] = (open(a).read(), open(b).read(), out)
    assert made["ours"] == made["theirs"]
    assert made["ours"][0].count("\n") >= 100
    assert made["ours"][0].startswith("@chr")


def test_genome_gen_matches_salt_tpu():
    import numpy as np

    from salt_tpu.sim import genome_gen as jgen
    from salt_tpu_torch.sim import genome_gen as tgen

    for (n1, c1), (n2, c2) in zip(jgen.synthesize_genome(20_000, 2, seed=4),
                                  tgen.synthesize_genome(20_000, 2, seed=4)):
        assert n1 == n2 and np.array_equal(c1, c2)


def test_device_trace_writes_a_trace_only_when_asked(work, plain, tmp_path,
                                                     monkeypatch):
    from salt_tpu_torch.utils.metrics import device_trace

    monkeypatch.delenv("SALT_TPU_TRACE", raising=False)
    with device_trace("nothing", "cpu"):
        pass
    assert os.listdir(tmp_path) == []
    monkeypatch.setenv("SALT_TPU_TRACE", str(tmp_path / "traces"))
    rc, got, _ = _run(cli.main, ALN + [work["prefix"], work["reads"]])
    assert rc == 0 and _body(got) == _body(plain)
    made = sorted(os.listdir(tmp_path / "traces" / "align_records"))
    assert len(made) == 1                       # one align_records call
    with open(tmp_path / "traces" / "align_records" / made[0]) as fh:
        events = json.load(fh)["traceEvents"]
    assert any(e.get("cat") == "cpu_op" for e in events)
    # both batches (80 reads in batches of 64), dispatch to finalize, with
    # the program's spans inside
    spans = [e["name"] for e in events if e.get("cat") == "cpu_op"]
    for name in ("device.dispatch", "device.seed", "device.locate",
                 "device.verify", "device.complete", "host.finalize",
                 "host.emit"):
        assert spans.count(name) == 2, name
