"""salt_tpu_torch/tools/bench.py (salt_tpu's bench.py on the port) on the
CPU at small sizes: its SE, PE and scale fixtures are the root bench.py's
bytes, its SE and PE runs give salt_tpu's SAM on the same reads and
options, and its last line is bench.py's JSON line.  Tolerance: exact
(fixture bytes, SAM bytes)."""

import contextlib
import dataclasses
import io
import json
import os
import time

import numpy as np
import pytest

import bench as salt_bench           # the root bench.py (no jax at import)
import salt_tpu.index.build
import salt_tpu.pipeline.engine
from salt_tpu.index.build import build_index_from_data as jax_build
from salt_tpu.io.fasta import SeqRecord
from salt_tpu.io.snp import SnpBlock as JaxBlock
from salt_tpu.pipeline.engine import SEAligner as JaxAligner
from salt_tpu.pipeline.engine import SEOptions as JaxOptions
from salt_tpu.pipeline.pe_engine import PEAligner as JaxPEAligner
from salt_tpu.pipeline.pe_engine import PEOptions as JaxPEOptions
from salt_tpu_torch.index.build import build_index_from_data
from salt_tpu_torch.tools import bench

import torch_fixtures  # noqa: F401  (one torch thread a worker)

BATCH = 32
N_SE = BATCH + 4 * BATCH        # a warm-up batch and two timed calls
CONTIGS = (("chrA", "first contig", 3000), ("chrB", None, 2500),
           ("chrC", "third", 2000))
KEY_ORDER = ["metric", "value", "unit", "vs_baseline", "pe_pairs_per_sec",
             "scale45mb_repeat_se_reads_per_sec"]


def write_genome(path):
    """A FASTA of CONTIGS (comments on two; a few N and lowercase bases)."""
    rng = np.random.default_rng(3)
    with open(path, "w") as f:
        for name, comment, n in CONTIGS:
            seq = np.array(list("ACGT"))[rng.integers(0, 4, n)]
            seq[rng.integers(0, n, 12)] = "N"
            low = rng.integers(0, n, 40)
            seq[low] = np.char.lower(seq[low])
            f.write(f">{name}" + (f" {comment}" if comment else "") + "\n")
            s = "".join(seq)
            for i in range(0, n, 60):
                f.write(s[i : i + 60] + "\n")
    return str(path)


@pytest.fixture(scope="module")
def genome(tmp_path_factory):
    return write_genome(tmp_path_factory.mktemp("bench") / "genome.fa")


@pytest.fixture(scope="module")
def fixture(genome):
    return bench.make_fixture(genome)


def test_fixture_is_salt_tpus(genome, fixture, monkeypatch):
    monkeypatch.setattr(salt_bench, "GENOME", genome)
    want = salt_bench.make_fixture()
    got = fixture
    assert got[0] == want[0]
    assert [c[1] for c in got[0]] == ["first contig", "(null)", "third"]
    assert len(got[1]) == len(want[1]) == len(CONTIGS)
    for a, b in zip(got[1], want[1]):
        assert a.chrom == b.chrom
        assert a.pos.dtype == b.pos.dtype and a.stype.dtype == b.stype.dtype
        assert np.array_equal(a.pos, b.pos)
        assert np.array_equal(a.stype, b.stype)
    assert len(got[2]) == bench.N_READS
    assert got[2] == want[2]


def test_pe_fixture_is_salt_tpus(genome, fixture, monkeypatch):
    monkeypatch.setattr(salt_bench, "GENOME", genome)
    contigs, blocks, _ = salt_bench.make_fixture()
    want = salt_bench.make_pe_fixture(contigs, blocks, 64)
    got = bench.make_pe_fixture(fixture[0], fixture[1], 64)
    assert len(got[0]) == 64
    assert got == want


def test_scale_fixture_is_salt_tpus(monkeypatch):
    """salt_tpu's run_scale at 1 M bases, with its index build and
    aligner replaced by stubs that keep what they are given: the same
    genome, SNP blocks, reads and options as the port's scale_fixture."""
    seen = {"aligned": []}

    def build(contig_data, blocks, l_seed):
        seen["build"] = (contig_data, blocks, l_seed)
        return "index"

    class Aligner:
        def __init__(self, idx, opts):
            seen["opts"] = opts

        def align_records(self, recs):
            seen["aligned"].append(recs)
            time.sleep(0.001)
            return ["s\t0\tchr1"] * len(recs)

    monkeypatch.setattr(salt_tpu.index.build, "build_index_from_data", build)
    monkeypatch.setattr(salt_tpu.pipeline.engine, "SEAligner", Aligner)
    monkeypatch.setattr(salt_bench, "BATCH", 16)
    salt_bench.run_scale(genome_mb=1)
    contig_data, blocks, recs = bench.scale_fixture(1_000_000, 16)

    (w_name, w_comment, w_seq), = seen["build"][0]
    (name, comment, seq), = contig_data
    assert (name, comment) == (w_name, w_comment) == ("chr1", "synthetic")
    assert np.array_equal(seq, w_seq)
    (wb,), (b,) = seen["build"][1], blocks
    assert b.chrom == wb.chrom
    assert np.array_equal(b.pos, wb.pos) and b.pos.dtype == wb.pos.dtype
    assert np.array_equal(b.stype, wb.stype)
    assert seen["build"][2] == 19
    warm, timed_recs = seen["aligned"]
    assert [(r.name, r.seq, r.qual) for r in recs] == [
        (r.name, r.seq, r.qual) for r in warm + timed_recs]
    assert len(warm) == 16 and len(recs) == 48
    want_opts = dataclasses.asdict(seen["opts"])
    got_opts = dataclasses.asdict(bench.se_options(16))
    assert {k: got_opts[k] for k in want_opts if k in got_opts} == {
        k: v for k, v in want_opts.items() if k in got_opts}


def _jax_index(fixture):
    contigs, blocks, _ = fixture
    return jax_build(contigs, [JaxBlock(b.chrom, b.pos, b.stype)
                               for b in blocks], l_seed=19)


def _jax_records(seqs, prefix):
    return [SeqRecord(f"{prefix}{i}", None, s, "I" * len(s))
            for i, s in enumerate(seqs)]


@pytest.fixture(scope="module")
def runs(fixture):
    """The port's SE and PE runs (CPU, batch 32) and salt_tpu's SAM of the
    same reads (pairs) under bench.py's options."""
    contigs, blocks, reads = fixture
    idx = build_index_from_data(contigs, blocks, l_seed=19)
    lines = []
    se = bench.run_se(idx, reads[:N_SE], BATCH, "cpu", lines.append)
    pe = bench.run_pe(contigs, blocks, idx, BATCH, "cpu", lines.append)
    jidx = _jax_index(fixture)
    kw = dict(l_overlap=1, max_locate=500, print_nm_md=True,
              print_xa_cigar=True, batch_size=BATCH, gap_batch=128)
    want_se = JaxAligner(jidx, JaxOptions(**kw)).align_records(
        _jax_records(reads[:N_SE], "r"))
    r1, r2 = bench.make_pe_fixture(contigs, blocks, 3 * BATCH)
    want_pe = JaxPEAligner(jidx, JaxPEOptions(**kw)).align_pairs(
        _jax_records(r1, "p"), _jax_records(r2, "p"))
    return se, pe, want_se, want_pe, lines


def test_se_run_gives_salt_tpus_sam(runs):
    se, _pe, want, _, lines = runs
    assert se.n == N_SE - BATCH and len(se.sam) == N_SE
    assert se.rate > 0 and se.mapped > 0.9 * se.n
    assert se.sam == want
    assert f"aligned {se.n} reads in" in "\n".join(lines)


def test_pe_run_gives_salt_tpus_sam(runs):
    _se, pe, _, want, lines = runs
    assert pe.n == 2 * BATCH and len(pe.sam) == 2 * 3 * BATCH
    assert pe.rate > 0
    assert pe.sam == want
    assert any(line.startswith(f"PE: {pe.n} pairs in") for line in lines)


def test_runs_report_stages_and_launches(runs):
    se, pe, _, _, lines = runs
    assert set(se.stages) >= {"host.finalize", "device.dispatch"}
    assert set(pe.stages) >= {"host.pairing", "host.sam"}
    assert se.launches == pe.launches == {"K1": 0, "K2": 0}   # no card
    text = "\n".join(lines)
    for tag in ("SE", "PE"):
        assert f"[bench] {tag} stages, seconds a batch: " in text
        assert (f"[bench] {tag} kernel launches in the timed calls: "
                "K1 0, K2 0") in text


def test_scale_run(monkeypatch):
    lines = []
    run = bench.run_scale(200_000, BATCH, "cpu", lines.append)
    assert run.n == 2 * BATCH and len(run.sam) == 3 * BATCH
    assert run.rate > 0 and run.mapped > 0.5 * run.n
    assert [r.name for r in run.records[:2]] == ["s0", "s1"]
    assert any(line.startswith("[bench] scale index (0.2MB repeat) built")
               for line in lines)
    assert any(line.startswith(f"[bench] scale: {run.n} reads in")
               for line in lines)


def _main(argv, monkeypatch):
    monkeypatch.setenv("SALT_TPU_BENCH_BATCH", str(BATCH))
    monkeypatch.setattr(bench, "N_READS", 3 * BATCH)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert bench.main(argv + ["--device", "cpu", "--no-scale"]) == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


def test_json_line_on_a_stand_in(monkeypatch):
    rec = _main(["--genome-synth", "6000", "--n-contigs", "2"], monkeypatch)
    assert list(rec) == KEY_ORDER[:5]
    assert rec["metric"] == "se_reads_per_sec_per_chip"
    assert rec["unit"] == "reads/s"
    assert rec["vs_baseline"] is None
    assert rec["value"] > 0 and rec["pe_pairs_per_sec"] > 0


def test_json_line_on_the_bundled_genome(tmp_path, monkeypatch):
    path = tmp_path / "Test" / "Genome" / "Genome.fa"
    os.makedirs(path.parent)
    write_genome(path)
    rec = _main(["--genome", str(path), "--no-pe"], monkeypatch)
    assert list(rec) == KEY_ORDER[:4]
    assert rec["vs_baseline"] == round(
        rec["value"] / bench.BASELINE_READS_PER_SEC, 3)


def test_result_line_keys_and_rounding():
    rec = json.loads(bench.result_line(12345.678, 2345.66, 345.649, True))
    assert list(rec) == KEY_ORDER
    assert rec == {"metric": "se_reads_per_sec_per_chip", "value": 12345.7,
                   "unit": "reads/s", "vs_baseline": 4.984,
                   "pe_pairs_per_sec": 2345.7,
                   "scale45mb_repeat_se_reads_per_sec": 345.6}


def test_missing_genome_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        bench.main(["--genome", str(tmp_path / "absent.fa"), "--device",
                    "cpu"])


def test_device_defaults_to_the_card():
    if bench.torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA"):
        bench.main(["--genome-synth", "6000"])
