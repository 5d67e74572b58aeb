"""salt_tpu_torch/tools/oracle_diff.py (SAM concordance with the
reference binary) on the CPU against a synthesized oracle directory laid
out as tools/make_oracle.sh writes it: a tiny genome, wgsim reads and
hapmap from the port's simulator, and salt_tpu's SE and PE SAM (the
reference_compat index, the drivers' options) in place of the C
binary's.  The port's records agree with all of them, and a changed
record is counted.  Tolerance: exact (SAM bytes)."""

import contextlib
import io
import os
import re

import pytest
import torch

from salt_tpu.index.build import build_index
from salt_tpu.io.fasta import read_records
from salt_tpu.pipeline.engine import SEAligner, SEOptions
from salt_tpu.pipeline.pe_engine import PEAligner, PEOptions
from salt_tpu_torch.sim.genome_gen import synthesize_genome, write_fasta
from salt_tpu_torch.sim.wgsim import SimParams, simulate
from salt_tpu_torch.tools import oracle_diff, run_accuracy

import torch_fixtures  # noqa: F401  (one torch thread a worker)

N_READS = 200
N_PAIRS = 100


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    """An oracle directory (genome.fa beside it) with salt_tpu's SAM."""
    d = tmp_path_factory.mktemp("oracle")
    genome = str(d / "Genome.fa")
    write_fasta(synthesize_genome(80_000, config="uniform"), genome)
    with open(d / "Read1.fq", "w") as f1, open(d / "Read2.fq", "w") as f2, \
            open(d / "mutations.txt", "w") as m:
        simulate(genome, f1, f2, SimParams(
            err_rate=0.0, mut_rate=0.05, indel_frac=0.0, dist=500,
            std_dev=50, n_pairs=N_READS, size_l=100, size_r=100,
            is_hap=True, seed=42), mut_out=m)
    run_accuracy.mutations_to_hapmap(str(d / "mutations.txt"),
                                     str(d / "hapmap.txt"))
    idx = build_index(genome, str(d / "hapmap.txt"), l_seed=19,
                      r_anchor_mode="reference_compat")
    r1 = list(read_records(str(d / "Read1.fq")))
    r2 = list(read_records(str(d / "Read2.fq")))
    se = SEAligner(idx, SEOptions(
        l_overlap=1, max_locate=500, print_nm_md=True, print_xa_cigar=True,
        batch_size=512, gap_batch=64)).align_records(r1)
    with open(d / "se_oracle.sam", "w") as f:
        f.write("@HD\tVN:1.4\n")
        f.writelines(rec + "\n" for rec in se)
    pe = PEAligner(idx, PEOptions(
        l_overlap=5, max_locate=1000, min_tlen=350, max_tlen=650,
        print_nm_md=True, print_xa_cigar=True, batch_size=2048,
        gap_batch=128)).align_pairs(r1[:N_PAIRS], r2[:N_PAIRS])
    with open(d / "pe_oracle.sam", "w") as f:
        f.write("@HD\tVN:1.4\n")
        # the reference prints a blank line after every paired record
        f.writelines(rec + "\n" for rec in pe)
    return str(d), genome


@pytest.fixture
def at_oracle(oracle, monkeypatch):
    monkeypatch.setattr(oracle_diff, "ORACLE_DIR", oracle[0])
    monkeypatch.setattr(oracle_diff, "GENOME", oracle[1])
    return oracle[0]


def run(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert oracle_diff.main(argv + ["--device", "cpu"]) == 0
    return out.getvalue()


def test_se_concordance_is_total(at_oracle):
    text = run([str(N_READS)])
    assert text.splitlines()[-1] == \
        f"concordance: {N_READS}/{N_READS} (100.000%)"


def test_pe_concordance_is_total(at_oracle):
    lines = open(os.path.join(at_oracle, "pe_oracle.sam")).readlines()
    assert len(lines) == 1 + 4 * N_PAIRS and lines[2] == "\n"
    text = run([str(N_PAIRS), "--pe"])
    assert text.splitlines()[-1] == \
        f"concordance: {2 * N_PAIRS}/{2 * N_PAIRS} (100.000%)"


@pytest.mark.parametrize("pe", [False, True])
def test_a_changed_record_is_counted(at_oracle, tmp_path, monkeypatch, pe):
    name = "pe_oracle.sam" if pe else "se_oracle.sam"
    lines = open(os.path.join(at_oracle, name)).readlines()
    at = 1 + (2 * 7 if pe else 7)       # record 7 of either file
    f = lines[at].split("\t")
    f[3] = str(int(f[3]) + 1)
    lines[at] = "\t".join(f)
    for other in os.listdir(at_oracle):
        os.symlink(os.path.join(at_oracle, other), tmp_path / other)
    os.remove(tmp_path / name)
    (tmp_path / name).write_text("".join(lines))
    monkeypatch.setattr(oracle_diff, "ORACLE_DIR", str(tmp_path))
    n = 2 * N_PAIRS if pe else N_READS
    text = run([str(N_PAIRS)] + ["--pe"] if pe else [str(N_READS)])
    assert re.search(rf"^--- (rec|read) 7$", text, re.M)
    assert text.splitlines()[-1] == \
        f"concordance: {n - 1}/{n} ({100.0 * (n - 1) / n:.3f}%)"


def test_device_defaults_to_the_card(at_oracle):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA"):
        oracle_diff.main([str(N_READS)])
