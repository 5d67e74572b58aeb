"""salt_tpu_torch/tools/bench_configs.py (BASELINE configs 2, 3 and 3s)
at a tiny genome on the CPU: the plain index with no SNP (config 2) and
the SNP-aware one (config 3) give salt_tpu's SAM on the same data and
options, sampled mode (3s) gives full mode's, and the command line prints
a line per config.  Tolerance: exact (SAM bytes)."""

import contextlib
import io
import re

import numpy as np
import pytest

from salt_tpu.index.build import build_index_from_data
from salt_tpu.io.fasta import SeqRecord
from salt_tpu.io.snp import SnpBlock
from salt_tpu.pipeline.engine import SEAligner as JaxAligner
from salt_tpu.pipeline.engine import SEOptions as JaxOptions
from salt_tpu_torch.tools import bench_configs

import torch_fixtures  # noqa: F401  (one torch thread a worker)

GENOME = 30_000
BATCH = 64


def _salt_tpu_sam(genome_len, snp_every, err):
    """salt_tpu's SE SAM of the timed reads, on the same data and options
    (tools/bench_configs.py)."""
    contig_data, blocks, recs, _starts = bench_configs.make_data(
        genome_len, snp_every, err, BATCH)
    idx = build_index_from_data(
        contig_data, [SnpBlock(b.chrom, b.pos, b.stype) for b in blocks],
        l_seed=19)
    al = JaxAligner(idx, JaxOptions(
        l_overlap=1, max_locate=500, print_nm_md=True, print_xa_cigar=True,
        batch_size=BATCH, gap_batch=128))
    return al.align_records([SeqRecord(r.name, r.comment, r.seq, r.qual)
                             for r in recs[BATCH:]])


@pytest.mark.parametrize("key", ["2", "3"])
def test_config_equals_salt_tpu(key):
    _tag, _len, snp_every, err, mode = bench_configs.CONFIGS[key]
    got = bench_configs.run_config(key, GENOME, snp_every, err, mode,
                                   device="cpu", batch=BATCH)
    assert got["n"] == BATCH * bench_configs.N_BATCHES
    assert got["mapped"] > 0.9 * got["n"]
    assert got["sam"] == _salt_tpu_sam(GENOME, snp_every, err)


def test_sampled_equals_full():
    runs = [bench_configs.run_config(
        key, GENOME, *bench_configs.CONFIGS[key][2:], device="cpu",
        batch=BATCH)["sam"] for key in ("3", "3s")]
    assert runs[0] == runs[1]


def test_command_line_prints_a_line_a_config(monkeypatch):
    monkeypatch.setenv("SALT_TPU_BENCH_BATCH", str(BATCH))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert bench_configs.main(["all", "--device", "cpu", "--genome-len",
                                   str(GENOME)]) == 0
    lines = re.findall(
        r"\[config (\S+): .*\] build [\d.]+s, device load [\d.]+s "
        r"\((\d+) index bytes on cpu\), (\d+)/[\d.]+s = \d+ reads/s, "
        r"(\d+)/(\d+) mapped, ([\d.]+)% correct", out.getvalue())
    assert [l[0] for l in lines] == ["2", "3"], out.getvalue()
    for _key, nbytes, n, mapped, n2, pct in lines:
        assert int(n) == int(n2) == BATCH * bench_configs.N_BATCHES
        assert int(nbytes) > 0 and int(mapped) > 0 and float(pct) > 90


def test_device_defaults_to_the_card():
    if bench_configs.torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA"):
        bench_configs.main(["2", "--genome-len", str(GENOME)])
