"""-X 1 slice parity: salt_tpu_torch's SEAligner(extend_algo="sw") on CPU
tensors emits SAM byte-identical to salt_tpu's, with the batched SW
pre-filter off and on, and the single-read behaviours salt_tpu's own
tests pin.  Each aligner gets its own package's index (salt_tpu's build,
carried across with index_from_arrays).  Tolerance: exact."""

import io
from contextlib import redirect_stdout

import numpy as np
import pytest

from salt_tpu.index.build import build_index_from_data
from salt_tpu.io.snp import SnpBlock
from salt_tpu.pipeline.engine import SEAligner as JaxAligner
from salt_tpu.pipeline.engine import SEOptions as JaxOptions
from salt_tpu_torch.index.store import save_index
from salt_tpu_torch.pipeline.engine import SEAligner, SEOptions
from salt_tpu_torch.utils.metrics import metrics, metrics_reset

from torch_fixtures import as_records, port_index, tiny_fixture

BASES = "ACGT"


@pytest.fixture(scope="module")
def one_snp():
    """The 2,000-base genome with one SNP of salt_tpu's -X 1 tests."""
    rng = np.random.default_rng(7)
    seq = "".join(BASES[c] for c in rng.integers(0, 4, 2000))
    ref = BASES.index(seq[100])
    stype = np.array([(1 << ref) | (1 << ((ref + 1) % 4)) | (ref << 4)], np.uint8)
    idx = build_index_from_data(
        [("c1", "t", seq)], [SnpBlock("c1", np.array([100], np.uint32), stype)],
        l_seed=19)
    return idx, port_index(idx), seq


def _gap_reads(seq):
    """24 reads that fail the ungapped pass: a 3 bp deletion or four
    substitutions each."""
    rng = np.random.default_rng(12)
    reads = []
    for i in range(24):
        start = int(rng.integers(0, 1800))
        r = list(seq[start : start + 100])
        if i % 2:
            del r[40:43]
            r += list(seq[start + 100 : start + 103])
        else:
            for p in (10, 30, 50, 70):
                r[p] = BASES[(BASES.index(r[p]) + 1) % 4]
        reads.append((f"r{i}", "".join(r)))
    return as_records(reads)


def _opts(device_sw, **kw):
    return dict(l_overlap=1, max_locate=100, batch_size=32, extend_algo="sw",
                print_nm_md=True, device_sw=device_sw, device_sw_min_batch=1,
                **kw)


def _assert_same(want, got):
    assert len(want) == len(got)
    bad = [(a, b) for a, b in zip(want, got) if a != b]
    assert not bad, f"{len(bad)}/{len(want)} records differ; first: {bad[0]}"


@pytest.mark.parametrize("device_sw", ["off", "on"])
def test_gap_reads_sam_identical(one_snp, device_sw):
    jidx, tidx, seq = one_snp
    recs = _gap_reads(seq)
    want = JaxAligner(jidx, JaxOptions(**_opts(device_sw))).align_records(recs)
    metrics_reset()
    got = SEAligner(tidx, SEOptions(**_opts(device_sw)),
                    device="cpu").align_records(recs)
    _assert_same(want, got)
    stages = metrics()
    assert stages["host.sw_extend"][1] > 0
    assert ("device.sw_score" in stages) == (device_sw == "on")
    cigars = [line.split("\t")[5] for line in got]
    assert sum("D" in c or "I" in c for c in cigars) >= 8


@pytest.fixture(scope="module")
def tiny():
    idx, records = tiny_fixture()
    return idx, port_index(idx), records


@pytest.mark.parametrize("device_sw", ["off", "on"])
def test_tiny_fixture_sam_identical(tiny, device_sw):
    jidx, tidx, records = tiny
    opts = _opts(device_sw, print_xa_cigar=True)
    opts.update(max_locate=500, batch_size=64)
    want = JaxAligner(jidx, JaxOptions(**opts)).align_records(records)
    got = SEAligner(tidx, SEOptions(**opts), device="cpu").align_records(records)
    _assert_same(want, got)
    assert sum(1 for line in got if line.split("\t")[2] != "*") > len(got) // 2
    assert any("S" in line.split("\t")[5] or "D" in line.split("\t")[5]
               for line in got)


def test_auto_prefilter_is_off_on_the_cpu(one_snp):
    """device_sw="auto" on a CPU aligner takes the branch salt_tpu takes
    off the TPU: no batched scoring, same SAM."""
    jidx, tidx, seq = one_snp
    recs = _gap_reads(seq)
    opts = _opts("auto")
    want = JaxAligner(jidx, JaxOptions(**opts)).align_records(recs)
    metrics_reset()
    got = SEAligner(tidx, SEOptions(**opts), device="cpu").align_records(recs)
    _assert_same(want, got)
    assert "device.sw_score" not in metrics()


def _one(idx, read, device_sw="off"):
    al = SEAligner(idx, SEOptions(**_opts(device_sw)), device="cpu")
    return al.align_records(as_records([("r0", read)]))[0].split("\t")


@pytest.mark.parametrize("device_sw", ["off", "on"])
@pytest.mark.parametrize("case", ["deletion", "clipped", "ungapped"])
def test_single_read_cases(one_snp, case, device_sw):
    _jidx, tidx, seq = one_snp
    if case == "deletion":
        f = _one(tidx, seq[300:352] + seq[355:403], device_sw)
        assert f[3] == "301" and f[5] == "52M3D48M" and int(f[4]) > 0
    elif case == "clipped":
        f = _one(tidx, "A" * 10 + seq[500:590], device_sw)
        assert f[5].startswith("10S") or f[5].startswith("11S"), f[5]
        assert f[3] in ("501", "502")
    else:
        f = _one(tidx, seq[700:800], device_sw)
        assert f[3] == "701" and f[5] == "100M"


def test_cli_x1_on_saved_index(one_snp, tmp_path):
    from salt_tpu_torch import cli

    jidx, tidx, seq = one_snp
    recs = _gap_reads(seq)
    want = JaxAligner(jidx, JaxOptions(**_opts("auto"))).align_records(recs)
    save_index(tidx, str(tmp_path / "idx"))
    fq = tmp_path / "reads.fq"
    fq.write_text("".join(f"@{r.name}\n{r.seq}\n+\n{r.qual}\n" for r in recs))
    out = io.StringIO()
    with redirect_stdout(out):
        rc = cli.main(["aln", "--device", "cpu", "-X", "1", "-d", "-r", "1",
                       "-m", "100", "--batch-size", "32",
                       str(tmp_path / "idx"), str(fq)])
    assert rc == 0
    lines = out.getvalue().splitlines()
    assert lines[0].startswith("@")
    _assert_same(want, [l for l in lines if not l.startswith("@")])


def test_bad_options_raise(one_snp):
    _jidx, tidx, _seq = one_snp
    with pytest.raises(ValueError, match="extend_algo"):
        SEAligner(tidx, SEOptions(extend_algo="nw"), device="cpu")
    with pytest.raises(ValueError, match="device_sw"):
        SEAligner(tidx, SEOptions(device_sw="maybe"), device="cpu")
