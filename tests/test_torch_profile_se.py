"""salt_tpu_torch/tools/profile_se.py (the stage profile of the SE chain)
at a tiny genome on the CPU: one line a part, the parts computing what
the aligner's ungapped step computes, the finalize split under cProfile,
and the card as the default device.  Tolerance: exact (packed
results)."""

import contextlib
import dataclasses
import io
import re

import pytest
import torch

from salt_tpu_torch.constants import NOGAP_MAX_DIFF
from salt_tpu_torch.io.fasta import read_records
from salt_tpu_torch.ops.verify import StrandVerify, replay_and_select
from salt_tpu_torch.pipeline.engine import (
    SEAligner,
    SEOptions,
    encode_reads,
    revcomp,
)
from salt_tpu_torch.pipeline.se import pack_result
from salt_tpu_torch.tools import profile_se, run_accuracy

import torch_fixtures  # noqa: F401  (one torch thread a worker)

B = 64
L = 100
ARGV = [str(B), "--genome-synth", "100000", "--n-pairs", "300"]
PARTS = ("seed", "seed+locate", "seed+locate+verify", "ungapped", "gapped",
         "ungapped (sampled)")


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("profile"))


@pytest.fixture(scope="module")
def printed(workdir):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert profile_se.main(ARGV + ["--device", "cpu", "--workdir",
                                       workdir]) == 0
    return out.getvalue()


@pytest.fixture(scope="module")
def fixture(workdir, printed):
    """The index and reads of the profile's run (the workdir's files)."""
    args = run_accuracy.parse_args([
        "300", "--genome-synth", "100000", "--genome-config", "uniform",
        "--sim", "internal", "--workdir", workdir])
    prod = run_accuracy.simulate(args)
    return run_accuracy.build(args, prod), list(read_records(prod.r1))


def test_prints_a_line_a_part(printed):
    got = re.findall(r"^\[profile\] (.+?) +first call +([\d.]+) s, steady "
                     r"+([\d.]+) ms, device busy not measured \(no card\)$",
                     printed, re.M)
    assert tuple(p for p, _f, _s in got) == PARTS
    assert all(float(s) > 0 for _p, _f, s in got)
    assert re.search(r"^\[profile\] ungapped-only equiv +\d+ reads/s$",
                     printed, re.M)
    assert re.search(r"^\[profile\] sampled overhead +[\d.]+x$", printed, re.M)


def test_finalize_split_lists_its_functions(printed):
    assert re.search(r"^\[profile\] one batch of 64 reads under cProfile: "
                     r"wall [\d.]+ s; .*host\.finalize [\d.]+ s", printed, re.M)
    rows = re.findall(r"^\[profile\]   +([\d.]+) +([\d.]+) +(\d+)  (.+)$",
                      printed, re.M)
    assert len(rows) == profile_se.TOP_FUNCTIONS
    assert "(_finalize_batch)" in rows[0][3]
    cum = [float(r[0]) for r in rows]
    assert cum == sorted(cum, reverse=True)


def test_parts_compute_the_aligner_step(fixture):
    """Each part computes what the aligner's steps compute on the same
    batch: its loci, its verified counts, its packed ungapped and gapped
    results, in full and in sampled mode."""
    idx, recs = fixture
    opts = SEOptions(l_overlap=1, max_locate=500, batch_size=B)
    al = SEAligner(idx, opts, device="cpu")
    sampled = SEAligner(idx, dataclasses.replace(opts, sa_mode="sampled"),
                        device="cpu")
    fns = dict(profile_se.parts(al, sampled))
    assert tuple(fns) == PARTS
    codes = encode_reads([r.seq for r in recs[:B]])
    f, r = torch.from_numpy(codes), torch.from_numpy(revcomp(codes))
    o = al.opts
    out, want = al._ungapped(f, r, o.full_cap(), o.verify_width)
    assert torch.equal(fns["ungapped"](f, r)[1], want)
    assert torch.equal(fns["ungapped (sampled)"](f, r)[1], want)

    _seq2, lc, _ovf = fns["seed+locate"](f, r)
    assert torch.equal(lc.pos, torch.cat([out.loci0.pos, out.loci1.pos]))
    v = fns["seed+locate+verify"](f, r)
    half = [StrandVerify(*(a[s] for a in v)) for s in (slice(0, B), slice(B, None))]
    res = replay_and_select(*half, NOGAP_MAX_DIFF, o.k_hits)
    assert all(torch.equal(a, b) for a, b in zip(res, out.res))

    rows = torch.arange(profile_se.GAPPED_ROWS)
    g = fns["gapped"](f, r)
    assert torch.equal(pack_result(g.res, (g.overflow,)),
                       al._gapped(f[rows], r[rows], out, rows, L // 10,
                                  o.verify_width))


def test_profile_needs_two_batches(fixture):
    idx, recs = fixture
    with pytest.raises(ValueError, match="needs"):
        profile_se.profile(idx, recs[:B], B, torch.device("cpu"))


def test_trace_counts_need_a_card():
    assert profile_se.trace_counts(lambda: None, torch.device("cpu")) is None


def test_device_defaults_to_the_card(workdir):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA"):
        profile_se.main(ARGV + ["--workdir", workdir])
