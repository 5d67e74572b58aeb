"""SE slice parity: salt_tpu_torch's SEAligner on CPU tensors emits SAM
records byte-identical to salt_tpu's SEAligner, on the tiny fixture, on
a repeat genome with indel reads (gapped path, overflow and full-cap
re-runs forced by a small max_locate and verify_width), and on mixed
read lengths.  Tolerance: exact."""

import io
from contextlib import redirect_stdout

import pytest

from salt_tpu.io.fasta import SeqRecord
from salt_tpu.pipeline.engine import SEAligner as JaxAligner
from salt_tpu.pipeline.engine import SEOptions as JaxOptions
from salt_tpu_torch.pipeline.engine import SEAligner, SEOptions
from salt_tpu_torch.utils.metrics import metrics, metrics_reset

from torch_fixtures import repeat_fixture, tiny_fixture

TINY_OPTS = dict(l_overlap=1, max_locate=500, print_nm_md=True,
                 print_xa_cigar=True, batch_size=64, gap_batch=16)
# small caps force the overflow, full-cap and gapped-overflow re-runs
REPEAT_OPTS = dict(l_overlap=1, max_locate=16, verify_width=8,
                   print_nm_md=True, print_xa_cigar=True, batch_size=64,
                   gap_batch=16)


def _both(idx, records, opts):
    want = JaxAligner(idx, JaxOptions(**opts)).align_records(records)
    metrics_reset()
    got = SEAligner(idx, SEOptions(**opts), device="cpu").align_records(records)
    return want, got, metrics()


def _assert_same(want, got):
    assert len(want) == len(got)
    bad = [(a, b) for a, b in zip(want, got) if a != b]
    assert not bad, f"{len(bad)}/{len(want)} records differ; first: {bad[0]}"


@pytest.fixture(scope="module")
def tiny():
    idx, records = tiny_fixture()
    want, got, stages = _both(idx, records, TINY_OPTS)
    return idx, records, want, got, stages


@pytest.fixture(scope="module")
def repeat(tmp_path_factory):
    idx, records = repeat_fixture(str(tmp_path_factory.mktemp("repeat")))
    want, got, stages = _both(idx, records, REPEAT_OPTS)
    return idx, records, want, got, stages


def test_tiny_fixture_sam_identical(tiny):
    _idx, _records, want, got, stages = tiny
    _assert_same(want, got)
    assert stages["device.gapped"][1] > 0
    assert sum(1 for line in got if line.split("\t")[2] != "*") > len(got) // 2


def test_repeat_genome_sam_identical(repeat):
    _idx, _records, want, got, _stages = repeat
    _assert_same(want, got)


@pytest.mark.parametrize("stage", ["device.ungapped_full", "device.gapped",
                                   "device.gapped_full"])
def test_repeat_genome_runs_rerun_paths(repeat, stage):
    """The fixture reaches the gapped check and both re-run tiers."""
    assert repeat[4][stage][1] > 0


def test_gapped_reads_get_indel_cigars(repeat):
    cigars = [line.split("\t")[5] for line in repeat[3]]
    assert any("I" in c or "D" in c for c in cigars)


def test_mixed_lengths_sam_identical(repeat):
    idx, records = repeat[0], repeat[1]
    mixed = [SeqRecord(r.name, r.comment, r.seq[:L], r.qual[:L])
             for r, L in zip(records, [70, 85, 100] * len(records))]
    want, got, _ = _both(idx, mixed, REPEAT_OPTS)
    _assert_same(want, got)
    assert {len(line.split("\t")[9]) for line in got if line} == {70, 85, 100}


def test_se_ungapped_and_full_width_verify_match(repeat):
    """pipeline/se.py's ungapped step and its full-width re-verify,
    field by field, against salt_tpu's on the repeat fixture."""
    import jax.numpy as jnp
    import numpy as np
    import torch

    from salt_tpu.pipeline import se as jse
    from salt_tpu.pipeline.device_index import to_device_index as jax_dix
    from salt_tpu_torch.pipeline import se
    from salt_tpu_torch.pipeline.device_index import to_device_index
    from salt_tpu_torch.pipeline.engine import encode_reads, revcomp

    idx, records = repeat[0], repeat[1]
    fwd = encode_reads([r.seq for r in records[:64]])
    rev = revcomp(fwd)
    kw = dict(l_overlap=1, max_seed=50, max_locate=16, cap=192, u=8,
              k_hits=8)
    jd = jax_dix(idx)
    want = jse.se_ungapped(jd, jnp.asarray(fwd), jnp.asarray(rev), **kw)
    td = to_device_index(idx, "cpu")
    got = se.se_ungapped(td, torch.from_numpy(fwd), torch.from_numpy(rev), **kw)

    def same(g, w):
        assert np.array_equal(g.numpy().astype(np.int64),
                              np.asarray(w).astype(np.int64))

    for g, w in zip(got.res, want.res):
        same(g, w)
    same(got.needs_gap, want.needs_gap)
    same(got.overflow, want.overflow)
    for g, w in zip(got.loci0 + got.loci1, want.loci0 + want.loci1):
        same(g, w)
    assert got.overflow.any()                  # u=8 truncates some reads
    full_w = jse.se_ungapped_full(jd, jnp.asarray(fwd), jnp.asarray(rev),
                                  want.loci0, want.loci1, 16, 192, k_hits=8)
    full_g = se.se_ungapped_full(td, torch.from_numpy(fwd),
                                 torch.from_numpy(rev), got.loci0, got.loci1,
                                 k_hits=8)
    for g, w in zip(full_g, full_w):
        same(g, w)


def test_cli_aln_on_saved_index(tiny, tmp_path):
    from salt_tpu.index.store import save_index
    from salt_tpu_torch import cli

    idx, records, want, _got, _ = tiny
    save_index(idx, str(tmp_path / "idx"))
    fq = tmp_path / "reads.fq"
    fq.write_text("".join(f"@{r.name}\n{r.seq}\n+\n{r.qual}\n" for r in records))
    out = io.StringIO()
    with redirect_stdout(out):
        rc = cli.main(["aln", "--device", "cpu", "-d", "-c", "-r", "1",
                       "-m", "500", "--batch-size", "64", str(tmp_path / "idx"),
                       str(fq)])
    assert rc == 0
    lines = out.getvalue().splitlines()
    assert lines[0].startswith("@")
    _assert_same(want, [l for l in lines if not l.startswith("@")])


@pytest.mark.parametrize("flags", [["--shards", "2", "-p"],
                                   ["--shards", "2", "-X", "1"],
                                   ["--shards", "2"],
                                   ["--shards", "4", "--sa-mode", "sampled"]])
def test_cli_unported_paths_exit_with_message(tmp_path, flags):
    """No path is left unported: the options that used to exit with a
    "not ported" message now get as far as loading the index, which is
    not there."""
    from salt_tpu_torch import cli

    with pytest.raises(FileNotFoundError, match="idx"):
        cli.main(["aln", "--device", "cpu"] + flags
                 + [str(tmp_path / "idx"), str(tmp_path / "r.fq")]
                 + ([str(tmp_path / "r2.fq")] if "-p" in flags else []))


def test_cuda_without_gpu_raises(tiny):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SEAligner(tiny[0], SEOptions(), device="cuda")


def test_hit_finalize_helpers_match():
    """The copied host helpers (set_hits, set_hits_batch, gen_mapq,
    gen_mapq_batch, revcomp) against salt_tpu's on random hit lists."""
    import numpy as np

    from salt_tpu.pipeline import engine as jeng
    from salt_tpu_torch.pipeline import engine as teng

    rng = np.random.default_rng(8)
    M, K = 200, 8
    hits_pos = rng.integers(0, 50, (M, 2, K)).astype(np.uint32)
    hits_ndiff = rng.integers(0, 4, (M, 2, K))
    n_hits = rng.integers(0, K + 3, (M, 2))
    a0 = rng.integers(0, 4, (M, 2))
    pos = rng.integers(0, 50, M)
    nd = rng.integers(0, 4, M)
    args = (pos, nd, n_hits, a0, hits_pos, hits_ndiff, 5)
    for g, w in zip(teng.set_hits_batch(*args), jeng.set_hits_batch(*args)):
        assert np.array_equal(g, w)
    for i in range(M):
        one = (int(pos[i]), int(nd[i]), n_hits[i], a0[i], hits_pos[i],
               hits_ndiff[i], 5)
        assert teng.set_hits(*one) == jeng.set_hits(*one)
        assert teng.gen_mapq(int(nd[i]), int(a0[i, 0])) == \
            jeng.gen_mapq(int(nd[i]), int(a0[i, 0]))
    assert np.array_equal(teng.gen_mapq_batch(nd, a0[:, 0]),
                          jeng.gen_mapq_batch(nd, a0[:, 0]))
    codes = rng.integers(0, 6, (4, 30)).astype(np.uint8)
    assert np.array_equal(teng.revcomp(codes), jeng.revcomp(codes))
