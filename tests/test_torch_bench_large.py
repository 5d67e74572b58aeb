"""The whole-genome drivers of salt_tpu_torch (tools/bench_large.py and
tools/build_sharded.py) at a small size on the CPU: a 2,000,000-base
genome in 8 contigs, built in 4 shards (each in its own process) and
whole; bench_large over the whole index in full and sampled mode, over
the 4 shards, and from a bundle it saved itself, with a batch of 256.
The SAM of each run equals the others' on reads drawn EDGE bases inside
their contig (every read, between the two modes), and the log lines that
PERF.md reads parse.  Tolerance: exact."""

import contextlib
import io
import json
import math
import os
import re

import numpy as np
import pytest
import torch

from salt_tpu_torch.index.store import load_index
from salt_tpu_torch.parallel.sharded import host_index, load_sharded_index
from salt_tpu_torch.tools import bench_large, build_sharded

import torch_fixtures  # noqa: F401  (one torch thread a worker)

GENOME = 2_000_000


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """The prefix of the sharded and whole builds, and build_sharded's
    output."""
    d = tmp_path_factory.mktemp("bench_large")
    prefix = str(d / "idx")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = build_sharded.main([str(GENOME), "4", "--contigs", "8",
                                 "--monolithic", "--prefix", prefix])
    assert rc == 0
    return prefix, out.getvalue()


def _bench(argv, monkeypatch):
    monkeypatch.setenv("SALT_TPU_BENCH_BATCH", "256")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = bench_large.main(argv + ["--device", "cpu"])
    assert rc == 0
    return out.getvalue()


def _differ(log):
    """(tag, differing, compared) of every held_equal line."""
    return [(m[1], int(m[2]), int(m[3])) for m in re.finditer(
        r"\] (.*): (\d+) of (\d+) records differ", log)]


def test_chunked_draws_equal_one_call(monkeypatch):
    """The uniform genome drawn in chunks (an odd size here) is the one
    call's, and leaves the generator where the one call leaves it."""
    monkeypatch.setattr(bench_large, "DRAW_CHUNK", 1001)
    a, b = np.random.default_rng(7), np.random.default_rng(7)
    got = bench_large.uniform_codes(100_003, a)
    want = b.integers(0, 4, 100_003, dtype=np.int64).astype(np.uint8)
    assert np.array_equal(got, want)
    assert a.integers(0, 2**62) == b.integers(0, 2**62)


def test_device_defaults_to_the_card(built):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_large.main(["0", "--load", built[0]])


def test_build_sharded_writes_what_the_cli_reads(built):
    prefix, out = built
    rows = [build_sharded.parse_shard_line(l) for l in out.splitlines()
            if l.startswith("SHARD")]
    # shards print as they finish, the whole genome after them
    assert sorted(r["which"] for r in rows[:4]) == ["0", "1", "2", "3"]
    assert rows[4]["which"] == "mono" and rows[4]["torch"] == 0
    assert sum(r["bases"] for r in rows[:4]) == rows[4]["bases"] == GENOME
    assert all(r["rss_gb"] > 0 and r["build_s"] >= 0 for r in rows)
    with open(prefix + ".shards.json") as fh:
        man = json.load(fh)
    assert man == {"n_shards": 4, "bins": [[0, 1], [2, 3], [4, 5], [6, 7]]}
    for i in range(4):
        assert os.path.exists(f"{prefix}.shard{i}.salt.npz")
    assert os.path.exists(prefix + ".salt.npz")


def test_host_index_of_the_shards_is_the_whole_ones(built):
    """Without the whole bundle, the shards' pac, mixRef and contig table
    laid end to end are the whole index's (an N-free genome)."""
    whole = load_index(built[0])
    _host, shards, bins = load_sharded_index(built[0])
    got = host_index(shards)
    assert got.l_pac == whole.l_pac and got.l_seed == whole.l_seed
    assert [(c.name, c.offset, c.length) for c in got.contigs] == \
        [(c.name, c.offset, c.length) for c in whole.contigs]
    assert np.array_equal(got.pac, whole.pac)
    assert np.array_equal(got.mixref, whole.mixref)


def test_whole_index_both_modes(built, monkeypatch):
    log = _bench(["0", "--load", built[0], "--pe", "--sa-mode",
                  "full,sampled", "--sam-out", built[0] + "_mono"],
                 monkeypatch)
    for kind, unit, n in (("SE", "reads", 512), ("PE", "pairs", 512)):
        for mode in ("full", "sampled"):
            m = re.search(rf"{kind} {mode}: aligned (\d+) {unit} in "
                          rf"([\d.]+)s -> (\d+) {unit}/s", log)
            assert m and int(m[1]) == n
            assert re.search(rf"{kind} {mode}: device index loaded in "
                             rf"[\d.]+s \(sa_mode={mode}\); index on cpu: "
                             r"\d+ bytes", log)
            assert f"{kind} {mode} per-MAPQ (alneval, 20bp):" in log
    m = re.search(r"SE full accuracy: (\d+)/(\d+) primaries within 5bp", log)
    assert int(m[1]) == int(m[2]) > 500
    assert re.search(r"SE full past 2\^31: 0 primaries", log)
    assert re.search(r"SE full kernel launches: K1 0 ", log)
    assert "device.dispatch" in log
    assert _differ(log) == [("SE sampled against full mode", 0, 512),
                            ("PE sampled against full mode", 0, 1024)]
    assert os.path.getsize(built[0] + "_mono.pe.sam") > 0


def test_sharded_equals_whole(built, monkeypatch):
    if not os.path.exists(built[0] + "_mono.se.sam"):
        _bench(["0", "--load", built[0], "--pe", "--sam-out",
                built[0] + "_mono"], monkeypatch)
    log = _bench(["0", "--load", built[0], "--shards", "4", "--pe",
                  "--compare", built[0] + "_mono"], monkeypatch)
    assert "SE full S=4: aligned 512 reads" in log
    diffs = _differ(log)
    assert [d[0].split(" (")[0] for d in diffs] == [
        f"SE against {built[0]}_mono", f"PE against {built[0]}_mono"]
    assert all(n == 0 and m > 400 for _t, n, m in diffs)
    assert "done; 0 records differ in the checks" in log


def test_save_and_load(tmp_path, monkeypatch):
    prefix = str(tmp_path / "b")
    log = _bench([str(GENOME), "--build-only", "--save", prefix], monkeypatch)
    assert re.search(r"index built in [\d.]+s .* peak RSS [\d.]+GB", log)
    assert re.search(r"saved to .* in [\d.]+s \([\d.]+GB\)", log)
    log = _bench(["0", "--load", prefix], monkeypatch)
    assert re.search(r"bundle loaded in [\d.]+s \(2M bases", log)
    m = re.search(r"SE full accuracy: (\d+)/(\d+) primaries within 5bp", log)
    assert int(m[1]) == int(m[2]) == 512


def test_peak_rss_without_vmhwm(monkeypatch):
    """Where /proc/self/status has no VmHWM (some sandboxed kernels), a
    build reports its peak as not measured (nan), and its SHARD line
    parses."""
    assert build_sharded._peak_rss() > 0
    real_open = open

    def status_without_vmhwm(path, *a, **k):
        if path == "/proc/self/status":
            return io.StringIO("Name:\tpython\nVmRSS:\t 1000 kB\n")
        return real_open(path, *a, **k)

    monkeypatch.setattr(build_sharded, "open", status_without_vmhwm,
                        raising=False)
    rss = build_sharded._peak_rss()
    assert math.isnan(rss)
    row = build_sharded.parse_shard_line(
        f"SHARD 0 bases 10 build_s 1.0 rss_gb {rss / 1e9:.2f} torch 0")
    assert math.isnan(row["rss_gb"]) and row["bases"] == 10
