"""The readers of the sampled-mode locate walk's span and counters
(sa_walk_*_per_kread.sampled): their arithmetic, their cell, and None
where the program has no such span or counter, as before the walk had
them."""

import sys
import types

import pytest

from benchmark import run
from benchmark.tests.helpers import bench, tiny
from test_bench_metrics import RUN

CELL = "chr21_snp144_sampled.se_wgsim"
STAGES = dict(RUN["stages"], **{"device.locate": 3.0, "device.sa_walk": 2.5})
COUNTERS = {"host.sync": 9_000, "sa_walk.blocks": 450,
            "sa_walk.slots": 450 * 8_192 * 128}
# the cell's twins of the full SE cell's `.se` metrics read from spans
# and counters, and its rate, which it reports per layer
SPAN_METRICS = {f"{m}_per_kread.sampled" for m in (
    "ungapped_ms", "seed_ms", "locate_ms", "syncs", "overflow_rows")} | {
    "se_reads_per_s.sampled"}
TRACE_METRICS = {"launches_per_kread.sampled", "device_idle_share.sampled"}
WANT = {
    "sa_walk_ms_per_kread.sampled": 12.5,
    "sa_walk_blocks_per_kread.sampled": 2.25,
    "sa_walk_slots_per_kread.sampled": 2.25 * 8_192 * 128,
}


def _registry(monkeypatch, counters=None):
    mod = types.ModuleType("salt_tpu_torch.utils.metrics")
    if counters is not None:
        mod.counters = lambda: dict(counters)
    monkeypatch.setitem(sys.modules, "salt_tpu_torch.utils.metrics", mod)


@pytest.mark.parametrize("name", sorted(WANT))
def test_walk_metric_arithmetic(name, monkeypatch):
    _registry(monkeypatch, COUNTERS)
    assert run.load_reader(name)(dict(RUN, stages=STAGES)) == \
        pytest.approx(WANT[name])


@pytest.mark.parametrize("name", ["sa_walk_blocks_per_kread.sampled",
                                  "sa_walk_slots_per_kread.sampled"])
def test_walk_counters_of_the_run_come_before_the_registry(name,
                                                           monkeypatch):
    _registry(monkeypatch, {k: 0 for k in COUNTERS})
    assert run.load_reader(name)(dict(RUN, counters=COUNTERS)) == \
        pytest.approx(WANT[name])


@pytest.mark.parametrize("name", sorted(WANT))
def test_walk_metric_without_its_span_or_counter_is_left_out(name,
                                                             monkeypatch):
    """The parent program, and full mode: device.locate without the walk,
    host.sync without the walk's counters."""
    parent = dict(RUN, stages=dict(RUN["stages"], **{"device.locate": 0.1}))
    _registry(monkeypatch, {"host.sync": 9_000})
    assert run.load_reader(name)(parent) is None
    _registry(monkeypatch, None)
    assert run.load_reader(name)(parent) is None
    monkeypatch.delitem(sys.modules, "salt_tpu_torch.utils.metrics")
    assert run.load_reader(name)(parent) is None


def test_walk_metrics_belong_to_the_sampled_cell_alone():
    b = bench()
    for cell in (w["name"] for w in b["workloads"]):
        _e2e, layer = run.cell_metrics(b, cell)
        names = {m["name"] for m in layer}
        assert (set(WANT) <= names) == (cell == CELL)
        assert not (set(WANT) & names) or cell == CELL
    e2e, layer = run.cell_metrics(b, CELL)
    assert {m["name"] for m in e2e} == {"device_memory_peak_gb", "setup_s"}
    assert {m["layer"] for m in layer if m["name"] in WANT} == {
        "device ungapped step"}
    assert {m["name"] for m in layer} == \
        SPAN_METRICS | TRACE_METRICS | set(WANT) | {"sa_walk_k4_share.sampled"}
    assert {m["moves"] for m in layer} == {"device_memory_peak_gb"}


def test_sampled_cell_runs_sampled_mode_on_the_full_cells_genome():
    """The sampled configuration is chr21_snp144 with `--sa-mode sampled`:
    the same genome, SNPs, index and control, so the same bytes."""
    full = run.load_cell("chr21_snp144.se_wgsim")
    sampled = run.load_cell(CELL)
    for key in ("genome", "genome_bases", "snps", "snp_seed", "index",
                "reduced", "control"):
        assert sampled["cfg"][key] == full["cfg"][key], key
    assert run.aln_args(sampled["cfg"], sampled["mix"]) == [
        "--sa-mode", "sampled"]
    assert sampled["mix"] == full["mix"]


def test_traced_sampled_run_reports_the_walk(tmp_path):
    """A whole traced run of the cell on the CPU, cut small: correct, and
    its line holds the three walk metrics beside the cell's other span and
    counter metrics and its rate (those read from a device trace find none
    on the CPU)."""
    cfg, cfg_bytes, mix, limits = tiny(CELL, bases=100_000, per_call=300,
                                       sample=60)
    mix["aln_args"] = ["--batch-size", "256"]     # a warm-up of 300 reads
    res = run.run_cell(CELL, cfg, cfg_bytes, mix, limits, bench(), 5, 0.0,
                       True, device="cpu", cache_dir=tmp_path)
    assert res["correct"], res["checks"]
    got = res["metrics"]
    assert set(WANT) <= set(got)
    assert got["sa_walk_blocks_per_kread.sampled"]["value"] > 0
    assert got["sa_walk_slots_per_kread.sampled"]["value"] >= \
        128 * got["sa_walk_blocks_per_kread.sampled"]["value"]
    assert got["sa_walk_ms_per_kread.sampled"]["value"] > 0
    assert SPAN_METRICS <= set(got)
    assert not TRACE_METRICS & set(got)
    assert got["se_reads_per_s.sampled"]["value"] > 0
