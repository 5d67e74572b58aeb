"""The reader of the share of the sampled-mode walk that the CUDA kernel K4
walks (sa_walk_k4_share.sampled, counters k4.lanes over sa_walk.slots):
its arithmetic, its cell, and None where the program has no K4 counter,
as before the kernel, or walked nothing."""

import sys
import types

import pytest

from benchmark import run
from benchmark.tests.helpers import bench
from test_bench_metrics import RUN

NAME = "sa_walk_k4_share.sampled"
CELL = "chr21_snp144_sampled.se_wgsim"


def _registry(monkeypatch, counters=None):
    mod = types.ModuleType("salt_tpu_torch.utils.metrics")
    if counters is not None:
        mod.counters = lambda: dict(counters)
    monkeypatch.setitem(sys.modules, "salt_tpu_torch.utils.metrics", mod)


@pytest.mark.parametrize("lanes, slots, want", [
    (450 * 8_192 * 128, 450 * 8_192 * 128, 100.0),
    (300, 1_200, 25.0),
    (0, 1_200, 0.0),
])
def test_k4_share_arithmetic(lanes, slots, want, monkeypatch):
    _registry(monkeypatch, {"host.sync": 9_000, "k4.lanes": lanes,
                            "sa_walk.slots": slots})
    assert run.load_reader(NAME)(RUN) == pytest.approx(want)


def test_k4_share_counters_of_the_run_come_before_the_registry(monkeypatch):
    _registry(monkeypatch, {"k4.lanes": 0, "sa_walk.slots": 1})
    assert run.load_reader(NAME)(dict(
        RUN, counters={"k4.lanes": 512, "sa_walk.slots": 1_024})) == \
        pytest.approx(50.0)


@pytest.mark.parametrize("counters", [
    {"host.sync": 9_000},                          # full mode
    {"host.sync": 9_000, "sa_walk.slots": 1_024},  # the parent program
    {"k4.lanes": 0, "sa_walk.slots": 0},           # nothing walked
    None,                                          # no registry function
])
def test_k4_share_without_its_counters_is_left_out(counters, monkeypatch):
    _registry(monkeypatch, counters)
    assert run.load_reader(NAME)(RUN) is None
    monkeypatch.delitem(sys.modules, "salt_tpu_torch.utils.metrics")
    assert run.load_reader(NAME)(RUN) is None


def test_k4_share_belongs_to_the_sampled_cell_alone():
    b = bench()
    for cell in (w["name"] for w in b["workloads"]):
        names = {m["name"] for m in run.cell_metrics(b, cell)[1]}
        assert (NAME in names) == (cell == CELL)
    (m,) = [m for m in b["per_layer"] if m["name"] == NAME]
    assert (m["unit"], m["layer"], m["moves"], m["source"]) == (
        "%", "device ungapped step", "device_memory_peak_gb",
        "program_counter")
