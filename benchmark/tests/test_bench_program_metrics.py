"""The readers of the program's own spans and counters: their arithmetic,
None where the program has no such span or counter, and that the
program's spans, function ranges in the profiler's trace, leave the
trace's numbers as the harness's spans alone give them."""

import sys
import types

import pytest

from benchmark import run
from benchmark.trace import reduce_trace
from test_bench_metrics import RUN, _Ev, _Prof

STAGES = dict(RUN["stages"], **{"device.seed": 0.4, "device.locate": 0.2,
                                "device.verify": 0.3, "host.emit": 3.0})
COUNTERS = {"host.sync": 9_000, "rows.overflow": 1_000,
            "pe.rescue_windows": 30_000}

WANT = {
    "seed_ms_per_kread.se": 2.0,
    "locate_ms_per_kread.se": 1.0,
    "verify_ms_per_kread.se": 1.5,
    "emit_ms_per_kread.se": 15.0,
    "syncs_per_kread.se": 45.0,
    "overflow_rows_per_kread.se": 5.0,
    "syncs_per_kpair.pe": 45.0,
    "rescue_windows_per_kpair.pe": 150.0,
}
COUNTED = ["syncs_per_kread.se", "overflow_rows_per_kread.se",
           "syncs_per_kpair.pe", "rescue_windows_per_kpair.pe"]


def _registry(monkeypatch, counters=None):
    """The program's utils/metrics as sys.modules holds it: with
    `counters()` giving `counters`, or, where None, a module without
    counters, as the parent program's is."""
    mod = types.ModuleType("salt_tpu_torch.utils.metrics")
    if counters is not None:
        mod.counters = lambda: dict(counters)
    monkeypatch.setitem(sys.modules, "salt_tpu_torch.utils.metrics", mod)


@pytest.mark.parametrize("name", sorted(WANT))
def test_program_metric_arithmetic(name, monkeypatch):
    _registry(monkeypatch, COUNTERS)
    assert run.load_reader(name)(dict(RUN, stages=STAGES)) == \
        pytest.approx(WANT[name])


@pytest.mark.parametrize("name", COUNTED)
def test_counters_of_the_run_come_before_the_registry(name, monkeypatch):
    _registry(monkeypatch, {k: 0 for k in COUNTERS})
    got = run.load_reader(name)(dict(RUN, counters=COUNTERS))
    assert got == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", sorted(WANT))
def test_program_metric_without_its_span_or_counter_is_left_out(
        name, monkeypatch):
    """What a program without the spans and counters gives: no counters()
    in its registry (or no registry), and only the stages it had."""
    parent = dict(RUN, stages=RUN["stages"])
    _registry(monkeypatch, None)
    assert run.load_reader(name)(parent) is None
    monkeypatch.delitem(sys.modules, "salt_tpu_torch.utils.metrics")
    assert run.load_reader(name)(parent) is None
    # counters kept, but not this one
    _registry(monkeypatch, {"k2.cells": 5})
    assert run.load_reader(name)(parent) is None


def test_program_spans_leave_the_trace_as_the_harness_spans_give_it():
    """The program's spans reach the trace as host cpu_op ranges, some of
    them under a harness span's name: idle gaps, busy time and the
    operations come out bit for bit as without them."""
    harness = [
        _Ev("window", False, "user_annotation", 0, 10_000),
        _Ev("device.dispatch", False, "user_annotation", 0, 5_000),
        _Ev("device.dispatch", True, "gpu_user_annotation", 1_000, 3_000),
        _Ev("host.finalize", False, "user_annotation", 6_000, 9_000),
        _Ev("k1", True, "kernel", 1_000, 2_000),
        _Ev("k2", True, "kernel", 2_500, 3_000),
        _Ev("memcpy", True, "gpu_memcpy", 7_000, 8_000),
    ]
    program = [
        _Ev("device.dispatch", False, "cpu_op", 100, 4_900),
        _Ev("device.seed", False, "cpu_op", 200, 2_200),
        _Ev("device.verify", False, "cpu_op", 2_300, 4_800),
        _Ev("host.finalize", False, "cpu_op", 6_100, 8_900),
        _Ev("host.emit", False, "cpu_op", 7_500, 8_800),
    ]
    names = ["device.dispatch", "host.finalize"]
    assert reduce_trace(_Prof(harness + program), names) == \
        reduce_trace(_Prof(harness), names)
