"""The readers of host finalize's native LV CIGAR call (span host.cigar,
counter lv.cigar_rows): their arithmetic, their cells, and None where the
program has no such span or counter, as before the call had them."""

import sys
import types

import pytest

from benchmark import run
from benchmark.tests.helpers import bench
from test_bench_metrics import RUN

CELLS = {"chr21_snp144.se_wgsim"}
STAGES = dict(RUN["stages"], **{"host.emit": 3.0, "host.cigar": 0.3})
COUNTERS = {"host.sync": 9_000, "lv.cigar_rows": 30_000}
WANT = {"cigar_ms_per_kread.se": 1.5, "cigar_rows_per_kread.se": 150.0}


def _registry(monkeypatch, counters=None):
    mod = types.ModuleType("salt_tpu_torch.utils.metrics")
    if counters is not None:
        mod.counters = lambda: dict(counters)
    monkeypatch.setitem(sys.modules, "salt_tpu_torch.utils.metrics", mod)


@pytest.mark.parametrize("name", sorted(WANT))
def test_cigar_metric_arithmetic(name, monkeypatch):
    _registry(monkeypatch, COUNTERS)
    assert run.load_reader(name)(dict(RUN, stages=STAGES)) == \
        pytest.approx(WANT[name])


def test_cigar_rows_of_the_run_come_before_the_registry(monkeypatch):
    _registry(monkeypatch, {k: 0 for k in COUNTERS})
    assert run.load_reader("cigar_rows_per_kread.se")(
        dict(RUN, counters=COUNTERS)) == pytest.approx(150.0)


@pytest.mark.parametrize("name", sorted(WANT))
def test_cigar_metric_without_its_span_or_counter_is_left_out(name,
                                                              monkeypatch):
    """The parent program: host.emit without host.cigar, host.sync
    without lv.cigar_rows."""
    parent = dict(RUN, stages=dict(RUN["stages"], **{"host.emit": 3.0}))
    _registry(monkeypatch, {"host.sync": 9_000})
    assert run.load_reader(name)(parent) is None
    _registry(monkeypatch, None)
    assert run.load_reader(name)(parent) is None
    monkeypatch.delitem(sys.modules, "salt_tpu_torch.utils.metrics")
    assert run.load_reader(name)(parent) is None


def test_cigar_metrics_belong_to_the_se_cells():
    b = bench()
    for cell in (w["name"] for w in b["workloads"]):
        names = {m["name"] for m in run.cell_metrics(b, cell)[1]}
        assert (set(WANT) <= names) == (cell in CELLS)
        assert not (set(WANT) & names) or cell in CELLS
    assert {m["layer"] for m in b["per_layer"] if m["name"] in WANT} == {
        "host finalize"}
