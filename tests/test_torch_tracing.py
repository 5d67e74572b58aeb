"""The port's spans and counters (utils/metrics): nesting, self time and
parents, their profiler ranges under an active torch.profiler (function
ranges, not user annotations, so nothing of them reaches a trace's device
events) and none without one, and the counts the aligners keep where the
work happens (read-backs, overflow re-runs, gapped rows, K1 rows, rescue
windows).  CPU tensors.  Tolerance: exact."""

from types import SimpleNamespace

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

from salt_tpu_torch.pipeline.engine import SEAligner, SEOptions
from salt_tpu_torch.pipeline.pe_engine import PEAligner, PEOptions
from salt_tpu_torch.pipeline.se import unpack_result
from salt_tpu_torch.utils import metrics as M

from torch_fixtures import (planted_pairs, port_index, repeat_fixture,
                            tiny_fixture, tiny_genome)

# small caps force the overflow, full-cap and gapped-overflow re-runs
REPEAT_OPTS = dict(l_overlap=1, max_locate=16, verify_width=8,
                   print_nm_md=True, print_xa_cigar=True, batch_size=64,
                   gap_batch=16)


@pytest.fixture
def clock(monkeypatch):
    """perf_counter of utils/metrics read from a list of times."""
    times = []
    monkeypatch.setattr(M, "time", SimpleNamespace(
        perf_counter=lambda: times.pop(0), time=M.time.time))
    M.metrics_reset()
    yield times
    M.metrics_reset()


def _nest():
    with M.stage("outer"):
        with M.stage("inner"):
            pass
        with M.stage("inner"):
            with M.stage("leaf"):
                pass


def test_nested_spans_give_parents_and_self_time(clock):
    # outer 0-10; inner 1-3 and 4-8, leaf 5-6 inside the second
    clock.extend([0.0, 1.0, 3.0, 4.0, 5.0, 6.0, 8.0, 10.0])
    _nest()
    sp = M.spans()
    assert sp["outer"] == (10.0, 10.0 - 2.0 - 4.0, 1, None)
    assert sp["inner"] == (6.0, 6.0 - 1.0, 2, "outer")
    assert sp["leaf"] == (1.0, 1.0, 1, "inner")
    assert {"outer", "inner", "leaf"} <= set(M.span_names())


def test_metrics_keeps_inclusive_totals_and_calls(clock):
    clock.extend([0.0, 1.0, 3.0, 4.0, 5.0, 6.0, 8.0, 10.0])
    _nest()
    assert M.metrics() == {"outer": (10.0, 1), "inner": (6.0, 2),
                           "leaf": (1.0, 1)}


@pytest.mark.parametrize("profiling", [False, True])
def test_spans_are_user_annotations_only_under_a_profiler(monkeypatch,
                                                          profiling):
    """A span is a profiler range only under a profiler: a function range
    (cpu_op), which kineto does not project onto the device as it does a
    user annotation."""
    opened = []
    real = M.profiler_range

    def spy(name):
        opened.append(name)
        return real(name)

    monkeypatch.setattr(M, "profiler_range", spy)
    if not profiling:
        _nest()
        assert opened == []
        return
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _nest()
    assert opened == ["outer", "inner", "inner", "leaf"]
    ev = {}
    for e in prof.profiler.kineto_results.events():
        if e.name() in ("outer", "inner", "leaf"):
            assert not e.is_user_annotation(), e.name()
            ev.setdefault(e.name(), []).append(
                (e.start_ns(), e.start_ns() + e.duration_ns()))
    assert sorted(ev) == ["inner", "leaf", "outer"]
    (o0, o1), = ev["outer"]
    (l0, l1), = ev["leaf"]
    assert all(o0 <= s and e <= o1 for s, e in ev["inner"])
    assert any(s <= l0 and l1 <= e for s, e in ev["inner"])


def test_metrics_reset_clears_counters_and_spans():
    M.count("x.test", 3)
    M.count("x.test")
    with M.stage("x.span"):
        pass
    assert M.counters()["x.test"] == 4
    assert "counter" in M.metrics_report(out=_Sink())
    M.metrics_reset()
    assert M.counters() == {} and M.metrics() == {} and M.spans() == {}
    assert "x.span" in M.span_names()


class _Sink:
    def write(self, _text):
        pass


@pytest.fixture(scope="module")
def tiny():
    idx, records = tiny_fixture()
    return SEAligner(port_index(idx), SEOptions(
        l_overlap=1, max_locate=500, print_nm_md=True, print_xa_cigar=True,
        batch_size=64, gap_batch=16), device="cpu"), records


def test_se_sam_is_the_same_with_a_profiler_on(tiny):
    al, records = tiny
    plain = al.align_records(records)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = al.align_records(records)
    assert traced == plain
    names = {e.name() for e in prof.profiler.kineto_results.events()
             if not e.is_user_annotation()}
    assert {"device.dispatch", "device.seed", "device.locate",
            "device.verify", "device.complete", "host.finalize",
            "host.emit"} <= names


def test_host_sync_is_the_same_on_two_runs_of_a_batch(tiny):
    al, records = tiny
    seen = []
    for _ in range(2):
        M.metrics_reset()
        al.align_records(records)
        seen.append(M.counters()["host.sync"])
    assert seen[0] == seen[1] > 0


@pytest.fixture(scope="module")
def repeat(tmp_path_factory):
    idx, records = repeat_fixture(str(tmp_path_factory.mktemp("repeat")))
    return SEAligner(port_index(idx), SEOptions(**REPEAT_OPTS),
                     device="cpu"), records


def test_row_counters_equal_the_rows_sent(repeat):
    """rows.overflow: the overflow flags of each batch's first pass, as
    unpack_result reads them; rows.gapped and k1.rows: the rows handed to
    _gapped, and 2 strands x verify width candidates a row to K1's plain
    version."""
    al, records = repeat
    handles, gapped = [], []
    dispatch, real_gapped = al._dispatch_batch, al._gapped

    def spy_dispatch(codes):
        h = dispatch(codes)
        handles.append(h)
        return h

    def spy_gapped(fwd, rev, out, sel, k, u):
        gapped.append((len(sel), u))
        return real_gapped(fwd, rev, out, sel, k, u)

    al._dispatch_batch, al._gapped = spy_dispatch, spy_gapped
    try:
        M.metrics_reset()
        al.align_records(records)
    finally:
        del al._dispatch_batch, al._gapped
    c = M.counters()
    K = al.opts.k_hits
    overflow = sum(int(unpack_result(h[3].numpy(), K)["n_extra"][:, 1].sum())
                   for h in handles)
    assert c["rows.overflow"] == overflow > 0
    assert c["rows.gapped"] == sum(n for n, _u in gapped) > 0
    assert c["k1.rows"] == sum(2 * n * u for n, u in gapped)


@pytest.fixture(scope="module")
def planted():
    idx, genome, _pos, _stype, rng = tiny_genome()
    r1, r2 = planted_pairs(genome, rng)
    return port_index(idx), r1, r2


def test_rescue_windows_count_the_windows_the_host_runs(planted):
    """pe.rescue_windows: each window of the requests handed to
    _run_rescue that reaches the host SSW (all of them up to the first
    hit, with the device pre-filter off)."""
    tidx, r1, r2 = planted
    al = PEAligner(tidx, PEOptions(l_overlap=1, max_locate=500,
                                   batch_size=64, gap_batch=16,
                                   device_sw="off"), device="cpu")
    handed, ran, inside = [], [], []
    real = al._run_rescue

    def spy_rescue(q0, q1, reqs, scores, snp):
        handed.append(len(reqs))
        inside.append(True)
        try:
            return real(q0, q1, reqs, scores, snp)
        finally:
            inside.pop()

    def spy_sw(fn):
        def run(*a):
            ran.append(bool(inside))
            return fn(*a)
        return run

    al._run_rescue = spy_rescue
    al._sw_snpaware = spy_sw(al._sw_snpaware)
    al._sw_plain = spy_sw(al._sw_plain)
    M.metrics_reset()
    al.align_pairs(r1, r2)
    assert M.counters()["pe.rescue_windows"] == sum(ran) > 0
    assert sum(ran) <= sum(handed)
    assert np.all(ran)
