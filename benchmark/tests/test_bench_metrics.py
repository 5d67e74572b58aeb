"""Each metric's arithmetic on a made-up stage table and trace."""

import pytest

from benchmark import run
from benchmark.trace import reduce_trace


class _Ev:
    def __init__(self, name, cuda, act, s, e):
        self._n, self._c, self._a, self._s, self._e = name, cuda, act, s, e

    def name(self):
        return self._n

    def device_type(self):
        return "DeviceType.CUDA" if self._c else "DeviceType.CPU"

    def activity_type(self):
        return self._a

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._e - self._s


class _Prof:
    def __init__(self, events):
        res = type("R", (), {"events": lambda _self: events})()
        self.profiler = type("P", (), {"kineto_results": res})()


def made_up_trace():
    return reduce_trace(_Prof([
        _Ev("window", False, "user_annotation", 0, 10_000),
        _Ev("host.finalize", False, "user_annotation", 6_000, 9_000),
        _Ev("window", True, "gpu_user_annotation", 0, 10_000),
        _Ev("aten::add", False, "cpu_op", 100, 200),
        _Ev("k1", True, "kernel", 1_000, 2_000),
        _Ev("k2", True, "kernel", 1_500, 3_000),
        _Ev("memcpy", True, "gpu_memcpy", 7_000, 8_000),
        _Ev("late", True, "kernel", 9_500, 12_000),
    ]), ["host.finalize"])


def test_trace_reduction():
    t = made_up_trace()
    assert t["window_s"] == pytest.approx(1e-5)
    assert t["busy_s"] == pytest.approx(3.5e-6)      # 1-3, 7-8, 9.5-10 us
    assert t["device_ops"] == 4
    gaps = dict(map(tuple, t["breakdown"]["idle_gaps"]))
    assert gaps["host.finalize"] == pytest.approx(1.5e-6)  # 8-9.5 us
    assert gaps["outside the layers' spans"] == pytest.approx(5e-6)
    ops = dict(map(tuple, t["breakdown"]["device_ops"]))
    assert ops["k2"] == pytest.approx(1.5e-6) and ops["late"] == pytest.approx(5e-7)


RUN = {
    "units": 300_000, "timed_s": 12.0, "setup_s": 7.5, "staged_units": 200_000,
    "staged_s": 8.0, "memory_peak_bytes": 1_331_483_136,
    "stages": {"host.finalize": 4.0, "device.dispatch": 1.0,
               "device.ungapped": 0.5, "device.gapped": 0.2,
               "host.pairing": 1.5, "host.sam": 0.5, "host.rescue": 0.3,
               "host.rescue_prefilter": 0.1},
    "trace": {"busy_s": 0.5, "window_s": 4.0, "device_ops": 50_000,
              "units": 100_000},
}


@pytest.mark.parametrize("name, want", [
    ("se_reads_per_s", 25_000.0),
    ("pe_pairs_per_s.pe", 25_000.0),
    ("se_reads_per_s.sampled", 25_000.0),
    ("device_memory_peak_gb", 1.331483136),
    ("setup_s", 7.5),
    ("finalize_ms_per_kread.se", 20.0),
    ("ungapped_ms_per_kread.se", 7.5),
    ("gapped_ms_per_kread.se", 1.0),
    ("pe_host_ms_per_kpair.pe", 10.0),
    ("rescue_ms_per_kpair.pe", 2.0),
    ("ungapped_ms_per_kpair.pe", 7.5),
    ("launches_per_kread.se", 500.0),
    ("device_idle_share.se", 87.5),
    ("device_idle_share.pe", 87.5),
])
def test_metric_arithmetic(name, want):
    assert run.load_reader(name)(RUN) == pytest.approx(want)


@pytest.mark.parametrize("name", ["gapped_ms_per_kread.se",
                                  "launches_per_kread.se",
                                  "device_idle_share.se",
                                  "se_reads_per_s.sampled",
                                  "pe_pairs_per_s.pe",
                                  "device_memory_peak_gb"])
def test_metric_with_nothing_to_read_is_left_out(name):
    empty = dict(RUN, stages={}, staged_units=0, staged_s=0.0,
                 memory_peak_bytes=0,
                 trace={"busy_s": 0.0, "window_s": 1.0, "device_ops": 0,
                        "units": 10})
    assert run.load_reader(name)(empty) is None


def test_trace_without_its_window_span_uses_the_events():
    t = reduce_trace(_Prof([
        _Ev("host.finalize", False, "user_annotation", 0, 4_000),
        _Ev("k1", True, "kernel", 1_000, 2_000),
    ]), ["host.finalize"])
    assert t["window_s"] == pytest.approx(4e-6)
    assert t["busy_s"] == pytest.approx(1e-6)
