"""Observability: per-stage timing counters and progress logging.

The reference's only instrumentation is unstructured stderr logging
with wall-clock deltas at phase boundaries (Align_src/alnse.c:1360-1365,
1444-1447; Index_src/index1.c:84,110).  This module supplies:

* ``stage("name")``   — context manager accumulating wall time + call
  counts into a process-wide registry (``metrics_report()`` to dump).
* ``progress(...)``   — reference-style stderr progress lines, gated by
  SALT_TPU_VERBOSE (default on, like the reference).
* ``device_trace("label", device)`` — a torch.profiler region written as a
  Chrome trace when SALT_TPU_TRACE=<dir> is set.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import sys
import time
from collections import defaultdict
from typing import Dict, Tuple

_STAGES: Dict[str, Tuple[float, int]] = defaultdict(lambda: (0.0, 0))
_T0 = time.time()
_TRACE_NO = itertools.count()


def _verbose() -> bool:
    return os.environ.get("SALT_TPU_VERBOSE", "1") != "0"


def log(msg: str, tag: str = "salt-tpu") -> None:
    if _verbose():
        sys.stderr.write(f"[{tag}] {msg}\n")
        sys.stderr.flush()


def progress(n_done: int, what: str = "reads") -> None:
    """Per-batch progress, the analogue of alnse.c:1444."""
    log(f"{n_done} {what} have been aligned! ({time.time() - _T0:.1f}s)")


@contextlib.contextmanager
def stage(name: str):
    """Accumulate wall time for a named pipeline stage."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        tot, cnt = _STAGES[name]
        _STAGES[name] = (tot + dt, cnt + 1)


def metrics() -> Dict[str, Tuple[float, int]]:
    return dict(_STAGES)


def metrics_reset() -> None:
    _STAGES.clear()


def metrics_report(out=None) -> str:
    """Human-readable per-stage table; also written to stderr when
    verbose and ``out`` is None."""
    rows = sorted(_STAGES.items(), key=lambda kv: -kv[1][0])
    width = max((len(k) for k, _ in rows), default=5)
    lines = [f"{'stage':<{width}}  {'total_s':>9}  {'calls':>7}  {'avg_ms':>9}"]
    for name, (tot, cnt) in rows:
        lines.append(
            f"{name:<{width}}  {tot:9.3f}  {cnt:7d}  {1000 * tot / max(cnt, 1):9.2f}"
        )
    report = "\n".join(lines)
    if out is not None:
        out.write(report + "\n")
    elif _verbose() and rows:
        sys.stderr.write(report + "\n")
    return report


@contextlib.contextmanager
def device_trace(label: str = "salt_tpu", device=None):
    """torch.profiler region when SALT_TPU_TRACE=<dir> is set: host
    activity always, CUDA activity when `device` is a CUDA device.  Each
    region is exported as a Chrome trace,
    <dir>/<label>/trace_<pid>_<n>.json.  A no-op otherwise."""
    trace_dir = os.environ.get("SALT_TPU_TRACE")
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device is not None and torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    out_dir = os.path.join(trace_dir, label)
    os.makedirs(out_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
        if len(activities) > 1:
            torch.cuda.synchronize()   # the region's kernels end inside it
    prof.export_chrome_trace(os.path.join(
        out_dir, f"trace_{os.getpid()}_{next(_TRACE_NO)}.json"))
