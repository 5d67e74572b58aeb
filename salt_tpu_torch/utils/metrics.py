"""Observability: spans, counters and progress logging.

The reference's only instrumentation is unstructured stderr logging
with wall-clock deltas at phase boundaries (Align_src/alnse.c:1360-1365,
1444-1447; Index_src/index1.c:84,110).  This module supplies:

* ``stage("name")``   — a span: a context manager accumulating wall time
  and calls into a process-wide registry (``metrics()``), with the time
  its child spans cover (``spans()``: self time and parent).  While a
  torch.profiler session is active it also opens a profiler range of
  that name, so the span sits in the profiler's trace on the kernels'
  clock; otherwise it costs two clock reads and a few dict updates.
  Spans are opened per batch, never per read.  The range is a function
  range (a ``cpu_op`` event), not a user annotation, so kineto projects
  nothing of it onto the device: a trace's device events stay the
  kernels, copies and memsets, and its user annotations the caller's.
* ``count("name", n)`` — a counter in the same registry (``counters()``);
  ``to_host(t)`` is every deliberate device-to-host read-back of the
  aligners, counted as ``host.sync``.
* ``progress(...)``   — reference-style stderr progress lines, gated by
  SALT_TPU_VERBOSE (default on, like the reference).
* ``device_trace("label", device)`` — a torch.profiler region written as a
  Chrome trace when SALT_TPU_TRACE=<dir> is set.

``metrics_reset()`` clears spans and counters; ``metrics_report()``
prints both.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import sys
import threading
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch
from torch._C._profiler import _RecordFunctionFast as profiler_range

_STAGES: Dict[str, Tuple[float, int]] = defaultdict(lambda: (0.0, 0))
_SELF: Dict[str, float] = defaultdict(float)
_PARENT: Dict[str, Optional[str]] = {}
_COUNTS: Dict[str, int] = defaultdict(int)
_NAMES: set = set()          # every span opened in the process
_OPEN = threading.local()    # .stack: [[name, seconds of closed children]]
_T0 = time.time()
_TRACE_NO = itertools.count()
_profiling = torch._C._autograd._profiler_enabled


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
    """Accumulate wall time for a named pipeline stage (a span)."""
    stack = getattr(_OPEN, "stack", None)
    if stack is None:
        stack = _OPEN.stack = []
    _PARENT[name] = stack[-1][0] if stack else None
    _NAMES.add(name)
    frame = [name, 0.0]
    stack.append(frame)
    ctx = profiler_range(name) if _profiling() else None
    if ctx is not None:
        ctx.__enter__()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        if ctx is not None:
            ctx.__exit__(None, None, None)
        stack.pop()
        if stack:
            stack[-1][1] += dt
        tot, cnt = _STAGES[name]
        _STAGES[name] = (tot + dt, cnt + 1)
        _SELF[name] += dt - frame[1]


def metrics() -> Dict[str, Tuple[float, int]]:
    """{span: (inclusive seconds, calls)}."""
    return dict(_STAGES)


def spans() -> Dict[str, Tuple[float, float, int, Optional[str]]]:
    """{span: (inclusive seconds, self seconds, calls, parent span)}: self
    time is the inclusive time less what the span's child spans cover;
    the parent is the span that was open around its last opening."""
    return {k: (tot, _SELF[k], cnt, _PARENT.get(k))
            for k, (tot, cnt) in _STAGES.items()}


def span_names() -> List[str]:
    """Every span name opened in this process, reset or not."""
    return sorted(_NAMES)


def count(name: str, n: int = 1) -> None:
    """Add n to a counter."""
    _COUNTS[name] += int(n)


def counters() -> Dict[str, int]:
    return dict(_COUNTS)


def to_host(t: torch.Tensor):
    """`t` as a NumPy array on the host (0-d for a scalar tensor): one
    deliberate device-to-host read-back, counted as host.sync.  On a CUDA
    tensor it waits for the work that makes `t`."""
    _COUNTS["host.sync"] += 1
    return t.cpu().numpy()


def metrics_reset() -> None:
    _STAGES.clear()
    _SELF.clear()
    _PARENT.clear()
    _COUNTS.clear()


def metrics_report(out=None) -> str:
    """Human-readable span and counter tables; also written to stderr
    when verbose and ``out`` is None."""
    rows = sorted(_STAGES.items(), key=lambda kv: -kv[1][0])
    width = max((len(k) for k in list(_STAGES) + list(_COUNTS)), default=5)
    lines = [f"{'stage':<{width}}  {'total_s':>9}  {'calls':>7}  {'avg_ms':>9}"
             f"  {'self_s':>9}"]
    for name, (tot, cnt) in rows:
        lines.append(
            f"{name:<{width}}  {tot:9.3f}  {cnt:7d}  {1000 * tot / max(cnt, 1):9.2f}"
            f"  {_SELF[name]:9.3f}"
        )
    if _COUNTS:
        lines.append(f"{'counter':<{width}}  {'count':>9}")
        lines.extend(f"{name:<{width}}  {n:9d}"
                     for name, n in sorted(_COUNTS.items()))
    report = "\n".join(lines)
    if out is not None:
        out.write(report + "\n")
    elif _verbose() and (rows or _COUNTS):
        sys.stderr.write(report + "\n")
    return report


@contextlib.contextmanager
def device_trace(label: str = "salt_tpu", device=None):
    """torch.profiler region when SALT_TPU_TRACE=<dir> is set: host
    activity always, CUDA activity when `device` is a CUDA device, with
    the spans opened inside as profiler ranges.  Each region is exported
    as a Chrome trace, <dir>/<label>/trace_<pid>_<n>.json.  A no-op
    otherwise, and inside a profiler session someone else opened."""
    trace_dir = os.environ.get("SALT_TPU_TRACE")
    if not trace_dir or _profiling():
        yield
        return
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
