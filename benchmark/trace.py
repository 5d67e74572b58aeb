"""Reduction of a torch.profiler trace to the device's busy time, its
operations and its idle gaps.

The profiled stretch is the host span named `window` (a record_function
the harness puts around the profiled call, ended by a device
synchronize), or, should the profiler drop it, the stretch the other
events cover.  Busy time is the union of the intervals of every kernel,
copy and memset on the device inside it; an idle gap is a stretch of it
between them, named by the innermost host span (a record_function the
harness puts around each layer's call) that covers the gap's middle.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict

import numpy as np

WINDOW = "window"


def _interval(ev):
    """(start, end) in ns of a kineto event."""
    if hasattr(ev, "start_ns"):
        s = ev.start_ns()
        return s, s + ev.duration_ns()
    s = int(ev.start_us() * 1000)
    return s, s + int(ev.duration_us() * 1000)


def reduce_trace(prof, span_names, top: int = 10) -> Dict:
    """busy_s, window_s, device_ops (kernels, copies and memsets in the
    stretch), and the breakdown lists.  `span_names` are the names of
    the harness's host spans; a device event of such a name is the
    span's own projection onto the device, no operation."""
    names_set = set(span_names) | {WINDOW}
    ops, names, spans = [], [], []
    for ev in prof.profiler.kineto_results.events():
        on_device = str(ev.device_type()).endswith("CUDA")
        if on_device and ev.name() not in names_set:
            ops.append(_interval(ev))
            names.append(ev.name())
        elif not on_device and ev.name() in names_set:
            spans.append((*_interval(ev), ev.name()))
    win = [s for s in spans if s[2] == WINDOW]
    if win:
        t0, t1 = win[0][0], win[0][1]
    else:   # the span was dropped: the stretch its layers' spans cover
        t0 = min(s[0] for s in spans + [(e[0], e[1], "") for e in ops])
        t1 = max(s[1] for s in spans + [(e[0], e[1], "") for e in ops])
    se = np.array(ops, dtype=np.int64).reshape(-1, 2)
    keep = (se[:, 1] > t0) & (se[:, 0] < t1)
    se = np.clip(se[keep], t0, t1)
    by_name: Dict[str, float] = defaultdict(float)
    for nm, (s, e) in zip((n for n, k in zip(names, keep) if k), se.tolist()):
        by_name[nm] += (e - s) / 1e9
    se = se[np.argsort(se[:, 0], kind="stable")]
    # union of intervals: op i opens a gap when it starts after every
    # earlier op (and the window's start) has passed
    ends = np.maximum.accumulate(se[:, 1]) if len(se) else np.zeros(0, np.int64)
    prev_end = np.concatenate([[t0], ends[:-1]]).astype(np.int64)[:len(se)]
    opens = se[:, 0] > prev_end
    gap_s = np.concatenate([prev_end[opens], [ends[-1] if len(se) else t0]])
    gap_e = np.concatenate([se[opens, 0], [t1]])
    idle_ns = np.maximum(gap_e - gap_s, 0)
    busy = (t1 - t0) - int(idle_ns.sum())
    mid = (gap_s + gap_e) // 2
    label = np.full(len(mid), -1)
    inner = sorted((s for s in spans if s[2] != WINDOW), key=lambda s: s[0])
    for i, (s, e, _n) in enumerate(inner):
        label[(mid >= s) & (mid <= e)] = i
    idle: Dict[str, float] = defaultdict(float)
    for lab, ns in zip(label.tolist(), idle_ns.tolist()):
        idle[inner[lab][2] if lab >= 0 else "outside the layers' spans"] += ns / 1e9
    rank = lambda d: sorted(([k, v] for k, v in d.items()),
                            key=lambda kv: -kv[1])[:top]
    return {
        "busy_s": busy / 1e9,
        "window_s": (t1 - t0) / 1e9,
        "device_ops": int(len(se)),
        "breakdown": {"device_ops": rank(by_name), "idle_gaps": rank(idle)},
    }
