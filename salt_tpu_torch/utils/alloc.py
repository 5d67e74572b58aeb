"""glibc allocator tuning for large-array workloads.

numpy hands every >128KB buffer straight to mmap by default, so each
temporary in a genome-scale pipeline is a fresh anonymous mapping whose
pages must be zero-faulted in — on this class of VM that throttles
streaming array code to ~400MB/s (measured: a single 180MB shift+add
temporary cost 7.4s faulted vs 0.05s in-place).  Raising the mmap/trim
thresholds keeps big blocks on the brk heap where glibc reuses them
without re-faulting.  Equivalent to MALLOC_MMAP_THRESHOLD_ /
MALLOC_TRIM_THRESHOLD_, but callable after interpreter start.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import sys

_M_TRIM_THRESHOLD = -1
_M_MMAP_THRESHOLD = -3

_done = False


def tune_allocator(threshold: int = 1 << 30) -> bool:
    """Raise glibc's mmap + trim thresholds.  Idempotent; returns True
    when the tuning took effect (False on non-glibc platforms)."""
    global _done
    if _done:
        return True
    if not sys.platform.startswith("linux"):
        return False
    try:
        libc = ctypes.CDLL(ctypes.util.find_library("c") or "libc.so.6",
                           use_errno=True)
        ok1 = libc.mallopt(_M_MMAP_THRESHOLD, threshold)
        ok2 = libc.mallopt(_M_TRIM_THRESHOLD, threshold)
        _done = bool(ok1 and ok2)
    except (OSError, AttributeError):
        return False
    return _done
