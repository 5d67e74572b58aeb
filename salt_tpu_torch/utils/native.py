"""Loader for the port's native host library (csrc/sais.cpp,
csrc/ssw_native.cpp and csrc/lv_host.cpp).

The library holds the SA-IS suffix sorter (index build), the
bit-faithful scalar SSW (PE rescue and -X 1 winner verification) and the
batched LV CIGAR and MD/NM/XV tags of SE finalize.  It is
built with g++ at first use into salt_tpu_torch/_build/.  A failed build
raises: there is no quiet drop to the pure-numpy SSW, which is about a
thousand times slower per call.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
BUILD_DIR = _PKG / "_build"
SOURCES = tuple(_PKG / "csrc" / f
                for f in ("sais.cpp", "ssw_native.cpp", "lv_host.cpp"))
LIBRARY = BUILD_DIR / "libsalt_host.so"

_lib = None
_lock = threading.Lock()


def build_library(cmd_prefix, sources, library: Path) -> str:
    """Compile `sources` into the shared library `library` unless it is
    newer than all of them; returns the compiler's stderr ("" when
    nothing was built).  The library appears under its name only once
    complete, so concurrent processes never load a partial file."""
    if library.exists() and all(
            library.stat().st_mtime >= s.stat().st_mtime for s in sources):
        return ""
    library.parent.mkdir(exist_ok=True)
    tmp = library.with_suffix(f".{os.getpid()}.tmp")
    cmd = [*cmd_prefix, "-o", str(tmp), *map(str, sources)]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    except FileNotFoundError as e:
        raise RuntimeError(f"{cmd[0]} not found: it is needed to build "
                           f"{library.name}") from e
    if res.returncode != 0:
        raise RuntimeError(f"{cmd[0]} failed ({res.returncode}) building "
                           f"{library.name}:\n{res.stderr}")
    os.replace(tmp, library)
    return res.stderr


def load_native() -> ctypes.CDLL:
    """The ctypes.CDLL of the host library, built with g++ if missing or
    older than its sources.  Raises when the build or the load fails."""
    global _lib
    with _lock:
        if _lib is None:
            build_library(["g++", "-O3", "-march=native", "-shared", "-fPIC"],
                          SOURCES, LIBRARY)
            _lib = ctypes.CDLL(str(LIBRARY))
        return _lib
