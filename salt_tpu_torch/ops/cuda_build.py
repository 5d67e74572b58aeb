"""Build-and-load of the port's CUDA kernels.

Each kernel is one `csrc/*.cu` source with a plain C interface.  It is
compiled at first use with nvcc for sm_90a into a shared library under
salt_tpu_torch/_build/ and loaded with ctypes.  Nothing is built or
loaded when a module is imported, and a failed build raises.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import threading
from pathlib import Path

import torch

from ..utils.native import BUILD_DIR, build_library

CSRC = Path(__file__).resolve().parent.parent / "csrc"
# the longest read the aligner takes (its locate packs seed offsets in 11
# bits); the kernels' shared-memory sizing is checked up to it
MAX_READ_LEN = 2047


class CudaKernel:
    """One kernel's library, built at first use, and its launch count
    (the wrapper adds one per launch of the kernel, and nowhere else).

    `functions` maps each exported C function to its ctypes argtypes;
    every function returns the CUDA error code of its launch, and every
    source exports `salt_cuda_error_string`."""

    # one lock a library: two kernels of one source never build it at once
    _locks: dict = {}

    def __init__(self, source_name: str, functions: dict):
        self.source = CSRC / source_name
        self.library = BUILD_DIR / f"libsalt_{self.source.stem}.so"
        self.functions = functions
        self.launches = 0
        self.build_log = ""
        self._lib = None
        self._lock = self._locks.setdefault(self.library, threading.Lock())

    def build(self) -> ctypes.CDLL:
        """Compile (if the library is missing or older than its source)
        and load.  Raises if nvcc is missing or the build fails."""
        with self._lock:
            if self._lib is not None:
                return self._lib
            nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
            if not os.path.exists(nvcc):
                raise RuntimeError("nvcc not found: the CUDA toolkit is "
                                   f"needed to build {self.source}")
            log = build_library(
                [nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                 "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                 "-Xptxas", "-v"], (self.source,), self.library)
            self.build_log = log or self.build_log
            lib = ctypes.CDLL(str(self.library))
            for name, argtypes in self.functions.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.salt_cuda_error_string.argtypes = [ctypes.c_int]
            lib.salt_cuda_error_string.restype = ctypes.c_char_p
            self._lib = lib
            return lib

    def check(self, rc: int) -> None:
        """Raise on a refused launch, else count it."""
        if rc != 0:
            raise RuntimeError(
                f"{self.source.name}: kernel launch failed: "
                + self._lib.salt_cuda_error_string(rc).decode())
        self.launches += 1


def check_tensor(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    """Raise unless `t` is a contiguous tensor of this dtype and shape on
    this device: the kernels read raw pointers."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
