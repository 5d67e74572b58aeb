"""Binding of the CUDA LV distance kernel (csrc/lv.cu).

The kernel is compiled at first use with nvcc for sm_90a into a shared
library with a plain C interface under salt_tpu_torch/_build/, and
loaded with ctypes.  Nothing is built or loaded when this module is
imported.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

from salt_tpu.constants import LV_MAX_K

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "lv.cu"
BUILD_DIR = _PKG / "_build"
# the longest read salt_tpu aligns (its locate packs seed offsets in 11
# bits); the kernel's shared-memory sizing is checked up to it
MAX_READ_LEN = 2047


class LVKernel:
    """The LV kernel's library, built at first use, and its launch count
    (one per launch of the kernel, and nowhere else)."""

    def __init__(self):
        self.source = SOURCE
        self.library = BUILD_DIR / "libsalt_lv.so"
        self.launches = 0
        self.build_log = ""
        self._lib = None
        self._lock = threading.Lock()

    def build(self) -> ctypes.CDLL:
        """Compile (if the library is missing or older than its source)
        and load.  Raises if nvcc is missing or the build fails."""
        with self._lock:
            if self._lib is not None:
                return self._lib
            so = self.library
            stale = (not so.exists()
                     or so.stat().st_mtime < self.source.stat().st_mtime)
            if stale:
                nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
                if not os.path.exists(nvcc):
                    raise RuntimeError("nvcc not found: the CUDA toolkit is "
                                       "needed to build " + str(self.source))
                BUILD_DIR.mkdir(exist_ok=True)
                tmp = so.with_suffix(f".{os.getpid()}.tmp")
                cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                       "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                       "-Xptxas", "-v", "-o", str(tmp), str(self.source)]
                res = subprocess.run(cmd, capture_output=True, text=True)
                if res.returncode != 0:
                    raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                                       f"{res.stderr}")
                self.build_log = res.stderr
                os.replace(tmp, so)
            lib = ctypes.CDLL(str(so))
            lib.salt_lv_distance.argtypes = [
                ctypes.c_void_p, ctypes.c_ulonglong, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ]
            lib.salt_lv_distance.restype = ctypes.c_int
            lib.salt_cuda_error_string.argtypes = [ctypes.c_int]
            lib.salt_cuda_error_string.restype = ctypes.c_char_p
            self._lib = lib
            return lib


LV = LVKernel()


def _check(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def lv_distance_cuda(
    mixref_words: torch.Tensor,  # int32 [n_words], uint32 bits, 8 nibbles each
    pos: torch.Tensor,           # int64 (N,) uint32 positions
    active: torch.Tensor,        # bool (N,)
    seq: torch.Tensor,           # uint8 (N, L) base codes
    k: int,
    window_pad: int,
) -> torch.Tensor:
    """The kernel's launch: int32 (N,) distances, 255 when inactive or
    above k.  Raises on tensors the kernel does not take and on a
    refused launch."""
    dev = mixref_words.device
    if dev.type != "cuda":
        raise ValueError("lv_distance_cuda takes CUDA tensors")
    if seq.dim() != 2:
        raise ValueError(f"seq must be (N, L), got {tuple(seq.shape)}")
    N, L = seq.shape
    if not 1 <= L <= MAX_READ_LEN:
        raise ValueError(f"read length {L} outside 1..{MAX_READ_LEN}")
    if k < 0 or window_pad < 0:
        raise ValueError(f"k={k} and window_pad={window_pad} must be >= 0")
    if mixref_words.dim() != 1 or mixref_words.shape[0] == 0:
        raise ValueError("mixref_words must be a non-empty vector")
    _check(mixref_words, "mixref_words", torch.int32, tuple(mixref_words.shape), dev)
    _check(pos, "pos", torch.int64, (N,), dev)
    _check(active, "active", torch.bool, (N,), dev)
    _check(seq, "seq", torch.uint8, (N, L), dev)
    k = min(LV_MAX_K - 1, k)
    lib = LV.build()
    out = torch.empty(N, dtype=torch.int32, device=dev)
    if N == 0:
        return out
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.salt_lv_distance(
            mixref_words.data_ptr(), mixref_words.shape[0], pos.data_ptr(),
            active.data_ptr(), seq.data_ptr(), N, L, L + window_pad, k,
            out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError("LV kernel launch failed: "
                           + lib.salt_cuda_error_string(rc).decode())
    LV.launches += 1
    return out
