"""Binding of the CUDA LV distance kernel (csrc/lv.cu), built at first
use and loaded with ctypes (ops/cuda_build.py).  Nothing is built or
loaded when this module is imported.
"""

from __future__ import annotations

import ctypes

import torch

from ..constants import LV_MAX_K
from ..utils.metrics import count
from .cuda_build import MAX_READ_LEN, CudaKernel, check_tensor

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = [_P, ctypes.c_ulonglong, _P, _P, _P, _I, _I, _I, _I, _P, _P]
LV = CudaKernel("lv.cu", {"salt_lv_distance": _ARGS})
# the byte form of the same source and library, with its own launch count
LV_BYTES = CudaKernel("lv.cu", {"salt_lv_distance_bytes": _ARGS})


def _launch(kern: CudaKernel, entry: str, ref: torch.Tensor, ref_dtype,
            pos: torch.Tensor, active: torch.Tensor, seq: torch.Tensor,
            k: int, window_pad: int) -> torch.Tensor:
    dev = ref.device
    if dev.type != "cuda":
        raise ValueError(f"{entry} takes CUDA tensors")
    if seq.dim() != 2:
        raise ValueError(f"seq must be (N, L), got {tuple(seq.shape)}")
    N, L = seq.shape
    if not 1 <= L <= MAX_READ_LEN:
        raise ValueError(f"read length {L} outside 1..{MAX_READ_LEN}")
    if k < 0 or window_pad < 0:
        raise ValueError(f"k={k} and window_pad={window_pad} must be >= 0")
    if ref.dim() != 1 or ref.shape[0] == 0:
        raise ValueError("the reference must be a non-empty vector")
    check_tensor(ref, "reference", ref_dtype, tuple(ref.shape), dev)
    check_tensor(pos, "pos", torch.int64, (N,), dev)
    check_tensor(active, "active", torch.bool, (N,), dev)
    check_tensor(seq, "seq", torch.uint8, (N, L), dev)
    k = min(LV_MAX_K - 1, k)
    lib = kern.build()
    out = torch.empty(N, dtype=torch.int32, device=dev)
    if N == 0:
        return out
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(lib, entry)(
            ref.data_ptr(), ref.shape[0], pos.data_ptr(), active.data_ptr(),
            seq.data_ptr(), N, L, L + window_pad, k, out.data_ptr(), stream)
    kern.check(rc)
    count("k1.rows", N)
    return out


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
    return _launch(LV, "salt_lv_distance", mixref_words, torch.int32, pos,
                   active, seq, k, window_pad)


def lv_distance_bytes_cuda(
    ref_bytes: torch.Tensor,     # uint8 [n], one match code a position
    pos: torch.Tensor,           # int64 (N,) uint32 positions
    active: torch.Tensor,        # bool (N,)
    pat: torch.Tensor,           # uint8 (N, L) match codes, used as they are
    k: int,
    window_pad: int,
) -> torch.Tensor:
    """The launch of the kernel's byte form (a byte reference and
    precoded patterns, as polish scores its hits): int32 (N,) distances,
    255 when inactive or above k.  Raises like lv_distance_cuda."""
    return _launch(LV_BYTES, "salt_lv_distance_bytes", ref_bytes, torch.uint8,
                   pos, active, pat, k, window_pad)
