"""Binding of the sampled-mode locate walk K4 (csrc/sa_walk.cu), built at
first use and loaded with ctypes (ops/cuda_build.py).  Nothing is built
or loaded when this module is imported.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils.metrics import count
from .cuda_build import CudaKernel, check_tensor
from .seed_cuda import FAMILY, family_args

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
SA_WALK = CudaKernel("sa_walk.cu", {"salt_sa_walk": (
    [_P, _P, _P, _L] + [_P, _L] * 3 + [_L] * 5 + [_I] + FAMILY + FAMILY
    + [_L, _L, _P, _P])})


def _table(t: torch.Tensor, name: str, shape_tail: tuple, dev) -> list:
    if t.dim() != 1 + len(shape_tail) or t.shape[0] == 0:
        raise ValueError(f"{name} must be a non-empty table of "
                         f"{1 + len(shape_tail)} dimensions")
    check_tensor(t, name, torch.int32, (t.shape[0], *shape_tail), dev)
    return [t.data_ptr(), t.shape[0]]


def resolve_sampled_cuda(sampled, ri_c, ri_r, rank: torch.Tensor,
                         is_r: torch.Tensor,
                         active: torch.Tensor) -> torch.Tensor:
    """The kernel's launch: int64 of rank's shape, the values of
    ops/locate.py:resolve_sampled_plain on every lane, inactive lanes
    included.  rank is int64 (uint32 in the low bits), is_r and active
    bool of the same shape; `sampled` a SampledSA and ri_c, ri_r the two
    families' RankIndex (fused or not) on the same device.  Raises on
    tensors the kernel does not take and on a refused launch, before any
    build for the former.  Counts k4.lanes.  Does not synchronize."""
    dev = rank.device
    shape = tuple(rank.shape)
    check_tensor(rank, "rank", torch.int64, shape, dev)
    check_tensor(is_r, "is_r", torch.bool, shape, dev)
    check_tensor(active, "active", torch.bool, shape, dev)
    s = sampled
    tables = (_table(s.sel_cat, "sel_cat", (2,), dev)
              + _table(s.samples_cat, "samples_cat", (), dev)
              + _table(s.syms_cat, "syms_cat", (), dev))
    if s.sel_cat.data_ptr() % 8:
        raise ValueError("sel_cat must be 8-byte aligned")
    fams = family_args(ri_c, "ri_c", dev) + family_args(ri_r, "ri_r", dev)
    if dev.type != "cuda":
        raise ValueError("resolve_sampled_cuda takes CUDA tensors")
    out = torch.empty(shape, dtype=torch.int64, device=dev)
    n = rank.numel()
    if n == 0:
        return out
    lib = SA_WALK.build()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.salt_sa_walk(
            rank.data_ptr(), is_r.data_ptr(), active.data_ptr(), n, *tables,
            s.c_words, s.c_sel_rows, s.c_n_samples, s.sharp_lo, s.sharp_hi,
            max(int(s.intv), int(s.max_r_walk)) + 1, *fams, ri_c.n, ri_r.n,
            out.data_ptr(), stream)
    SA_WALK.check(rc)
    count("k4.lanes", n)
    return out
