"""uint32 and int32 semantics on int64 tensors.

salt_tpu carries positions as uint32 and ranks as (possibly wrapped)
int32, and relies on 32-bit wraparound in a few places.  PyTorch has no
arithmetic, comparisons or shifts on uint32 tensors and no popcount, so
the port carries every such value in int64 and states the 32-bit
semantics explicitly: `& U32` where salt_tpu reads a value as uint32,
`as_i32` where its int32 arithmetic wraps.

Index tables keep salt_tpu's 4-byte width on the device: they are
stored as int32 tensors holding the uint32 bit pattern and read back
through `take_u32`.
"""

from __future__ import annotations

import numpy as np
import torch

U32 = 0xFFFFFFFF


def as_i32(x: torch.Tensor) -> torch.Tensor:
    """Two's-complement wrap of an integer tensor to the int32 range."""
    return ((x + 2**31) & U32) - 2**31


def ugt(a: torch.Tensor, b) -> torch.Tensor:
    """Unsigned a > b on values carried as (possibly wrapped) int32."""
    return (a & U32) > (b & U32)


def umin(a: torch.Tensor, b) -> torch.Tensor:
    """Unsigned minimum of wrapped-int32 values, returned as int32."""
    b = torch.as_tensor(b, dtype=a.dtype, device=a.device)
    return as_i32(torch.minimum(a & U32, b & U32))


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits in the low 32 bits of each int64 element (SWAR)."""
    x = x & U32
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & U32) >> 24


def take(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """arr[idx] along dim 0 with indices clamped to the array, as an XLA
    gather reads out-of-range indices."""
    return arr[idx.clamp(0, arr.shape[0] - 1)]


def take_u32(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather from an int32 table holding uint32 bit patterns; returns
    the unsigned values as int64."""
    return take(arr, idx).long() & U32


def u32_table(a: np.ndarray) -> torch.Tensor:
    """A host uint32 array as an int32 tensor of the same bits."""
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint32)
                            .view(np.int32))
