"""Binding of the CUDA Smith-Waterman score kernel (csrc/sw.cu), built at
first use and loaded with ctypes (ops/cuda_build.py).  Nothing is built
or loaded when this module is imported.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils.metrics import count
from .cuda_build import MAX_READ_LEN, CudaKernel, check_tensor

_P, _I = ctypes.c_void_p, ctypes.c_int
SW = CudaKernel("sw.cu", {
    "salt_sw_score": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _I],
    "salt_sw_lanes": [_I, _I]})
# H and E are held as 16-bit halves: -gap_open <= E, H <= MAX_READ_LEN
MAX_GAP_OPEN = 16384


def check_gaps(gap_open: int, gap_extend: int) -> None:
    """The recurrence (and the plain version's prefix-maximum form of F)
    needs 0 <= gap_extend <= gap_open and gap_open >= 1."""
    if not (0 <= gap_extend <= gap_open and 1 <= gap_open <= MAX_GAP_OPEN):
        raise ValueError(f"gap_open={gap_open}, gap_extend={gap_extend}: need "
                         f"0 <= gap_extend <= gap_open, 1 <= gap_open <= "
                         f"{MAX_GAP_OPEN}")


def sw_score_cuda(
    refs: torch.Tensor,     # uint8 (B, W) reference nibbles or base codes
    reads: torch.Tensor,    # uint8 (B, L) one-hot or base codes
    ref_len: torch.Tensor,  # int32 (B,) valid columns of each window
    snp_mode: bool,
    gap_open: int = 3,
    gap_extend: int = 1,
) -> torch.Tensor:
    """The kernel's launch: int32 (B,) best local scores.  Raises on
    tensors the kernel does not take and on a refused launch.  Does not
    synchronize: reading the result back does."""
    return sw_score_launch(refs, reads, ref_len, snp_mode, gap_open,
                           gap_extend, lanes=0)


def sw_score_launch(refs, reads, ref_len, snp_mode, gap_open=3, gap_extend=1,
                    lanes=0) -> torch.Tensor:
    """`sw_score_cuda` with the instantiation named.  lanes=0 lets the
    shape choose (`salt_sw_lanes(L, W)` in csrc/sw.cu: what the package
    runs); 16 forces the wavefront kernel (reads of up to 256 bases) and
    1 the one-thread-per-pair kernel.  Measurements use the forced forms
    to time both on one shape."""
    dev = refs.device
    if dev.type != "cuda":
        raise ValueError("sw_score_cuda takes CUDA tensors")
    if refs.dim() != 2 or reads.dim() != 2:
        raise ValueError(f"refs and reads must be (B, W) and (B, L), got "
                         f"{tuple(refs.shape)} and {tuple(reads.shape)}")
    B, W = refs.shape
    L = reads.shape[1]
    if not 1 <= L <= MAX_READ_LEN:
        raise ValueError(f"read length {L} outside 1..{MAX_READ_LEN}")
    if W < 1:
        raise ValueError("reference windows must have at least one column")
    check_gaps(gap_open, gap_extend)
    check_tensor(refs, "refs", torch.uint8, (B, W), dev)
    check_tensor(reads, "reads", torch.uint8, (B, L), dev)
    check_tensor(ref_len, "ref_len", torch.int32, (B,), dev)
    out = torch.empty(B, dtype=torch.int32, device=dev)
    if B == 0:
        return out
    lib = SW.build()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.salt_sw_score(
            refs.data_ptr(), reads.data_ptr(), ref_len.data_ptr(), B, W, L,
            int(bool(snp_mode)), gap_open, gap_extend, out.data_ptr(), stream,
            lanes)
    SW.check(rc)
    count("k2.cells", B * L * W)
    return out
