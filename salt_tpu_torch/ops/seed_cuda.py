"""Binding of the CUDA overlap seeding kernel K3 (csrc/seed.cu), built at
first use and loaded with ctypes (ops/cuda_build.py).  Nothing is built
or loaded when this module is imported.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils.metrics import count
from .cuda_build import MAX_READ_LEN, CudaKernel, check_tensor
from .rank import RankIndex

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# a family's rank index as the kernels take it (family_args)
FAMILY = [_P, _L, _L, _L, _P, _I]       # bc, rows, row_off, n_words, cfreq, n
SEED = CudaKernel("seed.cu", {"salt_seed_overlap": (
    [_P, _I, _I, _I, _I, _I, _I, _L, _I] + FAMILY + FAMILY
    + [_L, _P, _L, _P, _L, _P, _L] + [_P] * 8 + [_P])})
# the kernel keeps each family's C-array in shared memory
MAX_CFREQ = 16
# seed_only_ref: R is (1, 0, 0, false); R jump tables; R over all l_seed
# bases from (0, n)
MODE_R_JUMP, MODE_R_FULL, MODE_SEED_ONLY_REF = 0, 1, 2


def family_args(ri: RankIndex, name: str, dev) -> list:
    """A family's FAMILY arguments; raises on planes or a C-array the
    kernels do not take.  Two views that share one plane tensor pass the
    same pointer and row count, each with its own row_off."""
    check_tensor(ri.bc, f"{name}.bc", torch.int32, (ri.bc.shape[0], 2), dev)
    n_cfreq = ri.cfreq.shape[0] if ri.cfreq.dim() == 1 else 0
    if not 1 <= n_cfreq <= MAX_CFREQ:
        raise ValueError(f"{name}.cfreq must hold 1..{MAX_CFREQ} values")
    check_tensor(ri.cfreq, f"{name}.cfreq", torch.int64, (n_cfreq,), dev)
    if ri.bc.shape[0] == 0 or ri.bc.data_ptr() % 8:
        raise ValueError(f"{name}.bc must hold rows, 8-byte aligned")
    return [ri.bc.data_ptr(), ri.bc.shape[0], ri.row_off, ri.n_words,
            ri.cfreq.data_ptr(), n_cfreq]


def _table(t: torch.Tensor, name: str, dev) -> list:
    if t.dim() != 1 or t.shape[0] == 0:
        raise ValueError(f"{name} must be a non-empty vector")
    check_tensor(t, name, torch.int32, (t.shape[0],), dev)
    return [t.data_ptr(), t.shape[0]]


def seed_overlap_cuda(
    ri_c: RankIndex,
    ri_r: RankIndex,
    lkt: torch.Tensor,       # int32 [4^l_lkt + 1], uint32 bits
    seq: torch.Tensor,       # int64 (B, L) codes
    l_seed: int,
    l_overlap: int,
    max_seed: int,
    l_lkt: int = 12,
    seed_only_ref: bool = False,
    r_lkt_sp: torch.Tensor = None,
    r_lkt_ep: torch.Tensor = None,
):
    """The kernel's launch: ((sp, ep, offset, valid) of C, the same of R),
    int64 and bool (B, S) each, S = (L - l_seed) // l_overlap + 1, as
    ops/seed.py:seed_overlap_plain computes them.  Raises on tensors and
    shapes the kernel does not take and on a refused launch.  Does not
    synchronize."""
    if seq.dim() != 2:
        raise ValueError(f"seq must be (B, L), got {tuple(seq.shape)}")
    B, L = seq.shape
    if not 1 <= L <= MAX_READ_LEN:
        raise ValueError(f"read length {L} outside 1..{MAX_READ_LEN}")
    if not 1 <= l_lkt <= l_seed <= L or l_overlap < 1:
        raise ValueError(f"need 1 <= l_lkt ({l_lkt}) <= l_seed ({l_seed}) <= "
                         f"L ({L}) and l_overlap ({l_overlap}) >= 1")
    dev = seq.device
    if dev.type != "cuda":
        raise ValueError("seed_overlap_cuda takes CUDA tensors")
    check_tensor(seq, "seq", torch.int64, (B, L), dev)
    if seed_only_ref:
        mode, r_tabs = MODE_SEED_ONLY_REF, [None, 0, None, 0]
    elif r_lkt_sp is not None:
        if r_lkt_ep is None:
            raise ValueError("r_lkt_sp needs r_lkt_ep")
        mode = MODE_R_JUMP
        r_tabs = (_table(r_lkt_sp, "r_lkt_sp", dev)
                  + _table(r_lkt_ep, "r_lkt_ep", dev))
    else:
        mode, r_tabs = MODE_R_FULL, [None, 0, None, 0]
    args = (family_args(ri_c, "ri_c", dev) + family_args(ri_r, "ri_r", dev)
            + [ri_r.n] + _table(lkt, "lkt", dev) + r_tabs)
    S = (L - l_seed) // l_overlap + 1
    out = torch.empty((6, B, S), dtype=torch.int64, device=dev)
    valid = torch.empty((2, B, S), dtype=torch.bool, device=dev)
    if B == 0:
        return (*out[:3], valid[0]), (*out[3:], valid[1])
    lib = SEED.build()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.salt_seed_overlap(
            seq.data_ptr(), B, L, S, l_seed, l_overlap, l_lkt,
            max_seed & 0xFFFFFFFF, mode, *args,
            *(t.data_ptr() for t in out[:3]), valid[0].data_ptr(),
            *(t.data_ptr() for t in out[3:]), valid[1].data_ptr(), stream)
    SEED.check(rc)
    count("k3.seeds", B * S)
    return (*out[:3], valid[0]), (*out[3:], valid[1])
