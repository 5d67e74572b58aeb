"""Batched score-only affine Smith-Waterman for candidate pre-filtering.
Port of salt_tpu/ops/sw_batch.py.

The PE mate-rescue and -X 1 extension paths need the striped-SW score
of (read, reference-window) pairs to DECIDE (accept >= thres_score,
pick the best locus); the full result (begin/end, score2, cigar) is
only needed for the accepted winner (ops/ssw.py computes it
bit-faithfully to the vendored SSW, Align_src/ssw.c).

This module scores thousands of candidates per device call with the
textbook affine-gap SW recurrence.  SSW's striped pass computes E from
the pre-lazy-F H (ssw.c:227-230), so its scores can only be LOWER than
the textbook score; `textbook < threshold  =>  ssw < threshold` makes
this a sound reject filter, and in practice the scores are equal.
Accepted candidates are re-run through the exact host SSW, so observable
behavior is byte-identical.

`sw_score` runs the CUDA kernel (ops/sw_cuda.py) on CUDA tensors and
`sw_score_plain`, the plain PyTorch version, on CPU tensors.

The plain version scans columns with the vertical-gap prefix-max trick:
within a column, F(i) = max_{k<i} (H_nof(k) - gapO - (i-1-k) * gapE) is
a running maximum of position-adjusted keys, and computing F from the
F-uncorrected H is exact for gapO >= gapE, gapO > 0 (re-opening a gap
from a gap-extended cell is never better than extending the gap).
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.metrics import count
from . import sw_cuda

NEG = -(2**20)


def _score_snp(ref_nib, read_onehot, match=1, mismatch=-3):
    """score_mat2 semantics (alnpe.c:58-73): one-hot AND nonzero on
    rows/cols 1,2,4,8 scores +1, everything else (incl. 0/15 reference
    codes) -3.  A read one-hot 15 (N) matches every one-hot row."""
    r_ok = ((ref_nib & (ref_nib - 1)) == 0) & (ref_nib != 0)
    hit = r_ok & ((ref_nib & read_onehot) != 0)
    return torch.where(hit, match, mismatch).to(torch.int32)


def _score_plain(ref_code, read_code, match=1, mismatch=-3, n_pen=-1):
    """score_mat semantics (alnpe.c:52-56): 5x5, N row/col -1."""
    any_n = (ref_code >= 4) | (read_code >= 4)
    eq = ref_code == read_code
    return torch.where(any_n, n_pen,
                       torch.where(eq, match, mismatch)).to(torch.int32)


def sw_score_plain(
    refs: torch.Tensor,     # (B, W) integer: mixref nibbles (snp) or codes
    reads: torch.Tensor,    # (B, L) integer: one-hot (snp) or codes (plain)
    ref_len: torch.Tensor,  # (B,) integer true window lengths (<= W)
    snp_mode: bool,
    gap_open: int = 3,
    gap_extend: int = 1,
) -> torch.Tensor:
    """The plain PyTorch version: (B,) int32 best local alignment score
    (0 if none), on the tensors' device."""
    sw_cuda.check_gaps(gap_open, gap_extend)
    B, W = refs.shape
    L = reads.shape[1]
    dev = refs.device
    go, ge = gap_open, gap_extend
    refs = refs.to(torch.int32)
    reads = reads.to(torch.int32)
    irow = torch.arange(L, dtype=torch.int32, device=dev)
    valid_col = (torch.arange(W, dtype=torch.int32, device=dev)[None, :]
                 < ref_len.to(torch.int32)[:, None])               # (B, W)
    h = torch.zeros((B, L), dtype=torch.int32, device=dev)
    e = torch.zeros((B, L), dtype=torch.int32, device=dev)
    best = torch.zeros(B, dtype=torch.int32, device=dev)
    zero_col = torch.zeros((B, 1), dtype=torch.int32, device=dev)
    neg_col = torch.full((B, 1), NEG, dtype=torch.int32, device=dev)
    score = _score_snp if snp_mode else _score_plain
    if B == 0:
        return best
    for j in range(W):
        s = score(refs[:, j : j + 1], reads)                       # (B, L)
        e = torch.maximum(e - ge, h - go)
        h_diag = torch.cat([zero_col, h[:, :-1]], 1)
        h_nof = torch.clamp(torch.maximum(h_diag + s, e), min=0)
        # F(i) = max_{k<i} h_nof(k) - go - (i-1-k)*ge as a running max of
        # keys sheared by +k*ge, un-sheared by -(i+1)*ge afterwards
        fsrc = torch.cat([neg_col, (h_nof - go + ge)[:, :-1]], 1)
        runmax = torch.cummax(fsrc + irow * ge, 1).values
        f = runmax - (irow + 1) * ge
        vcol = valid_col[:, j : j + 1]
        h = torch.where(vcol, torch.maximum(h_nof, f), 0)
        e = torch.where(vcol, e, 0)
        best = torch.maximum(best, h.max(1).values)
    return best


def sw_score(
    refs: torch.Tensor,
    reads: torch.Tensor,
    ref_len: torch.Tensor,
    snp_mode: bool,
    gap_open: int = 3,
    gap_extend: int = 1,
) -> torch.Tensor:
    """(B,) int32 best local scores of B (window, read) pairs: the CUDA
    kernel on CUDA tensors (codes as uint8, ref_len as int32), the plain
    version on CPU tensors; either counts B x L x W as k2.cells."""
    if refs.device.type == "cuda":
        return sw_cuda.sw_score_cuda(refs, reads, ref_len, snp_mode,
                                     gap_open, gap_extend)
    count("k2.cells", refs.shape[0] * refs.shape[1] * reads.shape[1])
    return sw_score_plain(refs, reads, ref_len, snp_mode, gap_open,
                          gap_extend)


def sw_score_numpy(ref: np.ndarray, read: np.ndarray, snp_mode: bool,
                   gap_open: int = 3, gap_extend: int = 1) -> int:
    """Plain O(W*L) textbook affine SW for testing (single pair)."""
    W, L = len(ref), len(read)
    H = np.zeros((W + 1, L + 1), np.int32)
    E = np.full((W + 1, L + 1), -10**6, np.int32)
    F = np.full((W + 1, L + 1), -10**6, np.int32)
    best = 0
    for j in range(1, W + 1):
        for i in range(1, L + 1):
            r, q = int(ref[j - 1]), int(read[i - 1])
            if snp_mode:
                pw2 = r != 0 and (r & (r - 1)) == 0
                s = 1 if (pw2 and (r & q) != 0) else -3
            else:
                s = -1 if (r >= 4 or q >= 4) else (1 if r == q else -3)
            E[j][i] = max(E[j - 1][i] - gap_extend, H[j - 1][i] - gap_open)
            F[j][i] = max(F[j][i - 1] - gap_extend, H[j][i - 1] - gap_open)
            H[j][i] = max(0, H[j - 1][i - 1] + s, E[j][i], F[j][i])
            best = max(best, int(H[j][i]))
    return best
