"""Batched overlap seeding (alnse_seed_overlap, Align_src/alnse.c:199-312).
Port of salt_tpu/ops/seed.py.

For every seed start p (stride `l_overlap`) of every read, in parallel:

  C part: 12-mer lookup-table jump for the seed's last 12 bases, then
  l_seed-12 LF steps, then greedy left extension while the interval is
  wider than `max_seed` (alnse.c:246-258).

  R part: the same over the local-pattern BWT (rbwt.c:619-648,
  alnse.c:279-291; no N guard in the R extension, as in the reference).
  With the exact R 12-mer interval tables it jumps 12 steps as well.

Both families step over the same bases, so each LF step and each
extension round serves both.

`seed_overlap` runs the CUDA kernel K3 (ops/seed_cuda.py, csrc/seed.cu)
on CUDA tensors: one launch a call, no read-back.  On CPU tensors it runs
the plain PyTorch version, `seed_overlap_plain`, whose extension loop
reads back `any(active)` once per round (a host.sync) because its round
count is data dependent.  Either counts its seed starts as k3.seeds.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.metrics import count, to_host
from . import seed_cuda
from .rank import RankIndex, lf_step, rank_excl
from .uint import as_i32, take, take_u32, ugt


class Seeds(NamedTuple):
    sp: torch.Tensor      # int64 (..., S)
    ep: torch.Tensor      # int64 (..., S)
    offset: torch.Tensor  # int64 (..., S) seed start minus extension
    valid: torch.Tensor   # bool  (..., S)


def _match_backward(fams, chars):
    """Masked LF scans of several families over the same char stream
    (steps, ...) fed last-to-first.  fams: [(ri, k, l, alive)]."""
    for c in chars:
        bad = c > 3
        c0 = torch.where(bad, 0, c)
        nxt = []
        for ri, k, l, alive in fams:
            kn, ln = lf_step(ri, k, l, c0)
            alive = alive & ~bad & ~ugt(kn, ln)
            nxt.append((ri, torch.where(alive, kn, k),
                        torch.where(alive, ln, l), alive))
        fams = nxt
    return [(k, l, alive) for _ri, k, l, alive in fams]


def _greedy_extend(fams, seq, p, max_seed):
    """While l-k > max_seed and l_ext < p: try one more left base
    (alnse.c:246-258/279-291).  fams: [(ri, check_n, k, l, valid)];
    seq (B, L), p (B, S).  Returns [(k, l, l_ext)]."""
    B, S = p.shape
    seq_e = seq[:, None, :].expand(B, S, seq.shape[-1])
    st = []
    for ri, check_n, k, l, valid in fams:
        l_ext = torch.zeros_like(k)
        st.append([ri, check_n, k, l, l_ext,
                   valid & ugt(l - k, max_seed) & (l_ext < p)])
    while bool(to_host(torch.stack([s[5].any() for s in st]).any())):
        for s in st:
            ri, check_n, k, l, l_ext, active = s
            at = (p - l_ext - 1).clamp(min=0)
            c = torch.gather(seq_e, 2, at[..., None])[..., 0]
            csafe = c.clamp(max=4)
            ok = rank_excl(ri, k, csafe)
            ol = rank_excl(ri, l + 1, csafe)
            do = active & ~(ok + 1 > ol)  # counts, never wrapped
            if check_n:
                do &= c <= 3
            base = take(ri.cfreq, csafe)
            k = torch.where(do, base + ok + 1, k)
            l = torch.where(do, base + ol, l)
            l_ext = torch.where(do, l_ext + 1, l_ext)
            s[2:] = [k, l, l_ext, do & ugt(l - k, max_seed) & (l_ext < p)]
    return [(k, l, l_ext) for _ri, _cn, k, l, l_ext, _a in st]


def seed_overlap(
    ri_c: RankIndex,
    ri_r: RankIndex,
    lkt: torch.Tensor,
    seq: torch.Tensor,      # (B, L) int64 codes 0..4
    l_seed: int,
    l_overlap: int,
    max_seed: int,
    l_lkt: int = 12,
    seed_only_ref: bool = False,
    r_lkt_sp: torch.Tensor = None,
    r_lkt_ep: torch.Tensor = None,
):
    """Returns (c_seeds, r_seeds), each a Seeds with shape (B, S): the
    kernel on CUDA tensors, the plain version on CPU tensors."""
    args = (ri_c, ri_r, lkt, seq, l_seed, l_overlap, max_seed, l_lkt,
            seed_only_ref, r_lkt_sp, r_lkt_ep)
    if seq.is_cuda:
        c, r = seed_cuda.seed_overlap_cuda(*args)
        return Seeds(*c), Seeds(*r)
    return seed_overlap_plain(*args)


def seed_overlap_plain(
    ri_c: RankIndex,
    ri_r: RankIndex,
    lkt: torch.Tensor,
    seq: torch.Tensor,      # (B, L) int64 codes 0..4
    l_seed: int,
    l_overlap: int,
    max_seed: int,
    l_lkt: int = 12,
    seed_only_ref: bool = False,
    r_lkt_sp: torch.Tensor = None,
    r_lkt_ep: torch.Tensor = None,
):
    """Plain PyTorch version of the kernel: (c_seeds, r_seeds), each a
    Seeds with shape (B, S)."""
    B, L = seq.shape
    win = seq.unfold(1, l_seed, l_overlap)                  # (B, S, l_seed)
    S = win.shape[1]
    count("k3.seeds", B * S)
    p = torch.arange(0, S * l_overlap, l_overlap,
                     device=seq.device).expand(B, S)         # seed starts

    # ---- C part: 12-mer jump ----
    tail = win[..., l_seed - l_lkt:]
    has_n = (tail > 3).any(-1)
    pw = 4 ** torch.arange(l_lkt - 1, -1, -1, device=seq.device)
    kmer = (torch.where(tail > 3, 0, tail) * pw).sum(-1)
    sp0 = torch.where(has_n, 1, as_i32(take_u32(lkt, kmer)))
    ep0 = torch.where(has_n, 0, as_i32(take_u32(lkt, kmer + 1)) - 1)
    # LF over the remaining l_seed-12 bases, last-to-first
    chars = win[..., : l_seed - l_lkt].flip(-1).movedim(-1, 0)
    c_fam = (ri_c, sp0, ep0, ~ugt(sp0, ep0))

    if not seed_only_ref and r_lkt_sp is not None and l_seed >= l_lkt:
        rk0 = torch.where(has_n, 1, as_i32(take_u32(r_lkt_sp, kmer)))
        rl0 = torch.where(has_n, 0, as_i32(take_u32(r_lkt_ep, kmer)))
        (ck, cl, okc), (rk, rl, okr) = _match_backward(
            [c_fam, (ri_r, rk0, rl0, ~ugt(rk0, rl0))], chars)
        (ck, cl, ce), (rk, rl, re_) = _greedy_extend(
            [(ri_c, True, ck, cl, okc), (ri_r, False, rk, rl, okr)],
            seq, p, max_seed)
        return (Seeds(sp=ck, ep=cl, offset=p - ce, valid=okc),
                Seeds(sp=rk, ep=rl, offset=p - re_, valid=okr))

    ((ck, cl, okc),) = _match_backward([c_fam], chars)
    ((ck, cl, ce),) = _greedy_extend([(ri_c, True, ck, cl, okc)], seq, p,
                                     max_seed)
    c_seeds = Seeds(sp=ck, ep=cl, offset=p - ce, valid=okc)
    z = torch.zeros((B, S), dtype=torch.int64, device=seq.device)
    if seed_only_ref:
        return c_seeds, Seeds(sp=z + 1, ep=z, offset=z, valid=z.bool())
    # ---- R part without the jump table: full l_seed-step search ----
    ((rk, rl, okr),) = _match_backward(
        [(ri_r, z, z + ri_r.n, torch.ones_like(z, dtype=torch.bool))],
        win.flip(-1).movedim(-1, 0))
    ((rk, rl, re_),) = _greedy_extend([(ri_r, False, rk, rl, okr)], seq, p,
                                      max_seed)
    return c_seeds, Seeds(sp=rk, ep=rl, offset=p - re_, valid=okr)
