"""Sampled-mode locate on an index bundle against salt's own walk: the
port's resolve_sampled (over the aligner's fused rank planes and over
standalone ones) and the bundle's full tables (csa, r_coord) against
reference/sa_walk.SaltLocate, on random ranks of both families.

    python -m salt_tpu_torch.tools.sa_walk_check <index prefix>
        [--ranks 65536] [--device cuda|cpu]

The tables are the aligner's, sampled every SEOptions.sa_intv (8, as
salt's C_sa_intv).  Each family's ranks include rank 0 and, in the R
part, 64 ranks on a '#'.  Prints one JSON line: the ranks, the number of
them where each route differs from the plain walk, and the seconds each
took; on a card, where resolve_sampled is the kernel K4, also the lanes
where K4 differs from its plain version, resolve_sampled_plain, with
every other lane inactive.  Exits 1 where any differs.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..index.store import load_index
from ..ops.locate import resolve_sampled, resolve_sampled_plain
from ..ops.rank import rank_index_on
from ..pipeline.device_index import to_device_index
from ..pipeline.engine import SEOptions
from ..reference.sa_walk import SaltLocate

N_SHARP = 64       # R ranks drawn on a '#'
SEED = 17


def draw_ranks(idx, n: int, n_sharp: int, rng):
    """(ranks, is_r): n C ranks then n R ranks, rank 0 first in each
    family, `n_sharp` of the R ranks on a '#'."""
    lo, hi = int(idx.r_cumfreq[4]) + 1, int(idx.r_cumfreq[5]) + 1
    rc = rng.integers(1, len(idx.csa), n)
    rr = rng.integers(min(1, len(idx.r_coord) - 1), len(idx.r_coord), n)
    rc[0] = rr[0] = 0
    k = min(n_sharp, n - 1) if hi > lo else 0
    rr[1 : 1 + k] = rng.integers(lo, hi, k)
    return np.concatenate([rc, rr]), np.arange(2 * n) >= n


def full_values(idx, ranks, is_r) -> np.ndarray:
    """The full tables' value of each rank (uint32 in int64)."""
    return np.where(is_r, idx.r_coord[np.where(is_r, ranks, 0)],
                    idx.csa[np.where(is_r, 0, ranks)]).astype(np.int64)


def check(idx, device, n: int = 65536, tables=None) -> dict:
    """Counts of ranks where each route differs from the plain walk.
    `tables` is an aligner's (DeviceIndex, SampledSA) on `device`; without
    it the tables are built here as the aligner builds them."""
    dev = torch.device(device)
    if tables is None:
        tables = to_device_index(idx, dev, "sampled", SEOptions.sa_intv)
    dix, sampled = tables
    intv = sampled.intv
    ranks, is_r = draw_ranks(idx, n, N_SHARP, np.random.default_rng(SEED))
    out = {"ranks_per_family": n, "on_sharp": int(np.sum(
        is_r & (ranks >= int(idx.r_cumfreq[4]) + 1)
        & (ranks < int(idx.r_cumfreq[5]) + 1))), "intv": intv}
    t = time.perf_counter()
    walk = SaltLocate(idx, intv)
    want = walk.values(ranks, is_r)
    out["plain_walk_s"] = time.perf_counter() - t
    out["full_tables_differ"] = int(np.sum(full_values(idx, ranks, is_r)
                                           != want))
    solo = (rank_index_on(dev, idx.cbwt, np.append(idx.c_l2, 0)),
            rank_index_on(dev, idx.rbwt, np.append(idx.r_cumfreq, 0)))
    rk = torch.from_numpy(ranks).to(dev)
    fam = torch.from_numpy(is_r).to(dev)
    active = torch.ones_like(fam)
    for name, (ri_c, ri_r) in (("fused", (dix.ri_c, dix.ri_r)),
                               ("standalone", solo)):
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t = time.perf_counter()
        got = resolve_sampled(sampled, ri_c, ri_r, rk, fam, active).cpu()
        out[f"resolve_sampled_{name}_s"] = time.perf_counter() - t
        out[f"resolve_sampled_{name}_differ"] = int(np.sum(got.numpy()
                                                           != want))
        if dev.type == "cuda":
            # the kernel against its plain version on every lane, inactive
            # ones too (every other rank)
            half = active & (torch.arange(len(ranks), device=dev) % 2 == 0)
            k4 = resolve_sampled(sampled, ri_c, ri_r, rk, fam, half)
            plain = resolve_sampled_plain(sampled, ri_c, ri_r, rk, fam, half)
            out[f"k4_{name}_against_plain_differ"] = int((k4 != plain).sum())
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("prefix")
    ap.add_argument("--ranks", type=int, default=65536)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = check(load_index(args.prefix), args.device, args.ranks)
    print(json.dumps(out), flush=True)
    return int(any(v for k, v in out.items() if k.endswith("_differ")))


if __name__ == "__main__":
    sys.exit(main())
