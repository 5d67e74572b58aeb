"""Times the rank-plane and packing builders of to_device_index against
the numpy host route they replaced, on synthetic symbols: the C planes
(5 symbols, one sentinel) of an N-symbol BWT plus the packed words of an
N-nibble mixRef, built by rank_index_on + pack_words_into on a device and
by build_rank_index + pack_nibbles on the host, in turns host, device,
device, host, each result checked bit-equal.

    python -m salt_tpu_torch.tools.time_index_build [N] [--device D]

N defaults to 100,000,000; --device to cuda (raises without a card;
`--device cpu` times the torch route on the CPU).  torch runs one
intra-op thread, as the CPU tests do.  On a card the device times end in
a synchronize and include the copies of the symbols.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from ..ops.rank import build_rank_index, rank_index_on
from ..pipeline.device_index import pack_nibbles, pack_words_into
from ..pipeline.engine import checked_device


def inputs(n: int, seed: int = 1):
    """(BWT symbols 0..3 with one sentinel 4, its cfreq, one-hot mixRef
    nibbles) of length n."""
    rng = np.random.default_rng(seed)
    syms = rng.integers(0, 4, n, dtype=np.uint8)
    syms[n // 3] = 4
    cfreq = np.concatenate([[0], np.cumsum(np.bincount(syms, minlength=5)[:4]),
                            [0]]).astype(np.int64)
    mix = np.uint8(1) << rng.integers(0, 4, n, dtype=np.uint8)
    return syms, cfreq, mix


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="time_index_build")
    ap.add_argument("n", nargs="?", type=int, default=100_000_000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = checked_device(args.device)
    torch.set_num_threads(1)
    syms, cfreq, mix = inputs(args.n)

    def host():
        return build_rank_index(syms, cfreq).bc, pack_nibbles(mix)

    def device():
        bc = rank_index_on(dev, syms, cfreq).bc
        words = pack_words_into(mix, torch.empty(
            (len(mix) + 7) // 8 + 2, dtype=torch.int32, device=dev))
        if dev.type == "cuda":
            torch.cuda.synchronize()
        return bc, words

    routes = {"host": host, "device": device}
    times = {"host": [], "device": []}
    out = {}
    for name in ("host", "device", "device", "host"):
        t0 = time.perf_counter()
        out[name] = routes[name]()
        times[name].append(time.perf_counter() - t0)
    (want_bc, want_words), (bc, words) = out["host"], out["device"]
    same = (torch.equal(bc.cpu(), want_bc)
            and np.array_equal(words.cpu().numpy().view(np.uint32),
                               want_words))
    print(f"C planes + packed mixRef of {args.n} symbols, torch threads "
          f"{torch.get_num_threads()}: host route (build_rank_index + "
          f"pack_nibbles) {', '.join(f'{t:.3f}' for t in times['host'])} s; "
          f"rank_index_on + pack_words_into on {dev} "
          f"{', '.join(f'{t:.3f}' for t in times['device'])} s; "
          f"bit-equal: {same}", flush=True)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
