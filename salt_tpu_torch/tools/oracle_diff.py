"""SAM concordance of salt_tpu_torch with the reference binary: the port
of tools/run_se_oracle_diff.py and tools/run_pe_oracle_diff.py.

    python -m salt_tpu_torch.tools.oracle_diff [N] [--pe] [--device D]

Builds the reference_compat index (the reference's '#'-anchor
bookkeeping, index/build.py) of the reference tree's test genome with
tools/make_oracle.sh's hapmap, aligns the first N reads (default 20,000;
N pairs with --pe, default 2,000) of its simulated Read1.fq (and
Read2.fq) with the options of the reference's run_se_test.sh
(run_pe_test.sh) on --device (default cuda, an error without a card),
and prints the first differing records and the share of records equal
to the reference binary's SAM (se_oracle.sam, pe_oracle.sam).
tools/make_oracle.sh writes every input.  SALT_TPU_DEVICE_SW sets PE's
device_sw (default auto), as in the original.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from ..index.build import build_index
from ..io.fasta import read_records
from ..pipeline.engine import SEAligner, SEOptions, checked_device
from ..pipeline.pe_engine import PEAligner, PEOptions

GENOME = "/tmp/refbuild/Test/Genome/Genome.fa"
ORACLE_DIR = "/tmp/oracle"


def oracle_path(name: str) -> str:
    return os.path.join(ORACLE_DIR, name)


def compat_index():
    t0 = time.time()
    idx = build_index(GENOME, oracle_path("hapmap.txt"), l_seed=19,
                      r_anchor_mode="reference_compat")
    print(f"index built in {time.time()-t0:.1f}s", flush=True)
    return idx


def first_records(path: str, n: int) -> list:
    recs = []
    for r in read_records(path):
        recs.append(r)
        if len(recs) >= n:
            break
    return recs


def concordance(mine, oracle, what: str, show: int, width: int) -> int:
    """Prints the first `show` differing (mine, oracle) records and the
    concordance line; returns the number that differ."""
    n_diff = 0
    for i, (a, b) in enumerate(zip(mine, oracle)):
        if a != b:
            n_diff += 1
            if n_diff <= show:
                print(f"--- {what} {i}")
                print(f"mine:   {a[:width].rstrip()}")
                print(f"oracle: {b[:width].rstrip()}")
    n = len(mine)
    print(f"concordance: {n-n_diff}/{n} ({100.0*(n-n_diff)/n:.3f}%)")
    return n_diff


def se_diff(n: int, device) -> int:
    idx = compat_index()
    # run_se_test.sh args: -d -r 1 -l 100 -n 20 -c -m 500
    al = SEAligner(idx, SEOptions(
        l_overlap=1, max_locate=500, print_nm_md=True, print_xa_cigar=True,
        batch_size=512, gap_batch=64), device=device)
    recs = first_records(oracle_path("Read1.fq"), n)
    t0 = time.time()
    out = al.align_records(recs)
    dt = time.time() - t0
    print(f"aligned {len(recs)} reads in {dt:.1f}s ({len(recs)/dt:.0f} "
          "reads/s)", flush=True)
    oracle = [l.rstrip("\n") for l in open(oracle_path("se_oracle.sam"))
              if not l.startswith("@")]
    return concordance(out, oracle[: len(out)], "read", 10, 400)


def pe_diff(n: int, device) -> int:
    idx = compat_index()
    al = PEAligner(idx, PEOptions(
        device_sw=os.environ.get("SALT_TPU_DEVICE_SW", "auto"),
        l_overlap=5, max_locate=1000, min_tlen=350, max_tlen=650,
        print_nm_md=True, print_xa_cigar=True, batch_size=2048,
        gap_batch=128), device=device)
    r1 = first_records(oracle_path("Read1.fq"), n)
    r2 = first_records(oracle_path("Read2.fq"), n)
    t0 = time.time()
    out = al.align_pairs(r1, r2)
    dt = time.time() - t0
    print(f"aligned {n} pairs in {dt:.1f}s ({n/dt:.0f} pairs/s)", flush=True)
    oracle = [l for l in open(oracle_path("pe_oracle.sam"))
              if not l.startswith("@")]
    # As the original does: record i (with its newline) is held against
    # every second oracle line, the reference printing a blank line after
    # each paired record.
    orecs = [oracle[i] for i in range(0, len(oracle), 2)]
    return concordance(out[: 2 * n], orecs[: 2 * n], "rec", 8, 300)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="oracle_diff")
    ap.add_argument("n", nargs="?", type=int, default=None,
                    help="reads (pairs with --pe); default 20,000 (2,000)")
    ap.add_argument("--pe", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = checked_device(args.device)
    if args.pe:
        pe_diff(args.n if args.n is not None else 2000, dev)
    else:
        se_diff(args.n if args.n is not None else 20000, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
