"""Command-line entry points of the port: `idx`, `aln` and `polish`.

    python -m salt_tpu_torch.cli idx [-k 25] ref.fa snps.txt prefix
    python -m salt_tpu_torch.cli aln [-d] [-c] [-r N] [-s N] [-m N] [-g RG]
                                     [-X 0|1] [--sa-mode full|sampled]
                                     [--device cuda|cpu] prefix reads.fq
    python -m salt_tpu_torch.cli aln -p [-a MIN_TLEN] [-b MAX_TLEN] ...
                                     prefix R1.fq R2.fq
    python -m salt_tpu_torch.cli polish [-s] [-p] [--device cuda|cpu]
                                     prefix aln.sam

`aln` runs single-end alignment (Landau-Vishkin extension, or
Smith-Waterman with -X 1) or, with -p or two read files, paired-end
alignment, in full or sampled suffix-array mode on --device (default
cuda; asking for cuda without a GPU is an error).  `polish` re-scores
the multi-hits of a salt SAM (Landau-Vishkin on --device, or host SSW
with -s).  Option handling mirrors salt_tpu/cli.py; options of paths
that are not ported yet exit with a message.
"""

from __future__ import annotations

import argparse
import sys


def _not_ported(what: str) -> int:
    print(f"[aln] {what} is not ported to salt_tpu_torch yet (see "
          "ROADMAP.md); use `python -m salt_tpu.cli` for it",
          file=sys.stderr)
    return 2


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    ap = argparse.ArgumentParser(prog="salt-tpu-torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    ix = sub.add_parser("idx", help="build SNP-aware index")
    ix.add_argument("-k", "--seed-len", type=int, default=25)
    ix.add_argument("--compat-rpart", action="store_true",
                    help="reproduce the reference's broken R-part anchors")
    ix.add_argument("ref_fa")
    ix.add_argument("snp_file")
    ix.add_argument("prefix")

    al = sub.add_parser("aln", help="align reads -> SAM on stdout")
    al.add_argument("-t", "--threads", type=int, default=1)
    # -n/-l are parsed but inert in the reference too (alnse.c:1016,1090;
    # aux_init, alnse.c:1381)
    al.add_argument("-n", "--num", type=int, default=-1)
    al.add_argument("-g", "--group", default=None)
    al.add_argument("-l", "--read-length", type=int, default=100)
    al.add_argument("-c", "--xa-cigar", action="store_true")
    al.add_argument("-d", "--md", action="store_true")
    al.add_argument("-r", "--overlap", type=int, default=-1)
    al.add_argument("-s", "--max-seed", type=int, default=50)
    al.add_argument("-m", "--max-locate", type=int, default=1000)
    al.add_argument("-p", "--pe", action="store_true")
    al.add_argument("-a", "--min-tlen", type=int, default=250)
    al.add_argument("-b", "--max-tlen", type=int, default=550)
    al.add_argument("-X", "--extend", type=int, default=0,
                    help="extension algorithm: 0=Landau-Vishkin, 1=SW")
    al.add_argument("--batch-size", type=int, default=4096)
    al.add_argument("--sa-mode", choices=["full", "sampled"], default="full")
    al.add_argument("--shards", type=int, default=0)
    al.add_argument("--device", default="cuda",
                    help="torch device to align on (default: cuda)")
    al.add_argument("index_prefix")
    al.add_argument("read1")
    al.add_argument("read2", nargs="?")

    po = sub.add_parser("polish", help="re-score a salt SAM's multi-hits")
    po.add_argument("-s", "--sw", action="store_true")
    po.add_argument("-p", "--pe", action="store_true")
    po.add_argument("--device", default="cuda",
                    help="torch device to score on (default: cuda)")
    po.add_argument("index_prefix")
    po.add_argument("sam")

    args = ap.parse_args(argv)
    if args.cmd == "polish":
        from .index.store import load_index
        from .polish.polish import polish_main

        polish_main(load_index(args.index_prefix), args.sam, paired=args.pe,
                    use_sw=args.sw, out=sys.stdout, device=args.device)
        return 0

    if args.cmd == "idx":
        from .index.build import build_index_from_data
        from .index.store import save_index
        from .io.fasta import read_records
        from .io.snp import read_snp_blocks

        mode = "reference_compat" if args.compat_rpart else "exact"
        contig_data = [(r.name, r.comment or "(null)", r.seq)
                       for r in read_records(args.ref_fa)]
        blocks = list(read_snp_blocks(args.snp_file))
        save_index(build_index_from_data(contig_data, blocks,
                                         l_seed=args.seed_len,
                                         r_anchor_mode=mode), args.prefix)
        return 0

    if args.shards > 0:
        return _not_ported("the sharded aligner (--shards)")
    if args.threads != 1:
        print(f"[aln] -t {args.threads} ignored: batches are data-parallel "
              "on the device", file=sys.stderr)
    if args.num != -1:
        print("[aln] -n is inert (the reference overwrites max_diff "
              "internally, alnse.c:1016,1090); accepted for compatibility",
              file=sys.stderr)
    if args.read_length != 100:
        print("[aln] -l is inert (read length is taken from the input); "
              "accepted for compatibility", file=sys.stderr)

    from .index.store import load_index

    idx = load_index(args.index_prefix)
    common = dict(
        l_overlap=args.overlap if args.overlap > 0 else idx.l_seed,
        max_seed=args.max_seed,
        max_locate=args.max_locate,
        print_xa_cigar=args.xa_cigar,
        print_nm_md=args.md,
        rg_id=args.group,
        batch_size=args.batch_size,
        sa_mode=args.sa_mode,
    )
    cmd = " ".join(["salt-tpu-torch"] + argv)
    if args.pe or args.read2:
        if not args.read2:
            ap.error("paired-end alignment (-p) needs two read files")
        from .pipeline.pe_engine import PEAligner, PEOptions

        opts = PEOptions(min_tlen=args.min_tlen, max_tlen=args.max_tlen,
                         **common)
        PEAligner(idx, opts, device=args.device).align_files(
            args.read1, args.read2, sys.stdout, cmd=cmd)
        return 0

    from .pipeline.engine import SEAligner, SEOptions

    opts = SEOptions(extend_algo="sw" if args.extend == 1 else "lv", **common)
    SEAligner(idx, opts, device=args.device).align_file(
        args.read1, sys.stdout, cmd=cmd)
    return 0


if __name__ == "__main__":
    sys.exit(main())
