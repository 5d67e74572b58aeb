"""Command-line entry points of the port.

    python -m salt_tpu_torch.cli idx [-k 25] [--shards N] ref.fa snps.txt prefix
    python -m salt_tpu_torch.cli aln [-d] [-c] [-r N] [-s N] [-m N] [-g RG]
                                     [-X 0|1] [--sa-mode full|sampled]
                                     [--shards N] [--device cuda|cpu]
                                     prefix reads.fq
    python -m salt_tpu_torch.cli aln -p [-a MIN_TLEN] [-b MAX_TLEN] ...
                                     prefix R1.fq R2.fq
    python -m salt_tpu_torch.cli aln --part-dir DIR [--shard-batch N] ...
    python -m salt_tpu_torch.cli aln --part-dir DIR --merge prefix reads.fq
    python -m salt_tpu_torch.cli polish [-s] [-p] [--device cuda|cpu]
                                     prefix aln.sam
    python -m salt_tpu_torch.cli wgsim | snp-etl | alneval | readtools ...

`aln` runs single-end alignment (Landau-Vishkin extension, or
Smith-Waterman with -X 1) or, with -p or two read files, paired-end
alignment, in full or sampled suffix-array mode on --device (default
cuda; asking for cuda without a GPU is an error).  With --shards it
aligns against the sub-indexes `idx --shards N` built, one per reference
bin, spread over every visible CUDA device (all on the one device when
there is one, or on the CPU with --device cpu); where the prefix holds
no monolithic bundle (tools/build_sharded.py writes none unless asked),
SAM's host tables are the shards' laid end to end.  With --part-dir it
writes one SAM part per batch of --shard-batch reads for the batches
that are this process's (SALT_TPU_PROCESS_ID of SALT_TPU_NUM_PROCESSES),
and --merge joins the parts in input order.  `polish` re-scores the
multi-hits of a salt SAM (Landau-Vishkin on --device, or host SSW with
-s).  Option handling mirrors salt_tpu/cli.py.
"""

from __future__ import annotations

import argparse
import sys

# subcommands that hand their arguments on untouched; they are dispatched
# before argparse, which would not let a leading option flag through
_PASS_THROUGH = {
    "wgsim": ("sim.wgsim", "wgsim_main"),
    "snp-etl": ("etl.snp_etl", "_main"),
    "alneval": ("eval.wgsim_eval", "_main"),
    "readtools": ("eval.readtools", "readtools_main"),
}


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if argv and argv[0] in _PASS_THROUGH:
        import importlib

        module, entry = _PASS_THROUGH[argv[0]]
        return getattr(importlib.import_module(f"{__package__}.{module}"),
                       entry)(argv[1:])
    ap = argparse.ArgumentParser(
        prog="salt-tpu-torch",
        epilog="further subcommands, with options of their own: "
               + ", ".join(sorted(_PASS_THROUGH)))
    sub = ap.add_subparsers(dest="cmd", required=True)

    ix = sub.add_parser("idx", help="build SNP-aware index")
    ix.add_argument("-k", "--seed-len", type=int, default=25)
    ix.add_argument("--compat-rpart", action="store_true",
                    help="reproduce the reference's broken R-part anchors")
    ix.add_argument("--shards", type=int, default=0,
                    help="also build N per-reference-bin sub-indexes "
                         "(contiguous contig runs) for `aln --shards N`")
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
    al.add_argument("-e", "--sw", action="store_true")
    al.add_argument("-X", "--extend", type=int, default=0,
                    help="extension algorithm: 0=Landau-Vishkin, 1=SW")
    # accepted for drop-in compatibility; parsed but dead in the
    # reference too (aln.c:183,190-196 set fields no code reads)
    al.add_argument("-v", "--ref", action="store_true",
                    help=argparse.SUPPRESS)
    al.add_argument("-M", "--mismatch", type=int, default=None,
                    help=argparse.SUPPRESS)
    al.add_argument("-O", "--gapop", type=int, default=None,
                    help=argparse.SUPPRESS)
    al.add_argument("-E", "--gapex", type=int, default=None,
                    help=argparse.SUPPRESS)
    al.add_argument("--batch-size", type=int, default=4096)
    al.add_argument("--sa-mode", choices=["full", "sampled"], default="full")
    al.add_argument("--shards", type=int, default=0,
                    help="align against an index sharded by reference bin "
                         "(built with idx --shards N), the shards spread "
                         "over the visible devices")
    al.add_argument("--part-dir", default=None,
                    help="multi-host mode: write per-batch SAM parts here")
    al.add_argument("--shard-batch", type=int, default=100000,
                    help="reads per part (multi-host granularity)")
    al.add_argument("--merge", action="store_true",
                    help="merge part-dir into SAM on stdout and exit")
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
        if args.shards > 0:
            import json

            from .parallel.sharded import partition_contigs_contiguous

            bins = partition_contigs_contiguous(
                [len(c[2]) for c in contig_data], args.shards)
            for si, b in enumerate(bins):
                save_index(build_index_from_data(
                    [contig_data[i] for i in b],
                    [blocks[i] for i in b if i < len(blocks)],
                    l_seed=args.seed_len, r_anchor_mode=mode,
                ), f"{args.prefix}.shard{si}")
            with open(args.prefix + ".shards.json", "w") as fh:
                json.dump({"n_shards": args.shards, "bins": bins}, fh)
        return 0

    if args.threads != 1:
        print(f"[aln] -t {args.threads} ignored: batches are data-parallel "
              f"on the device ({args.device}); use --part-dir + multiple "
              "processes to scale hosts", file=sys.stderr)
    if args.num != -1:
        print("[aln] -n is inert (the reference overwrites max_diff "
              "internally, alnse.c:1016,1090); accepted for compatibility",
              file=sys.stderr)
    if args.read_length != 100:
        print("[aln] -l is inert (read length is taken from the input); "
              "accepted for compatibility", file=sys.stderr)

    from .index.store import load_index

    shards = None
    if args.shards > 0:
        from .parallel.sharded import load_sharded_index

        idx, *shards = load_sharded_index(args.index_prefix)
    else:
        idx = load_index(args.index_prefix)
    cmd = " ".join(["salt-tpu-torch"] + argv)
    paired = bool(args.pe or args.read2)
    if args.merge:
        from .io.sam import sam_header
        from .parallel.driver import merge_parts

        if not args.part_dir:
            ap.error("--merge needs --part-dir")
        merge_parts(args.part_dir, sys.stdout,
                    sam_header(idx, cmd, args.group))
        return 0
    if paired and not args.read2:
        ap.error("paired-end alignment (-p) needs two read files")

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
    if paired:
        from .pipeline.pe_engine import PEOptions

        opts = PEOptions(min_tlen=args.min_tlen, max_tlen=args.max_tlen,
                         **common)
    else:
        from .pipeline.engine import SEOptions

        opts = SEOptions(extend_algo="sw" if args.extend == 1 else "lv",
                         **common)
    al = _aligner(args, idx, opts, paired, shards)

    if args.part_dir:
        from .parallel.driver import align_file_sharded, maybe_init_distributed

        pid, npro = maybe_init_distributed()
        align_file_sharded(al, args.read1, args.part_dir, pid, npro,
                           batch_size=args.shard_batch, fastq2=args.read2)
    elif paired:
        al.align_files(args.read1, args.read2, sys.stdout, cmd=cmd)
    else:
        al.align_file(args.read1, sys.stdout, cmd=cmd)
    return 0


def _aligner(args, idx, opts, paired: bool, shards=None):
    """The SE or PE aligner of `aln`: over one index on --device, or, with
    --shards, over the sub-indexes that `idx --shards` saved, given as
    (shard indexes, bins)."""
    if shards is None:
        if paired:
            from .pipeline.pe_engine import PEAligner

            return PEAligner(idx, opts, device=args.device)
        from .pipeline.engine import SEAligner

        return SEAligner(idx, opts, device=args.device)

    from .parallel.sharded_engine import ShardedPEAligner, ShardedSEAligner

    shard_ixs, bins = shards
    if len(shard_ixs) != args.shards:
        print(f"[aln] index was sharded {len(shard_ixs)}-way; "
              f"using that (requested {args.shards})", file=sys.stderr)
    cls = ShardedPEAligner if paired else ShardedSEAligner
    # "cuda" means every visible card; any other name, that one device
    return cls(idx, shard_ixs, opts,
               devices=None if args.device == "cuda" else args.device,
               bins=bins, contig_lengths=[c.length for c in idx.contigs])


if __name__ == "__main__":
    sys.exit(main())
