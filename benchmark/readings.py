"""Readings of the numbers `correct` compares, for setting a cell's
limits: the program's, on many seeds in one process, with a fault
planted or not, and the control's (the reference in the program's
place, with one guarantee of the configuration broken).

    python3 benchmark/readings.py --workload <cell> --seeds 1 2 3 \
        [--side program|control] [--fault NAME] [--calls N] [--witness]

For each seed the reads of `--calls` calls of the cell's size are made
as a run makes them, and the same sample is checked: one JSON line a
seed.  The program side builds the aligner once, as a run's set-up
does; `--fault` plants one of benchmark/faults.py.  `--witness` aligns
the reads the check found at fault again with the port on the CPU and
says whether the records agree with the card's.  The control side needs
no program: the configuration's `control` names what it breaks
("snp_blind": the reference without its known alleles; "max_diff": one
mismatch fewer in an ungapped hit).  The benchmark's own runs never run
this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
if str(HERE.parent) not in sys.path:
    sys.path.insert(0, str(HERE.parent))

import torch  # noqa: E402

from benchmark import faults  # noqa: E402
from benchmark import genome as genome_mod  # noqa: E402
from benchmark import reference, run, traffic  # noqa: E402

# the aligner's options the reference reads, as `aln`'s defaults set them
DEFAULT_OPTIONS = {"k_hits": 8, "max_hits": 5, "max_seed": 50,
                   "min_tlen": 250, "max_tlen": 550}


def control_numbers(cfg: dict, cfg_bytes: bytes, mix: dict, seed: int,
                    n_calls: int, device, cache_dir: Path,
                    options: dict = None) -> dict:
    """The numbers of the control on one seed."""
    gen = genome_mod.load_genome(cfg, cfg_bytes, cache_dir)
    haps = traffic.make_sample(gen, mix, seed)
    ctl = cfg["control"]
    max_diff = int(cfg["index"]["max_diff"])
    broken = reference.RefGenome(gen, snp_aware=not ctl.get("snp_blind"))
    md = int(ctl.get("max_diff", max_diff))
    # salt's gapped limit: a tenth of the read in SE; in PE an end stays
    # at the ungapped limit (its mate's rescue is the program's, not the
    # control's)
    gap_k = max_diff if mix["mode"] == "pe" else int(mix["read_len"]) // 10
    qual = "2" * int(mix["read_len"])
    sample = run.Sample(mix["check_sample"], seed)
    for ci in range(n_calls):
        call = traffic.make_call(haps, mix, seed, ci)

        def lines_of(rows, call=call):
            names = [call.names[i] for i in rows]
            quals = [qual] * len(rows)
            if mix["mode"] == "pe":
                return reference.aligned_pe(
                    broken, names, call.codes[:, rows], quals,
                    call.locus[:, rows], call.reverse[:, rows], md, gap_k,
                    device)
            return reference.aligned_se(
                broken, names, call.codes[rows], quals, call.locus[rows],
                call.reverse[rows], md, gap_k, device)
        sample.offer(ci, call, lines_of)
    opts = dict(DEFAULT_OPTIONS, l_overlap=int(cfg["index"]["l_seed"]),
                **(options or {}))
    judge = run.make_judge(gen, cfg, mix, opts, device)
    sample.check(judge, mix)
    return dict(judge.numbers(), **judge.reported(), checked=judge.checked)


def program_numbers(cell: dict, seeds, n_calls: int, device, cache_dir: Path,
                    fault: str = None, witness: bool = False):
    """The program's numbers on each seed, one aligner for all."""
    from salt_tpu_torch.io.fasta import SeqRecord

    cfg, mix, cfg_bytes = cell["cfg"], cell["mix"], cell["cfg_bytes"]
    gen = genome_mod.load_genome(cfg, cfg_bytes, cache_dir)
    plant = faults.PLANT.get(fault)
    sabotage = faults.SABOTAGE.get(fault)
    if fault and not (plant or sabotage):
        raise ValueError(f"unknown fault {fault!r}")
    haps = traffic.make_sample(gen, mix, seeds[0])
    align, al, opts, setup_s = run.set_up(cfg, cfg_bytes, mix, gen, haps,
                                          seeds[0], device, cache_dir, plant)
    judge_opts = run.option_values(opts)
    ref = reference.RefGenome(gen)
    cpu = None
    for seed in seeds:
        t = time.perf_counter()
        haps = traffic.make_sample(gen, mix, seed)
        sample = run.Sample(mix["check_sample"], seed)
        for ci in range(n_calls):
            call = traffic.make_call(haps, mix, seed, ci)
            lines = align(traffic.records(call, SeqRecord))
            run.sync(device)
            if sabotage is not None:
                lines = sabotage(lines, gen)
            sample.offer(ci, call, lambda rows: [lines[i] for i in rows])
        judge = run.make_judge(gen, cfg, mix, judge_opts, device, ref=ref)
        sample.check(judge, mix)
        out = dict(judge.numbers(), **judge.reported(), checked=judge.checked,
                   seed=seed, seconds=time.perf_counter() - t,
                   examples=judge.examples + judge.repeat_examples)
        if witness and judge.fault_names:
            if cpu is None:
                prefix = cache_dir / f"idx_{genome_mod.config_key(cfg_bytes)}"
                cpu = run.build_aligner(str(prefix), mix["mode"] == "pe",
                                        "cpu", run.aln_args(cfg, mix))[0]
            out["witness"] = witness_agrees(cpu, sample, judge.fault_names,
                                            mix, SeqRecord)
        yield out
    del align, al


def witness_agrees(cpu, sample, names, mix: dict, record_type) -> dict:
    """Align the sample's reads of `names` with the port on the CPU and
    count the records equal to the card's."""
    rows = [i for i, n in enumerate(sample.names) if n in set(names)]
    call = traffic.Call(sample.codes.take(rows, axis=-2), [sample.names[i] for i in rows],
                        sample.locus.take(rows, axis=-1),
                        sample.reverse.take(rows, axis=-1))
    recs = traffic.records(call, record_type)
    if mix["mode"] == "pe":
        out = cpu.align_pairs(*recs)
        got = [(out[2 * i].rstrip("\n"), out[2 * i + 1].rstrip("\n"))
               for i in range(len(rows))]
    else:
        got = cpu.align_records(recs)
    same = sum(1 for i, g in zip(rows, got) if g == sample.lines[i])
    return {"reads": len(rows), "equal_on_cpu": same}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--side", choices=("program", "control"),
                    default="program")
    ap.add_argument("--fault", default=None)
    ap.add_argument("--calls", type=int, default=1)
    ap.add_argument("--witness", action="store_true")
    args = ap.parse_args(argv)
    cell = run.load_cell(args.workload)
    cfg = cell["cfg"]
    device = "cuda" if torch.cuda.is_available() else "cpu"
    cache_dir = HERE / ".cache" / cfg["name"]
    tag = {"workload": args.workload, "side": args.side, "fault": args.fault}
    if args.side == "control":
        for seed in args.seeds:
            t = time.perf_counter()
            out = control_numbers(cfg, cell["cfg_bytes"], cell["mix"], seed,
                                  args.calls, device, cache_dir)
            print(json.dumps(dict(tag, **out, seed=seed,
                                  seconds=time.perf_counter() - t)),
                  flush=True)
        return 0
    for out in program_numbers(cell, args.seeds, args.calls, device,
                               cache_dir, args.fault, args.witness):
        print(json.dumps(dict(tag, **out)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
