"""The benchmark of salt_tpu_torch: one cell a process.

    python3 benchmark/run.py --workload <config>.<mix> --seed N \\
        --seconds S --trace 0|1

A cell is an entry of BENCHMARK.json's `workloads`.  Everything that
belongs to one configuration, traffic mix, limit set or metric is a file
of its own that this harness finds by name:

    benchmark/configs/<config>.json   genome (one contig, or
                                      `genome.contigs`), SNPs, index
                                      options, and `idx_args` /
                                      `aln_args` for the port's `idx`
                                      and `aln` commands
    benchmark/traffic/<mix>.json      read simulation, call size, and
                                      `aln_args` of its own
    benchmark/limits/<cell>.json      the limits `correct` is held to
    benchmark/metrics/<metric>.py     read(run) -> number or None

A run: the configuration's genome and SNP table (made from its seed, or
read from benchmark/.cache), the sample's haplotypes (from --seed), and,
on a checkout's first run, the index, built and saved by the port's own
`idx` command in a child process (logged apart, as a compile is).  Then
set-up, timed from the import of salt_tpu_torch to the end of one
warm-up call: CUDA, the kernel libraries, the index bundle, the aligner
`aln -d` makes with the cell's `aln_args`, which builds the device index.
The window hands the aligner calls of `per_call` reads (SE,
`align_records`) or pairs (PE, `align_pairs`), each made from (--seed,
call) with the clock stopped and ended by a device synchronize, until
the timed seconds reach --seconds.  Of each call only the records of a
sample drawn from the seed are kept.  With --trace 1 the first call is
profiled and the stage timers are read over the calls after it.  Once
the window has closed and the aligner is freed, the reference
(benchmark/reference.py) checks the sample.

The last line of standard output is the result: correct, attempted,
failed, metrics, device, breakdown (traced runs) and checks (each
number compared, beside its limit).
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "salt_tpu")

if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark import genome as genome_mod  # noqa: E402
from benchmark import reference, traffic  # noqa: E402
from benchmark.trace import WINDOW, reduce_trace  # noqa: E402


def log(msg: str) -> None:
    print(f"[run] {msg}", file=sys.stderr, flush=True)


def load_json(path: Path):
    with open(path) as fh:
        return json.load(fh)


def load_reader(name: str):
    """The read() of benchmark/metrics/<name>.py."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def load_cell(name: str, bench: dict = None) -> dict:
    """A cell's entry, configuration (and its bytes), traffic mix and
    limits, each found by name."""
    bench = bench or load_json(ROOT / "BENCHMARK.json")
    w = {x["name"]: x for x in bench["workloads"]}[name]
    cfg_bytes = (HERE / "configs" / f"{w['config']}.json").read_bytes()
    return {"workload": w, "cfg": json.loads(cfg_bytes),
            "cfg_bytes": cfg_bytes,
            "mix": load_json(HERE / "traffic" / f"{w['traffic']}.json"),
            "limits": load_json(HERE / "limits" / f"{name}.json")["limits"]}


def cell_metrics(bench: dict, cell: str):
    """The end-to-end and per-layer metric entries the cell reports."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if cell in m.get("workloads", [cell] if m["moves"] in names
                              else [])]
    return e2e, layer


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def aln_args(cfg: dict, mix: dict) -> list:
    """The `aln` options of a cell beyond the defaults and -d."""
    return list(cfg.get("aln_args", [])) + list(mix.get("aln_args", []))


class _Built(Exception):
    pass


def build_aligner(prefix: str, paired: bool, device: str, extra=()):
    """The aligner `salt_tpu_torch.cli aln -d <extra>` makes for this
    index, with the command line's own defaults: cli.main runs up to the
    point where it would read the reads.  Returns (aligner, the options
    it runs with, seconds to load the index, seconds to build the
    aligner)."""
    from salt_tpu_torch import cli

    real = cli._aligner
    box = {}

    def capture(args, idx, opts, paired_, shards=None):
        box["t_loaded"] = time.perf_counter()
        al = real(args, idx, opts, paired_, shards)
        box["aligner"], box["opts"] = al, getattr(al, "opts", opts)
        raise _Built

    argv = ["aln", "-d", "--device", device, *extra] \
        + (["-p"] if paired else []) \
        + [prefix, "unread_1.fq"] + (["unread_2.fq"] if paired else [])
    cli._aligner = capture
    t0 = time.perf_counter()
    try:
        cli.main(argv)
    except _Built:
        pass
    finally:
        cli._aligner = real
    t1 = time.perf_counter()
    return box["aligner"], box["opts"], box["t_loaded"] - t0, \
        t1 - box["t_loaded"]


def write_inputs(gen, fa: Path, snp: Path) -> None:
    """The genome as FASTA, a record a contig, and its SNP table in
    salt's format: contig by contig in FASTA order, each line with its
    contig's name and 1-based position in it."""
    chars = gen.chars()
    table = list(zip(gen.contig_names, gen.contig_offsets.tolist(),
                     gen.contig_lengths.tolist()))
    with open(fa, "wb") as fh:
        for name, off, ln in table:
            fh.write(f">{name}\n".encode())
            for i in range(off, off + ln, 1 << 20):
                fh.write(chars[i:min(i + (1 << 20), off + ln)].tobytes())
            fh.write(b"\n")
    lut = "ACGTN"
    with open(snp, "w") as fh:
        for p, c, r, a in zip(gen.snp_pos.tolist(),
                              gen.contig_of(gen.snp_pos).tolist(),
                              gen.codes[gen.snp_pos].tolist(),
                              gen.snp_alt.tolist()):
            name, off, _ln = table[c]
            fh.write(f"{name}\t{p - off + 1}\t{lut[r]}/{lut[a]}\t{lut[r]}\n")


def ensure_index(cfg: dict, gen, prefix: Path) -> float:
    """Build and save the configuration's index once a checkout, as a
    user does: the port's `idx -k <l_seed> <idx_args>` command, in a
    child process, over the genome and SNP table `write_inputs` writes.
    Every file `idx` writes (with `--shards N`, the shards and their
    manifest too) moves under `prefix`.  Returns the seconds it took (0
    when built before)."""
    if Path(str(prefix) + ".salt.json").exists():
        return 0.0
    t = time.perf_counter()
    work = prefix.parent / f"{prefix.name}.build"
    work.mkdir(parents=True, exist_ok=True)
    fa, snp = work / "genome.fa", work / "genome.snp"
    write_inputs(gen, fa, snp)
    out = work / "idx"
    argv = [sys.executable, "-m", "salt_tpu_torch.cli", "idx", "-k",
            str(cfg["index"]["l_seed"]), *cfg.get("idx_args", []),
            str(fa), str(snp), str(out)]
    env = dict(os.environ, SALT_TPU_STORE_COMPRESS="0")
    subprocess.run(argv, check=True, cwd=str(ROOT), env=env,
                   stdout=subprocess.DEVNULL)
    main_json = None
    for f in sorted(work.iterdir()):
        if f.name.startswith("idx."):
            dest = prefix.parent / (prefix.name + f.name[3:])
            if f.name == "idx.salt.json":
                main_json = (f, dest)
            else:
                os.replace(f, dest)
    os.replace(*main_json)          # last: its presence means complete
    shutil.rmtree(work)
    return time.perf_counter() - t


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


SPANS = ("device.dispatch", "device.complete", "host.finalize",
         "host.pairing", "host.rescue_and_sam")


def wrap_layers(al, paired: bool):
    """Host spans around each layer's call, for the trace's idle gaps."""
    from torch.profiler import record_function

    def span(obj, attr, name):
        fn = getattr(obj, attr)

        def wrapped(*a, **k):
            with record_function(name):
                return fn(*a, **k)
        setattr(obj, attr, wrapped)

    se = al._se if paired else al
    span(se, "_dispatch_batch", "device.dispatch")
    span(se, "_complete_batch", "device.complete")
    if paired:
        span(al, "_fill_states_fast", "host.pairing")
        span(al, "_make_state", "host.pairing")
        span(al, "_finalize_states", "host.rescue_and_sam")
    else:
        span(al, "_finalize_batch", "host.finalize")


class Sample:
    """The reads (pairs) of a window that the reference checks: uniform
    over all of them and drawn from the seed.  Each read of call `ci`
    gets a key from (seed, ci); the `size` least keys are kept, with the
    read's truth and records, and the rest of each call is dropped."""

    def __init__(self, size: int, seed: int):
        self.size, self.seed = int(size), seed
        self.keys = None

    def offer(self, ci: int, call, lines_of) -> None:
        """`lines_of(rows)` gives the records of those rows of the call."""
        n = len(call.names)
        keys = np.random.default_rng([self.seed % (1 << 64), 3, ci]).random(n)
        k = min(self.size, n)
        rows = np.sort(np.argpartition(keys, k - 1)[:k]) if k < n \
            else np.arange(n)
        if self.keys is not None and len(self.keys) >= self.size:
            rows = rows[keys[rows] < self.keys.max()]
        if not len(rows):
            return
        new = {"keys": keys[rows], "names": [call.names[i] for i in rows],
               "codes": np.take(call.codes, rows, axis=-2),
               "locus": np.take(call.locus, rows, axis=-1),
               "reverse": np.take(call.reverse, rows, axis=-1),
               "lines": list(lines_of(rows))}
        if self.keys is not None:
            new = {"keys": np.concatenate([self.keys, new["keys"]]),
                   "names": self.names + new["names"],
                   "codes": np.concatenate([self.codes, new["codes"]], -2),
                   "locus": np.concatenate([self.locus, new["locus"]], -1),
                   "reverse": np.concatenate([self.reverse, new["reverse"]],
                                             -1),
                   "lines": self.lines + new["lines"]}
        keep = np.argsort(new["keys"], kind="stable")[:self.size]
        self.keys = new["keys"][keep]
        self.names = [new["names"][i] for i in keep]
        self.codes = np.take(new["codes"], keep, axis=-2)
        self.locus = np.take(new["locus"], keep, axis=-1)
        self.reverse = np.take(new["reverse"], keep, axis=-1)
        self.lines = [new["lines"][i] for i in keep]

    def check(self, judge, mix: dict) -> None:
        if self.keys is None:
            return
        quals = ["2" * int(mix["read_len"])] * len(self.names)
        fn = judge.check_pe if mix["mode"] == "pe" else judge.check_se
        fn(self.lines, self.names, self.codes, quals, self.locus,
           self.reverse)


def make_judge(gen, cfg: dict, mix: dict, opts: dict, device, ref=None):
    """The reference's judge of a cell, with the aligner's options."""
    return reference.Judge(
        ref or reference.RefGenome(gen), device,
        max_diff=int(cfg["index"]["max_diff"]),
        gap_k=int(mix["read_len"]) // 10, k_hits=opts["k_hits"],
        max_hits=opts["max_hits"], min_tlen=opts["min_tlen"],
        max_tlen=opts["max_tlen"], l_seed=int(cfg["index"]["l_seed"]),
        l_overlap=opts["l_overlap"], max_seed=opts["max_seed"])


def option_values(opts) -> dict:
    return {"k_hits": opts.k_hits, "max_hits": opts.max_hits,
            "l_overlap": opts.l_overlap, "max_seed": opts.max_seed,
            "min_tlen": getattr(opts, "min_tlen", 250),
            "max_tlen": getattr(opts, "max_tlen", 550)}


def set_up(cfg: dict, cfg_bytes: bytes, mix: dict, gen, haps, seed: int,
           device: str, cache_dir: Path, plant=None):
    """Index (once a checkout, apart), then set-up timed from the import
    of the port to the end of a warm-up call.  Returns (align, aligner,
    options, set-up seconds)."""
    paired = mix["mode"] == "pe"
    prefix = cache_dir / f"idx_{genome_mod.config_key(cfg_bytes)}"
    built = ensure_index(cfg, gen, prefix)
    if built:
        log(f"index built by the port's idx in {built:.3f} s (not set-up)")

    t_setup = time.perf_counter()
    import salt_tpu_torch  # noqa: F401
    from salt_tpu_torch.io.fasta import SeqRecord
    from salt_tpu_torch.utils.native import load_native

    t_import = time.perf_counter()
    if torch.device(device).type == "cuda":
        torch.cuda.init()
        torch.empty(1, device=device)
    t_cuda = time.perf_counter()
    if torch.device(device).type == "cuda":
        from salt_tpu_torch.ops import lv_cuda, sw_cuda

        lv_cuda.LV.build()
        sw_cuda.SW.build()
    load_native()
    t_libs = time.perf_counter()
    al, opts, t_load, t_al = build_aligner(str(prefix), paired, device,
                                           aln_args(cfg, mix))
    if plant is not None:
        plant(al)
    # the warm-up call holds one batch of each size the window's calls
    # are cut into; making its reads is no part of set-up
    t_gen = time.perf_counter()
    B = opts.batch_size // 2 if paired else opts.batch_size
    warm = traffic.make_call(
        haps, dict(mix, per_call=B + mix["per_call"] % B), seed, -1)
    warm_recs = traffic.records(warm, SeqRecord)
    t_gen = time.perf_counter() - t_gen

    def align(recs):
        if paired:
            out = al.align_pairs(*recs)
            return [(out[2 * i].rstrip("\n"), out[2 * i + 1].rstrip("\n"))
                    for i in range(len(recs[0]))]
        return al.align_records(recs)

    t_warm = time.perf_counter()
    align(warm_recs)
    sync(device)
    t_end = time.perf_counter()
    setup_s = t_end - t_setup - t_gen
    log(f"set-up {setup_s:.3f} s: import {t_import - t_setup:.3f}, cuda "
        f"{t_cuda - t_import:.3f}, kernel libraries {t_libs - t_cuda:.3f}, "
        f"index load {t_load:.3f}, aligner {t_al:.3f}, warm-up "
        f"{t_end - t_warm:.3f}")
    return align, al, opts, setup_s
def run_cell(cell: str, cfg: dict, cfg_bytes: bytes, mix: dict, limits: dict,
             bench: dict, seed: int, seconds: float, trace: bool,
             device: str = "cuda", cache_dir: Path = None,
             sabotage=None, plant=None) -> dict:
    """One run of a cell; returns the result object.  For the harness's
    own tests and readings, `plant(aligner)` may break the program once
    it is built, and `sabotage` may rewrite each call's records where
    they are produced."""
    cache_dir = cache_dir or HERE / ".cache" / cfg["name"]
    paired = mix["mode"] == "pe"
    t_run = time.perf_counter()
    gen = genome_mod.load_genome(cfg, cfg_bytes, cache_dir)
    haps = traffic.make_sample(gen, mix, seed)
    log(f"genome and sample in {time.perf_counter() - t_run:.1f} s")
    align, al, opts, setup_s = set_up(cfg, cfg_bytes, mix, gen, haps, seed,
                                      device, cache_dir, plant)
    from salt_tpu_torch.io.fasta import SeqRecord
    from salt_tpu_torch.utils import metrics as stages

    # ---------------- window ----------------
    if trace:
        wrap_layers(al, paired)
    stages.metrics_reset()
    sample = Sample(mix["check_sample"], seed)
    timed, units, staged_units, failed, prof_out = 0.0, 0, 0, 0, None
    staged_s = 0.0
    ci = 0
    while ci < (2 if trace else 1) or timed < seconds:
        call = traffic.make_call(haps, mix, seed, ci)
        recs = traffic.records(call, SeqRecord)
        t = time.perf_counter()
        if trace and ci == 0:
            from torch.profiler import ProfilerActivity, profile, record_function

            acts = [ProfilerActivity.CPU]
            if torch.device(device).type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            with profile(activities=acts) as prof:
                with record_function(WINDOW):
                    lines = align(recs)
                    sync(device)
        else:
            lines = align(recs)
            sync(device)
        dt = time.perf_counter() - t
        timed += dt
        n = len(call.names)
        log(f"call {ci}: {n} in {dt:.3f} s")
        units += n
        if trace and ci == 0:
            prof_out = reduce_trace(prof, SPANS)
            prof_out["units"] = n
            del prof
            stages.metrics_reset()
        else:
            staged_units += n
            staged_s += dt
        if sabotage is not None:
            lines = sabotage(lines, gen)
        failed += sum(1 for x in lines
                      if not (x if isinstance(x, str) else all(x)))
        sample.offer(ci, call, lambda rows: [lines[i] for i in rows])
        del recs, lines, call
        ci += 1
    stage_table = {k: v[0] for k, v in stages.metrics().items()}
    if torch.device(device).type == "cuda":
        peak = int(torch.cuda.max_memory_allocated())
        kind = torch.cuda.get_device_name(0)
    else:
        peak, kind = 0, "cpu"
    found = forbidden_modules()
    if found:
        raise SystemExit(f"forbidden modules loaded: {', '.join(found)}")
    judge_opts = option_values(opts)
    del al, opts, align
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()

    log(f"window {timed:.3f} s in {ci} calls of {mix['per_call']}")

    # ---------------- the reference ----------------
    t_ref = time.perf_counter()
    judge = make_judge(gen, cfg, mix, judge_opts, device)
    sample.check(judge, mix)
    numbers = judge.numbers()
    log(f"reference {time.perf_counter() - t_ref:.1f} s; run "
        f"{time.perf_counter() - t_run:.1f} s")
    correct = all(numbers[k] <= limits[k] for k in limits)

    run = {"units": units, "timed_s": timed, "setup_s": setup_s,
           "stages": stage_table, "staged_units": staged_units,
           "staged_s": staged_s, "memory_peak_bytes": peak,
           "trace": prof_out}
    e2e, layer = cell_metrics(bench, cell)
    out_metrics = {}
    for m in (layer if trace else e2e):
        v = load_reader(m["name"])(run)
        if v is not None:
            out_metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if kind != "cpu" else "cpu", "kind": kind,
           "count": 1, "memory_peak_bytes": peak}
    result = {"correct": bool(correct), "attempted": units, "failed": failed,
              "metrics": out_metrics, "device": dev}
    if trace:
        dev["busy_s"] = prof_out["busy_s"]
        dev["window_s"] = prof_out["window_s"]
        result["breakdown"] = prof_out["breakdown"]
    result["checks"] = {k: {"value": numbers[k], "limit": v}
                        for k, v in limits.items()}
    print(f"[check] {judge.checked} of {units} records checked: "
          + ", ".join(f"{k} {v}" for k, v in numbers.items())
          + "; not held to a limit: "
          + ", ".join(f"{k} {v}" for k, v in judge.reported().items()),
          file=sys.stderr)
    for e in judge.examples + judge.repeat_examples:
        print(f"[check] {e[:400]}", file=sys.stderr)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"unknown workload {args.workload!r}", file=sys.stderr)
        return 2
    w = cells[args.workload]
    if not torch.cuda.is_available() or torch.cuda.device_count() < w["chips"]:
        print(f"{args.workload} needs {w['chips']} CUDA device(s); "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 3
    c = load_cell(args.workload, bench)
    result = run_cell(args.workload, c["cfg"], c["cfg_bytes"], c["mix"],
                      c["limits"], bench, args.seed, args.seconds,
                      bool(args.trace))
    for k, v in result["checks"].items():
        print(f"check {k} {v['value']} limit {v['limit']}", file=sys.stderr)
    print(json.dumps(result))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
