"""Tiny configurations and traffic for the benchmark's CPU tests."""

import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"


def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def tiny(cell: str, bases: int = 200_000, per_call: int = 600,
         sample: int = 200):
    """(cfg, cfg_bytes, mix, limits) of a cell, cut to `bases` bases and
    calls of `per_call` reads (pairs) for a run on the CPU.  A cell that
    BENCHMARK.json does not list (its files kept as data) is found by its
    name, `<config>.<traffic>`."""
    config, traffic = cell.split(".")
    w = {x["name"]: x for x in bench()["workloads"]}.get(
        cell, {"config": config, "traffic": traffic})
    cfg = json.loads((BENCH / "configs" / f"{w['config']}.json").read_text())
    if cfg["snps"]:
        cfg["snps"] = bases // 300
    cfg["genome_bases"] = bases
    mix = json.loads((BENCH / "traffic" / f"{w['traffic']}.json").read_text())
    mix["per_call"] = per_call
    mix["check_sample"] = sample
    limits = json.loads((BENCH / "limits" / f"{cell}.json").read_text())["limits"]
    return cfg, json.dumps(cfg).encode(), mix, limits
