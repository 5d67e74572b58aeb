"""Whole runs on the CPU, past the harness's look for a chip: a sound run
comes out correct, and one whose program or answers are broken comes
out not correct, once for each fault an aligner's cell can have: half of
a call's answers left out, an answer altered where it is produced, and,
in PE, rescue left out."""

import json

import pytest

from benchmark import faults, run
from benchmark.tests.helpers import bench, tiny

# at this size the repeat recipe is mostly one satellite array, where
# rescue is not checked; a uniform genome with the configuration's SNPs
# gives the rescue check its work
CASES = [("ecoli_k12.se_wgsim", None, None),
         ("ecoli_k12.se_wgsim", "drop_half", None),
         ("ecoli_k12.se_wgsim", "alter", None),
         ("chr21_snp144.pe_wgsim", None, None),
         ("chr21_snp144.pe_wgsim", "drop_half", None),
         ("chr21_snp144.pe_wgsim", "alter", None),
         ("chr21_snp144.pe_wgsim", None, "uniform"),
         ("chr21_snp144.pe_wgsim", "no_rescue", "uniform")]


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    return tmp_path_factory.mktemp("cache")


@pytest.mark.parametrize("cell, fault, recipe", CASES)
def test_run_judges_faults(cell, fault, recipe, cache):
    cfg, cfg_bytes, mix, limits = tiny(cell, bases=100_000, per_call=300,
                                       sample=300 if recipe else 60)
    if recipe:
        cfg["genome"]["recipe"] = recipe
        cfg_bytes = json.dumps(cfg).encode()
    res = run.run_cell(cell, cfg, cfg_bytes, mix, limits, bench(), 5, 0.0,
                       False, device="cpu",
                       cache_dir=cache / f"{cfg['name']}_{recipe}",
                       sabotage=faults.SABOTAGE.get(fault),
                       plant=faults.PLANT.get(fault))
    assert set(res) == {"correct", "attempted", "failed", "metrics",
                        "device", "checks"}
    assert list(res)[-1] == "checks"
    assert res["attempted"] == 300
    assert res["correct"] is (fault is None), res["checks"]
    if fault is None:
        assert res["failed"] == 0
    e2e = run.cell_metrics(bench(), cell)[0]
    # a metric read from the card finds nothing to read on the CPU
    assert set(res["metrics"]) == {m["name"] for m in e2e
                                   if m["source"] != "device_trace"}


def test_sample_keeps_the_least_keys_of_all_calls():
    from benchmark import traffic
    import numpy as np

    calls = [traffic.Call(np.zeros((50, 4), np.uint8),
                          [f"c{ci}_{i}" for i in range(50)],
                          np.arange(50), np.zeros(50, bool)) for ci in range(3)]
    s = run.Sample(20, 7)
    for ci, c in enumerate(calls):
        s.offer(ci, c, lambda rows, c=c: [c.names[i] for i in rows])
    keys = np.concatenate([np.random.default_rng([7, 3, ci]).random(50)
                           for ci in range(3)])
    names = [n for c in calls for n in c.names]
    want = [names[i] for i in np.argsort(keys)[:20]]
    assert s.names == want and s.lines == want
    assert len(s.codes) == 20
