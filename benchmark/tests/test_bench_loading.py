"""Every configuration, traffic mix, limit set and metric of BENCHMARK.json
is a file the harness finds by name; a cell's options reach the port."""

import json

import pytest

from benchmark import run
from benchmark.tests.helpers import BENCH, bench, tiny


def test_every_cell_finds_its_files():
    b = bench()
    configs = {c["name"] for c in b["configs"]}
    for w in b["workloads"]:
        assert w["config"] in configs
        c = run.load_cell(w["name"], b)
        assert c["cfg"]["name"] == w["config"]
        assert c["mix"]["mode"] in ("se", "pe")
        assert c["limits"] and set(c["limits"]) <= {
            "fields_wrong", "hits_wrong", "records_wrong"}
        assert set(c["cfg"]["control"]) <= {"snp_blind", "max_diff"}
        e2e, layer = run.cell_metrics(b, w["name"])
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
        assert layer


@pytest.mark.parametrize("name", [m["name"] for m in bench()["end_to_end"]]
                         + [m["name"] for m in bench()["per_layer"]])
def test_metric_reader_loads(name):
    assert callable(run.load_reader(name))


def test_config_files_hold_their_reduced_keys():
    for c in bench()["configs"]:
        cfg = json.loads((BENCH.parent / c["file"]).read_text())
        assert c["source"] == cfg["source"]
        assert set(c["reduced"]) == set(cfg["reduced"])
        for k in c["reduced"]:
            assert k in cfg


def test_aln_args_reach_the_aligner(tmp_path):
    """A configuration's and a mix's `aln_args` are the options the
    port's `aln` builds its aligner with; `idx_args` reach `idx`."""
    from benchmark import genome

    cfg, _b, mix, _l = tiny("ecoli_k12.se_wgsim", bases=30_000)
    cfg["aln_args"] = ["--sa-mode", "sampled"]
    cfg["idx_args"] = ["-k", "19"]          # after the harness's own -k
    mix["aln_args"] = ["--max-locate", "500"]
    gen = genome.make_genome(cfg)
    prefix = tmp_path / "idx"
    assert run.ensure_index(cfg, gen, prefix) > 0
    assert json.loads((tmp_path / "idx.salt.json").read_text())["l_seed"] == 19
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "idx.salt.json", "idx.salt.npz"]
    assert run.ensure_index(cfg, gen, prefix) == 0
    al, opts, _t_load, _t_al = run.build_aligner(
        str(prefix), False, "cpu", run.aln_args(cfg, mix))
    assert opts.sa_mode == "sampled" and opts.max_locate == 500
    assert opts.l_overlap == 19 and opts is al.opts
