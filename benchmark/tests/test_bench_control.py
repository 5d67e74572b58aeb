"""The control (the reference in the program's place, with the guarantee
its configuration names broken) fails the cell's limits."""

import json

import pytest

from benchmark import readings
from benchmark.tests.helpers import tiny


@pytest.mark.parametrize("cell", ["chr21_snp144.se_wgsim",
                                  "ecoli_k12.se_wgsim",
                                  "chr21_snp144.pe_wgsim"])
def test_control_is_not_correct(cell, tmp_path):
    cfg, cfg_bytes, mix, limits = tiny(cell, bases=150_000, per_call=400,
                                       sample=150)
    out = readings.control_numbers(cfg, cfg_bytes, mix, 2**31 + 77, 1, "cpu",
                                   tmp_path)
    assert out["checked"] == 150
    assert any(out[k] > limits[k] for k in limits), json.dumps(out)
