"""Nothing the harness or the reference imports is JAX or salt_tpu; the
reference imports nothing of the program either.  Module names are
compared by their whole top-level name."""

import json
import subprocess
import sys

from benchmark.tests.helpers import ROOT

PROBE = """
import json, sys
sys.path.insert(0, {root!r})
{imports}
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""


def _top_level(imports: str):
    out = subprocess.run(
        [sys.executable, "-c", PROBE.format(root=str(ROOT), imports=imports)],
        capture_output=True, text=True, check=True, cwd=str(ROOT),
        env={"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu"})
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_reference_imports_nothing_of_the_program():
    mods = _top_level("import benchmark.reference, benchmark.genome, "
                      "benchmark.traffic, benchmark.trace")
    assert not mods & {"jax", "jaxlib", "flax", "salt_tpu", "salt_tpu_torch"}


def test_harness_and_program_import_no_jax():
    mods = _top_level(
        "import benchmark.run as r\n"
        "import salt_tpu_torch.cli, salt_tpu_torch.pipeline.engine, "
        "salt_tpu_torch.pipeline.pe_engine, salt_tpu_torch.index.build, "
        "salt_tpu_torch.index.store, salt_tpu_torch.ops.lv_cuda, "
        "salt_tpu_torch.ops.sw_cuda, salt_tpu_torch.utils.native\n"
        "assert not r.forbidden_modules()")
    assert "salt_tpu_torch" in mods
    assert not mods & {"jax", "jaxlib", "flax", "salt_tpu"}
