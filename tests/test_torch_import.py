"""salt_tpu_torch imports neither jax nor any module of salt_tpu, nor the
root bench.py: every module of the package, and chip_smoke, imports in a
fresh interpreter with all three blocked, and without nvcc or a GPU."""

import os
import pkgutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_modules():
    """Every module of the package, found by walking its directory (no
    import, so collection is the same in every worker)."""
    pkg = os.path.join(ROOT, "salt_tpu_torch")
    names = ["salt_tpu_torch"]
    names += [m.name for m in pkgutil.walk_packages([pkg], "salt_tpu_torch.")]
    return sorted(names)


MODULES = _port_modules()

# jax, salt_tpu and the root bench.py are made unimportable, so any import
# of one of them, direct or through another module, fails the subprocess
_PROBE = """
import importlib, sys
BLOCKED = ("jax", "jaxlib", "salt_tpu", "bench")
class _Block:
    def find_spec(self, name, path=None, target=None):
        if name in BLOCKED or name.startswith(tuple(b + "." for b in BLOCKED)):
            raise ImportError("blocked import of " + repr(name))
sys.meta_path.insert(0, _Block())
importlib.import_module(sys.argv[1])
bad = [m for m in sys.modules
       if m in BLOCKED or m.startswith(tuple(b + "." for b in BLOCKED))]
assert not bad, bad
print("ok")
"""


def test_walk_finds_the_package():
    for name in ("salt_tpu_torch.cli", "salt_tpu_torch.constants",
                 "salt_tpu_torch.index.build", "salt_tpu_torch.io.sam",
                 "salt_tpu_torch.ops.lv_cuda", "salt_tpu_torch.ops.sw_cuda",
                 "salt_tpu_torch.ops.ssw", "salt_tpu_torch.pipeline.engine",
                 "salt_tpu_torch.pipeline.pe_engine",
                 "salt_tpu_torch.utils.native",
                 "salt_tpu_torch.parallel.mesh",
                 "salt_tpu_torch.parallel.sharded",
                 "salt_tpu_torch.parallel.sharded_engine",
                 "salt_tpu_torch.parallel.driver",
                 "salt_tpu_torch.sim.genome_gen", "salt_tpu_torch.sim.wgsim",
                 "salt_tpu_torch.etl.snp_etl",
                 "salt_tpu_torch.eval.wgsim_eval",
                 "salt_tpu_torch.eval.readtools",
                 "salt_tpu_torch.tools.bench_configs",
                 "salt_tpu_torch.tools.run_accuracy",
                 "salt_tpu_torch.tools.profile_se",
                 "salt_tpu_torch.tools.oracle_diff",
                 "salt_tpu_torch.tools.bench"):
        assert name in MODULES
    assert len(MODULES) >= 45


def test_no_module_sets_up_a_process_group():
    """One process drives every device and hosts share only part files:
    no module of the port, nor chip_smoke, imports torch.distributed."""
    import re

    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for top, _dirs, files in os.walk(os.path.join(ROOT, "salt_tpu_torch")):
        paths += [os.path.join(top, f) for f in files if f.endswith(".py")]
    assert len(paths) >= len(MODULES)
    pattern = re.compile(r"torch\s*\.\s*distributed|from\s+torch\s+import"
                         r"[^\n]*\bdistributed\b|init_process_group")
    bad = [p for p in paths if pattern.search(open(p).read())]
    assert not bad, bad


def _probe_leaky(tmp_path, source):
    """The probe's subprocess on a module `leaky` made of `source`."""
    (tmp_path / "leaky.py").write_text(source)
    env = dict(os.environ, PYTHONPATH=f"{tmp_path}{os.pathsep}{ROOT}")
    return subprocess.run([sys.executable, "-c", _PROBE, "leaky"], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=120)


def test_probe_refuses_a_salt_tpu_import(tmp_path):
    """The probe fails on a module that imports salt_tpu, even one of its
    modules that does not import jax."""
    res = _probe_leaky(tmp_path, "import salt_tpu.constants\n")
    assert res.returncode != 0 and "blocked import" in res.stderr


def test_probe_refuses_the_root_bench(tmp_path):
    """The probe fails on a module that imports the root bench.py, which
    salt_tpu_torch/tools/bench.py ports and must not import."""
    res = _probe_leaky(tmp_path, "import bench\n")
    assert res.returncode != 0 and "blocked import" in res.stderr


@pytest.mark.parametrize("module", MODULES)
def test_imports_without_jax(module):
    env = dict(os.environ, PATH="/usr/bin:/bin", CUDA_VISIBLE_DEVICES="")
    env.pop("JAX_PLATFORMS", None)
    res = subprocess.run([sys.executable, "-c", _PROBE, module], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_chip_smoke_imports_without_jax():
    env = dict(os.environ, PATH="/usr/bin:/bin", CUDA_VISIBLE_DEVICES="")
    res = subprocess.run(
        [sys.executable, "-c",
         _PROBE.replace("importlib.import_module(sys.argv[1])",
                        "sys.path.insert(0, '.'); import chip_smoke"),
         "chip_smoke"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_gpu_or_repo(tmp_path, alone):
    """With no CUDA device, or copied away from the package, chip_smoke.py
    exits non-zero and prints no result line."""
    script = os.path.join(ROOT, "chip_smoke.py")
    if alone:
        with open(script) as src, open(tmp_path / "chip_smoke.py", "w") as dst:
            dst.write(src.read())
        script = str(tmp_path / "chip_smoke.py")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    res = subprocess.run([sys.executable, script], cwd=os.path.dirname(script),
                         env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
