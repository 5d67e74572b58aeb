"""salt_tpu_torch never imports jax: its modules import in a fresh
interpreter with jax blocked, and without nvcc or a GPU."""

import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MODULES = [
    "salt_tpu_torch",
    "salt_tpu_torch.ops.lv_cuda",
    "salt_tpu_torch.ops.lv",
    "salt_tpu_torch.pipeline.engine",
    "salt_tpu_torch.cli",
]

# jax is made unimportable, so any import of it, direct or through a
# jax-importing salt_tpu module, fails the subprocess
_PROBE = """
import importlib, sys
class _NoJax:
    def find_spec(self, name, path=None, target=None):
        if name == "jax" or name.startswith("jax.") or name == "jaxlib":
            raise ImportError("jax imported by " + repr(name))
sys.meta_path.insert(0, _NoJax())
importlib.import_module(sys.argv[1])
assert "jax" not in sys.modules
print("ok")
"""


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
