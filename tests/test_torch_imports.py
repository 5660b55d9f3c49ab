"""Import guard for the port: tracklab_torch and chip_smoke.py import
nothing of JAX or of the JAX package, and import without triton, nvcc or a
GPU."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
BANNED = ("jax", "jaxlib", "flax", "optax", "tracklab_tpu")
PORT_FILES = sorted(p.relative_to(ROOT).as_posix()
                    for p in (ROOT / "tracklab_torch").rglob("*.py")) \
    + ["chip_smoke.py"]


def _imports(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("rel", PORT_FILES)
def test_port_file_imports_nothing_of_jax(rel):
    tree = ast.parse((ROOT / rel).read_text(), filename=rel)
    bad = [m for m in _imports(tree) if m.split(".")[0] in BANNED]
    assert not bad, f"{rel} imports {bad}"


_PROBE = r"""
import importlib, pkgutil, sys
BLOCK = {"jax", "jaxlib", "flax", "optax", "tracklab_tpu", "triton"}
for name in list(sys.modules):
    if name.split(".")[0] in BLOCK:
        del sys.modules[name]

class Blocker:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCK:
            raise ImportError("blocked import: " + name)
        return None

sys.meta_path.insert(0, Blocker())
import tracklab_torch
names = [m.name for m in pkgutil.walk_packages(tracklab_torch.__path__,
                                               "tracklab_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
leaked = sorted(n for n in sys.modules if n.split(".")[0] in BLOCK)
assert not leaked, leaked
print(len(names))
"""


def test_port_imports_in_a_clean_interpreter():
    """A fresh interpreter that blocks JAX, the JAX package and triton, with
    no CUDA toolkit on PATH, imports every module of the port."""
    env = dict(os.environ, CUDA_HOME=str(ROOT / "no-cuda-here"),
               PATH=os.path.dirname(sys.executable),
               PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    assert int(res.stdout.split()[-1]) >= 19


# modules of the ReID slice, the ORU replay kernels and the Deep-OC-SORT /
# BoT-SORT / camera-motion slice, which the checks above must cover
SLICE_MODULES = ("tracklab_torch/ops/embeddings.py",
                 "tracklab_torch/models/osnet.py",
                 "tracklab_torch/kernels/oru_replay.py",
                 "tracklab_torch/trackers/strongsort.py",
                 "tracklab_torch/trackers/deepocsort.py",
                 "tracklab_torch/trackers/botsort.py",
                 "tracklab_torch/motion/lk.py",
                 "tracklab_torch/motion/gmc.py")


@pytest.mark.parametrize("rel", SLICE_MODULES)
def test_slice_modules_are_checked(rel):
    assert rel in PORT_FILES
    test_port_file_imports_nothing_of_jax(rel)
