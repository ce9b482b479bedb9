"""The port stands without JAX: ``broadphase_tpu_torch`` and ``chip_smoke``
import, and a small step runs, in a process where importing ``jax``,
``jaxlib`` or ``broadphase_tpu`` raises.  ``chip_smoke.py`` fails without a
CUDA card, and when it stands alone without the repository.
"""

import os
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

_BLOCKED_RUN = r"""
import sys

class _Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "broadphase_tpu"):
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, _Block())
sys.path.insert(0, sys.argv[1])

import numpy as np
import broadphase_tpu_torch as bt
import chip_smoke
from broadphase_tpu_torch import _jaxfree, convert, layer
from broadphase_tpu_torch.ops import _cuda, build, compact, expand2, prep
from broadphase_tpu_torch.ops import runends, search

caps = _jaxfree.bench_caps()
assert caps.tree_capacity(1_000_000) == 3_700_736
native = _jaxfree.native()
scene = _jaxfree.bench_scene(3, 500)
state = layer.build(bt.Index64_3D, *scene, out_capacity=8 * 500)
_, res = layer.scan(bt.Index64_3D, state, 64 * 500)
keys, ids, _ = native.extend(*scene)
keys, ids = native.sort_tree(keys, ids)
assert np.array_equal(layer.scan_result_to_numpy(res),
                      native.scan_seq(keys, ids))
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "broadphase_tpu"))
assert not loaded, loaded
print("JAXFREE-OK")
"""


def _env():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return env


def test_port_and_smoke_import_without_jax():
    out = subprocess.run([sys.executable, "-c", _BLOCKED_RUN, str(REPO)],
                         capture_output=True, text=True, timeout=300,
                         env=_env(), cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "JAXFREE-OK" in out.stdout


def test_chip_smoke_fails_without_cuda():
    out = subprocess.run([sys.executable, "chip_smoke.py"],
                         capture_output=True, text=True, timeout=300,
                         env=_env(), cwd=REPO)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "CUDA" in out.stderr


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = subprocess.run([sys.executable, "chip_smoke.py"],
                         capture_output=True, text=True, timeout=300,
                         env=_env(), cwd=tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
