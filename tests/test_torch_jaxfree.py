"""The port stands without JAX: ``broadphase_tpu_torch`` and ``chip_smoke``
import, and a small step, update, extend + merge, BR_SCENE round trip and
box query (both engines, batched, and the generic walk) run, the CLI's
``gen_boxes`` and ``gen_validation_data`` and a ball-pit frame run, and a
sharded step over two gloo ranks started by ``parallel.run_ranks`` (with
the tests' rank bodies, ``torch_rank_bodies.py``), in a process (and
ranks) where importing ``jax``, ``jaxlib`` or ``broadphase_tpu`` raises;
no file of the port or of the rank bodies loads anything of
``broadphase_tpu/`` by path; its copies of the bench capacities, the
bench scene, the scene generator and the C++ oracle bindings give what
the originals give.  ``chip_smoke.py`` fails without a CUDA card, and
when it stands alone without the repository.
"""

import ast
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import bench
from broadphase_tpu import bench_caps as jcaps
from broadphase_tpu.utils import gen as jgen
from broadphase_tpu.utils import native
from broadphase_tpu_torch import bench_caps, gen, oracle

REPO = Path(__file__).resolve().parent.parent

# Run from a file, so that the ranks the script spawns re-import it as
# their main module: the blocker holds in them too.
_BLOCKED_RUN = r"""
import sys

class _Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "broadphase_tpu"):
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, _Block())
sys.path[:0] = sys.argv[1:3]


def main():
    _single_chip()
    _tools()
    _sharded()
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "broadphase_tpu"))
    assert not loaded, loaded
    print("JAXFREE-OK")


def _sharded():
    import numpy as np
    from broadphase_tpu_torch import bench_caps, layer, parallel
    import broadphase_tpu_torch as bt
    import torch_rank_bodies as bodies

    scene = bench_caps.bench_scene(3, 500)
    case = {"spec": "Index64_3D", "scene": scene,
            "step": {"bucket_capacity": 8 * 500, "pair_capacity": 64 * 500}}
    ranks = parallel.run_ranks(bodies.drive_step, 2, "gloo", "cpu", [case])
    md = parallel.min_depth_for_devices(bt.Index64_3D, 2)
    state = layer.build(bt.Index64_3D, *scene, min_depth=md, device="cpu")
    _, res = layer.scan(bt.Index64_3D, state, 64 * 500)
    want = layer.scan_result_to_numpy(res)
    for rank in ranks:
        assert not rank[0]["result"].overflow
        assert np.array_equal(rank[0]["pairs"], want)


def _tools():
    import os
    import tempfile
    import numpy as np
    import torch
    from broadphase_tpu_torch import gen, scene as br_scene
    from broadphase_tpu_torch.examples import ball_pit
    from broadphase_tpu_torch.tools import __main__ as cli

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "s.br_scene")
        cli.main(["gen_boxes", "--count", "300", "--density", "0.001",
                  "--out", path])
        cli.main(["gen_validation_data", "--in", path, "--out-dir", d,
                  "--device", "cpu"])
        sc = br_scene.load(os.path.join(d, "2_layer_collisions.br_scene"))
        assert sc.collisions.shape[0] > 0
        assert np.array_equal(sc.bounds_min,
                              gen.gen_boxes(300, 0.001).bounds_min)
    sim = ball_pit.make_sim(200, lifecycle=True, device="cpu")
    state = ball_pit.initial_state(sim)
    out = ball_pit.frame(state, sim, ball_pit.lifecycle_draws(
        sim, torch.Generator().manual_seed(0)))
    assert int(out.nalive) == ball_pit.SPAWNS_PER_FRAME
    assert not bool(out.overflow)
    assert int(out.tree.count) >= ball_pit.SPAWNS_PER_FRAME


def _single_chip():
    import numpy as np
    import torch
    import broadphase_tpu_torch as bt
    import chip_smoke
    from broadphase_tpu_torch import (bench_caps, convert, layer, oracle, query,
                                      scene as br_scene, singleq, traverse,
                                      update)
    from broadphase_tpu_torch.ops import _cuda, build, compact, expand, expand2
    from broadphase_tpu_torch.ops import merge, prep, runends, search

    assert bench_caps.tree_capacity(1_000_000) == 3_700_736
    scene = bench_caps.bench_scene(3, 500)
    state = layer.build(bt.Index64_3D, *scene, out_capacity=8 * 500,
                        device="cpu")
    _, res = layer.scan(bt.Index64_3D, state, 64 * 500)
    keys, ids, _ = oracle.extend(*scene)
    keys, ids = oracle.sort_tree(keys, ids)
    assert np.array_equal(layer.scan_result_to_numpy(res),
                          oracle.scan_seq(keys, ids))
    tracked = update.build_tracked(bt.Index64_3D, *scene, out_capacity=8 * 500,
                                   device="cpu")
    moved = update.update(bt.Index64_3D, tracked, scene[0], scene[1],
                          scene[2] + 3.0, scene[3] + 3.0, 8 * 500)
    assert not bool(moved.state.overflow)
    half = layer.extend(bt.Index64_3D, layer.make_layer(bt.Index64_3D, 8 * 500,
                                                        device="cpu"),
                        scene[0], scene[1], scene[2][:250], scene[3][:250],
                        scene[4][:250])
    rest = layer.build(bt.Index64_3D, scene[0], scene[1], scene[2][250:],
                       scene[3][250:], scene[4][250:], device="cpu")
    merged = layer.sort(bt.Index64_3D, layer.merge(bt.Index64_3D, half, rest))
    assert layer.layers_equal(bt.Index64_3D, merged, state)
    restored = layer.layer_from_scene_layer(
        bt.Index64_3D, br_scene.loads(br_scene.dumps(br_scene.Scene(
            scene[0], scene[1], scene[2], scene[3], scene[4],
            layer.layer_to_scene_layer(bt.Index64_3D, state)))).layer,
        capacity=8 * 500, device="cpu")
    assert layer.layers_equal(bt.Index64_3D, restored, state)
    _, hits = query.test_box(bt.Index64_3D, state, scene[0], scene[1],
                             (scene[2][0], scene[3][0]), 64)
    assert 0 in hits.ids[:int(hits.count)].tolist()
    for engine in ("tree", "linear"):
        _, got = query.test_box(bt.Index64_3D, state, scene[0], scene[1],
                                (scene[2][0], scene[3][0]), 64, engine=engine)
        assert torch.equal(got.ids, hits.ids)
    _, rows = query.test_box_batch(bt.Index64_3D, state, scene[0], scene[1],
                                   (scene[2][:2], scene[3][:2]), 64)
    assert torch.equal(rows.ids[0], hits.ids)
    root, sub = traverse.box_halving_state(bt.Index64_3D, scene[0], scene[1])
    lo, hi = torch.as_tensor(scene[2][0]), torch.as_tensor(scene[3][0])
    _, walk = traverse.test_generic(
        bt.Index64_3D, state, root, sub,
        lambda g: torch.all((g[0] <= hi) & (g[1] >= lo), dim=-1), 64)
    assert torch.equal(walk.ids, hits.ids)


if __name__ == "__main__":
    main()
"""


def _env():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return env


def test_port_and_smoke_import_without_jax(tmp_path):
    script = tmp_path / "blocked_run.py"
    script.write_text(_BLOCKED_RUN)
    out = subprocess.run([sys.executable, str(script), str(REPO),
                          str(REPO / "tests")],
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


def test_copies_match_the_originals():
    for n in (1, 1000, 30_000, 1_000_000):
        assert bench_caps.tree_capacity(n) == jcaps.tree_capacity(n)
        assert bench_caps.pair_capacity(n) == jcaps.pair_capacity(n)
        assert bench_caps.emit_capacity(n) == jcaps.emit_capacity(n)
        for frac in (0.005, 0.01, 0.03, 0.1):
            assert bench_caps.update_caps(n, frac) == \
                jcaps.update_caps(n, frac)
    for got, want in zip(bench_caps.bench_scene(3, 3000, seed=4),
                         bench._scene(3, 3000, seed=4)):
        np.testing.assert_array_equal(got, want)
    scene = bench._scene(3, 3000, seed=4)
    got = oracle.extend(*scene)
    want = native.extend(*scene)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    got = oracle.sort_tree(*got[:2])
    want = native.sort_tree(*want[:2])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(oracle.scan_seq(*got),
                                  native.scan_seq(*want))
    for kw in ({"count": 5000, "density": 1e-3, "seed": 9},
               {"density": 1e-3, "system_bounds": (np.zeros(3, np.float32),
                                                   np.full(3, 40.0,
                                                           np.float32))}):
        got, want = gen.gen_boxes(**kw), jgen.gen_boxes(**kw)
        for field in ("system_min", "system_max", "bounds_min",
                      "bounds_max", "ids"):
            np.testing.assert_array_equal(getattr(got, field),
                                          getattr(want, field))


# a file:line citation of the JAX package (which no program can open)
_CITATION = re.compile(r"^broadphase_tpu/[\w/]+\.py:\d+$")


def _python_files():
    return sorted((REPO / "broadphase_tpu_torch").rglob("*.py")) + \
        [REPO / "chip_smoke.py", REPO / "tests" / "torch_rank_bodies.py"]


@pytest.mark.parametrize("path", _python_files(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_path_into_the_jax_package(path):
    """No module of the port, not chip_smoke.py and not the tests' rank
    bodies imports JAX or the JAX package, names a path inside ``broadphase_tpu/`` other than in a
    file:line citation, or loads a module from a file."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            names = []
        for name in names:
            assert name.split(".")[0] not in ("jax", "jaxlib",
                                              "broadphase_tpu"), name
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            v = node.value
            assert v != "broadphase_tpu", f"{path}: path component {v!r}"
            assert not v.startswith("broadphase_tpu/") or \
                _CITATION.match(v), f"{path}: path {v!r}"
        if isinstance(node, (ast.Attribute, ast.Name)):
            ident = node.attr if isinstance(node, ast.Attribute) else node.id
            assert ident not in ("spec_from_file_location", "exec_module",
                                 "import_module"), f"{path}: {ident}"


def test_kernel_sources_include_nothing_of_the_jax_package():
    for src in sorted((REPO / "broadphase_tpu_torch" / "csrc").glob("*")):
        for line in src.read_text().splitlines():
            if line.lstrip().startswith("#include"):
                assert "broadphase_tpu/" not in line, (src.name, line)
