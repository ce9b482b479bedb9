"""Runs of every cell, end to end, at tiny sizes on the CPU through the
program's plain kernels; the result line's keys; adding a mix by adding
files; the import rules."""

import json
import os
import shutil
import subprocess
import sys
import time

import pytest

from bpbench import harness

from conftest import CELLS, REPO, all_cells, tiny

CONTRACT_KEYS = ["correct", "attempted", "failed", "metrics", "device",
                 "checks"]


def run_tiny(cell, trace=False, seconds=0.3):
    return harness.run_cell(cell, 2 ** 31 + 17, seconds, trace, "cpu",
                            time.perf_counter(), all_cells(),
                            config_overrides=tiny(cell))


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_runs_and_is_correct(cell):
    r = run_tiny(cell)
    assert list(r) == CONTRACT_KEYS
    assert r["correct"] is True and r["failed"] == 0
    assert r["attempted"] >= 1
    bench = harness.load_bench()
    assert sorted(r["metrics"]) == sorted(
        m["name"] for m in bench["end_to_end"]
        if cell in m.get("workloads", [cell]))
    assert set(r["device"]) == {"platform", "kind", "count",
                                "memory_peak_bytes"}
    assert r["checks"]["frames_checked"]["value"] >= 1


def test_a_window_slower_than_its_warm_up_still_checks_a_frame(monkeypatch):
    """A host that slows down after the warm-up closes the window before
    the sampled frame comes: the window's last frame is checked instead."""
    real, calls = harness.run_frame, []

    def slow(cell, number, span):
        calls.append(number)
        if len(calls) > 30:      # past the warm-up's 2 x 16 - 2 frames
            time.sleep(0.3)
        return real(cell, number, span)

    monkeypatch.setattr(harness, "run_frame", slow)
    r = run_tiny("boxes3d_1M.rebuild")
    assert r["attempted"] == 1
    assert r["correct"] is True
    assert r["checks"]["frames_checked"]["value"] == 1


def test_traced_run_has_the_trace_keys():
    r = run_tiny("boxes3d_1M.rebuild", trace=True)
    assert list(r) == CONTRACT_KEYS[:5] + ["breakdown", "checks"]
    assert {"busy_s", "window_s"} <= set(r["device"])
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    # no device here: every per-layer reader finds nothing to read
    assert r["metrics"] == {}


def _copy_checkout(tmp_path):
    """BENCHMARK.json and bpbench/ copied, the program linked."""
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(REPO / "bpbench", tmp_path / "bpbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return tmp_path


def test_a_mix_is_added_by_adding_files(tmp_path):
    root = _copy_checkout(tmp_path)
    os.symlink(REPO / "broadphase_tpu_torch", root / "broadphase_tpu_torch")
    before = {p: p.read_bytes() for p in (root / "bpbench").rglob("*.*")}
    (root / "bpbench" / "traffic" / "throwaway.json").write_text(json.dumps(
        {"motion": {"kind": "ballistic", "speed_max": 0.003}, "ring": 5,
         "calls": ["build", "pick_ray", "scan"], "canonical": False,
         "ray": {"origin": [0.5, 0.0], "start": 0.2, "span": 0.5,
                 "period": 7, "x_scale": 1.0, "max_distance": 1.5},
         "check_frames": 3}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "ballpit2d_10k", "source": "a test",
                             "file": "bpbench/configs/ballpit2d_10k.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "ballpit2d_10k.throwaway",
                               "config": "ballpit2d_10k",
                               "traffic": "throwaway", "chips": 1,
                               "why": "a test"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("import json, sys, time; sys.path.insert(0, '.'); "
            "from bpbench import harness; "
            "r = harness.run_cell('ballpit2d_10k.throwaway', 5, 0.3, False, "
            "'cpu', time.perf_counter(), config_overrides={'objects': 400});"
            " print(json.dumps(r))")
    res = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    r = json.loads(res.stdout.strip().splitlines()[-1])
    assert r["correct"] is True and r["checks"]["pick_gap"]["value"] == 0
    after = {p: p.read_bytes() for p in (root / "bpbench").rglob("*.*")
             if p.suffix in (".py", ".json")}
    assert {p for p in after if p not in before} == {
        root / "bpbench" / "traffic" / "throwaway.json"}
    assert all(after[p] == before[p] for p in after if p in before)


BLOCKER = """
import sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in ('jax', 'jaxlib', 'flax', 'broadphase_tpu'):
            raise ImportError('blocked: ' + name)
sys.meta_path.insert(0, Block())
"""


def test_no_module_of_jax_or_the_jax_package_is_imported():
    code = BLOCKER + (
        "import time, pkgutil, importlib; sys.path.insert(0, '.');"
        "import bpbench;"
        "[importlib.import_module(m.name) for m in pkgutil.walk_packages("
        "bpbench.__path__, 'bpbench.') if '.tests' not in m.name];"
        "from bpbench import harness;"
        "[harness._reader(p.stem) for p in (harness.traffic.ROOT / "
        "'metrics').glob('*.py')];"
        "sys.path.insert(0, 'bpbench/tests'); from conftest import "
        "all_cells;"
        "r = harness.run_cell('ballpit2d_10k.frame', 3, 0.2, True, 'cpu', "
        "time.perf_counter(), all_cells(), {'objects': 300});"
        "assert r['correct'] and not harness.foreign_modules();"
        "assert 'broadphase_tpu_torch' in sys.modules")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]


def test_the_reference_loads_without_the_program():
    code = BLOCKER.replace("'broadphase_tpu')", "'broadphase_tpu', "
                           "'broadphase_tpu_torch', 'torch')") + (
        "sys.path.insert(0, '.');"
        "import importlib.util as u;"
        "s = u.spec_from_file_location('ref', "
        "'bpbench/reference/broadphase.py');"
        "m = u.module_from_spec(s); s.loader.exec_module(m)")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]


def test_foreign_modules_compares_whole_top_level_names(monkeypatch):
    for name in ("broadphase_tpu_torch.layer", "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert harness.foreign_modules() == []
    monkeypatch.setitem(sys.modules, "broadphase_tpu.layer", sys)
    monkeypatch.setitem(sys.modules, "jax", sys)
    assert harness.foreign_modules() == ["broadphase_tpu.layer", "jax"]


def _run_py(cwd, env=None):
    return subprocess.run(
        [sys.executable, "bpbench/run.py", "--workload",
         "boxes3d_1M.rebuild", "--seed", "1", "--seconds", "1", "--trace",
         "0"], cwd=cwd, capture_output=True, text=True, timeout=300,
        env=env)


def test_without_a_card_the_run_fails_with_no_result():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    res = _run_py(REPO, env)
    assert res.returncode == 2 and res.stdout.strip() == ""


def test_without_the_program_the_run_fails_with_no_result(tmp_path):
    res = _run_py(_copy_checkout(tmp_path))
    assert res.returncode != 0 and res.stdout.strip() == ""


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_is_correct_on_the_card(card, cell):
    r = harness.run_cell(cell, 2 ** 31 + 99, 1.0, False, card,
                         time.perf_counter(), all_cells(),
                         config_overrides=tiny(cell))
    assert r["correct"] is True and r["failed"] == 0, r["checks"]
