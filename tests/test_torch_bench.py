"""The port's benchmark (``broadphase_tpu_torch.bench``) against the JAX
package's ``bench.py``: the same scenes, draws and capacities; its four
configurations new to the card (the wide-id step, the ``Index64_2D`` step,
the ball pit and the merge + filtered scan) run on the CPU at small sizes
and equal ``broadphase_tpu.layer``'s ``build`` / ``scan`` / ``merge`` /
``scan_filtered`` on the same inputs and capacities (count, overflow,
pairs); the record has every key of ``bench.py``'s and folds every check
and every overflow flag in; the entry point refuses to run without a
card.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import bench as jbench
from broadphase_tpu import Index32_2D as J32_2D
from broadphase_tpu import Index64_2D as J64_2D
from broadphase_tpu import Index64_3D as J64_3D
from broadphase_tpu import bench_caps as jcaps
from broadphase_tpu import layer as jl
from broadphase_tpu_torch import bench, bench_caps, layer
from broadphase_tpu_torch.tools.profile_update import moving_scene

REPO = Path(__file__).resolve().parent.parent


def _rounded(k, n):
    return ((k * n) // 1024) * 1024


@pytest.mark.parametrize("n", [3000, 20_000, 1_000_000])
def test_caps_match_bench_py(n):
    # bench.py:98-102, :338-339, :369-371, :300-301, :696-699
    assert bench.step_caps(n) == (jcaps.tree_capacity(n),
                                  jcaps.pair_capacity(n),
                                  jcaps.emit_capacity(n))
    assert bench.wide_caps(n) == (
        jcaps.tree_capacity(n),
        jcaps.emit_capacity(n, 18 if n >= 500_000 else 40))
    assert bench.index64_2d_caps(n) == (_rounded(3, n), _rounded(1, n),
                                        _rounded(3, n))
    assert bench.ball_pit_caps(n) == (_rounded(24, n), _rounded(32, n))
    assert bench.merge_caps(n) == (4 * (n // 2), 4 * n, _rounded(10, n),
                                   _rounded(16, n))


@pytest.mark.parametrize("dim", [2, 3])
def test_scenes_match_bench_py(dim):
    for got, want in zip(bench_caps.bench_scene(dim, 3000),
                         jbench._scene(dim, 3000)):
        np.testing.assert_array_equal(got, want)
    if dim == 3:
        # bench.py:335: ids offset by 2^25
        *rest, ids = jbench._scene(3, 3000)
        for got, want in zip(bench.wide_scene(3000),
                             (*rest, (ids + (1 << 25)).astype(np.uint32))):
            np.testing.assert_array_equal(got, want)
            assert got.dtype == want.dtype


def test_ball_pit_draws_match_bench_py():
    # bench.py:289-294
    rng = np.random.default_rng(0)
    radius = rng.uniform(0.004, 0.01, 1000).astype(np.float32)
    pos = rng.uniform(0.05, 0.95, (1000, 2)).astype(np.float32)
    want = (pos, radius, np.zeros(2, np.float32), np.ones(2, np.float32),
            np.arange(1000, dtype=np.uint32))
    for got, w in zip(bench.ball_pit_scene(1000), want):
        np.testing.assert_array_equal(got, w)
        assert got.dtype == w.dtype


@pytest.mark.parametrize("frac", [0.005, 0.10])
def test_update_motion_matches_bench_py(frac):
    # bench.py:586-593: seed 3, uniform(-5, 5) jumps, a 1e-4 drift
    n = 3000
    smin, smax, bmin, bmax, ids = jbench._scene(3, n)
    rng = np.random.default_rng(3)
    moving = rng.random(n) < frac
    jump = (rng.uniform(-5.0, 5.0, size=bmin.shape).astype(np.float32)
            * moving[:, None])
    drift = np.float32(1e-4)
    want = (smin, smax, bmin, bmax, ids, bmin + jump + drift,
            bmax + jump + drift)
    for got, w in zip(moving_scene(n, frac), want):
        np.testing.assert_array_equal(got, w)


# ---------------------------------------------------------------------------
# Configurations 4-7 on the CPU against the JAX package
# ---------------------------------------------------------------------------

def _jax_pairs(res):
    cnt = int(res.count)
    return np.stack([np.asarray(res.pairs_a)[:cnt],
                     np.asarray(res.pairs_b)[:cnt]], axis=1)


def _jax_wide(n):
    tree_cap, pair_cap = bench.wide_caps(n)
    st = jl.build(J64_3D, *bench.wide_scene(n), out_capacity=tree_cap)
    return jl.scan(J64_3D, st, pair_cap)


def _jax_2d(n):
    tree_cap, pair_cap, emit_cap = bench.index64_2d_caps(n)
    st = jl.build(J64_2D, *bench_caps.bench_scene(2, n),
                  out_capacity=tree_cap)
    return jl.scan(J64_2D, st, pair_cap, emit_capacity=emit_cap)


def _jax_ball_pit(n):
    pos, radius, smin, smax, ids = bench.ball_pit_scene(n)
    pair_cap, emit_cap = bench.ball_pit_caps(n)
    r = radius[:, None]
    st = jl.build(J32_2D, smin, smax, pos - r, pos + r, ids, min_depth=4)
    return jl.scan(J32_2D, st, pair_cap, emit_capacity=emit_cap)


def _jax_merge(n):
    smin, smax, bmin, bmax, ids = bench_caps.bench_scene(3, n)
    static_cap, dyn_cap, pair_cap, emit_cap = bench.merge_caps(n)
    half = n // 2
    static = jl.build(J64_3D, smin, smax, bmin[:half], bmax[:half],
                      ids[:half], out_capacity=static_cap)
    dyn = jl.build(J64_3D, smin, smax, bmin[half:], bmax[half:], ids[half:],
                   out_capacity=dyn_cap)
    merged = jl.merge(J64_3D, dyn, static)
    return jl.scan_filtered(J64_3D, merged, pair_cap,
                            lambda a, b: (a % 2) == (b % 2), emit_cap)


CONFIGS = {
    # name: (the port's configuration on the CPU, the JAX package's)
    "wide": (lambda: bench.bench_full_step_wide(3000, "cpu", iters=0),
             lambda: _jax_wide(3000)),
    "index64_2d": (lambda: bench.bench_index64_2d(5000, "cpu", iters=0),
                   lambda: _jax_2d(5000)),
    "ball_pit": (lambda: bench.bench_ball_pit_2d(1000, "cpu", iters=0),
                 lambda: _jax_ball_pit(1000)),
    "merge_filtered": (lambda: bench.bench_merge_scan_filtered(
        4000, "cpu", iters=0), lambda: _jax_merge(4000)),
}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_configuration_matches_jax(name):
    port, jax_run = CONFIGS[name]
    out = port()
    st, res = out["result"]
    jst, jres = jax_run()
    assert int(res.count) == int(jres.count) == out["pairs"]
    assert bool(res.overflow) == bool(jres.overflow)
    assert bool(st.overflow) == bool(jst.overflow)
    assert int(st.count) == int(jst.count)
    np.testing.assert_array_equal(layer.scan_result_to_numpy(res),
                                  _jax_pairs(jres))
    assert out["overflow"] == (bool(jst.overflow) or bool(jres.overflow))
    # the bench's own reference agrees (the oracle, or the CPU path)
    assert out["verified"] or out["overflow"]
    assert out["p50_ms"] is None


def test_wide_ids_switch_the_rule_off_and_keep_the_pairs():
    out = bench.bench_full_step_wide(3000, "cpu", iters=0)
    _, res = out["result"]
    assert out["verified"] and not out["overflow"]
    got = layer.scan_result_to_numpy(res)
    assert got.min() >= 1 << 25
    want = bench.oracle_pairs(bench_caps.bench_scene(3, 3000))
    np.testing.assert_array_equal(got - np.uint32(1 << 25), want)


# ---------------------------------------------------------------------------
# The record
# ---------------------------------------------------------------------------

def _bench_py_record_keys():
    """The keys of the JSON record ``bench.py``'s ``child_main`` prints."""
    tree = ast.parse((REPO / "bench.py").read_text())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "child_main")
    dicts = [n for n in ast.walk(fn) if isinstance(n, ast.Dict)
             and any(isinstance(k, ast.Constant) and k.value == "metric"
                     for k in n.keys)]
    assert len(dicts) == 1
    return {k.value for k in dicts[0].keys}


def _results():
    ok = {"overflow": False, "verified": True}
    step = {**ok, "n": 1_000_000, "p50_ms": 4.0, "blocking_p50_ms": 5.0,
            "pairs": 8_531_205, "peak_memory_gib": 1.5}
    return {
        "verify_30k": dict(ok),
        "full_step_10k": {**step, "n": 10_000},
        "full_step_1M": step,
        "unsorted_1M": {**ok, "p50_ms": 2.5, "pairs": 8_531_205},
        "wide_1M": {**ok, "p50_ms": 7.0, "pairs": 8_531_205,
                    "peak_memory_gib": 2.0},
        "index64_2d_1M": {**ok, "p50_ms": 3.0, "pairs": 301_299,
                          "cells": 2_394_361, "peak_memory_gib": 0.5},
        "ball_pit_2d_10k": {**ok, "p50_ms": 3.5, "pairs": 176_365,
                            "cells": 28_633},
        "merge_scan_filtered_1M": {**ok, "p50_ms": 5.0, "pairs": 4_000_000},
        "update_sweep_1M": {**ok, "sweep": {0.005: 15.0, 0.01: 16.0,
                                            0.03: 17.0, 0.10: 20.0},
                            "build_p50_ms": 2.0, "break_even_frac": 0.0},
        "queries_100k": {**ok, "p50_ms": {"test_box[tree]": 2.0}},
        "single_query_1M": {**ok, "ms": {"test_box": 3.0}},
        "queries_batched_100k": {**ok, "us": {"test_box": 200.0}},
        "ball_pit_lifecycle": {"ms_frame": 9.0, "collisions": 100,
                               "verified": True},
    }


def test_record_has_every_key_of_bench_py():
    rec = bench.record(_results(), "NVIDIA H100 80GB HBM3, 700.00 W")
    assert _bench_py_record_keys() <= set(rec)
    assert {"device", "ball_pit_2d_10k_p50_ms", "peak_memory_gib"} <= \
        set(rec)
    assert rec["metric"] == "full_step_1M_p50_ms" and rec["value"] == 4.0
    assert rec["vs_baseline"] == pytest.approx(1e6 / 4.0 / (1e4 / 6.0))
    assert rec["verified"] is True and rec["overflow"] is False
    assert rec["update_1M_p50_ms"] == 17.0
    assert rec["update_1M_sweep_ms"] == {"0.005": 15.0, "0.010": 16.0,
                                         "0.030": 17.0, "0.100": 20.0}
    assert rec["peak_memory_gib"] == {"full_step_1M": 1.5,
                                      "full_step_1M_wide": 2.0,
                                      "index64_2d_1M": 0.5}
    assert rec["device"] == "NVIDIA H100 80GB HBM3, 700.00 W"


@pytest.mark.parametrize("key", list(_results()))
def test_one_failed_check_fails_the_record(key):
    r = _results()
    r[key]["verified"] = False
    rec = bench.record(r, "card")
    assert rec["verified"] is False and rec["overflow"] is False
    assert rec["unsorted_set_verified"] is (key != "unsorted_1M")


@pytest.mark.parametrize("key", [k for k in _results()
                                 if k != "ball_pit_lifecycle"])
def test_one_overflow_sets_the_record_flag(key):
    r = _results()
    r[key]["overflow"] = True
    rec = bench.record(r, "card")
    assert rec["overflow"] is True and rec["verified"] is True
    assert rec["single_query_overflow"] is (key == "single_query_1M")


def test_lifecycle_runs_the_port_demo_and_parses_its_summary():
    assert bench.parse_ball_pit_summary(
        "frame    0: balls: 2\n240 frames, 2500 ball slots, 9.87 ms/frame, "
        "total collisions 4242\n") == (9.87, 4242)
    assert bench.parse_ball_pit_summary("no summary\n") == (None, None)
    out = bench.bench_ball_pit_lifecycle(100, "cpu", frames=20)
    assert out["verified"] and out["ms_frame"] > 0
    assert out["collisions"] >= 0


def test_main_without_a_card_exits_non_zero():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    env["CUDA_VISIBLE_DEVICES"] = ""   # hide a card on any host
    out = subprocess.run([sys.executable, "-m", "broadphase_tpu_torch.bench"],
                         capture_output=True, text=True, timeout=300,
                         env=env, cwd=REPO)
    assert out.returncode != 0
    assert "{" not in out.stdout
    assert "CUDA" in out.stderr
