"""The level cell (``level_1M.static_dynamic``): a static layer built
once, each frame's dynamic layer built alone and merged into it, the
union scanned.  On the CPU at a tiny size: the cell runs and is correct,
the control and two faults come out as not correct, and the merge's
readers read a hand-made trace and find nothing without their span."""

import sys
import time
from types import SimpleNamespace

import pytest
import torch

from bpbench import check, control, harness, roofline, stages, traffic
from bpbench import trace as tracing
from bpbench.calls import merge_static
from bpbench.motions import walk
from broadphase_tpu_torch import layer, profiling

from conftest import all_cells

CELL = "level_1M.static_dynamic"
SEED = 2 ** 31 + 17
# 3,000 boxes at the tiny density of conftest.py's boxes3d_1M, half static
TINY = {"objects": 3000, "static_objects": 1500,
        "scene": {"kind": "level", "density": 2.4e-5, "size_min": 1.0,
                  "size_max": 10.0}}
MERGE = ["merge.device_ms", "merge_roofline", "merge.host_ms"]
H100 = "NVIDIA H100 80GB HBM3"


def run_tiny(monkeypatch=None, trace=False, device="cpu", seed=SEED):
    if monkeypatch is not None:
        monkeypatch.setattr(sys, "argv", [
            "bpbench/run.py", "--workload", CELL, "--seed", str(seed),
            "--seconds", "0.3", "--trace", str(int(trace))])
    return harness.run_cell(CELL, seed, 0.3, trace, device,
                            time.perf_counter(), all_cells(),
                            config_overrides=TINY)


def test_the_cell_runs_and_is_correct():
    r = run_tiny()
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 1
    assert set(r["checks"]) == {"tree_diff", "pairs_diff", "frames_checked"}
    bench = harness.load_bench()
    assert sorted(r["metrics"]) == sorted(
        m["name"] for m in bench["end_to_end"]
        if CELL in m.get("workloads", [CELL]))


def test_the_frame_is_the_ports_normal_path(monkeypatch):
    """Each frame builds the dynamic objects alone at their own capacity,
    merges them into the static layer built once at the union's, and
    scans the merged layer."""
    calls = []
    real_build, real_merge = layer.build, layer.merge

    def build(spec, smin, smax, bmin, bmax, ids, **k):
        calls.append(("build", int(ids[0]), ids.shape[0], k["out_capacity"]))
        return real_build(spec, smin, smax, bmin, bmax, ids, **k)

    def merge(spec, state, other):
        calls.append(("merge", state.keys.shape[0], other.keys.shape[0]))
        return real_merge(spec, state, other)

    monkeypatch.setattr(layer, "build", build)
    monkeypatch.setattr(layer, "merge", merge)
    bench = all_cells()
    w = harness.workload(bench, CELL)
    config = {**harness.config_of(bench, w), **TINY}
    cell = harness.Cell(config, traffic.load_json("traffic", w["traffic"]),
                        SEED, "cpu")
    union, dyn = cell.caps.tree, 6144        # tree_capacity(1500, 37)
    assert calls == [("build", 0, 1500, union)]
    calls.clear()
    _, out, _ = harness.run_frame(cell, 1, harness._no_span)
    assert calls == [("build", 1500, 1500, dyn), ("merge", union, dyn)]
    assert bool(out["tree"].sorted) and int(out["pairs"].count) > 0


def test_the_static_half_stays_and_the_dynamic_half_walks():
    bench = all_cells()
    w = harness.workload(bench, CELL)
    config = {**harness.config_of(bench, w), **TINY}
    cell = harness.Cell(config, traffic.load_json("traffic", w["traffic"]),
                        SEED, "cpu")
    bmin = cell.ring["bounds_min"]
    assert bmin.shape == (16, 3000, 3)
    assert (bmin[:, :1500] == bmin[0, :1500]).all()
    step = (bmin[1:, 1500:] - bmin[:-1, 1500:]).abs()
    assert (step.amax(dim=(1, 2)) > 0.4).all() and (step <= 0.5001).all()
    size = cell.ring["bounds_max"] - bmin     # kept, to f32 rounding
    assert torch.allclose(size, size[0].expand_as(size), atol=1e-4)
    assert (cell.ring["bounds_max"] <= cell.scene.system_max_t).all()


def test_the_control_fails_a_number():
    nums = control.control_numbers(CELL, 11, "cpu", all_cells(),
                                   config_overrides=TINY)
    ok, checks = check.verdict(nums, 1)
    assert not ok, checks


def _stale_static(monkeypatch):
    """The static layer built from where its objects stood one walk step
    away: a precomputed layer not rebuilt after the level moved."""
    real = merge_static.prepare

    def prepare(cell):
        real(cell)
        c, s = cell.config, cell.config["static_objects"]
        moved = walk.ring(cell.scene, {"step": 0.5}, 2,
                          traffic.generator(5, "cpu"))
        cell.static = layer.build(
            cell.spec, cell.scene.system_min_t, cell.scene.system_max_t,
            moved["bounds_min"][1][:s], moved["bounds_max"][1][:s],
            cell.scene.ids[:s], slots_per_axis=c["slots_per_axis"],
            min_depth=c["min_depth"], out_capacity=cell.caps.tree)
    monkeypatch.setattr(merge_static, "prepare", prepare)


def _dynamic_drops_its_last_object(monkeypatch):
    real = layer.build

    def build(spec, smin, smax, bmin, bmax, ids, **k):
        if int(ids[0]) != 0:             # the dynamic half's ids
            bmin, bmax, ids = bmin[:-1], bmax[:-1], ids[:-1]
        return real(spec, smin, smax, bmin, bmax, ids, **k)
    monkeypatch.setattr(layer, "build", build)


@pytest.mark.parametrize("fault", [_stale_static,
                                   _dynamic_drops_its_last_object],
                         ids=lambda f: f.__name__[1:])
def test_a_fault_makes_the_run_incorrect(monkeypatch, fault):
    fault(monkeypatch)
    r = run_tiny()
    assert r["correct"] is False, r["checks"]


def span(name, start, end):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": start,
            "dur": end - start}


def launch(corr, at, kernel_start, kernel_end):
    return [{"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
             "ts": at, "dur": 0.5, "args": {"correlation": corr}},
            {"ph": "X", "cat": "kernel", "name": f"op{corr}",
             "ts": kernel_start, "dur": kernel_end - kernel_start,
             "args": {"correlation": corr}}]


def sync(name, start, end):
    return {"ph": "X", "cat": "cuda_runtime", "name": name, "ts": start,
            "dur": end - start}


def _trace(span_s, span_ops, cells):
    return tracing.Trace(len(cells), 1e-3, 5e-4, 100, span_s, span_ops,
                         cells, [9 * c for c in cells], [], [])


def test_the_merge_readers_read_a_hand_made_trace():
    config = harness.config_of(all_cells(),
                               harness.workload(all_cells(), CELL))
    cells = [3_280_000, 3_290_000]
    run = SimpleNamespace(trace=_trace({"layer.merge": 6e-4},
                                       {"layer.merge": 30}, cells),
                          config=config, device_kind=H100)
    assert harness._reader("merge.device_ms")(run) == pytest.approx(0.3)
    # both live trees read once, the merged tree written once: 2 x 12 B
    # an entry of Index64_3D (an 8-byte key and a 4-byte id)
    nbytes = 2 * 12 * sum(cells)
    assert harness._reader("merge_roofline")(run) == pytest.approx(
        100 * nbytes / 3.35e12 / 6e-4)
    assert 0 < harness._reader("merge_roofline")(run) < 100
    assert roofline.tree_bytes(config, 1) == 12


def test_the_merge_readers_find_nothing_without_the_span():
    run = SimpleNamespace(trace=_trace({"layer.build": 1e-3},
                                       {"layer.build": 90}, [10, 10]),
                          config={}, device_kind=H100)
    assert harness._reader("merge.device_ms")(run) is None
    assert harness._reader("merge_roofline")(run) is None
    run = SimpleNamespace(trace=None, config={}, device_kind=H100)
    assert all(harness._reader(m)(run) is None for m in MERGE)


def test_a_traced_cpu_run_reports_the_merge_host_time(monkeypatch, capfd):
    r = run_tiny(monkeypatch, trace=True)
    assert r["correct"] is True
    # no device here: the device quantities stay out
    assert sorted(r["metrics"]) == ["merge.host_ms", "scan.spilled_share"]
    assert r["metrics"]["merge.host_ms"]["value"] > 0
    err = capfd.readouterr().err
    for stage in ("merge.cols", "merge.kernel", "merge.unpack"):
        assert f"{stage} | layer.merge | 1 |" in err
    assert "'merge.entries'" in err


def test_the_merge_host_time_is_nothing_in_a_program_without_the_span(
        monkeypatch):
    """A program whose spans lack ``layer.merge`` (the port before it had
    them) reports no ``merge.host_ms``, and the run goes on."""
    monkeypatch.setattr(profiling, "SPANS", tuple(
        s for s in profiling.SPANS
        if s != "layer.merge" and not s.startswith("merge.")))
    r = run_tiny(monkeypatch, trace=True)
    assert r["correct"] is True and "merge.host_ms" not in r["metrics"]


def test_the_stage_reduction_gives_the_merge_its_layer():
    # pass "off": a frame 0-90 with nothing in it; pass "on": from 100
    events = [span("frame", 0, 90), span("frame", 100, 200),
              span("layer.build", 101, 130), span("layer.merge", 131, 160),
              span("layer.scan", 161, 190), span("frame.readback", 191, 199),
              span("layer.build", 102, 129), span("layer.merge", 132, 159),
              span("merge.cols", 133, 140), span("merge.kernel", 141, 150),
              span("merge.unpack", 151, 158), span("layer.scan", 162, 189),
              sync("cudaMemcpy", 192, 198)]
    events += launch(1, 110, 110, 125) + launch(2, 142, 142, 152)
    events += launch(3, 165, 165, 185)
    st = stages.reduce(events, ["layer.build", "layer.merge", "layer.scan"],
                       profiling.SPANS, 1, {"merge.entries": 7}, 80e-6)
    us = 1e-6
    assert st.host_s["layer.merge"] == pytest.approx(29 * us)
    assert st.rows["layer.merge"].calls == 1       # the program's alone
    assert st.rows["merge.kernel"].device_s == pytest.approx(10 * us)
    assert st.rows["merge.cols"].ops == 0
    assert st.layer_of["merge.unpack"] == "layer.merge"
    got = harness._reader("merge.host_ms")(SimpleNamespace(stages=st))
    assert got == pytest.approx(0.029)


@pytest.mark.card
def test_the_cell_is_correct_on_the_card(monkeypatch, card):
    r = run_tiny(monkeypatch, trace=True, device=card, seed=2 ** 31 + 99)
    assert r["correct"] is True and r["failed"] == 0, r["checks"]
    assert set(MERGE) <= set(r["metrics"])
    assert 0 < r["metrics"]["merge_roofline"]["value"] < 100
