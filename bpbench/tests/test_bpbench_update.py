"""The update cell (``boxes3d_1M.update_1pct``): its entry in
``BENCHMARK.json``, and the update's readers: each reads a hand-made
trace as computed by hand and finds nothing without a trace; a traced
CPU run reports what a CPU can show, and a program without the update's
span or counters (the port before it had them) reports none of its
metrics and runs on."""

import ast
import re
import sys
import time
from types import SimpleNamespace

import pytest

from bpbench import harness, roofline, stages
from bpbench import trace as tracing
from broadphase_tpu_torch import profiling

from conftest import all_cells, tiny

CELL = "boxes3d_1M.update_1pct"
SEED = 2 ** 31 + 17
UPDATE = ["update.device_ms", "update.ops_per_frame", "update.host_ms",
          "update.idle_ms", "update_roofline", "update.changed_share"]
# read from the pass with the program's spans on (``stages.py``)
STAGED = ["update.host_ms", "update.idle_ms", "update.changed_share"]
H100 = "NVIDIA H100 80GB HBM3"


def _config():
    bench = all_cells()
    return harness.config_of(bench, harness.workload(bench, CELL))


def test_the_cell_and_its_metrics_are_declared():
    bench = harness.load_bench()
    assert harness.workload(bench, CELL) == {
        "name": CELL, "config": "boxes3d_1M_sleeping",
        "traffic": "update_1pct", "chips": 1,
        "why": harness.workload(bench, CELL)["why"]}
    per_layer = {m["name"]: m for m in bench["per_layer"]}
    for name in UPDATE:
        m = per_layer[name]
        assert (m["layer"], m["moves"], m["workloads"]) == (
            "update.update", "frame_ms", [CELL])
    p95 = next(m for m in bench["end_to_end"] if m["name"] == "frame_ms_p95")
    assert CELL not in p95["workloads"]


def test_the_sleeping_world_is_boxes3d_1M_in_all_the_harness_reads():
    """The sleeping world's scene, index and capacities are the rebuild's,
    so both draw the same boxes at one seed; only its source and what it
    guarantees of the persistent tree differ."""
    bench = harness.load_bench()
    sleeping = harness.config_of(bench, harness.workload(bench, CELL))
    boxes = harness.config_of(bench, harness.workload(bench,
                                                      "boxes3d_1M.rebuild"))
    assert sleeping["name"] == "boxes3d_1M_sleeping"
    for key in ("index", "dim", "objects", "scene", "slots_per_axis",
                "min_depth", "capacity", "precision"):
        assert sleeping[key] == boxes[key], key
    entry = next(c for c in bench["configs"]
                 if c["name"] == "boxes3d_1M_sleeping")
    assert entry["reduced"] == [] and entry["source"] == sleeping["source"]
    assert entry["source"] != next(c["source"] for c in bench["configs"]
                                   if c["name"] == "boxes3d_1M")


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


def _update_frame():
    """Pass "off": a frame 0-90 with nothing in it; pass "on": a frame
    from 100, the harness's ``update.update`` around the port's
    ``layer.update`` and its stages, then the scan and the read back."""
    events = [span("frame", 0, 90), span("frame", 100, 200),
              span("update.update", 101, 160), span("layer.scan", 161, 190),
              span("frame.readback", 191, 199),
              span("layer.update", 102, 159), span("update.diff", 103, 120),
              sync("cudaStreamSynchronize", 110, 114),
              span("update.extract", 121, 135),
              span("update.churn", 136, 150), span("update.merge", 151, 158),
              span("layer.scan", 162, 189), sync("cudaMemcpy", 192, 198)]
    return (events + launch(1, 105, 105, 125) + launch(2, 140, 140, 150)
            + launch(3, 152, 155, 165) + launch(4, 170, 170, 185))


def test_the_stage_readers_read_a_hand_made_trace():
    st = stages.reduce(_update_frame(), ["update.update", "layer.scan"],
                       profiling.SPANS, 1,
                       {"update.changed": 45, "update.churn_entries": 700},
                       80e-6)
    us = 1e-6
    # the port's span is a stage of the harness's layer, which carries
    # the time: 59 µs less the 4 µs sync
    assert "layer.update" not in st.host_s
    assert st.rows["layer.update"].calls == 1
    assert st.host_s["update.update"] == pytest.approx(55 * us)
    # device busy 105-125, 140-150, 155-165 inside 101-160
    assert st.idle_s["update.update"] == pytest.approx(24 * us)
    assert st.rows["update.diff"].syncs == 1
    assert st.rows["update.churn"].device_s == pytest.approx(10 * us)
    run = SimpleNamespace(stages=st, config={"objects": 3000})
    got = {m: harness._reader(m)(run) for m in STAGED}
    assert got == pytest.approx({"update.host_ms": 0.055,
                                 "update.idle_ms": 0.024,
                                 "update.changed_share": 1.5})


def _trace(span_s, span_ops, cells):
    return tracing.Trace(len(cells), 1e-3, 5e-4, 100, span_s, span_ops,
                         cells, [9 * c for c in cells], [], [])


def test_the_trace_readers_read_a_hand_made_trace():
    config = _config()
    cells = [3_280_000, 3_290_000]
    run = SimpleNamespace(trace=_trace({"update.update": 4.8e-3},
                                       {"update.update": 1458}, cells),
                          config=config, device_kind=H100)
    assert harness._reader("update.device_ms")(run) == pytest.approx(2.4)
    assert harness._reader("update.ops_per_frame")(run) == 729
    # both frames' bounds read once, 2 x 1M x 6 coordinates x 4 B, and
    # the tree read once and written once, 2 x 12 B an entry of
    # Index64_3D (an 8-byte key and a 4-byte id)
    nbytes = sum(2 * 1_000_000 * 6 * 4 + 2 * 12 * c for c in cells)
    assert harness._reader("update_roofline")(run) == pytest.approx(
        100 * nbytes / 3.35e12 / 4.8e-3)
    assert 0 < harness._reader("update_roofline")(run) < 100
    assert roofline.tree_bytes(config, 1) == 12


def test_the_roofline_bytes_follow_the_contract():
    update_bytes = harness._reader("update_roofline").__globals__[
        "update_bytes"]
    for config, cells, want in [
            (_config(), 3_280_000, 48_000_000 + 78_720_000),
            ({"objects": 3000, "dim": 3, "index": "Index64_3D"}, 9890,
             2 * 3000 * 6 * 4 + 2 * 12 * 9890),
            ({"objects": 600, "dim": 2, "index": "Index32_2D"}, 1000,
             2 * 600 * 4 * 4 + 2 * 8 * 1000)]:
        assert update_bytes(config, cells) == want


def test_every_reader_finds_nothing_without_a_trace():
    run = SimpleNamespace(trace=None, config=_config(), device_kind=H100)
    assert all(harness._reader(m)(run) is None for m in UPDATE)


def test_the_trace_readers_find_nothing_without_the_span():
    run = SimpleNamespace(trace=_trace({"layer.build": 1e-3},
                                       {"layer.build": 90}, [10, 10]),
                          config=_config(), device_kind=H100)
    assert all(harness._reader(m)(run) is None
               for m in UPDATE if m not in STAGED)


def run_tiny(monkeypatch, trace=True, device="cpu"):
    monkeypatch.setattr(sys, "argv", [
        "bpbench/run.py", "--workload", CELL, "--seed", str(SEED),
        "--seconds", "0.3", "--trace", str(int(trace))])
    return harness.run_cell(CELL, SEED, 0.3, trace, device,
                            time.perf_counter(), all_cells(),
                            config_overrides=tiny(CELL))


def test_a_traced_cpu_run_reports_the_update_host_metrics(monkeypatch,
                                                          capfd):
    r = run_tiny(monkeypatch)
    assert r["correct"] is True and r["failed"] == 0
    # no device here: the device quantities stay out
    assert sorted(r["metrics"]) == ["update.changed_share", "update.host_ms"]
    assert r["metrics"]["update.host_ms"]["value"] > 0
    err = capfd.readouterr().err
    for stage in ("update.diff", "update.extract", "update.churn",
                  "update.merge"):
        assert f"{stage} | update.update | 1 |" in err
    # the share is the stage table's counter over the objects and frames
    frames = int(re.search(r"^stages \((\d+) frames", err, re.M)[1])
    counted = ast.literal_eval(re.search(r"counters: (\{.*\})", err)[1])
    assert counted["update.churn_entries"] > counted["update.changed"] > 0
    assert r["metrics"]["update.changed_share"]["value"] == pytest.approx(
        100 * counted["update.changed"] / (3000 * frames))


def test_a_program_without_the_updates_span_and_counters_reports_none(
        monkeypatch):
    """The port before it had them: no ``layer.update`` span (and so no
    host or idle time of the update) and no update counters."""
    monkeypatch.setattr(profiling, "SPANS", tuple(
        s for s in profiling.SPANS
        if s != "layer.update" and not s.startswith("update.")))
    real = profiling.count

    def count(name, value):
        if not name.startswith("update."):
            real(name, value)

    monkeypatch.setattr(profiling, "count", count)
    r = run_tiny(monkeypatch)
    assert r["correct"] is True
    assert not set(STAGED) & set(r["metrics"])


@pytest.mark.card
def test_a_traced_card_run_reports_every_update_metric(monkeypatch, card):
    r = run_tiny(monkeypatch, device=card)
    assert r["correct"] is True and r["failed"] == 0, r["checks"]
    assert set(UPDATE) <= set(r["metrics"])
    assert 0 < r["metrics"]["update_roofline"]["value"] < 100
    assert r["metrics"]["update.changed_share"]["value"] > 0
