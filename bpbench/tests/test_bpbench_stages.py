"""The readers of the program's spans and counters (``bpbench/stages.py``):
the harness's reduction is blind to the program's spans; the stage
reduction on a hand-made trace; a traced CPU run reports what a CPU can
show; and every new reader finds nothing without a trace, without the
command line or against a program that opens no span."""

import sys
import time
from types import SimpleNamespace

import pytest

from bpbench import harness, stages, trace as tracing
from broadphase_tpu_torch import profiling

from conftest import all_cells, tiny

NEW = ["build.host_ms", "scan.host_ms", "build.idle_ms", "scan.idle_ms",
       "host.syncs_per_frame", "scan.kept_share"]
HOST = ["build.host_ms", "scan.host_ms", "scan.kept_share"]
# read only where the scan sorts its pairs canonically (k8)
CANONICAL = ["scan.spilled_share"]
SEED = 2 ** 31 + 17
CELL = "boxes3d_1M.rebuild"


def span(name, start, end):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": start,
            "dur": end - start}


def launch(corr, at, kernel_start, kernel_end, cat="kernel"):
    return [{"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
             "ts": at, "dur": 0.5, "args": {"correlation": corr}},
            {"ph": "X", "cat": cat, "name": f"op{corr}", "ts": kernel_start,
             "dur": kernel_end - kernel_start,
             "args": {"correlation": corr}}]


def sync(name, start, end):
    return {"ph": "X", "cat": "cuda_runtime", "name": name, "ts": start,
            "dur": end - start}


def harness_frame(offset=0.0):
    """One frame's harness spans and device work (µs), from ``offset``."""
    o = offset
    return ([span("frame", o + 100, o + 200),
             span("layer.build", o + 101, o + 150),
             span("layer.scan", o + 151, o + 190),
             span("frame.readback", o + 191, o + 199),
             sync("cudaMemcpy", o + 192, o + 198)]
            + launch(o + 1, o + 104, o + 104, o + 106)
            + launch(o + 2, o + 112, o + 115, o + 140)
            + launch(o + 3, o + 122, o + 140, o + 160)
            + launch(o + 4, o + 153, o + 160, o + 170)
            + launch(o + 5, o + 191.5, o + 192, o + 193, "gpu_memcpy"))


def program_spans(offset=0.0):
    o = offset
    return [span("layer.build", o + 102, o + 149),
            span("build.quantize", o + 103, o + 110),
            sync("cudaStreamSynchronize", o + 105, o + 108),
            span("build.emit", o + 111, o + 120),
            span("build.sort", o + 121, o + 145),
            span("layer.scan", o + 151, o + 189),
            span("scan.pass1", o + 152, o + 160)]


def test_the_harness_reduction_is_blind_to_the_programs_spans():
    names = ["layer.build", "layer.scan", "frame.readback"]
    plain = harness_frame() + harness_frame(200)
    # the program's syncs are the harness's too: both lists hold them
    with_spans = plain + program_spans() + program_spans(200)
    plain = plain + [e for e in program_spans() + program_spans(200)
                     if e["cat"] == "cuda_runtime"]
    assert (tracing.reduce(plain, names, [1, 1], [2, 2])
            == tracing.reduce(with_spans, names, [1, 1], [2, 2]))


def test_the_stage_reduction_of_a_hand_made_trace():
    # pass "off": a frame 0-90 with nothing in it; pass "on": from 100
    events = ([span("frame", 0, 90)] + harness_frame() + program_spans())
    st = stages.reduce(events, ["layer.build", "layer.scan"],
                       profiling.SPANS, 1, {"scan.pairs": 3,
                                            "scan.emitted": 4,
                                            "scan.sort_spilled": 1}, 80e-6)
    us = 1e-6
    assert st.frames == 1 and st.ops == 5
    assert st.window_s == pytest.approx(100 * us)
    assert st.busy_s == pytest.approx(58 * us)   # 104-106, 115-170, 192-193
    assert st.frame_s == pytest.approx({"harness": 80 * us, "off": 90 * us,
                                        "on": 100 * us})
    # host time inside each layer less the sync, and the idle overlapping it
    assert st.host_s == pytest.approx({"layer.build": 46 * us,
                                       "layer.scan": 39 * us})
    assert st.idle_s == pytest.approx({"layer.build": 12 * us,
                                       "layer.scan": 20 * us})
    rows = st.rows
    assert rows["build.quantize"] == pytest.approx(
        stages.Row(1, 7 * us, 3 * us, 2 * us, 1, 5 * us, 1))
    assert rows["build.emit"].device_s == pytest.approx(25 * us)
    assert rows["build.sort"].device_s == pytest.approx(20 * us)
    assert rows["scan.pass1"].device_s == pytest.approx(10 * us)
    assert rows["layer.build"].calls == 1            # the program's alone
    assert rows["layer.build"].self_s == pytest.approx(9 * us)
    assert rows["layer.scan"].self_s == pytest.approx(31 * us)
    assert rows["frame.readback"].syncs == 1 and st.syncs() == 1
    # the rows' device time sums to each layer's, and idle to the window's
    for layer in ("layer.build", "layer.scan"):
        assert sum(r.device_s for n, r in rows.items()
                   if st.layer_of[n] == layer) == pytest.approx(
            st.layer_device_s[layer])
    assert sum(r.idle_s for r in rows.values()) == pytest.approx(
        st.window_s - st.busy_s)
    run = SimpleNamespace(stages=st)
    got = {m: harness._reader(m)(run) for m in NEW}
    assert got == pytest.approx({
        "build.host_ms": 0.046, "scan.host_ms": 0.039,
        "build.idle_ms": 0.012, "scan.idle_ms": 0.020,
        "host.syncs_per_frame": 1.0, "scan.kept_share": 75.0})
    assert harness._reader("scan.spilled_share")(run) == pytest.approx(25.0)
    assert any("tracing on-cost" in line for line in stages.table(st))


def test_a_pass_that_lost_frames_is_refused():
    events = [span("frame", 0, 90)] + harness_frame() + program_spans()
    with pytest.raises(RuntimeError, match="frames"):
        stages.reduce(events, ["layer.build"], profiling.SPANS, 2, {}, 1.0)


def run_tiny(monkeypatch, cell=CELL, argv=True, trace=True, device="cpu"):
    if argv:
        monkeypatch.setattr(sys, "argv", [
            "bpbench/run.py", "--workload", cell, "--seed", str(SEED),
            "--seconds", "0.3", "--trace", str(int(trace))])
    return harness.run_cell(cell, SEED, 0.3, trace, device,
                            time.perf_counter(), all_cells(),
                            config_overrides=tiny(cell))


@pytest.mark.parametrize("cell", ["boxes3d_1M.rebuild",
                                  "boxes3d_1M.rebuild_unsorted"])
def test_a_traced_cpu_run_reports_the_host_metrics(monkeypatch, capfd,
                                                   cell):
    r = run_tiny(monkeypatch, cell)
    assert r["correct"] is True
    # no device here: the device quantities stay out
    canonical = CANONICAL if cell == "boxes3d_1M.rebuild" else []
    # the unsorted cell's tail, read per layer, is on the host's clock
    tail = [] if canonical else ["host.frame_ms_p95"]
    assert sorted(r["metrics"]) == sorted(HOST + canonical + tail)
    assert 0 < r["metrics"]["scan.kept_share"]["value"] <= 100
    assert all(r["metrics"][m]["value"] > 0 for m in HOST)
    assert all(0 <= r["metrics"][m]["value"] <= 100 for m in canonical)
    err = capfd.readouterr().err
    assert "build.quantize | layer.build | 1 |" in err
    assert "tracing on-cost" in err


def test_the_new_readers_find_nothing_without_a_trace(monkeypatch):
    run = SimpleNamespace(trace=None, config={}, device_kind="cpu")
    assert all(harness._reader(m)(run) is None for m in NEW)
    r = run_tiny(monkeypatch, trace=False)
    assert not set(NEW) & set(r["metrics"])


def test_the_new_readers_find_nothing_without_the_command_line(monkeypatch):
    r = run_tiny(monkeypatch, argv=False)
    assert r["metrics"] == {}


def test_the_new_readers_find_nothing_in_a_program_without_spans(
        monkeypatch):
    monkeypatch.delattr(profiling, "tracing")
    r = run_tiny(monkeypatch)
    assert r["metrics"] == {}


@pytest.mark.card
@pytest.mark.parametrize("cell", ["boxes3d_1M.rebuild",
                                  "boxes3d_1M.rebuild_unsorted"])
def test_a_traced_card_run_reports_every_new_metric(monkeypatch, card, cell):
    r = run_tiny(monkeypatch, cell, device=card)
    assert r["correct"] is True
    assert set(NEW) <= set(r["metrics"])
    assert r["metrics"]["host.syncs_per_frame"]["value"] >= 0
