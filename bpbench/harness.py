"""One run of one cell: set-up, warm-up, a closed frame loop for
``--seconds``, the check against the reference, one result line.

A cell is ``<config>.<mix>`` (``BENCHMARK.json``'s ``workloads``).  The
engine's frame loop is the one caller: a frame is the mix's calls into
the program and a host read of the pair count and the overflow flag
(the pick's id with it), which every engine makes before it uses the
pairs.  A frame whose flag is raised counts as failed.  With ``trace``
frames before the window run under ``torch.profiler``, with a span
around each call; the per-layer metrics read that trace.

Nothing here imports JAX or the JAX package; :func:`foreign_modules`
looks in ``sys.modules`` once the window has closed.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import subprocess
import sys
import time
from functools import reduce
from pathlib import Path
from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch

from broadphase_tpu_torch import index as port_index

from . import check, trace as tracing, traffic
from .caps import cell_caps

BENCHMARK = traffic.ROOT.parent / "BENCHMARK.json"
FOREIGN = ("jax", "jaxlib", "flax", "broadphase_tpu")
READBACK_SPAN = "frame.readback"
TRACE_SECONDS = 0.5          # frames traced: about this long, 8 to 100
LAUNCH_CHAIN = 200           # tiny kernels a launch-rate reading times


class ForeignModules(RuntimeError):
    """A module of JAX or of the JAX package was loaded."""


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def load_bench(path: Path = BENCHMARK) -> dict:
    return json.loads(Path(path).read_text())


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def config_of(bench: dict, w: dict) -> dict:
    for c in bench["configs"]:
        if c["name"] == w["config"]:
            return json.loads((traffic.ROOT.parent / c["file"]).read_text())
    raise SystemExit(f"no configuration {w['config']!r} in BENCHMARK.json")


def foreign_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FOREIGN)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Cell:
    """What a cell's frames need: its configuration, mix, capacities,
    scene and ring on the device, and each call's set-up state."""

    def __init__(self, config: dict, mix: dict, seed: int, device):
        self.config, self.traffic = config, mix
        self.spec = getattr(port_index, config["index"])
        self.caps = cell_caps(config)
        gen = traffic.generator(seed % 2 ** 64, device)
        self.scene = traffic.make_scene(config, gen, device)
        self.ring = traffic.make_ring(self.scene, mix, gen)
        self.calls = [traffic.plugin("calls", c) for c in mix["calls"]]
        for call in self.calls:
            call.prepare(self)

    def span_names(self):
        return [c.SPAN for c in self.calls] + [READBACK_SPAN]


def readback(out: dict) -> list:
    """The host read that ends a frame: [pair count (tree count where the
    mix has no scan), any overflow flag, the pick's id where there is a
    pick]."""
    last = out["pairs"] if "pairs" in out else out["tree"]
    flag = reduce(torch.logical_or, [o.overflow for o in out.values()])
    row = [last.count, flag.to(torch.int64)]
    if "pick" in out:
        row.append(out["pick"].obj_id)
    return torch.stack(row).tolist()


def run_frame(cell: Cell, number: int, span):
    """(frame, outputs, read-back values) of frame ``number``."""
    fr = traffic.frame(cell.ring, number)
    out = {}
    for call in cell.calls:
        with span(call.SPAN):
            call.run(cell, fr, out)
    with span(READBACK_SPAN):
        vals = readback(out)
    return fr, out, vals


def _no_span(_name):
    return contextlib.nullcontext()


def launch_us(device) -> Optional[float]:
    """Host launch rate: µs a launch over a chain of tiny in-place adds
    ended by one synchronize, the best of three chains."""
    if torch.device(device).type != "cuda":
        return None
    x = torch.zeros(1, device=device)
    best = float("inf")
    for _ in range(3):
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(LAUNCH_CHAIN):
            x.add_(1)
        _sync(device)
        best = min(best, time.perf_counter() - t0)
    return best / LAUNCH_CHAIN * 1e6


def card_line(device) -> str:
    if torch.device(device).type != "cuda":
        return "card: none (cpu)"
    try:
        limit = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        limit = "nvidia-smi unavailable"
    return f"card: {torch.cuda.get_device_name(device)}; {limit}"


def _reader(name: str):
    path = traffic.ROOT / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "bpbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_metrics(bench: dict, section: str, cell_name: str, run) -> dict:
    """The section's metrics that this cell reports, by their readers; a
    reader that finds nothing to read leaves its metric out."""
    out = {}
    for m in bench[section]:
        if "workloads" in m and cell_name not in m["workloads"]:
            continue
        value = _reader(m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def run_cell(name: str, seed: int, seconds: float, trace: bool, device,
             t_start: float, bench: Optional[dict] = None,
             config_overrides: Optional[dict] = None) -> dict:
    """One run of cell ``name``; returns the result line's object.
    ``t_start`` is the process's start on ``time.perf_counter``'s clock;
    ``config_overrides`` (tests) replace top-level configuration keys."""
    bench = bench or load_bench()
    w = workload(bench, name)
    config = {**config_of(bench, w), **(config_overrides or {})}
    mix = traffic.load_json("traffic", w["traffic"])
    split = {"imports": time.perf_counter() - t_start}
    t = time.perf_counter()
    if torch.device(device).type == "cuda":
        torch.cuda.init()
        torch.zeros(1, device=device)
    split["device"] = time.perf_counter() - t
    t = time.perf_counter()
    cell = Cell(config, mix, seed, device)
    _sync(device)
    split["scene_ring"] = time.perf_counter() - t

    # warm-up: the whole ring forward and back, holding as many frames'
    # outputs as the window will, so that the allocator has grown
    t = time.perf_counter()
    ring_len = cell.ring["bounds_min"].shape[0]
    warm = max(2 * ring_len - 2, 8)
    keep = mix["check_frames"]
    number, held, times = 1, [], []
    for i in range(warm):
        t0 = time.perf_counter()
        fr, out, _ = run_frame(cell, number, _no_span)
        times.append(time.perf_counter() - t0)
        if i < keep:
            held.append(out)
        number += 1
    del held, out
    est = float(np.median(times[warm // 2:]))
    split["warmup"] = time.perf_counter() - t
    t = time.perf_counter()
    launch = launch_us(device)
    split["launch_rate"] = time.perf_counter() - t
    rng = np.random.default_rng([seed % 2 ** 64, 1])
    horizon = max(keep, int(0.5 * seconds / est))
    sample_at = set(rng.choice(horizon, size=keep, replace=False).tolist())

    # with trace, the traced frames come first: the profiler's start and
    # stop take seconds, outside the window
    counts, prof = [], None
    if trace:
        record = torch.profiler.record_function
        prof = tracing.profiler()
        with prof:
            tracing.pad(device)
            for _ in range(max(8, min(100, int(TRACE_SECONDS / est)))):
                with record(tracing.FRAME_SPAN):
                    _, out, _ = run_frame(cell, number, record)
                counts += [out["tree"].count,
                           out.get("pairs", out["tree"]).count]
                number += 1
            tracing.pad(device)

    # the window
    frame_s, held, failed = [], [], 0
    i = 0
    start = time.perf_counter()
    setup_s = start - t_start
    while True:
        t0 = time.perf_counter()
        fr, out, vals = run_frame(cell, number, _no_span)
        t1 = time.perf_counter()
        frame_s.append(t1 - t0)
        failed += vals[1] != 0
        if i in sample_at:
            held.append((fr, out))
        number += 1
        i += 1
        if t1 - start >= seconds:
            break
    elapsed = t1 - start
    if len(held) < keep:
        # the host ran slower than in the warm-up and the window closed
        # before a sampled frame: its last frame is checked in its place
        held.append((fr, out))
    del out
    _sync(device)
    peak = (torch.cuda.max_memory_allocated(device)
            if torch.device(device).type == "cuda" else 0)
    foreign = foreign_modules()
    if foreign:
        raise ForeignModules("modules of JAX or the JAX package were "
                             "loaded: " + ", ".join(foreign))

    tr = None
    if trace:
        counts = torch.stack(counts).tolist()
        tr = tracing.reduce(tracing.export(prof), cell.span_names(),
                            counts[0::2], counts[1::2])
        del prof

    # the check: outputs to the host, the program's state freed, then the
    # reference on the host
    checked = [(check.FrameInputs(cell, fr), check.host_outputs(out))
               for fr, out in held]
    del held, fr
    cell.ring = cell.tracked = None
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    numbers = check.check_frames(cell, checked)
    check_s = time.perf_counter() - t
    correct, checks = check.verdict(numbers, len(checked))

    kind = (torch.cuda.get_device_name(device)
            if torch.device(device).type == "cuda" else "cpu")
    run = SimpleNamespace(
        window=SimpleNamespace(frame_s=frame_s, elapsed_s=elapsed,
                               frames=len(frame_s), setup_s=setup_s),
        trace=tr, config=config, device_kind=kind)
    section = "per_layer" if trace else "end_to_end"
    metrics = read_metrics(bench, section, name, run)
    log(card_line(device))
    log(f"launch_us {launch!r} (a launch in a chain of {LAUNCH_CHAIN} tiny "
        f"kernels)")
    log("setup split (s): " + ", ".join(f"{k} {v:.3f}"
                                        for k, v in split.items())
        + f"; setup_s {setup_s:.3f}")
    log(f"window: {len(frame_s)} frames in {elapsed:.3f} s, {failed} "
        f"failed; {tr.frames if tr else 0} traced; reference check of "
        f"{len(checked)} frames took {check_s:.3f} s")
    device_rec = {"platform": "gpu" if kind != "cpu" else "cpu",
                  "kind": kind, "count": w["chips"],
                  "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": len(frame_s),
              "failed": int(failed), "metrics": metrics,
              "device": device_rec}
    if tr is not None:
        device_rec["busy_s"] = tr.busy_s
        device_rec["window_s"] = tr.window_s
        result["breakdown"] = {"device_ops": tr.device_ops,
                               "idle_gaps": tr.idle_gaps}
        log(f"trace: {tr.frames} frames, {tr.ops} device ops, busy "
            f"{tr.busy_s:.6f} s of {tr.window_s:.6f} s; by span: "
            + json.dumps({k: [tr.span_s.get(k, 0.0), tr.span_ops[k]]
                          for k in tr.span_ops}))
    result["checks"] = checks
    return result
