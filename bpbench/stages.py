"""The program's own spans and counters, from a traced pass of the cell's
frames with the program's tracing on.

The port opens a ``record_function`` span at each stage of ``layer.build``
and ``layer.scan`` (``broadphase_tpu_torch.profiling.SPANS``) and keeps
counters (emissions, pairs, kernel launches) while
``profiling.tracing()`` is on, and neither while it is off.  The
harness's traced frames run with it off, so every metric they give reads
as it did before the program had spans.  This module traces the same
frames once more, with it on.  The first reader that needs the result
(``build.host_ms``, ``scan.host_ms``, ``build.idle_ms``,
``scan.idle_ms``, ``host.syncs_per_frame``, ``scan.kept_share``,
``scan.spilled_share``) runs the pass, once a run, after the window and
the check; the result is kept on the run for the others.  A reader sees the run's window, trace,
configuration and device; the cell and the seed it takes from the
command line that ``run.py`` parses (``--workload``, ``--seed``).  Where
the run has no trace, no such command line, or a program without
``profiling.tracing``, there is nothing to read.

The pass makes the cell anew from the same configuration and seed (the
same scene and ring), warms it up as the harness does, and traces the
harness's traced frames twice in one profiler window: with the program's
tracing off, as the harness ran them, then on.  The difference between
the two passes' mean frames is tracing's on-cost.  The second pass is
reduced on the profiler's clock: the host's time is cut into intervals,
each under the innermost span open (the harness's spans, one a call into
the program, and the program's; a harness span and a program span of
one name are one layer) and inside the innermost call span (the layer).
Device-idle time and the time blocked in synchronising CUDA runtime calls
are intersected with those intervals; each device operation goes to the
span open when its launch was made.  A stage table goes to stderr.
"""

from __future__ import annotations

import bisect
import sys
import time
from collections import defaultdict
from typing import Dict, NamedTuple, Optional

import torch

from broadphase_tpu_torch import profiling

from . import harness, trace as tracing, traffic

# synchronising CUDA runtime calls: the host waits in them for the device
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy")
OUTSIDE = "outside"


class Row(NamedTuple):
    calls: int          # spans opened
    self_s: float       # host time with this span innermost
    sync_s: float       # of which blocked in synchronising calls
    device_s: float     # device time of operations launched inside it
    ops: int            # device operations launched inside it
    idle_s: float       # device-idle time while it was innermost
    syncs: int          # synchronising calls made inside it


class Stages(NamedTuple):
    frames: int
    window_s: float                 # the pass's first frame to its last
    busy_s: float                   # device busy inside that window
    ops: int                        # device operations the frames made
    frame_s: Dict[str, float]       # mean traced frame: harness, off, on
    rows: Dict[str, Row]            # by innermost span
    layer_of: Dict[str, str]        # each span's layer
    host_s: Dict[str, float]        # by layer: host time less syncs
    idle_s: Dict[str, float]        # by layer: device idle
    layer_device_s: Dict[str, float]  # by layer, the harness's attribution
    program: tuple                  # the program's span names
    counters: Dict[str, int]        # the program's counters, summed

    def per_frame_ms(self, seconds: float) -> float:
        return seconds / self.frames * 1e3

    def traced(self, layer: str) -> bool:
        """The program opened its span of ``layer`` in this cell."""
        row = self.rows.get(layer)
        return layer in self.host_s and row is not None and row.calls > 0

    def syncs(self) -> int:
        """Synchronising calls made inside the program's spans."""
        return sum(r.syncs for name, r in self.rows.items()
                   if name in self.program)


def _argument(flag: str) -> Optional[str]:
    argv = sys.argv[1:]
    for i, arg in enumerate(argv[:-1]):
        if arg == flag:
            return argv[i + 1]
    for arg in argv:
        if arg.startswith(flag + "="):
            return arg[len(flag) + 1:]
    return None


def of(run) -> Optional[Stages]:
    """The run's :class:`Stages`, traced on the first call; None where
    there is nothing to read."""
    if not hasattr(run, "stages"):
        run.stages = _traced(run)
    return run.stages


def _traced(run) -> Optional[Stages]:
    if run.trace is None or not hasattr(profiling, "tracing"):
        return None
    name, seed = _argument("--workload"), _argument("--seed")
    w = next((w for w in harness.load_bench()["workloads"]
              if w["name"] == name), None)
    if w is None or seed is None:
        return None
    device = "cpu" if run.device_kind == "cpu" else "cuda:0"
    mix = traffic.load_json("traffic", w["traffic"])
    return trace_pass(run.config, mix, int(seed), device, run.trace)


def trace_pass(config: dict, mix: dict, seed: int, device,
               first) -> Stages:
    """Trace ``first.frames`` frames of the cell (the harness's traced
    frames, ``first`` its :class:`trace.Trace`) with the program's
    tracing off and then on, and reduce the second pass."""
    t0 = time.perf_counter()
    cell = harness.Cell(config, mix, seed, device)
    ring_len = cell.ring["bounds_min"].shape[0]
    warm = max(2 * ring_len - 2, 8)
    for number in range(1, warm + 1):
        harness.run_frame(cell, number, harness._no_span)
    frames = range(warm + 1, warm + 1 + first.frames)
    record = torch.profiler.record_function
    prof = tracing.profiler()
    with prof:
        tracing.pad(device)
        for on in (False, True):
            profiling.counters()
            with profiling.tracing(on):
                for number in frames:
                    with record(tracing.FRAME_SPAN):
                        harness.run_frame(cell, number, record)
            tracing.pad(device)
    counted = profiling.counters()
    calls = [c.SPAN for c in cell.calls]
    del cell
    stages = reduce(tracing.export(prof), calls, profiling.SPANS,
                    first.frames, counted,
                    first.window_s / first.frames)
    for line in table(stages):
        harness.log(line)
    harness.log(f"the stage pass took {time.perf_counter() - t0:.3f} s")
    return stages


class _Cover:
    """Lengths of a union of intervals inside any [a, b]."""

    def __init__(self, intervals):
        self.iv = tracing._union(intervals)
        self.starts = [s for s, _ in self.iv]
        self.before = [0.0]
        for s, e in self.iv:
            self.before.append(self.before[-1] + e - s)

    def upto(self, t: float) -> float:
        i = bisect.bisect_right(self.starts, t)
        if i == 0:
            return 0.0
        s, e = self.iv[i - 1]
        return self.before[i - 1] + min(t, e) - s

    def length(self, a: float, b: float) -> float:
        return self.upto(b) - self.upto(a)


def _segments(spans, layers, program, lo, hi):
    """[(start, end, innermost span, innermost layer)] covering [lo, hi],
    and {span: opened}: ``spans`` (start, end, name) nest; a span of a
    layer's name inside one of that name is the program's."""
    segs, opened, stack = [], defaultdict(int), []
    t = lo

    def cut(upto):
        nonlocal t
        if upto > t:
            name = stack[-1][1] if stack else OUTSIDE
            layer = next((n for _, n in reversed(stack) if n in layers),
                         None)
            segs.append((t, upto, name, layer))
            t = upto

    for s, e, name in sorted(spans, key=lambda x: (x[0], -x[1])):
        while stack and stack[-1][0] <= s:
            cut(stack[-1][0])
            stack.pop()
        cut(s)
        if name in program and (name not in layers
                                or any(n == name for _, n in stack)):
            opened[name] += 1
        stack.append((e, name))
    while stack:
        cut(stack[-1][0])
        stack.pop()
    cut(hi)
    return segs, opened


def reduce(events: list, calls, program, frames: int,
           counted: Dict[str, int], harness_frame_s: float) -> Stages:
    """The second pass's :class:`Stages` from the profile's events of both
    passes (``frames`` frames each); ``calls`` are the harness's call
    spans (the layers), ``program`` the program's span names."""
    layers = set(calls)
    names = layers | set(program) | {harness.READBACK_SPAN,
                                     tracing.FRAME_SPAN}
    annotations = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                   if e.get("cat") == "user_annotation"
                   and e.get("name") in names]
    frame_spans = sorted(a for a in annotations
                         if a[2] == tracing.FRAME_SPAN)
    if len(frame_spans) != 2 * frames:
        raise RuntimeError(f"the stage pass traced {len(frame_spans)} "
                           f"frames, not 2 x {frames}")
    off, on = frame_spans[:frames], frame_spans[frames:]
    lo, hi = on[0][0], max(e for _, e, _ in on)
    off_s = (max(e for _, e, _ in off) - off[0][0]) / frames * 1e-6
    segs, opened = _segments([a for a in annotations if lo <= a[0] <= hi],
                             layers, program, lo, hi)
    starts = [s for s, _, _, _ in segs]

    def at(t):
        i = bisect.bisect_right(starts, t) - 1
        return segs[i][2:] if i >= 0 else (OUTSIDE, None)

    launch = {e["args"]["correlation"]: e["ts"] for e in events
              if e.get("cat") in tracing.RUNTIME_CATS
              and "correlation" in e.get("args", {})}
    outer = tracing._Spans(events, layers | {harness.READBACK_SPAN})
    device_s, ops = defaultdict(float), defaultdict(int)
    layer_device_s = defaultdict(float)
    busy = []
    for e in events:
        if e.get("cat") not in tracing.DEVICE_CATS or e.get("ph") != "X":
            continue
        t = launch.get(e.get("args", {}).get("correlation"))
        if t is None or not lo <= t <= hi:
            continue
        name, _ = at(t)
        device_s[name] += e["dur"] * 1e-6
        ops[name] += 1
        layer_device_s[outer.at(t)] += e["dur"] * 1e-6
        busy.append((max(e["ts"], lo), min(e["ts"] + e["dur"], hi)))
    busy = _Cover([b for b in busy if b[1] > b[0]])
    sync_iv, syncs = [], defaultdict(int)
    for e in events:
        if (e.get("cat") in tracing.RUNTIME_CATS and e.get("ph") == "X"
                and e.get("name") in SYNC_CALLS and lo <= e["ts"] <= hi):
            sync_iv.append((e["ts"], min(e["ts"] + e["dur"], hi)))
            syncs[at(e["ts"])[0]] += 1
    sync = _Cover(sync_iv)
    self_s, sync_s, idle = (defaultdict(float) for _ in range(3))
    layer_of, host_s, idle_s = {}, defaultdict(float), defaultdict(float)
    for s, e, name, layer in segs:
        blocked = sync.length(s, e)
        gap = (e - s) - busy.length(s, e)
        self_s[name] += (e - s) * 1e-6
        sync_s[name] += blocked * 1e-6
        idle[name] += gap * 1e-6
        layer_of.setdefault(name, layer)
        if layer is not None:
            host_s[layer] += (e - s - blocked) * 1e-6
            idle_s[layer] += gap * 1e-6
    rows = {name: Row(opened.get(name, 0), self_s[name], sync_s[name],
                      device_s[name], ops[name], idle[name], syncs[name])
            for name in self_s}
    return Stages(frames, (hi - lo) * 1e-6, busy.length(lo, hi) * 1e-6,
                  sum(ops.values()),
                  {"harness": harness_frame_s, "off": off_s,
                   "on": (hi - lo) / frames * 1e-6},
                  rows, layer_of, dict(host_s), dict(idle_s),
                  dict(layer_device_s), tuple(program), dict(counted))


def table(st: Stages) -> list:
    """The stage table's lines: a row a span, per traced frame."""
    ms = st.per_frame_ms
    lines = [f"stages ({st.frames} frames, the program's tracing on; per "
             "frame): span | layer | calls | host self ms | of it blocked "
             "in syncs | device ms | ops | idle ms | syncs"]
    order = [n for n in st.program if n in st.rows] + sorted(
        n for n in st.rows if n not in st.program)
    for name in order:
        r = st.rows[name]
        lines.append(
            f"  {name} | {st.layer_of.get(name)} | {r.calls / st.frames:g} "
            f"| {ms(r.self_s):.4f} | {ms(r.sync_s):.4f} | "
            f"{ms(r.device_s):.4f} | {r.ops / st.frames:g} | "
            f"{ms(r.idle_s):.4f} | {r.syncs / st.frames:g}")
    for layer in sorted(st.layer_device_s):
        if layer not in st.host_s:
            continue
        summed = sum(r.device_s for n, r in st.rows.items()
                     if st.layer_of.get(n) == layer)
        lines.append(
            f"  {layer}: device ms {ms(summed):.4f} over its stages and "
            f"self, {ms(st.layer_device_s[layer]):.4f} by the harness's "
            f"spans; host ms less syncs {ms(st.host_s[layer]):.4f}; idle "
            f"ms {ms(st.idle_s[layer]):.4f}")
    idle = sum(r.idle_s for r in st.rows.values())
    lines.append(
        f"  idle: {ms(idle):.4f} ms a frame over the rows (layers "
        f"{ms(sum(st.idle_s.values())):.4f}, the rest "
        f"{ms(idle - sum(st.idle_s.values())):.4f}); window less busy "
        f"{ms(st.window_s - st.busy_s):.4f}")
    lines.append(f"  counters: {st.counters}")
    f = st.frame_s
    lines.append(
        f"tracing on-cost: mean traced frame {f['on'] * 1e3:.4f} ms with "
        f"the program's tracing on, {f['off'] * 1e3:.4f} ms off in the "
        f"same window ({100 * (f['on'] / f['off'] - 1):+.2f}%), "
        f"{f['harness'] * 1e3:.4f} ms in the harness's traced pass "
        f"({100 * (f['on'] / f['harness'] - 1):+.2f}%)")
    return lines
