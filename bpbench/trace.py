"""The traced window of a ``--trace 1`` run, reduced to what the per-layer
metrics read.

``torch.profiler`` records the CPU and CUDA activity of a run of frames;
the Chrome trace it exports is parsed here.  Each device operation
(kernel, copy, fill) is tied to the host call that launched it by the
CUDA runtime's correlation id, and so to the innermost of the harness's
spans (``frame``, one span a call into the program, ``frame.readback``)
open at that moment.  The profiler's windows lose device events at their
ends (H100, torch 2.11), so the window is padded at both ends with spin
kernels that are launched, and finished, outside the traced frames.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict
from typing import Dict, List, NamedTuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
FRAME_SPAN = "frame"
_PAD_LAUNCHES = 8


class Trace(NamedTuple):
    frames: int                      # frames traced
    window_s: float                  # first frame's start to last's end
    busy_s: float                    # device busy inside the window
    ops: int                         # device operations the frames made
    span_s: Dict[str, float]         # device seconds of each span's ops
    span_ops: Dict[str, int]         # device operations of each span
    tree_cells: List[int]            # each traced frame's tree count
    pairs: List[int]                 # each traced frame's pair count
    device_ops: List[list]           # [name, seconds], the 10 longest
    idle_gaps: List[list]            # [host activity, seconds], 10 longest


def pad(device) -> None:
    """Spin kernels, finished before the call returns."""
    if torch.device(device).type == "cuda":
        for _ in range(_PAD_LAUNCHES):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize(device)


def profiler():
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def export(prof) -> list:
    """The profile's Chrome trace events (written to a temporary file in
    ``TMPDIR`` and removed)."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.remove(path)


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


class _Spans:
    """The harness's host spans, for the innermost one open at a time."""

    def __init__(self, events, names):
        spans = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                 if e.get("cat") == "user_annotation"
                 and e.get("name") in names]
        # a span's children start later and are shorter: sort so that the
        # last span starting at or before t that contains t is innermost
        self.spans = sorted(spans, key=lambda s: (s[0], -s[1]))
        self.starts = [s[0] for s in self.spans]

    def at(self, t: float) -> str:
        i = bisect.bisect_right(self.starts, t)
        for s, e, name in reversed(self.spans[max(0, i - 8):i]):
            if s <= t <= e:
                return name
        return "outside"


def _innermost_op(cpu_ops, starts, t: float) -> str:
    i = bisect.bisect_right(starts, t)
    for s, e, name in reversed(cpu_ops[max(0, i - 64):i]):
        if s <= t <= e:
            return name
    return "python"


def reduce(events: list, span_names, tree_cells, pairs) -> Trace:
    """The traced frames' :class:`Trace` from the exported events."""
    spans = _Spans(events, set(span_names) | {FRAME_SPAN})
    frames = [s for s in spans.spans if s[2] == FRAME_SPAN]
    if not frames:
        raise RuntimeError("the profiler's trace holds no frame span")
    lo, hi = frames[0][0], max(s[1] for s in frames)
    launch = {e["args"]["correlation"]: e["ts"] for e in events
              if e.get("cat") in RUNTIME_CATS
              and "correlation" in e.get("args", {})}
    span_s, span_ops = defaultdict(float), defaultdict(int)
    by_name, busy = defaultdict(float), []
    ops = 0
    for e in events:
        if e.get("cat") not in DEVICE_CATS or e.get("ph") != "X":
            continue
        t = launch.get(e.get("args", {}).get("correlation"))
        if t is None or not lo <= t <= hi:
            continue
        name = spans.at(t)
        ops += 1
        span_ops[name] += 1
        span_s[name] += e["dur"] * 1e-6
        by_name[e["name"][:160]] += e["dur"] * 1e-6
        busy.append((max(e["ts"], lo), min(e["ts"] + e["dur"], hi)))
    merged = _union([b for b in busy if b[1] > b[0]])
    busy_s = sum(e - s for s, e in merged) * 1e-6
    cpu_ops = sorted((e["ts"], e["ts"] + e["dur"], e["name"])
                     for e in events
                     if e.get("ph") == "X"
                     and e.get("cat") in ("cpu_op",) + RUNTIME_CATS)
    starts = [c[0] for c in cpu_ops]
    gaps = defaultdict(float)
    edges = [lo] + [x for iv in merged for x in iv] + [hi]
    for s, e in zip(edges[::2], edges[1::2]):
        if e > s:
            host = f"{spans.at(s)}:{_innermost_op(cpu_ops, starts, s)}"
            gaps[host] += (e - s) * 1e-6

    def top(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                [:10]]

    return Trace(len(frames), (hi - lo) * 1e-6, busy_s, ops, dict(span_s),
                 dict(span_ops), tree_cells, pairs, top(by_name), top(gaps))
