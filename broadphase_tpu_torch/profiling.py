"""Timing, tracing and memory utilities on torch.

PyTorch counterparts of ``broadphase_tpu/utils/profiling.py``:

* :func:`timed`: p50/p90 host-clock statistics of a call, each call ended
  by ``torch.cuda.synchronize()`` on a CUDA device;
* :func:`trace`: a ``torch.profiler`` window (CPU and CUDA activities)
  that writes a Chrome trace into a directory;
* :func:`device_memory_stats`: bytes in use, peak and limit of a CUDA
  device (None on the CPU);
* :func:`peak_memory`: the peak bytes one call allocates above what was
  live before it.  It takes the place of JAX's
  ``compiled_memory_analysis``, which reads a compiler's buffer plan that
  eager execution does not have;
* :func:`device_events`: a call's device time and device operations
  from the profiler's CUDA events, by name; :func:`device_readings`,
  their median over a fixed number of windows;
* :func:`tracing`, :func:`span`, :func:`count` and :func:`counters`: the
  port's own spans at the stages of ``layer.build``, ``layer.scan``,
  ``layer.merge`` and ``update.update`` and its counters (emissions,
  pairs, sort passes and spilled sort keys, merged entries, an update's
  changed objects and churn entries, kernel launches), off by default;
* :func:`span_profile`: a call's host and device time in each of those
  spans (the stage profilers' rows, ``tools/profile_step.py`` and
  ``tools/profile_update.py``).
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile
import time
from collections import defaultdict
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch


def _sync(device) -> None:
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed(fn: Callable, *args, iters: int = 20, warmup: int = 3,
          device="cuda") -> Dict[str, float]:
    """Host-clock statistics (ms) of ``fn(*args)`` over ``iters`` calls
    after ``warmup``; on a CUDA ``device`` every call is ended by a
    synchronize, so the time is the call's, not its enqueue's."""
    for _ in range(warmup):
        fn(*args)
    _sync(device)
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(*args)
        _sync(device)
        times.append((time.perf_counter() - t0) * 1e3)
    arr = np.asarray(times)
    return {
        "p50_ms": float(np.percentile(arr, 50)),
        "p90_ms": float(np.percentile(arr, 90)),
        "min_ms": float(arr.min()),
        "mean_ms": float(arr.mean()),
        "iters": iters,
    }


@contextlib.contextmanager
def trace(log_dir: str):
    """``with trace(dir): step(...)``: a ``torch.profiler`` window over the
    CPU and, where there is a card, CUDA activities; on exit the Chrome
    trace is written to ``log_dir/trace.json`` (Perfetto or
    ``chrome://tracing`` open it)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        _sync("cuda" if torch.cuda.is_available() else "cpu")
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def device_memory_stats(device=None) -> Optional[Dict[str, int]]:
    """Bytes in use, peak bytes in use and the byte limit of a CUDA device
    (default: the current card), from ``torch.cuda.memory_stats``; None
    for the CPU, which keeps no such counters."""
    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda":
        return None
    s = torch.cuda.memory_stats(device)
    return {
        "bytes_in_use": int(s.get("allocated_bytes.all.current", 0)),
        "peak_bytes_in_use": int(s.get("allocated_bytes.all.peak", 0)),
        "bytes_limit": int(torch.cuda.get_device_properties(
            device).total_memory),
    }


def peak_memory(fn: Callable, *args, device="cuda") -> int:
    """Peak bytes that one ``fn(*args)`` allocates on a CUDA ``device``
    above what was live before it (the caching allocator's counters:
    ``reset_peak_memory_stats``, then ``max_memory_allocated``)."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError("peak_memory reads a CUDA device's allocator; got "
                         f"{device}")
    torch.cuda.synchronize(device)
    before = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    fn(*args)
    torch.cuda.synchronize(device)
    return torch.cuda.max_memory_allocated(device) - before


# The profiler's windows lose device events at their ends (on an H100
# with torch 2.11: the first few launches of a window, and now and then
# the last).  Each window is padded at both ends with spin kernels, which
# are left out of its events.
_PAD_KERNEL = "spin_kernel"
_PAD_LAUNCHES = 8


def _pad() -> None:
    for _ in range(_PAD_LAUNCHES):
        torch.cuda._sleep(1000)


def window_events(fn: Callable, reps: int = 5,
                  keep: Optional[Callable[[str], bool]] = None
                  ) -> Dict[str, Tuple[float, float]]:
    """{event name: (ms, count) per call} of the CUDA events (kernels,
    copies, fills) of ``reps`` calls of ``fn()`` in one padded
    ``torch.profiler`` window, those whose name ``keep`` accepts (all when
    None)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _pad()
        for _ in range(reps):
            fn()
        _pad()
        torch.cuda.synchronize()
    events = {}
    for evt in prof.key_averages():
        # under tracing() the port's spans show on the device's timeline
        # too, as the range of the work launched inside them
        if evt.device_type != DeviceType.CUDA or _PAD_KERNEL in evt.key \
                or evt.key in SPANS \
                or (keep is not None and not keep(evt.key)):
            continue
        ms, count = events.get(evt.key, (0.0, 0.0))
        events[evt.key] = (ms + evt.self_device_time_total / reps / 1e3,
                           count + evt.count / reps)
    return events


def window_totals(events: Dict[str, Tuple[float, float]]
                  ) -> Tuple[float, float]:
    """(ms, operations) per call, summed over a window's events."""
    return (sum(ms for ms, _ in events.values()),
            sum(count for _, count in events.values()))


def device_events(fn: Callable, reps: int = 5, tries: int = 6,
                  keep: Optional[Callable[[str], bool]] = None,
                  min_ops: float = 0.0
                  ) -> Tuple[Optional[Dict[str, Tuple[float, float]]], int]:
    """({event name: (ms, count) per call}, windows thrown away): the
    events of one :func:`window_events` window.  The profiler now and then
    returns a window that lost device events.  A window with no device
    time, or with fewer operations per call than ``min_ops`` (the
    caller's lower bound), is thrown away and profiled again, up to
    ``tries`` times in all; the events are None if none passes."""
    for dropped in range(tries):
        events = window_events(fn, reps, keep)
        ms, ops = window_totals(events)
        if ms > 0 and ops >= min_ops:
            return events, dropped
    return None, tries


def device_readings(fn: Callable, reps: int = 10, windows: int = 7,
                    keep: Optional[Callable[[str], bool]] = None
                    ) -> Tuple[float, float, list]:
    """(median ms, median operations, [(ms, operations) of each window])
    per call of ``fn()`` over a fixed number of :func:`window_events`
    windows, none thrown away.  A window that lost events or part of
    their time reads low; the median stands unless most windows did."""
    per_window = [window_totals(window_events(fn, reps, keep))
                  for _ in range(windows)]
    return (float(np.median([ms for ms, _ in per_window])),
            float(np.median([ops for _, ops in per_window])), per_window)


# ---------------------------------------------------------------------------
# The port's spans and counters
# ---------------------------------------------------------------------------

# Every span the port opens: a layer, then its stages in call order.  What
# a layer does between its stages is the layer's self time.
SPANS = ("layer.build", "build.quantize", "build.emit", "build.sort",
         "layer.scan", "scan.nested", "scan.pass1", "scan.prep",
         "scan.expand", "scan.compact", "scan.canonical",
         "layer.merge", "merge.cols", "merge.kernel", "merge.unpack",
         "layer.update", "update.diff", "update.extract", "update.churn",
         "update.merge")
# Every counter: the emission slots a scan fills (``prep_runs``' total),
# the pairs it keeps, the 8-bit digits on which its canonical pair sort's
# keys differ, the entries a merge leaves in its layer, the radix passes
# of the build's tree sort that did work, the keys of the pair sort's
# buckets too large for shared memory, the objects whose signature an
# update found changed and the churn entries (tombstones and inserts) it
# handed to the merge, and each kernel's launches (k7:
# ``expand_pairs_entries``; k8: the pair sort's chain; k9: the tree
# sort's chain).
COUNTERS = ("scan.emitted", "scan.pairs", "scan.sort_passes",
            "merge.entries", "build.sort_passes", "scan.sort_spilled",
            "update.changed", "update.churn_entries") + tuple(
                f"k{k}.launches" for k in range(1, 10))

_NO_SPAN = contextlib.nullcontext()
_tracing = False
_kept: Dict[str, List] = {}


class tracing:
    """Turn the port's spans and counters on (or, with ``on=False``,
    off): ``with tracing(): ...`` restores the previous state on exit, and
    a bare ``tracing(on)`` call leaves the new state set, as
    ``torch.set_grad_enabled`` does."""

    def __init__(self, on: bool = True):
        global _tracing
        self.prev, _tracing = _tracing, bool(on)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        global _tracing
        _tracing = self.prev
        return False


def span(name: str):
    """A ``torch.profiler.record_function`` span named ``name`` (one of
    :data:`SPANS`) while tracing is on, so that it lands in a profiler's
    trace beside the device events; one shared no-op context otherwise."""
    if not _tracing:
        return _NO_SPAN
    return torch.profiler.record_function(name)


def count(name: str, value) -> None:
    """Add ``value`` (a host int or a 0-dim tensor, kept by reference: no
    synchronisation, no kernel) to counter ``name`` while tracing is on;
    nothing otherwise."""
    if _tracing:
        _kept.setdefault(name, []).append(value)


def counters() -> Dict[str, int]:
    """{counter: sum} of the values kept since the last call, read to the
    host in one ``torch.stack(...).tolist()`` a device, and the kept
    values cleared."""
    kept = dict(_kept)
    _kept.clear()
    out = {name: 0 for name in kept}
    on_device: Dict[torch.device, list] = {}
    for name, values in kept.items():
        for v in values:
            if isinstance(v, torch.Tensor):
                on_device.setdefault(v.device, []).append((name, v))
            else:
                out[name] += int(v)
    for items in on_device.values():
        read = torch.stack([v.reshape(()).to(torch.int64)
                            for _, v in items]).tolist()
        for (name, _), v in zip(items, read):
            out[name] += v
    return out


# ---------------------------------------------------------------------------
# A call's time in each span
# ---------------------------------------------------------------------------

# Chrome trace categories: the device's operations, and the host's CUDA
# calls that launch them (joined by their correlation ids)
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_RUNTIME_CATS = ("cuda_runtime", "cuda_driver")


class SpanRow(NamedTuple):
    """One span's readings per call; the device columns are None where
    there is no card."""

    name: str
    calls: float                  # spans opened
    host_ms: float                # host time with it the innermost span
    device_ms: Optional[float]    # of the operations launched then
    device_ops: Optional[float]   # kernels, copies and fills launched then


class SpanProfile(NamedTuple):
    """A call's :class:`SpanRow` s in :data:`SPANS` order (the spans it
    opened), and the device ms and operations per call of the whole
    window, spans or not (None where there is no card)."""

    rows: List[SpanRow]
    device_ms: Optional[float]
    device_ops: Optional[float]


def _innermost(spans) -> List[Tuple[float, Optional[str]]]:
    """[(t, name)]: from each t on until the next, the innermost of the
    nested (start, end, name) ``spans`` that is open (None: none is)."""
    marks, stack = [], []

    def close():
        end, _ = stack.pop()
        marks.append((end, stack[-1][1] if stack else None))

    for start, end, name in sorted(spans, key=lambda x: (x[0], -x[1])):
        while stack and stack[-1][0] <= start:
            close()
        stack.append((end, name))
        marks.append((start, name))
    while stack:
        close()
    return marks


def span_rows(events: list, reps: int, on_device: bool) -> SpanProfile:
    """The :class:`SpanProfile` of ``reps`` calls from a profiler window's
    Chrome trace ``events``: a span's host time is the time it was the
    innermost of :data:`SPANS` open (a layer's excludes its stages), and
    each device operation goes to the innermost span open at its launch.
    The window's padding kernels count nowhere."""
    spans = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
             if e.get("cat") == "user_annotation" and e.get("name") in SPANS]
    calls = defaultdict(int)
    for _, _, name in spans:
        calls[name] += 1
    marks = _innermost(spans)
    at = [t for t, _ in marks]
    host_us = defaultdict(float)
    for (t, name), (t_next, _) in zip(marks, marks[1:]):
        if name is not None:
            host_us[name] += t_next - t
    launch = {e["args"]["correlation"]: e["ts"] for e in events
              if e.get("cat") in _RUNTIME_CATS
              and "correlation" in e.get("args", {})}
    dev_us, ops = defaultdict(float), defaultdict(int)
    window_us, window_ops = 0.0, 0
    for e in events:
        if e.get("cat") not in _DEVICE_CATS or e.get("ph") != "X" \
                or _PAD_KERNEL in e.get("name", ""):
            continue
        window_us += e["dur"]
        window_ops += 1
        t = launch.get(e.get("args", {}).get("correlation"))
        if t is None:
            continue
        i = bisect.bisect_right(at, t) - 1
        name = marks[i][1] if i >= 0 else None
        if name is not None:
            dev_us[name] += e["dur"]
            ops[name] += 1

    def dev(x):
        return x / reps if on_device else None

    rows = [SpanRow(name, calls[name] / reps, host_us[name] / reps / 1e3,
                    dev(dev_us[name] / 1e3), dev(ops[name]))
            for name in SPANS if calls[name]]
    return SpanProfile(rows, dev(window_us / 1e3), dev(window_ops))


def span_profile(fn: Callable, reps: int = 5, device="cuda"
                 ) -> SpanProfile:
    """Run ``fn()`` once to warm up, then ``reps`` times under
    :func:`tracing` in one ``torch.profiler`` window (padded on a card, as
    :func:`window_events` pads), and read its :func:`span_rows`."""
    from torch.profiler import ProfilerActivity, profile

    device = torch.device(device)
    on_device = device.type == "cuda"
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if on_device else [])
    with tracing():
        fn()
        _sync(device)
        with profile(activities=activities) as prof:
            if on_device:
                _pad()
            for _ in range(reps):
                fn()
            if on_device:
                _pad()
            _sync(device)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return span_rows(events, reps, on_device)
