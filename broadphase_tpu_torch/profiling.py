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
* :func:`device_events` and :func:`device_time`: a call's device time
  and device operations from the profiler's CUDA events, by name or in
  all; :func:`device_readings`, their median over a fixed number of
  windows; and :func:`pipelined_ms`, the host time of calls enqueued
  back to back (the stage profilers' columns);
* :func:`tracing`, :func:`span`, :func:`count` and :func:`counters`: the
  port's own spans at the stages of ``layer.build``, ``layer.scan`` and
  ``layer.merge`` and its counters (emissions, pairs, sort passes, merged
  entries, kernel launches), off by default.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Dict, List, Optional, Tuple

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
    caller's lower bound: what a shorter prefix of the same work showed),
    is thrown away and profiled again, up to ``tries`` times in all; the
    events are None if none passes."""
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


def device_time(fn: Callable, reps: int = 5, min_ops: float = 0.0
                ) -> Optional[Tuple[float, float]]:
    """(ms, operations) per call of ``fn()`` on the card, summed over
    :func:`device_events` (``min_ops`` as it says); None where no profiler
    window passed."""
    events, _ = device_events(fn, reps, min_ops=min_ops)
    return None if events is None else window_totals(events)


def pipelined_ms(fn: Callable, device, batches: int = 3, batch: int = 8
                 ) -> float:
    """Host ms per call of ``fn()``, the best of ``batches`` batches of
    ``batch`` calls enqueued back to back and ended by one synchronize
    (after one warm-up call): the stage profilers' host column, timed as
    the JAX package's profilers time their prefixes."""
    fn()
    _sync(device)
    best = float("inf")
    for _ in range(batches):
        t0 = time.perf_counter()
        outs = [fn() for _ in range(batch)]
        _sync(device)
        best = min(best, (time.perf_counter() - t0) / batch * 1e3)
        del outs
    return best


# ---------------------------------------------------------------------------
# The port's spans and counters
# ---------------------------------------------------------------------------

# Every span the port opens: a layer, then its stages in call order.  What
# a layer does between its stages is the layer's self time.
SPANS = ("layer.build", "build.quantize", "build.emit", "build.sort",
         "layer.scan", "scan.nested", "scan.pass1", "scan.prep",
         "scan.expand", "scan.compact", "scan.canonical",
         "layer.merge", "merge.cols", "merge.kernel", "merge.unpack")
# Every counter: the emission slots a scan fills (``prep_runs``' total),
# the pairs it keeps and the radix passes of its canonical pair sort that
# did work, the entries a merge leaves in its layer, the radix passes of
# the build's tree sort that did work, and each kernel's launches (k7:
# ``expand_pairs_entries``; k8: the pair sort's chain; k9: the tree
# sort's chain).
COUNTERS = ("scan.emitted", "scan.pairs", "scan.sort_passes",
            "merge.entries", "build.sort_passes") + tuple(
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
