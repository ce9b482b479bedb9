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
  all, and :func:`pipelined_ms`, the host time of calls enqueued back to
  back (the stage profilers' columns).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Dict, Optional, Tuple

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


def device_events(fn: Callable, reps: int = 5, tries: int = 6,
                  keep: Optional[Callable[[str], bool]] = None
                  ) -> Optional[Dict[str, Tuple[float, float]]]:
    """{event name: (ms, count) per call} of the CUDA events (kernels,
    copies, fills) of ``reps`` calls of ``fn()`` in one ``torch.profiler``
    window, those whose name ``keep`` accepts (all when None).  The
    profiler now and then returns a window with no device event; such a
    window is profiled again, up to ``tries`` times in all; None if none
    shows one."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = {}
        for evt in prof.key_averages():
            if evt.device_type != DeviceType.CUDA or (
                    keep is not None and not keep(evt.key)):
                continue
            ms, count = events.get(evt.key, (0.0, 0.0))
            events[evt.key] = (ms + evt.self_device_time_total / reps / 1e3,
                               count + evt.count / reps)
        if sum(ms for ms, _ in events.values()) > 0:
            return events
    return None


def device_time(fn: Callable, reps: int = 5
                ) -> Optional[Tuple[float, float]]:
    """(ms, operations) per call of ``fn()`` on the card, summed over
    :func:`device_events`; None where the profiler showed no device
    event."""
    events = device_events(fn, reps)
    if events is None:
        return None
    return (sum(ms for ms, _ in events.values()),
            sum(count for _, count in events.values()))


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
