"""Per-stage profile of the full broadphase step (``layer.build`` +
canonical ``layer.scan``) at the bench's scale.

The counterpart of ``broadphase_tpu/tools/profile_step.py``: it times
cumulative prefixes of the production step and reports each prefix's
time and the deltas between them.  Each prefix runs the production step
cut short by ``layer.scan_pairs``' ``_stage``, and the full prefix's
pairs must equal ``layer.scan``'s.

Run:  python -m broadphase_tpu_torch.tools.profile_step [n] [--device cpu]

Stages (each a prefix that ends at it):
  build       -- quantize, cell emission (k1) and the tree sort
  run_ends    -- pass 1 of the scan (k2): run ends and both rule bytes
  prep        -- run prefix sum and compaction of nonempty runs (k3)
  gather      -- pair expansion with the emit-once rule (k4)
  compact     -- emission compaction to the pair buffer (k5; the step
                 skips it where the emission buffer is no wider)
  sort_pairs  -- the canonical pair sort (torch.sort)
  full_stream -- + dedup mask and compaction (k5): the production step

Each prefix is timed on the host (the best of 3 batches of 8 calls, one
synchronize a batch) and, on a CUDA device, by its device time and
device operations (``torch.profiler``, 5 calls).
"""

from __future__ import annotations

import argparse
import sys
from typing import Callable, List, NamedTuple, Optional

import numpy as np
import torch

from .. import bench_caps, layer, profiling
from ..index import Index64_3D

SPEC = Index64_3D
STAGES = ("build",) + layer.SCAN_STAGES


class StageTime(NamedTuple):
    """A prefix's times, cumulative (the prefix that ends at the stage);
    the device columns are None where there is no card."""

    name: str
    host_ms: float
    device_ms: Optional[float]
    device_ops: Optional[float]   # kernels, copies and fills per call


def stage_time(name: str, fn: Callable, dev: torch.device) -> StageTime:
    """Host ms (:func:`profiling.pipelined_ms`) and, on a CUDA device,
    device ms and operations (:func:`profiling.device_time`) of one
    prefix; the device columns stay None where the profiler showed no
    device event."""
    host = profiling.pipelined_ms(fn, dev)
    dt = profiling.device_time(fn) if dev.type == "cuda" else None
    return StageTime(name, host, *(dt or (None, None)))


def caps(n: int):
    """(tree, pair, emission) capacities: ``bench_caps``' (the bench's
    shapes), at least 1024 lanes each."""
    return (bench_caps.tree_capacity(n),
            max(bench_caps.pair_capacity(n), 1024),
            max(bench_caps.emit_capacity(n), 1024))


def make_prefixes(spec, scene_t, tree_cap: int, pair_cap: int,
                  emit_cap: int) -> List[Callable]:
    """The prefixes of :data:`STAGES`, in order: the build, then the build
    and ``layer.scan_pairs`` cut at each of ``layer.SCAN_STAGES`` (its
    ``_stage``), as ``layer.scan`` calls it.  Each returns small sums over
    its last stage's output, except the last, which returns the step's
    ``ScanResult``."""
    smin, smax, bmin, bmax, ids = scene_t

    def build():
        return layer.build(spec, smin, smax, bmin, bmax, ids,
                           out_capacity=tree_cap)

    def p_build():
        st = build()
        return st.count, st.ids[::4096].sum()

    def prefix(stage):
        def run():
            st = build()
            return layer.scan_pairs(spec, st.keys, st.ids, st.count,
                                    pair_cap, extra_overflow=st.overflow,
                                    aux=st.aux, emit_capacity=emit_cap,
                                    _stage=stage)
        return run

    return [p_build] + [prefix(s) for s in layer.SCAN_STAGES]


def profile(n: int = 1_000_000, device="cuda", seed: int = 0
            ) -> List[StageTime]:
    """Time every prefix on the bench scene of n objects on ``device``,
    after checking that the full prefix gives ``layer.scan``'s pairs,
    count and overflow flag (raises ``RuntimeError`` if not)."""
    dev = layer.resolve_device(device)
    scene = bench_caps.bench_scene(3, n, seed=seed)
    smin, smax, bmin, bmax, ids = scene
    scene_t = tuple(torch.as_tensor(x, device=dev) for x in (
        smin, smax, bmin, bmax, ids.astype(np.int64)))
    tree_cap, pair_cap, emit_cap = caps(n)
    prefixes = make_prefixes(SPEC, scene_t, tree_cap, pair_cap, emit_cap)

    got = prefixes[-1]()
    _, want = layer.scan(SPEC, layer.build(SPEC, *scene_t,
                                           out_capacity=tree_cap),
                         pair_cap, emit_capacity=emit_cap)
    if not (int(got.count) == int(want.count)
            and bool(got.overflow) == bool(want.overflow)
            and np.array_equal(layer.scan_result_to_numpy(got),
                               layer.scan_result_to_numpy(want))):
        raise RuntimeError("the full prefix differs from layer.scan")

    return [stage_time(name, fn, dev) for name, fn in zip(STAGES, prefixes)]


def stage_table(rows: List[StageTime]) -> str:
    """The prefixes' cumulative host ms, device ms and device operations,
    each with its delta from the prefix before; a column that was not
    measured, and a delta from one, reads "not measured"."""
    def num(x, fmt):
        return format(x, fmt) if x is not None else "not measured"

    lines = [f"  {'stage':<11} {'host ms':>9} {'delta':>9}   "
             f"{'device ms':>12} {'delta':>12}   {'device ops':>12} "
             f"{'delta':>12}"]
    prev = (0.0, 0.0, 0.0)
    for r in rows:
        cols = []
        for x, p, fmt in zip((r.host_ms, r.device_ms, r.device_ops), prev,
                             (".3f", ".3f", ".0f")):
            cols += [num(x, fmt),
                     num(None if x is None or p is None else x - p, fmt)]
        lines.append(f"  {r.name:<11} {cols[0]:>9} {cols[1]:>9}   "
                     f"{cols[2]:>12} {cols[3]:>12}   {cols[4]:>12} "
                     f"{cols[5]:>12}")
        prev = (r.host_ms, r.device_ms, r.device_ops)
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="broadphase_tpu_torch.tools."
                                 "profile_step")
    ap.add_argument("n", type=int, nargs="?", default=1_000_000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    tree_cap, pair_cap, emit_cap = caps(args.n)
    print(f"profiling the step n={args.n} tree_cap={tree_cap} "
          f"pair_cap={pair_cap} emit_cap={emit_cap} on {args.device}")
    rows = profile(args.n, args.device)
    print("the full prefix's pairs equal layer.scan's")
    print(stage_table(rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
