"""Per-stage profile of the full broadphase step (``layer.build`` +
canonical ``layer.scan``) at the bench's scale.

The counterpart of ``broadphase_tpu/tools/profile_step.py``.  It runs the
production step itself under ``profiling.tracing()`` and reads the port's
spans (:func:`profiling.span_profile`): a row a span the step opens, in
``profiling.SPANS`` order.

Run:  python -m broadphase_tpu_torch.tools.profile_step [n] [--device cpu]

Rows (a layer's row is its own time outside its stages):
  layer.build     -- the build's own glue
  build.quantize  -- the bounds quantized to the system box
  build.emit      -- cell emission (k1)
  build.sort      -- the tree sort (k9)
  layer.scan      -- the scan's own glue
  scan.pass1      -- run ends and both rule bytes (k2)
  scan.prep       -- run prefix sum and compaction of nonempty runs (k3)
  scan.expand     -- pair expansion with the emit-once rule (k4)
  scan.canonical  -- the canonical pair sort, dedup and compaction (k8)

Each row gives the spans opened, the host ms with the span innermost and,
on a CUDA device, the device ms and operations launched then, per call
over 5 calls in one ``torch.profiler`` window; the last line gives the
window's device totals.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from .. import bench_caps, layer, profiling
from ..index import Index64_3D

SPEC = Index64_3D


def caps(n: int):
    """(tree, pair, emission) capacities: ``bench_caps``' (the bench's
    shapes), at least 1024 lanes each."""
    return (bench_caps.tree_capacity(n),
            max(bench_caps.pair_capacity(n), 1024),
            max(bench_caps.emit_capacity(n), 1024))


def profile(n: int = 1_000_000, device="cuda", seed: int = 0
            ) -> profiling.SpanProfile:
    """The spans of ``layer.build`` + canonical ``layer.scan`` on the bench
    scene of n objects on ``device``."""
    dev = layer.resolve_device(device)
    scene = bench_caps.bench_scene(3, n, seed=seed)
    smin, smax, bmin, bmax, ids = (torch.as_tensor(x, device=dev) for x in (
        *scene[:4], scene[4].astype(np.int64)))
    tree_cap, pair_cap, emit_cap = caps(n)

    def step():
        st = layer.build(SPEC, smin, smax, bmin, bmax, ids,
                         out_capacity=tree_cap)
        return layer.scan(SPEC, st, pair_cap, emit_capacity=emit_cap)

    return profiling.span_profile(step, device=dev)


def stage_table(prof: profiling.SpanProfile) -> str:
    """The spans' calls, host ms, device ms and device operations a call
    (a fraction where the profiler lost events), then the window's
    device totals; a column that was not measured reads "not
    measured"."""
    def num(x, fmt):
        return format(x, fmt) if x is not None else "not measured"

    lines = [f"  {'span':<15} {'calls':>5} {'host ms':>9}   "
             f"{'device ms':>12} {'device ops':>12}"]
    for r in prof.rows:
        lines.append(f"  {r.name:<15} {r.calls:>5g} {r.host_ms:>9.3f}   "
                     f"{num(r.device_ms, '.3f'):>12} "
                     f"{num(r.device_ops, '.1f'):>12}")
    host = sum(r.host_ms for r in prof.rows)
    lines.append(f"  {'window':<15} {'':>5} {host:>9.3f}   "
                 f"{num(prof.device_ms, '.3f'):>12} "
                 f"{num(prof.device_ops, '.1f'):>12}")
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
    print(stage_table(profile(args.n, args.device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
