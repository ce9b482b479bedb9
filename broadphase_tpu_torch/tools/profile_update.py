"""Per-stage profile of the temporal-coherence ``update`` at the bench's
scale.

The counterpart of ``broadphase_tpu/tools/profile_update.py``: it times
the prefixes of ``update.update`` that its ``_stage`` argument cuts, on
the bench's moving scene (``bench.py::bench_update_sweep``: the bench
scene, then ``churn_frac`` of the objects moved by uniform(-5, 5) per
axis, seed 3, and every object by 1e-4), beside a fresh ``layer.build``
on the new bounds as the reference line.  The full prefix must equal the
default ``update`` and the fresh build.

Run:  python -m broadphase_tpu_torch.tools.profile_update [n] [churn_frac]
          [--device cpu]

Stages (``update.STAGES``, each a prefix that ends at it):
  emit_diff -- signatures on the new bounds, the per-object diff, counts
  extract   -- changed-object compaction (k5), emission of their old and
               new rows, the churn streams
  churn     -- churn compaction to the merge budget (k5), the churn sort
  merge     -- merge, tombstone cancel and compaction in one kernel (k6)
  full      -- + the new state: the production update
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Tuple

import numpy as np
import torch

from .. import bench_caps, layer
from ..index import Index64_3D
from ..update import STAGES, build_tracked, update
from .profile_step import StageTime, stage_table, stage_time

SPEC = Index64_3D


def moving_scene(n: int, frac: float, seed: int = 0):
    """(system_min, system_max, bounds_min, bounds_max, ids, new bounds_min,
    new bounds_max) of the bench's update sweep, numpy."""
    smin, smax, bmin, bmax, ids = bench_caps.bench_scene(3, n, seed=seed)
    rng = np.random.default_rng(3)
    moving = rng.random(n) < frac
    jump = (rng.uniform(-5.0, 5.0, size=bmin.shape).astype(np.float32)
            * moving[:, None])
    drift = np.float32(1e-4)
    return smin, smax, bmin, bmax, ids, bmin + jump + drift, \
        bmax + jump + drift


def states_equal(a: layer.LayerState, b: layer.LayerState) -> bool:
    """Keys, ids, aux (the whole capacity), count, invalid_count and
    overflow."""
    return (all(torch.equal(x, y) for x, y in zip(a[:3], b[:3]))
            and int(a.count) == int(b.count)
            and int(a.invalid_count) == int(b.invalid_count)
            and bool(a.overflow) == bool(b.overflow))


def profile(n: int = 1_000_000, frac: float = 0.03, device="cuda"
            ) -> Tuple[List[StageTime], StageTime]:
    """Time every prefix of :data:`update.STAGES` and the fresh build on
    ``device``, after checking that the full prefix equals the default
    update and the fresh build (raises ``RuntimeError`` if not).  Returns
    (the stages, the build's line)."""
    dev = layer.resolve_device(device)
    tree_cap = bench_caps.tree_capacity(n)
    churn_cap, obj_cap = bench_caps.update_caps(n, frac)
    smin, smax, bmin, bmax, ids, bmin2, bmax2 = (
        torch.as_tensor(x, device=dev) for x in moving_scene(n, frac))
    ids = ids.to(torch.int64)
    tracked = build_tracked(SPEC, smin, smax, bmin, bmax, ids,
                            out_capacity=tree_cap)

    def prefix(stage):
        return lambda: update(SPEC, tracked, smin, smax, bmin2, bmax2,
                              churn_cap, obj_cap=obj_cap, _stage=stage)

    def fresh():
        return layer.build(SPEC, smin, smax, bmin2, bmax2, ids,
                           out_capacity=tree_cap)

    full = prefix("full")().state
    if not (states_equal(full, update(SPEC, tracked, smin, smax, bmin2,
                                      bmax2, churn_cap,
                                      obj_cap=obj_cap).state)
            and states_equal(full, fresh())):
        raise RuntimeError("the full prefix differs from update or from a "
                           "fresh build")

    return ([stage_time(s, prefix(s), dev) for s in STAGES],
            stage_time("build", fresh, dev))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="broadphase_tpu_torch.tools."
                                 "profile_update")
    ap.add_argument("n", type=int, nargs="?", default=1_000_000)
    ap.add_argument("churn_frac", type=float, nargs="?", default=0.03)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    churn_cap, obj_cap = bench_caps.update_caps(args.n, args.churn_frac)
    print(f"profiling update n={args.n} churn={args.churn_frac:.1%} "
          f"churn_cap={churn_cap} obj_cap={obj_cap} "
          f"tree_cap={bench_caps.tree_capacity(args.n)} on {args.device}")
    rows, build = profile(args.n, args.churn_frac, args.device)
    print("the full prefix equals update and a fresh build")
    print(stage_table(rows))
    dev = ("not measured" if build.device_ms is None else
           f"{build.device_ms:.3f} ms, {build.device_ops:.0f} operations")
    print(f"  fresh build (reference): host {build.host_ms:.3f} ms, "
          f"device {dev}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
