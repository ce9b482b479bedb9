"""Scan-step visualizer: the stack sweep's state at chosen steps.

The counterpart of ``examples/scan_visualizer.py`` of the JAX package,
after the reference's GUI scan-step visualizer (``examples/main.rs:
898-1028``).  It builds the tree of a 2D scene with the port
(``layer.build`` on ``--device``: the CUDA card unless ``--device cpu``),
replays the sequential ``scan_impl`` stack sweep over it on the host
(:func:`sweep_states`) and colors each element by its role at the step:

* green  -- on the stack (an ancestor of the current element)
* red    -- the current element
* orange -- collision partners emitted at this step
* grey   -- dropped from the stack (passed)
* blue   -- not yet visited

It writes one PNG a step (matplotlib, imported only to render).

Usage:
    python -m broadphase_tpu_torch.examples.scan_visualizer --boxes 40 \\
        --steps 0 10 20 --out-dir . [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from .. import cells, layer
from ..index import Index32_2D

SPEC = Index32_2D


def scene(n: int, seed: int = 0):
    """(system_min, system_max, bounds_min, bounds_max, ids): n boxes of
    side 4-18 in a 100 x 100 system (the JAX visualizer's scene)."""
    rng = np.random.default_rng(seed)
    smin = np.zeros(2, np.float32)
    smax = np.full(2, 100.0, np.float32)
    size = rng.uniform(4, 18, (n, 2)).astype(np.float32)
    bmin = rng.uniform(0, 80, (n, 2)).astype(np.float32)
    bmax = np.minimum(bmin + size, 99.9).astype(np.float32)
    return smin, smax, bmin, bmax, np.arange(n, dtype=np.uint32)


def sorted_tree(scene_np, device):
    """The scene's sorted tree as Python ints (keys, ids), built by the
    port on ``device``."""
    st = layer.build(SPEC, *scene_np, device=device)
    keys, ids, _ = layer.tree_to_numpy(SPEC, st)
    return [int(k) for k in keys], [int(i) for i in ids]


def sweep_states(keys, ids, step_limit):
    """Replay scan_impl (src/layer.rs:550-573), returning per-element roles
    after ``step_limit`` elements have been processed, and the set of
    elements emitted as partners of the current one."""
    n = len(keys)
    role = ["pending"] * n          # pending / stack / dropped / current
    stack = []                      # element indices
    emitted = set()
    for idx in range(min(step_limit + 1, n)):
        key, oid = keys[idx], ids[idx]
        while stack and not cells.overlaps(SPEC, key, keys[stack[-1]]):
            role[stack.pop()] = "dropped"
        if idx == step_limit:
            role[idx] = "current"
            if any(ids[s] == oid for s in stack):
                break
            for s in stack:
                if ids[s] != oid:
                    emitted.add(s)
            break
        if any(ids[s] == oid for s in stack):
            role[idx] = "dropped"
            continue
        stack.append(idx)
    for s in stack:
        if role[s] == "pending":
            role[s] = "stack"
    return role, emitted


def render(scene_np, keys, ids, role, emitted, path):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.patches import Rectangle

    smin, smax, bmin, bmax, obj_ids = scene_np
    colors = {"pending": "tab:blue", "stack": "tab:green",
              "dropped": "lightgrey", "current": "tab:red"}
    fig, ax = plt.subplots(figsize=(9, 9))
    ax.set_xlim(smin[0], smax[0])
    ax.set_ylim(smin[1], smax[1])
    ax.set_aspect("equal")
    by_id = {int(v): k for k, v in enumerate(obj_ids)}
    for e, oid in enumerate(ids):
        k = by_id[int(oid)]
        c = "tab:orange" if e in emitted else colors[role[e]]
        ax.add_patch(Rectangle(
            (bmin[k][0], bmin[k][1]),
            bmax[k][0] - bmin[k][0], bmax[k][1] - bmin[k][1],
            fill=True, alpha=0.45, facecolor=c, edgecolor="black",
            linewidth=0.5))
    fig.savefig(path, dpi=110, bbox_inches="tight")
    plt.close(fig)
    print(f"wrote {path}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="broadphase_tpu_torch.examples."
                                 "scan_visualizer")
    ap.add_argument("--boxes", type=int, default=40)
    ap.add_argument("--steps", type=int, nargs="+", default=[0, 5, 15])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out-dir", default=".")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    scene_np = scene(args.boxes, args.seed)
    os.makedirs(args.out_dir, exist_ok=True)
    keys, tids = sorted_tree(scene_np, args.device)
    for step in args.steps:
        role, emitted = sweep_states(keys, tids, step)
        render(scene_np, keys, tids, role, emitted,
               os.path.join(args.out_dir, f"scan_step_{step:04d}.png"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
