"""CLI for scene generation, inspection and validation data, on the port.

The counterpart of ``python -m broadphase_tpu.tools`` (the reference's
``gen_test_data`` binary, ``utils/src/gen_test_data.rs:805-813``), with
the same subcommands, arguments and output:

* ``gen_boxes``: a deterministic scene (``gen.py``, numpy) to BR_SCENE;
* ``show``: the scene's summary (``--verbose``, ``--limit``), a PNG of
  the boxes and a selected object's cells (``--png``, ``--select``;
  matplotlib, imported only then) and a self-contained HTML inspector
  that replays the stack sweep (``--html``; the same bytes as the JAX
  CLI writes);
* ``gen_validation_data``: the golden trio of the reference's pipeline
  (``gen_test_data.rs:740-786``): the tree in append order
  (``0_layer_unsorted``), sorted (``1_layer_sorted``) and its collisions
  (``2_layer_collisions``).

The trio and an HTML inspector of a scene with no stored tree are
computed by the port (``layer.make_layer`` + ``extend``, which emits the
reference's append order, then ``sort`` and the canonical scan) on
``--device``: the CUDA card unless ``--device cpu`` is given.  There is
no fallback to the CPU or to an oracle.

Usage:
    python -m broadphase_tpu_torch.tools gen_boxes --count 10000 \\
        --density 0.001 --size 1 10 --seed 0 --out scene.br_scene
    python -m broadphase_tpu_torch.tools show scene.br_scene \\
        [--png out.png] [--html out.html] [--device cpu]
    python -m broadphase_tpu_torch.tools gen_validation_data \\
        --in scene.br_scene --out-dir validation/ [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from .. import bench_caps, cells, gen, layer
from .. import scene as scene_io
from ..index import Index64_3D

SPEC = Index64_3D    # BR_SCENE fixes the index to Index64_3D


def cmd_gen_boxes(args) -> None:
    sc = gen.gen_boxes(count=args.count, density=args.density,
                       size_range=tuple(args.size), seed=args.seed)
    scene_io.save(args.out, sc)
    print(f"wrote {args.out}: {len(sc.ids)} boxes, "
          f"system [{sc.system_min.tolist()}, {sc.system_max.tolist()}]")


def cmd_show(args) -> None:
    """Dump scene info (reference ``show``, ``gen_test_data.rs:715-736``);
    optional PNG and HTML renders."""
    sc = scene_io.load(args.path)
    print(f"system_bounds: {sc.system_min.tolist()} .. "
          f"{sc.system_max.tolist()}")
    print(f"objects: {len(sc.ids)}")
    print(f"layer: min_depth={sc.layer.min_depth} "
          f"tree_len={len(sc.layer.ids)} sorted={sc.layer.sorted}")
    print(f"collisions: {len(sc.collisions)}")
    if args.verbose:
        for i in range(min(len(sc.ids), args.limit)):
            print(f"  obj {sc.ids[i]}: {sc.bounds_min[i].tolist()} .. "
                  f"{sc.bounds_max[i].tolist()}")
        for i in range(min(len(sc.layer.ids), args.limit)):
            print(f"  cell {sc.layer.keys[i]:#018x} -> id "
                  f"{sc.layer.ids[i]}")
    if args.png:
        _render_png(sc, args.png, args.select)
    if args.html:
        _render_html(sc, args.html, args.device)


def _render_png(sc, path: str, select: int = -1) -> None:
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.patches import Rectangle

    fig, ax = plt.subplots(figsize=(10, 10))
    ax.set_xlim(sc.system_min[0], sc.system_max[0])
    ax.set_ylim(sc.system_min[1], sc.system_max[1])
    ax.set_aspect("equal")
    for i in range(len(sc.ids)):
        sel = int(sc.ids[i]) == select
        ax.add_patch(Rectangle(
            (sc.bounds_min[i, 0], sc.bounds_min[i, 1]),
            sc.bounds_max[i, 0] - sc.bounds_min[i, 0],
            sc.bounds_max[i, 1] - sc.bounds_min[i, 1],
            fill=sel, linewidth=0.4,
            edgecolor="tab:red" if sel else "tab:blue",
            facecolor="tab:red" if sel else "none", alpha=0.8))
    if select >= 0 and len(sc.layer.ids):
        # the selected object's index cells (reference
        # gen_test_data.rs:383-393): cell -> local bounds -> global
        for k, oid in zip(sc.layer.keys, sc.layer.ids):
            if int(oid) != select:
                continue
            x0, y0, x1, y1 = cells.cell_rect_xy(SPEC, int(k), sc.system_min,
                                                sc.system_max)
            ax.add_patch(Rectangle(
                (x0, y0), x1 - x0, y1 - y0,
                fill=False, linewidth=1.0, edgecolor="tab:green"))
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    print(f"wrote {path}")


def _sorted_tree(sc, device):
    """The scene's tree sorted by (key, id) as Python ints: the stored
    layer (sorted on the host if it is not), else built by the port on
    ``device`` at the layer's ``min_depth``."""
    if len(sc.layer.ids):
        keys = np.asarray(sc.layer.keys, np.uint64)
        ids = np.asarray(sc.layer.ids, np.uint32)
        if not sc.layer.sorted:
            order = np.lexsort((ids, keys))
            keys, ids = keys[order], ids[order]
    else:
        st = layer.build(SPEC, sc.system_min, sc.system_max, sc.bounds_min,
                         sc.bounds_max, sc.ids,
                         min_depth=int(sc.layer.min_depth), device=device)
        if bool(st.overflow):
            raise RuntimeError(
                "an object needs more than 2 cells an axis at min_depth "
                f"{sc.layer.min_depth}: the tree would be cut")
        keys, ids, _ = layer.tree_to_numpy(SPEC, st)
    return [int(k) for k in keys], [int(i) for i in ids]


def sweep_events(keys, tids):
    """Replay the sequential stack sweep (``src/layer.rs:550-573``) over a
    sorted tree: per element, [pops, skipped (its id is on the stack),
    partners (the stack elements of other ids)]."""
    stack, events = [], []
    for i in range(len(keys)):
        pops = 0
        while stack and not cells.overlaps(SPEC, keys[i], keys[stack[-1]]):
            stack.pop()
            pops += 1
        skipped = any(tids[j] == tids[i] for j in stack)
        partners = [] if skipped else \
            [j for j in stack if tids[j] != tids[i]]
        events.append([pops, int(skipped), partners])
        if not skipped:
            stack.append(i)
    return events


def _render_html(sc, path: str, device) -> None:
    """Self-contained interactive scene inspector (XY projection), the
    headless analog of the reference's glium GUI
    (``utils/src/gen_test_data.rs:171-738``): click a cell to select it
    (click again to cycle through the cells under the cursor), and scrub
    the step slider to replay the stack sweep (``examples/main.rs:
    898-1028``) from the embedded per-element events.  One HTML file, no
    network."""
    keys, tids = _sorted_tree(sc, device)
    n = len(keys)
    if n > 50_000:
        print(f"warning: {n} tree entries — the HTML will be large")
    data = {
        "sys": [float(sc.system_min[0]), float(sc.system_min[1]),
                float(sc.system_max[0]), float(sc.system_max[1])],
        "objs": [[int(sc.ids[i]),
                  float(sc.bounds_min[i, 0]), float(sc.bounds_min[i, 1]),
                  float(sc.bounds_max[i, 0]), float(sc.bounds_max[i, 1])]
                 for i in range(len(sc.ids))],
        "cells": [[tids[i],
                   list(cells.cell_rect_xy(SPEC, keys[i], sc.system_min,
                                           sc.system_max)),
                   f"{keys[i]:#018x}", cells.depth_of(SPEC, keys[i])]
                  for i in range(n)],
        "events": sweep_events(keys, tids),
    }
    html = _HTML_TEMPLATE.replace("__DATA__", json.dumps(data))
    with open(path, "w") as f:
        f.write(html)
    print(f"wrote {path} ({n} cells, {len(sc.ids)} objects)")


_HTML_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>broadphase_tpu inspector</title>
<style>
 body{font:13px sans-serif;margin:0;display:flex;height:100vh}
 #view{flex:1}
 #side{width:300px;padding:10px;overflow:auto;border-left:1px solid #ccc}
 svg{width:100%;height:100%;background:#fafafa}
 .obj{fill:none;stroke:#9ab;stroke-width:1;vector-effect:non-scaling-stroke}
 .cell{stroke:#678;stroke-width:.5;cursor:pointer;
       vector-effect:non-scaling-stroke}
 .pending{fill:#4878d0;fill-opacity:.25}
 .stack{fill:#2ca02c;fill-opacity:.55}
 .dropped{fill:#999;fill-opacity:.3}
 .current{fill:#d62728;fill-opacity:.8}
 .partner{fill:#ff7f0e;fill-opacity:.8}
 .skipped{fill:#9467bd;fill-opacity:.7}
 .selected{stroke:#000;stroke-width:.4}
 #bar{position:absolute;left:10px;top:8px;background:#fffc;padding:6px;
      border:1px solid #ccc;border-radius:4px}
 input[type=range]{width:320px;vertical-align:middle}
</style></head><body>
<div id="view">
 <div id="bar">
  step <input id="step" type="range" min="0" value="0">
  <span id="stepn"></span>
  <button onclick="bump(-1)">-1</button><button onclick="bump(1)">+1</button>
 </div>
 <svg id="svg" preserveAspectRatio="xMidYMid meet"></svg>
</div>
<div id="side"><h3>broadphase_tpu inspector</h3>
 <p>Scrub the slider to replay the stack sweep
 (green&nbsp;stack, red&nbsp;current, orange&nbsp;partners,
 purple&nbsp;skipped&nbsp;dup-id, grey&nbsp;dropped).
 Click a cell to select; click the same spot again to cycle through
 overlapping cells.</p><div id="info">nothing selected</div></div>
<script>
const D = __DATA__;
const svg = document.getElementById("svg");
const [sx0, sy0, sx1, sy1] = D.sys;
svg.setAttribute("viewBox", `${sx0} ${sy0} ${sx1-sx0} ${sy1-sy0}`);
const NS = "http://www.w3.org/2000/svg";
function rect(x0,y0,x1,y1,cls){
  const r = document.createElementNS(NS, "rect");
  r.setAttribute("x",x0); r.setAttribute("y",y0);
  r.setAttribute("width",Math.max(x1-x0,1e-6));
  r.setAttribute("height",Math.max(y1-y0,1e-6));
  r.setAttribute("class",cls); svg.appendChild(r); return r;
}
for (const [,x0,y0,x1,y1] of D.objs) rect(x0,y0,x1,y1,"obj");
const cellEls = D.cells.map(([id,[x0,y0,x1,y1]]) => rect(x0,y0,x1,y1,"cell pending"));
const n = D.cells.length;
const slider = document.getElementById("step");
slider.max = n;
let selected = -1, lastKey = null, cycle = 0;
function stateAt(step){  // replay events 0..step-1
  const role = new Array(n).fill("pending"); const stack = [];
  for (let i = 0; i < step; i++){
    const [pops, skipped, partners] = D.events[i];
    for (let p = 0; p < pops; p++) role[stack.pop()] = "dropped";
    if (i === step-1) for (const j of partners) role[j] = "partner";
    if (skipped) role[i] = "skipped";
    else { stack.push(i); role[i] = i === step-1 ? "current" : "stack"; }
  }
  for (const j of stack) if (role[j] !== "current" && role[j] !== "partner")
    role[j] = "stack";
  return role;
}
function redraw(){
  const step = +slider.value;
  document.getElementById("stepn").textContent = `${step}/${n}`;
  const role = stateAt(step);
  cellEls.forEach((el,i) => {
    el.setAttribute("class",
      "cell " + role[i] + (i === selected ? " selected" : ""));
  });
}
function bump(d){ slider.value = Math.min(n, Math.max(0, +slider.value + d));
                  redraw(); }
slider.addEventListener("input", redraw);
svg.addEventListener("click", ev => {
  const pt = svg.createSVGPoint(); pt.x = ev.clientX; pt.y = ev.clientY;
  const p = pt.matrixTransform(svg.getScreenCTM().inverse());
  const hits = [];
  D.cells.forEach(([id,[x0,y0,x1,y1]],i) => {
    if (p.x >= x0 && p.x <= x1 && p.y >= y0 && p.y <= y1) hits.push(i);
  });
  if (!hits.length){ selected = -1; lastKey = null; redraw(); return; }
  // cycling keys off the HIT SET, not the exact point — pixel drift or
  // fractional client coords must not break "click again to cycle"
  const k = hits.join(",");
  cycle = k === lastKey ? (cycle + 1) % hits.length : 0;
  lastKey = k; selected = hits[cycle];
  const [id, box, key, depth] = D.cells[selected];
  // final-state partners of this id, aggregated from every emission
  const ids = new Set();
  D.events.forEach(([,,partners],i) => {
    const a = D.cells[i][0];
    for (const j of partners){ const b = D.cells[j][0];
      if (a === id) ids.add(b); if (b === id) ids.add(a); }
  });
  document.getElementById("info").innerHTML =
    `<b>cell ${selected}</b> (click again to cycle ${hits.length})<br>` +
    `object id ${id}<br>key ${key}<br>depth ${depth}<br>` +
    `collides with: ${[...ids].sort((a,b)=>a-b).join(", ") || "nothing"}`;
  redraw();
});
redraw();
</script></body></html>
"""


def cmd_gen_validation_data(args) -> None:
    """Golden pipeline (reference ``gen_validation_data``,
    ``gen_test_data.rs:740-786``) on ``--device``: load the scene, extend
    an empty layer (k1 emits the reference's append order), save
    ``0_layer_unsorted``; sort, save ``1_layer_sorted``; scan (canonical
    pairs, the buffer grown until nothing overflows), save
    ``2_layer_collisions``."""
    sc = scene_io.load(getattr(args, "in"))
    n = len(sc.ids)
    st = layer.make_layer(SPEC, max(n * 2 ** SPEC.dim, 1), min_depth=0,
                          device=args.device)
    st = layer.extend(SPEC, st, sc.system_min, sc.system_max, sc.bounds_min,
                      sc.bounds_max, sc.ids)
    keys, ids, _ = layer.tree_to_numpy(SPEC, st)
    st = layer.sort(SPEC, st)
    skeys, sids, _ = layer.tree_to_numpy(SPEC, st)
    st, res = layer.scan_auto(SPEC, st,
                              initial_capacity=bench_caps.emit_capacity(n))
    if bool(res.overflow):
        raise RuntimeError("the tree overflowed its capacity")
    pairs = layer.scan_result_to_numpy(res)

    os.makedirs(args.out_dir, exist_ok=True)
    sc.layer = scene_io.SceneLayer(0, keys, ids, sorted=False)
    scene_io.save(os.path.join(args.out_dir, "0_layer_unsorted.br_scene"),
                  sc)
    sc.layer = scene_io.SceneLayer(0, skeys, sids, sorted=True)
    scene_io.save(os.path.join(args.out_dir, "1_layer_sorted.br_scene"), sc)
    sc.collisions = pairs
    scene_io.save(os.path.join(args.out_dir,
                               "2_layer_collisions.br_scene"), sc)
    print(f"wrote 3 validation scenes to {args.out_dir} "
          f"(tree={len(sids)}, pairs={len(pairs)})")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="broadphase_tpu_torch.tools")
    sub = p.add_subparsers(dest="cmd", required=True)

    g = sub.add_parser("gen_boxes", help="generate a deterministic scene")
    g.add_argument("--count", type=int, default=None)
    g.add_argument("--density", type=float, default=None)
    g.add_argument("--size", type=float, nargs=2, default=[1.0, 10.0])
    g.add_argument("--seed", type=int, default=0)
    g.add_argument("--out", required=True)
    g.set_defaults(fn=cmd_gen_boxes)

    s = sub.add_parser("show", help="inspect a BR_SCENE file")
    s.add_argument("path")
    s.add_argument("--verbose", action="store_true")
    s.add_argument("--limit", type=int, default=20)
    s.add_argument("--png", default=None)
    s.add_argument("--html", default=None,
                   help="write a self-contained interactive inspector "
                        "(selection cycling + live sweep stepping)")
    s.add_argument("--select", type=int, default=-1)
    s.add_argument("--device", default="cuda",
                   help="where --html builds the tree of a scene that "
                        "stores none (default: the CUDA card)")
    s.set_defaults(fn=cmd_show)

    v = sub.add_parser("gen_validation_data",
                       help="derive golden layer/collision scenes")
    v.add_argument("--in", dest="in", required=True)
    v.add_argument("--out-dir", required=True)
    v.add_argument("--device", default="cuda",
                   help="where the pipeline runs (default: the CUDA card)")
    v.set_defaults(fn=cmd_gen_validation_data)

    args = p.parse_args(argv)
    args.fn(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
