"""What decides ``correct``: the outputs of sampled window frames against
the plain NumPy reference (``reference/``), recomputed from the frame's
own inputs.

Three numbers, each a maximum over the frames checked, each held to its
limit in ``limits.json``:

* ``tree_diff``: entries where the tree's (key, id) differ from the
  reference's sorted tree, plus the difference of the counts, plus 1 if
  the overflow flags differ (the entries are not compared once the
  reference overflows);
* ``pairs_diff``: the same for the candidate pairs, in order where the
  scan is canonical and as a sorted set where not;
* ``pick_gap``: how far the picked ball lies behind the reference's
  nearest hit, in world units: the larger of the gap between the two
  distances and the gap between the reference's distance of the ball the
  program named and the nearest; ``MISS`` where one side hit and the
  other did not, the flags differ, or the program named an id that no
  object of the scene has.

The reference takes the scene's own ids (``scene.ids``, copied to the
host once a cell), which need not be the rows 0..n-1: an engine hands
the broadphase its own handles.

The control (``control.py``) puts the reference computed in bfloat16 in
the program's place and goes through the same comparisons.
"""

from __future__ import annotations

import json
from typing import Dict, Optional

import numpy as np

from .reference import broadphase as ref
from .traffic import ROOT

MISS = 1.0e9
LIMITS = json.loads((ROOT / "limits.json").read_text())


class FrameInputs:
    """A frame's inputs on the host, as the program received them."""

    def __init__(self, cell, frame):
        self.number = frame.number
        self.bounds_min = frame.bounds_min.cpu().numpy()
        self.bounds_max = frame.bounds_max.cpu().numpy()
        self.positions = (None if frame.positions is None
                          else frame.positions.cpu().numpy())
        self.radius = (None if cell.scene.radius is None
                       else cell.scene.radius.cpu().numpy())
        self.ray_unit = None
        if "ray" in cell.traffic:
            period = cell.traffic["ray"]["period"]
            self.ray_unit = cell.ray_units[frame.number % period]


def scene_ids(cell) -> np.ndarray:
    """The scene's ids on the host, copied from the device once a cell
    and kept on it."""
    ids = getattr(cell, "host_ids", None)
    if ids is None:
        ids = cell.host_ids = cell.scene.ids.cpu().numpy()
    return ids


def row_of(ids: np.ndarray, obj_id: int) -> int:
    """The row of the object whose id is ``obj_id`` among the scene's
    ``ids``; -1 where no object has it."""
    order = np.argsort(ids, kind="stable")
    i = int(np.searchsorted(ids, obj_id, sorter=order))
    return int(order[i]) if i < len(ids) and ids[order[i]] == obj_id else -1


class FrameRef:
    """The reference's outputs of one frame, each computed when first
    asked for, in the precision ``rnd`` (``ref.exact`` or ``ref.bf16``)."""

    def __init__(self, cell, inputs: FrameInputs, rnd=ref.exact):
        self.cell, self.inputs, self.rnd = cell, inputs, rnd
        self.spec = ref.SPECS[cell.config["index"]]
        self._tree = self._pairs = self._pick = None

    def tree(self) -> ref.Tree:
        if self._tree is None:
            c, i = self.cell.config, self.inputs
            self._tree = ref.build(
                self.spec, self.cell.scene.system_min,
                self.cell.scene.system_max, i.bounds_min, i.bounds_max,
                scene_ids(self.cell), c["slots_per_axis"],
                c["min_depth"], self.cell.caps.tree, self.rnd)
        return self._tree

    def pairs(self) -> ref.Pairs:
        if self._pairs is None:
            self._pairs = ref.scan(self.spec, self.tree(),
                                   self.cell.caps.pairs, self.cell.caps.emit)
        return self._pairs

    def distances(self) -> np.ndarray:
        i = self.inputs
        return ref.ray_circle(i.positions, i.radius, self.cell.ray_origin,
                              i.ray_unit, self.rnd)

    def pick(self) -> ref.Pick:
        if self._pick is None:
            i = self.inputs
            self._pick = ref.pick(
                self.distances(), scene_ids(self.cell),
                self.cell.scene.system_min, self.cell.scene.system_max,
                i.bounds_min, i.bounds_max,
                self.cell.traffic["ray"]["max_distance"],
                self.tree().overflow)
        return self._pick


# --- the program's outputs on the host --------------------------------------

def host_outputs(out: dict) -> dict:
    """The outputs a frame put in ``out``, copied to the host in the
    reference's forms."""
    host = {}
    if "tree" in out:
        s = out["tree"]
        cnt = int(s.count)
        host["tree"] = ref.Tree(s.keys[:cnt].cpu().numpy().astype(np.uint64),
                                s.ids[:cnt].cpu().numpy(), cnt,
                                bool(s.overflow))
    if "pairs" in out:
        r = out["pairs"]
        cnt = int(r.count)
        a = r.pairs_a[:cnt].cpu().numpy().astype(np.uint64)
        b = r.pairs_b[:cnt].cpu().numpy().astype(np.uint64)
        host["pairs"] = ref.Pairs((a << np.uint64(32)) | b, cnt, -1,
                                  bool(r.overflow))
    if "pick" in out:
        p = out["pick"]
        found = bool(p.found)
        host["pick"] = ref.Pick(found, float(p.distance),
                                int(p.obj_id) if found else -1,
                                bool(p.overflow))
    return host


def control_outputs(frame_ref: FrameRef, kinds) -> dict:
    """The reference's outputs of the kinds a frame makes, in its
    precision: the control, in the program's place."""
    make = {"tree": frame_ref.tree, "pairs": frame_ref.pairs,
            "pick": frame_ref.pick}
    return {k: make[k]() for k in kinds}


# --- comparisons -------------------------------------------------------------

def tree_diff(got: ref.Tree, want: ref.Tree) -> int:
    flags = int(got.overflow != want.overflow)
    if want.overflow:
        return flags
    m = min(got.count, want.count)
    rows = np.count_nonzero((got.keys[:m] != want.keys[:m])
                            | (got.ids[:m] != want.ids[:m]))
    return flags + int(rows) + abs(got.count - want.count)


def pairs_diff(got: ref.Pairs, want: ref.Pairs, canonical: bool) -> int:
    flags = int(got.overflow != want.overflow)
    if want.overflow:
        return flags
    got_p = got.packed if canonical else np.sort(got.packed)
    m = min(len(got_p), want.count)
    return (flags + int(np.count_nonzero(got_p[:m] != want.packed[:m]))
            + abs(len(got_p) - want.count))


def pick_gap(got: ref.Pick, want: ref.Pick, distances: np.ndarray,
             ids: np.ndarray) -> float:
    """``distances`` and ``ids`` by row: the reference's distance of
    each object and its id."""
    if got.found != want.found or got.overflow != want.overflow:
        return MISS
    if not want.found:
        return 0.0
    row = row_of(ids, got.obj_id)
    named = distances[row] if row >= 0 else np.inf
    gap = max(abs(got.distance - want.distance), abs(named - want.distance))
    return float(gap) if np.isfinite(gap) else MISS


def compare(cell, frame_ref: FrameRef, host: dict) -> Dict[str, float]:
    """The numbers of one frame's outputs ``host`` against the exact
    reference ``frame_ref``."""
    got = {}
    if "tree" in host:
        got["tree_diff"] = tree_diff(host["tree"], frame_ref.tree())
    if "pairs" in host:
        got["pairs_diff"] = pairs_diff(host["pairs"], frame_ref.pairs(),
                                       cell.traffic["canonical"])
    if "pick" in host:
        got["pick_gap"] = pick_gap(host["pick"], frame_ref.pick(),
                                   frame_ref.distances(), scene_ids(cell))
    return got


def merge(numbers: Dict[str, float], more: Dict[str, float]) -> None:
    for k, v in more.items():
        numbers[k] = max(numbers.get(k, v), v)


def verdict(numbers: Dict[str, float], frames: int
            ) -> tuple[bool, Dict[str, dict]]:
    """(correct, {number: {"value", "limit"}}): correct when at least one
    frame was checked and every number is within its limit."""
    checks = {k: {"value": v, "limit": LIMITS[k]}
              for k, v in sorted(numbers.items())}
    checks["frames_checked"] = {"value": frames, "limit": 1}
    ok = frames >= 1 and all(c["value"] <= c["limit"]
                             for k, c in checks.items()
                             if k != "frames_checked")
    return ok, checks


def describe(checks: Dict[str, dict]) -> list:
    """One line a number: its name, value and limit."""
    lines = []
    for k, c in checks.items():
        rel = ">=" if k == "frames_checked" else "<="
        lines.append(f"check {k} {c['value']!r} (limit {rel} "
                     f"{c['limit']!r})")
    return lines


def check_frames(cell, held: list, rnd: Optional[object] = None
                 ) -> Dict[str, float]:
    """The numbers over ``held``: (FrameInputs, host outputs) of each
    frame checked; with ``rnd`` (the control) the reference in that
    precision stands in for the outputs."""
    numbers: Dict[str, float] = {}
    for inputs, host in held:
        exact = FrameRef(cell, inputs)
        if rnd is not None:
            host = control_outputs(FrameRef(cell, inputs, rnd), host.keys())
        merge(numbers, compare(cell, exact, host))
    return numbers
