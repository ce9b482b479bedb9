"""Buffer capacities of a cell, from its configuration's per-object
sizes: a copy of ``broadphase_tpu_torch/bench_caps.py``'s arithmetic (the
1M scene emits 3.28 cells, 15.7 raw emissions and 8.53 unique pairs an
object), so that the yardstick does not move with the program."""

from __future__ import annotations

from typing import NamedTuple


class Caps(NamedTuple):
    tree: int
    pairs: int
    emit: int


def tree_capacity(n: int, tenths: int) -> int:
    """``tenths / 10`` cells an object, rounded up past a multiple of
    1024."""
    return ((max(1, (tenths * n) // 10) // 1024) + 1) * 1024


def per_object(n: int, slack: int) -> int:
    """``slack`` an object, rounded down to a multiple of 1024."""
    return ((slack * n) // 1024) * 1024


def cell_caps(config: dict) -> Caps:
    n, c = config["objects"], config["capacity"]
    return Caps(tree_capacity(n, c["tree_tenths_per_object"]),
                per_object(n, c["pairs_per_object"]),
                per_object(n, c["emit_per_object"]))


def update_caps(n: int, churn_frac: float) -> tuple:
    """(churn_cap, obj_cap) for an update frame in which ``churn_frac`` of
    the n objects change cells: 8.25 cell slots per changed object on each
    side (every mover may fill its whole 2x2x2 block), and ~30% headroom on
    the changed-object count."""
    objs = max(64, int(n * churn_frac))
    churn_cap = ((8 * objs + objs // 4) // 1024 + 1) * 1024
    obj_cap = ((objs + (3 * objs) // 10) // 1024 + 1) * 1024
    return churn_cap, obj_cap
