"""Host-side cell geometry for the tools: one key at a time, on Python
ints, and a cell's rectangle in global coordinates.

The port's own copy of the part of ``broadphase_tpu/utils/oracle.py``
that the CLI and the scan visualizer use (``depth_of``, ``origin_of``,
``scale_at_depth``, ``overlaps``), with the origin decoded by this
package's ``index.py`` codec and the rectangle mapped by
``geom.to_global``, which runs the oracle's f32 operations in its order.
torch on the CPU only.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import geom, index
from .index import IndexSpec

U32 = 0xFFFF_FFFF


def depth_of(spec: IndexSpec, key: int) -> int:
    return int(key) & spec.depth_mask


def origin_of(spec: IndexSpec, key: int) -> Tuple[int, ...]:
    """The top-aligned u32 coordinate of each axis of one key."""
    axes = index.origin_of(spec, torch.tensor([int(key)], dtype=torch.int64))
    return tuple(int(a[0]) for a in axes)


def scale_at_depth(depth: int) -> int:
    """Side of a cell of ``depth`` > 0 in u32 local units."""
    if depth <= 0:
        raise ValueError(f"scale_at_depth needs depth > 0, got {depth}")
    return 1 << (32 - depth)


def _level_mask(spec: IndexSpec, depth: int) -> int:
    if depth <= 0:
        return 0
    return (((1 << (spec.dim * depth)) - 1)
            << (spec.key_bits - spec.dim * depth))


def overlaps(spec: IndexSpec, a: int, b: int) -> bool:
    """Two cells overlap iff one is an ancestor-or-equal of the other
    (reference ``src/index.rs:116-122``)."""
    depth = min(depth_of(spec, a), depth_of(spec, b))
    return (int(a) ^ int(b)) & _level_mask(spec, depth) == 0


def cell_rect_xy(spec: IndexSpec, key: int, system_min, system_max
                 ) -> Tuple[float, float, float, float]:
    """(x0, y0, x1, y1): the XY projection of one cell's global bounds; a
    depth-0 key covers the whole system."""
    depth = depth_of(spec, key)
    origin = origin_of(spec, key)
    if depth == 0:
        lo, hi = [0, 0], [U32] * 2
    else:
        scale = scale_at_depth(depth)
        lo = list(origin[:2])
        hi = [o + scale - 1 for o in origin[:2]]
    pts = torch.tensor([lo + [0] * (len(origin) - 2),
                        hi + [0] * (len(origin) - 2)], dtype=torch.int64)
    g = geom.to_global(system_min, system_max, pts)
    return float(g[0, 0]), float(g[0, 1]), float(g[1, 0]), float(g[1, 1])
