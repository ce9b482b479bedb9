"""Plain NumPy reference of the broadphase's semantics.

Written from the semantics of the upstream library (zvxryb/broadphase-rs:
``src/geom.rs`` quantization and grid walk, ``src/index.rs`` key layout,
``src/layer.rs`` stack sweep) and independent of the code under test: it
imports numpy only.  The Morton codec spreads the bits through a table of
bytes, unlike the masked shifts a device codec uses, so the two check
each other.

* :func:`build`: quantize the f32 bounds, pick each object's depth, walk
  its covering cells (at most ``slots_per_axis`` per axis, overflow
  flagged) and sort the (key, id) tree;
* :func:`scan`: every (later id, earlier id) pair of tree entries whose
  earlier cell contains the later one (the sweep's stack), sorted and
  deduplicated as unsigned (a, b) tuples;
* :func:`ray_circle` and :func:`pick`: the exact ray-circle distance of
  every ball and the nearest hit.

Every f32 operation of the quantization and of the ray-circle distance
goes through ``rnd``: :func:`exact` keeps numpy's IEEE f32 rounding, and
:func:`bf16` rounds each result to bfloat16, the precision below the
f32 that a configuration states (the benchmark's control).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

U32 = 0xFFFF_FFFF
RANGE_MAX = np.float32(4294967040.0)    # 0xFFFF_FF00 as f32 (geom.rs)


class Spec(NamedTuple):
    """A key layout: depth in the low ``depth_bits``, the Morton-coded
    top ``axis_bits`` of each u32 axis coordinate above it, x lowest."""

    dim: int
    depth_bits: int
    axis_bits: int

    @property
    def key_bits(self) -> int:
        return self.dim * self.axis_bits + self.depth_bits


SPECS = {
    "Index32_2D": Spec(2, 4, 14),
    "Index64_2D": Spec(2, 5, 29),
    "Index64_3D": Spec(3, 5, 19),
}


def exact(x: np.ndarray) -> np.ndarray:
    return x


def bf16(x: np.ndarray) -> np.ndarray:
    """f32 values rounded to the nearest bfloat16, ties to even."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF_0000
    return u.astype(np.uint32).view(np.float32)


def _f32(x) -> np.ndarray:
    return np.asarray(x, np.float32)


def quantize(system_min, system_max, pts, rnd=exact) -> np.ndarray:
    """u32 local coordinates (as int64) of f32 points (..., dim):
    ``(p - min) / (max - min) * RANGE_MAX``, clamped, NaN to 0, truncated
    (geom.rs ``to_local``)."""
    smin, smax, pts = _f32(system_min), _f32(system_max), _f32(pts)
    size = rnd(smax - smin)
    ratio = rnd(rnd(pts - smin) / size)
    v = rnd(ratio * RANGE_MAX)
    v = np.clip(v, np.float32(0), RANGE_MAX)
    return np.where(np.isnan(v), np.float32(0), v).astype(np.int64)


def _bit_length(v: np.ndarray) -> np.ndarray:
    """Significant bits of non-negative integers below 2^53."""
    return np.frexp(v.astype(np.float64))[1].astype(np.int64)


def depths(spec: Spec, lmin: np.ndarray, lmax: np.ndarray,
           min_depth: int) -> np.ndarray:
    """Per-object depth: leading zeros of the largest axis size minus one,
    at least ``min_depth``, at most ``axis_bits`` (geom.rs)."""
    size = (lmax - lmin + 1) & U32
    v = (size.max(axis=-1) - 1) & U32
    return np.clip(32 - _bit_length(v), min_depth, spec.axis_bits)


def _spread_table(dim: int) -> np.ndarray:
    """Bit i of each byte moved to bit ``dim * i``, one bit at a time."""
    v = np.arange(256, dtype=np.int64)
    out = np.zeros(256, np.int64)
    for i in range(8):
        out |= ((v >> i) & 1) << (dim * i)
    return out


_TABLES = {d: _spread_table(d) for d in (2, 3)}


def spread(spec: Spec, coord: np.ndarray) -> np.ndarray:
    """The top ``axis_bits`` of a u32 coordinate, bit i moved to bit
    ``dim * i``: byte by byte through :func:`_spread_table`."""
    v = (coord & U32) >> (32 - spec.axis_bits)
    table = _TABLES[spec.dim]
    out = np.zeros_like(v)
    for byte in range(0, spec.axis_bits, 8):
        out |= table[(v >> byte) & 0xFF] << (spec.dim * byte)
    return out


class Tree(NamedTuple):
    keys: np.ndarray        # (count,) uint64, sorted by (key, id)
    ids: np.ndarray         # (count,) int64
    count: int              # cells emitted
    overflow: bool          # count over the capacity, or a cell overflow


def build(spec: Spec, system_min, system_max, bounds_min, bounds_max, ids,
          slots_per_axis: int, min_depth: int, capacity: int,
          rnd=exact) -> Tree:
    """The sorted tree of the objects inside the system box (layer.rs
    ``extend`` + ``sort``).  Each object covers ``slots_per_axis`` cells
    or fewer on each axis at its depth, x fastest; one that needs more
    raises the overflow flag, as does a tree over ``capacity``."""
    smin, smax = _f32(system_min), _f32(system_max)
    bmin, bmax = _f32(bounds_min), _f32(bounds_max)
    ids = np.asarray(ids, np.int64)
    inside = np.all((smin <= bmin) & (smax >= bmax), axis=-1)
    bmin, bmax, ids = bmin[inside], bmax[inside], ids[inside]
    lmin = quantize(smin, smax, bmin, rnd)
    lmax = quantize(smin, smax, bmax, rnd)
    depth = depths(spec, lmin, lmax, min_depth)
    low = np.where(depth == 0, 0, (np.int64(1) << (32 - depth)) - 1)
    tmin = lmin & ~low[:, None] & U32
    tmax = lmax & ~low[:, None] & U32
    shift = np.minimum(32 - depth, 31)
    naxis = np.where(depth[:, None] == 0, 1,
                     ((tmax - tmin) >> shift[:, None]) + 1)
    A = slots_per_axis
    cell_overflow = bool(np.any(naxis > A))
    step = np.where(depth == 0, 0, np.int64(1) << shift)
    # each axis's two cell coordinates, spread: (n, A) per axis
    axes = [np.stack([spread(spec, tmin[:, k] + off * step)
                      for off in range(A)], axis=1) << k
            for k in range(spec.dim)]
    slots = A ** spec.dim
    offs = np.array([[(s // A ** k) % A for k in range(spec.dim)]
                     for s in range(slots)])                 # (S, dim)
    valid = np.ones((len(ids), slots), bool)
    key = np.zeros((len(ids), slots), np.int64)
    for k in range(spec.dim):
        valid &= offs[None, :, k] < naxis[:, k:k + 1]
        key |= axes[k][:, offs[:, k]]
    key <<= spec.depth_bits
    key |= depth[:, None]
    key[depth == 0] = 0
    keys, owners = _sort_by_key_then_id(
        key[valid].astype(np.uint64),
        np.broadcast_to(ids[:, None], valid.shape)[valid])
    count = len(keys)
    return Tree(keys, owners, count, cell_overflow or count > capacity)


def _sort_by_key_then_id(keys: np.ndarray, ids: np.ndarray):
    """(keys, ids) in (key, id) order, ids below 2^32: a sort by key, then
    one sort of ``rank of the key << 32 | id``."""
    if len(keys) == 0:
        return keys, ids
    order = np.argsort(keys)
    ks = keys[order]
    new = np.empty(len(ks), bool)
    new[0] = True
    np.not_equal(ks[1:], ks[:-1], out=new[1:])
    rank = (np.cumsum(new) - 1).astype(np.uint64)
    packed = np.sort((rank << np.uint64(32)) | ids[order].astype(np.uint64))
    return (ks[new][(packed >> np.uint64(32)).astype(np.int64)],
            (packed & np.uint64(U32)).astype(np.int64))


class Pairs(NamedTuple):
    packed: np.ndarray      # (count,) uint64 ``a << 32 | b``, ascending
    count: int
    emitted: int            # raw emissions: entries under each entry's cell
    overflow: bool


def scan(spec: Spec, tree: Tree, pair_capacity: int,
         emit_capacity: int) -> Pairs:
    """The stack sweep (layer.rs ``scan``) over a sorted tree: entry j
    meets entry i < j when i's cell contains j's, that is when
    ``key_i <= key_j <= descendant_max(key_i)``; each meeting of two ids
    gives (id_j, id_i).  Sorted and deduplicated as unsigned tuples.  The
    overflow flag: the tree's, more raw emissions than ``emit_capacity``,
    or more pairs than ``pair_capacity``."""
    keys, ids = tree.keys, tree.ids
    n = len(keys)
    depth = (keys & np.uint64((1 << spec.depth_bits) - 1)).astype(np.int64)
    below = (spec.key_bits - spec.dim * depth).astype(np.uint64)
    dmax = keys | ((np.uint64(1) << below) - np.uint64(1))
    ends = np.searchsorted(keys, dmax, side="right")
    lane = np.arange(n, dtype=np.int64)
    runs = ends - lane - 1
    emitted = int(runs.sum())
    # (first, second) entry of each emission, in 32 bits where they fit
    idx = np.int32 if n + emitted < 2 ** 31 else np.int64
    first = np.repeat(lane.astype(idx), runs)
    second = np.arange(1, emitted + 1, dtype=idx)
    second -= np.repeat((np.cumsum(runs) - runs).astype(idx), runs)
    second += first
    ids32 = ids.astype(np.uint32)
    a, b = ids32[second], ids32[first]
    del first, second
    keep = a != b
    packed = a[keep].astype(np.uint64) << np.uint64(32)
    packed |= b[keep]
    packed = np.unique(packed)
    count = len(packed)
    return Pairs(packed, count, emitted,
                 tree.overflow or emitted > emit_capacity
                 or count > pair_capacity)


def ray_circle(pos, radius, origin, dirn, rnd=exact) -> np.ndarray:
    """Each ball's distance along the unit ray from ``origin``, +inf on a
    miss (the upstream ball-pit example's narrow phase, main.rs)."""
    pos, radius = _f32(pos), _f32(radius)
    origin, dirn = _f32(origin), _f32(dirn)
    cx, cy = rnd(pos[:, 0] - origin[0]), rnd(pos[:, 1] - origin[1])
    t = rnd(rnd(cx * dirn[0]) + rnd(cy * dirn[1]))
    d2 = rnd(rnd(rnd(cx * cx) + rnd(cy * cy)) - rnd(t * t))
    r2 = rnd(radius * radius)
    root = rnd(np.sqrt(np.maximum(rnd(r2 - d2), np.float32(0))))
    hit = (d2 <= r2) & (rnd(t + root) >= 0)
    return np.where(hit, rnd(t - root), np.float32(np.inf))


class Pick(NamedTuple):
    found: bool
    distance: float         # +inf when nothing was hit
    obj_id: int             # -1 when nothing was hit
    overflow: bool          # the tree's flag: a ball may be missing


def pick(distances: np.ndarray, ids, system_min, system_max, bounds_min,
         bounds_max, max_distance: float, tree_overflow: bool) -> Pick:
    """The nearest ball inside the system box whose distance is finite
    and below ``max_distance``; the lowest id among equal distances."""
    smin, smax = _f32(system_min), _f32(system_max)
    inside = np.all((smin <= _f32(bounds_min)) & (smax >= _f32(bounds_max)),
                    axis=-1)
    d = np.where(inside & np.isfinite(distances)
                 & (distances < np.float32(max_distance)), distances,
                 np.float32(np.inf))
    if not np.isfinite(d).any():
        return Pick(False, float("inf"), -1, tree_overflow)
    best = d.min()
    return Pick(True, float(best),
                int(np.asarray(ids, np.int64)[d == best].min()),
                tree_overflow)
