"""Point and region queries by linear replay: test_box, test_ray, pick_ray,
test and pick, on torch tensors.

PyTorch counterpart of the linear engine of ``broadphase_tpu/query.py``.
For every geometry the reference ships, ``should_test`` is monotone (a
child cell passes only if its parent does), so the reference's recursive
walk reports exactly the elements whose own cell passes.  Each element's
root-to-cell halving of the system box is replayed in f32, bit for bit
(``geom.cell_bounds_f32``, and the ray's slab interval in
:func:`ray_intervals_keys`): on the nodes of the halving tree, which a
small table on the host holds, gathered per element.  The predicate is
evaluated once per element; the hits are compacted (kernel 5,
``ops/compact.py``), sorted and deduplicated.  Every query reads the
whole tree: milliseconds per query at 1M elements.

``pick_ray`` is the lexicographic argmin of (distance, the element's visit
rank in the reference's depth-first ray traversal, its position in the
sorted tree), which is the reference's first-visited winner among equal
distances; only the elements at the least distance are ranked.  A query
reads a few counts on the host (the deepest level, the number of hits,
the tied elements).

``get_dist`` and ``should_test`` are user callables on torch tensors on
the layer's device; the ids they are given hold ``PAD_ID`` past the
tree's count, so index per-object arrays only where the mask they are
given is set (or clamp first).

The dispatchers choose the engine as the JAX package does: ``"auto"``
(the default, or ``BROADPHASE_QUERY_ENGINE``) runs the sublinear tree
engine (``singleq.py``) from 32,768 tree lanes up and the linear engine
below; ``"linear"`` and ``"tree"`` force one.  Both give the same
results, bit for bit.

The batched queries (:func:`test_box_batch`, :func:`test_ray_batch`,
:func:`pick_ray_batch`) answer Q queries over one id-sorted view of the
tree, ``chunk`` queries at a time: the predicate runs over a (chunk, cap)
block, and each query's hits are compacted (kernel 5) in id order, the
first hit of each id kept, so no per-query sort is needed.  The JAX
package marks "an earlier lane of this id hits" by a log-step OR-scan
over the block; here one prefix count of the hits per row, compared with
its value at the id group's first lane, marks the same lanes.  A batched
query reads nothing on the host; a batched pick reads its tied lanes, as
the single pick does.  ``pick_ray_batch`` calls ``get_dist`` once per
query, on that query's slice of ``get_dist_args`` (each of which has a
leading Q axis), with the single query's contract.
"""

from __future__ import annotations

import os
from typing import Callable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import geom
from .index import IndexSpec, U32_MASK, depth_of, encode_axis, origin_of
from .layer import PAD_ID, LayerState, TestResult, sort
from .ops.compact import stream_compact

_INT64_MAX = (1 << 63) - 1


def _f32(x, dev) -> torch.Tensor:
    """A query argument as f32 on ``dev`` (host arrays without waiting for
    the card, ``geom.upload``)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=dev, dtype=torch.float32)
    return geom.upload(torch.as_tensor(x, dtype=torch.float32), dev)


def _flag_truncation(state: LayerState, res):
    """OR the layer's overflow flag into a query result: a tree that
    dropped cells may have lost the true answer."""
    return res._replace(overflow=res.overflow | state.overflow)


# ---------------------------------------------------------------------------
# Shared: the replayed cell of every element
# ---------------------------------------------------------------------------

def _element_cells(spec: IndexSpec, state: LayerState, system_min,
                   system_max, max_depth: Optional[int]):
    """(cell_min, cell_max, live): the replayed f32 bounds of each
    element's cell, cut at ``max_depth``, and the mask of live slots."""
    cmin, cmax = geom.cell_bounds_f32(
        spec, origin_of(spec, state.keys), depth_of(spec, state.keys),
        system_min, system_max, replay_depth=max_depth)
    live = torch.arange(state.ids.shape[0], device=state.ids.device) \
        < state.count
    return cmin, cmax, live


def _unique_compact(values: torch.Tensor, mask: torch.Tensor,
                    result_cap: int) -> TestResult:
    """The sorted unique ``values[mask]`` in a buffer of ``result_cap``
    (the reference's ``results.sort(); results.dedup()``): the masked
    values compacted (kernel 5), their count read on the host, only they
    sorted, and the first of each run of equal values compacted again."""
    (hits,), n = stream_compact(mask, (values,), (PAD_ID,))
    v = torch.sort(hits[:int(n)]).values
    keep = torch.ones_like(v, dtype=torch.bool)
    keep[1:] = v[1:] != v[:-1]
    (vals,), count = stream_compact(keep, (v,), (PAD_ID,))
    if vals.shape[0] < result_cap:
        vals = torch.cat([vals, vals.new_full(
            (result_cap - vals.shape[0],), PAD_ID)])
    return TestResult(vals[:result_cap], count.clamp(max=result_cap),
                      count > result_cap)


# ---------------------------------------------------------------------------
# Box queries (reference BoxTestGeometry, src/geom.rs:352-455)
# ---------------------------------------------------------------------------

def test_box_linear(spec: IndexSpec, state: LayerState, system_min,
                    system_max, query_bounds, result_cap: int,
                    max_depth: Optional[int] = None
                    ) -> Tuple[LayerState, TestResult]:
    """All ids whose cell overlaps the query box (reference
    ``Layer::test_box``): query_bounds is (qmin, qmax), (dim,) f32 each, in
    global coordinates.  The linear engine."""
    state = sort(spec, state)
    dev = state.ids.device
    qmin, qmax = _f32(query_bounds[0], dev), _f32(query_bounds[1], dev)
    cmin, cmax, live = _element_cells(spec, state, system_min, system_max,
                                      max_depth)
    hit = geom.bounds_overlaps(cmin, cmax, qmin[None, :], qmax[None, :])
    return state, _flag_truncation(
        state, _unique_compact(state.ids, hit & live, result_cap))


# ---------------------------------------------------------------------------
# Ray queries (reference RayTestGeometry, src/geom.rs:459-689)
# ---------------------------------------------------------------------------

def _ray_nodes(system_min, system_max, ray_origin, ray_dir, levels: int,
               device):
    """Per axis, over every node of the halving tree down to ``levels``
    (``geom.halving_nodes``, whose (lo, hi) come first): over the node's
    path from the root, the least center-plane distance on the ray's far
    side of each center (amax), the largest on its near side (amin), and
    whether an axis-parallel ray missed a child's slab (dead).  Built on
    the host in numpy float32, as ``geom.halving_nodes`` is, and moved to
    ``device`` in one transfer."""
    inf = np.float32(np.inf)
    ro, rd = geom.host_f32(ray_origin), geom.host_f32(ray_dir)
    lo_t, hi_t = geom.halving_nodes_host(system_min, system_max, levels)
    dim = lo_t.shape[1]
    amax = np.full((1, dim), inf, np.float32)
    amin = np.full((1, dim), -inf, np.float32)
    dead = np.zeros((1, dim), np.float32)
    tables = [[amax], [amin], [dead]]
    half32 = np.float32(0.5)
    for b in range(levels):
        level = slice((1 << b) - 1, (2 << b) - 1)
        lo, hi = lo_t[level], hi_t[level]
        half = (hi - lo) * half32
        center = lo + half
        with np.errstate(all="ignore"):
            dist = (center - ro) / rd
        finite = np.isfinite(dist)
        kids = []
        for side in (False, True):
            towards = (rd > 0) != side
            kids.append((
                np.minimum(amax, np.where(finite & towards, dist, inf)),
                np.maximum(amin, np.where(finite & ~towards, dist, -inf)),
                np.maximum(dead, (~finite & ((ro > center) != side))
                           .astype(np.float32))))
        amax, amin, dead = (np.stack(pair, axis=1).reshape(-1, dim)
                            for pair in zip(*kids))
        for t, v in zip(tables, (amax, amin, dead)):
            t.append(v)
    out = geom.upload(torch.from_numpy(np.stack(
        [lo_t, hi_t] + [np.concatenate(t) for t in tables])), device)
    return [out[0], out[1], out[2], out[3], out[4] != 0]


def ray_intervals_keys(spec: IndexSpec, keys: torch.Tensor, system_min,
                       system_max, ray_origin, ray_dir, range_min=0.0,
                       range_max=float("inf"),
                       max_depth: Optional[int] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each key's ray slab interval after replaying its halving path
    (``broadphase_tpu.query.ray_intervals_keys``): the system-bounds clamp
    (finite slab distances only, ``src/geom.rs:515-544``), then per level
    the center-plane distance updates with the axis-parallel kill
    (``:565-575``), in f32 with IEEE infinities and signed zeros.

    The levels are replayed on the nodes of the halving tree down to
    ``geom.TABLE_LEVELS`` (:func:`_ray_nodes`) and gathered per element,
    then element by element below that.  The interval is the min and max
    of the distances a path meets, and (inf, -inf) once a level kills it,
    so it splits by axis and by level exactly.  Like
    ``geom.cell_bounds_f32``, the levels run to the deepest valid key's
    replay depth; pads stop there.  Returns (rmin, rmax): (N,) f32 each."""
    dev = keys.device
    smin, smax = _f32(system_min, dev), _f32(system_max, dev)
    ro, rd = _f32(ray_origin, dev), _f32(ray_dir, dev)
    origin = torch.stack(list(origin_of(spec, keys)), dim=-1)   # (N, dim)
    replay = depth_of(spec, keys).to(torch.int64)
    if max_depth is not None:
        replay = replay.clamp(max=int(max_depth))

    # the with_system_bounds clamp
    d0 = (smin - ro) / rd
    d1 = (smax - ro) / rd
    fwd = rd > 0
    lo_d = torch.where(fwd, d0, d1)
    hi_d = torch.where(fwd, d1, d0)
    rmin0 = _f32(range_min, dev)
    rmax0 = _f32(range_max, dev)
    for axis in range(spec.dim):
        rmin0 = torch.where(geom.finite(lo_d[axis]),
                            torch.maximum(rmin0, lo_d[axis]), rmin0)
        rmax0 = torch.where(geom.finite(hi_d[axis]),
                            torch.minimum(rmax0, hi_d[axis]), rmax0)

    inf = torch.tensor(float("inf"), dtype=torch.float32, device=dev)
    levels = geom.replay_levels(spec, replay)
    cut = min(levels, geom.TABLE_LEVELS)
    rows = geom.node_rows(origin, replay.clamp(max=cut))
    lo, hi, amax, amin, dead = (torch.gather(t, 0, rows) for t in _ray_nodes(
        smin, smax, ro, rd, cut, dev))
    dead = dead.any(dim=-1)
    rmin = torch.where(dead, inf, torch.maximum(rmin0, amin.amax(dim=-1)))
    rmax = torch.where(dead, -inf, torch.minimum(rmax0, amax.amin(dim=-1)))
    for b in range(cut, levels):
        active = (replay > b)[:, None]                          # (N, 1)
        half = (hi - lo) * 0.5
        center = lo + half
        dist = (center - ro) / rd                               # (N, dim)
        side = ((origin >> (31 - b)) & 1) == 1
        finite = geom.finite(dist)
        towards = (rd > 0) != side
        upd_max = active & finite & towards
        upd_min = active & finite & ~towards
        rmax = torch.minimum(rmax,
                             torch.where(upd_max, dist, inf).amin(dim=-1))
        rmin = torch.maximum(rmin,
                             torch.where(upd_min, dist, -inf).amax(dim=-1))
        # an axis-parallel ray outside the child's slab: empty interval
        kill = active & ~finite & ((ro > center) != side)
        dead = kill.any(dim=-1)
        rmin = torch.where(dead, inf, rmin)
        rmax = torch.where(dead, -inf, rmax)
        lo = torch.where(active & side, center, lo)
        hi = torch.where(active & ~side, center, hi)
    return rmin, rmax


def ray_intervals(spec: IndexSpec, state: LayerState, system_min,
                  system_max, ray_origin, ray_dir, range_min=0.0,
                  range_max=float("inf"), max_depth: Optional[int] = None):
    """Whole-tree :func:`ray_intervals_keys` and the live-lane mask:
    (rmin, rmax, live), (cap,) each."""
    rmin, rmax = ray_intervals_keys(spec, state.keys, system_min,
                                    system_max, ray_origin, ray_dir,
                                    range_min, range_max, max_depth)
    live = torch.arange(state.ids.shape[0], device=state.ids.device) \
        < state.count
    return rmin, rmax, live


def test_ray_linear(spec: IndexSpec, state: LayerState, system_min,
                    system_max, ray_origin, ray_dir, range_min, range_max,
                    result_cap: int, max_depth: Optional[int] = None
                    ) -> Tuple[LayerState, TestResult]:
    """All ids whose cell the ray's interval [range_min, range_max]
    crosses (reference ``Layer::test_ray``).  The linear engine."""
    state = sort(spec, state)
    rmin, rmax, live = ray_intervals(spec, state, system_min, system_max,
                                     ray_origin, ray_dir, range_min,
                                     range_max, max_depth)
    return state, _flag_truncation(
        state, _unique_compact(state.ids, (rmin < rmax) & live, result_cap))


class PickResult(NamedTuple):
    distance: torch.Tensor   # () f32; +inf when nothing was hit
    obj_id: torch.Tensor     # () int64; PAD_ID when nothing was hit
    found: torch.Tensor      # () bool
    overflow: torch.Tensor   # () bool: the layer's tree was truncated, so
                             # the true nearest object may be missing


def _argmin_pick(d: torch.Tensor, ids: torch.Tensor, max_dist
                 ) -> PickResult:
    """(least distance below max_dist, its id), ties to the lowest id."""
    hit = d < max_dist
    d = torch.where(hit, d, float("inf"))
    dmin = d.min()
    idmin = torch.where(d == dmin, ids, PAD_ID).min()
    found = hit.any()
    return PickResult(torch.where(found, dmin, float("inf")),
                      torch.where(found, idmin, PAD_ID), found,
                      torch.zeros((), dtype=torch.bool, device=d.device))


def _ray_axis_positions(dim: int, ray_dir: torch.Tensor):
    """Rank-bit position of every axis in the reference's ray traversal
    order (``RayTestGeometry::test_order``): axes ascending by |direction|,
    with the reference's nested-if tie rules; 0-d int64 tensors."""
    a = ray_dir.abs()

    def pick(c, x, y):
        return torch.where(c, x, y)

    if dim == 2:
        c = a[0] <= a[1]
        return (pick(c, 0, 1), pick(c, 1, 0))
    c01, c02, c12 = a[0] <= a[1], a[0] <= a[2], a[1] <= a[2]
    b_a = c01 & c02          # axes = [0,1,2] if c12 else [0,2,1]
    b_b = ~b_a & c12         # axes = [1,0,2] if c02 else [1,2,0]
    #                          else [2,0,1] if c01 else [2,1,0]
    p0 = pick(b_a, 0, pick(b_b, pick(c02, 1, 2), pick(c01, 1, 2)))
    p1 = pick(b_a, pick(c12, 1, 2), pick(b_b, 0, pick(c01, 2, 1)))
    p2 = pick(b_a, pick(c12, 2, 1), pick(b_b, pick(c02, 2, 1), 0))
    return (p0, p1, p2)


def _ray_visit_rank(spec: IndexSpec, origin, depth, ray_dir: torch.Tensor
                    ) -> torch.Tensor:
    """Each element's visit rank in the reference's depth-first traversal
    of a ray (``src/layer.rs:222-230`` with the ray's ``test_order``), as
    one int64 (``broadphase_tpu.query._ray_visit_rank``, whose u32 columns
    it orders like).  The order is a fixed child permutation: per level,
    the axis bits go to their rank positions and flip on axes of negative
    direction, so the rank is the Morton key of the flipped coordinates
    with the axes permuted.  Only the top ``depth`` bits of a coordinate
    count; cells on one path compare as zero-padded ranks, and the caller
    breaks those ties by tree position."""
    pos = _ray_axis_positions(spec.dim, ray_dir)
    d = depth.to(torch.int64)
    keep = torch.where(d >= 1,
                       (U32_MASK << ((32 - d.clamp(max=31)) & 31))
                       & U32_MASK, 0)
    rank = torch.zeros_like(d)
    for axis in range(spec.dim):
        t = torch.where(ray_dir[axis] >= 0, origin[axis],
                        origin[axis] ^ U32_MASK) & keep
        rank = rank | (encode_axis(spec, t) << pos[axis])
    return rank


class _PickWinner(NamedTuple):
    """A pick's winner: its distance, visit rank, tree position and lane."""

    distance: torch.Tensor   # () f32, on the device
    rank: int                # visit rank (:func:`_ray_visit_rank`)
    position: int            # tree position
    lane: int                # lane of the distances the winner came from


def _pick_winner(spec: IndexSpec, d: torch.Tensor, keys: torch.Tensor,
                 max_dist, ray_dir, max_depth: Optional[int],
                 pos: Optional[torch.Tensor] = None
                 ) -> Optional[_PickWinner]:
    """The reference's winner: the first visited among the least
    distances, i.e. the lexicographic argmin of (distance, visit rank,
    tree position), or None when no lane hits.  The lanes at the least
    distance, their keys and tree positions come to the host in one
    transfer, and only they are ranked, there (:func:`_ray_visit_rank` on
    CPU tensors, the depth cut at ``max_depth``).  A lane's tree position
    is ``pos[lane]``, or the lane itself when ``pos`` is None; positions
    are distinct, so the winner is unique."""
    hit = d < max_dist
    d = torch.where(hit, d, float("inf"))
    dmin = d.min()
    lanes = ((d == dmin) & hit).nonzero().squeeze(1)
    if lanes.numel() == 0:
        return None
    host = torch.stack([lanes, keys[lanes],
                        lanes if pos is None else pos[lanes]]).cpu()
    depth = depth_of(spec, host[1])
    if max_depth is not None:
        depth = depth.clamp(max=int(max_depth))
    rank = _ray_visit_rank(spec, origin_of(spec, host[1]), depth,
                           _f32(ray_dir, "cpu"))
    first = torch.where(rank == rank.min(), host[2], _INT64_MAX).argmin()
    return _PickWinner(dmin, int(rank.min()), int(host[2][first]),
                       int(host[0][first]))


def _pick_result(win: Optional[_PickWinner], ids: torch.Tensor
                 ) -> PickResult:
    """A :class:`PickResult` of a winner over ``ids`` (a miss for None)."""
    dev = ids.device
    if win is None:
        false = torch.zeros((), dtype=torch.bool, device=dev)
        return PickResult(torch.full((), float("inf"), device=dev),
                          torch.full((), PAD_ID, device=dev), false, false)
    return PickResult(win.distance, ids[win.lane],
                      torch.ones((), dtype=torch.bool, device=dev),
                      torch.zeros((), dtype=torch.bool, device=dev))


def _argmin_pick_ranked(spec: IndexSpec, d: torch.Tensor,
                        keys: torch.Tensor, ids: torch.Tensor, max_dist,
                        ray_dir, max_depth: Optional[int],
                        pos: Optional[torch.Tensor] = None) -> PickResult:
    """The pick over lanes ``d`` of ``ids``: :func:`_pick_winner`'s
    distance and id."""
    return _pick_result(_pick_winner(spec, d, keys, max_dist, ray_dir,
                                     max_depth, pos), ids)


def _distances(get_dist: Callable, args, cand: torch.Tensor) -> torch.Tensor:
    """The user's distances as f32, +inf where not a candidate or not
    finite (a miss)."""
    d = torch.as_tensor(get_dist(*args), dtype=torch.float32,
                        device=cand.device)
    return torch.where(geom.finite(d) & cand, d, float("inf"))


def pick_ray_linear(spec: IndexSpec, state: LayerState, system_min,
                    system_max, ray_origin, ray_dir, max_distance,
                    get_dist: Callable, get_dist_args=(),
                    max_depth: Optional[int] = None
                    ) -> Tuple[LayerState, PickResult]:
    """Nearest object along a ray (reference ``Layer::pick_ray``).  The
    linear engine.

    ``get_dist(ids, mask, *get_dist_args) -> f32 distances`` is the
    vectorized narrow phase over every tree slot; non-finite distances
    are misses.  The candidates are the elements whose cell interval
    passes with nearest = ``max_distance``; the winner is the first
    visited among the least distances (:func:`_argmin_pick_ranked`)."""
    state = sort(spec, state)
    dev = state.ids.device
    md = _f32(max_distance, dev)
    rmin, rmax, live = ray_intervals(spec, state, system_min, system_max,
                                     ray_origin, ray_dir, 0.0, md,
                                     max_depth)
    cand = (rmin < rmax) & (rmin < md) & live
    d = _distances(get_dist, (state.ids, cand, *get_dist_args), cand)
    return state, _flag_truncation(state, _argmin_pick_ranked(
        spec, d, state.keys, state.ids, md, ray_dir, max_depth))


# ---------------------------------------------------------------------------
# Generic geometry (reference TestGeometry, src/geom.rs:327-348)
# ---------------------------------------------------------------------------

def test(spec: IndexSpec, state: LayerState, system_min, system_max,
         should_test: Callable, should_test_args=(), result_cap: int = 256,
         max_depth: Optional[int] = None) -> Tuple[LayerState, TestResult]:
    """Generic query (``broadphase_tpu.query.test``):
    ``should_test(cell_min, cell_max, *should_test_args) -> bool (cap,)``
    over the replayed (cap, dim) f32 cell bounds.  It must be monotone
    (a child passes only if its parent does), as every reference geometry
    is: that is what makes the elementwise replay exact."""
    state = sort(spec, state)
    cmin, cmax, live = _element_cells(spec, state, system_min, system_max,
                                      max_depth)
    hit = torch.as_tensor(should_test(cmin, cmax, *should_test_args),
                          dtype=torch.bool, device=live.device)
    return state, _flag_truncation(
        state, _unique_compact(state.ids, hit & live, result_cap))


def pick(spec: IndexSpec, state: LayerState, system_min, system_max,
         get_dist: Callable, max_distance=float("inf"), get_dist_args=(),
         max_depth: Optional[int] = None) -> Tuple[LayerState, PickResult]:
    """Generic nearest-object query (reference ``Layer::pick``):
    ``get_dist(ids, cell_min, cell_max, mask, *get_dist_args) -> f32``
    over the replayed cells; non-finite is a miss; ties go to the lowest
    id."""
    state = sort(spec, state)
    cmin, cmax, live = _element_cells(spec, state, system_min, system_max,
                                      max_depth)
    d = _distances(get_dist, (state.ids, cmin, cmax, live, *get_dist_args),
                   live)
    return state, _flag_truncation(
        state, _argmin_pick(d, state.ids, _f32(max_distance, live.device)))


# ---------------------------------------------------------------------------
# Dispatchers: linear replay or sublinear tree descent
# ---------------------------------------------------------------------------

_TREE_ENGINE_MIN_CAP = 32768


def _engine(engine: Optional[str], cap: int) -> str:
    """The engine a query runs (``broadphase_tpu.query._engine``):
    ``engine``, else ``BROADPHASE_QUERY_ENGINE``, else ``"auto"``, which
    is the tree engine from 32,768 lanes up."""
    if engine is None:
        engine = os.environ.get("BROADPHASE_QUERY_ENGINE", "auto")
    if engine == "auto":
        return "tree" if cap >= _TREE_ENGINE_MIN_CAP else "linear"
    if engine not in ("linear", "tree"):
        raise ValueError(f"unknown query engine {engine!r}; expected "
                         "'linear', 'tree' or 'auto'")
    return engine


def test_box(spec: IndexSpec, state: LayerState, system_min, system_max,
             query_bounds, result_cap: int, max_depth: Optional[int] = None,
             engine: Optional[str] = None,
             candidate_cap: Optional[int] = None
             ) -> Tuple[LayerState, TestResult]:
    """``Layer::test_box`` (``broadphase_tpu.query.test_box``) by the
    engine :func:`_engine` picks."""
    if _engine(engine, state.ids.shape[0]) == "tree":
        from . import singleq
        return singleq.test_box(
            spec, state, system_min, system_max, query_bounds, result_cap,
            max_depth, candidate_cap or singleq.CANDIDATE_CAP)
    return test_box_linear(spec, state, system_min, system_max,
                           query_bounds, result_cap, max_depth)


def test_ray(spec: IndexSpec, state: LayerState, system_min, system_max,
             ray_origin, ray_dir, range_min, range_max, result_cap: int,
             max_depth: Optional[int] = None, engine: Optional[str] = None,
             candidate_cap: Optional[int] = None,
             frontier_cap: Optional[int] = None
             ) -> Tuple[LayerState, TestResult]:
    """``Layer::test_ray`` (``broadphase_tpu.query.test_ray``) by the
    engine :func:`_engine` picks."""
    if _engine(engine, state.ids.shape[0]) == "tree":
        from . import singleq
        return singleq.test_ray(
            spec, state, system_min, system_max, ray_origin, ray_dir,
            range_min, range_max, result_cap, max_depth,
            candidate_cap or singleq.CANDIDATE_CAP,
            frontier_cap or singleq.FRONTIER_CAP)
    return test_ray_linear(spec, state, system_min, system_max, ray_origin,
                           ray_dir, range_min, range_max, result_cap,
                           max_depth)


def pick_ray(spec: IndexSpec, state: LayerState, system_min, system_max,
             ray_origin, ray_dir, max_distance, get_dist: Callable,
             get_dist_args=(), max_depth: Optional[int] = None,
             engine: Optional[str] = None,
             candidate_cap: Optional[int] = None,
             frontier_cap: Optional[int] = None
             ) -> Tuple[LayerState, PickResult]:
    """``Layer::pick_ray`` (``broadphase_tpu.query.pick_ray``) by the
    engine :func:`_engine` picks."""
    if _engine(engine, state.ids.shape[0]) == "tree":
        from . import singleq
        return singleq.pick_ray(
            spec, state, system_min, system_max, ray_origin, ray_dir,
            max_distance, get_dist, get_dist_args, max_depth,
            candidate_cap or singleq.CANDIDATE_CAP,
            frontier_cap or singleq.FRONTIER_CAP)
    return pick_ray_linear(spec, state, system_min, system_max, ray_origin,
                           ray_dir, max_distance, get_dist, get_dist_args,
                           max_depth)


# ---------------------------------------------------------------------------
# Batched queries: Q queries over one id-sorted view
# ---------------------------------------------------------------------------

_BATCH_CHUNK = 64


def _id_sorted_view(spec: IndexSpec, state: LayerState, system_min,
                    system_max, max_depth: Optional[int], with_ray: bool):
    """The elements in id order (a stable sort, so equal ids keep their
    tree order) with their replayed cells: (ids, tree positions, cell_min,
    cell_max, live, keys); the keys only for rays (their visit ranks),
    else None."""
    cmin, cmax, live = _element_cells(spec, state, system_min, system_max,
                                      max_depth)
    pos = torch.sort(state.ids, stable=True).indices
    keys = state.keys[pos] if with_ray else None
    return state.ids[pos], pos, cmin[pos], cmax[pos], live[pos], keys


def _group_starts(ids_sorted: torch.Tensor) -> torch.Tensor:
    """For id-sorted elements: the lane where each one's id group
    starts."""
    lane = torch.arange(ids_sorted.shape[0], device=ids_sorted.device)
    first = torch.ones_like(ids_sorted, dtype=torch.bool)
    first[1:] = ids_sorted[1:] != ids_sorted[:-1]
    return torch.cummax(torch.where(first, lane, 0), 0).values


def _unique_rows_sorted(ids_sorted: torch.Tensor, starts: torch.Tensor,
                        hit: torch.Tensor, result_cap: int
                        ) -> List[TestResult]:
    """:func:`_unique_compact` of each row of ``hit`` (chunk, cap) over
    the id-sorted elements: a lane is kept when it hits and no earlier
    lane of its id group does (the hits before it equal the hits before
    its group's first lane); the kept ids are already in ascending order
    and distinct, and are compacted by kernel 5, one launch per row."""
    before = torch.cumsum(hit, dim=1, dtype=torch.int32) - hit.to(
        torch.int32)
    keep = hit & (before == before[:, starts])
    out = []
    for row in keep:
        (vals,), count = stream_compact(row, (ids_sorted,), (PAD_ID,))
        if vals.shape[0] < result_cap:
            vals = torch.cat([vals, vals.new_full(
                (result_cap - vals.shape[0],), PAD_ID)])
        out.append(TestResult(vals[:result_cap],
                              count.clamp(max=result_cap),
                              count > result_cap))
    return out


def _stack(rows, empty):
    """Rows of one result type stacked on a leading Q axis."""
    if not rows:
        return empty
    return type(rows[0])(*(torch.stack(f) for f in zip(*rows)))


def _empty_hits(result_cap: int, dev) -> TestResult:
    return TestResult(torch.full((0, result_cap), PAD_ID, device=dev),
                      torch.zeros(0, dtype=torch.int64, device=dev),
                      torch.zeros(0, dtype=torch.bool, device=dev))


def _ray_intervals_cells(spec: IndexSpec, cmin, cmax, system_min,
                         system_max, ro, rd, range_min, range_max):
    """Each element's ray slab interval straight from its replayed cell
    bounds (``broadphase_tpu.query._ray_intervals_cells``), for a chunk of
    rays: ro, rd (C, dim) f32, range_min/max (C,) f32, cmin/cmax (cap,
    dim).  Every distance the level-by-level replay takes is to a face of
    the final cell or to a plane outside it along the ray, by the same
    f32 expression, so the interval is the replay's, bit for bit; the
    axis-parallel kill applies only at halved faces (inside the system
    box).  Returns (rmin, rmax): (C, cap) f32 each."""
    dev = cmin.device
    smin, smax = _f32(system_min, dev), _f32(system_max, dev)
    rmin = range_min[:, None].expand(-1, cmin.shape[0])
    rmax = range_max[:, None].expand(-1, cmin.shape[0])
    for axis in range(spec.dim):
        lo_f, hi_f = cmin[None, :, axis], cmax[None, :, axis]
        o, r = ro[:, axis, None], rd[:, axis, None]
        d_lo = (lo_f - o) / r
        d_hi = (hi_f - o) / r
        fwd = r > 0
        enter = torch.where(fwd, d_lo, d_hi)
        leave = torch.where(fwd, d_hi, d_lo)
        rmin = torch.where(geom.finite(enter),
                           torch.maximum(rmin, enter), rmin)
        rmax = torch.where(geom.finite(leave),
                           torch.minimum(rmax, leave), rmax)
        kill = ~geom.finite(d_lo) & (
            ((lo_f > smin[axis]) & (o <= lo_f))
            | ((hi_f < smax[axis]) & (o > hi_f)))
        rmin = torch.where(kill, torch.inf, rmin)
        rmax = torch.where(kill, -torch.inf, rmax)
    return rmin, rmax


def _per_query(x, Q: int, dev) -> torch.Tensor:
    """A scalar or (Q,) argument as (Q,) f32 on ``dev``."""
    return _f32(x, dev).expand(Q).contiguous()


def test_box_batch(spec: IndexSpec, state: LayerState, system_min,
                   system_max, query_bounds, result_cap: int,
                   max_depth: Optional[int] = None,
                   chunk: int = _BATCH_CHUNK
                   ) -> Tuple[LayerState, TestResult]:
    """:func:`test_box` over (Q, dim) query boxes
    (``broadphase_tpu.query.test_box_batch``); the result's fields carry a
    leading Q axis, and each row equals the single query's."""
    state = sort(spec, state)
    dev = state.ids.device
    qmin, qmax = _f32(query_bounds[0], dev), _f32(query_bounds[1], dev)
    ids_s, _, cmin, cmax, live, _ = _id_sorted_view(
        spec, state, system_min, system_max, max_depth, with_ray=False)
    starts = _group_starts(ids_s)
    rows = []
    for c in range(0, qmin.shape[0], chunk):
        hit = geom.bounds_overlaps(cmin[None], cmax[None],
                                   qmin[c:c + chunk, None, :],
                                   qmax[c:c + chunk, None, :]) & live
        rows += _unique_rows_sorted(ids_s, starts, hit, result_cap)
    return state, _flag_truncation(state, _stack(
        rows, _empty_hits(result_cap, dev)))


def test_ray_batch(spec: IndexSpec, state: LayerState, system_min,
                   system_max, ray_origins, ray_dirs, range_min, range_max,
                   result_cap: int, max_depth: Optional[int] = None,
                   chunk: int = _BATCH_CHUNK
                   ) -> Tuple[LayerState, TestResult]:
    """:func:`test_ray` over (Q, dim) origins and directions
    (``broadphase_tpu.query.test_ray_batch``); ``range_min`` and
    ``range_max`` are scalars or (Q,)."""
    state = sort(spec, state)
    dev = state.ids.device
    ro, rd = _f32(ray_origins, dev), _f32(ray_dirs, dev)
    Q = ro.shape[0]
    lo, hi = _per_query(range_min, Q, dev), _per_query(range_max, Q, dev)
    ids_s, _, cmin, cmax, live, _ = _id_sorted_view(
        spec, state, system_min, system_max, max_depth, with_ray=False)
    starts = _group_starts(ids_s)
    rows = []
    for c in range(0, Q, chunk):
        q = slice(c, c + chunk)
        rmin, rmax = _ray_intervals_cells(spec, cmin, cmax, system_min,
                                          system_max, ro[q], rd[q], lo[q],
                                          hi[q])
        rows += _unique_rows_sorted(ids_s, starts, (rmin < rmax) & live,
                                    result_cap)
    return state, _flag_truncation(state, _stack(
        rows, _empty_hits(result_cap, dev)))


def _pick_batch_winners(spec: IndexSpec, state: LayerState, system_min,
                        system_max, ray_origins, ray_dirs, max_distance,
                        get_dist: Callable, get_dist_args,
                        max_depth: Optional[int], chunk: int):
    """:func:`pick_ray_batch`'s engine over a sorted ``state``: returns the
    id-sorted view's ids and each query's :func:`_pick_winner` over them
    (None on a miss), whose position is the element's tree lane."""
    dev = state.ids.device
    ro, rd = _f32(ray_origins, dev), _f32(ray_dirs, dev)
    Q = ro.shape[0]
    md = _per_query(max_distance, Q, dev)
    rd_host = geom.host_f32(ray_dirs)
    ids_s, pos_s, cmin, cmax, live, keys_s = _id_sorted_view(
        spec, state, system_min, system_max, max_depth, with_ray=True)
    zero = torch.zeros(Q, dtype=torch.float32, device=dev)
    wins = []
    for c in range(0, Q, chunk):
        q = slice(c, c + chunk)
        rmin, rmax = _ray_intervals_cells(spec, cmin, cmax, system_min,
                                          system_max, ro[q], rd[q], zero[q],
                                          md[q])
        for j in range(rmin.shape[0]):
            i = c + j
            cand = (rmin[j] < rmax[j]) & (rmin[j] < md[i]) & live
            d = _distances(get_dist, (ids_s, cand, *(a[i] for a in
                                                     get_dist_args)), cand)
            wins.append(_pick_winner(spec, d, keys_s, md[i], rd_host[i],
                                     max_depth, pos_s))
    return ids_s, wins


def pick_ray_batch(spec: IndexSpec, state: LayerState, system_min,
                   system_max, ray_origins, ray_dirs, max_distance,
                   get_dist: Callable, get_dist_args=(),
                   max_depth: Optional[int] = None,
                   chunk: int = _BATCH_CHUNK
                   ) -> Tuple[LayerState, PickResult]:
    """:func:`pick_ray` over (Q, dim) rays
    (``broadphase_tpu.query.pick_ray_batch``); the result's fields carry a
    leading Q axis.  ``max_distance`` is a scalar or (Q,); every element
    of ``get_dist_args`` has a leading Q axis, and ``get_dist(ids, mask,
    *args_q)`` is called once per query, over the id-sorted elements."""
    state = sort(spec, state)
    dev = state.ids.device
    ids_s, wins = _pick_batch_winners(
        spec, state, system_min, system_max, ray_origins, ray_dirs,
        max_distance, get_dist, get_dist_args, max_depth, chunk)
    rows = [_pick_result(w, ids_s) for w in wins]
    false = torch.zeros(0, dtype=torch.bool, device=dev)
    return state, _flag_truncation(state, _stack(rows, PickResult(
        torch.zeros(0, device=dev), torch.zeros(0, dtype=torch.int64,
                                                device=dev), false, false)))
