"""Generic TestGeometry traversals on torch tensors: the masked
breadth-first walk (test_generic, pick_generic) and the ordered
depth-first pick (pick_ordered, pick_ray_ordered).

PyTorch counterpart of ``broadphase_tpu/traverse.py``.  The linear query
engine is exact only for monotone geometries (a child cell passes only if
its parent does); the reference's recursive ``test_impl``
(``src/layer.rs:167-239``) prunes a whole subtree the moment one cell
fails ``should_test``, so a non-monotone predicate loses descendants that
would pass their own test.  These walks keep that pruning.

* :func:`test_generic` and :func:`pick_generic`: a frontier of at most
  ``frontier_cap`` (cell key, element slice, user geometry state) lanes
  advances one depth per step.  One search of the sorted keys splits
  every slice among the ``2**dim`` children; the elements before the first
  child are at the cell and are reported; children that fail
  ``should_test`` or hold no elements drop out, and the survivors are
  compacted into the next frontier (kernel 5 on one column of lane
  indices; the keys, slices and geometry are gathered by it).  Reported
  slices go into a +1/-1 difference buffer (``index_add_``) whose prefix
  sum is the report mask.  No host read until the final compaction.
* :func:`pick_ordered`: the reference's ordered pick, a sequential DFS
  with ``test_order``, a ``nearest`` that shrinks during the walk and
  prunes at visit time, and one ``get_dist`` charge per object id.  The
  JAX package runs it as a ``lax.while_loop`` over a stack on the chip.
  Here the stack's control fields (key depth, slice bounds, fold tag) live
  on the host, mirroring that fixed-capacity stack and its dropped pushes
  entry for entry; the cell keys, geometry states, ``nearest``, the best
  id and the ``processed`` map live on the layer's device.  A fold step
  reads nothing on the host; a cell step reads ``should_test`` with the
  child slice bounds and ``test_order`` in one read.  ``pick_ordered.
  steps`` and ``pick_ordered.host_reads`` count both.

User protocol: a geometry state is a tuple of tensors, each with a leading
axis (1 for ``root_state``); ``subdivide_fn`` adds a leading ``2**dim``
child axis in ``index.subdivide``'s child order; ``should_test_fn``
broadcasts over whatever leading axes the leaves carry.  The root state's
leaves are moved to the layer's device.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from . import geom
from .index import IndexSpec, subdivide_at
from .layer import PAD_ID, LayerState, TestResult, sort
from .ops.compact import stream_compact
from .ops.search import lower_bound_keys
from .query import (PickResult, _argmin_pick, _distances, _f32,
                    _ray_axis_positions, _unique_compact)

# The ordered pick's result: overflow also covers the DFS stack and the
# BFS frontier capacity, not only a truncated tree.
OrderedPickResult = PickResult


def _levels(spec: IndexSpec, max_depth: Optional[int]) -> int:
    return spec.axis_bits if max_depth is None \
        else min(int(max_depth), spec.axis_bits)


def _on(state_tuple, dev) -> tuple:
    return tuple(torch.as_tensor(leaf).to(dev) for leaf in state_tuple)


def _traverse_mask(spec: IndexSpec, state: LayerState, root_state,
                   subdivide_fn: Callable, should_test_fn: Callable,
                   frontier_cap: int, max_depth: Optional[int]
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run the breadth-first walk; returns (report mask over the tree's
    slots, frontier overflow)."""
    F, fan = frontier_cap, spec.fanout
    keys = state.keys
    dev = keys.device
    cap = keys.shape[0]
    lane = torch.arange(F, device=dev)
    flat_lane = torch.arange(fan * F, device=dev)
    root_state = _on(root_state, dev)
    root_pass = torch.as_tensor(should_test_fn(root_state),
                                dtype=torch.bool, device=dev).reshape(1)
    kept = root_pass[0].to(torch.int64)
    gstate = tuple(torch.cat([leaf, leaf.new_zeros(
        (F - leaf.shape[0],) + leaf.shape[1:])]) for leaf in root_state)
    fkeys = torch.zeros(F, dtype=torch.int64, device=dev)
    flo = torch.zeros(F, dtype=torch.int64, device=dev)
    fhi = torch.where(lane == 0, state.count, 0)
    overflow = torch.zeros((), dtype=torch.bool, device=dev)
    diff = torch.zeros(cap + 1, dtype=torch.int64, device=dev)

    def report(lo, hi, active):
        # +1 at each nonempty slice's start, -1 at its end; inactive lanes
        # point at slot cap with weight 0
        a_lo = torch.where(active, lo, cap)
        a_hi = torch.where(active, hi, cap)
        w = (a_lo < a_hi).to(torch.int64)
        diff.index_add_(0, a_lo, w)
        diff.index_add_(0, a_hi, -w)

    for level in range(_levels(spec, max_depth)):
        # every live lane's cell has depth `level`; lanes at or past the
        # count hold copies of lane 0 (JAX: zeros), and every use of them
        # is masked by the count
        factive = lane < kept
        child_keys = subdivide_at(spec, fkeys, level)        # (fan, F)
        child_g = tuple(subdivide_fn(gstate))                # (fan, F, ...)
        bounds = lower_bound_keys(spec, keys, child_keys)
        bounds = torch.minimum(torch.maximum(bounds, flo[None, :]),
                               fhi[None, :])
        report(flo, bounds[0], factive)                      # at this cell
        child_hi = torch.cat([bounds[1:], fhi[None, :]])
        should = torch.as_tensor(should_test_fn(child_g), dtype=torch.bool,
                                 device=dev)
        keep = (factive[None, :] & should & (bounds < child_hi)
                ).reshape(fan * F)
        (idx,), new_kept = stream_compact(keep, (flat_lane,), (0,))
        idx = idx[:F]
        overflow = overflow | (new_kept > F)
        fkeys, flo, fhi = torch.stack([child_keys, bounds, child_hi]).reshape(
            3, fan * F)[:, idx]
        gstate = tuple(leaf.reshape((fan * F,) + leaf.shape[2:])[idx]
                       for leaf in child_g)
        kept = new_kept.clamp(max=F)

    # the depth limit or max_depth: every surviving slice reports whole
    # (reference src/layer.rs:189-196)
    report(flo, fhi, lane < kept)
    return torch.cumsum(diff[:cap], 0) > 0, overflow


def test_generic(spec: IndexSpec, state: LayerState, root_state,
                 subdivide_fn: Callable, should_test_fn: Callable,
                 result_cap: int = 256, frontier_cap: int = 1024,
                 max_depth: Optional[int] = None
                 ) -> Tuple[LayerState, TestResult]:
    """Arbitrary-geometry query with the reference's pruning
    (``broadphase_tpu.traverse.test_generic``): the sorted, distinct ids
    of every element whose cell chain, root down to its own cell, passes
    ``should_test``."""
    state = sort(spec, state)
    mask, ovf = _traverse_mask(spec, state, root_state, subdivide_fn,
                               should_test_fn, frontier_cap, max_depth)
    res = _unique_compact(state.ids, mask, result_cap)
    return state, TestResult(res.ids, res.count,
                             res.overflow | ovf | state.overflow)


def pick_generic(spec: IndexSpec, state: LayerState, root_state,
                 subdivide_fn: Callable, should_test_fn: Callable,
                 get_dist: Callable, max_distance=float("inf"),
                 get_dist_args=(), frontier_cap: int = 1024,
                 max_depth: Optional[int] = None
                 ) -> Tuple[LayerState, OrderedPickResult]:
    """Arbitrary-geometry nearest query
    (``broadphase_tpu.traverse.pick_generic``): the argmin of
    ``get_dist(ids, mask, *get_dist_args)`` over the elements the pruning
    walk reports, ties to the lowest id.  Exact for consistent narrow
    phases (an object is never nearer than its cell's entry distance);
    the result's overflow carries the frontier's."""
    state = sort(spec, state)
    mask, ovf = _traverse_mask(spec, state, root_state, subdivide_fn,
                               should_test_fn, frontier_cap, max_depth)
    d = _distances(get_dist, (state.ids, mask, *get_dist_args), mask)
    res = _argmin_pick(d, state.ids, _f32(max_distance, mask.device))
    return state, OrderedPickResult(res.distance, res.obj_id, res.found,
                                    ovf | state.overflow)


# ---------------------------------------------------------------------------
# Ordered (reference-exact) pick: sequential DFS with early-out
# ---------------------------------------------------------------------------

def pick_ordered(spec: IndexSpec, state: LayerState, root_state,
                 subdivide_fn: Callable, should_test_fn: Callable,
                 test_order_fn: Callable, get_dist_fn: Callable,
                 max_distance=float("inf"), get_dist_args=(),
                 max_depth: Optional[int] = None, stack_cap: int = 256,
                 id_bound: Optional[int] = None
                 ) -> Tuple[LayerState, OrderedPickResult]:
    """``Layer::pick`` with the reference's exact traversal
    (``broadphase_tpu.traverse.pick_ordered``): children visited in
    ``test_order``, ``should_test`` pruning against the nearest distance
    at visit time, one ``get_dist`` evaluation per object id, and the
    result the last id whose distance strictly improved ``nearest``;
    exact for any ``get_dist``, consistent or not.

    * ``should_test_fn(gstate, nearest) -> bool``;
    * ``test_order_fn(gstate) -> (2**dim,)`` integers, the child visit
      order of the parent cell (on the host or on the layer's device);
    * ``get_dist_fn(gstate, nearest, obj_id, *get_dist_args) -> f32``,
      for one object at the cell where it is first reported; non-finite
      is a miss.

    The ``processed`` map takes two sorts over the tree's capacity to
    group equal ids; ``id_bound`` (every live id below it) indexes it by
    id instead and skips both.  The stack holds ``stack_cap`` entries;
    pushes past it are dropped and flagged, as in the JAX package."""
    state = sort(spec, state)
    keys, ids = state.keys, state.ids
    dev = ids.device
    S, fan = stack_cap, spec.fanout

    # id -> processed slot (the reference's processed: HashSet<ID>)
    if id_bound is not None:
        rep = ids.clamp(max=int(id_bound) - 1)
        n_proc = int(id_bound)
    else:
        order = torch.sort(ids, stable=True).indices
        ids_s = ids[order]
        first = torch.ones_like(ids_s, dtype=torch.bool)
        first[1:] = ids_s[1:] != ids_s[:-1]
        rep = (torch.cumsum(first, 0) - 1)[torch.sort(order).indices]
        n_proc = ids.shape[0]
    processed = torch.zeros(n_proc, dtype=torch.bool, device=dev)

    limit = _levels(spec, max_depth)
    nearest = _f32(max_distance, dev)
    best = torch.full((), PAD_ID, dtype=torch.int64, device=dev)
    inf = torch.full((), torch.inf, device=dev)
    count = int(state.count)
    reads = 1
    # entry: (key () on the device, depth, lo, hi, fold tag, geometry)
    stack = [None] * S
    stack[0] = (torch.zeros((), dtype=torch.int64, device=dev), 0, 0, count,
                0, tuple(leaf[:1] for leaf in _on(root_state, dev)))
    sp = 1 if count > 0 else 0
    ovf = False
    steps = 0
    while sp > 0:
        steps += 1
        top = sp - 1
        key1, depth, lo0, hi0, tag, g1 = stack[top]
        if tag == 1:
            # fold the next element of the slice
            oid = ids[lo0]
            rp = rep[lo0].reshape(1)
            already = processed.index_select(0, rp)[0]
            d = torch.as_tensor(get_dist_fn(g1, nearest, oid, *get_dist_args),
                                dtype=torch.float32, device=dev).reshape(())
            d = torch.where(already | ~geom.finite(d), inf, d)
            best = torch.where(d < nearest, oid, best)
            nearest = torch.minimum(nearest, d)
            processed.index_fill_(0, rp, True)
            stack[top] = (key1, depth, lo0 + 1, hi0, 1, g1)
            if lo0 + 1 >= hi0:
                sp -= 1
            continue
        should = torch.as_tensor(should_test_fn(g1, nearest),
                                 dtype=torch.bool, device=dev).reshape(1)
        reads += 1
        if depth >= limit:
            if bool(should):
                stack[top] = (key1, depth, lo0, hi0, 1, g1)
            else:
                sp -= 1
            continue
        child_keys = subdivide_at(spec, key1, depth)         # (fan,)
        bounds = lower_bound_keys(spec, keys, child_keys).clamp(lo0, hi0)
        order = torch.as_tensor(test_order_fn(g1)).reshape(fan)
        if order.device == bounds.device:
            host = torch.cat([should.to(torch.int64), bounds,
                              order.to(torch.int64)]).tolist()
            order = host[1 + fan:]
        else:                         # an order given on the host
            host = torch.cat([should.to(torch.int64), bounds]).tolist()
            order = order.tolist()
        if not host[0]:
            sp -= 1
            continue
        cuts = host[1:1 + fan] + [hi0]
        child_g = tuple(subdivide_fn(g1))                    # (fan, 1, ...)
        p = top                       # the current entry is replaced
        # children pushed in reverse test_order, so popped in order
        for i in reversed(order):
            if cuts[i] < cuts[i + 1]:
                if p < S:
                    stack[p] = (child_keys[i], depth + 1, cuts[i],
                                cuts[i + 1], 0,
                                tuple(leaf[i] for leaf in child_g))
                p += 1
        # the elements AT this cell fold first (src/layer.rs:214-217):
        # pushed last, with the cell's own geometry
        if lo0 < cuts[0]:
            if p < S:
                stack[p] = (key1, depth, lo0, cuts[0], 1, g1)
            p += 1
        ovf = ovf or p > S
        sp = min(p, S)
    pick_ordered.steps += steps
    pick_ordered.host_reads += reads
    found = best != PAD_ID
    return state, OrderedPickResult(
        torch.where(found, nearest, inf), best, found,
        state.overflow | ovf)


pick_ordered.steps = 0
pick_ordered.host_reads = 0


# -- ray geometry for the ordered pick ------------------------------------

def _sides(dim: int, device) -> torch.Tensor:
    """(2**dim, 1, dim) bool: child c is on the high side of axis k where
    bit k of c is set (``index.subdivide``'s child order)."""
    c = torch.arange(1 << dim, device=device)[:, None]
    return ((c >> torch.arange(dim, device=device)) & 1).bool()[:, None, :]


def _halves(cmin: torch.Tensor, cmax: torch.Tensor, center: torch.Tensor):
    """(mins, maxs) of the 2**dim children, each (2**dim, F, dim)."""
    side = _sides(cmin.shape[-1], cmin.device)
    return torch.where(side, center, cmin), torch.where(side, cmax, center)


def _repeat(x: torch.Tensor, fan: int) -> torch.Tensor:
    return x[None].expand((fan,) + x.shape)


def _ray_subdivide(gstate):
    """Reference ``RayTestGeometry::subdivide`` (``src/geom.rs:551-589``,
    ``:617-659``) over the frontier axis: f32 midpoint halving, per-child
    slab range narrowing, the axis-parallel kill.  The reference narrows
    axis by axis; a min or max of exact values does not depend on their
    order, and a kill is absorbing, so all axes and children go at once."""
    cmin, cmax, crmin, crmax, ro, rd = gstate
    dim = cmin.shape[-1]
    fan = 1 << dim
    side = _sides(dim, cmin.device)                          # (fan, 1, dim)
    center = cmin + (cmax - cmin) / 2
    dist = (center - ro) / rd                                # (F, dim)
    fin = geom.finite(dist)
    towards = (rd > 0) != side                               # (fan, F, dim)
    hi = torch.minimum(crmax, torch.where(fin & towards, dist, torch.inf)
                       .amin(-1))
    lo = torch.maximum(crmin, torch.where(fin & ~towards, dist, -torch.inf)
                       .amax(-1))
    kill = (~fin & ((ro > center) != side)).any(-1)          # (fan, F)
    mins, maxs = _halves(cmin, cmax, center)
    return (mins, maxs, torch.where(kill, torch.inf, lo),
            torch.where(kill, -torch.inf, hi), _repeat(ro, fan),
            _repeat(rd, fan))


def _ray_should_test(gstate, nearest):
    """``RayTestGeometry::should_test`` (``src/geom.rs:608-610``)."""
    _, _, crmin, crmax, _, _ = gstate
    return (crmin < crmax) & (crmin < nearest)


def _ray_test_order(gstate):
    """``RayTestGeometry::test_order`` (``src/geom.rs:591-606``,
    ``:661-684``): axes ascending by |direction|; on each axis the child on
    the ray's origin side first.  Child ``c`` of the visit order has bit
    ``a`` set where bit ``pos[a]`` of ``c`` equals ``direction[a] >= 0``,
    with ``pos[a]`` the axis's rank in that order."""
    rd = gstate[5][0]
    dim = rd.shape[0]
    pos = _ray_axis_positions(dim, rd)
    c = torch.arange(1 << dim, device=rd.device)
    order = torch.zeros_like(c)
    for a in range(dim):
        flip = ((c >> pos[a]) & 1).eq(1) == (rd[a] >= 0)
        order = order | (flip.to(torch.int64) << a)
    return order


def ray_pick_state(spec: IndexSpec, system_min, system_max, origin,
                   direction, range_min=0.0, range_max=float("inf")):
    """(root_state, subdivide_fn, should_test_fn, test_order_fn) of the
    reference ``RayTestGeometry`` (``src/geom.rs:459-689``) for
    :func:`pick_ordered`, with the ``with_system_bounds`` range clamp
    (``:515-544``).  gstate = (cell_min, cell_max, range_min, range_max,
    origin, direction), on the CPU until the pick moves it."""
    dim = spec.dim
    smin = _f32(system_min, "cpu").reshape(1, dim)
    smax = _f32(system_max, "cpu").reshape(1, dim)
    ro = _f32(origin, "cpu").reshape(dim)
    rd = _f32(direction, "cpu").reshape(dim)
    d0 = (smin[0] - ro) / rd
    d1 = (smax[0] - ro) / rd
    fwd = rd > 0
    ent = torch.where(fwd, d0, d1)
    lev = torch.where(fwd, d1, d0)
    rmin = torch.maximum(_f32(range_min, "cpu"), torch.where(
        geom.finite(ent), ent, -torch.inf).max())
    rmax = torch.minimum(_f32(range_max, "cpu"), torch.where(
        geom.finite(lev), lev, torch.inf).min())
    root = (smin, smax, rmin[None], rmax[None], ro[None, :], rd[None, :])
    # the visit order depends on the direction alone, the same at every
    # cell: computed once, on the host
    order = _ray_test_order(root)
    return root, _ray_subdivide, _ray_should_test, lambda gstate: order


# -- box geometry for the ordered pick ------------------------------------

def _box_pick_subdivide(gstate):
    cmin, cmax, qmin, qmax = gstate
    mins, maxs = _halves(cmin, cmax, cmin + (cmax - cmin) / 2)
    fan = mins.shape[0]
    return mins, maxs, _repeat(qmin, fan), _repeat(qmax, fan)


def _box_pick_should_test(gstate, nearest):
    cmin, cmax, qmin, qmax = gstate
    return torch.all((cmin <= qmax) & (cmax >= qmin), dim=-1)


def _box_pick_test_order(gstate):
    return torch.arange(1 << gstate[0].shape[-1])


def box_pick_state(spec: IndexSpec, system_min, system_max, test_min,
                   test_max):
    """Ordered-pick state of the reference ``BoxTestGeometry``
    (``src/geom.rs:352-455``): identity test_order, an overlap-only
    should_test (the box geometry ignores ``nearest``).  gstate =
    (cell_min, cell_max, test_min, test_max)."""
    dim = spec.dim
    root = tuple(_f32(x, "cpu").reshape(1, dim) for x in (
        system_min, system_max, test_min, test_max))
    return root, _box_pick_subdivide, _box_pick_should_test, \
        _box_pick_test_order


def pick_ray_ordered(spec: IndexSpec, state: LayerState, system_min,
                     system_max, origin, direction, max_distance,
                     get_dist_fn: Callable, get_dist_args=(),
                     max_depth: Optional[int] = None, stack_cap: int = 256,
                     id_bound: Optional[int] = None
                     ) -> Tuple[LayerState, OrderedPickResult, torch.Tensor]:
    """``Layer::pick_ray`` (``src/layer.rs:417-446``) with the exact
    ordered semantics (``broadphase_tpu.traverse.pick_ray_ordered``): the
    ray geometry over [0, max_distance], ``get_dist_fn(nearest, obj_id,
    *get_dist_args)`` (the reference's closure never sees the cell), and
    the hit point ``origin + direction * distance`` (NaN when nothing is
    found)."""
    root, sub, st, to = ray_pick_state(spec, system_min, system_max,
                                       origin, direction, 0.0, max_distance)

    def get_dist(gstate, nearest, oid, *args):
        return get_dist_fn(nearest, oid, *args)

    state, res = pick_ordered(spec, state, root, sub, st, to, get_dist,
                              max_distance=max_distance,
                              get_dist_args=get_dist_args,
                              max_depth=max_depth, stack_cap=stack_cap,
                              id_bound=id_bound)
    dev = state.ids.device
    point = torch.where(res.found, _f32(origin, dev)
                        + _f32(direction, dev) * res.distance, torch.nan)
    return state, res, point


# ---------------------------------------------------------------------------
# Ready-made geometry states
# ---------------------------------------------------------------------------

def box_halving_state(spec: IndexSpec, system_min, system_max):
    """(root_state, subdivide_fn) replaying the reference's f32 midpoint
    cell halving (``src/geom.rs:379-455``): state = (cell_min, cell_max),
    leaves (..., dim); compose with any ``should_test_fn`` over them."""
    dim = spec.dim
    root = (_f32(system_min, "cpu").reshape(1, dim),
            _f32(system_max, "cpu").reshape(1, dim))

    def subdivide_fn(gstate):
        cmin, cmax = gstate
        return _halves(cmin, cmax, cmin + (cmax - cmin) * 0.5)

    return root, subdivide_fn
