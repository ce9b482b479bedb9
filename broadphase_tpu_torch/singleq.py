"""Sublinear single queries by tree descent: test_box, test_ray and
pick_ray on torch tensors.

PyTorch counterpart of ``broadphase_tpu/singleq.py``.  The linear engine
(``query.py``) replays every cell of the tree for each query; the
reference's recursive walk touches O(log n + k) slice boundaries
(``src/layer.rs:167-239``).  Here a few batched searches of the sorted
keys (``ops/search.py``) give a small set of contiguous candidate ranges,
the ranges are gathered into a fixed-capacity candidate buffer, and the
linear engine's own exact accept test runs on the candidates only, so the
results (ids, counts, pick winners with their distance ties) are the
linear engine's, bit for bit.

* :func:`test_box`: two per-axis descents of the query box (the leftmost
  and rightmost overlapping cell at each depth) give, at the deepest depth
  ``d*`` where the query spans at most two cells on every axis, at most
  ``2**dim`` covering cells; every overlapping cell is a descendant of one
  (one key range each) or an ancestor of one (an exact-key run).  The
  descents are scalar f32 work on the query alone and run on the host in
  numpy float32, with the u32 arithmetic of the JAX package (crossed
  paths of an inverted or NaN box wrap and fail the adjacency test); the
  card then runs one batch of searches and one gather.
* :func:`test_ray` and :func:`pick_ray`: a frontier of at most
  ``frontier_cap`` cells descends the cells that exist in the tree,
  carrying each cell's ray slab interval with the linear engine's f32
  expressions, and collects the elements at each passing cell as ranges.
  The JAX package stops its ``while_loop`` once the collected elements
  plus those still under the frontier fit the candidate buffer; here that
  condition is one read on the host per level, a few levels per ray
  (``_ray_frontier_ranges.host_reads`` counts them).  The compaction of
  each level's surviving children is kernel 5 on one column of lane
  indices, and the other columns are gathered by it.

``lo + (hi - lo) * 0.5`` stays three separate f32 operations, on the host
as on the card, never a fused multiply-add or ``torch.compile``.
Candidate-buffer and frontier overflow set the result's ``overflow``
flag, never silently.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from . import geom
from .index import (IndexSpec, depth_of, descendant_max, make_key,
                    origin_of, subdivide_at)
from .layer import LayerState, TestResult, sort
from .ops.compact import stream_compact
from .ops.search import (lower_bound_keys, lower_bound_keys_bracketed,
                         upper_bound_keys, upper_bound_keys_bracketed)
from .query import (PickResult, _argmin_pick_ranked, _distances,
                    _flag_truncation, _unique_compact, ray_intervals_keys)

# Defaults for the fixed-capacity buffers (overflow flagged).
CANDIDATE_CAP = 4096
FRONTIER_CAP = 256


def _levels(spec: IndexSpec, max_depth: Optional[int]) -> int:
    return spec.axis_bits if max_depth is None \
        else min(int(max_depth), spec.axis_bits)


# ---------------------------------------------------------------------------
# Shared: gather disjoint element ranges into a fixed candidate buffer
# ---------------------------------------------------------------------------

def _gather_ranges(state: LayerState, starts: torch.Tensor,
                   lens: torch.Tensor, candidate_cap: int):
    """The elements of R disjoint ranges of the sorted tree, concatenated
    in range order into ``candidate_cap`` lanes.  Returns (ids, keys,
    src, valid, overflow): (candidate_cap,) each, and whether the ranges
    held more elements than that.  Lane t belongs to the range whose
    inclusive end is the first above t (one search over the R ends)."""
    dev = state.ids.device
    lens = lens.clamp(min=0)
    ends = torch.cumsum(lens, 0)
    total = ends[-1]
    t = torch.arange(candidate_cap, device=dev)
    j = torch.searchsorted(ends, t, right=True).clamp(max=lens.shape[0] - 1)
    src = (starts[j] + t - (ends[j] - lens[j])).clamp(
        0, state.ids.shape[0] - 1)
    return (state.ids[src], state.keys[src], src, t < total,
            total > candidate_cap)


# ---------------------------------------------------------------------------
# test_box: covering-cell decomposition
# ---------------------------------------------------------------------------

def _box_cover_paths(spec: IndexSpec, system_min, system_max, qmin, qmax,
                     levels: int):
    """The leftmost and rightmost query-overlapping descent per axis
    (``broadphase_tpu.singleq._box_cover_paths``), in numpy on the host.

    Returns (Lc, Hc, d_star): (levels + 1, dim) u32 top-aligned cell
    coordinates of the two paths at each depth, and the deepest depth at
    which the query spans at most two cells on every axis.  The midpoints
    are ``geom.cell_bounds_f32``'s f32 expression; the adjacency test is
    u32, so crossed paths wrap to a large difference and fail."""
    dim = spec.dim
    half = np.float32(0.5)
    zero = np.zeros(dim, np.uint32)
    lo_l = lo_h = geom.host_f32(system_min)
    hi_l = hi_h = geom.host_f32(system_max)
    qmin, qmax = geom.host_f32(qmin), geom.host_f32(qmax)
    lc, hc = zero.copy(), zero.copy()
    lcs, hcs = [lc], [hc]
    d_star, prefix_ok = 0, True
    with np.errstate(all="ignore"):
        for b in range(levels):
            bit = np.uint32((1 << (31 - b)) & 0xFFFF_FFFF)
            # leftmost overlapping child: left iff mid >= qmin
            mid_l = lo_l + (hi_l - lo_l) * half
            right_l = ~(mid_l >= qmin)
            lo_l = np.where(right_l, mid_l, lo_l)
            hi_l = np.where(right_l, hi_l, mid_l)
            lc = lc | np.where(right_l, bit, zero).astype(np.uint32)
            # rightmost overlapping child: right iff mid <= qmax
            mid_h = lo_h + (hi_h - lo_h) * half
            right_h = mid_h <= qmax
            lo_h = np.where(right_h, mid_h, lo_h)
            hi_h = np.where(right_h, hi_h, mid_h)
            hc = hc | np.where(right_h, bit, zero).astype(np.uint32)
            prefix_ok = prefix_ok and bool(np.all(
                (hc - lc).astype(np.uint32) <= bit))
            if prefix_ok:
                d_star = b + 1
            lcs.append(lc)
            hcs.append(hc)
    return np.stack(lcs), np.stack(hcs), d_star


def _box_probes(spec: IndexSpec, system_min, system_max, qmin, qmax,
                levels: int):
    """The probe keys of a box query, on the host: for every depth d <=
    d* and every per-axis choice of the low or high path, the cell key
    and its range's end key (``descendant_max`` at d*, where the probes
    are the covering cells; the key itself above, an exact-key run).
    Duplicate choices (the paths agree on an axis), probes below d* and
    all probes of a query that misses the system box are dropped: in the
    JAX package they are ranges of length 0.  Returns (keys, end_keys):
    (R,) int64 each, in the JAX package's (depth, choice) order."""
    dim, fan = spec.dim, spec.fanout
    lc, hc, d_star = _box_cover_paths(spec, system_min, system_max, qmin,
                                      qmax, levels)
    smin, smax = geom.host_f32(system_min), geom.host_f32(system_max)
    root = bool(np.all((smin <= geom.host_f32(qmax)) & (smax >= geom.host_f32(qmin))))
    take_hi = ((np.arange(fan)[:, None] >> np.arange(dim)[None, :]) & 1
               ).astype(bool)[None]                          # (1, fan, dim)
    coords = np.where(take_hi, hc[:, None, :], lc[:, None, :])
    dup_ok = np.all(~take_hi | (hc[:, None, :] != lc[:, None, :]), axis=-1)
    depth = np.broadcast_to(np.arange(levels + 1)[:, None], dup_ok.shape)
    valid = dup_ok & (depth <= d_star) & root
    origin = [torch.as_tensor(coords[..., k][valid].astype(np.int64))
              for k in range(dim)]
    d = torch.as_tensor(depth[valid].astype(np.int64))
    keys = make_key(spec, origin, d)
    return keys, torch.where(d == d_star, descendant_max(spec, keys), keys)


def test_box(spec: IndexSpec, state: LayerState, system_min, system_max,
             query_bounds, result_cap: int, max_depth: Optional[int] = None,
             candidate_cap: int = CANDIDATE_CAP
             ) -> Tuple[LayerState, TestResult]:
    """Sublinear ``Layer::test_box`` (``broadphase_tpu.singleq.test_box``):
    the linear engine's results from the candidates of at most
    ``(levels + 1) * 2**dim`` key ranges."""
    state = sort(spec, state)
    dev = state.ids.device
    keys, end_keys = _box_probes(spec, system_min, system_max,
                                 query_bounds[0], query_bounds[1],
                                 _levels(spec, max_depth))
    if keys.numel() == 0:                  # one empty range
        keys = end_keys = torch.zeros(1, dtype=torch.int64)
        empty = True
    else:
        empty = False
    probes = geom.upload(torch.stack([keys, end_keys]), dev)
    starts = torch.minimum(lower_bound_keys(spec, state.keys, probes[0]),
                           state.count)
    ends = torch.minimum(upper_bound_keys(spec, state.keys, probes[1]),
                         state.count)
    lens = torch.zeros_like(starts) if empty else ends - starts
    ids, ckeys, _, valid, c_ovf = _gather_ranges(state, starts, lens,
                                                 candidate_cap)
    cmin, cmax = geom.cell_bounds_f32(spec, origin_of(spec, ckeys),
                                      depth_of(spec, ckeys), system_min,
                                      system_max, replay_depth=max_depth)
    qmin = geom.upload(geom.host_f32(query_bounds[0]), dev)
    qmax = geom.upload(geom.host_f32(query_bounds[1]), dev)
    hit = geom.bounds_overlaps(cmin, cmax, qmin[None, :], qmax[None, :]) \
        & valid
    res = _unique_compact(ids, hit, result_cap)
    res = res._replace(overflow=res.overflow | c_ovf)
    return state, _flag_truncation(state, res)


# ---------------------------------------------------------------------------
# Ray frontier: descend existing cells, collect exact-cell element ranges
# ---------------------------------------------------------------------------

def _ray_frontier_ranges(spec: IndexSpec, state: LayerState, system_min,
                         system_max, ray_origin, ray_dir, range_min,
                         range_max, nearest_cap, levels: int,
                         frontier_cap: int, stop_total: int = 0):
    """Descend the tree along the ray
    (``broadphase_tpu.singleq._ray_frontier_ranges``); returns (starts,
    lens, overflow): element ranges of the cells whose own accumulated
    slab interval passes (rmin < rmax, rmin < nearest_cap), level by
    level, then the cells left on the frontier whole (the depth cutoff,
    reference ``src/layer.rs:189-196``, or the early exit).

    ``stop_total`` > 0 stops the descent once the elements collected plus
    those still under the frontier fit in ``stop_total`` lanes; the
    caller re-tests every candidate exactly.  That condition is read on
    the host before each level.

    Every live frontier cell at level L has depth L, so the children's
    keys (``index.subdivide_at``) and their ranges' end keys
    (``descendant_max``) take masks known on the host.  Lanes
    at or past the frontier's count hold copies of lane 0 where the JAX
    package holds zeros: every use of them is masked by the count."""
    F, dim, fan = frontier_cap, spec.dim, spec.fanout
    dev = state.ids.device
    smin, smax = geom.host_f32(system_min), geom.host_f32(system_max)
    ro_h, rd_h = geom.host_f32(ray_origin), geom.host_f32(ray_dir)

    # the with_system_bounds clamp, query.ray_intervals' expressions
    with np.errstate(all="ignore"):
        d0 = (smin - ro_h) / rd_h
        d1 = (smax - ro_h) / rd_h
    fwd = rd_h > 0
    lo_d, hi_d = np.where(fwd, d0, d1), np.where(fwd, d1, d0)
    rmin0, rmax0 = np.float32(range_min), np.float32(range_max)
    for axis in range(dim):
        if np.isfinite(lo_d[axis]):
            rmin0 = np.maximum(rmin0, lo_d[axis])
        if np.isfinite(hi_d[axis]):
            rmax0 = np.minimum(rmax0, hi_d[axis])
    near_h = np.float32(nearest_cap)
    root_pass = bool((rmin0 < rmax0) & (rmin0 < near_h))

    # one transfer: the ray, the root's f32 state, the child side bits
    side_h = ((np.arange(fan)[:, None] >> np.arange(dim)[None, :]) & 1)
    consts = geom.upload(np.concatenate([
        ro_h, rd_h, [near_h], smin, smax, [rmin0, rmax0],
        side_h.reshape(-1)]).astype(np.float32), dev)
    ro, rd, near = consts[:dim], consts[dim:2 * dim], consts[2 * dim]
    fs = consts[2 * dim + 1:4 * dim + 3].expand(F, 2 * dim + 2)
    side = (consts[4 * dim + 3:] != 0).reshape(fan, 1, dim)
    towards = (rd > 0) != side                               # (fan, 1, dim)
    away = ~towards
    lane = torch.arange(F, device=dev)
    flat_lane = torch.arange(fan * F, device=dev)
    fkeys = torch.zeros(F, dtype=torch.int64, device=dev)
    flo = torch.zeros(F, dtype=torch.int64, device=dev)
    fhi = torch.where(lane == 0, state.count, 0)
    kept = geom.upload(torch.tensor(int(root_pass)), dev)
    ovf = torch.zeros((), dtype=torch.bool, device=dev)
    collected = torch.zeros((), dtype=torch.int64, device=dev)
    rstart, rlen = [], []

    for level in range(levels):
        factive = lane < kept
        if stop_total > 0:
            rem = torch.where(factive, fhi - flo, 0).sum() + collected
            _ray_frontier_ranges.host_reads += 1
            if int(rem) <= stop_total:
                break
        children = subdivide_at(spec, fkeys, level)          # (fan, F)
        # elements AT this cell: [flo, first child's lower bound), searched
        # inside the cell's own range
        blo = torch.where(factive, flo, 0)
        s0 = lower_bound_keys_bracketed(spec, state.keys, children[0], blo,
                                        torch.where(factive, fhi, 0))
        rstart.append(blo)
        rlen.append(s0 - blo)
        if stop_total > 0:
            collected = collected + rlen[-1].sum()

        # per-child slab update, query.ray_intervals' expressions
        lo, hi = fs[:, :dim], fs[:, dim:2 * dim]
        center = lo + (hi - lo) * 0.5                        # (F, dim)
        dist = (center - ro) / rd
        finite = geom.finite(dist)
        new_rmax = torch.where(finite & towards, dist, torch.inf).amin(-1)
        new_rmin = torch.where(finite & away, dist, -torch.inf).amax(-1)
        dead = (~finite & ((ro > center) != side)).any(-1)   # (fan, F)
        rmx_c = torch.where(dead, -torch.inf,
                            torch.minimum(fs[:, 2 * dim + 1], new_rmax))
        rmn_c = torch.where(dead, torch.inf,
                            torch.maximum(fs[:, 2 * dim], new_rmin))
        lo_c = torch.where(side, center, lo)                 # (fan, F, dim)
        hi_c = torch.where(side, hi, center)

        # only interval-passing children of nonempty cells go on
        keep = (factive & (flo < fhi)) & (rmn_c < rmx_c) & (rmn_c < near)
        (idx,), new_kept = stream_compact(keep.reshape(-1), (flat_lane,),
                                          (0,))
        idx = idx[:F]
        ovf = ovf | (new_kept > F)
        fkeys, cb_lo, cb_hi = torch.stack([
            children, s0.expand(fan, F), fhi.expand(fan, F)]).reshape(
                3, fan * F)[:, idx]
        fs = torch.cat([lo_c, hi_c, rmn_c[..., None], rmx_c[..., None]],
                       -1).reshape(fan * F, 2 * dim + 2)[idx]
        # each child's range: [lb(child), ub(descendant_max(child))),
        # inside its parent's bracket
        flo = lower_bound_keys_bracketed(spec, state.keys, fkeys, cb_lo,
                                         cb_hi)
        fhi = upper_bound_keys_bracketed(
            spec, state.keys,
            fkeys | ((1 << (spec.key_bits - dim * (level + 1))) - 1), flo,
            cb_hi)
        kept = new_kept.clamp(max=F)

    # what is left on the frontier reports whole
    factive = lane < kept
    rstart.append(torch.where(factive, flo, 0))
    rlen.append(torch.where(factive, fhi - flo, 0))
    return torch.cat(rstart), torch.cat(rlen), ovf


_ray_frontier_ranges.host_reads = 0


def test_ray(spec: IndexSpec, state: LayerState, system_min, system_max,
             ray_origin, ray_dir, range_min, range_max, result_cap: int,
             max_depth: Optional[int] = None,
             candidate_cap: int = CANDIDATE_CAP,
             frontier_cap: int = FRONTIER_CAP
             ) -> Tuple[LayerState, TestResult]:
    """Sublinear ``Layer::test_ray`` (``broadphase_tpu.singleq.test_ray``):
    the frontier descends until the candidates fit the buffer, then every
    candidate gets the linear engine's interval replay
    (``query.ray_intervals_keys``)."""
    state = sort(spec, state)
    starts, lens, f_ovf = _ray_frontier_ranges(
        spec, state, system_min, system_max, ray_origin, ray_dir,
        range_min, range_max, np.inf, _levels(spec, max_depth),
        frontier_cap, stop_total=candidate_cap)
    ids, keys, _, valid, c_ovf = _gather_ranges(state, starts, lens,
                                                candidate_cap)
    rmn, rmx = ray_intervals_keys(spec, keys, system_min, system_max,
                                  ray_origin, ray_dir, range_min, range_max,
                                  max_depth)
    res = _unique_compact(ids, (rmn < rmx) & valid, result_cap)
    res = res._replace(overflow=res.overflow | c_ovf | f_ovf)
    return state, _flag_truncation(state, res)


def pick_ray(spec: IndexSpec, state: LayerState, system_min, system_max,
             ray_origin, ray_dir, max_distance, get_dist: Callable,
             get_dist_args=(), max_depth: Optional[int] = None,
             candidate_cap: int = CANDIDATE_CAP,
             frontier_cap: int = FRONTIER_CAP
             ) -> Tuple[LayerState, PickResult]:
    """Sublinear ``Layer::pick_ray`` (``broadphase_tpu.singleq.pick_ray``):
    the linear engine's winner, distance ties included.  ``get_dist(ids,
    mask, *get_dist_args)`` must be a pure function of the ids it is
    given: it sees the gathered candidates, not the whole tree."""
    state = sort(spec, state)
    dev = state.ids.device
    md = np.float32(max_distance)
    starts, lens, f_ovf = _ray_frontier_ranges(
        spec, state, system_min, system_max, ray_origin, ray_dir, 0.0, md,
        md, _levels(spec, max_depth), frontier_cap,
        stop_total=candidate_cap)
    ids, keys, src, valid, c_ovf = _gather_ranges(state, starts, lens,
                                                  candidate_cap)
    rmn, rmx = ray_intervals_keys(spec, keys, system_min, system_max,
                                  ray_origin, ray_dir, 0.0, md, max_depth)
    md_t = geom.upload(np.asarray(md), dev)
    cand = (rmn < rmx) & (rmn < md_t) & valid
    d = _distances(get_dist, (ids, cand, *get_dist_args), cand)
    res = _argmin_pick_ranked(spec, d, keys, ids, md_t, ray_dir, max_depth,
                              src)
    res = res._replace(overflow=res.overflow | c_ovf | f_ovf)
    return state, _flag_truncation(state, res)
