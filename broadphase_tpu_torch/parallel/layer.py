"""Persistent sharded layer: build once over a process group, then scan,
merge and query it without gathering the tree onto one rank.

PyTorch counterpart of ``broadphase_tpu/parallel/layer.py``.  A
:class:`ShardedLayer` is one rank's sorted fragment of the global tree:
the keys in its contiguous Morton range (``scan.make_bucket_of``), so the
fragments in rank order ARE the sorted tree.

* :func:`make_build_sharded`: local emission, one routing sort, one
  exchange, one local sort (``scan.local_sorted_fragment``); the counts
  are made replicated by one ``all_gather``.
* :func:`make_scan_sharded`: ``layer.scan_pairs`` on the fragment (exact
  by the min_depth rule) and the dedup exchange.
* :func:`make_merge_sharded`: two layers over the same group hold, on each
  rank, fragments of the same key range, so the merge is the merge kernel
  (k6) on each fragment with every tag 0, as the single-chip merge of two
  sorted layers does, and needs no exchange.
* :func:`make_queries_sharded`: batched boxes, rays and picks by the
  single-chip linear engines on each fragment; one ``all_gather`` merges
  the answers.
* :func:`gather_layer` / :func:`shard_layer`: the checkpoint bridge to a
  single-chip :class:`~broadphase_tpu_torch.layer.LayerState`, which goes
  through BR_SCENE like any layer.

Where the JAX package is at fault, the port does not follow it:
``gather_layer`` takes the layer's own ``min_depth`` (JAX defaults to 0),
``shard_layer`` raises on a layer shallower than
:func:`~.scan.min_depth_for_devices` (JAX only warns), and the merge pads
its fragments to ``fragment_capacity`` (JAX's can come out shorter).
Merge ties: entries equal in (key, id) come out ordered by aux (k6),
where the JAX bitonic merge orders them by position.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from .. import query
from ..index import IndexSpec
from ..layer import (PAD_ID, LayerState, TestResult, _host, _merge_cols,
                     _unpack_meta, make_layer, scan_pairs, sort)
from ..ops.merge import merge_cancel_compact
from .scan import (ShardedScanResult, all_gather_rows, dedup_exchange,
                   gather_stats, local_sorted_fragment, make_bucket_of,
                   min_depth_for_devices, rank_device, world)

_INT64_MAX = (1 << 63) - 1


class ShardedLayer(NamedTuple):
    """One rank's fragment of a sharded tree, and the layer's replicated
    counts and flags."""

    keys: torch.Tensor           # (frag,) int64, PAD_KEY past the count
    ids: torch.Tensor            # (frag,) int64, PAD_ID past the count
    aux: torch.Tensor            # (frag,) int32
    counts: torch.Tensor         # (D,) int64 live lanes of every fragment
    invalid_count: torch.Tensor  # () int64, global
    overflow: torch.Tensor       # () bool, global
    min_depth: torch.Tensor      # () int64, host: the effective min_depth


def local_state(lyr: ShardedLayer, rank: int) -> LayerState:
    """The fragment as a sorted single-chip LayerState, for the
    single-chip engines (``broadphase_tpu.parallel.layer._local_state``);
    its flags are clear, the layer's are the caller's to add."""
    dev = lyr.ids.device
    return LayerState(
        keys=lyr.keys, ids=lyr.ids, aux=lyr.aux, count=lyr.counts[rank],
        sorted=_host(True, torch.bool), min_depth=lyr.min_depth,
        invalid_count=torch.zeros((), dtype=torch.int64, device=dev),
        overflow=torch.zeros((), dtype=torch.bool, device=dev))


def build_fragment(spec: IndexSpec, group, min_depth: int,
                   slots_per_axis: int, fragment_capacity: int, device,
                   system_min, system_max, bounds_min, bounds_max, ids):
    """(ShardedLayer, the fragment's aux before the wide-id gate)."""
    rank, n_dev = world(group)
    eff = max(int(min_depth), min_depth_for_devices(spec, n_dev))
    # the fragment is the concatenation of D routing rows, so one
    # (source, destination) row holds fragment_capacity / D lanes; a row
    # that overflows under source skew is flagged like any overflow
    bcap = -(-int(fragment_capacity) // n_dev)
    dev = rank_device(device, group, bounds_min, bounds_max, ids)
    frag = local_sorted_fragment(spec, group, n_dev, eff, slots_per_axis,
                                 bcap, system_min, system_max, bounds_min,
                                 bounds_max, ids, dev)
    stats = gather_stats((frag.count, frag.invalid, frag.overflow), group)
    return ShardedLayer(frag.keys, frag.ids, frag.aux, stats[:, 0],
                        stats[:, 1].sum(), stats[:, 2].any(),
                        _host(eff, torch.int64)), frag.tree_aux


def make_build_sharded(spec: IndexSpec, group=None, *, min_depth: int = 0,
                       slots_per_axis: int = 2, fragment_capacity: int,
                       device=None):
    """``fn(system_min, system_max, bounds_min, bounds_max, ids) ->
    ShardedLayer``, called by every rank with its object shard.  Each
    fragment is ``D * ceil(fragment_capacity / D)`` lanes long;
    ``min_depth`` is raised to :func:`min_depth_for_devices`."""
    def build(system_min, system_max, bounds_min, bounds_max, ids
              ) -> ShardedLayer:
        return build_fragment(spec, group, min_depth, slots_per_axis,
                              fragment_capacity, device, system_min,
                              system_max, bounds_min, bounds_max, ids)[0]

    return build


def make_scan_sharded(spec: IndexSpec, group=None, *, pair_capacity: int,
                      exchange_capacity: Optional[int] = None,
                      filter_fn: Optional[Callable] = None,
                      nested_ids: bool = False):
    """``fn(layer) -> ShardedScanResult``: repeated scans of a sharded
    layer, capacities per rank as in ``scan.make_sharded_step``."""
    xcap = int(exchange_capacity or pair_capacity)

    def scan(lyr: ShardedLayer) -> ShardedScanResult:
        rank, n_dev = world(group)
        res = scan_pairs(spec, lyr.keys, lyr.ids, lyr.counts[rank],
                         pair_capacity, filter_fn,
                         extra_overflow=lyr.overflow, aux=lyr.aux,
                         nested_ids=nested_ids)
        out_a, out_b, dcount, x_ovf = dedup_exchange(
            group, n_dev, xcap, res.pairs_a, res.pairs_b)
        stats = gather_stats((dcount, res.overflow | x_ovf), group)
        return ShardedScanResult(out_a, out_b, stats[:, 0],
                                 stats[:, 0].sum(), lyr.invalid_count,
                                 stats[:, 1].any())

    return scan


def gather_layer(spec: IndexSpec, lyr: ShardedLayer, group=None, *,
                 capacity: Optional[int] = None) -> LayerState:
    """The whole tree as one sorted single-chip :class:`LayerState`, on
    every rank (one ``all_gather`` of the fragments, whose lengths must
    agree, then their live prefixes in rank order): the checkpoint bridge,
    as ``layer.layer_to_scene_layer`` takes it.  ``capacity`` defaults to
    ``D * frag``; ``min_depth`` is the layer's own."""
    packed = torch.stack([lyr.keys, lyr.ids, lyr.aux.to(torch.int64)], 1)
    parts = all_gather_rows(packed, group)
    counts = lyr.counts.tolist()
    live = torch.cat([p[:c] for p, c in zip(parts, counts)])
    n = live.shape[0]
    cap = int(capacity) if capacity is not None else parts.shape[0] * \
        parts.shape[1]
    if cap < n:
        raise ValueError(f"capacity {cap} < live entries {n}")
    state = make_layer(spec, cap, int(lyr.min_depth), device=lyr.ids.device)
    state.keys[:n] = live[:, 0]
    state.ids[:n] = live[:, 1]
    state.aux[:n] = live[:, 2].to(torch.int32)
    return state._replace(count=lyr.counts.sum(),
                          invalid_count=lyr.invalid_count.clone(),
                          overflow=lyr.overflow.clone())


def shard_layer(spec: IndexSpec, state: LayerState, group=None, *,
                fragment_capacity: int) -> ShardedLayer:
    """This rank's fragment of a single-chip layer (the restore direction
    of :func:`gather_layer`: load a BR_SCENE checkpoint with
    ``layer.layer_from_scene_layer``, then place it without a rebuild),
    under the build's ownership rule; every rank passes the same layer.
    Raises if the layer's ``min_depth`` is below
    :func:`min_depth_for_devices` (a scan of the fragments could then miss
    pairs across a cut) or a fragment exceeds ``fragment_capacity``."""
    rank, n_dev = world(group)
    need = min_depth_for_devices(spec, n_dev)
    if int(state.min_depth) < need:
        raise ValueError(
            f"shard_layer: the layer's min_depth {int(state.min_depth)} is "
            f"below min_depth_for_devices {need} for {n_dev} ranks; "
            "rebuild it with min_depth >= that")
    state = sort(spec, state)
    cnt = int(state.count)
    dev = state.ids.device
    bucket = make_bucket_of(spec, n_dev)(state.keys[:cnt])
    bounds = torch.searchsorted(bucket.contiguous(),
                                torch.arange(n_dev + 1, device=dev))
    counts = bounds[1:] - bounds[:-1]
    fcap = int(fragment_capacity)
    if int(counts.max()) > fcap:
        raise ValueError(f"fragment_capacity {fcap} < largest fragment "
                         f"{int(counts.max())} (counts per rank: "
                         f"{counts.tolist()})")
    lo, c = int(bounds[rank]), int(counts[rank])
    frag = make_layer(spec, fcap, device=dev)
    frag.keys[:c] = state.keys[lo:lo + c]
    frag.ids[:c] = state.ids[lo:lo + c]
    frag.aux[:c] = state.aux[lo:lo + c]
    return ShardedLayer(frag.keys, frag.ids, frag.aux, counts,
                        state.invalid_count.clone(), state.overflow.clone(),
                        _host(int(state.min_depth), torch.int64))


def make_merge_sharded(spec: IndexSpec, group=None, *,
                       fragment_capacity: Optional[int] = None):
    """``fn(a, b) -> ShardedLayer``: the sharded ``Layer::merge``.  Key
    ownership is a function of the key and D alone, so two layers over one
    group hold fragments of the same key range on each rank: the merge
    kernel (k6) merges them with every tag 0, as ``layer.merge`` merges
    two sorted layers, and only the counts and flags travel (one
    ``all_gather``).  The fragments are ``fragment_capacity`` lanes
    (default: the sum of the inputs', which cannot overflow); the smaller
    ``min_depth`` is adopted.  Layers that share ids may hold one id in
    nested cells: scan them with ``nested_ids=True``."""
    def merge(a: ShardedLayer, b: ShardedLayer) -> ShardedLayer:
        rank, _ = world(group)
        out_cap = (a.ids.shape[0] + b.ids.shape[0]
                   if fragment_capacity is None else int(fragment_capacity))
        (keys, meta), count, _ = merge_cancel_compact(
            *_merge_cols(spec, local_state(a, rank)),
            *_merge_cols(spec, local_state(b, rank)), b.counts[rank],
            out_cap)
        ids, aux = _unpack_meta(spec, meta, out_cap, count)
        stats = gather_stats((count.clamp(max=out_cap), count > out_cap),
                             group)
        return ShardedLayer(
            keys, ids, aux, stats[:, 0], a.invalid_count + b.invalid_count,
            stats[:, 1].any() | a.overflow | b.overflow,
            _host(min(int(a.min_depth), int(b.min_depth)), torch.int64))

    return merge


def _f32_bits(x: float) -> int:
    return int(torch.tensor(x, dtype=torch.float32).view(torch.int32))


def make_queries_sharded(spec: IndexSpec, group=None, *, min_depth: int = 0,
                         result_cap: int = 4096, chunk: int = 64):
    """Batched queries over a :class:`ShardedLayer`: returns
    ``(test_box_batch, test_ray_batch, make_pick_ray_batch)``, with the
    JAX package's signatures.

    Each rank answers from its fragment with the single-chip linear
    engines (``query.test_box_batch`` and ``test_ray_batch``: the replay
    needs nothing outside the fragment), then one ``all_gather`` merges
    the answers: boxes and rays as the sorted unique union, cut at
    ``result_cap`` (size it for one rank's share: the union sorts
    ``D * result_cap`` lanes a query); picks by the lexicographic least
    (distance, visit rank, global tree position), where the position is
    the lane plus the counts of the earlier fragments, so the winner is
    the single-chip engine's.  Results are replicated on every rank.
    ``min_depth`` is unused by the linear engines and kept for the JAX
    signature."""
    del min_depth

    def _union(res: TestResult, lyr: ShardedLayer) -> TestResult:
        # each query's ids and its overflow flag in one all_gather
        row = torch.cat([res.ids, res.overflow[:, None].to(torch.int64)], 1)
        parts = all_gather_rows(row, group)                 # (D, Q, cap+1)
        flat = parts[..., :-1].permute(1, 0, 2).reshape(row.shape[0], -1)
        s = torch.sort(flat, dim=1).values
        keep = s != PAD_ID
        keep[:, 1:] &= s[:, 1:] != s[:, :-1]
        count = keep.sum(1)
        vals = torch.sort(torch.where(keep, s, PAD_ID), dim=1).values
        return TestResult(vals[:, :result_cap], count.clamp(max=result_cap),
                          (count > result_cap) | parts[..., -1].any(0)
                          | lyr.overflow)

    def test_box_batch(lyr: ShardedLayer, system_min, system_max,
                       query_bounds) -> TestResult:
        rank, _ = world(group)
        _, res = query.test_box_batch(spec, local_state(lyr, rank),
                                      system_min, system_max, query_bounds,
                                      result_cap, chunk=chunk)
        return _union(res, lyr)

    def test_ray_batch(lyr: ShardedLayer, system_min, system_max,
                       ray_origins, ray_dirs, range_min, range_max
                       ) -> TestResult:
        rank, _ = world(group)
        _, res = query.test_ray_batch(spec, local_state(lyr, rank),
                                      system_min, system_max, ray_origins,
                                      ray_dirs, range_min, range_max,
                                      result_cap, chunk=chunk)
        return _union(res, lyr)

    def make_pick_ray_batch(get_dist: Callable):
        """``get_dist(ids, mask, *args_q)`` is called once per query over
        the fragment's id-sorted elements, as ``query.pick_ray_batch``
        calls it."""

        def pick_ray_batch(lyr: ShardedLayer, system_min, system_max,
                           ray_origins, ray_dirs, max_distance,
                           get_dist_args=()) -> query.PickResult:
            rank, _ = world(group)
            st = local_state(lyr, rank)
            offset = int(lyr.counts[:rank].sum())
            ids_s, wins = query._pick_batch_winners(
                spec, st, system_min, system_max, ray_origins, ray_dirs,
                max_distance, get_dist, get_dist_args, None, chunk)
            # each query's local winner as the row the ranks compare:
            # (distance bits, visit rank, global tree position, id)
            rows = [[_f32_bits(float("inf")), _INT64_MAX, _INT64_MAX, PAD_ID]
                    if w is None else
                    [_f32_bits(float(w.distance)), w.rank,
                     w.position + offset, int(ids_s[w.lane])] for w in wins]
            Q = len(wins)
            local = torch.tensor(rows, dtype=torch.int64,
                                 device=st.ids.device).reshape(Q, 4)
            parts = all_gather_rows(local, group)             # (D, Q, 4)
            dist_all = parts[..., 0].to(torch.int32).view(torch.float32)
            best = dist_all.min(0).values
            tie = dist_all == best
            for col in (1, 2):
                m = torch.where(tie, parts[..., col], _INT64_MAX).min(0)
                tie &= parts[..., col] == m.values
            win = torch.where(tie, parts[..., 3], PAD_ID).min(0).values
            found = torch.isfinite(best)
            return query.PickResult(
                torch.where(found, best, float("inf")),
                torch.where(found, win, PAD_ID), found,
                lyr.overflow.expand(Q).clone())

        return pick_ray_batch

    return test_box_batch, test_ray_batch, make_pick_ray_batch
