"""Sharded temporal-coherence update: each frame's churn routed to the
rank that owns its keys.

PyTorch counterpart of ``broadphase_tpu/parallel/update.py``.  A
:class:`ShardedTracked` holds one rank's tree fragment (its key range)
and its object shard (bounds and emission signatures, by object index).
Per frame, on every rank:

1. the signatures of the object shard are recomputed and diffed
   (``update._signature``): no exchange;
2. the changed objects (compacted by kernel 5) are re-emitted from their
   old bounds as tombstones and from their new bounds as inserts
   (``update._emit_rows``, ``update._churn_stream``);
3. the churn is sorted by (key, meta) and routed to its key owner with the
   build's bucket rows and one exchange: a tombstone has the key of the
   entry it kills, so it lands on the fragment that holds it;
4. the received churn is merged into the fragment with tombstone
   cancellation (kernel 6, ``merge_cancel_compact``), and the counts,
   flags and the wide-id gate's max id travel in one ``all_gather``.

The updated fragments equal ``make_build_sharded`` on the new bounds:
keys, ids, aux, counts and flags.  The fragment's aux before the wide-id
gate rides along (``tree_aux``), as in the single-chip update, so aux is
kept on the ``wide_ids`` path too, where the JAX package's zeroes it.

Capacities are per rank, all overflow-flagged: ``obj_cap`` changed
objects of the object shard (default ``churn_cap``), ``route_cap`` churn
entries of one (source, destination) row (default ``ceil(2C / D)``) and
``churn_cap`` (C) the merge budget of a fragment, each side.  The flags
follow the JAX package's sharded update: cell overflow, more changed
objects than ``obj_cap``, an id at or above 2^28 - 1 without
``wide_ids``, a full routing row, more than 2C received entries, and a
fragment too short for the merged tree.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import geom
from ..index import IndexSpec, PAD_KEY
from ..layer import _NARROW_ID_BOUND, PAD_ID, _merge_cols, _unpack_meta
from ..ops.compact import stream_compact
from ..ops.merge import merge_cancel_compact, to_length
from ..update import (_PACK_ID_BOUND, _churn_stream, _emit_rows, _f32,
                      _sig_slot_count, _signature)
from .layer import ShardedLayer, build_fragment, local_state
from .scan import (bucket_rows, exchange, gather_stats, make_bucket_of,
                   sort_by_key_meta, world)


class ShardedTracked(NamedTuple):
    """One rank's fragment and object shard, with the shard's last bounds
    and emission signatures."""

    layer: ShardedLayer
    ids: torch.Tensor            # (n / D,) int64, positionally stable ids
    bounds_min: torch.Tensor     # (n / D, dim) f32, last frame's bounds
    bounds_max: torch.Tensor
    sig_depth: torch.Tensor      # (n / D,) int64
    sig_tmin: torch.Tensor       # (n / D, dim) int64
    sig_tmax: torch.Tensor
    sig_contained: torch.Tensor  # (n / D,) bool
    tree_aux: torch.Tensor       # (frag,) int32 the fragment's aux before
                                 # the wide-id gate


def make_build_tracked_sharded(spec: IndexSpec, group=None, *,
                               fragment_capacity: int, min_depth: int = 0,
                               slots_per_axis: int = 2, device=None):
    """``fn(system_min, system_max, bounds_min, bounds_max, ids) ->
    ShardedTracked``: the sharded build plus the object shard's signatures,
    called by every rank with its object shard."""
    def fn(system_min, system_max, bounds_min, bounds_max, ids
           ) -> ShardedTracked:
        lyr, tree_aux = build_fragment(
            spec, group, min_depth, slots_per_axis, fragment_capacity,
            device, system_min, system_max, bounds_min, bounds_max, ids)
        dev = lyr.ids.device
        bmin, bmax = _f32(bounds_min, dev), _f32(bounds_max, dev)
        if isinstance(ids, np.ndarray):
            ids = ids.astype(np.int64)
        return ShardedTracked(
            lyr, torch.as_tensor(ids, dtype=torch.int64, device=dev), bmin,
            bmax, *_signature(spec, system_min, system_max, bmin, bmax,
                              int(lyr.min_depth)), tree_aux)

    return fn


def make_update_sharded(spec: IndexSpec, group=None, *, churn_cap: int,
                        obj_cap: Optional[int] = None,
                        route_cap: Optional[int] = None,
                        slots_per_axis: int = 2, wide_ids: bool = False):
    """``fn(tracked, system_min, system_max, bounds_min, bounds_max) ->
    ShardedTracked``, called by every rank with the new bounds of its
    object shard.  Signatures and emissions take the tracked layer's own
    ``min_depth``, the one its build used, as the single-chip update does
    (the JAX package's takes a ``min_depth`` argument, which must match
    the build's).  Overflow anywhere sets the layer's global flag (rebuild
    that frame)."""
    _, n_dev = world(group)
    bucket_of = make_bucket_of(spec, n_dev)
    C = int(churn_cap)
    OC = int(obj_cap) if obj_cap is not None else C
    RC = int(route_cap) if route_cap is not None else -(-2 * C // n_dev)

    def fn(tracked: ShardedTracked, system_min, system_max, bounds_min,
           bounds_max) -> ShardedTracked:
        rank, _ = world(group)
        lyr = tracked.layer
        eff_md = int(lyr.min_depth)
        dev = lyr.ids.device
        n_local = tracked.ids.shape[0]
        bmin, bmax = _f32(bounds_min, dev), _f32(bounds_max, dev)

        # 1. the signature diff over the object shard
        depth_n, tmin_n, tmax_n, cont_n = _signature(
            spec, system_min, system_max, bmin, bmax, eff_md)
        changed = ((depth_n != tracked.sig_depth)
                   | (cont_n != tracked.sig_contained)
                   | torch.any((tmin_n != tracked.sig_tmin)
                               | (tmax_n != tracked.sig_tmax), dim=-1)) \
            & (cont_n | tracked.sig_contained)
        _, new_ovf = _sig_slot_count(depth_n, tmin_n, tmax_n, cont_n,
                                     slots_per_axis)
        obj_cnt = changed.sum()
        local_ovf = torch.any(new_ovf) | (obj_cnt > OC)
        if not wide_ids and n_local:
            local_ovf |= torch.where(tracked.ids != PAD_ID, tracked.ids,
                                     0).max() >= _PACK_ID_BOUND

        # 2. the changed objects' old and new emissions
        (obj_idx,), _ = stream_compact(
            changed, (torch.arange(n_local, dtype=torch.int64,
                                   device=dev),), (n_local,))
        obj_idx = torch.cat([obj_idx, obj_idx.new_full((OC,), n_local)])[:OC]
        row_live = torch.arange(OC, device=dev) < obj_cnt.clamp(max=OC)
        obj_idx = obj_idx.clamp(0, max(n_local - 1, 0))

        def rows(x):
            return x[obj_idx] if n_local else x.new_zeros(
                (OC,) + x.shape[1:])

        old_k, old_v = _emit_rows(spec, system_min, system_max,
                                  rows(tracked.bounds_min),
                                  rows(tracked.bounds_max), eff_md,
                                  slots_per_axis)
        new_k, new_v = _emit_rows(spec, system_min, system_max, rows(bmin),
                                  rows(bmax), eff_md, slots_per_axis)
        ids_rows = rows(tracked.ids)
        aux_row = geom.slot_aux(spec.dim, slots_per_axis, dev)
        t_key, t_meta, _ = _churn_stream(spec, ids_rows, aux_row, old_k,
                                         old_v & row_live[:, None], 1)
        i_key, i_meta, _ = _churn_stream(spec, ids_rows, aux_row, new_k,
                                         new_v & row_live[:, None], 0)
        key, meta = torch.cat([t_key, i_key]), torch.cat([t_meta, i_meta])

        # 3. route to the key owner: sorted by (key, meta), the churn is
        # grouped by owner (the top key bits are monotone in the key)
        perm = sort_by_key_meta(key, meta)
        skey = key[perm]
        owner = torch.where(skey != PAD_KEY, bucket_of(skey), n_dev)
        out_rows, _, route_ovf = bucket_rows((key, meta), perm, owner, n_dev,
                                             RC, (PAD_KEY, PAD_KEY))
        rk, rm = exchange(out_rows, group).reshape(n_dev * RC, 2).unbind(1)

        # 4. the received churn, in merge order, into the fragment
        perm = sort_by_key_meta(rk, rm)
        r_key, r_meta = rk[perm], rm[perm]
        recv_live = (r_key != PAD_KEY).sum()
        frag_len = lyr.ids.shape[0]
        tree_key, tree_meta = _merge_cols(spec, local_state(
            lyr, rank)._replace(aux=tracked.tree_aux))
        (o_key, o_meta), new_count, merge_ovf = merge_cancel_compact(
            tree_key, tree_meta, to_length(r_key, 2 * C),
            to_length(r_meta, 2 * C), recv_live.clamp(max=2 * C), frag_len)
        o_ids, o_aux = _unpack_meta(spec, o_meta, frag_len, new_count)

        stats = gather_stats((
            new_count.clamp(max=frag_len), (~cont_n).sum(),
            local_ovf | route_ovf | (recv_live > 2 * C) | merge_ovf
            | (new_count > frag_len),
            torch.where(o_ids != PAD_ID, o_ids, 0).max()), group)
        # the build's gate on the aux column: the max live id of the group
        # (without wide_ids every id is below 2^28 - 1, or overflow is set)
        aux = torch.where(stats[:, 3].max() < _NARROW_ID_BOUND, o_aux, 0) \
            if wide_ids else o_aux
        new_lyr = ShardedLayer(o_key, o_ids, aux, stats[:, 0],
                               stats[:, 1].sum(),
                               stats[:, 2].any() | lyr.overflow,
                               lyr.min_depth)
        return ShardedTracked(new_lyr, tracked.ids, bmin, bmax, depth_n,
                              tmin_n, tmax_n, cont_n, o_aux)

    return fn
