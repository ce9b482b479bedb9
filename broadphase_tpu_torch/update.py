"""Temporal-coherence tree updates: re-sort only what changed cells.

PyTorch counterpart of ``broadphase_tpu/update.py``.  A
:class:`TrackedScene` carries the sorted tree plus last frame's bounds and
each object's emission signature (depth, truncated local min/max,
containment), which determines its emitted cells exactly.  :func:`update`
recomputes the signatures on the new bounds and diffs them per object;
only the changed objects are re-emitted, from their old bounds as
tombstones and from their new bounds as inserts.  The churn is compacted
(kernel 5, ``ops/compact.py``), sorted (two stable library sorts) and
merged into the tree with tombstone cancellation (kernel 6,
``ops/merge.py``).  The result equals ``layer.build`` on the new bounds:
keys, ids, aux bits, count and flags.

Data contract: the merge columns are int64 ``key`` and
``meta = (id << (dim+1)) | (aux << 1) | tag`` (tag 1 = tombstone), with
``PAD_KEY`` in both columns for pads; ids below 2^32 leave room for aux on
the ``wide_ids`` path too.  A tombstone cancels its tree entry only on
(key, id, aux), but the tree's aux column is zeroed wherever a live id
reaches 2^29 - 1 (``layer.mask_aux``), and a frame can cross that line
either way.  So the tracked scene carries the tree's aux before that mask
(``tree_aux``), the merge runs on it, and the new state's aux is masked
again exactly as ``layer.build`` masks it.  (The JAX package's unpacked
path carries no aux, ``broadphase_tpu/update.py:191-195``; the port keeps
it, to equal ``layer.build``.)  Static arguments
(``churn_cap``, ``obj_cap``, ``slots_per_axis``, ``wide_ids``) are Python
values; counts and flags stay on the device, so a frame never waits for
the card.

Contract and limits (all flagged in ``state.overflow``, never silent), as
in the JAX package: ids unique and positionally stable across frames;
``churn_cap`` bounds the changed cell slots per side and ``obj_cap``
(default ``churn_cap``) the changed objects; without ``wide_ids``, an id
at or above 2^28 - 1 (which the JAX package's packed u32 column cannot
hold) sets the flag; a tree that overflowed stays flagged.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from . import geom, profiling
from .index import IndexSpec, PAD_KEY, U32_MASK, origin_of
from .layer import (PAD_ID, LayerState, _build, _host, _merge_cols,
                    _pack_meta, _unpack_meta, capacity_of, mask_aux,
                    resolve_device)
from .ops.compact import stream_compact
from .ops.merge import merge_cancel_compact, to_length

# ids strictly below this fit the JAX package's packed (id, aux, tag) u32
# column (broadphase_tpu/update.py:72-75); the port keeps its flag
_PACK_ID_BOUND = (1 << 28) - 1


class TrackedScene(NamedTuple):
    """A sorted layer plus last frame's bounds and emission signature, all
    on the layer's device."""

    state: LayerState
    ids: torch.Tensor            # (N,) int64, positionally stable ids
    bounds_min: torch.Tensor     # (N, dim) f32, last frame's raw bounds
    bounds_max: torch.Tensor
    sig_depth: torch.Tensor      # (N,) int64
    sig_tmin: torch.Tensor       # (N, dim) int64 truncated local min
    sig_tmax: torch.Tensor       # (N, dim) int64 truncated local max
    sig_contained: torch.Tensor  # (N,) bool
    tree_aux: torch.Tensor       # (cap,) int32 the tree's aux before the
                                 # wide-id mask, aligned with state.keys


def _f32(x, dev) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=dev)


def _signature(spec: IndexSpec, system_min, system_max, bounds_min,
               bounds_max, min_depth):
    """(depth (N,), tmin (N, dim), tmax (N, dim), contained (N,)): what
    ``geom.emit_cells`` emits for each object is a function of these."""
    dev = bounds_min.device
    smin, smax = _f32(system_min, dev), _f32(system_max, dev)
    contained = geom.bounds_contains(smin, smax, bounds_min, bounds_max)
    lmin = geom.to_local(smin, smax, bounds_min)
    lmax = geom.to_local(smin, smax, bounds_max)
    depth = geom.depth_for_bounds(spec, lmin, lmax, min_depth)
    tmin = geom.truncate_to_depth(lmin, depth[:, None])
    tmax = geom.truncate_to_depth(lmax, depth[:, None])
    return depth, tmin, tmax, contained


def _sig_slot_count(depth, tmin, tmax, contained, slots_per_axis: int):
    """Live emitted cells per object implied by a signature, and the
    per-object cell-overflow flag."""
    A = slots_per_axis
    shift = (32 - depth).clamp(max=31)
    span = ((tmax - tmin) & U32_MASK) >> shift[:, None]
    naxis = torch.where(depth[:, None] == 0, 1, span + 1)
    ovf = torch.any(naxis > A, dim=-1) & contained
    cnt = torch.prod(naxis.clamp(max=A), dim=-1)
    return torch.where(contained, cnt, 0), ovf


def build_tracked(spec: IndexSpec, system_min, system_max, bounds_min,
                  bounds_max, ids, slots_per_axis: int = 2,
                  min_depth: int = 0, out_capacity: Optional[int] = None,
                  device=None) -> TrackedScene:
    """``layer.build`` plus the bounds and signatures :func:`update` diffs
    against, on ``device`` (default as ``layer.build``: the first tensor
    input's device, else the card)."""
    dev = resolve_device(device, bounds_min, bounds_max, ids)
    state, emitted_aux, perm = _build(
        spec, system_min, system_max, bounds_min, bounds_max, ids,
        slots_per_axis=slots_per_axis, min_depth=min_depth,
        out_capacity=out_capacity, device=dev, want_perm=True)
    bmin, bmax = _f32(bounds_min, dev), _f32(bounds_max, dev)
    depth, tmin, tmax, contained = _signature(spec, system_min, system_max,
                                              bmin, bmax, min_depth)
    if isinstance(ids, np.ndarray):
        ids = ids.astype(np.int64)
    ids_t = torch.as_tensor(ids, dtype=torch.int64, device=dev)
    return TrackedScene(state, ids_t, bmin, bmax, depth, tmin, tmax,
                        contained, emitted_aux[perm])


def tree_aux_from_signature(spec: IndexSpec, state: LayerState, ids,
                            sig_tmin) -> torch.Tensor:
    """The tree's aux bits recomputed from the signature: bit k of a live
    entry is set iff its cell's axis-k origin is not its object's
    truncated minimum (the object's first cell along k); depth-0 cells and
    pads have none.  ``ids`` (N,) and ``sig_tmin`` (N, dim) as in a
    :class:`TrackedScene` (unique ids)."""
    if ids.shape[0] == 0:
        return torch.zeros_like(state.aux)
    live = state.ids != PAD_ID
    order = torch.argsort(ids)
    pos = torch.searchsorted(ids[order], torch.where(live, state.ids, 0))
    tmin = sig_tmin[order[pos.clamp(max=ids.shape[0] - 1)]]
    aux = torch.zeros_like(state.ids)
    for k, origin in enumerate(origin_of(spec, state.keys)):
        aux |= (origin != tmin[:, k]).to(torch.int64) << k
    cell = live & ((state.keys & spec.depth_mask) > 0)
    return torch.where(cell, aux, 0).to(torch.int32)


def _emit_rows(spec: IndexSpec, system_min, system_max, bmin_rows,
               bmax_rows, min_depth, slots_per_axis: int):
    """Cell emission on the gathered object rows only: (keys (OC, S),
    valid (OC, S)).  XLA's ``geom.emit_cells`` in the JAX package; here
    the port's ``geom.emit_cells``."""
    dev = bmin_rows.device
    smin, smax = _f32(system_min, dev), _f32(system_max, dev)
    contained = geom.bounds_contains(smin, smax, bmin_rows, bmax_rows)
    lmin = geom.to_local(smin, smax, bmin_rows)
    lmax = geom.to_local(smin, smax, bmax_rows)
    keys, valid, _ = geom.emit_cells(spec, lmin, lmax, min_depth,
                                     slots_per_axis)
    return keys, valid & contained[:, None]


def _churn_stream(spec: IndexSpec, ids_rows, aux_row, key_rows, valid_rows,
                  tag: int):
    """One churn side as flat (key, meta) columns and its keep mask;
    invalid lanes hold ``PAD_KEY``."""
    OC, S = valid_rows.shape
    keep = valid_rows.reshape(OC * S)
    ids2 = ids_rows[:, None].expand(OC, S).reshape(OC * S)
    aux2 = aux_row.to(torch.int64)[None, :].expand(OC, S).reshape(OC * S)
    meta = _pack_meta(spec.dim, ids2, aux2, tag)
    return (torch.where(keep, key_rows.reshape(OC * S), PAD_KEY),
            torch.where(keep, meta, PAD_KEY), keep)


def _tree_merge_cols(spec: IndexSpec, tracked: TrackedScene):
    """The sorted tree as merge columns (tag 0), with its aux before the
    wide-id mask; pads stay ``PAD_KEY``."""
    return _merge_cols(spec, tracked.state._replace(aux=tracked.tree_aux))


class _Churn(NamedTuple):
    """One frame's sorted churn buffer and what :func:`update` keeps."""

    signature: tuple             # (depth, tmin, tmax, contained), new bounds
    key: torch.Tensor            # (2C,) int64, sorted by (key, meta)
    meta: torch.Tensor           # (2C,) int64
    count: torch.Tensor          # () int64 live churn lanes, at most 2C
    overflow: torch.Tensor       # () bool: cell, churn, obj or id overflow


def _frame_churn(spec: IndexSpec, tracked: TrackedScene, system_min,
                 system_max, bmin_f, bmax_f, churn_cap: int,
                 slots_per_axis: int, obj_cap: int, wide_ids: bool
                 ) -> _Churn:
    """Signature diff, object-granular extraction and the sorted churn
    buffer (tombstones and inserts) of one frame, in the spans
    ``update.diff``, ``update.extract`` and ``update.churn``; under
    tracing it counts the objects whose signature changed
    (``update.changed``) and the churn entries handed to the merge
    (``update.churn_entries``), both 0-dim device tensors."""
    C, OC = churn_cap, obj_cap
    n = tracked.ids.shape[0]
    dev = tracked.ids.device
    min_depth = int(tracked.state.min_depth)
    with profiling.span("update.diff"):
        depth_n, tmin_n, tmax_n, cont_n = _signature(
            spec, system_min, system_max, bmin_f, bmax_f, min_depth)

        # equal signatures emit equal cells: drift within cells is no
        # churn; objects outside the system on both frames emit nothing
        # either way
        changed = ((depth_n != tracked.sig_depth)
                   | (cont_n != tracked.sig_contained)
                   | torch.any((tmin_n != tracked.sig_tmin)
                               | (tmax_n != tracked.sig_tmax), dim=-1)) \
            & (cont_n | tracked.sig_contained)

        old_cnt, _ = _sig_slot_count(tracked.sig_depth, tracked.sig_tmin,
                                     tracked.sig_tmax, tracked.sig_contained,
                                     slots_per_axis)
        new_cnt, new_ovf = _sig_slot_count(depth_n, tmin_n, tmax_n, cont_n,
                                           slots_per_axis)
        cell_ovf = torch.any(new_ovf)
        tomb_cnt = torch.where(changed, old_cnt, 0).sum()
        ins_cnt = torch.where(changed, new_cnt, 0).sum()
        obj_cnt = changed.sum(dtype=torch.int64)
        churn_ovf = (tomb_cnt > C) | (ins_cnt > C) | (obj_cnt > OC)
        profiling.count("update.changed", obj_cnt)

    with profiling.span("update.extract"):
        # the changed objects' indices (one 1-column compaction over the n
        # object lanes), then emission of only their old and new rows
        (obj_idx,), _ = stream_compact(
            changed, (torch.arange(n, dtype=torch.int64, device=dev),), (n,))
        if n >= OC:
            obj_idx = obj_idx[:OC]
        else:
            obj_idx = torch.cat([obj_idx, obj_idx.new_full((OC - n,), n)])
        row_live = torch.arange(OC, device=dev) < obj_cnt.clamp(max=OC)
        obj_idx = obj_idx.clamp(0, max(n - 1, 0))

        def rows(x):
            return x[obj_idx] if n else x.new_zeros((OC,) + x.shape[1:])

        old_keys, old_v = _emit_rows(spec, system_min, system_max,
                                     rows(tracked.bounds_min),
                                     rows(tracked.bounds_max), min_depth,
                                     slots_per_axis)
        new_keys, new_v = _emit_rows(spec, system_min, system_max,
                                     rows(bmin_f), rows(bmax_f), min_depth,
                                     slots_per_axis)
        ids_rows = rows(tracked.ids)
        aux_row = geom.slot_aux(spec.dim, slots_per_axis, dev)
        if n:
            max_id = torch.where(tracked.ids != PAD_ID, tracked.ids, 0).max()
            narrow = max_id < _PACK_ID_BOUND
        else:
            narrow = torch.ones((), dtype=torch.bool, device=dev)
        pack_ovf = torch.zeros((), dtype=torch.bool, device=dev) \
            if wide_ids else ~narrow

        t_key, t_meta, t_keep = _churn_stream(
            spec, ids_rows, aux_row, old_keys, old_v & row_live[:, None],
            1)                                               # tombstones
        i_key, i_meta, i_keep = _churn_stream(
            spec, ids_rows, aux_row, new_keys, new_v & row_live[:, None],
            0)                                               # inserts

    with profiling.span("update.churn"):
        # compact the 2*OC*S churn lanes to the 2C merge budget, then order
        # the buffer by (key, meta): meta's (id, aux, tag) lands each
        # tombstone directly after the tree entry it cancels
        (c_key, c_meta), c_cnt = stream_compact(
            torch.cat([t_keep, i_keep]), (torch.cat([t_key, i_key]),
                                          torch.cat([t_meta, i_meta])),
            (PAD_KEY, PAD_KEY))
        c_key, c_meta = to_length(c_key, 2 * C), to_length(c_meta, 2 * C)
        order = torch.sort(c_meta, stable=True).indices
        order = order[torch.sort(c_key[order], stable=True).indices]
        entries = c_cnt.clamp(max=2 * C)
        profiling.count("update.churn_entries", entries)
        return _Churn((depth_n, tmin_n, tmax_n, cont_n), c_key[order],
                      c_meta[order], entries,
                      cell_ovf | churn_ovf | pack_ovf)


def update(spec: IndexSpec, tracked: TrackedScene, system_min, system_max,
           bounds_min, bounds_max, churn_cap: int, slots_per_axis: int = 2,
           obj_cap: Optional[int] = None, wide_ids: bool = False
           ) -> TrackedScene:
    """Advance the tree to this frame's bounds by signature diff and
    tombstone merge.

    bounds_min/bounds_max: (N, dim) f32 for the object slots of
    :func:`build_tracked`; they move to the tracked scene's device.
    ``churn_cap`` bounds the changed cell slots per side, ``obj_cap``
    (default ``churn_cap``) the changed objects.  Returns a TrackedScene
    whose state equals ``layer.build`` on the new bounds (unique-id
    scenes), or has ``overflow`` set.

    Under ``profiling.tracing()`` the update opens ``layer.update`` with
    its stages: ``update.diff`` (signatures, diff, counts),
    ``update.extract`` (the changed objects' rows and churn streams),
    ``update.churn`` (compaction to the merge budget and the sort) and
    ``update.merge`` (k6 and the new state).
    """
    with profiling.span("layer.update"):
        state = tracked.state
        cap = capacity_of(state)
        dev = tracked.ids.device
        bmin_f, bmax_f = _f32(bounds_min, dev), _f32(bounds_max, dev)
        churn = _frame_churn(spec, tracked, system_min, system_max, bmin_f,
                             bmax_f, churn_cap, slots_per_axis,
                             obj_cap if obj_cap is not None else churn_cap,
                             wide_ids)

        with profiling.span("update.merge"):
            # merge, cancel and compact in one kernel; it has no churn
            # window, so the JAX package's choice between its kernel and a
            # global merge (broadphase_tpu/update.py:215-241) has no
            # counterpart here
            tree_key, tree_meta = _tree_merge_cols(spec, tracked)
            (out_key, out_meta), new_count, merge_ovf = merge_cancel_compact(
                tree_key, tree_meta, churn.key, churn.meta, churn.count, cap)
            o_ids, o_aux = _unpack_meta(spec, out_meta, cap, new_count)

            contained = churn.signature[3]
            new_state = state._replace(
                keys=out_key,
                ids=o_ids,
                # without wide_ids every live id is below 2^28 - 1 (else
                # overflow is set), where build masks nothing
                aux=mask_aux(o_ids, o_aux) if wide_ids else o_aux,
                count=new_count.clamp(max=cap),
                sorted=_host(True, torch.bool),
                invalid_count=(~contained).sum(dtype=torch.int64),
                overflow=(state.overflow | churn.overflow | merge_ovf
                          | (new_count > cap)),
            )
            return TrackedScene(new_state, tracked.ids, bmin_f, bmax_f,
                                *churn.signature, o_aux)
