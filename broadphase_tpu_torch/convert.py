"""Carry layer state and tracked scenes, single-chip and sharded, between
the JAX package and the port.

The JAX ``LayerState`` holds keys as u32 columns (``(hi, lo)`` for 64-bit
specs), u32 ids and aux, and scalar count and flags.  Its fields travel as
numpy arrays in a mapping with the JAX field names; ``keys`` is the tuple of
key columns, most significant first (``broadphase_tpu.index.sort_operands``).
This module never imports JAX: the caller turns the JAX arrays into numpy.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from .index import IndexSpec, key_from_columns, key_to_columns
from .layer import LayerState, resolve_device
from .parallel.layer import ShardedLayer, local_state
from .parallel.update import ShardedTracked
from .update import TrackedScene, tree_aux_from_signature


def layer_state_from_jax(spec: IndexSpec, fields: Mapping[str, Any],
                         device=None) -> LayerState:
    """The port's :class:`LayerState` for a JAX layer's numpy fields; the
    all-ones pad key becomes ``PAD_KEY``."""
    def scalar(name, dtype, dev=device):
        return torch.tensor(np.asarray(fields[name]).item(), dtype=dtype,
                            device=dev)

    return LayerState(
        keys=key_from_columns(spec, fields["keys"], device),
        ids=torch.as_tensor(np.asarray(fields["ids"], np.uint32)
                            .astype(np.int64), device=device),
        aux=torch.as_tensor(np.asarray(fields["aux"], np.uint32)
                            .astype(np.int32), device=device),
        count=scalar("count", torch.int64),
        sorted=scalar("sorted", torch.bool, None),
        min_depth=scalar("min_depth", torch.int64, None),
        invalid_count=scalar("invalid_count", torch.int64),
        overflow=scalar("overflow", torch.bool),
    )


def layer_state_to_numpy(spec: IndexSpec, state: LayerState
                         ) -> Dict[str, Any]:
    """Inverse of :func:`layer_state_from_jax`: the fields as the JAX
    package holds them (u32 key columns with all-ones pads, u32 ids and
    aux, numpy scalars)."""
    return {
        "keys": key_to_columns(spec, state.keys),
        "ids": state.ids.cpu().numpy().astype(np.uint32),
        "aux": state.aux.cpu().numpy().astype(np.uint32),
        "count": np.int32(int(state.count)),
        "sorted": np.bool_(bool(state.sorted)),
        "min_depth": np.uint32(int(state.min_depth)),
        "invalid_count": np.int32(int(state.invalid_count)),
        "overflow": np.bool_(bool(state.overflow)),
    }


_TRACKED_ARRAYS = ("bounds_min", "bounds_max", "sig_depth", "sig_tmin",
                   "sig_tmax", "sig_contained")


def tracked_scene_from_jax(spec: IndexSpec, fields: Mapping[str, Any],
                           device) -> TrackedScene:
    """The port's :class:`~broadphase_tpu_torch.update.TrackedScene` for a
    JAX ``TrackedScene``'s numpy fields: ``state`` is a mapping as
    :func:`layer_state_from_jax` takes, the other fields are arrays with
    the JAX field names (u32 ids and signatures, f32 bounds, bool
    containment).

    The port's scene also carries the tree's aux bits before the wide-id
    mask, which a JAX scene does not hold (its ``wide_ids`` update zeroes
    aux): they are recomputed from the tree's keys and ids and the
    objects' signatures (``update.tree_aux_from_signature``), which is
    what ``layer.build`` on the scene's bounds emits for them."""
    def arr(name):
        x = np.array(fields[name])
        if x.dtype == np.uint32:
            x = x.astype(np.int64)
        return torch.as_tensor(x, device=device)

    state = layer_state_from_jax(spec, fields["state"], device)
    ids, sig_tmin = arr("ids"), arr("sig_tmin")
    return TrackedScene(state, ids, *(arr(f) for f in _TRACKED_ARRAYS),
                        tree_aux_from_signature(spec, state, ids, sig_tmin))


def tracked_scene_to_numpy(spec: IndexSpec, tracked: TrackedScene
                           ) -> Dict[str, Any]:
    """Inverse of :func:`tracked_scene_from_jax`: the fields as the JAX
    package holds them."""
    out = {"state": layer_state_to_numpy(spec, tracked.state),
           "ids": tracked.ids.cpu().numpy().astype(np.uint32)}
    for name in _TRACKED_ARRAYS:
        x = getattr(tracked, name).cpu().numpy()
        out[name] = x.astype(np.uint32) if x.dtype == np.int64 else x
    return out


def _rank_device(device, rank: int) -> torch.device:
    """``device``, or rank ``rank``'s card ``cuda:{rank % device_count}``
    as the sharded entry points default to; raises where there is no card
    (``layer.resolve_device``)."""
    if device is None:
        device = f"cuda:{rank % max(torch.cuda.device_count(), 1)}"
    return resolve_device(device)


def sharded_layer_from_jax(spec: IndexSpec, fields: Mapping[str, Any],
                           rank: int, n_dev: int, min_depth: int,
                           device=None) -> ShardedLayer:
    """Rank ``rank``'s :class:`~broadphase_tpu_torch.parallel.ShardedLayer`
    of a JAX ``ShardedLayer`` over ``n_dev`` devices, given as numpy
    fields with the JAX names (``keys`` the tuple of global key columns,
    ``ids``, ``aux``, ``counts``, ``invalid_count``, ``overflow``): device
    ``rank``'s lanes ``[rank * frag, (rank + 1) * frag)`` become the
    fragment, on ``device`` (default: the rank's card).  A JAX sharded
    layer does not hold its ``min_depth``: pass the one it was built with
    (at least ``min_depth_for_devices``)."""
    device = _rank_device(device, rank)
    frag = np.asarray(fields["ids"]).shape[0] // n_dev
    lanes = slice(rank * frag, (rank + 1) * frag)

    def scalar(name, dtype):
        return torch.tensor(np.asarray(fields[name]).item(), dtype=dtype,
                            device=device)

    return ShardedLayer(
        keys=key_from_columns(spec, [np.asarray(c)[lanes]
                                     for c in fields["keys"]], device),
        ids=torch.as_tensor(np.asarray(fields["ids"], np.uint32)[lanes]
                            .astype(np.int64), device=device),
        aux=torch.as_tensor(np.asarray(fields["aux"], np.uint32)[lanes]
                            .astype(np.int32), device=device),
        counts=torch.as_tensor(np.asarray(fields["counts"]).astype(
            np.int64), device=device),
        invalid_count=scalar("invalid_count", torch.int64),
        overflow=scalar("overflow", torch.bool),
        min_depth=torch.tensor(int(min_depth), dtype=torch.int64))


def sharded_tracked_from_jax(spec: IndexSpec, fields: Mapping[str, Any],
                             rank: int, n_dev: int, min_depth: int,
                             device=None) -> ShardedTracked:
    """Rank ``rank``'s :class:`~broadphase_tpu_torch.parallel.ShardedTracked`
    of a JAX ``ShardedTracked``'s numpy fields: ``layer`` a mapping as
    :func:`sharded_layer_from_jax` takes, and the global object arrays
    (``ids``, ``bounds_min``, ``bounds_max``, ``sig_*``), of which the
    rank keeps its block ``[rank * n / n_dev, (rank + 1) * n / n_dev)``.
    The fragment's aux before the wide-id gate, which a JAX scene does not
    hold, is recomputed from the keys, the ids and the signatures
    (``update.tree_aux_from_signature``).  On ``device``, by default the
    rank's card."""
    device = _rank_device(device, rank)
    lyr = sharded_layer_from_jax(spec, fields["layer"], rank, n_dev,
                                 min_depth, device)

    def arr(name):
        x = np.array(fields[name])
        if x.dtype == np.uint32:
            x = x.astype(np.int64)
        return torch.as_tensor(x, device=device)

    ids, sig_tmin = arr("ids"), arr("sig_tmin")
    step = ids.shape[0] // n_dev
    objs = slice(rank * step, (rank + 1) * step)
    tree_aux = tree_aux_from_signature(spec, local_state(lyr, rank), ids,
                                       sig_tmin)
    return ShardedTracked(lyr, ids[objs],
                          *(arr(f)[objs] for f in _TRACKED_ARRAYS),
                          tree_aux)
