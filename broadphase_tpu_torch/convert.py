"""Carry layer state between the JAX package and the port.

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
from .layer import LayerState


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
