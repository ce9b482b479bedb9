"""Kernel 6: merge, tombstone cancel and compaction for ``update``
(``csrc/merge.cu``).

Replaces ``broadphase_tpu/ops/pallas_merge.py::merge_cancel_compact``.
Column contract: two int64 columns, ``key`` and ``meta = (id << (dim+1))
| (aux << 1) | tag``, each input sorted lexicographically by (key, meta).
A tombstone (tag 1) equals the tree entry it kills except in the tag bit,
so it sorts directly after it.  Pads are ``PAD_KEY`` in both columns: they
sort last and carry the tag.  Churn lanes at or past ``churn_count`` count
as pads.

The merged sequence puts a tree entry before an equal churn entry.  An
element is dropped if its own tag is set, or if the next merged element
has its key, its ``meta >> 1`` and the tag.  The survivors, in merged
order, come out compacted with ``PAD_KEY`` past the count.  The plain
version is the global formulation of ``broadphase_tpu/update.py:243-272``:
concatenate, stable lexicographic sort, shift-compare, compact.  The
kernel merges by merge path, one tile of merged positions a block, and
compacts by decoupled look-back in the same pass; bound by device memory.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .. import profiling
from ..index import PAD_KEY
from . import _cuda
from .compact import stream_compact_plain


def to_length(col: torch.Tensor, n: int) -> torch.Tensor:
    """``col`` cut, or padded with ``PAD_KEY``, to n entries."""
    if col.shape[0] >= n:
        return col[:n]
    return torch.cat([col, col.new_full((n - col.shape[0],), PAD_KEY)])


def merge_cancel_compact_plain(tree_key: torch.Tensor,
                               tree_meta: torch.Tensor,
                               churn_key: torch.Tensor,
                               churn_meta: torch.Tensor, churn_count,
                               out_capacity: int
                               ) -> Tuple[Tuple[torch.Tensor, torch.Tensor],
                                          torch.Tensor, torch.Tensor]:
    """Returns ((key, meta) of length ``out_capacity``, count,
    window_overflow); count is every survivor, and may exceed
    out_capacity; window_overflow is always false."""
    dev = tree_key.device
    nc = churn_key.shape[0]
    cc = torch.as_tensor(churn_count, dtype=torch.int64,
                         device=dev).clamp(0, nc)
    live = torch.arange(nc, device=dev) < cc
    key = torch.cat([tree_key, torch.where(live, churn_key, PAD_KEY)])
    meta = torch.cat([tree_meta, torch.where(live, churn_meta, PAD_KEY)])
    order = torch.sort(meta, stable=True).indices
    order = order[torch.sort(key[order], stable=True).indices]
    key, meta = key[order], meta[order]
    pad = key.new_full((1,), PAD_KEY)
    nkey = torch.cat([key[1:], pad])
    nmeta = torch.cat([meta[1:], pad])
    dead = (((meta & 1) == 1)
            | ((nkey == key) & ((nmeta >> 1) == (meta >> 1))
               & ((nmeta & 1) == 1)))
    (out_key, out_meta), count = stream_compact_plain(
        ~dead, (key, meta), (PAD_KEY, PAD_KEY))
    return ((to_length(out_key, out_capacity),
             to_length(out_meta, out_capacity)),
            count, torch.zeros((), dtype=torch.bool, device=dev))


def merge_cancel_compact(tree_key: torch.Tensor, tree_meta: torch.Tensor,
                         churn_key: torch.Tensor, churn_meta: torch.Tensor,
                         churn_count, out_capacity: int):
    """:func:`merge_cancel_compact_plain` on CPU tensors; the CUDA kernel on
    CUDA tensors (int64 columns, churn_count an int64 scalar on the card).
    The kernel has no churn window, so window_overflow is always false."""
    if tree_key.device.type == "cpu":
        return merge_cancel_compact_plain(tree_key, tree_meta, churn_key,
                                          churn_meta, churn_count,
                                          out_capacity)
    cap, nc = tree_key.shape[0], churn_key.shape[0]
    if (any(c.dtype != torch.int64 for c in (tree_key, tree_meta, churn_key,
                                             churn_meta))
            or tree_meta.shape != (cap,) or churn_meta.shape != (nc,)):
        raise ValueError("merge_cancel_compact: int64 (key, meta) columns "
                         "of one length per side expected")
    dev = tree_key.device
    cc = torch.as_tensor(churn_count, dtype=torch.int64,
                         device=dev).reshape(())
    _cuda.require_cuda("merge_cancel_compact", tree_key, tree_meta,
                       churn_key, churn_meta, cc)
    out_key = torch.empty(out_capacity, dtype=torch.int64, device=dev)
    out_meta = torch.empty_like(out_key)
    count = torch.empty((), dtype=torch.int64, device=dev)
    tiles = -(-max(cap + nc, out_capacity) // _cuda.merge_tile())
    scratch = torch.empty(tiles + 1, dtype=torch.int64, device=dev)
    _cuda.launch("bpt_merge", tree_key, tree_meta, churn_key, churn_meta, cc,
                 out_key, out_meta, count, scratch, cap, nc,
                 int(out_capacity))
    profiling.count("k6.launches", 1)
    return ((out_key, out_meta), count,
            torch.zeros((), dtype=torch.bool, device=dev))
