"""Kernel 4: pair expansion with the emit-once rule (``csrc/expand2.cu``).

Replaces ``broadphase_tpu/ops/pallas_expand2.py::expand_pairs_prepped``.
For each pair slot t < total, in run k (the last prepped entry with
``sv[k] <= t``):

    a = ids[t + ab[k]]     b = bid[k]

With the rule on, the emission is kept only in the pair's canonical cell
(:func:`emit_once_keep`); dropped emissions and slots >= total are PAD on
both sides.  The kernel partitions the slots into blocks of 1024, finds
each block's first and last run by one search, and gives every slot its
run by a forward fill in shared memory; bound by device memory (16 bytes
written per slot).
"""

from __future__ import annotations

import torch

from .. import profiling
from . import _cuda
from .search import expand_runs, segmented_broadcast

PAD_ID = 0xFFFF_FFFF


def emit_once_keep(dim: int, a_meta: torch.Tensor,
                   b_meta: torch.Tensor) -> torch.Tensor:
    """The emit-once rule (``broadphase_tpu.layer._emit_once_keep``): keep
    this emission iff no axis has both sides off their block minimum and
    the a-side alignment depth reaches the b entry's depth.  a_meta is the
    a-side byte ``(alpha << dim) | e``, b_meta ``(depth << dim) | e``."""
    emask = (1 << dim) - 1
    return (((a_meta & b_meta & emask) == 0)
            & ((a_meta >> dim) <= (b_meta >> dim)))


def expand_pairs_prepped_plain(ids, ameta, sv, ab, bid, bmeta, m, total,
                               pair_capacity: int, rule, dim: int):
    """The JAX package's XLA formulation over the prepped entries: slot ->
    entry by :func:`expand_runs`, b-side values by
    :func:`segmented_broadcast`.  Returns (a, b) int64 (pair_capacity,)."""
    P = pair_capacity
    dev = ids.device
    live_sv = sv[:int(m)]
    t = torch.arange(P, dtype=torch.int64, device=dev)
    valid = t < total
    pad = torch.full((P,), PAD_ID, dtype=torch.int64, device=dev)
    if live_sv.shape[0] == 0 or ids.shape[0] == 0:
        return pad, pad.clone()
    k, _ = expand_runs(live_sv, P)
    k = k.clamp(0, live_sv.shape[0] - 1)
    idx = (t + ab[k]).clamp(0, ids.shape[0] - 1)
    ones = torch.ones_like(live_sv)
    a = ids[idx]
    b = segmented_broadcast(live_sv, ones, bid[:live_sv.shape[0]], P)
    if bool(rule):
        bm = segmented_broadcast(live_sv, ones, bmeta[:live_sv.shape[0]], P)
        valid = valid & emit_once_keep(dim, ameta[idx], bm)
    return torch.where(valid, a, pad), torch.where(valid, b, pad)


def expand_pairs_prepped(ids, ameta, sv, ab, bid, bmeta, m, total,
                         pair_capacity: int, rule, dim: int):
    """:func:`expand_pairs_prepped_plain` on CPU tensors; the CUDA kernel on
    CUDA tensors.  ids int64 and ameta int32 per tree entry; sv/ab/bid
    int64 and bmeta int32 per prepped entry (``ops/prep.py``); m, total and
    rule scalars on the card."""
    if ids.device.type == "cpu":
        return expand_pairs_prepped_plain(ids, ameta, sv, ab, bid, bmeta, m,
                                          total, pair_capacity, rule, dim)
    if (ids.dtype != torch.int64 or ameta.dtype != torch.int32
            or sv.dtype != torch.int64 or ab.dtype != torch.int64
            or bid.dtype != torch.int64 or bmeta.dtype != torch.int32):
        raise ValueError("expand_pairs_prepped: int64 ids/sv/ab/bid and "
                         "int32 ameta/bmeta expected")
    if ameta.shape != ids.shape or not (
            sv.shape == ab.shape == bid.shape == bmeta.shape):
        raise ValueError("expand_pairs_prepped: ameta must match ids, and "
                         "sv/ab/bid/bmeta one another, in length")
    dev = ids.device
    m_t = torch.as_tensor(m, dtype=torch.int64, device=dev).reshape(())
    total_t = torch.as_tensor(total, dtype=torch.int64,
                              device=dev).reshape(())
    rule_t = torch.as_tensor(rule, dtype=torch.bool, device=dev).reshape(())
    _cuda.require_cuda("expand_pairs_prepped", ids, ameta, sv, ab, bid,
                       bmeta, m_t, total_t, rule_t)
    a = torch.empty(pair_capacity, dtype=torch.int64, device=dev)
    b = torch.empty_like(a)
    _cuda.launch("bpt_expand", ids, ameta, sv, ab, bid, bmeta, m_t, total_t,
                 rule_t, a, b, ids.shape[0], int(pair_capacity), int(dim))
    profiling.count("k4.launches", 1)
    return a, b
