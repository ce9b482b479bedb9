"""Kernel 7: the v2 pair expansion (``csrc/expand2.cu``, kernel 4's
template with the rule compiled out).

Replaces ``broadphase_tpu/ops/pallas_expand.py::expand_pairs``, the
expansion that the JAX scan takes under ``BROADPHASE_EXPAND=v2`` (here
``layer.scan(..., expand="v2")``).  For each pair slot t < total, in run
j (the last element with ``starts[j] <= t``, which is the nonempty run
among equal starts):

    a = ids[j + 1 + (t - starts[j])]     b = ids[j]

and PAD on both sides for t >= total.  There is no emit-once rule: every
emission of a pair survives to the canonical dedup.

The kernel takes the nonempty runs as the prep kernel lays them out
(``ops/prep.py``: sv = starts[j], ab = j + 1 - starts[j], bid = ids[j]),
which makes the same pair ``a = ids[t + ab[k]]``, ``b = bid[k]`` slot for
slot: :func:`expand_pairs_entries`, which the v2 scan calls.  It
partitions the slots into blocks of 1024 and finds each block's runs by
one search, as kernel 4 does; bound by device memory (16 bytes written
per slot).  :func:`expand_pairs` keeps the JAX function's contract
(``starts`` and ``run`` of every element); on the card it compacts the
nonempty runs into entries with kernel 5 first.
"""

from __future__ import annotations

import torch

from .. import profiling
from . import _cuda
from .compact import stream_compact
from .expand2 import expand_pairs_prepped_plain
from .prep import HUGE
from .search import expand_runs, segmented_broadcast

PAD_ID = 0xFFFF_FFFF


def expand_pairs_plain(ids: torch.Tensor, starts: torch.Tensor,
                       run: torch.Tensor, total, pair_capacity: int):
    """The JAX package's XLA formulation (``layer.py:1000-1006`` without the
    rule): slot -> run by :func:`expand_runs`, the b side by
    :func:`segmented_broadcast`.  Returns (a, b) int64 (pair_capacity,)."""
    P = pair_capacity
    cap = ids.shape[0]
    dev = ids.device
    t = torch.arange(P, dtype=torch.int64, device=dev)
    pad = torch.full((P,), PAD_ID, dtype=torch.int64, device=dev)
    if cap == 0:
        return pad, pad.clone()
    j, off = expand_runs(starts, P)
    i = (j.clamp(0, cap - 1) + 1 + off.clamp(min=0)).clamp(0, cap - 1)
    a = ids[i]
    b = segmented_broadcast(starts, run, ids, P)
    live = t < torch.as_tensor(total, device=dev)
    return torch.where(live, a, pad), torch.where(live, b, pad)


def expand_pairs_entries_plain(ids, sv, ab, bid, m, total,
                               pair_capacity: int):
    """Kernel 4's plain version with the rule off: slot -> entry by
    ``expand_runs`` over the m live starts.  Returns (a, b) int64
    (pair_capacity,)."""
    return expand_pairs_prepped_plain(ids, None, sv, ab, bid, None, m, total,
                                      pair_capacity, False, 0)


def expand_pairs_entries(ids, sv, ab, bid, m, total, pair_capacity: int):
    """:func:`expand_pairs_entries_plain` on CPU tensors; the CUDA kernel
    on CUDA tensors (ids int64 per tree entry; sv/ab/bid int64 per prepped
    entry; m and total int64 scalars on the card)."""
    if ids.device.type == "cpu":
        return expand_pairs_entries_plain(ids, sv, ab, bid, m, total,
                                          pair_capacity)
    if (ids.dtype != torch.int64 or sv.dtype != torch.int64
            or ab.dtype != torch.int64 or bid.dtype != torch.int64
            or not sv.shape == ab.shape == bid.shape):
        raise ValueError("expand_pairs_entries: int64 ids, and int64 "
                         "sv/ab/bid of one length expected")
    dev = ids.device
    m_t = torch.as_tensor(m, dtype=torch.int64, device=dev).reshape(())
    total_t = torch.as_tensor(total, dtype=torch.int64,
                              device=dev).reshape(())
    _cuda.require_cuda("expand_pairs_entries", ids, sv, ab, bid, m_t,
                       total_t)
    a = torch.empty(pair_capacity, dtype=torch.int64, device=dev)
    b = torch.empty_like(a)
    _cuda.launch("bpt_expand_v2", ids, sv, ab, bid, m_t, total_t, a, b,
                 ids.shape[0], int(pair_capacity))
    profiling.count("k7.launches", 1)
    return a, b


def expand_pairs(ids: torch.Tensor, starts: torch.Tensor, run: torch.Tensor,
                 total, pair_capacity: int):
    """:func:`expand_pairs_plain` on CPU tensors.  On CUDA tensors (ids,
    starts and run int64 of one length, total an int64 scalar on the
    card), kernel 5 compacts the nonempty runs into prepped entries and
    :func:`expand_pairs_entries` expands them."""
    if ids.device.type == "cpu":
        return expand_pairs_plain(ids, starts, run, total, pair_capacity)
    cap = ids.shape[0]
    if (ids.dtype != torch.int64 or starts.dtype != torch.int64
            or run.dtype != torch.int64 or starts.shape != (cap,)
            or run.shape != (cap,)):
        raise ValueError("expand_pairs: int64 ids, starts and run of one "
                         "length expected")
    total = torch.as_tensor(total, dtype=torch.int64,
                            device=ids.device).reshape(())
    _cuda.require_cuda("expand_pairs", ids, starts, run, total)
    lane = torch.arange(cap, dtype=torch.int64, device=ids.device)
    (sv, ab, bid), m = stream_compact(run > 0, (starts, lane + 1 - starts,
                                                ids), (HUGE, 0, PAD_ID))
    return expand_pairs_entries(ids, sv, ab, bid, m, total, pair_capacity)
