"""Kernel 7: the v2 pair expansion from run starts (``csrc/expand.cu``).

Replaces ``broadphase_tpu/ops/pallas_expand.py::expand_pairs``, the
expansion that the JAX scan takes under ``BROADPHASE_EXPAND=v2`` (here
``layer.scan(..., expand="v2")``).  For each pair slot t < total, in run
j (the last element with ``starts[j] <= t``, which is the nonempty run
among equal starts):

    a = ids[j + 1 + (t - starts[j])]     b = ids[j]

and PAD on both sides for t >= total.  There is no emit-once rule: every
emission of a pair survives to the canonical dedup.  The kernel gives one
thread per slot and finds j by binary search over ``starts``; bound by
device memory (16 bytes written per slot).
"""

from __future__ import annotations

import torch

from . import _cuda
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


def expand_pairs(ids: torch.Tensor, starts: torch.Tensor, run: torch.Tensor,
                 total, pair_capacity: int):
    """:func:`expand_pairs_plain` on CPU tensors; the CUDA kernel on CUDA
    tensors (ids, starts and run int64 of one length, total an int64 scalar
    on the card).  The kernel reads only ids and starts."""
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
    a = torch.empty(pair_capacity, dtype=torch.int64, device=ids.device)
    b = torch.empty_like(a)
    _cuda.launch("bpt_expand_v2", ids, starts, total, a, b, cap,
                 int(pair_capacity))
    expand_pairs.launches += 1
    return a, b


expand_pairs.launches = 0
