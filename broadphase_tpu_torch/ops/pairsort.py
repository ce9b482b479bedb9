"""Kernel 8: the canonical pair sort (``csrc/pairsort.cu``).

Replaces no TPU kernel: the JAX package sorts the pairs with ``lax.sort``
(``broadphase_tpu/layer.py::canonical_pairs``).  The chain compacts the
valid (a, b) lanes in emission order up to the output's capacity, packs
each as the unsigned key ``(a << w) | b``, ``w`` the bit length of the
largest live id, sorts the live keys by 8-bit LSD radix passes over their
``2w`` bits (a pass whose digit every key shares is skipped), and drops
each key equal to the one before it.  Every valid id must be below
``2^32 - 1``; the output is sorted by (a, b), deduplicated, PAD past the
count, as ``torch.sort`` of ``((a - 2^31) << 32) + b`` left it.

On a CUDA tensor the chain runs on the card with no host read (the width,
the live count and the plan of passes stay on the device); on a CPU
tensor :func:`pair_sort_plain` runs the same arithmetic.  The plain
version sorts the packed keys in one ``torch.sort``: a sort of keys alone
has one result, which the passes reach digit by digit.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import profiling
from . import _cuda

PAD_ID = 0xFFFF_FFFF
DIGIT_BITS = 8
MAX_LANES = 2 ** 31 - 1
_SIGN = -(1 << 63)


def width_of(bound: int) -> int:
    """The key's half width: the bit length of the id bound, at most 32."""
    return min(int(bound).bit_length(), 32)


def plan_passes(keys: torch.Tensor, w: int) -> torch.Tensor:
    """The radix passes that do work on ``keys`` (int64 views of the
    unsigned keys): those of the ``ceil(2w / 8)`` digits that not every
    key shares."""
    work = torch.zeros((), dtype=torch.int64, device=keys.device)
    if keys.numel() == 0:
        return work
    for p in range(-(-2 * w // DIGIT_BITS)):
        digit = (keys >> (DIGIT_BITS * p)) & ((1 << DIGIT_BITS) - 1)
        work = work + (digit != digit[0]).any().to(torch.int64)
    return work


def pair_sort_plain(a: torch.Tensor, b: torch.Tensor,
                    valid: Optional[torch.Tensor], capacity: int,
                    id_bound=None):
    """The chain's arithmetic in torch.  Returns (out_a, out_b, count,
    total, passes): the sorted, deduplicated pairs of the first
    ``capacity`` valid lanes (``valid`` None: the lanes where a != b) in
    ``capacity`` lanes, PAD past the count;
    the count of valid lanes; the passes that did work.  ``id_bound``
    (default: the largest valid id) bounds every valid id."""
    if valid is None:
        valid = a != b
    total = valid.sum(dtype=torch.int64)
    a_v, b_v = a[valid], b[valid]
    if id_bound is None:
        id_bound = torch.maximum(a_v.max(), b_v.max()) if a_v.numel() else 0
    w = width_of(id_bound)
    keys = (a_v[:capacity] << w) | b_v[:capacity]
    # flipping the sign bit orders the unsigned keys as int64
    keys = torch.sort(keys ^ _SIGN).values ^ _SIGN
    passes = plan_passes(keys, w)
    keep = torch.ones_like(keys, dtype=torch.bool)
    keep[1:] = keys[1:] != keys[:-1]
    kept = keys[keep]
    low = (1 << w) - 1
    out_a = torch.full((capacity,), PAD_ID, dtype=torch.int64,
                       device=a.device)
    out_b = out_a.clone()
    out_a[:kept.shape[0]] = (kept >> w) & low
    out_b[:kept.shape[0]] = kept & low
    count = torch.tensor(kept.shape[0], dtype=torch.int64, device=a.device)
    return out_a, out_b, count, total, passes


def pair_sort(a: torch.Tensor, b: torch.Tensor,
              valid: Optional[torch.Tensor], capacity: int,
              id_bound: Optional[torch.Tensor] = None):
    """:func:`pair_sort_plain` on a CPU tensor; the chain on a CUDA tensor
    (int64 ``a``, ``b`` and bool ``valid``, or None, of one length;
    ``id_bound`` a 0-dim int64 tensor or None).  Returns (out_a, out_b,
    count, total).  Under ``profiling.tracing()`` it counts
    ``scan.sort_passes`` (read from the chain's scratch on the card: no
    device operation), and on the card ``k8.launches``."""
    if a.device.type == "cpu":
        out = pair_sort_plain(a, b, valid, capacity, id_bound)
        profiling.count("scan.sort_passes", out[4])
        return out[:4]
    n = a.shape[0]
    if any(c.dtype != torch.int64 or c.shape != (n,) for c in (a, b)) or (
            valid is not None and (valid.dtype != torch.bool
                                   or valid.shape != (n,))):
        raise ValueError("pair_sort: valid must be bool and a, b int64, "
                         "all of one length")
    if id_bound is not None and (id_bound.dtype != torch.int64
                                 or id_bound.dim() != 0):
        raise ValueError("pair_sort: id_bound must be a 0-dim int64 tensor")
    if max(n, capacity) > MAX_LANES:
        raise ValueError(f"pair_sort takes at most {MAX_LANES} lanes, got "
                         f"{max(n, capacity)}")
    _cuda.require_cuda("pair_sort", a, b, *(
        t for t in (valid, id_bound) if t is not None))
    dev = a.device
    keys = [torch.empty(capacity, dtype=torch.int64, device=dev)
            for _ in range(2)]
    out_a = torch.empty(capacity, dtype=torch.int64, device=dev)
    out_b = torch.empty(capacity, dtype=torch.int64, device=dev)
    count = torch.empty((), dtype=torch.int64, device=dev)
    # the chain's Info words first (csrc/pairsort.cu), then its histograms,
    # tickets and status words; the entry point clears it
    scratch = torch.empty(_cuda.pairsort_scratch(n, capacity),
                          dtype=torch.int64, device=dev)
    _cuda.launch("bpt_pairsort", a, b, 0 if valid is None else valid,
                 0 if id_bound is None else id_bound, *keys, out_a, out_b,
                 count, scratch, n, capacity)
    profiling.count("k8.launches", 1)
    total, passes = scratch[0], scratch[4]
    profiling.count("scan.sort_passes", passes)
    return out_a, out_b, count, total
