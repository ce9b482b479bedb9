"""Kernel 8: the canonical pair sort (``csrc/pairsort.cu``).

Replaces no TPU kernel: the JAX package sorts the pairs with ``lax.sort``
(``broadphase_tpu/layer.py::canonical_pairs``).  The chain compacts the
valid (a, b) lanes in emission order up to the output's capacity, packs
each as the unsigned key ``(a << w) | b``, ``w`` the bit length of the
largest live id, splits the live keys into buckets of consecutive key
ranges by one scatter on their high bits (:func:`plan_buckets`), sorts each
bucket in one block's shared memory (a bucket over :func:`bucket_keys`
keys, through global memory), and drops each key equal to the one before
it.  Every valid id must be below ``2^32 - 1``; the output is sorted by
(a, b), deduplicated, PAD past the count, as ``torch.sort`` of
``((a - 2^31) << 32) + b`` left it.

On a CUDA tensor the chain runs on the card with no host read (the width,
the live count, the passes and the buckets stay on the device); on a CPU
tensor :func:`pair_sort_plain` runs the same arithmetic.  The plain
version sorts the packed keys in one ``torch.sort``: a sort of keys alone
has one result, which the buckets reach range by range.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import profiling
from . import _cuda

PAD_ID = 0xFFFF_FFFF
DIGIT_BITS = 8
MAX_LANES = 2 ** 31 - 1
# the chain's buckets (csrc/pairsort.cu): the most keys a bucket sorts in
# shared memory as 4-byte offsets from its base (kBucketKeys; half that as
# 8-byte ones), the keys a bucket averages at most (kTarget; half that
# with 8-byte offsets) and the most buckets (kMaxBuckets)
BUCKET_KEYS = 256 * 24
BUCKET_TARGET = 2560
MAX_BUCKETS = 16384
_SIGN = -(1 << 63)
_U64 = (1 << 64) - 1
# the chain's Info words read back as counters: the valid lanes, the
# passes, the spilled keys
_TOTAL, _PASSES, _SPILLED = 0, 3, 4


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


def _shift_for(live: int, span: int, target: int) -> int:
    want = min(-(-live // target), MAX_BUCKETS // 2)
    if want <= 1:
        return min(span.bit_length(), 63)
    shift = 63
    while shift > 0 and (span >> shift) < want - 1:
        shift -= 1
    return shift


def bucket_shift(live: int, span: int) -> int:
    """The chain's bucket width, ``bucket(key) = (key - least) >> shift``
    over ``live`` keys whose largest less least is ``span``: the largest
    shift in [0, 63] that leaves at least ``ceil(live / BUCKET_TARGET)``
    buckets (at most ``MAX_BUCKETS / 2`` asked for), 0 where no shift does,
    and for one bucket the smallest shift that leaves one; where that
    shift passes 32 (a bucket's offsets take 8 bytes), the same for half
    the target."""
    shift = _shift_for(live, span, BUCKET_TARGET)
    if shift > 32:
        shift = _shift_for(live, span, BUCKET_TARGET // 2)
    return shift


def bucket_keys(shift: int) -> int:
    """The most keys a bucket of width ``shift`` sorts in shared memory."""
    return BUCKET_KEYS if shift <= 32 else BUCKET_KEYS // 2


def plan_buckets(keys: torch.Tensor):
    """The chain's buckets over the live ``keys`` (int64 views of the
    unsigned keys, in any order): (shift, counts, spilled), the keys of each
    bucket and the keys of the buckets over :func:`bucket_keys` (a 0-dim
    tensor), which the chain sorts through global memory."""
    if keys.numel() == 0:
        return 0, keys.new_zeros(0), keys.new_zeros(())
    # flipping the sign bit orders the unsigned keys as int64
    least = (int((keys ^ _SIGN).min()) ^ _SIGN) & _U64
    largest = (int((keys ^ _SIGN).max()) ^ _SIGN) & _U64
    shift = bucket_shift(keys.numel(), largest - least)
    # key - least wraps as unsigned; the shift is logical
    diff = keys - (least - (1 << 64) if least >> 63 else least)
    bucket = diff if shift == 0 else (
        (diff >> shift) & ((1 << (64 - shift)) - 1))
    counts = torch.bincount(bucket, minlength=((largest - least) >> shift) + 1)
    return shift, counts, counts[counts > bucket_keys(shift)].sum()


def pair_sort_plain(a: torch.Tensor, b: torch.Tensor,
                    valid: Optional[torch.Tensor], capacity: int,
                    id_bound=None):
    """The chain's arithmetic in torch.  Returns (out_a, out_b, count,
    total, passes, spilled): the sorted, deduplicated pairs of the first
    ``capacity`` valid lanes (``valid`` None: the lanes where a != b) in
    ``capacity`` lanes, PAD past the count; the count of valid lanes; the
    8-bit digits on which the live keys differ; the live keys of the
    buckets over :func:`bucket_keys`.  ``id_bound`` (default: the largest
    valid id) bounds every valid id."""
    if valid is None:
        valid = a != b
    total = valid.sum(dtype=torch.int64)
    a_v, b_v = a[valid], b[valid]
    if id_bound is None:
        id_bound = torch.maximum(a_v.max(), b_v.max()) if a_v.numel() else 0
    w = width_of(id_bound)
    keys = (a_v[:capacity] << w) | b_v[:capacity]
    spilled = plan_buckets(keys)[2]
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
    return out_a, out_b, count, total, passes, spilled


def pair_sort(a: torch.Tensor, b: torch.Tensor,
              valid: Optional[torch.Tensor], capacity: int,
              id_bound: Optional[torch.Tensor] = None):
    """:func:`pair_sort_plain` on a CPU tensor; the chain on a CUDA tensor
    (int64 ``a``, ``b`` and bool ``valid``, or None, of one length;
    ``id_bound`` a 0-dim int64 tensor or None).  Returns (out_a, out_b,
    count, total).  Under ``profiling.tracing()`` it counts
    ``scan.sort_passes`` and ``scan.sort_spilled`` (read from the chain's
    scratch on the card: no device operation), and on the card
    ``k8.launches``."""
    if a.device.type == "cpu":
        out = pair_sort_plain(a, b, valid, capacity, id_bound)
        profiling.count("scan.sort_passes", out[4])
        profiling.count("scan.sort_spilled", out[5])
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
    # the chain's Info words first (csrc/pairsort.cu), then the pack's
    # status words and the buckets' counts, starts, cursors and status
    # words; the entry point clears it
    scratch = torch.empty(_cuda.pairsort_scratch(n, capacity),
                          dtype=torch.int64, device=dev)
    _cuda.launch("bpt_pairsort", a, b, 0 if valid is None else valid,
                 0 if id_bound is None else id_bound, *keys, out_a, out_b,
                 count, scratch, n, capacity)
    profiling.count("k8.launches", 1)
    profiling.count("scan.sort_passes", scratch[_PASSES])
    profiling.count("scan.sort_spilled", scratch[_SPILLED])
    return out_a, out_b, count, scratch[_TOTAL]
