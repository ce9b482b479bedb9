"""Packed Morton spatial-index codecs on torch tensors.

PyTorch counterpart of ``broadphase_tpu/index.py``.  The three index types
and their bit layout are the same (depth in the lowest ``depth_bits``, the
Morton-coded origin above it, X lowest); only the key representation
differs:

* every key is one ``torch.int64``.  Valid keys use at most 63 bits
  (``key_bits`` is 32, 63 and 62 for the three specs), so they are
  non-negative and order like the unsigned reference keys;
* the pad key is ``INT64_MAX``.  The JAX pad is all ones, which as int64
  would read as -1 and sort first, so it is mapped at the conversion
  boundary only (:func:`key_from_columns` / :func:`key_to_columns`).

u32 quantities (axis coordinates) are held in int64 tensors with values in
``[0, 2^32)``.  All functions are elementwise and take keys of any shape.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np
import torch

PAD_KEY = (1 << 63) - 1
U32_MASK = 0xFFFF_FFFF


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def _positions_mask(nbits: int, stride: int, granularity: int) -> int:
    """Bit positions of the nbits source bits when separated at
    ``granularity`` (see ``broadphase_tpu.index._positions_mask``)."""
    mask = 0
    for i in range(nbits):
        mask |= 1 << ((i // granularity) * granularity * stride
                      + (i % granularity))
    return mask


def _spread_stages(nbits: int, stride: int) -> List[Tuple[int, int]]:
    stages = []
    c = _next_pow2(nbits) >> 1
    while c >= 1:
        stages.append((c * (stride - 1), _positions_mask(nbits, stride, c)))
        c >>= 1
    return stages


def _compress_stages(nbits: int, stride: int) -> List[Tuple[int, int]]:
    stages = []
    c = 1
    top = _next_pow2(nbits)
    while c < top:
        stages.append((c * (stride - 1),
                       _positions_mask(nbits, stride, 2 * c)))
        c <<= 1
    return stages


@dataclasses.dataclass(frozen=True)
class IndexSpec:
    """Static description of one packed spatial-index type (same fields and
    derived constants as ``broadphase_tpu.index.IndexSpec``)."""

    name: str
    dim: int
    bits: int
    depth_bits: int
    axis_bits: int

    @property
    def origin_bits(self) -> int:
        return self.dim * self.axis_bits

    @property
    def origin_shift(self) -> int:
        return self.depth_bits

    @property
    def key_bits(self) -> int:
        return self.origin_bits + self.origin_shift

    @property
    def depth_mask(self) -> int:
        return (1 << self.depth_bits) - 1

    @property
    def origin_mask(self) -> int:
        return ((1 << self.origin_bits) - 1) << self.origin_shift

    @property
    def fanout(self) -> int:
        return 1 << self.dim

    @property
    def spread_stages(self) -> List[Tuple[int, int]]:
        return _spread_stages(self.axis_bits, self.dim)

    @property
    def compress_stages(self) -> List[Tuple[int, int]]:
        return _compress_stages(self.axis_bits, self.dim)


Index32_2D = IndexSpec("Index32_2D", dim=2, bits=32, depth_bits=4,
                       axis_bits=14)
Index64_2D = IndexSpec("Index64_2D", dim=2, bits=64, depth_bits=5,
                       axis_bits=29)
Index64_3D = IndexSpec("Index64_3D", dim=3, bits=64, depth_bits=5,
                       axis_bits=19)

ALL_SPECS = (Index32_2D, Index64_2D, Index64_3D)


def _i64(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.int64, device=device)


def bit_length(x: torch.Tensor) -> torch.Tensor:
    """Number of significant bits of each non-negative int64 (0 for 0):
    an exact branch-free binary search (torch has no clz)."""
    x = x.clone()
    n = torch.zeros_like(x)
    for s in (32, 16, 8, 4, 2, 1):
        y = x >> s
        hit = y != 0
        n = n + torch.where(hit, s, 0)
        x = torch.where(hit, y, x)
    return n + (x != 0).to(torch.int64)


def clz32(v: torch.Tensor) -> torch.Tensor:
    """Leading zeros of u32 values held in int64 (32 for 0)."""
    return 32 - bit_length(v & U32_MASK)


def ctz64(x: torch.Tensor) -> torch.Tensor:
    """Trailing zeros of non-negative int64 values (64 for 0)."""
    lsb = x & (-x)
    return torch.where(x == 0, 64, bit_length(lsb) - 1)


def mask_below(s: torch.Tensor) -> torch.Tensor:
    """``(1 << s) - 1`` for s in [0, 63] without int64 overflow."""
    s = s.clamp(0, 63)
    low = (torch.ones_like(s) << s.clamp(max=62)) - 1
    return torch.where(s >= 63, PAD_KEY, low)


# ---------------------------------------------------------------------------
# Codec ops
# ---------------------------------------------------------------------------

def encode_axis(spec: IndexSpec, origin: torch.Tensor) -> torch.Tensor:
    """Spread the top ``axis_bits`` of a u32 axis coordinate to stride-``dim``
    bit positions (``broadphase_tpu.index.encode_axis``)."""
    x = (_i64(origin) & U32_MASK) >> (32 - spec.axis_bits)
    for shift, mask in spec.spread_stages:
        x = (x | (x << shift)) & mask
    return x


def decode_axis(spec: IndexSpec, spread: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`encode_axis`: the top-aligned u32 axis coordinate."""
    x = _i64(spread) & _positions_mask(spec.axis_bits, spec.dim, 1)
    for shift, mask in spec.compress_stages:
        x = (x | (x >> shift)) & mask
    return (x << (32 - spec.axis_bits)) & U32_MASK


def make_key(spec: IndexSpec, origin: Sequence[torch.Tensor],
             depth) -> torch.Tensor:
    """Pack per-axis u32 coordinates (already truncated to ``depth``) and
    the depth into keys."""
    assert len(origin) == spec.dim
    morton = encode_axis(spec, origin[0])
    for axis in range(1, spec.dim):
        morton = morton | (encode_axis(spec, origin[axis]) << axis)
    depth = _i64(depth, morton.device)
    return (morton << spec.origin_shift) | depth.clamp(max=spec.axis_bits)


def depth_of(spec: IndexSpec, key: torch.Tensor) -> torch.Tensor:
    """Depth field of each key, as int32 (pad keys read as depth_mask)."""
    return (key & spec.depth_mask).to(torch.int32)


def origin_of(spec: IndexSpec, key: torch.Tensor
              ) -> Tuple[torch.Tensor, ...]:
    """The top-aligned u32 coordinate of each axis: :func:`decode_axis` of
    every axis at once, on a leading axis of ``dim`` (one pass of the
    compress stages instead of one per axis)."""
    morton = (key & spec.origin_mask) >> spec.origin_shift
    axes = torch.arange(spec.dim, device=key.device).reshape(
        (spec.dim,) + (1,) * key.dim())
    return tuple(decode_axis(spec, morton[None] >> axes).unbind(0))


def level_mask(spec: IndexSpec, depth) -> torch.Tensor:
    """Mask of the key bits meaningful at ``depth``: bits
    ``[key_bits - dim*depth, key_bits)``; depth 0 gives an empty mask."""
    depth = _i64(depth)
    below = spec.key_bits - spec.dim * depth
    full = (1 << spec.key_bits) - 1
    return full & ~mask_below(below)


def descendant_max(spec: IndexSpec, key: torch.Tensor) -> torch.Tensor:
    """Largest key of any descendant-or-equal cell of ``key``."""
    below = spec.key_bits - spec.dim * (key & spec.depth_mask)
    return key | torch.where(below < 0, PAD_KEY, mask_below(below))


def clamp_depth(spec: IndexSpec, depth) -> torch.Tensor:
    """Depths clamped to ``axis_bits``, as int64."""
    return _i64(depth).clamp(max=spec.axis_bits)


def set_depth(spec: IndexSpec, key: torch.Tensor, depth) -> torch.Tensor:
    """``key`` with its depth field replaced by ``min(depth, axis_bits)``."""
    return (key & ~spec.depth_mask) | clamp_depth(spec, depth).to(key.device)


def same_cell_at_depth(spec: IndexSpec, a: torch.Tensor, b: torch.Tensor,
                       depth) -> torch.Tensor:
    """Whether the cells of ``a`` and ``b`` agree on the origin bits
    meaningful at ``depth``."""
    return ((a ^ b) & level_mask(spec, depth).to(a.device)) == 0


def overlaps(spec: IndexSpec, a: torch.Tensor, b: torch.Tensor
             ) -> torch.Tensor:
    """Two cells overlap iff one is an ancestor-or-equal of the other
    (reference ``src/index.rs:116-122``)."""
    d = torch.minimum(depth_of(spec, a), depth_of(spec, b))
    return same_cell_at_depth(spec, a, b, d)


def subdivide(spec: IndexSpec, key: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Children of each cell in sorted order, on a new leading axis of
    ``2**dim``, and whether the cell is above the depth limit (reference
    ``src/index.rs:251-290``).  The child bits sit ``key_bits - dim *
    (depth + 1)`` bits up.  Where that is negative (a depth field past
    ``axis_bits``: a pad) the JAX package's u32 shift wraps and its shift
    gives 0; here the shift is clamped and those bits masked, which gives
    the same keys."""
    depth = key & spec.depth_mask
    shift = (spec.key_bits - spec.dim) - spec.dim * depth
    kids = torch.arange(spec.fanout, device=key.device).reshape(
        (spec.fanout,) + (1,) * key.dim())
    bits = torch.where(shift >= 0, kids << shift.clamp(min=0), 0)
    children = ((key | bits) & ~spec.depth_mask) | (depth + 1).clamp(
        max=spec.axis_bits)
    return children, depth < spec.axis_bits


def subdivide_at(spec: IndexSpec, key: torch.Tensor, depth: int
                 ) -> torch.Tensor:
    """:func:`subdivide`'s children of cells whose depth ``depth`` is known
    on the host and below ``axis_bits``: the same keys in fewer
    operations, for the tree walks, whose frontier or stack knows each
    cell's depth.  (2**dim, ...) keys."""
    kids = torch.arange(spec.fanout, device=key.device).reshape(
        (spec.fanout,) + (1,) * key.dim())
    base = (key & ~spec.depth_mask) | (depth + 1)
    return base | (kids << (spec.key_bits - spec.dim * (depth + 1)))


def _axis_interleave_mask(dim: int, axis_bits: int, axis: int) -> int:
    m = 0
    for j in range(axis_bits):
        m |= 1 << (j * dim + axis)
    return m


def tz_pack(spec: IndexSpec, key: torch.Tensor) -> torch.Tensor:
    """Per-axis trailing-zero counts of each cell's coordinate in depth
    units, clamped to 31 and packed in 5-bit fields (axis k at bits 5k),
    as int32 (``broadphase_tpu.index.tz_pack``).  Pad keys yield garbage
    that callers mask."""
    d = key & spec.depth_mask
    morton = (key & spec.origin_mask) >> spec.origin_shift
    out = torch.zeros_like(key)
    for k in range(spec.dim):
        m = morton & _axis_interleave_mask(spec.dim, spec.axis_bits, k)
        j = torch.div(ctz64(m) - k, spec.dim, rounding_mode="floor")
        tz = j - (spec.axis_bits - d)
        tz = torch.where(m != 0, tz.clamp(0, 31), 31)
        out = out | (tz << (5 * k))
    return out.to(torch.int32)


# ---------------------------------------------------------------------------
# Conversion boundary: the JAX package's u32 key columns <-> int64 keys
# ---------------------------------------------------------------------------

def key_from_columns(spec: IndexSpec, cols: Sequence[np.ndarray],
                     device=None) -> torch.Tensor:
    """int64 keys from the JAX package's u32 sort operands (``(hi, lo)`` for
    64-bit specs, ``(key,)`` for Index32_2D); all-ones pads become
    ``PAD_KEY``."""
    if spec.bits == 32:
        (k,) = cols
        wide = np.asarray(k, np.uint32).astype(np.uint64)
        pad = wide == np.uint64(U32_MASK)
    else:
        hi, lo = cols
        wide = ((np.asarray(hi, np.uint32).astype(np.uint64) << np.uint64(32))
                | np.asarray(lo, np.uint32).astype(np.uint64))
        pad = wide == np.uint64((1 << 64) - 1)
    wide = np.where(pad, np.uint64(PAD_KEY), wide)
    return torch.as_tensor(wide.astype(np.int64), device=device)


def key_to_columns(spec: IndexSpec, key: torch.Tensor
                   ) -> Tuple[np.ndarray, ...]:
    """Inverse of :func:`key_from_columns`."""
    k = key.detach().cpu().numpy().astype(np.int64)
    pad = k == PAD_KEY
    if spec.bits == 32:
        return (np.where(pad, U32_MASK, k).astype(np.uint32),)
    u = k.astype(np.uint64)
    hi = np.where(pad, U32_MASK, u >> np.uint64(32)).astype(np.uint32)
    lo = np.where(pad, U32_MASK, u & np.uint64(U32_MASK)).astype(np.uint32)
    return hi, lo


def keys_to_numpy(spec: IndexSpec, key: torch.Tensor) -> np.ndarray:
    """Keys as the JAX package's host view: uint64 (uint32 for
    Index32_2D), pads all ones."""
    cols = key_to_columns(spec, key)
    if spec.bits == 32:
        return cols[0]
    return ((cols[0].astype(np.uint64) << np.uint64(32))
            | cols[1].astype(np.uint64))


def keys_from_numpy(spec: IndexSpec, arr, device=None) -> torch.Tensor:
    """Inverse of :func:`keys_to_numpy` (``broadphase_tpu.index.
    keys_from_numpy``): int64 keys on ``device`` from uint64 (uint32 for
    Index32_2D) values; all-ones pads become ``PAD_KEY``."""
    if spec.bits == 32:
        return key_from_columns(spec, (np.asarray(arr, np.uint32),), device)
    arr = np.asarray(arr, np.uint64)
    return key_from_columns(spec, ((arr >> np.uint64(32)).astype(np.uint32),
                                   (arr & np.uint64(U32_MASK)).astype(
                                       np.uint32)), device)


# ---------------------------------------------------------------------------
# Debug formatters (reference impl Debug, src/index.rs:297-335)
# ---------------------------------------------------------------------------

def format_key(spec: IndexSpec, key_value: int) -> str:
    """One packed key as text: per-axis origin in octal and the depth, e.g.
    ``Index64_3D{origin: (0o0017..., 0o0044..., 0o0021...), depth: 5}``
    (``broadphase_tpu.index.format_key``)."""
    depth = key_value & spec.depth_mask
    morton = (key_value & spec.origin_mask) >> spec.origin_shift
    axes = []
    for axis in range(spec.dim):
        v = 0
        for i in range(spec.axis_bits):
            if (morton >> (spec.dim * i + axis)) & 1:
                v |= 1 << i
        v <<= 32 - spec.axis_bits
        axes.append(f"0o{v:011o}")
    return f"{spec.name}{{origin: ({', '.join(axes)}), depth: {depth}}}"


def format_keys(spec: IndexSpec, keys) -> List[str]:
    """:func:`format_key` of each key of an int64 tensor (read through
    :func:`keys_to_numpy`, so a pad reads as all ones) or of a numpy array
    of the host view."""
    if isinstance(keys, torch.Tensor):
        keys = keys_to_numpy(spec, keys)
    return [format_key(spec, int(k)) for k in np.asarray(keys)]
