"""Quantization, per-object depth and cell emission on torch tensors.

PyTorch counterpart of ``broadphase_tpu/geom.py``.  u32 quantities are held
in int64 tensors; every place where the JAX code relies on u32 wrap-around
masks with ``& 0xFFFF_FFFF``, and shifts are clamped at 31 exactly as
there, so results are bit-identical.

:func:`to_local` is the one floating-point step.  It runs the same f32
operations in the same order (subtract, divide, multiply, clip, NaN to 0,
truncate) and must never be rewritten with a reciprocal or handed to
``torch.compile``: a last-ulp change moves boxes into other cells (the JAX
package recorded 35 phantom pairs at 1M from such a rewrite).
"""

from __future__ import annotations

from typing import Tuple

import torch

from .index import IndexSpec, U32_MASK, clz32, encode_axis

RANGE_MAX_U32 = 0xFFFF_FF00
RANGE_MAX_F32 = 4294967040.0


def bounds_contains(amin, amax, bmin, bmax) -> torch.Tensor:
    """a fully contains b, per object (``broadphase_tpu.geom``)."""
    return torch.all((amin <= bmin) & (amax >= bmax), dim=-1)


def to_local(system_min, system_max, pts) -> torch.Tensor:
    """Quantize f32 points (..., dim) to u32 local coordinates (int64)."""
    system_min = torch.as_tensor(system_min, dtype=torch.float32,
                                 device=pts.device)
    system_max = torch.as_tensor(system_max, dtype=torch.float32,
                                 device=pts.device)
    pts = pts.to(torch.float32)
    size = system_max - system_min
    ratio = (pts - system_min) / size
    v = ratio * torch.tensor(RANGE_MAX_F32, dtype=torch.float32,
                             device=pts.device)
    v = v.clamp(0.0, RANGE_MAX_F32)
    v = torch.where(torch.isnan(v), torch.zeros_like(v), v)
    return v.to(torch.int64)


def truncate_to_depth(x: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
    """Mask off the bits below the cell scale; depth 0 is the identity."""
    low_bits = 32 - depth
    mask = torch.where(low_bits >= 32, U32_MASK,
                       (1 << low_bits.clamp(max=31)) - 1)
    return torch.where(depth == 0, x, x & ~mask & U32_MASK)


def depth_for_bounds(spec: IndexSpec, lmin: torch.Tensor,
                     lmax: torch.Tensor, min_depth) -> torch.Tensor:
    """Per-object cell depth from (..., dim) u32 bounds, as int64."""
    sizei = (lmax - lmin + 1) & U32_MASK
    v = (sizei.amax(dim=-1) - 1) & U32_MASK
    depth = torch.clamp(clz32(v), min=int(min_depth))
    return depth.clamp(max=spec.axis_bits)


def slot_aux(dim: int, slots_per_axis: int, device=None) -> torch.Tensor:
    """(S,) int32 block-offset bits per grid-walk slot: bit k set iff the
    slot is not the object's minimum cell along axis k."""
    A = int(slots_per_axis)
    s = torch.arange(A ** dim, dtype=torch.int64, device=device)
    aux = torch.zeros_like(s)
    for k in range(dim):
        aux |= (((s // A ** k) % A) > 0).to(torch.int64) << k
    return aux.to(torch.int32)


def emit_cells(spec: IndexSpec, lmin: torch.Tensor, lmax: torch.Tensor,
               min_depth, slots_per_axis: int = 2
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Up to ``slots_per_axis ** dim`` covering cells per object, x-fastest.

    lmin/lmax: (N, dim) u32 bounds in int64.  Returns (keys (N, S) int64,
    valid (N, S) bool, overflow (N,) bool).  This is the plain version of
    the build kernel (``ops/build.py``).
    """
    A = int(slots_per_axis)
    dim = spec.dim
    depth = depth_for_bounds(spec, lmin, lmax, min_depth)          # (N,)
    tmin = truncate_to_depth(lmin, depth[:, None])
    tmax = truncate_to_depth(lmax, depth[:, None])

    shift = (32 - depth).clamp(max=31)
    span = ((tmax - tmin) & U32_MASK) >> shift[:, None]
    naxis = torch.where(depth[:, None] == 0, 1, span + 1)          # (N, dim)
    overflow = torch.any(naxis > A, dim=-1)
    step = torch.where(depth == 0, 0, 1 << shift)

    S = A ** dim
    slot = torch.arange(S, dtype=torch.int64, device=lmin.device)
    axis_slot = torch.stack([(slot // A ** k) % A for k in range(dim)],
                            dim=-1)                                # (S, dim)
    valid = torch.all(axis_slot[None] < naxis[:, None, :], dim=-1)

    a_idx = torch.arange(A, dtype=torch.int64, device=lmin.device)
    spread = []
    for axis in range(dim):
        pvals = (tmin[:, axis:axis + 1] + a_idx[None] * step[:, None]) \
            & U32_MASK
        spread.append(encode_axis(spec, pvals) << axis)             # (N, A)
    morton = torch.zeros(lmin.shape[0], S, dtype=torch.int64,
                         device=lmin.device)
    for axis in range(dim):
        morton = morton | spread[axis][:, axis_slot[:, axis]]
    keys = (morton << spec.origin_shift) | depth[:, None]
    # depth 0 emits the single whole-system cell, key 0
    keys = torch.where(depth[:, None] == 0, 0, keys)
    return keys, valid, overflow
