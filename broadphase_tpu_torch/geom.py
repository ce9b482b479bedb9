"""Quantization, per-object depth and cell emission on torch tensors.

PyTorch counterpart of ``broadphase_tpu/geom.py``.  u32 quantities are held
in int64 tensors; every place where the JAX code relies on u32 wrap-around
masks with ``& 0xFFFF_FFFF``, and shifts are clamped at 31 exactly as
there, so results are bit-identical.

:func:`to_local` is the one floating-point step.  It runs the same f32
operations in the same order (subtract, divide, multiply, clip, NaN to 0,
truncate) and must never be rewritten with a reciprocal or handed to
``torch.compile``: a last-ulp change moves boxes into other cells (the JAX
package recorded 35 phantom pairs at 1M from such a rewrite).  The
queries' replay of the reference's cell halving (:func:`cell_bounds_f32`)
is the other, under the same rule.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .index import IndexSpec, U32_MASK, clz32, encode_axis

RANGE_MAX_U32 = 0xFFFF_FF00
RANGE_MAX_F32 = 4294967040.0


def bounds_overlaps(amin, amax, bmin, bmax) -> torch.Tensor:
    """Inclusive AABB overlap test, per object (``broadphase_tpu.geom``)."""
    return torch.all((amin <= bmax) & (amax >= bmin), dim=-1)


def bounds_contains(amin, amax, bmin, bmax) -> torch.Tensor:
    """a fully contains b, per object (``broadphase_tpu.geom``)."""
    return torch.all((amin <= bmin) & (amax >= bmax), dim=-1)


def bounds_center(bmin, bmax) -> torch.Tensor:
    """cgmath midpoint, ``min + (max - min) * 0.5`` in f32
    (``broadphase_tpu.geom``)."""
    return bmin + (bmax - bmin) * 0.5


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


def to_global(system_min, system_max, pts) -> torch.Tensor:
    """Inverse of :func:`to_local` (``broadphase_tpu.geom``): u32 local
    coordinates (..., dim) in int64 to f32 global points, ``min + local /
    RANGE * size`` in that order of f32 operations."""
    dev = pts.device
    system_min = torch.as_tensor(system_min, dtype=torch.float32, device=dev)
    system_max = torch.as_tensor(system_max, dtype=torch.float32, device=dev)
    size = system_max - system_min
    local = (pts & U32_MASK).to(torch.float32)
    return system_min + local / torch.tensor(
        RANGE_MAX_F32, dtype=torch.float32, device=dev) * size


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


def finite(x: torch.Tensor) -> torch.Tensor:
    """``torch.isfinite`` in two device operations instead of four (NaN
    and both infinities compare false)."""
    return x.abs() < torch.inf


def upload(t, device) -> torch.Tensor:
    """A small host tensor or array on ``device``.  To a CUDA card it goes
    through a pinned staging copy, asynchronously: a copy from pageable
    memory would make the host wait for every operation queued before
    it."""
    t = torch.as_tensor(t)
    device = torch.device(device)
    if device.type != "cuda" or t.device.type != "cpu":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def replay_levels(spec: IndexSpec, replay: torch.Tensor) -> int:
    """Levels a replay must run: the largest replay depth of a valid key
    (depth field at most ``axis_bits``), read on the host; 0 when none."""
    valid = torch.where(replay <= spec.axis_bits, replay, 0)
    return int(valid.max()) if valid.numel() else 0


# Levels of the halving tree that a replay tabulates.  A cell's bounds are
# a function of its depth and the top ``depth`` bits of each coordinate,
# so the halving runs once per tree node (2^d nodes at level d) and each
# element gathers its node's; an element deeper than this goes on element
# by element from its node at this level.
TABLE_LEVELS = 16


def host_f32(x) -> np.ndarray:
    """A query argument as a numpy float32 array on the host."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float32)


def halving_nodes_host(system_min, system_max, levels: int):
    """:func:`halving_nodes` as numpy float32 arrays on the host."""
    lo = host_f32(system_min)[None, :]
    hi = host_f32(system_max)[None, :]
    dim = lo.shape[1]
    half32 = np.float32(0.5)
    los, his = [lo], [hi]
    for _ in range(levels):
        half = (hi - lo) * half32
        center = lo + half
        lo = np.stack([lo, center], axis=1).reshape(-1, dim)
        hi = np.stack([center, hi], axis=1).reshape(-1, dim)
        los.append(lo)
        his.append(hi)
    return np.concatenate(los), np.concatenate(his)


def halving_nodes(system_min, system_max, levels: int, device):
    """The f32 (lo, hi) of every cell of the system box's halving tree down
    to ``levels``: ((2 << levels) - 1, dim) each, on ``device``.  The cell
    of depth d whose coordinate's top d bits are p on an axis is row
    ``(1 << d) - 1 + p`` of that axis's column: a child keeps its parent's
    lo and takes the center as hi on side 0, the reverse on side 1.  The
    table is small and built on the host in numpy (IEEE f32 operations
    give the card's values), which saves the card a launch per
    operation."""
    both = upload(torch.from_numpy(np.stack(halving_nodes_host(
        system_min, system_max, levels))), device)
    return both[0], both[1]


def node_rows(origin: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
    """(N, dim) rows of :func:`halving_nodes` of each element's cell at
    ``depth`` (N,): its top ``depth`` coordinate bits on each axis."""
    d = depth[:, None]
    return (1 << d) - 1 + (origin >> (32 - d))


def cell_bounds_f32(spec: IndexSpec, origin_axes, depth, system_min,
                    system_max, replay_depth=None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 bounds of each element's cell, cut at ``replay_depth``
    (``broadphase_tpu.geom.cell_bounds_f32``).

    The reference's queries halve the system box level by level, which is
    not the same f32 value as interpolating directly, so the halving is
    replayed, driven by each cell's origin bits: on the nodes of the
    halving tree down to :data:`TABLE_LEVELS` (:func:`halving_nodes`,
    gathered per element), then element by element below that.  Both run
    the same f32 operations on the same values.  ``lo + (hi - lo) * 0.5``
    is three separate tensor operations, never a fused multiply-add,
    ``addcmul`` or ``torch.compile``: the rounding decides which cells a
    query hits.  origin_axes: dim (N,) u32 in int64 (top-aligned); depth:
    (N,) integers.  Returns (cell_min, cell_max): (N, dim) f32.

    The halving runs to the deepest replay depth of a valid key (one read
    on the host): the levels below it change no valid key's cell.  Depth
    fields past ``axis_bits`` (pads) stop there too; callers mask them."""
    replay = depth.to(torch.int64)
    if replay_depth is not None:
        replay = replay.clamp(max=int(replay_depth))
    origin = torch.stack(list(origin_axes), dim=-1)            # (N, dim)
    levels = replay_levels(spec, replay)
    cut = min(levels, TABLE_LEVELS)
    lo_t, hi_t = halving_nodes(system_min, system_max, cut, origin.device)
    rows = node_rows(origin, replay.clamp(max=cut))
    lo, hi = torch.gather(lo_t, 0, rows), torch.gather(hi_t, 0, rows)
    for b in range(cut, levels):
        active = (replay > b)[:, None]                         # (N, 1)
        half = (hi - lo) * 0.5
        center = lo + half
        side = ((origin >> (31 - b)) & 1) == 1
        lo = torch.where(active & side, center, lo)
        hi = torch.where(active & ~side, center, hi)
    return lo, hi
