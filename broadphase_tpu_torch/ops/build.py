"""Kernel 1: fused cell emission for build (``csrc/build.cu``).

Replaces ``broadphase_tpu/ops/pallas_build.py::emit_build``.  One thread per
object computes its depth, truncation, spans and Morton-spread cell keys
(each axis coordinate spread once, by constant stages); a block stages the
valid cells of its contained objects in shared memory and writes them
coalesced at a base found by decoupled look-back (``csrc/scan1.cuh``), so
the output is the plain version's, slot for slot.  Bound by device memory:
~57 bytes read per object and 20 bytes written per cell.  Quantization
stays in torch ahead of the kernel (``geom.to_local``), as the JAX package
keeps it in XLA.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .. import geom, profiling
from ..index import IndexSpec, PAD_KEY
from . import _cuda

PAD_ID = 0xFFFF_FFFF


def emit_build_plain(spec: IndexSpec, lmin: torch.Tensor, lmax: torch.Tensor,
                     contained: torch.Tensor, ids: torch.Tensor,
                     min_depth: int, out_capacity: int,
                     slots_per_axis: int = 2
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                torch.Tensor, torch.Tensor]:
    """Valid cells of contained objects in object-major, x-fastest order.

    lmin/lmax: (N, dim) u32 in int64; contained: (N,) bool; ids: (N,)
    int64.  Returns (keys, ids, aux) of length ``out_capacity`` with pads
    (``PAD_KEY``/``PAD_ID``/0) past ``min(count, out_capacity)``, count (all
    valid cells, may exceed out_capacity) and the cell-overflow flag.
    """
    keys, valid, ovf = geom.emit_cells(spec, lmin, lmax, min_depth,
                                       slots_per_axis)
    valid = valid & contained[:, None]
    n, S = valid.shape
    aux = geom.slot_aux(spec.dim, slots_per_axis, lmin.device)
    flat = valid.reshape(-1)
    cells = (keys.reshape(-1)[flat],
             ids[:, None].expand(n, S).reshape(-1)[flat],
             aux[None, :].expand(n, S).reshape(-1)[flat])
    count = flat.sum(dtype=torch.int64)
    out = []
    for col, fill in zip(cells, (PAD_KEY, PAD_ID, 0)):
        o = torch.full((out_capacity,), fill, dtype=col.dtype,
                       device=lmin.device)
        k = min(col.shape[0], out_capacity)
        o[:k] = col[:k]
        out.append(o)
    return out[0], out[1], out[2], count, torch.any(ovf & contained)


def emit_build(spec: IndexSpec, lmin: torch.Tensor, lmax: torch.Tensor,
               contained: torch.Tensor, ids: torch.Tensor, min_depth: int,
               out_capacity: int, slots_per_axis: int = 2):
    """:func:`emit_build_plain` on CPU tensors; the CUDA kernel on CUDA
    tensors.  Both write the cells in object-major, x-fastest order, so
    when count > out_capacity both keep the same prefix, as the JAX
    package does."""
    if lmin.device.type == "cpu":
        return emit_build_plain(spec, lmin, lmax, contained, ids, min_depth,
                                out_capacity, slots_per_axis)
    n = ids.shape[0]
    if (lmin.dtype != torch.int64 or lmax.dtype != torch.int64
            or lmin.shape != (n, spec.dim) or lmax.shape != (n, spec.dim)
            or ids.dtype != torch.int64 or contained.dtype != torch.bool
            or contained.shape != (n,)):
        raise ValueError("emit_build: lmin/lmax (N, dim) int64, contained "
                         "(N,) bool and ids (N,) int64 expected")
    _cuda.require_cuda("emit_build", lmin, lmax, contained, ids)
    dev = lmin.device
    keys = torch.full((out_capacity,), PAD_KEY, dtype=torch.int64,
                      device=dev)
    out_ids = torch.full((out_capacity,), PAD_ID, dtype=torch.int64,
                         device=dev)
    aux = torch.zeros(out_capacity, dtype=torch.int32, device=dev)
    stats = torch.zeros(2, dtype=torch.int64, device=dev)
    # two status words a tile, then the ticket; the entry point clears them
    scratch = torch.empty(2 * -(-n // _cuda.build_tile()) + 1,
                          dtype=torch.int64, device=dev)
    _cuda.launch("bpt_build", lmin, lmax, contained, ids, stats, scratch,
                 keys, out_ids, aux, n, spec.dim, spec.axis_bits,
                 spec.depth_bits, int(slots_per_axis), int(min_depth),
                 int(out_capacity))
    profiling.count("k1.launches", 1)
    return keys, out_ids, aux, stats[0], stats[1] != 0
