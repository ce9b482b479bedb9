"""Kernel 2, pass 1 of the scan (``csrc/runends.cu``): descendant-run ends
and the two rule-byte columns, in one pass over the sorted keys.

Replaces ``broadphase_tpu/ops/pallas_runends.py::run_ends`` and the columns
the JAX package computes around it in XLA (``broadphase_tpu/layer.py:913``,
``:928``, ``:946``).  For every lane j of a sorted tree, pads included:

    lca[j]   = adjacent_lca_depth(keys)[j]  (-1 at the last lane)
    dep[j]   = depth_of(keys)[j]
    e[j]     = 1 + min{ i >= j : lca[i] < dep[j] },  0 for dep[j] > axis_bits
    bmeta[j] = ((dep << dim) | (aux & (2^dim - 1))) & 0xFF
    ameta[j] = alpha_meta(keys, dep, aux)[j]

The plain version computes the columns as the JAX package does, with the
per-depth suffix minimum of :func:`run_ends_plain`.  The kernel reads each
key and aux once, takes every clz and ctz in one instruction, and carries
the suffix minimum across tiles by a decoupled look-back over the later
tiles.  Bound by device memory: 24 bytes a lane, 12 without the rule bytes.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import profiling
from ..index import (IndexSpec, _axis_interleave_mask, bit_length, depth_of,
                     tz_pack)
from . import _cuda

_INT32_MAX = 2 ** 31 - 1


def adjacent_lca_depth(spec: IndexSpec, keys: torch.Tensor) -> torch.Tensor:
    """For each adjacent pair of a sorted key array, the depth of the two
    cells' lowest common ancestor: the leading zeros of their XOR, counted
    from the top of the ``key_bits`` field, over dim, clamped to
    ``axis_bits``.  int32 (n,); slot n-1 holds the sentinel -1."""
    x = (keys[:-1] ^ keys[1:]) & ((1 << spec.key_bits) - 1)
    nlz = spec.key_bits - bit_length(x)
    lca = torch.clamp(nlz // spec.dim, max=spec.axis_bits).to(torch.int32)
    return torch.cat([lca, torch.full((1,), -1, dtype=torch.int32,
                                      device=keys.device)])


def alpha_meta(spec: IndexSpec, keys: torch.Tensor, dep: torch.Tensor,
               aux: torch.Tensor) -> torch.Tensor:
    """Per-entry a-side rule byte ``(alpha << dim) | aux`` (int32): alpha is
    the shallowest ancestor depth the cell is aligned to on every axis
    where it is not its object's block minimum
    (``broadphase_tpu.layer._alpha_meta``)."""
    dim = spec.dim
    tz = tz_pack(spec, keys)
    mtz = None
    for k in range(dim):
        tz_k = (tz >> (5 * k)) & 31
        tz_k = torch.where(((aux >> k) & 1) != 0, tz_k, 31)
        mtz = tz_k if mtz is None else torch.minimum(mtz, tz_k)
    alpha = (dep - mtz).clamp(0, 31)
    return ((alpha << dim) | (aux & ((1 << dim) - 1))) & 0xFF


def run_ends_plain(lca: torch.Tensor, depth: torch.Tensor,
                   n_depths: int) -> torch.Tensor:
    """One reverse cumulative minimum per depth level (the JAX package's
    XLA formulation, ``ops/search.py:223-231``)."""
    n = lca.shape[0]
    pos = torch.arange(n, dtype=torch.int32, device=lca.device)
    e = torch.zeros(n, dtype=torch.int32, device=lca.device)
    for dd in range(n_depths):
        q = torch.where(lca < dd, pos, _INT32_MAX)
        nxt = torch.flip(torch.cummin(torch.flip(q, (0,)), 0).values, (0,))
        e = torch.where(depth == dd, nxt + 1, e)
    return e


Pass1 = Tuple[torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor]]


def scan_pass1_plain(spec: IndexSpec, keys: torch.Tensor,
                     aux: Optional[torch.Tensor] = None,
                     rules: bool = True) -> Pass1:
    """(e, ameta, bmeta) of a sorted tree, int32 each; ameta and bmeta are
    None when ``rules`` is False.  ``aux`` None reads as all zero."""
    dep = depth_of(spec, keys)
    e = run_ends_plain(adjacent_lca_depth(spec, keys), dep,
                       spec.axis_bits + 1)
    if not rules:
        return e, None, None
    if aux is None:
        aux = torch.zeros_like(dep)
    bmeta = ((dep << spec.dim) | (aux & ((1 << spec.dim) - 1))) & 0xFF
    return e, alpha_meta(spec, keys, dep, aux), bmeta


def scan_pass1(spec: IndexSpec, keys: torch.Tensor,
               aux: Optional[torch.Tensor] = None,
               rules: bool = True) -> Pass1:
    """:func:`scan_pass1_plain` on CPU tensors; the CUDA kernel on CUDA
    tensors (keys int64, aux int32 or None)."""
    if keys.device.type == "cpu":
        return scan_pass1_plain(spec, keys, aux, rules)
    n = keys.shape[0]
    if (keys.dtype != torch.int64 or keys.dim() != 1
            or (aux is not None and (aux.dtype != torch.int32
                                     or aux.shape != (n,)))):
        raise ValueError("scan_pass1: int64 keys and int32 aux of one "
                         "length expected")
    _cuda.require_cuda("scan_pass1", keys,
                       *([aux] if aux is not None else []))
    dev = keys.device
    e = torch.empty(n, dtype=torch.int32, device=dev)
    ameta = torch.empty_like(e) if rules else None
    bmeta = torch.empty_like(e) if rules else None
    if n == 0:
        return e, ameta, bmeta
    tiles = -(-n // _cuda.runends_tile())
    scratch = torch.empty(33 * tiles + 1, dtype=torch.int32, device=dev)
    masks = [_axis_interleave_mask(spec.dim, spec.axis_bits, k)
             if k < spec.dim else 0 for k in range(3)]
    _cuda.launch("bpt_runends", keys, aux, e, ameta, bmeta, scratch, n,
                 spec.dim, spec.key_bits, spec.axis_bits, spec.depth_bits,
                 *masks, int(rules))
    profiling.count("k2.launches", 1)
    return e, ameta, bmeta
