"""Kernel 2: descendant-run ends (``csrc/runends.cu``).

Replaces ``broadphase_tpu/ops/pallas_runends.py::run_ends``:

    e[j] = 1 + min{ i >= j : lca[i] < depth[j] },  0 for depth outside
    [0, n_depths)

a suffix minimum per depth level.  The kernel takes three passes (per-tile
firsts, a suffix minimum over tiles, a per-element pass) and gives every
element bounded work, so one run over the whole tree (a depth-0 object)
costs nothing extra.  Bound by device memory: ~12 bytes per element.
"""

from __future__ import annotations

import torch

from . import _cuda

_INT32_MAX = 2 ** 31 - 1


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


def run_ends(lca: torch.Tensor, depth: torch.Tensor,
             n_depths: int) -> torch.Tensor:
    """:func:`run_ends_plain` on CPU tensors; the CUDA kernel on CUDA
    tensors.  lca/depth: int32 (n,), ``lca[n-1] == -1``."""
    if lca.device.type == "cpu":
        return run_ends_plain(lca, depth, n_depths)
    n = lca.shape[0]
    if (lca.dtype != torch.int32 or depth.dtype != torch.int32
            or depth.shape != (n,) or not 1 <= n_depths <= 32):
        raise ValueError("run_ends: int32 lca/depth of one length and "
                         "1 <= n_depths <= 32 expected")
    _cuda.require_cuda("run_ends", lca, depth)
    tiles = _cuda.scan_tiles(n)
    e = torch.empty(n, dtype=torch.int32, device=lca.device)
    tile_first = torch.empty(tiles * n_depths, dtype=torch.int32,
                             device=lca.device)
    carry = torch.empty_like(tile_first)
    _cuda.launch("bpt_runends", lca, depth, e, tile_first, carry, n,
                 n_depths)
    run_ends.launches += 1
    return e


run_ends.launches = 0
