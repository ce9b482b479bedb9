"""Kernel 3: run lengths, their prefix sum and the nonempty-run compaction
(``csrc/prep.cu``).

Replaces ``broadphase_tpu/ops/pallas_prep.py::prep_runs``.  From the run
ends ``e`` and the live count:

    run[j] = max(min(e[j], count) - j - 1, 0)       for j < count
    starts = exclusive prefix sum of run            (int64, no wrap)

and the nonempty runs, in order, become entries (sv = start,
ab = j + 1 - start, bid = ids[j], bmeta = meta[j]).  The b-side rule byte
rides in its own column instead of being packed into the id.  ``wrapped``
is set exactly when the JAX package's int32 prefix sum would wrap
(total >= 2^31).  With ``meta=None`` (the v2 scan, whose expansion has no
rule) there is no bmeta column: the kernel's other instantiation neither
reads nor writes one, and None stands in its place.  Bound by device
memory; one launch after one memset, by the wide decoupled look-back of
``csrc/scan1.cuh``.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import profiling
from . import _cuda

HUGE = 0x7FFF_FFFF
PAD_ID = 0xFFFF_FFFF


def _count_tensor(count, device) -> torch.Tensor:
    return torch.as_tensor(count, dtype=torch.int64, device=device).reshape(())


def prep_runs_plain(e: torch.Tensor, ids: torch.Tensor,
                    meta: Optional[torch.Tensor], count):
    """Returns (sv, ab, bid, bmeta, m, total, wrapped); sv/ab/bid int64 and
    bmeta int32 of e's length, filled with 0x7FFF_FFFF / 0 / PAD / 0 past
    m (bmeta None when meta is None); m and total int64 scalars, wrapped a
    bool scalar."""
    cap = e.shape[0]
    count = _count_tensor(count, e.device)
    pos = torch.arange(cap, dtype=torch.int64, device=e.device)
    em = torch.minimum(e.to(torch.int64), count)
    run = torch.where(pos < count, (em - pos - 1).clamp(min=0), 0)
    starts = torch.cumsum(run, 0) - run
    nz = run > 0
    m = nz.sum(dtype=torch.int64)
    total = run.sum()
    k = int(m)
    sv = torch.full((cap,), HUGE, dtype=torch.int64, device=e.device)
    ab = torch.zeros(cap, dtype=torch.int64, device=e.device)
    bid = torch.full((cap,), PAD_ID, dtype=torch.int64, device=e.device)
    sv[:k] = starts[nz]
    ab[:k] = pos[nz] + 1 - starts[nz]
    bid[:k] = ids[nz]
    bmeta = None
    if meta is not None:
        bmeta = torch.zeros(cap, dtype=torch.int32, device=e.device)
        bmeta[:k] = meta[nz]
    return sv, ab, bid, bmeta, m, total, total >= 2 ** 31


def prep_runs(e: torch.Tensor, ids: torch.Tensor,
              meta: Optional[torch.Tensor], count):
    """:func:`prep_runs_plain` on CPU tensors; the CUDA kernel on CUDA
    tensors (e and meta int32, or meta None; ids int64; count an int64
    scalar on the card)."""
    if e.device.type == "cpu":
        return prep_runs_plain(e, ids, meta, count)
    cap = e.shape[0]
    if (e.dtype != torch.int32 or ids.dtype != torch.int64
            or ids.shape != (cap,)
            or (meta is not None and (meta.dtype != torch.int32
                                      or meta.shape != (cap,)))):
        raise ValueError("prep_runs: int32 e/meta and int64 ids of one "
                         "length expected")
    count = _count_tensor(count, e.device)
    _cuda.require_cuda("prep_runs", e, ids, count,
                       *([meta] if meta is not None else []))
    dev = e.device
    sv = torch.empty(cap, dtype=torch.int64, device=dev)
    ab = torch.empty_like(sv)
    bid = torch.empty_like(sv)
    bmeta = None if meta is None else torch.empty(cap, dtype=torch.int32,
                                                  device=dev)
    stats = torch.empty(3, dtype=torch.int64, device=dev)
    # two status words a tile, then the ticket
    scratch = torch.empty(2 * -(-cap // _cuda.prep_tile()) + 1,
                          dtype=torch.int64, device=dev)
    _cuda.launch("bpt_prep", e, ids, meta, count, sv, ab, bid, bmeta, stats,
                 scratch, cap)
    profiling.count("k3.launches", 1)
    return sv, ab, bid, bmeta, stats[0], stats[1], stats[2] != 0
