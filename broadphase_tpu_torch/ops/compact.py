"""Kernel 5: ordered stream compaction (``csrc/compact.cu``).

Replaces ``broadphase_tpu/ops/pallas_compact.py::stream_compact``; the
plain version is the counterpart of ``broadphase_tpu/ops/compact.py::
stable_compact``.  The kernel makes one pass over the data, by decoupled
look-back (``csrc/scan1.cuh``), and is bound by device memory: it reads
the keep flags and every column once, and writes every column once.  Its
counts are 32-bit, so it takes fewer than 2^31 lanes.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from .. import profiling
from . import _cuda

PAD_ID = 0xFFFF_FFFF
MAX_COLS = 4
MAX_LANES = 2 ** 31 - 1


def stream_compact_plain(keep: torch.Tensor, cols: Sequence[torch.Tensor],
                         fills: Optional[Sequence[int]] = None
                         ) -> Tuple[Tuple[torch.Tensor, ...], torch.Tensor]:
    """Move the kept lanes of every column to the front, in order; lanes at
    or past the count hold the column's fill.  Returns (cols, count)."""
    fills = (PAD_ID,) * len(cols) if fills is None else tuple(fills)
    count = keep.sum(dtype=torch.int64)
    out = []
    for col, fill in zip(cols, fills):
        kept = col[keep]
        o = torch.full_like(col, fill)
        o[:kept.shape[0]] = kept
        out.append(o)
    return tuple(out), count


def stream_compact(keep: torch.Tensor, cols: Sequence[torch.Tensor],
                   fills: Optional[Sequence[int]] = None
                   ) -> Tuple[Tuple[torch.Tensor, ...], torch.Tensor]:
    """:func:`stream_compact_plain` on a CPU tensor; the CUDA kernel on a
    CUDA tensor (bool keep, 1 to 4 int64 columns of keep's length)."""
    if keep.device.type == "cpu":
        return stream_compact_plain(keep, cols, fills)
    fills = (PAD_ID,) * len(cols) if fills is None else tuple(fills)
    n = keep.shape[0]
    if not 1 <= len(cols) <= MAX_COLS or len(fills) != len(cols):
        raise ValueError(f"stream_compact takes 1 to {MAX_COLS} columns "
                         "and one fill per column")
    if keep.dtype != torch.bool or any(
            c.dtype != torch.int64 or c.shape != (n,) for c in cols):
        raise ValueError("stream_compact: keep must be bool and every "
                         "column int64 of the same length")
    if n > MAX_LANES:
        raise ValueError(f"stream_compact takes at most {MAX_LANES} lanes, "
                         f"got {n}")
    _cuda.require_cuda("stream_compact", keep, *cols)
    outs = [torch.empty_like(c) for c in cols]
    count = torch.empty((), dtype=torch.int64, device=keep.device)
    # one status word a tile, then the ticket; the entry point clears them
    scratch = torch.empty(-(-n // _cuda.compact_tile()) + 1,
                          dtype=torch.int64, device=keep.device)
    pad = MAX_COLS - len(cols)
    ins = list(cols) + [0] * pad
    outs_p = outs + [0] * pad
    fills_p = list(fills) + [0] * pad
    _cuda.launch("bpt_compact", keep, count, *ins, *outs_p, *fills_p,
                 len(cols), n, scratch)
    profiling.count("k5.launches", 1)
    return tuple(outs), count
