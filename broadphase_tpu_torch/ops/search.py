"""Descendant-run structure of a sorted tree (``broadphase_tpu/ops/search.py``
:155-278 on torch tensors).

:func:`descendant_run_ends` takes the run ends from pass 1 of the scan (the
run-ends kernel, ``ops/runends.py``).  :func:`expand_runs` and
:func:`segmented_broadcast` are the XLA-path formulations of the JAX
package, kept as the reference the expansion kernel's plain version is
written with.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..index import IndexSpec
from .runends import scan_pass1


def descendant_run_ends(spec: IndexSpec, keys: torch.Tensor) -> torch.Tensor:
    """Exclusive end of every element's descendant-or-equal run over a
    sorted tree; pads (depth > axis_bits) get 0.  int32 (n,)."""
    return scan_pass1(spec, keys, rules=False)[0]


def expand_runs(starts: torch.Tensor, pair_capacity: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """For each slot t < pair_capacity: the index j(t) of the run holding t
    (``#starts <= t`` - 1) and the offset ``t - starts[j(t)]``, from a
    sorted exclusive prefix sum ``starts`` (histogram + cumsum)."""
    P = pair_capacity
    dev = starts.device
    t = torch.arange(P, dtype=torch.int64, device=dev)
    s = starts.to(torch.int64)
    s = s[(s >= 0) & (s < P)]
    hist = torch.zeros(P, dtype=torch.int64, device=dev)
    hist.index_add_(0, s, torch.ones_like(s))
    j_of_t = torch.cumsum(hist, 0) - 1
    smax = torch.zeros(P, dtype=torch.int64, device=dev)
    smax.scatter_reduce_(0, s, s, reduce="amax")
    start_of_t = torch.cummax(smax, 0).values
    return j_of_t, t - start_of_t


def segmented_broadcast(starts: torch.Tensor, run: torch.Tensor,
                        values: torch.Tensor, out_size: int) -> torch.Tensor:
    """out[t] = values[j(t)]: each nonempty run's value spread over its
    slots (0 before the first run)."""
    P = out_size
    dev = values.device
    s = starts.to(torch.int64)
    put = (run > 0) & (s >= 0) & (s < P)
    vals = torch.zeros(P, dtype=values.dtype, device=dev)
    vals[s[put]] = values[put]
    seen = torch.zeros(P, dtype=torch.bool, device=dev)
    seen[s[put]] = True
    pos = torch.arange(P, dtype=torch.int64, device=dev)
    src = torch.cummax(torch.where(seen, pos, -1), 0).values
    return torch.where(src >= 0, vals[src.clamp(min=0)],
                       torch.zeros_like(vals))
