"""Searches over sorted device arrays, and the descendant-run structure of a
sorted tree (``broadphase_tpu/ops/search.py`` on torch tensors).

The bound searches (:func:`lower_bound_keys`, :func:`upper_bound_keys`,
their bracketed forms, :func:`upper_bound_i32`, :func:`merged_upper_bound`)
are ``torch.searchsorted``.  The JAX package runs them as plain XLA loops
(no Pallas kernel computes them), and the port's keys are one int64 column
whose pads (``INT64_MAX``) sort last, so signed order is key order and the
library search computes the same function.  Positions are int64.  One
value differs: in ``Index64_2D`` (``key_bits`` 63) the root cell's
``descendant_max`` is ``INT64_MAX``, the pad, so its upper bound counts
the pads; the JAX pad (all ones) sorts above it.  Every caller clamps an
upper bound by the layer's count, where the two agree.

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


def lower_bound_keys(spec: IndexSpec, keys: torch.Tensor,
                     queries: torch.Tensor) -> torch.Tensor:
    """For each query key q: the number of keys of the sorted ``keys``
    below q (the first index of q's run), for queries of any shape."""
    del spec
    return torch.searchsorted(keys, queries.contiguous(), right=False)


def upper_bound_keys(spec: IndexSpec, keys: torch.Tensor,
                     queries: torch.Tensor) -> torch.Tensor:
    """For each query key q: the number of keys at or below q (the
    exclusive end of q's run)."""
    del spec
    return torch.searchsorted(keys, queries.contiguous(), right=True)


def _bracket(bound: torch.Tensor, lo, hi) -> torch.Tensor:
    """What the JAX package's bracketed binary search returns over a
    sorted array: the global bound clamped into [lo, hi], and lo where
    the bracket is inverted (its loop never runs)."""
    b = torch.minimum(bound, hi) if isinstance(hi, torch.Tensor) \
        else bound.clamp(max=int(hi))
    return torch.maximum(b, lo) if isinstance(lo, torch.Tensor) \
        else b.clamp(min=int(lo))


def lower_bound_keys_bracketed(spec: IndexSpec, keys: torch.Tensor,
                               queries: torch.Tensor, lo, hi
                               ) -> torch.Tensor:
    """:func:`lower_bound_keys` given per-query brackets [lo, hi].  The
    JAX package runs a data-dependent loop that stops when every bracket
    closes; on a sorted tree it returns the clamped global bound, which
    is one search here, with no loop and no read on the host."""
    return _bracket(lower_bound_keys(spec, keys, queries), lo, hi)


def upper_bound_keys_bracketed(spec: IndexSpec, keys: torch.Tensor,
                               queries: torch.Tensor, lo, hi
                               ) -> torch.Tensor:
    """:func:`upper_bound_keys` given per-query brackets [lo, hi]."""
    return _bracket(upper_bound_keys(spec, keys, queries), lo, hi)


def upper_bound_i32(sorted_vals: torch.Tensor, queries: torch.Tensor
                    ) -> torch.Tensor:
    """Number of elements of the sorted ``sorted_vals`` at or below each
    query."""
    return torch.searchsorted(sorted_vals, queries.contiguous(), right=True)


def merged_upper_bound(spec: IndexSpec, keys: torch.Tensor,
                       queries: torch.Tensor) -> torch.Tensor:
    """For every query q: the number of keys of the sorted ``keys`` at or
    below q, in query order.  The JAX package sorts the keys and queries
    together because a gather is slow on its chip; the answer is the
    upper bound."""
    return upper_bound_keys(spec, keys, queries)


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
