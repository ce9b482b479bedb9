"""Sharded broadphase step over a ``torch.distributed`` process group.

PyTorch counterpart of ``broadphase_tpu/parallel/scan.py``.  Each rank is
one process; it holds its object shard (the contiguous block
``[r * n / D, (r + 1) * n / D)`` of the objects, as ``shard_map``'s
``P(axis)`` splits them, :func:`object_shard`) and, after the routing, its
fragment of the sorted tree.  The split rule is the JAX package's:

* a key's top ``B = ceil(log2 D)`` significant bits select its owner rank
  (a contiguous Morton key range per rank, clamped to ``D - 1``);
* with ``min_depth * dim >= B`` (:func:`min_depth_for_devices`) every cell
  of one ``min_depth`` cell lies on one rank, so no candidate pair and no
  ancestor chain spans two ranks.

The step per rank: local cell emission (kernel 1, ``ops/build.py``), the
narrow-id gate reduced by MAX over the group, one routing sort by (key,
``(id << dim) | aux``), bucket rows cut at the bucket boundaries, ONE
``all_to_all_single`` of the packed (key, id, aux) rows, the local sort,
the per-fragment scan (kernels 2 to 4 and 8, ``layer.scan_pairs``) and
the dedup exchange: every pair goes to the rank owning the Fibonacci hash
of its first id, so the copies of a pair that two ranks emitted meet on
one rank and the canonical sort + dedup (kernel 8) removes them.  The counts
and flags of all ranks travel in one ``all_gather``.

The JAX collectives map one to one: ``all_to_all`` to
``all_to_all_single`` on the ``(D * row_cap, k)`` row block, ``psum`` and
``pmax`` to the gathered stats row (one ``all_gather`` in place of
several reductions), ``axis_index`` to ``dist.get_rank(group)``.

Entry points run on ``cuda:{rank % device_count}`` unless given
``device`` or tensors on another device (``device="cpu"`` and a gloo
group run on the CPU); without a card they raise, as the single-chip
entry points do.  Capacities are per rank, as in the JAX package.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..index import IndexSpec, PAD_KEY
from ..layer import (PAD_ID, _NARROW_ID_BOUND, _objects, canonical_pairs,
                     resolve_device, scan_pairs)
from ..ops.build import emit_build

_FIB = 0x9E3779B1        # the dedup exchange's Fibonacci hash multiplier
_U32 = 0xFFFF_FFFF


class ShardedScanResult(NamedTuple):
    """One rank's share of a sharded scan: its hash-owned class of the
    deduplicated pairs, sorted, and the totals, replicated on every
    rank."""

    pairs_a: torch.Tensor       # (D * xcap,) int64, PAD_ID past the count
    pairs_b: torch.Tensor       # (D * xcap,) int64
    shard_counts: torch.Tensor  # (D,) int64 pairs in each rank's class
    total_count: torch.Tensor   # () int64 exact global deduped pair count
    invalid_count: torch.Tensor  # () int64 objects outside the system box
    overflow: torch.Tensor      # () bool any buffer overflow on any rank


def min_depth_for_devices(spec: IndexSpec, n_devices: int) -> int:
    """Smallest min_depth such that no pair spans a rank's key-range cut."""
    if n_devices <= 1:
        return 0
    bits = (n_devices - 1).bit_length()  # ceil(log2 n)
    return -(-bits // spec.dim)          # ceil(bits / dim)


def world(group=None) -> tuple:
    """(rank, number of ranks) of this process in ``group``."""
    return dist.get_rank(group), dist.get_world_size(group)


def rank_device(device, group, *inputs) -> torch.device:
    """The device a rank's entry point runs on: ``device`` when given, else
    the device of the first tensor among ``inputs``, else
    ``cuda:{rank % device_count}``.  Raises when that is a CUDA device and
    no card is present (``layer.resolve_device``)."""
    if device is None and not any(isinstance(x, torch.Tensor)
                                  for x in inputs):
        n_cards = torch.cuda.device_count()
        device = (f"cuda:{dist.get_rank(group) % n_cards}" if n_cards
                  else "cuda")
    return resolve_device(device, *inputs)


def object_shard(x, group=None):
    """This rank's block ``[r * n / D, (r + 1) * n / D)`` of a globally
    shaped per-object array (the object count must divide by D, as
    ``shard_map`` requires)."""
    rank, n_dev = world(group)
    n = x.shape[0]
    if n % n_dev:
        raise ValueError(f"{n} objects do not split over {n_dev} ranks")
    step = n // n_dev
    return x[rank * step:(rank + 1) * step]


def exchange(rows: torch.Tensor, group=None) -> torch.Tensor:
    """``all_to_all`` of (D, row_cap, k) rows: row d goes to rank d, and
    row s of the result is what rank s sent here.  ``exchange.bytes``
    counts the bytes this rank sends."""
    rows = rows.contiguous()
    out = torch.empty_like(rows)
    dist.all_to_all_single(out, rows, group=group)
    exchange.bytes += rows.numel() * rows.element_size()
    return out


exchange.bytes = 0


def all_gather_rows(x: torch.Tensor, group=None) -> torch.Tensor:
    """(D,) + x.shape: every rank's ``x``, in rank order (``all_gather``,
    list form); ``all_gather_rows.bytes`` counts the bytes this rank
    sends."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    all_gather_rows.bytes += x.numel() * x.element_size()
    return torch.stack(parts)


all_gather_rows.bytes = 0


def gather_stats(values: Sequence[torch.Tensor], group=None) -> torch.Tensor:
    """(D, k) int64: the k scalars of every rank, in one ``all_gather``
    (the counts a rank reports, and its sums and flags to reduce)."""
    return all_gather_rows(torch.stack(
        [torch.as_tensor(v).to(torch.int64).reshape(()) for v in values]),
        group)


def make_bucket_of(spec: IndexSpec, n_dev: int) -> Callable:
    """Key -> owner rank: the top ``ceil(log2 n_dev)`` significant key
    bits, clamped to ``n_dev - 1``; monotone in the key.  Pads are the
    caller's to mask (``PAD_KEY``'s top bits fall in the last bucket)."""
    B = (n_dev - 1).bit_length() if n_dev > 1 else 0

    def bucket_of(keys: torch.Tensor) -> torch.Tensor:
        if B == 0:
            return torch.zeros_like(keys)
        return (keys >> (spec.key_bits - B)).clamp(max=n_dev - 1)

    return bucket_of


def bucket_rows(cols: Sequence[torch.Tensor], order: torch.Tensor,
                bucket: torch.Tensor, n_dev: int, row_cap: int,
                pads: Sequence[int]):
    """Regroup the lanes of the int64 columns ``cols``, taken in ``order``,
    into (n_dev, row_cap, len(cols)) destination rows, packed for one
    exchange.  ``bucket`` is each lane's destination in that order,
    non-decreasing, with pads marked ``n_dev`` at the tail: the bucket
    boundaries come from one ``searchsorted``, then one gather per column
    (a gather of whole packed rows runs far below the card's bandwidth).
    A bucket longer than ``row_cap`` keeps its first ``row_cap`` lanes.
    Returns (rows, counts (n_dev,), overflow)."""
    dev = bucket.device
    m = bucket.shape[0]
    bounds = torch.searchsorted(bucket, torch.arange(n_dev + 1, device=dev))
    counts = bounds[1:] - bounds[:-1]
    lane = torch.arange(row_cap, device=dev)
    take = lane[None, :] < counts[:, None]
    rows = torch.empty((n_dev, row_cap, len(cols)), dtype=torch.int64,
                       device=dev)
    if m:
        src = order[(bounds[:-1, None] + lane[None, :]).clamp(max=m - 1)]
    for j, (col, pad) in enumerate(zip(cols, pads)):
        rows[..., j] = torch.where(take, col[src], pad) if m else pad
    return rows, counts, torch.any(counts > row_cap)


def sort_by_key_meta(key: torch.Tensor, meta: torch.Tensor) -> torch.Tensor:
    """The permutation that orders rows by (key, meta): two stable library
    sorts, by meta and then by key."""
    order = torch.sort(meta, stable=True).indices
    return order[torch.sort(key[order], stable=True).indices]


class Fragment(NamedTuple):
    """One rank's sorted tree fragment after the routing exchange."""

    keys: torch.Tensor          # (D * bcap,) int64, PAD_KEY past count
    ids: torch.Tensor           # (D * bcap,) int64
    aux: torch.Tensor           # (D * bcap,) int32, gated by the global max
    tree_aux: torch.Tensor      # (D * bcap,) int32, before the gate
    count: torch.Tensor         # () int64 live lanes
    invalid: torch.Tensor       # () int64 this rank's objects outside
    overflow: torch.Tensor      # () bool cell or routing overflow


def local_sorted_fragment(spec: IndexSpec, group, n_dev: int,
                          min_depth: int, slots_per_axis: int, bcap: int,
                          system_min, system_max, bounds_min, bounds_max,
                          ids, dev: torch.device) -> Fragment:
    """Per-rank body of the sharded build
    (``broadphase_tpu.parallel.scan._local_sorted_fragment``): local
    emission (kernel 1) at ``n_local * slots**dim`` cells, the narrow-id
    gate reduced by MAX over the group, the routing sort by (key,
    ``(id << dim) | aux``), bucket rows, one exchange of the packed (key,
    id, aux) rows and the local sort.  The exchange carries the emitted
    aux bits ungated, so the fragment also has the tree's aux before the
    gate (``tree_aux``, which the sharded update merges on)."""
    contained, lmin, lmax, ids = _objects(dev, system_min, system_max,
                                          bounds_min, bounds_max, ids)
    n_local = ids.shape[0]
    keys, fids, faux, _, cell_ovf = emit_build(
        spec, lmin, lmax, contained, ids, int(min_depth),
        max(n_local * slots_per_axis ** spec.dim, 1), slots_per_axis)
    live = fids != PAD_ID
    # the gate must agree across ranks: the max live id over the group
    max_id = torch.where(live, fids, 0).max().reshape(1)
    dist.all_reduce(max_id, op=dist.ReduceOp.MAX, group=group)
    narrow = max_id[0] < _NARROW_ID_BOUND
    faux = faux.to(torch.int64)

    def tree_order(k, i, a):
        """The permutation to (key, (id << dim) | gated aux) order."""
        return sort_by_key_meta(k, (i << spec.dim) + torch.where(
            narrow, a, 0))

    perm = tree_order(keys, fids, faux)
    skeys = keys[perm]
    bucket = torch.where(skeys != PAD_KEY,
                         make_bucket_of(spec, n_dev)(skeys), n_dev)
    rows, _, route_ovf = bucket_rows((keys, fids, faux), perm, bucket,
                                     n_dev, bcap, (PAD_KEY, PAD_ID, 0))
    rk, ri, ra = exchange(rows, group).reshape(n_dev * bcap, 3).unbind(1)
    perm = tree_order(rk, ri, ra)
    skeys, sids, saux = rk[perm], ri[perm], ra[perm].to(torch.int32)
    return Fragment(skeys, sids, torch.where(narrow, saux, 0), saux,
                    (skeys != PAD_KEY).sum(), (~contained).sum(),
                    cell_ovf | route_ovf)


def _fib_owner(pa: torch.Tensor, n_dev: int) -> torch.Tensor:
    """``(pa * 0x9E3779B1 mod 2^32) % n_dev``, the JAX package's u32 hash:
    the 64-bit product could pass 2^63, so the low 32 bits are summed from
    the 16-bit halves of ``pa``, each product below 2^48."""
    lo = (pa & 0xFFFF) * _FIB
    hi = (((pa >> 16) & 0xFFFF) * _FIB) & 0xFFFF
    return ((lo + (hi << 16)) & _U32) % n_dev


def dedup_exchange(group, n_dev: int, xcap: int, pa: torch.Tensor,
                   pb: torch.Tensor):
    """Global pair dedup (``broadphase_tpu.parallel.scan._dedup_exchange``):
    route each pair to the rank owning the Fibonacci hash of its first id,
    so every copy of a pair meets on one rank, then the canonical sort and
    dedup (kernel 8).  ``pa``/``pb`` are a canonical scan's output, sorted
    by (a, b) with pads last, so one stable sort by owner orders them as
    JAX's sort by (owner, a, b).  Returns (out_a, out_b, count,
    overflow): this rank's class, sorted and deduplicated, in
    ``n_dev * xcap`` lanes."""
    owner = torch.where(pa != PAD_ID, _fib_owner(pa, n_dev), n_dev)
    owner, order = torch.sort(owner, stable=True)
    rows, _, x_ovf = bucket_rows((pa, pb), order, owner, n_dev, xcap,
                                 (PAD_ID, PAD_ID))
    xa, xb = (c.contiguous() for c in exchange(rows, group).reshape(
        n_dev * xcap, 2).unbind(1))
    out_a, out_b, count = canonical_pairs(xa, xb, xa != PAD_ID)
    return out_a, out_b, count, x_ovf


def make_sharded_step(spec: IndexSpec, group=None, *, min_depth: int = 0,
                      slots_per_axis: int = 2, bucket_capacity: int,
                      pair_capacity: int,
                      exchange_capacity: Optional[int] = None,
                      filter_fn: Optional[Callable] = None,
                      nested_ids: bool = False, device=None):
    """The sharded build + scan step
    (``broadphase_tpu.parallel.scan.make_sharded_step``):
    ``fn(system_min, system_max, bounds_min, bounds_max, ids) ->
    ShardedScanResult``, called by every rank of ``group`` (default: the
    world) with its object shard (:func:`object_shard`).

    ``bucket_capacity`` bounds one (source, destination) routing row, so a
    fragment holds ``D * bucket_capacity`` lanes; ``pair_capacity`` the
    rank's scan; ``exchange_capacity`` (default ``pair_capacity``) one
    dedup row, so a class holds ``D * exchange_capacity`` lanes.
    ``min_depth`` is raised to :func:`min_depth_for_devices`.
    ``filter_fn`` and ``nested_ids`` as ``layer.scan_pairs``; the
    min_depth rule keeps same-id nestings on one rank."""
    n_dev = dist.get_world_size(group)
    eff_min_depth = max(int(min_depth), min_depth_for_devices(spec, n_dev))
    bcap = int(bucket_capacity)
    xcap = int(exchange_capacity or pair_capacity)

    def step(system_min, system_max, bounds_min, bounds_max, ids
             ) -> ShardedScanResult:
        dev = rank_device(device, group, bounds_min, bounds_max, ids)
        frag = local_sorted_fragment(
            spec, group, n_dev, eff_min_depth, slots_per_axis, bcap,
            system_min, system_max, bounds_min, bounds_max, ids, dev)
        res = scan_pairs(spec, frag.keys, frag.ids, frag.count,
                         pair_capacity, filter_fn,
                         extra_overflow=frag.overflow, aux=frag.aux,
                         nested_ids=nested_ids)
        out_a, out_b, dcount, x_ovf = dedup_exchange(
            group, n_dev, xcap, res.pairs_a, res.pairs_b)
        stats = gather_stats((dcount, frag.invalid, res.overflow | x_ovf),
                             group)
        return ShardedScanResult(out_a, out_b, stats[:, 0],
                                 stats[:, 0].sum(), stats[:, 1].sum(),
                                 stats[:, 2].any())

    return step


def sharded_scan_step(spec: IndexSpec, group, system_min, system_max,
                      bounds_min, bounds_max, ids, **config
                      ) -> ShardedScanResult:
    """One-shot convenience wrapper around :func:`make_sharded_step`."""
    step = make_sharded_step(spec, group, **config)
    return step(system_min, system_max, bounds_min, bounds_max, ids)


def gather_pairs(result: ShardedScanResult, group=None) -> np.ndarray:
    """The global sorted pair list, on every rank: the classes' live
    prefixes in one ``all_gather`` and one sort.  The classes are disjoint
    (hash ownership), so this is a reorder, not a dedup.  Returns a
    (count, 2) uint32 array, as ``layer.scan_result_to_numpy`` (the JAX
    function returns the same pairs as a list of tuples)."""
    counts = result.shard_counts.tolist()
    m = max(counts, default=0)
    mine = torch.stack([result.pairs_a[:m], result.pairs_b[:m]], dim=1)
    parts = all_gather_rows(mine, group)
    live = torch.cat([p[:c] for p, c in zip(parts, counts)])
    # one int64 sort key that orders like the unsigned (a, b) tuple
    key = torch.sort((live[:, 0] - (1 << 31)) * (1 << 32)
                     + live[:, 1]).values
    return torch.stack([(key >> 32) + (1 << 31), key & _U32],
                       dim=1).cpu().numpy().astype(np.uint32)
