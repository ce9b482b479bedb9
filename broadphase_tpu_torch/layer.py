"""The layer: build and scan, on torch tensors.

PyTorch counterpart of the main path of ``broadphase_tpu/layer.py``:
:func:`build` (quantize, fused cell emission, tree sort) followed by
:func:`scan` (run ends, run prep, pair expansion with the emit-once rule,
emission compaction, canonical pair sort and dedup).  On CUDA tensors every
stage that the JAX package runs as a Pallas kernel launches this package's
CUDA kernel (``ops/``); on CPU tensors the same code runs each kernel's
plain version.  The tree sort and the canonical pair sort are
``torch.sort`` (library sorts, as ``lax.sort`` is in the JAX package).

Data contract (see ``index.py``): keys int64 with pad ``PAD_KEY``; ids
int64 with the reserved pad ``0xFFFF_FFFF``, which still sorts after every
live id; aux and the rule bytes int32.  A step enqueues its work without
waiting for the card: counts and flags stay on the device.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import geom
from .index import IndexSpec, PAD_KEY, keys_to_numpy
from .ops.build import emit_build
from .ops.compact import stream_compact
from .ops.expand import expand_pairs_entries
from .ops.expand2 import expand_pairs_prepped
from .ops.prep import prep_runs
from .ops.runends import scan_pass1

PAD_ID = 0xFFFF_FFFF

# Wider live ids drop the aux bits, as the JAX package's packed tree sort
# does (broadphase_tpu/layer.py:50, :413-424).
_NARROW_ID_BOUND = (1 << 29) - 1
# The emit-once rule is on only when every live id is below this bound
# (broadphase_tpu/layer.py:943): the JAX kernels pack the rule bytes
# beside 24-bit ids.
_RULE_ID_BOUND = (1 << 24) - 1


class LayerState(NamedTuple):
    """A built layer.  ``sorted`` and ``min_depth`` are host (CPU) scalars:
    they are known when the state is made, and :func:`scan` reads
    ``sorted`` without waiting for the card.  The other fields live on the
    layer's device."""

    keys: torch.Tensor           # (cap,) int64, PAD_KEY past count
    ids: torch.Tensor            # (cap,) int64, PAD_ID past count
    aux: torch.Tensor            # (cap,) int32 block-offset bits
    count: torch.Tensor          # () int64
    sorted: torch.Tensor         # () bool, host
    min_depth: torch.Tensor      # () int64, host
    invalid_count: torch.Tensor  # () int64: objects not in the system box
    overflow: torch.Tensor       # () bool: tree capacity or cell overflow


class ScanResult(NamedTuple):
    pairs_a: torch.Tensor        # (pair_cap,) int64, PAD_ID past count
    pairs_b: torch.Tensor        # (pair_cap,) int64
    count: torch.Tensor          # () int64
    overflow: torch.Tensor       # () bool


def _host(value, dtype) -> torch.Tensor:
    return torch.tensor(value, dtype=dtype)


def resolve_device(device, *inputs) -> torch.device:
    """The device an entry point runs on: ``device`` when given, else the
    device of the first tensor among ``inputs``, else the CUDA card.
    Raises when that is a CUDA device and no card is present: pass
    ``device="cpu"`` to run on the CPU."""
    if device is None:
        device = next((x.device for x in inputs
                       if isinstance(x, torch.Tensor)), "cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return dev


def capacity_of(state: LayerState) -> int:
    return state.ids.shape[0]


def make_layer(spec: IndexSpec, capacity: int, min_depth: int = 0,
               device=None) -> LayerState:
    """An empty layer of ``capacity`` entries on ``device`` (default: the
    card)."""
    del spec  # every spec shares the int64 key layout
    device = resolve_device(device)
    return LayerState(
        keys=torch.full((capacity,), PAD_KEY, dtype=torch.int64,
                        device=device),
        ids=torch.full((capacity,), PAD_ID, dtype=torch.int64,
                       device=device),
        aux=torch.zeros(capacity, dtype=torch.int32, device=device),
        count=torch.zeros((), dtype=torch.int64, device=device),
        sorted=_host(True, torch.bool),
        min_depth=_host(min_depth, torch.int64),
        invalid_count=torch.zeros((), dtype=torch.int64, device=device),
        overflow=torch.zeros((), dtype=torch.bool, device=device),
    )


@dataclasses.dataclass(frozen=True)
class LayerBuilder:
    """Static layer configuration (``broadphase_tpu.layer.LayerBuilder``):
    capacities are hard limits with overflow flags."""

    min_depth: int = 0
    slots_per_axis: int = 2
    index_capacity: Optional[int] = None
    collision_capacity: int = 1 << 20

    def empty(self, spec: IndexSpec, capacity: Optional[int] = None,
              device=None) -> LayerState:
        cap = capacity or self.index_capacity
        if cap is None:
            raise ValueError("need index_capacity (or capacity arg) for an "
                             "empty layer")
        return make_layer(spec, cap, self.min_depth, device)

    def build(self, spec: IndexSpec, system_min, system_max,
              bounds_min, bounds_max, ids, device=None) -> LayerState:
        return build(spec, system_min, system_max, bounds_min, bounds_max,
                     ids, slots_per_axis=self.slots_per_axis,
                     min_depth=self.min_depth,
                     out_capacity=self.index_capacity, device=device)

    def scan(self, spec: IndexSpec, state: LayerState
             ) -> Tuple[LayerState, ScanResult]:
        return scan(spec, state, self.collision_capacity)


# ---------------------------------------------------------------------------
# build / sort
# ---------------------------------------------------------------------------

def build(spec: IndexSpec, system_min, system_max, bounds_min, bounds_max,
          ids, slots_per_axis: int = 2, min_depth: int = 0,
          out_capacity: Optional[int] = None, device=None) -> LayerState:
    """Fresh sorted layer from (N, dim) f32 bounds and (N,) ids (u32
    values), on ``device`` (default: the device of the first tensor among
    the bounds and ids, else the card; see :func:`resolve_device`).
    The tree holds ``out_capacity`` entries (default
    ``N * slots_per_axis**dim``); ``overflow`` is set when live cells were
    cut or an object needed more than ``slots_per_axis`` cells on some
    axis.  Objects not inside the system box are dropped and counted in
    ``invalid_count``."""
    return _build(spec, system_min, system_max, bounds_min, bounds_max,
                  ids, slots_per_axis, min_depth, out_capacity, device)[0]


def _build(spec: IndexSpec, system_min, system_max, bounds_min, bounds_max,
           ids, slots_per_axis: int = 2, min_depth: int = 0,
           out_capacity: Optional[int] = None, device=None):
    """:func:`build`, and the emitted aux bits with the tree's order of
    them (``aux[perm]`` is the tree's aux before :func:`mask_aux`, which
    ``update`` carries from frame to frame)."""
    dev = resolve_device(device, bounds_min, bounds_max, ids)

    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=dev)

    smin, smax = f32(system_min), f32(system_max)
    bounds_min, bounds_max = f32(bounds_min), f32(bounds_max)
    if isinstance(ids, np.ndarray):
        ids = ids.astype(np.int64)
    ids = torch.as_tensor(ids, dtype=torch.int64, device=dev)
    n = ids.shape[0]
    contained = geom.bounds_contains(smin, smax, bounds_min, bounds_max)
    lmin = geom.to_local(smin, smax, bounds_min)
    lmax = geom.to_local(smin, smax, bounds_max)
    out_cap = out_capacity if out_capacity is not None \
        else n * slots_per_axis ** spec.dim
    keys, fids, faux, count, cell_ovf = emit_build(
        spec, lmin, lmax, contained, ids, int(min_depth), out_cap,
        slots_per_axis)
    skeys, sids, saux, perm = _sort_tree(spec, keys, fids, faux)
    state = LayerState(
        keys=skeys,
        ids=sids,
        aux=saux,
        count=count.clamp(max=out_cap),
        sorted=_host(True, torch.bool),
        min_depth=_host(int(min_depth), torch.int64),
        invalid_count=(~contained).sum(dtype=torch.int64),
        overflow=cell_ovf | (count > out_cap),
    )
    return state, faux, perm


def mask_aux(ids: torch.Tensor, aux: torch.Tensor) -> torch.Tensor:
    """The tree's aux column as the JAX package's packed tree sort leaves
    it: 0 on pads, and 0 everywhere once a live id reaches 2^29 - 1 (the
    emit-once rule then keeps every emission)."""
    if ids.shape[0] == 0:
        return aux
    live = ids != PAD_ID
    max_id = torch.where(live, ids, 0).max()
    return torch.where(live & (max_id < _NARROW_ID_BOUND), aux, 0)


def _sort_tree(spec: IndexSpec, keys: torch.Tensor, ids: torch.Tensor,
               aux: torch.Tensor):
    """Order the (key, id, aux) tuples as the JAX package's tree sort does:
    two stable library sorts, by ``(id << dim) | aux`` and then by key,
    with aux masked by :func:`mask_aux` first.  Returns the sorted (keys,
    ids, masked aux) and the permutation that sorts them."""
    if ids.shape[0] == 0:
        return keys, ids, aux, torch.zeros_like(ids)
    masked = mask_aux(ids, aux)
    order = torch.sort(ids * (1 << spec.dim) + masked, stable=True).indices
    skeys, order2 = torch.sort(keys[order], stable=True)
    perm = order[order2]
    return skeys, ids[perm], masked[perm], perm


def sort(spec: IndexSpec, state: LayerState) -> LayerState:
    """Sort the tree; a no-op for a sorted state."""
    if bool(state.sorted):
        return state
    keys, ids, aux, _ = _sort_tree(spec, state.keys, state.ids, state.aux)
    return state._replace(keys=keys, ids=ids, aux=aux,
                          sorted=_host(True, torch.bool))


# ---------------------------------------------------------------------------
# scan
# ---------------------------------------------------------------------------

def canonical_pairs(a: torch.Tensor, b: torch.Tensor, valid: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sort the valid (a, b) pairs, drop duplicates, compact to the front.

    One int64 sort key ``((a - 2^31) << 32) | b`` orders like the unsigned
    (a, b) tuple; invalid lanes take ``INT64_MAX``, which decodes to
    (PAD, PAD) and sorts last.  Returns (a, b, count), PAD past count."""
    key = torch.where(valid, (a - (1 << 31)) * (1 << 32) + b, PAD_KEY)
    key = torch.sort(key).values
    a_s = (key >> 32) + (1 << 31)
    b_s = key & 0xFFFF_FFFF
    prev = torch.cat([key[:1] ^ 1, key[:-1]])
    keep = (key != PAD_KEY) & (key != prev)
    (out_a, out_b), count = stream_compact(keep, (a_s, b_s))
    return out_a, out_b, count


def _finish_pairs(a, b, valid, pair_capacity: int, emit_capacity: int,
                  pair_overflow, extra_overflow, canonical: bool
                  ) -> ScanResult:
    """Emission compaction (when the emission buffer is wider than the pair
    buffer, or for ``canonical=False``) and the canonical sort + dedup."""
    if not canonical or emit_capacity > pair_capacity:
        (ca, cb), ccnt = stream_compact(valid, (a, b))
        a, b = ca[:pair_capacity], cb[:pair_capacity]
        pair_overflow = pair_overflow | (ccnt > pair_capacity)
        valid = a != PAD_ID
        if not canonical:
            return ScanResult(a, b, ccnt.clamp(max=pair_capacity),
                              pair_overflow | extra_overflow)
    out_a, out_b, count = canonical_pairs(a, b, valid)
    return ScanResult(out_a, out_b, count, pair_overflow | extra_overflow)


def runs_v2(e: torch.Tensor, count) -> Tuple[torch.Tensor, torch.Tensor,
                                              torch.Tensor]:
    """(starts, run, total) of the v2 expansion from the run ends e:
    ``run[j] = max(min(e[j], count) - j - 1, 0)`` for j < count, its
    exclusive prefix sum and its sum, int64: the JAX package's v2 branch
    in torch, which the prep kernel computes in :func:`scan_pairs`; kept
    as the plain reference of the JAX-shaped ``ops.expand.expand_pairs``."""
    lane = torch.arange(e.shape[0], dtype=torch.int64, device=e.device)
    em = torch.minimum(e.to(torch.int64), count)
    run = torch.where(lane < count, (em - (lane + 1)).clamp(min=0), 0)
    starts_incl = torch.cumsum(run, 0)
    return starts_incl - run, run, starts_incl[-1]


def scan_pairs(spec: IndexSpec, keys: torch.Tensor, ids: torch.Tensor,
               count: torch.Tensor, pair_capacity: int,
               extra_overflow: Optional[torch.Tensor] = None,
               aux: Optional[torch.Tensor] = None,
               emit_capacity: Optional[int] = None,
               canonical: bool = True, expand: str = "v3") -> ScanResult:
    """Pair expansion over a sorted tree (``broadphase_tpu.layer.scan_pairs``,
    its kernel path).

    Pass 1 (the run-ends kernel) finds each element's descendant run and
    its two rule bytes straight from the sorted keys, the prep kernel turns
    the runs into prefix-summed entries, and the expansion kernel writes
    one (later id, earlier id) emission per slot, keeping
    only the canonical emission of each pair when every live id is below
    2^24 - 1.  ``emit_capacity`` (>= ``pair_capacity``) bounds the raw
    emissions; ``canonical=False`` returns the unique pairs in emission
    order without the canonical sort.

    ``expand="v2"`` takes the JAX package's ``BROADPHASE_EXPAND=v2`` branch
    instead: pass 1 finds the run ends alone, the prep kernel makes the
    same entries without rule bytes, and the v2 expansion kernel
    (``ops/expand.py``) expands them with no emit-once rule, so duplicate
    emissions survive into ``canonical=False`` output.
    """
    if expand not in ("v2", "v3"):
        raise ValueError(f"expand must be 'v2' or 'v3', got {expand!r}")
    cap = ids.shape[0]
    dev = ids.device
    emit_cap = max(int(emit_capacity) if emit_capacity is not None
                   else pair_capacity, pair_capacity)
    if extra_overflow is None:
        extra_overflow = torch.zeros((), dtype=torch.bool, device=dev)
    if cap == 0:
        empty = torch.full((pair_capacity,), PAD_ID, dtype=torch.int64,
                           device=dev)
        return ScanResult(empty, empty.clone(),
                          torch.zeros((), dtype=torch.int64, device=dev),
                          extra_overflow)
    e, ameta, bmeta = scan_pass1(spec, keys, aux, rules=expand == "v3")
    sv, ab, bid, bm, m, total, wrapped = prep_runs(e, ids, bmeta, count)
    if expand == "v2":
        # broadphase_tpu/layer.py:980-998: the same runs and prefix sum,
        # expanded with no rule
        a, b = expand_pairs_entries(ids, sv, ab, bid, m, total, emit_cap)
    else:
        lane = torch.arange(cap, dtype=torch.int64, device=dev)
        max_id = torch.where(lane < count, ids, 0).max()
        a, b = expand_pairs_prepped(ids, ameta, sv, ab, bid, bm, m, total,
                                    emit_cap, max_id < _RULE_ID_BOUND,
                                    spec.dim)
    # dropped emissions and slots >= total are PAD on both sides
    valid = a != b
    return _finish_pairs(a, b, valid, pair_capacity, emit_cap,
                         wrapped | (total > emit_cap), extra_overflow,
                         canonical)


def scan(spec: IndexSpec, state: LayerState, pair_capacity: int,
         emit_capacity: Optional[int] = None, canonical: bool = True,
         expand: str = "v3") -> Tuple[LayerState, ScanResult]:
    """All-pairs candidate scan (``broadphase_tpu.layer.scan``): the sorted,
    deduplicated (later id, earlier id) pair list, or with
    ``canonical=False`` the same unique pairs in emission order.
    ``expand`` selects the expansion as :func:`scan_pairs` says."""
    state = sort(spec, state)
    result = scan_pairs(spec, state.keys, state.ids, state.count,
                        pair_capacity, extra_overflow=state.overflow,
                        aux=state.aux, emit_capacity=emit_capacity,
                        canonical=canonical, expand=expand)
    return state, result


def layers_equal(spec: IndexSpec, a: LayerState, b: LayerState) -> bool:
    """Host-side equality as ``broadphase_tpu.layer.layers_equal`` defines
    it: min_depth, the sorted flag and the live tree (keys and ids); the
    overflow and invalid counters are not compared."""
    ka, ia, ca = tree_to_numpy(spec, a)
    kb, ib, cb = tree_to_numpy(spec, b)
    return (int(a.min_depth) == int(b.min_depth)
            and bool(a.sorted) == bool(b.sorted)
            and ca == cb
            and bool(np.array_equal(ka, kb))
            and bool(np.array_equal(ia, ib)))


# ---------------------------------------------------------------------------
# Host views
# ---------------------------------------------------------------------------

def tree_to_numpy(spec: IndexSpec, state: LayerState):
    """(keys uint64 (uint32 for Index32_2D), ids uint32, count) of the live
    prefix, as ``broadphase_tpu.layer.tree_to_numpy`` returns them."""
    cnt = int(state.count)
    keys = keys_to_numpy(spec, state.keys[:cnt])
    ids = state.ids[:cnt].cpu().numpy().astype(np.uint32)
    return keys, ids, cnt


def scan_result_to_numpy(result: ScanResult) -> np.ndarray:
    """(count, 2) uint32 array of the live pairs."""
    cnt = int(result.count)
    return np.stack([result.pairs_a[:cnt].cpu().numpy(),
                     result.pairs_b[:cnt].cpu().numpy()],
                    axis=1).astype(np.uint32)
