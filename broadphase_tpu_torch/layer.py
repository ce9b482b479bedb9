"""The layer: build, extend, merge, sort and scan, on torch tensors.

PyTorch counterpart of ``broadphase_tpu/layer.py``: :func:`build` (quantize,
fused cell emission, tree sort) followed by :func:`scan` (run ends, run
prep, pair expansion with the emit-once rule, emission compaction,
canonical pair sort and dedup), and the rest of the layer surface:
:func:`clear`, :func:`extend`, :func:`merge`, :func:`scan_filtered`, the
``nested_ids`` pre-pass, :func:`scan_auto` and the BR_SCENE bridge.  On
CUDA tensors every stage that the JAX package runs as a Pallas kernel
launches this package's CUDA kernel (``ops/``); on CPU tensors the same
code runs each kernel's plain version.  The tree sort is ``torch.sort``
(a library sort, as ``lax.sort`` is in the JAX package); the canonical
pair sort is kernel 8, a radix sort of the pairs packed to the ids'
width; the merge of two sorted layers is the merge kernel (k6).

Data contract (see ``index.py``): keys int64 with pad ``PAD_KEY``; ids
int64 with the reserved pad ``0xFFFF_FFFF``, which still sorts after every
live id; aux and the rule bytes int32.  A step enqueues its work without
waiting for the card: counts and flags stay on the device.  ``extend``
and ``merge`` read one count on the host, and only when the layer is
sorted, to keep the host ``sorted`` flag exact.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import geom, profiling
from .index import (IndexSpec, PAD_KEY, depth_of, descendant_max,
                    keys_from_numpy, keys_to_numpy, origin_of)
from .ops.build import emit_build
from .ops.compact import stream_compact
from .ops.expand import expand_pairs_entries
from .ops.expand2 import expand_pairs_prepped
from .ops.merge import merge_cancel_compact
from .ops.pairsort import pair_sort
from .ops.prep import prep_runs
from .ops.runends import scan_pass1
from .ops.treesort import NARROW_ID_BOUND, tree_sort
from .scene import SceneLayer

PAD_ID = 0xFFFF_FFFF

# Wider live ids drop the aux bits, as the JAX package's packed tree sort
# does (broadphase_tpu/layer.py:50, :413-424).
_NARROW_ID_BOUND = NARROW_ID_BOUND
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


class TestResult(NamedTuple):
    """A query's hits (``broadphase_tpu.layer.TestResult``)."""

    ids: torch.Tensor            # (result_cap,) int64, PAD_ID past count
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
    capacities are hard limits with overflow flags; ``test_capacity`` is
    the query result buffer's size."""

    min_depth: int = 0
    slots_per_axis: int = 2
    index_capacity: Optional[int] = None
    collision_capacity: int = 1 << 20
    test_capacity: int = 1 << 16

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

    def scan_filtered(self, spec: IndexSpec, state: LayerState, filter_fn
                      ) -> Tuple[LayerState, ScanResult]:
        return scan_filtered(spec, state, self.collision_capacity, filter_fn)


def clear(state: LayerState) -> LayerState:
    """The layer emptied (``broadphase_tpu.layer.clear``): pads restored,
    count 0, sorted, counters and flags reset; ``min_depth`` kept."""
    dev = state.ids.device
    return state._replace(
        keys=torch.full_like(state.keys, PAD_KEY),
        ids=torch.full_like(state.ids, PAD_ID),
        aux=torch.zeros_like(state.aux),
        count=torch.zeros((), dtype=torch.int64, device=dev),
        sorted=_host(True, torch.bool),
        invalid_count=torch.zeros((), dtype=torch.int64, device=dev),
        overflow=torch.zeros((), dtype=torch.bool, device=dev),
    )


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


def _objects(dev, system_min, system_max, bounds_min, bounds_max, ids):
    """(contained, lmin, lmax, ids) of a batch of objects on ``dev``: the
    containment test and the u32 local bounds that cell emission takes,
    and the ids as int64."""
    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=dev)

    smin, smax = f32(system_min), f32(system_max)
    bounds_min, bounds_max = f32(bounds_min), f32(bounds_max)
    if isinstance(ids, np.ndarray):
        ids = ids.astype(np.int64)
    ids = torch.as_tensor(ids, dtype=torch.int64, device=dev)
    return (geom.bounds_contains(smin, smax, bounds_min, bounds_max),
            geom.to_local(smin, smax, bounds_min),
            geom.to_local(smin, smax, bounds_max), ids)


def _build(spec: IndexSpec, system_min, system_max, bounds_min, bounds_max,
           ids, slots_per_axis: int = 2, min_depth: int = 0,
           out_capacity: Optional[int] = None, device=None,
           want_perm: bool = False):
    """:func:`build`, and the emitted aux bits with, where ``want_perm``,
    the tree's order of them (``aux[perm]`` is the tree's aux before
    :func:`mask_aux`, which ``update`` carries from frame to frame; perm
    is None otherwise)."""
    with profiling.span("layer.build"):
        dev = resolve_device(device, bounds_min, bounds_max, ids)
        with profiling.span("build.quantize"):
            contained, lmin, lmax, ids = _objects(
                dev, system_min, system_max, bounds_min, bounds_max, ids)
        n = ids.shape[0]
        out_cap = out_capacity if out_capacity is not None \
            else n * slots_per_axis ** spec.dim
        with profiling.span("build.emit"):
            keys, fids, faux, count, cell_ovf = emit_build(
                spec, lmin, lmax, contained, ids, int(min_depth), out_cap,
                slots_per_axis)
        with profiling.span("build.sort"):
            # the (key, id, aux) order of the JAX package's tree sort,
            # aux masked by mask_aux: kernel 9 (ops/treesort.py)
            skeys, sids, saux, perm = tree_sort(spec, keys, fids, faux,
                                                want_perm)
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


def sort(spec: IndexSpec, state: LayerState) -> LayerState:
    """Sort the tree; a no-op for a sorted state."""
    if bool(state.sorted):
        return state
    keys, ids, aux, _ = tree_sort(spec, state.keys, state.ids, state.aux)
    return state._replace(keys=keys, ids=ids, aux=aux,
                          sorted=_host(True, torch.bool))


# ---------------------------------------------------------------------------
# extend / merge
# ---------------------------------------------------------------------------

def _place(col: torch.Tensor, src: torch.Tensor, dest: torch.Tensor
           ) -> torch.Tensor:
    """A copy of ``col`` with ``src[i]`` written at ``dest[i]``.  A lane
    whose dest is ``len(col)`` is dropped: it lands in a spare slot past
    the end of the returned column, which never sees it."""
    cap = col.shape[0]
    out = torch.empty(cap + 1, dtype=col.dtype, device=col.device)
    out[:cap] = col
    out.index_copy_(0, dest, src.to(col.dtype))
    return out[:cap]


def extend(spec: IndexSpec, state: LayerState, system_min, system_max,
           bounds_min, bounds_max, ids, slots_per_axis: int = 2
           ) -> LayerState:
    """Append a batch of objects (``broadphase_tpu.layer.extend``).

    bounds_min/bounds_max: (N, dim) f32; ids: (N,) u32 values; they move to
    the layer's device.  The cells are emitted by the build kernel (k1) at
    the layer's ``min_depth``, in the reference's append order (object
    major, x fastest), and placed at ``[count, count + appended)`` by a
    device-side scatter; cells that would land at or past the capacity
    are dropped.  Aux is appended unmasked, as in the JAX package
    (:func:`sort` masks it).  Objects not inside the system box are
    counted in ``invalid_count``; ``overflow`` is set when cells were cut
    or an object needed more than ``slots_per_axis`` cells on an axis.

    ``sorted`` is a host flag: when the layer is sorted, ``extend`` reads
    the appended count on the host (one wait for the card) to keep it
    exact, since appending nothing keeps the layer sorted; an unsorted
    layer stays unsorted without a wait.  ``extend`` is the incremental
    path; a whole frame is :func:`build`."""
    dev = state.ids.device
    contained, lmin, lmax, ids = _objects(dev, system_min, system_max,
                                          bounds_min, bounds_max, ids)
    cap = capacity_of(state)
    invalid = state.invalid_count + (~contained).sum(dtype=torch.int64)
    n = ids.shape[0]
    if n == 0:
        return state._replace(invalid_count=invalid)
    out_cap = max(min(n * slots_per_axis ** spec.dim, cap), 1)
    keys, fids, faux, appended, cell_ovf = emit_build(
        spec, lmin, lmax, contained, ids, int(state.min_depth), out_cap,
        slots_per_axis)
    lane = torch.arange(out_cap, dtype=torch.int64, device=dev)
    dest = state.count + lane
    dest = torch.where((lane < appended) & (dest < cap), dest, cap)
    new_count = state.count + appended
    return state._replace(
        keys=_place(state.keys, keys, dest),
        ids=_place(state.ids, fids, dest),
        aux=_place(state.aux, faux, dest),
        count=new_count.clamp(max=cap),
        sorted=_host(bool(state.sorted) and int(appended) == 0, torch.bool),
        invalid_count=invalid,
        overflow=state.overflow | (new_count > cap) | cell_ovf,
    )


def _pack_meta(dim: int, ids, aux, tag: int):
    """(id, aux, tag) -> one int64, monotone in (id, aux, tag): the merge
    kernel's meta column."""
    return (ids << (dim + 1)) | (aux << 1) | tag


def _unpack_meta(spec: IndexSpec, meta, cap: int, new_count):
    """(ids, aux) of the merged output's live prefix; PAD_ID and 0 past
    it."""
    dim = spec.dim
    lane = torch.arange(cap, dtype=torch.int64, device=meta.device)
    live = lane < new_count.clamp(max=cap)
    ids = torch.where(live, meta >> (dim + 1), PAD_ID)
    aux = torch.where(live, (meta >> 1) & ((1 << dim) - 1), 0)
    return ids, aux.to(torch.int32)


def _merge_cols(spec: IndexSpec, state: LayerState):
    """A sorted layer as the merge kernel's (key, meta) columns, tag 0;
    ``PAD_KEY`` in both on the pads."""
    meta = _pack_meta(spec.dim, state.ids, state.aux.to(torch.int64), 0)
    return state.keys, torch.where(state.ids != PAD_ID, meta, PAD_KEY)


def merge(spec: IndexSpec, state: LayerState, other: LayerState
          ) -> LayerState:
    """Merge another layer's tree into ``state``
    (``broadphase_tpu.layer.merge``): the smaller ``min_depth`` is adopted,
    with the JAX package's warning when they differ; the count is capped
    at ``state``'s capacity and ``overflow`` set when cells were cut.

    * Both layers sorted (the precomputed static layer the reference
      merges each frame's dynamic layer into): the merge kernel (k6) on
      (key, ``(id << (dim+1)) | (aux << 1)``) with every tag 0, so nothing
      cancels; the result is sorted.  Meta is monotone in (id, aux), so
      k6's input order is the order :func:`sort` leaves.  Entries equal in
      (key, id) come out ordered by aux, ``state``'s first where aux is
      equal too; the JAX bitonic merge orders them by network position.
      Keys, ids, count and flags agree with the JAX package; aux agrees
      wherever (key, id) is unique.
    * Otherwise: ``other``'s live entries are appended after ``state``'s
      by a device-side scatter, as the reference appends.  The layer stays
      sorted only if it was and ``other`` is empty: that reads
      ``other.count`` on the host, only when ``state`` is sorted.

    ``invalid_count`` is ``state``'s own, as in the JAX package.  Under
    ``profiling.tracing()`` the merge opens ``layer.merge`` with its stages
    (``merge.cols``, ``merge.kernel``, ``merge.unpack``) and counts the
    merged entries in ``merge.entries``."""
    with profiling.span("layer.merge"):
        a, b = int(state.min_depth), int(other.min_depth)
        if a != b:
            logging.getLogger("broadphase_tpu_torch").warning(
                "merging layers with different min_depth (%d != %d); "
                "adopting the smaller", a, b)
        cap = capacity_of(state)
        if bool(state.sorted) and bool(other.sorted):
            with profiling.span("merge.cols"):
                cols = (*_merge_cols(spec, state), *_merge_cols(spec, other))
            with profiling.span("merge.kernel"):
                (keys, meta), count, _ = merge_cancel_compact(
                    *cols, other.count, cap)
            with profiling.span("merge.unpack"):
                ids, aux = _unpack_meta(spec, meta, cap, count)
            is_sorted = True
        else:
            with profiling.span("merge.kernel"):
                src = torch.arange(capacity_of(other), dtype=torch.int64,
                                   device=state.ids.device)
                dest = state.count + src
                dest = torch.where((src < other.count) & (dest < cap), dest,
                                   cap)
                keys = _place(state.keys, other.keys, dest)
                ids = _place(state.ids, other.ids, dest)
                aux = _place(state.aux, other.aux, dest)
            is_sorted = bool(state.sorted) and int(other.count) == 0
        total = state.count + other.count
        merged = state._replace(
            keys=keys, ids=ids, aux=aux,
            count=total.clamp(max=cap),
            sorted=_host(is_sorted, torch.bool),
            min_depth=_host(min(a, b), torch.int64),
            overflow=state.overflow | other.overflow | (total > cap),
        )
        profiling.count("merge.entries", merged.count)
    return merged


# ---------------------------------------------------------------------------
# scan
# ---------------------------------------------------------------------------

def canonical_pairs(a: torch.Tensor, b: torch.Tensor, valid: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sort the valid (a, b) pairs, drop duplicates, compact to the front
    (kernel 8, ``ops/pairsort.py``): the pairs packed as ``(a << w) | b``,
    ``w`` the bit length of the largest valid id, radix-sorted and
    deduplicated.  Returns (a, b, count), PAD past count."""
    return pair_sort(a, b, valid, a.shape[0])[:3]


def _finish_pairs(a, b, valid, pair_capacity: int, emit_capacity: int,
                  pair_overflow, extra_overflow, canonical: bool,
                  id_bound: Optional[torch.Tensor] = None) -> ScanResult:
    """The canonical sort + dedup of the first ``pair_capacity`` valid
    emissions (kernel 8 compacts a wider emission buffer itself; ``valid``
    None: those where a != b), or for ``canonical=False`` the emission
    compaction alone (kernel 5)."""
    if not canonical:
        with profiling.span("scan.compact"):
            (ca, cb), ccnt = stream_compact(valid, (a, b))
            a, b = ca[:pair_capacity], cb[:pair_capacity]
            pair_overflow = pair_overflow | (ccnt > pair_capacity)
            valid = a != PAD_ID
        return ScanResult(a, b, ccnt.clamp(max=pair_capacity),
                          pair_overflow | extra_overflow)
    with profiling.span("scan.canonical"):
        out_a, out_b, count, total = pair_sort(a, b, valid, pair_capacity,
                                               id_bound)
    if emit_capacity > pair_capacity:
        pair_overflow = pair_overflow | (total > pair_capacity)
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


def _drop_nested_same_id(spec: IndexSpec, keys: torch.Tensor,
                         ids: torch.Tensor, count: torch.Tensor):
    """The reference sweep's id-on-stack skip as a pre-pass over a sorted
    tree (``broadphase_tpu.layer._drop_nested_same_id``): drop an entry
    when an earlier entry of its id is an ancestor-or-equal cell of it,
    i.e. has ``descendant_max >= key``.

    A stable sort by id groups the entries by id, key-ascending inside a
    group (the tree is sorted by key); an inclusive segmented running max
    of ``descendant_max`` by log-doubling, shifted by one, gives the max
    over the strictly earlier entries of the group; the skips go back to
    tree order by a scatter and the kept entries are compacted by k5,
    which keeps the tree sorted.  Returns (keys, ids, count)."""
    cap = ids.shape[0]
    idx = torch.arange(cap, dtype=torch.int64, device=ids.device)
    live = idx < count
    ids_g = torch.where(live, ids, PAD_ID)
    order = torch.sort(ids_g, stable=True).indices
    ids_s, key_s = ids_g[order], keys[order]
    run_max = descendant_max(spec, key_s)
    s = 1
    while s < cap:
        same = (idx >= s) & (ids_s == torch.roll(ids_s, s))
        cand = torch.roll(run_max, s)
        run_max = torch.where(same & (run_max < cand), cand, run_max)
        s <<= 1
    seg = (idx >= 1) & (ids_s == torch.roll(ids_s, 1))
    skip_s = seg & (torch.roll(run_max, 1) >= key_s)
    skip = torch.zeros_like(skip_s)
    skip[order] = skip_s
    (out_keys, out_ids), kept = stream_compact(
        live & ~skip, (keys, ids), (PAD_KEY, PAD_ID))
    return out_keys, out_ids, torch.minimum(kept, count)


def scan_pairs(spec: IndexSpec, keys: torch.Tensor, ids: torch.Tensor,
               count: torch.Tensor, pair_capacity: int,
               filter_fn: Optional[Callable] = None,
               extra_overflow: Optional[torch.Tensor] = None,
               aux: Optional[torch.Tensor] = None,
               emit_capacity: Optional[int] = None,
               nested_ids: bool = False, canonical: bool = True,
               expand: str = "v3") -> ScanResult:
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

    ``filter_fn(a, b) -> bool tensor`` (the id columns of the emission
    slots, PAD_ID on empty slots) is ANDed into the valid mask before the
    dedup, on both expansions.  ``nested_ids=True`` applies the reference
    sweep's id-on-stack skip first (:func:`_drop_nested_same_id`) and
    scans with aux all zero, so the emit-once rule keeps every emission:
    size ``pair_capacity`` for raw emissions then.

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
    if nested_ids:
        with profiling.span("scan.nested"):
            keys, ids, count = _drop_nested_same_id(spec, keys, ids, count)
        aux = None      # partial same-id blocks: the aux bits are stale
    with profiling.span("scan.pass1"):
        e, ameta, bmeta = scan_pass1(spec, keys, aux, rules=expand == "v3")
    with profiling.span("scan.prep"):
        sv, ab, bid, bm, m, total, wrapped = prep_runs(e, ids, bmeta, count)
    profiling.count("scan.emitted", total)
    max_id = None   # the v2 scan leaves kernel 8 to find its id bound
    with profiling.span("scan.expand"):
        if expand == "v2":
            # broadphase_tpu/layer.py:980-998: the same runs and prefix
            # sum, expanded with no rule
            a, b = expand_pairs_entries(ids, sv, ab, bid, m, total, emit_cap)
        else:
            lane = torch.arange(cap, dtype=torch.int64, device=dev)
            max_id = torch.where(lane < count, ids, 0).max()
            a, b = expand_pairs_prepped(ids, ameta, sv, ab, bid, bm, m,
                                        total, emit_cap,
                                        max_id < _RULE_ID_BOUND, spec.dim)
    # dropped emissions and slots >= total are PAD on both sides; kernel 8
    # finds a != b itself
    valid = None
    if filter_fn is not None or not canonical:
        valid = a != b
    if filter_fn is not None:
        valid = valid & torch.as_tensor(filter_fn(a, b), dtype=torch.bool,
                                        device=dev)
    result = _finish_pairs(a, b, valid, pair_capacity, emit_cap,
                           wrapped | (total > emit_cap), extra_overflow,
                           canonical, max_id)
    profiling.count("scan.pairs", result.count)
    return result


def scan(spec: IndexSpec, state: LayerState, pair_capacity: int,
         emit_capacity: Optional[int] = None, nested_ids: bool = False,
         canonical: bool = True, expand: str = "v3"
         ) -> Tuple[LayerState, ScanResult]:
    """All-pairs candidate scan (``broadphase_tpu.layer.scan``): the sorted,
    deduplicated (later id, earlier id) pair list, or with
    ``canonical=False`` the same unique pairs in emission order.
    ``nested_ids`` and ``expand`` as :func:`scan_pairs` says."""
    return scan_filtered(spec, state, pair_capacity, None, emit_capacity,
                         nested_ids, canonical, expand)


def scan_filtered(spec: IndexSpec, state: LayerState, pair_capacity: int,
                  filter_fn: Optional[Callable],
                  emit_capacity: Optional[int] = None,
                  nested_ids: bool = False, canonical: bool = True,
                  expand: str = "v3") -> Tuple[LayerState, ScanResult]:
    """:func:`scan` with a user predicate ANDed into the pairs before the
    dedup (``broadphase_tpu.layer.scan_filtered``): ``filter_fn(a_ids,
    b_ids)`` is a vectorized function of two int64 tensors on the layer's
    device that returns a bool mask of their shape."""
    with profiling.span("layer.scan"):
        state = sort(spec, state)
        result = scan_pairs(spec, state.keys, state.ids, state.count,
                            pair_capacity, filter_fn,
                            extra_overflow=state.overflow, aux=state.aux,
                            emit_capacity=emit_capacity,
                            nested_ids=nested_ids, canonical=canonical,
                            expand=expand)
    return state, result


def scan_auto(spec: IndexSpec, state: LayerState,
              initial_capacity: int = 1 << 15, max_doublings: int = 12,
              filter_fn: Optional[Callable] = None
              ) -> Tuple[LayerState, ScanResult]:
    """Scan with a growing pair buffer (``broadphase_tpu.layer.scan_auto``):
    the capacity starts at ``initial_capacity`` rounded up to a multiple
    of 1024 and doubles until the overflow flag, read on the host once an
    attempt, is clear; the result buffers have the JAX package's shapes.
    Raises ``RuntimeError`` after ``max_doublings`` doublings."""
    cap = max(1024, -(-initial_capacity // 1024) * 1024)
    for _ in range(max_doublings + 1):
        state, result = scan_filtered(spec, state, cap, filter_fn)
        if not bool(result.overflow):
            return state, result
        cap *= 2
    raise RuntimeError(
        f"scan overflowed even at pair_capacity={cap // 2}; the scene may "
        "be degenerate (many objects in one cell)")


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


# ---------------------------------------------------------------------------
# Checkpointing through BR_SCENE (``scene.py``)
# ---------------------------------------------------------------------------

def layer_to_scene_layer(spec: IndexSpec, state: LayerState) -> SceneLayer:
    """The live tree as a :class:`~broadphase_tpu_torch.scene.SceneLayer`
    (``broadphase_tpu.layer.layer_to_scene_layer``)."""
    keys, ids, _ = tree_to_numpy(spec, state)
    return SceneLayer(min_depth=int(state.min_depth), keys=keys, ids=ids,
                      sorted=bool(state.sorted))


def _aux_from_tree_np(spec: IndexSpec, keys_np, ids_np) -> np.ndarray:
    """The per-entry block-offset aux bits of a serialized tree, on the
    host (``broadphase_tpu.layer._aux_from_tree_np``): bit k is set iff
    the entry's cell is not its object's minimum cell along axis k.
    BR_SCENE holds no aux, so a restore recomputes it.

    Wrong bits could drop pairs (the emit-once rule would reject every
    copy), while zero bits only keep every emission.  So the entries are
    grouped by (id, depth), and only a group that is one full rectangular
    block of cells (per-axis spans whose product is the group's size) gets
    bits; any other group (merged same-id layers, duplicate cells) keeps
    aux 0.  Returns (n,) uint32."""
    n = len(ids_np)
    aux = np.zeros(n, np.uint32)
    if n == 0:
        return aux
    keys = keys_from_numpy(spec, keys_np, "cpu")
    coords = [c.numpy().astype(np.int64) for c in origin_of(spec, keys)]
    depth = depth_of(spec, keys).numpy().astype(np.int64)
    ids64 = np.asarray(ids_np, np.uint32).astype(np.int64)
    group_key = (ids64 << 6) | np.clip(depth, 0, 63)
    order = np.argsort(group_key, kind="stable")
    gk = group_key[order]
    starts = np.flatnonzero(np.concatenate([[True], gk[1:] != gk[:-1]]))
    sizes = np.diff(np.append(starts, n))
    d_g = depth[order][starts]
    # adjacent block cells at depth d differ by 2^(32-d) in the 32-bit
    # local coordinate (reference scale_at_depth, src/geom.rs:49)
    step = np.left_shift(np.int64(1), np.clip(32 - d_g, 0, 63))
    nvals_prod = np.ones(len(starts), np.int64)
    bits_sorted = np.zeros(n, np.uint32)
    gmins = []
    for k in range(spec.dim):
        c = coords[k][order]
        gmin = np.minimum.reduceat(c, starts)
        gmax = np.maximum.reduceat(c, starts)
        nvals_prod *= (gmax - gmin) // np.maximum(step, 1) + 1
        gmins.append(gmin)
    ok_full = np.repeat(nvals_prod == sizes, sizes)
    for k in range(spec.dim):
        gmin_full = np.repeat(gmins[k], sizes)
        bits_sorted |= ((coords[k][order] > gmin_full)
                        .astype(np.uint32) << k)
    aux[order] = np.where(ok_full, bits_sorted, np.uint32(0))
    return aux


def layer_from_scene_layer(spec: IndexSpec, scene_layer: SceneLayer,
                           capacity: Optional[int] = None,
                           device=None) -> LayerState:
    """A layer restored from a serialized tree
    (``broadphase_tpu.layer.layer_from_scene_layer``) on ``device``
    (default: the card), of ``capacity`` entries (default: the tree's
    length, at least 1), with the aux bits of :func:`_aux_from_tree_np`."""
    n = len(scene_layer.ids)
    cap = capacity or max(n, 1)
    if cap < n:
        raise ValueError(f"capacity {cap} < serialized tree length {n}")
    state = make_layer(spec, cap, scene_layer.min_depth, device)
    dev = state.ids.device
    ids_np = np.asarray(scene_layer.ids, np.uint32)
    state.keys[:n] = keys_from_numpy(spec, scene_layer.keys, dev)
    state.ids[:n] = torch.as_tensor(ids_np.astype(np.int64), device=dev)
    state.aux[:n] = torch.as_tensor(
        _aux_from_tree_np(spec, scene_layer.keys, ids_np).astype(np.int32),
        device=dev)
    return state._replace(
        count=torch.tensor(n, dtype=torch.int64, device=dev),
        sorted=_host(bool(scene_layer.sorted), torch.bool))
