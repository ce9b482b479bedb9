"""Port parity for the rest of the layer surface: clear, extend, merge,
scan_filtered, scan(nested_ids=True) and scan_auto of broadphase_tpu_torch
against broadphase_tpu.layer (its default CPU path), and against the C++
oracle (``native``) where it covers the path.

The same numpy scenes, made from a seed, go through both packages; layer
state crosses with ``convert``.  Trees are compared slot for slot over the
whole capacity (keys, ids, aux, count, sorted, min_depth, invalid_count,
overflow) and pair lists pair for pair: tolerance 0.  Merged trees compare
aux only where (key, id) is unique, as ``layer.merge`` documents.
"""

import logging

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import bench
from broadphase_tpu import index as bidx
from broadphase_tpu import layer as jl
from broadphase_tpu.utils import native
from broadphase_tpu.utils import oracle as joracle
from broadphase_tpu_torch import LayerBuilder, convert
from broadphase_tpu_torch import index as tidx
from broadphase_tpu_torch import layer as tl

from test_torch_layer import _jax_fields

SPECS = [(s, getattr(tidx, s.name)) for s in bidx.ALL_SPECS]
SPEC_IDS = [s.name for s in bidx.ALL_SPECS]
N = 400


def _scene(dim, n=N, seed=0, outside=False):
    smin, smax, bmin, bmax, ids = bench._scene(dim, n, seed=seed)
    bmin, bmax = bmin.copy(), bmax.copy()
    if outside:                  # some boxes leave the system box
        bmin[:20] -= 30.0
        bmax[20:40] += 500.0
    return smin, smax, bmin, bmax, ids


def _port(spec, tspec, jst):
    return convert.layer_state_from_jax(tspec, _jax_fields(spec, jst))


def _jax_state(spec, fields):
    """A JAX LayerState from numpy fields as ``_jax_fields`` gives them."""
    keys = bidx.key_from_columns(spec, tuple(jnp.asarray(c)
                                             for c in fields["keys"]))
    return jl.LayerState(keys=keys, **{
        f: jnp.asarray(fields[f]) for f in
        ("ids", "aux", "count", "sorted", "min_depth", "invalid_count",
         "overflow")})


def _grow(spec, jst, cap):
    """A JAX layer padded to ``cap`` entries (the JAX package's CPU build
    holds N * slots**dim entries whatever out_capacity above that asks)."""
    f = _jax_fields(spec, jst)
    extra = cap - len(f["ids"])
    return _jax_state(spec, dict(
        f, keys=tuple(np.concatenate([c, np.full(extra, 0xFFFF_FFFF,
                                                  np.uint32)])
                      for c in f["keys"]),
        ids=np.concatenate([f["ids"], np.full(extra, 0xFFFF_FFFF,
                                              np.uint32)]),
        aux=np.concatenate([f["aux"], np.zeros(extra, np.uint32)])))


def _assert_same_state(spec, tspec, jst, tst, aux=True):
    """The whole capacity slot for slot, and every counter and flag."""
    want = _jax_fields(spec, jst)
    got = convert.layer_state_to_numpy(tspec, tst)
    for g, w in zip(got["keys"], want["keys"]):
        np.testing.assert_array_equal(g, w)
    fields = ["ids", "count", "sorted", "min_depth", "invalid_count",
              "overflow"] + (["aux"] if aux else [])
    for f in fields:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)


def _pairs(res):
    cnt = int(res.count)
    a, b = np.asarray(res.pairs_a)[:cnt], np.asarray(res.pairs_b)[:cnt]
    return np.stack([a, b], axis=1).astype(np.uint32)


def _assert_same_scan(jres, tres):
    assert int(tres.count) == int(jres.count)
    assert bool(tres.overflow) == bool(jres.overflow)
    np.testing.assert_array_equal(tl.scan_result_to_numpy(tres),
                                  _pairs(jres))
    assert tres.pairs_a.shape == jres.pairs_a.shape


# ---------------------------------------------------------------------------
# clear / extend
# ---------------------------------------------------------------------------

def test_clear_matches_jax():
    spec, tspec = SPECS[2]
    scene = _scene(3, outside=True)
    jst = jl.build(spec, *scene, out_capacity=N // 2, min_depth=2)
    tst = _port(spec, tspec, jst)
    assert bool(tst.overflow) and int(tst.invalid_count) > 0
    jc, tc = jl.clear(jst), tl.clear(tst)
    _assert_same_state(spec, tspec, jc, tc)
    assert int(tc.min_depth) == 2 and bool(tc.sorted)


# name: (object batches as index ranges, capacity in cells per object,
# start from a JAX build of the first batch, scene with objects outside)
EXTEND_CASES = {
    "one_batch": ([(0, N)], 8, False, False),
    "batches": ([(0, 150), (150, 151), (151, N)], 8, False, False),
    "onto_sorted": ([(0, 200), (200, N)], 8, True, False),
    "outside": ([(0, 250), (250, N)], 8, False, True),
    "overflow": ([(0, 150), (150, N)], 2, False, False),
    "empty_batch": ([(0, 200), (200, 200)], 8, True, False),
}


# every case on Index64_3D, two of them on the 2D specs
EXTEND_PARAMS = [pytest.param(*SPECS[2], case, id=f"Index64_3D-{case}")
                 for case in EXTEND_CASES] + [
    pytest.param(*sp, case, id=f"{sp[0].name}-{case}")
    for sp in SPECS[:2] for case in ("batches", "onto_sorted")]


@pytest.mark.parametrize("spec,tspec,case", EXTEND_PARAMS)
def test_extend_matches_jax(spec, tspec, case):
    """The unsorted tree slot for slot, and sorted, invalid_count and
    overflow, after each batch."""
    batches, per_obj, from_build, outside = EXTEND_CASES[case]
    smin, smax, bmin, bmax, ids = _scene(spec.dim, outside=outside)
    cap = per_obj * N
    lo, hi = batches[0]
    if from_build:
        jst = _grow(spec, jl.build(spec, smin, smax, bmin[lo:hi],
                                   bmax[lo:hi], ids[lo:hi]), cap)
        batches = batches[1:]
    else:
        jst = jl.make_layer(spec, cap)
    tst = _port(spec, tspec, jst)
    for lo, hi in batches:
        args = (smin, smax, bmin[lo:hi], bmax[lo:hi], ids[lo:hi])
        jst = jl.extend(spec, jst, *args)
        tst = tl.extend(tspec, tst, *args)
        _assert_same_state(spec, tspec, jst, tst)
    assert bool(tst.sorted) == (case == "empty_batch")
    assert bool(tst.overflow) == (case == "overflow")
    assert (int(tst.invalid_count) > 0) == outside


def test_extend_min_depth_and_wide_slots():
    """extend emits at the layer's min_depth; slots_per_axis 3."""
    spec, tspec = SPECS[2]
    smin, smax, bmin, bmax, ids = _scene(3)
    jst = jl.make_layer(spec, 27 * N, min_depth=5)
    tst = tl.make_layer(tspec, 27 * N, min_depth=5, device="cpu")
    jst = jl.extend(spec, jst, smin, smax, bmin, bmax, ids, 3)
    tst = tl.extend(tspec, tst, smin, smax, bmin, bmax, ids, 3)
    _assert_same_state(spec, tspec, jst, tst)
    assert int(tst.count) > 8 * N


@pytest.mark.parametrize("spec,tspec", SPECS, ids=SPEC_IDS)
def test_build_equals_clear_extend_sort(spec, tspec):
    smin, smax, bmin, bmax, ids = _scene(spec.dim, outside=True)
    built = tl.build(tspec, smin, smax, bmin, bmax, ids,
                     out_capacity=8 * N, device="cpu")
    layer = tl.clear(built)
    layer = tl.extend(tspec, layer, smin, smax, bmin[:123], bmax[:123],
                      ids[:123])
    layer = tl.extend(tspec, layer, smin, smax, bmin[123:], bmax[123:],
                      ids[123:])
    assert not bool(layer.sorted)
    layer = tl.sort(tspec, layer)
    for f in ("keys", "ids", "aux"):
        assert torch.equal(getattr(layer, f), getattr(built, f)), f
    for f in ("count", "invalid_count", "overflow", "sorted"):
        assert int(getattr(layer, f)) == int(getattr(built, f)), f
    assert tl.layers_equal(tspec, layer, built)
    jst = _grow(spec, jl.build(spec, smin, smax, bmin, bmax, ids), 8 * N)
    _assert_same_state(spec, tspec, jst, layer)


# ---------------------------------------------------------------------------
# merge
# ---------------------------------------------------------------------------

def _halves(spec, sorted_, cap_a=8 * N, cap_b=8 * N, md_a=0, md_b=0,
            seed=0, split=N // 2):
    """Two JAX layers holding the scene's two halves: built (sorted) or
    extended (unsorted)."""
    smin, smax, bmin, bmax, ids = _scene(spec.dim, seed=seed)
    out = []
    for (lo, hi), cap, md in (((0, split), cap_a, md_a),
                              ((split, N), cap_b, md_b)):
        part = (bmin[lo:hi], bmax[lo:hi], ids[lo:hi])
        if sorted_:
            built = jl.build(spec, smin, smax, *part, min_depth=md,
                             out_capacity=min(cap, (hi - lo) * 2 ** spec.dim))
            out.append(_grow(spec, built, cap))
        else:
            st = jl.make_layer(spec, cap, min_depth=md)
            out.append(jl.extend(spec, st, smin, smax, *part))
    return out


def _assert_same_merge(spec, tspec, jm, tm, sorted_path):
    """Keys, ids, count and flags exact; aux exact where (key, id) is
    unique (on the append path, everywhere)."""
    _assert_same_state(spec, tspec, jm, tm, aux=False)
    assert tl.layers_equal(tspec, tm, _port(spec, tspec, jm))
    got = tm.aux.numpy().astype(np.uint32)
    want = np.asarray(jm.aux)
    if sorted_path:
        cnt = int(tm.count)
        k = convert.layer_state_to_numpy(tspec, tm)
        pairs = np.stack([*k["keys"], k["ids"]], axis=1)[:cnt]
        _, first, counts = np.unique(pairs, axis=0, return_index=True,
                                     return_counts=True)
        uniq = np.zeros(len(got), bool)
        uniq[first[counts == 1]] = True
        uniq[cnt:] = True
        got, want = got[uniq], want[uniq]
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("spec,tspec", SPECS, ids=SPEC_IDS)
@pytest.mark.parametrize("sorted_", [True, False], ids=["sorted", "append"])
def test_merge_matches_jax(spec, tspec, sorted_):
    ja, jb = _halves(spec, sorted_)
    ta, tb = _port(spec, tspec, ja), _port(spec, tspec, jb)
    jm, tm = jl.merge(spec, ja, jb), tl.merge(tspec, ta, tb)
    _assert_same_merge(spec, tspec, jm, tm, sorted_)
    assert bool(tm.sorted) == sorted_
    # the merged tree is the whole scene's tree, and scans to its pairs
    smin, smax, bmin, bmax, ids = _scene(spec.dim)
    whole = tl.build(tspec, smin, smax, bmin, bmax, ids,
                     out_capacity=8 * N, device="cpu")
    sm = tl.sort(tspec, tm)
    for f in ("keys", "ids", "aux"):
        assert torch.equal(getattr(sm, f), getattr(whole, f)), f
    _, got = tl.scan(tspec, tm, 24 * N, emit_capacity=64 * N)
    _, want = tl.scan(tspec, whole, 24 * N, emit_capacity=64 * N)
    assert not bool(got.overflow)
    np.testing.assert_array_equal(tl.scan_result_to_numpy(got),
                                  tl.scan_result_to_numpy(want))


def test_merge_ties_on_key_and_id():
    """Merging a sorted layer with itself: every (key, id) appears twice,
    with equal aux, so the result equals the JAX merge in full."""
    spec, tspec = SPECS[2]
    ja, _ = _halves(spec, True)
    ta = _port(spec, tspec, ja)
    jm, tm = jl.merge(spec, ja, ja), tl.merge(tspec, ta, ta)
    _assert_same_state(spec, tspec, jm, tm)
    assert int(tm.count) == 2 * int(ta.count)


@pytest.mark.parametrize("state_sorted", [True, False])
@pytest.mark.parametrize("other_sorted", [True, False])
def test_merge_an_empty_other(state_sorted, other_sorted):
    """An empty other leaves the tree; the layer stays sorted iff it
    was."""
    spec, tspec = SPECS[2]
    ja, _ = _halves(spec, state_sorted)
    empty = dict(_jax_fields(spec, jl.make_layer(spec, 64)),
                 sorted=np.bool_(other_sorted))
    ta = _port(spec, tspec, ja)
    jb = _jax_state(spec, empty)
    tb = convert.layer_state_from_jax(tspec, empty)
    jm, tm = jl.merge(spec, ja, jb), tl.merge(tspec, ta, tb)
    _assert_same_merge(spec, tspec, jm, tm, state_sorted and other_sorted)
    assert bool(tm.sorted) == state_sorted


@pytest.mark.parametrize("sorted_", [True, False], ids=["sorted", "append"])
def test_merge_different_min_depths(sorted_, caplog):
    spec, tspec = SPECS[2]
    ja, jb = _halves(spec, sorted_, md_a=3, md_b=1)
    ta, tb = _port(spec, tspec, ja), _port(spec, tspec, jb)
    jm = jl.merge(spec, ja, jb)
    with caplog.at_level(logging.WARNING, logger="broadphase_tpu_torch"):
        tm = tl.merge(tspec, ta, tb)
    assert "different min_depth (3 != 1)" in caplog.text
    _assert_same_merge(spec, tspec, jm, tm, sorted_)
    assert int(tm.min_depth) == 1


@pytest.mark.parametrize("sorted_", [True, False], ids=["sorted", "append"])
def test_merge_overflow(sorted_):
    """The state's capacity below the sum: the first cells are kept, the
    count is capped and overflow set."""
    spec, tspec = SPECS[2]
    ja, jb = _halves(spec, sorted_, cap_a=3 * N)
    ta, tb = _port(spec, tspec, ja), _port(spec, tspec, jb)
    jm, tm = jl.merge(spec, ja, jb), tl.merge(tspec, ta, tb)
    assert int(ta.count) + int(tb.count) > tl.capacity_of(ta)
    _assert_same_merge(spec, tspec, jm, tm, sorted_)
    assert bool(tm.overflow) and int(tm.count) == tl.capacity_of(ta)


# ---------------------------------------------------------------------------
# scan_filtered / nested_ids / scan_auto
# ---------------------------------------------------------------------------

def _filter_torch(a, b):
    return (a + b) % 3 != 0


def _filter_jax(a, b):
    return (a + b) % 3 != 0


@pytest.mark.parametrize("spec,tspec", SPECS, ids=SPEC_IDS)
@pytest.mark.parametrize("expand", ["v3", "v2"])
def test_scan_filtered_matches_jax(spec, tspec, expand):
    """canonical=True against JAX (and the C++ oracle's pairs, filtered
    in numpy, for Index64_3D); canonical=False in emission order (v3) or
    as a set (v2, which keeps duplicate emissions)."""
    scene = _scene(spec.dim, outside=True)
    jst = jl.build(spec, *scene, out_capacity=8 * N)
    tst = tl.build(tspec, *scene, out_capacity=8 * N, device="cpu")
    pair_cap, emit_cap = 40 * N, 64 * N
    for canonical in (True, False):
        _, jres = jl.scan_filtered(spec, jst, pair_cap, _filter_jax,
                                   emit_cap, False, canonical)
        _, tres = tl.scan_filtered(tspec, tst, pair_cap, _filter_torch,
                                   emit_cap, canonical=canonical,
                                   expand=expand)
        if canonical or expand == "v3":
            _assert_same_scan(jres, tres)
        else:
            got = np.unique(tl.scan_result_to_numpy(tres), axis=0)
            np.testing.assert_array_equal(
                got, np.unique(_pairs(jres), axis=0))
    if spec.name == "Index64_3D":
        keys, ids, _ = native.extend(*scene)
        keys, ids = native.sort_tree(keys, ids)
        want = native.scan_seq(keys, ids)
        want = want[(want[:, 0].astype(np.int64) + want[:, 1]) % 3 != 0]
        _, tres = tl.scan_filtered(tspec, tst, pair_cap, _filter_torch,
                                   emit_cap, expand=expand)
        np.testing.assert_array_equal(tl.scan_result_to_numpy(tres), want)


def test_layer_builder_scan_filtered_and_test_capacity():
    spec, tspec = SPECS[2]
    scene = _scene(3)
    lb = LayerBuilder(index_capacity=8 * N, collision_capacity=40 * N,
                      test_capacity=77)
    jlb = jl.LayerBuilder(index_capacity=8 * N, collision_capacity=40 * N,
                          test_capacity=77)
    assert lb.test_capacity == jlb.test_capacity == 77
    assert LayerBuilder().test_capacity == jl.LayerBuilder().test_capacity
    _, tres = lb.scan_filtered(tspec, lb.build(tspec, *scene, device="cpu"),
                               _filter_torch)
    _, jres = jlb.scan_filtered(spec, jlb.build(spec, *scene), _filter_jax)
    _assert_same_scan(jres, tres)


def _nested_fuzz_scene():
    """tests/test_fuzz_pipeline.py::test_nested_same_id_skip_rule: id 7
    at two nested sizes, id 3 overlapping only the inner one, id 9 the
    outer one."""
    smin = np.zeros(3, np.float32)
    smax = np.full(3, 64.0, np.float32)
    bmin = np.array([[1.0, 1.0, 1.0], [4.0, 4.0, 4.0], [4.5, 4.5, 4.5],
                     [2.0, 2.0, 2.0]], np.float32)
    bmax = np.array([[31.0, 31.0, 31.0], [6.0, 6.0, 6.0],
                     [6.5, 6.5, 6.5], [32.0, 32.0, 32.0]], np.float32)
    return smin, smax, bmin, bmax, np.array([7, 7, 3, 9], np.uint32)


def _nested_depths_scene():
    """tests/test_emit_once.py::test_exactly_once_mixed_depths_nested:
    large shallow boxes over many small deep ones, with every id given
    twice (the scene, and each box again grown by 0.5 on every side)."""
    smin = np.zeros(3, np.float32)
    smax = np.full(3, 64.0, np.float32)
    rng = np.random.default_rng(3)
    big_lo = rng.uniform(0, 30, size=(6, 3)).astype(np.float32)
    big_hi = big_lo + rng.uniform(15, 30, size=(6, 3)).astype(np.float32)
    big_hi = np.minimum(big_hi, 63.999).astype(np.float32)
    small_lo = rng.uniform(0, 62, size=(150, 3)).astype(np.float32)
    small_hi = small_lo + rng.uniform(0.2, 1.5, size=(150, 3)).astype(
        np.float32)
    small_hi = np.minimum(small_hi, 63.999).astype(np.float32)
    lo = np.concatenate([big_lo, small_lo])
    hi = np.concatenate([big_hi, small_hi])
    ids = np.arange(len(lo), dtype=np.uint32)
    grown_lo = np.maximum(lo - 0.5, 0.0).astype(np.float32)
    grown_hi = np.minimum(hi + 0.5, 63.999).astype(np.float32)
    return (smin, smax, np.concatenate([lo, grown_lo]),
            np.concatenate([hi, grown_hi]), np.concatenate([ids, ids]))


def _nested_concentric_scene():
    """Every id again at a larger concentric box (the sharded nested_ids
    check of __graft_entry__.py)."""
    smin, smax, bmin, bmax, ids = _scene(3, 300, seed=7)
    pad = 2.0
    b2min = np.concatenate([bmin, np.maximum(bmin - pad, smin + 1.0)])
    b2max = np.concatenate([bmax, np.minimum(bmax + pad, smax - 1.0)])
    return (smin, smax, b2min.astype(np.float32), b2max.astype(np.float32),
            np.concatenate([ids, ids]).astype(np.uint32))


@pytest.mark.parametrize("make", [_nested_fuzz_scene, _nested_depths_scene,
                                  _nested_concentric_scene],
                         ids=["fuzz_pipeline", "emit_once_depths",
                              "concentric"])
def test_nested_ids_matches_jax_and_oracle(make):
    spec, tspec = SPECS[2]
    scene = make()
    n = len(scene[4])
    jst = jl.build(spec, *scene)
    tst = tl.build(tspec, *scene, device="cpu")
    cap = max(64 * n, 4096)
    for canonical in (True, False):
        _, jres = jl.scan(spec, jst, cap, None, True, canonical)
        _, tres = tl.scan(tspec, tst, cap, nested_ids=True,
                          canonical=canonical)
        _assert_same_scan(jres, tres)
    keys, ids, _ = native.extend(*scene)
    keys, ids = native.sort_tree(keys, ids)
    want = native.scan_seq(keys, ids, pair_slack=64)
    _, tres = tl.scan(tspec, tst, cap, nested_ids=True)
    np.testing.assert_array_equal(tl.scan_result_to_numpy(tres), want)
    # the skip fired: without it the pair list differs
    _, plain = tl.scan(tspec, tst, cap)
    assert not np.array_equal(tl.scan_result_to_numpy(plain), want)


def test_nested_ids_on_a_merged_layer():
    """Merged layers sharing ids: the same objects in two layers, one at
    min_depth 3."""
    spec, tspec = SPECS[2]
    smin, smax, bmin, bmax, ids = _scene(3, 300, seed=9)
    ja = jl.build(spec, smin, smax, bmin, bmax, ids, out_capacity=40 * 300)
    jb = jl.build(spec, smin, smax, bmin + 0.25, bmax + 0.25, ids,
                  min_depth=3)
    jm = jl.merge(spec, ja, jb)
    tm = tl.merge(tspec, _port(spec, tspec, ja), _port(spec, tspec, jb))
    _, jres = jl.scan(spec, jm, 64 * 600, None, True)
    _, tres = tl.scan(tspec, tm, 64 * 600, nested_ids=True)
    _assert_same_scan(jres, tres)
    keys, tids, _ = tl.tree_to_numpy(tspec, tm)
    want = joracle.scan(spec, keys, tids)
    assert tl.scan_result_to_numpy(tres).tolist() == [list(p) for p in want]


@pytest.mark.parametrize("filtered", [False, True])
def test_scan_auto_matches_jax(filtered):
    """The same final capacity (1024 doubled until no overflow) and the
    same pairs."""
    spec, tspec = SPECS[2]
    scene = _scene(3, 500, seed=2)
    jst = jl.build(spec, *scene, out_capacity=8 * 500)
    tst = tl.build(tspec, *scene, out_capacity=8 * 500, device="cpu")
    fj, ft = (_filter_jax, _filter_torch) if filtered else (None, None)
    _, jres = jl.scan_auto(spec, jst, initial_capacity=1000, filter_fn=fj)
    _, tres = tl.scan_auto(tspec, tst, initial_capacity=1000, filter_fn=ft)
    assert tres.pairs_a.shape[0] > 1024
    _assert_same_scan(jres, tres)
    with pytest.raises(RuntimeError, match="pair_capacity=2048"):
        tl.scan_auto(tspec, tst, initial_capacity=1000, max_doublings=1)
