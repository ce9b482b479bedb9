"""Port parity for the slice: broadphase_tpu_torch.layer build + scan against
broadphase_tpu.layer (its default CPU path) and the C++ oracle
(``native``: extend -> sort_tree -> scan_seq).

Trees (keys, ids, aux, count, invalid_count, overflow) and pair lists
(canonical=True, and canonical=False in emission order) are compared
exactly.  Also: undersized capacities, wide ids, a JAX-built tree carried
across with ``convert``, and the device-dispatch rule of the kernels.
"""

import numpy as np
import pytest
import torch

import bench
from broadphase_tpu import index as bidx
from broadphase_tpu import layer as jl
from broadphase_tpu.utils import native
from broadphase_tpu_torch import LayerBuilder, bench_caps, convert, profiling
from broadphase_tpu_torch import index as tidx
from broadphase_tpu_torch import layer as tl
from broadphase_tpu_torch.ops import (build, compact, expand, expand2, merge,
                                      prep, runends)

from test_torch_index import jax_keys_np

N = 1500
CAPS = (8 * N, 40 * N, 64 * N)          # tree, pair, emit


def _scene(kind, dim=3, n=N):
    smin, smax, bmin, bmax, ids = bench._scene(dim, n)
    bmin, bmax = bmin.copy(), bmax.copy()
    if kind == "depth0":                 # one box is the whole system
        bmin[0], bmax[0] = smin, smax
    elif kind == "outside":              # some boxes leave the system box
        bmin[:100] -= 30.0
        bmax[100:200] += 500.0
    return smin, smax, bmin, bmax, ids


def _jax_step(spec, scene, tree_cap, pair_cap, emit_cap, canonical):
    st = jl.build(spec, *scene, out_capacity=tree_cap)
    return jl.scan(spec, st, pair_cap, emit_capacity=emit_cap,
                   canonical=canonical)


def _torch_step(tspec, scene, tree_cap, pair_cap, emit_cap, canonical):
    st = tl.build(tspec, *scene, out_capacity=tree_cap, device="cpu")
    return tl.scan(tspec, st, pair_cap, emit_capacity=emit_cap,
                   canonical=canonical)


def _pairs_jax(res):
    cnt = int(res.count)
    return np.stack([np.asarray(res.pairs_a)[:cnt],
                     np.asarray(res.pairs_b)[:cnt]], axis=1)


def _assert_tree_equal(spec, tspec, jst, tst, aux=True):
    assert int(tst.count) == int(jst.count)
    assert int(tst.invalid_count) == int(jst.invalid_count)
    assert bool(tst.overflow) == bool(jst.overflow)
    cnt = int(jst.count)
    np.testing.assert_array_equal(tidx.keys_to_numpy(tspec, tst.keys[:cnt]),
                                  jax_keys_np(spec, jst.keys)[:cnt])
    np.testing.assert_array_equal(tst.ids[:cnt].numpy().astype(np.uint32),
                                  np.asarray(jst.ids)[:cnt])
    if aux:
        np.testing.assert_array_equal(tst.aux[:cnt].numpy().astype(np.uint32),
                                      np.asarray(jst.aux)[:cnt])


def _assert_scan_equal(jres, tres):
    assert int(tres.count) == int(jres.count)
    assert bool(tres.overflow) == bool(jres.overflow)
    np.testing.assert_array_equal(tl.scan_result_to_numpy(tres),
                                  _pairs_jax(jres))


def test_bench_scene_matches_bench_generator():
    for got, want in zip(bench_caps.bench_scene(3, 2000),
                         bench._scene(3, 2000)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["bench", "depth0", "outside"])
def test_slice_matches_jax_and_oracle(kind):
    spec, tspec = bidx.Index64_3D, tidx.Index64_3D
    scene = _scene(kind)
    for canonical in (True, False):
        jst, jres = _jax_step(spec, scene, *CAPS, canonical)
        tst, tres = _torch_step(tspec, scene, *CAPS, canonical)
        _assert_tree_equal(spec, tspec, jst, tst)
        _assert_scan_equal(jres, tres)
        assert not bool(tres.overflow)
    assert (int(tst.invalid_count) > 0) == (kind == "outside")

    keys, ids, _ = native.extend(*scene)
    keys, ids = native.sort_tree(keys, ids)
    tkeys, tids, _ = tl.tree_to_numpy(tspec, tst)
    np.testing.assert_array_equal(tkeys, keys)
    np.testing.assert_array_equal(tids, ids)
    _, tres = _torch_step(tspec, scene, *CAPS, True)
    np.testing.assert_array_equal(tl.scan_result_to_numpy(tres),
                                  native.scan_seq(keys, ids))


@pytest.mark.parametrize("caps", [(2 * N, 40 * N, 64 * N),   # tree
                                  (8 * N, 4 * N, 4 * N),     # emission
                                  (8 * N, N, 64 * N)])       # pairs
def test_undersized_capacities(caps):
    spec, tspec = bidx.Index64_3D, tidx.Index64_3D
    scene = _scene("bench")
    for canonical in (True, False):
        jst, jres = _jax_step(spec, scene, *caps, canonical)
        tst, tres = _torch_step(tspec, scene, *caps, canonical)
        _assert_tree_equal(spec, tspec, jst, tst)
        _assert_scan_equal(jres, tres)
        assert bool(tres.overflow)


@pytest.mark.parametrize("offset", [(1 << 24) - 700, (1 << 29) + 5])
def test_wide_ids(offset):
    """Live ids reaching 2^24 - 1 turn the emit-once rule off (every
    emission survives to the canonical dedup); ids reaching 2^29 - 1 also
    drop the aux bits.  canonical=True output equals JAX's; emission order
    also does once aux is dropped, where JAX keeps every emission too."""
    spec, tspec = bidx.Index64_3D, tidx.Index64_3D
    smin, smax, bmin, bmax, ids = _scene("bench")
    scene = (smin, smax, bmin, bmax, ids + np.uint32(offset))
    caps = (8 * N, 64 * N, 64 * N)
    jst, jres = _jax_step(spec, scene, *caps, True)
    tst, tres = _torch_step(tspec, scene, *caps, True)
    _assert_tree_equal(spec, tspec, jst, tst)
    _assert_scan_equal(jres, tres)
    if offset > (1 << 29):
        assert int(tst.aux.abs().sum()) == 0
        _, jres = _jax_step(spec, scene, *caps, False)
        _, tres = _torch_step(tspec, scene, *caps, False)
        _assert_scan_equal(jres, tres)


@pytest.mark.parametrize("name", ["Index64_2D", "Index32_2D"])
def test_2d_specs_match_jax(name):
    spec, tspec = getattr(bidx, name), getattr(tidx, name)
    scene = bench._scene(2, 800)
    caps = (8 * 800, 40 * 800, 64 * 800)
    for canonical in (True, False):
        jst, jres = _jax_step(spec, scene, *caps, canonical)
        tst, tres = _torch_step(tspec, scene, *caps, canonical)
        _assert_tree_equal(spec, tspec, jst, tst)
        _assert_scan_equal(jres, tres)


def _jax_fields(spec, st):
    return {"keys": tuple(np.asarray(c) for c in
                          bidx.sort_operands(spec, st.keys)),
            **{f: np.asarray(getattr(st, f)) for f in
               ("ids", "aux", "count", "sorted", "min_depth",
                "invalid_count", "overflow")}}


def test_jax_built_tree_scans_the_same_in_the_port():
    spec, tspec = bidx.Index64_3D, tidx.Index64_3D
    scene = _scene("depth0")
    jst, jres = _jax_step(spec, scene, *CAPS, True)
    fields = _jax_fields(spec, jst)
    state = convert.layer_state_from_jax(tspec, fields)
    back = convert.layer_state_to_numpy(tspec, state)
    for k in fields:
        if k == "keys":
            for a, b in zip(back[k], fields[k]):
                np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_array_equal(back[k], fields[k], err_msg=k)
    _, tres = tl.scan(tspec, state, CAPS[1], emit_capacity=CAPS[2])
    _assert_scan_equal(jres, tres)

    # an unsorted state is sorted first, to the same tree
    perm = np.random.default_rng(0).permutation(len(fields["ids"]))
    shuffled = dict(fields, sorted=np.bool_(False),
                    keys=tuple(c[perm] for c in fields["keys"]),
                    ids=fields["ids"][perm], aux=fields["aux"][perm])
    sst, sres = tl.scan(tspec, convert.layer_state_from_jax(tspec, shuffled),
                        CAPS[1], emit_capacity=CAPS[2])
    assert bool(sst.sorted)
    assert torch.equal(sst.keys, state.keys)
    _assert_scan_equal(jres, sres)


def test_layer_builder_and_empty_layer():
    tspec = tidx.Index64_3D
    scene = _scene("bench")
    lb = LayerBuilder(index_capacity=CAPS[0], collision_capacity=CAPS[1])
    st = lb.build(tspec, *scene, device="cpu")
    _, res = lb.scan(tspec, st)
    _, want = _torch_step(tspec, scene, CAPS[0], CAPS[1], None, True)
    np.testing.assert_array_equal(tl.scan_result_to_numpy(res),
                                  tl.scan_result_to_numpy(want))
    empty = lb.empty(tspec, device="cpu")
    _, res = lb.scan(tspec, empty)
    assert int(res.count) == 0 and not bool(res.overflow)
    _, res = tl.scan(tspec, tl.make_layer(tspec, 0, device="cpu"), 64)
    assert int(res.count) == 0 and res.pairs_a.shape == (64,)


def _meta_args(name):
    """(wrapper, its arguments on the meta device, the launch counter its
    kernel adds to)."""
    m = "meta"

    def z(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=m)

    i64, i32 = torch.int64, torch.int32
    fn, args = {
        "emit_build": (build.emit_build, (tidx.Index64_3D, z((4, 3), i64),
                                          z((4, 3), i64),
                                          z(4, torch.bool), z(4, i64), 0, 32)),
        "run_ends": (runends.scan_pass1, (tidx.Index64_3D, z(4, i64),
                                          z(4, i32))),
        "prep_runs": (prep.prep_runs, (z(4, i32), z(4, i64), z(4, i32),
                                       z((), i64))),
        "prep_runs_no_meta": (prep.prep_runs, (z(4, i32), z(4, i64), None,
                                               z((), i64))),
        "expand_pairs_prepped": (expand2.expand_pairs_prepped,
                                 (z(4, i64), z(4, i32), z(4, i64), z(4, i64),
                                  z(4, i64), z(4, i32), z((), i64),
                                  z((), i64), 16, z((), torch.bool), 3)),
        "stream_compact": (compact.stream_compact,
                           (z(4, torch.bool), (z(4, i64),))),
        "merge_cancel_compact": (merge.merge_cancel_compact,
                                 (z(4, i64), z(4, i64), z(2, i64), z(2, i64),
                                  z((), i64), 4)),
        "expand_pairs": (expand.expand_pairs,
                         (z(4, i64), z(4, i64), z(4, i64), z((), i64), 16)),
        "expand_pairs_entries": (expand.expand_pairs_entries,
                                 (z(4, i64), z(4, i64), z(4, i64), z(4, i64),
                                  z((), i64), z((), i64), 16)),
    }[name]
    counter = {build.emit_build: "k1", runends.scan_pass1: "k2",
               prep.prep_runs: "k3", expand2.expand_pairs_prepped: "k4",
               compact.stream_compact: "k5", merge.merge_cancel_compact: "k6",
               expand.expand_pairs: "k7", expand.expand_pairs_entries: "k7"}
    return fn, args, counter[fn] + ".launches"


@pytest.mark.parametrize("name", ["emit_build", "run_ends", "prep_runs",
                                  "prep_runs_no_meta",
                                  "expand_pairs_prepped", "stream_compact",
                                  "merge_cancel_compact", "expand_pairs",
                                  "expand_pairs_entries"])
def test_kernel_wrappers_dispatch_on_device(name):
    """A tensor not on the CPU goes to the kernel, which refuses anything
    but a CUDA tensor: no silent plain path, and, with the port's counters
    on, no launch counted."""
    fn, args, counter = _meta_args(name)
    assert counter in profiling.COUNTERS
    with profiling.tracing():
        profiling.counters()
        with pytest.raises(ValueError, match="CUDA"):
            fn(*args)
        assert profiling.counters() == {}
