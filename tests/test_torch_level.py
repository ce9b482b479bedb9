"""A static level with moving objects, on the port's plain kernels at a
tiny size: a static layer built once, each frame's dynamic objects built
alone at their own capacity and merged into it (``layer.merge``), held to
the plain NumPy reference (``bpbench/reference/broadphase.py``) of the
union built at once, and its canonical scan to the reference's scan."""

import numpy as np
import pytest
import torch

from bpbench import caps, traffic
from bpbench.motions import walk_dynamic
from bpbench.reference import broadphase as ref
from bpbench.scenes import level
from broadphase_tpu_torch import index as tidx
from broadphase_tpu_torch import layer

SPEC = tidx.Index64_3D
N, STATIC = 3000, 1500
FRAMES = 4
# the level_1M configuration at bpbench/tests/conftest.py's tiny density
CONFIG = {"objects": N, "static_objects": STATIC, "dim": 3,
          "scene": {"kind": "level", "density": 2.4e-5, "size_min": 1.0,
                    "size_max": 10.0}}
UNION = caps.tree_capacity(N, 37)
DYNAMIC = caps.tree_capacity(N - STATIC, 37)
PAIRS, EMIT = caps.per_object(N, 9), caps.per_object(N, 16)


@pytest.fixture(scope="module")
def world():
    """The scene, ``FRAMES`` walked frames after it, and the static layer
    built once from frame 0 at the union's capacity."""
    scene = level.make(CONFIG, traffic.generator(2 ** 31 + 5, "cpu"), "cpu")
    ring = walk_dynamic.ring(scene, {"step": 0.5}, FRAMES + 1,
                             traffic.generator(9, "cpu"))
    static = _build(scene, ring["bounds_min"][0], ring["bounds_max"][0],
                    slice(0, STATIC), UNION)
    return scene, ring, static


def _build(scene, bmin, bmax, part, capacity):
    return layer.build(SPEC, scene.system_min_t, scene.system_max_t,
                       bmin[part], bmax[part], scene.ids[part],
                       out_capacity=capacity)


def _frame(world, k, dyn_capacity=DYNAMIC):
    scene, ring, static = world
    dyn = _build(scene, ring["bounds_min"][k], ring["bounds_max"][k],
                 slice(STATIC, N), dyn_capacity)
    return static, dyn


def _reference(world, k, capacity=UNION):
    scene, ring, _ = world
    return ref.build(ref.SPECS["Index64_3D"], scene.system_min,
                     scene.system_max, ring["bounds_min"][k].numpy(),
                     ring["bounds_max"][k].numpy(), np.arange(N), 2, 0,
                     capacity)


def _tree(state):
    n = int(state.count)
    return (state.keys[:n].numpy().astype(np.uint64), state.ids[:n].numpy(),
            n, bool(state.overflow))


@pytest.mark.parametrize("k", range(1, FRAMES + 1))
def test_the_merged_layer_is_the_unions_tree_and_scans_as_it(world, k):
    static, dyn = _frame(world, k)
    merged = layer.merge(SPEC, static, dyn)
    want = _reference(world, k)
    keys, ids, count, overflow = _tree(merged)
    assert not want.overflow and not overflow
    assert count == want.count
    assert np.array_equal(keys, want.keys) and np.array_equal(ids, want.ids)
    assert bool(merged.sorted) and merged.keys.shape[0] == UNION
    _, res = layer.scan(SPEC, merged, PAIRS, emit_capacity=EMIT)
    pairs = ref.scan(ref.SPECS["Index64_3D"], want, PAIRS, EMIT)
    n = int(res.count)
    got = ((res.pairs_a[:n].numpy().astype(np.uint64) << np.uint64(32))
           | res.pairs_b[:n].numpy().astype(np.uint64))
    assert not bool(res.overflow) and not pairs.overflow
    assert n == pairs.count and np.array_equal(got, pairs.packed)


def test_the_static_layer_is_not_changed_by_a_merge(world):
    static, dyn = _frame(world, 1)
    before = [t.clone() for t in static]
    layer.merge(SPEC, static, dyn)
    assert all(torch.equal(a, b) for a, b in zip(before, static))


@pytest.mark.parametrize("k", [1, FRAMES])
def test_the_merge_is_the_same_either_way_round(world, k):
    static, dyn = _frame(world, k, dyn_capacity=UNION)
    a = layer.merge(SPEC, static, dyn)
    b = layer.merge(SPEC, dyn, static)
    assert int(a.count) == int(b.count)
    assert torch.equal(a.keys, b.keys) and torch.equal(a.ids, b.ids)
    assert torch.equal(a.aux, b.aux)


def test_a_union_capacity_one_block_too_small_sets_overflow(world):
    scene, ring, _ = world
    count = _reference(world, 2).count
    small = -(-count // 1024) * 1024 - 1024
    static = _build(scene, ring["bounds_min"][0], ring["bounds_max"][0],
                    slice(0, STATIC), small)
    _, dyn = _frame(world, 2)
    merged = layer.merge(SPEC, static, dyn)
    want = _reference(world, 2, small)
    assert want.overflow and bool(merged.overflow)
    assert int(merged.count) == small and merged.keys.shape[0] == small
    # what fits is the union's tree cut at the capacity
    keys, ids, _, _ = _tree(merged)
    assert np.array_equal(keys, want.keys[:small])
    assert np.array_equal(ids, want.ids[:small])
