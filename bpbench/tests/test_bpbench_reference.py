"""The NumPy reference against the C++ oracle (``native/``) and against
brute force."""

import ast
from pathlib import Path

import numpy as np
import pytest

from bpbench.reference import broadphase as ref
from broadphase_tpu_torch import bench_caps, oracle


def _packed(pairs):
    return (pairs[:, 0].astype(np.uint64) << np.uint64(32)) \
        | pairs[:, 1].astype(np.uint64)


@pytest.mark.parametrize("seed", [0, 7])
def test_build_and_scan_equal_the_cpp_oracle_at_30k(seed):
    smin, smax, bmin, bmax, ids = bench_caps.bench_scene(3, 30_000, seed)
    spec = ref.SPECS["Index64_3D"]
    tree = ref.build(spec, smin, smax, bmin, bmax, ids, 2, 0, 10 ** 9)
    keys, tids, _ = oracle.extend(smin, smax, bmin, bmax, ids)
    keys, tids = oracle.sort_tree(keys, tids)
    assert np.array_equal(tree.keys, keys)
    assert np.array_equal(tree.ids, tids.astype(np.int64))
    pairs = ref.scan(spec, tree, 10 ** 9, 10 ** 9)
    assert np.array_equal(pairs.packed, _packed(oracle.scan_seq(keys, tids)))
    assert not tree.overflow and not pairs.overflow


def _scene(dim, n, seed):
    rng = np.random.default_rng(seed)
    r = rng.uniform(0.004, 0.03, n).astype(np.float32)[:, None]
    pos = rng.uniform(0.05, 0.95, (n, dim)).astype(np.float32)
    return (np.zeros(dim, np.float32), np.ones(dim, np.float32), pos - r,
            pos + r)


@pytest.mark.parametrize("index,min_depth", [("Index32_2D", 4),
                                             ("Index64_2D", 0),
                                             ("Index64_3D", 0)])
def test_every_true_overlap_is_a_candidate(index, min_depth):
    spec = ref.SPECS[index]
    smin, smax, bmin, bmax = _scene(spec.dim, 1500, 3)
    tree = ref.build(spec, smin, smax, bmin, bmax, np.arange(1500), 2,
                     min_depth, 10 ** 9)
    pairs = ref.scan(spec, tree, 10 ** 9, 10 ** 9)
    a = (pairs.packed >> np.uint64(32)).astype(np.int64)
    b = (pairs.packed & np.uint64(0xFFFF_FFFF)).astype(np.int64)
    cand = set(zip(np.minimum(a, b).tolist(), np.maximum(a, b).tolist()))
    hit = np.all((bmin[:, None] <= bmax[None]) & (bmax[:, None]
                                                  >= bmin[None]), axis=-1)
    i, j = np.nonzero(np.triu(hit, 1))
    assert set(zip(i.tolist(), j.tolist())) <= cand
    assert len(cand) == pairs.count        # no pair in both orders here


def test_capacities_and_cell_overflow_are_flagged():
    spec = ref.SPECS["Index64_3D"]
    smin, smax, bmin, bmax, ids = bench_caps.bench_scene(3, 2000, 1)
    tree = ref.build(spec, smin, smax, bmin, bmax, ids, 2, 0, 10 ** 9)
    assert ref.build(spec, smin, smax, bmin, bmax, ids, 2, 0,
                     tree.count - 1).overflow
    # a min_depth far below the boxes' own forces more than 2 cells an axis
    assert ref.build(spec, smin, smax, bmin, bmax, ids, 2, 12,
                     10 ** 9).overflow
    pairs = ref.scan(spec, tree, 10 ** 9, 10 ** 9)
    assert ref.scan(spec, tree, pairs.count - 1, 10 ** 9).overflow
    assert ref.scan(spec, tree, 10 ** 9, pairs.emitted - 1).overflow
    assert not ref.scan(spec, tree, pairs.count, pairs.emitted).overflow


def test_bf16_rounds_to_nearest_even():
    x = np.array([1.0, 1.0 + 2 ** -8, 1.0 + 3 * 2 ** -8, 1.0 + 2 ** -9,
                  -2.5, 3.0e38], np.float32)
    got = ref.bf16(x)
    assert got.tolist() == [1.0, 1.0, 1.0 + 2 ** -6, 1.0, -2.5,
                            float(ref.bf16(np.float32([3.0e38]))[0])]
    assert np.all(np.abs(got - x) <= np.abs(x) * 2 ** -8)


def test_ray_circle_and_pick():
    pos = np.array([[0.5, 0.5], [0.5, 0.2], [0.9, 0.5]], np.float32)
    radius = np.array([0.1, 0.1, 0.05], np.float32)
    d = ref.ray_circle(pos, radius, [0.5, 1.0], [0.0, -1.0])
    assert d[0] == pytest.approx(0.4) and d[1] == pytest.approx(0.7)
    assert np.isinf(d[2])
    p = ref.pick(d, np.arange(3), [0, 0], [1, 1], pos - radius[:, None],
                 pos + radius[:, None], 2.0, False)
    assert p.found and p.obj_id == 0 and p.distance == pytest.approx(0.4)
    # ball 0 sticks out of this system box, so it is not in the tree
    p = ref.pick(d, np.arange(3), [0, 0], [1, 0.45], pos - radius[:, None],
                 pos + radius[:, None], 2.0, False)
    assert p.found and p.obj_id == 1 and p.distance == pytest.approx(0.7)


def test_reference_imports_numpy_only():
    for path in Path(ref.__file__).parent.glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] in ("numpy", "typing",
                                              "__future__"), (path, name)
