"""Port parity: the scene generator and the host-side cell geometry.

``broadphase_tpu_torch.gen.gen_boxes`` against
``broadphase_tpu.utils.gen.gen_boxes`` bit for bit (both forms: count +
density, and bounds + density); ``geom.to_global`` and
``geom.bounds_center`` against the JAX package's (f32, tolerance 0); the
tools' ``cells`` helpers against ``broadphase_tpu.utils.oracle``
(integers exactly, rectangles bit for bit).
"""

import numpy as np
import pytest
import torch

from broadphase_tpu import geom as jgeom
from broadphase_tpu.index import Index32_2D as J32, Index64_3D as J64
from broadphase_tpu.utils import gen as jgen
from broadphase_tpu.utils import oracle
from broadphase_tpu_torch import cells, gen, geom
from broadphase_tpu_torch.index import Index32_2D, Index64_3D


def _assert_same_scene(got, want):
    for field in ("system_min", "system_max", "bounds_min", "bounds_max",
                  "ids"):
        g, w = getattr(got, field), getattr(want, field)
        assert g.dtype == w.dtype and g.shape == w.shape, field
        assert g.tobytes() == w.tobytes(), field


@pytest.mark.parametrize("count,density,size,seed", [
    (1, 0.001, (1.0, 10.0), 0),
    (200, 0.001, (1.0, 10.0), 0),
    (10_000, 0.001, (1.0, 10.0), 0),
    (3_000, 0.01, (0.5, 2.0), 7),
    (777, 1.0 / 64, (2.0, 3.0), 123456789),
])
def test_gen_boxes_bit_identical(count, density, size, seed):
    got = gen.gen_boxes(count=count, density=density, size_range=size,
                        seed=seed)
    want = jgen.gen_boxes(count=count, density=density, size_range=size,
                          seed=seed)
    _assert_same_scene(got, want)
    assert len(got.layer.ids) == 0 and got.collisions.shape == (0, 2)


def test_gen_boxes_bounds_form_bit_identical():
    bounds = (np.array([-10.0, 0.0, 5.0], np.float32),
              np.array([90.0, 40.0, 65.0], np.float32))
    got = gen.gen_boxes(density=0.002, system_bounds=bounds, seed=3)
    want = jgen.gen_boxes(density=0.002, system_bounds=bounds, seed=3)
    _assert_same_scene(got, want)
    with pytest.raises(ValueError):
        gen.gen_boxes(count=10, density=1e6, size_range=(1.0, 10.0))


def test_chacha_stream_matches():
    for seed in (0, 1, 2 ** 63 + 5):
        assert gen.seed_from_u64(seed) == jgen.seed_from_u64(seed)
        a, b = gen.ChaCha20Rng(seed), jgen.ChaCha20Rng(seed)
        assert [a.next_u32() for _ in range(50)] == \
            [b.next_u32() for _ in range(50)]
        assert a.gen_range_f32(1.0, 10.0) == b.gen_range_f32(1.0, 10.0)


def test_to_global_and_center_bit_identical():
    rng = np.random.default_rng(1)
    smin = np.array([-3.5, 0.0, 17.25], np.float32)
    smax = np.array([1000.0, 1e-3, 1e6], np.float32)
    pts = rng.integers(0, 1 << 32, (5000, 3), dtype=np.uint64)
    pts[:4] = [[0, 0, 0], [0xFFFF_FFFF] * 3, [0xFFFF_FF00] * 3,
               [1, 2, 3]]
    want = np.asarray(jgeom.to_global(smin, smax, pts.astype(np.uint32)))
    got = geom.to_global(torch.as_tensor(smin), torch.as_tensor(smax),
                         torch.as_tensor(pts.astype(np.int64))).numpy()
    assert got.dtype == np.float32
    assert got.tobytes() == want.tobytes()
    lo = rng.uniform(-100, 100, (5000, 3)).astype(np.float32)
    hi = (lo + rng.uniform(0, 50, (5000, 3))).astype(np.float32)
    want = np.asarray(jgeom.bounds_center(lo, hi))
    got = geom.bounds_center(torch.as_tensor(lo), torch.as_tensor(hi))
    assert got.numpy().tobytes() == want.tobytes()


@pytest.mark.parametrize("spec,jspec", [(Index64_3D, J64),
                                        (Index32_2D, J32)],
                         ids=["Index64_3D", "Index32_2D"])
def test_cell_helpers_match_the_oracle(spec, jspec):
    rng = np.random.default_rng(2)
    smin = np.zeros(spec.dim, np.float32)
    smax = np.full(spec.dim, 63.98, np.float32)
    keys = [0]
    for _ in range(300):
        origin = [int(v) for v in rng.integers(0, 1 << 32, spec.dim)]
        depth = int(rng.integers(0, spec.axis_bits + 1))
        origin = [oracle.truncate_to_depth(o, depth) if depth else 0
                  for o in origin]
        keys.append(oracle.make_key(jspec, origin, depth))
    for k in keys:
        assert cells.depth_of(spec, k) == oracle.depth_of(jspec, k)
        assert cells.origin_of(spec, k) == oracle.origin_of(jspec, k)
        d = cells.depth_of(spec, k)
        if d:
            assert cells.scale_at_depth(d) == oracle.scale_at_depth(d)
    for a, b in zip(keys, keys[1:] + keys[:1]):
        assert cells.overlaps(spec, a, b) == oracle.overlaps(jspec, a, b)
        assert cells.overlaps(spec, a, a)
    for k in keys:
        lo, hi = [0, 0], [0xFFFF_FFFF] * 2
        if oracle.depth_of(jspec, k):
            scale = oracle.scale_at_depth(oracle.depth_of(jspec, k))
            lo = list(oracle.origin_of(jspec, k)[:2])
            hi = [o + scale - 1 for o in lo]
        pad = [0] * (spec.dim - 2)
        want = [oracle.to_global(smin, smax, np.array(c + pad, np.uint32))
                for c in (lo, hi)]
        assert cells.cell_rect_xy(spec, k, smin, smax) == (
            float(want[0][0]), float(want[0][1]), float(want[1][0]),
            float(want[1][1]))
    with pytest.raises(ValueError):
        cells.scale_at_depth(0)
