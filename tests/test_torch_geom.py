"""Port parity: broadphase_tpu_torch.geom against broadphase_tpu.geom.

Quantization must be bit-identical (tolerance 0), including NaN, values
outside the system box and saturation at 0xFFFF_FF00; the depth and
cell-emission math is integer and compared exactly.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from broadphase_tpu import geom as jgeom
from broadphase_tpu_torch import geom as tgeom

from test_torch_index import SPEC_IDS, SPEC_PAIRS, jax_keys_np, torch_keys_np


def _u32(rng, shape):
    return rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)


def test_to_local_bit_identical():
    rng = np.random.default_rng(0)
    smin = np.array([-3.5, 0.0, 17.25], np.float32)
    smax = np.array([1000.0, 1e-3, 1e6], np.float32)
    pts = (smin + rng.uniform(-0.2, 1.2, (20000, 3))
           * (smax - smin)).astype(np.float32)
    special = np.array([
        smin, smax,                            # smax saturates at 0xFFFF_FF00
        np.nextafter(smax, np.float32(0)),            # just below the top
        smin - 1, smax + 1,                           # out of range
        [np.nan, np.inf, -np.inf],
        [np.float32(1e-30), -0.0, np.float32(3e38)],
    ], np.float32)
    pts = np.concatenate([special, pts]).astype(np.float32)
    want = np.asarray(jgeom.to_local(smin, smax, pts)).astype(np.int64)
    got = tgeom.to_local(torch.as_tensor(smin), torch.as_tensor(smax),
                         torch.as_tensor(pts)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.max() == tgeom.RANGE_MAX_U32
    assert got[1].tolist() == [tgeom.RANGE_MAX_U32] * 3


def test_bounds_contains_matches_jax():
    rng = np.random.default_rng(1)
    smin, smax = np.zeros(3, np.float32), np.full(3, 10.0, np.float32)
    bmin = rng.uniform(-1, 10, (500, 3)).astype(np.float32)
    bmax = (bmin + rng.uniform(0, 2, (500, 3))).astype(np.float32)
    bmin[0, 0] = np.nan
    want = np.asarray(jgeom.bounds_contains(smin, smax, bmin, bmax))
    got = tgeom.bounds_contains(*(torch.as_tensor(x) for x in
                                  (smin, smax, bmin, bmax))).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("spec,tspec", SPEC_PAIRS, ids=SPEC_IDS)
@pytest.mark.parametrize("min_depth", [0, 3])
def test_depth_and_truncation_match_jax(spec, tspec, min_depth):
    rng = np.random.default_rng(2 + min_depth)
    lmin = _u32(rng, (3000, spec.dim))
    span = rng.integers(0, 1 << rng.integers(0, 33, (3000, 1)),
                        dtype=np.uint64)
    lmax = ((lmin.astype(np.uint64) + span) & 0xFFFF_FFFF).astype(np.uint32)
    lmax[:100] = _u32(rng, (100, spec.dim))     # inverted boxes wrap
    want = np.asarray(jgeom.depth_for_bounds(spec, jnp.asarray(lmin),
                                             jnp.asarray(lmax), min_depth))
    got = tgeom.depth_for_bounds(tspec, torch.as_tensor(lmin.astype(np.int64)),
                                 torch.as_tensor(lmax.astype(np.int64)),
                                 min_depth)
    np.testing.assert_array_equal(got.numpy(), want)
    d = rng.integers(0, 33, lmin.shape[0]).astype(np.uint32)
    want_t = np.asarray(jgeom.truncate_to_depth(jnp.asarray(lmin[:, 0]),
                                                jnp.asarray(d)))
    got_t = tgeom.truncate_to_depth(
        torch.as_tensor(lmin[:, 0].astype(np.int64)),
        torch.as_tensor(d.astype(np.int64)))
    np.testing.assert_array_equal(got_t.numpy(), want_t)


@pytest.mark.parametrize("spec,tspec", SPEC_PAIRS, ids=SPEC_IDS)
@pytest.mark.parametrize("slots_per_axis,min_depth", [(2, 0), (2, 4), (3, 4)])
def test_emit_cells_matches_jax(spec, tspec, slots_per_axis, min_depth):
    """Keys, slot validity and cell overflow of the plain build version,
    over boxes from one cell wide to the whole system (depth 0 unless
    min_depth raises it; a raised depth makes big boxes overflow)."""
    rng = np.random.default_rng(4)
    n = 1500
    lmin = _u32(rng, (n, spec.dim))
    size = rng.integers(0, 1 << rng.integers(8, 33, (n, 1)), (n, spec.dim),
                        dtype=np.uint64)
    lmax = np.minimum(lmin.astype(np.uint64) + size,
                      0xFFFF_FF00).astype(np.uint32)
    lmin[0], lmax[0] = 0, 0xFFFF_FF00            # whole system: depth 0
    kj, vj, oj = jgeom.emit_cells(spec, jnp.asarray(lmin), jnp.asarray(lmax),
                                  min_depth, slots_per_axis)
    kt, vt, ot = tgeom.emit_cells(
        tspec, torch.as_tensor(lmin.astype(np.int64)),
        torch.as_tensor(lmax.astype(np.int64)), min_depth, slots_per_axis)
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))
    np.testing.assert_array_equal(torch_keys_np(tspec, kt.reshape(-1)),
                                  jax_keys_np(spec, kj).reshape(-1))
    assert bool(ot.any()) == (min_depth > 0)
