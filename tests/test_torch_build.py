"""Port parity: kernel 1, ops/build.py::emit_build.

The plain version against the JAX Pallas kernel (interpret mode) on the same
quantized objects.  Emission order is free on both sides, so the emitted
(key, id, aux) multisets are compared, with count and cell overflow; when
count exceeds out_capacity the kept subset depends on the order, and only
count and the flag are compared.  Exact throughout.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from broadphase_tpu import geom as jgeom
from broadphase_tpu.index import Index32_2D, Index64_2D, Index64_3D
from broadphase_tpu.ops.pallas_build import emit_build as jax_emit_build
from broadphase_tpu.utils import gen
from broadphase_tpu_torch import index as tidx
from broadphase_tpu_torch.ops import build as tbuild

from test_torch_index import jax_keys_np, torch_keys_np


def _quantized(smin, smax, bmin, bmax):
    lmin = np.asarray(jgeom.to_local(smin, smax, bmin))
    lmax = np.asarray(jgeom.to_local(smin, smax, bmax))
    contained = np.asarray(jgeom.bounds_contains(smin, smax, bmin, bmax))
    return lmin, lmax, contained


def _multiset(keys_u64, ids, aux):
    order = np.lexsort((aux, ids, keys_u64))
    return keys_u64[order], ids[order], aux[order]


def _compare(spec, smin, smax, bmin, bmax, ids, out_cap, min_depth=0,
             slots=2):
    tspec = getattr(tidx, spec.name)
    lmin, lmax, contained = _quantized(smin, smax, bmin, bmax)
    jk, ji, ja, jc, jo = jax_emit_build(
        spec, jnp.asarray(lmin), jnp.asarray(lmax), jnp.asarray(contained),
        jnp.asarray(ids), jnp.uint32(min_depth), out_cap,
        slots_per_axis=slots, interpret=True)
    tk, ti, ta, tc, to = tbuild.emit_build(
        tspec, torch.as_tensor(lmin.astype(np.int64)),
        torch.as_tensor(lmax.astype(np.int64)),
        torch.as_tensor(contained.copy()),
        torch.as_tensor(ids.astype(np.int64)), min_depth, out_cap, slots)
    assert int(tc) == int(jc)
    assert bool(to) == bool(jo)
    live = min(int(tc), out_cap)
    assert bool(torch.all(tk[live:] == tidx.PAD_KEY))
    if int(tc) > out_cap:
        return int(tc), bool(to)
    got = _multiset(torch_keys_np(tspec, tk[:live]),
                    ti[:live].numpy().astype(np.uint32),
                    ta[:live].numpy().astype(np.uint32))
    want = _multiset(jax_keys_np(spec, jk)[:live],
                     np.asarray(ji)[:live], np.asarray(ja)[:live])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    return int(tc), bool(to)


@pytest.mark.parametrize("out_factor,slots,min_depth", [
    pytest.param(4, 2, 0, id="4"), pytest.param(1, 2, 0, id="1"),
    pytest.param(27, 3, 0, id="slots3"),
    pytest.param(27, 3, 6, id="slots3-min_depth6")])
def test_generated_scene_3d(out_factor, slots, min_depth):
    """out_factor 1 leaves the tree below the cell count: overflow.  Three
    slots per axis with a raised min_depth emit objects three cells wide."""
    n = 2500
    sc = gen.gen_boxes(count=n, density=1.0 / 1000.0, seed=2)
    count, _ = _compare(Index64_3D, sc.system_min, sc.system_max,
                        sc.bounds_min, sc.bounds_max, sc.ids,
                        out_factor * n, min_depth, slots)
    assert (count > out_factor * n) == (out_factor == 1)


@pytest.mark.parametrize("spec,min_depth,slots", [
    pytest.param(Index32_2D, 4, 2, id="spec0-4"),
    pytest.param(Index64_2D, 0, 2, id="spec1-0"),
    pytest.param(Index64_2D, 12, 2, id="spec2-12"),
    pytest.param(Index64_2D, 0, 3, id="Index64_2D-0-slots3"),
    pytest.param(Index64_2D, 12, 3, id="Index64_2D-12-slots3")])
def test_2d_specs_min_depth(spec, min_depth, slots):
    """A raised min_depth makes the boxes need more cells per axis than
    the slots: the cell-overflow flag.  At three slots per axis they emit
    three cells along each axis."""
    rng = np.random.default_rng(0)
    n = 1500
    smin, smax = np.zeros(2, np.float32), np.ones(2, np.float32)
    r = rng.uniform(0.004, 0.01, n).astype(np.float32)
    p = rng.uniform(0.05, 0.95, (n, 2)).astype(np.float32)
    _, ovf = _compare(spec, smin, smax, p - r[:, None], p + r[:, None],
                      np.arange(n, dtype=np.uint32), slots ** 2 * n,
                      min_depth, slots)
    assert ovf == (min_depth == 12)


def test_invalid_and_depth0_objects():
    rng = np.random.default_rng(1)
    n = 600
    smin, smax = np.zeros(3, np.float32), np.full(3, 100.0, np.float32)
    bmin = rng.uniform(-20, 90, (n, 3)).astype(np.float32)
    bmax = (bmin + rng.uniform(0.5, 60, (n, 3))).astype(np.float32)
    bmin[0], bmax[0] = smin, smax                    # the whole system
    _compare(Index64_3D, smin, smax, bmin, bmax,
             np.arange(n, dtype=np.uint32), 8 * n)


def test_empty_build():
    count, ovf = _compare(Index64_3D, np.zeros(3, np.float32),
                          np.full(3, 10.0, np.float32),
                          np.zeros((0, 3), np.float32),
                          np.zeros((0, 3), np.float32),
                          np.zeros(0, np.uint32), 256)
    assert count == 0 and not ovf


@pytest.mark.parametrize("cut", [1, 2, 3])
def test_overflow_keeps_the_object_major_prefix(cut):
    """The cells come object by object, x-fastest, and a smaller
    out_capacity keeps a prefix of them: the contract the kernel keeps on
    the card too, slot for slot."""
    tspec = tidx.Index64_3D
    sc = gen.gen_boxes(count=700, density=1.0 / 1000.0, seed=4)
    lmin, lmax, contained = _quantized(sc.system_min, sc.system_max,
                                       sc.bounds_min, sc.bounds_max)
    args = (torch.as_tensor(lmin.astype(np.int64)),
            torch.as_tensor(lmax.astype(np.int64)),
            torch.as_tensor(contained.copy()),
            torch.arange(700, dtype=torch.int64))
    full = tbuild.emit_build(tspec, *args, 0, 8 * 700)
    count = int(full[3])
    ids = full[1][:count]
    assert bool(torch.all(ids[1:] >= ids[:-1]))
    out_cap = {1: 1, 2: count // 2, 3: count - 1}[cut]
    part = tbuild.emit_build(tspec, *args, 0, out_cap)
    assert int(part[3]) == count
    for got, want in zip(part[:3], full[:3]):
        assert torch.equal(got, want[:out_cap])
