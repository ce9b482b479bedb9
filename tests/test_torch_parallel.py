"""Port parity: the sharded build + scan step,
broadphase_tpu_torch.parallel.make_sharded_step against
broadphase_tpu.parallel.make_sharded_step.

The port runs as 1, 2, 3 and 4 ranks of a CPU gloo group
(``parallel.run_ranks``), one spawn per world size for every case; JAX
runs on as many devices of the 8-device CPU mesh.  Compared exactly, rank
by rank: each rank's class of pairs lane for lane, ``shard_counts``,
``total_count``, ``invalid_count``, ``overflow`` and the gathered pair
list.  Cases: the three specs, objects outside the system box, a small
``bucket_capacity`` and ``exchange_capacity`` (overflow), ids either side
of 2^29 - 1 and up to 2^32 - 2 (the dedup hash), ``nested_ids`` and
``filter_fn``.  The gathered pairs also equal the C++ oracle at each world
size's effective ``min_depth``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from broadphase_tpu import index as bidx
from broadphase_tpu import parallel as jpar
from broadphase_tpu.utils import oracle
from broadphase_tpu_torch.parallel import run_ranks

import torch_rank_bodies as bodies

WORLDS = (1, 2, 3, 4)
N = 240                        # divides by every world size


def scene(spec, n, seed, lo=-60.0, hi=60.0):
    rng = np.random.default_rng(seed)
    dim = spec.dim
    size = rng.uniform(0.5, 9.0, size=(n, dim)).astype(np.float32)
    bmin = rng.uniform(lo, hi - 9.0, size=(n, dim)).astype(np.float32)
    ids = np.arange(n, dtype=np.uint32)
    return (np.full(dim, lo, np.float32), np.full(dim, hi, np.float32),
            bmin, (bmin + size).astype(np.float32), ids)


def mesh(world):
    return Mesh(np.array(jax.devices()[:world]), ("objects",))


def jax_filter_odd_sum(a, b):
    """``bodies.filter_odd_sum`` on JAX arrays."""
    return ((a + b) & 1) == 1


JAX_FILTERS = {"odd_sum": jax_filter_odd_sum}


def jax_config(cfg):
    cfg = dict(cfg)
    if "filter" in cfg:
        cfg["filter_fn"] = JAX_FILTERS[cfg.pop("filter")]
    return cfg


def _ids_scene(top):
    sc = scene(bidx.Index64_3D, N, seed=5)
    ids = (top - np.arange(N, dtype=np.int64)[::-1]).astype(np.uint32)
    return sc[:4] + (ids,)


def _outside_scene():
    smin, smax, bmin, bmax, ids = scene(bidx.Index64_3D, N, seed=9)
    bmin, bmax = bmin.copy(), bmax.copy()
    bmin[::17] -= 80.0             # left of the system box
    bmax[5::23] += 90.0            # past its right face
    return smin, smax, bmin, bmax, ids


def _nested_scene():
    """Every id twice, at a box and a bigger concentric one: nested
    same-id cells."""
    smin, smax, bmin, bmax, ids = scene(bidx.Index64_3D, N // 2, seed=17)
    bmin2 = np.clip(bmin - 3.0, smin + 0.5, None).astype(np.float32)
    bmax2 = np.clip(bmax + 3.0, None, smax - 0.5).astype(np.float32)
    return (smin, smax, np.concatenate([bmin, bmin2]),
            np.concatenate([bmax, bmax2]), np.concatenate([ids, ids]))


BASE = {"bucket_capacity": 8 * N, "pair_capacity": 16 * N}
# name: (spec, scene, step configuration, world sizes)
CASES = {
    "Index64_3D": ("Index64_3D", lambda: scene(bidx.Index64_3D, N, 7),
                   BASE, WORLDS),
    "Index64_2D": ("Index64_2D", lambda: scene(bidx.Index64_2D, N, 7),
                   BASE, WORLDS),
    "Index32_2D": ("Index32_2D", lambda: scene(bidx.Index32_2D, N, 7),
                   BASE, WORLDS),
    "outside": ("Index64_3D", _outside_scene, BASE, WORLDS),
    "ids_2^29-2": ("Index64_3D", lambda: _ids_scene((1 << 29) - 2), BASE,
                   WORLDS),
    "ids_2^29-1": ("Index64_3D", lambda: _ids_scene((1 << 29) - 1), BASE,
                   WORLDS),
    "ids_2^32-2": ("Index64_3D", lambda: _ids_scene((1 << 32) - 2), BASE,
                   WORLDS),
    "bucket_overflow": ("Index64_3D", lambda: scene(bidx.Index64_3D, N, 11),
                        {**BASE, "bucket_capacity": N // 4}, (2, 3, 4)),
    "exchange_overflow": ("Index64_3D",
                          lambda: scene(bidx.Index64_3D, N, 11),
                          {**BASE, "exchange_capacity": 8}, (2, 3, 4)),
    "nested_ids": ("Index64_3D", _nested_scene,
                   {**BASE, "pair_capacity": 64 * N, "nested_ids": True},
                   (1, 3, 4)),
    "filter_fn": ("Index64_3D", lambda: scene(bidx.Index64_3D, N, 13),
                  {**BASE, "filter": "odd_sum"}, (2, 3, 4)),
}
PARAMS = [(w, name) for name, (*_, worlds) in CASES.items()
          for w in worlds]


@functools.lru_cache(maxsize=None)
def scene_of(name):
    return CASES[name][1]()


def _port_cases(world):
    return [{"spec": spec, "scene": scene_of(name), "step": cfg}
            for name, (spec, _, cfg, worlds) in CASES.items()
            if world in worlds]


@pytest.fixture(scope="module")
def port_runs():
    """The port's outputs per world size (one spawn each, on first use):
    {world: {case name: [rank outputs]}}."""
    runs = {}

    def get(world):
        if world not in runs:
            out = run_ranks(bodies.drive_step, world, "gloo", "cpu",
                            _port_cases(world))
            names = [n for n, (*_, ws) in CASES.items() if world in ws]
            runs[world] = {n: [rank[i] for rank in out]
                           for i, n in enumerate(names)}
        return runs[world]

    return get


@functools.lru_cache(maxsize=None)
def jax_step(spec_name, world, cfg_items):
    return jpar.make_sharded_step(getattr(bidx, spec_name), mesh(world),
                                  "objects", **jax_config(dict(cfg_items)))


def jax_run(name, world):
    spec, _, cfg, _ = CASES[name]
    step = jax_step(spec, world, tuple(sorted(cfg.items())))
    return step(*scene_of(name))


@pytest.mark.parametrize("world,name", PARAMS)
def test_sharded_step_matches_jax(port_runs, world, name):
    ranks = port_runs(world)[name]
    want = jax_run(name, world)
    lanes = np.asarray(want.pairs_a).shape[0] // world
    want_pairs = np.array(jpar.gather_pairs(want), np.uint32).reshape(-1, 2)
    for r, got in enumerate(ranks):
        res = got["result"]
        cut = slice(r * lanes, (r + 1) * lanes)
        np.testing.assert_array_equal(res.pairs_a.astype(np.uint32),
                                      np.asarray(want.pairs_a)[cut])
        np.testing.assert_array_equal(res.pairs_b.astype(np.uint32),
                                      np.asarray(want.pairs_b)[cut])
        np.testing.assert_array_equal(res.shard_counts,
                                      np.asarray(want.shard_counts))
        assert int(res.total_count) == int(want.total_count)
        assert int(res.invalid_count) == int(want.invalid_count)
        assert bool(res.overflow) == bool(want.overflow)
        np.testing.assert_array_equal(got["pairs"], want_pairs)
    if name.endswith("overflow"):
        assert bool(want.overflow)
    else:
        assert not bool(want.overflow)


ORACLE_CASES = ("Index64_3D", "Index64_2D", "Index32_2D", "outside",
                "ids_2^32-2")


@pytest.mark.parametrize("world,name", [(w, n) for w, n in PARAMS
                                        if n in ORACLE_CASES])
def test_sharded_step_matches_oracle(port_runs, world, name):
    """Each world size is held to the oracle at its own effective
    min_depth (``min_depth_for_devices``)."""
    spec = getattr(bidx, CASES[name][0])
    smin, smax, bmin, bmax, ids = scene_of(name)
    md = jpar.min_depth_for_devices(spec, world)
    keys, tids, _ = oracle.extend(spec, smin, smax, bmin, bmax, ids,
                                  min_depth=md)
    keys, tids = oracle.sort_tree(keys, tids)
    want = np.array(oracle.scan(spec, keys, tids), np.uint32).reshape(-1, 2)
    for got in port_runs(world)[name]:
        np.testing.assert_array_equal(got["pairs"], want)


def test_fib_owner_matches_u32_hash():
    """The dedup owner in int64 equals the JAX package's u32 product, for
    ids up to 2^32 - 2 (where the int64 product would pass 2^63)."""
    import torch
    from broadphase_tpu_torch.parallel.scan import _fib_owner

    ids = np.concatenate([np.arange(4096), (1 << 32) - 2 - np.arange(4096),
                          np.random.default_rng(3).integers(
                              0, (1 << 32) - 1, 4096)]).astype(np.uint32)
    for n_dev in (1, 2, 3, 4, 7, 8):
        want = (jnp.asarray(ids) * jnp.uint32(0x9E3779B1)) % jnp.uint32(
            n_dev)
        got = _fib_owner(torch.as_tensor(ids.astype(np.int64)), n_dev)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_exports_the_jax_names():
    """``broadphase_tpu_torch.parallel`` has every public name of
    ``broadphase_tpu/parallel/__init__.py``."""
    import types

    from broadphase_tpu_torch import parallel as tpar

    names = {n for n, v in vars(jpar).items() if not n.startswith("_")
             and not isinstance(v, types.ModuleType)}
    assert len(names) == 15
    assert names <= set(vars(tpar))
