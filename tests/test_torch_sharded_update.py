"""Port parity: the sharded temporal-coherence update,
broadphase_tpu_torch.parallel.make_update_sharded against
broadphase_tpu.parallel.make_update_sharded and against the port's fresh
sharded build on each frame's bounds.

The port runs as 1, 2, 3 and 4 ranks of a CPU gloo group, one spawn per
world size for every case; JAX on as many devices of the 8-device CPU
mesh.  Frame by frame, every rank's fragment is compared lane for lane
(keys, ids, aux), with the counts, ``invalid_count``, ``overflow`` and the
object shard's signatures.  Cases: the three specs with small and
key-range-crossing moves, objects leaving and entering the system box,
a build deeper than ``min_depth_for_devices``, with 4 slots an axis (the
port's update takes the tracked layer's ``min_depth``; JAX's is given
it), ``wide_ids`` (one id at 2^29 - 1, which only its own fragments
hold, while the gate on aux is the group's max id; ids up to 2^32 - 2),
an id past 2^28 - 1 without ``wide_ids``, undersized ``route_cap``,
``obj_cap`` and ``churn_cap``, and a JAX tracked scene carried across
with ``convert.sharded_tracked_from_jax``.

The one difference from JAX, by design: with ``wide_ids`` the JAX update
zeroes aux (``broadphase_tpu/update.py:191-195``) where its own build
keeps it (live ids below 2^29 - 1); the port keeps aux as its build does.
In that case aux is held to the port's fresh build, everything else to
JAX.
"""

import functools

import numpy as np
import pytest

from broadphase_tpu import index as bidx
from broadphase_tpu import parallel as jpar
from broadphase_tpu_torch.parallel import run_ranks

import torch_rank_bodies as bodies
from test_torch_parallel import N, WORLDS, mesh, scene
from test_torch_sharded_layer import assert_fragments, fields_of

FCAP = 8 * N
BUILD = {"fragment_capacity": FCAP}
UPDATE = {"churn_cap": 4 * N, "obj_cap": N}


def _frames(spec_name, seed, ids=None, shares=(0.05, 0.4), outside=False):
    """(scene, frames): moves of a random share of the objects, small and
    then large enough to cross min_depth cells and key ranges."""
    spec = getattr(bidx, spec_name)
    smin, smax, bmin, bmax, base_ids = scene(spec, N, seed)
    scene0 = (smin, smax, bmin, bmax, base_ids if ids is None else ids)
    rng = np.random.default_rng(seed + 100)
    frames = []
    for k, share in enumerate(shares):
        move = rng.random(N) < share
        delta = rng.normal(0, 25.0 if k % 2 else 2.0,
                           (N, spec.dim)).astype(np.float32)
        if outside:
            delta[move & (rng.random(N) < 0.3)] += 70.0 * (1 - 2 * (k % 2))
        bmin = np.where(move[:, None], bmin + delta, bmin).astype(np.float32)
        bmax = np.where(move[:, None], bmax + delta, bmax).astype(np.float32)
        frames.append((bmin, bmax))
    return scene0, frames


def _ids(base):
    return (base + np.arange(N, dtype=np.int64)).astype(np.uint32)


FULL = (3, 4)
# name: (spec, (scene, frames), update configuration, world sizes, what
# is held to JAX: "all", "no_aux" (the wide_ids difference) or "flags")
CASES = {
    "Index64_3D": ("Index64_3D", lambda: _frames("Index64_3D", 31), UPDATE,
                   WORLDS, "all"),
    "Index64_2D": ("Index64_2D", lambda: _frames("Index64_2D", 31), UPDATE,
                   WORLDS, "all"),
    "Index32_2D": ("Index32_2D", lambda: _frames("Index32_2D", 31), UPDATE,
                   WORLDS, "all"),
    "outside": ("Index64_3D", lambda: _frames("Index64_3D", 37,
                                              outside=True), UPDATE, FULL,
                "all"),
    "wide_ids_aux_kept": ("Index64_3D",
                          lambda: _frames("Index64_3D", 41,
                                          ids=_ids((1 << 28) + 5)),
                          {**UPDATE, "wide_ids": True}, (2, 4), "no_aux"),
    "wide_ids_past_2^29-1": ("Index64_3D",
                             lambda: _frames("Index64_3D", 43,
                                             ids=_ids((1 << 29) + 5)),
                             {**UPDATE, "wide_ids": True}, FULL, "all"),
    "wide_ids_one_at_2^29-1": ("Index64_3D",
                               lambda: _frames("Index64_3D", 49, ids=_ids(
                                   (1 << 29) - N)),
                               {**UPDATE, "wide_ids": True}, (4,), "all"),
    "wide_ids_2^32-2": ("Index64_3D",
                        lambda: _frames("Index64_3D", 45,
                                        ids=_ids((1 << 32) - 1 - N)),
                        {**UPDATE, "wide_ids": True}, (4,), "all"),
    "id_past_2^28-1": ("Index64_3D",
                       lambda: _frames("Index64_3D", 47,
                                       ids=_ids((1 << 28) - 8)),
                       UPDATE, FULL, "flags"),
    "min_depth_4": ("Index64_3D", lambda: _frames("Index64_3D", 67),
                    {**UPDATE, "slots_per_axis": 4}, (4,), "all"),
    "route_cap": ("Index64_3D", lambda: _frames("Index64_3D", 53),
                  {**UPDATE, "route_cap": 8}, FULL, "all"),
    "obj_cap": ("Index64_3D", lambda: _frames("Index64_3D", 59),
                {**UPDATE, "obj_cap": 4}, FULL, "all"),
    "churn_cap": ("Index64_3D", lambda: _frames("Index64_3D", 61),
                  {**UPDATE, "churn_cap": 6}, FULL, "all"),
}
OVERFLOWS = {"id_past_2^28-1", "route_cap", "obj_cap", "churn_cap"}
# builds deeper than min_depth_for_devices (min_depth 4 pushes the
# objects wider than a depth-4 cell one level down, onto up to 3 cells an
# axis, so 4 slots): JAX's update is given the build's min_depth, the
# port's takes the tracked layer's own
BUILD_EXTRA = {"min_depth_4": {"min_depth": 4, "slots_per_axis": 4}}
PARAMS = [(w, name) for name, (_, _, _, worlds, _) in CASES.items()
          for w in worlds]
FROM_JAX = "Index64_3D"


@functools.lru_cache(maxsize=None)
def frames_of(name):
    return CASES[name][1]()


@functools.lru_cache(maxsize=None)
def jax_fns(spec_name, world, cfg_items, build_items):
    spec, m = getattr(bidx, spec_name), mesh(world)
    build = dict(build_items)
    return (jpar.make_build_tracked_sharded(spec, m, "objects", **build),
            jpar.make_update_sharded(spec, m, "objects", **dict(cfg_items),
                                     min_depth=build.get("min_depth", 0)))


def _fns(name, world):
    spec, _, cfg, _, _ = CASES[name]
    return jax_fns(spec, world, tuple(sorted(cfg.items())),
                   tuple(sorted(_build_of(name).items())))


def _build_of(name):
    return {**BUILD, **BUILD_EXTRA.get(name, {})}


@functools.lru_cache(maxsize=None)
def jax_frames(name, world):
    """The JAX tracked scene after the build and after each frame."""
    build, upd = _fns(name, world)
    sc, frames = frames_of(name)
    tracked = [build(*sc)]
    for bmin, bmax in frames:
        tracked.append(upd(tracked[-1], sc[0], sc[1], bmin, bmax))
    return tracked


def tracked_fields(spec, t):
    out = {f: np.asarray(getattr(t, f)) for f in (
        "ids", "bounds_min", "bounds_max", "sig_depth", "sig_tmin",
        "sig_tmax", "sig_contained")}
    out["layer"] = fields_of(spec, t.layer)
    return out


def _port_case(name):
    spec, _, cfg, _, _ = CASES[name]
    sc, frames = frames_of(name)
    return {"spec": spec, "scene": sc, "build": _build_of(name),
            "update": cfg, "frames": frames}


@pytest.fixture(scope="module")
def port_runs():
    """{world: {case name: [rank outputs]}}, one spawn per world size; the
    Index64_3D case also runs from the JAX tracked scene
    (``Index64_3D/from_jax``)."""
    runs = {}

    def get(world):
        if world not in runs:
            names = [n for n, (*_, ws, _) in CASES.items() if world in ws]
            cases = [_port_case(n) for n in names]
            spec = getattr(bidx, CASES[FROM_JAX][0])
            c = _port_case(FROM_JAX)
            c["jax_tracked"] = (
                tracked_fields(spec, jax_frames(FROM_JAX, world)[0]),
                jpar.min_depth_for_devices(spec, world))
            cases.append(c)
            names.append(FROM_JAX + "/from_jax")
            out = run_ranks(bodies.drive_update, world, "gloo", "cpu", cases)
            runs[world] = {n: [rank[i]["frames"] for rank in out]
                           for i, n in enumerate(names)}
        return runs[world]

    return get


def assert_frames(spec, world, want, ranks, aux):
    """Every frame: fragments and flags as JAX's, and the object shard's
    signatures."""
    for k, jt in enumerate(want[1:]):
        assert_fragments(spec, world, jt.layer,
                         [r[k]["tracked"].layer for r in ranks], aux=aux)
        n = np.asarray(jt.ids).shape[0] // world
        for r, frames in enumerate(ranks):
            got = frames[k]["tracked"]
            for f in ("sig_depth", "sig_tmin", "sig_tmax", "sig_contained",
                      "bounds_min", "bounds_max"):
                np.testing.assert_array_equal(
                    getattr(got, f), np.asarray(getattr(jt, f))[
                        r * n:(r + 1) * n].astype(getattr(got, f).dtype))


@pytest.mark.parametrize("world,name", PARAMS)
def test_sharded_update_matches_jax(port_runs, world, name):
    """Fragments, flags and signatures as JAX's, frame by frame.  Past 2^28
    - 1 without ``wide_ids`` only the flag is compared: JAX's packed u32
    column wraps such ids, so its fragments mean nothing once it flags
    the frame."""
    spec = getattr(bidx, CASES[name][0])
    want = jax_frames(name, world)
    held = CASES[name][4]
    if held == "flags":
        for k, jt in enumerate(want[1:]):
            for frames in port_runs(world)[name]:
                got = frames[k]["tracked"].layer
                assert bool(got.overflow) == bool(jt.layer.overflow)
    else:
        assert_frames(spec, world, want, port_runs(world)[name],
                      aux=held == "all")
    assert bool(want[-1].layer.overflow) == (name in OVERFLOWS)


@pytest.mark.parametrize("world,name", [(w, n) for w, n in PARAMS
                                        if n not in OVERFLOWS])
def test_sharded_update_matches_sharded_build(port_runs, world, name):
    """Each frame's fragments equal the port's fresh sharded build on that
    frame's bounds: keys, ids, aux (kept on the ``wide_ids`` path), counts
    and flags."""
    for frames in port_runs(world)[name]:
        for frame in frames:
            got, fresh = frame["tracked"].layer, frame["fresh"]
            assert not bool(got.overflow)
            for f in ("keys", "ids", "aux", "counts", "invalid_count",
                      "overflow"):
                np.testing.assert_array_equal(getattr(got, f),
                                              getattr(fresh, f))


def test_wide_ids_aux_differs_from_jax_only_in_aux(port_runs):
    """The documented difference: with ids in [2^28 - 1, 2^29 - 1) and
    ``wide_ids`` the JAX update zeroes aux, which its own build keeps; the
    port keeps it (test_sharded_update_matches_sharded_build holds it to
    the port's build)."""
    world = 4
    want = jax_frames("wide_ids_aux_kept", world)
    assert not np.asarray(want[-1].layer.aux).any()
    got_aux = np.concatenate([frames[-1]["tracked"].layer.aux
                              for frames in port_runs(world)[
                                  "wide_ids_aux_kept"]])
    assert got_aux.any()


@pytest.mark.parametrize("world", WORLDS)
def test_convert_sharded_tracked_from_jax(port_runs, world):
    """Ranks made from a JAX sharded tracked scene by ``convert`` update
    frame by frame exactly as it does."""
    spec = getattr(bidx, CASES[FROM_JAX][0])
    assert_frames(spec, world, jax_frames(FROM_JAX, world),
                  port_runs(world)[FROM_JAX + "/from_jax"], aux=True)
