"""Port parity: the temporal-coherence update, broadphase_tpu_torch.update
against broadphase_tpu.update on the CPU (where JAX takes its global-merge
path) and against the port's own fresh build.

Keys, ids, aux, count, invalid_count and overflow are compared exactly,
frame by frame.  Also: the churn_cap / obj_cap / wide-id flags, a run
started from a JAX tracked scene carried across with ``convert``, and the
entry points' default device.
"""

import numpy as np
import pytest
import torch

from broadphase_tpu import index as bidx
from broadphase_tpu import update as jup
from broadphase_tpu_torch import LayerBuilder, convert
from broadphase_tpu_torch import index as tidx
from broadphase_tpu_torch import layer as tl
from broadphase_tpu_torch import update as tup

from test_torch_layer import _assert_tree_equal, _jax_fields


def _scene(spec, n, seed, lo=-50.0, hi=50.0):
    rng = np.random.default_rng(seed)
    dim = spec.dim
    size = rng.uniform(0.5, 8.0, size=(n, dim)).astype(np.float32)
    bmin = rng.uniform(lo, hi - 8.0, size=(n, dim)).astype(np.float32)
    ids = np.arange(n, dtype=np.uint32)
    return (np.full(dim, lo, np.float32), np.full(dim, hi, np.float32),
            bmin, (bmin + size).astype(np.float32), ids, rng)


class _Pair:
    """One scene tracked by both packages, advanced frame by frame."""

    def __init__(self, name, n, seed, ids=None):
        self.spec, self.tspec = getattr(bidx, name), getattr(tidx, name)
        (self.smin, self.smax, self.bmin, self.bmax, self.ids,
         self.rng) = _scene(self.spec, n, seed)
        if ids is not None:
            self.ids = ids
        self.cap = n * self.spec.fanout
        scene = (self.smin, self.smax, self.bmin, self.bmax, self.ids)
        self.jt = jup.build_tracked(self.spec, *scene, out_capacity=self.cap)
        self.tt = tup.build_tracked(self.tspec, *scene,
                                    out_capacity=self.cap, device="cpu")
        _assert_tree_equal(self.spec, self.tspec, self.jt.state,
                           self.tt.state)

    def move(self, share, sigma):
        n, dim = self.bmin.shape
        moving = self.rng.random(n) < share
        delta = self.rng.normal(0, sigma, (n, dim)).astype(np.float32)
        self.bmin = np.where(moving[:, None], self.bmin + delta,
                             self.bmin).astype(np.float32)
        self.bmax = np.where(moving[:, None], self.bmax + delta,
                             self.bmax).astype(np.float32)

    def update(self, churn_cap, obj_cap=None, wide_ids=False, check=True):
        """Both packages advance one frame.  The port must equal a fresh
        build, aux included, and JAX on keys, ids, count and flags; on
        aux too except with ``wide_ids``, where JAX zeroes it
        (``broadphase_tpu/update.py:191-195``).  With ``wide_ids`` the
        emission-order pairs are compared with the fresh build's too."""
        args = (self.smin, self.smax, self.bmin, self.bmax)
        self.jt = jup.update(self.spec, self.jt, *args, churn_cap,
                             obj_cap=obj_cap, wide_ids=wide_ids)
        self.tt = tup.update(self.tspec, self.tt, *args, churn_cap,
                             obj_cap=obj_cap, wide_ids=wide_ids)
        assert bool(self.tt.state.overflow) == bool(self.jt.state.overflow)
        if check:
            _assert_tree_equal(self.spec, self.tspec, self.jt.state,
                               self.tt.state, aux=not wide_ids)
            fresh = tl.build(self.tspec, self.smin, self.smax, self.bmin,
                             self.bmax, self.ids, out_capacity=self.cap,
                             device="cpu")
            assert tl.layers_equal(self.tspec, self.tt.state, fresh)
            cnt = int(fresh.count)
            assert torch.equal(self.tt.state.aux[:cnt], fresh.aux[:cnt])
            assert int(self.tt.state.invalid_count) == \
                int(fresh.invalid_count)
            if wide_ids:
                pair_cap = 64 * len(self.ids)
                _, got = tl.scan(self.tspec, self.tt.state, pair_cap,
                                 canonical=False)
                _, want = tl.scan(self.tspec, fresh, pair_cap,
                                  canonical=False)
                assert not bool(want.overflow)
                np.testing.assert_array_equal(
                    tl.scan_result_to_numpy(got),
                    tl.scan_result_to_numpy(want))
        return self.tt.state


@pytest.mark.parametrize("name", ["Index64_3D", "Index64_2D", "Index32_2D"])
def test_update_matches_jax_and_build(name):
    p = _Pair(name, 300, seed=51)
    for frame in range(3):
        p.move(0.3, 1.0 if frame % 2 == 0 else 15.0)
        assert not bool(p.update(300 * p.spec.fanout).overflow)


def test_objects_leaving_and_entering():
    p = _Pair("Index64_3D", 300, seed=53)
    for _ in range(3):
        p.move(0.2, 40.0)
        state = p.update(300 * 8)
        assert int(state.invalid_count) > 0


@pytest.mark.parametrize("case", ["no_change", "subcell_drift"])
def test_small_churn(case):
    """No change is the identity; drift far below a cell changes bounds
    but almost no cells, so a 64-slot churn buffer suffices."""
    p = _Pair("Index64_3D", 300, seed=61)
    before = p.tt.state
    for _ in range(2):
        if case == "subcell_drift":
            delta = p.rng.normal(0, 1e-4, p.bmin.shape).astype(np.float32)
            p.bmin = (p.bmin + delta).astype(np.float32)
            p.bmax = (p.bmax + delta).astype(np.float32)
        assert not bool(p.update(64).overflow)
    if case == "no_change":
        assert all(torch.equal(a, b) for a, b in zip(p.tt.state, before))


@pytest.mark.parametrize("caps", [(16, None), (300 * 8, 8)],
                         ids=["churn_cap", "obj_cap"])
def test_overflow_flags(caps):
    p = _Pair("Index64_3D", 300, seed=57)
    p.move(1.0, 20.0)
    assert bool(p.update(*caps, check=False).overflow)


@pytest.mark.parametrize("name", ["Index64_3D", "Index32_2D"])
def test_wide_ids(name):
    """Ids >= 2^28 - 1 set overflow unless wide_ids=True, which matches
    JAX and the fresh build exactly."""
    n = 200
    ids = np.arange(n, dtype=np.uint32) + np.uint32(1 << 29)
    p = _Pair(name, n, seed=65, ids=ids)
    jt0, tt0 = p.jt, p.tt
    p.move(0.3, 10.0)
    assert bool(p.update(n * p.spec.fanout, check=False).overflow)
    p.jt, p.tt = jt0, tt0
    assert not bool(p.update(n * p.spec.fanout, wide_ids=True).overflow)


@pytest.mark.parametrize("offset", [0, 1 << 28])
@pytest.mark.parametrize("name", ["Index64_3D", "Index32_2D"])
def test_wide_ids_keep_aux(name, offset):
    """Below 2^29 - 1 a fresh build keeps the aux bits, and so does the
    wide-ids update: with ids from 0 the emit-once rule stays on, so the
    emission-order pairs are the fresh build's too."""
    n = 200
    ids = np.arange(n, dtype=np.uint32) + np.uint32(offset)
    p = _Pair(name, n, seed=65, ids=ids)
    for _ in range(2):
        p.move(0.3, 10.0)
        state = p.update(n * p.spec.fanout, wide_ids=True)
        assert not bool(state.overflow)
        assert bool(torch.any(state.aux != 0))


def _crossing_frames(p, big):
    """Object ``big`` (id >= 2^29 - 1) leaves the system box, then enters
    it again: the largest live id crosses 2^29 - 1 down, then up."""
    n = len(p.ids)
    masked = []
    for shift in (500.0, -500.0):
        p.move(0.3, 5.0)
        p.bmin[big] += shift
        p.bmax[big] += shift
        state = p.update(n * p.spec.fanout, wide_ids=True)
        assert not bool(state.overflow)
        masked.append(not bool(torch.any(state.aux != 0)))
    assert masked == [False, True]


def test_wide_ids_across_the_aux_bound():
    """ids from 0 and one id of 2^29 + 7: a fresh build drops aux only
    while that object is in the system; the update follows it both
    ways."""
    n = 200
    ids = np.arange(n, dtype=np.uint32)
    ids[17] = (1 << 29) + 7
    p = _Pair("Index64_3D", n, seed=69, ids=ids)
    assert not bool(torch.any(p.tt.state.aux != 0))
    _crossing_frames(p, 17)


def test_run_from_jax_wide_tracked_scene():
    """A JAX wide-ids tracked scene (its update zeroes aux) carried across
    with ``convert``: the port recomputes the tree's aux from the
    signature, and its updates equal a fresh build, aux included."""
    n = 200
    ids = np.arange(n, dtype=np.uint32)
    ids[23] = (1 << 29) + 3
    p = _Pair("Index64_3D", n, seed=71, ids=ids)
    p.move(0.3, 10.0)
    p.update(n * 8, wide_ids=True)
    p.bmin[23] -= 500.0
    p.bmax[23] -= 500.0
    p.update(n * 8, wide_ids=True)
    assert not np.any(np.asarray(p.jt.state.aux) != 0)
    assert bool(torch.any(p.tt.state.aux != 0))
    jt = p.jt
    fields = {"state": _jax_fields(p.spec, jt.state),
              **{f: np.asarray(getattr(jt, f)) for f in
                 ("ids", "bounds_min", "bounds_max", "sig_depth",
                  "sig_tmin", "sig_tmax", "sig_contained")}}
    want = p.tt.tree_aux
    p.tt = convert.tracked_scene_from_jax(p.tspec, fields, "cpu")
    assert torch.equal(p.tt.tree_aux, want)
    p.bmin[23] += 500.0
    p.bmax[23] += 500.0
    for _ in range(2):
        p.move(0.3, 10.0)
        assert not bool(p.update(n * 8, wide_ids=True).overflow)


def test_run_from_jax_tracked_scene():
    """A JAX tracked scene carried across with ``convert`` updates in the
    port exactly as in JAX; the conversion round-trips its fields."""
    p = _Pair("Index64_3D", 300, seed=67)
    p.move(0.3, 5.0)
    p.update(300 * 8)
    jt = p.jt
    fields = {"state": _jax_fields(p.spec, jt.state),
              **{f: np.asarray(getattr(jt, f)) for f in
                 ("ids", "bounds_min", "bounds_max", "sig_depth",
                  "sig_tmin", "sig_tmax", "sig_contained")}}
    p.tt = convert.tracked_scene_from_jax(p.tspec, fields, "cpu")
    back = convert.tracked_scene_to_numpy(p.tspec, p.tt)
    for k, v in fields.items():
        if k == "state":
            for f, x in v.items():
                if f == "keys":
                    for a, b in zip(back[k][f], x):
                        np.testing.assert_array_equal(a, b)
                else:
                    np.testing.assert_array_equal(back[k][f], x)
        else:
            assert back[k].dtype == v.dtype, k
            np.testing.assert_array_equal(back[k], v)
    for frame in range(2):
        p.move(0.3, 15.0)
        assert not bool(p.update(300 * 8).overflow)


@pytest.mark.parametrize("entry", ["build", "make_layer", "empty",
                                   "builder_build", "build_tracked",
                                   "from_scene_layer"])
def test_entry_points_default_to_the_card(entry):
    """Without ``device`` an entry point given numpy inputs runs on the
    card, and raises where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    spec = tidx.Index64_3D
    smin, smax, bmin, bmax, ids, _ = _scene(bidx.Index64_3D, 50, seed=1)
    lb = LayerBuilder(index_capacity=400)
    call = {
        "build": lambda: tl.build(spec, smin, smax, bmin, bmax, ids),
        "make_layer": lambda: tl.make_layer(spec, 64),
        "empty": lambda: lb.empty(spec),
        "builder_build": lambda: lb.build(spec, smin, smax, bmin, bmax,
                                          ids),
        "build_tracked": lambda: tup.build_tracked(spec, smin, smax, bmin,
                                                   bmax, ids),
        "from_scene_layer": lambda: tl.layer_from_scene_layer(
            spec, tl.SceneLayer()),
    }[entry]
    with pytest.raises(RuntimeError, match="CUDA"):
        call()
    # tensors keep their device
    st = tl.build(spec, *(torch.as_tensor(x) for x in (smin, smax, bmin,
                                                        bmax)),
                  torch.as_tensor(ids.astype(np.int64)))
    assert st.keys.device.type == "cpu"
