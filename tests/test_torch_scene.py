"""Port parity for the BR_SCENE bridge: broadphase_tpu_torch.scene against
broadphase_tpu.utils.scene (the same bytes both ways), the layer's
checkpoint round trip, the aux bits a restore recomputes, and the key
codecs and formatters of index.py, against the JAX package on the same
numpy inputs from a seed; tolerance 0.
"""

import numpy as np
import pytest
import torch

import bench
from broadphase_tpu import index as bidx
from broadphase_tpu import layer as jl
from broadphase_tpu.utils import scene as jscene
from broadphase_tpu_torch import index as tidx
from broadphase_tpu_torch import layer as tl
from broadphase_tpu_torch import scene as tscene

from test_torch_index import SPEC_IDS, SPEC_PAIRS

N = 400


def _scene_obj(mod, nearest, n=50, tree=30, seed=0):
    rng = np.random.default_rng(seed)
    bmin = rng.uniform(-10, 10, (n, 3)).astype(np.float32)
    layer = mod.SceneLayer(
        min_depth=3, keys=rng.integers(0, 1 << 62, tree, dtype=np.uint64),
        ids=rng.integers(0, 1 << 32, tree, dtype=np.uint64).astype(np.uint32),
        sorted=bool(seed % 2))
    return mod.Scene(
        np.full(3, -12.0, np.float32), np.full(3, 12.5, np.float32), bmin,
        (bmin + rng.uniform(0, 2, (n, 3))).astype(np.float32),
        np.arange(n, dtype=np.uint32), layer,
        rng.integers(0, n, (17, 2)).astype(np.uint32),
        rng.integers(0, n, 9).astype(np.uint32), nearest)


@pytest.mark.parametrize("nearest", [None, (7, 2.5)])
@pytest.mark.parametrize("seed", [0, 1])
def test_scene_files_are_the_same_bytes(nearest, seed, tmp_path):
    """A file the JAX package writes reads back in the port and writes the
    same bytes; and the other way round."""
    data = jscene.dumps(_scene_obj(jscene, nearest, seed=seed))
    path = tmp_path / "scene.br"
    path.write_bytes(data)
    got = tscene.load(path)
    assert tscene.dumps(got) == data
    assert got.nearest == nearest and got.layer.min_depth == 3
    tscene.save(tmp_path / "port.br", _scene_obj(tscene, nearest, seed=seed))
    assert (tmp_path / "port.br").read_bytes() == data
    back = jscene.load(tmp_path / "port.br")
    np.testing.assert_array_equal(back.layer.keys, got.layer.keys)
    np.testing.assert_array_equal(back.collisions, got.collisions)


def test_scene_reader_refuses_what_the_jax_reader_refuses():
    data = jscene.dumps(_scene_obj(jscene, None))
    for bad in (b"NOT_SCEN" + data[8:], data[:-3],
                data[:8] + b"\x02\x00" + data[10:]):
        with pytest.raises(ValueError):
            jscene.loads(bad)
        with pytest.raises(ValueError):
            tscene.loads(bad)


@pytest.mark.parametrize("spec,tspec", SPEC_PAIRS, ids=SPEC_IDS)
def test_checkpoint_round_trip(spec, tspec, tmp_path):
    """build -> layer_to_scene_layer -> save -> load ->
    layer_from_scene_layer gives back the tree, its aux bits and its
    pairs; and equals the JAX package's restore of the same file."""
    scene = bench._scene(spec.dim, N, seed=3)
    cap = 8 * N
    built = tl.build(tspec, *scene, out_capacity=cap, device="cpu")
    sl = tl.layer_to_scene_layer(tspec, built)
    jsl = jl.layer_to_scene_layer(spec, jl.build(spec, *scene))
    np.testing.assert_array_equal(sl.keys, jsl.keys)
    np.testing.assert_array_equal(sl.ids, jsl.ids)
    assert (sl.min_depth, sl.sorted) == (jsl.min_depth, jsl.sorted)
    smin, smax, bmin, bmax, ids = scene
    pad = np.zeros((N, 3 - spec.dim), np.float32)
    tscene.save(tmp_path / "ckpt.br", tscene.Scene(
        np.resize(smin, 3), np.resize(smax, 3),
        np.concatenate([bmin, pad], 1), np.concatenate([bmax, pad], 1),
        ids, sl))
    loaded = tscene.load(tmp_path / "ckpt.br").layer
    restored = tl.layer_from_scene_layer(tspec, loaded, capacity=cap,
                                         device="cpu")
    for f in ("keys", "ids", "aux", "count"):
        assert torch.equal(getattr(restored, f), getattr(built, f)), f
    assert tl.layers_equal(tspec, restored, built)
    jrest = jl.layer_from_scene_layer(spec, jscene.load(tmp_path / "ckpt.br")
                                      .layer, capacity=cap)
    np.testing.assert_array_equal(restored.aux.numpy().astype(np.uint32),
                                  np.asarray(jrest.aux))
    _, got = tl.scan(tspec, restored, 24 * N, emit_capacity=64 * N)
    _, want = tl.scan(tspec, built, 24 * N, emit_capacity=64 * N)
    assert not bool(got.overflow)
    np.testing.assert_array_equal(tl.scan_result_to_numpy(got),
                                  tl.scan_result_to_numpy(want))


def test_restore_capacity_and_default():
    tspec = tidx.Index64_3D
    scene = bench._scene(3, 50, seed=1)
    sl = tl.layer_to_scene_layer(
        tspec, tl.build(tspec, *scene, device="cpu"))
    st = tl.layer_from_scene_layer(tspec, sl, device="cpu")
    assert tl.capacity_of(st) == len(sl.ids) == int(st.count)
    with pytest.raises(ValueError, match="capacity"):
        tl.layer_from_scene_layer(tspec, sl, capacity=len(sl.ids) - 1,
                                  device="cpu")
    empty = tl.layer_from_scene_layer(tspec, tscene.SceneLayer(),
                                      device="cpu")
    assert tl.capacity_of(empty) == 1 and int(empty.count) == 0


def _aux_cases(spec):
    """(keys, ids) of serialized trees: a built tree, the tree with one id
    given to two distant cells (not one block), and a merged same-id
    tree."""
    scene = bench._scene(spec.dim, N, seed=21)
    keys, ids, cnt = jl.tree_to_numpy(spec, jl.build(spec, *scene))
    dup_ids = ids.copy()
    dup_ids[0] = dup_ids[cnt - 1]
    merged = np.concatenate([ids, ids])
    return {"built": (keys, ids),
            "two_cells_one_id": (np.array([keys[0], keys[cnt - 1]]),
                                 np.array([7, 7], np.uint32)),
            "relabelled": (keys, dup_ids),
            "merged_same_ids": (np.concatenate([keys, keys]), merged),
            "empty": (keys[:0], ids[:0])}


@pytest.mark.parametrize("spec,tspec", SPEC_PAIRS, ids=SPEC_IDS)
def test_aux_from_tree_matches_jax(spec, tspec):
    """Bit for bit, including the zero fallback for groups that are not
    one full block (tests/test_layer.py::test_scene_layer_restore_
    reconstructs_aux)."""
    for name, (keys, ids) in _aux_cases(spec).items():
        got = tl._aux_from_tree_np(tspec, keys, ids)
        want = jl._aux_from_tree_np(spec, keys, ids)
        assert got.dtype == np.uint32, name
        np.testing.assert_array_equal(got, want, err_msg=name)
        if name == "two_cells_one_id":
            assert not got.any()
        if name == "built":
            assert got.any()


@pytest.mark.parametrize("spec,tspec", SPEC_PAIRS, ids=SPEC_IDS)
def test_key_codecs_and_formatters_match_jax(spec, tspec):
    scene = bench._scene(spec.dim, 200, seed=5)
    keys, _, cnt = jl.tree_to_numpy(spec, jl.build(spec, *scene))
    pad = np.iinfo(keys.dtype).max
    keys = np.concatenate([keys, np.array([0, pad], keys.dtype)])
    tkeys = tidx.keys_from_numpy(tspec, keys)
    assert tkeys.dtype == torch.int64 and int(tkeys[-1]) == tidx.PAD_KEY
    np.testing.assert_array_equal(tidx.keys_to_numpy(tspec, tkeys), keys)
    jkeys = bidx.keys_from_numpy(spec, keys)
    np.testing.assert_array_equal(
        np.asarray(bidx.keys_to_numpy(spec, jkeys)), keys)
    assert tidx.format_keys(tspec, tkeys) == bidx.format_keys(spec, jkeys)
    assert tidx.format_keys(tspec, keys) == bidx.format_keys(spec, jkeys)
    for k in keys[:5].tolist():
        assert tidx.format_key(tspec, k) == bidx.format_key(spec, k)
    assert tidx.format_key(tspec, 0).startswith(spec.name + "{origin: (")
