"""Port parity: kernel 4, ops/expand2.py::expand_pairs_prepped, with the
emit-once rule on and off, and the search helpers its plain version uses.

On a JAX-built tree, the port's prep + plain expansion must equal the JAX
Pallas kernels (interpret mode, ids packed with the rule bytes as the JAX
scan packs them) slot for slot, and the JAX XLA formulation
(``layer.py:1000-1012``); exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from broadphase_tpu import index as bidx
from broadphase_tpu import layer as blayer
from broadphase_tpu.ops import search as jsearch
from broadphase_tpu.ops.pallas_expand2 import expand_pairs_prepped as jexpand
from broadphase_tpu.ops.pallas_prep import prep_runs as jprep
from broadphase_tpu_torch import Index64_3D as TSPEC
from broadphase_tpu_torch import index as tidx
from broadphase_tpu_torch.ops import expand2 as texpand
from broadphase_tpu_torch.ops import prep as tprep
from broadphase_tpu_torch.ops import runends as truns
from broadphase_tpu_torch.ops import search as tsearch

from test_layer import random_scene
from test_torch_index import jax_to_torch_keys

SPEC = bidx.Index64_3D


@pytest.mark.parametrize("dim", [2, 3])
def test_emit_once_keep_all_bytes(dim):
    a, b = np.meshgrid(np.arange(256), np.arange(256))
    want = np.asarray(blayer._emit_once_keep(dim, jnp.asarray(a.ravel()),
                                             jnp.asarray(b.ravel())))
    got = texpand.emit_once_keep(dim, torch.as_tensor(a.ravel()),
                                 torch.as_tensor(b.ravel()))
    np.testing.assert_array_equal(got.numpy(), want)


def test_expand_runs_and_segmented_broadcast_match_jax():
    rng = np.random.default_rng(0)
    run = rng.integers(0, 6, 3000) * (rng.random(3000) < 0.5)
    starts = (np.cumsum(run) - run).astype(np.int32)
    P = int(run.sum()) - 100                     # cut inside the last runs
    vals = rng.integers(0, 1 << 31, 3000).astype(np.int32)
    jj, jo = jsearch.expand_runs(jnp.asarray(starts), P)
    tj, to = tsearch.expand_runs(torch.as_tensor(starts), P)
    np.testing.assert_array_equal(tj.numpy(), np.asarray(jj))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    want = jsearch.segmented_broadcast(jnp.asarray(starts), jnp.asarray(run),
                                       jnp.asarray(vals), P)
    got = tsearch.segmented_broadcast(torch.as_tensor(starts),
                                      torch.as_tensor(run),
                                      torch.as_tensor(vals), P)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _tree(n, id_offset):
    smin, smax, bmin, bmax, ids = random_scene(3, n, seed=7)
    bmin = np.vstack([smin[None], bmin]).astype(np.float32)   # depth 0
    bmax = np.vstack([smax[None], bmax]).astype(np.float32)
    ids = np.arange(len(bmin), dtype=np.uint32) + np.uint32(id_offset)
    return blayer.build(SPEC, smin, smax, bmin, bmax, ids,
                        out_capacity=len(ids) * 8 + 100)


@pytest.mark.parametrize("rule", [True, False])
@pytest.mark.parametrize("slack", [-2000, 3000])  # total > P, and P > total
def test_expand_matches_jax_kernel_and_xla(rule, slack):
    st = _tree(500, 0 if rule else (1 << 24))
    keys, ids, aux, count = st.keys, st.ids, st.aux, st.count
    cap = ids.shape[0]
    dep = bidx.depth_of(SPEC, keys)
    e = jsearch.descendant_run_ends(SPEC, keys, dep)
    live = jnp.arange(cap) < count
    meta8 = ((dep << 3) | (aux & 7)) & 0xFF
    ameta = blayer._alpha_meta(SPEC, keys, dep, aux)
    if rule:     # the JAX scan packs the rule bytes under 24-bit ids
        ids_b = jnp.where(live, (ids << 8) | meta8, blayer.PAD_ID)
        ids_a = jnp.where(live, (ids << 8) | ameta, blayer.PAD_ID)
    else:
        ids_b = ids_a = ids
    sv, ab, bid, _m, total, _w = jprep(e, ids_b, count, interpret=True)
    P = int(total) + slack
    ja, jb = jexpand(ids_a, sv, ab, bid, total, P, rule=rule, dim=3,
                     interpret=True)

    tkeys = jax_to_torch_keys(SPEC, TSPEC, keys)
    tids = torch.as_tensor(np.asarray(ids).astype(np.int64))
    taux = torch.as_tensor(np.asarray(aux).astype(np.int32))
    tdep = tidx.depth_of(TSPEC, tkeys)
    tameta = truns.alpha_meta(TSPEC, tkeys, tdep, taux)
    np.testing.assert_array_equal(tameta.numpy(), np.asarray(ameta))
    te = tsearch.descendant_run_ends(TSPEC, tkeys)
    tb8 = ((tdep << 3) | (taux & 7)) & 0xFF
    prepped = tprep.prep_runs(te, tids, tb8, int(count))
    assert int(prepped[5]) == int(total)
    a, b = texpand.expand_pairs_prepped(tids, tameta, *prepped[:6], P,
                                        torch.tensor(rule), 3)
    np.testing.assert_array_equal(a.numpy().astype(np.uint32), np.asarray(ja))
    np.testing.assert_array_equal(b.numpy().astype(np.uint32), np.asarray(jb))

    # the XLA formulation of the same slots
    run = jnp.where(live, jnp.maximum(jnp.minimum(e, count)
                                      - (jnp.arange(cap) + 1), 0), 0)
    starts = jnp.cumsum(run) - run
    j, off = jsearch.expand_runs(starts, P)
    i = jnp.clip(jnp.clip(j, 0, cap - 1) + 1 + jnp.maximum(off, 0), 0,
                 cap - 1)
    xa = ids[i]
    xb = jsearch.segmented_broadcast(starts, run, ids, P)
    valid = (jnp.arange(P) < total) & (xa != xb)
    if rule:
        bm = jsearch.segmented_broadcast(starts, run, meta8, P)
        valid = valid & blayer._emit_once_keep(3, ameta[i], bm)
    np.testing.assert_array_equal(
        (a != b).numpy(), np.asarray(valid))
    np.testing.assert_array_equal(
        a.numpy()[(a != b).numpy()].astype(np.uint32),
        np.asarray(xa)[np.asarray(valid)])


def _entries(run, seed):
    """Prep entries (as ``prep_runs`` lays them out) of the run lengths
    ``run``, with random ids below 2^24 - 1 and random rule bytes."""
    rng = np.random.default_rng(seed)
    cap = len(run)
    starts = np.cumsum(run) - run
    nz = run > 0
    j = np.flatnonzero(nz)
    m = len(j)
    ids = rng.integers(0, (1 << 24) - 1, cap)
    ameta = rng.integers(0, 256, cap)
    meta = rng.integers(0, 256, cap)
    sv = np.full(cap, tprep.HUGE)
    ab = np.zeros(cap, np.int64)
    bid = np.full(cap, tprep.PAD_ID)
    bmeta = np.zeros(cap, np.int64)
    sv[:m], ab[:m] = starts[nz], j + 1 - starts[nz]
    bid[:m], bmeta[:m] = ids[nz], meta[nz]
    return ids, ameta, sv, ab, bid, bmeta, m, int(run.sum())


def _runs(shape):
    run = np.zeros(3000, np.int64)
    if shape == "long_run":      # one run over most slots, short ones after
        run[2] = 2990
        run[2000:2990:9] = np.arange(110) % 5 + 1
    else:                        # every run of length 1: m == total
        run[:-1] = 1
    return run


@pytest.mark.parametrize("rule", [True, False])
@pytest.mark.parametrize("shape", ["long_run", "unit_runs"])
def test_expand_synthetic_runs_match_jax_kernel(shape, rule):
    ids, ameta, sv, ab, bid, bmeta, m, total = _entries(_runs(shape), 11)
    if shape == "unit_runs":
        assert m == total
    P = total + 300                          # total mid-buffer
    live = np.arange(len(sv)) < m
    if rule:     # the JAX kernel takes the rule bytes packed under the ids
        ids_a = (ids << 8) | ameta
        bid_c = np.where(live, (bid << 8) | bmeta, blayer.PAD_ID)
    else:
        ids_a, bid_c = ids, bid
    ja, jb = jexpand(jnp.asarray(ids_a.astype(np.uint32)),
                     jnp.asarray(sv.astype(np.int32)),
                     jnp.asarray(ab.astype(np.int32)),
                     jnp.asarray(bid_c.astype(np.uint32)),
                     jnp.asarray(total, jnp.int32), P, rule=rule, dim=3,
                     interpret=True)
    t = [torch.as_tensor(x) for x in (ids, ameta.astype(np.int32), sv, ab,
                                      bid, bmeta.astype(np.int32))]
    a, b = texpand.expand_pairs_prepped(*t, torch.tensor(m),
                                        torch.tensor(total), P,
                                        torch.tensor(rule), 3)
    np.testing.assert_array_equal(a.numpy().astype(np.uint32), np.asarray(ja))
    np.testing.assert_array_equal(b.numpy().astype(np.uint32), np.asarray(jb))
    assert (a.numpy()[total:] == tprep.PAD_ID).all()
    if not rule:
        assert (a.numpy()[:total] != tprep.PAD_ID).all()
