"""Port parity: kernel 2, pass 1 of the scan (ops/runends.py::scan_pass1):
the run ends, the adjacent-LCA depths that feed them, and both rule bytes.

The plain version against the JAX Pallas kernel (interpret mode), the JAX
XLA formulation (``search.descendant_run_ends`` off the TPU) and the JAX
scan's rule bytes (``layer._alpha_meta`` and its ``meta8`` expression);
exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from broadphase_tpu import index as bidx
from broadphase_tpu import layer as blayer
from broadphase_tpu.ops import search as jsearch
from broadphase_tpu.ops.pallas_runends import run_ends as jax_run_ends
from broadphase_tpu_torch import index as tidx
from broadphase_tpu_torch.ops import runends as truns
from broadphase_tpu_torch.ops import search as tsearch

from test_layer import random_scene
from test_torch_index import SPEC_IDS, SPEC_PAIRS, jax_to_torch_keys


@pytest.mark.parametrize("spec,tspec", SPEC_PAIRS, ids=SPEC_IDS)
def test_run_ends_on_built_tree(spec, tspec):
    """A JAX-built tree with a whole-system box (one run over every tile),
    exact duplicates and a pad tail."""
    smin, smax, bmin, bmax, ids = random_scene(spec.dim, 777, seed=3)
    bmin = np.vstack([smin[None], bmin, bmin[:40]]).astype(np.float32)
    bmax = np.vstack([smax[None], bmax, bmax[:40]]).astype(np.float32)
    ids = np.arange(len(bmin), dtype=np.uint32)
    state = blayer.build(spec, smin, smax, bmin, bmax, ids,
                         out_capacity=len(ids) * spec.fanout + 333)
    d = bidx.depth_of(spec, state.keys).astype(jnp.int32)
    lca_j = jsearch.adjacent_lca_depth(spec, state.keys)
    e_xla = np.asarray(jsearch.descendant_run_ends(spec, state.keys, d))
    e_pl = np.asarray(jax_run_ends(lca_j, d, spec.axis_bits + 1,
                                   interpret=True))
    np.testing.assert_array_equal(e_pl, e_xla)

    keys = jax_to_torch_keys(spec, tspec, state.keys)
    lca_t = truns.adjacent_lca_depth(tspec, keys)
    np.testing.assert_array_equal(lca_t.numpy(), np.asarray(lca_j))
    dt = tidx.depth_of(tspec, keys)
    np.testing.assert_array_equal(dt.numpy(), np.asarray(d))
    e_t = tsearch.descendant_run_ends(tspec, keys)
    np.testing.assert_array_equal(e_t.numpy(), e_xla)
    assert int(e_t[0]) >= int(state.count)        # depth 0 spans the tree


@pytest.mark.parametrize("n,n_depths", [(1, 20), (2, 20), (9000, 6)])
def test_run_ends_synthetic(n, n_depths):
    """Synthetic (lca, depth) streams with long plateaus and pads."""
    rng = np.random.default_rng(n)
    d = rng.integers(0, n_depths, n).astype(np.int32)
    d[rng.random(n) < 0.05] = n_depths + 3          # pads get e = 0
    lca = (rng.integers(-1, n_depths, n)).astype(np.int32)
    for s in range(0, n, 2500):
        lca[s:s + 1200] = n_depths - 1
    lca[-1] = -1
    want_pl = np.asarray(jax_run_ends(jnp.asarray(lca), jnp.asarray(d),
                                      n_depths, interpret=True))
    got = truns.run_ends_plain(torch.as_tensor(lca), torch.as_tensor(d),
                               n_depths)
    np.testing.assert_array_equal(got.numpy(), want_pl)
    assert np.all(got.numpy()[d >= n_depths] == 0)


@pytest.mark.parametrize("id_offset", [0, (1 << 24) - 300],
                         ids=["narrow_ids", "ids_across_2^24-1"])
@pytest.mark.parametrize("spec,tspec", SPEC_PAIRS, ids=SPEC_IDS)
def test_pass1_plain_matches_jax(spec, tspec, id_offset):
    """(e, ameta, bmeta) of pass 1 against the JAX scan's columns on a
    JAX-built tree with a whole-system box, exact duplicates, a pad tail
    and ids below or either side of 2^24 - 1; with the rule bytes off,
    e alone, the same."""
    smin, smax, bmin, bmax, _ = random_scene(spec.dim, 600, seed=5)
    bmin = np.vstack([smin[None], bmin, bmin[:30]]).astype(np.float32)
    bmax = np.vstack([smax[None], bmax, bmax[:30]]).astype(np.float32)
    ids = np.arange(len(bmin), dtype=np.uint32) + np.uint32(id_offset)
    state = blayer.build(spec, smin, smax, bmin, bmax, ids,
                         out_capacity=len(ids) * spec.fanout + 257)
    assert int(state.count) < state.ids.shape[0]          # a pad tail
    dep = bidx.depth_of(spec, state.keys)
    want_e = np.asarray(jsearch.descendant_run_ends(
        spec, state.keys, dep.astype(jnp.int32)))
    want_a = np.asarray(blayer._alpha_meta(spec, state.keys, dep,
                                           state.aux))
    want_b = np.asarray(((dep << jnp.uint32(spec.dim))
                         | (state.aux & jnp.uint32((1 << spec.dim) - 1)))
                        & jnp.uint32(0xFF))

    keys = jax_to_torch_keys(spec, tspec, state.keys)
    aux = torch.as_tensor(np.asarray(state.aux).astype(np.int32))
    e, ameta, bmeta = truns.scan_pass1(tspec, keys, aux)
    for got, want in ((e, want_e), (ameta, want_a), (bmeta, want_b)):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    e2, a2, b2 = truns.scan_pass1(tspec, keys, aux, rules=False)
    assert a2 is None and b2 is None
    np.testing.assert_array_equal(e2.numpy(), want_e)
