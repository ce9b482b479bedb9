"""Port parity: kernel 2, ops/runends.py::run_ends, and the adjacent-LCA
depths of ops/search.py that feed it.

The plain version against the JAX Pallas kernel (interpret mode) and the
JAX XLA formulation (``search.descendant_run_ends`` off the TPU); exact.
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
    lca_t = tsearch.adjacent_lca_depth(tspec, keys)
    np.testing.assert_array_equal(lca_t.numpy(), np.asarray(lca_j))
    dt = tidx.depth_of(tspec, keys)
    np.testing.assert_array_equal(dt.numpy(), np.asarray(d))
    e_t = tsearch.descendant_run_ends(tspec, keys, dt)
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
    got = truns.run_ends(torch.as_tensor(lca), torch.as_tensor(d), n_depths)
    np.testing.assert_array_equal(got.numpy(), want_pl)
    assert np.all(got.numpy()[d >= n_depths] == 0)
