"""Port parity: kernel 5, ops/compact.py::stream_compact.

The plain version (what a CPU tensor runs) against the JAX Pallas kernel in
interpret mode and against the JAX XLA fallback ``stable_compact``; exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from broadphase_tpu.ops.compact import stable_compact
from broadphase_tpu.ops.pallas_compact import stream_compact as jax_stream
from broadphase_tpu_torch.ops import compact as tcompact


# distinct fills, one a column; "3cols" and "4cols" take random keep flags
FILLS = (0xFFFF_FFFF, 7, 0, 0x1234_5678)


def _case(n, mode, seed):
    rng = np.random.default_rng(seed)
    ncols = {"3cols": 3, "4cols": 4}.get(mode, 2)
    keep = {"all": np.ones(n, bool),
            "none": np.zeros(n, bool),
            "last": np.arange(n) == n - 1}.get(mode, rng.random(n) < 0.37)
    cols = (rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32),
            np.arange(n, dtype=np.uint32),
            rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32),
            (np.arange(n, dtype=np.uint32) * 3) ^ 0xABCD)[:ncols]
    return keep, cols


@pytest.mark.parametrize("n,mode", [
    (4096, "random"), (5000, "random"),      # aligned and ragged length
    (3000, "all"), (3000, "none"), (2049, "last"), (1, "all"), (1, "none"),
    (3000, "3cols"), (3000, "4cols"),
    (3 * 4096 + 123, "random"),              # several of the JAX tiles
])
def test_stream_compact_matches_jax(n, mode):
    keep, cols = _case(n, mode, seed=n)
    fills = FILLS[:len(cols)]
    got, cnt = tcompact.stream_compact(
        torch.as_tensor(keep),
        tuple(torch.as_tensor(c.astype(np.int64)) for c in cols), fills)
    want, wcnt = jax_stream(jnp.asarray(keep), tuple(map(jnp.asarray, cols)),
                            fills=fills, interpret=True)
    xla, xcnt = stable_compact(jnp.asarray(keep),
                               tuple(map(jnp.asarray, cols)), fills)
    assert int(cnt) == int(wcnt) == int(xcnt) == int(keep.sum())
    for g, w, x in zip(got, want, xla):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(g.numpy(), np.asarray(x))


def test_stream_compact_empty_and_default_fill():
    got, cnt = tcompact.stream_compact(torch.zeros(0, dtype=torch.bool),
                                       (torch.zeros(0, dtype=torch.int64),))
    assert int(cnt) == 0 and got[0].shape == (0,)
    got, cnt = tcompact.stream_compact(torch.tensor([False, True, False]),
                                       (torch.tensor([1, 2, 3]),))
    assert int(cnt) == 1
    assert got[0].tolist() == [2, tcompact.PAD_ID, tcompact.PAD_ID]
