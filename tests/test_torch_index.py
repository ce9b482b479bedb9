"""Port parity: broadphase_tpu_torch.index against broadphase_tpu.index.

Inputs are drawn with numpy from a seed and given to both packages; every
comparison is exact (tolerance 0).  The helpers at the top carry keys
between the two packages and are shared by the other test_torch_* files.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from broadphase_tpu import index as bidx
from broadphase_tpu.utils import oracle
from broadphase_tpu_torch import index as tidx

SPEC_PAIRS = [(j, getattr(tidx, j.name)) for j in bidx.ALL_SPECS]
SPEC_IDS = [j.name for j in bidx.ALL_SPECS]


def jax_keys_np(spec, key) -> np.ndarray:
    """JAX keys as uint64 numpy (pads all ones)."""
    return np.asarray(bidx.keys_to_numpy(spec, key)).astype(np.uint64)


def torch_keys_np(tspec, key) -> np.ndarray:
    return tidx.keys_to_numpy(tspec, key).astype(np.uint64)


def jax_to_torch_keys(spec, tspec, key) -> torch.Tensor:
    cols = [np.asarray(c) for c in bidx.sort_operands(spec, key)]
    return tidx.key_from_columns(tspec, cols)


def random_keys(spec, n, seed):
    """Valid keys from random truncated origins and depths, via JAX."""
    rng = np.random.default_rng(seed)
    depth = rng.integers(0, spec.axis_bits + 1, n).astype(np.uint32)
    origin = []
    for _ in range(spec.dim):
        o = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
        low = (32 - depth.astype(np.int64)).clip(0, 32)
        mask = np.where(low >= 32, 0, (~((1 << low) - 1)) & 0xFFFF_FFFF)
        origin.append(np.where(depth == 0, 0, o & mask).astype(np.uint32))
    return origin, depth


@pytest.mark.parametrize("spec,tspec", SPEC_PAIRS, ids=SPEC_IDS)
def test_axis_codec_matches_jax(spec, tspec):
    rng = np.random.default_rng(1)
    x = rng.integers(0, 1 << 32, 2000, dtype=np.uint64).astype(np.uint32)
    x[:4] = [0, 0xFFFF_FFFF, 0x8000_0000, 0xFFFF_FF00]
    enc_j = np.asarray(bidx.keys_to_numpy(
        spec, bidx.encode_axis(spec, jnp.asarray(x)))).astype(np.uint64)
    enc_t = tidx.encode_axis(tspec, torch.as_tensor(x.astype(np.int64)))
    np.testing.assert_array_equal(enc_t.numpy().astype(np.uint64), enc_j)
    dec_j = np.asarray(bidx.decode_axis(
        spec, bidx.keys_from_numpy(spec, enc_j)))
    dec_t = tidx.decode_axis(tspec, enc_t)
    np.testing.assert_array_equal(dec_t.numpy().astype(np.uint32), dec_j)


@pytest.mark.parametrize("spec,tspec", SPEC_PAIRS, ids=SPEC_IDS)
def test_key_fields_match_jax(spec, tspec):
    """make_key, depth_of, level_mask, descendant_max and tz_pack on random
    valid keys, plus the conversion round trip with a pad."""
    origin, depth = random_keys(spec, 3000, seed=2)
    kj = bidx.make_key(spec, [jnp.asarray(o) for o in origin],
                       jnp.asarray(depth))
    kt = tidx.make_key(tspec, [torch.as_tensor(o.astype(np.int64))
                               for o in origin],
                       torch.as_tensor(depth.astype(np.int64)))
    np.testing.assert_array_equal(torch_keys_np(tspec, kt),
                                  jax_keys_np(spec, kj))
    assert torch.equal(jax_to_torch_keys(spec, tspec, kj), kt)

    np.testing.assert_array_equal(tidx.depth_of(tspec, kt).numpy(),
                                  np.asarray(bidx.depth_of(spec, kj)))
    # raw values: Index64_2D's depth-0 descendant_max is 2^63 - 1, which
    # the key conversion would read as the pad
    np.testing.assert_array_equal(
        tidx.descendant_max(tspec, kt).numpy().astype(np.uint64),
        jax_keys_np(spec, bidx.descendant_max(spec, kj)))
    np.testing.assert_array_equal(tidx.tz_pack(tspec, kt).numpy(),
                                  np.asarray(bidx.tz_pack(spec, kj)))
    d = torch.as_tensor(depth.astype(np.int64))
    np.testing.assert_array_equal(
        tidx.level_mask(tspec, d).numpy().astype(np.uint64),
        jax_keys_np(spec, bidx.level_mask(spec, jnp.asarray(depth))))
    for axis, (ot, oj) in enumerate(zip(tidx.origin_of(tspec, kt),
                                        bidx.origin_of(spec, kj))):
        np.testing.assert_array_equal(ot.numpy().astype(np.uint32),
                                      np.asarray(oj), err_msg=str(axis))

    pad = spec.pad_key((3,))
    pt = jax_to_torch_keys(spec, tspec, pad)
    assert torch.all(pt == tidx.PAD_KEY)
    np.testing.assert_array_equal(torch_keys_np(tspec, pt),
                                  jax_keys_np(spec, pad))
    assert int(tidx.depth_of(tspec, pt)[0]) == int(bidx.depth_of(spec,
                                                                 pad)[0])


def test_known_vectors_index64_3d():
    """The reference's own octal vectors (tests/test_index.py)."""
    spec = tidx.Index64_3D
    spread = 0o0_001_111_111_111_111_111_111
    axis = 0o1_777_777 << 13
    assert int(tidx.decode_axis(spec, torch.tensor([spread]))[0]) == axis
    assert int(tidx.encode_axis(spec, torch.tensor([axis]))[0]) == spread
    assert oracle.encode_axis(bidx.Index64_3D, axis) == spread
    zero = 0o0_006_666_666_666_666_666_666
    assert int(tidx.decode_axis(spec, torch.tensor([zero]))[0]) == 0


def test_bit_helpers_exact():
    rng = np.random.default_rng(3)
    x = rng.integers(0, 1 << 62, 5000, dtype=np.int64)
    x[:5] = [0, 1, (1 << 62) - 1, 1 << 61, tidx.PAD_KEY]
    t = torch.as_tensor(x)
    want = np.array([int(v).bit_length() for v in x])
    np.testing.assert_array_equal(tidx.bit_length(t).numpy(), want)
    lsb = np.array([(int(v) & -int(v)).bit_length() - 1 if v else 64
                    for v in x])
    np.testing.assert_array_equal(tidx.ctz64(t).numpy(), lsb)
    u = (x & 0xFFFF_FFFF)
    np.testing.assert_array_equal(
        tidx.clz32(torch.as_tensor(u)).numpy(),
        [32 - int(v).bit_length() for v in u])
    s = torch.arange(64)
    np.testing.assert_array_equal(tidx.mask_below(s).numpy(),
                                  [(1 << int(v)) - 1 for v in s])
