"""Deterministic scene generation: the reference's ``gen_boxes``.

The port's own copy of ``broadphase_tpu/utils/gen.py`` (numpy only; it
returns this package's :class:`~broadphase_tpu_torch.scene.Scene`, and
``tests/test_torch_gen.py`` holds it bit for bit against the original).
It replicates the RNG pipeline of ``utils/src/gen_test_data.rs:137-155``
so that the reference's test scenes regenerate bit for bit (its binary
fixtures are Git LFS pointers with no payload):

* ``ChaChaRng::seed_from_u64(seed)``: rand_core 0.5's default
  ``seed_from_u64`` expands the u64 through PCG32 (PCG-XSH-RR with the
  standard multiplier/increment) into a 32-byte key.
* ChaCha20 (djb variant: 64-bit block counter + 64-bit stream, both 0)
  generates the word stream; ``next_u32`` consumes words in order.
* ``Rng::gen_range(low, high)`` for f32 (rand 0.7 ``UniformFloat
  ::sample_single``): ``value0_1 = f32_from_bits((u32 >> 9) | 0x3f800000) -
  1.0``; result = ``value0_1 * scale + low`` (mul then add, f32 each step),
  retrying with a nudged-down scale if result >= high.
* Per box: 3 sizes (x,y,z), then 3 min-corner coords, in that order
  (``gen_test_data.rs:140-150``); ids are 0..n (``:155``).

Scene shape derivation (``gen_test_data.rs:98-125``): given count+density,
``linear_size = cbrt(count/density) + avg_box_size`` and system bounds =
[0, linear_size]^3; given bounds+density, ``count = density *
prod(sizef - avg_box_size)``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from .scene import Scene, SceneLayer

_PCG_MUL = 6364136223846793005
_PCG_INC = 11634580027462260723
_M64 = (1 << 64) - 1


def seed_from_u64(seed: int) -> bytes:
    """rand_core 0.5 ``SeedableRng::seed_from_u64``: PCG32 expansion."""
    state = seed & _M64
    out = bytearray()
    for _ in range(8):
        state = (state * _PCG_MUL + _PCG_INC) & _M64
        xorshifted = (((state >> 18) ^ state) >> 27) & 0xFFFF_FFFF
        rot = state >> 59
        x = ((xorshifted >> rot) | (xorshifted << ((32 - rot) & 31))) \
            & 0xFFFF_FFFF
        out += x.to_bytes(4, "little")
    return bytes(out)


def _rotl(x: np.ndarray, n: int) -> np.ndarray:
    return (x << np.uint32(n)) | (x >> np.uint32(32 - n))


def chacha20_words(key: bytes, counter0: int, nblocks: int) -> np.ndarray:
    """ChaCha20 keystream: ``nblocks`` 64-byte blocks from ``counter0``,
    64-bit counter + 64-bit stream(=0) layout (djb / rand_chacha variant).
    Returns (nblocks, 16) uint32, vectorized over blocks."""
    k = np.frombuffer(key, "<u4").astype(np.uint32)
    assert k.shape == (8,)
    const = np.array([0x61707865, 0x3320646E, 0x79622D32, 0x6B206574],
                     np.uint32)
    n = nblocks
    ctr = (np.arange(counter0, counter0 + n, dtype=np.uint64))
    state = np.zeros((16, n), np.uint32)
    state[0:4] = const[:, None]
    state[4:12] = k[:, None]
    state[12] = (ctr & np.uint64(0xFFFF_FFFF)).astype(np.uint32)
    state[13] = (ctr >> np.uint64(32)).astype(np.uint32)
    state[14] = 0
    state[15] = 0
    x = state.copy()

    def qr(a, b, c, d):
        x[a] += x[b]; x[d] = _rotl(x[d] ^ x[a], 16)
        x[c] += x[d]; x[b] = _rotl(x[b] ^ x[c], 12)
        x[a] += x[b]; x[d] = _rotl(x[d] ^ x[a], 8)
        x[c] += x[d]; x[b] = _rotl(x[b] ^ x[c], 7)

    with np.errstate(over="ignore"):
        for _ in range(10):
            qr(0, 4, 8, 12)
            qr(1, 5, 9, 13)
            qr(2, 6, 10, 14)
            qr(3, 7, 11, 15)
            qr(0, 5, 10, 15)
            qr(1, 6, 11, 12)
            qr(2, 7, 8, 13)
            qr(3, 4, 9, 14)
        x += state
    return x.T.copy()                      # (nblocks, 16) words in order


class ChaCha20Rng:
    """Word-stream RNG equivalent to rand_chacha 0.2 ``ChaChaRng``."""

    def __init__(self, seed: int):
        self.key = seed_from_u64(seed)
        self._buf = np.zeros(0, np.uint32)
        self._pos = 0
        self._counter = 0

    def _refill(self, min_words: int):
        nblocks = max(64, (min_words + 15) // 16)
        words = chacha20_words(self.key, self._counter, nblocks)
        self._counter += nblocks
        rest = self._buf[self._pos:]
        self._buf = np.concatenate([rest, words.reshape(-1)])
        self._pos = 0

    def next_u32(self) -> int:
        if self._pos >= len(self._buf):
            self._refill(1)
        v = int(self._buf[self._pos])
        self._pos += 1
        return v

    def next_u32_batch(self, n: int) -> np.ndarray:
        if len(self._buf) - self._pos < n:
            self._refill(n)
        out = self._buf[self._pos:self._pos + n]
        self._pos += n
        return out

    def gen_range_f32(self, low: float, high: float) -> np.float32:
        """rand 0.7 ``UniformFloat::<f32>::sample_single``."""
        low = np.float32(low)
        scale = np.float32(np.float32(high) - low)
        while True:
            bits = (self.next_u32() >> 9) | 0x3F80_0000
            value1_2 = np.frombuffer(
                np.uint32(bits).tobytes(), "<f4")[0]
            value0_1 = np.float32(value1_2 - np.float32(1.0))
            res = np.float32(np.float32(value0_1 * scale) + low)
            if res < np.float32(high):
                return res
            # rand's decrease_masked: nudge scale down one ulp
            scale = np.float32(np.nextafter(scale, np.float32(-np.inf)))


def _gen_range_f32_batch(u32s: np.ndarray, low: np.ndarray,
                         scale: np.ndarray) -> np.ndarray:
    """Vectorized common case of sample_single (no retry needed)."""
    bits = (u32s >> np.uint32(9)) | np.uint32(0x3F80_0000)
    v12 = bits.view(np.float32)
    v01 = (v12 - np.float32(1.0)).astype(np.float32)
    return (v01 * scale + low).astype(np.float32)


def gen_boxes(count: Optional[int] = None,
              density: Optional[float] = None,
              size_range: Tuple[float, float] = (1.0, 10.0),
              seed: int = 0,
              system_bounds: Optional[Tuple[np.ndarray, np.ndarray]] = None,
              ) -> Scene:
    """Port of the ``gen_boxes`` subcommand (``gen_test_data.rs:28-169``)."""
    s0, s1 = np.float32(size_range[0]), np.float32(size_range[1])
    avg = np.float32((s0 + s1) / np.float32(2.0))

    if count is None:
        if density is None or system_bounds is None:
            raise ValueError("need density + bounds to derive count")
        size = (np.asarray(system_bounds[1], np.float32)
                - np.asarray(system_bounds[0], np.float32))
        volume = np.prod((size - avg).astype(np.float32))
        count = int(np.float32(density) * volume)

    if system_bounds is None:
        if density is None:
            raise ValueError("need density to derive bounds")
        volume = np.float32(count) / np.float32(density)
        linear = np.float32(np.cbrt(volume) + avg)
        smin = np.zeros(3, np.float32)
        smax = np.full(3, linear, np.float32)
    else:
        smin = np.asarray(system_bounds[0], np.float32)
        smax = np.asarray(system_bounds[1], np.float32)

    if np.any((smax - smin) < s1):
        raise ValueError("object size larger than system bounds")

    rng = ChaCha20Rng(seed)

    # fast path: draw 6 words per box; fall back to the scalar loop for
    # boxes where sample_single would retry (res >= high), which replicates
    # the reference's rare rejection branch exactly.
    words = rng.next_u32_batch(6 * count).reshape(count, 6)
    sizes = _gen_range_f32_batch(
        words[:, 0:3], s0, np.float32(s1 - s0))
    lows = smin[None, :].astype(np.float32)
    scales = ((smax[None, :] - sizes) - lows).astype(np.float32)
    mins = _gen_range_f32_batch(words[:, 3:6], lows, scales)
    bad_size = ~(sizes < s1)
    bad_min = ~(mins < (smax[None, :] - sizes))
    bad = np.any(bad_size, axis=1) | np.any(bad_min, axis=1)
    if np.any(bad):
        # exact per-box replay for the rare retry cases: rerun the whole
        # stream sequentially (correctness over speed on this path)
        rng = ChaCha20Rng(seed)
        sizes = np.zeros((count, 3), np.float32)
        mins = np.zeros((count, 3), np.float32)
        for i in range(count):
            for a in range(3):
                sizes[i, a] = rng.gen_range_f32(s0, s1)
            for a in range(3):
                mins[i, a] = rng.gen_range_f32(
                    smin[a], np.float32(smax[a] - sizes[i, a]))

    maxs = (mins + sizes).astype(np.float32)
    ids = np.arange(count, dtype=np.uint32)
    return Scene(smin, smax, mins, maxs, ids, SceneLayer(),
                 np.zeros((0, 2), np.uint32), np.zeros(0, np.uint32), None)
