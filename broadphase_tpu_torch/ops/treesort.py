"""Kernel 9: the tree sort of ``layer.build`` (``csrc/treesort.cu``).

Replaces no TPU kernel: the JAX package sorts the tree with ``lax.sort``
(``broadphase_tpu/layer.py::_sort_now``).  The port sorted it with two
stable ``torch.sort`` over the whole capacity, by ``(id << dim) | aux``
and then by key.  The chain packs the live lanes (id not ``PAD_ID``) into
records of the key and a u32 payload, sorts the records by 8-bit LSD
radix passes and writes the sorted columns, pads last.  The payload is
the tiebreak ``t = (id << dim) | aux`` (the id alone once the largest
live id reaches 2^29 - 1, where :func:`mask_aux` zeroes aux), or the
lane where the caller asks for the permutation.  The passes run over the
digits of ``t`` and then of the key; a digit every live record shares is
skipped, and so is every digit of ``t`` when ``t`` never falls from one
live lane to the next, since a stable sort by key then leaves the order
the two stable sorts leave.  Engine emissions are in that order: objects
in input order, slots ascending.

On a CUDA tensor the chain runs on the card with no host read (the
largest id, the live count, the order flag and the plan stay on the
device); on a CPU tensor :func:`tree_sort_plain` runs the same
arithmetic and returns what the two stable sorts return.  Pads carry
``PAD_KEY``, live keys are below ``2^key_bits`` and aux below ``2^dim``.
"""

from __future__ import annotations

import torch

from .. import profiling
from ..index import PAD_KEY, IndexSpec
from . import _cuda

PAD_ID = 0xFFFF_FFFF
DIGIT_BITS = 8
MAX_LANES = 2 ** 31 - 1
# aux is masked once the largest live id reaches this (layer.mask_aux)
NARROW_ID_BOUND = (1 << 29) - 1
# the chain's Info word that counts the passes that work (csrc/treesort.cu)
_PASSES = 3


def key_digits(spec: IndexSpec) -> int:
    """The key's 8-bit digits: ``ceil(key_bits / 8)``."""
    return -(-spec.key_bits // DIGIT_BITS)


def digits_that_work(values: torch.Tensor, digits: int) -> int:
    """How many of the low ``digits`` 8-bit digits of ``values`` (int64,
    non-negative) not every value shares: a stable pass over a shared
    digit moves nothing."""
    if values.numel() == 0:
        return 0
    work = 0
    for p in range(digits):
        digit = (values >> (DIGIT_BITS * p)) & ((1 << DIGIT_BITS) - 1)
        work += bool((digit != digit[0]).any())
    return work


def tree_sort_plain(spec: IndexSpec, keys: torch.Tensor, ids: torch.Tensor,
                    aux: torch.Tensor, want_perm: bool = True):
    """The chain's arithmetic in torch.  Returns (keys, ids, aux, perm,
    passes): the live lanes ordered by (key, id, aux) with ties in lane
    order, then ``PAD_KEY`` / ``PAD_ID`` / 0, aux masked as
    :func:`layer.mask_aux` masks it; the permutation that sorts them (the
    pads' lanes in order last; None unless ``want_perm``); the radix
    passes that do work."""
    lanes = torch.nonzero(ids != PAD_ID).squeeze(1)
    k, i = keys[lanes], ids[lanes]
    max_id = int(i.max()) if i.numel() else 0
    masked = max_id >= NARROW_ID_BOUND
    t = i if masked else (i << spec.dim) | aux[lanes].to(torch.int64)
    t_bits = max_id.bit_length() + (0 if masked else spec.dim)
    in_order = bool((t[1:] >= t[:-1]).all())
    passes = digits_that_work(k, key_digits(spec))
    if in_order:
        order = torch.sort(k, stable=True).indices
    else:
        passes += digits_that_work(t, -(-t_bits // DIGIT_BITS))
        by_t = torch.sort(t, stable=True).indices
        order = by_t[torch.sort(k[by_t], stable=True).indices]
    live = order.shape[0]
    out_keys = torch.full_like(keys, PAD_KEY)
    out_ids = torch.full_like(ids, PAD_ID)
    out_aux = torch.zeros_like(aux)
    out_keys[:live] = k[order]
    out_ids[:live] = i[order]
    if not masked:
        out_aux[:live] = aux[lanes[order]]
    perm = None
    if want_perm:
        perm = torch.cat([lanes[order],
                          torch.nonzero(ids == PAD_ID).squeeze(1)])
    return out_keys, out_ids, out_aux, perm, passes


def tree_sort(spec: IndexSpec, keys: torch.Tensor, ids: torch.Tensor,
              aux: torch.Tensor, want_perm: bool = False):
    """:func:`tree_sort_plain` on a CPU tensor; the chain on a CUDA tensor
    (int64 ``keys`` and ``ids``, int32 ``aux``, of one length).  Returns
    (keys, ids, aux, perm), perm None unless ``want_perm``.  Under
    ``profiling.tracing()`` it counts ``build.sort_passes``, and on the
    card ``k9.launches``."""
    if keys.device.type == "cpu":
        *out, passes = tree_sort_plain(spec, keys, ids, aux, want_perm)
        profiling.count("build.sort_passes", passes)
        return tuple(out)
    n = ids.shape[0]
    if (keys.dtype != torch.int64 or ids.dtype != torch.int64
            or aux.dtype != torch.int32
            or not keys.shape == ids.shape == aux.shape == (n,)):
        raise ValueError("tree_sort: keys and ids int64 and aux int32, all "
                         "of one length")
    if n > MAX_LANES:
        raise ValueError(f"tree_sort takes at most {MAX_LANES} lanes, got "
                         f"{n}")
    _cuda.require_cuda("tree_sort", keys, ids, aux)
    dev = keys.device
    out_keys, out_ids = torch.empty_like(keys), torch.empty_like(ids)
    out_aux = torch.empty_like(aux)
    perm = torch.empty_like(ids) if want_perm else None
    if n == 0:
        profiling.count("build.sort_passes", 0)
        return out_keys, out_ids, out_aux, perm
    # one workspace of int64 words for the records' keys (two buffers of
    # n u64), their payloads and, by lane, the pads' lanes (n u32 each);
    # the chain's scratch apart, so that the passes counter holds on to
    # no more than it (its Info words first, then its histograms, tickets,
    # status words and the bound's partial maxima; the chain clears it)
    u32s = (n + 1) // 2
    buffers = [n, n, u32s, u32s] + ([u32s] if want_perm else [])
    ws = torch.empty(sum(buffers), dtype=torch.int64, device=dev)
    at = [ws.data_ptr() + 8 * sum(buffers[:i]) for i in range(len(buffers))]
    scratch = torch.empty(_cuda.treesort_scratch(n), dtype=torch.int64,
                          device=dev)
    _cuda.launch("bpt_treesort", keys, ids, aux, *at[:4],
                 at[4] if want_perm else 0, out_keys, out_ids, out_aux,
                 0 if perm is None else perm, scratch, n, spec.dim,
                 key_digits(spec), int(want_perm))
    profiling.count("k9.launches", 1)
    profiling.count("build.sort_passes", scratch[_PASSES])
    return out_keys, out_ids, out_aux, perm
