"""On-card smoke test of broadphase_tpu_torch: builds the seven CUDA kernels,
holds each against its plain PyTorch version (kernel 2, pass 1 of the scan,
also against the run ends of the adjacent-LCA depths; kernel 1 slot for
slot, also when the tree overflows; kernel 7 on both of its entry points),
drives the build + scan step at 30k and 1M boxes against the C++ oracle,
the v2 scan at 1M, and the temporal-coherence update path at 1M boxes and
four churn fractions (and a wide-ids frame) against a fresh build, aux
bits included, and the oracle.  Then the rest of the layer surface and
the linear queries: the static + dynamic merge (kernel 6) and clear +
extend (kernel 1) at 1M against the fresh build, scan_filtered at 1M and
nested_ids at 100k against the oracle, scan_auto at 30k, a BR_SCENE round
trip at 1M, box, ray and pick queries at 1M (the linear engine) and the
ball pit's frame against the CPU path.  Then the sublinear tree engine at
1M against the linear engine, the batched queries at 1M against single
queries, and the generic traversals (test_generic against test_box at
1M, a non-monotone band and the ordered picks against the CPU path at
30k, one ordered ray pick at 1M).  Last, the sharded surface at 1M, as
world 1 under NCCL and as four ranks sharing the card over a gloo group
(spawned by ``parallel.run_ranks``): step, build + scan, gather / shard,
the 90% + 10% merge, batched queries and a 1% update against the
oracle, the single-chip path and a fresh sharded build.  Then the tools
and the demo: the ball-pit demo (``examples.ball_pit``) at 2,500 balls
in its three modes, 300 frames each, every 30th frame against the CPU
path and its circle hits against brute force; the CLI's golden trio
(``tools gen_boxes`` + ``gen_validation_data``) at 10k and 1M against
the C++ oracle; the step and update profilers at 1M with their stage
tables; and the profiling utilities.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Every phase prints one line.  Any failure exits non-zero before the last
line; on success the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}``.
Without CUDA the script exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import hashlib
import io
import json
import re
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from broadphase_tpu_torch import (Index32_2D, Index64_2D, Index64_3D,
                                  bench_caps, geom, layer, parallel,
                                  profiling, query, singleq, traverse)
from broadphase_tpu_torch.examples import ball_pit
from broadphase_tpu_torch.tools import __main__ as cli
from broadphase_tpu_torch.tools import profile_step, profile_update
from broadphase_tpu_torch import scene as br_scene
from broadphase_tpu_torch import oracle as native
from broadphase_tpu_torch import update as upd
from broadphase_tpu_torch.index import PAD_KEY, depth_of
from broadphase_tpu_torch.ops import _cuda
from broadphase_tpu_torch.ops.build import emit_build, emit_build_plain
from broadphase_tpu_torch.ops.compact import (stream_compact,
                                              stream_compact_plain)
from broadphase_tpu_torch.ops.expand import (expand_pairs,
                                             expand_pairs_entries,
                                             expand_pairs_entries_plain,
                                             expand_pairs_plain)
from broadphase_tpu_torch.ops.expand2 import (expand_pairs_prepped,
                                              expand_pairs_prepped_plain)
from broadphase_tpu_torch.ops.merge import (merge_cancel_compact,
                                            merge_cancel_compact_plain)
from broadphase_tpu_torch.ops.prep import prep_runs, prep_runs_plain
from broadphase_tpu_torch.ops.runends import (adjacent_lca_depth,
                                              alpha_meta, run_ends_plain,
                                              scan_pass1, scan_pass1_plain)

SPEC = Index64_3D
# kernels 4 and 7 are one template, expand_partitioned_kernel<kRule>; the
# profiler shows its demangled or its mangled name
K4_NAMES = ("expand_partitioned_kernel<true>",
            "expand_partitioned_kernelILb1E")
K7_NAMES = ("expand_partitioned_kernel<false>",
            "expand_partitioned_kernelILb0E")
KERNELS = {
    # name: (wrapper, source, TPU kernel it replaces, path whose launches
    # the kernels line reports, names of the device work its entry point
    # launches, as the profiler shows them)
    "emit_build": (emit_build, "broadphase_tpu_torch/csrc/build.cu",
                   "broadphase_tpu/ops/pallas_build.py:290", "step",
                   ("build_kernel", "Memset")),
    "run_ends": (scan_pass1, "broadphase_tpu_torch/csrc/runends.cu",
                 "broadphase_tpu/ops/pallas_runends.py:103", "step",
                 ("pass1_kernel", "Memset")),
    "prep_runs": (prep_runs, "broadphase_tpu_torch/csrc/prep.cu",
                  "broadphase_tpu/ops/pallas_prep.py:173", "step",
                  ("prep_onepass", "Memset")),
    "expand_pairs_prepped": (expand_pairs_prepped,
                             "broadphase_tpu_torch/csrc/expand2.cu",
                             "broadphase_tpu/ops/pallas_expand2.py:307",
                             "step", K4_NAMES),
    "stream_compact": (stream_compact, "broadphase_tpu_torch/csrc/compact.cu",
                       "broadphase_tpu/ops/pallas_compact.py:200", "step",
                       ("compact_onepass", "Memset")),
    "merge_cancel_compact": (merge_cancel_compact,
                             "broadphase_tpu_torch/csrc/merge.cu",
                             "broadphase_tpu/ops/pallas_merge.py:263",
                             "frame", ("merge_path", "Memset")),
    # kernel 7: the v2 scan calls the entries' wrapper; expand_pairs (the
    # JAX function's contract) runs kernel 5 and then that wrapper
    "expand_pairs": (expand_pairs_entries,
                     "broadphase_tpu_torch/csrc/expand2.cu",
                     "broadphase_tpu/ops/pallas_expand.py:203", "scan_v2",
                     K7_NAMES),
}

# The least time the card could take: the
# bytes a function must move at the H100 SXM's 3.35 TB/s, or its integer
# operations at 132 SMs x 64 INT32 lanes x 1.98 GHz, whichever is longer.
# Every kernel here does a few integer operations per 8-byte element, far
# below the ~5 operations per byte at which the lanes would limit, so the
# operations are counted as 2 per element read or written.
HBM_BYTES_PER_S = 3.35e12
INT_OPS_PER_S = 132 * 64 * 1.98e9


# device kernels by layer, matched on the kernel's name; the rest of the
# device time is torch's elementwise and indexing glue
LAYER_OF_KERNEL = (("build_kernel", "k1 build"),
                   ("pass1_kernel", "k2 pass 1 (run ends, rule bytes)"),
                   ("prep_onepass", "k3 prep"),
                   *((k, "k7 expand v2") for k in K7_NAMES),
                   ("expand_partitioned", "k4 expand"),
                   ("compact_onepass", "k5 compact"),
                   ("merge_path", "k6 merge"),
                   ("RadixSort", "torch.sort"), ("Memcpy", "copies"),
                   ("Memset", "copies"))


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median device time of fn() in ms, CUDA events around each call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms_by_layer(run, reps: int = 5):
    """Device time per call of run() by layer (torch.profiler), in ms, and
    the device operations (kernels, copies, fills) per call; fails if no
    profiler window shows a device event (profiling.device_events)."""
    events = profiling.device_events(run, reps)
    check(events is not None, "the profiler shows no device events")
    by_layer = {}
    for key, (ms, _) in events.items():
        name = next((lab for k, lab in LAYER_OF_KERNEL if k in key),
                    "torch glue")
        by_layer[name] = by_layer.get(name, 0.0) + ms
    return by_layer, sum(count for _, count in events.values())


def kernel_device_ms(fn, names=None, reps: int = 10) -> float:
    """Device time per call of fn() in ms (torch.profiler, summed over reps
    calls after one warm-up): the device work whose name holds one of
    ``names``, or all of it when names is None; fails if no profiler
    window shows such work (profiling.device_events).  Unlike cuda_ms it
    leaves out the host's enqueue of the call's allocations and
    launches."""
    fn()
    torch.cuda.synchronize()
    events = profiling.device_events(
        fn, reps, keep=None if names is None
        else lambda key: any(k in key for k in names))
    check(events is not None, "the profiler shows no device time under "
          f"{names}")
    return sum(ms for ms, _ in events.values())


def ptxas_summary(names) -> list:
    """Registers, shared memory and spills of each kernel whose mangled
    name holds one of ``names``, from the build's ``-Xptxas=-v`` report;
    a template's integer and bool arguments follow its name
    (``build_kernel<3,2>``, ``prep_onepass<1>``)."""
    log = _cuda.ptxas_log(_cuda.library_path())
    fn, spill, out = None, "", []
    for line in log.read_text().splitlines():
        if "Compiling entry function" in line:
            fn = next((k for k in names if k in line), None)
            targs = re.findall(r"L[ib](-?\d+)E", line)
            if fn and targs:
                fn += "<" + ",".join(targs) + ">"
            spill = ""
        elif fn and "spill" in line:
            spill = line.strip()
        elif fn and "Used" in line:
            out.append(f"{fn}: {line.split(':', 1)[1].strip()}; {spill}")
            fn = None
    return out


def bound(nbytes: float):
    """(bound_ms, bound_by) for a function that moves nbytes bytes."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = 2 * (nbytes / 8) / INT_OPS_PER_S * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms,
                                                          "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def max_abs_err(got, want) -> float:
    """Largest |got - want| over paired tensors; fails on any difference,
    since every kernel must match its plain version exactly."""
    err = 0.0
    for g, w in zip(got, want):
        g = torch.as_tensor(g).reshape(-1)
        w = torch.as_tensor(w, device=g.device).reshape(-1)
        check(g.shape == w.shape, f"shape {tuple(g.shape)} != "
              f"{tuple(w.shape)}")
        if g.numel():
            d = (g.double() - w.double()).abs().max().item()
            err = max(err, d)
            check(bool(torch.equal(g.to(w.dtype), w)),
                  f"values differ (max abs {d})")
    return err


# ---------------------------------------------------------------------------
# The step's kernel inputs, computed as layer.build / layer.scan_pairs do
# ---------------------------------------------------------------------------

def build_inputs(scene, dev):
    smin, smax, bmin, bmax, ids = scene
    smin_t = torch.as_tensor(smin, device=dev)
    smax_t = torch.as_tensor(smax, device=dev)
    bmin_t = torch.as_tensor(bmin, device=dev)
    bmax_t = torch.as_tensor(bmax, device=dev)
    return (geom.to_local(smin_t, smax_t, bmin_t),
            geom.to_local(smin_t, smax_t, bmax_t),
            geom.bounds_contains(smin_t, smax_t, bmin_t, bmax_t),
            torch.as_tensor(ids.astype(np.int64), device=dev))


def pass1_glue(keys, aux):
    """The torch operations that pass 1 absorbed, as the step ran them
    before it: the adjacent-LCA depths, the depth column and both rule
    bytes (the plain version of pass 1 without its run-ends loop)."""
    dep = depth_of(SPEC, keys)
    lca = adjacent_lca_depth(SPEC, keys)
    bmeta = ((dep << SPEC.dim) | (aux & 7)) & 0xFF
    return lca, dep, bmeta, alpha_meta(SPEC, keys, dep, aux)


def compare_pass1(spec, keys, aux):
    """Kernel 2 against its plain version, (e, ameta, bmeta) and e alone
    without the rule bytes, and its e against run_ends_plain of the
    adjacent-LCA depths.  Returns (max_abs_err, the kernel's columns)."""
    got = scan_pass1(spec, keys, aux)
    err = max_abs_err(got, scan_pass1_plain(spec, keys, aux))
    e_only, no_a, no_b = scan_pass1(spec, keys, aux, rules=False)
    check(no_a is None and no_b is None, "scan_pass1: rule bytes without "
          "rules")
    lca = adjacent_lca_depth(spec, keys)
    want_e = run_ends_plain(lca, depth_of(spec, keys), spec.axis_bits + 1)
    err = max(err, max_abs_err((got[0], e_only), (want_e, want_e)))
    return err, got


def compare_build(inputs, out_cap, spec=SPEC, min_depth=0, slots=2):
    """Kernel 1 against its plain version: the cells slot for slot (the
    same object-major prefix when count > out_cap), count and cell-overflow
    flag, exact.  Returns (max_abs_err, the plain version's (count,
    flag))."""
    args = (spec, *inputs, min_depth, out_cap, slots)
    want = emit_build_plain(*args)
    err = max_abs_err(emit_build(*args), want)
    return err, (int(want[3]), bool(want[4]))


def compare_all(state, inputs, emit_cap):
    """Kernels 1-5 and 7 against their plain versions on one step's inputs
    (kernel 3 also without meta and kernel 7 on both entry points, as the
    v2 scan and the JAX function's contract run them).  Returns ({name:
    max_abs_err}, {name: (args, plain function, bytes the function moves,
    library call or None)}, {name: the same for the v2 scan's kernel 3 and
    the JAX-shaped kernel 7})."""
    errs, timed = {}, {}
    cap = state.keys.shape[0]
    errs["emit_build"], _ = compare_build(inputs, cap)
    timed["emit_build"] = ((SPEC, *inputs, 0, cap), emit_build_plain,
                           nbytes(*inputs) + 20 * cap, None)

    keys, aux = state.keys, state.aux
    errs["run_ends"], (e, ameta, bmeta) = compare_pass1(SPEC, keys, aux)
    timed["run_ends"] = ((SPEC, keys, aux), scan_pass1_plain,
                         nbytes(keys, aux, e, ameta, bmeta), None)
    lane = torch.arange(cap, device=keys.device)
    rule = (torch.where(lane < state.count, state.ids, 0).max()
            < layer._RULE_ID_BOUND)

    prepped = prep_runs(e, state.ids, bmeta, state.count)
    errs["prep_runs"] = max_abs_err(
        prepped, prep_runs_plain(e, state.ids, bmeta, state.count))
    timed["prep_runs"] = ((e, state.ids, bmeta, state.count),
                          prep_runs_plain,
                          nbytes(e, state.ids, bmeta, *prepped[:4]), None)

    sv, ab, bid, bm, m, total, _ = prepped
    xargs = (state.ids, ameta, sv, ab, bid, bm, m, total, emit_cap, rule,
             SPEC.dim)
    a, b = expand_pairs_prepped(*xargs)
    errs["expand_pairs_prepped"] = max_abs_err(
        (a, b), expand_pairs_prepped_plain(*xargs))
    # the live tree's ids and a-side bytes, the m live entries, the slots
    timed["expand_pairs_prepped"] = (
        xargs, expand_pairs_prepped_plain,
        12 * int(state.count) + 28 * int(m) + nbytes(a, b), None)

    valid = a != b
    got, cnt = stream_compact(valid, (a, b))
    want, want_cnt = stream_compact_plain(valid, (a, b))
    errs["stream_compact"] = max_abs_err(got + (cnt,), want + (want_cnt,))
    timed["stream_compact"] = ((valid, (a, b)), stream_compact_plain,
                               nbytes(valid, a, b) + nbytes(*got),
                               lambda: (a[valid], b[valid]))

    # the v2 scan on the same tree: kernel 3 without meta, then kernel 7 on
    # its entries; and kernel 7 through the JAX function's contract
    v2_prep = (e, state.ids, None, state.count)
    prepped_v2 = prep_runs(*v2_prep)
    check(prepped_v2[3] is None, "prep_runs: a bmeta column without meta")
    no_bm = prepped_v2[:3] + prepped_v2[4:]
    want_v2 = prep_runs_plain(*v2_prep)
    errs["prep_runs"] = max(errs["prep_runs"], max_abs_err(
        no_bm, want_v2[:3] + want_v2[4:]),
        max_abs_err(no_bm, prepped[:3] + prepped[4:]))
    extra = {"prep_runs (no meta, v2 scan)": (
        prep_runs, v2_prep, prep_runs_plain,
        nbytes(e, state.ids, *prepped_v2[:3]), ("prep_onepass", "Memset"))}
    sv2, ab2, bid2, _, m2, total2, _ = prepped_v2
    vargs = (state.ids, sv2, ab2, bid2, m2, total2, emit_cap)
    got = expand_pairs_entries(*vargs)
    errs["expand_pairs"] = max_abs_err(got, expand_pairs_entries_plain(*vargs))
    # the live tree's ids, the m entries' sv/ab/bid, the slots
    timed["expand_pairs"] = (vargs, expand_pairs_entries_plain,
                             8 * int(state.count) + 24 * int(m2)
                             + nbytes(*got), None)
    starts, run, v2_total = layer.runs_v2(e, state.count)
    jargs = (state.ids, starts, run, v2_total, emit_cap)
    jgot = expand_pairs(*jargs)
    errs["expand_pairs"] = max(errs["expand_pairs"], max_abs_err(
        jgot, expand_pairs_plain(*jargs)), max_abs_err(jgot, got))
    extra["expand_pairs (JAX contract: k5 + k7)"] = (
        expand_pairs, jargs, expand_pairs_plain,
        nbytes(state.ids, starts, run) + nbytes(*jgot),
        K7_NAMES + ("compact_onepass", "Memset"))
    return errs, timed, extra


def compare_merge(args):
    """Kernel 6 against its plain version: ((key, meta), count) exact."""
    (gk, gm), gc, govf = merge_cancel_compact(*args)
    (wk, wm), wc, wovf = merge_cancel_compact_plain(*args)
    check(not bool(govf), "merge_cancel_compact: window overflow set")
    return max_abs_err((gk, gm, gc), (wk, wm, wc))


# ---------------------------------------------------------------------------
# Adversarial kernel cases (exact equality, untimed)
# ---------------------------------------------------------------------------

def with_box(scene, lo_frac, hi_frac, n_boxes, seed):
    """The scene plus n_boxes cubes of edge (hi_frac - lo_frac) of the
    system box, placed at random; ids continue after the scene's."""
    smin, smax, bmin, bmax, ids = scene
    rng = np.random.default_rng(seed)
    ext = smax - smin
    edge = (hi_frac - lo_frac) * ext
    lo = smin + rng.uniform(0, 1, (n_boxes, len(smin))) * (ext - edge)
    lo = lo.astype(np.float32)
    hi = (lo + edge).astype(np.float32)
    new_ids = np.arange(len(ids), len(ids) + n_boxes, dtype=np.uint32)
    return (smin, smax, np.concatenate([bmin, lo]),
            np.concatenate([bmax, hi]), np.concatenate([ids, new_ids]))


def adversarial(dev):
    gen = torch.Generator(device="cpu").manual_seed(0)
    n_cases = 0

    def to(x):
        return x.to(dev)

    # stream_compact: empty, one element, ragged sizes, all / none kept
    for n in (0, 1, 2, 2047, 2049, 5000):
        for mode in ("random", "all", "none"):
            keep = {"random": torch.rand(n, generator=gen) < 0.4,
                    "all": torch.ones(n, dtype=torch.bool),
                    "none": torch.zeros(n, dtype=torch.bool)}[mode]
            cols = (torch.randint(0, 2 ** 40, (n,), generator=gen),
                    torch.arange(n, dtype=torch.int64))
            got = stream_compact(to(keep), tuple(map(to, cols)), (7, -1))
            want = stream_compact_plain(keep, cols, (7, -1))
            max_abs_err(got[0] + (got[1],), want[0] + (want[1],))
            n_cases += 1

    # emit_build / run_ends / prep / expand on small trees: one object, a
    # depth-0 object spanning the system, shallow boxes, objects outside
    # the system box, an undersized tree, ids either side of 2^24 - 1
    base = bench_caps.bench_scene(3, 3000, seed=1)
    scenes = {
        "one": tuple(x[:1] if i >= 2 else x for i, x in enumerate(base)),
        "depth0": with_box(base, 0.0, 1.0, 1, 2),
        "shallow": with_box(base, 0.0, 0.3, 40, 3),
        "outside": (base[0], base[1], base[2] - 50.0, base[3] - 50.0,
                    base[4]),
        "wide_ids": base[:4] + ((base[4] + (1 << 24) - 1500)
                                .astype(np.uint32),),
    }
    for name, scene in scenes.items():
        inputs = build_inputs(scene, dev)
        n = inputs[3].shape[0]
        for out_cap in (8 * n, max(1, n // 2)):
            compare_build(inputs, out_cap)
            n_cases += 1
        state = layer.build(SPEC, *scene, out_capacity=8 * n, device=dev)
        for emit_cap in (64 * n + 1, 1000):  # the second is below total
            compare_all(state, inputs, emit_cap)
            n_cases += 5
    return (n_cases + pass1_adversarial(dev) + compact_adversarial(dev)
            + prep_adversarial(dev) + build_adversarial(dev)
            + expand2_adversarial(dev) + merge_adversarial(dev)
            + expand_adversarial(dev))


def synthetic_keys(spec, n, digits, pad_from, seed):
    """n sorted keys whose top Morton digit takes the values ``digits`` in
    equal shares (so lca = 0 only where it changes), with random lower
    bits, random depth fields up to the field's top (depths past axis_bits
    read as pads), some exact duplicates, and PAD_KEY from ``pad_from``."""
    rng = np.random.default_rng(seed)
    low = spec.key_bits - spec.dim
    parts = np.array_split(np.arange(n), len(digits))
    keys = np.concatenate([(np.int64(d) << np.int64(low))
                           | rng.integers(0, 1 << low, len(part))
                           for d, part in zip(digits, parts)])
    keys = (keys & ~np.int64(spec.depth_mask)) | rng.integers(
        0, spec.depth_mask + 1, n)
    dup = rng.random(n) < 0.05
    keys[1:][dup[1:]] = keys[:-1][dup[1:]]
    keys = np.sort(keys)
    keys[pad_from:] = PAD_KEY
    return keys


def pass1_adversarial(dev):
    """Kernel 2 on what a single-pass look-back over the later tiles can
    get wrong: n = 1 and 2 and one below, at and above a tile multiple,
    1000+ tiles, the three specs, a depth-0 box, lca = 0 boundaries many
    tiles apart (the look-back of levels 1-2 crosses them), pads starting
    mid-tile, aux all zero and all set, and two calls in a row on one
    stream (stale status words); each with and without the rule bytes."""
    tile = _cuda.runends_tile()
    rng = np.random.default_rng(4)
    n_cases = 0

    def run(spec, keys, aux):
        nonlocal n_cases
        keys = torch.as_tensor(keys, device=dev)
        aux = torch.as_tensor(aux, dtype=torch.int32, device=dev)
        compare_pass1(spec, keys, aux)
        n_cases += 1

    for spec in (Index64_3D, Index64_2D, Index32_2D):
        full = (1 << spec.dim) - 1
        for n, digits, pad_from in (
                (1, (0,), 1), (2, (0, 1), 2), (2, (1,), 1),
                (3 * tile - 1, (0, 1), 2 * tile + 777),
                (3 * tile, (2,), 3 * tile), (3 * tile + 1, (0, 3), tile + 1),
                (1001 * tile + 5, (0, 1, 2, full), 1000 * tile + 2049)):
            keys = synthetic_keys(spec, n, digits, pad_from, n_cases)
            for aux in (np.zeros(n), np.full(n, full),
                        rng.integers(0, full + 1, n)):
                run(spec, keys, aux)
        scene = with_box(bench_caps.bench_scene(spec.dim, 20_000, seed=13),
                         0.0, 1.0, 1, 14)                   # a depth-0 box
        state = layer.build(spec, *scene, out_capacity=5 * 20_000 + 3,
                            device=dev)
        compare_pass1(spec, state.keys, state.aux)
        n_cases += 1
    # two calls in a row on the stream: the second reuses the first's
    # scratch, so a status word left over from the first would show
    a = torch.as_tensor(synthetic_keys(Index64_3D, 9 * tile + 3, (0, 7),
                                       9 * tile, 1), device=dev)
    b = torch.as_tensor(synthetic_keys(Index64_3D, 9 * tile + 3, (1,),
                                       5 * tile + 1, 2), device=dev)
    aux = torch.zeros(9 * tile + 3, dtype=torch.int32, device=dev)
    got_a, got_b = (scan_pass1(Index64_3D, k, aux) for k in (a, b))
    for got, k in ((got_a, a), (got_b, b)):
        max_abs_err(got, scan_pass1_plain(Index64_3D, k, aux))
    # lengths the kernel refuses, checked without allocating them
    small = torch.zeros(8, dtype=torch.int64, device=dev)
    try:
        _cuda.launch("bpt_runends", small, None, small, small, small, small,
                     2 ** 31 - 5, 3, 62, 19, 5, 1, 2, 4, 1)
    except RuntimeError:
        pass
    else:
        raise SmokeFailure("kernel 2 took n >= 2^31 - tile")
    return n_cases + 3


def compact_adversarial(dev):
    """Kernel 5 on what a single-pass tiled design can get wrong: 8k+
    tiles, tiles alternating all-kept and none-kept, one kept lane in the
    last tile, lengths one below, at and one above a tile multiple, 1, 3
    and 4 columns with distinct fills, and two calls in a row on one stream
    (stale status words)."""
    tile = _cuda.compact_tile()
    gen = torch.Generator(device=dev).manual_seed(7)
    fills = (7, -1, 1 << 40, -12345)

    def cols_of(n, k):
        lane = torch.arange(n, dtype=torch.int64, device=dev)
        return tuple(lane * (2 * j + 3) - j for j in range(k))

    def rand_keep(n, p=0.5):
        return torch.rand(n, generator=gen, device=dev) < p

    cases = [(rand_keep(8200 * tile + 5), 1)]                 # 8k+ tiles
    lane = torch.arange(40 * tile + 7, device=dev)
    cases.append(((lane // tile) % 2 == 0, 2))          # alternating tiles
    lane = torch.arange(37 * tile + 100, device=dev)
    cases.append((lane == lane.shape[0] - 3, 2))   # one kept, in the last tile
    cases += [(rand_keep(3 * tile + d), 2) for d in (-1, 0, 1)]
    cases += [(rand_keep(5 * tile + 17, 0.3), k) for k in (1, 3, 4)]
    for keep, k in cases:
        cols = cols_of(keep.shape[0], k)
        got = stream_compact(keep, cols, fills[:k])
        want = stream_compact_plain(keep, cols, fills[:k])
        max_abs_err(got[0] + (got[1],), want[0] + (want[1],))
    # two calls in a row on the stream: the second reuses the first's
    # scratch, so a status word left over from the first would show
    k1, k2 = rand_keep(9 * tile + 3, 0.9), rand_keep(9 * tile + 3, 0.1)
    cols = cols_of(9 * tile + 3, 2)
    got1 = stream_compact(k1, cols)
    got2 = stream_compact(k2, cols)
    for got, keep in ((got1, k1), (got2, k2)):
        want = stream_compact_plain(keep, cols)
        max_abs_err(got[0] + (got[1],), want[0] + (want[1],))
    return len(cases) + 2


def prep_adversarial(dev):
    """Kernel 3 on what a single-pass tiled design can get wrong: 1000+
    tiles, m = 0, every lane nonempty, count = 0, count = cap, count inside
    the last tile, cap one below, at and one above a tile multiple, a total
    of at least 2^31 across tiles (wrapped) and one past 2^40 (tile sums
    above 2^32), and two calls in a row on one stream (stale status
    words).  The pads past count carry e = 0, as the run-ends kernel
    leaves them."""
    tile = _cuda.prep_tile()
    gen = torch.Generator(device=dev).manual_seed(9)

    def operands(cap):
        ids = torch.randint(0, 1 << 32, (cap,), generator=gen, device=dev)
        meta = torch.randint(0, 256, (cap,), generator=gen, device=dev,
                             dtype=torch.int32)
        return ids, meta

    def ends(cap, count, style):
        lane = torch.arange(cap, device=dev)
        e = {"random": lane + torch.randint(0, 50, (cap,), generator=gen,
                                            device=dev),
             "dense": lane + 2,           # run 1: every lane but the last
             "empty": lane + 1,           # run 0 everywhere: m = 0
             "to_end": torch.full_like(lane, cap)}[style]
        return torch.where(lane < count, e, 0).to(torch.int32)

    def check_case(e, count, operands_):
        cnt = torch.tensor(count, device=dev)
        got = prep_runs(e, *operands_, cnt)
        want = prep_runs_plain(e, *operands_, cnt)
        max_abs_err(got, want)
        return want

    cases = [(1001 * tile + 77, 1001 * tile + 70, "random"),   # 1000+ tiles
             (5 * tile + 9, 5 * tile + 9, "empty"),
             (5 * tile + 9, 5 * tile + 9, "dense"),
             (5 * tile + 9, 0, "random"),
             (5 * tile + 9, 4 * tile + 100, "random")]
    cases += [(7 * tile + d, 7 * tile + d, "random") for d in (-1, 0, 1)]
    cases += [(65_537, 65_537, "to_end"), (1_500_000, 1_500_000, "to_end")]
    for cap, count, style in cases:
        want = check_case(ends(cap, count, style), count, operands(cap))
        if style == "to_end":
            check(bool(want[6]) and int(want[5]) == count * (count - 1) // 2,
                  f"prep case cap {cap}: total {int(want[5])} not wrapped")
        if style == "empty" or count == 0:
            check(int(want[4]) == 0, f"prep case cap {cap}: m != 0")
    # two calls in a row on the stream: the second reuses the first's
    # scratch, so a status word left over from the first would show
    cap = 9 * tile + 3
    ops_ = operands(cap)
    first, second = ends(cap, cap, "dense"), ends(cap, cap - 5, "random")
    got1 = prep_runs(first, *ops_, torch.tensor(cap, device=dev))
    got2 = prep_runs(second, *ops_, torch.tensor(cap - 5, device=dev))
    max_abs_err(got1, prep_runs_plain(first, *ops_, cap))
    max_abs_err(got2, prep_runs_plain(second, *ops_, cap - 5))
    return len(cases) + 2


def build_adversarial(dev):
    """Kernel 1 on each spec with A = 2 and A = 3, slot for slot: depth-0
    objects, min_depth 0, 4 and 12 (the last sets the cell-overflow flag),
    a scene with half of its objects outside the system box, n one below,
    at and one above a 256-object block, and out_cap below the count (n/2,
    1, 257, a third of the count and one short of it: the same prefix);
    two calls in a row on one stream (stale status words)."""
    n_cases, flags, over_cap = 0, set(), False
    for spec in (Index64_3D, Index64_2D, Index32_2D):
        scene = with_box(bench_caps.bench_scene(spec.dim, 3000, seed=11),
                         0.0, 1.0, 3, 12)            # three depth-0 objects
        smin, smax, bmin, bmax, ids = scene
        shift = (0.5 * (smax - smin)).astype(np.float32)
        outside = (smin, smax, bmin - shift, bmax - shift, ids)
        for sc in (scene, outside):
            inputs = build_inputs(sc, dev)
            n = inputs[3].shape[0]
            for slots in (2, 3):
                for min_depth in (0, 4, 12):
                    for out_cap in (slots ** spec.dim * n, n // 2):
                        _, (count, flag) = compare_build(
                            inputs, out_cap, spec, min_depth, slots)
                        flags.add(flag)
                        over_cap |= count > out_cap
                        n_cases += 1
        inputs = build_inputs(scene, dev)
        for n in (255, 256, 257, 511, 513):
            for slots in (2, 3):
                compare_build(tuple(x[:n] for x in inputs), 27 * n, spec, 0,
                              slots)
                n_cases += 1
        for slots in (2, 3):
            count = int(emit_build_plain(spec, *inputs, 0, 1, slots)[3])
            for out_cap in (1, 257, count // 3, count - 1):
                compare_build(inputs, out_cap, spec, 0, slots)
                n_cases += 1
    # two calls in a row on the stream: the second reuses the first's
    # scratch, so a status word left over from the first would show
    small = build_inputs(bench_caps.bench_scene(3, 5000, seed=16), dev)
    big = build_inputs(bench_caps.bench_scene(3, 9000, seed=17), dev)
    got = [emit_build(SPEC, *x, 0, 8 * 9000) for x in (big, small)]
    for g, x in zip(got, (big, small)):
        max_abs_err(g, emit_build_plain(SPEC, *x, 0, 8 * 9000))
    n_cases += 2
    check(flags == {False, True} and over_cap, "kernel 1 cases: the cell-"
          "overflow flag or an undersized out_cap was never reached")
    return n_cases


def prepped_entries(run, ids, seed, dev):
    """Kernel 4's inputs for per-element run lengths ``run`` (as the prep
    kernel lays them out), with random rule bytes; m and total on the
    card."""
    rng = np.random.default_rng(seed)
    cap = len(run)
    starts = np.cumsum(run) - run
    nz = run > 0
    m = int(nz.sum())
    sv = np.full(cap, 0x7FFF_FFFF, np.int64)
    ab = np.zeros(cap, np.int64)
    bid = np.full(cap, 0xFFFF_FFFF, np.int64)
    bmeta = np.zeros(cap, np.int32)
    sv[:m] = starts[nz]
    ab[:m] = np.flatnonzero(nz) + 1 - starts[nz]
    bid[:m] = ids[nz]
    bmeta[:m] = rng.integers(0, 256, m)
    ameta = rng.integers(0, 256, cap).astype(np.int32)
    return tuple(torch.as_tensor(x, device=dev) for x in (
        ids, ameta, sv, ab, bid, bmeta, m, int(run.sum())))


def expand2_adversarial(dev):
    """Kernel 4 on what a block-partitioned design can get wrong: one run
    longer than several blocks, every run of length 1 (m = total, the most
    runs a block can touch), block edges on run starts, runs one block
    long, random short runs, m = 0; each with total in the middle of a
    block and total > capacity, the rule on and off, and ids either side
    of 2^24 - 1."""
    rng = np.random.default_rng(8)
    cap = 60_000
    shapes = {}
    r = np.zeros(cap, np.int64)
    r[5] = 20_000
    r[30_000:50_000:13] = rng.integers(1, 9, len(range(30_000, 50_000, 13)))
    shapes["long run"] = r
    r = np.ones(cap, np.int64)
    r[-1] = 0
    shapes["unit runs"] = r
    r = np.zeros(cap, np.int64)
    r[:40_000] = 8                       # starts 8 j: every block edge
    shapes["edges on starts"] = r
    r = np.zeros(cap, np.int64)
    r[:50] = 1024
    shapes["block-long runs"] = r
    r = rng.integers(1, 12, cap) * (rng.random(cap) < 0.5)
    shapes["random"] = np.minimum(r, cap - 1 - np.arange(cap))
    shapes["m = 0"] = np.zeros(cap, np.int64)
    n_cases = 0
    for name, run in shapes.items():
        total = int(run.sum())
        for ids in (rng.integers(0, 1 << 20, cap),
                    (1 << 24) - 1 - cap // 2 + np.arange(cap)):
            args = prepped_entries(run, ids, n_cases, dev)
            check(name != "unit runs" or int(args[6]) == total,
                  "kernel 4 cases: unit runs must give m == total")
            for P in (total + 3 * 1024 + 100, max(total - 777, 1)):
                for rule in (True, False):
                    xargs = args + (P, torch.tensor(rule, device=dev), 3)
                    max_abs_err(expand_pairs_prepped(*xargs),
                                expand_pairs_prepped_plain(*xargs))
                    n_cases += 1
    return n_cases


def sorted_cols(key, meta, n, dev):
    """(key, meta) int64 columns sorted by (key, meta), PAD_KEY to n."""
    o = np.lexsort((meta, key))
    pad = np.full(n - len(key), PAD_KEY, np.int64)
    return (torch.as_tensor(np.concatenate([key[o], pad]), device=dev),
            torch.as_tensor(np.concatenate([meta[o], pad]), device=dev))


def merge_adversarial(dev):
    """Kernel 6 on edge cases: empty churn, all tombstones, all inserts,
    churn outside the tree's key range, an empty tree, inserts equal to
    live entries, churn_count short of the buffer, whole-tree churn; and
    on what merge path can get wrong: merged sizes one below, at and above
    a tile multiple, all churn inside one tile's key range, a tombstone
    that is the first element of a tile with its twin last in the tile
    before, equal (key, meta) ties across a tile edge, and cap + nc >=
    2^31 refused."""
    rng = np.random.default_rng(5)
    n_cases = merge_path_adversarial(dev)
    for n in (5000, 70_001):
        tk = np.sort(rng.choice(1 << 40, n, replace=False) + (1 << 20))
        tm = rng.integers(0, 1 << 30, n) << 1
        fresh = rng.choice(1 << 40, 3000, replace=False) + (1 << 20)
        fresh = fresh[~np.isin(fresh, tk)]
        pick = rng.choice(n, 1000, replace=False)
        cases = {
            "empty": (tk, tm, tk[:0], tm[:0], 0),
            "all_tombstones": (tk, tm, tk, tm | 1, n),
            "all_inserts": (tk, tm, fresh, np.arange(len(fresh)) << 1,
                            len(fresh)),
            "outside": (tk, tm, np.concatenate([np.arange(500),
                                                (1 << 42) + np.arange(500)]),
                        np.arange(1000) << 1, 1000),
            "empty_tree": (tk[:0], tm[:0], fresh, tm[:len(fresh)],
                           len(fresh)),
            "equal_insert": (tk, tm, np.concatenate([tk[pick], tk[pick]]),
                             np.concatenate([tm[pick] | 1, tm[pick]]), 2000),
            "short_count": (tk, tm, tk[pick], tm[pick] | 1, 700),
            "whole_tree": (tk, tm, np.concatenate([tk, tk]),
                           np.concatenate([tm | 1, tm + 2]), 2 * n),
        }
        for name, (ak, am, ck, cm, cc) in cases.items():
            cap, nc = n + 4000, 2 * n + 64
            args = (*sorted_cols(ak, am, cap, dev),
                    *sorted_cols(ck, cm, nc, dev),
                    torch.tensor(cc, device=dev), cap)
            compare_merge(args)
            n_cases += 1
            if name == "whole_tree":
                (key, _), cnt, _ = merge_cancel_compact(*args)
                check(int(cnt) == n and torch.equal(
                    key[:n].cpu(), torch.as_tensor(tk)),
                      "merge whole-tree churn: tree not rebuilt")
    return n_cases


def merge_path_adversarial(dev):
    tile = _cuda.merge_tile()
    rng = np.random.default_rng(15)
    n = 6 * tile + 100
    tk = np.sort(rng.choice(1 << 40, n, replace=False) + (1 << 20))
    tm = rng.integers(0, 1 << 30, n) << 1
    cases = []
    for d in (-1, 0, 1):     # cap + nc at a tile multiple, and beside it
        ck = rng.choice(1 << 40, 500, replace=False) + (1 << 20)
        cases.append((tk, tm, ck, np.arange(500) << 1, 500,
                      8 * tile + d - 600, 600))
    # all churn inside one tile's key range: tombstones of 300 entries and
    # 900 inserts between their keys
    lo, hi = tk[3 * tile], tk[3 * tile + 300]
    ins = rng.integers(lo, hi, 900)
    cases.append((tk, tm, np.concatenate([tk[3 * tile:3 * tile + 300], ins]),
                  np.concatenate([tm[3 * tile:3 * tile + 300] | 1,
                                  rng.integers(0, 1 << 30, 900) << 1]),
                  1200, n + 1200, 1200))
    # a tombstone at merged position k * tile, its twin (tree entry
    # k * tile - 1) last in the tile before; and a churn insert equal to
    # a tree entry in (key, meta) straddling the next tile edge (ties go
    # tree-first)
    for k in (1, 3):
        i = k * tile - 1
        ck = np.array([tk[i], tk[i + tile - 1]])
        cm = np.array([tm[i] | 1, tm[i + tile - 1]])
        cases.append((tk, tm, ck, cm, 2, n, 2))
    for ak, am, ck, cm, cc, cap, nc in cases:
        args = (*sorted_cols(ak, am, cap, dev), *sorted_cols(ck, cm, nc, dev),
                torch.tensor(cc, device=dev), cap)
        compare_merge(args)
    # cap + nc >= 2^31 is refused, checked without allocating it
    small = torch.zeros(8, dtype=torch.int64, device=dev)
    try:
        _cuda.launch("bpt_merge", small, small, small, small, small[0],
                     small, small, small[0], small, 2 ** 31 - 5, 5, 8)
    except RuntimeError:
        pass
    else:
        raise SmokeFailure("kernel 6 took cap + nc >= 2^31")
    return len(cases) + 1


def expand_adversarial(dev):
    """Kernel 7 on edge cases, through both entry points (the JAX
    function's starts and runs, and the prepped entries of the same runs):
    a run longer than any block, all runs empty, total mid-buffer, total
    above the pair capacity, an empty tree."""
    rng = np.random.default_rng(6)
    n_cases = 0
    mixed = np.zeros(50_000, np.int64)
    chosen = rng.choice(50_000 - 64, 2000, replace=False)
    mixed[chosen] = rng.integers(1, 48, 2000)
    mixed = np.minimum(mixed, 50_000 - 1 - np.arange(50_000))
    long_run = np.zeros(300_000, np.int64)
    long_run[3] = 299_990
    mid = np.zeros(4096, np.int64)
    mid[10] = 700
    for run, P in ((long_run, 300_123), (np.zeros(5000, np.int64), 4096),
                   (mid, 4096), (mixed, int(mixed.sum()) // 2),
                   (np.zeros(0, np.int64), 1000)):
        ids = rng.integers(0, 1 << 32, len(run))
        starts = np.cumsum(run) - run
        args = tuple(torch.as_tensor(x, device=dev)
                     for x in (ids, starts, run)) + (
            torch.tensor(int(run.sum()), device=dev), P)
        want = expand_pairs_plain(*args)
        max_abs_err(expand_pairs(*args), want)
        ent = prepped_entries(run, ids, n_cases, dev)
        eargs = (ent[0], *ent[2:5], ent[6], ent[7], P)
        max_abs_err(expand_pairs_entries(*eargs), want)
        max_abs_err(expand_pairs_entries_plain(*eargs), want)
        n_cases += 2
    return n_cases


# ---------------------------------------------------------------------------
# The slice against the C++ oracle
# ---------------------------------------------------------------------------

def scene_digest(scene) -> str:
    """Short hash of a scene's arrays: pins the exact boxes a count is for."""
    h = hashlib.sha1()
    for x in scene:
        h.update(np.ascontiguousarray(x).tobytes())
    return h.hexdigest()[:12]


def oracle(native, scene, min_depth=0):
    smin, smax, bmin, bmax, ids = scene
    keys, oids, _ = native.extend(smin, smax, bmin, bmax, ids,
                                  min_depth=min_depth)
    keys, oids = native.sort_tree(keys, oids)
    pairs = native.scan_seq(keys, oids,
                            pair_slack=max(4, 24_000_000 // max(len(oids), 1)))
    return keys, oids, pairs


def to_device(scene, dev):
    """The scene's arrays on the card (ids as int64), so that a timed step
    does not include the upload."""
    smin, smax, bmin, bmax, ids = scene
    return tuple(torch.as_tensor(x, device=dev)
                 for x in (smin, smax, bmin, bmax, ids.astype(np.int64)))


def step(scene_t, tree_cap, pair_cap, emit_cap, canonical, spec=SPEC,
         expand="v3"):
    state = layer.build(spec, *scene_t, out_capacity=tree_cap)
    return layer.scan(spec, state, pair_cap, emit_capacity=emit_cap,
                      canonical=canonical, expand=expand)


def check_against_cpu(spec, scene, dev, caps):
    """The card's step equals the CPU's (every kernel's plain version),
    tree and pairs in both contracts; the CPU tests hold the CPU path
    against the JAX package.  Returns the canonical pair count."""
    for canonical in (True, False):
        got_state, got = step(to_device(scene, dev), *caps, canonical, spec)
        want_state, want = step(to_device(scene, "cpu"), *caps, canonical,
                                spec)
        label = f"{spec.name} canonical={canonical}"
        check(not bool(got.overflow) and not bool(want.overflow),
              f"{label}: overflow")
        cnt = int(want_state.count)
        check(int(got_state.count) == cnt and all(
            torch.equal(g[:cnt].cpu(), w[:cnt]) for g, w in zip(
                got_state[:3], want_state[:3])), f"{label}: tree differs")
        pairs = layer.scan_result_to_numpy(want)
        check(np.array_equal(layer.scan_result_to_numpy(got), pairs),
              f"{label}: pairs differ")
    return pairs.shape[0]


def check_slice(native, scene, dev, tree_cap, pair_cap, emit_cap, label):
    scene_t = to_device(scene, dev)
    want_keys, want_ids, want = oracle(native, scene)
    state, res = step(scene_t, tree_cap, pair_cap, emit_cap, True)
    check(not bool(state.overflow) and not bool(res.overflow),
          f"{label}: overflow")
    keys, ids, _ = layer.tree_to_numpy(SPEC, state)
    check(np.array_equal(keys, want_keys) and np.array_equal(ids, want_ids),
          f"{label}: tree differs from the oracle's")
    got = layer.scan_result_to_numpy(res)
    check(got.shape == want.shape and np.array_equal(got, want),
          f"{label}: canonical pairs {got.shape[0]} differ from the "
          f"oracle's {want.shape[0]}")
    _, ures = step(scene_t, tree_cap, pair_cap, emit_cap, False)
    ugot = layer.scan_result_to_numpy(ures)
    check(not bool(ures.overflow) and ugot.shape == want.shape,
          f"{label}: canonical=False count {ugot.shape[0]} != "
          f"{want.shape[0]}")
    ugot = ugot[np.lexsort((ugot[:, 1], ugot[:, 0]))]
    check(np.array_equal(ugot, want),
          f"{label}: canonical=False set differs from the oracle's")
    return len(want_ids), want.shape[0]


def reset_launches() -> None:
    for wrapper, *_ in KERNELS.values():
        wrapper.launches = 0


def read_launches() -> dict:
    torch.cuda.synchronize()
    return {name: w.launches for name, (w, *_) in KERNELS.items()}


def host_ms(fn, reps: int) -> list:
    """Host-clock times of fn() in ms, each ended by a synchronize."""
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return walls


def motion(scene, frac, dev):
    """The bench's moving scene (``tools.profile_update.moving_scene``) of
    the bench scene's size, its two bound sets A and B on the card."""
    *_, bmin, bmax, _, bmin2, bmax2 = profile_update.moving_scene(
        len(scene[4]), frac)
    return ((torch.as_tensor(bmin, device=dev),
             torch.as_tensor(bmax, device=dev)),
            (torch.as_tensor(bmin2, device=dev),
             torch.as_tensor(bmax2, device=dev)))


states_equal = profile_update.states_equal


def tree_equals_oracle(state, scene_np):
    """(whether the state's live tree equals the oracle's, the oracle's
    sorted (keys, ids))."""
    smin, smax, bmin, bmax, ids = scene_np
    keys, oids, _ = native.extend(smin, smax, bmin, bmax, ids)
    keys, oids = native.sort_tree(keys, oids)
    got_keys, got_ids, _ = layer.tree_to_numpy(SPEC, state)
    return (np.array_equal(got_keys, keys) and np.array_equal(got_ids, oids),
            (keys, oids))


def update_sweep(scene_big, dev, tree_cap, pair_cap, emit_cap):
    """The update path at 1M and four churn fractions.  Returns
    ({frac: numbers}, launches of the 1% frame, merge kernel args of the
    1% frame)."""
    smin, smax, _, _, ids = scene_big
    smin_t, smax_t, _, _, ids_t = to_device(scene_big, dev)
    results, frame_launches, merge_args = {}, None, None
    for frac in (0.005, 0.01, 0.03, 0.10):
        churn_cap, obj_cap = bench_caps.update_caps(len(ids), frac)
        A, B = motion(scene_big, frac, dev)
        tracked = upd.build_tracked(SPEC, smin_t, smax_t, *A, ids_t,
                                    out_capacity=tree_cap)
        label = f"update 1M churn {frac:.1%}"

        def frame_update(tr, bounds, c=churn_cap, o=obj_cap):
            return upd.update(SPEC, tr, smin_t, smax_t, *bounds, c,
                              obj_cap=o)

        if frac == 0.01:    # the frame path, counted: update + scan
            churn = upd._frame_churn(SPEC, tracked, smin_t, smax_t, *B,
                                     churn_cap, 2, obj_cap, False)
            merge_args = (*upd._tree_merge_cols(SPEC, tracked),
                          churn.key, churn.meta, churn.count, tree_cap)
            reset_launches()
            t_b = frame_update(tracked, B)
            _, res_b = layer.scan(SPEC, t_b.state, pair_cap,
                                  emit_capacity=emit_cap)
            frame_launches = read_launches()
            check(frame_launches["merge_cancel_compact"] > 0
                  and frame_launches["stream_compact"] > 0,
                  f"{label}: merge or compact kernel not launched: "
                  f"{frame_launches}")
        else:
            t_b = frame_update(tracked, B)
        fresh = layer.build(SPEC, smin_t, smax_t, *B, ids_t,
                            out_capacity=tree_cap)
        check(bool(torch.any(fresh.aux != 0)), f"{label}: no aux bits")
        check(not bool(t_b.state.overflow), f"{label}: overflow")
        check(states_equal(t_b.state, fresh),
              f"{label}: the update differs from a fresh build")
        scene_b = (smin, smax, B[0].cpu().numpy(), B[1].cpu().numpy(), ids)
        same, (okeys, oids) = tree_equals_oracle(fresh, scene_b)
        check(same, f"{label}: the fresh build differs from the oracle")
        extra = ""
        if frac == 0.01:
            want = native.scan_seq(okeys, oids, pair_slack=24)
            got = layer.scan_result_to_numpy(res_b)
            check(not bool(res_b.overflow) and np.array_equal(got, want),
                  f"{label}: {got.shape[0]} canonical pairs of the updated "
                  f"tree differ from the oracle's {want.shape[0]}")
            extra = (f"; its {want.shape[0]} canonical pairs equal the "
                     "oracle's")
            small = upd.update(SPEC, tracked, smin_t, smax_t, *B, 64,
                               obj_cap=obj_cap)
            check(bool(small.state.overflow),
                  f"{label}: churn_cap 64 did not set overflow")
            wide_ids = ids_t + (1 << 28)
            wide = upd.build_tracked(SPEC, smin_t, smax_t, *A, wide_ids,
                                     out_capacity=tree_cap)
            check(bool(frame_update(wide, B).state.overflow),
                  f"{label}: ids >= 2^28 - 1 without wide_ids did not set "
                  "overflow")
            # the wide-ids path on ids from 0 keeps aux as a fresh build
            wide0 = upd.update(SPEC, tracked, smin_t, smax_t, *B, churn_cap,
                               obj_cap=obj_cap, wide_ids=True)
            check(not bool(wide0.state.overflow)
                  and states_equal(wide0.state, fresh),
                  f"{label}: the wide-ids update of ids from 0 differs from "
                  "a fresh build")
            extra += ("; the wide-ids update of ids from 0 equals it too, "
                      "aux included; churn_cap 64 and ids >= 2^28-1 without "
                      f"wide_ids set overflow; launches of the frame "
                      f"(update + canonical scan) {frame_launches}")
        print(f"{label}: churn_cap {churn_cap}, obj_cap {obj_cap}; the "
              f"first update equals a fresh build (keys, ids, aux, count "
              f"{int(fresh.count)}, invalid_count {int(fresh.invalid_count)},"
              f" overflow), and the fresh build equals the oracle{extra}")

        # steady state: alternate A and B, so every frame has real churn
        run = {"tracked": t_b, "frames": 0}

        def next_frame(scan_too=False):
            run["frames"] += 1
            run["tracked"] = frame_update(run["tracked"],
                                          A if run["frames"] % 2 else B)
            if scan_too:
                layer.scan(SPEC, run["tracked"].state, pair_cap,
                           emit_capacity=emit_cap)

        for _ in range(3):
            next_frame()
        upd_ms = host_ms(next_frame, 30)
        bld_ms = host_ms(lambda: layer.build(SPEC, smin_t, smax_t, *B, ids_t,
                                             out_capacity=tree_cap), 20)
        frame_ms = host_ms(lambda: next_frame(True), 20)
        check(not bool(run["tracked"].state.overflow),
              f"{label}: overflow in the timed frames")
        up50, up90 = np.percentile(upd_ms, [50, 90])
        b50 = float(np.percentile(bld_ms, 50))
        f50 = float(np.percentile(frame_ms, 50))
        print(f"{label}: update p50 {up50:.3f} ms, p90 {up90:.3f} ms (30 "
              f"alternating frames); fresh build p50 {b50:.3f} ms (20); "
              f"frame (update + canonical scan) p50 {f50:.3f} ms (20)")
        layers, ops = device_ms_by_layer(next_frame, reps=4)
        busy = sum(layers.values())
        print(f"profile {label}: device busy {busy:.3f} ms/update of the "
              f"{up50:.3f} ms p50 (idle share {1 - busy / up50:.3f}), "
              f"{ops:.0f} device operations per update; "
              + ", ".join(f"{k} {v:.3f}" for k, v in
                          sorted(layers.items(), key=lambda kv: -kv[1])))
        results[frac] = {"update_p50": up50, "update_p90": up90,
                         "build_p50": b50, "frame_p50": f50}
    return results, frame_launches, merge_args


# ---------------------------------------------------------------------------
# The rest of the layer surface and the linear queries
# ---------------------------------------------------------------------------

def p50(walls) -> float:
    return float(np.percentile(walls, 50))


def to_cpu(state):
    """A layer state's tensors on the CPU (the host flags already are)."""
    return layer.LayerState(*(t.cpu() for t in state))


def profile_line(label, run, p50_ms) -> dict:
    """Print the device profile of run() by layer; return it."""
    layers, ops = device_ms_by_layer(run)
    busy = sum(layers.values())
    print(f"profile {label}: device busy {busy:.3f} ms of the {p50_ms:.3f} "
          f"ms p50 (idle share {1 - busy / p50_ms:.3f}), {ops:.0f} device "
          "operations; " + ", ".join(
              f"{k} {v:.3f}" for k, v in
              sorted(layers.items(), key=lambda kv: -kv[1])))
    return layers


def merge_phase(scene_big, dev, tree_cap, pair_cap, emit_cap, fresh, want):
    """The static + dynamic pattern at 1M: 900k objects built once, 100k
    built each frame, merged (kernel 6) and scanned; the merged tree equals
    the fresh build and its pairs the oracle's.  Timed against the append
    path + layer.sort on the same inputs; an undersized state against the
    CPU path.  Returns (the merge's launches, its times)."""
    smin_t, smax_t, bmin_t, bmax_t, ids_t = to_device(scene_big, dev)
    split = 9 * len(ids_t) // 10
    static = layer.build(SPEC, smin_t, smax_t, bmin_t[:split],
                         bmax_t[:split], ids_t[:split],
                         out_capacity=tree_cap)
    dynamic = layer.build(SPEC, smin_t, smax_t, bmin_t[split:],
                          bmax_t[split:], ids_t[split:])
    reset_launches()
    merged = layer.merge(SPEC, static, dynamic)
    launches = read_launches()
    check(launches["merge_cancel_compact"] == 1
          and sum(launches.values()) == 1,
          f"merge 1M: not one launch of kernel 6 alone: {launches}")
    check(bool(merged.sorted) and states_equal(merged, fresh),
          "merge 1M: the merged tree differs from the fresh build")
    _, res = layer.scan(SPEC, merged, pair_cap, emit_capacity=emit_cap)
    got = layer.scan_result_to_numpy(res)
    check(not bool(res.overflow) and np.array_equal(got, want),
          f"merge 1M: {got.shape[0]} canonical pairs of the merged tree "
          f"differ from the oracle's {want.shape[0]}")

    unsorted = static._replace(sorted=torch.tensor(False))

    def append_sort():
        return layer.sort(SPEC, layer.merge(SPEC, unsorted, dynamic))

    check(states_equal(append_sort(), fresh),
          "merge 1M: append + sort differs from the fresh build")
    for _ in range(3):
        layer.merge(SPEC, static, dynamic)
        append_sort()
    m_ms = p50(host_ms(lambda: layer.merge(SPEC, static, dynamic), 20))
    a_ms = p50(host_ms(append_sort, 20))
    moved = 16 * (tree_cap + dynamic.ids.shape[0]) + 16 * tree_cap
    bound_ms, _ = bound(moved)
    print(f"merge 1M (900k static + 100k dynamic, kernel 6): the merged "
          f"tree equals the fresh build (keys, ids, aux, count "
          f"{int(merged.count)}, flags) and its {want.shape[0]} canonical "
          f"pairs the oracle's; launches {launches}; merge p50 {m_ms:.3f} "
          f"ms, append + layer.sort p50 {a_ms:.3f} ms (20 each); k6 bound "
          f"{bound_ms:.3f} ms ({moved / 1e6:.1f} MB)")
    layers = profile_line("merge 1M", lambda: layer.merge(SPEC, static,
                                                          dynamic), m_ms)
    check("torch.sort" not in layers, "merge 1M: the sorted merge sorted")
    profile_line("append + sort 1M", append_sort, a_ms)

    # a state whose capacity is below the sum: count and overflow as the
    # CPU path (the plain version of kernel 6) has them
    small_cap = int(static.count) + int(dynamic.count) // 4
    small = layer.build(SPEC, smin_t, smax_t, bmin_t[:split], bmax_t[:split],
                        ids_t[:split], out_capacity=small_cap)
    over = layer.merge(SPEC, small, dynamic)
    want_over = layer.merge(SPEC, to_cpu(small), to_cpu(dynamic))
    check(bool(over.overflow) and int(over.count) == small_cap
          and states_equal(to_cpu(over), want_over),
          "merge 1M into fewer slots: differs from the CPU path")
    print(f"merge 1M into {small_cap} slots ({int(small.count)} + "
          f"{int(dynamic.count)} cells): count and overflow set, equal to "
          "the CPU path slot for slot")
    return launches, {"merge_p50": m_ms, "append_sort_p50": a_ms,
                      "bound": bound_ms}


def extend_phase(scene_big, dev, fresh):
    """clear + 10 extends of 100k objects (kernel 1) equal the CPU path
    slot for slot before the sort, and the fresh 1M build after it; a 10k
    extend into the 1M tree timed.  Returns (the launches of the 10, the
    10k extend's time)."""
    smin, smax, bmin, bmax, ids = scene_big
    smin_t, smax_t, bmin_t, bmax_t, ids_t = to_device(scene_big, dev)
    step_n = len(ids) // 10
    batches = [(i * step_n, (i + 1) * step_n) for i in range(10)]
    reset_launches()
    st = layer.clear(fresh)
    for lo, hi in batches:
        st = layer.extend(SPEC, st, smin_t, smax_t, bmin_t[lo:hi],
                          bmax_t[lo:hi], ids_t[lo:hi])
    launches = read_launches()
    check(launches["emit_build"] == 10, f"extend 1M: launches {launches}")
    cpu = layer.clear(to_cpu(fresh))
    for lo, hi in batches:
        cpu = layer.extend(SPEC, cpu, smin, smax, bmin[lo:hi], bmax[lo:hi],
                           ids[lo:hi])
    check(not bool(st.sorted) and states_equal(to_cpu(st), cpu),
          "extend 1M: the unsorted tree differs from the CPU path")
    check(states_equal(layer.sort(SPEC, st), fresh),
          "extend 1M: clear + extend + sort differs from the fresh build")
    extra = bench_caps.bench_scene(3, 10_000, seed=1)
    x_t = to_device(extra[:4] + (extra[4] + np.uint32(1_000_000),), dev)

    def extend_10k():
        return layer.extend(SPEC, fresh, smin_t, smax_t, *x_t[2:])

    grown = extend_10k()
    check(not bool(grown.overflow) and not bool(grown.sorted),
          "extend 10k into 1M: overflow or still sorted")
    for _ in range(3):
        extend_10k()
    e_ms = p50(host_ms(extend_10k, 20))
    print(f"extend 1M: clear + 10 x 100k extends (launches {launches}) "
          f"equal the CPU path slot for slot, and after sort the fresh "
          f"build (keys, ids, aux, count {int(st.count)}, invalid_count, "
          f"overflow); a 10k-object extend into the 1M tree "
          f"(+{int(grown.count) - int(fresh.count)} cells) p50 {e_ms:.3f} "
          "ms (20)")
    profile_line("extend 10k into 1M", extend_10k, e_ms)
    return launches, {"extend_10k_p50": e_ms}


def filter_ids(a, b):
    """The smoke's collision-group predicate on id columns."""
    return (a + b) % 3 != 0


def filtered_phase(state, pair_cap, emit_cap, want):
    """scan_filtered at 1M against the oracle's pairs filtered in numpy,
    canonical and as a set; timed beside the unfiltered scan.  Returns (its
    launches, both times)."""
    want_f = want[(want[:, 0].astype(np.int64) + want[:, 1]) % 3 != 0]
    reset_launches()
    _, res = layer.scan_filtered(SPEC, state, pair_cap, filter_ids,
                                 emit_capacity=emit_cap)
    launches = read_launches()
    got = layer.scan_result_to_numpy(res)
    check(not bool(res.overflow) and np.array_equal(got, want_f),
          f"scan_filtered 1M: {got.shape[0]} pairs differ from the oracle's "
          f"{want_f.shape[0]}")
    _, ures = layer.scan_filtered(SPEC, state, pair_cap, filter_ids,
                                  emit_capacity=emit_cap, canonical=False)
    ugot = layer.scan_result_to_numpy(ures)
    ugot = ugot[np.lexsort((ugot[:, 1], ugot[:, 0]))]
    check(np.array_equal(ugot, want_f),
          "scan_filtered 1M canonical=False: the set differs")

    def filtered():
        return layer.scan_filtered(SPEC, state, pair_cap, filter_ids,
                                   emit_capacity=emit_cap)

    def plain():
        return layer.scan(SPEC, state, pair_cap, emit_capacity=emit_cap)

    for _ in range(3):
        filtered()
        plain()
    f_ms, s_ms = p50(host_ms(filtered, 20)), p50(host_ms(plain, 20))
    print(f"scan_filtered 1M ((a + b) % 3 != 0): {want_f.shape[0]} "
          f"canonical pairs equal the oracle's, filtered in numpy, and the "
          f"canonical=False set; launches {launches}; scan p50 filtered "
          f"{f_ms:.3f} ms, unfiltered {s_ms:.3f} ms (20 each)")
    return launches, {"filtered_scan_p50": f_ms, "scan_p50": s_ms}


def nested_phase(dev):
    """nested_ids at 100k objects, each id again at a larger concentric
    box, against the C++ oracle (its sweep skips an id already on the
    stack)."""
    smin, smax, bmin, bmax, ids = bench_caps.bench_scene(3, 100_000)
    pad = 2.0
    scene = (smin, smax,
             np.concatenate([bmin, np.maximum(bmin - pad, smin + 1.0)])
             .astype(np.float32),
             np.concatenate([bmax, np.minimum(bmax + pad, smax - 1.0)])
             .astype(np.float32),
             np.concatenate([ids, ids]))
    n = len(scene[4])
    state = layer.build(SPEC, *to_device(scene, dev))
    _, _, want = oracle(native, scene)
    reset_launches()
    _, res = layer.scan(SPEC, state, 32 * n, nested_ids=True)
    launches = read_launches()
    got = layer.scan_result_to_numpy(res)
    check(not bool(res.overflow) and np.array_equal(got, want),
          f"nested_ids 100k: {got.shape[0]} pairs differ from the oracle's "
          f"{want.shape[0]}")
    _, res_plain = layer.scan(SPEC, state, 32 * n)
    check(not np.array_equal(layer.scan_result_to_numpy(res_plain), want),
          "nested_ids 100k: the skip never fired")
    print(f"nested_ids 100k (x2 ids, concentric): {want.shape[0]} canonical "
          f"pairs equal the oracle's; without the skip the list differs; "
          f"launches {launches}")
    return launches


def scan_auto_phase(dev):
    """scan_auto from 1024 slots at 30k grows until no overflow and equals
    scan at a generous capacity."""
    n = 30_000
    scene = bench_caps.bench_scene(3, n)
    state = layer.build(SPEC, *to_device(scene, dev), out_capacity=4 * n)
    reset_launches()
    _, res = layer.scan_auto(SPEC, state, initial_capacity=1024)
    launches = read_launches()
    _, ref = layer.scan(SPEC, state, 10 * n, emit_capacity=16 * n)
    cap = res.pairs_a.shape[0]
    check(not bool(res.overflow) and cap > 1024 and np.array_equal(
        layer.scan_result_to_numpy(res), layer.scan_result_to_numpy(ref)),
          "scan_auto 30k: differs from scan at a generous capacity")
    print(f"scan_auto 30k: grew 1024 -> {cap} slots; its {int(res.count)} "
          f"pairs equal scan at 10n; launches {launches}")
    return launches


def scene_phase(scene_big, dev, tree_cap, pair_cap, emit_cap, fresh, want):
    """BR_SCENE at 1M: layer_to_scene_layer -> save -> load ->
    layer_from_scene_layer gives back the tree and the build's aux, and
    the same pairs."""
    smin, smax, bmin, bmax, ids = scene_big
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "scene_1m.br"
        t0 = time.perf_counter()
        br_scene.save(path, br_scene.Scene(
            smin, smax, bmin, bmax, ids,
            layer.layer_to_scene_layer(SPEC, fresh)))
        t1 = time.perf_counter()
        reset_launches()
        restored = layer.layer_from_scene_layer(
            SPEC, br_scene.load(path).layer, capacity=tree_cap, device=dev)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        size = path.stat().st_size
    check(states_equal(restored, fresh),
          "BR_SCENE 1M: the restored layer differs from the build")
    _, res = layer.scan(SPEC, restored, pair_cap, emit_capacity=emit_cap)
    launches = read_launches()
    check(not bool(res.overflow) and np.array_equal(
        layer.scan_result_to_numpy(res), want),
          "BR_SCENE 1M: the restored layer's pairs differ")
    print(f"BR_SCENE 1M: save {1e3 * (t1 - t0):.0f} ms ({size / 1e6:.1f} "
          f"MB), load + restore {1e3 * (t2 - t1):.0f} ms; keys, ids, count "
          f"and the build's aux back, and {want.shape[0]} pairs; launches "
          f"(restore + scan) {launches}")
    return launches


def ray_sphere(ids, mask, centers, radii, ro, dn):
    """Exact ray-sphere distance of each slot's object, inf on a miss; the
    sums are written out, so that every device adds in one order."""
    i = torch.where(mask, ids, 0)
    c = centers[i] - ro
    t = c[:, 0] * dn[0] + c[:, 1] * dn[1] + c[:, 2] * dn[2]
    d2 = c[:, 0] * c[:, 0] + c[:, 1] * c[:, 1] + c[:, 2] * c[:, 2] - t * t
    r = radii[i]
    r2 = r * r
    root = torch.sqrt(torch.clamp(r2 - d2, min=0.0))
    hit = (d2 <= r2) & (t + root >= 0)
    return torch.where(hit, t - root, torch.inf)


def same_hits(a, b) -> bool:
    return (int(a.count) == int(b.count) and bool(a.overflow) == bool(
        b.overflow) and torch.equal(a.ids.cpu(), b.ids.cpu()))


def same_pick(a, b) -> bool:
    return (bool(a.found) == bool(b.found) and int(a.obj_id) == int(b.obj_id)
            and torch.equal(a.distance.cpu(), b.distance.cpu()))


def query_set(scene_big):
    """The query phases' queries on the 1M scene: 32 boxes, 32 rays (8
    axis-parallel or -aligned) and 8 ray picks aimed at objects (origin,
    direction, unit direction), and the objects' sphere centers and
    radii."""
    smin, smax, bmin, bmax, ids = scene_big
    rng = np.random.default_rng(21)
    ext = smax - smin
    boxes = []
    for _ in range(32):
        lo = (smin + rng.uniform(0, 1, 3) * (ext - 30)).astype(np.float32)
        boxes.append((lo, (lo + rng.uniform(1, 30, 3)).astype(np.float32)))
    rays = []
    for k in range(32):
        d = rng.normal(size=3).astype(np.float32)
        if k % 8 == 3:
            d[k % 3] = 0.0                       # axis-parallel
        if k % 8 == 7:
            d = np.zeros(3, np.float32)
            d[k % 3] = -1.0                      # axis-aligned
        rays.append(((smin + rng.uniform(0, 1, 3) * ext).astype(np.float32),
                     d))
    centers = ((bmin + bmax) / 2.0).astype(np.float32)
    radii = (np.min(bmax - bmin, axis=1) / 2.0).astype(np.float32)
    picks = []
    for _ in range(8):
        ro = (smin + rng.uniform(0, 1, 3) * ext).astype(np.float32)
        d = (centers[rng.integers(len(ids))] - ro).astype(np.float32)
        picks.append((ro, d, (d / np.linalg.norm(d)).astype(np.float32)))
    return boxes, rays, picks, centers, radii


QUERY_CAP = 1 << 16


def query_fns(scene_big, dev, centers, radii, **kw):
    """(box, ray, pick): one query of each kind on a layer, through the
    dispatchers with the keyword arguments ``kw`` (the engine, its
    caps)."""
    smin, smax = scene_big[0], scene_big[1]
    on = {dv.type: (torch.as_tensor(centers, device=dv),
                    torch.as_tensor(radii, device=dv))
          for dv in (dev, torch.device("cpu"))}

    def box(st, q):
        return query.test_box(SPEC, st, smin, smax, q, QUERY_CAP, **kw)[1]

    def ray(st, q):
        return query.test_ray(SPEC, st, smin, smax, q[0], q[1], 0.0, np.inf,
                              QUERY_CAP, **kw)[1]

    def pick(st, q):
        dv = st.ids.device
        args = on[dv.type] + (torch.as_tensor(q[0], device=dv),
                              torch.as_tensor(q[2], device=dv))
        return query.pick_ray(SPEC, st, smin, smax, q[0], q[1], 1e9,
                              ray_sphere, args, **kw)[1]

    return box, ray, pick


def query_phase(scene_big, dev, fresh):
    """32 boxes, 32 rays and 8 ray picks on the 1M tree by the linear
    engine (pinned: the dispatchers pick the tree engine at 1M), each equal
    to the CPU path on the same tree.  Returns (their launches, the p50
    per query of each kind on the card)."""
    cpu = to_cpu(fresh)
    boxes, rays, picks, centers, radii = query_set(scene_big)
    box, ray, pick = query_fns(scene_big, dev, centers, radii,
                               engine="linear")

    reset_launches()
    results = {name: [fn(fresh, q) for q in qs] for name, fn, qs in (
        ("box", box, boxes), ("ray", ray, rays), ("pick", pick, picks))}
    launches = read_launches()
    summary = {}
    for name, fn, qs, same in (("box", box, boxes, same_hits),
                               ("ray", ray, rays, same_hits),
                               ("pick", pick, picks, same_pick)):
        for i, (q, got) in enumerate(zip(qs, results[name])):
            check(same(got, fn(cpu, q)),
                  f"query 1M: {name} {i} differs from the CPU path")
        fn(fresh, qs[0])
        walls = []
        for q in qs:
            walls += host_ms(lambda: fn(fresh, q), 1)
        summary[name] = p50(walls)
    hits = [int(r.count) for r in results["box"] + results["ray"]]
    found = sum(bool(r.found) for r in results["pick"])
    check(not any(bool(r.overflow) for r in results["box"] + results["ray"]),
          "query 1M: a result buffer overflowed")
    print(f"queries 1M: 32 boxes, 32 rays (8 axis-parallel or -aligned) and "
          f"8 ray-sphere picks ({found} found) equal the CPU path (ids, "
          f"counts, flags; pick id and f32 distance); hits per box/ray "
          f"{min(hits)}-{max(hits)}; p50 per query on the card: test_box "
          f"{summary['box']:.3f} ms, test_ray {summary['ray']:.3f} ms, "
          f"pick_ray {summary['pick']:.3f} ms; launches {launches}")
    profile_line("test_ray 1M", lambda: ray(fresh, rays[0]), summary["ray"])
    return launches, summary


def ball_pit_phase(dev):
    """The ball pit's broadphase (``examples.ball_pit.contacts``:
    Index32_2D, min_depth 4, 2,500 balls; build -> pick_ray (ray-circle)
    -> scan), its tree, pairs and pick equal to the CPU path at four ray
    angles and its pair buffer not overflowed; timed on the card."""
    n = 2500
    sims = {d.type: ball_pit.make_sim(n, device=d)
            for d in (dev, torch.device("cpu"))}
    start = ball_pit.initial_state(sims["cpu"], 0)

    def contacts(dv, ray_dir):
        sim = sims[torch.device(dv).type]
        pos, radius, ray = (torch.as_tensor(x, device=dv) for x in (
            start.pos, start.radius, ray_dir))
        return ball_pit.contacts(pos, radius, None, ray, sim)

    reset_launches()
    found = 0
    for k in (0, 30, 60, 90):
        a = np.float32(-1.9) + np.float32(1.4) * np.float32(k / 120.0)
        ray_dir = np.array([np.sin(a) * 0.4, np.cos(a)], np.float32)
        got, want = contacts(dev, ray_dir), contacts("cpu", ray_dir)
        check(torch.equal(got.tree.keys.cpu(), want.tree.keys)
              and torch.equal(got.tree.ids.cpu(), want.tree.ids)
              and all(torch.equal(g.cpu(), w) for g, w in zip(got[:3],
                                                             want[:3]))
              and same_pick(got.pick, want.pick)
              and not bool(got.overflow) and not bool(want.overflow),
              f"ball pit frame {k}: differs from the CPU path")
        found += bool(got.pick.found)
        if k == 0:
            launches = read_launches()
    pairs = int(got.valid.sum())
    f_ms = p50(host_ms(lambda: contacts(dev, ray_dir), 20))
    profile_line("ball pit frame", lambda: contacts(dev, ray_dir), f_ms)
    print(f"ball pit (Index32_2D, min_depth 4, 2,500 balls): build -> "
          f"pick_ray -> scan (examples.ball_pit.contacts) equal to the CPU "
          f"path at 4 ray angles ({found} picks found, {pairs} pairs in the "
          f"last, no overflow); p50 {f_ms:.3f} ms (20, positions, radii and "
          f"ray uploaded "
          f"each call); launches of one call {launches}")
    return launches, {"ball_pit_frame_p50": f_ms}


def count_syncs(fn):
    """(fn(), the host synchronizations it made), counted by torch's sync
    debug mode, which warns at each call that waits for the card."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchroniz" in str(w.message) for w in caught)


def degenerate_boxes(scene_big):
    """Boxes that cross the tree engine's u32 descent: inverted, NaN on an
    axis, all NaN, a point, one outside the system box."""
    smin, smax, bmin, _, _ = scene_big
    p = bmin[12345]
    nan = p.copy()
    nan[1] = np.nan
    return [(p + 20.0, p - 20.0), (p + 0.5, p - 0.5), (nan, nan + 10.0),
            (np.full(3, np.nan, np.float32),) * 2, (p, p.copy()),
            (smax + 5.0, smax + 9.0)]


def tree_query_phase(scene_big, dev, fresh):
    """The sublinear tree engine at 1M: the query phase's boxes, rays and
    picks and some degenerate boxes, each equal to the linear engine on
    the card (ids, count, overflow; pick id and f32 distance), a few to
    the CPU tree engine; p50 per query of both engines, timed in turns,
    and the host synchronizations per query.  Returns (the tree engine's
    launches, its p50s)."""
    boxes, rays, picks, centers, radii = query_set(scene_big)
    boxes = boxes + degenerate_boxes(scene_big)
    tree = query_fns(scene_big, dev, centers, radii, engine="tree")
    lin = query_fns(scene_big, dev, centers, radii, engine="linear")
    kinds = (("box", boxes, same_hits), ("ray", rays, same_hits),
             ("pick", picks, same_pick))
    reset_launches()
    reads0 = singleq._ray_frontier_ranges.host_reads
    got = {name: [tree[k](fresh, q) for q in qs]
           for k, (name, qs, _) in enumerate(kinds)}
    launches = read_launches()
    levels = singleq._ray_frontier_ranges.host_reads - reads0
    cpu = to_cpu(fresh)
    cpu_tree = query_fns(scene_big, dev, centers, radii, engine="tree")
    n_ovf = 0
    for k, (name, qs, same) in enumerate(kinds):
        for i, (q, res) in enumerate(zip(qs, got[name])):
            want = lin[k](fresh, q)
            check(not bool(want.overflow), f"tree 1M: {name} {i}: the "
                  "linear engine overflowed its result buffer")
            if bool(res.overflow):
                # the default caps were too small for this query: it says
                # so, and with larger caps it is exact
                n_ovf += 1
                res = query_fns(scene_big, dev, centers, radii,
                                engine="tree", candidate_cap=1 << 16,
                                frontier_cap=4096)[k](fresh, q)
            check(same(res, want), f"tree 1M: {name} {i} differs from the "
                  "linear engine on the card")
            if i < (2 if name == "pick" else 4):
                check(same(cpu_tree[k](cpu, q), res), f"tree 1M: {name} {i}"
                      " differs from the CPU tree engine")
    summary, syncs = {}, {}
    for k, (name, qs, _) in enumerate(kinds):
        tree[k](fresh, qs[0])
        walls = {"tree": [], "linear": []}
        for q in qs:
            for eng, fns in (("linear", lin), ("tree", tree)):
                walls[eng] += host_ms(lambda: fns[k](fresh, q), 1)
        summary[f"{name}_tree"] = p50(walls["tree"])
        summary[f"{name}_linear"] = p50(walls["linear"])
        torch.cuda.synchronize()
        syncs[name] = (count_syncs(lambda: tree[k](fresh, qs[1]))[1],
                       count_syncs(lambda: lin[k](fresh, qs[1]))[1])
    hits = [int(r.count) for r in got["box"] + got["ray"]]
    print(f"tree queries 1M: {len(boxes)} boxes ({len(boxes) - 32} "
          f"degenerate: inverted, NaN, a point, outside), {len(rays)} rays "
          f"and {len(picks)} ray-sphere picks by the tree engine equal the "
          f"linear engine on the card, and 4 + 4 + 2 of them the CPU tree "
          f"engine; {n_ovf} overflowed the default caps (candidate "
          f"{singleq.CANDIDATE_CAP}, frontier {singleq.FRONTIER_CAP}) and "
          f"were exact with larger ones; hits per box/ray {min(hits)}-"
          f"{max(hits)}; p50 per query tree / linear: test_box "
          f"{summary['box_tree']:.3f} / {summary['box_linear']:.3f} ms, "
          f"test_ray {summary['ray_tree']:.3f} / {summary['ray_linear']:.3f} "
          f"ms, pick_ray {summary['pick_tree']:.3f} / "
          f"{summary['pick_linear']:.3f} ms; host synchronizations per query"
          f" tree / linear: box {syncs['box'][0]} / {syncs['box'][1]}, ray "
          f"{syncs['ray'][0]} / {syncs['ray'][1]}, pick {syncs['pick'][0]} "
          f"/ {syncs['pick'][1]}; frontier levels per ray or pick "
          f"{levels / (len(rays) + len(picks)):.2f} (one host read each); "
          f"launches {launches}")
    profile_line("test_ray tree 1M", lambda: tree[1](fresh, rays[0]),
                 summary["ray_tree"])
    return launches, summary


def batch_query_phase(scene_big, dev, fresh):
    """The batched queries at 1M: Q = 256 boxes, 256 rays and 64 ray-sphere
    picks, chunk 64; every row equal to the single query on the card (the
    linear engine).  Prints ms per query amortized and the peak memory of
    each batch.  Returns (the batches' launches, their ms per query)."""
    smin, smax, bmin, bmax, ids = scene_big
    rng = np.random.default_rng(22)
    ext = smax - smin
    lo = (smin + rng.uniform(0, 1, (256, 3)) * (ext - 30)).astype(np.float32)
    qb = (lo, (lo + rng.uniform(1, 30, (256, 3))).astype(np.float32))
    ro = (smin + rng.uniform(0, 1, (256, 3)) * ext).astype(np.float32)
    rd = rng.normal(size=(256, 3)).astype(np.float32)
    rd[::16, 0] = 0.0                            # axis-parallel
    centers = ((bmin + bmax) / 2.0).astype(np.float32)
    radii = (np.min(bmax - bmin, axis=1) / 2.0).astype(np.float32)
    pro = ro[:64]
    pd = (centers[rng.integers(len(ids), size=64)] - pro).astype(np.float32)
    pdn = (pd / np.linalg.norm(pd, axis=1, keepdims=True)).astype(np.float32)
    c_t, r_t = (torch.as_tensor(centers, device=dev),
                torch.as_tensor(radii, device=dev))
    pargs = (c_t.expand(64, -1, -1), r_t.expand(64, -1),
             torch.as_tensor(pro, device=dev),
             torch.as_tensor(pdn, device=dev))

    runs = {
        "box": lambda: query.test_box_batch(SPEC, fresh, smin, smax, qb,
                                            QUERY_CAP)[1],
        "ray": lambda: query.test_ray_batch(SPEC, fresh, smin, smax, ro, rd,
                                            0.0, np.inf, QUERY_CAP)[1],
        "pick": lambda: query.pick_ray_batch(SPEC, fresh, smin, smax, pro,
                                             pd, 1e9, ray_sphere, pargs)[1],
    }
    reset_launches()
    got = {name: run() for name, run in runs.items()}
    launches = read_launches()
    box, ray, pick = query_fns(scene_big, dev, centers, radii,
                               engine="linear")
    for q in range(256):
        row = type(got["box"])(*(f[q] for f in got["box"]))
        check(same_hits(row, box(fresh, (qb[0][q], qb[1][q]))),
              f"batch 1M: box row {q} differs from the single query")
        row = type(got["ray"])(*(f[q] for f in got["ray"]))
        check(same_hits(row, ray(fresh, (ro[q], rd[q]))),
              f"batch 1M: ray row {q} differs from the single query")
    for q in range(64):
        row = type(got["pick"])(*(f[q] for f in got["pick"]))
        check(same_pick(row, pick(fresh, (pro[q], pd[q], pdn[q]))),
              f"batch 1M: pick row {q} differs from the single query")
    summary, peaks = {}, {}
    for name, run in runs.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        walls = host_ms(run, 2)
        peaks[name] = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        summary[f"{name}_batch_ms_per_query"] = min(walls) / (
            64 if name == "pick" else 256)
    found = int(got["pick"].found.sum())
    print(f"batch queries 1M (chunk 64): 256 boxes, 256 rays (16 axis-"
          f"parallel) and 64 ray-sphere picks ({found} found), every row "
          f"equal to the single query on the card; ms per query amortized "
          f"(the better of 2 batches): test_box_batch "
          f"{summary['box_batch_ms_per_query']:.3f}, test_ray_batch "
          f"{summary['ray_batch_ms_per_query']:.3f}, pick_ray_batch "
          f"{summary['pick_batch_ms_per_query']:.3f}; peak memory above the "
          f"tree {peaks['box']:.2f} / {peaks['ray']:.2f} / "
          f"{peaks['pick']:.2f} GiB; launches {launches}")
    return launches, summary


def sphere_one(nearest, oid, centers, radii, ro, dn):
    """ray_sphere for one object id (the ordered pick's narrow phase)."""
    i = oid.reshape(1)            # index_select: no wait for the card
    c = centers.index_select(0, i)[0] - ro
    t = c[0] * dn[0] + c[1] * dn[1] + c[2] * dn[2]
    d2 = c[0] * c[0] + c[1] * c[1] + c[2] * c[2] - t * t
    r = radii.index_select(0, i)[0]
    r2 = r * r
    root = torch.sqrt(torch.clamp(r2 - d2, min=0.0))
    hit = (d2 <= r2) & (t + root >= 0)
    return torch.where(hit, t - root, torch.inf)


def band_test(lo, hi, gap_x):
    """A non-monotone predicate: overlap with [lo, hi], and a cell extent
    of at least a quarter of the box or of at most 2, or a cell right of
    x = gap_x; left of it, middle-sized cells prune descendants that
    would pass their own test."""
    def should_test(gstate):
        cmin, cmax = gstate
        overlap = torch.all((cmin <= hi) & (cmax >= lo), dim=-1)
        ext = torch.amax(cmax - cmin, dim=-1)
        return overlap & ((ext >= 250.0) | (ext <= 2.0)
                          | (cmin[..., 0] >= gap_x))
    return should_test


def traverse_phase(scene_big, dev, fresh):
    """The generic traversals on the card: test_generic with the box
    halving state and the box predicate equal to test_box at 1M; a
    non-monotone band, pick_ordered (box geometry, an id-hash distance)
    and pick_ray_ordered (ray-sphere) equal to the CPU path at 30k; one
    1M pick_ray_ordered with id_bound, timed, with its steps.  Returns
    (the launches of the 1M walk, its times)."""
    smin, smax = scene_big[0], scene_big[1]
    root, sub = traverse.box_halving_state(SPEC, smin, smax)
    rng = np.random.default_rng(23)
    boxes = []
    for _ in range(4):
        lo = (smin + rng.uniform(0, 1, 3) * (smax - smin - 30)).astype(
            np.float32)
        boxes.append((lo, (lo + rng.uniform(5, 30, 3)).astype(np.float32)))
    reset_launches()
    walks = []
    for lo, hi in boxes:
        lo_t, hi_t = torch.as_tensor(lo, device=dev), torch.as_tensor(
            hi, device=dev)
        walks.append(traverse.test_generic(
            SPEC, fresh, root, sub, lambda g, lo_t=lo_t, hi_t=hi_t: torch.all(
                (g[0] <= hi_t) & (g[1] >= lo_t), dim=-1), QUERY_CAP,
            frontier_cap=4096)[1])
    launches = read_launches()
    for (lo, hi), got in zip(boxes, walks):
        want = query.test_box(SPEC, fresh, smin, smax, (lo, hi), QUERY_CAP,
                              engine="linear")[1]
        check(same_hits(got, want), "traverse 1M: test_generic with the box "
              "predicate differs from test_box")
    lo_t, hi_t = torch.as_tensor(boxes[0][0], device=dev), torch.as_tensor(
        boxes[0][1], device=dev)
    g_ms = p50(host_ms(lambda: traverse.test_generic(
        SPEC, fresh, root, sub, lambda g: torch.all(
            (g[0] <= hi_t) & (g[1] >= lo_t), dim=-1), QUERY_CAP,
        frontier_cap=4096), 5))

    # 30k: the card against the CPU
    n = 30_000
    sc = bench_caps.bench_scene(3, n, seed=7)
    on = {where: layer.build(SPEC, *sc, out_capacity=4 * n, device=dv)
          for where, dv in (("card", dev), ("cpu", torch.device("cpu")))}
    smin3, smax3 = sc[0], sc[1]
    mid = (smin3 + smax3) / 2
    root3, sub3 = traverse.box_halving_state(SPEC, smin3, smax3)
    lo, hi = mid - 40.0, mid + 40.0
    res = {}
    for dv, st in on.items():
        pred = band_test(torch.as_tensor(lo, device=st.ids.device),
                         torch.as_tensor(hi, device=st.ids.device),
                         float(mid[0]))
        res[dv] = traverse.test_generic(SPEC, st, root3, sub3, pred,
                                        QUERY_CAP, frontier_cap=4096)[1]
    box30 = query.test_box(SPEC, on["card"], smin3, smax3, (lo, hi),
                           QUERY_CAP, engine="linear")[1]
    check(same_hits(res["card"], res["cpu"]) and 0 < int(res["card"].count)
          < int(box30.count), "traverse 30k: the non-monotone band differs "
          "from the CPU path (or prunes nothing)")
    centers = ((sc[2] + sc[3]) / 2.0).astype(np.float32)
    radii = (np.min(sc[3] - sc[2], axis=1) / 2.0).astype(np.float32)
    steps0 = traverse.pick_ordered.steps
    n_found = 0
    for k in range(4):
        ro = (smin3 + rng.uniform(0, 1, 3) * (smax3 - smin3)).astype(
            np.float32)
        d = (centers[rng.integers(n)] - ro).astype(np.float32)
        dn = (d / np.linalg.norm(d)).astype(np.float32)
        qlo = (ro - 30.0).astype(np.float32)
        out = {}
        for dv, st in on.items():
            t = st.ids.device
            args = tuple(torch.as_tensor(x, device=t) for x in (
                centers, radii, ro, dn))
            ray = traverse.pick_ray_ordered(SPEC, st, smin3, smax3, ro, d,
                                            1e9, sphere_one, args)[1]
            boxp = traverse.pick_ordered(
                SPEC, st, *traverse.box_pick_state(SPEC, smin3, smax3, qlo,
                                                   qlo + 60.0),
                lambda g, near, oid: ((oid * 2654435761) % 4096).to(
                    torch.float32) / 16.0, 1e9)[1]
            out[dv] = (ray, boxp)
        check(same_pick(out["card"][0], out["cpu"][0])
              and same_pick(out["card"][1], out["cpu"][1]),
              f"traverse 30k: ordered pick {k} differs from the CPU path")
        n_found += bool(out["card"][0].found)
    steps30 = (traverse.pick_ordered.steps - steps0) / 16

    # 1M: one ordered ray pick with id_bound, timed
    c_t, r_t = (torch.as_tensor(a, device=dev) for a in query_set(
        scene_big)[3:])
    _, _, picks, _, _ = query_set(scene_big)
    ro, d, dn = picks[0]
    args = (c_t, r_t, torch.as_tensor(ro, device=dev),
            torch.as_tensor(dn, device=dev))

    def ordered():
        return traverse.pick_ray_ordered(SPEC, fresh, smin, smax, ro, d, 1e9,
                                         sphere_one, args,
                                         id_bound=len(scene_big[4]))[1]

    steps0, reads0 = traverse.pick_ordered.steps, \
        traverse.pick_ordered.host_reads
    t0 = time.perf_counter()
    got = ordered()
    torch.cuda.synchronize()
    o_ms = (time.perf_counter() - t0) * 1e3
    steps = traverse.pick_ordered.steps - steps0
    reads = traverse.pick_ordered.host_reads - reads0
    want = query.pick_ray(SPEC, fresh, smin, smax, ro, d, 1e9, ray_sphere,
                          args, engine="linear")[1]
    check(same_pick(got, want), "traverse 1M: pick_ray_ordered with the "
          "ray-sphere narrow phase differs from pick_ray")
    print(f"traverse: test_generic (box halving, box predicate) equals "
          f"test_box at 1M for 4 boxes, p50 {g_ms:.3f} ms; at 30k a "
          f"non-monotone band ({int(res['card'].count)} of the box's "
          f"{int(box30.count)} hits) and 4 pick_ray_ordered (ray-sphere, "
          f"{n_found} found) and 4 box pick_ordered (id-hash distance) equal"
          f" the CPU path, {steps30:.0f} steps per pick; at 1M "
          f"pick_ray_ordered with id_bound equals pick_ray (found "
          f"{bool(got.found)}): {steps} steps, {reads} host reads, "
          f"{o_ms:.1f} ms, {o_ms / max(steps, 1):.3f} ms per step; launches "
          f"of the 1M walks {launches}")
    return launches, {"test_generic_1M_p50": g_ms,
                      "pick_ray_ordered_1M_ms": o_ms,
                      "pick_ray_ordered_1M_steps": steps,
                      "ms_per_step": o_ms / max(steps, 1)}


# ---------------------------------------------------------------------------
# The sharded surface (parallel/): world 1 under NCCL, then four ranks on
# the one card over a gloo group, which stages CUDA tensors through the host
# ---------------------------------------------------------------------------

SHARDED_WORLDS = ((1, "nccl"), (4, "gloo"))
STEP_KERNELS = ("emit_build", "run_ends", "prep_runs", "expand_pairs_prepped",
                "stream_compact")


def sharded_caps(n: int, world: int) -> dict:
    """Per-rank capacities at n bench objects over ``world`` ranks: the
    fragment 25% over an even share of the tree; the scan's pair buffer,
    which also bounds its raw emissions, 50% over an even share of the
    single-chip emission buffer; a dedup row the single-chip pair buffer
    and a quarter on one rank, else twice an even (source, destination)
    share of that."""
    frag = -(-bench_caps.tree_capacity(n) * 5 // (4 * world))
    pairs = -(-bench_caps.emit_capacity(n) * 3 // (2 * world))
    xcap = bench_caps.pair_capacity(n) * 5 // 4
    return {"fragment": frag, "bucket": -(-frag // world), "pairs": pairs,
            "exchange": xcap if world == 1 else -(-2 * xcap // world ** 2)}


def sharded_queries(scene, dev):
    """The sharded phase's queries on the 1M scene: 64 boxes, 64 rays (4
    axis-parallel), 16 ray-sphere picks aimed at objects, and the picks'
    per-query distance arguments on ``dev``."""
    smin, smax, bmin, bmax, ids = scene
    rng = np.random.default_rng(23)
    ext = smax - smin
    lo = (smin + rng.uniform(0, 1, (64, 3)) * (ext - 30)).astype(np.float32)
    boxes = (lo, (lo + rng.uniform(1, 30, (64, 3))).astype(np.float32))
    ro = (smin + rng.uniform(0, 1, (64, 3)) * ext).astype(np.float32)
    rd = rng.normal(size=(64, 3)).astype(np.float32)
    rd[::16, 0] = 0.0
    centers = ((bmin + bmax) / 2.0).astype(np.float32)
    radii = (np.min(bmax - bmin, axis=1) / 2.0).astype(np.float32)
    pro = ro[:16]
    pd = (centers[rng.integers(len(ids), size=16)] - pro).astype(np.float32)
    pdn = (pd / np.linalg.norm(pd, axis=1, keepdims=True)).astype(np.float32)
    pargs = (torch.as_tensor(centers, device=dev).expand(16, -1, -1),
             torch.as_tensor(radii, device=dev).expand(16, -1),
             torch.as_tensor(pro, device=dev),
             torch.as_tensor(pdn, device=dev))
    return boxes, (ro, rd), (pro, pd), pargs


def fragments_equal(a, b) -> bool:
    """Two ranks' fragments: live keys, ids and aux, counts and flags."""
    c = int(a.counts[dist.get_rank()])
    return (torch.equal(a.counts, b.counts)
            and all(torch.equal(x[:c], y[:c]) for x, y in zip(a[:3], b[:3]))
            and int(a.invalid_count) == int(b.invalid_count)
            and bool(a.overflow) == bool(b.overflow))


def rank_ms(fn, reps: int) -> list:
    """Host-clock times of fn() in ms, every rank starting together (a
    barrier) and each call ended by a synchronize."""
    walls = []
    for _ in range(reps):
        dist.barrier()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return walls


def sent_bytes() -> int:
    return parallel.scan.exchange.bytes + parallel.scan.all_gather_rows.bytes


def sharded_rank(rank, device, n, reps):
    """One rank of the sharded phase at n bench objects: the step, the
    persistent layer (build, scan, gather and shard, the 90% + 10% merge,
    the queries) and a 1% update, each path's kernel launches counted from
    0.  Checks what one rank can check; returns the rest (rank 0's pairs,
    tree and query answers) for the parent to hold against the
    single-chip path and the oracle."""
    _, world = parallel.scan.world()
    caps = sharded_caps(n, world)
    scene = bench_caps.bench_scene(3, n)
    smin, smax = scene[0], scene[1]
    bmin, bmax, ids = (torch.as_tensor(x, device=device) for x in (
        scene[2], scene[3], scene[4].astype(np.int64)))
    shard = parallel.object_shard
    mine = (shard(bmin), shard(bmax), shard(ids))
    out = {"launches": {}, "ms": {}, "bytes": {}, "device_ms": {}}

    # the step
    step = parallel.make_sharded_step(
        SPEC, bucket_capacity=caps["bucket"], pair_capacity=caps["pairs"],
        exchange_capacity=caps["exchange"])
    reset_launches()
    sent = sent_bytes()
    res = step(smin, smax, *mine)
    out["launches"]["sharded_step"] = read_launches()
    out["bytes"]["step"] = sent_bytes() - sent
    check(not bool(res.overflow), f"sharded step, world {world}: overflow")
    pairs = parallel.gather_pairs(res)
    out["shard_counts"] = res.shard_counts.tolist()
    out["ms"]["step"] = rank_ms(lambda: step(smin, smax, *mine), reps)
    layers, ops = device_ms_by_layer(lambda: step(smin, smax, *mine),
                                     reps=1)
    out["device_ms"]["step"] = sum(layers.values())
    out["step_profile"] = (layers, ops)

    # the persistent layer
    build = parallel.make_build_sharded(SPEC,
                                        fragment_capacity=caps["fragment"])
    scan = parallel.make_scan_sharded(SPEC, pair_capacity=caps["pairs"],
                                      exchange_capacity=caps["exchange"])
    merge = parallel.make_merge_sharded(SPEC)
    box, ray, make_pick = parallel.make_queries_sharded(
        SPEC, result_cap=QUERY_CAP)
    boxes, rays, picks, pargs = sharded_queries(scene, device)
    cut = n * 9 // 10
    reset_launches()
    sent = sent_bytes()
    lyr = build(smin, smax, *mine)
    sres = scan(lyr)
    out["bytes"]["build_scan"] = sent_bytes() - sent
    static = build(smin, smax, shard(bmin[:cut]), shard(bmax[:cut]),
                   shard(ids[:cut]))
    dynamic = build(smin, smax, shard(bmin[cut:]), shard(bmax[cut:]),
                    shard(ids[cut:]))
    merged = merge(static, dynamic)
    answers = {"box": box(lyr, smin, smax, boxes),
               "ray": ray(lyr, smin, smax, *rays, 0.0, np.inf),
               "pick": make_pick(ray_sphere)(lyr, smin, smax, *picks, 1e9,
                                             pargs)}
    out["launches"]["sharded_layer"] = read_launches()
    check(not bool(lyr.overflow) and not bool(sres.overflow)
          and not bool(merged.overflow),
          f"sharded layer, world {world}: overflow")
    check(np.array_equal(parallel.gather_pairs(sres), pairs),
          f"sharded layer, world {world}: the scan's pairs differ from the "
          "step's")
    check(fragments_equal(merged, lyr), f"sharded merge, world {world}: "
          "the 90% + 10% merge differs from the fresh sharded build")
    gathered = parallel.gather_layer(SPEC, lyr)
    back = parallel.shard_layer(SPEC, gathered,
                                fragment_capacity=lyr.ids.shape[0])
    check(all(torch.equal(x, y) for x, y in zip(back[:4], lyr[:4])),
          f"sharded layer, world {world}: shard_layer(gather_layer) is not "
          "the fragment")
    out["ms"]["scan"] = rank_ms(lambda: scan(lyr), reps)
    layers, _ = device_ms_by_layer(lambda: scan(lyr), reps=1)
    out["device_ms"]["scan"] = sum(layers.values())

    # the update at 1% churn
    churn_cap, obj_cap = bench_caps.update_caps(n, 0.01)
    A, B = motion(scene, 0.01, device)
    tracked = parallel.make_build_tracked_sharded(
        SPEC, fragment_capacity=caps["fragment"])(
            smin, smax, shard(A[0]), shard(A[1]), mine[2])
    update = parallel.make_update_sharded(SPEC, churn_cap=churn_cap,
                                          obj_cap=obj_cap)
    reset_launches()
    sent = sent_bytes()
    moved = update(tracked, smin, smax, shard(B[0]), shard(B[1]))
    out["launches"]["sharded_update"] = read_launches()
    out["bytes"]["update"] = sent_bytes() - sent
    fresh = build(smin, smax, shard(B[0]), shard(B[1]), mine[2])
    check(not bool(moved.layer.overflow) and fragments_equal(
        moved.layer, fresh) and torch.equal(moved.layer.aux, fresh.aux),
          f"sharded update 1%, world {world}: differs from a fresh sharded "
          "build")
    frames = {"tracked": moved, "k": 0}

    def next_frame():
        frames["k"] += 1
        bounds = A if frames["k"] % 2 else B
        frames["tracked"] = update(frames["tracked"], smin, smax,
                                   shard(bounds[0]), shard(bounds[1]))

    out["ms"]["update"] = rank_ms(next_frame, reps)
    check(not bool(frames["tracked"].layer.overflow),
          f"sharded update 1%, world {world}: overflow in the timed frames")
    if rank == 0:
        cnt = int(gathered.count)
        out["pairs"] = pairs
        out["tree"] = tuple(x[:cnt].cpu().numpy() for x in gathered[:3])
        out["answers"] = answers
    return out


def sharded_phase(scene_big, dev, state, want, tree_cap):
    """The sharded surface at 1M on the bench scene, as world 1 under NCCL
    and as four ranks over gloo on the one card: the step and the
    persistent layer's scan against the oracle and the single-chip step at
    the world's min_depth, the gathered tree against the single-chip
    build, the queries against the single-chip batched queries; the merge,
    the gather / shard round trip and the 1% update checked by each rank.
    Returns (launches per route summed over ranks and worlds, timings)."""
    smin, smax = scene_big[0], scene_big[1]
    scene_t = to_device(scene_big, dev)
    routes = {r: dict.fromkeys(KERNELS, 0) for r in (
        "sharded_step", "sharded_layer", "sharded_update")}
    summary = {}
    for world, backend in SHARDED_WORLDS:
        t0 = time.perf_counter()
        ranks = parallel.run_ranks(sharded_rank, world, backend, None,
                                   len(scene_big[4]), 5)
        md = parallel.min_depth_for_devices(SPEC, world)
        if md == 0:
            ref, ref_pairs = state, want
        else:
            ref = layer.build(SPEC, *scene_t, min_depth=md,
                              out_capacity=tree_cap)
            okeys, oids, ref_pairs = oracle(native, scene_big, md)
            keys, ids, _ = layer.tree_to_numpy(SPEC, ref)
            check(np.array_equal(keys, okeys) and np.array_equal(ids, oids),
                  f"single-chip build at min_depth {md} differs from the "
                  "oracle's")
            cap = sharded_caps(len(scene_big[4]), 1)["pairs"]
            _, res = layer.scan(SPEC, ref, cap, emit_capacity=cap)
            check(np.array_equal(layer.scan_result_to_numpy(res),
                                 ref_pairs), f"single-chip scan at "
                  f"min_depth {md} differs from the oracle's")
        label = f"sharded world {world} ({backend})"
        got = ranks[0]
        check(np.array_equal(got["pairs"], ref_pairs),
              f"{label}: {got['pairs'].shape[0]} pairs differ from the "
              f"oracle's and the single-chip step's {ref_pairs.shape[0]} "
              f"at min_depth {md}")
        cnt = int(ref.count)
        check(all(np.array_equal(g, w[:cnt].cpu().numpy())
                  for g, w in zip(got["tree"], ref[:3])),
              f"{label}: gather_layer differs from the single-chip build at "
              f"min_depth {md}")
        boxes, rays, picks, pargs = sharded_queries(scene_big, dev)
        want_q = {
            "box": query.test_box_batch(SPEC, ref, smin, smax, boxes,
                                        QUERY_CAP)[1],
            "ray": query.test_ray_batch(SPEC, ref, smin, smax, *rays, 0.0,
                                        np.inf, QUERY_CAP)[1],
            "pick": query.pick_ray_batch(SPEC, ref, smin, smax, *picks, 1e9,
                                         ray_sphere, pargs)[1]}
        for kind, w in want_q.items():
            g = got["answers"][kind]
            check(all(np.array_equal(x, y.cpu().numpy())
                      for x, y in zip(g, w)),
                  f"{label}: {kind} queries differ from the single-chip "
                  "batched queries")
        for route in routes:
            for rank in ranks:
                for k, v in rank["launches"][route].items():
                    routes[route][k] += v
            need = ("merge_cancel_compact", "stream_compact") \
                if route == "sharded_update" else STEP_KERNELS
            if route == "sharded_layer":
                need += ("merge_cancel_compact",)
            check(all(sum(r["launches"][route][k] for r in ranks) > 0
                      for k in need),
                  f"{label}: a kernel of {route} was not launched: "
                  f"{[r['launches'][route] for r in ranks]}")
        ms = {k: [p50(r["ms"][k]) for r in ranks] for k in got["ms"]}
        summary.update({f"world{world}_{k}_p50": max(v)
                        for k, v in ms.items()})
        clock = "gloo staging CUDA tensors through the host" \
            if backend == "gloo" else "NCCL"
        print(f"{label}: the step's and the scan's {ref_pairs.shape[0]} "
              f"pairs equal the oracle and the single-chip step at min_depth"
              f" {md}; gather_layer equals the single-chip build ({cnt} "
              f"cells); 64 boxes, 64 rays and 16 picks "
              f"({int(got['answers']['pick'].found.sum())} found) equal the "
              f"single-chip batched queries; the 90% + 10% merge, the "
              f"gather / shard round trip and the 1% update equal the "
              f"fresh sharded build on every rank; overflow nowhere; "
              f"classes per rank {got['shard_counts']}")
        print(f"{label} timings ({clock}; host clock, barrier to "
              f"synchronize, p50 of 5 per rank): step "
              f"{[round(x, 3) for x in ms['step']]} ms, scan "
              f"{[round(x, 3) for x in ms['scan']]} ms, update 1% "
              f"{[round(x, 3) for x in ms['update']]} ms; device busy per "
              f"rank (profiler, one call): step "
              f"{[round(r['device_ms']['step'], 3) for r in ranks]} ms, scan "
              f"{[round(r['device_ms']['scan'], 3) for r in ranks]} ms; "
              f"bytes each rank sent (all_to_all + all_gather): step "
              f"{[r['bytes']['step'] for r in ranks]}, build + scan "
              f"{[r['bytes']['build_scan'] for r in ranks]}, update "
              f"{[r['bytes']['update'] for r in ranks]}; launches per rank "
              f"{[r['launches'] for r in ranks]}; "
              f"{time.perf_counter() - t0:.1f} s")
        layers, ops = got["step_profile"]
        print(f"profile {label} step, rank 0: {ops:.0f} device operations; "
              + ", ".join(f"{k} {v:.3f}" for k, v in
                          sorted(layers.items(), key=lambda kv: -kv[1])))
    return routes, summary


# ---------------------------------------------------------------------------
# The tools and the demo: the ball pit in three modes, the CLI's golden
# trio, the step and update profilers and the profiling utilities
# ---------------------------------------------------------------------------

DEMO_TOL = 1e-6     # positions, radii, pick distance: scatter-add order and
                    # the last bit of sin / cos / exp may differ by device


class LaunchTally:
    """Sums the kernels' launches over the calls it wraps, so that the
    comparisons between them do not count."""

    def __init__(self):
        self.total = {name: 0 for name in KERNELS}

    def __call__(self, fn, *args):
        before = read_launches()
        out = fn(*args)
        for name, n in read_launches().items():
            self.total[name] += n - before[name]
        return out


def hit_set(i, j, hit) -> set:
    """The unordered index pairs of the hit lanes."""
    i, j = i[hit].cpu().numpy(), j[hit].cpu().numpy()
    return set(zip(np.minimum(i, j).tolist(), np.maximum(i, j).tolist()))


def check_demo_frame(label, got, want):
    """A frame on the card against the same frame on the CPU: the scanned
    tree, pairs, hit and live counts and the pick exactly, and no overflow
    of the pair buffer; positions, radii and the pick's distance within
    DEMO_TOL."""
    check(not bool(got.overflow) and not bool(want.overflow),
          f"{label}: the pair buffer overflowed")
    check(want.tree is None if got.tree is None else
          torch.equal(got.tree.keys.cpu(), want.tree.keys)
          and torch.equal(got.tree.ids.cpu(), want.tree.ids),
          f"{label}: trees differ")
    gi, gj, gv = (x.cpu() for x in got.pairs)
    wi, wj, wv = want.pairs
    check(torch.equal(gv, wv) and torch.equal(gi[gv], wi[wv])
          and torch.equal(gj[gv], wj[wv]), f"{label}: pairs differ")
    check(int(got.ncol) == int(want.ncol)
          and int(got.nalive) == int(want.nalive),
          f"{label}: counts {int(got.ncol)}, {int(got.nalive)} != "
          f"{int(want.ncol)}, {int(want.nalive)}")
    check(bool(got.pick.found) == bool(want.pick.found)
          and int(got.pick.obj_id) == int(want.pick.obj_id)
          and (not bool(want.pick.found)
               or abs(float(got.pick.distance) - float(want.pick.distance))
               <= DEMO_TOL), f"{label}: pick differs")
    check(torch.equal(got.state.expires.cpu(), want.state.expires),
          f"{label}: lifetimes differ")
    for name in ("pos", "prev", "radius"):
        g, w = getattr(got.state, name).cpu(), getattr(want.state, name)
        err = float((g - w).abs().max())
        check(err <= DEMO_TOL, f"{label}: {name} off by {err}")


def demo_mode(dev, mode, n, frames, tally):
    """One mode of the demo at n balls: ``frames`` frames on the card
    (each one timed, counted and ended by a synchronize); every 30th also
    on the CPU from the same state and draws, and, outside brute-force
    mode, its circle hits against brute force on the card."""
    brute, life = mode == "brute_force", mode == "lifecycle"
    sim = ball_pit.make_sim(n, brute, life, dev)
    sim_cpu = ball_pit.make_sim(n, brute, life, "cpu")
    sim_bf = None if brute else ball_pit.make_sim(n, True, life, dev)
    state = ball_pit.initial_state(sim, 0)
    gen = torch.Generator(device=dev).manual_seed(0) if life else None

    def draws():
        return ball_pit.lifecycle_draws(sim, gen) if life else None

    ball_pit.frame(state, sim, draws())                    # warm-up
    torch.cuda.synchronize()
    walls, ncol, checked, hits, walls_out = [], [], 0, 0, 0
    for f in range(frames):
        d = draws()
        t0 = time.perf_counter()
        out = tally(ball_pit.frame, state, sim, d)      # synchronizes
        walls.append((time.perf_counter() - t0) * 1e3)
        ncol.append(out.ncol)
        if f % 30 == 0:
            cpu_state = ball_pit.State(*(x.cpu() for x in state))
            want = ball_pit.frame(cpu_state, sim_cpu,
                                  None if d is None else d.cpu())
            check_demo_frame(f"ball pit {mode} frame {f}", out, want)
            checked += 1
            if sim_bf is not None:
                _, r, _, alive, moved = ball_pit.integrate(state, sim, d)
                ray = ball_pit.ray_direction(state.t, sim)
                # a ball pressed into a wall leaves the system box, and the
                # build drops it that frame, as in the JAX demo: brute
                # force is held to the balls inside the box
                inside = geom.bounds_contains(sim.smin, sim.smax,
                                              moved - r[:, None],
                                              moved + r[:, None])
                sets = []
                for s in (sim, sim_bf):
                    con = ball_pit.contacts(moved, r, alive, ray, s)
                    check(not bool(con.overflow),
                          f"ball pit {mode} frame {f}: overflow")
                    i, j = con.i, con.j
                    hit, _ = ball_pit.narrow_phase(moved, r, i, j,
                                                   con.valid, s)
                    if s is sim_bf:
                        walls_out += len(hit_set(i, j, hit & ~(
                            inside[i] & inside[j])))
                        hit = hit & inside[i] & inside[j]
                    sets.append(hit_set(i, j, hit))
                check(sets[0] == sets[1],
                      f"ball pit {mode} frame {f}: {len(sets[0])} broadphase"
                      f" hits != {len(sets[1])} brute-force hits of the "
                      "balls inside the box")
                hits += len(sets[0])
        state = out.state
    d = draws()
    _, syncs = count_syncs(lambda: ball_pit.frame(state, sim, d))
    layers, ops = device_ms_by_layer(lambda: ball_pit.frame(state, sim, d))
    p50_, p90_ = np.percentile(walls, [50, 90])
    busy = sum(layers.values())
    total = int(torch.stack(ncol).sum())
    nalive = int(out.nalive)
    print(f"ball pit demo {mode} ({n} balls, {frames} frames): p50 "
          f"{p50_:.3f} ms/frame, p90 {p90_:.3f} (each frame synchronized); "
          f"device busy {busy:.3f} ms/frame (idle share "
          f"{1 - busy / p50_:.3f}), {ops:.0f} device operations, {syncs} "
          f"host synchronizations per frame; {total} collisions in all, "
          f"{nalive} balls alive at the end; {checked} frames equal the "
          f"CPU path (pairs, counts, pick; positions within {DEMO_TOL})"
          + (f", their {hits} circle hits equal brute force's among the "
             f"balls inside the box ({walls_out} more hits involve a ball "
             "pressed into a wall, which the build drops)" if sim_bf
             is not None else "") + "; device by layer " + ", ".join(
              f"{k} {v:.3f}" for k, v in
              sorted(layers.items(), key=lambda kv: -kv[1])))
    return {f"{mode}_p50": p50_, f"{mode}_p90": p90_,
            f"{mode}_busy": busy}


def demo_phase(dev, n=2500, frames=300):
    """The ball-pit demo (``examples.ball_pit``) in its three modes, n
    balls and ``frames`` frames each, and its command line for 60 frames.
    Returns (launches per mode, the numbers)."""
    routes, summary = {}, {}
    for mode in ("default", "lifecycle", "brute_force"):
        tally = LaunchTally()
        summary.update(demo_mode(dev, mode, n, frames, tally))
        routes[f"ball_pit_{mode}"] = tally.total
    check(all(routes["ball_pit_default"][k] > 0 for k in
              ("emit_build", "run_ends", "prep_runs", "expand_pairs_prepped",
               "stream_compact")),
          f"ball pit demo: a kernel of the frame was not launched: "
          f"{routes['ball_pit_default']}")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ball_pit.main(["--frames", "60", "--balls", str(n), "--device",
                       str(dev)])
    print(f"ball pit command line (60 frames, default mode): "
          f"{buf.getvalue().splitlines()[-1]}")
    return routes, summary


def trio_equals_native(out_dir, scene_path):
    """The golden trio in out_dir against the C++ oracle on the scene:
    the unsorted tree cell for cell, the sorted tree, the pairs."""
    sc = br_scene.load(scene_path)
    keys, oids, _ = native.extend(sc.system_min, sc.system_max,
                                  sc.bounds_min, sc.bounds_max, sc.ids)
    got = [br_scene.load(Path(out_dir) / f"{name}.br_scene") for name in (
        "0_layer_unsorted", "1_layer_sorted", "2_layer_collisions")]
    check(np.array_equal(got[0].layer.keys, keys)
          and np.array_equal(got[0].layer.ids, oids),
          f"{scene_path}: the unsorted tree differs from native.extend")
    keys, oids = native.sort_tree(keys, oids)
    check(np.array_equal(got[1].layer.keys, keys)
          and np.array_equal(got[1].layer.ids, oids) and got[1].layer.sorted,
          f"{scene_path}: the sorted tree differs from native.sort_tree")
    pairs = native.scan_seq(keys, oids,
                            pair_slack=max(4, 24_000_000 // len(oids)))
    check(np.array_equal(got[2].collisions, pairs),
          f"{scene_path}: {len(got[2].collisions)} pairs differ from "
          f"native.scan_seq's {len(pairs)}")
    return len(oids), len(pairs)


def cli_phase(dev, counts=(("10k", 10_000), ("1M", 1_000_000))):
    """The CLI in-process: gen_boxes (the reference's fixture
    boxes-seed_0-d_1_1000-s_1_10-n_010000, and the same generator at 1M)
    and gen_validation_data on the card, each timed; the golden trio held
    against the C++ oracle.  Returns (the launches of both pipelines, the
    times)."""
    tally, times, lines = LaunchTally(), {}, []
    with tempfile.TemporaryDirectory() as d:
        for label, count in counts:
            path = str(Path(d) / f"s{label}.br_scene")
            out = str(Path(d) / f"val{label}")
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                cli.main(["gen_boxes", "--count", str(count), "--density",
                          "0.001", "--size", "1", "10", "--seed", "0",
                          "--out", path])
            t1 = time.perf_counter()
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                tally(cli.main, ["gen_validation_data", "--in", path,
                                 "--out-dir", out, "--device", str(dev)])
            t2 = time.perf_counter()
            cells_, pairs = trio_equals_native(out, path)
            times[f"gen_boxes_{label}_s"] = t1 - t0
            times[f"gen_validation_data_{label}_s"] = t2 - t1
            lines.append(f"{label}: gen_boxes {t1 - t0:.3f} s, "
                         f"gen_validation_data {t2 - t1:.3f} s ({cells_} "
                         f"cells, {pairs} pairs)")
    check(all(tally.total[k] > 0 for k in (
        "emit_build", "run_ends", "prep_runs", "expand_pairs_prepped",
        "stream_compact")), f"CLI: a kernel was not launched: "
          f"{tally.total}")
    print("CLI (gen_boxes seed 0, density 1/1000, sizes 1-10; "
          "gen_validation_data on the card): the golden trio equals "
          "native.extend / sort_tree / scan_seq cell for cell and pair "
          "for pair; " + "; ".join(lines) + f"; launches {tally.total}")
    return tally.total, times


def ms_text(x) -> str:
    return "not measured" if x is None else f"{x:.3f} ms"


def profiler_phase(dev, step_p50, update_p50s, n=1_000_000):
    """The step profiler at 1M and the update profiler at 1M, 1% and 3%
    (each checks that its full prefix equals the production path); the
    stage tables.  Returns (the launches of one full prefix of each, the
    full prefixes' times)."""
    routes, summary = {}, {}

    def measured(label, rows):
        check(all(r.device_ms is not None and r.device_ms > 0
                  and r.device_ops > 0 for r in rows),
              f"{label}: the profiler shows no device time for "
              + ", ".join(r.name for r in rows if not r.device_ms))

    rows = profile_step.profile(n, dev)
    measured(f"profile_step {n}", rows)
    full = rows[-1]
    print(f"profile_step {n} (the full prefix's pairs equal layer.scan's): "
          f"full prefix host {full.host_ms:.3f} ms (best of 3 x 8, "
          f"pipelined), device {ms_text(full.device_ms)}; phase 5's p50 "
          f"{step_p50:.3f} ms (one synchronize a step)\n"
          + profile_step.stage_table(rows))
    summary["step_full_host"], summary["step_full_device"] = \
        full.host_ms, full.device_ms
    scene_t = to_device(bench_caps.bench_scene(3, n), dev)
    prefixes = profile_step.make_prefixes(SPEC, scene_t,
                                          *profile_step.caps(n))
    reset_launches()
    prefixes[-1]()
    routes["profile_step"] = read_launches()
    for frac in (0.01, 0.03):
        rows, build = profile_update.profile(n, frac, dev)
        measured(f"profile_update {n} churn {frac:.0%}", rows + [build])
        full = rows[-1]
        print(f"profile_update {n} churn {frac:.0%} (the full prefix equals "
              f"update and a fresh build): full host {full.host_ms:.3f} ms, "
              f"device {ms_text(full.device_ms)}; fresh build host "
              f"{build.host_ms:.3f} ms, device {ms_text(build.device_ms)}; "
              f"phase 7's update p50 {update_p50s[frac]:.3f} ms\n"
              + profile_step.stage_table(rows))
        summary[f"update_{frac:.2f}_full_host"] = full.host_ms
        summary[f"update_{frac:.2f}_full_device"] = full.device_ms
    smin, smax, bmin, bmax, ids, bmin2, bmax2 = (
        torch.as_tensor(x, device=dev)
        for x in profile_update.moving_scene(n, 0.03))
    churn_cap, obj_cap = bench_caps.update_caps(n, 0.03)
    tracked = upd.build_tracked(SPEC, smin, smax, bmin, bmax,
                                ids.to(torch.int64),
                                out_capacity=bench_caps.tree_capacity(n))
    reset_launches()
    upd.update(SPEC, tracked, smin, smax, bmin2, bmax2, churn_cap,
               obj_cap=obj_cap, _stage="full")
    routes["profile_update"] = read_launches()
    return routes, summary


def profiling_phase(dev, scene_t, caps):
    """The profiling utilities on the 1M step: timed, trace (a Chrome
    trace in a temporary directory), device_memory_stats, peak_memory."""
    def step_once():
        return step(scene_t, *caps, True)

    stats = profiling.timed(step_once, iters=20, warmup=3, device=dev)
    check(set(stats) == {"p50_ms", "p90_ms", "min_ms", "mean_ms", "iters"}
          and 0 < stats["min_ms"] <= stats["p50_ms"] <= stats["p90_ms"],
          f"timed: {stats}")
    with tempfile.TemporaryDirectory() as d:
        with profiling.trace(d):
            step_once()
        size = (Path(d) / "trace.json").stat().st_size
        text = (Path(d) / "trace.json").read_text()
    check(size > 0 and "build_kernel" in text,
          f"trace: {size} bytes, no kernel in it")
    mem = profiling.device_memory_stats(dev)
    check(mem is not None and 0 < mem["bytes_in_use"]
          <= mem["peak_bytes_in_use"] <= mem["bytes_limit"],
          f"device_memory_stats: {mem}")
    peak = profiling.peak_memory(step_once, device=dev)
    check(peak > 0, f"peak_memory: {peak}")
    print(f"profiling 1M step: timed p50 {stats['p50_ms']:.3f} ms, p90 "
          f"{stats['p90_ms']:.3f}, min {stats['min_ms']:.3f} (20); trace "
          f"{size / 1e6:.1f} MB of Chrome trace; device memory in use "
          f"{mem['bytes_in_use'] / 2 ** 30:.2f} GiB, peak "
          f"{mem['peak_bytes_in_use'] / 2 ** 30:.2f} GiB of "
          f"{mem['bytes_limit'] / 2 ** 30:.1f}; peak_memory of one step "
          f"{peak / 2 ** 30:.3f} GiB above the live tensors")
    return {"timed_p50": stats["p50_ms"], "peak_gib": peak / 2 ** 30}


def main() -> int:
    # 1. device
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False: this smoke test "
              "runs only on a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"card: {smi}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.device_count()} device(s)")

    # 2. build the kernels from csrc/
    t0 = time.perf_counter()
    _cuda.load()
    print(f"build: {len(KERNELS)} kernels from broadphase_tpu_torch/csrc in "
          f"{time.perf_counter() - t0:.1f} s -> {_cuda.library_path().name}")
    print("ptxas: " + " | ".join(ptxas_summary(sorted(
        {re.split(r"<|ILb", k)[0] for *_, names in KERNELS.values()
         for k in names} - {"Memset"}))))

    n_big = 1_000_000
    scene_big = bench_caps.bench_scene(3, n_big)
    tree_cap = bench_caps.tree_capacity(n_big)
    pair_cap = bench_caps.pair_capacity(n_big)
    emit_cap = bench_caps.emit_capacity(n_big)

    # 3. kernels against their plain versions: the 1M step's own
    # intermediates (and a 1% update frame's merge inputs, from phase 7),
    # timed, and the adversarial cases
    inputs = build_inputs(scene_big, dev)
    state_big = layer.build(SPEC, *scene_big, out_capacity=tree_cap,
                            device=dev)
    errs, timed, extra = compare_all(state_big, inputs, emit_cap)
    # kernel 1 at 1M with the tree a third of the count: the same prefix
    errs["emit_build"] = max(errs["emit_build"],
                             compare_build(inputs, tree_cap // 3)[0])
    glue, glue_ops = device_ms_by_layer(
        lambda: pass1_glue(state_big.keys, state_big.aux))
    print(f"pass-1 glue at 1M (the torch operations kernel 2 absorbed, run "
          f"as the step ran them before): device {sum(glue.values()):.3f} "
          f"ms, {glue_ops:.0f} device operations (5 profiled calls)")
    e_big = scan_pass1(SPEC, state_big.keys, rules=False)[0]
    glue, glue_ops = device_ms_by_layer(
        lambda: layer.runs_v2(e_big, state_big.count))
    print(f"runs_v2 glue at 1M (the torch operations kernel 3 took over in "
          f"the v2 scan, run as the scan ran them before): device "
          f"{sum(glue.values()):.3f} ms, {glue_ops:.0f} device operations "
          f"(5 profiled calls)")
    n_cases = adversarial(dev)
    print(f"adversarial: {n_cases} kernel cases exact (empty, one element, "
          f"ragged sizes, depth-0 and shallow boxes, outside boxes, "
          f"undersized tree, total > emit_cap, ids either side of 2^24-1, "
          f"kernel 3 with and without meta, kernel 7 on both entry points; "
          f"pass 1: n = 1 and 2, n around a tile multiple, 1000+ tiles, the "
          f"three specs, a depth-0 box, lca = 0 boundaries many tiles apart,"
          f" pads from mid-tile, aux all zero, all set and random, two calls"
          f" in a row, rule bytes on and off, n >= 2^31 - tile refused; "
          f"compaction: 8k+ tiles, tiles alternating all and none kept, "
          f"one kept lane in the last tile, n one below, at and above a "
          f"tile multiple, 1, 3 and 4 columns with distinct fills, two "
          f"calls in a row on one stream; prep: 1000+ tiles, m = 0, every "
          f"lane nonempty, count = 0, count = cap and inside the last tile, "
          f"cap around a tile multiple, total >= 2^31 (wrapped) and > 2^40,"
          f" two calls in a row; build: the three specs at A = 2 and 3, "
          f"depth-0 objects, min_depth 0/4/12 (cell overflow), half the "
          f"objects outside, n around the 256-object block, out_cap below "
          f"the count (n/2, 1, 257, a third, one short) slot for slot, two "
          f"calls in a row; expansion: a run longer than "
          f"several blocks, every run of length 1 (m = total), block edges "
          f"on run starts, runs one block long, m = 0, each with total "
          f"mid-block and total > capacity, rule on and off, ids either "
          f"side of 2^24-1; "
          f"merge: empty churn, all tombstones, all inserts, churn outside "
          f"the tree's keys, empty tree, inserts equal to live entries, "
          f"short churn_count, whole-tree churn, merged sizes around a tile"
          f" multiple, all churn in one tile's key range, a tombstone first "
          f"in a tile with its twin last in the one before, equal (key, "
          f"meta) ties across a tile edge, cap + nc >= 2^31 refused; v2 "
          f"expansion, on the JAX contract and on entries: a run "
          f"longer than any block, all runs empty, total mid-buffer, "
          f"total > pair capacity, empty tree)")

    # 4. slice at 30k against the C++ oracle, plus a depth-0 object
    n_small = 30_000
    scene_small = bench_caps.bench_scene(3, n_small)
    for label, sc in (("30k+depth0", with_box(scene_small, 0.0, 1.0, 1, 5)),
                      ("30k", scene_small)):
        cells, pairs = check_slice(
            native, sc, dev, 4 * n_small, 10 * n_small, 16 * n_small, label)
        print(f"slice {label}: tree ({cells} cells) and {pairs} canonical "
              "pairs equal the oracle; canonical=False same set and count")
    _, ovf = step(to_device(scene_small, dev), 4 * n_small, pairs // 2,
                  16 * n_small, True)
    check(bool(ovf.overflow), "30k: undersized pair_capacity did not set "
          "overflow")
    print(f"slice 30k: pair_capacity {pairs // 2} (half its pairs) sets "
          "overflow")
    scene_2d = with_box(bench_caps.bench_scene(2, n_small), 0.0, 1.0, 1, 6)
    for spec in (Index64_2D, Index32_2D):
        pairs = check_against_cpu(spec, scene_2d, dev, (
            4 * n_small, 16 * n_small, 32 * n_small))
        print(f"slice {spec.name} 30k+depth0: tree and {pairs} canonical "
              "pairs, and the emission-order pairs, equal the CPU path's")

    # 5. slice at 1M: the main path, counted launches, oracle, step times
    scene_t = to_device(scene_big, dev)
    reset_launches()
    state, res = step(scene_t, tree_cap, pair_cap, emit_cap, True)
    step_launches = read_launches()
    step_kernels = [k for k, v in KERNELS.items() if v[3] == "step"]
    check(all(step_launches[k] > 0 for k in step_kernels),
          f"1M: a kernel of the path was not launched: {step_launches}")
    check(not bool(state.overflow) and not bool(res.overflow), "1M: overflow")
    want_keys, want_ids, want = oracle(native, scene_big)
    keys, ids, _ = layer.tree_to_numpy(SPEC, state)
    check(np.array_equal(keys, want_keys) and np.array_equal(ids, want_ids),
          "1M: tree differs from the oracle's")
    got = layer.scan_result_to_numpy(res)
    check(got.shape == want.shape and np.array_equal(got, want),
          f"1M: {got.shape[0]} canonical pairs differ from the oracle's "
          f"{want.shape[0]}")
    print(f"slice 1M: tree ({len(want_ids)} cells) and {want.shape[0]} "
          f"canonical pairs equal the oracle; launches {step_launches}; "
          f"scene sha1 {scene_digest(scene_big)} (numpy {np.__version__})")

    step_p50 = {}
    for canonical in (True, False):
        for _ in range(3):
            step(scene_t, tree_cap, pair_cap, emit_cap, canonical)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        walls = host_ms(lambda: step(scene_t, tree_cap, pair_cap, emit_cap,
                                     canonical), 100)
        _, r = step(scene_t, tree_cap, pair_cap, emit_cap, canonical)
        check(not bool(r.overflow) and int(r.count) == want.shape[0],
              f"1M canonical={canonical}: count {int(r.count)} != "
              f"{want.shape[0]}")
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        p50, p90 = np.percentile(walls, [50, 90])
        step_p50[canonical] = p50
        print(f"step 1M canonical={canonical}: p50 {p50:.3f} ms, p90 "
              f"{p90:.3f} ms (100 steps, host clock to synchronize), peak "
              f"memory {peak:.2f} GiB")
        layers, ops = device_ms_by_layer(
            lambda: step(scene_t, tree_cap, pair_cap, emit_cap, canonical))
        busy = sum(layers.values())
        print(f"profile 1M canonical={canonical}: device busy {busy:.3f} "
              f"ms/step of the {p50:.3f} ms p50 (idle share "
              f"{1 - busy / p50:.3f}), {ops:.0f} device operations per "
              "step; " + ", ".join(
                  f"{k} {v:.3f}" for k, v in
                  sorted(layers.items(), key=lambda kv: -kv[1])))

    # 6. the v2 scan at 1M: counted launches, oracle.  It has no emit-once
    # rule, so its pair buffer holds raw emissions before the dedup, and is
    # sized as the emission buffer (bench_caps: the wide-id regime's rule)
    reset_launches()
    _, res2 = layer.scan(SPEC, state, emit_cap, emit_capacity=emit_cap,
                         expand="v2")
    v2_launches = read_launches()
    check(all(v2_launches[k] > 0 for k in ("run_ends", "prep_runs",
                                           "expand_pairs")),
          f"1M v2 scan: kernel 2, 3 or 7 was not launched: {v2_launches}")
    got2 = layer.scan_result_to_numpy(res2)
    check(np.array_equal(got2, want),
          f"1M v2 scan: {got2.shape[0]} canonical pairs differ from the "
          f"oracle's {want.shape[0]}")
    # emission order keeps the duplicate emissions (no rule); as a set
    # they are the oracle's pairs
    _, ures2 = layer.scan(SPEC, state, emit_cap, emit_capacity=emit_cap,
                          canonical=False, expand="v2")
    check(not bool(ures2.overflow) and np.array_equal(
        np.unique(layer.scan_result_to_numpy(ures2), axis=0), want),
          "1M v2 scan canonical=False: the set of pairs differs from the "
          "oracle's")

    def v2_step():
        return step(scene_t, tree_cap, emit_cap, emit_cap, True, expand="v2")

    for _ in range(3):
        v2_step()
    v2_ms = host_ms(v2_step, 20)
    v2_p50 = np.percentile(v2_ms, 50)
    print(f"scan_v2 1M: {got2.shape[0]} canonical pairs equal the oracle, "
          f"and the set of its {int(ures2.count)} emission-order pairs; "
          f"overflow {bool(res2.overflow)}; launches {v2_launches}; step "
          f"(build + v2 scan) p50 {v2_p50:.3f} ms (20)")
    layers, ops = device_ms_by_layer(v2_step)
    busy = sum(layers.values())
    print(f"profile 1M v2 step: device busy {busy:.3f} ms/step of the "
          f"{v2_p50:.3f} ms p50 (idle share {1 - busy / v2_p50:.3f}), "
          f"{ops:.0f} device operations per step; " + ", ".join(
              f"{k} {v:.3f}" for k, v in
              sorted(layers.items(), key=lambda kv: -kv[1])))

    # 7. the update path at 1M, four churn fractions
    results, frame_launches, merge_args = update_sweep(
        scene_big, dev, tree_cap, pair_cap, emit_cap)
    errs["merge_cancel_compact"] = compare_merge(merge_args)
    cc = int(merge_args[4])
    timed["merge_cancel_compact"] = (
        merge_args, merge_cancel_compact_plain,
        16 * (tree_cap + cc) + 16 * tree_cap, None)
    print("update summary: " + json.dumps(
        {f"{k:.3f}": {m: round(v, 3) for m, v in r.items()}
         for k, r in results.items()}))

    # 8. every kernel timed at the main path's shapes
    launches = {"step": step_launches, "frame": frame_launches,
                "scan_v2": v2_launches}
    # ms: CUDA events around one wrapper call (allocations and the host's
    # enqueue included); device_ms: the profiler's device time of the
    # kernel's own launches, per call over 10 calls
    rows = []
    for name, (wrapper, src, rep, path, names) in KERNELS.items():
        args, plain, moved, library = timed[name]
        ms = cuda_ms(lambda: wrapper(*args))
        device_ms = kernel_device_ms(lambda: wrapper(*args), names)
        check(device_ms > 0, f"kernel {name}: the profiler shows no device "
              f"time under {names}")
        plain_ms = cuda_ms(lambda: plain(*args))
        library_ms = library_device_ms = None
        if library is not None:
            library_ms = cuda_ms(library)
            library_device_ms = kernel_device_ms(library)
        bound_ms, bound_by = bound(moved)
        lib = ("none" if library is None else f"{library_ms:.3f} ms (device "
               f"{library_device_ms:.3f} ms)")
        print(f"kernel {name}: exact at the 1M shapes; device {device_ms:.3f}"
              f" ms, call {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
              f"{bound_ms:.3f} ms ({moved / 1e6:.1f} MB), library {lib}; "
              f"{launches[path][name]} launches per {path}")
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": rep, "launches": launches[path][name],
                     "max_abs_err": errs[name], "ms": ms,
                     "device_ms": device_ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "library_ms": library_ms,
                     "library_device_ms": library_device_ms})
    # the v2 scan's kernel 3 and the JAX-shaped kernel 7, timed alike
    for name, (wrapper, args, plain, moved, names) in extra.items():
        device_ms = kernel_device_ms(lambda: wrapper(*args), names)
        bound_ms, _ = bound(moved)
        print(f"kernel {name}: exact at the 1M shapes; device {device_ms:.3f}"
              f" ms, call {cuda_ms(lambda: wrapper(*args)):.3f} ms, plain "
              f"{cuda_ms(lambda: plain(*args)):.3f} ms, bound {bound_ms:.3f} "
              f"ms ({moved / 1e6:.1f} MB)")

    # 9-16. the rest of the layer surface and the linear queries, each
    # path's launches counted from 0
    routes, surface, seconds = dict(launches), {}, {}

    def timed_phase(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t0
        return out

    routes["merge"], surface["merge"] = timed_phase(
        "merge", merge_phase, scene_big, dev, tree_cap, pair_cap, emit_cap,
        state, want)
    routes["extend"], surface["extend"] = timed_phase(
        "extend", extend_phase, scene_big, dev, state)
    routes["scan_filtered"], surface["scan_filtered"] = timed_phase(
        "scan_filtered", filtered_phase, state, pair_cap, emit_cap, want)
    routes["nested_ids"] = timed_phase("nested_ids", nested_phase, dev)
    routes["scan_auto"] = timed_phase("scan_auto", scan_auto_phase, dev)
    routes["br_scene"] = timed_phase(
        "br_scene", scene_phase, scene_big, dev, tree_cap, pair_cap,
        emit_cap, state, want)
    routes["queries"], surface["queries"] = timed_phase(
        "queries", query_phase, scene_big, dev, state)
    routes["ball_pit"], surface["ball_pit"] = timed_phase(
        "ball_pit", ball_pit_phase, dev)
    # 17-19. the tree engine, the batched queries and the traversals
    routes["tree_queries"], surface["tree_queries"] = timed_phase(
        "tree_queries", tree_query_phase, scene_big, dev, state)
    routes["batch_queries"], surface["batch_queries"] = timed_phase(
        "batch_queries", batch_query_phase, scene_big, dev, state)
    routes["traverse"], surface["traverse"] = timed_phase(
        "traverse", traverse_phase, scene_big, dev, state)
    # 20. the sharded surface: world 1 under NCCL, four ranks over gloo
    sharded_routes, surface["sharded"] = timed_phase(
        "sharded", sharded_phase, scene_big, dev, state, want, tree_cap)
    routes.update(sharded_routes)
    # 21-24. the tools and the demo: the ball pit in three modes, the CLI,
    # the step and update profilers, the profiling utilities
    demo_routes, surface["ball_pit_demo"] = timed_phase(
        "ball_pit_demo", demo_phase, dev)
    routes.update(demo_routes)
    routes["cli"], surface["cli"] = timed_phase("cli", cli_phase, dev)
    prof_routes, surface["profilers"] = timed_phase(
        "profilers", profiler_phase, dev, step_p50[True],
        {f: results[f]["update_p50"] for f in (0.01, 0.03)})
    routes.update(prof_routes)
    surface["profiling"] = timed_phase(
        "profiling", profiling_phase, dev, scene_t,
        (tree_cap, pair_cap, emit_cap))
    print("surface summary: " + json.dumps(
        {k: {m: round(v, 3) for m, v in r.items()}
         for k, r in surface.items()}) + "; seconds per phase " + json.dumps(
        {k: round(v, 1) for k, v in seconds.items()})
        + f"; {time.perf_counter() - t_start:.0f} s since the start")

    # the kernels line: "routes" has each kernel's launches in every path
    for row in rows:
        row["routes"] = {r: n[row["name"]] for r, n in routes.items()}
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"FAIL: {exc}", file=sys.stderr)
        sys.exit(1)
