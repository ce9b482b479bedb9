"""Benchmark of the port on one CUDA card: the counterpart of the
repository's ``bench.py`` (the JAX package's benchmark).

Run from the repository root on a machine with a CUDA card:

    python3 -m broadphase_tpu_torch.bench

It runs twelve configurations, each with a check, in this order:

1. the 30k gate: ``gen_boxes`` (ChaCha20, seed 0), ``layer.build`` +
   ``scan``, canonical pair for pair and ``canonical=False`` as a set
   against the C++ oracle (``oracle.scan_seq``);
2. the full step (``build`` + canonical ``scan``) at 10k and 1M on the
   bench scene, each held to the oracle;
3. the 1M step with ``canonical=False``, set-equal to 2;
4. the 1M step with ids offset by 2^25, which switches the emit-once rule
   off: the oracle's pairs with both ids offset;
5. one ``Index64_2D`` step at 1M, held to the CPU path on the same scene
   (tree and canonical pairs);
6. the reference's headline ball pit: 10k circles, ``Index32_2D``,
   ``min_depth`` 4, held to the CPU path;
7. a 500k static layer merged into a 500k dynamic one (k6), then
   ``scan_filtered`` with ``a % 2 == b % 2``: the oracle's 1M pairs so
   filtered;
8. the 1M ``update`` at 0.5 / 1 / 3 / 10% churn beside a fresh build, the
   state equal to a fresh build at each fraction (``layers_equal``);
9. ``test_box`` / ``test_ray`` / ``pick_ray`` at 100k on both engines, the
   tree engine equal to the linear one;
10. tree-engine single queries at 1M by chain differencing, the chains
    equal to the linear engine's;
11. batched queries, Q = 512 at 100k, rows equal to single queries on a
    sample;
12. the ball-pit demo's lifecycle soak (2,500 balls, 240 frames,
    ``--chunk 10``) in a subprocess.

Steps are timed as ``bench.py`` times them: batches of calls enqueued back
to back, each batch ended by one ``torch.cuda.synchronize()``, the p50 of
the per-batch means; beside it the blocking p50, a synchronize after every
call.  Chain differencing (10) is the wall time a query adds, host work
included.

Prints one JSON record on stdout (``bench.py``'s keys, plus ``device``:
the card's name and power limit, ``ball_pit_2d_10k_p50_ms`` and
``peak_memory_gib``: what one step of 2, 4 and 5 allocates above the
tensors live before it); human-readable lines go to stderr.  ``overflow`` is
the OR of every configuration's flag and ``verified`` the AND of every
check; the process exits 1 when a check failed or a buffer overflowed,
after the record.  Without a CUDA card it prints why and exits 2 with no
record.  Each configuration function takes a ``device``, so that it also
runs on the CPU (every kernel's plain version) at small sizes.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, Dict, Optional

import numpy as np
import torch

from . import bench_caps, gen, layer, oracle, profiling, query, update
from .index import Index32_2D, Index64_2D, Index64_3D
from .ops import _cuda
from .tools.profile_update import moving_scene

# ids from here up switch the emit-once rule off (layer._RULE_ID_BOUND)
WIDE_ID_OFFSET = 1 << 25
# the reference's step: 10,000 dynamic objects in ~6 ms (its README)
REFERENCE_OBJECTS_PER_MS = 10_000 / 6.0
UPDATE_FRACS = (0.005, 0.01, 0.03, 0.10)
# rows of the batched queries held to single queries (those below Q)
SAMPLE_ROWS = (0, 1, 255, 511)
# seconds the lifecycle soak's subprocess may take
LIFECYCLE_TIMEOUT_S = 1500.0


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _to(dev, *arrays):
    """numpy arrays as tensors on ``dev`` (ids as int64)."""
    return tuple(torch.as_tensor(
        x.astype(np.int64) if x.dtype == np.uint32 else x, device=dev)
        for x in arrays)


def _pipelined_p50(step: Callable, dev, iters: int = 30, warmup: int = 3,
                   batch: int = 10):
    """(p50 of the per-batch mean ms, blocking p50 ms) of ``step()``:
    ``iters // batch`` batches enqueued back to back, each ended by one
    synchronize; the blocking p50 over 5 calls, each ended by one.  None,
    None when ``iters`` is 0."""
    if iters == 0:
        return None, None
    lat = profiling.timed(step, iters=5, warmup=warmup, device=dev)
    batches = []
    for _ in range(max(1, iters // batch)):
        t0 = time.perf_counter()
        outs = [step() for _ in range(batch)]
        profiling._sync(dev)
        batches.append((time.perf_counter() - t0) / batch * 1e3)
        del outs
    return float(np.percentile(batches, 50)), lat["p50_ms"]


def _first_step(step: Callable, dev):
    """(``step()``, the peak GiB it allocated above what was live before
    it; None off the card)."""
    if torch.device(dev).type != "cuda":
        return step(), None
    out = []
    peak = profiling.peak_memory(lambda: out.append(step()), device=dev)
    return out[0], peak / 2 ** 30


def oracle_pairs(scene) -> np.ndarray:
    """The canonical pairs of an ``Index64_3D`` scene by the C++ oracle:
    extend, sort, the sequential sweep."""
    keys, ids, _ = oracle.extend(*scene)
    keys, ids = oracle.sort_tree(keys, ids)
    return oracle.scan_seq(
        keys, ids, pair_slack=max(4, 24_000_000 // max(len(ids), 1)))


def _same_step(spec, got, want) -> bool:
    """Two (state, scan result) of one step agree: tree (keys, ids, count),
    canonical pairs and both overflow flags."""
    (gs, gr), (ws, wr) = got, want
    gk, gi, gc = layer.tree_to_numpy(spec, gs)
    wk, wi, wc = layer.tree_to_numpy(spec, ws)
    return (gc == wc and np.array_equal(gk, wk) and np.array_equal(gi, wi)
            and bool(gs.overflow) == bool(ws.overflow)
            and bool(gr.overflow) == bool(wr.overflow)
            and np.array_equal(layer.scan_result_to_numpy(gr),
                               layer.scan_result_to_numpy(wr)))


def _row_sorted(pairs: np.ndarray) -> np.ndarray:
    return pairs[np.lexsort((pairs[:, 1], pairs[:, 0]))]


# ---------------------------------------------------------------------------
# Scenes and capacities (bench.py's, inline there)
# ---------------------------------------------------------------------------

def step_caps(n: int):
    """(tree, pair, emission) capacities of the full step."""
    return (bench_caps.tree_capacity(n), bench_caps.pair_capacity(n),
            bench_caps.emit_capacity(n))


def wide_scene(n: int):
    """The bench scene with every id offset by 2^25."""
    *rest, ids = bench_caps.bench_scene(3, n)
    return (*rest, (ids + WIDE_ID_OFFSET).astype(np.uint32))


def wide_caps(n: int):
    """(tree, pair) capacities of the wide-id step: the pair buffer holds
    the raw emissions (15.7 an object at 1M; small scenes have relatively
    larger boxes)."""
    return (bench_caps.tree_capacity(n),
            bench_caps.emit_capacity(n, 18 if n >= 500_000 else 40))


def index64_2d_caps(n: int):
    """(tree, pair, emission) capacities of the 2D step: 3n, 1n, 3n (about
    2.4 cells and 0.3 pairs an object at this density)."""
    return tuple(((k * n) // 1024) * 1024 for k in (3, 1, 3))


def ball_pit_scene(n: int):
    """(positions, radii, system_min, system_max, ids) of the headline ball
    pit: radii U(0.004, 0.01), positions U(0.05, 0.95)^2, seed 0."""
    rng = np.random.default_rng(0)
    radius = rng.uniform(0.004, 0.01, n).astype(np.float32)
    pos = rng.uniform(0.05, 0.95, (n, 2)).astype(np.float32)
    return (pos, radius, np.zeros(2, np.float32), np.ones(2, np.float32),
            np.arange(n, dtype=np.uint32))


def ball_pit_caps(n: int):
    """(pair, emission) capacities of the ball pit: 24n and 32n (176,365
    pairs at 10k, 17.6 a ball)."""
    return ((24 * n) // 1024) * 1024, ((32 * n) // 1024) * 1024


def merge_caps(n: int):
    """(static tree, dynamic tree, pair, emission) capacities of the merge
    + filtered scan: 4 a static object, 4n for the merge target, 10n,
    16n."""
    return (4 * (n // 2), 4 * n, ((10 * n) // 1024) * 1024,
            ((16 * n) // 1024) * 1024)


def same_parity(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The filtered scan's predicate."""
    return (a % 2) == (b % 2)


# ---------------------------------------------------------------------------
# 1-7: the step and its variants
# ---------------------------------------------------------------------------

def verify_30k(device, n: int = 30_000) -> dict:
    """The 30k gate: canonical pairs pair for pair, and ``canonical=False``
    as a set, against the oracle's sweep of the card's tree."""
    spec = Index64_3D
    sc = gen.gen_boxes(count=n, density=1.0 / 1000.0, seed=0)
    scene = (sc.system_min, sc.system_max, sc.bounds_min, sc.bounds_max,
             sc.ids)
    st = layer.build(spec, *_to(device, *scene), out_capacity=4 * n)
    st, res = layer.scan(spec, st, 10 * n, emit_capacity=16 * n)
    keys, ids, _ = layer.tree_to_numpy(spec, st)
    want = oracle.scan_seq(keys, ids, pair_slack=32)
    got = layer.scan_result_to_numpy(res)
    ok = not bool(res.overflow) and np.array_equal(got, want)
    _, ures = layer.scan(spec, st, 10 * n, emit_capacity=16 * n,
                         canonical=False)
    ugot = layer.scan_result_to_numpy(ures)
    uok = (not bool(ures.overflow) and ugot.shape == want.shape
           and np.array_equal(_row_sorted(ugot), want))
    _log(f"verify 30k: {got.shape[0]} canonical pairs vs the oracle's "
         f"{want.shape[0]}: {'OK' if ok else 'FAILED'}; canonical=False "
         f"set {'OK' if uok else 'FAILED'}")
    return {"overflow": bool(res.overflow) or bool(ures.overflow),
            "verified": ok and uok}


def bench_full_step(n: int, device, iters: int = 30, batch: int = 10,
                    want: Optional[np.ndarray] = None) -> dict:
    """``build`` + canonical ``scan`` of the bench scene at the bench's
    capacities, held to the oracle's pairs (``want``: computed here when
    None)."""
    spec = Index64_3D
    scene = bench_caps.bench_scene(3, n)
    tree_cap, pair_cap, emit_cap = step_caps(n)
    args = _to(device, *scene)

    def step():
        st = layer.build(spec, *args, out_capacity=tree_cap)
        return layer.scan(spec, st, pair_cap, emit_capacity=emit_cap)[1]

    res, peak = _first_step(step, device)
    got = layer.scan_result_to_numpy(res)
    if want is None:
        want = oracle_pairs(scene)
    ok = np.array_equal(got, want)
    p50, lat = _pipelined_p50(step, device, iters=iters, batch=batch)
    out = {"n": n, "p50_ms": p50, "blocking_p50_ms": lat,
           "pairs": got.shape[0], "overflow": bool(res.overflow),
           "verified": ok, "peak_memory_gib": peak}
    _log(f"full step n={n}: p50 {p50} ms (blocking {lat} ms), "
         f"{got.shape[0]} pairs, equal to the oracle's {want.shape[0]}: "
         f"{ok}; overflow {bool(res.overflow)}; peak memory "
         f"{out['peak_memory_gib']} GiB")
    return out


def bench_full_step_unsorted(n: int, device, iters: int = 30,
                             want: Optional[np.ndarray] = None) -> dict:
    """The step with ``canonical=False``: the unique pairs in emission
    order, set-equal to the canonical step's (``want``: its pairs, which
    :func:`bench_full_step` holds to the oracle; computed here when
    None)."""
    spec = Index64_3D
    scene = bench_caps.bench_scene(3, n)
    tree_cap, pair_cap, emit_cap = step_caps(n)
    args = _to(device, *scene)

    def step(canonical=False):
        st = layer.build(spec, *args, out_capacity=tree_cap)
        return layer.scan(spec, st, pair_cap, emit_capacity=emit_cap,
                          canonical=canonical)[1]

    res = step()
    if want is None:
        want = layer.scan_result_to_numpy(step(True))
    got = layer.scan_result_to_numpy(res)
    set_ok = (not bool(res.overflow) and got.shape == want.shape
              and np.array_equal(_row_sorted(got), want))
    p50, _ = _pipelined_p50(step, device, iters=iters)
    _log(f"full step canonical=False n={n}: p50 {p50} ms, {got.shape[0]} "
         f"pairs, set equal to the canonical step's: {set_ok}")
    return {"p50_ms": p50, "pairs": got.shape[0],
            "overflow": bool(res.overflow), "verified": set_ok}


def bench_full_step_wide(n: int, device, iters: int = 20,
                         want: Optional[np.ndarray] = None) -> dict:
    """The step with ids offset by 2^25: the emit-once rule is off, so the
    pair buffer holds every raw emission and the canonical sort dedups
    them.  Held to the oracle's pairs of the unshifted scene (``want``:
    computed here when None) with both ids offset."""
    spec = Index64_3D
    scene = wide_scene(n)
    tree_cap, pair_cap = wide_caps(n)
    args = _to(device, *scene)

    def step():
        st = layer.build(spec, *args, out_capacity=tree_cap)
        return layer.scan(spec, st, pair_cap)

    (st, res), peak = _first_step(step, device)
    if want is None:
        want = oracle_pairs(bench_caps.bench_scene(3, n))
    got = layer.scan_result_to_numpy(res)
    ok = np.array_equal(got, want + np.uint32(WIDE_ID_OFFSET))
    p50, _ = _pipelined_p50(lambda: step()[1], device, iters=iters, batch=8)
    out = {"p50_ms": p50, "pairs": got.shape[0],
           "overflow": bool(st.overflow) or bool(res.overflow),
           "verified": ok, "peak_memory_gib": peak, "result": (st, res)}
    _log(f"full step wide ids n={n} (ids >= 2^25, emit-once off): p50 {p50}"
         f" ms, {got.shape[0]} pairs, equal to the oracle's offset by 2^25:"
         f" {ok}; overflow {out['overflow']}; peak memory "
         f"{out['peak_memory_gib']} GiB")
    return out


def bench_index64_2d(n: int, device, iters: int = 20) -> dict:
    """One ``Index64_2D`` step of the 2D bench scene, held to the CPU path
    on the same scene: tree and canonical pairs."""
    spec = Index64_2D
    scene = bench_caps.bench_scene(2, n)
    tree_cap, pair_cap, emit_cap = index64_2d_caps(n)

    def make_step(dev):
        args = _to(dev, *scene)

        def step():
            st = layer.build(spec, *args, out_capacity=tree_cap)
            return layer.scan(spec, st, pair_cap, emit_capacity=emit_cap)
        return step

    step = make_step(device)
    got, peak = _first_step(step, device)
    ok = _same_step(spec, got, make_step("cpu")())
    p50, _ = _pipelined_p50(lambda: step()[1], device, iters=iters, batch=8)
    st, res = got
    out = {"p50_ms": p50, "pairs": int(res.count), "cells": int(st.count),
           "overflow": bool(st.overflow) or bool(res.overflow),
           "verified": ok, "peak_memory_gib": peak, "result": got}
    _log(f"Index64_2D full step n={n}: p50 {p50} ms, {out['cells']} cells, "
         f"{out['pairs']} pairs, tree and pairs equal to the CPU path's: "
         f"{ok}; overflow {out['overflow']}; peak memory "
         f"{out['peak_memory_gib']} GiB")
    return out


def bench_ball_pit_2d(n: int, device, iters: int = 90) -> dict:
    """The reference's headline configuration: ``Index32_2D`` circles,
    ``min_depth`` 4, ``build`` + ``scan`` on ``p +- r`` every frame, held to
    the CPU path."""
    spec = Index32_2D
    pos, radius, smin, smax, ids = ball_pit_scene(n)
    pair_cap, emit_cap = ball_pit_caps(n)

    def make_step(dev):
        p, r, lo, hi, i = _to(dev, pos, radius, smin, smax, ids)

        def step():
            st = layer.build(spec, lo, hi, p - r[:, None], p + r[:, None], i,
                             min_depth=4)
            return layer.scan(spec, st, pair_cap, emit_capacity=emit_cap)
        return step

    step = make_step(device)
    got = step()
    ok = _same_step(spec, got, make_step("cpu")())
    p50, _ = _pipelined_p50(lambda: step()[1], device, iters=iters,
                            batch=30)
    st, res = got
    out = {"p50_ms": p50, "pairs": int(res.count), "cells": int(st.count),
           "overflow": bool(st.overflow) or bool(res.overflow),
           "verified": ok, "result": got}
    _log(f"ball pit 2D n={n}: p50 {p50} ms, {out['cells']} cells, "
         f"{out['pairs']} pairs, equal to the CPU path's: {ok}; overflow "
         f"{out['overflow']}")
    return out


def bench_merge_scan_filtered(n: int, device, iters: int = 30,
                              want: Optional[np.ndarray] = None) -> dict:
    """A static layer of the first half of the bench scene, built once,
    merged into each step's dynamic layer of the second half (k6), then
    ``scan_filtered`` keeping pairs of equal id parity.  Only the dynamic
    build, the merge and the scan are timed.  Held to the oracle's pairs of
    the whole scene (``want``: computed here when None) so filtered."""
    spec = Index64_3D
    scene = bench_caps.bench_scene(3, n)
    smin, smax, bmin, bmax, ids = _to(device, *scene)
    half = n // 2
    static_cap, dyn_cap, pair_cap, emit_cap = merge_caps(n)
    static = layer.build(spec, smin, smax, bmin[:half], bmax[:half],
                         ids[:half], out_capacity=static_cap)
    dyn_args = (bmin[half:], bmax[half:], ids[half:])

    def step():
        dyn = layer.build(spec, smin, smax, *dyn_args, out_capacity=dyn_cap)
        merged = layer.merge(spec, dyn, static)
        return layer.scan_filtered(spec, merged, pair_cap, same_parity,
                                   emit_cap)

    merged, res = step()
    if want is None:
        want = oracle_pairs(scene)
    got = layer.scan_result_to_numpy(res)
    ok = np.array_equal(got, want[(want[:, 0] % 2) == (want[:, 1] % 2)])
    p50, _ = _pipelined_p50(lambda: step()[1], device, iters=iters, batch=4)
    out = {"p50_ms": p50, "pairs": got.shape[0],
           "overflow": bool(merged.overflow) or bool(res.overflow),
           "verified": ok, "result": (merged, res)}
    _log(f"merge static + scan_filtered n={n}: p50 {p50} ms, "
         f"{got.shape[0]} pairs, equal to the oracle's of equal parity: "
         f"{ok}; overflow {out['overflow']}")
    return out


# ---------------------------------------------------------------------------
# 8: the update
# ---------------------------------------------------------------------------

def bench_update_sweep(n: int, device, iters: int = 16) -> dict:
    """At each churn fraction, that share of the objects jumps across cells
    and every object drifts by 1e-4 (``tools.profile_update.moving_scene``,
    seed 3); ``update`` against a fresh ``build`` on the same bounds, the
    first update's state equal to the fresh build's.  Times alternate
    between the two bound sets, so every frame after the first has real
    churn, in batches of 8.  The break-even is the largest fraction at
    which the update beats the build (0.0 when it never does)."""
    spec = Index64_3D
    tree_cap = bench_caps.tree_capacity(n)
    batch = 8
    sweep, build_p50 = {}, None
    parity, ovf = True, False
    for frac in UPDATE_FRACS:
        churn_cap, obj_cap = bench_caps.update_caps(n, frac)
        smin, smax, bmin, bmax, ids, bmin2, bmax2 = _to(
            device, *moving_scene(n, frac))
        A, B = (bmin, bmax), (bmin2, bmax2)

        def build(bounds):
            return layer.build(spec, smin, smax, *bounds, ids,
                               out_capacity=tree_cap)

        def upd(tracked, bounds, c=churn_cap, o=obj_cap):
            return update.update(spec, tracked, smin, smax, *bounds, c,
                                 obj_cap=o)

        tracked = update.build_tracked(spec, smin, smax, *A, ids,
                                       out_capacity=tree_cap)
        t_b = upd(tracked, B)
        parity = parity and layer.layers_equal(spec, t_b.state, build(B))
        ovf = ovf or bool(t_b.state.overflow)
        if iters == 0:
            continue
        if build_p50 is None:
            build_p50, _ = _pipelined_p50(lambda: build(B), device,
                                          iters=iters, warmup=1,
                                          batch=batch)
        for w in range(3):
            tracked = upd(tracked, A if w % 2 else B)
        profiling._sync(device)
        times = []
        for _ in range(max(1, iters // batch)):
            t0 = time.perf_counter()
            for i in range(batch):
                tracked = upd(tracked, A if i % 2 else B)
            profiling._sync(device)
            times.append((time.perf_counter() - t0) / batch * 1e3)
        sweep[frac] = float(np.percentile(times, 50))
        ovf = ovf or bool(tracked.state.overflow)
    break_even = max((f for f, ms in sweep.items() if ms < build_p50),
                     default=0.0)
    _log(f"update n={n} sweep (p50 ms by churn fraction): {sweep}; fresh "
         f"build p50 {build_p50} ms; break-even {break_even}; each first "
         f"update equal to a fresh build: {parity}; overflow {ovf}")
    return {"sweep": sweep, "build_p50_ms": build_p50,
            "break_even_frac": break_even, "overflow": ovf,
            "verified": parity}


# ---------------------------------------------------------------------------
# 9-11: queries
# ---------------------------------------------------------------------------

# the tree engine's candidate and frontier buffers of the query benches,
# sized for their queries (overflow is checked)
SINGLE_CCAP, SINGLE_FCAP = 32768, 256
QUERY_KINDS = ("test_box", "test_ray", "pick_ray")


def _id_dist(ids, mask, *_):
    """The benches' narrow phase: an object's distance is its id."""
    return torch.where(mask, ids.to(torch.float32), float("inf"))


def _same_hits(a, b) -> bool:
    return (int(a.count) == int(b.count) and torch.equal(a.ids, b.ids)
            and bool(a.overflow) == bool(b.overflow))


def _same_pick(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


def bench_queries(n: int, device, iters: int = 30) -> dict:
    """``test_box`` / ``test_ray`` / ``pick_ray`` of one query each on the
    bench scene (a 50-wide box at the system corner, the system diagonal
    as a ray, each object's id as its distance) on both engines, blocking
    p50 ms each; the tree engine's answers equal the linear engine's.  The
    tree engine gets :data:`SINGLE_CCAP` candidates: at 100k the box's
    candidates overflow its default 4,096, and the answer loses a hit."""
    spec = Index64_3D
    smin, smax, bmin, bmax, ids = bench_caps.bench_scene(3, n)
    state = layer.build(spec, smin, smax, *_to(device, bmin, bmax, ids),
                        out_capacity=4 * n)
    qmin, qmax, ro, rd = _to(device, smin + 10.0, smin + 60.0, smin,
                             smax - smin)
    calls = {
        "test_box": lambda eng: query.test_box(
            spec, state, smin, smax, (qmin, qmax), 65536, engine=eng,
            candidate_cap=SINGLE_CCAP)[1],
        "test_ray": lambda eng: query.test_ray(
            spec, state, smin, smax, ro, rd, 0.0, np.inf, 65536,
            engine=eng, candidate_cap=SINGLE_CCAP)[1],
        "pick_ray": lambda eng: query.pick_ray(
            spec, state, smin, smax, ro, rd, np.float32(1e9), _id_dist,
            engine=eng, candidate_cap=SINGLE_CCAP)[1],
    }
    out, ok, ovf = {}, True, False
    for name, call in calls.items():
        tree, linear = call("tree"), call("linear")
        same = _same_pick if name == "pick_ray" else _same_hits
        ok = ok and same(tree, linear)
        ovf = ovf or bool(tree.overflow) or bool(linear.overflow)
        for eng in ("tree", "linear"):
            out[f"{name}[{eng}]"] = (profiling.timed(
                lambda: call(eng), iters=iters, warmup=1,
                device=device)["p50_ms"] if iters else None)
    _log(f"queries n={n} blocking p50 ms: {out}; tree engine equal to "
         f"linear: {ok}; overflow {ovf}")
    return {"p50_ms": out, "overflow": ovf, "verified": ok}


def single_query_chain(spec, state, scene, kind: str, k: int,
                       engine: str = "tree"):
    """k data-dependent queries of one kind: each query's box or ray origin
    moves by 1e-9 times the previous answer (count or picked id), so that
    each waits for the one before.  Interactive scale: a box of 5% of the
    extent, a pick ray of 20% of it.  Returns the answers (int32 device
    scalars) and the OR of the overflow flags."""
    smin, smax = scene[0], scene[1]
    dev = state.ids.device
    extent = float(smax[0] - smin[0])
    q0, q1, ro = _to(dev, (smin + 0.25 * extent).astype(np.float32),
                     (smin + 0.30 * extent).astype(np.float32),
                     (smin + 0.40 * extent).astype(np.float32))
    rd = torch.ones(spec.dim, dtype=torch.float32, device=dev)
    rmax = np.float32(0.20 * extent)
    kw = {"engine": engine, "candidate_cap": SINGLE_CCAP}
    c = torch.zeros((), dtype=torch.int32, device=dev)
    ovf = torch.zeros((), dtype=torch.bool, device=dev)
    answers = []
    for _ in range(k):
        eps = c.to(torch.float32) * 1e-9
        if kind == "test_box":
            res = query.test_box(spec, state, smin, smax, (q0 + eps, q1 + eps),
                                 8192, **kw)[1]
            c = res.count
        elif kind == "test_ray":
            res = query.test_ray(spec, state, smin, smax, ro + eps, rd, 0.0,
                                 rmax, 8192, frontier_cap=SINGLE_FCAP,
                                 **kw)[1]
            c = res.count
        else:
            res = query.pick_ray(spec, state, smin, smax, ro + eps, rd,
                                 rmax, _id_dist, frontier_cap=SINGLE_FCAP,
                                 **kw)[1]
            c = res.obj_id
        c = c.to(torch.int32)
        ovf = ovf | res.overflow
        answers.append(c)
    return answers, ovf


def bench_single_query_tree(n: int, device, iters: int = 12) -> dict:
    """Tree-engine single queries at n objects by chain differencing: the
    p50 of k = 5 and k = 1 chains, each to a forced scalar readback,
    (p50_5 - p50_1) / 4 a query.  On the card this is the wall time one
    query adds, host work included.  The k = 5 chains' answers equal the
    linear engine's, and no buffer overflows."""
    spec = Index64_3D
    scene = bench_caps.bench_scene(3, n)
    smin, smax, bmin, bmax, ids = scene
    state = layer.build(spec, smin, smax, *_to(device, bmin, bmax, ids),
                        out_capacity=bench_caps.tree_capacity(n))
    out, ok, ovf = {}, True, False
    for kind in QUERY_KINDS:
        p50 = {}
        for k in (1, 5):
            answers, o = single_query_chain(spec, state, scene, kind, k)
            ovf = ovf or bool(o)
            if k == 5:
                lin, lo = single_query_chain(spec, state, scene, kind, k,
                                             "linear")
                ok = ok and [int(a) for a in answers] == [int(a) for a in lin]
                ovf = ovf or bool(lo)
            if iters:
                p50[k] = profiling.timed(
                    lambda: int(single_query_chain(spec, state, scene, kind,
                                                   k)[0][-1]),
                    iters=iters, warmup=1, device=device)["p50_ms"]
        out[kind] = (p50[5] - p50[1]) / 4.0 if iters else None
    _log(f"single queries n={n}, tree engine, ms a query (chain "
         f"differencing, wall time): {out}; chains equal to the linear "
         f"engine's: {ok}; overflow {ovf}")
    return {"ms": out, "overflow": ovf, "verified": ok}


def bench_queries_batched(n: int, device, Q: int = 512, iters: int = 30
                          ) -> dict:
    """Q queries a call (``test_box_batch`` / ``test_ray_batch`` /
    ``pick_ray_batch``, seed 1: 50-wide boxes, rays from anywhere in the
    system in any direction), microseconds a query at the pipelined p50;
    the rows :data:`SAMPLE_ROWS` (those below Q) equal the single
    queries' (the linear engine)."""
    spec = Index64_3D
    smin, smax, bmin, bmax, ids = bench_caps.bench_scene(3, n)
    state = layer.build(spec, smin, smax, *_to(device, bmin, bmax, ids),
                        out_capacity=4 * n)
    rng = np.random.default_rng(1)
    qmin, ro, rd = _to(device,
                       rng.uniform(0, smax[0] * 0.8, (Q, 3)).astype(
                           np.float32),
                       rng.uniform(0, smax[0], (Q, 3)).astype(np.float32),
                       rng.uniform(-1, 1, (Q, 3)).astype(np.float32))
    qmax = qmin + 50.0
    calls = {
        "test_box": lambda: query.test_box_batch(
            spec, state, smin, smax, (qmin, qmax), 4096)[1],
        "test_ray": lambda: query.test_ray_batch(
            spec, state, smin, smax, ro, rd, 0.0, np.inf, 4096)[1],
        "pick_ray": lambda: query.pick_ray_batch(
            spec, state, smin, smax, ro, rd, np.float32(1e9), _id_dist)[1],
    }
    rows = {name: call() for name, call in calls.items()}
    ok = True
    ovf = any(bool(r.overflow.any()) for r in rows.values())
    for i in (i for i in SAMPLE_ROWS if i < Q):
        single = {
            "test_box": query.test_box(spec, state, smin, smax,
                                       (qmin[i], qmax[i]), 4096,
                                       engine="linear")[1],
            "test_ray": query.test_ray(spec, state, smin, smax, ro[i], rd[i],
                                       0.0, np.inf, 4096,
                                       engine="linear")[1],
            "pick_ray": query.pick_ray(spec, state, smin, smax, ro[i], rd[i],
                                       np.float32(1e9), _id_dist,
                                       engine="linear")[1]}
        for name, want in single.items():
            got = type(want)(*(f[i] for f in rows[name]))
            same = _same_pick if name == "pick_ray" else _same_hits
            ok = ok and same(got, want)
    out = {}
    for name, call in calls.items():
        p50, _ = _pipelined_p50(call, device, iters=iters, batch=5)
        out[name] = p50 * 1e3 / Q if iters else None
    _log(f"batched queries n={n} Q={Q}, us a query: {out}; sampled rows "
         f"equal to single queries: {ok}; overflow {ovf}")
    return {"us": out, "overflow": ovf, "verified": ok}


# ---------------------------------------------------------------------------
# 12: the demo's lifecycle soak
# ---------------------------------------------------------------------------

def parse_ball_pit_summary(stdout: str):
    """(ms a frame, total collisions) from the demo's summary line
    ``"<frames> frames, <n> ball slots, <ms> ms/frame, total collisions
    <count>"``; (None, None) when there is none."""
    for line in reversed(stdout.splitlines()):
        if "ms/frame" in line and "total collisions" in line:
            try:
                return (float(line.split("ms/frame")[0].split(",")[-1]),
                        int(line.rsplit("total collisions", 1)[1]))
            except ValueError:
                break
    return None, None


def bench_ball_pit_lifecycle(n: int, device, frames: int = 240) -> dict:
    """The demo's lifecycle soak, ``python -m
    broadphase_tpu_torch.examples.ball_pit --lifecycle --chunk 10`` in a
    subprocess on ``device``: its ms a frame; verified when it exits 0
    and prints its summary."""
    root = Path(__file__).resolve().parent.parent
    cmd = [sys.executable, "-u", "-m", "broadphase_tpu_torch.examples."
           "ball_pit", "--balls", str(n), "--frames", str(frames),
           "--lifecycle", "--chunk", "10", "--device", str(device)]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True,
                           timeout=LIFECYCLE_TIMEOUT_S, cwd=root)
    except subprocess.TimeoutExpired:
        _log(f"ball pit --lifecycle: no result within {LIFECYCLE_TIMEOUT_S}"
             " s")
        return {"ms_frame": None, "collisions": None, "verified": False}
    ms, cols = parse_ball_pit_summary(r.stdout) if r.returncode == 0 \
        else (None, None)
    if r.returncode != 0:
        _log(f"ball pit --lifecycle failed (exit {r.returncode}): "
             f"{r.stderr[-800:]}")
    _log(f"ball pit --lifecycle n={n}, {frames} frames: {ms} ms a frame, "
         f"{cols} collisions")
    return {"ms_frame": ms, "collisions": cols,
            "verified": ms is not None}


# ---------------------------------------------------------------------------
# The record
# ---------------------------------------------------------------------------

def record(r: Dict[str, dict], device: str) -> dict:
    """The JSON record of a run's results (``r``: each configuration's
    dict, keyed as :func:`main` keys them): ``bench.py``'s keys, plus
    ``device``, ``ball_pit_2d_10k_p50_ms`` and ``peak_memory_gib``."""
    big, upd = r["full_step_1M"], r["update_sweep_1M"]
    p50 = big["p50_ms"]
    sweep = upd["sweep"]
    return {
        "metric": "full_step_1M_p50_ms",
        "value": p50,
        "unit": "ms",
        "vs_baseline": (None if p50 is None else
                        big["n"] / p50 / REFERENCE_OBJECTS_PER_MS),
        "blocking_p50_ms": big["blocking_p50_ms"],
        "overflow": any(bool(x.get("overflow", False)) for x in r.values()),
        "verified": all(bool(x["verified"]) for x in r.values()),
        "full_step_1M_unsorted_p50_ms": r["unsorted_1M"]["p50_ms"],
        "unsorted_set_verified": bool(r["unsorted_1M"]["verified"]),
        "single_query_1M_ms": r["single_query_1M"]["ms"],
        "single_query_overflow": bool(r["single_query_1M"]["overflow"]),
        "update_1M_p50_ms": sweep.get(0.03, min(sweep.values(),
                                                default=None)),
        "build_1M_p50_ms": upd["build_p50_ms"],
        "update_1M_sweep_ms": {f"{k:.3f}": v for k, v in sweep.items()},
        "update_break_even_frac": upd["break_even_frac"],
        "full_step_1M_wide_p50_ms": r["wide_1M"]["p50_ms"],
        "merge_scan_filtered_1M_p50_ms":
            r["merge_scan_filtered_1M"]["p50_ms"],
        "index64_2d_1M_p50_ms": r["index64_2d_1M"]["p50_ms"],
        "ball_pit_lifecycle_ms_frame": r["ball_pit_lifecycle"]["ms_frame"],
        "device": device,
        "ball_pit_2d_10k_p50_ms": r["ball_pit_2d_10k"]["p50_ms"],
        "peak_memory_gib": {
            "full_step_1M": big["peak_memory_gib"],
            "full_step_1M_wide": r["wide_1M"]["peak_memory_gib"],
            "index64_2d_1M": r["index64_2d_1M"]["peak_memory_gib"]},
    }


def card() -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def main() -> int:
    if not torch.cuda.is_available():
        print("bench: torch.cuda.is_available() is False; the benchmark "
              "runs only on a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    device = card()
    t0 = time.perf_counter()
    _cuda.load()
    _log(f"card: {device}; torch {torch.__version__}, CUDA "
         f"{torch.version.cuda}; kernels built in "
         f"{time.perf_counter() - t0:.1f} s")
    n = 1_000_000
    t0 = time.perf_counter()
    want = oracle_pairs(bench_caps.bench_scene(3, n))
    _log(f"oracle 1M: {want.shape[0]} pairs in "
         f"{time.perf_counter() - t0:.1f} s")
    r = {"verify_30k": verify_30k(dev),
         # small steps in larger batches, as bench.py times them
         "full_step_10k": bench_full_step(10_000, dev, iters=90, batch=30),
         "full_step_1M": bench_full_step(n, dev, want=want)}
    r["unsorted_1M"] = bench_full_step_unsorted(n, dev, want=want)
    r["wide_1M"] = bench_full_step_wide(n, dev, want=want)
    r["index64_2d_1M"] = bench_index64_2d(n, dev)
    r["ball_pit_2d_10k"] = bench_ball_pit_2d(10_000, dev)
    r["merge_scan_filtered_1M"] = bench_merge_scan_filtered(n, dev,
                                                            want=want)
    for key in ("wide_1M", "index64_2d_1M", "ball_pit_2d_10k",
                "merge_scan_filtered_1M"):
        r[key].pop("result")
    r["update_sweep_1M"] = bench_update_sweep(n, dev)
    r["queries_100k"] = bench_queries(100_000, dev)
    r["single_query_1M"] = bench_single_query_tree(n, dev)
    r["queries_batched_100k"] = bench_queries_batched(100_000, dev)
    # the reference's lifecycle caps the population at 2,500 balls
    r["ball_pit_lifecycle"] = bench_ball_pit_lifecycle(2_500, dev)
    rec = record(r, device)
    print(json.dumps(rec))
    return 0 if rec["verified"] and not rec["overflow"] else 1


if __name__ == "__main__":
    sys.exit(main())
