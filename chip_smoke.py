"""On-card smoke test of broadphase_tpu_torch: builds the five CUDA kernels,
holds each against its plain PyTorch version, and drives the build + scan
step at 30k and 1M boxes against the C++ oracle.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Every phase prints one line.  Any failure exits non-zero before the last
line; on success the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}``.
Without CUDA the script exits non-zero and prints no result.
"""

from __future__ import annotations

import hashlib
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from broadphase_tpu_torch import (Index32_2D, Index64_2D, Index64_3D,
                                  _jaxfree, geom, layer)
from broadphase_tpu_torch.index import depth_of
from broadphase_tpu_torch.ops import _cuda, search
from broadphase_tpu_torch.ops.build import emit_build, emit_build_plain
from broadphase_tpu_torch.ops.compact import (stream_compact,
                                              stream_compact_plain)
from broadphase_tpu_torch.ops.expand2 import (expand_pairs_prepped,
                                              expand_pairs_prepped_plain)
from broadphase_tpu_torch.ops.prep import prep_runs, prep_runs_plain
from broadphase_tpu_torch.ops.runends import run_ends, run_ends_plain

SPEC = Index64_3D
KERNELS = {
    # name: (wrapper, source, TPU kernel it replaces)
    "emit_build": (emit_build, "broadphase_tpu_torch/csrc/build.cu",
                   "broadphase_tpu/ops/pallas_build.py:290"),
    "run_ends": (run_ends, "broadphase_tpu_torch/csrc/runends.cu",
                 "broadphase_tpu/ops/pallas_runends.py:103"),
    "prep_runs": (prep_runs, "broadphase_tpu_torch/csrc/prep.cu",
                  "broadphase_tpu/ops/pallas_prep.py:173"),
    "expand_pairs_prepped": (expand_pairs_prepped,
                             "broadphase_tpu_torch/csrc/expand2.cu",
                             "broadphase_tpu/ops/pallas_expand2.py:307"),
    "stream_compact": (stream_compact, "broadphase_tpu_torch/csrc/compact.cu",
                       "broadphase_tpu/ops/pallas_compact.py:200"),
}


# device kernels by layer, matched on the kernel's name; the rest of the
# device time is torch's elementwise and indexing glue
LAYER_OF_KERNEL = (("build_kernel", "k1 build"), ("tile_first", "k2 run ends"),
                   ("carry_kernel", "k2 run ends"),
                   ("run_ends_kernel", "k2 run ends"),
                   ("prep_scatter", "k3 prep"), ("expand_kernel", "k4 expand"),
                   ("compact_scatter", "k5 compact"),
                   ("tile_sums", "k3/k5 scan phases"),
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


def device_ms_by_layer(run, reps: int = 5) -> dict:
    """Device time per call of run() by layer (torch.profiler), in ms."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
    by_layer = {}
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        name = next((lab for key, lab in LAYER_OF_KERNEL if key in evt.key),
                    "torch glue")
        by_layer[name] = (by_layer.get(name, 0.0)
                          + evt.self_device_time_total / reps / 1e3)
    return by_layer


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


def scan_inputs(state):
    keys, ids, aux, count = state.keys, state.ids, state.aux, state.count
    dep = depth_of(SPEC, keys)
    lca = search.adjacent_lca_depth(SPEC, keys)
    bmeta = ((dep << SPEC.dim) | (aux & 7)) & 0xFF
    ameta = layer._alpha_meta(SPEC, keys, dep, aux)
    lane = torch.arange(ids.shape[0], device=ids.device)
    rule = torch.where(lane < count, ids, 0).max() < layer._RULE_ID_BOUND
    return dep, lca, bmeta, ameta, rule


def compare_build(inputs, out_cap):
    lmin, lmax, contained, ids = inputs
    got = emit_build(SPEC, lmin, lmax, contained, ids, 0, out_cap)
    want = emit_build_plain(SPEC, lmin, lmax, contained, ids, 0, out_cap)
    err = max_abs_err(got[3:], want[3:])
    if int(want[3]) <= out_cap:   # the kept subset is arbitrary on overflow
        err = max(err, max_abs_err(layer._sort_tree(SPEC, *got[:3]),
                                   layer._sort_tree(SPEC, *want[:3])))
    return err


def compare_all(state, inputs, emit_cap):
    """Every kernel against its plain version on one step's inputs.
    Returns ({name: max_abs_err}, {name: (args, plain function)})."""
    errs, timed = {}, {}
    errs["emit_build"] = compare_build(inputs, state.keys.shape[0])
    timed["emit_build"] = (
        (SPEC, *inputs, 0, state.keys.shape[0]),
        emit_build_plain)

    dep, lca, bmeta, ameta, rule = scan_inputs(state)
    e = run_ends(lca, dep, SPEC.axis_bits + 1)
    errs["run_ends"] = max_abs_err(
        [e], [run_ends_plain(lca, dep, SPEC.axis_bits + 1)])
    timed["run_ends"] = ((lca, dep, SPEC.axis_bits + 1), run_ends_plain)

    prepped = prep_runs(e, state.ids, bmeta, state.count)
    errs["prep_runs"] = max_abs_err(
        prepped, prep_runs_plain(e, state.ids, bmeta, state.count))
    timed["prep_runs"] = ((e, state.ids, bmeta, state.count),
                          prep_runs_plain)

    sv, ab, bid, bm, m, total, _ = prepped
    xargs = (state.ids, ameta, sv, ab, bid, bm, m, total, emit_cap, rule,
             SPEC.dim)
    a, b = expand_pairs_prepped(*xargs)
    errs["expand_pairs_prepped"] = max_abs_err(
        (a, b), expand_pairs_prepped_plain(*xargs))
    timed["expand_pairs_prepped"] = (xargs, expand_pairs_prepped_plain)

    valid = a != b
    got, cnt = stream_compact(valid, (a, b))
    want, want_cnt = stream_compact_plain(valid, (a, b))
    errs["stream_compact"] = max_abs_err(got + (cnt,), want + (want_cnt,))
    timed["stream_compact"] = ((valid, (a, b)), stream_compact_plain)
    return errs, timed


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
    base = _jaxfree.bench_scene(3, 3000, seed=1)
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
            n_cases += 4
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


def oracle(native, scene):
    smin, smax, bmin, bmax, ids = scene
    keys, oids, _ = native.extend(smin, smax, bmin, bmax, ids)
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


def step(scene_t, tree_cap, pair_cap, emit_cap, canonical, spec=SPEC):
    state = layer.build(spec, *scene_t, out_capacity=tree_cap)
    return layer.scan(spec, state, pair_cap, emit_capacity=emit_cap,
                      canonical=canonical)


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


def main() -> int:
    # 1. device
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
    print(f"build: 5 kernels from broadphase_tpu_torch/csrc in "
          f"{time.perf_counter() - t0:.1f} s -> {_cuda.library_path().name}")

    native = _jaxfree.native()
    caps = _jaxfree.bench_caps()
    n_big = 1_000_000
    scene_big = _jaxfree.bench_scene(3, n_big)
    tree_cap = caps.tree_capacity(n_big)
    pair_cap = caps.pair_capacity(n_big)
    emit_cap = caps.emit_capacity(n_big)

    # 3. kernels against their plain versions: the 1M step's own
    # intermediates, timed, and the adversarial cases
    inputs = build_inputs(scene_big, dev)
    state_big = layer.build(SPEC, *scene_big, out_capacity=tree_cap,
                            device=dev)
    errs, timed = compare_all(state_big, inputs, emit_cap)
    times = {}
    for name, (args, plain) in timed.items():
        wrapper = KERNELS[name][0]
        times[name] = (cuda_ms(lambda: wrapper(*args)),
                       cuda_ms(lambda: plain(*args)))
        print(f"kernel {name}: exact match at the 1M step's shapes; "
              f"kernel {times[name][0]:.3f} ms, plain "
              f"{times[name][1]:.3f} ms (median of 10)")
    n_cases = adversarial(dev)
    print(f"adversarial: {n_cases} kernel cases exact (empty, one element, "
          f"ragged sizes, depth-0 and shallow boxes, outside boxes, "
          f"undersized tree, total > emit_cap, ids either side of 2^24-1)")

    # 4. slice at 30k against the C++ oracle, plus a depth-0 object
    n_small = 30_000
    scene_small = _jaxfree.bench_scene(3, n_small)
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
    scene_2d = with_box(_jaxfree.bench_scene(2, n_small), 0.0, 1.0, 1, 6)
    for spec in (Index64_2D, Index32_2D):
        pairs = check_against_cpu(spec, scene_2d, dev, (
            4 * n_small, 16 * n_small, 32 * n_small))
        print(f"slice {spec.name} 30k+depth0: tree and {pairs} canonical "
              "pairs, and the emission-order pairs, equal the CPU path's")

    # 5. slice at 1M: the main path, counted launches, oracle, step times
    for wrapper, _, _ in KERNELS.values():
        wrapper.launches = 0
    scene_t = to_device(scene_big, dev)
    state, res = step(scene_t, tree_cap, pair_cap, emit_cap, True)
    torch.cuda.synchronize()
    launches = {name: w.launches for name, (w, _, _) in KERNELS.items()}
    check(all(v > 0 for v in launches.values()),
          f"1M: a kernel of the path was not launched: {launches}")
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
          f"canonical pairs equal the oracle; launches {launches}; scene "
          f"sha1 {scene_digest(scene_big)} (numpy {np.__version__})")

    for canonical in (True, False):
        for _ in range(3):
            step(scene_t, tree_cap, pair_cap, emit_cap, canonical)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        walls = []
        for _ in range(100):
            t0 = time.perf_counter()
            _, r = step(scene_t, tree_cap, pair_cap, emit_cap, canonical)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        check(not bool(r.overflow) and int(r.count) == want.shape[0],
              f"1M canonical={canonical}: count {int(r.count)} != "
              f"{want.shape[0]}")
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        p50, p90 = np.percentile(walls, [50, 90])
        print(f"step 1M canonical={canonical}: p50 {p50:.3f} ms, p90 "
              f"{p90:.3f} ms (100 steps, host clock to synchronize), peak "
              f"memory {peak:.2f} GiB")
        layers = device_ms_by_layer(
            lambda: step(scene_t, tree_cap, pair_cap, emit_cap, canonical))
        busy = sum(layers.values())
        print(f"profile 1M canonical={canonical}: device busy {busy:.3f} "
              f"ms/step of the {p50:.3f} ms p50 (idle share "
              f"{1 - busy / p50:.3f}); " + ", ".join(
                  f"{k} {v:.3f}" for k, v in
                  sorted(layers.items(), key=lambda kv: -kv[1])))

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": errs[name],
         "ms": times[name][0], "plain_ms": times[name][1]}
        for name, (_, src, rep) in KERNELS.items()]}))
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
