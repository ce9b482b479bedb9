"""Headless 2D ball-pit demo on torch tensors: the reference example app.

The counterpart of ``examples/ball_pit.py`` of the JAX package, which
ports the reference's specs-ECS ball pit (``examples/main.rs``): Verlet
integration with gravity and a speed cap (``:334-361``), a broadphase
``Layer<Index32_2D>`` at ``min_depth`` 4 (``:364-374``), the circle
narrow phase over the scan's candidates (``:458-479``), a ``pick_ray``
every frame with an exact ray-circle narrow phase (``:423-456``),
positional correction (``:508-511``) and wall clamping (``:513-531``).
``--brute-force`` is the reference's O(n^2) soak mode (``:485-505``), and
``--lifecycle`` its population system (``:281-332``): balls past their
lifetime expire, and up to :data:`SPAWNS_PER_FRAME` new ones spawn at
the top, in the first dead slots by index.

One frame is :func:`frame`, a function of tensors on one device: the
physics state stays there, and the counters come back as device scalars
that the loop reads only on its print frames.  The broadphase is the
port's ``layer.build`` -> ``query.pick_ray`` -> ``layer.scan`` (kernels
k1-k5 on the card).  Random numbers cannot follow ``jax.random``'s
streams, so the lifecycle takes its three uniform draws (radius exponent,
x, lifetime) as an input (:func:`lifecycle_draws` makes them from a
``torch.Generator`` on the device).

Differences from the JAX demo that a comparison must allow for: the
positional correction is a scatter-add (``index_add_``), atomic on the
card, so positions agree to the last bits only up to the order of
summation; ``sin``, ``cos`` and ``exp`` may round the last bit otherwise
than XLA's, which moves the pick's distance and a spawned ball's radius
by an ulp.

Usage:
    python -m broadphase_tpu_torch.examples.ball_pit [--balls 2500]
        [--frames 300] [--brute-force] [--lifecycle] [--png-every 0]
        [--seed 0] [--chunk 1] [--device cuda]
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import layer, query
from ..index import Index32_2D
from ..layer import PAD_ID

SPEC = Index32_2D
WORLD = 1.0                         # the [0, 1]^2 box
GRAVITY = np.float32(-0.5)
DT = np.float32(1.0 / 100.0)        # reference: 100 Hz fixed step (main.rs:130)
MAX_SPEED = np.float32(1.0)         # speed cap (main.rs:352-358)
MIN_DEPTH = 4                       # reference layer config (main.rs:372)
RAY_ORIGIN = (0.5, 1.0)             # the pick ray sweeps from the top center

# Lifecycle constants (main.rs:303-306); lifetimes in seconds of sim time
LIFETIME_MIN = 10.0
LIFETIME_MAX = 50.0
SPAWNS_PER_FRAME = max(1, int(2500 * float(DT) * 1000.0 // (LIFETIME_MIN
                                                            * 1000.0)))


class Sim(NamedTuple):
    """A demo's configuration and its constants on its device (f32
    scalars, so that every operation rounds in f32 as the JAX demo's)."""

    n: int
    pair_cap: int
    brute_force: bool
    lifecycle: bool
    device: torch.device
    ids: torch.Tensor           # (n,) int64 object ids 0..n-1
    smin: torch.Tensor          # (2,) f32 system box
    smax: torch.Tensor
    origin: torch.Tensor        # (2,) f32 pick ray origin
    c: dict                     # name -> () f32 constant
    draw_lo: torch.Tensor       # (3, 1) f32 lower ends of the draws
    draw_span: torch.Tensor     # (3, 1) f32 their widths
    pair_i: Optional[torch.Tensor]  # brute force: (n*n,) first index
    pair_j: Optional[torch.Tensor]  #              (n*n,) second index


class State(NamedTuple):
    """The physics state, all on the device."""

    pos: torch.Tensor           # (n, 2) f32
    prev: torch.Tensor          # (n, 2) f32 last frame's positions
    radius: torch.Tensor        # (n,) f32
    expires: torch.Tensor       # (n,) f32 sim time of death (inf: never)
    t: torch.Tensor             # () f32 sim clock


class Contacts(NamedTuple):
    """A frame's candidate pairs and pick (:func:`contacts`)."""

    i: torch.Tensor             # (P,) int64 first ball of each lane
    j: torch.Tensor             # (P,) int64 second ball
    valid: torch.Tensor         # (P,) bool lanes that hold a candidate
    pick: query.PickResult      # the sweeping ray's nearest ball
    overflow: torch.Tensor      # () bool the scan's pair buffer overflowed
    tree: Optional[layer.LayerState]  # the scanned layer; None: brute force


class FrameResult(NamedTuple):
    state: State                # the next frame's state
    ncol: torch.Tensor          # () int64 colliding pairs this frame
    nalive: torch.Tensor        # () int64 balls alive this frame
    pick: query.PickResult      # the sweeping ray's nearest ball
    pairs: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]  # (i, j, valid)
    overflow: torch.Tensor      # () bool the scan's pair buffer overflowed
    tree: Optional[layer.LayerState]  # the scanned layer; None: brute force


def pair_capacity(n: int) -> int:
    """The demo's pair buffer: 32 a ball, a multiple of 1024 (the JAX
    demo's, so that overflow flags agree)."""
    return -(-32 * n // 1024) * 1024


def make_sim(n: int, brute_force: bool = False, lifecycle: bool = False,
             device=None) -> Sim:
    """A demo of n ball slots on ``device`` (default: the CUDA card; raises
    where there is none)."""
    dev = layer.resolve_device(device)

    def f32(x):
        return torch.tensor(np.float32(x), device=dev)

    consts = {"dt": DT, "g_dt": GRAVITY * DT, "max_speed": MAX_SPEED,
              "zero": 0.0, "half": 0.5, "one": 1.0, "two": 2.0,
              "three": 3.0, "eps": 1e-6, "800": 800.0, "-1.9": -1.9,
              "1.4": 1.4, "120": 120.0, "0.4": 0.4}
    pair_i = pair_j = None
    if brute_force:
        lane = torch.arange(n * n, dtype=torch.int64, device=dev)
        pair_i, pair_j = lane // n, lane % n
    return Sim(
        n=n, pair_cap=pair_capacity(n), brute_force=brute_force,
        lifecycle=lifecycle, device=dev,
        ids=torch.arange(n, dtype=torch.int64, device=dev),
        smin=torch.zeros(2, dtype=torch.float32, device=dev),
        smax=torch.full((2,), WORLD, dtype=torch.float32, device=dev),
        origin=torch.tensor(np.array(RAY_ORIGIN, np.float32), device=dev),
        c={k: f32(v) for k, v in consts.items()},
        draw_lo=torch.tensor(np.array([[0.5], [0.0], [LIFETIME_MIN]],
                                      np.float32), device=dev),
        draw_span=torch.tensor(np.array(
            [[1.5], [1.0], [LIFETIME_MAX - LIFETIME_MIN]], np.float32),
            device=dev),
        pair_i=pair_i, pair_j=pair_j)


def initial_state(sim: Sim, seed: int = 0) -> State:
    """The JAX demo's start: radii U(0.004, 0.01), positions U(0.05,
    0.95)^2, a small random velocity (numpy, seed); with the lifecycle
    every slot starts dead (the population ramps from empty)."""
    n = sim.n
    rng = np.random.default_rng(seed)
    radius = rng.uniform(0.004, 0.01, n).astype(np.float32)
    pos = rng.uniform(0.05, 0.95, (n, 2)).astype(np.float32)
    prev = pos - rng.normal(0, 0.001, (n, 2)).astype(np.float32)
    expires = (np.zeros(n, np.float32) if sim.lifecycle
               else np.full(n, np.inf, np.float32))
    dev = sim.device
    return State(*(torch.as_tensor(x, device=dev)
                   for x in (pos, prev, radius, expires)),
                 t=torch.zeros((), dtype=torch.float32, device=dev))


def lifecycle_draws(sim: Sim, gen: torch.Generator) -> torch.Tensor:
    """(3, SPAWNS_PER_FRAME) f32 draws of one frame: U(0.5, 2) (the radius
    exponent), U(0, 1) (x) and U(LIFETIME_MIN, LIFETIME_MAX), scaled as
    ``jax.random.uniform`` scales them: ``max(lo, u * (hi - lo) + lo)``."""
    u = torch.rand((3, SPAWNS_PER_FRAME), generator=gen, device=sim.device)
    return torch.maximum(sim.draw_lo, u * sim.draw_span + sim.draw_lo)


def ray_direction(t: torch.Tensor, sim: Sim) -> torch.Tensor:
    """The sweeping pick ray's direction at sim time t, on the device:
    its angle goes from -1.9 by 1.4 rad over 120 frames."""
    c = sim.c
    frame_no = t / c["dt"]
    a = c["-1.9"] + c["1.4"] * (torch.fmod(frame_no, c["120"]) / c["120"])
    return torch.stack([torch.sin(a) * c["0.4"], torch.cos(a)])


def ray_circle(ids, mask, pos, radius, origin, dirn):
    """Exact ray-circle distance of each slot's ball, inf on a miss
    (reference main.rs:423-456); the sums are written out, so that every
    device adds in one order."""
    i = torch.where(mask, ids, 0)
    c = pos[i] - origin
    t = c[:, 0] * dirn[0] + c[:, 1] * dirn[1]
    d2 = c[:, 0] * c[:, 0] + c[:, 1] * c[:, 1] - t * t
    r = radius[i]
    r2 = r * r
    root = torch.sqrt(torch.clamp(r2 - d2, min=0.0))
    hit = (d2 <= r2) & (t + root >= 0)
    return torch.where(hit, t - root, torch.inf)


def _norm2(v: torch.Tensor) -> torch.Tensor:
    """|v| over the last axis of length 2, its sum written out."""
    return torch.sqrt(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1])


def spawn_slots(alive: torch.Tensor) -> torch.Tensor:
    """The SPAWNS_PER_FRAME slots a frame spawns into, as
    ``lax.top_k(~alive, K)`` picks them: the dead slots first, then the
    live ones, each group by index (a stable sort; ``torch.topk`` orders
    ties arbitrarily on the card)."""
    return torch.sort(alive.to(torch.uint8), stable=True).indices[
        :SPAWNS_PER_FRAME]


def lifecycle_update(state: State, sim: Sim, draws: torch.Tensor):
    """Expire and spawn (reference Lifecycle, main.rs:281-332): balls past
    their lifetime die; the first SPAWNS_PER_FRAME dead slots by index
    get a new ball at the top with radius exp(U(0.5, 2)) / 800 and a
    uniform lifetime.  Where fewer slots are dead, the first live slots
    fill the K picks, as ``lax.top_k`` picks them, and keep their ball
    but lose its velocity, as in the JAX demo.  Returns (pos, prev,
    radius, expires, alive)."""
    c, t = sim.c, state.t
    alive = state.expires > t
    idx = spawn_slots(alive)
    ok = ~alive[idx]
    r_new = torch.exp(draws[0]) / c["800"]
    x_new = draws[1] * (c["one"] - c["two"] * r_new) + r_new
    y_new = c["one"] - r_new
    p_new = torch.stack([x_new, y_new], dim=-1)
    sel = torch.where(ok[:, None], p_new, state.pos[idx])
    pos, prev = state.pos.clone(), state.prev.clone()
    radius, expires = state.radius.clone(), state.expires.clone()
    pos[idx] = sel
    prev[idx] = sel                                 # zero initial velocity
    radius[idx] = torch.where(ok, r_new, radius[idx])
    expires[idx] = torch.where(ok, t + draws[2], expires[idx])
    return pos, prev, radius, expires, expires > t


def integrate(state: State, sim: Sim, draws: Optional[torch.Tensor] = None):
    """The lifecycle (with ``sim.lifecycle``) and the Verlet step with
    gravity and the speed cap, frozen for dead slots (main.rs:334-350).
    Returns (pos, radius, expires, alive or None when every slot lives,
    moved): ``moved`` is the new positions before the collision
    response."""
    c = sim.c
    pos, prev, radius, expires = state.pos, state.prev, state.radius, \
        state.expires
    alive = None
    if sim.lifecycle:
        if draws is None:
            raise ValueError("a lifecycle frame needs its draws "
                             "(lifecycle_draws)")
        pos, prev, radius, expires, alive = lifecycle_update(state, sim,
                                                             draws)
    vel = (pos - prev) / c["dt"]
    g = c["g_dt"]
    if alive is not None:
        vel = torch.where(alive[:, None], vel, c["zero"])
        g = torch.where(alive, g, c["zero"])
    vel = torch.stack([vel[:, 0], vel[:, 1] + g], dim=-1)
    speed = _norm2(vel)[:, None]
    vel = torch.where(speed > c["max_speed"], vel * (c["max_speed"] / speed),
                      vel)
    return pos, radius, expires, alive, pos + vel * c["dt"]


def contacts(moved: torch.Tensor, radius: torch.Tensor,
             alive: Optional[torch.Tensor], ray_dir: torch.Tensor,
             sim: Sim) -> Contacts:
    """Candidate pairs ``(i, j, valid)`` and the pick of the ray from
    :data:`RAY_ORIGIN` along ``ray_dir``: the broadphase (build ->
    ``pick_ray`` with the ray-circle narrow phase -> scan; dead balls'
    bounds leave the world, so the build drops them), with the scan's
    overflow flag and the scanned layer; or with ``sim.brute_force``
    every pair i < j of live balls, no pick and no layer.  Pair indices
    past the scan's count are clamped to n - 1 and masked by ``valid``."""
    n, c = sim.n, sim.c
    if sim.brute_force:
        mask = sim.pair_i < sim.pair_j
        if alive is not None:
            mask = mask & alive[sim.pair_i] & alive[sim.pair_j]
        false = torch.zeros((), dtype=torch.bool, device=sim.device)
        no_pick = query.PickResult(
            torch.full((), float("inf"), device=sim.device),
            torch.full((), PAD_ID, device=sim.device), false, false)
        return Contacts(sim.pair_i, sim.pair_j, mask, no_pick, false, None)
    bmin = moved - radius[:, None]
    bmax = moved + radius[:, None]
    if alive is not None:
        bmin = torch.where(alive[:, None], bmin, c["two"])
        bmax = torch.where(alive[:, None], bmax, c["three"])
    state = layer.build(SPEC, sim.smin, sim.smax, bmin, bmax, sim.ids,
                        min_depth=MIN_DEPTH)
    dirn = ray_dir / _norm2(ray_dir)
    state, pick = query.pick_ray(SPEC, state, sim.smin, sim.smax,
                                 sim.origin, ray_dir, 2.0, ray_circle,
                                 (moved, radius, sim.origin, dirn))
    state, res = layer.scan(SPEC, state, sim.pair_cap)
    valid = torch.arange(sim.pair_cap, device=sim.device) < res.count
    return Contacts(res.pairs_a.clamp(max=n - 1),
                    res.pairs_b.clamp(max=n - 1), valid, pick, res.overflow,
                    state)


def narrow_phase(moved, radius, i, j, valid, sim: Sim):
    """Circle-circle hits among the candidates and each hit's correction,
    half the overlap along the centers' axis (main.rs:458-479, 508-511):
    (hit (P,), corr (P, 2), zero where not hit)."""
    c = sim.c
    d = moved[i] - moved[j]
    dist = _norm2(d)
    rsum = radius[i] + radius[j]
    hit = valid & (dist < rsum) & (dist > c["zero"])
    corr = (d / torch.maximum(dist, c["eps"])[:, None]
            * ((rsum - dist) * c["half"])[:, None])
    return hit, torch.where(hit[:, None], corr, c["zero"])


def frame(state: State, sim: Sim, draws: Optional[torch.Tensor] = None
          ) -> FrameResult:
    """One frame: lifecycle (``draws``: :func:`lifecycle_draws`, with
    ``sim.lifecycle`` only), Verlet, broadphase and pick, circle narrow
    phase, positional correction (a scatter-add) and the wall clamp."""
    ray_dir = ray_direction(state.t, sim)
    pos, radius, expires, alive, moved = integrate(state, sim, draws)
    con = contacts(moved, radius, alive, ray_dir, sim)
    i, j, valid = con.i, con.j, con.valid
    hit, corr = narrow_phase(moved, radius, i, j, valid, sim)
    new_pos = moved.index_add(0, i, corr).index_add_(0, j, -corr)
    new_pos = torch.clamp(new_pos, min=radius[:, None],
                          max=sim.c["one"] - radius[:, None])
    nalive = (alive.sum() if alive is not None
              else torch.full((), sim.n, device=sim.device))
    return FrameResult(State(new_pos, pos, radius, expires,
                             state.t + sim.c["dt"]),
                       hit.sum(), nalive, con.pick, (i, j, valid),
                       con.overflow, con.tree)


def _picked(pick) -> str:
    return (f"pick id={int(pick.obj_id)} d={float(pick.distance):.3f}"
            if bool(pick.found) else "pick miss")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="broadphase_tpu_torch.examples."
                                 "ball_pit")
    ap.add_argument("--balls", type=int, default=2500)  # max in reference
    ap.add_argument("--frames", type=int, default=300)
    ap.add_argument("--brute-force", action="store_true")
    ap.add_argument("--lifecycle", action="store_true",
                    help="spawn/expire balls per frame (main.rs:281-332)")
    ap.add_argument("--png-every", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--chunk", type=int, default=1,
                    help="frames per report (1 = the reference's "
                    "per-frame loop)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    n = args.balls
    sim = make_sim(n, args.brute_force, args.lifecycle, args.device)
    state = initial_state(sim, args.seed)
    gen = None
    if args.lifecycle:
        gen = torch.Generator(device=sim.device).manual_seed(args.seed)

    def draws():
        return lifecycle_draws(sim, gen) if gen is not None else None

    frame(state, sim, draws())                          # warm-up, dropped
    if sim.device.type == "cuda":
        torch.cuda.synchronize(sim.device)

    # physics state stays on the device; the counters are device scalars,
    # read on the print frames only (the JAX demo's loop, :270-290)
    chunk = max(1, args.chunk)
    launches = max(1, args.frames // chunk) if chunk > 1 else args.frames
    col_counts = []
    t0 = time.perf_counter()
    for li in range(launches):
        fs = time.perf_counter()
        ncol = None
        for _ in range(chunk):
            out = frame(state, sim, draws())
            state = out.state
            ncol = out.ncol if ncol is None else ncol + out.ncol
        col_counts.append(ncol)
        if li % (3 if chunk > 1 else 30) == 0:
            # the reference's per-frame printout (main.rs:480-506)
            elapsed = (time.perf_counter() - fs) * 1e6
            print(f"frame {li * chunk:4d}: balls: {int(out.nalive):5d} "
                  f"collisions: {int(ncol):6d} "
                  f"elapsed: {elapsed:9.0f}us  {_picked(out.pick)}")
        if args.png_every and chunk == 1 and li % args.png_every == 0:
            _render(state.pos.cpu().numpy(), state.radius.cpu().numpy(), li)
    if sim.device.type == "cuda":
        torch.cuda.synchronize(sim.device)
    dt = time.perf_counter() - t0
    frames = launches * chunk
    total_col = int(torch.stack(col_counts).sum())
    print(f"{frames} frames, {n} ball slots, "
          f"{dt / frames * 1e3:.2f} ms/frame, "
          f"total collisions {total_col}")
    return 0


def _render(pos, radius, frame_no):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(6, 6))
    ax.set_xlim(0, WORLD)
    ax.set_ylim(0, WORLD)
    ax.set_aspect("equal")
    ax.scatter(pos[:, 0], pos[:, 1],
               s=(radius * 6 * 72) ** 2, alpha=0.6, linewidths=0)
    path = f"ball_pit_{frame_no:05d}.png"
    fig.savefig(path, dpi=100)
    plt.close(fig)
    print(f"wrote {path}")


if __name__ == "__main__":
    sys.exit(main())
