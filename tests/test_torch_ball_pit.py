"""Port parity: the ball-pit demo's frame against the JAX demo's
(``examples/ball_pit.py``, loaded by path) on the CPU, teacher-forced:
each frame starts both from the JAX demo's state, in the three modes
(broadphase, ``--lifecycle``, ``--brute-force``), and in broadphase mode
with a pair buffer too small for the frame's candidates.  The lifecycle
gets the draws JAX makes inside its frame.

Exact: the candidate pairs, the scanned tree and the scan's overflow flag
(against JAX's build + scan of the same bounds), the hit count, the live
count, the pick's id and ``found``, the spawn slots and their lifetimes.  Within a stated tolerance: positions
(1e-6 absolute in the unit square: the positional correction is a
scatter-add whose summation order differs) and the pick's distance and a
spawned ball's radius (1e-6 absolute: torch's ``sin``, ``cos`` and
``exp`` may round the last bit otherwise than XLA's).
"""

import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from broadphase_tpu import layer as jlayer
from broadphase_tpu.index import Index32_2D as J32
from broadphase_tpu_torch import layer as tlayer
from broadphase_tpu_torch.examples import ball_pit as bp

REPO = Path(__file__).resolve().parent.parent
N = 100
FRAMES = 5
TOL = 1e-6
SMALL_PAIR_CAP = 16     # below the 30-odd candidates of each frame here


@pytest.fixture(scope="module")
def jbp():
    spec = importlib.util.spec_from_file_location(
        "jax_ball_pit", REPO / "examples" / "ball_pit.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _start(mode, seed=5):
    """The demo's start with larger balls (radii 0.008-0.015, below the
    ``min_depth`` 4 cell, so that they collide and the ray finds them);
    for the lifecycle one dead slot (frame 0 then spawns into it and into
    the first live slot) and a few balls that expire in the next
    frames."""
    rng = np.random.default_rng(seed)
    radius = rng.uniform(0.008, 0.015, N).astype(np.float32)
    pos = rng.uniform(0.05, 0.95, (N, 2)).astype(np.float32)
    prev = (pos - rng.normal(0, 0.001, (N, 2))).astype(np.float32)
    expires = np.full(N, np.inf, np.float32)
    if mode == "lifecycle":
        expires[37] = 0.0
        expires[[3, 50, 51, 99]] = np.float32([0.015, 0.025, 0.025, 0.035])
    return pos, prev, radius, expires


def _jax_pairs(moved, radius, alive, pair_cap):
    """JAX's candidate pairs of the same bounds (its demo's collide), its
    overflow flag and its scanned tree's keys and ids."""
    bmin = np.where(alive[:, None], moved - radius[:, None], 2.0)
    bmax = np.where(alive[:, None], moved + radius[:, None], 3.0)
    st = jlayer.build(J32, np.zeros(2, np.float32), np.ones(2, np.float32),
                      bmin.astype(np.float32), bmax.astype(np.float32),
                      np.arange(N, dtype=np.uint32), min_depth=bp.MIN_DEPTH)
    st, res = jlayer.scan(J32, st, pair_cap)
    cnt = int(res.count)
    return (np.asarray(res.pairs_a)[:cnt].astype(np.int64),
            np.asarray(res.pairs_b)[:cnt].astype(np.int64),
            bool(res.overflow), jlayer.tree_to_numpy(J32, st))


@pytest.mark.parametrize("mode", ["broadphase", "lifecycle", "brute_force",
                                  "overflow"])
def test_frames_match_jax(jbp, mode):
    sim = bp.make_sim(N, brute_force=mode == "brute_force",
                      lifecycle=mode == "lifecycle", device="cpu")
    if mode == "overflow":
        sim = sim._replace(pair_cap=SMALL_PAIR_CAP)
    step = jbp.make_step(N, sim.pair_cap, mode == "brute_force",
                         mode == "lifecycle")
    pos, prev, radius, expires = _start(mode)
    t = np.float32(0.0)
    key = jax.random.PRNGKey(11)
    total_hits = found = 0
    for f in range(FRAMES):
        key, sub = jax.random.split(key)
        jres = step(pos, prev, radius, expires, jnp.float32(t), sub)
        jout = [np.array(x) for x in jres[:6]]
        jpick = [np.asarray(x) for x in jres[6]]
        draws = None
        if mode == "lifecycle":
            k1, k2, k4 = jax.random.split(sub, 3)
            K = bp.SPAWNS_PER_FRAME
            draws = torch.as_tensor(np.stack([
                np.asarray(jax.random.uniform(k1, (K,), jnp.float32, 0.5,
                                              2.0)),
                np.asarray(jax.random.uniform(k2, (K,), jnp.float32)),
                np.asarray(jax.random.uniform(k4, (K,), jnp.float32,
                                              bp.LIFETIME_MIN,
                                              bp.LIFETIME_MAX))]))
        state = bp.State(*(torch.as_tensor(x) for x in (pos, prev, radius,
                                                         expires)),
                         t=torch.tensor(t))
        got = bp.frame(state, sim, draws)
        label = f"{mode} frame {f}"

        np.testing.assert_array_equal(got.state.expires.numpy(), jout[3],
                                      err_msg=label)
        np.testing.assert_allclose(got.state.radius.numpy(), jout[2],
                                   rtol=0, atol=TOL, err_msg=label)
        np.testing.assert_allclose(got.state.prev.numpy(), jout[1], rtol=0,
                                   atol=TOL, err_msg=label)
        np.testing.assert_allclose(got.state.pos.numpy(), jout[0], rtol=0,
                                   atol=TOL, err_msg=label)
        assert int(got.ncol) == int(jout[4]), label
        assert int(got.nalive) == int(jout[5]), label
        assert bool(got.pick.found) == bool(jpick[2]), label
        if bool(jpick[2]):
            assert int(got.pick.obj_id) == int(jpick[0]), label
            assert abs(float(got.pick.distance) - float(jpick[1])) <= TOL
        assert float(got.state.t) == np.float32(t + bp.DT), label

        # the candidate pairs of this frame's bounds, against JAX's scan
        _, r, _, alive, moved = bp.integrate(state, sim, draws)
        alive_np = (np.ones(N, bool) if alive is None else alive.numpy())
        i, j, valid = (x.numpy() for x in got.pairs)
        if mode == "brute_force":
            ii, jj = np.meshgrid(np.arange(N), np.arange(N), indexing="ij")
            want = ((ii < jj) & alive_np[ii] & alive_np[jj]).reshape(-1)
            np.testing.assert_array_equal(valid, want)
            assert not bool(got.overflow) and got.tree is None, label
        else:
            ja, jb, ovf, jtree = _jax_pairs(moved.numpy(), r.numpy(),
                                            alive_np, sim.pair_cap)
            assert ovf == (mode == "overflow"), label
            assert bool(got.overflow) == ovf, label
            tkeys, tids, tcnt = tlayer.tree_to_numpy(bp.SPEC, got.tree)
            np.testing.assert_array_equal(tkeys, jtree[0], err_msg=label)
            np.testing.assert_array_equal(tids, jtree[1], err_msg=label)
            assert tcnt == jtree[2], label
            np.testing.assert_array_equal(i[valid], ja, err_msg=label)
            np.testing.assert_array_equal(j[valid], jb, err_msg=label)
        total_hits += int(got.ncol)
        found += bool(got.pick.found)
        pos, prev, radius, expires = jout[:4]
        t = np.float32(t + bp.DT)
    assert total_hits > 0
    if mode != "brute_force":
        assert found > 0


@pytest.mark.parametrize("dead", [[], [7], [0, 99], [5, 6, 7, 8],
                                  list(range(100))])
def test_spawn_slots_match_top_k(dead):
    alive = np.ones(N, bool)
    alive[dead] = False
    _, want = jax.lax.top_k(jnp.asarray(~alive).astype(jnp.int32),
                            bp.SPAWNS_PER_FRAME)
    got = bp.spawn_slots(torch.as_tensor(alive))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_demo_cli_prints_the_jax_demo_lines(jbp, capsys):
    jbp.main(["--balls", "100", "--frames", "31"])
    want = capsys.readouterr().out.splitlines()
    bp.main(["--device", "cpu", "--balls", "100", "--frames", "31"])
    got = capsys.readouterr().out.splitlines()

    def strip(line):   # the elapsed and ms/frame fields are times
        return [w for w in line.split() if not w.endswith(("us", "ms/frame,"))
                and not w.replace(".", "").isdigit() or w.isdigit()]

    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert strip(g) == strip(w), (g, w)


@pytest.mark.parametrize("extra,frames", [((), 5),
                                          (("--lifecycle", "--chunk", "2"),
                                           4)])
def test_demo_cli_runs(extra, frames):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH="")
    r = subprocess.run(
        [sys.executable, "-m", "broadphase_tpu_torch.examples.ball_pit",
         "--device", "cpu", "--balls", "100", "--frames", "5", *extra],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert f"{frames} frames, 100 ball slots" in r.stdout
