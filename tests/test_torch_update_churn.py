"""The temporal-coherence update under the benchmark's churn mix
(``bpbench/traffic/update_1pct.json``), on the port's plain kernels at a
tiny size: a persistent layer built once from ring frame 0
(``update.build_tracked``), then each frame's ``update`` and canonical
``scan`` over the whole ring played forward and back, each frame held to
the plain NumPy reference (``bpbench/reference/broadphase.py``) of a
fresh build and scan of that frame's bounds."""

import pytest

from bpbench import caps, check, traffic
from bpbench.reference import broadphase as ref
from broadphase_tpu_torch import index as tidx
from broadphase_tpu_torch import layer, profiling, update

SPEC = tidx.Index64_3D
N = 3000
# the boxes3d_1M configuration at bpbench/tests/conftest.py's tiny density
CONFIG = {"objects": N, "dim": 3,
          "scene": {"kind": "boxes", "density": 2.4e-5, "size_min": 1.0,
                    "size_max": 10.0}}
MIX = traffic.load_json("traffic", "update_1pct")
RING = MIX["ring"]
FRAMES = range(1, 2 * RING - 1)          # forward, back to ring frame 0
TREE = caps.tree_capacity(N, 37)
PAIRS, EMIT = caps.per_object(N, 9), caps.per_object(N, 16)
CHURN_CAP, OBJ_CAP = caps.update_caps(N, MIX["churn_fraction"])


@pytest.fixture(scope="module")
def played():
    """{frame number: (its bounds, the host outputs of its update and
    scan, the objects the update found changed)} over the ring."""
    gen = traffic.generator(2 ** 31 + 7, "cpu")
    scene = traffic.make_scene(CONFIG, gen, "cpu")
    ring = traffic.make_ring(scene, MIX, gen)
    tracked = update.build_tracked(
        SPEC, scene.system_min_t, scene.system_max_t, ring["bounds_min"][0],
        ring["bounds_max"][0], scene.ids, out_capacity=TREE)
    out = {}
    with profiling.tracing():
        profiling.counters()
        for number in FRAMES:
            fr = traffic.frame(ring, number)
            tracked = update.update(SPEC, tracked, scene.system_min_t,
                                    scene.system_max_t, fr.bounds_min,
                                    fr.bounds_max, CHURN_CAP,
                                    obj_cap=OBJ_CAP)
            tree, pairs = layer.scan(SPEC, tracked.state, PAIRS,
                                     emit_capacity=EMIT)
            changed = profiling.counters()["update.changed"]
            out[number] = (fr, check.host_outputs({"tree": tree,
                                                   "pairs": pairs}),
                           changed)
    return scene, out


@pytest.mark.parametrize("number", FRAMES)
def test_each_frame_equals_the_references_build_and_scan(played, number):
    scene, out = played
    fr, got, changed = out[number]
    want = ref.build(ref.SPECS["Index64_3D"], scene.system_min,
                     scene.system_max, fr.bounds_min.numpy(),
                     fr.bounds_max.numpy(), scene.ids.numpy(), 2, 0, TREE)
    assert not want.overflow and not got["tree"].overflow
    assert check.tree_diff(got["tree"], want) == 0
    pairs = ref.scan(ref.SPECS["Index64_3D"], want, PAIRS, EMIT)
    assert pairs.count > 0
    assert check.pairs_diff(got["pairs"], pairs, True) == 0
    # the mix churns each frame, within the changed objects' capacity
    assert 0 < changed <= OBJ_CAP


def test_the_ring_plays_every_frame_forward_and_back():
    slots = [traffic.slot_of(number, RING) for number in FRAMES]
    assert slots == list(range(1, RING)) + list(range(RING - 2, -1, -1))
