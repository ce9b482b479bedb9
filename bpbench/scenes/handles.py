"""Entity handles as ids: the upstream ``gen_boxes`` scene (``boxes.make``'s
draw, bit for bit) whose ids are 32-bit versioned handles, as an engine
built on an entity-component system hands them to the broadphase (EnTT's
``entt::entity``: a slot index in the low ``index_bits``, above it a
version that grows by one each time the slot's entity is destroyed and
the slot reused).  Row r is slot r, and its id is
``version(r) << index_bits | r``.

The versions are a recycling history: the upstream demo's population
system (broadphase-rs ``examples/main.rs:281-332``) run for
``age_frames`` frames of ``step_s`` over every slot.  It spawns at most
``objects * step_s / lifetime_s[0]`` entities a frame into the first
free slots (2 a frame at its 2,500 balls), so slot r is first filled in
frame ``r // that``; each entity lives U(lifetime_s) seconds, which
expire at the first frame at or past them; its slot is then released
(version + 1) and filled again in the same frame, since the deaths a
frame stay below the spawn cap (at 1M, about 333 against 1,000).  Every
slot thus recycles at one rate, and the versions gather in a band about
``age / mean lifetime``, as wide as the lifetimes' spread allows, not
evenly over the 12 bits.  The lifetimes come from a generator of their
own seeded from the scene's seed, so that at one seed the boxes and
their motion are ``boxes``' own."""

import torch

from . import boxes

_LIFETIMES = 16             # lifetimes drawn a slot per round
_SEED_SALT = 1 << 40        # the history's seed: the scene's, moved past it


def versions(config, seed: int, device) -> torch.Tensor:
    """(objects,) int64: each slot's deaths in the population system's
    first ``age_frames`` frames, the version of its live entity."""
    h, n = config["handles"], config["objects"]
    step, (life_lo, life_hi) = h["step_s"], h["lifetime_s"]
    lo, hi = round(life_lo / step), round(life_hi / step)
    cap = max(1, int(n * step / life_lo))
    gen = torch.Generator(device=device)
    gen.manual_seed(seed + _SEED_SALT)
    born = torch.arange(n, device=device) // cap
    deaths = torch.zeros(n, dtype=torch.int64, device=device)
    while bool((born <= h["age_frames"]).any()):
        u = torch.rand((n, _LIFETIMES), generator=gen, device=device)
        # a life of U(lo, hi) frames ends at the first frame past it
        life = lo + 1 + (u * (hi - lo)).to(torch.int64).clamp_(max=hi - lo - 1)
        ends = born[:, None] + life.cumsum(1)
        deaths += (ends <= h["age_frames"]).sum(1)
        born = ends[:, -1]
    return deaths


def make(config, gen, device):
    h = config["handles"]
    if h["index_bits"] + h["version_bits"] != 32 or \
            config["objects"] > 1 << h["index_bits"]:
        raise ValueError(f"handles {h} do not fit {config['objects']} "
                         "objects in 32 bits")
    scene = boxes.make(config, gen, device)
    version = versions(config, gen.initial_seed(), device)
    # the all-ones version is EnTT's tombstone, never a live entity's
    if int(version.max()) >= (1 << h["version_bits"]) - 1:
        raise ValueError(f"versions up to {int(version.max())} pass "
                         f"{h['version_bits']} bits")
    scene.ids = (version << h["index_bits"]) | scene.ids
    return scene
