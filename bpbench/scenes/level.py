"""A level: the upstream ``gen_boxes`` scene (``boxes.make``'s draw)
whose first ``static_objects`` objects are its static geometry, never
moved, and whose rest move.  The split is kept on the scene for the
motion (``motions/walk_dynamic.py``) and the calls."""

from . import boxes


def make(config, gen, device):
    scene = boxes.make(config, gen, device)
    scene.static_objects = config["static_objects"]
    return scene
