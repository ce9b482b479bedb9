"""``setup_s``: process start to the first timed frame: imports, the
card's start, the kernels' build where the checkout has none, the scene
and its ring, the calls' set-up and the warm-up."""


def read(run):
    return run.window.setup_s
