"""Motion models, one module per ``motion.kind`` of a traffic mix.

Each module has ``ring(scene, params, frames, gen) -> dict``: the bounds
of ``frames`` successive frames, as tensors with a leading frame axis
(``bounds_min`` and ``bounds_max``, and ``positions`` for balls), frame 0
the scene itself.  Every step between two neighbouring frames is one
step of the model, and the model is reversible in law, so the frame loop
plays the ring forward and back.
"""
