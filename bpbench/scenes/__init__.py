"""Scene generators, one module per ``scene.kind`` of a configuration.

Each module has ``make(config, gen, device) -> traffic.Scene``: the
objects of the configuration drawn on ``device`` from the seeded
``torch.Generator`` ``gen``, in a few large calls.
"""
