"""Command-line tools of the port: ``python -m broadphase_tpu_torch.tools``
(scene generation, inspection, validation data) and the stage profilers
``tools.profile_step`` and ``tools.profile_update``."""
