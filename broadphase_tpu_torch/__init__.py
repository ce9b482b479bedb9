"""broadphase_tpu_torch: the broadphase build, scan and temporal-coherence
update on PyTorch and CUDA.

A port of ``broadphase_tpu`` (JAX on a TPU), which stays beside it as the
reference.  Each Pallas kernel of the JAX package is a CUDA C++ kernel for
Hopper (``csrc/``), bound through ctypes (``ops/``); a CPU tensor runs
each kernel's plain PyTorch version instead.  Entry points run on the
CUDA card unless given CPU tensors or ``device="cpu"``.  This package
imports neither JAX nor ``broadphase_tpu``.
"""

from .index import ALL_SPECS, Index32_2D, Index64_2D, Index64_3D, IndexSpec
from .layer import (LayerBuilder, LayerState, ScanResult, build,
                    capacity_of, layers_equal, make_layer, scan, sort)
from . import update  # the module, as in broadphase_tpu: update.update
from .update import TrackedScene, build_tracked

__all__ = [
    "ALL_SPECS", "Index32_2D", "Index64_2D", "Index64_3D", "IndexSpec",
    "LayerBuilder", "LayerState", "ScanResult", "TrackedScene", "build",
    "build_tracked", "capacity_of", "layers_equal", "make_layer", "scan",
    "sort", "update",
]
