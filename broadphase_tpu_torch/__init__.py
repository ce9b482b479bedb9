"""broadphase_tpu_torch: the broadphase layer (build, extend, merge, sort,
scan), its point and region queries (linear, tree descent, batched), the
generic traversals and the temporal-coherence update on PyTorch and CUDA.

A port of ``broadphase_tpu`` (JAX on a TPU), which stays beside it as the
reference.  Each Pallas kernel of the JAX package is a CUDA C++ kernel for
Hopper (``csrc/``), bound through ctypes (``ops/``); a CPU tensor runs
each kernel's plain PyTorch version instead.  Entry points run on the
CUDA card unless given CPU tensors or ``device="cpu"``.  This package
imports neither JAX nor ``broadphase_tpu``.
"""

from .index import ALL_SPECS, Index32_2D, Index64_2D, Index64_3D, IndexSpec
from .layer import (LayerBuilder, LayerState, ScanResult, TestResult, build,
                    capacity_of, clear, extend, layers_equal, make_layer,
                    merge, scan, scan_auto, scan_filtered, sort)
# the modules, as in broadphase_tpu: update.update, query.pick_ray
from . import query, scene, singleq, traverse, update
from .update import TrackedScene, build_tracked

__all__ = [
    "ALL_SPECS", "Index32_2D", "Index64_2D", "Index64_3D", "IndexSpec",
    "LayerBuilder", "LayerState", "ScanResult", "TestResult",
    "TrackedScene", "build", "build_tracked", "capacity_of", "clear",
    "extend", "layers_equal", "make_layer", "merge", "query", "scan",
    "scan_auto", "scan_filtered", "scene", "singleq", "sort", "traverse",
    "update",
]
