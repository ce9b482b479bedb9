"""broadphase_tpu_torch: the broadphase build + scan step on PyTorch and CUDA.

A port of the main path of ``broadphase_tpu`` (JAX on a TPU), which stays
beside it as the reference.  Each Pallas kernel of the path is a CUDA C++
kernel for Hopper (``csrc/``), bound through ctypes (``ops/``); a CPU tensor
runs each kernel's plain PyTorch version instead.  This package imports
neither JAX nor ``broadphase_tpu``.
"""

from .index import ALL_SPECS, Index32_2D, Index64_2D, Index64_3D, IndexSpec
from .layer import (LayerBuilder, LayerState, ScanResult, build,
                    make_layer, scan, sort)

__all__ = [
    "ALL_SPECS", "Index32_2D", "Index64_2D", "Index64_3D", "IndexSpec",
    "LayerBuilder", "LayerState", "ScanResult", "build", "make_layer",
    "scan", "sort",
]
