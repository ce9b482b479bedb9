"""numpy-only helpers shared with the JAX package, without importing it.

``broadphase_tpu/__init__.py`` imports JAX, and the machines the port runs
on may have none, so the two numpy-only modules the port reuses are loaded
by file path:

* ``broadphase_tpu/utils/native.py``: ctypes bindings of the C++ oracle
  (``native/``, built with ``make -C native`` on first use);
* ``broadphase_tpu/bench_caps.py``: the 1M bench's capacities.

:func:`bench_scene` is the bench's scene generator (``bench.py::_scene``),
which sits in a module that sets up JAX's compile cache when imported.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

import numpy as np

_JAX_PKG = Path(__file__).resolve().parent.parent / "broadphase_tpu"


def _load(name: str, path: Path):
    if not path.exists():
        raise ImportError(f"{path} not found: the port needs the JAX "
                          "package's sources beside it")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def native():
    """The C++ oracle bindings (``broadphase_tpu.utils.native``)."""
    return _load("_bpt_native", _JAX_PKG / "utils" / "native.py")


def bench_caps():
    """The bench capacities (``broadphase_tpu.bench_caps``)."""
    return _load("_bpt_bench_caps", _JAX_PKG / "bench_caps.py")


def bench_scene(dim: int, n: int, seed: int = 0, density: float = 1e-3,
                size_range=(1.0, 10.0)):
    """(system_min, system_max, bounds_min, bounds_max, ids) of the bench's
    boxes scene: cubic system box of volume n / density, uniform sizes and
    placement, ids 0..n-1.  Same numbers as ``bench.py::_scene``."""
    rng = np.random.default_rng(seed)
    extent = (n / density) ** (1.0 / dim)
    lo, hi = 0.0, float(extent)
    size = rng.uniform(size_range[0], size_range[1],
                       size=(n, dim)).astype(np.float32)
    bmin = (rng.uniform(lo, hi, size=(n, dim)).astype(np.float32)
            * ((hi - size_range[1]) / hi)).astype(np.float32)
    bmax = bmin + size
    ids = np.arange(n, dtype=np.uint32)
    smin = np.full(dim, lo, np.float32)
    smax = np.full(dim, hi, np.float32)
    return smin, smax, bmin, bmax, ids
