"""Build and load the port's CUDA kernels (``csrc/*.cu``) through ctypes.

The kernels have a plain C interface: each entry point takes device
pointers, sizes and the stream, launches, and returns ``cudaGetLastError()``.
They are compiled with ``nvcc`` for ``sm_90a`` into one shared library under
``broadphase_tpu_torch/_build/``, named by a hash of the sources and flags,
at the first launch in a process.  Nothing here runs at import time: the
CPU test suite imports every module of the package.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional

import torch

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v")

# C entry points: "p" = pointer (c_void_p), "i" = int64 (c_int64).  Every
# pointer argument is a device pointer except the trailing stream handle.
_SIGNATURES = {
    "bpt_compact": "pp" + "pppp" + "pppp" + "iiii" + "ii" + "p" + "p",
    "bpt_build": "ppppp" + "p" + "ppp" + "iiiiiii" + "p",
    "bpt_runends": "pppppp" + "iiiii" + "iii" + "i" + "p",
    "bpt_prep": "pppp" + "pppp" + "pp" + "i" + "p",
    "bpt_expand": "pppppp" + "ppp" + "pp" + "iii" + "p",
    "bpt_merge": "ppppp" + "ppp" + "p" + "iii" + "p",
    "bpt_expand_v2": "pppp" + "pp" + "pp" + "ii" + "p",
    "bpt_pairsort": "pppp" + "pp" + "ppp" + "p" + "ii" + "p",
    "bpt_treesort": "ppp" + "pppp" + "p" + "pppp" + "p" + "iiii" + "p",
}

_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    default = cuda_home / "bin" / "nvcc"
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources():
    return sorted(SRC_DIR.glob("*.cu")), sorted(SRC_DIR.glob("*.cuh"))


def library_path() -> Path:
    cu, cuh = _sources()
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for p in cu + cuh:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libbpt_kernels_{h.hexdigest()[:16]}.so"


def ptxas_log(target: Path) -> Path:
    """The ``-Xptxas=-v`` report (registers, shared memory and spills of
    every kernel) that the build of library ``target`` left beside it."""
    return target.with_suffix(".ptxas.txt")


def _build(target: Path) -> None:
    nvcc = _nvcc()
    cu, _ = _sources()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / (p.stem + ".o") for p in cu]

        def compile_one(src_obj):
            src, obj = src_obj
            return subprocess.run(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                capture_output=True, text=True)

        with ThreadPoolExecutor(max_workers=len(cu)) as pool:
            results = list(pool.map(compile_one, zip(cu, objs)))
        for src, res in zip(cu, results):
            if res.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name}:\n"
                                   f"{res.stdout}\n{res.stderr}")
        ptxas_log(target).write_text(
            "".join(r.stdout + r.stderr for r in results))
        tmp_so = Path(tmp) / target.name
        res = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", *map(str, objs), "-o",
             str(tmp_so)], capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{res.stdout}\n"
                               f"{res.stderr}")
        os.replace(tmp_so, target)


def load() -> ctypes.CDLL:
    """The kernel library, built first if this checkout has not built it."""
    global _lib
    if _lib is not None:
        return _lib
    target = library_path()
    if not target.exists():
        _build(target)
    lib = ctypes.CDLL(str(target))
    for name, sig in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p if c == "p" else ctypes.c_int64
                       for c in sig]
    lib.bpt_error_string.restype = ctypes.c_char_p
    lib.bpt_error_string.argtypes = [ctypes.c_int]
    for name in ("bpt_build_tile", "bpt_runends_tile", "bpt_compact_tile",
                 "bpt_prep_tile", "bpt_merge_tile"):
        getattr(lib, name).restype = ctypes.c_int64
        getattr(lib, name).argtypes = []
    lib.bpt_pairsort_scratch.restype = ctypes.c_int64
    lib.bpt_pairsort_scratch.argtypes = [ctypes.c_int64, ctypes.c_int64]
    lib.bpt_treesort_scratch.restype = ctypes.c_int64
    lib.bpt_treesort_scratch.argtypes = [ctypes.c_int64]
    _lib = lib
    return lib


def launch(name: str, *args) -> None:
    """Call entry point ``name`` on the current stream; raise on a launch
    error.  Tensor arguments pass their data pointer, ints pass as int64."""
    lib = load()
    conv = [a.data_ptr() if isinstance(a, torch.Tensor) else a
            for a in args]
    err = getattr(lib, name)(*conv, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}: "
                           f"{lib.bpt_error_string(err).decode()}")


def build_tile() -> int:
    """Objects a block of the cell-emission kernel (``build.cu``) takes;
    its scratch is two status words a tile plus the ticket."""
    return load().bpt_build_tile()


def runends_tile() -> int:
    """Lanes a block of the pass-1 kernel (``runends.cu``) takes; its
    scratch is 32 per-level positions and one status word a tile, plus
    the ticket."""
    return load().bpt_runends_tile()


def compact_tile() -> int:
    """Lanes a block of the single-pass compaction kernel
    (``compact.cu``) takes; its scratch is one status word a tile plus
    the ticket."""
    return load().bpt_compact_tile()


def prep_tile() -> int:
    """Lanes a block of the single-pass prep kernel (``prep.cu``) takes;
    its scratch is two status words a tile plus the ticket."""
    return load().bpt_prep_tile()


def merge_tile() -> int:
    """Merged positions a block of the merge kernel (``merge.cu``) takes;
    its scratch is one status word a tile plus the ticket."""
    return load().bpt_merge_tile()


def pairsort_scratch(n: int, cap: int) -> int:
    """Words of scratch the pair-sort chain (``pairsort.cu``) needs for
    ``n`` input lanes and ``cap`` output lanes."""
    return load().bpt_pairsort_scratch(n, cap)


def treesort_scratch(n: int) -> int:
    """Words of scratch the tree-sort chain (``treesort.cu``) needs for
    ``n`` lanes."""
    return load().bpt_treesort_scratch(n)


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor on one card."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name}: tensors must all be on one CUDA "
                             f"device, got {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
