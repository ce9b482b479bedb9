"""ctypes bindings of the C++ oracle in the repository's ``native/``.

The port's own copy of the part of ``broadphase_tpu/utils/native.py`` it
uses: ``extend`` (the reference's append order), ``sort_tree`` and the
sequential stack-sweep scan ``scan_seq``, the golden reference for the
pair list at 1M.  The library is built with ``make -C native`` (g++, no
dependencies) on first use.  numpy only.
"""

from __future__ import annotations

import ctypes as ct
import subprocess
from pathlib import Path
from typing import Tuple

import numpy as np

NATIVE_DIR = Path(__file__).resolve().parent.parent / "native"
LIB_PATH = NATIVE_DIR / "libbroadphase_host.so"

_lib = None


def _load() -> ct.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    if not LIB_PATH.exists():
        res = subprocess.run(["make", "-C", str(NATIVE_DIR), "-s"],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"cannot build the native oracle:\n"
                               f"{res.stdout}\n{res.stderr}")
    lib = ct.CDLL(str(LIB_PATH))
    u64p = ct.POINTER(ct.c_uint64)
    u32p = ct.POINTER(ct.c_uint32)
    f32p = ct.POINTER(ct.c_float)
    lib.bp_extend_index64_3d.restype = ct.c_uint64
    lib.bp_extend_index64_3d.argtypes = [
        f32p, f32p, f32p, f32p, u32p, ct.c_uint64, ct.c_uint32,
        u64p, u32p, ct.c_uint64, u64p]
    lib.bp_sort_tree.restype = None
    lib.bp_sort_tree.argtypes = [u64p, u32p, ct.c_uint64]
    lib.bp_scan_seq.restype = ct.c_uint64
    lib.bp_scan_seq.argtypes = [u64p, u32p, ct.c_uint64, u64p, ct.c_uint64]
    _lib = lib
    return lib


def _p(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ct.POINTER(ctype))


def extend(system_min, system_max, bounds_min, bounds_max, ids,
           min_depth: int = 0, slack: int = 8
           ) -> Tuple[np.ndarray, np.ndarray, int]:
    """(keys, ids, invalid_count): the unsorted Index64_3D tree in the
    reference's append order."""
    lib = _load()
    bounds_min = np.ascontiguousarray(bounds_min, np.float32)
    bounds_max = np.ascontiguousarray(bounds_max, np.float32)
    ids = np.ascontiguousarray(ids, np.uint32)
    smin = np.ascontiguousarray(system_min, np.float32)
    smax = np.ascontiguousarray(system_max, np.float32)
    n = len(ids)
    cap = max(slack * n, 64)
    keys = np.zeros(cap, np.uint64)
    out_ids = np.zeros(cap, np.uint32)
    inv = np.zeros(1, np.uint64)
    w = lib.bp_extend_index64_3d(
        _p(smin, ct.c_float), _p(smax, ct.c_float),
        _p(bounds_min, ct.c_float), _p(bounds_max, ct.c_float),
        _p(ids, ct.c_uint32), n, min_depth,
        _p(keys, ct.c_uint64), _p(out_ids, ct.c_uint32), cap,
        _p(inv, ct.c_uint64))
    if w > cap:
        raise ValueError(f"extend overflow: {w} > {cap}; raise slack")
    return keys[:w].copy(), out_ids[:w].copy(), int(inv[0])


def sort_tree(keys: np.ndarray, ids: np.ndarray
              ) -> Tuple[np.ndarray, np.ndarray]:
    """The tree sorted by (key, id)."""
    lib = _load()
    keys = np.ascontiguousarray(keys, np.uint64).copy()
    ids = np.ascontiguousarray(ids, np.uint32).copy()
    lib.bp_sort_tree(_p(keys, ct.c_uint64), _p(ids, ct.c_uint32), len(ids))
    return keys, ids


def scan_seq(keys: np.ndarray, ids: np.ndarray, pair_slack: int = 32
             ) -> np.ndarray:
    """Sorted tree -> (n_pairs, 2) uint32 (later, earlier) pairs, sorted and
    deduplicated."""
    lib = _load()
    keys = np.ascontiguousarray(keys, np.uint64)
    ids = np.ascontiguousarray(ids, np.uint32)
    cap = max(pair_slack * max(len(ids), 1), 1024)
    out = np.zeros(cap, np.uint64)
    cnt = lib.bp_scan_seq(_p(keys, ct.c_uint64), _p(ids, ct.c_uint32),
                          len(ids), _p(out, ct.c_uint64), cap)
    if cnt > cap:
        raise ValueError(f"scan overflow: {cnt} > {cap}; raise pair_slack")
    packed = out[:cnt]
    return np.stack([(packed >> np.uint64(32)).astype(np.uint32),
                     (packed & np.uint64(0xFFFFFFFF)).astype(np.uint32)],
                    axis=1)
