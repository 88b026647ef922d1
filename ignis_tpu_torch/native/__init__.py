"""The native binned-SAH BVH8 builder, the port's own copy.

bvh_builder.cpp beside this file is the port's own copy of
ignis_tpu/native/bvh_builder.cpp, unchanged: plain C++ with a C ABI, so
the port reads, imports and compiles nothing of the JAX package's tree.
It is compiled with g++ into build/ignis_tpu_torch/ in the checkout
(ops/cuda_build.compile_and_load) and loaded with ctypes, built for the
baseline of the host architecture, without -march=native, so a cached
library runs on any host of that architecture. A failed build raises;
there is no numpy fallback.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np

from ..ops.cuda_build import compile_and_load

SOURCE = Path(__file__).resolve().parent / "bvh_builder.cpp"
GXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17"]
WIDTH = 8


def get_lib() -> ctypes.CDLL:
    lib = compile_and_load("bvh_builder", "g++", GXX_FLAGS, SOURCE)
    fn = lib.ig_build_bvh8
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
    return lib


def build_bvh8_native(v0: np.ndarray, e1: np.ndarray, e2: np.ndarray):
    """Binned-SAH BVH8 over a [T, 3] soup; returns (cmin [3][n, 8],
    cmax [3][n, 8], child [n, 8], prim_order [T])."""
    lib = get_lib()
    n = len(v0)
    if n == 0:
        raise ValueError("cannot build a BVH over no triangles")
    p1 = v0 + e1
    p2 = v0 + e2
    bb_min = np.ascontiguousarray(np.minimum(np.minimum(v0, p1), p2),
                                  np.float32)
    bb_max = np.ascontiguousarray(np.maximum(np.maximum(v0, p1), p2),
                                  np.float32)
    cap = max(2 * n // 4 + 8, 8)
    cmin = [np.empty(cap * WIDTH, np.float32) for _ in range(3)]
    cmax = [np.empty(cap * WIDTH, np.float32) for _ in range(3)]
    child = np.empty(cap * WIDTH, np.int32)
    order = np.empty(n, np.int32)

    def ptr(a):
        return a.ctypes.data_as(ctypes.c_void_p)
    n_nodes = lib.ig_build_bvh8(ptr(bb_min), ptr(bb_max), n,
                                ptr(cmin[0]), ptr(cmin[1]), ptr(cmin[2]),
                                ptr(cmax[0]), ptr(cmax[1]), ptr(cmax[2]),
                                ptr(child), ptr(order), cap)
    if n_nodes <= 0:
        raise RuntimeError(f"native BVH build failed ({n_nodes})")
    s = n_nodes * WIDTH
    return ([a[:s].reshape(n_nodes, WIDTH) for a in cmin],
            [a[:s].reshape(n_nodes, WIDTH) for a in cmax],
            child[:s].reshape(n_nodes, WIDTH), order)
