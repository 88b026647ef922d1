"""Host-side tri-leaf BVH8 (layout of ignis_tpu/bvh/builder.py:23-42).

Child bounds are struct-of-arrays [n_nodes, 8]; child references encode
0 = empty, > 0 = inner node index, < 0 = leaf with
start = (-c-1) >> 4 and count = (-c-1) & 15 (at most LEAF_SIZE), over the
triangle soup reordered by `prim_order`. The TPU-only chunked-leaf BVH
(chunkify_bvh8) and its 128-triangle chunk padding are not built.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from ..native import build_bvh8_native

LEAF_SIZE = 4
WIDTH = 8


class BVH8(NamedTuple):
    cmin_x: np.ndarray  # [n_nodes, 8]
    cmin_y: np.ndarray
    cmin_z: np.ndarray
    cmax_x: np.ndarray
    cmax_y: np.ndarray
    cmax_z: np.ndarray
    child: np.ndarray       # [n_nodes, 8] int32
    prim_order: np.ndarray  # [T] new soup position -> original triangle


def decode_leaf(code):
    v = -(code) - 1
    return v >> 4, v & 15


def build_bvh8(v0: np.ndarray, e1: np.ndarray, e2: np.ndarray) -> BVH8:
    """v0/e1/e2: [T, 3] float32 soup; C++ binned SAH collapsed to BVH8."""
    cmin, cmax, child, order = build_bvh8_native(
        np.asarray(v0, np.float32), np.asarray(e1, np.float32),
        np.asarray(e2, np.float32))
    return BVH8(*cmin, *cmax, child, order)
