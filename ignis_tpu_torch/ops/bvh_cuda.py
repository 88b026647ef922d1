"""K1: BVH8 closest-hit / any-hit, CUDA kernel and plain version.

The kernel (csrc/bvh_walk.cu) replaces
ignis_tpu/ops/pallas_bvh.py::_bvh_kernel. `intersect_bvh` launches it for
rays on a CUDA device and raises if it cannot; for rays on the CPU it takes
the plain lockstep walk of ops/bvh.py. `counts` holds the kernel's launch
count and the plain version's call count; `overflow_count` reads the
kernel's device counter of stack pushes it had to drop. A closest-hit
query whose rays or soup require grad (with grad mode on) goes through
`mt_replay.ClosestHit` (ops/mt_replay.py); any-hit is detached.
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_build, mt_replay
from .bvh import BVHArrays, intersect_bvh_plain as _walk_plain
from .intersect import Rays, TriSoup

counts = cuda_build.Counts()
reset_counts = counts.reset
_OVERFLOW: dict = {}   # device -> int32[1] tensor
_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] + [ctypes.c_void_p] * 17
             + [ctypes.c_int] + [ctypes.c_void_p] * 7)


def _kernel():
    return cuda_build.load_kernel("bvh_walk", "ig_bvh_walk", _ARGTYPES)


def build() -> None:
    """Compile (or load) the kernel library."""
    _kernel()


def _overflow_buf(device) -> torch.Tensor:
    key = str(device)
    if key not in _OVERFLOW:
        _OVERFLOW[key] = torch.zeros(1, dtype=torch.int32, device=device)
    return _OVERFLOW[key]


def overflow_count(device) -> int:
    """Stack pushes the kernel dropped on `device` since the last reset."""
    return int(_overflow_buf(device).item())


def reset_overflow(device) -> None:
    _overflow_buf(device).zero_()


def intersect_bvh_plain(rays: Rays, soup: TriSoup, bvh: BVHArrays,
                        any_hit: bool = False, shadow_visible=None):
    counts["plain_calls"] += 1
    return _walk_plain(rays, soup, bvh, any_hit, shadow_visible)


def intersect_bvh(rays: Rays, soup: TriSoup, bvh: BVHArrays,
                  any_hit: bool = False, shadow_visible=None):
    """Closest hit (a Hit) or any-hit occlusion (a bool tensor)."""
    if not any_hit and mt_replay.wants_grad(rays, soup):
        return mt_replay.closest_hit(
            lambda r, s: _intersect(r, s, bvh, False, None), rays, soup)
    return _intersect(rays, soup, bvh, any_hit, shadow_visible)


@torch.no_grad()
def _intersect(rays: Rays, soup: TriSoup, bvh: BVHArrays, any_hit: bool,
               shadow_visible):
    device = rays.tmin.device
    if device.type == "cpu":
        return intersect_bvh_plain(rays, soup, bvh, any_hit, shadow_visible)
    if device.type != "cuda":
        raise ValueError(f"K1 has no kernel for device {device}")
    a = cuda_build.prepare_hit_launch("K1", rays, soup, shadow_visible,
                                      any_hit)
    n_slots = bvh.child.numel()
    cuda_build.check_inputs("K1 boxes", device, n_slots, *bvh[:6])
    cuda_build.check_inputs("K1 child", device, n_slots, bvh.child,
                            dtype=torch.int32)
    if bvh.child.dim() != 2 or bvh.child.shape[1] != 8:
        raise ValueError("K1: child must be [n_nodes, 8]")
    if a.n:
        cuda_build.launch("K1 bvh_walk", counts, _kernel(), *a.rays, a.n,
                          *a.tris, a.vis, *[b.data_ptr() for b in bvh[:6]],
                          bvh.child.data_ptr(), int(any_hit), *a.outs,
                          _overflow_buf(device).data_ptr(), a.stream)
    return a.result
