"""K1: BVH8 closest-hit / any-hit, CUDA kernel and plain version.

The kernel (csrc/bvh_walk.cu) replaces
ignis_tpu/ops/pallas_bvh.py::_bvh_kernel. `intersect_bvh` launches it for
rays on a CUDA device and raises if it cannot; for rays on the CPU it takes
the plain lockstep walk of ops/bvh.py, which reads `BVHArrays` as they are.
`counts` holds the kernel's launch count and the plain version's call
count; `overflow_count` reads the kernel's device counter of stack pushes
it had to drop and `deepest_stack` the deepest stack it reached. A
closest-hit query whose rays or soup require grad (with grad mode on) goes
through `mt_replay.ClosestHit` (ops/mt_replay.py); any-hit is detached.

The kernel reads two packed layouts, both made by plain torch functions
here: `pack_nodes` (each node's occupied children as 32-byte records, made
once per BVH and kept in `_NODES` while the BVH lives) and `pack_tris`
(v0, e1, e2 as three float4 a row). Callers on the main path pack the
triangles once per render (techniques/path.render_lanes) and pass them as
`tri_rows`; a call without them packs its own.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
from torch.utils.weak import WeakIdKeyDictionary

from . import cuda_build, mt_replay
from .bvh import BVHArrays, LEAF_SIZE, intersect_bvh_plain as _walk_plain
from .intersect import Rays, TriSoup

counts = cuda_build.Counts()
reset_counts = counts.reset
_COUNTERS: dict = {}   # device -> int32[3]: dropped pushes, deepest stack,
#                        and the kernel's next-ray counter
_NODES = WeakIdKeyDictionary()   # BVHArrays.child -> PackedNodes
_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] + [ctypes.c_void_p] * 3
             + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 7)
TRI_ROW = 12     # floats a packed triangle: v0, e1, e2, each xyz + 0


class PackedNodes(NamedTuple):
    """Node records of a BVH8 for K1: each node's occupied children in slot
    order, one [8] int32 record each (box min xyz and max xyz as float
    bits, the reference, 0). An inner reference is
    (first record << 3) | (children - 1); a leaf keeps its BVHArrays code."""
    records: torch.Tensor   # [R, 8] int32
    root: int               # reference of node 0
    dropped: int            # empty child slots left out


def _kernel():
    return cuda_build.load_kernel("bvh_walk", "ig_bvh_walk", _ARGTYPES)


def build() -> None:
    """Compile (or load) the kernel library."""
    _kernel()


def _counters(device) -> torch.Tensor:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    key = str(device)
    if key not in _COUNTERS:
        _COUNTERS[key] = torch.zeros(3, dtype=torch.int32, device=device)
    return _COUNTERS[key]


def overflow_count(device) -> int:
    """Stack pushes the kernel dropped on `device` since the last reset."""
    return int(_counters(device)[0].item())


def deepest_stack(device) -> int:
    """The deepest stack the kernel reached on `device` since the last
    reset."""
    return int(_counters(device)[1].item())


def reset_overflow(device) -> None:
    _counters(device).zero_()


def pack_nodes(bvh: BVHArrays) -> PackedNodes:
    """K1's node records of `bvh` (plain torch, on bvh's device)."""
    child = bvh.child
    occupied = child != 0
    kids = occupied.sum(1)
    if bool((kids == 0).any()):
        raise ValueError("K1: a BVH node without children")
    leaf_counts = (-child[child < 0] - 1) & 15
    if bool((leaf_counts > LEAF_SIZE).any()):
        raise ValueError(f"K1: a leaf of more than {LEAF_SIZE} triangles")
    first = torch.cumsum(kids, 0) - kids
    if int(kids.sum()) > 1 << 28:
        raise ValueError("K1: too many node records for a 28-bit offset")
    inner = torch.clamp(child, min=0).long()
    ref = torch.where(child > 0, (first[inner] << 3) | (kids[inner] - 1),
                      child.long()).to(torch.int32)
    words = torch.stack([*[a.contiguous().view(torch.int32) for a in bvh[:6]],
                         ref, torch.zeros_like(ref)], 2)
    return PackedNodes(words[occupied].contiguous(), int(kids[0]) - 1,
                       int((~occupied).sum()))


def scene_nodes(bvh: BVHArrays) -> PackedNodes:
    """pack_nodes(bvh), made once while bvh's child tensor lives."""
    packed = _NODES.get(bvh.child)
    if packed is None:
        packed = pack_nodes(bvh)
        _NODES[bvh.child] = packed
    return packed


@torch.no_grad()
def pack_tris(soup: TriSoup) -> torch.Tensor:
    """K1's triangle rows: [T, 12] f32, v0, e1, e2 as xyz + 0 each (plain
    torch, on the soup's device, detached)."""
    z = torch.zeros_like(soup.v0.x)
    return torch.stack([*soup.v0, z, *soup.e1, z, *soup.e2, z], 1)


def intersect_bvh_plain(rays: Rays, soup: TriSoup, bvh: BVHArrays,
                        any_hit: bool = False, shadow_visible=None):
    counts["plain_calls"] += 1
    return _walk_plain(rays, soup, bvh, any_hit, shadow_visible)


def intersect_bvh(rays: Rays, soup: TriSoup, bvh: BVHArrays,
                  any_hit: bool = False, shadow_visible=None,
                  tri_rows: torch.Tensor = None):
    """Closest hit (a Hit) or any-hit occlusion (a bool tensor).
    `tri_rows` is pack_tris(soup), made by the caller once for many
    calls; without it the call packs its own."""
    if not any_hit and mt_replay.wants_grad(rays, soup):
        return mt_replay.closest_hit(
            lambda r, s: _intersect(r, s, bvh, False, None, tri_rows),
            rays, soup)
    return _intersect(rays, soup, bvh, any_hit, shadow_visible, tri_rows)


@torch.no_grad()
def _intersect(rays: Rays, soup: TriSoup, bvh: BVHArrays, any_hit: bool,
               shadow_visible, tri_rows):
    device = rays.tmin.device
    if device.type == "cpu":
        return intersect_bvh_plain(rays, soup, bvh, any_hit, shadow_visible)
    if device.type != "cuda":
        raise ValueError(f"K1 has no kernel for device {device}")
    a = cuda_build.prepare_hit_launch("K1", rays, soup, shadow_visible,
                                      any_hit)
    if bvh.child.dim() != 2 or bvh.child.shape[1] != 8:
        raise ValueError("K1: child must be [n_nodes, 8]")
    nodes = scene_nodes(bvh)
    if tri_rows is None:
        tri_rows = pack_tris(soup)
    cuda_build.check_inputs("K1 node records", device, nodes.records.numel(),
                            nodes.records, dtype=torch.int32)
    cuda_build.check_inputs("K1 triangle rows", device, a.n_tris * TRI_ROW,
                            tri_rows)
    for what, t in (("node records", nodes.records),
                    ("triangle rows", tri_rows)):
        if t.data_ptr() % 16:
            raise ValueError(f"K1: {what} not 16-byte aligned")
    if a.n:
        cuda_build.launch("K1 bvh_walk", counts, _kernel(), *a.rays, a.n,
                          tri_rows.data_ptr(), a.vis,
                          nodes.records.data_ptr(), nodes.root, int(any_hit),
                          *a.outs, _counters(device).data_ptr(), a.stream)
    return a.result
