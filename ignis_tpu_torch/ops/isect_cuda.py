"""K2: dense closest-hit / any-hit, CUDA kernel and plain version.

The kernel (csrc/isect_dense.cu) replaces
ignis_tpu/ops/pallas_isect.py::_isect_kernel. `intersect_tris` launches it
for rays on a CUDA device and raises if it cannot; for rays on the CPU it
takes `intersect_tris_plain`, a loop over 256-triangle chunks like
ignis_tpu/ops/intersect.py:130-213. `counts` holds the kernel's launch
count and the plain version's call count.
"""
from __future__ import annotations

import ctypes

import torch

from ..core.vec import Vec3
from . import cuda_build
from .intersect import FLT_MAX, Hit, Rays, TriSoup, moeller_trumbore

CHUNK = 256
counts = cuda_build.Counts()
reset_counts = counts.reset
_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] + [ctypes.c_void_p] * 10
             + [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 6)


def _kernel():
    return cuda_build.load_kernel("isect_dense", "ig_isect_dense", _ARGTYPES)


def build() -> None:
    """Compile (or load) the kernel library."""
    _kernel()


def intersect_tris(rays: Rays, soup: TriSoup, shadow_visible=None,
                   any_hit: bool = False):
    """Closest hit (a Hit) or any-hit occlusion (a bool tensor) of every
    ray against the whole soup. `shadow_visible` ([T] bool) gates the
    any-hit test."""
    device = rays.tmin.device
    if device.type == "cpu":
        return intersect_tris_plain(rays, soup, shadow_visible, any_hit)
    if device.type != "cuda":
        raise ValueError(f"K2 has no kernel for device {device}")
    a = cuda_build.prepare_hit_launch("K2", rays, soup, shadow_visible,
                                      any_hit)
    if a.n:
        cuda_build.launch("K2 isect_dense", counts, _kernel(), *a.rays, a.n,
                          *a.tris, a.vis, a.n_tris, int(any_hit), *a.outs,
                          a.stream)
    return a.result


def intersect_tris_plain(rays: Rays, soup: TriSoup, shadow_visible=None,
                         any_hit: bool = False):
    """Plain torch version: a loop over CHUNK-triangle chunks with an
    argmin per chunk (lowest prim on equal t)."""
    counts["plain_calls"] += 1
    device = rays.tmin.device
    n = rays.tmin.shape[0]
    n_tris = soup.v0.x.shape[0]
    org = Vec3(*[a[:, None] for a in rays.org])
    d = Vec3(*[a[:, None] for a in rays.dir])
    tmin = rays.tmin[:, None]
    tmax = rays.tmax[:, None]
    if any_hit:
        occ = torch.zeros(n, dtype=torch.bool, device=device)
    else:
        best_t = torch.full((n,), FLT_MAX, dtype=torch.float32, device=device)
        best_p = torch.full((n,), -1, dtype=torch.int32, device=device)
        best_u = torch.zeros(n, dtype=torch.float32, device=device)
        best_v = torch.zeros(n, dtype=torch.float32, device=device)
    for c0 in range(0, n_tris, CHUNK):
        sl = slice(c0, min(c0 + CHUNK, n_tris))
        v0 = Vec3(*[a[None, sl] for a in soup.v0])
        e1 = Vec3(*[a[None, sl] for a in soup.e1])
        e2 = Vec3(*[a[None, sl] for a in soup.e2])
        t, u, v, ok = moeller_trumbore(org, d, v0, e1, e2)
        ok = ok & (t > tmin) & (t < tmax)
        if any_hit:
            if shadow_visible is not None:
                ok = ok & shadow_visible[None, sl]
            occ = occ | ok.any(dim=1)
            continue
        ok = ok & (t < best_t[:, None])
        t_masked = torch.where(ok, t, FLT_MAX)
        j = torch.argmin(t_masked, dim=1, keepdim=True)
        t_j = torch.gather(t_masked, 1, j)[:, 0]
        got = t_j < best_t
        best_t = torch.where(got, t_j, best_t)
        best_p = torch.where(got, (c0 + j[:, 0]).to(torch.int32), best_p)
        best_u = torch.where(got, torch.gather(u, 1, j)[:, 0], best_u)
        best_v = torch.where(got, torch.gather(v, 1, j)[:, 0], best_v)
    if any_hit:
        return occ
    return Hit(best_t, best_p, best_u, best_v)
