"""Ray-primitive intersection on flat SoA geometry.

Port of ignis_tpu/ops/intersect.py: rays, hits, soups, Moeller-Trumbore,
spheres and `merge_hits`. Dense triangle closest-hit and any-hit are K2
(ops/isect_cuda.py): its CUDA kernel for tensors on the card, its plain
chunked version for tensors on the CPU.

Choices that decide parity, shared by the kernels and the plain versions:
- Moeller-Trumbore rejects |det| <= 1e-16, the JAX CPU path's epsilon
  (intersect.py:59), not the Pallas kernels' 1e-9.
- A miss carries t = FLT_MAX = 3e38 and prim = -1.
- A lane with tmax < tmin is dead and misses every primitive.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.vec import Vec3, cross, dot

FLT_MAX = 3.0e38
DET_EPS = 1e-16


class Rays(NamedTuple):
    org: Vec3   # [N]
    dir: Vec3   # [N]
    tmin: torch.Tensor
    tmax: torch.Tensor


class Hit(NamedTuple):
    t: torch.Tensor      # [N] f32, FLT_MAX if miss
    prim: torch.Tensor   # [N] i32 global primitive id (-1 if miss)
    u: torch.Tensor      # [N] f32 barycentric / param
    v: torch.Tensor      # [N] f32


class TriSoup(NamedTuple):
    """SoA triangle soup (no padding in the port)."""
    v0: Vec3   # [T]
    e1: Vec3   # v1 - v0
    e2: Vec3   # v2 - v0


class SphereSoup(NamedTuple):
    center: Vec3          # [S]
    radius: torch.Tensor  # [S] (<= 0 entries are padding)


def moeller_trumbore(org: Vec3, d: Vec3, v0: Vec3, e1: Vec3, e2: Vec3):
    """Broadcasting MT; returns (t, u, v, ok)."""
    pvec = cross(d, e2)
    det = dot(e1, pvec)
    good = torch.abs(det) > DET_EPS
    inv_det = torch.where(good, 1.0 / torch.where(det == 0, 1.0, det), 0.0)
    tvec = org - v0
    u = dot(tvec, pvec) * inv_det
    qvec = cross(tvec, e1)
    v = dot(d, qvec) * inv_det
    t = dot(e2, qvec) * inv_det
    ok = good & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
    return t, u, v, ok


def intersect_spheres_dense(rays: Rays, spheres: SphereSoup,
                            prim_offset: int) -> Hit:
    """Dense ray-sphere closest hit; prim ids offset past the tri soup."""
    n = rays.tmin.shape
    s = spheres.radius.shape[0]
    if s == 0:
        z = torch.zeros(n, dtype=torch.float32, device=rays.tmin.device)
        return Hit(torch.full_like(z, FLT_MAX),
                   torch.full(n, -1, dtype=torch.int32, device=z.device),
                   z, z)
    org = Vec3(*[a[:, None] for a in rays.org])
    d = Vec3(*[a[:, None] for a in rays.dir])
    c = Vec3(*[a[None, :] for a in spheres.center])
    r = spheres.radius[None, :]
    oc = org - c
    a = dot(d, d)
    b = 2.0 * dot(oc, d)
    cc = dot(oc, oc) - r * r
    disc = b * b - 4.0 * a * cc
    ok = (disc >= 0.0) & (r > 0.0)
    # sqrt only where disc > 0, so that reverse mode never meets sqrt's
    # infinite slope at 0 (inf * 0 would be NaN)
    pos = disc > 0.0
    sq = torch.where(pos, torch.sqrt(torch.where(pos, disc, 1.0)), 0.0)
    inv2a = 1.0 / (2.0 * a)
    t0 = (-b - sq) * inv2a
    t1 = (-b + sq) * inv2a
    tmin = rays.tmin[:, None]
    tmax = rays.tmax[:, None]
    t0v = torch.where(ok & (t0 > tmin) & (t0 < tmax), t0, FLT_MAX)
    t1v = torch.where(ok & (t1 > tmin) & (t1 < tmax), t1, FLT_MAX)
    t = torch.minimum(t0v, t1v)
    j = torch.argmin(t, dim=-1)
    t_j = torch.gather(t, 1, j[:, None])[:, 0]
    hit = t_j < FLT_MAX
    zero = torch.zeros_like(t_j)
    return Hit(torch.where(hit, t_j, FLT_MAX),
               torch.where(hit, (prim_offset + j).to(torch.int32), -1)
               .to(torch.int32), zero, zero)


def merge_hits(a: Hit, b: Hit) -> Hit:
    take_b = b.t < a.t
    return Hit(torch.where(take_b, b.t, a.t),
               torch.where(take_b, b.prim, a.prim),
               torch.where(take_b, b.u, a.u),
               torch.where(take_b, b.v, a.v))
