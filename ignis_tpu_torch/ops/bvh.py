"""BVH8 arrays and the plain lockstep traversal (K1's plain version).

Port of ignis_tpu/ops/bvh.py: the whole ray wavefront advances in
lockstep; each step every live lane pops a node, slab-tests its 8
children, pushes the hits (inner nodes and leaves alike) and intersects
up to LEAF_SIZE triangles of a popped leaf. Kept faithful to the JAX walk,
including its 48-slot stack that overwrites the top slot on overflow and
its walk-order tie break, so it checks the JAX package and the kernel
(ops/bvh_cuda.py) alike. Child encoding (bvh/builder.py): 0 = empty,
> 0 = inner node, < 0 = leaf with start = (-c-1) >> 4, count = (-c-1) & 15.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.vec import Vec3
from .intersect import FLT_MAX, Hit, Rays, TriSoup, moeller_trumbore

STACK = 48
WIDTH = 8
LEAF_SIZE = 4


class BVHArrays(NamedTuple):
    """Tri-leaf BVH8 on the device: [n_nodes, 8] SoA child boxes and
    child references."""
    cmin_x: torch.Tensor
    cmin_y: torch.Tensor
    cmin_z: torch.Tensor
    cmax_x: torch.Tensor
    cmax_y: torch.Tensor
    cmax_z: torch.Tensor
    child: torch.Tensor


def _inv_dir(d):
    return torch.where(torch.abs(d) > 1e-12, 1.0 / d, 1e12)


def intersect_bvh_plain(rays: Rays, soup: TriSoup, bvh: BVHArrays,
                        any_hit: bool = False, shadow_visible=None):
    """Closest-hit Hit, or any-hit bool occlusion mask."""
    device = rays.tmin.device
    n = rays.tmin.shape[0]
    n_tris = soup.v0.x.shape[0]
    inv_dx, inv_dy, inv_dz = (_inv_dir(a) for a in rays.dir)
    lane = torch.arange(n, device=device)
    stack = torch.zeros((n, STACK), dtype=torch.int32, device=device)
    sp = torch.ones(n, dtype=torch.int32, device=device)
    t_best = torch.clamp(rays.tmax, max=FLT_MAX)
    prim = torch.full((n,), -1, dtype=torch.int32, device=device)
    u = torch.zeros(n, dtype=torch.float32, device=device)
    v = torch.zeros(n, dtype=torch.float32, device=device)
    occ = torch.zeros(n, dtype=torch.bool, device=device)
    o = Vec3(*[a[:, None] for a in rays.org])
    tmin_c = rays.tmin[:, None]

    while True:
        live = sp > 0
        if any_hit:
            live = live & ~occ
        if not bool(live.any()):
            break
        sp1 = torch.clamp(sp - 1, min=0)
        node = stack[lane, sp1.long()]
        sp = torch.where(live, sp1, sp)
        is_leaf = node < 0
        inner = torch.clamp(node, min=0).long()

        def g(a):
            return a[inner]
        t0x = (g(bvh.cmin_x) - o.x) * inv_dx[:, None]
        t1x = (g(bvh.cmax_x) - o.x) * inv_dx[:, None]
        t0y = (g(bvh.cmin_y) - o.y) * inv_dy[:, None]
        t1y = (g(bvh.cmax_y) - o.y) * inv_dy[:, None]
        t0z = (g(bvh.cmin_z) - o.z) * inv_dz[:, None]
        t1z = (g(bvh.cmax_z) - o.z) * inv_dz[:, None]
        tnear = torch.maximum(
            torch.maximum(torch.minimum(t0x, t1x), torch.minimum(t0y, t1y)),
            torch.maximum(torch.minimum(t0z, t1z), tmin_c))
        tfar = torch.minimum(
            torch.minimum(torch.maximum(t0x, t1x), torch.maximum(t0y, t1y)),
            torch.minimum(torch.maximum(t0z, t1z), t_best[:, None]))
        cref = g(bvh.child)
        hit_child = ((tnear <= tfar) & (cref != 0) & live[:, None]
                     & (~is_leaf)[:, None])
        for j in range(WIDTH):
            m = hit_child[:, j]
            slot = torch.clamp(sp, max=STACK - 1).long()
            stack[lane, slot] = torch.where(m, cref[:, j], stack[lane, slot])
            sp = sp + m.to(torch.int32)

        lv = -node - 1
        start = lv >> 4
        count = lv & 15
        for k in range(LEAF_SIZE):
            ti = torch.clamp(start + k, 0, n_tris - 1).long()
            va = Vec3(*[a[ti] for a in soup.v0])
            ea = Vec3(*[a[ti] for a in soup.e1])
            eb = Vec3(*[a[ti] for a in soup.e2])
            tt, uu, vv, ok = moeller_trumbore(rays.org, rays.dir, va, ea, eb)
            ok = (ok & (tt > rays.tmin) & (tt < t_best) & is_leaf & live
                  & (k < count))
            if shadow_visible is not None:
                ok = ok & shadow_visible[ti]
            if any_hit:
                occ = occ | ok
            else:
                t_best = torch.where(ok, tt, t_best)
                prim = torch.where(ok, ti.to(torch.int32), prim)
                u = torch.where(ok, uu, u)
                v = torch.where(ok, vv, v)
    if any_hit:
        return occ
    return Hit(torch.where(prim >= 0, t_best, FLT_MAX), prim, u, v)
