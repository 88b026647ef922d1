"""Fixed-winner backward of the closest-hit kernels K1 and K2.

Port of the two identical VJPs of the JAX package,
ignis_tpu/ops/pallas_isect.py::_closest_bwd and
ignis_tpu/ops/pallas_bvh.py::_bvh_closest_bwd: the forward kernel picks
each ray's winning triangle, and the backward replays Moeller-Trumbore at
that fixed winner and differentiates it (`_mt_terms`, pallas_isect.py:133).
Rays that miss get no gradient.

`ClosestHit` is the torch.autograd.Function around a closest-hit launch.
Its backward launches `csrc/mt_replay_bwd.cu` for tensors on the card
(one thread per ray: recompute, hand-written adjoint, per-ray gradients
stored, soup gradients summed per winner in the warp and atomically added
into one [3, T, 4] buffer, returned as nine strided [T] columns) and takes
`mt_replay_bwd_plain` for tensors on the CPU: the same adjoint in torch
(`mt_adjoint`), in the kernel's operation order. `counts` holds the
kernel's launches and the plain version's calls.

The replay follows JAX's recompute, not the forward kernels: it divides by
det unless |det| < MT_EPS = 1e-9, where the forward rejects |det| <= 1e-16
(ops/intersect.py:23).
"""
from __future__ import annotations

import ctypes

import torch

from ..core.vec import Vec3, cross, dot
from . import cuda_build
from .intersect import Hit, Rays, TriSoup

MT_EPS = 1e-9
counts = cuda_build.Counts()
reset_counts = counts.reset
# 6 ray arrays, 9 soup arrays, prim, gt, gu, gv, 6 ray grads, the
# [3, T, 4] soup-gradient buffer, T, n, stream
_ARGTYPES = ([ctypes.c_void_p] * 26 + [ctypes.c_int] * 2
             + [ctypes.c_void_p])


def _kernel():
    return cuda_build.load_kernel("mt_replay_bwd", "ig_mt_replay_bwd",
                                  _ARGTYPES)


def build() -> None:
    """Compile (or load) the kernel library."""
    _kernel()


def mt_terms(ox, oy, oz, dx, dy, dz,
             v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z):
    """Differentiable Moeller-Trumbore, term for term as _mt_terms
    (broadcasting); returns (t, u, v, det)."""
    pvx = dy * e2z - dz * e2y                                 # d x e2
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    tvx = ox - v0x
    tvy = oy - v0y
    tvz = oz - v0z
    qvx = tvy * e1z - tvz * e1y                               # tvec x e1
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    inv_det = 1.0 / torch.where(torch.abs(det) < MT_EPS, 1.0, det)
    u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
    v = (dx * qvx + dy * qvy + dz * qvz) * inv_det
    t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det
    return t, u, v, det


def _flat(rays_or_arrays):
    return [a.contiguous() for a in rays_or_arrays]


def mt_adjoint(o: Vec3, d: Vec3, v0: Vec3, e1: Vec3, e2: Vec3, gt, gu, gv):
    """Reverse mode of mt_terms' (t, u, v) at cotangents (gt, gu, gv),
    written out in csrc/mt_replay_bwd.cu's operation order, so that on the
    same inputs the kernel (built with -fmad=false) and this agree bit for
    bit. Returns (d org, d dir, d v0, d e1, d e2)."""
    p = cross(d, e2)
    det = dot(e1, p)
    s = o - v0
    q = cross(s, e1)
    tiny = torch.abs(det) < MT_EPS
    inv = 1.0 / torch.where(tiny, 1.0, det)
    u = dot(s, p) * inv
    v = dot(d, q) * inv
    t = dot(e2, q) * inv
    a_t, a_u, a_v = gt * inv, gu * inv, gv * inv
    g_det = torch.where(tiny, 0.0, -(gt * t + gu * u + gv * v) * inv)
    dq = Vec3(*[a_t * x + a_v * y for x, y in zip(e2, d)])
    dp = Vec3(*[a_u * x + g_det * y for x, y in zip(s, e1)])
    ds = p * a_u + cross(e1, dq)
    dd = q * a_v + cross(e2, dp)
    de1 = p * g_det + cross(dq, s)
    de2 = q * a_t + cross(dp, d)
    return ds, dd, -ds, de1, de2


def mt_replay_bwd_plain(ray_arrays, soup_arrays, prim, gt, gu, gv):
    """Plain torch version: gather each ray's winner, run mt_adjoint, and
    index_add_ the soup gradients into [T]. ray_arrays: org xyz, dir xyz
    ([N]); soup_arrays: v0, e1, e2 xyz ([T]). Returns (6 ray gradients,
    9 soup gradients); rays with prim < 0 get zeros and add nothing.

    The adjoint is written out rather than taken with torch.autograd of
    mt_terms: the two are the same derivative, but their sums run in other
    orders, and at small, distant triangles (S1's) they then part by more
    than 1e-5 relative on about one ray in a hundred."""
    counts["plain_calls"] += 1
    n_tris = soup_arrays[0].shape[0]
    hit = prim >= 0
    p = torch.clamp(prim, 0, max(n_tris - 1, 0)).long()
    rows = [a[p] for a in soup_arrays]
    cts = [torch.where(hit, g, 0.0) for g in (gt, gu, gv)]
    grads = mt_adjoint(Vec3(*ray_arrays[:3]), Vec3(*ray_arrays[3:]),
                       Vec3(*rows[:3]), Vec3(*rows[3:6]), Vec3(*rows[6:]),
                       *cts)
    grads = [torch.where(hit, g, 0.0) for v in grads for g in v]
    soup_grads = [torch.zeros_like(a).index_add_(0, p, g)
                  for a, g in zip(soup_arrays, grads[6:])]
    return grads[:6], soup_grads


def mt_replay_bwd(ray_arrays, soup_arrays, prim, gt, gu, gv):
    """The fixed-winner backward: the CUDA kernel for tensors on the card,
    the plain version for tensors on the CPU."""
    device = prim.device
    if device.type == "cpu":
        return mt_replay_bwd_plain(ray_arrays, soup_arrays, prim, gt, gu, gv)
    if device.type != "cuda":
        raise ValueError(f"MT replay has no kernel for device {device}")
    n = prim.numel()
    rays = _flat(ray_arrays)
    soup = _flat(soup_arrays)
    cts = _flat((gt, gu, gv))
    cuda_build.check_inputs("MT replay rays", device, n, *rays, *cts)
    cuda_build.check_inputs("MT replay soup", device, soup[0].numel(), *soup)
    prim = prim.contiguous()
    cuda_build.check_inputs("MT replay prim", device, n, prim,
                            dtype=torch.int32)
    ray_grads = [torch.empty_like(a) for a in rays]
    n_tris = soup[0].numel()
    buf = torch.zeros((3, n_tris, 4), dtype=torch.float32, device=device)
    if n:
        cuda_build.launch(
            "MT replay backward", counts, _kernel(),
            *[a.data_ptr() for a in rays], *[a.data_ptr() for a in soup],
            prim.data_ptr(), *[a.data_ptr() for a in cts],
            *[a.data_ptr() for a in ray_grads], buf.data_ptr(), n_tris, n,
            torch.cuda.current_stream(device).cuda_stream)
    return ray_grads, [buf[i, :, j] for i in range(3) for j in range(3)]


def _arrays(rays: Rays, soup: TriSoup):
    return [*rays.org, *rays.dir], [*soup.v0, *soup.e1, *soup.e2]


def wants_grad(rays: Rays, soup: TriSoup) -> bool:
    """Whether a closest-hit query must record its backward: grad mode is
    on and a ray or soup array requires grad."""
    if not torch.is_grad_enabled():
        return False
    ray_arrays, soup_arrays = _arrays(rays, soup)
    return any(a.requires_grad for a in ray_arrays + soup_arrays)


class ClosestHit(torch.autograd.Function):
    """Closest hit with the fixed-winner backward. `forward_fn(rays,
    soup)` is the K1 or K2 wrapper's direct call; it runs on detached
    inputs. Differentiable in org, dir and the soup; tmin and tmax get no
    gradient and prim none either."""

    @staticmethod
    def forward(ctx, forward_fn, tmin, tmax, *arrays):
        ray_arrays, soup_arrays = list(arrays[:6]), list(arrays[6:])
        rays = Rays(Vec3(*ray_arrays[:3]), Vec3(*ray_arrays[3:]), tmin, tmax)
        soup = TriSoup(Vec3(*soup_arrays[:3]), Vec3(*soup_arrays[3:6]),
                       Vec3(*soup_arrays[6:]))
        hit = forward_fn(rays, soup)
        ctx.save_for_backward(*arrays, hit.prim)
        ctx.mark_non_differentiable(hit.prim)
        return tuple(hit)

    @staticmethod
    def backward(ctx, gt, _gprim, gu, gv):
        saved = ctx.saved_tensors
        arrays, prim = saved[:15], saved[15]
        ray_grads, soup_grads = mt_replay_bwd(arrays[:6], arrays[6:], prim,
                                              gt, gu, gv)
        return (None, None, None, *ray_grads, *soup_grads)


def closest_hit(forward_fn, rays: Rays, soup: TriSoup) -> Hit:
    """`forward_fn(rays, soup)` recorded for reverse mode (ClosestHit)."""
    ray_arrays, soup_arrays = _arrays(rays, soup)
    return Hit(*ClosestHit.apply(forward_fn, rays.tmin, rays.tmax,
                                 *ray_arrays, *soup_arrays))
