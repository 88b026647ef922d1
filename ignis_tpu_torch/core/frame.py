"""Orthonormal shading frames (port of ignis_tpu/core/frame.py).

Duff et al. 2017 branchless ONB, as the JAX package builds it, and the
normal-map reflection fix-up `ensure_valid_reflection`.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .vec import Vec3, dot, normalize, vselect


class Frame(NamedTuple):
    """Orthonormal basis: t (tangent), b (bitangent), n (normal = +Z)."""
    t: Vec3
    b: Vec3
    n: Vec3

    def to_world(self, v: Vec3) -> Vec3:
        return Vec3(
            self.t.x * v.x + self.b.x * v.y + self.n.x * v.z,
            self.t.y * v.x + self.b.y * v.y + self.n.y * v.z,
            self.t.z * v.x + self.b.z * v.y + self.n.z * v.z,
        )

    def to_local(self, v: Vec3) -> Vec3:
        return Vec3(dot(self.t, v), dot(self.b, v), dot(self.n, v))


def make_frame(n: Vec3) -> Frame:
    sign = torch.copysign(torch.ones_like(n.z), n.z)
    a = -1.0 / (sign + n.z)
    b = n.x * n.y * a
    t = Vec3(1.0 + sign * n.x * n.x * a, sign * b, -sign * n.x)
    bt = Vec3(b, sign + n.y * n.y * a, -n.y)
    return Frame(t, bt, n)


def _sqrt0(a):
    """sqrt(max(a, 0)) whose slope stays finite where a <= 0 (reverse mode
    through an unselected branch would otherwise give inf * 0 = NaN)."""
    pos = a > 0.0
    return torch.where(pos, torch.sqrt(torch.where(pos, a, 1.0)), 0.0)


def ensure_valid_reflection(ng: Vec3, i: Vec3, n: Vec3) -> Vec3:
    """Nudge a perturbed shading normal n so the reflection of the view
    direction i (pointing away from the surface) stays outside the
    geometric surface ng: the branchless Blender-Cycles algorithm of the
    reference (sampling.art:120-167), as ignis_tpu/core/frame.py has it."""
    d_ni = dot(n, i)
    r = Vec3(2.0 * d_ni * n.x - i.x, 2.0 * d_ni * n.y - i.y,
             2.0 * d_ni * n.z - i.z)
    threshold = torch.clamp(0.9 * dot(ng, i), max=0.01)
    ok = dot(ng, r) >= threshold

    nd = dot(n, ng)
    xr = Vec3(n.x - ng.x * nd, n.y - ng.y * nd, n.z - ng.z * nd)
    inv = 1.0 / torch.clamp(_sqrt0(dot(xr, xr)), min=1e-12)
    x = Vec3(xr.x * inv, xr.y * inv, xr.z * inv)

    ix = dot(i, x)
    iz = dot(i, ng)
    ix2, iz2 = ix * ix, iz * iz
    a = ix2 + iz2
    b = _sqrt0(ix2 * (a - threshold * threshold))
    c = iz * threshold + a
    fac = 0.5 / torch.clamp(a, min=1e-12)
    n1_z2 = fac * (b + c)
    n2_z2 = fac * (-b + c)
    valid1 = (n1_z2 > 1e-5) & (n1_z2 <= 1.0 + 1e-5)
    valid2 = (n2_z2 > 1e-5) & (n2_z2 <= 1.0 + 1e-5)

    n1 = (_sqrt0(1.0 - n1_z2), _sqrt0(n1_z2))
    n2 = (_sqrt0(1.0 - n2_z2), _sqrt0(n2_z2))
    r1 = 2.0 * (n1[0] * ix + n1[1] * iz) * n1[1] - iz
    r2 = 2.0 * (n2[0] * ix + n2[1] * iz) * n2[1] - iz
    pick1_both = torch.where((r1 >= 1e-5) & (r2 >= 1e-5), r1 < r2, r1 > r2)
    both = valid1 & valid2
    either = (~both) & (valid1 | valid2)
    ne_z2 = torch.where(valid1, n1_z2, n2_z2)
    ne = (_sqrt0(1.0 - ne_z2), _sqrt0(ne_z2))

    new_x = torch.where(both, torch.where(pick1_both, n1[0], n2[0]),
                        torch.where(either, ne[0], 0.0))
    new_z = torch.where(both, torch.where(pick1_both, n1[1], n2[1]),
                        torch.where(either, ne[1], 1.0))
    out = Vec3(x.x * new_x + ng.x * new_z, x.y * new_x + ng.y * new_z,
               x.z * new_x + ng.z * new_z)
    return vselect(ok, n, normalize(out))
