"""Orthonormal shading frames (port of ignis_tpu/core/frame.py).

Duff et al. 2017 branchless ONB, as the JAX package builds it. The
normal-map reflection fix-up (`ensure_valid_reflection`) belongs to bump
mapping, which the slice does not carry.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .vec import Vec3, dot


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
