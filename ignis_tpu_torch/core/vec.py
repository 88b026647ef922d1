"""SoA 3-vector / color math on torch tensors.

Port of ignis_tpu/core/vec.py. Vectors stay structs-of-arrays (three
equally-shaped float32 tensors) at every public function, so the port's
modules compare like for like with the JAX package and each CUDA kernel
takes one pointer per component.
"""
from __future__ import annotations

from typing import NamedTuple, Union

import torch

Tensor = torch.Tensor
Scalar = Union[float, Tensor]


class Vec2(NamedTuple):
    x: Tensor
    y: Tensor


class Vec3(NamedTuple):
    x: Tensor
    y: Tensor
    z: Tensor

    def __add__(self, o: "Vec3") -> "Vec3":
        return Vec3(self.x + o.x, self.y + o.y, self.z + o.z)

    def __sub__(self, o: "Vec3") -> "Vec3":
        return Vec3(self.x - o.x, self.y - o.y, self.z - o.z)

    def __mul__(self, s: Scalar) -> "Vec3":
        return Vec3(self.x * s, self.y * s, self.z * s)

    def __rmul__(self, s: Scalar) -> "Vec3":
        return Vec3(self.x * s, self.y * s, self.z * s)

    def __neg__(self) -> "Vec3":
        return Vec3(-self.x, -self.y, -self.z)


def dot(a: Vec3, b: Vec3) -> Tensor:
    return a.x * b.x + a.y * b.y + a.z * b.z


def cross(a: Vec3, b: Vec3) -> Vec3:
    return Vec3(a.y * b.z - a.z * b.y,
                a.z * b.x - a.x * b.z,
                a.x * b.y - a.y * b.x)


def length(a: Vec3) -> Tensor:
    return torch.sqrt(torch.clamp(dot(a, a), min=1e-24))


def safe_div(a, b):
    """a/b with 0 where b == 0 (reference safe_div semantics)."""
    zero = b == 0
    return torch.where(zero, 0.0, a / torch.where(zero, 1.0, b))


def normalize(a: Vec3) -> Vec3:
    l2 = dot(a, a)
    il = torch.where(l2 > 0, 1.0 / torch.sqrt(torch.clamp(l2, min=1e-12)),
                     0.0)
    return a * il


def vselect(m: Tensor, a: Vec3, b: Vec3) -> Vec3:
    return Vec3(torch.where(m, a.x, b.x), torch.where(m, a.y, b.y),
                torch.where(m, a.z, b.z))


class Color(NamedTuple):
    r: Tensor
    g: Tensor
    b: Tensor

    def __add__(self, o: "Color") -> "Color":
        return Color(self.r + o.r, self.g + o.g, self.b + o.b)

    def __mul__(self, s: Scalar) -> "Color":
        return Color(self.r * s, self.g * s, self.b * s)

    def __rmul__(self, s: Scalar) -> "Color":
        return Color(self.r * s, self.g * s, self.b * s)

    def cmul(self, o: "Color") -> "Color":
        return Color(self.r * o.r, self.g * o.g, self.b * o.b)


def black_like(t: Tensor) -> Color:
    z = torch.zeros_like(t, dtype=torch.float32)
    return Color(z, z, z)


def white_like(t: Tensor) -> Color:
    o = torch.ones_like(t, dtype=torch.float32)
    return Color(o, o, o)


def color_max_component(c: Color) -> Tensor:
    return torch.maximum(c.r, torch.maximum(c.g, c.b))


def cselect(m: Tensor, a: Color, b: Color) -> Color:
    return Color(torch.where(m, a.r, b.r), torch.where(m, a.g, b.g),
                 torch.where(m, a.b, b.b))


def saturate(c: Color, mx) -> Color:
    """Clamp each channel to [0, mx] (reference color_saturate)."""
    return Color(torch.clamp(c.r, 0.0, mx), torch.clamp(c.g, 0.0, mx),
                 torch.clamp(c.b, 0.0, mx))
