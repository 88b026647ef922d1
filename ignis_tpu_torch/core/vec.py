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


def _safe_div(a, b):
    zero = b == 0
    return torch.where(zero, 0.0, a / torch.where(zero, 1.0, b))


class _SafeDiv(torch.autograd.Function):
    """safe_div whose backward gives a lane with a zero cotangent a zero
    gradient: autograd's own a/b backward forms g * a / b^2, which is
    0 * inf = NaN where b is tiny but not 0, as it is on lanes that a
    later select masks out (a refraction Jacobian at grazing angles)."""

    @staticmethod
    def forward(ctx, a, b):
        q = _safe_div(a, b)
        ctx.save_for_backward(b, q)
        return q

    @staticmethod
    def backward(ctx, g):
        b, q = ctx.saved_tensors
        live = (g != 0) & (b != 0)
        gb = torch.where(live, b, 1.0)
        ga = torch.where(live, g / gb, 0.0)
        return ga, torch.where(live, -ga * q, 0.0)


def safe_div(a, b):
    """a/b with 0 where b == 0 (reference safe_div semantics); in reverse
    mode a lane whose cotangent is 0 gets no gradient (_SafeDiv)."""
    if torch.is_grad_enabled() and any(
            isinstance(x, torch.Tensor) and x.requires_grad for x in (a, b)):
        dev = (a if isinstance(a, torch.Tensor) else b).device
        a, b = torch.broadcast_tensors(_f32_on(a, dev), _f32_on(b, dev))
        return _SafeDiv.apply(a, b)
    return _safe_div(a, b)


def _f32_on(x, device) -> torch.Tensor:
    """x as an f32 tensor on `device`; a Python number by a fill there,
    not a copy from host memory (which would sync the host, and which a
    CUDA graph cannot capture)."""
    if isinstance(x, torch.Tensor):
        return x.to(dtype=torch.float32, device=device)
    return torch.full((), x, dtype=torch.float32, device=device)


def normalize(a: Vec3) -> Vec3:
    l2 = dot(a, a)
    il = torch.where(l2 > 0, 1.0 / torch.sqrt(torch.clamp(l2, min=1e-12)),
                     0.0)
    return a * il


def reflect(i: Vec3, n: Vec3) -> Vec3:
    """Reflect direction `i` (pointing away from the surface) about n."""
    return n * (2.0 * dot(i, n)) - i


def lerp(a, b, t):
    return a + (b - a) * t


def vselect(m: Tensor, a: Vec3, b: Vec3) -> Vec3:
    return Vec3(torch.where(m, a.x, b.x), torch.where(m, a.y, b.y),
                torch.where(m, a.z, b.z))


class Color(NamedTuple):
    r: Tensor
    g: Tensor
    b: Tensor

    def __add__(self, o: "Color") -> "Color":
        return Color(self.r + o.r, self.g + o.g, self.b + o.b)

    def __sub__(self, o: "Color") -> "Color":
        return Color(self.r - o.r, self.g - o.g, self.b - o.b)

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


def luminance(c: Color) -> Tensor:
    """Rec. 709 weights (reference color_luminance)."""
    return 0.2126 * c.r + 0.7152 * c.g + 0.0722 * c.b


def color_max_component(c: Color) -> Tensor:
    return torch.maximum(c.r, torch.maximum(c.g, c.b))


def cselect(m: Tensor, a: Color, b: Color) -> Color:
    return Color(torch.where(m, a.r, b.r), torch.where(m, a.g, b.g),
                 torch.where(m, a.b, b.b))


def clerp(a: Color, b: Color, t) -> Color:
    return Color(lerp(a.r, b.r, t), lerp(a.g, b.g, t), lerp(a.b, b.b, t))


def saturate(c: Color, mx) -> Color:
    """Clamp each channel to [0, mx] (reference color_saturate)."""
    return Color(torch.clamp(c.r, 0.0, mx), torch.clamp(c.g, 0.0, mx),
                 torch.clamp(c.b, 0.0, mx))


def i32_saturate(x: Tensor) -> Tensor:
    """jnp's astype(int32) of a float tensor: truncation toward zero,
    saturating at the int32 range with NaN -> 0 (XLA's conversion), as
    int64 values. A plain .to(torch.int32) of NaN or inf is undefined and
    differs between the CPU and CUDA."""
    x = torch.where(torch.isnan(x), 0.0, torch.clamp(x, -3.0e9, 3.0e9))
    return torch.clamp(x.to(torch.int64), -2 ** 31, 2 ** 31 - 1)
