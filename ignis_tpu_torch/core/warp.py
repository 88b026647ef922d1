"""Sampling warps (port of ignis_tpu/core/warp.py)."""
from __future__ import annotations

import numpy as _np
import torch

from .vec import Vec2, Vec3, safe_div

# Python floats rounded to float32, as in the JAX package.
PI = float(_np.float32(_np.pi))
TWO_PI = float(_np.float32(2.0 * _np.pi))
INV_PI = float(_np.float32(1.0 / _np.pi))
INV_2PI = float(_np.float32(1.0 / (2.0 * _np.pi)))
INV_4PI = float(_np.float32(1.0 / (4.0 * _np.pi)))


def safe_sqrt(x):
    return torch.sqrt(torch.clamp(x, min=1e-24))


def _from_theta_phi(c, s, phi):
    return Vec3(s * torch.cos(phi), s * torch.sin(phi), c)


def spherical_from_dir(d: Vec3):
    """Return (theta, phi) with theta in [0,pi] from +Z, phi in [0,2pi)."""
    theta = torch.arccos(torch.clamp(d.z, -1.0 + 1e-7, 1.0 - 1e-7))
    phi = torch.arctan2(d.y, d.x)
    phi = torch.where(phi < 0, phi + TWO_PI, phi)
    return theta, phi


def dir_from_spherical(theta, phi) -> Vec3:
    s = torch.sin(theta)
    return Vec3(s * torch.cos(phi), s * torch.sin(phi), torch.cos(theta))


def uniform_sphere_pdf():
    return INV_4PI


def sample_uniform_sphere(u, v):
    c = 2.0 * v - 1.0
    s = safe_sqrt(1.0 - c * c)
    phi = TWO_PI * u
    return _from_theta_phi(c, s, phi), torch.full_like(u, INV_4PI)


def cosine_hemisphere_pdf(c):
    return c * INV_PI


def sample_cosine_hemisphere(u, v):
    c = safe_sqrt(v)
    s = safe_sqrt(1.0 - v)
    phi = TWO_PI * u
    return _from_theta_phi(c, s, phi), cosine_hemisphere_pdf(c)


def sample_uniform_hemisphere(u, v):
    c = v
    s = safe_sqrt(1.0 - c * c)
    phi = TWO_PI * u
    return _from_theta_phi(c, s, phi), torch.full_like(u, INV_2PI)


def cosine_power_hemisphere_pdf(c, k):
    return torch.pow(torch.clamp(c, min=1e-6), k) * (k + 1.0) * INV_2PI


def sample_cosine_power_hemisphere(k, u, v):
    c = torch.clamp(torch.pow(v, 1.0 / (k + 1.0)), max=1.0)
    s = safe_sqrt(1.0 - c * c)
    phi = TWO_PI * u
    pow_c_k = torch.where(c != 0, v / torch.clamp(c, min=1e-30), 0.0)
    pdf = pow_c_k * (k + 1.0) * INV_2PI
    return _from_theta_phi(c, s, phi), pdf


def square_to_concentric_disk(u, v) -> Vec2:
    a = 2.0 * u - 1.0
    b = 2.0 * v - 1.0
    cond = torch.abs(a) > torch.abs(b)
    r = torch.where(cond, a, b)
    safe_r = torch.where(r == 0, 1.0, r)
    phi = torch.where(cond, (PI / 4.0) * (b / safe_r),
                      (PI / 2.0) - (PI / 4.0) * (a / safe_r))
    phi = torch.where(r == 0, 0.0, phi)
    return Vec2(r * torch.cos(phi), r * torch.sin(phi))


def uniform_disk_pdf(radius):
    return 1.0 / (PI * radius * radius)


def uniform_cone_pdf(cos_angle):
    return safe_div(1.0, TWO_PI * (1.0 - cos_angle))


def sample_uniform_cone(u, v, cos_angle):
    """Uniform direction in the cone around +Z (reference sampling.art)."""
    c1 = 1.0 - cos_angle
    p = square_to_concentric_disk(u, v)
    n2 = p.x * p.x + p.y * p.y
    z = cos_angle + c1 * (1.0 - n2)
    scale = safe_sqrt(c1 * (2.0 - c1 * n2))
    return Vec3(p.x * scale, p.y * scale, z), uniform_cone_pdf(cos_angle)


def sample_triangle(u, v):
    """Uniform barycentrics on the unit triangle (mirror-fold variant)."""
    flip = (u + v) > 1.0
    return torch.where(flip, 1.0 - u, u), torch.where(flip, 1.0 - v, v)
