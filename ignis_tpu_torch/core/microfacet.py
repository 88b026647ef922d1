"""GGX microfacet distribution: NDF, Smith G1, vNDF sampling (port of
ignis_tpu/core/microfacet.py).

alpha is the roughness itself, Smith shadowing is separable, visible
normals are sampled by spherical caps, and alpha <= DELTA_ALPHA counts as
a delta distribution. Directions are local (z = shading normal).
"""
from __future__ import annotations

import torch

from .vec import Vec3, dot, normalize, safe_div
from .warp import PI, TWO_PI

DELTA_ALPHA = 1e-4


def ndf_ggx(m: Vec3, au, av):
    """Anisotropic GGX NDF; m in the local frame."""
    kx = m.x / au
    ky = m.y / av
    k = kx * kx + ky * ky + m.z * m.z
    return safe_div(1.0, PI * au * av * k * k)


def g1_smith(w: Vec3, au, av):
    kx = au * w.x
    ky = av * w.y
    a2 = safe_div(kx * kx + ky * ky, w.z * w.z)
    return 2.0 / (1.0 + torch.sqrt(1.0 + a2))


def g_separable(wi: Vec3, wo: Vec3, au, av):
    return g1_smith(wi, au, av) * g1_smith(wo, au, av)


def sample_vndf_ggx(wo: Vec3, au, av, u0, u1) -> Vec3:
    """Visible-normal sample around the local view wo (spherical caps,
    microfacet.art:372); returns the local half vector."""
    s = normalize(Vec3(au * wo.x, av * wo.y, wo.z))
    phi = TWO_PI * u0
    z = (1.0 - u1) * (1.0 + s.z) - s.z
    # sqrt's argument kept off 0, where its slope is infinite
    sin_t = torch.sqrt(torch.clamp(1.0 - z * z, 1e-24, 1.0))
    h = Vec3(sin_t * torch.cos(phi) + s.x, sin_t * torch.sin(phi) + s.y,
             z + s.z)
    return normalize(Vec3(h.x * au, h.y * av, h.z))


def pdf_vndf_ggx(wo: Vec3, h: Vec3, au, av):
    """Half-vector pdf of vNDF sampling (microfacet.art:398)."""
    return safe_div(g1_smith(wo, au, av) * torch.abs(dot(wo, h))
                    * ndf_ggx(h, au, av), torch.abs(wo.z))


def reflective_jacobian(cos_h):
    """dwh -> dwi for reflection (shading.art:69)."""
    return safe_div(1.0, 4.0 * cos_h)


def refractive_jacobian(eta, cos_h_i, cos_h_o):
    """dwh -> dwi for refraction (shading.art:71)."""
    d = cos_h_i + cos_h_o * eta
    return safe_div(eta * eta * cos_h_i, d * d)
