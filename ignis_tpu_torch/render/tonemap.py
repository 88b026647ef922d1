"""Tonemapping and image statistics (port of ignis_tpu/render/tonemap.py).

Operators on luminance in xyY space (none, reinhard, modified reinhard,
ACES, uncharted2) and on RGB (agx, pbr-neutral), the sRGB gamma, special
colours for NaN / inf / negative pixels, and `image_info` (min, max,
average, soft percentiles, median, histograms, error counts). Plain torch
on the image's device: the JAX package computes them with jnp outside any
Pallas kernel. The 3x3 colour matrices are written as explicit float32
sums, so no TF32 matrix product enters them on the card.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.vec import i32_saturate

# sRGB <-> XYZ (D65)
_RGB2XYZ = ((0.4124564, 0.3575761, 0.1804375),
            (0.2126729, 0.7151522, 0.0721750),
            (0.0193339, 0.1191920, 0.9503041))
_XYZ2RGB = ((3.2404542, -1.5371385, -0.4985314),
            (-0.9692660, 1.8760108, 0.0415560),
            (0.0556434, -0.2040259, 1.0572252))

TONEMAP_METHODS = {"none": 0, "linear": 0, "reinhard": 1,
                   "reinhard_modified": 2, "modified_reinhard": 2,
                   "aces": 3, "uncharted2": 4, "agx": 5, "pbr_neutral": 6}


def _mat3(m, v):
    """m [3x3 python floats] times the last axis of v, as explicit fp32
    sums."""
    a, b, c = v[..., 0], v[..., 1], v[..., 2]
    return torch.stack([r[0] * a + r[1] * b + r[2] * c for r in m], dim=-1)


def _reinhard(l):
    return l / (1.0 + l)


def _reinhard_modified(l):
    lwhite = 4.0
    return l * (1.0 + l / (lwhite * lwhite)) / (1.0 + l)


def _aces(l):
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    return torch.clamp((l * (a * l + b)) / (l * (c * l + d) + e), 0.0, 1.0)


def _uncharted2_partial(x):
    A, B, C, D, E, F = 0.15, 0.50, 0.20, 0.20, 0.02, 0.30
    return ((x * (A * x + C * B) + D * E) / (x * (A * x + B) + D * F)) - E / F


def _uncharted2(l):
    exposure_bias = 2.0
    w = 11.2
    return _uncharted2_partial(l * exposure_bias) / _uncharted2_partial(w)


# the luminance curve of each method; the others keep the luminance
_CURVES = {1: _reinhard, 2: _reinhard_modified, 3: _aces, 4: _uncharted2}


def srgb_gamma(x):
    return torch.where(x <= 0.0031308, 12.92 * x,
                       1.055 * torch.pow(torch.clamp(x, min=1e-8), 1 / 2.4)
                       - 0.055)


def tonemap(img, scale=1.0, exposure_factor=1.0, exposure_offset=0.0,
            method: int = 0, use_gamma: bool = True):
    """img [h, w, 3] linear -> [h, w, 3] in [0, 1] display space.

    NaN -> cyan, inf -> pink, negative -> orange (tonemap.art:25-31)."""
    img = torch.as_tensor(img, dtype=torch.float32)
    rgb = img * scale
    xyz = _mat3(_RGB2XYZ, rgb)
    s = torch.clamp(xyz.sum(-1), min=1e-20)
    x = xyz[..., 0] / s
    y = xyz[..., 1] / s
    L = xyz[..., 1]

    Lp = exposure_factor * L + exposure_offset
    curve = _CURVES.get(method)
    nL = Lp if curve is None else curve(Lp)

    # xyY -> XYZ -> RGB with the new luminance
    denom = torch.clamp(y, min=1e-10)
    X = nL * x / denom
    Z = nL * (1.0 - x - y) / denom
    color = _mat3(_XYZ2RGB, torch.stack([X, nL, Z], dim=-1))

    if method == 5:
        color = _agx(color)
    elif method == 6:
        color = _pbr_neutral(color)

    out = srgb_gamma(torch.clamp(color, min=0.0)) if use_gamma else color
    out = torch.clamp(out, 0.0, 1.0)

    def special(r, g, b):
        return torch.tensor([r, g, b], dtype=torch.float32, device=img.device)
    out = torch.where((img < 0).any(-1, keepdim=True), special(1.0, 1.0, 0.0),
                      out)
    out = torch.where(torch.isinf(img).any(-1, keepdim=True),
                      special(1.0, 0.0, 150 / 255.0), out)
    out = torch.where(torch.isnan(img).any(-1, keepdim=True),
                      special(0.0, 1.0, 1.0), out)
    return out


def _agx(color):
    # minimal AgX: log2 encoding and a sigmoid contrast fit
    lo, hi = -12.47393, 4.026069
    c = torch.clamp((torch.log2(torch.clamp(color, min=1e-10)) - lo)
                    / (hi - lo), 0, 1)
    c2 = c * c
    c4 = c2 * c2
    return (15.5 * c4 * c2 - 40.14 * c4 * c + 31.96 * c4 - 6.868 * c2 * c
            + 0.4298 * c2 + 0.1191 * c - 0.00232)


def _pbr_neutral(color):
    """Khronos PBR-neutral-style highlight compression (simplified)."""
    start = 0.8
    peak = torch.amax(color, dim=-1, keepdim=True)
    d = 1.0 - start
    new_peak = 1.0 - d * d / torch.clamp(peak + d - start, min=1e-6)
    scale = torch.where(peak > start,
                        new_peak / torch.clamp(peak, min=1e-6), 1.0)
    g = 1.0 / (1.3 * torch.clamp(peak - start, min=0.0) + 1.0)
    out = color * scale
    white = torch.ones_like(out) * new_peak
    return out * g + white * (1.0 - g)


class ImageInfo(NamedTuple):
    min: torch.Tensor
    max: torch.Tensor
    average: torch.Tensor
    soft_min: torch.Tensor
    soft_max: torch.Tensor
    median: torch.Tensor
    inf_count: torch.Tensor
    nan_count: torch.Tensor
    neg_count: torch.Tensor
    histogram: torch.Tensor  # [4, bins] r / g / b / luminance


def image_info(img, scale=1.0, bins: int = 64) -> ImageInfo:
    """Whole-image statistics (imageinfo.art:17-144)."""
    img = torch.as_tensor(img, dtype=torch.float32)
    rgb = img * scale
    lum = (0.2126 * rgb[..., 0] + 0.7152 * rgb[..., 1]
           + 0.0722 * rgb[..., 2])
    finite = torch.isfinite(lum)
    safe = torch.where(finite, lum, 0.0)
    lmin = torch.amin(torch.where(finite, lum, float("inf")))
    lmax = torch.amax(torch.where(finite, lum, float("-inf")))
    avg = safe.sum() / torch.clamp(finite.sum(), min=1)
    sorted_l = torch.sort(safe.reshape(-1)).values
    n = sorted_l.shape[0]
    soft_min = sorted_l[max(int(n * 0.01), 0)]
    soft_max = sorted_l[min(int(n * 0.99), n - 1)]
    median = sorted_l[n // 2]
    inf_count = torch.isinf(rgb).sum()
    nan_count = torch.isnan(rgb).sum()
    neg_count = (rgb < 0).sum()

    lo = soft_min
    hi = torch.maximum(soft_max, lo + 1e-6)

    def hist(ch):
        idx = torch.clamp(i32_saturate((ch - lo) / (hi - lo) * bins), 0,
                          bins - 1)
        return torch.bincount(idx.reshape(-1), minlength=bins)
    histogram = torch.stack([hist(rgb[..., 0]), hist(rgb[..., 1]),
                             hist(rgb[..., 2]), hist(lum)])
    return ImageInfo(lmin, lmax, avg, soft_min, soft_max, median,
                     inf_count, nan_count, neg_count, histogram)
