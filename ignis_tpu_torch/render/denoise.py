"""AOV-guided denoisers (port of ignis_tpu/render/denoise.py).

The reference puts Intel Open Image Denoise behind its Runtime, fed by
the Normals / Albedo AOVs; the JAX package replaces it with two classical
filters of the same inputs, ported here as plain torch on the image's
device: an edge-avoiding a-trous wavelet filter (`denoise_image`,
Dammertz et al. 2010) and the guided non-local means (`denoise_image_nlm`,
the default). Every shift is an edge-clamped index (`_shift2d`), and the
accumulations run in the JAX loop order, so the port agrees with the JAX
package to float32 rounding. The NLM's 121 search offsets of about 40
elementwise ops each make several thousand kernel launches a call on the
card.
"""
from __future__ import annotations

import torch

# 5x5 B3-spline kernel weights (separable 1/16 [1 4 6 4 1])
_K1D = [1.0 / 16, 4.0 / 16, 6.0 / 16, 4.0 / 16, 1.0 / 16]


def _shift2d(img, dy, dx):
    """img shifted by (dy, dx) with edge clamp ([h, w, ...])."""
    h, w = img.shape[0], img.shape[1]
    ys = torch.clamp(torch.arange(h, device=img.device) + dy, 0, h - 1)
    xs = torch.clamp(torch.arange(w, device=img.device) + dx, 0, w - 1)
    return img[ys][:, xs]


def _guides(color, normals, albedo, depth):
    color = torch.as_tensor(color, dtype=torch.float32)
    h, w = color.shape[0], color.shape[1]
    normals = (torch.zeros_like(color) if normals is None
               else torch.as_tensor(normals, dtype=torch.float32))
    albedo = (torch.zeros_like(color) if albedo is None
              else torch.as_tensor(albedo, dtype=torch.float32))
    depth = (torch.zeros((h, w), dtype=torch.float32, device=color.device)
             if depth is None else torch.as_tensor(depth,
                                                   dtype=torch.float32))
    return color, normals, albedo, depth


def _depth_scale(depth):
    return torch.clamp(torch.amax(torch.abs(depth)), min=1e-6)


def denoise_image(color, normals=None, albedo=None, depth=None,
                  iterations: int = 4, sigma_color: float = 0.45,
                  sigma_normal: float = 0.2, sigma_albedo: float = 0.25,
                  sigma_depth: float = 0.03):
    """Edge-avoiding a-trous filter; images [h, w, 3], depth [h, w]."""
    color, normals, albedo, depth = _guides(color, normals, albedo, depth)
    h, w = color.shape[0], color.shape[1]
    depth = depth * (1.0 / _depth_scale(depth))

    out = color
    for it in range(iterations):
        step = 1 << it
        acc = torch.zeros_like(out)
        wsum = torch.zeros((h, w, 1), dtype=torch.float32,
                           device=color.device)
        for ky in range(5):
            for kx in range(5):
                dy = (ky - 2) * step
                dx = (kx - 2) * step
                kw = _K1D[ky] * _K1D[kx]
                c_s = _shift2d(out, dy, dx)
                n_s = _shift2d(normals, dy, dx)
                a_s = _shift2d(albedo, dy, dx)
                d_s = _shift2d(depth, dy, dx)
                dc = torch.sum((c_s - out) ** 2, dim=-1)
                dn = torch.sum((n_s - normals) ** 2, dim=-1)
                da = torch.sum((a_s - albedo) ** 2, dim=-1)
                dd = (d_s - depth) ** 2
                wgt = kw * torch.exp(
                    -dc / (sigma_color * sigma_color * (1 << it))
                    - dn / (sigma_normal * sigma_normal)
                    - da / (sigma_albedo * sigma_albedo)
                    - dd / (sigma_depth * sigma_depth))
                acc = acc + c_s * wgt[..., None]
                wsum = wsum + wgt[..., None]
        out = acc / torch.clamp(wsum, min=1e-8)
    return out


def _box_filter(img, r):
    """Mean filter of radius r over [h, w] by shifted sums."""
    acc = torch.zeros_like(img)
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            acc = acc + _shift2d(img, dy, dx)
    return acc / float((2 * r + 1) ** 2)


def denoise_image_nlm(color, normals=None, albedo=None, depth=None,
                      search_radius: int = 5, patch_radius: int = 1,
                      sigma_normal: float = 0.35, sigma_albedo: float = 0.3,
                      sigma_depth: float = 0.05, k: float = 0.45):
    """AOV-guided non-local means (the default denoiser).

    Patch-SSD weights with the noise-offset subtraction of Buades et al.
    (w = exp(-max(SSD - floor, 0) / h^2)), the floor being the smoothed
    patch-SSD to the 8-neighbourhood (about twice the noise variance in
    flat regions), jointly gated by the Normals / Albedo / Depth guides."""
    color, normals, albedo, depth = _guides(color, normals, albedo, depth)
    h, w = color.shape[0], color.shape[1]
    depth = depth / _depth_scale(depth)

    floor = torch.zeros((h, w), dtype=torch.float32, device=color.device)
    cnt = 0
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            d2 = torch.mean((_shift2d(color, dy, dx) - color) ** 2, dim=-1)
            floor = floor + _box_filter(d2, patch_radius)
            cnt += 1
    floor = _box_filter(floor / cnt, 2)
    hh = torch.clamp(k * floor, min=1e-12)

    acc = torch.zeros_like(color)
    wsum = torch.zeros((h, w), dtype=torch.float32, device=color.device)
    for dy in range(-search_radius, search_radius + 1):
        for dx in range(-search_radius, search_radius + 1):
            c_s = _shift2d(color, dy, dx)
            d2 = torch.mean((c_s - color) ** 2, dim=-1)
            ssd = _box_filter(d2, patch_radius)
            n_s = _shift2d(normals, dy, dx)
            a_s = _shift2d(albedo, dy, dx)
            d_s = _shift2d(depth, dy, dx)
            dn = torch.sum((n_s - normals) ** 2, dim=-1)
            da = torch.sum((a_s - albedo) ** 2, dim=-1)
            dd = (d_s - depth) ** 2
            wgt = torch.exp(
                -torch.clamp(ssd - floor, min=0.0) / hh
                - dn / (sigma_normal * sigma_normal)
                - da / (sigma_albedo * sigma_albedo)
                - dd / (sigma_depth * sigma_depth))
            acc = acc + c_s * wgt[..., None]
            wsum = wsum + wgt
    return acc / torch.clamp(wsum[..., None], min=1e-8)


def has_denoiser() -> bool:
    """The reference's Runtime::hasDenoiser (always available here)."""
    return True
