"""Dupuy-Jakob measured BRDF evaluation (port of
ignis_tpu/models/djmeasured.py, after the reference's
src/artic/bsdf/djmeasured.art and measured/powitacq_rgb.inl).

Operates on the tables baked by scene/djmeasured.py: (phi_i, theta_i)-node
interpolation, a half-vector unit-square lookup for fr, and the baked
product density with per-node CDFs for importance sampling. Isotropic
tables (P == 1) use phi-relative u_wm coordinates; anisotropic ones use
absolute phi and interpolate over the phi_i nodes as well
(djmeasured.art:529).

The four values a corner reads (r, g, b and the sampling density g) are
one row of a [P*T*H*W, 4] table, and every corner of an interpolation is
fetched in one K3 row gather (ops/gather.gather_block): its kernel on the
card, its plain version on the CPU. The CDF searches index their
[P*T, H] / [P*T*H, W] tables directly.

Conventions, as in the JAX package: eval includes |cos(in)| (the
reference's djmeasured eval returns the bare BRDF, djmeasured.art:511);
pdf and sample both condition on the known (view) direction.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..core.vec import Color, Vec3, safe_div
from ..ops import gather as gatherlib

TWO_PI_SQ = 2.0 * math.pi * math.pi


class DJData(NamedTuple):
    theta_nodes: torch.Tensor  # [T]
    phi_nodes: torch.Tensor    # [P] (P == 1: isotropic)
    table: torch.Tensor        # [P*T*H*W, 4]: fr (rgb) and g
    marg_cdf: torch.Tensor     # [P, T, H]
    cond_cdf: torch.Tensor     # [P, T, H, W]


def table_of(fr: np.ndarray, g: np.ndarray) -> np.ndarray:
    """The [P*T*H*W, 4] f32 gather table of fr [P, T, H, W, 3] and
    g [P, T, H, W]."""
    return np.concatenate([np.asarray(fr, np.float32),
                           np.asarray(g, np.float32)[..., None]],
                          axis=-1).reshape(-1, 4)


def from_numpy(d, device="cpu") -> DJData:
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
            device)
    return DJData(t(d.theta_nodes), t(d.phi_nodes), t(table_of(d.fr, d.g)),
                  t(d.marg_cdf), t(d.cond_cdf))


def _isotropic(data: DJData) -> bool:
    return data.phi_nodes.shape[0] == 1


def _elevation(v: Vec3):
    """Numerically robust acos(z) (powitacq_rgb.inl:1075)."""
    dz = v.z - 1.0
    return 2.0 * torch.arcsin(torch.clamp(
        0.5 * torch.sqrt(v.x * v.x + v.y * v.y + dz * dz), 0.0, 1.0 - 1e-7))


def _theta2u(theta):
    return torch.sqrt(torch.clamp(theta, min=0.0) * (2.0 / math.pi))


def _u2theta(u):
    return (u * u) * (math.pi / 2.0)


def _phi2u(phi):
    return phi * (0.5 / math.pi) + 0.5


def _u2phi(u):
    return (2.0 * u - 1.0) * math.pi


def _bins(nodes, x):
    """The surrounding nodes of x and the lerp weight towards the upper."""
    n = nodes.shape[0]
    hi = torch.clamp(torch.searchsorted(nodes, x.contiguous()), 1, n - 1)
    lo = hi - 1
    n_lo = nodes[lo]
    n_hi = nodes[hi]
    w = torch.clamp(safe_div(x - n_lo, n_hi - n_lo), 0.0, 1.0)
    return lo, hi, w


def _theta_bins(data: DJData, theta):
    return _bins(data.theta_nodes, theta)


def _phi_bins(data: DJData, phi):
    """The surrounding phi nodes (a non-periodic clamp, powitacq
    find_interval); isotropic tables give the single slice, weight 0."""
    if _isotropic(data):
        z = torch.zeros_like(phi)
        zi = z.to(torch.int64)
        return zi, zi, z
    return _bins(data.phi_nodes, phi)


def _uwm(data: DJData, known: Vec3, other: Vec3):
    """Half-vector unit-square coordinates; phi relative to `known` for
    isotropic tables, absolute otherwise (djmeasured.art:527-529)."""
    wm = Vec3(known.x + other.x, known.y + other.y, known.z + other.z)
    ln = torch.sqrt(torch.clamp(wm.x ** 2 + wm.y ** 2 + wm.z ** 2,
                                min=1e-24))
    wm = Vec3(wm.x / ln, wm.y / ln, wm.z / ln)
    theta_m = _elevation(wm)
    phi_m = torch.atan2(wm.y, wm.x)
    if _isotropic(data):
        phi_m = phi_m - torch.atan2(known.y, known.x)
    ux = _theta2u(theta_m)
    uy = _phi2u(phi_m)
    uy = uy - torch.floor(uy)
    return wm, theta_m, ux, uy


def _interp_fr(data: DJData, wo: Vec3, ux, uy):
    """(r, g, b, density) interpolated over the (phi_i, theta_i) nodes at
    (ux, uy): the 2 (isotropic) or 4 corners in one K3 gather."""
    _, T, H, W = data.cond_cdf.shape
    lo, hi, w = _theta_bins(data, _elevation(wo))
    plo, phi_, pw = _phi_bins(data, torch.atan2(wo.y, wo.x))
    iy = torch.clamp((uy * H).to(torch.int64), 0, H - 1)
    ix = torch.clamp((ux * W).to(torch.int64), 0, W - 1)
    corners = []
    for p, wp in ((plo, 1.0 - pw), (phi_, pw)):
        for t, wt in ((lo, 1.0 - w), (hi, w)):
            corners.append((((p * T + t) * H + iy) * W + ix, wp * wt))
        if _isotropic(data):
            break  # one phi slice, whose weight 1 - 0 covers it
    rows = torch.cat([c[0] for c in corners]).to(torch.int32)
    vals = gatherlib.gather_block(rows, data.table, 4)
    n = ix.shape[0]
    acc = None
    for k, (_, ww) in enumerate(corners):
        r, g, b, gg = vals[:, k * n:(k + 1) * n].unbind(0)
        cur = (r * ww, g * ww, b * ww, gg * ww)
        acc = cur if acc is None else tuple(a + c for a, c in zip(acc, cur))
    return acc


def dj_eval(data: DJData, tint: Color, wi: Vec3, wo: Vec3) -> Color:
    """eval with cos(in) included; wi = light, wo = view (both local)."""
    wm, theta_m, ux, uy = _uwm(data, wo, wi)
    r, g, b, _ = _interp_fr(data, wo, ux, uy)
    cos_i = torch.clamp(wi.z, min=0.0)
    ok = (wi.z > 1e-6) & (wo.z > 1e-6)
    f = torch.where(ok, cos_i, 0.0)
    return Color(tint.r * r * f, tint.g * g * f, tint.b * b * f)


def _pdf_from_g(g_val, ux, theta_m, wi: Vec3, wm: Vec3):
    sin_m = torch.sin(theta_m)
    jac = torch.clamp(TWO_PI_SQ * ux * sin_m, min=1e-6) * 4.0 \
        * torch.clamp(wi.x * wm.x + wi.y * wm.y + wi.z * wm.z, min=1e-6)
    return safe_div(g_val, jac)


def dj_pdf(data: DJData, wi: Vec3, wo: Vec3):
    wm, theta_m, ux, uy = _uwm(data, wo, wi)
    _, _, _, g_val = _interp_fr(data, wo, ux, uy)
    ok = (wi.z > 1e-6) & (wo.z > 1e-6)
    return torch.where(ok, _pdf_from_g(g_val, ux, theta_m, wo, wm), 0.0)


def _sample_rows(cdf_rows, row_idx, u):
    """Inverse CDF within each lane's row of an inclusive CDF table."""
    ncols = cdf_rows.shape[-1]
    rows = cdf_rows[row_idx]
    idx = torch.clamp((rows < u[:, None]).sum(dim=-1), 0, ncols - 1)
    lane = torch.arange(row_idx.shape[0], device=u.device)
    hi = rows[lane, idx]
    lo = torch.where(idx > 0, rows[lane, torch.clamp(idx - 1, min=0)], 0.0)
    p = torch.clamp(hi - lo, min=1e-12)
    frac = torch.clamp((u - lo) / p, 0.0, 1.0)
    return (idx.to(torch.float32) + frac) / ncols


def dj_sample(data: DJData, tint: Color, wo: Vec3, u0, u1, u2):
    """Sample the baked u_wm density conditioned on the view; returns
    (in_dir local, pdf, weight, valid)."""
    lo, hi, w = _theta_bins(data, _elevation(wo))
    plo, phi_, pw = _phi_bins(data, torch.atan2(wo.y, wo.x))
    # a stochastic node pick is the linear interpolation in expectation;
    # u0 serves both axes, rescaled after the first pick
    t = torch.where(u0 < w, hi, lo)
    u0b = torch.where(u0 < w, safe_div(u0, torch.clamp(w, min=1e-9)),
                      safe_div(u0 - w, torch.clamp(1.0 - w, min=1e-9)))
    p = torch.where(u0b < pw, phi_, plo)
    _, T, H, W = data.cond_cdf.shape
    uy = _sample_rows(data.marg_cdf.reshape(-1, H), p * T + t, u1)
    iy = torch.clamp((uy * H).to(torch.int64), 0, H - 1)
    ux = _sample_rows(data.cond_cdf.reshape(-1, W), (p * T + t) * H + iy, u2)
    theta_m = _u2theta(ux)
    phi_m = _u2phi(uy)
    if _isotropic(data):
        phi_m = phi_m + torch.atan2(wo.y, wo.x)
    sin_m = torch.sin(theta_m)
    wm = Vec3(torch.cos(phi_m) * sin_m, torch.sin(phi_m) * sin_m,
              torch.cos(theta_m))
    d = 2.0 * (wo.x * wm.x + wo.y * wm.y + wo.z * wm.z)
    wi = Vec3(wm.x * d - wo.x, wm.y * d - wo.y, wm.z * d - wo.z)
    r, g, b, g_val = _interp_fr(data, wo, ux, uy)
    pdf = _pdf_from_g(g_val, ux, theta_m, wo, wm)
    valid = (wi.z > 1e-6) & (wo.z > 1e-6) & (pdf > 1e-9)
    cos_i = torch.clamp(wi.z, min=0.0)
    s = torch.where(valid, safe_div(cos_i, pdf), 0.0)
    weight = Color(tint.r * r * s, tint.g * g * s, tint.b * b * s)
    return wi, pdf, weight, valid
