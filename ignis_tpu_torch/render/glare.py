"""Glare analysis (port of ignis_tpu/render/glare.py; the reference's
igexplorer, src/frontend/explorer/glare.art:23 compute_glare, a GPU
evalglare with a single glare source).

Given a radiance image and the camera, computes the daylighting glare
metrics: DGP (Wienold-Christoffersen), DGI and modified DGI, DGR and VCP,
UGR and experimental UGR, UGP, with the Guth position index and automatic
vertical illuminance. The per-pixel reductions are plain torch on the
image's device (one host read of their twelve results); the metrics
follow on the host, as in the JAX package.

Conventions (as the reference's):
- luminance [cd/m^2] = 179 lm/W (illuminant-E white efficiency) * CIE
  luma * ``scale``;
- glare source: pixels with luminance > ``mul`` * the average luminance
  (default multiplier 5);
- E_v < 100 lx -> every metric reports 0 (insufficient light); E_v <
  1000 lx applies the DGP low-light correction.

A pixel's solid angle is the spherical excess of its four corner rays,
four arccos values minus 2*pi in float32: at 512x512 that cancellation
leaves each pixel's omega on the last ulp of acos, which differs between
XLA, torch on the CPU and CUDA; the metrics, sums over many pixels, agree
far closer than the per-pixel omegas.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

WHITE_EFFICIENCY = 179.0  # lm/W, illuminant E (reference core/color.art:78)


class GlareResult(NamedTuple):
    dgp: float
    dgi: float
    dgi_mod: float
    dgr: float
    vcp: float
    ugr: float
    ugr_exp: float
    ugp: float
    vertical_illuminance: float
    avg_lum: float
    max_lum: float
    source_lum: float
    source_omega: float
    source_x: float
    source_y: float
    source_map: np.ndarray  # [h, w] relative source luminance in [0, 1]


def _unit(v):
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)


def _basis(cam_dir, cam_up, device):
    d = _unit(torch.as_tensor(cam_dir, dtype=torch.float32, device=device))
    up = torch.as_tensor(cam_up, dtype=torch.float32, device=device)
    return d, up


def _pixel_dirs(cam_dir, cam_up, fov_deg, w, h, xs, ys):
    """Perspective pixel -> direction grid at continuous corner
    coordinates (xs, ys) in [0, w] x [0, h]."""
    d, up = _basis(cam_dir, cam_up, xs.device)
    r = _unit(torch.linalg.cross(d, up))
    u = torch.linalg.cross(r, d)
    tan_h = math.tan(math.radians(fov_deg) / 2.0)
    aspect = h / w
    px = (2.0 * xs / w - 1.0) * tan_h
    py = (1.0 - 2.0 * ys / h) * tan_h * aspect
    v = d + px[..., None] * r + py[..., None] * u
    return _unit(v)


def _glare_reductions(img, cam_dir, cam_up, fov_deg: float, mul, scale,
                      e_v_override):
    h, w = img.shape[0], img.shape[1]
    device = img.device
    f32 = dict(dtype=torch.float32, device=device)
    xs = torch.arange(w + 1, **f32)[None, :].expand(h + 1, w + 1)
    ys = torch.arange(h + 1, **f32)[:, None].expand(h + 1, w + 1)
    corners = _pixel_dirs(cam_dir, cam_up, fov_deg, w, h, xs, ys)

    # per-pixel solid angle: the spherical excess of the 4 corner rays
    r1 = corners[:-1, :-1]   # (x, y)
    r2 = corners[1:, :-1]    # (x, y+1)
    r3 = corners[1:, 1:]     # (x+1, y+1)
    r4 = corners[:-1, 1:]    # (x+1, y)

    def splane(a, b):
        n = torch.linalg.cross(a, b - a)
        l2 = torch.sum(n * n, dim=-1, keepdim=True)
        return torch.where(l2 > 0, n / torch.sqrt(torch.clamp(l2, min=1e-30)),
                           0.0)

    n1 = splane(r1, r2)
    n2 = splane(r2, r3)
    n3 = splane(r3, r4)
    n4 = splane(r4, r1)

    def ang(a, b):
        return math.pi - torch.abs(torch.arccos(torch.clamp(
            torch.sum(a * b, dim=-1), -1.0, 1.0)))
    omega = ang(n1, n2) + ang(n2, n3) + ang(n3, n4) + ang(n4, n1) \
        - 2.0 * math.pi

    # centre directions for the cosine and position-index terms
    cd = _unit(0.25 * (r1 + r2 + r3 + r4))
    d, up = _basis(cam_dir, cam_up, device)
    hv = _unit(torch.linalg.cross(d, up))
    vv = _unit(torch.linalg.cross(d, hv))

    luma = (0.2126 * img[..., 0] + 0.7152 * img[..., 1]
            + 0.0722 * img[..., 2])
    lum = WHITE_EFFICIENCY * luma * scale

    cos_f = torch.abs(torch.sum(cd * d, dim=-1))
    total_omega = torch.sum(omega)
    total_lum = torch.sum(lum * omega)
    max_lum = torch.amax(lum)
    e_v_auto = torch.sum(lum * omega * cos_f)
    e_v = e_v_auto if e_v_override < 0 else torch.tensor(
        float(e_v_override), **f32)

    lum_avg = total_lum / total_omega
    lum_source = lum_avg * mul

    # glare-source aggregation (a single source, glare.art:145-171)
    is_src = lum > lum_source
    xi = torch.arange(w, **f32)[None, :].expand(h, w)
    yi = torch.arange(h, **f32)[:, None].expand(h, w)
    src_omega = torch.sum(torch.where(is_src, omega, 0.0))
    src_lum_o = torch.sum(torch.where(is_src, lum * omega, 0.0))
    src_x = torch.sum(torch.where(is_src, xi * omega, 0.0))
    src_y = torch.sum(torch.where(is_src, yi * omega, 0.0))

    # relative source-luminance map
    max_diff = torch.clamp(max_lum - lum_source, min=1e-20)
    source_map = torch.where(is_src, (lum - lum_source) / max_diff, 0.0)

    # position index at the source centroid (the Guth model; the
    # reference's Iwata branch below the line of sight is dead after its
    # own clamp, and its angles to the line of sight go unread)
    so = torch.clamp(src_omega, min=1e-20)
    gx = src_x / so
    gy = src_y / so
    gxi = torch.clamp(gx, 0.0, w - 1.0)
    gyi = torch.clamp(gy, 0.0, h - 1.0)
    gdir = _pixel_dirs(cam_dir, cam_up, fov_deg, w, h,
                       torch.reshape(gxi + 0.5, (1, 1)),
                       torch.reshape(gyi + 0.5, (1, 1)))[0, 0]
    t = torch.dot(d, gdir)
    sigma = torch.rad2deg(torch.abs(torch.arccos(torch.clamp(t, -1, 1))))
    hvn = gdir / torch.clamp(t, min=1e-6) - gdir
    hvn = hvn / torch.clamp(torch.linalg.vector_norm(hvn), min=1e-20)
    tau = torch.rad2deg(torch.arccos(torch.clamp(torch.dot(vv, hvn), -1, 1)))
    posindex = torch.exp(
        (35.2 - 0.31889 * tau - 1.22 * torch.exp(-2 * tau / 9)) / 1000
        * sigma + (21 + 0.26667 * tau - 0.002963 * tau * tau) / 100000
        * sigma * sigma)
    posindex = torch.clamp(posindex, max=16.0)

    scalars = torch.stack([total_omega, total_lum, max_lum, e_v, lum_avg,
                           lum_source, src_omega, src_lum_o, gx, gy,
                           posindex]).cpu().numpy()
    return (*scalars, source_map.cpu().numpy())


def compute_glare(img, cam_dir=(0, 0, 1), cam_up=(0, 1, 0), fov_deg=60.0,
                  mul=5.0, scale=1.0,
                  vertical_illuminance=-1.0) -> GlareResult:
    """Glare metrics of a radiance image ([h, w, 3] linear radiance, a
    tensor on the device to reduce on, or an array for the CPU)."""
    img = torch.as_tensor(img, dtype=torch.float32)
    (total_omega, total_lum, max_lum, e_v, lum_avg, lum_source,
     src_omega, src_lum_o, gx, gy, posi, source_map) = _glare_reductions(
        img, cam_dir, cam_up, float(fov_deg), float(mul), float(scale),
        float(vertical_illuminance))
    total_omega, total_lum = float(total_omega), float(total_lum)
    max_lum, e_v = float(max_lum), float(e_v)
    lum_avg, lum_source = float(lum_avg), float(lum_source)
    src_omega, src_lum_o = float(src_omega), float(src_lum_o)
    posi = float(posi)

    glare_omega = src_omega
    glare_lum = src_lum_o / glare_omega if glare_omega > 0 else 0.0
    lum_a = e_v / math.pi
    if glare_omega <= 1e-9:
        lum_backg = lum_avg
    else:
        lum_backg = (total_lum - src_lum_o) / (total_omega - src_omega)

    def dgp():
        c1, c2, c3 = 5.87e-5, 0.092, 0.159
        acc = (glare_lum ** 2) / (posi ** 2) * glare_omega / (e_v ** 1.87)
        source_dgp = math.log10(1 + acc)
        if glare_omega > 0:
            return c1 * e_v + c2 * source_dgp + c3
        return c1 * e_v + c3

    def dgi():
        omega_s = glare_omega / (posi * posi)
        s = 0.478 * glare_lum ** 1.6 * omega_s ** 0.8 / (
            lum_backg + 0.07 * glare_omega ** 0.5 * glare_lum)
        return 10 * math.log10(max(s, 1e-30))

    def dgi_mod():
        omega_s = glare_omega / (posi * posi)
        s = 0.478 * glare_lum ** 1.6 * omega_s ** 0.8 / (
            lum_a ** 0.85 + 0.07 * glare_omega ** 0.5 * glare_lum)
        return 10 * math.log10(max(s, 1e-30))

    def dgr():
        return 0.5 * glare_lum * (
            20.4 * glare_omega + 1.52 * glare_omega ** 0.2 - 0.075) / (
            posi * lum_avg ** 0.44)

    def vcp(dgr_v):
        if dgr_v > 750:
            return 0.0
        if dgr_v < 20:
            return 100.0
        return 50 * math.erf((6.374 - 1.3227 * math.log(dgr_v))
                             / 1.414213562373) + 50

    def ugr():
        s = (glare_lum / posi) ** 2 * glare_omega
        if s == 0:
            return 0.0
        return 8 * math.log10(0.25 / lum_backg * s)

    def ugr_exp():
        s = (1 / posi) ** 2 * glare_lum * glare_omega
        if s == 0:
            return 0.0
        return 8 * math.log10(lum_a) + 8 * math.log10(s / lum_backg)

    low_light = math.exp(0.024 * e_v - 4)
    low_light_corr = low_light / (1 + low_light) if e_v < 1000 else 1.0
    insufficient = e_v < 100

    z = lambda f: 0.0 if insufficient else f
    dgr_v = z(dgr())
    return GlareResult(
        dgp=z(low_light_corr * dgp()), dgi=z(dgi()), dgi_mod=z(dgi_mod()),
        dgr=dgr_v, vcp=z(vcp(dgr_v)) if not insufficient else 0.0,
        ugr=z(ugr()), ugr_exp=z(ugr_exp()),
        ugp=z(ugr() / 8 * 0.26),
        vertical_illuminance=e_v, avg_lum=lum_avg, max_lum=max_lum,
        source_lum=glare_lum, source_omega=glare_omega,
        source_x=float(gx), source_y=float(gy),
        source_map=np.asarray(source_map))


def glare_from_runtime(rt, mul=5.0, scale=1.0,
                       vertical_illuminance=-1.0) -> GlareResult:
    """Glare metrics of a Runtime's normalized film, with its camera's
    orientation, on the runtime's device. The fov is 60 degrees, as the
    JAX package's (its camera keeps no tan_half_fov)."""
    cam = rt.scene.camera
    cd = [float(cam.dir.x), float(cam.dir.y), float(cam.dir.z)]
    cu = [float(cam.up.x), float(cam.up.y), float(cam.up.z)]
    return compute_glare(rt.framebuffer(normalized=True), cd, cu, 60.0, mul,
                         scale, vertical_illuminance)
