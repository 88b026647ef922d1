"""Cameras: perspective (+DoF), orthogonal, fishlens.

Port of ignis_tpu/models/camera.py: `generate_rays`, and `sample_pixel`,
the light tracer's connection to the pinhole. Conventions:
  - view matrix columns (right, up, dir); right = normalize(cross(dir, up))
  - nx = 2*(x+sx)/w - 1 ; ny = 1 - 2*(y+sy)/h
  - scale = (tan(hfov/2), tan(hfov/2)/aspect)
Every returned array is a contiguous [N] tensor.
"""
from __future__ import annotations

import torch

from ..core import rng as rnglib
from ..core.vec import Vec3, cross, normalize, vselect
from ..core.warp import PI, square_to_concentric_disk
from ..ops.intersect import Rays
from ..scenedata import CameraData, RenderSettings


def pixel_to_normalized(x, y, sx, sy, w: int, h: int):
    nx = 2.0 * (x.to(torch.float32) + sx) / w - 1.0
    ny = 1.0 - 2.0 * (y.to(torch.float32) + sy) / h
    return nx, ny


def _full(v, like):
    return v.expand(like.shape).contiguous()


def generate_rays(cam: CameraData, settings: RenderSettings, x, y, sx, sy,
                  rng_state=None) -> Rays:
    nx, ny = pixel_to_normalized(x, y, sx, sy, settings.width,
                                 settings.height)
    if settings.camera_type in ("perspective", "orthogonal"):
        right = normalize(cross(cam.dir, cam.up))
        if settings.camera_type == "perspective":
            lx = cam.scale.x * nx
            ly = cam.scale.y * ny
            d = normalize(Vec3(right.x * lx + cam.up.x * ly + cam.dir.x,
                               right.y * lx + cam.up.y * ly + cam.dir.y,
                               right.z * lx + cam.up.z * ly + cam.dir.z))
            org = Vec3(_full(cam.eye.x, nx), _full(cam.eye.y, nx),
                       _full(cam.eye.z, nx))
            if rng_state is not None:
                # depth of field (perspective.art make_perspective_dof_camera)
                _, (ua, ub) = rnglib.next_f32_n(rng_state, 2)
                p = square_to_concentric_disk(ua, ub)
                ax = p.x * cam.aperture
                ay = p.y * cam.aperture
                focus = d * cam.focal
                ap = Vec3(right.x * ax + cam.up.x * ay,
                          right.y * ax + cam.up.y * ay,
                          right.z * ax + cam.up.z * ay)
                d_dof = normalize(focus - ap)
                m = (cam.aperture > 1e-6).expand(nx.shape)
                d = vselect(m, d_dof, d)
                org = vselect(m, org + ap, org)
        else:  # orthogonal: parallel rays, scale = extent
            ox = cam.scale.x * nx
            oy = cam.scale.y * ny
            org = Vec3(cam.eye.x + right.x * ox + cam.up.x * oy,
                       cam.eye.y + right.y * ox + cam.up.y * oy,
                       cam.eye.z + right.z * ox + cam.up.z * oy)
            d = Vec3(_full(cam.dir.x, nx), _full(cam.dir.y, nx),
                     _full(cam.dir.z, nx))
    elif settings.camera_type in ("fishlens", "fisheye"):
        org = Vec3(_full(cam.eye.x, nx), _full(cam.eye.y, nx),
                   _full(cam.eye.z, nx))
        d = _fishlens_dir(cam, settings, nx, ny)
    else:
        raise ValueError(f"Unknown camera type {settings.camera_type}")
    return Rays(org, d, _full(cam.tmin, nx), _full(cam.tmax, nx))


def _fishlens_dir(cam: CameraData, settings: RenderSettings, nx, ny) -> Vec3:
    """Equisolid fisheye over the image disk (fishlens.art)."""
    fw, fh = float(settings.width), float(settings.height)
    if settings.fish_mode == "circular":
        xasp, yasp = min(fw, fh) / fw, min(fw, fh) / fh
    elif settings.fish_mode == "cropped":
        xasp, yasp = max(fw, fh) / fw, max(fw, fh) / fh
    else:  # full
        diam = (fw * fw + fh * fh) ** 0.5
        xasp, yasp = diam / fw, diam / fh
    right = normalize(cross(cam.dir, cam.up))
    xx = nx * xasp
    yy = ny * yasp
    r = torch.sqrt(torch.clamp(xx * xx + yy * yy, min=1e-20))
    theta = r * (PI / 2.0)
    sin_t = torch.sin(theta)
    cos_t = torch.cos(theta)
    inv_r = torch.where(r > 1e-9, 1.0 / r, 0.0)
    dx = sin_t * xx * inv_r
    dy = sin_t * yy * inv_r
    return normalize(Vec3(right.x * dx + cam.up.x * dy + cam.dir.x * cos_t,
                          right.y * dx + cam.up.y * dy + cam.dir.y * cos_t,
                          right.z * dx + cam.up.z * dy + cam.dir.z * cos_t))


def sample_pixel(cam: CameraData, settings: RenderSettings, point: Vec3):
    """Project world points onto the image (perspective.art
    perspective_pos_to_pixel): (valid, linear pixel index, direction to the
    camera, point -> eye and unnormalised, importance weight). The weight is
    the pinhole importance in image-area measure, 1 / (A_img cos^3), A_img
    = 4 sx sy the image plane's area at unit distance (the w*h pixel count
    cancels against one light path a pixel lane)."""
    right = normalize(cross(cam.dir, cam.up))
    d = Vec3(point.x - cam.eye.x, point.y - cam.eye.y, point.z - cam.eye.z)
    ux = right.x * d.x + right.y * d.y + right.z * d.z
    uy = cam.up.x * d.x + cam.up.y * d.y + cam.up.z * d.z
    uz = cam.dir.x * d.x + cam.dir.y * d.y + cam.dir.z * d.z
    nx = ux / (uz * cam.scale.x)
    ny = uy / (uz * cam.scale.y)
    valid = (uz > 1e-6) & (nx >= -1) & (nx <= 1) & (ny >= -1) & (ny <= 1)
    w, h = settings.width, settings.height
    px = torch.clamp(torch.floor(w * (nx + 1.0) * 0.5).to(torch.int32), 0,
                     w - 1)
    py = torch.clamp(torch.floor(h * (1.0 - ny) * 0.5).to(torch.int32), 0,
                     h - 1)
    s_dir = Vec3(cam.eye.x - point.x, cam.eye.y - point.y,
                 cam.eye.z - point.z)
    dlen = torch.sqrt(torch.clamp(ux * ux + uy * uy + uz * uz, min=1e-24))
    cos_t = torch.clamp(uz / dlen, min=1e-6)
    weight = 1.0 / (4.0 * cam.scale.x * cam.scale.y * cos_t * cos_t * cos_t)
    return valid, py * w + px, s_dir, weight
