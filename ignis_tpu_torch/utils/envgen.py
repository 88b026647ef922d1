"""Procedural substitute environment map (copy of ignis_tpu/utils/envgen.py).

A deterministic lat-long HDR panorama with a high-dynamic-range sun disk
(peak ~2e4), a sky gradient, a bright horizon band and a textured dark
ground half, so that the conditional, SAT and hierarchical env CDFs, large
texture fetches and MIS all do real work. `ensure_substitute_env` writes
it as an EXR into a directory the caller names.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np


def make_substitute_env(width: int = 4096, height: int = 2048) -> np.ndarray:
    """Deterministic lat-long HDR panorama [h, w, 3] float32."""
    v = (np.arange(height, dtype=np.float32) + 0.5) / height   # 0 top
    u = (np.arange(width, dtype=np.float32) + 0.5) / width
    theta = v * np.pi                                          # polar
    phi = u * 2.0 * np.pi
    ct = np.cos(theta)[:, None]                                # +1 up
    st = np.sin(theta)[:, None]
    dirx = st * np.cos(phi)[None, :]
    diry = st * np.sin(phi)[None, :]

    # sky: zenith blue -> pale horizon
    t = np.clip(ct, 0.0, 1.0)
    sky = (np.stack([0.35 + 0.0 * t, 0.45 + 0.1 * t, 0.75 + 0.2 * t],
                    axis=-1) * (0.35 + 0.65 * (1.0 - t[..., None]) ** 2))
    horizon = np.exp(-np.abs(ct) * 12.0)[..., None] * \
        np.array([1.1, 0.95, 0.75], np.float32)

    # sun disk at elevation 40deg, azimuth 70deg, ~0.5deg radius + glow
    el, az = np.deg2rad(40.0), np.deg2rad(70.0)
    sdir = np.array([np.cos(el) * np.cos(az), np.cos(el) * np.sin(az),
                     np.sin(el)], np.float32)
    cosang = dirx * sdir[0] + diry * sdir[1] + ct * sdir[2]
    sun = np.where(cosang > np.cos(np.deg2rad(0.5)), 2.0e4, 0.0)
    glow = np.exp((np.clip(cosang, 0.0, 1.0) - 1.0) * 40.0) * 8.0
    sun_rgb = (sun + glow)[..., None] * np.array([1.0, 0.93, 0.82],
                                                 np.float32)

    # ground: dark green-brown with deterministic low-frequency variation
    rng_phase = np.float32(1.7)
    varia = (0.5 + 0.25 * np.sin(7.0 * phi)[None, :]
             + 0.25 * np.sin(13.0 * phi + rng_phase)[None, :]
             * np.cos(9.0 * theta)[:, None])
    ground = (np.stack([0.10 * varia, 0.14 * varia, 0.07 * varia], axis=-1)
              * np.ones((height, width, 1), np.float32))
    below = (ct < 0.0)[..., None]

    img = np.where(below, ground, sky + horizon) + sun_rgb
    return np.ascontiguousarray(img, np.float32)


def ensure_substitute_env(directory, width: int = 4096,
                          height: int = 2048) -> Path:
    """Generate (once) and return `directory`/substitute_env_WxH.exr."""
    from .image import _write_exr_fallback
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    out = directory / f"substitute_env_{width}x{height}.exr"
    if not out.exists():
        tmp = out.with_suffix(".tmp")
        _write_exr_fallback(tmp, make_substitute_env(width, height))
        tmp.replace(out)
    return out
