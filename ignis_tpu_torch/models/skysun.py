"""Hosek-Wilkie sky model and sun utilities (host-side baking); a copy of
ignis_tpu/models/skysun.py.

Analog of the reference's src/runtime/skysun/: the sky is baked to an
equirect radiance texture at load time and then used as a textured
environment light with CDF importance sampling. Dataset:
ignis_tpu_torch/data/hosek_rgb.npz (the public Hosek-Wilkie RGB fit data,
3-clause BSD, extracted from the published model data; the port's own
copy).

Two faults of the JAX bake are fixed here (ROADMAP queue 3,
tests/test_torch_sky.py): the dataset's coefficients are stored flat per
control point ([6 control points][9 coefficients], as in the published
ArHosekSkyModelData_RGB), which the JAX package reads as [9][6] and blends
across the wrong axis, and the radiance distribution reads the mie
parameter H from coefficient 8 and the zenith weight I from coefficient 7
(ArHosekSkyModel_GetRadianceInternal), which the JAX package swaps; with
both, its sky overflows float32 for most sun directions.

Bake difference vs the reference: the reference bakes theta in [0, pi/2]
over the full image height and feeds it to the full-sphere equirect mapping
(SkyModel.cpp RES_EL rows over ELEVATION_RANGE=pi/2); we bake a true
equirect (theta in [0, pi], ground half black) so the sky dome occupies the
geometrically correct half of the sphere.
"""
from __future__ import annotations

import math
from pathlib import Path

import numpy as np

_DATA = None


def _dataset():
    global _DATA
    if _DATA is None:
        f = np.load(Path(__file__).resolve().parent.parent / "data" / "hosek_rgb.npz")
        # the file keeps the JAX package's (3, 2, 10, 9, 6) shape of the
        # flat [control point][coefficient] data: read it as (…, 6, 9)
        _DATA = (f["config"].reshape(3, 2, 10, 6, 9), f["radiance"])
    return _DATA


def _quintic_bezier(ctrl, t):
    """ctrl: [6, ...] control points; t scalar."""
    s = 1.0 - t
    w = np.array([s ** 5, 5 * s ** 4 * t, 10 * s ** 3 * t * t,
                  10 * s * s * t ** 3, 5 * s * t ** 4, t ** 5])
    return np.tensordot(w, ctrl, axes=([0], [0]))


def _cook(dataset, turbidity, albedo, solar_elevation):
    """dataset: [2, 10, 6, 9] (albedo, turbidity, ctrl, coef) -> [9]."""
    t_int = int(np.clip(int(turbidity), 1, 10))
    t_rem = float(np.clip(turbidity - t_int, 0.0, 1.0))
    te = (solar_elevation / (math.pi / 2.0)) ** (1.0 / 3.0)

    def cfg(ti, alb):
        return _quintic_bezier(dataset[alb, ti - 1], te)

    a0t0 = cfg(t_int, 0)
    a1t0 = cfg(t_int, 1)
    if t_int == 10:
        a0t1, a1t1 = a0t0, a1t0
        t_rem = 0.0
    else:
        a0t1 = cfg(t_int + 1, 0)
        a1t1 = cfg(t_int + 1, 1)
    c0 = a0t0 * (1 - albedo) + a1t0 * albedo
    c1 = a0t1 * (1 - albedo) + a1t1 * albedo
    return c0 * (1 - t_rem) + c1 * t_rem


def _radiance_scalar(dataset_rad, turbidity, albedo, solar_elevation):
    t_int = int(np.clip(int(turbidity), 1, 10))
    t_rem = float(np.clip(turbidity - t_int, 0.0, 1.0))
    te = (solar_elevation / (math.pi / 2.0)) ** (1.0 / 3.0)

    def rad(ti, alb):
        return _quintic_bezier(dataset_rad[alb, ti - 1], te)

    a0t0 = rad(t_int, 0)
    a1t0 = rad(t_int, 1)
    if t_int == 10:
        a0t1, a1t1 = a0t0, a1t0
        t_rem = 0.0
    else:
        a0t1 = rad(t_int + 1, 0)
        a1t1 = rad(t_int + 1, 1)
    c0 = a0t0 * (1 - albedo) + a1t0 * albedo
    c1 = a0t1 * (1 - albedo) + a1t1 * albedo
    return c0 * (1 - t_rem) + c1 * t_rem


def _eval_config(cfg, cos_theta, gamma):
    """Hosek radiance distribution F(theta, gamma); cfg: [9]; batched."""
    A, B, C, D, E, F, G, I, H = [cfg[i] for i in range(9)]
    cg = np.cos(gamma)
    exp_m = np.exp(E * gamma)
    ray_m = cg * cg
    mie_m = (1.0 + cg * cg) / np.power(1.0 + H * H - 2.0 * H * cg, 1.5)
    zenith = np.sqrt(np.maximum(cos_theta, 0.0))
    return ((1.0 + A * np.exp(B / (cos_theta + 0.01)))
            * (C + D * exp_m + F * ray_m + G * mie_m + I * zenith))


CIE_Y_SUM = 106.856980


def ea_to_direction_yup(elevation, azimuth):
    """ElevationAzimuth::toDirectionYUp (azimuth west of south)."""
    ce, se = math.cos(elevation), math.sin(elevation)
    sa, ca = math.sin(azimuth), math.cos(azimuth)
    return np.array([-ce * sa, se, -ce * ca])


def compute_sun_ea(year=2020, month=5, day=6, hour=12, minute=0, seconds=0.0,
                   latitude=49.235422, longitude=-6.9965744, timezone=-2.0):
    """Solar position (PSA algorithm, Blanco-Muriel et al. 2001), matching
    reference computeSunEA (SunLocation.cpp). Returns (elevation, azimuth
    west-of-south)."""
    dec_hours = hour + timezone + (minute + seconds / 60.0) / 60.0
    aux1 = (month - 14) // 12
    aux2 = ((1461 * (year + 4800 + aux1)) // 4
            + (367 * (month - 2 - 12 * aux1)) // 12
            - (3 * ((year + 4900 + aux1) // 100)) // 4
            + day - 32075)
    julian = float(aux2) - 0.5 + dec_hours / 24.0
    ejd = julian - 2451545.0

    omega = 2.1429 - 0.0010394594 * ejd
    mean_long = 4.8950630 + 0.017202791698 * ejd
    anomaly = 6.2400600 + 0.0172019699 * ejd
    ecl_long = (mean_long + 0.03341607 * math.sin(anomaly)
                + 0.00034894 * math.sin(2 * anomaly) - 0.0001134
                - 0.0000203 * math.sin(omega))
    ecl_obl = 0.4090928 - 6.2140e-9 * ejd + 0.0000396 * math.cos(omega)

    sin_el = math.sin(ecl_long)
    ra = math.atan2(math.cos(ecl_obl) * sin_el, math.cos(ecl_long))
    if ra < 0:
        ra += 2 * math.pi
    decl = math.asin(math.sin(ecl_obl) * sin_el)

    gmst = 6.6974243242 + 0.0657098283 * ejd + dec_hours
    lmst = math.radians(gmst * 15 - longitude)
    lat = math.radians(latitude)
    hour_angle = lmst - ra
    zenith = math.acos(math.cos(lat) * math.cos(hour_angle) * math.cos(decl)
                       + math.sin(decl) * math.sin(lat))
    dy = -math.sin(hour_angle)
    dx = math.tan(decl) * math.cos(lat) - math.sin(lat) * math.cos(hour_angle)
    azimuth = math.atan2(dy, dx)
    if azimuth < 0:
        azimuth += 2 * math.pi
    zenith += (6371.01 / 149597890.0) * math.sin(zenith)
    return (math.pi / 2 - zenith,
            math.fmod(azimuth + math.pi, 2 * math.pi))


def ea_from_direction_yup(d):
    """(elevation, azimuth) from Y-up direction (ElevationAzimuth.h)."""
    d = np.asarray(d, np.float64)
    d = d / np.linalg.norm(d)
    theta = math.acos(np.clip(d[1], -1, 1))
    phi = math.atan2(-d[0], -d[2])
    if phi < 0:
        phi += 2 * math.pi
    return (math.pi / 2 - theta), phi


def bake_sky(sun_direction, turbidity=3.0, ground_albedo=(0.8, 0.8, 0.8),
             res_az=512, res_el=256) -> np.ndarray:
    """Bake equirect sky radiance [2*res_el, res_az, 3] (full sphere; ground
    half black). Row 0 = zenith; azimuth column 0 at -pi/4 like the
    reference (aligns with env map_env_uv's +0.25 u rotation)."""
    d = np.asarray(sun_direction, np.float64)
    d = d / np.linalg.norm(d)
    elevation = math.pi / 2 - math.acos(np.clip(d[1], -1, 1))
    # Azimuth in the env-texture convention of models/light.py:
    # column c covers phi_env = 2pi*u - pi/2 with phi_env = atan2(z, x).
    sun_azimuth = math.atan2(d[2], d[0])
    solar_elevation = max(elevation, 0.0)
    config, radiance = _dataset()

    cfgs = [_cook(config[k], turbidity, ground_albedo[k], solar_elevation)
            for k in range(3)]
    rads = [_radiance_scalar(radiance[k], turbidity, ground_albedo[k],
                             solar_elevation) for k in range(3)]

    theta = (math.pi / 2) * (np.arange(res_el) + 0.5) / res_el  # zenith..horizon
    azimuth = 2 * math.pi * (np.arange(res_az) + 0.5) / res_az - math.pi / 2
    st, ct = np.sin(theta)[:, None], np.cos(theta)[:, None]
    sun_theta = math.pi / 2 - solar_elevation
    cos_gamma = (ct * math.cos(sun_theta)
                 + st * math.sin(sun_theta) * np.cos(azimuth[None, :] - sun_azimuth))
    gamma = np.arccos(np.clip(cos_gamma, -1.0, 1.0))

    img = np.zeros((2 * res_el, res_az, 3), np.float32)
    for k in range(3):
        v = _eval_config(cfgs[k], np.maximum(ct, 0.0), gamma) * rads[k] / CIE_Y_SUM
        img[:res_el, :, k] = np.maximum(v, 0.0).astype(np.float32)
    return img


SUN_RADIUS_DEG = 0.533  # full angular diameter (sun.art:1)


def sun_cos_angle(angle_deg=SUN_RADIUS_DEG):
    return math.cos(math.radians(angle_deg / 2))


def sun_area_from_angle(angle_deg=SUN_RADIUS_DEG):
    srad = math.tan(math.radians(angle_deg / 2))
    return math.pi * srad * srad
