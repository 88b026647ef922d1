"""CIE sky classifications + Perez all-weather sky (host-side env bakes).

Mirrors the reference's src/artic/light/cie.art, perez.art and
src/runtime/light/CIELight.cpp / PerezLight.cpp. Both model families are
analytic radiance distributions over the sky dome; we bake them into an
equirect environment texture (models/skysun.py bake convention: row 0 =
zenith, column azimuth phi_env = 2*pi*u - pi/2) and register a textured env
light with CDF importance sampling. Perez `has_sun` additionally yields a
sun-disk light.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np

WHITE_EFFICIENCY = 179.0
SOLAR_E = 1367.0
SOLAR_L = 127500.0
ATM_PRECI_WATER = 2.0
SUN_RADIUS_DEG = 0.533


def _dir_grid(res_az=512, res_el=512):
    """World directions for each texel (y-up; full sphere)."""
    theta = math.pi * (np.arange(res_el) + 0.5) / res_el
    phi = 2 * math.pi * (np.arange(res_az) + 0.5) / res_az - math.pi / 2
    st, ct = np.sin(theta)[:, None], np.cos(theta)[:, None]
    cp, sp = np.cos(phi)[None, :], np.sin(phi)[None, :]
    return np.stack([st * cp, np.broadcast_to(ct, (res_el, res_az)),
                     st * sp], axis=-1)


def _cie_wmean(cos_theta, c1, c2):
    a = np.power(cos_theta + 1.01, 10)
    f1 = a * a / (a * a + 1.0)
    f2 = 1.0 / (a * a + 1.0)
    return c1 * f1[..., None] + c2 * f2[..., None]


def _skylight_normalization_factor(altitude, clear):
    arr = ([2.766521, 0.547665, -0.369832, 0.009237, 0.059229] if clear
           else [3.5556, -2.7152, -1.3081, 1.0660, 0.60227])
    x = (altitude - math.pi / 4) / (math.pi / 4)
    f = arr[4]
    for i in range(3, -1, -1):
        f = f * x + arr[i]
    return f


def bake_cie(kind: str, sun_dir, zenith, ground, ground_brightness=0.2,
             turbidity=2.45, has_ground=True, scale=(1, 1, 1),
             res_az=512, res_el=512) -> np.ndarray:
    """kind in {uniform, cloudy, clear, intermediate} (CIELight.cpp)."""
    zenith = np.asarray(zenith, np.float64)
    ground = np.asarray(ground, np.float64)
    scale = np.asarray(scale, np.float64)
    d = _dir_grid(res_az, res_el)
    cos_theta = d[..., 1]

    sun = np.asarray(sun_dir, np.float64)
    sun = sun / np.linalg.norm(sun)
    elevation = math.asin(np.clip(sun[1], -1, 1))

    if kind in ("uniform", "cloudy"):
        cloudy = kind == "cloudy"
        c1 = (1 + 2 * cos_theta) / 3 if cloudy else np.ones_like(cos_theta)
        c2 = 0.777777777 if cloudy else 1.0
        img = _cie_wmean(cos_theta, zenith * c1[..., None],
                         ground * (ground_brightness * c2))
    else:
        clear = kind == "clear"
        elev = min(elevation, math.radians(87.0))
        zb = (1.376 * turbidity - 1.81) * math.tan(elev) + 0.38
        if not clear:  # intermediate
            zb = (zb + 8.6 * sun[1] + 0.123) / 2
        zb = max(0.0, zb * 1000 / 203.0)
        if clear:
            factor = 0.274 * (0.91 + 10 * math.exp(-3 * (math.pi / 2 - elev))
                              + 0.45 * sun[1] * sun[1])
        else:
            factor = ((2.739 + 0.9891 * math.sin(0.3119 + 2.6 * elev))
                      * math.exp(-(math.pi / 2 - elev) * (0.4441 + 1.48 * elev)))
        norm_factor = _skylight_normalization_factor(elev, clear) / math.pi / factor
        solarbrightness = 1.5e9 / 208.0 * (1.147 - 0.147 / max(sun[1], 0.16))
        additive = (6e-5 / math.pi * solarbrightness * sun[1]
                    * (1.0 if clear else 0.15))
        c2 = zb * norm_factor + additive
        zenith_b = zb / factor

        cos_gamma = np.clip(np.tensordot(d, sun, axes=([2], [0])), -1, 1)
        gamma = np.arccos(cos_gamma)
        if clear:
            c1 = ((0.91 + 10 * np.exp(-3 * gamma) + 0.45 * cos_gamma ** 2)
                  * np.where(cos_theta >= 0.01,
                             1 - np.exp(-0.32 / np.maximum(cos_theta, 0.01)),
                             1.0))
        else:
            theta = np.arccos(np.clip(cos_theta, -1, 1))
            stheta = math.acos(np.clip(sun[1], -1, 1))
            c1 = (((1.35 * np.sin(5.631 - 3.59 * theta) + 3.12)
                   * math.sin(4.396 - 2.6 * stheta) + 6.37 - theta) / 2.326
                  * np.exp(gamma * (-0.563)
                           * ((2.629 - theta) * (1.562 - stheta) + 0.812)))
        img = _cie_wmean(cos_theta, zenith * (zenith_b * c1)[..., None],
                         ground * (ground_brightness * c2))
    if not has_ground:
        img = np.where(cos_theta[..., None] < 0, 0.0, img)
    return (img * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# Perez all-weather model (perez.art)
# ---------------------------------------------------------------------------

_RANGES = [1.000, 1.065, 1.230, 1.500, 1.950, 2.800, 4.500, 6.200, 12.01]
_PA = np.array([1.3525, -0.2576, -0.2690, -1.4366, -1.2219, -0.7730, 1.4148, 1.1016,
                -1.1000, -0.2515, 0.8952, 0.0156, -0.5484, -0.6654, -0.2672, 0.7117,
                -0.6000, -0.3566, -2.5000, 2.3250, -1.0156, -0.3670, 1.0078, 1.4051,
                -1.0000, 0.0211, 0.5025, -0.5119, -1.0500, 0.0289, 0.4260, 0.3590]).reshape(8, 4)
_PB = np.array([-0.7670, 0.0007, 1.2734, -0.1233, -0.2054, 0.0367, -3.9128, 0.9156,
                0.2782, -0.1812, -4.5000, 1.1766, 0.7234, -0.6219, -5.6812, 2.6297,
                0.2937, 0.0496, -5.6812, 1.8415, 0.2875, -0.5328, -3.8500, 3.3750,
                -0.3000, 0.1922, 0.7023, -1.6317, -0.3250, 0.1156, 0.7781, 0.0025]).reshape(8, 4)
_PC = np.array([2.8000, 0.6004, 1.2375, 1.0000, 6.9750, 0.1774, 6.4477, -0.1239,
                24.7219, -13.0812, -37.7000, 34.8438, 33.3389, -18.3000, -62.2500, 52.0781,
                21.0000, -4.7656, -21.5906, 7.2492, 14.0000, -0.9999, -7.1406, 7.5469,
                19.0000, -5.0000, 1.2438, -1.9094, 31.0625, -14.5000, -46.1148, 55.3750]).reshape(8, 4)
_PD = np.array([1.8734, 0.6297, 0.9738, 0.2809, -1.5798, -0.5081, -1.7812, 0.1080,
                -5.0000, 1.5218, 3.9229, -2.6204, -3.5000, 0.0016, 1.1477, 0.1062,
                -3.5000, -0.1554, 1.4062, 0.3988, -3.4000, -0.1078, -1.0750, 1.5702,
                -4.0000, 0.0250, 0.3844, 0.2656, -7.2312, 0.4050, 13.3500, 0.6234]).reshape(8, 4)
_PE = np.array([0.0356, -0.1246, -0.5718, 0.9938, 0.2624, 0.0672, -0.2190, -0.4285,
                -0.0156, 0.1597, 0.4199, -0.5562, 0.4659, -0.3296, -0.0876, -0.0329,
                0.0032, 0.0766, -0.0656, -0.1294, -0.0672, 0.4016, 0.3017, -0.4844,
                1.0468, -0.3788, -2.4517, 1.4656, 1.5000, -0.6426, 1.8564, 0.5636]).reshape(8, 4)
_DIFF_EFF = (np.array([97.24, 107.22, 104.97, 102.39, 100.71, 106.42, 141.88, 152.23]),
             np.array([-0.46, 1.15, 2.96, 5.59, 5.94, 3.83, 1.90, 0.35]),
             np.array([12.00, 0.59, -5.53, -13.95, -22.75, -36.15, -53.24, -45.27]),
             np.array([-8.91, -3.95, -8.77, -13.90, -23.74, -28.83, -14.03, -7.98]))
_DIR_EFF = (np.array([57.20, 98.99, 109.83, 110.34, 106.36, 107.19, 105.75, 101.18]),
            np.array([-4.55, -3.46, -4.90, -5.84, -3.97, -1.25, 0.77, 1.58]),
            np.array([-2.98, -1.21, -1.71, -1.99, -1.75, -1.51, -1.26, -1.10]),
            np.array([117.12, 12.38, -8.81, -4.56, -6.16, -26.73, -34.44, -8.29]))

# Radiance's 145-patch integration base (perez.art s_theta_base/s_phi_base)
_THETA_BASE = [84] * 30 + [72] * 30 + [60] * 24 + [48] * 24 + [36] * 18 \
    + [24] * 12 + [12] * 6 + [0]
_PHI_BASE = (list(range(0, 360, 12)) + list(range(0, 360, 12))
             + list(range(0, 360, 15)) + list(range(0, 360, 15))
             + list(range(0, 360, 20)) + list(range(0, 360, 30))
             + list(range(0, 360, 60)) + [0])


def _bin_of(clearness):
    for b in range(8):
        if _RANGES[b] <= clearness < _RANGES[b + 1]:
            return b
    return 7


def _eccentricity(day):
    da = 2 * math.pi * np.clip(day / 365.0, 0, 1)
    return (1.00011 + 0.034221 * math.cos(da) + 0.00128 * math.sin(da)
            + 0.000719 * math.cos(2 * da) + 0.000077 * math.sin(2 * da))


def _air_mass(sz):
    return 1.0 / (math.cos(sz) + 0.15 * math.exp(
        math.log(max(93.885 - math.degrees(sz), 1e-3)) * -1.253))


class PerezModel(NamedTuple):
    brightness: float
    clearness: float
    direct_irrad: float
    diffuse_irrad: float
    direct_illum: float
    diffuse_illum: float
    params: Tuple[float, float, float, float, float]


def _explicit_params(brightness, clearness, sz):
    if 1.065 < clearness < 2.8 and brightness < 0.2:
        brightness = 0.2
    b = _bin_of(clearness)

    def std(p):
        return p[b, 0] + p[b, 1] * sz + brightness * (p[b, 2] + p[b, 3] * sz)

    a = std(_PA)
    bb = std(_PB)
    e = std(_PE)
    if b == 0:
        c = math.exp(math.pow(max(brightness * (_PC[0, 0] + _PC[0, 1] * sz), 0.0),
                              _PC[0, 2])) - _PC[0, 3]
        dd = -math.exp(brightness * (_PD[0, 0] + _PD[0, 1] * sz)) + _PD[0, 2] \
            + brightness * _PD[0, 3]
    else:
        c = std(_PC)
        dd = std(_PD)
    return (a, bb, c, dd, e)


def _efficacy(tbl, brightness, clearness, sz, direct=False):
    b = _bin_of(clearness)
    a, bb, c, d = (t[b] for t in tbl)
    if direct:
        return max(0.0, a + bb * ATM_PRECI_WATER + c * math.exp(5.73 * sz - 5)
                   + d * brightness)
    return a + bb * ATM_PRECI_WATER + c * math.cos(sz) \
        + d * math.log(max(brightness, 1e-6))


def perez_model(sz, day, brightness=None, clearness=None, diffuse_irrad=None,
                direct_irrad=None) -> PerezModel:
    if brightness is not None:
        brightness = float(np.clip(brightness, 0.01, 0.6))
        clearness = float(np.clip(clearness, 1.0, 12.0 - 1e-3))
        diffuse_irrad = max(0.0, brightness * SOLAR_E * _eccentricity(day)
                            / _air_mass(sz))
        c = 1.041 * sz ** 3
        direct_irrad = float(np.clip(
            (clearness * (1 + c) - c) * diffuse_irrad - diffuse_irrad,
            0.0, SOLAR_E))
    else:
        diffuse_irrad = max(0.0, diffuse_irrad)
        direct_irrad = float(np.clip(direct_irrad, 0.0, SOLAR_E))
        brightness = float(np.clip(
            diffuse_irrad * _air_mass(sz) / (SOLAR_E * _eccentricity(day)),
            0.01, 0.6))
        c = 1.041 * sz ** 3
        clearness = float(np.clip(
            ((diffuse_irrad + direct_irrad) / max(diffuse_irrad, 1e-6) + c) / (1 + c),
            1.0, 12.0 - 1e-3))
    return PerezModel(
        brightness, clearness, direct_irrad, diffuse_irrad,
        direct_irrad * _efficacy(_DIR_EFF, brightness, clearness, sz, True),
        diffuse_irrad * _efficacy(_DIFF_EFF, brightness, clearness, sz),
        _explicit_params(brightness, clearness, sz))


def _perez_eval(cos_sun, cos_theta, p):
    sun_a = np.arccos(np.clip(cos_sun, -1, 1))
    A = 1 + p[0] * np.exp(p[1] / np.maximum(cos_theta, 1e-5))
    B = 1 + p[2] * np.exp(p[3] * sun_a) + p[4] * cos_sun * cos_sun
    return A * B


def _perez_integrate(sz, p):
    cs, ss = math.cos(sz), math.sin(sz)
    total = 0.0
    for th, ph in zip(_THETA_BASE, _PHI_BASE):
        t, f = math.radians(th), math.radians(ph)
        ct, st = math.cos(t), math.sin(t)
        cos_sun = min(1.0, cs * ct + ss * st * math.cos(f))
        total += float(_perez_eval(cos_sun, ct, p)) * ct
    return 2 * math.pi * total / 145.0


def bake_perez(sun_dir, model: PerezModel, tint=(1, 1, 1), ground=(0.2,) * 3,
               has_ground=True, has_sun=True, output="visibleradiance",
               res_az=512, res_el=512):
    """Returns (sky_img [h,w,3], sun_radiance rgb | None, cos_sun_angle)."""
    sun = np.asarray(sun_dir, np.float64)
    sun = sun / np.linalg.norm(sun)
    tint = np.asarray(tint, np.float64)
    ground = np.asarray(ground, np.float64)
    sin_alt = float(np.clip(sun[1], -1, 1))
    solar_alt = math.asin(sin_alt)
    sz = math.pi / 2 - solar_alt

    integrand = _perez_integrate(sz, model.params)
    num = {"visibleradiance": model.diffuse_illum / WHITE_EFFICIENCY,
           "solarradiance": model.diffuse_irrad,
           "luminance": model.diffuse_illum}[output]
    diffnorm = num / max(integrand, 1e-9)
    sun_num = {"visibleradiance": model.direct_illum / WHITE_EFFICIENCY,
               "solarradiance": model.direct_irrad,
               "luminance": model.direct_illum}[output]
    sun_color = tint * sun_num
    sky_color = tint * diffnorm
    zenith = sky_color * float(_perez_eval(sin_alt, 1.0, model.params))

    if model.clearness == 1:
        normfactor = 0.777778
    elif model.clearness < 6:
        f2 = ((2.739 + 0.9891 * math.sin(0.3119 + 2.6 * solar_alt))
              * math.exp(-sz * (0.4441 + 1.48 * solar_alt)))
        x = solar_alt / (math.pi / 4) - 1
        nsc = (((0.60227 * x + 1.0660) * x - 1.3081) * x - 2.7152) * x + 3.5556
        normfactor = nsc / max(f2, 1e-9) / math.pi
    else:
        f2 = 0.274 * (0.91 + 10 * math.exp(-3 * sz) + 0.45 * sin_alt * sin_alt)
        x = solar_alt / (math.pi / 4) - 1
        nsc = (((0.059229 * x + 0.009237) * x - 0.369832) * x + 0.547665) * x \
            + 2.766521
        normfactor = nsc / max(f2, 1e-9) / math.pi

    sunny = has_sun and model.clearness > 1
    actual_ground = ground * (
        (sun_color * abs(sin_alt) / math.pi if sunny else 0.0)
        + zenith * normfactor)
    sun_factor = 2 * math.pi * (1 - math.cos(math.radians(SUN_RADIUS_DEG / 2)))
    actual_sun = sun_color / sun_factor if sunny else None

    d = _dir_grid(res_az, res_el)
    cos_theta = d[..., 1]
    cos_sun = np.clip(np.tensordot(d, sun, axes=([2], [0])), -1, 1)
    fac = _perez_eval(cos_sun, cos_theta, model.params)
    img = _cie_wmean(cos_theta, sky_color * fac[..., None], actual_ground)
    if not has_ground:
        img = np.where(cos_theta[..., None] < 0, 0.0, img)
    cos_angle = math.cos(math.radians(SUN_RADIUS_DEG / 2))
    return img.astype(np.float32), actual_sun, cos_angle
