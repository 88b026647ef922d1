"""Sun utilities for the light loader (copies from ignis_tpu/models/skysun.py:
the elevation/azimuth direction, the solar position and the sun disk's
area). The Hosek-Wilkie sky bake is ROADMAP queue 1, item 16.
"""
from __future__ import annotations

import math

import numpy as np


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


SUN_RADIUS_DEG = 0.533  # full angular diameter (sun.art:1)


def sun_cos_angle(angle_deg=SUN_RADIUS_DEG):
    return math.cos(math.radians(angle_deg / 2))


def sun_area_from_angle(angle_deg=SUN_RADIUS_DEG):
    srad = math.tan(math.radians(angle_deg / 2))
    return math.pi * srad * srad
