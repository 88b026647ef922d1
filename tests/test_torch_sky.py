"""The sky models of ignis_tpu_torch against ignis_tpu, on the CPU.

The CIE (uniform, cloudy, clear, intermediate) and perez bakes are numpy
copies of the JAX package's: their images, and perez's sun, must be
exactly equal for several sun directions and parameters. The Hosek-Wilkie
`sky` bake is the JAX package's with two faults fixed (ROADMAP queue 3):
the reference's own bake overflows float32 for these suns, and the
port's is held to an independent transcription of the published model
(ArHosekSkyModel_CookConfiguration and GetRadianceInternal, over the flat
dataset) at a set of pixels, within rtol 1e-5. Then renders at spi 1,
32x32 of a scene under each CIE sky and under perez with and without its
sun, against the JAX package by the render bar of
tests/test_torch_render.py, and the `sky` scene finite and lit."""
import json
import math

import numpy as np
import pytest
import torch

from ignis_tpu.models import daylight as jday
from ignis_tpu.models import skysun as jsky
from ignis_tpu_torch.models import daylight as tday
from ignis_tpu_torch.models import skysun as tsky

import ignis_tpu_torch
from test_components import BASE
from test_torch_pexpr import render_bar, render_both

# The tensors here are small; one intra-op thread per test process keeps
# parallel test workers from oversubscribing the cores.
torch.set_num_threads(1)

SUNS = [(0.3, 0.8, 0.4), (0.0, 1.0, 0.0), (-0.6, 0.25, 0.2),
        (0.9, 0.05, -0.3)]


def _unit(d):
    d = np.asarray(d, np.float64)
    return d / np.linalg.norm(d)


@pytest.mark.parametrize("kind", ["uniform", "cloudy", "clear",
                                  "intermediate"])
@pytest.mark.parametrize("sun", range(len(SUNS)))
def test_bake_cie_matches_jax(kind, sun):
    args = (kind, _unit(SUNS[sun]), (1.0, 0.9, 0.8), (0.5, 0.4, 0.3), 0.3,
            2.8, sun % 2 == 0, (1.0, 1.0, 1.2))
    a = tday.bake_cie(*args, res_az=128, res_el=64)
    b = jday.bake_cie(*args, res_az=128, res_el=64)
    assert a.dtype == b.dtype and np.isfinite(a).all()
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("model", [
    {"brightness": 0.2, "clearness": 1.0},
    {"brightness": 0.3, "clearness": 6.0},
    {"brightness": 0.1, "clearness": 11.0},
    {"diffuse_irrad": 120.0, "direct_irrad": 600.0}])
@pytest.mark.parametrize("sun", range(len(SUNS)))
def test_bake_perez_matches_jax(model, sun):
    d = _unit(SUNS[sun])
    sz = math.pi / 2 - math.asin(d[1])
    ma, mb = tday.perez_model(sz, 150, **model), jday.perez_model(sz, 150,
                                                                   **model)
    assert tuple(ma) == tuple(mb)
    for output in ("visibleradiance", "solarradiance"):
        a = tday.bake_perez(d, ma, (1.0, 0.95, 0.9), (0.3, 0.3, 0.2),
                            sun % 2 == 0, True, output, 128, 64)
        b = jday.bake_perez(d, mb, (1.0, 0.95, 0.9), (0.3, 0.3, 0.2),
                            sun % 2 == 0, True, output, 128, 64)
        np.testing.assert_array_equal(a[0], b[0])
        assert (a[1] is None) == (b[1] is None) and a[2] == b[2]
        if a[1] is not None:
            np.testing.assert_array_equal(a[1], b[1])


def _official_sky(d, theta, gamma_cos, turbidity=3.0,
                  albedo=(0.8, 0.8, 0.8)):
    """The published Hosek-Wilkie RGB model at one direction, in python
    floats over the flat dataset (9 coefficients a control point, 6
    control points, 10 turbidities, 2 albedos): radiance per channel over
    CIE_Y_SUM, as the bake scales it."""
    data = np.load(tsky.Path(tsky.__file__).resolve().parent.parent
                   / "data" / "hosek_rgb.npz")
    elevation = max(math.pi / 2 - math.acos(min(max(d[1], -1.0), 1.0)), 0.0)
    se = (elevation / (math.pi / 2)) ** (1.0 / 3.0)
    w = [(1 - se) ** 5, 5 * (1 - se) ** 4 * se, 10 * (1 - se) ** 3 * se ** 2,
         10 * (1 - se) ** 2 * se ** 3, 5 * (1 - se) * se ** 4, se ** 5]
    ti = int(turbidity)
    tr = turbidity - ti
    out = []
    for ch in range(3):
        cfg = data["config"][ch].reshape(-1)
        rad = data["radiance"][ch].reshape(-1)
        a = albedo[ch]

        def blend(flat, stride, n, alb, t):
            base = alb * stride * 6 * 10 + stride * 6 * (t - 1)
            return [sum(w[k] * float(flat[base + i + stride * k])
                        for k in range(6)) for i in range(n)]
        parts = [((1 - a) * (1 - tr), 0, ti), (a * (1 - tr), 1, ti)]
        if ti < 10:
            parts += [((1 - a) * tr, 0, ti + 1), (a * tr, 1, ti + 1)]
        c = [0.0] * 9
        r = 0.0
        for wt, alb, t in parts:
            c = [x + wt * y for x, y in zip(c, blend(cfg, 9, 9, alb, t))]
            r += wt * blend(rad, 1, 1, alb, t)[0]
        A, B, C, D, E, F, G, I, H = c
        gamma = math.acos(min(max(gamma_cos, -1.0), 1.0))
        cg = math.cos(gamma)
        mie = (1.0 + cg * cg) / (1.0 + H * H - 2.0 * H * cg) ** 1.5
        ct = math.cos(theta)
        f = ((1.0 + A * math.exp(B / (ct + 0.01)))
             * (C + D * math.exp(E * gamma) + F * cg * cg + G * mie
                + I * math.sqrt(max(ct, 0.0))))
        out.append(max(f * r / tsky.CIE_Y_SUM, 0.0))
    return out


@pytest.mark.parametrize("sun", range(len(SUNS)))
def test_bake_sky_matches_the_published_model(sun):
    """The port's Hosek-Wilkie bake at 24 pixels of the sky half against
    _official_sky, within rtol 1e-5; the ground half is black. The JAX
    package's bake of the same sun overflows float32 on the first two
    suns (its dataset read as [9][6] and H / I swapped)."""
    d = _unit(SUNS[sun])
    res_az, res_el = 64, 32
    img = tsky.bake_sky(d, 3.0, (0.8, 0.8, 0.8), res_az, res_el)
    assert img.shape == (2 * res_el, res_az, 3) and np.isfinite(img).all()
    assert (img[res_el:] == 0).all() and img[:res_el].max() > 0
    sun_az = math.atan2(d[2], d[0])
    sun_theta = math.acos(min(max(d[1], -1.0), 1.0))
    sun_theta = min(sun_theta, math.pi / 2)
    rs = np.random.RandomState(sun)
    for r, c in zip(rs.randint(0, res_el, 24), rs.randint(0, res_az, 24)):
        theta = (math.pi / 2) * (r + 0.5) / res_el
        az = 2 * math.pi * (c + 0.5) / res_az - math.pi / 2
        cos_gamma = (math.cos(theta) * math.cos(sun_theta)
                     + math.sin(theta) * math.sin(sun_theta)
                     * math.cos(az - sun_az))
        np.testing.assert_allclose(img[r, c], _official_sky(d, theta,
                                                            cos_gamma),
                                   rtol=1e-5, atol=1e-9)
    if sun < 2:
        with np.errstate(all="ignore"):
            ref = jsky.bake_sky(d, 3.0, (0.8, 0.8, 0.8), res_az, res_el)
        assert not np.isfinite(ref).all() or ref.max() > 1e30


def sky_scene(light):
    sc = json.loads(json.dumps(BASE))
    sc["camera"]["transform"] = [1, 0, 0, 0, 0, 0, 1, 0, 0, -1, 0, -2]
    sc["lights"] = [light]
    return sc


@pytest.mark.parametrize("light", [
    {"type": "cie_uniform", "zenith": [1, 1, 1]},
    {"type": "ciecloudy", "ground_brightness": 0.3},
    {"type": "cie_clear", "turbidity": 3.0, "has_ground": False},
    {"type": "cieintermediate", "scale": [0.5, 0.5, 0.6]},
    {"type": "perez", "clearness": 6, "brightness": 0.2},
    {"type": "perez", "has_sun": False, "clearness": 6},
    {"type": "perez", "diffuse_irradiance": 100,
     "direct_irradiance": 500},
], ids=["cie_uniform", "cie_cloudy", "cie_clear", "cie_intermediate",
        "perez_sun", "perez_nosun", "perez_irradiance"])
def test_sky_scene_renders_as_jax(light):
    got, ref, rt = render_both(sky_scene({**light, "name": "s",
                                          "direction": [0.3, 0.8, 0.4]}))
    render_bar(got, ref)
    assert rt.scene.envmap.present and got.mean() > 0


def test_hosek_sky_scene_renders():
    """The `sky` light on the port: a textured env of the fixed bake, with
    its conditional CDF; finite and lit."""
    rt = ignis_tpu_torch.loadFromString(json.dumps(sky_scene(
        {"type": "sky", "name": "s", "direction": [0.3, 0.8, 0.4],
         "turbidity": 4.0})), device="cpu", spi=4)
    img = rt.step().framebuffer(normalized=True).numpy()
    assert rt.warnings == [] and bool(rt.scene.envmap.present)
    assert np.isfinite(img).all() and img.mean() > 0
    assert torch.isfinite(rt.scene.envmap.marginal).all()
