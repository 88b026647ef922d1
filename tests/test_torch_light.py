"""CDFs and lights of ignis_tpu_torch against ignis_tpu.

- core/cdf: the conditional, summed-area and hierarchical tables of a
  128x64 substitute env (utils/envgen) built by both packages (within
  1e-5: numpy and XLA associate float32 prefix sums apart), then, from
  the same tables, sample (x, y, pdf) and pdf at random points: within rtol 1e-5 / atol 1e-7 on at least 99.9% of lanes (a
  search may land on the other side of a boundary where the two packages
  round the rescaled uniform apart), and the pdf on every lane; the
  sample/pdf and integration invariants of tests/test_components.py:627.
- models/light: one scene with every light kind (point, spot,
  directional, area over triangles and over an analytic sphere, sun,
  textured env), bridged from ignis_tpu.build_scene, under each env
  method: sample_direct from random points on both sides, env_emission
  and env_pdf_direct on random directions, and select_light and
  selector_pdf under the uniform, cdf and hierarchy selectors: within
  rtol 1e-5 / atol 1e-6 on at least 99.9% of lanes (env_emission within
  rtol 1e-4: at the env's horizon, where the texture jumps, a one-ulp
  apart theta moves the bilinear lookup by 2e-5 relative).
"""
import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import ignis_tpu
from ignis_tpu.core import cdf as jcdf
from ignis_tpu.core.vec import Vec3 as JVec3
from ignis_tpu.models import light as JL
from ignis_tpu.models.texture import make_texture_evaluator as jtex_eval

from ignis_tpu_torch.bridge import from_reference
from ignis_tpu_torch.core import cdf
from ignis_tpu_torch.core.vec import Vec3
from ignis_tpu_torch.models import light as L
from ignis_tpu_torch.models.texture import make_texture_evaluator
from ignis_tpu_torch.utils.envgen import (ensure_substitute_env,
                                          make_substitute_env)

# The tensors here are small; one intra-op thread per test process keeps
# parallel test workers from oversubscribing the cores.
torch.set_num_threads(1)

N = 8192


def _weights():
    img = make_substitute_env(128, 64)
    w = img.mean(-1)[::-1]
    s = np.sin(np.pi * (np.arange(64) + 0.5) / 64)[:, None]
    return np.ascontiguousarray(w * s, np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _share(a, b, rtol, atol):
    return np.isclose(np.asarray(a), np.asarray(b), rtol=rtol,
                      atol=atol).mean()


METHODS = ("conditional", "sat", "hierachical")


def _tables(method):
    w = _weights()
    if method == "conditional":
        j = jcdf.build_cdf_2d(jnp.asarray(w))
        t = cdf.build_cdf_2d(w)
        port = cdf.CDF2D(*[_t(a) for a in j])
        return (j, jcdf.sample_cdf_2d, jcdf.pdf_cdf_2d), (
            t, port, cdf.sample_cdf_2d, cdf.pdf_cdf_2d)
    if method == "sat":
        j = jcdf.build_sat_2d(w)
        t = cdf.build_sat_2d(w)
        port = cdf.SAT2D(*[_t(a) for a in j])
        return (j, jcdf.sample_sat_2d, jcdf.pdf_sat_2d), (
            t, port, cdf.sample_sat_2d, cdf.pdf_sat_2d)
    j = jcdf.build_hier_2d(w)
    t = cdf.build_hier_2d(w)
    port = cdf.Hier2D(tuple(_t(a) for a in j.levels))
    return (j, jcdf.sample_hier_2d, jcdf.pdf_hier_2d), (
        t, port, cdf.sample_hier_2d, cdf.pdf_hier_2d)


@pytest.mark.parametrize("method", METHODS)
def test_cdf_matches_jax(method):
    (jt, jsample, jpdf), (own, port, tsample, tpdf) = _tables(method)
    jl = jt.levels if method == "hierachical" else tuple(jt)
    tl = own.levels if method == "hierachical" else tuple(own)
    assert len(jl) == len(tl)
    for a, b in zip(tl, jl):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)
    rs = np.random.RandomState(METHODS.index(method))
    u, v = [rs.rand(N).astype(np.float32) for _ in range(2)]
    u[:4] = (0.0, 1.0 - 2 ** -24, 0.5, 0.25)
    jx, jy, jp = jsample(jt, jnp.asarray(u), jnp.asarray(v))
    tx, ty, tp = tsample(port, _t(u), _t(v))
    for a, b in ((tx, jx), (ty, jy), (tp, jp)):
        assert _share(a.numpy(), b, 1e-5, 1e-7) >= 0.999
    x, y = [rs.rand(N).astype(np.float32) for _ in range(2)]
    np.testing.assert_allclose(tpdf(port, _t(x), _t(y)).numpy(),
                               np.asarray(jpdf(jt, jnp.asarray(x),
                                               jnp.asarray(y))),
                               rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("method", METHODS)
def test_cdf_sample_pdf_invariants(method):
    """tests/test_components.py:627 on the port: samples lie in the unit
    square with pdf > 0, pdf() agrees with the sampler's density, and
    E[g/p] over the method's own density grid is the grid mean."""
    rs = np.random.RandomState(3)
    wgrid = ((rs.rand(37, 61) ** 4) * 10 + 0.01).astype(np.float32)
    u, v = [_t(rs.rand(20000).astype(np.float32)) for _ in range(2)]
    build = {"conditional": cdf.build_cdf_2d, "sat": cdf.build_sat_2d,
             "hierachical": cdf.build_hier_2d}[method]
    sample = {"conditional": cdf.sample_cdf_2d, "sat": cdf.sample_sat_2d,
              "hierachical": cdf.sample_hier_2d}[method]
    pdf = {"conditional": cdf.pdf_cdf_2d, "sat": cdf.pdf_sat_2d,
           "hierachical": cdf.pdf_hier_2d}[method]
    tab = build(wgrid)
    x, y, p = sample(tab, u, v)
    x, y, p = x.numpy(), y.numpy(), p.numpy()
    assert ((x >= 0) & (x <= 1) & (y >= 0) & (y <= 1)).all() and (p > 0).all()
    np.testing.assert_allclose(p, pdf(tab, _t(x), _t(y)).numpy(), rtol=2e-2,
                               atol=1e-5)
    grid = tab.levels[0].numpy() if method == "hierachical" else wgrid
    h, w = grid.shape
    g = grid[np.minimum((y * h).astype(int), h - 1),
             np.minimum((x * w).astype(int), w - 1)]
    assert abs(float(np.mean(g / p)) / float(grid.mean()) - 1.0) < 0.02


def test_cdf_column_search_stays_flat():
    """The conditional sampler never makes a [lanes, width] tensor: its
    column search gathers one entry per lane per step (bit_length(w)
    steps)."""
    (_, _, _), (_, port, _, _) = _tables("conditional")
    w = port.conditional.shape[1]
    made = []
    orig = torch.Tensor.__getitem__

    def spy(self, idx):
        out = orig(self, idx)
        made.append(out.numel())
        return out
    torch.Tensor.__getitem__ = spy
    try:
        cdf.sample_cdf_2d(port, torch.rand(1000), torch.rand(1000))
    finally:
        torch.Tensor.__getitem__ = orig
    assert max(made) <= 1000 < 1000 * w


# --- lights -----------------------------------------------------------------

def light_scene(env_file, method, selector="uniform"):
    """One light of every kind around a small room: the scene of
    tests/test_components.py:464 with a directional light, a sun, an area
    light on an analytic sphere and a textured env under `method`."""
    return {
        "technique": {"type": "path", "max_depth": 3,
                      "light_selector": selector},
        "camera": {"type": "perspective", "fov": 60,
                   "transform": [1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, -2]},
        "film": {"size": [16, 16]},
        "textures": [{"type": "image", "name": "E",
                      "filename": str(env_file)}],
        "bsdfs": [{"type": "diffuse", "name": "g",
                   "reflectance": [0.8, 0.8, 0.8]},
                  {"type": "diffuse", "name": "black",
                   "reflectance": [0, 0, 0]}],
        "shapes": [{"type": "rectangle", "name": "B", "width": 4,
                    "height": 4, "flip_normals": True},
                   {"type": "rectangle", "name": "L", "width": 0.4,
                    "height": 0.4},
                   {"type": "sphere", "name": "S", "radius": 0.2}],
        "entities": [{"name": "B", "shape": "B", "bsdf": "g"},
                     {"name": "L", "shape": "L", "bsdf": "black",
                      "transform": [{"translate": [1.2, 0.5, -1.0]}]},
                     {"name": "S", "shape": "S", "bsdf": "black",
                      "transform": [{"translate": [-0.8, 0.6, -0.5]}]}],
        "lights": [
            {"type": "area", "name": "L", "entity": "L",
             "radiance": [6, 6, 6]},
            {"type": "point", "name": "P1", "position": [-1.2, 0.8, -1.2],
             "intensity": [2, 2, 2]},
            {"type": "spot", "name": "SP", "position": [0.5, -1.0, -1.2],
             "direction": [0, 0.5, 1], "intensity": [3, 3, 3],
             "cutoff": 40, "falloff": 25},
            {"type": "area", "name": "SA", "entity": "S",
             "radiance": [2, 3, 4]},
            {"type": "directional", "name": "D", "direction": [0.2, -1, 0.4],
             "irradiance": [0.5, 0.5, 0.6]},
            {"type": "sun", "name": "SUN", "direction": [-0.3, 0.7, -0.6],
             "irradiance": [1, 0.9, 0.8], "angle": 8.0},
            {"type": "env", "name": "E", "radiance": "E", "cdf": method},
        ],
    }


@pytest.fixture(scope="module")
def env_file(tmp_path_factory):
    return ensure_substitute_env(tmp_path_factory.mktemp("env"), 128, 64)


_BUILT = {}


def built(env_file, method, selector="uniform"):
    key = (method, selector)
    if key not in _BUILT:
        rt = ignis_tpu.loadFromString(json.dumps(
            light_scene(env_file, method, selector)))
        assert rt.warnings == []
        scene, settings = from_reference(rt.scene, rt.settings, "cpu")
        _BUILT[key] = rt, scene, settings
    return _BUILT[key]


def _points(seed, n=N):
    rs = np.random.RandomState(seed)
    p = rs.uniform(-1.5, 1.5, (n, 3)).astype(np.float32)
    p[:, 2] = rs.uniform(-1.8, 0.2, n)
    return p, rs.rand(n) < 0.7, [rs.rand(n).astype(np.float32)
                                 for _ in range(3)]


def _dirs(seed, n=N):
    v = np.random.RandomState(seed).randn(n, 3)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    # aim some directions into the sun's cone
    v[:64] = np.asarray([-0.3, 0.7, -0.6]) / np.linalg.norm([-0.3, 0.7,
                                                             -0.6])
    return v.astype(np.float32)


def _j3(a):
    return JVec3(*[jnp.asarray(a[:, i]) for i in range(3)])


def _t3(a):
    return Vec3(*[torch.from_numpy(a[:, i].copy()) for i in range(3)])


def _leaves(x):
    if isinstance(x, tuple):
        return [c for v in x for c in _leaves(v)]
    return [x]


def _assert_close(t, j, rtol=1e-5, atol=1e-6, share=0.999, what=""):
    for a, b in zip(_leaves(t), _leaves(j)):
        a, b = a.numpy(), np.asarray(b)
        if a.dtype == bool:
            got = (a == b).mean()
        else:
            got = _share(a, b, rtol, atol)
        assert got >= share, (what, got)


@pytest.mark.parametrize("method", METHODS)
def test_sample_direct_matches_jax(env_file, method):
    """Each light row's sample_direct at random points, sides and
    uniforms."""
    rt, scene, settings = built(env_file, method)
    jev = jtex_eval(rt.settings.texture_descs, rt.scene.textures)
    tev = make_texture_evaluator(settings.texture_descs, scene.textures)
    p, ent, (u0, u1, _) = _points(11)
    n_l = int(scene.lights.kind.numel())
    rows = np.random.RandomState(12).randint(0, n_l, N).astype(np.int32)
    jlp = JL.gather_light(rt.scene.lights, jnp.asarray(rows))
    tlp = L.gather_light(scene.lights, torch.from_numpy(rows))
    js = JL.sample_direct(rt.scene, jlp, _j3(p), jnp.asarray(ent),
                          jnp.asarray(u0), jnp.asarray(u1), jev)
    ts = L.sample_direct(scene, tlp, _t3(p), torch.from_numpy(ent),
                         torch.from_numpy(u0), torch.from_numpy(u1), tev)
    _assert_close(ts, js, what=method)
    # pruned by the scene's light kinds: the same samples
    tp = L.sample_direct(scene, tlp, _t3(p), torch.from_numpy(ent),
                         torch.from_numpy(u0), torch.from_numpy(u1), tev,
                         settings.light_kinds)
    for a, b in zip(_leaves(tp), _leaves(ts)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("method", METHODS)
def test_env_emission_and_pdf_match_jax(env_file, method):
    rt, scene, settings = built(env_file, method)
    jev = jtex_eval(rt.settings.texture_descs, rt.scene.textures)
    tev = make_texture_evaluator(settings.texture_descs, scene.textures)
    d = _dirs(13)
    for row in settings.infinite_light_rows:
        rows = np.full(N, row, np.int32)
        jlp = JL.gather_light(rt.scene.lights, jnp.asarray(rows))
        tlp = L.gather_light(scene.lights, torch.from_numpy(rows))
        _assert_close(L.env_emission(scene, tlp, _t3(d), tev,
                                     settings.light_kinds),
                      JL.env_emission(rt.scene, jlp, _j3(d), jev),
                      rtol=1e-4, what=(method, row, "emission"))
        _assert_close(L.env_pdf_direct(scene, tlp, _t3(d),
                                       settings.light_kinds),
                      JL.env_pdf_direct(rt.scene, jlp, _j3(d)),
                      what=(method, row, "pdf"))


@pytest.mark.parametrize("method", METHODS)
def test_env_sample_pdf_agree(env_file, method):
    """The env light's sampled solid-angle pdf equals env_pdf_direct in
    the sampled direction (what MIS needs), on the port alone."""
    _, scene, settings = built(env_file, method)
    tev = make_texture_evaluator(settings.texture_descs, scene.textures)
    row = [r for r in settings.infinite_light_rows
           if int(scene.lights.kind[r]) == L.LightKind.ENV][0]
    p, ent, (u0, u1, _) = _points(14)
    lp = L.gather_light(scene.lights, torch.full((N,), row))
    s = L.sample_direct(scene, lp, _t3(p), torch.from_numpy(ent),
                        torch.from_numpy(u0), torch.from_numpy(u1), tev)
    back = L.env_pdf_direct(scene, lp, s.dir)
    ok = (s.pdf_value > 1e-3).numpy()
    assert ok.mean() > 0.9
    np.testing.assert_allclose(back.numpy()[ok], s.pdf_value.numpy()[ok],
                               rtol=2e-2)


@pytest.mark.parametrize("selector", ["uniform", "cdf", "hierarchy"])
def test_selectors_match_jax(env_file, selector):
    rt, scene, settings = built(env_file, "conditional", selector)
    assert settings.light_selector == selector
    p, _, (u, _, _) = _points(15)
    jidx, jpdf = JL.select_light(rt.settings, rt.scene.lights,
                                 jnp.asarray(u), _j3(p))
    tidx, tpdf = L.select_light(settings, scene.lights, torch.from_numpy(u),
                                _t3(p))
    assert (tidx.numpy() == np.asarray(jidx)).mean() >= 0.999
    assert _share(tpdf.numpy(), jpdf, 1e-5, 1e-7) >= 0.999
    # the pdf of every row, from every point
    n_l = int(scene.lights.kind.numel())
    rows = np.random.RandomState(16).randint(0, n_l, N).astype(np.int32)
    jsp = JL.selector_pdf(rt.settings, rt.scene.lights, jnp.asarray(rows),
                          _j3(p))
    tsp = L.selector_pdf(settings, scene.lights, torch.from_numpy(rows),
                         _t3(p))
    np.testing.assert_allclose(tsp.numpy(), np.asarray(jsp), rtol=1e-5,
                               atol=1e-7)
    # selecting and then asking the pdf of what was picked agree
    back = L.selector_pdf(settings, scene.lights, tidx, _t3(p))
    np.testing.assert_allclose(back.numpy(), tpdf.numpy(), rtol=1e-5)
    if selector == "hierarchy":
        depth = L.hier_depth(scene.lights)
        assert depth >= 2
        again = L.select_light(settings, scene.lights, torch.from_numpy(u),
                               _t3(p), depth)
        assert torch.equal(again[0], tidx) and torch.equal(again[1], tpdf)


def test_sun_area_from_angle_matches_jax():
    from ignis_tpu.models.skysun import sun_area_from_angle as jarea
    from ignis_tpu_torch.models.skysun import sun_area_from_angle
    for a in (0.1, 0.533, 8.0):
        assert sun_area_from_angle(a) == pytest.approx(float(jarea(a)),
                                                       rel=1e-12)
