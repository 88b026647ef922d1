"""ignis_tpu_torch's other techniques against ignis_tpu on the CPU, on
the same scene arrays (bridged from one `ignis_tpu.build_scene`) and the
same random streams:

- ao, debug (every mode), wireframe, lightvisibility, camera_check,
  env_check and the info buffer per pixel, on one camera sample of
  tests/test_compaction.py's scene with a textured floor (one jitted JAX
  program for all of them);
- the light tracer's film, the photon map and grid (order and offsets
  exact), the PPM render, aept's histograms, guiding CDFs and guided
  render, at 32x32 with small photon counts;
- the building blocks: sample_emission for every light kind,
  sample_pixel, the new warps;
- every technique name and alias through `technique=` and
  Runtime.step(), and Runtime.render_aovs();
- the JAX tests' oracles on the port: the light tracer and PPM against
  the path tracer (tests/test_lighttracer.py, tests/test_ppm.py), and
  tests/test_components.py's aept and check-technique oracles, whose PExpr
  `expr` env textures are swapped for an image env made with numpy and a
  constant env (tests/test_torch_pexpr.py holds PExpr textures).
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ignis_tpu
import ignis_tpu_torch
from ignis_tpu.render.session import render_iteration as jax_iteration
from ignis_tpu_torch.bridge import from_reference
from ignis_tpu_torch.core import rng as rnglib
from ignis_tpu_torch.core.sampler import sample_pixel_offsets
from ignis_tpu_torch.core.vec import Vec3
from ignis_tpu_torch.models import camera
from ignis_tpu_torch.models import light as lightlib
from ignis_tpu_torch.ops import gather
from ignis_tpu_torch.render.session import Runtime, render_iteration
from ignis_tpu_torch.techniques import (ALIASES, SIMPLE, aept, lighttracer,
                                       ppm, simple)
from ignis_tpu_torch.techniques.path import render_tables

from test_compaction import SCENE as COMPACTION_SCENE
from test_components import BASE as COMPONENTS_BASE
from test_lighttracer import SCENE as LT_SCENE

torch.set_num_threads(1)

SIZE = 32
N_DEBUG_MODES = 28


def _checker_floor(scene):
    """The scene with its first material's reflectance a checkerboard."""
    sc = json.loads(json.dumps(scene))
    sc["textures"] = [{"type": "checkerboard", "name": "chk",
                       "scale_x": 5.3, "scale_y": 4.7,
                       "color0": [0.2, 0.6, 0.3], "color1": [0.8, 0.7, 0.6]}]
    sc["bsdfs"][0]["reflectance"] = "chk"
    sc["film"] = {"size": [SIZE, SIZE]}
    return sc


def _camera_sample(scene, settings):
    """Sample 0 of iteration 0 of every pixel, as the per-sample loop of
    both Runtimes makes it: (rays, random state after the pixel offsets)."""
    w, h = settings.width, settings.height
    x = torch.arange(w).repeat(h)
    y = torch.arange(h).repeat_interleave(w)
    state = rnglib.seed(0, 0, 0, x, y, settings.seed)
    state, (rx, ry) = sample_pixel_offsets(settings.pixel_sampler, state, 0,
                                           x, y)
    return camera.generate_rays(scene.camera, settings, x, y, rx, ry,
                                rng_state=state), state


def _to_jax(rays, state):
    from ignis_tpu.core.vec import Vec3 as JVec3
    from ignis_tpu.ops.intersect import Rays as JRays
    j = lambda t: jnp.asarray(t.numpy())  # noqa: E731
    return (JRays(JVec3(*[j(c) for c in rays.org]),
                  JVec3(*[j(c) for c in rays.dir]), j(rays.tmin),
                  j(rays.tmax)),
            jnp.asarray(state.numpy().astype(np.uint32)))


@pytest.fixture(scope="module")
def simple_views():
    """(port results, JAX results) of every simple technique, every debug
    mode and the info buffer on one camera sample; the JAX side is one
    jitted program."""
    from ignis_tpu.models.texture import make_texture_evaluator
    from ignis_tpu.techniques import simple as jsimple
    rt = ignis_tpu.loadFromString(json.dumps(
        _checker_floor(COMPACTION_SCENE)))
    scene, settings = from_reference(rt.scene, rt.settings, "cpu")
    rays, state = _camera_sample(scene, settings)
    jrays, jstate = _to_jax(rays, state)
    js = rt.settings
    fns = {"ao": jsimple.ao_trace, "debug": jsimple.debug_trace,
           "wireframe": jsimple.wireframe_trace,
           "lightvisibility": jsimple.light_visibility_trace,
           "camera_check": jsimple.camera_check_trace,
           "env_check": jsimple.env_check_trace}

    def run(sc, r, st):
        ev = make_texture_evaluator(js.texture_descs, sc.textures)
        out = {k: f(sc, js, r, st, eval_texture=ev) for k, f in fns.items()}
        for m in range(N_DEBUG_MODES):
            out[f"debug{m}"] = jsimple.debug_trace(
                sc, dataclasses.replace(js, debug_mode=m), r, st, ev)
        out["info"] = jsimple.info_buffer(sc, js, r, st, ev)
        return out
    ref = jax.jit(run)(rt.scene, jrays, jstate)
    tabs = render_tables(scene, settings)
    got = {k: simple.TRACES[k](scene, settings, rays, state, tabs)
           for k in SIMPLE}
    for m in range(N_DEBUG_MODES):
        got[f"debug{m}"] = simple.debug_trace(
            scene, dataclasses.replace(settings, debug_mode=m), rays, state,
            tabs)
    got["info"] = simple.info_buffer(scene, settings, rays, state, tabs)
    return got, ref


def _assert_colors(got, ref, tol=1e-5, share=1.0):
    """Every channel of `got` against `ref` within `tol` (abs and rel) on
    `share` of the lanes."""
    for a, b in zip(got, ref):
        a, b = a.numpy(), np.asarray(b)
        ok = np.isclose(a, b, rtol=tol, atol=tol)
        assert ok.mean() >= share, (ok.mean(), np.abs(a - b).max())


@pytest.mark.parametrize("tech", SIMPLE)
def test_simple_technique_matches_jax(simple_views, tech):
    """One sample per pixel of each simple technique equal to the JAX
    package's within 1e-5 on every pixel (binary views exactly)."""
    got, ref = simple_views
    _assert_colors(got[tech], ref[tech])
    assert float(sum(c.sum() for c in got[tech])) > 0


@pytest.mark.parametrize("mode", range(N_DEBUG_MODES))
def test_debug_mode_matches_jax(simple_views, mode):
    """Each of the 28 debug views (DebugMode.cpp's order) within 1e-4 of
    the JAX package's on every pixel (1e-5 on 99.9%: XLA contracts some
    products of the hit's barycentrics into FMAs)."""
    got, ref = simple_views
    _assert_colors(got[f"debug{mode}"], ref[f"debug{mode}"], tol=1e-4)
    _assert_colors(got[f"debug{mode}"], ref[f"debug{mode}"], share=0.999)


def test_info_buffer_matches_jax(simple_views):
    """Normals, textured albedo (white on a miss) and depth per pixel
    within 1e-5."""
    got, ref = simple_views
    for a, b in zip(got["info"], ref["info"]):
        _assert_colors(a, b)


@pytest.fixture(scope="module")
def lt_scene():
    """tests/test_lighttracer.py's box at 32x32, spi 4, bridged."""
    sc = json.loads(json.dumps(LT_SCENE))
    sc["film"] = {"size": [SIZE, SIZE]}
    sc["technique"]["type"] = "lt"
    rt = ignis_tpu.loadFromString(json.dumps(sc), spi=4, photons=4000)
    scene, settings = from_reference(rt.scene, rt.settings, "cpu")
    return rt, scene, settings


def _pixels(n=SIZE):
    return torch.arange(n).repeat(n), torch.arange(n).repeat_interleave(n)


def test_lt_film_matches_jax(lt_scene):
    """lt_trace_film against the JAX function on the same lanes: every
    pixel within rtol 1e-4 / atol 1e-6 (K3's scatter-add, here its plain
    index_add, sums a pixel's splats in another order than XLA's
    scatter), through one scatter-add a bounce."""
    from ignis_tpu.techniques import lighttracer as jlt
    rt, scene, settings = lt_scene
    x, y = _pixels()
    jx, jy = jnp.asarray(x.numpy(), jnp.int32), jnp.asarray(y.numpy(),
                                                            jnp.int32)
    ref = jax.jit(lambda sc: jlt.lt_trace_film(
        sc, rt.settings, jx, jy, jnp.uint32(0), jnp.uint32(0)))(rt.scene)
    gather.reset_counts()
    got = lighttracer.lt_trace_film(scene, settings, x, y, 0, 0)
    bounces = gather.scatter_counts["plain_calls"]
    assert 0 < bounces <= settings.spi * settings.max_depth
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-6)
    assert float(got.r.sum()) > 0


def test_photon_map_and_grid_match_jax(lt_scene):
    """trace_photons and build_photon_grid against the JAX functions on
    4,000 photons: the photon map within 1e-5 (valid and depth exact),
    the sorted photons in the same order (a stable sort of equal cell
    ids) and the cell offsets exact."""
    from ignis_tpu.models.texture import make_texture_evaluator
    from ignis_tpu.techniques import ppm as jppm
    rt, scene, settings = lt_scene
    js = rt.settings

    def run(sc):
        ev = make_texture_evaluator(js.texture_descs, sc.textures)
        pm = jppm.trace_photons(sc, js, jnp.uint32(0), jnp.uint32(0), ev)
        return pm, jppm.build_photon_grid(pm, sc, js)
    jpm, jgrid = jax.jit(run)(rt.scene)
    tabs = render_tables(scene, settings)
    pm = ppm.trace_photons(scene, settings, 0, 0, tabs)
    grid = ppm.build_photon_grid(pm, scene, settings)
    valid = np.asarray(jpm.valid)
    assert valid.sum() > 1000
    np.testing.assert_array_equal(pm.valid.numpy(), valid)
    np.testing.assert_array_equal(pm.depth.numpy(), np.asarray(jpm.depth))
    for name in ("pos", "in_dir", "radiance"):
        for a, b in zip(getattr(pm, name), getattr(jpm, name)):
            np.testing.assert_allclose(a.numpy()[valid], np.asarray(b)[valid],
                                       rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(grid.offsets.numpy(),
                                  np.asarray(jgrid.offsets))
    jp = jgrid.pmap
    jtab = np.stack([*[np.asarray(c) for c in (*jp.pos, *jp.in_dir,
                                              *jp.radiance)],
                     np.asarray(jp.depth), np.asarray(jp.valid)], 1)
    tab = grid.table[:, :ppm.PHOTON_COLS].numpy()
    np.testing.assert_allclose(tab, jtab, rtol=1e-5, atol=1e-5)


def test_ppm_radius_matches_jax():
    """compute_radius's lgamma closed form at iterations 0, 1, 7 and 100
    against the product r0 prod (k+1.8)/(k+2) in float64 and against the
    JAX function, within 5e-5 relative: both take three float32 lgammas
    of up to ~360 and subtract them, which loses ~1e-5 at iteration 100
    (the JAX value is 2.1e-5 off there, the port's 0.9e-5)."""
    from ignis_tpu.techniques import ppm as jppm
    rt = ignis_tpu.loadFromString(json.dumps(LT_SCENE))
    scene, settings = from_reference(rt.scene, rt.settings, "cpu")
    r0 = settings.merge_radius * 2.0 * float(scene.scene_radius)
    for it in (0, 1, 7, 100):
        exact = r0 * float(np.prod([(k + 1.8) / (k + 2.0)
                                    for k in range(it)]))
        ref = float(jppm.compute_radius(rt.settings, rt.scene,
                                        jnp.uint32(it)))
        got = float(ppm.compute_radius(settings, scene, it))
        assert got == pytest.approx(exact, rel=5e-5)
        assert got == pytest.approx(ref, rel=5e-5)


def test_ppm_render_matches_jax(lt_scene):
    """The PPM iteration (photon pass, grid, camera pass) at 32x32, spi 4,
    4,000 photons: 99% of pixels within rtol 1e-4 / atol 1e-5, means
    within 1e-4 relative (sums over photon slots reorder)."""
    rt, scene, settings = lt_scene
    js = dataclasses.replace(rt.settings, technique="ppm")
    ref = np.asarray(jax_iteration(rt.scene, js, jnp.uint32(0),
                                   jnp.uint32(0)))
    got = render_iteration(scene, dataclasses.replace(settings,
                                                      technique="ppm"),
                           0, 0).numpy()
    assert ref.mean() > 0.01
    close = np.isclose(got, ref, rtol=1e-4, atol=1e-5).all(-1).mean()
    assert close >= 0.99
    assert abs(got.mean() - ref.mean()) <= 1e-4 * ref.mean()


def _image_env(tmp_path, w=64, h=32):
    """An env image made with numpy: a dim sky and a bright 40x warm patch
    where tests/test_components.py:104's `expr` sky puts its sun
    (0.4 < u < 0.45, 0.6 < v < 0.65)."""
    from ignis_tpu_torch.utils.image import _write_exr_fallback
    u = (np.arange(w) + 0.5) / w
    v = (np.arange(h) + 0.5) / h
    img = np.tile(np.array([0.05, 0.05, 0.08], np.float32), (h, w, 1))
    sun = ((u[None, :] > 0.4) & (u[None, :] < 0.45)
           & (v[:, None] > 0.6) & (v[:, None] < 0.65))
    img[sun] += 40.0 * np.array([1.0, 0.9, 0.7], np.float32)
    path = tmp_path / "sky.exr"
    _write_exr_fallback(path, img[::-1].copy())
    return path


@pytest.fixture(scope="module")
def aept_scene(tmp_path_factory):
    """tests/test_components.py's plane under the numpy image env at
    32x32, spi 4, aept, bridged."""
    env = _image_env(tmp_path_factory.mktemp("env"))
    sc = json.loads(json.dumps(COMPONENTS_BASE))
    sc["textures"] = [{"type": "image", "name": "sky",
                       "filename": str(env)}]
    sc["lights"] = [{"type": "env", "name": "E", "radiance": "sky"}]
    sc["technique"]["type"] = "aept"
    rt = ignis_tpu.loadFromString(json.dumps(sc), spi=4)
    scene, settings = from_reference(rt.scene, rt.settings, "cpu")
    return rt, scene, settings


def test_aept_guiding_matches_jax(aept_scene):
    """learn_trace's histograms (counts exact, sums within rtol 1e-5)
    through one K3 scatter-add a bounce, and build_guiding's CDFs within
    1e-5, against the JAX functions; NEE off by default for aept."""
    from ignis_tpu.models.texture import make_texture_evaluator
    from ignis_tpu.techniques import aept as jaept
    rt, scene, settings = aept_scene
    assert not settings.enable_nee and not rt.settings.enable_nee
    js = rt.settings
    x, y = _pixels()
    jx, jy = jnp.asarray(x.numpy(), jnp.int32), jnp.asarray(y.numpy(),
                                                            jnp.int32)

    def run(sc):
        ev = make_texture_evaluator(js.texture_descs, sc.textures)
        hs, hc = jaept.learn_trace(sc, js, jx, jy, jnp.uint32(0),
                                   jnp.uint32(0), ev)
        return hs, hc, jaept.build_guiding(hs, hc)
    jhs, jhc, jg = jax.jit(run)(rt.scene)
    gather.reset_counts()
    hs, hc = aept.learn_trace(scene, settings, x, y, 0, 0)
    assert 0 < gather.scatter_counts["plain_calls"] \
        <= settings.spi * settings.max_depth
    assert float(hc.sum()) > 100
    np.testing.assert_array_equal(hc.numpy(), np.asarray(jhc))
    np.testing.assert_allclose(hs.numpy(), np.asarray(jhs), rtol=1e-5,
                               atol=1e-7)
    g = aept.build_guiding(hs, hc)
    for a, b in zip(g, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)


def test_aept_render_matches_jax(aept_scene):
    """The guided render (the learning iteration, then iteration 0 under
    its guiding) through Runtime.step() against the JAX Runtime's: 99% of
    pixels within rtol 1e-4 / atol 1e-5, means within 1e-4 relative."""
    rt, scene, settings = aept_scene
    rt.step()
    ref = np.asarray(rt.framebuffer(normalized=True))
    port = Runtime(scene, settings)
    got = port.step().framebuffer(normalized=True).numpy()
    assert port._aept_guiding is not None and ref.mean() > 0.01
    close = np.isclose(got, ref, rtol=1e-4, atol=1e-5).all(-1).mean()
    assert close >= 0.99
    assert abs(got.mean() - ref.mean()) <= 1e-4 * ref.mean()


def test_sample_emission_matches_jax():
    """sample_emission on 4,096 lanes spread over the six light kinds of
    one scene (point, spot, area, directional, sun, env) against the JAX
    function: position, direction, weight and cosine within 1e-5."""
    from ignis_tpu.core.vec import Vec3 as JVec3  # noqa: F401
    from ignis_tpu.models import light as jlight
    sc = json.loads(json.dumps(COMPONENTS_BASE))
    sc["bsdfs"].append({"type": "diffuse", "name": "black",
                        "reflectance": [0, 0, 0]})
    sc["shapes"].append({"type": "rectangle", "name": "L", "width": 0.4,
                         "height": 0.4})
    sc["entities"].append({"name": "L", "shape": "L", "bsdf": "black",
                           "transform": [{"translate": [1.2, 0.5, -1.0]}]})
    sc["lights"] = [
        {"type": "point", "name": "P", "position": [0, 1, -1.5],
         "intensity": [8, 8, 8]},
        {"type": "spot", "name": "S", "position": [0.5, -1.0, -1.2],
         "direction": [0, 0.5, 1], "intensity": [3, 3, 3], "cutoff": 40},
        {"type": "area", "name": "L", "entity": "L", "radiance": [6, 6, 6]},
        {"type": "directional", "name": "D", "direction": [0, -1, 0.3],
         "irradiance": [1, 1, 1]},
        {"type": "sun", "name": "U", "direction": [0.2, 1, 0.1],
         "irradiance": [2, 2, 2]},
        {"type": "env", "name": "E", "radiance": [0.1, 0.2, 0.3]},
    ]
    rt = ignis_tpu.loadFromString(json.dumps(sc))
    scene, settings = from_reference(rt.scene, rt.settings, "cpu")
    n = 4096
    rng = np.random.default_rng(9)
    us = rng.random((4, n), dtype=np.float32)
    rows = np.arange(n, dtype=np.int32) % settings.n_lights
    jlp = jlight.gather_light(rt.scene.lights, jnp.asarray(rows))
    ref = jax.jit(lambda sc_, lp, u: jlight.sample_emission(
        sc_, lp, *u))(rt.scene, jlp, jnp.asarray(us))
    lp = lightlib.gather_light(scene.lights, torch.from_numpy(rows))
    got = lightlib.sample_emission(scene, lp,
                                   *[torch.from_numpy(u) for u in us],
                                   kinds=settings.light_kinds)
    assert len(settings.light_kinds) == 6
    for a, b in zip(got, ref):
        for c, d in (zip(a, b) if isinstance(a, tuple) else ((a, b),)):
            np.testing.assert_allclose(c.numpy(), np.asarray(d), rtol=1e-5,
                                       atol=1e-5)


def test_sample_pixel_and_warps_match_jax():
    """camera.sample_pixel on points in front of, beside and behind the
    camera, and the new warps, against the JAX functions."""
    from ignis_tpu.core import warp as jwarp
    from ignis_tpu.models import camera as jcamera
    from ignis_tpu_torch.core import warp
    rt = ignis_tpu.loadFromString(json.dumps(LT_SCENE))
    scene, settings = from_reference(rt.scene, rt.settings, "cpu")
    rng = np.random.default_rng(4)
    p = rng.uniform(-3, 3, size=(3, 2048)).astype(np.float32)
    from ignis_tpu.core.vec import Vec3 as JVec3
    ref = jcamera.sample_pixel(rt.scene.camera, rt.settings,
                               JVec3(*[jnp.asarray(c) for c in p]))
    got = camera.sample_pixel(scene.camera, settings,
                              Vec3(*[torch.from_numpy(c) for c in p]))
    valid = np.asarray(ref[0])
    assert 100 < valid.sum() < 2048
    np.testing.assert_array_equal(got[0].numpy(), valid)
    np.testing.assert_array_equal(got[1].numpy()[valid],
                                  np.asarray(ref[1])[valid])
    for a, b in zip(got[2], ref[2]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    np.testing.assert_allclose(got[3].numpy()[valid],
                               np.asarray(ref[3])[valid], rtol=1e-5)
    u, v = rng.random((2, 512), dtype=np.float32)
    d, pdf = warp.sample_uniform_hemisphere(torch.from_numpy(u),
                                            torch.from_numpy(v))
    jd, jpdf = jwarp.sample_uniform_hemisphere(jnp.asarray(u),
                                               jnp.asarray(v))
    for a, b in zip(d, jd):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
    np.testing.assert_allclose(pdf.numpy(), np.asarray(jpdf))
    assert warp.uniform_sphere_pdf() == pytest.approx(
        float(jwarp.uniform_sphere_pdf()))
    assert warp.uniform_disk_pdf(0.7) == pytest.approx(
        float(jwarp.uniform_disk_pdf(0.7)))


@pytest.mark.parametrize("name", sorted(ALIASES))
def test_every_technique_runs_through_the_runtime(name):
    """Every technique name and alias of ignis_tpu/techniques/__init__.py
    loads through `technique=` and renders a finite, non-black 16x16
    image (a small lit plane before a constant env) through
    Runtime.step() (no NotImplementedError)."""
    sc = json.loads(json.dumps(COMPONENTS_BASE))
    sc["film"] = {"size": [16, 16]}
    sc["shapes"][0]["width"] = sc["shapes"][0]["height"] = 1.5
    sc["lights"].append({"type": "env", "name": "E",
                         "radiance": [0.1, 0.1, 0.1]})
    rt = ignis_tpu_torch.loadFromString(json.dumps(sc), device="cpu",
                                        technique=name, spi=2, photons=500)
    img = rt.step().framebuffer(normalized=True)
    assert rt.settings.technique == name
    assert bool(torch.isfinite(img).all()) and float(img.max()) > 0


def test_unknown_technique_raises():
    with pytest.raises(ValueError, match="Unknown technique"):
        ignis_tpu_torch.loadFromString(json.dumps(LT_SCENE), device="cpu",
                                       technique="bidir")


def test_render_aovs_match_jax():
    """Runtime.render_aovs() against the JAX Runtime's: Normals, Albedo
    (textured) and Depth per pixel within 1e-5."""
    doc = json.dumps(_checker_floor(COMPACTION_SCENE))
    ref = ignis_tpu.loadFromString(doc).render_aovs()
    got = ignis_tpu_torch.loadFromString(doc, device="cpu").render_aovs()
    assert got["Depth"].shape == (SIZE, SIZE)
    for k in ("Normals", "Albedo", "Depth"):
        np.testing.assert_allclose(got[k].numpy(), ref[k], rtol=1e-5,
                                   atol=1e-5)


def _render(scene, technique, spi, steps=1, **kw):
    sc = json.loads(json.dumps(scene))
    sc["technique"]["type"] = technique
    rt = ignis_tpu_torch.loadFromString(json.dumps(sc), device="cpu",
                                        spi=spi, **kw)
    for _ in range(steps):
        rt.step()
    return rt.framebuffer(normalized=True).numpy()


def test_lt_matches_pt():
    """tests/test_lighttracer.py:38 on the port: the light tracer and the
    path tracer agree on the global mean within 5% and on two blocks
    within 20%."""
    pt = _render(LT_SCENE, "path", spi=128)
    lt = _render(LT_SCENE, "lt", spi=128, steps=4)
    assert pt.mean() > 0.01
    assert abs(lt.mean() - pt.mean()) / pt.mean() < 0.05
    for sl in (np.s_[20:28, 20:28], np.s_[8:16, 32:40]):
        p, m = pt[sl].mean(), lt[sl].mean()
        assert abs(m - p) / max(p, 1e-6) < 0.2, (sl, p, m)


def test_ppm_matches_pt():
    """tests/test_ppm.py:26 on the port: PPM (20,000 photons, 2 steps of
    spi 16) against the path tracer: means within 8%, blocks within 25%."""
    sc = json.loads(json.dumps(LT_SCENE))
    sc["technique"] = {"type": "path", "max_depth": 4}
    pt = _render(sc, "path", spi=128)
    pm = _render(sc, "ppm", spi=16, steps=2, photons=20000)
    assert pt.mean() > 0.01
    assert abs(pm.mean() - pt.mean()) / pt.mean() < 0.08
    for sl in (np.s_[20:28, 20:28], np.s_[8:16, 32:40]):
        p, m = pt[sl].mean(), pm[sl].mean()
        assert abs(m - p) / max(p, 1e-6) < 0.25, (sl, p, m)


def test_aept_matches_pt(tmp_path):
    """tests/test_components.py:103 on the port, its PExpr `expr` sky
    swapped for the same sky as an image made with numpy (the port has no
    PExpr yet): aept and the path tracer agree within 10% at 48x48,
    spi 64."""
    sc = json.loads(json.dumps(COMPONENTS_BASE))
    sc["film"]["size"] = [48, 48]
    sc["textures"] = [{"type": "image", "name": "sky",
                       "filename": str(_image_env(tmp_path))}]
    sc["lights"] = [{"type": "env", "name": "E", "radiance": "sky"}]
    pt = _render(sc, "path", spi=64)
    ae = _render(sc, "aept", spi=64)
    assert pt.mean() > 0.01
    assert abs(ae.mean() - pt.mean()) / pt.mean() < 0.1


def test_check_techniques():
    """tests/test_components.py:116 on the port, the env_check half's
    `expr` sky swapped for a constant env of the same colour: camera_check
    is green where the plane is hit, env_check shows the env around a
    small plane."""
    sc = json.loads(json.dumps(COMPONENTS_BASE))
    img = _render(sc, "camera_check", spi=4)
    assert img[..., 1].mean() > 0.9 and img[..., 0].mean() < 0.1
    sc = json.loads(json.dumps(COMPONENTS_BASE))
    sc["shapes"][0]["width"] = 0.5
    sc["shapes"][0]["height"] = 0.5
    sc["lights"] = [{"type": "env", "name": "E",
                     "radiance": [0.2, 0.4, 0.8]}]
    img = _render(sc, "env_check", spi=4)
    assert img.max() > 0.1
