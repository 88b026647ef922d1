"""The slice end to end: ignis_tpu_torch renders against
ignis_tpu.render.session.render_iteration on bridged scenes (S1's, S2's
and S4's scenes, a small S5, the brick/bump and light-selector scenes of
tests/test_components.py and a textured blend), the cascade against the
one-stage render, the analytic oracles of tests/test_analytic.py and
tests/test_blend.py, the env-CDF method consistency of
tests/test_components.py, reproducibility and the Runtime counters."""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ignis_tpu
import ignis_tpu_torch
from ignis_tpu.render.session import render_iteration as jax_iteration
from ignis_tpu_torch.bridge import from_reference
from ignis_tpu_torch.render.session import render_iteration
from ignis_tpu_torch.techniques import path
from ignis_tpu_torch.techniques.path import render_lanes

from __graft_entry__ import _SCENE
from test_analytic import flat_scene
from test_blend import flat_env_scene
from test_compaction import SCENE as COMPACTION_SCENE
from test_components import BASE as COMPONENTS_BASE

# The tensors here are small; one intra-op thread per test process keeps
# parallel test workers from oversubscribing the cores.
torch.set_num_threads(1)


def _at(scene, size):
    s = json.loads(json.dumps(scene))
    s["film"] = {"size": [size, size]}
    return s


# S4 of chip_smoke.py: the compaction scene with the icosphere at
# subdivisions 2 (322 triangles), which both packages intersect densely
S4_SCENE = json.loads(json.dumps(COMPACTION_SCENE))
S4_SCENE["shapes"][1]["subdivisions"] = 2


def s5_small(env_dir, blend=False):
    """chip_smoke's S5 at 64x64: icospheres at subdivisions 1 (724
    triangles, a BVH), a 128x64 substitute env. Without `blend` the
    textured-blend ball is a plain diffuse: the JAX package resolves
    blends BLEND_MAX_DEPTH = 2 levels deep over all nine kinds present,
    and XLA takes about 7 minutes to compile that on the CPU; the
    textured blend has its own case (TEXTURED_BLEND)."""
    import chip_smoke
    from ignis_tpu_torch.utils.envgen import ensure_substitute_env
    sc = chip_smoke.s5_scene(ensure_substitute_env(env_dir, 128, 64),
                             subdivisions=1, size=64)
    if not blend:
        sc["bsdfs"][-1] = {"type": "diffuse", "name": "m8",
                           "reflectance": [0.7, 0.7, 0.2]}
    return sc


def brick_bump_scene():
    """tests/test_components.py:62: a brick texture behind a transform, a
    noise bump map of strength 0.5."""
    sc = json.loads(json.dumps(COMPONENTS_BASE))
    sc["textures"] = [
        {"type": "brick", "name": "bricks", "color0": [0.2, 0.1, 0.1],
         "color1": [0.7, 0.3, 0.2]},
        {"type": "noise", "name": "bump_src", "scale": 8},
        {"type": "transform", "name": "bricks_t", "texture": "bricks",
         "transform": [{"scale": [2, 2, 1]}]},
    ]
    sc["bsdfs"] = [
        {"type": "diffuse", "name": "inner", "reflectance": "bricks_t"},
        {"type": "bumpmap", "name": "g", "bsdf": "inner", "map": "bump_src",
         "strength": 0.5},
    ]
    return sc


def light_selector_scene(selector="hierarchy"):
    """tests/test_components.py:464: an area light, two points, a spot and
    a constant env over the components floor."""
    sc = json.loads(json.dumps(COMPONENTS_BASE))
    sc["technique"]["max_depth"] = 4
    sc["technique"]["light_selector"] = selector
    sc["bsdfs"].append({"type": "diffuse", "name": "black",
                        "reflectance": [0, 0, 0]})
    sc["shapes"].append({"type": "rectangle", "name": "L", "width": 0.4,
                         "height": 0.4})
    sc["entities"].append({"name": "L", "shape": "L", "bsdf": "black",
                           "transform": [{"translate": [1.2, 0.5, -1.0]}]})
    sc["lights"] = [
        {"type": "area", "name": "L", "entity": "L", "radiance": [6, 6, 6]},
        {"type": "point", "name": "P1", "position": [-1.2, 0.8, -1.2],
         "intensity": [2, 2, 2]},
        {"type": "point", "name": "P2", "position": [0, 1.4, -0.8],
         "intensity": [1, 1, 1]},
        {"type": "spot", "name": "S", "position": [0.5, -1.0, -1.2],
         "direction": [0, 0.5, 1], "intensity": [3, 3, 3], "cutoff": 40},
        {"type": "env", "name": "E", "radiance": [0.05, 0.05, 0.08]},
    ]
    return sc


# A blend of a diffuse and a rough conductor whose weight is a checkerboard
# texture (S5's ninth ball) on the blend tests' flat plane, under an env
# and a point light.
TEXTURED_BLEND = flat_env_scene([
    {"type": "diffuse", "name": "d", "reflectance": [0.7, 0.7, 0.2]},
    {"type": "roughconductor", "name": "c", "material": "aluminum",
     "roughness": 0.25},
    {"type": "blend", "name": "m", "first": "d", "second": "c",
     "weight": "chk"},
], "m")
TEXTURED_BLEND["textures"] = [{"type": "checkerboard", "name": "chk",
                               "scale_x": 8, "scale_y": 8}]
TEXTURED_BLEND["lights"].append({"type": "point", "name": "p",
                                 "position": [0, 0.5, -1],
                                 "intensity": [1, 1, 1]})


@pytest.fixture(scope="module", params=["compaction", "graft_entry", "s4",
                                        "s5", "brick_bump",
                                        "light_selectors", "textured_blend"])
def bridged(request, tmp_path_factory):
    scene = {"compaction": lambda: COMPACTION_SCENE,
             "graft_entry": lambda: _SCENE, "s4": lambda: S4_SCENE,
             "s5": lambda: s5_small(tmp_path_factory.mktemp("env")),
             "brick_bump": brick_bump_scene,
             "light_selectors": light_selector_scene,
             "textured_blend": lambda: TEXTURED_BLEND}[request.param]()
    rt = ignis_tpu.loadFromString(json.dumps(_at(scene, 64)), spi=4)
    ref = np.asarray(jax_iteration(rt.scene, rt.settings, jnp.uint32(0),
                                   jnp.uint32(0)))
    scene, settings = from_reference(rt.scene, rt.settings, "cpu")
    # where test_surface_and_frame_match_jax aims its rays: the origin,
    # or S5's balls (its floor lies below them, out of the origin's way)
    aim = np.array([0.0, -0.65, 0.0] if request.param == "s5" else
                   [0.0, 0.0, 0.0], np.float32)
    return scene, settings, ref, rt, aim


def test_slice_matches_jax(bridged):
    """Same arrays, same (pixel, sample) random streams: >= 99% of pixels
    within rtol 1e-3 / atol 1e-4 and image means within 0.5%; torch and
    XLA round transcendentals apart, so a few Russian-roulette and Fresnel
    decisions may flip."""
    scene, settings, ref, _, _ = bridged
    got = render_iteration(scene, settings, 0, 0).numpy()
    assert got.shape == ref.shape and np.isfinite(got).all()
    close = np.isclose(got, ref, rtol=1e-3, atol=1e-4).all(-1).mean()
    assert close >= 0.99
    assert abs(got.mean() - ref.mean()) <= 0.005 * ref.mean()


def test_cascade_matches_progressive(bridged, monkeypatch):
    """With MIN_BUCKET forced to 256 the 4096-lane film runs three
    compacting stages; the sample set is the same, only the fold order
    differs (tests/test_compaction.py:63 bar)."""
    scene, settings, _, _, _ = bridged
    w, h = settings.width, settings.height
    x = torch.arange(w).repeat(h)
    y = torch.arange(h).repeat_interleave(w)
    monkeypatch.setattr(path, "MIN_BUCKET", 256)
    assert path.bucket_chain(w * h, path.MIN_BUCKET) == [4096, 1024, 256]
    one = render_lanes(scene, settings, x, y, 0, 0, compact=False)
    casc = render_lanes(scene, settings, x, y, 0, 0, compact=True)
    for a, b in zip(casc, one):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-4,
                                   atol=2e-5)


def test_surface_and_frame_match_jax(bridged):
    """compute_surface and shading_frame on the same rays and hits (the
    JAX trace's): same float32 formulae, so within rtol 1e-5 / atol 1e-5
    (XLA may contract products into FMAs); entities and sides equal."""
    from ignis_tpu.core.vec import Vec3 as JVec3
    from ignis_tpu.ops.intersect import Rays as JRays
    from ignis_tpu.techniques import path as jpath
    from ignis_tpu_torch.core.vec import Vec3
    from ignis_tpu_torch.ops.intersect import Hit, Rays
    scene, _, _, rt, aim = bridged
    rng = np.random.default_rng(21)
    n = 4096
    eye = np.array([float(rt.scene.camera.eye.x), float(rt.scene.camera.eye.y),
                    float(rt.scene.camera.eye.z)], np.float32)
    o = np.tile(eye, (n, 1)) + rng.normal(scale=0.1, size=(n, 3)).astype(
        np.float32)
    d = (rng.normal(size=(n, 3)) * 0.3 + aim - eye).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    jrays = JRays(JVec3(*[jnp.asarray(o[:, i]) for i in range(3)]),
                  JVec3(*[jnp.asarray(d[:, i]) for i in range(3)]),
                  jnp.zeros(n), jnp.full(n, 3e38))
    jhit = jpath.trace_scene(rt.scene, jrays)
    assert (np.asarray(jhit.prim) >= 0).mean() > 0.3
    trays = Rays(Vec3(*[torch.from_numpy(o[:, i].copy()) for i in range(3)]),
                 Vec3(*[torch.from_numpy(d[:, i].copy()) for i in range(3)]),
                 torch.zeros(n), torch.full((n,), 3e38))
    thit = Hit(*[torch.from_numpy(np.array(a)) for a in jhit])
    js = jpath.compute_surface(rt.scene, jrays, jhit)
    ts = path.compute_surface(scene, trays, thit)
    np.testing.assert_array_equal(ts.ent.numpy(), np.asarray(js.ent))
    np.testing.assert_array_equal(ts.is_entering.numpy(),
                                  np.asarray(js.is_entering))
    for f in ("point", "face_n", "ns", "uv", "tu", "tv"):
        for a, b in zip(getattr(ts, f), getattr(js, f)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=1e-5, err_msg=f)
    jf, tf = jpath.shading_frame(js), path.shading_frame(ts)
    for a, b in zip(tf, jf):
        for x, y in zip(a, b):
            np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-4,
                                       atol=1e-4)


def _average(scene, spp, **kw):
    rt = ignis_tpu_torch.loadFromString(json.dumps(scene), device="cpu",
                                        **kw)
    for _ in range(spp):
        rt.step()
    return float(rt.framebuffer(normalized=True).mean())


def test_no_light():
    assert _average(flat_scene(), 8) == pytest.approx(0, abs=1e-8)


def test_point_light():
    """tests/test_analytic.py:45-50: average 0.005100456."""
    scene = flat_scene()
    scene["lights"].append({"type": "point", "name": "_l",
                            "position": [0, 0, -2], "power": 1})
    assert _average(scene, 8) == pytest.approx(0.005100456, abs=1e-4)


def test_env_light():
    scene = flat_scene()
    scene["lights"].append({"type": "env", "name": "_l",
                            "radiance": [1, 1, 1]})
    assert _average(scene, 16) == pytest.approx(1, rel=2e-3)


def test_spot_light():
    """tests/test_analytic.py:53: average 0.0348280902 (abs 2.5e-3)."""
    scene = flat_scene()
    scene["lights"].append({"type": "spot", "name": "_l", "cutoff": 45,
                            "falloff": 45, "position": [0, 0, -2],
                            "direction": [0, 0, 1], "power": 1})
    assert _average(scene, 8) == pytest.approx(0.0348280902, abs=2.5e-3)


def _center(scene, spp):
    rt = ignis_tpu_torch.loadFromString(json.dumps(scene), device="cpu")
    for _ in range(spp):
        rt.step()
    return rt.framebuffer(normalized=True)[24:40, 24:40].mean((0, 1)).numpy()


@pytest.mark.parametrize("bsdfs, mat, want, spp", [
    ([{"type": "diffuse", "name": "red", "reflectance": [1, 0, 0]},
      {"type": "diffuse", "name": "blue", "reflectance": [0, 0, 1]},
      {"type": "blend", "name": "m", "first": "red", "second": "blue",
       "weight": 0.25}], "m", [0.75, 0.0, 0.25], 16),
    ([{"type": "diffuse", "name": "g", "reflectance": [0.2, 0.8, 0.2]},
      {"type": "twosided", "name": "m", "bsdf": "g"}], "m",
     [0.2, 0.8, 0.2], 16),
    ([{"type": "diffuse", "name": "r", "reflectance": [0.8, 0.0, 0.0]},
      {"type": "diffuse", "name": "g", "reflectance": [0.0, 0.8, 0.0]},
      {"type": "blend", "name": "inner", "first": "r", "second": "g",
       "weight": 0.5},
      {"type": "diffuse", "name": "b", "reflectance": [0.0, 0.0, 0.8]},
      {"type": "blend", "name": "outer", "first": "inner", "second": "b",
       "weight": 0.5}], "outer", [0.2, 0.2, 0.4], 32),
], ids=["blend_weight", "twosided", "nested_blend"])
def test_blend_oracles(bsdfs, mat, want, spp):
    """tests/test_blend.py:33-78 on the port: under a uniform env at
    max_depth 2 the plane converges to its (lerped) reflectance, within
    0.03. (The mask case needs passthrough, and so transparent shadows:
    ROADMAP queue 1, item 12.)"""
    np.testing.assert_allclose(_center(flat_env_scene(bsdfs, mat), spp),
                               want, atol=0.03)


def test_dielectric_mix_matches_flattened_oracle():
    """tests/test_blend.py:81: a one-sample mix of two smooth dielectrics
    of one ior is the dielectric with lerped tints, within 0.04."""
    def glass(bsdfs, mat):
        s = flat_env_scene(bsdfs, mat)
        s["technique"]["max_depth"] = 6
        return s
    mixed = glass([
        {"type": "dielectric", "name": "ga", "int_ior": 1.5,
         "specular_transmittance": [1.0, 0.2, 0.2]},
        {"type": "dielectric", "name": "gb", "int_ior": 1.5,
         "specular_transmittance": [0.2, 0.2, 1.0]},
        {"type": "blend", "name": "m", "first": "ga", "second": "gb",
         "weight": 0.5}], "m")
    flat = glass([{"type": "dielectric", "name": "m", "int_ior": 1.5,
                   "specular_transmittance": [0.6, 0.2, 0.6]}], "m")
    np.testing.assert_allclose(_center(mixed, 48), _center(flat, 48),
                               atol=0.04)


def test_env_cdf_methods_render_consistency(tmp_path):
    """tests/test_components.py:685 on the port: a scene lit by an
    HDR-like PNG env (decoded by the port's own PNG reader) has the same
    image mean within 5% under the conditional, SAT and hierarchical
    methods."""
    from test_torch_texture import _png
    rs = np.random.RandomState(11)
    img = (rs.rand(32, 64, 3) ** 2 * 200).astype(np.uint8)
    _png(tmp_path / "env.png", img, 2)
    means = {}
    for method in ("conditional", "sat", "hierachical"):
        scene = json.loads(json.dumps(COMPONENTS_BASE))
        scene["textures"] = [{"type": "image", "name": "E",
                              "filename": str(tmp_path / "env.png")}]
        scene["lights"] = [{"type": "env", "name": "env", "radiance": "E",
                            "cdf": method}]
        rt = ignis_tpu_torch.loadFromString(json.dumps(scene), device="cpu",
                                            spi=32)
        assert rt.settings.env_cdf_method == method
        means[method] = float(rt.step().framebuffer(normalized=True).mean())
    ref = means["conditional"]
    for m, v in means.items():
        assert abs(v - ref) / max(ref, 1e-9) < 0.05, means


def test_light_selectors_agree():
    """tests/test_components.py:464 on the port: the uniform, cdf and
    hierarchy selectors estimate the same image mean within 2%."""
    means = {}
    for sel in ("uniform", "cdf", "hierarchy"):
        s = _at(light_selector_scene(sel), 48)
        rt = ignis_tpu_torch.loadFromString(json.dumps(s), device="cpu",
                                            spi=128)
        means[sel] = float(rt.step().framebuffer(normalized=True).mean())
    for sel in ("cdf", "hierarchy"):
        assert abs(means[sel] - means["uniform"]) / means["uniform"] < 0.02


def test_textures_survive_a_blend_in_the_scene():
    """A scene that holds a blend resolves every lane's material through
    the blend LaneShader. The port textures the rows it gathers there as
    it textures a lane's own row, so the brick/bump plane renders the
    same (>= 99% of pixels within rtol 1e-3 / atol 1e-4, mean within
    0.5%) whether or not an unused blend sits in the material table. The
    JAX package gathers those rows untextured (ignis_tpu/models/bsdf.py
    :978, ROADMAP queue 3): its plane loses the bricks, and its mean moves
    by more than 10%."""
    plain = _at(brick_bump_scene(), 64)
    with_blend = json.loads(json.dumps(plain))
    with_blend["bsdfs"] += [
        {"type": "diffuse", "name": "a", "reflectance": [1, 0, 0]},
        {"type": "blend", "name": "unused", "first": "a", "second": "g",
         "weight": 0.5}]
    imgs = []
    for sc in (plain, with_blend):
        rt = ignis_tpu_torch.loadFromString(json.dumps(sc), device="cpu",
                                            spi=4)
        imgs.append(rt.step().framebuffer(normalized=True).numpy())
        assert rt.settings.has_blend == (sc is with_blend)
    a, b = imgs
    assert np.isclose(b, a, rtol=1e-3, atol=1e-4).all(-1).mean() >= 0.99
    assert abs(b.mean() - a.mean()) <= 0.005 * a.mean()
    rt = ignis_tpu.loadFromString(json.dumps(with_blend), spi=4)
    ref = np.asarray(jax_iteration(rt.scene, rt.settings, jnp.uint32(0),
                                   jnp.uint32(0)))
    assert abs(ref.mean() - a.mean()) > 0.1 * a.mean()


def test_s5_with_textured_blend_renders(tmp_path):
    """The whole small S5, its textured blend included (which the JAX
    package would take minutes to compile; its parts are held against
    JAX by the bridged cases): finite, not black, and the cascade equal
    to the one-stage render."""
    rt = ignis_tpu_torch.loadFromString(
        json.dumps(s5_small(tmp_path, blend=True)), device="cpu", spi=2)
    assert rt.settings.has_blend
    img = rt.step().framebuffer(normalized=True)
    assert bool(torch.isfinite(img).all()) and float(img.mean()) > 0.01


def test_reproducibility_and_counters():
    scene = flat_scene(size=128)
    scene["lights"].append({"type": "point", "name": "_l",
                            "position": [0, 0, -2], "intensity": [1, 1, 1]})
    text = json.dumps(scene)

    def run(seed):
        rt = ignis_tpu_torch.loadFromString(text, device="cpu", seed=seed,
                                            spi=2)
        return rt, rt.step().framebuffer(normalized=True)

    rt, a = run(42)
    _, b = run(42)
    assert torch.equal(a, b)
    _, c = run(7)
    assert not torch.allclose(a, c)
    assert rt.iteration_count == 1 and rt.sample_count == 2
    rt.step()
    assert rt.iteration_count == 2 and rt.sample_count == 4
    raw = rt.framebuffer()
    assert torch.allclose(rt.framebuffer(normalized=True), raw / 2)
    rt.reset()
    assert rt.iteration_count == 0 and rt.sample_count == 0
    assert float(rt.framebuffer().abs().sum()) == 0.0


def test_k2_soup_packed_once_per_render(monkeypatch):
    """A step of S4 (no BVH) packs K2's soup once, in render_lanes, and
    every closest-hit and shadow query of every bounce gets that pack, so
    the pack adds no work per bounce."""
    from ignis_tpu_torch.ops import isect_cuda
    made, seen = [], []
    pack_soup, intersect_tris = isect_cuda.pack_soup, isect_cuda.intersect_tris

    def counting_pack(soup):
        made.append(pack_soup(soup))
        return made[-1]

    def recording(*args, packed=None, **kw):
        seen.append(packed)
        return intersect_tris(*args, packed=packed, **kw)
    monkeypatch.setattr(isect_cuda, "pack_soup", counting_pack)
    monkeypatch.setattr(isect_cuda, "intersect_tris", recording)
    rt = ignis_tpu_torch.loadFromString(json.dumps(_at(S4_SCENE, 32)),
                                        device="cpu", spi=2)
    rt.step()
    assert len(made) == 1 and len(seen) >= 4
    assert all(p is made[0] for p in seen)


@pytest.mark.parametrize("intervals, busy", [
    ([], 0.0),
    ([(0, 2), (1, 3)], 3.0),             # overlapping
    ([(5, 6), (0, 1), (5.5, 5.7)], 2.0),  # unsorted, nested
    ([(0, 1), (1, 2)], 2.0),             # touching
])
def test_busy_union(intervals, busy):
    """The device busy time of a profiled step counts overlapping device
    intervals once (render/profile.py)."""
    from ignis_tpu_torch.render.profile import busy_union
    assert busy_union(intervals) == busy
