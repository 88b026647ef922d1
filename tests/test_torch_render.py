"""The slice end to end: ignis_tpu_torch renders against
ignis_tpu.render.session.render_iteration on bridged scenes, the cascade
against the one-stage render, the analytic oracles of
tests/test_analytic.py, reproducibility and the Runtime counters."""
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
from test_compaction import SCENE as COMPACTION_SCENE

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


@pytest.fixture(scope="module", params=["compaction", "graft_entry", "s4"])
def bridged(request):
    scene = {"compaction": COMPACTION_SCENE, "graft_entry": _SCENE,
             "s4": S4_SCENE}[request.param]
    rt = ignis_tpu.loadFromString(json.dumps(_at(scene, 64)), spi=4)
    ref = np.asarray(jax_iteration(rt.scene, rt.settings, jnp.uint32(0),
                                   jnp.uint32(0)))
    scene, settings = from_reference(rt.scene, rt.settings, "cpu")
    return scene, settings, ref, rt


def test_slice_matches_jax(bridged):
    """Same arrays, same (pixel, sample) random streams: >= 99% of pixels
    within rtol 1e-3 / atol 1e-4 and image means within 0.5%; torch and
    XLA round transcendentals apart, so a few Russian-roulette and Fresnel
    decisions may flip."""
    scene, settings, ref, _ = bridged
    got = render_iteration(scene, settings, 0, 0).numpy()
    assert got.shape == ref.shape and np.isfinite(got).all()
    close = np.isclose(got, ref, rtol=1e-3, atol=1e-4).all(-1).mean()
    assert close >= 0.99
    assert abs(got.mean() - ref.mean()) <= 0.005 * ref.mean()


def test_cascade_matches_progressive(bridged, monkeypatch):
    """With MIN_BUCKET forced to 256 the 4096-lane film runs three
    compacting stages; the sample set is the same, only the fold order
    differs (tests/test_compaction.py:63 bar)."""
    scene, settings, _, _ = bridged
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
    scene, _, _, rt = bridged
    rng = np.random.default_rng(21)
    n = 4096
    eye = np.array([float(rt.scene.camera.eye.x), float(rt.scene.camera.eye.y),
                    float(rt.scene.camera.eye.z)], np.float32)
    o = np.tile(eye, (n, 1)) + rng.normal(scale=0.1, size=(n, 3)).astype(
        np.float32)
    d = (rng.normal(size=(n, 3)) * 0.3 - eye).astype(np.float32)
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
