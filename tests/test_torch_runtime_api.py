"""The rest of the Runtime API, the logger, the mesh cache, the Mitsuba
converter and the viewer in ignis_tpu_torch, on the CPU: the port's
versions of tests/test_runtime_api.py, tests/test_aux.py,
tests/test_cache.py and tests/test_viewer.py (every runtime with
device="cpu"), and against ignis_tpu on the same scenes and seeds:
trace() ray by ray, the acquireStats quantities, and checkpoints resumed
across the packages."""
import json
import threading
import time

import numpy as np
import pytest
import torch

import ignis_tpu
import ignis_tpu_torch
from ignis_tpu.scene.mitsuba import convert_mitsuba as jax_convert_mitsuba
from ignis_tpu.utils.exr import read_exr as jax_read_exr
from ignis_tpu_torch import view as V
from ignis_tpu_torch.scene import mesh as meshlib
from ignis_tpu_torch.scene.mitsuba import convert_mitsuba
from ignis_tpu_torch.utils import cache
from ignis_tpu_torch.utils.exr import read_exr
from ignis_tpu_torch.utils.logger import (FileLogListener, Logger,
                                          LogLevel)

from test_aux import SCENE as AUX_SCENE
from test_runtime_api import SCENE
from test_viewer import SCENE as VIEW_SCENE

torch.set_num_threads(1)


def load(scene, **kw):
    return ignis_tpu_torch.loadFromString(json.dumps(scene), device="cpu",
                                          **kw)


# -- tests/test_runtime_api.py ---------------------------------------------

def test_set_parameter_rebuild_and_camera():
    rt = load(SCENE, spi=8)
    rt.step()
    a = float(rt.framebuffer(normalized=True).mean())
    rt.setParameter("tint", 0.8)
    rt.reset()
    rt.step()
    b = float(rt.framebuffer(normalized=True).mean())
    assert abs(b / a - 4.0) < 0.01
    assert rt.getParameter("tint") == 0.8
    rt.setParameter("__camera_eye", [0, 0, -4])
    rt.reset()
    rt.step()
    c = float(rt.framebuffer(normalized=True).mean())
    assert abs(c - b) > 1e-4


def test_save_framebuffer_multilayer(tmp_path):
    """Read back by the port's reader and by the JAX package's: the layers,
    the film bit for bit and the ig* attributes, igTarget the device."""
    rt = load(SCENE, spi=8)
    rt.step()
    out = tmp_path / "multi.exr"
    rt.saveFramebuffer(str(out))
    fb = rt.framebuffer(normalized=True).numpy()
    for reader in (read_exr, jax_read_exr):
        chans, (w, h) = reader(str(out))
        assert (w, h) == (16, 16)
        assert {"R", "G", "B"} <= set(chans)
        assert "Normals.R" in chans and "Albedo.R" in chans
        np.testing.assert_array_equal(chans["R"], fb[..., 0])
    raw = out.read_bytes()
    for key in (b"igCameraEye", b"igTechniqueType", b"igSPP"):
        assert key in raw
    assert b"igTarget\0string\0\x03\0\0\0cpu" in raw


def test_mesh_writers_roundtrip(tmp_path):
    m = meshlib.make_ico_sphere((0, 0, 0), 1.0, 2)
    m.ensure_attributes()
    obj_p, ply_p = tmp_path / "s.obj", tmp_path / "s.ply"
    meshlib.save_obj(obj_p, m)
    meshlib.save_ply(ply_p, m)
    m2 = meshlib.load_obj(obj_p)
    m3 = meshlib.load_ply(ply_p)

    def canon(v):
        return v[np.lexsort(v.T)]
    assert np.allclose(canon(m.vertices), canon(m2.vertices), atol=1e-5)
    assert m2.indices.shape == m.indices.shape
    assert np.allclose(m.vertices, m3.vertices, atol=1e-5)
    assert np.allclose(m.normals, m3.normals, atol=1e-5)


def test_util_cli_convert(tmp_path):
    from ignis_tpu_torch.util_cli import main
    m = meshlib.make_box((0, 0, 0), np.array([1, 0, 0]),
                         np.array([0, 1, 0]), np.array([0, 0, 1]))
    m.ensure_attributes()
    src = tmp_path / "b.ply"
    dst = tmp_path / "b.obj"
    meshlib.save_ply(src, m)
    assert main(["convert", str(src), str(dst)]) == 0
    m2 = meshlib.load_obj(dst)
    assert len(m2.vertices) == len(m.vertices)


def test_denoiser_reduces_mse():
    scene = json.loads(json.dumps(SCENE))
    scene["film"]["size"] = [48, 48]
    scene["bsdfs"].append({"type": "diffuse", "name": "black",
                           "reflectance": [0, 0, 0]})
    scene["shapes"].append({"type": "rectangle", "name": "L",
                            "width": 0.5, "height": 0.5})
    scene["entities"].append({"name": "L", "shape": "L", "bsdf": "black",
                              "transform": [{"translate": [1.5, 0, -1.0]}]})
    scene["lights"] = [{"type": "area", "name": "L", "entity": "L",
                        "radiance": [10, 10, 10]}]
    rt = load(scene, spi=1)
    rt.step()
    noisy = rt.framebuffer(normalized=True).numpy()
    den = rt.denoised_framebuffer()
    ref_rt = load(scene, spi=256)
    ref_rt.step()
    ref = ref_rt.framebuffer(normalized=True).numpy()
    mse_noisy = ((noisy - ref) ** 2).mean()
    mse_den = ((den - ref) ** 2).mean()
    assert isinstance(den, np.ndarray) and np.isfinite(den).all()
    assert mse_den < mse_noisy
    den_at = rt.denoised_framebuffer(method="atrous")
    mse_at = ((den_at - ref) ** 2).mean()
    assert mse_den < 0.75 * mse_at, (mse_den, mse_at)


MITSUBA_XML = """<?xml version="1.0"?>
<scene version="3.0.0">
  <default name="spp" value="16"/>
  <default name="res" value="24"/>
  <integrator type="path"><integer name="max_depth" value="5"/></integrator>
  <sensor type="perspective">
    <float name="fov" value="45"/>
    <transform name="to_world">
      <lookat origin="0, 1, -4" target="0, 0, 0" up="0, 1, 0"/>
    </transform>
    <film type="hdrfilm">
      <integer name="width" value="$res"/>
      <integer name="height" value="$res"/>
    </film>
  </sensor>
  <bsdf type="diffuse" id="white">
    <rgb name="reflectance" value="0.7, 0.6, 0.5"/>
  </bsdf>
  <bsdf type="twosided" id="two">
    <bsdf type="roughplastic">
      <float name="alpha" value="0.2"/>
      <rgb name="diffuse_reflectance" value="0.2 0.3 0.8"/>
    </bsdf>
  </bsdf>
  <bsdf type="dielectric" id="glass">
    <float name="int_ior" value="1.5"/>
  </bsdf>
  <shape type="rectangle" id="floor">
    <transform name="to_world">
      <rotate x="1" angle="-90"/>
      <scale value="3"/>
      <translate x="0" y="-1" z="0"/>
    </transform>
    <ref id="white"/>
  </shape>
  <shape type="sphere" id="ball">
    <float name="radius" value="0.6"/>
    <point name="center" x="0" y="0" z="0"/>
    <ref id="glass"/>
  </shape>
  <shape type="cube" id="box">
    <transform name="to_world">
      <scale x="0.3" y="0.3" z="0.3"/>
      <translate x="1.2" y="-0.7" z="0.5"/>
    </transform>
    <ref id="two"/>
  </shape>
  <shape type="rectangle" id="lamp">
    <transform name="to_world">
      <rotate x="1" angle="90"/>
      <scale value="0.5"/>
      <translate x="0" y="2" z="0"/>
    </transform>
    <bsdf type="diffuse"><rgb name="reflectance" value="0"/></bsdf>
    <emitter type="area"><rgb name="radiance" value="8, 8, 8"/></emitter>
  </shape>
  <emitter type="point" id="p">
    <point name="position" x="1" y="2" z="-1"/>
    <rgb name="intensity" value="3"/>
  </emitter>
  <emitter type="constant"><rgb name="radiance" value="0.1"/></emitter>
</scene>
"""


def test_mitsuba_converter_matches_native(tmp_path):
    """The port's converter (a copy) gives the JAX converter's JSON for a
    Mitsuba XML written here, and the port renders the converted scene on
    the CPU."""
    xml = tmp_path / "scene.xml"
    xml.write_text(MITSUBA_XML)
    ours = convert_mitsuba(xml, tmp_path / "ours.json")
    theirs = jax_convert_mitsuba(str(xml))
    assert ours == theirs
    assert json.loads((tmp_path / "ours.json").read_text()) == theirs
    assert len(ours["shapes"]) == 4 and len(ours["lights"]) == 3
    rt = ignis_tpu_torch.loadFromString(json.dumps(ours), device="cpu",
                                        base_dir=str(tmp_path), spi=4)
    rt.step()
    img = rt.framebuffer(normalized=True)
    assert tuple(img.shape) == (24, 24, 3) and float(img.mean()) > 0


def _plane_rays(n=37):
    rays = np.zeros((n, 8), np.float32)
    rays[:, 0:3] = [0, 0, -2]
    dirs = np.stack([np.linspace(-0.2, 0.2, n), np.zeros(n), np.ones(n)], 1)
    rays[:, 3:6] = dirs / np.linalg.norm(dirs, axis=1, keepdims=True)
    rays[:, 7] = 3.0e38
    return rays


def test_trace_ray_list_matches_render():
    rt = load(SCENE, spi=8)
    rt.step()
    img = rt.framebuffer(normalized=True).numpy()
    rays = _plane_rays()
    n = len(rays)
    out = rt.trace(rays, spp=64)
    assert out.shape == (n, 3) and np.all(np.isfinite(out))
    h, w, _ = img.shape
    center_px = img[h // 2 - 1:h // 2 + 1, w // 2 - 1:w // 2 + 1].mean()
    center_tr = out[n // 2].mean()
    assert abs(center_tr - center_px) / max(center_px, 1e-6) < 0.35
    assert rt.trace(rays[:5], spp=4).shape == (5, 3)


def test_set_parameter_no_rebuild():
    """A registry parameter is copied into its tensor: no rebuild (the
    port's counterpart of the JAX test's "no recompile")."""
    rt = load(SCENE, spi=4)
    rt.step()
    a = float(rt.framebuffer(normalized=True).mean())
    rt.setParameter("tint", 0.8)
    rt.reset()
    rt.step()
    b = float(rt.framebuffer(normalized=True).mean())
    assert rt.rebuilds == 0
    assert abs(b / a - 4.0) < 0.02, (a, b)


def test_interactive_orbit_loop_no_rebuild():
    rt = load(SCENE, spi=1)
    rt.step()
    means = []
    for i in range(5):
        ang = i * 0.3
        eye = [2 * np.sin(ang), 0.0, -2 * np.cos(ang)]
        d = [-eye[0], 0.0, -eye[2]]
        rt.setCameraOrientation(eye, d, [0, 1, 0])
        rt.reset()
        rt.step()
        means.append(float(rt.framebuffer(normalized=True).mean()))
    assert rt.rebuilds == 0
    assert len(set(np.round(means, 6))) > 1


# -- tests/test_aux.py -------------------------------------------------------

def test_logger_levels_and_listeners(tmp_path):
    log = Logger()
    seen = []
    log.add_listener(lambda lvl, msg: seen.append((int(lvl), msg)))
    log.set_verbosity(LogLevel.WARNING)
    log.debug("hidden")
    log.info("hidden too")
    log.warning("shown")
    log.error("also shown")
    assert [m for _, m in seen] == ["shown", "also shown"]
    f = FileLogListener(str(tmp_path / "log.txt"))
    log.add_listener(f)
    log.error("to file")
    f.close()
    text = (tmp_path / "log.txt").read_text()
    assert "to file" in text and "[Error]" in text
    log.quiet = True
    log.error("silenced")
    assert len(seen) == 3


def test_render_pass_runs_user_kernel():
    rt = load(AUX_SCENE, spi=2)
    rt.step()

    def lum_pass(film, aovs, gain=1.0):
        assert isinstance(film, torch.Tensor) and film.device == rt.device
        assert sorted(aovs) == ["Albedo", "Depth", "Normals"]
        return (0.2126 * film[..., 0] + 0.7152 * film[..., 1]
                + 0.0722 * film[..., 2]) * gain

    p = rt.createPass(lum_pass)
    out = p.run(with_aovs=True, gain=2.0).numpy()
    assert out.shape == (8, 8) and p.result is not None
    film = rt.framebuffer(normalized=True).numpy()
    expect = 2.0 * (0.2126 * film[..., 0] + 0.7152 * film[..., 1]
                    + 0.0722 * film[..., 2])
    np.testing.assert_allclose(out, expect, rtol=1e-5)


def test_parameter_desc_set():
    descs = load(AUX_SCENE, spi=1).parameterDescs()
    ref = ignis_tpu.loadFromString(json.dumps(AUX_SCENE)).parameterDescs()
    assert descs == ref
    assert descs["strength"]["min"] == 0
    assert descs["strength"]["step"] == 0.1
    assert descs["strength"]["description"] == "demo knob"
    assert descs["tintv"]["type"] == "vector"
    assert descs["plain"] == {"type": "number", "value": 2.0}


SPHERE_SCENE = {
    "technique": {"type": "path", "max_depth": 3},
    "camera": {"type": "perspective", "fov": 60,
               "transform": [1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, -3,
                             0, 0, 0, 1]},
    "film": {"size": [24, 24]},
    "bsdfs": [{"type": "diffuse", "name": "w"}],
    "shapes": [{"type": "sphere", "name": "b", "radius": 0.5}],
    "entities": [{"name": "b", "shape": "b", "bsdf": "w"}],
    "lights": [{"type": "point", "name": "l", "position": [1, 2, 2],
                "power": 20},
               {"type": "env", "name": "e", "radiance": 0.4}],
}


def test_aov_registry_and_bake(tmp_path):
    from ignis_tpu_torch.render.bake import (bake_texture2d,
                                             bake_texture_average)
    scene = json.loads(json.dumps(SPHERE_SCENE))
    scene["film"]["size"] = [16, 16]
    scene["lights"] = [{"type": "env", "name": "e", "radiance": 0.5}]
    rt = load(scene)
    rt.step()
    assert rt.AOVs == ["Normals", "Albedo", "Depth"]
    nrm = rt.getFramebufferForHost("Normals")
    assert isinstance(nrm, np.ndarray) and nrm.shape == (16, 16, 3)
    assert rt.getFramebufferForHost("Depth").shape == (16, 16, 3)
    col = rt.getFramebufferForHost()
    assert col.shape == (16, 16, 3) and np.isfinite(col).all()
    rt.registerAOV("MyPass", np.full((16, 16, 3), 0.25, np.float32))
    assert "MyPass" in rt.AOVs
    np.testing.assert_allclose(rt.getFramebufferForHost("MyPass"), 0.25)
    with pytest.raises(KeyError):
        rt.getFramebufferForHost("Nope")
    with pytest.raises(ValueError):
        rt.registerAOV("Bad", np.zeros((3, 3, 3)))
    out = tmp_path / "fb.exr"
    rt.saveFramebuffer(str(out))
    channels, _ = jax_read_exr(str(out))
    assert any("MyPass" in k for k in channels)
    img = bake_texture2d("vec3(uv.x, 0, 1)", 32, 16, device="cpu")
    assert img.shape == (16, 32, 3)
    np.testing.assert_allclose(img[..., 2], 1.0)
    assert abs(img[..., 0].mean() - 0.5) < 0.02
    avg = bake_texture_average("vec3(uv.x, uv.y, 0.25)", res=32,
                               device="cpu")
    np.testing.assert_allclose(avg, [0.5, 0.5, 0.25], atol=0.02)


def test_checkpoint_resume_bitwise(tmp_path):
    txt = json.dumps(SPHERE_SCENE)
    ck = tmp_path / "state"
    rt = ignis_tpu_torch.loadFromString(txt, device="cpu", spi=1)
    rt.step().step()
    rt.saveCheckpoint(str(ck))
    rt.step().step()
    want = rt.framebuffer()
    assert rt.iteration_count == 4
    rt2 = ignis_tpu_torch.loadFromString(txt, device="cpu", spi=1)
    rt2.loadCheckpoint(str(ck))
    assert rt2.iteration_count == 2 and rt2.sample_count == 2
    rt2.step().step()
    assert torch.equal(rt2.framebuffer(), want)


def test_checkpoint_restores_the_registry(tmp_path):
    rt = load(SCENE, spi=2)
    rt.setParameter("tint", 0.6)
    rt.step()
    rt.saveCheckpoint(tmp_path / "c.npz")
    with np.load(tmp_path / "c.npz", allow_pickle=False) as z:
        assert sorted(z.files) == ["film", "frame", "iteration",
                                   "reg_tint", "registry_names",
                                   "sample_count", "seed"]
    rt2 = load(SCENE, spi=2).loadCheckpoint(tmp_path / "c")
    assert float(rt2.scene.registry["tint"]) == pytest.approx(0.6)
    assert rt2.rebuilds == 0
    rt.step()
    rt2.step()
    assert torch.equal(rt.framebuffer(), rt2.framebuffer())


# the render-parity bar of tests/test_torch_render.py
def _close_film(got, want):
    assert got.shape == want.shape and np.isfinite(got).all()
    close = np.isclose(got, want, rtol=1e-3, atol=1e-4).all(-1).mean()
    assert close >= 0.99, close
    assert abs(got.mean() - want.mean()) <= 0.005 * abs(want.mean())


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_checkpoint_resumes_across_packages(tmp_path, direction):
    """Two steps in one package, saved, loaded by the other, two more
    steps; against four straight steps of the loading package, by the
    render-parity bar of tests/test_torch_render.py."""
    txt = json.dumps(SPHERE_SCENE)

    def jax_rt():
        return ignis_tpu.loadFromString(txt, spi=1)

    def port_rt():
        return ignis_tpu_torch.loadFromString(txt, device="cpu", spi=1)

    def film(rt):
        f = rt.framebuffer()
        return f.numpy() if isinstance(f, torch.Tensor) else np.asarray(f)
    first, second = ((jax_rt, port_rt) if direction == "jax_to_port"
                     else (port_rt, jax_rt))
    a = first()
    a.step().step()
    a.saveCheckpoint(str(tmp_path / "ck"))
    b = second()
    b.loadCheckpoint(str(tmp_path / "ck"))
    assert b.iteration_count == 2 and b.sample_count == 2
    b.step().step()
    straight = second()
    for _ in range(4):
        straight.step()
    _close_film(film(b), film(straight))


# -- tests/test_cache.py -----------------------------------------------------

@pytest.fixture
def cachedir(tmp_path):
    d = cache.enable(tmp_path / "cache")
    yield d
    cache.disable()


def test_mesh_cache_roundtrip(cachedir, tmp_path):
    m = meshlib.make_uv_sphere((0, 0, 0), 1.0, stacks=8, slices=8)
    m.ensure_attributes()
    ply = tmp_path / "s.ply"
    meshlib.save_ply(str(ply), m)
    calls = []

    def loader():
        calls.append(1)
        return meshlib.load_ply(str(ply))
    m1 = cache.cached_mesh(str(ply), loader, "ply")
    m2 = cache.cached_mesh(str(ply), loader, "ply")
    assert len(calls) == 1, "second load must come from the cache"
    np.testing.assert_array_equal(m1.vertices, m2.vertices)
    np.testing.assert_array_equal(m1.indices, m2.indices)
    assert (m1.normals is None) == (m2.normals is None)
    if m1.normals is not None:
        np.testing.assert_array_equal(m1.normals, m2.normals)
    assert all(f.name.startswith("torch_") for f in cachedir.iterdir())


def test_mesh_cache_invalidates_on_content_change(cachedir, tmp_path):
    ply = tmp_path / "t.ply"
    for radius in (1.0, 2.0):
        m = meshlib.make_uv_sphere((0, 0, 0), radius, stacks=6, slices=6)
        m.ensure_attributes()
        meshlib.save_ply(str(ply), m)
        got = cache.cached_mesh(str(ply), lambda: meshlib.load_ply(str(ply)),
                                "ply")
        assert np.isclose(np.abs(got.vertices).max(), radius, atol=1e-5)


def test_cached_arrays_roundtrip(cachedir):
    key = [np.arange(12, dtype=np.float32), "tag"]
    calls = []

    def builder():
        calls.append(1)
        return {"a": np.arange(5, dtype=np.int32),
                "b": np.ones((2, 3), np.float32)}
    z1 = cache.cached_arrays("unit", key, builder)
    z2 = cache.cached_arrays("unit", key, builder)
    assert len(calls) == 1
    np.testing.assert_array_equal(z1["a"], z2["a"])
    np.testing.assert_array_equal(z1["b"], z2["b"])
    cache.cached_arrays("unit", [np.zeros(3, np.float32)], builder)
    assert len(calls) == 2


def test_cache_keys_differ_from_the_jax_package(cachedir, tmp_path):
    """The same PLY cached by both packages into one directory: each
    finds only its own artifact (the port's keys and names carry its
    tag)."""
    from ignis_tpu.scene import mesh as jax_meshlib
    from ignis_tpu.utils import cache as jax_cache
    m = meshlib.make_uv_sphere((0, 0, 0), 1.0, stacks=6, slices=6)
    m.ensure_attributes()
    ply = tmp_path / "s.ply"
    meshlib.save_ply(str(ply), m)
    jax_cache.enable(cachedir)
    try:
        jax_cache.cached_mesh(str(ply),
                              lambda: jax_meshlib.load_ply(str(ply)), "ply")
        calls = []
        cache.cached_mesh(str(ply), lambda: calls.append(1) or
                          meshlib.load_ply(str(ply)), "ply")
        assert calls == [1]
    finally:
        jax_cache.disable()
    names = sorted(f.name for f in cachedir.iterdir())
    assert len(names) == 2 and sum(n.startswith("torch_") for n in names) == 1


def test_scene_load_via_cache_matches(cachedir, tmp_path):
    """A PLY-backed scene of 1,024 triangles (a BVH) loads bit for bit
    the same from a warm cache: soup, attributes and BVH arrays."""
    m = meshlib.make_uv_sphere((0, 0, 1.0), 0.5, stacks=32, slices=16)
    m.ensure_attributes()
    ply = tmp_path / "ball.ply"
    meshlib.save_ply(str(ply), m)
    scene = {
        "technique": {"type": "path", "max_depth": 2},
        "camera": {"type": "perspective", "fov": 60,
                   "transform": [1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, -3,
                                 0, 0, 0, 1]},
        "film": {"size": [16, 16]},
        "bsdfs": [{"type": "diffuse", "name": "w"}],
        "shapes": [{"type": "ply", "name": "b", "filename": str(ply)}],
        "entities": [{"name": "b", "shape": "b", "bsdf": "w"}],
        "lights": [{"type": "env", "name": "e", "radiance": 0.5}],
    }
    txt = json.dumps(scene)
    rt1 = ignis_tpu_torch.loadFromString(txt, device="cpu",
                                         base_dir=str(tmp_path))
    n_files = len(list(cachedir.iterdir()))
    rt2 = ignis_tpu_torch.loadFromString(txt, device="cpu",
                                         base_dir=str(tmp_path))
    assert n_files == 2 and len(list(cachedir.iterdir())) == 2
    assert rt1.scene.bvh is not None
    for a, b in ((rt1.scene.tris, rt2.scene.tris),
                 (rt1.scene.tri_attr, rt2.scene.tri_attr),
                 (rt1.scene.bvh, rt2.scene.bvh)):
        for x, y in zip(torch.utils._pytree.tree_leaves(a),
                        torch.utils._pytree.tree_leaves(b)):
            assert torch.equal(x, y)


# -- tests/test_viewer.py ----------------------------------------------------

def test_viewer_loop_semantics():
    rt = ignis_tpu_torch.loadFromString(json.dumps(VIEW_SCENE), device="cpu",
                                        spi=2)
    state = V.ViewerState(rt)
    th = threading.Thread(target=state.render_loop, daemon=True)
    th.start()
    try:
        png, seq, stats = state.wait_frame(0, timeout=60)
        assert png.startswith(b"\x89PNG")
        assert stats["iteration"] >= 1
        png, seq2, stats2 = state.wait_frame(seq, timeout=60)
        assert stats2["iteration"] > stats["iteration"]
        assert stats2["spp"] == stats2["iteration"] * rt.SPI
        with state.lock:
            state.events.append({"type": "orbit", "dx": 120, "dy": 0})
        deadline = time.time() + 60
        while time.time() < deadline:
            png, seq, stats3 = state.wait_frame(seq, timeout=60)
            if stats3["iteration"] < stats2["iteration"]:
                break
        assert stats3["iteration"] < stats2["iteration"]
        assert stats3["frame"] > stats2["frame"]
        with state.lock:
            state.events.append({"type": "tonemap", "method": 1,
                                 "exposure": 2.0})
            state.events.append({"type": "key", "key": "v"})
        deadline = time.time() + 60
        while time.time() < deadline:
            png, seq, st4 = state.wait_frame(seq, timeout=60)
            if st4["tonemap"] == "reinhard" and st4["aov"] == "Normals":
                break
        assert st4["tonemap"] == "reinhard"
        assert st4["exposure"] == 2.0
        assert st4["aov"] == "Normals"
    finally:
        state.running = False
        th.join(timeout=120)
        assert not th.is_alive()


def test_viewer_frames_decode_as_the_tonemapped_film(tmp_path):
    """Three frames of the render loop in its worker thread: each frame's
    PNG (utils/image.encode_png) decodes through the port's read_png to
    the runtime's ACES-tonemapped film."""
    from ignis_tpu_torch.utils.image import read_png
    rt = ignis_tpu_torch.loadFromString(json.dumps(VIEW_SCENE), device="cpu",
                                        spi=1)
    state = V.ViewerState(rt)
    th = threading.Thread(target=state.render_loop, daemon=True)
    th.start()
    try:
        seq = 0
        for _ in range(3):
            png, seq, stats = state.wait_frame(seq, timeout=60)
    finally:
        state.running = False
        th.join(timeout=120)
    assert not th.is_alive() and seq >= 3 and stats["frame"] >= 3
    (tmp_path / "f.png").write_bytes(state.frame_png)
    img = read_png(tmp_path / "f.png")
    np.testing.assert_allclose(img * 255.0, rt.tonemap(method=3), atol=1e-3)


def test_camera_rig_math():
    rig = V.CameraRig([0, 0, -3], [0, 0, 1], [0, 1, 0], scene_radius=2.0)
    rig.orbit(100, 0)
    d = np.asarray(rig.dir)
    assert abs(np.linalg.norm(d) - 1) < 1e-6
    assert abs(d[2] - 1.0) > 0.05
    e0 = np.asarray(rig.eye).copy()
    rig.fly("w")
    assert np.linalg.norm(np.asarray(rig.eye) - e0) > 0.01
    rig.dolly(-2)
    assert np.isfinite(rig.eye).all()


# -- against ignis_tpu -------------------------------------------------------

TRACE_CASES = {
    "path": (SCENE, {}),
    "volpath": (SPHERE_SCENE, {"technique": "volpath"}),
    "ao": (SPHERE_SCENE, {"technique": "ao"}),
    "debug": (SPHERE_SCENE, {"technique": "debug"}),
}


@pytest.mark.parametrize("case", sorted(TRACE_CASES))
def test_trace_matches_jax_per_ray(case):
    """The same rays, spp and seed through both packages' trace(): ray by
    ray within rtol 1e-4 / atol 1e-5 on >= 99% of the rays (torch and XLA
    round transcendentals apart, so a roulette decision may flip), and
    the means within 0.5%; the second call (iteration 1) too."""
    scene, over = TRACE_CASES[case]
    txt = json.dumps(scene)
    rt = ignis_tpu_torch.loadFromString(txt, device="cpu", spi=1, seed=7,
                                        **over)
    jr = ignis_tpu.loadFromString(txt, spi=1, seed=7, **over)
    rng = np.random.default_rng(11)
    n = 300
    rays = np.zeros((n, 8), np.float32)
    rays[:, 0:3] = [0, 0.2, -2.5]
    d = np.stack([rng.uniform(-0.5, 0.5, n), rng.uniform(-0.5, 0.5, n),
                  np.ones(n)], 1)
    rays[:, 3:6] = d / np.linalg.norm(d, axis=1, keepdims=True)
    rays[:, 6] = 0.0
    rays[::7, 7] = 0.0          # tmax <= 0: unbounded
    rays[1::7, 7] = 1.0         # ends before the scene
    rays[2::7, 7] = 3.0e38
    rays[3::7, 7] = 2.6
    rays[4::7, 7] = -1.0
    rays[5::7, 7] = 1e3
    rays[6::7, 7] = 5.0
    for it in range(2):
        got = rt.trace(rays if it == 0 else rays[:, :6], spp=4)
        want = jr.trace(rays if it == 0 else rays[:, :6], spp=4)
        assert got.shape == want.shape == (n, 3)
        assert np.isfinite(got).all()
        close = np.isclose(got, want, rtol=1e-4, atol=1e-5).all(-1).mean()
        assert close >= 0.99, close
        assert abs(got.mean() - want.mean()) <= 0.005 * abs(want.mean()) \
            + 1e-7
    assert rt.iteration_count == 2


@pytest.mark.parametrize("technique", ["lt", "ppm", "aept"])
def test_trace_refuses_film_techniques(technique):
    rt = load(SPHERE_SCENE, spi=1, technique=technique)
    with pytest.raises(ValueError, match="does not support"):
        rt.trace(_plane_rays())


@pytest.mark.parametrize("scene_name", ["runtime_api", "sphere"])
def test_acquire_stats_matches_jax(scene_name):
    """The quantities of one instrumented iteration (BounceRay, ShadowRay,
    CameraRay, Iteration, OccupancyPct) equal the JAX package's; the
    film and counters stay; stats gets the integer quantities."""
    scene = {"runtime_api": SCENE, "sphere": SPHERE_SCENE}[scene_name]
    txt = json.dumps(scene)
    rt = ignis_tpu_torch.loadFromString(txt, device="cpu", spi=2)
    jr = ignis_tpu.loadFromString(txt, spi=2)
    rt.step()
    jr.step()
    before = rt.framebuffer().clone()
    q = rt.acquireStats()
    assert q == jr.acquireStats()
    assert q["CameraRay"] >= 16 * 16 or q["CameraRay"] >= 24 * 24
    assert rt.iteration_count == 1 and torch.equal(rt.framebuffer(), before)
    assert rt.stats.quantities["BounceRay"] == q["BounceRay"]
    assert "Iteration+Compile" in rt.stats.dump(1)


def test_acquire_stats_is_empty_for_other_techniques():
    assert load(SPHERE_SCENE, spi=1, technique="ao").acquireStats() == {}


def test_runtime_reference_api():
    """Properties, aliases, frame counting, the context manager, the
    tonemapped uint8 film, profiler traces and dumpShader (which leaves
    the film and counters alone)."""
    with load(SCENE, spi=2) as rt:
        rt.step()
        assert (rt.framebuffer_width, rt.framebuffer_height) == (16, 16)
        assert rt.FramebufferWidth == 16 and rt.FramebufferHeight == 16
        assert rt.IterationCount == 1 and rt.SampleCount == 2
        assert rt.SPI == 2 and rt.Technique == "path"
        rt.incFrameCount()
        rt.inc_frame()
        assert rt.FrameCount == 2
        ldr = rt.tonemap(method=1, exposure=0.5)
        assert ldr.dtype == np.uint8 and ldr.shape == (16, 16, 3)
        film = rt.framebuffer().clone()
        ops = rt.dumpShader()
        assert "aten::" in ops
        assert len(rt.dumpShader(full=True)) > 0
        assert torch.equal(rt.framebuffer(), film) and rt.IterationCount == 1
        rt.clearFramebuffer()
        assert rt.IterationCount == 0 and rt.FrameCount == 2
        assert float(rt.framebuffer().abs().sum()) == 0.0


def test_profiler_trace_writes_a_chrome_trace(tmp_path):
    rt = load(SCENE, spi=1)
    rt.startProfilerTrace(tmp_path / "prof")
    rt.step()
    assert rt.stopProfilerTrace() == str(tmp_path / "prof")
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert trace["traceEvents"]
    with pytest.raises(RuntimeError):
        rt.stopProfilerTrace()


def test_dump_shader_writes_its_path(tmp_path):
    rt = load(SCENE, spi=1)
    text = rt.dumpShader(tmp_path / "ops.txt")
    assert (tmp_path / "ops.txt").read_text() == text


def test_runtime_has_every_public_name_of_the_jax_runtime():
    rt = load(SCENE, spi=1)
    names = [n for n in dir(ignis_tpu.Runtime) if not n.startswith("_")]
    assert len(names) >= 39
    assert [n for n in names if not hasattr(rt, n)] == []
