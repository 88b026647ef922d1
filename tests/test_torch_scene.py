"""Scene loading in ignis_tpu_torch: the bridge reproduces the JAX
SceneData exactly; the port's own JAX-free loader builds the same tables
as ignis_tpu.build_scene; the BVH covers every triangle; the package
imports and loads a scene with JAX unavailable."""
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import ignis_tpu
import ignis_tpu_torch
from ignis_tpu_torch import scenedata as sd
from ignis_tpu_torch.bridge import from_reference
from ignis_tpu_torch.bvh.builder import decode_leaf
from ignis_tpu_torch.render import bake

from __graft_entry__ import _SCENE
from test_analytic import flat_scene
from test_compaction import SCENE as COMPACTION_SCENE

# The tensors here are small; one intra-op thread per test process keeps
# parallel test workers from oversubscribing the cores.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent


def _point_flat():
    s = flat_scene(64)
    s["lights"].append({"type": "point", "name": "_l",
                        "position": [0, 0, -2], "power": 1})
    return s


# tests/test_bvh.py:271-283: the 20,480-triangle icosphere (a BVH scene)
ICO_SCENE = {
    "technique": {"type": "path"},
    "camera": {"type": "perspective", "fov": 60,
               "transform": [1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, -4,
                             0, 0, 0, 1]},
    "film": {"size": [16, 16]},
    "bsdfs": [{"type": "diffuse", "name": "w"}],
    "shapes": [{"type": "icosphere", "name": "s", "radius": 1.2,
                "subdivisions": 5}],
    "entities": [{"name": "s", "shape": "s", "bsdf": "w"}],
    "lights": [{"type": "env", "name": "e", "radiance": 1.0}],
}

SCENES = {"graft_entry": _SCENE, "compaction": COMPACTION_SCENE,
          "analytic_flat": _point_flat()}


@pytest.fixture(scope="module", params=sorted(SCENES))
def pair(request):
    text = json.dumps(SCENES[request.param])
    ref = ignis_tpu.loadFromString(text, spi=2)
    own = ignis_tpu_torch.loadFromString(text, device="cpu", spi=2)
    return request.param, ref, own


def _leaves(obj, prefix=""):
    """(path, numpy leaf) of nested NamedTuples/tuples, by field name."""
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        for f in obj._fields:
            yield from _leaves(getattr(obj, f), f"{prefix}.{f}")
    elif isinstance(obj, tuple):
        for i, v in enumerate(obj):
            yield from _leaves(v, f"{prefix}[{i}]")
    elif isinstance(obj, torch.Tensor):
        yield prefix, obj.numpy()
    else:
        yield prefix, np.asarray(obj)


def test_bridge_reproduces_every_leaf(pair):
    """Every leaf of the JAX SceneData arrives exactly (value and dtype);
    the only fields the port leaves out are empty on these scenes, and
    the TPU chunked-leaf BVH is dropped."""
    _, ref, _ = pair
    scene, settings = from_reference(ref.scene, ref.settings, "cpu")
    jax_scene = ref.scene
    assert jax_scene.textures == () and jax_scene.measured == ()
    assert jax_scene.registry == {} and jax_scene.instances is None
    for f in sd.SceneData._fields:
        jv = getattr(jax_scene, f)
        if f == "bvh":
            jv = None if jv is None else jv.tri
        pv = getattr(scene, f)
        if jv is None:
            assert pv is None
            continue
        jl, pl = dict(_leaves(jv)), dict(_leaves(pv))
        assert jl.keys() == pl.keys(), f
        for k in jl:
            assert pl[k].dtype == jl[k].dtype, f + k
            np.testing.assert_array_equal(pl[k], jl[k], err_msg=f + k)
    for f in ("width", "height", "max_depth", "spi", "seed", "n_lights",
              "infinite_light_rows", "bsdf_kinds", "light_kinds"):
        assert getattr(settings, f) == getattr(ref.settings, f)


def _tri_rows(scene):
    """Real triangles as rows (soup, normals, uvs, entity, area, shadow),
    padding (entity -1) dropped, in a canonical order."""
    ta = scene.tri_attr
    cols = [*scene.tris.v0, *scene.tris.e1, *scene.tris.e2, *ta.n0, *ta.n1,
            *ta.n2, *ta.uv0, *ta.uv1, *ta.uv2, ta.area]
    a = np.stack([np.asarray(c, np.float32) for c in cols], 1)
    ent = np.asarray(ta.ent)
    a = np.concatenate([a, ent[:, None].astype(np.float32),
                        np.asarray(ta.shadow_visible)[:, None]
                        .astype(np.float32)], 1)[ent >= 0]
    return a[np.lexsort(a.T[::-1])]


def _soup_rows(scene, ids):
    """The v0, e1, e2 rows of triangles `ids` of scene's soup."""
    cols = [*scene.tris.v0, *scene.tris.e1, *scene.tris.e2]
    return np.stack([np.asarray(c)[ids] for c in cols], 1)


def _assert_loader_matches(ref, own, env_rtol=0.0):
    """The own loader's tables against the bridged JAX build: every leaf
    of the material, light (selector CDF and hierarchy included), entity,
    camera, sphere, env, medium and texture tables equal (the env CDF
    within `env_rtol`), the same multiset of triangles (the order differs:
    no TPU chunk clustering or padding), and the same settings."""
    bridged, bs = from_reference(ref.scene, ref.settings, "cpu")
    for f in ("materials", "lights", "entities", "camera", "spheres",
              "sph_attr", "envmap", "media", "textures"):
        jl = dict(_leaves(getattr(bridged, f)))
        pl = dict(_leaves(getattr(own.scene, f)))
        assert jl.keys() == pl.keys(), f
        for k in jl:
            assert pl[k].dtype == jl[k].dtype, f + k
            if k == ".area_tris" and not own.scene.lights.tri_count.any():
                # no area light: both hold the placeholder row 0
                np.testing.assert_array_equal(pl[k], jl[k], err_msg=f + k)
            elif k == ".area_tris":
                # triangle ids: compare the triangles they name, since the
                # two soups order the triangles apart
                np.testing.assert_array_equal(
                    _soup_rows(own.scene, pl[k]), _soup_rows(bridged, jl[k]))
            elif f == "envmap" and env_rtol:
                np.testing.assert_allclose(pl[k], jl[k], rtol=env_rtol,
                                           atol=env_rtol, err_msg=f + k)
            else:
                np.testing.assert_array_equal(pl[k], jl[k], err_msg=f + k)
    np.testing.assert_array_equal(_tri_rows(own.scene), _tri_rows(bridged))
    assert float(own.scene.scene_radius) == float(bridged.scene_radius)
    assert (own.scene.bvh is None) == (bridged.bvh is None)
    for f in ("width", "height", "max_depth", "min_depth", "spi",
              "infinite_light_rows", "n_lights", "bsdf_kinds", "light_kinds",
              "light_selector", "camera_type", "enable_nee", "has_blend",
              "has_bump", "env_cdf_method", "transparent_shadows"):
        assert getattr(own.settings, f) == getattr(ref.settings, f), f
    assert own.settings.texture_descs == bs.texture_descs


def test_own_loader_matches_build_scene(pair):
    """The JAX-free loader builds the JAX build's tables
    (_assert_loader_matches), the uniform selector's scenes included."""
    _, ref, own = pair
    _assert_loader_matches(ref, own)
    assert own.settings.light_selector == "uniform"


@pytest.mark.parametrize("method", ["conditional", "sat", "hierachical"])
def test_own_loader_matches_build_scene_s5(method, tmp_path):
    """chip_smoke's S5 at 64x64 (icospheres at subdivisions 1, a 128x64
    substitute env written as EXR and read back by each package's loader):
    every BSDF kind of the slice, textures, a bump map, a textured blend
    weight, every light kind and the hierarchy selector's tables equal the
    JAX build's, under each env method. The conditional CDF's prefix sums
    are within 1e-5 (numpy and XLA associate float32 sums apart)."""
    import chip_smoke
    from ignis_tpu_torch.utils.envgen import ensure_substitute_env
    sc = chip_smoke.s5_scene(ensure_substitute_env(tmp_path, 128, 64),
                             subdivisions=1, size=64)
    sc["lights"][0]["cdf"] = method
    text = json.dumps(sc)
    ref = ignis_tpu.loadFromString(text, spi=2)
    own = ignis_tpu_torch.loadFromString(text, device="cpu", spi=2)
    assert ref.warnings == [] and own.warnings == []
    _assert_loader_matches(ref, own, env_rtol=1e-5)
    assert own.settings.light_selector == "hierarchy"
    assert len(own.scene.textures) == 4 and own.settings.has_bump


def test_bvh_covers_every_triangle_once(pair):
    """tests/test_bvh.py:104-131 on the port's BVH (scenes with one)."""
    name, _, own = pair
    bvh = own.scene.bvh
    if name != "compaction":
        assert bvh is None     # below BVH_THRESHOLD triangles
        return
    child = bvh.child.numpy()
    n = own.scene.tris.v0.x.shape[0]
    cover = np.zeros(n, bool)
    for node in range(child.shape[0]):
        for c in child[node]:
            if c < 0:
                s, cnt = decode_leaf(int(c))
                assert 1 <= cnt <= 4 and not cover[s:s + cnt].any()
                cover[s:s + cnt] = True
            elif c > 0:
                assert c < child.shape[0]
    assert cover.all()


def test_imports_and_loads_without_jax():
    """`import ignis_tpu_torch` and loading S2 (__graft_entry__._SCENE)
    succeed with JAX unimportable, and nothing of ignis_tpu is loaded."""
    code = (
        "import sys, json\n"
        "sys.modules['jax'] = None\n"
        "import ignis_tpu_torch\n"
        f"scene = json.loads({json.dumps(json.dumps(_SCENE))})\n"
        "scene['film'] = {'size': [16, 16]}\n"
        "rt = ignis_tpu_torch.loadFromString(json.dumps(scene), "
        "device='cpu')\n"
        "rt.step()\n"
        "assert float(rt.framebuffer(normalized=True).mean()) > 0\n"
        "assert not any(m == 'ignis_tpu' or m.startswith('ignis_tpu.') "
        "for m in sys.modules)\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_port_stands_alone_without_jax_package(tmp_path):
    """ignis_tpu_torch/ and chip_smoke.py copied into a directory without
    ignis_tpu/: with JAX unimportable, the port builds its own BVH builder
    (native.SOURCE lies inside the port's package), loads the
    20,480-triangle icosphere with a BVH on the CPU and renders one 16x16
    step, and loads it under the Hosek sky, whose data file is the port's
    own copy; nothing of ignis_tpu is loaded."""
    shutil.copytree(ROOT / "ignis_tpu_torch", tmp_path / "ignis_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    assert not (tmp_path / "ignis_tpu").exists()
    code = (
        "import sys, json\n"
        "sys.modules['jax'] = None\n"
        "from pathlib import Path\n"
        "import chip_smoke\n"
        "import ignis_tpu_torch\n"
        "from ignis_tpu_torch import native\n"
        "pkg = Path(ignis_tpu_torch.__file__).resolve().parent\n"
        "assert pkg.parent == Path.cwd().resolve(), pkg\n"
        "assert native.SOURCE.resolve().is_relative_to(pkg), native.SOURCE\n"
        "assert native.SOURCE.exists()\n"
        f"scene = json.loads({json.dumps(json.dumps(ICO_SCENE))})\n"
        "rt = ignis_tpu_torch.loadFromString(json.dumps(scene), "
        "device='cpu')\n"
        "assert rt.scene.bvh is not None\n"
        "assert rt.scene.tris.v0.x.numel() == 20480\n"
        "rt.step()\n"
        "img = rt.framebuffer(normalized=True)\n"
        "assert tuple(img.shape) == (16, 16, 3)\n"
        "assert float(img.mean()) > 0\n"
        "scene['lights'] = [{'type': 'sky', 'name': 'sky', "
        "'direction': [0.3, 0.8, 0.4]}]\n"
        "sky = ignis_tpu_torch.loadFromString(json.dumps(scene), "
        "device='cpu')\n"
        "assert sky.warnings == [] and bool(sky.scene.envmap.present)\n"
        "assert (pkg / 'data' / 'hosek_rgb.npz').exists()\n"
        "assert not any(m == 'ignis_tpu' or m.startswith('ignis_tpu.') "
        "for m in sys.modules)\n"
        "from ignis_tpu_torch.utils.image import save_image\n"
        "save_image('img.exr', img.numpy())\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
    assert list((tmp_path / "build" / "ignis_tpu_torch").glob(
        "bvh_builder_*.so"))
    # the frontends in the same copy: the CLI's help, igutil info on the
    # EXR just written, with JAX and ignis_tpu unimportable
    guard = ("import sys, runpy; sys.modules['jax'] = None; "
             "sys.modules['ignis_tpu'] = None; sys.argv = sys.argv[1:]; "
             "runpy.run_module(sys.argv[0], run_name='__main__')")
    for argv, want in ((["ignis_tpu_torch.cli", "--help"], "--target"),
                       (["ignis_tpu_torch.util_cli", "info", "img.exr",
                         "--target", "cpu"], "size: 16x16")):
        out = subprocess.run([sys.executable, "-c", guard, *argv],
                             cwd=tmp_path, capture_output=True, text=True,
                             timeout=300)
        assert out.returncode == 0, out.stderr
        assert want in out.stdout


def _with(key, i, obj):
    def change(scene):
        scene[key][i] = obj
    return change


def _expr_texture(scene):
    scene["bsdfs"][1] = {"type": "diffuse", "name": "glass",
                         "reflectance": "tex"}
    scene["textures"] = [{"type": "expr", "name": "tex",
                          "expr": "vec3(uv.x, uv.y, 0.5)"}]


def _pexpr_medium(scene):
    scene["media"] = [{"type": "homogeneous", "name": "m",
                       "sigma_a": "vec3(uv.x, 0.5, 0.5)"}]


def _parameters(scene):
    scene["parameters"] = {"exposure": 1.0}


@pytest.mark.parametrize("change", [
    _with("bsdfs", 1, {"type": "tensortree", "name": "glass",
                       "filename": "missing.xml"}),
    _with("bsdfs", 1, {"type": "klems", "name": "glass",
                       "filename": "missing.xml"}),
    _expr_texture, _pexpr_medium, _parameters,
    _with("lights", 0, {"type": "perez", "name": "l"}),
], ids=["tensortree", "klems", "expr_texture", "pexpr_sigma_a",
        "scene_parameters", "perez_sky"])
def test_scene_language_features_load(change):
    """What a scene file may hold of the scene language loads as in the
    JAX package: measured BSDFs (a missing file degrades to an error row
    with the JAX build's warning), PExpr textures, PExpr media, the
    parameter registry and the sky models."""
    scene = json.loads(json.dumps(_SCENE))
    change(scene)
    text = json.dumps(scene)
    ref = ignis_tpu.loadFromString(text, spi=1)
    own = ignis_tpu_torch.loadFromString(text, device="cpu", spi=1)
    assert own.warnings == list(ref.warnings)
    assert own.settings.bsdf_kinds == ref.settings.bsdf_kinds
    assert own.settings.light_kinds == ref.settings.light_kinds
    assert [d.kind for d in own.settings.texture_descs] == \
        [d.kind for d in ref.settings.texture_descs]
    assert ([e is None for e in own.settings.medium_exprs]
            == [e is None for e in ref.settings.medium_exprs])
    assert sorted(own.scene.registry) == sorted(ref.scene.registry)


def test_cuda_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ignis_tpu_torch.loadFromString(json.dumps(_SCENE), device="cuda")


@pytest.mark.parametrize("entry", ["loadFromString", "loadFromFile",
                                   "Runtime.load_from_string",
                                   "Runtime.load_from_file",
                                   "bake_texture2d", "bake_texture_average",
                                   "ViewerState", "cli", "trace_cli",
                                   "util_cli", "view"])
def test_entry_points_default_to_the_card(entry, tmp_path, capsys):
    """With no `device`, every entry point (the loaders, the bakes and a
    ViewerState's runtime) asks for the CUDA card: without one it raises,
    and never runs on the CPU. The frontends without --target exit 2 with
    a message and write nothing."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from ignis_tpu_torch import cli, trace_cli, util_cli, view
    text = json.dumps(_SCENE)
    scene_file = tmp_path / "scene.json"
    scene_file.write_text(text)
    rays = tmp_path / "rays.txt"
    rays.write_text("0 0 -2 0 0 1\n")
    image = tmp_path / "img.exr"
    from ignis_tpu_torch.utils.image import save_image
    save_image(image, np.ones((4, 4, 3), np.float32))
    frontends = {
        "cli": lambda: cli.main([str(scene_file), "-o",
                                 str(tmp_path / "out.exr")]),
        "trace_cli": lambda: trace_cli.main([str(scene_file), "-i",
                                             str(rays), "-o",
                                             str(tmp_path / "out.txt")]),
        "util_cli": lambda: util_cli.main(["info", str(image)]),
        "view": lambda: view.main([str(scene_file), "--term"]),
    }
    if entry in frontends:
        assert frontends[entry]() == 2
        assert "needs a CUDA device" in capsys.readouterr().err
        assert sorted(p.name for p in tmp_path.iterdir()) == \
            ["img.exr", "rays.txt", "scene.json"]
        return
    load = {"loadFromString": lambda: ignis_tpu_torch.loadFromString(text),
            "loadFromFile": lambda: ignis_tpu_torch.loadFromFile(scene_file),
            "Runtime.load_from_string":
                lambda: ignis_tpu_torch.Runtime.load_from_string(text),
            "Runtime.load_from_file":
                lambda: ignis_tpu_torch.Runtime.load_from_file(scene_file),
            "bake_texture2d": lambda: bake.bake_texture2d("uv.x", 4, 4),
            "bake_texture_average":
                lambda: bake.bake_texture_average("uv.x", res=4),
            "ViewerState":
                lambda: view.ViewerState(ignis_tpu_torch.loadFromFile(
                    scene_file)),
            }[entry]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load()
