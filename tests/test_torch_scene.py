"""Scene loading in ignis_tpu_torch: the bridge reproduces the JAX
SceneData exactly; the port's own JAX-free loader builds the same tables
as ignis_tpu.build_scene; the BVH covers every triangle; the package
imports and loads a scene with JAX unavailable."""
import json
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


def test_own_loader_matches_build_scene(pair):
    """The JAX-free loader: material, light, entity, camera and sphere
    tables equal the JAX build's; the same multiset of triangles (the
    order differs: no TPU chunk clustering or padding). The tables of the
    cdf and hierarchy light selectors are not built: only the uniform
    selector is on the slice."""
    _, ref, own = pair
    bridged, _ = from_reference(ref.scene, ref.settings, "cpu")
    for f in ("materials", "lights", "entities", "camera", "spheres",
              "sph_attr", "envmap", "media"):
        jl = dict(_leaves(getattr(bridged, f)))
        pl = dict(_leaves(getattr(own.scene, f)))
        assert jl.keys() == pl.keys(), f
        for k in jl:
            if k.startswith((".select_cdf", ".hier_")):
                continue
            np.testing.assert_array_equal(pl[k], jl[k], err_msg=f + k)
    assert own.settings.light_selector == "uniform"
    np.testing.assert_array_equal(_tri_rows(own.scene), _tri_rows(bridged))
    assert float(own.scene.scene_radius) == float(bridged.scene_radius)
    assert (own.scene.bvh is None) == (bridged.bvh is None)
    for f in ("width", "height", "max_depth", "min_depth", "spi",
              "infinite_light_rows", "n_lights", "bsdf_kinds", "light_kinds",
              "light_selector", "camera_type", "enable_nee"):
        assert getattr(own.settings, f) == getattr(ref.settings, f), f


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


@pytest.mark.parametrize("change, item", [
    (("shapes", 0, {"type": "cube", "name": "floor"}), "item 19"),
    (("bsdfs", 1, {"type": "conductor", "name": "glass"}), "item 6"),
    (("lights", 0, {"type": "spot", "name": "l", "position": [0, 2, 2]}),
     "item 7"),
])
def test_off_slice_features_raise(change, item):
    """Anything off the slice raises NotImplementedError naming its
    ROADMAP item."""
    scene = json.loads(json.dumps(_SCENE))
    key, i, obj = change
    scene[key][i] = obj
    with pytest.raises(NotImplementedError, match=item):
        ignis_tpu_torch.loadFromString(json.dumps(scene), device="cpu")


def test_cuda_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ignis_tpu_torch.loadFromString(json.dumps(_SCENE), device="cuda")
