"""Shapes and mesh loaders of ignis_tpu_torch against ignis_tpu.

Every shape generator of the port's scene/mesh.py against
ignis_tpu.scene.mesh at the same parameters (vertices, indices, normals
and uvs within 1e-6); each file loader against the JAX loader on files
written here (ascii and binary PLY, OBJ with quads, negative indices and a
shape index, a Mitsuba .serialized file, a .gltf with an embedded buffer);
and the scene the port builds for every shape type, a glTF include and
media against ignis_tpu.build_scene through the bridge, leaf for leaf
(tests/test_torch_scene.py's _assert_loader_matches: triangles compared
as a multiset, so a BVH's prim order does not matter)."""
import base64
import json
import struct
import zlib

import numpy as np
import pytest
import torch

import ignis_tpu
import ignis_tpu_torch
from ignis_tpu.scene import mesh as J
from ignis_tpu.scene import parser as jparser
from ignis_tpu_torch.scene import mesh as P
from ignis_tpu_torch.scene import parser as pparser

from test_compaction import VOL_SCENE
from test_torch_scene import _assert_loader_matches
from test_torch_texture import _png
from test_torch_volume import BOX_SCENE, WALK_SCENE

# The tensors here are small; one intra-op thread per test process keeps
# parallel test workers from oversubscribing the cores.
torch.set_num_threads(1)


def _assert_mesh_equal(got, ref, atol=1e-6):
    np.testing.assert_array_equal(got.indices, ref.indices)
    for f in ("vertices", "normals", "texcoords"):
        a, b = getattr(got, f), getattr(ref, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert a.dtype == b.dtype, f
            np.testing.assert_allclose(a, b, rtol=0, atol=atol, err_msg=f)


GENERATORS = {
    "triangle": ("make_triangle", ((0, 0, 0), (1, 0.2, 0), (0.3, 1, 0.5))),
    "plane": ("make_plane", ((-1, -1, 0), (2, 0, 0), (0, 2, 0.5))),
    "rectangle": ("make_rectangle", ((-1, -1, 0), (1, -1, 0), (1, 1, 0.2),
                                     (-1, 1, 0))),
    "box": ("make_box", ((-0.5, -1, -0.25), (1, 0, 0), (0, 2, 0),
                         (0, 0, 0.5))),
    "icosphere": ("make_ico_sphere", ((0.1, 0.2, 0.3), 0.7, 3)),
    "uvsphere": ("make_uv_sphere", ((0, 0, 1), 1.5, 12, 9)),
    "disk": ("make_disk", ((0, 1, 0), (0.3, 1, 0.2), 0.8, 24)),
    "cone": ("make_cone", ((0, 0, 0), 0.5, (0.2, 1.5, 0.1), 20, True)),
    "cone_open": ("make_cone", ((0, 0, 0), 0.5, (0, 0, -1), 7, False)),
    "cylinder": ("make_cylinder", ((0, 0, 0), 0.5, (0, 2, 0), 0.5, 32,
                                   True)),
    "cylinder_tapered": ("make_cylinder", ((1, 0, 0), 0.6, (1, 0.5, 1), 0.2,
                                           9, False)),
    "radial_gaussian": ("make_radial_gaussian", ((0, 0, 0), (0, 0.5, 0.2),
                                                 0.4, 1.5, 20, 10)),
    "gaussian_lobe": ("make_gaussian_lobe", ((0, 1, 0), (0.2, 0.1, 1),
                                             (1, 0, 0), (0, 1, 0),
                                             [[0.2, 0.05], [0.05, 0.3]], 16,
                                             24, 2.0)),
}


@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_generator_matches_jax(name):
    fn, args = GENERATORS[name]
    got, ref = getattr(P, fn)(*args), getattr(J, fn)(*args)
    assert len(got.indices) > 0
    _assert_mesh_equal(got, ref)


# ---------------------------------------------------------------------------
# file loaders
# ---------------------------------------------------------------------------

def _ascii_ply(path):
    """A quad and a triangle with normals and (s, t) uvs, and an element
    the loaders skip."""
    path.write_text("\n".join([
        "ply", "format ascii 1.0", "comment written by the port's tests",
        "element vertex 5",
        "property float x", "property float y", "property float z",
        "property float nx", "property float ny", "property float nz",
        "property float s", "property float t",
        "element face 2", "property list uchar int vertex_indices",
        "element edge 1", "property int vertex1", "property int vertex2",
        "end_header",
        "0 0 0 0 0 1 0 0", "1 0 0 0 0 1 1 0", "1 1 0 0 0 1 1 1",
        "0 1 0 0 0 1 0 1", "0.5 2 0.25 0 0.6 0.8 0.5 1",
        "4 0 1 2 3", "3 3 2 4", "0 1", ""]))


def _binary_quads_ply(path):
    """A binary PLY of two quads: the face loop's path (not all faces are
    triangles)."""
    v = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0], [0, 2, 0],
                  [1, 2, 0]], "<f4")
    head = ("ply\nformat binary_little_endian 1.0\nelement vertex 6\n"
            "property float x\nproperty float y\nproperty float z\n"
            "element face 2\nproperty list uchar int vertex_indices\n"
            "end_header\n").encode()
    faces = b"".join(struct.pack("<B4i", 4, *f) for f in ((0, 1, 2, 3),
                                                          (3, 2, 5, 4)))
    path.write_bytes(head + v.tobytes() + faces)


@pytest.mark.parametrize("kind", ["ascii", "binary_triangles",
                                  "binary_quads"])
def test_ply_loader_matches_jax(kind, tmp_path):
    """ascii PLY; binary PLY as save_ply writes it (triangles only: the
    port's one-pass face read); binary PLY of quads (the face loop). The
    port's writer writes the JAX writer's bytes."""
    p = tmp_path / f"{kind}.ply"
    if kind == "ascii":
        _ascii_ply(p)
    elif kind == "binary_triangles":
        m = J.make_ico_sphere((0, 0, 0), 1.0, 2)
        J.save_ply(p, m)
        q = tmp_path / "port.ply"
        P.save_ply(q, P.make_ico_sphere((0, 0, 0), 1.0, 2))
        assert q.read_bytes() == p.read_bytes()
    else:
        _binary_quads_ply(p)
    got, ref = P.load_ply(p), J.load_ply(p)
    assert len(got.indices) >= 3
    _assert_mesh_equal(got, ref, atol=0)


def test_obj_loader_matches_jax(tmp_path):
    """OBJ with v/vt/vn corners, a quad, negative (relative) indices, a
    vertex-only face and a shape index; and the OBJ writer's output read
    back by both loaders."""
    p = tmp_path / "m.obj"
    p.write_text("\n".join([
        "# two objects", "o first",
        "v 0 0 0", "v 1 0 0", "v 1 1 0", "v 0 1 0",
        "vt 0 0", "vt 1 0", "vt 1 1", "vt 0 1",
        "vn 0 0 1",
        "f 1/1/1 2/2/1 3/3/1 4/4/1",
        "o second",
        "v 0 0 1", "v 1 0 1", "v 0 1 1",
        "f -3/-4/-1 -2/-3/-1 -1/-2/-1",
        "f 5 6 7", ""]))
    for si in (-1, 0, 1):
        _assert_mesh_equal(P.load_obj(p, si), J.load_obj(p, si), atol=0)
    q = tmp_path / "w.obj"
    P.save_obj(q, P.make_cone((0, 0, 0), 0.5, (0, 1, 0), 6, True))
    r = tmp_path / "w_ref.obj"
    J.save_obj(r, J.make_cone((0, 0, 0), 0.5, (0, 1, 0), 6, True))
    assert q.read_text() == r.read_text()
    _assert_mesh_equal(P.load_obj(q), J.load_obj(q), atol=0)


def _serialized(path, with_normals):
    """A version-4 Mitsuba .serialized file of two shapes, as
    tests/test_components.py:45 writes one."""
    verts = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]], np.float32)
    idx = np.array([[0, 1, 2], [0, 2, 3]], np.uint32)
    uv = np.array([[0, 0], [1, 0], [0, 1], [0, 0]], np.float32)
    nrm = np.tile(np.array([[0, 0, 1]], np.float32), (4, 1))
    blob, offsets = b"", []
    for k in range(2):
        flags = 0x0002 | 0x1000 | (0x0001 if with_normals else 0)
        payload = (struct.pack("<I", flags) + f"s{k}".encode() + b"\x00"
                   + struct.pack("<QQ", 4, 2) + (verts + k).tobytes()
                   + (nrm.tobytes() if with_normals else b"")
                   + uv.tobytes() + idx.tobytes())
        offsets.append(len(blob))
        blob += struct.pack("<HH", 0x041C, 4) + zlib.compress(payload)
    blob += b"".join(struct.pack("<Q", o) for o in offsets)
    path.write_bytes(blob + struct.pack("<I", 2))


@pytest.mark.parametrize("with_normals", [False, True])
def test_mitsuba_loader_matches_jax(with_normals, tmp_path):
    p = tmp_path / "m.serialized"
    _serialized(p, with_normals)
    for si in (0, 1):
        got, ref = P.load_mts_serialized(p, si), J.load_mts_serialized(p, si)
        assert float(got.vertices.min()) == si
        _assert_mesh_equal(got, ref, atol=0)
    _assert_mesh_equal(P.load_mesh_file(p), J.load_mesh_file(p), atol=0)


# ---------------------------------------------------------------------------
# glTF
# ---------------------------------------------------------------------------

def _gltf(tmp_path):
    """A .gltf of one textured quad under a translated, rotated and scaled
    node, a point light on a child node and a perspective camera; one
    base64 buffer holds positions, normals, uvs and uint16 indices."""
    pos = np.array([[-1, 0, -1], [1, 0, -1], [1, 0, 1], [-1, 0, 1]],
                   np.float32)
    nrm = np.tile(np.array([[0, 1, 0]], np.float32), (4, 1))
    uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    idx = np.array([0, 2, 1, 0, 3, 2], np.uint16)
    buf = pos.tobytes() + nrm.tobytes() + uv.tobytes() + idx.tobytes()
    views = [(0, 48), (48, 48), (96, 32), (128, 12)]
    img = (np.random.RandomState(4).rand(8, 8, 3) * 255).astype(np.uint8)
    _png(tmp_path / "base.png", img, 2)
    doc = {
        "asset": {"version": "2.0"},
        "buffers": [{"byteLength": len(buf), "uri":
                     "data:application/octet-stream;base64,"
                     + base64.b64encode(buf).decode()}],
        "bufferViews": [{"buffer": 0, "byteOffset": o, "byteLength": n}
                        for o, n in views],
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": 4,
             "type": "VEC3"},
            {"bufferView": 1, "componentType": 5126, "count": 4,
             "type": "VEC3"},
            {"bufferView": 2, "componentType": 5126, "count": 4,
             "type": "VEC2"},
            {"bufferView": 3, "componentType": 5123, "count": 6,
             "type": "SCALAR"}],
        "images": [{"uri": "base.png"}],
        "textures": [{"source": 0}],
        "materials": [{"name": "tile", "pbrMetallicRoughness": {
            "baseColorFactor": [1, 1, 1, 1], "metallicFactor": 0.1,
            "roughnessFactor": 0.6, "baseColorTexture": {"index": 0}}}],
        "meshes": [{"primitives": [{"attributes": {
            "POSITION": 0, "NORMAL": 1, "TEXCOORD_0": 2}, "indices": 3,
            "material": 0}]}],
        "extensions": {"KHR_lights_punctual": {"lights": [
            {"type": "point", "color": [1, 0.9, 0.8], "intensity": 5}]}},
        "cameras": [{"type": "perspective", "perspective": {
            "yfov": 0.9, "znear": 0.01, "zfar": 100}}],
        "nodes": [
            {"mesh": 0, "translation": [0, -0.5, 0],
             "rotation": [0, 0.3826834, 0, 0.9238795], "scale": [2, 1, 2],
             "children": [1]},
            {"translation": [0, 1.5, 0],
             "extensions": {"KHR_lights_punctual": {"light": 0}}},
            {"camera": 0, "translation": [0, 1, 4]}],
        "scenes": [{"nodes": [0, 2]}],
        "scene": 0,
    }
    (tmp_path / "quad.gltf").write_text(json.dumps(doc))
    return {"technique": {"type": "path", "max_depth": 3},
            "film": {"size": [32, 32]},
            "externals": [{"filename": "quad.gltf"}],
            "lights": [{"type": "env", "name": "sky",
                        "radiance": [0.2, 0.2, 0.25]}]}


def _objects(scene):
    """The parsed scene's objects by kind and name: (type, props with
    arrays as lists)."""
    def norm(v):
        if isinstance(v, np.ndarray):
            return v.tolist()
        if isinstance(v, (list, tuple)):
            return [norm(x) for x in v]
        return v
    out = {}
    for kind in ("shapes", "entities", "bsdfs", "textures", "lights"):
        out[kind] = {k: (o.plugin_type, {p: norm(v) for p, v in
                                         o.props.items()})
                     for k, o in getattr(scene, kind).items()}
    out["camera"] = (scene.camera.plugin_type,
                     {p: norm(v) for p, v in scene.camera.props.items()})
    return out


def test_gltf_include_matches_jax(tmp_path):
    """The glTF include merged through both parsers gives the same objects
    (an inline shape, the principled BSDF with its base-colour image
    texture, an entity under the node's transform, the point light and
    the camera); both builds give the same tables, and the port renders
    it through loadFromString -> Runtime.step()."""
    text = json.dumps(_gltf(tmp_path))
    own = pparser.load_from_string(text, tmp_path)
    ref = jparser.load_from_string(text, tmp_path)
    assert _objects(own) == _objects(ref)
    assert {o.plugin_type for o in own.shapes.values()} == {"inline"}
    assert {o.plugin_type for o in own.lights.values()} == {"point", "env"}
    rt = ignis_tpu.loadFromString(text, base_dir=str(tmp_path), spi=2)
    port = ignis_tpu_torch.loadFromString(text, device="cpu",
                                          base_dir=str(tmp_path), spi=2)
    assert rt.warnings == [] and port.warnings == []
    _assert_loader_matches(rt, port)
    img = port.step().framebuffer(normalized=True)
    assert bool(torch.isfinite(img).all()) and float(img.mean()) > 0.01


# ---------------------------------------------------------------------------
# scenes of every shape type
# ---------------------------------------------------------------------------

def _shape_scene(shapes, media=False):
    """A floor and `shapes` (shape dicts, one entity each, in a row along
    x) under a point light and an env, with an analytic sphere."""
    sc = {"technique": {"type": "path", "max_depth": 4},
          "camera": {"type": "perspective", "fov": 60,
                     "transform": [-1, 0, 0, 0, 0, 1, 0, 0.5, 0, 0, -1, 6,
                                   0, 0, 0, 1]},
          "film": {"size": [32, 32]},
          "bsdfs": [{"type": "diffuse", "name": "w",
                     "reflectance": [0.7, 0.7, 0.7]}],
          "shapes": [{"type": "rectangle", "name": "floor", "width": 10,
                      "height": 10},
                     {"type": "sphere", "name": "ball", "radius": 0.3,
                      "center": [0, 1.5, 0]}],
          "entities": [{"name": "floor", "shape": "floor", "bsdf": "w",
                        "transform": [{"translate": [0, -1, 0]},
                                      {"rotate": [-90, 0, 0]}]},
                       {"name": "ball", "shape": "ball", "bsdf": "w"}],
          "lights": [{"type": "point", "name": "l", "position": [1, 3, 2],
                      "power": 50},
                     {"type": "env", "name": "e", "radiance": 0.3}]}
    for i, s in enumerate(shapes):
        s = dict(s, name=f"s{i}")
        sc["shapes"].append(s)
        sc["entities"].append({
            "name": f"s{i}", "shape": f"s{i}", "bsdf": "w",
            "transform": [{"translate": [-3 + 1.5 * i, 0, 0]},
                          {"scale": 0.5}]})
    return sc


def _mesh_files(tmp_path):
    cyl = P.make_cylinder((0, 0, 0), 0.5, (0, 1, 0), 0.3, 12, True)
    P.save_obj(tmp_path / "cyl.obj", cyl)
    P.save_ply(tmp_path / "ico.ply", P.make_ico_sphere((0, 0, 0), 1.0, 3))
    _serialized(tmp_path / "two.serialized", True)
    _ascii_ply(tmp_path / "quad.ply")


SHAPE_SETS = {
    "box_cube": [{"type": "box", "width": 1, "height": 2, "depth": 0.5},
                 {"type": "cube"}],
    "cylinder_cone_disk": [
        {"type": "cylinder", "p0": [0, 0, 0], "p1": [0, 1, 0],
         "radius": 0.5, "sections": 16},
        {"type": "cylinder", "bottom_radius": 0.7, "top_radius": 0.2,
         "filled": False},
        {"type": "cone", "p0": [0, 0, 0], "p1": [0, 1.2, 0], "radius": 0.6},
        {"type": "disk", "origin": [0, 0.5, 0], "normal": [0, 1, 1],
         "radius": 0.5}],
    "gaussians": [
        {"type": "gauss", "normal": [0, 1, 0], "height": 1.5, "sigma": 0.3},
        {"type": "gauss_lobe", "direction": [0, 1, 0.2], "sigma_theta": 0.4,
         "sigma_phi": 0.6, "anisotropy": 0.2, "theta_size": 16,
         "phi_size": 24}],
    "mesh_files": [
        {"type": "ply", "filename": "ico.ply"},
        {"type": "obj", "filename": "cyl.obj"},
        {"type": "mitsuba", "filename": "two.serialized", "shape_index": 1},
        {"type": "external", "filename": "quad.ply"},
        {"type": "inline", "vertices": [0, 0, 0, 1, 0, 0, 0, 1, 0, 1, 1, 0],
         "indices": [0, 1, 2, 2, 1, 3], "texcoords": [0, 0, 1, 0, 0, 1, 1,
                                                      1]},
        {"type": "triangle", "p0": [0, 0, 0], "p1": [1, 0, 0],
         "p2": [0, 1, 1]}],
    "unsupported_and_flags": [
        {"type": "teapot"},
        {"type": "icosphere", "subdivisions": 1, "flip_normals": True},
        {"type": "uvsphere", "stacks": 8, "slices": 6, "face_normals": True,
         "transform": [{"rotate": [30, 0, 0]}]},
        {"type": "rectangle", "smooth_normals": True, "subdivision": 1}],
}


@pytest.mark.parametrize("which", sorted(SHAPE_SETS))
def test_shape_types_build_as_jax(which, tmp_path):
    """A scene of each set of shape types (every type of
    ignis_tpu/scene/build.py:225-330, mesh files written here, an unknown
    type skipped with the JAX build's warning) builds the JAX build's
    tables in the port, the analytic sphere kept analytic in both; the
    port renders it."""
    _mesh_files(tmp_path)
    text = json.dumps(_shape_scene(SHAPE_SETS[which]))
    rt = ignis_tpu.loadFromString(text, base_dir=str(tmp_path), spi=1)
    port = ignis_tpu_torch.loadFromString(text, device="cpu",
                                          base_dir=str(tmp_path), spi=1)
    assert port.warnings == rt.warnings
    _assert_loader_matches(rt, port)
    assert port.scene.spheres.radius.numel() == 1
    img = port.step().framebuffer(normalized=True)
    assert bool(torch.isfinite(img).all()) and float(img.mean()) > 0.01


@pytest.mark.parametrize("which", ["vol", "walk", "box"])
def test_media_and_see_through_rows_build_as_jax(which):
    """Media (constants, an entity's inner and outer medium) and the rows
    that turn transparent shadows on (thin dielectric, transparent,
    passthrough, RAD_ROOS) build the JAX build's tables and settings."""
    scene = {"vol": VOL_SCENE, "walk": WALK_SCENE, "box": BOX_SCENE}[which]
    sc = json.loads(json.dumps(scene))
    if which == "vol":
        sc["entities"][1]["outer_medium"] = "fog"
    text = json.dumps(sc)
    rt = ignis_tpu.loadFromString(text, spi=1)
    port = ignis_tpu_torch.loadFromString(text, device="cpu", spi=1)
    _assert_loader_matches(rt, port)
    assert port.settings.transparent_shadows == (which != "vol")
    assert int(port.scene.entities.med_inner.max()) >= 0
