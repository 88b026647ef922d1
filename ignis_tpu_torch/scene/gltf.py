"""glTF 2.0 importer: .gltf/.glb -> scene objects.

Copied from ignis_tpu/scene/gltf.py (an analog of the reference glTF
importer, glTFParser.cpp via tinygltf), unchanged: meshes with
POSITION/NORMAL/TEXCOORD_0 and indices become `inline` shapes, node
hierarchy transforms go to the entities, pbrMetallicRoughness materials
map to the principled BSDF with base-colour image textures,
KHR_lights_punctual lights to point, directional and spot lights, and the
first perspective camera to the scene's camera. Pure python and numpy.
"""
from __future__ import annotations

import base64
import json
import struct
from pathlib import Path

import numpy as np

_COMPONENT = {5120: np.int8, 5121: np.uint8, 5122: np.int16, 5123: np.uint16,
              5125: np.uint32, 5126: np.float32}
_NCOMP = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4, "MAT4": 16}


def _load_gltf(path: Path):
    data = path.read_bytes()
    if data[:4] == b"glTF":  # GLB container
        _, _, _ = struct.unpack("<III", data[:12])
        off = 12
        doc = None
        bin_chunk = b""
        while off < len(data):
            clen, ctype = struct.unpack("<II", data[off:off + 8])
            chunk = data[off + 8:off + 8 + clen]
            if ctype == 0x4E4F534A:  # JSON
                doc = json.loads(chunk)
            elif ctype == 0x004E4942:  # BIN
                bin_chunk = chunk
            off += 8 + clen
        return doc, [bin_chunk]
    doc = json.loads(data)
    buffers = []
    for buf in doc.get("buffers", []):
        uri = buf.get("uri", "")
        if uri.startswith("data:"):
            buffers.append(base64.b64decode(uri.split(",", 1)[1]))
        else:
            buffers.append((path.parent / uri).read_bytes())
    return doc, buffers


def _accessor(doc, buffers, idx):
    acc = doc["accessors"][idx]
    view = doc["bufferViews"][acc["bufferView"]]
    buf = buffers[view.get("buffer", 0)]
    dtype = _COMPONENT[acc["componentType"]]
    ncomp = _NCOMP[acc["type"]]
    count = acc["count"]
    offset = view.get("byteOffset", 0) + acc.get("byteOffset", 0)
    stride = view.get("byteStride", 0)
    itemsize = np.dtype(dtype).itemsize * ncomp
    if stride and stride != itemsize:
        rows = []
        for i in range(count):
            rows.append(np.frombuffer(buf, dtype, ncomp,
                                      offset + i * stride))
        arr = np.stack(rows)
    else:
        arr = np.frombuffer(buf, dtype, count * ncomp, offset)
        arr = arr.reshape(count, ncomp) if ncomp > 1 else arr
    if acc.get("normalized") and dtype != np.float32:
        arr = arr.astype(np.float32) / np.iinfo(dtype).max
    return np.array(arr)


def _node_matrix(node):
    if "matrix" in node:
        return np.asarray(node["matrix"], np.float64).reshape(4, 4).T
    m = np.eye(4)
    if "scale" in node:
        m[:3, :3] = np.diag(node["scale"])
    if "rotation" in node:
        x, y, z, w = node["rotation"]
        r = np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ])
        m[:3, :3] = r @ m[:3, :3]
    if "translation" in node:
        t = np.eye(4)
        t[:3, 3] = node["translation"]
        m = t @ m
    return m


def merge_gltf(scene, path: Path):
    """Merge a glTF file's content into a parser.Scene."""
    from .parser import SceneObject

    doc, buffers = _load_gltf(Path(path))
    prefix = Path(path).stem

    # Materials -> principled BSDFs
    mat_names = []
    for mi, mat in enumerate(doc.get("materials", [])):
        name = f"{prefix}_mat{mi}_{mat.get('name', '')}"
        pbr = mat.get("pbrMetallicRoughness", {})
        base = pbr.get("baseColorFactor", [1, 1, 1, 1])
        props = {
            "base_color": base[:3],
            "metallic": pbr.get("metallicFactor", 1.0),
            "roughness": pbr.get("roughnessFactor", 1.0),
        }
        tex = pbr.get("baseColorTexture")
        if tex is not None:
            t = doc["textures"][tex["index"]]
            img = doc["images"][t.get("source", 0)]
            if "uri" in img:
                tex_name = f"{prefix}_tex{tex['index']}"
                scene.textures[tex_name] = SceneObject(
                    "image", tex_name, {"filename": img["uri"]},
                    Path(path).parent)
                props["base_color"] = tex_name
        scene.bsdfs[name] = SceneObject("principled", name, props,
                                        Path(path).parent)
        mat_names.append(name)
    default_mat = f"{prefix}_default"
    scene.bsdfs.setdefault(default_mat, SceneObject(
        "principled", default_mat, {"base_color": [0.8, 0.8, 0.8],
                                    "metallic": 0.0, "roughness": 0.5},
        Path(path).parent))

    # Meshes -> inline shapes (one per primitive)
    mesh_prims = []  # mesh index -> [(shape_name, material_idx)]
    for mi, mesh in enumerate(doc.get("meshes", [])):
        prims = []
        for pi, prim in enumerate(mesh.get("primitives", [])):
            if prim.get("mode", 4) != 4:
                continue  # triangles only
            attrs = prim["attributes"]
            pos = _accessor(doc, buffers, attrs["POSITION"]).astype(np.float32)
            if "indices" in prim:
                idx = _accessor(doc, buffers, prim["indices"]).astype(np.int32)
            else:
                idx = np.arange(len(pos), dtype=np.int32)
            idx = idx.reshape(-1, 3)
            shape_name = f"{prefix}_m{mi}p{pi}"
            props = {"vertices": pos.reshape(-1).tolist(),
                     "indices": idx.reshape(-1).tolist()}
            if "NORMAL" in attrs:
                props["normals"] = _accessor(
                    doc, buffers, attrs["NORMAL"]).astype(np.float32) \
                    .reshape(-1).tolist()
            if "TEXCOORD_0" in attrs:
                uv = _accessor(doc, buffers, attrs["TEXCOORD_0"]) \
                    .astype(np.float32)
                uv[:, 1] = 1.0 - uv[:, 1]  # glTF v points down
                props["texcoords"] = uv.reshape(-1).tolist()
            scene.shapes[shape_name] = SceneObject("inline", shape_name,
                                                   props, Path(path).parent)
            prims.append((shape_name, prim.get("material")))
        mesh_prims.append(prims)

    # Node hierarchy
    lights_ext = (doc.get("extensions", {})
                  .get("KHR_lights_punctual", {}).get("lights", []))

    def walk(node_idx, parent_m):
        node = doc["nodes"][node_idx]
        m = parent_m @ _node_matrix(node)
        if "mesh" in node:
            for shape_name, mat_idx in mesh_prims[node["mesh"]]:
                ent_name = f"{prefix}_n{node_idx}_{shape_name}"
                bsdf = (mat_names[mat_idx] if mat_idx is not None
                        else default_mat)
                scene.entities[ent_name] = SceneObject(
                    "", ent_name,
                    {"shape": shape_name, "bsdf": bsdf,
                     "transform": m[:3, :].reshape(-1).tolist()},
                    Path(path).parent)
        lidx = (node.get("extensions", {})
                .get("KHR_lights_punctual", {}).get("light"))
        if lidx is not None and lidx < len(lights_ext):
            lt = lights_ext[lidx]
            lname = f"{prefix}_light{node_idx}"
            color = lt.get("color", [1, 1, 1])
            inten = lt.get("intensity", 1.0)
            pos = (m @ np.array([0, 0, 0, 1.0]))[:3]
            ldir = (m[:3, :3] @ np.array([0, 0, -1.0]))
            if lt.get("type") == "point":
                scene.lights[lname] = SceneObject(
                    "point", lname,
                    {"position": pos.tolist(),
                     "intensity": (np.asarray(color) * inten).tolist()},
                    Path(path).parent)
            elif lt.get("type") == "directional":
                scene.lights[lname] = SceneObject(
                    "directional", lname,
                    {"direction": ldir.tolist(),
                     "irradiance": (np.asarray(color) * inten).tolist()},
                    Path(path).parent)
            elif lt.get("type") == "spot":
                spot = lt.get("spot", {})
                scene.lights[lname] = SceneObject(
                    "spot", lname,
                    {"position": pos.tolist(), "direction": ldir.tolist(),
                     "intensity": (np.asarray(color) * inten).tolist(),
                     "cutoff": np.degrees(spot.get("outerConeAngle", 0.785)),
                     "falloff": np.degrees(spot.get("innerConeAngle", 0.6))},
                    Path(path).parent)
        if "camera" in node and scene.camera is None:
            cam = doc["cameras"][node["camera"]]
            if cam.get("type") == "perspective":
                p = cam.get("perspective", {})
                scene.camera = SceneObject(
                    "perspective", "camera",
                    {"vfov": np.degrees(p.get("yfov", 0.8)),
                     "near_clip": p.get("znear", 0.01),
                     "far_clip": p.get("zfar", 1e5),
                     # glTF cameras look down -Z; our convention: dir=+Z col
                     "transform": (m @ np.diag([1, 1, -1, 1]))[:3, :]
                     .reshape(-1).tolist()},
                    Path(path).parent)
        for ch in node.get("children", []):
            walk(ch, m)

    sidx = doc.get("scene", 0)
    roots = doc.get("scenes", [{}])[sidx].get("nodes", [])
    for r in roots:
        walk(r, np.eye(4))
