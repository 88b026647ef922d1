"""Scene build: parsed scene graph -> SceneData tensors + RenderSettings.

The slice's subset of ignis_tpu/scene/build.py, producing the port's
SceneData directly as tensors on an explicit device, without JAX.
Covered: perspective/orthogonal/fishlens cameras; rectangle, analytic
sphere, icosphere and uvsphere shapes; diffuse (with Oren-Nayar
roughness) and smooth, non-thin dielectric BSDFs; point and constant
environment lights. Anything else raises NotImplementedError naming its
ROADMAP item. Rows and values follow the JAX build exactly; the triangle
order differs: scenes with a BVH are reordered by the tri-leaf BVH8's
prim_order alone (no TPU chunk padding or clustering), smaller scenes keep
their load order, and the soup is not padded (an empty scene gets one
degenerate triangle).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from ..bvh.builder import build_bvh8
from ..core.vec import Color, Vec2, Vec3
from ..models.bsdf import DELTA_ALPHA, BsdfKind
from ..models.light import LightKind
from ..ops.bvh import BVHArrays
from ..ops.intersect import SphereSoup, TriSoup
from ..scenedata import (CameraData, Entities, EnvMap, Lights, Materials,
                         Media, RenderSettings, SceneData, SphereAttributes,
                         TriAttributes)
from . import mesh as meshlib
from .parser import Scene, SceneObject

# A triangle count carried over from the JAX package (scene/build.py:1305,
# measured there on a TPU); not yet measured on the card.
BVH_THRESHOLD = 512

DIELECTRIC_IOR = {
    "vacuum": 1.0, "air": 1.000277, "water": 1.3330, "ice": 1.31,
    "bk7": 1.5046, "glass": 1.5046, "fused_quartz": 1.458,
    "sapphire": 1.77, "diamond": 2.419, "polypropylene": 1.49,
    "ethanol": 1.361, "pet": 1.5750, "acrylic_glass": 1.49,
}

_MESH_SHAPES = ("rectangle", "icosphere", "uvsphere")


@dataclass
class BuiltScene:
    data: SceneData
    settings: RenderSettings
    warnings: List[str] = field(default_factory=list)


def _todo(what: str, item: str):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP queue 1, "
                               f"item {item})")


def _const_color(obj: SceneObject, key, default) -> np.ndarray:
    v = obj.get_color(key, default)
    if isinstance(v, str):
        raise _todo(f"{obj.name}.{key}: textured or PExpr value '{v}'",
                    "7 (textures) / 15 (PExpr)")
    return np.asarray(v, np.float64)


def _const_number(obj: SceneObject, key, default) -> float:
    v = obj.get(key, default)
    if isinstance(v, str):
        raise _todo(f"{obj.name}.{key}: PExpr value '{v}'", "15 (PExpr)")
    return float(v)


def _shape_to_mesh(obj: SceneObject) -> meshlib.TriMesh:
    t = obj.plugin_type
    p = obj
    if t == "rectangle":
        if "p0" in p.props:
            m = meshlib.make_rectangle(p.get_vec3("p0", (-1, -1, 0)),
                                       p.get_vec3("p1", (1, -1, 0)),
                                       p.get_vec3("p2", (1, 1, 0)),
                                       p.get_vec3("p3", (-1, 1, 0)))
        else:
            w = p.get_number("width", 2.0)
            h = p.get_number("height", 2.0)
            origin = p.get_vec3("origin", (-w / 2, -h / 2, 0))
            m = meshlib.make_plane(origin, np.array([w, 0, 0]),
                                   np.array([0, h, 0]))
    elif t == "icosphere":
        m = meshlib.make_ico_sphere(p.get_vec3("center"),
                                    p.get_number("radius", 1.0),
                                    p.get_int("subdivisions", 4))
    elif t == "uvsphere":
        m = meshlib.make_uv_sphere(p.get_vec3("center"),
                                   p.get_number("radius", 1.0),
                                   p.get_int("stacks", 32),
                                   p.get_int("slices", 16))
    else:
        raise _todo(f"shape type '{t}'", "19 (remaining shapes and mesh "
                    "loaders)")
    # post-processing flags (TriMeshProvider.cpp:525-545)
    if p.get_bool("flip_normals", False):
        m.flip_normals()
    if p.get_bool("face_normals", False):
        m.ensure_attributes()
        m.setup_face_normals_as_vertex_normals()
    elif p.get_bool("smooth_normals", False):
        m.compute_vertex_normals()
    tr = p.get_transform()
    if not np.allclose(tr, np.eye(4)):
        m.ensure_attributes()
        m.transform(tr)
    for _ in range(p.get_int("subdivision", 0)):
        m.ensure_attributes()
        m.subdivide()
    m.ensure_attributes()
    return m


def _roughness(obj: SceneObject) -> float:
    """Largest alpha of BSDF::setupRoughness (no property = delta)."""
    name = "alpha" if ("alpha" in obj.props or "alpha_u" in obj.props
                       or "alpha_v" in obj.props) else "roughness"
    if name + "_u" in obj.props or name + "_v" in obj.props:
        ru = _const_number(obj, name + "_u", 0.1)
        return max(ru, _const_number(obj, name + "_v", ru))
    if name not in obj.props:
        return 0.0
    r = _const_number(obj, name, 0.1)
    aniso = _const_number(obj, "anisotropic", 0.0)
    return r / math.sqrt(1.0 - min(max(aniso, 0.0), 1.0) * 0.99)


def _bsdf_row(obj: SceneObject) -> dict:
    """Translate a BSDF scene object into a Materials row dict."""
    t = obj.plugin_type
    row = dict(kind=int(BsdfKind.DIFFUSE),
               base=np.array([0.8, 0.8, 0.8]), extra=np.zeros(3),
               extra2=np.zeros(3), p0=0.0, p1=0.0, p2=0.0, p3=0.0,
               q0=0.0, q1=0.0, q2=0.0, q3=0.0, q4=0.0, q5=0.0,
               q6=0.0, q7=0.0, q8=0.0,
               base_tex=-1, extra_tex=-1, p0_tex=-1, p1_tex=-1,
               bump_kind=0, bump_tex=-1, bump_strength=1.0)

    def ior(key, default_name):
        s = obj.get_string(key + "_material")
        if s and s.lower() in DIELECTRIC_IOR:
            return DIELECTRIC_IOR[s.lower()]
        return _const_number(obj, key, DIELECTRIC_IOR[default_name])

    if t in ("diffuse", "roughdiffuse"):
        row["base"] = _const_color(obj, "reflectance", (0.8, 0.8, 0.8))
        row["p1"] = obj.get_number("roughness", 0.0)
    elif t in ("dielectric", "glass"):
        row["kind"] = int(BsdfKind.DIELECTRIC)
        row["base"] = _const_color(obj, "specular_reflectance", (1, 1, 1))
        row["extra"] = _const_color(obj, "specular_transmittance", (1, 1, 1))
        row["p0"] = ior("ext_ior", "vacuum")
        row["p1"] = ior("int_ior", "bk7")
        if _roughness(obj) > DELTA_ALPHA:
            raise _todo(f"rough dielectric '{obj.name}'", "6")
        if obj.get_bool("thin", False):
            raise _todo(f"thin dielectric '{obj.name}' (transparent "
                        "shadows)", "12")
    else:
        raise _todo(f"BSDF type '{t}'", "6 (remaining BSDF kinds)")
    return row


def build_scene(scene: Scene, device, overrides: Optional[dict] = None
                ) -> BuiltScene:
    device = torch.device(device)
    warnings: List[str] = []
    overrides = overrides or {}
    if overrides.get("instancing"):
        raise _todo("instancing", "13")

    # --- film / technique / camera -------------------------------------
    film = scene.film
    size = film.get("size", [800, 600]) if film else [800, 600]
    width, height = int(size[0]), int(size[1])
    width = int(overrides.get("width", width))
    height = int(overrides.get("height", height))

    tech = scene.technique
    tech_type = tech.plugin_type if tech else "path"
    if overrides.get("technique"):
        tech_type = str(overrides["technique"])
    max_depth = (tech.get_int("max_depth", tech.get_int("max_camera_depth",
                                                         64))
                 if tech else 64)
    min_depth = (tech.get_int("min_depth", tech.get_int("min_camera_depth",
                                                         2))
                 if tech else 2)
    if "max_depth" in overrides:
        max_depth = int(overrides["max_depth"])
    clamp = tech.get_number("clamp", 0.0) if tech else 0.0
    enable_nee = tech.get_bool("nee", True) if tech else True

    cam = scene.camera
    cam_type = cam.plugin_type if cam else "perspective"
    if overrides.get("camera"):
        cam_type = str(overrides["camera"])
    cam_transform = (cam.get_transform()
                     if (cam and "transform" in cam.props) else None)
    near = cam.get_number("near_clip", 0.0) if cam else 0.0
    far = cam.get_number("far_clip", 3.0e38) if cam else 3.0e38
    aspect = width / float(height)
    if cam is not None and cam.get("aspect_ratio") is not None:
        aspect = cam.get_number("aspect_ratio", aspect)
    if cam is not None and "vfov" in cam.props:
        sh = math.tan(math.radians(cam.get_number("vfov", 60.0)) / 2)
        sw = sh * aspect
    else:
        fovkey = "hfov" if (cam is not None and "hfov" in cam.props) else "fov"
        fov = math.radians(cam.get_number(fovkey, 60.0) if cam else 60.0)
        sw = math.tan(fov / 2)
        sh = sw / aspect
    fish_mode = cam.get_string("mode", "circular") if cam else "circular"

    # --- shapes ---------------------------------------------------------
    meshes: Dict[str, meshlib.TriMesh] = {}
    analytic_spheres: Dict[str, tuple] = {}
    for name, obj in scene.shapes.items():
        if obj.plugin_type == "sphere":
            analytic_spheres[name] = (obj.get_vec3("center"),
                                      obj.get_number("radius", 1.0))
        elif obj.plugin_type in _MESH_SHAPES:
            meshes[name] = _shape_to_mesh(obj)
        else:
            raise _todo(f"shape type '{obj.plugin_type}'",
                        "19 (remaining shapes and mesh loaders)")
    if scene.textures:
        raise _todo("textures", "7")
    if scene.media:
        raise _todo("participating media", "12")

    # --- materials ------------------------------------------------------
    mat_rows: List[dict] = []
    mat_index: Dict[str, int] = {}
    for name, obj in scene.bsdfs.items():
        mat_index[name] = len(mat_rows)
        mat_rows.append(_bsdf_row(obj))
    if not mat_rows:
        mat_rows.append(_bsdf_row(SceneObject("diffuse", "_default")))

    # --- entities: flatten transforms into one soup --------------------
    tri_v0, tri_e1, tri_e2 = [], [], []
    tri_n = ([], [], [])
    tri_uv = ([], [], [])
    tri_ent, tri_area, tri_shadow = [], [], []
    sph_center, sph_radius, sph_ent, sph_shadow = [], [], [], []
    ent_names: List[str] = []
    ent_mat, ent_light = [], []
    all_points = []
    for name, obj in scene.entities.items():
        shape_name = obj.get_string("shape")
        eid = len(ent_names)
        ent_names.append(name)
        ent_mat.append(mat_index.get(obj.get_string("bsdf"), 0))
        ent_light.append(-1)
        shadow_visible = obj.get_bool("shadow_visible", True)
        tr = obj.get_transform()
        if shape_name in analytic_spheres:
            c, r = analytic_spheres[shape_name]
            lin = tr[:3, :3]
            scale = np.abs(np.linalg.det(lin)) ** (1.0 / 3.0)
            if not np.allclose(lin, np.eye(3) * lin[0, 0], atol=1e-5):
                warnings.append(f"Entity '{name}': non-uniform sphere scale, "
                                "tessellating")
                m = meshlib.make_ico_sphere(c, r, 5)
                m.transform(tr)
                _append_mesh(m, eid, shadow_visible, tri_v0, tri_e1, tri_e2,
                             tri_n, tri_uv, tri_ent, tri_area, tri_shadow)
                all_points.append(m.vertices)
            else:
                wc = tr[:3, :3] @ np.asarray(c, np.float64) + tr[:3, 3]
                wr = r * scale
                sph_center.append(wc)
                sph_radius.append(wr)
                sph_ent.append(eid)
                sph_shadow.append(shadow_visible)
                all_points.append(wc[None] + np.array([[-wr, -wr, -wr],
                                                       [wr, wr, wr]]))
        elif shape_name in meshes:
            src = meshes[shape_name]
            m = meshlib.TriMesh(src.vertices.copy(), src.indices.copy(),
                                None if src.normals is None
                                else src.normals.copy(),
                                None if src.texcoords is None
                                else src.texcoords.copy())
            m.ensure_attributes()
            if not np.allclose(tr, np.eye(4)):
                m.transform(tr)
            _append_mesh(m, eid, shadow_visible, tri_v0, tri_e1, tri_e2,
                         tri_n, tri_uv, tri_ent, tri_area, tri_shadow)
            all_points.append(m.vertices)
        else:
            warnings.append(f"Entity '{name}': unknown shape '{shape_name}'")
        if obj.get_string("inner_medium") or obj.get_string("outer_medium"):
            raise _todo("participating media", "12")

    # --- lights ---------------------------------------------------------
    l_rows = []

    def light_row(**kw):
        row = dict(kind=int(LightKind.POINT), pos=np.zeros(3),
                   dir=np.array([0, 0, 1.0]), intensity=np.ones(3), p0=0.0,
                   p1=0.0, p2=0.0, entity=-1, tri_start=0, tri_count=0,
                   tex=-1, delta=False, infinite=False)
        row.update(kw)
        return row

    for name, obj in scene.lights.items():
        t = obj.plugin_type
        if t == "point":
            if "power" in obj.props:
                inten = _const_color(obj, "power", (4 * np.pi,) * 3) \
                    / (4 * np.pi)
            else:
                inten = _const_color(obj, "intensity", (1, 1, 1))
            l_rows.append(light_row(kind=int(LightKind.POINT),
                                    pos=obj.get_vec3("position"),
                                    intensity=inten, delta=True))
        elif t in ("env", "envmap", "environment", "uniform", "constant"):
            rad = _const_color(obj, "radiance", (1, 1, 1))
            scale = _const_color(obj, "scale", (1, 1, 1))
            l_rows.append(light_row(kind=int(LightKind.ENV),
                                    intensity=rad * scale, infinite=True))
        else:
            raise _todo(f"light type '{t}'", "7 (remaining light kinds)")

    # --- pack tables ----------------------------------------------------
    def cat(parts, width, dtype):
        if not parts:
            return np.zeros((0, width) if width else (0,), dtype)
        return np.concatenate(parts).astype(dtype)

    v0, e1, e2 = (cat(a, 3, np.float32) for a in (tri_v0, tri_e1, tri_e2))
    nrm = [cat(a, 3, np.float32) for a in tri_n]
    uvs = [cat(a, 2, np.float32) for a in tri_uv]
    t_ent = cat(tri_ent, 0, np.int32)
    t_area = cat(tri_area, 0, np.float32)
    t_shadow = cat(tri_shadow, 0, bool)
    n_tris = len(v0)
    bvh = None
    if n_tris >= BVH_THRESHOLD:
        b = build_bvh8(v0, e1, e2)
        perm = b.prim_order.astype(np.int64)
        v0, e1, e2 = v0[perm], e1[perm], e2[perm]
        nrm = [a[perm] for a in nrm]
        uvs = [a[perm] for a in uvs]
        t_ent, t_area, t_shadow = t_ent[perm], t_area[perm], t_shadow[perm]
        bvh = BVHArrays(*[torch.from_numpy(np.ascontiguousarray(a)).to(device)
                          for a in (b.cmin_x, b.cmin_y, b.cmin_z, b.cmax_x,
                                    b.cmax_y, b.cmax_z, b.child)])
    elif n_tris == 0:
        # one degenerate triangle keeps every per-triangle gather in range
        z3 = np.zeros((1, 3), np.float32)
        v0, e1, e2 = z3, z3, z3
        nrm = [z3] * 3
        uvs = [np.zeros((1, 2), np.float32)] * 3
        t_ent = np.full(1, -1, np.int32)
        t_area = np.zeros(1, np.float32)
        t_shadow = np.zeros(1, bool)

    def ten(a, dtype=None):
        a = np.ascontiguousarray(a)
        t = torch.from_numpy(a).to(device)
        return t if dtype is None else t.to(dtype)

    def soa3(a):
        a = np.asarray(a, np.float32).reshape(-1, 3)
        return Vec3(ten(a[:, 0]), ten(a[:, 1]), ten(a[:, 2]))

    def soa2(a):
        return Vec2(ten(a[:, 0]), ten(a[:, 1]))

    def scalar(v):
        return torch.tensor(float(v), dtype=torch.float32, device=device)

    tris = TriSoup(soa3(v0), soa3(e1), soa3(e2))
    attr = TriAttributes(n0=soa3(nrm[0]), n1=soa3(nrm[1]), n2=soa3(nrm[2]),
                         uv0=soa2(uvs[0]), uv1=soa2(uvs[1]),
                         uv2=soa2(uvs[2]), ent=ten(t_ent), area=ten(t_area),
                         shadow_visible=ten(t_shadow))
    spheres = SphereSoup(center=soa3(sph_center),
                         radius=ten(np.asarray(sph_radius, np.float32)))
    sph_attr = SphereAttributes(
        ent=ten(np.asarray(sph_ent, np.int32)),
        shadow_visible=ten(np.asarray(sph_shadow, bool)))
    entities = Entities(
        mat=ten(np.asarray(ent_mat or [0], np.int32)),
        light=ten(np.asarray(ent_light or [-1], np.int32)),
        med_inner=ten(np.full(max(len(ent_names), 1), -1, np.int32)),
        med_outer=ten(np.full(max(len(ent_names), 1), -1, np.int32)))

    def mcol(key, dtype=np.float32):
        return ten(np.asarray([r[key] for r in mat_rows], dtype))

    def mcolor(key):
        a = np.asarray([r[key] for r in mat_rows], np.float32).reshape(-1, 3)
        return Color(ten(a[:, 0]), ten(a[:, 1]), ten(a[:, 2]))

    materials = Materials(
        kind=mcol("kind", np.int32), base=mcolor("base"),
        extra=mcolor("extra"), extra2=mcolor("extra2"),
        **{k: mcol(k) for k in ("p0", "p1", "p2", "p3", "q0", "q1", "q2",
                                "q3", "q4", "q5", "q6", "q7", "q8")},
        **{k: mcol(k, np.int32) for k in ("base_tex", "extra_tex", "p0_tex",
                                          "p1_tex", "bump_kind",
                                          "bump_tex")},
        bump_strength=mcol("bump_strength"))

    if not l_rows:
        l_rows.append(light_row(intensity=np.zeros(3)))
        n_lights = 0
    else:
        n_lights = len(l_rows)
    lights = _pack_lights(l_rows, ten, soa3)

    media = Media(sigma_a=Color(*[ten(np.zeros(1, np.float32))] * 3),
                  sigma_s=Color(*[ten(np.zeros(1, np.float32))] * 3),
                  g=ten(np.zeros(1, np.float32)))
    envmap = EnvMap(present=ten(np.asarray(False)),
                    marginal=ten(np.zeros((1,), np.float32)),
                    conditional=ten(np.zeros((1, 1), np.float32)),
                    sat_table=ten(np.zeros((1, 1), np.float32)),
                    sat_grid=ten(np.zeros((1, 1), np.float32)))

    # --- scene bounds ---------------------------------------------------
    if all_points:
        pts = np.vstack(all_points)
        bmin, bmax = pts.min(0), pts.max(0)
    else:
        bmin, bmax = np.zeros(3), np.zeros(3)
    center = 0.5 * (bmin + bmax)
    radius = float(np.linalg.norm(bmax - bmin) * 0.5)
    if radius <= 0:
        radius = 1.0

    # --- camera ---------------------------------------------------------
    if cam_transform is not None:
        eye = cam_transform[:3, 3]
        cdir = cam_transform[:3, 2]
        cup = cam_transform[:3, 1]
    else:
        eye = np.array([0.0, 0.0, 0.0])
        cdir = np.array([0.0, 0.0, -1.0])
        cup = np.array([0.0, 1.0, 0.0])
    f32 = lambda v: float(np.float32(v))  # noqa: E731 - round like jnp.float32
    camera = CameraData(
        eye=Vec3(*[scalar(f32(v)) for v in eye]),
        dir=Vec3(*[scalar(f32(v)) for v in cdir / np.linalg.norm(cdir)]),
        up=Vec3(*[scalar(f32(v)) for v in cup / np.linalg.norm(cup)]),
        scale=Vec2(scalar(f32(sw)), scalar(f32(sh))),
        tmin=scalar(near), tmax=scalar(far),
        aperture=scalar(cam.get_number("aperture_radius", 0.0)
                        if cam else 0.0),
        focal=scalar(cam.get_number("focal_length", 1.0) if cam else 1.0))

    infinite_rows = tuple(int(i) for i, r in enumerate(l_rows)
                          if r["infinite"] and n_lights > 0)
    data = SceneData(tris=tris, tri_attr=attr, spheres=spheres,
                     sph_attr=sph_attr, entities=entities,
                     materials=materials, lights=lights, envmap=envmap,
                     camera=camera, media=media, bvh=bvh,
                     scene_radius=scalar(radius),
                     scene_center=Vec3(*[scalar(v) for v in center]))
    selector = (tech.get_string("light_selector", "uniform") or "uniform"
                ) if tech else "uniform"
    settings = RenderSettings(
        width=width, height=height, technique=tech_type,
        max_depth=max_depth, min_depth=min_depth, clamp=clamp,
        enable_nee=enable_nee,
        spi=int(overrides.get("spi", 1)), seed=int(overrides.get("seed", 0)),
        pixel_sampler=str(overrides.get("pixel_sampler", "uniform")),
        camera_type=cam_type, fish_mode=fish_mode,
        light_selector={"simple": "cdf"}.get(selector, selector),
        infinite_light_rows=infinite_rows, n_lights=n_lights,
        bsdf_kinds=tuple(sorted({int(r["kind"]) for r in mat_rows})),
        light_kinds=tuple(sorted({int(r["kind"]) for r in l_rows})))
    return BuiltScene(data=data, settings=settings, warnings=warnings)


def _pack_lights(l_rows, ten, soa3) -> Lights:
    """Light table, one row per light. The tables of the cdf and hierarchy
    selectors (select_cdf, hier_*) stay one-entry placeholders: only the
    uniform selector is on the slice (ROADMAP queue 1, item 7)."""
    def lcol(key):
        return np.asarray([r[key] for r in l_rows], np.float32)

    intensity = lcol("intensity").reshape(-1, 3)
    zero_f = ten(np.zeros(1, np.float32))
    zero_i = ten(np.zeros(1, np.int32))
    return Lights(
        kind=ten(lcol("kind").astype(np.int32)),
        pos=soa3(lcol("pos")), dir=soa3(lcol("dir")),
        intensity=Color(*[ten(intensity[:, i]) for i in range(3)]),
        p0=ten(lcol("p0")), p1=ten(lcol("p1")), p2=ten(lcol("p2")),
        entity=ten(lcol("entity").astype(np.int32)),
        tri_start=ten(lcol("tri_start").astype(np.int32)),
        tri_count=ten(lcol("tri_count").astype(np.int32)),
        tex=ten(lcol("tex").astype(np.int32)),
        delta=ten(lcol("delta").astype(bool)),
        infinite=ten(lcol("infinite").astype(bool)),
        area_tris=zero_i, area_cdf=zero_f, select_cdf=zero_f,
        hier_pos=soa3(np.zeros((1, 3), np.float32)),
        hier_dir=soa3(np.zeros((1, 3), np.float32)),
        hier_flux=zero_f, hier_has_dir=ten(np.zeros(1, bool)),
        hier_child=zero_i, hier_code=zero_i)


def _append_mesh(m: meshlib.TriMesh, eid: int, shadow_visible: bool,
                 tri_v0, tri_e1, tri_e2, tri_n, tri_uv, tri_ent, tri_area,
                 tri_shadow):
    v = m.vertices
    i = m.indices
    p0 = v[i[:, 0]]
    e1 = v[i[:, 1]] - p0
    e2 = v[i[:, 2]] - p0
    tri_v0.append(p0)
    tri_e1.append(e1)
    tri_e2.append(e2)
    for k in range(3):
        tri_n[k].append(m.normals[i[:, k]])
        tri_uv[k].append(m.texcoords[i[:, k]])
    tri_ent.append(np.full(len(i), eid, np.int32))
    tri_area.append(0.5 * np.linalg.norm(np.cross(e1, e2), axis=1))
    tri_shadow.append(np.full(len(i), shadow_visible, bool))
