"""Scene build: parsed scene graph -> SceneData tensors + RenderSettings.

The port's copy of ignis_tpu/scene/build.py, producing the port's
SceneData directly as tensors on an explicit device, without JAX.
Covered: perspective/orthogonal/fishlens cameras; every shape of the JAX
build (triangle, rectangle, cube/box, the analytic sphere, icosphere,
uvsphere, cylinder, cone, disk, the two gaussians, inline meshes and the
ply, obj, mitsuba and external mesh files; any other type is skipped with
the JAX build's warning); every BSDF (diffuse, dielectric smooth / rough /
thin, conductor, phong, plastic, principled, passthrough, transparent, the
Radiance models, the measured klems, tensortree and djmeasured, whose
tables go to SceneData.measured) and the wrappers (blend, mask, cutoff,
twosided, normalmap, bumpmap, and transform with its PExpr normal); image,
checkerboard, brick, noise-family, constant, transform and expr (PExpr)
textures; point, spot, directional, area, sun and environment lights, the
env constant, an image or a PExpr with its conditional / SAT /
hierarchical importance table, and the sky models (the CIE skies, perez
with its sun, and the Hosek-Wilkie `sky`), baked to equirect images with
the conditional table; the uniform, cdf and hierarchy light selectors and
their tables; homogeneous media, their sigmas constant or PExpr
(settings.medium_exprs), and the entities' inner and outer media. Any
colour or number property may be a PExpr string (scene/pexpr.py): a
constant one folds into the row, any other becomes a PEXPR texture, and
one that does not compile degrades with the JAX build's warning. The
scene's `parameters` become SceneData.registry, which closures read live.
Transparent shadows turn on, as in the JAX build, when a row is
passthrough, thin dielectric or Radiance. With `instancing=True` every
mesh shape that two or more entities use becomes an instance group
(ops/instanced.InstancedGeo: one local soup, with its own BVH at
BVH_THRESHOLD triangles or more, and a transform per instance). The
technique section sets the technique, its depths (ppm's
max_camera_depth spelling), NEE (off by default for aept), the debug
view, the photon count (the `photons` override, default 1,000,000), the
light depth, the merge radius and aept's learning iterations.

Rows and values follow the JAX build; the triangle order differs: scenes
with a BVH are reordered by the tri-leaf BVH8's prim_order alone (no TPU
chunk padding or clustering, area-light triangle ids remapped alike),
smaller scenes keep their load order, and the soup is not padded (an
empty scene gets one degenerate triangle).
"""
from __future__ import annotations

import datetime
import math
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from ..bvh.builder import build_bvh8
from ..core import cdf as cdflib
from ..core.vec import Color, Vec2, Vec3
from ..models import texture as texlib
from ..models.bsdf import BLEND_MAX_DEPTH, ROUGH_FLAG, THIN_FLAG, BsdfKind
from ..models.light import LightKind
from ..ops.bvh import BVHArrays
from ..ops.instanced import InstancedGeo
from ..ops.intersect import SphereSoup, TriSoup
from ..scenedata import (CameraData, Entities, EnvMap, Lights, Materials,
                         Media, RenderSettings, SceneData, SphereAttributes,
                         TriAttributes)
from . import mesh as meshlib
from .parser import Scene, SceneObject

# A triangle count carried over from the JAX package (scene/build.py:1305,
# measured there on a TPU); the card's crossover is near 82 (PERF.md).
BVH_THRESHOLD = 512

DIELECTRIC_IOR = {
    "vacuum": 1.0, "air": 1.000277, "water": 1.3330, "ice": 1.31,
    "bk7": 1.5046, "glass": 1.5046, "fused_quartz": 1.458,
    "sapphire": 1.77, "diamond": 2.419, "polypropylene": 1.49,
    "ethanol": 1.361, "pet": 1.5750, "acrylic_glass": 1.49,
}

# Conductor (eta, k) per channel (public tabulated values)
CONDUCTOR_SPECTRA = {
    "gold": ((0.143085, 0.374852, 1.44208), (3.98205, 2.38506, 1.60276)),
    "au": ((0.143085, 0.374852, 1.44208), (3.98205, 2.38506, 1.60276)),
    "silver": ((0.15522, 0.116692, 0.138342), (4.81810, 3.12313, 2.14628)),
    "ag": ((0.15522, 0.116692, 0.138342), (4.81810, 3.12313, 2.14628)),
    "aluminum": ((1.34560, 0.96521, 0.61722), (7.47460, 6.39950, 5.30310)),
    "al": ((1.34560, 0.96521, 0.61722), (7.47460, 6.39950, 5.30310)),
    "copper": ((0.200438, 0.924033, 1.10221), (3.91295, 2.44763, 2.14219)),
    "cu": ((0.200438, 0.924033, 1.10221), (3.91295, 2.44763, 2.14219)),
    "none": ((0.0, 0.0, 0.0), (1.0, 1.0, 1.0)),  # perfect mirror
}

_CIE_SKIES = ("cie_uniform", "cieuniform", "cie_cloudy", "ciecloudy",
              "cie_clear", "cieclear", "cie_intermediate", "cieintermediate")


@dataclass
class BuiltScene:
    data: SceneData
    settings: RenderSettings
    warnings: List[str] = field(default_factory=list)


def _const_color(obj: SceneObject, key, default, texreg, warnings):
    """A colour property that must be constant: a PExpr string folds to
    its constant value, or, where it is not constant, the default with a
    warning."""
    v = obj.get_color(key, default)
    if isinstance(v, str):
        c = texreg.eval_constant_color(v)
        if c is not None:
            return c
        warnings.append(f"'{obj.name}': non-constant {key} '{v}', using "
                        "its default")
        return np.asarray(default, np.float64)
    return np.asarray(v, np.float64)


def _as_color_const(v, default):
    if v is None:
        return np.asarray(default, np.float64)
    if isinstance(v, str):
        return None
    if isinstance(v, (int, float)):
        return np.full(3, float(v))
    return np.asarray(v, np.float64)


def _prop_number(obj: SceneObject, key, default, texreg):
    """A number property that may be a PExpr string, folded by
    evaluating it at one lane (ignis_tpu/scene/build.py:1730); the
    default where it does not evaluate."""
    v = obj.get(key, default)
    if isinstance(v, str):
        c = texreg.eval_constant_number(v)
        return default if c is None else c
    return float(v)


def _dry_ctx():
    """The one-lane CPU context of resolve_color's load-time dry run
    (texture lookups answer with the uv)."""
    z = torch.zeros((1,))
    return texlib.make_shade_ctx(
        Vec2(z, z), textures=lambda tid, uv: (uv[0], uv[1], uv[0]))


def _probe_ctx(u, point):
    """eval_constant_color's probe at uv (u, 1 - u) and `point`, which
    serves as the normal too; texture lookups answer (u, v, u)."""
    z = torch.full((1,), u)
    p = tuple(torch.full((1,), c) for c in point)
    return texlib.make_shade_ctx(
        Vec2(z, 1.0 - z), point=p, normal=p,
        textures=lambda tid, uv: (uv[0], uv[1], uv[0] * 0 + u))


class TextureRegistry:
    """Named texture nodes and PExpr compilation (the ShadingTree): a
    string colour or number property resolves to a texture by name, or
    to an implicit PEXPR texture compiled on demand; an expression that
    does not compile or evaluate degrades to -1 with a warning, as the
    JAX build does (ErrorBSDF-style, reference LoaderBSDF.cpp:36-49).
    `measured` collects the measured BSDFs' tables (SceneData.measured)."""

    def __init__(self, warnings: List[str], parameters=None, device="cpu"):
        self.descs: List = []
        self.datas: List = []
        self.name_to_tex: Dict[str, int] = {}
        self.images: Dict[str, np.ndarray] = {}
        self.measured: List = []
        self.warnings = warnings
        self.parameters = parameters or {}
        self.device = device
        self._pexpr_cache: Dict[str, int] = {}

    def _compiler(self):
        from .pexpr import Compiler
        params = {}
        for name, p in self.parameters.items():
            if isinstance(p, dict):
                ptype = p.get("type", "number")
                val = p.get("value", 0)
            else:
                ptype, val = "number", p
            if ptype in ("number", "num", "int"):
                params[name] = ("num", float(val))
            elif ptype == "vector":
                params[name] = ("vec3", tuple(float(x) for x in val))
            else:
                v = list(val) + [1.0]
                params[name] = ("vec4", tuple(float(x) for x in v[:4]))
        return Compiler(self.name_to_tex, params)

    def add(self, name, desc, data) -> int:
        self.descs.append(desc)
        self.datas.append(data)
        if name:
            self.name_to_tex[name] = len(self.descs) - 1
        return len(self.descs) - 1

    def pexpr_texture(self, fn) -> tuple:
        d, a = texlib.make_procedural(texlib.TexKind.PEXPR, (0, 0, 0),
                                      (1, 1, 1), device=self.device)
        return d._replace(fn=fn), a

    def resolve_color(self, s: str, what: str) -> int:
        """A texture name or PExpr string -> texture id (-1 on failure)."""
        if s in self.name_to_tex:
            return self.name_to_tex[s]
        if s in self._pexpr_cache:
            return self._pexpr_cache[s]
        try:
            fn = self._compiler().compile_color(s)
            # a dry run on one lane, so that unknown variables and arity
            # errors surface at load time
            fn(_dry_ctx())
            tid = self.add(None, *self.pexpr_texture(fn))
            self._pexpr_cache[s] = tid
            return tid
        except Exception as e:
            self.warnings.append(f"{what}: PExpr error: {e}")
            return -1

    def eval_constant_color(self, s: str):
        """The rgb of a spatially constant PExpr (the exporters'
        "color(r,g,b,a)" literals), else None. Expressions that read a
        declared parameter (live in the registry) or a spatial input are
        never folded; the others are probed at two points."""
        toks = set(re.findall(r"[A-Za-z_]\w*", s))
        if toks & set(self.parameters):
            return None
        if toks & {"uv", "uvw", "P", "N", "Np", "Ng", "V"}:
            return None
        try:
            fn = self._compiler().compile_color(s)

            def at(u, point):
                r, g, b = fn(_probe_ctx(u, point))
                return np.array([float(r[0]), float(g[0]), float(b[0])])
            a = at(0.13, (0.4, -1.2, 2.0))
            b = at(0.77, (-0.9, 0.3, -0.5))
            if np.allclose(a, b, atol=1e-6) and np.isfinite(a).all():
                return a
            return None
        except Exception:
            return None

    def eval_constant_number(self, s: str):
        """A PExpr evaluated at one lane of zeros, or None."""
        try:
            fn = self._compiler().compile_number(s)
            z = torch.zeros((1,), dtype=torch.float32)
            return float(fn(texlib.make_shade_ctx(Vec2(z, z)))[0])
        except Exception:
            return None


def _shape_to_mesh(obj: SceneObject,
                   warnings: List[str]) -> Optional[meshlib.TriMesh]:
    """The mesh of a shape object (ignis_tpu/scene/build.py:227-346), with
    the same defaults; None, with a warning, for an unknown type. Mesh
    files are parsed at every load (no cache). `sphere` never gets here:
    build_scene keeps it analytic."""
    t = obj.plugin_type
    p = obj
    if t == "triangle":
        m = meshlib.make_triangle(p.get_vec3("p0", (0, 0, 0)),
                                  p.get_vec3("p1", (1, 0, 0)),
                                  p.get_vec3("p2", (0, 1, 0)))
    elif t == "rectangle":
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
    elif t in ("cube", "box"):
        w = p.get_number("width", 2.0)
        h = p.get_number("height", 2.0)
        d = p.get_number("depth", 2.0)
        origin = p.get_vec3("origin", (-w / 2, -h / 2, -d / 2))
        m = meshlib.make_box(origin, np.array([w, 0, 0]), np.array([0, h, 0]),
                             np.array([0, 0, d]))
    elif t == "icosphere":
        m = meshlib.make_ico_sphere(p.get_vec3("center"),
                                    p.get_number("radius", 1.0),
                                    p.get_int("subdivisions", 4))
    elif t == "uvsphere":
        m = meshlib.make_uv_sphere(p.get_vec3("center"),
                                   p.get_number("radius", 1.0),
                                   p.get_int("stacks", 32),
                                   p.get_int("slices", 16))
    elif t == "cylinder":
        if "radius" in p.props:
            br = tr = p.get_number("radius", 1.0)
        else:
            br = p.get_number("bottom_radius", 1.0)
            tr = p.get_number("top_radius", br)
        m = meshlib.make_cylinder(p.get_vec3("p0"), br,
                                  p.get_vec3("p1", (0, 0, 1)), tr,
                                  p.get_int("sections", 32),
                                  p.get_bool("filled", True))
    elif t == "cone":
        m = meshlib.make_cone(p.get_vec3("p0"), p.get_number("radius", 1.0),
                              p.get_vec3("p1", (0, 0, 1)),
                              p.get_int("sections", 32),
                              p.get_bool("filled", True))
    elif t == "disk":
        m = meshlib.make_disk(p.get_vec3("origin"),
                              p.get_vec3("normal", (0, 0, 1)),
                              p.get_number("radius", 1.0),
                              p.get_int("sections", 32))
    elif t == "gauss":
        m = meshlib.make_radial_gaussian(
            p.get_vec3("origin"),
            np.asarray(p.get_vec3("normal", (0, 0, 1)), np.float64)
            * p.get_number("height", 1.0),
            p.get_number("sigma", 1.0), p.get_number("radius_scale", 1.0),
            p.get_int("sections", 32), p.get_int("slices", 16))
    elif t == "gauss_lobe":
        st = p.get_number("sigma_theta", 1.0)
        sp = p.get_number("sigma_phi", 1.0)
        an = p.get_number("anisotropy", 0.0)
        cov = [[st * st, an * st * sp], [an * st * sp, sp * sp]]
        m = meshlib.make_gaussian_lobe(
            p.get_vec3("origin"), p.get_vec3("direction", (0, 0, 1)),
            p.get_vec3("x_axis", (1, 0, 0)), p.get_vec3("y_axis", (0, 1, 0)),
            cov, p.get_int("theta_size", 64), p.get_int("phi_size", 128),
            p.get_number("scale", 1.0))
    elif t == "mitsuba":
        m = meshlib.load_mts_serialized(p.path("filename"),
                                        p.get_int("shape_index", 0))
    elif t == "obj":
        m = meshlib.load_obj(p.path("filename"), p.get_int("shape_index", -1))
    elif t == "ply":
        m = meshlib.load_ply(p.path("filename"))
    elif t == "external":
        m = meshlib.load_mesh_file(p.path("filename"))
    elif t == "inline":
        verts = np.asarray(p.get("vertices", []), np.float32).reshape(-1, 3)
        idx = np.asarray(p.get("indices", []), np.int32).reshape(-1, 3)
        norms = p.get("normals")
        uvs = p.get("texcoords")
        m = meshlib.TriMesh(
            verts, idx,
            np.asarray(norms, np.float32).reshape(-1, 3) if norms else None,
            np.asarray(uvs, np.float32).reshape(-1, 2) if uvs else None)
    else:
        warnings.append(f"Unsupported shape type '{t}', skipping")
        return None
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


def _roughness_uv(obj: SceneObject, texreg):
    """BSDF::setupRoughness: 'roughness' / 'alpha' (+ _u/_v) and
    'anisotropic'; alpha == roughness; no property means delta."""
    name = "alpha" if ("alpha" in obj.props or "alpha_u" in obj.props
                       or "alpha_v" in obj.props) else "roughness"
    if name + "_u" in obj.props or name + "_v" in obj.props:
        ru = _prop_number(obj, name + "_u", 0.1, texreg)
        return ru, _prop_number(obj, name + "_v", ru, texreg)
    if name not in obj.props:
        return 0.0, 0.0
    r = _prop_number(obj, name, 0.1, texreg)
    aniso = _prop_number(obj, "anisotropic", 0.0, texreg)
    aspect = math.sqrt(1.0 - min(max(aniso, 0.0), 1.0) * 0.99)
    return r / aspect, r * aspect


def _measured_row(obj: SceneObject, texreg: TextureRegistry, row: dict,
                  kind: BsdfKind, warnings: List[str], col) -> None:
    """A klems, tensortree or djmeasured row: its table loaded onto the
    device and appended to texreg.measured, q6 its index; a file that
    fails to load gives an error row with a warning."""
    from ..models import djmeasured as djmodel
    from ..models import klems as klemsmodel
    from ..models import tensortree as ttmodel
    from . import djmeasured, klems, tensortree
    t = obj.plugin_type
    try:
        if kind == BsdfKind.KLEMS:
            data = klemsmodel.from_numpy(klems.load_klems(obj.path(
                "filename")), texreg.device)
        elif kind == BsdfKind.TENSORTREE:
            # peakExtraction (default true, TensorTreeBSDF.cpp:67)
            data = ttmodel.from_numpy(
                tensortree.load_tensortree(obj.path("filename")),
                use_peak=obj.get_bool("peakExtraction", True),
                device=texreg.device)
        else:
            data = djmodel.from_numpy(djmeasured.load_djmeasured(obj.path(
                "filename")), texreg.device)
        row["kind"] = int(kind)
        row["q6"] = float(len(texreg.measured))
        texreg.measured.append(data)
        if kind == BsdfKind.DJMEASURED:
            col("tint", (1, 1, 1))
        else:
            col("base_color", (1, 1, 1))
            up = np.asarray(obj.get_vec3("up", (0, 0, 1)), np.float64)
            row["extra2"] = up / max(np.linalg.norm(up), 1e-9)
    except Exception as e:
        warnings.append(f"BSDF '{obj.name}': {t} load failed: {e}")
        row["kind"] = int(BsdfKind.NULL_ERROR)


def _bsdf_row(obj: SceneObject, texreg: TextureRegistry,
              warnings: List[str]) -> dict:
    """Translate a BSDF scene object into a Materials row dict
    (ignis_tpu/scene/build.py:350-619)."""
    t = obj.plugin_type
    row = dict(kind=int(BsdfKind.DIFFUSE),
               base=np.array([0.8, 0.8, 0.8]), extra=np.zeros(3),
               extra2=np.zeros(3), p0=0.0, p1=0.0, p2=0.0, p3=0.0,
               q0=0.0, q1=0.0, q2=0.0, q3=0.0, q4=0.0, q5=0.0,
               q6=0.0, q7=0.0, q8=0.0,
               base_tex=-1, extra_tex=-1, p0_tex=-1, p1_tex=-1,
               bump_kind=0, bump_tex=-1, bump_strength=1.0)

    def col(key, default, slot="base", tex_slot="base_tex"):
        v = obj.get_color(key, default)
        if isinstance(v, str):
            const = texreg.eval_constant_color(v)
            if const is not None:
                row[slot] = const
                return
            tid = texreg.resolve_color(v, f"BSDF '{obj.name}' {key}")
            row[tex_slot] = tid
            if tid < 0:
                warnings.append(f"BSDF '{obj.name}': unresolved '{v}'")
            row[slot] = np.asarray(default, np.float64)
        else:
            row[slot] = v

    def ior(key, default_name):
        s = obj.get_string(key + "_material")
        if s and s.lower() in DIELECTRIC_IOR:
            return DIELECTRIC_IOR[s.lower()]
        v = obj.get(key)
        if isinstance(v, str):
            c = texreg.eval_constant_number(v)
            if c is not None:
                return c
            warnings.append(f"BSDF '{obj.name}': non-constant ior '{v}'")
            return DIELECTRIC_IOR[default_name]
        return obj.get_number(key, DIELECTRIC_IOR[default_name])

    def weight(key, default, what):
        w = obj.get(key, default)
        if isinstance(w, str):
            row["p0_tex"] = texreg.resolve_color(w, f"BSDF '{obj.name}' "
                                                 f"{what}")
            return default
        return float(w)

    def const_color(key, default):
        return _const_color(obj, key, default, texreg, warnings)

    if t in ("diffuse", "roughdiffuse"):
        col("reflectance", (0.8, 0.8, 0.8))
        row["p1"] = obj.get_number("roughness", 0.0)
    elif t in ("dielectric", "glass", "roughdielectric", "thindielectric"):
        row["kind"] = int(BsdfKind.DIELECTRIC)
        col("specular_reflectance", (1, 1, 1), "base", "base_tex")
        col("specular_transmittance", (1, 1, 1), "extra", "extra_tex")
        row["p0"] = ior("ext_ior", "vacuum")
        row["p1"] = ior("int_ior", "bk7")
        row["p2"] = _roughness_uv(obj, texreg)[0]
        row["p3"] = 1.0 if (t == "thindielectric"
                            or obj.get_bool("thin", False)) else 0.0
    elif t in ("conductor", "roughconductor", "mirror", "perfect_mirror"):
        row["kind"] = int(BsdfKind.CONDUCTOR)
        col("specular_reflectance", (1, 1, 1), "base", "base_tex")
        mat = obj.get_string("material", "none")
        eta_k = CONDUCTOR_SPECTRA.get(mat.lower(), CONDUCTOR_SPECTRA["none"])
        row["extra"] = const_color("eta", eta_k[0])
        row["extra2"] = const_color("k", eta_k[1])
        row["p2"], row["p3"] = _roughness_uv(obj, texreg)
    elif t == "phong":
        row["kind"] = int(BsdfKind.PHONG)
        col("specular_reflectance", (0.2, 0.2, 0.2))
        row["p0"] = obj.get_number("exponent", 30.0)
    elif t in ("plastic", "roughplastic"):
        row["kind"] = int(BsdfKind.PLASTIC)
        col("diffuse_reflectance", (0.5, 0.5, 0.5))
        col("specular_reflectance", (1, 1, 1), "extra", "extra_tex")
        row["p0"] = ior("ext_ior", "vacuum")
        row["p1"] = ior("int_ior", "bk7")
        row["p2"] = _roughness_uv(obj, texreg)[0]
    elif t == "principled":
        row["kind"] = int(BsdfKind.PRINCIPLED)
        col("base_color", (0.8, 0.8, 0.8))

        def num(key, default):
            return _prop_number(obj, key, default, texreg)
        i = num("ior", DIELECTRIC_IOR["bk7"])
        row["p0"] = num("reflective_ior", i)
        row["p1"] = num("refractive_ior", i)
        if "roughness_u" in obj.props or "roughness_v" in obj.props:
            ru = num("roughness_u", 0.5)
            rv = num("roughness_v", ru)
        else:
            r = num("roughness", 0.5)
            aniso = num("anisotropic", 0.0)
            aspect = math.sqrt(1.0 - min(max(aniso, 0.0), 1.0) * 0.99)
            ru, rv = r / aspect, r * aspect
        row["p2"], row["p3"] = ru, rv
        for q, key, default in (
                ("q0", "metallic", 0.0), ("q1", "specular_transmission", 0.0),
                ("q2", "specular_tint", 0.0), ("q3", "sheen", 0.0),
                ("q4", "sheen_tint", 0.0), ("q5", "clearcoat", 0.0),
                ("q6", "clearcoat_gloss", 0.0),
                ("q7", "clearcoat_roughness", 0.1)):
            row[q] = num(key, default)
        row["extra2"] = np.array([
            num("flatness", 0.0), num("diffuse_transmission", 0.0),
            1.0 if obj.get_bool("thin", False) else 0.0])
    elif t in ("passthrough", "null"):
        row["kind"] = int(BsdfKind.PASSTHROUGH)
        row["base"] = np.ones(3)
    elif t in ("transparent", "ignore"):
        # tinted delta transmission (TransparentBSDF.cpp:16-20)
        row["kind"] = int(BsdfKind.PASSTHROUGH)
        col("color", (1, 1, 1))
    elif t in ("blend", "mix", "add"):
        # children resolved once every BSDF is registered (BlendBSDF.cpp)
        row["kind"] = int(BsdfKind.BLEND)
        row["_children"] = (obj.get_string("first", obj.get_string("bsdf1")),
                            obj.get_string("second",
                                           obj.get_string("bsdf2")))
        row["p0"] = weight("weight", 0.5, "weight")
    elif t in ("mask", "cutoff"):
        # mask = blend(passthrough, inner, opacity) (MaskBSDF.cpp)
        row["kind"] = int(BsdfKind.BLEND)
        row["_children"] = ("__passthrough__", obj.get_string("bsdf"))
        row["p0"] = weight("opacity", 1.0, "opacity")
        if t == "cutoff":
            row["p1"] = _prop_number(obj, "threshold", 0.5, texreg)
            row["p2"] = 1.0   # cutoff flag: the weight is thresholded
    elif t in ("twosided", "doublesided"):
        # frames always face the ray, so the inner row is two-sided already
        row["_alias"] = obj.get_string("bsdf")
    elif t == "transform":
        # the normal override (TransformBSDF.cpp:20-44): a PExpr vec3 per
        # shading point in world space, such as the Cycles exporter's
        # ensure_valid_reflection(Ng, V, bump(...)) chains; applied in
        # techniques/path.apply_normal_map as bump kind 3
        row["_alias"] = obj.get_string("bsdf")
        nexpr = obj.get("normal")
        if isinstance(nexpr, str):
            tid = texreg.resolve_color(nexpr, f"BSDF '{obj.name}' normal")
        elif nexpr is not None:
            v = np.asarray(nexpr, np.float64).reshape(-1)[:3]
            tid = texreg.resolve_color(
                f"vec3({v[0]!r}, {v[1]!r}, {v[2]!r})",
                f"BSDF '{obj.name}' normal")
        else:
            tid = -1
        if tid >= 0:
            row["bump_kind"] = 3
            row["bump_tex"] = tid
        if "tangent" in obj.props:
            warnings.append(f"BSDF '{obj.name}': transform tangent "
                            "override not supported; using normal only")
    elif t in ("map", "normalmap", "bumpmap"):
        # normal / bump map over the inner row (MapBSDF.cpp), applied per
        # hit in techniques/path.apply_normal_map
        row["_alias"] = obj.get_string("bsdf")
        row["bump_kind"] = 2 if t == "bumpmap" else 1
        m = obj.get("map", obj.get("texture"))
        if isinstance(m, str):
            row["bump_tex"] = texreg.resolve_color(m, f"BSDF '{obj.name}' "
                                                   "map")
        else:
            row["bump_kind"] = 0  # a constant map perturbs nothing
        row["bump_strength"] = obj.get_number("strength", 1.0)
    elif t in ("rad_brtdfunc", "rad_roos"):
        # Radiance compliance models (RadBRTDFuncBSDF.cpp / RadRoosBSDF.cpp)
        def cc(key, default):
            v = obj.get_color(key, default)
            if isinstance(v, str):
                c = texreg.eval_constant_number(v)
                if c is not None:
                    return np.full(3, float(c))
                warnings.append(f"BSDF '{obj.name}': non-constant {key}")
                return np.asarray(default, np.float64)
            return np.asarray(v, np.float64)
        dir_diff = cc("direct_diffuse", (0, 0, 0))
        front = cc("reflection_front_diffuse", (0, 0, 0)) + dir_diff
        back = cc("reflection_back_diffuse", (0, 0, 0)) + dir_diff
        row["extra2"] = cc("transmission_diffuse", (0, 0, 0))
        row["q0"], row["q1"], row["q2"] = front.tolist()
        row["q3"], row["q4"], row["q5"] = back.tolist()
        if t == "rad_brtdfunc":
            row["kind"] = int(BsdfKind.RAD_BRTDF)
            row["base"] = cc("reflection_specular", (1, 1, 1))
            row["extra"] = cc("transmission_specular", (0, 0, 0))
        else:
            row["kind"] = int(BsdfKind.RAD_ROOS)
            row["base"] = np.array([obj.get_number("trns_" + c, 0.0)
                                    for c in "wpq"])
            row["extra"] = np.array([obj.get_number("refl_" + c, 0.0)
                                     for c in "wpq"])
    elif t == "klems":
        # measured Klems BSDF (KlemsBSDF.cpp): XML -> 4 scattering matrices
        _measured_row(obj, texreg, row, BsdfKind.KLEMS, warnings, col)
    elif t == "tensortree":
        # measured tensor-tree BSDF (TensorTreeBSDF.cpp), baked to dense
        # grids at load (scene/tensortree.py)
        _measured_row(obj, texreg, row, BsdfKind.TENSORTREE, warnings, col)
    elif t == "djmeasured":
        # Dupuy-Jakob measured BRDF (DJMeasuredBSDF.cpp); a powitacq tensor
        # file baked to per-theta_i tables (scene/djmeasured.py)
        _measured_row(obj, texreg, row, BsdfKind.DJMEASURED, warnings, col)
    else:
        warnings.append(f"Unsupported BSDF type '{t}' -> error bsdf")
        row["kind"] = int(BsdfKind.NULL_ERROR)
    return row


def _resolve_wrappers(mat_rows: List[dict], mat_index: Dict[str, int],
                      texreg: TextureRegistry, warnings: List[str]) -> bool:
    """Resolve aliases (twosided, maps) and blend children once every row
    exists; returns whether the scene has a blend."""
    def passthrough_row():
        for i, r in enumerate(mat_rows):
            if r["kind"] == int(BsdfKind.PASSTHROUGH):
                return i
        mat_rows.append(_bsdf_row(SceneObject("passthrough",
                                              "__passthrough__"), texreg,
                                  texreg.warnings))
        return len(mat_rows) - 1

    def depth_of(idx, seen=()):
        if idx in seen or mat_rows[idx]["kind"] != int(BsdfKind.BLEND):
            return 0
        return 1 + max(depth_of(int(mat_rows[idx].get(q, 0)), seen + (idx,))
                       for q in ("q0", "q1"))

    has_blend = False
    for i, r in enumerate(list(mat_rows)):
        if "_alias" in r:
            inner = mat_index.get(r.pop("_alias"))
            if inner is not None:
                alias = dict(mat_rows[inner])
                for k in ("_children", "_alias", "bump_kind", "bump_tex",
                          "bump_strength"):
                    alias.pop(k, None)   # the wrapper's map survives
                mat_rows[i].update(alias)
            else:
                warnings.append("twosided/map: unknown inner bsdf")
        if "_children" in r:
            has_blend = True
            a_name, b_name = r.pop("_children")
            a = (passthrough_row() if a_name == "__passthrough__"
                 else mat_index.get(a_name, 0))
            b = mat_index.get(b_name, 0)
            if max(depth_of(a), depth_of(b)) >= BLEND_MAX_DEPTH:
                warnings.append(
                    f"blend '{a_name}'/'{b_name}' nesting exceeds "
                    f"BLEND_MAX_DEPTH={BLEND_MAX_DEPTH}; deepest children "
                    "degrade to their first leaf")
            mat_rows[i]["q0"] = float(a)
            mat_rows[i]["q1"] = float(b)
    return has_blend


def _load_textures(scene: Scene, texreg: TextureRegistry, device, overrides,
                   warnings: List[str]) -> None:
    """Texture nodes in file order (ignis_tpu/scene/build.py:715-800); a
    node that fails to load becomes magenta with a warning, as there."""
    from ..utils.image import load_image

    def wrap_of(s):
        return {"repeat": texlib.WrapMode.REPEAT,
                "mirror": texlib.WrapMode.MIRROR,
                "clamp": texlib.WrapMode.CLAMP}.get(s, texlib.WrapMode.REPEAT)

    def proc(*args, **kw):
        return texlib.make_procedural(*args, device=device, **kw)

    for name, obj in scene.textures.items():
        t = obj.plugin_type
        try:
            if t in ("expr", "pexpr"):
                src = obj.get_string("expr", obj.get_string("value", "1"))
                d, a = texreg.pexpr_texture(
                    texreg._compiler().compile_color(src))
            elif t in ("image", "bitmap"):
                tex_path = obj.path("filename")
                sub = (overrides.get("texture_substitutes") or {}).get(
                    Path(str(tex_path)).name)
                if sub is not None and not Path(str(tex_path)).exists():
                    warnings.append(f"Texture '{name}': missing asset "
                                    f"{Path(str(tex_path)).name} substituted "
                                    f"by {sub}")
                    tex_path = sub
                img = load_image(tex_path,
                                 linear=obj.get_bool("linear", False))
                texreg.images[name] = img
                filt = {"nearest": texlib.FilterMode.NEAREST,
                        "bilinear": texlib.FilterMode.BILINEAR}.get(
                    obj.get_string("filter_type", "bicubic"),
                    texlib.FilterMode.BICUBIC)
                wrap = obj.get_string("wrap_mode", "repeat")
                d, a = texlib.make_image_texture(
                    img, wrap_of(obj.get_string("wrap_mode_u", wrap)),
                    wrap_of(obj.get_string("wrap_mode_v", wrap)), filt,
                    obj.get_transform()[:2, (0, 1, 3)], device=device)
            elif t == "checkerboard":
                d, a = proc(texlib.TexKind.CHECKERBOARD,
                            _as_color_const(obj.get("color0"), (0, 0, 0)),
                            _as_color_const(obj.get("color1"), (1, 1, 1)),
                            obj.get_number("scale_x", 2.0),
                            obj.get_number("scale_y", 2.0))
            elif t in ("noise", "pnoise", "perlin", "fbm", "voronoi",
                       "cellnoise"):
                kind = {"noise": texlib.TexKind.NOISE,
                        "pnoise": texlib.TexKind.PERLIN,
                        "perlin": texlib.TexKind.PERLIN,
                        "fbm": texlib.TexKind.FBM,
                        "voronoi": texlib.TexKind.VORONOI,
                        "cellnoise": texlib.TexKind.CELLNOISE}[t]
                d, a = proc(kind,
                            _as_color_const(obj.get("color0"), (0, 0, 0)),
                            _as_color_const(obj.get("color1"), (1, 1, 1)),
                            obj.get_number("scale", 20.0))
            elif t == "brick":
                # BrickPattern.cpp defaults: scale (3, 6), gap (0.05, 0.1)
                d, a = proc(texlib.TexKind.BRICK,
                            _as_color_const(obj.get("color0"), (0, 0, 0)),
                            _as_color_const(obj.get("color1"), (1, 1, 1)),
                            obj.get_number("scale_x", 3.0),
                            obj.get_number("scale_y", 6.0),
                            obj.get_transform()[:2, (0, 1, 3)],
                            obj.get_number("gap_x", 0.05),
                            obj.get_number("gap_y", 0.1))
            elif t == "transform":
                inner_name = obj.get_string("texture", "")
                inner_id = texreg.name_to_tex.get(inner_name, -1)
                if inner_id < 0:
                    warnings.append(f"Texture '{name}': transform of unknown "
                                    f"texture '{inner_name}' (define it "
                                    "first); using white")
                    d, a = proc(texlib.TexKind.CONSTANT, (1, 1, 1),
                                (1, 1, 1))
                else:
                    d, a = proc(texlib.TexKind.TRANSFORM, (0, 0, 0),
                                (1, 1, 1),
                                transform=obj.get_transform()[:2, (0, 1, 3)],
                                inner=inner_id)
            elif t == "constant":
                d, a = proc(texlib.TexKind.CONSTANT,
                            _as_color_const(obj.get("color"), (1, 1, 1)),
                            (1, 1, 1))
            else:
                warnings.append(f"Texture '{name}': type '{t}' TODO, using "
                                "white")
                d, a = proc(texlib.TexKind.CONSTANT, (1, 1, 1), (1, 1, 1))
        except Exception as e:  # a missing file, a PExpr error etc.
            warnings.append(f"Texture '{name}': {e}; using magenta")
            d, a = proc(texlib.TexKind.CONSTANT, (1, 0, 1), (1, 0, 1))
        texreg.add(name, d, a)


def _light_direction(obj: SceneObject) -> np.ndarray:
    """LoaderUtils::getDirection: direction | sun_direction |
    elevation/azimuth | sun position from date, time and place (Y up)."""
    from ..models.skysun import compute_sun_ea, ea_to_direction_yup
    if "direction" in obj.props:
        d = obj.get_vec3("direction", (0, 0, 1))
    elif "sun_direction" in obj.props:
        d = obj.get_vec3("sun_direction", (0, 0, 1))
    elif "elevation" in obj.props or "azimuth" in obj.props:
        d = ea_to_direction_yup(obj.get_number("elevation", 0.0),
                                obj.get_number("azimuth", 0.0))
    else:
        el, az = compute_sun_ea(
            obj.get_int("year", 2020), obj.get_int("month", 5),
            obj.get_int("day", 6), obj.get_int("hour", 12),
            obj.get_int("minute", 0), obj.get_number("seconds", 0.0),
            obj.get_number("latitude", 49.235422),
            obj.get_number("longitude", -6.9965744),
            obj.get_number("timezone", -2.0))
        d = ea_to_direction_yup(el, az)
    n = np.linalg.norm(d)
    return d / n if n > 0 else np.array([0, 0, 1.0])


def _build_env_cdf(img: np.ndarray, compensate: bool, method: str,
                   device) -> EnvMap:
    """The env importance tables (CDF::computeForImage / LoaderUtils
    setup_cdf2d{,_sat,_hierachical}): row-luminance weights premultiplied
    by sin(theta), optional MIS compensation, rows flipped so row 0 is
    v = 0 (the bottom)."""
    w = np.maximum(img, 0.0).mean(axis=-1)
    defect = 0.0
    if compensate:
        d = float(w.mean())
        if abs(float(w.min()) - d) >= 1e-4:
            defect = d
    w = np.maximum(w - defect, 0.0)[::-1]
    h = w.shape[0]
    sin_theta = np.sin(np.pi * (np.arange(h) + 0.5) / h)[:, None]
    weights = (w * sin_theta).astype(np.float32)
    zero1 = torch.zeros((1,), dtype=torch.float32, device=device)
    zero2 = torch.zeros((1, 1), dtype=torch.float32, device=device)
    present = torch.tensor(True, device=device)
    if method == "sat":
        sat = cdflib.build_sat_2d(weights, device)
        return EnvMap(present, zero1, zero2, sat.table, sat.grid)
    if method in ("hierachical", "hierarchical"):
        return EnvMap(present, zero1, zero2, zero2, zero2,
                      cdflib.build_hier_2d(weights, device).levels)
    c = cdflib.build_cdf_2d(weights, device)
    return EnvMap(present, c.marginal, c.conditional, zero2, zero2)


def build_scene(scene: Scene, device, overrides: Optional[dict] = None
                ) -> BuiltScene:
    device = torch.device(device)
    warnings: List[str] = []
    overrides = overrides or {}

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
    # aept turns NEE off by default (AdaptiveEnvPathTechnique.cpp:18)
    enable_nee = (tech.get_bool("nee", tech_type not in ("aept",
                                                          "adaptive_env"))
                  if tech else True)

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
        else:
            m = _shape_to_mesh(obj, warnings)
            if m is not None:
                meshes[name] = m

    # --- textures and materials ----------------------------------------
    texreg = TextureRegistry(warnings, scene.parameters, device)
    _load_textures(scene, texreg, device, overrides, warnings)
    mat_rows: List[dict] = []
    mat_index: Dict[str, int] = {}
    for name, obj in scene.bsdfs.items():
        mat_index[name] = len(mat_rows)
        mat_rows.append(_bsdf_row(obj, texreg, warnings))
    if not mat_rows:
        mat_rows.append(_bsdf_row(SceneObject("diffuse", "_default"),
                                  texreg, warnings))
    has_blend = _resolve_wrappers(mat_rows, mat_index, texreg, warnings)

    # --- media (ignis_tpu/scene/build.py:867-889): homogeneous constants,
    # or PExpr sigmas evaluated where a lane enters the medium
    med_rows = []
    med_exprs: List = []
    med_index: Dict[str, int] = {}
    for name, obj in scene.media.items():
        med_index[name] = len(med_rows)
        sigmas, fns = [], []
        for key in ("sigma_a", "sigma_s"):
            c = _as_color_const(obj.get(key), (0, 0, 0))
            fn = None
            if c is None:
                try:
                    fn = texreg._compiler().compile_color(
                        obj.get_string(key))
                except Exception as e:
                    warnings.append(f"Medium '{name}' {key}: {e}")
                c = np.zeros(3)
            sigmas.append(c)
            fns.append(fn)
        med_exprs.append(tuple(fns) if any(fns) else None)
        med_rows.append((sigmas[0], sigmas[1],
                         _prop_number(obj, "g", 0.0, texreg)))

    # --- entities: flatten transforms into one soup --------------------
    tri_v0, tri_e1, tri_e2 = [], [], []
    tri_n = ([], [], [])
    tri_uv = ([], [], [])
    tri_ent, tri_area, tri_shadow = [], [], []
    sph_center, sph_radius, sph_ent, sph_shadow = [], [], [], []
    ent_names: List[str] = []
    ent_mat, ent_light, ent_med_in, ent_med_out = [], [], [], []
    ent_tri_range: Dict[str, tuple] = {}
    ent_sphere: Dict[str, tuple] = {}
    all_points = []
    n_soup = 0
    # two-level instancing (ignis_tpu/scene/build.py:906-1037): with
    # `instancing`, every mesh shape that two or more entities use keeps
    # one local-space soup and a world->local transform per entity
    inst_shapes: set = set()
    inst_records: Dict[str, list] = {}
    if overrides.get("instancing"):
        use_count: Dict[str, int] = {}
        for _, obj in scene.entities.items():
            sn = obj.get_string("shape")
            if sn in meshes:
                use_count[sn] = use_count.get(sn, 0) + 1
        inst_shapes = {sn for sn, c in use_count.items() if c >= 2}
    for name, obj in scene.entities.items():
        shape_name = obj.get_string("shape")
        eid = len(ent_names)
        ent_names.append(name)
        ent_mat.append(mat_index.get(obj.get_string("bsdf"), 0))
        ent_light.append(-1)
        ent_med_in.append(med_index.get(obj.get_string("inner_medium"), -1))
        ent_med_out.append(med_index.get(obj.get_string("outer_medium"), -1))
        shadow_visible = obj.get_bool("shadow_visible", True)
        tr = obj.get_transform()
        m = None
        if shape_name in analytic_spheres:
            c, r = analytic_spheres[shape_name]
            lin = tr[:3, :3]
            scale = np.abs(np.linalg.det(lin)) ** (1.0 / 3.0)
            if not np.allclose(lin, np.eye(3) * lin[0, 0], atol=1e-5):
                warnings.append(f"Entity '{name}': non-uniform sphere scale, "
                                "tessellating")
                m = meshlib.make_ico_sphere(c, r, 5)
                m.transform(tr)
            else:
                wc = tr[:3, :3] @ np.asarray(c, np.float64) + tr[:3, 3]
                wr = r * scale
                sph_center.append(wc)
                sph_radius.append(wr)
                sph_ent.append(eid)
                sph_shadow.append(shadow_visible)
                ent_sphere[name] = (wc, wr)
                all_points.append(wc[None] + np.array([[-wr, -wr, -wr],
                                                       [wr, wr, wr]]))
        elif shape_name in inst_shapes:
            w2l = np.linalg.inv(tr)
            src = meshes[shape_name]
            lo, hi = src.vertices.min(axis=0), src.vertices.max(axis=0)
            corners = np.array([[x, y, z, 1.0] for x in (lo[0], hi[0])
                                for y in (lo[1], hi[1])
                                for z in (lo[2], hi[2])])
            wc = (tr @ corners.T).T[:, :3]
            inst_records.setdefault(shape_name, []).append(
                (w2l[:3, :4].astype(np.float32),
                 w2l[:3, :3].T.astype(np.float32), eid, shadow_visible,
                 wc.min(axis=0).astype(np.float32),
                 wc.max(axis=0).astype(np.float32)))
            all_points.append(wc)
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
        else:
            warnings.append(f"Entity '{name}': unknown shape '{shape_name}'")
        if m is not None:
            ent_tri_range[name] = (n_soup, len(m.indices))
            n_soup += _append_mesh(m, eid, shadow_visible, tri_v0, tri_e1,
                                   tri_e2, tri_n, tri_uv, tri_ent, tri_area,
                                   tri_shadow)
            all_points.append(m.vertices)
    areas_all = (np.concatenate(tri_area).astype(np.float32) if tri_area
                 else np.zeros(0, np.float32))

    # --- lights ---------------------------------------------------------
    l_rows = []
    area_tris: List[int] = []
    area_cdf: List[float] = []
    envmap = None
    env_cdf_method = "conditional"
    ent_name_to_id = {n: i for i, n in enumerate(ent_names)}

    def light_row(**kw):
        row = dict(kind=int(LightKind.POINT), pos=np.zeros(3),
                   dir=np.array([0, 0, 1.0]), intensity=np.ones(3), p0=0.0,
                   p1=0.0, p2=0.0, entity=-1, tri_start=0, tri_count=0,
                   tex=-1, delta=False, infinite=False)
        row.update(kw)
        return row

    def lcolor(o, key, default):
        return _const_color(o, key, default, texreg, warnings)

    def sky_env(name, img, intensity):
        """A baked sky image as a textured env light with the
        conditional CDF (ignis_tpu/scene/build.py:1186-1191)."""
        td, ta = texlib.make_image_texture(img, filt=texlib.FilterMode(1),
                                           device=device)
        tid = texreg.add(name, td, ta)
        l_rows.append(light_row(kind=int(LightKind.ENV), intensity=intensity,
                                tex=tid, infinite=True))
        return _build_env_cdf(img, False, "conditional", device)

    for name, obj in scene.lights.items():
        t = obj.plugin_type
        if t == "point":
            if "power" in obj.props:
                inten = lcolor(obj, "power", (4 * np.pi,) * 3) \
                    / (4 * np.pi)
            else:
                inten = lcolor(obj, "intensity", (1, 1, 1))
            l_rows.append(light_row(kind=int(LightKind.POINT),
                                    pos=obj.get_vec3("position"),
                                    intensity=inten, delta=True))
        elif t == "spot":
            cutoff = math.radians(obj.get_number("cutoff", 30.0))
            falloff = math.radians(obj.get_number("falloff", 20.0))
            if "power" in obj.props:
                factor = 2 * np.pi * (1 - 0.5 * (math.cos(cutoff)
                                                 + math.cos(falloff)))
                inten = lcolor(obj, "power", (1, 1, 1)) / factor
            else:
                inten = lcolor(obj, "intensity", (1, 1, 1))
            l_rows.append(light_row(kind=int(LightKind.SPOT),
                                    pos=obj.get_vec3("position"),
                                    dir=_light_direction(obj),
                                    intensity=inten, p0=math.cos(cutoff),
                                    p1=math.cos(falloff), delta=True))
        elif t == "directional":
            l_rows.append(light_row(
                kind=int(LightKind.DIRECTIONAL), dir=_light_direction(obj),
                intensity=lcolor(obj, "irradiance", (1, 1, 1)),
                delta=True, infinite=True))
        elif t == "area":
            ent_name = obj.get_string("entity")
            eid = ent_name_to_id.get(ent_name, -1)
            if eid < 0:
                warnings.append(f"Area light '{name}': unknown entity")
                continue
            rad = _as_color_const(obj.get("radiance"), (1, 1, 1))
            if rad is None:
                warnings.append(f"Area light '{name}': textured radiance "
                                "TODO")
                rad = np.ones(3)
            row_id = len(l_rows)
            if ent_name in ent_sphere:
                wc, wr = ent_sphere[ent_name]
                total = float(4.0 * np.pi * wr * wr)
                l_rows.append(light_row(kind=int(LightKind.AREA),
                                        intensity=rad, pos=np.asarray(wc),
                                        p0=total, p1=float(row_id), p2=wr,
                                        entity=eid))
            else:
                start, count = ent_tri_range.get(ent_name, (0, 0))
                areas = areas_all[start:start + count].astype(np.float64)
                total = float(np.sum(areas))
                cdf_local = np.cumsum(areas) / max(total, 1e-30)
                a_start = len(area_tris)
                area_tris.extend(range(start, start + count))
                area_cdf.extend((row_id + cdf_local).tolist())
                l_rows.append(light_row(kind=int(LightKind.AREA),
                                        intensity=rad, p0=total,
                                        p1=float(row_id), entity=eid,
                                        tri_start=a_start, tri_count=count))
            if "power" in obj.props:
                pw = lcolor(obj, "power", (1, 1, 1))
                l_rows[row_id]["intensity"] = pw / (np.pi * max(total, 1e-30))
            ent_light[eid] = row_id
        elif t in ("env", "envmap", "environment", "uniform", "constant"):
            rad = obj.get_color("radiance", (1, 1, 1))
            scale = lcolor(obj, "scale", (1, 1, 1))
            if isinstance(rad, str):
                tid = texreg.resolve_color(rad, f"Env light '{name}'")
                if tid < 0:
                    warnings.append(f"Env light '{name}': unresolved "
                                    f"'{rad}', using white")
                elif rad in texreg.images:
                    # the "cdf" method (EnvironmentLight.cpp:22-27)
                    m = (obj.get_string("cdf", "conditional")
                         or "conditional").lower()
                    if m not in ("none", "conditional", "sat", "hierachical",
                                 "hierarchical"):
                        warnings.append(f"Env light '{name}': unknown cdf "
                                        f"method '{m}', using conditional")
                        m = "conditional"
                    if m != "none":
                        env_cdf_method = m
                        envmap = _build_env_cdf(
                            texreg.images[rad],
                            obj.get_bool("compensate", True), m, device)
                l_rows.append(light_row(kind=int(LightKind.ENV),
                                        intensity=scale, tex=tid,
                                        infinite=True))
            else:
                l_rows.append(light_row(kind=int(LightKind.ENV),
                                        intensity=np.asarray(rad) * scale,
                                        infinite=True))
        elif t == "sun":
            # SunLight.cpp: direction points scene -> sun; radiance given,
            # or irradiance over the sun disk's solid angle
            from ..models.skysun import sun_area_from_angle
            d = _light_direction(obj)
            angle = obj.get_number("angle", 0.533)
            if "radiance" in obj.props:
                rad = lcolor(obj, "radiance", (1, 1, 1))
            else:
                rad = (lcolor(obj, "irradiance", (1, 1, 1))
                       / sun_area_from_angle(angle))
            l_rows.append(light_row(kind=int(LightKind.SUN), dir=-d,
                                    intensity=rad,
                                    p0=math.cos(math.radians(angle / 2.0)),
                                    infinite=True))
        elif t in _CIE_SKIES:
            from ..models.daylight import bake_cie
            img = bake_cie(
                t.replace("cie_", "").replace("cie", ""),
                _light_direction(obj),
                _as_color_const(obj.get("zenith"), (1, 1, 1)),
                _as_color_const(obj.get("ground"), (1, 1, 1)),
                _prop_number(obj, "ground_brightness", 0.2, texreg),
                _prop_number(obj, "turbidity", 2.45, texreg),
                obj.get_bool("has_ground", True),
                _as_color_const(obj.get("scale"), (1, 1, 1)))
            envmap = sky_env(f"__cie_{name}", img, np.ones(3))
        elif t == "perez":
            from ..models.daylight import bake_perez, perez_model
            d = _light_direction(obj)
            sz = math.pi / 2 - math.asin(max(-1.0, min(1.0, d[1])))
            try:
                day = datetime.date(obj.get_int("year", 2020),
                                    obj.get_int("month", 5),
                                    obj.get_int("day", 6)).timetuple().tm_yday
            except ValueError:
                day = 127
            day = _prop_number(obj, "day_of_the_year", day, texreg)

            def num(key, default):
                return _prop_number(obj, key, default, texreg)
            if ("diffuse_irradiance" in obj.props
                    or "direct_irradiance" in obj.props
                    or "direct_horizontal_irradiance" in obj.props):
                direct = num("direct_irradiance", -1.0)
                if direct < 0:
                    direct = (num("direct_horizontal_irradiance", 1.0)
                              / max(math.cos(sz), 1e-6))
                model = perez_model(
                    sz, day, diffuse_irrad=num("diffuse_irradiance", 1.0),
                    direct_irrad=direct)
            else:
                model = perez_model(sz, day,
                                    brightness=num("brightness", 0.2),
                                    clearness=num("clearness", 1.0))
            img, sun_rad, cos_angle = bake_perez(
                d, model, tint=_as_color_const(obj.get("color"), (1, 1, 1)),
                ground=_as_color_const(obj.get("ground"), (0.2, 0.2, 0.2)),
                has_ground=obj.get_bool("has_ground", True),
                has_sun=obj.get_bool("has_sun", True),
                output=obj.get_string("output", "visibleradiance").lower())
            envmap = sky_env(f"__perez_{name}", img, np.ones(3))
            if sun_rad is not None:
                l_rows.append(light_row(kind=int(LightKind.SUN), dir=-d,
                                        intensity=np.asarray(sun_rad),
                                        p0=cos_angle, infinite=True))
        elif t == "sky":
            # the Hosek-Wilkie sky baked to an equirect env texture
            from ..models.skysun import bake_sky
            img = bake_sky(_light_direction(obj),
                           obj.get_number("turbidity", 3.0),
                           obj.get_vec3("ground", (0.8, 0.8, 0.8)))
            envmap = sky_env(f"__sky_{name}", img,
                             _as_color_const(obj.get("scale"), (1, 1, 1)))
        else:
            warnings.append(f"Unsupported light type '{t}', skipped")

    # --- pack tables ----------------------------------------------------
    def cat(parts, width, dtype):
        if not parts:
            return np.zeros((0, width) if width else (0,), dtype)
        return np.concatenate(parts).astype(dtype)

    v0, e1, e2 = (cat(a, 3, np.float32) for a in (tri_v0, tri_e1, tri_e2))
    nrm = [cat(a, 3, np.float32) for a in tri_n]
    uvs = [cat(a, 2, np.float32) for a in tri_uv]
    t_ent = cat(tri_ent, 0, np.int32)
    t_area = areas_all
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
        inv_perm = np.empty_like(perm)
        inv_perm[perm] = np.arange(len(perm))
        area_tris = [int(inv_perm[i]) for i in area_tris]
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
    instances = (tuple(_instance_group(meshes[sn], inst_records[sn], ten,
                                       soa3, soa2)
                       for sn in sorted(inst_records))
                 if inst_records else None)
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
        med_inner=ten(np.asarray(ent_med_in or [-1], np.int32)),
        med_outer=ten(np.asarray(ent_med_out or [-1], np.int32)))

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

    lights = _pack_lights(l_rows, n_lights, radius, area_tris, area_cdf,
                          v0, e1, e2, ten, soa3)
    media = Media(
        sigma_a=Color(*[ten(np.asarray([r[0][i] for r in med_rows] or [0.0],
                                       np.float32)) for i in range(3)]),
        sigma_s=Color(*[ten(np.asarray([r[1][i] for r in med_rows] or [0.0],
                                       np.float32)) for i in range(3)]),
        g=ten(np.asarray([r[2] for r in med_rows] or [0.0], np.float32)))
    if envmap is None:
        envmap = EnvMap(present=ten(np.asarray(False)),
                        marginal=ten(np.zeros((1,), np.float32)),
                        conditional=ten(np.zeros((1, 1), np.float32)),
                        sat_table=ten(np.zeros((1, 1), np.float32)),
                        sat_grid=ten(np.zeros((1, 1), np.float32)))

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
    # the live parameter registry (ignis_tpu/scene/build.py:1583-1600):
    # number and vector parameters as f32 tensors that PExpr closures read
    # at evaluation time, so Runtime.setParameter re-renders without a
    # rebuild
    registry = {}
    for pname, p in (scene.parameters or {}).items():
        ptype, val = ((p.get("type", "number"), p.get("value", 0))
                      if isinstance(p, dict) else ("number", p))
        try:
            if ptype in ("number", "num", "int") and isinstance(
                    val, (int, float)):
                registry[pname] = scalar(float(np.float32(val)))
            elif ptype in ("vector", "color") and hasattr(val, "__len__"):
                registry[pname] = ten(np.asarray([float(x) for x in val],
                                                 np.float32))
        except (TypeError, ValueError):
            pass  # strings and malformed values stay load-time constants
    data = SceneData(tris=tris, tri_attr=attr, spheres=spheres,
                     sph_attr=sph_attr, entities=entities,
                     materials=materials, lights=lights, envmap=envmap,
                     camera=camera, media=media, bvh=bvh,
                     scene_radius=scalar(radius),
                     scene_center=Vec3(*[scalar(v) for v in center]),
                     textures=tuple(texreg.datas), instances=instances,
                     measured=tuple(texreg.measured), registry=registry)
    selector = (tech.get_string("light_selector", "uniform") or "uniform"
                ) if tech else "uniform"

    def rough(r):
        a = float(r["p2"])
        if r["kind"] == int(BsdfKind.CONDUCTOR):
            a = max(a, float(r["p3"]))
        return a > 1e-4
    kinds = {int(r["kind"]) for r in mat_rows}
    kinds |= {ROUGH_FLAG + int(r["kind"]) for r in mat_rows
              if r["kind"] in (int(BsdfKind.CONDUCTOR),
                               int(BsdfKind.DIELECTRIC)) and rough(r)}
    kinds |= {THIN_FLAG + int(BsdfKind.DIELECTRIC) for r in mat_rows
              if r["kind"] == int(BsdfKind.DIELECTRIC) and r["p3"] > 0.5}
    # the rows a shadow ray may see through (ignis_tpu/scene/build.py
    # :1633-1640, without its environment switch)
    see_through = any(r["kind"] in (int(BsdfKind.PASSTHROUGH),
                                    int(BsdfKind.RAD_BRTDF),
                                    int(BsdfKind.RAD_ROOS))
                      or (r["kind"] == int(BsdfKind.DIELECTRIC)
                          and r["p3"] > 0.5) for r in mat_rows)
    settings = RenderSettings(
        width=width, height=height, technique=tech_type,
        max_depth=max_depth, min_depth=min_depth, clamp=clamp,
        enable_nee=enable_nee,
        spi=int(overrides.get("spi", 1)), seed=int(overrides.get("seed", 0)),
        pixel_sampler=str(overrides.get("pixel_sampler", "uniform")),
        camera_type=cam_type, fish_mode=fish_mode,
        light_selector={"simple": "cdf"}.get(selector, selector),
        infinite_light_rows=infinite_rows, n_lights=n_lights,
        texture_descs=tuple(texreg.descs), medium_exprs=tuple(med_exprs),
        has_blend=has_blend,
        transparent_shadows=see_through,
        has_bump=any(r["bump_kind"] != 0 and r["bump_tex"] >= 0
                     for r in mat_rows),
        bsdf_kinds=tuple(sorted(kinds)),
        light_kinds=tuple(sorted({int(r["kind"]) for r in l_rows})),
        env_cdf_method=env_cdf_method,
        debug_mode=_debug_mode_of(tech) if tech else 0,
        # photon mapping (PhotonMappingTechnique.cpp:14-20): the reference
        # default of 1e6 photons, overridable
        photon_count=max(100, int(overrides.get(
            "photons", tech.get_int("photons", 1000000) if tech
            else 1000000))),
        max_light_depth=tech.get_int("max_light_depth", 8) if tech else 8,
        merge_radius=tech.get_number("radius", 0.01) if tech else 0.01,
        learning_iterations=(max(1, tech.get_int("learning_iterations", 1))
                             if tech else 1))
    return BuiltScene(data=data, settings=settings, warnings=warnings)


def _instance_group(src: meshlib.TriMesh, recs: list, ten, soa3, soa2):
    """The InstancedGeo of one reused mesh: its local soup (not padded;
    with its own BVH8 at BVH_THRESHOLD triangles or more, the soup and
    attributes reordered by its prim_order) and the instances' records
    (w2l, normal matrix, entity, shadow_visible, world box)."""
    lm = meshlib.TriMesh(src.vertices.copy(), src.indices.copy(),
                         None if src.normals is None else src.normals.copy(),
                         None if src.texcoords is None
                         else src.texcoords.copy())
    lm.ensure_attributes()
    lv0, le1, le2 = [], [], []
    ln, luv = ([], [], []), ([], [], [])
    _append_mesh(lm, 0, True, lv0, le1, le2, ln, luv, [], [], [])
    v0, e1, e2 = (np.concatenate(a).astype(np.float32)
                  for a in (lv0, le1, le2))
    nrm = [np.concatenate(a).astype(np.float32) for a in ln]
    uvs = [np.concatenate(a).astype(np.float32) for a in luv]
    bvh = None
    if len(v0) >= BVH_THRESHOLD:
        b = build_bvh8(v0, e1, e2)
        perm = b.prim_order.astype(np.int64)
        v0, e1, e2 = v0[perm], e1[perm], e2[perm]
        nrm = [a[perm] for a in nrm]
        uvs = [a[perm] for a in uvs]
        bvh = BVHArrays(*[ten(a) for a in (b.cmin_x, b.cmin_y, b.cmin_z,
                                           b.cmax_x, b.cmax_y, b.cmax_z,
                                           b.child)])
    return InstancedGeo(
        soup=TriSoup(soa3(v0), soa3(e1), soa3(e2)),
        n0=soa3(nrm[0]), n1=soa3(nrm[1]), n2=soa3(nrm[2]),
        uv0=soa2(uvs[0]), uv1=soa2(uvs[1]), uv2=soa2(uvs[2]),
        w2l=ten(np.stack([r[0] for r in recs])),
        nrm_mat=ten(np.stack([r[1] for r in recs])),
        ent=ten(np.asarray([r[2] for r in recs], np.int32)),
        shadow_visible=ten(np.asarray([r[3] for r in recs], bool)),
        aabb_min=ten(np.stack([r[4] for r in recs])),
        aabb_max=ten(np.stack([r[5] for r in recs])), bvh=bvh)


# DebugMode.cpp's names of the debug views, in enum order
# (ignis_tpu/scene/build.py:622-645)
_DEBUG_MODES = ["normal", "tangent", "bitangent", "geometric normal",
                "local normal", "local tangent", "local bitangent",
                "local geometric normal", "texture coords", "prim coords",
                "point", "local point", "generated coords", "hit distance",
                "area", "raw prim id", "prim id", "raw entity id",
                "entity id", "raw material id", "material id", "is emissive",
                "is specular", "is entering", "check bsdf", "albedo",
                "medium inner", "medium outer"]


def _debug_mode_of(tech) -> int:
    v = tech.get("mode", 0)
    if isinstance(v, str):
        try:
            return _DEBUG_MODES.index(v.strip().lower())
        except ValueError:
            return 0
    try:
        return int(v)
    except (TypeError, ValueError):
        return 0


def _pack_lights(l_rows, n_lights, scene_r, area_tris, area_cdf, v0, e1, e2,
                 ten, soa3) -> Lights:
    """The light table, one row per light, with the cdf selector's flux
    CDF (LoaderLight::generateLightSelectionCDF) and the light hierarchy
    over the finite lights (LightHierarchy.cpp: balanced median split,
    siblings adjacent, right = left + 1, a path code per light)."""
    def lcol(key):
        return np.asarray([r[key] for r in l_rows], np.float32)

    def flux(r):
        kind = r["kind"]
        mi = float(np.mean(r["intensity"]))
        if kind == int(LightKind.POINT):
            return 4 * np.pi * mi
        if kind == int(LightKind.SPOT):
            return 2 * np.pi * (1 - r["p0"]) * mi
        if kind == int(LightKind.AREA):
            return np.pi * r["p0"] * mi
        return np.pi * scene_r * scene_r * max(mi, 1e-3)

    fluxes = np.asarray([max(flux(r), 1e-8) for r in l_rows], np.float64)
    select_cdf = np.cumsum(fluxes) / fluxes.sum()

    def centroid(r):
        if r["kind"] == int(LightKind.AREA) and int(r["tri_count"]) > 0:
            s, c = int(r["tri_start"]), int(r["tri_count"])
            ids = [int(area_tris[s + k]) for k in range(c)]
            return np.mean([np.asarray(v0[t], np.float64)
                            + (np.asarray(e1[t], np.float64)
                               + np.asarray(e2[t], np.float64)) / 3.0
                            for t in ids], axis=0)
        return np.asarray(r["pos"], np.float64).reshape(3)

    entries: List = []   # (pos, dir, flux, has_dir, child)
    codes = np.zeros(len(l_rows), np.int32)
    finite = [i for i, r in enumerate(l_rows)
              if not r["infinite"] and n_lights > 0]
    if finite:
        pos = {i: centroid(l_rows[i]) for i in finite}

        def emit(rows, slot, code, depth):
            if len(rows) == 1:
                i = rows[0]
                r = l_rows[i]
                codes[i] = code
                entries[slot] = (pos[i],
                                 np.asarray(r["dir"], np.float64).reshape(3),
                                 float(fluxes[i]),
                                 r["kind"] == int(LightKind.SPOT), i)
                return entries[slot]
            ps = np.asarray([pos[i] for i in rows])
            axis = int(np.argmax(ps.max(0) - ps.min(0)))
            order = np.argsort(ps[:, axis], kind="stable")
            mid = len(rows) // 2
            li = len(entries)
            entries.extend([None, None])
            le = emit([rows[k] for k in order[:mid]], li, code, depth + 1)
            re = emit([rows[k] for k in order[mid:]], li + 1,
                      code | (1 << depth), depth + 1)
            d = le[1] + re[1]
            dn = np.linalg.norm(d)
            entries[slot] = ((le[0] + re[0]) * 0.5,
                             d / dn if dn > 1e-9 else np.array([0.0, 0, 1]),
                             le[2] + re[2], le[3] and re[3], -(li + 1))
            return entries[slot]

        entries.append(None)
        emit(finite, 0, 0, 0)

    def hcol(j, dtype=np.float32):
        return ten(np.asarray([e[j] for e in entries] or [0], dtype))

    intensity = lcol("intensity").reshape(-1, 3)
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
        area_tris=ten(np.asarray(area_tris or [0], np.int32)),
        area_cdf=ten(np.asarray(area_cdf or [0.0], np.float32)),
        select_cdf=ten(select_cdf.astype(np.float32)),
        hier_pos=soa3(np.asarray([e[0] for e in entries] or [[0, 0, 0]],
                                 np.float32)),
        hier_dir=soa3(np.asarray([e[1] for e in entries] or [[0, 0, 1]],
                                 np.float32)),
        hier_flux=hcol(2), hier_has_dir=hcol(3, bool),
        hier_child=hcol(4, np.int32), hier_code=ten(codes))


def _append_mesh(m: meshlib.TriMesh, eid: int, shadow_visible: bool,
                 tri_v0, tri_e1, tri_e2, tri_n, tri_uv, tri_ent, tri_area,
                 tri_shadow) -> int:
    """Append a mesh's triangles to the soup lists; returns their count."""
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
    return len(i)
