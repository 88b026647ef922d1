"""Scene file parsing: tolerant JSON + externals + transform DSL.

Copied from ignis_tpu/scene/parser.py, which cannot be imported without
JAX (ignis_tpu/__init__.py imports the JAX renderer), unchanged; glTF
includes go through the port's own copy of the importer (scene/gltf.py).
Output is a plain-Python `Scene` of `SceneObject`s, consumed by
ignis_tpu_torch.scene.build.
"""

from __future__ import annotations

import json
import math
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np


# ---------------------------------------------------------------------------
# Tolerant JSON
# ---------------------------------------------------------------------------

def _strip_json(text: str) -> str:
    """Remove // and /* */ comments and trailing commas (string-safe)."""
    out = []
    i, n = 0, len(text)
    in_str = False
    while i < n:
        c = text[i]
        if in_str:
            out.append(c)
            if c == "\\" and i + 1 < n:
                out.append(text[i + 1])
                i += 2
                continue
            if c == '"':
                in_str = False
            i += 1
            continue
        if c == '"':
            in_str = True
            out.append(c)
            i += 1
            continue
        if c == "/" and i + 1 < n and text[i + 1] == "/":
            while i < n and text[i] != "\n":
                i += 1
            continue
        if c == "/" and i + 1 < n and text[i + 1] == "*":
            i += 2
            while i + 1 < n and not (text[i] == "*" and text[i + 1] == "/"):
                i += 1
            i += 2
            continue
        out.append(c)
        i += 1
    stripped = "".join(out)
    # trailing commas: , followed by ] or }
    stripped = re.sub(r",(\s*[\]}])", r"\1", stripped)
    return stripped


def loads_tolerant(text: str) -> Any:
    return json.loads(_strip_json(text))


# ---------------------------------------------------------------------------
# Transforms
# ---------------------------------------------------------------------------

def look_at(eye, target, up) -> np.ndarray:
    """3x4 camera-style frame: cols = (right, up, forward, eye).

    Matches the reference lookAt (Parser.cpp): f = normalize(target-eye),
    s = normalize(f x up), u = s x f.
    """
    eye = np.asarray(eye, np.float64)
    f = np.asarray(target, np.float64) - eye
    fn = np.linalg.norm(f)
    f = f / fn if fn > 1e-12 else np.array([0.0, 0.0, 1.0])
    u = np.asarray(up, np.float64)
    un = np.linalg.norm(u)
    u = u / un if un > 1e-12 else np.array([0.0, 0.0, 1.0])
    s = np.cross(f, u)
    sn = np.linalg.norm(s)
    if sn > 1e-12:
        s = s / sn
        u = np.cross(s, f)
    else:  # f parallel to up: build any frame
        s, u = _any_frame(f)
    m = np.eye(4)
    m[:3, 0] = s
    m[:3, 1] = u
    m[:3, 2] = f
    m[:3, 3] = eye
    return m


def _any_frame(n):
    sign = math.copysign(1.0, n[2])
    a = -1.0 / (sign + n[2])
    b = n[0] * n[1] * a
    t = np.array([1.0 + sign * n[0] * n[0] * a, sign * b, -sign * n[0]])
    bt = np.array([b, sign + n[1] * n[1] * a, -n[1]])
    return t, bt


def _rot_xyz(angles_deg) -> np.ndarray:
    ax, ay, az = [math.radians(a) for a in angles_deg]
    cx, sx = math.cos(ax), math.sin(ax)
    cy, sy = math.cos(ay), math.sin(ay)
    cz, sz = math.cos(az), math.sin(az)
    rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    m = np.eye(4)
    m[:3, :3] = rx @ ry @ rz
    return m


def _quat_matrix(q) -> np.ndarray:
    # [w, x, y, z] convention (Eigen Quaternionf(w,x,y,z) from 4D vector)
    w, x, y, z = q
    n = math.sqrt(w * w + x * x + y * y + z * z)
    if n == 0:
        return np.eye(4)
    w, x, y, z = w / n, x / n, y / n, z / n
    m = np.eye(4)
    m[:3, :3] = np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ])
    return m


def _matrix_from_flat(vals: List[float]) -> np.ndarray:
    m = np.eye(4)
    if len(vals) == 9:
        m[:3, :3] = np.asarray(vals, np.float64).reshape(3, 3)
    elif len(vals) == 12:
        m[:3, :] = np.asarray(vals, np.float64).reshape(3, 4)
    elif len(vals) == 16:
        m[:, :] = np.asarray(vals, np.float64).reshape(4, 4)
    else:
        raise ValueError(f"Transform matrix must have 9/12/16 entries, got {len(vals)}")
    return m


def _apply_transform_op(m: np.ndarray, name: str, value) -> np.ndarray:
    if name == "translate":
        t = np.eye(4)
        t[:3, 3] = np.asarray(value, np.float64)
        return m @ t
    if name == "scale":
        s = np.eye(4)
        if isinstance(value, (int, float)):
            s[0, 0] = s[1, 1] = s[2, 2] = float(value)
        else:
            s[0, 0], s[1, 1], s[2, 2] = [float(v) for v in value]
        return m @ s
    if name == "rotate":
        return m @ _rot_xyz(value)
    if name == "qrotate":
        return m @ _quat_matrix(value)
    if name == "lookat":
        origin = np.asarray(value.get("origin", [0, 0, 0]), np.float64)
        up = np.asarray(value.get("up", [0, 0, 1]), np.float64)
        if "direction" in value:
            target = np.asarray(value["direction"], np.float64) + origin
        else:
            target = np.asarray(value.get("target", [0, 1, 0]), np.float64)
        return m @ look_at(origin, target, up)
    if name == "matrix":
        return m @ _matrix_from_flat(value)
    raise ValueError(f"Unknown transform op '{name}'")


def parse_transform(prop) -> np.ndarray:
    """Property value -> 4x4 matrix (float64 host-side)."""
    if prop is None:
        return np.eye(4)
    if isinstance(prop, list) and prop and isinstance(prop[0], (int, float)):
        return _matrix_from_flat(prop)
    m = np.eye(4)
    if isinstance(prop, dict):
        prop = [prop]
    for op_obj in prop:
        for name, value in op_obj.items():
            m = _apply_transform_op(m, name, value)
    return m


# ---------------------------------------------------------------------------
# Scene objects
# ---------------------------------------------------------------------------

@dataclass
class SceneObject:
    plugin_type: str
    name: str
    props: Dict[str, Any] = field(default_factory=dict)
    base_dir: Path = Path(".")

    def get(self, key, default=None):
        return self.props.get(key, default)

    def get_number(self, key, default=0.0) -> float:
        v = self.props.get(key, default)
        return float(v)

    def get_int(self, key, default=0) -> int:
        return int(self.props.get(key, default))

    def get_bool(self, key, default=False) -> bool:
        return bool(self.props.get(key, default))

    def get_string(self, key, default="") -> str:
        v = self.props.get(key, default)
        return v if isinstance(v, str) else default

    def get_vec3(self, key, default=(0.0, 0.0, 0.0)) -> np.ndarray:
        v = self.props.get(key, None)
        if v is None:
            return np.asarray(default, np.float64)
        if isinstance(v, (int, float)):
            return np.full(3, float(v))
        return np.asarray(v, np.float64)

    def get_color(self, key, default=(0.0, 0.0, 0.0)):
        """Color property: number | [r,g,b] | texture/PExpr string."""
        v = self.props.get(key, None)
        if v is None:
            return np.asarray(default, np.float64)
        if isinstance(v, (int, float)):
            return np.full(3, float(v))
        if isinstance(v, str):
            return v  # texture name or PExpr — resolved by build stage
        return np.asarray(v, np.float64)

    def get_transform(self, key="transform") -> np.ndarray:
        return parse_transform(self.props.get(key))

    def path(self, key) -> Optional[Path]:
        s = self.get_string(key)
        if not s:
            return None
        p = Path(s)
        return p if p.is_absolute() else (self.base_dir / p)


@dataclass
class Scene:
    technique: Optional[SceneObject] = None
    camera: Optional[SceneObject] = None
    film: Optional[SceneObject] = None
    bsdfs: Dict[str, SceneObject] = field(default_factory=dict)
    shapes: Dict[str, SceneObject] = field(default_factory=dict)
    entities: Dict[str, SceneObject] = field(default_factory=dict)
    lights: Dict[str, SceneObject] = field(default_factory=dict)
    media: Dict[str, SceneObject] = field(default_factory=dict)
    textures: Dict[str, SceneObject] = field(default_factory=dict)
    parameters: Dict[str, Any] = field(default_factory=dict)


_LIST_KEYS = ("bsdfs", "shapes", "entities", "lights", "media", "textures")


def _parse_object(kind: str, obj: dict, base_dir: Path) -> SceneObject:
    props = {k: v for k, v in obj.items() if k not in ("type", "name")}
    return SceneObject(
        plugin_type=str(obj.get("type", "")).lower(),
        name=str(obj.get("name", "")),
        props=props,
        base_dir=base_dir,
    )


def _merge_into(scene: Scene, data: dict, base_dir: Path, top_level: bool):
    # Externals first: the including file's own objects override same-named
    # objects from includes (the variant-over-base pattern used throughout
    # the reference's evaluation scenes, e.g. two-planes-mirror.json).
    for ext in data.get("externals", []):
        fn = ext.get("filename")
        if not fn:
            continue
        p = Path(fn)
        p = p if p.is_absolute() else base_dir / p
        if p.suffix.lower() in (".gltf", ".glb"):
            from .gltf import merge_gltf
            merge_gltf(scene, p)
        else:
            sub = loads_tolerant(p.read_text())
            _merge_into(scene, sub, p.parent, top_level=False)
    for kind in _LIST_KEYS:
        for obj in data.get(kind, []):
            so = _parse_object(kind, obj, base_dir)
            getattr(scene, kind)[so.name] = so
    # Singletons: outer file wins (includes were merged before us)
    for kind in ("technique", "camera", "film"):
        if kind in data:
            so = _parse_object(kind, data[kind], base_dir)
            setattr(scene, kind, so)
    if "parameters" in data:
        scene.parameters.update(data["parameters"])


def load_from_string(text: str, base_dir="." ) -> Scene:
    data = loads_tolerant(text)
    scene = Scene()
    _merge_into(scene, data, Path(base_dir), top_level=True)
    return scene


def load_from_file(path) -> Scene:
    p = Path(path)
    return load_from_string(p.read_text(), p.parent)
