"""Flat scene representation on torch tensors (port of ignis_tpu/scenedata.py).

The scene's arrays are this renderer's "weights": SoA tables of tensors in
NamedTuples whose field names match the JAX package, so the bridge
(bridge.py) and the module-by-module tests compare like for like. Nothing
is placed on a device implicitly: `SceneData.to(device)` moves every leaf.

Left out against the JAX SceneData: the TPU-only chunked-leaf BVH: `bvh`
is the tri-leaf BVH8 alone (ops/bvh.BVHArrays). `textures` is a tuple of
models/texture.TexData; `instances` a tuple of ops/instanced.InstancedGeo,
one per mesh shared by two or more entities under `instancing=True`, or
None; `measured` the measured BSDFs' tables (models/klems.KlemsData,
models/tensortree.TensorTreeData, models/djmeasured.DJData), indexed by
a material row's q6; `registry` the scene's live parameters, name -> a
0-d or [3] / [4] f32 tensor, which Runtime.setParameter updates in place.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from .core.vec import Color, Vec2, Vec3
from .ops.bvh import BVHArrays
from .ops.intersect import SphereSoup, TriSoup


def tree_map(fn, obj):
    """Apply `fn` to every tensor leaf of nested NamedTuples, tuples and
    dicts."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*[tree_map(fn, v) for v in obj])
    if isinstance(obj, tuple):
        return tuple(tree_map(fn, v) for v in obj)
    if isinstance(obj, dict):
        return {k: tree_map(fn, v) for k, v in obj.items()}
    return obj


class TriAttributes(NamedTuple):
    """Per-triangle shading attributes (SoA, same order as the soup)."""
    n0: Vec3
    n1: Vec3
    n2: Vec3
    uv0: Vec2
    uv1: Vec2
    uv2: Vec2
    ent: torch.Tensor            # [T] i32 entity id, -1 padding
    area: torch.Tensor           # [T] f32 world-space area
    shadow_visible: torch.Tensor  # [T] bool


class SphereAttributes(NamedTuple):
    ent: torch.Tensor            # [S] i32
    shadow_visible: torch.Tensor  # [S] bool


class Entities(NamedTuple):
    mat: torch.Tensor        # [E] i32 material row
    light: torch.Tensor      # [E] i32 area-light id or -1
    med_inner: torch.Tensor  # [E] i32 medium id or -1
    med_outer: torch.Tensor  # [E] i32 medium id or -1


class Materials(NamedTuple):
    """Unified SoA material table; one row per scene BSDF (slot meanings
    in models/bsdf.py)."""
    kind: torch.Tensor
    base: Color
    extra: Color
    extra2: Color
    p0: torch.Tensor
    p1: torch.Tensor
    p2: torch.Tensor
    p3: torch.Tensor
    q0: torch.Tensor
    q1: torch.Tensor
    q2: torch.Tensor
    q3: torch.Tensor
    q4: torch.Tensor
    q5: torch.Tensor
    q6: torch.Tensor
    q7: torch.Tensor
    q8: torch.Tensor
    base_tex: torch.Tensor
    extra_tex: torch.Tensor
    p0_tex: torch.Tensor
    p1_tex: torch.Tensor
    bump_kind: torch.Tensor
    bump_tex: torch.Tensor
    bump_strength: torch.Tensor


class Lights(NamedTuple):
    """Unified SoA light table; one row per light (fields by kind in
    ignis_tpu/scenedata.py)."""
    kind: torch.Tensor
    pos: Vec3
    dir: Vec3
    intensity: Color
    p0: torch.Tensor
    p1: torch.Tensor
    p2: torch.Tensor
    entity: torch.Tensor
    tri_start: torch.Tensor
    tri_count: torch.Tensor
    tex: torch.Tensor
    delta: torch.Tensor
    infinite: torch.Tensor
    area_tris: torch.Tensor
    area_cdf: torch.Tensor
    select_cdf: torch.Tensor
    hier_pos: Vec3
    hier_dir: Vec3
    hier_flux: torch.Tensor
    hier_has_dir: torch.Tensor
    hier_child: torch.Tensor
    hier_code: torch.Tensor


class EnvMap(NamedTuple):
    """Environment importance tables of a textured env light: the
    conditional CDF (marginal, conditional), the summed-area table
    (sat_table, sat_grid) or the mip pyramid (hier_levels); the unused
    ones stay [1] / [1, 1] placeholders (core/cdf.py)."""
    present: torch.Tensor
    marginal: torch.Tensor
    conditional: torch.Tensor
    sat_table: torch.Tensor
    sat_grid: torch.Tensor
    hier_levels: tuple = ()


class CameraData(NamedTuple):
    eye: Vec3     # 0-d tensors
    dir: Vec3
    up: Vec3
    scale: Vec2   # tan(fov/2) horizontal/vertical
    tmin: torch.Tensor
    tmax: torch.Tensor
    aperture: torch.Tensor
    focal: torch.Tensor


class Media(NamedTuple):
    sigma_a: Color
    sigma_s: Color
    g: torch.Tensor


class SceneData(NamedTuple):
    tris: TriSoup
    tri_attr: TriAttributes
    spheres: SphereSoup
    sph_attr: SphereAttributes
    entities: Entities
    materials: Materials
    lights: Lights
    envmap: EnvMap
    camera: CameraData
    media: Media
    bvh: Optional[BVHArrays]
    scene_radius: torch.Tensor
    scene_center: Vec3
    textures: tuple = ()
    instances: Optional[tuple] = None
    measured: tuple = ()
    registry: Optional[dict] = None

    def to(self, device) -> "SceneData":
        """Every tensor leaf on `device` (a copy where it moves)."""
        return tree_map(lambda t: t.to(device), self)

    @property
    def device(self) -> torch.device:
        return self.tris.v0.x.device


@dataclasses.dataclass(frozen=True)
class RenderSettings:
    """Hashable static render configuration (copied from the JAX package;
    the fields other techniques read stay, so the bridge can copy it)."""
    width: int
    height: int
    technique: str = "path"
    max_depth: int = 64
    min_depth: int = 2
    clamp: float = 0.0
    enable_nee: bool = True
    spi: int = 1
    seed: int = 0
    camera_type: str = "perspective"
    fish_mode: str = "circular"
    infinite_light_rows: Tuple[int, ...] = ()
    n_lights: int = 0
    aov_normals: bool = False
    light_selector: str = "uniform"
    remat: bool = False
    debug_mode: int = 0
    texture_descs: Tuple = ()
    medium_exprs: Tuple = ()
    has_blend: bool = False
    transparent_shadows: bool = False
    has_bump: bool = False
    pixel_sampler: str = "uniform"
    learning_iterations: int = 1
    photon_count: int = 100000
    max_light_depth: int = 8
    merge_radius: float = 0.01
    ppm_grid: int = 64
    ppm_cell_cap: int = 32
    bsdf_kinds: Tuple = None
    light_kinds: Tuple = None
    env_cdf_method: str = "conditional"
