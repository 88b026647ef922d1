"""Light sampling / evaluation with masked kind dispatch.

Port of the slice's part of ignis_tpu/models/light.py: point lights and
constant (untextured) environment lights, with the uniform selector.
Other kinds and selectors raise NotImplementedError naming their ROADMAP
item.

Pdf convention (reference driver/light.art Pdf): every direct sample
carries (pdf_value, pdf_is_area); solid = value * dist^2 / cos for area
measure, value otherwise.
"""
from __future__ import annotations

from enum import IntEnum
from typing import NamedTuple

import torch

from ..core.vec import Color, Vec3, cselect, length, safe_div, vselect
from ..core.warp import INV_4PI, sample_uniform_sphere
from ..scenedata import Lights, SceneData

FLT_MAX = 3.0e38


class LightKind(IntEnum):
    POINT = 0
    SPOT = 1
    DIRECTIONAL = 2
    AREA = 3
    ENV = 4
    SUN = 5


SLICE_KINDS = (int(LightKind.POINT), int(LightKind.ENV))


def check_lights(settings, scene: SceneData) -> None:
    """Raise for any light kind, env texture or selector off the slice."""
    for k in settings.light_kinds or ():
        if int(k) not in SLICE_KINDS:
            raise NotImplementedError(
                f"light kind {int(k)} is not ported yet (ROADMAP queue 1, "
                "item 7: remaining light kinds)")
    if settings.light_selector != "uniform":
        raise NotImplementedError(
            f"light selector '{settings.light_selector}' is not ported yet "
            "(ROADMAP queue 1, item 7)")
    if bool((scene.lights.tex >= 0).any()):
        raise NotImplementedError(
            "textured environment lights are not ported yet (ROADMAP "
            "queue 1, item 7: textures and env CDFs)")


class LightParams(NamedTuple):
    kind: torch.Tensor
    pos: Vec3
    dir: Vec3
    intensity: Color
    p0: torch.Tensor
    p1: torch.Tensor
    p2: torch.Tensor
    tri_start: torch.Tensor
    tri_count: torch.Tensor
    tex: torch.Tensor
    delta: torch.Tensor
    infinite: torch.Tensor


class DirectSample(NamedTuple):
    pos: Vec3          # point on the light (meaningless for infinite)
    dir: Vec3          # unit direction surface -> light
    intensity: Color   # already divided by the sample pdf
    pdf_value: torch.Tensor
    pdf_is_area: torch.Tensor
    cos: torch.Tensor  # cosine on the light side
    dist: torch.Tensor


def gather_light(lights: Lights, idx) -> LightParams:
    idx = idx.long()

    def g(a):
        return a[idx]
    return LightParams(
        kind=g(lights.kind),
        pos=Vec3(*[g(a) for a in lights.pos]),
        dir=Vec3(*[g(a) for a in lights.dir]),
        intensity=Color(*[g(a) for a in lights.intensity]),
        p0=g(lights.p0), p1=g(lights.p1), p2=g(lights.p2),
        tri_start=g(lights.tri_start), tri_count=g(lights.tri_count),
        tex=g(lights.tex), delta=g(lights.delta), infinite=g(lights.infinite))


def pdf_as_solid(pdf_value, pdf_is_area, cos, dist2):
    area_as_solid = pdf_value * safe_div(dist2, cos)
    return torch.where(pdf_is_area, area_as_solid, pdf_value)


def sample_direct(scene: SceneData, lp: LightParams, from_point: Vec3,
                  u0, u1, kinds) -> DirectSample:
    """Direct-connection sample; `kinds` (settings.light_kinds) prunes
    absent kinds statically."""
    one = torch.ones_like(lp.p0)
    kinds = tuple(int(x) for x in kinds)
    branches = []
    if int(LightKind.POINT) in kinds:
        to_l = lp.pos - from_point
        dist = length(to_l)
        pdir = to_l * safe_div(1.0, dist)
        branches.append((LightKind.POINT, DirectSample(
            lp.pos, pdir, lp.intensity, one, one > 0, one, dist)))
    if int(LightKind.ENV) in kinds:
        branches.append((LightKind.ENV, _sample_env_direct(
            scene, lp, from_point, u0, u1)))

    def sel(kv, s, cur):
        m = lp.kind == kv
        return DirectSample(vselect(m, s.pos, cur.pos),
                            vselect(m, s.dir, cur.dir),
                            cselect(m, s.intensity, cur.intensity),
                            torch.where(m, s.pdf_value, cur.pdf_value),
                            torch.where(m, s.pdf_is_area, cur.pdf_is_area),
                            torch.where(m, s.cos, cur.cos),
                            torch.where(m, s.dist, cur.dist))

    out = branches[0][1]
    for kv, s in branches[1:]:
        out = sel(kv, s, out)
    return out


def _sample_env_direct(scene: SceneData, lp: LightParams, from_point: Vec3,
                       u0, u1) -> DirectSample:
    """Constant env: uniform sphere (env.art spherical variant)."""
    radius = scene.scene_radius * 1.01
    d, _ = sample_uniform_sphere(u0, u1)
    intens = lp.intensity * (1.0 / INV_4PI)
    pdf = torch.full_like(lp.p0, INV_4PI)
    return DirectSample(from_point + d * radius, d, intens, pdf,
                        torch.zeros_like(lp.delta),
                        torch.ones_like(lp.p0),
                        radius.expand(lp.p0.shape).contiguous())


def env_emission(lp: LightParams) -> Color:
    """Radiance of a constant env light for an escaping ray."""
    is_env = lp.kind == LightKind.ENV
    z = torch.zeros_like(lp.p0)
    return cselect(is_env, lp.intensity, Color(z, z, z))


def env_pdf_direct(lp: LightParams):
    """Solid-angle pdf of sampling a direction via sample_direct (MIS)."""
    return torch.full_like(lp.p0, INV_4PI)


def select_light(settings, u):
    """Uniform selector (light_selector.art:26)."""
    n_lights = settings.n_lights
    idx = torch.clamp((u * n_lights).to(torch.int32), 0, max(n_lights - 1, 0))
    pdf = torch.full_like(u, 1.0 / max(n_lights, 1))
    return idx, pdf


def selector_pdf(settings, like):
    """Uniform selection pdf of any light row."""
    return torch.full_like(like, 1.0 / max(settings.n_lights, 1),
                           dtype=torch.float32)
