"""Simple techniques: ambient occlusion, debug views, wireframe, light
visibility, the camera and environment checks, and the AOV info buffer.

Port of ignis_tpu/techniques/simple.py. Each shades one camera sample of
every lane: one closest hit (K1/K2, instanced groups included), the hit
attributes through K3 and, where the view needs them, the material
through K3 and one shadow any hit. Every function takes the render's
tables (path.RenderTables, made once per iteration) where the JAX one
takes the texture evaluator. `sample_lanes` is an iteration of one of
them (settings.spi camera samples a lane, the JAX per-sample loop,
ignis_tpu/render/session.py:273-294); `SimpleProgram` is that iteration
as one captured program (techniques/program.py).
"""
from __future__ import annotations

import torch

from ..core import rng as rnglib
from ..core.frame import make_frame
from ..core.sampler import sample_pixel_offsets
from ..core.vec import Color, Vec3, black_like, cselect, vselect
from ..core.warp import sample_cosine_hemisphere
from ..models import bsdf as bsdflib
from ..models import camera as cameralib
from ..models import light as lightlib
from ..ops.intersect import FLT_MAX, Rays
from ..scenedata import RenderSettings, SceneData
from . import canonical
from .path import (OFFSET, RenderTables, compute_surface, gather_material,
                   infinite_emissions, light_texture, make_surface_ctx,
                   occluded_scene, trace_scene)
from .program import Program


def _hit_surface(scene, rays, tabs):
    hit = trace_scene(scene, rays, tabs.packed, tabs.inst)
    return hit, compute_surface(scene, rays, hit, tabs.attr, tabs.inst)


def _grey(v) -> Color:
    return Color(v, v, v)


def ao_trace(scene: SceneData, settings: RenderSettings, rays: Rays,
             rng_state, tabs: RenderTables) -> Color:
    """Ambient occlusion: white where the cosine-sampled hemisphere ray
    escapes (aotracer.art)."""
    hit, surf = _hit_surface(scene, rays, tabs)
    found = hit.prim >= 0
    frame = make_frame(surf.ns)
    _, (u0, u1) = rnglib.next_f32_n(rng_state, 2)
    ldir, _ = sample_cosine_hemisphere(u0, u1)
    srays = Rays(surf.point, frame.to_world(ldir),
                 torch.full_like(rays.tmin, OFFSET),
                 torch.full_like(rays.tmin, FLT_MAX))
    occ = occluded_scene(scene, srays, tabs.packed, tabs.inst)
    return _grey(torch.where(found & ~occ, 1.0, 0.0))


def _abs_color(v: Vec3) -> Color:
    return Color(torch.abs(v.x), torch.abs(v.y), torch.abs(v.z))


def _palette(i) -> Color:
    """Distinct colours from an id (the reference colormap::palette)."""
    h = rnglib.mul32(rnglib.as_u32(i), 2654435761) & 0xFFFFFF
    return Color(((h >> 16) & 0xFF).to(torch.float32) / 255.0,
                 ((h >> 8) & 0xFF).to(torch.float32) / 255.0,
                 (h & 0xFF).to(torch.float32) / 255.0)


def _at(table, idx):
    """table[idx] with the index clamped into range (the JAX gather's
    out-of-bounds rule)."""
    return table[torch.clamp(idx, 0, table.shape[0] - 1).long()]


def debug_trace(scene: SceneData, settings: RenderSettings, rays: Rays,
                rng_state, tabs: RenderTables) -> Color:
    """Debug views (debugtracer.art modes, settings.debug_mode)."""
    hit, surf = _hit_surface(scene, rays, tabs)
    found = hit.prim >= 0
    frame = make_frame(surf.ns)
    mode = settings.debug_mode
    ent = torch.clamp(surf.ent, min=0)
    z = torch.zeros_like(rays.tmin)

    def material():
        # untextured, as the JAX debug views read it
        return gather_material(scene, surf, tabs.mat, info=tabs.info)[0]

    if mode == 1:
        c = _abs_color(frame.t)
    elif mode == 2:
        c = _abs_color(frame.b)
    elif mode == 3:
        c = _abs_color(surf.face_n)
    elif mode in (4, 5, 6, 7):
        # the local-frame views: the frames are ray-facing world frames
        c = _abs_color({4: surf.ns, 5: frame.t, 6: frame.b,
                        7: surf.face_n}[mode])
    elif mode == 8:
        c = Color(torch.abs(surf.uv.x), torch.abs(surf.uv.y), z)
    elif mode == 9:
        c = Color(torch.abs(hit.u), torch.abs(hit.v), z)
    elif mode in (10, 11, 12):
        # Point / LocalPoint / GeneratedCoords: the normalised hit position
        inv = 1.0 / torch.clamp(scene.scene_radius, min=1e-6)
        c = Color(torch.abs(surf.point.x - scene.scene_center.x) * inv,
                  torch.abs(surf.point.y - scene.scene_center.y) * inv,
                  torch.abs(surf.point.z - scene.scene_center.z) * inv)
    elif mode == 13:
        c = _grey(hit.t)
    elif mode == 14:
        c = _grey(_at(scene.tri_attr.area, hit.prim))
    elif mode in (15, 16):
        c = _palette(hit.prim)
    elif mode in (17, 18):
        c = _palette(surf.ent)
    elif mode in (19, 20):
        c = _palette(_at(scene.entities.mat, ent))
    elif mode == 21:
        e = (_at(scene.entities.light, ent) >= 0).to(torch.float32)
        c = Color(e, e, z)
    elif mode in (22, 24):
        # IsSpecular / CheckBSDF: the hit material is delta only
        present = tuple(int(k) for k in settings.bsdf_kinds)
        d = bsdflib.is_all_delta(material(), present).to(torch.float32)
        c = Color(d, z, d)
    elif mode == 23:
        e = surf.is_entering.to(torch.float32)
        c = Color(z, e, 1.0 - e)
    elif mode == 25:
        c = material().base
    elif mode in (26, 27):
        med = (scene.entities.med_inner if mode == 26
               else scene.entities.med_outer)
        c = _palette(torch.clamp(_at(med, ent), min=0))
    else:   # 0: the shading normal
        c = _abs_color(frame.n)
    return cselect(found, c, black_like(rays.tmin))


def wireframe_trace(scene: SceneData, settings: RenderSettings, rays: Rays,
                    rng_state, tabs: RenderTables) -> Color:
    """Edges: barycentric proximity to a triangle edge (wireframe.art)."""
    hit = trace_scene(scene, rays, tabs.packed, tabs.inst)
    edge = torch.minimum(torch.minimum(hit.u, hit.v), 1.0 - hit.u - hit.v)
    return _grey(torch.where((hit.prim >= 0) & (edge < 0.02), 1.0, 0.0))


def light_visibility_trace(scene: SceneData, settings: RenderSettings,
                           rays: Rays, rng_state,
                           tabs: RenderTables) -> Color:
    """Whether a uniformly picked light is seen from the first hit by one
    direct sample (lightvisibility.art, simplified)."""
    hit, surf = _hit_surface(scene, rays, tabs)
    if settings.n_lights == 0:
        return black_like(rays.tmin)
    _, (ul, u0, u1) = rnglib.next_f32_n(rng_state, 3)
    lsel, _ = lightlib.select_uniform(settings.n_lights, ul)
    lp = lightlib.gather_light(scene.lights, lsel)
    ls = lightlib.sample_direct(scene, lp, surf.point, surf.is_entering, u0,
                                u1, light_texture(tabs), settings.light_kinds)
    sdir = vselect(lp.infinite, ls.dir, ls.pos - surf.point)
    stmax = torch.where(lp.infinite, FLT_MAX, 1.0 - OFFSET)
    srays = Rays(surf.point, sdir, torch.full_like(stmax, OFFSET), stmax)
    occ = occluded_scene(scene, srays, tabs.packed, tabs.inst)
    return _grey(torch.where((hit.prim >= 0) & ~occ & (ls.cos > 0), 1.0,
                             0.0))


def env_check_trace(scene: SceneData, settings: RenderSettings, rays: Rays,
                    rng_state, tabs: RenderTables) -> Color:
    """The environment alone: camera rays that miss show the summed
    emission of every infinite non-delta light (internal/env_check.art)."""
    hit = trace_scene(scene, rays, tabs.packed, tabs.inst)
    miss = hit.prim < 0
    out = black_like(rays.tmin)
    for *_, emit in infinite_emissions(scene, tabs, rays.dir):
        out = cselect(miss, out + emit, out)
    return out


def camera_check_trace(scene: SceneData, settings: RenderSettings,
                       rays: Rays, rng_state, tabs: RenderTables,
                       pixel=None) -> Color:
    """Reproject the first hit through the camera: green where the point
    lands on its own pixel and sees the camera, shading to red with the
    reprojection error (internal/camera_check.art). `pixel` is each
    lane's row-major pixel index; by default the lanes are the whole
    film's pixels in row-major order."""
    hit, surf = _hit_surface(scene, rays, tabs)
    n = rays.tmin.shape[0]
    valid_p, pix, cam_dir, _ = cameralib.sample_pixel(scene.camera, settings,
                                                      surf.point)
    w, h = settings.width, settings.height
    lane = (torch.arange(n, dtype=torch.int32, device=rays.tmin.device)
            if pixel is None else pixel.to(torch.int32))
    fac = ((1.0 - torch.abs(lane % w - pix % w).to(torch.float32) / w)
           * (1.0 - torch.abs(lane // w - pix // w).to(torch.float32) / h))
    fac = torch.clamp(fac, 0.0, 1.0)
    srays = Rays(surf.point, cam_dir, torch.full_like(rays.tmin, OFFSET),
                 torch.full_like(rays.tmin, 1.0 - float(OFFSET)))
    occ = occluded_scene(scene, srays, tabs.packed, tabs.inst)
    ok = (hit.prim >= 0) & valid_p & ~occ
    z = torch.zeros_like(rays.tmin)
    # red + (green - red) * fac
    return cselect(ok, Color(1.0 - fac, fac, z), black_like(rays.tmin))


def info_buffer(scene: SceneData, settings: RenderSettings, rays: Rays,
                rng_state, tabs: RenderTables):
    """(Normals, Albedo, Depth) AOVs in one traversal (the reference
    `infobuffer` technique that feeds the denoiser): the shading normal,
    the textured albedo (white on a miss) and the hit distance."""
    hit, surf = _hit_surface(scene, rays, tabs)
    found = hit.prim >= 0
    ev = tabs.eval_texture
    ctx = (make_surface_ctx(scene, rays, surf, tabs.info)
           if ev is not None else None)
    mat = gather_material(scene, surf, tabs.mat, ev, ctx, tabs.info)[0]
    z = torch.zeros_like(rays.tmin)
    normals = Color(*[torch.where(found, c, 0.0) for c in surf.ns])
    albedo = Color(*[torch.where(found, c, 1.0) for c in mat.base])
    depth = torch.where(found, hit.t, 0.0)
    return normals, albedo, Color(depth, depth, z)


TRACES = {"ao": ao_trace, "debug": debug_trace, "wireframe": wireframe_trace,
          "lightvisibility": light_visibility_trace,
          "camera_check": camera_check_trace, "env_check": env_check_trace}


def sample_lanes(scene: SceneData, settings: RenderSettings,
                 tabs: RenderTables, x, y, iteration, frame) -> Color:
    """One iteration of the settings' simple technique for the lanes
    (pixels) x, y: each lane's colour summed over settings.spi camera
    samples; camera_check gets each lane's pixel id. `iteration` and
    `frame` are ints or 0-d int64 tensors (a CUDA graph's inputs)."""
    tech = canonical(settings.technique)
    fn = TRACES[tech]
    acc = None
    for s in range(settings.spi):
        state = rnglib.seed(s, iteration, frame, x, y, settings.seed)
        state, (rx, ry) = sample_pixel_offsets(
            settings.pixel_sampler, state, iteration * settings.spi + s, x, y)
        rays = cameralib.generate_rays(scene.camera, settings, x, y, rx, ry,
                                       rng_state=state)
        # camera_check compares each lane's pixel with its reprojection
        color = (fn(scene, settings, rays, state, tabs,
                    pixel=y * settings.width + x)
                 if tech == "camera_check"
                 else fn(scene, settings, rays, state, tabs))
        acc = color if acc is None else acc + color
    return acc


class SimpleProgram(Program):
    """sample_lanes for the lanes x, y as one program ("shade") over a
    [3, n] result buffer: a step is one replay and reads no flag (but the
    instanced pairs' overflow flag)."""

    def __init__(self, scene: SceneData, settings: RenderSettings,
                 tabs: RenderTables, x, y, pool=None):
        super().__init__(scene, settings, tabs, 0, pool)
        self.x, self.y = x, y
        self.out = torch.zeros((3, x.shape[0]), dtype=torch.float32,
                               device=self.device)

    def _keys(self) -> list:
        return [("shade", 0)]

    def _program(self, key) -> None:
        self.out.copy_(torch.stack(tuple(sample_lanes(
            self.scene, self.settings, self.tabs, self.x, self.y,
            self.iteration, self.frame))))

    def _sequence(self) -> Color:
        self._call(("shade", 0))
        return Color(*self.out.unbind(0))
