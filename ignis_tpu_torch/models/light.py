"""Light sampling / evaluation with masked kind dispatch.

Port of ignis_tpu/models/light.py: point, spot, directional, area (over
triangles by the area CDF, or an analytic sphere), sun, and environment
lights, constant or textured with an importance table (conditional CDF,
summed-area table or mip pyramid, core/cdf.py); the uniform, flux-CDF
(`cdf`) and light-hierarchy selectors; emission sampling for the light
tracer and the photon pass (`sample_emission`). `settings.light_kinds`
prunes absent kinds statically.

Pdf convention (reference driver/light.art Pdf): every direct sample
carries (pdf_value, pdf_is_area); solid = value * dist^2 / cos for area
measure, value otherwise.

No host sync: the hierarchy walks run a fixed number of masked steps, the
tree's depth, which `hier_depth` reads once per render.
"""
from __future__ import annotations

from enum import IntEnum
from typing import NamedTuple

import numpy as np
import torch

from ..core.cdf import (CDF2D, SAT2D, Hier2D, pdf_cdf_2d, pdf_hier_2d,
                        pdf_sat_2d, sample_cdf_2d, sample_hier_2d,
                        sample_sat_2d)
from ..core.frame import make_frame
from ..core.vec import (Color, Vec2, Vec3, cselect, cross, dot, length,
                        safe_div, vselect)
from ..core.warp import (INV_4PI, PI, TWO_PI, dir_from_spherical,
                         sample_cosine_hemisphere, sample_triangle,
                         sample_uniform_cone, sample_uniform_sphere,
                         spherical_from_dir, square_to_concentric_disk,
                         uniform_cone_pdf)
from ..scenedata import EnvMap, Lights, SceneData

FLT_MAX = 3.0e38


class LightKind(IntEnum):
    POINT = 0
    SPOT = 1
    DIRECTIONAL = 2
    AREA = 3
    ENV = 4        # constant (tex = -1) or textured
    SUN = 5


ALL_KINDS = tuple(int(k) for k in LightKind)


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


def _kinds(kinds):
    return ALL_KINDS if kinds is None else tuple(int(x) for x in kinds)


# ---------------------------------------------------------------------------
# Direct-connection sampling (NEE)
# ---------------------------------------------------------------------------

def sample_direct(scene: SceneData, lp: LightParams, from_point: Vec3,
                  from_entering, u0, u1, eval_texture=None,
                  kinds=None) -> DirectSample:
    """`kinds` (settings.light_kinds) prunes absent kinds statically;
    `from_entering` orients an area light's cosine."""
    one = torch.ones_like(lp.p0)
    zero = torch.zeros_like(lp.p0)
    kinds = _kinds(kinds)
    branches = []
    if LightKind.POINT in kinds or LightKind.SPOT in kinds:
        to_l = lp.pos - from_point
        dist = length(to_l)
        pdir = to_l * safe_div(1.0, dist)
        if LightKind.POINT in kinds:
            branches.append((LightKind.POINT, DirectSample(
                lp.pos, pdir, lp.intensity, one, one > 0, one, dist)))
        if LightKind.SPOT in kinds:
            cos_cut, cos_fall = lp.p0, lp.p1
            blend = cos_fall - cos_cut
            cos_angle = dot(-pdir, lp.dir)
            tfac = torch.clamp(safe_div(cos_angle - cos_cut, blend), 0.0, 1.0)
            sfac = torch.where(blend <= 1e-6,
                               torch.where(cos_angle <= cos_cut, 0.0, 1.0),
                               tfac * tfac * (3.0 - 2.0 * tfac))
            branches.append((LightKind.SPOT, DirectSample(
                lp.pos, pdir, lp.intensity * sfac,
                torch.where(cos_angle > cos_cut, 1.0, 0.0), one > 0,
                -dot(pdir, lp.dir), dist)))
    if LightKind.DIRECTIONAL in kinds or LightKind.SUN in kinds:
        # lp.dir is the direction light -> scene
        ddir = -lp.dir
        far = 2.0 * scene.scene_radius
        if LightKind.DIRECTIONAL in kinds:
            branches.append((LightKind.DIRECTIONAL, DirectSample(
                from_point + ddir * far, ddir, lp.intensity, one, zero > 1,
                one, far.expand(lp.p0.shape))))
        if LightKind.SUN in kinds:
            # uniform cone around -dir with cos_angle p0 (sun.art)
            cdir_l, cpdf = sample_uniform_cone(u0, u1, lp.p0)
            sdir = make_frame(ddir).to_world(cdir_l)
            branches.append((LightKind.SUN, DirectSample(
                from_point + sdir * far, sdir,
                lp.intensity * safe_div(1.0, cpdf), cpdf, zero > 1, one,
                far.expand(lp.p0.shape))))
    if LightKind.AREA in kinds:
        branches.append((LightKind.AREA, _sample_area_direct(
            scene, lp, from_point, from_entering, u0, u1)))
    if LightKind.ENV in kinds:
        branches.append((LightKind.ENV, _sample_env_direct(
            scene, lp, from_point, u0, u1, eval_texture)))

    if not branches:
        z3 = Vec3(zero, zero, zero)
        return DirectSample(z3, z3, Color(zero, zero, zero), zero, zero > 1,
                            zero, one)

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


def sample_area_point(scene: SceneData, lp: LightParams, u0, u1):
    """Uniform-by-area point on an area light: (pos, face_normal). Lights
    over triangles search the concatenated area CDF (entries of light row
    r lie in (r, r + 1]); sphere lights sample the surface uniformly."""
    lights = scene.lights
    cdf = lights.area_cdf
    n = cdf.shape[0]
    uc = torch.clamp(u0, 0.0, 0.999999)
    key = lp.p1 + uc          # p1 holds the light's own row
    pos = torch.clamp(torch.searchsorted(cdf, key, right=True), 0,
                      max(n - 1, 0))
    hi_v = cdf[pos]
    row = torch.ceil(hi_v) - 1.0
    lo = torch.where(pos > 0, torch.clamp(
        cdf[torch.clamp(pos - 1, min=0)] - row, 0.0, 1.0), 0.0)
    hi = torch.clamp(hi_v - row, 0.0, 1.0)
    seg = hi - lo
    ur = torch.where(seg > 0, (uc - lo) / torch.where(seg > 0, seg, 1.0),
                     0.0)
    tri = lights.area_tris[pos].long()
    tris = scene.tris
    v0 = Vec3(*[c[tri] for c in tris.v0])
    e1 = Vec3(*[c[tri] for c in tris.e1])
    e2 = Vec3(*[c[tri] for c in tris.e2])
    bu, bv = sample_triangle(torch.clamp(ur, 0.0, 1.0), u1)
    p = v0 + e1 * bu + e2 * bv
    fn = cross(e1, e2)
    face_n = fn * safe_div(1.0, length(fn))
    # analytic-sphere emitter (tri_count == 0): uniform surface point
    is_sphere = lp.tri_count == 0
    sdir, _ = sample_uniform_sphere(u0, u1)
    return (vselect(is_sphere, lp.pos + sdir * lp.p2, p),
            vselect(is_sphere, sdir, face_n))


def _sample_area_direct(scene: SceneData, lp: LightParams, from_point: Vec3,
                        from_entering, u0, u1) -> DirectSample:
    p, face_n = sample_area_point(scene, lp, u0, u1)
    to_l = p - from_point
    dist = length(to_l)
    d = to_l * safe_div(1.0, dist)
    # area.art: cos = dot(dir, face_normal) * (entering ? -1 : 1)
    cos = dot(d, face_n) * torch.where(from_entering, -1.0, 1.0)
    # intensity already divided by the sample pdf (1 / total area)
    return DirectSample(p, d, lp.intensity * lp.p0, safe_div(1.0, lp.p0),
                        torch.ones_like(dist) > 0, cos, dist)


# -- env ---------------------------------------------------------------------

def env_method(envmap: EnvMap):
    """Which importance table the scene carries, from its shapes alone:
    'hierachical', 'sat', 'conditional' or None."""
    if envmap is None:
        return None
    if len(envmap.hier_levels) > 0:
        return "hierachical"
    if envmap.sat_grid.shape[0] > 1 or envmap.sat_grid.shape[1] > 1:
        return "sat"
    if envmap.conditional.shape[0] > 1 or envmap.conditional.shape[1] > 1:
        return "conditional"
    return None


def _env_uv_from_dir(local_dir: Vec3) -> Vec2:
    """(env.art map_env_uv) for a direction already in env space."""
    theta, phi = spherical_from_dir(local_dir)
    u = torch.remainder(phi / TWO_PI + 0.25, 1.0)
    return Vec2(u, 1.0 - theta / PI)


def _switch_env_up(v: Vec3) -> Vec3:
    return Vec3(v.x, v.z, v.y)


def _env_sample_uv(envmap: EnvMap, u0, u1):
    m = env_method(envmap)
    if m == "hierachical":
        return sample_hier_2d(Hier2D(envmap.hier_levels), u0, u1)
    if m == "sat":
        return sample_sat_2d(SAT2D(envmap.sat_table, envmap.sat_grid), u0, u1)
    return sample_cdf_2d(CDF2D(envmap.marginal, envmap.conditional), u0, u1)


def _env_pdf_uv(envmap: EnvMap, x, y):
    m = env_method(envmap)
    if m == "hierachical":
        return pdf_hier_2d(Hier2D(envmap.hier_levels), x, y)
    if m == "sat":
        return pdf_sat_2d(SAT2D(envmap.sat_table, envmap.sat_grid), x, y)
    return pdf_cdf_2d(CDF2D(envmap.marginal, envmap.conditional), x, y)


def _sin_theta(ld: Vec3):
    """sqrt(max(1 - z^2, 0)) with a finite slope at the poles."""
    s2 = 1.0 - ld.z * ld.z
    pos = s2 > 0.0
    return torch.where(pos, torch.sqrt(torch.where(pos, s2, 1.0)), 0.0)


def _sample_env_direct(scene: SceneData, lp: LightParams, from_point: Vec3,
                       u0, u1, eval_texture) -> DirectSample:
    radius = scene.scene_radius * 1.01
    # constant env: uniform sphere (env.art spherical variant)
    d, _ = sample_uniform_sphere(u0, u1)
    intens = lp.intensity * (1.0 / INV_4PI)
    pdf = torch.full_like(lp.p0, INV_4PI)
    method = env_method(scene.envmap)
    if eval_texture is not None and method is None:
        # textured env without an importance table: uniform directions
        # weighted by the texture along them
        tex_col = eval_texture(lp.tex, _env_uv_from_dir(_switch_env_up(d)))
        intens = cselect(lp.tex >= 0,
                         tex_col.cmul(lp.intensity) * (1.0 / INV_4PI), intens)
    if eval_texture is not None and method is not None:
        x, y, p2 = _env_sample_uv(scene.envmap, u0, u1)
        ld = dir_from_spherical((1.0 - y) * PI, (x - 0.25) * TWO_PI)
        pdf_dir = safe_div(p2, _sin_theta(ld) * PI * PI * 2.0)
        tex_col = eval_texture(lp.tex, Vec2(x, y))
        use_tex = lp.tex >= 0
        d = vselect(use_tex, _switch_env_up(ld), d)
        intens = cselect(use_tex,
                         tex_col.cmul(lp.intensity) * safe_div(1.0, pdf_dir),
                         intens)
        pdf = torch.where(use_tex, pdf_dir, pdf)
    return DirectSample(from_point + d * radius, d, intens, pdf,
                        torch.zeros_like(lp.delta), torch.ones_like(lp.p0),
                        radius.expand(lp.p0.shape).contiguous())


def env_emission(scene: SceneData, lp: LightParams, ray_dir: Vec3,
                 eval_texture=None, kinds=None) -> Color:
    """Radiance of an infinite light for a ray escaping along ray_dir; the
    sun's disk is tested only when `kinds` has a sun."""
    out = lp.intensity
    if eval_texture is not None:
        tex_col = eval_texture(lp.tex,
                               _env_uv_from_dir(_switch_env_up(ray_dir)))
        out = cselect(lp.tex >= 0, tex_col.cmul(lp.intensity), out)
    z = torch.zeros_like(lp.p0)
    res = cselect(lp.kind == LightKind.ENV, out, Color(z, z, z))
    if LightKind.SUN in _kinds(kinds):
        # sun disk (sun.art emission): radiance inside the cone
        in_cone = dot(ray_dir, -lp.dir) >= lp.p0
        is_sun = (lp.kind == LightKind.SUN) & ~lp.delta
        res = cselect(is_sun & in_cone, lp.intensity, res)
    return res


def env_pdf_direct(scene: SceneData, lp: LightParams, ray_dir: Vec3,
                   kinds=None, textured=True):
    """Solid-angle pdf of sampling ray_dir through sample_direct (MIS).
    Without `textured` the rows are known to hold no texture, and the
    importance table is not read."""
    pdf = torch.full_like(lp.p0, INV_4PI)
    if textured and env_method(scene.envmap) is not None:
        ld = _switch_env_up(ray_dir)
        uv = _env_uv_from_dir(ld)
        p2 = _env_pdf_uv(scene.envmap, uv.x, uv.y)
        pdf_tex = safe_div(p2, _sin_theta(ld) * PI * PI * 2.0)
        pdf = torch.where(lp.tex >= 0, pdf_tex, pdf)
    if LightKind.SUN in _kinds(kinds):
        in_cone = dot(ray_dir, -lp.dir) >= lp.p0
        pdf = torch.where(lp.kind == LightKind.SUN,
                          torch.where(in_cone, uniform_cone_pdf(lp.p0), 0.0),
                          pdf)
    return pdf


# ---------------------------------------------------------------------------
# Light selection (uniform, flux CDF, hierarchy; light_selector.art)
# ---------------------------------------------------------------------------

def select_uniform(n_lights: int, u):
    idx = torch.clamp((u * n_lights).to(torch.int32), 0, max(n_lights - 1, 0))
    return idx, torch.full_like(u, 1.0 / max(n_lights, 1))


def select_cdf(lights: Lights, u):
    """Flux-weighted selection by the select_cdf table (LoaderLight.cpp
    estimated powers)."""
    cdf = lights.select_cdf
    idx = torch.clamp(torch.searchsorted(cdf, u, right=True), 0,
                      cdf.shape[0] - 1)
    pdf = cdf[idx] - torch.where(idx > 0, cdf[torch.clamp(idx - 1, min=0)],
                                 0.0)
    return idx.to(torch.int32), pdf


def hier_depth(lights: Lights) -> int:
    """Depth of the light hierarchy (steps from the root to the deepest
    leaf), read on the host: the trip count of the hierarchy walks."""
    child = lights.hier_child.detach().cpu().numpy()
    if child.size == 0:
        return 0
    depth = np.zeros(child.shape[0], np.int64)
    best = 0
    for i in range(child.shape[0]):   # children follow their parent
        if child[i] < 0:
            left = -int(child[i]) - 1
            depth[left] = depth[left + 1] = depth[i] + 1
            best = max(best, depth[i] + 1)
    return int(best)


def _hier_cost(lights: Lights, idx, pos: Vec3):
    """Importance of a hierarchy entry from pos (light_hierarchy.art
    get_entry_cost: flux * cos / dist^2)."""
    ex = lights.hier_pos.x[idx] - pos.x
    ey = lights.hier_pos.y[idx] - pos.y
    ez = lights.hier_pos.z[idx] - pos.z
    dist2 = torch.clamp(ex * ex + ey * ey + ez * ez, min=1e-9)
    inv_l = 1.0 / torch.sqrt(dist2)
    cos_d = torch.abs((lights.hier_dir.x[idx] * ex
                       + lights.hier_dir.y[idx] * ey
                       + lights.hier_dir.z[idx] * ez) * inv_l)
    cos_d = torch.where(lights.hier_has_dir[idx], cos_d, 1.0)
    return safe_div(lights.hier_flux[idx] * cos_d, dist2)


def _hier_left_prob(lights: Lights, left, right, pos: Vec3):
    cl = _hier_cost(lights, left, pos)
    cr = _hier_cost(lights, right, pos)
    return torch.clamp(
        safe_div(1.0, 1.0 + safe_div(cr, torch.clamp(cl, min=1e-30))),
        1e-4, 1.0 - 1e-4)


def select_hierarchy(lights: Lights, u, pos: Vec3, depth: int):
    """Stochastic top-down traversal (light_hierarchy.art
    sample_light_id): `depth` masked steps, the uniform rescaled at every
    split."""
    idx = torch.zeros_like(u, dtype=torch.int64)
    pdf = torch.ones_like(u)
    uu = u
    for _ in range(depth):
        child = lights.hier_child[idx].long()
        inner = child < 0
        left = torch.where(inner, -child - 1, idx)
        pl = _hier_left_prob(lights, left, left + 1, pos)
        go_left = uu < pl
        uu2 = torch.clamp(torch.where(go_left, uu / pl,
                                      (uu - pl) / (1.0 - pl)),
                          0.0, 1.0 - 1e-7)
        pdf = torch.where(inner, pdf * torch.where(go_left, pl, 1.0 - pl),
                          pdf)
        idx = torch.where(inner, torch.where(go_left, left, left + 1), idx)
        uu = torch.where(inner, uu2, uu)
    return lights.hier_child[idx], pdf


def hierarchy_pdf(lights: Lights, light_row, pos: Vec3, depth: int):
    """Deterministic re-descent along the light's path code
    (light_hierarchy.art compute_pdf), `depth` masked steps."""
    code = lights.hier_code[torch.clamp(light_row, min=0).long()].long()
    idx = torch.zeros_like(code)
    level = torch.zeros_like(code)
    pdf = torch.ones(code.shape, dtype=torch.float32, device=code.device)
    for _ in range(depth):
        child = lights.hier_child[idx].long()
        inner = child < 0
        left = torch.where(inner, -child - 1, idx)
        pl = _hier_left_prob(lights, left, left + 1, pos)
        go_left = ((code >> level) & 1) == 0
        pdf = torch.where(inner, pdf * torch.where(go_left, pl, 1.0 - pl),
                          pdf)
        idx = torch.where(inner, torch.where(go_left, left, left + 1), idx)
        level = level + inner.to(level.dtype)
    return pdf


def _hierarchy_available(settings, lights: Lights) -> bool:
    return (settings.light_selector == "hierarchy"
            and lights.hier_child.shape[0] > 0 and settings.n_lights > 0)


def _cdf_available(settings, lights: Lights) -> bool:
    return (settings.light_selector == "cdf"
            and lights.select_cdf.shape[0] == settings.n_lights)


def select_light(settings, lights: Lights, u, pos: Vec3 = None,
                 depth: int = None):
    """(light row, selection pdf) per lane. `depth` is hier_depth(lights),
    read here when not given."""
    if _hierarchy_available(settings, lights):
        if depth is None:
            depth = hier_depth(lights)
        n_inf = len(settings.infinite_light_rows)
        if pos is None:
            z = torch.zeros_like(u)
            pos = Vec3(z, z, z)
        if n_inf == 0:
            idx, pdf = select_hierarchy(lights, u, pos, depth)
            return idx.to(torch.int32), pdf
        if n_inf >= settings.n_lights:
            return select_uniform(settings.n_lights, u)
        # 50/50 infinite / finite split (light_selector.art:91)
        ratio = 0.5
        pick_inf = u < ratio
        u_inf = torch.clamp(u / ratio, 0.0, 1.0 - 1e-7)
        u_fin = torch.clamp((u - ratio) / (1.0 - ratio), 0.0, 1.0 - 1e-7)
        inf_rows = torch.tensor(settings.infinite_light_rows,
                                dtype=torch.int32, device=u.device)
        i_idx = inf_rows[torch.clamp((u_inf * n_inf).to(torch.int64), 0,
                                     n_inf - 1)]
        h_idx, h_pdf = select_hierarchy(lights, u_fin, pos, depth)
        return (torch.where(pick_inf, i_idx, h_idx.to(torch.int32)),
                torch.where(pick_inf, ratio / n_inf, h_pdf * (1.0 - ratio)))
    if _cdf_available(settings, lights):
        return select_cdf(lights, u)
    return select_uniform(settings.n_lights, u)


def infinite_selector_pdf(settings, lights: Lights, row: int, rows):
    """selector_pdf of `rows`, all holding infinite light row `row`: under
    the hierarchy selector a constant (the infinite half split evenly),
    so no walk runs."""
    n_inf = len(settings.infinite_light_rows)
    if (_hierarchy_available(settings, lights)
            and n_inf < settings.n_lights):
        return 0.5 / n_inf
    return selector_pdf(settings, lights, rows)


def selector_pdf(settings, lights: Lights, light_row, pos: Vec3 = None,
                 depth: int = None):
    """Selection pdf of the light rows `light_row` (MIS on emission hits
    and env misses)."""
    uniform = torch.full(light_row.shape, 1.0 / max(settings.n_lights, 1),
                         dtype=torch.float32, device=light_row.device)
    if _hierarchy_available(settings, lights):
        if depth is None:
            depth = hier_depth(lights)
        n_inf = len(settings.infinite_light_rows)
        if n_inf >= settings.n_lights:
            return uniform
        if pos is None:
            z = torch.zeros(light_row.shape, dtype=torch.float32,
                            device=light_row.device)
            pos = Vec3(z, z, z)
        h_pdf = hierarchy_pdf(lights, light_row, pos, depth)
        if n_inf == 0:
            return h_pdf
        is_inf = lights.infinite[torch.clamp(light_row, min=0).long()]
        return torch.where(is_inf, 0.5 / n_inf, h_pdf * 0.5)
    if _cdf_available(settings, lights):
        idx = torch.clamp(light_row, 0, settings.n_lights - 1).long()
        cdf = lights.select_cdf
        return cdf[idx] - torch.where(idx > 0,
                                      cdf[torch.clamp(idx - 1, min=0)], 0.0)
    return uniform


# ---------------------------------------------------------------------------
# Emission sampling (light tracer, photon pass)
# ---------------------------------------------------------------------------

class EmissionSample(NamedTuple):
    pos: Vec3
    dir: Vec3
    intensity: Color   # divided by (pdf_area * pdf_dir)
    cos: torch.Tensor  # cosine at the light


def sample_emission(scene: SceneData, lp: LightParams, u0, u1, u2, u3,
                    kinds=None) -> EmissionSample:
    """A point and a direction of emission on each lane's light (light.art
    sample_emission; ignis_tpu/models/light.py:571-657), for every kind in
    `kinds` (settings.light_kinds; all when None). A textured env emits
    its constant scale, as in the JAX package. The spot's photon weight is
    I(dir) / pdf_cone, its cos_axis in `cos`: the JAX package drops the
    reference's division by the spot's area (which dims spot photons
    about 2x against its own path tracer), and so does the port."""
    kinds = _kinds(kinds)
    one = torch.ones_like(lp.p0)
    zero = torch.zeros_like(lp.p0)
    radius = scene.scene_radius * 1.01
    center = scene.scene_center
    sdir, spdf = sample_uniform_sphere(u2, u3)
    cdirl, cpdf = sample_uniform_cone(u2, u3, lp.p0)
    dpos_pdf = safe_div(1.0, PI * radius * radius)
    disk = square_to_concentric_disk(u0, u1)
    # the disk's frame is the env direction's for all three infinite kinds,
    # as in the JAX package
    dframe = make_frame(-sdir)

    def boundary_pos(d):
        # a point of the disk across the bounding sphere, facing d
        off = dframe.to_world(Vec3(disk.x * radius, disk.y * radius, zero))
        return Vec3(center.x - d.x * radius + off.x,
                    center.y - d.y * radius + off.y,
                    center.z - d.z * radius + off.z)

    branches = []
    if LightKind.POINT in kinds:
        branches.append((LightKind.POINT, EmissionSample(
            lp.pos, sdir, lp.intensity * safe_div(1.0, spdf), one)))
    if LightKind.SPOT in kinds:
        sp_dir = make_frame(lp.dir).to_world(cdirl)
        blend = lp.p1 - lp.p0
        cosang = dot(sp_dir, lp.dir)
        tfac = torch.clamp(safe_div(cosang - lp.p0, blend), 0.0, 1.0)
        sfac = torch.where(blend <= 1e-6,
                           torch.where(cosang <= lp.p0, 0.0, 1.0),
                           tfac * tfac * (3.0 - 2.0 * tfac))
        branches.append((LightKind.SPOT, EmissionSample(
            lp.pos, sp_dir, lp.intensity * (sfac * safe_div(1.0, cpdf)),
            cdirl.z)))
    if LightKind.AREA in kinds:
        a_pos, a_n = sample_area_point(scene, lp, u0, u1)
        hdir, hpdf = sample_cosine_hemisphere(u2, u3)
        # weight 1 / (area pdf * cosine pdf) = total area / cosine pdf
        branches.append((LightKind.AREA, EmissionSample(
            a_pos, make_frame(a_n).to_world(hdir),
            lp.intensity * (lp.p0 * safe_div(1.0, hpdf)), hdir.z)))
    if LightKind.ENV in kinds:
        env_dir = -sdir   # inwards
        branches.append((LightKind.ENV, EmissionSample(
            boundary_pos(env_dir), env_dir,
            lp.intensity * safe_div(1.0, spdf * dpos_pdf), one)))
    if LightKind.SUN in kinds:
        scone = make_frame(lp.dir).to_world(cdirl)
        branches.append((LightKind.SUN, EmissionSample(
            boundary_pos(scone), scone,
            lp.intensity * safe_div(1.0, cpdf * dpos_pdf), cdirl.z)))
    if LightKind.DIRECTIONAL in kinds:
        branches.append((LightKind.DIRECTIONAL, EmissionSample(
            boundary_pos(lp.dir), lp.dir,
            lp.intensity * safe_div(1.0, dpos_pdf), one)))
    if not branches:
        z3 = Vec3(zero, zero, zero)
        return EmissionSample(z3, z3, Color(zero, zero, zero), zero)

    def sel(kv, e, cur):
        m = lp.kind == kv
        return EmissionSample(vselect(m, e.pos, cur.pos),
                              vselect(m, e.dir, cur.dir),
                              cselect(m, e.intensity, cur.intensity),
                              torch.where(m, e.cos, cur.cos))

    # the JAX order of selection: point first, directional last
    out = branches[0][1]
    for kv, e in branches[1:]:
        out = sel(kv, e, out)
    return out
