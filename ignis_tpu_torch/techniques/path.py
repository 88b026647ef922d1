"""Unidirectional path tracer with NEE + MIS + Russian roulette.

Port of the forward path of ignis_tpu/techniques/path.py: the wavefront
advances all lanes one bounce at a time with masked selects; every bounce
does one closest-hit traversal and one shadow any-hit traversal, through
K1 (ops/bvh_cuda.py) for scenes with a BVH and K2 (ops/isect_cuda.py)
otherwise. Dead lanes regenerate the next sample of their pixel, and the
compacting cascade (`render_lanes`) folds finished lanes into the film by
original lane id and continues on the survivors.

MIS is the balance heuristic in the reference's inverse-pdf form:
  hit:  w = 1 / (1 + inv_bsdf_pdf * light_select_pdf * light_pdf_solid)
  nee:  w = 1 / (1 + bsdf_pdf / light_pdf_solid)
Russian roulette is the max-component rule on contrib*eta^2, clamped to
[0.05, 0.95], active after min_depth.

Reverse mode runs through the same bounce (`render_lanes(remat=True)`,
the JAX package's path_trace_cascade_diff): closest hits through the K1/K2
fixed-winner backward (ops/mt_replay.py), the hit-attribute fetch through
K3 (ops/gather.py) and its scatter-add backward, bounces checkpointed in
chunks of DIFF_CHUNK.

Not carried yet: transparent shadows, textures and normal maps, blends,
instancing and other techniques.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from ..core import rng as rnglib
from ..core.frame import Frame, make_frame
from ..core.sampler import sample_pixel_offsets
from ..core.vec import (Color, Vec2, Vec3, black_like, color_max_component,
                        cross, cselect, dot, length, normalize, safe_div,
                        saturate, vselect, white_like)
from ..core.warp import PI, TWO_PI, spherical_from_dir
from ..models import bsdf as bsdflib
from ..models import camera as cameralib
from ..models import light as lightlib
from ..ops import bvh_cuda, isect_cuda
from ..ops import gather as gatherlib
from ..ops import intersect as isect
from ..ops.intersect import FLT_MAX, Hit, Rays
from ..scenedata import RenderSettings, SceneData, tree_map

OFFSET = 1e-3
ATTR_COLS = 22   # the hit attributes in attr_table
MIN_BUCKET = 4096
SHRINK = 4       # bucket shrink factor per cascade stage
DIFF_CHUNK = 8   # bounces per checkpointed chunk of the differentiable render


class Surface(NamedTuple):
    point: Vec3
    face_n: Vec3     # oriented towards the ray
    ns: Vec3         # shading normal, oriented towards the ray
    uv: Vec2
    is_entering: torch.Tensor
    ent: torch.Tensor
    tu: Vec3         # dP/du per face, zero when degenerate
    tv: Vec3


def trace_scene(scene: SceneData, rays: Rays, tri_rows=None) -> Hit:
    """Closest hit: BVH (K1) or dense (K2) triangles, then spheres.
    `tri_rows` is K1's packing of the soup (tri_rows_of), or None."""
    if scene.bvh is not None:
        h = bvh_cuda.intersect_bvh(rays, scene.tris, scene.bvh,
                                   tri_rows=tri_rows)
    else:
        h = isect_cuda.intersect_tris(rays, scene.tris)
    hs = isect.intersect_spheres_dense(rays, scene.spheres,
                                       scene.tris.v0.x.shape[0])
    return isect.merge_hits(h, hs)


def occluded_scene(scene: SceneData, rays: Rays,
                   tri_rows=None) -> torch.Tensor:
    """Any hit on a shadow-visible primitive."""
    vis = scene.tri_attr.shadow_visible
    if scene.bvh is not None:
        occ = bvh_cuda.intersect_bvh(rays, scene.tris, scene.bvh,
                                     any_hit=True, shadow_visible=vis,
                                     tri_rows=tri_rows)
    else:
        occ = isect_cuda.intersect_tris(rays, scene.tris, vis, any_hit=True)
    if scene.spheres.radius.shape[0] > 0:
        # sphere visibility is applied to the closest sphere hit
        h = isect.intersect_spheres_dense(rays, scene.spheres, 0)
        svis = scene.sph_attr.shadow_visible[torch.clamp(h.prim, min=0).long()]
        occ = occ | ((h.prim >= 0) & svis)
    return occ


def tri_rows_of(scene: SceneData):
    """K1's packed triangle rows of the scene's current soup
    (bvh_cuda.pack_tris), or None for a scene without a BVH."""
    return None if scene.bvh is None else bvh_cuda.pack_tris(scene.tris)


def attr_table(scene: SceneData) -> torch.Tensor:
    """The [T, 24] f32 table of per-triangle hit attributes: ATTR_COLS
    columns in the column order of the JAX hit shader (path.py:321-327),
    e1, e2, n0, n1, n2 (xyz each), uv0, uv1, uv2 (xy each), then the
    entity id as f32, and two zero columns, so that a row is 96 bytes of
    whole 16-byte words (gatherlib.stack_cols)."""
    ta = scene.tri_attr
    return gatherlib.stack_cols([*scene.tris.e1, *scene.tris.e2, *ta.n0,
                                 *ta.n1, *ta.n2, *ta.uv0, *ta.uv1, *ta.uv2,
                                 ta.ent])


def compute_surface(scene: SceneData, rays: Rays, hit: Hit,
                    tab: torch.Tensor = None) -> Surface:
    """Hit attributes through one row gather of `tab` (attr_table, K3)
    into contiguous columns; the table is built here when none is
    given."""
    n_tri = scene.tris.v0.x.shape[0]
    prim = torch.clamp(hit.prim, min=0)
    is_tri = prim < n_tri
    tp = torch.clamp(prim, 0, n_tri - 1)

    def g3(v, i):
        return Vec3(v.x[i], v.y[i], v.z[i])

    if tab is None:
        tab = attr_table(scene)
    (e1x, e1y, e1z, e2x, e2y, e2z, n0x, n0y, n0z, n1x, n1y, n1z,
     n2x, n2y, n2z, uv0x, uv0y, uv1x, uv1y, uv2x, uv2y,
     entf) = gatherlib.gather_block(tp, tab, ATTR_COLS).unbind(0)
    e1 = Vec3(e1x, e1y, e1z)
    e2 = Vec3(e2x, e2y, e2z)
    fn = cross(e1, e2)
    face_n = fn * safe_div(1.0, length(fn))
    u, v = hit.u, hit.v
    w = 1.0 - u - v
    n0, n1, n2 = Vec3(n0x, n0y, n0z), Vec3(n1x, n1y, n1z), Vec3(n2x, n2y, n2z)
    ns = normalize(Vec3(n0.x * w + n1.x * u + n2.x * v,
                        n0.y * w + n1.y * u + n2.y * v,
                        n0.z * w + n1.z * u + n2.z * v))
    uv0, uv1, uv2 = Vec2(uv0x, uv0y), Vec2(uv1x, uv1y), Vec2(uv2x, uv2y)
    uv = Vec2(uv0.x * w + uv1.x * u + uv2.x * v,
              uv0.y * w + uv1.y * u + uv2.y * v)
    ent = torch.round(entf).to(torch.int32)

    du1 = uv1.x - uv0.x
    dv1 = uv1.y - uv0.y
    du2 = uv2.x - uv0.x
    dv2 = uv2.y - uv0.y
    det_uv = du1 * dv2 - dv1 * du2
    ok_uv = torch.abs(det_uv) > 1e-12
    inv_det = torch.where(ok_uv, 1.0 / torch.where(ok_uv, det_uv, 1.0), 0.0)
    tu = Vec3((e1.x * dv2 - e2.x * dv1) * inv_det,
              (e1.y * dv2 - e2.y * dv1) * inv_det,
              (e1.z * dv2 - e2.z * dv1) * inv_det)
    tv = Vec3((e2.x * du1 - e1.x * du2) * inv_det,
              (e2.y * du1 - e1.y * du2) * inv_det,
              (e2.z * du1 - e1.z * du2) * inv_det)

    # Miss lanes carry t = FLT_MAX; clamp so inf*0 cannot make NaNs (the
    # lanes are masked out anyway).
    t_safe = torch.where(hit.prim >= 0, hit.t, 1.0)
    point = rays.org + rays.dir * t_safe

    n_sph = scene.spheres.radius.shape[0]
    if n_sph > 0:
        sp = torch.clamp(prim - n_tri, 0, n_sph - 1).long()
        sn = normalize(point - g3(scene.spheres.center, sp))
        theta, phi = spherical_from_dir(sn)
        face_n = vselect(is_tri, face_n, sn)
        ns = vselect(is_tri, ns, sn)
        uv = Vec2(torch.where(is_tri, uv.x, phi / TWO_PI),
                  torch.where(is_tri, uv.y, theta / PI))
        ent = torch.where(is_tri, ent, scene.sph_attr.ent[sp])
        z = torch.zeros_like(uv.x)
        zero = Vec3(z, z, z)
        tu = vselect(is_tri, tu, zero)
        tv = vselect(is_tri, tv, zero)

    is_entering = dot(rays.dir, face_n) <= 0.0
    flip = torch.where(is_entering, 1.0, -1.0)
    return Surface(point, face_n * flip, ns * flip, uv, is_entering, ent,
                   tu, tv)


def shading_frame(surf: Surface) -> Frame:
    """Shading-normal frame with UV-aligned tangents when the surface has
    them, ONB fallback otherwise."""
    fr = make_frame(surf.ns)
    ns = surf.ns
    proj = dot(ns, surf.tu)
    t = Vec3(surf.tu.x - ns.x * proj, surf.tu.y - ns.y * proj,
             surf.tu.z - ns.z * proj)
    tl2 = dot(t, t)
    ok = tl2 > 1e-16
    t = t * (1.0 / torch.sqrt(torch.clamp(tl2, min=1e-30)))
    b0 = cross(ns, t)
    b = b0 * torch.where(dot(b0, surf.tv) < 0.0, -1.0, 1.0)
    return Frame(vselect(ok, t, fr.t), vselect(ok, b, fr.b), ns)


def gather_material(scene: SceneData, surf: Surface) -> bsdflib.MatParams:
    m = scene.materials
    mid = scene.entities.mat[torch.clamp(surf.ent, min=0).long()].long()

    def gc(c):
        return Color(c.r[mid], c.g[mid], c.b[mid])
    return bsdflib.MatParams(kind=m.kind[mid], base=gc(m.base),
                             extra=gc(m.extra), extra2=gc(m.extra2),
                             p0=m.p0[mid], p1=m.p1[mid], p2=m.p2[mid],
                             p3=m.p3[mid])


class PathState(NamedTuple):
    org: Vec3
    dir: Vec3
    tmin: torch.Tensor
    tmax: torch.Tensor
    rng: torch.Tensor      # uint32 values in int64
    contrib: Color
    inv_pdf: torch.Tensor
    eta: torch.Tensor
    alive: torch.Tensor
    result: Color
    depth: torch.Tensor    # current path depth (camera segment = 1)
    sample: torch.Tensor   # per-lane sample counter (regeneration)


def _handle_color(c: Color, settings: RenderSettings) -> Color:
    if settings.clamp > 0:
        return saturate(c, settings.clamp)
    return c


def _cadd_where(m, acc: Color, c: Color) -> Color:
    return Color(acc.r + torch.where(m, c.r, 0.0),
                 acc.g + torch.where(m, c.g, 0.0),
                 acc.b + torch.where(m, c.b, 0.0))


def check_settings(settings: RenderSettings, scene: SceneData) -> None:
    """Raise for anything the port does not carry yet."""
    if settings.technique not in ("path", "pt"):
        raise NotImplementedError(
            f"technique '{settings.technique}' is not ported yet (ROADMAP "
            "queue 1, items 12 and 14)")
    if settings.transparent_shadows:
        raise NotImplementedError(
            "transparent shadows are not ported yet (ROADMAP queue 1, "
            "item 12)")
    if settings.has_blend or settings.has_bump or settings.texture_descs:
        raise NotImplementedError(
            "blends, normal maps and textures are not ported yet (ROADMAP "
            "queue 1, items 6 and 7)")
    bsdflib.check_kinds(settings.bsdf_kinds)
    lightlib.check_lights(settings, scene)


def make_bounce(scene: SceneData, settings: RenderSettings,
                tab: torch.Tensor, regen=None, rows=None):
    """Per-bounce wavefront step; `tab` is the scene's attr_table and
    `rows` its tri_rows_of. With `regen` = (x, y, iteration, frame), lanes
    whose path ended restart the next sample of their pixel."""
    n_lights = settings.n_lights
    present = tuple(int(k) for k in settings.bsdf_kinds)
    kinds = tuple(int(k) for k in settings.light_kinds or ())

    def bounce(state: PathState) -> PathState:
        n = state.tmin.shape[0]
        device = state.tmin.device
        rays_b = Rays(state.org, state.dir, state.tmin,
                      torch.where(state.alive, state.tmax, -1.0))
        hit = trace_scene(scene, rays_b, rows)
        found = hit.prim >= 0
        result = state.result

        # ---- miss: infinite lights -------------------------------------
        miss = state.alive & ~found
        for lid in settings.infinite_light_rows:
            lp = lightlib.gather_light(
                scene.lights, torch.full((n,), lid, dtype=torch.int64,
                                         device=device))
            emit = lightlib.env_emission(lp)
            pdf_s = lightlib.env_pdf_direct(lp)
            lsel_pdf = lightlib.selector_pdf(settings, state.tmin)
            if settings.enable_nee:
                mis = torch.where(lp.delta, 0.0,
                                  1.0 / (1.0 + state.inv_pdf * lsel_pdf * pdf_s))
            else:
                mis = torch.where(lp.delta, 0.0, 1.0)
            c = _handle_color(state.contrib.cmul(emit) * mis, settings)
            result = _cadd_where(miss & ~lp.delta, result, c)

        # ---- hit shading -----------------------------------------------
        active = state.alive & found
        surf = compute_surface(scene, rays_b, hit, tab)
        mat = gather_material(scene, surf)
        out_dir = -state.dir
        frame = make_frame(surf.ns)
        shader = bsdflib.LaneShader(mat, frame, surf.is_entering, present)
        all_delta = shader.is_all_delta()

        # emission on hit (area emitters)
        light_row = scene.entities.light[torch.clamp(surf.ent, min=0).long()]
        is_emissive = light_row >= 0
        lp_hit = lightlib.gather_light(scene.lights,
                                       torch.clamp(light_row, min=0))
        cos_l = -dot(state.dir, frame.n)
        emit_ok = active & is_emissive & surf.is_entering & (cos_l > 1e-6)
        pdf_area = safe_div(1.0, lp_hit.p0)
        t_safe = torch.where(emit_ok, hit.t, 1.0)
        cos_safe = torch.where(emit_ok, cos_l, 1.0)
        pdf_s = pdf_area * t_safe * t_safe / cos_safe
        esel_pdf = lightlib.selector_pdf(settings, state.tmin)
        if settings.enable_nee:
            mis_e = 1.0 / (1.0 + state.inv_pdf * esel_pdf * pdf_s)
        else:
            mis_e = torch.ones_like(pdf_s)
        c_emit = _handle_color(state.contrib.cmul(lp_hit.intensity) * mis_e,
                               settings)
        result = _cadd_where(emit_ok, result, c_emit)

        rng = state.rng
        depth = state.depth

        # ---- NEE -------------------------------------------------------
        if settings.enable_nee and n_lights > 0:
            rng, (ul, u0, u1) = rnglib.next_f32_n(rng, 3)
            lsel, sel_pdf = lightlib.select_light(settings, ul)
            lp = lightlib.gather_light(scene.lights, lsel)
            ls = lightlib.sample_direct(scene, lp, surf.point, u0, u1, kinds)
            pdf_l_s = lightlib.pdf_as_solid(ls.pdf_value, ls.pdf_is_area,
                                            ls.cos, ls.dist * ls.dist) * sel_pdf
            bsdf_f = shader.eval(ls.dir, out_dir)
            bsdf_p = shader.pdf(ls.dir, out_dir)
            mis = torch.where(lp.delta, 1.0,
                              1.0 / (1.0 + safe_div(bsdf_p, pdf_l_s)))
            factor = safe_div(ls.pdf_value, pdf_l_s)
            contrib_nee = _handle_color(
                ls.intensity.cmul(state.contrib.cmul(bsdf_f)) * (mis * factor),
                settings)
            want = (active & ~all_delta & (depth + 1 <= settings.max_depth)
                    & (pdf_l_s > 1e-9) & (ls.cos > 1e-6)
                    & (color_max_component(contrib_nee) > 0))
            # finite lights aim at the sampled point (range [o, 1-o]);
            # unwanted lanes get tmax < tmin so the kernels cull them
            sdir = vselect(lp.infinite, ls.dir, ls.pos - surf.point)
            stmax = torch.where(lp.infinite, FLT_MAX, 1.0 - OFFSET)
            stmax = torch.where(want, stmax, -1.0)
            shadow_rays = Rays(surf.point, sdir,
                               torch.full_like(stmax, OFFSET), stmax)
            occ = occluded_scene(scene, shadow_rays, rows)
            result = _cadd_where(want & ~occ, result, contrib_nee)

        # ---- bounce ----------------------------------------------------
        rng, (b_pick, b0, b1, b2, b_rr) = rnglib.next_f32_n(rng, 5)
        bs = shader.sample(out_dir, b_pick, b0, b1, b2)
        new_contrib = state.contrib.cmul(bs.weight)
        rr_c = color_max_component(new_contrib) * state.eta * state.eta
        rr_prob = torch.clamp(rr_c, 0.05, 0.95)
        rr_prob = torch.where(depth + 1 > settings.min_depth, rr_prob, 1.0)
        survive = b_rr < rr_prob
        cont = (active & bs.valid & survive & (bs.pdf > 1e-9)
                & (depth + 1 <= settings.max_depth))
        new_contrib = new_contrib * (1.0 / rr_prob)
        new_inv_pdf = torch.where(bs.is_delta, 0.0, safe_div(1.0, bs.pdf))

        new_state = PathState(
            org=surf.point, dir=bs.in_dir,
            tmin=torch.full_like(state.tmin, OFFSET),
            tmax=torch.full_like(state.tmin, FLT_MAX),
            rng=rng,
            contrib=cselect(cont, new_contrib, state.contrib),
            inv_pdf=torch.where(cont, new_inv_pdf, state.inv_pdf),
            eta=torch.where(cont, state.eta * bs.eta, state.eta),
            alive=cont, result=result, depth=state.depth + 1,
            sample=state.sample)
        if regen is None:
            return new_state

        x, y, iteration, frame_id = regen
        died = state.alive & ~cont
        do_regen = died & (state.sample + 1 < settings.spi)
        new_sample = torch.where(do_regen, state.sample + 1, state.sample)
        fresh = rnglib.seed(new_sample, iteration, frame_id, x, y,
                            settings.seed)
        sample_idx = (rnglib.as_u32(new_sample)
                      + iteration * settings.spi) & rnglib.MASK
        fresh2, (rx, ry) = sample_pixel_offsets(settings.pixel_sampler,
                                                fresh, sample_idx, x, y)
        cam = cameralib.generate_rays(scene.camera, settings, x, y, rx, ry,
                                      rng_state=fresh2)
        return PathState(
            org=vselect(do_regen, cam.org, new_state.org),
            dir=vselect(do_regen, cam.dir, new_state.dir),
            tmin=torch.where(do_regen, cam.tmin, new_state.tmin),
            tmax=torch.where(do_regen, cam.tmax, new_state.tmax),
            rng=torch.where(do_regen, fresh2, new_state.rng),
            contrib=cselect(do_regen, white_like(state.tmin),
                            new_state.contrib),
            inv_pdf=torch.where(do_regen, 0.0, new_state.inv_pdf),
            eta=torch.where(do_regen, 1.0, new_state.eta),
            alive=cont | do_regen, result=result,
            depth=torch.where(do_regen, 1, new_state.depth),
            sample=new_sample)

    return bounce


def initial_state(rays: Rays, rng_state) -> PathState:
    like = rays.tmin
    return PathState(
        org=rays.org, dir=rays.dir, tmin=rays.tmin, tmax=rays.tmax,
        rng=rng_state, contrib=white_like(like),
        inv_pdf=torch.zeros_like(like), eta=torch.ones_like(like),
        alive=torch.ones_like(like, dtype=torch.bool),
        result=black_like(like),
        depth=torch.ones_like(like, dtype=torch.int32),
        sample=torch.zeros_like(like, dtype=torch.int32))


def start_state(scene: SceneData, settings: RenderSettings, x, y,
                iteration: int, frame: int) -> PathState:
    """Camera rays of every lane's first sample."""
    st0 = rnglib.seed(torch.zeros_like(x), iteration, frame, x, y,
                      settings.seed)
    st0, (rx, ry) = sample_pixel_offsets(settings.pixel_sampler, st0,
                                         iteration * settings.spi, x, y)
    rays = cameralib.generate_rays(scene.camera, settings, x, y, rx, ry,
                                   rng_state=st0)
    return initial_state(rays, st0)


def bucket_chain(n: int, min_bucket: int):
    """Cascade of bucket sizes: n, n/SHRINK, ... down to min_bucket."""
    sizes = [n]
    while sizes[-1] // SHRINK >= min_bucket:
        sizes.append(sizes[-1] // SHRINK)
    return sizes


def render_lanes(scene: SceneData, settings: RenderSettings, x, y,
                 iteration: int, frame: int, compact: bool = True,
                 remat: bool = False) -> Color:
    """Render settings.spi samples for every lane (pixel (x, y)); returns
    the per-lane radiance summed over the samples, in x's lane order.

    With `compact`, the compacting cascade of ignis_tpu
    (cascade_lane_fn): stages of n, n/4, ... lanes down to MIN_BUCKET;
    a stage ends once at most size/4 lanes are alive (the last once none
    is), all stages share one budget of spi*max_depth bounces, and each
    stage folds its radiance into the film by original lane id and hands
    its survivors, compacted, to the next. Without it, one stage: the
    persistent-lane progressive render (path_trace_progressive).

    With `remat`, the same bounces run in chunks of up to DIFF_CHUNK under
    torch.utils.checkpoint, so reverse mode keeps only each chunk's input
    state and recomputes the chunk's bounces in the backward (the JAX
    package's path_trace_cascade_diff). A chunk decides how many bounces
    it runs from the alive counts of its own state, so its recompute
    repeats the same decisions."""
    n = x.shape[0]
    device = x.device
    sizes = bucket_chain(n, MIN_BUCKET) if compact else [n]
    tab = attr_table(scene)
    rows = tri_rows_of(scene)
    st = start_state(scene, settings, x, y, iteration, frame)
    film = torch.zeros((3, n), dtype=torch.float32, device=device)
    budget = settings.spi * settings.max_depth
    px, py = x, y
    l0 = torch.arange(n, device=device)
    for si, size in enumerate(sizes):
        last = si == len(sizes) - 1
        min_alive = 0 if last else size // SHRINK
        bounce = make_bounce(scene, settings, tab, (px, py, iteration, frame),
                             rows)

        def run(st, limit, bounce=bounce, min_alive=min_alive):
            it = 0
            while it < limit and int(st.alive.sum()) > min_alive:
                st = bounce(st)
                it += 1
            return st, it

        if remat:
            it = 0
            while it < budget:
                limit = min(DIFF_CHUNK, budget - it)
                st, done = checkpoint(run, st, limit, use_reentrant=False,
                                      preserve_rng_state=False)
                it += done
                if done < limit:
                    break
        else:
            st, it = run(st, budget)
        budget -= it
        film = film.index_add(1, l0, torch.stack(st.result))
        if not last:
            st = st._replace(result=black_like(st.tmin))
            order = torch.argsort((~st.alive).to(torch.int8),
                                  stable=True)[:size // SHRINK]
            st = tree_map(lambda a: a[order], st)
            px, py, l0 = px[order], py[order], l0[order]
    return Color(film[0], film[1], film[2])
