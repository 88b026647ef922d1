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

Materials: the Materials columns are stacked once per render into one
[M, 32] table (`material_table`), and a lane's row, or a blend child's,
is one K3 gather of it (`gather_mat_rows`), whose backward is K3's
scatter-add. Textures replace the albedo and extra colours, normal and
bump maps perturb the shading normal (`apply_normal_map`), and a
texture may drive the top blend's weight.

Reverse mode runs through the same bounce (`render_lanes(remat=True)`,
the JAX package's path_trace_cascade_diff): closest hits through the K1/K2
fixed-winner backward (ops/mt_replay.py), the hit-attribute and material
fetches through K3 (ops/gather.py) and its scatter-add backward, bounces
checkpointed in chunks of DIFF_CHUNK.

Transparent shadows (`shadow_transmittance`) walk a shadow ray's
crossings of see-through rows and media; the volumetric technique
(techniques/volpath.py) shares this module's shading, light sampling and
cascade (`technique_fns`), and the other techniques (techniques/simple.py,
lighttracer.py, ppm.py, aept.py) its tracing, hit shading and tables.
Instanced groups (ops/instanced.py) take part in every closest hit, any
hit and hit-attribute fetch, through their own tables
(`RenderTables.inst`).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from ..core import rng as rnglib
from ..core.frame import Frame, ensure_valid_reflection, make_frame
from ..core.fresnel import fresnel_dielectric
from ..core.sampler import sample_pixel_offsets
from ..core.vec import (Color, Vec2, Vec3, black_like, color_max_component,
                        cross, cselect, dot, length, normalize, safe_div,
                        saturate, vselect, white_like)
from ..core.warp import PI, TWO_PI, spherical_from_dir
from ..models import bsdf as bsdflib
from ..models import camera as cameralib
from ..models import light as lightlib
from ..models import medium as medlib
from ..models import texture as texlib
from ..ops import bvh_cuda, isect_cuda
from ..ops import gather as gatherlib
from ..ops import instanced as instlib
from ..ops import intersect as isect
from ..ops.intersect import FLT_MAX, Hit, Rays
from ..scenedata import RenderSettings, SceneData, tree_map

OFFSET = 1e-3
ATTR_COLS = 22   # the hit attributes in attr_table
# the columns of material_table: MatParams' (MAT_COLS), then the texture
# and normal-map slots (TEX_COLS); integers are exact as f32 below 2^24
MAT_COLS = 23
TEX_COLS = ("base_tex", "extra_tex", "p0_tex", "p1_tex", "bump_kind",
            "bump_tex", "bump_strength")
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


def instance_tables(scene: SceneData):
    """The GroupTables of each instanced group (ops/instanced.py), or None
    for a scene without instances."""
    if scene.instances is None:
        return None
    return tuple(instlib.group_tables(g) for g in scene.instances)


def _groups(scene: SceneData, inst):
    """(group, its tables, its prim base) of each instanced group."""
    if inst is None:
        inst = instance_tables(scene)
    base = scene.tris.v0.x.shape[0] + scene.spheres.radius.shape[0]
    out = []
    for g, gt in zip(scene.instances, inst):
        out.append((g, gt, base))
        base += g.n_instances * g.tris_per_instance
    return out


def trace_scene(scene: SceneData, rays: Rays, packed=None,
                inst=None) -> Hit:
    """Closest hit: BVH (K1) or dense (K2) triangles, then spheres, then
    the instanced groups (one K1 or K2 launch each). `packed` is the soup
    packed for that kernel (soup_pack_of), or None; `inst` the groups'
    tables (instance_tables), made here when None."""
    if scene.bvh is not None:
        h = bvh_cuda.intersect_bvh(rays, scene.tris, scene.bvh,
                                   tri_rows=packed)
    else:
        h = isect_cuda.intersect_tris(rays, scene.tris, packed=packed)
    hs = isect.intersect_spheres_dense(rays, scene.spheres,
                                       scene.tris.v0.x.shape[0])
    h = isect.merge_hits(h, hs)
    if scene.instances is not None:
        for g, gt, base in _groups(scene, inst):
            h = isect.merge_hits(h, instlib.intersect_instanced(
                rays, g, base, tabs=gt))
    return h


def occluded_scene(scene: SceneData, rays: Rays,
                   packed=None, inst=None) -> torch.Tensor:
    """Any hit on a shadow-visible primitive, instanced ones included."""
    vis = scene.tri_attr.shadow_visible
    if scene.bvh is not None:
        occ = bvh_cuda.intersect_bvh(rays, scene.tris, scene.bvh,
                                     any_hit=True, shadow_visible=vis,
                                     tri_rows=packed)
    else:
        occ = isect_cuda.intersect_tris(rays, scene.tris, vis, any_hit=True,
                                        packed=packed)
    if scene.spheres.radius.shape[0] > 0:
        # sphere visibility is applied to the closest sphere hit
        h = isect.intersect_spheres_dense(rays, scene.spheres, 0)
        svis = scene.sph_attr.shadow_visible[torch.clamp(h.prim, min=0).long()]
        occ = occ | ((h.prim >= 0) & svis)
    if scene.instances is not None:
        for g, gt, _ in _groups(scene, inst):
            occ = occ | instlib.intersect_instanced(rays, g, 0, any_hit=True,
                                                    tabs=gt)
    return occ


def soup_pack_of(scene: SceneData):
    """The scene's current soup packed for its kernel: K1's triangle rows
    (bvh_cuda.pack_tris) with a BVH, K2's tiles (isect_cuda.pack_soup)
    without."""
    if scene.bvh is not None:
        return bvh_cuda.pack_tris(scene.tris)
    return isect_cuda.pack_soup(scene.tris)


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
                    tab: torch.Tensor = None, inst=None) -> Surface:
    """Hit attributes through one row gather of `tab` (attr_table, K3)
    into contiguous columns; the table is built here when none is
    given. Hits on an instanced group take its local attributes and the
    instance's normal matrix and entity (instanced_surface: two K3
    gathers a group, of the group's tables `inst`)."""
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

    if scene.instances is not None:
        # the instanced region, prim >= n_tri + n_sph (JAX path.py:390-420)
        z = torch.zeros_like(uv.x)
        zero = Vec3(z, z, z)
        for g, gt, base in _groups(scene, inst):
            size = g.n_instances * g.tris_per_instance
            keep = ~((prim >= base) & (prim < base + size))
            (ifn, in0, in1, in2, iuv0, iuv1, iuv2,
             ient) = instlib.instanced_surface(
                 g, gt, torch.clamp(prim - base, 0, size - 1))
            ifn = normalize(ifn)
            ins = normalize(Vec3(in0.x * w + in1.x * u + in2.x * v,
                                 in0.y * w + in1.y * u + in2.y * v,
                                 in0.z * w + in1.z * u + in2.z * v))
            face_n = vselect(keep, face_n, ifn)
            ns = vselect(keep, ns, ins)
            uv = Vec2(torch.where(keep, uv.x, iuv0.x * w + iuv1.x * u
                                  + iuv2.x * v),
                      torch.where(keep, uv.y, iuv0.y * w + iuv1.y * u
                                  + iuv2.y * v))
            ent = torch.where(keep, ent, ient)
            tu = vselect(keep, tu, zero)
            tv = vselect(keep, tv, zero)

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


def material_columns(scene: SceneData) -> list:
    """The Materials columns in material_table's order: kind, base,
    extra, extra2 (rgb each), p0-p3 and q0-q8 (MAT_COLS of them, in
    MatParams' order), then TEX_COLS."""
    m = scene.materials
    return ([m.kind, *m.base, *m.extra, *m.extra2, m.p0, m.p1, m.p2, m.p3,
             m.q0, m.q1, m.q2, m.q3, m.q4, m.q5, m.q6, m.q7, m.q8]
            + [getattr(m, c) for c in TEX_COLS])


def material_table(scene: SceneData) -> torch.Tensor:
    """The [M, 32] f32 table of material_columns, padded with two zero
    columns (gatherlib.stack_cols). Made once per render; a leaf that
    requires grad gets its gradient through K3's scatter into this
    table."""
    return gatherlib.stack_cols(material_columns(scene))


def _ids(col):
    return torch.round(col).to(torch.int32)


def gather_mat_rows(mtab: torch.Tensor, ids, with_tex: bool = False,
                    grad=None):
    """MatParams of material rows `ids` ([N] int32) through one K3 gather
    of material_table; with `with_tex` also the TEX_COLS columns, by name
    (texture ids and bump kind as int32). `grad` (SceneInfo.mat_grad)
    names the columns whose leaves require grad; the others leave the
    graph, so that, say, an albedo gradient does not reach the ray
    directions through the iors, and the graph's columns are copied out
    of the block, so that what autograd saves holds no [k, N] block."""
    k = MAT_COLS + len(TEX_COLS) if with_tex else MAT_COLS
    cols = gatherlib.gather_block(ids, mtab, k).unbind(0)
    if grad is not None and mtab.requires_grad:
        cols = [c.clone() if g else c.detach() for c, g in zip(cols, grad)]
    mat = bsdflib.MatParams(_ids(cols[0]), Color(*cols[1:4]),
                            Color(*cols[4:7]), Color(*cols[7:10]),
                            *cols[10:MAT_COLS])
    if not with_tex:
        return mat
    tex = dict(zip(TEX_COLS, cols[MAT_COLS:]))
    for c in TEX_COLS[:-1]:
        tex[c] = _ids(tex[c])
    return mat, tex


def material_ids(scene: SceneData, surf: Surface):
    """Each lane's material row (int32)."""
    return scene.entities.mat[torch.clamp(surf.ent, min=0).long()]


class SceneInfo(NamedTuple):
    """What a render reads once from the scene's small tables on the host,
    so that no bounce syncs: the blend nesting depth, the hierarchy depth,
    the bump kinds present, the texture ids each slot can hold, the kind,
    texture and delta flag of each infinite light row, which
    material_columns require grad, and whether the scene has PExpr."""
    blend_depth: int
    hier_depth: int
    bump_kinds: tuple
    tex_ids: dict        # TEX_COLS slot -> texture ids that occur in it
    light_tex: tuple     # texture ids of the lights
    infinite: dict       # infinite light row -> (kind, texture id, delta)
    mat_grad: tuple      # per material_columns column: requires grad
    pexpr: bool = False  # a PExpr texture or medium: the full ShadeCtx


def scene_info(scene: SceneData, settings: RenderSettings) -> SceneInfo:
    m = scene.materials
    kind = m.kind.detach().cpu().numpy()
    q0 = m.q0.detach().cpu().numpy()
    q1 = m.q1.detach().cpu().numpy()

    def depth(i, seen=()):
        if i in seen or kind[i] != bsdflib.BsdfKind.BLEND:
            return 0
        return 1 + max(depth(int(round(c)), seen + (i,))
                       for c in (q0[i], q1[i]))
    blend_depth = (max(depth(i) for i in range(len(kind)))
                   if settings.has_blend else 0)
    tex_ids = {c: tuple(sorted({int(t) for t in getattr(m, c).cpu().numpy()
                                if t >= 0}))
               for c in ("base_tex", "extra_tex", "p0_tex", "bump_tex")}
    bk = m.bump_kind.cpu().numpy()
    bt = m.bump_tex.cpu().numpy()
    return SceneInfo(
        blend_depth=blend_depth,
        hier_depth=(lightlib.hier_depth(scene.lights)
                    if settings.light_selector == "hierarchy" else 0),
        bump_kinds=tuple(sorted({int(k) for k, t in zip(bk, bt)
                                 if k > 0 and t >= 0})),
        tex_ids=tex_ids,
        light_tex=tuple(sorted({int(t) for t in
                                scene.lights.tex.cpu().numpy() if t >= 0})),
        infinite={r: (int(scene.lights.kind[r]), int(scene.lights.tex[r]),
                      bool(scene.lights.delta[r]))
                  for r in settings.infinite_light_rows},
        mat_grad=tuple(c.requires_grad for c in material_columns(scene)),
        pexpr=texlib.has_pexpr(settings.texture_descs, settings.medium_exprs))


def make_surface_ctx(scene: SceneData, rays: Rays, surf: Surface,
                     info: SceneInfo) -> texlib.ShadeCtx:
    """The texture lookup context at a surface hit: its uv and the view
    direction, and for a scene with PExpr (info.pexpr) every PExpr
    variable (ignis_tpu/techniques/path.py:447-469), the scene's live
    parameter registry included."""
    view = (-rays.dir.x, -rays.dir.y, -rays.dir.z)
    if not info.pexpr:
        return texlib.light_ctx(surf.uv, view)
    fr = shading_frame(surf)
    return texlib.make_shade_ctx(
        surf.uv, point=tuple(surf.point), normal=tuple(surf.ns),
        face_normal=tuple(surf.face_n), tangent=tuple(fr.t),
        bitangent=tuple(fr.b), ray_dir=view, ray_org=tuple(rays.org),
        entity_id=surf.ent, frontside=surf.is_entering,
        scene_center=tuple(scene.scene_center),
        scene_radius=scene.scene_radius, registry=scene.registry,
        dpdu=tuple(surf.tu), dpdv=tuple(surf.tv))


def apply_textures(mat, tex: dict, eval_texture, ctx, info: SceneInfo):
    """`mat` with its albedo and extra colours replaced by their textures
    on the rows that have one (only the ids a slot holds are evaluated)."""
    for slot, col in (("base", "base_tex"), ("extra", "extra_tex")):
        if info.tex_ids[col]:
            c = eval_texture(tex[col], ctx, info.tex_ids[col])
            mat = mat._replace(**{slot: cselect(tex[col] >= 0, c,
                                                getattr(mat, slot))})
    return mat


def gather_material(scene: SceneData, surf: Surface, mtab: torch.Tensor,
                    eval_texture=None, ctx=None, info: SceneInfo = None):
    """(MatParams, material ids, texture columns or None) of each lane's
    hit, the albedo and extra colours replaced by their textures where a
    row has one."""
    mid = material_ids(scene, surf)
    if eval_texture is None:
        return gather_mat_rows(mtab, mid, grad=info.mat_grad), mid, None
    mat, tex = gather_mat_rows(mtab, mid, with_tex=True, grad=info.mat_grad)
    return apply_textures(mat, tex, eval_texture, ctx, info), mid, tex


def apply_normal_map(surf: Surface, ctx: texlib.ShadeCtx, eval_texture,
                     tex: dict, info: SceneInfo) -> Surface:
    """Perturb the shading normal of normal- and bump-mapped rows
    (reference bsdf/map.art make_normalmap / make_bumpmap) and set that of
    transform BSDFs (bump kind 3), then clamp it
    so the view reflection stays above the geometric surface (make_normal
    _set). Only the bump kinds the scene has are evaluated."""
    if not info.bump_kinds:
        return surf
    bk = tex["bump_kind"]
    bt = torch.clamp(tex["bump_tex"], min=0)
    bs = tex["bump_strength"]
    ids = info.tex_ids["bump_tex"]
    fr = shading_frame(surf)
    new_ns = surf.ns
    if 1 in info.bump_kinds:
        # normalmap (map.art:56): tangent-space colour to world, lerped by
        # the strength
        c = eval_texture(bt, ctx, ids)
        tx, ty, tz = 2.0 * c.r - 1.0, 2.0 * c.g - 1.0, 2.0 * c.b - 1.0
        o = normalize(fr.to_world(Vec3(tx, ty, tz)))
        n_n = normalize(Vec3(surf.ns.x + (o.x - surf.ns.x) * bs,
                             surf.ns.y + (o.y - surf.ns.y) * bs,
                             surf.ns.z + (o.z - surf.ns.z) * bs))
        new_ns = vselect(bk == 1, n_n, new_ns)
    if 2 in info.bump_kinds:
        # bumpmap (map.art:64): n - strength * (t dh/du + b dh/dv), central
        # differences scaled to a derivative (texture/common.art:28)
        h = 0.001
        u, v = ctx.uv

        def height(uu, vv):
            return eval_texture(bt, ctx._replace(uv=(uu, vv)), ids).r
        dx = (height(u + h, v) - height(u - h, v)) / (2.0 * h)
        dy = (height(u, v + h) - height(u, v - h)) / (2.0 * h)
        b_n = normalize(Vec3(surf.ns.x - bs * (fr.t.x * dx + fr.b.x * dy),
                             surf.ns.y - bs * (fr.t.y * dx + fr.b.y * dy),
                             surf.ns.z - bs * (fr.t.z * dx + fr.b.z * dy)))
        new_ns = vselect(bk == 2, b_n, new_ns)
    if 3 in info.bump_kinds:
        # the transform BSDF's normal (TransformBSDF.cpp:40-44): a PExpr
        # vec3 per shading point in world space, its rgb the new normal
        c = eval_texture(bt, ctx, ids)
        new_ns = vselect(bk == 3, normalize(Vec3(c.r, c.g, c.b)), new_ns)
    new_ns = vselect(bk > 0, ensure_valid_reflection(
        surf.face_n, Vec3(*ctx.ray_dir), new_ns), new_ns)
    return surf._replace(ns=new_ns)


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
    """Raise for a technique that does not exist, and for settings without
    their BSDF kinds."""
    from . import TECHNIQUES
    if settings.technique not in TECHNIQUES:
        raise ValueError(f"Unknown technique '{settings.technique}'")
    bsdflib.check_kinds(settings.bsdf_kinds)


class RenderTables(NamedTuple):
    """What a render makes once from the scene and hands to every bounce:
    the attr_table, the material_table, the medium_table (None where no
    bounce reads a medium), scene_info, the soup packed for its kernel
    (soup_pack_of), the texture evaluator (None without textures) and the
    instanced groups' tables (instance_tables, None without instances)."""
    attr: torch.Tensor
    mat: torch.Tensor
    med: torch.Tensor
    info: SceneInfo
    packed: object
    eval_texture: object
    inst: tuple = None


def render_tables(scene: SceneData, settings: RenderSettings,
                  eval_texture=None) -> RenderTables:
    if eval_texture is None:
        eval_texture = texlib.make_texture_evaluator(settings.texture_descs,
                                                     scene.textures)
    media = settings.transparent_shadows or settings.technique == "volpath"
    return RenderTables(attr_table(scene), material_table(scene),
                        medlib.medium_table(scene.media) if media else None,
                        scene_info(scene, settings), soup_pack_of(scene),
                        eval_texture, instance_tables(scene))


def shadow_transmittance(scene: SceneData, settings: RenderSettings,
                         rays: Rays, tabs: RenderTables, init_medium=None,
                         max_crossings: int = 4) -> Color:
    """Transparent shadow rays (ignis_tpu/techniques/path.py:187-300): the
    transmittance along each shadow segment, 0 where it is blocked.

    Walks up to `max_crossings` closest hits along the segment, one
    trace_scene (K1 or K2) and the K3 fetches of its hit attributes and
    material rows each, as fixed masked steps with no host sync. A
    straight-through delta transmitter (passthrough, thin smooth
    dielectric, RAD_BRTDF and RAD_ROOS specular transmission) multiplies
    its tint into the carried transmittance (textured tints take the
    table's constant, as in the JAX package); any other surface blocks.
    Homogeneous media attenuate each leg under the medium tracked across
    the crossed entities' inner and outer media, from `init_medium` (ids,
    vacuum when None) on. Lanes still alive after the last crossing are
    attenuated to the segment's end and blocked by any further hit.

    Unlike the JAX function, the leg after the last crossing is attenuated
    too: there a ray that meets nothing more gets seg_len 0 (ROADMAP queue
    3, ADVICE path.py:237). The walk's geometry is detached (its rays,
    hits and attributes carry no gradient, so no MT replay runs for it);
    its tints and transmittances carry gradients to the material and
    medium tables."""
    n = rays.tmin.shape[0]
    info = tabs.info
    present = tuple(int(k) for k in settings.bsdf_kinds)
    one = torch.ones_like(rays.tmin)
    zero = torch.zeros_like(one)
    tint = Color(one, one, one)
    alive = rays.tmax > rays.tmin
    med_id = (torch.full((n,), -1, dtype=torch.int32, device=one.device)
              if init_medium is None else init_medium)
    org = Vec3(*[c.detach() for c in rays.org])
    d = Vec3(*[c.detach() for c in rays.dir])
    # area-light shadow rays run over an unnormalised direction (t in
    # [o, 1 - o]): a medium's path length needs |d|
    dlen = length(d)
    t_cur = rays.tmin.detach()
    t_end = rays.tmax.detach()
    attr = tabs.attr.detach()
    ent_in, ent_out = scene.entities.med_inner, scene.entities.med_outer

    for _ in range(max_crossings):
        seg = Rays(org, d, t_cur, torch.where(alive, t_end, -1.0))
        hit = trace_scene(scene, seg, tabs.packed, tabs.inst)
        found = hit.prim >= 0
        surf = compute_surface(scene, seg, hit, attr, tabs.inst)
        mat = gather_mat_rows(tabs.mat, material_ids(scene, surf),
                              grad=info.mat_grad)
        # the medium over [t_cur, t_hit], or to the segment's end
        seg_len = (torch.where(found, hit.t, t_end) - t_cur) * dlen
        med = medlib.gather_medium(tabs.med, med_id)
        tr = medlib.transmittance(med, torch.clamp(seg_len, min=0.0))
        # the tint of the crossed row
        cos_h = torch.abs(dot(normalize(d), surf.face_n))
        f_th = fresnel_dielectric(mat.p0 / torch.clamp(mat.p1, min=1e-6),
                                  cos_h).factor
        f_th = f_th + (1.0 - f_th) * f_th / (f_th + 1.0)
        thin_ok = (mat.p3 > 0.5) & (mat.p2 <= bsdflib.DELTA_ALPHA)
        kind = mat.kind
        through = Color(zero, zero, zero)
        through = cselect(kind == bsdflib.BsdfKind.PASSTHROUGH, mat.base,
                          through)
        through = cselect((kind == bsdflib.BsdfKind.DIELECTRIC) & thin_ok,
                          mat.extra * (1.0 - f_th), through)
        if int(bsdflib.BsdfKind.RAD_BRTDF) in present:
            # the specular transmission colour is in `extra`
            through = cselect(kind == bsdflib.BsdfKind.RAD_BRTDF, mat.extra,
                              through)
        if int(bsdflib.BsdfKind.RAD_ROOS) in present:
            # `base` holds the (w, p, q) model parameters: the angular tau
            # of rad.art make_rad_roos_bsdf
            tw, tp, tq = (mat.base.r, mat.base.g,
                          torch.clamp(mat.base.b, min=1e-4))
            z = torch.arccos(torch.clamp(cos_h, 0.0, 1.0 - 1e-7)) \
                * 0.636619772368
            a_c = 8.0
            alpha_t = 5.2 + 0.7 * tq
            gamma_t = (5.26 + 0.06 * tp) + (0.73 + 0.04 * tp) * tq
            b_t = 0.25 / tq
            c_t = 1.0 - a_c - b_t
            tau = torch.clamp(tw * (1.0 - a_c * torch.pow(z, alpha_t)
                                    - b_t * z * z
                                    - c_t * torch.pow(z, gamma_t)), 0.0, 1.0)
            through = cselect(kind == bsdflib.BsdfKind.RAD_ROOS,
                              Color(tau, tau, tau), through)
        crossed = alive & found
        tint = cselect(crossed, tint.cmul(tr).cmul(through),
                       cselect(alive, tint.cmul(tr), tint))
        # the medium on the far side of the interface
        ent = torch.clamp(surf.ent, min=0).long()
        med_id = torch.where(crossed, torch.where(surf.is_entering,
                                                  ent_in[ent], ent_out[ent]),
                             med_id)
        t_cur = torch.where(crossed, hit.t + OFFSET, t_end)
        alive = crossed & (color_max_component(tint) > 0.0) & (t_cur < t_end)
    # past the crossing budget: the rest of the segment under the last
    # medium, blocked by anything there (no light leaks past the budget)
    med = medlib.gather_medium(tabs.med, med_id)
    rest = torch.clamp(t_end - t_cur, min=0.0) * dlen
    rest = torch.where(torch.isfinite(rest), rest, 0.0)
    tint = tint.cmul(medlib.transmittance(med, rest))
    fin = Rays(org, d, t_cur, torch.where(alive, t_end, -1.0))
    blocked = occluded_scene(scene, fin, tabs.packed, tabs.inst)
    return cselect(alive & blocked, Color(zero, zero, zero), tint)


def infinite_emissions(scene: SceneData, tabs: RenderTables, dirs: Vec3):
    """For each infinite light row that is no delta light: (row, its
    kind, its texture id, the row id a lane, its LightParams, its radiance
    along `dirs`, the texture evaluated)."""
    n = dirs.x.shape[0]
    for lid, (kind, tex_id, delta) in tabs.info.infinite.items():
        if delta:
            continue
        rows = torch.full((n,), lid, dtype=torch.int64, device=dirs.x.device)
        lp = lightlib.gather_light(scene.lights, rows)
        env_tex = None
        if tabs.eval_texture is not None and tex_id >= 0:
            def env_tex(tid, ctx, tex_id=tex_id):
                return tabs.eval_texture(tid, ctx, (tex_id,))
        yield (lid, kind, tex_id, rows, lp,
               lightlib.env_emission(scene, lp, dirs, env_tex, (kind,)))


def env_miss(scene: SceneData, settings: RenderSettings, tabs: RenderTables,
             state, inv_pdf, mask, result: Color) -> Color:
    """`result` plus the emission of the infinite lights that the lanes
    under `mask` see along their ray, MIS-weighted with `inv_pdf` (a delta
    light adds nothing to a miss)."""
    for lid, kind, tex_id, rows, lp, emit in infinite_emissions(
            scene, tabs, state.dir):
        pdf_s = lightlib.env_pdf_direct(scene, lp, state.dir, (kind,),
                                        textured=tex_id >= 0)
        lsel_pdf = lightlib.infinite_selector_pdf(settings, scene.lights,
                                                  lid, rows)
        if settings.enable_nee:
            mis = 1.0 / (1.0 + inv_pdf * lsel_pdf * pdf_s)
            c = state.contrib.cmul(emit) * mis
        else:
            c = state.contrib.cmul(emit)
        result = _cadd_where(mask, result, _handle_color(c, settings))
    return result


def light_texture(tabs: RenderTables):
    """The texture evaluator over the lights' texture ids, or None."""
    ev, info = tabs.eval_texture, tabs.info
    if ev is None or not info.light_tex:
        return None

    def light_tex(tid, c):
        return ev(tid, c, info.light_tex)
    return light_tex


class Shading(NamedTuple):
    surf: Surface
    frame: Frame
    shader: bsdflib.LaneShader
    ctx: texlib.ShadeCtx = None   # the lookup context (None: no textures)


def shade_hit(scene: SceneData, settings: RenderSettings, tabs: RenderTables,
              rays: Rays, hit: Hit, weight_texture: bool = True) -> Shading:
    """The surface at each lane's hit (K3 attribute fetch), its material
    (K3 material fetch, textures, normal and bump maps) and the lane
    shader over it, blends resolved. Without `weight_texture` a textured
    blend weight keeps its constant, as the JAX light tracer, photon pass
    and aept shade (they pass no override to make_lane_shader)."""
    info, ev = tabs.info, tabs.eval_texture
    n = rays.tmin.shape[0]
    present = tuple(int(k) for k in settings.bsdf_kinds)
    textured = ev is not None and bool(info.tex_ids["base_tex"]
                                       or info.tex_ids["extra_tex"])
    surf = compute_surface(scene, rays, hit, tabs.attr, tabs.inst)
    ctx = (make_surface_ctx(scene, rays, surf, info)
           if ev is not None or info.pexpr else None)
    mat, mid, tex = gather_material(scene, surf, tabs.mat, ev, ctx, info)
    if tex is not None:
        surf = apply_normal_map(surf, ctx, ev, tex, info)
    frame = make_frame(surf.ns)
    w_override = None
    if (weight_texture and tex is not None and info.blend_depth
            and info.tex_ids["p0_tex"]):
        wtex = ev(tex["p0_tex"], ctx, info.tex_ids["p0_tex"])
        w_override = torch.where(tex["p0_tex"] >= 0, wtex.r, mat.p0)

    def gather_row(ids):
        # the rows of blend children, and of every lane of a scene with
        # blends, textured as gather_material textures a lane's own row
        # (the JAX package reads them untextured: ROADMAP queue 3); `ids`
        # holds k rows a lane (make_lane_shader stacks children)
        if not textured:
            return gather_mat_rows(tabs.mat, ids, grad=info.mat_grad)
        k = ids.shape[0] // n
        if info.pexpr:
            ctx_k = texlib.map_lanes(ctx, lambda c: torch.cat([c] * k))
        else:
            # the other kinds read the uv alone
            ctx_k = ctx._replace(uv=tuple(torch.cat([c] * k)
                                          for c in ctx.uv))
        return apply_textures(*gather_mat_rows(tabs.mat, ids, with_tex=True,
                                               grad=info.mat_grad),
                              ev, ctx_k, info)
    shader = bsdflib.make_lane_shader(gather_row, mid, mat, frame,
                                      surf.is_entering, info.blend_depth,
                                      w_override, present, scene.measured)
    return Shading(surf, frame, shader, ctx)


def hit_emission(scene: SceneData, settings: RenderSettings,
                 tabs: RenderTables, state, inv_pdf, active, hit: Hit,
                 sh: Shading):
    """(lanes that see an area emitter's front, its radiance, the MIS
    weight of that hit against NEE with `inv_pdf`)."""
    lights = scene.lights
    surf = sh.surf
    light_row = scene.entities.light[torch.clamp(surf.ent, min=0).long()]
    hit_row = torch.clamp(light_row, min=0)
    lp_hit = lightlib.gather_light(lights, hit_row)
    cos_l = -dot(state.dir, sh.frame.n)
    emit_ok = active & (light_row >= 0) & surf.is_entering & (cos_l > 1e-6)
    pdf_area = safe_div(1.0, lp_hit.p0)
    # miss lanes carry t = FLT_MAX and cos_l may be <= 0: sanitise so that
    # reverse mode meets no inf or NaN on the masked lanes
    t_safe = torch.where(emit_ok, hit.t, 1.0)
    cos_safe = torch.where(emit_ok, cos_l, 1.0)
    pdf_s = pdf_area * t_safe * t_safe / cos_safe
    esel_pdf = lightlib.selector_pdf(settings, lights, hit_row, state.org,
                                     tabs.info.hier_depth)
    if settings.enable_nee:
        mis_e = 1.0 / (1.0 + inv_pdf * esel_pdf * pdf_s)
    else:
        mis_e = torch.ones_like(pdf_s)
    return emit_ok, lp_hit.intensity, mis_e


class NeeSample(NamedTuple):
    lp: lightlib.LightParams
    ls: lightlib.DirectSample
    pdf_l_s: torch.Tensor    # light pdf in solid angle, selection included
    bsdf_f: Color
    bsdf_p: torch.Tensor
    factor: torch.Tensor


def sample_nee(scene: SceneData, settings: RenderSettings,
               tabs: RenderTables, rng, sh: Shading, out_dir: Vec3):
    """(rng, NeeSample): a light picked by the selector, a point on it,
    and the BSDF's value and pdf towards it."""
    lights = scene.lights
    kinds = tuple(int(k) for k in settings.light_kinds or ())
    surf = sh.surf
    rng, (ul, u0, u1) = rnglib.next_f32_n(rng, 3)
    lsel, sel_pdf = lightlib.select_light(settings, lights, ul, surf.point,
                                          tabs.info.hier_depth)
    lp = lightlib.gather_light(lights, lsel)
    ls = lightlib.sample_direct(scene, lp, surf.point, surf.is_entering, u0,
                                u1, light_texture(tabs), kinds)
    pdf_l_s = lightlib.pdf_as_solid(ls.pdf_value, ls.pdf_is_area, ls.cos,
                                    ls.dist * ls.dist) * sel_pdf
    return rng, NeeSample(lp, ls, pdf_l_s, sh.shader.eval(ls.dir, out_dir),
                          sh.shader.pdf(ls.dir, out_dir),
                          safe_div(ls.pdf_value, pdf_l_s))


def shadow_rays_of(nee: NeeSample, surf: Surface, want) -> Rays:
    """The shadow segment from the hit to the light sample: finite lights
    aim at the sampled point (range [o, 1-o]); unwanted lanes get
    tmax < tmin, so the kernels cull them."""
    sdir = vselect(nee.lp.infinite, nee.ls.dir, nee.ls.pos - surf.point)
    stmax = torch.where(nee.lp.infinite, FLT_MAX, 1.0 - OFFSET)
    stmax = torch.where(want, stmax, -1.0)
    return Rays(surf.point, sdir, torch.full_like(stmax, OFFSET), stmax)


def through_inv_pdf(bs: bsdflib.BsdfSample, out_dir: Vec3, old_inv_pdf,
                    new_inv_pdf):
    """A straight-through delta transmission (passthrough, thin glass, a
    BRTDfunc's transmission) keeps the direction measure, so the path's
    MIS density carries through the interface: its old inv_pdf stays,
    which keeps the transparent-shadow NEE and the light hit behind the
    interface complementary."""
    is_through = bs.is_delta & (dot(bs.in_dir, -out_dir) > 1.0 - 1e-6)
    return torch.where(is_through, old_inv_pdf, new_inv_pdf)


def regenerate(scene: SceneData, settings: RenderSettings, regen, state,
               cont):
    """(lanes that restart, their sample counters, their camera rays, their
    random states): lanes whose path ended with samples of their pixel
    left restart the next one."""
    x, y, iteration, frame_id = regen
    do_regen = state.alive & ~cont & (state.sample + 1 < settings.spi)
    new_sample = torch.where(do_regen, state.sample + 1, state.sample)
    fresh = rnglib.seed(new_sample, iteration, frame_id, x, y, settings.seed)
    sample_idx = (rnglib.as_u32(new_sample)
                  + iteration * settings.spi) & rnglib.MASK
    fresh2, (rx, ry) = sample_pixel_offsets(settings.pixel_sampler, fresh,
                                            sample_idx, x, y)
    cam = cameralib.generate_rays(scene.camera, settings, x, y, rx, ry,
                                  rng_state=fresh2)
    return do_regen, new_sample, cam, fresh2


def make_bounce(scene: SceneData, settings: RenderSettings,
                tabs: RenderTables, regen=None):
    """Per-bounce wavefront step over the render's `tabs`. With `regen` =
    (x, y, iteration, frame), lanes whose path ended restart the next
    sample of their pixel."""
    n_lights = settings.n_lights

    def bounce(state: PathState) -> PathState:
        rays_b = Rays(state.org, state.dir, state.tmin,
                      torch.where(state.alive, state.tmax, -1.0))
        hit = trace_scene(scene, rays_b, tabs.packed, tabs.inst)
        found = hit.prim >= 0
        result = env_miss(scene, settings, tabs, state, state.inv_pdf,
                          state.alive & ~found, state.result)

        # ---- hit shading -----------------------------------------------
        active = state.alive & found
        sh = shade_hit(scene, settings, tabs, rays_b, hit)
        surf, shader = sh.surf, sh.shader
        out_dir = -state.dir
        all_delta = shader.is_all_delta()
        emit_ok, intensity, mis_e = hit_emission(
            scene, settings, tabs, state, state.inv_pdf, active, hit, sh)
        result = _cadd_where(emit_ok, result, _handle_color(
            state.contrib.cmul(intensity) * mis_e, settings))

        rng = state.rng
        depth = state.depth

        # ---- NEE -------------------------------------------------------
        if settings.enable_nee and n_lights > 0:
            rng, nee = sample_nee(scene, settings, tabs, rng, sh, out_dir)
            mis = torch.where(nee.lp.delta, 1.0,
                              1.0 / (1.0 + safe_div(nee.bsdf_p, nee.pdf_l_s)))
            contrib_nee = _handle_color(
                nee.ls.intensity.cmul(state.contrib.cmul(nee.bsdf_f))
                * (mis * nee.factor), settings)
            want = (active & ~all_delta & (depth + 1 <= settings.max_depth)
                    & (nee.pdf_l_s > 1e-9) & (nee.ls.cos > 1e-6)
                    & (color_max_component(contrib_nee) > 0))
            shadow_rays = shadow_rays_of(nee, surf, want)
            if settings.transparent_shadows:
                s_tint = shadow_transmittance(scene, settings, shadow_rays,
                                              tabs)
                result = _cadd_where(
                    want & (color_max_component(s_tint) > 0.0), result,
                    contrib_nee.cmul(s_tint))
            else:
                occ = occluded_scene(scene, shadow_rays, tabs.packed,
                                     tabs.inst)
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
        if settings.transparent_shadows:
            new_inv_pdf = through_inv_pdf(bs, out_dir, state.inv_pdf,
                                          new_inv_pdf)

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

        do_regen, new_sample, cam, fresh2 = regenerate(scene, settings,
                                                       regen, state, cont)
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
                iteration: int, frame: int, initial=initial_state):
    """Camera rays of every lane's first sample, in the state `initial`
    makes of them."""
    st0 = rnglib.seed(torch.zeros_like(x), iteration, frame, x, y,
                      settings.seed)
    st0, (rx, ry) = sample_pixel_offsets(settings.pixel_sampler, st0,
                                         iteration * settings.spi, x, y)
    rays = cameralib.generate_rays(scene.camera, settings, x, y, rx, ry,
                                   rng_state=st0)
    return initial(rays, st0)


def technique_fns(settings: RenderSettings):
    """(initial state, bounce maker) of the settings' technique: the
    cascade's technique adapter (ignis_tpu/techniques/path.py:961-978)."""
    if settings.technique == "volpath":
        from .volpath import make_vol_bounce, vol_initial_state
        return vol_initial_state, make_vol_bounce
    return initial_state, make_bounce


def bucket_chain(n: int, min_bucket: int):
    """Cascade of bucket sizes: n, n/SHRINK, ... down to min_bucket."""
    sizes = [n]
    while sizes[-1] // SHRINK >= min_bucket:
        sizes.append(sizes[-1] // SHRINK)
    return sizes


def render_lanes(scene: SceneData, settings: RenderSettings, x, y,
                 iteration: int, frame: int, compact: bool = True,
                 remat: bool = False, eval_texture=None) -> Color:
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
    repeats the same decisions.

    The technique's bounce (path or volpath, technique_fns) runs in
    either. `eval_texture` is the scene's texture evaluator (made here
    when not given); the render's tables are made once here
    (render_tables)."""
    n = x.shape[0]
    device = x.device
    sizes = bucket_chain(n, MIN_BUCKET) if compact else [n]
    initial, make = technique_fns(settings)
    tabs = render_tables(scene, settings, eval_texture)
    st = start_state(scene, settings, x, y, iteration, frame, initial)
    film = torch.zeros((3, n), dtype=torch.float32, device=device)
    budget = settings.spi * settings.max_depth
    px, py = x, y
    l0 = torch.arange(n, device=device)
    for si, size in enumerate(sizes):
        last = si == len(sizes) - 1
        min_alive = 0 if last else size // SHRINK
        bounce = make(scene, settings, tabs, (px, py, iteration, frame))

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
