"""Texture nodes: image lookup, procedural patterns and PExpr closures
(port of ignis_tpu/models/texture.py).

Split representation, as in the JAX package:
  - TexDesc: static python ints (kind, wraps, filter, inner texture), part
    of RenderSettings.texture_descs;
  - TexData: tensors (image, uv transform, colours, parameters), the
    SceneData `textures` leaf.
`make_texture_evaluator` returns eval_texture(tex_id, ctx), an unrolled
masked select over the scene's textures. A PEXPR texture evaluates its
compiled closure (scene/pexpr.py, `desc.fn`) on the full ShadeCtx, and may
read other textures through `ctx.textures`.
"""
from __future__ import annotations

from enum import IntEnum
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..core.rng import MASK, mul32
from ..core.vec import Color, Vec2, cselect


class TexKind(IntEnum):
    IMAGE = 0
    CHECKERBOARD = 1
    BRICK = 2
    NOISE = 3       # value noise
    PERLIN = 4
    FBM = 5
    VORONOI = 6
    CELLNOISE = 7
    CONSTANT = 8
    PEXPR = 9
    TRANSFORM = 10  # uv-transform wrapper around desc.inner


class WrapMode(IntEnum):
    REPEAT = 0
    MIRROR = 1
    CLAMP = 2


class FilterMode(IntEnum):
    NEAREST = 0
    BILINEAR = 1
    BICUBIC = 2     # evaluated as bilinear, as in the JAX package


class TexDesc(NamedTuple):
    """Static per-texture descriptor (hashable). `fn` holds a PEXPR
    texture's compiled closure (scene/pexpr.Compiler.compile_color)."""
    kind: int
    wrap_u: int
    wrap_v: int
    filter: int
    fn: object = None
    inner: int = -1


class TexData(NamedTuple):
    """Tensor data of one texture."""
    image: torch.Tensor       # [h, w, 3] for IMAGE, [1, 1, 3] otherwise
    transform: torch.Tensor   # [2, 3] uv affine transform
    color0: torch.Tensor      # [3]
    color1: torch.Tensor      # [3]
    p0: torch.Tensor          # scalar parameters (scale, octaves, ...)
    p1: torch.Tensor
    p2: torch.Tensor          # brick gap_x
    p3: torch.Tensor          # brick gap_y


class ShadeCtx(NamedTuple):
    """What a texture lookup at a surface sees (ignis_tpu/scene/pexpr.py
    ShadeCtx). The non-PExpr kinds read `uv` alone; `ray_dir` (pointing
    away from the surface, PExpr's V) serves the normal-map clamp; the
    other fields are PExpr's variables, built by make_shade_ctx only for
    scenes with a PExpr texture or medium. `textures(tex_id, uv)` gives
    nested lookups, `registry` the scene's live parameters, `dpdu` and
    `dpdv` the raw surface derivatives that bump() reads."""
    uv: tuple
    ray_dir: tuple = None
    point: tuple = None
    np_: tuple = None
    normal: tuple = None
    face_normal: tuple = None
    tangent: tuple = None
    bitangent: tuple = None
    ray_org: tuple = None
    prim_coords: tuple = None
    entity_id: torch.Tensor = None
    pixel: tuple = None
    frontside: torch.Tensor = None
    textures: object = None
    registry: dict = None
    dpdu: tuple = None
    dpdv: tuple = None


def _f32(v, device):
    return torch.as_tensor(np.asarray(v, np.float32), device=device)


def make_image_texture(img, wrap_u=WrapMode.REPEAT, wrap_v=WrapMode.REPEAT,
                       filt=FilterMode.BICUBIC, transform=None,
                       device="cpu"):
    t = np.eye(2, 3) if transform is None else transform
    desc = TexDesc(int(TexKind.IMAGE), int(wrap_u), int(wrap_v), int(filt))
    data = TexData(image=_f32(img, device), transform=_f32(t, device),
                   color0=_f32(np.zeros(3), device),
                   color1=_f32(np.ones(3), device), p0=_f32(0, device),
                   p1=_f32(0, device), p2=_f32(0, device), p3=_f32(0, device))
    return desc, data


def make_procedural(kind: TexKind, color0, color1, p0=0.0, p1=0.0,
                    transform=None, p2=0.0, p3=0.0, inner=-1, device="cpu"):
    t = np.eye(2, 3) if transform is None else transform
    desc = TexDesc(int(kind), 0, 0, 0, inner=int(inner))
    data = TexData(image=_f32(np.zeros((1, 1, 3)), device),
                   transform=_f32(t, device), color0=_f32(color0, device),
                   color1=_f32(color1, device), p0=_f32(p0, device),
                   p1=_f32(p1, device), p2=_f32(p2, device),
                   p3=_f32(p3, device))
    return desc, data


# ---------------------------------------------------------------------------
# Evaluation
# ---------------------------------------------------------------------------

def _affine(tex: TexData, u, v):
    t = tex.transform
    return (t[0, 0] * u + t[0, 1] * v + t[0, 2],
            t[1, 0] * u + t[1, 1] * v + t[1, 2])


def _wrap(x, mode: int):
    if mode == WrapMode.REPEAT:
        return torch.remainder(x, 1.0)
    if mode == WrapMode.MIRROR:
        t = torch.remainder(x, 2.0)
        return torch.where(t > 1.0, 2.0 - t, t)
    return torch.clamp(x, 0.0, 1.0)


def _fetch(img, xi, yi) -> Color:
    h, w = img.shape[0], img.shape[1]
    idx = (torch.clamp(yi, 0, h - 1) * w + torch.clamp(xi, 0, w - 1)).long()
    flat = img.reshape(-1, 3)
    rgb = flat[idx]
    return Color(rgb[:, 0], rgb[:, 1], rgb[:, 2])


def _eval_image(desc: TexDesc, tex: TexData, u, v) -> Color:
    img = tex.image
    h, w = img.shape[0], img.shape[1]
    tu, tv = _affine(tex, u, v)
    uu = _wrap(tu, desc.wrap_u)
    vv = _wrap(tv, desc.wrap_v)
    # image row 0 is the top; uv v = 0 is the bottom
    x = uu * w - 0.5
    y = (1.0 - vv) * h - 0.5
    if desc.filter == FilterMode.NEAREST:
        return _fetch(img, torch.round(x).to(torch.int64),
                      torch.round(y).to(torch.int64))
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    x0 = x0.to(torch.int64)
    y0 = y0.to(torch.int64)
    c00 = _fetch(img, x0, y0)
    c10 = _fetch(img, x0 + 1, y0)
    c01 = _fetch(img, x0, y0 + 1)
    c11 = _fetch(img, x0 + 1, y0 + 1)

    def mix(a, b, t):
        return Color(a.r + (b.r - a.r) * t, a.g + (b.g - a.g) * t,
                     a.b + (b.b - a.b) * t)
    return mix(mix(c00, c10, fx), mix(c01, c11, fx), fy)


def _const(c, like) -> Color:
    return Color(*[c[i].expand(like.shape) for i in range(3)])


def _eval_checkerboard(tex: TexData, u, v) -> Color:
    iu = torch.floor(u * tex.p0).to(torch.int64)
    iv = torch.floor(v * tex.p1).to(torch.int64)
    even = torch.remainder(iu + iv, 2) == 0
    return cselect(even, _const(tex.color0, u), _const(tex.color1, u))


def _hash2(ix, iy):
    """The JAX package's uint32 hash, on int64 tensors holding uint32
    values (core/rng.mul32 keeps every product below 2^63)."""
    h = mul32(ix & MASK, 0x9E3779B1) ^ mul32(iy & MASK, 0x85EBCA77)
    h = h ^ (h >> 13)
    h = mul32(h, 0xC2B2AE35)
    h = h ^ (h >> 16)
    return (h >> 8).to(torch.float32) * (1.0 / 16777216.0)


def _value_noise(u, v):
    x0 = torch.floor(u)
    y0 = torch.floor(v)
    fx = u - x0
    fy = v - y0
    x0 = x0.to(torch.int64)
    y0 = y0.to(torch.int64)
    sx = fx * fx * (3.0 - 2.0 * fx)
    sy = fy * fy * (3.0 - 2.0 * fy)
    n00 = _hash2(x0, y0)
    n10 = _hash2(x0 + 1, y0)
    n01 = _hash2(x0, y0 + 1)
    n11 = _hash2(x0 + 1, y0 + 1)
    return ((n00 * (1 - sx) + n10 * sx) * (1 - sy)
            + (n01 * (1 - sx) + n11 * sx) * sy)


def _mix_colors(tex: TexData, n) -> Color:
    return Color(*[tex.color0[i] + (tex.color1[i] - tex.color0[i]) * n
                   for i in range(3)])


def _eval_noiselike(desc: TexDesc, tex: TexData, u, v) -> Color:
    scale = torch.clamp(tex.p0, min=1e-6)
    x = u * scale
    y = v * scale
    if desc.kind == TexKind.FBM:
        amp, val, tot = 1.0, 0.0, 0.0
        for o in range(4):
            val = val + amp * _value_noise(x * (2 ** o), y * (2 ** o))
            tot += amp
            amp *= 0.5
        n = val / tot
    elif desc.kind == TexKind.CELLNOISE:
        n = _hash2(torch.floor(x).to(torch.int64),
                   torch.floor(y).to(torch.int64))
    elif desc.kind == TexKind.VORONOI:
        x0 = torch.floor(x).to(torch.int64)
        y0 = torch.floor(y).to(torch.int64)
        best = torch.full_like(u, 1e9)
        for dx in (-1, 0, 1):
            for dy in (-1, 0, 1):
                cx = x0 + dx
                cy = y0 + dy
                px = cx.to(torch.float32) + _hash2(cx, cy)
                py = cy.to(torch.float32) + _hash2(cy, cx)
                best = torch.minimum(best, (px - x) ** 2 + (py - y) ** 2)
        n = torch.sqrt(best)
    else:  # NOISE and PERLIN: value noise
        n = _value_noise(x, y)
    return _mix_colors(tex, n)


def _eval_brick(tex: TexData, u, v) -> Color:
    """brick.art node_brick: color0 mortar, color1 brick; odd rows shifted
    by half a brick."""
    tu, tv = _affine(tex, u, v)
    su = tu * tex.p0
    sv = tv * tex.p1
    odd = torch.remainder(sv * 0.5, 1.0) > 0.5
    x = torch.remainder(torch.where(odd, su + 0.5, su), 1.0)
    y = torch.remainder(sv, 1.0)
    inside = ((x <= 1.0 - tex.p2) & (y <= 1.0 - tex.p3)).to(torch.float32)
    return _mix_colors(tex, inside)


def _eval_one(desc: TexDesc, tex: TexData, ctx: ShadeCtx) -> Color:
    u, v = ctx.uv
    if desc.kind == TexKind.IMAGE:
        return _eval_image(desc, tex, u, v)
    if desc.kind == TexKind.CHECKERBOARD:
        return _eval_checkerboard(tex, u, v)
    if desc.kind == TexKind.BRICK:
        return _eval_brick(tex, u, v)
    if desc.kind == TexKind.CONSTANT:
        return _const(tex.color0, u)
    if desc.kind == TexKind.PEXPR:
        return Color(*desc.fn(ctx))
    return _eval_noiselike(desc, tex, u, v)


def _eval_resolved(descs, datas, i: int, ctx: ShadeCtx) -> Color:
    """Texture i, following TRANSFORM wrappers (TransformPattern)."""
    desc, tex = descs[i], datas[i]
    hops = 0
    while desc.kind == TexKind.TRANSFORM and desc.inner >= 0 and hops < 8:
        ctx = ctx._replace(uv=_affine(tex, *ctx.uv))
        desc, tex = descs[desc.inner], datas[desc.inner]
        hops += 1
    return _eval_one(desc, tex, ctx)


def light_ctx(uv: Vec2, ray_dir=None) -> ShadeCtx:
    """The context of a scene without PExpr: uv and the view direction."""
    return ShadeCtx(uv=(uv.x, uv.y), ray_dir=ray_dir)


def make_shade_ctx(uv: Vec2, point=None, normal=None, face_normal=None,
                   ray_dir=None, ray_org=None, prim_coords=None,
                   entity_id=None, pixel=None, frontside=None,
                   tangent=None, bitangent=None, scene_center=None,
                   scene_radius=None, textures=None, registry=None,
                   dpdu=None, dpdv=None) -> ShadeCtx:
    """The full PExpr context (ignis_tpu/models/texture.py:264-291); the
    pieces not given are zeros, Np is the point relative to the scene's
    bounding sphere."""
    z = torch.zeros_like(uv.x)
    zv = (z, z, z)
    npos = zv
    if point is not None and scene_center is not None:
        inv = 1.0 / torch.clamp(torch.as_tensor(scene_radius), min=1e-6)
        npos = ((point[0] - scene_center[0]) * inv,
                (point[1] - scene_center[1]) * inv,
                (point[2] - scene_center[2]) * inv)
    zi = z.to(torch.int32)
    return ShadeCtx(
        uv=(uv.x, uv.y), ray_dir=ray_dir or zv,
        point=point or zv, np_=npos,
        normal=normal or zv, face_normal=face_normal or zv,
        tangent=tangent or zv, bitangent=bitangent or zv,
        ray_org=ray_org or zv, prim_coords=prim_coords or (z, z),
        entity_id=entity_id if entity_id is not None else zi,
        pixel=pixel or (zi, zi),
        frontside=frontside if frontside is not None else z < 1,
        textures=textures, registry=registry, dpdu=dpdu, dpdv=dpdv)


def map_lanes(ctx: ShadeCtx, fn) -> ShadeCtx:
    """`ctx` with `fn` applied to each of its lane tensors (the textures
    and the registry stay)."""
    def one(v):
        if isinstance(v, torch.Tensor):
            return fn(v)
        if isinstance(v, tuple):
            return tuple(one(c) for c in v)
        return v
    return ShadeCtx(*[v if f in ("textures", "registry") else one(v)
                      for f, v in zip(ShadeCtx._fields, ctx)])


def has_pexpr(descs, medium_exprs=()) -> bool:
    """Whether a scene needs the full ShadeCtx: a PEXPR texture or a PExpr
    medium."""
    return (any(d.kind == TexKind.PEXPR for d in descs)
            or any(e is not None for e in medium_exprs or ()))


def make_texture_evaluator(descs: Tuple[TexDesc, ...], datas):
    """eval_texture(tex_id [N] int, ctx, ids=None) -> Color [N], or None
    for a scene without textures; `ctx` is a ShadeCtx or a bare Vec2 uv
    (a PExpr then sees zeros for every variable but uv, as in the JAX
    package).
    `ids`, when given, are the only texture ids tex_id can hold (known
    from the scene's tables), and only those textures are evaluated;
    other lanes get black, as for a tex_id that is no texture."""
    if not descs:
        return None
    pexpr = has_pexpr(descs)

    def eval_texture(tex_id, ctx, ids=None) -> Color:
        if isinstance(ctx, Vec2):
            ctx = make_shade_ctx(ctx) if pexpr else light_ctx(ctx)
        if ctx.textures is None:
            # nested texture references of PExpr closures
            def nested(tid, uvt):
                c = _eval_resolved(descs, datas, tid, ctx._replace(uv=uvt))
                return (c.r, c.g, c.b)
            ctx = ctx._replace(textures=nested)
        z = torch.zeros(tex_id.shape, dtype=torch.float32,
                        device=tex_id.device)
        out = Color(z, z, z)
        for i in range(len(descs)) if ids is None else ids:
            out = cselect(tex_id == i, _eval_resolved(descs, datas, i, ctx),
                          out)
        return out

    return eval_texture
