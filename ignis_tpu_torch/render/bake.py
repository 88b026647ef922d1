"""PExpr bake-to-texture (port of ignis_tpu/render/bake.py).

Reference: BakeShader::setupTexture2d (src/runtime/shader/BakeShader.h:13)
evaluates a shading expression over a uv grid (entrypoints/bake.art:1-31);
ShadingTree::bakeTexture (ShadingTree.cpp:457) uses it to discretize PExpr
properties, and bakeTextureAverage reduces it to one colour. Here the
expression goes through the port's compiler (scene/pexpr.py) and is
evaluated in one pass over the pixel-centre uv lattice, on `device`: the
card unless the caller passes device="cpu".
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..models.texture import ShadeCtx


def _grid_ctx(w: int, h: int, device, textures=None,
              registry=None) -> ShadeCtx:
    u = (torch.arange(w, dtype=torch.float32, device=device) + 0.5) / w
    v = (torch.arange(h, dtype=torch.float32, device=device) + 0.5) / h
    uu = u[None, :].expand(h, w).reshape(-1)
    vv = v[:, None].expand(h, w).reshape(-1)
    zero = torch.zeros_like(uu)
    one = torch.ones_like(uu)
    zv = (zero, zero, zero)
    return ShadeCtx(
        uv=(uu, vv), point=(uu, vv, zero), np_=(uu, vv, zero),
        normal=(zero, zero, one), face_normal=(zero, zero, one),
        tangent=(one, zero, zero), bitangent=(zero, one, zero),
        ray_dir=(zero, zero, one), ray_org=zv, prim_coords=(uu, vv),
        entity_id=torch.zeros(uu.shape, dtype=torch.int32, device=device),
        pixel=(uu * w, vv * h), frontside=one > 0,
        textures=textures, registry=registry)


def bake_texture2d(expr: str, width: int, height: int,
                   texture_ids: Optional[Dict[str, int]] = None,
                   textures=None, parameters=None, registry=None,
                   device="cuda") -> np.ndarray:
    """A PExpr colour expression over a [height, width] uv lattice:
    float32 [h, w, 3] (bake.art bake_texture2d)."""
    from ..scene.pexpr import Compiler
    from .session import resolve_device
    device = resolve_device(device)
    fn = Compiler(texture_ids or {}, parameters).compile_color(expr)
    with torch.no_grad():
        r, g, b = fn(_grid_ctx(width, height, device,
                               textures=textures, registry=registry))
        img = torch.stack([c.reshape(height, width) for c in (r, g, b)],
                          dim=-1)
    return img.cpu().numpy().astype(np.float32)


def bake_texture_average(expr: str, res: int = 64, **kw) -> np.ndarray:
    """The mean colour of a PExpr expression (ShadingTree
    bakeTextureAverage)."""
    img = bake_texture2d(expr, res, res, **kw)
    return img.reshape(-1, 3).mean(axis=0)
