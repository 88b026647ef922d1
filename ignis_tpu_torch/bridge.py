"""Bridge from the JAX package's scene arrays to the port's tensors.

`from_reference(scene_data, settings, device)` walks the JAX SceneData's
NamedTuples by field name and calls `np.asarray` on each leaf, so it never
imports JAX itself. Tests use it to feed identical arrays to both
packages. The chunked-leaf TPU BVH is dropped (`bvh` becomes the tri-leaf
BVH8), textures arrive as the port's TexData, instance groups as the
port's InstancedGeo without the JAX local soup's TPU padding (and without
a local BVH, so K2 serves them and local prim ids keep the JAX order), and
what the port does not carry (measured BSDFs, PExpr textures and the
parameter registry) raises naming its ROADMAP item.
`param_from_reference` carries one JAX parameter in as leaves that
require grad, and `to_numpy` brings the port's gradients back.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import scenedata as sd
from .core.vec import Color, Vec2, Vec3
from .models.texture import TexData, TexDesc, check_descs
from .ops.bvh import BVHArrays
from .ops.instanced import InstancedGeo
from .ops.intersect import SphereSoup, TriSoup

_PORT_TYPES = {cls.__name__: cls for cls in (
    Vec2, Vec3, Color, TriSoup, SphereSoup, BVHArrays, sd.TriAttributes,
    sd.SphereAttributes, sd.Entities, sd.Materials, sd.Lights, sd.EnvMap,
    sd.CameraData, sd.Media, TexData)}


def _leaf(v, device) -> torch.Tensor:
    a = np.asarray(v)
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _convert(v, device):
    if isinstance(v, tuple) and hasattr(v, "_fields"):
        cls = _PORT_TYPES[type(v).__name__]
        return cls(**{f: _convert(getattr(v, f), device)
                      for f in cls._fields})
    if isinstance(v, tuple):
        return tuple(_convert(x, device) for x in v)
    return _leaf(v, device)


def param_from_reference(value, device):
    """A JAX parameter (an array, or a NamedTuple of arrays such as a Color
    or Vec3) as the port's type, every leaf a fresh tensor on `device` that
    requires grad."""
    return sd.tree_map(lambda t: t.requires_grad_(),
                       _convert(value, torch.device(device)))


def to_numpy(value):
    """A tensor, or NamedTuples/tuples of tensors, as numpy arrays (a
    gradient brought back for comparison with the JAX package's)."""
    return sd.tree_map(lambda t: t.detach().cpu().numpy(), value)


def from_reference(scene_data, settings, device):
    """(JAX SceneData, JAX RenderSettings) -> (port SceneData, port
    RenderSettings) with every leaf on `device`."""
    device = torch.device(device)
    if scene_data.measured:
        raise NotImplementedError("measured BSDFs are not ported yet "
                                  "(ROADMAP queue 1, item 16)")
    if scene_data.registry:
        raise NotImplementedError("the PExpr parameter registry is not "
                                  "ported yet (ROADMAP queue 1, item 15)")
    descs = tuple(TexDesc(d.kind, d.wrap_u, d.wrap_v, d.filter, None,
                          d.inner) for d in settings.texture_descs)
    check_descs(tuple(d._replace(fn=j.fn) for d, j in
                      zip(descs, settings.texture_descs)))
    fields = {f: _convert(getattr(scene_data, f), device)
              for f in sd.SceneData._fields if f not in ("bvh", "instances")}
    fields["bvh"] = (None if scene_data.bvh is None
                     else _convert(scene_data.bvh.tri, device))
    fields["instances"] = (None if scene_data.instances is None else tuple(
        _instance_group(g, device) for g in scene_data.instances))
    port_settings = sd.RenderSettings(**{
        f.name: getattr(settings, f.name)
        for f in dataclasses.fields(sd.RenderSettings)})
    port_settings = dataclasses.replace(port_settings, texture_descs=descs)
    return sd.SceneData(**fields), port_settings


def _instance_group(g, device) -> InstancedGeo:
    """A JAX InstancedGeo as the port's: the local soup's trailing
    all-zero padding rows dropped, no local BVH."""
    rows = np.stack([np.asarray(c) for v in g.soup for c in v], 1)
    nz = np.flatnonzero(np.any(rows != 0, axis=1))
    t = int(nz[-1]) + 1 if nz.size else 1

    def cut(v):
        return type(v)(*[np.asarray(c)[:t] for c in v])
    return InstancedGeo(
        soup=_convert(type(g.soup)(*[cut(v) for v in g.soup]), device),
        **{f: _convert(cut(getattr(g, f)), device)
           for f in ("n0", "n1", "n2", "uv0", "uv1", "uv2")},
        **{f: _leaf(getattr(g, f), device)
           for f in ("w2l", "nrm_mat", "ent", "shadow_visible", "aabb_min",
                     "aabb_max")})
