"""Bridge from the JAX package's scene arrays to the port's tensors.

`from_reference(scene_data, settings, device)` walks the JAX SceneData's
NamedTuples by field name and calls `np.asarray` on each leaf, so it never
imports JAX itself. Tests use it to feed identical arrays to both
packages. The chunked-leaf TPU BVH is dropped (`bvh` becomes the tri-leaf
BVH8), textures arrive as the port's TexData, instance groups as the
port's InstancedGeo without the JAX local soup's TPU padding (and without
a local BVH, so K2 serves them and local prim ids keep the JAX order),
the measured tables as the port's KlemsData / TensorTreeData / DJData
(Dupuy-Jakob's fr and g as the one gather table), and the parameter
registry as a dict of tensors. A compiled PExpr closure cannot cross
frameworks: the PEXPR textures' closures and the medium closures come
from `closures`, the port's RenderSettings of the same scene built by the
port (build_scene on the same JSON); without it a PEXPR texture has no
closure and PExpr media render with their constant table.
`param_from_reference` carries one JAX parameter in as leaves that
require grad, and `to_numpy` brings the port's gradients back.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import scenedata as sd
from .core.vec import Color, Vec2, Vec3
from .models import djmeasured, klems, tensortree
from .models.texture import TexData, TexDesc
from .ops.bvh import BVHArrays
from .ops.instanced import InstancedGeo
from .ops.intersect import SphereSoup, TriSoup

_PORT_TYPES = {cls.__name__: cls for cls in (
    Vec2, Vec3, Color, TriSoup, SphereSoup, BVHArrays, sd.TriAttributes,
    sd.SphereAttributes, sd.Entities, sd.Materials, sd.Lights, sd.EnvMap,
    sd.CameraData, sd.Media, TexData, klems.KlemsBasisData,
    klems.KlemsComponentData, klems.KlemsData, tensortree.TTComponentData,
    tensortree.TensorTreeData)}


def _leaf(v, device) -> torch.Tensor:
    a = np.asarray(v)
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _convert(v, device):
    if v is None:
        return None
    if isinstance(v, dict):
        return {k: _convert(x, device) for k, x in v.items()}
    if type(v).__name__ == "DJData":
        return djmeasured.DJData(
            _leaf(v.theta_nodes, device), _leaf(v.phi_nodes, device),
            _leaf(djmeasured.table_of(np.asarray(v.fr), np.asarray(v.g)),
                  device),
            _leaf(v.marg_cdf, device), _leaf(v.cond_cdf, device))
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


def from_reference(scene_data, settings, device, closures=None):
    """(JAX SceneData, JAX RenderSettings) -> (port SceneData, port
    RenderSettings) with every leaf on `device`; `closures` (the port's
    RenderSettings of the same scene) supplies the PExpr closures."""
    device = torch.device(device)
    descs = tuple(TexDesc(d.kind, d.wrap_u, d.wrap_v, d.filter, None,
                          d.inner) for d in settings.texture_descs)
    med = ()
    if closures is not None:
        descs = tuple(d._replace(fn=c.fn) for d, c in
                      zip(descs, closures.texture_descs))
        med = closures.medium_exprs
    fields = {f: _convert(getattr(scene_data, f), device)
              for f in sd.SceneData._fields if f not in ("bvh", "instances")}
    fields["bvh"] = (None if scene_data.bvh is None
                     else _convert(scene_data.bvh.tri, device))
    fields["instances"] = (None if scene_data.instances is None else tuple(
        _instance_group(g, device) for g in scene_data.instances))
    port_settings = sd.RenderSettings(**{
        f.name: getattr(settings, f.name)
        for f in dataclasses.fields(sd.RenderSettings)})
    port_settings = dataclasses.replace(port_settings, texture_descs=descs,
                                        medium_exprs=med)
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
