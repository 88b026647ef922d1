"""Bridge from the JAX package's scene arrays to the port's tensors.

`from_reference(scene_data, settings, device)` walks the JAX SceneData's
NamedTuples by field name and calls `np.asarray` on each leaf, so it never
imports JAX itself. Tests use it to feed identical arrays to both
packages. The chunked-leaf TPU BVH is dropped (`bvh` becomes the tri-leaf
BVH8), and scene features off the slice (textures, measured BSDFs, the
PExpr registry, instancing) raise. `param_from_reference` carries one JAX
parameter in as leaves that require grad, and `to_numpy` brings the port's
gradients back.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import scenedata as sd
from .core.vec import Color, Vec2, Vec3
from .ops.bvh import BVHArrays
from .ops.intersect import SphereSoup, TriSoup

_PORT_TYPES = {cls.__name__: cls for cls in (
    Vec2, Vec3, Color, TriSoup, SphereSoup, BVHArrays, sd.TriAttributes,
    sd.SphereAttributes, sd.Entities, sd.Materials, sd.Lights, sd.EnvMap,
    sd.CameraData, sd.Media)}


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
    if scene_data.textures or scene_data.measured or scene_data.registry \
            or scene_data.instances is not None:
        raise NotImplementedError(
            "textures, measured BSDFs, PExpr parameters and instancing are "
            "not ported yet")
    fields = {f: _convert(getattr(scene_data, f), device)
              for f in sd.SceneData._fields if f != "bvh"}
    fields["bvh"] = (None if scene_data.bvh is None
                     else _convert(scene_data.bvh.tri, device))
    port_settings = sd.RenderSettings(**{
        f.name: getattr(settings, f.name)
        for f in dataclasses.fields(sd.RenderSettings)})
    return sd.SceneData(**fields), port_settings
