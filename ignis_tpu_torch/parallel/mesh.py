"""Differentiable-rendering loss and train step on one device.

Port of the one-device body of ignis_tpu/parallel/mesh.py: `loss_fn` is
the L2 image loss w.r.t. the material albedo table, rendered through the
differentiable cascade (settings.remat), and `train_step` is
`train_step_sharded` without the mesh: one SGD step on `materials.base`.
Sharding rays over several GPUs is ROADMAP queue 1, item 18.
"""
from __future__ import annotations

import dataclasses

import torch

from ..core.vec import Color
from ..render.session import render_iteration
from ..scenedata import RenderSettings, SceneData


def with_base(scene: SceneData, base: Color) -> SceneData:
    """`scene` with its material albedo table replaced by `base`."""
    return scene._replace(materials=scene.materials._replace(base=base))


def loss_fn(diff_materials, scene: SceneData, settings: RenderSettings,
            target: torch.Tensor, iteration: int, frame: int) -> torch.Tensor:
    """mean((image - target)^2) with materials.base = diff_materials["base"]
    (a Color of [M] tensors); the render always takes the differentiable
    cascade (remat)."""
    if not settings.remat:
        settings = dataclasses.replace(settings, remat=True)
    img = render_iteration(with_base(scene, diff_materials["base"]), settings,
                           iteration, frame)
    return torch.mean((img - target) ** 2)


def train_step(scene: SceneData, settings: RenderSettings,
               target: torch.Tensor, iteration: int, frame: int, lr: float):
    """One SGD step on materials.base; returns (loss, new scene)."""
    base = Color(*[c.detach().requires_grad_() for c in scene.materials.base])
    loss = loss_fn({"base": base}, scene, settings, target, iteration, frame)
    grads = torch.autograd.grad(loss, list(base))
    new_base = Color(*[(p - lr * g).detach() for p, g in zip(base, grads)])
    return loss.detach(), with_base(scene, new_base)
