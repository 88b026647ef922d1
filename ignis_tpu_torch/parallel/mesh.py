"""Differentiable-rendering loss and train step, and the film's lanes
sharded over several devices or processes.

Port of ignis_tpu/parallel/mesh.py. `loss_fn` is the L2 image loss
w.r.t. the material albedo table, rendered through the differentiable
cascade (settings.remat), and `train_step` one SGD step on
`materials.base` on one device.

The sharded functions split the film's h*w lanes, in row-major pixel
order (render/session._pixels), into n_shards contiguous slices of equal
size; shard r renders lanes [r*n/k, (r+1)*n/k) by the settings'
technique (render/session.render_technique_lanes, as render_iteration
dispatches) with the scene replicated, so path's compacting cascade
stays local to the shard. lt's shards each splat their lanes' light
paths over the whole film, and their films are summed. A `RayMesh`
holds the shards of this
process: several devices in one process (each shard's slice runs on its
own device in turn, and the film is assembled on the first device), or,
under an initialised torch.distributed group, one device a process (the
slices are assembled by all_gather_into_tensor and the albedo gradients
summed by all_reduce). The JAX package's 32x32 lane tiling is TPU
machinery and is not carried over.
"""
from __future__ import annotations

import dataclasses
import os
from typing import NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist

from ..core.vec import Color
from ..render.session import (_pixels, render_iteration,
                              render_technique_lanes, resolve_device)
from ..scenedata import RenderSettings, SceneData
from ..techniques import canonical


class RayMesh(NamedTuple):
    """The shards of one process: `devices` (one a shard, repeats allowed)
    and whether they run under torch.distributed's default group, with
    this process's rank and the world size (each process holds the same
    number of shards). The mesh keeps no reference to the group, so that
    destroy_process_group frees it."""
    devices: tuple
    grouped: bool = False
    rank: int = 0
    world_size: int = 1

    @property
    def n_shards(self) -> int:
        return len(self.devices) * self.world_size


def make_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence] = None) -> RayMesh:
    """A RayMesh. Without a torch.distributed group: over `devices`
    (e.g. ["cpu"] * 4 or ["cuda:0"] * 4), else the first `n_devices` (all
    by default) CUDA cards; raises when a card is asked for and none is
    present. Under a group: one device for this process, `devices[0]`
    when given, else cuda:LOCAL_RANK (rank modulo the card count without
    that variable). `n_devices` and `devices` exclude each other."""
    if n_devices is not None and devices is not None:
        raise ValueError("make_mesh takes n_devices or devices, not both")
    if dist.is_initialized():
        if devices is not None and len(devices) != 1:
            raise ValueError("a mesh under a process group has one device "
                             f"a process, got {len(devices)}")
        dev = (resolve_device(devices[0]) if devices is not None
               else _local_card())
        return RayMesh((dev,), True, dist.get_rank(), dist.get_world_size())
    if devices is None:
        resolve_device("cuda")
        n = torch.cuda.device_count() if n_devices is None else n_devices
        devices = [f"cuda:{i}" for i in range(n)]
    if not devices:
        raise ValueError("a mesh needs at least one device")
    return RayMesh(tuple(resolve_device(d) for d in devices))


def _local_card() -> torch.device:
    resolve_device("cuda")
    local = os.environ.get("LOCAL_RANK")
    index = (int(local) if local is not None
             else dist.get_rank() % torch.cuda.device_count())
    return torch.device("cuda", index)


def _shards(settings: RenderSettings, mesh: RayMesh):
    """(shard device, its lanes' x, y) of each shard of this process."""
    n = settings.width * settings.height
    k = mesh.n_shards
    if n % k:
        raise ValueError(f"film lanes {n} not divisible by {k} shards")
    size = n // k
    out = []
    for j, dev in enumerate(mesh.devices):
        x, y = _pixels(settings, dev)
        lo = (mesh.rank * len(mesh.devices) + j) * size
        out.append((dev, x[lo:lo + size], y[lo:lo + size]))
    return out


def _splats(settings: RenderSettings) -> bool:
    """Whether each shard's render is a whole film (lt's splats) rather
    than its own lanes' radiance."""
    return canonical(settings.technique) == "lt"


def _assemble(parts, settings: RenderSettings, mesh: RayMesh):
    """The [h, w, 3] film (scaled by 1/spi) on the first device from this
    process's shards: [size, 3] lane slices, concatenated and
    all-gathered under a group; or, for lt, [h*w, 3] films, summed and
    all-reduced under a group."""
    first = mesh.devices[0]
    if _splats(settings):
        local = parts[0].to(first)
        for p in parts[1:]:
            local = local + p.to(first)
        if mesh.grouped:
            dist.all_reduce(local, op=dist.ReduceOp.SUM)
    else:
        local = torch.cat([p.to(first) for p in parts])
        if mesh.grouped:
            full = local.new_empty((local.shape[0] * mesh.world_size, 3))
            dist.all_gather_into_tensor(full, local)
            local = full
    return local.reshape(settings.height, settings.width, 3) * (
        1.0 / settings.spi)


def _render_sharded(scene: SceneData, settings: RenderSettings,
                    iteration: int, frame: int, mesh: RayMesh,
                    compact: bool) -> torch.Tensor:
    parts = []
    for dev, x, y in _shards(settings, mesh):
        c = render_technique_lanes(scene.to(dev), settings, x, y, iteration,
                                   frame, compact=compact)
        parts.append(torch.stack(list(c), -1))
    return _assemble(parts, settings, mesh)


def render_iteration_sharded_compact(scene: SceneData,
                                     settings: RenderSettings,
                                     iteration: int, frame: int,
                                     mesh: RayMesh) -> torch.Tensor:
    """One iteration, [h, w, 3], by the settings' technique; for path and
    volpath each shard runs the compacting cascade on its own lane slice
    (no collective until the film is gathered). The cascade's stages
    depend on a shard's lane count, so its radiance sums group apart from
    a one-shard render's: equal to it to rounding, not bit for bit."""
    return _render_sharded(scene, settings, iteration, frame, mesh, True)


def render_iteration_sharded(scene: SceneData, settings: RenderSettings,
                             iteration: int, frame: int,
                             mesh: RayMesh) -> torch.Tensor:
    """One iteration, [h, w, 3], by the settings' technique, path and
    volpath through the uncompacted per-lane loop
    (render_lanes(compact=False)) on each shard's lane slice. Lanes are
    independent, so the film equals a one-shard one bit for bit (lt's,
    whose shards' films are summed, to rounding)."""
    return _render_sharded(scene, settings, iteration, frame, mesh, False)


def with_base(scene: SceneData, base: Color) -> SceneData:
    """`scene` with its material albedo table replaced by `base`."""
    return scene._replace(materials=scene.materials._replace(base=base))


def _remat(settings: RenderSettings) -> RenderSettings:
    return (settings if settings.remat
            else dataclasses.replace(settings, remat=True))


def loss_fn(diff_materials, scene: SceneData, settings: RenderSettings,
            target: torch.Tensor, iteration: int, frame: int) -> torch.Tensor:
    """mean((image - target)^2) with materials.base = diff_materials["base"]
    (a Color of [M] tensors); the render always takes the differentiable
    cascade (remat)."""
    img = render_iteration(with_base(scene, diff_materials["base"]),
                           _remat(settings), iteration, frame)
    return torch.mean((img - target) ** 2)


def _sgd(base: Color, grads, lr: float) -> Color:
    return Color(*[(p - lr * g).detach() for p, g in zip(base, grads)])


def train_step(scene: SceneData, settings: RenderSettings,
               target: torch.Tensor, iteration: int, frame: int, lr: float):
    """One SGD step on materials.base; returns (loss, new scene)."""
    base = Color(*[c.detach().requires_grad_() for c in scene.materials.base])
    loss = loss_fn({"base": base}, scene, settings, target, iteration, frame)
    grads = torch.autograd.grad(loss, list(base))
    return loss.detach(), with_base(scene, _sgd(base, grads, lr))


def train_step_sharded(scene: SceneData, settings: RenderSettings,
                       target: torch.Tensor, iteration: int, frame: int,
                       lr: float, mesh: RayMesh):
    """train_step with the lanes sharded: each shard takes the gradient of
    its slice's share of the mean loss, sum((img - target)^2) / (h*w*3),
    rendered as render_iteration renders it (path and volpath through the
    differentiable cascade); the shares' losses and albedo gradients are
    summed (in turn in this process, then by all_reduce under a group),
    and every rank applies the same SGD step. Returns (loss, new scene) on
    the first device, the same on every rank. lt raises: every lane's
    light paths splat over the whole film, so its loss does not split by
    lanes."""
    if _splats(settings):
        raise ValueError("train_step_sharded: lt's loss does not split by "
                         "lanes; use train_step")
    settings = _remat(settings)
    n_el = settings.width * settings.height * 3
    first = mesh.devices[0]
    flat_target = target.reshape(-1, 3)
    total = None
    for dev, x, y in _shards(settings, mesh):
        base = Color(*[c.detach().to(dev).requires_grad_()
                       for c in scene.materials.base])
        c = render_technique_lanes(with_base(scene.to(dev), base), settings,
                                   x, y, iteration, frame)
        img = torch.stack(list(c), -1) * (1.0 / settings.spi)
        lanes = y.long() * settings.width + x.long()
        share = torch.sum((img - flat_target.to(dev)[lanes]) ** 2) / n_el
        grads = torch.autograd.grad(share, list(base))
        part = torch.cat([share.detach()[None], *grads]).to(first)
        total = part if total is None else total + part
    if mesh.grouped:
        dist.all_reduce(total, op=dist.ReduceOp.SUM)
    m = scene.materials.base.r.shape[0]
    grads = total[1:].reshape(3, m)
    base = Color(*[c.detach().to(first) for c in scene.materials.base])
    return total[0], with_base(scene.to(first), _sgd(base, grads, lr))
