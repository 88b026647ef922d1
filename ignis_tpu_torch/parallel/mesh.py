"""Differentiable-rendering loss and train step, and the film's lanes
sharded over several devices or processes.

Port of ignis_tpu/parallel/mesh.py. `loss_fn` is the L2 image loss
w.r.t. the material albedo table, rendered through the differentiable
cascade (settings.remat), and `train_step` one SGD step on
`materials.base` on one device. On a CUDA device a path or volpath scene,
instanced or not (render/session.uses_train_graphs), takes the step by
replaying CUDA graphs of the differentiable cascade (`TrainProgram`,
techniques/cascade.DiffCascadeProgram): the counterpart of jitting
value_and_grad of the JAX loss_fn (train_step_sharded under jax.jit,
ignis_tpu/parallel/mesh.py:154-170). Its loss equals the eager step's
(`train_step_eager`) bit for bit, its albedo gradient up to the order of
K3's scatter atomics. A program is kept for one device and reused while
the settings are equal and every scene tensor but materials.base is the
same tensor, unmodified (`TrainProgram.serves`), so the loop `loss, scene
= train_step(scene, ...)` captures once and then copies the albedo, the
target, the iteration and the frame in. `loss_fn`, `train_step_sharded`
and the distributed step stay eager.

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
import time
from typing import NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist

from ..core.vec import Color
from ..render.session import (_image, _pixels, render_iteration,
                              render_technique_lanes, resolve_device,
                              uses_train_graphs)
from ..scenedata import RenderSettings, SceneData, tree_map
from ..techniques import canonical
from ..techniques.cascade import DiffCascadeProgram
from ..techniques.path import render_tables


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


def _l2(img: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean((img - target) ** 2)


def loss_fn(diff_materials, scene: SceneData, settings: RenderSettings,
            target: torch.Tensor, iteration: int, frame: int) -> torch.Tensor:
    """mean((image - target)^2) with materials.base = diff_materials["base"]
    (a Color of [M] tensors); the render always takes the differentiable
    cascade (remat)."""
    img = render_iteration(with_base(scene, diff_materials["base"]),
                           _remat(settings), iteration, frame)
    return _l2(img, target)


def _sgd(base: Color, grads, lr: float) -> Color:
    return Color(*[(p - lr * g).detach() for p, g in zip(base, grads)])


def train_step_eager(scene: SceneData, settings: RenderSettings,
                     target: torch.Tensor, iteration: int, frame: int,
                     lr: float):
    """train_step through loss_fn and autograd, op by op: (loss, new
    scene)."""
    base = Color(*[c.detach().requires_grad_() for c in scene.materials.base])
    loss = loss_fn({"base": base}, scene, settings, target, iteration, frame)
    grads = torch.autograd.grad(loss, list(base))
    return loss.detach(), with_base(scene, _sgd(base, grads, lr))


def _fixed_leaves(scene: SceneData) -> list:
    """Every tensor leaf of `scene` but materials.base."""
    out = []
    tree_map(out.append, with_base(scene, None))
    return out


class TrainProgram:
    """train_step's program for one scene and settings (taken with remat)
    on the scene's device: the render's tables, made once (scene_info
    included) with materials.base requiring grad, and the differentiable
    cascade (DiffCascadeProgram) with its albedo, target, iteration and
    frame buffers. On the card the first `step` captures the programs as
    CUDA graphs (Program.capture: a sizing run for instanced groups, then
    one eager run under torch's sync debug mode "error", in which a host
    sync in any program raises), and every step replays them; on the CPU
    they run as they are. A failed capture raises."""

    def __init__(self, scene: SceneData, settings: RenderSettings):
        settings = _remat(settings)
        dev = scene.device
        self.settings = settings
        self.device = dev
        self._fixed = [(t, t._version) for t in _fixed_leaves(scene)]
        base = scene.materials.base
        grad_base = Color(*[c.detach().requires_grad_() for c in base])
        tabs = render_tables(with_base(scene, grad_base), settings)
        target = torch.zeros((settings.height, settings.width, 3),
                             dtype=torch.float32, device=dev)
        self.target = target
        x, y = _pixels(settings, dev)
        self.program = DiffCascadeProgram(
            scene, settings, tabs, x, y, base,
            lambda film: _l2(_image(film, settings), target))
        self.capture_seconds = None

    def serves(self, scene: SceneData, settings: RenderSettings) -> bool:
        """The reuse rule: equal settings, and every scene tensor but
        materials.base the same tensor as at build with the same
        `_version` (an in-place edit bumps it)."""
        now = _fixed_leaves(scene)
        return (_remat(settings) == self.settings
                and len(now) == len(self._fixed)
                and all(t is u and v == u._version
                        for (t, v), u in zip(self._fixed, now)))

    def step(self, base: Color, target: torch.Tensor, iteration: int,
             frame: int):
        """(loss, gradient w.r.t. materials.base) of loss_fn at `base`,
        as fresh tensors, from a step whose instanced traces fitted their
        pair capacities (DiffCascadeProgram.train runs an overflowed step
        again, so no gradient of one reaches the SGD update)."""
        self.program.set_base(base)
        with torch.no_grad():
            self.target.copy_(target)
        if self.device.type == "cuda" and not self.program.captured:
            t0 = time.perf_counter()
            self.program.capture(iteration, frame)
            self.capture_seconds = time.perf_counter() - t0
        self.program.train(iteration, frame)
        return self.program.loss.clone(), self.program.base_grad()


_PROGRAMS: dict = {}   # device -> the TrainProgram kept for it


def train_program(scene: SceneData, settings: RenderSettings) -> TrainProgram:
    """The TrainProgram of scene.device if it serves `scene` and
    `settings`, else a new one, which replaces it (at most one a
    device)."""
    dev = scene.device
    prog = _PROGRAMS.get(dev)
    if prog is not None and prog.serves(scene, settings):
        return prog
    _PROGRAMS.pop(dev, None)
    del prog            # free the old graphs before the new tables
    _PROGRAMS[dev] = TrainProgram(scene, settings)
    return _PROGRAMS[dev]


def release_programs() -> None:
    """Drop the kept TrainPrograms: their graphs, pools and slots."""
    _PROGRAMS.clear()


def train_step(scene: SceneData, settings: RenderSettings,
               target: torch.Tensor, iteration: int, frame: int, lr: float):
    """One SGD step on materials.base; returns (loss, new scene). Replays
    the kept TrainProgram's CUDA graphs where uses_train_graphs says so,
    else runs train_step_eager."""
    if not uses_train_graphs(scene, settings):
        return train_step_eager(scene, settings, target, iteration, frame,
                                lr)
    loss, grads = train_program(scene, settings).step(
        scene.materials.base, target, iteration, frame)
    base = Color(*[c.detach() for c in scene.materials.base])
    return loss, with_base(scene, _sgd(base, grads, lr))


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
