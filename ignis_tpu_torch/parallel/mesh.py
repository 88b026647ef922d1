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
target, the iteration and the frame in. `loss_fn` stays eager (the JAX
package does not jit it either).

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

On a CUDA scene without remat (session.uses_graphs) the sharded renders
replay kept programs, and for path and volpath (uses_train_graphs) so
does the sharded train step: the counterparts of the jitted
render_iteration_sharded[_compact] and train_step_sharded. Each shard of
this process has its own program over its lanes (`ShardRender`: the
Runtime's make_program; `ShardTrain`: a TrainProgram with the shard's
share of the loss) on a replica of the scene made once a device, kept in
a registry beside the TrainPrograms under (kind, compaction, mesh) and
reused while the settings are equal and every scene tensor (but
materials.base, for the train step) is the same tensor, unmodified;
`release_programs()` drops them all. The shards replay in turn and the
film is assembled, or the gradients summed, after the replays; the
collectives stay outside the graphs, one call a step on the current
stream. `render_sharded_eager` and `train_step_sharded_eager` are the op
by op routes of the CPU and remat, and the programs' reference: the
films and losses are bit-equal to theirs on the same mesh.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist

from ..core.vec import Color
from ..render.session import (_image, _pixels, aept_guiding, make_program,
                              render_iteration, render_technique_lanes,
                              resolve_device, uses_graphs, uses_train_graphs)
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


def render_sharded_eager(scene: SceneData, settings: RenderSettings,
                         iteration: int, frame: int, mesh: RayMesh,
                         compact: bool) -> torch.Tensor:
    """The sharded render op by op, whatever the device: each shard's
    lanes through render_technique_lanes on a copy of the scene, compacting
    as `compact` says. The route of the CPU and of remat, and the
    captured route's reference."""
    parts = []
    for dev, x, y in _shards(settings, mesh):
        c = render_technique_lanes(scene.to(dev), settings, x, y, iteration,
                                   frame, compact=compact)
        parts.append(torch.stack(list(c), -1))
    return _assemble(parts, settings, mesh)


def _snapshot(tensors) -> list:
    return [(t, t._version) for t in tensors]


def _unchanged(snapshot, tensors) -> bool:
    """Whether `tensors` are the snapshot's, each at its `_version` (an
    in-place edit bumps it)."""
    return len(tensors) == len(snapshot) and all(
        t is u and v == u._version for (t, v), u in zip(snapshot, tensors))


def _all_leaves(scene: SceneData) -> list:
    out = []
    tree_map(out.append, scene)
    return out


class ShardRender:
    """The sharded render's programs for one scene, settings, mesh and
    compaction: the counterpart of the jitted render_iteration_sharded
    [_compact] (ignis_tpu/parallel/mesh.py:51-119). Each device of this
    process's shards holds a replica of the scene (the scene itself on
    its own device) and its render tables, made once; each shard a
    program (render/session.make_program) for its lanes over them, the
    shards of a device captured in one graph pool, in shard order. aept's
    shards read one guiding a device, learnt for the frame of the call
    (session.aept_guiding's program) and relearnt into the same tensors
    when the frame changes. `run` replays the shards in turn, each
    shard's radiance copied out of its buffers before the next replays.
    An instanced shard whose traces overflowed its pair capacity reruns
    after a recapture (Program.run), so its result never reaches the
    film."""

    def __init__(self, scene: SceneData, settings: RenderSettings,
                 mesh: RayMesh, compact: bool, iteration: int, frame: int):
        t0 = time.perf_counter()
        self.settings = settings
        self._fixed = _snapshot(_all_leaves(scene))
        self.aept = canonical(settings.technique) == "aept"
        self.guiding = {}          # device -> [frame, guiding] (aept)
        replicas, pools = {}, {}
        self.programs = []
        for dev, x, y in _shards(settings, mesh):
            if dev not in replicas:
                sc = scene.to(dev)
                replicas[dev] = (sc, render_tables(sc, settings))
                if self.aept:
                    self.guiding[dev] = [frame, aept_guiding(
                        sc, settings, frame, replicas[dev][1], True)]
            sc, tabs = replicas[dev]
            g = self.guiding[dev][1] if self.aept else None
            prog = make_program(sc, settings, tabs, x, y, g, pools.get(dev),
                                compact=compact)
            if dev.type == "cuda":
                prog.capture(iteration, frame)
                pools[dev] = prog.pool
            self.programs.append(prog)
        self._replicas = replicas
        self.capture_seconds = time.perf_counter() - t0

    def serves(self, scene: SceneData, settings: RenderSettings) -> bool:
        """The reuse rule: equal settings, and every scene tensor the same
        tensor as at build with the same `_version`."""
        return (settings == self.settings
                and _unchanged(self._fixed, _all_leaves(scene)))

    def _relearn(self, frame: int) -> None:
        for dev, kept in self.guiding.items():
            if kept[0] == frame:
                continue
            sc, tabs = self._replicas[dev]
            new = aept_guiding(sc, self.settings, frame, tabs, True)
            with torch.no_grad():
                for d, v in zip(kept[1], new):
                    d.copy_(v)
            kept[0] = frame

    def run(self, iteration: int, frame: int) -> list:
        """Each shard's [size, 3] lane radiance (lt: [h*w, 3] film), in
        shard order, as fresh tensors."""
        self._relearn(frame)
        return [torch.stack(list(prog.run(iteration, frame)), -1)
                for prog in self.programs]


_SHARDED: dict = {}   # (kind, compact, mesh) -> the ShardRender/ShardTrain


def _kept(key, scene: SceneData, settings: RenderSettings, make):
    """The kept shard programs of `key` if they serve `scene` and
    `settings`, else make() (after dropping the old ones), kept."""
    kept = _SHARDED.get(key)
    if kept is not None and kept.serves(scene, settings):
        return kept
    _SHARDED.pop(key, None)
    del kept            # free the old graphs before the new tables
    _SHARDED[key] = make()
    return _SHARDED[key]


def shard_programs(key):
    """The shard programs kept under `key` (("render", compact, mesh) or
    ("train", True, mesh)), or None."""
    return _SHARDED.get(key)


def _render_sharded(scene: SceneData, settings: RenderSettings,
                    iteration: int, frame: int, mesh: RayMesh,
                    compact: bool) -> torch.Tensor:
    if not uses_graphs(scene, settings):
        return render_sharded_eager(scene, settings, iteration, frame, mesh,
                                    compact)
    shards = _kept(("render", compact, mesh), scene, settings,
                   lambda: ShardRender(scene, settings, mesh, compact,
                                       iteration, frame))
    return _assemble(shards.run(iteration, frame), settings, mesh)


def render_iteration_sharded_compact(scene: SceneData,
                                     settings: RenderSettings,
                                     iteration: int, frame: int,
                                     mesh: RayMesh) -> torch.Tensor:
    """One iteration, [h, w, 3], by the settings' technique; for path and
    volpath each shard runs the compacting cascade on its own lane slice
    (no collective until the film is gathered). The cascade's stages
    depend on a shard's lane count, so its radiance sums group apart from
    a one-shard render's: equal to it to rounding, not bit for bit. Where
    session.uses_graphs says so (a CUDA scene, no remat), the shards
    replay their kept programs (ShardRender), bit-equal to
    render_sharded_eager's film of the same mesh (lt's up to its splat's
    atomics on the card)."""
    return _render_sharded(scene, settings, iteration, frame, mesh, True)


def render_iteration_sharded(scene: SceneData, settings: RenderSettings,
                             iteration: int, frame: int,
                             mesh: RayMesh) -> torch.Tensor:
    """One iteration, [h, w, 3], by the settings' technique, path and
    volpath through the uncompacted per-lane loop
    (render_lanes(compact=False)) on each shard's lane slice. Lanes are
    independent, so the film equals a one-shard one bit for bit (lt's,
    whose shards' films are summed, to rounding). Dispatched as
    render_iteration_sharded_compact is."""
    return _render_sharded(scene, settings, iteration, frame, mesh, False)


def with_base(scene: SceneData, base: Color) -> SceneData:
    """`scene` with its material albedo table replaced by `base`."""
    return scene._replace(materials=scene.materials._replace(base=base))


def _remat(settings: RenderSettings) -> RenderSettings:
    return (settings if settings.remat
            else dataclasses.replace(settings, remat=True))


def _l2(img: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean((img - target) ** 2)


def _share(lanes: torch.Tensor, target: torch.Tensor,
           settings: RenderSettings, n_el: int) -> torch.Tensor:
    """A shard's share of the mean loss: its [size, 3] radiance sums
    scaled by 1/spi against its target rows, summed over n_el."""
    img = lanes * (1.0 / settings.spi)
    return torch.sum((img - target) ** 2) / n_el


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
    they run as they are. A failed capture raises.

    With `lanes` = (x, y), one shard's program (ShardTrain): the cascade
    over those lanes and the loss the shard's share of the mean,
    sum((img - target)^2) / (h*w*3), with `target` its lanes' [len(x), 3]
    rows, as train_step_sharded_eager forms it. `pool` is the CUDA graph
    pool to capture into."""

    def __init__(self, scene: SceneData, settings: RenderSettings,
                 lanes=None, pool=None):
        settings = _remat(settings)
        dev = scene.device
        self.settings = settings
        self.device = dev
        self._fixed = _snapshot(_fixed_leaves(scene))
        base = scene.materials.base
        grad_base = Color(*[c.detach().requires_grad_() for c in base])
        tabs = render_tables(with_base(scene, grad_base), settings)
        if lanes is None:
            x, y = _pixels(settings, dev)
            target = torch.zeros((settings.height, settings.width, 3),
                                 dtype=torch.float32, device=dev)

            def loss_of(film):
                return _l2(_image(film, settings), target)
        else:
            x, y = lanes
            target = torch.zeros((x.shape[0], 3), dtype=torch.float32,
                                 device=dev)
            n_el = settings.width * settings.height * 3

            def loss_of(film):
                return _share(torch.stack(list(film), -1), target,
                              settings, n_el)
        self.target = target
        self.program = DiffCascadeProgram(scene, settings, tabs, x, y, base,
                                          loss_of, pool=pool)
        self.capture_seconds = None

    def serves(self, scene: SceneData, settings: RenderSettings) -> bool:
        """The reuse rule: equal settings, and every scene tensor but
        materials.base the same tensor as at build with the same
        `_version` (an in-place edit bumps it)."""
        return (_remat(settings) == self.settings
                and _unchanged(self._fixed, _fixed_leaves(scene)))

    def step(self, base: Color, target: torch.Tensor, iteration: int,
             frame: int):
        """(loss, gradient w.r.t. materials.base) of the loss at `base`,
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
    """Drop the kept TrainPrograms and shard programs: their graphs,
    pools and slots."""
    _PROGRAMS.clear()
    _SHARDED.clear()


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


class ShardTrain:
    """The sharded train step's programs for one scene, settings (taken
    with remat) and mesh: the counterpart of the jitted
    train_step_sharded (ignis_tpu/parallel/mesh.py:154). Each shard of
    this process a TrainProgram over its lanes (its share of the loss),
    on a replica of the scene on its device, the shards of a device
    captured in one graph pool. The reuse rule is TrainProgram's:
    materials.base is copied in, every other scene tensor must stay."""

    def __init__(self, scene: SceneData, settings: RenderSettings,
                 mesh: RayMesh):
        settings = _remat(settings)
        self.settings = settings
        self._fixed = _snapshot(_fixed_leaves(scene))
        replicas = {}
        self.shards = []
        for dev, x, y in _shards(settings, mesh):
            if dev not in replicas:
                replicas[dev] = scene.to(dev)
            prog = TrainProgram(replicas[dev], settings, (x, y))
            lanes = y.long() * settings.width + x.long()
            self.shards.append((dev, lanes, prog))

    @property
    def capture_seconds(self) -> float:
        return sum(p.capture_seconds or 0.0 for _, _, p in self.shards)

    def serves(self, scene: SceneData, settings: RenderSettings) -> bool:
        return (_remat(settings) == self.settings
                and _unchanged(self._fixed, _fixed_leaves(scene)))

    def shares(self, base: Color, flat_target: torch.Tensor,
               iteration: int, frame: int, first) -> list:
        """Each shard's [1 + 3M] (share of the loss, its albedo gradient)
        on `first`, in shard order; the first call captures each shard's
        programs (into its device's pool)."""
        out, pools = [], {}
        for dev, lanes, prog in self.shards:
            if prog.program.pool is None:
                prog.program.pool = pools.get(dev)
            loss, grads = prog.step(base, flat_target.to(dev)[lanes],
                                    iteration, frame)
            pools[dev] = prog.program.pool
            out.append(torch.cat([loss[None], *grads]).to(first))
        return out


def _check_sharded(settings: RenderSettings) -> None:
    if _splats(settings):
        raise ValueError("train_step_sharded: lt's loss does not split by "
                         "lanes; use train_step")


def _eager_shares(scene: SceneData, settings: RenderSettings,
                  flat_target: torch.Tensor, iteration: int, frame: int,
                  mesh: RayMesh) -> list:
    n_el = settings.width * settings.height * 3
    first = mesh.devices[0]
    out = []
    for dev, x, y in _shards(settings, mesh):
        base = Color(*[c.detach().to(dev).requires_grad_()
                       for c in scene.materials.base])
        c = render_technique_lanes(with_base(scene.to(dev), base), settings,
                                   x, y, iteration, frame)
        lanes = y.long() * settings.width + x.long()
        share = _share(torch.stack(list(c), -1), flat_target.to(dev)[lanes],
                       settings, n_el)
        grads = torch.autograd.grad(share, list(base))
        out.append(torch.cat([share.detach()[None], *grads]).to(first))
    return out


def _sgd_sharded(scene: SceneData, parts: list, lr: float, mesh: RayMesh):
    """Sum the shards' parts in shard order (then all_reduce under a
    group) and take the SGD step: (loss, new scene) on the first
    device."""
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    if mesh.grouped:
        dist.all_reduce(total, op=dist.ReduceOp.SUM)
    first = mesh.devices[0]
    m = scene.materials.base.r.shape[0]
    grads = total[1:].reshape(3, m)
    base = Color(*[c.detach().to(first) for c in scene.materials.base])
    return total[0], with_base(scene.to(first), _sgd(base, grads, lr))


def train_step_sharded_eager(scene: SceneData, settings: RenderSettings,
                             target: torch.Tensor, iteration: int,
                             frame: int, lr: float, mesh: RayMesh):
    """train_step_sharded op by op, whatever the device: each shard's
    share through render_technique_lanes and autograd. The route of the
    CPU and of the techniques but path and volpath, and the captured
    route's reference."""
    _check_sharded(settings)
    settings = _remat(settings)
    parts = _eager_shares(scene, settings, target.reshape(-1, 3), iteration,
                          frame, mesh)
    return _sgd_sharded(scene, parts, lr, mesh)


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
    lanes. Where session.uses_train_graphs says so (path and volpath on a
    CUDA scene), the shards replay their kept programs (ShardTrain): the
    loss equals train_step_sharded_eager's bit for bit, the gradient up to
    the order of K3's scatter atomics; the collective stays outside the
    graphs. Else train_step_sharded_eager."""
    if not uses_train_graphs(scene, settings):
        return train_step_sharded_eager(scene, settings, target, iteration,
                                        frame, lr, mesh)
    _check_sharded(settings)
    shards = _kept(("train", True, mesh), scene, settings,
                   lambda: ShardTrain(scene, settings, mesh))
    parts = shards.shares(scene.materials.base, target.reshape(-1, 3),
                          iteration, frame, mesh.devices[0])
    return _sgd_sharded(scene, parts, lr, mesh)
