"""Several processes rendering one film: the port of
ignis_tpu/parallel/distributed.py on torch.distributed.

One process a device. `initialize` forms the process group (nccl for a
CUDA device, gloo when the caller asks for the CPU), `global_mesh` is the
RayMesh of this process's one device under it, and `render_distributed`
/ `train_step_distributed` run mesh.py's sharded render and train step:
each rank renders its contiguous slice of the film's lanes, the slices
are all-gathered, and the albedo gradients all-reduced, so every rank
ends with the same film, loss and new albedo. On the card each rank
replays its kept shard programs (mesh.ShardRender / ShardTrain, CUDA
graphs) and calls the collective once a step after the replays, outside
the graphs: the counterpart of ignis_tpu's jitted render_distributed /
train_step_distributed.

Usage (per process):

    from ignis_tpu_torch.parallel import distributed as dist
    dist.initialize()                      # False when single-process
    mesh = dist.global_mesh()
    film = dist.render_distributed(rt.scene, rt.settings, mesh, it, frame)
    # film: numpy [h, w, 3], identical on every process

The group's address, size and this process's rank come from the
arguments or from IGNIS_COORDINATOR (host:port), IGNIS_NUM_PROCESSES and
IGNIS_PROCESS_ID.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch
import torch.distributed as tdist

from ..render.session import resolve_device, uses_graphs
from .mesh import (make_mesh, render_iteration_sharded_compact,
                   train_step_sharded)

_TASKSET = "/usr/bin/taskset"
_WEAK_TIMEOUT = 300.0   # seconds a pinned_weak_scaling rank may take


def initialize(coordinator: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               device="cuda") -> bool:
    """Form the process group over TCP at `coordinator` (host:port).
    Returns False when neither a coordinator nor a process count is given
    (one process, no group), True when it formed one. The backend is nccl
    for a CUDA `device` (raising when no card is present) and gloo for
    the CPU; there is no fallback from one to the other."""
    coordinator = coordinator or os.environ.get("IGNIS_COORDINATOR")
    if num_processes is None and "IGNIS_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["IGNIS_NUM_PROCESSES"])
    if process_id is None and "IGNIS_PROCESS_ID" in os.environ:
        process_id = int(os.environ["IGNIS_PROCESS_ID"])
    if coordinator is None and num_processes is None:
        return False
    if coordinator is None or num_processes is None or process_id is None:
        raise ValueError("a process group needs the coordinator, the number "
                         "of processes and this process's id (or "
                         "IGNIS_COORDINATOR, IGNIS_NUM_PROCESSES and "
                         "IGNIS_PROCESS_ID)")
    kind = resolve_device(device).type
    backends = {"cuda": "nccl", "cpu": "gloo"}
    if kind not in backends:
        raise ValueError(f"no process-group backend for device {device!r}")
    tdist.init_process_group(backends[kind],
                             init_method=f"tcp://{coordinator}",
                             world_size=num_processes, rank=process_id)
    return True


def shutdown(mesh) -> None:
    """Wait for every rank, then destroy the group."""
    dev = mesh.devices[0]
    tdist.barrier(device_ids=[dev.index] if dev.type == "cuda" else None)
    tdist.destroy_process_group()


def global_mesh(device=None):
    """The RayMesh of this process under the group: its one device,
    `device` when given, else the CPU under gloo and cuda:LOCAL_RANK under
    nccl."""
    if device is None and tdist.get_backend() == "gloo":
        device = "cpu"
    return make_mesh(devices=None if device is None else [device])


def render_distributed(scene, settings, mesh, iteration: int,
                       frame: int) -> np.ndarray:
    """One render iteration with the lanes sharded over `mesh`: the full
    [h, w, 3] film as numpy, the same on every rank. Every rank calls it
    with the same scene. Dispatched as
    mesh.render_iteration_sharded_compact is (the kept shard programs on
    the card)."""
    img = render_iteration_sharded_compact(scene, settings, iteration,
                                           frame, mesh)
    return img.cpu().numpy()


def train_step_distributed(scene, settings, target, iteration: int,
                           frame: int, lr: float, mesh):
    """One albedo SGD step with the lanes sharded over `mesh`: (loss as a
    float, the same on every rank; new scene). Dispatched as
    mesh.train_step_sharded is (the kept shard programs for path and
    volpath on the card)."""
    loss, new_scene = train_step_sharded(scene, settings,
                                         torch.as_tensor(target), iteration,
                                         frame, lr, mesh)
    return float(loss), new_scene


def _msamples_per_s(fn, settings, iters: int) -> float:
    """Best-of-`iters` Msamples/s of fn(iteration) after a warm-up, each
    run ended by reading the film on the host."""
    float(fn(0).sum())
    best = float("inf")
    for i in range(iters):
        t0 = time.perf_counter()
        float(fn(i + 1).sum())
        best = min(best, time.perf_counter() - t0)
    return settings.width * settings.height * settings.spi / best / 1e6


def scaling_report(build_runtime, shard_counts=(1, 4),
                   iters: int = 3) -> dict:
    """What scaling this machine can show, with no number it cannot.

    - `spmd_overhead`: the same film rendered on one-process meshes of
      each count in `shard_counts`, every shard on the runtime's device,
      through render_iteration_sharded_compact's route for the runtime
      (`route`): on the card the kept shard programs' replays (their
      capture is the warm-up call), on the CPU the eager shards. The
      work is fixed and the device shared, so the ideal is flat wall
      time; `spmd_overhead_efficiency` = Msamples/s at the largest count
      over that at the smallest is what sharding costs: the per-shard
      replays and flag waits (eager: launches and alive-count syncs) and
      the film's assembly.
    - `world_sizes`: the process-group sizes the machine can form on its
      cards (one process a card); with one card only world size 1.

    Weak scaling over processes is pinned_weak_scaling's.

    build_runtime() -> Runtime."""
    rt = build_runtime()
    device = rt.scene.device
    out = {"device": str(device), "spmd_overhead": {},
           "route": ("captured" if uses_graphs(rt.scene, rt.settings)
                     else "eager")}
    for k in shard_counts:
        mesh = make_mesh(devices=[device] * k)
        out["spmd_overhead"][k] = _msamples_per_s(
            lambda it: render_iteration_sharded_compact(
                rt.scene, rt.settings, it, 0, mesh), rt.settings, iters)
    lo, hi = min(shard_counts), max(shard_counts)
    if hi > lo:
        out["spmd_overhead_efficiency"] = (out["spmd_overhead"][hi]
                                           / out["spmd_overhead"][lo])
        out["spmd_overhead_shards"] = f"{lo}->{hi} (fixed work, one device)"
    cards = torch.cuda.device_count() if device.type == "cuda" else 0
    if device.type == "cuda":
        out["world_sizes"] = list(range(1, cards + 1))
        if cards < 2:
            out["multi_card"] = (f"only world size 1 exists here ({cards} "
                                 "card): no multi-card scaling is measured")
    return out


# A pinned_weak_scaling rank: renders a film of 128 x (rows * world) under
# a gloo group and prints its best time of three iterations.
_WEAK_WORKER = r"""
import json, os, sys, time
sys.path.insert(0, sys.argv[1])
import torch
torch.set_num_threads(1)
import ignis_tpu_torch
from ignis_tpu_torch.parallel import distributed as dist
dist.initialize(device="cpu")
world = int(os.environ["IGNIS_NUM_PROCESSES"])
scene = json.loads(sys.argv[2])
scene["film"] = {"size": [128, int(sys.argv[3]) * world]}
rt = ignis_tpu_torch.loadFromString(json.dumps(scene), device="cpu", spi=2)
mesh = dist.global_mesh()
dist.render_distributed(rt.scene, rt.settings, mesh, 0, 0)
times = []
for i in range(3):
    t0 = time.perf_counter()
    dist.render_distributed(rt.scene, rt.settings, mesh, i + 1, 0)
    times.append(time.perf_counter() - t0)
print("WEAK_RESULT", min(times))
dist.shutdown(mesh)
"""

# __graft_entry__._SCENE at max_depth 3: a floor and a glass ball under a
# point light and a constant environment.
WEAK_SCENE = {
    "technique": {"type": "path", "max_depth": 3},
    "camera": {"type": "perspective", "fov": 60, "near_clip": 0.1,
               "far_clip": 100,
               "transform": [-1, 0, 0, 0, 0, 1, 0, 0, 0, 0, -1, 3.85,
                             0, 0, 0, 1]},
    "bsdfs": [{"type": "diffuse", "name": "white",
               "reflectance": [0.8, 0.8, 0.8]},
              {"type": "dielectric", "name": "glass", "int_ior": 1.55}],
    "shapes": [{"type": "rectangle", "name": "floor", "width": 4,
                "height": 4},
               {"type": "sphere", "name": "ball", "radius": 0.5}],
    "entities": [{"name": "floor", "shape": "floor", "bsdf": "white",
                  "transform": [{"rotate": [-90, 0, 0]},
                                {"translate": [0, -1, 0]}]},
                 {"name": "ball", "shape": "ball", "bsdf": "glass"}],
    "lights": [{"type": "point", "name": "l", "position": [0, 2, 2],
                "power": 50},
               {"type": "env", "name": "e", "radiance": [0.1, 0.1, 0.2]}],
}


def free_port() -> int:
    """A TCP port on 127.0.0.1 that is free now, for a group's address."""
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _weak_run(world: int, cores, rows: int):
    """One weak-scaling point: `world` gloo ranks, rank i pinned to
    cores[i]; rank 0's best time, or the first failing rank's error."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("IGNIS_")}
    env.update(IGNIS_COORDINATOR=f"127.0.0.1:{free_port()}",
               IGNIS_NUM_PROCESSES=str(world), OMP_NUM_THREADS="1")
    repo = str(Path(__file__).resolve().parents[2])
    procs = [subprocess.Popen(
        [_TASKSET, "-c", str(cores[r]), sys.executable, "-c", _WEAK_WORKER,
         repo, json.dumps(WEAK_SCENE), str(rows)],
        env=dict(env, IGNIS_PROCESS_ID=str(r)), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=_WEAK_TIMEOUT))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (out, err) in zip(procs, outs):
        if p.returncode != 0:
            return None, (err or out)[-300:]
    line = [ln for ln in outs[0][0].splitlines()
            if ln.startswith("WEAK_RESULT")]
    return float(line[0].split()[1]), None


def pinned_weak_scaling(rows_per_rank: int = 384) -> dict:
    """Weak scaling on the CPU: for world sizes 1, 2, 4 and 8 (as far as
    this process's cores reach), that many gloo ranks, each pinned with
    taskset to one core, render 128 x rows_per_rank lanes each. Returns
    each world size's rank-0 seconds and efficiency = t(1)/t(N) (ideal
    1.0), or `skipped` with the reason."""
    if not shutil.which(_TASKSET):
        return {"skipped": f"no {_TASKSET}"}
    cores = sorted(os.sched_getaffinity(0))
    worlds = [w for w in (1, 2, 4, 8) if w <= len(cores)]
    if len(worlds) < 2:
        return {"skipped": f"only {len(cores)} core(s)"}
    out = {}
    for w in worlds:
        sec, err = _weak_run(w, cores, rows_per_rank)
        if err is not None:
            out[f"{w}_error"] = err
            break
        out[w] = sec
    ks = sorted(k for k in out if isinstance(k, int))
    if len(ks) >= 2:
        out["efficiency"] = out[ks[0]] / out[ks[-1]]
        out["efficiency_ranks"] = (
            f"{ks[0]}->{ks[-1]} (1 pinned core a rank, weak scaling)")
    return out
