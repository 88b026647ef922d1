"""ignis_tpu_torch's sharded render and train step (parallel/mesh.py) and
its process-group layer (parallel/distributed.py) on the CPU, against the
port's one-process render and ignis_tpu's sharded functions on
tests/conftest.py's 8-device CPU mesh: films of one-process meshes of 1,
2 and 4 shards (`["cpu"] * k`), the other techniques through the same
shards, the sharded albedo step, a real two-process gloo group,
`initialize`'s refusals and the pinned weak scaling. Scenes are built
once with ignis_tpu.build_scene and bridged."""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ignis_tpu
import ignis_tpu_torch
from ignis_tpu.parallel import mesh as jmesh
from ignis_tpu_torch.bridge import from_reference
from ignis_tpu_torch.parallel import distributed as dist
from ignis_tpu_torch.parallel import mesh
from ignis_tpu_torch.render.session import _pixels, render_iteration
from ignis_tpu_torch.techniques import SIMPLE
from ignis_tpu_torch.techniques.path import render_lanes

from test_components import BASE as COMPONENTS_BASE
from test_parallel import small_scene

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
# tests/test_parallel.py:143's bar for a sharded compacting cascade
RTOL, ATOL = 2e-4, 2e-5
LR = 1e-2


@pytest.fixture(scope="module")
def ref():
    """small_scene() (64x64, spi 1) built once by ignis_tpu and bridged,
    with the JAX package's sharded films and train step on its 8-device
    CPU mesh."""
    rt = ignis_tpu.loadFromString(json.dumps(small_scene()))
    scene, settings = from_reference(rt.scene, rt.settings, "cpu")
    jm = jmesh.make_mesh()
    assert len(jm.devices.reshape(-1)) == 8
    zero = jnp.uint32(0)
    films = {
        "uncompacted": np.asarray(jmesh.render_iteration_sharded(
            rt.scene, rt.settings, zero, zero, jm)),
        "compact": np.asarray(jmesh.render_iteration_sharded_compact(
            rt.scene, rt.settings, zero, zero, jm))}
    target = jnp.zeros((settings.height, settings.width, 3), jnp.float32)
    loss, new_scene = jmesh.train_step_sharded(
        rt.scene, dataclasses.replace(rt.settings, remat=True), target,
        zero, zero, jnp.float32(LR), jm)
    base = np.stack([np.asarray(c) for c in new_scene.materials.base])
    return scene, settings, films, float(loss), base


def _base(scene):
    return np.stack([c.numpy() for c in scene.materials.base])


def _compact_film(scene, settings):
    """The port's one-process compacting render of every lane."""
    x, y = _pixels(settings, "cpu")
    c = render_lanes(scene, settings, x, y, 0, 0, compact=True)
    return (torch.stack(list(c), -1).reshape(settings.height, settings.width,
                                             3) * (1.0 / settings.spi))


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_sharded_films(ref, shards):
    """render_iteration_sharded equals render_iteration bit for bit (its
    lanes are independent); render_iteration_sharded_compact is within
    rtol 2e-4 / atol 2e-5 of the one-process compacting render; both
    within that bar of the JAX package's sharded films."""
    scene, settings, films, _, _ = ref
    assert settings.width * settings.height < 8192   # render_iteration
    m = mesh.make_mesh(devices=["cpu"] * shards)      # does not compact
    assert m.n_shards == shards and not m.grouped
    plain = mesh.render_iteration_sharded(scene, settings, 0, 0, m)
    assert torch.equal(plain, render_iteration(scene, settings, 0, 0))
    compact = mesh.render_iteration_sharded_compact(scene, settings, 0, 0, m)
    np.testing.assert_allclose(compact.numpy(),
                               _compact_film(scene, settings).numpy(),
                               rtol=RTOL, atol=ATOL)
    assert float(compact.mean()) > 0.01
    for got, key in ((plain, "uncompacted"), (compact, "compact")):
        np.testing.assert_allclose(got.numpy(), films[key], rtol=RTOL,
                                   atol=ATOL, err_msg=key)


def test_one_shard_compact_equals_step():
    """World size 1 runs the same lanes through the same cascade as
    Runtime.step(): at 128x128 (compacting) the films are bit-equal."""
    rt = ignis_tpu_torch.loadFromString(json.dumps(small_scene(128)),
                                        device="cpu")
    film = mesh.render_iteration_sharded_compact(
        rt.scene, rt.settings, 0, 0, mesh.make_mesh(devices=["cpu"]))
    rt.step()
    assert torch.equal(film, rt.framebuffer(normalized=True))


def test_uneven_split_raises(ref):
    scene, settings, _, _, _ = ref
    with pytest.raises(ValueError, match="not divisible"):
        mesh.render_iteration_sharded(scene, settings, 0, 0,
                                      mesh.make_mesh(devices=["cpu"] * 3))


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_train_step_sharded(ref, shards):
    """The sharded albedo step against the port's train_step: loss and new
    albedo within rtol 1e-5; against the JAX package's train_step_sharded
    within tests/test_torch_grad.py's bar (rtol 2e-2): the loss, the new
    albedo, and the gradient itself, (old - new) / lr, on every entry
    JAX moves (the one step moves the albedo by well under 2%, so the new
    albedo alone would not see a gradient off by a large factor)."""
    scene, settings, _, jloss, jbase = ref
    target = torch.zeros((settings.height, settings.width, 3))
    loss1, one = mesh.train_step(scene, settings, target, 0, 0, LR)
    loss, new = mesh.train_step_sharded(
        scene, settings, target, 0, 0, LR,
        mesh.make_mesh(devices=["cpu"] * shards))
    base, old = _base(new), _base(scene)
    np.testing.assert_allclose(float(loss), float(loss1), rtol=1e-5)
    np.testing.assert_allclose(base, _base(one), rtol=1e-5)
    assert not np.allclose(base, old)
    np.testing.assert_allclose(float(loss), jloss, rtol=2e-2)
    np.testing.assert_allclose(base, jbase, rtol=2e-2)
    grad = (old.astype(np.float64) - base) / LR
    jgrad = (old.astype(np.float64) - jbase) / LR
    moved = jgrad != 0
    assert moved.sum() >= 3 and np.array_equal(moved, grad != 0)
    np.testing.assert_allclose(grad[moved], jgrad[moved], rtol=2e-2)


WORKER = r"""
import json, sys
sys.path.insert(0, {repo!r})
import numpy as np
import torch
torch.set_num_threads(1)
import ignis_tpu_torch
from ignis_tpu_torch.parallel import distributed as dist

assert dist.initialize(device="cpu")
assert torch.distributed.get_world_size() == 2
mesh = dist.global_mesh()
assert mesh.n_shards == 2 and mesh.devices == (torch.device("cpu"),)
rt = ignis_tpu_torch.loadFromString({scene!r}, device="cpu")
film = dist.render_distributed(rt.scene, rt.settings, mesh, 0, 0)
np.save({out!r}, film)
loss, new = dist.train_step_distributed(rt.scene, rt.settings,
                                        np.zeros_like(film), 0, 0, 1e-2,
                                        mesh)
print("RESULT", json.dumps({{"loss": loss, "base": [
    float(c[0]) for c in new.materials.base]}}))
dist.shutdown(mesh)
"""


def test_two_process_gloo_group(ref, tmp_path):
    """Two OS processes form a gloo group from the IGNIS_* variables (as
    tests/test_distributed.py:68's do), each render its half of the lanes
    and gather the film, then take one sharded albedo step: both hold the
    same film, loss and new albedo, the film within the compacting bar of
    the one-process render, the loss within rtol 1e-5 of train_step's."""
    scene, settings, _, _, _ = ref
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "IGNIS_COORDINATOR",
                        "IGNIS_NUM_PROCESSES", "IGNIS_PROCESS_ID")}
    env.update(IGNIS_COORDINATOR=f"127.0.0.1:{dist.free_port()}",
               IGNIS_NUM_PROCESSES="2", OMP_NUM_THREADS="1")
    procs = []
    for pid in range(2):
        code = WORKER.format(repo=str(REPO), scene=json.dumps(small_scene()),
                             out=str(tmp_path / f"film{pid}.npy"))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code], env=dict(env,
                                                   IGNIS_PROCESS_ID=str(pid)),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    results = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=240)
            assert p.returncode == 0, f"worker failed:\n{out[-2000:]}\n" \
                                      f"{err[-2000:]}"
            line = [ln for ln in out.splitlines() if ln.startswith("RESULT")]
            results.append(json.loads(line[0][len("RESULT "):]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    films = [np.load(tmp_path / f"film{pid}.npy") for pid in range(2)]
    np.testing.assert_array_equal(films[0], films[1])
    assert results[0] == results[1]
    np.testing.assert_allclose(films[0],
                               _compact_film(scene, settings).numpy(),
                               rtol=RTOL, atol=ATOL)
    loss1, _ = mesh.train_step(scene, settings,
                               torch.zeros(films[0].shape), 0, 0, LR)
    np.testing.assert_allclose(results[0]["loss"], float(loss1), rtol=1e-5)


def test_initialize_without_a_group(monkeypatch):
    """No coordinator and no process count: no group (False). CUDA asked
    for without a card: raises, and forms no gloo group instead; so does
    a mesh of the default devices."""
    for k in ("IGNIS_COORDINATOR", "IGNIS_NUM_PROCESSES", "IGNIS_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    assert dist.initialize() is False
    assert not torch.distributed.is_initialized()
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dist.initialize(coordinator=f"127.0.0.1:{dist.free_port()}",
                        num_processes=1, process_id=0)
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.make_mesh()
    with pytest.raises(ValueError, match="coordinator"):
        dist.initialize(num_processes=2)


def test_pinned_weak_scaling_tiny_rows():
    """pinned_weak_scaling at 16 rows a rank: an efficiency over the world
    sizes this machine's cores allow, or an honest `skipped`."""
    out = dist.pinned_weak_scaling(rows_per_rank=16)
    if "skipped" in out:
        assert isinstance(out["skipped"], str)
        return
    assert not any(k.endswith("_error") for k in map(str, out)), out
    ks = sorted(k for k in out if isinstance(k, int))
    assert ks[0] == 1 and len(ks) >= 2
    assert all(out[k] > 0 for k in ks) and out["efficiency"] > 0


def test_scaling_report_on_the_cpu():
    """scaling_report on a CPU runtime: Msamples/s of one-process meshes
    of 1 and 2 shards and their overhead efficiency (their ratio,
    unclamped), and no world size or multi-card claim, since no card is
    involved."""
    out = dist.scaling_report(
        lambda: ignis_tpu_torch.loadFromString(json.dumps(small_scene()),
                                               device="cpu"),
        shard_counts=(1, 2), iters=1)
    assert out["device"] == "cpu"
    assert all(out["spmd_overhead"][k] > 0 for k in (1, 2))
    assert out["spmd_overhead_efficiency"] == (out["spmd_overhead"][2]
                                               / out["spmd_overhead"][1])
    assert "world_sizes" not in out and "multi_card" not in out


def test_ao_sharded_matches_jax():
    """small_scene() under ao: the port's 2-shard render_iteration_sharded
    equals its render_iteration bit for bit and is within 1e-5 (abs and
    rel, tests/test_torch_techniques.py's bar) of the JAX package's
    render_iteration_sharded on a mesh of 2 of its CPU devices, which
    dispatches the technique per sample."""
    sc = small_scene()
    sc["technique"] = {"type": "ao"}
    rt = ignis_tpu.loadFromString(json.dumps(sc))
    scene, settings = from_reference(rt.scene, rt.settings, "cpu")
    zero = jnp.uint32(0)
    want = np.asarray(jmesh.render_iteration_sharded(
        rt.scene, rt.settings, zero, zero, jmesh.make_mesh(2)))
    m = mesh.make_mesh(devices=["cpu"] * 2)
    got = mesh.render_iteration_sharded(scene, settings, 0, 0, m)
    assert torch.equal(got, render_iteration(scene, settings, 0, 0))
    assert float(got.mean()) > 0.01
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def plane_json():
    """tests/test_components.py's lit plane before a constant env at
    16x16 (tests/test_torch_techniques.py's every-technique scene)."""
    sc = json.loads(json.dumps(COMPONENTS_BASE))
    sc["film"] = {"size": [16, 16]}
    sc["shapes"][0]["width"] = sc["shapes"][0]["height"] = 1.5
    sc["lights"].append({"type": "env", "name": "E",
                         "radiance": [0.1, 0.1, 0.1]})
    return json.dumps(sc)


@pytest.mark.parametrize("tech", [*SIMPLE, "volpath", "lt", "ppm", "aept"])
def test_sharded_films_of_every_technique(plane_json, tech):
    """Each technique through both sharded renders at 2 shards against
    render_iteration: bit for bit, but for lt (whose shards' films are
    summed, in another order than one film's splats) within rtol 1e-5 /
    atol 1e-7, and volpath's compacting render within the cascade's bar;
    a non-black film."""
    rt = ignis_tpu_torch.loadFromString(plane_json, device="cpu",
                                        technique=tech, spi=2, photons=500)
    scene, settings = rt.scene, rt.settings
    want = render_iteration(scene, settings, 0, 0)
    m = mesh.make_mesh(devices=["cpu"] * 2)
    for fn in (mesh.render_iteration_sharded,
               mesh.render_iteration_sharded_compact):
        got = fn(scene, settings, 0, 0, m)
        if tech == "lt":
            np.testing.assert_allclose(got.numpy(), want.numpy(),
                                       rtol=1e-5, atol=1e-7)
        elif tech == "volpath" and fn is mesh.render_iteration_sharded_compact:
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL,
                                       atol=ATOL)
        else:
            assert torch.equal(got, want), fn.__name__
    assert bool(torch.isfinite(want).all()) and float(want.max()) > 0


def test_lt_train_step_sharded_raises(plane_json):
    """lt splats each lane's light paths over the whole film, so its loss
    does not split by lanes: the sharded step refuses it."""
    rt = ignis_tpu_torch.loadFromString(plane_json, device="cpu",
                                        technique="lt", spi=1)
    target = torch.zeros((16, 16, 3))
    with pytest.raises(ValueError, match="lt"):
        mesh.train_step_sharded(rt.scene, rt.settings, target, 0, 0, LR,
                                mesh.make_mesh(devices=["cpu"] * 2))


def test_make_mesh_takes_one_of_its_arguments():
    with pytest.raises(ValueError, match="not both"):
        mesh.make_mesh(n_devices=2, devices=["cpu"] * 4)


@pytest.mark.parametrize("tech", ["volpath", "ppm", "aept"])
def test_train_step_sharded_of_other_techniques(plane_json, tech):
    """The sharded albedo step renders as train_step does for the other
    techniques whose film depends on the albedo: loss and new albedo at 2
    shards within rtol 1e-5 of train_step's, and the albedo moved."""
    rt = ignis_tpu_torch.loadFromString(plane_json, device="cpu",
                                        technique=tech, spi=2, photons=500)
    target = torch.zeros((16, 16, 3))
    loss1, one = mesh.train_step(rt.scene, rt.settings, target, 0, 0, LR)
    loss, new = mesh.train_step_sharded(rt.scene, rt.settings, target, 0, 0,
                                        LR, mesh.make_mesh(devices=["cpu"] * 2))
    np.testing.assert_allclose(float(loss), float(loss1), rtol=1e-5)
    np.testing.assert_allclose(_base(new), _base(one), rtol=1e-5)
    assert not np.allclose(_base(new), _base(rt.scene))
