"""The sharded render's and train step's shard programs (parallel/mesh.py
ShardRender and ShardTrain) on the CPU, without CUDA graphs: the
dispatch rule is patched so that the programs run as they do on the
card, uncaptured. On small_scene() at 64x64 (spi 1) and at 1, 2 and 4
shards the program films equal the eager sharded films
(render_sharded_eager) bit for bit and the JAX package's sharded films
within tests/test_parallel.py:143's bar; the program train step's loss
equals the eager sharded step's bit for bit, its new albedo within rtol
1e-5 of the eager step's and of JAX's train_step_sharded; every
technique's sharded films at 2 shards on the lit plane; the reuse rule
of the kept programs; lt's sharded step still raises. The same programs
run as CUDA graphs on the card (chip_smoke.py phase 15,
tests/test_torch_cuda.py)."""
import numpy as np
import pytest
import torch

import ignis_tpu_torch
from ignis_tpu_torch.parallel import mesh
from ignis_tpu_torch.techniques import SIMPLE

from test_torch_parallel import (ATOL, LR, RTOL, _base,  # noqa: F401
                                 plane_json, ref)

torch.set_num_threads(1)


@pytest.fixture
def on_programs(monkeypatch):
    """The sharded render and train step take the shard programs on the
    CPU (as on the card), from empty registries."""
    monkeypatch.setattr(mesh, "uses_graphs", lambda *a: True)
    monkeypatch.setattr(mesh, "uses_train_graphs", lambda *a: True)
    monkeypatch.setattr(mesh, "_SHARDED", {})
    monkeypatch.setattr(mesh, "_PROGRAMS", {})


SHARDED = {False: mesh.render_iteration_sharded,
           True: mesh.render_iteration_sharded_compact}


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_program_films_match_eager_and_jax(ref, on_programs, shards):
    """Both sharded renders through the shard programs: bit-equal to the
    eager sharded films of the same mesh, within rtol 2e-4 / atol 2e-5 of
    the JAX package's sharded films; a second call replays the kept
    programs."""
    scene, settings, films, _, _ = ref
    m = mesh.make_mesh(devices=["cpu"] * shards)
    for compact, fn in SHARDED.items():
        got = fn(scene, settings, 0, 0, m)
        kept = mesh.shard_programs(("render", compact, m))
        assert kept is not None and len(kept.programs) == shards
        want = mesh.render_sharded_eager(scene, settings, 0, 0, m, compact)
        assert torch.equal(got, want), compact
        key = "compact" if compact else "uncompacted"
        np.testing.assert_allclose(got.numpy(), films[key], rtol=RTOL,
                                   atol=ATOL, err_msg=key)
        again = fn(scene, settings, 1, 0, m)
        assert mesh.shard_programs(("render", compact, m)) is kept
        assert torch.equal(again, mesh.render_sharded_eager(
            scene, settings, 1, 0, m, compact))
    assert float(got.mean()) > 0.01


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_program_train_step_matches_eager_and_jax(ref, on_programs, shards):
    """The sharded train step through the shard programs: the loss
    bit-equal to the eager sharded step's, the new albedo within rtol
    1e-5 of the eager step's and of the JAX package's train_step_sharded;
    the albedo moved."""
    scene, settings, _, jloss, jbase = ref
    m = mesh.make_mesh(devices=["cpu"] * shards)
    target = torch.zeros((settings.height, settings.width, 3))
    e_loss, e_new = mesh.train_step_sharded_eager(scene, settings, target,
                                                  0, 0, LR, m)
    loss, new = mesh.train_step_sharded(scene, settings, target, 0, 0, LR,
                                        m)
    kept = mesh.shard_programs(("train", True, m))
    assert kept is not None and len(kept.shards) == shards
    assert torch.equal(loss, e_loss)
    np.testing.assert_allclose(float(loss), jloss, rtol=2e-2)
    base = _base(new)
    np.testing.assert_allclose(base, _base(e_new), rtol=1e-5)
    np.testing.assert_allclose(base, jbase, rtol=1e-5)
    assert not np.allclose(base, _base(scene))


@pytest.mark.parametrize("tech", [*SIMPLE, "path", "volpath", "lt", "ppm",
                                  "aept"])
def test_program_films_of_every_technique(plane_json, on_programs, tech):
    """Each technique's sharded films at 2 shards through the shard
    programs, bit-equal to the eager sharded films (on the CPU lt's splat
    adds in one order); aept's shards relearn their guiding for a new
    frame; a non-black film."""
    rt = ignis_tpu_torch.loadFromString(plane_json, device="cpu",
                                        technique=tech, spi=2, photons=500)
    scene, settings = rt.scene, rt.settings
    m = mesh.make_mesh(devices=["cpu"] * 2)
    for compact, fn in SHARDED.items():
        for frame in (0, 1):
            got = fn(scene, settings, 0, frame, m)
            want = mesh.render_sharded_eager(scene, settings, 0, frame, m,
                                             compact)
            assert torch.equal(got, want), (compact, frame)
    assert bool(torch.isfinite(got).all()) and float(got.max()) > 0


def test_reuse_rule(ref, on_programs):
    """A second call with the same scene reuses the kept programs; an
    in-place edit of a scene tensor, or a new mesh shape, makes new ones;
    the train programs stay when only materials.base changes (the SGD
    step's new scene); release_programs() empties both registries."""
    scene, settings, _, _, _ = ref
    scene = scene._replace(materials=scene.materials._replace(
        base=type(scene.materials.base)(
            *[c.clone() for c in scene.materials.base])))
    m2 = mesh.make_mesh(devices=["cpu"] * 2)
    key = ("render", True, m2)
    mesh.render_iteration_sharded_compact(scene, settings, 0, 0, m2)
    kept = mesh.shard_programs(key)
    mesh.render_iteration_sharded_compact(scene, settings, 1, 0, m2)
    assert mesh.shard_programs(key) is kept
    with torch.no_grad():
        scene.materials.base.r.mul_(0.5)
    film = mesh.render_iteration_sharded_compact(scene, settings, 0, 0, m2)
    assert mesh.shard_programs(key) is not kept
    assert torch.equal(film, mesh.render_sharded_eager(scene, settings, 0, 0,
                                                       m2, True))
    m4 = mesh.make_mesh(devices=["cpu"] * 4)
    mesh.render_iteration_sharded_compact(scene, settings, 0, 0, m4)
    four = mesh.shard_programs(("render", True, m4))
    assert four is not None and len(four.programs) == 4
    assert mesh.shard_programs(key) is not None
    target = torch.zeros((settings.height, settings.width, 3))
    _, new = mesh.train_step_sharded(scene, settings, target, 0, 0, LR, m2)
    train = mesh.shard_programs(("train", True, m2))
    loss, _ = mesh.train_step_sharded(new, settings, target, 0, 0, LR, m2)
    assert mesh.shard_programs(("train", True, m2)) is train
    e_loss, _ = mesh.train_step_sharded_eager(new, settings, target, 0, 0,
                                              LR, m2)
    assert torch.equal(loss, e_loss)
    mesh.release_programs()
    assert mesh._SHARDED == {} and mesh._PROGRAMS == {}


def test_lt_train_step_sharded_still_raises(plane_json, on_programs):
    """With the programs' dispatch rule on, lt's sharded step still
    refuses: its loss does not split by lanes."""
    rt = ignis_tpu_torch.loadFromString(plane_json, device="cpu",
                                        technique="lt", spi=1)
    target = torch.zeros((16, 16, 3))
    with pytest.raises(ValueError, match="lt"):
        mesh.train_step_sharded(rt.scene, rt.settings, target, 0, 0, LR,
                                mesh.make_mesh(devices=["cpu"] * 2))
    assert mesh._SHARDED == {}
