"""The captured train step's program on the CPU, without CUDA graphs:
parallel/mesh.TrainProgram (techniques/cascade.DiffCascadeProgram)
against the eager train step (train_step_eager: loss_fn through
render_lanes(remat=True) and autograd) on the same arrays: the loss bit
for bit, the albedo gradient and the updated albedo within rtol 1e-5 /
atol 1e-6 * max|g|, no MT replay; against the JAX package's
jax.value_and_grad(loss_fn) at test_torch_grad's bars; each stage's
bounces and budget against eager's; which state leaves carry the albedo's
gradient; the program's reuse rule and the dispatch rule of train_step.
The same programs run as CUDA graphs on the card (chip_smoke.py phase 13,
tests/test_torch_cuda.py)."""
import dataclasses
import json
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ignis_tpu
import ignis_tpu_torch
from ignis_tpu.parallel.mesh import loss_fn as jax_loss_fn
from ignis_tpu_torch.bridge import from_reference, param_from_reference
from ignis_tpu_torch.core.vec import Color
from ignis_tpu_torch.ops import mt_replay
from ignis_tpu_torch.parallel import mesh
from ignis_tpu_torch.parallel.mesh import (TrainProgram, loss_fn, train_step,
                                           train_step_eager)
from ignis_tpu_torch.render.session import uses_train_graphs
from ignis_tpu_torch.techniques import path
from ignis_tpu_torch.techniques.path import grad_carriers, leaves

from test_compaction import SCENE as COMPACTION_SCENE, VOL_SCENE
from test_parallel import small_scene
from test_torch_render import _at

torch.set_num_threads(1)

LR = 1e-2
# name -> (scene dict, film size): the compaction scene runs three
# stages with MIN_BUCKET at 256 (K1), VOL_SCENE under volpath (K1),
# small_scene through K2
SCENES = {"compaction": (COMPACTION_SCENE, 64), "volpath": (VOL_SCENE, 64),
          "small_k2": (small_scene(32), 32)}


def _load(name, spi=4):
    sc, size = SCENES[name]
    rt = ignis_tpu_torch.loadFromString(json.dumps(_at(sc, size)), spi=spi,
                                        device="cpu")
    target = torch.full((size, size, 3), 0.05)
    return rt.scene, rt.settings, target


def _eager_grad(scene, settings, target):
    """(loss, [3, M] albedo gradient) of loss_fn through autograd."""
    base = Color(*[c.detach().requires_grad_()
                   for c in scene.materials.base])
    loss = loss_fn({"base": base}, scene, settings, target, 0, 0)
    return loss.detach(), torch.stack(torch.autograd.grad(loss, list(base)))


def _close(got, want, what):
    """rtol 1e-5, atol 1e-6 * max|want|."""
    atol = 1e-6 * float(want.abs().max())
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=atol, err_msg=what)


@pytest.fixture
def on_program(monkeypatch):
    """train_step takes the program on the CPU (as on the card), from an
    empty program cache."""
    monkeypatch.setattr(mesh, "uses_train_graphs", lambda *a: True)
    monkeypatch.setattr(mesh, "_PROGRAMS", {})
    monkeypatch.setattr(path, "MIN_BUCKET", 256)


@pytest.mark.parametrize("name", list(SCENES))
def test_train_step_matches_eager(name, on_program):
    """train_step through the program against train_step_eager on the same
    arrays: the loss bit for bit, the gradient (the program's) and the
    updated albedo within rtol 1e-5 / atol 1e-6 * max|g| of eager's; the
    albedo moves no ray, so no closest hit takes the MT replay."""
    scene, settings, target = _load(name)
    want_loss, want_g = _eager_grad(scene, settings, target)
    e_loss, e_scene = train_step_eager(scene, settings, target, 0, 0, LR)
    mt_replay.reset_counts()
    loss, new_scene = train_step(scene, settings, target, 0, 0, LR)
    prog = mesh._PROGRAMS[torch.device("cpu")]
    assert mt_replay.counts["plain_calls"] == 0
    assert torch.equal(loss, want_loss) and torch.equal(loss, e_loss)
    g = torch.stack(list(prog.program.base_grad()))
    assert bool((want_g != 0).any())
    _close(g, want_g, "albedo gradient")
    _close(torch.stack(list(new_scene.materials.base)),
           torch.stack(list(e_scene.materials.base)), "updated albedo")
    assert not any(t.requires_grad for t in new_scene.materials.base)
    if name == "compaction":
        assert len(prog.program.stages) == 3


@pytest.mark.parametrize("which", ["compaction_k1", "small_scene_k2"])
def test_program_matches_jax(which):
    """The program's loss and albedo gradient against the JAX package's
    jax.value_and_grad(loss_fn) on the same arrays, at
    test_torch_grad.test_albedo_loss_and_train_step_match_jax's bars
    (32x32, spi 1): the loss and the top gradient entry within rtol
    2e-2."""
    sc = COMPACTION_SCENE if which == "compaction_k1" else small_scene(32)
    rt = ignis_tpu.loadFromString(json.dumps(_at(sc, 32)), spi=1)
    scene, settings = from_reference(rt.scene, rt.settings, "cpu")
    assert (scene.bvh is not None) == (which == "compaction_k1")
    target = np.zeros((32, 32, 3), np.float32)
    jbase = rt.scene.materials.base
    jloss, jgrad = jax.value_and_grad(jax_loss_fn)(
        {"base": jbase}, rt.scene, rt.settings, jnp.asarray(target),
        jnp.uint32(0), jnp.uint32(0))
    ref_g = np.stack([np.asarray(c) for c in jgrad["base"]])
    prog = TrainProgram(scene, settings)
    loss, g = prog.step(param_from_reference(jbase, "cpu"),
                        torch.from_numpy(target), 0, 0)
    got_g = torch.stack(list(g)).numpy()
    np.testing.assert_allclose(float(loss), float(jloss), rtol=2e-2)
    top = np.unravel_index(int(np.argmax(np.abs(ref_g))), ref_g.shape)
    assert ref_g[top] != 0
    np.testing.assert_allclose(got_g[top], ref_g[top], rtol=2e-2)


def _eager_forward_stages(monkeypatch, scene, settings, target):
    """The bounces each stage of loss_fn's forward (render_lanes with
    remat) ran, counted without its backward."""
    stages = []
    real = path.technique_fns

    def fns(s):
        initial, make = real(s)

        def counted_make(*a, **kw):
            bounce = make(*a, **kw)
            stages.append(0)
            k = len(stages) - 1

            def counted(st):
                stages[k] += 1
                return bounce(st)
            return counted
        return initial, counted_make
    with monkeypatch.context() as m:
        m.setattr(path, "technique_fns", fns)
        with torch.no_grad():
            loss_fn({"base": scene.materials.base}, scene, settings, target,
                    0, 0)
    return stages


@pytest.mark.parametrize("max_depth", [8, 2])
def test_stage_counts_match_eager(max_depth, on_program, monkeypatch):
    """Each stage's bounce count and the budget after it equal the eager
    forward's, on the three-stage compaction scene: at max_depth 8 a stage
    runs no bounce; at max_depth 2 the first stage uses up the budget of
    spi * max_depth = 8 and the others run none. The backward replays one
    bounce VJP a bounce."""
    scene, settings, target = _load("compaction")
    settings = dataclasses.replace(settings, max_depth=max_depth)
    stages = _eager_forward_stages(monkeypatch, scene, settings, target)
    prog = TrainProgram(scene, settings)
    vjps = [0]
    real = prog.program._vjp

    def counted(s):
        vjps[0] += 1
        real(s)
    prog.program._vjp = counted
    prog.step(scene.materials.base, target, 0, 0)
    p = prog.program
    budget = settings.spi * max_depth - np.cumsum(stages)
    assert p.stage_it.tolist() == stages == list(p.last.bounces)
    assert p.stage_budget.tolist() == budget.tolist()
    assert vjps[0] == sum(stages)
    if max_depth == 8:
        assert 0 in stages
    else:
        assert stages[0] == 8 and budget[-1] == 0 and stages[1:] == [0, 0]


@pytest.mark.parametrize("name", ["compaction", "volpath"])
def test_grad_carriers(name):
    """The albedo's gradient rides on the throughput and the radiance sum
    only: the rays' origin and direction stay off the tape, so no closest
    hit takes the MT replay backward, as in the eager step."""
    scene, settings, target = _load(name)
    prog = TrainProgram(scene, settings)
    st = prog.program.stages[0].st
    flat = leaves(st)
    carried = {i for i, a in enumerate(flat)
               for f in ("contrib", "result")
               if any(a is c for c in getattr(st, f))}
    assert set(prog.program.carry) == carried
    tabs = path.render_tables(scene, settings)
    make = path.technique_fns(settings)[1]
    bounce = make(scene, settings, tabs, (prog.program.x, prog.program.y,
                                          0, 0))
    # nothing requires grad in these tables: no leaf carries a gradient
    assert not any(grad_carriers(bounce, st))


def test_reuse_rule(on_program):
    """A chained second step reuses the program (its loss bit-equal to the
    eager step's at the same albedo); an in-place edit of tris.v0 (a
    _version bump), other settings and a new scene each build a new
    one."""
    scene, settings, target = _load("small_k2")
    cpu = torch.device("cpu")
    _, scene1 = train_step(scene, settings, target, 0, 0, LR)
    first = mesh._PROGRAMS[cpu]
    loss, scene2 = train_step(scene1, settings, target, 1, 0, LR)
    assert mesh._PROGRAMS[cpu] is first
    assert torch.equal(loss, train_step_eager(scene1, settings, target, 1, 0,
                                              LR)[0])
    with torch.no_grad():
        scene2.tris.v0.x.add_(0.0)
    train_step(scene2, settings, target, 2, 0, LR)
    second = mesh._PROGRAMS[cpu]
    assert second is not first and len(mesh._PROGRAMS) == 1
    train_step(scene2, dataclasses.replace(settings, max_depth=2), target,
               2, 0, LR)
    third = mesh._PROGRAMS[cpu]
    assert third is not second
    other, _, _ = _load("small_k2")
    train_step(other, dataclasses.replace(settings, max_depth=2), target, 0,
               0, LR)
    assert mesh._PROGRAMS[cpu] is not third


CARD = torch.device("cuda")
DISPATCH = [  # (device, technique, instances, remat) -> program
    (CARD, "path", None, False, True),
    (CARD, "volpath", None, False, True),
    (CARD, "path", None, True, True),
    (CARD, "path", "instances", False, True),
    (torch.device("cpu"), "path", None, False, False),
    (torch.device("cpu"), "volpath", None, False, False),
    (CARD, "ao", None, False, False),
    (CARD, "lt", None, False, False),
    (CARD, "ppm", None, False, False),
    (CARD, "aept", None, False, False),
]


@pytest.mark.parametrize("device,technique,instances,remat,want", DISPATCH)
def test_dispatch_rule(device, technique, instances, remat, want):
    """train_step replays the graphs for path and volpath on a CUDA device,
    instanced scenes included, whatever settings.remat says (the step
    takes remat anyway); every other case takes the eager step."""
    _, settings, _ = _load("small_k2", spi=1)
    s = dataclasses.replace(settings, technique=technique, remat=remat)
    scene = SimpleNamespace(device=device, instances=instances)
    assert uses_train_graphs(scene, s) is want
    assert mesh.uses_train_graphs is uses_train_graphs


def test_cpu_train_step_is_eager(monkeypatch):
    """On the CPU train_step builds no program: it is train_step_eager."""
    monkeypatch.setattr(mesh, "_PROGRAMS", {})
    scene, settings, target = _load("small_k2", spi=1)
    loss, new = train_step(scene, settings, target, 0, 0, LR)
    want, want_scene = train_step_eager(scene, settings, target, 0, 0, LR)
    assert not mesh._PROGRAMS and torch.equal(loss, want)
    assert all(torch.equal(a, b) for a, b in zip(
        new.materials.base, want_scene.materials.base))
