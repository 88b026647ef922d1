"""The captured step's stage program on the CPU, without CUDA graphs:
techniques/cascade.CascadeProgram against the eager render_lanes bit for
bit (path and volpath, several iterations and frames, three cascade
stages), each stage's bounce count and budget against eager's, the
iteration and frame as tensors against ints under every pixel sampler,
the gated film against the JAX package's render, the Runtime's table
cache and its invalidation, and the dispatch rule of Runtime.step()
(techniques/program.py's runner, which every captured program shares).
The same programs run as CUDA graphs on the card (chip_smoke.py phase
12, tests/test_torch_cuda.py)."""
import dataclasses
import json
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ignis_tpu
import ignis_tpu_torch
from ignis_tpu.render.session import render_iteration as jax_iteration
from ignis_tpu_torch.bridge import from_reference
from ignis_tpu_torch.render import session
from ignis_tpu_torch.render.session import (_image, _pixels,
                                            render_iteration, uses_graphs)
from ignis_tpu_torch.techniques import cascade, path, program
from ignis_tpu_torch.techniques.cascade import CascadeProgram, leaves
from ignis_tpu_torch.techniques.path import (render_lanes, render_tables,
                                             start_state)

from __graft_entry__ import _SCENE
from test_compaction import SCENE as COMPACTION_SCENE, VOL_SCENE
from test_instancing import _grid_scene
from test_runtime_api import SCENE as RUNTIME_SCENE
from test_torch_render import S4_SCENE, _at, s5_small

torch.set_num_threads(1)

NAMES = ("compaction", "graft_entry", "s4", "s5", "volpath")


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """name -> (scene, settings, tables, x, y) on the CPU at 64x64, spi 4,
    made on first use."""
    made = {}

    def get(name):
        if name not in made:
            sc = {"compaction": lambda: COMPACTION_SCENE,
                  "graft_entry": lambda: _SCENE, "s4": lambda: S4_SCENE,
                  "s5": lambda: s5_small(tmp_path_factory.mktemp("env")),
                  "volpath": lambda: VOL_SCENE}[name]()
            rt = ignis_tpu_torch.loadFromString(json.dumps(_at(sc, 64)),
                                                spi=4, device="cpu")
            x, y = _pixels(rt.settings, "cpu")
            made[name] = (rt.scene, rt.settings,
                          render_tables(rt.scene, rt.settings), x, y)
        return made[name]
    return get


def eager_stages(monkeypatch, scene, settings, x, y, iteration, frame, tabs,
                 compact=True):
    """render_lanes's film and the bounces each of its stages ran."""
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
    monkeypatch.setattr(path, "technique_fns", fns)
    film = render_lanes(scene, settings, x, y, iteration, frame,
                        compact=compact, tabs=tabs)
    monkeypatch.setattr(path, "technique_fns", real)
    return film, stages


@pytest.mark.parametrize("iteration,frame", [(0, 0), (3, 1)])
@pytest.mark.parametrize("name", NAMES)
def test_gated_film_matches_eager(scenes, name, iteration, frame,
                                  monkeypatch):
    """With MIN_BUCKET forced to 256 the 4096-lane film runs three stages
    (as test_cascade_matches_progressive): the gated program's film equals
    render_lanes(compact=True)'s bit for bit, each stage's bounce count and
    the budget after it equal eager's, and the program evaluates one
    bounce a stage more than eager (each stage's gated-off bounce)."""
    scene, settings, tabs, x, y = scenes(name)
    monkeypatch.setattr(path, "MIN_BUCKET", 256)
    assert path.bucket_chain(x.shape[0], path.MIN_BUCKET) == [4096, 1024,
                                                              256]
    want, stages = eager_stages(monkeypatch, scene, settings, x, y,
                                iteration, frame, tabs)
    prog = CascadeProgram(scene, settings, tabs, x, y, compact=True)
    got = prog.run(iteration, frame)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    budget = settings.spi * settings.max_depth - np.cumsum(stages)
    assert prog.stage_it.tolist() == stages
    assert prog.stage_budget.tolist() == budget.tolist()
    assert list(prog.last.bounces) == stages
    assert prog.last.evaluations == sum(stages) + len(stages)
    assert sum(stages) > 8


@pytest.mark.parametrize("kind", ["uniform", "mjitt", "halton"])
def test_tensor_iteration_matches_int(scenes, kind):
    """start_state (the FNV seed, the pixel sampler and the camera) gives
    the same bits for the iteration and frame as 0-d int64 tensors, as a
    CUDA graph reads them, as for Python ints."""
    scene, settings, _, x, y = scenes("graft_entry")
    settings = dataclasses.replace(settings, pixel_sampler=kind)
    for iteration, frame in ((0, 0), (5, 2), (2**31 + 7, 3)):
        a = start_state(scene, settings, x, y, iteration, frame)
        b = start_state(scene, settings, x, y,
                        torch.tensor(iteration, dtype=torch.int64),
                        torch.tensor(frame, dtype=torch.int64))
        assert all(torch.equal(p, q) for p, q in zip(leaves(a), leaves(b)))


@pytest.mark.parametrize("kind", ["mjitt", "halton"])
def test_gated_film_under_samplers(scenes, kind):
    """The one-stage program (a film under the compaction gate) equals
    render_lanes(compact=False) under the other pixel samplers, whose
    regeneration reads the iteration tensor on every bounce."""
    scene, settings, tabs, x, y = scenes("graft_entry")
    settings = dataclasses.replace(settings, pixel_sampler=kind)
    want = render_lanes(scene, settings, x, y, 2, 1, compact=False,
                        tabs=tabs)
    prog = CascadeProgram(scene, settings, tabs, x, y, compact=False)
    got = prog.run(2, 1)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert prog.last.evaluations == prog.last.bounces[0] + 1


def test_gated_film_matches_jax(monkeypatch):
    """The gated program's three-stage film of the compaction scene against
    ignis_tpu's render_iteration on the same arrays, at
    test_slice_matches_jax's bar: >= 99% of pixels within rtol 1e-3 / atol
    1e-4, image means within 0.5%."""
    rt = ignis_tpu.loadFromString(json.dumps(_at(COMPACTION_SCENE, 64)),
                                  spi=4)
    ref = np.asarray(jax_iteration(rt.scene, rt.settings, jnp.uint32(0),
                                   jnp.uint32(0)))
    scene, settings = from_reference(rt.scene, rt.settings, "cpu")
    monkeypatch.setattr(path, "MIN_BUCKET", 256)
    x, y = _pixels(settings, "cpu")
    prog = CascadeProgram(scene, settings, render_tables(scene, settings),
                          x, y, compact=True)
    got = _image(prog.run(0, 0), settings).numpy()
    assert len(prog.stages) == 3
    assert got.shape == ref.shape and np.isfinite(got).all()
    close = np.isclose(got, ref, rtol=1e-3, atol=1e-4).all(-1).mean()
    assert close >= 0.99
    assert abs(got.mean() - ref.mean()) <= 0.005 * ref.mean()


def _counting_scene_info(monkeypatch):
    calls = [0]
    real = path.scene_info

    def counted(*a, **kw):
        calls[0] += 1
        return real(*a, **kw)
    monkeypatch.setattr(path, "scene_info", counted)
    return calls


def test_runtime_keeps_tables(monkeypatch):
    """A CPU Runtime keeps its tables and captures nothing: two steps make
    scene_info once; a registry setParameter gives the eager film of the
    new value with no rebuild; a camera change takes effect on the next
    step; a rebuild parameter drops the tables."""
    calls = _counting_scene_info(monkeypatch)
    rt = ignis_tpu_torch.loadFromString(json.dumps(RUNTIME_SCENE), spi=4,
                                        device="cpu")
    assert not rt.captured
    rt.step()
    rt.step()
    assert calls[0] == 1 and rt.program is None
    rt.setParameter("tint", 0.8)
    rt.reset()
    rt.step()
    assert calls[0] == 1 and rt.rebuilds == 0
    assert torch.equal(rt.framebuffer(),
                       render_iteration(rt.scene, rt.settings, 0, 0))
    before = rt.framebuffer()
    rt.setCameraOrientation([0.3, 0.1, -2.5], [-0.1, 0.0, 1.0], [0, 1, 0])
    rt.reset()
    rt.step()
    assert calls[0] == 2
    assert torch.equal(rt.framebuffer(),
                       render_iteration(rt.scene, rt.settings, 0, 0))
    assert not torch.equal(rt.framebuffer(), before)
    rt.setParameter("extra", 1.0)
    rt.step()
    assert rt.rebuilds == 1 and calls[0] == 4


def test_runtime_program_path_on_cpu(monkeypatch):
    """The Runtime's captured path with the capture left out (a CPU Runtime
    told to take it): each step runs the kept program, bit-equal to the
    eager film of that iteration, also after a registry setParameter and a
    camera move, which need no new program; a rebuild drops the program
    and the tables and decides the dispatch anew (eager on the CPU)."""
    monkeypatch.setattr(cascade.CascadeProgram, "capture",
                        lambda self: None)
    calls = _counting_scene_info(monkeypatch)
    rt = ignis_tpu_torch.loadFromString(json.dumps(RUNTIME_SCENE), spi=4,
                                        device="cpu")
    rt.captured = True
    rt.step()
    prog = rt.program
    assert prog is not None and calls[0] == 1
    want0 = render_iteration(rt.scene, rt.settings, 0, 0)
    assert torch.equal(rt.framebuffer(), want0)
    rt.step()
    want1 = render_iteration(rt.scene, rt.settings, 1, 0)
    assert torch.equal(rt.framebuffer(), want0 + want1)
    assert rt.program is prog and calls[0] == 3
    rt.setParameter("tint", 0.8)
    rt.setCameraOrientation([0.3, 0.1, -2.5], [-0.1, 0.0, 1.0], [0, 1, 0])
    rt.reset()
    rt.step()
    assert rt.program is prog and rt.rebuilds == 0
    assert torch.equal(rt.framebuffer(),
                       render_iteration(rt.scene, rt.settings, 0, 0))
    rt.setParameter("extra", 1.0)
    rt.step()
    assert rt.rebuilds == 1 and rt.program is None and not rt.captured
    assert rt._tables is not None and rt._tables is not prog.tabs


def test_dispatch_rule():
    """Runtime.step() takes the graphs on a CUDA device for every
    technique, instanced scenes included, and the eager render under
    remat and on the CPU; the Runtime says which."""
    rt = ignis_tpu_torch.loadFromString(json.dumps(_at(_SCENE, 32)),
                                        device="cpu")
    assert not rt.captured
    card = SimpleNamespace(device=torch.device("cuda"), instances=None)
    s = rt.settings
    assert uses_graphs(card, s)
    assert uses_graphs(card, dataclasses.replace(s, technique="volpath"))
    assert not uses_graphs(card, dataclasses.replace(s, remat=True))
    for tech in ("ao", "lt", "ppm", "aept"):
        assert uses_graphs(card, dataclasses.replace(s, technique=tech))
    inst = ignis_tpu_torch.loadFromString(json.dumps(_grid_scene(2)),
                                          device="cpu", instancing=True)
    assert inst.scene.instances is not None and not inst.captured
    assert uses_graphs(SimpleNamespace(device=torch.device("cuda"),
                                       instances=inst.scene.instances),
                       inst.settings)
    assert session.uses_graphs is uses_graphs


def test_flags_ring_reads_behind():
    """The runner's flag ring on the CPU: each push copies the flag at
    that moment, and reads return them in order."""
    flags = program._Flags(4, torch.device("cpu"))
    go = torch.tensor(True)
    a = flags.push(go)
    go.fill_(False)
    b = flags.push(go)
    assert (a, b) == (0, 1) and flags.read(a) and not flags.read(b)
