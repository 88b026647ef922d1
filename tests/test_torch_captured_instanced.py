"""Instanced scenes in the captured programs, on the CPU without CUDA
graphs: the fixed-capacity instanced trace (ops/instanced.py, a
PairBudget a group: torch.nonzero_static into `cap` slots, the count
folded into a device flag) against the eager `nonzero` trace bit for bit
and against the JAX package's trace; a capacity forced too small, which
sets the overflow flag and, through the Runtime, ends in one recapture
and the eager film; the instanced cascade (techniques/cascade
.CascadeProgram) against eager render_lanes bit for bit over iterations
and frames; and the instanced train step (DiffCascadeProgram through
parallel/mesh.TrainProgram) against the eager step. The same programs
run as CUDA graphs on the card (chip_smoke.py phase 14,
tests/test_torch_cuda.py)."""
import json

import jax
import numpy as np
import pytest
import torch

import ignis_tpu
import ignis_tpu_torch
from ignis_tpu_torch.bridge import from_reference
from ignis_tpu_torch.core.vec import Color
from ignis_tpu_torch.ops import mt_replay
from ignis_tpu_torch.parallel import mesh
from ignis_tpu_torch.parallel.mesh import loss_fn, train_step
from ignis_tpu_torch.render.session import _pixels, render_iteration
from ignis_tpu_torch.techniques import path, program
from ignis_tpu_torch.techniques.cascade import CascadeProgram
from ignis_tpu_torch.techniques.path import (occluded_scene, render_lanes,
                                             render_tables, trace_scene)

from test_instancing import _grid_scene
from test_torch_instancing import _jax_rays, _rays, _split

torch.set_num_threads(1)


def _grid(subdivisions=2, size=64, spi=4):
    """The port's own load of _grid_scene(8) (64 instances) with its
    icosphere at `subdivisions` (2: 320 triangles, the local soup through
    K2's plain version; 4: 5,120, through its own BVH and K1's)."""
    sc = _grid_scene(8)
    sc["shapes"][0]["subdivisions"] = subdivisions
    sc["film"] = {"size": [size, size]}
    return ignis_tpu_torch.loadFromString(json.dumps(sc), device="cpu",
                                          spi=spi, instancing=True)


def _sized(scene, settings, rays):
    """The render's tables with a PairBudget a group, sized by one eager
    closest-hit and any-hit trace of `rays` (the program's sizing run)."""
    tabs = program.with_pair_budgets(render_tables(scene, settings))
    trace_scene(scene, rays, tabs.packed, tabs.inst)
    occluded_scene(scene, rays, tabs.packed, tabs.inst)
    for g in tabs.inst:
        assert g.pairs.largest > 0
        g.pairs.cap = program.pair_capacity(g.pairs.largest)
    return tabs


@pytest.fixture(scope="module")
def grid8():
    """(JAX runtime, bridged port scene and settings) of the 64-instance
    grid at 64x64, spi 4."""
    rt = ignis_tpu.loadFromString(json.dumps(_grid_scene(8)), spi=4,
                                  instancing=True)
    scene, settings = from_reference(rt.scene, rt.settings, "cpu")
    return rt, scene, settings


def test_pair_capacity_rule():
    """The capacity is the largest pair count times HEADROOM, rounded up to
    a multiple of PAIR_ALIGN, never under PAIR_ALIGN."""
    assert program.HEADROOM > 1 and program.PAIR_ALIGN == 1024
    assert program.pair_capacity(0) == 1024
    assert program.pair_capacity(819) == 1024
    assert program.pair_capacity(820) == 2048
    assert program.pair_capacity(100_000) == 125_952
    for n in (1, 5_000, 333_333):
        cap = program.pair_capacity(n)
        assert cap % 1024 == 0 and cap >= n * program.HEADROOM


@pytest.mark.parametrize("kind", ["closest", "any"])
def test_fixed_trace_matches_nonzero_and_jax(grid8, kind):
    """On _grid_scene(8) (8,192 camera and secondary rays), the trace
    compacted into the sized capacity equals the nonzero trace bit for bit
    (t, prim, u, v; any hit), its count lands in `seen` without passing
    the capacity, and it meets the JAX intersect_instanced within
    test_torch_instancing.test_instanced_trace_matches_jax's bars."""
    rt, scene, settings = grid8
    rays = _rays(scene)
    tabs = _sized(scene, settings, rays)
    eager = render_tables(scene, settings)
    pairs = tabs.inst[0].pairs
    pairs.seen.zero_()
    if kind == "any":
        got = occluded_scene(scene, rays, tabs.packed, tabs.inst)
        want = occluded_scene(scene, rays, eager.packed, eager.inst)
        assert torch.equal(got, want) and bool(got.any())
        from ignis_tpu.techniques import path as jpath
        jocc = jax.jit(jpath.occluded_scene)(rt.scene, _jax_rays(rays))
        np.testing.assert_array_equal(got.numpy(), np.asarray(jocc))
    else:
        got = trace_scene(scene, rays, tabs.packed, tabs.inst)
        want = trace_scene(scene, rays, eager.packed, eager.inst)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        from ignis_tpu.techniques import path as jpath
        jhit = jax.jit(jpath.trace_scene)(rt.scene, _jax_rays(rays))
        base = scene.tris.v0.x.shape[0] + scene.spheres.radius.shape[0]
        jf, ji, jl = _split(jhit.prim, base, 512)
        f, i, loc = _split(got.prim.numpy(), base, 320)
        assert f.mean() > 0.2 and (~f).mean() > 0.1
        np.testing.assert_array_equal(f, jf)
        np.testing.assert_array_equal(i[f], ji[f])
        np.testing.assert_array_equal(loc[f], jl[f])
        np.testing.assert_allclose(got.t.numpy()[f], np.asarray(jhit.t)[f],
                                   rtol=1e-5, atol=5e-5)
        for a, b in ((got.u, jhit.u), (got.v, jhit.v)):
            err = np.abs(a.numpy()[f] - np.asarray(b)[f])
            assert (err <= 1e-4).mean() >= 0.995 and err.max() <= 1e-3
    assert 0 < int(pairs.seen) <= pairs.largest <= pairs.cap


def test_fixed_trace_through_local_bvh():
    """The local soup with its own BVH (5,120 triangles, K1's path): the
    fixed-capacity trace equals the nonzero one bit for bit."""
    rt = _grid(subdivisions=4, size=32)
    (geo,) = rt.scene.instances
    assert geo.bvh is not None
    rays = _rays(rt.scene, n_side=32)
    tabs = _sized(rt.scene, rt.settings, rays)
    eager = render_tables(rt.scene, rt.settings)
    got = trace_scene(rt.scene, rays, tabs.packed, tabs.inst)
    want = trace_scene(rt.scene, rays, eager.packed, eager.inst)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert bool((got.prim >= 0).any())


def test_capacity_too_small_sets_the_flag(grid8):
    """A capacity under the pair count: the trace's `seen` passes it (the
    overflow flag), and only the first cap pairs take part."""
    _, scene, settings = grid8
    rays = _rays(scene)
    tabs = _sized(scene, settings, rays)
    pairs = tabs.inst[0].pairs
    largest, pairs.cap = pairs.largest, 64
    pairs.seen.zero_()
    got = trace_scene(scene, rays, tabs.packed, tabs.inst)
    assert int(pairs.seen) > pairs.cap and int(pairs.seen) <= largest
    want = trace_scene(scene, rays)
    assert not torch.equal(got.prim, want.prim)


def test_runtime_overflow_recaptures_once():
    """Through the Runtime (its program path on the CPU, the capture left
    out): a capacity forced under the next step's pair count makes that
    step overflow; its film is thrown away, the capacity is raised to the
    count seen times HEADROOM (one recapture) and the step runs again, so
    the film equals the eager films of iterations 0 and 1 bit for bit;
    the step after it needs none."""
    rt = _grid(size=32)
    rt.captured = True
    rt.step()
    prog = rt.program
    (pairs,) = prog.pairs
    assert prog.recaptures == 0 and pairs.cap >= pairs.largest > 0
    pairs.cap = 64
    rt.step()
    assert prog.recaptures == 1 and rt.program is prog
    assert pairs.cap == program.pair_capacity(int(pairs.seen))
    want = (render_iteration(rt.scene, rt.settings, 0, 0)
            + render_iteration(rt.scene, rt.settings, 1, 0))
    assert torch.equal(rt.framebuffer(), want)
    rt.step()
    assert prog.recaptures == 1 and prog.last.evaluations > 0


@pytest.mark.parametrize("iteration,frame", [(0, 0), (3, 1), (7, 2)])
def test_instanced_cascade_matches_eager(iteration, frame, monkeypatch):
    """The instanced cascade (MIN_BUCKET 256: three stages at 64x64)
    equals render_lanes(compact=True) bit for bit; its first run sized
    the group's capacity and no later trace passed it."""
    monkeypatch.setattr(path, "MIN_BUCKET", 256)
    rt = _grid()
    s = rt.settings
    tabs = render_tables(rt.scene, s)
    x, y = _pixels(s, "cpu")
    prog = CascadeProgram(rt.scene, s, tabs, x, y, compact=True)
    for it, fr in ((iteration, frame), (iteration + 1, frame)):
        want = render_lanes(rt.scene, s, x, y, it, fr, compact=True,
                            tabs=tabs)
        got = prog.run(it, fr)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert len(prog.stages) == 3 and prog.recaptures == 0
    (pairs,) = prog.pairs
    assert 0 < int(pairs.seen) <= pairs.cap
    assert sum(prog.last.bounces) > 3


@pytest.mark.parametrize("subdivisions", [2, 4])
def test_instanced_train_step_matches_eager(subdivisions, monkeypatch):
    """train_step on the instanced grid through the program (on the CPU,
    as on the card): the loss equals the eager step's (loss_fn through
    render_lanes(remat=True) and autograd) bit for bit, the albedo
    gradient within rtol 1e-4 / atol 1e-5 * max|g|, with no MT replay (the
    albedo moves no ray); the local soup through K2 (subdivisions 2) and
    through its own BVH (4)."""
    monkeypatch.setattr(mesh, "uses_train_graphs", lambda *a: True)
    monkeypatch.setattr(mesh, "_PROGRAMS", {})
    monkeypatch.setattr(path, "MIN_BUCKET", 256)
    rt = _grid(subdivisions=subdivisions, size=32 if subdivisions == 4
               else 64)
    scene, s = rt.scene, rt.settings
    target = torch.full((s.height, s.width, 3), 0.05)
    base = Color(*[c.detach().requires_grad_()
                   for c in scene.materials.base])
    want_loss = loss_fn({"base": base}, scene, s, target, 0, 0)
    want_g = torch.stack(torch.autograd.grad(want_loss, list(base)))
    mt_replay.reset_counts()
    loss, _ = train_step(scene, s, target, 0, 0, 1e-2)
    prog = mesh._PROGRAMS[torch.device("cpu")].program
    assert mt_replay.counts["plain_calls"] == 0
    assert torch.equal(loss, want_loss.detach())
    got_g = torch.stack(list(prog.base_grad()))
    assert bool((want_g != 0).any())
    np.testing.assert_allclose(got_g.numpy(), want_g.numpy(), rtol=1e-4,
                               atol=1e-5 * float(want_g.abs().max()))
    (pairs,) = prog.pairs
    assert prog.recaptures == 0 and pairs.cap >= pairs.largest > 0
