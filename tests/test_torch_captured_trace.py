"""Runtime.trace(), acquireStats() and aept's learning through their
programs on the CPU, without CUDA graphs (a Runtime told to take the
captured route, as on the card): program.TraceProgram a bucket,
program.LoopProgram over path.stats_fns and over aept.learn_fns. Each
against the eager route on the same arrays bit for bit, and against the
JAX package's trace and acquireStats at the bars of
tests/test_torch_runtime_api.py. The same programs
run as CUDA graphs on the card (chip_smoke.py phase 15,
tests/test_torch_cuda.py)."""
import json

import numpy as np
import pytest
import torch

import ignis_tpu
import ignis_tpu_torch
from ignis_tpu_torch.render.session import aept_guiding, render_iteration
from ignis_tpu_torch.techniques.program import trace_bucket

from __graft_entry__ import _SCENE as GRAFT_SCENE
from test_compaction import SCENE as COMPACTION_SCENE
from test_runtime_api import SCENE as RUNTIME_SCENE
from test_torch_render import _at

torch.set_num_threads(1)

SCENES = {"compaction_k1": COMPACTION_SCENE, "graft_entry_k2": GRAFT_SCENE}
SIZES = (1, 1000, 1025, 5000)
BUCKETS = (1024, 1024, 2048, 8192)


def _load(scene, captured, **over):
    rt = ignis_tpu_torch.loadFromString(json.dumps(_at(scene, 32)),
                                        device="cpu", spi=1, seed=7, **over)
    rt.captured = captured
    return rt


def _rays(n, seed=11):
    """Rays from the scenes' camera position over the floor and the ball,
    with tmax <= 0 (unbounded), short, long and 3e38 values."""
    rng = np.random.default_rng(seed)
    rays = np.zeros((n, 8), np.float32)
    rays[:, 0:3] = [0.0, 0.3, 3.85]
    d = np.stack([rng.uniform(-1.2, 1.2, n), rng.uniform(-1.3, 0.6, n),
                  -np.ones(n)], 1)
    rays[:, 3:6] = d / np.linalg.norm(d, axis=1, keepdims=True)
    rays[:, 7] = 3.0e38
    rays[::5, 7] = 0.0
    rays[1::5, 7] = 2.0
    rays[2::5, 7] = -1.0
    rays[3::5, 6] = 0.5
    return rays


def test_trace_buckets():
    assert [trace_bucket(n) for n in SIZES] == list(BUCKETS)
    assert trace_bucket(1024) == 1024 and trace_bucket(8193) == 16384


@pytest.mark.parametrize("which", sorted(SCENES))
@pytest.mark.parametrize("tech", ["path", "volpath", "ao"])
def test_trace_program_matches_eager_and_jax(tech, which):
    """trace() through the kept TraceProgram of each bucket at n = 1,
    1,000, 1,025 and 5,000 rays and spp 1 and 3 ([n, 8] and [n, 6] rays):
    [n, 3] (no padded lane), bit-equal to the eager trace of the same
    rays and iteration; one program a bucket (1,024, 1,024, 2,048,
    8,192), the first call of a bucket making it and later calls
    reusing it; the iteration counts up once a call. Then 1,025 rays at
    spp 3 against the JAX package's trace at the same iteration: within
    rtol 1e-4 / atol 1e-5 on >= 99% of the rays, the means within 0.5%."""
    scene = SCENES[which]
    eager, rt = _load(scene, False, technique=tech), _load(scene, True,
                                                           technique=tech)
    rays = _rays(max(SIZES))
    made = {}
    calls = 0
    for n, bucket in zip(SIZES, BUCKETS):
        for spp in (1, 3):
            r = rays[:n] if spp == 1 else rays[:n, :6]
            got, want = rt.trace(r, spp=spp), eager.trace(r, spp=spp)
            calls += 1
            assert got.shape == (n, 3) and np.isfinite(got).all()
            assert np.array_equal(got, want), (n, spp)
            prog = rt._trace_programs[bucket]
            assert made.setdefault(bucket, prog) is prog
    assert sorted(rt._trace_programs) == [1024, 2048, 8192]
    assert rt.iteration_count == eager.iteration_count == calls
    assert eager._trace_programs == {}
    assert float(np.abs(want).max()) > 0

    jr = ignis_tpu.loadFromString(json.dumps(_at(scene, 32)), spi=1, seed=7,
                                  technique=tech)
    jr._iteration = rt.iteration_count
    got = rt.trace(rays[:1025], spp=3)
    want = jr.trace(rays[:1025], spp=3)
    close = np.isclose(got, want, rtol=1e-4, atol=1e-5).all(-1).mean()
    assert close >= 0.99, close
    assert abs(got.mean() - want.mean()) <= 0.005 * abs(want.mean()) + 1e-7


def test_trace_program_dropped_by_a_rebuild():
    """A registry parameter keeps the trace programs (and gives the eager
    result of the new value); a rebuild drops them and the stats
    program."""
    from test_torch_captured import RUNTIME_SCENE as PARAM_SCENE
    rays = _rays(300)
    rt = _load(PARAM_SCENE, True)
    eager = _load(PARAM_SCENE, False)
    rt.trace(rays)
    eager.trace(rays)
    prog = rt._trace_programs[1024]
    rt.acquireStats()
    assert rt._stats_program is not None
    for r in (rt, eager):
        r.setParameter("tint", 0.8)
    assert np.array_equal(rt.trace(rays), eager.trace(rays))
    assert rt._trace_programs[1024] is prog and rt.rebuilds == 0
    rt.setParameter("extra", 1.0)
    rt.trace(rays)
    # the rebuild decides the dispatch anew: eager on the CPU
    assert rt.rebuilds == 1 and not rt.captured
    assert rt._trace_programs == {} and rt._stats_program is None


@pytest.mark.parametrize("which", ["runtime_api", "compaction"])
def test_acquire_stats_program_matches_eager_and_jax(which):
    """acquireStats through the kept stats program: the same quantities
    as the eager instrumented iteration and as the JAX package's
    acquireStats, at the first call and at a replay of the same
    program; the film and the iteration count stay."""
    scene = {"runtime_api": RUNTIME_SCENE, "compaction": _at(
        COMPACTION_SCENE, 32)}[which]
    txt = json.dumps(scene)
    eager = ignis_tpu_torch.loadFromString(txt, device="cpu", spi=2)
    rt = ignis_tpu_torch.loadFromString(txt, device="cpu", spi=2)
    rt.captured = True
    jr = ignis_tpu.loadFromString(txt, spi=2)
    q = rt.acquireStats()
    prog = rt._stats_program
    assert prog is not None
    assert q == eager.acquireStats() == jr.acquireStats()
    assert rt.acquireStats() == q and rt._stats_program is prog
    assert q["CameraRay"] >= rt.settings.width * rt.settings.height
    assert rt.iteration_count == 0 and rt.framebuffer().abs().max() == 0


def test_aept_learning_program_matches_eager():
    """aept's guiding from the learning program (program.LoopProgram of
    learn_fns over two learning iterations) equals the eager learning's
    bit for bit on the CPU, where the histograms' scatter adds in one
    order; a Runtime on the captured route keeps that guiding and steps
    the eager film."""
    sc = _at(COMPACTION_SCENE, 32)
    sc["technique"] = {"type": "aept", "max_depth": 8,
                       "learning_iterations": 2}
    txt = json.dumps(sc)
    rt = ignis_tpu_torch.loadFromString(txt, device="cpu", spi=2)
    assert rt.settings.learning_iterations == 2
    want = aept_guiding(rt.scene, rt.settings, 0)
    got = aept_guiding(rt.scene, rt.settings, 0, captured=True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert float(want.count.sum()) > 0
    rt.captured = True
    rt.step()
    assert all(torch.equal(a, b) for a, b in zip(rt._aept_guiding, want))
    assert torch.equal(rt.framebuffer(), render_iteration(
        rt.scene, rt.settings, 0, 0, want))
