"""The other techniques as captured programs, on the CPU without CUDA
graphs (render/session.make_program: simple.SimpleProgram,
program.LoopProgram for lt and aept's guided pass, ppm.PPMProgram):
each program's film against the eager render_iteration of the same
iteration and frame bit for bit (lt too: the CPU's index_add adds in
order), and against the JAX package's render at the bars that
tests/test_torch_techniques.py uses; ppm's radius from the device
iteration against the int's; and, through a CPU Runtime told to take
the program path, aept's guiding learnt once and a reset dropping the
program. The same programs run as CUDA graphs on the card (chip_smoke.py
phase 14, tests/test_torch_cuda.py)."""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ignis_tpu
from ignis_tpu.render.session import render_iteration as jax_iteration
from ignis_tpu_torch.bridge import from_reference
from ignis_tpu_torch.render.session import (Runtime, _image, _pixels,
                                            aept_guiding, make_program,
                                            render_iteration)
from ignis_tpu_torch.techniques import SIMPLE, ppm
from ignis_tpu_torch.techniques.path import render_tables

from test_compaction import SCENE as COMPACTION_SCENE
from test_components import BASE as COMPONENTS_BASE
from test_lighttracer import SCENE as LT_SCENE
from test_torch_techniques import _assert_colors, _checker_floor, _image_env

torch.set_num_threads(1)

SIZE = 32


@pytest.fixture(scope="module")
def simple_case():
    """(port scene, settings, the JAX iteration 0 of every simple technique
    in one jitted program) on tests/test_compaction.py's scene with a
    textured floor at 32x32, spi 2."""
    rt = ignis_tpu.loadFromString(json.dumps(
        _checker_floor(COMPACTION_SCENE)), spi=2)
    scene, settings = from_reference(rt.scene, rt.settings, "cpu")
    js = rt.settings
    ref = jax.jit(lambda sc: {
        t: jax_iteration(sc, dataclasses.replace(js, technique=t),
                         jnp.uint32(0), jnp.uint32(0)) for t in SIMPLE})(
        rt.scene)
    return scene, settings, ref


@pytest.fixture(scope="module")
def box():
    """(JAX runtime, port scene and settings) of tests/test_lighttracer.py's
    box at 32x32, spi 4, 4,000 photons."""
    sc = json.loads(json.dumps(LT_SCENE))
    sc["film"] = {"size": [SIZE, SIZE]}
    rt = ignis_tpu.loadFromString(json.dumps(sc), spi=4, photons=4000)
    scene, settings = from_reference(rt.scene, rt.settings, "cpu")
    return rt, scene, settings


def _program_films(scene, settings, guiding=None, steps=((0, 0), (1, 1))):
    """The program's images and eager render_iteration's at each
    (iteration, frame) of `steps`, one program for all."""
    tabs = render_tables(scene, settings)
    x, y = _pixels(settings, "cpu")
    prog = make_program(scene, settings, tabs, x, y, guiding)
    out = []
    for it, fr in steps:
        got = _image(prog.run(it, fr), settings)
        want = render_iteration(scene, settings, it, fr, guiding, tabs)
        out.append((got, want))
    return prog, out


def _close_share(got, ref, rtol, atol, share, mean_rel):
    ref = np.asarray(ref)
    close = np.isclose(got, ref, rtol=rtol, atol=atol).all(-1).mean()
    assert close >= share
    assert abs(got.mean() - ref.mean()) <= mean_rel * ref.mean()


@pytest.mark.parametrize("tech", SIMPLE)
def test_simple_program_matches_eager_and_jax(simple_case, tech):
    """The simple technique's one program (settings.spi camera samples)
    equals the eager iteration bit for bit at iterations 0 and 1 (frames
    0 and 1), reads no flag, and meets the JAX iteration within
    test_simple_technique_matches_jax's 1e-5 on every pixel (the debug
    view at test_debug_mode_matches_jax's 1e-4, 1e-5 on 99.9%)."""
    scene, settings, ref = simple_case
    s = dataclasses.replace(settings, technique=tech)
    prog, films = _program_films(scene, s)
    for got, want in films:
        assert torch.equal(got, want)
    assert prog.last.evaluations == 0 and prog.last.bounces == ()
    got = films[0][0]
    chans = [got[..., c].reshape(-1) for c in range(3)]
    refs = [np.asarray(ref[tech])[..., c].reshape(-1) for c in range(3)]
    if tech == "debug":
        _assert_colors(chans, refs, tol=1e-4)
        _assert_colors(chans, refs, share=0.999)
    else:
        _assert_colors(chans, refs)
    assert float(got.sum()) > 0


def test_lt_program_matches_eager_and_jax(box):
    """lt's gated loop (the film in its state, K3's splat inside) equals
    the eager film bit for bit at iterations 0 and 1, and the JAX
    iteration within test_lt_film_matches_jax's rtol 1e-4 / atol 1e-6;
    it ran more than one bounce and one gated-off evaluation."""
    rt, scene, settings = box
    s = dataclasses.replace(settings, technique="lt")
    prog, films = _program_films(scene, s)
    for got, want in films:
        assert torch.equal(got, want)
    (k,) = prog.last.bounces
    assert 1 < k <= s.spi * s.max_depth and prog.last.evaluations == k + 1
    ref = np.asarray(jax_iteration(rt.scene, dataclasses.replace(
        rt.settings, technique="lt"), jnp.uint32(0), jnp.uint32(0)))
    np.testing.assert_allclose(films[0][0].numpy(), ref, rtol=1e-4,
                               atol=1e-6)
    assert float(films[0][0].sum()) > 0


def test_ppm_program_matches_eager_and_jax(box):
    """ppm's programs (gated photon loop, grid and radius, gated camera
    loop) equal the eager iteration bit for bit at iterations 0 and 1,
    and the JAX iteration within test_ppm_render_matches_jax's bars (99%
    of pixels within rtol 1e-4 / atol 1e-5, means within 1e-4)."""
    rt, scene, settings = box
    s = dataclasses.replace(settings, technique="ppm")
    prog, films = _program_films(scene, s)
    for got, want in films:
        assert torch.equal(got, want)
    photon, camera = prog.last.bounces
    assert 0 < photon <= s.max_light_depth and camera > 1
    ref = jax_iteration(rt.scene, dataclasses.replace(rt.settings,
                                                      technique="ppm"),
                        jnp.uint32(0), jnp.uint32(0))
    assert float(np.asarray(ref).mean()) > 0.01
    _close_share(films[0][0].numpy(), ref, 1e-4, 1e-5, 0.99, 1e-4)


def test_ppm_radius_from_device_iteration(box):
    """compute_radius of a 0-d int64 iteration tensor (the program's) gives
    the int's bits."""
    _, scene, settings = box
    for it in (0, 1, 7, 100, 12345):
        assert torch.equal(
            ppm.compute_radius(settings, scene, it),
            ppm.compute_radius(settings, scene,
                               torch.tensor(it, dtype=torch.int64)))


@pytest.fixture(scope="module")
def aept_case(tmp_path_factory):
    """(JAX runtime, port scene and settings) of tests/test_components.py's
    plane under a numpy image env at 32x32, spi 4, aept."""
    env = _image_env(tmp_path_factory.mktemp("env"))
    sc = json.loads(json.dumps(COMPONENTS_BASE))
    sc["textures"] = [{"type": "image", "name": "sky",
                       "filename": str(env)}]
    sc["lights"] = [{"type": "env", "name": "E", "radiance": "sky"}]
    sc["technique"]["type"] = "aept"
    rt = ignis_tpu.loadFromString(json.dumps(sc), spi=4)
    scene, settings = from_reference(rt.scene, rt.settings, "cpu")
    return rt, scene, settings


def test_aept_program_matches_eager_and_jax(aept_case):
    """aept's guided pass as a gated loop under the guiding learnt once:
    bit-equal to the eager iteration at iterations 0 and 1, and the JAX
    Runtime's first step (learning, then iteration 0) within
    test_aept_render_matches_jax's bars."""
    rt, scene, settings = aept_case
    guiding = aept_guiding(scene, settings, 0)
    prog, films = _program_films(scene, settings, guiding)
    for got, want in films:
        assert torch.equal(got, want)
    rt.step()
    ref = np.asarray(rt.framebuffer(normalized=True))
    assert ref.mean() > 0.01
    _close_share(films[0][0].numpy(), ref, 1e-4, 1e-5, 0.99, 1e-4)


def test_runtime_aept_program_keeps_guiding_until_reset(aept_case,
                                                        monkeypatch):
    """A CPU Runtime told to take the program path (the capture left out)
    learns aept's guiding once, before its program, and replays it: two
    steps equal the eager films of iterations 0 and 1 under that guiding;
    reset() drops the guiding and the program, and the next step learns
    anew and makes a new program."""
    _, scene, settings = aept_case
    learnt = []
    from ignis_tpu_torch.render import session
    real = session.aept_guiding

    def counted(*a, **kw):
        learnt.append(1)
        return real(*a, **kw)
    monkeypatch.setattr(session, "aept_guiding", counted)
    rt = Runtime(scene, settings)
    rt.captured = True
    rt.step()
    rt.step()
    prog, guiding = rt.program, rt._aept_guiding
    assert len(learnt) == 1 and prog is not None
    want = (render_iteration(scene, settings, 0, 0, guiding)
            + render_iteration(scene, settings, 1, 0, guiding))
    assert torch.equal(rt.framebuffer(), want)
    rt.reset()
    assert rt.program is None and rt._aept_guiding is None
    rt.step()
    assert len(learnt) == 2 and rt.program is not prog
    assert torch.equal(rt.framebuffer(), render_iteration(
        scene, settings, 0, 0, rt._aept_guiding))
