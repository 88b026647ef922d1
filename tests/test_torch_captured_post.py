"""The post-processing programs (ignis_tpu_torch/render/post_program.py)
on the CPU, without CUDA graphs: dispatch told to take the program route
(`post_program.uses_program`), as on the card. tonemap (every method,
both gammas), image_info, both denoisers (with and without their guides)
and the glare reductions through their programs are bit-equal to the
plain functions on the same inputs, and within tests/test_torch_post.py's
bars of the JAX package's jitted functions; a second set of traced
arguments replays with the new values; the keeper runs a key's first
call plain, builds the program at the second, keys on the static
arguments and holds at most MAX_PROGRAMS keys. The same programs run as
CUDA graphs on the card (chip_smoke.py phase 10, tests/test_torch_cuda.py).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ignis_tpu.render import denoise as jdenoise
from ignis_tpu.render import glare as jglare
from ignis_tpu.render import tonemap as jtonemap
from ignis_tpu_torch.render import denoise, glare, post_program, tonemap

from test_torch_post import GLARE_CASES, hdr_image

torch.set_num_threads(1)

SIZES = [(64, 64), (37, 53)]


@pytest.fixture
def programs(monkeypatch):
    """The program route on the CPU, with an empty keeper before and
    after."""
    post_program.release_programs()
    monkeypatch.setattr(post_program, "uses_program", lambda *a: True)
    yield post_program.kept(torch.device("cpu"))
    post_program.release_programs()


def _twice(fn, *args, **kw):
    """fn's first call (plain) and second (the program's), checked to
    have taken those routes."""
    first = fn(*args, **kw)
    n = len(post_program.kept(torch.device("cpu")))
    second = fn(*args, **kw)
    assert len(post_program.kept(torch.device("cpu"))) == n
    return first, second


def _equal(a, b):
    if isinstance(a, tuple):
        return all(_equal(x, y) for x, y in zip(a, b))
    return torch.equal(a, b)


def noisy(h, w, seed=3):
    """A noisy colour image with piecewise guides: normals, albedo,
    depth."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([0.5 + 0.4 * np.sin(xx / 5.0 + c) for c in range(3)], -1)
    color = (base + rng.normal(0, 0.15, (h, w, 3))).astype(np.float32)
    half = (xx > w // 2)[..., None]
    normals = np.where(half, [0.0, 0.0, 1.0], [0.0, 1.0, 0.0]).astype(
        np.float32)
    albedo = np.where(half, [0.8, 0.2, 0.2], [0.3, 0.3, 0.9]).astype(
        np.float32)
    depth = (2.0 + yy / h + 3.0 * (xx > w // 3)).astype(np.float32)
    return color, normals, albedo, depth


@pytest.mark.parametrize("use_gamma", [True, False])
@pytest.mark.parametrize("method", range(7))
def test_tonemap_program_equals_plain_and_jax(programs, method, use_gamma):
    """Every method, the gamma on and off, at 64x64 and 37x53: the
    program's result torch.equal to tonemap_plain's (at scale 1 and 1.3),
    and within test_torch_post.py's tonemap bar of the JAX jitted tonemap
    at that test's arguments (rtol 1e-5 on >= 97% of the values, rtol
    1e-5 + atol 3e-4 on all; NaN, inf and negative pixels exactly)."""
    for h, w in SIZES:
        img = torch.from_numpy(hdr_image(h, w, seed=h))
        kw = dict(exposure_factor=1.7, exposure_offset=0.01, method=method,
                  use_gamma=use_gamma)
        first, got = _twice(tonemap.tonemap, img, **kw)
        want = tonemap.tonemap_plain(img, **kw)
        assert torch.equal(first, want) and torch.equal(got, want)
        scaled = tonemap.tonemap(img, scale=1.3, **kw)
        assert torch.equal(scaled, tonemap.tonemap_plain(img, scale=1.3,
                                                         **kw))
        j = np.asarray(jtonemap.tonemap(jnp.asarray(img.numpy()), **kw))
        g = got.numpy()
        assert np.isclose(g, j, rtol=1e-5, atol=0.0).mean() >= 0.97
        np.testing.assert_allclose(g, j, rtol=1e-5, atol=3e-4)
        for y, x in ((0, 0), (1, 1), (2, 2), (3, 3)):
            np.testing.assert_array_equal(g[y, x], j[y, x])


@pytest.mark.parametrize("bins", [64, 16])
def test_image_info_program_equals_plain_and_jax(programs, bins):
    """image_info through its program equal to image_info_plain in every
    field; counts and histograms equal to JAX's, the float statistics
    within rtol 1e-6 (test_torch_post.py's bar)."""
    for h, w in SIZES:
        img = torch.from_numpy(hdr_image(h, w, seed=w))
        first, got = _twice(tonemap.image_info, img, scale=1.3, bins=bins)
        want = tonemap.image_info_plain(img, scale=1.3, bins=bins)
        assert _equal(tuple(first), tuple(want))
        assert _equal(tuple(got), tuple(want))
        assert got.histogram.shape == (4, bins)
        j = jtonemap.image_info(jnp.asarray(img.numpy()), scale=1.3,
                                bins=bins)
        for f in ("inf_count", "nan_count", "neg_count", "histogram"):
            np.testing.assert_array_equal(getattr(got, f).numpy(),
                                          np.asarray(getattr(j, f)))
        for f in ("min", "max", "average", "soft_min", "soft_max",
                  "median"):
            np.testing.assert_allclose(float(getattr(got, f)),
                                       float(getattr(j, f)), rtol=1e-6)


@pytest.mark.parametrize("bins", [1, 16, 64])
def test_histogram_scatter_equals_bincount(bins):
    """The fixed [bins] scatter-add equals torch.bincount(minlength=bins),
    with every bin and with empty bins."""
    rng = np.random.default_rng(bins)
    for n, hi in ((5000, bins), (7, max(bins // 2, 1)), (0, bins)):
        idx = torch.from_numpy(rng.integers(0, hi, n))
        got = tonemap.histogram_counts(idx, bins)
        assert torch.equal(got, torch.bincount(idx, minlength=bins))


DENOISERS = {"atrous": (denoise.denoise_image, denoise.denoise_image_plain,
                        jdenoise.denoise_image),
             "nlm": (denoise.denoise_image_nlm,
                     denoise.denoise_image_nlm_plain,
                     jdenoise.denoise_image_nlm)}


@pytest.mark.parametrize("guides", ["all", "none", "normals_depth"])
@pytest.mark.parametrize("method", sorted(DENOISERS))
def test_denoiser_program_equals_plain_and_jax(programs, method, guides):
    """Both denoisers with all, none and some of their guides (the absent
    ones zeros made when the program is built): the program's result
    torch.equal to the plain function's at 64x64 and 37x53, and within
    rtol 1e-5 (atol 1e-7) of the JAX jitted filter at 37x53
    (test_torch_post.py's bar; XLA compiles the unrolled NLM for about 15
    s a shape)."""
    fn, plain, jfn = DENOISERS[method]
    for h, w in SIZES:
        color, normals, albedo, depth = noisy(h, w)
        given = {"all": (normals, albedo, depth), "none": (None,) * 3,
                 "normals_depth": (normals, None, depth)}[guides]
        args = [torch.from_numpy(color)] + [
            None if g is None else torch.from_numpy(g) for g in given]
        first, got = _twice(fn, *args)
        want = plain(*args)
        assert torch.equal(first, want) and torch.equal(got, want)
        if (h, w) != SIZES[-1]:
            continue
        j = np.asarray(jfn(jnp.asarray(color), *[
            None if g is None else jnp.asarray(g) for g in given]))
        np.testing.assert_allclose(got.numpy(), j, rtol=1e-5, atol=1e-7)


def _glare_equal(a, b):
    assert all(getattr(a, f) == getattr(b, f) for f in a._fields[:-1])
    np.testing.assert_array_equal(a.source_map, b.source_map)


@pytest.mark.parametrize("case", sorted(GLARE_CASES))
def test_glare_program_equals_plain_and_jax(programs, monkeypatch, case):
    """compute_glare through the glare program equal to compute_glare
    through glare_reductions_plain in every metric and the source map,
    and within test_torch_post.py's glare bar of the JAX package (rtol
    1e-3, atol 1e-9; the source map within 1e-6)."""
    kw = dict(GLARE_CASES[case])
    img = torch.from_numpy(kw.pop("img"))
    first, got = _twice(glare.compute_glare, img, **kw)
    monkeypatch.setattr(post_program, "uses_program", lambda *a: False)
    want = glare.compute_glare(img, **kw)
    _glare_equal(first, want)
    _glare_equal(got, want)
    j = jglare.compute_glare(img.numpy(), **kw)
    for f in j._fields[:-1]:
        assert math.isclose(getattr(got, f), getattr(j, f), rel_tol=1e-3,
                            abs_tol=1e-9), f
    np.testing.assert_allclose(got.source_map, j.source_map, atol=1e-6)


def test_changed_traced_arguments_replay_with_new_values(programs):
    """A program called with a second set of traced arguments (a
    sigma, k, the exposure, the scale, the glare multiplier, a tilted
    camera, a fixed E_v) gives the plain result for those arguments, not
    the first set's, and builds no new program."""
    h, w = 37, 53
    color, normals, albedo, depth = [torch.from_numpy(a)
                                     for a in noisy(h, w)]
    guides = (normals, albedo, depth)
    img = torch.from_numpy(hdr_image(h, w))
    glare_img = torch.from_numpy(GLARE_CASES["bright_source"]["img"])
    calls = [
        (denoise.denoise_image, denoise.denoise_image_plain, (color, *guides),
         [{}, {"sigma_color": 0.3}]),
        (denoise.denoise_image_nlm, denoise.denoise_image_nlm_plain,
         (color, *guides), [{}, {"k": 0.6}]),
        (tonemap.tonemap, tonemap.tonemap_plain, (img,),
         [{"method": 3}, {"method": 3, "exposure_factor": 2.0}]),
        (tonemap.image_info, tonemap.image_info_plain, (img,),
         [{}, {"scale": 2.0}]),
    ]
    for fn, plain, args, kws in calls:
        outs = [fn(*args, **kws[0]) for _ in range(2)]
        n = len(programs)
        other = fn(*args, **kws[1])
        assert len(programs) == n
        for got, kw in ((outs[1], kws[0]), (other, kws[1])):
            assert _equal(tuple(got) if isinstance(got, tuple) else got,
                          tuple(plain(*args, **kw)) if isinstance(
                              got, tuple) else plain(*args, **kw))
        assert not _equal(outs[1], other)
    for kw in ({"mul": 5.0}, {"mul": 3.0, "cam_dir": (0.1, -0.2, 1.0),
                              "vertical_illuminance": 2500.0}):
        got = glare.compute_glare(glare_img, **kw)
        want_s, want_m = glare.glare_reductions_plain(
            glare_img, kw.get("cam_dir", (0, 0, 1)), (0, 1, 0), 60.0,
            kw["mul"], 1.0, kw.get("vertical_illuminance", -1.0))
        np.testing.assert_array_equal(got.source_map, want_m.numpy())
        assert got.vertical_illuminance == float(want_s[3])
        assert got.source_x == float(want_s[8])
    assert post_program.program_of(
        "glare_reductions", (60.0,), [glare_img]) is not None
    assert got.vertical_illuminance == 2500.0


def test_keeper_first_call_plain_then_program(programs, monkeypatch):
    """The first call of a key runs tonemap_plain and keeps no program;
    the second builds one and does not run the plain function; the
    third reuses it."""
    seen = []
    real = tonemap.tonemap_plain

    def counting(*a, **kw):
        seen.append(1)
        return real(*a, **kw)
    monkeypatch.setattr(tonemap, "tonemap_plain", counting)
    img = torch.from_numpy(hdr_image(16, 16))
    tonemap.tonemap(img, method=1)
    assert len(seen) == 1
    assert post_program.program_of("tonemap", (1, True), [img]) is None
    assert len(programs) == 1
    tonemap.tonemap(img, method=1)
    prog = post_program.program_of("tonemap", (1, True), [img])
    assert isinstance(prog, post_program.PostProgram) and len(seen) == 1
    tonemap.tonemap(img, method=1)
    assert post_program.program_of("tonemap", (1, True), [img]) is prog
    assert len(seen) == 1 and prog.graph is None


def test_keeper_keys_on_statics_shapes_and_guides(programs):
    """A new static argument, a new image size or another set of guides
    is a new key; the same call again is not."""
    img = torch.from_numpy(hdr_image(16, 16))
    for bins in (64, 64, 16):
        tonemap.image_info(img, bins=bins)
    assert len(programs) == 2
    tonemap.image_info(torch.from_numpy(hdr_image(16, 20)), bins=16)
    assert len(programs) == 3
    color, normals, albedo, depth = [torch.from_numpy(a)
                                     for a in noisy(16, 16)]
    denoise.denoise_image(color, normals, albedo, depth, iterations=2)
    denoise.denoise_image(color, normals, None, depth, iterations=2)
    denoise.denoise_image(color, normals, albedo, depth, iterations=3)
    assert len(programs) == 6
    keys = [k for k in programs if k[0] == "denoise_image"]
    assert {k[1] for k in keys} == {(2,), (3,)}


def test_keeper_least_recently_used_bound(programs):
    """At most MAX_PROGRAMS keys a device: the least recently used goes
    first, and a key used again stays."""
    img = torch.from_numpy(hdr_image(8, 8))
    n = post_program.MAX_PROGRAMS
    for bins in range(1, n + 1):
        tonemap.image_info(img, bins=bins)
        tonemap.image_info(img, bins=bins)
    assert len(programs) == n
    tonemap.image_info(img, bins=1)            # bins 1 is now the newest
    tonemap.image_info(img, bins=n + 1)
    assert len(programs) == n
    bins_kept = sorted(k[1][0] for k in programs)
    assert bins_kept == [1] + list(range(3, n + 2))
    assert isinstance(post_program.program_of("image_info", (1,), [img]),
                      post_program.PostProgram)
    post_program.release_programs()
    assert not post_program.kept(torch.device("cpu"))


def test_dispatch_rule():
    """The program route only for CUDA tensors that need no gradient:
    CPU tensors and tensors requiring grad take the plain function,
    whose gradient flows."""
    x = torch.ones(4, 4, 3)
    assert not post_program.uses_program(x, 1.0)
    img = torch.from_numpy(hdr_image(8, 8)).abs().nan_to_num(0.0, 1.0, 0.0)
    img.requires_grad_(True)
    assert not post_program.uses_program(img)
    tonemap.tonemap(img, method=1).sum().backward()
    assert img.grad is not None and torch.isfinite(img.grad).all()
    assert not post_program.kept(torch.device("cpu"))


def test_program_without_graph_refuses_capture():
    """A program on the CPU runs its body on its buffers; capture() needs
    a CUDA device and raises elsewhere."""
    img = torch.from_numpy(hdr_image(8, 8))
    body = tonemap._tonemap_body(img, 0, True)
    prog = post_program.PostProgram(body, [img], (1.0, 1.0, 0.0))
    got = prog([img], (1.0, 1.0, 0.0))[0]
    assert torch.equal(got, tonemap.tonemap_plain(img))
    with pytest.raises(ValueError, match="CUDA"):
        prog.capture()
