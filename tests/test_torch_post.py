"""Post-processing in ignis_tpu_torch against ignis_tpu, on the CPU:
tonemap (every method) and image_info on an HDR image holding NaN, +-inf
and negative pixels, the a-trous and NLM denoisers on a noisy 48x48 render
with its AOVs, the glare metrics, and the PNG, HDR and multilayer-EXR
writers read back by the JAX package's readers (ignis_tpu.utils.exr and
OpenCV) and by the port's own. The same numpy inputs, from a seed, go
through both packages; each test states its tolerance."""
import json
import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ignis_tpu_torch
from ignis_tpu.render import denoise as jdenoise
from ignis_tpu.render import glare as jglare
from ignis_tpu.render import tonemap as jtonemap
from ignis_tpu.utils.exr import read_exr as jax_read_exr
from ignis_tpu_torch.render import denoise, glare, tonemap
from ignis_tpu_torch.utils import image as imagelib
from ignis_tpu_torch.utils.exr import read_exr

from test_glare import _scene_img
from test_runtime_api import SCENE as API_SCENE

os.environ.setdefault("OPENCV_IO_ENABLE_OPENEXR", "1")

torch.set_num_threads(1)


def hdr_image(h=40, w=30, seed=1):
    """Squared normals times 9 (a long tail up to ~75), with a NaN, +inf,
    -inf and a negative pixel."""
    rng = np.random.default_rng(seed)
    img = (rng.standard_normal((h, w, 3)) * 3).astype(np.float32) ** 2
    img[0, 0, 0] = np.nan
    img[1, 1, 1] = np.inf
    img[2, 2, 2] = -np.inf
    img[3, 3] = -0.5
    return img


@pytest.mark.parametrize("method", range(7))
def test_tonemap_matches_jax(method):
    """Each method within rtol 1e-5 on >= 97% of the values, and within
    rtol 1e-5 + atol 3e-4 on all: the reference's XLA einsum rounds its
    XYZ a float32 ulp apart from the port's explicit sums (no summation
    order reproduces it), and the XYZ -> RGB matrix cancels, the gamma and
    AgX's polynomial magnify that on up to ~2% of the 3,600 values (at
    most 2.5e-4 in display space, 0.06 of an 8-bit step). The NaN, inf
    and negative pixels get their colours exactly."""
    img = hdr_image()
    want = np.asarray(jtonemap.tonemap(jnp.asarray(img), exposure_factor=1.7,
                                       exposure_offset=0.01, method=method))
    got = tonemap.tonemap(torch.from_numpy(img), exposure_factor=1.7,
                          exposure_offset=0.01, method=method).numpy()
    assert got.shape == want.shape
    close = np.isclose(got, want, rtol=1e-5, atol=0.0)
    assert close.mean() >= 0.97
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=3e-4)
    for y, x in ((0, 0), (1, 1), (2, 2), (3, 3)):
        np.testing.assert_array_equal(got[y, x], want[y, x])


def test_tonemap_names_match_jax():
    assert tonemap.TONEMAP_METHODS == jtonemap.TONEMAP_METHODS


@pytest.mark.parametrize("seed", [1, 2])
def test_image_info_matches_jax(seed):
    """Counts and the histograms exactly; the float statistics within 1e-6
    relative (the luminance's float32 sum rounds apart by an ulp)."""
    img = hdr_image(seed=seed)
    want = jtonemap.image_info(jnp.asarray(img), scale=1.3)
    got = tonemap.image_info(torch.from_numpy(img), scale=1.3)
    for f in ("inf_count", "nan_count", "neg_count", "histogram"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)
    for f in ("min", "max", "average", "soft_min", "soft_max", "median"):
        np.testing.assert_allclose(float(getattr(got, f)),
                                   float(getattr(want, f)), rtol=1e-6,
                                   err_msg=f)


def noisy_render():
    """tests/test_runtime_api.py:92's denoiser scene at 48x48, spi 1 (an
    area light, so NEE is stochastic), rendered by the port, with its
    Normals, Albedo and Depth AOVs, as numpy."""
    scene = json.loads(json.dumps(API_SCENE))
    scene["film"]["size"] = [48, 48]
    scene["bsdfs"].append({"type": "diffuse", "name": "black",
                           "reflectance": [0, 0, 0]})
    scene["shapes"].append({"type": "rectangle", "name": "L",
                            "width": 0.5, "height": 0.5})
    scene["entities"].append({"name": "L", "shape": "L", "bsdf": "black",
                              "transform": [{"translate": [1.5, 0, -1.0]}]})
    scene["lights"] = [{"type": "area", "name": "L", "entity": "L",
                        "radiance": [10, 10, 10]}]
    rt = ignis_tpu_torch.loadFromString(json.dumps(scene), device="cpu",
                                        spi=1)
    rt.step()
    aovs = rt.render_aovs()
    return (rt.framebuffer(normalized=True).numpy(),
            *[aovs[k].numpy() for k in ("Normals", "Albedo", "Depth")])


@pytest.mark.parametrize("method", ["atrous", "nlm"])
def test_denoiser_matches_jax(method):
    """Both filters on the same noisy render and AOVs within rtol 1e-5
    (atol 1e-7 for values near 0): same loop order of the accumulations,
    float32 throughout."""
    color, normals, albedo, depth = noisy_render()
    assert color.std() > 0
    jfn = {"atrous": jdenoise.denoise_image,
           "nlm": jdenoise.denoise_image_nlm}[method]
    fn = {"atrous": denoise.denoise_image,
          "nlm": denoise.denoise_image_nlm}[method]
    want = np.asarray(jfn(*[jnp.asarray(a) for a in
                            (color, normals, albedo, depth)]))
    got = fn(*[torch.from_numpy(a) for a in
               (color, normals, albedo, depth)]).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    assert denoise.has_denoiser()


GLARE_CASES = {
    "bright_source": dict(img=_scene_img(bg=0.3, src=3000.0)),
    "uniform": dict(img=_scene_img(bg=1.0)),
    "insufficient_light": dict(img=_scene_img(bg=1e-4)),
    "off_axis_wide": dict(img=_scene_img(h=96, w=128, bg=0.5, src=800.0,
                                         src_px=(90, 20), r=6),
                          cam_dir=(0.1, 0.0, 1.0), fov_deg=70.0),
    "fixed_ev": dict(img=_scene_img(bg=0.3, src=500.0, src_px=(10, 50)),
                     vertical_illuminance=2500.0, mul=3.0, scale=2.0),
}


@pytest.mark.parametrize("case", sorted(GLARE_CASES))
def test_glare_metrics_match_jax(case):
    """Every metric, E_v and the source's omega, luminance and centroid
    within rtol 1e-3 (atol 1e-9 for the zeros); the source map within
    1e-6."""
    kw = dict(GLARE_CASES[case])
    img = kw.pop("img")
    want = jglare.compute_glare(img, **kw)
    got = glare.compute_glare(torch.from_numpy(img), **kw)
    for f in want._fields[:-1]:
        assert math.isclose(getattr(got, f), getattr(want, f), rel_tol=1e-3,
                            abs_tol=1e-9), (f, getattr(got, f),
                                            getattr(want, f))
    np.testing.assert_allclose(got.source_map, want.source_map, atol=1e-6)


def omega_f64(h, w, cam_dir=(0.0, 0.0, 1.0), cam_up=(0.0, 1.0, 0.0),
              fov_deg=60.0):
    """Per-pixel solid angles and |cos| to the view axis, in float64: an
    independent numpy evaluation of glare.art's spherical excess."""
    def unit(v):
        return v / np.linalg.norm(v, axis=-1, keepdims=True)
    d = unit(np.asarray(cam_dir, np.float64))
    r = unit(np.cross(d, np.asarray(cam_up, np.float64)))
    u = np.cross(r, d)
    t = math.tan(math.radians(fov_deg) / 2)
    ys, xs = np.mgrid[0:h + 1, 0:w + 1].astype(np.float64)
    c = unit(d + ((2 * xs / w - 1) * t)[..., None] * r
             + ((1 - 2 * ys / h) * t * h / w)[..., None] * u)
    r1, r2, r3, r4 = c[:-1, :-1], c[1:, :-1], c[1:, 1:], c[:-1, 1:]
    n = [unit(np.cross(a, b - a)) for a, b in
         ((r1, r2), (r2, r3), (r3, r4), (r4, r1))]
    omega = sum(math.pi - np.arccos(np.clip((a * b).sum(-1), -1, 1))
                for a, b in zip(n, n[1:] + n[:1])) - 2 * math.pi
    return omega, np.abs((unit(r1 + r2 + r3 + r4) * d).sum(-1))


def f64_ev_and_source_omega(img):
    omega, cos = omega_f64(*img.shape[:2])
    lum = 179.0 * (0.2126 * img[..., 0] + 0.7152 * img[..., 1]
                   + 0.0722 * img[..., 2]).astype(np.float64)
    src = lum > 5.0 * (lum * omega).sum() / omega.sum()
    return (lum * omega * cos).sum(), omega[src].sum()


@pytest.mark.parametrize("size", [64, 512])
def test_glare_float32_solid_angle_against_float64(size):
    """E_v and the source's omega of both packages against a float64
    evaluation. At 64x64 both are within 1e-3 of it. At 512x512 a pixel's
    omega is four float32 arccos values minus 2*pi, and the cancellation
    leaves each pixel on the last ulp of acos: both packages' E_v and
    source omega then miss the float64 values by several percent, each in
    its own way (the reference precision fault of ROADMAP queue 3; the
    port keeps the reference's float32 formula). Held: within 10% of
    float64, and the fault shows (a spread above 1e-3)."""
    img = _scene_img(h=size, w=size, bg=0.3, src=3000.0,
                     src_px=(size * 0.6, size * 0.4), r=size // 25)
    ev64, so64 = f64_ev_and_source_omega(img)
    spread = []
    for r in (jglare.compute_glare(img),
              glare.compute_glare(torch.from_numpy(img))):
        for got, ref in ((r.vertical_illuminance, ev64),
                         (r.source_omega, so64)):
            spread.append(abs(got / ref - 1.0))
    if size == 64:
        assert max(spread) < 1e-3, spread
    else:
        assert 1e-3 < max(spread) < 0.1, spread


def test_glare_from_runtime_matches_compute_glare():
    rt = ignis_tpu_torch.loadFromString(json.dumps(API_SCENE), device="cpu",
                                        spi=4)
    rt.step()
    got = glare.glare_from_runtime(rt)
    want = glare.compute_glare(rt.framebuffer(normalized=True),
                               (0.0, 0.0, 1.0), (0.0, 1.0, 0.0), 60.0)
    assert got[:-1] == want[:-1]


def _ldr_image(seed=3, h=21, w=34):
    rng = np.random.default_rng(seed)
    img = rng.random((h, w, 3)).astype(np.float32) * 1.2
    img[0, 0] = [-0.5, 2.0, 0.0]
    return img


def test_png_writer_read_back_by_opencv_and_the_port(tmp_path):
    """8-bit sRGB with +0.5 rounding: the same bytes as the JAX writer's
    (OpenCV's) once decoded, by OpenCV and by the port's reader."""
    import cv2
    from ignis_tpu.utils.image import save_image as jax_save
    img = _ldr_image()
    imagelib.save_image(tmp_path / "p.png", img)
    jax_save(str(tmp_path / "j.png"), img)
    ours = cv2.imread(str(tmp_path / "p.png"))[..., ::-1]
    theirs = cv2.imread(str(tmp_path / "j.png"))[..., ::-1]
    np.testing.assert_array_equal(ours, theirs)
    np.testing.assert_allclose(imagelib.read_png(tmp_path / "p.png"),
                               ours / 255.0, rtol=0, atol=1e-7)
    assert imagelib.encode_png(ours).startswith(b"\x89PNG")


def test_hdr_writer_and_reader_against_opencv(tmp_path):
    """RGBE: OpenCV reads the port's flat file as the port does, the port
    reads OpenCV's run-length-encoded file as OpenCV does, and both
    writers round the same (but for a negative component, which the port
    clamps to 0 and OpenCV wraps); within 2^-7 of the max component."""
    import cv2
    from ignis_tpu.utils.image import save_image as jax_save
    rng = np.random.default_rng(0)
    img = (rng.random((37, 53, 3)) ** 4 * 50).astype(np.float32)
    img[0, 0] = 0.0
    imagelib.save_image(tmp_path / "p.hdr", img)
    jax_save(str(tmp_path / "j.hdr"), img)
    raw = (tmp_path / "j.hdr").read_bytes()
    assert raw[raw.index(b"+X 53\n") + 6:][:2] == b"\x02\x02"   # RLE
    ours = imagelib.load_image(tmp_path / "p.hdr")
    theirs = imagelib.load_image(tmp_path / "j.hdr")
    cv_ours = cv2.imread(str(tmp_path / "p.hdr"), cv2.IMREAD_UNCHANGED)
    cv_theirs = cv2.imread(str(tmp_path / "j.hdr"), cv2.IMREAD_UNCHANGED)
    np.testing.assert_array_equal(ours, cv_ours[..., ::-1])
    np.testing.assert_array_equal(theirs, cv_theirs[..., ::-1])
    np.testing.assert_array_equal(ours, theirs)
    err = np.abs(ours - img) / np.maximum(img.max(-1, keepdims=True), 1e-30)
    assert err[1:].max() <= 2.0 ** -7


def test_multilayer_exr_read_back_by_both_readers(tmp_path):
    """Layer channels, float bits and ig* attributes as the JAX writer's:
    ignis_tpu.utils.exr.read_exr and the port's read_exr see the same
    channels, and so does OpenCV for the default layer; the file is byte
    for byte the JAX writer's."""
    import cv2
    from ignis_tpu.utils.image import write_exr_multilayer as jax_write
    rng = np.random.default_rng(5)
    layers = {"": rng.random((19, 23, 3)).astype(np.float32) * 4,
              "Normals": rng.standard_normal((19, 23, 3)).astype(np.float32),
              "Depth": rng.random((19, 23)).astype(np.float32) * 9}
    meta = {"igTechniqueType": "path", "igSPP": 16, "igSeed": 3,
            "igCameraEye": (0.5, 1.0, -2.0), "igExposure": 0.25}
    imagelib.write_exr_multilayer(tmp_path / "p.exr", layers, meta)
    jax_write(str(tmp_path / "j.exr"), layers, meta)
    assert (tmp_path / "p.exr").read_bytes() == \
        (tmp_path / "j.exr").read_bytes()
    theirs, size = jax_read_exr(str(tmp_path / "p.exr"))
    ours, size2 = read_exr(tmp_path / "p.exr")
    assert size == size2 == (23, 19)
    assert sorted(theirs) == sorted(ours) == sorted(
        ["R", "G", "B", "Normals.R", "Normals.G", "Normals.B", "Depth.R",
         "Depth.G", "Depth.B"])
    for k in theirs:
        np.testing.assert_array_equal(ours[k], theirs[k])
    np.testing.assert_array_equal(ours["Normals.G"], layers["Normals"][..., 1])
    np.testing.assert_array_equal(ours["Depth.B"], layers["Depth"])
    cv = cv2.imread(str(tmp_path / "p.exr"), cv2.IMREAD_UNCHANGED)
    if cv is not None:   # OpenCV builds without an EXR codec read nothing
        np.testing.assert_array_equal(cv[..., ::-1][..., :3], layers[""])


def test_save_image_exr_read_back_by_both_readers(tmp_path):
    from ignis_tpu.utils.exr import load_exr_rgb as jax_load
    img = _ldr_image() * 7.0
    imagelib.save_image(tmp_path / "p.exr", img)
    np.testing.assert_array_equal(jax_load(str(tmp_path / "p.exr")), img)
    np.testing.assert_array_equal(imagelib.load_image(tmp_path / "p.exr"),
                                  img)


@pytest.mark.parametrize("suffix", [".jpg", ".bmp", ".tga"])
def test_unported_formats_raise(tmp_path, suffix):
    with pytest.raises(NotImplementedError, match="not ported"):
        imagelib.save_image(tmp_path / f"x{suffix}", _ldr_image())
    with pytest.raises(NotImplementedError, match="not ported"):
        imagelib.load_image(tmp_path / f"x{suffix}")
