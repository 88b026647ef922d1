"""Textures and image IO of ignis_tpu_torch against ignis_tpu.

Every texture kind (image under each wrap and filter,
checkerboard, brick, noise, perlin, fbm, voronoi, cellnoise, constant,
transform, and a PEXPR closure that reads another texture) made by
both packages from the same numpy inputs and evaluated on the same random
uv, out of [0, 1] included: within rtol 1e-5 / atol 1e-6 (the PEXPR one
within rtol 1e-6). The image loader against the JAX package's (OpenCV):
ZIP and uncompressed EXR and 8- and 16-bit PNGs in gray, gray+alpha, RGB
and RGBA, written here; exact for EXR, within 1e-6 after the sRGB decode
for PNG (16-bit samples scaled as the JAX loader should: it divides them
by 255). The substitute env generator and the EXR writer round-trip."""
import struct
import zlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from ignis_tpu.core.vec import Vec2 as JVec2
from ignis_tpu.models import texture as JT

from ignis_tpu_torch.core.vec import Vec2
from ignis_tpu_torch.models import texture as T

# The tensors here are small; one intra-op thread per test process keeps
# parallel test workers from oversubscribing the cores.
torch.set_num_threads(1)

N = 4096


def _uv(seed, lo=-1.5, hi=2.5):
    rs = np.random.RandomState(seed)
    return [rs.uniform(lo, hi, N).astype(np.float32) for _ in range(2)]


def _eval_both(make, seed):
    """Evaluate texture 0 of both packages' evaluators at random uv."""
    (jd, ja), (td, ta) = make(JT), make(T)
    u, v = _uv(seed)
    jev = JT.make_texture_evaluator(tuple(jd), tuple(ja))
    tev = T.make_texture_evaluator(tuple(td), tuple(ta))
    ids = np.zeros(N, np.int32)
    jc = jev(jnp.asarray(ids), JVec2(jnp.asarray(u), jnp.asarray(v)))
    tc = tev(torch.from_numpy(ids), Vec2(torch.from_numpy(u),
                                         torch.from_numpy(v)))
    return [np.asarray(c) for c in jc], [c.numpy() for c in tc]


def _single(fn):
    def make(lib):
        d, a = fn(lib)
        return [d], [a]
    return make


IMG = np.random.RandomState(5).rand(13, 17, 3).astype(np.float32) * 4.0
AFFINE = np.array([[1.7, 0.3, 0.25], [-0.2, 2.1, -0.4]], np.float32)


@pytest.mark.parametrize("wrap", ["REPEAT", "MIRROR", "CLAMP"])
@pytest.mark.parametrize("filt", ["NEAREST", "BILINEAR", "BICUBIC"])
def test_image_texture_matches_jax(wrap, filt):
    def make(lib):
        return lib.make_image_texture(
            IMG, getattr(lib.WrapMode, wrap), lib.WrapMode.REPEAT
            if wrap == "CLAMP" else getattr(lib.WrapMode, wrap),
            getattr(lib.FilterMode, filt), AFFINE)
    j, t = _eval_both(_single(make), 1)
    for a, b in zip(t, j):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


PROCEDURAL = {
    "checkerboard": ("CHECKERBOARD", dict(p0=3.0, p1=5.0)),
    "brick": ("BRICK", dict(p0=3.0, p1=6.0, transform=AFFINE, p2=0.05,
                            p3=0.1)),
    "noise": ("NOISE", dict(p0=8.0)),
    "perlin": ("PERLIN", dict(p0=6.0)),
    "fbm": ("FBM", dict(p0=5.0)),
    "voronoi": ("VORONOI", dict(p0=7.0)),
    "cellnoise": ("CELLNOISE", dict(p0=9.0)),
    "constant": ("CONSTANT", {}),
}


@pytest.mark.parametrize("name", sorted(PROCEDURAL))
def test_procedural_texture_matches_jax(name):
    kind, kw = PROCEDURAL[name]

    def make(lib):
        return lib.make_procedural(getattr(lib.TexKind, kind),
                                   (0.1, 0.2, 0.3), (0.9, 0.6, 0.4), **kw)
    j, t = _eval_both(_single(make), 2)
    for a, b in zip(t, j):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


def test_transform_texture_matches_jax():
    """A transform of a brick (tests/test_components.py:66), and a
    transform of a transform of an image: the uv goes through each
    wrapper's affine map first."""
    def make(lib):
        brick = lib.make_procedural(lib.TexKind.BRICK, (0.2, 0.1, 0.1),
                                    (0.7, 0.3, 0.2), 3.0, 6.0, None,
                                    0.05, 0.1)
        img = lib.make_image_texture(IMG, lib.WrapMode.MIRROR,
                                     lib.WrapMode.REPEAT,
                                     lib.FilterMode.BILINEAR)
        t0 = lib.make_procedural(lib.TexKind.TRANSFORM, (0, 0, 0), (1, 1, 1),
                                 transform=np.diag([2.0, 2.0, 1.0])[:2],
                                 inner=1)
        t1 = lib.make_procedural(lib.TexKind.TRANSFORM, (0, 0, 0), (1, 1, 1),
                                 transform=AFFINE, inner=3)
        t2 = lib.make_procedural(lib.TexKind.TRANSFORM, (0, 0, 0), (1, 1, 1),
                                 transform=AFFINE[::-1].copy(), inner=2)
        items = [t0, brick, img, t2, t1]
        return [d for d, _ in items], [a for _, a in items]
    (jd, ja), (td, ta) = make(JT), make(T)
    u, v = _uv(3)
    ids = np.random.RandomState(4).randint(0, 5, N).astype(np.int32)
    jc = JT.make_texture_evaluator(tuple(jd), tuple(ja))(
        jnp.asarray(ids), JVec2(jnp.asarray(u), jnp.asarray(v)))
    tev = T.make_texture_evaluator(tuple(td), tuple(ta))
    tid = torch.from_numpy(ids)
    tuv = Vec2(torch.from_numpy(u), torch.from_numpy(v))
    for a, b in zip(tev(tid, tuv), jc):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)
    # `ids` restricts the evaluation to the ids a slot can hold
    part = tev(tid, tuv, (0, 4))
    keep = (ids == 0) | (ids == 4)
    for a, b in zip(part, jc):
        np.testing.assert_allclose(a.numpy()[keep], np.asarray(b)[keep],
                                   rtol=1e-5, atol=1e-6)
        assert (a.numpy()[~keep] == 0).all()


def test_pexpr_texture_matches_jax():
    """A PEXPR texture evaluated through the evaluator (kind PEXPR calls
    desc.fn) on a bare uv, reading a second texture by name (the nested
    lookup the evaluator gives a closure), against the JAX package."""
    from ignis_tpu.scene.pexpr import Compiler as JC
    from ignis_tpu_torch.scene.pexpr import Compiler as TC
    src = "checker(uv * 2) * 0.5 + color(uv.x, fbm(uv * 3), 0.25)"

    def make(lib, comp):
        chk = lib.make_procedural(lib.TexKind.CHECKERBOARD, (0.1, 0.2, 0.3),
                                  (0.9, 0.8, 0.7), 4.0, 4.0)
        d, a = lib.make_procedural(lib.TexKind.PEXPR, (0, 0, 0), (1, 1, 1))
        d = d._replace(fn=comp({"checker": 1}).compile_color(src))
        return [d, chk[0]], [a, chk[1]]
    (jd, ja), (td, ta) = make(JT, JC), make(T, TC)
    u, v = _uv(8)
    ids = np.random.RandomState(9).randint(0, 2, N).astype(np.int32)
    jc = JT.make_texture_evaluator(tuple(jd), tuple(ja))(
        jnp.asarray(ids), JVec2(jnp.asarray(u), jnp.asarray(v)))
    tc = T.make_texture_evaluator(tuple(td), tuple(ta))(
        torch.from_numpy(ids), Vec2(torch.from_numpy(u), torch.from_numpy(v)))
    for a, b in zip(tc, jc):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)


# --- image IO ----------------------------------------------------------------

def _exr_uncompressed(path, img):
    """A scanline EXR with no compression (one line per block), channels
    B, G, R as float32."""
    h, w, _ = img.shape

    def attr(name, type_, data):
        return (name.encode() + b"\0" + type_.encode() + b"\0"
                + struct.pack("<I", len(data)) + data)
    chlist = b"".join(c + b"\0" + struct.pack("<iiii", 2, 0, 1, 1)
                      for c in (b"B", b"G", b"R")) + b"\0"
    header = (attr("channels", "chlist", chlist)
              + attr("compression", "compression", bytes([0]))
              + attr("dataWindow", "box2i",
                     struct.pack("<iiii", 0, 0, w - 1, h - 1))
              + attr("displayWindow", "box2i",
                     struct.pack("<iiii", 0, 0, w - 1, h - 1))
              + attr("lineOrder", "lineOrder", bytes([0]))
              + attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
              + attr("screenWindowCenter", "v2f", struct.pack("<ff", 0, 0))
              + attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
              + b"\0")
    lines = [np.stack([img[y, :, 2], img[y, :, 1], img[y, :, 0]])
             .astype("<f4").tobytes() for y in range(h)]
    table = 8 + len(header)
    off = table + 8 * h
    offsets = []
    for ln in lines:
        offsets.append(off)
        off += 8 + len(ln)
    with open(path, "wb") as f:
        f.write(struct.pack("<II", 20000630, 2) + header)
        f.write(b"".join(struct.pack("<Q", o) for o in offsets))
        for y, ln in enumerate(lines):
            f.write(struct.pack("<iI", y, len(ln)) + ln)


def _png(path, data, color_type):
    """A non-interlaced PNG of uint8/uint16 samples, rows filtered with
    each of the five filter types in turn."""
    h, w = data.shape[:2]
    depth = 16 if data.dtype == np.uint16 else 8
    raw = data.astype(">u2" if depth == 16 else np.uint8).reshape(h, -1)
    rows = raw.view(np.uint8).reshape(h, -1).astype(np.int32)
    bpp = rows.shape[1] // w
    out, prior = [], np.zeros(rows.shape[1], np.int32)
    for y in range(h):
        line, ft = rows[y], y % 5
        left = np.concatenate([np.zeros(bpp, np.int32), line[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int32), prior[:-bpp]])
        if ft == 0:
            f = line
        elif ft == 1:
            f = line - left
        elif ft == 2:
            f = line - prior
        elif ft == 3:
            f = line - (left + prior) // 2
        else:
            p = left + prior - upleft
            pa, pb, pc = abs(p - left), abs(p - prior), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prior, upleft))
            f = line - pred
        out.append(bytes([ft]) + (f & 0xFF).astype(np.uint8).tobytes())
        prior = line

    def chunk(tag, body):
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))
    ihdr = struct.pack(">IIBBBBB", w, h, depth, color_type, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
                + chunk(b"IDAT", zlib.compress(b"".join(out)))
                + chunk(b"IEND", b""))


@pytest.fixture(scope="module")
def jax_image():
    pytest.importorskip("cv2")
    from ignis_tpu.utils import image
    return image


@pytest.mark.parametrize("kind", ["zip", "none"])
def test_exr_loader_matches_jax(kind, tmp_path, jax_image):
    from ignis_tpu_torch.utils.image import _write_exr_fallback, load_image
    img = (np.random.RandomState(9).rand(37, 29, 3) * 50).astype(np.float32)
    p = tmp_path / f"{kind}.exr"
    (_write_exr_fallback if kind == "zip" else _exr_uncompressed)(p, img)
    got = load_image(p)
    np.testing.assert_array_equal(got, img)
    np.testing.assert_array_equal(got, jax_image.load_image(p))


@pytest.mark.parametrize("depth", [8, 16])
@pytest.mark.parametrize("color_type", [0, 2, 4, 6])
def test_png_loader_matches_jax(depth, color_type, tmp_path, jax_image):
    from ignis_tpu_torch.utils.image import load_image
    ch = {0: 1, 2: 3, 4: 2, 6: 4}[color_type]
    top = 255 if depth == 8 else 65535
    data = np.random.RandomState(depth + color_type).randint(
        0, top + 1, (11, 23, ch)).astype(np.uint16 if depth == 16
                                         else np.uint8)
    data[..., 0].flat[:3] = (0, top, top // 2)   # both ends of the range
    p = tmp_path / f"t{depth}_{color_type}.png"
    _png(p, data, color_type)
    raw = load_image(p, linear=True)
    assert raw.dtype == np.float32 and raw.shape == (11, 23, 3)
    ref = jax_image.load_image(p, linear=True)
    if depth == 16:
        # the JAX loader scales 16-bit samples by 1/255, not 1/65535
        # (ignis_tpu/utils/image.py:56, ROADMAP queue 3)
        ref = ref * np.float32(255.0 / 65535.0)
    np.testing.assert_allclose(raw, ref, rtol=1e-6, atol=1e-7)
    assert raw.min() == 0.0 and raw.max() == 1.0
    got = load_image(p)
    want = (jax_image.load_image(p) if depth == 8
            else jax_image.srgb_to_linear(ref).astype(np.float32))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_other_formats_raise(tmp_path):
    from ignis_tpu_torch.utils.image import load_image
    p = tmp_path / "x.jpg"
    p.write_bytes(b"\xff\xd8\xff")
    with pytest.raises(NotImplementedError, match="item 17"):
        load_image(p)


def test_substitute_env_matches_jax(tmp_path):
    """The port's envgen copy writes the same panorama as the JAX
    package's generator, and its EXR reads back exactly."""
    from ignis_tpu.utils.envgen import make_substitute_env as jmake
    from ignis_tpu_torch.utils.envgen import (ensure_substitute_env,
                                              make_substitute_env)
    from ignis_tpu_torch.utils.image import load_image
    img = make_substitute_env(128, 64)
    np.testing.assert_array_equal(img, jmake(128, 64))
    p = ensure_substitute_env(tmp_path, 128, 64)
    assert p.parent == tmp_path and p.name == "substitute_env_128x64.exr"
    np.testing.assert_array_equal(load_image(p), img)
    assert ensure_substitute_env(tmp_path, 128, 64) == p   # made once
