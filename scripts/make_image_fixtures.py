"""Write the image fixtures of tests/data/images with OpenCV and Pillow,
and beside them `cv2_pixels.npz`: each file as cv2.imread reads it
(IMREAD_UNCHANGED | ANYDEPTH | ANYCOLOR), as [h, w, 3] RGB (grey
replicated, alpha dropped).

The port's decoders are held to these pixels where no OpenCV is at hand
(chip_smoke.py's texture phase runs on a machine without cv2 or Pillow;
the CPU tests compare with cv2 directly). Run from the repository's
root:

    python scripts/make_image_fixtures.py

The fixtures, each a few KB: OpenCV's progressive 4:2:0 JPEG, 8-bit
palette BMP (cv2 writes a grey image so), 16-bit RGB TIFF with LZW and
the horizontal predictor, binary 8-bit PPM, colour PFM, default GIF (its
fixed 3-3-2 table), lossless and quality-80 WebP, default 8-bit LZW
TIFF, Radiance .pic and Sun raster; Pillow's interlaced 64-colour,
transparent and animated GIFs, lossy WebP with alpha (VP8X + ALPH),
lossless WebP with its transforms, CMYK JPEG and untransformed RGB JPEG;
and a JPEG named .png, whose suffix lies about its content. JPEG 2000
(each at least 32 pixels a side): cv2's default .jp2 of a noisy image
(rate 4 truncates it), lossless 16-bit and grey .jp2; Pillow's
irreversible 9/7 with the colour transform, 3 quality layers and RPCL,
a raw code stream of 32 x 32 tiles (the last ones partial) with 16 x 16
code-blocks, 32 x 32 precincts, CPRL, 3 resolutions and PLT markers,
and an RGBA .jp2 in PCRL. cv2 reads no JPEG 2000 with an image offset,
so no fixture has one (tests/test_torch_jpeg2000.py holds offsets to
Pillow's OpenJPEG decode).

Beside them, tests/data/images_1024 holds the decode-timing files of
chip_smoke.py's texture phase: one smooth 1024 x 1024 image as cv2's
quality-80 and lossless WebP, progressive JPEG and default .jp2
(lossless: the whole stream fits rate 4), with the SHA-256 of the pixels
cv2 reads from each (`cv2_sha256.json`). `jp2_psnr.json` holds the PSNR
of cv2's default .jp2 of cv2_q80.webp's pixels against them, the bar of
chip_smoke's .jp2 writer (less 0.5 dB).
"""
import hashlib
import io
import json
from pathlib import Path

import cv2
import numpy as np
from PIL import Image

DATA = Path(__file__).resolve().parent.parent / "tests" / "data"
OUT = DATA / "images"
TIMING = DATA / "images_1024"
FLAGS = cv2.IMREAD_UNCHANGED | cv2.IMREAD_ANYDEPTH | cv2.IMREAD_ANYCOLOR


def smooth(h, w, seed, scale=255.0):
    """[h, w, 3] float64: smooth colour waves with a little noise and a
    bright square, in [0, scale]."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([0.5 + 0.45 * np.sin(xx / (5.0 + c) + c)
                    * np.cos(yy / 7.0 - c) for c in range(3)], -1)
    img += rng.normal(0, 0.03, img.shape)
    img[h // 4:h // 2, w // 4:w // 2] = 0.95
    return np.clip(img, 0, 1) * scale


def rgb8(h, w, seed):
    return smooth(h, w, seed).astype(np.uint8)


def noisy8(h, w, seed):
    """rgb8 with strong noise: more than OpenCV's JPEG 2000 rate of 4
    holds."""
    rng = np.random.default_rng(seed)
    return np.clip(smooth(h, w, seed) + rng.normal(0, 40, (h, w, 3)), 0,
                   255).astype(np.uint8)


# OpenCV's files: name -> (image as RGB or grey, cv2.imwrite parameters)
CV2_FIXTURES = {
    "progressive_420.jpg": lambda: (
        rgb8(40, 56, 1),
        [cv2.IMWRITE_JPEG_PROGRESSIVE, 1,
         cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
         cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420]),
    "palette_8bit.bmp": lambda: (smooth(24, 37, 2)[..., 1].astype(np.uint8),
                                 []),
    "lzw_predictor_16bit.tif": lambda: (
        smooth(24, 32, 3, 65535.0).astype(np.uint16),
        [cv2.IMWRITE_TIFF_COMPRESSION, cv2.IMWRITE_TIFF_COMPRESSION_LZW,
         cv2.IMWRITE_TIFF_PREDICTOR, cv2.IMWRITE_TIFF_PREDICTOR_HORIZONTAL]),
    "rgb_8bit.ppm": lambda: (rgb8(20, 27, 4), [cv2.IMWRITE_PXM_BINARY, 1]),
    "rgb_float.pfm": lambda: (smooth(16, 21, 5, 4.0).astype(np.float32), []),
    "cv2_default.gif": lambda: (rgb8(24, 30, 6), []),
    "cv2_lossless.webp": lambda: (rgb8(24, 33, 7), []),
    "cv2_q80.webp": lambda: (rgb8(40, 52, 8), [cv2.IMWRITE_WEBP_QUALITY, 80]),
    "cv2_default_8bit.tiff": lambda: (rgb8(20, 26, 9), []),
    "cv2_rgbe.pic": lambda: (rgb8(18, 23, 10), []),
    "cv2_raster.sr": lambda: (rgb8(14, 19, 11), []),
    "cv2_default.jp2": lambda: (noisy8(36, 44, 22), []),
    "cv2_lossless_16bit.jp2": lambda: (
        smooth(32, 34, 23, 65535.0).astype(np.uint16),
        [cv2.IMWRITE_JPEG2000_COMPRESSION_X1000, 1000]),
    "cv2_grey.jp2": lambda: (noisy8(33, 40, 24)[..., 0], []),
}


def _pil(img, fmt, **kw) -> bytes:
    bio = io.BytesIO()
    img.save(bio, fmt, **kw)
    return bio.getvalue()


def _transparent_gif() -> bytes:
    """A 16-colour palette GIF whose index 3 is transparent (the left
    quarter and a stripe), the background entry 5."""
    rng = np.random.default_rng(12)
    idx = rng.integers(0, 16, (21, 27)).astype(np.uint8)
    idx[:, :6] = 3
    idx[10] = 3
    im = Image.fromarray(idx, "P")
    im.putpalette(rng.integers(0, 256, 48).tolist())
    return _pil(im, "GIF", transparency=3, background=5, optimize=False)


def _animated_gif() -> bytes:
    frames = [Image.fromarray(rgb8(22, 28, 13 + k)).quantize(32)
              for k in range(3)]
    return _pil(frames[0], "GIF", save_all=True, append_images=frames[1:],
                duration=100, loop=0)


def _alpha_webp() -> bytes:
    rgb = rgb8(26, 35, 16)
    alpha = np.clip(smooth(26, 35, 17)[..., 0] * 1.5, 0, 255).astype(np.uint8)
    return _pil(Image.fromarray(np.dstack([rgb, alpha]), "RGBA"), "WEBP",
                quality=70)


# Pillow's files: name -> bytes
PIL_FIXTURES = {
    "pil_interlaced_64.gif": lambda: _pil(
        Image.fromarray(rgb8(29, 37, 14)).quantize(64), "GIF",
        interlace=True),
    "pil_transparent.gif": _transparent_gif,
    "pil_animated.gif": _animated_gif,
    "pil_lossy_alpha.webp": _alpha_webp,
    "pil_lossless.webp": lambda: _pil(Image.fromarray(rgb8(27, 31, 18)),
                                      "WEBP", lossless=True, method=6),
    "pil_cmyk.jpg": lambda: _pil(Image.fromarray(rgb8(24, 40, 19))
                                 .convert("CMYK"), "JPEG", quality=90),
    "pil_rgb.jpg": lambda: _pil(Image.fromarray(rgb8(24, 40, 20)), "JPEG",
                                quality=90, keep_rgb=True),
    "pil_irreversible_layers.jp2": lambda: _pil(
        Image.fromarray(rgb8(40, 48, 25)), "JPEG2000", irreversible=True,
        mct=1, quality_mode="rates", quality_layers=[40, 20, 10],
        progression="RPCL"),
    "pil_tiles_precincts.j2k": lambda: _pil(
        Image.fromarray(rgb8(45, 61, 26)), "JPEG2000", no_jp2=True,
        tile_size=(32, 32), codeblock_size=(16, 16), precinct_size=(32, 32),
        progression="CPRL", num_resolutions=3, plt=True),
    "pil_rgba_pcrl.jp2": lambda: _pil(
        Image.fromarray(np.dstack([rgb8(34, 38, 27),
                                   rgb8(34, 38, 28)[..., 0]]), "RGBA"),
        "JPEG2000", progression="PCRL", quality_mode="rates",
        quality_layers=[8]),
    # a baseline JPEG under a PNG's name
    "jpeg_named.png": lambda: cv2.imencode(".jpg", rgb8(24, 32, 21))[1]
    .tobytes(),
}


def cv2_rgb(path) -> np.ndarray:
    img = cv2.imread(str(path), FLAGS)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, -1)
    return np.ascontiguousarray(img[..., 2::-1])


def timing_image() -> np.ndarray:
    """The smooth 1024 x 1024 RGB image of the decode-timing files."""
    yy, xx = np.mgrid[0:1024, 0:1024]
    return np.stack([127 + 120 * np.sin(xx / (40.0 + 9 * c) + c)
                     * np.cos(yy / (55.0 - 7 * c)) for c in range(3)],
                    -1).astype(np.uint8)


def main() -> None:
    OUT.mkdir(parents=True, exist_ok=True)
    pixels = {}
    for name, make in CV2_FIXTURES.items():
        img, params = make()
        if img.ndim == 3:
            img = np.ascontiguousarray(img[..., ::-1])     # RGB -> BGR
        assert cv2.imwrite(str(OUT / name), img, params), name
    for name, make in PIL_FIXTURES.items():
        (OUT / name).write_bytes(make())
    for name in list(CV2_FIXTURES) + list(PIL_FIXTURES):
        pixels[name] = cv2_rgb(OUT / name)
        print(f"{name}: {(OUT / name).stat().st_size} bytes, "
              f"{pixels[name].shape} {pixels[name].dtype}")
    np.savez_compressed(OUT / "cv2_pixels.npz", **pixels)
    TIMING.mkdir(parents=True, exist_ok=True)
    bgr = np.ascontiguousarray(timing_image()[..., ::-1])
    sums = {}
    for name, params in (("smooth_q80.webp", [cv2.IMWRITE_WEBP_QUALITY, 80]),
                         ("smooth_lossless.webp", []),
                         ("smooth_progressive.jpg",
                          [cv2.IMWRITE_JPEG_PROGRESSIVE, 1]),
                         ("smooth_default.jp2", [])):
        assert cv2.imwrite(str(TIMING / name), bgr, params), name
        sums[name] = hashlib.sha256(cv2_rgb(TIMING / name)
                                    .tobytes()).hexdigest()
        print(f"{name}: {(TIMING / name).stat().st_size} bytes")
    (TIMING / "cv2_sha256.json").write_text(json.dumps(sums, indent=1)
                                            + "\n")
    src = pixels["cv2_q80.webp"]
    ok, buf = cv2.imencode(".jp2", np.ascontiguousarray(src[..., ::-1]))
    back = cv2.imdecode(buf, FLAGS)[..., ::-1].astype(np.float64)
    psnr = 10 * np.log10(255.0 ** 2 / np.mean((back - src) ** 2))
    (OUT.parent / "jp2_psnr.json").write_text(json.dumps(
        {"cv2_q80.webp": psnr}, indent=1) + "\n")
    print(f"cv2's .jp2 of cv2_q80.webp's pixels: {len(buf)} bytes, PSNR "
          f"{psnr:.4f} dB")


if __name__ == "__main__":
    main()
