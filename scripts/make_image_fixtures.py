"""Write the image fixtures of tests/data/images with OpenCV, and beside
them `cv2_pixels.npz`: each file as cv2.imread reads it (IMREAD_UNCHANGED
| ANYDEPTH | ANYCOLOR), as [h, w, 3] RGB (grey replicated).

The port's decoders are held to these pixels where no OpenCV is at hand
(chip_smoke.py's texture phase runs on a machine without cv2; the CPU
tests compare with cv2 directly). Run from the repository's root:

    python scripts/make_image_fixtures.py

The fixtures: a progressive 4:2:0 JPEG, an 8-bit palette BMP (cv2 writes
a grey image so), a 16-bit RGB TIFF with LZW and the horizontal
predictor, a binary 8-bit PPM and a colour PFM, each a few KB.
"""
from pathlib import Path

import cv2
import numpy as np

OUT = Path(__file__).resolve().parent.parent / "tests" / "data" / "images"
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


FIXTURES = {
    "progressive_420.jpg": lambda: (
        smooth(40, 56, 1).astype(np.uint8),
        [cv2.IMWRITE_JPEG_PROGRESSIVE, 1,
         cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
         cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420]),
    "palette_8bit.bmp": lambda: (smooth(24, 37, 2)[..., 1].astype(np.uint8),
                                 []),
    "lzw_predictor_16bit.tif": lambda: (
        smooth(24, 32, 3, 65535.0).astype(np.uint16),
        [cv2.IMWRITE_TIFF_COMPRESSION, cv2.IMWRITE_TIFF_COMPRESSION_LZW,
         cv2.IMWRITE_TIFF_PREDICTOR, cv2.IMWRITE_TIFF_PREDICTOR_HORIZONTAL]),
    "rgb_8bit.ppm": lambda: (smooth(20, 27, 4).astype(np.uint8),
                             [cv2.IMWRITE_PXM_BINARY, 1]),
    "rgb_float.pfm": lambda: (smooth(16, 21, 5, 4.0).astype(np.float32), []),
}


def cv2_rgb(path) -> np.ndarray:
    img = cv2.imread(str(path), FLAGS)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, -1)
    return np.ascontiguousarray(img[..., 2::-1])


def main() -> None:
    OUT.mkdir(parents=True, exist_ok=True)
    pixels = {}
    for name, make in FIXTURES.items():
        img, params = make()
        if img.ndim == 3:
            img = np.ascontiguousarray(img[..., ::-1])     # RGB -> BGR
        assert cv2.imwrite(str(OUT / name), img, params), name
        pixels[name] = cv2_rgb(OUT / name)
        print(f"{name}: {(OUT / name).stat().st_size} bytes, "
              f"{pixels[name].shape} {pixels[name].dtype}")
    np.savez_compressed(OUT / "cv2_pixels.npz", **pixels)


if __name__ == "__main__":
    main()
