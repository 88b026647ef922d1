"""CCITT bilevel TIFF (ignis_tpu_torch/utils/ccitt.py, utils/tiff.py)
against OpenCV, through which ignis_tpu reads it: Pillow's (libtiff's)
files under compression 2 (Modified Huffman), 32771 (the same, rows
word-aligned), 3 (T.4: 1-D, and 2-D under Group3Options bit 0, with and
without fill to a byte before each EOL) and 4 (T.6), FillOrder 1 and 2,
photometric 1 and, patched, 0, strips of several rows, and widths whose
runs pass 1,728 and 2,560 pixels; decode_tiff held to cv2.imdecode
exactly (uint8 grey), load_image to ignis_tpu's (which returns 0 and 255
unscaled for a .tif: ROADMAP queue 3)."""
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest

from ignis_tpu.utils import image as jax_image
from ignis_tpu_torch.utils import ccitt
from ignis_tpu_torch.utils import image as imagelib
from ignis_tpu_torch.utils.tiff import decode_tiff

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))
from make_image_fixtures import _pil_ccitt, tiff_file  # noqa: E402
from make_image_fixtures import with_short_tag  # noqa: E402

FLAGS = cv2.IMREAD_UNCHANGED | cv2.IMREAD_ANYDEPTH | cv2.IMREAD_ANYCOLOR
COMPRESSIONS = {"rle": ("tiff_ccitt", {}), "rlew": ("tiff_raw_16", {}),
                "g3_1d": ("group3", {}), "g3_2d": ("group3", {"t292": 1}),
                "g3_2d_fill": ("group3", {"t292": 5}),
                "g3_1d_fill": ("group3", {"t292": 4}),
                "g4": ("group4", {})}


def _cv2(data: bytes):
    img = cv2.imdecode(np.frombuffer(data, np.uint8), FLAGS)
    if img is None:
        return None
    return np.repeat(img[..., None], 3, -1) if img.ndim == 2 else img


def _image(kind, h, w, seed):
    """bool [h, w]: noise, blobs, or long runs (bands 50 pixels wide)."""
    rng = np.random.default_rng(seed)
    if kind == "noise":
        return rng.random((h, w)) > 0.5
    if kind == "runs":
        return np.repeat(rng.random((h, w // 50 + 1)) > 0.5, 50, 1)[:, :w]
    yy, xx = np.mgrid[0:h, 0:w]
    return np.sin(xx / 5.0 + seed) * np.cos(yy / 4.0) > 0.2


@pytest.mark.parametrize("kind,size", [
    ("noise", (9, 13)), ("blobs", (23, 37)), ("runs", (5, 1800)),
    ("runs", (4, 3000)), ("blobs", (1, 1)), ("noise", (40, 71))],
    ids=["noise_9x13", "blobs_23x37", "runs_1800", "runs_3000", "1x1",
         "noise_40x71"])
@pytest.mark.parametrize("comp", list(COMPRESSIONS))
def test_pillow_files_match_cv2(comp, kind, size):
    """Each compression and option over noise, blobs and runs past 1,728
    and 2,560 pixels: decode_tiff equals cv2.imdecode exactly (for 32771
    also where libtiff's word alignment leaves a row 8 bits off, as cv2
    reads it)."""
    name, info = COMPRESSIONS[comp]
    data = _pil_ccitt(_image(kind, *size, seed=size[1]), name, **info)
    want = _cv2(data)
    assert want is not None
    np.testing.assert_array_equal(decode_tiff(data), want)


@pytest.mark.parametrize("comp", ["rle", "g3_2d", "g4"])
@pytest.mark.parametrize("rows", [1, 3, 7])
def test_strips_fill_order_and_photometric_match_cv2(comp, rows):
    """Strips of 1, 3 and 7 rows (each strip coded afresh, 2-D rows
    against a white row at each strip's top), FillOrder 2 (each byte's
    bits reversed), and photometric 0 (white is zero, patched into the
    file): decode_tiff equals cv2."""
    name, info = COMPRESSIONS[comp]
    bits = _image("blobs", 17, 29, rows)
    for extra in ({"t278": rows}, {"t278": rows, "t266": 2}):
        data = _pil_ccitt(bits, name, **info, **extra)
        for photo in (1, 0):
            case = with_short_tag(data, 262, photo)
            np.testing.assert_array_equal(decode_tiff(case), _cv2(case))


@pytest.mark.parametrize("name", ["pil_ccitt_rle.tif", "pil_ccitt_rlew.tif",
                                  "pil_group3.tif", "pil_group3_2d.tif",
                                  "pil_group4_wide.tif",
                                  "group4_photo0_fill2.tif"])
def test_fixtures_load_as_jax(name):
    """The CCITT fixtures: decode_samples gives cv2's pixels
    (cv2_pixels.npz); ignis_tpu's load_image gives those samples
    unscaled, the port's load_image them / 255, sRGB-decoded unless
    linear (ROADMAP queue 3)."""
    path = Path(__file__).resolve().parent / "data" / "images" / name
    want = np.load(path.parent / "cv2_pixels.npz")[name]
    got = imagelib.decode_samples(path)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(jax_image.load_image(str(path)),
                                  got.astype(np.float32))
    np.testing.assert_array_equal(imagelib.load_image(path, linear=True),
                                  got / np.float32(255))


@pytest.mark.parametrize("black", [False, True], ids=["white", "black"])
def test_run_codes_are_prefix_free_and_round_trip(black):
    """T.4's run-length codes of a colour, with the extended makeup codes
    shared by both: no code is a prefix of another, and every run length
    0-2,560 coded as makeup codes then a terminating code decodes back
    through the port's 13-bit lookup."""
    codes = ccitt.run_codes(black)
    assert len(codes) == 64 + 27 + 13
    vals = sorted(codes.values(), key=len)
    for i, a in enumerate(vals):
        assert not any(b.startswith(a) for b in vals[i + 1:])
    for run in range(0, 2561, 7):
        bits = (codes[run // 64 * 64] if run >= 64 else "") + codes[run % 64]
        raw = bytes(int((bits + "0" * 16)[i:i + 8], 2)
                    for i in range(0, len(bits) + 8, 8))
        b = ccitt._Bits(raw, False)
        assert b.run(black) == run


@pytest.mark.parametrize("case", ["g4_8bit", "g3_rgb"])
def test_ccitt_of_more_than_one_bit_raises_ioerror(case):
    """CCITT compression of 8-bit grey or of RGB, which libtiff decodes
    nothing of: IOError, as ignis_tpu raises for cv2's None."""
    if case == "g4_8bit":
        data = tiff_file(np.zeros((4, 8, 1), np.uint8), comp=4,
                         encode=lambda c: bytes(4))
    else:
        data = tiff_file(np.zeros((4, 8, 3), np.uint8), comp=3,
                         encode=lambda c: bytes(4))
    assert _cv2(data) is None
    with pytest.raises(IOError):
        decode_tiff(data)
