"""SGI LogLuv TIFF (ignis_tpu_torch/utils/logluv.py, utils/tiff.py)
against OpenCV, through which ignis_tpu reads it: cv2's own SGILog and
SGILog24 files of float images, LogL files of float grey, and files
encoded here from libtiff's tif_luv.c layout (every 24-bit u'v' index,
random 32-bit words with their sign bits, strips and tiles in both byte
orders) held to cv2.imdecode exactly; load_image held to ignis_tpu's
load_image exactly (LogLuv is linear radiance to both, LogL the int8 tone
curve cv2 gives both)."""
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest

from ignis_tpu.utils import image as jax_image
from ignis_tpu_torch.utils import image as imagelib
from ignis_tpu_torch.utils import logluv
from ignis_tpu_torch.utils.tiff import decode_tiff

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))
from make_image_fixtures import hdr, logluv_tiff, tiff_file  # noqa: E402

FLAGS = cv2.IMREAD_UNCHANGED | cv2.IMREAD_ANYDEPTH | cv2.IMREAD_ANYCOLOR
FIXTURES = Path(__file__).resolve().parent / "data" / "images"


def _cv2(data: bytes):
    """cv2.imdecode as [h, w, 3] RGB (grey replicated), or None."""
    img = cv2.imdecode(np.frombuffer(data, np.uint8), FLAGS)
    if img is None:
        return None
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, -1)
    return np.ascontiguousarray(img[..., 2::-1])


def _encoded(img, comp):
    ok, buf = cv2.imencode(".tif", img, [cv2.IMWRITE_TIFF_COMPRESSION, comp])
    assert ok
    return buf.tobytes()


@pytest.mark.parametrize("level", [1, 300, 640, 1023])
def test_every_sgilog24_index_matches_cv2(level):
    """All 16,384 14-bit chroma indices (the 16,289 of libtiff's u'v'
    table and the neutral past it) at a 10-bit log luminance: the port's
    float RGB equals cv2's bit for bit, so the recovered table
    (utils/logluv_table.py) is libtiff's."""
    words = (np.uint32(level) << 14) | np.arange(1 << 14, dtype=np.uint32)
    data = logluv_tiff(words.reshape(128, 128), 34677)
    got = decode_tiff(data)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, _cv2(data))


def test_uv_table_shape():
    """163 rows of cells, 16,289 in all, each row's u' start inside
    [0, 0.62] and rising row widths toward the middle of the gamut."""
    rows = logluv._uv_rows()
    assert len(rows) == 163 and rows[-1][1] + rows[-1][2] == 16289
    assert all(0.0 < u < 0.62 for u, _, _ in rows)


@pytest.mark.parametrize("order", ["<", ">"])
@pytest.mark.parametrize("layout", ["strips1", "strips5", "tiles"])
@pytest.mark.parametrize("kind", ["luv32", "luv24", "logl"])
def test_hand_encoded_layouts_match_cv2(kind, layout, order):
    """Random words (32-bit with the sign bit set on some, 24-bit, 16-bit
    LogL) with long runs in some rows, in strips of 1 or 5 rows or 16 x 16
    tiles, little- and big-endian: decode_tiff equals cv2, dtype too."""
    rng = np.random.default_rng(len(kind) * 7 + len(layout) + ord(order))
    h, w = 21, 37
    if kind == "luv32":
        words = rng.integers(0, 1 << 32, (h, w), dtype=np.uint64).astype(
            np.uint32)
    elif kind == "luv24":
        words = rng.integers(0, 1 << 24, (h, w)).astype(np.uint32)
    else:
        words = rng.integers(0, 1 << 16, (h, w)).astype(np.uint16)
    words[::3, : w // 2] = words[::3, :1]             # runs
    kw = ({"tile": (16, 16)} if layout == "tiles"
          else {"rows_per_strip": int(layout[6:])})
    data = logluv_tiff(words, 34677 if kind == "luv24" else 34676, order,
                       **kw)
    got, want = decode_tiff(data), _cv2(data)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("comp", [34676, 34677])
@pytest.mark.parametrize("size", [(1, 1), (5, 7), (19, 26), (8, 33)],
                         ids=["1x1", "5x7", "19x26", "8x33"])
def test_cv2_written_matches_cv2_and_jax(tmp_path, comp, size):
    """cv2's SGILog and SGILog24 files of float RGB over six decades,
    black pixels and a sun of 2e4 (which SGILog24 clips): decode_samples
    equals cv2's floats and load_image equals ignis_tpu's, bit for bit,
    at widths that do and do not fill cv2's 4-pixel XYZ conversion."""
    img = hdr(*size, seed=sum(size))
    img[-1, -1] = (2e4, 1e4, 5e3)
    data = _encoded(np.ascontiguousarray(img[..., ::-1]), comp)
    p = tmp_path / "x.tif"
    p.write_bytes(data)
    got = imagelib.decode_samples(p)
    np.testing.assert_array_equal(got, _cv2(data))
    for lin in (False, True):
        np.testing.assert_array_equal(
            imagelib.load_image(p, linear=lin),
            jax_image.load_image(str(p), linear=lin))


@pytest.mark.parametrize("fmt", [1, 2], ids=["unsigned", "signed"])
def test_logl_grey_tones_match_cv2_and_jax(tmp_path, fmt):
    """LogL (photometric 32844): cv2's float grey file and a hand-encoded
    one of every sign and magnitude; cv2 reads 256 sqrt(Y) truncated (0
    at Y <= 0, 255 at Y >= 1) as uint8, or int8 for signed samples (cv2's
    own files), and so do decode_samples and both load_images."""
    words = np.arange(0, 1 << 16, 97, dtype=np.uint16)[:600].reshape(20, 30)
    words[0, :4] = (0, 0x8000, 0x7FFF, 16384)
    data = logluv_tiff(words, 34676, rows_per_strip=4, signed=fmt == 2)
    want = _cv2(data)
    assert want.dtype == (np.int8 if fmt == 2 else np.uint8)
    got = decode_tiff(data)
    np.testing.assert_array_equal(got, want)
    grey = hdr(17, 23, 92)[..., 1] * np.float32(0.01)
    cv2_file = _encoded(grey, 34676)
    p = tmp_path / "g.tif"
    p.write_bytes(cv2_file)
    assert imagelib.decode_samples(p).dtype == np.int8
    np.testing.assert_array_equal(imagelib.decode_samples(p), _cv2(cv2_file))
    np.testing.assert_array_equal(imagelib.load_image(p),
                                  jax_image.load_image(str(p)))


@pytest.mark.parametrize("width", list(range(1, 10)) + [31, 64, 101])
def test_xyz_to_rgb_equals_cvtcolor(width):
    """utils/logluv.xyz_to_rgb against cv2.cvtColor(COLOR_XYZ2BGR) on
    float32 XYZ over eight decades: bit-equal, including the last w % 4
    pixels of a row, which OpenCV sums in another order."""
    rng = np.random.default_rng(width)
    xyz = (rng.random((7, width, 3)) * 10.0 ** rng.uniform(
        -4, 4, (7, width, 1))).astype(np.float32)
    want = cv2.cvtColor(xyz, cv2.COLOR_XYZ2BGR)[..., ::-1]
    np.testing.assert_array_equal(logluv.xyz_to_rgb(xyz), want)


@pytest.mark.parametrize("case", ["luv_uncompressed", "luv_lzw",
                                  "rgb_under_sgilog", "grey_under_sgilog",
                                  "luv_planar", "luv_one_sample",
                                  "logl_three_samples", "logl_sgilog24",
                                  "logl_float"])
def test_combinations_cv2_refuses_raise_ioerror(case):
    """The LogLuv combinations libtiff or OpenCV read nothing of (LogLuv
    outside SGILog, SGILog under another photometric, planar or one-sample
    LogLuv, LogL of three samples, under SGILog24 or of float samples)
    raise IOError, as ignis_tpu's load_image raises for cv2's None."""
    from make_image_fixtures import sgilog_rows
    s3 = np.zeros((4, 6, 3), np.int16)
    s1 = np.zeros((4, 6, 1), np.int16)
    zero4 = lambda c: sgilog_rows(np.zeros(c.shape[:2], np.uint32), 4)  # noqa
    zero2 = lambda c: sgilog_rows(np.zeros(c.shape[:2], np.uint32), 2)  # noqa
    data = {
        "luv_uncompressed": lambda: tiff_file(s3, photo=32845),
        "luv_lzw": lambda: tiff_file(s3, comp=5, photo=32845),
        "rgb_under_sgilog": lambda: tiff_file(s3, comp=34676, photo=2,
                                              encode=zero4),
        "grey_under_sgilog": lambda: tiff_file(s1, comp=34676, photo=1,
                                               encode=zero2),
        "luv_planar": lambda: tiff_file(s3, comp=34676, photo=32845,
                                        planar=True, encode=zero4),
        "luv_one_sample": lambda: tiff_file(s1, comp=34676, photo=32845,
                                            encode=zero4),
        "logl_three_samples": lambda: tiff_file(s3, comp=34676,
                                                photo=32844, encode=zero2),
        "logl_sgilog24": lambda: tiff_file(s1, comp=34677, photo=32844,
                                           encode=lambda c: bytes(
                                               3 * c.shape[0] * c.shape[1])),
        "logl_float": lambda: tiff_file(np.zeros((4, 6, 1), np.float32),
                                        comp=34676, photo=32844,
                                        encode=zero2),
    }[case]()
    assert _cv2(data) is None
    with pytest.raises(IOError):
        decode_tiff(data)


@pytest.mark.parametrize("name", ["env_sgilog_256x128.tif",
                                  "env_sgilog24_256x128.tif"])
def test_environment_maps_match_cv2_pixels(name):
    """The 256 x 128 substitute environment map as cv2 writes it in
    SGILog and SGILog24 (the files chip_smoke.py's texture phase lights a
    scene with): cv2's floats (cv2_pixels.npz) exactly, the sun of about
    2e4 kept by SGILog and clipped by SGILog24's 10-bit log luminance (at
    Y 15.9) as cv2 clips it, each file at most 150 KB."""
    want = np.load(FIXTURES / "cv2_pixels.npz")[name]
    got = imagelib.decode_samples(FIXTURES / name)
    assert got.dtype == np.float32 and got.shape == (128, 256, 3)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _cv2((FIXTURES / name).read_bytes()))
    assert (FIXTURES / name).stat().st_size <= 150_000
    assert (got.max() > 1e4) == ("sgilog24" not in name)


def test_logluv_environment_step_on_cpu(tmp_path):
    """chip_smoke.logluv_env_step on the CPU: the scene lit by each
    LogLuv map alone (an env light's radiance texture) renders finite,
    its film bit-equal to the same scene lit by an EXR of load_image's
    radiance, as phase 16 renders both on the card."""
    import chip_smoke
    out = chip_smoke.logluv_env_step("cpu", tmp_path, size=16)
    assert sorted(out["maps"]) == ["env_sgilog24_256x128.tif",
                                   "env_sgilog_256x128.tif"]
    for row in out["maps"].values():
        assert row["bit_equal"] and row["film_mean"] > 0
        assert row["decode_s"] > 0
