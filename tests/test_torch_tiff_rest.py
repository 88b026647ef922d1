"""The last TIFF variants OpenCV reads for ignis_tpu (utils/tiff.py):
YCbCr outside JPEG (every YCbCrSubsampling libtiff's RGBA reader
converts, ReferenceBlackWhite and YCbCrCoefficients at their defaults and
set, strips and tiles, the codecs and the predictor), CIELab, 64-bit
integers, palettes without a colour map, JPEG of planes and of white-is-
zero grey, and the compressions libtiff knows no codec for; decode_tiff
held to cv2.imdecode exactly (atol 0). Each combination OpenCV reads
nothing of raises IOError, as ignis_tpu's load_image raises for cv2's
None."""
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest

from ignis_tpu.utils import image as jax_image
from ignis_tpu_torch.utils import image as imagelib
from ignis_tpu_torch.utils.jpeg import encode_jpeg
from ignis_tpu_torch.utils.tiff import decode_tiff

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))
from make_image_fixtures import tiff_file, ycbcr_tiff  # noqa: E402

FLAGS = cv2.IMREAD_UNCHANGED | cv2.IMREAD_ANYDEPTH | cv2.IMREAD_ANYCOLOR
REF_BW = (532, 5, [16, 1, 235, 1, 128, 1, 240, 1, 128, 1, 240, 1])
BT709 = (529, 5, [2126, 10000, 7152, 10000, 722, 10000])
SUBSAMPLINGS = [(1, 1), (2, 1), (2, 2), (4, 1), (4, 2), (4, 4), (1, 2)]


def _cv2(data: bytes):
    img = cv2.imdecode(np.frombuffer(data, np.uint8), FLAGS)
    if img is None:
        return None
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, -1)
    return np.ascontiguousarray(img[..., 2::-1])


def _noise(h, w, seed, ch=3):
    return np.random.default_rng(seed).integers(0, 256, (h, w, ch)).astype(
        np.uint8)


@pytest.mark.parametrize("comp,predictor", [(1, 1), (5, 1), (5, 2), (8, 2),
                                            (32773, 1)],
                         ids=["none", "lzw", "lzw_pred", "deflate_pred",
                              "packbits"])
@pytest.mark.parametrize("hs,vs", SUBSAMPLINGS,
                         ids=[f"{a}x{b}" for a, b in SUBSAMPLINGS])
def test_ycbcr_strips_match_cv2(hs, vs, comp, predictor):
    """YCbCr in strips of data units (odd sizes, several strips, the last
    short), big- and little-endian by turns: decode_tiff equals cv2 to the
    level (libtiff's integer tables), at 4 x 4 with an odd count of units
    across too, where libtiff reads a strip's rows short."""
    for k, (h, w) in enumerate(((23, 29), (8, 8), (13, 5), (1, 37))):
        ycc = _noise(h, w, hs * 10 + vs + k)
        data = ycbcr_tiff(ycc, hs, vs, comp, "<>"[k % 2], None, vs * (k + 1),
                          predictor)
        want = _cv2(data)
        assert want is not None
        np.testing.assert_array_equal(decode_tiff(data), want)


@pytest.mark.parametrize("hs,vs", SUBSAMPLINGS,
                         ids=[f"{a}x{b}" for a, b in SUBSAMPLINGS])
def test_ycbcr_tiles_and_tags_match_cv2(hs, vs):
    """YCbCr in 16 x 16 tiles (clipped at the right and bottom: at 4 x 4
    libtiff skips a clipped tile's hidden units as 10 bytes each), with
    the predictor (kept where a tile's rows divide it, else left undone as
    libtiff leaves it), and ReferenceBlackWhite and BT.709's
    YCbCrCoefficients set: decode_tiff equals cv2."""
    for k, tags in enumerate(([], [REF_BW], [BT709], [REF_BW, BT709])):
        ycc = _noise(20 + k, 37 - 3 * k, 40 + k)
        data = ycbcr_tiff(ycc, hs, vs, 5, "<", (16, 16), None, 1 + k % 2,
                          tags)
        np.testing.assert_array_equal(decode_tiff(data), _cv2(data))


@pytest.mark.parametrize("case", ["planar_1x1", "planar_2x2", "sub_2x4",
                                  "16bit", "4_samples"])
def test_ycbcr_outside_what_cv2_reads(case):
    """Planar YCbCr at 1 x 1 reads as cv2 reads it; planar at 2 x 2, 2 x 4
    subsampling, 16-bit and four-sample YCbCr, which cv2 reads nothing
    of, raise IOError."""
    img = _noise(9, 13, 7)
    data = {
        "planar_1x1": lambda: tiff_file(img, "<", None, 5, photo=6,
                                        planar=True, rows_per_strip=4,
                                        tags=[(530, 3, [1, 1])]),
        "planar_2x2": lambda: tiff_file(img, "<", None, 1, photo=6,
                                        planar=True, rows_per_strip=4,
                                        tags=[(530, 3, [2, 2])]),
        "sub_2x4": lambda: ycbcr_tiff(_noise(8, 8, 1), 2, 4, 1, "<", None,
                                      8),
        "16bit": lambda: tiff_file(img.astype(np.uint16), "<", None, 1,
                                   photo=6, tags=[(530, 3, [1, 1])]),
        "4_samples": lambda: tiff_file(np.dstack([img, img[..., :1]]), "<",
                                       None, 1, photo=6,
                                       tags=[(530, 3, [1, 1])]),
    }[case]()
    want = _cv2(data)
    if case == "planar_1x1":
        np.testing.assert_array_equal(decode_tiff(data), want)
        return
    assert want is None
    with pytest.raises(IOError):
        decode_tiff(data)


@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("white", ["default", "d65"])
def test_cielab_matches_cv2(bits, white):
    """CIELab (photometric 8) of 8 and 16 bits, under libtiff's default
    white point (D50's XYZ) and a D65 WhitePoint tag: decode_tiff equals
    cv2's uint8 RGB (libtiff's float32 Lab to XYZ to sRGB display)."""
    rng = np.random.default_rng(bits)
    lab = rng.integers(0, 1 << bits, (40, 64, 3)).astype(
        np.uint8 if bits == 8 else np.uint16)
    tags = [] if white == "default" else [(318, 5, [3127, 10000, 3290,
                                                    10000])]
    data = tiff_file(lab, comp=5, photo=8, tags=tags)
    np.testing.assert_array_equal(decode_tiff(data), _cv2(data))


@pytest.mark.parametrize("dtype", ["u8", "i8"])
@pytest.mark.parametrize("channels", [1, 3])
def test_64bit_integers_match_cv2_and_jax(tmp_path, dtype, channels):
    """uint64 and int64 samples (OpenCV 5's 64-bit types), grey and RGB,
    with LZW and the predictor: decode_samples gives cv2's values and
    dtype, and load_image ignis_tpu's float32 of them."""
    rng = np.random.default_rng(channels)
    v = rng.integers(-2 ** 40 if dtype == "i8" else 0, 2 ** 40,
                     (6, 7, channels)).astype(dtype)
    p = tmp_path / "x.tif"
    p.write_bytes(tiff_file(v, comp=5, predictor=2))
    got = imagelib.decode_samples(p)
    assert got.dtype == np.dtype(dtype)
    np.testing.assert_array_equal(got, _cv2(p.read_bytes()))
    np.testing.assert_array_equal(imagelib.load_image(p),
                                  jax_image.load_image(str(p)).reshape(
                                      got.shape))


@pytest.mark.parametrize("case", ["u8_no_map", "u16_no_map", "int8_map"])
def test_palettes_match_cv2(case):
    """Palette images OpenCV reads outside the usual: without a colour map
    (8 and 16 bits: the indices as grey) and of signed 8-bit indices (the
    colours of their unsigned bytes, kept int8): decode_tiff equals cv2,
    dtype too."""
    idx = np.random.default_rng(3).integers(0, 16, (9, 11, 1))
    cmap = np.arange(768).reshape(256, 3).astype(np.uint16) * 80
    data = {"u8_no_map": lambda: tiff_file(idx.astype(np.uint8), photo=3),
            "u16_no_map": lambda: tiff_file(idx.astype(np.uint16) * 300,
                                            photo=3),
            "int8_map": lambda: tiff_file(idx.astype(np.int8) - 5, photo=3,
                                          cmap=cmap)}[case]()
    want = _cv2(data)
    got = decode_tiff(data)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", ["planar_rgb", "photo0_grey"])
def test_jpeg_planes_and_white_is_zero_match_cv2(case):
    """JPEG-compressed TIFF of planes (one grey JPEG a plane's strip) and
    of white-is-zero grey (inverted, as libtiff's RGBA reader inverts
    it): decode_tiff equals cv2 within 1 level."""
    img = _noise(19, 23, 11)
    if case == "planar_rgb":
        data = tiff_file(img, comp=7, planar=True, rows_per_strip=16,
                         encode=lambda c: encode_jpeg(c[..., 0], 90))
    else:
        data = tiff_file(img[..., :1], comp=7, photo=0,
                         encode=lambda c: encode_jpeg(c[..., 0], 90))
    assert np.abs(decode_tiff(data).astype(int) - _cv2(data)).max() <= 1


@pytest.mark.parametrize("comp", [9, 999, 34712])
@pytest.mark.parametrize("photo", [0, 1, 2, 3, 5])
def test_unknown_compressions_match_cv2(comp, photo):
    """A compression libtiff knows no codec for: OpenCV's RGBA reader
    keeps its zeroed buffer at 8 bits (white where white is zero, a
    palette's first colour, CMYK's white), and so does the port."""
    shape = (3, 4, {2: 3, 5: 4}.get(photo, 1))
    cmap = np.arange(768).reshape(256, 3).astype(np.uint16) * 80 \
        if photo == 3 else None
    data = tiff_file(np.full(shape, 7, np.uint8), comp=comp, photo=photo,
                     cmap=cmap, encode=lambda c: c.tobytes())
    np.testing.assert_array_equal(decode_tiff(data), _cv2(data))


REFUSED = {
    "float16": lambda: tiff_file(np.zeros((4, 5, 3), np.float16)),
    "mask_photometric_4": lambda: tiff_file(np.zeros((4, 5, 1), np.uint8),
                                            photo=4),
    "icclab_9": lambda: tiff_file(np.zeros((4, 5, 3), np.uint8), photo=9),
    "itulab_10": lambda: tiff_file(np.zeros((4, 5, 3), np.uint8), photo=10),
    "rgb_of_2_samples": lambda: tiff_file(np.zeros((4, 5, 2), np.uint8),
                                          photo=2),
    "predictor_4": lambda: tiff_file(np.zeros((4, 5, 3), np.uint8), comp=5,
                                     tags=[(317, 3, [4])]),
    "float_predictor_u8": lambda: tiff_file(np.zeros((4, 5, 3), np.uint8),
                                            comp=5, tags=[(317, 3, [3])]),
    "palette_16bit": lambda: tiff_file(np.zeros((4, 5, 1), np.uint16),
                                       photo=3,
                                       cmap=np.zeros((65536, 3), np.uint16)),
    "palette_1bit_no_map": lambda: tiff_file(np.zeros((4, 5, 1), np.uint8),
                                             photo=3, bits=1),
    "rgb_4bit": lambda: tiff_file(np.zeros((4, 5, 3), np.uint8), photo=2,
                                  bits=4),
    "cmyk_16bit": lambda: tiff_file(np.zeros((4, 5, 4), np.uint16), photo=5),
    "cmyk_inkset_2": lambda: tiff_file(np.zeros((4, 5, 4), np.uint8),
                                       photo=5, tags=[(332, 3, [2])]),
    "lab_4_samples": lambda: tiff_file(np.zeros((4, 5, 4), np.uint8),
                                       photo=8),
    "lab_planar": lambda: tiff_file(np.zeros((4, 5, 3), np.uint8), photo=8,
                                    planar=True),
    "old_jpeg_6": lambda: tiff_file(np.zeros((4, 5, 3), np.uint8), comp=6,
                                    encode=lambda c: c.tobytes()),
    "next_32766": lambda: tiff_file(np.zeros((4, 5, 3), np.uint8),
                                    comp=32766, encode=lambda c: c.tobytes()),
    "pixarlog_32909": lambda: tiff_file(np.zeros((4, 5, 3), np.uint8),
                                        comp=32909,
                                        encode=lambda c: c.tobytes()),
    "lzma_34925": lambda: tiff_file(np.zeros((4, 5, 3), np.uint8),
                                    comp=34925, encode=lambda c: c.tobytes()),
    "zstd_50000": lambda: tiff_file(np.zeros((4, 5, 3), np.uint8),
                                    comp=50000, encode=lambda c: c.tobytes()),
    "unknown_codec_16bit": lambda: tiff_file(np.zeros((4, 5, 3), np.uint16),
                                             comp=9,
                                             encode=lambda c: c.tobytes()),
    "mixed_bit_depths": lambda: tiff_file(np.zeros((4, 5, 3), np.uint8))
    .replace(b"\x08\x00\x08\x00\x08\x00", b"\x08\x00\x10\x00\x08\x00"),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_variants_cv2_reads_nothing_of_raise_ioerror(tmp_path, case):
    """Each TIFF combination the port once refused by name and cv2 reads
    nothing of raises IOError, and ignis_tpu's load_image raises too."""
    data = REFUSED[case]()
    assert _cv2(data) is None
    p = tmp_path / "x.tif"
    p.write_bytes(data)
    with pytest.raises(IOError):
        imagelib.load_image(p)
    with pytest.raises(IOError):
        jax_image.load_image(str(p))


@pytest.mark.parametrize("name", ["ycbcr_22_lzw.tif", "ycbcr_41_refbw.tif",
                                  "ycbcr_44_tiles.tif", "lab_8bit.tif",
                                  "uint64_grey.tif"])
def test_fixtures_match_cv2_pixels(name):
    """The fixtures of these variants decode to cv2_pixels.npz and cv2
    still reads each to those pixels."""
    path = Path(__file__).resolve().parent / "data" / "images" / name
    want = np.load(path.parent / "cv2_pixels.npz")[name]
    got = imagelib.decode_samples(path)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(_cv2(path.read_bytes()), want)
