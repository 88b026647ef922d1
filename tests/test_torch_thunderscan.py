"""ThunderScan TIFF (compression 32809) of 4-bit palettes in the port's
TIFF reader (ignis_tpu_torch/utils/tiff.py, `_thunder`) against OpenCV
(cv2 5.0.0, libtiff 4.7.1's tif_thunder.c), through which ignis_tpu
reads textures. libtiff has no ThunderScan encoder; the files come from
the hand-written one in scripts/thunderscan_encoder.py (fixtures by
scripts/make_named_fixtures.py): runs longer than 63 pixels, every
2-bit and 3-bit delta and their skip codes, raw values with stray high
bits, odd widths, several strips. cv2 expands the palette to BGR; the
port reads each file to its pixels at atol 0, damaged strips too (a row
the codes do not fill stops its strip, as libtiff's RGBA reader leaves
it), tiled files as libtiff's zeroed tiles, and raises IOError for
ThunderScan grey, which cv2 reads nothing of."""
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest

from ignis_tpu.utils import image as jax_image
from ignis_tpu_torch.utils import image as imagelib
from ignis_tpu_torch.utils import tiff

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))
import make_image_fixtures as M  # noqa: E402
import make_named_fixtures as F  # noqa: E402
import thunderscan_encoder as TE  # noqa: E402

FLAGS = cv2.IMREAD_UNCHANGED | cv2.IMREAD_ANYDEPTH | cv2.IMREAD_ANYCOLOR
FIXTURES = Path(__file__).resolve().parent / "data" / "images"
THUNDER = sorted(n for n in F.FIXTURES if n.startswith("thunder_"))


def _cv2(data: bytes):
    img = cv2.imdecode(np.frombuffer(data, np.uint8), FLAGS)
    if img is None:
        return None
    return np.ascontiguousarray(img[..., 2::-1])


def _codes(data: bytes):
    """Every code byte of a one-IFD ThunderScan fixture's strips."""
    order, big, ifd = tiff._header(data)
    t = tiff._tags(data, order, big, ifd)
    return b"".join(data[o:o + n] for o, n in zip(t[273], t[279]))


@pytest.mark.parametrize("name", THUNDER)
def test_fixture_matches_cv2(name):
    """Each ThunderScan fixture decodes to cv2_pixels.npz and to live
    cv2.imdecode exactly; ignis_tpu's load_image (which scales no .tif)
    gives those samples, the port's scales them by 255."""
    path = FIXTURES / name
    want = np.load(FIXTURES / "cv2_pixels.npz")[name]
    got = imagelib.decode_samples(path)
    assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(_cv2(path.read_bytes()), want)
    np.testing.assert_array_equal(jax_image.load_image(str(path)),
                                  got.astype(np.float32))
    np.testing.assert_array_equal(imagelib.load_image(path, linear=True),
                                  got.astype(np.float32) / np.float32(255))


def test_fixtures_use_every_code():
    """thunder_runs chains run codes past 63 pixels in two strips;
    thunder_codes uses every 2-bit and 3-bit delta value, both skip codes
    and raw values, over an odd width in two strips."""
    runs = _codes((FIXTURES / "thunder_runs.tif").read_bytes())
    assert any(a == b == 63 for a, b in zip(runs, runs[1:]))
    codes = _codes((FIXTURES / "thunder_codes.tif").read_bytes())
    d2 = {c >> s & 3 for c in codes if c >> 6 == 1 for s in (4, 2, 0)}
    d3 = {c >> s & 7 for c in codes if c >> 6 == 2 for s in (3, 0)}
    assert d2 == set(range(4)) and d3 == set(range(8))
    assert any(c >> 6 == 3 for c in codes) and any(
        c >> 6 == 0 for c in codes)
    for name in THUNDER:
        data = (FIXTURES / name).read_bytes()
        order, big, ifd = tiff._header(data)
        assert len(tiff._tags(data, order, big, ifd)[273]) == 2


@pytest.mark.parametrize("seed", range(12))
def test_random_files_match_cv2(seed):
    """Random palettes, sizes, strip heights and code choices, some files
    with a damaged byte or a truncated last strip: the port reads each
    as cv2 does, or raises IOError where cv2 reads nothing."""
    rng = np.random.default_rng(seed)
    h, w = int(rng.integers(1, 20)), int(rng.integers(1, 140))
    idx = rng.integers(0, 16, (h, w))
    if seed % 3 == 0:
        idx = np.cumsum(rng.integers(-2, 3, (h, w)), 1) % 16
    elif seed % 3 == 1:
        idx = np.where(rng.random((h, w)) < 0.8, idx[:, :1], idx)
    data = bytearray(TE.thunder_tiff(idx, rng.integers(0, 1 << 16, (16, 3)),
                                     int(rng.integers(1, h + 1)),
                                     rng if seed % 2 else None))
    if seed % 4 == 3:
        k = int(rng.integers(len(data) - 10, len(data)))
        data[k] = int(rng.integers(256))
    if seed % 6 == 5:
        data = data[:-2]
    data = bytes(data)
    want = _cv2(data)
    if want is None:
        with pytest.raises(IOError):
            tiff.decode_tiff(data)
    else:
        np.testing.assert_array_equal(tiff.decode_tiff(data), want)


@pytest.mark.parametrize("body,width,rows", [
    (bytes([0xC1, 0xC2, 0xC3]), 4, 1),           # not enough data
    (bytes([0xC3, 20, 0xC1, 8]), 9, 2),          # a run past the row
    (bytes([0xC3, 8, 0xC2, 0xC1, 8]), 9, 2),     # a run past an odd start
    (bytes([0x40 | 3 << 4 | 2 << 2 | 2, 0x80 | 5 << 3 | 4, 0xC1, 7]), 9,
     1),                                         # wrapped deltas, overrun
    (bytes([0xF3, 8, 0xE1, 8]), 9, 2)],          # raw values' high bits
    ids=["short", "overrun", "odd_overrun", "wrap", "raw_high"])
def test_damaged_rows_as_libtiff_leaves_them(body, width, rows):
    """Hand-made strips: libtiff stops a strip at the row its codes do
    not fill, keeping what was decoded (no half-filled last byte of a
    row the strip ends in) over the reader's zeroed buffer."""
    cmap = np.arange(16)[:, None].repeat(3, 1) * 4096
    data = M.tiff_file(np.zeros((rows, width, 1), np.uint8), comp=32809,
                       photo=3, cmap=cmap, bits=4,
                       encode=lambda c: body)
    np.testing.assert_array_equal(tiff.decode_tiff(data), _cv2(data))


def test_tiled_reads_as_zeroed_tiles():
    """A tiled ThunderScan file: libtiff decodes no tile for OpenCV's
    reader, which keeps its zeroed buffer (every pixel the colour map's
    first entry); the port reads it so."""
    rng = np.random.default_rng(5)
    idx = rng.integers(1, 16, (20, 40))
    cmap = rng.integers(0, 1 << 16, (16, 3))
    data = M.tiff_file(idx[..., None].astype(np.uint8), comp=32809,
                       photo=3, cmap=cmap, bits=4, tile=(16, 16),
                       encode=TE.encode)
    want = _cv2(data)
    assert (want == (cmap[0] >> 8).astype(np.uint8)).all()
    np.testing.assert_array_equal(tiff.decode_tiff(data), want)


def test_grey_reads_nothing(tmp_path):
    """ThunderScan of 4-bit grey: cv2 reads nothing, and both packages
    raise IOError."""
    data = F.thunder_grey()
    assert _cv2(data) is None
    p = tmp_path / "x.tif"
    p.write_bytes(data)
    with pytest.raises(IOError):
        imagelib.load_image(p)
    with pytest.raises(IOError):
        jax_image.load_image(str(p))
