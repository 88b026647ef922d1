"""AVIF grid primary items (ignis_tpu_torch/utils/avif.py) against
OpenCV (libavif 1.4.2), through which ignis_tpu reads them. No writer
here makes a grid, so the files are laid out here
(scripts/make_image_fixtures.py's avif_grid, HEIF's ImageGrid) around
the AV1 items of cv2's and Pillow's single-image files: 1 x 2, 2 x 1 and
2 x 2 grids cut to their output size, the ImageGrid in `idat` or `mdat`
with 16- or 32-bit sizes, 4:2:0 and 4:4:4 tiles, an alpha grid; the
port's pixels equal cv2's exactly. The grids libavif refuses (tiles under
64 pixels, odd 4:2:0 tiles or output, an output the tiles overfill or do
not fill, too few tiles) raise IOError."""
import io
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest

from ignis_tpu.utils import image as jax_image
from ignis_tpu_torch.utils import avif
from ignis_tpu_torch.utils import image as imagelib

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))
from make_image_fixtures import avif_grid, rgb8  # noqa: E402

FLAGS = cv2.IMREAD_UNCHANGED | cv2.IMREAD_ANYDEPTH | cv2.IMREAD_ANYCOLOR
FIXTURES = Path(__file__).resolve().parent / "data" / "images"


def _cv2(data: bytes):
    img = cv2.imdecode(np.frombuffer(data, np.uint8), FLAGS)
    if img is None:
        return None
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, -1)
    return np.ascontiguousarray(img[..., 2::-1])


def _tiles(n, w, h, seed, lossless=False):
    params = [cv2.IMWRITE_AVIF_QUALITY, 100] if lossless else []
    return [cv2.imencode(".avif", rgb8(h, w, seed + k)[..., ::-1],
                         params)[1].tobytes() for k in range(n)]


@pytest.mark.parametrize("in_idat,wide", [(True, False), (False, True),
                                          (True, True), (False, False)],
                         ids=["idat16", "mdat32", "idat32", "mdat16"])
@pytest.mark.parametrize("rows,cols,out", [
    (1, 2, (128, 64)), (2, 1, (64, 128)), (2, 2, (100, 90)),
    (2, 2, (128, 128)), (1, 3, (130, 40))],
    ids=["1x2", "2x1", "2x2_cut", "2x2_full", "1x3_cut"])
def test_grids_match_cv2(rows, cols, out, in_idat, wide):
    """Grids of cv2's 64 x 64 4:2:0 tiles, whole or cut to an even output
    size: decode_avif equals cv2.imdecode exactly (the tiles laid out and
    cut before libavif's conversion, so its chroma filter crosses the
    tile edges as cv2's does)."""
    data = avif_grid(_tiles(rows * cols, 64, 64, rows * 10 + cols), rows,
                     cols, *out, in_idat, wide)
    want = _cv2(data)
    assert want is not None and want.shape == (out[1], out[0], 3)
    np.testing.assert_array_equal(avif.decode_avif(data, "g.avif"), want)


@pytest.mark.parametrize("out", [(128, 64), (127, 63), (131, 61)],
                         ids=["128x64", "127x63", "131x61"])
def test_lossless_444_tiles_match_cv2(out):
    """Lossless (4:4:4, identity matrix) tiles of 66 x 64: odd output
    sizes are read too, as cv2 reads them."""
    data = avif_grid(_tiles(2, 66, 64, 3, lossless=True), 1, 2, *out)
    np.testing.assert_array_equal(avif.decode_avif(data, "g.avif"),
                                  _cv2(data))


def test_alpha_grid_matches_cv2():
    """Pillow's RGBA files as tiles with an alpha grid beside the colour
    grid (`auxl`): the colour read as cv2 reads it, alpha dropped."""
    from PIL import Image
    tiles = []
    for k in range(2):
        rgba = np.dstack([rgb8(64, 64, 40 + k), rgb8(64, 64, 50 + k)[..., 0]])
        bio = io.BytesIO()
        Image.fromarray(rgba, "RGBA").save(bio, "AVIF", quality=80)
        tiles.append(bio.getvalue())
    data = avif_grid(tiles, 1, 2, 128, 64, alpha_tiles=tiles)
    assert avif.parse_avif(data)["alpha"]
    np.testing.assert_array_equal(avif.decode_avif(data, "g.avif"),
                                  _cv2(data))


@pytest.mark.parametrize("case", ["tiles_48", "odd_tile_420", "odd_output",
                                  "output_overfilled", "output_unfilled",
                                  "too_few_tiles", "ipma_not_rising"])
def test_grids_libavif_refuses_raise_ioerror(tmp_path, case):
    """The grids libavif refuses raise IOError, as ignis_tpu's load_image
    raises for cv2's None: tiles under 64 pixels (MIAF 7.3.11.4.2), an
    odd 4:2:0 tile or output, an output larger than the tiles or leaving
    a row of tiles empty, fewer tiles than the grid names, item
    properties (ipma) whose item IDs do not rise."""
    if case == "tiles_48":
        data = avif_grid(_tiles(2, 48, 48, 1), 1, 2, 96, 48)
    elif case == "odd_tile_420":
        data = avif_grid(_tiles(2, 65, 64, 1), 1, 2, 130, 64)
    elif case == "odd_output":
        data = avif_grid(_tiles(2, 64, 64, 1), 1, 2, 127, 64)
    elif case == "output_overfilled":
        data = avif_grid(_tiles(2, 64, 64, 1), 1, 2, 130, 64)
    elif case == "output_unfilled":
        data = avif_grid(_tiles(4, 64, 64, 1), 2, 2, 64, 128)
    elif case == "ipma_not_rising":
        data = bytearray(avif_grid(_tiles(2, 64, 64, 1), 1, 2, 128, 64))
        at = data.index(b"ipma") + 12                 # item 1's entry
        one = data[at:at + 5]                          # ID, 2 properties
        rest = data[at + 5:at + 5 + 2 * 5]             # items 3 and 4
        data[at:at + 15] = rest + one
        data = bytes(data)
    else:
        data = bytearray(avif_grid(_tiles(2, 64, 64, 1), 1, 2, 128, 64))
        at = data.index(b"dimg") + 6
        data[at:at + 2] = (1).to_bytes(2, "big")      # one reference
        data = bytes(data)
    assert _cv2(data) is None
    p = tmp_path / "g.avif"
    p.write_bytes(data)
    with pytest.raises(IOError):
        imagelib.load_image(p)
    with pytest.raises(IOError):
        jax_image.load_image(str(p))


@pytest.mark.parametrize("name", ["grid_2x1.avif", "grid_2x2_crop.avif"])
def test_grid_fixtures_load_as_jax(name):
    """The grid fixtures: cv2_pixels.npz exactly; ignis_tpu's load_image
    gives those samples unscaled (ROADMAP queue 3), the port's / 255."""
    want = np.load(FIXTURES / "cv2_pixels.npz")[name]
    got = imagelib.decode_samples(FIXTURES / name)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(jax_image.load_image(str(FIXTURES / name)),
                                  got.astype(np.float32))
    np.testing.assert_array_equal(
        imagelib.load_image(FIXTURES / name, linear=True),
        got / np.float32(255))
