"""The HEIF layouts of AVIF the port once refused by name, in
ignis_tpu_torch/utils/avif.py, against OpenCV (cv2 5.0.0, libavif
1.4.2), through which ignis_tpu reads textures: gain maps (`tmap` items
of ISO 21496-1 metadata in an `altr` group), overlays (`iovl`), iloc
construction method 2, image sequences without a primary item, and a
sequence whose primary item and first track sample differ. The files
are composed by scripts/make_avif_items.py around AV1 items of the
port's encoder and Pillow's sequences (scripts/make_named_fixtures.py).

What cv2 shows: libavif reads an `avis` major brand by its colour track,
an `avif` one by its primary item; a `tmap` or `iovl` primary item, iloc
construction method 2 (on any item) and field sizes other than 0, 4 and
8, an `avif` brand without `meta` or an `avis` one without `moov` give
it nothing. cv2 takes a file for AVIF only where libavif parses its
first 500 bytes: libavif reads a primary grid's ImageGrid and, under
the `tmap` brand, the tone map metadata while parsing, and fails where
that data starts past them in a box that starts at or before their
end."""
import io
import struct
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest
from PIL import Image

from ignis_tpu.utils import image as jax_image
from ignis_tpu_torch.utils import avif
from ignis_tpu_torch.utils import image as imagelib

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))
import make_avif_items as I  # noqa: E402
import make_named_fixtures as F  # noqa: E402

FLAGS = cv2.IMREAD_UNCHANGED | cv2.IMREAD_ANYDEPTH | cv2.IMREAD_ANYCOLOR
FIXTURES = Path(__file__).resolve().parent / "data" / "images"
ITEMS = sorted(n for n in F.FIXTURES
               if n.startswith(("gain_", "track_", "item_")))


def _cv2(data: bytes):
    img = cv2.imdecode(np.frombuffer(data, np.uint8), FLAGS)
    if img is None:
        return None
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, -1)
    return np.ascontiguousarray(img[..., 2::-1])


def _same_as_cv2(data: bytes):
    """The port reads `data` as cv2 does: its pixels, or IOError where
    cv2 reads nothing."""
    want = _cv2(data)
    if want is None:
        with pytest.raises(IOError):
            avif.decode_avif(data, "x.avif")
    else:
        np.testing.assert_array_equal(avif.decode_avif(data, "x.avif"),
                                      want)
    return want


@pytest.mark.parametrize("name", ITEMS)
def test_fixture_matches_cv2(name):
    """Each gain-map, track-only and item-and-track fixture decodes to
    cv2_pixels.npz and to live cv2.imdecode exactly; ignis_tpu's
    load_image gives its samples as they are, the port's scaled."""
    path = FIXTURES / name
    want = np.load(FIXTURES / "cv2_pixels.npz")[name]
    got = imagelib.decode_samples(path)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(_cv2(path.read_bytes()), want)
    np.testing.assert_array_equal(jax_image.load_image(str(path)),
                                  got.astype(np.float32))
    np.testing.assert_array_equal(imagelib.load_image(path, linear=True),
                                  got.astype(np.float32) / np.float32(255))


def test_gain_map_layouts():
    """With the base image primary, cv2 shows the base (with or without
    the altr group and the tmap brand, the metadata where the signature
    check reads it); with the tmap primary, nothing."""
    base, gain = F.av1_stream(32, 48, 12), F.av1_stream(16, 24, 13)
    base_px = _cv2(F.avif_of(base))
    for group in (True, False):
        for brand, idat in ((False, False), (True, True)):
            got = _same_as_cv2(I.gain_map(base, gain, 48, 32, "base", group,
                                          brand, idat))
            np.testing.assert_array_equal(got, base_px)
        assert _same_as_cv2(I.gain_map(base, gain, 48, 32, "tmap",
                                       group)) is None


def test_signature_window_of_the_tone_map():
    """Under the tmap brand, the tone map metadata first in mdat, moved
    by a longer item name across cv2's 500-byte signature: the port
    reads or refuses each file as cv2 does (refused only where mdat
    starts at or before the window's end and the metadata past it)."""
    base, gain = F.av1_stream(32, 48, 12), F.av1_stream(16, 24, 13)
    seen = set()
    for pad in range(0, 160, 4):
        data = I.heif({
            1: {"type": "tmap", "data": I.tmap_metadata(), "name": "x" * pad,
                "props": [I.full_box(b"ispe", 0, struct.pack(">II", 48,
                                                              32))]},
            2: {"type": "av01", "data": base[0],
                "props": I.av1_props(base[1], 48, 32)},
            3: {"type": "av01", "data": gain[0], "name": "GMap",
                "props": I.av1_props(gain[1], 24, 16, nclx=False)}},
            2, refs=[("dimg", 1, [2, 3])], groups=[("altr", 10, [1, 2])],
            brands=(b"avif", b"mif1", b"miaf", b"tmap"))
        seen.add(_same_as_cv2(data) is None)
    assert seen == {True, False}


@pytest.mark.parametrize("wide", [False, True])
def test_overlay_reads_nothing(wide):
    """iovl primary items (canvas fill, inputs past the canvas' edge):
    libavif decodes no colour image from them, cv2 reads nothing and the
    port raises IOError."""
    a, b = F.av1_stream(16, 16, 17), F.av1_stream(16, 24, 18)
    assert _same_as_cv2(I.overlay([a, b], (40, 30), [(-5, 0), (30, 25)],
                                  (1000, 2000, 3000, 65535), wide)) is None


def test_iloc_method_2_on_any_item_and_field_sizes():
    """iloc construction method 2 on the primary item or on another
    item, and an item_reference_index of 2 bytes: libavif refuses the
    iloc box, cv2 reads nothing, the port raises IOError."""
    s = F.av1_stream(32, 48, 21)
    props = I.av1_props(s[1], 48, 32)
    files = [I.method2(*s),
             I.heif({1: {"type": "av01", "data": s[0], "props": props},
                     2: {"type": "Exif", "data": b"", "method": 2,
                         "from": 1}}, 1)]
    bad = bytearray(I.heif({1: {"type": "av01", "data": s[0],
                                "props": props}}, 1))
    at = bad.index(b"iloc") + 8
    bad[at + 1] = 0x02                  # index_size 2
    files.append(bytes(bad))
    for data in files:
        assert _same_as_cv2(data) is None


@pytest.mark.parametrize("mode,frames", [("RGB", 2), ("RGB", 3),
                                         ("RGBA", 2)])
def test_sequences_without_a_primary_item(mode, frames):
    """Pillow's sequences, meta taken out: the colour track's first
    sample is read (an alpha track ignored), as cv2 reads it; the
    sequence itself (major brand avis) reads the same picture; with the
    avif brand still listed cv2 reads nothing."""
    seq = F.pil_sequence(frames, mode, seed=frames)
    whole = _same_as_cv2(seq)
    np.testing.assert_array_equal(_same_as_cv2(I.track_only(seq)), whole)
    assert _same_as_cv2(I.track_only(seq, (b"avis", b"avif"))) is None


@pytest.mark.parametrize("major", [b"avis", b"avif", b"mif1"])
def test_source_by_major_brand(major):
    """A sequence whose primary item is another picture than its first
    sample: libavif reads the track under the avis major brand or a brand
    naming neither, the item under avif; the port picks the same."""
    seq = F.pil_sequence(2, seed=16)
    still = F.pil_still(16)
    data = I.item_and_track(seq, avif.parse_avif(still)["av1"], major)
    got = _same_as_cv2(data)
    want = _cv2(still) if major == b"avif" else _cv2(seq)
    np.testing.assert_array_equal(got, want)


def test_track_is_pillows_first_frame():
    """The track-only fixture holds Pillow's first frame: Pillow reads the
    sequence to the same pixels as the port reads the track."""
    seq = F.pil_sequence(3, seed=14)
    pil = np.asarray(Image.open(io.BytesIO(seq)).convert("RGB"))
    np.testing.assert_array_equal(
        imagelib.decode_samples(FIXTURES / "track_only.avif"), pil)


@pytest.mark.parametrize("grid_first", [True, False])
def test_grid_image_grid_in_the_signature_window(grid_first):
    """A 1 x 2 grid of the encoder's 64 x 64 tiles, its ImageGrid in mdat
    before the tiles (inside cv2's 500-byte signature window) or after
    them (past it, its mdat starting inside): cv2 reads the first and
    nothing of the second, and so does the port (it once read both)."""
    tiles = [F.av1_stream(64, 64, 30 + k) for k in range(2)]
    grid_item = {"type": "grid", "data": struct.pack(">BBBBHH", 0, 0, 0, 1,
                                                     128, 64),
                 "props": [I.full_box(b"ispe", 0, struct.pack(">II", 128,
                                                               64))]}
    items = {}
    first = 1 if grid_first else 3
    items[first] = grid_item
    for k, (obus, seq, w, h) in enumerate(tiles):
        items[k + (2 if grid_first else 1)] = {
            "type": "av01", "data": obus, "props": I.av1_props(seq, w, h)}
    ids = [i for i in sorted(items) if i != first]
    data = I.heif(items, first, refs=[("dimg", first, ids)])
    got = _same_as_cv2(data)
    assert (got is None) == (not grid_first)
