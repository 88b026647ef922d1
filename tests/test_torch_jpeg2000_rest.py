"""The port's JPEG 2000 reader (ignis_tpu_torch/utils/jpeg2000.py and
utils/ebcot.py) on the Part 1 features beyond cv2's default .jp2,
against OpenCV (cv2 5.0.0 with OpenJPEG 2.5.3), through which ignis_tpu
reads .jp2 files.

The fixtures are OpenJPEG's own files (libopenjp2 2.5.4 driven through
ctypes by scripts/make_jp2_fixtures.py): every code-block style, SOP and
EPH, POC volumes over tiles and tile-parts, RGN, PPM and PPT, palettes
and sYCC in tests/data/images (each read to cv2_pixels.npz and to live
cv2 exactly, dtype included), and in tests/data/images_unread the files
cv2 reads nothing of (subsampled sYCC, e-sYCC, CMYK, a Part 2 component
transform, 17- and 4-bit components), for which the port raises
IOError as ignis_tpu does."""
from pathlib import Path

import cv2
import numpy as np
import pytest

from ignis_tpu.utils import image as jax_image
from ignis_tpu_torch.utils import ebcot, jpeg2000
from ignis_tpu_torch.utils import image as imagelib

FLAGS = cv2.IMREAD_UNCHANGED | cv2.IMREAD_ANYDEPTH | cv2.IMREAD_ANYCOLOR
DATA = Path(__file__).resolve().parent / "data"
FIXTURES = DATA / "images"
UNREAD = DATA / "images_unread"
OPJ = sorted(p.name for p in FIXTURES.glob("opj_*.jp2"))
# the JPEG 2000 files of images_unread (the others: test_torch_image_refusals)
UNREAD_FILES = sorted(p.name for p in UNREAD.iterdir()
                      if p.suffix in (".jp2", ".j2k", ".jph"))


def _cv2_rgb(data: bytes):
    img = cv2.imdecode(np.frombuffer(data, np.uint8), FLAGS)
    if img is None:
        return None
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, -1)
    return np.ascontiguousarray(img[..., 2::-1])


def test_openjpeg_fixture_sets():
    """OpenJPEG's fixtures: the 25 that cv2 reads (opj_poc_cut.jp2 among
    them, whose POC volumes leave two components' top resolutions out)
    and the 6 it reads nothing of, as scripts/make_jp2_fixtures.py writes
    them, beside the HT files cv2 reads nothing of
    (scripts/make_htj2k_fixtures.py)."""
    assert len(OPJ) == 25
    assert UNREAD_FILES == sorted([
        "opj_sycc420.jp2", "opj_esycc.jp2", "opj_cmyk.jp2",
        "opj_mct_part2.jp2", "opj_17bit.jp2", "opj_4bit.jp2",
        "ht_4passes.j2k", "ht_rgn.j2k", "ht_mixed.j2k", "ht_scup.j2k",
        "ht_layers_t814.j2k", "ht_empty_cleanup.j2k"])


@pytest.mark.parametrize("name", OPJ)
def test_openjpeg_fixture_matches_cv2(name):
    """Each of OpenJPEG's fixtures decodes to cv2_pixels.npz and to live
    cv2.imdecode of its bytes exactly, dtype and shape included."""
    data = (FIXTURES / name).read_bytes()
    want = np.load(FIXTURES / "cv2_pixels.npz")[name]
    got = imagelib.decode_samples(FIXTURES / name)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(_cv2_rgb(data), want)


@pytest.mark.parametrize("tail,lanes", [(0, 2048), (1 << 20, 2048),
                                        (0, 5)])
@pytest.mark.parametrize("name", [
    "opj_style01.jp2", "opj_style04.jp2", "opj_style3f.jp2",
    "opj_bypass_termall_53.jp2", "opj_bypass_termall_97.jp2",
    "opj_rgn_all.jp2", "opj_grey16_bypass_rgn.jp2"])
def test_lockstep_and_scalar_decodes_match_cv2(monkeypatch, name, tail,
                                                lanes):
    """The bypass, termination and RGN files with every code-block in
    the numpy lockstep (in one run, or in runs of 5 code-blocks), and
    with every code-block decoded in Python integers: each cv2's
    pixels."""
    monkeypatch.setattr(ebcot, "TAIL", tail)
    monkeypatch.setattr(jpeg2000, "LANES", lanes)
    want = np.load(FIXTURES / "cv2_pixels.npz")[name]
    np.testing.assert_array_equal(
        jpeg2000.decode_jpeg2000((FIXTURES / name).read_bytes()), want)


def test_raw_segments_are_decoded():
    """The bypass fixtures run raw (bypass) passes: a run of lanes of
    each of them reaches the raw decoder."""
    seen = []
    real = ebcot._MQDecoder.raw_lanes

    def spy(self, idx):
        seen.append(len(idx))
        return real(self, idx)
    ebcot._MQDecoder.raw_lanes = spy
    try:
        for name in ("opj_style01.jp2", "opj_bypass_termall_97.jp2",
                     "opj_texture_64.jp2"):
            seen.clear()
            jpeg2000.decode_jpeg2000((FIXTURES / name).read_bytes())
            assert sum(seen) > 0, name
    finally:
        ebcot._MQDecoder.raw_lanes = real


@pytest.mark.parametrize("name", ["opj_texture_64.jp2",
                                  "opj_palette16_index.jp2"])
def test_load_image_against_jax_reference(name):
    """The port's load_image of OpenJPEG's files against ignis_tpu's:
    ignis_tpu returns a .jp2's raw integers as they are (the reference
    fault that test_unscaled_8bit_jp2_of_jax_reference pins), the port
    scales them to [0, 1] and sRGB-decodes unless `linear`."""
    p = FIXTURES / name
    raw = jax_image.load_image(str(p))
    top = np.float32(np.iinfo(imagelib.decode_samples(p).dtype).max)
    np.testing.assert_allclose(imagelib.load_image(p, linear=True) * top,
                               raw, rtol=1e-6)
    np.testing.assert_allclose(imagelib.load_image(p),
                               imagelib.srgb_to_linear(raw / top),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name", UNREAD_FILES)
def test_files_cv2_reads_nothing_of_raise_ioerror(tmp_path, name):
    """Each file cv2 reads nothing of (subsampled, e-sYCC, CMYK, Part 2
    MCT, 17 and 4 bits): the port raises IOError("Cannot load image ..."),
    as ignis_tpu's load_image raises for cv2.imread's None."""
    data = (UNREAD / name).read_bytes()
    assert _cv2_rgb(data) is None
    with pytest.raises(IOError, match="Cannot load image"):
        jpeg2000.decode_jpeg2000(data, name)
    with pytest.raises(IOError, match="Cannot load image"):
        imagelib.load_image(UNREAD / name)
    with pytest.raises(IOError):
        jax_image.load_image(str(UNREAD / name))


def test_only_htj2k_is_refused_by_name():
    """HTJ2K, once the last refusal by name in jpeg2000.py, is read since
    utils/htj2k.py (tests/test_torch_htj2k.py): jpeg2000.py raises no
    NotImplementedError, and what cv2 reads nothing of raises IOError."""
    src = (Path(jpeg2000.__file__)).read_text()
    assert "NotImplementedError" not in src
    assert not hasattr(jpeg2000, "_refuse")
    assert "IOError" in src


# ---------------------------------------------------------------------------
# the parts: segments, the raw decoder, POC order, palettes, colour
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("style,want", [
    (0, [109] * 4), (0x01, [10, 2, 1, 2, 1, 2]), (0x04, [1] * 6),
    (0x05, [1] * 6), (0x3F, [1] * 6)])
def test_codeword_segment_sizes(style, want):
    """Passes a codeword segment holds, as OpenJPEG's opj_t2_init_seg
    gives them: all under style 0, 10 then 2 and 1 in turn under bypass,
    one under termination on each pass (with or without bypass)."""
    got, prev = [], None
    for _ in want:
        prev = jpeg2000._max_passes(style, prev)
        got.append(prev)
    assert got == want


def test_raw_decoder_bit_stuffing():
    """The raw decoder reads bits MSB first, 7 bits of the byte after
    0xFF, and 1 bits at the 0xFF 0xFF that ends a segment; the scalar
    decoder reads the same bits."""
    seg = bytes([0xA5, 0xFF, 0x35, 0x0F])
    want = ([1, 0, 1, 0, 0, 1, 0, 1] + [1] * 8 + [0, 1, 1, 0, 1, 0, 1]
            + [0, 0, 0, 0, 1, 1, 1, 1] + [1] * 20)
    mq = ebcot._MQDecoder([[seg], [seg]])
    mq.start(np.arange(2), np.array(mq.offsets)[:, 0], np.ones(2, bool))
    lanes = mq.raw_lanes(np.arange(2))
    got = [int(lanes.code(0, np.array([True, False]))[0])
           for _ in range(len(want))]
    assert got == want
    sc = lanes.scalar(1)
    assert [sc.code(0) for _ in range(len(want))] == want


def test_poc_volumes_order_packets():
    """POC volumes: one volume over everything gives the plain order;
    volumes split by resolution and component give each packet once, in
    volume order, the packets of a later volume that an earlier one gave
    skipped."""
    cod = jpeg2000._Coding(bytes([2, 0, 0, 0, 1]), 0, 0, "x")
    comps = [jpeg2000._tile_component(0, 0, 20, 12, cod) for _ in range(3)]
    plain = jpeg2000._packet_order(0, 2, comps, 0, 0)
    assert jpeg2000._packet_order(0, 2, comps, 0, 0,
                                  [(0, 0, 2, 3, 3, 1)]) == \
        jpeg2000._packet_order(1, 2, comps, 0, 0)
    vols = [(0, 0, 2, 1, 3, 4), (1, 0, 2, 3, 2, 0), (0, 0, 5, 9, 3, 2)]
    got = jpeg2000._packet_order(0, 2, comps, 0, 0, vols)
    assert sorted(got) == sorted(plain) and len(set(got)) == len(got)
    assert [p[1] for p in got[:6]] == [0] * 6
    assert all(p[2] == 2 for p in got[-4:])


def test_palette_mapping_as_openjpeg():
    """pclr and cmap as OpenJPEG applies them: the index clamped to the
    entries, a direct channel passed as it is."""
    entries = np.array([[10, 20, 30], [40, 50, 60]])
    idx = np.array([[-3, 0], [1, 7]])
    out = jpeg2000._apply_palette([idx], (entries, [(0, 1, 0), (0, 1, 1),
                                                    (0, 1, 2)]), "x")
    np.testing.assert_array_equal(np.stack(out, -1), entries[[[0, 0], [1, 1]]])
    out = jpeg2000._apply_palette([idx, idx + 1], (entries[:, :2], [
        (0, 1, 0), (1, 0, 0)]), "x")
    np.testing.assert_array_equal(out[1], idx + 1)
    with pytest.raises(IOError, match="cmap"):
        jpeg2000._apply_palette([idx], (entries, [(3, 1, 0)]), "x")


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_colour_conversions_equal_opencv(dtype):
    """The grey of a palette's colours and sYCC's RGB in integers equal
    cv2.cvtColor's BGR2GRAY and YUV2BGR on random 8- and 16-bit
    samples."""
    top = int(np.iinfo(dtype).max)
    v = np.random.default_rng(top).integers(0, top + 1, (64, 64, 3)
                                            ).astype(dtype)
    ch = [v[..., i].astype(np.int64) for i in range(3)]
    grey = cv2.cvtColor(np.ascontiguousarray(v[..., ::-1]),
                        cv2.COLOR_BGR2GRAY)
    np.testing.assert_array_equal(jpeg2000._grey(*ch), grey)
    rgb = cv2.cvtColor(v, cv2.COLOR_YUV2BGR)[..., ::-1]
    np.testing.assert_array_equal(np.stack(jpeg2000._yuv_to_rgb(*ch, top),
                                           -1), rgb)


def test_jp2_texture_step_and_refusals_on_cpu(tmp_path):
    """Phase 16's JPEG 2000 parts on the CPU: OpenJPEG's 64 x 64 texture
    (bypass, termination, SOP / EPH, POC, PPT) through load_image into a
    scene whose film is bit-equal to that of its PNG twin
    (chip_smoke.jp2_texture_step, a captured step on the card), and each
    file cv2 reads nothing of refused with IOError
    (chip_smoke.unread_refusals)."""
    import torch

    import chip_smoke
    out = chip_smoke.jp2_texture_step(torch.device("cpu"), tmp_path, 16)
    assert out["bit_equal"] and out["finite"] and out["film_mean"] > 0
    assert out["shape"] == [64, 64, 3] and out["device"] == "cpu"
    refused = chip_smoke.unread_refusals()
    assert sorted(k for k in refused if k in UNREAD_FILES) == UNREAD_FILES
    assert all(refused[k].startswith("Cannot load image")
               for k in UNREAD_FILES)
    assert all(v != "read" for v in refused.values())
