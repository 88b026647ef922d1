"""The port's AVIF reader (ignis_tpu_torch/utils/avif.py, av1.py,
av1_recon.py, av1_filters.py, av1_mv.py, av1_grain.py, yuv.py) against
OpenCV, through which ignis_tpu reads .avif files (cv2 5.0.0 with
libavif 1.4.2 and libaom 3.14.1).

Every AVIF fixture (tests/data/images, written by
scripts/make_image_fixtures.py) and a set of cv2 and Pillow (12.1, libavif
1.3.0 with libaom 3.12.1) variants over quality, speed, bit depth,
subsampling, range, tiles, alpha, animation and libaom's switches are read
by the port and by cv2.imdecode on the same bytes and must agree exactly,
sample for sample, in dtype and shape. load_image scales by the file's bit
depth; ignis_tpu's unscaled AVIF samples are pinned by strict xfails. The
arithmetic decoder is held to a small encoder's round trip, the lossless
Walsh-Hadamard transform to its forward transform's."""
import io
import json
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest
from PIL import Image

from ignis_tpu.utils import image as jax_image
from ignis_tpu_torch.utils import av1, av1_recon, avif, yuv
from ignis_tpu_torch.utils import image as imagelib

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))
from make_image_fixtures import with_nclx  # noqa: E402

FLAGS = cv2.IMREAD_UNCHANGED | cv2.IMREAD_ANYDEPTH | cv2.IMREAD_ANYCOLOR
FIXTURES = Path(__file__).resolve().parent / "data" / "images"
AVIF_FIXTURES = sorted(p.name for p in FIXTURES.glob("*.avif"))

# the tool each fixture was made to switch on
MADE_FOR = {
    "cv2_default.avif": "qm", "cv2_q0_speed10.avif": "cdef",
    "cv2_q50_speed0.avif": "filter_intra", "cv2_lossless.avif": "lossless",
    "cv2_grey.avif": "4:0:0", "cv2_10bit.avif": "10-bit",
    "cv2_12bit.avif": "12-bit", "cv2_grey_10bit.avif": "10-bit",
    "cv2_screen.avif": "deblock", "pil_420_limited.avif": "limited range",
    "pil_422.avif": "4:2:2", "pil_444_speed0.avif": "4:4:4",
    "pil_400.avif": "4:0:0", "pil_tiles.avif": "tiles",
    "pil_rgba.avif": "alpha", "pil_animated.avif": "avis",
    "pil_exif_rotated.avif": "4:2:0", "pil_palette.avif": "palette",
    "pil_intrabc.avif": "intrabc", "pil_filter_intra.avif": "filter_intra",
    "pil_cfl.avif": "cfl", "pil_restoration.avif": "lr_sgrproj",
    "pil_qm.avif": "qm", "pil_deltaq.avif": "delta_q",
    "pil_delta_lf.avif": "delta_lf", "pil_chroma_deltaq.avif": "uv_delta_q",
    "pil_tx64.avif": "tx64", "pil_sharpness.avif": "sharpness",
    "pil_sb128.avif": "sb128", "pil_film_grain.avif": "film_grain",
    # cv2's and Pillow's files under other colour matrices (their colr box
    # rewritten): the AV1 stream is the source file's
    **{f"cv2_default_mc{m}.avif": "4:2:0" for m in (1, 2, 4, 7, 8, 9, 12,
                                                     15)},
    **{f"cv2_10bit_mc{m}.avif": "10-bit" for m in (1, 4, 7, 8, 9, 12, 15)},
    "cv2_10bit_mc12_cp9.avif": "10-bit", "pil_444_mc8.avif": "4:4:4",
    "pil_444_mc12_cp9.avif": "4:4:4",
    # grid primary items of cv2's 64 x 64 tiles (make_image_fixtures'
    # avif_grid)
    "grid_2x1.avif": "grid", "grid_2x2_crop.avif": "grid",
    # the port's own encoder's superres and show_existing_frame streams,
    # and HEIF layouts around them and Pillow's sequences
    # (scripts/make_named_fixtures.py)
    **{n: "superres" for n in (
        "sr_d9_odd.avif", "sr_d12_444.avif", "sr_d16_10bit.avif",
        "sr_two_tiles.avif", "sr_lr_wiener.avif", "sr_lr_sgrproj.avif",
        "sr_lr_switchable.avif", "sr_grain.avif", "sr_texture_64.avif")},
    "av1_show_existing.avif": "show_existing_frame",
    "av1_show_existing_grain.avif": "show_existing_frame",
    "gain_map_base.avif": "gain_map", "gain_map_brand.avif": "gain_map",
    "track_only.avif": "avis", "track_only_alpha.avif": "avis",
    "item_and_track.avif": "avis"}


def _cv2_rgb(data: bytes):
    """cv2.imdecode of data as [h, w, 3] RGB (grey replicated, alpha
    dropped), or None where cv2 reads nothing."""
    img = cv2.imdecode(np.frombuffer(data, np.uint8), FLAGS)
    if img is None:
        return None
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, -1)
    return np.ascontiguousarray(img[..., 2::-1])


def _photo(h, w, seed=0, noise=10.0):
    """uint8 [h, w, 3]: colour waves with noise and a flat bright patch."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([127 + 110 * np.sin(xx / (5.0 + c) + c)
                    * np.cos(yy / 7.0 - c) for c in range(3)], -1)
    img = img + rng.normal(0, noise, img.shape)
    img[h // 4:h // 2, w // 4:w // 2] = 240
    return np.clip(img, 0, 255).astype(np.uint8)


def _screen(h, w, seed=3):
    """Dark glyphs from twelve random 8 x 6 masks on white."""
    rng = np.random.default_rng(seed)
    glyphs = [rng.random((8, 6)) < 0.4 for _ in range(12)]
    img = np.full((h, w, 3), 255, np.uint8)
    for y in range(2, h - 9, 10):
        for x in range(2, w - 7, 7):
            img[y:y + 8, x:x + 6][glyphs[rng.integers(0, 12)]] = 20
    return img


def _cv2_file(q=95, speed=6, depth=8, grey=False, h=27, w=35):
    img = _photo(h, w, seed=q + 7 * speed + depth)
    if depth > 8:
        img = (img.astype(np.uint16) << (depth - 8)) | \
            (img.astype(np.uint16) >> (16 - depth))
    src = img[..., 0] if grey else np.ascontiguousarray(img[..., ::-1])
    ok, buf = cv2.imencode(".avif", src, [
        cv2.IMWRITE_AVIF_QUALITY, q, cv2.IMWRITE_AVIF_SPEED, speed,
        cv2.IMWRITE_AVIF_DEPTH, depth])
    assert ok
    return buf.tobytes()


def _pil_file(img=None, mode="RGB", **kw):
    img = _photo(26, 33, seed=5) if img is None else img
    bio = io.BytesIO()
    if kw.pop("frames", 1) > 1:
        Image.fromarray(img, mode).save(
            bio, "AVIF", save_all=True, duration=100,
            append_images=[Image.fromarray(np.roll(img, k, 1), mode)
                           for k in (3, 7)], **kw)
    else:
        Image.fromarray(img, mode).save(bio, "AVIF", **kw)
    return bio.getvalue()


def _adv(*pairs, screen=False, **kw):
    img = _screen(64, 96) if screen else None
    return lambda: _pil_file(img, advanced=list(pairs), **kw)


VARIANTS = {
    **{f"cv2_q{q}": (lambda q=q: _cv2_file(q=q)) for q in
       (0, 25, 60, 95, 100)},
    **{f"cv2_speed{s}": (lambda s=s: _cv2_file(q=60, speed=s)) for s in
       (0, 3, 10)},
    **{f"cv2_{d}bit_q{q}": (lambda d=d, q=q: _cv2_file(q=q, depth=d))
       for d in (10, 12) for q in (30, 90, 100)},
    **{f"cv2_grey_{d}bit_q{q}": (
        lambda d=d, q=q: _cv2_file(q=q, depth=d, grey=True))
       for d, q in ((8, 20), (8, 95), (8, 100), (10, 60), (12, 60))},
    **{f"pil_{ss.replace(':', '')}_{rng}": (
        lambda ss=ss, rng=rng: _pil_file(quality=50, speed=6,
                                         subsampling=ss, range=rng))
       for ss in ("4:2:0", "4:2:2", "4:4:4", "4:0:0")
       for rng in ("full", "limited")},
    "pil_speed0": lambda: _pil_file(quality=40, speed=0),
    "pil_speed10": lambda: _pil_file(quality=40, speed=10),
    "pil_tiles": lambda: _pil_file(_photo(72, 136, 9), quality=20, speed=8,
                                   tile_rows=1, tile_cols=1),
    "pil_rgba": lambda: _pil_file(np.dstack([_photo(20, 23, 1),
                                             _photo(20, 23, 2)[..., 0]]),
                                  "RGBA", quality=60),
    "pil_animated": lambda: _pil_file(quality=60, frames=3),
    "pil_palette": _adv(("tune-content", "screen"), ("enable-palette", "1"),
                        screen=True, quality=70, speed=3),
    "pil_intrabc": _adv(("tune-content", "screen"), ("enable-intrabc", "1"),
                        screen=True, quality=70, speed=6),
    "pil_filter_intra": _adv(("enable-filter-intra", "1"), quality=30,
                             speed=3),
    "pil_cfl": _adv(("enable-cfl-intra", "1"), quality=50, speed=6),
    "pil_restoration": lambda: _pil_file(
        _photo(48, 56, 4, 4.0), quality=80, speed=2,
        advanced=[("enable-restoration", "1")]),
    "pil_qm": _adv(("enable-qm", "1"), quality=50, speed=6),
    "pil_deltaq": _adv(("deltaq-mode", "2"), quality=30, speed=6),
    "pil_chroma_deltaq": _adv(("enable-chroma-deltaq", "1"), quality=50),
    "pil_tx64": lambda: _pil_file(_photo(72, 72, 8, 0.0), quality=20,
                                  speed=4, advanced=[("enable-tx64", "1")]),
    "pil_sharpness": _adv(("sharpness", "7"), quality=40, speed=6),
    "pil_no_cdf_update": _adv(("cdf-update-mode", "0"), quality=40,
                              speed=6),
    "pil_sb128": lambda: _pil_file(_photo(40, 72, 6), quality=30, speed=6,
                                   advanced=[("sb-size", "128")]),
    **{f"pil_film_grain_{t}": _adv(("film-grain-test", str(t)), quality=60,
                                   speed=6) for t in (1, 6, 10, 16)},
}


@pytest.mark.parametrize("name", AVIF_FIXTURES)
def test_fixture_matches_cv2(name):
    """Each AVIF fixture reads to exactly the pixels cv2 gives (the npz,
    written by cv2.imread), dtype and shape included; 10- and 12-bit files
    as uint16 at their own range."""
    want = np.load(FIXTURES / "cv2_pixels.npz")[name]
    got = imagelib.decode_samples(FIXTURES / name)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert want.max() <= {np.dtype(np.uint8): 255}.get(
        want.dtype, 1023 if "10bit" in name else 4095)


@pytest.mark.parametrize("name", AVIF_FIXTURES)
def test_fixture_switches_on_its_tool(name):
    """The tool each fixture was made for is on in its own headers and
    blocks, and avif_tools.json (the PERF.md table's source) lists what
    coding_tools reads."""
    data = (FIXTURES / name).read_bytes()
    tools = avif.coding_tools(data)
    assert MADE_FOR[name] in tools, tools
    table = json.loads((FIXTURES.parent / "avif_tools.json").read_text())
    assert table[name] == tools


@pytest.mark.parametrize("case", sorted(VARIANTS))
def test_variant_matches_cv2(case):
    """cv2's and Pillow's files over quality, speed, depth, subsampling,
    range, tiles, alpha, animation and libaom's switches read to exactly
    cv2.imdecode's pixels."""
    data = VARIANTS[case]()
    want = _cv2_rgb(data)
    got = avif.decode_avif(data, case)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name,depth", [
    ("cv2_default.avif", 8), ("cv2_grey.avif", 8), ("cv2_10bit.avif", 10),
    ("cv2_12bit.avif", 12), ("cv2_grey_10bit.avif", 10)])
def test_load_image_scales_by_bit_depth(name, depth):
    """load_image and read_ldr divide by 2^depth - 1 (255, 1023, 4095),
    not by the dtype's range, and sRGB-decode unless `linear`."""
    px = np.load(FIXTURES / "cv2_pixels.npz")[name]
    want = px.astype(np.float32) / np.float32((1 << depth) - 1)
    lin = imagelib.load_image(FIXTURES / name, linear=True)
    np.testing.assert_array_equal(lin, want)
    np.testing.assert_array_equal(imagelib.read_ldr(FIXTURES / name), want)
    np.testing.assert_allclose(imagelib.load_image(FIXTURES / name),
                               imagelib.srgb_to_linear(want), rtol=1e-6)
    assert lin.max() <= 1.0 and lin.max() > 0.5


def _both_readers(path):
    return [(imagelib.load_image(path, linear=lin),
             jax_image.load_image(str(path), linear=lin))
            for lin in (False, True)]


@pytest.mark.xfail(strict=True, reason="ignis_tpu's load_image returns an "
                   "AVIF's raw 0-255 integers as linear radiance (it scales "
                   "only .png, .jpg, .jpeg, .bmp and .tga; a reference "
                   "fault the port fixes, ROADMAP queue 3)")
def test_unscaled_8bit_avif_of_jax_reference():
    """The port's load_image of cv2's default AVIF against ignis_tpu's:
    they differ by the reference's missing 1/255 (and sRGB decode)."""
    for got, want in _both_readers(FIXTURES / "cv2_default.avif"):
        np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.xfail(strict=True, reason="ignis_tpu's load_image returns a "
                   "10-bit AVIF's raw 0-1023 integers as linear radiance (a "
                   "reference fault the port fixes, ROADMAP queue 3)")
def test_unscaled_10bit_avif_of_jax_reference():
    """The port's load_image of cv2's 10-bit AVIF against ignis_tpu's:
    they differ by the reference's missing 1/1023 (and sRGB decode)."""
    for got, want in _both_readers(FIXTURES / "cv2_10bit.avif"):
        np.testing.assert_allclose(got, want, rtol=1e-6)


def _grey_alpha():
    img = np.dstack([_photo(20, 23, 1), _photo(20, 23, 2)[..., 0]])
    return _pil_file(img, "RGBA", subsampling="4:0:0")


@pytest.mark.parametrize("case", ["truncated_item", "ftyp_only",
                                  "no_meta_item", "grey_with_alpha",
                                  "truncated_tile"])
def test_unreadable_files_raise_ioerror(tmp_path, case):
    """Where cv2 reads nothing the port raises IOError, as ignis_tpu
    raises for cv2.imread's None: a file cut inside its item data, a bare
    ftyp box, a primary item that is not there, a grey image with an
    alpha item (cv2 refuses two channels) and a tile cut short."""
    good = (FIXTURES / "cv2_default.avif").read_bytes()
    data = {"truncated_item": lambda: good[:len(good) - 60],
            "ftyp_only": lambda: good[:32],
            "no_meta_item": lambda: good[:32] + bytes(8),
            "grey_with_alpha": _grey_alpha,
            "truncated_tile": lambda: _short_tile(good)}[case]()
    assert _cv2_rgb(data) is None
    p = tmp_path / "x.avif"
    p.write_bytes(data)
    with pytest.raises(IOError):
        imagelib.load_image(p)


def _short_tile(good):
    """cv2_default.avif with its AV1 frame OBU claiming 5 bytes more than
    the item holds (its size field rewritten in as many bytes)."""
    av = avif.parse_avif(good)["av1"]
    start = good.index(av)
    pos = 0
    while True:                            # to the frame OBU
        size, body = av1.leb128(av, pos + 1)
        if (av[pos] >> 3) & 15 == 6:
            break
        pos = body + size
    n, new = body - pos - 1, size + 5
    field = [((new >> (7 * i)) & 0x7f) | (0x80 if i < n - 1 else 0)
             for i in range(n)]
    bad = bytearray(good)
    bad[start + pos + 1:start + body] = bytes(field)
    return bytes(bad)


class _Bits:
    def __init__(self):
        self.bits = []

    def put(self, v, n):
        self.bits += [(v >> (n - 1 - i)) & 1 for i in range(n)]

    def bytes(self):
        bits = self.bits + [1] + [0] * (-(len(self.bits) + 1) % 8)
        return bytes(int("".join(map(str, bits[i:i + 8])), 2)
                     for i in range(0, len(bits), 8))


def _obu(kind, payload):
    return bytes([(kind << 3) | 2, len(payload)]) + payload


def _sequence_header(superres=0):
    b = _Bits()
    b.put(0, 3)                    # seq_profile
    b.put(1, 1)                    # still_picture
    b.put(0, 1)                    # reduced_still_picture_header
    b.put(0, 1)                    # timing_info_present_flag
    b.put(0, 1)                    # initial_display_delay_present_flag
    b.put(0, 5)                    # operating_points_cnt_minus_1
    b.put(0, 12)                   # operating_point_idc[0]
    b.put(0, 5)                    # seq_level_idx[0]
    b.put(5, 4)
    b.put(5, 4)                    # frame width/height bits - 1
    b.put(15, 6)
    b.put(15, 6)                   # 16 x 16
    b.put(0, 1)                    # frame_id_numbers_present_flag
    b.put(0, 3)                    # 64x64 sb, no filter intra or edge filter
    b.put(0, 5)                    # interintra .. enable_order_hint
    b.put(0, 1)                    # seq_choose_screen_content_tools
    b.put(0, 1)                    # seq_force_screen_content_tools
    b.put(superres, 1)
    b.put(0, 2)                    # cdef, restoration
    b.put(0, 1)                    # high_bitdepth
    b.put(0, 1)                    # mono_chrome
    b.put(0, 1)                    # color_description_present_flag
    b.put(1, 1)                    # color_range
    b.put(0, 2)                    # chroma_sample_position
    b.put(0, 1)                    # separate_uv_delta_q
    b.put(0, 1)                    # film_grain_params_present
    return _obu(1, b.bytes())


def _frame_header(show_existing=0, frame_type=0, superres=0):
    b = _Bits()
    b.put(show_existing, 1)
    if not show_existing:
        b.put(frame_type, 2)
        b.put(1, 1)                # show_frame
        if frame_type:
            b.put(0, 1)            # error_resilient_mode
        b.put(0, 1)                # disable_cdf_update
        b.put(0, 1)                # frame_size_override_flag
        b.put(superres, 1)         # use_superres
    return _obu(3, b.bytes())


@pytest.mark.parametrize("tool,data", [
    ("superres", lambda: _sequence_header(1) + _frame_header(superres=1)),
    ("large-scale tile", lambda: _sequence_header() + _obu(8, b"\0\0")),
    ("inter frame", lambda: _sequence_header() + _frame_header(
        frame_type=1)),
    ("show_existing_frame", lambda: _sequence_header() + _frame_header(
        show_existing=1))])
def test_unported_tools_refused_by_name(tool, data):
    """AV1 tools once refused by name, in streams of headers alone. Since
    superres and show_existing_frame are read (tests/
    test_torch_avif_superres.py), and a tile list OBU and an inter frame
    with nothing before it to refer to raise IOError, each of these
    streams raises IOError naming the file, as cv2 reads nothing of it;
    an inter frame after a key frame, which cv2 reads, is the one tool
    still refused by name (test_inter_frame_after_a_key_frame_refused)."""
    item = data()
    wrapped = avif.heif_image(item, item[:2 + item[1]], 16, 16)
    assert _cv2_rgb(wrapped) is None
    with pytest.raises(IOError, match="x.avif"):
        av1.decode_av1(item, "x.avif")


def _with_matrix(mc):
    data = bytearray((FIXTURES / "cv2_default.avif").read_bytes())
    at = data.index(b"nclx") + 8
    data[at:at + 2] = mc.to_bytes(2, "big")
    return bytes(data)


def _without_meta():
    data = bytearray((FIXTURES / "pil_animated.avif").read_bytes())
    at = data.index(b"meta")
    data[at:at + 4] = b"free"
    return bytes(data)


@pytest.mark.parametrize("what,data", [
    ("colour matrix", lambda: _with_matrix(1)),
    ("image sequence without a primary item", _without_meta),
    ("grid", lambda: (FIXTURES / "grid_2x1.avif").read_bytes())])
def test_unported_container_features_refused_by_name(what, data):
    """Container features once refused by name, each read now as cv2
    reads it: a colour matrix other than BT.601 or the identity (here
    BT.709; test_colour_matrix_matches_cv2), a grid primary item
    (tests/test_torch_avif_grid.py), and an `avis` file whose meta is
    made a `free` box: its ftyp still lists the `avif` brand, which
    libavif reads only with a primary item, so cv2 reads nothing and the
    port raises IOError (sequences without a primary item under the
    other brands: tests/test_torch_avif_items.py)."""
    want = _cv2_rgb(data())
    if want is None:
        with pytest.raises(IOError):
            avif.decode_avif(data(), "x.avif")
        return
    np.testing.assert_array_equal(avif.decode_avif(data(), "x.avif"), want)


def test_save_avif_still_refused(tmp_path):
    """save_image refused '.avif' until the port had a writer; it now
    writes it as cv2 does (tests/test_torch_avif_writer.py): an 8 x 8
    image reads back through cv2 and the port to the same pixels, and
    load_image gives them scaled and sRGB-decoded."""
    img = np.linspace(0, 1, 8 * 8 * 3, dtype=np.float32).reshape(8, 8, 3)
    path = tmp_path / "x.avif"
    imagelib.save_image(path, img)
    data = path.read_bytes()
    assert data[4:12] == b"ftypavif"
    port = avif.decode_avif(data)
    np.testing.assert_array_equal(_cv2_rgb(data), port)
    np.testing.assert_allclose(
        imagelib.load_image(path),
        imagelib.srgb_to_linear(port / np.float32(255.0)), rtol=1e-6)


def _adapt(cdf, s):
    n = len(cdf) - 1
    cnt = cdf[n]
    rate = 3 + (cnt > 15) + (cnt > 31) + min((n).bit_length() - 1, 2)
    for i in range(n - 1):
        if i < s:
            cdf[i] -= cdf[i] >> rate
        else:
            cdf[i] += (32768 - cdf[i]) >> rate
    cdf[n] = min(cnt + 1, 32)


def _encode(pairs, update):
    """A range encoder for the decoder's intervals: (symbol, cdf) pairs to
    bytes. The value is the interval's low end, so the stream is its
    complement (the decoder reads inverted bits)."""
    low, rng, shifts = 0, 1 << 15, 0
    for s, cdf in pairs:
        n = len(cdf) - 1
        cur = rng
        for k in range(s + 1):
            prev = cur
            cur = (((rng >> 8) * ((32768 - cdf[k]) >> 6)) >> 1) + \
                4 * (n - k - 1)
        low += cur
        rng = prev - cur
        d = 16 - rng.bit_length()
        rng <<= d
        low <<= d
        shifts += d
        if update:
            _adapt(cdf, s)
    nbits = 15 + shifts
    nbytes = (nbits + 7) // 8
    bits = (~low) & ((1 << nbits) - 1)
    return (bits << (8 * nbytes - nbits)).to_bytes(nbytes, "big")


@pytest.mark.parametrize("update", [True, False])
def test_symbol_decoder_round_trip(update):
    """Symbols of random 2- to 16-symbol CDFs (skewed and uniform), with
    CDF adaptation and its counter on or off, and literal bits, decode as
    a small encoder coded them."""
    rng = np.random.default_rng(int(update))
    tables = []
    for _ in range(12):
        n = int(rng.integers(2, 17))
        cuts = np.sort(rng.choice(np.arange(1, 32768), n - 1, replace=False))
        tables.append(cuts.tolist() + [32768, 0])
    seq = []
    for _ in range(3000):
        t = int(rng.integers(0, len(tables) + 1))
        if t == len(tables):
            seq.append((int(rng.integers(0, 2)), None))
        else:
            n = len(tables[t]) - 1
            s = int(min(rng.geometric(0.4) - 1, n - 1)) if rng.random() < \
                0.7 else int(rng.integers(0, n))
            seq.append((s, t))
    enc_tables = [list(t) for t in tables]
    pairs = [(s, [16384, 32768, 0] if t is None else enc_tables[t])
             for s, t in seq]
    data = _encode(pairs, update)
    sd = av1.SymbolDecoder(data, 0, len(data), not update)
    dec_tables = [list(t) for t in tables]
    got = [sd.bool() if t is None else sd.symbol(dec_tables[t])
           for _, t in seq]
    assert got == [s for s, _ in seq]
    assert dec_tables == enc_tables


def _fwht(x):
    """libaom's forward Walsh-Hadamard (av1_fwht4x4): columns, then rows
    scaled by 4; int [B, 4, 4]."""
    def one(a, b, c, d):
        a = a + b
        d = d - c
        e = (a - d) >> 1
        b = e - b
        c = e - c
        a = a - c
        d = d + b
        return a, c, d, b
    cols = one(*(x[:, i, :] for i in range(4)))
    t = np.stack(cols, 1)
    rows = one(*(t[:, :, j] for j in range(4)))
    return np.stack(rows, 2) * 4


def test_lossless_wht_round_trip():
    """The inverse WHT of the lossless path undoes the forward one exactly
    on residuals of 8-, 10- and 12-bit range, and the lossless fixtures
    (coded with it) read to cv2's pixels."""
    rng = np.random.default_rng(4)
    for bd in (8, 10, 12):
        x = rng.integers(-(1 << bd) + 1, 1 << bd, (64, 4, 4)).astype(
            np.int64)
        back = av1_recon.inverse_transform(_fwht(x), 0, 0, True, bd)
        np.testing.assert_array_equal(back, x)
    data = (FIXTURES / "cv2_lossless.avif").read_bytes()
    assert "lossless" in avif.coding_tools(data)
    np.testing.assert_array_equal(avif.decode_avif(data), _cv2_rgb(data))


def test_tables_hold_the_specifications_values():
    """Spot checks of av1_tables (taken from libaom) against values the
    AV1 specification prints: default CDFs, quantiser lookups, filter
    taps and the self-guided parameters."""
    from ignis_tpu_torch.utils import av1_tables as T
    assert T.PARTITION[0] == [19132, 25510, 30392]
    assert T.KF_Y_MODE[0][0][:3] == [15588, 17027, 19338]
    assert T.SKIP == [[31671], [16515], [4576]]
    assert T.DC_Q[0][:4] == [4, 8, 8, 9] and T.DC_Q[0][-1] == 1336
    assert T.AC_Q[2][-1] == 29247
    assert T.SM_WEIGHTS[4] == [255, 149, 85, 64]
    assert T.FILTER_INTRA_TAPS[0][0] == [-6, 10, 0, 0, 0, 12, 0]
    assert T.SGR_PARAMS[0] == [2, 140, 1, 3236]
    assert T.COSPI[32] == 2896 and T.SINPI == [0, 1321, 2482, 3344, 3803]
    qm = T.quantizer_matrix()
    assert qm.shape == (15, 2, 3344) and qm[0, 0, :4].tolist() == \
        [32, 43, 73, 97]


# ---- colour matrices -------------------------------------------------------
# files of each kind whose colr box the matrix tests rewrite: 8-bit 4:2:0,
# 10- and 12-bit 4:2:0, 8-bit 4:4:4 and 4:2:2, 8-bit limited range, the
# identity's lossless 4:4:4, a noisy 8-bit file, and grey
MATRIX_FILES = ["cv2_default.avif", "cv2_10bit.avif", "cv2_12bit.avif",
                "pil_444_speed0.avif", "pil_422.avif",
                "pil_420_limited.avif", "cv2_lossless.avif",
                "cv2_q50_speed0.avif", "pil_400.avif"]
# the primaries MC 12 (chroma-derived) is tried under: libyuv's three,
# libavif's other tables, and ones it has no table for (BT.709's)
PRIMARIES = (1, 2, 4, 5, 6, 7, 8, 9, 10, 11, 12, 22, 0, 3)
_FRAMES = {}


def _frame(name):
    """The decoded AV1 frame of a fixture (decoded once)."""
    if name not in _FRAMES:
        data = (FIXTURES / name).read_bytes()
        _FRAMES[name] = av1.decode_av1(avif.parse_avif(data)["av1"])
    return _FRAMES[name]


@pytest.mark.parametrize("matrix", range(18))
@pytest.mark.parametrize("name", MATRIX_FILES)
def test_colour_matrix_matches_cv2(name, matrix):
    """Each file under matrix_coefficients 0-17, in full and limited
    range (and MC 12 under each primaries): the port's conversion equals
    cv2.imdecode of the same bytes sample for sample, dtype included
    (libyuv's fixed point for 8-bit BT.709, BT.601 and BT.2020, libavif's
    float path for FCC, SMPTE 240, YCgCo, the identity, chroma-derived
    constants of other primaries, matrices without a table, and 10 and
    12 bits); where cv2 reads nothing (MC 3, 10, 11, 13, 14, 16, 17, the
    identity with subsampled chroma, YCgCo in limited range) the port
    raises IOError. Grey files read under any matrix, as cv2 reads
    them."""
    good = (FIXTURES / name).read_bytes()
    frame = _frame(name)
    for full in (0, 1):
        for cp in PRIMARIES if matrix == 12 else (1,):
            data = bytearray(with_nclx(good, matrix, cp))
            at = data.index(b"colrnclx") + 14
            data[at] = (full << 7) | (data[at] & 0x7F)
            want = _cv2_rgb(bytes(data))
            if frame.mono:
                got = avif.decode_avif(bytes(data))
            elif want is None:
                with pytest.raises(IOError):
                    yuv.yuv_to_rgb(frame.planes, frame.bit_depth,
                                   frame.ss_x, frame.ss_y, matrix, full, cp)
                continue
            else:
                got = yuv.yuv_to_rgb(frame.planes, frame.bit_depth,
                                     frame.ss_x, frame.ss_y, matrix, full,
                                     cp)
            assert got.dtype == want.dtype, (full, cp)
            np.testing.assert_array_equal(got, want, err_msg=f"{full} {cp}")


@pytest.mark.parametrize("matrix", [0, 3, 10, 11, 13, 14])
def test_matrices_cv2_refuses_raise_ioerror_in_both(tmp_path, matrix):
    """cv2_default.avif (4:2:0) under a matrix libavif converts nothing
    of (the identity needs 4:4:4): the port's load_image raises IOError,
    as ignis_tpu's does for cv2's None, on the same bytes."""
    p = tmp_path / "x.avif"
    p.write_bytes(with_nclx((FIXTURES / "cv2_default.avif").read_bytes(),
                            matrix))
    with pytest.raises(IOError):
        imagelib.load_image(p)
    with pytest.raises(IOError):
        jax_image.load_image(str(p))


@pytest.mark.parametrize("name", sorted(n for n in AVIF_FIXTURES
                                        if "_mc" in n))
def test_matrix_fixtures_load_as_jax(name):
    """The colour-matrix fixtures: ignis_tpu's load_image gives the
    port's samples as they are (it scales no .avif: the strict xfails
    above), and the port's load_image scales them by the bit depth."""
    got = imagelib.decode_samples(FIXTURES / name)
    top = 1023 if "10bit" in name else 255
    for lin in (False, True):
        np.testing.assert_array_equal(
            jax_image.load_image(str(FIXTURES / name), linear=lin),
            got.astype(np.float32))
    np.testing.assert_array_equal(
        imagelib.load_image(FIXTURES / name, linear=True),
        got.astype(np.float32) / np.float32(top))
