"""AV1 superres, show_existing_frame and the temporal units of several
frames in the port's AVIF reader (ignis_tpu_torch/utils/av1.py,
av1_filters.upscale, av1_recon.reconstruct) against OpenCV (cv2 5.0.0:
libavif 1.4.2 over libaom), through which ignis_tpu reads textures.

The files come from the port's own AV1 encoder (utils/av1_enc.py's
`encode_frame`: superres at denominators 9-16, 4:4:4, 10 bits, loop
restoration of each type, film grain, two tile columns, a hidden key
frame shown by show_existing_frame), written by
scripts/make_named_fixtures.py and each read by cv2: the port reads each
to cv2's pixels at atol 0, and seeded random streams too. libaom's rules
that the specification leaves to conformance are held where cv2 shows
them: FrameWidth at least Min(16, UpscaledWidth), tile columns of at
least 128 coded pixels under superres. The upscaler is held to a direct
transcription of 7.16 in Python integers. An inter frame after a key
frame, which cv2 reads, is the one tool still refused by name."""
import io
import sys
from pathlib import Path
from types import SimpleNamespace

import cv2
import numpy as np
import pytest
from PIL import Image

from ignis_tpu.utils import image as jax_image
from ignis_tpu_torch.utils import av1, av1_enc, av1_filters, avif
from ignis_tpu_torch.utils import av1_tables as T
from ignis_tpu_torch.utils import image as imagelib
from ignis_tpu_torch.utils.av1 import (RESTORE_SGRPROJ, RESTORE_SWITCHABLE,
                                       RESTORE_WIENER)

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))
import make_named_fixtures as F  # noqa: E402

FLAGS = cv2.IMREAD_UNCHANGED | cv2.IMREAD_ANYDEPTH | cv2.IMREAD_ANYCOLOR
FIXTURES = Path(__file__).resolve().parent / "data" / "images"
AV1_FIXTURES = sorted(n for n in F.FIXTURES if n.startswith(("sr_", "av1_")))


def _cv2(data: bytes):
    img = cv2.imdecode(np.frombuffer(data, np.uint8), FLAGS)
    if img is None:
        return None
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, -1)
    return np.ascontiguousarray(img[..., 2::-1])


@pytest.mark.parametrize("name", AV1_FIXTURES)
def test_fixture_matches_cv2(name):
    """Each superres and show_existing_frame fixture decodes to
    cv2_pixels.npz and to live cv2.imdecode of its bytes exactly, dtype
    and shape included."""
    path = FIXTURES / name
    want = np.load(FIXTURES / "cv2_pixels.npz")[name]
    got = imagelib.decode_samples(path)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(_cv2(path.read_bytes()), want)


@pytest.mark.parametrize("name", AV1_FIXTURES)
def test_fixture_loads_as_jax(name):
    """ignis_tpu's load_image gives the samples as they are (it scales no
    .avif: tests/test_torch_avif.py's strict xfails pin that), the
    port's load_image scales them by the bit depth."""
    path = FIXTURES / name
    got = imagelib.decode_samples(path)
    top = 1023 if got.dtype == np.uint16 else 255
    for lin in (False, True):
        np.testing.assert_array_equal(
            jax_image.load_image(str(path), linear=lin),
            got.astype(np.float32))
    np.testing.assert_array_equal(imagelib.load_image(path, linear=True),
                                  got.astype(np.float32) / np.float32(top))


def test_fixtures_use_the_tools_they_name():
    """The fixtures' headers: each superres file codes a narrower frame
    than it shows (FrameWidth < UpscaledWidth), at its denominator; the
    loop restoration, film grain, two-tile, 4:4:4 and 10-bit ones carry
    those; the show_existing_frame ones hold a hidden key frame."""
    def dec(name):
        return av1.Decoder(avif.parse_avif((FIXTURES / name).read_bytes())
                           ["av1"])
    for name, denom in (("sr_d9_odd.avif", 9), ("sr_d12_444.avif", 12),
                        ("sr_d16_10bit.avif", 16)):
        d = dec(name)
        assert d.sr_denom == denom and d.w < d.up_w
    d = dec("sr_d9_odd.avif")
    assert d.w % 4 and d.up_w % 2          # a partial 4 x 4, odd width
    assert (dec("sr_d12_444.avif").ssx, dec("sr_d16_10bit.avif").bd) == \
        (0, 10)
    assert len(dec("sr_two_tiles.avif").col_starts) == 3
    for name, kind in (("sr_lr_wiener.avif", RESTORE_WIENER),
                       ("sr_lr_sgrproj.avif", RESTORE_SGRPROJ),
                       ("sr_lr_switchable.avif", RESTORE_SWITCHABLE)):
        d = dec(name)
        assert d.lr_type == [kind] * 3
        assert {u[0] for p in range(3) for u in d.lr_units[p].values()} \
            >= ({kind} if kind != RESTORE_SWITCHABLE
                else {RESTORE_WIENER, RESTORE_SGRPROJ})
    assert dec("sr_grain.avif").grain is not None
    for name in ("av1_show_existing.avif", "av1_show_existing_grain.avif"):
        d = dec(name)
        assert not d.show_frame and d.output is not None
    assert dec("av1_show_existing_grain.avif").grain is not None


def _transcribed_upscale(row, down, up, mi_w, bd):
    """7.16's upscaling of one plane row, in Python integers as the
    specification writes it (C's truncating division)."""
    def div(a, b):
        return abs(a) // b * (1 if a >= 0 else -1)
    step = ((down << 14) + up // 2) // up
    err = up * step - (down << 14)
    x0 = div(-((up - down) << 13) + up // 2, up) + (1 << 7) - div(err, 2)
    x0 &= (1 << 14) - 1
    out = []
    for x in range(up):
        src_x = -(1 << 14) + x0 + x * step
        src_p = src_x >> 14
        src_f = (src_x & ((1 << 14) - 1)) >> 8
        s = 0
        for k in range(8):
            s += row[min(max(src_p + k - 3, 0), mi_w - 1)] * \
                T.UPSCALE_FILTER[src_f][k]
        out.append(min(max((s + 64) >> 7, 0), (1 << bd) - 1))
    return out


@pytest.mark.parametrize("ss", [0, 1], ids=["444", "420"])
@pytest.mark.parametrize("denom", range(9, 17))
def test_upscaler_matches_spec_transcription(denom, ss):
    """av1_filters.upscale over random rows (samples past the frame's
    width included, up to the MI-aligned width the taps clamp at) against
    the transcription, for every denominator and both subsamplings, at 8
    and 10 bits."""
    rng = np.random.default_rng(denom * 2 + ss)
    for up_w, bd in ((int(rng.integers(17, 200)), 8),
                     (int(rng.integers(17, 200)), 10)):
        w = av1_enc.coded_width(up_w, denom)
        d = SimpleNamespace(bd=bd, ssx=ss, w=w, up_w=up_w,
                            mi_cols=2 * ((w + 7) >> 3))
        mi_w = (d.mi_cols * 4) >> ss
        planes = [rng.integers(0, 1 << bd, (3, mi_w + 160)).astype(np.int32)
                  for _ in range(2)]
        got = av1_filters.upscale(d, planes)
        down, up = (w + ss) >> ss, (up_w + ss) >> ss
        for row in range(3):
            want = _transcribed_upscale(planes[1][row].tolist(), down, up,
                                        mi_w, bd)
            assert got[1][row, :up].tolist() == want


def _random_case(seed):
    """A seeded random superres stream's options and size: denominator,
    subsampling, depth, loop restoration, film grain, a hidden frame."""
    rng = np.random.default_rng(seed)
    opts = {"superres": int(rng.integers(9, 17))}
    if rng.random() < 0.3:
        opts.update(ssx=0, ssy=0)
    if rng.random() < 0.3:
        opts["bd"] = 10
    if rng.random() < 0.6:
        opts["lr"] = F.lr([int(rng.integers(4)) for _ in range(3)],
                          int(rng.integers(3)), int(rng.integers(2)), seed)
    if opts.get("bd", 8) == 8 and rng.random() < 0.3:
        opts["grain"] = F.grain_params(seed)
    if rng.random() < 0.3:
        opts["hidden"] = True
    h = int(rng.integers(1, 40))
    w = int(rng.integers(1, min(4096 // h, 120) + 1))
    return h, w, opts


@pytest.mark.parametrize("seed", range(8))
def test_random_streams_match_cv2(seed):
    """Seeded random streams of the encoder (any size from 1 x 1, any
    denominator, with or without loop restoration, film grain, a hidden
    frame): the port reads each to cv2's pixels."""
    h, w, opts = _random_case(seed)
    data = F.avif_of(F.av1_stream(h, w, seed, **opts))
    want = _cv2(data)
    assert want is not None
    np.testing.assert_array_equal(avif.decode_avif(data), want)


@pytest.mark.parametrize("w,denom", [(6, 10), (15, 16), (24, 13), (17, 9)])
def test_coded_width_at_least_16_as_libaom(w, denom):
    """libaom keeps FrameWidth at least Min(16, UpscaledWidth): a 6-wide
    picture at denominator 10 is coded whole, a 24-wide one at 13 as 16
    (not 15), and cv2 reads each as the port does."""
    d = av1.Decoder(F.av1_stream(8, w, w, superres=denom)[0])
    assert d.w == max((w * 8 + denom // 2) // denom, min(16, w))
    data = F.avif_of(F.av1_stream(8, w, w, superres=denom))
    np.testing.assert_array_equal(avif.decode_avif(data), _cv2(data))


def test_allow_intrabc_not_read_under_superres():
    """With screen content tools on and a superres frame, the header has
    no allow_intrabc bit (UpscaledWidth != FrameWidth): the fields after
    it read as written."""
    o = av1_enc.Options(superres=12)
    bw = av1.BitWriter()
    bw.f(1, 0)                  # disable_cdf_update
    bw.f(1, 1)                  # allow_screen_content_tools
    bw.f(1, 0)                  # force_integer_mv
    bw.f(1, 1)                  # use_superres
    bw.f(3, 12 - 9)             # coded_denom
    bw.f(1, 0)                  # render_and_frame_size_different
    rest = av1.BitReader(av1_enc.frame_header(
        16, 16, (0, 0, 0, 0), (0, 0), (0, 0), 0))
    for _ in range(3):          # its disable_cdf_update, sct, render
        rest.f(1)
    for _ in range(len(rest.data) * 8 - 3):
        bw.f(1, rest.f(1))
    bw.byte_align()
    d = av1_enc.frame_state(av1_enc.sequence_header(24, 16, o), bw.bytes())
    assert (d.sct, d.allow_intrabc, d.up_w, d.w) == (1, 0, 24, 16)
    assert d.base_q == av1_enc.BASE_Q and d.dq[1] == [-16, -16]


def test_inter_frame_after_a_key_frame_refused():
    """An item of Pillow's first (key) and second (inter) sequence
    samples: cv2 shows the inter frame's picture (Pillow's second frame),
    and the port, once refusing it, reads it to the same pixels."""
    item, seq = F.key_and_inter()
    data = avif.heif_image(item, seq, 32, 24)
    seq_file = F.pil_sequence(2, seed=7)
    im = Image.open(io.BytesIO(seq_file))
    im.seek(1)
    want = np.asarray(im.convert("RGB"))
    np.testing.assert_array_equal(_cv2(data), want)
    got = avif.decode_avif(data, "x.avif")
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_show_existing_frame_shows_the_slot():
    """A hidden key frame then show_existing_frame: the output is the
    hidden frame's reconstruction (its film grain applied at showing);
    without the showing header the unit shows nothing (IOError)."""
    o = av1_enc.Options(hidden=True)
    e = av1_enc.encode_frame(F.yuv_planes(16, 24, 5), o)
    shown = av1.decode_av1(e.obus)
    hidden_only = e.obus[:-len(av1_enc._obu(3, av1_enc.show_existing_header(
        0)))]
    d = av1.Decoder(hidden_only)
    assert d.frame_done and not d.show_frame
    with pytest.raises(IOError):
        av1.decode_av1(hidden_only)
    d.finish_frame()
    frame, _ = d.slots[0][:2]
    for a, b in zip(shown.planes, frame.planes):
        np.testing.assert_array_equal(a, b)
