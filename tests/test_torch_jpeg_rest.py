"""The last JPEGs OpenCV (libjpeg-turbo 3.1) reads for ignis_tpu
(utils/jpeg.py, utils/jpeg_arith.py): lossless (SOF3) of 8 bits, every
predictor, point transforms, restart intervals, one and three
components; arithmetic-coded sequential (SOF9) and progressive (SOF10)
files, made here by re-coding the quantised coefficients of cv2's own
baseline files with T.81's QM coder (scripts/make_image_fixtures.py's
arith_jpeg), held first to cv2's reading of the baseline file (the
encoder is right) and then the port to cv2's reading of them; CMYK
without an Adobe marker and YCCK. Lossless files are held to cv2 exactly,
the others within 1 level, as the other JPEGs. The JPEGs cv2 reads
nothing of (12- and 16-bit lossless and DCT frames, hierarchical frames,
lossless YCbCr) raise IOError beside ignis_tpu's IOError."""
import io
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest

from ignis_tpu.utils import image as jax_image
from ignis_tpu_torch.utils import image as imagelib
from ignis_tpu_torch.utils import jpeg_arith
from ignis_tpu_torch.utils.jpeg import decode_jpeg

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))
from make_image_fixtures import QMEncoder, arith_jpeg  # noqa: E402
from make_image_fixtures import lossless_jpeg, smooth  # noqa: E402

FLAGS = cv2.IMREAD_UNCHANGED | cv2.IMREAD_ANYDEPTH | cv2.IMREAD_ANYCOLOR


def _cv2(data: bytes):
    img = cv2.imdecode(np.frombuffer(data, np.uint8), FLAGS)
    if img is None:
        return None
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, -1)
    return np.ascontiguousarray(img[..., 2::-1])


def _samples(h, w, ch, seed, kind):
    rng = np.random.default_rng(seed)
    if kind == "noise":
        return rng.integers(0, 256, (h, w, ch)).astype(np.uint8)
    return np.clip(smooth(h, w, seed)[..., :ch] + rng.normal(0, 6, (h, w, ch)),
                   0, 255).astype(np.uint8)


@pytest.mark.parametrize("predictor", range(1, 8))
@pytest.mark.parametrize("channels,pt,restart", [(1, 0, 0), (3, 0, 2),
                                                 (3, 1, 0), (1, 3, 1)],
                         ids=["grey", "rgb_rst2", "rgb_pt1", "grey_pt3_rst1"])
def test_lossless_matches_cv2(predictor, channels, pt, restart):
    """Lossless JPEG of 8 bits under each predictor, with a point
    transform and restart intervals of whole MCU rows, one component or
    three (read untransformed, as libjpeg-turbo reads lossless colour):
    decode_jpeg equals cv2 exactly, noise and smooth images, interleaved
    and a scan a component."""
    for k, (h, w, kind) in enumerate(((13, 17, "noise"), (1, 9, "smooth"),
                                      (24, 5, "smooth"))):
        px = _samples(h, w, channels, predictor * 10 + k, kind)
        data = lossless_jpeg(px, predictor, pt, restart, None, k % 2 == 0)
        want = _cv2(data)
        assert want is not None
        np.testing.assert_array_equal(decode_jpeg(data), want)
        np.testing.assert_array_equal(
            want, np.repeat((px >> pt) << pt, 3 // channels, -1))


@pytest.mark.parametrize("restart", [0, 1, 3])
@pytest.mark.parametrize("variant", ["420", "444", "grey"])
@pytest.mark.parametrize("mode", ["sequential", "progressive"])
def test_arithmetic_matches_cv2(mode, variant, restart):
    """cv2's baseline files re-coded arithmetically (SOF9, or SOF10: DC
    first and refinement, AC bands 1-5 and 6-63 and their refinement),
    restart markers every 0, 1 or 3 MCUs: cv2 reads the re-coded file to
    the baseline file's pixels (so the encoder is T.81's), and
    decode_jpeg within 1 level of cv2."""
    px = _samples(29, 35, 1 if variant == "grey" else 3, restart + 7,
                  "smooth")
    params = [cv2.IMWRITE_JPEG_QUALITY, 85]
    if variant == "444":
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                   cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444]
    img = px[..., 0] if variant == "grey" else px[..., ::-1]
    base = cv2.imencode(".jpg", np.ascontiguousarray(img), params)[1].tobytes()
    data = arith_jpeg(base, mode == "progressive", restart)
    want = _cv2(data)
    np.testing.assert_array_equal(want, _cv2(base))
    assert np.abs(decode_jpeg(data).astype(int) - want).max() <= 1


@pytest.mark.parametrize("dac", [{0: 0x00}, {0: 0x52, 16: 9},
                                 {0: 0xF0, 1: 0x21, 16: 1, 17: 63}],
                         ids=["L0U0", "L2U5_K9", "L0U15_K1_K63"])
def test_arithmetic_conditioning_matches_cv2(dac):
    """DAC markers: the DC conditioning bounds L and U and the AC Kx of
    each table, as libjpeg's contexts take them: cv2 reads the file to
    its baseline's pixels, and the port within 1 level of cv2."""
    px = _samples(27, 33, 3, 5, "noise")
    base = cv2.imencode(".jpg", px, [cv2.IMWRITE_JPEG_QUALITY, 75])[1]
    data = arith_jpeg(base.tobytes(), True, 2, dac)
    want = _cv2(data)
    np.testing.assert_array_equal(want, _cv2(base.tobytes()))
    assert np.abs(decode_jpeg(data).astype(int) - want).max() <= 1


def test_qm_coder_round_trip():
    """The QM encoder of the fixture script and utils/jpeg_arith.py's
    decoder over 20,000 decisions in 40 contexts of skewed statistics,
    and the fixed-probability state 113: every decision comes back."""
    rng = np.random.default_rng(1)
    ctx = rng.integers(0, 40, 20000)
    bias = rng.random(40)
    bits = (rng.random(20000) < bias[ctx]).astype(int)
    bits[::97] = rng.integers(0, 2, bits[::97].shape)
    enc, st = QMEncoder(), [0] * 41
    st[40] = jpeg_arith.FIXED
    for i, (c, b) in enumerate(zip(ctx, bits)):
        enc.encode(st, 40 if i % 11 == 0 else c, int(b))
    data = enc.finish().replace(b"\xff\x00", b"\xff")
    dec, st = jpeg_arith.QMDecoder(data), [0] * 41
    st[40] = jpeg_arith.FIXED
    got = [dec.decode(st, 40 if i % 11 == 0 else c)
           for i, c in enumerate(ctx)]
    np.testing.assert_array_equal(got, bits)


@pytest.mark.parametrize("variant", ["no_adobe", "ycck"])
@pytest.mark.parametrize("subsampling", [0, 2], ids=["444", "420"])
def test_cmyk_without_adobe_and_ycck_match_cv2(variant, subsampling):
    """Four components without an Adobe marker (CMYK, as libjpeg guesses)
    and with Adobe transform 2 (YCCK: libjpeg's YCC to inverted CMYK):
    decode_jpeg within 1 level of cv2, which converts CMYK to BGR."""
    from PIL import Image
    bio = io.BytesIO()
    Image.fromarray(_samples(21, 26, 3, subsampling, "smooth")).convert(
        "CMYK").save(bio, "JPEG", quality=90, subsampling=subsampling)
    data = bio.getvalue()
    at = data.index(b"\xff\xee")
    n = int.from_bytes(data[at + 2:at + 4], "big")
    data = (data[:at] + data[at + 2 + n:] if variant == "no_adobe"
            else data[:at + 15] + b"\x02" + data[at + 16:])
    assert np.abs(decode_jpeg(data).astype(int) - _cv2(data)).max() <= 1


def _patched(marker, prec):
    """cv2's baseline file with its frame header's marker and precision
    rewritten."""
    data = bytearray(cv2.imencode(".jpg", _samples(16, 16, 3, 0, "noise"))[1]
                     .tobytes())
    sof = data.index(b"\xff\xc0")
    data[sof + 1], data[sof + 4] = marker, prec
    return bytes(data)


@pytest.mark.parametrize("case", [
    "lossless_12", "lossless_16", "dct_12_sof1", "dct_12_sof2",
    "hierarchical_sof5", "hierarchical_sof7", "hierarchical_sof13",
    "lossless_jfif", "two_components"])
def test_jpegs_cv2_reads_nothing_of_raise_ioerror(tmp_path, case):
    """12- and 16-bit lossless and 12-bit DCT frames (which libjpeg-turbo
    reads only through interfaces OpenCV does not call), hierarchical
    frames, lossless YCbCr (a JFIF marker) and two components: IOError
    from the port, as from ignis_tpu's load_image."""
    if case.startswith("lossless_1"):
        data = bytearray(lossless_jpeg(_samples(9, 9, 1, 1, "noise")))
        sof = data.index(b"\xff\xc3")
        data[sof + 4] = int(case[-2:])
        data = bytes(data)
    elif case == "lossless_jfif":
        data = lossless_jpeg(_samples(9, 9, 3, 1, "noise"), jfif=True)
    elif case == "two_components":
        data = bytearray(lossless_jpeg(_samples(9, 9, 3, 1, "noise")))
        data[data.index(b"\xff\xc3") + 9] = 2
        data = bytes(data)
    else:
        marker = {"dct_12_sof1": 0xC1, "dct_12_sof2": 0xC2,
                  "hierarchical_sof5": 0xC5, "hierarchical_sof7": 0xC7,
                  "hierarchical_sof13": 0xCD}[case]
        data = _patched(marker, 12 if case.startswith("dct") else 8)
    assert _cv2(data) is None
    p = tmp_path / "x.jpg"
    p.write_bytes(data)
    with pytest.raises(IOError):
        imagelib.load_image(p)
    with pytest.raises(IOError):
        jax_image.load_image(str(p))


@pytest.mark.parametrize("name", ["lossless_grey.jpg", "lossless_rgb_p7.jpg",
                                  "arith_seq_420.jpg", "arith_prog_dac.jpg",
                                  "ycck.jpg", "cmyk_no_adobe.jpg"])
def test_fixtures_load_as_jax(name):
    """The fixtures: decode_samples gives cv2_pixels.npz (lossless ones
    exactly, the others within 1 level), and load_image ignis_tpu's
    (scaled and sRGB-decoded by both) within 1/255 before the decode."""
    path = Path(__file__).resolve().parent / "data" / "images" / name
    want = np.load(path.parent / "cv2_pixels.npz")[name]
    got = imagelib.decode_samples(path)
    tol = 0 if name.startswith("lossless") else 1
    assert np.abs(got.astype(int) - want).max() <= tol
    np.testing.assert_allclose(imagelib.load_image(path, linear=True),
                               jax_image.load_image(str(path), linear=True),
                               rtol=0, atol=tol / 255.0)


# ---- lossless arithmetic (SOF11) -------------------------------------------
sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))
import lossless_arith_encoder as LA  # noqa: E402


def _sof11_source(nc, seed):
    rng = np.random.default_rng(seed)
    v = np.cumsum(rng.integers(-9, 10, (13, 17, nc)), 1) + 128
    return np.clip(v, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("predictor", range(1, 8))
@pytest.mark.parametrize("nc,pt,dac,restart", [
    (1, 0, None, 0), (3, 1, (1, 3), 0), (3, 0, None, 4), (1, 1, (0, 2), 5)],
    ids=["grey", "rgb_pt1_dac", "rgb_restart", "grey_pt1_dac_restart"])
def test_sof11_reads_nothing_as_cv2(tmp_path, predictor, nc, pt, dac,
                                    restart):
    """Lossless arithmetic-coded files of the fixture writer
    (scripts/lossless_arith_encoder.py: T.81 H.1.2.3's 25 conditions on
    the left and upper differences, predictors 1-7, point transform 0
    and 1, grey and three components, with and without DAC, restart
    intervals), each read back to its stored samples by the writer's
    mirror decoder: libjpeg-turbo has no lossless arithmetic decoder, cv2
    reads nothing, and the port raises IOError beside ignis_tpu's."""
    src = _sof11_source(nc, predictor)
    data = LA.sof11_jpeg(src, predictor, pt, restart, dac)
    np.testing.assert_array_equal(LA.decode_sof11(data), src >> pt << pt)
    assert _cv2(data) is None
    p = tmp_path / "x.jpg"
    p.write_bytes(data)
    with pytest.raises(IOError, match="SOF11"):
        imagelib.load_image(p)
    with pytest.raises(IOError):
        jax_image.load_image(str(p))
