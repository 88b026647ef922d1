"""The port's own image codecs (ignis_tpu_torch/utils/image.py,
utils/jpeg.py) against OpenCV, through which ignis_tpu reads and writes
LDR images: BMP, PNG palette and Adam7 files and baseline JPEGs read by
the port and by `ignis_tpu.utils.image.load_image` on the same bytes, and
the port's writers read back by `cv2.imread`.

cv2 (5.0.0) writes BMP and JPEG fixtures. It writes no palette or
interlaced PNG, so those fixtures are encoded here from the PNG
specification and read by both sides. cv2 5.0.0 has no TGA codec, so the
TGA fixtures are encoded here from the TGA specification and held to
their pixels (ignis_tpu's load_image cannot read a TGA with this cv2)."""
import struct
import zlib

import cv2
import numpy as np
import pytest

from ignis_tpu.utils import image as jax_image
from ignis_tpu_torch.utils import image as imagelib
from ignis_tpu_torch.utils.jpeg import decode_jpeg, encode_jpeg


def _full_range(h, w, seed=0, ch=3):
    """uint8 [h, w, ch] noise over 0-255 with both ends present."""
    img = np.random.default_rng(seed).integers(0, 256, (h, w, ch),
                                               dtype=np.uint8)
    flat = img.reshape(-1, ch)
    flat[0], flat[1] = 0, 255
    return img


def _photo(h, w, seed=0):
    """A smooth image with noise, edges and both ends of 0-255: what a
    JPEG is for."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([127 + 127 * np.sin(xx / 7.0 + c) * np.cos(yy / 9.0 - c)
                    for c in range(3)], -1) + rng.normal(0, 20, (h, w, 3))
    img[2:9, 3:30] = 255
    img[12:20, 5:12] = 0
    return np.clip(img, 0, 255).astype(np.uint8)


def _both_readers(path):
    """(port, ignis_tpu) load_image of path, sRGB-decoded and linear."""
    return [(imagelib.load_image(path, linear=lin),
             jax_image.load_image(str(path), linear=lin))
            for lin in (False, True)]


# ---------------------------------------------------------------------------
# BMP
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("channels", [3, 4])
def test_bmp_read_matches_jax(tmp_path, channels):
    """cv2's 24-bit (BGR) and 32-bit (BGRA) BMPs of an odd width (rows
    padded to 4 bytes): the port's load_image equals ignis_tpu's exactly,
    sRGB-decoded and linear."""
    img = _full_range(13, 21, channels, channels)
    p = tmp_path / f"c{channels}.bmp"
    assert cv2.imwrite(str(p), img)
    for got, want in _both_readers(p):
        assert got.shape == (13, 21, 3) and got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(imagelib.decode_bmp(p.read_bytes()),
                                  img[..., 2::-1])


def test_bmp_top_down_and_writer(tmp_path):
    """A top-down BMP (negative height) reads the right way up, and the
    port's 24-bit writer's file reads back through cv2.imread equal to its
    input, directly and through save_image's sRGB encoding."""
    rgb = _full_range(5, 7, 3)
    data = bytearray(imagelib.encode_bmp(rgb))
    stride = (3 * 7 + 3) & ~3
    rows = np.frombuffer(bytes(data[54:]), np.uint8).reshape(5, stride)
    data[22:26] = struct.pack("<i", -5)
    data[54:] = rows[::-1].tobytes()
    np.testing.assert_array_equal(imagelib.decode_bmp(bytes(data)), rgb)
    p = tmp_path / "w.bmp"
    p.write_bytes(imagelib.encode_bmp(rgb))
    np.testing.assert_array_equal(cv2.imread(str(p))[..., ::-1], rgb)
    lin = np.random.default_rng(3).random((9, 6, 3)).astype(np.float32)
    imagelib.save_image(tmp_path / "s.bmp", lin)
    want = (imagelib.linear_to_srgb(lin) * 255.0 + 0.5).astype(np.uint8)
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "s.bmp"))
                                  [..., ::-1], want)


# ---------------------------------------------------------------------------
# TGA
# ---------------------------------------------------------------------------

def _tga(kind, w, h, bpp, desc, payload, image_id=b""):
    return struct.pack("<BBBHHBHHHHBB", len(image_id), 0, kind, 0, 0, 0, 0,
                       0, w, h, bpp, desc) + image_id + payload


def test_tga_uncompressed_and_rle_read():
    """Hand-encoded TGAs: uncompressed 24-bit with the bottom-left origin
    and an image id, and run-length-encoded 32-bit with the top-left
    origin (run and raw packets), each equal to its pixels."""
    rgb = _full_range(4, 6, 5)
    bgr = rgb[..., ::-1]
    raw = _tga(2, 6, 4, 24, 0x00, bgr[::-1].tobytes(), b"id!")
    np.testing.assert_array_equal(imagelib.decode_tga(raw), rgb)
    row = np.array([[1, 2, 3], [1, 2, 3], [1, 2, 3], [9, 8, 7], [0, 0, 255]],
                   np.uint8)
    bgra = np.concatenate([row[:, ::-1], np.full((5, 1), 77, np.uint8)], 1)
    rle = (bytes([0x82]) + bgra[0].tobytes()            # run of 3
           + bytes([0x01]) + bgra[3:5].tobytes())       # 2 raw pixels
    got = imagelib.decode_tga(_tga(10, 5, 2, 32, 0x28, rle * 2))
    np.testing.assert_array_equal(got, np.stack([row, row]))


def test_tga_writer_round_trip(tmp_path):
    """save_image's TGA (run-length encoded, rows of runs, singles and a
    run past 128 pixels) reads back equal, and a row's packets are the
    ones the specification gives."""
    rgb = _full_range(6, 300, 7)
    rgb[2, 10:200] = (5, 6, 7)
    rgb[3] = rgb[3, :1]
    data = imagelib.encode_tga(rgb)
    assert data[2] == 10 and data[17] == 0x20
    np.testing.assert_array_equal(imagelib.decode_tga(data), rgb)
    small = np.array([[[1, 2, 3], [1, 2, 3], [4, 5, 6]]], np.uint8)
    assert imagelib.encode_tga(small)[18:] == (
        bytes([0x81, 3, 2, 1, 0x00, 6, 5, 4]))
    lin = np.random.default_rng(4).random((5, 8, 3)).astype(np.float32)
    imagelib.save_image(tmp_path / "s.tga", lin)
    want = (imagelib.linear_to_srgb(lin) * 255.0 + 0.5).astype(np.uint8)
    np.testing.assert_array_equal(
        imagelib.read_ldr(tmp_path / "s.tga"), want / np.float32(255.0))


# ---------------------------------------------------------------------------
# PNG: palette, low bit depths, Adam7
# ---------------------------------------------------------------------------

ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _pack_rows(samples, depth):
    """[h, w, ch] samples as PNG scanline bytes (no filter byte)."""
    h = samples.shape[0]
    if depth == 16:
        return samples.astype(">u2").reshape(h, -1).view(np.uint8)
    if depth == 8:
        return samples.astype(np.uint8).reshape(h, -1)
    bits = ((samples.reshape(h, -1, 1) >> np.arange(depth - 1, -1, -1))
            & 1).astype(np.uint8).reshape(h, -1)
    return np.packbits(bits, axis=1)


def _filtered(rows, bpp, first_filter):
    """Rows filtered with the five filter types in turn (the PNG
    specification's Sub, Up, Average and Paeth)."""
    rows = rows.astype(np.int32)
    out, prior = [], np.zeros(rows.shape[1], np.int32)
    for y, line in enumerate(rows):
        ft = (first_filter + y) % 5
        left = np.concatenate([np.zeros(bpp, np.int32), line[:-bpp]])
        ul = np.concatenate([np.zeros(bpp, np.int32), prior[:-bpp]])
        if ft == 0:
            f = line
        elif ft == 1:
            f = line - left
        elif ft == 2:
            f = line - prior
        elif ft == 3:
            f = line - (left + prior) // 2
        else:
            p = left + prior - ul
            pa, pb, pc = abs(p - left), abs(p - prior), abs(p - ul)
            f = line - np.where((pa <= pb) & (pa <= pc), left,
                                np.where(pb <= pc, prior, ul))
        out.append(bytes([ft]) + (f & 0xFF).astype(np.uint8).tobytes())
        prior = line
    return b"".join(out)


def _png_bytes(samples, depth, color, interlace, plte=None):
    h, w, ch = samples.shape
    bpp = max(1, ch * depth // 8)
    if interlace:
        raw = b"".join(
            _filtered(_pack_rows(samples[y0::dy, x0::dx], depth), bpp, k)
            for k, (x0, y0, dx, dy) in enumerate(ADAM7)
            if x0 < w and y0 < h)
    else:
        raw = _filtered(_pack_rows(samples, depth), bpp, 0)

    def chunk(tag, body):
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))
    out = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, color, 0, 0, interlace))
    if plte is not None:
        out += chunk(b"PLTE", plte.tobytes())
    return out + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b"")


PNG_CASES = [  # (colour type, bit depth, interlace)
    (3, 1, 0), (3, 2, 0), (3, 4, 0), (3, 8, 0), (3, 4, 1), (3, 8, 1),
    (0, 1, 0), (0, 2, 1), (0, 4, 0), (0, 8, 1), (2, 8, 1), (4, 8, 1),
    (6, 8, 1)]


@pytest.mark.parametrize("color,depth,interlace", PNG_CASES,
                         ids=[f"type{c}_{d}bit_{'adam7' if i else 'flat'}"
                              for c, d, i in PNG_CASES])
def test_png_palette_and_interlace_match_jax(tmp_path, color, depth,
                                             interlace):
    """Palette PNGs (PLTE of 2^depth full-range colours), gray below 8
    bits, and Adam7 interlacing of every colour type, at 13x11 (every
    pass non-empty, partial bytes at the row ends): the port's load_image
    equals ignis_tpu's (libpng through cv2) exactly."""
    rng = np.random.default_rng(depth * 10 + color + interlace)
    ch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color]
    samples = rng.integers(0, 1 << depth, (11, 13, ch))
    flat = samples.reshape(-1, ch)
    flat[0], flat[1] = 0, (1 << depth) - 1
    plte = None
    if color == 3:
        plte = _full_range(1 << depth, 1, depth)[:, 0]
    p = tmp_path / "t.png"
    p.write_bytes(_png_bytes(samples, depth, color, interlace, plte))
    for got, want in _both_readers(p):
        assert got.shape == (11, 13, 3)
        np.testing.assert_array_equal(got, want)
    if color == 3:
        np.testing.assert_array_equal(
            imagelib.read_png(p), plte[samples[..., 0]] / np.float32(255.0))


def test_png_16bit_adam7():
    """A 16-bit RGB Adam7 PNG reads as its samples / 65535 (ignis_tpu
    scales 16-bit samples by 1/255, ROADMAP queue 3, so not against it)."""
    import tempfile
    from pathlib import Path
    samples = np.random.default_rng(5).integers(0, 65536, (9, 10, 3))
    with tempfile.TemporaryDirectory() as d:
        p = Path(d) / "t.png"
        p.write_bytes(_png_bytes(samples, 16, 2, 1))
        np.testing.assert_array_equal(
            imagelib.read_png(p), (samples / 65535.0).astype(np.float32))


# ---------------------------------------------------------------------------
# JPEG
# ---------------------------------------------------------------------------

SAMPLING = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420}


@pytest.mark.parametrize("size", [(37, 53), (8, 8), (1, 5)],
                         ids=["37x53", "8x8", "1x5"])
@pytest.mark.parametrize("sampling", list(SAMPLING))
def test_jpeg_read_matches_jax(tmp_path, sampling, size):
    """cv2's baseline JPEGs (quality 90) at 4:4:4, 4:2:2 and 4:2:0, of
    sizes that are and are not whole MCUs: the port's load_image within
    1/255 of ignis_tpu's (libjpeg-turbo's islow IDCT, fancy upsampling and
    integer colour tables), sRGB-decoded and linear."""
    img = _photo(*size)
    p = tmp_path / "t.jpg"
    assert cv2.imwrite(str(p), img[..., ::-1], [
        cv2.IMWRITE_JPEG_QUALITY, 90,
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling]])
    for got, want in _both_readers(p):
        assert got.shape == size + (3,)
        np.testing.assert_allclose(got, want, rtol=0, atol=1.0 / 255.0)
    ref = cv2.imread(str(p))[..., ::-1].astype(int)
    assert np.abs(decode_jpeg(p.read_bytes()).astype(int) - ref).max() <= 1


def test_jpeg_gray_and_restart_markers(tmp_path):
    """A gray JPEG reads as three equal channels, and a JPEG with a
    restart marker every 3 MCUs reads as cv2 reads it, within 1/255."""
    p = tmp_path / "g.jpeg"
    assert cv2.imwrite(str(p), _photo(33, 47)[..., 0])
    for got, want in _both_readers(p):
        np.testing.assert_allclose(got, want, rtol=0, atol=1.0 / 255.0)
    assert cv2.imwrite(str(p), _photo(64, 80), [cv2.IMWRITE_JPEG_RST_INTERVAL,
                                                3])
    assert b"\xff\xd0" in p.read_bytes()
    for got, want in _both_readers(p):
        np.testing.assert_allclose(got, want, rtol=0, atol=1.0 / 255.0)


def test_jpeg_writer_matches_cv2_quality(tmp_path):
    """save_image's JPEG (baseline 4:2:0, quality 95, Annex K tables),
    read back by cv2.imread, is within 0.5 dB PSNR of cv2's own
    quality-95 JPEG of the same pixels; the port decodes it as cv2 does,
    within 1/255."""
    rgb = _photo(96, 120, seed=2)
    lin = imagelib.srgb_to_linear(rgb / np.float32(255.0)).astype(np.float32)
    ldr = (imagelib.linear_to_srgb(lin) * 255.0 + 0.5).astype(np.uint8)
    imagelib.save_image(tmp_path / "p.jpg", lin)
    data = (tmp_path / "p.jpg").read_bytes()
    assert data[:2] == b"\xff\xd8" and b"\xff\xc0" in data
    ours = cv2.imread(str(tmp_path / "p.jpg"))[..., ::-1]
    assert cv2.imwrite(str(tmp_path / "c.jpg"), ldr[..., ::-1],
                       [cv2.IMWRITE_JPEG_QUALITY, 95])
    theirs = cv2.imread(str(tmp_path / "c.jpg"))[..., ::-1]

    def psnr(a):
        return 10 * np.log10(255.0 ** 2 / np.mean(
            (a.astype(np.float64) - ldr) ** 2))
    assert psnr(ours) >= psnr(theirs) - 0.5, (psnr(ours), psnr(theirs))
    assert np.abs(decode_jpeg(data).astype(int) - ours).max() <= 1
    gray = encode_jpeg(ldr[..., 1])
    back = cv2.imdecode(np.frombuffer(gray, np.uint8), cv2.IMREAD_UNCHANGED)
    assert back.shape == ldr.shape[:2]


def test_progressive_jpeg_raises(tmp_path):
    """A progressive JPEG is refused by name, not misread."""
    p = tmp_path / "p.jpg"
    assert cv2.imwrite(str(p), _photo(16, 16),
                       [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    with pytest.raises(NotImplementedError, match="progressive"):
        imagelib.load_image(p)
