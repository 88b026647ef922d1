"""The port's own image codecs (ignis_tpu_torch/utils/image.py,
utils/jpeg.py, utils/tiff.py, utils/gif.py, utils/webp.py) against
OpenCV, through which ignis_tpu reads and writes images: BMP (every
depth, RLE, bit fields, OS/2's 12-byte header), PNG palette and Adam7
files, baseline, progressive, CMYK and RGB JPEGs, TIFF (every sample
type OpenCV reads, bilevel, palettes, CMYK, JPEG-compressed, planar,
BigTIFF), PNM, PAM, PFM, Sun raster, GIF and WebP (lossless and lossy)
read by the port and by cv2 or `ignis_tpu.utils.image.load_image` on the
same bytes, files found by their content whatever their suffix, and
every writer of save_image read back by `cv2.imread` beside ignis_tpu's
file of the same image (the PAM byte for byte).

cv2 (5.0.0) writes BMP, JPEG, GIF, WebP, TIFF (every sample type), PAM
and the other fixtures; Pillow (12.1.0) writes the palette, transparent
and animated GIFs, WebPs with alpha, animations and its `method`s, CMYK
and RGB JPEGs, and bilevel, CMYK, JPEG-compressed, signed 32-bit and
BigTIFF TIFFs. cv2 writes no palette or interlaced PNG, so those
fixtures are encoded here from the PNG specification and read by both
sides. cv2 5.0.0 has no TGA codec, so the TGA fixtures are encoded here
from the TGA specification and held to their pixels; ignis_tpu's
save_image of a .tga raises cv2.error and its load_image of a TGA raises
IOError, pinned as a reference fault the port fixes. Likewise the BMP
(OS/2 too), TIFF (planar, tiled, big-endian, BigTIFF, JPEG in YCbCr
strips), PAM, Sun-raster and GIF variants cv2 does not write, and
lossless WebPs with each transform (RFC 9649), are encoded here (or by
scripts/make_image_fixtures.py) from their specifications and held to
cv2.imread where cv2 reads them, else to their pixels; lossy WebPs with
the filter headers no writer here makes are cv2's own frames written
again with another header (RFC 6386's boolean encoder)."""
import struct
import sys
import zlib
from pathlib import Path

import cv2
import numpy as np
import pytest

from ignis_tpu.utils import image as jax_image
from ignis_tpu_torch.utils import image as imagelib
from ignis_tpu_torch.utils.jpeg import decode_jpeg, encode_jpeg
from ignis_tpu_torch.utils.tiff import decode_tiff

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))
from make_image_fixtures import lzw_encode as _lzw_encode  # noqa: E402
from make_image_fixtures import packbits as _packbits  # noqa: E402
from make_image_fixtures import tiff_file as _tiff  # noqa: E402


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
    """A progressive JPEG, which this test once held to NotImplementedError,
    is read (equal to cv2 within 1 level), and so are the variants it
    once held so too: the same coefficients arithmetic-coded (SOF10) and
    an 8-bit lossless file (SOF3) of the same pixels, as cv2 reads them.
    A 12-bit frame and a lossless arithmetic-coded frame (SOF11, once
    refused by name; libjpeg-turbo has no lossless arithmetic decoder),
    which cv2 reads nothing of, raise IOError as ignis_tpu's load_image
    does."""
    import sys
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent
                           / "scripts"))
    from make_image_fixtures import arith_jpeg, lossless_jpeg
    p = tmp_path / "p.jpg"
    assert cv2.imwrite(str(p), _photo(16, 16),
                       [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    data = p.read_bytes()
    ref = cv2.imread(str(p))[..., ::-1].astype(int)
    assert np.abs(decode_jpeg(data).astype(int) - ref).max() <= 1
    for variant in (arith_jpeg(data, progressive=True),
                    lossless_jpeg(_photo(16, 16), 1, ids=[82, 71, 66])):
        assert np.abs(decode_jpeg(variant).astype(int)
                      - _cv2_rgb(variant)).max() <= 1
    sof = data.index(b"\xff\xc2")
    for marker, prec in ((0xC2, 12), (0xCB, 8)):
        variant = bytearray(data)
        variant[sof + 1] = marker
        variant[sof + 4] = prec
        (tmp_path / "v.jpg").write_bytes(bytes(variant))
        assert _cv2_rgb(bytes(variant)) is None
        with pytest.raises(IOError, match="12-bit" if prec == 12
                           else "SOF11"):
            imagelib.load_image(tmp_path / "v.jpg")
        with pytest.raises(IOError):
            jax_image.load_image(str(tmp_path / "v.jpg"))


# ---------------------------------------------------------------------------
# progressive JPEG
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("optimize", [0, 1], ids=["annex_k", "optimized"])
@pytest.mark.parametrize("size", [(37, 53), (8, 8), (1, 5)],
                         ids=["37x53", "8x8", "1x5"])
@pytest.mark.parametrize("sampling", list(SAMPLING))
def test_progressive_jpeg_matches_cv2(tmp_path, sampling, size, optimize):
    """cv2's progressive JPEGs (libjpeg's scan script: DC first and
    refinement, spectral bands of AC first scans, AC refinements) at
    4:4:4, 4:2:2 and 4:2:0, of sizes that are and are not whole MCUs, with
    the Annex K or optimized Huffman tables: decode_jpeg within 1 level of
    cv2.imread, and load_image within 1/255 of ignis_tpu's, sRGB-decoded
    and linear."""
    p = tmp_path / "t.jpg"
    assert cv2.imwrite(str(p), _photo(*size)[..., ::-1], [
        cv2.IMWRITE_JPEG_PROGRESSIVE, 1, cv2.IMWRITE_JPEG_QUALITY, 90,
        cv2.IMWRITE_JPEG_OPTIMIZE, optimize,
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling]])
    data = p.read_bytes()
    assert b"\xff\xc2" in data and data.count(b"\xff\xda") > 2
    ref = cv2.imread(str(p))[..., ::-1].astype(int)
    assert np.abs(decode_jpeg(data).astype(int) - ref).max() <= 1
    for got, want in _both_readers(p):
        assert got.shape == size + (3,)
        np.testing.assert_allclose(got, want, rtol=0, atol=1.0 / 255.0)


@pytest.mark.parametrize("restart", [0, 1, 3])
def test_progressive_jpeg_gray_and_restart_markers(tmp_path, restart):
    """A grey progressive JPEG (single-component DC scans) and colour
    ones with a restart marker every 1 and 3 MCUs (end-of-band runs and
    DC predictions reset at each), optimized tables: within 1 level of
    cv2.imread, load_image within 1/255 of ignis_tpu's."""
    params = [cv2.IMWRITE_JPEG_PROGRESSIVE, 1, cv2.IMWRITE_JPEG_OPTIMIZE, 1,
              cv2.IMWRITE_JPEG_RST_INTERVAL, restart]
    for name, img in (("g.jpg", _photo(33, 47)[..., 0]),
                      ("c.jpg", _photo(64, 80, seed=3))):
        p = tmp_path / name
        assert cv2.imwrite(str(p), img, params)
        data = p.read_bytes()
        assert (b"\xff\xd0" in data) == (restart > 0)
        ref = cv2.imread(str(p))[..., ::-1].astype(int)
        assert np.abs(decode_jpeg(data).astype(int) - ref).max() <= 1
        for got, want in _both_readers(p):
            np.testing.assert_allclose(got, want, rtol=0, atol=1.0 / 255.0)


# ---------------------------------------------------------------------------
# BMP: palettes, run-length encoding, bit fields
# ---------------------------------------------------------------------------

def _bmp(w, h, bpp, comp, pixels, palette=None, masks=None, hsize=40):
    """A BMP of stored pixel bytes, an optional palette of (r, g, b) and
    BI_BITFIELDS masks (after a 40-byte header, or inside a longer one),
    from the BMP specification."""
    pal = b"" if palette is None else b"".join(
        bytes([b, g, r, 0]) for r, g, b in palette)
    extra = b"" if masks is None else struct.pack("<III", *masks)
    if hsize > 40:
        extra = extra.ljust(hsize - 40, b"\0")
    info = struct.pack("<IiiHHIIiiII", hsize, w, h, 1, bpp, comp,
                       len(pixels), 2835, 2835,
                       0 if palette is None else len(palette), 0) + extra
    off = 14 + len(info) + len(pal)
    return (struct.pack("<2sIHHI", b"BM", off + len(pixels), 0, 0, off)
            + info + pal + pixels)


def _bmp_rows(idx, bpp):
    """[h, w] palette indices as bottom-up rows of bpp-bit indices, each
    padded to 4 bytes."""
    h, w = idx.shape
    stride = (w * bpp + 31) // 32 * 4
    out = b""
    for row in idx[::-1]:
        bits = ((row[:, None] >> np.arange(bpp - 1, -1, -1)) & 1).astype(
            np.uint8).reshape(-1)
        out += np.packbits(bits).tobytes().ljust(stride, b"\0")
    return out


def _bmp_rle(idx, four, delta_at=None):
    """RLE8 (RLE4 when `four`) of [h, w] indices, bottom row first: runs of
    two or more equal pixels, absolute runs of three or more, single
    pixels as runs of one, end of line, end of bitmap; `delta_at` (stored
    row, column) moves 2 pixels right and 1 row up there (the skipped
    pixels take palette entry 0)."""
    out = bytearray()
    h, w = idx.shape
    rows = idx[::-1].tolist()
    start = 0
    for y in range(h):
        row, x, start = rows[y], start, 0
        while x < w:
            if delta_at == (y, x):
                out += bytes([0, 2, 2, 1])
                start = x + 2
                break
            end = x
            while end < w and row[end] == row[x] and end - x < 255:
                end += 1
            stop = w if delta_at is None or delta_at[0] != y else \
                delta_at[1]
            if end - x >= 2 or stop - x < 3:
                n = end - x if end - x >= 2 else 1
                out += bytes([n, row[x] * 17 if four else row[x]])
                x += n
                continue
            n = 3
            while x + n < stop and n < 255 and row[x + n] != row[
                    min(x + n + 1, w - 1)]:
                n += 1
            px = row[x:x + n]
            if four:
                px = px + [0] * (n % 2)
                data = bytes(a << 4 | b for a, b in zip(px[::2], px[1::2]))
            else:
                data = bytes(px)
            out += bytes([0, n]) + data + b"\0" * (len(data) % 2)
            x += n
        else:
            out += bytes([0, 0])
    return bytes(out + bytes([0, 1]))


def _cv2_rgb(data: bytes):
    """cv2.imdecode of data (IMREAD_UNCHANGED | ANYDEPTH | ANYCOLOR) as
    [h, w, 3] RGB, or None where cv2 reads nothing."""
    img = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED
                       | cv2.IMREAD_ANYDEPTH | cv2.IMREAD_ANYCOLOR)
    if img is None:
        return None
    if img.ndim == 2 or img.shape[2] == 2:     # grey, or grey and alpha
        img = np.repeat(img.reshape(img.shape[:2] + (-1,))[..., :1], 3, -1)
    return np.ascontiguousarray(img[..., 2::-1])


def _bmp_case(case, rng):
    h, w = 9, 21
    if case in ("1bit", "4bit", "8bit", "rle8", "rle4", "rle8_delta",
                "rle4_delta"):
        bpp = {"1": 1, "4": 4, "8": 8}[case[3] if case.startswith("rle")
                                       else case[0]]
        n = 1 << bpp
        pal = [tuple(int(v) for v in rng.integers(0, 256, 3))
               for _ in range(n)]
        idx = rng.integers(0, n, (h, w))
        idx[2, 3:12] = n - 1
        idx[5] = 1
        if case.startswith("rle"):
            delta = (3, 4) if case.endswith("delta") else None
            data = _bmp(w, h, bpp, 1 if bpp == 8 else 2,
                        _bmp_rle(idx, bpp == 4, delta), pal)
        else:
            data = _bmp(w, h, bpp, 0, _bmp_rows(idx, bpp), pal)
        return data
    if case.startswith("16"):
        stride = (2 * w + 3) & ~3
        word = rng.integers(0, 1 << 16, (h, w)).astype("<u2")
        px = b"".join(r.tobytes().ljust(stride, b"\0") for r in word[::-1])
        masks = {"16_555": None, "16_565": (0xF800, 0x7E0, 0x1F),
                 "16_555_fields": (0x7C00, 0x3E0, 0x1F)}[case]
        return _bmp(w, h, 16, 0 if masks is None else 3, px, masks=masks)
    word = rng.integers(0, 1 << 32, (h, w)).astype("<u4")
    masks, hsize = {
        "32_fields_bytes": ((0xFF0000, 0xFF00, 0xFF), 40),
        "32_fields_high": ((0xFF000000, 0xFF0000, 0xFF00), 108),
        "32_fields_10bit": ((0x3FF00000, 0xFFC00, 0x3FF), 108),
        "32_fields_5bit": ((0x1F, 0x3E0, 0x7C00), 124),
        "32_fields_12_10_10": ((0xFFF00000, 0xFFC00, 0x3FF), 56)}[case]
    return _bmp(w, h, 32, 3, word[::-1].tobytes(), masks=masks, hsize=hsize)


BMP_CASES = ["1bit", "4bit", "8bit", "rle8", "rle4", "rle8_delta",
             "rle4_delta", "16_555", "16_565", "16_555_fields",
             "32_fields_bytes", "32_fields_high", "32_fields_10bit",
             "32_fields_5bit", "32_fields_12_10_10"]


@pytest.mark.parametrize("case", BMP_CASES)
def test_bmp_variants_match_cv2(case):
    """Hand-encoded BMPs (cv2 writes none of these): 1-, 4- and 8-bit
    palettes, RLE8 and RLE4 (runs, absolute runs, a delta), 16-bit 5-5-5
    and 5-6-5, 32-bit bit fields of 8, 10, 5 and 12 bits in 40-, 56-, 108-
    and 124-byte headers: decode_bmp equals cv2.imdecode exactly."""
    data = _bmp_case(case, np.random.default_rng(len(case)))
    want = _cv2_rgb(data)
    assert want is not None
    np.testing.assert_array_equal(imagelib.decode_bmp(data), want)


def test_bmp_cv2_grey_palette_and_narrow_16bit_fields(tmp_path):
    """cv2's own 8-bit palette BMP of a grey image reads as its grey
    levels through load_image (equal to ignis_tpu's); a 16-bit file with
    4-4-4 and 3-6-6 bit fields, which cv2 refuses, reads with each field
    shifted up into the high bits, as cv2 expands 5- and 6-bit fields."""
    grey = _full_range(11, 19, 8, 1)[..., 0]
    p = tmp_path / "g.bmp"
    assert cv2.imwrite(str(p), grey)
    assert p.read_bytes()[28] == 8
    np.testing.assert_array_equal(imagelib.decode_bmp(p.read_bytes()),
                                  np.repeat(grey[..., None], 3, -1))
    for got, want in _both_readers(p):
        np.testing.assert_array_equal(got, want)
    word = np.random.default_rng(9).integers(0, 1 << 16, (3, 5))
    stride = 12
    px = b"".join(r.astype("<u2").tobytes().ljust(stride, b"\0")
                  for r in word[::-1])
    for masks in ((0xF00, 0xF0, 0xF), (0xE000, 0x1F80, 0x7E)):
        data = _bmp(5, 3, 16, 3, px, masks=masks)
        assert _cv2_rgb(data) is None
        want = []
        for m in masks:
            shift = (m & -m).bit_length() - 1
            width = (m >> shift).bit_length()
            want.append(((word & m) >> shift) << (8 - width))
        np.testing.assert_array_equal(imagelib.decode_bmp(data),
                                      np.stack(want, -1).astype(np.uint8))


# ---------------------------------------------------------------------------
# TIFF
# ---------------------------------------------------------------------------

TIFF_COMPRESSIONS = {"none": (1, 1), "lzw": (5, 1), "lzw_predictor": (5, 2),
                     "deflate": (8, 1), "deflate_predictor": (8, 2),
                     "packbits": (32773, 1)}


@pytest.mark.parametrize("compression", list(TIFF_COMPRESSIONS))
@pytest.mark.parametrize("channels", [1, 3, 4], ids=["grey", "rgb", "rgba"])
@pytest.mark.parametrize("depth", [8, 16])
def test_tiff_cv2_written_matches_cv2(depth, channels, compression):
    """cv2's TIFFs (little-endian strips of 4 rows) of 8- and 16-bit grey,
    RGB and RGBA, uncompressed, LZW, Deflate (each with and without the
    horizontal predictor) and PackBits: decode_tiff equals cv2.imread
    (alpha dropped)."""
    comp, pred = TIFF_COMPRESSIONS[compression]
    rng = np.random.default_rng(depth + channels)
    img = rng.integers(0, 1 << depth, (19, 23, channels)).astype(
        np.uint8 if depth == 8 else np.uint16)
    img[2:9, 3:12] = img[0, 0]
    ok, buf = cv2.imencode(".tif", img[..., 0] if channels == 1 else img, [
        cv2.IMWRITE_TIFF_COMPRESSION, comp, cv2.IMWRITE_TIFF_PREDICTOR, pred,
        cv2.IMWRITE_TIFF_ROWSPERSTRIP, 4])
    assert ok
    got = decode_tiff(buf.tobytes())
    assert got.dtype == img.dtype
    np.testing.assert_array_equal(got, _cv2_rgb(buf.tobytes()))


@pytest.mark.parametrize("compression", [c for c in TIFF_COMPRESSIONS
                                         if c != "none"])
@pytest.mark.parametrize("layout", ["strips", "tiles"])
@pytest.mark.parametrize("order", ["<", ">"], ids=["II", "MM"])
@pytest.mark.parametrize("depth", [8, 16])
def test_tiff_hand_encoded_matches_cv2(depth, order, layout, compression):
    """Hand-encoded TIFFs (cv2 writes no big-endian or tiled file): 8- and
    16-bit RGB, little- and big-endian, strips of 5 rows or 16x16 tiles
    (partial at the edges), LZW, Deflate (with and without the predictor)
    and PackBits: decode_tiff equals cv2.imread and the samples."""
    comp, pred = TIFF_COMPRESSIONS[compression]
    rng = np.random.default_rng(depth)
    img = rng.integers(0, 1 << depth, (19, 23, 3)).astype(
        np.uint8 if depth == 8 else np.uint16)
    img[3:9] = img[3, 0]
    data = _tiff(img, order, (16, 16) if layout == "tiles" else None, comp,
                 pred, rows_per_strip=5)
    got = decode_tiff(data)
    np.testing.assert_array_equal(got, img)
    np.testing.assert_array_equal(got, _cv2_rgb(data))


def test_tiff_uncompressed_tiles_palette_and_float():
    """Uncompressed tiles and strips in both byte orders (cv2 cannot read
    uncompressed 8-bit tiles, so those are held to their samples); the
    predictor tag on uncompressed data, which libtiff ignores; palette
    images with a 16-bit colour map (entries times 257, and arbitrary ones:
    the high bytes) and an 8-bit one; 32-bit float RGB and grey, tiled,
    big-endian, and cv2's own float files (the floating-point predictor):
    each equal to cv2.imread where cv2 reads it."""
    rng = np.random.default_rng(12)
    img = rng.integers(0, 256, (19, 23, 3)).astype(np.uint8)
    for order in "<>":
        np.testing.assert_array_equal(
            decode_tiff(_tiff(img, order, (16, 16))), img)
        data = _tiff(img, order, None, 1, 2, rows_per_strip=5)
        np.testing.assert_array_equal(decode_tiff(data), img
                                      - np.concatenate(
                                          [np.zeros_like(img[:, :1]),
                                           img[:, :-1]], 1))
        np.testing.assert_array_equal(decode_tiff(data), _cv2_rgb(data))
    pal = rng.integers(0, 256, (256, 3))
    idx = rng.integers(0, 256, (19, 23, 1)).astype(np.uint8)
    for cmap, order, tile in ((pal * 257, "<", None), (pal, ">", (16, 16)),
                              (rng.integers(0, 65536, (256, 3)), ">",
                               (16, 16))):
        data = _tiff(idx, order, tile, 8, photo=3, cmap=cmap)
        got = decode_tiff(data)
        np.testing.assert_array_equal(got, _cv2_rgb(data))
        want = cmap >> 8 if cmap.max() > 255 else cmap
        np.testing.assert_array_equal(got, want[idx[..., 0]])
    f = rng.random((19, 23, 3)).astype(np.float32) * 3.0
    for data in (_tiff(f, ">", (16, 16), 8),
                 _tiff(f[..., :1], "<", None, 5, rows_per_strip=7),
                 cv2.imencode(".tif", f)[1].tobytes(),
                 cv2.imencode(".tif", f[..., 0], [
                     cv2.IMWRITE_TIFF_COMPRESSION, 8])[1].tobytes()):
        got = decode_tiff(data)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, _cv2_rgb(data))


# ---------------------------------------------------------------------------
# PNM, PFM, Sun raster
# ---------------------------------------------------------------------------

PNM_HAND = {
    "p1": b"P1\n# bitmap\n5 2\n0 1 0 1 1\n1 0 0 0 1\n",
    "p1_packed_digits": b"P1\n5 2\n0101110001\n",
    "p2_maxval_100": b"P2\n# c\n5 1\n100\n0 1 50 99 100\n",
    "p2_16bit": b"P2 2 2 65535 0 65535 300 4\n",
    "p3": b"P3\n2 1\n255\n1 2 3 4 5 6\n",
    "p3_maxval_1000": b"P3\n2 1\n1000\n1 2 3 4 5 1000\n",
    "p4": b"P4\n5 2\n" + bytes([0b01011000, 0b10001000]),
    "p5_maxval_100": b"P5\n5 1\n100\n" + bytes([0, 1, 50, 99, 100]),
    "p5_maxval_1000": b"P5 5 1 1000\n" + np.array(
        [0, 1, 500, 999, 1000]).astype(">u2").tobytes(),
    "p6_maxval_15": b"P6\n1 1\n15\n" + bytes([1, 7, 15]),
}


@pytest.mark.parametrize("case", sorted(PNM_HAND))
def test_pnm_hand_encoded_matches_cv2(case):
    """Hand-encoded PNMs (P1-P6, comments, maxvals 1-65535, samples
    without separators in P1): decode_pnm equals cv2.imdecode, values and
    dtype (cv2 scales an ASCII file below maxval 256 to 0-255, keeps a
    binary one as stored, reads 1 as black in a bitmap)."""
    data = PNM_HAND[case]
    want = _cv2_rgb(data)
    got = imagelib.decode_pnm(data)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("binary", [0, 1], ids=["ascii", "binary"])
@pytest.mark.parametrize("suffix", [".ppm", ".pgm", ".pbm", ".pnm"])
def test_pnm_cv2_written_matches_cv2(tmp_path, suffix, binary):
    """cv2's PPM, PGM, PBM and PNM files, ASCII and binary, 8-bit and (PPM)
    16-bit: load_image's samples equal cv2.imread, and load_image is
    the samples / 255 (or / 65535) sRGB-decoded, or not with `linear`."""
    rng = np.random.default_rng(len(suffix) + binary)
    img = rng.integers(0, 256, (7, 9, 3), dtype=np.uint8)
    src = {".ppm": img, ".pnm": img, ".pgm": img[..., 0],
           ".pbm": (img[..., 0] > 128).astype(np.uint8) * 255}[suffix]
    p = tmp_path / f"t{suffix}"
    assert cv2.imwrite(str(p), src, [cv2.IMWRITE_PXM_BINARY, binary])
    want = _cv2_rgb(p.read_bytes())
    samples = imagelib.decode_samples(p)
    np.testing.assert_array_equal(samples, want)
    norm = want / np.float32(255.0)
    np.testing.assert_array_equal(imagelib.load_image(p, linear=True), norm)
    np.testing.assert_allclose(imagelib.load_image(p),
                               imagelib.srgb_to_linear(norm), rtol=1e-6)
    if suffix == ".ppm":
        i16 = rng.integers(0, 65536, (7, 9, 3)).astype(np.uint16)
        assert cv2.imwrite(str(p), i16, [cv2.IMWRITE_PXM_BINARY, binary])
        np.testing.assert_array_equal(imagelib.decode_samples(p),
                                      _cv2_rgb(p.read_bytes()))
        np.testing.assert_array_equal(
            imagelib.load_image(p, linear=True),
            _cv2_rgb(p.read_bytes()) / np.float32(65535.0))


def test_pfm_matches_cv2_and_jax(tmp_path):
    """cv2's PFMs (colour and grey, little-endian, rows bottom-up) and a
    hand-encoded big-endian one with scale 2: decode_pfm equals
    cv2.imread (the samples times 1 / |scale|), and load_image equals
    ignis_tpu's (float data is linear and taken as it is)."""
    rng = np.random.default_rng(4)
    f = (rng.random((7, 9, 3)) * 5).astype(np.float32)
    for img in (f, f[..., 0]):
        p = tmp_path / "t.pfm"
        assert cv2.imwrite(str(p), img)
        np.testing.assert_array_equal(imagelib.decode_pfm(p.read_bytes()),
                                      _cv2_rgb(p.read_bytes()))
        for got, want in _both_readers(p):
            np.testing.assert_array_equal(got, want)
    data = b"PF\n2 1\n2.0\n" + np.arange(6, dtype=">f4").tobytes()
    np.testing.assert_array_equal(imagelib.decode_pfm(data), _cv2_rgb(data))


def _ras(w, h, depth, rows, kind=1, cmap=None):
    """A Sun raster of [h, row bytes] rows (padded here to 16 bits), raw or
    byte-run encoded (type 2), with an optional [n, 3] colour map."""
    pad = rows.shape[1] % 2
    data = b"".join(r.tobytes() + b"\0" * pad for r in rows)
    if kind == 2:
        enc, i = bytearray(), 0
        while i < len(data):
            j = i
            while j < len(data) and data[j] == data[i] and j - i < 256:
                j += 1
            if j - i >= 3 or data[i] == 0x80:
                enc += (b"\x80\x00" if j - i == 1
                        else bytes([0x80, j - i - 1, data[i]]))
                i = j
            else:
                enc.append(data[i])
                i += 1
        data = bytes(enc)
    m = b"" if cmap is None else cmap.T.tobytes()
    return struct.pack(">8I", 0x59A66A95, w, h, depth, len(data), kind,
                       0 if cmap is None else 1, len(m)) + m + data


def test_sun_raster_matches_cv2(tmp_path):
    """Sun rasters: cv2's own (24-bit, raw) and hand-encoded 24- and 32-bit
    raw files, 8- and 1-bit with a colour map, equal to cv2.imread; the
    byte-run encoded (type 2, a 0x80 literal included) and RGB-order
    (type 3) files, and map-less 8- and 1-bit ones, which cv2 does not
    read, equal to their pixels (grey levels; 1 is black)."""
    rng = np.random.default_rng(6)
    h, w = 3, 5
    px = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    px[1, :3] = 0x80
    p = tmp_path / "t.ras"
    assert cv2.imwrite(str(p), px[..., ::-1])
    for data in (p.read_bytes(), _ras(w, h, 24, px[..., ::-1].reshape(h, -1))):
        np.testing.assert_array_equal(imagelib.decode_sun_raster(data), px)
        np.testing.assert_array_equal(imagelib.decode_sun_raster(data),
                                      _cv2_rgb(data))
    px4 = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
    data = _ras(w, h, 32, px4.reshape(h, -1))
    np.testing.assert_array_equal(imagelib.decode_sun_raster(data),
                                  _cv2_rgb(data))
    idx = rng.integers(0, 4, (h, w), dtype=np.uint8)
    idx[0] = 0x80 % 4
    cmap = rng.integers(0, 256, (4, 3), dtype=np.uint8)
    bits = np.packbits(rng.integers(0, 2, (h, 16), dtype=np.uint8), axis=1)
    cm2 = np.array([[10, 20, 30], [200, 100, 50]], np.uint8)
    for data in (_ras(w, h, 8, idx, 1, cmap), _ras(w, h, 1, bits, 1, cm2)):
        np.testing.assert_array_equal(imagelib.decode_sun_raster(data),
                                      _cv2_rgb(data))
    held = [(_ras(w, h, 24, px[..., ::-1].reshape(h, -1), 2), px),
            (_ras(w, h, 24, px.reshape(h, -1), 3), px),
            (_ras(w, h, 32, px4.reshape(h, -1), 3), px4[..., 1:]),
            (_ras(w, h, 8, idx + 0x7E, 2, rng.integers(
                0, 256, (256, 3), dtype=np.uint8)), None),
            (_ras(w, h, 8, idx * 60), np.repeat((idx * 60)[..., None], 3,
                                                 -1)),
            (_ras(w, h, 1, bits), np.repeat(
                ((1 - np.unpackbits(bits, axis=1)[:, :w]) * 255)[..., None],
                3, -1))]
    for data, want in held:
        if want is None:      # the mapped RLE file: its own colour map
            cm = np.frombuffer(data, np.uint8, 768, 32).reshape(3, -1).T
            want = cm[idx + 0x7E]
        np.testing.assert_array_equal(imagelib.decode_sun_raster(data), want)
    (tmp_path / "t.sr").write_bytes(held[0][0])
    np.testing.assert_array_equal(imagelib.read_ldr(tmp_path / "t.sr"),
                                  px / np.float32(255.0))


# ---------------------------------------------------------------------------
# normalisation, refusals and the committed fixtures
# ---------------------------------------------------------------------------

def test_tiff_and_pnm_load_scaled_and_srgb_decoded(tmp_path):
    """load_image of an 8-bit TIFF or PPM is its samples / 255, of a
    16-bit TIFF / 65535, sRGB-decoded unless `linear`: the same as a PNG
    of the same samples (ignis_tpu returns the raw integers for these
    suffixes, ROADMAP queue 3); float TIFF data equals ignis_tpu's."""
    rng = np.random.default_rng(8)
    img = rng.integers(0, 256, (6, 10, 3), dtype=np.uint8)
    assert cv2.imwrite(str(tmp_path / "t.png"), img)
    for name in ("t.tif", "t.tiff", "t.ppm"):
        assert cv2.imwrite(str(tmp_path / name), img)
        for lin in (False, True):
            np.testing.assert_array_equal(
                imagelib.load_image(tmp_path / name, linear=lin),
                imagelib.load_image(tmp_path / "t.png", linear=lin))
    i16 = rng.integers(0, 65536, (6, 10, 3)).astype(np.uint16)
    assert cv2.imwrite(str(tmp_path / "w.tif"), i16)
    np.testing.assert_array_equal(
        imagelib.load_image(tmp_path / "w.tif", linear=True),
        i16[..., ::-1] / np.float32(65535.0))
    f = (rng.random((6, 10, 3)) * 4).astype(np.float32)
    assert cv2.imwrite(str(tmp_path / "f.tif"), f)
    for got, want in _both_readers(tmp_path / "f.tif"):
        np.testing.assert_array_equal(got, want)


@pytest.mark.xfail(strict=True, reason="ignis_tpu's load_image returns an "
                   "8-bit TIFF's raw 0-255 integers as linear radiance (a "
                   "reference fault the port fixes, ROADMAP queue 3)")
def test_unscaled_8bit_tiff_of_jax_reference(tmp_path):
    """The port's load_image of an 8-bit TIFF against ignis_tpu's: they
    differ by the reference's missing 1/255 (and sRGB decode)."""
    img = np.random.default_rng(10).integers(1, 256, (5, 6, 3),
                                             dtype=np.uint8)
    p = tmp_path / "t.tif"
    assert cv2.imwrite(str(p), img)
    for got, want in _both_readers(p):
        np.testing.assert_allclose(got, want, rtol=1e-6)


def _unported_file(kind):
    """(suffix, bytes) of a file this test held to its refusal: cv2's
    AVIF (read and written now), Pillow's BigTIFF (read now)."""
    import io

    from PIL import Image
    if kind == "avif":
        return ".avif", cv2.imencode(".avif", _full_range(8, 8, 1))[1] \
            .tobytes()
    bio = io.BytesIO()
    Image.fromarray(_full_range(9, 11, 2)).save(bio, "TIFF", big_tiff=True)
    return ".tif", bio.getvalue()


@pytest.mark.parametrize("kind,name", [("avif", "AVIF"),
                                       ("bigtiff", "BigTIFF")])
def test_unported_formats_refused_by_name(tmp_path, kind, name):
    """The formats once refused here by name are read now. BigTIFF
    (version 43, found by its content) reads to cv2's pixels, and
    load_image gives them / 255, as it gives a classic TIFF's. AVIF is
    read as cv2 reads it (tests/test_torch_avif.py), and save_image, which
    refused to write it by name, writes it as cv2 does
    (tests/test_torch_avif_writer.py): the file reads back through cv2.
    (JPEG 2000 is read and written: tests/test_torch_jpeg2000.py.)"""
    suffix, data = _unported_file(kind)
    p = tmp_path / f"t{suffix}"
    p.write_bytes(data)
    if kind == "avif":
        assert imagelib.sniff(data) == "avif"
        want = _cv2_rgb(data)
        np.testing.assert_array_equal(imagelib.decode_samples(p), want)
        np.testing.assert_array_equal(
            imagelib.load_image(p, linear=True),
            want.astype(np.float32) / np.float32(255.0))
        imagelib.save_image(p, np.zeros((4, 4, 3), np.float32))
        written = p.read_bytes()
        np.testing.assert_array_equal(imagelib.decode_samples(p),
                                      _cv2_rgb(written))
        return
    assert data[:4] == b"II+\0" and imagelib.sniff(data) == "tiff"
    want = _cv2_rgb(data)
    np.testing.assert_array_equal(imagelib.decode_samples(p), want)
    np.testing.assert_array_equal(imagelib.load_image(p, linear=True),
                                  want / np.float32(255.0))


FIXTURES = Path(__file__).resolve().parent / "data" / "images"


def test_committed_fixtures_match_cv2():
    """The fixtures of scripts/make_image_fixtures.py (a progressive 4:2:0
    JPEG, cv2's 8-bit palette BMP, a 16-bit LZW TIFF with the predictor, a
    PPM, a PFM) decode to cv2_pixels.npz (the JPEG within 1 level, the
    others exactly), and cv2 still reads each to those pixels."""
    want = np.load(FIXTURES / "cv2_pixels.npz")
    assert sorted(want.files) == sorted(
        p.name for p in FIXTURES.iterdir() if p.suffix != ".npz")
    for name in want.files:
        got = imagelib.decode_samples(FIXTURES / name)
        assert got.dtype == want[name].dtype, name
        tol = 1 if name.endswith(".jpg") else 0
        assert np.abs(got.astype(np.float64) - want[name]).max() <= tol, name
        np.testing.assert_array_equal(
            _cv2_rgb((FIXTURES / name).read_bytes()), want[name])


def test_texture_scene_of_fixtures_renders_on_cpu():
    """chip_smoke.texture_scene (a rectangle textured with each fixture)
    loads on the CPU with no texture refused, each texture's image equal
    to load_image of its file, and one step renders finite and not
    black, as phase 16 renders it on the card."""
    import json

    import torch

    import chip_smoke
    import ignis_tpu_torch
    scene = chip_smoke.texture_scene(32)
    rt = ignis_tpu_torch.loadFromString(json.dumps(scene), device="cpu",
                                        spi=1)
    assert rt.warnings == []
    assert len(scene["textures"]) == len(list(FIXTURES.glob("*.*"))) - 1
    rt.step()
    film = rt.framebuffer(normalized=True)
    assert bool(torch.isfinite(film).all()) and float(film.mean()) > 0.0


def test_texture_phase_parts_on_cpu(tmp_path):
    """Phase 16's host parts on the CPU: every save_image suffix written
    and read back (chip_smoke.writers_round_trip), the 1024 x 1024 files
    (WebP, JPEG, JPEG 2000, AVIF) decoded to cv2's pixels by their
    SHA-256 (decode_timing), and the
    texture scene's film bit-equal to that of its twin whose textures are
    PNGs of the decoded 8-bit pixels and EXRs of the 16-bit and float
    ones, as phase_textures renders both on the card."""
    import json

    import torch

    import chip_smoke
    import ignis_tpu_torch
    want = np.load(FIXTURES / "cv2_pixels.npz")
    out = chip_smoke.writers_round_trip(want["cv2_lossless.webp"], tmp_path)
    assert sorted(out) == sorted(chip_smoke.WRITER_SUFFIXES)
    assert len(chip_smoke.decode_timing()) == 5
    twins = {}
    for name in want.files:
        px = imagelib.decode_samples(FIXTURES / name)
        if px.dtype == np.uint8:
            twins[name] = tmp_path / f"{name}.png"
            twins[name].write_bytes(imagelib.encode_png(px))
        else:
            twins[name] = tmp_path / f"{name}.exr"
            imagelib.save_image(twins[name],
                                imagelib.load_image(FIXTURES / name))
    films = []
    for files in (None, twins):
        rt = ignis_tpu_torch.loadFromString(json.dumps(
            chip_smoke.texture_scene(16, files)), device="cpu", spi=1)
        rt.step()
        films.append(rt.framebuffer(normalized=True))
    assert torch.equal(*films)


# ---------------------------------------------------------------------------
# content before suffix: sniff and mislabelled files
# ---------------------------------------------------------------------------

def _signed_files():
    """(bytes, the decoder sniff must name) for every signature (JPEG
    2000 at 32 pixels a side, cv2's least)."""
    import io

    from PIL import Image
    img = _full_range(6, 7, 21)
    bgr = img[..., ::-1].copy()
    big = _full_range(33, 32, 23)
    j2k = io.BytesIO()
    Image.fromarray(_full_range(32, 33, 22)).save(j2k, "JPEG2000",
                                                   no_jp2=True)

    def enc(ext, im=bgr, params=()):
        return cv2.imencode(ext, im, list(params))[1].tobytes()
    tiff = enc(".tif")
    return {
        "png": (enc(".png"), "png"), "jpeg": (enc(".jpg"), "jpeg"),
        "bmp": (enc(".bmp"), "bmp"), "tiff_ii": (tiff, "tiff"),
        "tiff_mm": (_tiff(img, ">"), "tiff"),
        "bigtiff": (_tiff(img, "<", big=True), "tiff"),
        "bigtiff_mm": (_tiff(img, ">", None, 5, 2, big=True), "tiff"),
        "pam": (enc(".pam"), "pam"),
        **{f"pnm_p{k}": (PNM_HAND[c], "pnm") for k, c in
           ((1, "p1"), (2, "p2_maxval_100"), (3, "p3"), (4, "p4"),
            (5, "p5_maxval_100"), (6, "p6_maxval_15"))},
        "pfm_colour": (enc(".pfm", bgr.astype(np.float32)), "pfm"),
        "pfm_grey": (enc(".pfm", bgr[..., 0].astype(np.float32)), "pfm"),
        "sun_raster": (enc(".sr"), "sun_raster"),
        "radiance": (enc(".hdr", bgr.astype(np.float32)), "hdr"),
        "rgbe": (b"#?RGBE\n\n-Y 1 +X 1\n\x80\x80\x80\x81", "hdr"),
        "gif87a": (b"GIF87a" + enc(".gif")[6:], "gif"),
        "gif89a": (enc(".gif"), "gif"), "webp": (enc(".webp"), "webp"),
        "avif": (enc(".avif"), "avif"),
        "jp2": (enc(".jp2", big), "jpeg2000"),
        "j2k": (j2k.getvalue(), "jpeg2000"),
        "tga": (_tga(2, 2, 1, 24, 0x20, bytes(6)), None),
        # a PAM header cut short: OpenCV reads nothing of it
        "unknown": (b"P7\nWIDTH 1\n", "pam"),
        "no_signature": (b"P8\nWIDTH 1\n", None)}


@pytest.mark.parametrize("case", sorted(_signed_files()))
def test_sniff_names_every_signature(tmp_path, case):
    """sniff picks the decoder by OpenCV's signatures (TGA has none), and
    a file's decoder follows its content under any suffix: a .dat file
    reads as cv2 reads the same bytes (BigTIFF and PAM too); a TGA reads
    by its suffix only; bytes no decoder claims, and a PAM header cut
    short, raise IOError, as in ignis_tpu."""
    data, kind = _signed_files()[case]
    assert imagelib.sniff(data) == kind
    p = tmp_path / "x.dat"
    p.write_bytes(data)
    if case == "unknown":
        assert _cv2_rgb(data) is None
        with pytest.raises(IOError):
            imagelib.decode_samples(p)
    elif kind is None:
        with pytest.raises(IOError, match="Cannot load image"):
            imagelib.decode_samples(p)
        if case == "tga":
            (tmp_path / "x.tga").write_bytes(data)
            assert imagelib.decode_samples(tmp_path / "x.tga").shape == \
                (1, 2, 3)
    else:
        want = _cv2_rgb(data)
        got = imagelib.decode_samples(p)
        if want is None:                       # hand-encoded, cv2 refuses
            assert got.ndim == 3
        else:
            assert got.dtype == want.dtype
            tol = 1 if kind == "jpeg" else 0
            assert np.abs(got.astype(np.float64) - want).max() <= tol


def _mislabelled(kind):
    """(bytes, the lying suffix) of a file whose suffix names another
    format, each suffix one ignis_tpu scales by 1/255."""
    img = _photo(21, 26, seed=4)
    bgr = img[..., ::-1].copy()
    data = {"jpeg_as_png": (".jpg", ".png"), "ppm_as_jpg": (".ppm", ".jpg"),
            "png_as_bmp": (".png", ".bmp"), "bmp_as_jpeg": (".bmp", ".jpeg"),
            "webp_as_png": (".webp", ".png"), "gif_as_jpg": (".gif", ".jpg"),
            "tiff_as_png": (".tif", ".png")}[kind]
    return cv2.imencode(data[0], bgr)[1].tobytes(), data[1]


@pytest.mark.parametrize("kind", ["jpeg_as_png", "ppm_as_jpg", "png_as_bmp",
                                  "bmp_as_jpeg", "webp_as_png", "gif_as_jpg",
                                  "tiff_as_png"])
def test_mislabelled_files_load_as_jax(tmp_path, kind):
    """A file whose suffix lies (a JPEG named .png, a PPM named .jpg, ...)
    loads in the port to the linear image ignis_tpu's load_image gives
    (cv2 finds the decoder by content too, and both scale 8-bit data by
    1/255 for these suffixes): sRGB-decoded and linear, JPEG within 1/255,
    the rest exactly."""
    data, suffix = _mislabelled(kind)
    p = tmp_path / f"x{suffix}"
    p.write_bytes(data)
    tol = 1.0 / 255.0 if kind.startswith("jpeg") else 0.0
    for got, want in _both_readers(p):
        assert got.shape == want.shape == (21, 26, 3)
        np.testing.assert_allclose(got, want, rtol=0, atol=tol)


# ---------------------------------------------------------------------------
# GIF
# ---------------------------------------------------------------------------

def _gif(sw, sh, gct, bg, frame, lct=None, x0=0, y0=0, transparent=None,
         min_size=8, interlace=False):
    """A one-frame GIF89a from the GIF specification: optional global and
    local colour tables, a frame at (x0, y0) of the logical screen, an
    optional transparent index, interlaced rows, LZW at min_size."""
    from ignis_tpu_torch.utils.gif import _lzw_encode
    h, w = frame.shape

    def flags(table):
        return 0 if table is None else 0x80 | (len(table).bit_length() - 2)
    out = b"GIF89a" + struct.pack("<HHBBB", sw, sh, flags(gct), bg, 0)
    if gct is not None:
        out += gct.astype(np.uint8).tobytes()
    if transparent is not None:
        out += b"\x21\xf9\x04\x01\0\0" + bytes([transparent]) + b"\0"
    out += b"\x2c" + struct.pack("<HHHHB", x0, y0, w, h, flags(lct)
                                 | (0x40 if interlace else 0))
    if lct is not None:
        out += lct.astype(np.uint8).tobytes()
    rows = frame
    if interlace:
        rows = frame[np.concatenate([np.arange(a, h, s) for a, s in
                                     ((0, 8), (4, 8), (2, 4), (1, 2))])]
    lzw = _lzw_encode(rows.reshape(-1), min_size)
    body = b"".join(bytes([len(lzw[i:i + 255])]) + lzw[i:i + 255]
                    for i in range(0, len(lzw), 255))
    return out + bytes([min_size]) + body + b"\0\x3b"


GIF_CASES = ["full", "partial_frame", "partial_transparent", "local_table",
             "local_table_only", "interlaced", "interlaced_local",
             "transparent_index_0"]


@pytest.mark.parametrize("case", GIF_CASES)
def test_gif_variants_match_cv2(case):
    """Hand-encoded GIFs: a frame smaller than the logical screen at an
    offset (the rest the background colour), transparent pixels (left at
    the background colour, as cv2 composes them), a local colour table
    with and without a global one, interlaced rows: decode_gif equals
    cv2.imdecode exactly (alpha dropped)."""
    rng = np.random.default_rng(len(case))
    gct = rng.integers(0, 256, (16, 3))
    lct = rng.integers(0, 256, (4, 3))
    fr = rng.integers(0, 16, (11, 13)).astype(np.uint8)
    data = {
        "full": lambda: _gif(13, 11, gct, 2, fr, min_size=4),
        "partial_frame": lambda: _gif(20, 15, gct, 2, fr, x0=5, y0=3,
                                      min_size=4),
        "partial_transparent": lambda: _gif(20, 15, gct, 7, fr, x0=2, y0=1,
                                            transparent=5, min_size=4),
        "local_table": lambda: _gif(13, 11, gct, 2, fr % 4, lct=lct,
                                    min_size=2),
        "local_table_only": lambda: _gif(16, 12, None, 0, fr % 4, lct=lct,
                                         x0=1, y0=1, min_size=2),
        "interlaced": lambda: _gif(13, 11, gct, 2, fr, min_size=4,
                                   interlace=True),
        "interlaced_local": lambda: _gif(13, 11, None, 0, fr % 4, lct=lct,
                                         min_size=3, interlace=True),
        "transparent_index_0": lambda: _gif(13, 11, gct, 0, fr, min_size=4,
                                            transparent=0),
    }[case]()
    from ignis_tpu_torch.utils.gif import decode_gif
    np.testing.assert_array_equal(decode_gif(data), _cv2_rgb(data))


@pytest.mark.parametrize("min_size", range(2, 9))
def test_gif_code_sizes_match_cv2(min_size):
    """GIFs at each LZW minimum code size 2-8 (random indices over the
    whole table, enough codes to fill the 4096-entry table and clear it):
    decode_gif equals cv2.imdecode."""
    from ignis_tpu_torch.utils.gif import decode_gif
    rng = np.random.default_rng(min_size)
    n = 1 << min_size
    frame = rng.integers(0, n, (160, 170)).astype(np.uint8)
    data = _gif(170, 160, rng.integers(0, 256, (max(n, 4), 3)), 1, frame,
                min_size=min_size)
    np.testing.assert_array_equal(decode_gif(data), _cv2_rgb(data))


def _pil_bytes(im, fmt, **kw) -> bytes:
    import io
    bio = io.BytesIO()
    im.save(bio, fmt, **kw)
    return bio.getvalue()


def test_pillow_gifs_match_cv2():
    """Pillow's interlaced 64-colour GIF, a transparent one (the
    background entry a colour of its own) and an animated one whose
    frames differ (the first is what cv2 reads): decode_gif equals
    cv2.imdecode."""
    from PIL import Image

    from ignis_tpu_torch.utils.gif import decode_gif
    rng = np.random.default_rng(3)
    idx = rng.integers(0, 16, (19, 23)).astype(np.uint8)
    idx[:, :4] = 3
    pal = Image.fromarray(idx, "P")
    pal.putpalette(rng.integers(0, 256, 48).tolist())
    frames = [Image.fromarray(_photo(17, 22, seed=s)).quantize(32)
              for s in range(3)]
    for data in (
            _pil_bytes(Image.fromarray(_photo(29, 35)).quantize(64), "GIF",
                       interlace=True),
            _pil_bytes(pal, "GIF", transparency=3, background=6,
                       optimize=False),
            _pil_bytes(frames[0], "GIF", save_all=True,
                       append_images=frames[1:], duration=50)):
        np.testing.assert_array_equal(decode_gif(data), _cv2_rgb(data))


@pytest.mark.parametrize("case", ["1x1", "9x14", "40x33", "flat_34x62"])
def test_gif_writer_matches_cv2(tmp_path, case):
    """encode_gif maps an image onto cv2's fixed 3-3-2 table with cv2's
    float32 dithering: its indices equal those of cv2's own GIF of the
    same pixels (read by Pillow; a flat colour whose errors reach a level's
    midpoint within float32's rounding included), cv2 reads the file back
    to the same pixels as its own, and save_image's GIF read back by cv2
    is no further from the 8-bit image than cv2's GIF of it, in mean and
    max."""
    from PIL import Image

    from ignis_tpu_torch.utils import gif
    img = {"1x1": lambda: np.array([[[200, 17, 99]]], np.uint8),
           "9x14": lambda: _photo(9, 14, seed=14),
           "40x33": lambda: _photo(40, 33, seed=33),
           "flat_34x62": lambda: np.full((34, 62, 3), (219, 42, 202),
                                         np.uint8)}[case]()
    theirs = cv2.imencode(".gif", img[..., ::-1].copy())[1].tobytes()
    ours = gif.encode_gif(img)
    want = np.array(Image.open(__import__("io").BytesIO(theirs)))
    np.testing.assert_array_equal(gif.dither_332(img), want)
    np.testing.assert_array_equal(_cv2_rgb(ours), _cv2_rgb(theirs))
    np.testing.assert_array_equal(gif.decode_gif(ours), _cv2_rgb(theirs))
    lin = imagelib.srgb_to_linear(img / np.float32(255.0)).astype(np.float32)
    ldr = (imagelib.linear_to_srgb(lin) * 255.0 + 0.5).astype(np.uint8)
    imagelib.save_image(tmp_path / "p.gif", lin)
    jax_image.save_image(str(tmp_path / "j.gif"), lin)
    errs = []
    for name in ("p.gif", "j.gif"):
        back = _cv2_rgb((tmp_path / name).read_bytes()).astype(np.int64)
        err = np.abs(back - ldr)
        errs.append((err.mean(), err.max()))
    assert errs[0][0] <= errs[1][0] and errs[0][1] <= errs[1][1], errs


# ---------------------------------------------------------------------------
# WebP: lossless (VP8L)
# ---------------------------------------------------------------------------

def _argb_channels(px):
    return [(px >> s) & 255 for s in (24, 16, 8, 0)]


def _from_channels(ch):
    a, r, g, b = [np.asarray(c, np.int64) & 255 for c in ch]
    return a << 24 | r << 16 | g << 8 | b


def _sub_pixels(a, b):
    return _from_channels([x - y for x, y in zip(_argb_channels(a),
                                                   _argb_channels(b))])


def _forward_predictor(px, modes):
    """The predictor transform's residuals of ARGB px [h, w] (RFC 9649
    4.1: 14 modes from the original neighbours, the rightmost pixel's
    top-right the first of its own row; row 0 and column 0 fixed)."""
    h, w = px.shape
    z = np.zeros_like(px)
    L, T, TL, TR = z.copy(), z.copy(), z.copy(), z.copy()
    L[:, 1:] = px[:, :-1]
    T[1:] = px[:-1]
    TL[1:, 1:] = px[:-1, :-1]
    TR[1:, :-1] = px[:-1, 1:]
    TR[1:, -1] = px[1:, 0]
    ch = _argb_channels

    def avg(a, b):
        return _from_channels([(x + y) >> 1 for x, y in zip(ch(a), ch(b))])

    def select():
        d = sum(np.abs(lc - tlc) - np.abs(tc - tlc)
                for lc, tc, tlc in zip(ch(L), ch(T), ch(TL)))
        return np.where(d <= 0, T, L)

    def full():
        return _from_channels([np.clip(a + b - c, 0, 255) for a, b, c in
                               zip(ch(L), ch(T), ch(TL))])

    def half():
        out = []
        for a, b in zip(ch(avg(L, T)), ch(TL)):
            d = a - b
            out.append(np.clip(a + np.where(d >= 0, d // 2, -((-d) // 2)),
                               0, 255))
        return _from_channels(out)
    black = np.full_like(px, 0xFF000000)
    preds = [black, L, T, TR, TL, avg(avg(L, TR), T), avg(L, TL),
             avg(L, T), avg(TL, T), avg(T, TR),
             avg(avg(L, TL), avg(T, TR)), select(), full(), half(),
             black, black]
    pred = np.choose(modes, preds)
    pred[1:, 0] = T[1:, 0]
    pred[0, 1:] = L[0, 1:]
    pred[0, 0] = 0xFF000000
    return _sub_pixels(px, pred)


def _delta(m, c):
    return (((m ^ 128) - 128) * ((c ^ 128) - 128)) >> 5


def _forward_cross_colour(px, mult):
    """libwebp's VP8LTransformColor with per-pixel multipliers."""
    a, r, g, b = _argb_channels(px)
    g2r, g2b, r2b = mult & 255, (mult >> 8) & 255, (mult >> 16) & 255
    nr = (r - _delta(g2r, g)) & 255
    nb = (b - _delta(g2b, g) - _delta(r2b, r)) & 255
    return _from_channels([a, nr, g, nb])


def _prefix_encode(v):
    """(symbol, extra bits, extra value) of a length or distance v >= 1."""
    d = v - 1
    if d < 4:
        return d, 0, 0
    top = d.bit_length() - 1
    second = (d >> (top - 1)) & 1
    return 2 * top + second, top - 1, d & ((1 << (top - 1)) - 1)


def _entropy_image(fields, img, rng, cache_bits=0, lz77=False,
                   meta_bits=0, level0=False):
    """Append an entropy-coded image of ARGB img [h, w] (RFC 9649 5) to
    fields: optional colour cache, meta prefix codes (level0), literals,
    cache hits, and backward references at distances 1, w, w + 1, w - 1
    (plane codes) and 7 (a plain distance) when lz77."""
    from ignis_tpu_torch.utils.webp import _write_code
    h, w = img.shape
    fields.append((int(bool(cache_bits)), 1))
    if cache_bits:
        fields.append((cache_bits, 4))
    meta = None
    if level0:
        fields.append((int(bool(meta_bits)), 1))
        if meta_bits:
            fields.append((meta_bits - 2, 3))
            mh, mw = -(-h // (1 << meta_bits)), -(-w // (1 << meta_bits))
            meta = rng.integers(0, 3, (mh, mw))
            meta.flat[0] = 2
            _entropy_image(fields, (meta << 8).astype(np.int64), rng)
    flat = img.reshape(-1).tolist()
    n = len(flat)
    size = 1 << cache_bits
    cache = [None] * size
    plane = [(1, 2), (w, 1), (w + 1, 3), (w - 1, 4), (7, 7 + 120)]
    tokens = []
    i = 0
    while i < n:
        best = None
        for dist, dcode in plane if lz77 else ():
            if 1 <= dist <= i:
                k = 0
                while i + k < n and k < 4096 and flat[i + k] == \
                        flat[i + k - dist]:
                    k += 1
                if k >= 3 and (best is None or k > best[0]):
                    best = (k, dcode)
        key = ((flat[i] * 0x1E35A7BD) & 0xFFFFFFFF) >> (32 - cache_bits) \
            if cache_bits else 0
        if best:
            tokens.append((i, "ref", best))
            step = best[0]
        elif cache_bits and cache[key] == flat[i]:
            tokens.append((i, "cache", key))
            step = 1
        else:
            tokens.append((i, "lit", flat[i]))
            step = 1
        for v in flat[i:i + step]:
            if cache_bits:
                cache[((v * 0x1E35A7BD) & 0xFFFFFFFF)
                      >> (32 - cache_bits)] = v
        i += step
    ngroups = int(meta.max()) + 1 if meta is not None else 1
    sizes = (280 + (size if cache_bits else 0), 256, 256, 256, 40)
    hist = [[np.zeros(s, np.int64) for s in sizes] for _ in range(ngroups)]
    syms = []
    for pos, kind, val in tokens:
        y, x = divmod(pos, w)
        g = int(meta[y >> meta_bits, x >> meta_bits]) if meta is not None \
            else 0
        if kind == "lit":
            parts = [(0, (val >> 8) & 255), (1, (val >> 16) & 255),
                     (2, val & 255), (3, val >> 24)]
        elif kind == "cache":
            parts = [(0, 280 + val)]
        else:
            ls, lb, lv = _prefix_encode(val[0])
            ds, db, dv = _prefix_encode(val[1])
            parts = [(0, 256 + ls), ("x", (lv, lb)), (4, ds),
                     ("x", (dv, db))]
        for a, v in parts:
            if a != "x":
                hist[g][a][v] += 1
        syms.append((g, parts))
    codes = [[_write_code(fields, hg) for hg in grp] for grp in hist]
    for g, parts in syms:
        for a, v in parts:
            if a == "x":
                fields.append(v)
            else:
                c, ln = codes[g][a]
                fields.append((int(c[v]), int(ln[v])))


def _vp8l_file(rgb, transforms=(), cache_bits=0, lz77=False, meta_bits=0,
               seed=0, palette=None):
    """A lossless WebP of uint8 [h, w, 3] RGB written from RFC 9649 with
    the given transforms in order ('predictor', 'cross_colour',
    'subtract_green', 'colour_indexing' over `palette` or the image's
    colours), the colour cache, backward references and meta prefix
    codes."""
    from ignis_tpu_torch.utils.webp import _pack
    rng = np.random.default_rng(seed)
    h, w, _ = rgb.shape
    px = 0xFF << 24 | rgb[..., 0].astype(np.int64) << 16 | \
        rgb[..., 1].astype(np.int64) << 8 | rgb[..., 2].astype(np.int64)
    fields = [(0x2F, 8), (w - 1, 14), (h - 1, 14), (0, 1), (0, 3)]
    for t in transforms:
        fields.append((1, 1))
        cw = px.shape[1]
        if t in ("predictor", "cross_colour"):
            bits = 2 if t == "predictor" else 3
            sh, sw = -(-h // (1 << bits)), -(-cw // (1 << bits))
            sub = rng.integers(0, 1 << 32, (sh, sw), dtype=np.int64)
            if t == "predictor":          # every mode, 14 and 15 included
                modes = np.arange(sh * sw).reshape(sh, sw) % 16
                sub = (sub & ~0xF00) | modes << 8
            fields += [(0 if t == "predictor" else 1, 2), (bits - 2, 3)]
            _entropy_image(fields, sub, rng)
            full = np.repeat(np.repeat(sub, 1 << bits, 0), 1 << bits,
                             1)[:h, :cw]
            px = _forward_predictor(px, (full >> 8) & 15) \
                if t == "predictor" else _forward_cross_colour(px, full)
        elif t == "subtract_green":
            fields.append((2, 2))
            a, r, g, b = _argb_channels(px)
            px = _from_channels([a, r - g, g, b - g])
        else:
            table = np.unique(px) if palette is None else palette
            n = len(table)
            bits = 3 if n <= 2 else 2 if n <= 4 else 1 if n <= 16 else 0
            fields += [(3, 2), (n - 1, 8)]
            stored = np.concatenate([table[:1], _sub_pixels(table[1:],
                                                            table[:-1])])
            _entropy_image(fields, stored[None, :], rng)
            idx = np.searchsorted(table, px)
            per, bpp = 1 << bits, 8 >> bits
            pw = -(-cw // per)
            packed = np.zeros((h, pw), np.int64)
            for k in range(per):
                col = idx[:, k::per]
                packed[:, :col.shape[1]] |= col << (k * bpp)
            px = 0xFF000000 | packed << 8
    fields.append((0, 1))
    _entropy_image(fields, px, rng, cache_bits, lz77, meta_bits, True)
    v, nb = zip(*fields)
    body = _pack(np.array(v, np.int64), np.array(nb, np.int64)).ljust(12,
                                                                       b"\0")
    body += b"\0" * (len(body) & 1)
    return b"RIFF" + struct.pack("<I", 12 + len(body)) + b"WEBPVP8L" + \
        struct.pack("<I", len(body)) + body


VP8L_CASES = {
    "predictor": dict(transforms=("predictor",)),
    "cross_colour": dict(transforms=("cross_colour",)),
    "subtract_green": dict(transforms=("subtract_green",)),
    "indexing_2": dict(transforms=("colour_indexing",), colours=2),
    "indexing_4": dict(transforms=("colour_indexing",), colours=4),
    "indexing_16": dict(transforms=("colour_indexing",), colours=11),
    "indexing_256": dict(transforms=("colour_indexing",), colours=200),
    "all_four": dict(transforms=("colour_indexing", "subtract_green",
                                 "cross_colour", "predictor"),
                     colours=7),
    "three_then_lz77_cache": dict(transforms=("subtract_green", "predictor",
                                              "cross_colour"),
                                  cache_bits=6, lz77=True),
    "colour_cache": dict(cache_bits=4),
    "lz77": dict(lz77=True),
    "meta_codes": dict(meta_bits=2, lz77=True, cache_bits=3),
}


@pytest.mark.parametrize("case", sorted(VP8L_CASES))
def test_vp8l_transforms_match_cv2(case):
    """Hand-encoded lossless WebPs (RFC 9649): each transform alone
    (predictor with all 16 mode values, cross-colour, subtract-green,
    colour indexing with 1-, 2-, 4- and 8-bit bundles), all four
    together, the colour cache, LZ77 backward references (plane codes
    and a plain distance), meta prefix codes: decode_webp equals
    cv2.imdecode and the source pixels."""
    from ignis_tpu_torch.utils.webp import decode_webp
    kw = dict(VP8L_CASES[case])
    colours = kw.pop("colours", None)
    rng = np.random.default_rng(len(case))
    img = _photo(19, 27, seed=len(case))
    img[5:9] = img[5, 0]                     # runs for the references
    if colours:
        pal = rng.integers(0, 256, (colours, 3)).astype(np.uint8)
        img = pal[rng.integers(0, colours, img.shape[:2])]
    data = _vp8l_file(img, seed=len(case), **kw)
    want = _cv2_rgb(data)
    assert want is not None
    np.testing.assert_array_equal(want, img)
    np.testing.assert_array_equal(decode_webp(data), want)


@pytest.mark.parametrize("shape", [(1, 1), (3, 5), (33, 47)],
                         ids=["1x1", "3x5", "33x47"])
def test_webp_writer_round_trip(tmp_path, shape):
    """encode_webp's lossless file (subtract-green, literal prefix codes)
    reads back through cv2.imdecode and decode_webp equal to its input:
    noise, a flat image (one-symbol codes), two colours; save_image's
    .webp reads back equal to the 8-bit sRGB image."""
    from ignis_tpu_torch.utils.webp import decode_webp, encode_webp
    rng = np.random.default_rng(shape[1])
    for img in (rng.integers(0, 256, shape + (3,), dtype=np.uint8),
                np.full(shape + (3,), 77, np.uint8),
                (rng.integers(0, 2, shape + (1,)) * np.array([10, 200, 30]))
                .astype(np.uint8)):
        data = encode_webp(img)
        np.testing.assert_array_equal(_cv2_rgb(data), img)
        np.testing.assert_array_equal(decode_webp(data), img)
    lin = rng.random(shape + (3,)).astype(np.float32)
    imagelib.save_image(tmp_path / "s.webp", lin)
    want = (imagelib.linear_to_srgb(lin) * 255.0 + 0.5).astype(np.uint8)
    np.testing.assert_array_equal(_cv2_rgb((tmp_path / "s.webp")
                                           .read_bytes()), want)


# ---------------------------------------------------------------------------
# WebP: lossy (VP8)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quality", [5, 50, 95])
@pytest.mark.parametrize("shape", [(1, 1), (1, 7), (17, 33), (64, 64),
                                   (31, 129)],
                         ids=["1x1", "1x7", "17x33", "64x64", "31x129"])
def test_vp8_lossy_matches_cv2(shape, quality):
    """cv2's lossy WebPs at qualities 5, 50 and 95 (segments with their
    quantiser and filter strengths, 4x4 and 16x16 luma modes, skipped
    macroblocks), of sizes that are and are not whole macroblocks, one
    pixel and one row included: decode_webp equals cv2.imdecode
    exactly."""
    from ignis_tpu_torch.utils.webp import decode_webp
    img = _photo(*shape, seed=quality) if min(shape) > 8 else \
        np.random.default_rng(quality).integers(0, 256, shape + (3,),
                                                dtype=np.uint8)
    data = cv2.imencode(".webp", img[..., ::-1].copy(),
                        [cv2.IMWRITE_WEBP_QUALITY, quality])[1].tobytes()
    assert data[12:16] == b"VP8 "
    np.testing.assert_array_equal(decode_webp(data), _cv2_rgb(data))


@pytest.mark.parametrize("method", range(7))
def test_vp8_pillow_methods_match_cv2(method):
    """Pillow's lossy WebPs at its `method` 0-6 (libwebp's speed / effort
    trade, which changes the mode and token choices), noise at quality 90
    beside a photo at 60: decode_webp equals cv2.imdecode."""
    from PIL import Image

    from ignis_tpu_torch.utils.webp import decode_webp
    rng = np.random.default_rng(method)
    for img, q in ((_photo(45, 61, seed=method), 60),
                   (rng.integers(0, 256, (20, 37, 3), dtype=np.uint8), 90)):
        data = _pil_bytes(Image.fromarray(img), "WEBP", quality=q,
                          method=method)
        np.testing.assert_array_equal(decode_webp(data), _cv2_rgb(data))


def _bool_encode(decisions) -> bytes:
    """RFC 6386 7.3's boolean encoder of (probability, bit) decisions,
    flushed by 40 zero bits at probability 128."""
    out = bytearray()
    rng, bottom, count = 255, 0, 24

    def carry():
        i = len(out) - 1
        while out[i] == 255:
            out[i] = 0
            i -= 1
        out[i] += 1
    for prob, bit in list(decisions) + [(128, 0)] * 40:
        split = 1 + (((rng - 1) * prob) >> 8)
        if bit:
            bottom += split
            rng -= split
        else:
            rng = split
        while rng < 128:
            rng <<= 1
            if bottom & (1 << 31):
                carry()
            bottom = (bottom << 1) & 0xFFFFFFFF
            count -= 1
            if count == 0:
                out.append(bottom >> 24)
                bottom &= (1 << 24) - 1
                count = 8
    return bytes(out)


def _vp8_variant(monkeypatch, data, simple, level, sharpness, deltas,
                 partitions):
    """cv2's lossy WebP re-encoded with another loop-filter header (simple
    or normal filter, level, sharpness, reference and mode deltas) and
    its tokens split into `partitions` partitions by macroblock row: every
    boolean decision of the original is recorded while decode_vp8 reads
    it, the filter header's decisions replaced, and the rest written
    again with RFC 6386's encoder."""
    from ignis_tpu_torch.utils import webp
    decoders, rows, header = [], [], {}
    base = webp._BoolDecoder

    class Recorder(base):
        def __init__(self, *args):
            super().__init__(*args)
            self.log = []
            decoders.append(self)

        def get(self, prob):
            bit = base.get(self, prob)
            self.log.append((prob, bit))
            return bit
    init, parse = webp._Header.__init__, webp._parse_modes

    def hdr_init(self, br):
        init(self, br)
        header.update(end=len(br.log), hdr=self)

    def modes(br, hdr, intra_t, intra_l, x):
        if x == 0:
            rows.append(len(decoders[1].log))
        return parse(br, hdr, intra_t, intra_l, x)
    with monkeypatch.context() as m:
        m.setattr(webp, "_BoolDecoder", Recorder)
        m.setattr(webp._Header, "__init__", hdr_init)
        m.setattr(webp, "_parse_modes", modes)
        payload = data[20:20 + struct.unpack("<I", data[16:20])[0]]
        webp.decode_vp8(payload)
    hdr, end = header["hdr"], header["end"]
    assert not hdr.use_delta and hdr.partitions == 1 and len(decoders) == 2

    def bits(v, n):
        return [(128, (v >> k) & 1) for k in range(n - 1, -1, -1)]
    head = decoders[0].log[:end - 13]         # up to the filter header
    new = head + [(128, simple)] + bits(level, 6) + bits(sharpness, 3)
    new.append((128, int(deltas is not None)))
    if deltas is not None:
        new.append((128, 1))
        for d in deltas:
            new += [(128, 1)] + bits(abs(d), 6) + [(128, int(d < 0))]
    new += bits(partitions.bit_length() - 1, 2) + decoders[0].log[end:]
    tokens = decoders[1].log
    bounds = rows + [len(tokens)]
    parts = [_bool_encode([t for r in range(k, len(rows), partitions)
                           for t in tokens[bounds[r]:bounds[r + 1]]])
             for k in range(partitions)]
    first = _bool_encode(new)
    tag = (payload[0] & 0x1F) | len(first) << 5
    frame = (struct.pack("<I", tag)[:3] + payload[3:10] + first
             + b"".join(struct.pack("<I", len(p))[:3] for p in parts[:-1])
             + b"".join(parts))
    frame += b"\0" * (len(frame) & 1)
    return b"RIFF" + struct.pack("<I", 12 + len(frame)) + b"WEBPVP8 " + \
        struct.pack("<I", len(frame)) + frame


VP8_FILTERS = {  # (simple, level, sharpness, deltas, partitions)
    "simple_level_20": (1, 20, 0, None, 1),
    "simple_level_63_sharp_5": (1, 63, 5, None, 1),
    "simple_deltas": (1, 30, 2, (5, -3, 0, 1, 9, -7, 2, 0), 2),
    "normal_sharp_3": (0, 40, 3, None, 1),
    "normal_sharp_7_level_9": (0, 9, 7, None, 4),
    "normal_deltas": (0, 25, 0, (-20, 4, 0, 0, 30, 1, -2, 0), 8),
    "no_filter_partitions": (0, 0, 0, None, 2),
}


@pytest.mark.parametrize("case", sorted(VP8_FILTERS))
def test_vp8_filter_variants_match_cv2(monkeypatch, case):
    """No writer here makes a VP8 frame with the simple loop filter,
    sharpness, loop-filter deltas or more than one token partition, so
    cv2's own frame (segments with their filter strengths) is written
    again with such a header (see _vp8_variant): decode_webp equals
    cv2.imdecode of the rewritten file, and the original still decodes
    as before."""
    from ignis_tpu_torch.utils.webp import decode_webp
    img = _photo(37, 53, seed=5)
    data = cv2.imencode(".webp", img[..., ::-1].copy(),
                        [cv2.IMWRITE_WEBP_QUALITY, 30])[1].tobytes()
    variant = _vp8_variant(monkeypatch, data, *VP8_FILTERS[case])
    want = _cv2_rgb(variant)
    assert want is not None
    if VP8_FILTERS[case][1]:
        assert not np.array_equal(want, _cv2_rgb(data))
    np.testing.assert_array_equal(decode_webp(variant), want)
    np.testing.assert_array_equal(decode_webp(data), _cv2_rgb(data))


def test_webp_alpha_and_animation_match_cv2():
    """Pillow's WebPs with alpha (lossy: VP8X + ALPH; lossless, with and
    without `exact`) and animations (lossy and lossless; cv2 reads the
    first frame): decode_webp equals cv2.imdecode, alpha dropped."""
    from PIL import Image

    from ignis_tpu_torch.utils.webp import decode_webp
    rng = np.random.default_rng(8)
    rgba = np.dstack([_photo(33, 45), rng.integers(0, 256, (33, 45),
                                                   dtype=np.uint8)])
    frames = [Image.fromarray(_photo(21, 26, seed=s)) for s in range(3)]
    files = [_pil_bytes(Image.fromarray(rgba, "RGBA"), "WEBP", **kw)
             for kw in (dict(quality=60), dict(lossless=True),
                        dict(lossless=True, exact=True))]
    assert files[0][12:16] == b"VP8X" and b"ALPH" in files[0]
    files += [_pil_bytes(frames[0], "WEBP", save_all=True,
                         append_images=frames[1:], **kw)
              for kw in (dict(quality=50), dict(lossless=True))]
    for data in files:
        np.testing.assert_array_equal(decode_webp(data), _cv2_rgb(data))


# ---------------------------------------------------------------------------
# JPEG: CMYK and RGB
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["cmyk", "cmyk_420", "cmyk_progressive",
                                     "rgb", "rgb_progressive"])
@pytest.mark.parametrize("shape", [(1, 5), (16, 16), (37, 53)],
                         ids=["1x5", "16x16", "37x53"])
def test_cmyk_and_rgb_jpeg_match_cv2(shape, variant):
    """Pillow's CMYK JPEGs (Adobe transform 0, four inverted components,
    4:4:4 or 4:2:0, baseline or progressive) and untransformed RGB JPEGs
    (keep_rgb): decode_jpeg within 1 level of cv2.imread (its CMYK ->
    BGR conversion); a YCCK frame (Adobe transform 2), which this test
    once held to NotImplementedError, within 1 level too (libjpeg's YCC
    to inverted CMYK, then cv2's conversion)."""
    from PIL import Image
    img = Image.fromarray(_photo(*shape, seed=len(variant)))
    kw = dict(quality=90, progressive=variant.endswith("progressive"))
    if variant.startswith("cmyk"):
        img = img.convert("CMYK")
        if variant.endswith("420"):
            kw["subsampling"] = 2
    else:
        kw["keep_rgb"] = True
    data = _pil_bytes(img, "JPEG", **kw)
    ref = _cv2_rgb(data).astype(int)
    assert np.abs(decode_jpeg(data).astype(int) - ref).max() <= 1
    if variant == "cmyk":
        pos = data.index(b"\xff\xeeAdobe"[:2]) + 15
        assert data[pos] == 0
        ycck = data[:pos] + b"\x02" + data[pos + 1:]
        assert np.abs(decode_jpeg(ycck).astype(int)
                      - _cv2_rgb(ycck)).max() <= 1


# ---------------------------------------------------------------------------
# the writers of save_image
# ---------------------------------------------------------------------------

WRITER_SUFFIXES = [".tif", ".tiff", ".ppm", ".pnm", ".pam", ".pfm", ".sr",
                   ".ras", ".pic", ".webp", ".jpe", ".dib"]


@pytest.mark.parametrize("suffix", WRITER_SUFFIXES)
def test_save_image_writers_match_jax(tmp_path, suffix):
    """save_image and ignis_tpu's save_image (cv2.imwrite of the 8-bit
    sRGB image) of the same float image, read back by cv2.imread, give
    the same pixels (PFM as 0-255 floats, .pic as RGBE of the 8-bit image
    / 255, as cv2 writes both); .jpe within 0.5 dB PSNR of cv2's file, as
    test_jpeg_writer_matches_cv2_quality holds .jpg; the port reads its
    own file back as cv2 does."""
    rgb = _photo(27, 35, seed=len(suffix))
    lin = imagelib.srgb_to_linear(rgb / np.float32(255.0)).astype(np.float32)
    ldr = (imagelib.linear_to_srgb(lin) * 255.0 + 0.5).astype(np.uint8)
    imagelib.save_image(tmp_path / f"p{suffix}", lin)
    jax_image.save_image(str(tmp_path / f"j{suffix}"), lin)
    ours = _cv2_rgb((tmp_path / f"p{suffix}").read_bytes())
    theirs = _cv2_rgb((tmp_path / f"j{suffix}").read_bytes())
    if suffix == ".jpe":
        def psnr(a):
            return 10 * np.log10(255.0 ** 2 / np.mean(
                (a.astype(np.float64) - ldr) ** 2))
        assert psnr(ours) >= psnr(theirs) - 0.5, (psnr(ours), psnr(theirs))
    else:
        assert ours.dtype == theirs.dtype
        np.testing.assert_array_equal(ours, theirs)
    got = imagelib.decode_samples(tmp_path / f"p{suffix}")
    assert np.abs(got.astype(np.float64) - ours).max() <= (
        1 if suffix == ".jpe" else 0)


def test_save_image_grey_formats_and_unknown_suffix_raise(tmp_path):
    """.pgm and .pbm of a colour image, which cv2 refuses (ignis_tpu's
    save_image then writes no file), raise ValueError naming the suffix;
    so does a suffix no writer takes."""
    img = np.random.default_rng(2).random((4, 5, 3)).astype(np.float32)
    for suffix in (".pgm", ".pbm"):
        with pytest.raises(ValueError, match=f"'{suffix}'"):
            imagelib.save_image(tmp_path / f"p{suffix}", img)
        jax_image.save_image(str(tmp_path / f"j{suffix}"), img)
        assert not (tmp_path / f"j{suffix}").exists()
        assert not (tmp_path / f"p{suffix}").exists()
    with pytest.raises(ValueError, match="'.xyz'"):
        imagelib.save_image(tmp_path / "p.xyz", img)


@pytest.mark.xfail(strict=True, reason="ignis_tpu's load_image returns a "
                   "GIF's raw 0-255 integers as linear radiance (it scales "
                   "only .png, .jpg, .jpeg, .bmp and .tga; a reference "
                   "fault the port fixes, ROADMAP queue 3)")
def test_unscaled_8bit_gif_of_jax_reference(tmp_path):
    """The port's load_image of cv2's GIF against ignis_tpu's: they differ
    by the reference's missing 1/255 (and sRGB decode)."""
    p = tmp_path / "t.gif"
    assert cv2.imwrite(str(p), _full_range(5, 6, 11))
    for got, want in _both_readers(p):
        np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.xfail(strict=True, reason="ignis_tpu's load_image returns a "
                   "WebP's raw 0-255 integers as linear radiance (a "
                   "reference fault the port fixes, ROADMAP queue 3)")
def test_unscaled_8bit_webp_of_jax_reference(tmp_path):
    """The port's load_image of cv2's lossless WebP against ignis_tpu's:
    they differ by the reference's missing 1/255 (and sRGB decode)."""
    p = tmp_path / "t.webp"
    assert cv2.imwrite(str(p), _full_range(5, 6, 12))
    for got, want in _both_readers(p):
        np.testing.assert_allclose(got, want, rtol=1e-6)


# ---------------------------------------------------------------------------
# PAM
# ---------------------------------------------------------------------------

def _pam(tail=b"", **fields):
    return ("P7\n" + "".join(f"{k} {v}\n" for k, v in fields.items())
            ).encode() + b"ENDHDR\n" + tail


PAM_CASES = {
    "grey": _pam(bytes(range(6)), WIDTH=3, HEIGHT=2, DEPTH=1, MAXVAL=255,
                 TUPLTYPE="GRAYSCALE"),
    "grey_no_tupltype": _pam(bytes(range(6)), WIDTH=3, HEIGHT=2, DEPTH=1,
                             MAXVAL=255),
    "grey_maxval_100": _pam(bytes([0, 1, 50, 99, 100, 7]), WIDTH=3,
                            HEIGHT=2, DEPTH=1, MAXVAL=100,
                            TUPLTYPE="GRAYSCALE"),
    "grey_16bit": _pam(np.array([1, 40000], ">u2").tobytes(), WIDTH=2,
                       HEIGHT=1, DEPTH=1, MAXVAL=65535,
                       TUPLTYPE="GRAYSCALE"),
    "grey_alpha": _pam(bytes(range(6)), WIDTH=3, HEIGHT=1, DEPTH=2,
                       MAXVAL=255, TUPLTYPE="GRAYSCALE_ALPHA"),
    "grey_alpha_16bit": _pam(np.array([299, 2], ">u2").tobytes(), WIDTH=1,
                             HEIGHT=1, DEPTH=2, MAXVAL=300,
                             TUPLTYPE="GRAYSCALE_ALPHA"),
    "rgb": _pam(bytes(range(6)), WIDTH=2, HEIGHT=1, DEPTH=3, MAXVAL=255,
                TUPLTYPE="RGB"),
    "rgb_maxval_15": _pam(bytes([1, 7, 15, 0, 3, 9]), WIDTH=2, HEIGHT=1,
                          DEPTH=3, MAXVAL=15, TUPLTYPE="RGB"),
    "rgb_maxval_1000": _pam(np.array([1, 2, 3, 300, 400, 1000], ">u2")
                            .tobytes(), WIDTH=2, HEIGHT=1, DEPTH=3,
                            MAXVAL=1000, TUPLTYPE="RGB"),
    "rgb_alpha": _pam(bytes(range(8)), WIDTH=2, HEIGHT=1, DEPTH=4,
                      MAXVAL=255, TUPLTYPE="RGB_ALPHA"),
    "rgb_alpha_16bit": _pam(np.array([1, 2, 3, 4], ">u2").tobytes(),
                            WIDTH=1, HEIGHT=1, DEPTH=4, MAXVAL=65535,
                            TUPLTYPE="RGB_ALPHA"),
    "blackandwhite": _pam(bytes([0xFF, 0x80, 0, 1, 1, 0]), WIDTH=3,
                          HEIGHT=2, DEPTH=1, MAXVAL=1,
                          TUPLTYPE="BLACKANDWHITE"),
    "blackandwhite_wide": _pam(bytes([0xAA, 0x55] + [0] * 8 + [0x0F, 0xF0]
                                     + [0] * 8), WIDTH=10, HEIGHT=2,
                               DEPTH=1, MAXVAL=1),
    "blackandwhite_maxval_255": _pam(bytes([0xFF, 0x80, 0, 1, 1, 0]),
                                     WIDTH=3, HEIGHT=2, DEPTH=1, MAXVAL=255,
                                     TUPLTYPE="BLACKANDWHITE"),
    "maxval_0": _pam(bytes(1), WIDTH=1, HEIGHT=1, DEPTH=1, MAXVAL=0),
    "fields_in_any_order": _pam(bytes(range(6)), HEIGHT=1, WIDTH=2,
                                MAXVAL=255, DEPTH=3),
    "comments_tabs_crlf": (b"P7\r\n# a comment\r\nWIDTH\t2 \r\nHEIGHT  1\r\n"
                           b"DEPTH 3\r\nMAXVAL 255\r\n#\rTUPLTYPE RGB\r\n"
                           b"ENDHDR\r\n" + bytes(range(6))),
    "endhdr_with_a_value": (b"P7\nWIDTH 1\nHEIGHT 1\nDEPTH 1\nMAXVAL 255\n"
                            b"ENDHDR x\n" + bytes([9])),
    "trailing_data": _pam(bytes(range(10)), WIDTH=2, HEIGHT=1, DEPTH=3,
                          MAXVAL=255),
    # OpenCV reads nothing of these
    "truncated_header": b"P7\nWIDTH 1\n",
    "truncated_data": _pam(bytes(4), WIDTH=2, HEIGHT=1, DEPTH=3,
                           MAXVAL=255),
    "space_after_p7": b"P7 \nWIDTH 1\nHEIGHT 1\nDEPTH 1\nMAXVAL 255\n"
                      b"ENDHDR\n\0",
    "lower_case": b"P7\nwidth 1\nheight 1\ndepth 1\nmaxval 255\nendhdr\n\0",
    "comment_after_a_value": b"P7\nWIDTH 1 # w\nHEIGHT 1\nDEPTH 1\n"
                             b"MAXVAL 255\nENDHDR\n\0",
    "unknown_field": _pam(bytes(6), WIDTH=2, HEIGHT=1, DEPTH=3, FOO=7,
                          MAXVAL=255),
    "repeated_field": b"P7\nWIDTH 1\nHEIGHT 1\nDEPTH 1\nMAXVAL 255\n"
                      b"WIDTH 2\nENDHDR\n\0\0",
    "no_maxval": _pam(bytes(6), WIDTH=2, HEIGHT=1, DEPTH=3),
    "maxval_65536": _pam(bytes(4), WIDTH=1, HEIGHT=1, DEPTH=1,
                         MAXVAL=65536),
    "width_0": _pam(bytes(4), WIDTH=0, HEIGHT=1, DEPTH=1, MAXVAL=255),
    "depth_5": _pam(bytes(5), WIDTH=1, HEIGHT=1, DEPTH=5, MAXVAL=255),
    "depth_2_no_tupltype": _pam(bytes(6), WIDTH=3, HEIGHT=1, DEPTH=2,
                                MAXVAL=255),
    "depth_4_no_tupltype": _pam(bytes(8), WIDTH=2, HEIGHT=1, DEPTH=4,
                                MAXVAL=255),
    "grey_16bit_no_tupltype": _pam(bytes(4), WIDTH=2, HEIGHT=1, DEPTH=1,
                                   MAXVAL=300),
    "tupltype_of_another_depth": _pam(bytes(6), WIDTH=2, HEIGHT=1, DEPTH=3,
                                      MAXVAL=255, TUPLTYPE="GRAYSCALE"),
    "unknown_tupltype": _pam(bytes(6), WIDTH=2, HEIGHT=1, DEPTH=3,
                             MAXVAL=255, TUPLTYPE="FOO"),
    "blackandwhite_alpha": _pam(bytes(6), WIDTH=3, HEIGHT=1, DEPTH=2,
                                MAXVAL=1, TUPLTYPE="BLACKANDWHITE_ALPHA"),
    "grey_alpha_maxval_1": _pam(bytes(6), WIDTH=3, HEIGHT=1, DEPTH=2,
                                MAXVAL=1, TUPLTYPE="GRAYSCALE_ALPHA"),
}


def _cv2_pam(data):
    """cv2.imdecode of a PAM as [h, w, 3] RGB, or None where it reads
    nothing or throws (a width of 0)."""
    try:
        return _cv2_rgb(data)
    except cv2.error:
        return None


@pytest.mark.parametrize("case", sorted(PAM_CASES))
def test_pam_matches_cv2(tmp_path, case):
    """Hand-encoded PAMs (P7) from the PAM specification, each header
    field, TUPLTYPE and maxval, comments, CR LF line ends: decode_pam
    equals cv2.imdecode, values and dtype (samples as stored, 16 bits
    above maxval 255, the first three in OpenCV's BGR order, a maxval-1
    grey row's bytes read as bits); every header or file cv2 refuses
    raises IOError, as ignis_tpu's load_image raises for cv2's None."""
    data = PAM_CASES[case]
    want = _cv2_pam(data)
    assert imagelib.sniff(data) == "pam"
    p = tmp_path / "x.pam"
    p.write_bytes(data)
    if want is None:
        with pytest.raises(IOError):
            imagelib.decode_samples(p)
        if case != "width_0":          # cv2.imread throws on that one
            with pytest.raises(IOError):
                jax_image.load_image(str(p))
        return
    got = imagelib.decode_samples(p)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_pam_rgb_at_maxval_1_refused_by_name():
    """Three samples at maxval 1, which this test once held to
    NotImplementedError, read as OpenCV reads them: each row's first w
    bits as the pixels' grey, whatever the rest of its bytes. Four
    samples at maxval 1, which OpenCV reads nothing of, raise IOError (no
    PAM is refused by name any more)."""
    rng = np.random.default_rng(31)
    for h, w in ((1, 2), (5, 9), (7, 17)):
        for body in (rng.integers(0, 2, h * w * 3),
                     rng.integers(0, 256, h * w * 3)):
            data = _pam(body.astype(np.uint8).tobytes(), WIDTH=w, HEIGHT=h,
                        DEPTH=3, MAXVAL=1, TUPLTYPE="RGB")
            want = _cv2_rgb(data)
            got = imagelib.decode_pam(data)
            assert got.dtype == want.dtype == np.uint8
            np.testing.assert_array_equal(got, want)
    data = _pam(bytes(8), WIDTH=2, HEIGHT=1, DEPTH=4, MAXVAL=1,
                TUPLTYPE="RGB_ALPHA")
    assert _cv2_pam(data) is None
    with pytest.raises(IOError, match="4 samples of maxval 1"):
        imagelib.decode_pam(data)


@pytest.mark.parametrize("shape", [(1, 1), (9, 11), (23, 4)],
                         ids=["1x1", "9x11", "23x4"])
def test_pam_writer_byte_equal_to_jax(tmp_path, shape):
    """save_image('.pam') writes ignis_tpu's file byte for byte (cv2's
    P7 header without TUPLTYPE, the samples in BGR order), and both
    packages read it back: the port's samples are cv2's and the 8-bit
    sRGB image; ignis_tpu's load_image gives the same samples unscaled
    (it scales no .pam, as no .ppm: ROADMAP queue 3)."""
    lin = np.random.default_rng(sum(shape)).random(
        shape + (3,)).astype(np.float32)
    imagelib.save_image(tmp_path / "p.pam", lin)
    jax_image.save_image(str(tmp_path / "j.pam"), lin)
    data = (tmp_path / "p.pam").read_bytes()
    assert data == (tmp_path / "j.pam").read_bytes()
    assert data.startswith(f"P7\nWIDTH {shape[1]}\nHEIGHT {shape[0]}\n"
                           "DEPTH 3\nMAXVAL 255\nENDHDR\n".encode())
    ldr = (imagelib.linear_to_srgb(lin) * 255.0 + 0.5).astype(np.uint8)
    got = imagelib.decode_samples(tmp_path / "p.pam")
    np.testing.assert_array_equal(got, ldr)
    np.testing.assert_array_equal(got, _cv2_rgb(data))
    np.testing.assert_array_equal(
        jax_image.load_image(str(tmp_path / "p.pam")), got)


# ---------------------------------------------------------------------------
# OS/2 BMP
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bpp", [1, 4, 8, 24, 32])
@pytest.mark.parametrize("size", [(5, 7), (1, 1), (3, 33)],
                         ids=["5x7", "1x1", "3x33"])
def test_os2_bmp_matches_cv2(tmp_path, bpp, size):
    """OS/2 BMPs (the 12-byte BITMAPCOREHEADER, 3-byte palette entries,
    a full palette before the pixels; 1, 4, 8, 24 and 32 bits), from the
    BMP specification: decode_bmp equals cv2.imdecode, which reads them
    grey under ignis_tpu's flags (OpenCV's 0.299 / 0.587 / 0.114 in 14-bit
    fixed point), and load_image equals ignis_tpu's exactly, sRGB-decoded
    and linear."""
    from make_image_fixtures import os2_bmp
    rng = np.random.default_rng(bpp * 100 + size[1])
    h, w = size
    if bpp == 32:
        px = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
        stride = w * 4
        rows = b"".join(r[:, [2, 1, 0, 3]].tobytes() for r in px[::-1])
        data = (struct.pack("<2sIHHI", b"BM", 26 + len(rows), 0, 0, 26)
                + struct.pack("<IHHHH", 12, w, h, 1, 32) + rows)
        assert len(rows) == stride * h
    elif bpp == 24:
        data = os2_bmp(rng.integers(0, 256, (h, w, 3), dtype=np.uint8), 24)
    else:
        data = os2_bmp(rng.integers(0, 1 << bpp, (h, w), dtype=np.uint8),
                       bpp, rng.integers(0, 256, (1 << bpp, 3),
                                         dtype=np.uint8))
    want = _cv2_rgb(data)
    got = imagelib.decode_bmp(data)
    assert got.dtype == want.dtype and got.shape == (h, w, 3)
    np.testing.assert_array_equal(got, want)
    p = tmp_path / "x.bmp"
    p.write_bytes(data)
    for ours, theirs in _both_readers(p):
        np.testing.assert_array_equal(ours, theirs)


@pytest.mark.parametrize("case", ["os2_16bit", "os2_short_palette",
                                  "header_16", "os2_zero_width"])
def test_bmp_headers_cv2_refuses_raise_ioerror(tmp_path, case):
    """What OpenCV reads nothing of raises IOError, as ignis_tpu's
    load_image raises: a 16-bit OS/2 file, an OS/2 palette cut short
    (OpenCV reads 2^bpp entries), a 16-byte OS/2 2.x header, a width of
    0."""
    from make_image_fixtures import os2_bmp
    rows = bytes(8 * 3)
    data = {
        "os2_16bit": lambda: (struct.pack("<2sIHHI", b"BM", 50, 0, 0, 26)
                              + struct.pack("<IHHHH", 12, 3, 3, 1, 16)
                              + rows),
        "os2_short_palette": lambda: os2_bmp(
            np.zeros((3, 3), np.uint8), 8, np.zeros((20, 3), np.uint8)),
        "header_16": lambda: (struct.pack("<2sIHHI", b"BM", 54, 0, 0, 30)
                              + struct.pack("<IIIHH", 16, 3, 3, 1, 24)
                              + rows + bytes(3)),
        "os2_zero_width": lambda: (struct.pack("<2sIHHI", b"BM", 50, 0, 0,
                                               26)
                                   + struct.pack("<IHHHH", 12, 0, 3, 1, 24)
                                   + rows)}[case]()
    assert _cv2_rgb(data) is None
    p = tmp_path / "x.bmp"
    p.write_bytes(data)
    with pytest.raises(IOError):
        imagelib.load_image(p)
    with pytest.raises(IOError):
        jax_image.load_image(str(p))


# ---------------------------------------------------------------------------
# TIFF: sample types, bilevel, CMYK, JPEG, planar, BigTIFF
# ---------------------------------------------------------------------------

def _samples(dtype, shape, seed):
    """Random samples over a dtype's range (float: normal, 100 wide)."""
    rng = np.random.default_rng(seed)
    d = np.dtype(dtype)
    if d.kind == "f":
        return rng.normal(0, 100, shape).astype(d)
    info = np.iinfo(d)
    return rng.integers(info.min, info.max, shape, dtype=np.int64,
                        endpoint=True).astype(d)


@pytest.mark.parametrize("channels", [1, 3, 4], ids=["grey", "rgb", "rgba"])
@pytest.mark.parametrize("dtype", ["int8", "int16", "int32", "uint32",
                                   "float64"])
def test_tiff_cv2_sample_types_match_cv2(tmp_path, dtype, channels):
    """cv2's own TIFFs of signed 8-, 16- and 32-bit, unsigned 32-bit (LZW
    with the horizontal predictor) and float64 (uncompressed) samples:
    decode_tiff gives cv2.imread's dtype and values, and load_image gives
    ignis_tpu's float32 exactly (samples as they are, linear)."""
    img = _samples(dtype, (7, 9, channels), channels)
    p = tmp_path / "x.tif"
    assert cv2.imwrite(str(p), img[..., 0] if channels == 1 else img)
    want = _cv2_rgb(p.read_bytes())
    got = decode_tiff(p.read_bytes())
    assert got.dtype == want.dtype == np.dtype(dtype)
    np.testing.assert_array_equal(got, want)
    for ours, theirs in _both_readers(p):
        assert ours.dtype == np.float32
        np.testing.assert_array_equal(ours, theirs)
    with pytest.raises(ValueError, match="not LDR"):
        imagelib.read_ldr(p)


TIFF_CODECS = {"none": (1, 1), "lzw_predictor": (5, 2), "deflate": (8, 1),
               "deflate_predictor": (8, 2), "packbits": (32773, 1)}


@pytest.mark.parametrize("dtype,compression", [
    (d, c) for d in ("uint32", "int8", "int16", "int32", "float32",
                     "float64")
    for c in list(TIFF_CODECS) + (["lzw_float_predictor",
                                   "deflate_float_predictor"]
                                  if d.startswith("float") else [])])
def test_tiff_hand_encoded_sample_types_match_cv2(dtype, compression):
    """Hand-encoded RGB of every sample type, big-endian strips of 5 rows
    and little-endian 16 x 16 tiles, each codec, the horizontal
    predictor (libtiff sums any sample's bits as an unsigned integer,
    floats too) and, for floats, the floating-point predictor: equal to
    cv2.imread and to the samples."""
    if "float_predictor" in compression:
        comp, pred = (5 if compression.startswith("lzw") else 8), 3
    else:
        comp, pred = TIFF_CODECS[compression]
    img = _samples(dtype, (19, 23, 3), len(dtype) + comp)
    for data in (_tiff(img, ">", None, comp, pred, rows_per_strip=5),
                 _tiff(img, "<", (16, 16), comp, pred)):
        got = decode_tiff(data)
        assert got.dtype == img.dtype
        np.testing.assert_array_equal(got, img)
        if (comp, img.dtype.itemsize) != (1, 1):  # cv2's 8-bit tile fault
            np.testing.assert_array_equal(got, _cv2_rgb(data))


def _pil_tiff(im, **kw) -> bytes:
    import io
    bio = io.BytesIO()
    im.save(bio, "TIFF", **kw)
    return bio.getvalue()


@pytest.mark.parametrize("compression", ["none", "lzw", "deflate",
                                         "packbits"])
@pytest.mark.parametrize("photo", [0, 1], ids=["white_is_zero",
                                               "black_is_zero"])
def test_tiff_bilevel_matches_cv2(photo, compression):
    """1-bit TIFFs, white-is-zero and black-is-zero, uncompressed,
    PackBits, LZW and Deflate, in strips of 5 rows and LZW 16 x 16 tiles
    (rows padded to a byte): 0 and 255 as cv2.imread gives them; Pillow's
    bilevel files too."""
    from PIL import Image
    comp = {"none": 1, "lzw": 5, "deflate": 8, "packbits": 32773}[
        compression]
    bits = np.random.default_rng(photo + comp).integers(
        0, 2, (19, 23, 1)).astype(np.uint8)
    for data in (_tiff(bits, "<", None, comp, photo=photo, bits=1,
                       rows_per_strip=5),
                 _tiff(bits, ">", (16, 16), 5, photo=photo, bits=1)):
        got = decode_tiff(data)
        np.testing.assert_array_equal(got, _cv2_rgb(data))
        white = bits[..., 0] == photo
        np.testing.assert_array_equal(got[..., 0], white * 255)
    pil = {"none": None, "lzw": "tiff_lzw", "deflate": "tiff_adobe_deflate",
           "packbits": "packbits"}[compression]
    data = _pil_tiff(Image.fromarray(bits[..., 0] > 0), compression=pil)
    np.testing.assert_array_equal(decode_tiff(data), _cv2_rgb(data))


def test_tiff_grey_and_palette_depths_match_cv2():
    """Palettes of 1 bit (which OpenCV reads grey: 0.299 / 0.587 / 0.114
    of the map's colours, 14-bit fixed point), 4 bits and 8 bits;
    white-is-zero at 8 bits (inverted, as libtiff's RGBA reader inverts)
    and 16 bits (as stored): each equal to cv2.imread. 2-bit files and
    4-bit grey, which OpenCV reads nothing of, raise IOError."""
    rng = np.random.default_rng(31)
    for bits in (1, 4, 8):
        idx = rng.integers(0, 1 << bits, (9, 13, 1)).astype(np.uint8)
        cmap = rng.integers(0, 65536, (1 << bits, 3))
        data = _tiff(idx, "<", None, 5, photo=3, cmap=cmap,
                     bits=bits if bits < 8 else None, rows_per_strip=4)
        np.testing.assert_array_equal(decode_tiff(data), _cv2_rgb(data))
    for dt in (np.uint8, np.uint16):
        v = _samples(dt, (9, 13, 1), 3)
        data = _tiff(v, "<", None, 8, photo=0)
        np.testing.assert_array_equal(decode_tiff(data), _cv2_rgb(data))
    for bits, photo in ((2, 1), (2, 0), (2, 3), (4, 1), (4, 0)):
        v = rng.integers(0, 1 << bits, (5, 6, 1)).astype(np.uint8)
        data = _tiff(v, "<", None, 1, photo=photo, bits=bits,
                     cmap=rng.integers(0, 256, (1 << bits, 3))
                     if photo == 3 else None)
        assert _cv2_rgb(data) is None
        with pytest.raises(IOError):
            decode_tiff(data)


@pytest.mark.parametrize("layout", ["strips", "tiles", "planar"])
@pytest.mark.parametrize("compression", ["none", "lzw_predictor", "deflate",
                                         "packbits"])
def test_tiff_cmyk_matches_cv2(layout, compression):
    """8-bit CMYK (photometric 5), hand-encoded in strips, tiles or
    planes, each codec: equal to cv2.imread, which converts it as
    libtiff's RGBA reader does (R = (255 - K) * (255 - C) / 255,
    truncated), alpha dropped; Pillow's CMYK too. CMYK with an alpha
    sample, which OpenCV reads nothing of, raises IOError."""
    from PIL import Image
    comp, pred = TIFF_CODECS[compression]
    cmyk = _samples(np.uint8, (19, 23, 4), comp)
    data = _tiff(cmyk, ">" if layout == "tiles" else "<",
                 (16, 16) if layout == "tiles" else None, comp, pred,
                 photo=5, rows_per_strip=5, planar=layout == "planar")
    got = decode_tiff(data)
    np.testing.assert_array_equal(got, _cv2_rgb(data))
    k = 255 - cmyk[..., 3:].astype(np.int32)
    np.testing.assert_array_equal(
        got, (255 - cmyk[..., :3].astype(np.int32)) * k // 255)
    rgb = _full_range(13, 17, comp)
    data = _pil_tiff(Image.fromarray(rgb).convert("CMYK"),
                     compression=None if comp == 1 else "tiff_lzw")
    np.testing.assert_array_equal(decode_tiff(data), _cv2_rgb(data))
    five = _samples(np.uint8, (5, 6, 5), 1)
    data = _tiff(five, "<", None, comp, photo=5, tags=[(338, 3, [2])])
    assert _cv2_rgb(data) is None
    with pytest.raises(IOError):
        decode_tiff(data)


def _rgb_jpeg_ids_123(c):
    """A JPEG of RGB samples coded as they are (Pillow's keep_rgb) with
    component ids 1, 2, 3, which a JPEG reader alone would take for
    YCbCr: a TIFF's photometric says RGB."""
    import io

    from PIL import Image
    bio = io.BytesIO()
    Image.fromarray(np.ascontiguousarray(c)).save(bio, "JPEG", quality=90,
                                                  keep_rgb=True)
    b = bytearray(bio.getvalue())
    i = b.index(b"\xff\xc0")
    for k in range(b[i + 9]):
        b[i + 10 + 3 * k] = k + 1
    i = b.index(b"\xff\xda")
    for k in range(b[i + 4]):
        b[i + 5 + 2 * k] = k + 1
    return bytes(b)


@pytest.mark.parametrize("case", ["pil_rgb", "pil_ycbcr", "pil_grey",
                                  "ycbcr_420_strips_16", "ycbcr_420_strips_8",
                                  "ycbcr_420_tiles", "ycbcr_422_strips",
                                  "rgb_ids_123"])
def test_tiff_jpeg_matches_cv2(case):
    """JPEG-compressed TIFFs (compression 7): Pillow's RGB, YCbCr and grey
    files (JPEGTables before each strip's abbreviated stream), and
    hand-encoded 4:2:0 and 4:2:2 YCbCr (photometric 6) strips of 16 and 8
    rows and 16 x 16 tiles, and RGB (photometric 2) coded as it is under
    component ids a JPEG reader would take for YCbCr: within 1 level of
    cv2.imread (the bar of the port's JPEG reads; exact here)."""
    from PIL import Image
    rgb = _photo(37, 45, seed=len(case))
    ycc = [(530, 3, [2, 2])]
    data = {
        "pil_rgb": lambda: _pil_tiff(Image.fromarray(rgb),
                                     compression="jpeg", quality=90),
        "pil_ycbcr": lambda: _pil_tiff(Image.fromarray(rgb).convert("YCbCr"),
                                       compression="jpeg"),
        "pil_grey": lambda: _pil_tiff(Image.fromarray(rgb[..., 0]),
                                      compression="jpeg"),
        "ycbcr_420_strips_16": lambda: _tiff(
            rgb, "<", None, 7, photo=6, rows_per_strip=16, tags=ycc,
            encode=lambda c: encode_jpeg(c, 90)),
        "ycbcr_420_strips_8": lambda: _tiff(
            rgb, ">", None, 7, photo=6, rows_per_strip=8, tags=ycc,
            encode=lambda c: encode_jpeg(c, 75)),
        "ycbcr_420_tiles": lambda: _tiff(
            rgb, "<", (16, 16), 7, photo=6, tags=ycc,
            encode=lambda c: encode_jpeg(c, 90)),
        "ycbcr_422_strips": lambda: _tiff(
            rgb, "<", None, 7, photo=6, rows_per_strip=16,
            tags=[(530, 3, [2, 1])], encode=lambda c: _pil_jpeg_422(c)),
        "rgb_ids_123": lambda: _tiff(rgb, "<", None, 7, photo=2,
                                     rows_per_strip=16,
                                     encode=_rgb_jpeg_ids_123)}[case]()
    want = _cv2_rgb(data)
    got = decode_tiff(data)
    assert got.dtype == want.dtype == np.uint8
    assert np.abs(got.astype(np.int32) - want).max() <= 1


def _pil_jpeg_422(c):
    import io

    from PIL import Image
    bio = io.BytesIO()
    Image.fromarray(np.ascontiguousarray(c)).save(bio, "JPEG", quality=85,
                                                  subsampling=1)
    return bio.getvalue()


def test_tiff_jpeg_of_other_components_raises_ioerror():
    """A JPEG chunk whose components are not the image's samples (three
    in a grey file), which libtiff refuses, raises IOError."""
    rgb = _photo(16, 16)
    data = _tiff(rgb[..., :1], "<", None, 7, photo=1,
                 encode=lambda c: encode_jpeg(np.repeat(c, 3, -1)))
    assert _cv2_rgb(data) is None
    with pytest.raises(IOError):
        decode_tiff(data)


@pytest.mark.parametrize("dtype", ["uint8", "int8", "uint16", "int16",
                                   "uint32", "float32", "float64"])
@pytest.mark.parametrize("layout", ["strips", "tiles"])
def test_tiff_planar_matches_cv2(dtype, layout):
    """PlanarConfiguration 2 (each sample's strips or tiles after the
    previous sample's), LZW with the horizontal predictor and Deflate:
    8-bit samples equal cv2.imread (libtiff's RGBA reader takes planes);
    wider samples equal the samples, which OpenCV misreads (it reads the
    first plane's chunk as if chunky and leaves the rest unset)."""
    img = _samples(dtype, (19, 23, 3), len(dtype))
    tile = (16, 16) if layout == "tiles" else None
    for comp, pred in ((5, 2), (8, 1)):
        data = _tiff(img, "<", tile, comp, pred, planar=True,
                     rows_per_strip=5)
        got = decode_tiff(data)
        assert got.dtype == img.dtype
        np.testing.assert_array_equal(got, img)
        if img.dtype.itemsize == 1:
            np.testing.assert_array_equal(got, _cv2_rgb(data))


def test_tiff_unassociated_alpha_premultiplied_as_cv2():
    """8-bit RGBA with ExtraSamples 2 (unassociated alpha), chunky and
    planar, reads premultiplied ((c * a + 127) / 255), as libtiff's RGBA
    reader gives it to OpenCV; associated or unspecified alpha, and 16-bit
    samples, as stored: each equal to cv2.imread."""
    rng = np.random.default_rng(41)
    px = rng.integers(0, 256, (7, 9, 4)).astype(np.uint8)
    for extra in (None, 0, 1, 2):
        tags = [] if extra is None else [(338, 3, [extra])]
        for planar in (False, True):
            data = _tiff(px, "<", None, 5, 2, planar=planar, tags=tags)
            got = decode_tiff(data)
            np.testing.assert_array_equal(got, _cv2_rgb(data))
            want = px[..., :3].astype(np.int32)
            if extra == 2:
                want = (want * px[..., 3:].astype(np.int32) + 127) // 255
            np.testing.assert_array_equal(got, want)
    px16 = px.astype(np.uint16) * 257
    data = _tiff(px16, "<", None, 8, tags=[(338, 3, [2])])
    np.testing.assert_array_equal(decode_tiff(data), _cv2_rgb(data))
    np.testing.assert_array_equal(decode_tiff(data), px16[..., :3])


@pytest.mark.parametrize("compression", ["none", "lzw_predictor", "deflate",
                                         "packbits"])
@pytest.mark.parametrize("layout", ["strips", "tiles"])
@pytest.mark.parametrize("order", ["<", ">"], ids=["II", "MM"])
def test_bigtiff_matches_cv2(order, layout, compression):
    """BigTIFF (version 43, 20-byte IFD entries, LONG8 strip and tile
    offsets), hand-encoded: 16-bit RGB in both byte orders, strips and
    tiles, each codec, equal to cv2.imread and the samples; Pillow's
    8-bit BigTIFF too."""
    from PIL import Image
    comp, pred = TIFF_CODECS[compression]
    img = _samples(np.uint16, (19, 23, 3), comp)
    data = _tiff(img, order, (16, 16) if layout == "tiles" else None, comp,
                 pred, big=True, rows_per_strip=5)
    assert data[2:4] == (b"+\0" if order == "<" else b"\0+")
    np.testing.assert_array_equal(decode_tiff(data), img)
    np.testing.assert_array_equal(decode_tiff(data), _cv2_rgb(data))
    data = _pil_tiff(Image.fromarray(_full_range(9, 14, comp)),
                     big_tiff=True)
    np.testing.assert_array_equal(decode_tiff(data), _cv2_rgb(data))


@pytest.mark.parametrize("case", ["group4", "group3", "ycbcr_raw",
                                  "bad_bigtiff_header",
                                  "thunderscan_palette"])
def test_tiff_refusals(case):
    """CCITT Group 4 and Group 3 and YCbCr outside JPEG, which this test
    once held to NotImplementedError, read as cv2 reads them
    (tests/test_torch_ccitt.py, test_torch_tiff_rest.py); a BigTIFF header
    of another byte size, which is no TIFF, raises IOError; a
    ThunderScan-coded (32809) 4-bit palette, once refused by name, reads
    as cv2 reads it (tests/test_torch_thunderscan.py): here codes of zero
    bytes, runs of no pixels, so libtiff stops the strip at its first row
    and both read the colour map's first entry everywhere."""
    from PIL import Image
    bits = _full_range(12, 17, 5)[..., 0] > 128
    if case == "bad_bigtiff_header":
        data = b"II+\0\x04\0\0\0" + bytes(16)
        with pytest.raises(IOError):
            decode_tiff(data)
        return
    if case == "thunderscan_palette":
        data = _tiff(_full_range(8, 8, 1)[..., :1] >> 4, "<", None, 32809,
                     photo=3, bits=4, cmap=np.zeros((16, 3), np.uint16),
                     encode=lambda c: bytes(len(c)))
        np.testing.assert_array_equal(decode_tiff(data), _cv2_rgb(data))
        return
    if case == "ycbcr_raw":
        data = _tiff(_full_range(8, 8, 1), "<", None, 1, photo=6,
                     tags=[(530, 3, [1, 1])])
    else:
        data = _pil_tiff(Image.fromarray(bits), compression=case)
    np.testing.assert_array_equal(decode_tiff(data), _cv2_rgb(data))


NEW_FIXTURES = ["cv2_int8.tif", "cv2_int16.tif", "cv2_int32.tif",
                "cv2_sgilog.tif", "cv2_sgilog24.tif", "cv2_logl.tif",
                "env_sgilog_256x128.tif", "env_sgilog24_256x128.tif",
                "sgilog_tiles_be.tif", "sgilog24_strips.tif",
                "pil_ccitt_rle.tif", "pil_ccitt_rlew.tif", "pil_group3.tif",
                "pil_group3_2d.tif", "pil_group4_wide.tif",
                "group4_photo0_fill2.tif", "ycbcr_22_lzw.tif",
                "ycbcr_41_refbw.tif", "ycbcr_44_tiles.tif",
                "lossless_grey.jpg", "lossless_rgb_p7.jpg",
                "arith_seq_420.jpg", "arith_prog_dac.jpg", "ycck.jpg",
                "cmyk_no_adobe.jpg", "grid_2x1.avif", "grid_2x2_crop.avif",
                "rgb_maxval1.pam", "lab_8bit.tif", "uint64_grey.tif",
                "cv2_uint32.tif", "cv2_float64.tif", "cv2_default.pam",
                "pil_bilevel.tif", "pil_cmyk.tif", "pil_jpeg.tif",
                "pil_jpeg_ycbcr.tif", "pil_int32.tif", "pil_bigtiff.tif",
                "planar_strips.tif", "planar_tiles.tif",
                "ycbcr_420_jpeg.tif", "os2_8bit.bmp", "os2_24bit.bmp",
                "rgb_alpha_16bit.pam", "grayscale_alpha.pam",
                "blackandwhite.pam"]


@pytest.mark.parametrize("name", NEW_FIXTURES)
def test_fixtures_load_as_jax(name):
    """Each fixture of the last two image slices (TIFF sample types,
    layouts and codecs, LogLuv, CCITT, YCbCr, CIELab, lossless,
    arithmetic and YCCK JPEG, AVIF grids, PAMs, OS/2 BMPs): decode_samples
    gives cv2's pixels (dtype, shape, values); load_image equals
    ignis_tpu's where ignis_tpu scales the suffix (.bmp, .jpg) or the
    samples are taken as they are (signed, 32- and 64-bit, float, LogLuv's
    radiance and LogL's int8 tones), exactly; for the 8- and 16-bit .tif,
    .pam and .avif files, which ignis_tpu returns unscaled (ROADMAP queue
    3), its values are the port's samples (of a grey-and-alpha PAM,
    ignis_tpu keeps both channels, alpha first: ROADMAP queue 3)."""
    want = np.load(FIXTURES / "cv2_pixels.npz")[name]
    got = imagelib.decode_samples(FIXTURES / name)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    for ours, theirs in _both_readers(FIXTURES / name):
        assert ours.dtype == theirs.dtype == np.float32
        if theirs.shape[-1] == 2:
            theirs = np.repeat(theirs[..., 1:], 3, -1)
        if name.endswith((".bmp", ".jpg")) or got.dtype not in (
                np.uint8, np.uint16):
            np.testing.assert_array_equal(ours, theirs)
        else:
            np.testing.assert_array_equal(theirs, got.astype(np.float32))


# ---------------------------------------------------------------------------
# TGA: a reference fault the port fixes
# ---------------------------------------------------------------------------

@pytest.mark.xfail(strict=True, raises=cv2.error, reason="ignis_tpu's "
                   "save_image hands '.tga' to cv2.imwrite, which has no TGA "
                   "writer in OpenCV 5.0.0 and raises cv2.error (a reference "
                   "fault the port fixes, ROADMAP queue 3)")
def test_tga_save_of_jax_reference(tmp_path):
    """save_image('.tga') writes a run-length TGA that the port reads
    back; ignis_tpu's save_image of the same image raises cv2.error."""
    lin = np.random.default_rng(4).random((5, 7, 3)).astype(np.float32)
    imagelib.save_image(tmp_path / "p.tga", lin)
    ldr = (imagelib.linear_to_srgb(lin) * 255.0 + 0.5).astype(np.uint8)
    np.testing.assert_array_equal(
        imagelib.decode_samples(tmp_path / "p.tga"), ldr)
    jax_image.save_image(str(tmp_path / "j.tga"), lin)


@pytest.mark.xfail(strict=True, raises=IOError, reason="ignis_tpu's "
                   "load_image reads a TGA through cv2.imread, which has no "
                   "TGA codec in OpenCV 5.0.0 and returns None, so it raises "
                   "IOError (a reference fault the port fixes, ROADMAP "
                   "queue 3)")
def test_tga_load_of_jax_reference(tmp_path):
    """load_image of the port's TGA gives its pixels / 255, sRGB-decoded;
    ignis_tpu's load_image of the same file raises IOError."""
    rgb = _full_range(4, 6, 5)
    p = tmp_path / "x.tga"
    p.write_bytes(imagelib.encode_tga(rgb))
    for ours, theirs in _both_readers(p):
        np.testing.assert_allclose(ours, theirs, rtol=1e-6)
