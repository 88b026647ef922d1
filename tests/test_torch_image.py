"""The port's own image codecs (ignis_tpu_torch/utils/image.py,
utils/jpeg.py, utils/tiff.py, utils/gif.py, utils/webp.py) against
OpenCV, through which ignis_tpu reads and writes images: BMP (every
depth, RLE, bit fields), PNG palette and Adam7 files, baseline,
progressive, CMYK and RGB JPEGs, TIFF, PNM, PFM, Sun raster, GIF and
WebP (lossless and lossy) read by the port and by cv2 or
`ignis_tpu.utils.image.load_image` on the same bytes, files found by
their content whatever their suffix, and every writer of save_image read
back by `cv2.imread` beside ignis_tpu's file of the same image.

cv2 (5.0.0) writes BMP, JPEG, GIF, WebP, TIFF and the other fixtures;
Pillow (12.1.0) writes the palette, transparent and animated GIFs, WebPs
with alpha, animations and its `method`s, and CMYK and RGB JPEGs. cv2
writes no palette or interlaced PNG, so those fixtures are encoded here
from the PNG specification and read by both sides. cv2 5.0.0 has no TGA
codec, so the TGA fixtures are encoded here from the TGA specification
and held to their pixels (ignis_tpu's load_image cannot read a TGA with
this cv2). Likewise the BMP, TIFF, Sun-raster and GIF variants cv2 does
not write, and lossless WebPs with each transform (RFC 9649), are
encoded here from their specifications and held to cv2.imread where cv2
reads them, else to their pixels; lossy WebPs with the filter headers no
writer here makes are cv2's own frames written again with another
header (RFC 6386's boolean encoder)."""
import struct
import zlib
from pathlib import Path

import cv2
import numpy as np
import pytest

from ignis_tpu.utils import image as jax_image
from ignis_tpu_torch.utils import image as imagelib
from ignis_tpu_torch.utils.jpeg import decode_jpeg, encode_jpeg
from ignis_tpu_torch.utils.tiff import decode_tiff


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
    is read (equal to cv2 within 1 level); the variants the port still
    does not decode are refused by name, not misread: the same file with
    an arithmetic-coded (SOF9), lossless (SOF3) or 12-bit frame header, and
    a four-component (CMYK) frame."""
    p = tmp_path / "p.jpg"
    assert cv2.imwrite(str(p), _photo(16, 16),
                       [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    data = p.read_bytes()
    ref = cv2.imread(str(p))[..., ::-1].astype(int)
    assert np.abs(decode_jpeg(data).astype(int) - ref).max() <= 1
    sof = data.index(b"\xff\xc2")
    for marker, prec, match in ((0xC9, 8, "arithmetic"), (0xC3, 8, "lossless"),
                                (0xC2, 12, "12-bit")):
        variant = bytearray(data)
        variant[sof + 1] = marker
        variant[sof + 4] = prec
        (tmp_path / "v.jpg").write_bytes(bytes(variant))
        with pytest.raises(NotImplementedError, match=match):
            imagelib.load_image(tmp_path / "v.jpg")
    variant = bytearray(data)
    variant[sof + 9] = 4                     # components
    with pytest.raises(NotImplementedError, match="4 components"):
        decode_jpeg(bytes(variant))


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
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, -1)
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

def _lzw_encode(data: bytes) -> bytes:
    """TIFF LZW as libtiff writes it: MSB-first codes from 9 bits, a clear
    code first, the width growing when the next code would not fit (the
    decoder's early change), a clear code when the table fills, EOI."""
    out, acc, nacc = bytearray(), 0, 0

    def put(code, width):
        nonlocal acc, nacc
        acc, nacc = acc << width | code, nacc + width
        while nacc >= 8:
            nacc -= 8
            out.append(acc >> nacc & 0xFF)
        acc &= (1 << nacc) - 1

    table = {bytes([i]): i for i in range(256)}
    width, nxt = 9, 258
    put(256, width)
    cur = b""
    for b in data:
        nxt_str = cur + bytes([b])
        if nxt_str in table:
            cur = nxt_str
            continue
        put(table[cur], width)
        table[nxt_str] = nxt
        nxt += 1
        if nxt == 4094:
            put(256, width)
            table = {bytes([i]): i for i in range(256)}
            width, nxt = 9, 258
        elif nxt > (1 << width) - 1:
            width += 1
        cur = bytes([b])
    if cur:
        put(table[cur], width)
        nxt += 1
        if nxt > (1 << width) - 1 and width < 12:
            width += 1
    put(257, width)
    if nacc:
        put(0, 8 - nacc)
    return bytes(out)


def _packbits(data: bytes) -> bytes:
    """PackBits: repeat runs of 2-128 bytes, literal runs up to 128."""
    out, i, n = bytearray(), 0, len(data)
    while i < n:
        j = i
        while j < n and data[j] == data[i] and j - i < 128:
            j += 1
        if j - i >= 2:
            out += bytes([257 - (j - i)]) + data[i:i + 1]
            i = j
            continue
        k = i + 1
        while k < n and k - i < 128 and not (k + 1 < n
                                             and data[k] == data[k + 1]):
            k += 1
        out += bytes([k - i - 1]) + data[i:k]
        i = k
    return bytes(out)


def _tiff(samples, order="<", tile=None, comp=1, predictor=1, photo=None,
          cmap=None, rows_per_strip=None):
    """A TIFF of [h, w, spp] uint8 / uint16 / float32 samples from the TIFF
    6.0 specification: byte order, strips or tiles, compression 1, 5, 8 or
    32773, predictor 2, palette (photometric 3 and a colour map)."""
    h, w, spp = samples.shape
    dt = samples.dtype
    photo = photo if photo is not None else (2 if spp >= 3 else 1)
    if tile:
        tw, th = tile
        chunks = []
        for y0 in range(0, h, th):
            for x0 in range(0, w, tw):
                c = np.zeros((th, tw, spp), dt)
                part = samples[y0:y0 + th, x0:x0 + tw]
                c[:part.shape[0], :part.shape[1]] = part
                chunks.append(c)
    else:
        rps = rows_per_strip or h
        chunks = [samples[y0:y0 + rps] for y0 in range(0, h, rps)]
    enc = []
    for c in chunks:
        c = c.copy()
        if predictor == 2:
            c[:, 1:] = c[:, 1:] - c[:, :-1]
        raw = c.astype(dt.newbyteorder(order)).tobytes()
        raw = {1: lambda r: r, 5: _lzw_encode, 8: zlib.compress,
               32773: _packbits}[comp](raw)
        enc.append(raw)
    tags = [(256, 4, [w]), (257, 4, [h]), (258, 3, [dt.itemsize * 8] * spp),
            (259, 3, [comp]), (262, 3, [photo]), (277, 3, [spp]),
            (284, 3, [1]), (339, 3, [3 if dt.kind == "f" else 1] * spp)]
    if tile:
        tags += [(322, 3, [tile[0]]), (323, 3, [tile[1]]),
                 (324, 4, None), (325, 4, [len(e) for e in enc])]
    else:
        tags += [(273, 4, None), (278, 4, [rows_per_strip or h]),
                 (279, 4, [len(e) for e in enc])]
    if predictor != 1:
        tags.append((317, 3, [predictor]))
    if cmap is not None:
        tags.append((320, 3, list(cmap.T.reshape(-1))))
    tags.sort()
    extra_at = 8 + 2 + 12 * len(tags) + 4
    extra_len = sum(len(v) * (2 if t == 3 else 4) for _, t, v in tags
                    if v is not None and len(v) * (2 if t == 3 else 4) > 4)
    extra_len += 4 * len(enc) if len(enc) > 1 else 0
    offsets = list(np.cumsum([extra_at + extra_len]
                             + [len(e) for e in enc[:-1]]))
    ifd, extra = struct.pack(order + "H", len(tags)), b""
    for tag, typ, vals in tags:
        vals = [int(v) for v in (offsets if vals is None else vals)]
        payload = struct.pack(order + ("H" if typ == 3 else "I") * len(vals),
                              *vals)
        if len(payload) <= 4:
            ifd += struct.pack(order + "HHI", tag, typ, len(vals)) + \
                payload.ljust(4, b"\0")
        else:
            ifd += struct.pack(order + "HHII", tag, typ, len(vals),
                               extra_at + len(extra))
            extra += payload
    magic = b"II*\0" if order == "<" else b"MM\0*"
    return (magic + struct.pack(order + "I", 8) + ifd + b"\0" * 4 + extra
            + b"".join(enc))


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
    """(suffix, bytes) of a file this test holds to its refusal: cv2's
    AVIF (read and written now), a BigTIFF header."""
    if kind == "avif":
        return ".avif", cv2.imencode(".avif", _full_range(8, 8, 1))[1] \
            .tobytes()
    return ".tif", b"II+\0\x08\0\0\0" + bytes(32)


@pytest.mark.parametrize("kind,name", [("avif", "AVIF"),
                                       ("bigtiff", "BigTIFF")])
def test_unported_formats_refused_by_name(tmp_path, kind, name):
    """BigTIFF raises NotImplementedError naming the format and the
    file's suffix, found by the file's content. AVIF, once refused here
    too, is read now as cv2 reads it (tests/test_torch_avif.py), and
    save_image, which refused to write it by name, writes it as cv2 does
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
    assert imagelib.sniff(data) == name
    with pytest.raises(NotImplementedError, match=f"{name} \\('{suffix}'"):
        imagelib.load_image(p)


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
        "bigtiff": (b"II+\0\x08\0\0\0" + bytes(16), "BigTIFF"),
        "bigtiff_mm": (b"MM\0+\0\x08\0\0" + bytes(16), "BigTIFF"),
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
        "unknown": (b"P7\nWIDTH 1\n", None)}


@pytest.mark.parametrize("case", sorted(_signed_files()))
def test_sniff_names_every_signature(tmp_path, case):
    """sniff picks the decoder by OpenCV's signatures (TGA has none), and
    a file's decoder follows its content under any suffix: a .dat file
    reads as cv2 reads the same bytes; a TGA reads by its suffix only;
    bytes no decoder claims raise IOError, as in ignis_tpu."""
    data, kind = _signed_files()[case]
    assert imagelib.sniff(data) == kind
    p = tmp_path / "x.dat"
    p.write_bytes(data)
    if kind == "BigTIFF":
        with pytest.raises(NotImplementedError, match=kind):
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
    BGR conversion), and a YCCK frame (Adobe transform 2) refused by
    name."""
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
        with pytest.raises(NotImplementedError, match="YCCK"):
            decode_jpeg(ycck)


# ---------------------------------------------------------------------------
# the writers of save_image
# ---------------------------------------------------------------------------

WRITER_SUFFIXES = [".tif", ".tiff", ".ppm", ".pnm", ".pfm", ".sr", ".ras",
                   ".pic", ".webp", ".jpe", ".dib"]


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
