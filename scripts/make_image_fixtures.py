"""Write the image fixtures of tests/data/images with OpenCV and Pillow,
and beside them `cv2_pixels.npz`: each file as cv2.imread reads it
(IMREAD_UNCHANGED | ANYDEPTH | ANYCOLOR), as [h, w, 3] RGB (grey
replicated, alpha dropped).

The port's decoders are held to these pixels where no OpenCV is at hand
(chip_smoke.py's texture phase runs on a machine without cv2 or Pillow;
the CPU tests compare with cv2 directly). Run from the repository's
root:

    python scripts/make_image_fixtures.py

The fixtures, each a few KB: OpenCV's progressive 4:2:0 JPEG, 8-bit
palette BMP (cv2 writes a grey image so), 16-bit RGB TIFF with LZW and
the horizontal predictor, binary 8-bit PPM, colour PFM, default GIF (its
fixed 3-3-2 table), lossless and quality-80 WebP, default 8-bit LZW
TIFF, Radiance .pic and Sun raster; Pillow's interlaced 64-colour,
transparent and animated GIFs, lossy WebP with alpha (VP8X + ALPH),
lossless WebP with its transforms, CMYK JPEG and untransformed RGB JPEG;
and a JPEG named .png, whose suffix lies about its content. JPEG 2000
(each at least 32 pixels a side): cv2's default .jp2 of a noisy image
(rate 4 truncates it), lossless 16-bit and grey .jp2; Pillow's
irreversible 9/7 with the colour transform, 3 quality layers and RPCL,
a raw code stream of 32 x 32 tiles (the last ones partial) with 16 x 16
code-blocks, 32 x 32 precincts, CPRL, 3 resolutions and PLT markers,
and an RGBA .jp2 in PCRL. cv2 reads no JPEG 2000 with an image offset,
so no fixture has one (tests/test_torch_jpeg2000.py holds offsets to
Pillow's OpenJPEG decode).

AVIF (each a few KB, some of odd size; tests/data/avif_tools.json lists
the AV1
coding tools each file switches on, read from its own headers and blocks
by utils/avif.py's coding_tools): cv2's default (no parameters:
base_q_idx 148 with delta q per superblock, 4:2:0 with quantiser
matrices, CDEF and deblocking), quality 0 at speed 10,
quality 50 at speed 0, lossless (quality 100: 4:4:4 under the identity
matrix), grey, 10- and 12-bit colour and 10-bit grey, and a screen-like
image (palette and intra block copy); Pillow's 4:2:0 in limited range,
4:2:2, 4:4:4 at speed 0, 4:0:0, 2 x 2 tiles, RGBA (an alpha item), an
animated `avis`, an EXIF-rotated file (irot and imir, which cv2 does not
apply), and one file per libaom switch: palette and intra block copy
(`tune-content=screen`), filter intra, CFL, loop restoration (Wiener
and self-guided), quantiser matrices, `deltaq-mode` (delta q),
`delta-lf-mode` (delta lf), chroma delta q, 64-point transforms,
sharpness, 128 x 128 superblocks and film grain.

Beside them, tests/data/images_1024 holds the decode-timing files of
chip_smoke.py's texture phase: one smooth 1024 x 1024 image as cv2's
quality-80 and lossless WebP, progressive JPEG, default .jp2
(lossless: the whole stream fits rate 4) and default AVIF, with the
SHA-256 of the pixels cv2 reads from each (`cv2_sha256.json`). `jp2_psnr.json` holds the PSNR
of cv2's default .jp2 of cv2_q80.webp's pixels against them, the bar of
chip_smoke's .jp2 writer (less 0.5 dB). `avif_bars.json` holds, for each
source of the AVIF writer's bars (`avif_sources`), the PSNR, file and AV1
payload bytes and base_q_idx of cv2's default AVIF of it: the port's
file must reach that PSNR less 0.5 dB within twice the payload
(tests/test_torch_avif_writer.py, chip_smoke.py's texture phase).
"""
import hashlib
import io
import json
import struct
import sys
import zlib
from pathlib import Path

import cv2
import numpy as np
from PIL import Image

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from ignis_tpu_torch.utils.avif import coding_tools  # noqa: E402
from ignis_tpu_torch.utils.jpeg import encode_jpeg  # noqa: E402

DATA = Path(__file__).resolve().parent.parent / "tests" / "data"
OUT = DATA / "images"
TIMING = DATA / "images_1024"
FLAGS = cv2.IMREAD_UNCHANGED | cv2.IMREAD_ANYDEPTH | cv2.IMREAD_ANYCOLOR


def smooth(h, w, seed, scale=255.0):
    """[h, w, 3] float64: smooth colour waves with a little noise and a
    bright square, in [0, scale]."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([0.5 + 0.45 * np.sin(xx / (5.0 + c) + c)
                    * np.cos(yy / 7.0 - c) for c in range(3)], -1)
    img += rng.normal(0, 0.03, img.shape)
    img[h // 4:h // 2, w // 4:w // 2] = 0.95
    return np.clip(img, 0, 1) * scale


def rgb8(h, w, seed):
    return smooth(h, w, seed).astype(np.uint8)


def noisy8(h, w, seed):
    """rgb8 with strong noise: more than OpenCV's JPEG 2000 rate of 4
    holds."""
    rng = np.random.default_rng(seed)
    return np.clip(smooth(h, w, seed) + rng.normal(0, 40, (h, w, 3)), 0,
                   255).astype(np.uint8)


# ---- files encoded here from their specifications -----------------------

def lzw_encode(data: bytes) -> bytes:
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


def packbits(data: bytes) -> bytes:
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


_TIFF_PACK = {3: "H", 4: "I", 7: "B", 16: "Q"}


def tiff_file(samples, order="<", tile=None, comp=1, predictor=1,
              photo=None, cmap=None, rows_per_strip=None, planar=False,
              big=False, bits=None, tags=(), encode=None):
    """A TIFF of [h, w, spp] samples (uint8 to uint32, int8 to int32,
    float32, float64) from the TIFF 6.0 specification, or from BigTIFF's
    (`big`: version 43, 20-byte entries, LONG8 offsets): byte order,
    strips or tiles, chunky or planar samples, compression 1, 5, 8 or
    32773 (or another with `encode`, which codes a chunk's [rows, cols,
    samples]), predictor 2, `bits` of 1, 2 or 4 (samples packed MSB first,
    rows padded to a byte), palette (photometric 3 and a colour map), and
    `tags`, more (tag, type, values)."""
    h, w, spp = samples.shape
    dt = samples.dtype
    nbits = bits or dt.itemsize * 8
    photo = photo if photo is not None else (2 if spp >= 3 else 1)
    planes = ([samples[..., k:k + 1] for k in range(spp)] if planar
              else [samples])
    chunks = []
    for plane in planes:
        if tile:
            tw, th = tile
            for y0 in range(0, h, th):
                for x0 in range(0, w, tw):
                    c = np.zeros((th, tw, plane.shape[2]), dt)
                    part = plane[y0:y0 + th, x0:x0 + tw]
                    c[:part.shape[0], :part.shape[1]] = part
                    chunks.append(c)
        else:
            rps = rows_per_strip or h
            chunks += [plane[y0:y0 + rps] for y0 in range(0, h, rps)]
    enc = []
    for c in chunks:
        if encode is not None:
            enc.append(encode(c))
            continue
        c = c.copy()
        if predictor == 2:          # on the bits, as unsigned integers
            u = c.view(f"u{dt.itemsize}")
            u[:, 1:] = u[:, 1:] - u[:, :-1]
        if predictor == 3:          # byte planes, most significant first
            rows, cols, n = c.shape
            b = c.astype(">" + dt.str[1:]).view(np.uint8).reshape(
                rows, cols, n, dt.itemsize).transpose(0, 3, 1, 2).reshape(
                    rows, -1).copy()
            b[:, n:] = b[:, n:] - b[:, :-n]
            enc.append({5: lzw_encode, 8: zlib.compress}[comp](b.tobytes()))
            continue
        if bits:
            b = np.unpackbits(c.astype(np.uint8)[..., None], axis=-1)[
                ..., 8 - bits:]
            raw = np.packbits(b.reshape(c.shape[0], -1), axis=1).tobytes()
        else:
            raw = c.astype(dt.newbyteorder(order)).tobytes()
        raw = {1: lambda r: r, 5: lzw_encode, 8: zlib.compress,
               32773: packbits}[comp](raw)
        enc.append(raw)
    kind = {"u": 1, "i": 2, "f": 3}[dt.kind]
    off_type = 16 if big else 4
    tags = [(256, 4, [w]), (257, 4, [h]), (258, 3, [nbits] * spp),
            (259, 3, [comp]), (262, 3, [photo]), (277, 3, [spp]),
            (284, 3, [2 if planar else 1]), (339, 3, [kind] * spp)] + list(
                tags)
    if tile:
        tags += [(322, 3, [tile[0]]), (323, 3, [tile[1]]),
                 (324, off_type, None), (325, 4, [len(e) for e in enc])]
    else:
        tags += [(273, off_type, None), (278, 4, [rows_per_strip or h]),
                 (279, 4, [len(e) for e in enc])]
    if predictor != 1:
        tags.append((317, 3, [predictor]))
    if cmap is not None:
        tags.append((320, 3, list(cmap.T.reshape(-1))))
    tags.sort(key=lambda t: t[0])
    inline, entry = (8, 20) if big else (4, 12)

    def payload(typ, vals):
        return struct.pack(order + _TIFF_PACK[typ] * len(vals),
                           *[int(v) for v in vals])
    extra_at = (16 + 8 + entry * len(tags) + 8 if big
                else 8 + 2 + entry * len(tags) + 4)
    extra_len = 0
    for _, typ, vals in tags:
        n = len(enc) if vals is None else len(vals)
        size = struct.calcsize(_TIFF_PACK[typ]) * n
        extra_len += size if size > inline else 0
    offsets = list(np.cumsum([extra_at + extra_len]
                             + [len(e) for e in enc[:-1]]))
    ifd = struct.pack(order + ("Q" if big else "H"), len(tags))
    extra = b""
    for tag, typ, vals in tags:
        vals = offsets if vals is None else vals
        data = payload(typ, vals)
        head = struct.pack(order + ("HHQ" if big else "HHI"), tag, typ,
                           len(vals))
        if len(data) <= inline:
            ifd += head + data.ljust(inline, b"\0")
        else:
            ifd += head + struct.pack(order + ("Q" if big else "I"),
                                      extra_at + len(extra))
            extra += data
    if big:
        magic = (b"II+\0" if order == "<" else b"MM\0+") + struct.pack(
            order + "HHQ", 8, 0, 16)
        return magic + ifd + b"\0" * 8 + extra + b"".join(enc)
    magic = b"II*\0" if order == "<" else b"MM\0*"
    return (magic + struct.pack(order + "I", 8) + ifd + b"\0" * 4 + extra
            + b"".join(enc))


def os2_bmp(pixels, bpp, palette=None) -> bytes:
    """An OS/2 BMP (the 12-byte BITMAPCOREHEADER: 16-bit width and height,
    a palette of 3-byte BGR entries) of [h, w] palette indices at 1, 4 or
    8 bits with an [n, 3] RGB palette, or of [h, w, 3] RGB at 24 bits;
    rows bottom-up, each padded to 4 bytes."""
    h, w = pixels.shape[:2]
    stride = (w * bpp + 31) // 32 * 4
    rows = b""
    for row in pixels[::-1]:
        if bpp == 24:
            raw = row[:, ::-1].tobytes()
        else:
            bits = ((row[:, None] >> np.arange(bpp - 1, -1, -1)) & 1)
            raw = np.packbits(bits.astype(np.uint8).reshape(-1)).tobytes()
        rows += raw.ljust(stride, b"\0")
    pal = b"" if palette is None else np.ascontiguousarray(
        palette[:, ::-1], np.uint8).tobytes()
    off = 14 + 12 + len(pal)
    return (struct.pack("<2sIHHI", b"BM", off + len(rows), 0, 0, off)
            + struct.pack("<IHHHH", 12, w, h, 1, bpp) + pal + rows)


def pam_file(samples, maxval, tupltype=None) -> bytes:
    """A PAM (P7) of [h, w, depth] samples (big-endian 16 bits above maxval
    255), with a comment line and TUPLTYPE where given."""
    h, w, depth = samples.shape
    head = (f"P7\n# made from the PAM specification\nWIDTH {w}\nHEIGHT {h}"
            f"\nDEPTH {depth}\nMAXVAL {maxval}\n")
    if tupltype:
        head += f"TUPLTYPE {tupltype}\n"
    body = samples.astype(">u2" if maxval > 255 else np.uint8).tobytes()
    return (head + "ENDHDR\n").encode() + body


def with_nclx(data: bytes, matrix: int, primaries=None) -> bytes:
    """An AVIF file with its colr box's nclx matrix_coefficients (and
    colour_primaries, where given) rewritten."""
    out = bytearray(data)
    at = out.index(b"colrnclx") + 8
    if primaries is not None:
        out[at:at + 2] = primaries.to_bytes(2, "big")
    out[at + 4:at + 6] = matrix.to_bytes(2, "big")
    return bytes(out)


# OpenCV's files: name -> (image as RGB or grey, cv2.imwrite parameters)
CV2_FIXTURES = {
    "progressive_420.jpg": lambda: (
        rgb8(40, 56, 1),
        [cv2.IMWRITE_JPEG_PROGRESSIVE, 1,
         cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
         cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420]),
    "palette_8bit.bmp": lambda: (smooth(24, 37, 2)[..., 1].astype(np.uint8),
                                 []),
    "lzw_predictor_16bit.tif": lambda: (
        smooth(24, 32, 3, 65535.0).astype(np.uint16),
        [cv2.IMWRITE_TIFF_COMPRESSION, cv2.IMWRITE_TIFF_COMPRESSION_LZW,
         cv2.IMWRITE_TIFF_PREDICTOR, cv2.IMWRITE_TIFF_PREDICTOR_HORIZONTAL]),
    "rgb_8bit.ppm": lambda: (rgb8(20, 27, 4), [cv2.IMWRITE_PXM_BINARY, 1]),
    "rgb_float.pfm": lambda: (smooth(16, 21, 5, 4.0).astype(np.float32), []),
    "cv2_default.gif": lambda: (rgb8(24, 30, 6), []),
    "cv2_lossless.webp": lambda: (rgb8(24, 33, 7), []),
    "cv2_q80.webp": lambda: (rgb8(40, 52, 8), [cv2.IMWRITE_WEBP_QUALITY, 80]),
    "cv2_default_8bit.tiff": lambda: (rgb8(20, 26, 9), []),
    "cv2_rgbe.pic": lambda: (rgb8(18, 23, 10), []),
    "cv2_raster.sr": lambda: (rgb8(14, 19, 11), []),
    "cv2_default.jp2": lambda: (noisy8(36, 44, 22), []),
    "cv2_lossless_16bit.jp2": lambda: (
        smooth(32, 34, 23, 65535.0).astype(np.uint16),
        [cv2.IMWRITE_JPEG2000_COMPRESSION_X1000, 1000]),
    "cv2_grey.jp2": lambda: (noisy8(33, 40, 24)[..., 0], []),
    # cv2.imwrite of other sample types: LZW with the horizontal predictor
    # (float64 uncompressed), a few samples below zero
    "cv2_int8.tif": lambda: ((smooth(21, 26, 61, 140.0) - 20).astype(
        np.int8), []),
    "cv2_int16.tif": lambda: ((smooth(19, 27, 62, 30000.0) - 3000).astype(
        np.int16), []),
    "cv2_int32.tif": lambda: ((smooth(23, 22, 63, 2e6) - 2e5).astype(
        np.int32), []),
    "cv2_uint32.tif": lambda: (smooth(17, 25, 64, 3e6).astype(np.uint32),
                               []),
    "cv2_float64.tif": lambda: (smooth(20, 21, 65, 4.0), []),
    "cv2_default.pam": lambda: (rgb8(11, 13, 66), []),
}


def smooth16(h, w, seed, depth):
    """smooth() as uint16 at `depth` bits (0 to 2^depth - 1, as cv2 takes
    a 10- or 12-bit image for IMWRITE_AVIF_DEPTH)."""
    return smooth(h, w, seed, (1 << depth) - 1).astype(np.uint16)


def screen(h, w, seed):
    """Dark glyphs from a set of twelve random 8 x 6 masks on white: text
    that encoders code with palettes and intra block copy."""
    rng = np.random.default_rng(seed)
    glyphs = [rng.random((8, 6)) < 0.4 for _ in range(12)]
    img = np.full((h, w, 3), 255, np.uint8)
    for y in range(2, h - 9, 10):
        for x in range(2, w - 7, 7):
            img[y:y + 8, x:x + 6][glyphs[rng.integers(0, 12)]] = (20, 20, 20)
    return img


def _avif(**params):
    return [v for k, v in params.items() for v in
            (getattr(cv2, f"IMWRITE_AVIF_{k.upper()}"), v)]


# OpenCV's AVIF files: name -> (image as RGB or grey, parameters)
CV2_AVIF = {
    "cv2_default.avif": lambda: (rgb8(37, 45, 30), []),
    "cv2_q0_speed10.avif": lambda: (rgb8(24, 33, 31),
                                    _avif(quality=0, speed=10)),
    "cv2_q50_speed0.avif": lambda: (noisy8(29, 41, 32),
                                    _avif(quality=50, speed=0)),
    "cv2_lossless.avif": lambda: (rgb8(21, 27, 33), _avif(quality=100)),
    "cv2_grey.avif": lambda: (smooth(23, 31, 34)[..., 1].astype(np.uint8),
                              []),
    "cv2_10bit.avif": lambda: (smooth16(27, 35, 35, 10),
                               _avif(depth=10, quality=90)),
    "cv2_12bit.avif": lambda: (smooth16(25, 31, 36, 12),
                               _avif(depth=12, quality=80)),
    "cv2_grey_10bit.avif": lambda: (smooth16(19, 29, 37, 10)[..., 0],
                                    _avif(depth=10)),
    "cv2_screen.avif": lambda: (screen(80, 112, 38), []),
}


def _pil_avif(img, mode="RGB", **kw) -> bytes:
    return _pil(Image.fromarray(img, mode), "AVIF", **kw)


def _screen_switch(name, speed):
    return lambda: _pil_avif(screen(96, 160, 39), quality=80, speed=speed,
                             advanced=[("tune-content", "screen"),
                                       (f"enable-{name}", "1")])


def _rotated_avif() -> bytes:
    exif = Image.Exif()
    exif[0x0112] = 7                 # transposed: irot and imir
    return _pil_avif(rgb8(19, 29, 50), exif=exif.tobytes())


# Pillow's AVIF files: name -> bytes
PIL_AVIF = {
    "pil_420_limited.avif": lambda: _pil_avif(rgb8(26, 37, 51), quality=70,
                                              range="limited"),
    "pil_422.avif": lambda: _pil_avif(rgb8(22, 35, 52), quality=60,
                                      subsampling="4:2:2"),
    "pil_444_speed0.avif": lambda: _pil_avif(noisy8(21, 23, 53), quality=50,
                                             speed=0, subsampling="4:4:4"),
    "pil_400.avif": lambda: _pil_avif(rgb8(23, 26, 54), quality=60,
                                      subsampling="4:0:0"),
    "pil_tiles.avif": lambda: _pil_avif(rgb8(136, 136, 49), quality=30,
                                        speed=8, tile_rows=1, tile_cols=1),
    "pil_rgba.avif": lambda: _pil_avif(
        np.dstack([rgb8(24, 33, 55), rgb8(24, 33, 56)[..., 0]]), "RGBA",
        quality=60),
    "pil_animated.avif": lambda: _pil(
        Image.fromarray(rgb8(22, 28, 57)), "AVIF", save_all=True,
        append_images=[Image.fromarray(rgb8(22, 28, 58 + k))
                       for k in range(2)], duration=100, quality=60),
    "pil_exif_rotated.avif": _rotated_avif,
    "pil_palette.avif": _screen_switch("palette", 2),
    "pil_intrabc.avif": _screen_switch("intrabc", 6),
    "pil_filter_intra.avif": lambda: _pil_avif(
        rgb8(40, 47, 46), quality=30, speed=3,
        advanced=[("enable-filter-intra", "1")]),
    "pil_cfl.avif": lambda: _pil_avif(rgb8(40, 47, 47), quality=50, speed=6,
                                      advanced=[("enable-cfl-intra", "1")]),
    "pil_restoration.avif": lambda: _pil_avif(
        rgb8(72, 81, 40), quality=80, speed=2,
        advanced=[("enable-restoration", "1")]),
    "pil_qm.avif": lambda: _pil_avif(rgb8(40, 47, 45), quality=50, speed=6,
                                     advanced=[("enable-qm", "1")]),
    "pil_deltaq.avif": lambda: _pil_avif(rgb8(64, 80, 41), quality=30,
                                         speed=6,
                                         advanced=[("deltaq-mode", "2")]),
    "pil_delta_lf.avif": lambda: _pil_avif(
        rgb8(64, 80, 41), quality=85, speed=6,
        advanced=[("deltaq-mode", "3"), ("delta-lf-mode", "1")]),
    "pil_chroma_deltaq.avif": lambda: _pil_avif(
        rgb8(40, 47, 42), quality=50, speed=6,
        advanced=[("enable-chroma-deltaq", "1")]),
    "pil_tx64.avif": lambda: _pil_avif(rgb8(72, 81, 41), quality=20, speed=4,
                                       advanced=[("enable-tx64", "1")]),
    "pil_sharpness.avif": lambda: _pil_avif(rgb8(40, 47, 48), quality=50,
                                            speed=6,
                                            advanced=[("sharpness", "7")]),
    "pil_sb128.avif": lambda: _pil_avif(rgb8(72, 136, 44), quality=20,
                                        speed=6, advanced=[("sb-size",
                                                            "128")]),
    "pil_film_grain.avif": lambda: _pil_avif(
        rgb8(38, 45, 59), quality=60, speed=6,
        advanced=[("film-grain-test", "10")]),
}


# cv2's and Pillow's AVIF files with their nclx colour matrix (and
# primaries) rewritten: name -> (file, matrix_coefficients, primaries)
MATRIX_AVIF = {
    **{f"cv2_default_mc{m}.avif": ("cv2_default.avif", m, None)
       for m in (1, 2, 4, 7, 8, 9, 12, 15)},
    **{f"cv2_10bit_mc{m}.avif": ("cv2_10bit.avif", m, None)
       for m in (1, 4, 7, 8, 9, 12, 15)},
    "cv2_10bit_mc12_cp9.avif": ("cv2_10bit.avif", 12, 9),
    "pil_444_mc8.avif": ("pil_444_speed0.avif", 8, None),
    "pil_444_mc12_cp9.avif": ("pil_444_speed0.avif", 12, 9),
}


def _pil(img, fmt, **kw) -> bytes:
    bio = io.BytesIO()
    img.save(bio, fmt, **kw)
    return bio.getvalue()


def _transparent_gif() -> bytes:
    """A 16-colour palette GIF whose index 3 is transparent (the left
    quarter and a stripe), the background entry 5."""
    rng = np.random.default_rng(12)
    idx = rng.integers(0, 16, (21, 27)).astype(np.uint8)
    idx[:, :6] = 3
    idx[10] = 3
    im = Image.fromarray(idx, "P")
    im.putpalette(rng.integers(0, 256, 48).tolist())
    return _pil(im, "GIF", transparency=3, background=5, optimize=False)


def _animated_gif() -> bytes:
    frames = [Image.fromarray(rgb8(22, 28, 13 + k)).quantize(32)
              for k in range(3)]
    return _pil(frames[0], "GIF", save_all=True, append_images=frames[1:],
                duration=100, loop=0)


def _alpha_webp() -> bytes:
    rgb = rgb8(26, 35, 16)
    alpha = np.clip(smooth(26, 35, 17)[..., 0] * 1.5, 0, 255).astype(np.uint8)
    return _pil(Image.fromarray(np.dstack([rgb, alpha]), "RGBA"), "WEBP",
                quality=70)


# Pillow's files: name -> bytes
PIL_FIXTURES = {
    "pil_interlaced_64.gif": lambda: _pil(
        Image.fromarray(rgb8(29, 37, 14)).quantize(64), "GIF",
        interlace=True),
    "pil_transparent.gif": _transparent_gif,
    "pil_animated.gif": _animated_gif,
    "pil_lossy_alpha.webp": _alpha_webp,
    "pil_lossless.webp": lambda: _pil(Image.fromarray(rgb8(27, 31, 18)),
                                      "WEBP", lossless=True, method=6),
    "pil_cmyk.jpg": lambda: _pil(Image.fromarray(rgb8(24, 40, 19))
                                 .convert("CMYK"), "JPEG", quality=90),
    "pil_rgb.jpg": lambda: _pil(Image.fromarray(rgb8(24, 40, 20)), "JPEG",
                                quality=90, keep_rgb=True),
    "pil_irreversible_layers.jp2": lambda: _pil(
        Image.fromarray(rgb8(40, 48, 25)), "JPEG2000", irreversible=True,
        mct=1, quality_mode="rates", quality_layers=[40, 20, 10],
        progression="RPCL"),
    "pil_tiles_precincts.j2k": lambda: _pil(
        Image.fromarray(rgb8(45, 61, 26)), "JPEG2000", no_jp2=True,
        tile_size=(32, 32), codeblock_size=(16, 16), precinct_size=(32, 32),
        progression="CPRL", num_resolutions=3, plt=True),
    "pil_rgba_pcrl.jp2": lambda: _pil(
        Image.fromarray(np.dstack([rgb8(34, 38, 27),
                                   rgb8(34, 38, 28)[..., 0]]), "RGBA"),
        "JPEG2000", progression="PCRL", quality_mode="rates",
        quality_layers=[8]),
    # a baseline JPEG under a PNG's name
    "jpeg_named.png": lambda: cv2.imencode(".jpg", rgb8(24, 32, 21))[1]
    .tobytes(),
    "pil_bilevel.tif": lambda: _pil(Image.fromarray(
        smooth(27, 35, 67)[..., 0] > 128), "TIFF", compression="packbits"),
    "pil_cmyk.tif": lambda: _pil(Image.fromarray(rgb8(22, 29, 68))
                                 .convert("CMYK"), "TIFF",
                                 compression="tiff_lzw"),
    "pil_jpeg.tif": lambda: _pil(Image.fromarray(rgb8(30, 37, 69)), "TIFF",
                                 compression="jpeg", quality=90),
    "pil_jpeg_ycbcr.tif": lambda: _pil(Image.fromarray(rgb8(30, 37, 70))
                                       .convert("YCbCr"), "TIFF",
                                       compression="jpeg"),
    "pil_int32.tif": lambda: _pil(Image.fromarray(
        (smooth(19, 23, 71, 5e5)[..., 0] - 4e4).astype(np.int32)), "TIFF"),
    "pil_bigtiff.tif": lambda: _pil(Image.fromarray(rgb8(21, 24, 72)),
                                    "TIFF", big_tiff=True),
}


def _os2_palette() -> bytes:
    """An 8-bit OS/2 BMP of rgb8's colours through Pillow's 256-colour
    quantisation (its palette padded to 256 entries)."""
    im = Image.fromarray(rgb8(25, 31, 76)).quantize(256)
    pal = np.zeros((256, 3), np.uint8)
    got = np.asarray(im.getpalette(), np.uint8).reshape(-1, 3)[:256]
    pal[:len(got)] = got
    return os2_bmp(np.asarray(im), 8, pal)


# files encoded here from their specifications: name -> bytes
HAND_FIXTURES = {
    "planar_strips.tif": lambda: tiff_file(
        rgb8(23, 29, 73), "<", None, 5, 2, planar=True, rows_per_strip=5),
    "planar_tiles.tif": lambda: tiff_file(rgb8(35, 41, 74), ">", (16, 16),
                                          8, planar=True),
    # 4:2:0 YCbCr JPEG strips of 16 rows (the port's baseline writer)
    "ycbcr_420_jpeg.tif": lambda: tiff_file(
        rgb8(37, 45, 75), "<", None, 7, photo=6, rows_per_strip=16,
        encode=lambda c: encode_jpeg(c, 90), tags=[(530, 3, [2, 2])]),
    "os2_8bit.bmp": _os2_palette,
    "os2_24bit.bmp": lambda: os2_bmp(rgb8(19, 26, 77), 24),
    "rgb_alpha_16bit.pam": lambda: pam_file(np.dstack([
        smooth(13, 17, 78, 65535.0), smooth(13, 17, 79, 65535.0)[..., :1]])
        .astype(np.uint16), 65535, "RGB_ALPHA"),
    "grayscale_alpha.pam": lambda: pam_file(
        rgb8(15, 12, 80)[..., :2], 255, "GRAYSCALE_ALPHA"),
    # one sample a byte, 0 or 1: OpenCV reads each row's bytes as bits
    "blackandwhite.pam": lambda: pam_file(
        (smooth(9, 14, 81)[..., :1] > 128).astype(np.uint8), 1,
        "BLACKANDWHITE"),
}


def cv2_rgb(path) -> np.ndarray:
    img = cv2.imread(str(path), FLAGS)
    if img.ndim == 2 or img.shape[2] == 2:     # grey, or grey and alpha
        img = np.repeat(img.reshape(img.shape[:2] + (-1,))[..., :1], 3, -1)
    return np.ascontiguousarray(img[..., 2::-1])


def timing_image() -> np.ndarray:
    """The smooth 1024 x 1024 RGB image of the decode-timing files."""
    yy, xx = np.mgrid[0:1024, 0:1024]
    return np.stack([127 + 120 * np.sin(xx / (40.0 + 9 * c) + c)
                     * np.cos(yy / (55.0 - 7 * c)) for c in range(3)],
                    -1).astype(np.uint8)


def main() -> None:
    OUT.mkdir(parents=True, exist_ok=True)
    pixels = {}
    for name, make in CV2_FIXTURES.items():
        img, params = make()
        if img.ndim == 3:
            img = np.ascontiguousarray(img[..., ::-1])     # RGB -> BGR
        assert cv2.imwrite(str(OUT / name), img, params), name
    for name, make in PIL_FIXTURES.items():
        (OUT / name).write_bytes(make())
    for name, make in CV2_AVIF.items():
        img, params = make()
        if img.ndim == 3:
            img = np.ascontiguousarray(img[..., ::-1])
        assert cv2.imwrite(str(OUT / name), img, params), name
    for name, make in PIL_AVIF.items():
        (OUT / name).write_bytes(make())
    for name, make in HAND_FIXTURES.items():
        (OUT / name).write_bytes(make())
    for name, (src, matrix, primaries) in MATRIX_AVIF.items():
        (OUT / name).write_bytes(with_nclx((OUT / src).read_bytes(), matrix,
                                           primaries))
    avif_names = list(CV2_AVIF) + list(PIL_AVIF) + list(MATRIX_AVIF)
    tools = {}
    for name in avif_names:
        tools[name] = coding_tools((OUT / name).read_bytes())
        print(f"{name}: {', '.join(tools[name])}")
    (DATA / "avif_tools.json").write_text(json.dumps(tools, indent=1) + "\n")
    for name in (list(CV2_FIXTURES) + list(PIL_FIXTURES)
                 + list(HAND_FIXTURES) + avif_names):
        pixels[name] = cv2_rgb(OUT / name)
        print(f"{name}: {(OUT / name).stat().st_size} bytes, "
              f"{pixels[name].shape} {pixels[name].dtype}")
    np.savez_compressed(OUT / "cv2_pixels.npz", **pixels)
    TIMING.mkdir(parents=True, exist_ok=True)
    bgr = np.ascontiguousarray(timing_image()[..., ::-1])
    sums = {}
    for name, params in (("smooth_q80.webp", [cv2.IMWRITE_WEBP_QUALITY, 80]),
                         ("smooth_lossless.webp", []),
                         ("smooth_progressive.jpg",
                          [cv2.IMWRITE_JPEG_PROGRESSIVE, 1]),
                         ("smooth_default.jp2", []),
                         ("smooth_default.avif", [])):
        assert cv2.imwrite(str(TIMING / name), bgr, params), name
        sums[name] = hashlib.sha256(cv2_rgb(TIMING / name)
                                    .tobytes()).hexdigest()
        print(f"{name}: {(TIMING / name).stat().st_size} bytes")
    (TIMING / "cv2_sha256.json").write_text(json.dumps(sums, indent=1)
                                            + "\n")
    src = pixels["cv2_q80.webp"]
    ok, buf = cv2.imencode(".jp2", np.ascontiguousarray(src[..., ::-1]))
    back = cv2.imdecode(buf, FLAGS)[..., ::-1].astype(np.float64)
    psnr = 10 * np.log10(255.0 ** 2 / np.mean((back - src) ** 2))
    (OUT.parent / "jp2_psnr.json").write_text(json.dumps(
        {"cv2_q80.webp": psnr}, indent=1) + "\n")
    print(f"cv2's .jp2 of cv2_q80.webp's pixels: {len(buf)} bytes, PSNR "
          f"{psnr:.4f} dB")
    (DATA / "avif_bars.json").write_text(json.dumps(
        avif_bars(pixels), indent=1) + "\n")


def avif_sources(pixels) -> dict:
    """The sources of the AVIF writer's bars: in-repo pixels of small
    fixtures, one more small image, the smooth timing image whole and as
    its top-left 512 x 512 crop, and its waves drawn 4,160 x 16 (two AV1
    tile columns; chip_smoke.wide_source)."""
    import chip_smoke
    smooth = timing_image()
    return {"cv2_lossless.webp": pixels["cv2_lossless.webp"],
            "cv2_q80.webp": pixels["cv2_q80.webp"],
            "rgb8(37, 45, 30)": rgb8(37, 45, 30),
            "smooth_lossless.webp[:512, :512]": smooth[:512, :512],
            "smooth_lossless.webp": smooth,
            chip_smoke.WIDE_AVIF: chip_smoke.wide_source()}


def avif_bars(pixels) -> dict:
    """cv2's default AVIF (cv2.imwrite with no parameters, as ignis_tpu's
    save_image calls it) of each source: the PSNR of what cv2 reads back
    against the source, the file's and the AV1 item's bytes, and the
    frame header's base_q_idx and tile layout."""
    from ignis_tpu_torch.utils.av1 import Decoder
    from ignis_tpu_torch.utils.avif import parse_avif
    out = {}
    for name, src in avif_sources(pixels).items():
        ok, buf = cv2.imencode(".avif", np.ascontiguousarray(src[..., ::-1]))
        assert ok, name
        back = cv2.imdecode(buf, FLAGS)[..., ::-1].astype(np.float64)
        item = parse_avif(buf.tobytes())["av1"]
        d = Decoder(item)
        out[name] = {"shape": list(src.shape),
                     "psnr_db": float(10 * np.log10(255.0 ** 2 / np.mean(
                         (back - src) ** 2))),
                     "file_bytes": len(buf), "payload_bytes": len(item),
                     "base_q_idx": d.base_q,
                     "tile_cols_log2": d.tile_cols_log2,
                     "tile_rows_log2": d.tile_rows_log2}
        print(f"cv2's AVIF of {name}: {out[name]}")
    return out


if __name__ == "__main__":
    main()
