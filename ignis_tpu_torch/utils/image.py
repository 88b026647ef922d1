"""Image IO without OpenCV or PIL: every file ignis_tpu reads or writes
through OpenCV, read and written with numpy and zlib.

The port's counterpart of ignis_tpu/utils/image.py, which goes through
OpenCV. As OpenCV does, a file is read by the decoder its content names
(`sniff`: PNG, JPEG, BMP, TIFF and BigTIFF, PNM, PAM, PFM, Sun raster,
Radiance, GIF, WebP, JPEG 2000 and AVIF signatures), not by its suffix;
EXR goes by its suffix, as in ignis_tpu, and TGA, which has no
signature, by its suffix where no signature matches; a file no decoder
claims raises IOError, as ignis_tpu raises for cv2.imread's None, and so
does a file OpenCV reads nothing of where a decoder here knows it.

Here PNG is decoded with numpy and zlib (1-16 bits, gray, gray with
alpha, RGB, RGBA or palette, the five row filters, Adam7 interlacing)
and encoded as 8-bit RGB with filter 0 (`encode_png`); JPEG goes through
utils/jpeg.py (baseline and progressive, YCbCr, RGB and Adobe CMYK,
decoded as libjpeg decodes it; written as baseline 4:2:0 at quality 95,
cv2's default); JPEG 2000 (.jp2 boxes or a raw code stream, every
Part 1 feature OpenCV reads: progression orders and POC, layers, tiles,
precincts, every code-block style, SOP/EPH, PPM/PPT, RGN, the 5/3 and
9/7 wavelets, palettes and sYCC) through utils/jpeg2000.py and
utils/ebcot.py, read as OpenCV
reads it through OpenJPEG and written as cv2's default .jp2 writer
writes it (lossless 5/3 cut to OpenCV's rate of 4); BMP is read at
every depth (palettes, RLE8 and RLE4, bit fields, OS/2's 12-byte header,
which OpenCV reads grey) and written at 24; TIFF goes through
utils/tiff.py (classic and BigTIFF, every sample type OpenCV reads,
bilevel, CMYK, JPEG-compressed, planar; written 8-bit LZW with the
predictor, as cv2 writes it); GIF through utils/gif.py and WebP through
utils/webp.py (read as cv2 reads them, written as cv2's default writers
write them: the fixed 3-3-2 GIF table with its dithering, lossless
WebP); AVIF through utils/avif.py and utils/av1.py (the HEIF container
and an AV1 key-frame decoder, with libavif's YUV to RGB as cv2 gets it
under every colour matrix it converts: 8-bit files as uint8, 10- and
12-bit ones as uint16 at their own range); PNM (P1-P6), PAM (P7), PFM
and Sun raster are read as OpenCV reads them and written as cv2 writes
them (binary P6, P7 of depth 3, a little-endian PFM, a 24-bit raster);
TGA is read as uncompressed or run-length-encoded truecolour and written
run-length encoded; EXR is read by the port's own reader and written as
scanline ZIP
(`_write_exr_channels`, also `write_exr_multilayer`'s layers and ig*
attributes); Radiance .hdr and .pic are read with flat or
run-length-encoded scanlines and written flat, in the RGBE rounding of
the rgbe.c that OpenCV uses. 8- and 16-bit input is scaled to [0, 1]
(8-bit by 1/255, 16-bit by 1/65535, AVIF by its bit depth: 1/1023 for 10
bits, 1/4095 for 12) and sRGB-decoded to linear unless `linear`; EXR,
HDR, PFM, float TIFF and a TIFF's signed and 32-bit integers are linear,
their values as they are. AVIF is written as cv2's default writer writes
it (utils/av1_enc.py, in tiles past 4,032 pixels a row).
LDR output is sRGB-encoded with +0.5 rounding, as the JAX writer's.
Images are float32 [h, w, 3] RGB with row 0 at the top.
"""
from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

_PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}   # colour type -> samples


def srgb_to_linear(x: np.ndarray) -> np.ndarray:
    return np.where(x <= 0.04045, x / 12.92, ((x + 0.055) / 1.055) ** 2.4)


def linear_to_srgb(x: np.ndarray) -> np.ndarray:
    x = np.clip(x, 0.0, 1.0)
    return np.where(x <= 0.0031308, x * 12.92, 1.055 * x ** (1 / 2.4) - 0.055)


# OpenCV's signatures, as (prefix, decoder)
_SIGNATURES = (
    (_PNG_MAGIC, "png"), (b"\xff\xd8\xff", "jpeg"), (b"BM", "bmp"),
    (b"II*\0", "tiff"), (b"MM\0*", "tiff"), (b"II+\0", "tiff"),
    (b"MM\0+", "tiff"), (b"GIF87a", "gif"), (b"GIF89a", "gif"),
    (b"#?RADIANCE", "hdr"), (b"#?RGBE", "hdr"),
    (b"\x59\xa6\x6a\x95", "sun_raster"), (b"PF", "pfm"), (b"Pf", "pfm"),
    (b"\0\0\0\x0cjP  \r\n\x87\n", "jpeg2000"),
    (b"\xff\x4f\xff\x51", "jpeg2000"))
_SPACE = b" \t\n\v\f\r"


def sniff(data: bytes):
    """The decoder OpenCV would pick for a file's bytes, by its signature:
    'png', 'jpeg', 'bmp', 'tiff' (BigTIFF too), 'pnm', 'pam', 'pfm',
    'sun_raster', 'hdr', 'gif', 'webp', 'jpeg2000' (a .jp2 file or a raw
    code stream), 'avif', or None."""
    for sig, kind in _SIGNATURES:
        if data.startswith(sig):
            return kind
    if len(data) > 2 and data[:1] == b"P" and data[1] in b"123456":
        return "pnm"
    if len(data) > 2 and data[:2] == b"P7" and data[2] in _SPACE:
        return "pam"
    if data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        return "webp"
    if data[4:12] in (b"ftypavif", b"ftypavis"):
        return "avif"
    return None


def decode_samples(path) -> np.ndarray:
    """A file's pixels as [h, w, 3] RGB samples as OpenCV reads them,
    found by its content: uint8, uint16 (16-bit PNG, TIFF, PNM, PAM, 9-
    to 16-bit JPEG 2000, and 10- and 12-bit AVIF at their own range),
    float32 (PFM, float TIFF, Radiance), or a TIFF's uint32, int8, int16,
    int32 or float64; grey replicated, alpha dropped."""
    return _decode(path)[0]


def _decode(path):
    """(decode_samples' samples, the largest value an integer sample of
    the file can take where that is not its dtype's: 2^depth - 1 for
    AVIF, else None)."""
    path = Path(path)
    data = path.read_bytes()
    kind = sniff(data)
    if kind is None and path.suffix.lower() == ".tga":
        kind = "tga"
    if kind is None:
        raise IOError(f"Cannot load image {path}")
    if kind == "avif":
        from .avif import decode_avif_depth
        samples, depth = decode_avif_depth(data, path.name)
        return samples, (1 << depth) - 1
    if kind == "jpeg":
        from .jpeg import decode_jpeg
        return decode_jpeg(data), None
    if kind == "tiff":
        from .tiff import decode_tiff
        return decode_tiff(data), None
    if kind == "gif":
        from .gif import decode_gif
        return decode_gif(data), None
    if kind == "webp":
        from .webp import decode_webp
        return decode_webp(data), None
    if kind == "jpeg2000":
        from .jpeg2000 import decode_jpeg2000
        return decode_jpeg2000(data, path.name), None
    return {"png": decode_png, "bmp": decode_bmp, "tga": decode_tga,
            "pnm": decode_pnm, "pam": decode_pam, "pfm": decode_pfm,
            "hdr": decode_hdr,
            "sun_raster": decode_sun_raster}[kind](data), None


def _scaled(samples: np.ndarray) -> bool:
    """Whether samples are LDR data scaled to [0, 1]: unsigned 8 and 16
    bits. Float samples, and a TIFF's signed and 32-bit integers, are
    taken as they are, as ignis_tpu takes them."""
    return samples.dtype in (np.uint8, np.uint16)


def _normalised(samples: np.ndarray, maxval=None) -> np.ndarray:
    """Integer samples to [0, 1] (8 bits / 255, 16 bits / 65535, or /
    `maxval` where the file's depth is not its dtype's); other samples
    (`_scaled`) as float32 as they are."""
    if maxval is not None:
        return samples.astype(np.float32) / np.float32(maxval)
    if samples.dtype == np.uint8:
        return samples.astype(np.float32) / np.float32(255.0)
    if samples.dtype == np.uint16:
        return samples.astype(np.float32) / np.float32(65535.0)
    return samples.astype(np.float32)


def read_ldr(path) -> np.ndarray:
    """An integer-sample file as float32 [h, w, 3] in [0, 1]
    (sRGB-encoded values): 8-bit samples / 255, 16-bit ones (PNG, TIFF,
    PNM) / 65535, AVIF's by its bit depth."""
    samples, maxval = _decode(path)
    if not _scaled(samples):
        raise ValueError(f"{path}: {samples.dtype} samples are not LDR "
                         "data")
    return _normalised(samples, maxval)


def load_image(path, linear: bool = False) -> np.ndarray:
    """Linear float32 [h, w, 3] RGB. EXR (by its suffix), HDR, PFM and
    float TIFF are linear, and so are a TIFF's signed and 32-bit integers
    (their values as they are, as ignis_tpu takes them); 8- and 16-bit
    data is scaled to [0, 1] and sRGB-decoded unless `linear` (normal
    maps; ImagePattern's 'linear' flag)."""
    path = Path(path)
    if path.suffix.lower() == ".exr":
        from .exr import load_exr_rgb
        return np.ascontiguousarray(load_exr_rgb(path), np.float32)
    samples, maxval = _decode(path)
    img = _normalised(samples, maxval)
    if not _scaled(samples):
        return np.ascontiguousarray(img)
    if not linear:
        img = srgb_to_linear(img)
    return np.ascontiguousarray(img, np.float32)


def encode_ppm(rgb) -> bytes:
    """A binary PPM (P6, maxval 255) of uint8 [h, w, 3], as cv2 writes it."""
    rgb = _rgb8(rgb)
    h, w, _ = rgb.shape
    return f"P6\n{w} {h}\n255\n".encode() + rgb.tobytes()


def encode_pam(rgb) -> bytes:
    """A PAM (P7, depth 3, maxval 255, no TUPLTYPE) of uint8 [h, w, 3], as
    cv2 writes an image ignis_tpu hands it: the samples in OpenCV's BGR
    order."""
    rgb = _rgb8(rgb)
    h, w, _ = rgb.shape
    return (f"P7\nWIDTH {w}\nHEIGHT {h}\nDEPTH 3\nMAXVAL 255\nENDHDR\n"
            .encode() + np.ascontiguousarray(rgb[..., ::-1]).tobytes())


def encode_pfm(img) -> bytes:
    """A little-endian colour PFM (scale -1, rows bottom-up) of [h, w, 3]
    samples as float32, as cv2 writes it."""
    img = np.asarray(img, np.float32)
    h, w, _ = img.shape
    return f"PF\n{w} {h}\n-1\n".encode() + \
        np.ascontiguousarray(img[::-1], "<f4").tobytes()


def encode_sun_raster(rgb) -> bytes:
    """A raw 24-bit Sun raster (type 1, BGR, rows padded to 16 bits) of
    uint8 [h, w, 3], as cv2 writes it."""
    rgb = _rgb8(rgb)
    h, w, _ = rgb.shape
    stride = (3 * w + 1) & ~1
    rows = np.zeros((h, stride), np.uint8)
    rows[:, :3 * w] = rgb[..., ::-1].reshape(h, 3 * w)
    return struct.pack(">8I", 0x59A66A95, w, h, 24, rows.size, 1, 0, 0) + \
        rows.tobytes()


def _ldr_writer(suffix: str):
    """The encoder of 8-bit RGB for a suffix cv2.imwrite takes, or None."""
    from .gif import encode_gif
    from .jpeg import encode_jpeg
    from .avif import encode_avif
    from .jpeg2000 import encode_jp2
    from .tiff import encode_tiff
    from .webp import encode_webp
    return {".png": encode_png, ".jpg": encode_jpeg, ".jpeg": encode_jpeg,
            ".jpe": encode_jpeg, ".bmp": encode_bmp, ".dib": encode_bmp,
            ".tga": encode_tga, ".tif": encode_tiff, ".tiff": encode_tiff,
            ".ppm": encode_ppm, ".pnm": encode_ppm, ".pam": encode_pam,
            ".pfm": lambda ldr: encode_pfm(ldr.astype(np.float32)),
            ".sr": encode_sun_raster, ".ras": encode_sun_raster,
            # cv2's HDR writer scales 8-bit data by 1/255.0f
            ".pic": lambda ldr: _hdr_bytes(
                ldr.astype(np.float32) * np.float32(1.0 / 255.0)),
            ".webp": encode_webp, ".gif": encode_gif,
            ".jp2": encode_jp2, ".avif": encode_avif}.get(suffix)


def save_image(path, img):
    """Save linear float32 [h, w, 3] RGB by its suffix, as ignis_tpu hands
    it to cv2.imwrite: EXR (ZIP) and HDR keep it linear; every other
    format is written from the 8-bit sRGB image (PFM as its 0-255 values,
    .pic scaled back to [0, 1], as cv2 writes an 8-bit image to them).
    .jp2 as cv2's default JPEG 2000 writer (utils/jpeg2000.py: lossless
    5/3, cut to rate 4 by PCRD-opt). .pgm and .pbm, which cv2 writes of
    grey images only, and a .jp2 below 32 pixels a side, which cv2 does
    not write (ignis_tpu then leaves an unreadable 77-byte file), raise
    ValueError. .avif as cv2's default AVIF writer writes it
    (utils/avif.py over utils/av1_enc.py: 4:2:0, base_q_idx 148 with
    delta q, quantiser matrices, deblocking and CDEF, libaom's tiles);
    .pam as cv2 writes it (`encode_pam`)."""
    path = Path(path)
    img = np.asarray(img, np.float32)
    suffix = path.suffix.lower()
    if suffix == ".exr":
        _write_exr_fallback(path, img)
        return
    if suffix == ".hdr":
        write_hdr(path, img)
        return
    if suffix in (".pgm", ".pbm"):
        raise ValueError(f"{path.name}: '{suffix}' holds a grey image, "
                         "and save_image writes colour")
    if suffix == ".jp2" and min(img.shape[:2]) < 32:
        raise ValueError(f"{path.name}: '.jp2' needs at least 32 pixels a "
                         f"side (OpenCV writes no smaller JPEG 2000), got "
                         f"{img.shape[1]} x {img.shape[0]}")
    encode = _ldr_writer(suffix)
    if encode is None:
        raise ValueError(f"{path.name}: no image writer for '{suffix}'")
    ldr = (linear_to_srgb(img) * 255.0 + 0.5).astype(np.uint8)
    path.write_bytes(encode(ldr))


def _rgb8(rgb) -> np.ndarray:
    rgb = np.ascontiguousarray(rgb, np.uint8)
    if rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"expected uint8 [h, w, 3], got {rgb.shape}")
    return rgb


def _channel(word, mask: int, bpp: int) -> np.ndarray:
    """A BMP bit-field channel expanded to 8 bits as OpenCV expands it: a
    16-bit file's field shifted up into the high bits (its 5-5-5 and 5-6-5
    conversions), a 32-bit file's masked bits (contiguous or not) shifted
    down to the mask's lowest and scaled in float32 by 255 / (mask >>
    shift), truncated. A 16-bit mask with gaps, which OpenCV refuses,
    raises IOError."""
    if mask == 0:
        return np.zeros(word.shape, np.uint8)
    shift = (mask & -mask).bit_length() - 1
    top = mask >> shift
    if bpp == 32:
        scale = np.float32(255.0) / np.float32(top)
        v = ((word & mask) >> shift).astype(np.float32) * scale
        return v.astype(np.int64).astype(np.uint8)
    width = top.bit_length()
    if top != (1 << width) - 1:
        raise IOError(f"BMP: OpenCV reads no 16-bit channel mask {mask:#x}")
    v = (word >> shift) & top
    v = v << (8 - width) if width <= 8 else v >> (width - 8)
    return v.astype(np.uint8)


def _bmp_rle(data: bytes, pos: int, w: int, h: int, four: bool):
    """RLE8 (or RLE4 when `four`) palette indices as [h, w] uint8, bottom
    row first as stored; pixels a delta or an early end of line skips
    keep index 0 (OpenCV fills them with the palette's first colour)."""
    idx = np.zeros((h, w), np.uint8)
    x = y = 0
    n = len(data)
    while pos + 1 < n and y < h:
        count, val = data[pos], data[pos + 1]
        pos += 2
        if count:                          # a run of count pixels
            px = ([val >> 4, val & 15] * count)[:count] if four else \
                [val] * count
            m = min(count, w - x)
            idx[y, x:x + m] = px[:m]
            x += count
        elif val == 0:                     # end of line
            x, y = 0, y + 1
        elif val == 1:                     # end of bitmap
            break
        elif val == 2:                     # delta
            x, y = x + data[pos], y + data[pos + 1]
            pos += 2
        else:                              # val literal pixels
            nbytes = (val + 1) // 2 if four else val
            raw = data[pos:pos + nbytes]
            px = ([v for b in raw for v in (b >> 4, b & 15)][:val] if four
                  else list(raw))
            m = max(min(val, w - x), 0)
            idx[y, x:x + m] = px[:m]
            x += val
            pos += nbytes + (nbytes & 1)   # to a 16-bit boundary
    return idx


def decode_bmp(data: bytes) -> np.ndarray:
    """A BMP as uint8 [h, w, 3] RGB: 1-, 4- and 8-bit palettes (also RLE8
    and RLE4), 16 bits (5-5-5, or BI_BITFIELDS masks of any width), 24
    bits, and 32 bits (BGRx or BI_BITFIELDS masks of any width),
    bottom-up or top-down. The masks of BI_BITFIELDS follow a 40-byte
    header or lie in a longer one (OpenCV ignores them after a 40-byte
    header and reads such a 32-bit file as BGRx). An OS/2 file (the
    12-byte header: 16-bit width and height, a full palette of 3-byte
    entries; 1, 4, 8, 24 or 32 bits) comes back grey, as OpenCV reads it
    under ignis_tpu's flags (`opencv_grey`); a header OpenCV does not read
    raises IOError."""
    if data[:2] != b"BM" or len(data) < 26:
        raise ValueError("not a BMP file")
    offset, hsize = struct.unpack("<II", data[10:18])
    os2 = hsize == 12               # OS/2's BITMAPCOREHEADER
    if os2:
        w, h, _, bpp = struct.unpack("<HHHH", data[18:26])
        comp = colors = 0
        if w == 0 or h == 0 or bpp not in (1, 4, 8, 24, 32):
            raise IOError(f"BMP: OpenCV reads no {w} x {h} OS/2 file of "
                          f"{bpp} bits")
    elif hsize < 36 or len(data) < 50:
        raise IOError(f"BMP: OpenCV reads no file with a {hsize}-byte "
                      "header")
    else:
        w, h, _, bpp, comp = struct.unpack("<iiHHI", data[18:34])
        colors = struct.unpack("<I", data[46:50])[0]
    top_down, h = h < 0, abs(h)
    rle = {(1, 8): False, (2, 4): True}.get((comp, bpp))
    if not (comp == 0 and bpp in (1, 4, 8, 16, 24, 32)
            or comp == 3 and bpp in (16, 32) or rle is not None):
        raise IOError(f"BMP: OpenCV reads no {bpp}-bit file of "
                      f"compression {comp}")
    if bpp <= 8:
        n = colors or 1 << bpp
        entry = 3 if os2 else 4
        if len(data) < 14 + hsize + entry * n:
            raise IOError("BMP: truncated palette")
        pal = np.frombuffer(data, np.uint8, entry * n, 14 + hsize).reshape(
            n, entry)[:, 2::-1]
        if rle is not None:
            idx = _bmp_rle(data, offset, w, h, rle)
        else:
            stride = (w * bpp + 31) // 32 * 4
            if len(data) < offset + stride * h:
                raise ValueError("BMP: truncated pixel data")
            rows = np.frombuffer(data, np.uint8, stride * h,
                                 offset).reshape(h, stride)
            idx = np.unpackbits(rows, axis=1).reshape(h, -1, bpp)
            idx = (idx[:, :w] << np.arange(bpp - 1, -1, -1, dtype=np.uint8)
                   ).sum(-1, dtype=np.uint8) if bpp < 8 else rows[:, :w]
        rgb = pal[np.minimum(idx, n - 1)]
    else:
        stride = (w * bpp // 8 + 3) & ~3
        if len(data) < offset + stride * h:
            raise ValueError("BMP: truncated pixel data")
        rows = np.frombuffer(data, np.uint8, stride * h, offset).reshape(
            h, stride)
        px = rows[:, :w * bpp // 8].reshape(h, w, bpp // 8)
        masks = (struct.unpack("<III", data[54:66]) if comp == 3
                 else (0x7C00, 0x3E0, 0x1F))
        if bpp == 24 or bpp == 32 and (comp == 0 or 0 in masks):
            rgb = px[..., 2::-1]       # OpenCV reads BGRx without a mask
        else:
            word = (px.view("<u2") if bpp == 16 else px.view("<u4"))[..., 0]
            rgb = np.stack([_channel(word.astype(np.int64), m, bpp)
                            for m in masks], -1)
    rgb = rgb if top_down else rgb[::-1]
    return opencv_grey(rgb) if os2 else np.ascontiguousarray(rgb)


def opencv_grey(rgb: np.ndarray) -> np.ndarray:
    """OpenCV's colour-to-grey of uint8 RGB (14-bit fixed point: 0.299 R
    + 0.587 G + 0.114 B, rounded), replicated to [h, w, 3]: what OpenCV
    returns for files it reads as grey whatever their colours (an OS/2
    BMP, a 1-bit palette TIFF)."""
    c = rgb.astype(np.int32)
    y = (c[..., 0] * 4899 + c[..., 1] * 9617 + c[..., 2] * 1868 + 8192) >> 14
    return np.ascontiguousarray(np.repeat(y.astype(np.uint8)[..., None], 3,
                                          -1))


def _pnm_tokens(data: bytes, count: int, pos: int = 2):
    """`count` whitespace-separated header numbers from pos ('#' starts a
    comment to the end of the line), and the position after the single
    whitespace byte that ends the last."""
    out = []
    n = len(data)
    while len(out) < count:
        while pos < n and (data[pos] in b" \t\r\n" or data[pos] == 35):
            if data[pos] == 35:
                while pos < n and data[pos] not in b"\r\n":
                    pos += 1
            else:
                pos += 1
        end = pos
        while end < n and data[end] in b"0123456789":
            end += 1
        if end == pos:
            raise ValueError("PNM: bad header")
        out.append(int(data[pos:end]))
        pos = end
    return out, pos + 1


def decode_pnm(data: bytes) -> np.ndarray:
    """A PBM, PGM or PPM (P1-P6) as [h, w, 3] RGB samples as OpenCV reads
    them: 1 is black in a bitmap (0 / 255), an ASCII grey or colour file
    with a maxval below 256 is scaled to 0-255 (i * 255 // maxval), a
    binary one is not, and a maxval above 255 gives uint16 samples as
    stored."""
    if len(data) < 3 or data[:1] != b"P" or data[1:2] not in b"123456":
        raise ValueError("not a PNM file")
    kind = data[1] - 48
    bitmap = kind in (1, 4)
    (w, h, *rest), pos = _pnm_tokens(data, 2 if bitmap else 3)
    maxval = 1 if bitmap else rest[0]
    if not 0 < maxval < 65536:
        raise ValueError(f"PNM: maxval {maxval}")
    ch = 3 if kind in (3, 6) else 1
    n = w * h * ch
    if kind == 4:
        stride = (w + 7) // 8
        rows = np.frombuffer(data, np.uint8, stride * h, pos).reshape(h, -1)
        v = np.unpackbits(rows, axis=1)[:, :w]
    elif kind in (5, 6):
        v = np.frombuffer(data, ">u2" if maxval > 255 else np.uint8, n, pos)
    else:
        body = data[pos - 1:]
        if kind == 1:       # digits need no separators in a P1 body
            v = np.frombuffer(bytes(b for b in body if b in b"01"),
                              np.uint8) - 48
        else:
            v = np.array(_pnm_tokens(body, n, 0)[0], np.int64)
        v = v[:n]
    if bitmap:
        v = np.where(np.asarray(v) != 0, 0, 255).astype(np.uint8)
    elif kind in (2, 3) and maxval < 256:
        v = (np.asarray(v, np.int64) * 255 // maxval).astype(np.uint8)
    else:
        v = np.asarray(v).astype(np.uint16 if maxval > 255 else np.uint8)
    img = v.reshape(h, w, ch)
    return np.ascontiguousarray(np.repeat(img, 3, -1) if ch == 1 else img)


# PAM's TUPLTYPEs that OpenCV reads -> their depth
_PAM_TUPLES = {b"BLACKANDWHITE": 1, b"GRAYSCALE": 1, b"GRAYSCALE_ALPHA": 2,
               b"RGB": 3, b"RGB_ALPHA": 4}
_PAM_FIELDS = (b"WIDTH", b"HEIGHT", b"DEPTH", b"MAXVAL", b"TUPLTYPE",
               b"ENDHDR")


def _pam_line(data: bytes, pos: int):
    """One header line from pos as OpenCV's ReadPAMHeaderLine reads it:
    (identifier, value, the position after it); None for a comment.
    An identifier is at most 8 bytes and ends at a whitespace byte; a
    line break there ends the line (ENDHDR's pixels start right after
    that one byte); else the value runs from the next non-space byte to
    the line's end, trailing whitespace dropped."""
    n = len(data)
    while pos < n and data[pos] in _SPACE:
        pos += 1
    if pos >= n:
        raise IOError("PAM: the header has no ENDHDR")
    if data[pos] == 35:                        # '#': to the line's end
        while pos < n and data[pos] not in b"\r\n":
            pos += 1
        return None, None, pos + 1
    end = pos
    while end < n and end - pos < 8 and data[end] not in _SPACE:
        end += 1
    if end >= n or data[end] not in _SPACE or data[pos:end] not in \
            _PAM_FIELDS:
        raise IOError(f"PAM: bad header field {data[pos:end + 1]!r}")
    ident, pos = data[pos:end], end + 1
    if data[end] in b"\r\n":
        return ident, b"", pos
    while pos < n and data[pos] in _SPACE:
        pos += 1
    end = pos
    while end < n and data[end] not in b"\r\n":
        end += 1
    if end >= n:
        raise IOError("PAM: the header ends in a field")
    return ident, data[pos:end].rstrip(_SPACE), end + 1


def decode_pam(data: bytes) -> np.ndarray:
    """A PAM (P7) as [h, w, 3] samples as OpenCV reads them: WIDTH,
    HEIGHT, DEPTH (1-4), MAXVAL (0-65535) and TUPLTYPE (BLACKANDWHITE,
    GRAYSCALE, GRAYSCALE_ALPHA, RGB, RGB_ALPHA; without one, a depth of 1
    below maxval 256 or of 3 below 256), comments. Samples are as stored
    (uint8, or big-endian uint16 above maxval 255), their first three
    taken in OpenCV's BGR order; at maxval 1 (of one or three samples) a
    row's bytes are read as bits, most significant first, its first w
    bits the pixels' grey, 1 as 255, as OpenCV reads them. Grey is
    replicated and alpha dropped. A header or a file OpenCV
    refuses raises IOError."""
    if len(data) < 3 or data[:2] != b"P7" or data[2] not in b"\r\n":
        raise IOError("not a PAM file")
    fields, tupl, pos = {}, None, 3
    while True:
        ident, value, pos = _pam_line(data, pos)
        if ident is None:
            continue
        if ident == b"ENDHDR":
            break
        if ident == b"TUPLTYPE":
            if value not in _PAM_TUPLES:
                raise IOError(f"PAM: TUPLTYPE {value!r}")
            tupl = value
            continue
        digits = value[1:] if value[:1] == b"-" else value
        if not digits.isdigit() and digits or ident in fields:
            raise IOError(f"PAM: {ident.decode()} {value!r}")
        fields[ident] = int(value or b"0")
    if len(fields) != 4:
        raise IOError("PAM: WIDTH, HEIGHT, DEPTH and MAXVAL are required")
    w, h, depth, maxval = (fields[k] for k in _PAM_FIELDS[:4])
    if w <= 0 or h <= 0 or not 1 <= depth <= 4 or not 0 <= maxval < 65536:
        raise IOError(f"PAM: {w} x {h}, depth {depth}, maxval {maxval}")
    if tupl is None and not (depth in (1, 3) and maxval < 256):
        raise IOError(f"PAM: no TUPLTYPE for depth {depth}, maxval "
                      f"{maxval}")
    if tupl is not None and _PAM_TUPLES[tupl] != depth:
        raise IOError(f"PAM: TUPLTYPE {tupl.decode()} at depth {depth}")
    if maxval == 1 and depth in (2, 4):
        raise IOError(f"PAM: OpenCV reads no {depth} samples of maxval 1")
    size = 2 if maxval > 255 else 1
    stride = w * depth * size
    if len(data) < pos + stride * h:
        raise IOError("PAM: truncated pixel data")
    if maxval == 1:            # the first w bits of each row's bytes
        rows = np.frombuffer(data, np.uint8, stride * h, pos).reshape(
            h, stride)
        bits = np.unpackbits(rows, axis=1)[:, :w]
        return np.ascontiguousarray(np.repeat((bits * 255)[..., None], 3,
                                              -1))
    img = np.frombuffer(data, ">u2" if size == 2 else np.uint8, w * h * depth,
                        pos).reshape(h, w, depth).astype(
        np.uint16 if size == 2 else np.uint8)
    if depth < 3:
        return np.ascontiguousarray(np.repeat(img[..., :1], 3, -1))
    return np.ascontiguousarray(img[..., 2::-1])


def decode_pfm(data: bytes) -> np.ndarray:
    """A PFM ('PF' colour, 'Pf' grey) as float32 [h, w, 3]: little-endian
    when the scale is negative, rows stored bottom-up, the samples times
    the float32 1 / |scale|, as OpenCV reads them."""
    if data[:2] not in (b"PF", b"Pf"):
        raise ValueError("not a PFM file")
    lines, pos = [], 2
    while len(lines) < 3:
        while data[pos] in b" \t\r\n":
            pos += 1
        end = pos
        while data[end] not in b" \t\r\n":
            end += 1
        lines.append(data[pos:end])
        pos = end
    pos += 1
    w, h, scale = int(lines[0]), int(lines[1]), float(lines[2])
    ch = 3 if data[1:2] == b"F" else 1
    v = np.frombuffer(data, "<f4" if scale < 0 else ">f4", w * h * ch, pos)
    img = v.reshape(h, w, ch)[::-1].astype(np.float32)
    if scale != 0:
        img = img * np.float32(1.0 / abs(scale))
    return np.ascontiguousarray(np.repeat(img, 3, -1) if ch == 1 else img)


def decode_sun_raster(data: bytes) -> np.ndarray:
    """A Sun raster as uint8 [h, w, 3] RGB: 1- and 8-bit with or without a
    colour map (1 is black in a map-less bitmap, 8 bits map-less is
    grey), 24 and 32 bits (BGR, or RGB in type 3; 32 bits lead with a pad
    byte), raw (types 0, 1, 3) or byte-run encoded (type 2; 0x80 n v
    repeats v n + 1 times, 0x80 0 is one 0x80). OpenCV reads the raw
    24-bit, 32-bit and mapped files, not types 2 and 3."""
    if len(data) < 32 or data[:4] != b"\x59\xa6\x6a\x95":
        raise ValueError("not a Sun raster file")
    _, w, h, depth, _, kind, maptype, maplen = struct.unpack(">8I",
                                                             data[:32])
    if depth not in (1, 8, 24, 32) or kind > 3 or maptype > 1:
        raise IOError(f"Sun raster: OpenCV reads no depth {depth}, type "
                      f"{kind}, map type {maptype}")
    pos = 32 + maplen
    cmap = None
    if maptype == 1 and maplen:
        cmap = np.frombuffer(data, np.uint8, maplen, 32).reshape(3, -1).T
    stride = ((w * depth + 7) // 8 + 1) & ~1
    body = data[pos:]
    if kind == 2:
        out = bytearray()
        i, n = 0, len(body)
        while i < n and len(out) < stride * h:
            b = body[i]
            if b != 0x80:
                out.append(b)
                i += 1
            elif body[i + 1] == 0:
                out.append(0x80)
                i += 2
            else:
                out += body[i + 2:i + 3] * (body[i + 1] + 1)
                i += 3
        body = bytes(out)
    rows = np.frombuffer(body, np.uint8, stride * h).reshape(h, stride)
    if depth in (1, 8):
        idx = (np.unpackbits(rows, axis=1)[:, :w] if depth == 1
               else rows[:, :w])
        if cmap is not None:
            return np.ascontiguousarray(cmap[np.minimum(idx, len(cmap) - 1)])
        grey = (1 - idx) * 255 if depth == 1 else idx
        return np.ascontiguousarray(np.repeat(grey.astype(np.uint8)[..., None],
                                              3, -1))
    px = rows[:, :w * depth // 8].reshape(h, w, depth // 8)[..., depth // 8
                                                            - 3:]
    return np.ascontiguousarray(px if kind == 3 else px[..., ::-1])


def encode_bmp(rgb) -> bytes:
    """A 24-bit bottom-up BI_RGB BMP of uint8 [h, w, 3]."""
    rgb = _rgb8(rgb)
    h, w, _ = rgb.shape
    stride = (3 * w + 3) & ~3
    rows = np.zeros((h, stride), np.uint8)
    rows[:, :3 * w] = rgb[::-1, :, ::-1].reshape(h, 3 * w)
    head = struct.pack("<2sIHHI", b"BM", 54 + rows.size, 0, 0, 54)
    info = struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0, rows.size, 2835,
                       2835, 0, 0)
    return head + info + rows.tobytes()


def decode_tga(data: bytes) -> np.ndarray:
    """An uncompressed (type 2) or run-length-encoded (type 10) 24- or
    32-bit truecolour TGA as uint8 [h, w, 3] RGB."""
    if len(data) < 18:
        raise ValueError("not a TGA file")
    (id_len, cmap_type, kind, _, cmap_len, cmap_bits, _, _, w, h, bpp,
     desc) = struct.unpack("<BBBHHBHHHHBB", data[:18])
    if kind not in (2, 10) or bpp not in (24, 32):
        # OpenCV has no TGA codec: ignis_tpu reads no TGA at all
        raise IOError(f"TGA: image type {kind}, {bpp} bits is not read "
                      "(truecolour 24 or 32 bits, raw or run-length "
                      "encoded)")
    pos = 18 + id_len + (cmap_len * ((cmap_bits + 7) // 8) if cmap_type
                         else 0)
    bp = bpp // 8
    n = w * h
    if kind == 2:
        if len(data) < pos + n * bp:
            raise ValueError("TGA: truncated pixel data")
        px = np.frombuffer(data, np.uint8, n * bp, pos)
    else:
        out = bytearray()
        while len(out) < n * bp:
            if pos >= len(data):
                raise ValueError("TGA: truncated run-length data")
            head = data[pos]
            count = (head & 0x7F) + 1
            if head & 0x80:
                out += data[pos + 1:pos + 1 + bp] * count
                pos += 1 + bp
            else:
                out += data[pos + 1:pos + 1 + count * bp]
                pos += 1 + count * bp
        px = np.frombuffer(bytes(out[:n * bp]), np.uint8)
    img = px.reshape(h, w, bp)[..., 2::-1]
    if not desc & 0x20:        # bottom-left origin
        img = img[::-1]
    if desc & 0x10:            # right-to-left
        img = img[:, ::-1]
    return np.ascontiguousarray(img)


def encode_tga(rgb) -> bytes:
    """A run-length-encoded 24-bit truecolour TGA (type 10, top-left
    origin) of uint8 [h, w, 3]; runs and raw packets stop at row ends."""
    rgb = _rgb8(rgb)
    h, w, _ = rgb.shape
    bgr = rgb[..., ::-1]
    out = bytearray(struct.pack("<BBBHHBHHHHBB", 0, 0, 10, 0, 0, 0, 0, 0, w,
                                h, 24, 0x20))
    for row in bgr:
        # start of each run of equal pixels
        new = np.ones(w, bool)
        new[1:] = (row[1:] != row[:-1]).any(-1)
        starts = np.flatnonzero(new).tolist() + [w]
        raw = []      # the single pixels since the last run
        for a, b in zip(starts[:-1], starts[1:]):
            if b - a == 1:
                raw.append(a)
                continue
            _flush_raw(out, row, raw)
            raw = []
            for c0 in range(a, b, 128):
                out.append(0x80 | (min(128, b - c0) - 1))
                out += row[c0].tobytes()
        _flush_raw(out, row, raw)
    return bytes(out)


def _flush_raw(out: bytearray, row, raw) -> None:
    """Raw packets (up to 128 pixels each) of the consecutive pixels in
    `raw`."""
    for c0 in range(0, len(raw), 128):
        idx = raw[c0:c0 + 128]
        out.append(len(idx) - 1)
        out += row[idx[0]:idx[-1] + 1].tobytes()


def _png_chunk(ctype: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + ctype + body
            + struct.pack(">I", zlib.crc32(ctype + body) & 0xFFFFFFFF))


def encode_png(rgb) -> bytes:
    """An 8-bit RGB PNG of uint8 [h, w, 3] (filter 0 on every row)."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    if rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"encode_png: expected [h, w, 3], got {rgb.shape}")
    h, w, _ = rgb.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           rgb.reshape(h, w * 3)], axis=1)
    return (_PNG_MAGIC
            + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0,
                                              0))
            + _png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _png_chunk(b"IEND", b""))


def _rgbe(img: np.ndarray) -> np.ndarray:
    """float32 [h, w, 3] -> uint8 [h, w, 4] RGBE (rgbe.c's float2rgbe:
    mantissas truncated after scaling by 256 / max)."""
    img = np.maximum(np.asarray(img, np.float32), 0.0)
    v = img.max(axis=-1)
    m, e = np.frexp(v)
    ok = v >= 1e-32
    scale = np.where(ok, m * 256.0 / np.where(ok, v, 1.0), 0.0)
    out = np.zeros(img.shape[:2] + (4,), np.uint8)
    out[..., :3] = (img * scale[..., None].astype(np.float32)).astype(
        np.uint8)
    out[..., 3] = np.where(ok, e + 128, 0).astype(np.uint8)
    return out


def _hdr_bytes(img) -> bytes:
    """A Radiance RGBE file of float [h, w, 3], flat scanlines, row 0 at
    the top."""
    img = np.asarray(img, np.float32)
    h, w = img.shape[:2]
    head = (f"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y {h} +X {w}\n"
            ).encode()
    return head + _rgbe(img[..., :3]).tobytes()


def write_hdr(path, img):
    """Radiance RGBE file, flat scanlines, row 0 at the top."""
    Path(path).write_bytes(_hdr_bytes(img))


def _rle_scanline(data: bytes, pos: int, w: int):
    """One run-length-encoded RGBE scanline at data[pos:] -> ([w, 4], end)."""
    line = np.empty((4, w), np.uint8)
    for c in range(4):
        x = 0
        while x < w:
            n = data[pos]
            run = n > 128           # n - 128 copies of one byte
            n = n - 128 if run else n   # else n literal bytes
            if n == 0 or x + n > w:
                raise ValueError("HDR: bad scanline run")
            if run:
                line[c, x:x + n] = data[pos + 1]
                pos += 2
            else:
                line[c, x:x + n] = np.frombuffer(data, np.uint8, n, pos + 1)
                pos += 1 + n
            x += n
    return line.T, pos


def decode_hdr(data: bytes) -> np.ndarray:
    """A Radiance file (flat or RLE scanlines, -Y h +X w) as float32
    [h, w, 3] (rgbe.c's rgbe2float: m * 2^(e - 136))."""
    if not data.startswith(b"#?"):
        raise ValueError("not a Radiance HDR file")
    pos = data.index(b"\n\n") + 2
    end = data.index(b"\n", pos)
    line = data[pos:end]
    dims = line.split()
    pos = end + 1
    if len(dims) != 4 or dims[0] != b"-Y" or dims[2] != b"+X":
        # OpenCV's rgbe.c reads only the standard orientation
        raise IOError(f"HDR: OpenCV reads no resolution line {line!r} "
                      "(only -Y h +X w)")
    h, w = int(dims[1]), int(dims[3])
    rgbe = np.empty((h, w, 4), np.uint8)
    for y in range(h):
        if (8 <= w < 0x8000 and data[pos] == 2 and data[pos + 1] == 2
                and (data[pos + 2] << 8 | data[pos + 3]) == w):
            rgbe[y], pos = _rle_scanline(data, pos + 4, w)
        else:
            rgbe[y] = np.frombuffer(data, np.uint8, w * 4, pos).reshape(w, 4)
            pos += w * 4
    e = rgbe[..., 3].astype(np.int32)
    f = np.where(e > 0, np.ldexp(np.float32(1.0), e - 136), 0.0)
    return np.ascontiguousarray(rgbe[..., :3] * f[..., None], np.float32)


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the PNG row filters: [h, stride] uint8 samples."""
    data = np.frombuffer(raw, np.uint8).reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.int32)
    for y in range(h):
        ftype = int(data[y, 0])
        line = data[y, 1:].astype(np.int32)
        if ftype == 0:
            cur = line
        elif ftype == 1:    # Sub: a running sum per byte of a pixel
            cur = np.empty(stride, np.int32)
            for k in range(bpp):
                cur[k::bpp] = np.cumsum(line[k::bpp]) & 0xFF
        elif ftype == 2:    # Up
            cur = (line + prior) & 0xFF
        elif ftype in (3, 4):   # Average, Paeth: pixel by pixel
            cur = np.empty(stride, np.int32)
            for x in range(0, stride, bpp):
                a = cur[x - bpp:x] if x else np.zeros(bpp, np.int32)
                b = prior[x:x + bpp]
                if ftype == 3:
                    pred = (a + b) >> 1
                else:
                    c = prior[x - bpp:x] if x else np.zeros(bpp, np.int32)
                    p = a + b - c
                    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
                    pred = np.where((pa <= pb) & (pa <= pc), a,
                                    np.where(pb <= pc, b, c))
                cur[x:x + bpp] = (line[x:x + bpp] + pred) & 0xFF
        else:
            raise ValueError(f"PNG: unknown row filter {ftype}")
        out[y] = cur
        prior = cur
    return out


# Adam7: each pass's (x0, y0, dx, dy)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _png_samples(raw: bytes, w: int, h: int, depth: int, ch: int):
    """Unfilter one (sub)image of raw PNG rows: [h, w, ch] samples (uint8,
    or uint16 at depth 16) and the bytes it used."""
    bits = w * ch * depth
    stride = (bits + 7) // 8
    used = h * (stride + 1)
    rows = _unfilter(raw[:used], h, stride, max(1, ch * depth // 8))
    if depth == 16:
        return rows.view(">u2").reshape(h, w, ch).astype(np.uint16), used
    if depth == 8:
        return rows.reshape(h, w, ch), used
    packed = np.unpackbits(rows, axis=1)[:, :bits].reshape(h, w * ch, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    vals = (packed * weights).sum(-1, dtype=np.uint8)
    return vals.reshape(h, w, ch), used


def read_png(path) -> np.ndarray:
    """A PNG as float32 [h, w, 3] in [0, 1] (sRGB-encoded values)."""
    return _normalised(decode_png(Path(path).read_bytes()))


def decode_png(data: bytes) -> np.ndarray:
    """A PNG's samples as [h, w, 3] uint8 (uint16 at 16 bits). Palette
    images take their PLTE colours; gray below 8 bits is scaled to 8 bits
    as libpng expands it; alpha is dropped."""
    if data[:8] != _PNG_MAGIC:
        raise ValueError("not a PNG file")
    pos, idat, hdr, plte = 8, [], None, None
    while pos < len(data):
        n, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if ctype == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif ctype == b"PLTE":
            plte = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
    if hdr is None:
        raise ValueError("PNG: no IHDR chunk")
    w, h, depth, color, _, _, interlace = hdr
    ch = _PNG_CHANNELS.get(color)
    if ch is None or depth not in (1, 2, 4, 8, 16) or interlace > 1 or (
            ch > 1 and depth < 8 and color != 3) or (
            color == 3 and (depth > 8 or plte is None)):
        raise IOError(
            f"PNG colour type {color} at {depth} bits, interlace "
            f"{interlace} is not a valid PNG")
    raw = zlib.decompress(b"".join(idat))
    if interlace:
        dt = np.uint16 if depth == 16 else np.uint8
        smp = np.zeros((h, w, ch), dt)
        pos = 0
        for x0, y0, dx, dy in _ADAM7:
            pw, ph = -(-(w - x0) // dx), -(-(h - y0) // dy)
            if pw <= 0 or ph <= 0:
                continue
            sub, used = _png_samples(raw[pos:], pw, ph, depth, ch)
            smp[y0::dy, x0::dx] = sub
            pos += used
    else:
        smp, _ = _png_samples(raw, w, h, depth, ch)
    if color == 3:
        img = plte[np.minimum(smp[..., 0], len(plte) - 1)]
    elif depth == 16:
        img = smp
    else:
        scale = 255 // ((1 << depth) - 1)      # libpng's gray expansion
        img = (smp.astype(np.uint8) * scale).astype(np.uint8)
    if img.shape[-1] <= 2:
        img = np.repeat(img[..., :1], 3, axis=-1)
    return np.ascontiguousarray(img[..., :3])


def write_exr_multilayer(path, layers, metadata=None):
    """Scanline ZIP EXR with several RGB layers and ig* attributes (as the
    JAX writer's: the default layer's channels R/G/B, an AOV layer's
    Name.R/Name.G/Name.B, sorted).

    layers: dict name -> [h, w, 3] or [h, w] float array ("" = default)
    metadata: dict name -> str | int | float | (x, y, z)
    """
    first = next(iter(layers.values()))
    h, w = first.shape[0], first.shape[1]
    channels = []
    for lname, img in layers.items():
        img = np.asarray(img, np.float32)
        if img.ndim == 2:
            img = np.stack([img] * 3, axis=-1)
        prefix = f"{lname}." if lname else ""
        channels += [(prefix + "B", img[..., 2]), (prefix + "G", img[..., 1]),
                     (prefix + "R", img[..., 0])]
    channels.sort(key=lambda c: c[0])  # EXR requires sorted channel names
    meta_attrs = b""
    for name, value in (metadata or {}).items():
        if isinstance(value, str):
            meta_attrs += _attr(name, "string", value.encode())
        elif isinstance(value, (bool, int, np.integer)):
            meta_attrs += _attr(name, "int", struct.pack("<i", int(value)))
        elif isinstance(value, (float, np.floating)):
            meta_attrs += _attr(name, "float", struct.pack("<f", float(value)))
        elif isinstance(value, (tuple, list, np.ndarray)) and len(value) == 3:
            meta_attrs += _attr(name, "v3f", struct.pack(
                "<fff", *[float(x) for x in value]))
    _write_exr_channels(path, w, h, channels, meta_attrs)


def _attr(name, type_, data):
    return (name.encode() + b"\0" + type_.encode() + b"\0"
            + struct.pack("<I", len(data)) + data)


def _write_exr_fallback(path, img: np.ndarray):
    """Scanline ZIP-compressed EXR writer, float32 RGB (as the JAX
    package's)."""
    img = np.asarray(img, np.float32)
    h, w, _ = img.shape
    channels = [("B", img[..., 2]), ("G", img[..., 1]), ("R", img[..., 0])]
    _write_exr_channels(path, w, h, channels, b"")


def _write_exr_channels(path, w, h, channels, extra_attrs):
    chlist = b""
    for name, _ in channels:
        chlist += name.encode() + b"\0" + struct.pack("<iiii", 2, 0, 1, 1)
    chlist += b"\0"
    header = (_attr("channels", "chlist", chlist)
              + _attr("compression", "compression", bytes([3]))  # ZIP
              + _attr("dataWindow", "box2i",
                     struct.pack("<iiii", 0, 0, w - 1, h - 1))
              + _attr("displayWindow", "box2i",
                     struct.pack("<iiii", 0, 0, w - 1, h - 1))
              + _attr("lineOrder", "lineOrder", bytes([0]))
              + _attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
              + _attr("screenWindowCenter", "v2f", struct.pack("<ff", 0, 0))
              + _attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
              + extra_attrs + b"\0")

    # ZIP compression groups 16 scanlines a block
    blocks = []
    for y0 in range(0, h, 16):
        y1 = min(y0 + 16, h)
        # per scanline, the channels one after the other
        raw = np.stack([ch[y0:y1] for _, ch in channels], axis=1) \
            .astype("<f4").tobytes()
        # EXR zip pre-filter: de-interleave, then the delta predictor
        a = np.frombuffer(raw, np.uint8)
        half = (len(a) + 1) // 2
        split = np.empty_like(a)
        split[:half] = a[0::2]
        split[half:] = a[1::2]
        d = split.astype(np.int16)
        out = np.empty_like(d)
        out[0] = d[0]
        out[1:] = d[1:] - d[:-1] + 128 + 256
        comp = zlib.compress((out & 0xFF).astype(np.uint8).tobytes())
        if len(comp) >= len(raw):
            comp = raw
        blocks.append((y0, comp))

    with open(path, "wb") as f:
        f.write(struct.pack("<I", 20000630))  # magic
        f.write(struct.pack("<I", 2))         # version
        f.write(header)
        table = f.tell()
        f.write(b"\0" * (8 * len(blocks)))
        offsets = []
        for y0, comp in blocks:
            offsets.append(f.tell())
            f.write(struct.pack("<iI", y0, len(comp)))
            f.write(comp)
        f.seek(table)
        for off in offsets:
            f.write(struct.pack("<Q", off))
