"""TIFF in numpy: the decoder behind utils/image.py's `.tif` and `.tiff`,
read as OpenCV (libtiff) reads them, and the writer of what OpenCV writes
by default (`encode_tiff`: 8-bit RGB, little-endian, LZW with the
horizontal predictor, in strips).

One image (the first IFD) of a classic TIFF or a BigTIFF (version 43:
8-byte offsets, LONG8 and IFD8 fields), little- or big-endian, in strips
or tiles, chunky or planar samples (PlanarConfiguration 1 or 2):
uncompressed, PackBits, LZW (MSB-first codes with the early change),
Deflate, JPEG (compression 7, its JPEGTables tag before each chunk's
stream, decoded by utils/jpeg.py), CCITT (compressions 2, 32771, 3 and
4, utils/ccitt.py), ThunderScan (32809, `_thunder`) or SGI LogLuv
(34676, 34677, utils/logluv.py); LZW
and Deflate with or without the horizontal predictor (2), or for float
samples the floating-point predictor (3), which libtiff ignores in the
other codecs. Samples: unsigned and signed 8, 16, 32 and 64 bits, float
32 and 64 bits, each returned in the dtype OpenCV gives them; grey (1
bit as 0 and 255; white-is-zero inverted at 8 bits, as libtiff's RGBA
reader inverts it, kept as stored wider), RGB, RGBA (unassociated 8-bit
alpha premultiplied, as that reader premultiplies it) and palette (4 and
8 bits; 1 bit grey, as OpenCV reads it; without a colour map the indices
as grey); CMYK (photometric 5), 8 bits, converted as libtiff's RGBA
reader converts it (R = (255 - K) * (255 - C) / 255, truncated); YCbCr
(photometric 6) inside JPEG, converted by libjpeg's integer path, and
outside it by libtiff's tables (`_ycbcr`); CIELab (8), as libtiff's RGBA
reader converts it. Palette colours are the colour map's high bytes
(libtiff's RGBA conversion; a map whose entries all fit in 8 bits is
taken as 8-bit). A compression libtiff knows no codec for reads as
OpenCV's zeroed buffer at 8 bits. What OpenCV reads nothing of (2-bit
files, 4-bit grey, CMYK with alpha, the codecs OpenCV's libtiff is built
without, ThunderScan of grey, ...) raises IOError.
"""
from __future__ import annotations

import math
import struct
import zlib

import numpy as np

from .image import opencv_grey

# field type -> (struct code, size); 16 and 18 are BigTIFF's LONG8, IFD8
_TYPES = {1: ("B", 1), 2: ("s", 1), 3: ("H", 2), 4: ("I", 4), 5: ("II", 8),
          6: ("b", 1), 7: ("B", 1), 8: ("h", 2), 9: ("i", 4), 10: ("ii", 8),
          11: ("f", 4), 12: ("d", 8), 13: ("I", 4), 16: ("Q", 8),
          17: ("q", 8), 18: ("Q", 8)}
# none, LZW, Deflate (2 tags), PackBits, JPEG
_CODECS = (1, 5, 8, 32946, 32773, 7)
# CCITT: Modified Huffman (and word-aligned), T.4, T.6
_CCITT = (2, 32771, 3, 4)
# the compressions libtiff names; of these OpenCV's libtiff is built
# without old-style JPEG, PixarLog, JBIG, LERC, LZMA, ZSTD, WebP and JPEG
# XL, and reads nothing under them
_LIBTIFF = (1, 2, 3, 4, 5, 6, 7, 8, 32766, 32771, 32773, 32809, 32909,
            32946, 34661, 34676, 34677, 34887, 34925, 50000, 50001, 50002)
_UNBUILT = (6, 32909, 34661, 34887, 34925, 50000, 50001, 50002)
# (bits, SampleFormat) -> the dtype OpenCV reads such samples into
# the YCbCrSubsampling libtiff's RGBA reader converts (putcontig8bitYCbCr*)
_SUBSAMPLINGS = ((1, 1), (1, 2), (2, 1), (2, 2), (4, 1), (4, 2), (4, 4))
_DTYPES = {(8, 1): "u1", (16, 1): "u2", (32, 1): "u4", (64, 1): "u8",
           (8, 2): "i1", (16, 2): "i2", (32, 2): "i4", (64, 2): "i8",
           (32, 3): "f4", (64, 3): "f8"}


def _header(data: bytes):
    """(byte order, BigTIFF, the first IFD's offset) of a TIFF."""
    order = {b"II": "<", b"MM": ">"}.get(data[:2])
    if order is None or len(data) < 8:
        raise ValueError("not a TIFF file")
    magic = struct.unpack(order + "H", data[2:4])[0]
    if magic == 42:
        return order, False, struct.unpack(order + "I", data[4:8])[0]
    if magic == 43 and len(data) >= 16 and struct.unpack(
            order + "HH", data[4:8]) == (8, 0):
        return order, True, struct.unpack(order + "Q", data[8:16])[0]
    raise IOError(f"TIFF: version {magic} is not a TIFF")


def _tags(data: bytes, order: str, big: bool, ifd: int) -> dict:
    """The tags of the IFD at `ifd`: tag -> list of values (bytes for
    ASCII). A BigTIFF's entries are 20 bytes (8-byte counts and values)."""
    count, entry, inline = ("Q", 20, 8) if big else ("H", 12, 4)
    head = struct.calcsize(count)
    if ifd + head > len(data):
        raise IOError("TIFF: the IFD lies past the end of the file")
    n = struct.unpack(order + count, data[ifd:ifd + head])[0]
    tags = {}
    for i in range(n):
        e = ifd + head + entry * i
        if big:
            tag, typ, cnt = struct.unpack(order + "HHQ", data[e:e + 12])
            at = e + 12
        else:
            tag, typ, cnt = struct.unpack(order + "HHI", data[e:e + 8])
            at = e + 8
        if typ not in _TYPES:
            continue
        code, size = _TYPES[typ]
        nbytes = size * cnt
        pos = at if nbytes <= inline else struct.unpack(
            order + ("Q" if big else "I"), data[at:at + inline])[0]
        raw = data[pos:pos + nbytes]
        if len(raw) != nbytes:
            raise IOError(f"TIFF: tag {tag} lies past the end of the file")
        if typ == 2:
            tags[tag] = raw
        else:
            tags[tag] = list(struct.unpack(order + code * cnt, raw))
    return tags


def _lzw(data: bytes) -> bytes:
    """TIFF LZW: 9- to 12-bit MSB-first codes, ClearCode 256, EOI 257, the
    code width growing one code early."""
    out = bytearray()
    table = [bytes([i]) for i in range(256)] + [b"", b""]
    width, pos, n = 9, 0, len(data) * 8
    data = data + b"\0\0\0"
    prev = None
    while pos + width <= n:
        i = pos >> 3
        word = data[i] << 16 | data[i + 1] << 8 | data[i + 2]
        code = (word >> (24 - (pos & 7) - width)) & ((1 << width) - 1)
        pos += width
        if code == 256:
            del table[258:]
            width, prev = 9, None
            continue
        if code == 257:
            break
        if prev is None:
            entry = table[code]
        else:
            if code < len(table):
                entry = table[code]
            elif code == len(table):
                entry = prev + prev[:1]
            else:
                raise ValueError("TIFF: bad LZW code")
            table.append(prev + entry[:1])
            if len(table) >= (1 << width) - 1 and width < 12:
                width += 1
        out += entry
        prev = entry
    return bytes(out)


def _packbits(data: bytes) -> bytes:
    out = bytearray()
    i, n = 0, len(data)
    while i < n:
        h = data[i]
        i += 1
        if h < 128:
            out += data[i:i + h + 1]
            i += h + 1
        elif h > 128:
            out += data[i:i + 1] * (257 - h)
            i += 1
    return bytes(out)


def _inflate(raw: bytes, comp: int) -> bytes:
    """A chunk's bytes under compression 1, 5 (LZW), 8 or 32946 (Deflate)
    or 32773 (PackBits), decompressed."""
    if comp == 5:
        return _lzw(raw)
    if comp in (8, 32946):
        return zlib.decompress(raw)
    if comp == 32773:
        return _packbits(raw)
    return raw


# ThunderScan's deltas: 2-bit (code 2 skips) and 3-bit (code 4 skips)
_THUNDER2 = (0, 1, None, -1)
_THUNDER3 = (0, 1, 2, 3, None, -3, -2, -1)


def _thunder(raw: bytes, rows: int, w: int) -> bytes:
    """A ThunderScan strip of `rows` rows of w 4-bit pixels, as libtiff's
    tif_thunder.c decodes it for OpenCV's RGBA reader (which reads a
    tiled file's tiles as its zeroed buffer): each row from
    pixel value 0, codes of 2 bits over 6 (a run of the last value, three
    2-bit or two 3-bit deltas modulo 16, a raw value). A row that the
    codes do not fill exactly stops the strip there (libtiff's "Not
    enough" or "Too much data"), the rest left as the reader's zeroed
    buffer: a run that overshoots the row writes nothing past an odd
    start, deltas past its end nothing at all, and a row the strip's
    codes end in keeps no half-filled last byte (as cv2 reads it)."""
    stride = (w + 1) // 2
    out = bytearray(rows * stride)
    pos = 0
    for r in range(rows):
        px = []
        last = 0
        while pos < len(raw) and len(px) < w:
            n = raw[pos]
            pos += 1
            kind = n >> 6
            if kind == 0:
                if len(px) + n <= w:
                    px += [last] * n
                else:
                    if len(px) & 1 and n:
                        px.append(last)
                    _thunder_row(out, r * stride, px)
                    return bytes(out)
                continue
            if kind == 1:
                deltas = [_THUNDER2[(n >> s) & 3] for s in (4, 2, 0)]
            elif kind == 2:
                deltas = [_THUNDER3[(n >> s) & 7] for s in (3, 0)]
            else:
                deltas = [None]
                last = n & 15
                px.append(last)
            for dv in deltas:
                if dv is not None:
                    last = (last + dv) & 15
                    if len(px) < w:
                        px.append(last)
        if len(px) != w:
            # a row the strip ends in: its last byte is not kept half full
            _thunder_row(out, r * stride, px[:len(px) & ~1])
            break
        _thunder_row(out, r * stride, px)
    return bytes(out)


def _thunder_row(out: bytearray, at: int, px: list):
    for i, v in enumerate(px):
        out[at + (i >> 1)] |= v << (4 * (1 - (i & 1)))


def _float_predictor(raw: bytes, rows: int, cw: int, spp: int, size: int):
    """Undo the floating-point predictor (3; libtiff's fpAcc) on float
    rows of `size`-byte samples: each row's bytes summed with a stride of
    spp, then read as `size` byte planes, most significant first."""
    b = np.frombuffer(raw, np.uint8, rows * cw * spp * size).reshape(
        rows, cw * size, spp)
    b = np.cumsum(b, axis=1, dtype=np.uint8).reshape(rows, size, cw * spp)
    return np.ascontiguousarray(b.transpose(0, 2, 1)).view(
        f">f{size}").reshape(rows, cw, spp).astype(f"=f{size}")


def _jpeg_chunk(raw: bytes, tables, photo: int) -> np.ndarray:
    """A JPEG strip or tile as libtiff hands it to OpenCV's RGBA reader:
    its stream after the JPEGTables' (less their EOI), grey or RGB;
    YCbCr (photometric 6) converted to RGB by libjpeg, RGB (2) taken as
    coded (libtiff turns libjpeg's colour conversion off)."""
    from .jpeg import decode_jpeg, frame_components
    if tables and raw[:2] == b"\xff\xd8":
        raw = bytes(tables[:-2]) + raw[2:]
    if frame_components(raw) != (1 if photo in (0, 1) else 3):
        raise IOError("TIFF: a JPEG chunk's components are not the "
                      "image's samples (libtiff refuses it)")
    rgb = decode_jpeg(raw, {2: "rgb", 6: "ycc"}.get(photo))
    return rgb[..., :1] if photo in (0, 1) else rgb


def _unpack_bits(raw: bytes, rows: int, cw: int, bits: int) -> np.ndarray:
    """[rows, cw, 1] uint8 values of 1- or 4-bit samples, MSB first, each
    row padded to a byte."""
    stride = (cw * bits + 7) // 8
    rows = min(rows, len(raw) // stride)
    b = np.unpackbits(np.frombuffer(raw, np.uint8, rows * stride).reshape(
        rows, stride), axis=1)[:, :cw * bits].reshape(rows, cw, bits)
    w = (1 << np.arange(bits - 1, -1, -1)).astype(np.uint8)
    return (b * w).sum(-1, dtype=np.uint8)[..., None]


def _chunks(t: dict, w: int, h: int, spp: int, planar: bool):
    """(chunk width, chunk height, samples a chunk, [(offset, bytes, y0,
    x0, first sample)]) of the strips or tiles; planar files hold one
    plane's chunks after another's."""
    if 322 in t:
        cw, ch = t[322][0], t[323][0]
        offsets, counts = t[324], t[325]
    else:
        cw, ch = w, min(t.get(278, [h])[0], h)
        offsets, counts = t[273], t[279]
    across, down = -(-w // cw), -(-h // ch)
    per_plane = across * down
    planes = spp if planar else 1
    if len(offsets) < per_plane * planes or len(counts) < len(offsets):
        raise IOError("TIFF: fewer strips or tiles than the image needs")
    places = []
    for i in range(per_plane * planes):
        k, j = divmod(i, per_plane)
        places.append((offsets[i], counts[i], (j // across) * ch,
                       (j % across) * cw, k))
    return cw, ch, (1 if planar else spp), places


def _ycbcr_tables(t: dict):
    """libtiff's TIFFYCbCrToRGBInit of the file's YCbCrCoefficients (tag
    529; default 0.299, 0.587, 0.114) and ReferenceBlackWhite (532;
    default 0 255 128 255 128 255): (Y, Cr->R, Cb->B, Cr->G, Cb->G) int64
    tables of 256 entries, in its float32 and 16-bit fixed-point
    arithmetic."""
    f = np.float32
    luma = [f(v[0] / v[1]) for v in np.reshape(t.get(529, [299, 1000, 587,
                                                           1000, 114, 1000]),
                                                (3, 2))]
    rbw = [f(v[0] / v[1]) for v in np.reshape(
        t.get(532, [0, 1, 255, 1, 128, 1, 255, 1, 128, 1, 255, 1]), (6, 2))]
    if np.isnan(luma[0]) or luma[1] == 0 or np.isnan(luma[2]):
        raise IOError("TIFF: invalid YCbCrCoefficients (libtiff refuses "
                      "them)")

    def fix(x):
        return int(float(f(min(max(x, f(0)), f(2))) * f(65536)) + 0.5)

    def code2v(c, rb, rw, cr):
        den = f(rw - rb) if rw - rb != 0 else f(1)
        v = (np.asarray(c - int(rb), np.int64).astype(f) * f(cr)) / den
        return np.clip(v, f(-4096), f(4096)).astype(np.int64)
    f1 = f(2) - f(2) * luma[0]
    f3 = f(2) - f(2) * luma[2]
    d1, d2 = fix(f1), -fix(luma[0] * f1 / luma[1])
    d3, d4 = fix(f3), -fix(luma[2] * f3 / luma[1])
    x = np.arange(-128, 128)
    cr = code2v(x, rbw[4] - f(128), rbw[5] - f(128), 127)
    cb = code2v(x, rbw[2] - f(128), rbw[3] - f(128), 127)
    half = 1 << 15
    return (code2v(x + 128, rbw[0], rbw[1], 255), (d1 * cr + half) >> 16,
            (d3 * cb + half) >> 16, d2 * cr, d4 * cb + half)


def _ycbcr_chunk(raw: bytes, rows: int, cols: int, hs: int, vs: int):
    """[rows', cols', 3] uint8 Y, Cb, Cr of a YCbCr chunk in data units
    of hs x vs luma samples and one Cb and Cr, each unit's chroma taken by
    all its pixels (libtiff's putcontig8bitYCbCr tiles); rows' and cols'
    are rounded up to whole units."""
    across, down = -(-cols // hs), -(-rows // vs)
    unit = hs * vs + 2
    down = min(down, len(raw) // (across * unit))
    u = np.frombuffer(raw, np.uint8, down * across * unit).reshape(
        down, across, unit)
    y = u[..., :hs * vs].reshape(down, across, vs, hs).transpose(
        0, 2, 1, 3).reshape(down * vs, across * hs)
    c = np.repeat(np.repeat(u[..., hs * vs:], vs, 0), hs, 1)
    return np.dstack([y[..., None], c])


def _ycbcr_to_rgb(ycc: np.ndarray, t: dict) -> np.ndarray:
    """uint8 RGB of uint8 Y, Cb, Cr as libtiff's TIFFYCbCrtoRGB gives
    them to OpenCV's RGBA reader."""
    ytab, crr, cbb, crg, cbg = _ycbcr_tables(t)
    y, cb, cr = (ycc[..., k].astype(np.int64) for k in range(3))
    yy = ytab[y]
    rgb = np.stack([yy + crr[cr], yy + ((cbg[cb] + crg[cr]) >> 16),
                    yy + cbb[cb]], -1)
    return np.clip(rgb, 0, 255).astype(np.uint8)


def _ycbcr(data, t, w, h, spp, bits, fmt, comp, planar, predictor):
    """A YCbCr TIFF outside JPEG (photometric 6) as OpenCV reads it
    through libtiff's RGBA reader: 8-bit samples in data units of the
    YCbCrSubsampling (tag 530, default 2 x 2; `_SUBSAMPLINGS`), or planar
    at 1 x 1, converted
    by `_ycbcr_to_rgb` to uint8 RGB."""
    hs, vs = t.get(530, [2, 2])[:2]
    if bits != 8 or fmt != 1 or spp != 3 or comp not in _CODECS \
            or predictor not in (1, 2) or (hs, vs) not in _SUBSAMPLINGS \
            or planar and (hs, vs) != (1, 1):
        raise IOError(f"TIFF: OpenCV reads no YCbCr file of {spp} {bits}-bit "
                      f"samples, subsampling {hs} x {vs}, compression "
                      f"{comp}, predictor {predictor}, planar {int(planar)}")
    if planar:
        hs = vs = 1
    cw, ch, cspp, places = _chunks(t, w, h, spp, planar)
    img = np.zeros((-(-h // ch) * ch + vs, -(-w // cw) * cw + hs, 3),
                   np.uint8)
    for off, cnt, y0, x0, k in places:
        rows = min(ch, h - y0) if 322 not in t else ch
        raw = _inflate(data[off:off + cnt], comp)
        unit = -(-cw // hs) * (hs * vs + 2)
        line = cw * cspp if 322 in t or planar else unit // vs
        whole = (-(-ch // vs) * unit) % line == 0 if 322 in t else True
        if predictor == 2 and comp in (5, 8, 32946) and line % cspp == 0 \
                and whole:
            # libtiff's horizontal predictor, three bytes apart, on rows of
            # its scanline (a tile's: tile width x 3) bytes; on a scanline
            # of no whole number of samples, or a tile of no whole number
            # of such rows, it fails, and OpenCV's RGBA reader goes on with
            # the bytes as they were
            n = len(raw) // line * line
            b = np.frombuffer(raw, np.uint8, n).reshape(-1, line // cspp,
                                                        cspp)
            raw = np.cumsum(b, 1, dtype=np.uint8).tobytes() + raw[n:]
        if planar:
            n = min(rows, len(raw) // cw)
            img[y0:y0 + n, x0:x0 + cw, k] = np.frombuffer(
                raw, np.uint8, n * cw).reshape(n, cw)
            continue
        if 322 not in t:
            # libtiff reads a strip's rows times its scanline size, the
            # bytes of a row of data units over vs truncated (short of
            # the strip at 4 x 4 with an odd number of units across); the
            # rest of its buffer reads as zeros
            line = -(-cw // hs) * (hs * vs + 2) // vs
            raw = raw[:-(-rows // vs) * vs * line].ljust(
                -(-rows // vs) * -(-cw // hs) * (hs * vs + 2), b"\0")
        elif (hs, vs) == (4, 4) and w - x0 < cw:
            # libtiff's putcontig8bitYCbCr44tile skips a clipped tile's
            # hidden units as 10 bytes each, not 18
            seen, hidden = -(-(w - x0) // 4), (cw - (w - x0)) // 4
            step = seen * 18 + hidden * 10
            raw = b"".join(raw[r * step:r * step + seen * 18].ljust(
                cw // 4 * 18, b"\0") for r in range(-(-rows // 4)))
        chunk = _ycbcr_chunk(raw, rows, cw, hs, vs)
        img[y0:y0 + chunk.shape[0], x0:x0 + chunk.shape[1]] = chunk
    return _ycbcr_to_rgb(img[:h, :w], t)


def _cielab_to_rgb(img: np.ndarray, t: dict) -> np.ndarray:
    """uint8 RGB of 8- or 16-bit CIELab samples (photometric 8: L
    unsigned, a and b signed) as libtiff's RGBA reader converts them for
    OpenCV (TIFFCIELabToRGBInit for its sRGB display, the WhitePoint tag,
    by default D50's, as reference white; TIFFCIELab16ToXYZ and TIFFXYZToRGB
    in float32, gamma 2.4 through a 1,501-entry table)."""
    f = np.float32
    if 318 in t:
        wp = [f(v[0] / v[1]) for v in np.reshape(t[318], (2, 2))]
    else:                       # libtiff's default: D50's XYZ normalised
        d50 = (f(96.425), f(100), f(82.468))
        wp = [d50[0] / (d50[0] + d50[1] + d50[2]),
              d50[1] / (d50[0] + d50[1] + d50[2])]
    if wp[1] == 0:
        raise IOError("TIFF: a white point of y 0 (libtiff refuses it)")
    y0 = f(100)
    x0 = wp[0] / wp[1] * y0
    z0 = (f(1) - wp[0] - wp[1]) / wp[1] * y0
    if img.dtype == np.uint8:
        l16 = img[..., 0].astype(np.int64) * 257
        a16 = img[..., 1].view(np.int8).astype(np.int64) * 256
        b16 = img[..., 2].view(np.int8).astype(np.int64) * 256
    else:
        l16 = img[..., 0].astype(np.int64)
        a16 = img[..., 1].view(np.int16).astype(np.int64)
        b16 = img[..., 2].view(np.int16).astype(np.int64)
    L = l16.astype(f) * f(100) / f(65535)
    small = L < f(8.856)
    yy = np.where(small, (L * y0) / f(903.292), f(0))
    cby = np.where(small, f(7.787) * (yy / y0) + f(16) / f(116),
                   (L + f(16)) / f(116))
    yy = np.where(small, yy, y0 * cby * cby * cby)

    def channel(tmp, ref):
        return np.where(tmp < f(0.2069), ref * (tmp - f(0.13793)) / f(7.787),
                        ref * tmp * tmp * tmp)
    xx = channel(a16.astype(f) / f(256) / f(500) + cby, x0)
    zz = channel(cby - b16.astype(f) / f(256) / f(200), z0)
    mat = np.array([[3.2410, -1.5374, -0.4986], [-0.9692, 1.8760, 0.0416],
                    [0.0556, -0.2040, 1.0570]], f)
    step = (f(100) - f(1)) / f(1500)
    table = [f(255) * f(math.pow(i / 1500, 1.0 / f(2.4)))
             for i in range(1501)]
    table = np.asarray(table, f).astype(np.float64)
    out = []
    for row in mat:
        lum = row[0] * xx + row[1] * yy + row[2] * zz
        lum = np.minimum(np.maximum(lum, f(1)), f(100))
        i = np.minimum(((lum - f(1)) / step).astype(np.int64), 1500)
        v = table[i]
        out.append(np.minimum(np.where(v > 0, v + 0.5, v - 0.5).astype(
            np.int64), 255))
    return np.stack(out, -1).astype(np.uint8)


def _logluv(data, t, w, h, spp, bits, fmt, comp, photo, planar):
    """A LogLuv or LogL TIFF (utils/logluv.py) as OpenCV reads it: LogLuv
    (three samples, chunky, SGILog or SGILog24, whatever sample type the
    file declares) as float32 RGB, LogL (one 8- or 16-bit integer sample,
    SGILog) as its tone curve in uint8 or, of signed samples, int8. Other
    combinations, which libtiff or OpenCV refuse, raise IOError."""
    from . import logluv
    if photo == 32845 and comp in (34676, 34677) and spp == 3 \
            and not planar:
        planes = 4
    elif photo == 32844 and comp == 34676 and spp == 1 and bits in (8, 16) \
            and fmt in (1, 2):
        planes = 2
    else:
        raise IOError(f"TIFF: OpenCV reads no photometric {photo} under "
                      f"compression {comp} with {spp} {bits}-bit samples "
                      f"of format {fmt}")
    cw, ch, _, places = _chunks(t, w, h, spp, planar)
    words = np.zeros((-(-h // ch) * ch, -(-w // cw) * cw), np.uint32)
    for off, cnt, y0, x0, _ in places:
        rows = min(ch, h - y0) if 322 not in t else ch
        raw = data[off:off + cnt]
        words[y0:y0 + rows, x0:x0 + cw] = (
            logluv.packed24(raw, rows, cw) if comp == 34677
            else logluv.rle_planes(raw, rows, cw, planes))
    words = words[:h, :w]
    if planes == 2:
        grey = logluv.logl_grey(words)
        if fmt == 1:
            grey = grey.view(np.uint8)
        return np.ascontiguousarray(np.repeat(grey[..., None], 3, -1))
    xyz = (logluv.luv24_to_xyz(words) if comp == 34677
           else logluv.luv32_to_xyz(words))
    return logluv.xyz_to_rgb(xyz)


def decode_tiff(data: bytes) -> np.ndarray:
    """A TIFF as [h, w, 3] RGB samples as OpenCV reads them: unsigned or
    signed 8- to 64-bit integers, float32 or float64 as stored (grey
    replicated, alpha dropped); palette, CMYK, CIELab, YCbCr and bilevel
    (CCITT too) images as uint8 colours, JPEG-compressed ones as libjpeg
    decodes them, LogLuv as float32 RGB radiance and LogL as its 8-bit
    tones."""
    order, big, ifd = _header(data)
    t = _tags(data, order, big, ifd)
    if 256 not in t or 257 not in t:
        raise IOError("TIFF: no image size")
    w, h = t[256][0], t[257][0]
    spp = t.get(277, [1])[0]
    bps = set(t.get(258, [1]))
    comp = t.get(259, [1])[0]
    photo = t.get(262, [None])[0]
    fmt = set(t.get(339, [1]))
    predictor = t.get(317, [1])[0]
    planar = t.get(284, [1])[0] == 2
    if len(bps) != 1 or len(fmt) != 1:
        raise IOError("TIFF: OpenCV reads no file of mixed bit depths or "
                      "sample formats")
    bits, fmt = bps.pop(), fmt.pop()
    unknown = comp not in _LIBTIFF
    if unknown and (bits, fmt) != (8, 1) or comp in _UNBUILT:
        # OpenCV's RGBA reader keeps its zeroed buffer where libtiff knows
        # no codec at all, at 8 bits; else it reads nothing
        raise IOError(f"TIFF: OpenCV reads no {bits}-bit file under "
                      f"compression {comp}")
    if comp == 32809 and (photo, bits, spp) != (3, 4, 1):
        raise IOError("TIFF: ThunderScan (32809) of other than a 4-bit "
                      "palette, which OpenCV does not read")
    if comp == 32766:
        raise IOError(f"TIFF: compression {comp} codes 2- or 4-bit grey, "
                      "which OpenCV does not read")
    if photo == 3 and 320 not in t:
        if bits not in (8, 16) or fmt != 1:
            raise IOError("TIFF: OpenCV reads no palette image without a "
                          f"colour map at {bits} bits")
        photo = 1                   # OpenCV reads the indices as grey
    if photo in (32844, 32845) or comp in (34676, 34677):
        return _logluv(data, t, w, h, spp, bits, fmt, comp, photo, planar)
    if comp in _CCITT and (bits != 1 or spp != 1):
        raise IOError(f"TIFF: CCITT compression {comp} of {spp} {bits}-bit "
                      "samples (libtiff decodes only 1 bit)")
    if photo == 6 and comp != 7:
        return _ycbcr(data, t, w, h, spp, bits, fmt, comp, planar,
                      predictor)
    dtype = "u1" if bits in (1, 2, 4) and fmt == 1 else _DTYPES.get(
        (bits, fmt))
    if bits == 2 or bits == 4 and photo != 3 or photo == 5 and spp != 4:
        # OpenCV reads no 2-bit file, no 4-bit grey, no CMYK with alpha
        raise IOError(f"TIFF: OpenCV reads no {bits}-bit file of "
                      f"photometric {photo} with {spp} samples")
    min_spp = {0: 1, 1: 1, 2: 3, 3: 1, 5: 4, 6: 3, 8: 3}.get(photo, 99)
    coded = comp in (5, 8, 32946)     # the codecs that run a predictor
    if dtype is None or spp < min_spp \
            or coded and (predictor not in (1, 2, 3)
                          or predictor == 3 and fmt != 3
                          or predictor == 2 and bits < 8) \
            or photo == 3 and (bits > 8 or fmt == 3) \
            or photo in (2, 5) and bits < 8 \
            or photo == 5 and (bits != 8 or t.get(332, [1])[0] != 1) \
            or photo == 8 and (bits not in (8, 16) or fmt != 1 or spp != 3
                               or planar or comp == 7) \
            or comp == 7 and (bits != 8 or photo not in (0, 1, 2, 6)
                              or spp != (1 if photo in (0, 1) else 3)
                              or planar and photo != 2):
        raise IOError(
            f"TIFF: OpenCV reads no {bits}-bit samples of format {fmt}, "
            f"photometric {photo}, compression {comp}, predictor "
            f"{predictor}, planar {int(planar)}")
    if not coded:
        predictor = 1                 # libtiff runs no predictor there
    dt = np.dtype(order + dtype)
    cw, ch, cspp, places = _chunks(t, w, h, spp, planar)
    img = np.zeros((-(-h // ch) * ch, -(-w // cw) * cw, spp),
                   dt.newbyteorder("="))
    for off, cnt, y0, x0, k in places:
        raw = data[off:off + cnt]
        if unknown:
            continue
        if comp == 7:
            chunk = _jpeg_chunk(raw, t.get(347), 1 if planar else photo)
            chunk = chunk[:ch, :cw, :cspp]
            rows = chunk.shape[0]
            img[y0:y0 + rows, x0:x0 + chunk.shape[1], k:k + cspp] = chunk
            continue
        if comp in _CCITT:
            from . import ccitt
            rows = min(ch, h - y0) if 322 not in t else ch
            options = t.get(293 if comp == 4 else 292, [0])[0]
            chunk = ccitt.decode(raw, rows, cw, comp, options,
                                 t.get(266, [1])[0])[..., None]
            img[y0:y0 + rows, x0:x0 + cw] = chunk
            continue
        if comp == 32809:
            if off + cnt > len(data):
                raise IOError("TIFF: a ThunderScan strip past the end of "
                              "the file, which OpenCV does not read")
            if 322 in t:
                continue     # libtiff decodes no tile: its zeroed buffer
            raw = _thunder(raw, min(ch, h - y0), w)
        raw = _inflate(raw, comp)
        if bits < 8:
            chunk = _unpack_bits(raw, ch, cw, bits)
        elif predictor == 3 and comp in (5, 8, 32946):
            rows = min(ch, len(raw) // (cw * cspp * dt.itemsize))
            chunk = _float_predictor(raw, rows, cw, cspp, dt.itemsize)
        else:
            rows = min(ch, len(raw) // (cw * cspp * dt.itemsize))
            chunk = np.frombuffer(raw, dt, rows * cw * cspp).reshape(
                rows, cw, cspp).astype(dt.newbyteorder("="))
        if predictor == 2 and comp in (5, 8, 32946):
            # libtiff runs a predictor only inside these codecs, and sums
            # any sample's bits as an unsigned integer of its size
            u = np.dtype(f"u{chunk.dtype.itemsize}")
            chunk = np.cumsum(chunk.view(u), axis=1, dtype=u).view(
                chunk.dtype)
        rows = chunk.shape[0]
        img[y0:y0 + rows, x0:x0 + cw, k:k + cspp] = chunk
    img = img[:h, :w]
    if photo == 3:
        cmap = np.asarray(t[320], np.int64).reshape(3, -1)
        if cmap.max() >= 256:
            cmap = cmap >> 8
        idx = np.minimum(img[..., 0].view(f"u{img.itemsize}"),
                         cmap.shape[1] - 1)
        rgb = cmap.T.astype(np.uint8)[idx]
        if bits == 1:
            return opencv_grey(rgb)
        # signed indices read as unsigned, the colours kept signed
        return np.ascontiguousarray(rgb.view(img.dtype))
    if photo == 8:
        return _cielab_to_rgb(img, t)
    if photo == 5:
        k = 255 - img[..., 3:4].astype(np.int32)
        return ((255 - img[..., :3].astype(np.int32)) * k // 255).astype(
            np.uint8)
    if photo in (0, 1):
        grey = img[..., :1]
        if bits == 1:                      # the white value is photo's
            grey = ((grey == photo) * 255).astype(np.uint8)
        elif photo == 0 and bits == 8:     # libtiff's RGBA reader inverts
            grey = np.invert(grey)
        return np.ascontiguousarray(np.repeat(grey, 3, -1))
    rgb = img[..., :3]
    if bits == 8 and spp > 3 and t.get(338, [0])[0] == 2:
        # libtiff's RGBA reader premultiplies unassociated alpha
        a = img[..., 3:4].astype(np.int32)
        rgb = ((rgb.view(np.uint8).astype(np.int32) * a + 127) // 255
               ).astype(np.uint8).view(rgb.dtype)
    return np.ascontiguousarray(rgb)


def _lzw_encode(data: bytes) -> bytes:
    """TIFF LZW as libtiff writes it: MSB-first codes from 9 bits, a clear
    code first, the width growing one code early (as `_lzw` reads it), a
    clear code when the table fills, the end code last."""
    out = bytearray()
    acc = nacc = 0
    width, nxt = 9, 258
    table: dict = {}

    def put(code):
        nonlocal acc, nacc
        acc = acc << width | code
        nacc += width
        while nacc >= 8:
            nacc -= 8
            out.append(acc >> nacc & 0xFF)
        acc &= (1 << nacc) - 1

    put(256)
    cur = -1
    for b in data:
        if cur < 0:
            cur = b
            continue
        code = table.get(cur << 8 | b)
        if code is not None:
            cur = code
            continue
        put(cur)
        table[cur << 8 | b] = nxt
        nxt += 1
        if nxt == 4094:
            put(256)
            table.clear()
            width, nxt = 9, 258
        elif nxt > (1 << width) - 1:
            width += 1
        cur = b
    if cur >= 0:
        put(cur)
        nxt += 1
        if nxt > (1 << width) - 1 and width < 12:
            width += 1
    put(257)
    if nacc:
        out.append(acc << (8 - nacc) & 0xFF)
    return bytes(out)


def encode_tiff(rgb) -> bytes:
    """A little-endian TIFF of uint8 [h, w, 3] RGB: LZW with the horizontal
    predictor, strips of about 8 KB."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    if rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"encode_tiff: expected [h, w, 3], got {rgb.shape}")
    h, w, _ = rgb.shape
    rows = max(1, 8192 // (3 * w))
    diff = rgb.copy()
    diff[:, 1:] -= rgb[:, :-1]                 # the predictor, mod 256
    strips = [_lzw_encode(diff[y:y + rows].tobytes())
              for y in range(0, h, rows)]
    n = len(strips)
    # header, IFD (12 tags), then the arrays the IFD points to, then strips
    ifd_size = 2 + 12 * 12 + 4
    extra = 8 + ifd_size
    bps_at = extra
    offs_at = bps_at + 6
    counts_at = offs_at + 4 * n
    data_at = counts_at + 4 * n
    offsets = np.cumsum([data_at] + [len(s) for s in strips[:-1]])

    def entry(tag, typ, count, value):
        return struct.pack("<HHII", tag, typ, count, value)
    ifd = struct.pack("<H", 12) + b"".join([
        entry(256, 4, 1, w), entry(257, 4, 1, h),
        entry(258, 3, 3, bps_at), entry(259, 3, 1, 5), entry(262, 3, 1, 2),
        entry(273, 4, n, offs_at if n > 1 else int(offsets[0])),
        entry(277, 3, 1, 3), entry(278, 4, 1, rows),
        entry(279, 4, n, counts_at if n > 1 else len(strips[0])),
        entry(284, 3, 1, 1), entry(317, 3, 1, 2), entry(339, 3, 1, 1)]) \
        + b"\0\0\0\0"
    arrays = struct.pack("<3H", 8, 8, 8) + np.asarray(
        offsets, "<u4").tobytes() + np.asarray(
        [len(s) for s in strips], "<u4").tobytes()
    return b"II*\0" + struct.pack("<I", 8) + ifd + arrays + b"".join(strips)
