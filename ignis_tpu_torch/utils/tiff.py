"""TIFF in numpy: the decoder behind utils/image.py's `.tif` and `.tiff`,
read as OpenCV (libtiff) reads them, and the writer of what OpenCV writes
by default (`encode_tiff`: 8-bit RGB, little-endian, LZW with the
horizontal predictor, in strips).

One image (the first IFD) of a classic TIFF or a BigTIFF (version 43:
8-byte offsets, LONG8 and IFD8 fields), little- or big-endian, in strips
or tiles, chunky or planar samples (PlanarConfiguration 1 or 2):
uncompressed, PackBits, LZW (MSB-first codes with the early change),
Deflate, or JPEG (compression 7, its JPEGTables tag before each chunk's
stream, decoded by utils/jpeg.py); LZW and Deflate with or without the
horizontal predictor (2), or for float samples the floating-point
predictor (3), which libtiff ignores in the other codecs. Samples:
unsigned 8, 16 and 32 bits, signed 8, 16 and 32 bits (SampleFormat 2),
float 32 and 64 bits, each returned in the dtype OpenCV gives them; grey
(1 bit as 0 and 255; white-is-zero inverted at 8 bits, as libtiff's RGBA
reader inverts it, kept as stored wider), RGB, RGBA (unassociated 8-bit
alpha premultiplied, as that reader premultiplies it) and palette (4 and
8 bits; 1 bit grey, as OpenCV reads it); CMYK (photometric 5), 8 bits,
converted as libtiff's RGBA reader converts it (R = (255 - K) * (255 -
C) / 255, truncated); YCbCr (photometric 6) inside JPEG, converted by
libjpeg's integer path. Palette colours are the colour map's high bytes
(libtiff's RGBA conversion; a map whose entries all fit in 8 bits is
taken as 8-bit). What OpenCV reads nothing of (2-bit files, 4-bit grey,
CMYK with alpha, a JPEG chunk of other components) raises IOError; other
variants (CCITT and other compressions, YCbCr outside JPEG, Lab and
other photometric interpretations) raise NotImplementedError.
"""
from __future__ import annotations

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
# (bits, SampleFormat) -> the dtype OpenCV reads such samples into
_DTYPES = {(8, 1): "u1", (16, 1): "u2", (32, 1): "u4", (8, 2): "i1",
           (16, 2): "i2", (32, 2): "i4", (32, 3): "f4", (64, 3): "f8"}


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
    if frame_components(raw) != (1 if photo == 1 else 3):
        raise IOError("TIFF: a JPEG chunk's components are not the "
                      "image's samples (libtiff refuses it)")
    rgb = decode_jpeg(raw, {2: "rgb", 6: "ycc"}.get(photo))
    return rgb[..., :1] if photo == 1 else rgb


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


def decode_tiff(data: bytes) -> np.ndarray:
    """A TIFF as [h, w, 3] RGB samples as OpenCV reads them: uint8,
    uint16, uint32, int8, int16, int32, float32 or float64 as stored
    (grey replicated, alpha dropped); palette, CMYK and bilevel images as
    uint8 colours, JPEG-compressed ones as libjpeg decodes them."""
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
        raise NotImplementedError("TIFF: mixed bit depths or sample "
                                  "formats are not ported")
    bits, fmt = bps.pop(), fmt.pop()
    dtype = "u1" if bits in (1, 2, 4) and fmt == 1 else _DTYPES.get(
        (bits, fmt))
    if bits == 2 or bits == 4 and photo != 3 or photo == 5 and spp != 4:
        # OpenCV reads no 2-bit file, no 4-bit grey, no CMYK with alpha
        raise IOError(f"TIFF: OpenCV reads no {bits}-bit file of "
                      f"photometric {photo} with {spp} samples")
    min_spp = {0: 1, 1: 1, 2: 3, 3: 1, 5: 4, 6: 3}.get(photo, 99)
    if dtype is None or spp < min_spp or comp not in _CODECS \
            or predictor not in (1, 2, 3) or predictor == 3 and fmt != 3 \
            or predictor == 2 and bits < 8 \
            or photo == 3 and (bits > 8 or fmt != 1 or 320 not in t) \
            or photo in (2, 5) and bits < 8 \
            or photo == 5 and (bits != 8 or t.get(332, [1])[0] != 1) \
            or photo == 6 and comp != 7 \
            or comp == 7 and (bits != 8 or planar or photo not in (1, 2, 6)
                              or spp != (1 if photo == 1 else 3)):
        raise NotImplementedError(
            f"TIFF: {bits}-bit samples of format {fmt}, photometric {photo}, "
            f"compression {comp}, predictor {predictor}, planar "
            f"{int(planar)} are not ported")
    dt = np.dtype(order + dtype)
    cw, ch, cspp, places = _chunks(t, w, h, spp, planar)
    img = np.zeros((-(-h // ch) * ch, -(-w // cw) * cw, spp),
                   dt.newbyteorder("="))
    for off, cnt, y0, x0, k in places:
        raw = data[off:off + cnt]
        if comp == 7:
            chunk = _jpeg_chunk(raw, t.get(347), photo)[:ch, :cw]
            rows = chunk.shape[0]
            img[y0:y0 + rows, x0:x0 + chunk.shape[1]] = chunk
            continue
        if comp == 5:
            raw = _lzw(raw)
        elif comp in (8, 32946):
            raw = zlib.decompress(raw)
        elif comp == 32773:
            raw = _packbits(raw)
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
        idx = np.minimum(img[..., 0], cmap.shape[1] - 1)
        rgb = cmap.T.astype(np.uint8)[idx]
        return opencv_grey(rgb) if bits == 1 else np.ascontiguousarray(rgb)
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
