"""Baseline TIFF in numpy: the decoder behind utils/image.py's `.tif` and
`.tiff`, read as OpenCV (libtiff) reads them, and the writer of what
OpenCV writes by default (`encode_tiff`: 8-bit RGB, little-endian, LZW
with the horizontal predictor, in strips).

One image (the first IFD), little- or big-endian, in strips or tiles,
chunky samples: uncompressed, PackBits, LZW (MSB-first codes with the
early change) or Deflate; LZW and Deflate with or without the horizontal
predictor (2), or for float samples the floating-point predictor (3),
which libtiff ignores in the other two;
8- or 16-bit unsigned grey, RGB, RGBA and palette, and 32-bit float grey
or RGB. Palette colours are the colour map's high bytes (libtiff's
RGBA conversion; a map whose entries all fit in 8 bits is taken as 8-bit).
Other variants (BigTIFF, planar samples, other compressions, other
photometric interpretations) raise NotImplementedError.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

# field type -> (struct code, size)
_TYPES = {1: ("B", 1), 2: ("s", 1), 3: ("H", 2), 4: ("I", 4), 5: ("II", 8),
          6: ("b", 1), 7: ("B", 1), 8: ("h", 2), 9: ("i", 4), 10: ("ii", 8),
          11: ("f", 4), 12: ("d", 8), 16: ("Q", 8)}
_CODECS = (1, 5, 8, 32946, 32773)   # none, LZW, Deflate (2 tags), PackBits


def _tags(data: bytes, order: str) -> dict:
    """The first IFD's tags: tag -> list of values (bytes for ASCII)."""
    ifd = struct.unpack(order + "I", data[4:8])[0]
    n = struct.unpack(order + "H", data[ifd:ifd + 2])[0]
    tags = {}
    for i in range(n):
        e = ifd + 2 + 12 * i
        tag, typ, cnt = struct.unpack(order + "HHI", data[e:e + 8])
        if typ not in _TYPES:
            continue
        code, size = _TYPES[typ]
        nbytes = size * cnt
        pos = e + 8 if nbytes <= 4 else struct.unpack(
            order + "I", data[e + 8:e + 12])[0]
        raw = data[pos:pos + nbytes]
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


def _float_predictor(raw: bytes, rows: int, cw: int, spp: int):
    """Undo the floating-point predictor (3; libtiff's fpAcc) on float32
    rows: each row's bytes summed with a stride of spp, then read as four
    byte planes, most significant first."""
    b = np.frombuffer(raw, np.uint8, rows * cw * spp * 4).reshape(
        rows, cw * 4, spp)
    b = np.cumsum(b, axis=1, dtype=np.uint8).reshape(rows, 4, cw * spp)
    return np.ascontiguousarray(b.transpose(0, 2, 1)).view(">f4").reshape(
        rows, cw, spp).astype(np.float32)


def decode_tiff(data: bytes) -> np.ndarray:
    """A TIFF as [h, w, 3] RGB: uint8 or uint16 samples as stored (palette
    images as uint8 colours), float32 for float samples."""
    order = {b"II": "<", b"MM": ">"}.get(data[:2])
    if order is None or len(data) < 8:
        raise ValueError("not a TIFF file")
    magic = struct.unpack(order + "H", data[2:4])[0]
    if magic != 42:
        raise NotImplementedError(f"TIFF: version {magic} (BigTIFF) is not "
                                  "ported")
    t = _tags(data, order)
    w, h = t[256][0], t[257][0]
    spp = t.get(277, [1])[0]
    bps = set(t.get(258, [1]))
    comp = t.get(259, [1])[0]
    photo = t.get(262, [None])[0]
    fmt = t.get(339, [1])[0]
    predictor = t.get(317, [1])[0]
    if len(bps) != 1 or t.get(284, [1])[0] != 1:
        raise NotImplementedError("TIFF: mixed bit depths or planar samples "
                                  "are not ported")
    bits = bps.pop()
    dtype = {(8, 1): "u1", (16, 1): "u2", (32, 3): "f4"}.get((bits, fmt))
    if dtype is None or photo not in (1, 2, 3) or comp not in _CODECS \
            or predictor not in (1, 2, 3) or (predictor == 3) != (fmt == 3) \
            and predictor != 1 or photo == 3 and (bits != 8 or 320 not in t):
        raise NotImplementedError(
            f"TIFF: {bits}-bit samples of format {fmt}, photometric {photo}, "
            f"compression {comp}, predictor {predictor} are not ported")
    dt = np.dtype(order + dtype)
    if 322 in t:
        cw, ch = t[322][0], t[323][0]
        offsets, counts = t[324], t[325]
        across = -(-w // cw)
        places = [((i // across) * ch, (i % across) * cw)
                  for i in range(len(offsets))]
    else:
        cw, ch = w, t.get(278, [h])[0]
        offsets, counts = t[273], t[279]
        places = [(i * ch, 0) for i in range(len(offsets))]
    img = np.zeros((-(-h // ch) * ch, -(-w // cw) * cw, spp), dt.newbyteorder(
        "="))
    for off, cnt, (y0, x0) in zip(offsets, counts, places):
        raw = data[off:off + cnt]
        if comp == 5:
            raw = _lzw(raw)
        elif comp in (8, 32946):
            raw = zlib.decompress(raw)
        elif comp == 32773:
            raw = _packbits(raw)
        rows = min(ch, len(raw) // (cw * spp * dt.itemsize))
        if predictor == 3 and comp in (5, 8, 32946):
            chunk = _float_predictor(raw, rows, cw, spp)
        else:
            chunk = np.frombuffer(raw, dt, rows * cw * spp).reshape(
                rows, cw, spp).astype(dt.newbyteorder("="))
        if predictor == 2 and comp in (5, 8, 32946):
            # libtiff runs a predictor only inside these codecs
            chunk = np.cumsum(chunk, axis=1, dtype=chunk.dtype)
        img[y0:y0 + rows, x0:x0 + cw] = chunk
    img = img[:h, :w]
    if photo == 3:
        cmap = np.asarray(t[320], np.int64).reshape(3, -1)
        if cmap.max() >= 256:
            cmap = cmap >> 8
        return np.ascontiguousarray(cmap.T.astype(np.uint8)[img[..., 0]])
    if photo == 1:
        return np.ascontiguousarray(np.repeat(img[..., :1], 3, -1))
    if spp < 3:
        raise NotImplementedError(f"TIFF: RGB with {spp} samples")
    return np.ascontiguousarray(img[..., :3])


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
