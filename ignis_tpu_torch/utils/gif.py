"""GIF in numpy: read as OpenCV's own GIF codec reads a file, written as
its default writer writes one.

Reading: LZW with code sizes 2-8 (clear and end codes, the table frozen
when full), global and local colour tables, interlaced rows. The result
is the first frame composed as OpenCV composes it: the logical screen
filled with the background colour (the global table's background entry,
black without a global table), the frame drawn at its offset, and its
transparent pixels (a graphic control extension's transparent index)
left at the background colour.

Writing: OpenCV's default (fast) GIF writer maps every image onto one
fixed 256-entry table, red and green in 8 levels of 36 (0-252) and blue
in 4 of 85, index r << 5 | g << 2 | b, with Floyd-Steinberg error
diffusion in float32: the errors pushed to a pixel (1/16 of the upper
left's, 5/16 of the one above, 3/16 of the upper right's, 7/16 of the
left's, summed in that order) are added to its value, which goes to the
nearest level (ties up), and the difference is pushed on. `encode_gif`
does the same, computed along anti-diagonals (x + 2y constant) so that a
whole diagonal is one numpy step; it maps OpenCV's 4096 x 4096 image of
every 24-bit colour to the same indices.
"""
from __future__ import annotations

import struct

import numpy as np

_STEPS = np.array([36.0, 36.0, 85.0])      # R, G, B level spacing
_TOP = np.array([7, 7, 3])                # highest level index
_INTERLACE = ((0, 8), (4, 8), (2, 4), (1, 2))   # (first row, step)


def _blocks(data: bytes, pos: int):
    """The data sub-blocks at pos: (their bytes joined, the position after
    the terminating empty block)."""
    out = bytearray()
    n = len(data)
    while pos < n:
        size = data[pos]
        pos += 1
        if size == 0:
            break
        out += data[pos:pos + size]
        pos += size
    return bytes(out), pos


def _lzw_decode(data: bytes, min_size: int, count: int) -> np.ndarray:
    """GIF LZW (LSB-first codes from min_size + 1 bits, clear and end codes,
    the width growing when the next entry needs it, no entries added once
    the table holds 4096): the first `count` indices, short data padded
    with index 0."""
    if not 2 <= min_size <= 8:
        raise ValueError(f"GIF: LZW minimum code size {min_size}")
    clear, end = 1 << min_size, (1 << min_size) + 1
    base = [bytes([i]) for i in range(clear)] + [b"", b""]
    table = list(base)
    size = min_size + 1
    out = bytearray()
    prev = None
    acc = nacc = 0
    pos, n = 0, len(data)
    while len(out) < count:
        while nacc < size and pos < n:
            acc |= data[pos] << nacc
            nacc += 8
            pos += 1
        if nacc < size:
            break
        code = acc & ((1 << size) - 1)
        acc >>= size
        nacc -= size
        if code == clear:
            table = list(base)
            size, prev = min_size + 1, None
            continue
        if code == end:
            break
        if prev is None:
            if code >= clear:
                raise ValueError("GIF: bad first LZW code")
            entry = table[code]
        else:
            if code < len(table):
                entry = table[code]
            elif code == len(table):
                entry = prev + prev[:1]
            else:
                raise ValueError("GIF: bad LZW code")
            if len(table) < 4096:
                table.append(prev + entry[:1])
                if len(table) == 1 << size and size < 12:
                    size += 1
        out += entry
        prev = entry
    idx = np.zeros(count, np.uint8)
    got = min(len(out), count)
    idx[:got] = np.frombuffer(bytes(out[:got]), np.uint8)
    return idx


def _table(data: bytes, pos: int, flags: int):
    """The colour table of 2^(flags & 7 + 1) entries at pos, if flags has
    its table bit: ([n, 3] uint8 or None, the position after it)."""
    if not flags & 0x80:
        return None, pos
    n = 2 << (flags & 7)
    return np.frombuffer(data, np.uint8, 3 * n, pos).reshape(n, 3), \
        pos + 3 * n


def decode_gif(data: bytes) -> np.ndarray:
    """A GIF's first frame as uint8 [h, w, 3] RGB (the logical screen's
    size), composed as OpenCV composes it."""
    if data[:6] not in (b"GIF87a", b"GIF89a") or len(data) < 13:
        raise ValueError("not a GIF file")
    sw, sh, flags, bg = struct.unpack("<HHBB", data[6:12])
    gct, pos = _table(data, 13, flags)
    colour = gct[bg] if gct is not None and bg < len(gct) else \
        np.zeros(3, np.uint8)
    canvas = np.empty((sh, sw, 3), np.uint8)
    canvas[:] = colour
    transparent = None
    n = len(data)
    while pos < n:
        tag = data[pos]
        if tag == 0x3B:                       # trailer
            break
        if tag == 0x21:                       # extension
            label = data[pos + 1]
            body, nxt = _blocks(data, pos + 2)
            if label == 0xF9 and len(body) >= 4 and body[0] & 1:
                transparent = body[3]
            pos = nxt
            continue
        if tag != 0x2C:
            raise ValueError(f"GIF: unexpected block {tag:#x} at {pos}")
        x0, y0, w, h, iflags = struct.unpack("<HHHHB", data[pos + 1:pos + 10])
        lct, pos = _table(data, pos + 10, iflags)
        pal = lct if lct is not None else gct
        if pal is None:
            raise ValueError("GIF: a frame without a colour table")
        min_size = data[pos]
        lzw, pos = _blocks(data, pos + 1)
        idx = _lzw_decode(lzw, min_size, w * h).reshape(h, w)
        if iflags & 0x40:                     # interlaced rows
            rows = np.concatenate([np.arange(a, h, s) for a, s in _INTERLACE])
            flat = idx
            idx = np.empty_like(flat)
            idx[rows] = flat
        rgb = pal[np.minimum(idx, len(pal) - 1)]
        keep = np.ones((h, w), bool) if transparent is None else \
            idx != transparent
        region = canvas[y0:y0 + h, x0:x0 + w]
        hh, ww = region.shape[:2]
        region[keep[:hh, :ww]] = rgb[:hh, :ww][keep[:hh, :ww]]
        return canvas
    raise ValueError("GIF: no image")


def dither_332(rgb) -> np.ndarray:
    """OpenCV's fast GIF quantisation of uint8 [h, w, 3] RGB: [h, w] uint8
    indices into `TABLE_332` (Floyd-Steinberg in float32, see the module
    docstring)."""
    rgb = np.asarray(rgb, np.uint8)
    h, w, _ = rgb.shape
    f32 = np.float32
    img = rgb.astype(f32)
    steps = _STEPS.astype(f32)
    weights = [f32(k / 16) for k in (1, 5, 3, 7)]
    # err[y + 1, x + 1] is pixel (y, x)'s pushed error; the rim stays 0
    err = np.zeros((h + 1, w + 2, 3), f32)
    level = np.zeros((h, w, 3), np.int64)
    for t in range(w + 2 * (h - 1)):
        y = np.arange(max(0, (t - w + 2) // 2), min(h - 1, t // 2) + 1)
        x = t - 2 * y
        acc = err[y, x] * weights[0]
        for src, wt in ((err[y, x + 1], weights[1]),
                        (err[y, x + 2], weights[2]),
                        (err[y + 1, x], weights[3])):
            acc = acc + src * wt
        v = img[y, x] + acc
        k = np.clip(np.floor((v.astype(np.float64) + _STEPS / 2) / _STEPS),
                    0, _TOP)
        err[y + 1, x + 1] = v - (k * _STEPS).astype(f32)
        level[y, x] = k
    return (level[..., 0] << 5 | level[..., 1] << 2 | level[..., 2]).astype(
        np.uint8)


_I = np.arange(256)
TABLE_332 = np.stack([(_I >> 5) * 36, (_I >> 2 & 7) * 36, (_I & 3) * 85],
                     -1).astype(np.uint8)


def _lzw_encode(idx: np.ndarray, min_size: int = 8) -> bytes:
    """GIF LZW of a flat index array: a clear code first, a clear code
    whenever the table fills (4096 entries), the end code last; code
    widths as the decoder grows them."""
    clear, end = 1 << min_size, (1 << min_size) + 1
    out = bytearray()
    acc = nacc = 0
    table: dict = {}
    nxt = clear + 2
    sent = 0            # codes sent since the last clear

    def put(code):
        nonlocal acc, nacc, sent
        # the decoder adds its entries one code behind the encoder
        size = min(12, max(min_size + 1,
                           (clear + 2 + max(0, sent - 1)).bit_length()))
        acc |= code << nacc
        nacc += size
        sent += 1
        while nacc >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            nacc -= 8

    put(clear)
    sent = 0
    prefix = None
    for v in idx.tolist():
        if prefix is None:
            prefix = v
            continue
        key = (prefix, v)
        code = table.get(key)
        if code is not None:
            prefix = code
            continue
        put(prefix)
        table[key] = nxt
        nxt += 1
        prefix = v
        if nxt == 4096:
            put(clear)
            table.clear()
            nxt, sent = clear + 2, 0
    if prefix is not None:
        put(prefix)
    put(end)
    if nacc:
        out.append(acc & 0xFF)
    return bytes(out)


def encode_gif(rgb) -> bytes:
    """A GIF89a of uint8 [h, w, 3] RGB as OpenCV's default writer maps it:
    `TABLE_332` as the global colour table, `dither_332`'s indices."""
    rgb = np.asarray(rgb, np.uint8)
    if rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"encode_gif: expected [h, w, 3], got {rgb.shape}")
    h, w, _ = rgb.shape
    if not (0 < h < 65536 and 0 < w < 65536):
        raise ValueError(f"GIF: cannot encode a {w}x{h} image")
    lzw = _lzw_encode(dither_332(rgb).reshape(-1))
    body = b"".join(bytes([len(lzw[i:i + 255])]) + lzw[i:i + 255]
                    for i in range(0, len(lzw), 255))
    return (b"GIF89a" + struct.pack("<HHBBB", w, h, 0xF7, 0, 0)
            + TABLE_332.tobytes()
            + b"\x2c" + struct.pack("<HHHHB", 0, 0, w, h, 0)
            + b"\x08" + body + b"\x00\x3b")
