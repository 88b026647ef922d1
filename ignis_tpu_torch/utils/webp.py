"""WebP in numpy: read as OpenCV reads it through libwebp, and written
lossless, as OpenCV writes it by default.

The RIFF container holds one `VP8 ` (lossy), `VP8L` (lossless) or `VP8X`
(extended) chunk; an extended file's `ALPH` chunk is skipped (the alpha
does not change libwebp's RGB, and ignis_tpu drops alpha), and an
animation (`ANIM` / `ANMF`) gives its first frame on a canvas of
transparent black, as OpenCV returns it.

VP8L (RFC 9649): prefix-code groups with their meta prefix image, LZ77
backward references with the 120-entry distance map, the colour cache,
and the four transforms (predictor with its 14 modes, cross-colour,
subtract-green, colour indexing with pixel bundling). The entropy decode
is serial; the transforms are numpy, the predictor along anti-diagonals
(x + 2y constant), since a pixel reads its left and upper-right
neighbours.

VP8 (RFC 6386, key frames, as libwebp decodes them): the boolean decoder,
the frame header (segments, filter type and level, mode and reference
deltas, token partitions, quantiser deltas, coefficient probability
updates), 16x16 and 4x4 luma and chroma intra prediction from the
unfiltered neighbours, the inverse DCT and WHT, then the normal or simple
loop filter and libwebp's fancy 4:2:0 upsampler with its fixed-point
YUV -> RGB (`WebPDecodeBGR`, OpenCV's path). The token decode and the
prediction go macroblock by macroblock; the transforms run on every
block at once, and the loop filter on every macroblock of an
anti-diagonal (x + 2y constant) at once, an order in which no two
macroblocks of one step touch the same pixels.

The writer (`encode_webp`) makes a lossless file: the subtract-green
transform and one group of prefix codes over literal pixels.
"""
from __future__ import annotations

import heapq
import struct

import numpy as np

# ---------------------------------------------------------------------------
# RIFF container
# ---------------------------------------------------------------------------


def _chunks(data: bytes, pos: int, end: int):
    """(fourcc, payload start, payload size) of the RIFF chunks in
    data[pos:end] (payloads padded to even sizes)."""
    out = []
    while pos + 8 <= end:
        tag = data[pos:pos + 4]
        size = struct.unpack("<I", data[pos + 4:pos + 8])[0]
        out.append((tag, pos + 8, size))
        pos += 8 + size + (size & 1)
    return out


def _decode_frame(data: bytes, chunks) -> np.ndarray:
    for tag, start, size in chunks:
        if tag == b"VP8L":
            return decode_vp8l(data[start:start + size])
        if tag == b"VP8 ":
            return decode_vp8(data[start:start + size])
    raise ValueError("WebP: no VP8 or VP8L image chunk")


def decode_webp(data: bytes) -> np.ndarray:
    """A WebP file as uint8 [h, w, 3] RGB, as OpenCV reads it."""
    if len(data) < 20 or data[:4] != b"RIFF" or data[8:12] != b"WEBP":
        raise ValueError("not a WebP file")
    end = min(len(data), 8 + struct.unpack("<I", data[4:8])[0])
    chunks = _chunks(data, 12, end)
    if not chunks:
        raise ValueError("WebP: empty container")
    tag, start, _ = chunks[0]
    if tag == b"VP8X":
        flags = data[start]
        cw = int.from_bytes(data[start + 4:start + 7], "little") + 1
        ch = int.from_bytes(data[start + 7:start + 10], "little") + 1
        if flags & 0x02:                      # animation
            for t, s, n in chunks:
                if t == b"ANMF":
                    x0 = 2 * int.from_bytes(data[s:s + 3], "little")
                    y0 = 2 * int.from_bytes(data[s + 3:s + 6], "little")
                    frame = _decode_frame(data, _chunks(data, s + 16, s + n))
                    canvas = np.zeros((ch, cw, 3), np.uint8)
                    region = canvas[y0:y0 + frame.shape[0],
                                    x0:x0 + frame.shape[1]]
                    region[:] = frame[:region.shape[0], :region.shape[1]]
                    return canvas
            raise ValueError("WebP: an animation without frames")
    return _decode_frame(data, chunks)


# ---------------------------------------------------------------------------
# VP8L: lossless
# ---------------------------------------------------------------------------

# the 120 (dx, dy) offsets of the short distance codes, as libwebp's
# kCodeToPlane: dy << 4 | (8 - dx)
_CODE_TO_PLANE = bytes.fromhex(
    "1807171928062729161a262a38053739151b363a252b48044749141c353b464a"
    "242c58454b343c035759131d565a232d444c555b333d68026769121e666a222e"
    "545c434d656b323e78017779535d111f646c424e767a212f757b313f636d525e"
    "00747c414f1020626e30737d515f40727e616f50717f6070")
_CODE_TO_PLANE_LIST = list(_CODE_TO_PLANE)
_LENGTH_ORDER = (17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13,
                 14, 15)
_ALPHABET = (256 + 24, 256, 256, 256, 40)


class _LBits:
    """LSB-first bit reader over a VP8L stream; reads past the end give
    zeros."""

    def __init__(self, data: bytes):
        b = np.frombuffer(bytes(data) + bytes(8), np.uint8).astype(np.uint32)
        self.win = (b[:-3] | b[1:-2] << 8 | b[2:-1] << 16
                    | b[3:] << 24).tolist()
        self.pos = 0
        self.end = 8 * len(data)

    def read(self, n: int) -> int:
        p = self.pos
        self.pos = p + n
        return (self.win[p >> 3] >> (p & 7)) & ((1 << n) - 1)


def _reverse(code: int, n: int) -> int:
    return int(format(code, f"0{n}b")[::-1], 2) if n else 0


def _prefix_table(lengths):
    """A canonical prefix code (lengths by symbol, 0 = unused) as a lookup
    of the next max-length bits, LSB first: (table of symbol << 4 |
    length, mask). One used symbol takes no bits."""
    lengths = np.asarray(lengths, np.int64)
    used = np.flatnonzero(lengths)
    if len(used) == 0:
        raise ValueError("WebP: an empty prefix code")
    if len(used) == 1:
        return [int(used[0]) << 4], 0
    ls = lengths[used]
    if (np.sum(2.0 ** -ls.astype(np.float64)) != 1.0) or ls.max() > 15:
        raise ValueError("WebP: a prefix code that is not complete")
    m = int(ls.max())
    table = np.zeros(1 << m, np.int64)
    code = 0
    for n in range(1, m + 1):
        for s in used[ls == n]:
            table[_reverse(code, n)::1 << n] = int(s) << 4 | n
            code += 1
        code <<= 1
    return table.tolist(), (1 << m) - 1


def _read_symbol(br: _LBits, code) -> int:
    table, mask = code
    p = br.pos
    e = table[(br.win[p >> 3] >> (p & 7)) & mask]
    br.pos = p + (e & 15)
    return e >> 4


def _read_code(br: _LBits, alphabet: int):
    """One prefix code of the stream (simple or normal) as _prefix_table."""
    lengths = np.zeros(alphabet, np.int64)
    if br.read(1):                            # simple code
        count = br.read(1) + 1
        first = br.read(8 if br.read(1) else 1)
        lengths[first] = 1
        if count == 2:
            lengths[br.read(8)] = 1
        return _prefix_table(lengths)
    cl = [0] * 19
    for i in range(br.read(4) + 4):
        cl[_LENGTH_ORDER[i]] = br.read(3)
    cl_code = _prefix_table(cl)
    if br.read(1):
        max_symbol = 2 + br.read(2 + 2 * br.read(3))
        if max_symbol > alphabet:
            raise ValueError("WebP: max_symbol past the alphabet")
    else:
        max_symbol = alphabet
    symbol, prev = 0, 8
    while symbol < alphabet and max_symbol > 0:
        max_symbol -= 1
        c = _read_symbol(br, cl_code)
        if c < 16:
            lengths[symbol] = c
            symbol += 1
            if c:
                prev = c
            continue
        extra, offset = ((2, 3), (3, 3), (7, 11))[c - 16]
        repeat = br.read(extra) + offset
        if symbol + repeat > alphabet:
            raise ValueError("WebP: code lengths past the alphabet")
        lengths[symbol:symbol + repeat] = prev if c == 16 else 0
        symbol += repeat
    return _prefix_table(lengths)


def _prefix_value(symbol: int, br: _LBits) -> int:
    """A length or distance from its prefix symbol and extra bits."""
    if symbol < 4:
        return symbol + 1
    extra = (symbol - 2) >> 1
    return ((2 + (symbol & 1)) << extra) + br.read(extra) + 1


def _subsample(size: int, bits: int) -> int:
    return (size + (1 << bits) - 1) >> bits


def _decode_pixels(br, w, h, groups, meta, hbits, hw, cache_bits):
    """The entropy-coded ARGB pixels of a w x h image as a flat list."""
    n = w * h
    out = []
    append = out.append
    win = br.win
    pos = br.pos
    cache = [0] * (1 << cache_bits) if cache_bits else None
    shift = 32 - cache_bits
    cached = 0
    limit = 256 + 24
    planes = _CODE_TO_PLANE_LIST
    k = x = y = 0
    block = -1
    while k < n:
        if meta is not None or block < 0:
            b = (y >> hbits) * hw + (x >> hbits) if meta is not None else 0
            if b != block:
                block = b
                group = groups[meta[b] if meta is not None else 0]
                (gt, gm), (rt, rm), (bt, bm), (at, am) = group[:4]
        e = gt[(win[pos >> 3] >> (pos & 7)) & gm]
        pos += e & 15
        code = e >> 4
        if code < 256:
            er = rt[(win[pos >> 3] >> (pos & 7)) & rm]
            pos += er & 15
            eb = bt[(win[pos >> 3] >> (pos & 7)) & bm]
            pos += eb & 15
            ea = at[(win[pos >> 3] >> (pos & 7)) & am]
            pos += ea & 15
            append((ea >> 4) << 24 | (er >> 4) << 16 | code << 8 | eb >> 4)
            k += 1
            x += 1
        elif code < limit:                     # backward reference
            br.pos = pos
            length = _prefix_value(code - 256, br)
            dcode = _prefix_value(_read_symbol(br, group[4]), br)
            pos = br.pos
            if dcode > 120:
                dist = dcode - 120
            else:
                d = planes[dcode - 1]
                dist = max(1, (d >> 4) * w + 8 - (d & 15))
            start = k - dist
            if start < 0 or k + length > n:
                raise ValueError("WebP: a backward reference out of range")
            if dist >= length:
                out += out[start:start + length]
            else:
                out += (out[start:] * (length // dist + 1))[:length]
            k += length
            x += length
        else:                                  # colour cache
            if cache is None:
                raise ValueError("WebP: a cache code without a cache")
            for v in out[cached:]:
                cache[((v * 0x1E35A7BD) & 0xFFFFFFFF) >> shift] = v
            cached = k
            append(cache[code - limit])
            k += 1
            x += 1
        if x >= w:
            y += x // w
            x %= w
    if pos > br.end + 64:
        raise ValueError("WebP: lossless data ends early")
    br.pos = pos
    return out


def _decode_stream(br: _LBits, w: int, h: int, level0: bool):
    """One VP8L image stream (the main image when level0, else a
    transform's or the meta codes' sub-image): [h, w] uint32 ARGB."""
    transforms = []
    if level0:
        while br.read(1):
            kind = br.read(2)
            if any(t[0] == kind for t in transforms):
                raise ValueError("WebP: a transform used twice")
            if kind in (0, 1):                 # predictor, cross-colour
                bits = br.read(3) + 2
                sub = _decode_stream(br, _subsample(w, bits),
                                     _subsample(h, bits), False)
                transforms.append((kind, bits, sub, w))
            elif kind == 2:                    # subtract green
                transforms.append((kind, 0, None, w))
            else:                              # colour indexing
                count = br.read(8) + 1
                bits = 3 if count <= 2 else 2 if count <= 4 else \
                    1 if count <= 16 else 0
                table = _decode_stream(br, count, 1, False)[0]
                table = _pack_channels([np.cumsum(c) & 255 for c in
                                        _channels(table.astype(np.int64))])
                transforms.append((kind, bits, table, w))
                w = _subsample(w, bits)
    cache_bits = 0
    if br.read(1):
        cache_bits = br.read(4)
        if not 1 <= cache_bits <= 11:
            raise ValueError(f"WebP: colour cache of {cache_bits} bits")
    meta, hbits, hw = None, 0, 0
    if level0 and br.read(1):
        hbits = br.read(3) + 2
        hw = _subsample(w, hbits)
        ent = _decode_stream(br, hw, _subsample(h, hbits), False)
        meta = ((ent >> 8) & 0xFFFF).reshape(-1).tolist()
    ngroups = max(meta) + 1 if meta is not None else 1
    sizes = list(_ALPHABET)
    if cache_bits:
        sizes[0] += 1 << cache_bits
    groups = [[_read_code(br, a) for a in sizes] for _ in range(ngroups)]
    px = np.array(_decode_pixels(br, w, h, groups, meta, hbits, hw,
                                 cache_bits), np.uint32).reshape(h, w)
    for kind, bits, sub, tw in reversed(transforms):
        if kind == 0:
            px = _inverse_predictor(px, bits, sub)
        elif kind == 1:
            px = _inverse_cross_colour(px, bits, sub)
        elif kind == 2:
            g = (px >> 8) & 0xFF
            px = (px & 0xFF00FF00) | (((px >> 16) + g) & 0xFF) << 16 | \
                ((px + g) & 0xFF)
        else:
            px = _inverse_indexing(px, bits, sub, tw)
    return px


def _blocks_of(sub, bits, h, w):
    """A sub-image's value for every pixel of an h x w image."""
    return np.repeat(np.repeat(sub, 1 << bits, 0), 1 << bits, 1)[:h, :w]


def _inverse_cross_colour(px, bits, sub):
    h, w = px.shape
    m = _blocks_of(sub, bits, h, w).astype(np.int64)
    g2r = ((m & 255) ^ 128) - 128
    g2b = (((m >> 8) & 255) ^ 128) - 128
    r2b = (((m >> 16) & 255) ^ 128) - 128
    p = px.astype(np.int64)
    green = (((p >> 8) & 255) ^ 128) - 128
    red = ((p >> 16) + ((g2r * green) >> 5)) & 255
    blue = p + ((g2b * green) >> 5) + ((r2b * ((red ^ 128) - 128)) >> 5)
    return ((p & 0xFF00FF00) | red << 16 | (blue & 255)).astype(np.uint32)


def _inverse_indexing(px, bits, table, w):
    h = px.shape[0]
    pal = np.zeros(256, np.uint32)
    pal[:len(table)] = table[:256]
    idx = (px >> 8) & 255
    if bits:
        per = 1 << bits
        bpp = 8 >> bits
        x = np.arange(w)
        idx = (idx[:, x >> bits] >> ((x & (per - 1)) * bpp)[None, :]) & \
            ((1 << bpp) - 1)
    return pal[idx[:, :w].reshape(h, w)]


def _avg2(a, b):
    """The per-channel floor average of ARGB arrays."""
    return (((a ^ b) & 0xFEFEFEFE) >> 1) + (a & b)


def _channels(px):
    return [(px >> s) & 255 for s in (24, 16, 8, 0)]


def _pack_channels(ch):
    return ch[0] << 24 | ch[1] << 16 | ch[2] << 8 | ch[3]


def _predictions(left, t, tl, tr):
    """The 16 predictor modes' values (RFC 9649 4.1; 14 and 15 are black,
    as libwebp pads its table) for arrays of neighbours."""
    black = np.full_like(t, 0xFF000000)
    cl, ct, ctl = _channels(left), _channels(t), _channels(tl)
    select = np.where(sum(np.abs(a - c) - np.abs(b - c)
                          for a, b, c in zip(cl, ct, ctl)) <= 0, t, left)
    full = _pack_channels([np.clip(a + b - c, 0, 255)
                           for a, b, c in zip(cl, ct, ctl)])
    half = []
    for a, c in zip(_channels(_avg2(left, t)), ctl):
        d = a - c
        half.append(np.clip(a + np.where(d >= 0, d >> 1, -((-d) >> 1)),
                            0, 255))                # C's truncation
    return [black, left, t, tr, tl, _avg2(_avg2(left, tr), t),
            _avg2(left, tl), _avg2(left, t), _avg2(tl, t), _avg2(t, tr),
            _avg2(_avg2(left, tl), _avg2(t, tr)), select, full,
            _pack_channels(half), black, black]


def _add_argb(a, b):
    return (((a & 0xFF00FF00) + (b & 0xFF00FF00)) & 0xFF00FF00) | \
        (((a & 0x00FF00FF) + (b & 0x00FF00FF)) & 0x00FF00FF)


def _inverse_predictor(px, bits, sub):
    """Undo the predictor transform. A pixel reads its left, top-left, top
    and top-right neighbours (the rightmost pixel's top-right is the first
    of its own row), so every pixel with equal x + 2y is decoded at once,
    in increasing x + 2y."""
    h, w = px.shape
    res = px.astype(np.int64).reshape(-1)
    modes = ((_blocks_of(sub, bits, h, w) >> 8) & 15).astype(np.int64)
    modes[:, 0] = 2                            # column 0: the top pixel
    modes[0, :] = 1                            # row 0: the left pixel
    modes[0, 0] = 0                            # black
    modes = modes.reshape(-1)
    out = np.zeros(h * w, np.int64)
    for t in range(w + 2 * (h - 1)):
        y = np.arange(max(0, (t - w + 2) // 2), min(h - 1, t // 2) + 1)
        x = t - 2 * y
        i = y * w + x
        up = np.maximum(i - w, 0)
        left = out[np.maximum(i - 1, 0)]
        top = out[up]
        tl = out[np.maximum(up - 1, 0)]
        tr = np.where(x == w - 1, out[y * w], out[np.minimum(up + 1,
                                                             h * w - 1)])
        pred = np.choose(modes[i], _predictions(left, top, tl, tr))
        out[i] = _add_argb(res[i], pred)
    return out.reshape(h, w).astype(np.uint32)


def decode_vp8l(data: bytes) -> np.ndarray:
    """A VP8L bitstream (the chunk's payload) as uint8 [h, w, 3] RGB."""
    if len(data) < 5 or data[0] != 0x2F:
        raise ValueError("WebP: not a VP8L bitstream")
    br = _LBits(data[1:])
    w = br.read(14) + 1
    h = br.read(14) + 1
    br.read(1)                                 # alpha hint
    if br.read(3) != 0:
        raise ValueError("WebP: VP8L version is not 0")
    px = _decode_stream(br, w, h, True)
    return np.stack(_channels(px)[1:], -1).astype(np.uint8)


# ---------------------------------------------------------------------------
# VP8: lossy key frames
# ---------------------------------------------------------------------------

# RFC 6386's constant tables, byte for byte: the default coefficient
# probabilities [4][8][3][11] (13.5), their update probabilities (13.4),
# the key-frame subblock-mode probabilities [10][10][9] (11.5), and the
# DC (uint8) and AC (little-endian uint16) quantiser steps [128] (14.1)
_COEFF_PROBS = bytes.fromhex(
    "8080808080808080808080808080808080808080808080808080808080808080"
    "80fd88feffe4db8080808080bd81f2ffe3d5ffdb8080806a7ee3fcd6d1ffff80"
    "80800162f8ffece2ffff808080b585eefeddeaff9a8080804e86caf7c6b4ffdb"
    "80808001b9f9fff3ff8080808080b896f7ffece080808080804d6ed8ffece680"
    "808080800165fbfff1ff8080808080aa8bf1fcecd1ffff8080802574c4f3e4ff"
    "ffff80808001ccfefff5ff8080808080cfa0faffee8080808080806667e7ffd3"
    "ab80808080800198fcfff0ff8080808080b187f3ffeae180808080805081d3ff"
    "c2e080808080800101ff8080808080808080f601ff8080808080808080ff8080"
    "8080808080808080c623eddfc1bba2a0919b3e832dc6ddacb0dc9dfcdd01442f"
    "92d095a7dda2ffdf800195f1ffdde0ffff808080b88deafddedcffc780808051"
    "63b5f2b0bef9caffff800181e8fdd6c5f2c4ffff806379d2fac9c6ffca808080"
    "175ba3f2aabbf7d2ffff8001c8f6ffeaff80808080806db2f1ffe7f5ffff8080"
    "802c82c9fdcdc0ffff8080800184effbdbd1ffa58080805e88e1fbdabeffff80"
    "80801664aef5baa1ffc780808001b6f9ffe8eb80808080807c8ff1ffe3ea8080"
    "808080234db5fbc1d3ffcd808080019df7ffece7ffff808080798debffe1e3ff"
    "ff8080802d63bcfbc3d9ffe08080800101fbffd5ff8080808080cb01f8ffff80"
    "80808080808901b1ffe0ff8080808080fd09f8fbcfd0ffc0808080af0de0f3c1"
    "b9f9c6ffff804911abdda1b3eca7ffea80015ff7fdd4b7ffff808080ef5af4fa"
    "d3d1ffff8080809b4dc3f8bcc3ffff8080800118effbdadbffcd808080c933db"
    "ffc4ba8080808080452ebeefc9daffe480808001bffbffff808080808080dfa5"
    "f9ffd5ff80808080808d7cf8ffff8080808080800110f8ffff808080808080be"
    "24e6ffecff80808080809501ff808080808080808001e2ff8080808080808080"
    "f7c0ff8080808080808080f080ff80808080808080800186fcffff8080808080"
    "80d53efaffff808080808080375dff8080808080808080808080808080808080"
    "808080808080808080808080808080808080808080808080ca18d5ebbabfdca0"
    "f0afff7e26b6e8a9b8e4aeffbb803d2e8adb97b2f0aaffd8800170e6fac7bff7"
    "9fffff80a66de4fcd3d7ffae808080274da2e8acb4f5b2ffff800134dcf6c6c7"
    "f9dcffff807c4abff3b7c1faddffff80184782db9aaaf3b6ffff8001b6e1f9db"
    "f0ffe08080809596e2fcd8cdffab8080801c6caaf2b7c2fedfffff800151e6fc"
    "cccbffc08080807b66d1f7bcc4ffe9808080145f99f3a4adffcb80808001def8"
    "ffd8d58080808080a8aff6fcebcdffff8080802f74d7ffd3d4ffff8080800179"
    "ecfdd4d6ffff8080808d54d5fcc9caffdb8080802a50a0f0a2b9ffcd80808001"
    "01ff8080808080808080f401ff8080808080808080ee01ff8080808080808080")

_COEFF_UPDATE_PROBS = bytes.fromhex(
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "ffb0f6ffffffffffffffffffdff1fcfffffffffffffffff9fdfdffffffffffff"
    "fffffff4fcffffffffffffffffeafefefffffffffffffffffdffffffffffffff"
    "fffffffff6feffffffffffffffffeffdfefffffffffffffffffefffeffffffff"
    "fffffffffff8fefffffffffffffffffbfffeffffffffffffffffffffffffffff"
    "fffffffffffffdfefffffffffffffffffbfefefffffffffffffffffefffeffff"
    "fffffffffffffffefdfffefffffffffffffafffefffefffffffffffffeffffff"
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "ffffffffffffffffd9ffffffffffffffffffffe1fcf1fdfffffeffffffffeafa"
    "f1fafdfffdfefffffffffeffffffffffffffffffdffefeffffffffffffffffee"
    "fdfefefffffffffffffffff8fefffffffffffffffff9feffffffffffffffffff"
    "fffffffffffffffffffffffffdfffffffffffffffffff7feffffffffffffffff"
    "fffffffffffffffffffffffffffdfefffffffffffffffffcffffffffffffffff"
    "fffffffffffffffffffffffffffffefefffffffffffffffffdffffffffffffff"
    "fffffffffffffffffffffffffffffffefdfffffffffffffffffaffffffffffff"
    "fffffffffeffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "ffffffffffffffffffffffffffffffffbafbfaffffffffffffffffeafbf4feff"
    "fffffffffffffbfbf3fdfefffefffffffffffdfeffffffffffffffffecfdfeff"
    "fffffffffffffffbfdfdfefefffffffffffffffefefffffffffffffffffefefe"
    "fffffffffffffffffffffffffffffffffffffffffefffffffffffffffffffefe"
    "fffffffffffffffffffefffffffffffffffffffffffffffffffffffffffffffe"
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "fffffffffffffffffffffffffffffffffffffffffffffffff8ffffffffffffff"
    "fffffffafefcfefffffffffffffff8fef9fdfffffffffffffffffdfdffffffff"
    "fffffffff6fdfdfffffffffffffffffcfefbfefefffffffffffffffefcffffff"
    "fffffffffff8fefdfffffffffffffffffdfffefefffffffffffffffffbfeffff"
    "fffffffffffff5fbfefffffffffffffffffdfdfefffffffffffffffffffbfdff"
    "fffffffffffffffcfdfefffffffffffffffffffefffffffffffffffffffffcff"
    "fffffffffffffffff9fffefffffffffffffffffffffeffffffffffffffffffff"
    "fdfffffffffffffffffaffffffffffffffffffffffffffffffffffffffffffff"
    "fffffffffffffffffffffeffffffffffffffffffffffffffffffffffffffffff")

_BMODE_PROBS = bytes.fromhex(
    "e7783059737178987098b3407eaa762e465faf458f505552489b67383a0aabda"
    "bd110d98721a11a32cc3150aad791850c31a3e2c405590470a26abd590221aaa"
    "2e371388a021ce473f14087272d00c09e251280b60b6541d102486b759896265"
    "6aa59448bb64829d6f204b504266a7634a3e28ea80293509b2f18d1a086b4a2b"
    "1a9249a631179d412669a033341f7380684f0c1bd9ff5711075744472c72330f"
    "ba172f290e6eb6b71511c2422d1966c5bd171216585893962a2e2dc4cd2b61b7"
    "75552623b33d2735c8571a152be8ab3822336872661d5d4d271c55ab3aa55a62"
    "40221674ce17222ba6496b36201a3301512b1f44196a1640ab24e17222131566"
    "84bc104c7c3e124e5f5539323033c165239fd76f592e6f3c941facdbe415126f"
    "70714d55b3ff267872282a01c4f5d10a196d582b1d8ca6d5252b9a3d3f1e9b43"
    "2d4401d16450082b9a01331a478e4e4e10ff8022c5ab29280566d3b70401dd33"
    "3211a8d1c01719528a1f24ab1ba6262ce543573aa952731a3bb33f3b5ab43ba6"
    "5d499a282815748fd12227af2f0f10b722df312db72e1121b706620f20b7392e"
    "16188001361125412049731c801780cd2803097333c01206df572509733b4d40"
    "152f68372cda09363582e2405a46cd2829171a39363970b8052926a6d51e221a"
    "8598740a2086271335dd1a722049ff1f0941ea020f0176494b200c33c0ffa02b"
    "33581f2343665537ba553815176f3bcd2d25c03726467c49660122627d622a58"
    "685575af525f543559806471652d4b4f7b2f338051ab01391105476639352931"
    "26210d7939491a0155290a438a4d6e5a2f727315020a66ffa61706651d100a55"
    "8065c41a39120a6666d522142b75140f24a38044011a663d472522351ff3c045"
    "3c472649771cde25442d8022012f0bf5ab3e1113469255373e46252b259a64a3"
    "55a0013f095c881c4020c9554b0f090940ffb8771056061c0540ff19f8013808"
    "118489ff3774803a0f145287391a7928a4321f899a851923da33672c83837b1f"
    "069e5628408794e02db780161a1183f09a0e01d12d10155b40de0701c5381527"
    "9b3c8a1766d5530c0d36c0ff442f1c551a555580802092ab120b073f90ab0404"
    "f6231b0a92aeab0c1a80be502363b4507e362d557e2f57b033291420654b808b"
    "769274805538290fb0ec5525093e471e117776ff11128a65263c8a37462b1a8e"
    "9224131eabff611b148a2d3d3edb0151bc4020291475978e1415a370130c3dc3"
    "80300418")

_DC_TABLE = bytes.fromhex(
    "0405060708090a0a0b0c0d0e0f101111121314141515161617171819191a1b1c"
    "1d1e1f20212223242525262728292a2b2c2d2e2e2f303132333435363738393a"
    "3b3c3d3e3f404142434445464748494a4b4c4c4d4e4f50515253545556575859"
    "5b5d5f6062646566686a6c6e707274767a7c7e80828486888a8c8f9194979a9d")

_AC_TABLE = bytes.fromhex(
    "0400050006000700080009000a000b000c000d000e000f001000110012001300"
    "1400150016001700180019001a001b001c001d001e001f002000210022002300"
    "2400250026002700280029002a002b002c002d002e002f003000310032003300"
    "3400350036003700380039003a003c003e00400042004400460048004a004c00"
    "4e00500052005400560058005a005c005e00600062006400660068006a006c00"
    "6e0070007200740077007a007d0080008300860089008c008f00920095009800"
    "9b009e00a100a400a700aa00ad00b100b500b900bd00c100c500c900cd00d100"
    "d500d900dd00e100e500ea00ef00f500f900fe00030108010d01120117011c01")
_ZIGZAG = (0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15)
_BANDS = (0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0)
_CAT_PROBS = ((173, 148, 140), (176, 155, 140, 135),
              (180, 157, 141, 134, 130),
              (254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129))
# range -> the shift that brings it back to 128-255
_NORM = [0] + [7 - r.bit_length() + 1 for r in range(1, 256)]
# intra modes, as libwebp numbers them
_DC, _TM, _VE, _HE, _RD, _VR, _LD, _VL, _HD, _HU = range(10)


class _BoolDecoder:
    """RFC 6386's boolean decoder over data[start:end]; reads past the end
    give zeros. `value` holds `bits` bits below the 8-bit window that is
    compared with the split."""

    def __init__(self, data: bytes, start: int, end: int):
        self.data, self.pos, self.end = data, start, end
        self.value, self.bits, self.range = 0, -8, 255

    def get(self, prob: int) -> int:
        split = 1 + (((self.range - 1) * prob) >> 8)
        if self.bits < 0:
            n = min(7, self.end - self.pos)
            if n > 0:
                self.value = self.value << (8 * n) | int.from_bytes(
                    self.data[self.pos:self.pos + n], "big")
                self.pos += n
                self.bits += 8 * n
            else:
                self.value <<= 8
                self.bits += 8
        big = split << self.bits
        if self.value >= big:
            self.range -= split
            self.value -= big
            bit = 1
        else:
            self.range = split
            bit = 0
        if self.range < 128:
            s = _NORM[self.range]
            self.range <<= s
            self.bits -= s
        return bit

    def literal(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = v << 1 | self.get(128)
        return v

    def signed(self, n: int) -> int:
        v = self.literal(n)
        return -v if self.get(128) else v

    def optional_signed(self, n: int) -> int:
        return self.signed(n) if self.get(128) else 0


def _large_value(get, p) -> int:
    """libwebp's GetLargeValue: a token above 1 (categories 3-6 with their
    extra bits)."""
    if not get(p[3]):
        if not get(p[4]):
            return 2
        return 3 + get(p[5])
    if not get(p[6]):
        if not get(p[7]):
            return 5 + get(159)
        return 7 + 2 * get(165) + get(145)
    bit1 = get(p[8])
    cat = 2 * bit1 + get(p[9 + bit1])
    v = 0
    for prob in _CAT_PROBS[cat]:
        v = v + v + get(prob)
    return v + 3 + (8 << cat)


def _coeffs(get, bands, ctx, dq, n, out, off) -> int:
    """libwebp's GetCoeffs: one block's tokens from position n, dequantised
    into out[off + raster index]; returns the position after the last
    token (16 when the block runs to its end)."""
    p = bands[n][ctx]
    while n < 16:
        if not get(p[0]):
            return n
        while not get(p[1]):
            n += 1
            if n == 16:
                return 16
            p = bands[n][0]
        if not get(p[2]):
            v = 1
            p = bands[n + 1][1]
        else:
            v = _large_value(get, p)
            p = bands[n + 1][2]
        out[off + _ZIGZAG[n]] = (-v if get(128) else v) * dq[n > 0]
        n += 1
    return 16


def _wht(dc):
    """libwebp's TransformWHT: the 16 luma DCs from the Y2 block."""
    tmp = [0] * 16
    for i in range(4):
        a0 = dc[i] + dc[12 + i]
        a1 = dc[4 + i] + dc[8 + i]
        a2 = dc[4 + i] - dc[8 + i]
        a3 = dc[i] - dc[12 + i]
        tmp[i], tmp[8 + i] = a0 + a1, a0 - a1
        tmp[4 + i], tmp[12 + i] = a3 + a2, a3 - a2
    out = [0] * 16
    for i in range(4):
        d = tmp[4 * i] + 3
        a0 = d + tmp[4 * i + 3]
        a1 = tmp[4 * i + 1] + tmp[4 * i + 2]
        a2 = tmp[4 * i + 1] - tmp[4 * i + 2]
        a3 = d - tmp[4 * i + 3]
        out[4 * i:4 * i + 4] = ((a0 + a1) >> 3, (a3 + a2) >> 3,
                                (a0 - a1) >> 3, (a3 - a2) >> 3)
    return out


def _int16(v: int) -> int:
    return ((v + 32768) & 0xFFFF) - 32768


class _Header:
    """The first partition's frame header (libwebp's VP8GetHeaders)."""

    def __init__(self, br: _BoolDecoder):
        get = br.get
        br.get(128)                            # colour space
        br.get(128)                            # clamping type
        self.segments = get(128)
        self.update_map = 0
        self.absolute = 1
        self.seg_quant = [0] * 4
        self.seg_filter = [0] * 4
        self.seg_probs = [255, 255, 255]
        if self.segments:
            self.update_map = get(128)
            if get(128):                       # segment feature data
                self.absolute = get(128)
                self.seg_quant = [br.optional_signed(7) for _ in range(4)]
                self.seg_filter = [br.optional_signed(6) for _ in range(4)]
            if self.update_map:
                self.seg_probs = [br.literal(8) if get(128) else 255
                                  for _ in range(3)]
        self.simple = get(128)
        self.level = br.literal(6)
        self.sharpness = br.literal(3)
        self.ref_delta = [0] * 4
        self.mode_delta = [0] * 4
        self.use_delta = get(128)
        if self.use_delta and get(128):
            for d in (self.ref_delta, self.mode_delta):
                for i in range(4):
                    if get(128):
                        d[i] = br.signed(6)
        self.partitions = 1 << br.literal(2)

    def quant(self, br: _BoolDecoder):
        """The per-segment dequantisation factors (libwebp's VP8ParseQuant):
        [(y1 (dc, ac), y2 (dc, ac), uv (dc, ac))] for the 4 segments."""
        base = br.literal(7)
        dy1, dy2, dy2a, duv, duva = (br.optional_signed(4) for _ in range(5))
        out = []
        for s in range(4):
            if self.segments:
                q = self.seg_quant[s] + (0 if self.absolute else base)
            else:
                q = base

            def dc(v, top=127):
                return _DC_TABLE[min(max(v, 0), top)]

            def ac(v):
                i = min(max(v, 0), 127)
                return _AC_TABLE[2 * i] | _AC_TABLE[2 * i + 1] << 8
            y2ac = max(ac(q + dy2a) * 101581 >> 16, 8)
            out.append(((dc(q + dy1), ac(q)), (dc(q + dy2) * 2, y2ac),
                        (dc(q + duv, 117), ac(q + duva))))
        return out

    def filter_strengths(self):
        """libwebp's PrecomputeFilterStrengths: [segment][i4x4] (limit,
        interior limit, hev threshold); limit 0 = no filtering."""
        out = []
        for s in range(4):
            base = self.level
            if self.segments:
                base = self.seg_filter[s] + (0 if self.absolute else
                                             self.level)
            row = []
            for i4 in (0, 1):
                level = base
                if self.use_delta:
                    level += self.ref_delta[0] + (self.mode_delta[0] if i4
                                                  else 0)
                level = min(max(level, 0), 63)
                if level == 0:
                    row.append((0, 0, 0))
                    continue
                ilevel = level
                if self.sharpness > 0:
                    ilevel >>= 2 if self.sharpness > 4 else 1
                    ilevel = min(ilevel, 9 - self.sharpness)
                ilevel = max(ilevel, 1)
                row.append((2 * level + ilevel, ilevel,
                            2 if level >= 40 else 1 if level >= 15 else 0))
            out.append(row)
        return out


def _probas(br: _BoolDecoder):
    """The coefficient probabilities after the frame's updates, as
    bands[type][position 0-16][context] -> 11 probabilities."""
    probs = []
    get = br.get
    for i in range(4 * 8 * 3 * 11):
        probs.append(br.literal(8) if get(_COEFF_UPDATE_PROBS[i])
                     else _COEFF_PROBS[i])
    out = []
    for t in range(4):
        bands = [[probs[((t * 8 + b) * 3 + c) * 11:((t * 8 + b) * 3 + c)
                        * 11 + 11] for c in range(3)] for b in range(8)]
        out.append([bands[_BANDS[n]] for n in range(17)])
    return out


def _parse_modes(br, hdr, intra_t, intra_l, x):
    """One macroblock's header from the first partition: (segment, skip
    flag, i4x4, 16 luma modes, chroma mode)."""
    get = br.get
    seg = 0
    if hdr.update_map:
        p = hdr.seg_probs
        seg = get(p[1]) if not get(p[0]) else 2 + get(p[2])
    skip = get(hdr.skip_prob) if hdr.skip_prob is not None else 0
    i4 = not get(145)
    top = intra_t[4 * x:4 * x + 4]
    if not i4:
        mode = (_TM if get(128) else _HE) if get(156) else \
            (_VE if get(163) else _DC)
        intra_t[4 * x:4 * x + 4] = [mode] * 4
        intra_l[:] = [mode] * 4
        modes = [mode]
    else:
        modes = [0] * 16
        for y in range(4):
            ymode = intra_l[y]
            for i in range(4):
                prob = _BMODE_PROBS[90 * top[i] + 9 * ymode:
                                    90 * top[i] + 9 * ymode + 9]
                if not get(prob[0]):
                    ymode = _DC
                elif not get(prob[1]):
                    ymode = _TM
                elif not get(prob[2]):
                    ymode = _VE
                elif not get(prob[3]):
                    if not get(prob[4]):
                        ymode = _HE
                    else:
                        ymode = _VR if get(prob[5]) else _RD
                elif not get(prob[6]):
                    ymode = _LD
                elif not get(prob[7]):
                    ymode = _VL
                else:
                    ymode = _HU if get(prob[8]) else _HD
                top[i] = ymode
                modes[4 * y + i] = ymode
            intra_l[y] = ymode
        intra_t[4 * x:4 * x + 4] = top
    uv = _DC if not get(142) else _VE if not get(114) else \
        (_TM if get(183) else _HE)
    return seg, skip, i4, modes, uv


def _residuals(get, bands, q, nz, left, i4, out):
    """libwebp's ParseResiduals for one macroblock: dequantised
    coefficients into out (24 blocks of 16: Y, U, V), the top and left
    non-zero contexts updated in place (nz / left = [bits, dc flag]);
    returns whether every coefficient is zero."""
    y1, y2, uvq = q
    nzy = 0
    if not i4:
        dc = [0] * 16
        n = _coeffs(get, bands[1], nz[1] + left[1], y2, 0, dc, 0)
        nz[1] = left[1] = int(n > 0)
        dc = [_int16(v) for v in dc]
        for k, v in enumerate(_wht(dc) if n > 1 else
                              [(dc[0] + 3) >> 3] * 16):
            out[16 * k] = _int16(v)
        first, ac = 1, bands[0]
    else:
        first, ac = 0, bands[3]
    tnz = nz[0] & 0x0F
    lnz = left[0] & 0x0F
    off = 0
    for _ in range(4):
        lf = lnz & 1
        for _ in range(4):
            n = _coeffs(get, ac, lf + (tnz & 1), y1, first, out, off)
            lf = int(n > first)
            tnz = (tnz >> 1) | (lf << 7)
            nzy |= n > first or out[off] != 0
            off += 16
        tnz >>= 4
        lnz = (lnz >> 1) | (lf << 7)
    out_t, out_l = tnz, lnz >> 4
    nzuv = 0
    for ch in (0, 2):
        tnz = nz[0] >> (4 + ch)
        lnz = left[0] >> (4 + ch)
        for _ in range(2):
            lf = lnz & 1
            for _ in range(2):
                n = _coeffs(get, bands[2], lf + (tnz & 1), uvq, 0, out, off)
                lf = int(n > 0)
                tnz = (tnz >> 1) | (lf << 3)
                nzuv |= n > 0 or out[off] != 0
                off += 16
            tnz >>= 2
            lnz = (lnz >> 1) | (lf << 5)
        out_t |= (tnz << 4) << ch
        out_l |= (lnz & 0xF0) << ch
    nz[0], left[0] = out_t, out_l
    return not (nzy or nzuv)


def _mul1(a):
    return ((a * 20091) >> 16) + a


def _mul2(a):
    return (a * 35468) >> 16


def _idct(coef: np.ndarray) -> np.ndarray:
    """libwebp's TransformOne on [..., 16] raster coefficients: the
    residual each block adds to its prediction, [..., 4, 4] (before the
    add's clip)."""
    c = coef.astype(np.int64).reshape(coef.shape[:-1] + (4, 4))
    r0, r1, r2, r3 = c[..., 0, :], c[..., 1, :], c[..., 2, :], c[..., 3, :]
    a, b = r0 + r2, r0 - r2
    cc, d = _mul2(r1) - _mul1(r3), _mul1(r1) + _mul2(r3)
    t = np.stack([a + d, b + cc, b - cc, a - d], -2)   # [..., k, column]
    dc = t[..., 0] + 4
    a, b = dc + t[..., 2], dc - t[..., 2]
    cc, d = _mul2(t[..., 1]) - _mul1(t[..., 3]), _mul1(t[..., 1]) + \
        _mul2(t[..., 3])
    return np.stack([a + d, b + cc, b - cc, a - d], -1) >> 3


def _clip(v: int) -> int:
    return 0 if v < 0 else 255 if v > 255 else v


def _avg3(a, b, c):
    return (a + 2 * b + c + 2) >> 2


def _pred4(mode, top, x, left):
    """A 4x4 luma prediction (libwebp's VP8PredLuma4) from the 8 pixels
    above (4 above-right), the one above-left and the 4 to the left: 16
    values, row by row."""
    A, B, C, D, E, F, G, H = top
    I, J, K, L = left
    if mode == _DC:
        return [(A + B + C + D + I + J + K + L + 4) >> 3] * 16
    if mode == _TM:
        return [_clip(t + v - x) for v in left for t in top[:4]]
    if mode == _VE:
        return [_avg3(x, A, B), _avg3(A, B, C), _avg3(B, C, D),
                _avg3(C, D, E)] * 4
    if mode == _HE:
        return [v for v in (_avg3(x, I, J), _avg3(I, J, K), _avg3(J, K, L),
                            _avg3(K, L, L)) for _ in range(4)]
    if mode == _RD:
        d = [_avg3(J, K, L), _avg3(I, J, K), _avg3(x, I, J), _avg3(A, x, I),
             _avg3(B, A, x), _avg3(C, B, A), _avg3(D, C, B)]
        return [d[3 - r + c] for r in range(4) for c in range(4)]
    if mode == _LD:
        d = [_avg3(A, B, C), _avg3(B, C, D), _avg3(C, D, E), _avg3(D, E, F),
             _avg3(E, F, G), _avg3(F, G, H), _avg3(G, H, H)]
        return [d[r + c] for r in range(4) for c in range(4)]
    if mode == _VR:
        return [(x + A + 1) >> 1, (A + B + 1) >> 1, (B + C + 1) >> 1,
                (C + D + 1) >> 1,
                _avg3(I, x, A), _avg3(x, A, B), _avg3(A, B, C),
                _avg3(B, C, D),
                _avg3(J, I, x), (x + A + 1) >> 1, (A + B + 1) >> 1,
                (B + C + 1) >> 1,
                _avg3(K, J, I), _avg3(I, x, A), _avg3(x, A, B),
                _avg3(A, B, C)]
    if mode == _VL:
        return [(A + B + 1) >> 1, (B + C + 1) >> 1, (C + D + 1) >> 1,
                (D + E + 1) >> 1,
                _avg3(A, B, C), _avg3(B, C, D), _avg3(C, D, E),
                _avg3(D, E, F),
                (B + C + 1) >> 1, (C + D + 1) >> 1, (D + E + 1) >> 1,
                _avg3(E, F, G),
                _avg3(B, C, D), _avg3(C, D, E), _avg3(D, E, F),
                _avg3(F, G, H)]
    if mode == _HD:
        return [(I + x + 1) >> 1, _avg3(I, x, A), _avg3(x, A, B),
                _avg3(A, B, C),
                (J + I + 1) >> 1, _avg3(J, I, x), (I + x + 1) >> 1,
                _avg3(I, x, A),
                (K + J + 1) >> 1, _avg3(K, J, I), (J + I + 1) >> 1,
                _avg3(J, I, x),
                (L + K + 1) >> 1, _avg3(L, K, J), (K + J + 1) >> 1,
                _avg3(K, J, I)]
    # _HU
    return [(I + J + 1) >> 1, _avg3(I, J, K), (J + K + 1) >> 1,
            _avg3(J, K, L),
            (J + K + 1) >> 1, _avg3(J, K, L), (K + L + 1) >> 1,
            _avg3(K, L, L),
            (K + L + 1) >> 1, _avg3(K, L, L), L, L,
            L, L, L, L]


def _pred_block(mode, top, left, x, size, has_top, has_left):
    """A 16x16 luma or 8x8 chroma prediction (DC with the edges it has,
    TM, VE, HE) as [size, size] int64."""
    if mode == _DC:
        shift = size.bit_length() - 1         # log2(size)
        if has_top and has_left:
            v = (int(top.sum()) + int(left.sum()) + size) >> (shift + 1)
        elif has_left:
            v = (int(left.sum()) + size // 2) >> shift
        elif has_top:
            v = (int(top.sum()) + size // 2) >> shift
        else:
            v = 128
        return np.full((size, size), v, np.int64)
    if mode == _TM:
        return np.clip(top[None, :] + left[:, None] - x, 0, 255)
    if mode == _VE:
        return np.repeat(top[None, :], size, 0)
    return np.repeat(left[:, None], size, 1)


def _edges(plane, y0, x0, size, mb_y, mb_x):
    """The unfiltered top row, left column and top-left pixel of a
    macroblock as libwebp sees them: 127 above the frame (the top-left
    too), 129 left of it (the top-left below the first row too)."""
    if mb_y > 0:
        top = plane[y0 - 1, x0:x0 + size].astype(np.int64)
        tl = int(plane[y0 - 1, x0 - 1]) if mb_x > 0 else 129
    else:
        top = np.full(size, 127, np.int64)
        tl = 127
    left = plane[y0:y0 + size, x0 - 1].astype(np.int64) if mb_x > 0 else \
        np.full(size, 129, np.int64)
    return top, left, tl


def _reconstruct(mbs, res, mbw, mbh):
    """Intra prediction plus residual, macroblock by macroblock, into
    unfiltered planes: (Y [16 mbh, 16 mbw], U, V [8 mbh, 8 mbw])."""
    Y = np.zeros((16 * mbh, 16 * mbw), np.uint8)
    U = np.zeros((8 * mbh, 8 * mbw), np.uint8)
    V = np.zeros((8 * mbh, 8 * mbw), np.uint8)
    # Y residual [N, 16, 16] from blocks [N, 16, 4, 4] in raster order
    ry = res[:, :16].reshape(-1, 4, 4, 4, 4).transpose(0, 1, 3, 2, 4) \
        .reshape(-1, 16, 16)
    ruv = res[:, 16:].reshape(-1, 2, 2, 2, 4, 4).transpose(0, 1, 2, 4, 3, 5) \
        .reshape(-1, 2, 8, 8)
    for i, (i4, modes, uvmode) in enumerate(mbs):
        mb_y, mb_x = divmod(i, mbw)
        y0, x0 = 16 * mb_y, 16 * mb_x
        top, left, tl = _edges(Y, y0, x0, 16, mb_y, mb_x)
        if not i4:
            pred = _pred_block(modes[0], top, left, tl, 16, mb_y > 0,
                               mb_x > 0)
            Y[y0:y0 + 16, x0:x0 + 16] = np.clip(pred + ry[i], 0, 255)
        else:
            if mb_y == 0:
                tr = [127] * 4
            elif mb_x < mbw - 1:
                tr = Y[y0 - 1, x0 + 16:x0 + 20].tolist()
            else:
                tr = [int(Y[y0 - 1, x0 + 15])] * 4
            # a 17 x 21 work area: row 0 the top edge (top-left, 16, 4
            # above-right), column 0 the left edge; the above-right pixels
            # repeat on rows 4, 8 and 12 for the right column's blocks
            ws = [[0] * 21 for _ in range(17)]
            ws[0] = [tl] + top.tolist() + tr
            for r, v in enumerate(left.tolist()):
                ws[r + 1][0] = v
            for r in (4, 8, 12):
                ws[r][17:21] = tr
            rb = res[i, :16].reshape(16, 16).tolist()
            for n in range(16):
                r0, c0 = 4 * (n >> 2) + 1, 4 * (n & 3) + 1
                above = ws[r0 - 1]
                p = _pred4(modes[n], above[c0:c0 + 8], above[c0 - 1],
                           [ws[r0 + k][c0 - 1] for k in range(4)])
                rr = rb[n]
                for k in range(16):
                    v = p[k] + rr[k]
                    ws[r0 + (k >> 2)][c0 + (k & 3)] = \
                        0 if v < 0 else 255 if v > 255 else v
            Y[y0:y0 + 16, x0:x0 + 16] = np.array(ws, np.uint8)[1:, 1:17]
        cy, cx = 8 * mb_y, 8 * mb_x
        for k, P in enumerate((U, V)):
            top, left, tl = _edges(P, cy, cx, 8, mb_y, mb_x)
            pred = _pred_block(uvmode, top, left, tl, 8, mb_y > 0, mb_x > 0)
            P[cy:cy + 8, cx:cx + 8] = np.clip(pred + ruv[i, k], 0, 255)
    return Y, U, V


def _filter_lanes(buf, centre, step, thresh, ilevel, hev_t, kind):
    """One batch of loop-filter lanes on the flat int64 buffer: lane i
    runs across the edge through centre[i] (its first pixel past the
    edge) with stride step[i]. kind: 'simple', 'mb' (FilterLoop26) or
    'inner' (FilterLoop24), each as libwebp's dsp/dec.c."""
    if len(centre) == 0:
        return
    offs = centre[:, None] + np.arange(-4, 4)[None, :] * step[:, None]
    P = buf[offs]
    p3, p2, p1, p0, q0, q1, q2, q3 = P.T
    needs = 4 * np.abs(p0 - q0) + np.abs(p1 - q1) <= 2 * thresh + 1
    out = P.copy()
    if kind == "simple":
        hev = np.ones_like(needs)
    else:
        needs &= ((np.abs(p3 - p2) <= ilevel) & (np.abs(p2 - p1) <= ilevel)
                  & (np.abs(p1 - p0) <= ilevel) & (np.abs(q3 - q2) <= ilevel)
                  & (np.abs(q2 - q1) <= ilevel) & (np.abs(q1 - q0) <= ilevel))
        hev = (np.abs(p1 - p0) > hev_t) | (np.abs(q1 - q0) > hev_t)
    # DoFilter2: where hev (or the simple filter)
    a = 3 * (q0 - p0) + np.clip(p1 - q1, -128, 127)
    a1 = np.clip((a + 4) >> 3, -16, 15)
    a2 = np.clip((a + 3) >> 3, -16, 15)
    f2 = needs & hev
    out[f2, 3] = np.clip(p0 + a2, 0, 255)[f2]
    out[f2, 4] = np.clip(q0 - a1, 0, 255)[f2]
    if kind == "mb":                           # DoFilter6
        f6 = needs & ~hev
        a = np.clip(3 * (q0 - p0) + np.clip(p1 - q1, -128, 127), -128, 127)
        a1 = (27 * a + 63) >> 7
        a2 = (18 * a + 63) >> 7
        a3 = (9 * a + 63) >> 7
        for col, v in ((1, p2 + a3), (2, p1 + a2), (3, p0 + a1),
                       (4, q0 - a1), (5, q1 - a2), (6, q2 - a3)):
            out[f6, col] = np.clip(v, 0, 255)[f6]
    elif kind == "inner":                      # DoFilter4
        f4 = needs & ~hev
        a = 3 * (q0 - p0)
        a1 = np.clip((a + 4) >> 3, -16, 15)
        a2 = np.clip((a + 3) >> 3, -16, 15)
        a3 = (a1 + 1) >> 1
        for col, v in ((2, p1 + a3), (3, p0 + a2), (4, q0 - a1),
                       (5, q1 - a3)):
            out[f4, col] = np.clip(v, 0, 255)[f4]
    buf[offs] = out


def _loop_filter(Y, U, V, finfo, mbw, mbh, simple):
    """libwebp's DoFilter for every macroblock, in an order equal to its
    raster order: the macroblocks with equal x + 2y at once. finfo: [N, 4]
    (limit, interior limit, hev threshold, inner edges)."""
    wy, wc = Y.shape[1], 2 * U.shape[1]
    cw = U.shape[1]
    buf = np.concatenate([Y.reshape(-1), np.concatenate([U, V], 1)
                          .reshape(-1)]).astype(np.int64)
    cbase = Y.size
    lane16, lane8 = np.arange(16), np.arange(8)
    for t in range(mbw + 2 * (mbh - 1)):
        my = np.arange(max(0, (t - mbw + 2) // 2), min(mbh - 1, t // 2) + 1)
        mx = t - 2 * my
        f = finfo[my * mbw + mx]
        on = f[:, 0] > 0
        my, mx, f = my[on], mx[on], f[on]
        if len(my) == 0:
            continue

        def lanes(sel, luma_edge, chroma_edge, vertical):
            """Lane centres, strides and parameters of one edge of the
            selected macroblocks: the luma edge at offset luma_edge and,
            unless None or simple, the chroma edges at chroma_edge."""
            yy, xx, ff = my[sel], mx[sel], f[sel]
            if vertical:
                c = ((16 * yy[:, None] + lane16) * wy + 16 * xx[:, None]
                     + luma_edge).reshape(-1)
                s = np.ones_like(c)
            else:
                c = ((16 * yy[:, None] + luma_edge) * wy + 16 * xx[:, None]
                     + lane16).reshape(-1)
                s = np.full_like(c, wy)
            prm = np.repeat(ff, 16, 0)
            if chroma_edge is not None and not simple:
                cc = []
                for off in (0, cw):
                    if vertical:
                        cc.append(((8 * yy[:, None] + lane8) * wc
                                   + 8 * xx[:, None] + chroma_edge + off))
                    else:
                        cc.append(((8 * yy[:, None] + chroma_edge) * wc
                                   + 8 * xx[:, None] + lane8 + off))
                cc = cbase + np.concatenate(cc, 1).reshape(-1)
                c = np.concatenate([c, cc])
                s = np.concatenate([s, np.full(len(cc), 1 if vertical
                                               else wc)])
                prm = np.concatenate([prm, np.repeat(ff, 16, 0)])
            return c, s, prm

        inner = f[:, 3] > 0
        edges = ((mx > 0, 0, 0, True, "mb", 4),
                 (inner, 4, 4, True, "inner", 0),
                 (inner, 8, None, True, "inner", 0),
                 (inner, 12, None, True, "inner", 0),
                 (my > 0, 0, 0, False, "mb", 4),
                 (inner, 4, 4, False, "inner", 0),
                 (inner, 8, None, False, "inner", 0),
                 (inner, 12, None, False, "inner", 0))
        for sel, le, ce, vertical, kind, extra in edges:
            if not sel.any():
                continue
            c, s, prm = lanes(sel, le, ce, vertical)
            _filter_lanes(buf, c, s, prm[:, 0] + extra, prm[:, 1], prm[:, 2],
                          "simple" if simple else kind)
    Y[:] = buf[:cbase].reshape(Y.shape)
    C = buf[cbase:].reshape(U.shape[0], wc)
    U[:], V[:] = C[:, :cw], C[:, cw:]


def _mult_hi(v, c):
    return (v * c) >> 8


def _clip8(v):
    return np.where((v & ~16383) == 0, v >> 6, np.where(v < 0, 0, 255))


def _yuv_to_rgb(y, u, v) -> np.ndarray:
    """libwebp's VP8YuvToRgb (14-bit fixed point) on int64 planes."""
    yy = _mult_hi(y, 19077)
    r = _clip8(yy + _mult_hi(v, 26149) - 14234)
    g = _clip8(yy - _mult_hi(u, 6419) - _mult_hi(v, 13320) + 8708)
    b = _clip8(yy + _mult_hi(u, 33050) - 17685)
    return np.stack([r, g, b], -1).astype(np.uint8)


def _upsample_pair(top, cur, w):
    """libwebp's fancy upsampler on one pair of chroma rows (each [n, uw]
    int64): the chroma of the output row nearer `top` (weights 3 top : 1
    cur) and of the one nearer `cur`, each [n, w]."""
    n = top.shape[0]
    near_t = np.empty((n, w), np.int64)
    near_c = np.empty((n, w), np.int64)
    near_t[:, 0] = (3 * top[:, 0] + cur[:, 0] + 2) >> 2
    near_c[:, 0] = (3 * cur[:, 0] + top[:, 0] + 2) >> 2
    last = (w - 1) >> 1
    if last >= 1:
        tl, t = top[:, :last], top[:, 1:last + 1]
        l, c = cur[:, :last], cur[:, 1:last + 1]
        avg = tl + t + l + c + 8
        d12 = (avg + 2 * (t + l)) >> 3
        d03 = (avg + 2 * (tl + c)) >> 3
        near_t[:, 1:2 * last:2] = (d12 + tl) >> 1
        near_t[:, 2:2 * last + 1:2] = (d03 + t) >> 1
        near_c[:, 1:2 * last:2] = (d03 + l) >> 1
        near_c[:, 2:2 * last + 1:2] = (d12 + c) >> 1
    if not w & 1:
        near_t[:, w - 1] = (3 * top[:, last] + cur[:, last] + 2) >> 2
        near_c[:, w - 1] = (3 * cur[:, last] + top[:, last] + 2) >> 2
    return near_t, near_c


def _fancy_rgb(Y, U, V) -> np.ndarray:
    """The cropped planes as RGB through libwebp's EmitFancyRGB: row 0
    from chroma row 0 alone, rows 2k-1 and 2k from chroma rows k-1 and k,
    the last row of an even height from the last chroma row alone."""
    h, w = Y.shape
    out = np.empty((h, w, 3), np.uint8)
    y = Y.astype(np.int64)
    chroma = []
    for P in (U, V):
        p = P.astype(np.int64)
        first, _ = _upsample_pair(p[:1], p[:1], w)
        rows = [first]
        if h > 1:
            near_t, near_c = _upsample_pair(p[:-1], p[1:], w)
            pairs = np.empty((2 * near_t.shape[0], w), np.int64)
            pairs[0::2], pairs[1::2] = near_t, near_c
            rows.append(pairs)
        if h % 2 == 0 and h > 1:
            last, _ = _upsample_pair(p[-1:], p[-1:], w)
            rows.append(last)
        chroma.append(np.concatenate(rows)[:h])
    out[:] = _yuv_to_rgb(y, *chroma)
    return out


def decode_vp8(data: bytes) -> np.ndarray:
    """A VP8 key frame (the `VP8 ` chunk's payload) as uint8 [h, w, 3] RGB,
    as libwebp decodes it to BGR."""
    if len(data) < 10:
        raise ValueError("WebP: truncated VP8 frame")
    bits = data[0] | data[1] << 8 | data[2] << 16
    if bits & 1:
        raise ValueError("WebP: a VP8 frame that is not a key frame")
    if (bits >> 1) & 7 > 3:
        raise ValueError("WebP: unknown VP8 profile")
    part0 = bits >> 5
    if data[3:6] != b"\x9d\x01\x2a":
        raise ValueError("WebP: bad VP8 start code")
    w = (data[6] | data[7] << 8) & 0x3FFF
    h = (data[8] | data[9] << 8) & 0x3FFF
    if w == 0 or h == 0 or 10 + part0 > len(data):
        raise ValueError("WebP: bad VP8 frame header")
    br = _BoolDecoder(data, 10, 10 + part0)
    hdr = _Header(br)
    # token partitions: 3-byte sizes, then the data, the last takes the rest
    pos = 10 + part0
    nparts = hdr.partitions
    starts = pos + 3 * (nparts - 1)
    parts = []
    for p in range(nparts - 1):
        size = int.from_bytes(data[pos + 3 * p:pos + 3 * p + 3], "little")
        size = min(size, len(data) - starts)
        parts.append(_BoolDecoder(data, starts, starts + size))
        starts += size
    parts.append(_BoolDecoder(data, starts, len(data)))
    quant = hdr.quant(br)
    br.get(128)                                # refresh entropy probs
    bands = _probas(br)
    hdr.skip_prob = br.literal(8) if br.get(128) else None
    strengths = hdr.filter_strengths()
    mbw, mbh = (w + 15) >> 4, (h + 15) >> 4
    n = mbw * mbh
    coeffs = np.zeros((n, 384), np.int64)
    finfo = np.zeros((n, 4), np.int64)
    mbs = []
    intra_t = [_DC] * (4 * mbw)
    nz_top = [[0, 0] for _ in range(mbw)]
    for mb_y in range(mbh):
        intra_l = [_DC] * 4
        left = [0, 0]
        get = parts[mb_y % nparts].get
        for mb_x in range(mbw):
            seg, skip, i4, modes, uv = _parse_modes(br, hdr, intra_t,
                                                    intra_l, mb_x)
            if not skip:
                out = [0] * 384
                skip = _residuals(get, bands, quant[seg], nz_top[mb_x],
                                  left, i4, out)
                coeffs[mb_y * mbw + mb_x] = out
            else:
                nz_top[mb_x][0] = left[0] = 0
                if not i4:
                    nz_top[mb_x][1] = left[1] = 0
            limit, ilevel, hev = strengths[seg][int(i4)]
            finfo[mb_y * mbw + mb_x] = (limit, ilevel, hev,
                                        int(i4) | (not skip))
            mbs.append((i4, modes, uv))
    # libwebp stores coefficients as int16
    coeffs = ((coeffs + 32768) & 0xFFFF) - 32768
    res = _idct(coeffs.reshape(n, 24, 16))
    Y, U, V = _reconstruct(mbs, res, mbw, mbh)
    if hdr.level > 0:
        _loop_filter(Y, U, V, finfo, mbw, mbh, hdr.simple)
    return _fancy_rgb(Y[:h, :w], U[:(h + 1) // 2, :(w + 1) // 2],
                      V[:(h + 1) // 2, :(w + 1) // 2])


# ---------------------------------------------------------------------------
# VP8L writer
# ---------------------------------------------------------------------------

def _huffman_lengths(counts, limit: int) -> np.ndarray:
    """Prefix-code lengths for symbol counts, none above `limit`: Huffman's
    construction, on counts halved (rounding up) until it fits; every
    code of two or more symbols is complete."""
    counts = np.asarray(counts, np.int64)
    lengths = np.zeros(len(counts), np.int64)
    used = np.flatnonzero(counts)
    if len(used) < 2:
        lengths[used] = 1
        return lengths
    c = counts[used]
    while True:
        heap = [(int(v), i, (i,)) for i, v in enumerate(c)]
        heapq.heapify(heap)
        depth = np.zeros(len(c), np.int64)
        tie = len(c)
        while len(heap) > 1:
            a, _, sa = heapq.heappop(heap)
            b, _, sb = heapq.heappop(heap)
            for s in sa + sb:
                depth[s] += 1
            heapq.heappush(heap, (a + b, tie, sa + sb))
            tie += 1
        if depth.max() <= limit:
            lengths[used] = depth
            return lengths
        c = (c + 1) // 2


def _codes(lengths) -> np.ndarray:
    """The canonical codes of `lengths`, bit-reversed for LSB-first
    writing."""
    lengths = np.asarray(lengths, np.int64)
    out = np.zeros(len(lengths), np.int64)
    code = 0
    for n in range(1, int(lengths.max(initial=0)) + 1):
        for s in np.flatnonzero(lengths == n):
            out[s] = _reverse(code, n)
            code += 1
        code <<= 1
    return out


def _write_code(fields, counts):
    """Append the description of a prefix code for `counts` to fields
    ((value, bits) pairs); return (codes, lengths) to write symbols with
    (a one-symbol code writes none)."""
    counts = np.asarray(counts, np.int64)
    used = np.flatnonzero(counts)
    if len(used) == 0:
        used = np.array([0])
    n = len(counts)
    none = np.zeros(n, np.int64)
    if len(used) <= 2 and used.max() < 256:   # simple code
        fields += [(1, 1), (len(used) - 1, 1)]
        s0 = int(used[0])
        fields += [(0, 1), (s0, 1)] if s0 < 2 else [(1, 1), (s0, 8)]
        if len(used) == 1:
            return none, none
        fields.append((int(used[1]), 8))
        lengths = none.copy()
        lengths[used] = 1
        return _codes(lengths), lengths
    lengths = _huffman_lengths(counts, 15)
    cl_lengths = _huffman_lengths(np.bincount(lengths, minlength=19), 7)
    fields += [(0, 1), (19 - 4, 4)]
    fields += [(int(cl_lengths[i]), 3) for i in _LENGTH_ORDER]
    fields.append((0, 1))                      # every symbol coded
    if np.count_nonzero(cl_lengths) > 1:       # else one length: no bits
        cl_codes = _codes(cl_lengths)
        fields += [(int(cl_codes[v]), int(cl_lengths[v])) for v in lengths]
    if len(used) == 1:
        return none, none
    return _codes(lengths), lengths


def _pack(values, nbits) -> bytes:
    """Fields of nbits (each 0-32) packed LSB first."""
    values = np.asarray(values, np.uint64)
    nbits = np.asarray(nbits, np.int64)
    keep = nbits > 0
    values, nbits = values[keep], nbits[keep]
    pos = np.concatenate([[0], np.cumsum(nbits)])
    total = int(pos[-1])
    words = np.zeros(total // 64 + 2, np.uint64)
    w, o = pos[:-1] >> 6, (pos[:-1] & 63).astype(np.uint64)
    np.bitwise_or.at(words, w, values << o)
    spill = (pos[:-1] & 63) + nbits > 64
    np.bitwise_or.at(words, w[spill] + 1,
                     values[spill] >> (np.uint64(64) - o[spill]))
    return words.astype("<u8").tobytes()[:(total + 7) // 8]


def encode_webp(rgb) -> bytes:
    """A lossless WebP (VP8L) of uint8 [h, w, 3] RGB: the subtract-green
    transform, then one group of prefix codes over literal pixels (no
    backward references, no colour cache)."""
    rgb = np.asarray(rgb, np.uint8)
    if rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"encode_webp: expected [h, w, 3], got {rgb.shape}")
    h, w, _ = rgb.shape
    if not (0 < h <= 16384 and 0 < w <= 16384):
        raise ValueError(f"WebP: cannot encode a {w}x{h} image")
    g = rgb[..., 1].reshape(-1).astype(np.int64)
    r = (rgb[..., 0].reshape(-1).astype(np.int64) - g) & 255
    b = (rgb[..., 2].reshape(-1).astype(np.int64) - g) & 255
    fields = [(0x2F, 8), (w - 1, 14), (h - 1, 14), (0, 1), (0, 3),
              (1, 1), (2, 2), (0, 1),          # subtract green, no more
              (0, 1), (0, 1)]                  # no colour cache, one group
    symbols = []
    for values, size in ((g, 280), (r, 256), (b, 256),
                         (np.full(1, 255), 256), (np.zeros(0, np.int64),
                                                  40)):
        codes, lengths = _write_code(fields, np.bincount(values,
                                                         minlength=size))
        symbols.append((codes[values], lengths[values]))
    head_v, head_n = zip(*fields)
    px_v = np.stack([symbols[0][0], symbols[1][0], symbols[2][0]], -1)
    px_n = np.stack([symbols[0][1], symbols[1][1], symbols[2][1]], -1)
    body = _pack(np.concatenate([np.array(head_v, np.int64),
                                 px_v.reshape(-1)]),
                 np.concatenate([np.array(head_n, np.int64),
                                 px_n.reshape(-1)]))
    # OpenCV reads no WebP file under 32 bytes: zero bytes past the last
    # pixel's bits pad a tiny image's stream to that
    body = body.ljust(12, b"\0")
    chunk = b"VP8L" + struct.pack("<I", len(body)) + body + \
        b"\0" * (len(body) & 1)
    return b"RIFF" + struct.pack("<I", 4 + len(chunk)) + b"WEBP" + chunk
