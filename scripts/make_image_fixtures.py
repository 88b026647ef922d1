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

The last image slice's (each a few KB but the two environment maps):
cv2's SGI LogLuv TIFFs of radiance over six decades (SGILog, SGILog24,
LogL of grey) and of the 256 x 128 substitute environment map (SGILog,
SGILog24: the maps chip_smoke.py's texture phase lights a scene with),
LogLuv files of random words encoded here (big-endian tiles, strips);
Pillow's CCITT TIFFs (Modified Huffman, word-aligned, T.4 1-D and 2-D
with fill, T.6 of runs past 2,560 pixels, and one patched to white-is-
zero with FillOrder 2); YCbCr TIFFs of 2 x 2 (LZW, predictor), 4 x 1
(Deflate, big-endian, ReferenceBlackWhite and BT.709 coefficients) and
4 x 4 (clipped tiles); lossless JPEGs (grey, predictor 1; RGB, predictor
7, point transform 1, restarts); cv2's baseline JPEGs re-coded
arithmetically (sequential 4:2:0 with restarts; progressive 4:4:4 with
DAC conditioning); Pillow's CMYK JPEG as YCCK and without its Adobe
marker; AVIF grids of cv2's 64 x 64 tiles (2 x 1 in idat; 2 x 2 cut to
100 x 90, 32-bit sizes, in mdat); an RGB PAM at maxval 1; CIELab and
uint64 TIFFs. libtiff's LogLuv encoder dithers at random (its default
SGILOGENCODE_RANDITHER), so a rerun writes other SGILog24 files and
pixels: check `cv2_sgilog24.tif`, `env_sgilog24_256x128.tif` and
`cv2_pixels.npz` out again with `pil_animated.avif` (whose clock moves)
and `cv2_raster.sr` (whose last pad byte cv2 leaves unset).

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


_TIFF_PACK = {3: "H", 4: "I", 5: "I", 7: "B", 16: "Q"}


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
    `tags`, more (tag, type, values; a RATIONAL (5) as numerators and
    denominators in turn)."""
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
                           len(vals) // 2 if typ == 5 else len(vals))
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


def sgilog_rows(words, planes: int) -> bytes:
    """SGILog (compression 34676) of [rows, cols] words: each row's byte
    planes, most significant first, as runs of 3-129 equal bytes (n - 126
    = 2-129 repeats behind a byte n >= 128) between literal stretches of
    at most 127 bytes, as tif_luv.c's encoder codes them."""
    out = bytearray()
    for row in np.asarray(words, np.uint32):
        for k in range(planes - 1, -1, -1):
            b = ((row >> (8 * k)) & 0xFF).astype(np.uint8).tobytes()
            i, n = 0, len(b)
            while i < n:
                j = i
                while j < n and b[j] == b[i] and j - i < 129:
                    j += 1
                if j - i >= 3:
                    out += bytes([j - i + 126, b[i]])
                    i = j
                    continue
                k2 = i + 1
                while k2 < n and k2 - i < 127 and not (
                        k2 + 2 < n and b[k2] == b[k2 + 1] == b[k2 + 2]):
                    k2 += 1
                out += bytes([k2 - i]) + b[i:k2]
                i = k2
    return bytes(out)


def logluv_tiff(words, comp=34676, order="<", tile=None,
                rows_per_strip=1, signed=True) -> bytes:
    """A LogLuv TIFF of [h, w] 32-bit words (photometric 32845, SGILog) or
    24-bit ones (comp 34677, SGILog24), or with `words` uint16 a LogL one
    (photometric 32844), with the 16-bit signed samples OpenCV's writer
    declares (unsigned ones unless `signed`), in strips or tiles."""
    words = np.asarray(words)
    logl = words.dtype == np.uint16
    s = np.zeros(words.shape + (1 if logl else 3,),
                 np.int16 if signed else np.uint16)
    s[..., 0] = (words & 0xFFFF).astype(np.uint16).view(s.dtype)
    if not logl:
        s[..., 1] = (words.astype(np.uint32) >> 16).astype(np.uint16).view(
            s.dtype)

    def encode(c):
        w = c[..., 0].view(np.uint16).astype(np.uint32)
        if not logl:
            w |= c[..., 1].view(np.uint16).astype(np.uint32) << 16
        if comp == 34677:
            return np.stack([w >> 16, w >> 8, w], -1).astype(
                np.uint8).tobytes()
        return sgilog_rows(w, 2 if logl else 4)
    return tiff_file(s, order, tile, comp, photo=32844 if logl else 32845,
                     rows_per_strip=rows_per_strip, encode=encode)


def ycbcr_tiff(ycc, hs, vs, comp=1, order="<", tile=None, rows_per_strip=None,
               predictor=1, tags=()) -> bytes:
    """A YCbCr TIFF (photometric 6) of uint8 [h, w, 3] Y, Cb, Cr in data
    units of hs x vs luma samples and one Cb and Cr (the chroma of each
    unit's top-left pixel), YCbCrSubsampling (hs, vs), in strips of
    `rows_per_strip` (a multiple of vs) or tiles, compression 1, 5, 8 or
    32773, predictor 2 on rows of libtiff's scanline size (a row of units'
    bytes over vs; a tile's width x 3), not applied where that size is no
    multiple of 3 or a tile no whole number of such rows (libtiff then
    fails to undo it and reads the bytes as they are)."""
    h, w, _ = ycc.shape
    tw, th = tile or (w, rows_per_strip or h)
    H, W = -(-h // th) * th, -(-w // tw) * tw
    full = np.zeros((max(H, -(-h // vs) * vs), max(W, -(-w // hs) * hs), 3),
                    np.uint8)
    full[:h, :w] = ycc
    chunks = []
    for y0 in range(0, H, th):
        for x0 in range(0, W if tile else tw, tw):
            part = (full[y0:y0 + th, x0:x0 + tw] if tile
                    else full[y0:y0 + th])
            rows = part.shape[0] if tile else min(th, h - y0)
            cols = part.shape[1] if tile else w
            part = part[:-(-rows // vs) * vs, :-(-cols // hs) * hs]
            n, m = part.shape[0] // vs, part.shape[1] // hs
            y = part[..., 0].reshape(n, vs, m, hs).transpose(0, 2, 1, 3)
            units = np.concatenate([y.reshape(n, m, vs * hs),
                                    part[::vs, ::hs, 1:]], -1)
            raw = units.tobytes()
            line = tw * 3 if tile else m * (hs * vs + 2) // vs
            if predictor == 2 and line % 3 == 0 and len(raw) % line == 0:
                a = np.frombuffer(raw, np.uint8).copy()
                k = len(a) // line * line
                r = a[:k].reshape(-1, line // 3, 3)
                r[:, 1:] = r[:, 1:] - r[:, :-1]
                raw = r.tobytes() + a[k:].tobytes()
            chunks.append({1: lambda b: b, 5: lzw_encode, 8: zlib.compress,
                           32773: packbits}[comp](raw))
    it = iter(chunks)
    return tiff_file(np.zeros((h, w, 3), np.uint8), order, tile, comp,
                     predictor, photo=6, rows_per_strip=rows_per_strip,
                     tags=[(530, 3, [hs, vs])] + list(tags),
                     encode=lambda c: next(it))


def _segment(marker: int, body: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body


def _stuffed(bits: str) -> bytes:
    """MSB-first bits padded with ones to a byte, 0xFF bytes stuffed."""
    bits += "1" * (-len(bits) % 8)
    out = bytearray()
    for i in range(0, len(bits), 8):
        out.append(int(bits[i:i + 8], 2))
        if out[-1] == 0xFF:
            out.append(0)
    return bytes(out)


def lossless_jpeg(samples, predictor=1, pt=0, restart_rows=0, ids=None,
                  interleaved=True, jfif=False) -> bytes:
    """A lossless JPEG (SOF3, T.81 H.1) of uint8 [h, w, nc] samples
    (stored >> pt), 8-bit precision: differences from `predictor` (1-7)
    coded in DC categories (16: 32768, no bits) with one Huffman table of
    17 five-bit codes, in one interleaved scan or a scan a component,
    restart markers every `restart_rows` rows of MCUs."""
    h, w, nc = samples.shape
    ids = ids or list(range(1, nc + 1))
    x = (samples.astype(np.int64) >> pt)
    counts = [0] * 16
    counts[4] = 17
    codes = {s: format(s, "05b") for s in range(17)}
    out = b"\xff\xd8"
    if jfif:
        out += _segment(0xE0, b"JFIF\0\1\1\0\0\1\0\1\0\0")
    out += _segment(0xC3, struct.pack(">BHHB", 8, h, w, nc) + b"".join(
        bytes([ids[k], 0x11, 0]) for k in range(nc)))
    out += _segment(0xC4, bytes([0]) + bytes(counts) + bytes(range(17)))
    if restart_rows:
        out += _segment(0xDD, struct.pack(">H", restart_rows * w))

    def diffs(p):
        d = np.zeros((h, w), np.int64)
        init = 1 << (7 - pt)
        for y in range(h):
            first = restart_rows and y % restart_rows == 0 or y == 0
            for xx in range(w):
                if first:
                    pred = init if xx == 0 else p[y, xx - 1]
                elif xx == 0:
                    pred = p[y - 1, 0]
                else:
                    ra, rb, rc = p[y, xx - 1], p[y - 1, xx], p[y - 1, xx - 1]
                    pred = {1: ra, 2: rb, 3: rc, 4: ra + rb - rc,
                            5: ra + ((rb - rc) >> 1), 6: rb + ((ra - rc) >> 1),
                            7: (ra + rb) >> 1}[predictor]
                d[y, xx] = (p[y, xx] - pred + 32768) % 65536 - 32768
        return d

    def code(v):
        if v == -32768:
            return codes[16]
        s = abs(int(v)).bit_length()
        if s == 0:
            return codes[0]
        return codes[s] + format(v if v > 0 else v + (1 << s) - 1, f"0{s}b")
    planes = [diffs(x[..., k]) for k in range(nc)]
    scans = [list(range(nc))] if interleaved else [[k] for k in range(nc)]
    for comps in scans:
        out += _segment(0xDA, bytes([len(comps)]) + b"".join(
            bytes([ids[k], 0]) for k in comps) + bytes([predictor, 0, pt]))
        bits, rst = "", 0
        for y in range(h):
            if restart_rows and y and y % restart_rows == 0:
                out += _stuffed(bits) + bytes([0xFF, 0xD0 + rst % 8])
                bits, rst = "", rst + 1
            for xx in range(w):
                bits += "".join(code(planes[k][y, xx]) for k in comps)
        out += _stuffed(bits)
    return out + b"\xff\xd9"


class QMEncoder:
    """T.81 Annex D's QM encoder as libjpeg's jcarith.c writes it (carry
    over stacked 0xFF bytes, 0xFF stuffed with 0x00, the D.1.8 flush), on
    the states of utils/jpeg_arith.py's decoder."""

    def __init__(self):
        from ignis_tpu_torch.utils.jpeg_arith import QE
        self.qe = QE
        self.out = bytearray()
        self.c, self.a, self.sc, self.zc, self.ct, self.buf = (0, 0x10000, 0,
                                                               0, 11, -1)

    def _flush_stack(self, byte):
        if self.zc:
            self.out += b"\0" * self.zc
            self.zc = 0
        self.out.append(byte)
        if byte == 0xFF:
            self.out.append(0)

    def _emit(self, temp):
        if temp > 0xFF:
            if self.buf >= 0:
                self._flush_stack(self.buf + 1)
            self.zc += self.sc
            self.sc = 0
            self.buf = temp & 0xFF
        elif temp == 0xFF:
            self.sc += 1
        else:
            if self.buf == 0:
                self.zc += 1
            elif self.buf >= 0:
                self._flush_stack(self.buf)
            if self.sc:
                if self.zc:
                    self.out += b"\0" * self.zc
                    self.zc = 0
                self.out += b"\xff\0" * self.sc
                self.sc = 0
            self.buf = temp & 0xFF

    def encode(self, st, k, val):
        sv = st[k]
        qe, nlps, nmps, switch = self.qe[sv & 0x7F]
        self.a -= qe
        if val != sv >> 7:
            if self.a >= qe:
                self.c += self.a
                self.a = qe
            st[k] = (sv & 0x80) ^ (nlps | switch << 7)
        else:
            if self.a >= 0x8000:
                return
            if self.a < qe:
                self.c += self.a
                self.a = qe
            st[k] = (sv & 0x80) ^ nmps
        while True:
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                self._emit(self.c >> 19)
                self.c &= 0x7FFFF
                self.ct += 8
            if self.a >= 0x8000:
                break

    def finish(self) -> bytes:
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        self.c <<= self.ct
        if self.c & 0xF8000000:
            if self.buf >= 0:
                self._flush_stack(self.buf + 1)
            self.zc += self.sc
            self.sc = 0
        else:
            if self.buf == 0:
                self.zc += 1
            elif self.buf >= 0:
                self._flush_stack(self.buf)
            if self.sc:
                if self.zc:
                    self.out += b"\0" * self.zc
                    self.zc = 0
                self.out += b"\xff\0" * self.sc
                self.sc = 0
        if self.c & 0x7FFF800:
            if self.zc:
                self.out += b"\0" * self.zc
                self.zc = 0
            self.out.append((self.c >> 19) & 0xFF)
            if (self.c >> 19) & 0xFF == 0xFF:
                self.out.append(0)
            if self.c & 0x7F800:
                self.out.append((self.c >> 11) & 0xFF)
                if (self.c >> 11) & 0xFF == 0xFF:
                    self.out.append(0)
        return bytes(self.out)


def _qm_magnitude(enc, st, k, v, base):
    """Figures F.8 and F.9 from bin k: v - 1's category (its AC bins go on
    at `base`; DC's, `base` None, at X1 = 20) and bits."""
    m = 0
    v -= 1
    if v:
        enc.encode(st, k, 1)
        m = 1
        v2 = v
        if base is None:
            k = 20
            while v2 >> 1:
                v2 >>= 1
                enc.encode(st, k, 1)
                m <<= 1
                k += 1
        elif v2 >> 1:
            v2 >>= 1
            enc.encode(st, k, 1)
            m <<= 1
            k = base
            while v2 >> 1:
                v2 >>= 1
                enc.encode(st, k, 1)
                m <<= 1
                k += 1
    enc.encode(st, k, 0)
    k += 14
    m >>= 1
    while m:
        enc.encode(st, k, 1 if m & v else 0)
        m >>= 1
    return m


def arith_jpeg(baseline: bytes, progressive=False, restart=0,
               dac=None) -> bytes:
    """The quantised coefficients of a Huffman JPEG re-coded with T.81's
    arithmetic coding, as libjpeg's jcarith.c codes them: SOF9 (one
    interleaved scan) or SOF10 (a DC first scan at Al 1, its refinement,
    and for each component AC bands 1-5 and 6-63 at Al 1 and their
    refinement), DRI every `restart` MCUs, and `dac` DAC values
    ({(class << 4 | table): value}). The other markers are copied."""
    from ignis_tpu_torch.utils.jpeg import ZIGZAG, _scan_units, parse_jpeg
    j = parse_jpeg(baseline)
    comps, frame = j["comps"], j["frame"]
    zz = ZIGZAG.tolist()
    order = sorted(comps, key=lambda c: comps[c]["order"])
    out = bytearray(b"\xff\xd8")
    pos = 2
    while True:
        m = baseline[pos + 1]
        n = struct.unpack(">H", baseline[pos + 2:pos + 4])[0]
        if m in (0xDB, 0xE0, 0xEE, 0xE1, 0xFE):
            out += baseline[pos:pos + 2 + n]
        if m in (0xC0, 0xC1, 0xC2):
            sof = bytearray(baseline[pos:pos + 2 + n])
            sof[1] = 0xCA if progressive else 0xC9
        if m == 0xDA:
            break
        pos += 2 + n
    out += bytes(sof)
    dac = dac or {}
    if dac:
        out += _segment(0xCC, b"".join(bytes([k, v]) for k, v in dac.items()))
    if restart:
        out += _segment(0xDD, struct.pack(">H", restart))
    scans = ([(order, 0, 63, 0, 0)] if not progressive else
             [(order, 0, 0, 0, 1), (order, 0, 0, 1, 0)]
             + [([c], 1, 5, 0, 1) for c in order]
             + [([c], 6, 63, 0, 1) for c in order]
             + [([c], 1, 63, 1, 0) for c in order])
    for ids, ss, se, ah, al in scans:
        out += _segment(0xDA, bytes([len(ids)]) + b"".join(
            bytes([c, (comps[c]["order"] and 1) << 4 | (comps[c]["order"]
                                                        and 1)])
            for c in ids) + bytes([ss, se, ah << 4 | al]))
        scan = [(c, comps[c]["order"] and 1, comps[c]["order"] and 1)
                for c in ids]
        rows, cols, units = _scan_units(comps, scan, frame)
        n_mcu = rows * cols
        rst = 0
        for start in range(0, n_mcu, restart or n_mcu):
            if start:
                out += bytes([0xFF, 0xD0 + rst % 8])
                rst += 1
            enc = QMEncoder()
            dc_st = {t: [0] * 64 for t in (0, 1)}
            ac_st = {t: [0] * 256 for t in (0, 1)}
            fixed = [113]
            last = [0] * len(units)
            ctx = [0] * len(units)
            for mcu in range(start, min(start + (restart or n_mcu), n_mcu)):
                my, mx = divmod(mcu, cols)
                for u, (c, hh, vv) in enumerate(units):
                    t = scan[u][1]
                    lu = dac.get(t, 0x10)
                    kx = dac.get(16 | t, 5)
                    for by in range(vv):
                        for bx in range(hh):
                            blk = [int(x) for x in
                                   c["coef"][my * vv + by, mx * hh + bx]]
                            if ss == 0 and ah == 0:
                                dc = blk[0] >> al
                                v = dc - last[u]
                                st = dc_st[t]
                                s0 = ctx[u]
                                if v == 0:
                                    enc.encode(st, s0, 0)
                                    ctx[u] = 0
                                else:
                                    last[u] = dc
                                    enc.encode(st, s0, 1)
                                    sign = v < 0
                                    enc.encode(st, s0 + 1, int(sign))
                                    mag = abs(v)
                                    m = 0
                                    if mag - 1:
                                        m = 1 << (mag - 1).bit_length() - 1
                                    ctx[u] = (0 if m < (1 << (lu & 15)) >> 1
                                              else 12 + 4 * sign
                                              if m > (1 << (lu >> 4)) >> 1
                                              else 4 + 4 * sign)
                                    _qm_magnitude(enc, st, s0 + 2 + sign, mag,
                                                  None)
                            elif ss == 0:
                                enc.encode(fixed, 0, (blk[0] >> al) & 1)
                            if se == 0:
                                continue
                            _arith_ac(enc, ac_st[t], fixed, blk, max(ss, 1),
                                      se, ah, al, kx, zz)
            out += enc.finish()
    return bytes(out) + b"\xff\xd9"


def _arith_ac(enc, st, fixed, blk, ss, se, ah, al, kx, zz):
    """jcarith.c's AC coding of one block over ss..se: first scans
    (Figure F.5 on coefficients / 2^al, rounded toward zero) and, at ah >
    0, refinement (Figure G.10)."""
    def pt(k, shift):
        v = blk[zz[k]]
        return -((-v) >> shift) if v < 0 else v >> shift
    ke = se
    while ke >= ss and pt(ke, al) == 0:
        ke -= 1
    kex = ke
    if ah:
        while kex >= ss and pt(kex, ah) == 0:
            kex -= 1
    k = ss
    while k <= ke:
        s = 3 * (k - 1)
        if not ah or k > kex:
            enc.encode(st, s, 0)
        while True:
            v = pt(k, al)
            if v:
                if ah and abs(v) >> 1:
                    enc.encode(st, s + 2, abs(v) & 1)
                    break
                enc.encode(st, s + 1, 1)
                enc.encode(fixed, 0, int(v < 0))
                if not ah:
                    _qm_magnitude(enc, st, s + 2, abs(v),
                                  189 if k <= kx else 217)
                break
            enc.encode(st, s + 1, 0)
            s += 3
            k += 1
        k += 1
    if k <= se:
        enc.encode(st, 3 * (k - 1), 1)


def avif_grid(tiles, rows, cols, out_w, out_h, in_idat=True,
              wide=False, colr=True, alpha_tiles=None) -> bytes:
    """An AVIF whose primary item is a `grid` (HEIF 6.6.2.3) of `rows` x
    `cols` AV1 tiles, each taken from a single-image AVIF (cv2's or
    Pillow's; all of one size and configuration) in `tiles`, row by row:
    the ImageGrid (16-bit fields, or 32-bit with `wide`) in `idat` or in
    `mdat`, `dimg` references from the grid to its tiles in order, ispe
    of the grid and of the tiles, av1C on the tiles and the first tile's
    colr nclx on the grid (with `colr`); `alpha_tiles` (single-image
    AVIFs with an alpha item) add an alpha grid of their alpha items,
    `auxl` to the colour grid."""
    from ignis_tpu_torch.utils.avif import _boxes, _item_data, _parse_meta

    def item_of(data, alpha=False):
        """(payload, av1C box, colr box or None, (w, h))."""
        meta = next(b for b in _boxes(data, 0, len(data)) if b.type == "meta")
        m = _parse_meta(data, meta)
        item = m["pitm"]
        if alpha:
            item = next(frm for kind, frm, to in m["refs"] if kind == "auxl")
        boxes = {}
        for idx in m["assoc"][item]:
            prop = m["props"][idx - 1]
            start = prop.body - 8
            boxes[prop.type] = data[start:prop.end]
        ispe = boxes["ispe"]
        return (_item_data(data, m, item), boxes["av1C"], boxes.get("colr"),
                struct.unpack(">II", ispe[12:20]))
    colour = [item_of(t) for t in tiles]
    layers = [colour]
    if alpha_tiles is not None:
        layers.append([item_of(t, True) for t in alpha_tiles])
    tw, th = colour[0][3]
    fmt = ">BBBBII" if wide else ">BBBBHH"
    grid = struct.pack(fmt, 0, int(wide), rows - 1, cols - 1, out_w, out_h)

    def box(kind, body):
        return struct.pack(">I4s", 8 + len(body), kind) + body

    def full(kind, version, body, flags=0):
        return box(kind, bytes([version]) + flags.to_bytes(3, "big") + body)
    # items: grids 1 (colour) and 2 (alpha), tiles from 3 on
    props = [full(b"ispe", 0, struct.pack(">II", out_w, out_h)),
             full(b"ispe", 0, struct.pack(">II", tw, th))]
    assoc, infes, locs, refs = {}, [], [], []
    payload = b""
    tile_id = 3
    for layer, items in enumerate(layers):
        gid = 1 + layer
        props.append(items[0][1])                       # av1C
        av1c = len(props)
        gprops = [1]
        if layer == 0 and colr and items[0][2] is not None:
            props.append(items[0][2])
            gprops.append(len(props))
        if layer == 1:
            props.append(full(b"auxC", 0, b"urn:mpeg:mpegB:cicp:systems:"
                              b"auxiliary:alpha\0"))
            gprops.append(len(props))
        assoc[gid] = gprops
        infes.append(full(b"infe", 2, struct.pack(">HH", gid, 0) + b"grid"
                          + b"\0"))
        ids = []
        if not in_idat:
            locs.append((gid, 0, len(payload), len(grid)))
            payload += grid
        for it in items:
            infes.append(full(b"infe", 2, struct.pack(">HH", tile_id, 0)
                              + b"av01\0", flags=1))
            assoc[tile_id] = [2, av1c | 0x80]
            locs.append((tile_id, 0, len(payload), len(it[0])))
            payload += it[0]
            ids.append(tile_id)
            tile_id += 1
        refs.append(box(b"dimg", struct.pack(">HH", gid, len(ids))
                        + b"".join(struct.pack(">H", i) for i in ids)))
        if in_idat:
            locs.append((gid, 1, 0, len(grid)))
        if layer == 1:
            refs.append(box(b"auxl", struct.pack(">HHH", 2, 1, 1)))
    ipco = box(b"ipco", b"".join(props))
    ipma = full(b"ipma", 0, struct.pack(">I", len(assoc)) + b"".join(
        struct.pack(">HB", i, len(p)) + bytes(p)
        for i, p in sorted(assoc.items())))
    ftyp = box(b"ftyp", b"avif" + bytes(4) + b"avifmif1miaf")

    def meta(mdat_at):
        iloc = full(b"iloc", 1, struct.pack(">BBH", 0x44, 0, len(locs))
                    + b"".join(struct.pack(">HHHHII", i, method, 0, 1,
                                           off + (mdat_at if method == 0
                                                  else 0), n)
                               for i, method, off, n in locs))
        return full(b"meta", 0, full(b"hdlr", 0, bytes(4) + b"pict"
                                     + bytes(13))
                    + full(b"pitm", 0, struct.pack(">H", 1)) + iloc
                    + full(b"iinf", 0, struct.pack(">H", len(infes))
                           + b"".join(infes))
                    + full(b"iref", 0, b"".join(refs))
                    + box(b"iprp", ipco + ipma)
                    + (box(b"idat", grid * len(layers)) if in_idat else b""))
    at = len(ftyp) + len(meta(0)) + 8
    return ftyp + meta(at) + box(b"mdat", payload)


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


def hdr(h, w, seed) -> np.ndarray:
    """float32 [h, w, 3] linear radiance over six decades: smooth() in
    (0, 1] times 10^(-3..3) along a diagonal, a few pixels black."""
    yy, xx = np.mgrid[0:h, 0:w]
    scale = 10.0 ** (6.0 * (xx / max(w - 1, 1) + yy / max(h - 1, 1)) / 2
                     - 3.0)
    img = (smooth(h, w, seed, 1.0) + 1e-3) * scale[..., None]
    img[0, :2] = 0.0
    return img.astype(np.float32)


def substitute_env() -> np.ndarray:
    """The 256 x 128 substitute environment map (utils/envgen.py), float32
    RGB: the LogLuv environment maps of chip_smoke.py's texture phase."""
    from ignis_tpu_torch.utils.envgen import make_substitute_env
    return np.asarray(make_substitute_env(256, 128), np.float32)


def _sgilog(comp):
    return [cv2.IMWRITE_TIFF_COMPRESSION, comp]


# OpenCV's LogLuv TIFFs: name -> (image as RGB or grey, parameters)
CV2_LOGLUV = {
    "cv2_sgilog.tif": lambda: (hdr(19, 26, 90), _sgilog(34676)),
    "cv2_sgilog24.tif": lambda: (hdr(19, 26, 91), _sgilog(34677)),
    # float grey: LogL, which cv2 reads as its int8 tone curve
    "cv2_logl.tif": lambda: (hdr(17, 23, 92)[..., 1], _sgilog(34676)),
    "env_sgilog_256x128.tif": lambda: (substitute_env(), _sgilog(34676)),
    "env_sgilog24_256x128.tif": lambda: (substitute_env(), _sgilog(34677)),
}


def _bits(h, w, seed) -> np.ndarray:
    """bool [h, w]: blobs of a smooth image, for the bilevel files."""
    return smooth(h, w, seed)[..., 0] > 128


def with_short_tag(data: bytes, tag: int, value: int) -> bytes:
    """A little-endian classic TIFF with a SHORT tag of its first IFD set
    to `value` in place."""
    out = bytearray(data)
    ifd = struct.unpack("<I", data[4:8])[0]
    for i in range(struct.unpack("<H", data[ifd:ifd + 2])[0]):
        e = ifd + 2 + 12 * i
        if struct.unpack("<H", data[e:e + 2])[0] == tag:
            out[e + 8:e + 10] = struct.pack("<H", value)
            return bytes(out)
    raise KeyError(tag)


def _pil_ccitt(bits, compression, **info) -> bytes:
    from PIL import TiffImagePlugin
    ifd = TiffImagePlugin.ImageFileDirectory_v2()
    for k, v in info.items():
        ifd[int(k[1:])] = v
    return _pil(Image.fromarray(bits), "TIFF", compression=compression,
                tiffinfo=ifd)


def _cmyk_jpeg(transform=None) -> bytes:
    """Pillow's CMYK JPEG with its Adobe marker's transform set, or with
    no Adobe marker at all (transform None)."""
    data = _pil(Image.fromarray(rgb8(21, 27, 93)).convert("CMYK"), "JPEG",
                quality=90)
    at = data.index(b"\xff\xeeAdobe"[:2])
    n = struct.unpack(">H", data[at + 2:at + 4])[0]
    if transform is None:
        return data[:at] + data[at + 2 + n:]
    return data[:at + 15] + bytes([transform]) + data[at + 16:]


def _avif_tiles(n, seed, size=64) -> list:
    """n single-image cv2 AVIFs of size x size, the tiles of a grid."""
    return [cv2.imencode(".avif", rgb8(size, size, seed + k)[..., ::-1])[1]
            .tobytes() for k in range(n)]


def _cv2_jpeg(rgb, quality, sampling=None) -> bytes:
    """cv2's baseline JPEG of uint8 RGB at a quality (and sampling)."""
    params = [cv2.IMWRITE_JPEG_QUALITY, quality]
    if sampling is not None:
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, sampling]
    return cv2.imencode(".jpg", np.ascontiguousarray(rgb[..., ::-1]),
                        params)[1].tobytes()


def _ycc(h, w, seed) -> np.ndarray:
    """uint8 [h, w, 3] Y, Cb, Cr: rgb8's channels as stored samples."""
    return rgb8(h, w, seed)


# the files of the last image slice, cv2's readers' rest: LogLuv, CCITT,
# YCbCr TIFF, lossless and arithmetic JPEG, YCCK, AVIF grids, PAM at
# maxval 1, CIELab and 64-bit TIFF: name -> bytes
MORE_FIXTURES = {
    "sgilog_tiles_be.tif": lambda: logluv_tiff(
        (np.random.default_rng(94).integers(0, 1 << 31, (21, 37))
         | (np.arange(37) // 9 << 20)).astype(np.uint32), 34676, ">",
        (16, 16)),
    "sgilog24_strips.tif": lambda: logluv_tiff(
        np.random.default_rng(95).integers(0, 1 << 24, (18, 25)).astype(
            np.uint32), 34677, "<", None, 5),
    "pil_ccitt_rle.tif": lambda: _pil_ccitt(_bits(23, 37, 96), "tiff_ccitt"),
    "pil_ccitt_rlew.tif": lambda: _pil_ccitt(_bits(23, 37, 97),
                                             "tiff_raw_16"),
    "pil_group3.tif": lambda: _pil_ccitt(_bits(22, 41, 98), "group3"),
    # 2-D rows and EOLs padded to a byte (Group3Options 5)
    "pil_group3_2d.tif": lambda: _pil_ccitt(_bits(25, 39, 99), "group3",
                                            t292=5),
    # runs past 2,560 pixels: the extended makeup codes, several
    "pil_group4_wide.tif": lambda: _pil_ccitt(
        np.repeat(_bits(6, 60, 100), 45, 1), "group4"),
    # white is zero, bits in reversed order (FillOrder 2)
    "group4_photo0_fill2.tif": lambda: with_short_tag(_pil_ccitt(
        _bits(19, 33, 101), "group4", t266=2), 262, 0),
    "ycbcr_22_lzw.tif": lambda: ycbcr_tiff(_ycc(23, 29, 102), 2, 2, 5, "<",
                                           None, 6, 2),
    "ycbcr_41_refbw.tif": lambda: ycbcr_tiff(
        _ycc(21, 31, 103), 4, 1, 8, ">", None, 3, tags=[
            (532, 5, [16, 1, 235, 1, 128, 1, 240, 1, 128, 1, 240, 1]),
            (529, 5, [2126, 10000, 7152, 10000, 722, 10000])]),
    "ycbcr_44_tiles.tif": lambda: ycbcr_tiff(_ycc(37, 45, 104), 4, 4, 5,
                                             "<", (16, 16)),
    "lossless_grey.jpg": lambda: lossless_jpeg(rgb8(19, 23, 105)[..., :1]),
    "lossless_rgb_p7.jpg": lambda: lossless_jpeg(
        rgb8(18, 22, 106), 7, 1, 2, [82, 71, 66]),
    "arith_seq_420.jpg": lambda: arith_jpeg(_cv2_jpeg(
        rgb8(29, 35, 107), 90), restart=4),
    "arith_prog_dac.jpg": lambda: arith_jpeg(_cv2_jpeg(
        noisy8(27, 33, 108), 75, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444), True,
        0, {0: 0x52, 16: 9, 1: 0x21, 17: 2}),
    "ycck.jpg": lambda: _cmyk_jpeg(2),
    "cmyk_no_adobe.jpg": lambda: _cmyk_jpeg(None),
    # the probe's 2 x 1 grid of 64 x 64 tiles, its ImageGrid in idat
    "grid_2x1.avif": lambda: avif_grid(_avif_tiles(2, 109), 1, 2, 128, 64),
    # 2 x 2, cut to 100 x 90, 32-bit sizes, the ImageGrid in mdat
    "grid_2x2_crop.avif": lambda: avif_grid(_avif_tiles(4, 111), 2, 2, 100,
                                            90, False, True),
    "rgb_maxval1.pam": lambda: pam_file(
        (smooth(11, 14, 115) > 128).astype(np.uint8), 1, "RGB"),
    "lab_8bit.tif": lambda: tiff_file(noisy8(17, 21, 116), comp=5, photo=8),
    "uint64_grey.tif": lambda: tiff_file(
        smooth(15, 19, 117, 9e5)[..., :1].astype(np.uint64), comp=5,
        predictor=2),
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
    for name, make in CV2_LOGLUV.items():
        img, params = make()
        if img.ndim == 3:
            img = np.ascontiguousarray(img[..., ::-1])
        assert cv2.imwrite(str(OUT / name), img, params), name
    for name, make in MORE_FIXTURES.items():
        (OUT / name).write_bytes(make())
    avif_names = (list(CV2_AVIF) + list(PIL_AVIF) + list(MATRIX_AVIF)
                  + [n for n in MORE_FIXTURES if n.endswith(".avif")])
    tools = {}
    for name in avif_names:
        tools[name] = coding_tools((OUT / name).read_bytes())
        print(f"{name}: {', '.join(tools[name])}")
    (DATA / "avif_tools.json").write_text(json.dumps(tools, indent=1) + "\n")
    for name in (list(CV2_FIXTURES) + list(PIL_FIXTURES)
                 + list(HAND_FIXTURES) + avif_names + list(CV2_LOGLUV)
                 + [n for n in MORE_FIXTURES if not n.endswith(".avif")]):
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
    its top-left 512 x 512 and 256 x 256 crops, and its waves drawn
    4,160 x 16 (two AV1 tile columns; chip_smoke.wide_source)."""
    import chip_smoke
    smooth = timing_image()
    return {"cv2_lossless.webp": pixels["cv2_lossless.webp"],
            "cv2_q80.webp": pixels["cv2_q80.webp"],
            "rgb8(37, 45, 30)": rgb8(37, 45, 30),
            "smooth_lossless.webp[:512, :512]": smooth[:512, :512],
            "smooth_lossless.webp[:256, :256]": smooth[:256, :256],
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
