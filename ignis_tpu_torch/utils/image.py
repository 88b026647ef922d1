"""Image IO without OpenCV or PIL: EXR, Radiance HDR and PNG, read and
written.

The port's counterpart of ignis_tpu/utils/image.py, which goes through
OpenCV. Here PNG is decoded with numpy and zlib (8 or 16 bits, gray, gray
with alpha, RGB or RGBA, non-interlaced, the five row filters) and
encoded as 8-bit RGB with filter 0 (`encode_png`); EXR is read by the
port's own reader and written as scanline ZIP (`_write_exr_channels`,
also `write_exr_multilayer`'s layers and ig* attributes); Radiance .hdr
is read with flat or run-length-encoded scanlines and written flat, in
the RGBE rounding of the rgbe.c that OpenCV uses. JPEG, BMP and TGA are
not ported. LDR input is sRGB-decoded to linear unless `linear`; EXR and
HDR are linear; LDR output is sRGB-encoded with +0.5 rounding, as the
JAX writer's. Images are float32 [h, w, 3] RGB with row 0 at the top.
"""
from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

_PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}   # colour type -> samples


def srgb_to_linear(x: np.ndarray) -> np.ndarray:
    return np.where(x <= 0.04045, x / 12.92, ((x + 0.055) / 1.055) ** 2.4)


def linear_to_srgb(x: np.ndarray) -> np.ndarray:
    x = np.clip(x, 0.0, 1.0)
    return np.where(x <= 0.0031308, x * 12.92, 1.055 * x ** (1 / 2.4) - 0.055)


def _unsupported(path: Path, what: str) -> NotImplementedError:
    return NotImplementedError(
        f"image format '{path.suffix.lower()}' ({path.name}) is not ported: "
        f"the port {what} EXR, HDR and PNG (JPEG, BMP and TGA need codecs "
        "of their own; ROADMAP queue 1, item 17)")


def load_image(path, linear: bool = False) -> np.ndarray:
    """Linear float32 [h, w, 3] RGB. `linear` skips the sRGB decode of LDR
    data images (normal maps; ImagePattern's 'linear' flag)."""
    path = Path(path)
    suffix = path.suffix.lower()
    if suffix == ".exr":
        from .exr import load_exr_rgb
        return np.ascontiguousarray(load_exr_rgb(path), np.float32)
    if suffix == ".hdr":
        return read_hdr(path)
    if suffix == ".png":
        img = read_png(path)
        if not linear:
            img = srgb_to_linear(img)
        return np.ascontiguousarray(img, np.float32)
    raise _unsupported(path, "reads")


def save_image(path, img):
    """Save linear float32 [h, w, 3] RGB: EXR (ZIP) and HDR keep it
    linear, PNG is 8-bit sRGB."""
    path = Path(path)
    img = np.asarray(img, np.float32)
    suffix = path.suffix.lower()
    if suffix == ".exr":
        _write_exr_fallback(path, img)
    elif suffix == ".hdr":
        write_hdr(path, img)
    elif suffix == ".png":
        ldr = (linear_to_srgb(img) * 255.0 + 0.5).astype(np.uint8)
        path.write_bytes(encode_png(ldr))
    else:
        raise _unsupported(path, "writes")


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


def write_hdr(path, img):
    """Radiance RGBE file, flat scanlines, row 0 at the top."""
    img = np.asarray(img, np.float32)
    h, w = img.shape[:2]
    head = (f"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y {h} +X {w}\n"
            ).encode()
    Path(path).write_bytes(head + _rgbe(img[..., :3]).tobytes())


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


def read_hdr(path) -> np.ndarray:
    """A Radiance .hdr file (flat or RLE scanlines, -Y h +X w) as float32
    [h, w, 3] (rgbe.c's rgbe2float: m * 2^(e - 136))."""
    data = Path(path).read_bytes()
    if not data.startswith(b"#?"):
        raise ValueError(f"{path}: not a Radiance HDR file")
    pos = data.index(b"\n\n") + 2
    end = data.index(b"\n", pos)
    dims = data[pos:end].split()
    pos = end + 1
    if len(dims) != 4 or dims[0] != b"-Y" or dims[2] != b"+X":
        raise NotImplementedError(
            f"{path}: HDR orientation {data[pos:end]!r} is not ported "
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


def read_png(path) -> np.ndarray:
    """A PNG as float32 [h, w, 3] in [0, 1] (sRGB-encoded values)."""
    data = Path(path).read_bytes()
    if data[:8] != _PNG_MAGIC:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        n, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if ctype == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
    if hdr is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, color, _, _, interlace = hdr
    if color not in _PNG_CHANNELS or depth not in (8, 16) or interlace:
        raise NotImplementedError(
            f"{path}: PNG colour type {color}, {depth} bits, interlace "
            f"{interlace} is not ported (8/16-bit gray, gray+alpha, RGB or "
            "RGBA, not interlaced)")
    ch = _PNG_CHANNELS[color]
    bpp = ch * depth // 8
    rows = _unfilter(zlib.decompress(b"".join(idat)), h, w * bpp, bpp)
    if depth == 16:
        img = rows.view(">u2").reshape(h, w, ch).astype(np.float32) / 65535.0
    else:
        img = rows.reshape(h, w, ch).astype(np.float32) / 255.0
    if ch <= 2:
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
