"""Image IO without OpenCV or PIL: EXR (utils/exr.py) and PNG read, EXR
write.

The port's counterpart of ignis_tpu/utils/image.py, which reads through
OpenCV. Here PNG is decoded with numpy and zlib (8 or 16 bits, gray, gray
with alpha, RGB or RGBA, non-interlaced, the five row filters) and EXR by
the port's own reader; any other format raises. LDR input is sRGB-decoded
to linear unless `linear`; EXR is linear. Images come back as float32
[h, w, 3] RGB with row 0 at the top.
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


def load_image(path, linear: bool = False) -> np.ndarray:
    """Linear float32 [h, w, 3] RGB. `linear` skips the sRGB decode of LDR
    data images (normal maps; ImagePattern's 'linear' flag)."""
    path = Path(path)
    suffix = path.suffix.lower()
    if suffix == ".exr":
        from .exr import load_exr_rgb
        return np.ascontiguousarray(load_exr_rgb(path), np.float32)
    if suffix == ".png":
        img = read_png(path)
        if not linear:
            img = srgb_to_linear(img)
        return np.ascontiguousarray(img, np.float32)
    raise NotImplementedError(
        f"image format '{suffix}' ({path.name}) is not ported yet: the port "
        "reads EXR and PNG (ROADMAP queue 1, item 17)")


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


def _write_exr_fallback(path, img: np.ndarray):
    """Scanline ZIP-compressed EXR writer, float32 RGB (as the JAX
    package's)."""
    img = np.asarray(img, np.float32)
    h, w, _ = img.shape
    channels = [("B", img[..., 2]), ("G", img[..., 1]), ("R", img[..., 0])]
    _write_exr_channels(path, w, h, channels, b"")


def _write_exr_channels(path, w, h, channels, extra_attrs):

    def attr(name, type_, data):
        return (name.encode() + b"\0" + type_.encode() + b"\0"
                + struct.pack("<I", len(data)) + data)

    chlist = b""
    for name, _ in channels:
        chlist += name.encode() + b"\0" + struct.pack("<iiii", 2, 0, 1, 1)
    chlist += b"\0"
    header = (attr("channels", "chlist", chlist)
              + attr("compression", "compression", bytes([3]))  # ZIP
              + attr("dataWindow", "box2i",
                     struct.pack("<iiii", 0, 0, w - 1, h - 1))
              + attr("displayWindow", "box2i",
                     struct.pack("<iiii", 0, 0, w - 1, h - 1))
              + attr("lineOrder", "lineOrder", bytes([0]))
              + attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
              + attr("screenWindowCenter", "v2f", struct.pack("<ff", 0, 0))
              + attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
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
