"""SGI LogLuv TIFF in numpy: the HDR encodings of Greg Ward's LogLuv
(photometric 32845) and LogL (32844), read as OpenCV reads them through
libtiff's tif_luv.c.

Compression 34676 (SGILog) codes each row on its own, one byte plane
after another (most significant first: LogLuv's 16-bit signed log L, 8-bit
u' and 8-bit v'; LogL's 16 bits), each plane run-length coded: a byte n
>= 128 repeats the next byte n - 126 times, a byte n < 128 is followed by
n literal bytes. Compression 34677 (SGILog24) stores three bytes a pixel,
big-endian, uncoded: a 10-bit log L and a 14-bit index into libtiff's
table of u'v' cells (utils/logluv_table.py: 163 rows of 0.0035-wide
squares).

OpenCV asks libtiff for float XYZ of a LogLuv file (LogLuv32toXYZ /
LogLuv24toXYZ, computed in double and stored as float) and turns it into
BGR with cvtColor's XYZ2BGR in float32; the port gives the same floats as
RGB. Of a LogL file OpenCV gets libtiff's 8-bit tone curve, 256 sqrt(Y)
truncated (0 at Y <= 0, 255 at Y >= 1), and keeps the file's signed
sample format: int8, so Y >= 0.25 reads negative. The port gives those
int8 values too, as ignis_tpu's load_image returns them.
"""
from __future__ import annotations

import math

import numpy as np

# libtiff's uvcode.h: UV_SQSIZ and UV_VSTART, both stored as float; its
# rows of cells are utils/logluv_table.py's
_UV_SQSIZ = float(np.float32(0.0035))
_UV_VSTART = float(np.float32(0.01694))


def _uv_rows():
    """[(ustart as float, first index, cells)] of the 163 rows: a row's
    first index is the sum of the cells before it."""
    from .logluv_table import UV_ROWS
    rows, first = [], 0
    for ustart, nus in UV_ROWS:
        rows.append((float(np.float32(ustart)), first, nus))
        first += nus
    return rows


def _uv_table() -> np.ndarray:
    """[16384, 2] float64 (u', v') of every 14-bit index as libtiff's
    uv_decode gives it; indices past the table decode to the neutral
    (U_NEU, V_NEU), as LogLuv24toXYZ takes them."""
    uv = np.empty((1 << 14, 2), np.float64)
    uv[:] = (0.210526316, 0.473684211)
    for vi, (ustart, first, nus) in enumerate(_uv_rows()):
        ui = np.arange(nus, dtype=np.float64)
        uv[first:first + nus, 0] = ustart + (ui + .5) * _UV_SQSIZ
        uv[first:first + nus, 1] = _UV_VSTART + (vi + .5) * _UV_SQSIZ
    return uv


def _log16_table() -> np.ndarray:
    """[32768] float64 |Y| of each 15-bit log L (LogL16toY)."""
    le = range(1 << 15)
    return np.array([0.0] + [math.exp(math.log(2) / 256. * (k + .5)
                                      - math.log(2) * 64.)
                             for k in le[1:]], np.float64)


def _log10_table() -> np.ndarray:
    """[1024] float64 Y of each 10-bit log L (LogL10toY)."""
    return np.array([0.0] + [math.exp(math.log(2) / 64. * (k + .5)
                                      - math.log(2) * 12.)
                             for k in range(1, 1024)], np.float64)


def rle_planes(raw: bytes, rows: int, cols: int, planes: int):
    """[rows, cols] uint32 words of SGILog-coded rows: each row `planes`
    byte planes, most significant first, run-length coded as tif_luv.c's
    LogLuvDecode32 / LogL16Decode reads them. A row whose planes run out
    of bytes raises IOError (libtiff's "Not enough data")."""
    out = np.zeros(rows * planes * cols, np.uint8)
    src, dst = [], []
    pos, n = 0, len(raw)
    for p in range(rows * planes):
        i, base = 0, p * cols
        while i < cols and pos < n:
            h = raw[pos]
            if h >= 128:
                if pos + 1 >= n:
                    break
                k = min(h - 126, cols - i)
                out[base + i:base + i + k] = raw[pos + 1]
                i += k
                pos += 2
            else:
                k = min(h, cols - i, n - pos - 1)
                src.append(np.arange(pos + 1, pos + 1 + k))
                dst.append(np.arange(base + i, base + i + k))
                i += k
                pos += 1 + k
        if i != cols:
            raise IOError(f"SGILog: not enough data at row {p // planes}")
    if src:
        buf = np.frombuffer(raw, np.uint8)
        out[np.concatenate(dst)] = buf[np.concatenate(src)]
    b = out.reshape(rows, planes, cols).astype(np.uint32)
    word = np.zeros((rows, cols), np.uint32)
    for k in range(planes):
        word |= b[:, k] << (8 * (planes - 1 - k))
    return word


def packed24(raw: bytes, rows: int, cols: int) -> np.ndarray:
    """[rows, cols] uint32 of SGILog24's three big-endian bytes a pixel."""
    need = rows * cols * 3
    if len(raw) < need:
        raise IOError("SGILog24: not enough data")
    b = np.frombuffer(raw, np.uint8, need).reshape(rows, cols, 3).astype(
        np.uint32)
    return b[..., 0] << 16 | b[..., 1] << 8 | b[..., 2]


def _xyz(L: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """float32 [..., 3] XYZ of luminance L and chroma (u', v'), in
    LogLuv32toXYZ's double arithmetic; L <= 0 is black."""
    with np.errstate(all="ignore"):
        s = 1. / (6. * u - 16. * v + 12.)
        x = 9. * u * s
        y = 4. * v * s
        xyz = np.stack([x / y * L, L, (1. - x - y) / y * L], -1)
    xyz[L <= 0.] = 0.
    return xyz.astype(np.float32)


def luv32_to_xyz(p: np.ndarray) -> np.ndarray:
    """float32 [..., 3] XYZ of 32-bit LogLuv words (LogLuv32toXYZ)."""
    p = p.astype(np.int64)
    le = (p >> 16) & 0x7FFF
    L = _log16_table()[le]
    L[(p >> 31) & 1 == 1] *= -1.0
    u = 1. / 410. * (((p >> 8) & 0xFF) + .5)
    v = 1. / 410. * ((p & 0xFF) + .5)
    return _xyz(L, u, v)


def luv24_to_xyz(p: np.ndarray) -> np.ndarray:
    """float32 [..., 3] XYZ of 24-bit LogLuv words (LogLuv24toXYZ)."""
    p = p.astype(np.int64)
    L = _log10_table()[(p >> 14) & 0x3FF]
    uv = _uv_table()[p & 0x3FFF]
    return _xyz(L, uv[..., 0], uv[..., 1])


def logl_grey(p: np.ndarray) -> np.ndarray:
    """int8 of 16-bit LogL words as libtiff's L16toGry tones them:
    256 sqrt(Y) truncated, 0 at Y <= 0 (a negative or zero log L), 255 at
    Y >= 1, the byte taken as signed."""
    p = p.astype(np.int64)
    Y = _log16_table()[p & 0x7FFF]
    g = np.where(Y >= 1., 255, (256. * np.sqrt(Y)).astype(np.int64))
    g[(p & 0x8000 != 0) | (Y <= 0.)] = 0
    return g.astype(np.uint8).view(np.int8)


# OpenCV's XYZ2sRGB_D65, as float32, rows in RGB order
_XYZ2RGB = np.array([[3.240479, -1.53715, -0.498535],
                     [-0.969256, 1.875991, 0.041556],
                     [0.055648, -0.204043, 1.057311]], np.float32)


def xyz_to_rgb(xyz: np.ndarray) -> np.ndarray:
    """float32 [h, w, 3] RGB of float32 XYZ as OpenCV's cvtColor
    (COLOR_XYZ2BGR) computes it row by row: four pixels at a time as
    X * c0 + (Y * c1 + Z * c2) in float32 arithmetic, the last w % 4 of a
    row as X * c0 + Y * c1 + Z * c2."""
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    c = _XYZ2RGB
    rgb = np.stack([x * c[k, 0] + (y * c[k, 1] + z * c[k, 2])
                    for k in range(3)], -1)
    v = xyz.shape[-2] - xyz.shape[-2] % 4
    x, y, z = x[..., v:], y[..., v:], z[..., v:]
    rgb[..., v:, :] = np.stack([x * c[k, 0] + y * c[k, 1] + z * c[k, 2]
                                for k in range(3)], -1)
    return rgb.astype(np.float32)
