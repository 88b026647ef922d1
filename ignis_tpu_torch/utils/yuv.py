"""libavif's YUV to RGB as cv2.imread gets it, and its RGB to YUV as
cv2.imwrite makes it (libavif 1.4.2 with its static libyuv).

RGB to YUV (`rgb_to_yuv420`): 8-bit full-range BT.601 4:2:0, libyuv's
J420 rows in their fixed point, each 2 x 2 block's chroma from the
rounded average of its two rounded column averages (odd widths and
heights average the last column or row with itself).

YUV to RGB, by the nclx matrix_coefficients (MC) and colour primaries:
8-bit images whose matrix libyuv has constants for go through libyuv's
fixed-point YuvPixel (chroma upsampled by libyuv's bilinear ScaleRowUp2
rows for 4:2:0 and 4:2:2): BT.709 (MC 1), BT.601 (MC 2, 5, 6), BT.2020
(MC 9), and MC 12 (chroma-derived) where the primaries are BT.709,
BT.601 or BT.2020, each in full and limited range (`_LIBYUV`). Every
other matrix, and 10- and 12-bit images, go through libavif's built-in
float path (bilinear 9/3/3/1 chroma upsampling in float32), rounded as
libavif rounds: the identity (MC 0, 4:4:4 only), YCgCo (MC 8, full range
only), and Kr, Kb from libavif's table (MC 1, 4, 5, 6, 7, 9), from the
primaries (MC 12) or BT.601's (any other MC cv2 reads: 2 and 15). The
matrices libavif refuses (3, 10, 11, 13, 14, 16 and up, the identity
with subsampled chroma, YCgCo in limited range) raise IOError, as cv2
reads nothing of them. The writers here mark every colour image BT.601
(matrix_coefficients 6) or, lossless, the identity (0).
"""
from __future__ import annotations

import numpy as np

# libyuv's YuvConstants (YG, YB, UB, UG, VG, VR), by (matrix, full range)
_LIBYUV = {(601, 1): (16320, 32, 113, 22, 46, 90),       # kYuvJPEGConstants
           (601, 0): (18997, -1160, 128, 25, 52, 102),   # kYuvI601Constants
           (709, 1): (16320, 32, 119, 12, 30, 101),      # kYuvF709Constants
           (709, 0): (18997, -1160, 128, 14, 34, 115),   # kYuvH709Constants
           (2020, 1): (16320, 32, 120, 11, 37, 94),      # kYuvV2020Constants
           (2020, 0): (19003, -1160, 128, 12, 42, 107)}  # kYuv2020Constants
# the libyuv matrix of each MC libavif hands libyuv, and of each primaries
# for MC 12 (chroma-derived)
_LIBYUV_MC = {1: 709, 2: 601, 5: 601, 6: 601, 9: 2020}
_LIBYUV_CP = {1: 709, 2: 709, 5: 601, 6: 601, 9: 2020}
# libavif's (Kr, Kb) by matrix_coefficients; BT.601's for the others
_KRKB = {1: (0.2126, 0.0722), 4: (0.30, 0.11), 5: (0.299, 0.114),
         6: (0.299, 0.114), 7: (0.212, 0.087), 9: (0.2627, 0.0593)}
# libavif's colour primaries (rx, ry, gx, gy, bx, by, wx, wy); BT.709's
# for the others
_PRIMARIES = {
    1: (0.64, 0.33, 0.30, 0.60, 0.15, 0.06, 0.3127, 0.3290),
    4: (0.67, 0.33, 0.21, 0.71, 0.14, 0.08, 0.310, 0.316),
    5: (0.64, 0.33, 0.29, 0.60, 0.15, 0.06, 0.3127, 0.3290),
    6: (0.630, 0.340, 0.310, 0.595, 0.155, 0.070, 0.3127, 0.3290),
    7: (0.630, 0.340, 0.310, 0.595, 0.155, 0.070, 0.3127, 0.3290),
    8: (0.681, 0.319, 0.243, 0.692, 0.145, 0.049, 0.310, 0.316),
    9: (0.708, 0.292, 0.170, 0.797, 0.131, 0.046, 0.3127, 0.3290),
    10: (1.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.3333, 0.3333),
    11: (0.680, 0.320, 0.265, 0.690, 0.150, 0.060, 0.314, 0.351),
    12: (0.680, 0.320, 0.265, 0.690, 0.150, 0.060, 0.3127, 0.3290),
    22: (0.630, 0.340, 0.295, 0.605, 0.155, 0.077, 0.3127, 0.3290)}
# the matrices cv2 reads a colour image of
_READ = (0, 1, 2, 4, 5, 6, 7, 8, 9, 12, 15)


def _krkb(matrix, primaries):
    """libavif's float32 (Kr, Kb) of a matrix: its table's, the
    chroma-derived ones of the primaries (MC 12: H.273's equations 32-37
    in float32, as avifColorPrimariesComputeYCoeffs computes them), or
    BT.601's."""
    f32 = np.float32
    if matrix != 12:
        kr, kb = _KRKB.get(matrix, (0.299, 0.114))
        return f32(kr), f32(kb)
    rx, ry, gx, gy, bx, by, wx, wy = (f32(v) for v in _PRIMARIES.get(
        primaries, _PRIMARIES[1]))
    one = f32(1)
    rz, gz, bz, wz = (one - (rx + ry), one - (gx + gy), one - (bx + by),
                      one - (wx + wy))
    den = wy * (rx * (gy * bz - by * gz) + gx * (by * rz - ry * bz)
                + bx * (ry * gz - gy * rz))
    kr = (ry * (wx * (gy * bz - by * gz) + wy * (bx * gz - gx * bz)
                + wz * (gx * by - bx * gy))) / den
    kb = (by * (wx * (ry * gz - gy * rz) + wy * (gx * rz - rx * gz)
                + wz * (rx * gy - gx * ry))) / den
    return f32(kr), f32(kb)


def _up2_index(width):
    """The two chroma columns (nearer, farther) that libyuv's ScaleRowUp2
    (with its Any wrapper's edges) blends 3:1 for each output column; the
    first and the last column take their own chroma column alone (the last
    one also at an odd width)."""
    k = np.arange(width)
    near = np.where(k % 2 == 1, (k - 1) // 2, k // 2)
    far = np.where(k % 2 == 1, (k + 1) // 2, np.maximum(k // 2 - 1, 0))
    near[-1] = far[-1] = (width - 1) // 2
    return near, far


def _libyuv_chroma(c, width, height, ssx, ssy):
    """Chroma upsampled to [height, width] as libyuv's *MatrixFilter
    functions (kFilterBilinear) do it."""
    c = c.astype(np.int32)
    if not ssx:
        return c[:height, :width]
    near, far = _up2_index(width)
    # per chroma row: horizontal weights 3 (near) and 1 (far), x 4
    h4 = 3 * c[:, near] + c[:, far]
    if not ssy:
        return (h4 + 2) >> 2
    out = np.empty((height, width), np.int32)
    out[0] = (4 * h4[0] + 8) >> 4
    j = 1
    r = 0
    while j + 1 < height:
        s, t = h4[r], h4[min(r + 1, h4.shape[0] - 1)]
        out[j] = (3 * s + t + 8) >> 4
        out[j + 1] = (s + 3 * t + 8) >> 4
        j += 2
        r += 1
    if j < height:
        out[j] = (4 * h4[r] + 8) >> 4
    return out


def _libyuv_rgb(y, u, v, consts):
    yg, yb, ub, ug, vg, vr = consts
    bb = ub * 128 - yb
    bg = ug * 128 + vg * 128 + yb
    br = vr * 128 - yb
    y1 = ((y.astype(np.int64) * 0x0101 * yg) & 0xffffffff) >> 16
    u = u.astype(np.int64)
    v = v.astype(np.int64)
    b = (y1 + u * ub - bb) >> 6
    g = (y1 + bg - (u * ug + v * vg)) >> 6
    r = (y1 + v * vr - br) >> 6
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


def rgb_to_yuv420(rgb: np.ndarray):
    """Y [h, w] and U, V [(h + 1) // 2, (w + 1) // 2] (int32) of uint8
    RGB [h, w, 3], as libyuv's RGB to J420 makes them."""
    rgb = rgb.astype(np.int32)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    y = (77 * r + 150 * g + 29 * b + 128) >> 8
    h, w = r.shape

    def avg(c):
        c = np.pad(c, ((0, h & 1), (0, w & 1)), mode="edge")
        left = (c[0::2, 0::2] + c[1::2, 0::2] + 1) >> 1
        right = (c[0::2, 1::2] + c[1::2, 1::2] + 1) >> 1
        return (left + right + 1) >> 1
    ra, ga, ba = avg(r), avg(g), avg(b)
    u = (128 * ba - 85 * ga - 43 * ra + 0x8000) >> 8
    v = (128 * ra - 107 * ga - 21 * ba + 0x8000) >> 8
    return y, u, v


def _float_rgb(planes, bd, ssx, ssy, matrix, full, primaries):
    f32 = np.float32
    y = planes[0].astype(np.int64)
    h, w = y.shape
    mx = (1 << bd) - 1
    identity = matrix == 0
    if full:
        bias_y, range_y = f32(0), f32(mx)
        bias_uv, range_uv = f32(1 << (bd - 1)), f32(mx)
    else:
        bias_y, range_y = f32(16 << (bd - 8)), f32(219 << (bd - 8))
        bias_uv, range_uv = f32(1 << (bd - 1)), f32(224 << (bd - 8))
    if identity:
        bias_uv, range_uv = bias_y, range_y
    cp = np.arange(1 << bd, dtype=np.float32)
    tab_y = (cp - bias_y) / range_y
    tab_uv = (cp - bias_uv) / range_uv
    Y = tab_y[np.minimum(y, mx)]
    ch = []
    for c in planes[1:]:
        c = np.minimum(c.astype(np.int64), mx)
        if not ssx and not ssy:
            ch.append(tab_uv[c])
            continue
        i = np.arange(w)
        j = np.arange(h)
        ui, uj = i >> ssx, j >> ssy
        if ssx:
            adj_i = np.where((i == 0) | ((i == w - 1) & (i % 2 != 0)), ui,
                             np.where(i % 2 != 0, ui + 1, ui - 1))
        else:
            adj_i = ui
        if ssy:
            adj_j = np.where((j == 0) | ((j == h - 1) & (j % 2 != 0)), uj,
                             np.where(j % 2 != 0, uj + 1, uj - 1))
        else:
            adj_j = uj
        a = tab_uv[c[uj[:, None], ui[None, :]]] * f32(9.0 / 16.0)
        b = tab_uv[c[uj[:, None], adj_i[None, :]]] * f32(3.0 / 16.0)
        cc = tab_uv[c[adj_j[:, None], ui[None, :]]] * f32(3.0 / 16.0)
        d = tab_uv[c[adj_j[:, None], adj_i[None, :]]] * f32(1.0 / 16.0)
        ch.append(((a + b) + cc) + d)
    cb, cr = ch
    if identity:
        R, G, B = cr, Y, cb
    elif matrix == 8:                          # YCgCo: Cg in U, Co in V
        t = Y - cb
        R, G, B = t + cr, Y + cb, t - cr
    else:
        kr, kb = _krkb(matrix, primaries)
        kg = f32(1.0) - kr - kb
        R = Y + (f32(2) * (f32(1) - kr)) * cr
        B = Y + (f32(2) * (f32(1) - kb)) * cb
        G = Y - ((f32(2) * (((kr * (f32(1) - kr)) * cr) +
                           ((kb * (f32(1) - kb)) * cb))) / kg)
    out = []
    for v in (R, G, B):
        v = np.clip(v, f32(0), f32(1))
        out.append((f32(0.5) + v * f32(mx)).astype(np.int64))
    return np.stack(out, -1).astype(np.uint8 if bd == 8 else np.uint16)


def yuv_to_rgb(planes, bd, ssx, ssy, matrix, full, primaries=1) -> np.ndarray:
    """RGB [h, w, 3] (uint8 for 8 bits, else uint16 at the image's own
    depth) of decoded Y, U, V planes, as libavif converts them for cv2
    under the nclx matrix_coefficients `matrix` and colour `primaries`;
    IOError where libavif converts nothing."""
    if matrix not in _READ or matrix == 0 and (ssx or ssy) \
            or matrix == 8 and not full:
        kind = "full" if full else "limited"
        raise IOError(
            f"AVIF: libavif converts no image of colour matrix "
            f"(matrix_coefficients) {matrix} at {kind} range, chroma "
            f"subsampled {ssx}, {ssy}: OpenCV reads nothing")
    lib = _LIBYUV_CP.get(primaries) if matrix == 12 else _LIBYUV_MC.get(
        matrix)
    if bd == 8 and lib is not None:
        y = planes[0]
        h, w = y.shape
        u = _libyuv_chroma(planes[1], w, h, ssx, ssy)
        v = _libyuv_chroma(planes[2], w, h, ssx, ssy)
        return _libyuv_rgb(y, u, v, _LIBYUV[(lib, int(full))])
    return _float_rgb(planes, bd, ssx, ssy, matrix, full, primaries)
