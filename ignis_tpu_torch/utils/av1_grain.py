"""AV1 film grain synthesis (spec 7.18.3), applied to the output planes as
libaom's decoder applies it: the grain templates from the Gaussian
sequence and the auto-regressive filter, the piecewise-linear scaling
functions, 32 x 32 luma blocks at random offsets blended across their
overlaps, and the noise added with the optional clip to restricted
range."""
from __future__ import annotations

import numpy as np

from . import av1_tables as T


def read_grain_params(br, mono, ssx, ssy, seed=None):
    """film_grain_params() after apply_grain == 1 and update_grain == 1;
    `seed` is grain_seed where the caller has read it."""
    g = {"seed": br.f(16) if seed is None else seed}
    ny = br.f(4)
    g["y"] = [(br.f(8), br.f(8)) for _ in range(ny)]
    g["cfl"] = 0 if mono else br.f(1)
    g["cb"], g["cr"] = [], []
    if not (mono or g["cfl"] or (ssx == 1 and ssy == 1 and ny == 0)):
        g["cb"] = [(br.f(8), br.f(8)) for _ in range(br.f(4))]
        g["cr"] = [(br.f(8), br.f(8)) for _ in range(br.f(4))]
    g["scaling_shift"] = br.f(2) + 8
    lag = br.f(2)
    g["lag"] = lag
    npos = 2 * lag * (lag + 1)
    g["ar_y"] = [br.f(8) - 128 for _ in range(npos)] if ny else []
    npc = npos + 1 if ny else npos
    g["ar_cb"] = [br.f(8) - 128 for _ in range(npc)] \
        if (g["cfl"] or g["cb"]) else []
    g["ar_cr"] = [br.f(8) - 128 for _ in range(npc)] \
        if (g["cfl"] or g["cr"]) else []
    g["ar_shift"] = br.f(2) + 6
    g["grain_scale_shift"] = br.f(2)
    g["cb_mult"] = g["cb_luma_mult"] = g["cb_offset"] = 0
    g["cr_mult"] = g["cr_luma_mult"] = g["cr_offset"] = 0
    if g["cb"]:
        g["cb_mult"], g["cb_luma_mult"], g["cb_offset"] = br.f(8), br.f(8), \
            br.f(9)
    if g["cr"]:
        g["cr_mult"], g["cr_luma_mult"], g["cr_offset"] = br.f(8), br.f(8), \
            br.f(9)
    g["overlap"] = br.f(1)
    g["clip"] = br.f(1)
    return g


class _Rng:
    def __init__(self, seed):
        self.r = seed

    def get(self, bits):
        r = self.r
        bit = (r ^ (r >> 1) ^ (r >> 3) ^ (r >> 12)) & 1
        r = (r >> 1) | (bit << 15)
        self.r = r
        return (r >> (16 - bits)) & ((1 << bits) - 1)


def _round2(v, n):
    return (v + (1 << (n - 1))) >> n


def _templates(g, bd, ssx, ssy):
    gauss = T.GAUSSIAN_SEQUENCE
    center = 128 << (bd - 8)
    gmin, gmax = -center, (256 << (bd - 8)) - 1 - center
    shift = 12 - bd + g["grain_scale_shift"]
    rng = _Rng(g["seed"])
    ny = len(g["y"])
    luma = [[_round2(gauss[rng.get(11)], shift) if ny else 0
             for _ in range(82)] for _ in range(73)]
    lag, ars = g["lag"], g["ar_shift"]
    if ny:
        for y in range(3, 73):
            for x in range(3, 82 - 3):
                s = 0
                pos = 0
                for dr in range(-lag, 1):
                    for dc in range(-lag, lag + 1):
                        if dr == 0 and dc == 0:
                            break
                        s += luma[y + dr][x + dc] * g["ar_y"][pos]
                        pos += 1
                luma[y][x] = min(max(luma[y][x] + _round2(s, ars), gmin),
                                 gmax)
    cw, ch = (44 if ssx else 82), (38 if ssy else 73)
    chroma = []
    for key, xor in (("cb", 0xb524), ("cr", 0x49d8)):
        on = bool(g[key]) or bool(g["cfl"])
        rng = _Rng(g["seed"] ^ xor)
        chroma.append([[_round2(gauss[rng.get(11)], shift) if on else 0
                        for _ in range(cw)] for _ in range(ch)])
    cb, cr = chroma
    for y in range(3, ch):
        for x in range(3, cw - 3):
            s0 = s1 = 0
            pos = 0
            for dr in range(-lag, 1):
                for dc in range(-lag, lag + 1):
                    c0 = g["ar_cb"][pos] if g["ar_cb"] else 0
                    c1 = g["ar_cr"][pos] if g["ar_cr"] else 0
                    if dr == 0 and dc == 0:
                        if ny:
                            lx = ((x - 3) << ssx) + 3
                            ly = ((y - 3) << ssy) + 3
                            lum = 0
                            for i in range(ssy + 1):
                                for j in range(ssx + 1):
                                    lum += luma[ly + i][lx + j]
                            if ssx + ssy:
                                lum = (lum + (1 << (ssx + ssy - 1))) >> (
                                    ssx + ssy)
                            s0 += lum * c0
                            s1 += lum * c1
                        break
                    s0 += c0 * cb[y + dr][x + dc]
                    s1 += c1 * cr[y + dr][x + dc]
                    pos += 1
            if g["cb"] or g["cfl"]:
                cb[y][x] = min(max(cb[y][x] + _round2(s0, ars), gmin), gmax)
            if g["cr"] or g["cfl"]:
                cr[y][x] = min(max(cr[y][x] + _round2(s1, ars), gmin), gmax)
    return (np.array(luma, np.int64), np.array(cb, np.int64),
            np.array(cr, np.int64))


def _scaling_lut(points):
    lut = np.zeros(256, np.int64)
    if not points:
        return lut
    lut[:points[0][0]] = points[0][1]
    for i in range(len(points) - 1):
        (x0, y0), (x1, y1) = points[i], points[i + 1]
        dx, dy = x1 - x0, y1 - y0
        delta = dy * ((65536 + (dx >> 1)) // dx)
        for x in range(dx):
            lut[x0 + x] = y0 + ((x * delta + 32768) >> 16)
    lut[points[-1][0]:] = points[-1][1]
    return lut


def _scale(lut, idx, bd):
    if bd == 8:
        return lut[idx]
    sh = bd - 8
    x = idx >> sh
    rem = idx - (x << sh)
    start = lut[x]
    end = lut[np.minimum(x + 1, 255)]
    v = start + (((end - start) * rem + (1 << (sh - 1))) >> sh)
    return np.where(x == 255, start, v)


def _round2_arr(v, n):
    return (v + (1 << (n - 1))) >> n


def apply_grain(g, planes, bd, ssx, ssy, matrix):
    """Adds film grain to the cropped output planes (int arrays)."""
    h, w = planes[0].shape
    nplanes = len(planes)
    center = 128 << (bd - 8)
    gmin, gmax = -center, (256 << (bd - 8)) - 1 - center
    tmpl = _templates(g, bd, ssx, ssy)
    overlap = g["overlap"]
    # noise stripes of 34 luma rows, one per 32 rows of the frame
    nstripes = (h + 31) // 32 + 1
    stripes = []
    for p in range(nplanes):
        sx, sy = (ssx, ssy) if p else (0, 0)
        stripes.append(np.zeros((nstripes, 34 >> sy, ((w + 1) // 2 + 48)
                                 * 2 >> sx), np.int64))
    luma_num = 0
    for y in range(0, (h + 1) // 2, 16):
        rng = _Rng(g["seed"] ^ (((luma_num * 37 + 178) & 255) << 8)
                   ^ ((luma_num * 173 + 105) & 255))
        for x in range(0, (w + 1) // 2, 16):
            rand = rng.get(8)
            ox, oy = rand >> 4, rand & 15
            for p in range(nplanes):
                sx, sy = (ssx, ssy) if p else (0, 0)
                px = 6 + ox if sx else 9 + ox * 2
                py = 6 + oy if sy else 9 + oy * 2
                blk = tmpl[p][py:py + (34 >> sy), px:px + (34 >> sx)].copy()
                st = stripes[p][luma_num]
                x0 = x * 2 if not sx else x
                if overlap and x > 0:
                    if not sx:
                        old0, old1 = st[:, x0], st[:, x0 + 1]
                        blk[:, 0] = np.clip(_round2_arr(
                            old0 * 27 + blk[:, 0] * 17, 5), gmin, gmax)
                        blk[:, 1] = np.clip(_round2_arr(
                            old1 * 17 + blk[:, 1] * 27, 5), gmin, gmax)
                    else:
                        old = st[:, x0]
                        blk[:, 0] = np.clip(_round2_arr(
                            old * 23 + blk[:, 0] * 22, 5), gmin, gmax)
                st[:, x0:x0 + blk.shape[1]] = blk
        luma_num += 1
    noise = []
    for p in range(nplanes):
        sx, sy = (ssx, ssy) if p else (0, 0)
        ph, pw = (h + sy) >> sy, (w + sx) >> sx
        img = np.zeros((ph, pw), np.int64)
        for yy in range(ph):
            n = yy >> (5 - sy)
            i = yy - (n << (5 - sy))
            row = stripes[p][n][i, :pw].copy()
            if overlap and n > 0:
                if not sy and i < 2:
                    old = stripes[p][n - 1][i + 32, :pw]
                    row = np.clip(_round2_arr(
                        old * 27 + row * 17 if i == 0 else old * 17 + row * 27,
                        5), gmin, gmax)
                elif sy and i < 1:
                    old = stripes[p][n - 1][i + 16, :pw]
                    row = np.clip(_round2_arr(old * 23 + row * 22, 5), gmin,
                                  gmax)
            img[yy] = row
        noise.append(img)
    if g["clip"]:
        lo = 16 << (bd - 8)
        max_y = 235 << (bd - 8)
        max_c = max_y if matrix == 0 else 240 << (bd - 8)
    else:
        lo, max_y = 0, (256 << (bd - 8)) - 1
        max_c = max_y
    mx = (1 << bd) - 1
    shift = g["scaling_shift"]
    out_y = planes[0].astype(np.int64)
    out = [out_y]
    if nplanes > 1:
        ph, pw = planes[1].shape
        ly = (np.arange(ph) << ssy)[:, None]
        lx = (np.arange(pw) << ssx)[None, :]
        if ssx:
            nx = np.minimum(lx + 1, w - 1)
            avg = (out_y[ly, lx] + out_y[ly, nx] + 1) >> 1
        else:
            avg = out_y[ly, lx]
        for p, key in ((1, "cb"), (2, "cr")):
            orig = planes[p].astype(np.int64)
            if g[key] or g["cfl"]:
                if g["cfl"]:
                    merged = avg
                    lut = _scaling_lut(g["y"])
                else:
                    comb = avg * (g[key + "_luma_mult"] - 128) + orig * (
                        g[key + "_mult"] - 128)
                    merged = np.clip((comb >> 6) + ((g[key + "_offset"] - 256)
                                                    << (bd - 8)), 0, mx)
                    lut = _scaling_lut(g[key])
                nz = _round2_arr(_scale(lut, merged, bd) * noise[p], shift)
                orig = np.clip(orig + nz, lo, max_c)
            out.append(orig)
    if g["y"]:
        lut = _scaling_lut(g["y"])
        nz = _round2_arr(_scale(lut, out_y, bd) * noise[0], shift)
        out[0] = np.clip(out_y + nz, lo, max_y)
    return out
