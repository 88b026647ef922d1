"""AV1's in-loop filters over whole planes with numpy: the deblocking
filter (spec 7.14), CDEF (7.15), the superres upscaling (7.16) and loop
restoration (7.17).

Within one pass of the deblocking filter no two edges touch the same
samples (a filter is never wider than the transforms on both of its
sides), so a pass filters all its edges at once; a plane's vertical
edges go before its horizontal ones, as in the specification.
"""
from __future__ import annotations

import numpy as np

from . import av1_tables as T
from .av1 import BH4, BW4, TXH, TXW

CDEF_DIRECTIONS = (((-1, 1), (-2, 2)), ((0, 1), (-1, 2)), ((0, 1), (0, 2)),
                   ((0, 1), (1, 2)), ((1, 1), (2, 2)), ((1, 0), (2, 1)),
                   ((1, 0), (2, 0)), ((1, 0), (2, -1)))
CDEF_UV_DIR = (((0, 1, 2, 3, 4, 5, 6, 7), (1, 2, 2, 2, 3, 4, 6, 0)),
               ((7, 0, 2, 4, 5, 6, 6, 6), (0, 1, 2, 3, 4, 5, 6, 7)))
DIV_TABLE = (0, 840, 420, 280, 210, 168, 140, 120, 105)


# modes that take loop_filter_mode_deltas[1] (7.14.4): NEARESTMV, NEARMV,
# NEWMV and the compound modes but GLOBAL_GLOBALMV
_MODE_TYPE = np.array([0] * 13 + [1, 1, 0, 1] + [1] * 6 + [0, 1], np.int8)


def _mi_arrays(dec):
    """Per 4 x 4 luma unit: block size, skip, is_inter, segment, delta
    lf, RefFrame[0] and the mode's loop filter mode type."""
    rows, cols = dec.mi_rows, dec.mi_cols
    size = np.zeros((rows, cols), np.int16)
    skip = np.zeros((rows, cols), np.int8)
    inter = np.zeros((rows, cols), np.int8)
    seg = np.zeros((rows, cols), np.int8)
    dlf = np.zeros((rows, cols, 4), np.int16)
    ref = np.zeros((rows, cols), np.int8)
    mode = np.zeros((rows, cols), np.int8)
    for r in range(rows):
        row = dec.mi[r]
        size[r] = [b.size for b in row]
        skip[r] = [b.skip for b in row]
        inter[r] = [b.is_inter for b in row]
        seg[r] = [b.seg for b in row]
        dlf[r] = [b.delta_lf for b in row]
        ref[r] = [b.ref[0] for b in row]
        mode[r] = [b.y_mode for b in row]
    return size, skip, inter, seg, dlf, ref, _MODE_TYPE[mode]


def _levels(dec, plane, pas, seg, dlf, ref, mtype):
    """Filter level per 4 x 4 luma unit for one plane and pass (7.14.4)."""
    i = pas if plane == 0 else plane + 1
    delta = dlf[..., i if dec.delta_lf_multi else 0].astype(np.int32)
    lvl = np.clip(delta + dec.lf_level[i], 0, 63)
    if dec.seg_enabled:
        feat = np.array([dec.seg_feat[s][1 + i] or 0 for s in range(8)])
        on = np.array([dec.seg_feat[s][1 + i] is not None for s in range(8)])
        lvl = np.where(on[seg], np.clip(lvl + feat[seg], 0, 63), lvl)
    if dec.lf_delta_enabled:
        shift = lvl >> 5
        rd = np.array(dec.lf_ref_deltas, np.int32)[np.maximum(ref, 0)]
        md = np.array(dec.lf_mode_deltas, np.int32)[mtype]
        lvl = np.clip(lvl + (rd << shift) + np.where(ref > 0, md << shift,
                                                      0), 0, 63)
    return lvl


def deblock(dec, planes, only=None):
    """Deblocks `planes` in place (those of `only`, when given)."""
    size, skip, inter, seg, dlf, ref, mtype = _mi_arrays(dec)
    bw = np.array(BW4, np.int32)[size] * 4
    bh = np.array(BH4, np.int32)[size] * 4
    txw, txh = np.array(TXW, np.int32), np.array(TXH, np.int32)
    sharp = dec.lf_sharp
    shift = 2 if sharp > 4 else 1 if sharp > 0 else 0
    for p in range(dec.nplanes):
        if p and not dec.lf_level[1 + p] or only is not None and \
                p not in only:
            continue
        sx, sy = (dec.ssx, dec.ssy) if p else (0, 0)
        lf = dec.lf_tx[p].astype(np.int32)
        ph, pw = lf.shape
        # mi of each plane 4 x 4 unit: (y << sy) | sy, (x << sx) | sx
        mr = np.minimum((np.arange(ph) << sy) | sy, dec.mi_rows - 1)
        mc = np.minimum((np.arange(pw) << sx) | sx, dec.mi_cols - 1)
        for pas in range(2):
            lvl_mi = _levels(dec, p, pas, seg, dlf, ref, mtype)
            lvl = lvl_mi[mr[:, None], mc[None, :]]
            if pas == 0:
                prev_lvl = np.zeros_like(lvl)
                prev_lvl[:, 1:] = lvl[:, :-1]
                prev_tx = np.zeros_like(lf)
                prev_tx[:, 1:] = lf[:, :-1]
                pos = (np.arange(pw) * 4)[None, :]
                bsz = np.maximum(bw[mr[:, None], mc[None, :]] >> sx, 4)
                tsz, ptsz = txw[lf], txw[prev_tx]
                on = (np.arange(pw) > 0)[None, :] & \
                    ((np.arange(pw) << sx) * 4 < dec.w)[None, :] & \
                    ((np.arange(ph) << sy) * 4 < dec.h)[:, None]
            else:
                prev_lvl = np.zeros_like(lvl)
                prev_lvl[1:] = lvl[:-1]
                prev_tx = np.zeros_like(lf)
                prev_tx[1:] = lf[:-1]
                pos = (np.arange(ph) * 4)[:, None]
                bsz = np.maximum(bh[mr[:, None], mc[None, :]] >> sy, 4)
                tsz, ptsz = txh[lf], txh[prev_tx]
                on = (np.arange(ph) > 0)[:, None] & \
                    ((np.arange(pw) << sx) * 4 < dec.w)[None, :] & \
                    ((np.arange(ph) << sy) * 4 < dec.h)[:, None]
            sk = skip[mr[:, None], mc[None, :]].astype(bool)
            intra = ~inter[mr[:, None], mc[None, :]].astype(bool)
            is_block = (pos % bsz) == 0
            is_tx = (pos % tsz) == 0
            apply = on & is_tx & (is_block | ~sk | intra)
            fsize = np.minimum(np.minimum(tsz, ptsz), 16 if p == 0 else 8)
            lv = np.where(lvl == 0, prev_lvl, lvl)
            apply &= lv > 0
            if not apply.any():
                continue
            if sharp > 0:
                limit = np.clip(lv >> shift, 1, 9 - sharp)
            else:
                limit = np.maximum(1, lv >> shift)
            blimit = 2 * (lv + 2) + limit
            thresh = lv >> 4
            ys, xs = np.nonzero(apply)
            buf = planes[p] if pas == 0 else planes[p].T
            if pas == 1:
                ys, xs = xs, ys
                fs = fsize.T[ys, xs]
                lim, blim, thr = limit.T[ys, xs], blimit.T[ys, xs], \
                    thresh.T[ys, xs]
            else:
                fs = fsize[ys, xs]
                lim, blim, thr = limit[ys, xs], blimit[ys, xs], \
                    thresh[ys, xs]
            _filter_edges(buf, ys, xs, fs, lim, blim, thr, p, dec.bd)


def _filter_edges(buf, ys, xs, fs, lim, blim, thr, plane, bd):
    """Filters vertical edges at x = 4 * xs of rows 4 * ys .. + 3 in
    `buf` (a plane, or its transpose for horizontal edges)."""
    k = np.arange(4)
    rows = (ys[:, None] * 4 + k[None, :]).reshape(-1)
    x0 = np.repeat(xs * 4, 4)
    fs = np.repeat(fs, 4)
    sh = bd - 8
    lim = np.repeat(lim, 4).astype(np.int64) << sh
    blim = np.repeat(blim, 4).astype(np.int64) << sh
    thr = np.repeat(thr, 4).astype(np.int64) << sh
    offs = np.arange(-8, 8)
    cols = x0[:, None] + offs[None, :]
    valid = cols >= 0
    cols = np.maximum(cols, 0)
    v = buf[rows[:, None], cols].astype(np.int64)
    v[~valid] = 0

    def P(i):
        return v[:, 7 - i]

    def Q(i):
        return v[:, 8 + i]
    ad = np.abs
    hev = (ad(P(1) - P(0)) > thr) | (ad(Q(1) - Q(0)) > thr)
    flen = np.where(fs == 4, 4, 6 if plane else np.where(fs == 8, 8, 16))
    mask = (ad(P(1) - P(0)) > lim) | (ad(Q(1) - Q(0)) > lim) | \
        (ad(P(0) - Q(0)) * 2 + (ad(P(1) - Q(1)) >> 1) > blim)
    mask |= (flen >= 6) & ((ad(P(2) - P(1)) > lim) | (ad(Q(2) - Q(1)) > lim))
    mask |= (flen >= 8) & ((ad(P(3) - P(2)) > lim) | (ad(Q(3) - Q(2)) > lim))
    fmask = ~mask
    one = 1 << sh
    flat = ~((ad(P(1) - P(0)) > one) | (ad(Q(1) - Q(0)) > one) |
             (ad(P(2) - P(0)) > one) | (ad(Q(2) - Q(0)) > one) |
             ((flen >= 8) & ((ad(P(3) - P(0)) > one) |
                             (ad(Q(3) - Q(0)) > one))))
    flat &= fs >= 8
    flat2 = ~((ad(P(6) - P(0)) > one) | (ad(Q(6) - Q(0)) > one) |
              (ad(P(5) - P(0)) > one) | (ad(Q(5) - Q(0)) > one) |
              (ad(P(4) - P(0)) > one) | (ad(Q(4) - Q(0)) > one))
    flat2 &= fs >= 16
    narrow = fmask & ((fs == 4) | ~flat)
    wide3 = fmask & ~narrow & ((fs == 8) | ~flat2)
    wide4 = fmask & ~narrow & ~wide3
    out = v.copy()
    if narrow.any():
        lo, hi = -(1 << (bd - 1)), (1 << (bd - 1)) - 1
        o80 = 0x80 << sh
        s = narrow
        ps1, ps0 = P(1)[s] - o80, P(0)[s] - o80
        qs0, qs1 = Q(0)[s] - o80, Q(1)[s] - o80
        h = hev[s]
        f = np.where(h, np.clip(ps1 - qs1, lo, hi), 0)
        f = np.clip(f + 3 * (qs0 - ps0), lo, hi)
        f1 = np.clip(f + 4, lo, hi) >> 3
        f2 = np.clip(f + 3, lo, hi) >> 3
        idx = np.nonzero(s)[0]
        out[idx, 8] = np.clip(qs0 - f1, lo, hi) + o80
        out[idx, 7] = np.clip(ps0 + f2, lo, hi) + o80
        f = (f1 + 1) >> 1
        nh = ~h
        out[idx[nh], 9] = np.clip(qs1 - f, lo, hi)[nh] + o80
        out[idx[nh], 6] = np.clip(ps1 + f, lo, hi)[nh] + o80
    for sel, log2 in ((wide3, 3), (wide4, 4)):
        if not sel.any():
            continue
        if log2 == 4:
            n, n2 = 6, 1
        elif plane == 0:
            n, n2 = 3, 0
        else:
            n, n2 = 2, 1
        idx = np.nonzero(sel)[0]
        vv = v[idx]
        for i in range(-n, n):
            t = 0
            for j in range(-n, n + 1):
                pidx = min(max(i + j, -(n + 1)), n)
                tap = 2 if abs(j) <= n2 else 1
                t = t + vv[:, 8 + pidx] * tap
            out[idx, 8 + i] = (t + (1 << (log2 - 1))) >> log2
    changed = (out != v) & valid
    r_i, c_i = np.nonzero(changed)
    buf[rows[r_i], cols[r_i, c_i]] = out[r_i, c_i]


# ---- CDEF -------------------------------------------------------------------
def _cdef_dir(blocks, bd):
    """Direction and variance of each 8 x 8 block ([K, 8, 8] int)."""
    x = (blocks.astype(np.int64) >> (bd - 8)) - 128
    K = x.shape[0]
    ii, jj = np.mgrid[0:8, 0:8]
    bins = [ii + jj, ii + jj // 2, ii + 0 * jj, 3 + ii - jj // 2,
            7 + ii - jj, 3 - ii // 2 + jj, jj + 0 * ii, ii // 2 + jj]
    partial = np.zeros((8, K, 15), np.int64)
    flat = x.reshape(K, 64)
    for d in range(8):
        m = np.zeros((64, 15), np.int64)
        m[np.arange(64), bins[d].reshape(-1)] = 1
        partial[d] = flat @ m
    cost = np.zeros((8, K), np.int64)
    cost[2] = (partial[2][:, :8] ** 2).sum(1) * DIV_TABLE[8]
    cost[6] = (partial[6][:, :8] ** 2).sum(1) * DIV_TABLE[8]
    for d in (0, 4):
        c = partial[d][:, 7] ** 2 * DIV_TABLE[8]
        for i in range(7):
            c = c + (partial[d][:, i] ** 2 + partial[d][:, 14 - i] ** 2) * \
                DIV_TABLE[i + 1]
        cost[d] = c
    for d in (1, 3, 5, 7):
        c = (partial[d][:, 3:8] ** 2).sum(1) * DIV_TABLE[8]
        for j in range(3):
            c = c + (partial[d][:, j] ** 2 + partial[d][:, 10 - j] ** 2) * \
                DIV_TABLE[2 * j + 2]
        cost[d] = c
    best = np.argmax(cost, 0)          # the first of equal costs, as '>'
    bc = cost[best, np.arange(K)]
    var = (bc - cost[(best + 4) & 7, np.arange(K)]) >> 10
    return best, var


def _constrain(diff, thr, damp):
    adj = np.maximum(0, damp - _floor_log2(np.maximum(thr, 1)))
    val = np.minimum(np.abs(diff), np.maximum(0, thr - (np.abs(diff) >> adj)))
    return np.where(thr == 0, 0, np.sign(diff) * val)


def _floor_log2(v):
    return np.floor(np.log2(v)).astype(np.int64)


def cdef(dec, planes, only=None):
    """The CDEF-filtered planes (those of `only`, when given; the others
    as they were)."""
    skip = _mi_arrays(dec)[1]
    bd = dec.bd
    cs = bd - 8
    rows, cols = dec.mi_rows, dec.mi_cols
    r8 = np.arange(0, rows, 2)
    c8 = np.arange(0, cols, 2)
    R, C = np.meshgrid(r8, c8, indexing="ij")
    R, C = R.reshape(-1), C.reshape(-1)
    idx = np.array([dec.cdef_idx.get((r & ~15, c & ~15), -1)
                    for r, c in zip(R.tolist(), C.tolist())], np.int64)
    sk = skip[R, C] & skip[R + 1, C] & skip[R, C + 1] & skip[R + 1, C + 1]
    sel = (idx >= 0) & (sk == 0)
    out = [p.copy() for p in planes]
    if not sel.any():
        return out
    R, C, idx = R[sel], C[sel], idx[sel]
    luma = planes[0]
    yy = (R * 4)[:, None, None] + np.arange(8)[None, :, None]
    xx = (C * 4)[:, None, None] + np.arange(8)[None, None, :]
    ydir, var = _cdef_dir(luma[yy, xx], bd)
    ystr = np.array(dec.cdef_y, np.int64)[idx]
    uvstr = np.array(dec.cdef_uv, np.int64)[idx]
    for p in range(dec.nplanes):
        if only is not None and p not in only:
            continue
        sx, sy = (dec.ssx, dec.ssy) if p else (0, 0)
        if p == 0:
            pri, sec = ystr[:, 0] << cs, ystr[:, 1] << cs
            dirs = np.where(pri == 0, 0, ydir)
            vs = np.where((var >> 6) > 0,
                          np.minimum(_floor_log2(np.maximum(var >> 6, 1)),
                                     12), 0)
            pri = np.where(var > 0, (pri * (4 + vs) + 8) >> 4, 0)
            damp = dec.cdef_damping + cs
        else:
            pri, sec = uvstr[:, 0] << cs, uvstr[:, 1] << cs
            dirs = np.where(pri == 0, 0, np.array(CDEF_UV_DIR[sx][sy])[ydir])
            damp = dec.cdef_damping + cs - 1
        if not (pri.any() or sec.any()):
            continue
        _cdef_plane(planes[p], out[p], R, C, dirs, pri, sec, damp, sx, sy,
                    dec, cs)
    return out


def _cdef_plane(src, dst, R, C, dirs, pri, sec, damp, sx, sy, dec, cs):
    h, w = 8 >> sy, 8 >> sx
    y0 = ((R * 4) >> sy)[:, None, None]
    x0 = ((C * 4) >> sx)[:, None, None]
    yy = y0 + np.arange(h)[None, :, None]
    xx = x0 + np.arange(w)[None, None, :]
    x = src[yy, xx].astype(np.int64)
    hmax = (dec.mi_rows * 4) >> sy
    wmax = (dec.mi_cols * 4) >> sx
    total = np.zeros_like(x)
    mx, mn = x.copy(), x.copy()
    pri_b = pri[:, None, None]
    sec_b = sec[:, None, None]
    taps_sel = (pri >> cs) & 1
    pri_taps = np.array(((4, 2), (3, 3)), np.int64)[taps_sel]
    sec_taps = np.array(((2, 1), (2, 1)), np.int64)[taps_sel]
    dirv = np.array(CDEF_DIRECTIONS, np.int64)
    for k in range(2):
        for sign in (-1, 1):
            for kind, dset in (("p", dirs), ("s1", (dirs + 2) & 7),
                               ("s2", (dirs - 2) & 7)):
                dy = dirv[dset, k, 0][:, None, None]
                dx = dirv[dset, k, 1][:, None, None]
                ty, tx_ = yy + sign * dy, xx + sign * dx
                ok = (ty >= 0) & (ty < hmax) & (tx_ >= 0) & (tx_ < wmax)
                v = src[np.clip(ty, 0, src.shape[0] - 1),
                        np.clip(tx_, 0, src.shape[1] - 1)].astype(np.int64)
                if kind == "p":
                    c = _constrain(v - x, pri_b, damp)
                    total += np.where(ok, pri_taps[:, k][:, None, None] * c,
                                      0)
                else:
                    c = _constrain(v - x, sec_b, damp)
                    total += np.where(ok, sec_taps[:, k][:, None, None] * c,
                                      0)
                mx = np.where(ok, np.maximum(mx, v), mx)
                mn = np.where(ok, np.minimum(mn, v), mn)
    y = x + ((8 + total - (total < 0)) >> 4)
    dst[yy, xx] = np.clip(y, mn, mx)


# ---- superres ---------------------------------------------------------------
SCALE_BITS, EXTRA_BITS = 14, 8      # SUPERRES_SCALE_BITS, _EXTRA_BITS


def upscale_params(down: int, up: int):
    """(stepX, initialSubpelX) of 7.16 for a plane row of `down` samples
    upscaled to `up`; C's truncating division."""
    def div(a, b):
        q = abs(a) // b
        return q if a >= 0 else -q
    step = ((down << SCALE_BITS) + up // 2) // up
    err = up * step - (down << SCALE_BITS)
    x0 = div(-((up - down) << (SCALE_BITS - 1)) + up // 2, up) + \
        (1 << (EXTRA_BITS - 1)) - div(err, 2)
    return step, x0 & ((1 << SCALE_BITS) - 1)


def upscale(dec, planes):
    """The planes upscaled to UpscaledWidth (7.16): each output sample
    the 8-tap Upscale_Filter phase of its position, stepX apart from
    initialSubpelX, over the coded samples clamped to the MI-aligned
    width (columns past the frame's width read as decoded)."""
    taps = np.array(T.UPSCALE_FILTER, np.int64)
    mx = (1 << dec.bd) - 1
    out = []
    for p, buf in enumerate(planes):
        sx = dec.ssx if p else 0
        down = (dec.w + sx) >> sx
        up = (dec.up_w + sx) >> sx
        step, x0 = upscale_params(down, up)
        pos = x0 + np.arange(up, dtype=np.int64) * step
        first = (pos >> SCALE_BITS) - 1 - 3        # 8 taps from srcX - 3
        phase = (pos & ((1 << SCALE_BITS) - 1)) >> EXTRA_BITS
        last = ((dec.mi_cols * 4) >> sx) - 1
        cols = np.clip(first[:, None] + np.arange(8)[None, :], 0, last)
        src = buf[:, cols].astype(np.int64)          # [rows, up, 8]
        v = (src * taps[phase][None]).sum(-1)
        res = np.zeros((buf.shape[0], up + 160), np.int32)
        res[:, :up] = np.clip((v + 64) >> 7, 0, mx)
        out.append(res)
    return out


# ---- loop restoration -------------------------------------------------------
def restore(dec, planes, deblocked):
    out = [p.copy() for p in planes]
    bd = dec.bd
    for p in range(dec.nplanes):
        if dec.lr_type[p] == 0:
            continue
        sx, sy = (dec.ssx, dec.ssy) if p else (0, 0)
        size = dec.lr_size[p]
        pw, ph = (dec.up_w + sx) >> sx, (dec.h + sy) >> sy
        unit_rows = max((ph + (size >> 1)) // size, 1)
        unit_cols = max((pw + (size >> 1)) // size, 1)
        m = 0
        while True:
            lo_y = (-8 + 64 * m) >> sy
            ys0, ys1 = max(0, lo_y), min(ph, lo_y + (64 >> sy))
            if ys0 >= ph:
                break
            stripe_end = lo_y + (64 >> sy) - 1
            ur = min(unit_rows - 1, ((64 * m) >> sy) // size)
            for uc in range(unit_cols):
                unit = dec.lr_units[p].get((ur, uc))
                if unit is None or unit[0] == 0:
                    continue
                xs0 = uc * size
                xs1 = pw if uc == unit_cols - 1 else min(pw, (uc + 1) * size)
                src = _lr_source(planes[p], deblocked[p], xs0, xs1, ys0, ys1,
                                 lo_y, stripe_end, pw, ph)
                cdef_px = planes[p][ys0:ys1, xs0:xs1].astype(np.int64)
                if unit[0] == 1:
                    res = _wiener(src, unit[1], bd, ys1 - ys0, xs1 - xs0)
                else:
                    res = _sgr(src, cdef_px, unit[1], unit[2], bd)
                out[p][ys0:ys1, xs0:xs1] = res
            m += 1
    return out


def _lr_source(cdefd, deblocked, xs0, xs1, ys0, ys1, s0, s1, pw, ph):
    """Samples around [ys0, ys1) x [xs0, xs1), 3 beyond each side, as
    get_source_sample gives them."""
    ys = np.arange(ys0 - 3, ys1 + 3)
    xs = np.clip(np.arange(xs0 - 3, xs1 + 3), 0, pw - 1)
    yc = np.clip(ys, 0, ph - 1)
    above = yc < s0
    below = yc > s1
    yv = np.where(above, np.maximum(s0 - 2, yc),
                  np.where(below, np.minimum(s1 + 2, yc), yc))
    src = cdefd[yv[:, None], xs[None, :]].astype(np.int64)
    deb = deblocked[yv[:, None], xs[None, :]].astype(np.int64)
    return np.where((above | below)[:, None], deb, src)


def _wiener(src, coeffs, bd, h, w):
    r0 = 5 if bd == 12 else 3
    r1 = 9 if bd == 12 else 11
    vf, hf = coeffs

    def taps(c):
        f = [c[0], c[1], c[2], 128 - 2 * (c[0] + c[1] + c[2]), c[2], c[1],
             c[0]]
        return f
    hft, vft = taps(hf), taps(vf)
    off = 1 << (bd + 7 - r0 - 1)
    lim = (1 << (bd + 1 + 7 - r0)) - 1
    inter = np.zeros((h + 6, w), np.int64)
    for t in range(7):
        inter += hft[t] * src[:, t:t + w]
    inter = np.clip((inter + (1 << (r0 - 1))) >> r0, -off, lim - off)
    out = np.zeros((h, w), np.int64)
    for t in range(7):
        out += vft[t] * inter[t:t + h]
    out = (out + (1 << (r1 - 1))) >> r1
    return np.clip(out, 0, (1 << bd) - 1)


def _box_sums(a, r):
    """Sums over (2r + 1) x (2r + 1) windows of a 2D array (valid part)."""
    c = np.cumsum(np.cumsum(np.pad(a, ((1, 0), (1, 0))), 0), 1)
    k = 2 * r + 1
    return c[k:, k:] - c[:-k, k:] - c[k:, :-k] + c[:-k, :-k]


def _sgr(src, cdef_px, s, xqd, bd):
    h, w = cdef_px.shape
    params = T.SGR_PARAMS[s]
    flt = []
    for pas in range(2):
        r, s_ = params[pas * 2], params[pas * 2 + 1]
        if r == 0:
            flt.append(None)
            continue
        n = (2 * r + 1) ** 2
        # A and B over rows -1 .. h and columns -1 .. w
        win = src[3 - 1 - r:3 + h + 1 + r, 3 - 1 - r:3 + w + 1 + r]
        a = _box_sums(win * win, r)
        b = _box_sums(win, r)
        if bd > 8:
            a = (a + (1 << (2 * (bd - 8) - 1))) >> (2 * (bd - 8))
            d = (b + (1 << (bd - 9))) >> (bd - 8)
        else:
            d = b
        p = np.maximum(0, a * n - d * d)
        z = (p * s_ + (1 << 19)) >> 20
        a2 = np.where(z >= 255, 256, np.where(
            z == 0, 1, ((z << 8) + (z // 2)) // (z + 1)))
        one_over_n = ((1 << 12) + (n // 2)) // n
        b2 = ((1 << 8) - a2) * b * one_over_n
        A, B = a2, (b2 + (1 << 11)) >> 12
        fa = np.zeros((h, w), np.int64)
        fb = np.zeros((h, w), np.int64)
        odd = (np.arange(h) & 1).astype(bool)
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                As = A[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
                Bs = B[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
                if pas == 0:
                    wt = np.where(((np.arange(h) + dy) & 1).astype(bool),
                                  6 if dx == 0 else 5, 0)[:, None]
                else:
                    wt = 4 if dx == 0 or dy == 0 else 3
                fa += wt * As
                fb += wt * Bs
        shift = np.where(odd, 4, 5)[:, None] if pas == 0 else 5
        v = fa * cdef_px + fb
        sh = 8 + shift - 4
        flt.append((v + (1 << (sh - 1))) >> sh)
    w0, w1 = xqd
    w2 = (1 << 7) - w0 - w1
    u = cdef_px << 4
    v = w1 * u
    v = v + (w0 * flt[0] if flt[0] is not None else w0 * u)
    v = v + (w2 * flt[1] if flt[1] is not None else w2 * u)
    s_out = (v + (1 << 10)) >> 11
    return np.clip(s_out, 0, (1 << bd) - 1)
