"""AV1 reconstruction: dequantisation, the inverse transforms, intra
prediction, intra block copy, inter prediction (av1_inter.py) and the
in-loop filters, as the AV1
specification defines them (libaom and dav1d decode to the same planes).

The inverse transforms (DCT 4-64, ADST 4/8/16, flipped ADST, identity
4-32, the lossless Walsh-Hadamard) run on numpy over every transform
block of one size and type at once, with the spec's intermediate
rounding, the row clamp to BitDepth + 8 bits and the column clamp to
Max(BitDepth + 6, 16) bits at every butterfly sum, the 2:1 rectangular
scaling by 2896 / 4096 and the zero-out above 32 coefficients. Intra
prediction (DC, V, H, the six directional modes with the edge filter and
upsampling, SMOOTH, SMOOTH_V, SMOOTH_H, PAETH, CFL, palette, filter
intra) and intra block copy follow the decode order, as each block reads
its reconstructed neighbours. The deblocking filter (4/6/8/14 taps, a
plane's vertical edges before its horizontal ones), CDEF and loop
restoration (Wiener and self-guided over 64-row stripes that read the
deblocked rows across their boundaries) go over whole planes.
"""
from __future__ import annotations

import numpy as np

from . import av1_tables as T
from .av1 import (D67, DC_PRED, PAETH, SMOOTH, SMOOTH_H, SMOOTH_V, TX_ADJ,
                  TXH, TXLH, TXLW, TXW, UV_CFL, V_PRED, Frame)

COS = np.array(T.COSPI, np.int64)
MODE_TO_ANGLE = (0, 90, 180, 45, 135, 113, 157, 203, 67, 0, 0, 0, 0)
EDGE_KERNEL = ((0, 4, 8, 4, 0), (0, 5, 6, 5, 0), (2, 4, 4, 4, 2))
ROW_SHIFT = (0, 1, 2, 2, 2, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2)
QM_OFFSET = {0: 0, 1: 16, 2: 80, 3: 336, 5: 1360, 6: 1392, 7: 1424,
             8: 1552, 9: 1680, 10: 2192, 13: 2704, 14: 2768, 15: 2832,
             16: 3088}
# 1D transform kinds of each transform type: (vertical, horizontal)
_DCT, _ADST, _FLIP, _IDT = range(4)
TX_KINDS = ((_DCT, _DCT), (_ADST, _DCT), (_DCT, _ADST), (_ADST, _ADST),
            (_FLIP, _DCT), (_DCT, _FLIP), (_FLIP, _FLIP), (_ADST, _FLIP),
            (_FLIP, _ADST), (_IDT, _IDT), (_DCT, _IDT), (_IDT, _DCT),
            (_ADST, _IDT), (_IDT, _ADST), (_FLIP, _IDT), (_IDT, _FLIP))


# ---- 1D inverse transforms on lists of columns ----------------------------
def _rnd(v):
    return (v + 2048) >> 12


def _brev(n, x):
    return int(format(x, f"0{n}b")[::-1], 2) if n else 0


class _Clamp:
    def __init__(self, bits):
        self.lo, self.hi = -(1 << (bits - 1)), (1 << (bits - 1)) - 1

    def __call__(self, v):
        return np.clip(v, self.lo, self.hi)


def _idct_br(x, cl):
    """The inverse DCT of `x`, given in bit-reversed input order."""
    n = len(x)
    if n == 2:
        a, b = x
        return [_rnd((a + b) * COS[32]), _rnd((a - b) * COS[32])]
    e = _idct_br(x[:n // 2], cl)
    o = _idct_odd(x[n // 2:], n, cl)
    m = n // 2
    return ([cl(e[i] + o[m - 1 - i]) for i in range(m)] +
            [cl(e[m - 1 - i] - o[i]) for i in range(m)])


def _idct_odd(y, n, cl):
    m = len(y)
    lg = n.bit_length() - 1
    y = list(y)
    for i in range(m // 2):
        a, b = i, m - 1 - i
        k = _brev(lg, n // 2 + i)
        ang = 64 * k // n
        xa, xb = y[a], y[b]
        y[a] = _rnd(xa * COS[64 - ang] - xb * COS[ang])
        y[b] = _rnd(xa * COS[ang] + xb * COS[64 - ang])
    s = 1
    while 4 * s <= m:
        # sums and differences in groups of 2s, alternating sign
        for r in range(m // (2 * s)):
            g = r * 2 * s
            for t in range(s):
                xa, xb = y[g + t], y[g + 2 * s - 1 - t]
                if r % 2 == 0:
                    y[g + t], y[g + 2 * s - 1 - t] = cl(xa + xb), cl(xa - xb)
                else:
                    y[g + t], y[g + 2 * s - 1 - t] = cl(xb - xa), cl(xa + xb)
        # rotations of the mirrored pairs in groups of 4s
        if 4 * s == m:
            for j in range(s, 2 * s):
                xa, xb = y[j], y[m - 1 - j]
                y[j] = _rnd((xb - xa) * COS[32])
                y[m - 1 - j] = _rnd((xa + xb) * COS[32])
        else:
            nn = n // (4 * s)
            for q in range((m // 2) // (4 * s)):
                k = _brev(nn.bit_length() - 1, nn // 2 + q)
                a_ = 64 * k // nn
                b_ = 64 - a_
                g = q * 4 * s
                for j in range(g + s, g + 2 * s):
                    xa, xb = y[j], y[m - 1 - j]
                    y[j] = _rnd(-xa * COS[a_] + xb * COS[b_])
                    y[m - 1 - j] = _rnd(xa * COS[b_] + xb * COS[a_])
                for j in range(g + 2 * s, g + 3 * s):
                    xa, xb = y[j], y[m - 1 - j]
                    y[j] = _rnd(-xa * COS[b_] - xb * COS[a_])
                    y[m - 1 - j] = _rnd(-xa * COS[a_] + xb * COS[b_])
        s *= 2
    return y


def idct(cols, cl):
    n = len(cols)
    lg = n.bit_length() - 1
    return _idct_br([cols[_brev(lg, i)] for i in range(n)], cl)


def iadst4(x, cl):
    s = T.SINPI
    x0, x1, x2, x3 = x
    s0, s1 = s[1] * x0, s[2] * x0
    s2, s3 = s[3] * x1, s[4] * x2
    s4, s5, s6 = s[1] * x2, s[2] * x3, s[4] * x3
    s7 = (x0 - x2) + x3
    s0 = s0 + s3
    s1 = s1 - s4
    s3 = s2
    s2 = s[3] * s7
    s0 = s0 + s5
    s1 = s1 - s6
    y0, y1, y2, y3 = s0 + s3, s1 + s3, s2, s0 + s1
    y3 = y3 - s3
    return [_rnd(y0), _rnd(y1), _rnd(y2), _rnd(y3)]


def _btf(w0, a, w1, b):
    return _rnd(w0 * a + w1 * b)


def iadst8(x, cl):
    c = COS
    b = [x[7], x[0], x[5], x[2], x[3], x[4], x[1], x[6]]
    t = [None] * 8
    for k, a in enumerate((4, 20, 36, 52)):
        t[2 * k] = _btf(c[a], b[2 * k], c[64 - a], b[2 * k + 1])
        t[2 * k + 1] = _btf(c[64 - a], b[2 * k], -c[a], b[2 * k + 1])
    b = [cl(t[i] + t[i + 4]) for i in range(4)] + \
        [cl(t[i] - t[i + 4]) for i in range(4)]
    b[4], b[5], b[6], b[7] = (_btf(c[16], b[4], c[48], b[5]),
                              _btf(c[48], b[4], -c[16], b[5]),
                              _btf(-c[48], b[6], c[16], b[7]),
                              _btf(c[16], b[6], c[48], b[7]))
    b = [cl(b[0] + b[2]), cl(b[1] + b[3]), cl(b[0] - b[2]), cl(b[1] - b[3]),
         cl(b[4] + b[6]), cl(b[5] + b[7]), cl(b[4] - b[6]), cl(b[5] - b[7])]
    b[2], b[3] = _btf(c[32], b[2], c[32], b[3]), _btf(c[32], b[2], -c[32],
                                                      b[3])
    b[6], b[7] = _btf(c[32], b[6], c[32], b[7]), _btf(c[32], b[6], -c[32],
                                                      b[7])
    return [b[0], -b[4], b[6], -b[2], b[3], -b[7], b[5], -b[1]]


def iadst16(x, cl):
    c = COS
    b = []
    for k in range(8):
        b += [x[15 - 2 * k], x[2 * k]]
    t = [None] * 16
    for k in range(8):
        a = 2 + 8 * k
        t[2 * k] = _btf(c[a], b[2 * k], c[64 - a], b[2 * k + 1])
        t[2 * k + 1] = _btf(c[64 - a], b[2 * k], -c[a], b[2 * k + 1])
    b = [cl(t[i] + t[i + 8]) for i in range(8)] + \
        [cl(t[i] - t[i + 8]) for i in range(8)]
    b[8], b[9] = _btf(c[8], b[8], c[56], b[9]), _btf(c[56], b[8], -c[8],
                                                     b[9])
    b[10], b[11] = (_btf(c[40], b[10], c[24], b[11]),
                    _btf(c[24], b[10], -c[40], b[11]))
    b[12], b[13] = (_btf(-c[56], b[12], c[8], b[13]),
                    _btf(c[8], b[12], c[56], b[13]))
    b[14], b[15] = (_btf(-c[24], b[14], c[40], b[15]),
                    _btf(c[40], b[14], c[24], b[15]))
    nb = list(b)
    for g in (0, 8):
        for i in range(4):
            nb[g + i] = cl(b[g + i] + b[g + i + 4])
            nb[g + i + 4] = cl(b[g + i] - b[g + i + 4])
    b = nb
    for g in (4, 12):
        b[g], b[g + 1], b[g + 2], b[g + 3] = (
            _btf(c[16], b[g], c[48], b[g + 1]),
            _btf(c[48], b[g], -c[16], b[g + 1]),
            _btf(-c[48], b[g + 2], c[16], b[g + 3]),
            _btf(c[16], b[g + 2], c[48], b[g + 3]))
    nb = list(b)
    for g in (0, 4, 8, 12):
        nb[g] = cl(b[g] + b[g + 2])
        nb[g + 1] = cl(b[g + 1] + b[g + 3])
        nb[g + 2] = cl(b[g] - b[g + 2])
        nb[g + 3] = cl(b[g + 1] - b[g + 3])
    b = nb
    for g in (2, 6, 10, 14):
        b[g], b[g + 1] = (_btf(c[32], b[g], c[32], b[g + 1]),
                          _btf(c[32], b[g], -c[32], b[g + 1]))
    return [b[0], -b[8], b[12], -b[4], b[6], -b[14], b[10], -b[2], b[3],
            -b[11], b[15], -b[7], b[5], -b[13], b[9], -b[1]]


def iidentity(x, cl):
    n = len(x)
    if n == 4:
        return [_rnd(v * 5793) for v in x]
    if n == 8:
        return [v * 2 for v in x]
    if n == 16:
        return [_rnd(v * 11586) for v in x]
    return [v * 4 for v in x]


def _one_d(kind, cols, cl):
    n = len(cols)
    if kind == _DCT:
        return idct(cols, cl)
    if kind == _IDT:
        return iidentity(cols, cl)
    out = {4: iadst4, 8: iadst8, 16: iadst16}[n](cols, cl)
    return out[::-1] if kind == _FLIP else out


def iwht(cols, shift):
    a, c, d, b = (v >> shift for v in cols)
    a = a + c
    d = d - b
    e = (a - d) >> 1
    b = e - b
    c = e - c
    a = a - b
    d = d + c
    return [a, b, c, d]


def inverse_transform(coef, tx, txtype, lossless, bd):
    """Residuals of a batch of transform blocks: `coef` int64 [B, h, w]
    dequantised coefficients (zero beyond 32), one size and type."""
    bsz, h, w = coef.shape
    if lossless:
        rows = [coef[:, :, j].reshape(-1) for j in range(4)]
        rows = iwht(rows, 2)
        res = np.stack(rows, -1).reshape(bsz, 4, 4)
        cols = [res[:, i, :].reshape(-1) for i in range(4)]
        cols = iwht(cols, 0)
        return np.stack([c.reshape(bsz, 4) for c in cols], 1)
    vk, hk = TX_KINDS[txtype]
    lw, lh = TXLW[tx], TXLH[tx]
    nr = min(h, 32)
    x = coef[:, :nr, :].astype(np.int64)
    if abs(lw - lh) == 1:
        x = _rnd(x * 2896)
    row_cl = _Clamp(bd + 8)
    x = row_cl(x)
    cols = [x[:, :, j].reshape(-1) for j in range(w)]
    out = _one_d(hk, cols, row_cl)
    r = np.stack(out, -1).reshape(bsz, nr, w)
    sh = ROW_SHIFT[tx]
    if sh:
        r = (r + (1 << (sh - 1))) >> sh
    res = np.zeros((bsz, h, w), np.int64)
    res[:, :nr] = r
    col_cl = _Clamp(max(bd + 6, 16))
    res = col_cl(res)
    cols = [res[:, i, :].reshape(-1) for i in range(h)]
    out = _one_d(vk, cols, col_cl)
    res = np.stack([o.reshape(bsz, w) for o in out], 1)
    return (res + 8) >> 4


def batch_residuals(dec):
    """Dequantises and inverse-transforms every coded transform block of
    the frame, grouped by size, type and losslessness; the residuals land
    in each record's slot 11 as int32 [h, w]."""
    groups = {}
    for rec in dec.records:
        res = rec[11]
        if res is None:
            continue
        groups.setdefault((rec[3], res[0], rec[4].lossless), []).append(rec)
    for (tx, txtype, lossless), recs in groups.items():
        resid = residuals([rec[11] for rec in recs], [rec[0] for rec in recs],
                          tx, lossless, dec.bd)
        for k, rec in enumerate(recs):
            rec[11] = resid[k].astype(np.int32)


_QM = []


def qm_table() -> np.ndarray:
    """av1_tables.quantizer_matrix(), unpacked once."""
    if not _QM:
        _QM.append(T.quantizer_matrix())
    return _QM[0]


def residuals(coefs, planes, tx, lossless, bd):
    """int64 [B, h, w] residuals of B transform blocks of one size and
    type: `coefs` their (tx type, {position: level}, dc quantiser, ac
    quantiser, qm level) as TileDecoder.coeffs reads them, `planes`
    their planes."""
    adj = TX_ADJ[tx]
    aw = TXW[adj]
    h, w = TXH[tx], TXW[tx]
    shift = (w * h > 256) + (w * h > 1024)
    lim = 1 << (7 + bd)
    coef = np.zeros((len(coefs), h, w), np.int64)
    for k, (txtype, out, dcq, acq, qml) in enumerate(coefs):
        mat = None
        if qml < 15:
            mat = qm_table()[qml, 1 if planes[k] else 0, QM_OFFSET[adj]:]
        blk = coef[k]
        for pos, lev in out.items():
            q = dcq if pos == 0 else acq
            if mat is not None:
                q = (q * int(mat[pos]) + 16) >> 5
            a = abs(lev)
            v = ((a * q) & 0xffffff) >> shift
            if lev < 0:
                v = -v
            v = -lim if v < -lim else lim - 1 if v >= lim else v
            blk[pos // aw, pos % aw] = v
    return inverse_transform(coef, tx, coefs[0][0], lossless, bd)


# ---- intra prediction -----------------------------------------------------
def _edge_filter(buf, off, sz, strength):
    """Filters buf[off - 1 .. off + sz - 2] (AboveRow/LeftCol[-1 ..])."""
    if not strength or sz < 2:
        return
    edge = buf[off - 1:off - 1 + sz]
    # the taps read the edge clamped at both ends: pad it by two
    e = np.array(edge[:1] * 2 + edge + edge[-1:] * 2, np.int64)
    k = EDGE_KERNEL[strength - 1]
    s = sum(k[j] * e[1 + j:sz + j] for j in range(5))
    buf[off:off + sz - 1] = ((s + 8) >> 4).tolist()


def _upsample(buf, off, num, mx):
    dup = [0] * (num + 3)
    dup[0] = buf[off - 1]
    for i in range(-1, num):
        dup[i + 2] = buf[off + i]
    dup[num + 2] = buf[off + num - 1]
    buf[off - 2] = dup[0]
    for i in range(num):
        s = -dup[i] + 9 * dup[i + 1] + 9 * dup[i + 2] - dup[i + 3]
        s = min(max((s + 8) >> 4, 0), mx)
        buf[off + 2 * i - 1] = s
        buf[off + 2 * i] = dup[i + 2]


def _strength(w, h, ftype, delta):
    d = abs(delta)
    s = w + h
    if ftype == 0:
        if s <= 8:
            return 1 if d >= 56 else 0
        if s <= 16:
            return 1 if d >= 40 else 0
        if s <= 24:
            return 3 if d >= 32 else 2 if d >= 16 else 1 if d >= 8 else 0
        if s <= 32:
            return 3 if d >= 32 else 2 if d >= 4 else 1 if d >= 1 else 0
        return 3 if d >= 1 else 0
    if s <= 8:
        return 2 if d >= 64 else 1 if d >= 40 else 0
    if s <= 16:
        return 2 if d >= 48 else 1 if d >= 20 else 0
    if s <= 24:
        return 3 if d >= 4 else 0
    return 3 if d >= 1 else 0


def _use_upsample(w, h, ftype, delta):
    d = abs(delta)
    if d <= 0 or d >= 40:
        return 0
    return int(w + h <= (8 if ftype else 16))


def _is_smooth(b, plane):
    if b is None:
        return False
    if plane == 0:
        return b.y_mode in (SMOOTH, SMOOTH_V, SMOOTH_H)
    if b.is_inter:
        return False
    return b.uv_mode in (SMOOTH, SMOOTH_V, SMOOTH_H)


class Recon:
    def __init__(self, dec):
        self.d = dec
        self.bd = dec.bd
        self.mx = (1 << dec.bd) - 1
        self.planes = []
        for p in range(dec.nplanes):
            sx, sy = (dec.ssx, dec.ssy) if p else (0, 0)
            hh = ((dec.mi_rows * 4) >> sy) + 160
            ww = ((dec.mi_cols * 4) >> sx) + 160
            self.planes.append(np.zeros((hh, ww), np.int32))

    def filter_type(self, b, plane):
        d = self.d
        r, c = b.row, b.col
        mi = d.mi
        above = left = None
        au, al = b.avail[2:] if plane else b.avail[:2]
        if au:
            rr, cc = r - 1, c
            if plane:
                if d.ssx and not (c & 1):
                    cc += 1
                if d.ssy and (r & 1):
                    rr -= 1
            above = mi[rr][cc]
        if al:
            rr, cc = r, c - 1
            if plane:
                if d.ssx and (c & 1):
                    cc -= 1
                if d.ssy and not (r & 1):
                    rr += 1
            left = mi[rr][cc]
        return int(_is_smooth(above, plane) or _is_smooth(left, plane))

    def predict_intra(self, rec):
        (plane, x, y, tx, b, have_l, have_a, have_ar, have_bl, _, _, _,
         max_luma) = rec
        d = self.d
        buf = self.planes[plane]
        w, h = TXW[tx], TXH[tx]
        sx, sy = (d.ssx, d.ssy) if plane else (0, 0)
        max_x = ((d.mi_cols * 4) >> sx) - 1
        max_y = ((d.mi_rows * 4) >> sy) - 1
        bd = self.bd
        n = w + h
        off = 16
        above = [0] * (2 * n + 2 * off)
        left = [0] * (2 * n + 2 * off)
        if not have_a and have_l:
            v = int(buf[y, x - 1])
            for i in range(n):
                above[off + i] = v
        elif not have_a and not have_l:
            v = (1 << (bd - 1)) - 1
            for i in range(n):
                above[off + i] = v
        else:
            lim = min(max_x, x + (2 * w if have_ar else w) - 1)
            row = buf[y - 1]
            if lim >= x + n - 1:
                above[off:off + n] = row[x:x + n].tolist()
            else:
                seg = row[x:lim + 1].tolist()
                above[off:off + len(seg)] = seg
                for i in range(len(seg), n):
                    above[off + i] = seg[-1]
        if not have_l and have_a:
            v = int(buf[y - 1, x])
            for i in range(n):
                left[off + i] = v
        elif not have_l and not have_a:
            v = (1 << (bd - 1)) + 1
            for i in range(n):
                left[off + i] = v
        else:
            lim = min(max_y, y + (2 * h if have_bl else h) - 1)
            col = buf[y:lim + 1, x - 1].tolist()
            left[off:off + len(col)] = col
            for i in range(len(col), n):
                left[off + i] = col[-1]
        if have_a and have_l:
            corner = int(buf[y - 1, x - 1])
        elif have_a:
            corner = int(buf[y - 1, x])
        elif have_l:
            corner = int(buf[y, x - 1])
        else:
            corner = 1 << (bd - 1)
        above[off - 1] = left[off - 1] = corner
        mode = b.y_mode if plane == 0 else (DC_PRED if b.uv_mode == UV_CFL
                                            else b.uv_mode)
        if plane == 0 and b.filter_mode >= 0:
            pred = self.filter_intra(b.filter_mode, above, left, off, w, h)
        elif V_PRED <= mode <= D67:
            pred = self.directional(b, plane, x, y, mode, w, h, have_l,
                                    have_a, above, left, off, max_x, max_y)
        elif mode == SMOOTH:
            wx = np.array(T.SM_WEIGHTS[w], np.int64)
            wy = np.array(T.SM_WEIGHTS[h], np.int64)[:, None]
            a = np.array(above[off:off + w], np.int64)
            l_ = np.array(left[off:off + h], np.int64)[:, None]
            p = wy * a + (256 - wy) * left[off + h - 1] + wx * l_ + \
                (256 - wx) * above[off + w - 1]
            pred = (p + 256) >> 9
        elif mode == SMOOTH_V:
            wy = np.array(T.SM_WEIGHTS[h], np.int64)[:, None]
            a = np.array(above[off:off + w], np.int64)
            pred = (wy * a + (256 - wy) * left[off + h - 1] + 128) >> 8
        elif mode == SMOOTH_H:
            wx = np.array(T.SM_WEIGHTS[w], np.int64)
            l_ = np.array(left[off:off + h], np.int64)[:, None]
            pred = (wx * l_ + (256 - wx) * above[off + w - 1] + 128) >> 8
        elif mode == PAETH:
            a = np.array(above[off:off + w], np.int64)[None, :]
            l_ = np.array(left[off:off + h], np.int64)[:, None]
            base = a + l_ - corner
            pl, pt, ptl = np.abs(base - l_), np.abs(base - a), \
                np.abs(base - corner)
            pred = np.where((pl <= pt) & (pl <= ptl), l_,
                            np.where(pt <= ptl, a, corner))
        else:
            lw, lh = TXLW[tx], TXLH[tx]
            if have_a and have_l:
                s = sum(above[off:off + w]) + sum(left[off:off + h])
                avg = (s + ((w + h) >> 1)) // (w + h)
            elif have_a:
                avg = (sum(above[off:off + w]) + (w >> 1)) >> lw
            elif have_l:
                avg = (sum(left[off:off + h]) + (h >> 1)) >> lh
            else:
                avg = 1 << (bd - 1)
            pred = avg
        buf[y:y + h, x:x + w] = pred
        if plane and b.uv_mode == UV_CFL:
            self.cfl(b, plane, x, y, tx, max_luma)

    def directional(self, b, plane, x, y, mode, w, h, have_l, have_a,
                    above, left, off, max_x, max_y):
        d = self.d
        delta = b.angle_y if plane == 0 else b.angle_uv
        ang = MODE_TO_ANGLE[mode] + delta * 3
        up_a = up_l = 0
        if d.seq["edge_filter"]:
            if ang != 90 and ang != 180:
                if 90 < ang < 180 and (w + h) >= 24:
                    v = (left[off] * 5 + above[off - 1] * 6 + above[off] * 5
                         + 8) >> 4
                    above[off - 1] = left[off - 1] = v
                ftype = self.filter_type(b, plane)
                if have_a:
                    st = _strength(w, h, ftype, ang - 90)
                    num = min(w, max_x - x + 1) + (h if ang < 90 else 0) + 1
                    _edge_filter(above, off, num, st)
                if have_l:
                    st = _strength(w, h, ftype, ang - 180)
                    num = min(h, max_y - y + 1) + (w if ang > 180 else 0) + 1
                    _edge_filter(left, off, num, st)
            else:
                ftype = 0
            if ang != 90 and ang != 180:
                up_a = _use_upsample(w, h, ftype, ang - 90)
                if up_a:
                    _upsample(above, off, w + (h if ang < 90 else 0),
                              self.mx)
                up_l = _use_upsample(w, h, ftype, ang - 180)
                if up_l:
                    _upsample(left, off, h + (w if ang > 180 else 0),
                              self.mx)
        dr = T.DR_INTRA_DERIVATIVE
        ii = np.arange(h, dtype=np.int64)[:, None]
        jj = np.arange(w, dtype=np.int64)[None, :]
        A = np.array(above, np.int64)
        L = np.array(left, np.int64)
        if ang == 90:
            return np.broadcast_to(A[off:off + w], (h, w))
        if ang == 180:
            return np.broadcast_to(L[off:off + h, None], (h, w))
        if ang < 90:
            dx = dr[ang]
            idx = (ii + 1) * dx
            base = (idx >> (6 - up_a)) + (jj << up_a)
            shift = ((idx << up_a) >> 1) & 0x1f
            maxb = (w + h - 1) << up_a
            bc = np.minimum(base, maxb)
            v = (A[off + bc] * (32 - shift) + A[off + np.minimum(bc + 1, maxb)]
                 * shift + 16) >> 5
            return np.where(base < maxb, v, A[off + maxb])
        if ang > 180:
            dy = dr[270 - ang]
            idx = (jj + 1) * dy
            base = (idx >> (6 - up_l)) + (ii << up_l)
            shift = ((idx << up_l) >> 1) & 0x1f
            return (L[off + base] * (32 - shift) + L[off + base + 1] * shift
                    + 16) >> 5
        dx = dr[180 - ang]
        dy = dr[ang - 90]
        idx = (jj << 6) - (ii + 1) * dx
        base = idx >> (6 - up_a)
        use_a = base >= -(1 << up_a)
        shift = ((idx << up_a) >> 1) & 0x1f
        ba = np.where(use_a, base, 0)
        va = (A[off + ba] * (32 - shift) + A[off + ba + 1] * shift + 16) >> 5
        idx2 = (ii << 6) - (jj + 1) * dy
        base2 = idx2 >> (6 - up_l)
        shift2 = ((idx2 << up_l) >> 1) & 0x1f
        bl = np.where(use_a, 0, base2)
        vl = (L[off + bl] * (32 - shift2) + L[off + bl + 1] * shift2
              + 16) >> 5
        return np.where(use_a, va, vl)

    def filter_intra(self, fmode, above, left, off, w, h):
        taps = T.FILTER_INTRA_TAPS[fmode]
        pred = [[0] * w for _ in range(h)]
        mx = self.mx
        for i2 in range(h >> 1):
            for j4 in range(w >> 2):
                p = [0] * 7
                for i in range(7):
                    if i < 5:
                        if i2 == 0:
                            p[i] = above[off + (j4 << 2) + i - 1]
                        elif j4 == 0 and i == 0:
                            p[i] = left[off + (i2 << 1) - 1]
                        else:
                            p[i] = pred[(i2 << 1) - 1][(j4 << 2) + i - 1]
                    else:
                        if j4 == 0:
                            p[i] = left[off + (i2 << 1) + i - 5]
                        else:
                            p[i] = pred[(i2 << 1) + i - 5][(j4 << 2) - 1]
                for i in range(8):
                    t = taps[i]
                    pr = (t[0] * p[0] + t[1] * p[1] + t[2] * p[2] +
                          t[3] * p[3] + t[4] * p[4] + t[5] * p[5] +
                          t[6] * p[6])
                    v = (pr + 8) >> 4 if pr >= 0 else -((-pr + 8) >> 4)
                    pred[(i2 << 1) + (i >> 2)][(j4 << 2) + (i & 3)] = \
                        min(max(v, 0), mx)
        return np.array(pred, np.int64)

    def cfl(self, b, plane, x, y, tx, max_luma):
        d = self.d
        w, h = TXW[tx], TXH[tx]
        sx, sy = d.ssx, d.ssy
        alpha = b.cfl_u if plane == 1 else b.cfl_v
        luma = self.planes[0]
        max_w, max_h = max_luma
        ly0, lx0 = y << sy, x << sx
        iy = np.minimum(np.arange(h), ((max_h - ly0) >> sy) - 1)
        jx = np.minimum(np.arange(w), ((max_w - lx0) >> sx) - 1)
        rows = ly0 + (iy << sy)
        cols = lx0 + (jx << sx)
        t = np.zeros((h, w), np.int64)
        for dy in range(sy + 1):
            for dx in range(sx + 1):
                t += luma[(rows + dy)[:, None], (cols + dx)[None, :]]
        L = t << (3 - sx - sy)
        avg = (int(L.sum()) + ((1 << (TXLW[tx] + TXLH[tx])) >> 1)) >> (
            TXLW[tx] + TXLH[tx])
        v = alpha * (L - avg)
        scaled = np.where(v >= 0, (v + 32) >> 6, -((-v + 32) >> 6))
        buf = self.planes[plane]
        dc = buf[y:y + h, x:x + w].astype(np.int64)
        buf[y:y + h, x:x + w] = np.clip(dc + scaled, 0, self.mx)

    def palette(self, rec):
        plane, x, y, tx, b, _, _, _, _, xr, yr, _, _ = rec
        w, h = TXW[tx], TXH[tx]
        if plane == 0:
            pal, cmap = b.pal_colors[0], b.color_map_y
        else:
            pal = b.pal_colors[1] if plane == 1 else b.pal_v
            cmap = b.color_map_uv
        m = np.array(cmap, np.int64)[yr * 4:yr * 4 + h, xr * 4:xr * 4 + w]
        self.planes[plane][y:y + h, x:x + w] = np.array(pal, np.int64)[m]

    def run(self):
        d = self.d
        batch_residuals(d)
        mx = self.mx
        from .av1_inter import predict_inter_block
        from .av1_mv import predict_intrabc
        done = set()
        for rec in d.records:
            plane, x, y, tx, b = rec[:5]
            if b.is_inter:
                key = (id(b), plane)
                if key not in done:
                    done.add(key)
                    if b.use_intrabc:
                        predict_intrabc(self, b, plane)
                    else:
                        predict_inter_block(self, b, plane)
            elif (b.pal_size[0] if plane == 0 else b.pal_size[1]):
                self.palette(rec)
            else:
                self.predict_intra(rec)
            res = rec[11]
            if res is not None:
                h, w = res.shape
                buf = self.planes[plane]
                v = buf[y:y + h, x:x + w] + res
                np.clip(v, 0, mx, out=v)
                buf[y:y + h, x:x + w] = v


def reconstruct(dec) -> Frame:
    """The frame of `dec`'s parse before film grain: prediction and
    residuals, deblocking and CDEF at the coded width, the superres
    upscaling (7.16) of the CDEF output and of the deblocked planes that
    loop restoration reads at its stripes' edges, loop restoration at the
    upscaled width."""
    from .av1_filters import cdef, deblock, restore, upscale
    rc = Recon(dec)
    rc.run()
    planes = rc.planes
    if any(dec.lf_level[:2]):
        deblock(dec, planes)
    pre_cdef = [p.copy() for p in planes] if any(
        t for t in dec.lr_type) else None
    if dec.cdef_on:
        planes = cdef(dec, planes)
    if dec.up_w != dec.w:
        planes = upscale(dec, planes)
        if pre_cdef is not None:
            pre_cdef = upscale(dec, pre_cdef)
    if pre_cdef is not None:
        planes = restore(dec, planes, pre_cdef)
    f = Frame()
    s = dec.seq
    f.bit_depth = dec.bd
    f.mono = bool(s["mono"])
    f.ss_x, f.ss_y = dec.ssx, dec.ssy
    f.color_primaries, f.transfer, f.matrix = s["cp"], s["tc"], s["mc"]
    f.full_range = s["full_range"]
    f.planes = []
    for p in range(dec.nplanes):
        sx, sy = (dec.ssx, dec.ssy) if p else (0, 0)
        f.planes.append(planes[p][:(dec.h + sy) >> sy,
                                  :(dec.up_w + sx) >> sx].copy())
    return f
