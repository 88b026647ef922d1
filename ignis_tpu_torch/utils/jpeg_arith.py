"""Arithmetic-coded JPEG (SOF9 sequential, SOF10 progressive) in numpy, as
libjpeg(-turbo)'s jdarith.c decodes it for OpenCV: the QM coder of ITU-T
T.81 Annex D (`QE`: Table D.3's probability estimates) and the statistics
of Annex F and G: DC differences in contexts conditioned on the previous
difference's size (the DAC marker's L and U, 0 and 1 by default), AC
coefficients in contexts of their zig-zag index (above DAC's Kx, 5 by
default, magnitudes take the second set), signs of AC coefficients and
refinement bits at the fixed probability 1/2 (state 113). Statistics and
the coder restart at each scan and each restart marker; a marker inside
the data feeds the coder zeros. The coefficients go to the same arrays
(natural order) that utils/jpeg.py's Huffman scans fill.
"""
from __future__ import annotations

from .jpeg import ZIGZAG, _scan_units, _segments

# T.81 Table D.3 as jaricom.c packs it: (Qe, Next_Index_LPS,
# Next_Index_MPS, Switch_MPS) of states 0-112, and 113, libjpeg's fixed
# probability 1/2
QE = (
    (0x5a1d, 1, 1, 1), (0x2586, 14, 2, 0), (0x1114, 16, 3, 0),
    (0x080b, 18, 4, 0), (0x03d8, 20, 5, 0), (0x01da, 23, 6, 0),
    (0x00e5, 25, 7, 0), (0x006f, 28, 8, 0), (0x0036, 30, 9, 0),
    (0x001a, 33, 10, 0), (0x000d, 35, 11, 0), (0x0006, 9, 12, 0),
    (0x0003, 10, 13, 0), (0x0001, 12, 13, 0), (0x5a7f, 15, 15, 1),
    (0x3f25, 36, 16, 0), (0x2cf2, 38, 17, 0), (0x207c, 39, 18, 0),
    (0x17b9, 40, 19, 0), (0x1182, 42, 20, 0), (0x0cef, 43, 21, 0),
    (0x09a1, 45, 22, 0), (0x072f, 46, 23, 0), (0x055c, 48, 24, 0),
    (0x0406, 49, 25, 0), (0x0303, 51, 26, 0), (0x0240, 52, 27, 0),
    (0x01b1, 54, 28, 0), (0x0144, 56, 29, 0), (0x00f5, 57, 30, 0),
    (0x00b7, 59, 31, 0), (0x008a, 60, 32, 0), (0x0068, 62, 33, 0),
    (0x004e, 63, 34, 0), (0x003b, 32, 35, 0), (0x002c, 33, 9, 0),
    (0x5ae1, 37, 37, 1), (0x484c, 64, 38, 0), (0x3a0d, 65, 39, 0),
    (0x2ef1, 67, 40, 0), (0x261f, 68, 41, 0), (0x1f33, 69, 42, 0),
    (0x19a8, 70, 43, 0), (0x1518, 72, 44, 0), (0x1177, 73, 45, 0),
    (0x0e74, 74, 46, 0), (0x0bfb, 75, 47, 0), (0x09f8, 77, 48, 0),
    (0x0861, 78, 49, 0), (0x0706, 79, 50, 0), (0x05cd, 48, 51, 0),
    (0x04de, 50, 52, 0), (0x040f, 50, 53, 0), (0x0363, 51, 54, 0),
    (0x02d4, 52, 55, 0), (0x025c, 53, 56, 0), (0x01f8, 54, 57, 0),
    (0x01a4, 55, 58, 0), (0x0160, 56, 59, 0), (0x0125, 57, 60, 0),
    (0x00f6, 58, 61, 0), (0x00cb, 59, 62, 0), (0x00ab, 61, 63, 0),
    (0x008f, 61, 32, 0), (0x5b12, 65, 65, 1), (0x4d04, 80, 66, 0),
    (0x412c, 81, 67, 0), (0x37d8, 82, 68, 0), (0x2fe8, 83, 69, 0),
    (0x293c, 84, 70, 0), (0x2379, 86, 71, 0), (0x1edf, 87, 72, 0),
    (0x1aa9, 87, 73, 0), (0x174e, 72, 74, 0), (0x1424, 72, 75, 0),
    (0x119c, 74, 76, 0), (0x0f6b, 74, 77, 0), (0x0d51, 75, 78, 0),
    (0x0bb6, 77, 79, 0), (0x0a40, 77, 48, 0), (0x5832, 80, 81, 1),
    (0x4d1c, 88, 82, 0), (0x438e, 89, 83, 0), (0x3bdd, 90, 84, 0),
    (0x34ee, 91, 85, 0), (0x2eae, 92, 86, 0), (0x299a, 93, 87, 0),
    (0x2516, 86, 71, 0), (0x5570, 88, 89, 1), (0x4ca9, 95, 90, 0),
    (0x44d9, 96, 91, 0), (0x3e22, 97, 92, 0), (0x3824, 99, 93, 0),
    (0x32b4, 99, 94, 0), (0x2e17, 93, 86, 0), (0x56a8, 95, 96, 1),
    (0x4f46, 101, 97, 0), (0x47e5, 102, 98, 0), (0x41cf, 103, 99, 0),
    (0x3c3d, 104, 100, 0), (0x375e, 99, 93, 0), (0x5231, 105, 102, 0),
    (0x4c0f, 106, 103, 0), (0x4639, 107, 104, 0), (0x415e, 103, 99, 0),
    (0x5627, 105, 106, 1), (0x50e7, 108, 107, 0), (0x4b85, 109, 103, 0),
    (0x5597, 110, 109, 0), (0x504f, 111, 107, 0), (0x5a10, 110, 111, 1),
    (0x5522, 112, 109, 0), (0x59eb, 112, 111, 1), (0x5a1d, 113, 113, 0))
FIXED = 113        # the state of a fixed probability 1/2
DC_BINS, AC_BINS = 64, 256


class _Overflow(Exception):
    """libjpeg's JWRN_ARITH_BAD_CODE: the rest of the scan decodes as
    zeros."""


class QMDecoder:
    """jdarith.c's arith_decode over one entropy-coded segment: states
    are ints (bit 7 the MPS, bits 0-6 the index into QE)."""

    def __init__(self, seg: bytes):
        self.d = seg
        self.i = 0
        self.c = self.a = 0
        self.ct = -16

    def decode(self, st: list, k: int) -> int:
        while self.a < 0x8000:
            self.ct -= 1
            if self.ct < 0:
                data = self.d[self.i] if self.i < len(self.d) else 0
                self.i += 1
                self.c = (self.c << 8) | data
                self.ct += 8
                if self.ct < 0:
                    self.ct += 1
                    if self.ct == 0:
                        self.a = 0x8000
            self.a <<= 1
        sv = st[k]
        qe, nlps, nmps, switch = QE[sv & 0x7F]
        temp = self.a - qe
        self.a = temp
        temp <<= self.ct
        if self.c >= temp:
            self.c -= temp
            if self.a < qe:
                self.a = qe
                st[k] = (sv & 0x80) ^ nmps
            else:
                self.a = qe
                st[k] = (sv & 0x80) ^ (nlps | switch << 7)
                sv ^= 0x80
        elif self.a < 0x8000:
            if self.a < qe:
                st[k] = (sv & 0x80) ^ (nlps | switch << 7)
                sv ^= 0x80
            else:
                st[k] = (sv & 0x80) ^ nmps
        return sv >> 7


def _magnitude(dec, st, k, base):
    """Figures F.23 and F.24 for an AC value: its magnitude less one, the
    category from bin k (twice) and on from `base` (X2 at 189 or 217), its
    bits 14 bins above the category's last bin."""
    m = dec.decode(st, k)
    if m and dec.decode(st, k):
        m <<= 1
        k = base
        while dec.decode(st, k):
            m <<= 1
            if m == 0x8000:
                raise _Overflow
            k += 1
    v = m
    k += 14
    m >>= 1
    while m:
        if dec.decode(st, k):
            v |= m
        m >>= 1
    return v


def _dc_diff(dec, st, ctx, lower, upper):
    """Figure F.19: one DC difference in context `ctx` (0, 4, 8, 12, 16)
    -> (difference, the next context)."""
    if dec.decode(st, ctx) == 0:
        return 0, 0
    sign = dec.decode(st, ctx + 1)
    k = ctx + 2 + sign
    m_first = dec.decode(st, k)
    m = m_first
    if m:
        k = 20
        while dec.decode(st, k):
            m <<= 1
            if m == 0x8000:
                raise _Overflow
            k += 1
    if m < (1 << lower) >> 1:
        nxt = 0
    elif m > (1 << upper) >> 1:
        nxt = 12 + 4 * sign
    else:
        nxt = 4 + 4 * sign
    v = m
    k += 14
    m >>= 1
    while m:
        if dec.decode(st, k):
            v |= m
        m >>= 1
    v += 1
    return (-v if sign else v), nxt


def _ac(dec, st, fixed, k, kx):
    """One nonzero AC value at index k (sign, category, bits) after its
    nonzero decision: Figures F.21-F.24."""
    sign = dec.decode(fixed, 0)
    v = _magnitude(dec, st, 3 * (k - 1) + 2, 189 if k <= kx else 217) + 1
    return -v if sign else v


def decode_arith_scan(data, pos, comps, scan, frame, restart, spectral,
                      progressive, cond):
    """Decode one arithmetic-coded scan into comps' coefficient arrays
    ([rows, cols, 64] int32, natural order). `spectral` is (Ss, Se, Ah,
    Al), `cond` the DAC values by (class << 4 | table). Returns the
    position of the next marker."""
    ss, se, ah, al = spectral
    if not progressive:
        ss, se, ah, al = 0, 63, 0, 0
    elif ss == 0 and se != 0 or ss > se or se > 63 or (ss and len(scan) > 1):
        raise ValueError(f"JPEG: bad progressive scan Ss {ss} Se {se}")
    segs, end = _segments(data, pos)
    rows, cols, units = _scan_units(comps, scan, frame)
    dc_tabs = [td for _, td, _ in scan]
    ac_tabs = [ta for _, _, ta in scan]
    n_mcu = rows * cols
    per = restart or n_mcu
    zz = ZIGZAG.tolist()
    p1, m1 = 1 << al, -1 << al
    mcu = 0
    for seg in segs:
        if mcu >= n_mcu:
            break
        dec = QMDecoder(seg)
        dc_st = {t: [0] * DC_BINS for t in set(dc_tabs)}
        ac_st = {t: [0] * AC_BINS for t in set(ac_tabs)}
        fixed = [FIXED]
        last = [0] * len(units)
        ctx = [0] * len(units)
        broken = False
        for _ in range(min(per, n_mcu - mcu)):
            my, mx = divmod(mcu, cols)
            mcu += 1
            if broken:
                continue
            try:
                for u, (c, hh, vv) in enumerate(units):
                    coef = c["coef"]
                    for by in range(vv):
                        for bx in range(hh):
                            blk = coef[my * vv + by, mx * hh + bx]
                            if ss == 0 and ah == 0:
                                t = dc_tabs[u]
                                lu = cond.get(t, 0x10)
                                diff, ctx[u] = _dc_diff(dec, dc_st[t], ctx[u],
                                                        lu & 15, lu >> 4)
                                last[u] = (last[u] + diff) & 0xFFFF
                                dc = last[u] - 0x10000 if last[u] & 0x8000 \
                                    else last[u]
                                blk[0] = dc * p1
                            elif ss == 0:
                                if dec.decode(fixed, 0):
                                    blk[0] |= p1
                            if se == 0:
                                continue
                            t = ac_tabs[u]
                            kx = cond.get(16 | t, 5)
                            if ah == 0:
                                _ac_first(dec, ac_st[t], fixed, blk,
                                          max(ss, 1), se, kx, zz, al)
                            else:
                                _ac_refine(dec, ac_st[t], fixed, blk, ss, se,
                                           zz, p1, m1)
            except _Overflow:
                broken = True
    if mcu < n_mcu:
        raise ValueError("JPEG: scan ends before its last MCU")
    return end


def _ac_first(dec, st, fixed, blk, k, se, kx, zz, al):
    """Figure F.20 (G.1.3.2 for a progressive first scan): the AC
    coefficients k..se of one block."""
    while k <= se:
        s = 3 * (k - 1)
        if dec.decode(st, s):               # end of block
            return
        while dec.decode(st, s + 1) == 0:
            s += 3
            k += 1
            if k > se:
                raise _Overflow
        blk[zz[k]] = _ac(dec, st, fixed, k, kx) * (1 << al)
        k += 1


def _ac_refine(dec, st, fixed, blk, ss, se, zz, p1, m1):
    """G.1.3.3: one block's AC refinement over ss..se (jdarith.c's
    decode_mcu_AC_refine)."""
    kex = se
    while kex > 0 and not blk[zz[kex]]:
        kex -= 1
    k = ss
    while k <= se:
        s = 3 * (k - 1)
        if k > kex and dec.decode(st, s):
            return
        while True:
            z = zz[k]
            if blk[z]:
                if dec.decode(st, s + 2):
                    blk[z] += m1 if blk[z] < 0 else p1
                break
            if dec.decode(st, s + 1):
                blk[z] = m1 if dec.decode(fixed, 0) else p1
                break
            s += 3
            k += 1
            if k > se:
                raise _Overflow
        k += 1
