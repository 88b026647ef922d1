"""JPEG in numpy: a decoder that follows libjpeg's integer pipeline, and
a baseline 4:2:0 encoder.

The decoder reads baseline, extended sequential and progressive Huffman
JPEGs (SOF0, SOF1, SOF2) with 8-bit samples, one or three components, any
sampling factors, interleaved or single-component scans and restart
markers; a progressive file's scans (spectral selection and successive
approximation, DC and AC, first and refinement) accumulate its
coefficients as libjpeg's jdphuff.c does before the one inverse DCT. To
land where
libjpeg(-turbo), which OpenCV reads through, lands, each step is libjpeg's:
Huffman decoding and dequantisation, the `jidctint` integer inverse DCT
(CONST_BITS 13, PASS1_BITS 2), the "fancy" triangular h2v1, h1v2 and h2v2
chroma upsampling of `jdsample` (the edge samples replicated), and the
integer YCbCr->RGB tables of `jdcolor`. Arithmetic-coded sequential and
progressive files (SOF9, SOF10) decode through utils/jpeg_arith.py into
the same coefficients; lossless ones (SOF3, 8 bits: the seven
predictors, point transform, restarts) as libjpeg-turbo's jdlossls.c,
their three components untransformed. Three components are YCbCr or,
as libjpeg guesses (no JFIF marker and Adobe transform 0, or component
ids 'R', 'G', 'B'), untransformed RGB; four components (Adobe transform
0, or no Adobe marker) are Adobe's inverted CMYK, converted to RGB as
OpenCV converts libjpeg's CMYK (R = K - (255 - C) * K / 256, truncated,
and likewise), and YCCK (transform 2) is libjpeg's YCbCr to inverted
CMYK first. What libjpeg-turbo reads nothing of for OpenCV (12- and
16-bit frames, hierarchical ones, lossless YCbCr, and lossless
arithmetic-coded frames, SOF11, as it has no lossless arithmetic
decoder) raises IOError.

The encoder writes baseline JFIF at 4:2:0 (colour) with the Annex K
quantisation tables scaled to a quality as libjpeg scales them (95 by
default, cv2's default) and the Annex K Huffman tables.
"""
from __future__ import annotations

import struct

import numpy as np

ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])

# ---------------------------------------------------------------------------
# decoding
# ---------------------------------------------------------------------------


def _huffman_table(counts, symbols):
    """A 65536-entry lookup of a 16-bit peek: (symbol << 8) | code length
    (0 where no code starts)."""
    lut = np.zeros(1 << 16, np.int32)
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            lo = code << (16 - length)
            lut[lo:lo + (1 << (16 - length))] = (symbols[k] << 8) | length
            code += 1
            k += 1
        code <<= 1
    return lut.tolist()


class _Bits:
    """MSB-first bit reader over one entropy-coded segment (byte stuffing
    removed); reads past the end return zeros."""

    def __init__(self, data: bytes):
        self.d = data + b"\0\0\0\0"
        self.pos = 0

    def peek16(self) -> int:
        i, r = self.pos >> 3, self.pos & 7
        d = self.d
        return ((d[i] << 16 | d[i + 1] << 8 | d[i + 2]) >> (8 - r)) & 0xFFFF

    def decode(self, lut) -> int:
        e = lut[self.peek16()]
        if not e & 0xFF:
            raise ValueError("JPEG: bad Huffman code")
        self.pos += e & 0xFF
        return e >> 8

    def bits(self, n: int) -> int:
        """n (0-16) bits as an unsigned value."""
        if n == 0:
            return 0
        v = self.peek16() >> (16 - n)
        self.pos += n
        return v

    def receive_extend(self, s: int) -> int:
        """s magnitude bits as a signed value (F.2.2.1's EXTEND)."""
        if s == 0:
            return 0
        v = self.peek16() >> (16 - s)
        self.pos += s
        return v if v >= 1 << (s - 1) else v - (1 << s) + 1


def _segments(data: bytes, pos: int):
    """The entropy-coded data from pos: a list of segments split at RSTn
    markers with byte stuffing removed, and the position of the marker
    that ends the scan."""
    segs, cur, n = [], bytearray(), len(data)
    while True:
        j = data.find(b"\xff", pos)
        if j < 0 or j + 1 >= n:
            raise ValueError("JPEG: scan runs past the end of the file")
        cur += data[pos:j]
        m = data[j + 1]
        if m == 0x00:
            cur.append(0xFF)
            pos = j + 2
        elif 0xD0 <= m <= 0xD7:
            segs.append(bytes(cur))
            cur = bytearray()
            pos = j + 2
        elif m == 0xFF:
            pos = j + 1       # fill bytes
        else:
            segs.append(bytes(cur))
            return segs, j


def _decode_scan(data, pos, comps, scan, frame, dc_luts, ac_luts,
                 restart):
    """Decode one sequential Huffman scan into comps' coefficient arrays
    ([rows, cols, 64] int32, natural order, not dequantised); returns the
    position of the next marker."""
    segs, end = _segments(data, pos)
    rows, cols, units = _scan_units(comps, scan, frame)
    luts = [(dc_luts[td], ac_luts[ta]) for _, td, ta in scan]
    n_mcu = rows * cols
    per = restart or n_mcu
    zz = ZIGZAG.tolist()
    mcu = 0
    for seg in segs:
        if mcu >= n_mcu:
            break
        bits = _Bits(seg)
        pred = [0] * len(units)
        for _ in range(min(per, n_mcu - mcu)):
            my, mx = divmod(mcu, cols)
            for u, ((c, hh, vv), (dcl, acl)) in enumerate(zip(units, luts)):
                coef = c["coef"]
                for by in range(vv):
                    for bx in range(hh):
                        blk = coef[my * vv + by, mx * hh + bx]
                        s = bits.decode(dcl)
                        pred[u] += bits.receive_extend(s)
                        blk[0] = pred[u]
                        k = 1
                        while k < 64:
                            rs = bits.decode(acl)
                            r, s = rs >> 4, rs & 15
                            if s == 0:
                                if r != 15:
                                    break
                                k += 16
                                continue
                            k += r
                            if k > 63:
                                raise ValueError("JPEG: AC index past 63")
                            blk[zz[k]] = bits.receive_extend(s)
                            k += 1
            mcu += 1
    if mcu < n_mcu:
        raise ValueError("JPEG: scan ends before its last MCU")
    return end


def _decode_lossless_scan(data, pos, comps, scan, frame, dc_luts, restart,
                          spectral):
    """Decode one lossless Huffman scan (T.81 H.1, as libjpeg-turbo's
    jdlhuff.c and jdpred.c) into comps' sample planes: each sample's
    difference (DC-style categories; 16 is 32768 with no bits) added to
    the prediction of its predictor Ss (1 Ra, 2 Rb, 3 Rc, 4 Ra + Rb - Rc,
    5 Ra + (Rb - Rc) / 2, 6 Rb + (Ra - Rc) / 2, 7 (Ra + Rb) / 2) modulo
    2^16. The first row of the scan and of each restart interval (a whole
    number of MCU rows, as libjpeg-turbo requires) predicts from the left,
    its first sample from 2^(P - Pt - 1); a row's first sample from above.
    The result is shifted up by the point transform Pt (Al)."""
    predictor, _, _, pt = spectral
    if not 1 <= predictor <= 7:
        raise IOError(f"JPEG: lossless predictor {predictor}")
    segs, end = _segments(data, pos)
    if len(scan) == 1:
        c = comps[scan[0][0]]
        rows, cols, units = c["brows"], c["bcols"], [(c, 1, 1)]
    else:
        rows = -(-frame["height"] // frame["vmax"])
        cols = -(-frame["width"] // frame["hmax"])
        units = [(comps[ci], comps[ci]["h"], comps[ci]["v"])
                 for ci, _, _ in scan]
    if restart and restart % cols:
        raise IOError("JPEG: OpenCV reads no lossless file whose restart "
                      "interval is no whole number of MCU rows")
    luts = [dc_luts[td] for _, td, _ in scan]
    n_mcu = rows * cols
    per = restart or n_mcu
    diffs = [np.zeros((rows * vv, cols * hh), np.int64) for _, hh, vv in units]
    mcu = 0
    for seg in segs:
        if mcu >= n_mcu:
            break
        bits = _Bits(seg)
        for _ in range(min(per, n_mcu - mcu)):
            my, mx = divmod(mcu, cols)
            for u, (_, hh, vv) in enumerate(units):
                for by in range(vv):
                    for bx in range(hh):
                        s = bits.decode(luts[u])
                        diffs[u][my * vv + by, mx * hh + bx] = (
                            32768 if s == 16 else bits.receive_extend(s))
            mcu += 1
    if mcu < n_mcu:
        raise ValueError("JPEG: scan ends before its last MCU")
    first_rows = set(range(0, rows, (restart or n_mcu) // cols or rows))
    for (c, hh, vv), diff in zip(units, diffs):
        out = c["coef"]
        for y in range(diff.shape[0]):
            d = diff[y]
            if y // vv in first_rows and y % vv == 0:
                row = np.cumsum(d) + (1 << (7 - pt))
            else:
                row = _undifference(d, out[y - 1].astype(np.int64),
                                    predictor)
            out[y, :len(d)] = row & 0xFFFF
    for c, _, _ in units:
        c["coef"] = (c["coef"] << pt) & 0xFF
    return end


def _undifference(d, above, predictor):
    """One row of lossless samples (before the modulo) from its
    differences and the row above, under predictor 1-7."""
    if predictor == 2:
        return above + d
    out = np.empty_like(d)
    out[0] = above[0] + d[0]
    if predictor == 1:
        return np.cumsum(np.concatenate([out[:1], d[1:]]))
    if predictor == 3:
        out[1:] = above[:-1] + d[1:]
        return out
    if predictor in (4, 5):
        step = above[1:] - above[:-1]
        if predictor == 5:
            step = step >> 1
        return np.cumsum(np.concatenate([out[:1], step + d[1:]]))
    ra = int(out[0]) & 0xFFFF
    for x in range(1, len(d)):
        rb, rc = int(above[x]), int(above[x - 1])
        pred = rb + ((ra - rc) >> 1) if predictor == 6 else (ra + rb) >> 1
        ra = (pred + int(d[x])) & 0xFFFF
        out[x] = ra
    return out


def _scan_units(comps, scan, frame):
    """The scan's blocks as MCU rows x cols and, per component, (comp, h,
    v): a single-component scan takes the component's own blocks, one an
    MCU; an interleaved one whole MCUs."""
    if len(scan) == 1:
        c = comps[scan[0][0]]
        return c["brows"], c["bcols"], [(c, 1, 1)]
    rows = -(-frame["height"] // (8 * frame["vmax"]))
    cols = -(-frame["width"] // (8 * frame["hmax"]))
    return rows, cols, [(comps[ci], comps[ci]["h"], comps[ci]["v"])
                        for ci, _, _ in scan]


def _decode_progressive_scan(data, pos, comps, scan, frame, dc_luts,
                             ac_luts, restart, spectral):
    """Decode one progressive Huffman scan (T.81 G.1.2, as libjpeg's
    jdphuff.c) into comps' coefficient arrays, which accumulate over the
    scans: a DC first scan (the difference shifted up by Al), a DC
    refinement (one bit a block), an AC first scan over Ss..Se (end-of-band
    runs) or an AC refinement (correction bits on the nonzero
    coefficients, new coefficients of +-2^Al). `spectral` is (Ss, Se, Ah,
    Al). Returns the position of the next marker."""
    ss, se, ah, al = spectral
    if ss == 0 and se != 0 or ss > se or se > 63 or (ss and len(scan) > 1):
        raise ValueError(f"JPEG: bad progressive scan Ss {ss} Se {se}")
    segs, end = _segments(data, pos)
    rows, cols, units = _scan_units(comps, scan, frame)
    luts = [(dc_luts.get(td), ac_luts.get(ta)) for _, td, ta in scan]
    n_mcu = rows * cols
    per = restart or n_mcu
    zz = ZIGZAG.tolist()
    p1, m1 = 1 << al, -1 << al
    mcu = 0
    for seg in segs:
        if mcu >= n_mcu:
            break
        bits = _Bits(seg)
        pred = [0] * len(units)
        eobrun = 0
        for _ in range(min(per, n_mcu - mcu)):
            my, mx = divmod(mcu, cols)
            for u, ((c, hh, vv), (dcl, acl)) in enumerate(zip(units, luts)):
                coef = c["coef"]
                for by in range(vv):
                    for bx in range(hh):
                        blk = coef[my * vv + by, mx * hh + bx]
                        if ss == 0:
                            if ah == 0:
                                pred[u] += bits.receive_extend(
                                    bits.decode(dcl))
                                blk[0] = pred[u] * p1
                            elif bits.bits(1):
                                blk[0] |= p1
                            continue
                        if ah == 0:
                            if eobrun:
                                eobrun -= 1
                                continue
                            k = ss
                            while k <= se:
                                rs = bits.decode(acl)
                                r, s = rs >> 4, rs & 15
                                if s:
                                    k += r
                                    if k > 63:
                                        raise ValueError(
                                            "JPEG: AC index past 63")
                                    blk[zz[k]] = bits.receive_extend(s) * p1
                                elif r == 15:
                                    k += 15
                                else:
                                    eobrun = (1 << r) + bits.bits(r) - 1
                                    break
                                k += 1
                            continue
                        eobrun = _refine_ac(bits, acl, blk, ss, se, zz, p1,
                                            m1, eobrun)
            mcu += 1
    if mcu < n_mcu:
        raise ValueError("JPEG: scan ends before its last MCU")
    return end


def _refine_ac(bits, acl, blk, k, se, zz, p1, m1, eobrun) -> int:
    """One block of an AC refinement scan over k..se (jdphuff.c's
    decode_mcu_AC_refine); returns the end-of-band run left."""
    def correct(z):
        v = int(blk[z])
        if bits.bits(1) and (v & p1) == 0:
            blk[z] = v + (p1 if v >= 0 else m1)

    if eobrun == 0:
        while k <= se:
            rs = bits.decode(acl)
            r, s = rs >> 4, rs & 15
            if s:
                if s != 1:
                    raise ValueError("JPEG: refinement coefficient of size "
                                     f"{s}")
                s = p1 if bits.bits(1) else m1
            elif r != 15:
                eobrun = (1 << r) + bits.bits(r)
                break
            # pass the nonzero coefficients (a correction bit each) and r
            # zero ones
            while k <= se:
                z = zz[k]
                if blk[z]:
                    correct(z)
                else:
                    r -= 1
                    if r < 0:
                        break
                k += 1
            if s:
                if k > 63:
                    raise ValueError("JPEG: AC index past 63")
                blk[zz[k]] = s
            k += 1
    if eobrun > 0:
        while k <= se:
            z = zz[k]
            if blk[z]:
                correct(z)
            k += 1
        eobrun -= 1
    return eobrun


# jidctint.c's fixed-point constants, FIX(x) = round(x * 2^13)
_C = {k: int(round(v * 8192)) for k, v in {
    "0_298631336": 0.298631336, "0_390180644": 0.390180644,
    "0_541196100": 0.541196100, "0_765366865": 0.765366865,
    "0_899976223": 0.899976223, "1_175875602": 1.175875602,
    "1_501321110": 1.501321110, "1_847759065": 1.847759065,
    "1_961570560": 1.961570560, "2_053119869": 2.053119869,
    "2_562915447": 2.562915447, "3_072711026": 3.072711026}.items()}


def _idct_1d(x0, x1, x2, x3, x4, x5, x6, x7):
    """One pass of jidctint's butterfly on int64 arrays; returns the eight
    outputs before the final descale."""
    z1 = (x2 + x6) * _C["0_541196100"]
    tmp2 = z1 - x6 * _C["1_847759065"]
    tmp3 = z1 + x2 * _C["0_765366865"]
    tmp0 = (x0 + x4) << 13
    tmp1 = (x0 - x4) << 13
    t10, t13 = tmp0 + tmp3, tmp0 - tmp3
    t11, t12 = tmp1 + tmp2, tmp1 - tmp2
    a0, a1, a2, a3 = x7, x5, x3, x1
    z1, z2, z3, z4 = a0 + a3, a1 + a2, a0 + a2, a1 + a3
    z5 = (z3 + z4) * _C["1_175875602"]
    a0 = a0 * _C["0_298631336"]
    a1 = a1 * _C["2_053119869"]
    a2 = a2 * _C["3_072711026"]
    a3 = a3 * _C["1_501321110"]
    z1 = z1 * -_C["0_899976223"]
    z2 = z2 * -_C["2_562915447"]
    z3 = z3 * -_C["1_961570560"] + z5
    z4 = z4 * -_C["0_390180644"] + z5
    a0 = a0 + z1 + z3
    a1 = a1 + z2 + z4
    a2 = a2 + z2 + z3
    a3 = a3 + z1 + z4
    return (t10 + a3, t11 + a2, t12 + a1, t13 + a0,
            t13 - a0, t12 - a1, t11 - a2, t10 - a3)


def idct_islow(coef: np.ndarray, quant: np.ndarray) -> np.ndarray:
    """jidctint.c's jpeg_idct_islow on [..., 64] coefficients (natural
    order) and a [64] quantisation table: [..., 8, 8] uint8 samples."""
    c = (coef.astype(np.int64) * quant.astype(np.int64)).reshape(
        coef.shape[:-1] + (8, 8))
    # pass 1: columns, output scaled up by 2^PASS1_BITS
    cols = _idct_1d(*[c[..., k, :] for k in range(8)])
    ws = np.stack([(v + (1 << 10)) >> 11 for v in cols], -2)
    # pass 2: rows
    rows = _idct_1d(*[ws[..., :, k] for k in range(8)])
    out = np.stack([((v + (1 << 17)) >> 18) + 128 for v in rows], -1)
    return np.clip(out, 0, 255).astype(np.uint8)


def _fancy_h2(p: np.ndarray) -> np.ndarray:
    """jdsample's h2v1_fancy_upsample on [..., w] int32 (w > 2)."""
    left = np.concatenate([p[..., :1], p[..., :-1]], -1)
    right = np.concatenate([p[..., 1:], p[..., -1:]], -1)
    out = np.empty(p.shape[:-1] + (2 * p.shape[-1],), np.int32)
    out[..., 0::2] = (3 * p + left + 1) >> 2
    out[..., 1::2] = (3 * p + right + 2) >> 2
    out[..., 0] = p[..., 0]
    out[..., -1] = p[..., -1]
    return out


def _colsums(p: np.ndarray):
    """h2v2/h1v2's vertical sums: 3 * this row + the nearer row above
    (for the upper output row) and below (the lower), rows replicated at
    the edges: ([h, w] each)."""
    up = np.concatenate([p[:1], p[:-1]], 0)
    down = np.concatenate([p[1:], p[-1:]], 0)
    return 3 * p + up, 3 * p + down


def _fancy_h2v2(p: np.ndarray) -> np.ndarray:
    """jdsample's h2v2_fancy_upsample on [h, w] int32 (w > 2)."""
    h, w = p.shape
    out = np.empty((2 * h, 2 * w), np.int32)
    for r, cs in enumerate(_colsums(p)):
        left = np.concatenate([cs[:, :1], cs[:, :-1]], 1)
        right = np.concatenate([cs[:, 1:], cs[:, -1:]], 1)
        row = out[r::2]
        row[:, 0::2] = (3 * cs + left + 8) >> 4
        row[:, 1::2] = (3 * cs + right + 7) >> 4
        row[:, 0] = (4 * cs[:, 0] + 8) >> 4
        row[:, -1] = (4 * cs[:, -1] + 7) >> 4
    return out


def _fancy_h1v2(p: np.ndarray) -> np.ndarray:
    """jdsample's h1v2_fancy_upsample on [h, w] int32."""
    out = np.empty((2 * p.shape[0], p.shape[1]), np.int32)
    up, down = _colsums(p)
    out[0::2] = (up + 1) >> 2
    out[1::2] = (down + 2) >> 2
    return out


def _upsample(p: np.ndarray, fh: int, fv: int) -> np.ndarray:
    """A component plane [h, w] (its downsampled size) upsampled by
    (fh, fv) as libjpeg does with fancy upsampling on."""
    p = p.astype(np.int32)
    w = p.shape[1]
    if (fh, fv) == (2, 1) and w > 2:
        return _fancy_h2(p)
    if (fh, fv) == (2, 2) and w > 2:
        return _fancy_h2v2(p)
    if (fh, fv) == (1, 2):
        return _fancy_h1v2(p)
    return np.repeat(np.repeat(p, fv, 0), fh, 1)


def _ycc_to_rgb(y, cb, cr) -> np.ndarray:
    """jdcolor.c's ycc_rgb_convert (SCALEBITS 16) on int32 planes."""
    one_half = 1 << 15
    fix = lambda x: int(x * 65536 + 0.5)   # noqa: E731
    cb = cb - 128
    cr = cr - 128
    r = y + ((fix(1.40200) * cr + one_half) >> 16)
    b = y + ((fix(1.77200) * cb + one_half) >> 16)
    g = y + ((-fix(0.34414) * cb - fix(0.71414) * cr + one_half) >> 16)
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


def frame_components(data: bytes):
    """The number of components of a JPEG's first frame header, or None
    where no frame header is found."""
    pos = 2
    while pos + 4 <= len(data) and data[pos] == 0xFF:
        m = data[pos + 1]
        if m == 0xFF:
            pos += 1
            continue
        length = struct.unpack(">H", data[pos + 2:pos + 4])[0]
        if m in (0xC0, 0xC1, 0xC2) or 0xC3 <= m <= 0xCF and m not in (
                0xC4, 0xC8, 0xCC):
            return data[pos + 9] if pos + 9 < len(data) else None
        if m == 0xDA:
            return None
        pos += 2 + length
    return None


def decode_jpeg(data: bytes, colour: str | None = None) -> np.ndarray:
    """A JPEG as uint8 [h, w, 3] RGB (grey replicated, CMYK converted).
    Three components are YCbCr or RGB as libjpeg guesses, or as `colour`
    says ('ycc' or 'rgb': a TIFF's photometric interpretation)."""
    return _reconstruct(parse_jpeg(data), colour)


def parse_jpeg(data: bytes) -> dict:
    """A JPEG's markers and entropy-coded scans, decoded: 'comps' (id ->
    component: sampling, table, 'coef' [rows, cols, 64] quantised
    coefficients in natural order, or a lossless file's [rows, cols]
    samples), 'frame', 'quant', 'lossless', 'adobe', 'jfif'."""
    if data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG file (no SOI marker)")
    pos, n = 2, len(data)
    quant, dc_luts, ac_luts = {}, {}, {}
    frame, comps, restart, adobe, scanned = None, None, 0, None, False
    progressive = arith = lossless = jfif = False
    cond = {}                  # DAC: table class and number -> value
    while True:
        if pos + 1 >= n:
            if scanned:           # no EOI marker after the last scan
                break
            raise ValueError("JPEG: truncated file")
        if data[pos] != 0xFF:
            raise ValueError(f"JPEG: expected a marker at byte {pos}")
        m = data[pos + 1]
        pos += 2
        if m == 0xFF:
            pos -= 1
            continue
        if m == 0xD9:
            break
        if pos + 2 > n:
            raise ValueError("JPEG: truncated segment")
        length = struct.unpack(">H", data[pos:pos + 2])[0]
        body = data[pos + 2:pos + length]
        if len(body) != length - 2:
            raise ValueError("JPEG: truncated segment")
        pos += length
        if m == 0xDB:                          # DQT
            i = 0
            while i < len(body):
                pq, tq = body[i] >> 4, body[i] & 15
                if pq:
                    t = np.frombuffer(body, ">u2", 64, i + 1)
                    i += 129
                else:
                    t = np.frombuffer(body, np.uint8, 64, i + 1)
                    i += 65
                q = np.zeros(64, np.int32)
                q[ZIGZAG] = t
                quant[tq] = q
        elif m == 0xC4:                        # DHT
            i = 0
            while i < len(body):
                tc, th = body[i] >> 4, body[i] & 15
                counts = list(body[i + 1:i + 17])
                syms = list(body[i + 17:i + 17 + sum(counts)])
                (ac_luts if tc else dc_luts)[th] = _huffman_table(counts,
                                                                  syms)
                i += 17 + sum(counts)
        elif m == 0xDD:                        # DRI
            restart = struct.unpack(">H", body[:2])[0]
        elif m == 0xEE and body[:5] == b"Adobe":
            adobe = body[11] if len(body) > 11 else None
        elif m == 0xE0 and body[:5] == b"JFIF\0":
            jfif = True
        elif m in (0xC0, 0xC1, 0xC2, 0xC3, 0xC9, 0xCA):
            # baseline, extended, progressive and lossless Huffman;
            # extended and progressive arithmetic
            progressive = m in (0xC2, 0xCA)
            arith, lossless = m in (0xC9, 0xCA), m == 0xC3
            prec, h, w, nc = struct.unpack(">BHHB", body[:6])
            if prec != 8:
                # libjpeg(-turbo) reads these only through its 12- and
                # 16-bit interfaces, which OpenCV does not call
                raise IOError(f"JPEG: OpenCV reads no {prec}-bit "
                              f"{'lossless' if lossless else 'DCT'} file")
            if nc not in (1, 3, 4) or h == 0:
                raise IOError(f"JPEG: OpenCV reads no file of {nc} "
                              "components (or of a DNL height)")
            comps = {}
            for k in range(nc):
                cid, hv, tq = body[6 + 3 * k:9 + 3 * k]
                comps[cid] = {"h": hv >> 4, "v": hv & 15, "tq": tq,
                              "order": k}
            hmax = max(c["h"] for c in comps.values())
            vmax = max(c["v"] for c in comps.values())
            unit = 1 if lossless else 8      # a data unit's side
            mrows, mcols = -(-h // (unit * vmax)), -(-w // (unit * hmax))
            for c in comps.values():
                c["width"] = -(-w * c["h"] // hmax)
                c["height"] = -(-h * c["v"] // vmax)
                c["bcols"] = -(-c["width"] // unit)
                c["brows"] = -(-c["height"] // unit)
                c["coef"] = np.zeros((mrows * c["v"], mcols * c["h"])
                                     + (() if lossless else (64,)),
                                     np.int32)
            frame = {"width": w, "height": h, "hmax": hmax, "vmax": vmax}
        elif m == 0xCB:
            raise IOError("JPEG: OpenCV reads no lossless arithmetic-coded "
                          "file (SOF11): libjpeg-turbo decodes none")
        elif 0xC5 <= m <= 0xCF and m not in (0xC8, 0xCC):
            raise IOError(f"JPEG: OpenCV reads no hierarchical file "
                          f"(SOF{m - 0xC0})")
        elif m == 0xCC:                        # DAC
            for i in range(0, len(body) - 1, 2):
                cond[body[i]] = body[i + 1]
        elif m == 0xDA:                        # SOS
            if frame is None:
                raise ValueError("JPEG: scan before the frame header")
            ns = body[0]
            scan = [(body[1 + 2 * k], body[2 + 2 * k] >> 4,
                     body[2 + 2 * k] & 15) for k in range(ns)]
            spectral = (body[1 + 2 * ns], body[2 + 2 * ns],
                        body[3 + 2 * ns] >> 4, body[3 + 2 * ns] & 15)
            if lossless:
                pos = _decode_lossless_scan(data, pos, comps, scan, frame,
                                            dc_luts, restart, spectral)
            elif arith:
                from .jpeg_arith import decode_arith_scan
                pos = decode_arith_scan(data, pos, comps, scan, frame,
                                        restart, spectral, progressive,
                                        cond)
            elif progressive:
                pos = _decode_progressive_scan(
                    data, pos, comps, scan, frame, dc_luts, ac_luts,
                    restart, (body[1 + 2 * ns], body[2 + 2 * ns],
                              body[3 + 2 * ns] >> 4, body[3 + 2 * ns] & 15))
            else:
                pos = _decode_scan(data, pos, comps, scan, frame, dc_luts,
                                   ac_luts, restart)
            scanned = True
    if frame is None:
        raise ValueError("JPEG: no frame header")
    return {"comps": comps, "frame": frame, "quant": quant,
            "lossless": lossless, "adobe": adobe, "jfif": jfif}


def _reconstruct(j: dict, colour) -> np.ndarray:
    """uint8 [h, w, 3] RGB of parse_jpeg's result, libjpeg's way: the
    inverse DCT, upsampling and colour conversion."""
    comps, frame, quant = j["comps"], j["frame"], j["quant"]
    lossless, adobe, jfif = j["lossless"], j["adobe"], j["jfif"]
    planes = []
    for c in sorted(comps.values(), key=lambda c: c["order"]):
        if lossless:
            plane = c["coef"][:c["height"], :c["width"]]
        else:
            if c["tq"] not in quant:
                raise ValueError("JPEG: missing quantisation table")
            blocks = idct_islow(c["coef"], quant[c["tq"]])
            r, cc = blocks.shape[:2]
            plane = blocks.transpose(0, 2, 1, 3).reshape(8 * r, 8 * cc)
            plane = plane[:c["height"], :c["width"]]
        up = _upsample(plane, frame["hmax"] // c["h"],
                       frame["vmax"] // c["v"])
        planes.append(up[:frame["height"], :frame["width"]])
    if len(planes) == 1:
        return np.repeat(planes[0].astype(np.uint8)[..., None], 3, -1)
    if len(planes) == 4:
        if adobe == 2:                  # YCCK: libjpeg's YCC to inverted
            planes[:3] = [255 - p.astype(np.int32) for p in np.moveaxis(
                _ycc_to_rgb(*planes[:3]), -1, 0)]
        k = planes[3]
        return np.stack([k - (((255 - c) * k) >> 8) for c in planes[:3]],
                        -1).astype(np.uint8)
    ids = tuple(cid for cid, _ in sorted(comps.items(),
                                         key=lambda kv: kv[1]["order"]))
    if lossless and (jfif or adobe):
        # libjpeg-turbo converts no lossless YCbCr
        raise IOError("JPEG: OpenCV reads no lossless YCbCr file")
    rgb = lossless or not jfif and (adobe == 0 or adobe is None
                                    and ids == (82, 71, 66))
    if colour == "rgb" or rgb and colour != "ycc":
        return np.stack(planes, -1).astype(np.uint8)
    return _ycc_to_rgb(*planes)


# ---------------------------------------------------------------------------
# encoding
# ---------------------------------------------------------------------------

# ITU-T T.81 Annex K: K.1 and K.2 quantisation tables (natural order)
_Q_LUMA = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
_Q_CHROMA = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99]
    + [99] * 32)
# K.3-K.6: the typical Huffman tables (code counts by length, symbols)
_DC_LUMA = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], list(range(12)))
_DC_CHROMA = ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0],
              list(range(12)))
_AC_LUMA = ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D], bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
    "2433627282090a161718191a25262728292a3435363738393a434445464748494a"
    "535455565758595a636465666768696a737475767778797a838485868788898a"
    "92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6"
    "c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa"))
_AC_CHROMA = ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77],
              bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0"
    "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
    "494a535455565758595a636465666768696a737475767778797a828384858687"
    "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
    "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa"))


def quality_table(base: np.ndarray, quality: int) -> np.ndarray:
    """jcparam.c's jpeg_quality_scaling and jpeg_add_quant_table
    (force_baseline): an Annex K table at `quality` (1-100)."""
    quality = min(max(int(quality), 1), 100)
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return np.clip((base * scale + 50) // 100, 1, 255).astype(np.int32)


def _codes(counts, symbols):
    """symbol -> (code, length) of a canonical Huffman table."""
    out, code, k = {}, 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            out[symbols[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return out


def _fdct(blocks: np.ndarray) -> np.ndarray:
    """The orthonormal-scaled 8x8 forward DCT of T.81 A.3.3 on [..., 8, 8]
    float64 (level-shifted samples)."""
    k = np.arange(8)
    basis = np.cos((2 * k[None, :] + 1) * k[:, None] * np.pi / 16)
    basis *= np.where(k == 0, np.sqrt(1 / 8), np.sqrt(2 / 8))[:, None]
    return basis @ blocks @ basis.T


def _blocks(plane: np.ndarray, rows: int, cols: int) -> np.ndarray:
    """[rows*8, cols*8] plane (edge-replicated to size) as [rows, cols, 8,
    8] blocks."""
    h, w = plane.shape
    p = np.pad(plane, ((0, 8 * rows - h), (0, 8 * cols - w)), mode="edge")
    return p.reshape(rows, 8, cols, 8).transpose(0, 2, 1, 3)


def encode_jpeg(rgb: np.ndarray, quality: int = 95) -> bytes:
    """Baseline JFIF of uint8 [h, w, 3] RGB at 4:2:0 (or [h, w] gray),
    Annex K tables scaled to `quality`."""
    rgb = np.asarray(rgb, np.uint8)
    gray = rgb.ndim == 2
    h, w = rgb.shape[:2]
    if h == 0 or w == 0 or h > 65535 or w > 65535:
        raise ValueError(f"JPEG: cannot encode a {w}x{h} image")
    qs = [quality_table(_Q_LUMA, quality), quality_table(_Q_CHROMA, quality)]
    x = rgb.astype(np.float64)
    if gray:
        planes = [x]
        samp = [(1, 1)]
    else:
        r, g, b = x[..., 0], x[..., 1], x[..., 2]
        y = 0.299 * r + 0.587 * g + 0.114 * b
        cb = -0.168736 * r - 0.331264 * g + 0.5 * b + 128
        cr = 0.5 * r - 0.418688 * g - 0.081312 * b + 128
        ph, pw = -(-h // 2) * 2, -(-w // 2) * 2

        def down(p):
            p = np.pad(p, ((0, ph - h), (0, pw - w)), mode="edge")
            return p.reshape(ph // 2, 2, pw // 2, 2).mean((1, 3))
        planes = [y, down(cb), down(cr)]
        samp = [(2, 2), (1, 1), (1, 1)]
    hmax = max(s[0] for s in samp)
    vmax = max(s[1] for s in samp)
    mrows, mcols = -(-h // (8 * vmax)), -(-w // (8 * hmax))
    coefs = []
    for k, (p, (sh, sv)) in enumerate(zip(planes, samp)):
        blk = _blocks(p - 128.0, mrows * sv, mcols * sh)
        q = qs[min(k, 1)].reshape(8, 8)
        c = np.round(_fdct(blk) / q).astype(np.int32)
        coefs.append(c.reshape(c.shape[:2] + (64,))[..., ZIGZAG])
    dc = [_codes(*_DC_LUMA), _codes(*_DC_CHROMA)]
    ac = [_codes(*_AC_LUMA), _codes(*_AC_CHROMA)]
    out = bytearray()
    acc, nacc = 0, 0

    def put(code, length):
        nonlocal acc, nacc
        acc = (acc << length) | code
        nacc += length
        while nacc >= 8:
            nacc -= 8
            byte = (acc >> nacc) & 0xFF
            out.append(byte)
            if byte == 0xFF:
                out.append(0)
        acc &= (1 << nacc) - 1

    def magnitude(v):
        s = int(abs(v)).bit_length()
        return s, (v if v >= 0 else v + (1 << s) - 1)

    pred = [0] * len(planes)
    for my in range(mrows):
        for mx in range(mcols):
            for k, (sh, sv) in enumerate(samp):
                t = min(k, 1)
                for by in range(sv):
                    for bx in range(sh):
                        zz = coefs[k][my * sv + by, mx * sh + bx].tolist()
                        s, bits = magnitude(zz[0] - pred[k])
                        pred[k] = zz[0]
                        put(*dc[t][s])
                        if s:
                            put(bits, s)
                        run = 0
                        for v in zz[1:]:
                            if v == 0:
                                run += 1
                                continue
                            while run > 15:
                                put(*ac[t][0xF0])
                                run -= 16
                            s, bits = magnitude(v)
                            put(*ac[t][(run << 4) | s])
                            put(bits, s)
                            run = 0
                        if run:
                            put(*ac[t][0x00])
    if nacc:
        put((1 << (8 - nacc)) - 1, 8 - nacc)

    def seg(marker, body):
        return bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body
    head = b"\xff\xd8" + seg(0xE0, b"JFIF\0\x01\x01\x00\x00\x01\x00\x01\0\0")
    for t, q in enumerate(qs[:1 if gray else 2]):
        head += seg(0xDB, bytes([t]) + bytes(q[ZIGZAG].tolist()))
    sof = struct.pack(">BHHB", 8, h, w, len(planes))
    for k, (sh, sv) in enumerate(samp):
        sof += bytes([k + 1, (sh << 4) | sv, min(k, 1)])
    head += seg(0xC0, sof)
    tables = [(0x00, _DC_LUMA), (0x10, _AC_LUMA)]
    if not gray:
        tables += [(0x01, _DC_CHROMA), (0x11, _AC_CHROMA)]
    for tc, (counts, syms) in tables:
        head += seg(0xC4, bytes([tc] + counts) + bytes(syms))
    sos = bytes([len(planes)])
    for k in range(len(planes)):
        sos += bytes([k + 1, (min(k, 1) << 4) | min(k, 1)])
    head += seg(0xDA, sos + b"\x00\x3f\x00")
    return head + bytes(out) + b"\xff\xd9"
