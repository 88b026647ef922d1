"""A lossless arithmetic-coded JPEG (SOF11, ITU-T T.81 H.1.2.3) writer
and its mirror decoder, the lossless twin of the SOF9 writer
`make_image_fixtures.arith_jpeg`. Not part of the port: libjpeg-turbo
(cv2's and Pillow's) has a lossless Huffman coder only and reads nothing
of such a file, so the port raises IOError for it as ignis_tpu does;
scripts/make_named_fixtures.py writes the files that show it.

The model (T.81 H.1.2.3 on F.1.4.4.1): each difference from predictor
1-7 (as SOF3's) is coded in one of 25 conditions, the left and upper
neighbours' differences Da and Db each classed as zero, small or large
(by the DAC's bounds L and U, 0 and 1 by default) and signed. A
condition owns four bins (S0: zero or not; SS: the sign; SP and SN: the
magnitude's first decision); the magnitude's categories and bits go on
in bins 100-128 when Db is zero or small, 129-157 when it is large.
Statistics and the QM coder restart at each restart interval.

    python scripts/lossless_arith_encoder.py   # round trip and cv2
"""
from __future__ import annotations

import struct
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent))
from make_image_fixtures import QMEncoder, _segment  # noqa: E402

BINS = 158
X_SMALL, X_LARGE = 100, 129


def _classes(d, lower, upper):
    """T.81 F.1.4.4.1.3's class of a difference: 0 zero, 1 small
    positive, 2 small negative, 3 large positive, 4 large negative."""
    a = abs(d)
    if a <= (1 << lower) >> 1:
        return 0
    if a <= 1 << upper:
        return 1 if d > 0 else 2
    return 3 if d > 0 else 4


def _predict(p, y, x, first_row, predictor, init):
    if first_row:
        return init if x == 0 else p[y, x - 1]
    if x == 0:
        return p[y - 1, 0]
    ra, rb, rc = p[y, x - 1], p[y - 1, x], p[y - 1, x - 1]
    return {1: ra, 2: rb, 3: rc, 4: ra + rb - rc, 5: ra + ((rb - rc) >> 1),
            6: rb + ((ra - rc) >> 1), 7: (ra + rb) >> 1}[predictor]


def _context(diff, y, x, first_row, lower, upper):
    da = diff[y, x - 1] if x else 0
    db = 0 if first_row else diff[y - 1, x]
    cb = _classes(db, lower, upper)
    s0 = 4 * (5 * _classes(da, lower, upper) + cb)
    return s0, (X_LARGE if cb >= 3 else X_SMALL)


def _encode_diff(enc, st, v, s0, xbase):
    if v == 0:
        enc.encode(st, s0, 0)
        return
    enc.encode(st, s0, 1)
    sign = int(v < 0)
    enc.encode(st, s0 + 1, sign)
    m = abs(v) - 1
    k = s0 + 2 + sign
    top = 0
    if m:
        enc.encode(st, k, 1)
        top, k = 1, xbase
        while m >> top:
            enc.encode(st, k, 1)
            top += 1
            k += 1
    enc.encode(st, k, 0)
    k += 14
    for b in range(top - 2, -1, -1):
        enc.encode(st, k, (m >> b) & 1)


def _decode_diff(dec, st, s0, xbase):
    if not dec.decode(st, s0):
        return 0
    sign = dec.decode(st, s0 + 1)
    k = s0 + 2 + sign
    top = 0
    if dec.decode(st, k):
        top, k = 1, xbase
        while dec.decode(st, k):
            top += 1
            k += 1
    k += 14
    m = (1 << (top - 1)) if top else 0
    for b in range(top - 2, -1, -1):
        m |= dec.decode(st, k) << b
    return -(m + 1) if sign else m + 1


def sof11_jpeg(samples, predictor=1, pt=0, restart_rows=0, dac=None,
               ids=None) -> bytes:
    """A SOF11 file of uint8 [h, w, nc] samples (stored >> pt), 8-bit
    precision, in one interleaved scan (every component 1 x 1), DRI every
    `restart_rows` rows, `dac` the conditioning (L, U) of table 0."""
    h, w, nc = samples.shape
    ids = ids or list(range(1, nc + 1))
    lower, upper = dac or (0, 1)
    x = samples.astype(np.int64) >> pt
    out = b"\xff\xd8" + _segment(0xCB, struct.pack(">BHHB", 8, h, w, nc)
                                 + b"".join(bytes([ids[k], 0x11, 0])
                                            for k in range(nc)))
    if dac:
        out += _segment(0xCC, bytes([0, upper << 4 | lower]))
    if restart_rows:
        out += _segment(0xDD, struct.pack(">H", restart_rows * w))
    out += _segment(0xDA, bytes([nc]) + b"".join(
        bytes([ids[k], 0]) for k in range(nc)) + bytes([predictor, 0, pt]))
    diff = np.zeros((nc, h, w), np.int64)
    init = 1 << (7 - pt)
    rows = restart_rows or h
    for y0 in range(0, h, rows):
        if y0:
            out += bytes([0xFF, 0xD0 + (y0 // rows - 1) % 8])
        enc, st = QMEncoder(), [0] * BINS
        for y in range(y0, min(y0 + rows, h)):
            for xx in range(w):
                for k in range(nc):
                    p = x[..., k]
                    v = int((p[y, xx] - _predict(p, y, xx, y == y0,
                                                 predictor, init) + 32768)
                            % 65536 - 32768)
                    diff[k, y, xx] = v
                    s0, xb = _context(diff[k], y, xx, y == y0, lower, upper)
                    _encode_diff(enc, st, v, s0, xb)
        out += enc.finish()
    return out + b"\xff\xd9"


def decode_sof11(data: bytes) -> np.ndarray:
    """sof11_jpeg's files back to their stored samples [h, w, nc] (<< pt),
    the round trip that shows the writer codes what it means."""
    from ignis_tpu_torch.utils.jpeg_arith import QMDecoder
    pos, lower, upper, restart = 2, 0, 1, 0
    while True:
        m, n = data[pos + 1], struct.unpack(">H", data[pos + 2:pos + 4])[0]
        body = data[pos + 4:pos + 2 + n]
        if m == 0xCB:
            h, w, nc = struct.unpack(">HHB", body[1:6])
        elif m == 0xCC:
            lower, upper = body[1] & 15, body[1] >> 4
        elif m == 0xDD:
            restart = struct.unpack(">H", body)[0]
        pos += 2 + n
        if m == 0xDA:
            predictor, pt = body[-3], body[-1] & 15
            break
    rows = restart // w if restart else h
    x = np.zeros((nc, h, w), np.int64)
    diff = np.zeros((nc, h, w), np.int64)
    init = 1 << (7 - pt)
    for y0 in range(0, h, rows):
        end = data.find(b"\xff", pos)
        while data[end + 1] == 0:
            end = data.find(b"\xff", end + 2)
        seg = data[pos:end].replace(b"\xff\x00", b"\xff")
        dec, st = QMDecoder(seg), [0] * BINS
        for y in range(y0, min(y0 + rows, h)):
            for xx in range(w):
                for k in range(nc):
                    s0, xb = _context(diff[k], y, xx, y == y0, lower, upper)
                    v = _decode_diff(dec, st, s0, xb)
                    diff[k, y, xx] = v
                    pred = _predict(x[k], y, xx, y == y0, predictor, init)
                    x[k, y, xx] = (pred + v) & 0xFF >> pt
        pos = end + 2
    return (x.transpose(1, 2, 0) << pt).astype(np.uint8)


if __name__ == "__main__":
    import cv2
    r = np.random.default_rng(0)
    s = np.clip(np.cumsum(r.integers(-9, 10, (12, 17, 3)), 1) + 128, 0,
                255).astype(np.uint8)
    for pred in range(1, 8):
        f = sof11_jpeg(s, pred, pred % 2, 4 if pred > 4 else 0,
                       (1, 3) if pred == 3 else None)
        rt = bool((decode_sof11(f) == (s >> (pred % 2)) << (pred % 2)).all())
        print(pred, "round trip", rt, "cv2:",
              cv2.imdecode(np.frombuffer(f, np.uint8), cv2.IMREAD_UNCHANGED))
