"""A ThunderScan (TIFF compression 32809) encoder for 4-bit palette
images: the inverse of libtiff's tif_thunder.c decoder, which OpenCV's
libtiff reads and nothing here writes (libtiff has no ThunderScan
encoder). Not part of the port: scripts/make_named_fixtures.py writes
the fixtures with it, and scripts/torch_image_fuzz.py draws random
files.

Each row starts from pixel value 0 and is a string of one-byte codes,
two bits of kind over six of data:
- 0x00 | n: a run, n (0-63) more pixels of the last value;
- 0x40 | a b c: three 2-bit deltas from the last value (0, +1, -1;
  2 skips the slot);
- 0x80 | a b: two 3-bit deltas (0, 1, 2, 3, -3, -2, -1; 4 skips);
- 0xC0 | v: the raw value v (its low four bits).
Deltas are taken modulo 16, as libtiff masks the sum to four bits.

    python scripts/thunderscan_encoder.py   # round trip through cv2
"""
from __future__ import annotations

import numpy as np

D2 = {0: 0, 1: 1, 15: 3}                  # delta modulo 16 -> 2-bit code
D3 = {0: 0, 1: 1, 2: 2, 3: 3, 13: 5, 14: 6, 15: 7}
SKIP2, SKIP3 = 2, 4


def _fits(row, i, last, table, slots):
    """How many pixels from i the delta table codes in a row."""
    k = 0
    while k < slots and i + k < len(row) and \
            (int(row[i + k]) - last) & 15 in table:
        last = int(row[i + k])
        k += 1
    return k


def _deltas(row, i, last, table, slots, k, bits, skip, rng):
    """The code of k deltas from pixel i in `slots` slots, the unused
    slots skipped (placed at random with `rng`, else last)."""
    where = sorted(rng.choice(slots, k, replace=False)) if rng is not None \
        else list(range(k))
    fields, j = [], 0
    for s in range(slots):
        if j < k and s == where[j]:
            v = int(row[i + j])
            fields.append(table[(v - last) & 15])
            last = v
            j += 1
        else:
            fields.append(skip)
    code = 0
    for f in fields:
        code = (code << bits) | f
    return code, last


def encode_row(row, rng=None) -> bytes:
    """The codes of one row of 4-bit values: runs where two or more
    pixels repeat the last value, else three 2-bit deltas, two 3-bit
    deltas, fewer of either, or a raw value, in that order; with `rng`
    each code's kind and length drawn among those that fit (and raw
    values with random high data bits), so every code and skip occurs."""
    out = bytearray()
    last, i, w = 0, 0, len(row)
    while i < w:
        run = 0
        while i + run < w and run < 63 and int(row[i + run]) == last:
            run += 1
        k2 = _fits(row, i, last, D2, 3)
        k3 = _fits(row, i, last, D3, 2)
        opts = []
        if run:
            opts.append(("run", run))
        if k2:
            opts.append(("d2", k2))
        if k3:
            opts.append(("d3", k3))
        opts.append(("raw", 1))
        if rng is None:
            kind, k = next(o for o in opts if o[0] != "run" or o[1] >= 2)
        else:
            kind, k = opts[rng.integers(len(opts))]
            k = int(rng.integers(1, k + 1))
        if kind == "run":
            out.append(k)
        elif kind == "d2":
            code, last = _deltas(row, i, last, D2, 3, k, 2, SKIP2, rng)
            out.append(0x40 | code)
        elif kind == "d3":
            code, last = _deltas(row, i, last, D3, 2, k, 3, SKIP3, rng)
            out.append(0x80 | code)
        else:
            last = int(row[i])
            high = 0 if rng is None else int(rng.integers(4)) << 4
            out.append(0xC0 | high | last)
        i += k
    return bytes(out)


def encode(values, rng=None) -> bytes:
    """A strip of [rows, w] (or [rows, w, 1]) 4-bit values."""
    v = np.asarray(values)
    if v.ndim == 3:
        v = v[..., 0]
    return b"".join(encode_row(r, rng) for r in v)


def thunder_tiff(index, cmap, rows_per_strip=None, rng=None) -> bytes:
    """A ThunderScan TIFF of [h, w] palette indices (0-15) and a colour
    map [16, 3] of 16-bit colours, in strips of `rows_per_strip`."""
    import make_image_fixtures as M
    idx = np.asarray(index, np.uint8)[..., None]
    return M.tiff_file(idx, comp=32809, photo=3, cmap=np.asarray(cmap),
                       bits=4, rows_per_strip=rows_per_strip,
                       encode=lambda c: encode(c, rng))


if __name__ == "__main__":
    import sys
    from pathlib import Path

    import cv2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    r = np.random.default_rng(0)
    idx = r.integers(0, 16, (9, 37))
    cm = r.integers(0, 65536, (16, 3))
    data = thunder_tiff(idx, cm, 4, r)
    got = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED)
    want = (cm >> 8).astype(np.uint8)[idx][..., ::-1]
    print("cv2 reads the round trip:", bool((got == want).all()))
