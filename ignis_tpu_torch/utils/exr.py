"""OpenEXR scanline reader (NONE / RLE / ZIPS / ZIP / PIZ; half and float).

The port's own copy of ignis_tpu/utils/exr.py (numpy and zlib only, so it
runs where no OpenCV or PIL is installed): the scanline container and PIZ
(bitmap LUT, Huffman, 16-bit wavelet) from the public format spec.
`load_exr_rgb` returns the R, G, B channels (stored in the file in
alphabetical order, B, G, R) as a float32 [h, w, 3] image.
"""
from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

_PT_UINT = 0
_PT_HALF = 1
_PT_FLOAT = 2

_COMP_NONE = 0
_COMP_RLE = 1
_COMP_ZIPS = 2
_COMP_ZIP = 3
_COMP_PIZ = 4

_LINES_PER_BLOCK = {_COMP_NONE: 1, _COMP_RLE: 1, _COMP_ZIPS: 1,
                    _COMP_ZIP: 16, _COMP_PIZ: 32}


def read_exr(path):
    """Returns (channels_dict name->float32 [h,w], (w, h))."""
    data = Path(path).read_bytes()
    if struct.unpack("<I", data[:4])[0] != 20000630:
        raise ValueError(f"{path}: not an EXR file")
    version = struct.unpack("<I", data[4:8])[0]
    if version & 0x200:
        raise ValueError(f"{path}: tiled EXR not supported")
    pos = 8

    channels = []   # (name, pixel_type)
    compression = _COMP_NONE
    dw = None
    while True:
        e = data.index(b"\x00", pos)
        if e == pos:
            pos += 1
            break
        name = data[pos:e].decode()
        pos = e + 1
        e = data.index(b"\x00", pos)
        typ = data[pos:e].decode()
        pos = e + 1
        size = struct.unpack("<I", data[pos:pos + 4])[0]
        pos += 4
        val = data[pos:pos + size]
        pos += size
        if name == "channels" and typ == "chlist":
            i = 0
            while val[i] != 0:
                ce = val.index(b"\x00", i)
                cn = val[i:ce].decode()
                pt = struct.unpack("<i", val[ce + 1:ce + 5])[0]
                xs, ys = struct.unpack("<ii", val[ce + 9:ce + 17])
                if xs != 1 or ys != 1:
                    raise ValueError("subsampled channels not supported")
                channels.append((cn, pt))
                i = ce + 17
        elif name == "compression":
            compression = val[0]
        elif name == "dataWindow":
            dw = struct.unpack("<iiii", val)

    if dw is None:
        raise ValueError("missing dataWindow")
    w = dw[2] - dw[0] + 1
    h = dw[3] - dw[1] + 1
    if compression not in _LINES_PER_BLOCK:
        raise ValueError(f"compression {compression} not supported")
    lpb = _LINES_PER_BLOCK[compression]
    n_blocks = (h + lpb - 1) // lpb

    offsets = struct.unpack(f"<{n_blocks}Q", data[pos:pos + 8 * n_blocks])

    out = {cn: np.zeros((h, w), np.float32) for cn, _ in channels}
    bytes_per = {_PT_UINT: 4, _PT_HALF: 2, _PT_FLOAT: 4}

    for off in offsets:
        y0 = struct.unpack("<i", data[off:off + 4])[0] - dw[1]
        length = struct.unpack("<I", data[off + 4:off + 8])[0]
        payload = data[off + 8:off + 8 + length]
        ny = min(lpb, h - y0)
        raw_size = sum(bytes_per[pt] for _, pt in channels) * w * ny

        if compression == _COMP_PIZ:
            chans = _piz_decompress(payload, channels, w, ny)
            for (cn, pt), arr in zip(channels, chans):
                if pt == _PT_HALF:
                    out[cn][y0:y0 + ny] = arr.view(np.float16).astype(np.float32) \
                        if arr.dtype == np.uint16 else arr
                else:
                    out[cn][y0:y0 + ny] = arr
            continue

        if compression in (_COMP_ZIP, _COMP_ZIPS):
            if length < raw_size:
                raw = zlib.decompress(payload)
                raw = _unpredict(np.frombuffer(raw, np.uint8))
            else:
                raw = payload
        elif compression == _COMP_RLE:
            if length < raw_size:
                raw = _rle_decompress(payload)
                raw = _unpredict(np.frombuffer(raw, np.uint8))
            else:
                raw = payload
        else:
            raw = payload

        # Scanline layout: per line, per channel (alphabetical file order)
        p = 0
        for yy in range(ny):
            for cn, pt in channels:
                nb = bytes_per[pt] * w
                seg = raw[p:p + nb]
                p += nb
                if pt == _PT_HALF:
                    row = np.frombuffer(seg, np.float16).astype(np.float32)
                elif pt == _PT_FLOAT:
                    row = np.frombuffer(seg, np.float32)
                else:
                    row = np.frombuffer(seg, np.uint32).astype(np.float32)
                out[cn][y0 + yy] = row

    return out, (w, h)


def load_exr_rgb(path) -> np.ndarray:
    chans, (w, h) = read_exr(path)
    def pick(*names):
        for n in names:
            if n in chans:
                return chans[n]
        # try suffix match (layered EXRs like "Color.R")
        for key in chans:
            if key.split(".")[-1] in names:
                return chans[key]
        return None
    r = pick("R")
    g = pick("G")
    b = pick("B")
    if r is None:
        y = pick("Y")
        if y is None:
            raise ValueError(f"{path}: no RGB or Y channels")
        r = g = b = y
    if g is None:
        g = r
    if b is None:
        b = r
    return np.stack([r, g, b], axis=-1).astype(np.float32)


def _unpredict(d: np.ndarray) -> bytes:
    """EXR zip/rle post-filter: delta-predictor first, THEN de-interleave
    (OpenEXR ImfZip::uncompress order)."""
    delta = d.astype(np.int64)
    delta[1:] -= 128 + 256
    rec = (np.cumsum(delta, dtype=np.int64) & 0xFF).astype(np.uint8)
    n = rec.shape[0]
    half = (n + 1) // 2
    inter = np.empty(n, np.uint8)
    inter[0::2] = rec[:half]
    inter[1::2] = rec[half:]
    return inter.tobytes()


def _rle_decompress(src: bytes) -> bytes:
    out = bytearray()
    i = 0
    n = len(src)
    while i < n:
        cnt = struct.unpack("<b", src[i:i + 1])[0]
        i += 1
        if cnt < 0:
            out += src[i:i - cnt]
            i += -cnt
        else:
            out += src[i:i + 1] * (cnt + 1)
            i += 1
    return bytes(out)


# ---------------------------------------------------------------------------
# PIZ
# ---------------------------------------------------------------------------

_BITMAP_SIZE = 8192  # (1 << 16) / 8
_USHORT_RANGE = 1 << 16
_HUF_ENCBITS = 16
_HUF_DECBITS = 14
_HUF_ENCSIZE = (1 << _HUF_ENCBITS) + 1
_HUF_DECSIZE = 1 << _HUF_DECBITS
_HUF_DECMASK = _HUF_DECSIZE - 1


def _piz_decompress(src: bytes, channels, w, ny):
    pos = 0
    min_nz, max_nz = struct.unpack("<HH", src[pos:pos + 4])
    pos += 4
    bitmap = np.zeros(_BITMAP_SIZE, np.uint8)
    if min_nz <= max_nz:
        nb = max_nz - min_nz + 1
        bitmap[min_nz:max_nz + 1] = np.frombuffer(src[pos:pos + nb], np.uint8)
        pos += nb

    lut, max_value = _reverse_lut_from_bitmap(bitmap)

    (length,) = struct.unpack("<i", src[pos:pos + 4])
    pos += 4

    total = sum((2 if pt == _PT_HALF else 4) // 2 * w * ny
                for _, pt in channels)
    out_shorts = _huf_uncompress(src[pos:pos + length], total)

    # Per channel: contiguous [ny, w*size] shorts; size = shorts per pixel.
    # wav2Decode runs per interleaved slice j (ox = size), then the LUT.
    arrays = []
    p = 0
    chan_slices = []
    for cn, pt in channels:
        size = 1 if pt == _PT_HALF else 2
        n = w * size * ny
        cd = out_shorts[p:p + n].copy()
        p += n
        grid = cd.reshape(ny, w, size)
        for j in range(size):
            plane = np.ascontiguousarray(grid[:, :, j])
            _wav_2d_decode(plane, max_value)
            grid[:, :, j] = plane
        chan_slices.append((grid, pt, size))

    for grid, pt, size in chan_slices:
        np.take(lut, grid, out=grid)

    for grid, pt, size in chan_slices:
        if pt == _PT_HALF:
            arrays.append(grid.reshape(ny, w).view(np.float16)
                          .astype(np.float32))
        else:
            fr = grid.astype(np.uint32)
            bits = fr[..., 0] | (fr[..., 1] << 16)
            arrays.append(bits.view(np.float32))
    return arrays


def _reverse_lut_from_bitmap(bitmap):
    bits = np.unpackbits(bitmap[:, None], axis=1, bitorder="little").reshape(-1)
    idx = np.nonzero(bits)[0]
    if idx.shape[0] == 0 or idx[0] != 0:
        idx = np.concatenate([[0], idx])  # 0 always mapped
    lut = np.zeros(_USHORT_RANGE, np.uint16)
    lut[:idx.shape[0]] = idx.astype(np.uint16)
    max_value = idx.shape[0] - 1
    return lut, max_value


def _huf_uncompress(src: bytes, n_out):
    im, iM, _table_len, nbits, _ = struct.unpack("<iiiii", src[:20])
    pos = 20
    freq = np.zeros(_HUF_ENCSIZE, np.int64)

    # Unpack encoding table (code lengths, RLE for runs of zero)
    bitbuf = 0
    bitcnt = 0
    data = src
    dlen = len(src)

    def getbits(n, pos_ref):
        nonlocal bitbuf, bitcnt
        while bitcnt < n:
            bitbuf = (bitbuf << 8) | data[pos_ref[0]]
            pos_ref[0] += 1
            bitcnt += 8
        bitcnt -= n
        return (bitbuf >> bitcnt) & ((1 << n) - 1)

    pref = [pos]
    i = im
    while i <= iM:
        l = getbits(6, pref)
        freq[i] = l
        if l == 63:  # LONG_ZEROCODE_RUN
            run = getbits(8, pref) + 6
            freq[i:i + run] = 0
            i += run
        elif l >= 59:  # SHORT_ZEROCODE_RUN
            run = l - 59 + 2
            freq[i:i + run] = 0
            i += run
        else:
            i += 1

    # freq now holds code LENGTHS; build canonical codes
    codes = _huf_canonical_codes(freq)

    # Build decoding table
    pos = pref[0]
    n_bytes = (nbits + 7) // 8
    bits_data = np.frombuffer(data[pos:pos + n_bytes], np.uint8)

    return _huf_decode(codes, freq, im, iM, bits_data, nbits, n_out)


def _huf_canonical_codes(lens):
    """OpenEXR hufCanonicalCodeTable: returns code values per symbol."""
    n = np.zeros(59, np.int64)
    for l in lens[lens > 0]:
        n[l] += 1
    c = 0
    base = np.zeros(59, np.int64)
    for i in range(58, 0, -1):
        nc = (c + n[i]) >> 1
        base[i] = c
        c = nc
    # base[i] currently the starting code (to be assigned incrementally)
    codes = np.zeros(lens.shape[0], np.int64)
    counters = base.copy()
    nz = np.nonzero(lens)[0]
    for s in nz:
        l = lens[s]
        codes[s] = counters[l]
        counters[l] += 1
    return codes


def _huf_decode(codes, lens, im, iM, bits_data, nbits, n_out):
    """Bit-serial Huffman decode with the fast _HUF_DECBITS table."""
    # Build fast lookup: for codes with len <= DECBITS, fill table
    table_sym = np.full(_HUF_DECSIZE, -1, np.int64)
    table_len = np.zeros(_HUF_DECSIZE, np.int64)
    long_codes = {}
    nz = np.nonzero(lens)[0]
    for s in nz:
        l = int(lens[s])
        c = int(codes[s])
        if l <= _HUF_DECBITS:
            start = c << (_HUF_DECBITS - l)
            cnt = 1 << (_HUF_DECBITS - l)
            table_sym[start:start + cnt] = s
            table_len[start:start + cnt] = l
        else:
            long_codes[(c, l)] = s

    out = np.zeros(n_out, np.uint16)
    oi = 0
    buf = 0
    bc = 0
    rlc = iM  # run-length symbol
    bi = 0
    nbytes = bits_data.shape[0]
    bits_list = bits_data.tolist()
    table_sym_l = table_sym.tolist()
    table_len_l = table_len.tolist()

    while oi < n_out:
        # Refill
        while bc < 32 and bi < nbytes:
            buf = (buf << 8) | bits_list[bi]
            bi += 1
            bc += 8
        if bc == 0:
            break
        look = (buf >> (bc - _HUF_DECBITS)) & _HUF_DECMASK if bc >= _HUF_DECBITS \
            else (buf << (_HUF_DECBITS - bc)) & _HUF_DECMASK
        s = table_sym_l[look]
        if s >= 0 and table_len_l[look] <= bc:
            l = table_len_l[look]
            bc -= l
        else:
            # slow path: long code
            s = None
            for l in range(_HUF_DECBITS + 1, 59):
                if bc < l:
                    break
                c = (buf >> (bc - l)) & ((1 << l) - 1)
                if (c, l) in long_codes:
                    s = long_codes[(c, l)]
                    bc -= l
                    break
            if s is None:
                break
        if s == rlc:
            # run-length: next 8 bits = count, repeat previous value
            while bc < 8 and bi < nbytes:
                buf = (buf << 8) | bits_list[bi]
                bi += 1
                bc += 8
            run = (buf >> (bc - 8)) & 0xFF
            bc -= 8
            prev = out[oi - 1] if oi > 0 else 0
            out[oi:oi + run] = prev
            oi += run
        else:
            out[oi] = s
            oi += 1
    return out


def _wdec14(l, h):
    """Vectorized OpenEXR wdec14 on uint16 arrays."""
    ls = l.astype(np.int16).astype(np.int32)
    hs = h.astype(np.int16).astype(np.int32)
    ai = ls + (hs & 1) + (hs >> 1)
    a = ai.astype(np.int16).astype(np.uint16)
    b = (ai - hs).astype(np.int16).astype(np.uint16)
    return a, b


def _wdec16(l, h):
    """Vectorized OpenEXR wdec16 (mod-2^16 arithmetic)."""
    m = l.astype(np.int32)
    d = h.astype(np.int32)
    bb = (m - (d >> 1)) & 0xFFFF
    aa = (d + bb - 32768) & 0xFFFF
    return aa.astype(np.uint16), bb.astype(np.uint16)


def _wav_2d_decode(a, mx):
    """OpenEXR wav2Decode on a 2D uint16 array [ny, nx] (in place),
    vectorized across wavelet blocks per level."""
    wdec = _wdec14 if mx < (1 << 14) else _wdec16
    ny, nx = a.shape
    n = min(nx, ny)
    p = 1
    while p <= n:
        p <<= 1
    p >>= 1
    p2 = p
    p >>= 1

    while p >= 1:
        # Block origins: y <= ny - p2, x <= nx - p2, strides p2 (= 2p)
        ys = np.arange(0, ny - p2 + 1, p2)
        xs = np.arange(0, nx - p2 + 1, p2)
        if ys.size > 0 and xs.size > 0:
            Y, X = np.meshgrid(ys, xs, indexing="ij")
            v00 = a[Y, X]
            v10 = a[Y + p, X]
            v01 = a[Y, X + p]
            v11 = a[Y + p, X + p]
            i00, i10 = wdec(v00, v10)
            i01, i11 = wdec(v01, v11)
            r00, r01 = wdec(i00, i01)
            r10, r11 = wdec(i10, i11)
            a[Y, X] = r00
            a[Y, X + p] = r01
            a[Y + p, X] = r10
            a[Y + p, X + p] = r11
        # Odd column (nx & p): vertical 1D pairs at x_odd for each block row
        if (nx & p) and ys.size > 0:
            x_odd = xs[-1] + p2 if xs.size > 0 else 0
            if x_odd < nx:
                c0 = a[ys, x_odd]
                c1 = a[ys + p, x_odd]
                r0, r1 = wdec(c0, c1)
                a[ys, x_odd] = r0
                a[ys + p, x_odd] = r1
        # Odd line (ny & p): horizontal 1D pairs at y_odd
        if (ny & p) and xs.size > 0:
            y_odd = ys[-1] + p2 if ys.size > 0 else 0
            if y_odd < ny:
                r0, r1 = wdec(a[y_odd, xs], a[y_odd, xs + p])
                a[y_odd, xs] = r0
                a[y_odd, xs + p] = r1
        p2 = p
        p >>= 1
