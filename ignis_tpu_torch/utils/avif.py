"""AVIF read as OpenCV reads it: the HEIF container (ISO BMFF, MIAF), the
AV1 image item decoded by utils/av1.py, and libavif's YUV to RGB
conversion as libavif 1.4.2 makes it for cv2.imread (utils/yuv.py).

What is read: `ftyp` brands `avif` and `avis`; `meta` with `hdlr`, `pitm`,
`iloc` (versions 0-2, construction methods 0 and 1, several extents),
`iinf`/`infe`, `iref`, `grpl` and `idat`; the item properties `av1C` and
`colr` (nclx; an ICC profile is passed over, as cv2 ignores it) through
`ipma`, and `auxC` of the items that refer to the primary one; an image
sequence's `moov` (`trak`, `tref` auxl, `stsd` av01 with av1C and colr,
`stsz`, `stco`/`co64`). As libavif picks its source: an `avis` major
brand is read by its colour track's first sample (an alpha track
ignored), an `avif` one by its primary item, never an alpha (`auxl`)
item; a gain-mapped file (`tmap`) by its base image. As cv2 does, `irot`,
`imir` and `clap` are not applied, alpha is dropped and a monochrome
image is its Y plane as it is. 8-bit files come back as uint8, 10- and
12-bit files as uint16 at their own range (0-1023, 0-4095), as cv2
returns them.

Every colour matrix libavif converts for cv2 is read (utils/yuv.py:
BT.709, BT.601, FCC, SMPTE 240, YCgCo, BT.2020, chroma-derived from the
primaries, the identity, and the matrices without a table of their own);
the colour description is the nclx box's, else the AV1 sequence
header's. A grid primary item (`grid`: its ImageGrid in `idat` or
`mdat`, 16- or 32-bit sizes, `dimg` tiles) is its tiles' planes laid out
and cut to the grid's size before the colour conversion, as libavif does.
A file cv2 reads nothing from raises IOError: a damaged one, a grey
image with an alpha item (cv2 refuses two channels), a colour matrix
libavif converts nothing of, a `tmap` or `iovl` primary item, iloc
construction method 2 or field sizes other than 0, 4 and 8, an `avif`
brand without `meta` or an `avis` one without `moov`, and item data that
cv2's signature check (libavif parsing the first SIGNATURE bytes) reads
past them (`_signature_reads`).
"""
from __future__ import annotations

import struct

import numpy as np


class _Box:
    __slots__ = ("type", "end", "body")

    def __init__(self, type_, end, body):
        self.type, self.end, self.body = type_, end, body


def _boxes(data: bytes, start: int, end: int):
    pos = start
    while pos + 8 <= end:
        size, kind = struct.unpack_from(">I4s", data, pos)
        head = 8
        if size == 1:
            size = struct.unpack_from(">Q", data, pos + 8)[0]
            head = 16
        elif size == 0:
            size = end - pos
        if size < head or pos + size > end:
            raise IOError("AVIF: truncated box")
        yield _Box(kind.decode("latin-1"), pos + size, pos + head)
        pos += size


def _children(data, box, skip=0):
    return list(_boxes(data, box.body + skip, box.end))


def _uint(data, pos, n):
    return int.from_bytes(data[pos:pos + n], "big") if n else 0


def _parse_iloc(data, box):
    version = data[box.body]
    p = box.body + 4
    sizes = data[p] << 8 | data[p + 1]
    off_size, len_size = sizes >> 12, (sizes >> 8) & 15
    base_size, idx_size = (sizes >> 4) & 15, sizes & 15
    if version < 1:
        idx_size = 0
    if {off_size, len_size, base_size, idx_size} - {0, 4, 8}:
        raise IOError("AVIF: an iloc field size other than 0, 4 or 8, "
                      "which libavif refuses")
    p += 2
    if version < 2:
        count = _uint(data, p, 2)
        p += 2
    else:
        count = _uint(data, p, 4)
        p += 4
    items = {}
    for _ in range(count):
        n = 2 if version < 2 else 4
        item = _uint(data, p, n)
        p += n
        method = 0
        if version in (1, 2):
            method = _uint(data, p, 2) & 15
            p += 2
        p += 2                                  # data_reference_index
        base = _uint(data, p, base_size)
        p += base_size
        extents = []
        n_ext = _uint(data, p, 2)
        p += 2
        for _ in range(n_ext):
            if version in (1, 2) and idx_size:
                p += idx_size
            off = _uint(data, p, off_size)
            p += off_size
            length = _uint(data, p, len_size)
            p += len_size
            extents.append((base + off, length))
        if method not in (0, 1):
            raise IOError(f"AVIF: iloc construction method {method}, "
                          "which libavif refuses")
        items[item] = (method, extents)
    return items


def _parse_meta(data, meta):
    out = {"items": {}, "props": [], "assoc": {}, "refs": [], "pitm": None,
           "idat": b"", "iloc": {}, "groups": []}
    for box in _children(data, meta, 4):
        b = box.body
        if box.type == "pitm":
            out["pitm"] = _uint(data, b + 4, 2 if data[b] == 0 else 4)
        elif box.type == "iloc":
            out["iloc"] = _parse_iloc(data, box)
        elif box.type == "idat":
            out["idat"] = data[b:box.end]
        elif box.type == "iinf":
            n = 2 if data[b] == 0 else 4
            for infe in _boxes(data, b + 4 + n, box.end):
                v, q = data[infe.body], infe.body + 4
                if v < 2:
                    continue
                m = 2 if v == 2 else 4
                item = _uint(data, q, m)
                kind = data[q + m + 2:q + m + 6].decode("latin-1")
                out["items"][item] = kind
        elif box.type == "iref":
            n = 2 if data[b] == 0 else 4
            for ref in _boxes(data, b + 4, box.end):
                q = ref.body
                frm = _uint(data, q, n)
                cnt = _uint(data, q + n, 2)
                to = [_uint(data, q + n + 2 + k * n, n) for k in range(cnt)]
                out["refs"].append((ref.type, frm, to))
        elif box.type == "grpl":
            for g in _children(data, box):
                n = _uint(data, g.body + 8, 4)
                out["groups"].append((g.type, [
                    _uint(data, g.body + 12 + 4 * k, 4) for k in range(n)]))
        elif box.type == "iprp":
            for sub in _children(data, box):
                if sub.type == "ipco":
                    out["props"] = _children(data, sub)
                elif sub.type == "ipma":
                    v, flags = data[sub.body], _uint(data, sub.body + 1, 3)
                    count = _uint(data, sub.body + 4, 4)
                    q = sub.body + 8
                    for _ in range(count):
                        n = 2 if v < 1 else 4
                        item = _uint(data, q, n)
                        q += n
                        if out["assoc"] and item <= max(out["assoc"]):
                            raise IOError("AVIF: ipma item IDs do not rise "
                                          "(libavif refuses the file)")
                        cnt = data[q]
                        q += 1
                        idx = []
                        for _ in range(cnt):
                            if flags & 1:
                                idx.append(_uint(data, q, 2) & 0x7fff)
                                q += 2
                            else:
                                idx.append(data[q] & 0x7f)
                                q += 1
                        out["assoc"][item] = idx
    return out


def _item_data(data, meta, item):
    if item not in meta["iloc"]:
        raise IOError(f"AVIF: item {item} has no location")
    method, extents = meta["iloc"][item]
    src = data if method == 0 else meta["idat"]
    parts = []
    for off, length in extents:
        if length == 0:
            length = len(src) - off
        if off + length > len(src):
            raise IOError("AVIF: item data past the end of the file")
        parts.append(src[off:off + length])
    return b"".join(parts)


def _is_alpha(data, meta, item):
    """Whether an auxiliary item's auxC names an alpha plane."""
    for idx in meta["assoc"].get(item, []):
        if 1 <= idx <= len(meta["props"]):
            prop = meta["props"][idx - 1]
            if prop.type == "auxC":
                urn = data[prop.body + 4:prop.end].split(b"\0")[0]
                return urn in (b"urn:mpeg:mpegB:cicp:systems:auxiliary:alpha",
                               b"urn:mpeg:hevc:2015:auxid:1")
    return False


def _av1_item(data, m, item) -> bytes:
    """An av01 item's data behind its av1C configuration OBUs."""
    av1 = _item_data(data, m, item)
    for idx in m["assoc"].get(item, []):
        if 1 <= idx <= len(m["props"]):
            prop = m["props"][idx - 1]
            if prop.type == "av1C":
                av1 = data[prop.body + 4:prop.end] + av1
    return av1


def _nclx(data, m, item):
    """An item's colr nclx as (primaries, transfer, matrix, full range),
    or None."""
    for idx in m["assoc"].get(item, []):
        if 1 <= idx <= len(m["props"]):
            prop = m["props"][idx - 1]
            b = prop.body
            if prop.type == "colr" and data[b:b + 4] == b"nclx":
                cp, tc, mc = struct.unpack_from(">HHH", data, b + 4)
                return cp, tc, mc, data[b + 10] >> 7
    return None


def _image_grid(body: bytes):
    """HEIF's ImageGrid: (rows, columns, output width, output height),
    its sizes 16-bit, or 32-bit under flags bit 0."""
    if len(body) < 8 or body[0] != 0:
        raise IOError("AVIF: bad ImageGrid")
    fmt = ">II" if body[1] & 1 else ">HH"
    if len(body) < 4 + struct.calcsize(fmt):
        raise IOError("AVIF: truncated ImageGrid")
    return (body[2] + 1, body[3] + 1) + struct.unpack_from(fmt, body, 4)


def _find(data, box, kind, skip=0):
    return next((b for b in _children(data, box, skip) if b.type == kind),
                None)


def _tracks(data, moov):
    """The `av01` tracks of an image sequence, in file order: {'id',
    'handler', 'auxl' (the tracks an auxl tref names), 'av1C' (the
    sample entry's configuration OBUs), 'nclx', 'first' (the first
    sample's bytes)}."""
    out = []
    for trak in _children(data, moov):
        if trak.type != "trak":
            continue
        tkhd, mdia = _find(data, trak, "tkhd"), _find(data, trak, "mdia")
        if tkhd is None or mdia is None:
            continue
        tid = _uint(data, tkhd.body + (20 if data[tkhd.body] == 1 else 12),
                    4)
        auxl = []
        tref = _find(data, trak, "tref")
        if tref is not None:
            for ref in _children(data, tref):
                if ref.type == "auxl":
                    auxl += [_uint(data, q, 4) for q in range(
                        ref.body, ref.end - 3, 4)]
        hdlr = _find(data, mdia, "hdlr")
        minf = _find(data, mdia, "minf")
        stbl = minf and _find(data, minf, "stbl")
        if hdlr is None or stbl is None:
            continue
        tables = {b.type: b for b in _children(data, stbl)}
        stsd = tables.get("stsd")
        entry = stsd and next(iter(_boxes(data, stsd.body + 8, stsd.end)),
                              None)
        if entry is None or entry.type != "av01":
            continue
        t = {"id": tid, "auxl": auxl, "av1C": b"", "nclx": None,
             "handler": data[hdlr.body + 8:hdlr.body + 12].decode(
                 "latin-1")}
        for prop in _boxes(data, entry.body + 78, entry.end):
            if prop.type == "av1C":
                t["av1C"] = data[prop.body + 4:prop.end]
            elif prop.type == "colr" and \
                    data[prop.body:prop.body + 4] == b"nclx":
                cp, tc, mc = struct.unpack_from(">HHH", data, prop.body + 4)
                t["nclx"] = (cp, tc, mc, data[prop.body + 10] >> 7)
        t["first"] = _first_sample(data, tables)
        out.append(t)
    return out


def _first_sample(data, tables) -> bytes:
    """The first sample's bytes, by stsz and the first chunk's offset
    (stco or co64)."""
    stsz = tables.get("stsz")
    chunks = tables.get("stco") or tables.get("co64")
    if stsz is None or chunks is None or \
            _uint(data, chunks.body + 4, 4) == 0 or \
            _uint(data, stsz.body + 8, 4) == 0:
        raise IOError("AVIF: an image sequence without samples")
    size = _uint(data, stsz.body + 4, 4) or _uint(data, stsz.body + 12, 4)
    n = 8 if chunks.type == "co64" else 4
    off = _uint(data, chunks.body + 8, n)
    if off + size > len(data):
        raise IOError("AVIF: a sample past the end of the file")
    return data[off:off + size]


# cv2 takes a file for AVIF only where libavif parses its first bytes
# (avifDecoderParse of this many, OK or truncated: grfmt_avif.cpp)
SIGNATURE = 500


def _signature_reads(data, top, m, items):
    """cv2's signature check: libavif reads the data of `items` (the
    primary grid's ImageGrid; with the `tmap` brand, the tone map
    metadata) while it parses the file's first SIGNATURE bytes, and
    fails where such data starts past them in a box that starts at or
    before their end; a read otherwise waits for more data (truncated
    data, which cv2 accepts)."""
    for item in items:
        method, extents = m["iloc"].get(item, (0, []))
        if method != 0 or not extents:
            continue
        off = extents[0][0]
        box = next((b for b in top if b.body - 8 <= off < b.end), None)
        if box is not None and box.body - 8 <= SIGNATURE < off:
            raise IOError("AVIF: item data that cv2's signature check "
                          f"reads past its first {SIGNATURE} bytes")


def parse_avif(data: bytes) -> dict:
    """The AV1 data (its av1C configuration OBUs first) of the image
    libavif decodes for cv2, and its properties: {'av1': bytes, 'nclx':
    (primaries, transfer, matrix, full range) or None, 'alpha': whether
    an alpha item or track refers to it}; of a grid primary item 'grid'
    (rows, columns, output width and height) and 'tiles', each tile's AV1
    data, in its `dimg` order, for 'av1'. libavif's source: an `avis`
    major brand reads the sequence's colour track (its first sample), an
    `avif` one the primary item, any other the track where there is
    one."""
    top = list(_boxes(data, 0, len(data)))
    if not top or top[0].type != "ftyp":
        raise IOError("AVIF: no ftyp box")
    f = top[0]
    major = data[f.body:f.body + 4]
    brands = {major} | {data[q:q + 4] for q in range(f.body + 8, f.end - 3,
                                                      4)}
    meta = next((b for b in top if b.type == "meta"), None)
    moov = next((b for b in top if b.type == "moov"), None)
    if b"avif" in brands and meta is None or \
            b"avis" in brands and moov is None:
        raise IOError("AVIF: an 'avif' brand without meta or an 'avis' "
                      "brand without moov, which libavif refuses")
    out = {"nclx": None, "alpha": False}
    m = _parse_meta(data, meta) if meta is not None else None
    if m is not None:
        grid = [m["pitm"]] if m["items"].get(m["pitm"]) == "grid" else []
        # the gain map libavif parses: a tmap in an altr group with the
        # primary item, under the tmap brand
        tmaps = [i for i, k in m["items"].items() if k == "tmap" and any(
            kind == "altr" and i in ids and m["pitm"] in ids
            for kind, ids in m["groups"])] if b"tmap" in brands else []
        _signature_reads(data, top, m, grid + tmaps)
    tracks = _tracks(data, moov) if moov is not None else []
    colour = next((t for t in tracks if not t["auxl"]), None)
    if major == b"avis" and colour is None:
        raise IOError("AVIF: an 'avis' file without a colour track")
    if colour is not None and major != b"avif":
        out["av1"] = colour["av1C"] + colour["first"]
        out["nclx"] = colour["nclx"]
        out["alpha"] = any(colour["id"] in t["auxl"] for t in tracks)
        return out
    if m is None:
        raise IOError("AVIF: no primary image item or colour track")
    item = m["pitm"]
    kind = m["items"].get(item)
    if kind in ("av01", "grid"):
        out["alpha"] = any(ref == "auxl" and item in to and
                           _is_alpha(data, m, frm)
                           for ref, frm, to in m["refs"])
        out["nclx"] = _nclx(data, m, item)
    if kind == "av01":
        out["av1"] = _av1_item(data, m, item)
        return out
    if kind == "grid":
        out["grid"] = _image_grid(_item_data(data, m, item))
        tiles = next((to for ref, frm, to in m["refs"]
                      if ref == "dimg" and frm == item), [])
        rows, cols = out["grid"][:2]
        if len(tiles) != rows * cols or any(
                m["items"].get(t) != "av01" for t in tiles):
            raise IOError(f"AVIF: a {rows} x {cols} grid of "
                          f"{len(tiles)} tiles, or tiles not AV1")
        out["tiles"] = [_av1_item(data, m, t) for t in tiles]
        if out["nclx"] is None:
            out["nclx"] = _nclx(data, m, tiles[0])
        return out
    raise IOError(f"AVIF: primary item of type '{kind}', which libavif "
                  "decodes no colour image from")


def decode_avif(data: bytes, name: str = "") -> np.ndarray:
    """The primary image as cv2.imread(IMREAD_UNCHANGED | ANYDEPTH |
    ANYCOLOR) gives it, as [h, w, 3] RGB (grey replicated, alpha
    dropped): uint8 for 8-bit files, uint16 at the file's own range
    for 10- and 12-bit ones."""
    return decode_avif_depth(data, name)[0]


def decode_avif_depth(data: bytes, name: str = ""):
    """(decode_avif's samples, the image's bit depth)."""
    from .av1 import decode_av1
    info = parse_avif(data)
    frame = (_grid_frame(info, name) if "grid" in info
             else decode_av1(info["av1"], name))
    nclx = info["nclx"]
    if nclx is None:
        nclx = (frame.color_primaries, frame.transfer, frame.matrix,
                frame.full_range)
    if frame.mono:
        if info["alpha"]:
            # cv2 would read two channels, and reads nothing
            raise IOError(f"Cannot load image {name}: a grey AVIF with "
                          "alpha, which OpenCV does not read")
        y = frame.planes[0]
        out = y.astype(np.uint8 if frame.bit_depth == 8 else np.uint16)
        return np.repeat(out[..., None], 3, -1), frame.bit_depth
    from .yuv import yuv_to_rgb
    return yuv_to_rgb(frame.planes, frame.bit_depth, frame.ss_x,
                      frame.ss_y, nclx[2], nclx[3], nclx[0]), frame.bit_depth


def _grid_frame(info, name):
    """The decoded frame of a grid: its tiles decoded and their planes
    laid side by side, row by row, then cut to the output size, as
    libavif lays them out before it converts the whole to RGB. libavif's
    rules (MIAF 7.3.11.4.2): tiles of one size and format, at least 64
    pixels a side, even where chroma is subsampled, as many as the output
    needs and no more, the output even where subsampled."""
    from .av1 import decode_av1
    rows, cols, ow, oh = info["grid"]
    tiles = [decode_av1(t, name) for t in info["tiles"]]
    first = tiles[0]
    th, tw = first.planes[0].shape
    fmt = (first.bit_depth, first.mono, first.ss_x, first.ss_y)
    if any((t.bit_depth, t.mono, t.ss_x, t.ss_y) != fmt
           or t.planes[0].shape != (th, tw) for t in tiles) \
            or tw < 64 or th < 64 or not (cols - 1) * tw < ow <= cols * tw \
            or not (rows - 1) * th < oh <= rows * th \
            or first.ss_x and (tw % 2 or ow % 2) \
            or first.ss_y and (th % 2 or oh % 2):
        raise IOError(f"Cannot load image {name}: a {rows} x {cols} AVIF "
                      f"grid of {tw} x {th} tiles to {ow} x {oh}, which "
                      "libavif refuses")
    planes = []
    for p in range(len(first.planes)):
        sx, sy = (first.ss_x, first.ss_y) if p else (0, 0)
        whole = np.concatenate([np.concatenate(
            [t.planes[p] for t in tiles[r * cols:(r + 1) * cols]], 1)
            for r in range(rows)], 0)
        planes.append(np.ascontiguousarray(
            whole[:(oh + sy) >> sy, :(ow + sx) >> sx]))
    first.planes = planes
    return first


def _box(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I4s", 8 + len(body), kind) + body


def _full_box(kind: bytes, version: int, body: bytes) -> bytes:
    return _box(kind, bytes([version, 0, 0, 0]) + body)


def heif_image(av1: bytes, seq_obu: bytes, w: int, h: int) -> bytes:
    """An AVIF still image of one AV1 item (`av1` its OBUs, `seq_obu`
    their sequence header, whose profile, level, bit depth and
    subsampling av1C and pixi repeat), boxes laid out as cv2.imwrite lays
    them out: ftyp (avif; avif mif1 miaf MA1B), meta (hdlr pict, pitm,
    iloc, iinf/infe av01 'Color', iprp: ipco with ispe, pixi, av1C and
    colr nclx 1/13/6 full range, then ipma), mdat."""
    from .av1 import BitReader, Decoder, leb128
    _, p = leb128(seq_obu, 1)
    d = Decoder.__new__(Decoder)
    d.sequence_header(BitReader(seq_obu, p))
    s = d.seq
    flags = ((s["bd"] > 8) << 6 | (s["bd"] == 12) << 5 | s["mono"] << 4
             | s["ssx"] << 3 | s["ssy"] << 2)
    ftyp = _box(b"ftyp", b"avif" + bytes(4) + b"avifmif1miafMA1B")
    ipco = _box(b"ipco", _full_box(b"ispe", 0, struct.pack(">II", w, h)) +
                _full_box(b"pixi", 0, bytes([3] + [s["bd"]] * 3)) +
                _box(b"av1C", bytes([0x81, s["profile"] << 5 | s["level"],
                                     flags, 0])) +
                _box(b"colr", b"nclx" + struct.pack(">HHHB", 1, 13, 6,
                                                    0x80)))
    ipma = _full_box(b"ipma", 0, struct.pack(">IHB", 1, 1, 4) +
                     bytes([0x01, 0x02, 0x83, 0x04]))
    infe = _full_box(b"infe", 2, struct.pack(">HH", 1, 0) + b"av01Color\0")

    def meta(offset):
        return _full_box(b"meta", 0, _full_box(
            b"hdlr", 0, bytes(4) + b"pict" + bytes(13)) +
            _full_box(b"pitm", 0, struct.pack(">H", 1)) +
            _full_box(b"iloc", 0, struct.pack(">BBHHHHII", 0x44, 0, 1, 1, 0,
                                              1, offset, len(av1))) +
            _full_box(b"iinf", 0, struct.pack(">H", 1) + infe) +
            _box(b"iprp", ipco + ipma))
    offset = len(ftyp) + len(meta(0)) + 8
    return ftyp + meta(offset) + _box(b"mdat", av1)


def encode_avif(rgb: np.ndarray) -> bytes:
    """uint8 [h, w, 3] RGB as cv2.imwrite writes it to .avif by default
    (utils/av1_enc.py: 4:2:0 at base_q_idx 148 with cv2's quantiser
    matrices, delta q, deblocking and CDEF)."""
    from .av1_enc import encode_yuv420
    from .yuv import rgb_to_yuv420
    rgb = np.ascontiguousarray(rgb, np.uint8)
    if rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"expected uint8 [h, w, 3], got {rgb.shape}")
    h, w = rgb.shape[:2]
    enc = encode_yuv420(*rgb_to_yuv420(rgb))
    return heif_image(enc.obus, enc.seq, w, h)


def coding_tools(data: bytes) -> list:
    """The AV1 coding tools a file switches on, read from its headers and
    the mode info of its blocks: the evidence of the fixtures' tool table
    (scripts/make_image_fixtures.py, tests/test_torch_avif.py)."""
    info = parse_avif(data)
    if "grid" in info:          # a grid's tiles' tools, and 'grid'
        tools = set().union(*(_item_tools(t, info["alpha"])
                              for t in info["tiles"])) | {"grid"}
    else:
        tools = _item_tools(info["av1"], info["alpha"])
    if data[8:12] == b"avis":
        tools.add("avis")
    meta = next((b for b in _boxes(data, 0, len(data)) if b.type == "meta"),
                None)
    if meta is not None and "tmap" in _parse_meta(data, meta)[
            "items"].values():
        tools.add("gain_map")
    return sorted(tools)


def _item_tools(av1: bytes, alpha: bool) -> set:
    """coding_tools of one AV1 item, as a set."""
    from .av1 import TXH, TXW, UV_CFL, Decoder
    d = Decoder(av1)
    s = d.seq
    fmt = "4:0:0" if s["mono"] else {(1, 1): "4:2:0", (1, 0): "4:2:2",
                                      (0, 0): "4:4:4"}[(s["ssx"], s["ssy"])]
    tools = {fmt, f"{d.bd}-bit", "full range" if s["full_range"]
             else "limited range"}
    flags = {"lossless": d.coded_lossless, "tx_mode_select":
             d.tx_mode_select, "qm": d.using_qm, "delta_q":
             d.delta_q_present, "delta_lf": d.delta_lf_present,
             "segmentation": d.seg_enabled, "cdef": d.cdef_on and any(
                 any(v) for v in d.cdef_y + d.cdef_uv),
             "deblock": any(d.lf_level[:2]), "sharpness": d.lf_sharp > 0,
             "sb128": s["sb128"], "screen_content": d.sct,
             "allow_intrabc": d.allow_intrabc, "reduced_tx_set":
             d.reduced_tx_set, "film_grain": d.grain is not None,
             "tiles": len(d.col_starts) * len(d.row_starts) > 4,
             "uv_delta_q": any(d.dq[1] + d.dq[2]),
             "reduced_still_picture_header": s["reduced"],
             "disable_cdf_update": d.disable_cdf_update,
             "superres": d.up_w != d.w,
             "show_existing_frame": d.showed_existing,
             "alpha": alpha}
    tools |= {k for k, v in flags.items() if v}
    for p, t in enumerate(d.lr_type):
        if t:
            kinds = {u[0] for u in d.lr_units[p].values()}
            tools |= {{1: "lr_wiener", 2: "lr_sgrproj"}[k] for k in kinds
                      if k}
    blocks = {id(r[4]): r[4] for r in d.records}.values()
    for b in blocks:
        if b.pal_size[0] or b.pal_size[1]:
            tools.add("palette")
        if b.filter_mode >= 0:
            tools.add("filter_intra")
        if b.uv_mode == UV_CFL and not b.is_inter:
            tools.add("cfl")
        if b.use_intrabc:
            tools.add("intrabc")
        if b.angle_y or b.angle_uv:
            tools.add("angle_delta")
        if b.size in (13, 14, 15):
            tools.add("128x128 blocks")
    for r in d.records:
        if max(TXW[r[3]], TXH[r[3]]) == 64 and r[11] is not None:
            tools.add("tx64")
    return tools
