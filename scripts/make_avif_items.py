"""HEIF item layouts around AV1 payloads, for the AVIF fixtures of
scripts/make_named_fixtures.py: files no writer here made before, each
composed box by box (ISO/IEC 23008-12, ISO/IEC 14496-12) and judged by
cv2. Not part of the port.

- `heif`: any set of items (data in `mdat`, in `idat`, or by iloc
  construction method 2 from another item), `pitm`, `iref`, item
  properties and `grpl` entity groups;
- `gain_map`: a base `av01` item, a gain map `av01` item and a `tmap`
  item (ISO 21496-1 metadata) deriving from both, grouped `altr`;
- `overlay`: an `iovl` item over AV1 inputs (canvas fill, 16- or 32-bit
  offsets);
- `track_only`: an image sequence with its `meta` taken out (chunk
  offsets moved, the brands that need a primary item dropped);
- `item_and_track`: a sequence whose primary item is another picture
  than its track's first sample.
"""
from __future__ import annotations

import struct

from ignis_tpu_torch.utils import avif
from ignis_tpu_torch.utils.avif import _boxes, _children, _find

box, full_box = avif._box, avif._full_box


def av1_props(seq_obu: bytes, w: int, h: int, nclx=True) -> list:
    """ispe, pixi, av1C (from the sequence header) and colr nclx, as
    avif.heif_image writes them."""
    whole = avif.heif_image(b"", seq_obu, w, h)
    top = list(_boxes(whole, 0, len(whole)))
    meta = next(b for b in top if b.type == "meta")
    iprp = _find(whole, meta, "iprp", 4)
    ipco = _find(whole, iprp, "ipco")
    props = [whole[b.body - 8:b.end] for b in _children(whole, ipco)]
    return props if nclx else props[:3]


def heif(items: dict, pitm: int, refs=(), groups=(), major=b"avif",
         brands=(b"avif", b"mif1", b"miaf"), iloc_version=1) -> bytes:
    """A HEIF file. `items` {id: {"type", "data", "props": [property
    boxes], "method": 0 (mdat), 1 (idat) or 2 (`from`: the id of the
    item whose data it takes, whole), "name"}}; `refs` [(kind, from,
    [to])]; `groups` [(kind, group id, [entity ids])]."""
    ids = sorted(items)
    props, assoc = [], {}
    for i in ids:
        idx = []
        for pb in items[i].get("props", []):
            if pb not in props:
                props.append(pb)
            idx.append(props.index(pb) + 1)
        assoc[i] = idx
    infe = b"".join(full_box(b"infe", 2, struct.pack(">HH", i, 0)
                             + items[i]["type"].encode()
                             + items[i].get("name", "").encode() + b"\0")
                    for i in ids)
    iinf = full_box(b"iinf", 0, struct.pack(">H", len(ids)) + infe)
    # av1C essential, the rest not, as cv2's files mark them
    ipma = full_box(b"ipma", 0, struct.pack(">I", len(ids)) + b"".join(
        struct.pack(">HB", i, len(assoc[i])) + bytes(
            k | (0x80 if props[k - 1][4:8] == b"av1C" else 0)
            for k in assoc[i]) for i in ids))
    iprp = box(b"iprp", box(b"ipco", b"".join(props)) + ipma)
    iref = b""
    if refs:
        iref = full_box(b"iref", 0, b"".join(
            box(k.encode(), struct.pack(">HH", f, len(to))
                + b"".join(struct.pack(">H", t) for t in to))
            for k, f, to in refs))
    grpl = b""
    if groups:
        grpl = box(b"grpl", b"".join(
            full_box(k.encode(), 0, struct.pack(">II", g, len(e))
                     + b"".join(struct.pack(">I", x) for x in e))
            for k, g, e in groups))
    idat = b"".join(items[i]["data"] for i in ids
                    if items[i].get("method", 0) == 1)
    mdat_items = [i for i in ids if items[i].get("method", 0) == 0]

    by_item = any(items[i].get("method") == 2 for i in ids)

    def iloc(mdat_at):
        rows, at_idat, at_mdat = [], 0, mdat_at
        for i in ids:
            it = items[i]
            m = it.get("method", 0)
            if m == 0:
                ext, at_mdat = (at_mdat, len(it["data"])), \
                    at_mdat + len(it["data"])
            elif m == 1:
                ext, at_idat = (at_idat, len(it["data"])), \
                    at_idat + len(it["data"])
            else:
                ext = (0, 0)            # the whole of the item named
            # item_reference_index: the first iloc reference
            idx = struct.pack(">I", int(m == 2)) if by_item else b""
            rows.append(struct.pack(">HHHH", i, m, 0, 1) + idx
                        + struct.pack(">II", *ext))
        sizes = 0x4400 | (4 if by_item else 0)
        body = struct.pack(">HH", sizes, len(ids)) + b"".join(rows)
        return full_box(b"iloc", iloc_version, body)
    iref_m2 = b""
    m2 = [(i, items[i]["from"]) for i in ids if items[i].get("method") == 2]
    if m2:
        iref_m2 = b"".join(box(b"iloc", struct.pack(">HHH", i, 1, f))
                           for i, f in m2)
        iref = full_box(b"iref", 0, (iref[12:] if iref else b"") + iref_m2)

    def meta(mdat_at):
        return full_box(b"meta", 0, full_box(
            b"hdlr", 0, bytes(4) + b"pict" + bytes(13))
            + full_box(b"pitm", 0, struct.pack(">H", pitm)) + iloc(mdat_at)
            + iinf + iref + iprp + grpl
            + (box(b"idat", idat) if idat else b""))
    ftyp = box(b"ftyp", major + bytes(4) + b"".join(brands))
    at = len(ftyp) + len(meta(0)) + 8
    return ftyp + meta(at) + box(b"mdat", b"".join(
        items[i]["data"] for i in mdat_items))


def tmap_metadata(channels=1, headroom=(2, 1)) -> bytes:
    """ISO 21496-1 gain map metadata as libavif writes it: version 0,
    minimum and writer version 0, flags (multichannel), the base and
    alternate HDR headrooms, then per channel the gain map's min, max,
    gamma and the base and alternate offsets, each a rational."""
    out = struct.pack(">BHHB", 0, 0, 0, 1 if channels == 3 else 0)
    out += struct.pack(">IIII", 0, 1, *headroom)
    for _ in range(channels):
        out += struct.pack(">iIiIIIiIiI", 0, 1, 2, 1, 1, 1, 1, 64, 1, 64)
    return out


def gain_map(base: tuple, gain: tuple, w: int, h: int, pitm: str,
             group=True, brand=False, tmap_in_idat=False) -> bytes:
    """A gain-mapped still: item 1 the base image, 2 the gain map (each
    (AV1 OBUs, sequence header OBU, width, height)), 3 the `tmap`
    deriving from both (dimg 3 -> 1, 2; its metadata after the images in
    `mdat`, or in `idat`), an `altr` group of 3 then 1; `pitm` "base" or
    "tmap"; with `brand`, the `tmap` brand, under which libavif parses
    the gain map."""
    items = {
        1: {"type": "av01", "data": base[0],
            "props": av1_props(base[1], base[2], base[3])},
        2: {"type": "av01", "data": gain[0], "name": "GMap",
            "props": av1_props(gain[1], gain[2], gain[3], nclx=False)},
        3: {"type": "tmap", "data": tmap_metadata(),
            "method": int(tmap_in_idat),
            "props": [full_box(b"ispe", 0, struct.pack(">II", w, h))]}}
    return heif(items, 1 if pitm == "base" else 3,
                refs=[("dimg", 3, [1, 2])],
                groups=[("altr", 10, [3, 1])] if group else (),
                brands=(b"avif", b"mif1", b"miaf")
                + ((b"tmap",) if brand else ()))


def overlay(inputs, canvas: tuple, offsets, fill=(0, 0, 0, 0),
            wide=False) -> bytes:
    """An `iovl` primary item over AV1 items (each (OBUs, sequence header
    OBU, width, height)): the canvas (width, height) filled with `fill`
    (RGBA, 16-bit), each input at its (x, y) offset."""
    fmt = ">I" if wide else ">H"
    soff = ">i" if wide else ">h"
    data = bytes([0, int(wide)]) + struct.pack(">4H", *fill) + \
        struct.pack(fmt, canvas[0]) + struct.pack(fmt, canvas[1]) + \
        b"".join(struct.pack(soff, x) + struct.pack(soff, y)
                 for x, y in offsets)
    n = len(inputs)
    items = {i + 1: {"type": "av01", "data": obus,
                     "props": av1_props(seq, w, h)}
             for i, (obus, seq, w, h) in enumerate(inputs)}
    items[n + 1] = {"type": "iovl", "data": data, "method": 1,
                    "props": [full_box(b"ispe", 0,
                                       struct.pack(">II", *canvas))]}
    return heif(items, n + 1, refs=[("dimg", n + 1, list(range(1,
                                                                n + 1)))])


def method2(obus: bytes, seq: bytes, w: int, h: int) -> bytes:
    """The primary `av01` item's data by iloc construction method 2:
    its extent the whole of item 1 (data in `mdat`), named by an `iloc`
    item reference."""
    items = {1: {"type": "av01", "data": obus, "name": "source"},
             2: {"type": "av01", "data": b"", "method": 2, "from": 1,
                 "props": av1_props(seq, w, h)}}
    return heif(items, 2)


def _chunk_offsets(data: bytearray, delta: int):
    moov = next(b for b in _boxes(bytes(data), 0, len(data))
                if b.type == "moov")
    for trak in _children(bytes(data), moov):
        if trak.type != "trak":
            continue
        mdia = _find(bytes(data), trak, "mdia")
        stbl = _find(bytes(data), _find(bytes(data), mdia, "minf"), "stbl")
        for t in _children(bytes(data), stbl):
            if t.type in ("stco", "co64"):
                k = 8 if t.type == "co64" else 4
                cnt = int.from_bytes(data[t.body + 4:t.body + 8], "big")
                for i in range(cnt):
                    q = t.body + 8 + i * k
                    v = int.from_bytes(data[q:q + k], "big") + delta
                    data[q:q + k] = v.to_bytes(k, "big")


def track_only(seq_file: bytes, brands=(b"avis", b"msf1", b"iso8")):
    """An image sequence without a primary item: `meta` taken out, the
    ftyp's compatible brands `brands` (avif, which needs a primary item,
    dropped) and the chunk offsets moved to match."""
    top = list(_boxes(seq_file, 0, len(seq_file)))
    ftyp, meta = top[0], next(b for b in top if b.type == "meta")
    new_ftyp = box(b"ftyp", seq_file[ftyp.body:ftyp.body + 8]
                   + b"".join(brands))
    rest = seq_file[ftyp.end:meta.body - 8] + seq_file[meta.end:]
    out = bytearray(new_ftyp + rest)
    _chunk_offsets(out, len(new_ftyp) - ftyp.end
                   - (meta.end - meta.body + 8))
    return bytes(out)


def item_and_track(seq_file: bytes, still_obus: bytes, major=b"avis"):
    """`seq_file` whose primary item's extent is moved to `still_obus`
    (another picture of the same size), appended in an mdat of its own;
    major brand `major`. libavif reads an `avis` major brand by its
    track, an `avif` one by its primary item."""
    top = list(_boxes(seq_file, 0, len(seq_file)))
    meta = next(b for b in top if b.type == "meta")
    pitm = avif._parse_meta(seq_file, meta)["pitm"]
    iloc = _find(seq_file, meta, "iloc", 4)
    out = bytearray(seq_file)
    off = len(out) + 8
    out += box(b"mdat", still_obus)
    if out[iloc.body] != 0 or out[iloc.body + 4] != 0x44:
        raise ValueError("expected iloc version 0 with 4-byte offsets")
    q = iloc.body + 8
    for _ in range(int.from_bytes(out[iloc.body + 6:iloc.body + 8], "big")):
        item = int.from_bytes(out[q:q + 2], "big")
        n = int.from_bytes(out[q + 4:q + 6], "big")
        q += 6
        for _ in range(n):
            if item == pitm:
                out[q:q + 8] = struct.pack(">II", off, len(still_obus))
            q += 8
    out[8:12] = major
    return bytes(out)
