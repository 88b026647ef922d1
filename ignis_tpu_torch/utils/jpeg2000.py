"""JPEG 2000 in numpy: read as OpenCV reads it through OpenJPEG, and
written as OpenCV's default .jp2 writer writes it.

Reading (`decode_jpeg2000`): the JP2 boxes (signature, `ftyp`, `jp2h`
with `ihdr`, `colr`, `pclr` and `cmap`, `jp2c`) or a raw codestream
(ITU-T T.800 Part 1); the main and tile-part headers (SIZ, COD, COC,
QCD, QCC, RGN, POC, PPM, PPT, COM, TLM, PLM, PLT, CRG, SOT, SOD, EOC;
image, tile and tile-part offsets); tier-2: tag trees and packet headers
(zero-length packets, inclusion, zero bit-planes, pass counts, Lblock,
one length per codeword segment as OpenJPEG's opj_t2_init_seg cuts the
passes under bypass and termination on each pass), SOP segments before
packets and EPH markers after their headers, headers packed in PPM or
PPT markers, in all five progression orders over any precinct size or
in the progression volumes of POC markers (main and tile-part headers,
OpenJPEG's opj_pi iterators); tier-1 in utils/ebcot.py (every Part 1
code-block style, RGN's maxshift); then dequantisation (no quantisation,
or expounded or derived step sizes, with the guard bits), OpenJPEG's
midpoint reconstruction of truncated coefficients, the inverse 5/3 in
integers and 9/7 in float32 with OpenJPEG's lifting order and constants,
the inverse RCT and ICT, the DC level shift and the clamp and rounding
to each component's precision; a palette mapped as OpenJPEG's
opj_jp2_apply_pclr maps it.

OpenCV's view of the result (`decode_jpeg2000` returns it): components
of 8 bits (in the code stream) as uint8, 9 to 16 bits as uint16, each
value cast (not clipped) to that type; one code-stream component is
grey, three RGB, four RGBA (alpha dropped, as the port drops it for
every format); a one-component image that a palette maps to colour is
the grey of that colour (OpenCV's BGR2GRAY in 15-bit fixed point), and
sYCC is turned to RGB by OpenCV's YUV2BGR (14-bit fixed point). OpenCV
reads nothing of two components, signed components, an image offset,
component subsampling, fewer than 8 or more than 16 bits, the colour
spaces e-sYCC and CMYK, or a Part 2 component transform (OpenJPEG
refuses those its own encoder writes), and the port raises IOError for
each, as ignis_tpu raises for cv2.imread's None.

Writing (`encode_jp2`), as cv2.imwrite writes an 8-bit RGB image by
default: one tile, LRCP, one layer, no component transform, five
decomposition levels of the reversible 5/3, 64 x 64 code-blocks, no
quantisation with two guard bits; the code-blocks truncated by PCRD-opt
(each block's truncation points on the convex hull of its (bytes,
distortion) pairs, one slope threshold found by bisection) so that the
code stream takes at most h * w * 3 / 4 bytes, OpenCV's rate of 4, and
an image whose whole stream fits stays lossless; SIZ, COD, QCD, COM,
SOT, SOD and EOC in JP2 boxes with an sRGB `colr`.

HTJ2K (ITU-T T.814, Part 15: code-block style 0x40) is read as OpenCV's
OpenJPEG reads it: the HT block decoder in utils/htj2k.py, tier-2 as
OpenJPEG's HT branch cuts the segments (the cleanup pass one segment,
the passes after it another; a later packet's first pass still goes to
the first segment unless the style's termination bit closes it), the
CAP and CPF markers read (`read_cap`) and the Rsiz bit taken, and the
rest shared with Part 1. OpenCV reads nothing of mixed mode (style
0x80), and of an HT block with an RGN shift, more than three passes or
a malformed cleanup segment (htj2k.Malformed): IOError for each.
"""
from __future__ import annotations

import struct

import numpy as np

from . import htj2k
from .ebcot import BYPASS, TERMALL, CodeBlocks

JP2_SIGNATURE = b"\0\0\0\x0cjP  \r\n\x87\n"
SOC = b"\xff\x4f\xff\x51"
PROGRESSIONS = ("LRCP", "RLCP", "RPCL", "PCRL", "CPRL")
HT_STYLE = 0x40
# Part 15's mixed mode: Part 1 and HT code-blocks in one component,
# which OpenJPEG refuses
_HT_MIXED = 0x80
# Part 2's multiple component transform: MCT, MCC, MCO and CBD
_PART2_MARKERS = (0xFF74, 0xFF75, 0xFF77, 0xFF78)
# the JP2 colour spaces OpenCV refuses (T.800 Table I.10: e-sYCC, CMYK)
_UNREAD_SPACES = {24: "e-sYCC", 12: "CMYK"}


# code-blocks decoded or encoded together, at most: bounds a run's
# memory (a lane holds a few 4,096-entry int64 rows, and when encoding
# its symbols, a byte each)
LANES = 1024


def _unread(what, name):
    raise IOError(f"Cannot load image {name}: {what}, which OpenCV reads "
                  "nothing of")


# ---------------------------------------------------------------------------
# JP2 boxes and headers
# ---------------------------------------------------------------------------

def _boxes(data: bytes, pos: int, end: int):
    """(type, payload start, payload end) of the boxes in data[pos:end]."""
    out = []
    while pos + 8 <= end:
        size, kind = struct.unpack(">I4s", data[pos:pos + 8])
        head = 8
        if size == 1:
            size, head = struct.unpack(">Q", data[pos + 8:pos + 16])[0], 16
        elif size == 0:
            size = end - pos
        if size < head:
            raise ValueError("JPEG 2000: bad box length")
        out.append((kind, pos + head, min(pos + size, end)))
        pos += size
    return out


def codestream(data: bytes, name="image"):
    """The code stream of a .jp2 file or a raw J2K stream, and the JP2
    colour space (the first `colr` box's enumerated space: 16 sRGB, 17
    grey, 18 sYCC, ...; None where the file names none)."""
    cs, space, _ = _jp2(data, name)
    return cs, space


def _jp2(data: bytes, name):
    """(code stream, colour space, palette): the palette is None, or
    (entries [n, channels] as read, [(component, mapping type, palette
    column)] of `cmap`), as OpenJPEG's opj_jp2_read_pclr / read_cmap read
    them; a `pclr` without a `cmap` is dropped, as OpenJPEG drops it."""
    if data.startswith(SOC):
        return data, None, None
    if not data.startswith(JP2_SIGNATURE):
        raise ValueError(f"{name}: not a JPEG 2000 file")
    space = pclr = cmap = None
    seen_colr = False
    for kind, a, b in _boxes(data, 0, len(data)):
        if kind == b"jp2h":
            for sub, c, d in _boxes(data, a, b):
                if sub == b"colr" and not seen_colr:
                    seen_colr = True
                    if data[c] == 1:
                        space = struct.unpack(">I", data[c + 3:c + 7])[0]
                elif sub == b"pclr":
                    pclr = _read_pclr(data[c:d], name)
                elif sub == b"cmap":
                    if pclr is None or cmap is not None:
                        _unread("a 'cmap' box without a 'pclr' box before "
                                "it", name)
                    body = data[c:d]
                    if len(body) < 4 * pclr.shape[1]:
                        _unread("a short 'cmap' box", name)
                    cmap = [struct.unpack(">HBB", body[4 * i:4 * i + 4])
                            for i in range(pclr.shape[1])]
        elif kind == b"jp2c":
            return data[a:b], space, None if cmap is None else (pclr, cmap)
    raise ValueError(f"{name}: no code stream (jp2c box)")


def _read_pclr(body, name):
    """The entries [n, channels] of a `pclr` box, each read unsigned in
    its channel's whole bytes (at most 4)."""
    if len(body) < 3:
        _unread("a short 'pclr' box", name)
    ne, npc = struct.unpack(">HB", body[:3])
    if not 0 < ne <= 1024 or npc == 0:
        _unread(f"a 'pclr' box of {ne} entries of {npc} channels", name)
    nbytes = [min(((b & 0x7F) + 1 + 7) >> 3, 4) for b in body[3:3 + npc]]
    pos = 3 + npc
    if len(body) < pos + ne * sum(nbytes):
        _unread("a short 'pclr' box", name)
    out = np.zeros((ne, npc), np.int64)
    for e in range(ne):
        for ch, nb in enumerate(nbytes):
            out[e, ch] = int.from_bytes(body[pos:pos + nb], "big")
            pos += nb
    return out


# Ccap15's bits 15-14 (T.814 Table A.4): which code-blocks are HT
_HT_SETS = {0: "HTONLY", 2: "HTDECLARED", 3: "MIXED"}


def read_cap(body):
    """A CAP marker's Pcap (a bit a Part, the MSB Part 1) and its Ccap
    words by Part; for Part 15, the Ccap15 fields: which code-blocks are
    HT (HTONLY, HTDECLARED or MIXED), several HT sets a block, RGN,
    heterogeneous code-block styles, the irreversible path, and the 5-bit
    MAGB field (the magnitude bound's code). A short marker gives what it
    holds (OpenJPEG reads none of it)."""
    out = {"pcap": None, "ccap": {}, "ht": None}
    if len(body) < 4:
        return out
    pcap = struct.unpack(">I", body[:4])[0]
    out["pcap"] = pcap
    pos = 4
    for part in range(1, 33):
        if pcap >> (32 - part) & 1 and pos + 2 <= len(body):
            out["ccap"][part] = struct.unpack(">H", body[pos:pos + 2])[0]
            pos += 2
    c = out["ccap"].get(15)
    if c is not None:
        out["ht"] = {"set": _HT_SETS.get(c >> 14, "reserved"),
                     "multi_ht": bool(c >> 13 & 1), "rgn": bool(c >> 12 & 1),
                     "heterogeneous": bool(c >> 11 & 1),
                     "irreversible": bool(c >> 5 & 1), "magb": c & 0x1F}
    return out


class _Coding:
    """A component's coding style (COD / COC): decomposition levels,
    code-block size exponents, style, wavelet (1: reversible 5/3) and
    precinct exponents per resolution."""

    def __init__(self, body, pos, custom, name):
        (self.levels, xcb, ycb, self.style,
         self.wavelet) = struct.unpack(">5B", body[pos:pos + 5])
        self.xcb, self.ycb = xcb + 2, ycb + 2
        if self.style & _HT_MIXED:
            _unread("HTJ2K's mixed mode (code-block style 0x80)", name)
        if self.xcb > 10 or self.ycb > 10 or self.xcb + self.ycb > 12:
            raise ValueError(f"{name}: code-block size 2^{self.xcb} x "
                             f"2^{self.ycb}")
        n = self.levels + 1
        if custom:
            pp = body[pos + 5:pos + 5 + n]
            self.prec = [(b & 15, b >> 4) for b in pp]
            if any(0 in xy for xy in self.prec[1:]):
                raise IOError(f"Cannot load image {name}: a precinct of "
                              "2^0 above the lowest resolution (T.800 "
                              "Table A.21), which OpenCV refuses")
        else:
            self.prec = [(15, 15)] * n


class _Quant:
    """A component's quantisation (QCD / QCC): style, guard bits and
    (exponent, mantissa) per band, in OpenJPEG's band order (LL, then HL,
    LH, HH of each resolution)."""

    def __init__(self, body, pos):
        sq = body[pos]
        self.style, self.guard = sq & 31, sq >> 5
        rest = body[pos + 1:]
        if self.style == 0:
            self.steps = [(b >> 3, 0) for b in rest]
        else:
            v = [struct.unpack(">H", rest[i:i + 2])[0]
                 for i in range(0, len(rest) - 1, 2)]
            self.steps = [(x >> 11, x & 0x7FF) for x in v]

    def step(self, band: int):
        if self.style == 1:          # derived from the LL band's
            e, m = self.steps[0]
            return max(e - (band - 1) // 3, 0) if band else e, m
        return self.steps[band]


def _styles():
    """A header's coding and quantisation markers (COD, COC by component,
    QCD, QCC by component), RGN shifts by component and POC volumes and,
    for a tile, its tile-parts' data and PPT data by Zppt."""
    return {"parts": [], "cod": None, "coc": {}, "qcd": None, "qcc": {},
            "rgn": {}, "poc": [], "ppt": {}}


class _Header:
    """The main header's SIZ and markers (`main`), each tile's (`tiles`),
    the tiles in the order their last tile-part comes (`order`), and the
    packet headers of PPM markers (`ppm`, None without PPM) with the
    position up to which tiles have read them (`ppm_pos`)."""

    def __init__(self, cs: bytes, name):
        self.name = name
        if not cs.startswith(SOC):
            raise ValueError(f"{name}: no SOC/SIZ")
        n = struct.unpack(">H", cs[4:6])[0]
        siz = cs[6:4 + n]
        (rsiz, self.X, self.Y, self.X0, self.Y0, self.XT, self.YT, self.XT0,
         self.YT0, nc) = struct.unpack(">H8IH", siz[:36])
        self.comps = []
        for c in range(nc):
            s, dx, dy = siz[36 + 3 * c:39 + 3 * c]
            if dx != 1 or dy != 1:
                _unread(f"component subsampling ({dx} x {dy})", name)
            self.comps.append(((s & 0x7F) + 1, bool(s & 0x80)))
        self.main = _styles()
        self.tiles = {}
        # Part 15's capabilities and profile, as read; OpenJPEG decodes
        # by the code-block style alone, whatever they say
        self.cap = self.cpf = None
        ppm, order = [], []          # PPM data by Zppm; tiles of tile-parts
        pos = 4 + n
        tile = end = None
        while pos + 2 <= len(cs):
            m = struct.unpack(">H", cs[pos:pos + 2])[0]
            if m == 0xFFD9:                  # EOC
                break
            if m == 0xFF93:                  # SOD: the tile-part's data
                if not end:                  # to EOC
                    end = len(cs) - 2 * (cs[-2:] == b"\xff\xd9")
                self.tiles[tile]["parts"].append(cs[pos + 2:end])
                order.append(tile)
                pos = end
                continue
            length = struct.unpack(">H", cs[pos + 2:pos + 4])[0]
            body = cs[pos + 4:pos + 2 + length]
            if m in _PART2_MARKERS:
                _unread("a Part 2 multiple component transform", name)
            if m == 0xFF50:                  # CAP (Part 15)
                self.cap = read_cap(body)
            elif m == 0xFF59:                # CPF: Pcpf words
                self.cpf = [struct.unpack(">H", body[i:i + 2])[0]
                            for i in range(0, len(body) - 1, 2)]
            dest = self.main if tile is None else self.tiles[tile]
            if m == 0xFF90:                  # SOT
                tile, psot = struct.unpack(">HI", body[:6])
                end = pos + psot if psot else None
                self.tiles.setdefault(tile, _styles())
            elif m in (0xFF52, 0xFF53, 0xFF5C, 0xFF5D):
                self._coding_marker(m, body, dest)
            elif m == 0xFF5E:                # RGN: Crgn, Srgn, SPrgn
                k = 2 if len(self.comps) > 256 else 1
                c = int.from_bytes(body[:k], "big")
                if c >= len(self.comps):
                    raise ValueError(f"{name}: RGN of component {c}")
                dest["rgn"][c] = body[k + 1]
            elif m == 0xFF5F:
                dest["poc"].extend(self._poc(body))
            elif m == 0xFF60:                # PPM: Zppm, Ippm
                ppm.append((body[0], body[1:]))
            elif m == 0xFF61:                # PPT: Zppt, Ippt
                if ppm:
                    _unread("PPT markers beside PPM markers", name)
                if body[0] in dest["ppt"]:
                    _unread(f"a second PPT marker of Zppt {body[0]}", name)
                dest["ppt"][body[0]] = body[1:]
            pos += 2 + length
        if self.main["cod"] is None or self.main["qcd"] is None:
            raise ValueError(f"{name}: no COD or QCD in the main header")
        self.order = list(dict.fromkeys(order[::-1]))[::-1]
        self.ppm = self._ppm(ppm, len(order)) if ppm else None
        self.ppm_pos = 0

    def _poc(self, body):
        """The progression volumes of a POC marker: (resolution start,
        component start, layer end, resolution end, component end,
        progression) each, the component end at most the components
        (OpenJPEG's opj_j2k_read_poc; a one-byte end of 0 is 256)."""
        k = 2 if len(self.comps) > 256 else 1
        size = 5 + 2 * k
        if not body or len(body) % size:
            raise ValueError(f"{self.name}: a POC marker of {len(body)} "
                             "bytes")
        out = []
        for i in range(0, len(body), size):
            r0 = body[i]
            c0 = int.from_bytes(body[i + 1:i + 1 + k], "big")
            l1, r1 = struct.unpack(">HB", body[i + 1 + k:i + 4 + k])
            c1 = int.from_bytes(body[i + 4 + k:i + 4 + 2 * k], "big")
            prog = body[i + 4 + 2 * k]
            if prog > 4:
                raise ValueError(f"{self.name}: progression order {prog}")
            out.append((r0, c0, l1, r1, (c1 or 256) if k == 1 else c1,
                        prog))
        return [(r0, c0, l1, r1, min(c1, len(self.comps)), prog)
                for r0, c0, l1, r1, c1, prog in out]

    def _ppm(self, ppm, parts):
        """The packet headers of PPM markers as OpenJPEG's
        opj_j2k_merge_ppm joins them: the Ippm in Zppm order, each
        tile-part's Nppm-byte run after its 4-byte Nppm, the runs of all
        tile-parts one stream that the tiles read on from each other."""
        if len({z for z, _ in ppm}) < len(ppm):
            _unread("two PPM markers of one Zppm", self.name)
        data = b"".join(d for _, d in sorted(ppm, key=lambda x: x[0]))
        out, pos = [], 0
        while pos < len(data):
            if pos + 4 > len(data):
                _unread("a PPM marker without its Nppm", self.name)
            n = struct.unpack(">I", data[pos:pos + 4])[0]
            out.append(data[pos + 4:pos + 4 + n])
            pos += 4 + n
        if len(out) < parts:
            _unread("PPM markers shorter than their tile-parts", self.name)
        return b"".join(out)

    def _coding_marker(self, m, body, dest):
        wide = len(self.comps) > 256
        if m == 0xFF52:
            scod = body[0]
            prog, layers, mct = struct.unpack(">BHB", body[1:5])
            if prog > 4:
                raise ValueError(f"{self.name}: progression order {prog}")
            dest["cod"] = (prog, layers, mct,
                           _Coding(body, 5, scod & 1, self.name), scod)
        elif m == 0xFF53:
            c = struct.unpack(">H", body[:2])[0] if wide else body[0]
            k = 2 if wide else 1
            dest["coc"][c] = _Coding(body, k + 1, body[k] & 1, self.name)
        elif m == 0xFF5C:
            dest["qcd"] = _Quant(body, 0)
        else:
            c = struct.unpack(">H", body[:2])[0] if wide else body[0]
            dest["qcc"][c] = _Quant(body, 2 if wide else 1)

    def styles(self, t):
        """(progression, layers, mct, [coding], [quant]) of tile t, by
        the precedence tile COC > tile COD > main COC > main COD (and
        likewise for QCC / QCD)."""
        tp, main = self.tiles.get(t) or _styles(), self.main
        prog, layers, mct, cod, _ = tp["cod"] or main["cod"]
        codings, quants = [], []
        for c in range(len(self.comps)):
            if c in tp["coc"]:
                codings.append(tp["coc"][c])
            elif tp["cod"] is not None:
                codings.append(tp["cod"][3])
            else:
                codings.append(main["coc"].get(c, main["cod"][3]))
            if c in tp["qcc"]:
                quants.append(tp["qcc"][c])
            elif tp["qcd"] is not None:
                quants.append(tp["qcd"])
            else:
                quants.append(main["qcc"].get(c, main["qcd"]))
        return prog, layers, mct, codings, quants

    def packets(self, t):
        """How tile t's packets are read: (SOP before each, EPH after
        each header, its POC volumes (the main header's, then its own),
        RGN shift per component, its packet headers where PPM or PPT
        markers hold them, else None)."""
        tp, main = self.tiles.get(t) or _styles(), self.main
        scod = (tp["cod"] or main["cod"])[4]
        shifts = [tp["rgn"].get(c, main["rgn"].get(c, 0))
                  for c in range(len(self.comps))]
        if self.ppm is not None:
            heads = self.ppm[self.ppm_pos:]
        elif tp["ppt"]:
            heads = b"".join(tp["ppt"][z] for z in sorted(tp["ppt"]))
        else:
            heads = None
        return (bool(scod & 2), bool(scod & 4), main["poc"] + tp["poc"],
                shifts, heads)


# ---------------------------------------------------------------------------
# tier-2: tag trees and packets
# ---------------------------------------------------------------------------

class _BitReader:
    """Packet-header bits, MSB first; after a 0xFF byte only 7 bits
    (OpenJPEG's opj_bio)."""

    def __init__(self, data, pos):
        self.data, self.pos = data, pos
        self.buf, self.ct = 0, 0

    def bit(self):
        if self.ct == 0:
            self.buf = (self.buf << 8) & 0xFFFF
            self.ct = 7 if self.buf == 0xFF00 else 8
            if self.pos < len(self.data):
                self.buf |= self.data[self.pos]
                self.pos += 1
        self.ct -= 1
        return (self.buf >> self.ct) & 1

    def bits(self, n):
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bit()
        return v

    def align(self):
        """The end of a header: after 0xFF the stuffed byte is read.
        False where that byte is past the data (opj_bio_inalign fails)."""
        ok = True
        if (self.buf & 0xFF) == 0xFF:
            ok = self.pos < len(self.data)
            self.ct = 0
            self.bit()
        self.ct = 0
        return ok


class _TagTree:
    """A tag tree over a w x h grid of leaves (T.800 B.10.2): nodes level
    by level, leaves first."""

    def __init__(self, w, h):
        self.parent = []
        sizes = []
        while True:
            sizes.append((w, h))
            if w * h <= 1:
                break
            w, h = (w + 1) // 2, (h + 1) // 2
        base, parent = 0, []
        for lv, (w, h) in enumerate(sizes):
            nxt = base + w * h
            for j in range(h):
                for i in range(w):
                    if lv + 1 < len(sizes):
                        pw = sizes[lv + 1][0]
                        parent.append(nxt + (j // 2) * pw + i // 2)
                    else:
                        parent.append(-1)
            base = nxt
        self.parent = parent
        n = len(parent)
        # OpenJPEG's opj_tgt_reset: a node not yet decoded holds 999, so a
        # header read past its data (zero bits) ends at threshold 1,000
        self.value = [999] * n
        self.low = [0] * n
        self.known = [False] * n

    def _path(self, leaf):
        path = [leaf]
        while self.parent[path[-1]] >= 0:
            path.append(self.parent[path[-1]])
        return path[::-1]

    def decode(self, br: _BitReader, leaf, threshold):
        """True where the leaf's value is below threshold (opj_tgt_decode);
        the bits read refine the tree's nodes."""
        low = 0
        for node in self._path(leaf):
            low = max(low, self.low[node])
            while low < threshold and low < self.value[node]:
                if br.bit():
                    self.value[node] = low
                else:
                    low += 1
            self.low[node] = low
        return self.value[leaf] < threshold

    def set(self, values):
        """Leaf values for encoding; each parent holds its children's
        least."""
        n = len(values)
        self.value[:n] = list(values)
        for i in range(len(self.parent)):
            p = self.parent[i]
            if p >= 0:
                self.value[p] = min(self.value[p], self.value[i])

    def encode(self, bw, leaf, threshold):
        low = 0
        for node in self._path(leaf):
            low = max(low, self.low[node])
            while low < threshold:
                if low >= self.value[node]:
                    if not self.known[node]:
                        bw.put(1)
                        self.known[node] = True
                    break
                bw.put(0)
                low += 1
            self.low[node] = low


def _num_passes(br):
    if not br.bit():
        return 1
    if not br.bit():
        return 2
    n = br.bits(2)
    if n != 3:
        return 3 + n
    n = br.bits(5)
    if n != 31:
        return 6 + n
    return 37 + br.bits(7)


def _ceildiv(a, b):
    return -(-a // b)


class _Block:
    """A code-block: its band, position in the band's array, and what
    the packets gave it: codeword segments, each [most passes, passes,
    bytes]."""
    __slots__ = ("band", "x0", "y0", "x1", "y1", "leaf", "included",
                 "lblock", "planes", "passes", "segs", "chunks")

    def __init__(self, band, x0, y0, x1, y1, leaf):
        self.band, self.leaf = band, leaf
        self.x0, self.y0, self.x1, self.y1 = x0, y0, x1, y1
        self.included, self.lblock, self.planes, self.passes = False, 3, 0, 0
        self.segs, self.chunks = [], []


def _max_passes(style, prev):
    """The passes a new codeword segment holds (OpenJPEG's
    opj_t2_init_seg; prev: the previous segment's, None for the first):
    one under termination on each pass; under bypass 10 (the first: up to
    the fourth plane's clean-up), then 2 (a raw significance and
    refinement pair) and 1 (an MQ clean-up) in turn; else all (109)."""
    if style & TERMALL:
        return 1
    if style & BYPASS:
        return 10 if prev is None else (2 if prev in (1, 10) else 1)
    return 109


class _Band:
    """A sub-band of a tile-component: orientation (0 LL, 1 HL, 2 LH,
    3 HH), extent in band coordinates, bit-planes Mb and step size."""

    def __init__(self, orient, x0, y0, x1, y1, index):
        self.orient, self.index = orient, index
        self.x0, self.y0, self.x1, self.y1 = x0, y0, x1, y1


def _tile_component(tcx0, tcy0, tcx1, tcy1, cod: _Coding):
    """Resolutions of one tile-component: per resolution its extent,
    bands, precinct grid and precincts, each a list of (band, its
    code-blocks, cw, ch, inclusion tag tree, zero bit-plane tag tree)."""
    NL = cod.levels
    res = []
    for r in range(NL + 1):
        s = 1 << (NL - r)
        rx0, ry0 = _ceildiv(tcx0, s), _ceildiv(tcy0, s)
        rx1, ry1 = _ceildiv(tcx1, s), _ceildiv(tcy1, s)
        ppx, ppy = cod.prec[r]
        if r == 0:
            bands = [_Band(0, rx0, ry0, rx1, ry1, 0)]
        else:
            nb = NL - r + 1
            bands = []
            for k, (xo, yo) in enumerate(((1, 0), (0, 1), (1, 1))):
                ox, oy = xo << (nb - 1), yo << (nb - 1)
                bands.append(_Band(
                    k + 1, _ceildiv(tcx0 - ox, 1 << nb),
                    _ceildiv(tcy0 - oy, 1 << nb),
                    _ceildiv(tcx1 - ox, 1 << nb),
                    _ceildiv(tcy1 - oy, 1 << nb), 3 * (r - 1) + k + 1))
        px0, py0 = (rx0 >> ppx) << ppx, (ry0 >> ppy) << ppy
        pw = 0 if rx1 == rx0 else (_ceildiv(rx1, 1 << ppx) - (rx0 >> ppx))
        ph = 0 if ry1 == ry0 else (_ceildiv(ry1, 1 << ppy) - (ry0 >> ppy))
        if r == 0:
            gx0, gy0, gw, gh = px0, py0, ppx, ppy
        else:
            gx0, gy0, gw, gh = px0 >> 1, py0 >> 1, ppx - 1, ppy - 1
        cbw, cbh = min(cod.xcb, gw), min(cod.ycb, gh)
        precincts = []
        for k in range(pw * ph):
            kx, ky = k % pw, k // pw
            prc = []
            for band in bands:
                x0 = max(gx0 + (kx << gw), band.x0)
                y0 = max(gy0 + (ky << gh), band.y0)
                x1 = min(gx0 + ((kx + 1) << gw), band.x1)
                y1 = min(gy0 + ((ky + 1) << gh), band.y1)
                if band.x1 <= band.x0 or band.y1 <= band.y0:
                    continue
                if x1 <= x0 or y1 <= y0:
                    cw = ch = 0
                else:
                    bx0, by0 = (x0 >> cbw) << cbw, (y0 >> cbh) << cbh
                    cw = _ceildiv(x1, 1 << cbw) - (x0 >> cbw)
                    ch = _ceildiv(y1, 1 << cbh) - (y0 >> cbh)
                blocks = []
                for j in range(cw * ch):
                    cx = bx0 + ((j % cw) << cbw)
                    cy = by0 + ((j // cw) << cbh)
                    blocks.append(_Block(band, max(cx, x0), max(cy, y0),
                                         min(cx + (1 << cbw), x1),
                                         min(cy + (1 << cbh), y1), j))
                prc.append((band, blocks, cw, ch,
                                  _TagTree(cw, ch) if cw * ch else None,
                                  _TagTree(cw, ch) if cw * ch else None))
            precincts.append(prc)
        res.append({"x0": rx0, "y0": ry0, "x1": rx1, "y1": ry1,
                    "bands": bands, "pw": pw, "ph": ph, "ppx": ppx,
                    "ppy": ppy, "px0": px0, "py0": py0,
                    "precincts": precincts})
    return res


def _packet_order(prog, layers, comps, tx0, ty0, pocs=()):
    """(layer, resolution, component, precinct) of every packet of a
    tile in progression order; comps: per component its resolutions.
    The position orders emit a precinct where OpenJPEG's walk over the
    canvas meets it: at its upper-left corner on the canvas, or at the
    tile's edge for a precinct that starts before it. Under POC volumes
    (resolution start, component start, layer end, resolution end,
    component end, progression), each volume in turn from layer 0, a
    packet that an earlier volume gave skipped (OpenJPEG's `include`)."""
    if pocs:
        seen, out = set(), []
        for r0, c0, l1, r1, c1, p in pocs:
            for pk in _packet_order(p, min(l1, layers), comps, tx0, ty0):
                if r0 <= pk[1] < r1 and c0 <= pk[2] < c1 and pk not in seen:
                    seen.add(pk)
                    out.append(pk)
        return out
    maxr = max(len(res) for res in comps)
    out = []
    if prog in (0, 1):
        outer = [(l, r) for l in range(layers) for r in range(maxr)] \
            if prog == 0 else [(l, r) for r in range(maxr)
                               for l in range(layers)]
        for l, r in outer:
            for c, res in enumerate(comps):
                if r < len(res):
                    n = res[r]["pw"] * res[r]["ph"]
                    out.extend((l, r, c, k) for k in range(n))
        return out
    entries = []
    for c, res in enumerate(comps):
        NL = len(res) - 1
        for r, rr in enumerate(res):
            for k in range(rr["pw"] * rr["ph"]):
                kx, ky = k % rr["pw"], k // rr["pw"]
                x = max(tx0, (rr["px0"] + (kx << rr["ppx"])) << (NL - r))
                y = max(ty0, (rr["py0"] + (ky << rr["ppy"])) << (NL - r))
                key = {2: (r, y, x, c), 3: (y, x, c, r), 4: (c, y, x, r)}[prog]
                entries.append((key, r, c, k))
    entries.sort()
    for _, r, c, k in entries:
        out.extend((l, r, c, k) for l in range(layers))
    return out


def _read_packets(data, order, comps, quants, codings, sop=False,
                  eph=False, heads=None, name="image"):
    """Parse the packets of a tile's data in order, giving each
    code-block its codeword segments (their passes and bytes): an SOP
    segment skipped before a packet where it stands, the header read from
    the data or from `heads` (PPM / PPT), an EPH skipped after it. As in
    OpenJPEG's opj_t2_read_packet_header and strict mode, the file is not
    read where an EPH is missing (after any header), a length takes more
    than 32 bits, a header that gives passes ends on 0xFF at the end of
    its data, or a segment runs past the tile's data. Without `heads`,
    stops at the end of the data (the rest of the packets read as
    empty: under EPH, a missing EPH). Returns the bytes of `heads` read."""
    pos = hpos = 0
    for l, r, c, k in order:
        if heads is None and pos >= len(data):
            if eph:
                _unread("a packet header without its EPH marker", name)
            break
        if sop and len(data) - pos >= 6 and data[pos:pos + 2] == b"\xff\x91":
            pos += 6
        src = data if heads is None else heads
        prc = comps[c][r]["precincts"][k]
        br = _BitReader(src, pos if heads is None else hpos)
        got = []
        style = codings[c].style
        present = br.bit()
        if present:
            for band, blocks, cw, ch, incl, zbp in prc:
                mb = quants[c].step(band.index)[0] + quants[c].guard - 1
                for b in blocks:
                    if not b.included:
                        inc = incl.decode(br, b.leaf, l + 1)
                    else:
                        inc = br.bit()
                    if not inc:
                        continue
                    if not b.included:
                        i = 0
                        while not zbp.decode(br, b.leaf, i):
                            i += 1
                        b.planes = mb - (i - 1)   # less the zero planes
                        b.included = True
                    n = _num_passes(br)
                    while br.bit():
                        b.lblock += 1
                    segs = b.segs
                    if not segs or segs[-1][1] == segs[-1][0]:
                        segs.append([_max_passes(
                            style, segs[-1][0] if segs else None), 0, b""])
                    j = len(segs) - 1
                    while True:
                        if style & HT_STYLE:
                            # OpenJPEG's HT branch: the first segment
                            # takes one pass a packet, a later one the
                            # rest (a later packet's first pass goes to
                            # the first segment while it is not full)
                            take = 1 if j == 0 else n
                        else:
                            take = min(segs[j][0] - segs[j][1], n)
                        bits = b.lblock + take.bit_length() - 1
                        if bits > 32:
                            _unread(f"a {bits}-bit segment length", name)
                        got.append((b, j, take, br.bits(bits)))
                        n -= take
                        if n <= 0:
                            break
                        segs.append([_max_passes(style, segs[j][0]), 0, b""])
                        j += 1
        if not br.align() and present:
            _unread("a packet header cut at 0xFF", name)
        hp = br.pos
        if eph:
            if len(src) - hp < 2 or src[hp:hp + 2] != b"\xff\x92":
                _unread("a packet header without its EPH marker", name)
            hp += 2
        if heads is None:
            pos = hp
        else:
            hpos = hp
        for b, j, take, length in got:
            if pos + length > len(data):
                _unread("a code-block's segment past the end of its tile's "
                        "data (OpenJPEG's strict mode)", name)
            b.segs[j][2] += data[pos:pos + length]
            b.segs[j][1] += take
            b.passes += take
            b.chunks.append(data[pos:pos + length])
            pos += length
    return hpos


# ---------------------------------------------------------------------------
# wavelets and colour
# ---------------------------------------------------------------------------

def _mirror(i, n):
    """Whole-sample symmetric extension of index i in [0, n)."""
    i = np.abs(i)
    return np.where(i > n - 1, 2 * (n - 1) - i, i)


def _idwt53_1d(x, cas, axis):
    """Inverse reversible 5/3 along an axis of an integer array whose
    first sample sits at an even (cas 0) or odd (cas 1) coordinate."""
    x = np.moveaxis(x, axis, 0).copy()
    n = x.shape[0]
    if n == 1:
        if cas:          # OpenJPEG halves a lone odd sample, truncating
            x = np.where(x < 0, -((-x) >> 1), x >> 1)
        return np.moveaxis(x, 0, axis)
    i = np.arange(n)
    lo, hi = i[cas::2], i[1 - cas::2]
    x[lo] -= (x[_mirror(lo - 1, n)] + x[_mirror(lo + 1, n)] + 2) >> 2
    x[hi] += (x[_mirror(hi - 1, n)] + x[_mirror(hi + 1, n)]) >> 1
    return np.moveaxis(x, 0, axis)


# OpenJPEG's 9/7 lifting constants (float32) and its scaling: the low
# band times K, the high band times 2 / K (its "two_invK", offset by
# step sizes taken without the bands' gain)
_K = np.float32(1.230174105)
_TWO_INV_K = np.float32(1.625732422)
_LIFT = (np.float32(-0.443506852), np.float32(-0.882911075),
         np.float32(0.052980118), np.float32(1.586134342))


def _idwt97_1d(x, cas, axis):
    """Inverse irreversible 9/7 along an axis of a float32 array, in
    OpenJPEG's order: scale, then four lifting steps with symmetric
    extension, each new = old + (left + right) * c in float32."""
    x = np.moveaxis(x, axis, 0).copy()
    n = x.shape[0]
    sn = (n + 1 - cas) // 2
    dn = n - sn
    if (cas == 0 and not (dn > 0 or sn > 1)) or (
            cas == 1 and not (sn > 0 or dn > 1)):
        return np.moveaxis(x, 0, axis)
    i = np.arange(n)
    lo, hi = i[cas::2], i[1 - cas::2]
    x[lo] *= _K
    x[hi] *= _TWO_INV_K
    for step, c in enumerate(_LIFT):
        t = lo if step % 2 == 0 else hi
        x[t] = x[t] + (x[_mirror(t - 1, n)] + x[_mirror(t + 1, n)]) * c
    return np.moveaxis(x, 0, axis)


def _inverse_dwt(bands_by_res, res, reversible):
    """The tile-component from its bands: per resolution, interleave
    LL / HL / LH / HH, then the 1-D inverse along rows, then columns."""
    a = bands_by_res[0][0]
    inv = _idwt53_1d if reversible else _idwt97_1d
    for r in range(1, len(res)):
        rr = res[r]
        w, h = rr["x1"] - rr["x0"], rr["y1"] - rr["y0"]
        cx, cy = rr["x0"] & 1, rr["y0"] & 1
        out = np.zeros((h, w), a.dtype)
        hl, lh, hh = bands_by_res[r]
        out[cy::2, cx::2] = a
        out[cy::2, 1 - cx::2] = hl
        out[1 - cy::2, cx::2] = lh
        out[1 - cy::2, 1 - cx::2] = hh
        if w and h:
            out = inv(out, cx, 1)
            out = inv(out, cy, 0)
        a = out
    return a


def _inverse_ict(y, u, v):
    """OpenJPEG's opj_mct_decode_real in float32."""
    r = y + v * np.float32(1.402)
    g = y - u * np.float32(0.34413) - v * np.float32(0.71414)
    b = y + u * np.float32(1.772)
    return r, g, b


# ---------------------------------------------------------------------------
# decoding
# ---------------------------------------------------------------------------

def decode_components(data: bytes, name="image"):
    """Every component of a JPEG 2000 file as int32 [h, w] arrays (the
    image area, offsets removed), with the header (its `palette` the JP2
    palette, if any): (components, header, JP2 colour space)."""
    cs, space, palette = _jp2(data, name)
    hd = _Header(cs, name)
    hd.palette = palette
    W, H = hd.X - hd.X0, hd.Y - hd.Y0
    out = [np.zeros((H, W), np.int32) for _ in hd.comps]
    ntx = _ceildiv(hd.X - hd.XT0, hd.XT)
    nty = _ceildiv(hd.Y - hd.YT0, hd.YT)
    # as OpenJPEG decodes them: each tile once its last tile-part is read
    # (PPM's headers are read on from tile to tile in this order)
    tiles = [t for t in hd.order if t < ntx * nty]
    for t in tiles + [t for t in range(ntx * nty) if t not in tiles]:
        p, q = t % ntx, t // ntx
        tx0 = max(hd.XT0 + p * hd.XT, hd.X0)
        ty0 = max(hd.YT0 + q * hd.YT, hd.Y0)
        tx1 = min(hd.XT0 + (p + 1) * hd.XT, hd.X)
        ty1 = min(hd.YT0 + (q + 1) * hd.YT, hd.Y)
        tile = _decode_tile(hd, t, tx0, ty0, tx1, ty1)
        for c, (arr, y0, x0) in enumerate(tile):
            y0, x0 = y0 - hd.Y0, x0 - hd.X0
            h, w = min(arr.shape[0], H - y0), min(arr.shape[1], W - x0)
            out[c][y0:y0 + h, x0:x0 + w] = arr[:h, :w]
    return out, hd, space


def _decode_tile(hd: _Header, t, tx0, ty0, tx1, ty1):
    prog, layers, mct, codings, quants = hd.styles(t)
    if mct > 1:
        _unread("a Part 2 multiple component transform", hd.name)
    sop, eph, pocs, shifts, heads = hd.packets(t)
    comps = [_tile_component(tx0, ty0, tx1, ty1, cod) for cod in codings]
    data = b"".join(hd.tiles[t]["parts"]) if t in hd.tiles else b""
    order = _packet_order(prog, layers, comps, tx0, ty0, pocs)
    # the highest resolution each component's packets reach (OpenJPEG's
    # resno_decoded): POC volumes may leave the top ones out
    top = [max((r for _, r, cc, _ in order if cc == c), default=0)
           for c in range(len(comps))]
    if mct and len(comps) >= 3:
        # OpenJPEG's opj_tcd_mct_decode refuses the transform (and the
        # tile) where components 0-2 differ in resolutions, or in the
        # highest one their packets reach
        if len({len(comps[c]) for c in range(3)}) > 1 or \
                len(set(top[:3])) > 1:
            _unread("a colour transform over components of different "
                    "resolutions", hd.name)
    used = _read_packets(data, order, comps, quants, codings, sop, eph,
                         heads, hd.name)
    if hd.ppm is not None:
        hd.ppm_pos += used
    # tier-1: every code-block of the tile a lane, LANES at a time
    blocks, comp_of = [], []
    for c, res in enumerate(comps):
        for rr in res:
            for prc in rr["precincts"]:
                for part in prc:
                    for b in part[1]:
                        if b.planes + shifts[c] >= 31:
                            _unread(f"{b.planes + shifts[c]} bit-planes "
                                    "in a code-block", hd.name)
                        if b.passes:
                            blocks.append(b)
                            comp_of.append(c)
    coeffs = {id(band): np.zeros((max(band.y1 - band.y0, 0),
                                  max(band.x1 - band.x0, 0)), np.int64)
              for res in comps for rr in res for band in rr["bands"]}
    ht = [b for b, c in zip(blocks, comp_of) if codings[c].style & HT_STYLE]
    if ht:
        # HT code-blocks (Part 15): every block of each HT component,
        # the empty ones too, as OpenJPEG decodes them
        specs = []
        for c, res in enumerate(comps):
            if not codings[c].style & HT_STYLE:
                continue
            for rr in res:
                for prc in rr["precincts"]:
                    for band, blks, *_ in prc:
                        mb = quants[c].step(band.index)[0] \
                            + quants[c].guard - 1
                        for b in blks:
                            specs.append((b, htj2k.Block(
                                b"".join(b.chunks) if b.chunks else None,
                                len(b.segs[0][2]) if b.segs else 0,
                                len(b.segs[1][2]) if len(b.segs) > 1 else 0,
                                sum(s[1] for s in b.segs[:2]),
                                mb if b.included else 0, b.planes,
                                b.y1 - b.y0, b.x1 - b.x0, codings[c].style,
                                shifts[c])))
        try:
            for k in range(0, len(specs), LANES):
                run = specs[k:k + LANES]
                for (b, _), arr in zip(run, htj2k.decode_blocks(
                        [s for _, s in run])):
                    band = b.band
                    coeffs[id(band)][b.y0 - band.y0:b.y1 - band.y0,
                                     b.x0 - band.x0:b.x1 - band.x0] = arr
        except htj2k.Malformed as e:
            _unread(f"an HT code-block OpenJPEG refuses ({e})", hd.name)
        keep = [i for i, c in enumerate(comp_of)
                if not codings[c].style & HT_STYLE]
        blocks = [blocks[i] for i in keep]
        comp_of = [comp_of[i] for i in keep]
    for k in range(0, len(blocks), LANES):
        run, cs = blocks[k:k + LANES], comp_of[k:k + LANES]
        cb = CodeBlocks([(b.y1 - b.y0, b.x1 - b.x0) for b in run],
                        [b.band.orient for b in run],
                        [b.planes for b in run], [b.passes for b in run],
                        [codings[c].style for c in cs],
                        [shifts[c] for c in cs])
        cb.decode([[(bytes(d), n) for _, n, d in b.segs] for b in run])
        for i, b in enumerate(run):
            band = b.band
            coeffs[id(band)][b.y0 - band.y0:b.y1 - band.y0,
                             b.x0 - band.x0:b.x1 - band.x0] = cb.block(i)
    # OpenJPEG rebuilds a component only up to top[c] and puts that
    # smaller picture at its own origin on the canvas, the rest of the
    # tile left 0
    out = []
    for c, (res, cod, qnt) in enumerate(zip(comps, codings, quants)):
        prec = hd.comps[c][0]
        reversible = cod.wavelet == 1
        by_res = []
        res = res[:top[c] + 1]
        for rr in res:
            arrs = []
            for band in rr["bands"]:
                arr = coeffs[id(band)]
                if reversible:
                    arr = np.where(arr < 0, -((-arr) >> 1), arr >> 1)
                else:
                    e, m = qnt.step(band.index)
                    step = np.float32((1.0 + m / 2048.0)
                                      * 2.0 ** (prec - e))
                    arr = arr.astype(np.float32) * (np.float32(0.5) * step)
                arrs.append(arr)
            by_res.append(arrs)
        out.append(_inverse_dwt(by_res, res, reversible))
    if mct and len(out) >= 3 and out[0].shape == out[1].shape == \
            out[2].shape:
        if codings[0].wavelet == 1:
            y, u, v = out[:3]
            g = y - ((u + v) >> 2)
            out[:3] = [v + g, g, u + g]
        else:
            out[:3] = _inverse_ict(*out[:3])
    result = []
    for c, arr in enumerate(out):
        prec, signed = hd.comps[c]
        if arr.dtype == np.float32:
            arr = np.rint(arr).astype(np.int64)
        lo, hi = (-(1 << (prec - 1)), (1 << (prec - 1)) - 1) if signed \
            else (0, (1 << prec) - 1)
        shift = 0 if signed else 1 << (prec - 1)
        rr = comps[c][top[c]]
        result.append((np.clip(arr + shift, lo, hi).astype(np.int32),
                       rr["y0"], rr["x0"]))
    return result


def _apply_palette(comps, palette, name):
    """The components after `pclr` and `cmap`, as OpenJPEG's
    opj_jp2_check_color and opj_jp2_apply_pclr give them: a mapped
    channel takes the entries of its palette column at the index clamped
    to the entries, a direct one its component as it is. A one-component
    image whose mapping leaves a column unused maps column i to channel
    i (OpenJPEG's repair of such files)."""
    entries, cmap = palette
    npc = entries.shape[1]
    used = [False] * npc
    for i, (cmp, mtyp, pcol) in enumerate(cmap):
        if cmp >= len(comps) or mtyp > 1 or pcol >= npc \
                or (mtyp == 1 and (used[pcol] or pcol != i)) \
                or (mtyp == 0 and pcol != 0):
            _unread("a 'cmap' box that OpenJPEG refuses", name)
        used[pcol] = True
    if any(not used[i] and cmap[i][1] for i in range(len(cmap))):
        _unread("a 'cmap' box that OpenJPEG refuses", name)
    if len(comps) == 1 and not all(used):
        cmap = [(cmp, 1, i) for i, (cmp, _, _) in enumerate(cmap)]
    out = []
    for i, (cmp, mtyp, pcol) in enumerate(cmap):
        src = comps[cmp]
        if mtyp == 0:
            out.append(src.astype(np.int64))
        else:
            out.append(entries[np.clip(src, 0, len(entries) - 1), pcol])
    return out


def _descale(x, n):
    """OpenCV's CV_DESCALE: x / 2^n rounded half up, in integers."""
    return (x + (1 << (n - 1))) >> n


def _grey(r, g, b):
    """OpenCV's BGR2GRAY of integer samples (15-bit fixed point, the
    coefficients of 0.299, 0.587 and 0.114)."""
    return _descale(b * 3735 + g * 19235 + r * 9798, 15)


def _yuv_to_rgb(y, u, v, top):
    """OpenCV's YUV2BGR of integer samples of maximum `top` (14-bit fixed
    point, U and V about top // 2 + 1), as (r, g, b) clamped to
    [0, top]."""
    d = top // 2 + 1
    b = y + _descale((u - d) * 33292, 14)
    g = y + _descale((u - d) * -6472 + (v - d) * -9519, 14)
    r = y + _descale((v - d) * 18678, 14)
    return [np.clip(x, 0, top) for x in (r, g, b)]


def decode_jpeg2000(data: bytes, name="image") -> np.ndarray:
    """A .jp2 file or J2K code stream as OpenCV reads it: [h, w, 3] RGB
    uint8 (8-bit components) or uint16 (9 to 16 bits), grey replicated,
    alpha dropped; a palette's colours as their grey where the code
    stream has one component; sYCC turned to RGB."""
    comps, hd, space = decode_components(data, name)
    n = len(comps)
    if n not in (1, 3, 4):
        raise IOError(f"Cannot load image {name}: OpenCV reads no JPEG 2000 "
                      f"of {n} components")
    if any(s for _, s in hd.comps):
        raise IOError(f"Cannot load image {name}: OpenCV reads no signed "
                      "JPEG 2000 components")
    if hd.X0 or hd.Y0:
        raise IOError(f"Cannot load image {name}: OpenCV reads no JPEG 2000 "
                      f"with an image offset ({hd.X0}, {hd.Y0})")
    prec = max(p for p, _ in hd.comps)
    if prec > 16 or prec < 8:
        _unread(f"{prec}-bit components", name)
    if space in _UNREAD_SPACES:
        _unread(f"the colour space {_UNREAD_SPACES[space]}", name)
    if hd.palette is not None:
        comps = _apply_palette(comps, hd.palette, name)
    dtype = np.uint8 if prec <= 8 else np.uint16
    top = int(np.iinfo(dtype).max)
    # OpenCV casts each value to its type (no clipping)
    comps = [np.asarray(c).astype(dtype).astype(np.int64) for c in comps]
    if n == 1:
        if space not in (17, 18) and len(comps) >= 3:
            comps = [_grey(*comps[:3])]
        img = np.stack([comps[0]] * 3, -1)
    elif len(comps) < 3:
        img = np.stack([comps[0]] * 3, -1)
    elif space == 18:
        img = np.stack(_yuv_to_rgb(*comps[:3], top), -1)
    else:
        img = np.stack(comps[:3], -1)
    return np.ascontiguousarray(img.astype(dtype))


# ---------------------------------------------------------------------------
# writing
# ---------------------------------------------------------------------------

MIN_SIDE = 32          # OpenCV writes no .jp2 below 2^5 pixels a side
LEVELS = 5
GUARD = 2
XCB = YCB = 6


def _fdwt53_1d(x, axis):
    """Forward reversible 5/3 along an axis (first sample at an even
    coordinate): predict the odd samples, then update the even ones."""
    x = np.moveaxis(x, axis, 0).copy()
    n = x.shape[0]
    if n > 1:
        i = np.arange(n)
        lo, hi = i[0::2], i[1::2]
        x[hi] -= (x[_mirror(hi - 1, n)] + x[_mirror(hi + 1, n)]) >> 1
        x[lo] += (x[_mirror(lo - 1, n)] + x[_mirror(lo + 1, n)] + 2) >> 2
    return np.moveaxis(x, 0, axis)


def _synthesis_norms():
    """Squared L2 norms of the 5/3 synthesis basis functions: [level 1-5]
    x (low, high), from a float inverse of an impulse."""
    out = np.zeros((LEVELS + 1, 2))
    n = 1 << (LEVELS + 6)
    for level in range(1, LEVELS + 1):
        for kind in (0, 1):
            sig = np.zeros(n)
            size = n >> level
            sig[(size >> 1) + (size if kind else 0)] = 1.0
            for lv in range(level, 0, -1):
                m = n >> (lv - 1)
                half = m >> 1
                x = np.zeros(m)
                x[0::2], x[1::2] = sig[:half], sig[half:m]
                i = np.arange(m)
                lo, hi = i[0::2], i[1::2]
                x[lo] -= (x[_mirror(lo - 1, m)] + x[_mirror(lo + 1, m)]) / 4
                x[hi] += (x[_mirror(hi - 1, m)] + x[_mirror(hi + 1, m)]) / 2
                sig[:m] = x
            out[level, kind] = float((sig ** 2).sum())
    return out


class _BitWriter:
    """Packet-header bits, MSB first, 7 bits in a byte after 0xFF; a
    header ending on 0xFF gets a zero byte, as a reader aligns past it."""

    def __init__(self):
        self.out = bytearray()
        self.cur = self.n = 0
        self.cap = 8

    def put(self, b):
        self.cur = (self.cur << 1) | b
        self.n += 1
        if self.n == self.cap:
            self.out.append(self.cur)
            self.cap = 7 if self.cur == 0xFF else 8
            self.cur = self.n = 0

    def bits(self, v, n):
        for i in range(n - 1, -1, -1):
            self.put((v >> i) & 1)

    def flush(self):
        if self.n:
            self.out.append(self.cur << (self.cap - self.n))
        if self.out and self.out[-1] == 0xFF:
            self.out.append(0)
        return bytes(self.out)


def _put_passes(bw, n):
    if n == 1:
        bw.put(0)
    elif n == 2:
        bw.bits(2, 2)
    elif n <= 5:
        bw.bits(0xC | (n - 3), 4)
    elif n <= 36:
        bw.bits((0xF << 5) | (n - 6), 9)
    else:
        bw.bits((0x1FF << 7) | (n - 37), 16)


def _packet(bands, take):
    """One packet of the only layer: header and body. bands: per band
    (cw, ch, [(lane, planes)] in raster order, Mb); take[lane] = (passes,
    bytes of the stream)."""
    if not any(take[lane][0] for band in bands for lane, _ in band[2]):
        return b"\0"
    bw = _BitWriter()
    bw.put(1)
    body = []
    for cw, ch, members, m in bands:
        incl, zbp = _TagTree(cw, ch), _TagTree(cw, ch)
        incl.set([0 if take[lane][0] else 1 for lane, _ in members])
        zbp.set([m - planes for _, planes in members])
        for leaf, (lane, planes) in enumerate(members):
            n, data = take[lane]
            incl.encode(bw, leaf, 1)
            if not n:
                continue
            zbp.encode(bw, leaf, 1 << 20)
            _put_passes(bw, n)
            need = max(len(data).bit_length() - (n.bit_length() - 1), 3)
            for _ in range(need - 3):
                bw.put(1)
            bw.put(0)
            bw.bits(len(data), need + n.bit_length() - 1)
            body.append(data)
    return bw.flush() + b"".join(body)


def _hull(rates, dist):
    """Truncation points (pass counts) on the lower convex hull of a
    block's (bytes, distortion) pairs, with the slope that reaches each:
    ([0, k1, k2, ...], [inf, s1, s2, ...]) slopes decreasing."""
    R = np.concatenate([[0], rates]).astype(np.float64)
    pts, slopes = [0], [np.inf]
    for k in range(1, len(R)):
        if dist[k] >= dist[pts[-1]]:
            continue
        while True:
            j = pts[-1]
            if R[k] <= R[j]:
                s = np.inf
            else:
                s = (dist[j] - dist[k]) / (R[k] - R[j])
            if len(pts) > 1 and s >= slopes[-1]:
                pts.pop()
                slopes.pop()
                continue
            break
        pts.append(k)
        slopes.append(s)
    return pts, slopes


COMMENT = b"Created by ignis_tpu_torch"


def encode_jp2(rgb) -> bytes:
    """A .jp2 of uint8 [h, w, 3] RGB as OpenCV writes it by default: one
    tile, LRCP, one layer, no component transform, five levels of the
    reversible 5/3, 64 x 64 code-blocks, no quantisation, and the code
    stream cut by PCRD-opt to at most h * w * 3 / 4 bytes (lossless where
    the whole stream fits)."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    h, w, nc = rgb.shape
    if h < MIN_SIDE or w < MIN_SIDE:
        raise ValueError(f"JPEG 2000: {w} x {h} is below {MIN_SIDE} pixels "
                         "a side, where OpenCV writes no file")
    budget = h * w * 3 // 4
    norms = _synthesis_norms()
    # bands per component: resolution 0 the LL, then HL, LH, HH from the
    # coarsest level; eps = 8 + the band's gain
    shapes, orient, planes, coeffs, weight = [], [], [], [], []
    layout = []          # [c][r] -> [(cw, ch, [(lane, planes)], Mb)]
    for c in range(nc):
        a = rgb[..., c].astype(np.int64) - 128
        bands = []
        for _ in range(LEVELS):
            a = _fdwt53_1d(_fdwt53_1d(a, 0), 1)
            bands.append((a[0::2, 1::2], a[1::2, 0::2], a[1::2, 1::2]))
            a = a[0::2, 0::2]
        res = [[(0, a, LEVELS)]] + [
            [(k + 1, arr, LEVELS - r) for k, arr in enumerate(bands[
                LEVELS - 1 - r])] for r in range(LEVELS)]
        comp = []
        for r, rbands in enumerate(res):
            rl = []
            for o, arr, level in rbands:
                mb = GUARD + 8 + (0, 1, 1, 2)[o] - 1
                # squared norm of the band's synthesis: x high for HL
                # and HH, y high for LH and HH
                wgt = norms[level, o & 1] * norms[level, o >> 1]
                bh, bw = arr.shape
                cw, ch = _ceildiv(bw, 1 << XCB), _ceildiv(bh, 1 << YCB)
                members = []
                for j in range(cw * ch):
                    y0, x0 = (j // cw) << YCB, (j % cw) << XCB
                    blk = arr[y0:y0 + (1 << YCB), x0:x0 + (1 << XCB)]
                    p = int(np.abs(blk).max()).bit_length() if blk.size \
                        else 0
                    if p > mb:
                        raise ValueError("JPEG 2000: coefficient range")
                    members.append((len(shapes), p))
                    shapes.append(blk.shape)
                    orient.append(o)
                    planes.append(p)
                    coeffs.append(blk)
                    weight.append(wgt)
                rl.append((cw, ch, members, mb))
            comp.append(rl)
        layout.append(comp)
    streams, rates, hulls = [], [], []
    for k in range(0, len(shapes), LANES):
        cb = CodeBlocks(shapes[k:k + LANES], orient[k:k + LANES],
                        planes[k:k + LANES],
                        [3 * p - 2 for p in planes[k:k + LANES]])
        s, r = cb.encode(coeffs[k:k + LANES])
        streams += s
        rates += r
        hulls += [_hull(r[i], cb.dist[i, :len(r[i]) + 1] * weight[k + i])
                  for i in range(len(s))]

    def stream_for(lam):
        take = []
        for i, (pts, slopes) in enumerate(hulls):
            k = 0
            for p, s in zip(pts, slopes):
                if s >= lam:
                    k = p
            take.append((k, streams[i][:rates[i][k - 1]] if k else b""))
        return _codestream(h, w, nc, layout, take)

    full = [(len(r), s) for r, s in zip(rates, streams)]
    cs = _codestream(h, w, nc, layout, full)
    if len(cs) > budget:
        finite = [s for _, sl in hulls for s in sl[1:] if np.isfinite(s)]
        lo = min(finite) / 2 if finite else 1.0
        hi = max(finite) * 2 if finite else 1.0
        cs = stream_for(hi)
        for _ in range(40):
            mid = np.sqrt(lo * hi)
            trial = stream_for(mid)
            if len(trial) <= budget:
                hi, cs = mid, trial
            else:
                lo = mid
    return _jp2_boxes(cs, h, w, nc)


def _codestream(h, w, nc, layout, take):
    siz = struct.pack(">HH8IH", 38 + 3 * nc, 0, w, h, 0, 0, w, h, 0, 0, nc) \
        + bytes([7, 1, 1]) * nc
    cod = struct.pack(">HBBHBBBBBB", 12, 0, 0, 1, 0, LEVELS, XCB - 2,
                      YCB - 2, 0, 1)
    eps = [8] + [8 + g for _ in range(LEVELS) for g in (1, 1, 2)]
    qcd = struct.pack(">HB", 3 + len(eps), GUARD << 5) + bytes(
        e << 3 for e in eps)
    com = struct.pack(">HH", 4 + len(COMMENT), 1) + COMMENT
    packets = b"".join(_packet(layout[c][r], take)
                       for r in range(LEVELS + 1) for c in range(nc))
    sot = struct.pack(">HHIBB", 10, 0, 12 + 2 + len(packets), 0, 1)
    return (b"\xff\x4f\xff\x51" + siz + b"\xff\x52" + cod + b"\xff\x5c"
            + qcd + b"\xff\x64" + com + b"\xff\x90" + sot + b"\xff\x93"
            + packets + b"\xff\xd9")


def _box(kind, body):
    return struct.pack(">I", 8 + len(body)) + kind + body


def _jp2_boxes(cs, h, w, nc):
    ihdr = _box(b"ihdr", struct.pack(">IIHBBBB", h, w, nc, 7, 7, 0, 0))
    colr = _box(b"colr", struct.pack(">BBBI", 1, 0, 0, 16))
    return (JP2_SIGNATURE + _box(b"ftyp", b"jp2 \0\0\0\0jp2 ")
            + _box(b"jp2h", ihdr + colr) + _box(b"jp2c", cs))
