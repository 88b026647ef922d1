"""Write the JPEG 2000 fixtures of OpenJPEG's own encoder: the Part 1
features beyond cv2's default .jp2 that the port reads as cv2 reads
them, and the files cv2 reads nothing of.

The encoder is libopenjp2, driven through ctypes: Pillow's bundled copy
(pillow.libs/libopenjp2-*.so*, OpenJPEG 2.5.4), else the system's
libopenjp2.so.7. No header is at hand, so the fields of
`opj_cparameters_t` are found by their int32 word: the defaults that
`opj_set_default_encoder_parameters` writes are checked first, and the
script refuses to write anything if a field is not where it expects.
Run from the repository's root:

    python scripts/make_jp2_fixtures.py

Into tests/data/images, each also added to `cv2_pixels.npz` as cv2.imread
reads it (IMREAD_UNCHANGED | ANYDEPTH | ANYCOLOR, grey replicated, alpha
dropped; the other entries stay as they are):
- `opj_style01` ... `opj_style20`: one Part 1 code-block style each
  (bypass, context reset, termination on each pass, vertically causal
  context, predictable termination, segmentation symbols), two quality
  layers (the second lossless) so that a block's passes and segments
  span packets; `opj_style3f` all six at once;
- `opj_bypass_termall_53` and `_97`: bypass with termination on each
  pass, three lossy layers, the reversible 5/3 and the irreversible 9/7
  with the colour transform;
- `opj_sop`, `opj_eph`, `opj_sop_eph`: SOP marker segments and EPH
  markers;
- `opj_poc`: three progression volumes (by resolution and component)
  over two layers; `opj_poc_tileparts`: 2 x 2 tiles, each with two
  volumes, in tile-parts by layer; `opj_poc_cut`: volumes that leave
  two components' top two resolutions out (invalid under T.800, read by
  cv2 as OpenJPEG rebuilds them: up to the resolution decoded);
- `opj_rgn_comp0`: an RGN marker (maxshift 5) for component 0, as the
  encoder writes it (it shifts no coefficient itself); `opj_rgn_all`:
  the same file with RGN markers for components 1 and 2 inserted by hand;
- `opj_grey16_bypass_rgn`: 16-bit grey with bypass and RGN;
- `opj_ppm`, `opj_ppt`: an SOP+EPH file rewritten with its packet
  headers (and their EPH) in PPM markers in the main header, or in PPT
  markers in each tile-part's header (T.800 A.7.4-A.7.5); the SOP
  segments and the packet bodies stay in the bit stream;
- `opj_palette8`: an 8-bit index under `pclr` (256 entries of 3 x 8
  bits) and `cmap` boxes written here, which cv2 reads as the grey of the
  palette's colours; `opj_palette16_index` (a 16-bit index, read as
  uint16) and `opj_palette16_entries` (16-bit entries under an 8-bit
  index, which cv2 casts to uint8);
- `opj_sycc`: colour space sYCC (enumcs 18), which cv2 turns to RGB;
- `opj_texture_64`: the 64 x 64 texture of chip_smoke.py's phase 16,
  with bypass and termination on each pass, SOP and EPH, two progression
  volumes, three layers, 2 x 2 tiles in tile-parts by layer and PPT
  markers.

Into tests/data/images_unread, the files cv2 reads nothing of (it logs
why): sYCC 4:2:0 (`opj_sycc420`, "tiles are not supported"), e-sYCC
(`opj_esycc`) and CMYK (`opj_cmyk`, "Unsupported color space
conversion"), a Part 2 array-based component transform (`opj_mct_part2`,
which OpenJPEG refuses: "Invalid multiple component transformation"),
17-bit components (`opj_17bit`, "output precision > 16 not supported")
and 4-bit ones (`opj_4bit`, below 8 bits).

The encoder writes no HT code-blocks (style 0x40), so HTJ2K has no
fixture.
"""
import ctypes
import ctypes.util
import io
import os
import struct
import sys
import tempfile
from pathlib import Path

import cv2
import numpy as np
import PIL

DATA = Path(__file__).resolve().parent.parent / "tests" / "data"
OUT = DATA / "images"
UNREAD = DATA / "images_unread"
FLAGS = cv2.IMREAD_UNCHANGED | cv2.IMREAD_ANYDEPTH | cv2.IMREAD_ANYCOLOR

# opj_cparameters_t by int32 word (OpenJPEG 2.x, x86-64)
SIZE = 18720
W_TILE_ON, W_TDX, W_TDY = 0, 3, 4
W_DISTO_ALLOC, W_CSTY, W_PROG = 5, 12, 13
W_POC, POC_WORDS, W_NUMPOCS = 14, 37, 1198
W_LAYERS, W_RATES = 1199, 1200
W_NUMRES, W_CBW, W_CBH, W_MODE, W_IRREV = 1400, 1401, 1402, 1403, 1404
W_ROI_COMP, W_ROI_SHIFT = 1405, 1406
W_SUBX, W_SUBY = 4549, 4550
# and by byte: tp_on, tp_flag, tcp_mct (chars after cp_rsiz, word 4673)
B_TP_ON, B_TP_FLAG, B_MCT = 18696, 18697, 18698
# opj_poc_t fields, by word in the entry
POC_RES0, POC_COMP0, POC_LAY1, POC_RES1, POC_COMP1, POC_PRG1 = 0, 1, 2, 3, 4, 8
POC_TILE = 12
# defaults that must be found where the words above say (the words
# between them, mode and irreversible between the code-block size and
# roi_compno, hold 0)
DEFAULTS = {W_NUMRES: 6, W_CBW: 64, W_CBH: 64, W_MODE: 0, W_IRREV: 0,
            W_ROI_COMP: -1, W_ROI_SHIFT: 0, W_SUBX: 1, W_SUBY: 1,
            4551: -1, 4552: -1}
LRCP, RLCP, RPCL, PCRL, CPRL = range(5)
SRGB, GREY, SYCC, EYCC, CMYK = 1, 2, 3, 4, 5


def _library():
    libs = Path(PIL.__file__).resolve().parent.parent / "pillow.libs"
    found = sorted(libs.glob("libopenjp2-*.so*"))
    name = str(found[0]) if found else (ctypes.util.find_library("openjp2")
                                        or "libopenjp2.so.7")
    lib = ctypes.CDLL(name)
    vp, u32 = ctypes.c_void_p, ctypes.c_uint32
    for fn, args, res in (
            ("opj_set_default_encoder_parameters", [vp], None),
            ("opj_image_create", [u32, vp, ctypes.c_int], vp),
            ("opj_create_compress", [ctypes.c_int], vp),
            ("opj_setup_encoder", [vp, vp, vp], ctypes.c_int),
            ("opj_stream_create_default_file_stream",
             [ctypes.c_char_p, ctypes.c_int], vp),
            ("opj_start_compress", [vp, vp, vp], ctypes.c_int),
            ("opj_encode", [vp, vp], ctypes.c_int),
            ("opj_end_compress", [vp, vp], ctypes.c_int),
            ("opj_stream_destroy", [vp], None),
            ("opj_destroy_codec", [vp], None),
            ("opj_image_destroy", [vp], None),
            ("opj_set_MCT", [vp, vp, vp, u32], ctypes.c_int),
            ("opj_version", [], ctypes.c_char_p)):
        f = getattr(lib, fn)
        f.argtypes, f.restype = args, res
    return lib, name


LIB, LIB_NAME = _library()


def default_parameters():
    """opj_cparameters_t as OpenJPEG's defaults fill it, checked against
    DEFAULTS word by word (every other word 0, nothing past SIZE)."""
    buf = (ctypes.c_uint8 * (SIZE + 64))()
    ctypes.memset(buf, 0x5A, SIZE + 64)
    LIB.opj_set_default_encoder_parameters(buf)
    words = np.frombuffer(buf, np.int32, SIZE // 4)
    if bytes(buf[SIZE:]) != b"\x5a" * 64:
        raise SystemExit("opj_cparameters_t is larger than expected")
    found = {int(i): int(words[i]) for i in np.nonzero(words)[0]}
    if found != {k: v for k, v in DEFAULTS.items() if v}:
        raise SystemExit(f"opj_cparameters_t defaults {found} are not "
                         f"{DEFAULTS}: the field offsets do not hold")
    return buf


def encode(comps, space=SRGB, jp2=True, prec=8, sub=None, size=None,
           layers=(), mode=0, irreversible=False, csty=0, prog=LRCP,
           numres=6, cblk=(64, 64), tiles=None, pocs=(), tileparts=None,
           roi=None, mct=0, matrix=None):
    """A file of OpenJPEG's encoder: comps (int arrays, each already
    subsampled by its entry of `sub`) of `prec` bits in colour space
    `space`; `layers` the compression ratios of the quality layers (0 the
    lossless last; none: one lossless layer); `pocs` (resno0, compno0,
    layno1, resno1, compno1, progression, tile) each; `tileparts` the
    tp_flag ('R', 'L' or 'C'); roi (component, shift); mct 1 for the
    RCT / ICT, 2 for the array `matrix` (Part 2)."""
    buf = default_parameters()
    w = np.frombuffer(buf, np.int32, SIZE // 4)
    w[W_NUMRES], (w[W_CBW], w[W_CBH]) = numres, cblk
    w[W_MODE], w[W_IRREV], w[W_CSTY], w[W_PROG] = mode, irreversible, csty, \
        prog
    if layers:
        w[W_DISTO_ALLOC], w[W_LAYERS] = 1, len(layers)
        w[W_RATES:W_RATES + len(layers)] = np.array(
            layers, np.float32).view(np.int32)
    if tiles:
        w[W_TILE_ON], w[W_TDX], w[W_TDY] = 1, tiles[0], tiles[1]
    for i, (r0, c0, l1, r1, c1, prg, tile) in enumerate(pocs):
        at = W_POC + POC_WORDS * i
        for off, v in ((POC_RES0, r0), (POC_COMP0, c0), (POC_LAY1, l1),
                       (POC_RES1, r1), (POC_COMP1, c1), (POC_PRG1, prg),
                       (POC_TILE, tile)):
            w[at + off] = v
    w[W_NUMPOCS] = len(pocs)
    if roi:
        w[W_ROI_COMP], w[W_ROI_SHIFT] = roi
    if tileparts:
        buf[B_TP_ON], buf[B_TP_FLAG] = 1, ord(tileparts)
    buf[B_MCT] = mct
    n = len(comps)
    H, W = size or comps[0].shape
    sub = sub or [(1, 1)] * n
    parms = (ctypes.c_uint32 * (9 * n))()
    for c, a in enumerate(comps):
        parms[9 * c:9 * c + 9] = [sub[c][0], sub[c][1], a.shape[1],
                                  a.shape[0], 0, 0, prec, prec, 0]
    img = LIB.opj_image_create(n, parms, space)
    # opj_image_t: x0, y0, x1, y1, numcomps, color_space, then comps; an
    # opj_image_comp_t is 64 bytes with its data pointer at 48
    ctypes.memmove(img + 8, struct.pack("<II", W, H), 8)
    comp_at = ctypes.cast(img + 24, ctypes.POINTER(ctypes.c_void_p))[0]
    for c, a in enumerate(comps):
        data = ctypes.cast(comp_at + 64 * c + 48,
                           ctypes.POINTER(ctypes.c_void_p))[0]
        arr = np.ascontiguousarray(a, np.int32)
        ctypes.memmove(data, arr.ctypes.data, arr.nbytes)
    if matrix is not None:
        m = np.ascontiguousarray(matrix, np.float32)
        shift = np.zeros(n, np.int32)
        if not LIB.opj_set_MCT(buf, m.ctypes.data, shift.ctypes.data, n):
            raise SystemExit("opj_set_MCT failed")
    codec = LIB.opj_create_compress(2 if jp2 else 0)
    fd, path = tempfile.mkstemp(suffix=".jp2")
    os.close(fd)
    try:
        if not LIB.opj_setup_encoder(codec, buf, img):
            raise SystemExit("opj_setup_encoder failed")
        stream = LIB.opj_stream_create_default_file_stream(path.encode(), 0)
        ok = (LIB.opj_start_compress(codec, img, stream)
              and LIB.opj_encode(codec, stream)
              and LIB.opj_end_compress(codec, stream))
        LIB.opj_stream_destroy(stream)
        if not ok:
            raise SystemExit("OpenJPEG's encoder failed")
        return Path(path).read_bytes()
    finally:
        LIB.opj_destroy_codec(codec)
        LIB.opj_image_destroy(img)
        os.unlink(path)


# ---- code streams taken apart and put together ---------------------------

def _segment(code, body):
    return struct.pack(">HH", code, 2 + len(body)) + body


def split_codestream(cs):
    """(main header markers, [(SOT body, tile-part header markers, data)])
    of a code stream: each marker a (code, body) pair."""
    assert cs[:2] == b"\xff\x4f"
    pos, main, parts, cur = 2, [], [], None
    while pos < len(cs):
        code = struct.unpack(">H", cs[pos:pos + 2])[0]
        if code == 0xFFD9:
            break
        length = struct.unpack(">H", cs[pos + 2:pos + 4])[0]
        body = cs[pos + 4:pos + 2 + length]
        if code == 0xFF90:
            psot = struct.unpack(">I", body[2:6])[0]
            cur = [body, [], None]
            parts.append(cur)
            end = pos + psot
        elif code == 0xFF93:
            cur[2] = cs[pos + 2:end]
            pos = end
            continue
        else:
            (main if cur is None else cur[1]).append((code, body))
        pos += 2 + length
    return main, parts


def join_codestream(main, parts):
    out = b"\xff\x4f" + b"".join(_segment(c, b) for c, b in main)
    for sot, markers, data in parts:
        head = b"".join(_segment(c, b) for c, b in markers)
        psot = 12 + len(head) + 2 + len(data)
        out += _segment(0xFF90, sot[:2] + struct.pack(">I", psot) + sot[6:])
        out += head + b"\xff\x93" + data
    return out + b"\xff\xd9"


def packets(data):
    """The packets of a tile-part of an SOP+EPH stream: (header with its
    EPH, body) each, the SOP segment dropped; no 0xFF91 or 0xFF92 can
    occur inside a header or a body (bit and byte stuffing)."""
    out = []
    starts = [i for i in range(len(data) - 1)
              if data[i] == 0xFF and data[i + 1] == 0x91]
    if data and (not starts or starts[0]):
        raise ValueError("not an SOP stream")
    for k, s in enumerate(starts):
        end = starts[k + 1] if k + 1 < len(starts) else len(data)
        eph = data.index(b"\xff\x92", s + 6) + 2
        if eph > end:
            raise ValueError("a packet without its EPH")
        out.append((data[s + 6:eph], data[eph:end]))
    return out


def _sop(n):
    return struct.pack(">HHH", 0xFF91, 4, n & 0xFFFF)


def packed(data, where):
    """An SOP+EPH .jp2 rewritten with its packet headers in PPM markers
    (where == 'ppm') or in PPT markers of each tile-part ('ppt'); the SOP
    segments (renumbered in each tile) and the bodies stay."""
    at = data.index(b"jp2c") - 4
    cs = data[at + 8:]
    main, parts = split_codestream(cs)
    ppm, seen, zppt = b"", {}, {}
    new_parts = []
    for sot, markers, tdata in parts:
        tile = struct.unpack(">H", sot[:2])[0]
        pk = packets(tdata)
        heads = b"".join(h for h, _ in pk)
        body = b""
        for h, b in pk:
            body += _sop(seen.get(tile, 0)) + b
            seen[tile] = seen.get(tile, 0) + 1
        if where == "ppm":
            ppm += struct.pack(">I", len(heads)) + heads
            new_parts.append((sot, markers, body))
        else:
            ppt = []
            for i in range(0, len(heads), 65000):
                ppt.append((0xFF61, bytes([zppt.get(tile, 0)])
                            + heads[i:i + 65000]))
                zppt[tile] = zppt.get(tile, 0) + 1
            new_parts.append((sot, markers + ppt, body))
    if where == "ppm":
        main = main + [(0xFF60, bytes([z]) + ppm[i:i + 65000])
                       for z, i in enumerate(range(0, len(ppm), 65000))]
    cs = join_codestream(main, new_parts)
    return data[:at] + struct.pack(">I", 8 + len(cs)) + b"jp2c" + cs


def with_rgn(data, comps, shift):
    """data with an RGN marker (maxshift `shift`) for each of `comps`
    added to the main header."""
    at = data.index(b"jp2c") - 4
    main, parts = split_codestream(data[at + 8:])
    main = main + [(0xFF5E, bytes([c, 0, shift])) for c in comps]
    cs = join_codestream(main, parts)
    return data[:at] + struct.pack(">I", 8 + len(cs)) + b"jp2c" + cs


def _box(kind, body):
    return struct.pack(">I", 8 + len(body)) + kind + body


def palette_jp2(index, prec, entries, bits):
    """A .jp2 of a one-component index code stream under `pclr` (entries
    [n, 3] of `bits` bits) and `cmap` boxes, colour space sRGB."""
    cs = encode([index], jp2=False, prec=prec)
    h, w = index.shape
    ne, npc = entries.shape
    nbytes = (bits + 7) // 8
    pclr = struct.pack(">HB", ne, npc) + bytes([bits - 1] * npc) + b"".join(
        int(v).to_bytes(nbytes, "big") for v in entries.ravel())
    cmap = b"".join(struct.pack(">HBB", 0, 1, i) for i in range(npc))
    jp2h = (_box(b"ihdr", struct.pack(">IIHBBBB", h, w, 1, prec - 1, 7, 0, 0))
            + _box(b"colr", struct.pack(">BBBI", 1, 0, 0, 16))
            + _box(b"pclr", pclr) + _box(b"cmap", cmap))
    return (b"\0\0\0\x0cjP  \r\n\x87\n" + _box(b"ftyp", b"jp2 \0\0\0\0jp2 ")
            + _box(b"jp2h", jp2h) + _box(b"jp2c", cs))


# ---- sources -------------------------------------------------------------

def photo(h, w, seed, noise=10.0, scale=255):
    """[h, w, 3] int32 in [0, scale]: colour waves with noise and a flat
    square (many bit-planes, runs and flat blocks)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([0.5 + 0.4 * np.sin(xx / (5.0 + c) + c)
                    * np.cos(yy / 7.0 - c) for c in range(3)], -1)
    img = img * 255 + rng.normal(0, noise, img.shape)
    img[h // 4:h // 2, w // 4:w // 2] = 240
    return (np.clip(img, 0, 255) * (scale / 255.0)).astype(np.int32)


def planes(img):
    return [img[..., c] for c in range(img.shape[2])]


def _poc_file():
    return encode(planes(photo(40, 48, 43)), layers=(20, 0), pocs=(
        (0, 0, 2, 3, 3, RLCP, 1), (3, 0, 2, 6, 2, CPRL, 1),
        (3, 2, 2, 6, 3, PCRL, 1)), numres=6, cblk=(16, 16))


def _poc_cut():
    """Volumes that leave components 1 and 2 at 4 of their 6 resolutions
    (invalid under T.800): OpenJPEG rebuilds those two only up to
    resolution 3 and puts that 12 x 10 picture at the canvas's corner."""
    return encode(planes(photo(40, 48, 43)), layers=(20, 0), pocs=(
        (0, 0, 2, 3, 3, RLCP, 1), (3, 0, 2, 6, 1, CPRL, 1),
        (3, 1, 2, 4, 3, PCRL, 1)), numres=6, cblk=(16, 16))


# The encoder starts a volume that ends at a later layer than the one
# before it at its own end layer (opj_pi_update_encode_poc_and_final), so
# the packets of a volume split by layers are never written: the volumes
# here split resolutions and components, each over every layer. It also
# fails, or loses packets, under tile-parts by resolution or component
# with a POC; tile-parts by layer ('L') hold.
def _poc_tiles():
    vols = ((0, 0, 2, 2, 3, RPCL), (2, 0, 2, 4, 3, LRCP))
    return encode(planes(photo(48, 56, 44)), layers=(16, 0), tiles=(32, 24),
                  pocs=[v + (t,) for t in range(1, 5) for v in vols],
                  tileparts="L", numres=4, cblk=(16, 16))


def _texture():
    vols = ((0, 0, 3, 2, 3, CPRL), (2, 0, 3, 5, 3, LRCP))
    return packed(encode(planes(photo(64, 64, 45, noise=6.0)),
                         layers=(24, 8, 0), mode=0x05, csty=6, tiles=(32, 32),
                         pocs=[v + (t,) for t in range(1, 5) for v in vols],
                         tileparts="L", numres=5, cblk=(16, 16), mct=1),
                  "ppt")


def _palette(kind, seed=46):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:40, 0:48]
    idx = ((xx * 5 + yy * 3 + (xx * yy) // 7) % 256).astype(np.int32)
    pal = rng.integers(0, 256, (256, 3))
    if kind == 8:
        return palette_jp2(idx, 8, pal, 8)
    if kind == "index16":
        return palette_jp2((idx * 4 + 1) % 1024, 16,
                           rng.integers(0, 256, (1024, 3)), 8)
    return palette_jp2(idx, 8, pal * 251 + rng.integers(0, 251, pal.shape),
                       16)


def _grey16():
    g = photo(40, 48, 47, scale=65535)[..., 1]
    return encode([g], space=GREY, prec=16, mode=0x01, roi=(0, 5),
                  layers=(6, 0))


def _sub420():
    img = photo(40, 48, 48)
    return encode([img[..., 0], img[..., 1][::2, ::2], img[..., 2][::2, ::2]],
                  space=SYCC, sub=[(1, 1), (2, 2), (2, 2)], size=(40, 48))


RGB = lambda seed: planes(photo(40, 48, seed))  # noqa: E731
STYLE_LAYERS = dict(layers=(12, 0), cblk=(32, 32))

FIXTURES = {
    **{f"opj_style{m:02x}.jp2": (lambda m=m: encode(
        RGB(30 + m), mode=m, mct=1, **STYLE_LAYERS))
       for m in (0x01, 0x02, 0x04, 0x08, 0x10, 0x20)},
    "opj_style3f.jp2": lambda: encode(RGB(31), mode=0x3F, mct=1,
                                      **STYLE_LAYERS),
    "opj_bypass_termall_53.jp2": lambda: encode(
        RGB(32), mode=0x05, layers=(40, 20, 8), cblk=(16, 16)),
    "opj_bypass_termall_97.jp2": lambda: encode(
        RGB(33), mode=0x05, layers=(40, 20, 8), irreversible=True, mct=1,
        cblk=(32, 16)),
    "opj_sop.jp2": lambda: encode(RGB(34), csty=2, layers=(16, 0)),
    "opj_eph.jp2": lambda: encode(RGB(35), csty=4, layers=(16, 0)),
    "opj_sop_eph.jp2": lambda: encode(RGB(36), csty=6, layers=(16, 0),
                                      prog=RPCL),
    "opj_poc.jp2": _poc_file,
    "opj_poc_tileparts.jp2": _poc_tiles,
    "opj_poc_cut.jp2": _poc_cut,
    "opj_rgn_comp0.jp2": lambda: encode(RGB(37), roi=(0, 5)),
    "opj_rgn_all.jp2": lambda: with_rgn(encode(RGB(38), roi=(0, 5),
                                               layers=(10, 0)), (1, 2), 5),
    "opj_grey16_bypass_rgn.jp2": _grey16,
    "opj_ppm.jp2": lambda: packed(encode(RGB(39), csty=6, layers=(20, 6, 0),
                                         cblk=(16, 16)), "ppm"),
    "opj_ppt.jp2": lambda: packed(encode(RGB(40), csty=6, layers=(20, 0),
                                         tiles=(32, 24), tileparts="R",
                                         numres=4), "ppt"),
    "opj_palette8.jp2": lambda: _palette(8),
    "opj_palette16_index.jp2": lambda: _palette("index16"),
    "opj_palette16_entries.jp2": lambda: _palette("entries16"),
    "opj_sycc.jp2": lambda: encode(RGB(41), space=SYCC),
    "opj_texture_64.jp2": _texture,
}

UNREAD_FIXTURES = {
    "opj_sycc420.jp2": _sub420,
    "opj_esycc.jp2": lambda: encode(RGB(49), space=EYCC),
    "opj_cmyk.jp2": lambda: encode(RGB(50) + [RGB(50)[0] // 2], space=CMYK),
    "opj_mct_part2.jp2": lambda: encode(RGB(51), mct=2, matrix=[
        [0.5, 0.3, 0.2], [0.1, 0.8, 0.1], [0.2, 0.2, 0.6]]),
    "opj_17bit.jp2": lambda: encode([c * 512 for c in RGB(52)], prec=17),
    "opj_4bit.jp2": lambda: encode([c >> 4 for c in RGB(53)], prec=4),
}


def cv2_rgb(data):
    img = cv2.imdecode(np.frombuffer(data, np.uint8), FLAGS)
    if img is None:
        return None
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, -1)
    return np.ascontiguousarray(img[..., 2::-1])


def check_poc_layout():
    """The POC fields land where the POC words say: a file of two
    volumes carries them back in its POC marker."""
    data = encode(RGB(1), layers=(20, 0), pocs=(
        (1, 0, 1, 4, 3, CPRL, 1), (0, 1, 2, 6, 3, RPCL, 1)))
    at = data.index(b"\xff\x5f")
    n = struct.unpack(">H", data[at + 2:at + 4])[0]
    vols = [struct.unpack(">BBHBBB", data[at + 4 + 7 * i:at + 11 + 7 * i])
            for i in range((n - 2) // 7)]
    if vols[:2] != [(1, 0, 1, 4, 3, CPRL), (0, 1, 2, 6, 3, RPCL)]:
        raise SystemExit(f"opj_poc_t fields are not where expected: {vols}")


def main() -> None:
    print(f"{LIB_NAME}: OpenJPEG {LIB.opj_version().decode()}")
    check_poc_layout()
    OUT.mkdir(parents=True, exist_ok=True)
    UNREAD.mkdir(parents=True, exist_ok=True)
    npz = OUT / "cv2_pixels.npz"
    pixels = dict(np.load(npz)) if npz.exists() else {}
    for name, make in FIXTURES.items():
        data = make()
        px = cv2_rgb(data)
        if px is None:
            raise SystemExit(f"cv2 reads nothing of {name}")
        (OUT / name).write_bytes(data)
        pixels[name] = px
        print(f"{name}: {len(data)} bytes, {px.shape} {px.dtype}")
    for name, make in UNREAD_FIXTURES.items():
        data = make()
        if cv2_rgb(data) is not None:
            raise SystemExit(f"cv2 reads {name}")
        (UNREAD / name).write_bytes(data)
        print(f"{name}: {len(data)} bytes, cv2 reads nothing")
    buf = io.BytesIO()
    np.savez_compressed(buf, **pixels)
    npz.write_bytes(buf.getvalue())


if __name__ == "__main__":
    sys.exit(main())
