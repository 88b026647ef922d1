"""What the port's image readers refuse, against OpenCV: a file cv2 reads
nothing of raises IOError, as ignis_tpu's load_image raises for
cv2.imread's None (Radiance resolution lines other than -Y h +X w, BMP
depths and compressions, Sun raster depths and types, TGA, invalid PNG
headers), and a file cv2 reads is read as cv2 reads it (BMP bit fields
with gaps or a missing mask). No NotImplementedError is left: every
file cv2 reads the port reads, and the audit test holds that."""
import ast
import struct
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest

from ignis_tpu.utils import image as jax_image
from ignis_tpu_torch.utils import image as imagelib

FLAGS = cv2.IMREAD_UNCHANGED | cv2.IMREAD_ANYDEPTH | cv2.IMREAD_ANYCOLOR
UTILS = Path(__file__).resolve().parent.parent / "ignis_tpu_torch" / "utils"
UNREAD = Path(__file__).resolve().parent / "data" / "images_unread"

sys.path.insert(0, str(UTILS.parent.parent / "scripts"))
import make_named_fixtures as F  # noqa: E402


def _cv2(data: bytes):
    img = cv2.imdecode(np.frombuffer(data, np.uint8), FLAGS)
    if img is None:
        return None
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, -1)
    return np.ascontiguousarray(img[..., 2::-1])


def _both_raise(tmp_path, data, suffix, match=None):
    p = tmp_path / f"x{suffix}"
    p.write_bytes(data)
    with pytest.raises(IOError, match=match):
        imagelib.load_image(p)
    with pytest.raises(IOError):
        jax_image.load_image(str(p))


@pytest.mark.parametrize("line", [b"+Y 4 +X 4", b"-Y 4 -X 4", b"+X 4 -Y 4",
                                  b"+Y 4 -X 4", b"-X 4 +Y 4", b"+X 4 +Y 4"])
def test_hdr_orientations_raise_ioerror(tmp_path, line):
    """A Radiance file whose resolution line is not -Y h +X w: OpenCV's
    rgbe.c reads nothing, and the port raises IOError naming the line (it
    once raised NotImplementedError naming an empty line)."""
    data = (b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n" + line + b"\n"
            + bytes(64))
    assert _cv2(data) is None
    _both_raise(tmp_path, data, ".hdr",
                match=line.decode().replace("+", r"\+"))


def _bmp_v4(words, bpp, masks):
    """A BMP of one row of `words` with a 108-byte header holding the
    BI_BITFIELDS masks (R, G, B, A)."""
    info = struct.pack("<IiiHHIIiiII", 108, len(words), 1, 1, bpp, 3, 0,
                       2835, 2835, 0, 0) + struct.pack("<4I", *masks)
    info = info.ljust(108, b"\0")
    body = np.asarray(words, "<u4" if bpp == 32 else "<u2").tobytes()
    body = body.ljust((len(body) + 3) & ~3, b"\0")
    return (struct.pack("<2sIHHI", b"BM", 14 + 108 + len(body), 0, 0,
                        14 + 108) + info + body)


@pytest.mark.parametrize("masks", [
    (0x00F0F000, 0xF00, 0xF, 0), (0x00F0F000, 0x0F0F00, 0x0F00FF, 0),
    (0xFF0000, 0xFF00, 0, 0), (0, 0xFF00, 0xFF, 0),
    (0x7F, 0x3F80, 0x1FC000, 0),
    (0x1FF, 0x3FE00, 0x7FC0000, 0), (0x3FF00000, 0xFFC00, 0x3FF, 0)],
    ids=["gap_red", "gaps_all", "no_blue", "no_red", "7bit", "9bit",
         "10bit"])
def test_bmp_32bit_bit_fields_match_cv2(masks):
    """32-bit BI_BITFIELDS as OpenCV expands them: each channel's masked
    bits (with gaps too, which the port once refused by name) shifted to
    the mask's lowest and scaled in float32 by 255 / (mask >> shift),
    truncated; a file missing a colour's mask read as plain BGRx."""
    words = np.random.default_rng(len(str(masks))).integers(
        0, 1 << 32, 64, dtype=np.uint64)
    words[:3] = (0xFFFFFFFF, 0, 0x00A0A000)
    data = _bmp_v4(words, 32, masks)
    np.testing.assert_array_equal(imagelib.decode_bmp(data), _cv2(data))


@pytest.mark.parametrize("bpp,comp", [(16, 3), (4, 1), (8, 2), (2, 0),
                                      (0, 0), (24, 3), (8, 3), (32, 6),
                                      (24, 4), (24, 5), (1, 1), (24, 1)],
                         ids=lambda v: str(v))
def test_bmp_cv2_reads_nothing_of_raise_ioerror(tmp_path, bpp, comp):
    """BMP depths and compressions cv2 reads nothing of (16-bit fields
    with a gap, RLE of the wrong depth, 2 and 0 bits, bit fields at 24 or
    8 bits, alpha bit fields, embedded JPEG and PNG, Huffman 1-D): IOError
    from both readers."""
    if (bpp, comp) == (16, 3):
        data = _bmp_v4(np.arange(8), 16, (0x7C01, 0x3E0, 0x1E, 0))
    else:
        info = struct.pack("<IiiHHIIiiII", 40, 4, 4, 1, bpp, comp, 64, 2835,
                           2835, 0, 0)
        pal = bytes(4 << bpp) if 0 < bpp <= 8 else b""
        off = 14 + 40 + len(pal)
        data = (struct.pack("<2sIHHI", b"BM", off + 64, 0, 0, off) + info
                + pal + bytes(range(64)))
    assert _cv2(data) is None
    _both_raise(tmp_path, data, ".bmp")


@pytest.mark.parametrize("depth,kind,maptype", [
    (4, 1, 0), (16, 1, 0), (8, 4, 0), (8, 5, 0), (8, 0xFFFF, 0),
    (8, 1, 2), (2, 1, 0)], ids=lambda v: str(v))
def test_sun_raster_cv2_reads_nothing_of_raise_ioerror(tmp_path, depth, kind,
                                                       maptype):
    """Sun raster depths, types (TIFF, IFF, experimental) and raw colour
    maps cv2 reads nothing of: IOError from both readers."""
    data = struct.pack(">8I", 0x59A66A95, 4, 4, depth, 200, kind, maptype,
                       12 if maptype else 0) + bytes(12 if maptype else 0) \
        + bytes(200)
    assert _cv2(data) is None
    _both_raise(tmp_path, data, ".ras")


@pytest.mark.parametrize("kind,bpp", [(1, 8), (3, 8), (9, 8), (11, 8),
                                      (2, 16), (10, 15)],
                         ids=lambda v: str(v))
def test_tga_types_raise_ioerror(tmp_path, kind, bpp):
    """TGA types the port does not read (colour-mapped, grey, their RLE
    forms, 15- and 16-bit truecolour): IOError, as ignis_tpu raises for
    every TGA (cv2 5.0.0 has no TGA codec)."""
    data = struct.pack("<BBBHHBHHHHBB", 0, int(kind in (1, 9)), kind, 0,
                       256 if kind in (1, 9) else 0, 24, 0, 0, 4, 4, bpp,
                       0) + bytes(800)
    _both_raise(tmp_path, data, ".tga", match="TGA")


@pytest.mark.parametrize("color,depth,interlace", [
    (2, 4, 0), (3, 16, 0), (0, 8, 2), (7, 8, 0), (4, 2, 0)],
    ids=lambda v: str(v))
def test_invalid_png_headers_raise_ioerror(tmp_path, color, depth,
                                           interlace):
    """PNG headers the PNG specification forbids (RGB below 8 bits, a
    16-bit palette, interlace method 2, colour type 7, grey-and-alpha
    at 2 bits): libpng refuses them, and the port raises IOError."""
    import zlib

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))
    data = (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", 4, 4, depth, color, 0,
                                         0, interlace))
            + chunk(b"PLTE", bytes(12)) + chunk(b"IDAT", zlib.compress(
                bytes(64))) + chunk(b"IEND", b""))
    assert _cv2(data) is None
    _both_raise(tmp_path, data, ".png")


def test_refusals_by_name_are_the_listed_ones():
    """No `raise NotImplementedError` is left under ignis_tpu_torch/utils:
    every file cv2 reads the port reads (AV1 inter frames were the last
    refused by name), and the rest, which cv2 reads nothing of, raises
    IOError."""
    found = []
    for path in sorted(UTILS.glob("*.py")):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            exc = getattr(node, "exc", None) if isinstance(
                node, ast.Raise) else None
            if exc is None:
                continue
            func = exc.func if isinstance(exc, ast.Call) else exc
            if getattr(func, "id", "") == "NotImplementedError":
                found.append(f"{path.name}:{node.lineno}")
    assert not found, found


@pytest.mark.parametrize("name", sorted(F.UNREAD_FIXTURES))
def test_named_fixtures_cv2_reads_nothing_of_raise_ioerror(name):
    """The files of scripts/make_named_fixtures.py that cv2 reads nothing
    of (a tile list OBU, an inter frame with nothing before it, superres
    tile columns under 128 coded pixels, tmap and iovl primary items, a
    tone map past cv2's signature window, iloc construction method 2, a
    track without meta under the avif brand, ThunderScan grey, SOF11):
    both packages raise IOError."""
    path = UNREAD / name
    assert _cv2(path.read_bytes()) is None
    with pytest.raises(IOError):
        imagelib.load_image(path)
    with pytest.raises(IOError):
        jax_image.load_image(str(path))
