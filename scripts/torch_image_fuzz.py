"""Hold the port's GIF, WebP, JPEG 2000, AVIF, TIFF, PAM and OS/2 BMP
codecs to OpenCV on random files.

For a given number of seconds, make random images (noise, smooth waves,
a flat colour, a checkerboard, a few-colour palette image, noise over a
ramp; 1-89 pixels a side), write each with cv2 or Pillow (lossy WebP at
any quality, cv2's lossless WebP, Pillow's lossless and lossy WebP at any
method, with alpha a third of the time, Pillow's palette GIFs, interlaced
or transparent; cv2's default and lossless .jp2 of 8- or 16-bit images,
Pillow's JPEG 2000 with random resolutions, code-block sizes,
progression, 9/7, colour transform, quality layers, tiles, precincts,
raw code stream and PLT, grey, RGB, RGBA or 16-bit; cv2's AVIF at any
quality, speed and bit depth (8, 10, 12), colour or grey, and Pillow's
at any quality, speed, subsampling, range, tiles and libaom switch, with
alpha a fifth of the time, either under a random nclx colour matrix,
primaries and range two times in five; and the port's own AVIF writer,
avif.encode_avif; cv2's TIFF of any sample type, 1, 3 or 4 channels,
codec and predictor, Pillow's bilevel, CMYK, JPEG, signed 32-bit and
BigTIFF files, and TIFFs encoded here of any sample type, strips or
tiles, chunky or (8-bit) planar, classic or BigTIFF; cv2's PAM of 1, 3
or 4 channels at 8 or 16 bits; an OS/2 BMP of 1, 4, 8 or 24 bits; cv2's
SGI LogLuv TIFF (SGILog or SGILog24) of random radiance or LogL of
grey, and LogLuv TIFFs encoded here of random words, strips or tiles,
either byte order; Pillow's CCITT TIFFs (Modified Huffman, word-aligned,
T.4 1-D or 2-D with or without fill, T.6) of random bilevel images, in
strips, FillOrder 1 or 2, white-is-zero or not; YCbCr TIFFs encoded here
of any subsampling, codec, predictor, strips or tiles and
ReferenceBlackWhite and YCbCrCoefficients; lossless JPEGs encoded here of
any predictor, point transform, restart interval and component count;
cv2's baseline JPEGs re-coded arithmetically, sequential or progressive,
with restarts and DAC conditioning; AVIF grids of cv2's tiles of random
size, count and output size; OpenJPEG's own encoder through ctypes
(scripts/make_jp2_fixtures.py) with any Part 1 code-block styles, SOP
and EPH, quality layers, 9/7, colour transform, resolutions, code-block
sizes, tiles and tile-parts, POC volumes, RGN, PPM or PPT rewrites,
palettes, grey and 16-bit, sYCC, subsampled sYCC, e-sYCC and CMYK);
HTJ2K files of the hand-written HT encoder (scripts/htj2k_encoder.py:
grey, 16-bit or RGB, the 5/3 or 9/7, levels, code-block sizes, COC,
precincts, tiles, progressions, 1-3 passes over layers, style bits, CAP,
CPF, JP2 or JPH, and broken files cv2 reads nothing of); the port's AV1
encoder under superres, 4:4:4, 10 bits, loop restoration, film grain,
two tile columns and show_existing_frame, HEIF layouts
(scripts/make_avif_items.py: gain maps, overlays, iloc construction
method 2, track-only sequences, items and tracks that differ),
ThunderScan TIFFs of the hand-written encoder, SOF11 JPEGs and AVIF
items of a key frame and inter frames from Pillow's sequences
(scripts/make_inter_fixtures.py: any speed, 2-8 frames, size,
subsampling, quality and motion); and compare the port's decode with
cv2.imdecode (arithmetic JPEG within 1 level); where cv2 reads no AVIF (a
grey one with alpha, a matrix libavif converts nothing of, a grid it
refuses), no PAM, no OS/2 BMP, none of the files of the last image
slice and no file of OpenJPEG's or the HT encoder, the port must raise
IOError.
For cv2's GIF writer, compare cv2's read-back of the port's `encode_gif`
with that of cv2's own file. Needs cv2 and Pillow. Run from the
repository's root:

    python scripts/torch_image_fuzz.py --seed 1 --seconds 60

(`--openjpeg`: OpenJPEG's files only; `--htj2k`: the HT encoder's;
`--named`: the families of the files once refused by name; `--inter`:
AV1 inter frames only.)

It prints each mismatch and one closing line of counts, and exits 1 if
any file differed.
"""
import argparse
import io
import struct
import sys
import time
from pathlib import Path

import cv2
import numpy as np
from PIL import Image

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from ignis_tpu_torch.utils import avif, gif, jpeg2000, webp  # noqa: E402
from ignis_tpu_torch.utils import image as imagelib  # noqa: E402
from ignis_tpu_torch.utils.tiff import decode_tiff  # noqa: E402
from make_image_fixtures import os2_bmp, tiff_file, with_nclx  # noqa: E402
from make_image_fixtures import (_pil_ccitt, arith_jpeg, avif_grid,  # noqa
                                 logluv_tiff, lossless_jpeg, with_short_tag,
                                 ycbcr_tiff)
from ignis_tpu_torch.utils.jpeg import decode_jpeg  # noqa: E402
import make_jp2_fixtures as opj  # noqa: E402
import htj2k_encoder as ht  # noqa: E402
import lossless_arith_encoder as sof11  # noqa: E402
import make_avif_items as items  # noqa: E402
import make_inter_fixtures as inter  # noqa: E402
import make_named_fixtures as named  # noqa: E402
import thunderscan_encoder as thunder  # noqa: E402

FLAGS = cv2.IMREAD_UNCHANGED | cv2.IMREAD_ANYDEPTH | cv2.IMREAD_ANYCOLOR


def cv2_rgb(data: bytes):
    img = cv2.imdecode(np.frombuffer(data, np.uint8), FLAGS)
    if img is None:
        return None
    if img.ndim == 2 or img.shape[2] == 2:
        img = np.repeat(img.reshape(img.shape[:2] + (-1,))[..., :1], 3, -1)
    return np.ascontiguousarray(img[..., 2::-1])


def random_image(rng, h, w) -> np.ndarray:
    kind = rng.integers(0, 6)
    yy, xx = np.mgrid[0:h, 0:w]
    if kind == 0:
        return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    if kind == 1:
        return np.stack([127 + 120 * np.sin(xx / (3 + 7 * rng.random()) + c)
                         * np.cos(yy / (3 + 9 * rng.random()))
                         for c in range(3)], -1).astype(np.uint8)
    if kind == 2:
        return np.full((h, w, 3), rng.integers(0, 256, 3), np.uint8)
    if kind == 3:
        a, b = rng.integers(1, 9, 2)
        return ((xx // a + yy // b) % 2 * 255)[..., None].repeat(
            3, -1).astype(np.uint8)
    if kind == 4:
        pal = rng.integers(0, 256, (rng.integers(1, 20), 3))
        return pal[rng.integers(0, len(pal), (h, w))].astype(np.uint8)
    return np.clip(rng.normal(128, 60, (h, w, 3)) + 2 * xx[..., None], 0,
                   255).astype(np.uint8)


def pil_bytes(im, fmt, **kw) -> bytes:
    bio = io.BytesIO()
    im.save(bio, fmt, **kw)
    return bio.getvalue()


def one_case(rng):
    """(label, the file, the port's decoder) or, for the GIF writer,
    (label, cv2's own file, the port's file)."""
    h, w = (int(v) for v in rng.integers(1, 90, 2))
    img = random_image(rng, h, w)
    bgr = np.ascontiguousarray(img[..., ::-1])
    kind = rng.integers(0, 26)
    if kind >= 21:
        return NAMED_CASES[kind - 21](rng, h, w, img)
    if kind >= 13:
        return REST_CASES[kind - 13](rng, h, w, img)
    if kind == 12:
        return pam_or_os2_case(rng, h, w, img)
    if kind == 11:
        return tiff_case(rng, h, w, img)
    if kind == 10:
        return (f"AVIF writer {h}x{w}", avif.encode_avif(img),
                avif.decode_avif)
    if kind >= 8:
        return avif_case(rng, kind == 8, h, w, img)
    if kind >= 6:
        return jp2_case(rng, kind == 6)
    rgba = Image.fromarray(np.dstack([img, rng.integers(0, 256, (h, w),
                                                        dtype=np.uint8)]))
    im = rgba if rng.random() < 0.3 else Image.fromarray(img)
    if kind == 0:
        q = int(rng.integers(1, 101))
        return (f"cv2 WebP q{q} {h}x{w}", cv2.imencode(
            ".webp", bgr, [cv2.IMWRITE_WEBP_QUALITY, q])[1].tobytes(),
            webp.decode_webp)
    if kind == 1:
        return (f"cv2 lossless WebP {h}x{w}",
                cv2.imencode(".webp", bgr)[1].tobytes(), webp.decode_webp)
    if kind in (2, 3):
        kw = dict(quality=int(rng.integers(0, 101)),
                  method=int(rng.integers(0, 7)), lossless=kind == 2)
        return (f"Pillow WebP {kw} {im.mode} {h}x{w}",
                pil_bytes(im, "WEBP", **kw), webp.decode_webp)
    if kind == 4:
        return (f"GIF writer {h}x{w}", cv2.imencode(".gif", bgr)[1].tobytes(),
                gif.encode_gif(img))
    kw = dict(interlace=bool(rng.integers(0, 2)))
    if rng.random() < 0.5:
        kw["transparency"] = int(rng.integers(0, 2))
    pal = Image.fromarray(img).quantize(int(rng.integers(2, 257)))
    return (f"Pillow GIF {kw} {h}x{w}", pil_bytes(pal, "GIF", **kw),
            gif.decode_gif)


# libaom switches Pillow passes on (`advanced`); film grain at any of
# libaom's 16 test vectors
AVIF_SWITCHES = [
    ("tune-content", "screen"), ("enable-palette", "1"),
    ("enable-intrabc", "1"), ("enable-filter-intra", "1"),
    ("enable-cfl-intra", "1"), ("enable-restoration", "1"),
    ("enable-qm", "1"), ("deltaq-mode", "2"), ("deltaq-mode", "3"),
    ("delta-lf-mode", "1"), ("enable-chroma-deltaq", "1"),
    ("enable-tx64", "1"), ("sharpness", "7"), ("sb-size", "128"),
    ("reduced-tx-type-set", "1"), ("enable-cdef", "0"),
    ("cdf-update-mode", "0")]


def avif_case(rng, from_cv2, h, w, img):
    if from_cv2:
        depth = int(rng.choice([8, 8, 10, 12]))
        src = img[..., 0] if rng.random() < 0.2 else img[..., ::-1]
        if depth > 8:
            src = (src.astype(np.uint16) << (depth - 8)) | \
                (src.astype(np.uint16) >> (16 - depth))
        params = [cv2.IMWRITE_AVIF_QUALITY, int(rng.integers(0, 101)),
                  cv2.IMWRITE_AVIF_SPEED, int(rng.integers(0, 11)),
                  cv2.IMWRITE_AVIF_DEPTH, depth]
        label = f"cv2 AVIF {params[1::2]} {src.shape}"
        data = cv2.imencode(".avif", np.ascontiguousarray(src),
                            params)[1].tobytes()
        if rng.random() < 0.4:
            label, data = recoloured(rng, label, data)
        return label, data, avif.decode_avif
    kw = dict(quality=int(rng.integers(0, 101)),
              speed=int(rng.integers(0, 11)),
              subsampling=str(rng.choice(["4:2:0", "4:2:2", "4:4:4",
                                          "4:0:0"])),
              range=str(rng.choice(["full", "limited"])))
    if rng.random() < 0.3:
        kw["tile_rows"], kw["tile_cols"] = (int(v) for v in
                                            rng.integers(0, 3, 2))
    if rng.random() < 0.6:
        picks = rng.choice(len(AVIF_SWITCHES), int(rng.integers(1, 4)),
                           replace=False)
        kw["advanced"] = [AVIF_SWITCHES[i] for i in picks]
        if rng.random() < 0.15:
            kw["advanced"].append(("film-grain-test",
                                   str(int(rng.integers(1, 17)))))
    im = Image.fromarray(np.dstack([img, img[..., 1]]), "RGBA") \
        if rng.random() < 0.2 else Image.fromarray(img)
    try:
        data = pil_bytes(im, "AVIF", **kw)
    except (OSError, ValueError):      # switches libaom refuses together
        return avif_case(rng, from_cv2, h, w, img)
    label, data = f"Pillow AVIF {kw} {im.mode} {h}x{w}", data
    if rng.random() < 0.4:
        label, data = recoloured(rng, label, data)
    return label, data, avif.decode_avif


def recoloured(rng, label, data):
    """The file under a random nclx matrix (0-17), primaries and range."""
    matrix = int(rng.integers(0, 18))
    primaries = int(rng.choice([1, 2, 4, 5, 6, 9, 10, 12, 22]))
    out = bytearray(with_nclx(data, matrix, primaries))
    at = out.index(b"colrnclx") + 14
    full = int(rng.integers(0, 2))
    out[at] = (full << 7) | (out[at] & 0x7F)
    return (f"{label} as nclx {primaries}/{matrix} full {full}",
            bytes(out))


TIFF_TYPES = ("uint8", "uint16", "uint32", "int8", "int16", "int32",
              "float32", "float64")


def random_samples(img, dtype, channels):
    """img's samples spread over a dtype (floats: about 0-4)."""
    d = np.dtype(dtype)
    v = img[..., :channels].astype(np.float64)
    if d.kind == "f":
        return (v / 64.0).astype(d)
    info = np.iinfo(d)
    span = float(info.max) - float(info.min)
    return (info.min + v / 255.0 * span).astype(d)


def tiff_case(rng, h, w, img):
    """A random TIFF of cv2's writer, Pillow's, or encoded here."""
    pick = rng.integers(0, 3)
    if pick == 0:
        dtype = str(rng.choice(TIFF_TYPES))
        channels = int(rng.choice([1, 3, 4]))
        arr = random_samples(img, dtype, channels)
        comp = int(rng.choice([1, 5, 8, 32773]))
        params = [cv2.IMWRITE_TIFF_COMPRESSION, comp]
        if comp in (5, 8):
            params += [cv2.IMWRITE_TIFF_PREDICTOR, int(rng.integers(1, 3))]
        src = arr[..., 0] if channels == 1 else arr[..., ::-1]
        ok, buf = cv2.imencode(".tif", np.ascontiguousarray(src), params)
        return f"cv2 TIFF {dtype} {channels} {params} {h}x{w}", \
            buf.tobytes(), decode_tiff
    if pick == 1:
        kind = str(rng.choice(["1", "CMYK", "jpeg", "I", "big"]))
        kw, im = {}, Image.fromarray(img)
        if kind == "1":
            im = Image.fromarray(img[..., 0] > 127)
            kw["compression"] = str(rng.choice(["raw", "packbits",
                                                "tiff_lzw",
                                                "tiff_adobe_deflate"]))
        elif kind == "CMYK":
            im = im.convert("CMYK")
        elif kind == "jpeg":
            if rng.random() < 0.3:
                im = im.convert("YCbCr")
            elif rng.random() < 0.3:
                im = Image.fromarray(img[..., 0])
            kw["compression"] = "jpeg"
            kw["quality"] = int(rng.integers(5, 101))
        elif kind == "I":
            im = Image.fromarray(random_samples(img, "int32", 1)[..., 0])
        else:
            kw["big_tiff"] = True
        return (f"Pillow TIFF {kind} {kw} {h}x{w}",
                pil_bytes(im, "TIFF", **kw), decode_tiff)
    dtype = str(rng.choice(TIFF_TYPES))
    channels = int(rng.choice([1, 3, 4]))
    arr = random_samples(img, dtype, channels)
    comp = int(rng.choice([1, 5, 8, 32773]))
    pred = 1
    if comp in (5, 8):
        pred = int(rng.choice([1, 2, 3] if dtype.startswith("float")
                              else [1, 2]))
    tile = None
    if rng.random() < 0.4:
        tile = tuple(int(16 * v) for v in rng.integers(1, 4, 2))
    kw = dict(order=str(rng.choice(["<", ">"])), tile=tile, comp=comp,
              predictor=pred, rows_per_strip=int(rng.integers(1, h + 1)),
              planar=bool(arr.dtype.itemsize == 1 and channels > 1
                          and rng.random() < 0.5),
              big=bool(rng.random() < 0.3))
    if comp == 1 and tile and arr.dtype.itemsize == 1:
        kw["comp"] = 5            # OpenCV cannot read raw 8-bit tiles
    return f"TIFF {dtype} {channels} {kw} {h}x{w}", tiff_file(arr, **kw), \
        decode_tiff


def pam_or_os2_case(rng, h, w, img):
    """cv2's PAM of 1, 3 or 4 channels at 8 or 16 bits, or an OS/2 BMP."""
    if rng.random() < 0.5:
        channels = int(rng.choice([1, 3, 4]))
        arr = img[..., :1] if channels == 1 else img
        if channels == 4:
            arr = np.dstack([img, img[..., 1]])
        if rng.random() < 0.3:
            arr = arr.astype(np.uint16) * 257
        return f"cv2 PAM {arr.shape} {arr.dtype}", cv2.imencode(
            ".pam", np.ascontiguousarray(arr))[1].tobytes(), \
            imagelib.decode_pam
    bpp = int(rng.choice([1, 4, 8, 24]))
    if bpp == 24:
        return f"OS/2 BMP 24 {h}x{w}", os2_bmp(img, 24), imagelib.decode_bmp
    pal = rng.integers(0, 256, (1 << bpp, 3), dtype=np.uint8)
    idx = rng.integers(0, 1 << bpp, (h, w), dtype=np.uint8)
    return f"OS/2 BMP {bpp} {h}x{w}", os2_bmp(idx, bpp, pal), \
        imagelib.decode_bmp


def jp2_case(rng, from_cv2):
    """A random JPEG 2000 file of cv2's or Pillow's writer (at least 8
    pixels a side; Pillow's 9/7 untiled and with every level at least 2
    samples, where its OpenJPEG 2.5.4 would abort)."""
    h, w = (int(v) for v in rng.integers(8, 90, 2))
    img = random_image(rng, h, w)
    deep = rng.random() < 0.25
    if from_cv2:
        h, w = max(h, 32), max(w, 32)
        img = random_image(rng, h, w)
        arr = img.astype(np.uint16) * 257 if deep else img
        if rng.random() < 0.3:
            arr = arr[..., 0]
        params = [cv2.IMWRITE_JPEG2000_COMPRESSION_X1000,
                  int(rng.choice([1000, 1000, int(rng.integers(1, 1000))]))]
        if rng.random() < 0.5:
            params = []
        data = cv2.imencode(".jp2", np.ascontiguousarray(arr[..., ::-1]
                                                         if arr.ndim == 3
                                                         else arr),
                            params)[1].tobytes()
        return f"cv2 .jp2 {params} {arr.shape} {arr.dtype}", data, \
            jpeg2000.decode_jpeg2000
    mode = str(rng.choice(["L", "RGB", "RGBA", "I;16"]))
    arr = {"L": img[..., 0], "RGB": img,
           "RGBA": np.dstack([img, img[..., 1] // 2]),
           "I;16": img[..., 0].astype(np.uint16) * 257}[mode]
    kw = {}
    if rng.random() < 0.5:
        kw["num_resolutions"] = int(rng.integers(1, 7))
    if rng.random() < 0.5:
        kw["codeblock_size"] = tuple(int(2 ** v)
                                     for v in rng.integers(2, 7, 2))
        if kw["codeblock_size"][0] * kw["codeblock_size"][1] > 4096:
            kw["codeblock_size"] = (64, 64)
    if rng.random() < 0.5:
        kw["progression"] = str(rng.choice(jpeg2000.PROGRESSIONS))
    if rng.random() < 0.3 and mode in ("RGB", "RGBA"):
        kw["mct"] = int(rng.integers(0, 2))
    if rng.random() < 0.4:
        kw["quality_mode"] = "rates"
        kw["quality_layers"] = sorted(
            (float(rng.uniform(2, 80)) for _ in range(rng.integers(1, 4))),
            reverse=True)
    if rng.random() < 0.3:
        kw["tile_size"] = tuple(int(v) for v in rng.integers(16, 64, 2))
    if rng.random() < 0.3:
        p = int(2 ** rng.integers(5, 8))
        kw["precinct_size"] = (p, p)
    if rng.random() < 0.4:
        kw["irreversible"] = True
        kw.pop("tile_size", None)
        kw["num_resolutions"] = max(1, min(kw.get("num_resolutions", 6),
                                           int(np.log2(min(h, w)))))
    kw["no_jp2"] = bool(rng.random() < 0.2)
    kw["plt"] = bool(rng.random() < 0.2)
    try:
        data = pil_bytes(Image.fromarray(arr), "JPEG2000", **kw)
    except OSError:           # options Pillow's encoder refuses
        return jp2_case(rng, from_cv2)
    return f"Pillow JPEG 2000 {kw} {mode} {h}x{w}", data, \
        jpeg2000.decode_jpeg2000


# the decoders of the last image slice's cases: where cv2 reads nothing
# of their files, the port must raise IOError
def strict_tiff(data):
    return decode_tiff(data)


def strict_jpeg(data):
    return decode_jpeg(data)


def near_jpeg(data):
    """decode_jpeg of an arithmetic-coded file: held within 1 level."""
    return decode_jpeg(data)


def strict_avif(data):
    return avif.decode_avif(data)


def logluv_case(rng, h, w, img):
    """cv2's SGILog / SGILog24 of random radiance, cv2's LogL of grey, or
    a LogLuv TIFF of random words encoded here."""
    pick = rng.integers(0, 4)
    if pick < 3:
        hdr = (img.astype(np.float32) / 255 + 1e-3) * np.float32(
            10.0 ** rng.uniform(-3, 4))
        if pick == 2:
            hdr = hdr[..., 1]
        comp = 34677 if pick == 1 else 34676
        return (f"cv2 LogLuv {comp} {'grey ' if pick == 2 else ''}{h}x{w}",
                cv2.imencode(".tif", np.ascontiguousarray(
                    hdr[..., ::-1] if hdr.ndim == 3 else hdr),
                    [cv2.IMWRITE_TIFF_COMPRESSION, comp])[1].tobytes(),
                strict_tiff)
    bits = int(rng.choice([16, 24, 32]))
    words = rng.integers(0, 1 << bits, (h, w), dtype=np.uint64).astype(
        np.uint16 if bits == 16 else np.uint32)
    if rng.random() < 0.5:
        words[:, :w // 2] = words[:, :1]
    tile = (16, 16) if rng.random() < 0.3 else None
    rows = int(rng.integers(1, 9))
    order = "<>"[int(rng.integers(0, 2))]
    return (f"LogLuv {bits}-bit words {order} tile {tile} rows {rows} "
            f"{h}x{w}", logluv_tiff(words, 34677 if bits == 24 else 34676,
                                   order, tile, rows,
                                   bool(rng.integers(0, 2))), strict_tiff)


def ccitt_case(rng, h, w, img):
    """Pillow's CCITT TIFF of a random bilevel image, any compression and
    options, strips, fill order, photometric 0 or 1."""
    comp, info = [("tiff_ccitt", {}), ("tiff_raw_16", {}), ("group3", {}),
                  ("group3", {"t292": 1}), ("group3", {"t292": 5}),
                  ("group4", {})][int(rng.integers(0, 6))]
    info = dict(info, t278=int(rng.integers(1, h + 1)))
    if rng.random() < 0.3:
        info["t266"] = 2
    wide = int(rng.choice([1, 1, 1, 40]))
    bits = np.repeat(img[..., 1] > rng.integers(0, 256), wide, 1)
    data = _pil_ccitt(bits, comp, **info)
    photo = int(rng.integers(0, 2))
    return (f"CCITT {comp} {info} photometric {photo} {h}x{w * wide}",
            with_short_tag(data, 262, photo), strict_tiff)


def ycbcr_case(rng, h, w, img):
    """A YCbCr TIFF encoded here: any subsampling, codec, predictor,
    strips or tiles, byte order, ReferenceBlackWhite and coefficients."""
    hs, vs = [(1, 1), (2, 1), (2, 2), (4, 1), (4, 2), (4, 4), (1, 2),
              (2, 4)][int(rng.integers(0, 8))]
    comp = int(rng.choice([1, 5, 8, 32773]))
    pred = 2 if comp in (5, 8) and rng.random() < 0.5 else 1
    tile = (16, 16) if comp != 1 and rng.random() < 0.3 else None
    rows = None if tile else vs * int(rng.integers(1, 5))
    tags = []
    if rng.random() < 0.3:
        tags.append((532, 5, [16, 1, 235, 1, 128, 1, 240, 1, 128, 1, 240,
                              1]))
    if rng.random() < 0.3:
        tags.append((529, 5, [2126, 10000, 7152, 10000, 722, 10000]))
    return (f"YCbCr {hs}x{vs} comp {comp} pred {pred} tile {tile} rows "
            f"{rows} {len(tags)} tags {h}x{w}",
            ycbcr_tiff(img, hs, vs, comp, "<>"[int(rng.integers(0, 2))],
                       tile, rows, pred, tags), strict_tiff)


def lossless_case(rng, h, w, img):
    """A lossless JPEG encoded here of 1 or 3 components."""
    ch = int(rng.choice([1, 3]))
    pred, pt = int(rng.integers(1, 8)), int(rng.choice([0, 0, 1, 4]))
    rst = int(rng.choice([0, 0, 1, 3]))
    return (f"lossless JPEG {ch} ch pred {pred} pt {pt} rst {rst} {h}x{w}",
            lossless_jpeg(img[..., :ch], pred, pt, rst, None,
                          bool(rng.integers(0, 2))), strict_jpeg)


def arith_case(rng, h, w, img):
    """cv2's baseline JPEG of any quality and sampling re-coded
    arithmetically, sequential or progressive, restarts, DAC."""
    params = [cv2.IMWRITE_JPEG_QUALITY, int(rng.integers(5, 101))]
    if rng.random() < 0.5:
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                   int(rng.choice([cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
                                   cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422]))]
    src = img[..., 0] if rng.random() < 0.2 else img[..., ::-1]
    base = cv2.imencode(".jpg", np.ascontiguousarray(src), params)[1]
    prog, rst = bool(rng.integers(0, 2)), int(rng.choice([0, 0, 1, 5]))
    dac = None
    if rng.random() < 0.3:
        dac = {0: int(rng.integers(0, 16)) | int(rng.integers(0, 16)) << 4,
               16: int(rng.integers(1, 64))}
        dac[0] = (dac[0] & 15) | max(dac[0] >> 4, dac[0] & 15) << 4
    return (f"arithmetic JPEG {params} progressive {prog} rst {rst} dac "
            f"{dac} {h}x{w}", arith_jpeg(base.tobytes(), prog, rst, dac),
            near_jpeg)


def grid_case(rng, h, w, img):
    """An AVIF grid of cv2's tiles of 48-80 pixels, 1-3 by 1-3, cut to a
    random size (sometimes one libavif refuses)."""
    rows, cols = (int(v) for v in rng.integers(1, 4, 2))
    tw, th = (int(v) for v in rng.choice([48, 64, 66, 65, 80], 2))
    lossless = rng.random() < 0.3
    params = [cv2.IMWRITE_AVIF_QUALITY, 100] if lossless else []
    tiles = [cv2.imencode(".avif", np.ascontiguousarray(np.resize(
        img, (th, tw, 3))[..., ::-1]), params)[1].tobytes()
        for _ in range(rows * cols)]
    ow = int(rng.integers(max((cols - 1) * tw, 1), cols * tw + 2))
    oh = int(rng.integers(max((rows - 1) * th, 1), rows * th + 2))
    return (f"AVIF grid {rows}x{cols} of {tw}x{th} to {ow}x{oh}",
            avif_grid(tiles, rows, cols, ow, oh, bool(rng.integers(0, 2)),
                      bool(rng.integers(0, 2))), strict_avif)


def strict_jp2(data):
    return jpeg2000.decode_jpeg2000(data)


def forked(fn, *args, **kw):
    """fn(*args, **kw)'s bytes, made in a child process: OpenJPEG's
    encoder aborts on some options (assertions in its DWT and bit
    writer), which would end the run. None where the child failed."""
    import os
    rd, wr = os.pipe()
    pid = os.fork()
    if pid == 0:
        os.close(rd)
        code = 1
        try:
            data = fn(*args, **kw)
            with os.fdopen(wr, "wb") as f:
                f.write(data)
            code = 0
        finally:
            os._exit(code)
    os.close(wr)
    with os.fdopen(rd, "rb") as f:
        data = f.read()
    _, status = os.waitpid(pid, 0)
    return data if status == 0 else None


def opj_case(rng, h, w, img):
    """A random file of OpenJPEG's own encoder (at least 8 pixels a
    side): RGB, grey or 16-bit grey, sYCC (subsampled a third of the
    time), e-sYCC or CMYK, or an 8-bit index under a palette; any Part 1
    code-block styles, SOP / EPH, 1-3 quality layers, 9/7 and the colour
    transform, resolutions, code-block sizes, tiles, tile-parts, RGN,
    POC volumes split by resolution and component (the splits its
    encoder writes whole, in tile-parts by layer), and an SOP+EPH file's
    headers moved to PPM or PPT."""
    h, w = max(h, 8), max(w, 8)
    img = random_image(rng, h, w).astype(np.int32)
    kind = rng.random()
    if kind < 0.08:
        pal = rng.integers(0, 256, (int(rng.integers(1, 257)), 3))
        idx = rng.integers(0, min(len(pal) + 2, 256), (h, w))
        data = forked(opj.palette_jp2, idx.astype(np.int32), 8, pal, 8)
        if data is None:        # sizes OpenJPEG's encoder refuses
            return opj_case(rng, h, w, img)
        return f"OpenJPEG palette {len(pal)} {h}x{w}", data, strict_jp2
    comps, space, prec, sub, size = opj.planes(img), opj.SRGB, 8, None, None
    if kind < 0.25:
        comps, space = comps[:1], opj.GREY
        if rng.random() < 0.4:
            comps, prec = [comps[0] * 257], 16
    elif kind < 0.35:
        space = opj.SYCC
        if rng.random() < 0.3:
            comps = [comps[0], comps[1][::2, ::2], comps[2][::2, ::2]]
            sub, size = [(1, 1), (2, 2), (2, 2)], (h, w)
    elif kind < 0.4:
        space = opj.EYCC if rng.random() < 0.5 else opj.CMYK
        if space == opj.CMYK:
            comps = comps + [comps[0] // 2]
    kw = dict(mode=int(rng.integers(0, 64)),
              csty=int(rng.choice([0, 2, 4, 6, 6])),
              numres=int(rng.integers(1, 1 + min(6, int(np.log2(min(h, w)))))),
              cblk=tuple(int(2 ** v) for v in rng.integers(2, 7, 2)),
              prog=int(rng.integers(0, 5)))
    if kw["cblk"][0] * kw["cblk"][1] > 4096:
        kw["cblk"] = (64, 64)
    if rng.random() < 0.5:
        kw["layers"] = tuple(sorted((float(rng.uniform(2, 60))
                                     for _ in range(rng.integers(1, 3))),
                                    reverse=True)) + (0.0,) * int(
                                        rng.integers(0, 2))
    if len(comps) >= 3 and sub is None and space == opj.SRGB:
        kw["mct"] = int(rng.integers(0, 2))
    if rng.random() < 0.3 and sub is None:
        # untiled, every level at least 2 samples: OpenJPEG 2.5.4's 9/7
        # encoder aborts on a level of one sample
        kw["irreversible"] = True
        kw["numres"] = max(1, min(kw["numres"],
                                  int(np.log2(min(h, w))) - 1))
    elif rng.random() < 0.3:
        kw["tiles"] = tuple(int(v) for v in rng.integers(16, 64, 2))
    if rng.random() < 0.3:
        kw["roi"] = (int(rng.integers(0, len(comps))),
                     int(rng.integers(1, 8)))
    ntiles = 1
    if "tiles" in kw:
        ntiles = -(-w // kw["tiles"][0]) * -(-h // kw["tiles"][1])
    if rng.random() < 0.3 and 3 * ntiles <= 32:
        nl, nr = len(kw.get("layers", (0,))), kw["numres"]
        r = int(rng.integers(0, nr + 1))
        c = int(rng.integers(0, len(comps) + 1))
        vols = [(0, 0, nl, r, len(comps), int(rng.integers(0, 5))),
                (r, 0, nl, nr, c, int(rng.integers(0, 5))),
                (r, c, nl, nr, len(comps), int(rng.integers(0, 5)))]
        vols = [v for v in vols if v[0] < v[3] and v[1] < v[4]]
        kw["pocs"] = [v + (t,) for t in range(1, ntiles + 1)
                      for v in vols]
        if rng.random() < 0.5:
            kw["tileparts"] = "L"
    elif rng.random() < 0.3:
        kw["tileparts"] = str(rng.choice(["R", "L", "C"]))
    data = forked(opj.encode, comps, space=space, prec=prec, sub=sub,
                  size=size, **kw)
    if data is None:            # options OpenJPEG's encoder refuses
        return opj_case(rng, h, w, img)
    pack = None
    if kw["csty"] == 6 and rng.random() < 0.5:
        try:
            data, pack = opj.packed(data, str(rng.choice(["ppm", "ppt"]))), \
                "packed"
        except ValueError:      # a stream the encoder cut short
            pass
    return (f"OpenJPEG {kw} space {space} prec {prec} sub {sub} {pack} "
            f"{h}x{w}", data, strict_jp2)


def ht_case(rng, h, w, img):
    """A random HTJ2K file of the hand-written HT encoder
    (scripts/htj2k_encoder.py): grey (8 or 16 bits) or RGB (with or
    without the RCT or ICT), the 5/3 or the 9/7, 0-5 levels, any
    code-block size, a component's own through COC, precincts, tiles,
    the five progressions, 1-3 passes from a random cleanup plane spread
    over 1-3 layers (as T.814 or as OpenJPEG reads such packets), Part 1
    style bits beside 0x40, CAP, CPF and the Rsiz bit or not, raw, JP2 or
    JPH; one file in eight broken as the fixtures in images_unread are
    (more than 3 passes, RGN, mixed mode, a bad Scup, an empty cleanup
    segment), which cv2 reads nothing of."""
    kind = rng.random()
    bits = 8
    if kind < 0.3:
        comps = [img[..., 0].astype(np.int64)]
        if rng.random() < 0.4:
            bits = 16
            comps = [comps[0] * 257 - rng.integers(0, 257, (h, w))
                     .clip(0, comps[0] * 257)]
    else:
        comps = [img[..., c].astype(np.int64) for c in range(3)]
    reversible = rng.random() < 0.6
    levels = int(rng.integers(0, 6))

    def coding():
        xcb = int(rng.integers(2, 7))
        ycb = int(rng.integers(2, min(11, 12 - xcb) + 1))
        prec = None
        if rng.random() < 0.3:
            prec = [tuple(int(v) for v in rng.integers(0 if r == 0 else 1,
                                                        9, 2))
                    for r in range(levels + 1)]
        return ht.Comp(levels, xcb, ycb, int(rng.choice([0, 0, 4, 8, 1,
                                                         int(rng.integers(
                                                             0, 64))])),
                       prec)
    cods = [coding()]
    if len(comps) > 1 and rng.random() < 0.3:
        cods = [coding() for _ in comps]
    passes = int(rng.integers(1, 4))
    plane = int(rng.integers(0, 4))
    split = sorted(int(v) for v in rng.integers(0, 3, passes))
    split = [v - split[0] for v in split]
    broken = rng.random() < 0.125
    hook, rgn = None, False
    if broken:
        what = int(rng.integers(0, 5))
        if what == 0:
            passes, split = 4, [0] * 4
        elif what == 1:
            rgn = True
        elif what == 2:
            cods = [ht.Comp(levels, 4, 4, 0x80)]
        else:
            def hook(c, orient, q, pl, segs, what=what):
                d = bytearray(segs[0])
                if what == 3:
                    v = len(d) + int(rng.integers(1, 9))
                    d[-1], d[-2] = v >> 4, (d[-2] & 0xF0) | (v & 0xF)
                    return (bytes(d),) + tuple(segs[1:])
                return (b"",) + tuple(segs[1:])
    kw = dict(bits=bits, comps=cods, reversible=reversible,
              mct=len(comps) == 3 and rng.random() < 0.7,
              prog=int(rng.integers(0, 5)), layers=max(split) + 1,
              base_step=float(rng.choice([0.5, 1.0, 2.0, 4.0])),
              cap=rng.random() < 0.7, cpf=rng.random() < 0.3,
              rsiz=rng.random() < 0.8, jp2=rng.random() < 0.5,
              opj_layers=rng.random() < 0.5, block_hook=hook,
              plan=lambda c, r, band, b, q, Mb: ht.BlockPlan(
                  min(plane, Mb - 1), passes, split))
    if kw["jp2"] and rng.random() < 0.3:
        kw["brand"] = b"jph "
    if rng.random() < 0.3:
        kw["tiles"] = tuple(int(v) for v in rng.integers(8, 64, 2))
    try:
        data = ht.encode(comps, **kw)
    except ValueError:          # a Scup past 4,079 bytes: draw again
        return ht_case(rng, h, w, img)
    if rgn:
        at = data.index(b"\xff\x5c")
        data = data[:at] + struct.pack(">HHBBB", 0xFF5E, 5, 0, 0, 2) + \
            data[at:]
    label = {k: v for k, v in kw.items() if k not in ("plan", "block_hook",
                                                       "comps")}
    return (f"HTJ2K {label} levels {levels} cods "
            f"{[vars(c) for c in cods]} passes {passes} plane {plane} "
            f"layers {split} broken {broken} {h}x{w}x{len(comps)}", data,
            strict_jp2)


def superres_case(rng, h, w, img):
    """The port's AV1 encoder at a random superres denominator (or none),
    4:2:0 or 4:4:4, 8 or 10 bits, loop restoration of random types,
    unit sizes and units, film grain, two tile columns, a hidden key
    frame shown by show_existing_frame; now and then a tile list OBU
    after the frame or an inter frame of Pillow's with nothing before
    it."""
    roll = rng.random()
    if roll < 0.04:
        return "AV1 tile list OBU", named.tile_list(), strict_avif
    if roll < 0.08:
        return "AV1 inter frame first", named.inter_first(), strict_avif
    opts = {"superres": int(rng.choice([8] + list(range(9, 17))))}
    if rng.random() < 0.3:
        opts.update(ssx=0, ssy=0)
    if rng.random() < 0.3:
        opts["bd"] = 10
    if rng.random() < 0.6:
        opts["lr"] = named.lr([int(rng.integers(4)) for _ in range(3)],
                              int(rng.integers(3)), int(rng.integers(2)),
                              int(rng.integers(1 << 16)))
    if opts.get("bd", 8) == 8 and rng.random() < 0.3:
        opts["grain"] = named.grain_params(int(rng.integers(1 << 16)))
    if rng.random() < 0.3:
        opts["hidden"] = True
    if opts["superres"] != 8 and rng.random() < 0.15:
        h = int(rng.integers(8, 24))
        w = (int(rng.integers(100, 200)) * opts["superres"]) // 8 + 1
        opts["tile_cols"] = 1
    label = f"AV1 {h}x{w} {sorted(opts)} denominator {opts['superres']}"
    try:
        stream = named.av1_stream(h, w, int(rng.integers(1 << 16)), **opts)
    except IOError:             # a tile column libaom refuses, as cv2
        return label, named._narrow_tiles(), strict_avif
    return label, named.avif_of(stream), strict_avif


def items_case(rng, h, w, img):
    """HEIF layouts: a gain map (base or tmap primary, with or without
    the altr group, the tmap brand and the metadata in idat), an overlay,
    iloc construction method 2, a Pillow sequence without its meta
    (brands with or without avif), a sequence whose primary item differs
    from its first sample under a random major brand."""
    h, w = max(h, 2), max(w, 2)
    seed = int(rng.integers(1 << 16))
    kind = int(rng.integers(5))
    if kind == 0:
        base = named.av1_stream(h, w, seed)
        gain = named.av1_stream(max(h // 2, 1), max(w // 2, 1), seed + 1)
        args = [bool(rng.integers(2)) for _ in range(3)]
        pitm = "tmap" if rng.random() < 0.2 else "base"
        return (f"gain map {pitm} {args} {h}x{w}",
                items.gain_map(base, gain, w, h, pitm, *args), strict_avif)
    if kind == 1:
        ins = [named.av1_stream(int(rng.integers(1, 30)),
                                int(rng.integers(1, 30)), seed + k)
               for k in range(int(rng.integers(1, 4)))]
        offs = [tuple(int(v) for v in rng.integers(-8, 40, 2)) for _ in ins]
        return ("overlay", items.overlay(ins, (w, h), offs,
                                         wide=bool(rng.integers(2))),
                strict_avif)
    if kind == 2:
        return "iloc method 2", items.method2(*named.av1_stream(
            h, w, seed)), strict_avif
    seq = named.pil_sequence(int(rng.integers(2, 4)),
                             "RGBA" if rng.random() < 0.3 else "RGB", seed,
                             h, w)
    if kind == 3:
        brands = [(b"avis", b"msf1", b"iso8"), (b"avis",),
                  (b"avis", b"avif")][int(rng.integers(3))]
        return (f"track only {brands}", items.track_only(seq, brands),
                strict_avif)
    major = [b"avis", b"avif", b"mif1"][int(rng.integers(3))]
    still = avif.parse_avif(named.pil_still(seed, h, w))["av1"]
    return (f"item and track {major}", items.item_and_track(seq, still,
                                                          major),
            strict_avif)


def thunderscan_case(rng, h, w, img):
    """A ThunderScan TIFF of the hand-written encoder: random 4-bit
    palette images (noise, ramps, flat stretches), random strip heights
    and code choices, tiles now and then, a damaged byte or a cut strip
    now and then."""
    idx = (img[..., 0] >> 4).astype(np.uint8)
    if rng.random() < 0.3:
        idx = np.where(rng.random((h, w)) < 0.8, idx[:, :1], idx)
    cmap = rng.integers(0, 1 << 16, (16, 3))
    if rng.random() < 0.1:
        data = tiff_file(idx[..., None], comp=32809, photo=3, cmap=cmap,
                         bits=4, tile=(16, 16), encode=thunder.encode)
    else:
        data = thunder.thunder_tiff(idx, cmap, int(rng.integers(1, h + 1)),
                                    rng if rng.random() < 0.5 else None)
    data = bytearray(data)
    if rng.random() < 0.2:
        k = int(rng.integers(max(len(data) - 12, 8), len(data)))
        data[k] = int(rng.integers(256))
    if rng.random() < 0.1:
        data = data[:-int(rng.integers(1, 4))]
    return f"ThunderScan {h}x{w}", bytes(data), strict_tiff


def sof11_case(rng, h, w, img):
    """A lossless arithmetic-coded JPEG (SOF11) of any predictor, point
    transform, restart interval, DAC and 1 or 3 components: cv2 reads
    nothing of it."""
    ch = int(rng.choice([1, 3]))
    pred, pt = int(rng.integers(1, 8)), int(rng.choice([0, 1]))
    rst = int(rng.choice([0, 0, 2]))
    dac = (int(rng.integers(0, 3)), int(rng.integers(3, 6))) \
        if rng.random() < 0.3 else None
    h, w = min(h, 24), min(w, 24)
    return (f"SOF11 {ch} ch pred {pred} pt {pt} rst {rst} dac {dac}",
            sof11.sof11_jpeg(img[:h, :w, :ch], pred, pt, rst, dac),
            strict_jpeg)


def inter_case(rng, h, w, img):
    """An AVIF item of a random Pillow sequence's first N samples (a key
    frame, then inter frames: scripts/make_inter_fixtures.py) at any
    speed, N of 2-8, size, subsampling, quality and motion (at speeds
    0-2, which libaom takes tens of seconds for at larger sizes, up to
    64 x 64 and 5 frames)."""
    h, w = max(h, 8), max(w, 8)
    n = int(rng.integers(2, 9))
    motion = str(rng.choice(inter.MOTIONS))
    speed = int(rng.integers(0, 11))
    if speed < 3:       # libaom's slowest speeds: small items (seconds)
        h, w, n = min(h, 64), min(w, 64), min(n, 5)
    sub = str(rng.choice(["4:2:0", "4:2:2", "4:4:4"]))
    q = int(rng.integers(20, 101))
    label = f"AV1 inter {h}x{w} N {n} {motion} speed {speed} {sub} q{q}"
    fr = inter.frames(h, w, n, motion, int(rng.integers(1 << 16)))
    buf = io.BytesIO()
    fr[0].save(buf, "AVIF", save_all=True, append_images=fr[1:],
               duration=100, speed=speed, subsampling=sub, quality=q)
    samples = named.sequence_samples(buf.getvalue(), n)
    seq = samples[0][2:4 + samples[0][3]]
    return label, avif.heif_image(b"".join(samples), seq, w, h), strict_avif


REST_CASES = (logluv_case, ccitt_case, ycbcr_case, lossless_case,
              arith_case, grid_case, opj_case, ht_case)
NAMED_CASES = (superres_case, items_case, thunderscan_case, sof11_case,
               inter_case)
STRICT = (strict_tiff, strict_jpeg, near_jpeg, strict_avif, strict_jp2)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--seconds", type=float, default=60.0)
    ap.add_argument("--openjpeg", action="store_true",
                    help="only files of OpenJPEG's own encoder")
    ap.add_argument("--htj2k", action="store_true",
                    help="only files of the hand-written HTJ2K encoder")
    ap.add_argument("--named", action="store_true",
                    help="only the families of the files once refused by "
                         "name: superres and show_existing_frame, HEIF "
                         "items, ThunderScan, SOF11, AV1 inter frames")
    ap.add_argument("--inter", action="store_true",
                    help="only AV1 inter frames (inter_case)")
    args = ap.parse_args()
    rng = np.random.default_rng(args.seed)
    files = bad = avifs = written = rest = opjs = hts = 0
    by_family = {f.__name__: 0 for f in NAMED_CASES}
    end = time.perf_counter() + args.seconds
    while time.perf_counter() < end:
        if args.openjpeg:
            h, w = (int(v) for v in rng.integers(8, 90, 2))
            label, data, other = opj_case(rng, h, w, None)
        elif args.htj2k:
            h, w = (int(v) for v in rng.integers(1, 90, 2))
            label, data, other = ht_case(rng, h, w, random_image(rng, h, w))
        elif args.inter:
            h, w = (int(v) for v in rng.integers(8, 129, 2))
            by_family["inter_case"] += 1
            label, data, other = inter_case(rng, h, w, None)
        elif args.named:
            h, w = (int(v) for v in rng.integers(1, 65, 2))
            case = NAMED_CASES[int(rng.integers(len(NAMED_CASES)))]
            by_family[case.__name__] += 1
            label, data, other = case(rng, h, w, random_image(rng, h, w))
        else:
            label, data, other = one_case(rng)
        written += label.startswith("AVIF writer")
        want = cv2_rgb(data)
        avifs += other is avif.decode_avif
        rest += other in STRICT
        opjs += other is strict_jp2 and not label.startswith("HTJ2K")
        hts += label.startswith("HTJ2K")
        if want is None and other in (avif.decode_avif, imagelib.decode_pam,
                                      imagelib.decode_bmp) + STRICT:
            files += 1
            try:       # cv2 reads nothing: neither may the port
                other(data)
            except IOError:
                continue
            bad += 1
            print(f"mismatch: {label}: read where cv2 reads nothing")
            continue
        if want is None:
            continue
        files += 1
        try:       # a fuzz run reports every failure and goes on
            got = cv2_rgb(other) if isinstance(other, bytes) else other(data)
        except Exception as e:
            bad += 1
            print(f"mismatch: {label}: {e!r}")
            continue
        near = other is near_jpeg
        if got is None or got.shape != want.shape or got.dtype != want.dtype \
                and other in STRICT or not near and not np.array_equal(
                    got, want) or near and np.abs(
                        got.astype(np.int64) - want).max() > 1:
            bad += 1
            print(f"mismatch: {label}: pixels differ")
    if args.named or args.inter:
        print(f"{files} files of the once-refused kinds (drawn by family: "
              f"{by_family}), {bad} differed from cv2")
        return 1 if bad else 0
    print(f"{files} files ({avifs} AVIF, {written} of them from the port's "
          f"AVIF writer; {rest} of the last slice's kinds: LogLuv, CCITT, "
          f"YCbCr, lossless and arithmetic JPEG, AVIF grids, OpenJPEG's "
          f"files; {opjs} of OpenJPEG's, {hts} HTJ2K of the HT encoder), "
          f"{bad} differed from cv2")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
