"""Write the fixtures of the files the port once refused by name: AV1
superres and show_existing_frame, tile list OBUs and inter frames, the
AVIF gain map (`tmap`), overlay (`iovl`), iloc construction method 2
and track-only layouts, ThunderScan TIFF palettes and lossless
arithmetic JPEG (SOF11). Each is made by a writer here and judged by
OpenCV (cv2 5.0.0: libavif 1.4.2 over libaom, libtiff 4.7.1,
libjpeg-turbo 3.1.2), through which ignis_tpu reads textures:

- AV1 streams: ignis_tpu_torch/utils/av1_enc.py (`encode_frame` with
  `Options`: superres, 4:4:4, 10 bits, loop restoration, film grain,
  tile columns, a hidden key frame shown by show_existing_frame);
- HEIF layouts: scripts/make_avif_items.py; image sequences: Pillow's
  AVIF writer (`save_all`), their clocks zeroed so a rerun writes the
  same bytes;
- ThunderScan: scripts/thunderscan_encoder.py; SOF11:
  scripts/lossless_arith_encoder.py.

Run from the repository's root (needs cv2 and Pillow):

    python scripts/make_named_fixtures.py

Into tests/data/images, each also added to `cv2_pixels.npz` as
cv2.imread reads it (IMREAD_UNCHANGED | ANYDEPTH | ANYCOLOR, alpha
dropped; the other entries stay as they are) and each AVIF's coding
tools to tests/data/avif_tools.json, the files of FIXTURES;
into tests/data/images_unread those of UNREAD_FIXTURES, which cv2 reads
nothing of. Before anything is written, each file is checked: cv2
reads each of FIXTURES and nothing of each of UNREAD_FIXTURES."""
from __future__ import annotations

import io
import json
import sys
from pathlib import Path

import cv2
import numpy as np
from PIL import Image

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))
import lossless_arith_encoder as LA  # noqa: E402
import make_avif_items as I  # noqa: E402
import thunderscan_encoder as TE  # noqa: E402
from ignis_tpu_torch.utils import av1_enc, avif  # noqa: E402
from ignis_tpu_torch.utils.av1 import (RESTORE_SGRPROJ,  # noqa: E402
                                       RESTORE_SWITCHABLE, RESTORE_WIENER)

DATA = ROOT / "tests" / "data"
OUT = DATA / "images"
UNREAD = DATA / "images_unread"
FLAGS = cv2.IMREAD_UNCHANGED | cv2.IMREAD_ANYDEPTH | cv2.IMREAD_ANYCOLOR


# ---- sources ------------------------------------------------------------
def yuv_planes(h, w, seed, bd=8, ssx=1, ssy=1):
    """Smooth seeded Y, U, V planes (int32, `bd` bits) of an h x w
    picture at the subsampling (ssx, ssy): waves, noise and a bright
    square."""
    rng = np.random.default_rng(seed)
    out = []
    for p in range(3):
        sx, sy = (ssx, ssy) if p else (0, 0)
        ph, pw = (h + sy) >> sy, (w + sx) >> sx
        yy, xx = np.mgrid[0:ph, 0:pw]
        v = 0.5 + 0.4 * np.sin(xx * (1 + sx) / (3.0 + p) + seed + p) * \
            np.cos(yy * (1 + sy) / (4.0 + p))
        v += rng.normal(0, 0.05, v.shape)
        v[ph // 4:ph // 2, pw // 4:pw // 2] = 0.9 - 0.3 * p
        out.append(np.clip(np.rint(v * ((1 << bd) - 1)), 0,
                           (1 << bd) - 1).astype(np.int32))
    return out


def grain_params(seed):
    """Film grain parameters for an 8-bit 4:2:0 frame: luma and both
    chroma scaling points, an auto-regressive lag of 2, overlap."""
    rng = np.random.default_rng(seed)

    def points(n):
        xs = np.sort(rng.choice(np.arange(8, 248), n, replace=False))
        return [(int(x), int(rng.integers(40, 200))) for x in xs]
    lag = 2
    n = 2 * lag * (lag + 1)
    g = {"seed": int(rng.integers(1 << 16)), "y": points(4), "cfl": 0,
         "cb": points(2), "cr": points(3), "scaling_shift": 9, "lag": lag,
         "ar_y": [int(v) for v in rng.integers(-12, 13, n)],
         "ar_cb": [int(v) for v in rng.integers(-12, 13, n + 1)],
         "ar_cr": [int(v) for v in rng.integers(-12, 13, n + 1)],
         "ar_shift": 7, "grain_scale_shift": 0, "cb_mult": 128,
         "cb_luma_mult": 192, "cb_offset": 256, "cr_mult": 140,
         "cr_luma_mult": 180, "cr_offset": 250, "overlap": 1, "clip": 0}
    return g


def av1_stream(h, w, seed, **opts):
    """(AV1 OBUs, sequence header OBU, w, h) of av1_enc.encode_frame."""
    o = av1_enc.Options(**opts)
    e = av1_enc.encode_frame(yuv_planes(h, w, seed, o.bd, o.ssx, o.ssy), o)
    return e.obus, e.seq, w, h


def avif_of(stream) -> bytes:
    obus, seq, w, h = stream
    return avif.heif_image(obus, seq, w, h)


def lr(types, shift=0, uv_shift=0, seed=0):
    return {"types": list(types), "shift": shift, "uv_shift": uv_shift,
            "seed": seed}


def _zero_times(data: bytes) -> bytes:
    """mvhd, tkhd and mdhd of a sequence with their creation and
    modification times set to 0 (Pillow writes the clock's)."""
    out = bytearray(data)

    def walk(start, end):
        for b in avif._boxes(bytes(out), start, end):
            if b.type in ("moov", "trak", "mdia"):
                walk(b.body, b.end)
            elif b.type in ("mvhd", "tkhd", "mdhd"):
                n = 16 if out[b.body] == 1 else 8
                out[b.body + 4:b.body + 4 + n] = bytes(n)
    walk(0, len(out))
    return bytes(out)


def pil_sequence(n=3, mode="RGB", seed=0, h=24, w=32) -> bytes:
    """Pillow's AVIF image sequence (save_all) of n seeded frames."""
    rng = np.random.default_rng(seed)
    base = np.stack(yuv_planes(h, w, seed, ssx=0, ssy=0), -1).astype(
        np.uint8)
    frames = []
    for i in range(n):
        img = np.roll(base, 3 * i, axis=1)
        if mode == "RGBA":
            img = np.dstack([img, rng.integers(0, 256, (h, w), np.uint8)])
        frames.append(Image.fromarray(img, mode))
    buf = io.BytesIO()
    frames[0].save(buf, "AVIF", save_all=True, append_images=frames[1:],
                   duration=100)
    return _zero_times(buf.getvalue())


def pil_still(seed, h=24, w=32) -> bytes:
    img = np.stack(yuv_planes(h, w, seed + 50, ssx=0, ssy=0), -1)
    buf = io.BytesIO()
    Image.fromarray(img.astype(np.uint8)).save(buf, "AVIF")
    return buf.getvalue()


def sequence_samples(data: bytes, count=2) -> list:
    """The first `count` samples of a sequence's colour track, by stsz
    and the first chunk (Pillow writes one chunk)."""
    top = {b.type: b for b in avif._boxes(data, 0, len(data))}
    trak = avif._find(data, top["moov"], "trak")
    mdia = avif._find(data, trak, "mdia")
    stbl = avif._find(data, avif._find(data, mdia, "minf"), "stbl")
    t = {b.type: b for b in avif._children(data, stbl)}
    sizes = [avif._uint(data, t["stsz"].body + 12 + 4 * i, 4)
             for i in range(count)]
    off = avif._uint(data, t["stco"].body + 8, 4)
    out = []
    for s in sizes:
        out.append(data[off:off + s])
        off += s
    return out


def key_and_inter(seed=7) -> tuple:
    """(an AV1 item of Pillow's first (key) and second (inter) sequence
    samples, its sequence header OBU): cv2 shows the inter frame."""
    s1, s2 = sequence_samples(pil_sequence(2, seed=seed))
    seq = s1[2:4 + s1[3]]
    return s1 + s2, seq


# ---- AV1 -----------------------------------------------------------------
def _sr(h, w, seed, **opts):
    return avif_of(av1_stream(h, w, seed, **opts))


def tile_list() -> bytes:
    obus, seq, w, h = av1_stream(16, 24, 3)
    return avif.heif_image(obus + av1_enc._obu(8, bytes(4)), seq, w, h)


def inter_first() -> bytes:
    item, seq = key_and_inter()
    s1 = sequence_samples(pil_sequence(2, seed=7))[0]
    inter = item[len(s1):]
    return avif.heif_image(inter[:2] + seq + inter[2:], seq, 32, 24)


# ---- ThunderScan ---------------------------------------------------------
def _palette(seed):
    return np.random.default_rng(seed).integers(0, 1 << 16, (16, 3))


def thunder_runs() -> bytes:
    """Flat stretches longer than 63 pixels (runs of several codes) and
    ramps, 150 pixels a row, in two strips."""
    idx = np.zeros((12, 150), np.uint8)
    idx[:, 70:] = (np.arange(80) // 9) % 16
    idx[3:6, 10:140] = 9
    idx[8] = np.arange(150) % 16
    return TE.thunder_tiff(idx, _palette(1), rows_per_strip=6)


def thunder_codes() -> bytes:
    """An odd width (37) of small and large steps, coded with every code
    kind and skip slot drawn at random, in two strips."""
    rng = np.random.default_rng(2)
    idx = np.cumsum(rng.choice([0, 0, 1, -1, 2, -2, 3, -3, 7], (10, 37)),
                    axis=1) % 16
    return TE.thunder_tiff(idx, _palette(2), rows_per_strip=5,
                           rng=np.random.default_rng(3))


def thunder_grey() -> bytes:
    idx = np.arange(64, dtype=np.uint8).reshape(4, 16) % 16
    import make_image_fixtures as M
    return M.tiff_file(idx[..., None], comp=32809, photo=1, bits=4,
                       encode=TE.encode)


# ---- SOF11 ---------------------------------------------------------------
def _sof11_samples(nc, seed):
    rng = np.random.default_rng(seed)
    v = np.cumsum(rng.integers(-6, 7, (20, 24, nc)), 1) + 128
    return np.clip(v, 0, 255).astype(np.uint8)


def sof11(predictor, nc, pt=0, dac=None, restart=0) -> bytes:
    return LA.sof11_jpeg(_sof11_samples(nc, predictor), predictor, pt,
                         restart, dac)


FIXTURES = {
    "sr_d9_odd.avif": lambda: _sr(30, 61, 1, superres=9),
    "sr_d12_444.avif": lambda: _sr(32, 48, 2, superres=12, ssx=0, ssy=0),
    "sr_d16_10bit.avif": lambda: _sr(32, 64, 3, superres=16, bd=10),
    "sr_two_tiles.avif": lambda: _sr(16, 216, 4, superres=9, tile_cols=1),
    "sr_lr_wiener.avif": lambda: _sr(48, 64, 5, superres=10, lr=lr(
        [RESTORE_WIENER] * 3, seed=5)),
    "sr_lr_sgrproj.avif": lambda: _sr(48, 64, 6, superres=13, lr=lr(
        [RESTORE_SGRPROJ] * 3, seed=6)),
    "sr_lr_switchable.avif": lambda: _sr(40, 60, 7, superres=14, bd=10,
                                         lr=lr([RESTORE_SWITCHABLE] * 3,
                                               uv_shift=1, seed=7)),
    "sr_grain.avif": lambda: _sr(40, 48, 8, superres=11,
                                 grain=grain_params(8)),
    "sr_texture_64.avif": lambda: _sr(64, 64, 9, superres=12, lr=lr(
        [RESTORE_SWITCHABLE] * 3, seed=9)),
    "av1_show_existing.avif": lambda: _sr(24, 40, 10, hidden=True),
    "av1_show_existing_grain.avif": lambda: _sr(
        24, 40, 11, hidden=True, superres=10, grain=grain_params(11)),
    "gain_map_base.avif": lambda: I.gain_map(
        av1_stream(32, 48, 12), av1_stream(16, 24, 13), 48, 32, "base"),
    "gain_map_brand.avif": lambda: I.gain_map(
        av1_stream(32, 48, 12), av1_stream(16, 24, 13), 48, 32, "base",
        tmap_in_idat=True, brand=True),
    "track_only.avif": lambda: I.track_only(pil_sequence(3, seed=14)),
    "track_only_alpha.avif": lambda: I.track_only(
        pil_sequence(2, "RGBA", seed=15)),
    "item_and_track.avif": lambda: I.item_and_track(
        pil_sequence(2, seed=16), avif.parse_avif(pil_still(16))["av1"]),
    "thunder_runs.tif": thunder_runs,
    "thunder_codes.tif": thunder_codes,
}

UNREAD_FIXTURES = {
    "av1_tile_list.avif": tile_list,
    "av1_inter_first.avif": inter_first,
    "sr_narrow_tiles.avif": lambda: _narrow_tiles(),
    "gain_map_tmap_primary.avif": lambda: I.gain_map(
        av1_stream(32, 48, 12), av1_stream(16, 24, 13), 48, 32, "tmap"),
    "gain_map_signature.avif": lambda: I.gain_map(
        av1_stream(32, 48, 12), av1_stream(16, 24, 13), 48, 32, "base",
        brand=True),
    "overlay_16.avif": lambda: I.overlay(
        [av1_stream(16, 16, 17), av1_stream(16, 24, 18)], (40, 30),
        [(0, 0), (28, 20)], fill=(65535, 32768, 0, 65535)),
    "overlay_32.avif": lambda: I.overlay(
        [av1_stream(16, 16, 19), av1_stream(16, 24, 20)], (40, 30),
        [(-6, -4), (20, 10)], wide=True),
    "iloc_method2.avif": lambda: I.method2(*av1_stream(32, 48, 21)),
    "track_avif_brand.avif": lambda: I.track_only(
        pil_sequence(2, seed=22), (b"avis", b"avif", b"mif1", b"miaf")),
    "thunder_grey.tif": thunder_grey,
    "sof11_grey_p1.jpg": lambda: sof11(1, 1),
    "sof11_rgb_p2_dac.jpg": lambda: sof11(2, 3, dac=(1, 3)),
    "sof11_grey_p3_pt1.jpg": lambda: sof11(3, 1, pt=1),
    "sof11_rgb_p4_restart.jpg": lambda: sof11(4, 3, restart=5),
    "sof11_grey_p5_dac.jpg": lambda: sof11(5, 1, dac=(0, 2)),
    "sof11_rgb_p6_pt1.jpg": lambda: sof11(6, 3, pt=1),
    "sof11_rgb_p7.jpg": lambda: sof11(7, 3),
}


def _narrow_tiles() -> bytes:
    """Superres over two tile columns whose first is one 64-pixel
    superblock wide: libaom needs 128 coded pixels a column (the
    decoder's check is lifted while the encoder parses its headers)."""
    from ignis_tpu_torch.utils import av1
    check = av1.Decoder.check_tile_widths
    av1.Decoder.check_tile_widths = lambda self: None
    try:
        return _sr(16, 133, 23, superres=12, tile_cols=1)
    finally:
        av1.Decoder.check_tile_widths = check


def cv2_rgb(data: bytes):
    """cv2.imdecode's samples as RGB (grey replicated, alpha dropped), or
    None."""
    img = cv2.imdecode(np.frombuffer(data, np.uint8), FLAGS)
    if img is None:
        return None
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, -1)
    return np.ascontiguousarray(img[..., 2::-1])


def main():
    files = {name: make() for name, make in FIXTURES.items()}
    unread = {name: make() for name, make in UNREAD_FIXTURES.items()}
    pixels = {}
    for name, data in files.items():
        px = cv2_rgb(data)
        assert px is not None, f"cv2 reads nothing of {name}"
        pixels[name] = px
    for name, data in unread.items():
        assert cv2_rgb(data) is None, f"cv2 reads {name}"
    UNREAD.mkdir(exist_ok=True)
    for name, data in files.items():
        (OUT / name).write_bytes(data)
    for name, data in unread.items():
        (UNREAD / name).write_bytes(data)
    tools_json = DATA / "avif_tools.json"
    tools = json.loads(tools_json.read_text())
    tools.update({name: avif.coding_tools(data)
                  for name, data in files.items() if name.endswith(".avif")})
    tools_json.write_text(json.dumps(tools, indent=1)
                          + "\n")
    npz = OUT / "cv2_pixels.npz"
    every = dict(np.load(npz))
    every.update(pixels)
    buf = io.BytesIO()
    np.savez_compressed(buf, **dict(sorted(every.items())))
    npz.write_bytes(buf.getvalue())
    print(f"wrote {len(files)} fixtures to {OUT} and {len(unread)} to "
          f"{UNREAD}")


if __name__ == "__main__":
    main()
