"""Write the AV1 inter-frame fixtures: AVIF items whose AV1 data is the
first N samples of one of Pillow's AVIF image sequences (a key frame,
then inter frames), as make_named_fixtures.key_and_inter builds its
item. cv2 5.0.0 (libavif over libaom 3.14.1) shows the last frame shown,
an inter frame, and ignis_tpu reads textures through cv2.

Each family varies Pillow's `speed` (0, 3, 6 and 10: the lower, the more
of AV1's inter tools libaom tries), the chroma `subsampling` (4:2:0,
4:2:2, 4:4:4), the motion between frames (shifts, a zoom, a rotation, a
fade, an object moving over a moving background), the size (32 x 24 to
256 x 256) and N (2 to 8); three pass libaom options through Pillow's
`advanced`. Frames are drawn from a seed with numpy and
Pillow's affine resampling.

Run from the repository's root (needs cv2 and Pillow with AVIF):

    python scripts/make_inter_fixtures.py

Into tests/data/images_inter: each fixture's .avif, cv2_pixels.npz (each
as cv2.imdecode reads it, RGB), and tools.json, the coding tools the
port's decoder counts in each file and over the set (av1.count_tools).
Before anything is written each file is checked: cv2 reads it, and its
pixels equal Pillow's own decode (dav1d) of frame N - 1."""
from __future__ import annotations

import io
import json
import sys
from collections import Counter
from pathlib import Path

import cv2
import numpy as np
from PIL import Image

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

from ignis_tpu_torch.utils import av1, avif  # noqa: E402
import make_named_fixtures as F  # noqa: E402

OUT = ROOT / "tests" / "data" / "images_inter"
MOTIONS = ("shift", "zoom", "rotate", "fade", "mixed")


def base_image(h: int, w: int, seed: int) -> np.ndarray:
    """A textured RGB picture: waves per channel, discs, noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.zeros((h, w, 3))
    for c in range(3):
        img[..., c] = 128 + 60 * np.sin(xx / (5 + 3 * c) + rng.uniform(
            0, 6)) * np.cos(yy / (7 + 2 * c))
    for _ in range(6):
        cy, cx = rng.uniform(0, h), rng.uniform(0, w)
        r = rng.uniform(3, max(4, min(h, w) / 3))
        img[(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] = rng.uniform(0, 255, 3)
    img += rng.normal(0, 6, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def frames(h: int, w: int, n: int, motion: str, seed: int) -> list:
    """n frames of `motion` over a picture 64 pixels larger than h x w."""
    big = base_image(h + 64, w + 64, seed)
    im = Image.fromarray(big)
    cx, cy = (w + 64) / 2, (h + 64) / 2
    out = []
    for i in range(n):
        if motion == "shift":
            y0 = 32 + 3 * i - 3 * n // 2
            f = big[y0:y0 + h, 32 - 2 * i:32 - 2 * i + w]
        elif motion == "zoom":
            s = 1 + 0.04 * i
            f = np.asarray(im.transform(im.size, Image.AFFINE, (
                1 / s, 0, cx - cx / s, 0, 1 / s, cy - cy / s),
                Image.BICUBIC))[32:32 + h, 32:32 + w]
        elif motion == "rotate":
            f = np.asarray(im.rotate(2.5 * i, Image.BICUBIC))[
                32:32 + h, 32:32 + w]
        elif motion == "fade":
            f = np.clip(big[32:32 + h, 32:32 + w].astype(np.int64)
                        * (1 - 0.08 * i) + 10 * i, 0, 255).astype(np.uint8)
        else:                                   # an object over a pan
            f = big[32:32 + h, 32 + i:32 + i + w].copy()
            oy, ox = (4 + 2 * i) % h, (4 + 3 * i) % w
            f[oy:oy + h // 4, ox:ox + w // 4] = (200, 40, 90)
        out.append(Image.fromarray(np.ascontiguousarray(f)))
    return out


def sequence(h, w, n, motion, seed, speed, subsampling, advanced=None):
    """Pillow's AVIF sequence of the frames (`advanced`: libaom options),
    its clocks zeroed."""
    fr = frames(h, w, n, motion, seed)
    buf = io.BytesIO()
    fr[0].save(buf, "AVIF", save_all=True, append_images=fr[1:],
               duration=100, speed=speed, subsampling=subsampling,
               advanced=advanced)
    return F._zero_times(buf.getvalue())


def item(h, w, n, motion, seed, speed, subsampling, advanced=None):
    """(the AVIF item of the sequence's N samples, the sequence file)."""
    seq_file = sequence(h, w, n, motion, seed, speed, subsampling, advanced)
    samples = F.sequence_samples(seq_file, n)
    s1 = samples[0]
    seq = s1[2:4 + s1[3]]
    return avif.heif_image(b"".join(samples), seq, w, h), seq_file


# name: (height, width, N, motion, seed, speed, subsampling[, libaom
# options: error resilient frames, segmentation by libaom's variance AQ,
# no order hints])
FIXTURES = {
    "s6_420_shift_24x32_n2": (24, 32, 2, "shift", 1, 6, "4:2:0"),
    "s0_420_mixed_48x64_n4": (48, 64, 4, "mixed", 1, 0, "4:2:0"),
    "s3_422_zoom_80x96_n5": (80, 96, 5, "zoom", 2, 3, "4:2:2"),
    "s10_444_rotate_64x64_n3": (64, 64, 3, "rotate", 3, 10, "4:4:4"),
    "s0_444_fade_40x48_n6": (40, 48, 6, "fade", 4, 0, "4:4:4"),
    "s3_420_rotate_128x128_n6": (128, 128, 6, "rotate", 5, 3, "4:2:0"),
    "s6_422_mixed_72x80_n8": (72, 80, 8, "mixed", 6, 6, "4:2:2"),
    "s0_422_shift_64x72_n7": (64, 72, 7, "shift", 7, 0, "4:2:2"),
    "s10_420_fade_56x40_n5": (56, 40, 5, "fade", 8, 10, "4:2:0"),
    "s0_420_zoom_96x96_n5": (96, 96, 5, "zoom", 9, 0, "4:2:0"),
    "s6_444_zoom_256x256_n8": (256, 256, 8, "zoom", 10, 6, "4:4:4"),
    "s3_420_error_resilient_48x64_n5": (48, 64, 5, "zoom", 12, 3, "4:2:0",
                                        {"error-resilient": "1"}),
    "s3_420_segmentation_64x80_n5": (64, 80, 5, "zoom", 13, 3, "4:2:0",
                                     {"aq-mode": "1"}),
    "s6_420_no_order_hint_64x80_n5": (64, 80, 5, "rotate", 14, 6, "4:2:0",
                                      {"enable-order-hint": "0"}),
    # the texture of chip_smoke.py's inter texture step
    "texture_64x64_n4": (64, 64, 4, "rotate", 11, 3, "4:2:0"),
}


def tools_of(data: bytes) -> Counter:
    """count_tools over every frame of an AVIF item's AV1 data."""
    d = av1.Decoder(avif.parse_avif(data)["av1"])
    if d.frame_done:
        d.finish_frame()
    return d.tools


def main() -> None:
    files, tools, pixels = {}, {}, {}
    total = Counter()
    for name, spec in FIXTURES.items():
        data, seq_file = item(*spec)
        rgb = cv2.imdecode(np.frombuffer(data, np.uint8),
                           cv2.IMREAD_UNCHANGED)
        if rgb is None:
            raise SystemExit(f"cv2 reads nothing of {name}")
        im = Image.open(io.BytesIO(seq_file))
        im.seek(spec[2] - 1)
        if not np.array_equal(rgb[..., ::-1],
                              np.asarray(im.convert("RGB"))):
            raise SystemExit(f"{name}: cv2 and Pillow's frame differ")
        files[name] = data
        pixels[name] = np.ascontiguousarray(rgb[..., ::-1])
        tools[name] = dict(sorted(tools_of(data).items()))
        total.update(tools[name])
        print(f"{name}: {len(data)} bytes", flush=True)
    OUT.mkdir(parents=True, exist_ok=True)
    for name, data in files.items():
        (OUT / f"{name}.avif").write_bytes(data)
    buf = io.BytesIO()
    np.savez_compressed(buf, **pixels)
    (OUT / "cv2_pixels.npz").write_bytes(buf.getvalue())
    tools["all"] = dict(sorted(total.items()))
    (OUT / "tools.json").write_text(json.dumps(tools, indent=1) + "\n")
    for k, v in tools["all"].items():
        print(f"{k}: {v}")


if __name__ == "__main__":
    main()
