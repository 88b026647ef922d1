"""Hold the port's AVIF writer to cv2's default AVIF on the sources of
tests/data/avif_bars.json: for each, the port's save_image(.avif) of the
same 8-bit pixels, its write seconds, and chip_smoke.avif_against_bars'
figures (PSNR as the port's decoder reads the file back, which is cv2's
reading: tests/test_torch_avif_writer.py; AV1 payload bytes;
base_q_idx) beside cv2's and the bars (PSNR less 0.5 dB, twice the
payload, 148). Needs cv2 and Pillow (for the sources). Run from the
repository's root:

    python scripts/avif_writer_bars.py [--only NAME ...] [--json PATH]

It prints one line a source and exits 1 if any misses a bar.
"""
import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))
import chip_smoke  # noqa: E402
from make_image_fixtures import avif_sources  # noqa: E402

from ignis_tpu_torch.utils import image as imagelib  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", nargs="*", help="the sources to encode")
    ap.add_argument("--json", help="also write the figures to this file")
    args = ap.parse_args()
    bars = json.loads(chip_smoke.AVIF_BARS.read_text())
    pixels = np.load(ROOT / "tests" / "data" / "images" / "cv2_pixels.npz")
    out, missed = {}, 0
    with tempfile.TemporaryDirectory() as tmp:
        for name, src in avif_sources(pixels).items():
            if args.only and name not in args.only:
                continue
            lin = imagelib.srgb_to_linear(src / np.float32(255.0)).astype(
                np.float32)
            path = Path(tmp) / "x.avif"
            t0 = time.perf_counter()
            imagelib.save_image(path, lin)
            sec = time.perf_counter() - t0
            ok, what, psnr, payload = chip_smoke.avif_against_bars(
                path, src, name)
            missed += not ok
            out[name] = {"write_s": sec, "psnr_db": psnr,
                         "file_bytes": path.stat().st_size,
                         "payload_bytes": payload, "cv2": bars[name],
                         "ok": ok}
            print(f"{name} {src.shape[1]}x{src.shape[0]}: written in "
                  f"{sec:.2f} s, {path.stat().st_size} bytes: {what} | cv2 "
                  f"{bars[name]['psnr_db']:.3f} dB, {bars[name]['file_bytes']}"
                  f" bytes | {'ok' if ok else 'MISSED'}", flush=True)
    if args.json:
        Path(args.json).write_text(json.dumps(out, indent=1))
    return 1 if missed else 0


if __name__ == "__main__":
    sys.exit(main())
