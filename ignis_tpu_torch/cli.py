"""igcli-equivalent command line frontend (port of ignis_tpu/cli.py).

    python -m ignis_tpu_torch.cli scene.json --spp 64 -o out.exr

Renders on the CUDA card by default (`--target auto` or `gpu`; without a
card it exits 2 with a message and never falls back to the CPU);
`--target cpu` renders on the CPU, `--device N` picks cuda:N. Each
iteration is fenced with torch.cuda.synchronize() here, not in
Runtime.step(), and the run ends with the reference's
`# min/med/max (min/med/max Msamples/s)` line (and a JSON line with
--json).
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time


def add_target_args(p: argparse.ArgumentParser) -> None:
    """The device flags every frontend shares."""
    p.add_argument("--target", choices=["auto", "gpu", "cpu"],
                   default="auto",
                   help="device: auto and gpu are the CUDA card (exit 2 "
                        "without one), cpu the CPU")
    p.add_argument("--device", type=int, default=None,
                   help="CUDA device index (cuda:N)")


def target_device(args):
    """The torch device that --target / --device name, or None after
    printing why it is not there (the caller exits 2)."""
    import torch
    if args.target == "cpu":
        if args.device not in (None, 0):
            print(f"error: --device {args.device} with --target cpu",
                  file=sys.stderr)
            return None
        return "cpu"
    if not torch.cuda.is_available():
        print(f"error: --target {args.target} needs a CUDA device and none "
              "is available (use --target cpu for the CPU)",
              file=sys.stderr)
        return None
    index = args.device or 0
    if not 0 <= index < torch.cuda.device_count():
        print(f"error: --device {index} out of range (have "
              f"{torch.cuda.device_count()})", file=sys.stderr)
        return None
    return f"cuda:{index}"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="igtorch", description="ignis_tpu_torch renderer CLI")
    p.add_argument("scene", help="Scene file (JSON)")
    p.add_argument("-o", "--output", default="output.exr",
                   help="Output image path (.exr/.png/.hdr)")
    p.add_argument("--spp", type=int, default=64,
                   help="Total samples per pixel")
    p.add_argument("--spi", type=int, default=1,
                   help="Samples per iteration")
    p.add_argument("--width", type=int, default=None)
    p.add_argument("--height", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--spp-mode", choices=["fixed", "capped"], default="fixed")
    p.add_argument("--timeout", type=float, default=0.0,
                   help="Render time budget in seconds (0 = unlimited)")
    p.add_argument("--instancing", action="store_true",
                   help="two-level geometry: meshes reused by several "
                        "entities are stored once with per-instance "
                        "transforms")
    p.add_argument("--denoise", action="store_true",
                   help="AOV-guided denoise before writing the output")
    p.add_argument("--stats", action="store_true")
    add_target_args(p)
    p.add_argument("--json", action="store_true",
                   help="Print one summary JSON line")
    # user parameters (the reference's ProgramOptions.cpp:151-235)
    p.add_argument("--Pi", "--parameter-int", nargs=2, action="append",
                   default=[], metavar=("NAME", "VALUE"),
                   help="Set integer value in the global registry")
    p.add_argument("--Pn", "--parameter-num", nargs=2, action="append",
                   default=[], metavar=("NAME", "VALUE"),
                   help="Set number value in the global registry")
    p.add_argument("--Pv", "--parameter-vec", nargs=4, action="append",
                   default=[], metavar=("NAME", "X", "Y", "Z"),
                   help="Set vector value in the global registry")
    p.add_argument("--Pc", "--parameter-col", nargs=4, action="append",
                   default=[], metavar=("NAME", "R", "G", "B"),
                   help="Set color value in the global registry")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = target_device(args)
    if device is None:
        return 2
    import torch
    from . import Runtime
    from .utils.image import save_image

    def fence():
        if device != "cpu":
            torch.cuda.synchronize(device)

    overrides = {"spi": args.spi, "seed": args.seed}
    if args.width:
        overrides["width"] = args.width
    if args.height:
        overrides["height"] = args.height
    if args.instancing:
        overrides["instancing"] = True

    t0 = time.time()
    rt = Runtime.load_from_file(args.scene, device=device, **overrides)
    for name, v in args.Pi:
        rt.setParameter(name, int(v))
    for name, v in args.Pn:
        rt.setParameter(name, float(v))
    for entry in args.Pv + args.Pc:
        rt.setParameter(entry[0], [float(x) for x in entry[1:]])
    rt._refresh_parameters()
    for wmsg in rt.warnings:
        print(f"[warn] {wmsg}", file=sys.stderr)
    load_time = time.time() - t0

    iters = max(1, args.spp // max(args.spi, 1))
    w, h = rt.framebuffer_width, rt.framebuffer_height
    samples_per_iter = w * h * rt.settings.spi

    iter_times = []
    t_start = time.time()
    for _ in range(iters):
        it0 = time.time()
        rt.step()
        fence()
        iter_times.append(time.time() - it0)
        if args.timeout > 0 and time.time() - t_start > args.timeout:
            break

    img = (rt.denoised_framebuffer() if args.denoise
           else rt.framebuffer(normalized=True).cpu().numpy())
    save_image(args.output, img)

    # the reference's summary (cli/main.cpp:171), over every iteration;
    # the first one's time includes the kernels' build
    rates = [samples_per_iter / t / 1e6 for t in iter_times]
    mn, md, mx = min(rates), statistics.median(rates), max(rates)
    print(f"# {min(iter_times):.3f}/{statistics.median(iter_times):.3f}/"
          f"{max(iter_times):.3f} ({mn:.3f}/{md:.3f}/{mx:.3f} Msamples/s)")
    if args.stats:
        print(f"Load: {load_time:.2f}s  Iterations: {rt.iteration_count}  "
              f"SPP: {rt.sample_count}")
        q = rt.acquireStats()
        if q:
            print("Quantities (one instrumented iteration): "
                  + "  ".join(f"{k}={v}" for k, v in sorted(q.items())))
        print(rt.stats.dump(total_iters=rt.iteration_count))
    if args.json:
        print(json.dumps({
            "scene": args.scene, "spp": rt.sample_count,
            "msamples_per_s_median": md, "iterations": rt.iteration_count,
            "wall_s": time.time() - t_start, "device": device,
        }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
