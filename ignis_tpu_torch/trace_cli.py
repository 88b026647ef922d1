"""igtrace-equivalent CLI (port of ignis_tpu/trace_cli.py): a ray list
in, radiance out.

    python -m ignis_tpu_torch.trace_cli scene.json < rays.txt

Each input line is `ox oy oz dx dy dz [tmin tmax]`, each output line
`r g b` (Runtime.trace over --spp samples). On the CUDA card unless
`--target cpu`; without a card it exits 2.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from .cli import add_target_args, target_device


def _read_rays(lines):
    rays = []
    for line in lines:
        parts = [float(x) for x in line.split()]
        if len(parts) >= 6:
            rays.append(parts[:8] + [0.0] * (8 - min(len(parts), 8)))
    return rays


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="igtorch-trace")
    p.add_argument("scene")
    p.add_argument("--spp", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("-i", "--input", default="-")
    p.add_argument("-o", "--output", default="-")
    add_target_args(p)
    args = p.parse_args(argv)
    device = target_device(args)
    if device is None:
        return 2

    if args.input == "-":
        rays = _read_rays(sys.stdin)
    else:
        with open(args.input) as src:
            rays = _read_rays(src)
    if not rays:
        print("no rays", file=sys.stderr)
        return 1

    from . import Runtime
    rt = Runtime.load_from_file(args.scene, device=device, seed=args.seed)
    out = rt.trace(np.asarray(rays, np.float32), spp=args.spp)

    lines = "".join(f"{r} {g} {b}\n" for r, g, b in out)
    if args.output == "-":
        sys.stdout.write(lines)
    else:
        with open(args.output, "w") as dst:
            dst.write(lines)
    return 0


if __name__ == "__main__":
    sys.exit(main())
