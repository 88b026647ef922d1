#!/usr/bin/env python3
"""Split a profiled step's device-op count into kernels, memcpys and
memsets, over repeated steps, to show how far the count moves between
steps of one scene.

    python3 scripts/torch_profile_op_kinds.py

Builds the kernels, loads chip_smoke's S6 and S1 (512x512, spi 4) on the
card, runs one warm-up step of each, then profiles S6, S1, S6, S1, S6
(`ignis_tpu_torch.render.profile.profile_step`, the reader chip_smoke's
profiles use) and prints each step's device ops with their split by
kind. Needs one CUDA card; imports nothing of JAX.
"""
import collections
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main():
    import chip_smoke
    import ignis_tpu_torch
    from ignis_tpu_torch.render import profile

    chip_smoke.phase_build()
    s6 = ignis_tpu_torch.loadFromString(json.dumps(
        chip_smoke.s6_scene(ROOT / "build")), spi=4)
    s1 = ignis_tpu_torch.loadFromString(json.dumps(
        chip_smoke.S1_GLASS_ICO7), spi=4)
    s6.step()
    s1.step()
    reader = profile.device_spans
    kinds = []

    def spans(prof):
        out = reader(prof)
        kinds.append(collections.Counter(
            "memcpy" if "Memcpy" in n else "memset" if "Memset" in n
            else "kernel" for n, _, _ in out))
        return out
    profile.device_spans = spans
    for name, rt in (("S6", s6), ("S1", s1), ("S6", s6), ("S1", s1),
                     ("S6", s6)):
        p = profile.profile_step(rt.step, {})
        print(name, p["device_ops"], dict(kinds[-1]), flush=True)


if __name__ == "__main__":
    main()
