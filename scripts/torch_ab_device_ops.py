#!/usr/bin/env python3
"""Device ops of the same profiled steps in two or more trees of the
repository, to tell a change's ops from a machine's or a run's.

    git archive REV | tar -x -C checkout/parent
    python3 scripts/torch_ab_device_ops.py checkout/parent . checkout/parent

Each TREE runs in its own process (its chip_smoke.py and ignis_tpu_torch):
the kernels' build, then chip_smoke's S1 (512x512, spi 4) under `ao` and
`path`: one step profiled after chip_smoke.measure_steps' warm-up and
timed step, and one after 3 and after 4 plain steps
(`ignis_tpu_torch.render.profile.profile_step`). Prints one line
`TREE {"ao measure_steps": N, ...}` a tree. Needs one CUDA card;
imports nothing of JAX.
"""
import json
import subprocess
import sys
from pathlib import Path


def measure(tree: Path) -> dict:
    sys.path.insert(0, str(tree))
    import chip_smoke
    import ignis_tpu_torch
    from ignis_tpu_torch.render.profile import profile_step
    chip_smoke.phase_build()
    text = json.dumps(chip_smoke.S1_GLASS_ICO7)
    out = {}
    for tech in ("ao", "path"):
        def load():
            return ignis_tpu_torch.loadFromString(text, spi=chip_smoke.SPI,
                                                  technique=tech)
        m = chip_smoke.measure_steps(f"S1 {tech}", load(), ["K1"], steps=1)
        out[f"{tech} measure_steps"] = m["profile"]["device_ops"]
        for before in (3, 4):
            rt = load()
            for _ in range(before):
                rt.step()
            out[f"{tech} after {before}"] = profile_step(
                rt.step, {})["device_ops"]
    return out


def main():
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        print(json.dumps(measure(Path(sys.argv[2]).resolve())))
        return
    for tree in sys.argv[1:]:
        run = subprocess.run([sys.executable, __file__, "--one", tree],
                             capture_output=True, text=True, check=True)
        print(tree, run.stdout.strip().splitlines()[-1], flush=True)


if __name__ == "__main__":
    main()
