#!/usr/bin/env python3
"""Read the device intervals of one profiled step two ways, to show that
they count the same work: from the profiler's raw Kineto events
(`ignis_tpu_torch.render.profile.device_spans`, what chip_smoke's profiles
read) and from torch.profiler's FunctionEvents (`prof.events()`, what
they read before the materials slice).

    python3 scripts/torch_profile_readers.py [--json PATH]

Builds the kernels, loads chip_smoke's S1 (512x512, spi 4) on the card,
runs one forward step and one albedo train step (black target) to warm
up, then profiles one of each and prints, for each reader, the number of
device intervals, their summed time and their union, and the kernel
names whose counts differ between the readers. Needs one CUDA card;
imports nothing of JAX.
"""
import argparse
import json
import sys
import time
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def function_event_spans(prof):
    """(name, start us, end us) of every device interval, read through
    the profiler's FunctionEvents."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events() if e.device_type == cuda]


def summary(spans, seconds):
    from ignis_tpu_torch.render.profile import busy_union
    return {"device_ops": len(spans),
            "device_sum_us": sum(e - s for _, s, e in spans),
            "device_busy_us": busy_union((s, e) for _, s, e in spans),
            "read_s": seconds}


def compare(step):
    """Profile one call of `step` and read its device intervals both
    ways."""
    import torch
    from ignis_tpu_torch.render.profile import device_spans
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        step()
        torch.cuda.synchronize()
    out = {}
    for label, reader in (("kineto", device_spans),
                          ("function_events", function_event_spans)):
        t0 = time.perf_counter()
        spans = reader(prof)
        out[label] = summary(spans, time.perf_counter() - t0)
        out[label]["names"] = Counter(n for n, _, _ in spans)
    a, b = out["kineto"].pop("names"), out["function_events"].pop("names")
    out["names_differing"] = {n: [a[n], b[n]] for n in a.keys() | b.keys()
                              if a[n] != b[n]}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", metavar="PATH", help="also write the result")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    import ignis_tpu_torch
    from ignis_tpu_torch import train_step
    print(cs.nvidia_smi_line())
    cs.phase_build()
    rt = ignis_tpu_torch.loadFromString(json.dumps(cs.S1_GLASS_ICO7),
                                        spi=cs.SPI)
    s = rt.settings
    target = torch.zeros((s.height, s.width, 3), device=rt.scene.device)

    def train():
        train_step(rt.scene, s, target, 0, 0, 1e-2)
    result = {"nvidia_smi": cs.nvidia_smi_line()}
    for label, step in (("S1 forward step", rt.step),
                        ("S1 train step", train)):
        step()
        result[label] = compare(step)
        print(label, json.dumps(result[label]), flush=True)
    same = all(r["kineto"]["device_ops"] == r["function_events"]["device_ops"]
               and not r["names_differing"]
               for k, r in result.items() if k != "nvidia_smi")
    print(f"the readers agree on every device interval's name and count: "
          f"{same}")
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
