"""Where one step (a `Runtime.step()`, or a train step) spends its device
time.

`profile_step` runs one step under torch.profiler and reads the device
intervals (kernels, copies, fills) of that same step: their summed time,
the union of their intervals, which is the time the device had work, and
that union over the step's own host wall time (the busy share). The
profiler adds host time per launched kernel, so a step of many small
kernels runs slower under it than without it, and the busy share of a
profiled step is a lower bound on an unprofiled step's.
"""
from __future__ import annotations

import time
from collections import defaultdict

import torch


def busy_union(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, cur_start, cur_end = 0.0, None, None
    for start, end in sorted(intervals):
        if cur_end is None or start > cur_end:
            if cur_end is not None:
                total += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    if cur_end is not None:
        total += cur_end - cur_start
    return total


def device_spans(prof):
    """(name, start us, end us) of every device interval of a finished
    torch.profiler run, read from its raw Kineto events: building the
    profiler's FunctionEvents takes minutes for the million events of a
    large train step."""
    cuda = torch.autograd.DeviceType.CUDA
    raw = getattr(getattr(prof, "profiler", None), "kineto_results", None)
    if raw is None:
        raise RuntimeError("torch.profiler kept no raw Kineto results "
                           "(profiler.kineto_results)")
    return [(e.name(), e.start_ns() / 1e3,
             (e.start_ns() + e.duration_ns()) / 1e3)
            for e in raw.events() if e.device_type() == cuda]


def profile_step(step, named: dict) -> dict:
    """Profile one call of `step` (no arguments) on the CUDA device.

    `named` maps a label to a substring of kernel names (e.g.
    {"K1": "bvh_walk_kernel"}); their device time is reported apiece.
    Times are in microseconds except `wall_s`; `top` lists the eight
    kernel names of most device time with their counts."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = device_spans(prof)
    busy = busy_union((s, e) for _, s, e in spans)
    by_name = defaultdict(lambda: [0, 0.0])
    for name, s, e in spans:
        by_name[name][0] += 1
        by_name[name][1] += e - s
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    return {
        "wall_s": wall,
        "device_ops": len(spans),
        "device_sum_us": sum(e - s for _, s, e in spans),
        "device_busy_us": busy,
        "busy_share": busy / (wall * 1e6) if wall > 0 else 0.0,
        **{f"{label}_us": sum(t for n, (_, t) in by_name.items() if key in n)
           for label, key in named.items()},
        "top": [[name[:90], c, t] for name, (c, t) in ranked[:8]],
    }
