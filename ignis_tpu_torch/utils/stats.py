"""Render statistics (the reference's Statistics.h; a port of
ignis_tpu/utils/stats.py).

Sections time the runtime's work, quantities count it (camera rays, and
the in-kernel ray counts of `Runtime.acquireStats`). A section on a CUDA
device records a CUDA event on the device's current stream at its start
and end, and no host sync: the elapsed times are read when the report is
made (`dump`, which waits for the device), or earlier for pairs whose end
the device has already passed. A section on the CPU takes the host
clock. `Statistics.dump()` gives the --stats report.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List

import torch

# pending CUDA event pairs kept before the completed ones are folded in
_MAX_PENDING = 64


@dataclass
class SectionTimer:
    total: float = 0.0
    count: int = 0

    def add(self, dt: float):
        self.total += dt
        self.count += 1


@dataclass
class Statistics:
    sections: Dict[str, SectionTimer] = field(default_factory=dict)
    quantities: Dict[str, int] = field(default_factory=dict)
    _pending: List[tuple] = field(default_factory=list, repr=False)

    def section(self, name: str, device=None):
        """Time a block: CUDA events on a CUDA `device`, else the host
        clock."""
        return _SectionCtx(self, name, device)

    def add_time(self, name: str, dt: float):
        self.sections.setdefault(name, SectionTimer()).add(dt)

    def add_quantity(self, name: str, n: int):
        self.quantities[name] = self.quantities.get(name, 0) + int(n)

    def _fold(self, wait: bool):
        """Add the device times of pending sections: all of them with
        `wait` (which waits for the device), else those already ended."""
        keep = []
        for name, start, end in self._pending:
            if wait:
                end.synchronize()
            elif not end.query():
                keep.append((name, start, end))
                continue
            self.add_time(name, start.elapsed_time(end) / 1e3)
        self._pending = keep

    def dump(self, total_iters: int = 0) -> str:
        self._fold(wait=True)
        lines = ["Statistics:"]
        for name, t in sorted(self.sections.items()):
            avg = t.total / max(t.count, 1)
            lines.append(f"  {name:24s} {t.total:9.3f}s total"
                         f"  {avg * 1e3:9.2f}ms avg  x{t.count}")
        for name, q in sorted(self.quantities.items()):
            per = q / max(total_iters, 1)
            lines.append(f"  {name:24s} {q:12d} total  {per:12.1f}/iter")
        return "\n".join(lines)


class _SectionCtx:
    def __init__(self, stats: Statistics, name: str, device):
        self.stats = stats
        self.name = name
        self.device = None if device is None else torch.device(device)

    def _event(self):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    def __enter__(self):
        if self.device is not None and self.device.type == "cuda":
            self.start = self._event()
        else:
            self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.device is not None and self.device.type == "cuda":
            self.stats._pending.append((self.name, self.start,
                                        self._event()))
            if len(self.stats._pending) > _MAX_PENDING:
                self.stats._fold(wait=False)
        else:
            self.stats.add_time(self.name, time.perf_counter() - self.t0)
        return False
