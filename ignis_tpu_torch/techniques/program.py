"""The runner that every captured program shares: fixed buffers, device
flags read behind the device, CUDA graphs in one pool, and the instanced
trace's pair capacity with its overflow handling.

The port's counterpart of ignis_tpu's jitted iteration
(_compiled_iteration, ignis_tpu/render/session.py:49-63): a step is a
fixed sequence of programs over tensors allocated once, each program one
CUDA graph on the card. A `while` loop of the JAX package (a
`lax.while_loop` on `any(alive)`) becomes a gated program: it reads the
flag `go` that the program before it published, writes where(go,
bounce(state), state) into its buffers (its lanes enter the bounce dead
when go is off, so the kernels cull all its rays), adds go to the bounce
counter `it` and publishes the loop's test anew. The host queues the
programs and reads each flag behind the device (`_Flags`: the flag that
gates bounce k is copied to pinned memory behind an event, and the host
waits for it only once bounce k is queued), so the card never waits for
the host and each loop ends with one gated-off bounce.

The iteration and frame are 0-d int64 tensors filled before a run and the
camera is the program's own copy (`set_camera`), so one capture serves
every step. On the CPU the programs run as they are, through the same
runner; on the card `capture` makes K1's node records, sizes the
instanced pairs, runs the step once eagerly under torch's sync debug
mode "error" (a host sync in any program raises) and records each
program as a CUDA graph, all in one memory pool (the Runtime's, when it
gives one); `run` replays them and adds the kernel launches each graph
recorded to the wrappers' counts.

Instanced groups: the program's tables carry a PairBudget a group
(ops/instanced.py). The first run (or the capture's first step) is a
sizing run with the eager trace, which keeps each group's largest pair
count; the capacity is that count times HEADROOM, rounded up to
PAIR_ALIGN. Every later trace
compacts into that many slots and folds its count into the budget's
`seen` on the device. After a step the host reads one more flag, whether
any group's `seen` passed its capacity. When it did, the step's result
is thrown away before the caller sees it, each such capacity is raised
to the count it saw times HEADROOM, the programs are captured again
(`recaptures`) and the step runs again.
"""
from __future__ import annotations

import contextlib
import gc
import math
import time
from typing import NamedTuple

import torch

from ..ops import bvh_cuda, cuda_build
from ..ops.instanced import PairBudget
from ..scenedata import RenderSettings, SceneData, tree_map
from .path import RenderTables, leaves

HEADROOM = 1.25     # a capacity over the largest pair count seen
PAIR_ALIGN = 1024   # capacities are multiples of this many pairs


class RunStats(NamedTuple):
    """What one run did, counted on the host: the bounces each gated loop
    ran (the flags read true; for the cascade, each stage's) and the
    bounce programs queued, gated-off ones included. The host waits for
    one flag a queued bounce, and for one more after the step when the
    scene has instanced groups."""
    bounces: tuple
    evaluations: int


class _Flags:
    """A ring of `go` flags copied to host memory (pinned on the card),
    each behind an event."""

    def __init__(self, n: int, device: torch.device):
        cuda = device.type == "cuda"
        self.host = torch.zeros(n, dtype=torch.bool, pin_memory=cuda)
        self.events = ([torch.cuda.Event() for _ in range(n)] if cuda
                       else None)
        self.used = 0

    def push(self, go: torch.Tensor) -> int:
        """Queue a copy of `go`; returns its slot."""
        j = self.used
        self.used += 1
        self.host[j].copy_(go, non_blocking=True)
        if self.events is not None:
            self.events[j].record()
        return j

    def read(self, j: int) -> bool:
        """The flag in slot j, once its copy has landed."""
        if self.events is not None:
            self.events[j].synchronize()
        return bool(self.host[j])


def _on(device: torch.device):
    return (torch.cuda.device(device) if device.type == "cuda"
            else contextlib.nullcontext())


def pair_capacity(count: int) -> int:
    """The capacity for a largest pair count: count * HEADROOM, rounded up
    to a multiple of PAIR_ALIGN (at least PAIR_ALIGN)."""
    return max(1, math.ceil(count * HEADROOM / PAIR_ALIGN)) * PAIR_ALIGN


def with_pair_budgets(tabs: RenderTables) -> RenderTables:
    """`tabs` with a fresh PairBudget in each instanced group's tables
    (the same tensors otherwise)."""
    if tabs.inst is None:
        return tabs
    return tabs._replace(inst=tuple(
        g._replace(pairs=PairBudget(g.members.device)) for g in tabs.inst))


class Program:
    """The runner of a captured program for one scene and settings over
    buffers allocated by the subclass. A subclass gives `_keys()` (every
    program, in capture order), `_program(key)` (runs one program) and
    `_sequence()` (queues one step's programs through `_call` and `_loop`
    and returns the step's result as views of its buffers). `tabs` are the
    render's tables (each instanced group given a PairBudget here);
    `n_flags` bounds the flags one step pushes; `pool` is a CUDA graph
    pool handle to capture into (a new one when None)."""

    def __init__(self, scene: SceneData, settings: RenderSettings,
                 tabs: RenderTables, n_flags: int, pool=None):
        dev = scene.device
        self.device = dev
        self.scene = scene._replace(camera=tree_map(torch.clone,
                                                    scene.camera))
        self.settings = settings
        self.tabs = with_pair_budgets(tabs)
        self.pairs = [g.pairs for g in self.tabs.inst or ()]
        i64 = dict(dtype=torch.int64, device=dev)
        self.iteration = torch.zeros((), **i64)
        self.frame = torch.zeros((), **i64)
        self.it = torch.zeros((), **i64)
        self.go = torch.zeros((), dtype=torch.bool, device=dev)
        self._flags = _Flags(n_flags + 1, dev)
        self._graphs = None
        self.pool = pool
        self.last = None
        self.capture_seconds = None
        self.recaptures = 0
        self._bounces, self._evals = [], 0

    @property
    def captured(self) -> bool:
        return self._graphs is not None

    def set_camera(self, cam) -> None:
        """Copy `cam` (CameraData) into the program's camera."""
        with torch.no_grad():
            for d, s in zip(leaves(self.scene.camera), leaves(cam)):
                if d is not s:
                    d.copy_(s)

    # -- building blocks of the programs --------------------------------
    @staticmethod
    def _write(bufs, vals, go=None) -> None:
        """Copy the state `vals` into the buffers `bufs`; with `go`, only
        where go holds. Every value is made before any buffer is written,
        so a value that aliases another buffer reads its old contents."""
        pairs = list(zip(leaves(bufs), leaves(vals)))
        for b, v in pairs:
            if v.dtype != b.dtype or v.shape != b.shape:
                raise RuntimeError(f"program: a state leaf of {v.dtype} "
                                   f"{tuple(v.shape)} for a buffer of "
                                   f"{b.dtype} {tuple(b.shape)}")
        if go is not None:
            pairs = [(b, v if v is b else torch.where(go, v, b))
                     for b, v in pairs]
        for b, v in pairs:
            if v is not b:
                b.copy_(v)

    def _start_loop(self, bufs, vals, limit: int) -> None:
        """A loop's start: its first state into `bufs`, the bounce counter
        zeroed and the loop's test published."""
        self._write(bufs, vals)
        self.it.zero_()
        self._publish_any(bufs, limit)

    def _gated(self, bufs, bounce, limit: int) -> None:
        """One gated bounce of a loop over the state `bufs` (a NamedTuple
        with an `alive` leaf): the eager loop `while it < limit and
        any(alive): state = bounce(state)`, one step of it."""
        go = self.go
        new = bounce(bufs._replace(alive=bufs.alive & go))
        self._write(bufs, new, go)
        self.it.add_(go.to(torch.int64))
        self._publish_any(bufs, limit)

    def _publish_any(self, bufs, limit: int) -> None:
        self.go.copy_((self.it < limit) & bufs.alive.any())

    # -- the runner -----------------------------------------------------
    def _keys(self) -> list:
        raise NotImplementedError

    def _program(self, key) -> None:
        raise NotImplementedError

    def _sequence(self):
        raise NotImplementedError

    def _full_sequence(self):
        """What one step queues (the forward; a train step adds its
        backward): the sequence that sizes, warms up and captures."""
        return self._sequence()

    def _call(self, key) -> None:
        if self._graphs is None:
            self._program(key)
            return
        graph, delta = self._graphs[key]
        graph.replay()
        cuda_build.add_launches(delta)

    def _loop(self, key) -> None:
        """Queue the gated program `key` until the flag that gates it reads
        false, each flag read one bounce behind."""
        flags = self._flags
        gate = flags.push(self.go)
        k = 0
        while True:
            self._call(key)
            self._evals += 1
            nxt = flags.push(self.go)
            if not flags.read(gate):
                break
            k += 1
            gate = nxt
        self._bounces.append(k)

    def _begin(self, iteration: int, frame: int) -> None:
        self.iteration.fill_(int(iteration))
        self.frame.fill_(int(frame))
        for p in self.pairs:
            p.seen.zero_()
        self._flags.used = 0
        self._bounces, self._evals = [], 0

    def _overflowed(self) -> bool:
        """Whether a trace of the step found more pairs than its group's
        capacity: one flag, read behind the device."""
        if not self.pairs:
            return False
        over = torch.stack([p.seen > p.cap for p in self.pairs]).any()
        return self._flags.read(self._flags.push(over))

    def _size(self, iteration: int, frame: int) -> None:
        """The sizing run: one eager step in which every group without a
        capacity traces with the eager `nonzero` and keeps its largest
        pair count; then its capacity from that count."""
        unsized = [p for p in self.pairs if p.cap is None]
        for p in unsized:
            p.largest = 0
        self._begin(iteration, frame)
        self._full_sequence()
        for p in unsized:
            p.cap = pair_capacity(p.largest)

    def _pack_nodes(self) -> None:
        """K1's packed nodes of the scene's and each group's BVH, which
        K1's wrapper makes at its first call with a host sync
        (bvh_cuda.scene_nodes, kept while the BVH lives): made here, so
        that no program makes them in the warm-up or a capture."""
        for g in (self.scene, *(self.scene.instances or ())):
            if g.bvh is not None:
                bvh_cuda.scene_nodes(g.bvh)

    def _grow(self, iteration: int, frame: int) -> None:
        """After an overflow: each capacity that a trace passed raised to
        the count it saw times HEADROOM (a host read of `seen`, on this
        path alone), and the graphs captured again."""
        for p in self.pairs:
            seen = int(p.seen)
            if seen > p.cap:
                p.cap = pair_capacity(seen)
        self.recaptures += 1
        if self._graphs is not None:
            self.capture(iteration, frame)

    def _execute(self, sequence, iteration: int, frame: int):
        with torch.no_grad(), _on(self.device):
            if any(p.cap is None for p in self.pairs):
                self._size(iteration, frame)
            while True:
                self._begin(iteration, frame)
                out = sequence()
                if not self._overflowed():
                    break
                self._grow(iteration, frame)
        self.last = RunStats(tuple(self._bounces), self._evals)
        return out

    def run(self, iteration: int, frame: int):
        """One step at `iteration` and `frame`: the subclass's result, as
        views of the program's buffers (valid until the next run)."""
        return self._execute(self._sequence, iteration, frame)

    def capture(self, iteration: int = 0, frame: int = 0) -> None:
        """Make K1's packed nodes and size the instanced pairs (the sizing
        run, once), run one step eagerly under torch's sync debug mode
        "error" (the warm-up: it loads the kernels, and a host sync in any
        program raises) and record every program as a CUDA graph, all in
        one memory pool. A capture that fails raises."""
        if self.device.type != "cuda":
            raise ValueError("program: CUDA graphs need a CUDA device")
        t0 = time.perf_counter()
        self._graphs = None
        graphs = {}
        with torch.no_grad(), _on(self.device):
            self._pack_nodes()
            if any(p.cap is None for p in self.pairs):
                self._size(iteration, frame)
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
            try:
                self._begin(iteration, frame)
                self._full_sequence()
            finally:
                torch.cuda.set_sync_debug_mode(mode)
            if self.pool is None:
                self.pool = torch.cuda.graph_pool_handle()
            # a CUDA graph that the cyclic collector frees while a capture
            # runs destroys its executable then, which invalidates the
            # capture: no collection until the graphs are recorded
            collecting = gc.isenabled()
            gc.disable()
            try:
                for key in self._keys():
                    graphs[key] = self._record(key)
            finally:
                if collecting:
                    gc.enable()
            torch.cuda.synchronize(self.device)
        self._graphs = graphs
        self.capture_seconds = time.perf_counter() - t0


    def _record(self, key):
        """(program `key` recorded as a CUDA graph in the pool, the
        launches its replay makes)."""
        g = torch.cuda.CUDAGraph()
        before = cuda_build.launch_snapshot()
        try:
            # thread_local: a viewer's other threads may use the card
            # while its render thread captures
            with torch.cuda.graph(g, pool=self.pool,
                                  capture_error_mode="thread_local"):
                self._program(key)
        finally:
            # the capture launched nothing; each replay will
            delta = cuda_build.launches_since(before)
            cuda_build.add_launches(delta, -1)
        return g, delta


class LoopProgram(Program):
    """A technique whose step is one persistent-lane loop (lt, aept's
    guided pass) as two programs: `start` (the loop's first state) and
    one gated `bounce`. `fns(scene, tabs, iteration, frame)` gives the
    technique's (start(), bounce(state), result(state)) over the
    program's scene (its own camera), tables, iteration and frame;
    `limit` is the loop's bound on bounces."""

    def __init__(self, scene: SceneData, settings: RenderSettings,
                 tabs: RenderTables, fns, limit: int, pool=None):
        super().__init__(scene, settings, tabs, limit + 2, pool)
        self.limit = limit
        self.start, self.bounce, self.result_of = fns(
            self.scene, self.tabs, self.iteration, self.frame)
        with torch.no_grad(), _on(self.device):
            self.st = tree_map(torch.empty_like, self.start())

    def _keys(self) -> list:
        return [("start", 0), ("bounce", 0)]

    def _program(self, key) -> None:
        if key[0] == "start":
            self._start_loop(self.st, self.start(), self.limit)
        else:
            self._gated(self.st, self.bounce, self.limit)

    def _sequence(self):
        self._call(("start", 0))
        self._loop(("bounce", 0))
        return self.result_of(self.st)


def run_loop(st, bounce, limit: int):
    """The eager loop that a LoopProgram gates: `while it < limit and
    any(alive): st = bounce(st)`, one host read of the alive flags a
    bounce (the JAX while_loop's test)."""
    it = 0
    while it < limit and bool(st.alive.any()):
        st = bounce(st)
        it += 1
    return st


TRACE_MIN_BUCKET = 1024


def trace_bucket(n: int) -> int:
    """The ray-list program's bucket for n rays: the power of two of at
    least TRACE_MIN_BUCKET that holds them (ignis_tpu/render/session.py:
    701-704)."""
    n_pad = TRACE_MIN_BUCKET
    while n_pad < n:
        n_pad *= 2
    return n_pad


class TraceProgram(Program):
    """Runtime.trace's ray list as captured programs over `n_pad` lanes:
    the counterpart of ignis_tpu's _compiled_trace (ignis_tpu/render/
    session.py:86-113), one program a bucket (trace_bucket). The rays, the
    sample index, the iteration and the frame live in device buffers that
    `load` and the run fill before the programs run; lanes past the
    list's n are dead rays (org 0, dir (0, 0, 1), tmin 0, tmax -1), and
    since ray i of sample s keeps the stream (s, iteration, frame, i, 0,
    seed), they change no real ray's result. Each sample is, for path and
    volpath, a `start` (the sample's random states and first state), a
    gated `bounce` (at most max_depth, flags read behind the device) and
    `accum`; for the simple techniques one `shade` program. `accum` and
    `shade` write the sample's radiance into `acc` for sample 0 and add it
    for the others, in the eager loop's order, so the sum equals the eager
    trace's bit for bit."""

    def __init__(self, scene: SceneData, settings: RenderSettings,
                 tabs: RenderTables, n_pad: int, pool=None):
        from ..core import rng as rnglib
        from ..core.vec import Vec3
        from ..ops.intersect import Rays
        from . import SIMPLE, canonical
        super().__init__(scene, settings, tabs, settings.max_depth + 2, pool)
        dev = self.device
        self.n_pad = n_pad
        self.spp = 1
        cuda = dev.type == "cuda"
        # rows: org xyz, dir xyz, tmin, tmax
        self.host = torch.zeros((8, n_pad), dtype=torch.float32,
                                pin_memory=cuda)
        self.ray_buf = torch.zeros((8, n_pad), dtype=torch.float32,
                                   device=dev)
        r = self.ray_buf.unbind(0)
        rays = Rays(Vec3(*r[0:3]), Vec3(*r[3:6]), r[6], r[7])
        self.sample = torch.zeros((), dtype=torch.int64, device=dev)
        self.rng = torch.zeros(n_pad, dtype=torch.int64, device=dev)
        self.acc = torch.zeros((3, n_pad), dtype=torch.float32, device=dev)
        idx = torch.arange(n_pad, device=dev)
        zero = torch.zeros_like(idx)
        # the closures read the buffers, not self: a program in no
        # reference cycle is freed as soon as it is dropped
        sample, it, fr = self.sample, self.iteration, self.frame
        scene, tabs = self.scene, self.tabs

        def seed():
            return rnglib.seed(sample, it, fr, idx, zero, settings.seed)
        self._seed = seed
        tech = canonical(settings.technique)
        self.simple = tech in SIMPLE
        if self.simple:
            from .simple import TRACES
            fn = TRACES[tech]

            def shade():
                return fn(scene, settings, rays, seed(), tabs)
            self._shade = shade
        else:
            from .path import trace_fns
            self.start, self.bounce, self.result_of = trace_fns(
                self.scene, settings, self.tabs, rays, self.rng)
            with torch.no_grad(), _on(dev):
                self.st = tree_map(torch.empty_like, self.start())

    def _add(self, c) -> None:
        """acc = c for sample 0, acc + c after it."""
        c = torch.stack(tuple(c))
        self.acc.copy_(torch.where(self.sample == 0, c, self.acc + c))

    def _keys(self) -> list:
        if self.simple:
            return [("shade", 0)]
        return [("start", 0), ("bounce", 0), ("accum", 0)]

    def _program(self, key) -> None:
        kind = key[0]
        if kind == "shade":
            self._add(self._shade())
        elif kind == "start":
            self.rng.copy_(self._seed())
            self._start_loop(self.st, self.start(), self.settings.max_depth)
        elif kind == "bounce":
            self._gated(self.st, self.bounce, self.settings.max_depth)
        else:
            self._add(self.result_of(self.st))

    def _sequence(self) -> torch.Tensor:
        for s in range(self.spp):
            self.sample.fill_(s)
            if self.simple:
                self._call(("shade", 0))
                continue
            # each sample's loop reads its flags from the ring's start:
            # every earlier flag it needs was read
            self._flags.used = 0
            self._call(("start", 0))
            self._loop(("bounce", 0))
            self._call(("accum", 0))
        return self.acc

    def load(self, rays, spp: int) -> int:
        """Copy the ray list `rays` (numpy [n, 8] float32, tmax already
        mapped) into the ray buffers through pinned memory, the lanes past
        n dead, for a run of spp samples; returns n. `run` then returns
        the [3, n_pad] radiance sums as a view of the program's buffer."""
        n = rays.shape[0]
        if n > self.n_pad:
            raise ValueError(f"trace program: {n} rays for a bucket of "
                             f"{self.n_pad}")
        h = self.host.numpy()
        h[:, n:] = 0.0
        h[5, n:] = 1.0
        h[7, n:] = -1.0
        h[:, :n] = rays.T
        self.ray_buf.copy_(self.host, non_blocking=True)
        self.spp = spp
        return n
