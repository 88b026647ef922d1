"""Captured post-processing: the port's counterpart of the jax.jit that
ignis_tpu puts on denoise_image, denoise_image_nlm, tonemap, image_info
and the glare reductions.

Each of those functions is written as a body over tensors: its images,
its traced arguments (the floats that JAX traces: sigmas, scales,
exposures, the camera's vectors) as 0-d or [3] float32 tensors, and the
constants it needs, made once when the body is built. The plain function
builds the body and calls it on the spot. A `PostProgram` holds one body
at one key over fixed device buffers, and on the card one CUDA graph of
it: a call copies the images and the traced values into the buffers
(device copies and fills, no host sync), replays the graph and clones
the outputs out of the graph's pool. A graph freezes every Python value,
so every argument that JAX traces lives in a buffer and a changed sigma
replays with the new one; the static arguments are in the key.

Dispatch (`uses_program`): every input a CUDA tensor, none requiring
grad. The CPU and autograd take the plain function. The first call of a
key runs the plain function too (a one-off call, as `cli --denoise`
makes, costs less plain than captured); the second builds the program,
captures it and replays; later calls replay. A capture that fails
raises. The keeper holds at most MAX_PROGRAMS keys a device, least
recently used first out (JAX's jit cache is the counterpart);
`release_programs()` drops them all.
"""
from __future__ import annotations

import gc
import threading
import time
from collections import OrderedDict

import torch

MAX_PROGRAMS = 16

_LOCK = threading.RLock()
_KEPT: dict = {}          # device -> OrderedDict(key -> PostProgram | None)


def uses_program(*args) -> bool:
    """True when every tensor among args lies on a CUDA device and none
    requires grad (non-tensor arguments are traced values)."""
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    return bool(tensors) and all(t.is_cuda and not t.requires_grad
                                 for t in tensors)


def as_traced(values, device) -> list:
    """The plain route's traced arguments: each value as a float32 tensor
    on `device` (what a program's buffers hold after `load`)."""
    return [torch.as_tensor(v, dtype=torch.float32, device=device)
            for v in values]


def _fill(buf: torch.Tensor, value) -> None:
    """Copy a traced value into its buffer without a host sync: a Python
    number is a fill kernel's argument, a device tensor a device copy."""
    if isinstance(value, torch.Tensor):
        buf.copy_(value.reshape(buf.shape))
    elif buf.dim() == 0:
        buf.fill_(float(value))
    else:
        for i, v in enumerate(value):
            buf[i].fill_(float(v))


class PostProgram:
    """`body(inputs, traced)` over fixed buffers: `inputs` are the image
    buffers (None for an absent optional input), `traced` the traced
    arguments' float32 buffers. Without a graph (the CPU) a call runs the
    body on the buffers; after `capture()` a call replays its graph."""

    def __init__(self, body, inputs, traced):
        self.body = body
        self.device = next(t for t in inputs if t is not None).device
        self.inputs = [None if t is None else torch.empty_like(t)
                       for t in inputs]
        self.traced = [torch.zeros(torch.as_tensor(v).shape,
                                   dtype=torch.float32, device=self.device)
                       for v in traced]
        self.graph = None
        self.pool = None
        self.outputs = None
        self.capture_seconds = 0.0
        self.replays = 0

    def load(self, inputs, traced) -> None:
        for buf, t in zip(self.inputs, inputs):
            if buf is not None:
                buf.copy_(t)
        for buf, v in zip(self.traced, traced):
            _fill(buf, v)

    def _run_body(self):
        return tuple(self.body(self.inputs, self.traced))

    def capture(self) -> None:
        """One eager run under torch's sync debug mode "error" (a host
        sync in the body raises), then the body recorded as a CUDA graph
        in the program's own pool, with the cyclic collector off while it
        records. The buffers must hold a call's values."""
        if self.device.type != "cuda":
            raise ValueError("post_program: CUDA graphs need a CUDA device")
        t0 = time.perf_counter()
        with torch.no_grad(), torch.cuda.device(self.device):
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
            try:
                self._run_body()
            finally:
                torch.cuda.set_sync_debug_mode(mode)
            pool = torch.cuda.graph_pool_handle()
            g = torch.cuda.CUDAGraph()
            collecting = gc.isenabled()
            gc.disable()
            try:
                # thread_local: the viewer tonemaps in its render thread
                with torch.cuda.graph(g, pool=pool,
                                      capture_error_mode="thread_local"):
                    outputs = self._run_body()
            finally:
                if collecting:
                    gc.enable()
            torch.cuda.synchronize(self.device)
        self.graph, self.pool, self.outputs = g, pool, outputs
        self.capture_seconds = time.perf_counter() - t0

    def __call__(self, inputs, traced) -> tuple:
        """The body's outputs for these inputs and traced values, as fresh
        tensors."""
        self.load(inputs, traced)
        if self.graph is None:
            with torch.no_grad():
                return tuple(t.clone() for t in self._run_body())
        with torch.cuda.device(self.device):
            self.graph.replay()
            self.replays += 1
            return tuple(t.clone() for t in self.outputs)


def _key(name, statics, inputs):
    return (name, statics, tuple(
        None if t is None else (tuple(t.shape), t.dtype) for t in inputs))


def kept(device) -> OrderedDict:
    """The keeper's entries on `device`, least recently used first: key ->
    PostProgram, or None for a key called once."""
    return _KEPT.setdefault(torch.device(device), OrderedDict())


def program_of(name, statics, inputs):
    """The kept PostProgram of this call's key, or None."""
    device = next(t for t in inputs if t is not None).device
    return kept(device).get(_key(name, statics, inputs))


def call(name, statics, inputs, traced, build, plain) -> tuple:
    """One call of a post-processing function through the keeper.

    `name` and `statics` (the static arguments) with the inputs' shapes
    (None for an absent optional input) make the key; `traced` are the
    traced values; `build()` makes the body for this key; `plain()` runs
    the plain function. The first call of a key returns plain()'s result,
    later ones the program's outputs."""
    key = _key(name, statics, inputs)
    device = next(t for t in inputs if t is not None).device
    with _LOCK:
        programs = kept(device)
        if key not in programs:
            programs[key] = None
            while len(programs) > MAX_PROGRAMS:
                programs.popitem(last=False)     # least recently used
            first = True
        else:
            programs.move_to_end(key)
            first = False
            prog = programs[key]
            if prog is None:
                prog = PostProgram(build(), inputs, traced)
                if device.type == "cuda":
                    prog.load(inputs, traced)
                    prog.capture()
                programs[key] = prog
            out = prog(inputs, traced)
    return plain() if first else out


def release_programs() -> None:
    """Drop every kept post-processing program: graphs, pools, buffers."""
    with _LOCK:
        _KEPT.clear()
