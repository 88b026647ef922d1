"""Build, load and launch the port's native libraries.

Each kernel source under ignis_tpu_torch/csrc/ exposes a plain C entry
point that launches on the stream it is given and returns
`cudaGetLastError()`. It is compiled for sm_90a by nvcc into a shared
library under build/ignis_tpu_torch/ in the checkout and loaded with
ctypes; the host-side BVH builder (native/) goes through the same
`compile_and_load` with g++. A library is keyed by a hash of its source,
compiler, flags and host architecture. Nothing here runs at import time,
and a failed build or launch raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import time
from pathlib import Path
from typing import NamedTuple

import torch

from .intersect import Hit, Rays, TriSoup

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ignis_tpu_torch"
# -fmad=false: no a*b+c contraction, so the kernels round every operation
# as the plain torch versions do and agree with them bit for bit on the
# same operation order (exact fp32 Moeller-Trumbore, ops/intersect.py).
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_LIBS: dict = {}
BUILD_LOG: dict = {}   # library name -> (seconds, compiler output)


class Counts(dict):
    """A kernel wrapper's counters: kernel launches and plain-version calls."""

    def __init__(self):
        super().__init__(launches=0, plain_calls=0)

    def reset(self) -> None:
        self.update(launches=0, plain_calls=0)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def compile_and_load(name: str, compiler: str, flags: list, src: Path
                     ) -> ctypes.CDLL:
    """Compile `src` with `compiler *flags src -o lib.so` once per hash of
    the source, the compiler's name, the flags and the host architecture,
    and load the library with ctypes."""
    if name in _LIBS:
        return _LIBS[name]
    key = " ".join([Path(compiler).name, *flags, platform.machine()])
    tag = hashlib.sha256(src.read_bytes() + key.encode()).hexdigest()[:16]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = BUILD_DIR / f"{name}_{tag}.so"
    seconds, log = 0.0, "cached"
    if not so.exists():
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run([compiler, *flags, str(src), "-o", str(tmp)],
                              capture_output=True, text=True, timeout=600)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"{compiler} failed for {src.name}:\n{log}")
        os.replace(tmp, so)
    BUILD_LOG[name] = (seconds, log)
    lib = ctypes.CDLL(str(so))
    _LIBS[name] = lib
    return lib


def load_kernel(name: str, entry: str, argtypes: list):
    """The C entry point `entry` of csrc/<name>.cu, built for sm_90a."""
    fn = getattr(compile_and_load(name, _nvcc(), NVCC_FLAGS,
                                  CSRC / f"{name}.cu"), entry)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def launch(what: str, counts: Counts, fn, *args) -> None:
    """Call a kernel's C entry point; raise on a CUDA error, else count
    one launch."""
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")
    counts["launches"] += 1


def ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


def check_inputs(what: str, device, n: int, *arrays, dtype=torch.float32):
    """Every array on `device`, of `dtype`, contiguous and of length n."""
    for a in arrays:
        if a.device != device:
            raise ValueError(f"{what}: tensor on {a.device}, expected {device}")
        if a.dtype != dtype:
            raise ValueError(f"{what}: dtype {a.dtype}, expected {dtype}")
        if not a.is_contiguous():
            raise ValueError(f"{what}: non-contiguous input")
        if a.numel() != n:
            raise ValueError(f"{what}: {a.numel()} elements, expected {n}")


class HitLaunch(NamedTuple):
    """Checked arguments and fresh outputs of one K1/K2 launch."""
    n: int               # rays
    rays: list           # 8 pointers: org xyz, dir xyz, tmin, tmax
    n_tris: int
    tris: list           # 9 pointers: v0 xyz, e1 xyz, e2 xyz
    vis: int             # shadow_visible pointer, 0 for none
    outs: list           # 5 pointers: t, prim, u, v, occ (0 where unused)
    stream: int
    result: object       # the Hit, or the bool occlusion tensor
    inputs: list         # the ray tensors, alive until the launch


def prepare_hit_launch(what: str, rays: Rays, soup: TriSoup,
                       shadow_visible, any_hit: bool) -> HitLaunch:
    """Check the rays, soup and shadow mask of a launch on the rays' CUDA
    device, and allocate its outputs: a bool occlusion tensor for any-hit,
    else a Hit (t, prim, u, v)."""
    device = rays.tmin.device
    ray_arrays = [a.contiguous() for a in (*rays.org, *rays.dir, rays.tmin,
                                           rays.tmax)]
    n = ray_arrays[0].numel()
    tri_arrays = [*soup.v0, *soup.e1, *soup.e2]
    n_tris = tri_arrays[0].numel()
    check_inputs(f"{what} rays", device, n, *ray_arrays)
    check_inputs(f"{what} soup", device, n_tris, *tri_arrays)
    vis = None
    if any_hit and shadow_visible is not None:
        vis = shadow_visible
        check_inputs(f"{what} shadow_visible", device, n_tris, vis,
                     dtype=torch.bool)
    if any_hit:
        result = torch.empty(n, dtype=torch.bool, device=device)
        outs = (None, None, None, None, result)
    else:
        f32 = dict(dtype=torch.float32, device=device)
        result = Hit(torch.empty(n, **f32),
                     torch.empty(n, dtype=torch.int32, device=device),
                     torch.empty(n, **f32), torch.empty(n, **f32))
        outs = (*result, None)
    return HitLaunch(n, [a.data_ptr() for a in ray_arrays], n_tris,
                     [a.data_ptr() for a in tri_arrays], ptr(vis),
                     [ptr(o) for o in outs],
                     torch.cuda.current_stream(device).cuda_stream, result,
                     ray_arrays)
