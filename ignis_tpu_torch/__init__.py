"""ignis_tpu_torch — the ignis_tpu renderer, ported to PyTorch and CUDA.

Scenes render progressively through `Runtime.step()` on the CUDA card
(`device="cuda"`, the entry points' default, which raises without a
card) with the technique the scene names in `technique.type` or the
`technique=` override: path and volpath (the compacting cascade), ao,
debug, wireframe, lightvisibility, camera_check and env_check (one
sample a call), the light tracer (lt), progressive photon mapping (ppm)
and the adaptive environment path tracer (aept), with every alias of
ignis_tpu/techniques/__init__.py. `loadFromString(..., instancing=True)`
keeps one local soup for each mesh that several entities share
(ops/instanced.py), and `Runtime.render_aovs()` returns the Normals,
Albedo and Depth AOVs. Scenes may hold PExpr strings (scene/pexpr.py),
a `parameters` registry that `Runtime.setParameter` updates without a
rebuild, measured klems / tensortree / djmeasured BSDFs and the CIE,
perez and Hosek-Wilkie sky lights. Every closest-hit and shadow ray goes through
hand-written sm_90a CUDA kernels on the card (K1, BVH8 walk:
ops/bvh_cuda.py; K2, dense intersection: ops/isect_cuda.py), the hit
attributes, materials, photons and instance tables through K3 (row
gather: ops/gather.py), and the light tracer's splat and aept's
histograms through K3's scatter-add; on the CPU each takes its plain
torch version. `render_iteration` with settings.remat is differentiable
in the scene's tensors (materials, triangle soup and attributes): closest
hits through the fixed-winner backward kernel (ops/mt_replay.py),
attributes through K3's scatter-add. `loss_fn` and `train_step` are the
one-device training step. Imports torch and numpy, never JAX. CPU tests:
`JAX_PLATFORMS=cpu python -m pytest tests/test_torch_*.py`; on the card,
`python3 chip_smoke.py` and `python -m pytest tests/test_torch_cuda.py -m
cuda`.
"""
from .parallel.mesh import loss_fn, train_step
from .render.session import Runtime, render_iteration
from .scene.build import build_scene
from .scene.parser import load_from_file, load_from_string

__version__ = "0.1.0"


def loadFromFile(path, *, device="cuda", **overrides) -> Runtime:
    return Runtime.load_from_file(path, device=device, **overrides)


def loadFromString(text, *, device="cuda", base_dir=".",
                   **overrides) -> Runtime:
    return Runtime.load_from_string(text, device=device, base_dir=base_dir,
                                    **overrides)
