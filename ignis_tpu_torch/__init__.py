"""ignis_tpu_torch — the path tracer of ignis_tpu, ported to PyTorch and CUDA.

`path` scenes render progressively through `Runtime.step()` on the CUDA
card (`device="cuda"`, the entry points' default, which raises without a
card), with every closest-hit and shadow ray going through
hand-written sm_90a CUDA kernels on the card (K1, BVH8 walk:
ops/bvh_cuda.py; K2, dense intersection: ops/isect_cuda.py) and the hit
attributes through K3 (row gather: ops/gather.py); on the CPU each takes
its plain torch version. `render_iteration` with settings.remat is
differentiable in the scene's tensors (materials, triangle soup and
attributes): closest hits through the fixed-winner backward kernel
(ops/mt_replay.py), attributes through K3's scatter-add. `loss_fn` and
`train_step` are the one-device training step. Imports torch and numpy,
never JAX.
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
