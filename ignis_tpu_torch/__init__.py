"""ignis_tpu_torch — the path tracer of ignis_tpu, ported to PyTorch and CUDA.

The first slice: `path` scenes render progressively through
`Runtime.step()` on an explicit device, with every closest-hit and shadow
ray going through hand-written sm_90a CUDA kernels on the card (K1, BVH8
walk: ops/bvh_cuda.py; K2, dense intersection: ops/isect_cuda.py) and
through their plain torch versions on the CPU. Imports torch and numpy,
never JAX.
"""
from .render.session import Runtime, render_iteration
from .scene.build import build_scene
from .scene.parser import load_from_file, load_from_string

__version__ = "0.1.0"


def loadFromFile(path, *, device, **overrides) -> Runtime:
    return Runtime.load_from_file(path, device=device, **overrides)


def loadFromString(text, *, device, base_dir=".", **overrides) -> Runtime:
    return Runtime.load_from_string(text, device=device, base_dir=base_dir,
                                    **overrides)
