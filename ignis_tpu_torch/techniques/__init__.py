"""Rendering techniques (port of ignis_tpu/techniques/__init__.py).

Every name the JAX package accepts in a scene's `technique.type` (or the
`technique=` override), with its aliases. The session (render/session.py)
runs path and volpath through the compacting cascade, the simple
techniques one sample at a time, and the light tracer, photon mapping and
aept through their own passes.
"""
from __future__ import annotations

ALIASES = {
    "path": "path", "pt": "path",
    "volpath": "volpath",
    "ao": "ao", "aotracer": "ao",
    "debug": "debug",
    "wireframe": "wireframe",
    "lightvisibility": "lightvisibility",
    "camera_check": "camera_check", "cameracheck": "camera_check",
    "env_check": "env_check", "envcheck": "env_check",
    "lt": "lt", "lighttracer": "lt",
    "ppm": "ppm", "photonmapper": "ppm",
    "aept": "aept", "adaptive_env": "aept",
}
TECHNIQUES = frozenset(ALIASES)
# the techniques that shade one camera sample a call (simple.py)
SIMPLE = ("ao", "debug", "wireframe", "lightvisibility", "camera_check",
          "env_check")


def canonical(name: str) -> str:
    """The technique's own name for `name` or one of its aliases."""
    if name not in ALIASES:
        raise ValueError(f"Unknown technique '{name}'")
    return ALIASES[name]


def dispatch_technique(name: str):
    """The function that renders technique `name`: render_lanes for path
    and volpath, a per-sample trace function for the simple techniques,
    lt_trace_film, ppm_render, or aept's sample_trace."""
    c = canonical(name)
    if c in ("path", "volpath"):
        from .path import render_lanes
        return render_lanes
    if c in SIMPLE:
        from . import simple
        return simple.TRACES[c]
    if c == "lt":
        from .lighttracer import lt_trace_film
        return lt_trace_film
    if c == "ppm":
        from .ppm import ppm_render
        return ppm_render
    from .aept import sample_trace
    return sample_trace
