"""Runtime: scene -> progressive rendering session on one device.

Port of ignis_tpu/render/session.py: load a scene onto a device (the CUDA
card unless the caller names another; without a card, asking for it
raises), `step()` renders one iteration of settings.spi samples per pixel
with the scene's technique and adds it to the film (`render_iteration`):

- path and volpath: films of _COMPACTION_MIN_LANES lanes or more go
  through the compacting cascade, smaller ones through the one-stage
  progressive render, as in the JAX Runtime; with settings.remat every
  film takes the differentiable cascade (`render_lanes(remat=True)`);
- the simple techniques (ao, debug, wireframe, lightvisibility,
  camera_check, env_check): one camera sample of every pixel a call,
  settings.spi calls (the JAX per-sample loop, session.py:273-294);
- lt: the light tracer's film; ppm: the photon pass, grid and camera pass;
- aept: the first step runs the learning iterations and builds the
  guiding CDFs, which the runtime keeps; every step renders guided.

`render_aovs()` returns the Normals, Albedo and Depth AOVs (the info
buffer at pixel centres). `setParameter` / `getParameter` are the JAX
Runtime's (ignis_tpu/render/session.py:346-398): a parameter of the live
registry (SceneData.registry) is copied into its tensor in place, which
the PExpr closures read at evaluation time, so nothing is rebuilt; the
camera's __camera_eye / dir / up replace the camera's tensors; any other
parameter marks the scene for a rebuild before the next step
(`rebuilds` counts them). Lanes are in row-major pixel order: the JAX
package's 32x32 lane tiling served the TPU kernels' block culling, and
since random streams are keyed by pixel and sample, any lane order gives
the same image.

The rest of the JAX Runtime API (ignis_tpu/render/session.py:297-811):
`trace()` (a ray list, streams keyed by the ray's index),
`acquireStats()` (one instrumented iteration), `saveFramebuffer` (a
multilayer EXR with the AOV layers and ig* attributes),
`denoised_framebuffer`, `tonemap`, pickle-free `.npz` checkpoints with
the JAX package's keys (a checkpoint of either package resumes in the
other), `createPass` / `RenderPass`, `parameterDescs`, the AOV registry,
torch.profiler traces, `dumpShader` (the op tables of one profiled
iteration), the reference API's properties and a context manager.
`step()` times itself in `stats` ("Iteration+Compile" for the first
step, then "Iteration") with CUDA events on the card, so it adds no host
sync.

The Runtime keeps the render's tables (`render_tables`) between steps
(made anew each step only under settings.remat), and on a CUDA device it
runs every technique without remat, instanced scenes included, by
replaying CUDA graphs of the technique's program (`make_program`: the
cascade of techniques/cascade.py for path and volpath, simple.
SimpleProgram, a program.LoopProgram for lt and aept's guided pass,
ppm.PPMProgram), the counterpart of the JAX Runtime's jitted iteration
(_compiled_iteration, ignis_tpu/render/session.py:49-63): the first step
captures the programs (techniques/program.py: an eager sizing run of
the instanced pairs, one eager run under torch's sync debug mode
"error", then the graphs, all in the Runtime's one pool), each later
step fills
the iteration, frame and camera and replays. aept's learning iterations
run once before its capture, as a gated program of their own
(aept_guiding), whose graphs are dropped once the guiding is built.
`trace()` replays a kept program.TraceProgram a ray-count bucket and
`acquireStats()` a kept program of the instrumented iteration, both in
the Runtime's pool. `uses_graphs` decides all of this from the scene and
settings before any capture and `Runtime.captured` reports it; the films,
traces and counts equal the eager route's bit for bit (lt's films up to
the order of its splat's atomics on the card). A registry parameter and
a camera change need no new capture; a rebuild drops the tables and
every program, and a new guiding (aept after reset()) drops the step's
graphs.
"""
from __future__ import annotations

import time
from pathlib import Path

import numpy as np
import torch

from ..core import rng as rnglib
from ..core.vec import Color, Vec3
from ..models import camera as cameralib
from ..scene.build import build_scene
from ..scene.parser import load_from_file, load_from_string
from ..scenedata import RenderSettings, SceneData
from ..techniques import SIMPLE, canonical, dispatch_technique
from ..techniques.cascade import CascadeProgram
from ..ops.intersect import Rays
from ..techniques.path import (check_settings, render_lanes,
                               render_lanes_stats, render_tables,
                               stat_quantities, stats_fns, trace_rays)
from ..techniques.program import LoopProgram, TraceProgram, trace_bucket
from ..utils.logger import logger
from ..utils.stats import Statistics

# The JAX package's gate (ignis_tpu/render/session.py:152), carried over;
# where the cascade starts to pay on the card is not measured yet.
_COMPACTION_MIN_LANES = 2 * 4096


def resolve_device(device) -> torch.device:
    """torch.device for `device`; raises when CUDA is asked for and no
    card is present."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but no CUDA device is "
                           "available")
    return device


def _pixels(settings: RenderSettings, device):
    w, h = settings.width, settings.height
    return (torch.arange(w, device=device).repeat(h),
            torch.arange(h, device=device).repeat_interleave(w))


def _image(color: Color, settings: RenderSettings) -> torch.Tensor:
    img = torch.stack([color.r, color.g, color.b], dim=-1)
    return img.reshape(settings.height, settings.width, 3) * (
        1.0 / settings.spi)


def aept_guiding(scene: SceneData, settings: RenderSettings, frame: int,
                 tabs=None, captured: bool = False):
    """aept's guiding CDFs from settings.learning_iterations learning
    iterations (iterations 0, 1, ...), their histograms summed in order.
    With `captured` the iterations run as one gated program
    (program.LoopProgram of aept.learn_fns, the iteration in a device
    buffer), captured as CUDA graphs in a pool of its own on a CUDA device
    and dropped with it once the guiding is built: the counterpart of
    ignis_tpu's _compiled_aept_learn (ignis_tpu/render/session.py:116-128).
    Without it, the eager aept.learn_trace (the CPU, remat)."""
    from ..techniques import aept
    if tabs is None:
        tabs = render_tables(scene, settings)
    x, y = _pixels(settings, scene.device)
    learn = None
    if captured and settings.learning_iterations > 0:
        def fns(sc, tb, it, fr):
            return aept.learn_fns(sc, settings, tb, x, y, it, fr)
        learn = LoopProgram(scene, settings, tabs, fns,
                            settings.spi * settings.max_depth)
        if scene.device.type == "cuda":
            learn.capture(0, frame)
    hs = hc = None
    for it in range(settings.learning_iterations):
        if learn is None:
            s, c = aept.learn_trace(scene, settings, x, y, it, frame, tabs)
        else:
            s, c = learn.run(it, frame)
        if hs is None:
            # a program's result is a view of its buffer
            hs, hc = (s, c) if learn is None else (s.clone(), c.clone())
        else:
            hs, hc = hs + s, hc + c
    return aept.build_guiding(hs, hc)


def render_iteration(scene: SceneData, settings: RenderSettings,
                     iteration: int, frame: int, guiding=None,
                     tabs=None) -> torch.Tensor:
    """One iteration: [h, w, 3] mean radiance over settings.spi samples,
    by the settings' technique. With settings.remat, path and volpath take
    the differentiable cascade at every film size (as
    ignis_tpu/render/session.py:227): differentiable in the scene's
    tensors that require grad. aept uses `guiding` (aept_guiding), and
    learns it first when none is given. `tabs` are the render's tables
    (render_tables), made here when not given."""
    x, y = _pixels(settings, scene.device)
    return _image(render_technique_lanes(scene, settings, x, y, iteration,
                                         frame, guiding, tabs=tabs),
                  settings)


def compact_lanes(settings: RenderSettings) -> bool:
    """Whether path and volpath compact: with settings.remat, or for a film
    of _COMPACTION_MIN_LANES lanes or more."""
    return (settings.remat
            or settings.width * settings.height >= _COMPACTION_MIN_LANES)


def uses_graphs(scene: SceneData, settings: RenderSettings) -> bool:
    """The dispatch rule of Runtime.step(), trace(), acquireStats(), aept's
    learning and the sharded renders (parallel/mesh.py), decided by the
    scene and the settings before any capture: CUDA graphs of the
    captured programs (make_program, program.TraceProgram, the stats and
    learning loops, the shard programs) on a CUDA device without
    settings.remat, whatever the technique and whether or not the scene
    has instances; the eager route on the CPU and under remat."""
    return scene.device.type == "cuda" and not settings.remat


def uses_train_graphs(scene: SceneData, settings: RenderSettings) -> bool:
    """The dispatch rule of parallel/mesh.train_step and
    train_step_sharded, decided by the scene and the settings before any
    capture: CUDA graphs of the differentiable cascade
    (techniques/cascade.DiffCascadeProgram) for a path or volpath scene on
    a CUDA device, instanced or not (the train step takes remat whatever
    the settings say); the eager train step for every other."""
    return (scene.device.type == "cuda"
            and canonical(settings.technique) in ("path", "volpath"))


def make_program(scene: SceneData, settings: RenderSettings, tabs, x, y,
                 guiding=None, pool=None, compact=None):
    """The captured program of the settings' technique for the lanes
    (pixels) x, y over the render's tables `tabs`: the cascade
    (compacting as `compact` says, by default as compact_lanes does) for
    path and volpath, one program of settings.spi camera samples for the
    simple techniques, a gated loop for lt and for aept's guided pass
    (under `guiding`), ppm's photon loop, grid and camera loop. `pool` is
    the CUDA graph pool to capture into."""
    tech = canonical(settings.technique)
    if tech in ("path", "volpath"):
        if compact is None:
            compact = compact_lanes(settings)
        return CascadeProgram(scene, settings, tabs, x, y, compact,
                              pool=pool)
    if tech in SIMPLE:
        from ..techniques.simple import SimpleProgram
        return SimpleProgram(scene, settings, tabs, x, y, pool=pool)
    if tech == "ppm":
        from ..techniques.ppm import PPMProgram
        return PPMProgram(scene, settings, tabs, x, y, pool=pool)
    if tech == "lt":
        from ..techniques.lighttracer import lt_fns

        def fns(sc, tb, it, fr):
            return lt_fns(sc, settings, tb, x, y, it, fr)
    else:
        from ..techniques.aept import sample_fns

        def fns(sc, tb, it, fr):
            return sample_fns(sc, settings, tb, x, y, it, fr, guiding)
    return LoopProgram(scene, settings, tabs, fns,
                       settings.spi * settings.max_depth, pool=pool)


def render_technique_lanes(scene: SceneData, settings: RenderSettings, x, y,
                           iteration: int, frame: int, guiding=None,
                           compact=None, tabs=None) -> Color:
    """render_iteration's work for the lanes (pixels) x, y, by the
    settings' technique: each lane's radiance summed over settings.spi
    samples, in x's lane order; for lt, the whole [h*w] film that these
    lanes' light paths splat into. path and volpath compact when
    `compact` says so (by default as render_iteration does: with
    settings.remat or a film of _COMPACTION_MIN_LANES lanes or more).
    ppm's photon pass and aept's learning iterations (when no `guiding`
    is given) cover the whole scene and film whatever the lanes. `tabs`
    as in render_iteration."""
    tech = canonical(settings.technique)
    if tabs is None:
        tabs = render_tables(scene, settings)
    if tech in ("path", "volpath"):
        if compact is None:
            compact = compact_lanes(settings)
        return render_lanes(scene, settings, x, y, iteration, frame,
                            compact=compact, remat=settings.remat, tabs=tabs)
    if tech in SIMPLE:
        from ..techniques.simple import sample_lanes
        return sample_lanes(scene, settings, tabs, x, y, iteration, frame)
    fn = dispatch_technique(tech)
    if tech in ("lt", "ppm"):
        return fn(scene, settings, x, y, iteration, frame, tabs)
    if guiding is None:
        guiding = aept_guiding(scene, settings, frame, tabs)
    return fn(scene, settings, x, y, iteration, frame, guiding, tabs)


def _ckpt_path(path) -> str:
    """np.savez appends '.npz' when missing; save and load agree on it."""
    p = str(path)
    return p if p.endswith(".npz") else p + ".npz"


def _profiler(device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


class RenderPass:
    """A user compute pass over the film and AOVs (the reference's
    RenderPass). `fn(film [h, w, 3], aovs {name: tensor}, **params)` gets
    tensors on the runtime's device and runs as it is, on every run()."""

    def __init__(self, runtime: "Runtime", fn):
        self._rt = runtime
        self._fn = fn
        self.result = None

    def run(self, with_aovs: bool = False, **params):
        film = self._rt.framebuffer(normalized=True)
        aovs = self._rt.render_aovs() if with_aovs else {}
        self.result = self._fn(film, aovs, **params)
        return self.result


class Runtime:
    """Progressive rendering session."""

    def __init__(self, scene: SceneData, settings: RenderSettings,
                 warnings=(), source=None, overrides=None):
        check_settings(settings, scene)
        self.scene = scene
        self.settings = settings
        self.warnings = list(warnings)
        self.device = scene.device
        self._film = None
        self._iteration = 0
        self._frame = 0
        self._sample_count = 0
        self._aept_guiding = None
        self._source = source          # the parsed scene, for rebuilds
        self._overrides = dict(overrides or {})
        self._params_dirty = False
        self._user_aovs = {}
        self._profiling = None
        self.rebuilds = 0
        self.stats = Statistics()
        self._tables = None       # render_tables, kept until a rebuild
        self._program = None      # the captured program (make_program)
        self._pool = None         # the CUDA graph pool of its programs
        self._trace_programs = {}  # trace()'s TraceProgram a bucket
        self._stats_program = None  # acquireStats()'s LoopProgram
        self.captured = uses_graphs(scene, settings)
        self.capture_seconds = None

    @staticmethod
    def _load(sc, device, overrides) -> "Runtime":
        built = build_scene(sc, resolve_device(device), overrides)
        return Runtime(built.data, built.settings, built.warnings, sc,
                       overrides)

    @staticmethod
    def load_from_file(path, *, device="cuda", **overrides) -> "Runtime":
        return Runtime._load(load_from_file(path), device, overrides)

    @staticmethod
    def load_from_string(text, *, device="cuda", base_dir=".",
                         **overrides) -> "Runtime":
        return Runtime._load(load_from_string(text, base_dir), device,
                             overrides)

    # -- runtime parameters (reference Runtime::setParameter) -----------
    def setParameter(self, name: str, value) -> None:
        """Set a scene parameter (reference Runtime.h:134-142): the camera
        (__camera_eye / __camera_dir / __camera_up) and the live registry
        update in place, with no rebuild; any other parameter rebuilds
        the scene before the next step."""
        cam_fields = {"__camera_eye": "eye", "__camera_dir": "dir",
                      "__camera_up": "up"}
        if name in cam_fields:
            v = [float(x) for x in value]
            vec = Vec3(*[torch.tensor(x, dtype=torch.float32,
                                      device=self.device) for x in v[:3]])
            self.scene = self.scene._replace(
                camera=self.scene.camera._replace(**{cam_fields[name]: vec}))
            return
        reg = self.scene.registry or {}
        if name in reg:
            old = reg[name]
            new = torch.as_tensor(
                [float(x) for x in value] if old.dim() > 0
                else float(value), dtype=torch.float32)
            if new.shape != old.shape:
                raise ValueError(f"parameter '{name}' expects shape "
                                 f"{tuple(old.shape)}")
            with torch.no_grad():
                old.copy_(new)
            if self._source is not None:
                self._source.parameters[name] = value
            return
        if self._source is None:
            raise RuntimeError("setParameter needs a Runtime loaded from a "
                               "scene file or string")
        self._source.parameters[name] = value
        self._params_dirty = True

    def setCameraOrientation(self, eye, dir, up) -> None:
        """The reference's setCameraOrientationParameter."""
        self.setParameter("__camera_eye", eye)
        self.setParameter("__camera_dir", dir)
        self.setParameter("__camera_up", up)

    def getParameter(self, name: str, default=None):
        if self._source is None:
            return default
        return self._source.parameters.get(name, default)

    def parameterDescs(self) -> dict:
        """The scene's declared parameters with their UI metadata
        (reference ParameterDescSet): name -> {type, value, min, max,
        step, description}; plain values get a type and their value."""
        out = {}
        if self._source is None:
            return out
        for name, p in (self._source.parameters or {}).items():
            if isinstance(p, dict):
                d = {"type": p.get("type", "number"),
                     "value": p.get("value", 0)}
                for k in ("min", "max", "step", "description"):
                    if k in p:
                        d[k] = p[k]
            else:
                d = {"type": "vector" if hasattr(p, "__len__")
                     and not isinstance(p, str) else "number", "value": p}
            out[name] = d
        return out

    def createPass(self, fn) -> RenderPass:
        """A user pass (reference Runtime::createPass / runPass):
        fn(film, aovs, **params) over the runtime's tensors."""
        return RenderPass(self, fn)

    def _refresh_parameters(self) -> None:
        """The rebuild that setParameter deferred, if any."""
        if not self._params_dirty:
            return
        self._params_dirty = False
        built = build_scene(self._source, self.device, self._overrides)
        check_settings(built.settings, built.data)
        self.scene, self.settings = built.data, built.settings
        self.warnings = list(built.warnings)
        self._aept_guiding = None
        self._tables = None
        self._program = None
        self._trace_programs = {}
        self._stats_program = None
        self.captured = uses_graphs(self.scene, self.settings)
        self.rebuilds += 1

    def _step_tables(self):
        """The render's tables, made once and kept until a rebuild; with
        settings.remat made anew each step, since they carry the step's
        gradient."""
        if self.settings.remat:
            return None
        if self._tables is None:
            self._tables = render_tables(self.scene, self.settings)
        return self._tables

    def _guiding(self, tabs):
        """aept's guiding, learnt at the first step after a load, rebuild
        or reset and kept; None for the other techniques."""
        if canonical(self.settings.technique) != "aept":
            return None
        if self._aept_guiding is None:
            self._aept_guiding = aept_guiding(self.scene, self.settings,
                                              self._frame, tabs,
                                              self.captured)
        return self._aept_guiding

    def _captured_iteration(self) -> torch.Tensor:
        """One iteration by replaying the technique's CUDA graphs; the
        first call makes the program (after aept's learning) and captures
        it (Program.capture: the sizing run of an instanced scene, the
        warm-up and the graphs, in the Runtime's pool). The camera is copied into the program
        before each run, so a camera change needs no capture."""
        if self._program is None:
            tabs = self._step_tables()
            guiding = self._guiding(tabs)
            t0 = time.perf_counter()
            x, y = _pixels(self.settings, self.device)
            prog = make_program(self.scene, self.settings, tabs, x, y,
                                guiding, self._pool)
            if self.device.type == "cuda":
                prog.capture(self._iteration, self._frame)
                self._pool = prog.pool
            self._program = prog
            self.capture_seconds = time.perf_counter() - t0
        self._program.set_camera(self.scene.camera)
        return _image(self._program.run(self._iteration, self._frame),
                      self.settings)

    @property
    def program(self):
        """The captured program (make_program) once a captured step has
        run, else None; `program.last` counts the last step's bounces by
        gated loop (the cascade's by stage) and its bounce evaluations,
        `program.pairs` holds the instanced groups' pair capacities and
        `program.recaptures` the captures redone after an overflow."""
        return self._program

    # -- properties -----------------------------------------------------
    @property
    def iteration_count(self) -> int:
        return self._iteration

    @property
    def sample_count(self) -> int:
        return self._sample_count

    @property
    def framebuffer_width(self) -> int:
        return self.settings.width

    @property
    def framebuffer_height(self) -> int:
        return self.settings.height

    # the reference Python API's names (frontend/python/runtime.cpp)
    IterationCount = iteration_count
    SampleCount = sample_count
    FramebufferWidth = framebuffer_width
    FramebufferHeight = framebuffer_height

    @property
    def FrameCount(self) -> int:
        return self._frame

    @property
    def SPI(self) -> int:
        return self.settings.spi

    @property
    def Technique(self) -> str:
        return self.settings.technique

    # -- rendering ------------------------------------------------------
    def step(self) -> "Runtime":
        self._refresh_parameters()
        section = "Iteration" if self._iteration > 0 else "Iteration+Compile"
        with self.stats.section(section, self.device):
            if self.captured:
                img = self._captured_iteration()
            else:
                tabs = self._step_tables()
                img = render_iteration(self.scene, self.settings,
                                       self._iteration, self._frame,
                                       self._guiding(tabs), tabs)
            self._film = img if self._film is None else self._film + img
        self._iteration += 1
        self._sample_count += self.settings.spi
        self.stats.add_quantity("CameraRays", self.settings.width
                                * self.settings.height * self.settings.spi)
        return self

    def _capture(self, prog) -> None:
        """Capture `prog` into the Runtime's graph pool on a CUDA device
        (at the current iteration and frame); nothing on the CPU."""
        if self.device.type == "cuda":
            prog.capture(self._iteration, self._frame)
            self._pool = prog.pool

    def acquireStats(self) -> dict:
        """One instrumented iteration of the path technique (the
        reference's --stats; ignis_tpu's path_trace_progressive_stats),
        its quantities added to `stats`: BounceRay, ShadowRay, CameraRay,
        Iteration and the mean lane occupancy OccupancyPct. Leaves the
        film and the counters alone; {} for other techniques. Where
        `captured` (uses_graphs) says so, the iteration replays a kept
        program (program.LoopProgram of path.stats_fns over every pixel,
        its counters on the device, captured in the Runtime's pool at the
        first call, dropped by a rebuild): the counterpart of ignis_tpu's
        _compiled_stats_iteration (ignis_tpu/render/session.py:66-83),
        read once after the replay. Else path.render_lanes_stats."""
        if canonical(self.settings.technique) != "path":
            return {}
        self._refresh_parameters()
        x, y = _pixels(self.settings, self.device)
        if not self.captured:
            _, q = render_lanes_stats(self.scene, self.settings, x, y,
                                      self._iteration, self._frame,
                                      self._step_tables())
        else:
            prog = self._stats_program
            if prog is None:
                settings = self.settings

                def fns(sc, tb, it, fr):
                    return stats_fns(sc, settings, tb, x, y, it, fr)
                prog = LoopProgram(self.scene, settings, self._step_tables(),
                                   fns, settings.spi * settings.max_depth,
                                   self._pool)
                self._capture(prog)
                self._stats_program = prog
            prog.set_camera(self.scene.camera)
            _, counts = prog.run(self._iteration, self._frame)
            q = stat_quantities(counts.tolist())
        lanes = self.settings.width * self.settings.height
        iters = max(q["Iteration"], 1)
        for k, v in q.items():
            self.stats.add_quantity(k, v)
        q["OccupancyPct"] = round(100.0 * q["BounceRay"] / (iters * lanes),
                                  2)
        return q

    def trace(self, rays, spp: int = 1) -> np.ndarray:
        """Ray-list mode (reference Runtime::trace, igtrace): rays [n, 8]
        (origin, direction, tmin, tmax) or [n, 6]; a tmax <= 0 is 3e38.
        Returns [n, 3] radiance averaged over spp samples as numpy. Ray i
        of sample s takes the stream (s, iteration, frame, i, 0, seed),
        as the JAX trace does; the iteration counts up afterwards. lt, ppm
        and aept render films, not rays: they raise ValueError.

        Where `captured` (uses_graphs) says so, the rays go through the
        kept program.TraceProgram of their bucket (program.trace_bucket:
        the power of two of at least 1,024 that holds n), padded with dead
        rays and captured in the Runtime's pool at the bucket's first call:
        the counterpart of ignis_tpu's _compiled_trace (ignis_tpu/render/
        session.py:86-113). A rebuild drops the programs; a registry
        parameter needs no new capture. Else the eager loop of
        path.trace_rays (path, volpath) or simple.TRACES, unpadded. Both
        read the Runtime's kept tables and give the same bits."""
        tech = canonical(self.settings.technique)
        if tech in ("lt", "ppm", "aept"):
            raise ValueError(f"trace() does not support technique '{tech}'")
        rays = np.asarray(rays, np.float32)
        if rays.ndim != 2 or rays.shape[1] not in (6, 8):
            raise ValueError(f"trace() takes [n, 6] or [n, 8] rays, got "
                             f"{rays.shape}")
        if spp < 1:
            raise ValueError(f"trace() needs spp >= 1, got {spp}")
        self._refresh_parameters()
        tabs = self._step_tables() or render_tables(self.scene,
                                                    self.settings)
        if self.captured:
            out = self._trace_program(rays, spp, tabs)
        else:
            out = self._trace_eager(rays, spp, tech, tabs)
        self._iteration += 1
        return out.cpu().numpy()

    def _trace_program(self, rays, spp: int, tabs) -> torch.Tensor:
        n = rays.shape[0]
        full = np.empty((n, 8), np.float32)
        full[:, :6] = rays[:, :6]
        full[:, 6] = rays[:, 6] if rays.shape[1] > 6 else 0.0
        tmax = rays[:, 7] if rays.shape[1] > 7 else np.float32(3.0e38)
        full[:, 7] = np.where(tmax <= 0, np.float32(3.0e38), tmax)
        n_pad = trace_bucket(n)
        prog = self._trace_programs.get(n_pad)
        if prog is None:
            prog = TraceProgram(self.scene, self.settings, tabs, n_pad,
                                self._pool)
            self._trace_programs[n_pad] = prog
        prog.load(full, spp)
        if not prog.captured:
            self._capture(prog)
        prog.set_camera(self.scene.camera)
        acc = prog.run(self._iteration, self._frame)[:, :n]
        return acc.t() / float(spp)

    def _trace_eager(self, rays, spp: int, tech: str, tabs) -> torch.Tensor:
        n = rays.shape[0]
        r = torch.from_numpy(rays).to(self.device)
        col = [r[:, k].contiguous() for k in range(rays.shape[1])]
        f32 = dict(dtype=torch.float32, device=self.device)
        tmin = col[6] if len(col) > 6 else torch.zeros(n, **f32)
        tmax = col[7] if len(col) > 7 else torch.full((n,), 3.0e38, **f32)
        ray = Rays(Vec3(*col[0:3]), Vec3(*col[3:6]), tmin,
                   torch.where(tmax <= 0, 3.0e38, tmax))
        idx = torch.arange(n, device=self.device)
        zero = torch.zeros_like(idx)
        if tech in ("path", "volpath"):
            fn = trace_rays
        else:
            from ..techniques.simple import TRACES
            fn = TRACES[tech]
        acc = None
        for s in range(spp):
            state = rnglib.seed(s, self._iteration, self._frame, idx, zero,
                                self.settings.seed)
            c = fn(self.scene, self.settings, ray, state, tabs)
            c = torch.stack([c.r, c.g, c.b], dim=-1)
            acc = c if acc is None else acc + c
        return acc / float(spp)

    def framebuffer(self, normalized: bool = False) -> torch.Tensor:
        """Accumulated film [h, w, 3] on the runtime's device; divided by
        the iteration count when `normalized`."""
        if self._film is None:
            return torch.zeros((self.settings.height, self.settings.width, 3),
                               dtype=torch.float32, device=self.device)
        if normalized and self._iteration > 0:
            return self._film / self._iteration
        return self._film.clone()

    def reset(self) -> None:
        self._film = None
        self._iteration = 0
        self._sample_count = 0
        if self._aept_guiding is not None:
            # the guided pass's graphs read the guiding: a new one needs
            # a new capture
            self._aept_guiding = None
            self._program = None

    def clearFramebuffer(self, aov: str = "") -> None:
        self.reset()

    def inc_frame(self) -> None:
        self._frame += 1

    def incFrameCount(self) -> None:
        self.inc_frame()

    # -- post-processing and output -------------------------------------
    def denoised_framebuffer(self, method: str = "nlm") -> np.ndarray:
        """The AOV-guided denoised film (the reference's OIDN behind
        Runtime::step): the guided non-local means by default,
        method="atrous" the a-trous filter; computed on the runtime's
        device, returned as numpy."""
        from .denoise import denoise_image, denoise_image_nlm
        fn = denoise_image_nlm if method == "nlm" else denoise_image
        aovs = self.render_aovs()
        out = fn(self.framebuffer(normalized=True), aovs["Normals"],
                 aovs["Albedo"], aovs["Depth"])
        return out.cpu().numpy()

    def tonemap(self, method: int = 3, exposure: float = 0.0,
                offset: float = 0.0) -> np.ndarray:
        """The tonemapped film, uint8 [h, w, 3] (runtime.cpp:264); method
        indexes the reference's tonemap list (3 = ACES)."""
        from .tonemap import tonemap as tm
        out = tm(self.framebuffer(normalized=True),
                 exposure_factor=2.0 ** exposure, exposure_offset=offset,
                 method=method)
        return (np.clip(out.cpu().numpy(), 0.0, 1.0) * 255).astype("uint8")

    def saveFramebuffer(self, path, with_aovs: bool = True) -> None:
        """Multilayer EXR with ig* metadata (reference
        Runtime::saveFramebuffer): the default layer is the normalized
        film, then the Normals / Albedo / Depth and user AOV layers."""
        from ..utils.image import write_exr_multilayer
        layers = {"": self.framebuffer(normalized=True).cpu().numpy()}
        if with_aovs:
            for name, img in self.render_aovs().items():
                layers[name] = img.cpu().numpy()
            layers.update(self._user_aovs)
        cam = self.scene.camera

        def v3(v):
            return (float(v.x), float(v.y), float(v.z))
        metadata = {
            "igCameraType": self.settings.camera_type,
            "igTechniqueType": self.settings.technique,
            "igTarget": self.device.type,
            "igCameraEye": v3(cam.eye),
            "igCameraUp": v3(cam.up),
            "igCameraDir": v3(cam.dir),
            "igSeed": int(self.settings.seed),
            "igSPP": int(self._sample_count),
            "igSPI": int(self.settings.spi),
            "igIteration": int(self._iteration),
            "igFrame": int(self._frame),
        }
        write_exr_multilayer(path, layers, metadata)

    # -- AOV registry (reference Runtime::aovs, getFramebufferForHost) ----
    @property
    def AOVs(self) -> list:
        """Names of the AOV layers; listing them renders nothing."""
        return ["Normals", "Albedo", "Depth"] + list(self._user_aovs)

    def registerAOV(self, name: str, image) -> None:
        """Publish a user AOV layer (a pass's output, a custom buffer); it
        joins getFramebufferForHost and saveFramebuffer."""
        if isinstance(image, torch.Tensor):
            image = image.detach().cpu().numpy()
        img = np.asarray(image, np.float32)
        if img.shape[:2] != (self.settings.height, self.settings.width):
            raise ValueError(f"AOV '{name}' shape {img.shape} != film")
        self._user_aovs[name] = img

    def getFramebufferForHost(self, aov: str = "") -> np.ndarray:
        """The normalized film, or a named AOV layer, as numpy [h, w, 3]
        (the reference Python API, runtime.cpp:232; '' is the colour)."""
        if aov in ("", "Color"):
            return self.framebuffer(normalized=True).cpu().numpy()
        if aov in self._user_aovs:
            img = self._user_aovs[aov]
        elif aov in ("Normals", "Albedo", "Depth"):
            img = self.render_aovs()[aov].cpu().numpy()
        else:
            raise KeyError(f"unknown AOV '{aov}' (have {self.AOVs})")
        if img.ndim == 2:
            img = np.stack([img, img, img], axis=-1)
        return np.asarray(img, np.float32)

    def render_aovs(self) -> dict:
        """The Normals, Albedo ([h, w, 3] each) and Depth ([h, w]) AOVs of
        one ray through each pixel's centre (the info buffer,
        techniques/simple.info_buffer), on the runtime's device."""
        from ..techniques.simple import info_buffer
        s = self.settings
        x, y = _pixels(s, self.device)
        state = rnglib.seed(0, 0, 0, x, y, s.seed)
        half = torch.full(x.shape, 0.5, device=self.device)
        rays = cameralib.generate_rays(self.scene.camera, s, x, y, half, half)
        normals, albedo, depth = info_buffer(
            self.scene, s, rays, state, render_tables(self.scene, s))

        def im(c):
            return torch.stack(list(c), dim=-1).reshape(s.height, s.width, 3)
        return {"Normals": im(normals), "Albedo": im(albedo),
                "Depth": im(depth)[..., 0]}

    # -- profiling ------------------------------------------------------
    def startProfilerTrace(self, log_dir) -> None:
        """Start a torch.profiler capture of whatever runs until
        stopProfilerTrace (host ops, and device kernels on the card)."""
        if self._profiling is not None:
            raise RuntimeError("a profiler trace is already running")
        prof = _profiler(self.device)
        prof.__enter__()
        self._profiling = (prof, Path(log_dir))

    def stopProfilerTrace(self) -> str:
        """End the capture and write it as a Chrome trace,
        LOG_DIR/trace.json; returns LOG_DIR."""
        if self._profiling is None:
            raise RuntimeError("no profiler trace is running")
        prof, log_dir = self._profiling
        self._profiling = None
        prof.__exit__(None, None, None)
        log_dir.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(log_dir / "trace.json"))
        return str(log_dir)

    def dumpShader(self, path=None, full: bool = False) -> str:
        """The port's counterpart of the reference's DumpShader /
        DumpShaderFull, which the JAX package answers with the render
        iteration's jaxpr and compiled HLO: one render iteration runs
        under torch.profiler (the film and the counters stay as they
        are), and ``full=False`` returns its table of torch ops,
        ``full=True`` its table of device kernels (on the CPU, where the
        ops run themselves, the op table by input shape). Written to
        `path` too when given."""
        prof = _profiler(self.device)
        with prof:
            render_iteration(self.scene, self.settings, self._iteration,
                             self._frame, self._aept_guiding)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        if not full:
            text = prof.key_averages().table(sort_by="cpu_time_total",
                                             row_limit=-1)
        elif self.device.type == "cuda":
            from .profile import device_spans
            kernels = {}
            for name, t0, t1 in device_spans(prof):
                c, us = kernels.get(name, (0, 0.0))
                kernels[name] = (c + 1, us + t1 - t0)
            rows = sorted(kernels.items(), key=lambda kv: -kv[1][1])
            text = "\n".join([f"{'count':>8} {'device us':>12}  kernel"] + [
                f"{c:8d} {us:12.1f}  {name}" for name, (c, us) in rows])
        else:
            text = prof.key_averages(group_by_input_shape=True).table(
                sort_by="self_cpu_time_total", row_limit=-1)
        if path is not None:
            Path(path).write_text(text)
        return text

    # -- checkpoints ----------------------------------------------------
    def saveCheckpoint(self, path) -> None:
        """The progressive render's state as a pickle-free .npz: the
        accumulated film, the iteration / frame / sample counters, the
        seed and the registry's parameters, under the JAX package's keys,
        so either package resumes the other's checkpoint. Random streams
        are keyed by (sample, iteration, frame, pixel), so a resume
        continues the same sample sequence."""
        reg = {k: v.detach().cpu().numpy()
               for k, v in (self.scene.registry or {}).items()}
        np.savez(
            _ckpt_path(path),
            film=(self._film.cpu().numpy() if self._film is not None
                  else np.zeros(0, np.float32)),
            iteration=self._iteration, frame=self._frame,
            sample_count=self._sample_count, seed=self.settings.seed,
            # a unicode dtype, not object: loading never needs pickle
            registry_names=np.array(list(reg), dtype="U"),
            **{f"reg_{k}": v for k, v in reg.items()})

    def loadCheckpoint(self, path) -> "Runtime":
        """Restore a saveCheckpoint state into this session of the same
        scene."""
        with np.load(_ckpt_path(path), allow_pickle=False) as z:
            film = z["film"]
            self._film = (torch.from_numpy(np.asarray(film, np.float32))
                          .to(self.device) if film.size else None)
            self._iteration = int(z["iteration"])
            self._frame = int(z["frame"])
            self._sample_count = int(z["sample_count"])
            if int(z["seed"]) != int(self.settings.seed):
                logger.warning(
                    f"checkpoint seed {int(z['seed'])} != scene seed "
                    f"{self.settings.seed}; sample streams will differ")
            for k in z["registry_names"]:
                self.setParameter(str(k), np.asarray(z[f"reg_{k}"]).tolist())
        self._refresh_parameters()
        return self

    # the reference Python API's context manager
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False
