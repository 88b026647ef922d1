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
"""
from __future__ import annotations

import torch

from ..core import rng as rnglib
from ..core.sampler import sample_pixel_offsets
from ..core.vec import Color, Vec3
from ..models import camera as cameralib
from ..models.texture import make_texture_evaluator
from ..scene.build import build_scene
from ..scene.parser import load_from_file, load_from_string
from ..scenedata import RenderSettings, SceneData
from ..techniques import canonical, dispatch_technique
from ..techniques.path import check_settings, render_lanes, render_tables

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
                 tabs=None):
    """aept's guiding CDFs from settings.learning_iterations learning
    iterations (iterations 0, 1, ...)."""
    from ..techniques import aept
    if tabs is None:
        tabs = render_tables(scene, settings)
    x, y = _pixels(settings, scene.device)
    hs = hc = None
    for it in range(settings.learning_iterations):
        s, c = aept.learn_trace(scene, settings, x, y, it, frame, tabs)
        hs, hc = (s, c) if hs is None else (hs + s, hc + c)
    return aept.build_guiding(hs, hc)


def render_iteration(scene: SceneData, settings: RenderSettings,
                     iteration: int, frame: int,
                     guiding=None) -> torch.Tensor:
    """One iteration: [h, w, 3] mean radiance over settings.spi samples,
    by the settings' technique. With settings.remat, path and volpath take
    the differentiable cascade at every film size (as
    ignis_tpu/render/session.py:227): differentiable in the scene's
    tensors that require grad. aept uses `guiding` (aept_guiding), and
    learns it first when none is given."""
    w, h = settings.width, settings.height
    device = scene.device
    x, y = _pixels(settings, device)
    tech = canonical(settings.technique)
    eval_texture = make_texture_evaluator(settings.texture_descs,
                                          scene.textures)
    if tech in ("path", "volpath"):
        return _image(render_lanes(
            scene, settings, x, y, iteration, frame,
            compact=settings.remat or w * h >= _COMPACTION_MIN_LANES,
            remat=settings.remat, eval_texture=eval_texture), settings)
    tabs = render_tables(scene, settings, eval_texture)
    fn = dispatch_technique(tech)
    if tech in ("lt", "ppm"):
        return _image(fn(scene, settings, x, y, iteration, frame, tabs),
                      settings)
    if tech == "aept":
        if guiding is None:
            guiding = aept_guiding(scene, settings, frame, tabs)
        return _image(fn(scene, settings, x, y, iteration, frame, guiding,
                         tabs), settings)
    acc = None
    for s in range(settings.spi):
        state = rnglib.seed(s, iteration, frame, x, y, settings.seed)
        state, (rx, ry) = sample_pixel_offsets(
            settings.pixel_sampler, state, iteration * settings.spi + s, x, y)
        rays = cameralib.generate_rays(scene.camera, settings, x, y, rx, ry,
                                       rng_state=state)
        color = fn(scene, settings, rays, state, tabs)
        acc = color if acc is None else acc + color
    return _image(acc, settings)


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
        self.rebuilds = 0

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

    def getParameter(self, name: str, default=None):
        if self._source is None:
            return default
        return self._source.parameters.get(name, default)

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
        self.rebuilds += 1

    @property
    def iteration_count(self) -> int:
        return self._iteration

    @property
    def sample_count(self) -> int:
        return self._sample_count

    def step(self) -> "Runtime":
        self._refresh_parameters()
        guiding = None
        if canonical(self.settings.technique) == "aept":
            if self._aept_guiding is None:
                self._aept_guiding = aept_guiding(self.scene, self.settings,
                                                  self._frame)
            guiding = self._aept_guiding
        img = render_iteration(self.scene, self.settings, self._iteration,
                               self._frame, guiding)
        self._film = img if self._film is None else self._film + img
        self._iteration += 1
        self._sample_count += self.settings.spi
        return self

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
        self._aept_guiding = None

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
