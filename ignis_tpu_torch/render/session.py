"""Runtime: scene -> progressive rendering session on one device.

Port of the path technique's part of ignis_tpu/render/session.py: load a
scene onto a device (the CUDA card unless the caller names another;
without a card, asking for it raises), `step()` renders one iteration of
settings.spi samples per pixel and adds it to the film. Films of
_COMPACTION_MIN_LANES lanes or more go through the compacting cascade,
smaller ones through the one-stage progressive render, as in the JAX
Runtime; with settings.remat every film takes the differentiable cascade
(`render_lanes(remat=True)`). Lanes are in
row-major pixel order: the JAX package's 32x32 lane tiling served the
TPU kernels' block culling, and since random streams are keyed by pixel
and sample, any lane order gives the same image.
"""
from __future__ import annotations

import torch

from ..models.texture import make_texture_evaluator
from ..scene.build import build_scene
from ..scene.parser import load_from_file, load_from_string
from ..scenedata import RenderSettings, SceneData
from ..techniques.path import check_settings, render_lanes

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


def render_iteration(scene: SceneData, settings: RenderSettings,
                     iteration: int, frame: int) -> torch.Tensor:
    """One iteration: [h, w, 3] mean radiance over settings.spi samples.
    With settings.remat, the differentiable cascade at every film size
    (as ignis_tpu/render/session.py:227): differentiable in the scene's
    tensors that require grad."""
    w, h = settings.width, settings.height
    device = scene.device
    x = torch.arange(w, device=device).repeat(h)
    y = torch.arange(h, device=device).repeat_interleave(w)
    eval_texture = make_texture_evaluator(settings.texture_descs,
                                          scene.textures)
    color = render_lanes(scene, settings, x, y, iteration, frame,
                         compact=(settings.remat
                                  or w * h >= _COMPACTION_MIN_LANES),
                         remat=settings.remat, eval_texture=eval_texture)
    img = torch.stack([color.r, color.g, color.b], dim=-1).reshape(h, w, 3)
    return img * (1.0 / settings.spi)


class Runtime:
    """Progressive rendering session."""

    def __init__(self, scene: SceneData, settings: RenderSettings,
                 warnings=()):
        check_settings(settings, scene)
        self.scene = scene
        self.settings = settings
        self.warnings = list(warnings)
        self.device = scene.device
        self._film = None
        self._iteration = 0
        self._frame = 0
        self._sample_count = 0

    @staticmethod
    def load_from_file(path, *, device="cuda", **overrides) -> "Runtime":
        built = build_scene(load_from_file(path), resolve_device(device),
                            overrides)
        return Runtime(built.data, built.settings, built.warnings)

    @staticmethod
    def load_from_string(text, *, device="cuda", base_dir=".",
                         **overrides) -> "Runtime":
        built = build_scene(load_from_string(text, base_dir),
                            resolve_device(device), overrides)
        return Runtime(built.data, built.settings, built.warnings)

    @property
    def iteration_count(self) -> int:
        return self._iteration

    @property
    def sample_count(self) -> int:
        return self._sample_count

    def step(self) -> "Runtime":
        img = render_iteration(self.scene, self.settings, self._iteration,
                               self._frame)
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
