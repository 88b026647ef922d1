"""Light tracer (adjoint transport): light paths splat onto the film
through the camera.

Port of ignis_tpu/techniques/lighttracer.py (lighttracer.art): each lane
emits light paths (`sample_emission`), connects every vertex to the
pinhole (one shadow any hit, K1/K2) and bounces with the adjoint BSDF and
Russian roulette; a lane whose path ends starts its next one until it has
traced settings.spi paths. The splat, `.at[pix].add` in the JAX package,
is K3's scatter-add onto an [h*w, 4] film (ops/gather.scatter_add_rows):
the lanes that connect nowhere add zero at pixel 0, which the kernel
skips. The loop runs at most spi * max_depth bounces and ends once no
lane is alive, read on the host once a bounce (the JAX while_loop's
`any(alive)`).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import rng as rnglib
from ..core.vec import (Color, Vec3, color_max_component, cselect, dot,
                        normalize, safe_div, vselect)
from ..models import camera as cameralib
from ..models import light as lightlib
from ..ops import gather as gatherlib
from ..ops.intersect import FLT_MAX, Rays
from ..scenedata import RenderSettings, SceneData
from .path import (OFFSET, RenderTables, _handle_color, occluded_scene,
                   render_tables, shade_hit, trace_scene)


class LTState(NamedTuple):
    org: Vec3
    dir: Vec3
    tmin: torch.Tensor
    rng: torch.Tensor
    contrib: Color
    eta: torch.Tensor
    depth: torch.Tensor
    sample: torch.Tensor
    alive: torch.Tensor


def _emit(scene: SceneData, settings: RenderSettings, tabs: RenderTables, x,
          y, sample, iteration: int, frame: int):
    """Start light paths (make_lt_emitter): (rng, position, direction,
    tmin, radiance over the selection and emission pdfs)."""
    state = rnglib.seed(sample, iteration, frame, x, y, settings.seed)
    state, (ul, u0, u1, u2, u3) = rnglib.next_f32_n(state, 5)
    lsel, sel_pdf = lightlib.select_light(settings, scene.lights, ul,
                                          depth=tabs.info.hier_depth)
    lp = lightlib.gather_light(scene.lights, lsel)
    es = lightlib.sample_emission(scene, lp, u0, u1, u2, u3,
                                  settings.light_kinds)
    radiance = es.intensity * safe_div(torch.abs(es.cos), sel_pdf)
    tmin = torch.where(lp.infinite, 0.0, OFFSET)
    return state, es.pos, es.dir, tmin, radiance


def lt_trace_film(scene: SceneData, settings: RenderSettings, x, y,
                  iteration: int, frame: int,
                  tabs: RenderTables = None) -> Color:
    """The film of one iteration, [h*w] a channel: settings.spi light paths
    from every lane (pixel x, y keys its random streams), splatted where
    they reach the camera. `tabs` are the render's tables (made here when
    not given)."""
    if tabs is None:
        tabs = render_tables(scene, settings)
    n = x.shape[0]
    n_pix = settings.width * settings.height
    device = x.device
    cam = scene.camera
    zero_i = torch.zeros_like(x, dtype=torch.int32)
    rng0, pos0, dir0, tmin0, rad0 = _emit(scene, settings, tabs, x, y,
                                          zero_i, iteration, frame)
    st = LTState(org=pos0, dir=dir0, tmin=tmin0, rng=rng0, contrib=rad0,
                 eta=torch.ones(n, device=device),
                 depth=torch.ones(n, dtype=torch.int32, device=device),
                 sample=zero_i, alive=torch.ones(n, dtype=torch.bool,
                                                 device=device))
    film = torch.zeros((n_pix, 4), dtype=torch.float32, device=device)

    def bounce(state: LTState, film):
        rays_b = Rays(state.org, state.dir, state.tmin,
                      torch.where(state.alive, FLT_MAX, -1.0))
        hit = trace_scene(scene, rays_b, tabs.packed, tabs.inst)
        active = state.alive & (hit.prim >= 0)
        sh = shade_hit(scene, settings, tabs, rays_b, hit,
                       weight_texture=False)
        surf, frame_l, shader = sh.surf, sh.frame, sh.shader
        out_dir = -state.dir
        all_delta = shader.is_all_delta()

        # ---- connect to the camera (lighttracer.art:72) ----------------
        valid_p, pix, cam_dir, cam_w = cameralib.sample_pixel(
            cam, settings, surf.point)
        in_dir = normalize(cam_dir)
        cos_o = dot(out_dir, frame_l.n)
        cos_i = dot(in_dir, frame_l.n)
        d2 = torch.clamp(dot(cam_dir, cam_dir), min=1e-12)
        # shader.eval holds |cos| towards the camera; the rest of the
        # geometry term is 1/d^2, the camera's importance is in cam_w
        f = shader.eval(in_dir, out_dir)
        contrib = _handle_color(state.contrib.cmul(f) * (cam_w * (1.0 / d2)),
                                settings)
        want = (active & ~all_delta & valid_p & ((cos_o * cos_i) > 1e-6)
                & (state.depth + 1 <= settings.max_depth))
        srays = Rays(surf.point, cam_dir, torch.full_like(d2, OFFSET),
                     torch.where(want, 1.0 - float(OFFSET), -1.0))
        ok = want & ~occluded_scene(scene, srays, tabs.packed, tabs.inst)
        splat = torch.stack([torch.where(ok, c, 0.0) for c in contrib])
        film = film + gatherlib.scatter_add_rows(
            torch.where(ok, pix, 0).to(torch.int32), splat, n_pix, 4)

        # ---- adjoint bounce --------------------------------------------
        rng, (b_pick, b0, b1, b2, b_rr) = rnglib.next_f32_n(state.rng, 5)
        bs = shader.sample(out_dir, b_pick, b0, b1, b2, adjoint=True)
        new_contrib = state.contrib.cmul(bs.weight)
        rr_c = color_max_component(new_contrib) * state.eta * state.eta
        rr_prob = torch.clamp(rr_c, 0.05, 0.95)
        rr_prob = torch.where(state.depth + 1 > settings.min_depth, rr_prob,
                              1.0)
        cont = (active & bs.valid & (b_rr < rr_prob) & (bs.pdf > 1e-9)
                & (state.depth + 1 <= settings.max_depth))
        new_contrib = new_contrib * (1.0 / rr_prob)

        # ---- regenerate finished paths ---------------------------------
        do_regen = state.alive & ~cont & (state.sample + 1 < settings.spi)
        new_sample = torch.where(do_regen, state.sample + 1, state.sample)
        rng2, pos, dirn, tmin, rad = _emit(scene, settings, tabs, x, y,
                                           new_sample, iteration, frame)
        return LTState(
            org=vselect(do_regen, pos, surf.point),
            dir=vselect(do_regen, dirn, bs.in_dir),
            tmin=torch.where(do_regen, tmin, OFFSET),
            rng=torch.where(do_regen, rng2, rng),
            contrib=cselect(do_regen, rad,
                            cselect(cont, new_contrib, state.contrib)),
            eta=torch.where(do_regen, 1.0,
                            torch.where(cont, state.eta * bs.eta,
                                        state.eta)),
            depth=torch.where(do_regen, 1, state.depth + 1),
            sample=new_sample, alive=cont | do_regen), film

    it = 0
    while it < settings.spi * settings.max_depth and bool(st.alive.any()):
        st, film = bounce(st, film)
        it += 1
    return Color(film[:, 0], film[:, 1], film[:, 2])
