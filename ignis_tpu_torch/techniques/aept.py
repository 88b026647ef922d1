"""Adaptive environment path tracer ("aept").

Port of ignis_tpu/techniques/aept.py ("Adaptive Environment Sampling on
CPU and GPU", Atanasov et al. 2018; adaptive_env_pathtracer.art,
AdaptiveEnvPathTechnique.cpp):

1. Learning (`learn_trace`, the first settings.learning_iterations
   iterations, framebuffer locked): a plain path tracer records, for each
   env hit reached through at least one smooth bounce, the path's
   luminance into a [GRID cells x TILE cells] histogram (5,000 x 512
   bins): direction from the camera to the last rough vertex, times the
   outgoing direction. Each bounce's records are one K3 scatter-add onto
   the histogram (ops/gather.scatter_add_rows).
2. `build_guiding` turns it into per-grid-cell 2D CDFs.
3. Sampling (`sample_trace`): at each non-delta vertex whose cell saw
   more than MIN_COUNT samples, the bounce direction comes from the
   guiding CDFs with probability AE_PROB, else from the BSDF, weighted by
   the one-sample MIS mixture pdf. The row searches run a fixed number of
   steps (core/cdf._count_less), with no host sync.

No NEE (the scene loader turns it off for aept by default, as
AdaptiveEnvPathTechnique.cpp:18). The eager loops read `any(alive)` on
the host once a bounce (program.run_loop); on the card the learning
iterations (program.LoopProgram over `learn_fns`, the histogram in the
state) and the guided pass (over `sample_fns`) gate their bounces on the
device.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import rng as rnglib
from ..core.cdf import _count_less
from ..core.vec import (Color, Vec3, black_like, color_max_component,
                        cselect, dot, normalize, safe_div, vselect,
                        white_like)
from ..core.warp import PI, dir_from_spherical, spherical_from_dir
from ..ops import gather as gatherlib
from ..ops.intersect import FLT_MAX, Rays
from ..scenedata import RenderSettings, SceneData
from .path import (OFFSET, RenderTables, _cadd_where, _handle_color,
                   infinite_emissions, regenerate,
                   render_tables, shade_hit, start_state, trace_scene)
from .program import run_loop

GRID_X, GRID_Y = 50, 100    # adaptive_env_pathtracer.art:16-17
TILE_X, TILE_Y = 32, 16     # :18-19
AE_PROB = 0.75              # :462
MIN_COUNT = 100             # guiding on once a cell saw > 100 samples
SMOOTH_PDF = PI             # is_smooth(pdf) = pdf < pi (:233)
N_GRID = GRID_X * GRID_Y
N_TILE = TILE_X * TILE_Y


class Guiding(NamedTuple):
    cond_cdf: torch.Tensor  # [N_GRID * TILE_Y, TILE_X] inclusive row CDFs
    marg_cdf: torch.Tensor  # [N_GRID, TILE_Y] inclusive CDFs
    count: torch.Tensor     # [N_GRID] learning samples


def _grid_cell(pos: Vec3, cam_pos: Vec3):
    dn = normalize(Vec3(pos.x - cam_pos.x, pos.y - cam_pos.y,
                        pos.z - cam_pos.z))
    theta, phi = spherical_from_dir(dn)
    gx = torch.clamp((GRID_X * phi / (2.0 * torch.pi)).to(torch.int32), 0,
                     GRID_X - 1)
    gy = torch.clamp((GRID_Y * theta / torch.pi).to(torch.int32), 0,
                     GRID_Y - 1)
    return gy * GRID_X + gx


def _tile_uv(d: Vec3):
    theta, phi = spherical_from_dir(d)
    return phi / (2.0 * torch.pi), theta / torch.pi


def _tile_cell(d: Vec3):
    theta, phi = spherical_from_dir(d)
    tx = torch.clamp((TILE_X * phi / (2.0 * torch.pi)).to(torch.int32), 0,
                     TILE_X - 1)
    ty = torch.clamp((TILE_Y * theta / torch.pi).to(torch.int32), 0,
                     TILE_Y - 1)
    return ty * TILE_X + tx


def _fresh_state(rays: Rays, rng_state, **extra):
    like = rays.tmin
    return dict(org=rays.org, dir=rays.dir, tmin=rays.tmin, tmax=rays.tmax,
                rng=rng_state, contrib=white_like(like),
                eta=torch.ones_like(like),
                alive=torch.ones_like(like, dtype=torch.bool),
                depth=torch.ones_like(like, dtype=torch.int32),
                sample=torch.zeros_like(like, dtype=torch.int32), **extra)


class _LearnState(NamedTuple):
    org: Vec3
    dir: Vec3
    tmin: torch.Tensor
    tmax: torch.Tensor
    rng: torch.Tensor
    contrib: Color
    eta: torch.Tensor
    last_pos: Vec3
    last_dir: Vec3
    has_rough: torch.Tensor
    alive: torch.Tensor
    depth: torch.Tensor
    sample: torch.Tensor
    hist: torch.Tensor      # [N_GRID * N_TILE, 4]: luminance sums, counts


def _rr(settings, state, weight):
    """(roulette-weighted contribution, survival probability)."""
    new_contrib = state.contrib.cmul(weight)
    rr_c = color_max_component(new_contrib) * state.eta * state.eta
    rr_prob = torch.clamp(rr_c, 0.05, 0.95)
    rr_prob = torch.where(state.depth + 1 > settings.min_depth, rr_prob, 1.0)
    return new_contrib * (1.0 / rr_prob), rr_prob


def learn_trace(scene: SceneData, settings: RenderSettings, x, y,
                iteration: int, frame: int, tabs: RenderTables = None):
    """One learning iteration: the (hist_sum, hist_cnt) increments, each
    [N_GRID * N_TILE] (program.run_loop of learn_fns)."""
    if tabs is None:
        tabs = render_tables(scene, settings)
    start, bounce, result = learn_fns(scene, settings, tabs, x, y,
                                      iteration, frame)
    return result(run_loop(start(), bounce,
                           settings.spi * settings.max_depth))


def learn_fns(scene: SceneData, settings: RenderSettings,
              tabs: RenderTables, x, y, iteration, frame):
    """A learning iteration's loop for the lanes x, y: (start() ->
    _LearnState with its histogram zeroed, bounce, result(state) ->
    (hist_sum, hist_cnt) views of the state's histogram). The histogram
    lives in the state, so a gated program keeps it in its buffers. The
    iteration and frame are ints or 0-d int64 tensors."""
    cam = scene.camera.eye
    n_bins = N_GRID * N_TILE
    # every infinite row counts a record, a delta one with no luminance
    any_inf = bool(tabs.info.infinite)

    def initial(rays, rng_state):
        like = rays.tmin
        z = torch.zeros_like(like)
        zv = Vec3(z, z, torch.ones_like(like))
        return _LearnState(**_fresh_state(
            rays, rng_state, last_pos=zv, last_dir=zv,
            has_rough=torch.zeros_like(like, dtype=torch.bool),
            hist=torch.zeros((n_bins, 4), dtype=torch.float32,
                             device=like.device)))

    def start() -> _LearnState:
        return start_state(scene, settings, x, y, iteration, frame, initial)

    def result(state: _LearnState):
        return state.hist[:, 0], state.hist[:, 1]

    regen = (x, y, iteration, frame)

    def bounce(state: _LearnState) -> _LearnState:
        hist = state.hist
        rays_b = Rays(state.org, state.dir, state.tmin,
                      torch.where(state.alive, state.tmax, -1.0))
        hit = trace_scene(scene, rays_b, tabs.packed, tabs.inst)
        found = hit.prim >= 0
        # an env miss: record into the histogram (:246)
        miss = state.alive & ~found
        if any_inf:
            lum = torch.zeros_like(state.tmin)
            for *_, emit in infinite_emissions(scene, tabs, state.dir):
                c = _handle_color(state.contrib.cmul(emit), settings)
                lum = lum + torch.where(miss, (c.r + c.g + c.b) / 3.0, 0.0)
            record = miss & state.has_rough & (state.depth > 1)
            cell = (_grid_cell(state.last_pos, cam) * N_TILE
                    + _tile_cell(state.last_dir))
            hist = hist + gatherlib.scatter_add_rows(
                torch.where(record, cell, 0).to(torch.int32),
                torch.stack([torch.where(record, lum / settings.spi, 0.0),
                             torch.where(record, 1.0, 0.0)]), n_bins, 4)

        # the surface bounce (a plain path tracer, no NEE: :231)
        active = state.alive & found
        sh = shade_hit(scene, settings, tabs, rays_b, hit,
                       weight_texture=False)
        rng, (b_pick, b0, b1, b2, b_rr) = rnglib.next_f32_n(state.rng, 5)
        bs = sh.shader.sample(-state.dir, b_pick, b0, b1, b2)
        new_contrib, rr_prob = _rr(settings, state, bs.weight)
        cont = (active & bs.valid & (b_rr < rr_prob) & (bs.pdf > 1e-9)
                & (state.depth + 1 <= settings.max_depth))
        smooth = ~bs.is_delta & (bs.pdf < SMOOTH_PDF)
        point = sh.surf.point
        last_pos = vselect(smooth, point, state.last_pos)
        last_dir = vselect(smooth, bs.in_dir, state.last_dir)
        do_regen, new_sample, cam_r, fresh = regenerate(scene, settings,
                                                        regen, state, cont)
        return _LearnState(
            org=vselect(do_regen, cam_r.org, point),
            dir=vselect(do_regen, cam_r.dir, bs.in_dir),
            tmin=torch.where(do_regen, cam_r.tmin, OFFSET),
            tmax=torch.where(do_regen, cam_r.tmax, FLT_MAX),
            rng=torch.where(do_regen, fresh, rng),
            contrib=cselect(do_regen, white_like(state.tmin),
                            cselect(cont, new_contrib, state.contrib)),
            eta=torch.where(do_regen, 1.0,
                            torch.where(cont, state.eta * bs.eta, state.eta)),
            last_pos=last_pos, last_dir=last_dir,
            has_rough=torch.where(do_regen, False,
                                  state.has_rough | (cont & smooth)),
            alive=cont | do_regen,
            depth=torch.where(do_regen, 1, state.depth + 1),
            sample=new_sample, hist=hist)

    return start, bounce, result


def build_guiding(hist_sum: torch.Tensor, hist_cnt: torch.Tensor) -> Guiding:
    """The guiding CDFs (aept_handle_after_iteration_learning): per grid
    cell, the tile rows' conditional CDFs and their marginal; rows
    without weight uniform."""
    device = hist_sum.device
    mean = torch.where(hist_cnt > 0,
                       hist_sum / torch.clamp(hist_cnt, min=1.0), 0.0)
    w = mean.reshape(N_GRID, TILE_Y, TILE_X)
    cond_sum = torch.cumsum(w, dim=-1)
    row_tot = cond_sum[..., -1:]
    uniform_x = torch.arange(1, TILE_X + 1, dtype=torch.float32,
                             device=device) / TILE_X
    cond_cdf = torch.where(row_tot > 1e-9,
                           cond_sum / torch.clamp(row_tot, min=1e-30),
                           uniform_x)
    cond_cdf[..., -1] = 1.0
    marg_sum = torch.cumsum(row_tot[..., 0], dim=-1)
    tot = marg_sum[..., -1:]
    uniform_y = torch.arange(1, TILE_Y + 1, dtype=torch.float32,
                             device=device) / TILE_Y
    marg_cdf = torch.where(tot > 1e-9, marg_sum / torch.clamp(tot, min=1e-30),
                           uniform_y)
    marg_cdf[..., -1] = 1.0
    count = hist_cnt.reshape(N_GRID, N_TILE).sum(dim=-1)
    return Guiding(cond_cdf.reshape(N_GRID * TILE_Y, TILE_X).contiguous(),
                   marg_cdf.contiguous(), count)


def _row_pdf(cdf_rows, row, col):
    """cdf_rows[row, col] - cdf_rows[row, col - 1] (0 before the first)."""
    ncols = cdf_rows.shape[-1]
    flat = cdf_rows.reshape(-1)
    base = row.long() * ncols
    col = col.long()
    prev = torch.where(col > 0, flat[base + torch.clamp(col - 1, min=0)],
                       0.0)
    return flat[base + col] - prev


def guiding_pdf(g: Guiding, cell, d: Vec3):
    """Solid-angle pdf of the guided distribution at direction d."""
    u, v = _tile_uv(d)
    tx = torch.clamp((u * TILE_X).to(torch.int32), 0, TILE_X - 1)
    ty = torch.clamp((v * TILE_Y).to(torch.int32), 0, TILE_Y - 1)
    p_y = _row_pdf(g.marg_cdf, cell, ty) * TILE_Y
    p_x = _row_pdf(g.cond_cdf, cell * TILE_Y + ty, tx) * TILE_X
    sin_t = torch.sin(v * torch.pi)
    return safe_div(p_y * p_x, sin_t * torch.pi * torch.pi * 2.0)


def _sample_row(cdf_rows, row, u):
    """Inverse-CDF sample within each lane's row: (column, continuous
    position, pdf), by a search of a fixed number of steps."""
    ncols = cdf_rows.shape[-1]
    flat = cdf_rows.reshape(-1)
    base = row.long() * ncols
    idx = torch.clamp(_count_less(flat, base, ncols, u), 0, ncols - 1)
    hi = flat[base + idx]
    lo = torch.where(idx > 0, flat[base + torch.clamp(idx - 1, min=0)], 0.0)
    p = torch.clamp(hi - lo, min=1e-12)
    frac = torch.clamp((u - lo) / p, 0.0, 1.0)
    return idx, (idx.to(torch.float32) + frac) / ncols, p * ncols


def guiding_sample(g: Guiding, cell, u0, u1):
    """A direction from the cell's CDFs and its solid-angle pdf."""
    ty, vy, py = _sample_row(g.marg_cdf, cell, u0)
    _, vx, px = _sample_row(g.cond_cdf, cell.long() * TILE_Y + ty, u1)
    theta = vy * torch.pi
    d = dir_from_spherical(theta, vx * 2.0 * torch.pi)
    return d, safe_div(py * px, torch.sin(theta) * torch.pi * torch.pi * 2.0)


class _SampState(NamedTuple):
    org: Vec3
    dir: Vec3
    tmin: torch.Tensor
    tmax: torch.Tensor
    rng: torch.Tensor
    contrib: Color
    inv_pdf: torch.Tensor
    eta: torch.Tensor
    alive: torch.Tensor
    result: Color
    depth: torch.Tensor
    sample: torch.Tensor


def sample_trace(scene: SceneData, settings: RenderSettings, x, y,
                 iteration: int, frame: int, guiding: Guiding,
                 tabs: RenderTables = None) -> Color:
    """The guided path tracing pass (make_adaptive_env_sampling_path
    _renderer), persistent lanes: per-lane radiance summed over
    settings.spi samples."""
    if tabs is None:
        tabs = render_tables(scene, settings)
    start, bounce, result = sample_fns(scene, settings, tabs, x, y,
                                       iteration, frame, guiding)
    return result(run_loop(start(), bounce,
                           settings.spi * settings.max_depth))


def sample_fns(scene: SceneData, settings: RenderSettings,
               tabs: RenderTables, x, y, iteration, frame, guiding: Guiding):
    """The guided pass's loop for the lanes x, y: (start() -> _SampState,
    bounce, result), reading `guiding` where it lives. The iteration and
    frame are ints or 0-d int64 tensors."""
    cam = scene.camera.eye

    def initial(rays, rng_state):
        like = rays.tmin
        return _SampState(**_fresh_state(
            rays, rng_state, inv_pdf=torch.zeros_like(like),
            result=black_like(like)))

    def start() -> _SampState:
        return start_state(scene, settings, x, y, iteration, frame, initial)

    def result(state: _SampState) -> Color:
        return state.result

    regen = (x, y, iteration, frame)

    def bounce(state: _SampState) -> _SampState:
        rays_b = Rays(state.org, state.dir, state.tmin,
                      torch.where(state.alive, state.tmax, -1.0))
        hit = trace_scene(scene, rays_b, tabs.packed, tabs.inst)
        found = hit.prim >= 0
        # a miss sees the env at full weight: no NEE in this technique
        # (adaptive_env_pathtracer.art:237), so no MIS discount
        miss = state.alive & ~found
        result = state.result
        for *_, emit in infinite_emissions(scene, tabs, state.dir):
            result = _cadd_where(miss, result, _handle_color(
                state.contrib.cmul(emit), settings))

        active = state.alive & found
        sh = shade_hit(scene, settings, tabs, rays_b, hit,
                       weight_texture=False)
        shader = sh.shader
        out_dir = -state.dir
        all_delta = shader.is_all_delta()
        # emission on a hit, at full weight for the same reason
        light_row = scene.entities.light[
            torch.clamp(sh.surf.ent, min=0).long()]
        li = torch.clamp(light_row, min=0).long()
        emit_ok = (active & (light_row >= 0) & sh.surf.is_entering
                   & (dot(state.dir, sh.frame.n) < -1e-6))
        result = _cadd_where(emit_ok, result, _handle_color(
            state.contrib.cmul(Color(*[c[li] for c in
                                       scene.lights.intensity])), settings))

        cell = _grid_cell(sh.surf.point, cam)
        ae_prob = torch.where(
            all_delta | (guiding.count[cell.long()] <= MIN_COUNT), 0.0,
            AE_PROB)
        rng, (u_sel, b_pick, b0, b1, b2, b_rr) = rnglib.next_f32_n(
            state.rng, 6)
        use_guide = u_sel < ae_prob
        # branch A: a guided direction
        gdir, gpdf = guiding_sample(guiding, cell, b0, b1)
        f_g = shader.eval(gdir, out_dir)
        p_bsdf_g = shader.pdf(gdir, out_dir)
        mix_g = (1.0 - ae_prob) * p_bsdf_g + ae_prob * gpdf
        w_g = Color(*[safe_div(c, mix_g) for c in f_g])
        # branch B: a BSDF sample, reweighted by the mixture pdf
        bs = shader.sample(out_dir, b_pick, b0, b1, b2)
        mix_b = (1.0 - ae_prob) * bs.pdf + ae_prob * guiding_pdf(
            guiding, cell, bs.in_dir)
        scale_b = torch.where(bs.is_delta, 1.0, safe_div(bs.pdf, mix_b))
        w_b = bs.weight * scale_b

        new_dir = vselect(use_guide, gdir, bs.in_dir)
        weight = cselect(use_guide, w_g, w_b)
        mix_pdf = torch.where(use_guide, mix_g, mix_b)
        valid = torch.where(use_guide, p_bsdf_g > 1e-9, bs.valid)
        new_eta = torch.where(use_guide, 1.0, bs.eta)
        is_delta = torch.where(use_guide, False, bs.is_delta)
        new_contrib, rr_prob = _rr(settings, state, weight)
        cont = (active & valid & (b_rr < rr_prob) & (mix_pdf > 1e-9)
                & (state.depth + 1 <= settings.max_depth))
        new_inv_pdf = torch.where(is_delta, 0.0,
                                  safe_div(1.0, rr_prob * mix_pdf))
        do_regen, new_sample, cam_r, fresh = regenerate(scene, settings,
                                                        regen, state, cont)
        return _SampState(
            org=vselect(do_regen, cam_r.org, sh.surf.point),
            dir=vselect(do_regen, cam_r.dir, new_dir),
            tmin=torch.where(do_regen, cam_r.tmin, OFFSET),
            tmax=torch.where(do_regen, cam_r.tmax, FLT_MAX),
            rng=torch.where(do_regen, fresh, rng),
            contrib=cselect(do_regen, white_like(state.tmin),
                            cselect(cont, new_contrib, state.contrib)),
            inv_pdf=torch.where(do_regen, 0.0,
                                torch.where(cont, new_inv_pdf,
                                            state.inv_pdf)),
            eta=torch.where(do_regen, 1.0,
                            torch.where(cont, state.eta * new_eta,
                                        state.eta)),
            alive=cont | do_regen, result=result,
            depth=torch.where(do_regen, 1, state.depth + 1),
            sample=new_sample)

    return start, bounce, result
