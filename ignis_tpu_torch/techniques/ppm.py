"""Progressive photon mapping (PPM).

Port of ignis_tpu/techniques/ppm.py (photonmapper.art,
PhotonMappingTechnique.cpp):

- Light pass (`trace_photons`): one lane a photon, emitted by
  `sample_emission`, bounced through delta chains only; each lane deposits
  at most one photon, at its first non-delta, non-emissive surface that
  faces it. The photons go into one [P, 12] f32 table (PHOTON_COLS).
- Grid (`build_photon_grid`): photons sorted by linear cell id with a
  stable sort (which photons of a crowded cell survive the ppm_cell_cap
  truncation depends on the order within the cell, as with jnp.argsort),
  the sorted table one K3 gather of the rows, cell ranges by searchsorted.
- Camera pass (`ppm_trace_progressive`): persistent-lane path tracing; at
  every non-delta vertex a density estimate over the 2^3 cells around the
  query ball, ppm_cell_cap photon slots a cell: each cell's [n, K] photons
  are one K3 gather of the table, and the lane shader is evaluated once
  over the n*K (lane, photon) pairs (`LaneShader.map_lanes`), the lanes in
  chunks of GATHER_PAIRS // K so the [n*K] temporaries stay small.
- The radius schedule r_i = r0 prod_{k<i} (k+1.8)/(k+2) in closed form
  through lgamma.

Both loops read `any(alive)` on the host once a bounce.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import rng as rnglib
from ..core.vec import (Color, Vec3, black_like, color_max_component,
                        cselect, dot, safe_div, vselect, white_like)
from ..ops import gather as gatherlib
from ..ops.intersect import FLT_MAX, Rays
from ..scenedata import RenderSettings, SceneData
from .lighttracer import _emit
from .path import (OFFSET, RenderTables, _cadd_where, _handle_color,
                   infinite_emissions, regenerate, render_tables, shade_hit,
                   start_state, trace_scene)

TAN_1_DEG = 0.017455064   # photonmapper.art:271 (primary-footprint radius)
CONTRACT = 0.8            # radius contraction ratio (photonmapper.art:244)
# the photon table's columns: position, direction towards the light,
# radiance (xyz / rgb each), depth, valid, one zero
PHOTON_COLS = 11
GATHER_PAIRS = 1 << 22    # (lane, photon) pairs a chunk of the gather


class PhotonMap(NamedTuple):
    pos: Vec3            # [P] deposit position
    in_dir: Vec3         # [P] direction the photon arrived from
    radiance: Color      # [P] carried power (already / pdf at emission)
    depth: torch.Tensor  # [P] i32 path depth at the deposit
    valid: torch.Tensor  # [P] bool


class PhotonGrid(NamedTuple):
    table: torch.Tensor     # [P, 12] photons sorted by cell id
    offsets: torch.Tensor   # [G^3 + 1] cell -> first sorted photon
    gmin: Vec3              # grid origin (0-d tensors)
    inv_cell: torch.Tensor
    cell_size: torch.Tensor


def photon_table(pm: PhotonMap) -> torch.Tensor:
    return gatherlib.stack_cols([*pm.pos, *pm.in_dir, *pm.radiance,
                                 pm.depth, pm.valid])


class _PhotonState(NamedTuple):
    org: Vec3
    dir: Vec3
    tmin: torch.Tensor
    rng: torch.Tensor
    contrib: Color
    depth: torch.Tensor
    alive: torch.Tensor
    pmap: PhotonMap


def trace_photons(scene: SceneData, settings: RenderSettings, iteration: int,
                  frame: int, tabs: RenderTables) -> PhotonMap:
    """settings.photon_count photons (make_ppm_light_renderer); each lane
    deposits at most one, at its first non-delta surface."""
    P = settings.photon_count
    device = scene.device
    x = torch.arange(P, dtype=torch.int32, device=device)
    y = torch.zeros_like(x)
    rng0, pos0, dir0, tmin0, rad0 = _emit(scene, settings, tabs, x, y, y,
                                          iteration, frame)
    z = torch.zeros(P, device=device)
    st = _PhotonState(
        org=pos0, dir=dir0, tmin=tmin0, rng=rng0, contrib=rad0,
        depth=torch.ones(P, dtype=torch.int32, device=device),
        alive=torch.ones(P, dtype=torch.bool, device=device),
        pmap=PhotonMap(Vec3(z, z, z), Vec3(z, z, torch.ones_like(z)),
                       Color(z, z, z), torch.zeros_like(x),
                       torch.zeros(P, dtype=torch.bool, device=device)))

    def bounce(state: _PhotonState) -> _PhotonState:
        rays = Rays(state.org, state.dir, state.tmin,
                    torch.where(state.alive, FLT_MAX, -1.0))
        hit = trace_scene(scene, rays, tabs.packed, tabs.inst)
        active = state.alive & (hit.prim >= 0)
        sh = shade_hit(scene, settings, tabs, rays, hit, weight_texture=False)
        surf, shader = sh.surf, sh.shader
        out_dir = -state.dir
        all_delta = shader.is_all_delta()
        emissive = scene.entities.light[torch.clamp(surf.ent, min=0).long()] \
            >= 0
        cos_o = dot(out_dir, sh.frame.n)
        # deposit on the first non-delta, non-emissive surface facing the
        # photon (photonmapper.art:178)
        deposit = active & ~emissive & ~all_delta & (cos_o > 1e-6)
        pm = state.pmap
        pm = PhotonMap(vselect(deposit, surf.point, pm.pos),
                       vselect(deposit, out_dir, pm.in_dir),
                       cselect(deposit, state.contrib, pm.radiance),
                       torch.where(deposit, state.depth, pm.depth),
                       pm.valid | deposit)
        # bounce through delta chains only (photonmapper.art:206), adjoint
        rng, (b_pick, b0, b1, b2) = rnglib.next_f32_n(state.rng, 4)
        bs = shader.sample(out_dir, b_pick, b0, b1, b2, adjoint=True)
        new_contrib = state.contrib.cmul(bs.weight)
        avg = (new_contrib.r + new_contrib.g + new_contrib.b) * (1.0 / 3.0)
        cont = (active & ~deposit & all_delta & bs.valid & (avg > 1e-6)
                & (state.depth + 2 <= settings.max_light_depth))
        return _PhotonState(
            org=surf.point, dir=bs.in_dir,
            tmin=torch.full_like(state.tmin, OFFSET), rng=rng,
            contrib=cselect(cont, new_contrib, state.contrib),
            depth=state.depth + 1, alive=cont, pmap=pm)

    it = 0
    while it < settings.max_light_depth and bool(st.alive.any()):
        st = bounce(st)
        it += 1
    return st.pmap


def build_photon_grid(photons: PhotonMap, scene: SceneData,
                      settings: RenderSettings) -> PhotonGrid:
    """Photons sorted by their cell of a G^3 grid over the scene's bounding
    cube (invalid ones last), and each cell's first index."""
    G = settings.ppm_grid
    radius = scene.scene_radius
    gmin = Vec3(*[c - radius for c in scene.scene_center])
    cell = torch.clamp(2.0 * radius / G, min=1e-6)
    inv_cell = 1.0 / cell

    def axis_idx(p, lo):
        return torch.clamp(((p - lo) * inv_cell).to(torch.int32), 0, G - 1)

    cid = (axis_idx(photons.pos.x, gmin.x)
           + G * (axis_idx(photons.pos.y, gmin.y)
                  + G * axis_idx(photons.pos.z, gmin.z)))
    cid = torch.where(photons.valid, cid, G * G * G)
    cid_sorted, order = torch.sort(cid, stable=True)
    table = gatherlib.gather_block(order.to(torch.int32),
                                   photon_table(photons)).t().contiguous()
    offsets = torch.searchsorted(
        cid_sorted, torch.arange(G * G * G + 1, dtype=cid_sorted.dtype,
                                 device=cid.device)).to(torch.int32)
    return PhotonGrid(table, offsets, gmin, inv_cell, cell)


def compute_radius(settings: RenderSettings, scene: SceneData,
                   iteration: int) -> torch.Tensor:
    """ppm_compute_radius in closed form: prod_{i<n} (i+1+c)/(i+2) =
    Gamma(n+1+c) / (Gamma(1+c) Gamma(n+2))."""
    r0 = settings.merge_radius * 2.0 * scene.scene_radius
    nf = torch.tensor(float(iteration), dtype=torch.float32,
                      device=r0.device)
    shrink = torch.exp(torch.lgamma(nf + 1.0 + CONTRACT)
                       - torch.lgamma(torch.full_like(nf, 1.0 + CONTRACT))
                       - torch.lgamma(nf + 2.0))
    return torch.clamp(r0 * shrink, min=1e-5)


def _ppm_kernel(r2, d2):
    """Simpson kernel (photonmapper.art:43)."""
    ir2 = safe_div(1.0, r2)
    term = 1.0 - d2 * ir2
    return term * term * 3.0 * ir2 * (1.0 / torch.pi)


def gather_photons(grid: PhotonGrid, settings: RenderSettings, point: Vec3,
                   radius, shader, out_dir: Vec3, normal: Vec3, cos_o,
                   cam_depth) -> Color:
    """The kernel-weighted photon power within `radius` of each lane's
    `point` (radius clamped to one cell, so the 2x2x2 cells from the cell
    of point - radius cover the ball; at most ppm_cell_cap photons a cell,
    a crowded cell's kept share rescaled to its count)."""
    G, K = settings.ppm_grid, settings.ppm_cell_cap
    n = cos_o.shape[0]
    P = grid.table.shape[0]
    radius = torch.minimum(radius, grid.cell_size)
    r2 = radius * radius
    lo = [torch.floor((p - radius - g) * grid.inv_cell).to(torch.int32)
          for p, g in zip(point, grid.gmin)]
    slot = torch.arange(K, dtype=torch.int32, device=cos_o.device)
    step = max(1, GATHER_PAIRS // K)
    out = []
    for a in range(0, n, step):
        b = min(n, a + step)

        def rep(t, a=a, b=b):
            return t[a:b].repeat_interleave(K)

        sh_k = shader.map_lanes(rep)
        out_k = Vec3(*[rep(c) for c in out_dir])
        pt = [c[a:b, None] for c in point]
        nrm = [c[a:b, None] for c in normal]
        r2_c = r2[a:b, None]
        acc = [torch.zeros(b - a, device=cos_o.device) for _ in range(3)]
        for dz in (0, 1):
            for dy in (0, 1):
                for dx in (0, 1):
                    cx, cy, cz = lo[0][a:b] + dx, lo[1][a:b] + dy, \
                        lo[2][a:b] + dz
                    in_grid = ((cx >= 0) & (cx < G) & (cy >= 0) & (cy < G)
                               & (cz >= 0) & (cz < G))
                    cid = torch.where(in_grid, cx + G * (cy + G * cz),
                                      0).long()
                    start = grid.offsets[cid]
                    end = torch.where(in_grid, grid.offsets[cid + 1], start)
                    idx = start[:, None] + slot[None, :]
                    m = idx < end[:, None]
                    cols = gatherlib.gather_block(
                        torch.clamp(idx, 0, P - 1).reshape(-1), grid.table,
                        PHOTON_COLS).reshape(PHOTON_COLS, b - a, K)
                    px, py, pz, dxp, dyp, dzp, rr, rg, rb, pdep, pval = cols
                    ex, ey, ez = pt[0] - px, pt[1] - py, pt[2] - pz
                    d2 = ex * ex + ey * ey + ez * ez
                    cos_i = dxp * nrm[0] + dyp * nrm[1] + dzp * nrm[2]
                    ok = (m & (pval > 0.5) & (d2 <= r2_c)
                          & (cam_depth[a:b, None] + pdep.to(torch.int32)
                             <= settings.max_depth)
                          & ((cos_o[a:b, None] * cos_i) > 1e-6))
                    kern = _ppm_kernel(r2_c, d2)
                    # eval holds |cos_i|; the light side already projected
                    # it, so it is divided back out (photonmapper.art:312)
                    f = sh_k.eval(Vec3(dxp.reshape(-1), dyp.reshape(-1),
                                       dzp.reshape(-1)), out_k)
                    w = torch.where(ok, safe_div(kern, torch.abs(cos_i)), 0.0)
                    # a cell of more than K photons gives a K-subsample:
                    # rescale by the kept share
                    cnt = (end - start).to(torch.float32)
                    scale = safe_div(cnt, torch.clamp(cnt, max=float(K)))
                    w = w * torch.clamp(scale, min=1.0)[:, None]
                    for c, (pr, fc) in enumerate(zip((rr, rg, rb), f)):
                        acc[c] = acc[c] + torch.sum(
                            pr * fc.reshape(b - a, K) * w, dim=1)
        out.append(acc)
    inv = 1.0 / settings.photon_count
    return Color(*[torch.cat([o[c] for o in out]) * inv for c in range(3)])


class _CamState(NamedTuple):
    org: Vec3
    dir: Vec3
    tmin: torch.Tensor
    tmax: torch.Tensor
    rng: torch.Tensor
    contrib: Color
    eta: torch.Tensor
    radius: torch.Tensor     # the inherited primary-footprint radius
    path_type: torch.Tensor  # 0: delta bounces only so far, 1: a diffuse one
    alive: torch.Tensor
    result: Color
    depth: torch.Tensor
    sample: torch.Tensor


def _cam_initial(rays: Rays, rng_state) -> _CamState:
    like = rays.tmin
    return _CamState(
        org=rays.org, dir=rays.dir, tmin=rays.tmin, tmax=rays.tmax,
        rng=rng_state, contrib=white_like(like), eta=torch.ones_like(like),
        radius=torch.full_like(like, FLT_MAX),
        path_type=torch.zeros_like(like, dtype=torch.int32),
        alive=torch.ones_like(like, dtype=torch.bool),
        result=black_like(like),
        depth=torch.ones_like(like, dtype=torch.int32),
        sample=torch.zeros_like(like, dtype=torch.int32))


def ppm_trace_progressive(scene: SceneData, settings: RenderSettings, x, y,
                          iteration: int, frame: int, grid: PhotonGrid,
                          radius_it, tabs: RenderTables) -> Color:
    """The camera pass (make_ppm_path_renderer) with persistent-lane
    regeneration: per-lane radiance summed over settings.spi samples."""
    st = start_state(scene, settings, x, y, iteration, frame, _cam_initial)
    regen = (x, y, iteration, frame)

    def bounce(state: _CamState) -> _CamState:
        rays_b = Rays(state.org, state.dir, state.tmin,
                      torch.where(state.alive, state.tmax, -1.0))
        hit = trace_scene(scene, rays_b, tabs.packed, tabs.inst)
        found = hit.prim >= 0
        result = state.result
        # a miss: infinite lights, LS*E paths only (photonmapper.art:328)
        miss = state.alive & ~found & (state.path_type == 0)
        for *_, emit in infinite_emissions(scene, tabs, state.dir):
            result = _cadd_where(miss, result, _handle_color(
                state.contrib.cmul(emit), settings))

        active = state.alive & found
        sh = shade_hit(scene, settings, tabs, rays_b, hit)
        surf, shader = sh.surf, sh.shader
        out_dir = -state.dir
        all_delta = shader.is_all_delta()
        light_row = scene.entities.light[torch.clamp(surf.ent, min=0).long()]
        emissive = light_row >= 0
        cos_o = dot(out_dir, sh.frame.n)
        # a light hit: LS*E paths only (photonmapper.art:283)
        intensity = scene.lights.intensity
        li = torch.clamp(light_row, min=0).long()
        emit_ok = (active & emissive & surf.is_entering
                   & (state.path_type == 0) & (cos_o > 1e-6))
        result = _cadd_where(emit_ok, result, _handle_color(
            state.contrib.cmul(Color(*[c[li] for c in intensity])),
            settings))

        # the density estimate (photonmapper.art:296)
        prim_r = torch.minimum(radius_it, hit.t * TAN_1_DEG)
        actual_r = torch.where(state.depth > 1, state.radius, prim_r)
        gather_ok = (active & ~emissive & ~all_delta
                     & (state.depth + 1 <= settings.max_depth)
                     & (torch.abs(cos_o) > 1e-6))
        g = gather_photons(grid, settings, surf.point, actual_r, shader,
                           out_dir, sh.frame.n, cos_o, state.depth)
        result = _cadd_where(gather_ok, result,
                             _handle_color(state.contrib.cmul(g), settings))

        # the bounce (photonmapper.art:358)
        rng, (b_pick, b0, b1, b2, b_rr) = rnglib.next_f32_n(state.rng, 5)
        bs = shader.sample(out_dir, b_pick, b0, b1, b2)
        new_contrib = state.contrib.cmul(bs.weight)
        rr_c = color_max_component(new_contrib) * state.eta * state.eta
        rr_prob = torch.clamp(rr_c, 0.05, 0.95)
        rr_prob = torch.where(state.depth + 1 > settings.min_depth, rr_prob,
                              1.0)
        cont = (active & bs.valid & (b_rr < rr_prob) & (bs.pdf > 1e-9)
                & (state.depth + 1 <= settings.max_depth))
        new_contrib = new_contrib * (1.0 / rr_prob)

        do_regen, new_sample, cam, fresh = regenerate(scene, settings, regen,
                                                      state, cont)
        return _CamState(
            org=vselect(do_regen, cam.org, surf.point),
            dir=vselect(do_regen, cam.dir, bs.in_dir),
            tmin=torch.where(do_regen, cam.tmin, OFFSET),
            tmax=torch.where(do_regen, cam.tmax, FLT_MAX),
            rng=torch.where(do_regen, fresh, rng),
            contrib=cselect(do_regen, white_like(state.tmin),
                            cselect(cont, new_contrib, state.contrib)),
            eta=torch.where(do_regen, 1.0,
                            torch.where(cont, state.eta * bs.eta, state.eta)),
            radius=torch.where(do_regen, FLT_MAX,
                               torch.where(cont, actual_r, state.radius)),
            path_type=torch.where(
                do_regen, 0, torch.where(cont & ~bs.is_delta, 1,
                                         state.path_type)),
            alive=cont | do_regen, result=result,
            depth=torch.where(do_regen, 1, state.depth + 1),
            sample=new_sample)

    it = 0
    while it < settings.spi * settings.max_depth and bool(st.alive.any()):
        st = bounce(st)
        it += 1
    return st.result


def ppm_render(scene: SceneData, settings: RenderSettings, x, y,
               iteration: int, frame: int,
               tabs: RenderTables = None) -> Color:
    """One PPM iteration: the photon pass, the grid, the camera pass."""
    if tabs is None:
        tabs = render_tables(scene, settings)
    photons = trace_photons(scene, settings, iteration, frame, tabs)
    grid = build_photon_grid(photons, scene, settings)
    radius_it = compute_radius(settings, scene, iteration)
    return ppm_trace_progressive(scene, settings, x, y, iteration, frame,
                                 grid, radius_it, tabs)
