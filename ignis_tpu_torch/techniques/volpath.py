"""Volumetric path tracer (homogeneous media).

Port of ignis_tpu/techniques/volpath.py (after the reference's
technique/volpathtracer.art):
  - per-bounce distance sampling with the smallest channel's exponential;
    a medium event replaces the surface continuation;
  - surface emission and NEE always contribute, weighted by the segment's
    transmittance;
  - a medium event scatters by Henyey-Greenstein (weight 1) and flags
    inv_pdf = -1, so the next hit's emission counts in full;
  - crossing a transmissive surface switches the lane's medium to the
    entity's inner or outer medium.
The bounce shares the path technique's hit shading, light sampling,
regeneration and cascade (techniques/path.py); `render_lanes` runs it for
a volpath scene, compacting, checkpointed under `remat`.

Four differences from the JAX function, each a fault of the reference
(ROADMAP queue 3), each held to an analytic value or a second estimator
by tests/test_torch_volume.py:
  - a medium event weighs sigma_s Tr / pdf (sigma_s / sigma_t for a grey
    medium); the JAX bounce leaves sigma_s out;
  - the surface branch, taken with the chance P that the distance sample
    reaches the segment's end, weighs Tr / P; the JAX bounce weighs Tr,
    so light carried on past a surface in a scattering medium counts
    Tr * P;
  - NEE at a surface reached from a medium event keeps its MIS weight
    against the surface's own BSDF sampling, which the JAX bounce sets to
    1 there while the BSDF-sampled hit keeps its share;
  - in a scene with transparent shadows but no glassy row (passthrough
    media only), NEE keeps the shadow segment's medium transmittance,
    which the JAX bounce drops there (ADVICE volpath.py:166).
Glassy scenes (thin dielectric or Radiance rows) take the crossing walk
(path.shadow_transmittance) from the lane's current medium. The distance
sampling is held fixed under the sigmas' gradient (medium.sample_distance).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import rng as rnglib
from ..core.vec import (Color, Vec3, black_like, color_max_component,
                        cselect, dot, safe_div, vselect, white_like)
from ..models import medium as medlib
from ..models.bsdf import THIN_FLAG, BsdfKind
from ..ops.intersect import FLT_MAX, Rays
from ..scenedata import RenderSettings, SceneData
from .path import (OFFSET, RenderTables, _cadd_where, _handle_color, env_miss,
                   hit_emission, occluded_scene, regenerate, sample_nee,
                   shade_hit, shadow_rays_of, shadow_transmittance,
                   through_inv_pdf, trace_scene)


class VolPathState(NamedTuple):
    org: Vec3
    dir: Vec3
    tmin: torch.Tensor
    tmax: torch.Tensor
    rng: torch.Tensor
    contrib: Color
    inv_pdf: torch.Tensor   # < 0 flags a medium interaction
    eta: torch.Tensor
    medium: torch.Tensor    # int32 current medium id (-1 vacuum)
    med_sa: Color           # the current medium's sigma_a, sigma_s and g,
    med_ss: Color           # read where the lane entered it
    med_g: torch.Tensor
    alive: torch.Tensor
    result: Color
    depth: torch.Tensor     # per-lane path depth (camera segment = 1)
    sample: torch.Tensor    # per-lane sample counter (regeneration)


def vol_initial_state(rays: Rays, rng_state) -> VolPathState:
    like = rays.tmin
    return VolPathState(
        org=rays.org, dir=rays.dir, tmin=rays.tmin, tmax=rays.tmax,
        rng=rng_state, contrib=white_like(like),
        inv_pdf=torch.zeros_like(like), eta=torch.ones_like(like),
        medium=torch.full_like(like, -1, dtype=torch.int32),
        med_sa=black_like(like), med_ss=black_like(like),
        med_g=torch.zeros_like(like),
        alive=torch.ones_like(like, dtype=torch.bool),
        result=black_like(like),
        depth=torch.ones_like(like, dtype=torch.int32),
        sample=torch.zeros_like(like, dtype=torch.int32))


def is_glassy(settings: RenderSettings) -> bool:
    """Whether NEE takes the crossing walk: transparent shadows in a scene
    with a thin dielectric or a Radiance row. Passthrough-only scenes keep
    the current-medium transmittance and binary occlusion, as in the JAX
    package, whose walk cost them 2.7x there."""
    kinds = settings.bsdf_kinds
    return settings.transparent_shadows and (
        (THIN_FLAG + int(BsdfKind.DIELECTRIC)) in kinds
        or int(BsdfKind.RAD_BRTDF) in kinds
        or int(BsdfKind.RAD_ROOS) in kinds)


def make_vol_bounce(scene: SceneData, settings: RenderSettings,
                    tabs: RenderTables, regen=None):
    """Per-bounce volumetric wavefront step over the render's `tabs`; with
    `regen` = (x, y, iteration, frame) lanes whose path ended restart the
    next sample of their pixel (path.make_bounce's contract)."""
    n_lights = settings.n_lights
    glassy = is_glassy(settings)

    def bounce(state: VolPathState) -> VolPathState:
        rays_b = Rays(state.org, state.dir, state.tmin,
                      torch.where(state.alive, state.tmax, -1.0))
        hit = trace_scene(scene, rays_b, tabs.packed, tabs.inst)
        found = hit.prim >= 0
        med = medlib.params_from_state(state.med_sa, state.med_ss,
                                       state.med_g, state.medium)
        mis_inv_pdf = torch.clamp(state.inv_pdf, min=0.0)

        # ---- miss: infinite lights, seen only from vacuum ----------------
        inf_tr = (med.sigma_t.r + med.sigma_t.g + med.sigma_t.b) <= 1e-4
        result = env_miss(scene, settings, tabs, state, mis_inv_pdf,
                          state.alive & ~found & inf_tr, state.result)

        # ---- hit shading -------------------------------------------------
        active = state.alive & found
        sh = shade_hit(scene, settings, tabs, rays_b, hit)
        surf, frame, shader = sh.surf, sh.frame, sh.shader
        out_dir = -state.dir
        all_delta = shader.is_all_delta()
        seg_tr = medlib.transmittance(med, torch.where(found, hit.t, 0.0))
        emit_ok, intensity, mis_e = hit_emission(
            scene, settings, tabs, state, mis_inv_pdf, active, hit, sh)
        result = _cadd_where(emit_ok, result, _handle_color(
            state.contrib.cmul(intensity.cmul(seg_tr)) * mis_e, settings))

        rng = state.rng
        depth = state.depth

        # ---- NEE from the surface ----------------------------------------
        if settings.enable_nee and n_lights > 0:
            rng, nee = sample_nee(scene, settings, tabs, rng, sh, out_dir)
            mis = torch.where(nee.lp.delta, 1.0,
                              1.0 / (1.0 + safe_div(nee.bsdf_p, nee.pdf_l_s)))
            unshadowed = _handle_color(
                nee.ls.intensity.cmul(state.contrib.cmul(nee.bsdf_f))
                * (mis * nee.factor), settings)
            if glassy:
                # the walk attenuates the shadow segment itself
                contrib_nee = unshadowed.cmul(seg_tr)
            else:
                # the shadow segment under the current medium
                shadow_tr = medlib.transmittance(med, nee.ls.dist)
                contrib_nee = unshadowed.cmul(seg_tr.cmul(shadow_tr))
            want = (active & ~all_delta & (depth + 1 <= settings.max_depth)
                    & (nee.pdf_l_s > 1e-9) & (nee.ls.cos > 1e-6)
                    & (color_max_component(contrib_nee) > 0))
            shadow_rays = shadow_rays_of(nee, surf, want)
            if glassy:
                s_tint = shadow_transmittance(scene, settings, shadow_rays,
                                              tabs, init_medium=state.medium)
                result = _cadd_where(
                    want & (color_max_component(s_tint) > 0.0), result,
                    contrib_nee.cmul(s_tint))
            else:
                occ = occluded_scene(scene, shadow_rays, tabs.packed,
                                     tabs.inst)
                result = _cadd_where(want & ~occ, result, contrib_nee)

        # ---- continuation: a medium event or the surface bounce ----------
        rng, (um, up0, up1, b_pick, b0, b1, b2, b_rr) = \
            rnglib.next_f32_n(rng, 8)
        # medium sampling over real segments only: misses and dead lanes
        # carry t = FLT_MAX, and dist 0 gives no medium event
        ms = medlib.sample_distance(med, torch.where(found, hit.t, 0.0), um)
        phase_dir, _ = medlib.sample_hg(med.g, out_dir, up0, up1)
        med_contrib = state.contrib.cmul(ms.weight.cmul(med.sigma_s))
        med_org = state.org + state.dir * ms.t
        bs = shader.sample(out_dir, b_pick, b0, b1, b2)
        surf_contrib = state.contrib.cmul(seg_tr).cmul(bs.weight) * \
            ms.surface_scale

        take_med = active & ms.valid
        new_contrib = cselect(take_med, med_contrib, surf_contrib)
        rr_c = color_max_component(new_contrib) * state.eta * state.eta
        rr_prob = torch.clamp(rr_c, 0.05, 0.95)
        rr_prob = torch.where(depth + 1 > settings.min_depth, rr_prob, 1.0)
        survive = b_rr < rr_prob
        surf_ok = bs.valid & (bs.pdf > 1e-9)
        cont = (active & survive & (depth + 1 <= settings.max_depth)
                & (take_med | surf_ok))
        new_contrib = new_contrib * (1.0 / rr_prob)

        # the medium behind a transmission through the surface, read there
        # (a PExpr sigma at the entry surface's context)
        is_trans = dot(frame.n, bs.in_dir) < 0.0
        ent = torch.clamp(surf.ent, min=0).long()
        new_med = torch.where(
            is_trans, torch.where(surf.is_entering,
                                  scene.entities.med_inner[ent],
                                  scene.entities.med_outer[ent]),
            state.medium)
        new_sa, new_ss, new_g = medlib.eval_medium_at(
            tabs.med, new_med, settings.medium_exprs, sh.ctx)
        if not scene.media.g.requires_grad:
            # g turns the scattered direction: with no g leaf to
            # differentiate, the direction leaves the graph, and a sigma
            # gradient runs no closest-hit backward
            new_g = new_g.detach()

        new_inv_pdf = torch.where(take_med, -1.0,
                                  torch.where(bs.is_delta, 0.0,
                                              safe_div(1.0, bs.pdf)))
        if settings.transparent_shadows:
            new_inv_pdf = torch.where(
                take_med, new_inv_pdf,
                through_inv_pdf(bs, out_dir, state.inv_pdf, new_inv_pdf))
        cross = cont & ~take_med
        new_state = VolPathState(
            org=vselect(take_med, med_org, surf.point),
            dir=vselect(take_med, phase_dir, bs.in_dir),
            tmin=torch.where(take_med, 0.0, OFFSET),
            tmax=torch.full_like(state.tmin, FLT_MAX),
            rng=rng,
            contrib=cselect(cont, new_contrib, state.contrib),
            inv_pdf=torch.where(cont, new_inv_pdf, state.inv_pdf),
            eta=torch.where(cross, state.eta * bs.eta, state.eta),
            medium=torch.where(cross, new_med, state.medium),
            med_sa=cselect(cross, new_sa, state.med_sa),
            med_ss=cselect(cross, new_ss, state.med_ss),
            med_g=torch.where(cross, new_g, state.med_g),
            alive=cont, result=result, depth=state.depth + 1,
            sample=state.sample)
        if regen is None:
            return new_state

        do_regen, new_sample, cam, fresh2 = regenerate(scene, settings,
                                                       regen, state, cont)
        zero = black_like(state.tmin)
        return VolPathState(
            org=vselect(do_regen, cam.org, new_state.org),
            dir=vselect(do_regen, cam.dir, new_state.dir),
            tmin=torch.where(do_regen, cam.tmin, new_state.tmin),
            tmax=torch.where(do_regen, cam.tmax, new_state.tmax),
            rng=torch.where(do_regen, fresh2, new_state.rng),
            contrib=cselect(do_regen, white_like(state.tmin),
                            new_state.contrib),
            inv_pdf=torch.where(do_regen, 0.0, new_state.inv_pdf),
            eta=torch.where(do_regen, 1.0, new_state.eta),
            medium=torch.where(do_regen, -1, new_state.medium),
            med_sa=cselect(do_regen, zero, new_state.med_sa),
            med_ss=cselect(do_regen, zero, new_state.med_ss),
            med_g=torch.where(do_regen, 0.0, new_state.med_g),
            alive=cont | do_regen, result=result,
            depth=torch.where(do_regen, 1, new_state.depth),
            sample=new_sample)

    return bounce
