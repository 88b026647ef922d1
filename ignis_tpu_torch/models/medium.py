"""Participating media: homogeneous transmittance, distance sampling, phase.

Port of ignis_tpu/models/medium.py (itself after the reference's
medium/homogeneous.art and phase/henyeygreenstein.art): distance sampling
by the exponential of the smallest channel's extinction. Medium id -1 is
vacuum. `sample_distance` also returns the chance that the sample reaches
the segment's end, which the volpath bounce divides out of its surface
branch (the JAX package keeps the bare transmittance there), and it holds
the sampling fixed under the sigmas' gradient.

The media's constants are stacked once per render into one [n, 8] table
(`medium_table`: sigma_a, sigma_s, g and a zero column), and a lane's
medium is one K3 row gather of it (ops/gather.py), whose backward is K3's
scatter-add: a sigma gradient meets no per-column indexing backward.
PExpr-valued sigmas (settings.medium_exprs) override the table where a
lane enters such a medium (`eval_medium_at`).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.frame import make_frame
from ..core.vec import Color, Vec3, safe_div
from ..core.warp import INV_4PI, TWO_PI
from ..ops import gather as gatherlib
from ..scenedata import Media

MED_COLS = 7   # sigma_a (rgb), sigma_s (rgb), g


class MediumParams(NamedTuple):
    sigma_a: Color
    sigma_s: Color
    sigma_t: Color
    g: torch.Tensor
    vacuum: torch.Tensor      # bool
    scattering: torch.Tensor  # bool: any sigma_s


def medium_table(media: Media) -> torch.Tensor:
    """The [n, 8] f32 table of the media's sigma_a, sigma_s and g
    (gatherlib.stack_cols); a leaf that requires grad gets its gradient
    through K3's scatter into this table."""
    return gatherlib.stack_cols([*media.sigma_a, *media.sigma_s, media.g])


def _masked(vac, c: Color) -> Color:
    return Color(*[torch.where(vac, 0.0, x) for x in c])


def _params(sa: Color, ss: Color, g, vac) -> MediumParams:
    sa, ss = _masked(vac, sa), _masked(vac, ss)
    scat = (ss.r + ss.g + ss.b) > 1e-4
    return MediumParams(sa, ss, sa + ss, g, vac, scat)


def gather_medium(tab: torch.Tensor, idx: torch.Tensor) -> MediumParams:
    """The medium of each lane's id ([N] int32, -1 = vacuum) from
    medium_table `tab`: one K3 gather."""
    safe = torch.clamp(idx, 0, tab.shape[0] - 1).to(torch.int32)
    sar, sag, sab, ssr, ssg, ssb, g = gatherlib.gather_block(
        safe, tab, MED_COLS).unbind(0)
    return _params(Color(sar, sag, sab), Color(ssr, ssg, ssb), g, idx < 0)


def params_from_state(sa: Color, ss: Color, g, medium_id) -> MediumParams:
    """Per-lane medium parameters carried in the path state (the sigmas
    read where the lane entered the medium)."""
    return _params(sa, ss, g, medium_id < 0)


def eval_medium_at(tab: torch.Tensor, medium_id, medium_exprs=(),
                   sctx=None):
    """(sigma_a, sigma_s, g) of each lane's medium: the constant table's,
    with the PExpr closures of `medium_exprs` (settings.medium_exprs: per
    medium None or (fn_a, fn_s)) evaluated at the surface context `sctx`
    on the lanes in such a medium (ignis_tpu/models/medium.py:60-78)."""
    m = gather_medium(tab, medium_id)
    sa, ss = m.sigma_a, m.sigma_s
    for mi, entry in enumerate(medium_exprs or ()):
        if entry is None:
            continue
        fn_a, fn_s = entry
        sel = medium_id == mi
        if fn_a is not None:
            sa = Color(*[torch.where(sel, c, d)
                         for c, d in zip(fn_a(sctx), sa)])
        if fn_s is not None:
            ss = Color(*[torch.where(sel, c, d)
                         for c, d in zip(fn_s(sctx), ss)])
    return sa, ss, m.g


# Distances reaching transmittance can be FLT_MAX (infinite lights, miss
# lanes). exp(-sigma*d) saturates long before d = 1e8, but the derivative
# d/dsigma = -d * exp(-sigma*d) carries the raw distance: capped, so that
# the sigma cotangents stay finite.
_TR_DIST_CAP = 1e8


def transmittance(med: MediumParams, dist) -> Color:
    d = torch.clamp(dist, max=_TR_DIST_CAP)
    return Color(*[torch.exp(-st * d) for st in med.sigma_t])


def sigma_t_pivot(med: MediumParams):
    """The smallest channel's extinction, which distance sampling uses."""
    st = med.sigma_t
    return torch.minimum(st.r, torch.minimum(st.g, st.b))


def tr_at_pivot(med: MediumParams, dist):
    return torch.exp(-sigma_t_pivot(med) * torch.clamp(dist,
                                                       max=_TR_DIST_CAP))


class MediumSample(NamedTuple):
    valid: torch.Tensor
    t: torch.Tensor
    weight: Color                # Tr / pdf of a medium event at t
    surface_scale: torch.Tensor  # 1 / P(the sample reaches the end)


def sample_distance(med: MediumParams, dist, u) -> MediumSample:
    """Distance sampling along a segment of length `dist`
    (homogeneous.art sample); invalid where the sample reaches the
    segment's end, in vacuum or where the medium does not scatter.

    The sampling is detached from the sigmas: the distance, its pdf and
    the chance of reaching the end are constants of reverse mode, and the
    sigmas' gradient flows through the transmittances that the weights
    divide by them. Each branch's weight is then f / p with p held fixed,
    whose gradient is the derivative of the branch's expected value; a
    sampled distance that moved with sigma would miss the lanes that cross
    the segment's end as sigma moves."""
    eps = 1e-3
    stp = torch.clamp(sigma_t_pivot(med), min=1e-8).detach()
    ndist = torch.minimum(dist, -torch.log(1.0 - u * 0.99999) / stp)
    reach_surface = torch.abs(dist - ndist) <= eps
    tr = transmittance(med, ndist)
    pdf = (torch.exp(-stp * torch.clamp(ndist, max=_TR_DIST_CAP)) * stp
           ).detach()
    w = Color(*[safe_div(c, pdf) for c in tr])
    events = med.scattering & (~med.vacuum)
    valid = (~reach_surface) & events
    # reach_surface <=> -log(1 - 0.99999 u) / stp >= dist - eps
    x = torch.clamp(dist.detach() - eps, min=0.0)
    p_end = torch.clamp(1.0 - (1.0 - torch.exp(-stp * x)) / 0.99999, 0.0, 1.0)
    scale = torch.where(p_end > 0.0, 1.0 / torch.clamp(p_end, min=1e-30), 0.0)
    return MediumSample(valid, ndist, w, torch.where(events, scale, 1.0))


# -- Henyey-Greenstein phase -------------------------------------------------

def hg_pdf(g, cos_theta):
    d = 1.0 + g * g - 2.0 * g * cos_theta
    return INV_4PI * safe_div(1.0 - g * g,
                              d * torch.sqrt(torch.clamp(d, min=1e-12)))


def sample_hg(g, out_dir: Vec3, u0, u1):
    """An incoming direction and its pdf (the weight is 1: pdf == phase).
    The cosine is taken against -out_dir (forward scattering), as in
    phase.art."""
    small = torch.abs(g) < 1e-3
    cos_uniform = 1.0 - 2.0 * u0
    sq = safe_div(1.0 - g * g, 1.0 + g - 2.0 * g * u0)
    cos_hg = safe_div(1.0 + g * g - sq * sq, 2.0 * g)
    cos_theta = torch.where(small, cos_uniform, torch.clamp(cos_hg, -1.0, 1.0))
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta * cos_theta, min=0.0))
    phi = TWO_PI * u1
    frame = make_frame(-out_dir)
    d = frame.to_world(Vec3(sin_theta * torch.cos(phi),
                            sin_theta * torch.sin(phi), cos_theta))
    pdf = torch.where(small, torch.full_like(g, INV_4PI), hg_pdf(g, cos_theta))
    return d, pdf
