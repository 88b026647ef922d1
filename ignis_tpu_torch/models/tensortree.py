"""TensorTree measured BSDF evaluation (port of
ignis_tpu/models/tensortree.py, after the reference's bsdf/tensortree.art).

The variable-depth tensor tree is baked to dense grids at load time
(scene/tensortree.py); eval is a nearest-cell read of the grid over the
Shirley-Chiu parameter square (3-D isotropic, 4-D anisotropic), by plain
tensor indexing: the grids are constant tables that take no gradient.
Frame and sampling follow the Klems model (cosine hemisphere and a side
pick by the component totals), as the reference ships it
(tensortree.art:308). Peak extraction (`peakExtraction`) keeps the
shipped semantics; since the reference kernel's projected solid angle is
the constant pi (tensortree.art:125), the peak can fire only for depth-0
trees, which from_numpy decides at load.

The query convention is the JAX package's default (its IGNIS_TT_EXP
bitfield at 89, read from the environment there), coded directly in
`_eval_factor`: this module reads no environment variable, has no
multilinear filter and no other convention. Trees are laid out (out, in);
the quadrants with wo above the pinned front frame query with in and out
transposed and negated, with |cos wi| restored by the cosine fix; 4-D
front reflection keeps the straight mapping.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..core.vec import Color, Vec3, safe_div, vselect
from ..core.warp import cosine_hemisphere_pdf, sample_cosine_hemisphere

class TTComponentData(NamedTuple):
    grid: torch.Tensor          # res^ndim dense bake
    total: torch.Tensor         # 0-d
    min_proj_sa: torch.Tensor   # 0-d: pi / 4^maxDepth


class TensorTreeData(NamedTuple):
    front_reflection: TTComponentData
    back_reflection: TTComponentData
    front_transmission: TTComponentData
    back_transmission: TTComponentData
    # the peakExtraction property (default true); None where the peak can
    # never fire for this tree (decided in from_numpy), which skips the
    # 29-probe scan
    use_peak: torch.Tensor = None


def from_numpy(t, use_peak: bool = True, device="cpu") -> TensorTreeData:
    def comp(c):
        return TTComponentData(
            torch.from_numpy(np.ascontiguousarray(c.grid, np.float32)).to(
                device),
            torch.tensor(float(np.float32(c.total)), device=device),
            torch.tensor(float(np.float32(getattr(c, "min_proj_sa",
                                                  3.1416))), device=device))
    # the eval kernel's proj_sa is the constant pi, so a probe counts as
    # a peak only when pi <= 1.5 * min_proj_sa: depth-0 trees alone, on
    # the two transmission components _peak_by_side probes
    thresh = 2.0 * 3.14159265 / 3.0 - 1e-5
    can_fire = use_peak and (
        float(getattr(t.front_transmission, "min_proj_sa", 3.1416)) >= thresh
        or float(getattr(t.back_transmission, "min_proj_sa", 3.1416))
        >= thresh)
    return TensorTreeData(comp(t.front_reflection), comp(t.back_reflection),
                          comp(t.front_transmission),
                          comp(t.back_transmission),
                          torch.tensor(1.0, device=device) if can_fire
                          else None)


def _disk_to_square(x, y):
    """concentric_disk_to_square (warp.art:24) -> [0, 1]^2."""
    quadrant = torch.abs(x) > torch.abs(y)
    r_sign = torch.where(quadrant, x, y)
    r = torch.copysign(torch.sqrt(x * x + y * y), r_sign)
    phi = torch.atan2(y * torch.sign(r_sign), x * torch.sign(r_sign))
    c = 4.0 * phi / math.pi
    t = torch.where(quadrant, c, 2.0 - c) * r
    a = torch.where(quadrant, r, t)
    b = torch.where(quadrant, t, r)
    return (a + 1.0) * 0.5, (b + 1.0) * 0.5


def _positive(v: Vec3) -> Vec3:
    flip = torch.where(v.z >= 0, 1.0, -1.0)
    return Vec3(v.x * flip, v.y * flip, v.z * flip)


def _neg(v: Vec3) -> Vec3:
    return Vec3(-v.x, -v.y, -v.z)


def _eval_component(comp: TTComponentData, ndim: int, wi: Vec3, wo: Vec3,
                    swap_io: bool = False):
    """tt_eval_component: the grid cell at the mapped parameter point,
    times |cos wi|; `swap_io` reads the tree's axes as (out, in)."""
    ox, oy = _disk_to_square(wo.x, wo.y)
    if ndim == 3:
        in_t = (0.5 - 1e-6) - 0.5 * torch.sqrt(wi.x * wi.x + wi.y * wi.y)
        coords = (ox, oy, in_t) if swap_io else (in_t, ox, oy)
    else:
        ix, iy = _disk_to_square(-wi.x, -wi.y)
        coords = (ox, oy, ix, iy) if swap_io else (ix, iy, ox, oy)
    idx = []
    for ax, c in enumerate(coords):
        res = comp.grid.shape[ax]
        idx.append(torch.clamp((c * res).to(torch.int64), 0, res - 1))
    return comp.grid[tuple(idx)] * torch.abs(wi.z)


def _eval_factor(tt: TensorTreeData, wi: Vec3, wo: Vec3):
    """The quadrant dispatch (component choice of tensortree.art:242-247)
    under the JAX package's default convention (IGNIS_TT_EXP = 89: bits 1,
    8, 16 and 64)."""
    nd = tt.front_reflection.grid.dim()
    t_in, t_out = _positive(wi), _positive(wo)
    # bits 8 and 16: the back quadrants query with in and out transposed
    # and both negated (the tree's handedness)
    b_in, b_out = _neg(t_out), _neg(t_in)
    # bit 64: 4-D front reflection keeps the straight mapping
    straight_rr = nd == 4
    rr_in, rr_out = (t_in, t_out) if straight_rr else (b_in, b_out)
    # bit 1: every tree is laid out (out, in)
    f_rr = _eval_component(tt.front_reflection, nd, rr_in, rr_out, True)
    f_ft = _eval_component(tt.front_transmission, nd, t_in, t_out, True)
    f_bt = _eval_component(tt.back_transmission, nd, b_in, b_out, True)
    f_br = _eval_component(tt.back_reflection, nd, t_in, t_out, True)
    # the cosine fix: a transposed lookup applied |cos| of the other vector
    fix = torch.abs(wi.z) * safe_div(
        1.0, torch.clamp(torch.abs(wo.z), min=1e-6))
    if not straight_rr:
        f_rr = f_rr * fix
    f_bt = f_bt * fix
    in_front = wi.z > 0
    out_front = wo.z > 0
    ok = (torch.abs(wi.z) > 1e-6) & (torch.abs(wo.z) > 1e-6)
    f = torch.where(in_front, torch.where(out_front, f_rr, f_ft),
                    torch.where(out_front, f_bt, f_br))
    return torch.where(ok, f, 0.0)


# the peak scan's 29 probe offsets, in units of the search radius
# (reference tt_dir2check, tensortree.art:128)
_DIR2CHECK = (
    (0, 0), (-0.6, 0), (0, 0.6), (0, -0.6), (0.6, 0),
    (-0.6, 0.6), (-0.6, -0.6), (0.6, 0.6), (0.6, -0.6),
    (-1.2, 0), (0, 1.2), (0, -1.2), (1.2, 0),
    (-1.2, 1.2), (-1.2, -1.2), (1.2, 1.2), (1.2, -1.2),
    (-1.8, 0), (0, 1.8), (0, -1.8), (1.8, 0),
    (-1.8, 1.8), (-1.8, -1.8), (1.8, 1.8), (1.8, -1.8),
    (-2.4, 0), (0, 2.4), (0, -2.4), (2.4, 0),
)


def _check_peak_transmission(tt: TensorTreeData, comp: TTComponentData,
                             wo: Vec3):
    """tt_check_peak_transmission (tensortree.art:161) with the kernel's
    constant proj_sa = pi, as the JAX package mirrors it."""
    nd = tt.front_reflection.grid.dim()
    srchrad = torch.sqrt(comp.min_proj_sa)
    proj_sa = math.pi
    peak_lum = torch.zeros_like(wo.x)
    om_peak = torch.zeros_like(wo.x)
    om_surr = torch.zeros_like(wo.x)
    peak_count = torch.zeros_like(wo.x)
    for ox, oy in _DIR2CHECK:
        wi = Vec3(-wo.x + ox * srchrad, -wo.y + oy * srchrad, -wo.z)
        factor = _eval_component(comp, nd, wi, wo)
        surr = (proj_sa > 1.5 * comp.min_proj_sa) | \
            (peak_lum > 8.0 * factor * peak_count)
        om_surr = om_surr + torch.where(surr, proj_sa, 0.0)
        peak_lum = peak_lum + torch.where(surr, 0.0, factor)
        om_peak = om_peak + torch.where(surr, 0.0, proj_sa)
        peak_count = peak_count + torch.where(surr, 0.0, 1.0)
    return ~((om_surr < 0.2 * om_peak) | (peak_lum < 0.005))


def _refl_prob(tt: TensorTreeData, wo_z):
    fp = safe_div(tt.front_reflection.total,
                  tt.front_reflection.total + tt.back_transmission.total)
    bp = safe_div(tt.back_reflection.total,
                  tt.back_reflection.total + tt.front_transmission.total)
    return torch.where(wo_z > 0, fp, bp)


def tt_eval(tt: TensorTreeData, base_color: Color, kframe, in_dir: Vec3,
            out_dir: Vec3) -> Color:
    f = _eval_factor(tt, kframe.to_local(in_dir), kframe.to_local(out_dir))
    return Color(base_color.r * f, base_color.g * f, base_color.b * f)


def _peak_by_side(tt: TensorTreeData, wo: Vec3):
    """The peak check against the outgoing side's transmission component
    (wo front: back transmission; wo back: front transmission); no probe
    at all where from_numpy found the peak can never fire."""
    if tt.use_peak is None:
        return torch.zeros_like(wo.x, dtype=torch.bool)
    pk_b = _check_peak_transmission(tt, tt.back_transmission, wo)
    pk_f = _check_peak_transmission(tt, tt.front_transmission, wo)
    return torch.where(wo.z > 0, pk_b, pk_f)


def tt_pdf(tt: TensorTreeData, kframe, in_dir: Vec3, out_dir: Vec3):
    wi = kframe.to_local(in_dir)
    wo = kframe.to_local(out_dir)
    rp = _refl_prob(tt, wo.z)
    same = (wi.z * wo.z) > 0
    prob = torch.where(same, rp, 1.0 - rp)
    # a transmission peak is a delta event: pdf 0 (tensortree.art:299)
    prob = torch.where(~same & _peak_by_side(tt, wo), 0.0, prob)
    return prob * cosine_hemisphere_pdf(torch.abs(wi.z))


def tt_sample(tt: TensorTreeData, base_color: Color, kframe, out_dir: Vec3,
              u0, u1, u2):
    """(in_dir in world space, pdf, weight, valid, peak)."""
    wo = kframe.to_local(out_dir)
    cdir, cpdf = sample_cosine_hemisphere(u1, u2)
    rp = _refl_prob(tt, wo.z)
    pick_refl = (rp > 0) & (u0 < rp)
    same_side = Vec3(cdir.x, cdir.y, torch.where(wo.z >= 0, cdir.z, -cdir.z))
    # peak extraction: the transmission pick becomes the straight-through
    # delta direction -wo with pdf 1 - rp (tensortree.art:316-320)
    peak = _peak_by_side(tt, wo) & ~pick_refl
    wi = vselect(pick_refl, same_side, vselect(peak, _neg(wo),
                                               _neg(same_side)))
    prob = torch.where(pick_refl, rp, 1.0 - rp)
    pdf = torch.where(peak, 1.0 - rp, prob * cpdf)
    f = _eval_factor(tt, wi, wo)
    w = safe_div(f, pdf)
    weight = Color(base_color.r * w, base_color.g * w, base_color.b * w)
    return kframe.to_world(wi), pdf, weight, pdf > 1e-9, peak
