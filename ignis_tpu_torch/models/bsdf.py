"""BSDF evaluation / sampling / pdf with masked kind dispatch.

Port of the slice's part of ignis_tpu/models/bsdf.py: DIFFUSE (Lambert and
Oren-Nayar) and smooth, non-thin DIELECTRIC, with the same static pruning
by `settings.bsdf_kinds`. Every kind, or rough or thin variant, outside
that set raises NotImplementedError naming its ROADMAP item; the blend
wrapper is not on the slice either, so a LaneShader holds one material.

Semantics (reference bsdf/*.art): eval includes the cosine term and delta
lobes eval to 0; sample returns weight = eval/pdf, the eta ratio and a
delta flag.
"""
from __future__ import annotations

from enum import IntEnum
from typing import NamedTuple

import torch

from ..core import fresnel as fr
from ..core.frame import Frame
from ..core.vec import Color, Vec3, cselect, dot, safe_div, vselect
from ..core.warp import INV_PI, cosine_hemisphere_pdf, sample_cosine_hemisphere

EPS = 1e-6
DELTA_ALPHA = 1e-4
ROUGH_FLAG = 100
THIN_FLAG = 200


class BsdfKind(IntEnum):
    DIFFUSE = 0
    DIELECTRIC = 1
    CONDUCTOR = 2
    PASSTHROUGH = 3
    PHONG = 4
    PLASTIC = 5
    PRINCIPLED = 6
    NULL_ERROR = 7
    BLEND = 8
    RAD_BRTDF = 9
    RAD_ROOS = 10
    KLEMS = 11
    TENSORTREE = 12
    DJMEASURED = 13


SLICE_KINDS = (int(BsdfKind.DIFFUSE), int(BsdfKind.DIELECTRIC))


def check_kinds(present) -> None:
    """Raise for any BSDF kind (or rough/thin variant) off the slice."""
    if present is None:
        raise NotImplementedError("settings.bsdf_kinds must be set")
    for k in present:
        if int(k) not in SLICE_KINDS:
            raise NotImplementedError(
                f"BSDF kind {int(k)} is not ported yet (ROADMAP queue 1, "
                "item 6: remaining BSDF kinds, rough and thin variants)")


class MatParams(NamedTuple):
    kind: torch.Tensor
    base: Color
    extra: Color
    extra2: Color
    p0: torch.Tensor
    p1: torch.Tensor
    p2: torch.Tensor
    p3: torch.Tensor


class BsdfSample(NamedTuple):
    in_dir: Vec3
    pdf: torch.Tensor
    weight: Color
    eta: torch.Tensor
    is_delta: torch.Tensor
    valid: torch.Tensor


def _eta_ratio(mat: MatParams, is_entering):
    """n1/n2 along the propagation direction."""
    return torch.where(is_entering, mat.p0 / torch.clamp(mat.p1, min=1e-6),
                       mat.p1 / torch.clamp(mat.p0, min=1e-6))


def _oren_nayar_eval(kd: Color, alpha, wi: Vec3, wo: Vec3):
    a2 = alpha * alpha
    p1 = torch.clamp(wi.z, min=0.0)
    p2 = torch.clamp(wo.z, min=0.0)
    s = -p1 * p2 + torch.clamp(dot(wo, wi), min=0.0)
    t = torch.where(s <= EPS, 1.0,
                    torch.clamp(torch.maximum(p1, p2), min=EPS))
    A = 1.0 - 0.5 * a2 / (a2 + 0.33)
    B = 0.45 * a2 / (a2 + 0.09)
    C = 0.17 * a2 / (a2 + 0.13)
    fac = (A + B * s / t) * INV_PI
    return Color(kd.r * fac + kd.r * kd.r * C * INV_PI,
                 kd.g * fac + kd.g * kd.g * C * INV_PI,
                 kd.b * fac + kd.b * kd.b * C * INV_PI) * p1


def _diffuse_eval(mat: MatParams, wi: Vec3, wo: Vec3) -> Color:
    cos_i = torch.clamp(wi.z, min=0.0)
    lam = mat.base * (cos_i * INV_PI)
    on = _oren_nayar_eval(mat.base, mat.p1, wi, wo)
    return cselect(mat.p1 > EPS, on, lam)


def _want(present, kind):
    return int(kind) in present


def eval_bsdf(mat: MatParams, frame: Frame, in_dir: Vec3, out_dir: Vec3,
              present) -> Color:
    """Masked dispatch; smooth dielectrics are delta and eval to 0."""
    wi = frame.to_local(in_dir)
    wo = frame.to_local(out_dir)
    z = torch.zeros_like(mat.p0)
    res = Color(z, z, z)
    if _want(present, BsdfKind.DIFFUSE):
        res = cselect(mat.kind == BsdfKind.DIFFUSE,
                      _diffuse_eval(mat, wi, wo), res)
    return res


def pdf_bsdf(mat: MatParams, frame: Frame, in_dir: Vec3, out_dir: Vec3,
             present) -> torch.Tensor:
    wi = frame.to_local(in_dir)
    cos_pdf = cosine_hemisphere_pdf(torch.clamp(wi.z, min=0.0))
    pdf = torch.zeros_like(mat.p0)
    if _want(present, BsdfKind.DIFFUSE):
        pdf = torch.where(mat.kind == BsdfKind.DIFFUSE, cos_pdf, pdf)
    return pdf


def is_all_delta(mat: MatParams) -> torch.Tensor:
    """Of the slice's kinds only the smooth dielectric is delta."""
    return (mat.kind == BsdfKind.DIELECTRIC) & (mat.p2 <= DELTA_ALPHA)


def _sel_sample(m, a: BsdfSample, b: BsdfSample) -> BsdfSample:
    return BsdfSample(vselect(m, a.in_dir, b.in_dir),
                      torch.where(m, a.pdf, b.pdf),
                      cselect(m, a.weight, b.weight),
                      torch.where(m, a.eta, b.eta),
                      torch.where(m, a.is_delta, b.is_delta),
                      torch.where(m, a.valid, b.valid))


def sample_bsdf(mat: MatParams, frame: Frame, is_entering, out_dir: Vec3,
                u0, u1, u2, present) -> BsdfSample:
    """Masked-dispatch sample. u0: lobe select; u1, u2: direction."""
    kinds = mat.kind
    zero = torch.zeros_like(mat.p0)
    one = torch.ones_like(mat.p0)
    false = zero > 1
    true = zero < 1
    wo = frame.to_local(out_dir)
    cos_o = wo.z
    refl_smooth = Vec3(-wo.x, -wo.y, wo.z)
    out = BsdfSample(refl_smooth, one, Color(one, one, one), one, true,
                     false)  # inert default (invalid)

    if _want(present, BsdfKind.DIFFUSE):
        cdir, cpdf = sample_cosine_hemisphere(u1, u2)
        on_w = _oren_nayar_eval(mat.base, mat.p1, cdir, wo) \
            * safe_div(1.0, cpdf)
        diff_w = cselect(mat.p1 > EPS, on_w, mat.base)
        diff_s = BsdfSample(cdir, cpdf, diff_w, one, false, cpdf > 0)
        out = _sel_sample(kinds == BsdfKind.DIFFUSE, diff_s, out)

    if _want(present, BsdfKind.DIELECTRIC):
        k_ratio = _eta_ratio(mat, is_entering)
        fsm = fr.fresnel_dielectric(k_ratio, torch.clamp(cos_o, min=0.0))
        refr_sm = Vec3(-wo.x * k_ratio, -wo.y * k_ratio,
                       k_ratio * cos_o - fsm.cos_t - k_ratio * wo.z)
        choose_refl = u0 <= fsm.factor
        d_dir = vselect(choose_refl, refl_smooth, refr_sm)
        d_w = cselect(choose_refl, mat.base, mat.extra)
        d_eta = torch.where(choose_refl, one, k_ratio)
        # radiance-mode refraction carries the (eta_i/eta_t)^2 compression
        d_w = d_w * torch.where(~choose_refl, k_ratio * k_ratio, 1.0)
        diel_s = BsdfSample(d_dir, one, d_w, d_eta, true, true)
        out = _sel_sample(kinds == BsdfKind.DIELECTRIC, diel_s, out)

    return out._replace(in_dir=frame.to_world(out.in_dir))


class LaneShader:
    """Per-lane BSDF interface over one material row per lane (the blend
    wrapper of the JAX LaneShader is not on the slice)."""

    def __init__(self, mat: MatParams, frame: Frame, entering, present):
        check_kinds(present)
        self.mat = mat
        self.frame = frame
        self.entering = entering
        self.present = tuple(int(k) for k in present)

    def eval(self, in_dir: Vec3, out_dir: Vec3) -> Color:
        return eval_bsdf(self.mat, self.frame, in_dir, out_dir, self.present)

    def pdf(self, in_dir: Vec3, out_dir: Vec3):
        return pdf_bsdf(self.mat, self.frame, in_dir, out_dir, self.present)

    def is_all_delta(self):
        return is_all_delta(self.mat)

    def sample(self, out_dir: Vec3, u_pick, u0, u1, u2) -> BsdfSample:
        """`u_pick` is the blend-branch draw; without blends it goes
        unused, as in the JAX LaneShader."""
        return sample_bsdf(self.mat, self.frame, self.entering, out_dir,
                           u0, u1, u2, self.present)
