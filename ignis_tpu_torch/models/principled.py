"""Disney-style principled BSDF (port of ignis_tpu/models/principled.py).

Burley diffuse with retro-reflection and optional thin subsurface, sheen,
GGX reflection with the Disney fresnel (dielectric/metallic lerp), GGX
transmission and clearcoat; lobe selection per calcLobeDistribution;
alpha = roughness^2 (at least 1e-3). Local shading frame, per lane.

Material slots (kind PRINCIPLED):
  base   = base_color
  extra2 = (flatness, diffuse_transmission, thin flag)
  p0=reflective_ior p1=refractive_ior p2=roughness_u p3=roughness_v
  q0=metallic q1=specular_transmission q2=specular_tint q3=sheen
  q4=sheen_tint q5=clearcoat q6=clearcoat_gloss q7=clearcoat_roughness
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import microfacet as mf
from ..core.fresnel import fresnel_dielectric
from ..core.vec import (Color, Vec3, clerp, cselect, dot, luminance,
                        normalize, reflect, safe_div, vselect)
from ..core.warp import INV_PI, cosine_hemisphere_pdf, sample_cosine_hemisphere

GRAZE = 1e-5
MICRO_EPS = 1e-5


class PrincipledParams(NamedTuple):
    base: Color
    refl_eta: torch.Tensor   # n1/n2 along propagation
    refr_eta: torch.Tensor
    refl_ior: torch.Tensor
    refr_ior: torch.Tensor
    au: torch.Tensor
    av: torch.Tensor
    metallic: torch.Tensor
    spec_trans: torch.Tensor
    spec_tint: torch.Tensor
    sheen: torch.Tensor
    sheen_tint: torch.Tensor
    clearcoat: torch.Tensor
    cc_gloss: torch.Tensor
    cc_rough: torch.Tensor
    flatness: torch.Tensor
    diff_trans: torch.Tensor
    thin: torch.Tensor


def _ones(like) -> Color:
    o = torch.ones_like(like)
    return Color(o, o, o)


def unpack(mat, is_entering) -> PrincipledParams:
    thin = mat.extra2.b > 0.5
    refl_ior = torch.clamp(mat.p0, min=1.01)
    refr_ior = torch.clamp(mat.p1, min=1.01)
    ent = is_entering | thin
    return PrincipledParams(
        base=mat.base,
        refl_eta=torch.where(ent, 1.0 / refl_ior, refl_ior),
        refr_eta=torch.where(ent, 1.0 / refr_ior, refr_ior),
        refl_ior=refl_ior, refr_ior=refr_ior,
        au=torch.clamp(torch.clamp(mat.p2, min=1e-3) ** 2, min=1e-3),
        av=torch.clamp(torch.clamp(mat.p3, min=1e-3) ** 2, min=1e-3),
        metallic=torch.clamp(mat.q0, 0.0, 1.0),
        spec_trans=torch.clamp(mat.q1, 0.0, 1.0),
        spec_tint=mat.q2, sheen=mat.q3, sheen_tint=mat.q4,
        clearcoat=mat.q5, cc_gloss=mat.q6, cc_rough=mat.q7,
        flatness=mat.extra2.r,
        diff_trans=torch.clamp(mat.extra2.g, 0.0, 1.0), thin=thin)


def _schlick_approx(c):
    m = torch.clamp(1.0 - c, 0.0, 1.0)
    m2 = m * m
    return m2 * m2 * m


def _schlick_r0(eta):
    r = (1.0 - eta) / (1.0 + eta)
    return r * r


def _tint_color(c: Color) -> Color:
    lum = luminance(c)
    inv = torch.where(lum > 1e-6, safe_div(1.0, lum), 1.0)
    return cselect(lum > 1e-6, c * inv, _ones(lum))


def _refr_alpha(p: PrincipledParams):
    """getRefractionMicro: thin remaps the roughness."""
    scale = torch.clamp(0.65 * p.refr_ior - 0.35, 0.0, 1.0)
    au = torch.where(p.thin, torch.clamp(scale * p.au, 1e-3, 1.0), p.au)
    av = torch.where(p.thin, torch.clamp(scale * p.av, 1e-3, 1.0), p.av)
    return au, av


def _disney_fresnel(p: PrincipledParams, h: Vec3, wo: Vec3, wi: Vec3):
    hdv = torch.abs(dot(wo, h))
    hdl = torch.abs(dot(wi, h))
    f1 = fresnel_dielectric(p.refl_eta, hdv).factor
    a = clerp(_ones(f1), _tint_color(p.base), p.spec_tint)
    r0 = clerp(a * _schlick_r0(p.refl_eta), p.base, p.metallic)
    s = _schlick_approx(hdl)
    f2 = Color(r0.r + (1.0 - r0.r) * s, r0.g + (1.0 - r0.g) * s,
               r0.b + (1.0 - r0.b) * s)
    out = clerp(Color(f1, f1, f1), f2, p.metallic)
    z = torch.zeros_like(f1)
    return cselect((hdv * hdl) > 1e-6, out, Color(z, z, z))


def _eval_diffuse(p: PrincipledParams, wi: Vec3, wo: Vec3):
    andl = torch.abs(wi.z)
    andv = torch.abs(wo.z)
    lk = _schlick_approx(andl)
    vk = _schlick_approx(andv)
    diff = (1.0 - 0.5 * lk) * (1.0 - 0.5 * vk)
    vdl = torch.abs(dot(wi, wo))
    rr = (vdl + 1.0) * (torch.sqrt(p.au) + torch.sqrt(p.av)) / 2.0
    retro = rr * (lk + vk + lk * vk * (rr - 1.0))
    # thin subsurface
    h = normalize(wi + wo)
    hdl = dot(wi, h)
    fss90 = hdl * hdl * torch.sqrt(p.au * p.av)
    fss = (1.0 - lk + fss90 * lk) * (1.0 - vk + fss90 * vk)
    ss_term = 1.25 * (fss * (1.0 / (andl + andv + 1e-5) - 0.5) + 0.5)
    ss = torch.where(p.thin, 1.0 - p.flatness + ss_term * p.flatness, 1.0)
    return INV_PI * (diff + retro) * ss * andl


def _eval_sheen(p: PrincipledParams, wi: Vec3) -> Color:
    lk = _schlick_approx(torch.abs(wi.z))
    stc = clerp(_ones(lk), _tint_color(p.base), p.sheen_tint)
    return stc * (p.sheen * lk * torch.abs(wi.z))


def _eval_reflection(p: PrincipledParams, wi: Vec3, wo: Vec3, h: Vec3):
    F = _disney_fresnel(p, h, wo, wi)
    D = mf.ndf_ggx(h, p.au, p.av)
    G = mf.g_separable(wi, wo, p.au, p.av)
    return F * torch.abs(D * G * mf.reflective_jacobian(wo.z))


def _eval_refraction(p: PrincipledParams, wi: Vec3, wo: Vec3, h: Vec3):
    au, av = _refr_alpha(p)
    hdi = dot(wi, h)
    hdo = dot(wo, h)
    F = fresnel_dielectric(p.refr_eta, torch.abs(hdo)).factor
    D = mf.ndf_ggx(h, au, av)
    G = mf.g_separable(wi, wo, au, av)
    jac = mf.refractive_jacobian(p.refr_eta, hdi, hdo)
    norm = torch.abs(safe_div(hdo * jac, wo.z))
    # radiance-mode (eta_i/eta_t)^2 compression on transmission
    term = (1.0 - F) * D * G * norm * (p.refr_eta * p.refr_eta)
    # thin: a plain fresnel pass-through
    ft = fresnel_dielectric(p.refr_eta, torch.abs(wo.z)).factor
    ft = ft + (1.0 - ft) * ft / (ft + 1.0)
    term = torch.where(p.thin, 1.0 - ft, term)
    col = cselect(p.thin,
                  Color(torch.sqrt(torch.clamp(p.base.r, min=1e-24)),
                        torch.sqrt(torch.clamp(p.base.g, min=1e-24)),
                        torch.sqrt(torch.clamp(p.base.b, min=1e-24))),
                  p.base)
    return col * term


def _eval_clearcoat(p: PrincipledParams, wi: Vec3, wo: Vec3, h: Vec3):
    F0, R = 0.04, 0.25
    r2 = torch.clamp(p.cc_rough * (1.0 - p.cc_gloss) + 0.01 * p.cc_gloss,
                     min=0.001)
    d = mf.ndf_ggx(h, r2, r2)
    f = F0 + (1.0 - F0) * _schlick_approx(torch.abs(dot(wi, h)))
    g = mf.g1_smith(wi, R, R) * mf.g1_smith(wo, R, R)
    v = torch.abs(R * d * f * g * mf.reflective_jacobian(wo.z) * wi.z)
    return Color(v, v, v)


def _halfway(p: PrincipledParams, wi: Vec3, wo: Vec3):
    is_trans = (wi.z * wo.z) < 0.0
    h = vselect(is_trans, normalize(wi + wo * p.refr_eta),
                normalize(wi + wo))
    # make_same_hemisphere(wo, h)
    flip = torch.sign(h.z * wo.z)
    flip = torch.where(flip == 0, 1.0, flip)
    return Vec3(h.x * flip, h.y * flip, h.z * flip), is_trans


def _eval_translucent(wi: Vec3, wo: Vec3):
    lk = _schlick_approx(torch.abs(wi.z))
    vk = _schlick_approx(torch.abs(wo.z))
    return INV_PI * (1.0 - 0.5 * lk) * (1.0 - 0.5 * vk) * torch.abs(wi.z)


def eval_principled(mat, is_entering, wi: Vec3, wo: Vec3) -> Color:
    p = unpack(mat, is_entering)
    h, is_trans = _halfway(p, wi, wo)
    andl = torch.abs(wi.z)
    diffuse_weight = (torch.where(p.thin, 1.0, 1.0 - p.metallic)
                      * (1.0 - p.spec_trans))
    trans_weight = (1.0 - p.metallic) * p.spec_trans
    refl = (p.base * (_eval_diffuse(p, wi, wo) * diffuse_weight)
            + _eval_sheen(p, wi) * diffuse_weight
            + _eval_reflection(p, wi, wo, h)
            + _eval_clearcoat(p, wi, wo, h) * p.clearcoat)
    trans = (p.base * (torch.where(p.thin, 1.0, 0.0) * p.diff_trans
                       * _eval_translucent(wi, wo))
             + _eval_refraction(p, wi, wo, h) * trans_weight)
    out = cselect(is_trans, trans, refl)
    z = torch.zeros_like(andl)
    return cselect(andl > GRAZE, out, Color(z, z, z))


def _lobe_distribution(p: PrincipledParams, wo: Vec3):
    abs_gen = luminance(p.base)
    abs_spec = 1.0 + (luminance(_tint_color(p.base)) - 1.0) * p.spec_tint
    diff_refl = torch.clamp(abs_gen * (1.0 - p.metallic)
                            * (1.0 - p.spec_trans), 0, 1)
    F = fresnel_dielectric(p.refr_eta, torch.abs(wo.z)).factor
    spec_refl = torch.clamp(abs_spec * (1.0 - F) + F, 0, 1)
    diff_trans = torch.clamp(abs_gen * p.diff_trans * diff_refl, 0, 1)
    spec_trans = torch.clamp((1.0 - F) * abs_gen * (1.0 - p.metallic)
                             * p.spec_trans, 0, 1)
    has_t = (p.diff_trans > 0) | (p.spec_trans > 0)
    diff_trans = torch.where(has_t, diff_trans, 0.0)
    spec_trans = torch.where(has_t, spec_trans, 0.0)
    norm = diff_refl + spec_refl + diff_trans + spec_trans
    ok = norm > 1e-6
    inv = safe_div(1.0, norm)
    return (torch.where(ok, diff_refl * inv, 1.0),
            torch.where(ok, diff_trans * inv, 0.0),
            torch.where(ok, spec_refl * inv, 0.0),
            torch.where(ok, spec_trans * inv, 0.0))


def _pos_hemi(v: Vec3) -> Vec3:
    s = torch.sign(v.z)
    s = torch.where(s == 0, 1.0, s)
    return Vec3(v.x * s, v.y * s, v.z * s)


def _spec_refl_pdf(p: PrincipledParams, wi: Vec3, wo: Vec3):
    pwo = _pos_hemi(wo)
    h = normalize(_pos_hemi(wi) + pwo)
    pdf_h = mf.pdf_vndf_ggx(pwo, h, p.au, p.av)
    pdf_h = torch.where(pdf_h > MICRO_EPS, pdf_h, 0.0)
    return torch.abs(pdf_h * mf.reflective_jacobian(dot(pwo, h)))


def _spec_trans_pdf(p: PrincipledParams, wi: Vec3, wo: Vec3):
    au, av = _refr_alpha(p)
    pwo = _pos_hemi(wo)
    pwi = -_pos_hemi(wi)
    h = normalize(pwi + pwo * p.refr_eta)
    pdf_h = mf.pdf_vndf_ggx(pwo, h, au, av)
    pdf_h = torch.where(pdf_h > MICRO_EPS, pdf_h, 0.0)
    return torch.abs(pdf_h * mf.refractive_jacobian(p.refr_eta, dot(pwi, h),
                                                    dot(pwo, h)))


def pdf_principled(mat, is_entering, wi: Vec3, wo: Vec3):
    p = unpack(mat, is_entering)
    dr, dt, sr, st = _lobe_distribution(p, wo)
    diff_pdf = cosine_hemisphere_pdf(torch.abs(wi.z))
    same = (wi.z * wo.z) >= 0.0
    pdf_same = dr * diff_pdf + sr * _spec_refl_pdf(p, wi, wo)
    pdf_thin = dt * diff_pdf + st
    pdf_trans = dt * diff_pdf + st * _spec_trans_pdf(p, wi, wo)
    out = torch.where(same, pdf_same, torch.where(p.thin, pdf_thin,
                                                  pdf_trans))
    graze = (torch.abs(wi.z) <= GRAZE) | (torch.abs(wo.z) <= GRAZE)
    return torch.where(graze, 0.0, out)


def sample_principled(mat, is_entering, wo: Vec3, u0, u1, u2):
    """(wi_local, pdf, eta, valid); the weight is eval/pdf (caller)."""
    p = unpack(mat, is_entering)
    dr, dt, sr, st = _lobe_distribution(p, wo)
    pwo = _pos_hemi(wo)
    # candidates are built around pwo and flipped back by whole vectors
    flip = torch.sign(wo.z)
    flip = torch.where(flip == 0, 1.0, flip)

    cdir, _ = sample_cosine_hemisphere(u1, u2)
    wi_dr = cdir * flip
    wi_dt = cdir * (-flip)
    h_r = mf.sample_vndf_ggx(pwo, p.au, p.av, u1, u2)
    wi_sr = reflect(pwo, h_r) * flip
    au_t, av_t = _refr_alpha(p)
    h_t = mf.sample_vndf_ggx(pwo, au_t, av_t, u1, u2)
    cos_h_o = dot(h_t, pwo)
    frt = fresnel_dielectric(p.refr_eta, torch.abs(cos_h_o))
    s = p.refr_eta * cos_h_o - frt.cos_t
    refr = normalize(Vec3(h_t.x * s - pwo.x * p.refr_eta,
                          h_t.y * s - pwo.y * p.refr_eta,
                          h_t.z * s - pwo.z * p.refr_eta))
    # total internal reflection reflects instead
    pwi_t = vselect(frt.total, reflect(pwo, h_t), refr)
    wi_st = vselect(p.thin, -wo, pwi_t * flip)

    c1 = dr
    c2 = dr + dt
    c3 = dr + dt + st
    pick_dr = u0 < c1
    pick_dt = (~pick_dr) & (u0 < c2)
    pick_st = (~pick_dr) & (~pick_dt) & (u0 < c3)
    wi = vselect(pick_dr, wi_dr,
                 vselect(pick_dt, wi_dt, vselect(pick_st, wi_st, wi_sr)))
    pdf = pdf_principled(mat, is_entering, wi, wo)
    same = (wi.z * wo.z) >= 0.0
    eta = torch.where(p.thin | same, 1.0, p.refr_eta)
    valid = (pdf > 1e-7) & (torch.abs(wo.z) > GRAZE) & torch.isfinite(pdf)
    return wi, pdf, eta, valid
