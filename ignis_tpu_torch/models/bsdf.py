"""BSDF evaluation / sampling / pdf with masked kind dispatch.

Port of ignis_tpu/models/bsdf.py's analytic kinds: diffuse (Lambert and
Oren-Nayar), dielectric (smooth, rough and thin), conductor (smooth, rough
and anisotropic), phong, plastic (smooth and rough), principled
(models/principled.py), passthrough, null/error and the Radiance models
RAD_BRTDF and RAD_ROOS, with the blend wrapper (`LaneShader`,
`make_lane_shader`). Every kind present in the scene runs on every lane
and a mask selects; `settings.bsdf_kinds` prunes absent kinds statically,
with the ROUGH_FLAG / THIN_FLAG pseudo-kinds pruning the microfacet and
thin-glass code of scenes without such rows. The measured kinds (klems,
tensortree, djmeasured; models/klems.py, tensortree.py, djmeasured.py)
read their tables from SceneData.measured by the row's q6, one unrolled
masked select over the scene's tables (`_select_tables`).

Semantics (reference bsdf/*.art): eval includes the cosine term and delta
lobes eval to 0; sample returns weight = eval/pdf, the eta ratio and a
delta flag; rough lobes are GGX with visible-normal sampling
(core/microfacet.py) and alpha <= 1e-4 is the delta variant.

Material slots (scenedata.Materials):
  DIFFUSE:    base=reflectance, p1=roughness (Oren-Nayar alpha)
  DIELECTRIC: base=spec_refl, extra=spec_trans, p0=ext_ior, p1=int_ior,
              p2=alpha, p3=thin flag
  CONDUCTOR:  base=spec_refl, extra=eta, extra2=k, p2=alpha_u, p3=alpha_v
  PHONG:      base=spec_refl, p0=exponent
  PLASTIC:    base=diffuse_refl, extra=spec_refl, p0=ext_ior, p1=int_ior,
              p2=alpha
  BLEND:      p0=weight, q0/q1=child rows, p1=cutoff threshold, p2=cutoff
  RAD_*:      base/extra=(specular or Roos w,p,q), extra2=trns_diff,
              q0-q5=front/back diffuse reflection
  KLEMS, TENSORTREE: base=colour, extra2=the up vector, q6=table index
  DJMEASURED: base=tint, q6=table index
"""
from __future__ import annotations

from enum import IntEnum
from typing import NamedTuple

import torch

from ..core import fresnel as fr
from ..core import microfacet as mf
from ..core.frame import Frame, make_frame
from ..core.vec import (Color, Vec3, clerp, cselect, dot, normalize, reflect,
                        safe_div, vselect)
from ..core.warp import (INV_PI, cosine_hemisphere_pdf,
                         cosine_power_hemisphere_pdf, sample_cosine_hemisphere,
                         sample_cosine_power_hemisphere)

EPS = 1e-6
DELTA_ALPHA = mf.DELTA_ALPHA
# pseudo-kinds in settings.bsdf_kinds: ROUGH_FLAG + kind when a conductor
# or dielectric row is rough, THIN_FLAG + DIELECTRIC when one is thin
ROUGH_FLAG = 100
THIN_FLAG = 200
# nesting depth of blends resolved per lane (deeper children degrade to
# the deepest level's rows, as in the JAX package)
BLEND_MAX_DEPTH = 2


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


def check_kinds(present) -> None:
    """Raise for settings without their BSDF kinds."""
    if present is None:
        raise ValueError("settings.bsdf_kinds must be set")


class MatParams(NamedTuple):
    kind: torch.Tensor
    base: Color
    extra: Color
    extra2: Color
    p0: torch.Tensor
    p1: torch.Tensor
    p2: torch.Tensor
    p3: torch.Tensor
    # principled: q0=metallic q1=spec_trans q2=spec_tint q3=sheen
    # q4=sheen_tint q5=clearcoat q6=clearcoat_gloss q7=clearcoat_roughness;
    # blend: q0/q1 = child rows; RAD: q0-q5 = front/back diffuse
    q0: torch.Tensor
    q1: torch.Tensor
    q2: torch.Tensor
    q3: torch.Tensor
    q4: torch.Tensor
    q5: torch.Tensor
    q6: torch.Tensor
    q7: torch.Tensor
    q8: torch.Tensor


class BsdfSample(NamedTuple):
    in_dir: Vec3
    pdf: torch.Tensor
    weight: Color
    eta: torch.Tensor
    is_delta: torch.Tensor
    valid: torch.Tensor


def _black(like) -> Color:
    z = torch.zeros_like(like)
    return Color(z, z, z)


def _want(present, kind):
    return present is None or int(kind) in present


def _want_rough(present, kind):
    return present is None or (ROUGH_FLAG + int(kind)) in present


def _want_thin(present):
    return present is None or (THIN_FLAG + int(BsdfKind.DIELECTRIC)) in present


def _want_rad(present):
    return _want(present, BsdfKind.RAD_BRTDF) or _want(present,
                                                       BsdfKind.RAD_ROOS)


# ---------------------------------------------------------------------------
# Helpers
# ---------------------------------------------------------------------------

def _conductor_fresnel(eta: Color, k: Color, cos_i) -> Color:
    """reference conductor_factor (fresnel.art), per channel."""
    def chan(n, kk):
        f = n * n + kk * kk
        c2 = cos_i * cos_i
        d1 = f * c2
        d2 = 2.0 * n * cos_i
        rs = safe_div(d1 - d2, d1 + d2)
        rp = safe_div(f - d2 + c2, f + d2 + c2)
        return torch.clamp((rs * rs + rp * rp) * 0.5, 0.0, 1.0)
    return Color(chan(eta.r, k.r), chan(eta.g, k.g), chan(eta.b, k.b))


def _fresnel_diffuse_factor(eta):
    """fresnel.art:42 (Egan/Hilgeman and d'Eon/Irving fits)."""
    lo = (-1.4399 * eta * eta + 0.7099 * eta + 0.6681
          + 0.0636 / torch.clamp(eta, min=1e-6))
    ie = 1.0 / torch.clamp(eta, min=1e-6)
    hi = (0.919317 - 3.4793 * ie + 6.75335 * ie ** 2 - 7.80989 * ie ** 3
          + 4.98554 * ie ** 4 - 1.36881 * ie ** 5)
    return torch.where(eta < 1.0, lo, hi)


def _eta_ratio(mat: MatParams, is_entering):
    """n1/n2 along the propagation direction (dielectric, plastic)."""
    return torch.where(is_entering, mat.p0 / torch.clamp(mat.p1, min=1e-6),
                       mat.p1 / torch.clamp(mat.p0, min=1e-6))


# ---------------------------------------------------------------------------
# Diffuse family and phong
# ---------------------------------------------------------------------------

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


def _phong_eval(mat: MatParams, wi: Vec3, wo: Vec3) -> Color:
    cos_i = torch.clamp(wi.z, min=0.0)
    r = Vec3(-wo.x, -wo.y, wo.z)
    # floor: pow(0, k)'s slope blows up
    c = torch.clamp(dot(r, wi), min=1e-6)
    k = mat.p0
    return mat.base * (torch.pow(c, k) * (k + 2.0) * (0.5 * INV_PI) * cos_i)


# ---------------------------------------------------------------------------
# Rough conductor (conductor.art make_rough_conductor_bsdf)
# ---------------------------------------------------------------------------

def _conductor_rough_eval(mat: MatParams, wi: Vec3, wo: Vec3) -> Color:
    au, av = mat.p2, mat.p3
    h = normalize(wi + wo)
    cos_i = wi.z
    cos_o = wo.z
    D = mf.ndf_ggx(h, torch.clamp(au, min=1e-5), torch.clamp(av, min=1e-5))
    G = mf.g_separable(wi, wo, au, av)
    F = _conductor_fresnel(mat.extra, mat.extra2, torch.abs(dot(h, wo)))
    f = safe_div(D * G, 4.0 * torch.abs(cos_o))
    ok = (cos_i > EPS) & (cos_o > EPS) & (au > DELTA_ALPHA)
    return cselect(ok, mat.base.cmul(F) * f, _black(cos_i))


def _conductor_rough_pdf(mat: MatParams, wi: Vec3, wo: Vec3):
    au = torch.clamp(mat.p2, min=1e-5)
    av = torch.clamp(mat.p3, min=1e-5)
    h = normalize(wi + wo)
    pdf_h = mf.pdf_vndf_ggx(wo, h, au, av)
    pdf = pdf_h * torch.abs(mf.reflective_jacobian(dot(h, wo)))
    ok = (wi.z > EPS) & (wo.z > EPS) & (mat.p2 > DELTA_ALPHA)
    return torch.where(ok, pdf, 0.0)


# ---------------------------------------------------------------------------
# Rough dielectric (dielectric.art make_rough_dielectric_bsdf)
# ---------------------------------------------------------------------------

def _diel_halfway(wi: Vec3, wo: Vec3, eta, is_transmission):
    return vselect(is_transmission, normalize(wi + wo * eta),
                   normalize(wi + wo))


def _dielectric_rough_eval(mat: MatParams, is_entering, wi: Vec3,
                           wo: Vec3) -> Color:
    eta = _eta_ratio(mat, is_entering)
    alpha = torch.clamp(mat.p2, min=1e-5)
    cos_i = wi.z
    cos_o = wo.z
    is_trans = (cos_i * cos_o) < 0.0
    h = _diel_halfway(wi, wo, eta, is_trans)
    cos_h_i = dot(h, wi)
    cos_h_o = dot(h, wo)
    F = fr.fresnel_dielectric(eta, torch.abs(cos_h_o)).factor
    D = mf.ndf_ggx(h, alpha, alpha)
    G = mf.g_separable(wi, wo, alpha, alpha)
    refl = mat.base * (F * D * G * torch.abs(mf.reflective_jacobian(cos_o)))
    jac = mf.refractive_jacobian(eta, cos_h_i, cos_h_o)
    norm = torch.abs(safe_div(cos_h_o * jac, cos_o))
    # radiance-mode (eta_i/eta_t)^2 compression on transmission
    trans = mat.extra * ((1.0 - F) * D * G * norm * (eta * eta))
    ok = ((torch.abs(cos_i * cos_o) > EPS)
          & (torch.abs(cos_h_i * cos_h_o) > EPS) & (mat.p2 > DELTA_ALPHA))
    return cselect(ok, cselect(is_trans, trans, refl), _black(cos_i))


def _dielectric_rough_pdf(mat: MatParams, is_entering, wi: Vec3, wo: Vec3):
    eta = _eta_ratio(mat, is_entering)
    alpha = torch.clamp(mat.p2, min=1e-5)
    cos_i = wi.z
    cos_o = wo.z
    is_trans = (cos_i * cos_o) < 0.0
    h = _diel_halfway(wi, wo, eta, is_trans)
    cos_h_i = dot(h, wi)
    cos_h_o = dot(h, wo)
    F = fr.fresnel_dielectric(eta, torch.abs(cos_h_o)).factor
    mpdf = mf.pdf_vndf_ggx(wo, h, alpha, alpha)
    p_refl = F * mpdf * torch.abs(mf.reflective_jacobian(cos_h_o))
    p_trans = (1.0 - F) * mpdf * torch.abs(
        mf.refractive_jacobian(eta, cos_h_i, cos_h_o))
    pdf = torch.where(is_trans, p_trans, p_refl)
    ok = ((torch.abs(cos_i * cos_o) > EPS)
          & (torch.abs(cos_h_i * cos_h_o) > EPS) & (mat.p2 > DELTA_ALPHA)
          & (mpdf > 1e-5))
    return torch.where(ok, pdf, 0.0)


# ---------------------------------------------------------------------------
# Plastic (plastic.art: fresnel mix of diffuse with inner scattering and a
# smooth or rough coat)
# ---------------------------------------------------------------------------

def _plastic_parts(mat: MatParams, wi: Vec3, wo: Vec3):
    eta = mat.p0 / torch.clamp(mat.p1, min=1e-6)
    fdr = _fresnel_diffuse_factor(eta)
    fi = fr.fresnel_dielectric(eta, torch.abs(wi.z)).factor
    fo = fr.fresnel_dielectric(eta, torch.abs(wo.z)).factor
    scatter = (1.0 - fi) * eta * eta / torch.clamp(1.0 - fdr, min=1e-4)
    return fo, scatter


def _coat(mat: MatParams) -> MatParams:
    """The plastic's coat as an isotropic rough conductor row."""
    z = mat.p0 * 0
    return mat._replace(base=mat.extra, extra=Color(z, z, z),
                        extra2=Color(z + 1, z + 1, z + 1), p3=mat.p2)


def _plastic_eval(mat: MatParams, wi: Vec3, wo: Vec3) -> Color:
    fo, scatter = _plastic_parts(mat, wi, wo)
    cos_i = torch.clamp(wi.z, min=0.0)
    out = mat.base * (cos_i * INV_PI * scatter) * (1.0 - fo)
    rough = mat.p2 > DELTA_ALPHA
    coat = _conductor_rough_eval(_coat(mat), wi, wo)
    return cselect(rough, cselect(fo > 0, out + coat * fo, out), out)


def _plastic_pdf(mat: MatParams, wi: Vec3, wo: Vec3):
    fo, _ = _plastic_parts(mat, wi, wo)
    p = (1.0 - fo) * cosine_hemisphere_pdf(torch.clamp(wi.z, min=0.0))
    rough = mat.p2 > DELTA_ALPHA
    p_coat = _conductor_rough_pdf(mat._replace(p3=mat.p2), wi, wo)
    return torch.where(rough, p + fo * p_coat, p)


# ---------------------------------------------------------------------------
# Radiance models (rad.art): mirror + straight transmission + lambert
# reflection/transmission, with nested one-sample lobe selection
# ---------------------------------------------------------------------------

def _rad_lobes(mat: MatParams, is_entering, wo: Vec3):
    """Per-lane (refl_spec, trns_spec, refl_diff, trns_diff)."""
    # Roos angular model (rad.art:37): specular terms from the view angle;
    # arccos's argument kept inside (-1, 1), where its slope is finite
    z = torch.arccos(torch.clamp(torch.abs(wo.z), 0.0, 1.0 - 1e-7)) \
        * 0.636619772368
    tq = torch.clamp(mat.base.b, min=1e-4)
    rq = torch.clamp(mat.extra.b, min=1e-4)
    tp, rp = mat.base.g, mat.extra.g
    tw, rw = mat.base.r, mat.extra.r
    a = 8.0
    alpha_t = 5.2 + 0.7 * tq

    def gamma(p, q):
        return (5.26 + 0.06 * p) + (0.73 + 0.04 * p) * q
    b_t = 0.25 / tq
    c_t = 1.0 - a - b_t
    tau = tw * (1.0 - a * torch.pow(z, alpha_t) - b_t * z * z
                - c_t * torch.pow(z, gamma(tp, tq)))
    rf = rw + (1.0 - rw) * torch.pow(z, gamma(rp, rq))
    tau = torch.clamp(tau, 0.0, 1.0)
    rf = torch.clamp(rf, 0.0, 1.0)

    is_roos = mat.kind == BsdfKind.RAD_ROOS
    refl_spec = cselect(is_roos, Color(rf, rf, rf), mat.base)
    trns_spec = cselect(is_roos, Color(tau, tau, tau), mat.extra)
    front = Color(mat.q0, mat.q1, mat.q2)
    back = Color(mat.q3, mat.q4, mat.q5)
    refl_diff = cselect(is_entering.expand(mat.p0.shape), front, back)
    return refl_spec, trns_spec, refl_diff, mat.extra2


def _avg(c: Color):
    return (c.r + c.g + c.b) * (1.0 / 3.0)


def _rad_probs(refl_spec, trns_spec, refl_diff, trns_diff):
    """Nested lobe-selection probabilities (rad.art:16-28)."""
    p_refr = safe_div(_avg(trns_spec), _avg(refl_spec) + _avg(trns_spec))
    p_td = safe_div(_avg(trns_diff), _avg(refl_diff) + _avg(trns_diff))
    sum_spec = _avg(refl_spec) + _avg(trns_spec)
    sum_diff = _avg(refl_diff) + _avg(trns_diff)
    return p_refr, p_td, safe_div(sum_spec, sum_spec + sum_diff)


def _rad_eval(mat: MatParams, is_entering, wi: Vec3, wo: Vec3) -> Color:
    _, _, refl_diff, trns_diff = _rad_lobes(mat, is_entering, wo)
    cr = torch.clamp(wi.z, min=0.0) * INV_PI
    ct = torch.clamp(-wi.z, min=0.0) * INV_PI
    return Color(refl_diff.r * cr + trns_diff.r * ct,
                 refl_diff.g * cr + trns_diff.g * ct,
                 refl_diff.b * cr + trns_diff.b * ct)


def _rad_pdf(mat: MatParams, is_entering, wi: Vec3, wo: Vec3):
    _, p_td, p_spec = _rad_probs(*_rad_lobes(mat, is_entering, wo))
    pr = cosine_hemisphere_pdf(torch.clamp(wi.z, min=0.0)) * (1.0 - p_td)
    pt = cosine_hemisphere_pdf(torch.clamp(-wi.z, min=0.0)) * p_td
    return (1.0 - p_spec) * (pr + pt)


def _rad_sample(mat: MatParams, is_entering, wo: Vec3, u0, cdir: Vec3,
                cpdf) -> BsdfSample:
    refl_spec, trns_spec, refl_diff, trns_diff = _rad_lobes(mat, is_entering,
                                                            wo)
    p_refr, p_td, p_spec = _rad_probs(refl_spec, trns_spec, refl_diff,
                                      trns_diff)
    one = torch.ones_like(u0)
    pick_spec = u0 < p_spec
    # re-stretch u0 within the chosen group for the inner lobe choice
    u_in = torch.where(pick_spec, safe_div(u0, p_spec),
                       safe_div(u0 - p_spec, 1.0 - p_spec))
    pick_refr = u_in < p_refr
    pick_td = u_in < p_td

    refl_smooth = Vec3(-wo.x, -wo.y, wo.z)
    spec_dir = vselect(pick_refr, -wo, refl_smooth)
    spec_w = cselect(pick_refr,
                     trns_spec * safe_div(1.0, p_spec * p_refr),
                     refl_spec * safe_div(1.0, p_spec * (1.0 - p_refr)))
    diff_dir = vselect(pick_td, Vec3(cdir.x, cdir.y, -cdir.z), cdir)
    diff_w = cselect(pick_td,
                     trns_diff * safe_div(1.0, (1.0 - p_spec) * p_td),
                     refl_diff * safe_div(1.0, (1.0 - p_spec) * (1.0 - p_td)))
    diff_pdf = cpdf * (1.0 - p_spec) * torch.where(pick_td, p_td, 1.0 - p_td)
    return BsdfSample(vselect(pick_spec, spec_dir, diff_dir),
                      torch.where(pick_spec, one, diff_pdf),
                      cselect(pick_spec, spec_w, diff_w), one, pick_spec,
                      torch.where(pick_spec, one > 0, cpdf > 0))


def _select_tables(mat: MatParams, measured, want_type, fn, zero):
    """An unrolled masked select over the scene's measured tables of type
    `want_type` by the row's q6: each lane takes fn(its table), a tensor,
    Color or tuple of them shaped like `zero`."""
    kid = mat.q6.to(torch.int32)
    out = zero
    for i, kd in enumerate(measured):
        if not isinstance(kd, want_type):
            continue
        v = fn(kd)
        m = kid == i
        if isinstance(out, Color):
            out = cselect(m, v, out)
        elif isinstance(out, tuple):
            out = tuple(
                cselect(m, a, b) if isinstance(b, Color) else
                (vselect(m, a, b) if isinstance(b, Vec3)
                 else torch.where(m, a, b))
                for a, b in zip(v, out))
        else:
            out = torch.where(m, v, out)
    return out


def _measured_dispatch(op, mat: MatParams, frame: Frame, is_entering,
                       measured, zero, want_type):
    """_select_tables of op(table, the Klems frame of the row's up vector)
    (ignis_tpu/models/bsdf.py:419-445): the Klems and TensorTree kinds."""
    from . import klems as klemslib
    up = Vec3(mat.extra2.r, mat.extra2.g, mat.extra2.b)
    kframe = klemslib.make_klems_frame(frame.n, is_entering, up)
    return _select_tables(mat, measured, want_type,
                          lambda kd: op(kd, kframe), zero)


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------

def eval_bsdf(mat: MatParams, frame: Frame, is_entering, in_dir: Vec3,
              out_dir: Vec3, present=None, measured=()) -> Color:
    """Masked dispatch over the kinds in `present` (settings.bsdf_kinds;
    None = all); delta lobes eval to 0. `measured` holds the scene's
    measured tables (SceneData.measured)."""
    from . import principled
    wi = frame.to_local(in_dir)
    wo = frame.to_local(out_dir)
    kinds = mat.kind
    res = _black(mat.p0)
    if _want(present, BsdfKind.DIFFUSE):
        res = cselect(kinds == BsdfKind.DIFFUSE, _diffuse_eval(mat, wi, wo),
                      res)
    if _want(present, BsdfKind.PHONG):
        res = cselect(kinds == BsdfKind.PHONG, _phong_eval(mat, wi, wo), res)
    if _want(present, BsdfKind.PLASTIC):
        res = cselect(kinds == BsdfKind.PLASTIC, _plastic_eval(mat, wi, wo),
                      res)
    if _want_rough(present, BsdfKind.CONDUCTOR):
        res = cselect(kinds == BsdfKind.CONDUCTOR,
                      _conductor_rough_eval(mat, wi, wo), res)
    if _want_rough(present, BsdfKind.DIELECTRIC):
        res = cselect(kinds == BsdfKind.DIELECTRIC,
                      _dielectric_rough_eval(mat, is_entering, wi, wo), res)
    if _want(present, BsdfKind.PRINCIPLED):
        res = cselect(kinds == BsdfKind.PRINCIPLED,
                      principled.eval_principled(mat, is_entering, wi, wo),
                      res)
    if _want_rad(present):
        is_rad = (kinds == BsdfKind.RAD_BRTDF) | (kinds == BsdfKind.RAD_ROOS)
        res = cselect(is_rad, _rad_eval(mat, is_entering, wi, wo), res)
    if measured and _want(present, BsdfKind.KLEMS):
        from . import klems as klemslib
        v = _measured_dispatch(
            lambda kd, kf: klemslib.klems_eval(kd, mat.base, kf, in_dir,
                                               out_dir),
            mat, frame, is_entering, measured, _black(mat.p0),
            klemslib.KlemsData)
        res = cselect(kinds == BsdfKind.KLEMS, v, res)
    if measured and _want(present, BsdfKind.TENSORTREE):
        from . import tensortree as ttlib
        v = _measured_dispatch(
            lambda kd, kf: ttlib.tt_eval(kd, mat.base, kf, in_dir, out_dir),
            mat, frame, is_entering, measured, _black(mat.p0),
            ttlib.TensorTreeData)
        res = cselect(kinds == BsdfKind.TENSORTREE, v, res)
    if measured and _want(present, BsdfKind.DJMEASURED):
        from . import djmeasured as djlib
        v = _select_tables(mat, measured, djlib.DJData,
                           lambda kd: djlib.dj_eval(kd, mat.base, wi, wo),
                           _black(mat.p0))
        res = cselect(kinds == BsdfKind.DJMEASURED, v, res)
    if _want(present, BsdfKind.NULL_ERROR):
        err = torch.clamp(wi.z, min=0.0) * INV_PI
        res = cselect(kinds == BsdfKind.NULL_ERROR,
                      Color(err, torch.zeros_like(err), err), res)
    return res


def pdf_bsdf(mat: MatParams, frame: Frame, is_entering, in_dir: Vec3,
             out_dir: Vec3, present=None, measured=()) -> torch.Tensor:
    from . import principled
    wi = frame.to_local(in_dir)
    # the diffuse and null pdfs need no out direction: scenes of those
    # kinds alone skip it
    if any(_want(present, k) for k in (BsdfKind.PLASTIC, BsdfKind.PHONG,
                                       BsdfKind.PRINCIPLED)) or any(
            _want_rough(present, k) for k in (BsdfKind.CONDUCTOR,
                                              BsdfKind.DIELECTRIC)) \
            or _want_rad(present) or (measured and _want(
                present, BsdfKind.DJMEASURED)):
        wo = frame.to_local(out_dir)
    kinds = mat.kind
    cos_pdf = cosine_hemisphere_pdf(torch.clamp(wi.z, min=0.0))
    pdf = torch.zeros_like(mat.p0)
    if _want(present, BsdfKind.DIFFUSE):
        pdf = torch.where(kinds == BsdfKind.DIFFUSE, cos_pdf, pdf)
    if _want(present, BsdfKind.NULL_ERROR):
        pdf = torch.where(kinds == BsdfKind.NULL_ERROR, cos_pdf, pdf)
    if _want(present, BsdfKind.PLASTIC):
        pdf = torch.where(kinds == BsdfKind.PLASTIC,
                          _plastic_pdf(mat, wi, wo), pdf)
    if _want(present, BsdfKind.PHONG):
        c = torch.clamp(dot(Vec3(-wo.x, -wo.y, wo.z), wi), min=0.0)
        pdf = torch.where(kinds == BsdfKind.PHONG,
                          cosine_power_hemisphere_pdf(c, mat.p0), pdf)
    if _want_rough(present, BsdfKind.CONDUCTOR):
        pdf = torch.where(kinds == BsdfKind.CONDUCTOR,
                          _conductor_rough_pdf(mat, wi, wo), pdf)
    if _want_rough(present, BsdfKind.DIELECTRIC):
        pdf = torch.where(kinds == BsdfKind.DIELECTRIC,
                          _dielectric_rough_pdf(mat, is_entering, wi, wo),
                          pdf)
    if _want(present, BsdfKind.PRINCIPLED):
        pdf = torch.where(kinds == BsdfKind.PRINCIPLED,
                          principled.pdf_principled(mat, is_entering, wi, wo),
                          pdf)
    if _want_rad(present):
        is_rad = (kinds == BsdfKind.RAD_BRTDF) | (kinds == BsdfKind.RAD_ROOS)
        pdf = torch.where(is_rad, _rad_pdf(mat, is_entering, wi, wo), pdf)
    if measured and _want(present, BsdfKind.KLEMS):
        from . import klems as klemslib
        v = _measured_dispatch(
            lambda kd, kf: klemslib.klems_pdf(kd, kf, in_dir, out_dir),
            mat, frame, is_entering, measured, torch.zeros_like(mat.p0),
            klemslib.KlemsData)
        pdf = torch.where(kinds == BsdfKind.KLEMS, v, pdf)
    if measured and _want(present, BsdfKind.TENSORTREE):
        from . import tensortree as ttlib
        v = _measured_dispatch(
            lambda kd, kf: ttlib.tt_pdf(kd, kf, in_dir, out_dir),
            mat, frame, is_entering, measured, torch.zeros_like(mat.p0),
            ttlib.TensorTreeData)
        pdf = torch.where(kinds == BsdfKind.TENSORTREE, v, pdf)
    if measured and _want(present, BsdfKind.DJMEASURED):
        from . import djmeasured as djlib
        v = _select_tables(mat, measured, djlib.DJData,
                           lambda kd: djlib.dj_pdf(kd, wi, wo),
                           torch.zeros_like(mat.p0))
        pdf = torch.where(kinds == BsdfKind.DJMEASURED, v, pdf)
    return pdf


def is_all_delta(mat: MatParams, present=None) -> torch.Tensor:
    """Lanes whose every lobe is delta: passthrough, smooth dielectrics
    and smooth conductors (only the kinds in `present` are tested)."""
    k = mat.kind
    terms = []
    if _want(present, BsdfKind.PASSTHROUGH):
        terms.append(k == BsdfKind.PASSTHROUGH)
    if _want(present, BsdfKind.DIELECTRIC):
        terms.append((k == BsdfKind.DIELECTRIC) & (mat.p2 <= DELTA_ALPHA))
    if _want(present, BsdfKind.CONDUCTOR):
        terms.append((k == BsdfKind.CONDUCTOR) & (mat.p2 <= DELTA_ALPHA))
    if not terms:
        return torch.zeros_like(k, dtype=torch.bool)
    out = terms[0]
    for t in terms[1:]:
        out = out | t
    return out


def _sel_sample(m, a: BsdfSample, b: BsdfSample) -> BsdfSample:
    return BsdfSample(vselect(m, a.in_dir, b.in_dir),
                      torch.where(m, a.pdf, b.pdf),
                      cselect(m, a.weight, b.weight),
                      torch.where(m, a.eta, b.eta),
                      torch.where(m, a.is_delta, b.is_delta),
                      torch.where(m, a.valid, b.valid))


def sample_bsdf(mat: MatParams, frame: Frame, is_entering, out_dir: Vec3,
                u0, u1, u2, present=None, adjoint=False,
                measured=()) -> BsdfSample:
    """Masked-dispatch sample. u0: lobe select; u1, u2: direction. With
    `adjoint` (importance transport) refraction carries no (eta_i/eta_t)^2
    radiance compression."""
    from . import principled
    kinds = mat.kind
    zero = torch.zeros_like(mat.p0)
    one = torch.ones_like(mat.p0)
    false = zero > 1
    true = zero < 1
    wo = frame.to_local(out_dir)
    cos_o = wo.z
    refl_smooth = Vec3(-wo.x, -wo.y, wo.z)

    need_cos = any(_want(present, k) for k in
                   (BsdfKind.DIFFUSE, BsdfKind.PLASTIC, BsdfKind.NULL_ERROR))
    # the half vector serves the rough conductor and dielectric rows and
    # the plastic's coat; smooth-only scenes skip it
    need_vndf = (_want_rough(present, BsdfKind.CONDUCTOR)
                 or _want_rough(present, BsdfKind.DIELECTRIC)
                 or _want(present, BsdfKind.PLASTIC))
    if need_cos or _want_rad(present):
        cdir, cpdf = sample_cosine_hemisphere(u1, u2)
    if need_vndf:
        h_l = mf.sample_vndf_ggx(
            wo, torch.clamp(mat.p2, min=1e-5),
            torch.clamp(torch.where(kinds == BsdfKind.CONDUCTOR, mat.p3,
                                    mat.p2), min=1e-5), u1, u2)
        refl_r = reflect(wo, h_l)

    out = BsdfSample(refl_smooth, one, Color(one, one, one), one, true,
                     false)  # inert default (invalid)

    def sel(kind_val, s_, cur):
        return _sel_sample(kinds == kind_val, s_, cur)

    if _want(present, BsdfKind.DIFFUSE):
        on_w = _oren_nayar_eval(mat.base, mat.p1, cdir, wo) \
            * safe_div(1.0, cpdf)
        diff_w = cselect(mat.p1 > EPS, on_w, mat.base)
        out = sel(BsdfKind.DIFFUSE,
                  BsdfSample(cdir, cpdf, diff_w, one, false, cpdf > 0), out)

    if _want(present, BsdfKind.PHONG):
        pdir_l, ppdf = sample_cosine_power_hemisphere(mat.p0, u1, u2)
        pdir = make_frame(refl_smooth).to_world(pdir_l)
        p_w = cselect(ppdf > EPS,
                      _phong_eval(mat, pdir, wo) * safe_div(1.0, ppdf),
                      _black(zero))
        out = sel(BsdfKind.PHONG,
                  BsdfSample(pdir, ppdf, p_w, one, false,
                             (ppdf > EPS) & (pdir.z > 0)), out)

    if _want(present, BsdfKind.CONDUCTOR):
        f_smooth = _conductor_fresnel(mat.extra, mat.extra2,
                                      torch.clamp(cos_o, min=0.0))
        cond_s = BsdfSample(refl_smooth, one, mat.base.cmul(f_smooth), one,
                            true, cos_o > 0)
        if _want_rough(present, BsdfKind.CONDUCTOR):
            au = torch.clamp(mat.p2, min=1e-5)
            av = torch.clamp(mat.p3, min=1e-5)
            pdf_r = mf.pdf_vndf_ggx(wo, h_l, au, av) * torch.abs(
                mf.reflective_jacobian(dot(h_l, wo)))
            w_r = _conductor_rough_eval(mat, refl_r, wo) \
                * safe_div(1.0, pdf_r)
            cond_ro = BsdfSample(refl_r, pdf_r, w_r, one, false,
                                 (pdf_r > 1e-7) & (refl_r.z > 0)
                                 & (cos_o > 0))
            cond_s = _sel_sample(mat.p2 > DELTA_ALPHA, cond_ro, cond_s)
        out = sel(BsdfKind.CONDUCTOR, cond_s, out)

    if _want(present, BsdfKind.DIELECTRIC):
        k_ratio = _eta_ratio(mat, is_entering)
        fsm = fr.fresnel_dielectric(k_ratio, torch.clamp(cos_o, min=0.0))
        refr_sm = Vec3(-wo.x * k_ratio, -wo.y * k_ratio,
                       k_ratio * cos_o - fsm.cos_t - k_ratio * wo.z)
        choose_refl = u0 <= fsm.factor
        d_dir = vselect(choose_refl, refl_smooth, refr_sm)
        d_w = cselect(choose_refl, mat.base, mat.extra)
        d_eta = torch.where(choose_refl, one, k_ratio)
        refracted = ~choose_refl
        thin = None
        if _want_thin(present):
            thin = mat.p3 > 0.5
            kt_ratio = mat.p0 / torch.clamp(mat.p1, min=1e-6)
            ft = fr.fresnel_dielectric(kt_ratio, torch.abs(cos_o)).factor
            ft = ft + (1.0 - ft) * ft / (ft + 1.0)
            thin_refl = u0 <= ft
            d_dir = vselect(thin, vselect(thin_refl, refl_smooth, -wo),
                            d_dir)
            d_w = cselect(thin, cselect(thin_refl, mat.base, mat.extra), d_w)
            d_eta = torch.where(thin, one, d_eta)
            refracted = refracted & ~thin
        if not adjoint:
            # radiance-mode refraction carries the (eta_i/eta_t)^2
            # compression (PBRT convention; closed glass cancels it on exit)
            d_w = d_w * torch.where(refracted, k_ratio * k_ratio, 1.0)
        diel_s = BsdfSample(d_dir, one, d_w, d_eta, true, true)

        if _want_rough(present, BsdfKind.DIELECTRIC):
            cos_h_o = dot(h_l, wo)
            frough = fr.fresnel_dielectric(k_ratio, torch.abs(cos_h_o))
            refl_h = reflect(wo, h_l)
            s = k_ratio * cos_h_o - frough.cos_t
            refr_h = normalize(Vec3(h_l.x * s - wo.x * k_ratio,
                                    h_l.y * s - wo.y * k_ratio,
                                    h_l.z * s - wo.z * k_ratio))
            dr_refl = u0 <= frough.factor
            dr_dir = vselect(dr_refl, refl_h, refr_h)
            alpha = torch.clamp(mat.p2, min=1e-5)
            mpdf = mf.pdf_vndf_ggx(wo, h_l, alpha, alpha)
            jac_refl = torch.abs(mf.reflective_jacobian(cos_h_o))
            jac_refr = torch.abs(mf.refractive_jacobian(
                k_ratio, dot(h_l, dr_dir), cos_h_o))
            f_pdf = mpdf * torch.where(dr_refl, frough.factor * jac_refl,
                                       (1.0 - frough.factor) * jac_refr)
            dr_w = _dielectric_rough_eval(mat, is_entering, dr_dir, wo) \
                * safe_div(1.0, f_pdf)
            dr_is_trans = (dr_dir.z * cos_o) < 0.0
            if adjoint:
                # eval carries the radiance-mode eta^2; divide it back out
                dr_w = dr_w * torch.where(
                    dr_is_trans, safe_div(1.0, k_ratio * k_ratio), 1.0)
            dr_eta = torch.where(dr_is_trans, k_ratio, one)
            # reject side-switching samples: pdf and eval would disagree
            diel_ro = BsdfSample(dr_dir, f_pdf, dr_w, dr_eta, false,
                                 (f_pdf > 1e-7) & (torch.abs(cos_h_o) > EPS)
                                 & (dr_refl != dr_is_trans))
            rough = mat.p2 > DELTA_ALPHA
            if thin is not None:
                rough = rough & ~thin
            diel_s = _sel_sample(rough, diel_ro, diel_s)
        out = sel(BsdfKind.DIELECTRIC, diel_s, out)

    if _want(present, BsdfKind.PASSTHROUGH):
        # base tints the delta transmission ("transparent"); plain
        # passthrough keeps base = 1
        out = sel(BsdfKind.PASSTHROUGH,
                  BsdfSample(-wo, one, mat.base, one, true, true), out)

    if _want(present, BsdfKind.PLASTIC):
        fo, scatter = _plastic_parts(mat, cdir, wo)
        pl_refl = u0 <= fo
        pl_rough = mat.p2 > DELTA_ALPHA
        pl_dir = vselect(pl_refl, vselect(pl_rough, refl_r, refl_smooth),
                         cdir)
        pl_pdf_d = (1.0 - fo) * cosine_hemisphere_pdf(
            torch.clamp(pl_dir.z, min=0.0))
        pl_pdf_s = torch.where(
            pl_rough, fo * _conductor_rough_pdf(mat._replace(p3=mat.p2),
                                                pl_dir, wo), fo)
        pl_pdf = torch.where(pl_rough, pl_pdf_d + pl_pdf_s,
                             torch.where(pl_refl, fo, pl_pdf_d))
        w_diff = mat.base * (scatter * torch.ones_like(fo))
        pl_w = cselect(pl_rough,
                       _plastic_eval(mat, pl_dir, wo) * safe_div(1.0, pl_pdf),
                       cselect(pl_refl, mat.extra, w_diff))
        out = sel(BsdfKind.PLASTIC,
                  BsdfSample(pl_dir, pl_pdf, pl_w, one, pl_refl & ~pl_rough,
                             (pl_pdf > 1e-7) | (pl_refl & ~pl_rough)), out)

    if _want(present, BsdfKind.PRINCIPLED):
        pr_wi, pr_pdf, pr_eta, pr_valid = principled.sample_principled(
            mat, is_entering, wo, u0, u1, u2)
        pr_w = principled.eval_principled(mat, is_entering, pr_wi, wo) \
            * safe_div(1.0, pr_pdf)
        out = sel(BsdfKind.PRINCIPLED,
                  BsdfSample(pr_wi, pr_pdf, pr_w, pr_eta, false, pr_valid),
                  out)

    if _want_rad(present):
        is_rad = (kinds == BsdfKind.RAD_BRTDF) | (kinds == BsdfKind.RAD_ROOS)
        out = _sel_sample(is_rad, _rad_sample(mat, is_entering, wo, u0,
                                              cdir, cpdf), out)

    if _want(present, BsdfKind.NULL_ERROR):
        out = sel(BsdfKind.NULL_ERROR,
                  BsdfSample(cdir, cpdf, Color(one, zero, one), one, false,
                             cpdf > 0), out)

    # measured kinds (ignis_tpu/models/bsdf.py:778-824): Klems and
    # TensorTree sample in world space, brought to local for the common
    # to_world below
    zero_t = (Vec3(zero, zero, one), zero, Color(zero, zero, zero), false)
    if measured and _want(present, BsdfKind.KLEMS):
        from . import klems as klemslib
        wdir, kpdf, kw, kvalid = _measured_dispatch(
            lambda kd, kf: klemslib.klems_sample(kd, mat.base, kf, out_dir,
                                                 u0, u1, u2),
            mat, frame, is_entering, measured, zero_t, klemslib.KlemsData)
        out = sel(BsdfKind.KLEMS, BsdfSample(frame.to_local(wdir), kpdf, kw,
                                             one, false, kvalid), out)
    if measured and _want(present, BsdfKind.TENSORTREE):
        from . import tensortree as ttlib
        wdir, tpdf, tw, tvalid, tpeak = _measured_dispatch(
            lambda kd, kf: ttlib.tt_sample(kd, mat.base, kf, out_dir,
                                           u0, u1, u2),
            mat, frame, is_entering, measured, zero_t + (false,),
            ttlib.TensorTreeData)
        # tpeak: the peak-extraction delta transmission
        out = sel(BsdfKind.TENSORTREE, BsdfSample(
            frame.to_local(wdir), tpdf, tw, one, tpeak, tvalid), out)
    if measured and _want(present, BsdfKind.DJMEASURED):
        from . import djmeasured as djlib
        dj_dir, dj_pdf, dj_w, dj_valid = _select_tables(
            mat, measured, djlib.DJData,
            lambda kd: djlib.dj_sample(kd, mat.base, wo, u0, u1, u2), zero_t)
        out = sel(BsdfKind.DJMEASURED, BsdfSample(dj_dir, dj_pdf, dj_w, one,
                                                  false, dj_valid), out)

    return out._replace(in_dir=frame.to_world(out.in_dir))


# ---------------------------------------------------------------------------
# Blend (mix / mask) wrapper: one-sample MIS mix of two material rows
# (reference bsdf/mix.art make_join_bsdf)
# ---------------------------------------------------------------------------

def _pair(x):
    """x twice along the lanes: a tensor, or a NamedTuple of them."""
    if isinstance(x, torch.Tensor):
        return torch.cat([x, x])
    return type(x)(*[_pair(c) for c in x])


def _halves(x):
    """The first and second half of the lanes of x (a tensor, or a
    NamedTuple of them), as views."""
    if isinstance(x, torch.Tensor):
        n = x.shape[0] // 2
        return x[:n], x[n:]
    parts = [_halves(c) for c in x]
    return (type(x)(*[p[0] for p in parts]),
            type(x)(*[p[1] for p in parts]))


class LaneShader:
    """Per-lane BSDF interface over (possibly blended) material rows.

    With `w` None, `rows` is the lane's own MatParams. Otherwise `w` is the
    lerp weight towards the second child, and `rows` holds both children
    of every lane stacked along the lanes (the first child's N lanes, then
    the second's), as a MatParams or, for a nested blend, a LaneShader over
    the 2N lanes: the two children are shaded in one masked dispatch, so a
    blend costs one more dispatch per level, not two."""

    def __init__(self, rows, w, frame: Frame, entering, present,
                 measured=()):
        self.rows = rows
        self.w = w
        self.frame = frame
        self.entering = entering
        self.present = present
        self.measured = measured
        if w is not None and not isinstance(rows, LaneShader):
            self.frame, self.entering = _pair(frame), _pair(entering)

    def _eval(self, in_dir, out_dir):
        if isinstance(self.rows, LaneShader):
            return self.rows.eval(in_dir, out_dir)
        return eval_bsdf(self.rows, self.frame, self.entering, in_dir,
                         out_dir, self.present, self.measured)

    def _pdf(self, in_dir, out_dir):
        if isinstance(self.rows, LaneShader):
            return self.rows.pdf(in_dir, out_dir)
        return pdf_bsdf(self.rows, self.frame, self.entering, in_dir,
                        out_dir, self.present, self.measured)

    def _sample(self, out_dir, u_pick, u0, u1, u2, adjoint):
        if isinstance(self.rows, LaneShader):
            return self.rows.sample(out_dir, u_pick, u0, u1, u2, adjoint)
        return sample_bsdf(self.rows, self.frame, self.entering, out_dir,
                           u0, u1, u2, self.present, adjoint, self.measured)

    def _delta(self):
        if isinstance(self.rows, LaneShader):
            return self.rows.is_all_delta()
        return is_all_delta(self.rows, self.present)

    def eval(self, in_dir: Vec3, out_dir: Vec3) -> Color:
        if self.w is None:
            return self._eval(in_dir, out_dir)
        a, b = _halves(self._eval(_pair(in_dir), _pair(out_dir)))
        return clerp(a, b, self.w)

    def pdf(self, in_dir: Vec3, out_dir: Vec3):
        if self.w is None:
            return self._pdf(in_dir, out_dir)
        a, b = _halves(self._pdf(_pair(in_dir), _pair(out_dir)))
        return a + (b - a) * self.w

    def is_all_delta(self):
        if self.w is None:
            return self._delta()
        a, b = _halves(self._delta())
        return torch.where(self.w >= 1.0, b,
                           torch.where(self.w <= 0.0, a, a & b))

    def map_lanes(self, fn) -> "LaneShader":
        """The shader over the lanes that `fn` makes of its [N] lane
        tensors (a slice, a repeat: photon mapping shades K photons a
        lane); the stacked children of a blend are mapped half by half."""
        def halves(t):
            m = t.shape[0] // 2
            return torch.cat([fn(t[:m]), fn(t[m:])])

        def tmap(f, x):
            if isinstance(x, torch.Tensor):
                return f(x)
            return type(x)(*[tmap(f, c) for c in x])

        new = object.__new__(LaneShader)
        new.present = self.present
        new.measured = self.measured
        new.w = None if self.w is None else fn(self.w)
        if self.w is not None and isinstance(self.rows, LaneShader):
            new.rows = self.rows.map_lanes(halves)
            new.frame, new.entering = tmap(fn, self.frame), fn(self.entering)
        elif self.w is not None:
            new.rows = tmap(halves, self.rows)
            new.frame = tmap(halves, self.frame)
            new.entering = halves(self.entering)
        else:
            new.rows = tmap(fn, self.rows)
            new.frame, new.entering = tmap(fn, self.frame), fn(self.entering)
        return new

    def sample(self, out_dir: Vec3, u_pick, u0, u1, u2,
               adjoint=False) -> BsdfSample:
        if self.w is None:
            return self._sample(out_dir, u_pick, u0, u1, u2, adjoint)
        w = self.w
        # stick-breaking: rescale the pick within the chosen branch, so a
        # nested blend child gets a fresh uniform for its own choice
        pick_b = u_pick < w
        u_next = torch.where(pick_b, safe_div(u_pick, w),
                             safe_div(u_pick - w, 1.0 - w))
        out2 = _pair(out_dir)
        sA, sB = _halves(self._sample(out2, *[_pair(u) for u in
                                              (u_next, u0, u1, u2)],
                                      adjoint))
        s = _sel_sample(pick_b, sB, sA)
        # pdf and eval of both children at the sampled direction
        in2 = _pair(s.in_dir)
        pdfA, pdfB = _halves(self._pdf(in2, out2))
        evalA, evalB = _halves(self._eval(in2, out2))
        # mix.art sample_mat: the chosen child contributes s.color * s.pdf
        c_first = s.weight * s.pdf
        p = torch.where(pick_b, pdfA + (s.pdf - pdfA) * w,
                        s.pdf + (pdfB - s.pdf) * w)
        c = cselect(pick_b, clerp(evalA, c_first, w), clerp(c_first, evalB, w))
        return BsdfSample(s.in_dir, p, c * safe_div(1.0, p), s.eta,
                          s.is_delta, s.valid & (p > 1e-9))


def blend_weight(mat: MatParams, override=None):
    """The blend weight towards the second child: the row's p0 (or the
    texture's `override`), binarised at p1 by the cutoff flag p2; 0 on
    rows that are no blend."""
    w = mat.p0 if override is None else override
    w = torch.where(mat.p2 > 0.5, torch.where(w >= mat.p1, 1.0, 0.0), w)
    return torch.where(mat.kind == BsdfKind.BLEND, torch.clamp(w, 0.0, 1.0),
                       0.0)


def make_lane_shader(gather_row, mid, base_mat: MatParams, frame: Frame,
                     entering, blend_depth: int, weight_override=None,
                     present=None, measured=()) -> LaneShader:
    """The lane shader, resolving `blend_depth` levels of blend children
    (the scene's nesting depth, at most BLEND_MAX_DEPTH; 0 = no blends).
    `gather_row(ids)` fetches the MatParams of material rows `ids`. The
    texture-driven weight override applies to the top level only;
    `measured` is SceneData.measured."""
    if blend_depth <= 0:
        return LaneShader(base_mat, None, frame, entering, present,
                          measured)

    def build(ids, mat, frame, entering, depth, override=None):
        # both children's rows in one gather: the first child's, then the
        # second's (a lane that is no blend holds its own row twice)
        is_blend = mat.kind == BsdfKind.BLEND
        kids = torch.cat([
            torch.where(is_blend, torch.round(q).to(ids.dtype), ids)
            for q in (mat.q0, mat.q1)])
        rows = gather_row(torch.clamp(kids, min=0))
        if depth > 1:
            rows = build(kids, rows, _pair(frame), _pair(entering),
                         depth - 1)
        return LaneShader(rows, blend_weight(mat, override), frame,
                          entering, present, measured)

    return build(mid, base_mat, frame, entering,
                 min(blend_depth, BLEND_MAX_DEPTH), weight_override)
