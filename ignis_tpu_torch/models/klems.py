"""Klems measured BSDF evaluation (port of ignis_tpu/models/klems.py, after
the reference's src/artic/bsdf/klems.art).

The model is four patch-to-patch scattering matrices (front/back x
reflection/transmission) over the Klems hemisphere bases. Directions map
to basis entries by a theta-ring search and phi arithmetic; eval is one
matrix element a lane, read by plain tensor indexing: the matrices are
constant tables that take no gradient.

Sampling importance-samples the scattering matrices, as the JAX package
does: the patch of the unknown direction from the solid-angle-weighted
CDF of the matrix slice fixed by the known direction (KlemsLoader.h
buildCDF_Rowwise / Colwise), then a uniform solid-angle point inside the
patch; pdf(dir) = pick_prob * M[r, c] / sum_slice.

The model works in the Radiance-style frame of the unflipped surface
normal and the row's "up" vector (klems.art:207), with normalized tangent
axes.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.vec import Color, Vec3, cross, dot, normalize, safe_div, vselect
from ..core.warp import TWO_PI, spherical_from_dir


class KlemsBasisData(NamedTuple):
    lower: torch.Tensor       # [T]
    upper: torch.Tensor       # [T]
    phi_count: torch.Tensor   # [T] f32
    lin_off: torch.Tensor     # [T] f32
    entry_ring: torch.Tensor  # [E] int32: the theta ring of each entry


class KlemsComponentData(NamedTuple):
    row: KlemsBasisData
    col: KlemsBasisData
    matrix: torch.Tensor      # [R, C]
    total: torch.Tensor       # 0-d
    cdf_rows: torch.Tensor    # [C, R] cumulative over rows r for fixed col
    sum_rows: torch.Tensor    # [C] slice magnitudes (0 = empty slice)
    cdf_cols: torch.Tensor    # [R, C] cumulative over cols c for fixed row
    sum_cols: torch.Tensor    # [R]


class KlemsData(NamedTuple):
    front_reflection: KlemsComponentData
    back_reflection: KlemsComponentData
    front_transmission: KlemsComponentData
    back_transmission: KlemsComponentData


def _t(a, device, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return t if dtype is None else t.to(dtype)


def _basis_np(b, device):
    ring = np.repeat(np.arange(len(b.phi_count), dtype=np.int32),
                     b.phi_count.astype(np.int64))
    return KlemsBasisData(_t(np.asarray(b.lower, np.float32), device),
                          _t(np.asarray(b.upper, np.float32), device),
                          _t(b.phi_count.astype(np.float32), device),
                          _t(b.lin_off.astype(np.float32), device),
                          _t(ring, device))


def _entry_solid_angles(b):
    sa_ring = ((np.cos(b.lower) - np.cos(b.upper)) * 2.0 * np.pi
               / np.maximum(b.phi_count.astype(np.float64), 1))
    ring = np.repeat(np.arange(len(b.phi_count)),
                     b.phi_count.astype(np.int64))
    return sa_ring[ring].astype(np.float32)


def from_numpy(k, device="cpu") -> KlemsData:
    """scene/klems.py KlemsNp -> tensors on `device`, with the patch-CDF
    tables (ignis_tpu/models/klems.py from_numpy)."""
    def comp(c):
        m = np.asarray(c.matrix, np.float64)
        sa_row = _entry_solid_angles(c.row)
        sa_col = _entry_solid_angles(c.col)
        # sample a row given a fixed column: weight by the row patch's
        # solid angle
        w_rows = m * sa_row[:, None]
        sum_rows = w_rows.sum(axis=0)
        cdf_rows = np.cumsum(w_rows, axis=0) / np.maximum(
            sum_rows[None, :], 1e-30)
        cdf_rows[-1, :] = 1.0
        # sample a column given a fixed row
        w_cols = m * sa_col[None, :]
        sum_cols = w_cols.sum(axis=1)
        cdf_cols = np.cumsum(w_cols, axis=1) / np.maximum(
            sum_cols[:, None], 1e-30)
        cdf_cols[:, -1] = 1.0
        return KlemsComponentData(
            _basis_np(c.row, device), _basis_np(c.col, device),
            _t(np.asarray(c.matrix, np.float32), device),
            torch.tensor(float(np.float32(c.total)), device=device),
            _t(cdf_rows.T.astype(np.float32), device),
            _t(sum_rows.astype(np.float32), device),
            _t(cdf_cols.astype(np.float32), device),
            _t(sum_cols.astype(np.float32), device))
    return KlemsData(comp(k.front_reflection), comp(k.back_reflection),
                     comp(k.front_transmission), comp(k.back_transmission))


def _basis_index(basis: KlemsBasisData, theta, phi):
    """k_index_of: the theta ring by a comparison count, phi by rounding."""
    t_idx = (basis.lower[None, :] < theta[:, None]).sum(dim=1) - 1
    t_idx = torch.clamp(t_idx, 0, basis.lower.shape[0] - 1)
    nphi = basis.phi_count[t_idx]
    p_idx = torch.clamp((phi * nphi / (2.0 * np.pi) + 0.5).to(torch.int64),
                        min=0)
    p_idx = torch.where(p_idx >= nphi.to(torch.int64), 0, p_idx)
    return basis.lin_off[t_idx].to(torch.int64) + p_idx


def _eval_component(comp: KlemsComponentData, in_dir: Vec3, out_dir: Vec3):
    ti, pi = spherical_from_dir(in_dir)
    to, po = spherical_from_dir(out_dir)
    ci = _basis_index(comp.col, ti, pi)
    ro = _basis_index(comp.row, to, po)
    return comp.matrix[ro, ci]


class KlemsFrame(NamedTuple):
    right: Vec3
    nup: Vec3
    n: Vec3

    def to_local(self, v: Vec3) -> Vec3:
        return Vec3(dot(self.right, v), dot(self.nup, v), dot(self.n, v))

    def to_world(self, v: Vec3) -> Vec3:
        return Vec3(self.right.x * v.x + self.nup.x * v.y + self.n.x * v.z,
                    self.right.y * v.x + self.nup.y * v.y + self.n.y * v.z,
                    self.right.z * v.x + self.nup.z * v.y + self.n.z * v.z)


def make_klems_frame(frame_n: Vec3, is_entering, up: Vec3) -> KlemsFrame:
    ent = torch.as_tensor(is_entering, device=frame_n.x.device).expand(
        frame_n.x.shape)
    n = vselect(ent, frame_n, -frame_n)
    right = cross(up, n)
    deg = (right.x * right.x + right.y * right.y
           + right.z * right.z) <= 1e-12
    one, zero = torch.ones_like(n.x), torch.zeros_like(n.x)
    # up parallel to n: the identity frame (tt_transform_matrix)
    right = vselect(deg, Vec3(one, zero, zero), normalize(right))
    nup = vselect(deg, Vec3(zero, one, zero), normalize(cross(n, right)))
    nn = vselect(deg, Vec3(zero, zero, one), n)
    return KlemsFrame(right, nup, nn)


def _k_fi(v: Vec3) -> Vec3:
    return Vec3(-v.x, -v.y, v.z)


def _k_bo(v: Vec3) -> Vec3:
    return Vec3(v.x, v.y, -v.z)


def _local_eval_factor(kd: KlemsData, wi: Vec3, wo: Vec3):
    """klems.art local_eval's quadrant dispatch: the scalar factor."""
    in_front = wi.z > 0
    out_front = wo.z > 0
    f_rr = _eval_component(kd.front_reflection, _k_fi(wo), wi)
    f_tt = _eval_component(kd.front_transmission, wi, -wo)
    f_bt = _eval_component(kd.back_transmission, -wi, wo)
    f_br = _eval_component(kd.back_reflection, -wo, _k_bo(wi))
    return torch.where(in_front, torch.where(out_front, f_rr, f_tt),
                       torch.where(out_front, f_bt, f_br))


def _refl_prob(kd: KlemsData, wo_z):
    fp = safe_div(kd.front_reflection.total,
                  kd.front_reflection.total + kd.back_transmission.total)
    bp = safe_div(kd.back_reflection.total,
                  kd.back_reflection.total + kd.front_transmission.total)
    return torch.where(wo_z > 0, fp, bp)


def klems_eval(kd: KlemsData, base_color: Color, kframe: KlemsFrame,
               in_dir: Vec3, out_dir: Vec3) -> Color:
    wi = kframe.to_local(in_dir)
    wo = kframe.to_local(out_dir)
    f = _local_eval_factor(kd, wi, wo) * torch.abs(wi.z)
    return Color(base_color.r * f, base_color.g * f, base_color.b * f)


def _slice_pick(cdf_table, fixed_idx, u):
    """An entry index from each lane's row of a per-slice CDF table."""
    e = (cdf_table[fixed_idx] < u[:, None]).sum(dim=1)
    return torch.clamp(e, 0, cdf_table.shape[1] - 1)


def _patch_dir(basis: KlemsBasisData, e, xi1, xi2) -> Vec3:
    """A uniform solid-angle point inside patch `e` (upper hemisphere);
    phi segments centred on p * 2pi / nphi, as _basis_index rounds."""
    t = basis.entry_ring[e].long()
    lo = basis.lower[t]
    up = basis.upper[t]
    nphi = basis.phi_count[t]
    off = basis.lin_off[t]
    p = e.to(torch.float32) - off
    phi = (p + xi1 - 0.5) * (TWO_PI / nphi)
    cz = torch.cos(up) + xi2 * (torch.cos(lo) - torch.cos(up))
    sz = torch.sqrt(torch.clamp(1.0 - cz * cz, min=0.0))
    return Vec3(sz * torch.cos(phi), sz * torch.sin(phi), cz)


def _dir_pdf(kd: KlemsData, wi: Vec3, wo: Vec3):
    """Solid-angle pdf of the patch-CDF sampler for wi given wo (both
    local): M[r, c] / sum_slice times the component's pick chance."""
    rp = _refl_prob(kd, wo.z)
    in_f = wi.z > 0
    out_f = wo.z > 0
    fr, bt = kd.front_reflection, kd.back_transmission
    br, ft = kd.back_reflection, kd.front_transmission
    # RR: sampled patch = row(wi), fixed col = k_fi(wo)
    ci = _basis_index(fr.col, *spherical_from_dir(_k_fi(wo)))
    r = _basis_index(fr.row, *spherical_from_dir(wi))
    p_rr = rp * safe_div(fr.matrix[r, ci], fr.sum_rows[ci])
    # BT (wo front, wi back): fixed row = wo, sampled col = -wi
    ro = _basis_index(bt.row, *spherical_from_dir(wo))
    c = _basis_index(bt.col, *spherical_from_dir(-wi))
    p_bt = (1.0 - rp) * safe_div(bt.matrix[ro, c], bt.sum_cols[ro])
    # BR (both back): fixed col = -wo, sampled row = k_bo(wi)
    ci2 = _basis_index(br.col, *spherical_from_dir(-wo))
    r2 = _basis_index(br.row, *spherical_from_dir(_k_bo(wi)))
    p_br = rp * safe_div(br.matrix[r2, ci2], br.sum_rows[ci2])
    # FT (wo back, wi front): fixed row = -wo, sampled col = wi
    ro2 = _basis_index(ft.row, *spherical_from_dir(-wo))
    c2 = _basis_index(ft.col, *spherical_from_dir(wi))
    p_ft = (1.0 - rp) * safe_div(ft.matrix[ro2, c2], ft.sum_cols[ro2])
    return torch.where(out_f, torch.where(in_f, p_rr, p_bt),
                       torch.where(in_f, p_ft, p_br))


def klems_pdf(kd: KlemsData, kframe: KlemsFrame, in_dir: Vec3,
              out_dir: Vec3):
    return _dir_pdf(kd, kframe.to_local(in_dir), kframe.to_local(out_dir))


def klems_sample(kd: KlemsData, base_color: Color, kframe: KlemsFrame,
                 out_dir: Vec3, u0, u1, u2):
    """(in_dir in world space, pdf, weight, valid): the component by the
    relative totals (klems.art get_refl_prob), u0 rescaled after that
    pick, then the patch from the slice CDF and a point in the patch."""
    wo = kframe.to_local(out_dir)
    rp = _refl_prob(kd, wo.z)
    pick_refl = (rp > 0) & (u0 < rp)
    upick = torch.clamp(torch.where(pick_refl, safe_div(u0, rp),
                                    safe_div(u0 - rp, 1.0 - rp)),
                        0.0, 1.0 - 1e-7)
    out_f = wo.z > 0
    fr, bt = kd.front_reflection, kd.back_transmission
    br, ft = kd.back_reflection, kd.front_transmission
    # RR (wo front, reflect): fixed col k_fi(wo), sampled row -> wi upper
    ci_rr = _basis_index(fr.col, *spherical_from_dir(_k_fi(wo)))
    d_rr = _patch_dir(fr.row, _slice_pick(fr.cdf_rows, ci_rr, upick),
                      u1, u2)
    # BT (wo front, transmit): fixed row wo, sampled col -> wi = -dir
    ro_bt = _basis_index(bt.row, *spherical_from_dir(wo))
    d_bt = _patch_dir(bt.col, _slice_pick(bt.cdf_cols, ro_bt, upick),
                      u1, u2)
    # BR (wo back, reflect): fixed col -wo, sampled row -> wi = k_bo(dir)
    ci_br = _basis_index(br.col, *spherical_from_dir(-wo))
    d_br = _patch_dir(br.row, _slice_pick(br.cdf_rows, ci_br, upick),
                      u1, u2)
    # FT (wo back, transmit): fixed row -wo, sampled col -> wi = dir
    ro_ft = _basis_index(ft.row, *spherical_from_dir(-wo))
    d_ft = _patch_dir(ft.col, _slice_pick(ft.cdf_cols, ro_ft, upick),
                      u1, u2)
    wi = vselect(out_f, vselect(pick_refl, d_rr, -d_bt),
                 vselect(pick_refl, _k_bo(d_br), d_ft))
    pdf = _dir_pdf(kd, wi, wo)
    f = _local_eval_factor(kd, wi, wo) * torch.abs(wi.z)
    w = safe_div(f, pdf)
    weight = Color(base_color.r * w, base_color.g * w, base_color.b * w)
    return kframe.to_world(wi), pdf, weight, pdf > 1e-9
