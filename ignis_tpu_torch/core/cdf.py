"""1D / 2D discrete CDFs: construction, sampling and pdf (port of
ignis_tpu/core/cdf.py) for environment-map importance sampling.

A 1D CDF over n bins holds inclusive prefix sums, cdf[n-1] == 1. Three 2D
tables, as the reference's env "cdf" methods: the row-marginal plus
per-row conditional CDF (CDF2D), the summed-area table (SAT2D) and the
mip pyramid (Hier2D). Construction runs once on the host in numpy;
sampling and pdf run per lane on tensors.

Every per-lane search is a fixed number of gathers, so no lane count or
host sync is needed and nothing of size [lanes, width] is made: the
conditional row's column search is a binary search over the flattened
table with the JAX package's count-of-strictly-less semantics, the SAT
bisection and the pyramid descent run a number of steps known from the
table's shape.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch


def _f32(a, device):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)


def build_cdf_1d_np(weights) -> np.ndarray:
    """Inclusive prefix sums of rows of `weights` normalised to end at 1
    (float32 accumulation, as jnp.cumsum); all-zero rows become uniform."""
    w = np.asarray(weights, np.float32)
    c = np.cumsum(w, axis=-1, dtype=np.float32)
    total = c[..., -1:]
    n = w.shape[-1]
    uniform = np.broadcast_to(np.arange(1, n + 1, dtype=np.float32) / n,
                              c.shape)
    with np.errstate(invalid="ignore", divide="ignore"):
        return np.where(total > 0, c / np.where(total > 0, total, 1.0),
                        uniform).astype(np.float32)


def _count_less(flat, base, n: int, u):
    """Per lane, the number of entries < u among flat[base : base + n]
    (a sorted row): a branchless binary search of bit_length(n) steps."""
    pos = torch.zeros_like(base)
    step = 1 << (n.bit_length() - 1)
    while step:
        cand = pos + step
        ok = cand <= n
        val = flat[base + torch.clamp(cand, max=n) - 1]
        pos = torch.where(ok & (val < u), cand, pos)
        step >>= 1
    return pos


class CDF2D(NamedTuple):
    """Row marginal [h] and per-row conditionals [h, w]; the pdf is with
    respect to the unit square."""
    marginal: torch.Tensor
    conditional: torch.Tensor


def build_cdf_2d(weights, device="cpu") -> CDF2D:
    w = np.asarray(weights, np.float32)
    return CDF2D(_f32(build_cdf_1d_np(w.sum(axis=-1, dtype=np.float32)),
                      device),
                 _f32(build_cdf_1d_np(w), device))


def _entry(flat, i):
    """flat[i], 0 where i < 0."""
    return torch.where(i >= 0, flat[torch.clamp(i, min=0)], 0.0)


def sample_cdf_2d(c: CDF2D, u, v):
    """Continuous 2D sample: (x, y, unit-square pdf)."""
    h, w = c.conditional.shape
    ri = torch.clamp(torch.searchsorted(c.marginal, v, right=True), 0, h - 1)
    rlo = _entry(c.marginal, ri - 1)
    rp = c.marginal[ri] - rlo
    rrem = torch.where(rp > 0, (v - rlo) / torch.where(rp > 0, rp, 1.0), 0.0)
    flat = c.conditional.reshape(-1)
    base = ri * w
    ci = torch.clamp(_count_less(flat, base, w, u), 0, w - 1)
    clo = torch.where(ci > 0, flat[base + torch.clamp(ci - 1, min=0)], 0.0)
    cp = flat[base + ci] - clo
    crem = torch.where(cp > 0, (u - clo) / torch.where(cp > 0, cp, 1.0), 0.0)
    x = (ci.to(torch.float32) + torch.clamp(crem, 0.0, 1.0)) / w
    y = (ri.to(torch.float32) + torch.clamp(rrem, 0.0, 1.0)) / h
    return x, y, (rp * h) * (cp * w)


def pdf_cdf_2d(c: CDF2D, x, y):
    """Unit-square pdf at the continuous position (x, y)."""
    h, w = c.conditional.shape
    ri = torch.clamp((y * h).to(torch.int64), 0, h - 1)
    ci = torch.clamp((x * w).to(torch.int64), 0, w - 1)
    rp = c.marginal[ri] - _entry(c.marginal, ri - 1)
    flat = c.conditional.reshape(-1)
    base = ri * w
    cp = flat[base + ci] - torch.where(
        ci > 0, flat[base + torch.clamp(ci - 1, min=0)], 0.0)
    return (rp * h) * (cp * w)


# ---------------------------------------------------------------------------
# Summed-area-table 2D CDF (reference core/cdf.art make_cdf_2d_sat)
# ---------------------------------------------------------------------------

class SAT2D(NamedTuple):
    table: torch.Tensor  # [h+1, w+1] exclusive 2D prefix sums, [-1,-1] = 1
    grid: torch.Tensor   # [h, w] unit-square density


def build_sat_2d_np(weights):
    w = np.maximum(np.asarray(weights, np.float64), 0.0)
    total = w.sum()
    if total <= 0:
        w = np.ones_like(w)
        total = w.sum()
    p = w / total
    h, n = p.shape
    table = np.zeros((h + 1, n + 1), np.float64)
    table[1:, 1:] = p.cumsum(axis=0).cumsum(axis=1)
    table[-1, -1] = 1.0
    return table.astype(np.float32), (p * (h * n)).astype(np.float32)


def build_sat_2d(weights, device="cpu") -> SAT2D:
    table, grid = build_sat_2d_np(weights)
    return SAT2D(_f32(table, device), _f32(grid, device))


def _bisect_boundaries(cdf_at, u, n: int):
    """Invert a piecewise-linear CDF whose values at the n+1 texel
    boundaries are cdf_at(i), bisecting on integer boundaries so the
    bracket lands on one texel: (position in [0, 1], texel index)."""
    lo = torch.zeros_like(u, dtype=torch.int64)
    hi = torch.full_like(lo, n)
    for _ in range(int(math.ceil(math.log2(max(n, 2))))):
        mid = (lo + hi) // 2
        go_hi = cdf_at(mid) > u
        hi = torch.where(go_hi, mid, hi)
        lo = torch.where(go_hi, lo, mid)
    lo = torch.clamp(lo, max=n - 1)
    flo = cdf_at(lo)
    d = cdf_at(lo + 1) - flo
    t = torch.where(d > 1e-12, (u - flo) / torch.where(d > 1e-12, d, 1.0),
                    0.5)
    return (lo.to(torch.float32) + torch.clamp(t, 0.0, 1.0)) / n, lo


def sample_sat_2d(s: SAT2D, u, v):
    """Continuous 2D sample from the SAT (cdf.art sample_continuous)."""
    h, w = s.grid.shape
    flat = s.table.reshape(-1)
    stride = w + 1
    x, ix = _bisect_boundaries(lambda i: flat[h * stride + i], u, w)
    strip = flat[h * stride + ix + 1] - flat[h * stride + ix]
    inv_strip = torch.where(strip > 1e-12,
                            1.0 / torch.where(strip > 1e-12, strip, 1.0), 0.0)
    y, iy = _bisect_boundaries(
        lambda j: (flat[j * stride + ix + 1] - flat[j * stride + ix])
        * inv_strip, v, h)
    return x, y, s.grid.reshape(-1)[iy * w + ix]


def pdf_sat_2d(s: SAT2D, x, y):
    h, w = s.grid.shape
    ix = torch.clamp((x * w).to(torch.int64), 0, w - 1)
    iy = torch.clamp((y * h).to(torch.int64), 0, h - 1)
    return s.grid.reshape(-1)[iy * w + ix]


# ---------------------------------------------------------------------------
# Hierarchical (mip-pyramid) 2D warp (reference core/cdf.art
# make_cdf_2d_hierachical); the descent remaps by each branch's actual
# probability, so sample and pdf agree
# ---------------------------------------------------------------------------

class Hier2D(NamedTuple):
    levels: tuple  # ([S, S], [S/2, S/2], ..., [2, 2]); level 0 has mean 1


def build_hier_2d_np(weights, max_size: int = 1024):
    w = np.maximum(np.asarray(weights, np.float64), 0.0)
    if w.sum() <= 0:
        w = np.ones_like(w)
    h, n = w.shape
    size = min(1 << int(math.ceil(math.log2(max(h, n, 2)))), max_size)
    # area-average resample onto the square power-of-two grid
    ys = (np.arange(size) + 0.5) / size * h
    xs = (np.arange(size) + 0.5) / size * n
    g = w[np.minimum(ys.astype(np.int64), h - 1)[:, None],
          np.minimum(xs.astype(np.int64), n - 1)[None, :]]
    if g.sum() <= 0:
        g = np.ones_like(g)
    g = g / g.mean()
    levels = [g]
    while levels[-1].shape[0] > 2:
        a = levels[-1]
        levels.append(a.reshape(a.shape[0] // 2, 2, a.shape[1] // 2, 2)
                      .sum(axis=(1, 3)))
    return tuple(lv.astype(np.float32) for lv in levels)


def build_hier_2d(weights, device="cpu", max_size: int = 1024) -> Hier2D:
    return Hier2D(tuple(_f32(lv, device)
                        for lv in build_hier_2d_np(weights, max_size)))


def sample_hier_2d(hz: Hier2D, u, v):
    """Top-down 2x2 descent: (x, y, unit-square pdf). Comparisons use the
    original uniforms against per-node interval bounds."""
    ix = torch.zeros_like(u, dtype=torch.int64)
    iy = torch.zeros_like(ix)
    ulo = torch.zeros_like(u)
    uw = torch.ones_like(u)
    vlo = torch.zeros_like(v)
    vw = torch.ones_like(v)
    for lv in reversed(hz.levels):
        s = lv.shape[1]
        flat = lv.reshape(-1)
        cx = 2 * ix
        cy = 2 * iy
        x00 = flat[cy * s + cx]
        x01 = flat[cy * s + cx + 1]
        x10 = flat[(cy + 1) * s + cx]
        x11 = flat[(cy + 1) * s + cx + 1]
        total = x00 + x01 + x10 + x11
        pl = torch.where(total > 0, (x00 + x10)
                         / torch.where(total > 0, total, 1.0), 0.5)
        thr = ulo + pl * uw
        go_l = u < thr
        ulo = torch.where(go_l, ulo, thr)
        uw = uw * torch.where(go_l, pl, 1.0 - pl)
        ix = torch.where(go_l, cx, cx + 1)
        colt = torch.where(go_l, x00 + x10, x01 + x11)
        topv = torch.where(go_l, x00, x01)
        pt = torch.where(colt > 0, topv / torch.where(colt > 0, colt, 1.0),
                         0.5)
        thr_v = vlo + pt * vw
        go_t = v < thr_v
        vlo = torch.where(go_t, vlo, thr_v)
        vw = vw * torch.where(go_t, pt, 1.0 - pt)
        iy = torch.where(go_t, cy, cy + 1)
    uu = torch.clamp((u - ulo) / torch.clamp(uw, min=1e-30), 0.0, 1.0 - 1e-7)
    vv = torch.clamp((v - vlo) / torch.clamp(vw, min=1e-30), 0.0, 1.0 - 1e-7)
    size = hz.levels[0].shape[0]
    x = (ix.to(torch.float32) + uu) / size
    y = (iy.to(torch.float32) + vv) / size
    return x, y, hz.levels[0].reshape(-1)[iy * size + ix]


def pdf_hier_2d(hz: Hier2D, x, y):
    size = hz.levels[0].shape[0]
    ix = torch.clamp((x * size).to(torch.int64), 0, size - 1)
    iy = torch.clamp((y * size).to(torch.int64), 0, size - 1)
    return hz.levels[0].reshape(-1)[iy * size + ix]
