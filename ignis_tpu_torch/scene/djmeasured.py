"""Dupuy-Jakob measured BRDF (.bsdf tensor file) loader + baker.

Parses the powitacq "tensor_file" container (reference:
src/runtime/measured/powitacq_rgb.inl:810) and bakes the NDF-parameterized
representation into per-theta_i-node dense tables:

  fr[t, H, W, 3]   BRDF value over the half-vector unit square u_wm
  g[t, H, W]       sampling density over u_wm (vndf x luminance product)
  marg/cond CDFs   for importance sampling u_wm directly

The reference inverts the VNDF warp per evaluation (Marginal2D::invert,
a data-dependent search). Baking moves that inversion to load time; at
shading time eval/pdf/sample are static gathers over lanes.
Isotropic files (phi_i count <= 2, the norm for the RGL database) bake a
single phi_i slice with phi-relative parameterization; anisotropic files
bake one slice per phi_i node with absolute phi (djmeasured.art:529 only
shifts u_wm.y by phi_i in the isotropic case).
"""
from __future__ import annotations

import struct
from typing import NamedTuple

import numpy as np

_DTYPES = {1: np.uint8, 2: np.int8, 3: np.uint16, 4: np.int16,
           5: np.uint32, 6: np.int32, 7: np.uint64, 8: np.int64,
           9: np.float16, 10: np.float32, 11: np.float64}


def read_tensor_file(path) -> dict:
    data = open(path, "rb").read()
    if data[:12] != b"tensor_file\x00":
        raise ValueError(f"{path}: not a tensor file")
    if data[12] != 1 or data[13] != 0:
        raise ValueError(f"{path}: unsupported tensor file version")
    (n_fields,) = struct.unpack_from("<I", data, 14)
    pos = 18
    fields = {}
    for _ in range(n_fields):
        (name_len,) = struct.unpack_from("<H", data, pos)
        pos += 2
        name = data[pos:pos + name_len].decode()
        pos += name_len
        ndim, dtype = struct.unpack_from("<HB", data, pos)
        pos += 3
        (offset,) = struct.unpack_from("<Q", data, pos)
        pos += 8
        shape = struct.unpack_from("<" + "Q" * ndim, data, pos)
        pos += 8 * ndim
        dt = _DTYPES[dtype]
        count = int(np.prod(shape)) if shape else 1
        arr = np.frombuffer(data, dt, count, int(offset)).reshape(shape)
        fields[name] = np.array(arr)
    return fields


def theta2u(theta):
    return np.sqrt(theta * (2.0 / np.pi))


def u2theta(u):
    return (u * u) * (np.pi / 2.0)


def phi2u(phi):
    return phi * (0.5 / np.pi) + 0.5


def u2phi(u):
    return (2.0 * u - 1.0) * np.pi


def _bilinear(grid: np.ndarray, x, y):
    """Sample grid[h, w] at continuous (x, y) in [0,1]^2 (vertex-aligned,
    matching powitacq Marginal2D's node interpolation)."""
    h, w = grid.shape[-2], grid.shape[-1]
    fx = np.clip(x, 0.0, 1.0) * (w - 1)
    fy = np.clip(y, 0.0, 1.0) * (h - 1)
    x0 = np.clip(fx.astype(np.int64), 0, w - 2)
    y0 = np.clip(fy.astype(np.int64), 0, h - 2)
    tx = fx - x0
    ty = fy - y0
    g = grid
    v00 = g[..., y0, x0]
    v10 = g[..., y0, x0 + 1]
    v01 = g[..., y0 + 1, x0]
    v11 = g[..., y0 + 1, x0 + 1]
    return ((v00 * (1 - tx) + v10 * tx) * (1 - ty)
            + (v01 * (1 - tx) + v11 * tx) * ty)


class _Marginal2D:
    """Piecewise-constant marginal/conditional warp over a density grid.

    Approximates powitacq's piecewise-bilinear Marginal2D on an upsampled
    grid: rows marginal over y, conditional over x. Provides forward
    (uniform -> position) and inverse maps, both vectorized."""

    def __init__(self, density: np.ndarray, upsample: int = 2):
        h, w = density.shape
        if upsample > 1:
            ys = (np.arange(h * upsample) + 0.5) / (h * upsample)
            xs = (np.arange(w * upsample) + 0.5) / (w * upsample)
            xx, yy = np.meshgrid(xs, ys)
            density = _bilinear(density, xx, yy)
        d = np.maximum(density.astype(np.float64), 0.0)
        total = d.sum()
        if total <= 0:
            d = np.ones_like(d)
            total = d.sum()
        self.p = d / total                      # cell probabilities
        self.h, self.w = d.shape
        self.row_sum = self.p.sum(axis=1)       # [h]
        self.marg_cdf = np.concatenate([[0.0], np.cumsum(self.row_sum)])
        cond = self.p / np.maximum(self.row_sum[:, None], 1e-300)
        self.cond_cdf = np.concatenate(
            [np.zeros((self.h, 1)), np.cumsum(cond, axis=1)], axis=1)

    def invert(self, ux, uy):
        """Position (ux, uy) -> uniform sample (sx, sy) and density."""
        iy = np.clip((uy * self.h).astype(np.int64), 0, self.h - 1)
        fy = uy * self.h - iy
        sy = self.marg_cdf[iy] + self.row_sum[iy] * fy
        ix = np.clip((ux * self.w).astype(np.int64), 0, self.w - 1)
        fx = ux * self.w - ix
        sx = self.cond_cdf[iy, ix] + (self.cond_cdf[iy, ix + 1]
                                      - self.cond_cdf[iy, ix]) * fx
        pdf = self.p[iy, ix] * self.h * self.w  # unit-square density
        return sx, sy, pdf

    def density(self, ux, uy):
        iy = np.clip((uy * self.h).astype(np.int64), 0, self.h - 1)
        ix = np.clip((ux * self.w).astype(np.int64), 0, self.w - 1)
        return self.p[iy, ix] * self.h * self.w


class DJMeasuredNp(NamedTuple):
    theta_nodes: np.ndarray  # [T]
    phi_nodes: np.ndarray    # [P] (P == 1: isotropic, phi-relative tables)
    fr: np.ndarray           # [P, T, H, W, 3]
    g: np.ndarray            # [P, T, H, W] sampling density over u_wm
    marg_cdf: np.ndarray     # [P, T, H] inclusive
    cond_cdf: np.ndarray     # [P, T, H, W] inclusive per-row


def load_djmeasured(path, res: int = 128) -> DJMeasuredNp:
    f = read_tensor_file(path)
    theta_i = f["theta_i"].astype(np.float64)
    phi_i = f["phi_i"].astype(np.float64)
    isotropic = phi_i.shape[0] <= 2
    ndf = f["ndf"].astype(np.float64)       # [hn, wn]
    sigma = f["sigma"].astype(np.float64)   # [hs, ws]
    vndf = f["vndf"].astype(np.float64)     # [P, T, hv, wv]
    lum = f["luminance"].astype(np.float64)  # [P, T, hl, wl]
    rgb = f["rgb"].astype(np.float64)       # [P, T, 3, hr, wr]

    T = theta_i.shape[0]
    P = 1 if isotropic else vndf.shape[0]
    H = W = res
    uxs = (np.arange(W) + 0.5) / W
    uys = (np.arange(H) + 0.5) / H
    uxx, uyy = np.meshgrid(uxs, uys)

    fr_t = np.zeros((P, T, H, W, 3), np.float32)
    g_t = np.zeros((P, T, H, W), np.float32)
    for pi in range(P):
        ph = 0.0 if isotropic else float(phi_i[pi])
        for t in range(T):
            th = float(theta_i[t])
            u_wi_x = theta2u(th)
            u_wi_y = phi2u(ph)
            sigma_i = max(float(_bilinear(sigma, np.float64(u_wi_x),
                                          np.float64(u_wi_y))), 1e-9)
            vw = _Marginal2D(vndf[pi, t])
            lw = _Marginal2D(lum[pi, t])
            sx, sy, vndf_pdf = vw.invert(uxx, uyy)
            ndf_v = _bilinear(ndf, uxx, uyy)
            for c in range(3):
                val = _bilinear(rgb[pi, t, c], sx, sy)
                fr_t[pi, t, ..., c] = np.maximum(val, 0.0) * ndf_v \
                    / (4.0 * sigma_i)
            g_t[pi, t] = vndf_pdf * lw.density(sx, sy)

    # inclusive CDFs over the baked sampling density
    gsum = g_t.astype(np.float64)
    row = np.cumsum(gsum, axis=3)
    row_tot = np.maximum(row[..., -1:], 1e-300)
    cond = (row / row_tot).astype(np.float32)
    cond[..., -1] = 1.0
    marg = np.cumsum(row_tot[..., 0], axis=2)
    marg_tot = np.maximum(marg[..., -1:], 1e-300)
    marg = (marg / marg_tot).astype(np.float32)
    marg[..., -1] = 1.0

    phi_nodes = (np.zeros(1) if isotropic else phi_i).astype(np.float32)
    return DJMeasuredNp(theta_i.astype(np.float32), phi_nodes,
                        fr_t, g_t, marg, cond)
