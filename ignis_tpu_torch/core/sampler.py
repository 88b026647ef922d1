"""Pixel samplers: uniform, correlated multi-jitter, Halton.

Port of ignis_tpu/core/sampler.py, on the uint32-in-int64 convention of
core/rng.py.
"""
from __future__ import annotations

import torch

from . import rng as rnglib
from .rng import MASK, as_u32, mul32


def _permute_u32(i, key):
    """Kensler-style stateless permutation hash on uint32."""
    i = as_u32(i) ^ as_u32(key)
    i = mul32(i, 0xe170893d)
    i = i ^ (i >> 16)
    i = mul32(i, 0x929eb3f9)
    return i ^ (i >> 16)


def _radical_inverse_2(i):
    i = as_u32(i)
    i = ((i & 0x55555555) << 1) | ((i & 0xAAAAAAAA) >> 1)
    i = ((i & 0x33333333) << 2) | ((i & 0xCCCCCCCC) >> 2)
    i = ((i & 0x0F0F0F0F) << 4) | ((i & 0xF0F0F0F0) >> 4)
    i = ((i & 0x00FF00FF) << 8) | ((i & 0xFF00FF00) >> 8)
    i = ((i << 16) | (i >> 16)) & MASK
    return i.to(torch.float32) * 2.3283064365386963e-10


def _radical_inverse_3(i):
    x = as_u32(i).to(torch.float32)
    inv = torch.zeros_like(x)
    f = torch.tensor(1.0 / 3.0, dtype=torch.float32, device=x.device)
    base_inv = f
    for _ in range(20):
        d = torch.remainder(x, 3.0)
        inv = inv + d * f
        x = torch.floor(x / 3.0)
        f = f * base_inv
    return inv


def sample_pixel_offsets(kind: str, rng_state, sample_index, x, y):
    """Returns (rng_state, (sx, sy)) jitter offsets in [0,1)^2."""
    if kind == "halton":
        idx = as_u32(sample_index)
        rot = rnglib.seed(0, 0, 0, x, y, 0x9e3779b9)
        _, (r0, r1) = rnglib.next_f32_n(rot, 2)
        sx = torch.remainder(_radical_inverse_2(idx) + r0, 1.0)
        sy = torch.remainder(_radical_inverse_3(idx) + r1, 1.0)
        return rng_state, (sx, sy)
    if kind == "mjitt":
        bx, by = 4, 4
        n = bx * by
        s = as_u32(sample_index) % n
        key = rnglib.seed(0, 0, 0, x, y, 0x51633e2d)
        sp = _permute_u32(s, key) % n
        cx = (sp % bx).to(torch.float32)
        cy = (sp // bx).to(torch.float32)
        rng_state, (jx, jy) = rnglib.next_f32_n(rng_state, 2)
        return rng_state, ((cx + jx) / bx, (cy + jy) / by)
    if kind != "uniform":
        raise ValueError(f"Unknown pixel sampler {kind}")
    rng_state, (sx, sy) = rnglib.next_f32_n(rng_state, 2)
    return rng_state, (sx, sy)
