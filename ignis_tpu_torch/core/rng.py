"""Counter-based per-ray RNG: FNV-hashed seed feeding PCG-RXS-M-XS-32.

Bit-exact port of ignis_tpu/core/rng.py. The JAX package computes on
uint32 with logical shifts and wrap-around multiplies; torch's int32 `>>`
is arithmetic and it has no full uint32 arithmetic, so states live in
int64 tensors holding values in [0, 2^32) and are masked with 0xFFFFFFFF
after every multiply and xor. Every product stays below 2^63: the PCG and
FNV multipliers are below 2^31, and `mul32` splits a full 32-bit
multiplier into 16-bit halves.

Streams are keyed by (sample, iteration, frame, x, y, seed), never by
lane, so lane order, tiling and compaction do not change which numbers a
path draws.
"""
from __future__ import annotations

import torch

MASK = 0xFFFFFFFF
_FNV_OFFSET = 0x811C9DC5
_FNV_PRIME = 0x01000193
_PCG_MULT = 747796405
_PCG_INC = 2891336453


def as_u32(v):
    """A python int or an integer tensor as uint32 values (int64 tensor)."""
    if isinstance(v, torch.Tensor):
        return v.to(torch.int64) & MASK
    return int(v) & MASK


def mul32(a, m: int):
    """(a * m) mod 2^32 for uint32 values `a` and a constant m < 2^32."""
    return (a * (m & 0xFFFF) + (((a * (m >> 16)) & 0xFFFF) << 16)) & MASK


def fnv_hash(h, x):
    """One FNV-1a round folding uint32 `x` into hash `h` byte by byte."""
    h = as_u32(h)
    x = as_u32(x)
    for shift in (0, 8, 16, 24):
        h = ((h ^ ((x >> shift) & 0xFF)) * _FNV_PRIME) & MASK
    return h


def seed(sample, iteration, frame, x, y, user_seed):
    """Per-ray stream seed (create_random_seed structure)."""
    h = _FNV_OFFSET
    for v in (user_seed, sample, iteration, frame, x, y):
        h = fnv_hash(h, v)
    return h


def _pcg_step(state):
    return (state * _PCG_MULT + _PCG_INC) & MASK


def _pcg_output(state):
    word = (((state >> ((state >> 28) + 4)) ^ state) * 277803737) & MASK
    return (word >> 22) ^ word


def next_u32(state):
    """Advance state; returns (new_state, uint32 draw)."""
    state = _pcg_step(state)
    return state, _pcg_output(state)


def next_f32(state):
    """Advance state; returns (new_state, float32 in [0, 1)).

    (bits >> 8) < 2^24 converts to float32 exactly, and the scale is a
    power of two, so the draw equals the JAX package's bit for bit."""
    state, bits = next_u32(state)
    return state, (bits >> 8).to(torch.float32) * (1.0 / 16777216.0)


def next_f32_n(state, n: int):
    """Draw n floats; returns (state, [f0, f1, ...])."""
    outs = []
    for _ in range(n):
        state, f = next_f32(state)
        outs.append(f)
    return state, outs
