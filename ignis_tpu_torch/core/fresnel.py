"""Dielectric Fresnel term (port of ignis_tpu/core/fresnel.py).

Conventions: `k` is the ratio n1/n2 crossing the interface along the
incident direction; cos_i is the absolute cosine on the incident side.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class FresnelResult(NamedTuple):
    factor: torch.Tensor   # reflection probability (1 on TIR)
    cos_t: torch.Tensor    # transmitted cosine (0 on TIR)
    total: torch.Tensor    # bool: total internal reflection


def fresnel_dielectric(k, cos_i) -> FresnelResult:
    """Exact dielectric Fresnel; k = n1/n2, cos_i >= 0."""
    sin_t2 = k * k * (1.0 - cos_i * cos_i)
    total = sin_t2 > 1.0
    cos_t = torch.sqrt(torch.clamp(1.0 - sin_t2, min=0.0))
    r_par = (k * cos_i - cos_t) / torch.clamp(k * cos_i + cos_t, min=1e-20)
    r_per = (cos_i - k * cos_t) / torch.clamp(cos_i + k * cos_t, min=1e-20)
    f = 0.5 * (r_par * r_par + r_per * r_per)
    return FresnelResult(torch.where(total, 1.0, f),
                         torch.where(total, 0.0, cos_t), total)
