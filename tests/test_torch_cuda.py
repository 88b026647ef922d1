"""Tests of ignis_tpu_torch that need a CUDA card. They run the checks of
chip_smoke.py, which is the one home of the on-card checks, at a test's
size: the hand-written kernels against their plain torch versions (t, prim,
u, v and any-hit), and the slice on the card against the slice on the CPU.
They skip without a card. The file imports no JAX, so it runs on the
card's machine: `python -m pytest tests/test_torch_cuda.py -m cuda`."""
import json

import pytest
import torch

import chip_smoke
import ignis_tpu_torch
from ignis_tpu_torch.ops import bvh_cuda, isect_cuda

pytestmark = pytest.mark.cuda

# tests/test_bvh.py:271-283 icosphere (20,480 triangles)
ICO = {"technique": {"type": "path"},
       "camera": {"type": "perspective", "fov": 60,
                  "transform": [1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, -4,
                                0, 0, 0, 1]},
       "film": {"size": [32, 32]},
       "bsdfs": [{"type": "diffuse", "name": "w"}],
       "shapes": [{"type": "icosphere", "name": "s", "radius": 1.2,
                   "subdivisions": 5}],
       "entities": [{"name": "s", "shape": "s", "bsdf": "w"}],
       "lights": [{"type": "env", "name": "e", "radiance": 1.0}]}


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run `python3 chip_smoke.py` there)")
    return torch.device("cuda")


@pytest.mark.parametrize("n_tris", [2, 256, 4096])
def test_k2_matches_plain(device, n_tris):
    """K2 against its plain version on a random soup with dead lanes and a
    shadow mask, at chip_smoke's bars (prim > 0.999, t, u, v where the
    prim agrees, any-hit >= 0.999)."""
    isect_cuda.reset_counts()
    chip_smoke.phase_k2(device, sizes=(n_tris,))
    assert isect_cuda.counts == {"launches": 2, "plain_calls": 2}


def test_k1_matches_plain(device):
    """K1 against the plain lockstep walk on the icosphere's BVH and
    against K2, at chip_smoke's bars (tests/test_bvh.py:298-305 plus prim,
    u and v); no stack push is dropped."""
    rt = ignis_tpu_torch.loadFromString(json.dumps(ICO), device=device)
    bvh_cuda.reset_counts()
    chip_smoke.phase_k1(device, rt, n_rays=65536)
    assert bvh_cuda.counts["launches"] == 4


def test_slice_on_card_matches_cpu(device):
    """The analytic point-light oracle on the card, and S2 and S1 (at
    subdivisions 3) on the card against the CPU at 64x64: >= 99% of
    pixels within rtol 1e-3 / atol 1e-4 and means within 0.5%."""
    chip_smoke.phase_reference(device)
