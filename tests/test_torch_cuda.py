"""Tests of ignis_tpu_torch that need a CUDA card. They run the checks of
chip_smoke.py, which is the one home of the on-card checks, at a test's
size: the hand-written kernels against their plain torch versions (t, prim,
u, v and any-hit, also on rays shaped like the main path's; K3's gather and
scatter-add on random rows, on the main path's first bounce, on one row,
with NaN, -0.0 and inf cotangents, and on every launch of a recorded
geometry-gradient step; the MT replay, also with every ray on one
triangle), the
train step and geometry gradient with their launch counts, and the slice
and its gradient on the card against the CPU.
They skip without a card. The file imports no JAX, so it runs on the
card's machine: `python -m pytest tests/test_torch_cuda.py -m cuda`."""
import json

import numpy as np
import pytest
import torch

import chip_smoke
import ignis_tpu_torch
from ignis_tpu_torch.ops import bvh_cuda, gather, isect_cuda

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


def _small(scene, size=128, **shape):
    s = json.loads(json.dumps(scene))
    s["film"] = {"size": [size, size]}
    for k, v in shape.items():
        s["shapes"][-1][k] = v
    return s


def test_k1_exact_on_main_path_sets(device):
    """K1 on chip_smoke's main-path ray sets (camera rays in pixel order,
    cosine secondary rays from their hits, shadow rays to S1's light) of
    S1 (icosphere at subdivisions 5) and S3 (uvsphere 80x100) at 128x128:
    t, u, v bit for bit where the prims agree, prim agreement > 0.995,
    any-hit agreement >= 0.995, and the stack overflow counter 0."""
    runtimes = {
        "S1": ignis_tpu_torch.loadFromString(json.dumps(_small(
            chip_smoke.S1_GLASS_ICO7, subdivisions=5)), device=device),
        "S3": ignis_tpu_torch.loadFromString(json.dumps(_small(
            chip_smoke.S3_BENCH_BIG, stacks=80, slices=100)),
            device=device)}
    bvh_cuda.reset_counts()
    out, deepest = chip_smoke.phase_k1_sets(device, runtimes,
                                            check_only=True)
    assert len(out) == 6 and all(r["max_abs_err"] == 0.0
                                 for r in out.values())
    assert bvh_cuda.overflow_count(device) == 0
    assert 0 < deepest <= 32
    assert bvh_cuda.counts["plain_calls"] == 6


def test_mt_replay_every_ray_on_one_triangle(device):
    """The MT replay with 262,144 rays aimed at one triangle and all of
    them replayed there, where every lane of every warp shares its
    winner: per-ray gradients bit for bit with mt_replay_bwd_plain, soup
    sums within 1e-6 + 1e-4 sum|terms|."""
    rng = np.random.default_rng(21)
    soup, _ = chip_smoke.random_soup(rng, 64, device)
    rays = chip_smoke.rays_at_triangle(rng, soup, 7, 262144, device)
    prim = torch.full_like(rays.tmin, 7, dtype=torch.int32)
    chip_smoke.compare_replay("MT replay, every ray on triangle 7", rays,
                              soup, prim, 5)


def test_slice_on_card_matches_cpu(device):
    """The analytic point-light oracle on the card, and S2 and S1 (at
    subdivisions 3) on the card against the CPU at 64x64: >= 99% of
    pixels within rtol 1e-3 / atol 1e-4 and means within 0.5%."""
    chip_smoke.phase_reference(device)


def test_grad_kernels_match_plain(device):
    """K3 gather (equal) and scatter-add, and the MT replay at K1's and
    K2's winners, against their plain versions at chip_smoke's bars, on
    the icosphere's attribute table."""
    rt = ignis_tpu_torch.loadFromString(json.dumps(ICO), device=device)
    rays = chip_smoke.random_rays(np.random.default_rng(3), 65536, device,
                                  extent=3.0)
    errs, _ = chip_smoke.phase_grad_kernels(device, rt, rays)
    assert errs["K3_gather_rows"] == 0.0


@pytest.mark.parametrize("which", ["random", "camera", "one row",
                                   "special"])
def test_k3_matches_plain_on_set(device, which):
    """K3 on chip_smoke.k3_sets of S1 (icosphere at subdivisions 5) at
    128x128: random rows; the main path's first bounce (camera hits of
    main_path_sets, a miss on row 0 with zero cotangents); every lane on
    one row; cotangents holding a NaN, a -0.0 and an inf. The gather equal
    to tab[idx]; the scatter within 1e-6 + 1e-5 sum|terms| of index_add_,
    NaN and inf in index_add_'s entries, padding columns zero."""
    rt = ignis_tpu_torch.loadFromString(json.dumps(_small(
        chip_smoke.S1_GLASS_ICO7, subdivisions=5)), device=device)
    idx, tab, k, cot = chip_smoke.k3_sets(rt, device, n=65536)[which]
    gather.reset_counts()
    g_err, _ = chip_smoke.check_k3(which, idx, tab, k, cot)
    assert g_err == 0.0
    assert gather.gather_counts["launches"] == 1
    assert gather.scatter_counts["launches"] == 1


def test_k3_on_recorded_geometry_launches(device):
    """Every K3 launch of one geometry-gradient step of S1 (subdivisions
    3) and S2 at 64x64, spi 2, recorded: gathers equal to their plain
    versions, scatters within the reorder bar, and timed."""
    runtimes = {}
    for name, sc in (("S1_glass_ico7",
                      chip_smoke._ico3(chip_smoke.S1_GLASS_ICO7)),
                     ("S2_graft_entry", chip_smoke.S2_GRAFT_ENTRY)):
        small = json.loads(json.dumps(sc))
        small["film"] = {"size": [64, 64]}
        runtimes[name] = ignis_tpu_torch.loadFromString(
            json.dumps(small), device=device, spi=2)
    out = chip_smoke.phase_k3_recorded(device, runtimes)
    for row in out.values():
        assert row["gather"]["launches"] > 0 and row["scatter"]["launches"] > 0
        assert row["gather"]["ms"] > 0 and row["scatter"]["ms"] > 0


def test_train_and_geometry_steps_launch_kernels(device):
    """phase 7's train step on S1 (at subdivisions 3), S2 and S3 (at
    80x100) at 64x64, spi 2, and the geometry gradient on S1 and S2: loss
    and gradients finite, every kernel of the path launched, no plain
    version called."""
    s3 = json.loads(json.dumps(chip_smoke.S3_BENCH_BIG))
    s3["shapes"][0].update(stacks=80, slices=100)
    scenes = {"S1_glass_ico7": chip_smoke._ico3(chip_smoke.S1_GLASS_ICO7),
              "S2_graft_entry": chip_smoke.S2_GRAFT_ENTRY,
              "S3_bench_big": s3}
    runtimes = {}
    for name, sc in scenes.items():
        small = json.loads(json.dumps(sc))
        small["film"] = {"size": [64, 64]}
        runtimes[name] = ignis_tpu_torch.loadFromString(
            json.dumps(small), device=device, spi=2)
    counts, _ = chip_smoke.phase_train(device, runtimes)
    assert all(n > 0 for n in counts.values()), counts


def test_gradient_on_card_matches_cpu(device):
    """small_scene(64)'s albedo gradient on the card within rtol 1e-3 of
    the CPU's."""
    chip_smoke.phase_grad_reference(device)
