"""Tests of ignis_tpu_torch that need a CUDA card. They run the checks of
chip_smoke.py, which is the one home of the on-card checks, at a test's
size: the hand-written kernels against their plain torch versions (t, prim,
u, v and any-hit, also on rays shaped like the main path's, K2 on S2's and
S4's exactly; the S4 render through K2 alone, S5's through K1 and K3;
S6's volpath with its crossing walk through K1 and K3, its sigma
gradient; K3's gather and scatter-add on random rows, on the main path's first
bounce, at S5's material fetch, on one row,
with NaN, -0.0 and inf cotangents, and on every launch of a recorded
geometry-gradient step; the MT replay, also with every ray on one
triangle), the
train step and geometry gradient with their launch counts, the slice
and its gradient on the card against the CPU, instanced renders against
flattened ones, every other technique on the card against the CPU, and
the scene-language slice (S9's launches and Dupuy-Jakob K3 gathers,
setParameter without a rebuild, skies, a PExpr medium and the bake on the
card against the CPU). They skip without a card. The file imports no JAX, so it runs on the
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


def test_k2_exact_on_main_path_sets(device):
    """K2 on chip_smoke's main-path ray sets of S2 and S4 (camera rays in
    pixel order, cosine secondary rays from their hits, shadow rays to
    the scene's point light) at 128x128, the soup packed once: prims equal
    on every lane, t, u, v bit for bit, any hit equal on every lane."""
    runtimes = {}
    for name, sc, light in (("S2", chip_smoke.S2_GRAFT_ENTRY,
                             chip_smoke.S2_LIGHT),
                            ("S4", chip_smoke.S4_GLASS_ICO2,
                             chip_smoke.S1_LIGHT)):
        runtimes[name] = (ignis_tpu_torch.loadFromString(
            json.dumps(_small(sc)), device=device), light)
    isect_cuda.reset_counts()
    out = chip_smoke.phase_k2_sets(device, runtimes, check_only=True)
    assert len(out) == 6 and all(r["max_abs_err"] == 0.0
                                 for r in out.values())
    # 6 checked launches and each scene's camera trace in main_path_sets
    assert isect_cuda.counts == {"launches": 8, "plain_calls": 6}


def test_s4_render_launches_k2_only(device):
    """S4 (322 triangles, no BVH) at 64x64, spi 2, through Runtime.step():
    K2 launched, K1 not, and no plain version called."""
    rt = ignis_tpu_torch.loadFromString(
        json.dumps(_small(chip_smoke.S4_GLASS_ICO2, size=64)),
        device=device, spi=2)
    assert rt.scene.bvh is None and rt.scene.tris.v0.x.numel() == 322
    chip_smoke.reset_all_counts()
    img = rt.step().framebuffer(normalized=True)
    launched = chip_smoke.launches()
    assert launched["K2"] > 0 and launched["K1"] == 0, launched
    assert chip_smoke.plain_calls() == 0
    assert bool(torch.isfinite(img).all()) and float(img.mean()) > 1e-3


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


def _s5(env_dir, size=64, env=(128, 64)):
    """chip_smoke's S5 with icospheres at subdivisions 1."""
    from ignis_tpu_torch.utils.envgen import ensure_substitute_env
    return chip_smoke.s5_scene(ensure_substitute_env(env_dir, *env),
                               subdivisions=1, size=size)


def _s6(build_dir, subdivisions=2, size=64):
    """chip_smoke's S6 with its ball at `subdivisions`."""
    return chip_smoke.s6_scene(build_dir, subdivisions=subdivisions,
                               size=size)


def test_slice_on_card_matches_cpu(device, tmp_path):
    """The analytic point-light oracle on the card, and S2, S4, S1 (at
    subdivisions 3), S5 (at subdivisions 1, a 256x128 env) and S6 (volpath,
    its ball at subdivisions 2, K2) on the card against the CPU at 64x64:
    >= 99% of pixels within rtol 1e-3 / atol 1e-4 and means within
    0.5%."""
    chip_smoke.phase_reference(device, _s5(tmp_path, env=(256, 128)),
                               _s6(tmp_path))


def test_k1_exact_on_s6_crossing_sets(device, tmp_path):
    """K1 on S6's secondary set and the two crossing sets of its
    transparent-shadow walk (chip_smoke.crossing_sets), the ball at
    subdivisions 5 (a BVH), at 128x128: t, u, v bit for bit where the
    prims agree, prim agreement > 0.995, no stack overflow."""
    rt = ignis_tpu_torch.loadFromString(json.dumps(_s6(tmp_path, 5, 128)),
                                        device=device)
    assert rt.scene.bvh is not None
    out, _ = chip_smoke.phase_k1_sets(device, {"S6": rt}, check_only=True,
                                      sets_of=chip_smoke.crossing_sets)
    assert len(out) == 3 and all(r["max_abs_err"] == 0.0
                                 for r in out.values())
    assert bvh_cuda.overflow_count(device) == 0


def test_s6_render_launches_k1_and_k3(device, tmp_path):
    """S6 (the ball at subdivisions 4, a BVH) at 64x64, spi 2, through
    Runtime.step(): volpath with the crossing walk launches K1 and K3's
    gather, not K2, no plain version; the image finite and not black."""
    rt = ignis_tpu_torch.loadFromString(json.dumps(_s6(tmp_path, 4)),
                                        device=device, spi=2)
    assert rt.scene.bvh is not None and rt.settings.transparent_shadows
    chip_smoke.reset_all_counts()
    img = rt.step().framebuffer(normalized=True)
    launched = chip_smoke.launches()
    assert launched["K1"] > 0 and launched["K3_gather_rows"] > 0, launched
    assert launched["K2"] == 0
    assert chip_smoke.plain_calls() == 0
    assert bool(torch.isfinite(img).all()) and float(img.mean()) > 1e-3


def test_sigma_gradient_step_and_card_against_cpu(device, tmp_path):
    """phase 7's sigma gradient step on S6 (the ball at subdivisions 4,
    64x64, spi 2): finite and nonzero on every entry, K1 and K3's scatter
    launched, no plain version; then the small S6's sigma gradient on the
    card within rtol 1e-3 of the CPU's."""
    rt = ignis_tpu_torch.loadFromString(json.dumps(_s6(tmp_path, 4)),
                                        device=device, spi=2)
    out = chip_smoke.phase_sigma(device, rt, _s6(tmp_path))
    assert len(out["grad"]) == 12


def test_s5_render_launches_k1_and_k3(device, tmp_path):
    """S5 (subdivisions 1, 724 triangles, a BVH) at 64x64, spi 2, through
    Runtime.step(): K1 and K3's gather launched, K2 not, no plain version
    called, the image finite and not black."""
    rt = ignis_tpu_torch.loadFromString(json.dumps(_s5(tmp_path)),
                                        device=device, spi=2)
    assert rt.scene.bvh is not None and rt.settings.has_blend
    chip_smoke.reset_all_counts()
    img = rt.step().framebuffer(normalized=True)
    launched = chip_smoke.launches()
    assert launched["K1"] > 0 and launched["K3_gather_rows"] > 0, launched
    assert launched["K2"] == 0
    assert chip_smoke.plain_calls() == 0
    assert bool(torch.isfinite(img).all()) and float(img.mean()) > 1e-3


def test_k3_on_s5_material_table(device, tmp_path):
    """K3 at the material fetch's shape (chip_smoke.k3_material_set): the
    material rows of S5's 262,144 camera hits at 512x512 in its [14, 32]
    material table, 30 columns. The gather bit for bit with tab[idx]; the
    scatter within 1e-6 + 1e-5 sum|terms| of index_add_ (the contention
    of 262,144 lanes on 14 rows reorders the sums)."""
    rt = ignis_tpu_torch.loadFromString(json.dumps(_s5(tmp_path, size=512)),
                                        device=device, spi=1)
    idx, tab, k, cot = chip_smoke.k3_material_set(rt, device)
    assert idx.numel() == 262144 and tuple(tab.shape) == (14, 32)
    assert k == 30
    gather.reset_counts()
    g_err, _ = chip_smoke.check_k3("S5 material table", idx, tab, k, cot)
    assert g_err == 0.0
    assert gather.gather_counts["launches"] == 1
    assert gather.scatter_counts["launches"] == 1


def test_k3_on_s6_medium_table(device, tmp_path):
    """K3 at the medium fetch's shape (chip_smoke.k3_medium_set): the media
    of S6's 262,144 camera hits at 512x512 (the ball at subdivisions 4) in
    its [2, 8] medium table, 7 columns, and phase 7's timing of it. The
    gather bit for bit with tab[idx]; the scatter within 1e-6 + 1e-5
    sum|terms| of index_add_ (262,144 lanes on 2 rows)."""
    rt = ignis_tpu_torch.loadFromString(
        json.dumps(_s6(tmp_path, 4, size=512)), device=device, spi=1)
    idx, tab, k, cot = chip_smoke.k3_medium_set(rt, device)
    assert idx.numel() == 262144 and tuple(tab.shape) == (2, 8) and k == 7
    assert 0 < int(idx.sum()) < idx.numel()     # both media are read
    gather.reset_counts()
    out = chip_smoke.phase_k3_table(device, "S6 medium table", idx, tab, k,
                                    cot)
    assert out["gather"]["max_abs_err"] == 0.0
    assert gather.gather_counts["launches"] > 0
    assert gather.scatter_counts["launches"] > 0


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


def test_train_and_geometry_steps_launch_kernels(device, tmp_path):
    """phase 7's train step on S1 (at subdivisions 3), S2, S3 (at 80x100),
    S4, S5 (at subdivisions 1) and S6 (its ball at subdivisions 4, a BVH)
    at 64x64, spi 2, S5's roughness gradient
    and the geometry gradient on S1 and S2: loss and gradients finite,
    every kernel of the path launched, no plain version called."""
    s3 = json.loads(json.dumps(chip_smoke.S3_BENCH_BIG))
    s3["shapes"][0].update(stacks=80, slices=100)
    scenes = {"S1_glass_ico7": chip_smoke._ico3(chip_smoke.S1_GLASS_ICO7),
              "S2_graft_entry": chip_smoke.S2_GRAFT_ENTRY,
              "S3_bench_big": s3,
              "S4_glass_ico2": chip_smoke.S4_GLASS_ICO2,
              chip_smoke.S5_NAME: _s5(tmp_path),
              chip_smoke.S6_NAME: _s6(tmp_path, 4)}
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


@pytest.mark.parametrize("subdivisions", [4, 2])
def test_instanced_matches_flattened_on_card(device, subdivisions):
    """phase 8's check at 128x128: _grid_scene(8) instanced (the local soup
    through K1 at subdivisions 4, through K2 at 2) against flattened, the
    99th percentile of the relative difference under 0.05 and means within
    1%."""
    out = chip_smoke.instanced_against_flattened(subdivisions, size=128)
    assert out["q99"] < 0.05 and out["mean_rel"] < 0.01


@pytest.mark.parametrize("name", chip_smoke.REFERENCE_CASES)
def test_technique_on_card_matches_cpu(device, name, tmp_path):
    """Each technique and the instanced render on the card against the
    CPU at 64x64 (chip_smoke.technique_card_vs_cpu's bars: 99% of pixels
    close, means within 1e-4 relative, 1e-3 for lt and aept)."""
    from ignis_tpu_torch.utils.envgen import ensure_substitute_env
    out = chip_smoke.technique_card_vs_cpu(
        device, name, ensure_substitute_env(tmp_path, 256, 128))
    assert out["pixels_close"] >= 0.99


def test_s9_render_launches_k1_and_k3_and_dj_gathers(device, tmp_path):
    """Phase 9 at 64x64, spi 2, with S9's balls at subdivisions 3 (5,122
    triangles, a BVH): a step through K1 and K3 alone, and the Dupuy-Jakob
    K3 gathers of a step equal to their plain version."""
    rt = ignis_tpu_torch.loadFromString(json.dumps(chip_smoke.s9_scene(
        tmp_path, subdivisions=3, size=64)), device=device, spi=2)
    assert rt.scene.bvh is not None and len(rt.scene.measured) == 3
    rt.step()
    chip_smoke.reset_all_counts()
    rt.step()
    launched = chip_smoke.launches()
    assert launched["K1"] > 0 and launched["K3_gather_rows"] > 0
    assert launched["K2"] == 0 and chip_smoke.plain_calls() == 0
    out = chip_smoke.phase_dj_k3(chip_smoke.record_dj_gathers(rt))
    assert out["launches"] > 0 and out["max_abs_err"] == 0


def test_s9_set_parameter_without_rebuild(device, tmp_path):
    """phase 9's setParameter('tint') check at 64x64: pack_nodes and
    render_tables calls unchanged, no rebuild, the registry's tensor
    updated in place; tests/test_runtime_api.py's 4x ratio on the card."""
    rt = ignis_tpu_torch.loadFromString(json.dumps(chip_smoke.s9_scene(
        tmp_path, subdivisions=3, size=64)), device=device, spi=2)
    rt.step()
    out = chip_smoke.phase_tint(device, rt)
    assert abs(out["runtime_api_ratio"] - 4.0) < 0.01


@pytest.mark.parametrize("which", ["s9_small", "cie_clear", "sky",
                                   "pexpr_fog"])
def test_scene_language_on_card_matches_cpu(device, which, tmp_path):
    """phase 9's card-vs-CPU checks at 64x64 (phase 6's bar): S9 at
    subdivisions 1 (K2), S9 small under a CIE sky and the Hosek sky, and
    VOL_SCENE's fog with a PExpr sigma_s."""
    small = chip_smoke.s9_scene(tmp_path, subdivisions=1, size=64)
    if which in ("cie_clear", "sky"):
        small = {**small, "lights": [{"type": which, "name": "sky",
                                      "direction": chip_smoke.S9_SUN}]}
    if which == "pexpr_fog":
        small = json.loads(json.dumps(chip_smoke.S1_GLASS_ICO7))
        small["film"] = {"size": [64, 64]}
        small["technique"] = {"type": "volpath", "max_depth": 8}
        small["shapes"][1]["subdivisions"] = 3
        small["media"] = [{"type": "homogeneous", "name": "fog",
                           "sigma_a": [0.1, 0.1, 0.1],
                           "sigma_s": chip_smoke.S9_FOG_SIGMA_S, "g": 0.2}]
        small["entities"][1]["inner_medium"] = "fog"
    close, rel = chip_smoke.card_vs_cpu(device, which, small)
    assert close >= 0.99 and rel <= 0.005


def test_bake_on_card_matches_cpu(device):
    from ignis_tpu_torch.render.bake import bake_texture2d
    params = {"tint": ("num", 0.6)}
    a = bake_texture2d(chip_smoke.S9_FLOOR, 64, 32, parameters=params,
                       device=device)
    b = bake_texture2d(chip_smoke.S9_FLOOR, 64, 32, parameters=params,
                       device="cpu")
    np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
