#!/usr/bin/env python3
"""Drive ignis_tpu_torch's main path once on one CUDA card and check it.

Run from the root of a checkout: `python3 chip_smoke.py`. Phases, each
printing its own lines; any failure exits non-zero:

1. device: the card's name and power limit (nvidia-smi);
2. build: K1 (csrc/bvh_walk.cu), K2 (csrc/isect_dense.cu), K3
   (csrc/gather_cols.cu), the MT replay (csrc/mt_replay_bwd.cu) and the
   native BVH builder, from the sources in the checkout, all at once;
3. K2 against its plain torch version on the card (random soups);
4. K1 against its plain version on S1's BVH, and against K2 brute force
   on a 20,480-triangle icosphere; kernel and plain times; then K1 on
   three 262,144-ray sets of S1 and S3 shaped like the main path's
   (camera rays in pixel order, cosine secondary rays from their hits,
   shadow rays from those hits to S1's point light): exact against the
   plain walk, timed beside its bound, the deepest stack counted;
5. render S1-S3 at 512x512 through `loadFromString` (its default device,
   the card) and `Runtime.step()`, with every kernel's launch count reset
   just before and read just after; no plain version may run; then one more
   step of each under torch.profiler (render/profile.py): device time,
   busy share and top device consumers of that step;
6. reference checks: the analytic point-light oracle on the card, and
   card-vs-CPU renders of small scenes;
7. gradients: K3's gather and scatter-add against their plain versions
   on S1's attribute table (random rows, S1's camera hits with zero
   cotangents on the misses, every lane on one row, cotangents holding
   NaN, -0.0 and inf) and the MT replay against its plain version, with
   times (K3 on the random rows, the replay on S1's contended rays and on
   a random soup); `train_step` (albedo) on S1-S3 at 512x512 and a
   geometry gradient on S1 and S2, counts reset before and read after;
   one profiled train step per scene and one profiled S1
   geometry-gradient step; every K3 launch of one S1 and one S2
   geometry-gradient step recorded, checked and timed beside
   index_select / index_add and its bound; the K3 scatter at the albedo
   backward's shape beside index_put_; the albedo gradient on the card
   against the CPU's;
then one JSON line of kernel results (each kernel's time beside its bound
and, where one PyTorch call computes the same function, that call's
time), the nvidia-smi line again, and as the last line
{"ok": true, "device": {...}}.
Imports nothing of JAX. `--profile-json PATH` also writes the renders'
timings and the profiled steps to PATH.
"""
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# S1: tests/test_compaction.py:17 SCENE, icosphere at subdivisions 7
# (327,682 triangles), film 512x512.
S1_GLASS_ICO7 = {
    "technique": {"type": "path", "max_depth": 8},
    "camera": {
        "type": "perspective", "fov": 60,
        "transform": [-1, 0, 0, 0, 0, 1, 0, 0, 0, 0, -1, 3.85, 0, 0, 0, 1],
    },
    "film": {"size": [512, 512]},
    "bsdfs": [
        {"type": "diffuse", "name": "white", "reflectance": [0.7, 0.7, 0.7]},
        {"type": "dielectric", "name": "glass", "int_ior": 1.55},
    ],
    "shapes": [
        {"type": "rectangle", "name": "floor", "width": 6, "height": 6},
        {"type": "icosphere", "name": "ball", "radius": 0.8,
         "subdivisions": 7},
    ],
    "entities": [
        {"name": "floor", "shape": "floor", "bsdf": "white",
         "transform": [{"rotate": [-90, 0, 0]}, {"translate": [0, -1, 0]}]},
        {"name": "ball", "shape": "ball", "bsdf": "glass"},
    ],
    "lights": [
        {"type": "point", "name": "l", "position": [2, 3, 2], "power": 60},
        {"type": "env", "name": "e", "radiance": [0.2, 0.25, 0.3]},
    ],
}

# S2: __graft_entry__.py:8 _SCENE (2 triangles + an analytic sphere),
# film 512x512.
S2_GRAFT_ENTRY = {
    "technique": {"type": "path", "max_depth": 6},
    "camera": {
        "type": "perspective", "fov": 60, "near_clip": 0.1, "far_clip": 100,
        "transform": [-1, 0, 0, 0, 0, 1, 0, 0, 0, 0, -1, 3.85, 0, 0, 0, 1],
    },
    "film": {"size": [512, 512]},
    "bsdfs": [
        {"type": "diffuse", "name": "white", "reflectance": [0.8, 0.8, 0.8]},
        {"type": "dielectric", "name": "glass", "int_ior": 1.55},
    ],
    "shapes": [
        {"type": "rectangle", "name": "floor", "width": 4, "height": 4},
        {"type": "sphere", "name": "ball", "radius": 0.5},
    ],
    "entities": [
        {"name": "floor", "shape": "floor", "bsdf": "white",
         "transform": [{"rotate": [-90, 0, 0]}, {"translate": [0, -1, 0]}]},
        {"name": "ball", "shape": "ball", "bsdf": "glass"},
    ],
    "lights": [
        {"type": "point", "name": "l", "position": [0, 2, 2], "power": 50},
        {"type": "env", "name": "e", "radiance": [0.1, 0.1, 0.2]},
    ],
}

# S3: bench.py:331 BIG_SCENE, uvsphere 400x500 (400,000 triangles).
S3_BENCH_BIG = {
    "technique": {"type": "path", "max_depth": 4},
    "camera": {"type": "perspective", "fov": 60,
               "transform": [1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, -4,
                             0, 0, 0, 1]},
    "film": {"size": [512, 512]},
    "bsdfs": [{"type": "diffuse", "name": "w"}],
    "shapes": [{"type": "uvsphere", "name": "s", "radius": 1.2,
                "stacks": 400, "slices": 500}],
    "entities": [{"name": "s", "shape": "s", "bsdf": "w"}],
    "lights": [{"type": "env", "name": "e", "radiance": 1.0}],
}

SCENES = (("S1_glass_ico7", S1_GLASS_ICO7, "K1"),
          ("S2_graft_entry", S2_GRAFT_ENTRY, "K2"),
          ("S3_bench_big", S3_BENCH_BIG, "K1"))
SPI = 4
S1_LIGHT = (2.0, 3.0, 2.0)   # S1's point light

# The least time of a kernel: the larger of its bytes (each input read once,
# each output written once) over the card's memory rate and its operations
# over the fp32 rate outside the tensor cores, both the H100 SXM's published
# peaks (NVIDIA's data sheet, dense rates).
H100_BYTES_PER_S = 3.35e12
H100_FP32_PER_S = 67e12
SLAB_OPS = 22    # one child's slab test: 6 subtractions, 6 products, 10 min/max
MT_OPS = 42      # one Moeller-Trumbore test, from the ray to t, u and v
REPLAY_OPS = 150  # one ray of the MT replay: forward and hand-written adjoint


def flat_scene(size=256):
    """tests/test_analytic.py:16 flat_scene: the canonical flat plane."""
    return {
        "technique": {"type": "path", "max_depth": 2},
        "camera": {"type": "perspective", "fov": 90, "near_clip": 0.01,
                   "far_clip": 100,
                   "transform": [1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, -1]},
        "film": {"size": [size, size]},
        "bsdfs": [{"type": "diffuse", "name": "ground",
                   "reflectance": [1, 1, 1]}],
        "shapes": [{"type": "rectangle", "name": "Bottom", "width": 2,
                    "height": 2, "flip_normals": True}],
        "entities": [{"name": "Bottom", "shape": "Bottom", "bsdf": "ground"}],
        "lights": [],
    }


class CheckFailed(Exception):
    pass


def check(cond, what):
    if not cond:
        raise CheckFailed(what)
    print(f"  ok: {what}")


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps=10, warmup=2):
    """Median of `reps` CUDA-event timings of fn() after warm-up, in ms.

    A spin kernel (`torch.cuda._sleep`) keeps the device busy while the
    host enqueues each timing's start event, fn()'s work and end event, so
    the events bracket device time rather than the host's launch overhead
    wherever fn() enqueues its work within the spin (~2 ms on an H100). A
    plain version that waits on the device inside fn() is timed with its
    host time, as it runs."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(4_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def random_soup(rng, n_tris, device):
    from ignis_tpu_torch.core.vec import Vec3
    from ignis_tpu_torch.ops.intersect import TriSoup
    import torch
    v0 = rng.uniform(-3, 3, (n_tris, 3)).astype(np.float32)
    e1 = rng.uniform(-0.6, 0.6, (n_tris, 3)).astype(np.float32)
    e2 = rng.uniform(-0.6, 0.6, (n_tris, 3)).astype(np.float32)

    def soa(a):
        return Vec3(*[torch.from_numpy(a[:, i].copy()).to(device)
                      for i in range(3)])
    vis = torch.from_numpy(rng.uniform(size=n_tris) < 0.7).to(device)
    return TriSoup(soa(v0), soa(e1), soa(e2)), vis


def random_rays(rng, n, device, extent=4.0, dead_frac=0.05):
    """Rays with random origins and directions; `dead_frac` of them dead
    (tmax < tmin)."""
    import torch
    from ignis_tpu_torch.core.vec import Vec3
    from ignis_tpu_torch.ops.intersect import Rays
    o = rng.uniform(-extent, extent, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = np.full(n, 1e30, np.float32)
    tmax[rng.uniform(size=n) < dead_frac] = -1.0

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return Rays(Vec3(*[t(o[:, i]) for i in range(3)]),
                Vec3(*[t(d[:, i]) for i in range(3)]),
                t(np.zeros(n, np.float32)), t(tmax))


def rays_at_triangle(rng, soup, k, n, device):
    """n rays from random origins to random points inside triangle k of
    `soup`, so that every ray's winner can be k."""
    import torch
    from ignis_tpu_torch.core.vec import Vec3
    from ignis_tpu_torch.ops.intersect import Rays
    tri = [np.array([float(c[k]) for c in v], np.float32)
           for v in (soup.v0, soup.e1, soup.e2)]
    u = rng.uniform(size=(n, 1)).astype(np.float32)
    v = rng.uniform(size=(n, 1)).astype(np.float32)
    flip = (u + v) > 1
    u, v = np.where(flip, 1 - u, u), np.where(flip, 1 - v, v)
    target = tri[0] + u * tri[1] + v * tri[2]
    o = target + rng.uniform(-4, 4, (n, 3)).astype(np.float32)
    d = (target - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return Rays(Vec3(*[t(o[:, i]) for i in range(3)]),
                Vec3(*[t(d[:, i]) for i in range(3)]),
                t(np.zeros(n, np.float32)), t(np.full(n, 1e30, np.float32)))


def camera_rays(scene, settings, n, device):
    """n camera rays of the scene's camera through random pixels."""
    import torch
    from ignis_tpu_torch.models.camera import generate_rays
    g = torch.Generator(device="cpu").manual_seed(1)
    x = torch.randint(0, settings.width, (n,), generator=g).to(device)
    y = torch.randint(0, settings.height, (n,), generator=g).to(device)
    sx = torch.rand(n, generator=g).to(device)
    sy = torch.rand(n, generator=g).to(device)
    return generate_rays(scene.camera, settings, x, y, sx, sy)


def cat_rays(a, b):
    import torch
    from ignis_tpu_torch.core.vec import Vec3
    from ignis_tpu_torch.ops.intersect import Rays
    c = lambda p, q: torch.cat([p, q]).contiguous()  # noqa: E731
    return Rays(Vec3(*[c(p, q) for p, q in zip(a.org, b.org)]),
                Vec3(*[c(p, q) for p, q in zip(a.dir, b.dir)]),
                c(a.tmin, b.tmin), c(a.tmax, b.tmax))


def main_path_sets(rt, device, light=S1_LIGHT, seed=17):
    """Three ray sets of the main path on rt's scene, one ray per pixel of
    its film, from `seed`: "camera", camera rays in pixel order with a
    random offset in each pixel, as the first bounce traces them;
    "secondary", rays from their hits in cosine-distributed directions
    about the shading normal (lanes whose camera ray missed are dead:
    tmax < tmin); "shadow", rays from those hits to a point light at
    `light` (any hit). Returns {name: (rays, any_hit)}."""
    import torch
    from ignis_tpu_torch.core.frame import make_frame
    from ignis_tpu_torch.core.vec import Vec3
    from ignis_tpu_torch.core.warp import sample_cosine_hemisphere
    from ignis_tpu_torch.models.camera import generate_rays
    from ignis_tpu_torch.ops import bvh_cuda
    from ignis_tpu_torch.ops.intersect import FLT_MAX, Rays
    from ignis_tpu_torch.techniques.path import OFFSET, compute_surface
    scene, s = rt.scene, rt.settings
    n = s.width * s.height
    g = torch.Generator(device="cpu").manual_seed(seed)
    pix = torch.arange(n)
    x, y = (pix % s.width).to(device), (pix // s.width).to(device)
    sx, sy, u0, u1 = [torch.rand(n, generator=g).to(device)
                      for _ in range(4)]
    cam = generate_rays(scene.camera, s, x, y, sx, sy)
    hit = bvh_cuda.intersect_bvh(cam, scene.tris, scene.bvh)
    surf = compute_surface(scene, cam, hit)
    found = hit.prim >= 0
    local, _ = sample_cosine_hemisphere(u0, u1)
    d = make_frame(surf.ns).to_world(local)
    org = Vec3(*[a.contiguous() for a in surf.point])
    tmin = torch.full_like(hit.t, OFFSET)
    sec = Rays(org, Vec3(*[a.contiguous() for a in d]), tmin,
               torch.where(found, FLT_MAX, -1.0))
    to_light = Vec3(*[(c - a).contiguous() for c, a in zip(light, org)])
    shadow = Rays(org, to_light, tmin, torch.where(found, 1.0 - OFFSET, -1.0))
    return {"camera": (cam, False), "secondary": (sec, False),
            "shadow": (shadow, True)}


def compare_hits(got, ref, what, bar, hit_mask=False):
    """Hold a closest-hit result against a reference: prim agreement
    > bar (and, with `hit_mask`, hit-mask agreement >= bar); at least 100
    lanes where both hit the same primitive; there, t within rtol 1e-4
    and u, v within rtol 1e-5 / atol 1e-6 on every lane; t within rtol
    1e-4 on a share >= bar of the lanes where both hit at all. Returns the
    largest |difference| of t, u or v where both hit the same primitive."""
    gt, gp, gu, gv = [x.cpu().numpy() for x in got]
    rt, rp, ru, rv = [x.cpu().numpy() for x in ref]
    agree = (gp == rp).mean()
    check(agree > bar, f"{what}: prim agreement {agree:.6f} > {bar}")
    if hit_mask:
        agree = ((gp >= 0) == (rp >= 0)).mean()
        check(agree >= bar, f"{what}: hit-mask agreement {agree:.6f} "
              f">= {bar}")
    both = (gp >= 0) & (rp >= 0)
    same = both & (gp == rp)
    n_same = int(same.sum())
    check(n_same >= 100, f"{what}: {n_same} lanes where both hit the same "
          f"primitive (>= 100)")
    # A flipped edge hit sends a lane to another triangle at another t, so
    # t is held to rtol 1e-4 (np.allclose's atol 1e-8, as tests/test_bvh.py)
    # on every lane where both hit the same primitive, and by share where
    # both hit at all.
    ok_t = np.isclose(gt, rt, rtol=1e-4, atol=1e-8)
    check(ok_t[same].all(), f"{what}: t within rtol 1e-4 on all {n_same} "
          f"lanes where both hit the same primitive")
    share = ok_t[both].mean()
    check(share >= bar, f"{what}: t within rtol 1e-4 on {share:.6f} "
          f"of {both.sum()} lanes where both hit")
    # Same primitive, same Moeller-Trumbore: the barycentrics feed normal
    # and uv interpolation, so they are held as tightly as t.
    for name, a, b in (("u", gu, ru), ("v", gv, rv)):
        ok = np.isclose(a[same], b[same], rtol=1e-5, atol=1e-6)
        check(ok.all(), f"{what}: {name} within rtol 1e-5 / atol 1e-6 on "
              f"all {n_same} lanes where both hit the same primitive")
    return max(float(np.abs(a[same] - b[same]).max())
               for a, b in ((gt, rt), (gu, ru), (gv, rv)))


def bound(n_bytes, n_ops):
    """(least time in ms, "bytes" or "operations") of work that moves
    n_bytes and does n_ops fp32 operations."""
    by_bytes = n_bytes / H100_BYTES_PER_S * 1e3
    by_ops = n_ops / H100_FP32_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                             "operations")


def bvh_paths(bvh, n_tris):
    """(parent of each node, node of each triangle's leaf, children of each
    node) of a BVHArrays, in numpy."""
    child = bvh.child.cpu().numpy().astype(np.int64)
    parent = np.full(child.shape[0], -1)
    node, slot = np.nonzero(child > 0)
    parent[child[node, slot]] = node
    node, slot = np.nonzero(child < 0)
    code = -child[node, slot] - 1
    start, count = code >> 4, code & 15
    offsets = np.cumsum(count) - count
    owner = np.full(n_tris, -1)
    owner[np.repeat(start - offsets, count) + np.arange(count.sum())] = \
        np.repeat(node, count)
    return parent, owner, (child != 0).sum(1)


def k1_bound(rays, result, paths, any_hit):
    """K1's least time on these rays: ray arrays in (8 f32), results out
    (t, prim, u, v; or one occlusion byte), the root's records, and for
    closest hit each distinct winner's triangle row and the records of
    every node on its path from the root; operations: the root's slab
    tests of every live ray and one triangle test of every hit. What else
    a ray must read to prove its answer depends on the walk and is not
    counted, so this is a floor."""
    parent, owner, kids = paths
    n = rays.tmin.numel()
    live = int((rays.tmax >= rays.tmin).sum())
    n_bytes = 32 * n + (1 if any_hit else 16) * n
    n_ops = live * int(kids[0]) * SLAB_OPS
    on_path = np.zeros(len(parent), bool)
    on_path[0] = True
    if not any_hit:
        prim = result.prim.cpu().numpy()
        winners = np.unique(prim[prim >= 0])
        nodes = np.unique(owner[winners])
        while len(nodes):
            on_path[nodes] = True
            nodes = np.unique(parent[nodes])
            nodes = nodes[nodes >= 0]
            nodes = nodes[~on_path[nodes]]
        n_bytes += 48 * len(winners)
        n_ops += int((prim >= 0).sum()) * MT_OPS
    n_bytes += 32 * int(kids[on_path].sum())
    return bound(n_bytes, n_ops)


def replay_bound(prim, n_tris):
    """The MT replay's least time: per ray 6 ray floats, the prim and 3
    cotangents in, 6 ray gradients out; each distinct winner's 9 soup
    floats in; the 9 [T] soup gradients out."""
    n = prim.numel()
    p = prim.cpu().numpy()
    winners = len(np.unique(p[p >= 0]))
    return bound(n * (10 + 6) * 4 + winners * 36 + 9 * 4 * n_tris,
                 int((p >= 0).sum()) * REPLAY_OPS)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_build():
    """Every library at once: one compiler process per source."""
    from concurrent.futures import ThreadPoolExecutor
    from ignis_tpu_torch.native import get_lib
    from ignis_tpu_torch.ops import (bvh_cuda, cuda_build, gather,
                                     isect_cuda, mt_replay)
    t0 = time.perf_counter()
    builds = (isect_cuda.build, bvh_cuda.build, gather.build,
              mt_replay.build, get_lib)
    with ThreadPoolExecutor(len(builds)) as pool:
        for f in [pool.submit(b) for b in builds]:
            f.result()
    print(f"  build seconds: {time.perf_counter() - t0:.2f}")
    for name, (sec, log) in cuda_build.BUILD_LOG.items():
        print(f"  {name}: " + (f"compiled in {sec:.2f} s" if log != "cached"
                               else "cached"))
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"    {line.strip()}")


def phase_k2(device, n_rays=262144, sizes=(2, 256, 4096)):
    """K2 against its plain version on random soups."""
    from ignis_tpu_torch.ops import isect_cuda
    rng = np.random.default_rng(7)
    rays = random_rays(rng, n_rays, device)
    err = 0.0
    for n_tris in sizes:
        soup, vis = random_soup(rng, n_tris, device)
        got = isect_cuda.intersect_tris(rays, soup)
        ref = isect_cuda.intersect_tris_plain(rays, soup)
        err = max(err, compare_hits(got, ref, f"K2 T={n_tris}", 0.999))
        occ = isect_cuda.intersect_tris(rays, soup, vis, any_hit=True)
        occ_ref = isect_cuda.intersect_tris_plain(rays, soup, vis,
                                                  any_hit=True)
        agree = (occ == occ_ref).float().mean().item()
        check(agree >= 0.999, f"K2 T={n_tris}: any-hit agreement "
              f"{agree:.6f} >= 0.999")
    return err


def phase_k1(device, s1, n_rays=65536):
    """K1 against its plain version on the BVH of `s1` (S1's runtime),
    and against K2; no stack push may be dropped."""
    import torch
    from ignis_tpu_torch.ops import bvh_cuda, isect_cuda
    scene, settings = s1.scene, s1.settings
    bvh_cuda.reset_overflow(device)
    rng = np.random.default_rng(11)
    half = n_rays // 2
    rays = cat_rays(camera_rays(scene, settings, half, device),
                    random_rays(rng, n_rays - half, device, extent=1.5))
    vis = scene.tri_attr.shadow_visible
    got = bvh_cuda.intersect_bvh(rays, scene.tris, scene.bvh)
    ref = bvh_cuda.intersect_bvh_plain(rays, scene.tris, scene.bvh)
    err = compare_hits(got, ref, "K1 S1", 0.995, hit_mask=True)
    occ = bvh_cuda.intersect_bvh(rays, scene.tris, scene.bvh, any_hit=True,
                                 shadow_visible=vis)
    occ_ref = bvh_cuda.intersect_bvh_plain(rays, scene.tris, scene.bvh,
                                           any_hit=True, shadow_visible=vis)
    agree = (occ == occ_ref).float().mean().item()
    check(agree >= 0.995, f"K1 S1: any-hit agreement {agree:.6f} >= 0.995")

    # cross-check against K2 brute force on a 20,480-triangle icosphere
    import ignis_tpu_torch
    ico = {"technique": {"type": "path"},
           "camera": {"type": "perspective", "fov": 60,
                      "transform": [1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, -4,
                                    0, 0, 0, 1]},
           "film": {"size": [32, 32]},
           "bsdfs": [{"type": "diffuse", "name": "w"}],
           "shapes": [{"type": "icosphere", "name": "s", "radius": 1.2,
                       "subdivisions": 5}],
           "entities": [{"name": "s", "shape": "s", "bsdf": "w"}],
           "lights": [{"type": "env", "name": "e", "radiance": 1.0}]}
    rt = ignis_tpu_torch.loadFromString(json.dumps(ico), device=device)
    sc = rt.scene
    check(sc.tris.v0.x.numel() == 20480 and sc.bvh is not None,
          "icosphere: 20,480 triangles with a BVH")
    rays2 = random_rays(rng, n_rays, device, extent=3.0)
    h1 = bvh_cuda.intersect_bvh(rays2, sc.tris, sc.bvh)
    h2 = isect_cuda.intersect_tris(rays2, sc.tris)
    compare_hits(h1, h2, "K1 vs K2 icosphere", 0.995, hit_mask=True)
    o1 = bvh_cuda.intersect_bvh(rays2, sc.tris, sc.bvh, any_hit=True)
    o2 = isect_cuda.intersect_tris(rays2, sc.tris, any_hit=True)
    agree = (o1 == o2).float().mean().item()
    check(agree >= 0.995, f"K1 vs K2 icosphere: any-hit agreement "
          f"{agree:.6f} >= 0.995")
    torch.cuda.synchronize()
    ovf = bvh_cuda.overflow_count(device)
    check(ovf == 0, f"K1 stack overflow counter {ovf} == 0")
    return err, rays


def phase_times(device, s1, k1_rays):
    """Median CUDA-event times of each kernel and its plain version, with
    the kernel's bound: K2 at S2's shape, K1 on the 65,536 rays of
    phase_k1 (closest and any hit), the soup packed beforehand as the
    main path packs it."""
    import torch
    from ignis_tpu_torch.ops import bvh_cuda, isect_cuda
    rng = np.random.default_rng(5)
    out = {}
    # K2 at S2's shape: its 2-triangle soup and 262,144 lanes
    import ignis_tpu_torch
    s2 = ignis_tpu_torch.loadFromString(json.dumps(S2_GRAFT_ENTRY),
                                        device=device)
    rays = random_rays(rng, 262144, device)
    n_tris = s2.scene.tris.v0.x.numel()
    n = rays.tmin.numel()
    out["K2"] = (cuda_ms(lambda: isect_cuda.intersect_tris(rays,
                                                           s2.scene.tris)),
                 cuda_ms(lambda: isect_cuda.intersect_tris_plain(
                     rays, s2.scene.tris)),
                 *bound(48 * n + 36 * n_tris, n * n_tris * MT_OPS))
    sc = s1.scene
    rows = bvh_cuda.pack_tris(sc.tris)
    paths = bvh_paths(sc.bvh, sc.tris.v0.x.numel())
    vis = sc.tri_attr.shadow_visible
    for name, any_hit in (("K1", False), ("K1_any", True)):
        kw = dict(any_hit=any_hit, shadow_visible=vis if any_hit else None)
        res = bvh_cuda.intersect_bvh(k1_rays, sc.tris, sc.bvh, **kw)
        out[name] = (
            cuda_ms(lambda: bvh_cuda.intersect_bvh(k1_rays, sc.tris, sc.bvh,
                                                   tri_rows=rows, **kw)),
            cuda_ms(lambda: bvh_cuda.intersect_bvh_plain(
                k1_rays, sc.tris, sc.bvh, **kw), reps=10, warmup=1),
            *k1_bound(k1_rays, res, paths, any_hit))
    for k, (ms, plain, bms, by) in out.items():
        print(f"  {k}: kernel {ms:.4f} ms, plain {plain:.4f} ms, bound "
              f"{bms:.4f} ms ({by})")
    torch.cuda.synchronize()
    return out


def phase_k1_sets(device, runtimes, check_only=False):
    """K1 on main_path_sets of each runtime ({name: Runtime}): exact
    against the plain walk (t, u and v bit for bit where the prims agree,
    prim agreement > 0.995, any-hit agreement >= 0.995), and,
    unless check_only, its median time with the soup packed beforehand, as
    the main path packs it, beside its bound. No stack push may be
    dropped. Returns {"<scene> <set>": {...}}."""
    import torch
    from ignis_tpu_torch.ops import bvh_cuda
    bvh_cuda.reset_overflow(device)
    out = {}
    for name, rt in runtimes.items():
        sc = rt.scene
        rows = bvh_cuda.pack_tris(sc.tris)
        paths = bvh_paths(sc.bvh, sc.tris.v0.x.numel())
        nodes = bvh_cuda.scene_nodes(sc.bvh)
        print(f"  {name}: {sc.bvh.child.shape[0]} nodes, "
              f"{nodes.records.shape[0]} node records "
              f"({nodes.records.numel() * 4 / 1e6:.1f} MB), {nodes.dropped} "
              f"empty child slots dropped")
        vis = sc.tri_attr.shadow_visible
        for set_name, (rays, any_hit) in main_path_sets(rt, device).items():
            what = f"K1 {name} {set_name}"
            live = int((rays.tmax >= rays.tmin).sum())
            if any_hit:
                got = bvh_cuda.intersect_bvh(rays, sc.tris, sc.bvh, True, vis,
                                             tri_rows=rows)
                ref = bvh_cuda.intersect_bvh_plain(rays, sc.tris, sc.bvh,
                                                   True, vis)
                agree = (got == ref).float().mean().item()
                check(agree >= 0.995, f"{what}: any-hit agreement "
                      f"{agree:.6f} >= 0.995 ({int(ref.sum())} of {live} live "
                      f"rays occluded)")
                err, prim_agree = 0.0, None
            else:
                got = bvh_cuda.intersect_bvh(rays, sc.tris, sc.bvh,
                                             tri_rows=rows)
                ref = bvh_cuda.intersect_bvh_plain(rays, sc.tris, sc.bvh)
                same = got.prim == ref.prim
                prim_agree = float(same.float().mean())
                check(prim_agree > 0.995, f"{what}: prim agreement "
                      f"{prim_agree:.6f} > 0.995 ({int((ref.prim >= 0).sum())}"
                      f" of {live} live rays hit)")
                err = max(max_err(a[same], b[same]) for a, b in
                          zip((got.t, got.u, got.v), (ref.t, ref.u, ref.v)))
                check(err == 0.0, f"{what}: t, u, v bit for bit where the "
                      f"prims agree (max |difference| {err})")
                agree = None
            row = {"rays": rays.tmin.numel(), "live": live,
                   "any_hit": any_hit, "max_abs_err": err,
                   "prim_agreement": prim_agree, "any_hit_agreement": agree}
            if not check_only:
                ms = cuda_ms(lambda: bvh_cuda.intersect_bvh(
                    rays, sc.tris, sc.bvh, any_hit, vis if any_hit else None,
                    tri_rows=rows))
                bms, by = k1_bound(rays, got, paths, any_hit)
                row.update(ms=ms, bound_ms=bms, bound_by=by)
                print(f"  {what}: kernel {ms:.4f} ms, bound {bms:.4f} ms "
                      f"({by}), {live} live rays")
            out[f"{name} {set_name}"] = row
    torch.cuda.synchronize()
    ovf = bvh_cuda.overflow_count(device)
    deepest = bvh_cuda.deepest_stack(device)
    print(f"  K1 deepest stack on these sets: {deepest} entries")
    check(ovf == 0, f"K1 stack overflow counter {ovf} == 0")
    return out, deepest


def all_counts():
    """Every kernel wrapper's counters, by kernel name."""
    from ignis_tpu_torch.ops import bvh_cuda, gather, isect_cuda, mt_replay
    return {"K1": bvh_cuda.counts, "K2": isect_cuda.counts,
            "K3_gather_rows": gather.gather_counts,
            "K3_scatter_add_rows": gather.scatter_counts,
            "MT_replay_bwd": mt_replay.counts}


def reset_all_counts():
    for c in all_counts().values():
        c.reset()


def launches():
    return {k: c["launches"] for k, c in all_counts().items()}


def plain_calls() -> int:
    return sum(c["plain_calls"] for c in all_counts().values())


def phase_render(device, runtimes):
    """Render S1-S3 on the card; launch counts reset just before."""
    import torch
    from ignis_tpu_torch.ops import bvh_cuda, isect_cuda
    bvh_cuda.reset_overflow(device)
    reset_all_counts()
    per_scene = {}
    for name, _, kernel in SCENES:
        rt = runtimes[name]
        k1_0, k2_0 = bvh_cuda.counts["launches"], isect_cuda.counts["launches"]
        rt.step()                               # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            rt.step()
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        img = rt.framebuffer(normalized=True)
        s = rt.settings
        msps = 3 * s.width * s.height * s.spi / sec / 1e6
        mean = float(img.mean())
        k1 = bvh_cuda.counts["launches"] - k1_0
        k2 = isect_cuda.counts["launches"] - k2_0
        print(f"  {name}: {msps:.4f} Msamples/s ({sec:.3f} s for 3 steps), "
              f"image mean {mean:.6f}, K1 launches {k1}, K2 launches {k2}")
        check(tuple(img.shape) == (s.height, s.width, 3),
              f"{name}: image shape {tuple(img.shape)}")
        check(bool(torch.isfinite(img).all()), f"{name}: image finite")
        check(mean > 1e-3, f"{name}: image not black")
        launched = k1 if kernel == "K1" else k2
        check(launched > 0, f"{name}: {kernel} launched {launched} times")
        per_scene[name] = {"msamples_per_s": msps, "seconds_3_steps": sec,
                           "mean": mean, "K1": k1, "K2": k2}
    counts = launches()
    check(counts["K3_gather_rows"] > 0, f"K3 gather_rows launched "
          f"{counts['K3_gather_rows']} times")
    plain = plain_calls()
    check(plain == 0, f"no plain version called during the renders "
          f"({plain})")
    ovf = bvh_cuda.overflow_count(device)
    print(f"  K1 deepest stack in the renders: "
          f"{bvh_cuda.deepest_stack(device)} entries")
    check(ovf == 0, f"K1 stack overflow counter {ovf} == 0")
    return counts, per_scene


def phase_profile(runtimes):
    """One profiled step per scene: device time, busy share and the top
    device consumers of that same step (render/profile.py)."""
    from ignis_tpu_torch.render.profile import profile_step
    out = {}
    for name, _, _ in SCENES:
        p = profile_step(runtimes[name].step, {"K1": "bvh_walk_kernel",
                                               "K2": "isect_dense_kernel"})
        print(f"  {name}: profiled step {p['wall_s']:.4f} s, device ops "
              f"{p['device_ops']}, device busy {p['device_busy_us']:.1f} us "
              f"(share {p['busy_share']:.4f}), device sum "
              f"{p['device_sum_us']:.1f} us, K1 {p['K1_us']:.1f} us, "
              f"K2 {p['K2_us']:.1f} us")
        for kname, count, us in p["top"]:
            print(f"    {us:10.1f} us {count:6d}x {kname}")
        out[name] = p
    return out


def phase_reference(device):
    """Analytic point-light oracle on the card, and card-vs-CPU renders."""
    import torch
    import ignis_tpu_torch
    scene = flat_scene()
    scene["lights"].append({"type": "point", "name": "_l",
                            "position": [0, 0, -2], "power": 1})
    rt = ignis_tpu_torch.loadFromString(json.dumps(scene), device=device)
    for _ in range(8):
        rt.step()
    avg = float(rt.framebuffer(normalized=True).mean())
    check(abs(avg - 0.005100456) <= 1e-4,
          f"analytic point light: {avg:.9f} vs 0.005100456 (abs 1e-4)")
    for name, sc in (("S2", S2_GRAFT_ENTRY), ("S1 at subdivisions 3",
                                              _ico3(S1_GLASS_ICO7))):
        small = dict(sc)
        small["film"] = {"size": [64, 64]}
        imgs = []
        for dev in (device, "cpu"):
            r = ignis_tpu_torch.loadFromString(json.dumps(small), device=dev,
                                               spi=4)
            imgs.append(r.step().framebuffer(normalized=True).cpu().numpy())
        gpu, cpu = imgs
        close = np.isclose(gpu, cpu, rtol=1e-3, atol=1e-4).all(-1).mean()
        rel = abs(gpu.mean() - cpu.mean()) / max(cpu.mean(), 1e-9)
        check(close >= 0.99, f"{name} 64x64: card vs CPU pixels close "
              f"{close:.4f} >= 0.99")
        check(rel <= 0.005, f"{name} 64x64: mean card {gpu.mean():.6f} vs "
              f"CPU {cpu.mean():.6f} within 0.5%")
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# phase 7: gradients
# ---------------------------------------------------------------------------

def small_scene(size=64, max_depth=3):
    """tests/test_parallel.py:19 small_scene: floor, ball, point + env."""
    return {
        "technique": {"type": "path", "max_depth": max_depth},
        "camera": {"type": "perspective", "fov": 60, "near_clip": 0.1,
                   "far_clip": 100,
                   "transform": [-1, 0, 0, 0, 0, 1, 0, 0, 0, 0, -1, 3,
                                 0, 0, 0, 1]},
        "film": {"size": [size, size]},
        "bsdfs": [{"type": "diffuse", "name": "white",
                   "reflectance": [0.7, 0.5, 0.3]}],
        "shapes": [
            {"type": "rectangle", "name": "floor", "width": 4, "height": 4},
            {"type": "sphere", "name": "ball", "radius": 0.5},
        ],
        "entities": [
            {"name": "floor", "shape": "floor", "bsdf": "white",
             "transform": [{"rotate": [-90, 0, 0]},
                           {"translate": [0, -1, 0]}]},
            {"name": "ball", "shape": "ball", "bsdf": "white"},
        ],
        "lights": [
            {"type": "point", "name": "l", "position": [1, 2, 2],
             "power": 30},
            {"type": "env", "name": "e", "radiance": [0.2, 0.2, 0.3]},
        ],
    }


def max_err(a, b) -> float:
    return float((a - b).abs().max()) if a.numel() else 0.0


def reorder_ratio(got, ref, idx, terms, rtol):
    """Largest |got - ref| / (1e-6 + rtol * sum|terms|) over the rows of
    two scatter-added sums (`terms` added at rows `idx`, in atomic order in
    one and index_add_ order in the other). Reordering a float32 sum moves
    it by a share of the sum of its terms' magnitudes, not of the result,
    which may cancel to near 0; a ratio <= 1 is within the bar."""
    import torch
    mag = torch.zeros_like(ref).index_add_(0, idx, terms.abs())
    return float(((got - ref).abs() / (1e-6 + rtol * mag)).max())


def compare_replay(what, rays, soup, prim, seed):
    """The MT replay kernel against mt_replay_bwd_plain at the winners
    `prim`, with random cotangents. Per-ray gradients bit for bit (both
    run the same operations in the same order, without FMA contraction).
    Soup gradients are
    sums over the rays that hit a triangle, in atomic order on the card and
    index_add_ order in the plain version: within 1e-6 + 1e-4 times the sum
    of their terms' magnitudes (reorder_ratio). Returns the largest
    |difference|."""
    import torch
    from ignis_tpu_torch.core.vec import Vec3
    from ignis_tpu_torch.ops import mt_replay
    n = prim.numel()
    g = torch.Generator(device="cpu").manual_seed(seed)
    cts = [torch.randn(n, generator=g).to(prim.device) for _ in range(3)]
    ray_arrays = [*rays.org, *rays.dir]
    soup_arrays = [*soup.v0, *soup.e1, *soup.e2]
    kr, ks = mt_replay.mt_replay_bwd(ray_arrays, soup_arrays, prim, *cts)
    pr, ps = mt_replay.mt_replay_bwd_plain(ray_arrays, soup_arrays, prim,
                                           *cts)
    hit = prim >= 0
    check(int(hit.sum()) >= 1000, f"{what}: {int(hit.sum())} of {n} rays "
          f"hit (>= 1000)")
    exact = all(torch.equal(a, b) for a, b in zip(kr, pr))
    check(exact, f"{what}: per-ray gradients bit for bit")
    # |terms| of every soup sum
    p = torch.clamp(prim, min=0).long()
    rows = [a[p] for a in soup_arrays]
    terms = mt_replay.mt_adjoint(Vec3(*ray_arrays[:3]),
                                 Vec3(*ray_arrays[3:]), Vec3(*rows[:3]),
                                 Vec3(*rows[3:6]), Vec3(*rows[6:]), *cts)[2:]
    worst = max(reorder_ratio(a, b, p, torch.where(hit, term, 0.0), 1e-4)
                for a, b, term in zip(ks, ps, [c for v in terms for c in v]))
    check(worst <= 1.0, f"{what}: soup gradients within 1e-6 + 1e-4 "
          f"sum|terms| (worst ratio {worst:.4f})")
    return max(max_err(a, b) for a, b in zip(kr + ks, pr + ps))


def k3_bound(idx, k, n_rows, scatter):
    """K3's least time at these indices: the index and the k columns of
    every lane, each distinct row's k floats read (gather), or the whole
    [n_rows, k] gradient written (scatter); the scatter's one addition per
    value as operations."""
    import torch
    n = idx.numel()
    if scatter:
        return bound((4 + 4 * k) * n + 4 * k * n_rows, n * k)
    return bound((4 + 4 * k) * n + 4 * k * torch.unique(idx).numel(), 0)


def k3_gather_result(idx, tab, k):
    """One K3 gather against its plain version: (the [k, N] block equal to
    tab[idx, :k].T, largest |difference|)."""
    import torch
    from ignis_tpu_torch.ops import gather
    got = gather.gather_rows(idx, tab, k)
    ref = gather.gather_rows_plain(idx, tab, k)
    return (tuple(got.shape) == (k, idx.numel()) and torch.equal(got, ref),
            max_err(got, ref))


def k3_scatter_result(idx, cot, n_rows, stride):
    """One K3 scatter of the [k, N] cotangent block against its plain
    version: (what differs beyond reordering, or ""; the worst ratio to
    the reorder bar, 1e-6 + 1e-5 times the sum of the terms' magnitudes
    of each entry (reorder_ratio), over the finite entries; the largest
    |difference| there). NaN and inf must land where index_add_ puts them,
    and the padding columns must stay zero."""
    import torch
    from ignis_tpu_torch.ops import gather
    k = cot.shape[0]
    got = gather.scatter_add_rows(idx, cot, n_rows, stride)
    ref = gather.scatter_add_rows_plain(idx, cot, n_rows, stride)
    faults = []
    if got[:, k:].any():
        faults.append("padding columns not zero")
    got, ref = got[:, :k], ref[:, :k]
    nan = ref.isnan()
    if not torch.equal(got.isnan(), nan):
        faults.append("NaN elsewhere than index_add_'s")
    inf = ref.isinf()
    if not torch.equal(got[inf], ref[inf]):
        faults.append("inf elsewhere than index_add_'s")
    fin = ~(nan | inf)
    terms = torch.where(torch.isfinite(cot), cot, 0.0).t()
    ratio = reorder_ratio(torch.where(fin, got, 0.0),
                          torch.where(fin, ref, 0.0), idx.long(), terms, 1e-5)
    return "; ".join(faults), ratio, max_err(got[fin], ref[fin])


def check_k3(what, idx, tab, k, cot):
    """K3's gather and scatter-add against their plain versions on one
    set (k3_gather_result, k3_scatter_result); returns the largest
    |difference| of each."""
    n_rows, stride = tab.shape
    equal, g_err = k3_gather_result(idx, tab, k)
    check(equal, f"K3 gather_rows {what} [{n_rows} x {stride}, {k} columns] "
          f"at {idx.numel()} indices: equal to tab[idx]")
    fault, ratio, s_err = k3_scatter_result(idx, cot, n_rows, stride)
    check(not fault and ratio <= 1.0, f"K3 scatter_add_rows {what}: within "
          f"1e-6 + 1e-5 sum|terms| of index_add_ (worst ratio {ratio:.4f})"
          f"{'; ' + fault if fault else ''}, NaN, inf and padding as it")
    return g_err, s_err


def k3_camera_set(rt, device, seed=23):
    """K3's inputs at the first bounce of rt's main path: the clamped
    prims of main_path_sets' camera hits (a miss on row 0) into rt's
    attr_table, and a random cotangent block that is zero on the misses,
    as the masked shading leaves it."""
    import torch
    from ignis_tpu_torch.ops import bvh_cuda
    from ignis_tpu_torch.techniques.path import ATTR_COLS, attr_table
    sc = rt.scene
    cam, _ = main_path_sets(rt, device)["camera"]
    prim = bvh_cuda.intersect_bvh(cam, sc.tris, sc.bvh).prim
    tab = attr_table(sc)
    idx = torch.clamp(prim, 0, tab.shape[0] - 1).to(torch.int32)
    g = torch.Generator(device="cpu").manual_seed(seed)
    cot = torch.randn(ATTR_COLS, idx.numel(), generator=g).to(device)
    return idx, tab, torch.where(prim >= 0, cot, 0.0)


def k3_sets(rt, device, n=262144, seed=3):
    """K3's check sets on rt's attr_table: "random", n random rows with
    random cotangents; "camera", k3_camera_set; "one row", n lanes on row 7;
    "special", random rows whose cotangents hold a NaN, a -0.0 and an inf.
    Returns {name: (idx, tab, k, cot)}."""
    import torch
    from ignis_tpu_torch.techniques.path import ATTR_COLS, attr_table
    tab = attr_table(rt.scene)
    n_rows, k = tab.shape[0], ATTR_COLS
    g = torch.Generator(device="cpu").manual_seed(seed)
    idx = torch.randint(0, n_rows, (n,), generator=g,
                        dtype=torch.int32).to(device)
    cot = torch.randn(k, n, generator=g).to(device)
    special = cot.clone()
    special[3, 10], special[5, 20], special[7, 30] = (
        float("nan"), -0.0, float("inf"))
    cam_idx, _, cam_cot = k3_camera_set(rt, device)
    return {"random": (idx, tab, k, cot),
            "camera": (cam_idx, tab, k, cam_cot),
            "one row": (torch.full_like(idx, 7), tab, k, cot),
            "special": (idx, tab, k, special)}


def phase_grad_kernels(device, s1, k1_rays):
    """K3's gather and scatter-add and the MT replay against their plain
    versions on the card, at the gradient path's shapes (S1's attribute
    table, 262,144 lanes: k3_sets), the replay also with 65,536 rays aimed
    at one triangle; median kernel, plain and library times and each
    kernel's bound: K3 on the random set, the replay on S1's contended rays
    (half camera rays through random pixels, half random rays about the
    ball, most of whose hits land on the floor's two triangles) and on
    random rays against a 4,096-triangle random soup, where winners rarely
    repeat."""
    import torch
    from ignis_tpu_torch.ops import bvh_cuda, gather, isect_cuda, mt_replay
    sc = s1.scene
    g = torch.Generator(device="cpu").manual_seed(3)
    sets = k3_sets(s1, device)
    errs = {"K3_gather_rows": 0.0, "K3_scatter_add_rows": 0.0}
    for name, (idx, tab, k, cot) in sets.items():
        ge, se = check_k3(name, idx, tab, k, cot)
        errs["K3_gather_rows"] = max(errs["K3_gather_rows"], ge)
        errs["K3_scatter_add_rows"] = max(errs["K3_scatter_add_rows"], se)
    idx, tab, k, cot = sets["random"]
    n_rows, stride = tab.shape
    n = idx.numel()

    hit = bvh_cuda.intersect_bvh(k1_rays, sc.tris, sc.bvh)
    e1 = compare_replay("MT replay, S1 rays at K1's winners", k1_rays,
                        sc.tris, hit.prim, 1)
    rng = np.random.default_rng(13)
    soup, _ = random_soup(rng, 4096, device)
    rays = random_rays(rng, 65536, device)
    e2 = compare_replay("MT replay, random soup at K2's winners", rays, soup,
                        isect_cuda.intersect_tris(rays, soup).prim, 2)
    at0 = rays_at_triangle(rng, soup, 0, 65536, device)
    e3 = compare_replay("MT replay, every ray on triangle 0", at0, soup,
                        torch.zeros_like(at0.tmin, dtype=torch.int32), 4)
    errs["MT_replay_bwd"] = max(e1, e2, e3)

    # times at the main path's shapes: 262,144 lanes
    contended = cat_rays(camera_rays(sc, s1.settings, n // 2, device),
                         random_rays(rng, n // 2, device, extent=1.5))
    spread = random_rays(rng, n, device)
    replay_sets = {
        "S1 contended": (contended, [*sc.tris.v0, *sc.tris.e1, *sc.tris.e2],
                         bvh_cuda.intersect_bvh(contended, sc.tris,
                                                sc.bvh).prim),
        "random soup": (spread, [*soup.v0, *soup.e1, *soup.e2],
                        isect_cuda.intersect_tris(spread, soup).prim)}
    cts = [torch.randn(n, generator=g).to(device) for _ in range(3)]
    zeros = torch.zeros(n_rows, k, device=device)
    rows = cot.t().contiguous()
    times = {
        "K3_gather_rows": dict(
            ms=cuda_ms(lambda: gather.gather_rows(idx, tab, k)),
            plain_ms=cuda_ms(lambda: gather.gather_rows_plain(idx, tab, k)),
            library_ms=cuda_ms(lambda: torch.index_select(tab, 0, idx))),
        "K3_scatter_add_rows": dict(
            ms=cuda_ms(lambda: gather.scatter_add_rows(idx, cot, n_rows,
                                                       stride)),
            plain_ms=cuda_ms(lambda: gather.scatter_add_rows_plain(
                idx, cot, n_rows, stride)),
            library_ms=cuda_ms(lambda: torch.index_add(zeros, 0, idx, rows)))}
    times["K3_gather_rows"].update(zip(("bound_ms", "bound_by"), k3_bound(
        idx, k, n_rows, False)))
    times["K3_scatter_add_rows"].update(zip(("bound_ms", "bound_by"),
                                            k3_bound(idx, k, n_rows, True)))
    for name in ("camera", "one row"):
        i, t, _, c = sets[name]
        times["K3_gather_rows"].setdefault("sets", {})[name] = dict(
            ms=cuda_ms(lambda: gather.gather_rows(i, t, k)),
            library_ms=cuda_ms(lambda: torch.index_select(t, 0, i)),
            bound_ms=k3_bound(i, k, n_rows, False)[0])
        r = c.t().contiguous()
        times["K3_scatter_add_rows"].setdefault("sets", {})[name] = dict(
            ms=cuda_ms(lambda: gather.scatter_add_rows(i, c, n_rows, stride)),
            library_ms=cuda_ms(lambda: torch.index_add(zeros, 0, i, r)),
            bound_ms=k3_bound(i, k, n_rows, True)[0])
    replay = {}
    for name, (r, soup_arrays, prim) in replay_sets.items():
        ra = [*r.org, *r.dir]
        row = dict(
            ms=cuda_ms(lambda: mt_replay.mt_replay_bwd(ra, soup_arrays, prim,
                                                       *cts)),
            plain_ms=cuda_ms(lambda: mt_replay.mt_replay_bwd_plain(
                ra, soup_arrays, prim, *cts)),
            library_ms=None, hits=int((prim >= 0).sum()),
            winners=int(torch.unique(prim[prim >= 0]).numel()))
        row.update(zip(("bound_ms", "bound_by"),
                       replay_bound(prim, soup_arrays[0].numel())))
        replay[name] = row
    times["MT_replay_bwd"] = dict(replay["S1 contended"], sets=replay)
    for name, t in [*times.items()] + [
            (f"{kernel} {k}", v) for kernel in times
            for k, v in times[kernel].get("sets", {}).items()]:
        lib = ("none" if t["library_ms"] is None
               else f"{t['library_ms']:.4f} ms")
        plain = (f", plain {t['plain_ms']:.4f} ms" if "plain_ms" in t
                 else "")
        print(f"  {name}: kernel {t['ms']:.4f} ms{plain}, library {lib}, "
              f"bound {t['bound_ms']:.4f} ms")
    return errs, times


def geometry_leaves(scene):
    """`scene` with tris.v0/e1/e2 replaced by fresh leaves that require
    grad, and the list of those leaves."""
    from ignis_tpu_torch.core.vec import Vec3
    vs = {f: Vec3(*[c.detach().clone().requires_grad_()
                    for c in getattr(scene.tris, f)])
          for f in ("v0", "e1", "e2")}
    return (scene._replace(tris=scene.tris._replace(**vs)),
            [c for v in vs.values() for c in v])


def phase_train(device, runtimes):
    """One-GPU train step (SGD on the albedo, target black) on S1-S3 at
    512x512, spi 4: median of 3 after a warm-up, peak memory; counts
    reset before and read after; then a geometry gradient of the same
    loss on S1 and S2."""
    import torch
    from ignis_tpu_torch import loss_fn, train_step
    lr = 1e-2
    reset_all_counts()
    out = {}
    for name, _, kernel in SCENES:
        rt = runtimes[name]
        s = rt.settings
        target = torch.zeros((s.height, s.width, 3), device=device)
        before = launches()
        base = torch.stack(list(rt.scene.materials.base))
        secs, peaks = [], []
        for _ in range(4):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(device)
            t0 = time.perf_counter()
            loss, new_scene = train_step(rt.scene, s, target, 0, 0, lr)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            peaks.append(torch.cuda.max_memory_allocated(device))
        sec = statistics.median(secs[1:])
        msps = s.width * s.height * s.spi / sec / 1e6
        grad = (base - torch.stack(list(new_scene.materials.base))) / lr
        after = launches()
        used = {k: after[k] - before[k] for k in after}
        print(f"  {name}: train step {msps:.4f} Msamples/s fwd+bwd (median "
              f"{sec:.4f} s of {[round(x, 4) for x in secs[1:]]}), peak "
              f"memory {max(peaks) / 2**30:.3f} GiB, loss {float(loss):.6f},"
              f" launches {used}")
        check(bool(torch.isfinite(loss)), f"{name}: loss finite")
        check(bool(torch.isfinite(grad).all()) and bool((grad != 0).any()),
              f"{name}: albedo gradient finite and nonzero")
        check(used[kernel] > 0 and used["K3_gather_rows"] > 0,
              f"{name}: {kernel} and K3 gather_rows launched in the train "
              f"steps")
        out[name] = {"msamples_per_s": msps, "step_s": secs,
                     "peak_gib": max(peaks) / 2**30, "loss": float(loss),
                     "launches": used}
    check(plain_calls() == 0, f"no plain version called in the train steps "
          f"({plain_calls()})")

    for name in ("S1_glass_ico7", "S2_graft_entry"):
        rt = runtimes[name]
        s = rt.settings
        target = torch.zeros((s.height, s.width, 3), device=device)
        scene, leaves = geometry_leaves(rt.scene)
        before = launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        loss = loss_fn({"base": scene.materials.base}, scene, s, target, 0, 0)
        grads = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        after = launches()
        used = {k: after[k] - before[k] for k in after}
        g = torch.stack(grads)
        finite = float(torch.isfinite(g).float().mean())
        nonzero = int((g != 0).sum())
        print(f"  {name}: geometry gradient in {sec:.4f} s, peak memory "
              f"{torch.cuda.max_memory_allocated(device) / 2**30:.3f} GiB, "
              f"finite share {finite:.6f}, nonzero entries {nonzero} of "
              f"{g.numel()}, launches {used}")
        check(used["MT_replay_bwd"] > 0 and used["K3_scatter_add_rows"] > 0,
              f"{name}: MT replay and K3 scatter_add_rows launched")
        # S2's only triangles, the floor, lie in the camera's plane (y = 0)
        # and through the glass ball: its hits see the lights only through
        # glass, so its smooth gradient is 0 and only S1's must be nonzero.
        check(bool(torch.isfinite(loss))
              and (nonzero > 0 or name != "S1_glass_ico7"),
              f"{name}: loss finite" + (", geometry gradient nonzero"
                                        if name == "S1_glass_ico7" else ""))
        out[name]["geometry"] = {"seconds": sec, "finite_share": finite,
                                 "nonzero": nonzero, "launches": used}
    check(plain_calls() == 0, f"no plain version called in the train and "
          f"geometry steps ({plain_calls()})")
    return launches(), out


def phase_train_profile(device, runtimes):
    """One train step per scene under torch.profiler."""
    import torch
    from ignis_tpu_torch import train_step
    from ignis_tpu_torch.render.profile import profile_step
    names = {"K1": "bvh_walk_kernel", "K2": "isect_dense_kernel",
             "K3": "gather_rows_kernel", "K3s": "scatter_add_rows_kernel",
             "MT": "mt_replay_bwd_kernel"}
    out = {}
    for name, _, _ in SCENES:
        rt = runtimes[name]
        s = rt.settings
        target = torch.zeros((s.height, s.width, 3), device=device)
        p = profile_step(lambda: train_step(rt.scene, s, target, 0, 0, 1e-2),
                         names)
        print(f"  {name}: profiled train step {p['wall_s']:.4f} s, device "
              f"ops {p['device_ops']}, device busy {p['device_busy_us']:.1f}"
              f" us (share {p['busy_share']:.4f}), "
              + ", ".join(f"{k} {p[k + '_us']:.1f} us" for k in names))
        for kname, count, us in p["top"]:
            print(f"    {us:10.1f} us {count:6d}x {kname}")
        out[name] = p
    return out


def phase_geometry_profile(device, rt):
    """One geometry-gradient step of `rt` (w.r.t. tris.v0/e1/e2, the loss
    of phase_train) under torch.profiler: the MT replay's summed device
    time in it, beside K1's and K3's."""
    import torch
    from ignis_tpu_torch import loss_fn
    from ignis_tpu_torch.render.profile import profile_step
    s = rt.settings
    target = torch.zeros((s.height, s.width, 3), device=device)
    names = {"MT": "mt_replay_bwd_kernel", "K1": "bvh_walk_kernel",
             "K3": "gather_rows_kernel", "K3s": "scatter_add_rows_kernel"}

    def step():
        scene, leaves = geometry_leaves(rt.scene)
        loss = loss_fn({"base": scene.materials.base}, scene, s, target, 0, 0)
        torch.autograd.grad(loss, leaves)
    p = profile_step(step, names)
    print(f"  profiled geometry-gradient step {p['wall_s']:.4f} s, device "
          f"ops {p['device_ops']}, device busy {p['device_busy_us']:.1f} us "
          f"(share {p['busy_share']:.4f}), "
          + ", ".join(f"{k} {p[k + '_us']:.1f} us" for k in names))
    check(p["MT_us"] > 0, "the MT replay ran in the profiled step")
    return p


def record_k3(rt, device):
    """The arguments of every K3 launch of one geometry-gradient step of
    rt (phase_train's loss w.r.t. tris.v0/e1/e2), recorded by wrapping
    gather.gather_rows and gather.scatter_add_rows for that step alone:
    ([(idx, tab, k)], [(idx, cot, n_rows, stride)])."""
    import torch
    from ignis_tpu_torch import loss_fn
    from ignis_tpu_torch.ops import gather
    s = rt.settings
    target = torch.zeros((s.height, s.width, 3), device=device)
    gathers, scatters = [], []
    gather_rows, scatter_add_rows = gather.gather_rows, gather.scatter_add_rows

    def rec_gather(idx, tab, k):
        gathers.append((idx.clone(), tab.detach(), k))
        return gather_rows(idx, tab, k)

    def rec_scatter(idx, cot, n_rows, stride):
        scatters.append((idx.clone(), cot.contiguous().clone(), n_rows,
                         stride))
        return scatter_add_rows(idx, cot, n_rows, stride)
    gather.gather_rows, gather.scatter_add_rows = rec_gather, rec_scatter
    try:
        scene, leaves = geometry_leaves(rt.scene)
        loss = loss_fn({"base": scene.materials.base}, scene, s, target, 0, 0)
        torch.autograd.grad(loss, leaves)
    finally:
        gather.gather_rows = gather_rows
        gather.scatter_add_rows = scatter_add_rows
    return gathers, scatters


def time_k3_launches(gathers, scatters, kernels=None, library=True):
    """Each K3 kernel's median time per recorded launch, summed over the
    launches; with `library`, beside the sum of torch.index_select
    (gather) and torch.index_add into zeros (scatter, the cotangent as
    [N, k] rows, made beforehand) on the same launches and the summed
    bound. `kernels` = (gather, scatter) replaces the wrappers timed."""
    import torch
    from ignis_tpu_torch.ops import gather
    g_fn, s_fn = kernels or (gather.gather_rows, gather.scatter_add_rows)
    out = {"gather": dict(
        launches=len(gathers), lanes=sum(i.numel() for i, _, _ in gathers),
        ms=sum(cuda_ms(lambda: g_fn(i, t, k)) for i, t, k in gathers))}
    out["scatter"] = dict(
        launches=len(scatters), lanes=sum(i.numel() for i, *_ in scatters),
        zero_lanes=sum(int((c == 0).all(0).sum()) for _, c, _, _ in scatters),
        ms=sum(cuda_ms(lambda: s_fn(i, c, t, st))
               for i, c, t, st in scatters))
    if not library:
        return out
    rows = [cot.t().contiguous() for _, cot, _, _ in scatters]
    zeros = {n_rows: torch.zeros(n_rows, cot.shape[0], device=cot.device)
             for _, cot, n_rows, _ in scatters}
    out["gather"].update(
        library_ms=sum(cuda_ms(lambda: torch.index_select(t, 0, i))
                       for i, t, _ in gathers),
        bound_ms=sum(k3_bound(i, k, t.shape[0], False)[0]
                     for i, t, k in gathers))
    out["scatter"].update(
        library_ms=sum(cuda_ms(lambda: torch.index_add(zeros[t], 0, i, r))
                       for (i, _, t, _), r in zip(scatters, rows)),
        bound_ms=sum(k3_bound(i, c.shape[0], t, True)[0]
                     for i, c, t, _ in scatters))
    return out


def phase_k3_recorded(device, runtimes):
    """K3 on the launches of one S1 and one S2 geometry-gradient step
    (record_k3): every gather equal to its plain version and every scatter
    within the reorder bar (k3_gather_result, k3_scatter_result), then the
    times of time_k3_launches. Returns {scene: {"gather": ..., "scatter":
    ...}}."""
    out = {}
    for name in ("S1_glass_ico7", "S2_graft_entry"):
        gathers, scatters = record_k3(runtimes[name], device)
        equal = [k3_gather_result(*a)[0] for a in gathers]
        check(len(gathers) > 0 and all(equal), f"{name} geometry step: all "
              f"{len(gathers)} recorded K3 gathers equal to tab[idx]")
        results = [k3_scatter_result(*a) for a in scatters]
        worst = max((r[1] for r in results), default=0.0)
        faults = [r[0] for r in results if r[0]]
        check(len(scatters) > 0 and not faults and worst <= 1.0,
              f"{name} geometry step: all {len(scatters)} recorded K3 "
              f"scatters within 1e-6 + 1e-5 sum|terms| of index_add_ (worst "
              f"ratio {worst:.4f}){'; ' + faults[0] if faults else ''}")
        row = time_k3_launches(gathers, scatters)
        for kind, t in row.items():
            print(f"  {name} geometry step, K3 {kind}: {t['launches']} "
                  f"launches, {t['lanes']} lanes, kernel {t['ms']:.4f} ms, "
                  f"library {t['library_ms']:.4f} ms, bound "
                  f"{t['bound_ms']:.4f} ms (sums)")
        out[name] = row
    return out


def phase_albedo_shape(device, s1):
    """The K3 scatter at the shape of the albedo's backward, numbers only
    (the port's albedo gather, path.gather_material, does not go through
    K3): the material ids of S1's camera hits (main_path_sets; a miss
    reads row 0's entity), T = S1's material count, K = 3, random
    cotangents; held to the reorder bar, and timed beside
    torch.zeros(T, 3).index_put_((mid,), g, accumulate=True), the
    operation behind torch's indexing_backward_kernel in the train step."""
    import torch
    from ignis_tpu_torch.ops import bvh_cuda, gather
    from ignis_tpu_torch.techniques.path import compute_surface
    sc = s1.scene
    cam, _ = main_path_sets(s1, device)["camera"]
    surf = compute_surface(sc, cam, bvh_cuda.intersect_bvh(cam, sc.tris,
                                                           sc.bvh))
    mid = sc.entities.mat[torch.clamp(surf.ent, min=0).long()].long()
    n_mat = sc.materials.base.r.numel()
    g = torch.Generator(device="cpu").manual_seed(29)
    cot = torch.randn(3, mid.numel(), generator=g).to(device)
    rows = cot.t().contiguous()
    idx = mid.to(torch.int32)
    fault, ratio, _ = k3_scatter_result(idx, cot, n_mat, 4)
    check(not fault and ratio <= 1.0, f"K3 scatter at the albedo's shape "
          f"({mid.numel()} lanes onto {n_mat} materials): within the reorder "
          f"bar (worst ratio {ratio:.4f})")
    row = dict(
        lanes=mid.numel(), materials=n_mat,
        ms=cuda_ms(lambda: gather.scatter_add_rows(idx, cot, n_mat, 4)),
        index_put_ms=cuda_ms(lambda: torch.zeros(n_mat, 3, device=device)
                             .index_put_((mid,), rows, accumulate=True)))
    row.update(zip(("bound_ms", "bound_by"), k3_bound(idx, 3, n_mat, True)))
    print(f"  K3 scatter at the albedo's shape: kernel {row['ms']:.4f} ms, "
          f"index_put_(accumulate=True) {row['index_put_ms']:.4f} ms, bound "
          f"{row['bound_ms']:.4f} ms")
    return row


def phase_grad_reference(device):
    """The albedo gradient of small_scene(64) on the card against the
    CPU's: rtol 1e-3."""
    import torch
    import ignis_tpu_torch
    from ignis_tpu_torch import loss_fn
    from ignis_tpu_torch.core.vec import Color
    grads = []
    for dev in (device, "cpu"):
        rt = ignis_tpu_torch.loadFromString(json.dumps(small_scene(64)),
                                            device=dev, spi=1)
        base = Color(*[c.detach().clone().requires_grad_()
                       for c in rt.scene.materials.base])
        target = torch.zeros((64, 64, 3), device=dev)
        loss = loss_fn({"base": base}, rt.scene, rt.settings, target, 0, 0)
        grads.append(torch.stack(torch.autograd.grad(loss, list(base)))
                     .cpu().numpy())
    gpu, cpu = grads
    print(f"  small_scene(64) albedo gradient: card {gpu.ravel().tolist()},"
          f" CPU {cpu.ravel().tolist()}")
    check(np.isfinite(gpu).all() and np.abs(cpu).max() > 0
          and np.allclose(gpu, cpu, rtol=1e-3, atol=0),
          "small_scene(64): albedo gradient on the card within rtol 1e-3 "
          "of the CPU's")


def _ico3(scene):
    s = json.loads(json.dumps(scene))
    s["shapes"][1]["subdivisions"] = 3
    return s


def main() -> int:
    import argparse
    import torch
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile-json", metavar="PATH",
                    help="also write the renders' timings and the profiled "
                         "steps' breakdown to PATH")
    args = ap.parse_args()
    print("== phase 1: device")
    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke needs one card", file=sys.stderr)
        return 1
    smi = nvidia_smi_line()
    print(smi)
    kind = torch.cuda.get_device_name(0)
    print(f"  torch.cuda.get_device_name: {kind}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    sys.path.insert(0, str(ROOT))
    import ignis_tpu_torch
    device = torch.device("cuda:0")

    print("== phase 2: build")
    phase_build()

    print("== phase 3: K2 against its plain version")
    k2_err = phase_k2(device)

    print("== loading S1-S3 on the card")
    runtimes = {}
    for name, sc, _ in SCENES:
        t0 = time.perf_counter()
        runtimes[name] = ignis_tpu_torch.loadFromString(json.dumps(sc),
                                                        spi=SPI)
        rt = runtimes[name]
        check(rt.scene.device == device, f"{name} loaded onto {device} by "
              f"default")
        print(f"  {name}: {rt.scene.tris.v0.x.numel()} triangles, "
              f"{rt.scene.spheres.radius.numel()} spheres, BVH "
              f"{'yes' if rt.scene.bvh is not None else 'no'}, loaded in "
              f"{time.perf_counter() - t0:.2f} s")

    print("== phase 4: K1 against its plain version and against K2")
    k1_err, k1_rays = phase_k1(device, runtimes["S1_glass_ico7"])
    times = phase_times(device, runtimes["S1_glass_ico7"], k1_rays)
    k1_sets, deepest = phase_k1_sets(
        device, {"S1": runtimes["S1_glass_ico7"],
                 "S3": runtimes["S3_bench_big"]})

    print("== phase 5: render S1-S3")
    counts, per_scene = phase_render(device, runtimes)
    profile = phase_profile(runtimes)

    print("== phase 6: reference checks")
    phase_reference(device)

    print("== phase 7: gradients")
    grad_errs, grad_times = phase_grad_kernels(
        device, runtimes["S1_glass_ico7"], k1_rays)
    grad_counts, train = phase_train(device, runtimes)
    train_profile = phase_train_profile(device, runtimes)
    geometry_profile = phase_geometry_profile(device,
                                              runtimes["S1_glass_ico7"])
    k3_recorded = phase_k3_recorded(device, runtimes)
    albedo = phase_albedo_shape(device, runtimes["S1_glass_ico7"])
    phase_grad_reference(device)

    def timed(t):
        ms, plain, bms, by = t
        return {"ms": ms, "plain_ms": plain, "bound_ms": bms, "bound_by": by}
    k1_sets["S1 phase-4 65,536 any hit"] = timed(times["K1_any"])
    kernels = [
        {"name": "K1_bvh_walk", "route": "cuda",
         "source": "ignis_tpu_torch/csrc/bvh_walk.cu",
         "replaces": "ignis_tpu/ops/pallas_bvh.py:74",
         "launches": counts["K1"],
         "max_abs_err": max([k1_err] + [r["max_abs_err"]
                                        for r in k1_sets.values()
                                        if "max_abs_err" in r]),
         **timed(times["K1"]), "library_ms": None, "deepest_stack": deepest,
         "sets": k1_sets},
        {"name": "K2_isect_dense", "route": "cuda",
         "source": "ignis_tpu_torch/csrc/isect_dense.cu",
         "replaces": "ignis_tpu/ops/pallas_isect.py:156",
         "launches": counts["K2"], "max_abs_err": k2_err,
         **timed(times["K2"]), "library_ms": None},
    ]
    for name, source, replaces in (
            ("K3_gather_rows", "ignis_tpu_torch/csrc/gather_cols.cu",
             "ignis_tpu/ops/gather.py:59"),
            ("K3_scatter_add_rows", "ignis_tpu_torch/csrc/gather_cols.cu",
             "ignis_tpu/ops/gather.py:121"),
            ("MT_replay_bwd", "ignis_tpu_torch/csrc/mt_replay_bwd.cu",
             "ignis_tpu/ops/pallas_isect.py:381")):
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": grad_counts[name],
                        "max_abs_err": grad_errs[name], **grad_times[name]})
    by_name = {k["name"]: k for k in kernels}
    for name, part in (("K3_gather_rows", "gather"),
                       ("K3_scatter_add_rows", "scatter")):
        by_name[name]["sets"].update({f"{scene} geometry step": row[part]
                                      for scene, row in k3_recorded.items()})
    by_name["K3_scatter_add_rows"]["sets"]["S1 albedo shape"] = albedo
    for k in kernels:
        check(k["launches"] > 0, f"{k['name']} launched on the main path")
    if args.profile_json:
        Path(args.profile_json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.profile_json).write_text(json.dumps(
            {"nvidia_smi": smi, "scenes": per_scene, "profile": profile,
             "train": train, "train_profile": train_profile,
             "geometry_profile": geometry_profile}, indent=1))
    print(json.dumps({"scenes": per_scene, "train": train,
                      "geometry_profile_us": {
                          k: v for k, v in geometry_profile.items()
                          if k.endswith("_us")}}))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
