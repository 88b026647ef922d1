#!/usr/bin/env python3
"""Drive ignis_tpu_torch's main path once on one CUDA card and check it.

Run from the root of a checkout: `python3 chip_smoke.py`. Phases, each
printing its own lines; any failure exits non-zero:

1. device: the card's name and power limit (nvidia-smi);
2. build: K1 (csrc/bvh_walk.cu), K2 (csrc/isect_dense.cu) and the native
   BVH builder, from the sources in the checkout;
3. K2 against its plain torch version on the card (random soups);
4. K1 against its plain version on S1's BVH, and against K2 brute force
   on a 20,480-triangle icosphere; kernel and plain times;
5. render S1-S3 at 512x512 through `loadFromString(..., device="cuda")`
   and `Runtime.step()`, with every kernel's launch count reset just
   before and read just after; no plain intersection may run; then one
   more step of each under torch.profiler (render/profile.py): device
   time, busy share and top device consumers of that step;
6. reference checks: the analytic point-light oracle on the card, and
   card-vs-CPU renders of small scenes;
then one JSON line of kernel results, the nvidia-smi line again, and as
the last line {"ok": true, "device": {...}}.
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


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_build():
    from ignis_tpu_torch.native import get_lib
    from ignis_tpu_torch.ops import bvh_cuda, cuda_build, isect_cuda
    t0 = time.perf_counter()
    isect_cuda.build()
    bvh_cuda.build()
    get_lib()
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
    """Median CUDA-event times of each kernel and its plain version."""
    from ignis_tpu_torch.ops import bvh_cuda, isect_cuda
    rng = np.random.default_rng(5)
    out = {}
    # K2 at S2's shape: its 2-triangle soup and 262,144 lanes
    import ignis_tpu_torch
    s2 = ignis_tpu_torch.loadFromString(json.dumps(S2_GRAFT_ENTRY),
                                        device=device)
    rays = random_rays(rng, 262144, device)
    out["K2"] = (cuda_ms(lambda: isect_cuda.intersect_tris(rays,
                                                           s2.scene.tris)),
                 cuda_ms(lambda: isect_cuda.intersect_tris_plain(
                     rays, s2.scene.tris)))
    sc = s1.scene
    out["K1"] = (cuda_ms(lambda: bvh_cuda.intersect_bvh(k1_rays, sc.tris,
                                                        sc.bvh)),
                 cuda_ms(lambda: bvh_cuda.intersect_bvh_plain(
                     k1_rays, sc.tris, sc.bvh), reps=10, warmup=1))
    vis = sc.tri_attr.shadow_visible
    out["K1_any"] = (
        cuda_ms(lambda: bvh_cuda.intersect_bvh(
            k1_rays, sc.tris, sc.bvh, any_hit=True, shadow_visible=vis)),
        cuda_ms(lambda: bvh_cuda.intersect_bvh_plain(
            k1_rays, sc.tris, sc.bvh, any_hit=True, shadow_visible=vis),
            reps=10, warmup=1))
    for k, (ms, plain) in out.items():
        print(f"  {k}: kernel {ms:.4f} ms, plain {plain:.4f} ms")
    return out


def phase_render(device, runtimes):
    """Render S1-S3 on the card; launch counts reset just before."""
    import torch
    from ignis_tpu_torch.ops import bvh_cuda, isect_cuda
    bvh_cuda.reset_overflow(device)
    isect_cuda.reset_counts()
    bvh_cuda.reset_counts()
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
    counts = {"K1": bvh_cuda.counts["launches"],
              "K2": isect_cuda.counts["launches"]}
    plain = isect_cuda.counts["plain_calls"] + bvh_cuda.counts["plain_calls"]
    check(plain == 0, f"no plain intersection call during the renders "
          f"({plain})")
    ovf = bvh_cuda.overflow_count(device)
    check(ovf == 0, f"K1 stack overflow counter {ovf} == 0")
    return counts, per_scene


def phase_profile(runtimes):
    """One profiled step per scene: device time, busy share and the top
    device consumers of that same step (render/profile.py)."""
    from ignis_tpu_torch.render.profile import profile_step
    out = {}
    for name, _, _ in SCENES:
        p = profile_step(runtimes[name], {"K1": "bvh_walk_kernel",
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
    from ignis_tpu_torch.ops import bvh_cuda, isect_cuda
    device = torch.device("cuda:0")

    print("== phase 2: build")
    phase_build()

    print("== phase 3: K2 against its plain version")
    k2_err = phase_k2(device)

    print("== loading S1-S3 on the card")
    runtimes = {}
    for name, sc, _ in SCENES:
        t0 = time.perf_counter()
        runtimes[name] = ignis_tpu_torch.loadFromString(
            json.dumps(sc), device=device, spi=SPI)
        rt = runtimes[name]
        print(f"  {name}: {rt.scene.tris.v0.x.numel()} triangles, "
              f"{rt.scene.spheres.radius.numel()} spheres, BVH "
              f"{'yes' if rt.scene.bvh is not None else 'no'}, loaded in "
              f"{time.perf_counter() - t0:.2f} s")

    print("== phase 4: K1 against its plain version and against K2")
    k1_err, k1_rays = phase_k1(device, runtimes["S1_glass_ico7"])
    times = phase_times(device, runtimes["S1_glass_ico7"], k1_rays)

    print("== phase 5: render S1-S3")
    counts, per_scene = phase_render(device, runtimes)
    profile = phase_profile(runtimes)

    print("== phase 6: reference checks")
    phase_reference(device)

    kernels = [
        {"name": "K1_bvh_walk", "route": "cuda",
         "source": "ignis_tpu_torch/csrc/bvh_walk.cu",
         "replaces": "ignis_tpu/ops/pallas_bvh.py:74",
         "launches": counts["K1"], "max_abs_err": k1_err,
         "ms": times["K1"][0], "plain_ms": times["K1"][1]},
        {"name": "K2_isect_dense", "route": "cuda",
         "source": "ignis_tpu_torch/csrc/isect_dense.cu",
         "replaces": "ignis_tpu/ops/pallas_isect.py:156",
         "launches": counts["K2"], "max_abs_err": k2_err,
         "ms": times["K2"][0], "plain_ms": times["K2"][1]},
    ]
    for k in kernels:
        check(k["launches"] > 0, f"{k['name']} launched on the main path")
    if args.profile_json:
        Path(args.profile_json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.profile_json).write_text(json.dumps(
            {"nvidia_smi": smi, "scenes": per_scene, "profile": profile},
            indent=1))
    print(json.dumps({"scenes": per_scene,
                      "K1_any_hit_ms": times["K1_any"][0],
                      "K1_any_hit_plain_ms": times["K1_any"][1]}))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
