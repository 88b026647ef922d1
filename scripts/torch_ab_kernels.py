#!/usr/bin/env python3
"""Time two revisions of ignis_tpu_torch's K1 and MT replay kernels in turns
on one CUDA card, on the main path's shapes.

    git show REV:ignis_tpu_torch/csrc/bvh_walk.cu > DIR/bvh_walk.cu
    git show REV:ignis_tpu_torch/csrc/mt_replay_bwd.cu > DIR/mt_replay_bwd.cu
    python3 scripts/torch_ab_kernels.py --old-csrc DIR [--json PATH]

The old sources are those before the packed layouts: K1 with the
structure-of-arrays C entry point (9 soup arrays, 6 box arrays and the
child array of BVHArrays), the MT replay with 9 soup-gradient arrays, each
zeroed by its own fill as its wrapper did. Both revisions are built from
source into build/ignis_tpu_torch/ and loaded into one process. Each turn
(old, new, new, old by default) swaps one revision in behind the wrappers
(ops/bvh_cuda._intersect, ops/mt_replay.mt_replay_bwd) and measures, with
chip_smoke's helpers: K1's median time per launch on phase 4's 65,536 S1
rays and on the main-path ray sets of S1 and S3; the summed K1 device time
in one profiled forward step of S1 and of S3; the MT replay's median time
on S1's contended 262,144 lanes and on a random 4,096-triangle soup; and
its summed device time in one profiled S1 geometry-gradient step. The revisions' K1 results
and per-ray replay gradients are held equal. Imports nothing of JAX.
"""
import argparse
import ctypes
import json
import statistics
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

# the structure-of-arrays entry points of the earlier K1 and MT replay
_OLD_K1_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int]
                    + [ctypes.c_void_p] * 17 + [ctypes.c_int]
                    + [ctypes.c_void_p] * 7)
_OLD_MT_ARGTYPES = [ctypes.c_void_p] * 34 + [ctypes.c_int, ctypes.c_void_p]


def load_old(csrc: Path):
    """The earlier K1 and MT replay entry points, built from `csrc`."""
    from ignis_tpu_torch.ops import cuda_build
    nvcc = cuda_build._nvcc()
    libs = {}
    for name, entry, argtypes in (
            ("bvh_walk", "ig_bvh_walk", _OLD_K1_ARGTYPES),
            ("mt_replay_bwd", "ig_mt_replay_bwd", _OLD_MT_ARGTYPES)):
        lib = cuda_build.compile_and_load(f"{name}_old", nvcc,
                                          cuda_build.NVCC_FLAGS,
                                          csrc / f"{name}.cu")
        fn = getattr(lib, entry)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        libs[name] = fn
    return libs


def old_k1_intersect(fn, overflow):
    """A drop-in for ops/bvh_cuda._intersect that launches the earlier
    K1 on BVHArrays and the soup's 9 arrays."""
    import torch
    from ignis_tpu_torch.ops import bvh_cuda, cuda_build

    @torch.no_grad()
    def _intersect(rays, soup, bvh, any_hit, shadow_visible, tri_rows):
        a = cuda_build.prepare_hit_launch("K1 (old)", rays, soup,
                                          shadow_visible, any_hit)
        if a.n:
            cuda_build.launch("K1 (old)", bvh_cuda.counts, fn, *a.rays, a.n,
                              *a.tris, a.vis,
                              *[b.data_ptr() for b in bvh[:6]],
                              bvh.child.data_ptr(), int(any_hit), *a.outs,
                              overflow.data_ptr(), a.stream)
        return a.result
    return _intersect


def old_replay(fn):
    """A drop-in for ops/mt_replay.mt_replay_bwd that launches the earlier
    replay into 9 soup-gradient arrays, each zeroed by its own fill."""
    import torch
    from ignis_tpu_torch.ops import cuda_build, mt_replay

    def mt_replay_bwd(ray_arrays, soup_arrays, prim, gt, gu, gv):
        device = prim.device
        rays = [a.contiguous() for a in ray_arrays]
        soup = [a.contiguous() for a in soup_arrays]
        cts = [a.contiguous() for a in (gt, gu, gv)]
        prim = prim.contiguous()
        ray_grads = [torch.empty_like(a) for a in rays]
        soup_grads = [torch.zeros_like(a) for a in soup]
        if prim.numel():
            cuda_build.launch(
                "MT replay (old)", mt_replay.counts, fn,
                *[a.data_ptr() for a in rays], *[a.data_ptr() for a in soup],
                prim.data_ptr(), *[a.data_ptr() for a in cts],
                *[a.data_ptr() for a in ray_grads],
                *[a.data_ptr() for a in soup_grads], prim.numel(),
                torch.cuda.current_stream(device).cuda_stream)
        return ray_grads, soup_grads
    return mt_replay_bwd


def swap_in(which, old, new):
    from ignis_tpu_torch.ops import bvh_cuda, mt_replay
    k1, mt = (old if which == "old" else new)
    bvh_cuda._intersect = k1
    mt_replay.mt_replay_bwd = mt


def k1_results(rays_sets, scenes):
    """Every set's K1 result under the revision swapped in."""
    from ignis_tpu_torch.ops import bvh_cuda
    out = {}
    for key, (scene_name, rays, any_hit) in rays_sets.items():
        sc = scenes[scene_name].scene
        vis = sc.tri_attr.shadow_visible if any_hit else None
        out[key] = bvh_cuda.intersect_bvh(rays, sc.tris, sc.bvh, any_hit, vis)
    return out


def turn(which, revisions, rays_sets, scenes, replay_sets, device):
    import torch
    from ignis_tpu_torch.ops import bvh_cuda, mt_replay
    from ignis_tpu_torch.render.profile import profile_step
    swap_in(which, *revisions)
    row = {"which": which, "k1_ms": {}, "replay_ms": {}}
    for key, (scene_name, rays, any_hit) in rays_sets.items():
        sc = scenes[scene_name].scene
        vis = sc.tri_attr.shadow_visible if any_hit else None
        rows = bvh_cuda.pack_tris(sc.tris)
        row["k1_ms"][key] = cs.cuda_ms(lambda: bvh_cuda.intersect_bvh(
            rays, sc.tris, sc.bvh, any_hit, vis, tri_rows=rows))
    for name in ("S1_glass_ico7", "S3_bench_big"):
        p = profile_step(scenes[name].step, {"K1": "bvh_walk_kernel"})
        row[f"{name} forward"] = {k: p[k] for k in
                                  ("wall_s", "device_busy_us", "K1_us")}
    for key, (ra, sa, prim, cts) in replay_sets.items():
        row["replay_ms"][key] = cs.cuda_ms(
            lambda: mt_replay.mt_replay_bwd(ra, sa, prim, *cts))
    s1 = scenes["S1_glass_ico7"]
    s = s1.settings
    target = torch.zeros((s.height, s.width, 3), device=device)

    def geometry_step():
        from ignis_tpu_torch import loss_fn
        scene, leaves = cs.geometry_leaves(s1.scene)
        loss = loss_fn({"base": scene.materials.base}, scene, s, target, 0,
                       0)
        torch.autograd.grad(loss, leaves)
    p = profile_step(geometry_step, {"MT": "mt_replay_bwd_kernel"})
    row["S1 geometry"] = {k: p[k] for k in
                          ("wall_s", "device_busy_us", "MT_us")}
    print(json.dumps(row), flush=True)
    return row


def main() -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old-csrc", type=Path, required=True,
                    help="directory with the earlier bvh_walk.cu and "
                         "mt_replay_bwd.cu")
    ap.add_argument("--turns", default="old,new,new,old")
    ap.add_argument("--json", type=Path, help="also write the turns here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    smi = cs.nvidia_smi_line()
    print(smi)
    import ignis_tpu_torch
    from ignis_tpu_torch.ops import bvh_cuda, isect_cuda, mt_replay
    device = torch.device("cuda:0")
    cs.phase_build()
    old_libs = load_old(args.old_csrc)
    overflow = torch.zeros(1, dtype=torch.int32, device=device)
    old = (old_k1_intersect(old_libs["bvh_walk"], overflow),
           old_replay(old_libs["mt_replay_bwd"]))
    new = (bvh_cuda._intersect, mt_replay.mt_replay_bwd)

    scenes = {name: ignis_tpu_torch.loadFromString(json.dumps(sc),
                                                   device=device, spi=cs.SPI)
              for name, sc, kernel in cs.SCENES if kernel == "K1"}
    s1 = scenes["S1_glass_ico7"]
    rng = np.random.default_rng(11)
    half = 65536 // 2
    k1_rays = cs.cat_rays(cs.camera_rays(s1.scene, s1.settings, half, device),
                          cs.random_rays(rng, half, device, extent=1.5))
    rays_sets = {"S1 phase-4 65,536": ("S1_glass_ico7", k1_rays, False),
                 "S1 phase-4 65,536 any hit": ("S1_glass_ico7", k1_rays,
                                               True)}
    for short, name in (("S1", "S1_glass_ico7"), ("S3", "S3_bench_big")):
        for set_name, (rays, any_hit) in cs.main_path_sets(
                scenes[name], device).items():
            rays_sets[f"{short} {set_name}"] = (name, rays, any_hit)

    n = 262144
    g = torch.Generator(device="cpu").manual_seed(3)
    cts = [torch.randn(n, generator=g).to(device) for _ in range(3)]
    contended = cs.cat_rays(cs.camera_rays(s1.scene, s1.settings, n // 2,
                                           device),
                            cs.random_rays(rng, n // 2, device, extent=1.5))
    soup, _ = cs.random_soup(rng, 4096, device)
    spread = cs.random_rays(rng, n, device)
    t = s1.scene.tris
    replay_sets = {
        "S1 contended": ([*contended.org, *contended.dir],
                         [*t.v0, *t.e1, *t.e2],
                         bvh_cuda.intersect_bvh(contended, t,
                                                s1.scene.bvh).prim, cts),
        "random soup": ([*spread.org, *spread.dir],
                        [*soup.v0, *soup.e1, *soup.e2],
                        isect_cuda.intersect_tris(spread, soup).prim, cts)}

    # the two revisions agree: K1 results equal, per-ray gradients equal
    results = {}
    grads = {}
    for which in ("old", "new"):
        swap_in(which, old, new)
        results[which] = k1_results(rays_sets, scenes)
        grads[which] = {k: mt_replay.mt_replay_bwd(*v[:3], *v[3])[0]
                        for k, v in replay_sets.items()}
        for name in scenes:                       # warm-up step
            scenes[name].step()
    for key in rays_sets:
        a, b = results["old"][key], results["new"][key]
        same = (torch.equal(a, b) if isinstance(a, torch.Tensor)
                else all(torch.equal(x, y) for x, y in zip(a, b)))
        cs.check(same, f"K1 {key}: old and new results equal")
    for key in replay_sets:
        cs.check(all(torch.equal(x, y) for x, y in
                     zip(grads["old"][key], grads["new"][key])),
                 f"MT replay {key}: old and new per-ray gradients equal")
    cs.check(int(overflow.item()) == 0, "old K1 dropped no push")

    rows = [turn(which, (old, new), rays_sets, scenes, replay_sets, device)
            for which in args.turns.split(",")]
    swap_in("new", old, new)
    summary = {"nvidia_smi": smi}
    for which in ("old", "new"):
        mine = [r for r in rows if r["which"] == which]
        summary[which] = {
            "k1_ms": {k: statistics.median(r["k1_ms"][k] for r in mine)
                      for k in rays_sets},
            "replay_ms": {k: statistics.median(r["replay_ms"][k]
                                               for r in mine)
                          for k in replay_sets},
            **{f"{name} {k}": statistics.median(r[name][k] for r in mine)
               for name, k in (("S1_glass_ico7 forward", "K1_us"),
                               ("S3_bench_big forward", "K1_us"),
                               ("S1 geometry", "MT_us"))}}
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps({"turns": rows, **summary},
                                        indent=1))
    print(json.dumps(summary))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
