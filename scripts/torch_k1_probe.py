#!/usr/bin/env python3
"""Where K1's time goes on the main path's camera rays, by kind of ray.

    python3 scripts/torch_k1_probe.py [--json PATH]

On one CUDA card, for S1 and S3 of chip_smoke.py: the camera rays of
chip_smoke.main_path_sets split by what they hit (nothing, or the entity
they hit), each kind tiled in order to the film's 262,144 rays, and the
whole set; for each, K1's median time per launch and its node visits per
ray. Visits are counted by a second build of csrc/bvh_walk.cu in which the
deepest-stack counter (counters[1]) sums visits instead; the walk itself is
the same. Also the visits per live ray of the secondary and shadow sets.
Imports nothing of JAX.
"""
import argparse
import ctypes
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

# the deepest-stack bookkeeping of csrc/bvh_walk.cu and its visit-counting
# replacement
_DEEPEST = (
    """            node = visit<ANY_HIT>(ray, node, nodes, tris, vis, stk, sp, best_t,
                                  best_u, best_v, best_p, occ, deepest,
                                  counters);""",
    """            int unused = 0;
            node = visit<ANY_HIT>(ray, node, nodes, tris, vis, stk, sp, best_t,
                                  best_u, best_v, best_p, occ, unused,
                                  counters);
            ++deepest;""")
_REDUCE = (
    """    const int warp_deepest = __reduce_max_sync(FULL, deepest);
    if (lane == 0 && warp_deepest > 0)
        atomicMax(counters + 1, warp_deepest);""",
    """    const int warp_visits = __reduce_add_sync(FULL, deepest);
    if (lane == 0)
        atomicAdd(counters + 1, warp_visits);""")


def visit_counting_kernel():
    """The K1 entry point of a build that counts visits in counters[1]."""
    from ignis_tpu_torch.ops import bvh_cuda, cuda_build
    src = (cuda_build.CSRC / "bvh_walk.cu").read_text()
    for old, new in (_DEEPEST, _REDUCE):
        if old not in src:
            raise RuntimeError("csrc/bvh_walk.cu changed: update the probe")
        src = src.replace(old, new)
    path = cuda_build.BUILD_DIR / "bvh_walk_visits.cu"
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path.write_text(src)
    lib = cuda_build.compile_and_load("bvh_walk_visits", cuda_build._nvcc(),
                                      cuda_build.NVCC_FLAGS, path)
    fn = lib.ig_bvh_walk
    fn.argtypes, fn.restype = bvh_cuda._ARGTYPES, ctypes.c_int
    return fn


def main() -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", type=Path, help="also write the results here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    smi = cs.nvidia_smi_line()
    print(smi)
    import ignis_tpu_torch
    from ignis_tpu_torch.core.vec import Vec3
    from ignis_tpu_torch.ops import bvh_cuda
    from ignis_tpu_torch.ops.intersect import Rays
    device = torch.device("cuda:0")
    kernel = bvh_cuda._kernel
    counting = visit_counting_kernel()

    def run(rays, sc, rows, any_hit=False):
        """(median ms of the kernel, visits summed by the counting build)"""
        vis = sc.tri_attr.shadow_visible if any_hit else None
        call = lambda: bvh_cuda.intersect_bvh(  # noqa: E731
            rays, sc.tris, sc.bvh, any_hit, vis, tri_rows=rows)
        bvh_cuda._kernel = kernel
        ms = cs.cuda_ms(call)
        bvh_cuda._kernel = lambda: counting
        bvh_cuda.reset_overflow(device)
        call()
        visits = bvh_cuda.deepest_stack(device)
        bvh_cuda._kernel = kernel
        return ms, visits

    def tiled(rays, idx, n):
        take = idx[torch.arange(n, device=device) % idx.numel()]
        g = lambda a: a[take].contiguous()  # noqa: E731
        return Rays(Vec3(*[g(a) for a in rays.org]),
                    Vec3(*[g(a) for a in rays.dir]), g(rays.tmin),
                    g(rays.tmax))

    out = {"nvidia_smi": smi}
    for short, name, scene in (("S1", "S1_glass_ico7", cs.S1_GLASS_ICO7),
                               ("S3", "S3_bench_big", cs.S3_BENCH_BIG)):
        rt = ignis_tpu_torch.loadFromString(json.dumps(scene), device=device,
                                            spi=cs.SPI)
        sc = rt.scene
        rows = bvh_cuda.pack_tris(sc.tris)
        sets = cs.main_path_sets(rt, device)
        cam = sets["camera"][0]
        n = cam.tmin.numel()
        hit = bvh_cuda.intersect_bvh(cam, sc.tris, sc.bvh, tri_rows=rows)
        ent = torch.where(hit.prim >= 0,
                          sc.tri_attr.ent[hit.prim.clamp(min=0).long()], -1)
        kinds = {"all": torch.arange(n, device=device)}
        for e in torch.unique(ent).tolist():
            kinds["miss" if e < 0 else f"entity {e}"] = (ent == e).nonzero(
                ).flatten()
        for kind, idx in kinds.items():
            ms, visits = run(tiled(cam, idx, n), sc, rows)
            row = {"share": idx.numel() / n, "ms": ms,
                   "visits_per_ray": visits / n}
            out[f"{short} camera {kind}"] = row
            print(f"  {short} camera {kind}: {row}")
        for set_name in ("secondary", "shadow"):
            rays, any_hit = sets[set_name]
            live = int((rays.tmax >= rays.tmin).sum())
            ms, visits = run(rays, sc, rows, any_hit)
            row = {"ms": ms, "live": live,
                   "visits_per_live_ray": visits / max(live, 1)}
            out[f"{short} {set_name}"] = row
            print(f"  {short} {set_name}: {row}")
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(out, indent=1))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
