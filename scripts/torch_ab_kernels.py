#!/usr/bin/env python3
"""Time two revisions of ignis_tpu_torch's kernels in turns on one CUDA
card, on the main path's shapes.

    git show REV:ignis_tpu_torch/csrc/isect_dense.cu > DIR/isect_dense.cu
    python3 scripts/torch_ab_kernels.py --old-csrc DIR [--crossover] \
        [--json PATH]

Each kernel whose earlier source DIR holds is compared; both revisions are
built from source into build/ignis_tpu_torch/ and loaded into one process,
and each turn (old, new, new, old by default) swaps one revision in behind
its own wrapper and measures with chip_smoke's helpers.

- K2 (DIR/isect_dense.cu, the source before the packed soup: the
  structure-of-arrays C entry point with 9 soup arrays, which reads no
  pack), swapped in behind ops/isect_cuda._intersect: its median time per
  launch on the main-path sets of S2 and S4 (k2_sets) and on 262,144
  random rays against random soups of 2, 32, 128, 322 and 511 triangles,
  closest and any hit, each soup packed beforehand for the new kernel;
  the summed K2 device time of one profiled forward step of S2 and of S4.
  The revisions' results are held equal on every set.

- K3 (DIR/gather_cols.cu, the source before the column layout: [N, K]
  rows out of an unpadded [T, K] table, one element per thread): its
  gather and scatter-add timed per launch and summed (time_k3_launches) on
  262,144 random rows of S1's attribute table and on every launch of one
  recorded S1 and one S2 geometry-gradient step (record_k3), each
  revision fed its own layout, made beforehand. The revisions' gathers are
  held equal and their scatters within the reorder bar of each other.
- K1 and the MT replay (DIR/bvh_walk.cu and DIR/mt_replay_bwd.cu, the
  sources before the packed layouts: K1 with the structure-of-arrays C
  entry point, 9 soup arrays, 6 box arrays and the child array of
  BVHArrays; the MT replay with 9 soup-gradient arrays, each zeroed by its
  own fill as its wrapper did), swapped in behind ops/bvh_cuda._intersect
  and ops/mt_replay.mt_replay_bwd: K1's median time per launch on phase
  4's 65,536 S1 rays and on the main-path ray sets of S1 and S3; the
  summed K1 device time in one profiled forward step of S1 and of S3; the
  MT replay's median time on S1's contended 262,144 lanes and on a random
  4,096-triangle soup; and its summed device time in one profiled S1
  geometry-gradient step. The revisions' K1 results and per-ray replay
  gradients are held equal.

`--crossover` also times K1 against K2 on the main-path sets of S1's
scene with the icosphere at subdivisions 0-4 (22 to 5,122 triangles), K1
over a BVH from the port's builder (crossover).

Imports nothing of JAX.
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
# the earlier K3: idx, table or cotangent, output; n, k, t; stream
_OLD_K3_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
    ctypes.c_void_p]
# the earlier K2: 8 ray arrays, n, 9 soup arrays, shadow mask, T, any_hit,
# 5 outputs, stream
_OLD_K2_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int]
                    + [ctypes.c_void_p] * 10 + [ctypes.c_int] * 2
                    + [ctypes.c_void_p] * 6)


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


def ab_k1_replay(csrc, turns, device):
    """K1 and the MT replay, old against new (module docstring)."""
    import torch
    import ignis_tpu_torch
    from ignis_tpu_torch.ops import bvh_cuda, isect_cuda, mt_replay
    old_libs = load_old(csrc)
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
            for which in turns]
    swap_in("new", old, new)
    summary = {}
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
    return {"turns": rows, **summary}


def load_old_k3(csrc: Path):
    """The earlier K3 as drop-ins with its own layout: gather(idx, tab)
    with tab [T, K] -> [N, K]; scatter(idx, rows, n_rows) with rows
    [N, K] -> [n_rows, K] from zeros."""
    import torch
    from ignis_tpu_torch.ops import cuda_build
    lib = cuda_build.compile_and_load("gather_cols_old", cuda_build._nvcc(),
                                      cuda_build.NVCC_FLAGS,
                                      csrc / "gather_cols.cu")
    fns = {}
    for entry in ("ig_gather_rows", "ig_scatter_add_rows"):
        fns[entry] = getattr(lib, entry)
        fns[entry].argtypes = _OLD_K3_ARGTYPES
        fns[entry].restype = ctypes.c_int
    counts = cuda_build.Counts()

    def gather(idx, tab):
        n, (t, k) = idx.numel(), tab.shape
        out = torch.empty((n, k), dtype=torch.float32, device=idx.device)
        cuda_build.launch("K3 gather (old)", counts, fns["ig_gather_rows"],
                          idx.data_ptr(), tab.data_ptr(), out.data_ptr(), n,
                          k, t, torch.cuda.current_stream().cuda_stream)
        return out

    def scatter(idx, rows, n_rows):
        n, k = rows.shape
        dtab = torch.zeros((n_rows, k), dtype=torch.float32,
                           device=idx.device)
        cuda_build.launch("K3 scatter (old)", counts,
                          fns["ig_scatter_add_rows"], idx.data_ptr(),
                          rows.data_ptr(), dtab.data_ptr(), n, k, n_rows,
                          torch.cuda.current_stream().cuda_stream)
        return dtab
    return gather, scatter


def ab_k3(csrc, turns, device):
    """K3, old against new (module docstring)."""
    import torch
    import ignis_tpu_torch
    from ignis_tpu_torch.ops import gather
    from ignis_tpu_torch.techniques.path import ATTR_COLS, attr_table
    old_gather, old_scatter = load_old_k3(csrc)
    scenes = {name: ignis_tpu_torch.loadFromString(json.dumps(sc),
                                                   device=device, spi=cs.SPI)
              for name, sc, _ in cs.SCENES if name != "S3_bench_big"}
    tab = attr_table(scenes["S1_glass_ico7"].scene)
    n = 262144
    g = torch.Generator(device="cpu").manual_seed(3)
    idx = torch.randint(0, tab.shape[0], (n,), generator=g,
                        dtype=torch.int32).to(device)
    cot = torch.randn(ATTR_COLS, n, generator=g).to(device)
    sets = {"random": ([(idx, tab, ATTR_COLS)],
                       [(idx, cot, *tab.shape)])}
    for name in scenes:
        sets[f"{name} geometry step"] = cs.record_k3(scenes[name], device)

    # each revision's layout, made beforehand: the old kernel reads the
    # unpadded table and the cotangent as [N, K] rows
    tables, rows = {}, {}
    for gathers, scatters in sets.values():
        for _, t, k in gathers:
            tables.setdefault(t.data_ptr(), t[:, :k].contiguous())
        for _, c, _, _ in scatters:
            rows[c.data_ptr()] = c.t().contiguous()
    old = (lambda i, t, k: old_gather(i, tables[t.data_ptr()]),
           lambda i, c, t, st: old_scatter(i, rows[c.data_ptr()], t))
    new = (gather.gather_rows, gather.scatter_add_rows)

    for name, (gathers, scatters) in sets.items():
        worst = 0.0
        same = all(torch.equal(new[0](i, t, k), old[0](i, t, k).t())
                   for i, t, k in gathers)
        cs.check(same, f"K3 {name}: old and new gathers equal")
        for i, c, t, st in scatters:
            a = new[1](i, c, t, st)[:, :c.shape[0]]
            worst = max(worst, cs.reorder_ratio(a, old[1](i, c, t, st),
                                                i.long(), rows[c.data_ptr()],
                                                1e-5))
        cs.check(worst <= 1.0, f"K3 {name}: old and new scatters within "
                 f"1e-6 + 1e-5 sum|terms| of each other (worst ratio "
                 f"{worst:.4f})")
    # the library calls on each layout: index_select on the padded table
    # (time_k3_launches) and on the unpadded one that the old kernel reads
    library = {name: cs.time_k3_launches(*v) for name, v in sets.items()}
    for name, (gathers, _) in sets.items():
        library[name]["gather"]["library_unpadded_ms"] = sum(
            cs.cuda_ms(lambda: torch.index_select(tables[t.data_ptr()], 0, i))
            for i, t, _ in gathers)
    turn_rows = []
    for which in turns:
        fns = old if which == "old" else new
        row = {"which": which}
        for name, (gathers, scatters) in sets.items():
            t = cs.time_k3_launches(gathers, scatters, fns, library=False)
            row[name] = {"gather_ms": t["gather"]["ms"],
                         "scatter_ms": t["scatter"]["ms"]}
        print(json.dumps(row), flush=True)
        turn_rows.append(row)
    summary = {"library_and_bound": library}
    for which in ("old", "new"):
        mine = [r for r in turn_rows if r["which"] == which]
        summary[which] = {name: {k: statistics.median(r[name][k]
                                                      for r in mine)
                                 for k in ("gather_ms", "scatter_ms")}
                          for name in sets}
    return {"turns": turn_rows, **summary}


def old_k2_intersect(csrc: Path):
    """A drop-in for ops/isect_cuda._intersect that launches the earlier
    K2, built from `csrc`, on the soup's 9 arrays (it takes no pack)."""
    import torch
    from ignis_tpu_torch.ops import cuda_build, isect_cuda
    lib = cuda_build.compile_and_load("isect_dense_old", cuda_build._nvcc(),
                                      cuda_build.NVCC_FLAGS,
                                      csrc / "isect_dense.cu")
    fn = lib.ig_isect_dense
    fn.argtypes, fn.restype = _OLD_K2_ARGTYPES, ctypes.c_int

    @torch.no_grad()
    def _intersect(rays, soup, shadow_visible, any_hit, packed):
        a = cuda_build.prepare_hit_launch("K2 (old)", rays, soup,
                                          shadow_visible, any_hit)
        if a.n:
            cuda_build.launch("K2 (old)", isect_cuda.counts, fn, *a.rays,
                              a.n, *a.tris, a.vis, a.n_tris, int(any_hit),
                              *a.outs, a.stream)
        return a.result
    return _intersect


def k2_sets(scenes, device):
    """K2's A/B sets: {name: (soup, rays, any_hit, shadow mask, pack)}:
    the main-path sets of S2 and S4, and 262,144 random rays against
    random soups of 2, 32, 128, 322 and 511 triangles, closest and any
    hit; each soup packed beforehand, as the main path packs it."""
    from ignis_tpu_torch.ops import isect_cuda
    sets = {}
    for short, name, light in (("S2", "S2_graft_entry", cs.S2_LIGHT),
                               ("S4", "S4_glass_ico2", cs.S1_LIGHT)):
        sc = scenes[name].scene
        pack = isect_cuda.pack_soup(sc.tris)
        for set_name, (rays, any_hit) in cs.main_path_sets(
                scenes[name], device, light).items():
            sets[f"{short} {set_name}"] = (
                sc.tris, rays, any_hit,
                sc.tri_attr.shadow_visible if any_hit else None, pack)
    rng = np.random.default_rng(7)
    rays = cs.random_rays(rng, 262144, device)
    for n_tris in (2, 32, 128, 322, 511):
        soup, vis = cs.random_soup(rng, n_tris, device)
        pack = isect_cuda.pack_soup(soup)
        sets[f"random T={n_tris}"] = (soup, rays, False, None, pack)
        sets[f"random T={n_tris} any hit"] = (soup, rays, True, vis, pack)
    return sets


def ab_k2(csrc, turns, device):
    """K2, old against new: each set's median time per launch, and the
    summed K2 device time of one profiled forward step of S2 and of S4.
    The revisions' results are held equal on every set."""
    import torch
    import ignis_tpu_torch
    from ignis_tpu_torch.ops import isect_cuda
    from ignis_tpu_torch.render.profile import profile_step
    revisions = {"old": old_k2_intersect(csrc), "new": isect_cuda._intersect}
    scenes = {name: ignis_tpu_torch.loadFromString(json.dumps(sc),
                                                   device=device, spi=cs.SPI)
              for name, sc, kernel in cs.SCENES if kernel == "K2"}
    sets = k2_sets(scenes, device)

    def call(v):
        soup, rays, any_hit, vis, pack = v
        return isect_cuda.intersect_tris(rays, soup, vis, any_hit,
                                         packed=pack)
    results = {}
    for which, fn in revisions.items():
        isect_cuda._intersect = fn
        results[which] = {k: call(v) for k, v in sets.items()}
        for rt in scenes.values():                 # warm-up step
            rt.step()
    for key in sets:
        a, b = results["old"][key], results["new"][key]
        same = (torch.equal(a, b) if isinstance(a, torch.Tensor)
                else all(torch.equal(x, y) for x, y in zip(a, b)))
        cs.check(same, f"K2 {key}: old and new results equal")
    rows = []
    for which in turns:
        isect_cuda._intersect = revisions[which]
        row = {"which": which, "k2_ms": {k: cs.cuda_ms(lambda: call(v))
                                         for k, v in sets.items()}}
        for name, rt in scenes.items():
            p = profile_step(rt.step, {"K2": "isect_dense_kernel"})
            row[f"{name} forward"] = {k: p[k] for k in
                                      ("wall_s", "device_busy_us", "K2_us")}
        print(json.dumps(row), flush=True)
        rows.append(row)
    isect_cuda._intersect = revisions["new"]
    summary = {"turns": rows}
    for which in ("old", "new"):
        mine = [r for r in rows if r["which"] == which]
        summary[which] = {
            "k2_ms": {k: statistics.median(r["k2_ms"][k] for r in mine)
                      for k in sets},
            **{f"{name} forward K2_us": statistics.median(
                r[f"{name} forward"]["K2_us"] for r in mine)
               for name in scenes}}
    summary["sets"] = {}
    for key, (soup, rays, any_hit, vis, pack) in sets.items():
        res = results["new"][key]
        n_tris = soup.v0.x.numel()
        summary["sets"][key] = {
            "tris": n_tris, "rays": rays.tmin.numel(),
            "live": int((rays.tmax >= rays.tmin).sum()),
            "bound_ms": cs.k2_bound(rays, res, n_tris, any_hit)[0],
            "dense_ms": cs.dense_bound(rays.tmin.numel(), n_tris)[0]}
    return summary


def bvh_of(soup, device):
    """A BVH of `soup` from the port's builder: (the soup in the BVH's
    order, BVHArrays, the order as a tensor)."""
    import torch
    from ignis_tpu_torch.bvh.builder import build_bvh8
    from ignis_tpu_torch.core.vec import Vec3
    from ignis_tpu_torch.ops.bvh import BVHArrays
    from ignis_tpu_torch.ops.intersect import TriSoup
    arrays = [torch.stack(tuple(v), 1).cpu().numpy()
              for v in (soup.v0, soup.e1, soup.e2)]
    b = build_bvh8(*arrays)
    order = torch.from_numpy(b.prim_order.astype(np.int64)).to(device)
    perm = TriSoup(*[Vec3(*[c[order].contiguous() for c in v])
                     for v in (soup.v0, soup.e1, soup.e2)])
    bvh = BVHArrays(*[torch.from_numpy(np.ascontiguousarray(a)).to(device)
                      for a in (b.cmin_x, b.cmin_y, b.cmin_z, b.cmax_x,
                                b.cmax_y, b.cmax_z, b.child)])
    return perm, bvh, order


def crossover(device, subdivisions=(0, 1, 2, 3, 4)):
    """K1 (a BVH from the port's builder over the soup) against K2 (the
    soup packed) on the main-path sets of S1's scene with the icosphere
    at each subdivision: median time of each, and how far their results
    agree (prims compared through the BVH's order; equal-t ties may take
    another triangle, as each keeps its own lowest id)."""
    import torch
    import ignis_tpu_torch
    from ignis_tpu_torch.ops import bvh_cuda, isect_cuda
    out = {}
    for sub in subdivisions:
        scene = json.loads(json.dumps(cs.S1_GLASS_ICO7))
        scene["shapes"][1]["subdivisions"] = sub
        rt = ignis_tpu_torch.loadFromString(json.dumps(scene), device=device,
                                            spi=cs.SPI)
        soup, vis = rt.scene.tris, rt.scene.tri_attr.shadow_visible
        perm, bvh, order = bvh_of(soup, device)
        rows, pack = bvh_cuda.pack_tris(perm), isect_cuda.pack_soup(soup)
        for set_name, (rays, any_hit) in cs.main_path_sets(rt,
                                                           device).items():
            def k1():
                return bvh_cuda.intersect_bvh(
                    rays, perm, bvh, any_hit, vis[order] if any_hit else None,
                    tri_rows=rows)

            def k2():
                return isect_cuda.intersect_tris(
                    rays, soup, vis if any_hit else None, any_hit,
                    packed=pack)
            a, b = k1(), k2()
            if any_hit:
                agree = float((a == b).float().mean())
            else:
                mapped = torch.where(a.prim >= 0,
                                     order[a.prim.clamp(min=0).long()], -1)
                agree = float((mapped == b.prim).float().mean())
            row = {"tris": soup.v0.x.numel(), "k1_ms": cs.cuda_ms(k1),
                   "k2_ms": cs.cuda_ms(k2), "agreement": agree}
            print(f"  crossover sub {sub} ({row['tris']} tris) {set_name}: "
                  f"K1 {row['k1_ms']:.4f} ms, K2 {row['k2_ms']:.4f} ms, "
                  f"agreement {agree:.6f}", flush=True)
            out[f"sub {sub} {set_name}"] = row
    return out


def main() -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old-csrc", type=Path,
                    help="directory with the earlier isect_dense.cu, "
                         "gather_cols.cu and/or bvh_walk.cu and "
                         "mt_replay_bwd.cu")
    ap.add_argument("--crossover", action="store_true",
                    help="also time K1 against K2 on S1's scene at "
                         "icosphere subdivisions 0-4")
    ap.add_argument("--turns", default="old,new,new,old")
    ap.add_argument("--json", type=Path, help="also write the turns here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    smi = cs.nvidia_smi_line()
    print(smi)
    device = torch.device("cuda:0")
    cs.phase_build()
    turns = args.turns.split(",")
    summary = {"nvidia_smi": smi}
    old = args.old_csrc
    if old and (old / "isect_dense.cu").exists():
        summary["K2"] = ab_k2(old, turns, device)
    if old and (old / "gather_cols.cu").exists():
        summary["K3"] = ab_k3(old, turns, device)
    if old and (old / "bvh_walk.cu").exists():
        summary["K1, MT replay"] = ab_k1_replay(old, turns, device)
    if args.crossover:
        summary["K1/K2 crossover"] = crossover(device)
    if len(summary) == 1:
        print(f"no earlier source in {old} and no --crossover",
              file=sys.stderr)
        return 1
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(summary, indent=1))
    print(json.dumps({k: ({w: v[w] for w in ("old", "new")}
                          if "old" in v else v)
                      for k, v in summary.items() if k != "nvidia_smi"}))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
