"""K1 (BVH8 walk) against ignis_tpu: the plain lockstep walk on the
bridged icosphere scene of tests/test_bvh.py:271-283, held against the XLA
walk on `bvh.tri` and the Pallas kernel (interpret mode) on `bvh.chunk`;
the port's own BVH against brute force; the kernel's packed layouts
(node records, triangle rows) against the arrays they come from, and its
nearest-first walk, step for step in numpy, against the plain walk. The
CUDA kernel itself is checked on the card (tests/test_torch_cuda.py,
chip_smoke.py)."""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ignis_tpu
import ignis_tpu_torch
from ignis_tpu.core.vec import Vec3 as JVec3
from ignis_tpu.ops.bvh import intersect_bvh
from ignis_tpu.ops.intersect import Rays as JRays
from ignis_tpu.ops.pallas_bvh import intersect_bvh_pallas
from ignis_tpu_torch.bridge import from_reference
from ignis_tpu_torch.bvh.builder import decode_leaf
from ignis_tpu_torch.core.vec import Vec3
from ignis_tpu_torch.ops import bvh_cuda, isect_cuda
from ignis_tpu_torch.ops.intersect import Rays

from test_compaction import SCENE as COMPACTION_SCENE

# The tensors here are small; one intra-op thread per test process keeps
# parallel test workers from oversubscribing the cores.
torch.set_num_threads(1)

ICO_SCENE = {
    "technique": {"type": "path"},
    "camera": {"type": "perspective", "fov": 60,
               "transform": [1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, -4,
                             0, 0, 0, 1]},
    "film": {"size": [32, 32]},
    "bsdfs": [{"type": "diffuse", "name": "w"}],
    "shapes": [{"type": "icosphere", "name": "s", "radius": 1.2,
                "subdivisions": 5}],
    "entities": [{"name": "s", "shape": "s", "bsdf": "w"}],
    "lights": [{"type": "env", "name": "e", "radiance": 1.0}],
}


@pytest.fixture(scope="module")
def ico():
    rt = ignis_tpu.loadFromString(json.dumps(ICO_SCENE))
    scene, _ = from_reference(rt.scene, rt.settings, "cpu")
    rng = np.random.default_rng(2)
    n = 500
    o = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    jrays = JRays(JVec3(*[jnp.asarray(o[:, i]) for i in range(3)]),
                  JVec3(*[jnp.asarray(d[:, i]) for i in range(3)]),
                  jnp.zeros(n), jnp.full(n, 1e30))
    trays = Rays(Vec3(*[torch.from_numpy(o[:, i].copy()) for i in range(3)]),
                 Vec3(*[torch.from_numpy(d[:, i].copy()) for i in range(3)]),
                 torch.zeros(n), torch.full((n,), 1e30))
    return rt.scene, scene, jrays, trays


def test_plain_walk_matches_xla_walk(ico):
    """Same lockstep walk, stack and tie break as ops/bvh.py: the same
    hits, t within rtol 1e-6."""
    jsc, sc, jrays, trays = ico
    assert sc.bvh is not None and sc.tris.v0.x.shape[0] > 2048
    ref = intersect_bvh(jrays, jsc.tris, jsc.bvh.tri)
    got = bvh_cuda.intersect_bvh_plain(trays, sc.tris, sc.bvh)
    np.testing.assert_array_equal(got.prim.numpy(), np.asarray(ref.prim))
    np.testing.assert_allclose(got.t.numpy(), np.asarray(ref.t), rtol=1e-6)
    vis = sc.tri_attr.shadow_visible
    occ = bvh_cuda.intersect_bvh_plain(trays, sc.tris, sc.bvh, any_hit=True,
                                       shadow_visible=vis)
    occ_ref = intersect_bvh(jrays, jsc.tris, jsc.bvh.tri, any_hit=True,
                            shadow_visible=jsc.tri_attr.shadow_visible)
    np.testing.assert_array_equal(occ.numpy(), np.asarray(occ_ref))


def test_plain_walk_matches_pallas_interpret(ico):
    """Against the chunked-leaf Pallas kernel: bars of
    tests/test_bvh.py:298-305 (its packed key and 1e-9 epsilon break
    near-ties differently)."""
    jsc, sc, jrays, trays = ico
    h_chunk = intersect_bvh_pallas(jrays, jsc.tris, jsc.bvh.chunk,
                                   interpret=True)
    got = bvh_cuda.intersect_bvh_plain(trays, sc.tris, sc.bvh)
    pt, pc = got.prim.numpy(), np.asarray(h_chunk.prim)
    assert ((pt >= 0) == (pc >= 0)).mean() > 0.995
    m = (pt >= 0) & (pc >= 0)
    assert m.sum() > 30
    assert np.allclose(np.asarray(h_chunk.t)[m], got.t.numpy()[m], rtol=1e-4)
    occ_chunk = intersect_bvh_pallas(jrays, jsc.tris, jsc.bvh.chunk,
                                     any_hit=True, interpret=True)
    occ = bvh_cuda.intersect_bvh_plain(trays, sc.tris, sc.bvh, any_hit=True)
    assert (occ.numpy() == np.asarray(occ_chunk)).mean() > 0.995


@pytest.fixture(scope="module")
def own_ico():
    rt = ignis_tpu_torch.loadFromString(json.dumps(ICO_SCENE), device="cpu")
    return rt.scene


def test_own_bvh_covers_every_triangle_once(own_ico):
    """The port's native-built BVH8: every triangle in exactly one leaf of
    at most 4, child references in range (tests/test_bvh.py:104-131)."""
    child = own_ico.bvh.child.numpy()
    n = own_ico.tris.v0.x.shape[0]
    cover = np.zeros(n, bool)
    for node in range(child.shape[0]):
        for c in child[node]:
            if c < 0:
                s, cnt = decode_leaf(int(c))
                assert 1 <= cnt <= 4 and not cover[s:s + cnt].any()
                cover[s:s + cnt] = True
            elif c > 0:
                assert c < child.shape[0]
    assert cover.all()


def test_own_bvh_matches_brute_force(own_ico, ico):
    """Walk of the port's own BVH against the dense plain version (K2's)
    on the same soup: the walk breaks ties in walk order, the scan by
    lowest prim, so the bars are those of tests/test_bvh.py:298-305."""
    trays = ico[3]
    sc = own_ico
    h = bvh_cuda.intersect_bvh(trays, sc.tris, sc.bvh)
    ref = isect_cuda.intersect_tris_plain(trays, sc.tris)
    pt, pr = h.prim.numpy(), ref.prim.numpy()
    assert ((pt >= 0) == (pr >= 0)).mean() > 0.995
    m = (pt >= 0) & (pr >= 0)
    assert m.sum() > 30
    assert np.allclose(h.t.numpy()[m], ref.t.numpy()[m], rtol=1e-4)
    occ = bvh_cuda.intersect_bvh(trays, sc.tris, sc.bvh, any_hit=True)
    assert (occ.numpy() == (pr >= 0)).mean() > 0.995


def test_wrapper_takes_plain_on_cpu(own_ico, ico):
    trays = ico[3]
    bvh_cuda.reset_counts()
    bvh_cuda.intersect_bvh(trays, own_ico.tris, own_ico.bvh)
    bvh_cuda.intersect_bvh(trays, own_ico.tris, own_ico.bvh, any_hit=True)
    assert bvh_cuda.counts == {"launches": 0, "plain_calls": 2}


@pytest.fixture(scope="module", params=["icosphere", "compaction"])
def own_bvh_scene(request, own_ico):
    """The port's own BVH of the 20,480-triangle icosphere and of
    tests/test_compaction.py's scene (floor + icosphere)."""
    if request.param == "icosphere":
        return own_ico
    rt = ignis_tpu_torch.loadFromString(json.dumps(COMPACTION_SCENE),
                                        device="cpu")
    return rt.scene


def _decode_records(packed):
    """(node of each record, its 6 box words as float32, its child in
    BVHArrays' encoding) of K1's node records, read back independently of
    pack_nodes: records lie in node order, so the sorted first records of
    the root and of every inner reference name the nodes 0, 1, ..."""
    rec = packed.records.numpy()
    ref = rec[:, 6].astype(np.int64)
    inner = ref >= 0
    first = np.concatenate([[0], np.sort(ref[inner] >> 3)])
    assert (np.diff(first) > 0).all()
    kids = np.diff(np.append(first, len(rec)))
    named = np.searchsorted(first, ref[inner] >> 3)
    assert ((ref[inner] & 7) + 1 == kids[named]).all()
    assert packed.root == kids[0] - 1
    child = ref.copy()
    child[inner] = named
    return (np.repeat(np.arange(len(first)), kids),
            rec[:, :6].copy().view(np.float32), child)


def test_packed_nodes_unpack_to_occupied_slots(own_bvh_scene):
    """K1's node records hold exactly the occupied child slots of
    BVHArrays, node by node in slot order: boxes bit for bit, child
    references naming the same nodes and leaves; the dropped count is the
    number of empty slots."""
    bvh = own_bvh_scene.bvh
    packed = bvh_cuda.pack_nodes(bvh)
    child = bvh.child.numpy()
    occupied = child != 0
    node, boxes, ref = _decode_records(packed)
    np.testing.assert_array_equal(node, np.nonzero(occupied)[0])
    want = np.stack([a.numpy() for a in bvh[:6]], -1)[occupied]
    assert boxes.view(np.int32).tobytes() == want.view(np.int32).tobytes()
    np.testing.assert_array_equal(ref, child[occupied])
    assert packed.dropped == int((~occupied).sum()) > 0
    assert packed.records.dtype == torch.int32
    assert packed.records.shape == (int(occupied.sum()), 8)


def test_packed_tris_equal_soup(own_bvh_scene):
    """K1's triangle rows are v0, e1, e2 (each xyz, then 0) bit for bit."""
    soup = own_bvh_scene.tris
    rows = bvh_cuda.pack_tris(soup).numpy()
    assert rows.shape == (soup.v0.x.shape[0], 12) and rows.dtype == np.float32
    for j, v in enumerate((soup.v0, soup.e1, soup.e2)):
        for c in range(3):
            assert rows[:, 4 * j + c].tobytes() == v[c].numpy().tobytes()
        assert not rows[:, 4 * j + 3].any()


def test_wrapper_with_tri_rows_matches_jax(ico):
    """intersect_bvh on the CPU, given packed triangle rows as the path
    passes them, against JAX's XLA walk (same prims, t within rtol 1e-6)
    and the Pallas kernel in interpret mode (the bars of
    test_plain_walk_matches_pallas_interpret)."""
    jsc, sc, jrays, trays = ico
    rows = bvh_cuda.pack_tris(sc.tris)
    got = bvh_cuda.intersect_bvh(trays, sc.tris, sc.bvh, tri_rows=rows)
    ref = intersect_bvh(jrays, jsc.tris, jsc.bvh.tri)
    np.testing.assert_array_equal(got.prim.numpy(), np.asarray(ref.prim))
    np.testing.assert_allclose(got.t.numpy(), np.asarray(ref.t), rtol=1e-6)
    vis = sc.tri_attr.shadow_visible
    occ = bvh_cuda.intersect_bvh(trays, sc.tris, sc.bvh, any_hit=True,
                                 shadow_visible=vis, tri_rows=rows)
    occ_ref = intersect_bvh(jrays, jsc.tris, jsc.bvh.tri, any_hit=True,
                            shadow_visible=jsc.tri_attr.shadow_visible)
    np.testing.assert_array_equal(occ.numpy(), np.asarray(occ_ref))
    h_chunk = intersect_bvh_pallas(jrays, jsc.tris, jsc.bvh.chunk,
                                   interpret=True)
    pt, pc = got.prim.numpy(), np.asarray(h_chunk.prim)
    assert ((pt >= 0) == (pc >= 0)).mean() > 0.995
    m = (pt >= 0) & (pc >= 0)
    assert m.sum() > 30
    assert np.allclose(np.asarray(h_chunk.t)[m], got.t.numpy()[m], rtol=1e-4)


# csrc/bvh_walk.cu's comparator network
_SORT8 = ((0, 2), (1, 3), (4, 6), (5, 7), (0, 1), (2, 3), (4, 5), (6, 7),
          (0, 4), (1, 5), (2, 6), (3, 7), (2, 4), (3, 5), (1, 4), (3, 6),
          (1, 2), (3, 4), (5, 6))


def _walk_packed(o, d, tmin, tmax, rows, records, root, any_hit):
    """One ray through K1's walk as csrc/bvh_walk.cu runs it, in numpy
    float32: node records, nearest-first order by the same comparator
    network, leaves in near order, the nearest inner child visited next and
    the others pushed far to near, closest hit skipping entries beyond its
    best hit. Returns (t, prim, u, v) or the occlusion bit, and the deepest
    stack."""
    f = np.float32
    inv = [f(1) / x if abs(x) > f(1e-12) else f(1e12) for x in d]
    best_t, best = min(tmax, f(3.0e38)), (-1, f(0), f(0))
    stack, deepest, node = [], 0, root
    while node is not None:
        first, kids = node >> 3, (node & 7) + 1
        ents = []
        for j in range(8):
            if j >= kids:
                ents.append((np.inf, 0))
                continue
            r = records[first + j]
            b = r[:6].view(np.float32)
            t0 = [(b[a] - o[a]) * inv[a] for a in range(3)]
            t1 = [(b[3 + a] - o[a]) * inv[a] for a in range(3)]
            near = max(max(min(t0[0], t1[0]), min(t0[1], t1[1])),
                       max(min(t0[2], t1[2]), tmin))
            far = min(min(max(t0[0], t1[0]), max(t0[1], t1[1])),
                      min(max(t0[2], t1[2]), best_t))
            ents.append((near, int(r[6])) if near <= far else (np.inf, 0))
        for a, b in _SORT8:
            if ents[b][0] < ents[a][0]:
                ents[a], ents[b] = ents[b], ents[a]
        for near, ref in ents:
            if near == np.inf or ref >= 0 or near > best_t:
                continue
            lv = -ref - 1
            for k in range(lv >> 4, (lv >> 4) + (lv & 15)):
                v0, e1, e2 = rows[k, 0:3], rows[k, 4:7], rows[k, 8:11]
                t, u, v, ok = _mt(o, d, v0, e1, e2)
                if not ok or not t > tmin:
                    continue
                if any_hit:
                    if t < best_t:
                        return True, deepest
                elif t < best_t or (t == best_t and k < best[0]):
                    best_t, best = t, (k, u, v)
        nxt = None
        for near, ref in reversed(ents):
            if near == np.inf or ref < 0 or near > best_t:
                continue
            if nxt is not None:
                stack.append(nxt)
            nxt = (ref, near)
        deepest = max(deepest, len(stack))
        node = None if nxt is None else nxt[0]
        while node is None and stack:
            ref, near = stack.pop()
            if any_hit or near <= best_t:
                node = ref
    if any_hit:
        return False, deepest
    t = best_t if best[0] >= 0 else f(3.0e38)
    return (t, best[0], best[1], best[2]), deepest


def _mt(o, d, v0, e1, e2):
    """Moeller-Trumbore in csrc/bvh_walk.cu's operation order (float32)."""
    pv = np.array([d[1] * e2[2] - d[2] * e2[1], d[2] * e2[0] - d[0] * e2[2],
                   d[0] * e2[1] - d[1] * e2[0]], np.float32)
    det = e1[0] * pv[0] + e1[1] * pv[1] + e1[2] * pv[2]
    if not abs(det) > np.float32(1e-16):
        return 0, 0, 0, False
    inv_det = np.float32(1) / det
    tv = o - v0
    u = (tv[0] * pv[0] + tv[1] * pv[1] + tv[2] * pv[2]) * inv_det
    qv = np.array([tv[1] * e1[2] - tv[2] * e1[1],
                   tv[2] * e1[0] - tv[0] * e1[2],
                   tv[0] * e1[1] - tv[1] * e1[0]], np.float32)
    v = (d[0] * qv[0] + d[1] * qv[1] + d[2] * qv[2]) * inv_det
    t = (e2[0] * qv[0] + e2[1] * qv[1] + e2[2] * qv[2]) * inv_det
    return t, u, v, bool(u >= 0 and v >= 0 and u + v <= 1)


def test_nearest_first_walk_matches_plain(own_bvh_scene):
    """K1's walk over its packed layouts, replayed ray by ray in numpy,
    gives the plain lockstep walk's closest hits exactly (prim, and t, u,
    v bit for bit) and its any-hit answers, on 300 rays from outside and
    inside the scene, with no more than 32 stack entries."""
    sc = own_bvh_scene
    packed = bvh_cuda.pack_nodes(sc.bvh)
    rows = bvh_cuda.pack_tris(sc.tris).numpy()
    rng = np.random.default_rng(5)
    n = 300
    o = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    o[: n // 3] *= np.float32(0.1)          # a third start inside
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmin = np.full(n, 1e-3, np.float32)
    tmax = np.full(n, 1e30, np.float32)
    tmax[::7] = np.float32(1.0)             # some short rays
    trays = Rays(Vec3(*[torch.from_numpy(o[:, i].copy()) for i in range(3)]),
                 Vec3(*[torch.from_numpy(d[:, i].copy()) for i in range(3)]),
                 torch.from_numpy(tmin), torch.from_numpy(tmax))
    ref = bvh_cuda.intersect_bvh_plain(trays, sc.tris, sc.bvh)
    occ_ref = bvh_cuda.intersect_bvh_plain(trays, sc.tris, sc.bvh,
                                           any_hit=True).numpy()
    records = packed.records.numpy()
    deepest = 0
    for i in range(n):
        hit, depth = _walk_packed(o[i], d[i], tmin[i], tmax[i], rows,
                                  records, packed.root, False)
        deepest = max(deepest, depth)
        want = (ref.t[i].item(), ref.prim[i].item(), ref.u[i].item(),
                ref.v[i].item())
        assert hit[1] == want[1], i
        for a, b in zip((hit[0], hit[2], hit[3]), (want[0], want[2],
                                                    want[3])):
            assert np.float32(a).tobytes() == np.float32(b).tobytes(), i
        occ, depth = _walk_packed(o[i], d[i], tmin[i], tmax[i], rows,
                                  records, packed.root, True)
        deepest = max(deepest, depth)
        assert occ == bool(occ_ref[i]), i
    assert (ref.prim >= 0).sum() > 50
    assert 0 < deepest <= 32
