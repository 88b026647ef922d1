"""K2 (dense intersection) against ignis_tpu: the plain torch version
against `intersect_tris_dense` and the Pallas kernel in interpret mode, on
the soups of tests/test_bvh.py; spheres and merge_hits; the wrapper's
device dispatch. The CUDA kernel itself is checked on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ignis_tpu.core.vec import Vec3 as JVec3
from ignis_tpu.ops import intersect as J
from ignis_tpu.ops.pallas_isect import intersect_tris_pallas
from ignis_tpu_torch.core.vec import Vec3
from ignis_tpu_torch.ops import intersect as T
from ignis_tpu_torch.ops import isect_cuda

# The tensors here are small; one intra-op thread per test process keeps
# parallel test workers from oversubscribing the cores.
torch.set_num_threads(1)


def _soup_130():
    """tests/test_bvh.py:141-154: T=256 random soup, N=512 rays."""
    rng = np.random.default_rng(3)
    n_tris, n = 256, 512
    v0 = rng.uniform(-3, 3, (n_tris, 3)).astype(np.float32)
    e1 = rng.uniform(-0.6, 0.6, (n_tris, 3)).astype(np.float32)
    e2 = rng.uniform(-0.6, 0.6, (n_tris, 3)).astype(np.float32)
    o = rng.uniform(-4, 4, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return v0, e1, e2, o, d


def _soup_chunk31():
    """tests/test_bvh.py:223-244: T=4096 soup spread along x, rays aimed
    at the last 128 triangles."""
    rng = np.random.default_rng(5)
    n_tris, n = 4096, 256
    v0 = rng.uniform(-0.5, 0.5, (n_tris, 3)).astype(np.float32)
    v0[:, 0] += np.arange(n_tris, dtype=np.float32) / 16.0
    e1 = rng.uniform(-0.3, 0.3, (n_tris, 3)).astype(np.float32)
    e2 = rng.uniform(-0.3, 0.3, (n_tris, 3)).astype(np.float32)
    o = np.zeros((n, 3), np.float32)
    o[:, 0] = 250.0
    o[:, 2] = 5.0
    k = 3968 + (np.arange(n) % 128)
    targets = v0[k] + e1[k] / 3 + e2[k] / 3
    d = (targets - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return v0, e1, e2, o, d


def _both(v0, e1, e2, o, d, tmax=None):
    n = len(o)
    tmax = np.full(n, 1e30, np.float32) if tmax is None else tmax
    j3 = lambda a: JVec3(*[jnp.asarray(a[:, i]) for i in range(3)])  # noqa
    t3 = lambda a: Vec3(*[torch.from_numpy(a[:, i].copy())  # noqa
                          for i in range(3)])
    jsoup = J.TriSoup(j3(v0), j3(e1), j3(e2))
    tsoup = T.TriSoup(t3(v0), t3(e1), t3(e2))
    jrays = J.Rays(j3(o), j3(d), jnp.zeros(n), jnp.asarray(tmax))
    trays = T.Rays(t3(o), t3(d), torch.zeros(n), torch.from_numpy(tmax))
    return jsoup, tsoup, jrays, trays


SOUPS = {"t256": _soup_130, "chunk31": _soup_chunk31}


@pytest.fixture(scope="module", params=sorted(SOUPS))
def soup(request):
    return _both(*SOUPS[request.param]())


def test_plain_matches_dense(soup):
    """Same fp32 Moeller-Trumbore, epsilon and argmin tie break as
    intersect_tris_dense; bars of tests/test_bvh.py:163-165."""
    jsoup, tsoup, jrays, trays = soup
    ref = J.intersect_tris_dense(jrays, jsoup)
    got = isect_cuda.intersect_tris_plain(trays, tsoup)
    rp, gp = np.asarray(ref.prim), got.prim.numpy()
    assert (gp == rp).mean() > 0.999
    hit = rp >= 0
    assert hit.sum() > 50
    np.testing.assert_allclose(got.t.numpy()[hit], np.asarray(ref.t)[hit],
                               rtol=1e-4)
    assert (got.t.numpy()[~hit] == T.FLT_MAX).all()


def test_plain_matches_pallas_interpret(soup):
    """Against the Pallas kernel (interpret mode): its packed key breaks
    near-ties by lowest prim and its epsilon is 1e-9, so agreement is a
    ratio (tests/test_bvh.py:163-165 bars)."""
    jsoup, tsoup, jrays, trays = soup
    n_tris = jsoup.v0.x.shape[0]
    t, prim, _, _ = intersect_tris_pallas(
        jrays.org.x, jrays.org.y, jrays.org.z,
        jrays.dir.x, jrays.dir.y, jrays.dir.z, jrays.tmin, jrays.tmax,
        jsoup.v0.x, jsoup.v0.y, jsoup.v0.z, jsoup.e1.x, jsoup.e1.y,
        jsoup.e1.z, jsoup.e2.x, jsoup.e2.y, jsoup.e2.z, jnp.ones(n_tris),
        interpret=True)
    got = isect_cuda.intersect_tris_plain(trays, tsoup)
    assert (got.prim.numpy() == np.asarray(prim)).mean() > 0.999
    hit = np.asarray(prim) >= 0
    np.testing.assert_allclose(got.t.numpy()[hit], np.asarray(t)[hit],
                               rtol=1e-4)


def test_any_hit_mask_and_dead_lanes():
    """Any-hit gated by a random shadow_visible mask, with dead lanes
    (tmax < tmin): same tests as occluded_tris_dense, so equal lanes."""
    v0, e1, e2, o, d = _soup_130()
    rng = np.random.default_rng(8)
    tmax = np.full(len(o), 1e30, np.float32)
    dead = rng.uniform(size=len(o)) < 0.2
    tmax[dead] = -1.0
    jsoup, tsoup, jrays, trays = _both(v0, e1, e2, o, d, tmax)
    vis = rng.uniform(size=len(v0)) < 0.6
    ref = np.asarray(J.occluded_tris_dense(jrays, jsoup, jnp.asarray(vis)))
    got = isect_cuda.intersect_tris_plain(trays, tsoup, torch.from_numpy(vis),
                                          any_hit=True)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), ref)
    assert not got.numpy()[dead].any() and ref[~dead].any()
    closest = isect_cuda.intersect_tris_plain(trays, tsoup)
    assert (closest.prim.numpy()[dead] == -1).all()


def test_spheres_and_merge():
    """intersect_spheres_dense and merge_hits: same closed form; t within
    rtol 1e-6 (float32 sqrt of the same discriminant)."""
    rng = np.random.default_rng(12)
    s, n = 5, 2048
    c = rng.uniform(-2, 2, (s, 3)).astype(np.float32)
    r = rng.uniform(0.2, 0.8, s).astype(np.float32)
    r[-1] = 0.0   # padding entry never hits
    o = rng.uniform(-4, 4, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    v0, e1, e2, _, _ = _soup_130()
    jsoup, tsoup, jrays, trays = _both(v0, e1, e2, o, d)
    jsph = J.SphereSoup(JVec3(*[jnp.asarray(c[:, i]) for i in range(3)]),
                        jnp.asarray(r))
    tsph = T.SphereSoup(Vec3(*[torch.from_numpy(c[:, i].copy())
                               for i in range(3)]), torch.from_numpy(r))
    jh = J.intersect_spheres_dense(jrays, jsph, 256)
    th = T.intersect_spheres_dense(trays, tsph, 256)
    np.testing.assert_array_equal(th.prim.numpy(), np.asarray(jh.prim))
    np.testing.assert_allclose(th.t.numpy(), np.asarray(jh.t), rtol=1e-6)
    assert (th.prim.numpy() >= 256).sum() > 30
    jm = J.merge_hits(J.intersect_tris_dense(jrays, jsoup), jh)
    tm = T.merge_hits(isect_cuda.intersect_tris_plain(trays, tsoup), th)
    np.testing.assert_array_equal(tm.prim.numpy(), np.asarray(jm.prim))
    # triangle t: XLA may contract the MT dot products into FMAs, hence
    # the tests/test_bvh.py bar rather than 1e-6
    np.testing.assert_allclose(tm.t.numpy(), np.asarray(jm.t), rtol=1e-4)


def test_wrapper_takes_plain_on_cpu(soup):
    """The K2 wrapper given CPU tensors runs the plain version and never
    counts a launch."""
    _, tsoup, _, trays = soup
    isect_cuda.reset_counts()
    h = isect_cuda.intersect_tris(trays, tsoup)
    occ = isect_cuda.intersect_tris(trays, tsoup, any_hit=True)
    assert isect_cuda.counts == {"launches": 0, "plain_calls": 2}
    ref = isect_cuda.intersect_tris_plain(trays, tsoup)
    assert torch.equal(h.prim, ref.prim)
    assert torch.equal(occ, ref.prim >= 0)


# ---------------------------------------------------------------------------
# K2's packed soup and the plain replay of its warp-tile cull
# ---------------------------------------------------------------------------

def _s4_soup():
    """The soup of S4 (chip_smoke.S4_GLASS_ICO2: S1's scene with the
    icosphere at subdivisions 2, 322 triangles, no BVH), on the CPU."""
    import json

    import chip_smoke
    import ignis_tpu_torch
    small = json.loads(json.dumps(chip_smoke.S4_GLASS_ICO2))
    small["film"] = {"size": [64, 64]}
    rt = ignis_tpu_torch.loadFromString(json.dumps(small), device="cpu")
    assert rt.scene.bvh is None and rt.scene.tris.v0.x.numel() == 322
    return rt


def _tsoup(v0, e1, e2):
    def t3(a):
        return Vec3(*[torch.from_numpy(np.ascontiguousarray(a[:, i]))
                      for i in range(3)])
    return T.TriSoup(t3(v0), t3(e1), t3(e2))


def _np_soup(soup):
    return [np.stack([a.numpy() for a in v], 1)
            for v in (soup.v0, soup.e1, soup.e2)]


def _rays_at(o, target, tmax=1e30):
    d = (target - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    n = len(o)
    t3 = lambda a: Vec3(*[torch.from_numpy(np.ascontiguousarray(  # noqa
        a[:, i].astype(np.float32))) for i in range(3)])
    return T.Rays(t3(o), t3(d), torch.zeros(n),
                  torch.full((n,), tmax, dtype=torch.float32))


def test_pack_soup_rows_tiles_and_order():
    """pack_soup: the rows are the soup in a permuted order, each carrying
    its original prim id; tiles are consecutive runs of at most TILE rows
    covering the soup, the large triangles (the floor) tiled apart and
    first; every tile's box holds its triangles' vertices with a margin;
    a chunk of CHUNK_TILES tiles holds at most TILE * CHUNK_TILES rows."""
    rng = np.random.default_rng(4)
    v0 = rng.uniform(-1, 1, (300, 3)).astype(np.float32)
    e1 = rng.uniform(-0.05, 0.05, (300, 3)).astype(np.float32)
    e2 = rng.uniform(-0.05, 0.05, (300, 3)).astype(np.float32)
    big = [17, 230]
    e1[big] = [[8.0, 0.0, 0.0], [0.0, 0.0, 8.0]]
    pack = isect_cuda.pack_soup(_tsoup(v0, e1, e2))
    rows, tiles = pack.rows.numpy(), pack.tiles.numpy()
    prim = rows[:, 3].copy().view(np.int32)
    assert sorted(prim) == list(range(300))
    np.testing.assert_array_equal(rows[:, 0:3], v0[prim])
    np.testing.assert_array_equal(rows[:, 4:7], e1[prim])
    np.testing.assert_array_equal(rows[:, 8:11], e2[prim])
    assert not rows[:, [7, 11]].any()
    start = tiles[:, 3].copy().view(np.int32)
    count = tiles[:, 7].copy().view(np.int32)
    assert start[0] == 0 and (start[1:] == start[:-1] + count[:-1]).all()
    assert count.sum() == 300 and (count >= 1).all()
    assert (count <= isect_cuda.TILE).all()
    assert sorted(prim[:2]) == big and start[1] == 2
    for k in range(len(tiles)):
        r = slice(start[k], start[k] + count[k])
        for vert in (rows[r, 0:3], rows[r, 0:3] + rows[r, 4:7],
                     rows[r, 0:3] + rows[r, 8:11]):
            assert (vert > tiles[k, 0:3]).all()
            assert (vert < tiles[k, 4:7]).all()
    for c0 in range(0, len(tiles), isect_cuda.CHUNK_TILES):
        assert count[c0:c0 + isect_cuda.CHUNK_TILES].sum() <= \
            isect_cuda.TILE * isect_cuda.CHUNK_TILES
    empty = isect_cuda.pack_soup(_tsoup(*[np.zeros((0, 3), np.float32)] * 3))
    assert empty.rows.shape == (0, 12) and empty.tiles.shape == (0, 8)


def _cull_case(name):
    """(soup, rays, shadow mask) of one replay case: rays from random
    origins aimed at S4's vertices, at points on its edges (shared by two
    triangles, so equal-t ties between ids the pack has permuted), at
    points on its tiles' box faces and along them, or a random soup of
    1,500 triangles, which the kernel streams in chunks."""
    rng = np.random.default_rng(17)
    if name == "streamed":
        v0 = rng.uniform(-3, 3, (1500, 3)).astype(np.float32)
        e1 = rng.uniform(-0.6, 0.6, (1500, 3)).astype(np.float32)
        e2 = rng.uniform(-0.6, 0.6, (1500, 3)).astype(np.float32)
        o = rng.uniform(-4, 4, (2048, 3)).astype(np.float32)
        soup = _tsoup(v0, e1, e2)
        return soup, _rays_at(o, rng.uniform(-3, 3, (2048, 3))), \
            torch.from_numpy(rng.uniform(size=1500) < 0.6)
    rt = _s4_soup()
    soup = rt.scene.tris
    v0, e1, e2 = _np_soup(soup)
    k = rng.integers(0, len(v0), 2048)
    if name == "vertices":
        corner = rng.integers(0, 3, (2048, 1))
        target = v0[k] + np.where(corner == 1, e1[k], 0) \
            + np.where(corner == 2, e2[k], 0)
    elif name == "edges":
        s = rng.uniform(size=(2048, 1)).astype(np.float32)
        which = rng.integers(0, 3, (2048, 1))
        a = np.where(which == 2, v0[k] + e1[k], v0[k])
        b = np.where(which == 0, v0[k] + e1[k], v0[k] + e2[k])
        target = a + s * (b - a)
    else:
        pack = isect_cuda.pack_soup(soup)
        tiles = pack.tiles.numpy()
        t = tiles[rng.integers(0, len(tiles), 2048)]
        lo, hi = t[:, 0:3], t[:, 4:7]
        target = lo + rng.uniform(size=(2048, 3)) * (hi - lo)
        axis = rng.integers(0, 3, 2048)
        side = rng.uniform(size=2048) < 0.5
        rows = np.arange(2048)
        target[rows, axis] = np.where(side, lo[rows, axis], hi[rows, axis])
        o = rng.uniform(-4, 4, (2048, 3)).astype(np.float32)
        # half the rays run along the face: the origin in its plane
        along = np.arange(2048) % 2 == 0
        o[along, axis[along]] = target[along, axis[along]]
        return soup, _rays_at(o, target), rt.scene.tri_attr.shadow_visible
    o = rng.uniform(-4, 4, (2048, 3)).astype(np.float32)
    return soup, _rays_at(o, target), rt.scene.tri_attr.shadow_visible


@pytest.mark.parametrize("case", ["vertices", "edges", "box faces",
                                  "streamed"])
def test_cull_replay_exact(case):
    """The plain replay of K2's walk over the pack (tile order, per-lane
    slab tests against the padded boxes, warp skips, the (t, prim) rule)
    never culls a tile holding a triangle Moeller-Trumbore accepts within
    the lane's interval, and equals intersect_tris_plain bit for bit,
    closest and any hit."""
    soup, rays, vis = _cull_case(case)
    pack = isect_cuda.pack_soup(soup)
    got, missed = isect_cuda.intersect_packed_plain(rays, pack)
    ref = isect_cuda.intersect_tris_plain(rays, soup)
    assert missed == 0
    assert (ref.prim >= 0).sum() > 100
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    occ, missed = isect_cuda.intersect_packed_plain(rays, pack, vis, True)
    assert missed == 0
    assert torch.equal(occ, isect_cuda.intersect_tris_plain(rays, soup, vis,
                                                            True))


def test_cull_replay_exact_on_s4_main_path():
    """The replay on S4's main-path sets at 64x64 (chip_smoke's camera,
    secondary and shadow rays): no hit culled, results equal to the plain
    version bit for bit."""
    import chip_smoke
    rt = _s4_soup()
    sc = rt.scene
    pack = isect_cuda.pack_soup(sc.tris)
    for name, (rays, any_hit) in chip_smoke.main_path_sets(rt, "cpu").items():
        vis = sc.tri_attr.shadow_visible if any_hit else None
        got, missed = isect_cuda.intersect_packed_plain(rays, pack, vis,
                                                        any_hit)
        ref = isect_cuda.intersect_tris_plain(rays, sc.tris, vis, any_hit)
        assert missed == 0, name
        if any_hit:
            assert torch.equal(got, ref) and ref.any()
        else:
            assert all(torch.equal(a, b) for a, b in zip(got, ref)), name
            assert (ref.prim >= 0).sum() > 20
