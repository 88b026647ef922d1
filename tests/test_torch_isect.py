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
