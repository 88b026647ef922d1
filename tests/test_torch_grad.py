"""The gradient path of ignis_tpu_torch against ignis_tpu.

Module by module: the Moeller-Trumbore replay (ops/mt_replay.py) against
`_mt_terms`; the closest-hit gradients of K2 and K1 (their plain versions
here, with the fixed-winner backward) against `jax.grad` through the Pallas
kernels in interpret mode; K3's gather and scatter-add against
ignis_tpu/ops/gather.py. Then the slice: `loss_fn` / `train_step` on the
material albedo against the JAX package's `loss_fn`, and against the port's
own central differences; geometry gradients; the differentiable cascade
against the forward one. The kernels themselves are held against these
plain versions on the card (tests/test_torch_cuda.py, chip_smoke.py
phase 7)."""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ignis_tpu
from ignis_tpu.core.vec import Vec3 as JVec3
from ignis_tpu.ops.gather import gather_cols as jax_gather_cols
from ignis_tpu.ops.intersect import Rays as JRays
from ignis_tpu.ops.pallas_bvh import intersect_bvh_pallas
from ignis_tpu.ops.pallas_isect import _mt_terms, intersect_tris_pallas
from ignis_tpu.parallel.mesh import loss_fn as jax_loss_fn
from ignis_tpu.render.session import render_iteration as jax_iteration
from ignis_tpu_torch.bridge import (from_reference, param_from_reference,
                                    to_numpy)
from ignis_tpu_torch.core.vec import Vec3
from ignis_tpu_torch.ops import bvh_cuda, gather, isect_cuda, mt_replay
from ignis_tpu_torch.ops.intersect import Rays, TriSoup
from ignis_tpu_torch.parallel.mesh import loss_fn, train_step
from ignis_tpu_torch.render.session import render_iteration
from ignis_tpu_torch.techniques import path

from test_compaction import SCENE as COMPACTION_SCENE
from test_parallel import small_scene
from test_torch_bvh import ICO_SCENE

# The tensors here are small; one intra-op thread per test process keeps
# parallel test workers from oversubscribing the cores.
torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


def _random_rays_soup(seed, n, n_tris):
    """tests/test_bvh.py:168-212's soup and rays: ([15] ray+soup numpy
    columns: org xyz, dir xyz, v0 xyz, e1 xyz, e2 xyz)."""
    rng = np.random.default_rng(seed)
    v0 = rng.uniform(-3, 3, (n_tris, 3)).astype(np.float32)
    e1 = rng.uniform(-0.6, 0.6, (n_tris, 3)).astype(np.float32)
    e2 = rng.uniform(-0.6, 0.6, (n_tris, 3)).astype(np.float32)
    o = rng.uniform(-4, 4, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return [np.ascontiguousarray(a[:, i]) for a in (o, d, v0, e1, e2)
            for i in range(3)]


NAMES = [f"{a}.{c}" for a in ("org", "dir", "v0", "e1", "e2") for c in "xyz"]


def _torch_leaves(cols):
    return [_t(c).requires_grad_() for c in cols]


def _port_rays_soup(leaves, n):
    rays = Rays(Vec3(*leaves[:3]), Vec3(*leaves[3:6]), torch.zeros(n),
                torch.full((n,), 1e30))
    soup = TriSoup(Vec3(*leaves[6:9]), Vec3(*leaves[9:12]),
                   Vec3(*leaves[12:15]))
    return rays, soup


def _hit_loss_torch(hit, w):
    """sum(w * (t + u*v)) over lanes that hit (w fixes the lanes)."""
    m = hit.prim >= 0
    return torch.sum(w * (torch.where(m, hit.t, 0.0)
                          + torch.where(m, hit.u * hit.v, 0.0)))


def _hit_loss_jax(t, prim, u, v, w):
    m = prim >= 0
    return jnp.sum(w * (jnp.where(m, t, 0.0) + jnp.where(m, u * v, 0.0)))


def _assert_grads_close(got, ref, rtol=1e-3, atol=1e-4, min_entries=10,
                        what=""):
    """tests/test_bvh.py:168-212's bar: where both gradients are nonzero,
    within rtol 1e-3 / atol 1e-4, on more than `min_entries` entries."""
    both = (got != 0) & (ref != 0)
    assert both.sum() > min_entries, what
    np.testing.assert_allclose(got[both], ref[both], rtol=rtol, atol=atol,
                               err_msg=what)
    # and neither side has a gradient where the other has none but noise
    assert np.abs(got[(got != 0) & (ref == 0)]).max(initial=0) <= atol
    assert np.abs(ref[(ref != 0) & (got == 0)]).max(initial=0) <= atol


# ---------------------------------------------------------------------------
# 1. Moeller-Trumbore replay
# ---------------------------------------------------------------------------

def test_mt_terms_matches_jax():
    """mt_terms against _mt_terms (the same formulae, term for term) on a
    random soup and rays, each ray against a random triangle: t, u, v and
    det within rtol 1e-6 (atol 1e-6 for det's cancellation near 0)."""
    cols = _random_rays_soup(3, 4096, 4096)
    got = mt_replay.mt_terms(*[_t(c) for c in cols])
    ref = _mt_terms(*[jnp.asarray(c) for c in cols])
    for name, a, b in zip(("t", "u", "v", "det"), got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6, err_msg=name)


@pytest.mark.parametrize("seed", [3, 4])
def test_mt_adjoint_matches_autograd(seed):
    """mt_replay_bwd_plain's written-out adjoint against torch.autograd of
    mt_terms at each ray's winner (K2's plain version, T = N = 256) with
    random cotangents: the same derivative summed in another order, so
    within rtol 1e-5 / atol 1e-6 on these well-conditioned triangles;
    misses get zeros; soup gradients are the per-ray ones index-added."""
    n = 256
    cols = _random_rays_soup(seed, n, n)
    rays, soup = _port_rays_soup([_t(c) for c in cols], n)
    prim = isect_cuda.intersect_tris(rays, soup).prim
    hit = prim >= 0
    assert 10 < int(hit.sum()) < n
    rng = np.random.default_rng(seed)
    cts = [_t(rng.normal(size=n)) for _ in range(3)]
    ray_g, soup_g = mt_replay.mt_replay_bwd_plain(
        [_t(c) for c in cols[:6]], [_t(c) for c in cols[6:]], prim, *cts)
    p = torch.clamp(prim, min=0).long()
    leaves = [_t(c).requires_grad_() for c in cols[:6]] + [
        _t(c)[p].requires_grad_() for c in cols[6:]]
    t, u, v, _ = mt_replay.mt_terms(*leaves)
    ref = torch.autograd.grad((t, u, v), leaves,
                              [torch.where(hit, g, 0.0) for g in cts])
    for name, g, r in zip(NAMES, ray_g, ref[:6]):
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=name)
        assert (g[~hit] == 0).all()
    for name, g, r in zip(NAMES[6:], soup_g, ref[6:]):
        want = torch.zeros(n).index_add_(0, p, r).numpy()
        np.testing.assert_allclose(g.numpy(), want, rtol=1e-5, atol=1e-6,
                                   err_msg=name)


# ---------------------------------------------------------------------------
# 2-3. closest-hit gradients (fixed-winner backward)
# ---------------------------------------------------------------------------

def test_k2_closest_hit_grad_matches_jax():
    """K2 (plain version here) + ClosestHit's backward against jax.grad
    through intersect_tris_pallas(interpret=True), T = N = 256: gradients
    of org, dir, v0, e1 and e2, on the lanes where both pick the same
    triangle, at tests/test_bvh.py:168-212's bar."""
    n = t_count = 256
    cols = _random_rays_soup(11, n, t_count)
    jcols = [jnp.asarray(c) for c in cols]

    def pallas(*a):
        return intersect_tris_pallas(*a[:6], jnp.zeros(n), jnp.full(n, 1e30),
                                     *a[6:], jnp.ones(t_count),
                                     interpret=True)
    jt, jprim, ju, jv = pallas(*jcols)
    leaves = _torch_leaves(cols)
    rays, soup = _port_rays_soup(leaves, n)
    mt_replay.reset_counts()
    hit = isect_cuda.intersect_tris(rays, soup)
    agree = hit.prim.numpy() == np.asarray(jprim)
    assert agree.mean() > 0.99 and (hit.prim.numpy()[agree] >= 0).sum() > 10
    w = agree.astype(np.float32)
    got = torch.autograd.grad(_hit_loss_torch(hit, _t(w)), leaves)
    assert mt_replay.counts == {"launches": 0, "plain_calls": 1}
    ref = jax.grad(lambda *a: _hit_loss_jax(*pallas(*a), jnp.asarray(w)),
                   argnums=tuple(range(15)))(*jcols)
    for name, g, r in zip(NAMES, got, ref):
        _assert_grads_close(g.numpy(), np.asarray(r), min_entries=0,
                            what=name)
    # v0.x, the column tests/test_bvh.py:168 holds: more than 10 entries
    _assert_grads_close(got[6].numpy(), np.asarray(ref[6]))


def test_k2_any_hit_is_detached():
    """Any-hit stays out of the graph (JAX's stop_gradient)."""
    cols = _random_rays_soup(5, 64, 16)
    rays, soup = _port_rays_soup(_torch_leaves(cols), 64)
    occ = isect_cuda.intersect_tris(rays, soup, any_hit=True)
    assert occ.dtype == torch.bool and not occ.requires_grad


@pytest.fixture(scope="module")
def ico():
    """tests/test_torch_bvh.py's 20,480-triangle icosphere, bridged, and
    4096 random rays from a shell of radius 1.6 (0.4 outside it) aimed at
    random points of the cube [-0.5, 0.5]^3, so that none grazes it. The
    adjoint's terms grow with the ray's distance from the winner's v0 and
    with grazing incidence, and cancel: from radius 3, float32 rounding
    alone moved one dir gradient in 4096 past the bar (1.2e-4 on 1.8e-3)."""
    rt = ignis_tpu.loadFromString(json.dumps(ICO_SCENE))
    scene, _ = from_reference(rt.scene, rt.settings, "cpu")
    rng = np.random.default_rng(4)
    n = 4096
    o = rng.normal(size=(n, 3))
    o *= 1.6 / np.linalg.norm(o, axis=1, keepdims=True)
    aim = rng.uniform(-0.5, 0.5, (n, 3))
    d = (aim - o).astype(np.float32)
    o = o.astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return rt.scene, scene, o, d


def test_k1_closest_hit_grad_matches_jax(ico):
    """K1 (the plain lockstep walk here) + ClosestHit's backward against
    jax.grad through intersect_bvh_pallas(interpret=True) on the
    icosphere: prims agree on >= 0.995 of the rays, and on the rays where
    they agree the gradients of org, dir, v0, e1 and e2 are equal at
    tests/test_bvh.py's bar."""
    jsc, sc, o, d = ico
    n = o.shape[0]
    ray_cols = [np.ascontiguousarray(a[:, i]) for a in (o, d)
                for i in range(3)]
    soup_cols = [c.numpy() for v in sc.tris for c in v]
    leaves = _torch_leaves(ray_cols + soup_cols)
    rays, soup = _port_rays_soup(leaves, n)
    jrays = JRays(JVec3(*[jnp.asarray(c) for c in ray_cols[:3]]),
                  JVec3(*[jnp.asarray(c) for c in ray_cols[3:]]),
                  jnp.zeros(n), jnp.full(n, 1e30))
    jprim = np.asarray(intersect_bvh_pallas(jrays, jsc.tris, jsc.bvh.chunk,
                                            interpret=True).prim)
    mt_replay.reset_counts()
    hit = bvh_cuda.intersect_bvh(rays, soup, sc.bvh)
    agree = hit.prim.numpy() == jprim
    assert agree.mean() >= 0.995
    assert (jprim[agree] >= 0).sum() > 1000
    w = agree.astype(np.float32)
    got = torch.autograd.grad(_hit_loss_torch(hit, _t(w)), leaves)
    assert mt_replay.counts == {"launches": 0, "plain_calls": 1}

    def jloss(jr, js):
        h = intersect_bvh_pallas(jr, js, jsc.bvh.chunk, interpret=True)
        return _hit_loss_jax(h.t, h.prim, h.u, h.v, jnp.asarray(w))
    gr, gs = jax.grad(jloss, argnums=(0, 1))(jrays, jsc.tris)
    ref = [*gr.org, *gr.dir, *gs.v0, *gs.e1, *gs.e2]
    for name, g, r in zip(NAMES, got, ref):
        _assert_grads_close(g.numpy(), np.asarray(r), min_entries=10,
                            what=name)


def test_sphere_winner_gives_triangle_zero_cotangent():
    """Where an analytic sphere wins merge_hits, the triangle's closest-hit
    Function gets a zero cotangent: the soup gradient is finite, and only
    the rays whose winner is the triangle reach it."""
    from ignis_tpu_torch.ops.intersect import (
        SphereSoup, intersect_spheres_dense, merge_hits)
    n = 64
    x = torch.linspace(-0.9, 0.9, n)
    rays = Rays(Vec3(x, torch.zeros(n), torch.full((n,), -3.0)),
                Vec3(torch.zeros(n), torch.zeros(n), torch.ones(n)),
                torch.zeros(n), torch.full((n,), 1e30))
    # a big triangle in the plane z = 2, behind a ball of radius 0.5
    leaves = [_t([c]).requires_grad_()
              for c in (-4, -4, 2, 16, 0, 0, 0, 16, 0)]
    soup = TriSoup(Vec3(*leaves[:3]), Vec3(*leaves[3:6]), Vec3(*leaves[6:]))
    balls = SphereSoup(Vec3(torch.zeros(1), torch.zeros(1), torch.zeros(1)),
                       torch.full((1,), 0.5))
    h = merge_hits(isect_cuda.intersect_tris(rays, soup),
                   intersect_spheres_dense(rays, balls, 1))
    ball = h.prim == 1
    assert 0 < int(ball.sum()) < n and bool((h.prim[~ball] == 0).all())
    w = torch.linspace(1.0, 2.0, n)
    g = torch.autograd.grad(torch.sum(w * h.t), leaves)
    assert all(bool(torch.isfinite(x).all()) for x in g)
    # the plane is z = v0.z and the rays start at z = -3 along +z, so
    # t = v0.z + 3: d/d v0.z sums w over the triangle's rays alone
    np.testing.assert_allclose(float(g[2]), float(w[~ball].sum()),
                               rtol=1e-6)


# ---------------------------------------------------------------------------
# 4. K3
# ---------------------------------------------------------------------------

def test_k3_gather_and_scatter_match_jax():
    """gather_cols against JAX gather_cols: the Pallas kernel (interpret)
    carries bf16 hi/lo rounding, about 2^-18 relative, hence rtol 1e-5;
    the plain `tab[idx]` path exactly. The backward against jax.grad of
    sum(w * out): rtol 1e-6 / atol 1e-7 (sums in another order)."""
    rng = np.random.default_rng(9)
    n, t_rows, k = 4096, 1500, 22
    cols = [rng.normal(size=t_rows).astype(np.float32) for _ in range(k)]
    idx = rng.integers(0, t_rows, n).astype(np.int32)
    w = rng.normal(size=(n, k)).astype(np.float32)
    jcols = [jnp.asarray(c) for c in cols]
    leaves = _torch_leaves(cols)
    gather.reset_counts()
    out = gather.gather_cols(torch.from_numpy(idx), leaves)
    got = torch.stack(out, dim=1)
    ref_interp = np.stack([np.asarray(c) for c in jax_gather_cols(
        jnp.asarray(idx), jcols, interpret=True)], axis=1)
    ref_plain = np.stack([np.asarray(c) for c in jax_gather_cols(
        jnp.asarray(idx), jcols, interpret=False)], axis=1)
    np.testing.assert_allclose(got.detach().numpy(), ref_interp, rtol=1e-5,
                               atol=0)
    np.testing.assert_array_equal(got.detach().numpy(), ref_plain)

    g = torch.autograd.grad(torch.sum(_t(w) * got), leaves)
    assert gather.gather_counts == {"launches": 0, "plain_calls": 1}
    assert gather.scatter_counts == {"launches": 0, "plain_calls": 1}

    def jloss(cs):
        o = jax_gather_cols(jnp.asarray(idx), cs, interpret=True)
        return jnp.sum(jnp.asarray(w) * jnp.stack(o, axis=1))
    ref_g = jax.grad(jloss)(jcols)
    for a, b in zip(g, ref_g):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)


def test_k3_gather_without_grad_skips_the_function():
    """Outside reverse mode the table is fetched without the Function."""
    tab = torch.arange(12.0).reshape(4, 3)
    idx = torch.tensor([3, 0, 3], dtype=torch.int32)
    out = gather.gather_table(idx, tab)
    assert torch.equal(out, tab[idx.long()]) and out.grad_fn is None
    with torch.no_grad():
        out = gather.gather_table(idx, tab.clone().requires_grad_())
    assert out.grad_fn is None


# ---------------------------------------------------------------------------
# 5. the slice: albedo
# ---------------------------------------------------------------------------

def _load(scene_dict, size, **overrides):
    s = json.loads(json.dumps(scene_dict))
    s["film"] = {"size": [size, size]}
    rt = ignis_tpu.loadFromString(json.dumps(s), spi=1, **overrides)
    scene, settings = from_reference(rt.scene, rt.settings, "cpu")
    return rt, scene, settings


def _flat(color):
    return np.stack([np.asarray(c) for c in color])


def _port_fd_check(loss_of, p0, grad, rows=1, eps=1e-3, rtol=0.08):
    """tests/test_parallel.py:147 _fd_check for the port: the reverse-mode
    gradient `grad` of loss_of at p0 against central differences on its
    top-|g| entries (the random streams are keyed by pixel and sample, so
    both sides see the same sample set)."""
    assert np.isfinite(grad).all()
    flat = np.abs(grad).reshape(-1)
    order = np.argsort(-flat)[:rows]
    assert flat[order[0]] > 0, "no differentiable signal"
    for i in order:
        idx = np.unravel_index(int(i), grad.shape)
        hi, lo = p0.copy(), p0.copy()
        hi[idx] += eps
        lo[idx] -= eps
        fd = (loss_of(hi) - loss_of(lo)) / (2 * eps)
        np.testing.assert_allclose(grad[idx], fd, rtol=rtol, atol=1e-6)


@pytest.mark.parametrize("which", ["small_scene_k2", "compaction_k1"])
def test_albedo_loss_and_train_step_match_jax(which):
    """loss_fn's albedo gradient and one train_step (lr 1e-2) against the
    JAX package's loss_fn on small_scene(32) (K2 path) and on the
    compaction scene at 32x32 (K1 path), spi 1: the top gradient entry and
    the updated albedo within rtol 2e-2; then the port's gradient against
    its own central differences (rows 1, eps 1e-3, rtol 0.08)."""
    if which == "small_scene_k2":
        rt, scene, settings = _load(small_scene(32), 32)
        assert scene.bvh is None
    else:
        rt, scene, settings = _load(COMPACTION_SCENE, 32)
        assert scene.bvh is not None
    target = np.zeros((32, 32, 3), np.float32)
    jbase = rt.scene.materials.base
    jloss, jgrad = jax.value_and_grad(jax_loss_fn)(
        {"base": jbase}, rt.scene, rt.settings, jnp.asarray(target),
        jnp.uint32(0), jnp.uint32(0))
    ref_g = _flat(jgrad["base"])

    base = param_from_reference(jbase, "cpu")
    loss = loss_fn({"base": base}, scene, settings, torch.from_numpy(target),
                   0, 0)
    got_g = _flat(to_numpy(torch.autograd.grad(loss, list(base))))
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=2e-2)
    top = np.unravel_index(int(np.argmax(np.abs(ref_g))), ref_g.shape)
    assert ref_g[top] != 0
    np.testing.assert_allclose(got_g[top], ref_g[top], rtol=2e-2)

    lr = 1e-2
    loss2, new_scene = train_step(scene, settings, torch.from_numpy(target),
                                  0, 0, lr)
    np.testing.assert_allclose(float(loss2), float(loss.detach()), rtol=1e-6)
    new_base = _flat(to_numpy(new_scene.materials.base))
    ref_base = _flat(jbase) - lr * ref_g          # mesh.py:167's update
    np.testing.assert_allclose(new_base, ref_base, rtol=2e-2)
    step, ref_step = _flat(jbase) - new_base, lr * ref_g
    np.testing.assert_allclose(step[top], ref_step[top], rtol=2e-2)
    assert not any(t.requires_grad for t in new_scene.materials.base)

    p0 = _flat(to_numpy(scene.materials.base)).copy()
    tgt = torch.from_numpy(target)

    def loss_of(p):
        b = tuple(torch.from_numpy(p[i].copy()) for i in range(3))
        with torch.no_grad():
            return float(loss_fn({"base": type(scene.materials.base)(*b)},
                                 scene, settings, tgt, 0, 0))
    _port_fd_check(loss_of, p0, got_g)


# ---------------------------------------------------------------------------
# 6. the slice: geometry
# ---------------------------------------------------------------------------

GEOMETRY = (("tris", "v0"), ("tris", "e1"), ("tris", "e2"),
            ("tri_attr", "n0"), ("tri_attr", "n1"), ("tri_attr", "n2"))


def _with_leaves(scene, params):
    """scene with the Vec3s named in params replaced by their leaves."""
    for (group, name), v in params.items():
        scene = scene._replace(**{group: getattr(scene, group)._replace(
            **{name: v})})
    return scene


def _image_loss(img):
    """L2 against a black target, reduced in float64 so that central
    differences of a few 1e-8 stay above the loss's rounding."""
    return torch.mean(img.double() ** 2)


@pytest.fixture(scope="module")
def small32():
    return _load(small_scene(32), 32)


@pytest.mark.parametrize("which", ["small_scene_k2", "compaction_k1"])
def test_geometry_gradient_finite_and_nonzero(which, small32):
    """Reverse mode through the fixed-winner backward and K3's scatter:
    the gradient w.r.t. the soup (v0, e1, e2) and the vertex normals is
    finite everywhere and nonzero somewhere in each, on small_scene(32)
    (K2, diffuse) and on the compaction scene at 64x64 (K1, glass). Under
    detect_anomaly, no backward step yields NaN, even one a later masked
    select would drop (the roots in Fresnel at total internal reflection
    and in the ray-sphere test at a zero discriminant once did)."""
    if which == "small_scene_k2":
        _, scene, settings = small32
    else:
        _, scene, settings = _load(COMPACTION_SCENE, 64)
    settings = dataclasses.replace(settings, remat=True)
    params = {k: param_from_reference(getattr(getattr(scene, k[0]), k[1]),
                                      "cpu") for k in GEOMETRY}
    mt_replay.reset_counts()
    gather.reset_counts()
    leaves = [c for v in params.values() for c in v]
    with torch.autograd.detect_anomaly():
        img = render_iteration(_with_leaves(scene, params), settings, 0, 0)
        grads = to_numpy(torch.autograd.grad(_image_loss(img), leaves))
    assert mt_replay.counts["plain_calls"] > 0
    assert gather.scatter_counts["plain_calls"] > 0
    for i, key in enumerate(GEOMETRY):
        g = np.stack(grads[3 * i:3 * i + 3])
        assert np.isfinite(g).all(), key
        assert (g != 0).any(), key


def test_normal_gradient_matches_central_differences():
    """The gradient w.r.t. the vertex normals of small_scene(32) against
    the port's central differences: rows 1, eps 5e-3, rtol 0.1.

    At max_depth 3, not 2: the floor lies in the camera's plane (y = 0),
    so no camera ray hits it, and at max_depth 2 a bounced ray's hit gets
    no NEE, which leaves the normals without any gradient. At max_depth 3
    the signal is NEE at the second hit; the Russian roulette of the bounce
    after it draws on the diffuse albedo alone, so no decision moves with
    the normals."""
    _, scene, settings = _load(small_scene(32, max_depth=3), 32)
    settings = dataclasses.replace(settings, remat=True)
    keys = GEOMETRY[3:]
    params = {k: param_from_reference(getattr(getattr(scene, k[0]), k[1]),
                                      "cpu") for k in keys}
    img = render_iteration(_with_leaves(scene, params), settings, 0, 0)
    leaves = [c for v in params.values() for c in v]
    grad = np.stack(to_numpy(torch.autograd.grad(_image_loss(img), leaves)))
    p0 = np.stack([c.detach().numpy() for c in leaves])

    def loss_of(p):
        vs = {k: Vec3(*[torch.from_numpy(p[3 * i + j].copy())
                        for j in range(3)]) for i, k in enumerate(keys)}
        with torch.no_grad():
            return float(_image_loss(render_iteration(
                _with_leaves(scene, vs), settings, 0, 0)))
    _port_fd_check(loss_of, p0, grad, rows=1, eps=5e-3, rtol=0.1)


@pytest.mark.xfail(strict=True, reason=(
    "the JAX reference's own geometry gradient is NaN on small_scene(32) "
    "at max_depth 3: jax.grad w.r.t. tris.v0.y, tris.e1.y or "
    "tri_attr.n0.y of mean(render_iteration(remat=True)) is NaN on both "
    "real triangles, so there is nothing to compare the port's against"))
def test_geometry_gradient_matches_jax(small32):
    """The port's gradient w.r.t. tris.v0.y against jax.grad of the same
    loss: would be rtol 2e-2 on the top entry, if JAX's were finite."""
    rt, scene, settings = small32
    settings = dataclasses.replace(settings, remat=True)
    jsettings = dataclasses.replace(rt.settings, remat=True)
    jtris = rt.scene.tris

    def jloss(v0y):
        sc = rt.scene._replace(tris=jtris._replace(
            v0=jtris.v0._replace(y=v0y)))
        img = jax_iteration(sc, jsettings, jnp.uint32(0), jnp.uint32(0))
        return jnp.mean(img ** 2)
    ref = np.asarray(jax.grad(jloss)(jtris.v0.y))
    v0 = param_from_reference(jtris.v0, "cpu")
    tris = scene.tris._replace(v0=v0)
    img = render_iteration(scene._replace(tris=tris), settings, 0, 0)
    got = torch.autograd.grad(torch.mean(img ** 2), v0.y)[0].numpy()
    assert np.isfinite(got).all()
    assert np.isfinite(ref).all()
    top = int(np.argmax(np.abs(ref)))
    np.testing.assert_allclose(got[top], ref[top], rtol=2e-2)


# ---------------------------------------------------------------------------
# 7. differentiable cascade = forward cascade
# ---------------------------------------------------------------------------

def test_diff_cascade_matches_forward(monkeypatch):
    """render_iteration with remat (the checkpointed cascade, three stages
    with MIN_BUCKET forced to 256) against without (the one-stage
    progressive render) on the compaction scene at 64x64: the same sample
    set, so within rtol 2e-4 / atol 2e-5 (tests/test_compaction.py:63);
    and reverse mode through it reaches the albedo."""
    rt = ignis_tpu.loadFromString(json.dumps(COMPACTION_SCENE), spi=4)
    scene, settings = from_reference(rt.scene, rt.settings, "cpu")
    monkeypatch.setattr(path, "MIN_BUCKET", 256)
    assert path.bucket_chain(64 * 64, path.MIN_BUCKET) == [4096, 1024, 256]
    fwd = render_iteration(scene, settings, 0, 0)
    base = param_from_reference(rt.scene.materials.base, "cpu")
    diff_settings = dataclasses.replace(settings, remat=True)
    diff = render_iteration(scene._replace(materials=scene.materials._replace(
        base=base)), diff_settings, 0, 0)
    assert diff.requires_grad
    np.testing.assert_allclose(diff.detach().numpy(), fwd.numpy(),
                               rtol=2e-4, atol=2e-5)
    g = torch.autograd.grad(diff.sum(), list(base))
    assert all(torch.isfinite(x).all() for x in g)
    assert any((x != 0).any() for x in g)
