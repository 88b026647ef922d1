"""ignis_tpu_torch's two-level instancing (ops/instanced.py) against
ignis_tpu on the CPU: the instance groups the loaders build, the
instanced closest hit, any hit and hit attributes on the same rays, and
the render, on tests/test_instancing.py's grid of 64 icospheres
(`_grid_scene(8)`, 320 triangles each) bridged from one
`ignis_tpu.build_scene`; the JAX tests' oracles (instanced against
flattened renders, O(1)-mesh memory, three groups, 1,024 instances) on
the port; one local-soup kernel call a group per trace whatever the
instance count; the local soup's own BVH (K1's path) against the
flattened scene; and the albedo gradient through instanced hits.

The JAX package pads a group's local soup to a multiple of 256 triangles
(TPU chunks); the port does not, so a hit's (instance, local triangle)
is compared, not its encoded prim."""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ignis_tpu
import ignis_tpu_torch
from ignis_tpu.render.session import render_iteration as jax_iteration
from ignis_tpu_torch.bridge import from_reference
from ignis_tpu_torch.core.vec import Vec3
from ignis_tpu_torch.ops import bvh_cuda, gather, isect_cuda, mt_replay
from ignis_tpu_torch.ops.intersect import Hit, Rays, TriSoup
from ignis_tpu_torch.render.session import render_iteration
from ignis_tpu_torch.techniques import path

from test_instancing import _grid_scene, _multi_group_scene

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def grid8():
    """(JAX runtime, bridged port scene and settings) of the 64-instance
    grid at 64x64, spi 4."""
    rt = ignis_tpu.loadFromString(json.dumps(_grid_scene(8)), spi=4,
                                  instancing=True)
    scene, settings = from_reference(rt.scene, rt.settings, "cpu")
    return rt, scene, settings


def _rays(scene, n_side=64, seed=5):
    """Camera rays through the 64x64 pixel centres, then cosine-free
    random secondary rays from their hits (both packages trace both)."""
    from ignis_tpu_torch.models import camera
    from ignis_tpu_torch.scenedata import RenderSettings
    s = RenderSettings(width=n_side, height=n_side)
    x = torch.arange(n_side).repeat(n_side)
    y = torch.arange(n_side).repeat_interleave(n_side)
    half = torch.full(x.shape, 0.5)
    cam = camera.generate_rays(scene.camera, s, x, y, half, half)
    hit = path.trace_scene(scene, cam)
    p = cam.org + cam.dir * torch.where(hit.prim >= 0, hit.t, 1.0)
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(x.shape[0], 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    sec = Rays(p, Vec3(*[torch.from_numpy(d[:, i].copy()) for i in range(3)]),
               torch.full(x.shape, 1e-3), torch.full(x.shape, 3e38))
    return Rays(*[Vec3(*[torch.cat([a, b]) for a, b in zip(u, v)])
                  if isinstance(u, Vec3) else torch.cat([u, v])
                  for u, v in zip(cam, sec)])


def _jax_rays(rays):
    from ignis_tpu.core.vec import Vec3 as JVec3
    from ignis_tpu.ops.intersect import Rays as JRays
    j = lambda t: jnp.asarray(t.numpy())  # noqa: E731
    return JRays(JVec3(*[j(c) for c in rays.org]),
                 JVec3(*[j(c) for c in rays.dir]), j(rays.tmin),
                 j(rays.tmax))


def _split(prim, base, t_local):
    """(hit, instance, local triangle) of encoded prims."""
    prim = np.asarray(prim)
    local = prim - base
    return prim >= 0, local // t_local, local % t_local


def test_build_matches_jax(grid8):
    """The port's own loader builds the JAX package's group: one group of
    64 instances, its local soup the JAX soup without the padding rows,
    equal transforms, normal matrices, entities, visibility and boxes,
    and no instanced triangle in the flat soup."""
    rt, _, _ = grid8
    own = ignis_tpu_torch.loadFromString(json.dumps(_grid_scene(8)),
                                         device="cpu", spi=4,
                                         instancing=True)
    (g,), (jg,) = own.scene.instances, rt.scene.instances
    assert g.n_instances == jg.n_instances == 64 and g.bvh is None
    t = g.tris_per_instance
    assert t == 320 and jg.tris_per_instance == 512   # 320 padded to 512
    for a, b in zip(g.soup, jg.soup):
        for c, d in zip(a, b):
            np.testing.assert_array_equal(c.numpy(), np.asarray(d)[:t])
    assert not np.asarray(jg.soup.e1.x)[t:].any()
    for f in ("w2l", "nrm_mat", "ent", "shadow_visible", "aabb_min",
              "aabb_max"):
        np.testing.assert_array_equal(getattr(g, f).numpy(),
                                      np.asarray(getattr(jg, f)))
    assert int((own.scene.tri_attr.ent >= 0).sum()) == 0
    assert float(own.scene.scene_radius) == pytest.approx(
        float(rt.scene.scene_radius), rel=1e-6)


def test_instanced_trace_matches_jax(grid8):
    """Closest hit and any hit on 8,192 rays (camera rays and random
    secondary rays from their hits): hit or miss, instance and local
    triangle equal on every lane; t within rtol 1e-5 / atol 5e-5 on every
    lane, u and v within 1e-4 on 99.5% of the hits and 1e-3 on all (the
    same float32 transforms and Moeller-Trumbore, but XLA contracts some
    products into FMAs, and grazing hits amplify it in u and v); occlusion
    equal."""
    rt, scene, _ = grid8
    rays = _rays(scene)
    jr = _jax_rays(rays)
    from ignis_tpu.techniques import path as jpath
    jhit = jax.jit(jpath.trace_scene)(rt.scene, jr)
    jocc = jax.jit(jpath.occluded_scene)(rt.scene, jr)
    hit = path.trace_scene(scene, rays)
    occ = path.occluded_scene(scene, rays)
    base = scene.tris.v0.x.shape[0] + scene.spheres.radius.shape[0]
    jf, ji, jl = _split(jhit.prim, base, 512)
    f, i, loc = _split(hit.prim.numpy(), base, 320)
    assert f.mean() > 0.2 and (~f).mean() > 0.1
    np.testing.assert_array_equal(f, jf)
    np.testing.assert_array_equal(i[f], ji[f])
    np.testing.assert_array_equal(loc[f], jl[f])
    np.testing.assert_allclose(hit.t.numpy()[f], np.asarray(jhit.t)[f],
                               rtol=1e-5, atol=5e-5)
    for a, b in ((hit.u, jhit.u), (hit.v, jhit.v)):
        err = np.abs(a.numpy()[f] - np.asarray(b)[f])
        assert (err <= 1e-4).mean() >= 0.995 and err.max() <= 1e-3
    np.testing.assert_array_equal(occ.numpy(), np.asarray(jocc))


def test_instanced_surface_matches_jax(grid8):
    """compute_surface at the JAX hits (their prims re-encoded with the
    port's T): point, normals and uv within 1e-5, entity and side equal
    (two K3 gathers a group: the local attributes and the instance
    table)."""
    rt, scene, _ = grid8
    rays = _rays(scene)
    jr = _jax_rays(rays)
    from ignis_tpu.techniques import path as jpath
    jhit = jax.jit(jpath.trace_scene)(rt.scene, jr)
    jsurf = jax.jit(jpath.compute_surface)(rt.scene, jr, jhit)
    base = scene.tris.v0.x.shape[0] + scene.spheres.radius.shape[0]
    f, i, loc = _split(jhit.prim, base, 512)
    prim = np.where(f, base + i * 320 + loc, -1).astype(np.int32)
    hit = Hit(*[torch.from_numpy(np.array(a)) for a in
                (jhit.t, prim, jhit.u, jhit.v)])
    gather.reset_counts()
    surf = path.compute_surface(scene, rays, hit)
    # the flat attribute table, the group's attributes and instance table
    assert gather.gather_counts["plain_calls"] == 3
    for name in ("point", "face_n", "ns", "uv"):
        for a, b in zip(getattr(surf, name), getattr(jsurf, name)):
            np.testing.assert_allclose(a.numpy()[f], np.asarray(b)[f],
                                       rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(surf.ent.numpy()[f],
                                  np.asarray(jsurf.ent)[f])
    np.testing.assert_array_equal(surf.is_entering.numpy()[f],
                                  np.asarray(jsurf.is_entering)[f])


def test_instanced_render_matches_jax(grid8):
    """The 64x64 render (spi 4, path, max_depth 3) against the JAX
    package's on the same arrays and random streams: 99% of pixels within
    rtol 1e-4 / atol 1e-4, image means within 1e-4 relative."""
    rt, scene, settings = grid8
    ref = np.asarray(jax_iteration(rt.scene, rt.settings, jnp.uint32(0),
                                   jnp.uint32(0)))
    got = render_iteration(scene, settings, 0, 0).numpy()
    assert got.shape == ref.shape and ref.mean() > 0.01
    close = np.isclose(got, ref, rtol=1e-4, atol=1e-4).all(-1).mean()
    assert close >= 0.99
    assert abs(got.mean() - ref.mean()) <= 1e-4 * ref.mean()


def _flat_and_instanced(doc, spi=4, **kw):
    return (ignis_tpu_torch.loadFromString(doc, device="cpu", spi=spi, **kw),
            ignis_tpu_torch.loadFromString(doc, device="cpu", spi=spi,
                                           instancing=True, **kw))


def _assert_images_agree(a, b):
    """tests/test_instancing.py:69-73: the 99th percentile of per-pixel
    relative difference under 0.05, means within 1%."""
    rel = np.abs(a - b) / np.maximum(np.abs(a), 1e-3)
    assert np.quantile(rel, 0.99) < 0.05, (a.mean(), b.mean())
    assert abs(a.mean() - b.mean()) / max(a.mean(), 1e-6) < 0.01


def test_instanced_matches_flattened_with_o1_memory():
    """tests/test_instancing.py:49 on the port: the instanced scene holds
    one copy of the mesh (no padding) and none in its flat soup, and
    renders as the flattened scene does."""
    flat, inst = _flat_and_instanced(json.dumps(_grid_scene(8)))
    n_flat = int((flat.scene.tri_attr.ent >= 0).sum())
    (geo,) = inst.scene.instances
    assert geo.n_instances == 64
    assert geo.tris_per_instance * 64 == n_flat
    assert int((inst.scene.tri_attr.ent >= 0).sum()) == 0
    _assert_images_agree(flat.step().framebuffer(normalized=True).numpy(),
                         inst.step().framebuffer(normalized=True).numpy())


def test_instanced_1k_instances_builds_small():
    """tests/test_instancing.py:83 on the port: 1,024 instances keep
    O(mesh + instances) resident floats."""
    rt = ignis_tpu_torch.loadFromString(
        json.dumps(_grid_scene(32, spacing=1.2)), device="cpu", spi=1,
        instancing=True)
    (geo,) = rt.scene.instances
    assert geo.n_instances == 1024
    assert int((rt.scene.tri_attr.ent >= 0).sum()) == 0
    assert geo.tris_per_instance == 320
    resident = geo.tris_per_instance * 21 + geo.n_instances * (12 + 9 + 6)
    assert resident < geo.n_instances * geo.tris_per_instance * 21 / 50


def test_multi_group_instancing_matches_flattened():
    """tests/test_instancing.py:137 on the port: three reused meshes make
    three groups (4, 3 and 3 instances), the lone cone stays flat, and
    the render agrees with the flattened one."""
    flat, inst = _flat_and_instanced(json.dumps(_multi_group_scene()))
    assert sorted(g.n_instances for g in inst.scene.instances) == [3, 3, 4]
    n_global = int((inst.scene.tri_attr.ent >= 0).sum())
    n_flat = int((flat.scene.tri_attr.ent >= 0).sum())
    assert 0 < n_global < n_flat / 3
    _assert_images_agree(flat.step().framebuffer(normalized=True).numpy(),
                         inst.step().framebuffer(normalized=True).numpy())


@pytest.mark.parametrize("n_side", [2, 8, 32])
def test_one_local_sweep_a_group_per_trace(n_side):
    """A closest hit or any hit of an instanced scene calls the local
    soup's kernel (here its plain version) once a group, whatever the
    instance count (4, 64 or 1,024): not once an instance."""
    rt = ignis_tpu_torch.loadFromString(
        json.dumps(_grid_scene(n_side, spacing=1.2)), device="cpu",
        instancing=True)
    rays = _rays(rt.scene, n_side=16)
    for any_hit in (False, True):
        isect_cuda.reset_counts()
        if any_hit:
            path.occluded_scene(rt.scene, rays)
        else:
            path.trace_scene(rt.scene, rays)
        # the flat soup's sweep and the group's
        assert isect_cuda.counts["plain_calls"] == 2


def test_local_bvh_matches_flattened():
    """A mesh of BVH_THRESHOLD triangles or more (icospheres at
    subdivisions 4: 5,120) gets its own BVH, so its instances go through
    K1's path (here its plain walk): the same hits, entities and distances
    as the flattened scene's on 8,192 rays (t within rtol 5e-4)."""
    sc = _grid_scene(3)
    sc["shapes"][0]["subdivisions"] = 4
    flat, inst = _flat_and_instanced(json.dumps(sc), spi=1)
    (geo,) = inst.scene.instances
    assert geo.bvh is not None and geo.tris_per_instance == 5120
    rays = _rays(inst.scene)
    bvh_cuda.reset_counts()
    hi = path.trace_scene(inst.scene, rays)
    assert bvh_cuda.counts["plain_calls"] == 1
    hf = path.trace_scene(flat.scene, rays)
    f = hf.prim.numpy() >= 0
    assert f.sum() > 200
    np.testing.assert_array_equal(hi.prim.numpy() >= 0, f)
    si = path.compute_surface(inst.scene, rays, hi)
    sf = path.compute_surface(flat.scene, rays, hf)
    np.testing.assert_array_equal(si.ent.numpy()[f], sf.ent.numpy()[f])
    # the two soups are transformed apart (world rows, local rows and a
    # float32 transform), so t agrees to rounding
    np.testing.assert_allclose(hi.t.numpy()[f], hf.t.numpy()[f], rtol=5e-4)
    np.testing.assert_array_equal(
        path.occluded_scene(inst.scene, rays).numpy(),
        path.occluded_scene(flat.scene, rays).numpy())


def test_coincident_instances_keep_the_first():
    """A fifth entity of the 2x2 grid's mesh at the first one's place:
    no hit names it, as the JAX scan's strict `<` keeps the earlier
    instance, and every lane names the JAX package's instance."""
    sc = _grid_scene(2)
    sc["entities"].append(dict(sc["entities"][0], name="twin"))
    doc = json.dumps(sc)
    rt = ignis_tpu.loadFromString(doc, instancing=True)
    scene, _ = from_reference(rt.scene, rt.settings, "cpu")
    rays = _rays(scene)
    from ignis_tpu.techniques import path as jpath
    jhit = jax.jit(jpath.trace_scene)(rt.scene, _jax_rays(rays))
    hit = path.trace_scene(scene, rays)
    base = scene.tris.v0.x.shape[0]
    f, i, _ = _split(hit.prim.numpy(), base, 320)
    jf, ji, _ = _split(jhit.prim, base, 512)
    assert (i[f] == 0).sum() > 20
    np.testing.assert_array_equal(f, jf)
    np.testing.assert_array_equal(i[f], ji[f])
    assert not (i[f] == 4).any()


def test_albedo_gradient_through_instanced_hits():
    """The albedo gradient of a 32x32 loss flows through instanced hits
    (their geometry held fixed) as through the flattened scene's: equal
    within rtol 1e-3."""
    sc = _grid_scene(4)
    sc["film"]["size"] = [32, 32]
    flat, inst = _flat_and_instanced(json.dumps(sc), spi=1)
    target = torch.zeros((32, 32, 3))
    grads = []
    for rt in (flat, inst):
        base = rt.scene.materials.base
        leaf = type(base)(*[c.detach().clone().requires_grad_()
                            for c in base])
        scene = rt.scene._replace(materials=rt.scene.materials._replace(
            base=leaf))
        settings = rt.settings.__class__(**{**rt.settings.__dict__,
                                            "remat": True})
        img = render_iteration(scene, settings, 0, 0)
        loss = ((img - target) ** 2).mean()
        grads.append(torch.stack(torch.autograd.grad(loss, list(leaf))))
    assert bool(torch.isfinite(grads[1]).all()) and bool(
        (grads[1] != 0).any())
    np.testing.assert_allclose(grads[1].numpy(), grads[0].numpy(),
                               rtol=1e-3, atol=1e-7)


# ---------------------------------------------------------------------------
# the instanced geometry gradient
# ---------------------------------------------------------------------------

def _leaf_soup(soup):
    return TriSoup(*[Vec3(*[c.detach().clone().requires_grad_() for c in v])
                     for v in soup])


def _small_grid():
    """_grid_scene(2) with its icosphere at subdivisions 1 (80 triangles),
    32x32, spi 1: 4 instances, and a flattened soup of 320 triangles, under
    the BVH threshold, so it keeps the entities' order."""
    sc = _grid_scene(2)
    sc["shapes"][0]["subdivisions"] = 1
    sc["film"]["size"] = [32, 32]
    return json.dumps(sc)


def _local_to_world(geo):
    """Each instance's local->world linear map L (float64 [I, 3, 3]) and
    offset c, inverted from w2l."""
    a = geo.w2l[:, :, :3].double()
    lin = torch.linalg.inv(a)
    return lin, -(lin @ geo.w2l[:, :, 3:].double())[..., 0]


def _soup_grad(scene, settings, soup_leaves, with_soup):
    img = render_iteration(with_soup(scene, soup_leaves), settings, 0, 0)
    loss = torch.mean(img.double() ** 2)
    return torch.autograd.grad(loss, [c for v in soup_leaves for c in v])


def _with_group_soup(scene, soup):
    (g,) = scene.instances
    return scene._replace(instances=(g._replace(soup=soup),))


def test_instanced_soup_gradient_matches_flattened():
    """The gradient of a 32x32 L2 loss w.r.t. the shared local soup (v0,
    e1, e2) equals the sum, over the 4 instances, of the flattened scene's
    gradients w.r.t. each world copy, pulled back through that instance's
    local->world linear map (L^T g): within 5e-5 of the largest entry
    (float32 sums over the lanes in two orders), on a soup the flattened
    scene's own to one ulp. Both renders replay each
    bounce's closest hit (MT replay, plain version here)."""
    doc = _small_grid()
    flat, inst = _flat_and_instanced(doc, spi=1)
    (geo,) = inst.scene.instances
    lin, off = _local_to_world(geo)
    n_inst, t_local = geo.n_instances, geo.tris_per_instance
    assert flat.scene.bvh is None and n_inst == 4
    for name, affine in (("v0", True), ("e1", False), ("e2", False)):
        local = torch.stack(list(getattr(geo.soup, name)), -1).double()
        world = torch.einsum("iab,tb->ita", lin, local)
        if affine:
            world = world + off[:, None, :]
        np.testing.assert_allclose(
            world.reshape(-1, 3).float().numpy(),
            torch.stack(list(getattr(flat.scene.tris, name)), -1).numpy(),
            rtol=0, atol=2.5e-7)
    settings = dataclasses.replace(inst.settings, remat=True)
    mt_replay.reset_counts()
    g_inst = _soup_grad(inst.scene, settings, _leaf_soup(geo.soup),
                        _with_group_soup)
    assert mt_replay.counts["plain_calls"] == settings.max_depth
    g_flat = _soup_grad(flat.scene, settings, _leaf_soup(flat.scene.tris),
                        lambda sc, s: sc._replace(tris=s))
    for k, name in enumerate(("v0", "e1", "e2")):
        got = torch.stack(g_inst[3 * k:3 * k + 3], -1).double()
        gw = torch.stack(g_flat[3 * k:3 * k + 3], -1).double()
        want = torch.einsum("iab,ita->tb", lin,
                            gw.reshape(n_inst, t_local, 3))
        assert bool(torch.isfinite(got).all()) and (got != 0).sum() > 20
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=5e-5 * float(want.abs().max()),
                                   err_msg=name)


def test_instanced_soup_gradient_matches_central_differences():
    """The same gradient against the port's central differences of the
    image loss on its two largest entries (eps 5e-3, rtol 0.1, as the flat
    soup's normal gradient): moving one local vertex moves it in every
    instance."""
    _, inst = _flat_and_instanced(_small_grid(), spi=1)
    (geo,) = inst.scene.instances
    settings = dataclasses.replace(inst.settings, remat=True)
    grad = np.stack([g.numpy() for g in _soup_grad(
        inst.scene, settings, _leaf_soup(geo.soup), _with_group_soup)])
    p0 = np.stack([c.numpy() for v in geo.soup for c in v])

    def loss_of(p):
        soup = TriSoup(*[Vec3(*[torch.from_numpy(p[3 * i + j].copy())
                                for j in range(3)]) for i in range(3)])
        with torch.no_grad():
            img = render_iteration(_with_group_soup(inst.scene, soup),
                                   settings, 0, 0)
        return float(torch.mean(img.double() ** 2))
    flat_g = np.abs(grad).reshape(-1)
    for i in np.argsort(-flat_g)[:2]:
        idx = np.unravel_index(int(i), grad.shape)
        hi, lo = p0.copy(), p0.copy()
        hi[idx] += 5e-3
        lo[idx] -= 5e-3
        fd = (loss_of(hi) - loss_of(lo)) / 1e-2
        np.testing.assert_allclose(grad[idx], fd, rtol=0.1, atol=1e-6)


def test_instanced_trace_vjp_matches_jax(grid8):
    """The VJP of the instanced closest hit's (t, u, v) at random
    cotangents, on the ~2,000 of _rays' 8,192 rays that hit an instance,
    w.r.t. the local soup, w2l and the rays' org and dir, against jax.vjp
    of ignis_tpu.ops.instanced.intersect_instanced (its soup's padding
    rows cut): finite on both sides, and within rtol 1e-4 plus 1e-4 of
    the array's largest entry on 99% of the entries and within 1e-3 of it
    on all. A few grazing hits part further: the forward u already
    differs by up to 1e-3 there (test_instanced_trace_matches_jax), since
    XLA contracts some products into FMAs."""
    from ignis_tpu.ops import instanced as jinst
    from ignis_tpu_torch.ops import instanced as inst
    rt, scene, _ = grid8
    (geo,), (jgeo,) = scene.instances, rt.scene.instances
    base = scene.tris.v0.x.shape[0] + scene.spheres.radius.shape[0]
    rays = _rays(scene)
    sel = torch.nonzero(inst.intersect_instanced(rays, geo, base).prim
                        >= 0).squeeze(1)
    rays = Rays(*[Vec3(*[c[sel] for c in v]) if isinstance(v, Vec3)
                  else v[sel] for v in rays])
    rng = np.random.default_rng(11)
    cts = [rng.normal(size=sel.shape[0]).astype(np.float32)
           for _ in range(3)]
    soup = _leaf_soup(geo.soup)
    w2l = geo.w2l.clone().requires_grad_()
    org, d = (Vec3(*[c.clone().requires_grad_() for c in v])
              for v in (rays.org, rays.dir))
    mt_replay.reset_counts()
    h = inst.intersect_instanced(Rays(org, d, rays.tmin, rays.tmax),
                                 geo._replace(soup=soup, w2l=w2l), base)
    loss = sum((torch.from_numpy(c) * x).sum()
               for c, x in zip(cts, (h.t, h.u, h.v)))
    got = torch.autograd.grad(loss, [*[c for v in soup for c in v], w2l,
                                     *org, *d])
    assert mt_replay.counts["plain_calls"] == 1

    jr = _jax_rays(rays)

    def trace(soup_, w2l_, o, d_):
        hh = jinst.intersect_instanced(jr._replace(org=o, dir=d_),
                                       jgeo._replace(soup=soup_, w2l=w2l_),
                                       base)
        return hh.t, hh.u, hh.v
    _, vjp = jax.vjp(trace, jgeo.soup, jgeo.w2l, jr.org, jr.dir)
    jsoup, jw2l, jo, jd = vjp(tuple(jnp.asarray(c) for c in cts))
    t_local = geo.tris_per_instance
    want = [np.asarray(c)[:t_local] for v in jsoup for c in v] + [
        np.asarray(jw2l)] + [np.asarray(c) for v in (jo, jd) for c in v]
    names = [f"{a}.{c}" for a in ("v0", "e1", "e2") for c in "xyz"] + [
        "w2l"] + [f"{a}.{c}" for a in ("org", "dir") for c in "xyz"]
    for name, a, b in zip(names, got, want):
        a = a.numpy()
        assert np.isfinite(b).all() and np.isfinite(a).all(), name
        scale = float(np.abs(b).max())
        assert scale > 0, name
        err = np.abs(a - b)
        assert (err <= 1e-4 * np.abs(b) + 1e-4 * scale).mean() >= 0.99, name
        assert err.max() <= 1e-3 * scale, name


def test_forward_without_grad_records_no_replay():
    """With grad mode on and nothing that moves a ray requiring grad (no
    leaf at all, then the albedo), the instanced closest hit replays
    nothing and returns the forward's own t, u and v; with the soup
    requiring grad it returns the same values, recorded."""
    from ignis_tpu_torch.ops import instanced as inst
    _, rt = _flat_and_instanced(_small_grid(), spi=1)
    (geo,) = rt.scene.instances
    rays = _rays(rt.scene, n_side=32)
    base = rt.scene.tris.v0.x.shape[0] + rt.scene.spheres.radius.shape[0]
    mt_replay.reset_counts()
    plain = inst.intersect_instanced(rays, geo, base)
    settings = dataclasses.replace(rt.settings, remat=True)
    leaf = type(rt.scene.materials.base)(*[
        c.clone().requires_grad_() for c in rt.scene.materials.base])
    img = render_iteration(rt.scene._replace(
        materials=rt.scene.materials._replace(base=leaf)), settings, 0, 0)
    torch.autograd.grad(img.sum(), list(leaf))
    assert mt_replay.counts["plain_calls"] == 0
    assert not plain.t.requires_grad
    rec = inst.intersect_instanced(rays, geo._replace(
        soup=_leaf_soup(geo.soup)), base)
    assert rec.t.requires_grad and rec.u.requires_grad
    for a, b in zip(rec, plain):
        np.testing.assert_array_equal(a.detach().numpy(), b.numpy())
