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
from ignis_tpu_torch.ops import bvh_cuda, gather, isect_cuda
from ignis_tpu_torch.ops.intersect import Hit, Rays
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
