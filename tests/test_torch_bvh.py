"""K1 (BVH8 walk) against ignis_tpu: the plain lockstep walk on the
bridged icosphere scene of tests/test_bvh.py:271-283, held against the XLA
walk on `bvh.tri` and the Pallas kernel (interpret mode) on `bvh.chunk`;
the port's own BVH against brute force. The CUDA kernel itself is checked
on the card (tests/test_torch_cuda.py, chip_smoke.py)."""
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
