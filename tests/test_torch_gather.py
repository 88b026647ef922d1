"""K3 at its column layout against ignis_tpu/ops/gather.py, and the hit
shader's fetch through it.

The attribute table is padded to a row stride that is a multiple of 4
(`gather.stack_cols`, `path.attr_table`) and the gather returns K
contiguous [N] columns, as the JAX function does. Here the plain versions
run (tensors on the CPU); the CUDA kernels are held against them on the
card (tests/test_torch_cuda.py, chip_smoke.py phase 7)."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import torch

import chip_smoke
import ignis_tpu_torch
from ignis_tpu.ops.gather import gather_cols as jax_gather_cols
from ignis_tpu_torch.ops import gather
from ignis_tpu_torch.techniques import path

from test_torch_bvh import ICO_SCENE

# The tensors here are small; one intra-op thread per test process keeps
# parallel test workers from oversubscribing the cores.
torch.set_num_threads(1)


def _contended(rng, n, t_rows):
    """Indices as the main path's: half on two rows, a third on row 0 (the
    row a miss is clamped to), the rest at random; and the mask of the
    row-0 lanes, whose cotangents are zero as a masked miss's are."""
    idx = rng.integers(0, t_rows, n)
    half, third = n // 2, n // 3
    idx[:half] = rng.choice([5, 11], half)
    idx[half:half + third] = 0
    order = rng.permutation(n)
    miss = np.zeros(n, bool)
    miss[half:half + third] = True
    return idx[order].astype(np.int32), miss[order]


def test_k3_padded_table_and_columns_match_jax():
    """gather_cols on contended indices against JAX gather_cols: the
    Pallas kernel (interpret) carries bf16 hi/lo rounding, about 2^-18
    relative, hence rtol 1e-5; the plain `tab[idx]` path exactly. The
    columns come back contiguous. The backward against jax.grad of
    sum(w * out), w zero on the row-0 lanes: rtol 1e-6 / atol 1e-7 (sums
    in another order); through the padded [T, 24] table the two padding
    columns get exactly zero."""
    rng = np.random.default_rng(19)
    n, t_rows, k = 4096, 1500, 22
    cols = [rng.normal(size=t_rows).astype(np.float32) for _ in range(k)]
    idx, miss = _contended(rng, n, t_rows)
    w = rng.normal(size=(k, n)).astype(np.float32)
    w[:, miss] = 0.0
    jcols = [jnp.asarray(c) for c in cols]
    leaves = [torch.from_numpy(c).requires_grad_() for c in cols]
    gather.reset_counts()
    out = gather.gather_cols(torch.from_numpy(idx), leaves)
    assert len(out) == k and all(c.is_contiguous() and c.shape == (n,)
                                 for c in out)
    got = torch.stack(out).detach().numpy()
    ref_interp = np.stack([np.asarray(c) for c in jax_gather_cols(
        jnp.asarray(idx), jcols, interpret=True)])
    ref_plain = np.stack([np.asarray(c) for c in jax_gather_cols(
        jnp.asarray(idx), jcols, interpret=False)])
    np.testing.assert_allclose(got, ref_interp, rtol=1e-5, atol=0)
    np.testing.assert_array_equal(got, ref_plain)

    g = torch.autograd.grad(torch.sum(torch.from_numpy(w) * torch.stack(out)),
                            leaves)
    assert gather.gather_counts == {"launches": 0, "plain_calls": 1}
    assert gather.scatter_counts == {"launches": 0, "plain_calls": 1}

    def jloss(cs):
        o = jax_gather_cols(jnp.asarray(idx), cs, interpret=True)
        return jnp.sum(jnp.asarray(w) * jnp.stack(o))
    ref_g = jax.grad(jloss)(jcols)
    for a, b in zip(g, ref_g):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)

    tab = gather.stack_cols([torch.from_numpy(c) for c in cols])
    assert tab.shape == (t_rows, 24) and not tab[:, k:].any()
    tab.requires_grad_()
    block = gather.gather_block(torch.from_numpy(idx), tab, k)
    (dtab,) = torch.autograd.grad(torch.sum(torch.from_numpy(w) * block),
                                  [tab])
    assert dtab.shape == (t_rows, 24)
    assert torch.equal(dtab[:, k:], torch.zeros(t_rows, 24 - k))
    assert torch.equal(dtab[:, :k], torch.stack(g, dim=1))


def test_k3_scatter_of_special_values_matches_index_add():
    """A cotangent block holding NaN, -0.0 and inf: the plain scatter is
    index_add_ into zeros column by column, NaN and inf land in their
    rows, -0.0 leaves +0, and nothing reaches the padding columns."""
    idx = torch.tensor([2, 0, 2, 1, 3], dtype=torch.int32)
    g = torch.zeros(3, 5)
    g[0, 0] = float("nan")
    g[1, 1] = -0.0
    g[2, 3] = float("inf")
    g[1, 4] = 1.5
    dtab = gather.scatter_add_rows(idx, g, 4, 4)
    ref = torch.zeros(4, 3).index_add_(0, idx.long(), g.t())
    assert torch.equal(dtab[:, :3].isnan(), ref.isnan())
    assert dtab[2, 0].isnan() and dtab[1, 2] == float("inf")
    fin = ~ref.isnan()
    assert torch.equal(dtab[:, :3][fin], ref[fin])
    assert not torch.signbit(dtab[0, 1]) and not dtab[:, 3].any()


def test_compute_surface_padded_matches_unpadded_rows(monkeypatch):
    """compute_surface through the padded [T, 24] table and its contiguous
    columns equals, bit for bit, the same function fed the strided columns
    of an [N, 22] row gather of the unpadded table (the layout before the
    column block), on the icosphere of tests/test_bvh.py:271 with camera
    rays that hit and miss."""
    rt = ignis_tpu_torch.loadFromString(json.dumps(ICO_SCENE), device="cpu")
    scene = rt.scene
    tab = path.attr_table(scene)
    n_tri = scene.tris.v0.x.numel()
    assert tab.shape == (n_tri, 24) and not tab[:, path.ATTR_COLS:].any()
    ta = scene.tri_attr
    old_tab = torch.stack([*scene.tris.e1, *scene.tris.e2, *ta.n0, *ta.n1,
                           *ta.n2, *ta.uv0, *ta.uv1, *ta.uv2,
                           ta.ent.to(torch.float32)], dim=1)
    assert torch.equal(tab[:, :path.ATTR_COLS], old_tab)

    rays = chip_smoke.camera_rays(scene, rt.settings, 4096, "cpu")
    hit = path.trace_scene(scene, rays)
    hits = (hit.prim >= 0).float().mean()
    assert 0.05 < hits < 0.95
    new = path.compute_surface(scene, rays, hit, tab)
    monkeypatch.setattr(gather, "gather_block",
                        lambda idx, tab, k: old_tab[idx.long()].t())
    old = path.compute_surface(scene, rays, hit, tab)
    for f, a, b in zip(new._fields, new, old):
        for x, y in (zip(a, b) if isinstance(a, tuple) else [(a, b)]):
            assert torch.equal(x, y), f
