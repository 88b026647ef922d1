"""Two-level instanced geometry: one local-space soup per mesh that two or
more entities share, and a world->local transform per instance.

Port of ignis_tpu/ops/instanced.py. The JAX package scans over the
instances and sends the whole ray block through the dense sweep once per
instance (K2's kernel on the TPU), dead-laning the rays that miss that
instance's world box. On the card that would be one kernel launch and a
few dozen small ops per instance per trace. Here one trace of a group
runs a bounded number of launches whatever its instance count:

1. the instances are cut into clusters of CLUSTER, in the Morton order
   of their box centres (`group_tables`, once per render), and every ray
   is slab-tested against every cluster's box, in chunks of clusters,
   into one [clusters, N] mask;
2. the passing (cluster, ray) pairs are compacted and expanded to the
   cluster's instances: CLUSTER candidate pairs each, the pair's ray and
   instance fetched through K3 (an [N, 8] ray table, an [I, 20] transform
   table); a candidate whose ray misses its instance's world box (the JAX
   package's slab test) becomes a dead lane (tmax < tmin). The eager
   trace compacts with `torch.nonzero`, its one host sync. A captured
   program's trace (techniques/program.py) compacts into the `cap` slots
   of the group's PairBudget with `torch.nonzero_static`, in the same
   row-major order and with no host sync: the slots past the count are
   dead candidates, which the kernels cull at once, and the count is
   folded into the budget's `seen` on the device, where the program reads
   an overflow (`seen > cap`) behind the step;
3. each candidate ray moves into its instance's local space with d
   unnormalised, so that local t equals world t, and all candidates go
   through the local soup's kernel as one ray batch: K1 over the group's
   own BVH when the soup has one (BVH_THRESHOLD triangles or more, the
   rule trace_scene follows), else K2 on its packed tiles;
4. the closest hit of each ray is one scatter_reduce(amin) of the int64
   key (t bits << 32) | prim, whose f32 bits order like t since t >= 0;
   the winning candidate's u and v come back through K3's scatter-add
   (every other candidate adds zero). The key keeps the JAX tie rule: the
   scan's strict `<` keeps the earlier instance, which has the lower prim.
   Any hit is a scatter_reduce(amax) over the candidates of shadow-visible
   instances.

A hit's prim is prim_base + inst * T + local prim, T the group's own
triangle count (the JAX package pads the local soup to a multiple of 256
for its TPU chunks; the port does not). `instanced_surface` fetches the
local attributes through K3 from the group's [T, 24] attribute table and
the instance's normal matrix and entity id through K3 from its [I, 12]
instance table.

The forward above picks each ray's winner with no gradient. When grad
mode is on and the shared soup, the transforms or the rays require
grad, the closest hit is also recorded for reverse mode
(`_differentiable_hit`): each ray's winning instance and local triangle
come from the fold, its local ray is rebuilt with autograd from the
instance's w2l (a K3 gather of a live [I, 12] table, so the transform
gradients come back through K3's scatter-add), and Moeller-Trumbore is
replayed at that fixed winner through ops/mt_replay.ClosestHit (the MT
replay kernel on the card, its plain version on the CPU). t is the same
in local and world space, so t, u and v carry gradients to the soup, to
w2l and to the world ray, as the JAX package's `_local_rays` and dense
sweep do. Rays that miss get none; any hit stays detached. The group's
attribute table is built from the live soup, normals and uvs when they
require grad, so that `instanced_surface`'s K3 gather scatter-adds into
them.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..core.vec import Vec2, Vec3
from . import bvh_cuda, isect_cuda, mt_replay
from . import gather as gatherlib
from .bvh import BVHArrays
from .intersect import FLT_MAX, Hit, Rays, TriSoup

CLUSTER = 16              # instances a cluster
SLAB_ELEMENTS = 1 << 24   # (cluster, ray) slab tests a chunk at most
INST_COLS = 10            # the instance table: normal matrix, entity id
TRACE_COLS = 19           # the transform table: w2l, box, shadow_visible
ATTR_COLS = 21            # the group's attribute table: e1, e2, n*, uv*
NO_HIT = torch.iinfo(torch.int64).max


class InstancedGeo(NamedTuple):
    """One shared local-space mesh and its instances (scene/build.py makes
    one per reused shape). `bvh` is the local soup's own BVH8 when it has
    BVH_THRESHOLD triangles or more, else None."""
    soup: TriSoup
    n0: Vec3
    n1: Vec3
    n2: Vec3
    uv0: Vec2
    uv1: Vec2
    uv2: Vec2
    w2l: torch.Tensor             # [I, 3, 4] world -> local affine
    nrm_mat: torch.Tensor         # [I, 3, 3] normal matrix (w2l linear)^T
    ent: torch.Tensor             # [I] i32 entity ids
    shadow_visible: torch.Tensor  # [I] bool
    aabb_min: torch.Tensor        # [I, 3] world-space instance bounds
    aabb_max: torch.Tensor        # [I, 3]
    bvh: Optional[BVHArrays] = None

    @property
    def n_instances(self) -> int:
        return self.w2l.shape[0]

    @property
    def tris_per_instance(self) -> int:
        return self.soup.v0.x.shape[0]


class PairBudget:
    """The (cluster, ray) pair capacity of one group's traces in a captured
    program. With `cap` None the trace compacts with torch.nonzero and
    keeps the largest pair count it saw in `largest` (the program's
    sizing run); with `cap` set it compacts into cap slots with no host
    sync and folds its count into `seen`, a 0-d int64 on the device that
    the program zeroes before each step and reads behind it."""

    def __init__(self, device):
        self.cap = None
        self.largest = 0
        self.seen = torch.zeros((), dtype=torch.int64, device=device)

    @property
    def nbytes(self) -> int:
        """Bytes of a trace's main candidate buffers at this capacity:
        a candidate's 8 ray columns, 19 transform columns, 7 local-ray
        columns and 4 kernel results (f32), its int32 ray id and int64
        instance id."""
        return 0 if self.cap is None else self.cap * CLUSTER * (38 * 4 + 12)


class GroupTables(NamedTuple):
    """What a render makes once per group: the local soup packed for its
    kernel (K1's rows with a BVH, K2's tiles without), the [T, 24]
    attribute table, the [I, 12] instance table, the [I, 20] transform
    table, the clusters' members ([C, CLUSTER] int32, -1 padding) and
    padded boxes ([C, 3] each); and, in a captured program's tables, the
    group's PairBudget (None: the eager trace)."""
    packed: object
    attr: torch.Tensor
    inst: torch.Tensor
    xform: torch.Tensor
    members: torch.Tensor
    box_lo: torch.Tensor
    box_hi: torch.Tensor
    pairs: Optional[PairBudget] = None


def _morton(p: torch.Tensor) -> torch.Tensor:
    lo, hi = p.amin(0), p.amax(0)
    ext = torch.clamp((hi - lo).amax(), min=1e-30)
    g = ((p - lo) / ext * 1023.0).clamp(0, 1023).long()
    spread = isect_cuda._spread10
    return spread(g[:, 0]) | (spread(g[:, 1]) << 1) | (spread(g[:, 2]) << 2)


def group_tables(geo: InstancedGeo) -> GroupTables:
    """The tables of one group (plain torch on the group's device). The
    attribute and instance tables record for reverse mode when grad mode
    is on and their columns require grad; the kernels' tables never
    do."""
    n_inst = geo.n_instances
    attr = gatherlib.stack_cols([*geo.soup.e1, *geo.soup.e2, *geo.n0,
                                 *geo.n1, *geo.n2, *geo.uv0, *geo.uv1,
                                 *geo.uv2])
    inst = gatherlib.stack_cols([*geo.nrm_mat.reshape(n_inst, 9).t(),
                                 geo.ent.to(torch.float32)])
    return GroupTables(attr=attr, inst=inst, **_trace_tables(geo))


@torch.no_grad()
def _trace_tables(geo: InstancedGeo):
    """group_tables' packed soup, transform table, cluster members and
    boxes, made with no gradient."""
    packed = (bvh_cuda.pack_tris(geo.soup) if geo.bvh is not None
              else isect_cuda.pack_soup(geo.soup))
    n_inst = geo.n_instances
    xform = gatherlib.stack_cols([*geo.w2l.reshape(n_inst, 12).t(),
                                  *geo.aabb_min.t(), *geo.aabb_max.t(),
                                  geo.shadow_visible.to(torch.float32)])
    order = torch.argsort(_morton(0.5 * (geo.aabb_min + geo.aabb_max)),
                          stable=True).to(torch.int32)
    n_cl = -(-n_inst // CLUSTER)
    members = torch.full((n_cl * CLUSTER,), -1, dtype=torch.int32,
                         device=order.device)
    members[:n_inst] = order
    members = members.reshape(n_cl, CLUSTER)
    valid = (members >= 0)[..., None]
    m = members.clamp(min=0).long()
    lo = torch.where(valid, geo.aabb_min[m], float("inf")).amin(1)
    hi = torch.where(valid, geo.aabb_max[m], float("-inf")).amax(1)
    # padded, so the cluster test never drops a pair the instance's own
    # slab test keeps
    pad = 1e-4 * (hi - lo).amax(1, keepdim=True) + 1e-6 * torch.maximum(
        lo.abs(), hi.abs()).amax(1, keepdim=True)
    return {"packed": packed, "xform": xform, "members": members,
            "box_lo": lo - pad, "box_hi": hi + pad}


def _inv(d):
    return torch.where(torch.abs(d) > 1e-12, 1.0 / d,
                       torch.where(d >= 0, 1e12, -1e12))


def _slab(org, inv, tmin, tmax, lo, hi):
    """The JAX package's world-box slab test (_slab_hits); org, inv: the
    ray's per-axis tensors, lo, hi: the box's, all broadcastable."""
    tn, tf = tmin, tmax
    for o, i, a, b in zip(org, inv, lo, hi):
        t0, t1 = (a - o) * i, (b - o) * i
        tn = torch.maximum(tn, torch.minimum(t0, t1))
        tf = torch.minimum(tf, torch.maximum(t0, t1))
    return tn <= tf


def _cluster_pairs(rays: Rays, tabs: GroupTables):
    """(cluster, ray) index pairs whose ray meets the cluster's box, as
    int64 [P] each, and which of them are pairs (None: all). Eager
    (tabs.pairs None or unsized): P is the count, found by torch.nonzero,
    the trace's one host sync. In a captured program: P is the budget's
    cap (_fixed_pairs)."""
    n = rays.tmin.shape[0]
    inv = [_inv(d) for d in rays.dir]
    n_cl = tabs.members.shape[0]
    step = max(1, SLAB_ELEMENTS // max(n, 1))
    mask = torch.empty((n_cl, n), dtype=torch.bool, device=rays.tmin.device)
    for c0 in range(0, n_cl, step):
        c1 = min(n_cl, c0 + step)
        lo = [tabs.box_lo[c0:c1, a, None] for a in range(3)]
        hi = [tabs.box_hi[c0:c1, a, None] for a in range(3)]
        mask[c0:c1] = _slab(rays.org, inv, rays.tmin, rays.tmax, lo, hi)
    pairs = tabs.pairs
    if pairs is not None and pairs.cap is not None:
        return _fixed_pairs(mask, pairs)
    cl, ray = torch.nonzero(mask, as_tuple=True)
    if pairs is not None:
        pairs.largest = max(pairs.largest, cl.shape[0])
    return cl, ray, None


def _fixed_pairs(mask: torch.Tensor, pairs: PairBudget):
    """The first pairs.cap set entries of the [C, N] mask in row-major
    order (torch.nonzero's), as cluster and ray indices, and which slots
    hold one; the mask's count is folded into pairs.seen. No host sync."""
    n = mask.shape[1]
    flat = mask.reshape(-1)
    idx = torch.nonzero_static(flat, size=pairs.cap,
                               fill_value=-1).squeeze(1)
    pairs.seen.copy_(torch.maximum(pairs.seen, flat.sum()))
    live = idx >= 0
    # a free slot points at ray (slot mod n) of cluster 0: its dead
    # candidates fold neutral values (no hit, no occlusion, zero u and v)
    # into rays spread over the batch, where all at ray 0 would serialise
    # the folds' atomics on one address
    slot = torch.arange(pairs.cap, device=idx.device)
    idx = torch.where(live, idx, slot % n)
    return idx // n, idx % n, live


def _candidates(rays: Rays, geo: InstancedGeo, tabs: GroupTables,
                any_hit: bool):
    """The candidate (instance, ray) lanes of a trace: (ray index [Q]
    int32, instance index [Q] int64, local rays [Q] whose dead lanes
    missed their instance's box or are no candidate)."""
    cl, ray, live = _cluster_pairs(rays, tabs)
    q = cl.shape[0] * CLUSTER
    ray_q = ray.to(torch.int32).repeat_interleave(CLUSTER)
    inst = tabs.members[cl].reshape(q)
    ok = inst >= 0
    if live is not None:
        ok = ok & live.repeat_interleave(CLUSTER)
    inst = inst.clamp(min=0)
    rtab = gatherlib.stack_cols([*rays.org, *rays.dir, rays.tmin, rays.tmax])
    ox, oy, oz, dx, dy, dz, tmin, tmax = gatherlib.gather_block(
        ray_q, rtab, 8).unbind(0)
    x = gatherlib.gather_block(inst, tabs.xform, TRACE_COLS).unbind(0)
    m = x[:12]
    org, d = (ox, oy, oz), (dx, dy, dz)
    ok = ok & _slab(org, [_inv(c) for c in d], tmin, tmax, x[12:15],
                    x[15:18])
    if any_hit:
        ok = ok & (x[18] > 0.5)
    o = Vec3(*[m[4 * r] * ox + m[4 * r + 1] * oy + m[4 * r + 2] * oz
               + m[4 * r + 3] for r in range(3)])
    dl = Vec3(*[m[4 * r] * dx + m[4 * r + 1] * dy + m[4 * r + 2] * dz
                for r in range(3)])
    local = Rays(o, dl, tmin, torch.where(ok, tmax, -1.0))
    return ray_q, inst.long(), local


def _local_trace(local: Rays, geo: InstancedGeo, tabs: GroupTables,
                 any_hit: bool):
    """One launch of the local soup's kernel over every candidate. On the
    CPU, whose plain sweep pays for every lane, dead or not, only the live
    candidates go through it (the card's kernels cull dead lanes at once,
    and compacting them would cost a second host sync)."""
    def trace(rays):
        if geo.bvh is not None:
            return bvh_cuda.intersect_bvh(rays, geo.soup, geo.bvh,
                                          any_hit=any_hit,
                                          tri_rows=tabs.packed)
        return isect_cuda.intersect_tris(rays, geo.soup, any_hit=any_hit,
                                         packed=tabs.packed)
    if local.tmin.device.type != "cpu":
        return trace(local)
    live = torch.nonzero(local.tmax >= local.tmin).squeeze(1)
    h = trace(Rays(*[Vec3(*[c[live] for c in v]) if isinstance(v, Vec3)
                     else v[live] for v in local]))
    q = local.tmin.shape[0]
    if any_hit:
        return torch.zeros(q, dtype=torch.bool).index_copy_(0, live, h)
    return Hit(torch.full((q,), FLT_MAX).index_copy_(0, live, h.t),
               torch.full((q,), -1, dtype=torch.int32).index_copy_(
                   0, live, h.prim),
               torch.zeros(q).index_copy_(0, live, h.u),
               torch.zeros(q).index_copy_(0, live, h.v))


def intersect_instanced(rays: Rays, geo: InstancedGeo, prim_base: int,
                        any_hit: bool = False, tabs: GroupTables = None):
    """Closest hit over all instances of `geo` (a Hit whose prim is
    prim_base + inst * T + local prim, -1 on a miss), or with `any_hit`
    the bool occlusion by its shadow-visible instances. `tabs` is
    group_tables(geo), made here when not given. The closest hit is
    differentiable in the soup, w2l and the rays' org and dir when one of
    them requires grad (`_differentiable_hit`)."""
    if tabs is None:
        tabs = group_tables(geo)
    hit = _fixed_hit(rays, geo, prim_base, any_hit, tabs)
    if any_hit or not _wants_grad(rays, geo):
        return hit
    return _differentiable_hit(rays, geo, prim_base, hit)


def _wants_grad(rays: Rays, geo: InstancedGeo) -> bool:
    return mt_replay.wants_grad(rays, geo.soup) or (
        torch.is_grad_enabled() and geo.w2l.requires_grad)


@torch.no_grad()
def _fixed_hit(rays: Rays, geo: InstancedGeo, prim_base: int,
               any_hit: bool, tabs: GroupTables):
    """intersect_instanced's forward: the winners, with no gradient."""
    n = rays.tmin.shape[0]
    device = rays.tmin.device
    ray_q, inst, local = _candidates(rays, geo, tabs, any_hit)
    h = _local_trace(local, geo, tabs, any_hit)
    idx = ray_q.long()
    if any_hit:
        occ = torch.zeros(n, dtype=torch.int32, device=device)
        occ.scatter_reduce_(0, idx, h.to(torch.int32), "amax")
        return occ > 0
    found = h.prim >= 0
    prim = prim_base + inst * geo.tris_per_instance + h.prim.clamp(min=0)
    key = torch.where(found, (h.t.view(torch.int32).to(torch.int64) << 32)
                      | prim, NO_HIT)
    best = torch.full((n,), NO_HIT, dtype=torch.int64, device=device)
    best.scatter_reduce_(0, idx, key, "amin")
    win = found & (key == best[idx])
    uv = gatherlib.scatter_add_rows(
        ray_q, torch.stack([torch.where(win, h.u, 0.0),
                            torch.where(win, h.v, 0.0)]), n, 4)
    hit = best != NO_HIT
    t = (best >> 32).to(torch.int32).view(torch.float32)
    return Hit(torch.where(hit, t, FLT_MAX),
               torch.where(hit, best & 0xFFFFFFFF, -1).to(torch.int32),
               uv[:, 0].contiguous(), uv[:, 1].contiguous())


def _differentiable_hit(rays: Rays, geo: InstancedGeo, prim_base: int,
                        hit: Hit) -> Hit:
    """`hit` (the fixed winners) recorded for reverse mode: each ray's
    local ray at its winning instance, o' = A o + b and d' = A d (d'
    unnormalised, as the JAX package's _local_rays), rebuilt with autograd
    from a K3 gather of the live w2l table, then Moeller-Trumbore replayed
    at the winning local triangle (mt_replay.ClosestHit). The values are
    hit's; rays that miss get no gradient."""
    T = geo.tris_per_instance
    local = (hit.prim - prim_base).clamp(min=0)
    inst = torch.clamp(local // T, 0, geo.n_instances - 1).to(torch.int32)
    lp = torch.where(hit.prim >= 0, local % T, -1).to(torch.int32)
    w2l = gatherlib.stack_cols(geo.w2l.reshape(geo.n_instances, 12).t())
    m = gatherlib.gather_block(inst, w2l, 12).unbind(0)
    o = Vec3(*[m[4 * r] * rays.org.x + m[4 * r + 1] * rays.org.y
               + m[4 * r + 2] * rays.org.z + m[4 * r + 3] for r in range(3)])
    d = Vec3(*[m[4 * r] * rays.dir.x + m[4 * r + 1] * rays.dir.y
               + m[4 * r + 2] * rays.dir.z for r in range(3)])
    # fresh tensors: the autograd.Function takes its outputs over
    fixed = Hit(hit.t.clone(), lp, hit.u.clone(), hit.v.clone())
    t, _, u, v = mt_replay.closest_hit(lambda r, s: fixed,
                                       Rays(o, d, rays.tmin, rays.tmax),
                                       geo.soup)
    return Hit(t, hit.prim, u, v)


def instanced_surface(geo: InstancedGeo, tabs: GroupTables, prim_local):
    """Per hit, the local attributes of its triangle and its instance's
    normal matrix and entity id, each through one K3 gather:
    (face normal, n0, n1, n2 in world space, unnormalised; uv0, uv1, uv2;
    entity id). `prim_local` = prim - prim_base, clamped by the caller."""
    T = geo.tris_per_instance
    inst = torch.clamp(prim_local // T, 0, geo.n_instances - 1)
    lp = torch.clamp(prim_local % T, 0, T - 1)
    (e1x, e1y, e1z, e2x, e2y, e2z, n0x, n0y, n0z, n1x, n1y, n1z,
     n2x, n2y, n2z, uv0x, uv0y, uv1x, uv1y, uv2x, uv2y) = \
        gatherlib.gather_block(lp.to(torch.int32), tabs.attr,
                               ATTR_COLS).unbind(0)
    icols = gatherlib.gather_block(inst.to(torch.int32), tabs.inst,
                                   INST_COLS).unbind(0)
    nm = icols[:9]
    ent = torch.round(icols[9]).to(torch.int32)

    def xform_n(x, y, z):
        return Vec3(nm[0] * x + nm[1] * y + nm[2] * z,
                    nm[3] * x + nm[4] * y + nm[5] * z,
                    nm[6] * x + nm[7] * y + nm[8] * z)

    fn_local = (e1y * e2z - e1z * e2y, e1z * e2x - e1x * e2z,
                e1x * e2y - e1y * e2x)
    return (xform_n(*fn_local), xform_n(n0x, n0y, n0z),
            xform_n(n1x, n1y, n1z), xform_n(n2x, n2y, n2z),
            Vec2(uv0x, uv0y), Vec2(uv1x, uv1y), Vec2(uv2x, uv2y), ent)
