"""K2: dense closest-hit / any-hit, CUDA kernel and plain versions.

The kernel (csrc/isect_dense.cu) replaces
ignis_tpu/ops/pallas_isect.py::_isect_kernel. `intersect_tris` launches it
for rays on a CUDA device and raises if it cannot; for rays on the CPU it
takes `intersect_tris_plain`, a loop over 256-triangle chunks like
ignis_tpu/ops/intersect.py:130-213. `counts` holds the kernel's launch
count and the plain version's call count. A closest-hit query whose rays
or soup require grad (with grad mode on) goes through
`mt_replay.ClosestHit`, whose backward is the fixed-winner replay
(ops/mt_replay.py); any-hit is detached, as JAX's `stop_gradient`.

The kernel reads the soup packed by `pack_soup` (plain torch): rows in a
spatial order, each carrying its original prim id, in tiles of at most
TILE triangles with padded boxes, which a warp culls. Callers on the main
path pack once per render (techniques/path.render_lanes) and pass the pack
down; a call without one packs its own. `intersect_packed_plain` replays
the kernel's walk over a pack in plain torch: its tile order, its culls
and its tie rule, and it counts the culls that would have dropped a hit.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..core.vec import Vec3
from . import cuda_build, mt_replay
from .intersect import FLT_MAX, Hit, Rays, TriSoup, moeller_trumbore

CHUNK = 256       # triangles per chunk of the plain version
TILE = 16         # triangles a tile at most (csrc/isect_dense.cu TILE)
CHUNK_TILES = 32  # tiles in the kernel's shared memory at once
ROW = 12          # floats a packed triangle
# A triangle whose box's largest side exceeds BIG_SHARE of the soup's is
# tiled apart from the rest, so that it widens no tile of small ones.
BIG_SHARE = 0.125
# Box margin: PAD_REL of the soup's largest side plus PAD_ABS of its
# largest coordinate, far above the rounding of v0 + e1 and of a hit
# point that Moeller-Trumbore accepts at the edge of a triangle.
PAD_REL = 2e-4
PAD_ABS = 1e-6
SLAB_SLACK = 2e-6   # the slab test widens tfar by this share of itself
DIRECT = 4          # a tile of at most this many triangles is not culled
counts = cuda_build.Counts()
reset_counts = counts.reset
_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int]
             + [ctypes.c_void_p, ctypes.c_int] * 2
             + [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 6)


class SoupPack(NamedTuple):
    """The soup as K2 reads it. rows: [T, 12] f32 in tile order, v0 xyz
    and the original prim id (int32 bits), e1 xyz and 0, e2 xyz and 0.
    tiles: [n_tiles, 8] f32, the padded box's min xyz and the tile's first
    row (int32 bits), its max xyz and its row count (int32 bits)."""
    rows: torch.Tensor
    tiles: torch.Tensor


def _kernel():
    return cuda_build.load_kernel("isect_dense", "ig_isect_dense", _ARGTYPES)


def build() -> None:
    """Compile (or load) the kernel library."""
    _kernel()


def _spread10(x):
    """The 10 low bits of int64 x moved to every third bit."""
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    return (x | (x << 2)) & 0x09249249


def _bits(a: torch.Tensor) -> torch.Tensor:
    """int32 values carried in a float32 column, and back."""
    if a.dtype == torch.float32:
        return a.contiguous().view(torch.int32)
    return a.to(torch.int32).contiguous().view(torch.float32)


@torch.no_grad()
def pack_soup(soup: TriSoup) -> SoupPack:
    """K2's packing of `soup` (plain torch, on its device, detached): the
    large triangles first, then the rest, each group in the Morton order of
    its box centres on a 1024^3 grid of the soup's box, cut into tiles of
    up to TILE consecutive rows; each tile's box padded by the margin."""
    v0, e1, e2 = (torch.stack(tuple(v), 1).detach()
                  for v in (soup.v0, soup.e1, soup.e2))
    n = v0.shape[0]
    if n == 0:
        z = v0.new_zeros
        return SoupPack(z((0, ROW)), z((0, 8)))
    b, c = v0 + e1, v0 + e2
    lo = torch.minimum(torch.minimum(v0, b), c)
    hi = torch.maximum(torch.maximum(v0, b), c)
    s_lo, s_hi = lo.amin(0), hi.amax(0)
    ext = (s_hi - s_lo).amax()
    big = (hi - lo).amax(1) > ext * BIG_SHARE
    cell = ((lo + hi) * 0.5 - s_lo) / torch.clamp(ext, min=1e-30) * 1023.0
    g = cell.clamp(0, 1023).long()
    code = (_spread10(g[:, 0]) | (_spread10(g[:, 1]) << 1)
            | (_spread10(g[:, 2]) << 2))
    order = torch.argsort(((~big).long() << 30) | code, stable=True)
    n_big = int(big.sum())
    starts = [*range(0, n_big, TILE), *range(n_big, n, TILE)]
    counts_ = [min(TILE, (n_big if s < n_big else n) - s) for s in starts]
    r = torch.arange(n, device=v0.device)
    tile = torch.where(r < n_big, r // TILE,
                       -(-n_big // TILE) + (r - n_big) // TILE)
    idx = tile[:, None].expand(n, 3)
    pad = PAD_REL * ext + PAD_ABS * torch.maximum(s_lo.abs().amax(),
                                                  s_hi.abs().amax())
    box_lo = v0.new_full((len(starts), 3), float("inf")).scatter_reduce(
        0, idx, lo[order], "amin") - pad
    box_hi = v0.new_full((len(starts), 3), float("-inf")).scatter_reduce(
        0, idx, hi[order], "amax") + pad
    meta = _bits(torch.tensor([starts, counts_], dtype=torch.int32).t()
                 ).to(v0.device)
    z = v0.new_zeros((n, 1))
    rows = torch.cat([v0[order], _bits(order)[:, None], e1[order], z,
                      e2[order], z], 1)
    return SoupPack(rows.contiguous(),
                    torch.cat([box_lo, meta[:, :1], box_hi, meta[:, 1:]],
                              1).contiguous())


def intersect_tris(rays: Rays, soup: TriSoup, shadow_visible=None,
                   any_hit: bool = False, packed: SoupPack = None):
    """Closest hit (a Hit) or any-hit occlusion (a bool tensor) of every
    ray against the whole soup. `shadow_visible` ([T] bool) gates the
    any-hit test. `packed` is pack_soup(soup), made by the caller once for
    many calls; without it the call packs its own."""
    if not any_hit and mt_replay.wants_grad(rays, soup):
        return mt_replay.closest_hit(
            lambda r, s: _intersect(r, s, None, False, packed), rays, soup)
    return _intersect(rays, soup, shadow_visible, any_hit, packed)


@torch.no_grad()
def _intersect(rays: Rays, soup: TriSoup, shadow_visible, any_hit: bool,
               packed: SoupPack):
    device = rays.tmin.device
    if device.type == "cpu":
        return intersect_tris_plain(rays, soup, shadow_visible, any_hit)
    if device.type != "cuda":
        raise ValueError(f"K2 has no kernel for device {device}")
    a = cuda_build.prepare_hit_launch("K2", rays, soup, shadow_visible,
                                      any_hit)
    if packed is None:
        packed = pack_soup(soup)
    n_tiles = packed.tiles.shape[0]
    cuda_build.check_inputs("K2 rows", device, a.n_tris * ROW, packed.rows)
    cuda_build.check_inputs("K2 tiles", device, n_tiles * 8, packed.tiles)
    for what, t in (("rows", packed.rows), ("tiles", packed.tiles)):
        if t.data_ptr() % 16:
            raise ValueError(f"K2: {what} not 16-byte aligned")
    if a.n:
        cuda_build.launch("K2 isect_dense", counts, _kernel(), *a.rays, a.n,
                          packed.rows.data_ptr(), a.n_tris,
                          packed.tiles.data_ptr(), n_tiles, a.vis,
                          int(any_hit), *a.outs, a.stream)
    return a.result


def intersect_tris_plain(rays: Rays, soup: TriSoup, shadow_visible=None,
                         any_hit: bool = False):
    """Plain torch version: a loop over CHUNK-triangle chunks with an
    argmin per chunk (lowest prim on equal t)."""
    counts["plain_calls"] += 1
    device = rays.tmin.device
    n = rays.tmin.shape[0]
    n_tris = soup.v0.x.shape[0]
    org = Vec3(*[a[:, None] for a in rays.org])
    d = Vec3(*[a[:, None] for a in rays.dir])
    tmin = rays.tmin[:, None]
    tmax = rays.tmax[:, None]
    if any_hit:
        occ = torch.zeros(n, dtype=torch.bool, device=device)
    else:
        best_t = torch.full((n,), FLT_MAX, dtype=torch.float32, device=device)
        best_p = torch.full((n,), -1, dtype=torch.int32, device=device)
        best_u = torch.zeros(n, dtype=torch.float32, device=device)
        best_v = torch.zeros(n, dtype=torch.float32, device=device)
    for c0 in range(0, n_tris, CHUNK):
        sl = slice(c0, min(c0 + CHUNK, n_tris))
        v0 = Vec3(*[a[None, sl] for a in soup.v0])
        e1 = Vec3(*[a[None, sl] for a in soup.e1])
        e2 = Vec3(*[a[None, sl] for a in soup.e2])
        t, u, v, ok = moeller_trumbore(org, d, v0, e1, e2)
        ok = ok & (t > tmin) & (t < tmax)
        if any_hit:
            if shadow_visible is not None:
                ok = ok & shadow_visible[None, sl]
            occ = occ | ok.any(dim=1)
            continue
        ok = ok & (t < best_t[:, None])
        t_masked = torch.where(ok, t, FLT_MAX)
        j = torch.argmin(t_masked, dim=1, keepdim=True)
        t_j = torch.gather(t_masked, 1, j)[:, 0]
        got = t_j < best_t
        best_t = torch.where(got, t_j, best_t)
        best_p = torch.where(got, (c0 + j[:, 0]).to(torch.int32), best_p)
        best_u = torch.where(got, torch.gather(u, 1, j)[:, 0], best_u)
        best_v = torch.where(got, torch.gather(v, 1, j)[:, 0], best_v)
    if any_hit:
        return occ
    return Hit(best_t, best_p, best_u, best_v)


def box_meets_plain(org, inv, tmin, lim, lo, hi):
    """The kernel's slab test (box_meets) in the same fp32 operations:
    does the ray meet the box [lo, hi] within [tmin, lim]? org and inv
    are xyz sequences; every argument broadcasts."""
    t0 = [(lo[a] - org[a]) * inv[a] for a in range(3)]
    t1 = [(hi[a] - org[a]) * inv[a] for a in range(3)]
    mn = [torch.fmin(p, q) for p, q in zip(t0, t1)]
    mx = [torch.fmax(p, q) for p, q in zip(t0, t1)]
    near = torch.fmax(torch.fmax(mn[0], mn[1]), torch.fmax(mn[2], tmin))
    far = torch.fmin(torch.fmin(mx[0], mx[1]), torch.fmin(mx[2], lim))
    return near <= far + far.abs() * SLAB_SLACK


@torch.no_grad()
def intersect_packed_plain(rays: Rays, pack: SoupPack, shadow_visible=None,
                           any_hit: bool = False):
    """The kernel's walk over `pack` in plain torch, for checking the cull:
    warps of 32 consecutive rays, chunks of CHUNK_TILES tiles, closest hit
    visiting a chunk's tiles by the distance of their box centres from the
    warp's first origin, and a lane testing a tile's triangles only if its
    slab test meets the tile's box (or the tile holds at most DIRECT).
    Returns (the Hit or occlusion, missed): `missed` counts the (lane,
    tile) culls that dropped a triangle Moeller-Trumbore accepts within the
    lane's interval, which would change the result; 0 when the cull is
    exact."""
    n = rays.tmin.shape[0]
    w = -(-n // 32)
    device = rays.tmin.device

    def lanes(a, fill):
        out = torch.full((w * 32,), fill, dtype=torch.float32, device=device)
        out[:n] = a
        return out.view(w, 32)
    o = [lanes(a, 0.0) for a in rays.org]
    d = [lanes(a, 0.0) for a in rays.dir]
    tmin, tmax = lanes(rays.tmin, 0.0), lanes(rays.tmax, -1.0)
    inv = [1.0 / a for a in d]
    active = tmax >= tmin
    searching = active.clone()
    best_t = torch.full((w, 32), FLT_MAX, dtype=torch.float32, device=device)
    best_p = torch.full((w, 32), -1, dtype=torch.int32, device=device)
    best_u = torch.zeros_like(best_t)
    best_v = torch.zeros_like(best_t)
    rows, tiles = pack.rows, pack.tiles
    n_rows, n_tiles = rows.shape[0], tiles.shape[0]
    prim_of_row = _bits(rows[:, 3])
    start, count = _bits(tiles[:, 3]).long(), _bits(tiles[:, 7]).long()
    org3 = Vec3(*[a[..., None] for a in o])
    dir3 = Vec3(*[a[..., None] for a in d])
    slot = torch.arange(TILE, device=device)
    missed = 0
    for c0 in range(0, n_tiles, CHUNK_TILES):
        nt = min(CHUNK_TILES, n_tiles - c0)
        ks = torch.arange(c0, c0 + nt, device=device)
        if any_hit:
            order = ks.expand(w, nt)
        else:
            c = (tiles[ks, :3] + tiles[ks, 4:7]) * 0.5
            dc = [c[None, :, a] - o[a][:, :1] for a in range(3)]
            d2 = dc[0] * dc[0] + dc[1] * dc[1] + dc[2] * dc[2]
            key = (d2.view(torch.int32) & ~31) | (ks - c0).to(torch.int32)
            order = c0 + (torch.sort(key, 1).values & 31).long()
        for s in range(nt):
            k = order[:, s]
            blo, bhi = tiles[k, :3], tiles[k, 4:7]
            lim = tmax if any_hit else torch.fmin(tmax, best_t)
            meets = box_meets_plain(o, inv, tmin, lim,
                                    [blo[:, a, None] for a in range(3)],
                                    [bhi[:, a, None] for a in range(3)])
            meets = meets | (count[k] <= DIRECT)[:, None]
            live = searching & meets
            r = torch.clamp(start[k][:, None] + slot, max=n_rows - 1)
            valid = (slot < count[k][:, None])[:, None, :]
            tri = [Vec3(*[rows[r, f + a][:, None, :] for a in range(3)])
                   for f in (0, 4, 8)]
            t, u, v, ok = moeller_trumbore(org3, dir3, *tri)
            ok = (ok & valid & (t > tmin[..., None]) & (t < tmax[..., None]))
            p = prim_of_row[r][:, None, :].expand_as(t)
            if any_hit:
                if shadow_visible is not None:
                    ok = ok & shadow_visible[p.long()]
                found = ok.any(2) & searching
                missed += int((found & ~meets).sum())
                searching = searching & ~(found & live)
                continue
            within = (ok & (t <= lim[..., None])).any(2)
            missed += int((within & active & ~meets).sum())
            cand = ok & live[..., None]
            t_c = torch.where(cand, t, float("inf")).amin(2)
            at = cand & (t == t_c[..., None])
            p_c = torch.where(at, p, torch.iinfo(torch.int32).max).amin(2)
            j = (at & (p == p_c[..., None])).to(torch.int8).argmax(2,
                                                                 keepdim=True)
            better = cand.any(2) & ((t_c < best_t)
                                    | ((t_c == best_t) & (p_c < best_p)))
            best_t = torch.where(better, t_c, best_t)
            best_p = torch.where(better, p_c, best_p)
            best_u = torch.where(better, torch.gather(u, 2, j)[..., 0], best_u)
            best_v = torch.where(better, torch.gather(v, 2, j)[..., 0], best_v)
    if any_hit:
        return (active & ~searching).reshape(-1)[:n], missed
    return Hit(*[a.reshape(-1)[:n] for a in (best_t, best_p, best_u,
                                             best_v)]), missed
