// K2: dense ray-triangle closest-hit / any-hit for Hopper (sm_90a).
//
// Replaces the TPU kernel ignis_tpu/ops/pallas_isect.py::_isect_kernel
// (launched by _intersect_impl; default `vpu` branch, exact fp32
// Moeller-Trumbore, with per-block culling of 128-triangle chunk boxes).
// It serves scenes below the BVH threshold (scene/build.py
// BVH_THRESHOLD = 512 triangles), where a BVH does not pay: every ray may
// test every triangle.
//
// What bounds it on the card: fp32 issue. A ray/triangle test is ~50
// unfused operations and an IEEE reciprocal against 48 bytes of triangle
// that every ray of the card reads, so the soup belongs in shared memory
// and the cost is the number of tests a warp has to issue.
//
// What the design does about it:
// - the soup is read as packed rows (ops/isect_cuda.pack_soup): v0, e1, e2
//   as three float4 a triangle, the original prim id in v0's fourth word,
//   in tiles of at most TILE = 16 triangles, each with a box padded by a
//   rounding margin. A block loads the whole soup into dynamic shared
//   memory once (up to CHUNK_TILES tiles, 512 triangles, 25 KB), while its
//   first rays' loads are in flight, and then loops over warps of 32
//   consecutive rays (persistent blocks); a larger soup is streamed
//   through in chunks of CHUNK_TILES tiles by the same loop, the block's
//   warps in step. Every read of a triangle is a float4 broadcast. A soup
//   of one tile of at most DIRECT triangles (S2's floor) takes a TINY
//   instance: no shared memory, no persistence, no cull, so that its
//   launch costs what one wave of ray loads and stores costs;
// - per-warp tile culling, the TPU kernel's chunk culling in a warp's form:
//   each lane slab-tests its ray against a tile's box over
//   [tmin, min(tmax, best t)] and the warp skips the tile when no lane
//   meets it (__any_sync). Closest hit visits a chunk's tiles in the order
//   of their box centres' distance from lane 0's origin (a warp bitonic
//   sort of up to 32 keys), so near tiles shrink best t before far ones are
//   tested. The order and the skip are warp-uniform, so the shared-memory
//   reads stay broadcasts;
// - a warp-uniform early-out inside Moeller-Trumbore: after the u test a
//   warp whose lanes have all failed goes on to the next triangle. It
//   skips only work whose result is discarded;
// - one ray per lane, loaded and stored in coalesced 32-ray runs.
//
// Results are those of the plain version (ops/isect_cuda.
// intersect_tris_plain) bit for bit: Moeller-Trumbore in its operation
// order, built with -fmad=false (ops/cuda_build.py); |det| > 1e-16, the
// JAX CPU path's epsilon (ignis_tpu/ops/intersect.py:59); a hit needs
// tmin < t < tmax; closest hit keeps the least (t, original prim id), so
// equal t keeps the lowest prim whatever the visit order; any hit ends a
// lane at its first shadow-visible hit; lanes with tmax < tmin miss; a
// miss writes t = 3e38 and prim = -1. The cull is exact as long as no
// triangle that Moeller-Trumbore accepts lies outside its tile's padded
// box (the margin: pack_soup), which the plain replay of the cull
// (intersect_packed_plain) checks on the CPU.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 256;
constexpr int WARPS = BLOCK / 32;
constexpr int TILE = 16;           // triangles a tile at most
constexpr int CHUNK_TILES = 32;    // tiles in shared memory at once
constexpr int CHUNK_ROWS = TILE * CHUNK_TILES;
constexpr float IG_FLT_MAX = 3.0e38f;
constexpr float DET_EPS = 1e-16f;
// the slab test's own rounding: tfar is widened by this share of itself
constexpr float SLAB_SLACK = 2e-6f;
// a tile of at most this many triangles is tested without its box: the
// triangles cost less than the slab test and the three reciprocals
constexpr int DIRECT = 4;
constexpr unsigned FULL = 0xffffffffu;

struct Ray {
    float px, py, pz, dx, dy, dz, tmin, tmax;
};

__device__ __forceinline__ bool box_meets(const Ray& r, float ix, float iy,
                                          float iz, float4 lo, float4 hi,
                                          float lim)
{
    const float t0x = (lo.x - r.px) * ix;
    const float t1x = (hi.x - r.px) * ix;
    const float t0y = (lo.y - r.py) * iy;
    const float t1y = (hi.y - r.py) * iy;
    const float t0z = (lo.z - r.pz) * iz;
    const float t1z = (hi.z - r.pz) * iz;
    const float tnear = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                              fmaxf(fminf(t0z, t1z), r.tmin));
    const float tfar = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                             fminf(fmaxf(t0z, t1z), lim));
    return tnear <= tfar + fabsf(tfar) * SLAB_SLACK;
}

// Ascending bitonic sort of one int a lane over the first `width` lanes
// of the warp (a warp-uniform power of two up to 32).
__device__ __forceinline__ int warp_sort(int v, int lane, int width)
{
    for (int k = 2; k <= width; k <<= 1) {
#pragma unroll
        for (int j = k >> 1; j > 0; j >>= 1) {
            const int o = __shfl_xor_sync(FULL, v, j);
            const bool up = (lane & k) == 0;
            const bool low = (lane & j) == 0;
            v = (low == up) ? min(v, o) : max(v, o);
        }
    }
    return v;
}

// Chunk `c0` (tiles c0 .. c0 + nt - 1, rows of those tiles) into shared
// memory by the whole block; returns the chunk's first row.
__device__ __forceinline__ int load_chunk(const float4* __restrict__ rows,
                                          const float4* __restrict__ tiles,
                                          int n_rows, int c0, int nt,
                                          float4* s_tiles, float4* s_rows)
{
    for (int k = threadIdx.x; k < 2 * nt; k += BLOCK)
        s_tiles[k] = __ldg(tiles + 2 * c0 + k);
    const int row0 = __float_as_int(__ldg(tiles + 2 * c0).w);
    const float4 last_lo = __ldg(tiles + 2 * (c0 + nt - 1));
    const float4 last_hi = __ldg(tiles + 2 * (c0 + nt - 1) + 1);
    const int row_end = __float_as_int(last_lo.w) + __float_as_int(last_hi.w);
    const int count = min(min(row_end, n_rows) - row0, CHUNK_ROWS);
    for (int k = threadIdx.x; k < 3 * count; k += BLOCK)
        s_rows[k] = __ldg(rows + 3 * row0 + k);
    return row0;
}

// One warp's rays against `count` triangles from `row` on: lanes that
// are not `live` take no hit. Returns false once an any-hit warp has no
// lane left searching.
template <bool ANY_HIT>
__device__ __forceinline__ bool tile_walk(const Ray& ray, const float4* row,
                                          int count, bool live,
                                          const uint8_t* __restrict__ vis,
                                          bool& active, float& best_t,
                                          float& best_u, float& best_v,
                                          int& best_p)
{
    for (int j = 0; j < count; ++j, row += 3) {
        const float4 a = row[0], e1 = row[1], e2 = row[2];
        // pvec = d x e2, det = e1 . pvec
        const float pvx = ray.dy * e2.z - ray.dz * e2.y;
        const float pvy = ray.dz * e2.x - ray.dx * e2.z;
        const float pvz = ray.dx * e2.y - ray.dy * e2.x;
        const float det = e1.x * pvx + e1.y * pvy + e1.z * pvz;
        bool ok = live && active && fabsf(det) > DET_EPS;
        const float inv_det = 1.0f / det;
        const float tvx = ray.px - a.x;
        const float tvy = ray.py - a.y;
        const float tvz = ray.pz - a.z;
        const float u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det;
        // u > 1 with v >= 0 fails u + v <= 1, so this drops no hit
        ok = ok && u >= 0.f && u <= 1.f;
        if (!__any_sync(FULL, ok))
            continue;
        // qvec = tvec x e1
        const float qvx = tvy * e1.z - tvz * e1.y;
        const float qvy = tvz * e1.x - tvx * e1.z;
        const float qvz = tvx * e1.y - tvy * e1.x;
        const float v = (ray.dx * qvx + ray.dy * qvy + ray.dz * qvz) * inv_det;
        const float t = (e2.x * qvx + e2.y * qvy + e2.z * qvz) * inv_det;
        ok = ok && v >= 0.f && u + v <= 1.f && t > ray.tmin && t < ray.tmax;
        const int p = __float_as_int(a.w);
        if (ANY_HIT) {
            if (ok && (vis == nullptr || __ldg(vis + p)))
                active = false;
            if (!__any_sync(FULL, active))
                return false;
        } else if (ok && (t < best_t || (t == best_t && p < best_p))) {
            best_t = t; best_u = u; best_v = v; best_p = p;
        }
    }
    return true;
}

// One warp's rays against the chunk in shared memory.
template <bool ANY_HIT>
__device__ __forceinline__ void chunk_walk(const Ray& ray, int lane, int nt,
                                           int row0, const float4* s_tiles,
                                           const float4* s_rows,
                                           const uint8_t* __restrict__ vis,
                                           bool& active, float& best_t,
                                           float& best_u, float& best_v,
                                           int& best_p)
{
    int order = lane;
    if (!ANY_HIT && nt > 1) {
        // tiles nearest first: key = distance^2 of the box centre from
        // lane 0's origin, its low 5 bits replaced by the tile's slot
        const float ox = __shfl_sync(FULL, ray.px, 0);
        const float oy = __shfl_sync(FULL, ray.py, 0);
        const float oz = __shfl_sync(FULL, ray.pz, 0);
        int key = 0x7fffffe0 | lane;
        if (lane < nt) {
            const float4 lo = s_tiles[2 * lane], hi = s_tiles[2 * lane + 1];
            const float cx = (lo.x + hi.x) * 0.5f - ox;
            const float cy = (lo.y + hi.y) * 0.5f - oy;
            const float cz = (lo.z + hi.z) * 0.5f - oz;
            const float d2 = cx * cx + cy * cy + cz * cz;
            key = (__float_as_int(d2) & ~31) | lane;
        }
        order = warp_sort(key, lane, 1 << (32 - __clz(nt - 1))) & 31;
    }
    // the reciprocals of the direction, only where some tile is culled
    float ix = 0.f, iy = 0.f, iz = 0.f;
    if (__any_sync(FULL, lane < nt
                   && __float_as_int(s_tiles[2 * lane + 1].w) > DIRECT)) {
        ix = 1.0f / ray.dx;
        iy = 1.0f / ray.dy;
        iz = 1.0f / ray.dz;
    }
    for (int s = 0; s < nt; ++s) {
        const int k = ANY_HIT ? s : __shfl_sync(FULL, order, s);
        const float4 lo = s_tiles[2 * k], hi = s_tiles[2 * k + 1];
        const int count = __float_as_int(hi.w);
        const float lim = ANY_HIT ? ray.tmax : fminf(ray.tmax, best_t);
        const bool live = active
            && (count <= DIRECT || box_meets(ray, ix, iy, iz, lo, hi, lim));
        if (!__any_sync(FULL, live))
            continue;
        const float4* row = s_rows + 3 * (__float_as_int(lo.w) - row0);
        if (!tile_walk<ANY_HIT>(ray, row, count, live, vis, active, best_t,
                                best_u, best_v, best_p))
            return;
    }
}

// TINY: a soup of one tile of at most DIRECT triangles, read from device
// memory (every lane the same address), one warp of rays a warp, no
// shared memory; otherwise the soup is staged in shared memory (module
// note) and the blocks are persistent.
template <bool ANY_HIT, bool TINY>
__global__ void __launch_bounds__(BLOCK)
isect_dense_kernel(const float* __restrict__ ox, const float* __restrict__ oy,
                   const float* __restrict__ oz, const float* __restrict__ dxp,
                   const float* __restrict__ dyp, const float* __restrict__ dzp,
                   const float* __restrict__ tminp,
                   const float* __restrict__ tmaxp, int n,
                   const float4* __restrict__ rows, int n_rows,
                   const float4* __restrict__ tiles, int n_tiles,
                   const uint8_t* __restrict__ vis, float* __restrict__ t_out,
                   int* __restrict__ prim_out, float* __restrict__ u_out,
                   float* __restrict__ v_out, uint8_t* __restrict__ occ_out)
{
    extern __shared__ float4 smem[];
    float4* const s_tiles = smem;                     // [2 * CHUNK_TILES]
    float4* const s_rows = smem + 2 * CHUNK_TILES;    // [3 * CHUNK_ROWS]
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const bool resident = n_tiles <= CHUNK_TILES;
    bool staged = TINY || !resident;
    int row0 = 0;
    const int n_items = (n + 31) / 32;
    // the bound is block-uniform, so every warp of the block takes each
    // trip and the barriers below are reached by all
    for (int base = blockIdx.x * WARPS; base < n_items;
         base += gridDim.x * WARPS) {
        const int i = (base + warp) * 32 + lane;
        Ray ray;
        bool active = false;
        if (i < n) {
            ray.px = ox[i]; ray.py = oy[i]; ray.pz = oz[i];
            ray.dx = dxp[i]; ray.dy = dyp[i]; ray.dz = dzp[i];
            ray.tmin = tminp[i]; ray.tmax = tmaxp[i];
            active = ray.tmax >= ray.tmin;
        } else {
            ray.px = ray.py = ray.pz = 0.f;
            ray.dx = ray.dy = ray.dz = 0.f;
            ray.tmin = 0.f; ray.tmax = -1.f;
        }
        if (!staged) {
            // a resident soup, loaded once while the first rays' loads are
            // in flight; its first tile starts at row 0
            for (int k = threadIdx.x; k < 2 * n_tiles; k += BLOCK)
                s_tiles[k] = __ldg(tiles + k);
            for (int k = threadIdx.x; k < 3 * min(n_rows, CHUNK_ROWS);
                 k += BLOCK)
                s_rows[k] = __ldg(rows + k);
            __syncthreads();
            staged = true;
        }
        float best_t = IG_FLT_MAX, best_u = 0.f, best_v = 0.f;
        int best_p = -1;
        if (TINY) {
            if (__any_sync(FULL, active))
                tile_walk<ANY_HIT>(ray, rows, n_rows, true, vis, active,
                                   best_t, best_u, best_v, best_p);
        } else {
            for (int c0 = 0; c0 < n_tiles; c0 += CHUNK_TILES) {
                const int nt = min(CHUNK_TILES, n_tiles - c0);
                if (!resident) {
                    // also keeps the previous chunk until every warp is done
                    if (!__syncthreads_or(active))
                        break;
                    row0 = load_chunk(rows, tiles, n_rows, c0, nt, s_tiles,
                                      s_rows);
                    __syncthreads();
                }
                if (__any_sync(FULL, active))
                    chunk_walk<ANY_HIT>(ray, lane, nt, row0, s_tiles, s_rows,
                                        vis, active, best_t, best_u, best_v,
                                        best_p);
            }
        }
        if (i < n) {
            if (ANY_HIT) {
                // a live lane that is no longer active found its occluder
                occ_out[i] = (ray.tmax >= ray.tmin && !active) ? 1 : 0;
            } else {
                t_out[i] = best_p >= 0 ? best_t : IG_FLT_MAX;
                prim_out[i] = best_p;
                u_out[i] = best_u;
                v_out[i] = best_v;
            }
        }
    }
}

template <bool ANY_HIT, bool TINY>
int launch(const float* ox, const float* oy, const float* oz, const float* dx,
           const float* dy, const float* dz, const float* tmin,
           const float* tmax, int n, const float4* rows, int n_rows,
           const float4* tiles, int n_tiles, const uint8_t* vis,
           float* t_out, int* prim_out, float* u_out, float* v_out,
           uint8_t* occ_out, cudaStream_t s)
{
    static int sms = 0, last_smem = -1, last_per_sm = 0;
    const int smem = TINY ? 0 : static_cast<int>(sizeof(float4))
        * (2 * CHUNK_TILES + 3 * min(n_rows, CHUNK_ROWS));
    if (sms == 0) {
        int dev = 0;
        cudaGetDevice(&dev);
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    if (smem != last_smem) {
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &last_per_sm, isect_dense_kernel<ANY_HIT, TINY>, BLOCK, smem);
        last_smem = smem;
    }
    if (sms <= 0 || last_per_sm <= 0)
        return static_cast<int>(cudaErrorInvalidConfiguration);
    const int blocks = ((n + 31) / 32 + WARPS - 1) / WARPS;
    isect_dense_kernel<ANY_HIT, TINY><<<
        TINY ? blocks : min(sms * last_per_sm, blocks), BLOCK, smem, s>>>(
        ox, oy, oz, dx, dy, dz, tmin, tmax, n, rows, n_rows, tiles, n_tiles,
        vis, t_out, prim_out, u_out, v_out, occ_out);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// rows: [n_rows, 12] f32 and tiles: [n_tiles, 8] f32 (pack_soup); vis:
// [n_rows] bool by original prim id, or null.
extern "C" int ig_isect_dense(const float* ox, const float* oy, const float* oz,
                              const float* dx, const float* dy, const float* dz,
                              const float* tmin, const float* tmax, int n,
                              const float* rows, int n_rows,
                              const float* tiles, int n_tiles,
                              const uint8_t* vis, int any_hit, float* t_out,
                              int* prim_out, float* u_out, float* v_out,
                              uint8_t* occ_out, void* stream)
{
    if (n <= 0)
        return 0;
    const float4* rows4 = reinterpret_cast<const float4*>(rows);
    const float4* tiles4 = reinterpret_cast<const float4*>(tiles);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const bool tiny = n_tiles == 1 && n_rows <= DIRECT;
    if (any_hit)
        return (tiny ? launch<true, true> : launch<true, false>)(
            ox, oy, oz, dx, dy, dz, tmin, tmax, n, rows4, n_rows, tiles4,
            n_tiles, vis, t_out, prim_out, u_out, v_out, occ_out, s);
    return (tiny ? launch<false, true> : launch<false, false>)(
        ox, oy, oz, dx, dy, dz, tmin, tmax, n, rows4, n_rows, tiles4, n_tiles,
        vis, t_out, prim_out, u_out, v_out, occ_out, s);
}
