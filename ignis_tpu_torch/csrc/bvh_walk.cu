// K1: BVH8 closest-hit / any-hit traversal for Hopper (sm_90a).
//
// Replaces the TPU kernel ignis_tpu/ops/pallas_bvh.py::_bvh_kernel
// (launched by _traverse_impl). It serves scenes at or above the BVH
// threshold (scene/build.py BVH_THRESHOLD = 512 triangles).
//
// What bounds it on the card: memory latency and divergence, not bytes or
// arithmetic. A ray visits a few nodes and tests a few triangles (means of
// 2-6 visits on S1 and S3, p99 of 18-30 in slot order), and each visit is a
// dependent round trip to L2 at an address that diverges between
// neighbouring rays; a warp runs as long as its longest ray. The soup and
// nodes of a 400k-triangle scene fit the 50 MB L2.
//
// What the design does about it:
// - packed node records (ops/bvh_cuda.pack_nodes): a node keeps only its
//   occupied children, one 32-byte record each (box min xyz, max x | max yz,
//   reference, 0), read with 16-byte __ldg's, four records' loads issued
//   together before any of them is tested, and no empty slot read. An inner
//   reference is (first record << 3) | (children - 1); a leaf reference
//   keeps the BVHArrays code -((start << 4 | count) + 1) with count <= 4;
// - packed triangles (ops/bvh_cuda.pack_tris): v0, e1, e2 as three float4,
//   so a leaf's up to 4 triangles are 12 vector loads issued together;
// - nearest first: a fixed 19-comparator network sorts a node's children
//   by entry distance in registers; leaf children are intersected in near
//   order, hit inner children are pushed far to near with their entry
//   distance, the nearest is visited next without a trip through the
//   stack, and closest hit skips a popped entry whose distance lies beyond
//   the best hit before loading its records. Any hit takes the same order
//   (on the card it found the occluders of shadow rays sooner than slot
//   order did) and ends at the first shadow-visible hit;
// - persistent lanes: the grid fills the card once, and a lane whose ray
//   has ended takes the next unclaimed one (one atomicAdd per warp), so a
//   warp does not idle behind its longest ray while rays are left;
// - the stack lives in shared memory, entry-major ([slot][thread]), so
//   threads at different depths never share a bank. The deepest stack
//   counted on the card (counters[1], chip_smoke.py phase 4) was 16 on
//   S1's and S3's rays, and STACK_SIZE leaves twice that; a push beyond it
//   is dropped and counted in counters[0], which callers require to stay 0
//   (the JAX walk overwrote its top slot silently, ops/bvh.py:113-115).
//
// Results do not depend on the visit order: closest hit takes the exact
// fp32 t with the lowest prim id on equal t, and any hit reports whether
// some shadow-visible triangle lies in (tmin, tmax). Moeller-Trumbore keeps
// the plain version's operation order; the determinant test is
// |det| > 1e-16 (ignis_tpu/ops/intersect.py:59), and with -fmad=false
// (ops/cuda_build.py) each triangle test rounds as the plain version's
// does. Lanes with tmax < tmin miss at once.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 128;
constexpr int STACK_SIZE = 32;
constexpr float IG_FLT_MAX = 3.0e38f;
constexpr float DET_EPS = 1e-16f;
constexpr int MISS_KEY = 0x7fffffff;   // above the key of every float

struct Ray {
    float px, py, pz, dx, dy, dz, idx, idy, idz, tmin;
};

__device__ __forceinline__ float inv_dir(float d)
{
    // ignis_tpu/ops/bvh.py:53-55
    return fabsf(d) > 1e-12f ? 1.0f / d : 1e12f;
}

// An int with the order of the float x, and back.
__device__ __forceinline__ int order_key(float x)
{
    const int b = __float_as_int(x);
    return b >= 0 ? b : b ^ 0x7fffffff;
}

__device__ __forceinline__ float key_float(int k)
{
    return __int_as_float(k >= 0 ? k : k ^ 0x7fffffff);
}

__device__ __forceinline__ void cswap(int& ka, int& ra, int& kb, int& rb)
{
    const bool swap = kb < ka;
    const int k = swap ? kb : ka, r = swap ? rb : ra;
    kb = swap ? ka : kb;
    rb = swap ? ra : rb;
    ka = k;
    ra = r;
}

// Ascending sort of 8 (key, ref) pairs by a 19-comparator network; every
// index is a constant, so nothing leaves registers.
__device__ __forceinline__ void sort8(int* k, int* r)
{
    cswap(k[0], r[0], k[2], r[2]); cswap(k[1], r[1], k[3], r[3]);
    cswap(k[4], r[4], k[6], r[6]); cswap(k[5], r[5], k[7], r[7]);
    cswap(k[0], r[0], k[1], r[1]); cswap(k[2], r[2], k[3], r[3]);
    cswap(k[4], r[4], k[5], r[5]); cswap(k[6], r[6], k[7], r[7]);
    cswap(k[0], r[0], k[4], r[4]); cswap(k[1], r[1], k[5], r[5]);
    cswap(k[2], r[2], k[6], r[6]); cswap(k[3], r[3], k[7], r[7]);
    cswap(k[2], r[2], k[4], r[4]); cswap(k[3], r[3], k[5], r[5]);
    cswap(k[1], r[1], k[4], r[4]); cswap(k[3], r[3], k[6], r[6]);
    cswap(k[1], r[1], k[2], r[2]); cswap(k[3], r[3], k[4], r[4]);
    cswap(k[5], r[5], k[6], r[6]);
}

// Moeller-Trumbore in the plain version's operation order.
__device__ __forceinline__ bool mt(const Ray& ray, float4 v0, float4 e1,
                                   float4 e2, float& t, float& u, float& v)
{
    const float ax = e1.x, ay = e1.y, az = e1.z;
    const float bx = e2.x, by = e2.y, bz = e2.z;
    const float dx = ray.dx, dy = ray.dy, dz = ray.dz;
    const float pvx = dy * bz - dz * by;
    const float pvy = dz * bx - dx * bz;
    const float pvz = dx * by - dy * bx;
    const float det = ax * pvx + ay * pvy + az * pvz;
    if (!(fabsf(det) > DET_EPS))
        return false;
    const float inv_det = 1.0f / det;
    const float tvx = ray.px - v0.x;
    const float tvy = ray.py - v0.y;
    const float tvz = ray.pz - v0.z;
    u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det;
    const float qvx = tvy * az - tvz * ay;
    const float qvy = tvz * ax - tvx * az;
    const float qvz = tvx * ay - tvy * ax;
    v = (dx * qvx + dy * qvy + dz * qvz) * inv_det;
    t = (bx * qvx + by * qvy + bz * qvz) * inv_det;
    return u >= 0.f && v >= 0.f && u + v <= 1.f;
}

// Test the triangles of leaf `code`; closest hit shrinks best_t, any hit
// returns true at the first shadow-visible hit.
template <bool ANY_HIT>
__device__ __forceinline__ bool leaf(const Ray& ray, int code,
                                     const float4* __restrict__ tris,
                                     const uint8_t* __restrict__ vis,
                                     float& best_t, float& best_u,
                                     float& best_v, int& best_p)
{
    const int lv = -code - 1;
    const int start = lv >> 4;
    const int count = lv & 15;
    float4 a[4], b[4], c[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        if (k < count) {
            const float4* row = tris + 3 * (start + k);
            a[k] = __ldg(row);
            b[k] = __ldg(row + 1);
            c[k] = __ldg(row + 2);
        }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        if (k >= count)
            break;
        float t, u, v;
        if (!mt(ray, a[k], b[k], c[k], t, u, v) || !(t > ray.tmin))
            continue;
        const int p = start + k;
        if (ANY_HIT) {
            if (t < best_t && (vis == nullptr || __ldg(vis + p)))
                return true;
        } else if (t < best_t || (t == best_t && p < best_p)) {
            best_t = t; best_u = u; best_v = v; best_p = p;
        }
    }
    return false;
}

// One visit of `node`: slab-test its children, intersect the leaves that
// the ray reaches nearest first, push the inner children to visit later.
// Returns the next node to visit, or -1 once the ray's walk has ended.
template <bool ANY_HIT>
__device__ __forceinline__ int visit(const Ray& ray, int node,
                                     const int4* __restrict__ nodes,
                                     const float4* __restrict__ tris,
                                     const uint8_t* __restrict__ vis,
                                     int2* stk, int& sp, float& best_t,
                                     float& best_u, float& best_v,
                                     int& best_p, bool& occ, int& deepest,
                                     int* counters)
{
    // four records' loads at a time, then their slab tests
    const int first = node >> 3;
    const int kids = (node & 7) + 1;
    int key[8], ref[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        key[j] = MISS_KEY;
        ref[j] = 0;
    }
#pragma unroll
    for (int h = 0; h < 8; h += 4) {
        if (h >= kids)
            break;
        int4 lo[4], hi[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            if (h + j < kids) {
                lo[j] = __ldg(nodes + 2 * (first + h + j));
                hi[j] = __ldg(nodes + 2 * (first + h + j) + 1);
            }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            if (h + j < kids) {
                const float t0x = (__int_as_float(lo[j].x) - ray.px) * ray.idx;
                const float t1x = (__int_as_float(lo[j].w) - ray.px) * ray.idx;
                const float t0y = (__int_as_float(lo[j].y) - ray.py) * ray.idy;
                const float t1y = (__int_as_float(hi[j].x) - ray.py) * ray.idy;
                const float t0z = (__int_as_float(lo[j].z) - ray.pz) * ray.idz;
                const float t1z = (__int_as_float(hi[j].y) - ray.pz) * ray.idz;
                const float tnear = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                                          fmaxf(fminf(t0z, t1z), ray.tmin));
                const float tfar = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                                         fminf(fmaxf(t0z, t1z), best_t));
                if (tnear <= tfar) {
                    key[h + j] = order_key(tnear);
                    ref[h + j] = hi[j].z;
                }
            }
        }
    }

    sort8(key, ref);
    int hits = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j)
        hits += key[j] != MISS_KEY;
    // leaves, nearest first: rotate the `hits` sorted entries through
    // index 0; the hits end at 8 - hits .. 7, near to far
#pragma unroll 1
    for (int it = 0; it < hits; ++it) {
        const int k0 = key[0], r0 = ref[0];
#pragma unroll
        for (int j = 0; j < 7; ++j) {
            key[j] = key[j + 1];
            ref[j] = ref[j + 1];
        }
        key[7] = k0;
        ref[7] = r0;
        if (r0 < 0 && key_float(k0) <= best_t
            && leaf<ANY_HIT>(ray, r0, tris, vis, best_t, best_u, best_v,
                             best_p)) {
            occ = true;
            return -1;
        }
    }
    // inner children in front of the best hit: push far to near, keep
    // the nearest to visit next
    int next = -1, next_key = 0;
#pragma unroll
    for (int j = 7; j >= 0; --j) {
        if (key[j] == MISS_KEY || ref[j] < 0 || key_float(key[j]) > best_t)
            continue;
        if (next >= 0) {
            if (sp < STACK_SIZE) {
                stk[sp * BLOCK] = make_int2(next, next_key);
                ++sp;
            } else {
                atomicAdd(counters, 1);
            }
        }
        next = ref[j];
        next_key = key[j];
    }
    deepest = max(deepest, sp);
    if (next >= 0)
        return next;

    // pop, skipping entries beyond the best hit (any hit never shrinks
    // best_t, so it skips nothing)
    while (sp > 0) {
        --sp;
        const int2 e = stk[sp * BLOCK];
        if (ANY_HIT || key_float(e.y) <= best_t)
            return e.x;
    }
    return -1;
}

// Persistent lanes: a grid that fills the card once; each lane walks one
// ray at a time, one visit per trip round the loop, and a lane whose ray
// has ended writes it out and takes the next unclaimed ray (one atomicAdd
// per warp on counters[2]), so a warp stays full until the rays run out.
template <bool ANY_HIT>
__global__ void __launch_bounds__(BLOCK)
bvh_walk_kernel(const float* __restrict__ ox, const float* __restrict__ oy,
                const float* __restrict__ oz, const float* __restrict__ dxp,
                const float* __restrict__ dyp, const float* __restrict__ dzp,
                const float* __restrict__ tminp, const float* __restrict__ tmaxp,
                int n, const float4* __restrict__ tris,
                const uint8_t* __restrict__ vis, const int4* __restrict__ nodes,
                int root, float* __restrict__ t_out, int* __restrict__ prim_out,
                float* __restrict__ u_out, float* __restrict__ v_out,
                uint8_t* __restrict__ occ_out, int* __restrict__ counters)
{
    __shared__ int2 stack[STACK_SIZE * BLOCK];
    int2* const stk = stack + threadIdx.x;   // slot s at stk[s * BLOCK]
    const unsigned FULL = 0xffffffffu;
    const int lane = threadIdx.x & 31;

    int i = -1;   // this lane's ray: -1 wants one, >= n none is left
    Ray ray;
    float best_t = 0.f, best_u = 0.f, best_v = 0.f;
    int best_p = -1, sp = 0, node = -1, deepest = 0;
    bool occ = false;
    while (true) {
        const unsigned need = __ballot_sync(FULL, i < 0);
        if (need) {
            const int leader = __ffs(need) - 1;
            int base = 0;
            if (lane == leader)
                base = atomicAdd(counters + 2, __popc(need));
            base = __shfl_sync(FULL, base, leader);
            if (i < 0) {
                i = base + __popc(need & ((1u << lane) - 1u));
                if (i < n) {
                    ray.px = ox[i]; ray.py = oy[i]; ray.pz = oz[i];
                    ray.dx = dxp[i]; ray.dy = dyp[i]; ray.dz = dzp[i];
                    ray.tmin = tminp[i];
                    const float tmx = tmaxp[i];
                    ray.idx = inv_dir(ray.dx);
                    ray.idy = inv_dir(ray.dy);
                    ray.idz = inv_dir(ray.dz);
                    best_t = fminf(tmx, IG_FLT_MAX);
                    best_u = best_v = 0.f;
                    best_p = -1;
                    occ = false;
                    sp = 0;
                    node = tmx >= ray.tmin ? root : -1;
                }
            }
        }
        if (__all_sync(FULL, i >= n))
            break;
        if (i < n && node >= 0) {
            node = visit<ANY_HIT>(ray, node, nodes, tris, vis, stk, sp, best_t,
                                  best_u, best_v, best_p, occ, deepest,
                                  counters);
        }
        if (i < n && node < 0) {
            if (ANY_HIT) {
                occ_out[i] = occ ? 1 : 0;
            } else {
                t_out[i] = best_p >= 0 ? best_t : IG_FLT_MAX;
                prim_out[i] = best_p;
                u_out[i] = best_u;
                v_out[i] = best_v;
            }
            i = -1;
        }
    }
    const int warp_deepest = __reduce_max_sync(FULL, deepest);
    if (lane == 0 && warp_deepest > 0)
        atomicMax(counters + 1, warp_deepest);
}

template <bool ANY_HIT>
int launch(const float* ox, const float* oy, const float* oz, const float* dx,
           const float* dy, const float* dz, const float* tmin,
           const float* tmax, int n, const float4* tris, const uint8_t* vis,
           const int4* nodes, int root, float* t_out, int* prim_out,
           float* u_out, float* v_out, uint8_t* occ_out, int* counters,
           cudaStream_t s)
{
    static int resident = 0;   // blocks that fit the card at once
    if (resident == 0) {
        int dev = 0, sms = 0, per_sm = 0;
        cudaGetDevice(&dev);
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, bvh_walk_kernel<ANY_HIT>, BLOCK, 0);
        resident = sms * per_sm;
        if (resident <= 0)
            return static_cast<int>(cudaErrorInvalidConfiguration);
    }
    const int blocks = min(resident, (n + BLOCK - 1) / BLOCK);
    cudaMemsetAsync(counters + 2, 0, sizeof(int), s);
    bvh_walk_kernel<ANY_HIT><<<blocks, BLOCK, 0, s>>>(
        ox, oy, oz, dx, dy, dz, tmin, tmax, n, tris, vis, nodes, root, t_out,
        prim_out, u_out, v_out, occ_out, counters);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// nodes: [records, 8] int32 (pack_nodes); tris: [T, 12] f32 (pack_tris);
// counters: int32[3], dropped pushes, the deepest stack and the next ray
// (zeroed here before each launch).
extern "C" int ig_bvh_walk(const float* ox, const float* oy, const float* oz,
                           const float* dx, const float* dy, const float* dz,
                           const float* tmin, const float* tmax, int n,
                           const float* tris, const uint8_t* vis,
                           const int* nodes, int root, int any_hit,
                           float* t_out, int* prim_out, float* u_out,
                           float* v_out, uint8_t* occ_out, int* counters,
                           void* stream)
{
    if (n <= 0)
        return 0;
    const float4* tris4 = reinterpret_cast<const float4*>(tris);
    const int4* nodes4 = reinterpret_cast<const int4*>(nodes);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (any_hit)
        return launch<true>(ox, oy, oz, dx, dy, dz, tmin, tmax, n, tris4, vis,
                            nodes4, root, t_out, prim_out, u_out, v_out,
                            occ_out, counters, s);
    return launch<false>(ox, oy, oz, dx, dy, dz, tmin, tmax, n, tris4, vis,
                         nodes4, root, t_out, prim_out, u_out, v_out, occ_out,
                         counters, s);
}
