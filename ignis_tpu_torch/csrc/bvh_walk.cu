// K1: BVH8 closest-hit / any-hit traversal for Hopper (sm_90a).
//
// Replaces the TPU kernel ignis_tpu/ops/pallas_bvh.py::_bvh_kernel
// (launched by _traverse_impl). It serves scenes at or above the BVH
// threshold (scene/build.py BVH_THRESHOLD = 512 triangles).
//
// What bounds it on the card: memory latency. Each visited node reads
// 8 x 7 words of child boxes and references, each leaf up to 4 x 36 bytes
// of triangles, at addresses that diverge between neighbouring rays, and
// the arithmetic per byte is small. The reads go through the read-only
// path (__ldg); the soup of a 400k-triangle scene (~16 MB) and its nodes fit
// the 50 MB L2, so after the first bounce they are mostly L2 hits.
// Occupancy (many rays in flight per SM) is what hides the latency, so the
// kernel keeps its state small: one ray per thread in registers and a
// 64-entry stack of inner-node ids in local memory.
//
// Design, written for the card rather than carried over from the TPU (no
// per-block walk, no chunk work list, no HBM streaming and no SMEM budget,
// so there is no triangle cap):
// - the root is node 0; child > 0 is an inner node, child < 0 a leaf with
//   start = (-c-1) >> 4 and count = (-c-1) & 15 (at most 4), child == 0 is
//   empty (bvh/builder.py layout);
// - each visit slab-tests all 8 children; leaf children are intersected at
//   once and inner children are pushed, so the stack holds inner nodes only;
// - closest hit shrinks tmax as it finds hits, and takes the exact fp32 t
//   with the lowest prim id on equal t, which makes the result independent
//   of the visit order (the plain lockstep walk breaks ties in walk order);
// - any hit returns at the first hit on a shadow-visible triangle;
// - lanes with tmax < tmin miss at once;
// - the determinant test is |det| > 1e-16 (ignis_tpu/ops/intersect.py:59),
//   and with -fmad=false (ops/cuda_build.py) each triangle test rounds as the
//   plain version's does;
// - a push beyond the 64-entry stack is dropped and counted in a device
//   counter, which callers read and require to stay 0 (the JAX walk
//   overwrote its top slot silently, ops/bvh.py:113-115).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 128;
constexpr int STACK_SIZE = 64;
constexpr float IG_FLT_MAX = 3.0e38f;
constexpr float DET_EPS = 1e-16f;

struct Soup {
    const float *v0x, *v0y, *v0z, *e1x, *e1y, *e1z, *e2x, *e2y, *e2z;
    const uint8_t* vis;
};

struct Nodes {
    const float *cmin_x, *cmin_y, *cmin_z, *cmax_x, *cmax_y, *cmax_z;
    const int* child;
};

__device__ __forceinline__ bool mt(const Soup& s, int k, float px, float py,
                                   float pz, float dx, float dy, float dz,
                                   float& t, float& u, float& v)
{
    const float ax = __ldg(s.e1x + k), ay = __ldg(s.e1y + k), az = __ldg(s.e1z + k);
    const float bx = __ldg(s.e2x + k), by = __ldg(s.e2y + k), bz = __ldg(s.e2z + k);
    const float pvx = dy * bz - dz * by;
    const float pvy = dz * bx - dx * bz;
    const float pvz = dx * by - dy * bx;
    const float det = ax * pvx + ay * pvy + az * pvz;
    if (!(fabsf(det) > DET_EPS))
        return false;
    const float inv_det = 1.0f / det;
    const float tvx = px - __ldg(s.v0x + k);
    const float tvy = py - __ldg(s.v0y + k);
    const float tvz = pz - __ldg(s.v0z + k);
    u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det;
    const float qvx = tvy * az - tvz * ay;
    const float qvy = tvz * ax - tvx * az;
    const float qvz = tvx * ay - tvy * ax;
    v = (dx * qvx + dy * qvy + dz * qvz) * inv_det;
    t = (bx * qvx + by * qvy + bz * qvz) * inv_det;
    return u >= 0.f && v >= 0.f && u + v <= 1.f;
}

__device__ __forceinline__ float inv_dir(float d)
{
    // ignis_tpu/ops/bvh.py:53-55
    return fabsf(d) > 1e-12f ? 1.0f / d : 1e12f;
}

template <bool ANY_HIT>
__global__ void __launch_bounds__(BLOCK)
bvh_walk_kernel(const float* __restrict__ ox, const float* __restrict__ oy,
                const float* __restrict__ oz, const float* __restrict__ dxp,
                const float* __restrict__ dyp, const float* __restrict__ dzp,
                const float* __restrict__ tminp, const float* __restrict__ tmaxp,
                int n, Soup soup, Nodes nodes, float* __restrict__ t_out,
                int* __restrict__ prim_out, float* __restrict__ u_out,
                float* __restrict__ v_out, uint8_t* __restrict__ occ_out,
                int* __restrict__ overflow)
{
    const int i = blockIdx.x * BLOCK + threadIdx.x;
    if (i >= n)
        return;
    const float px = ox[i], py = oy[i], pz = oz[i];
    const float dx = dxp[i], dy = dyp[i], dz = dzp[i];
    const float tmn = tminp[i], tmx = tmaxp[i];

    float best_t = fminf(tmx, IG_FLT_MAX), best_u = 0.f, best_v = 0.f;
    int best_p = -1;
    bool occ = false;

    if (tmx >= tmn) {
        const float idx = inv_dir(dx), idy = inv_dir(dy), idz = inv_dir(dz);
        int stack[STACK_SIZE];
        int sp = 0;
        stack[sp++] = 0;
        while (sp > 0 && !occ) {
            const int base = stack[--sp] * 8;
            for (int j = 0; j < 8; ++j) {
                const int c = __ldg(nodes.child + base + j);
                if (c == 0)
                    continue;
                const float t0x = (__ldg(nodes.cmin_x + base + j) - px) * idx;
                const float t1x = (__ldg(nodes.cmax_x + base + j) - px) * idx;
                const float t0y = (__ldg(nodes.cmin_y + base + j) - py) * idy;
                const float t1y = (__ldg(nodes.cmax_y + base + j) - py) * idy;
                const float t0z = (__ldg(nodes.cmin_z + base + j) - pz) * idz;
                const float t1z = (__ldg(nodes.cmax_z + base + j) - pz) * idz;
                const float tnear = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                                          fmaxf(fminf(t0z, t1z), tmn));
                const float tfar = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                                         fminf(fmaxf(t0z, t1z), best_t));
                if (!(tnear <= tfar))
                    continue;
                if (c > 0) {
                    if (sp < STACK_SIZE)
                        stack[sp++] = c;
                    else
                        atomicAdd(overflow, 1);
                    continue;
                }
                const int lv = -c - 1;
                const int start = lv >> 4;
                const int count = lv & 15;
                for (int k = start; k < start + count; ++k) {
                    float t, u, v;
                    if (!mt(soup, k, px, py, pz, dx, dy, dz, t, u, v))
                        continue;
                    if (!(t > tmn))
                        continue;
                    if (ANY_HIT) {
                        if (t < best_t && (soup.vis == nullptr || __ldg(soup.vis + k))) {
                            occ = true;
                            break;
                        }
                    } else if (t < best_t || (t == best_t && k < best_p)) {
                        best_t = t; best_u = u; best_v = v; best_p = k;
                    }
                }
                if (ANY_HIT && occ)
                    break;
            }
        }
    }
    if (ANY_HIT) {
        occ_out[i] = occ ? 1 : 0;
    } else {
        t_out[i] = best_p >= 0 ? best_t : IG_FLT_MAX;
        prim_out[i] = best_p;
        u_out[i] = best_u;
        v_out[i] = best_v;
    }
}

}  // namespace

extern "C" int ig_bvh_walk(const float* ox, const float* oy, const float* oz,
                           const float* dx, const float* dy, const float* dz,
                           const float* tmin, const float* tmax, int n,
                           const float* v0x, const float* v0y, const float* v0z,
                           const float* e1x, const float* e1y, const float* e1z,
                           const float* e2x, const float* e2y, const float* e2z,
                           const uint8_t* vis, const float* cmin_x,
                           const float* cmin_y, const float* cmin_z,
                           const float* cmax_x, const float* cmax_y,
                           const float* cmax_z, const int* child, int any_hit,
                           float* t_out, int* prim_out, float* u_out,
                           float* v_out, uint8_t* occ_out, int* overflow,
                           void* stream)
{
    if (n <= 0)
        return 0;
    const Soup soup{v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z, vis};
    const Nodes nodes{cmin_x, cmin_y, cmin_z, cmax_x, cmax_y, cmax_z, child};
    const dim3 grid((n + BLOCK - 1) / BLOCK);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (any_hit)
        bvh_walk_kernel<true><<<grid, BLOCK, 0, s>>>(
            ox, oy, oz, dx, dy, dz, tmin, tmax, n, soup, nodes, t_out,
            prim_out, u_out, v_out, occ_out, overflow);
    else
        bvh_walk_kernel<false><<<grid, BLOCK, 0, s>>>(
            ox, oy, oz, dx, dy, dz, tmin, tmax, n, soup, nodes, t_out,
            prim_out, u_out, v_out, occ_out, overflow);
    return static_cast<int>(cudaGetLastError());
}
