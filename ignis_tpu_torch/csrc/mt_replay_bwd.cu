// Fixed-winner backward of the closest-hit kernels K1 and K2 (sm_90a).
//
// Replaces the two identical VJPs of the TPU kernels,
// ignis_tpu/ops/pallas_isect.py::_closest_bwd and
// ignis_tpu/ops/pallas_bvh.py::_bvh_closest_bwd, which re-evaluate
// Moeller-Trumbore (_mt_terms, pallas_isect.py:133) at each ray's winning
// triangle under jax.vjp and scatter the soup gradients with a gather
// adjoint.
//
// What bounds it on the card: memory and same-address atomics. Per ray it
// reads 6 ray floats, the prim and 3 cotangents, gathers the winner's 9
// soup floats, stores 6 ray gradients and adds 9 terms into the soup
// gradients (~130 bytes of traffic against ~150 flops). Rays that hit one
// triangle add into the same 9 addresses, and on the main path they do so
// in bulk: 81% of S1's timing rays' hits land on its two floor triangles,
// one of them taking 29% of all rays, so one atomicAdd per ray and
// component serialises ~10^5 adds on each of 9 addresses.
//
// Design: one ray per thread; the forward is recomputed in registers and
// the adjoint is written out by hand (no tape); per-ray gradients are plain
// coalesced stores. The soup gradients go into one [3, T] buffer of
// float4, zeroed by the wrapper with one fill: v0, e1 and e2 of triangle k
// (xyz, then 0) at k, T + k and 2T + k, so each is one float4 atomicAdd
// (sm_90) and the three lie on three cache lines. The lanes of a warp that
// share a winner (__match_any_sync on prim, taken as soon as the prim is
// loaded) first sum their terms by a tree of shuffles over their ranks
// within the group, and only the group's first lane adds; a warp whose
// winners are all distinct (misses aside) adds lane by lane with no
// shuffle. Only the soup sums change order (run to run as well, through
// the atomics); the per-ray gradients are those of mt_adjoint bit for bit.
//
// Arithmetic follows _mt_terms: inv_det = 1 / (|det| < 1e-9 ? 1 : det), and
// where |det| < 1e-9 the determinant gets no gradient. Rays with prim < 0
// get zero gradients and add nothing.
//
// Adjoint, with p = d x e2, s = o - v0, q = s x e1, det = e1.p,
// inv = 1/det and cotangents gt, gu, gv:
//   a_t = gt inv, a_u = gu inv, a_v = gv inv,
//   g_det = -(gt t + gu u + gv v) inv;
//   de2 = a_t q; dq = a_t e2 + a_v d; ds = a_u p; dp = a_u s + g_det e1;
//   dd = a_v q; de1 = g_det p;
//   ds += e1 x dq; de1 += dq x s; dd += e2 x dp; de2 += dp x d;
//   do = ds; dv0 = -ds.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 256;
constexpr float MT_EPS = 1e-9f;

struct V3 {
    float x, y, z;
};

__device__ __forceinline__ V3 cross3(V3 a, V3 b)
{
    return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
            a.x * b.y - a.y * b.x};
}

__device__ __forceinline__ float dot3(V3 a, V3 b)
{
    return a.x * b.x + a.y * b.y + a.z * b.z;
}

__device__ __forceinline__ V3 axpy(float a, V3 x, V3 y)
{
    return {a * x.x + y.x, a * x.y + y.y, a * x.z + y.z};
}

__device__ __forceinline__ V3 add3(V3 a, V3 b)
{
    return {a.x + b.x, a.y + b.y, a.z + b.z};
}

__device__ __forceinline__ V3 load3(const float* x, const float* y,
                                    const float* z, int i)
{
    return {x[i], y[i], z[i]};
}

__device__ __forceinline__ void store3(float* x, float* y, float* z, int i,
                                       V3 v)
{
    x[i] = v.x; y[i] = v.y; z[i] = v.z;
}

// Lane of the r-th (from 0) set bit of mask: the largest lane with at most
// r set bits below it, found by binary search.
__device__ __forceinline__ int lane_of_rank(unsigned mask, int r)
{
    int lane = 0;
#pragma unroll
    for (int b = 16; b > 0; b >>= 1)
        if (__popc(mask & ((1u << (lane + b)) - 1u)) <= r)
            lane += b;
    return lane;
}

__global__ void __launch_bounds__(BLOCK)
mt_replay_bwd_kernel(const float* __restrict__ ox, const float* __restrict__ oy,
                     const float* __restrict__ oz, const float* __restrict__ dxp,
                     const float* __restrict__ dyp, const float* __restrict__ dzp,
                     const float* __restrict__ v0x, const float* __restrict__ v0y,
                     const float* __restrict__ v0z, const float* __restrict__ e1x,
                     const float* __restrict__ e1y, const float* __restrict__ e1z,
                     const float* __restrict__ e2x, const float* __restrict__ e2y,
                     const float* __restrict__ e2z, const int* __restrict__ prim,
                     const float* __restrict__ gtp, const float* __restrict__ gup,
                     const float* __restrict__ gvp,
                     float* __restrict__ gox, float* __restrict__ goy,
                     float* __restrict__ goz, float* __restrict__ gdx,
                     float* __restrict__ gdy, float* __restrict__ gdz,
                     float4* __restrict__ gsoup, int n_tris, int n)
{
    // Every lane of the warp stays to the shuffles; lanes past n or with
    // prim < 0 carry k = -1 and zero soup terms.
    const int i = blockIdx.x * BLOCK + threadIdx.x;
    const int k = i < n ? prim[i] : -1;

    // Group the lanes by winner now, while the ray and soup loads below are
    // still to be issued: only the prim is needed for it.
    const unsigned FULL = 0xffffffffu;
    const int lane = threadIdx.x & 31;
    const unsigned group = __match_any_sync(FULL, k);
    const int size = __popc(group);
    const int rank = __popc(group & ((1u << lane) - 1u));
    const int widest = __reduce_max_sync(FULL, k >= 0 ? size : 1);

    float g[9] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (i < n && k < 0) {
        const V3 zero = {0.f, 0.f, 0.f};
        store3(gox, goy, goz, i, zero);
        store3(gdx, gdy, gdz, i, zero);
    } else if (i < n) {
        const V3 o = load3(ox, oy, oz, i);
        const V3 d = load3(dxp, dyp, dzp, i);
        const V3 v0 = load3(v0x, v0y, v0z, k);
        const V3 e1 = load3(e1x, e1y, e1z, k);
        const V3 e2 = load3(e2x, e2y, e2z, k);

        // forward, in _mt_terms' order
        const V3 p = cross3(d, e2);
        const float det = dot3(e1, p);
        const V3 s = {o.x - v0.x, o.y - v0.y, o.z - v0.z};
        const V3 q = cross3(s, e1);
        const bool tiny = fabsf(det) < MT_EPS;
        const float inv = 1.0f / (tiny ? 1.0f : det);
        const float u = dot3(s, p) * inv;
        const float v = dot3(d, q) * inv;
        const float t = dot3(e2, q) * inv;

        // adjoint
        const float gt = gtp[i], gu = gup[i], gv = gvp[i];
        const float a_t = gt * inv, a_u = gu * inv, a_v = gv * inv;
        const float g_det = tiny ? 0.f : -(gt * t + gu * u + gv * v) * inv;
        V3 de2 = {a_t * q.x, a_t * q.y, a_t * q.z};
        const V3 dq = axpy(a_t, e2, {a_v * d.x, a_v * d.y, a_v * d.z});
        V3 ds = {a_u * p.x, a_u * p.y, a_u * p.z};
        const V3 dp = axpy(a_u, s, {g_det * e1.x, g_det * e1.y, g_det * e1.z});
        V3 dd = {a_v * q.x, a_v * q.y, a_v * q.z};
        V3 de1 = {g_det * p.x, g_det * p.y, g_det * p.z};
        ds = add3(ds, cross3(e1, dq));
        de1 = add3(de1, cross3(dq, s));
        dd = add3(dd, cross3(e2, dp));
        de2 = add3(de2, cross3(dp, d));

        store3(gox, goy, goz, i, ds);
        store3(gdx, gdy, gdz, i, dd);
        g[0] = -ds.x; g[1] = -ds.y; g[2] = -ds.z;
        g[3] = de1.x; g[4] = de1.y; g[5] = de1.z;
        g[6] = de2.x; g[7] = de2.y; g[8] = de2.z;
    }

    // A warp whose winners are all distinct (misses aside) adds its terms
    // lane by lane; any other first sums the terms of the lanes that share
    // a winner: at step s, the lane of rank r (r a multiple of 2s) adds the
    // partial sum of rank r + s, and the group's rank-0 lane adds the sum.
    if (widest == 1) {
        if (k >= 0) {
            atomicAdd(gsoup + k, make_float4(g[0], g[1], g[2], 0.f));
            atomicAdd(gsoup + n_tris + k, make_float4(g[3], g[4], g[5], 0.f));
            atomicAdd(gsoup + 2 * n_tris + k,
                      make_float4(g[6], g[7], g[8], 0.f));
        }
        return;
    }
    for (int s = 1; s < widest; s <<= 1) {
        const bool has = rank + s < size;
        const bool take = has && (rank & (2 * s - 1)) == 0;
        const int src = has ? lane_of_rank(group, rank + s) : lane;
#pragma unroll
        for (int c = 0; c < 9; ++c) {
            const float other = __shfl_sync(FULL, g[c], src);
            if (take)
                g[c] += other;
        }
    }
    if (k >= 0 && rank == 0) {
        atomicAdd(gsoup + k, make_float4(g[0], g[1], g[2], 0.f));
        atomicAdd(gsoup + n_tris + k, make_float4(g[3], g[4], g[5], 0.f));
        atomicAdd(gsoup + 2 * n_tris + k, make_float4(g[6], g[7], g[8], 0.f));
    }
}

}  // namespace

// gsoup: [3, n_tris, 4] f32, zeroed by the caller, 16-byte aligned: the
// v0, e1 and e2 gradients of triangle k (xyz, then 0) at [0|1|2, k].
extern "C" int ig_mt_replay_bwd(
    const float* ox, const float* oy, const float* oz, const float* dx,
    const float* dy, const float* dz, const float* v0x, const float* v0y,
    const float* v0z, const float* e1x, const float* e1y, const float* e1z,
    const float* e2x, const float* e2y, const float* e2z, const int* prim,
    const float* gt, const float* gu, const float* gv, float* gox, float* goy,
    float* goz, float* gdx, float* gdy, float* gdz, float* gsoup, int n_tris,
    int n, void* stream)
{
    if (n <= 0)
        return 0;
    const dim3 grid((n + BLOCK - 1) / BLOCK);
    mt_replay_bwd_kernel<<<grid, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
        ox, oy, oz, dx, dy, dz, v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z,
        prim, gt, gu, gv, gox, goy, goz, gdx, gdy, gdz,
        reinterpret_cast<float4*>(gsoup), n_tris, n);
    return static_cast<int>(cudaGetLastError());
}
