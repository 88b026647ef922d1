// Fixed-winner backward of the closest-hit kernels K1 and K2 (sm_90a).
//
// Replaces the two identical VJPs of the TPU kernels,
// ignis_tpu/ops/pallas_isect.py::_closest_bwd and
// ignis_tpu/ops/pallas_bvh.py::_bvh_closest_bwd, which re-evaluate
// Moeller-Trumbore (_mt_terms, pallas_isect.py:133) at each ray's winning
// triangle under jax.vjp and scatter the soup gradients with a gather
// adjoint.
//
// What bounds it on the card: memory. Per ray it reads 6 ray floats, the
// prim and 3 cotangents, gathers the winner's 9 soup floats, stores 6 ray
// gradients and issues 9 atomic adds into the soup gradients (~130 bytes of
// traffic against ~150 flops), so it is a bandwidth and atomic-throughput
// kernel. Design: one ray per thread; the forward is recomputed in
// registers and the adjoint is written out by hand (no tape); per-ray
// gradients are plain coalesced stores; soup gradients are atomicAdd into
// arrays the wrapper has zeroed. Rays hitting the same triangle collide on
// its 9 addresses; the atomics make the soup sums' order, and so their last
// bits, vary from run to run.
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

__device__ __forceinline__ void atomic3(float* x, float* y, float* z, int i,
                                        V3 v)
{
    atomicAdd(x + i, v.x); atomicAdd(y + i, v.y); atomicAdd(z + i, v.z);
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
                     float* __restrict__ gv0x, float* __restrict__ gv0y,
                     float* __restrict__ gv0z, float* __restrict__ ge1x,
                     float* __restrict__ ge1y, float* __restrict__ ge1z,
                     float* __restrict__ ge2x, float* __restrict__ ge2y,
                     float* __restrict__ ge2z, int n)
{
    const int i = blockIdx.x * BLOCK + threadIdx.x;
    if (i >= n)
        return;
    const int k = prim[i];
    if (k < 0) {
        const V3 zero = {0.f, 0.f, 0.f};
        store3(gox, goy, goz, i, zero);
        store3(gdx, gdy, gdz, i, zero);
        return;
    }
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
    atomic3(gv0x, gv0y, gv0z, k, {-ds.x, -ds.y, -ds.z});
    atomic3(ge1x, ge1y, ge1z, k, de1);
    atomic3(ge2x, ge2y, ge2z, k, de2);
}

}  // namespace

extern "C" int ig_mt_replay_bwd(
    const float* ox, const float* oy, const float* oz, const float* dx,
    const float* dy, const float* dz, const float* v0x, const float* v0y,
    const float* v0z, const float* e1x, const float* e1y, const float* e1z,
    const float* e2x, const float* e2y, const float* e2z, const int* prim,
    const float* gt, const float* gu, const float* gv, float* gox, float* goy,
    float* goz, float* gdx, float* gdy, float* gdz, float* gv0x, float* gv0y,
    float* gv0z, float* ge1x, float* ge1y, float* ge1z, float* ge2x,
    float* ge2y, float* ge2z, int n, void* stream)
{
    if (n <= 0)
        return 0;
    const dim3 grid((n + BLOCK - 1) / BLOCK);
    mt_replay_bwd_kernel<<<grid, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
        ox, oy, oz, dx, dy, dz, v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z,
        prim, gt, gu, gv, gox, goy, goz, gdx, gdy, gdz, gv0x, gv0y, gv0z,
        ge1x, ge1y, ge1z, ge2x, ge2y, ge2z, n);
    return static_cast<int>(cudaGetLastError());
}
