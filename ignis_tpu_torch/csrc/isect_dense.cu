// K2: dense ray-triangle closest-hit / any-hit for Hopper (sm_90a).
//
// Replaces the TPU kernel ignis_tpu/ops/pallas_isect.py::_isect_kernel
// (launched by _intersect_impl; default `vpu` branch, exact fp32
// Moeller-Trumbore). It serves scenes below the BVH threshold, where every
// ray is tested against every triangle.
//
// What bounds it on the card: arithmetic. Each ray/triangle pair costs
// ~50 fp32 operations against 40 bytes of triangle data, and every ray of a
// block needs the same triangles, so the soup is read once per block into
// shared memory (10 floats per triangle, TILE triangles = 10 KB) and the
// inner loop runs from shared memory and registers. Device-memory traffic
// is the ray load/store (48 bytes per ray) plus T*40 bytes per block.
//
// Design, written for the card rather than carried over from the TPU:
// - one ray per thread, 256 threads per block; no lane-block chunk AABB
//   bitmask and no packed (t, prim) key;
// - closest hit keeps (t, prim, u, v) in registers; triangles are visited
//   in increasing prim order and a hit replaces the best only on a strictly
//   smaller t, so equal t keeps the lowest prim id (the dense scan's
//   argmin + strict `<`, ignis_tpu/ops/intersect.py:141-147);
// - any hit stops a thread at its first visible hit, and the block leaves
//   its tile loop once no thread still searches (__syncthreads_or);
// - lanes with tmax < tmin are dead: they miss at once and only help load
//   tiles;
// - the determinant test is |det| > 1e-16, the JAX CPU path's epsilon
//   (intersect.py:59), not the Pallas kernels' 1e-9;
// - a miss writes t = 3e38 and prim = -1.
// Built with -fmad=false (ops/cuda_build.py): every operation rounds as in
// the plain torch version, in the same order, so the two agree bit for bit;
// FMA contraction made grazing hits differ by more than rtol 1e-4 in t.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 256;
constexpr float IG_FLT_MAX = 3.0e38f;
constexpr float DET_EPS = 1e-16f;

template <bool ANY_HIT>
__global__ void __launch_bounds__(TILE)
isect_dense_kernel(const float* __restrict__ ox, const float* __restrict__ oy,
                   const float* __restrict__ oz, const float* __restrict__ dxp,
                   const float* __restrict__ dyp, const float* __restrict__ dzp,
                   const float* __restrict__ tminp,
                   const float* __restrict__ tmaxp, int n,
                   const float* __restrict__ v0x, const float* __restrict__ v0y,
                   const float* __restrict__ v0z, const float* __restrict__ e1x,
                   const float* __restrict__ e1y, const float* __restrict__ e1z,
                   const float* __restrict__ e2x, const float* __restrict__ e2y,
                   const float* __restrict__ e2z,
                   const uint8_t* __restrict__ vis, int n_tris,
                   float* __restrict__ t_out, int* __restrict__ prim_out,
                   float* __restrict__ u_out, float* __restrict__ v_out,
                   uint8_t* __restrict__ occ_out)
{
    __shared__ float s_tri[10][TILE];
    const int tid = threadIdx.x;
    const int i = blockIdx.x * TILE + tid;
    const bool in_range = i < n;

    float px = 0.f, py = 0.f, pz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
    float tmn = 0.f, tmx = -1.f;
    if (in_range) {
        px = ox[i]; py = oy[i]; pz = oz[i];
        dx = dxp[i]; dy = dyp[i]; dz = dzp[i];
        tmn = tminp[i]; tmx = tmaxp[i];
    }
    const bool live = in_range && tmx >= tmn;

    float best_t = IG_FLT_MAX, best_u = 0.f, best_v = 0.f;
    int best_p = -1;
    bool occ = false;

    for (int base = 0; base < n_tris; base += TILE) {
        const bool searching = ANY_HIT ? (live && !occ) : live;
        // also the barrier that keeps the previous tile alive until every
        // thread has finished reading it
        if (!__syncthreads_or(searching))
            break;
        const int k = base + tid;
        if (k < n_tris) {
            s_tri[0][tid] = v0x[k]; s_tri[1][tid] = v0y[k]; s_tri[2][tid] = v0z[k];
            s_tri[3][tid] = e1x[k]; s_tri[4][tid] = e1y[k]; s_tri[5][tid] = e1z[k];
            s_tri[6][tid] = e2x[k]; s_tri[7][tid] = e2y[k]; s_tri[8][tid] = e2z[k];
            s_tri[9][tid] = (vis == nullptr || vis[k]) ? 1.f : 0.f;
        }
        __syncthreads();
        if (!searching)
            continue;
        const int count = min(TILE, n_tris - base);
        for (int j = 0; j < count; ++j) {
            const float ax = s_tri[3][j], ay = s_tri[4][j], az = s_tri[5][j];
            const float bx = s_tri[6][j], by = s_tri[7][j], bz = s_tri[8][j];
            // pvec = d x e2, det = e1 . pvec
            const float pvx = dy * bz - dz * by;
            const float pvy = dz * bx - dx * bz;
            const float pvz = dx * by - dy * bx;
            const float det = ax * pvx + ay * pvy + az * pvz;
            if (!(fabsf(det) > DET_EPS))
                continue;
            const float inv_det = 1.0f / det;
            const float tvx = px - s_tri[0][j];
            const float tvy = py - s_tri[1][j];
            const float tvz = pz - s_tri[2][j];
            const float u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det;
            // qvec = tvec x e1
            const float qvx = tvy * az - tvz * ay;
            const float qvy = tvz * ax - tvx * az;
            const float qvz = tvx * ay - tvy * ax;
            const float v = (dx * qvx + dy * qvy + dz * qvz) * inv_det;
            const float t = (bx * qvx + by * qvy + bz * qvz) * inv_det;
            const bool ok = u >= 0.f && v >= 0.f && u + v <= 1.f && t > tmn
                && t < tmx;
            if (ANY_HIT) {
                if (ok && s_tri[9][j] > 0.f) {
                    occ = true;
                    break;
                }
            } else if (ok && t < best_t) {
                best_t = t; best_u = u; best_v = v; best_p = base + j;
            }
        }
    }
    if (!in_range)
        return;
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

extern "C" int ig_isect_dense(const float* ox, const float* oy, const float* oz,
                              const float* dx, const float* dy, const float* dz,
                              const float* tmin, const float* tmax, int n,
                              const float* v0x, const float* v0y,
                              const float* v0z, const float* e1x,
                              const float* e1y, const float* e1z,
                              const float* e2x, const float* e2y,
                              const float* e2z, const uint8_t* vis, int n_tris,
                              int any_hit, float* t_out, int* prim_out,
                              float* u_out, float* v_out, uint8_t* occ_out,
                              void* stream)
{
    if (n <= 0)
        return 0;
    const dim3 grid((n + TILE - 1) / TILE);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (any_hit)
        isect_dense_kernel<true><<<grid, TILE, 0, s>>>(
            ox, oy, oz, dx, dy, dz, tmin, tmax, n, v0x, v0y, v0z, e1x, e1y,
            e1z, e2x, e2y, e2z, vis, n_tris, t_out, prim_out, u_out, v_out,
            occ_out);
    else
        isect_dense_kernel<false><<<grid, TILE, 0, s>>>(
            ox, oy, oz, dx, dy, dz, tmin, tmax, n, v0x, v0y, v0z, e1x, e1y,
            e1z, e2x, e2y, e2z, vis, n_tris, t_out, prim_out, u_out, v_out,
            occ_out);
    return static_cast<int>(cudaGetLastError());
}
