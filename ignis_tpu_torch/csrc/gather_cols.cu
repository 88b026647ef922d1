// K3: row gather of an f32 attribute table at N indices into K contiguous
// columns, and its scatter-add adjoint, for Hopper (sm_90a).
//
// Replaces the TPU kernel ignis_tpu/ops/gather.py::_gather_kernel (called
// by _gather_cols_call, entry gather_cols) and its VJP _gather_cols_bwd.
// The TPU form fetched rows as one-hot x table products on the MXU, with the
// f32 table split into bf16 hi and lo halves; here a row is copied, so the
// result is the exact f32 value (the MXU form carries about 2^-18 relative
// error).
//
// What bounds it on the card: memory. The gather moves the index and K
// floats out per lane plus each distinct row in; the hit shader's 22
// attribute columns (techniques/path.py) at 262,144 lanes are 24 MB. The
// scatter reads the same and writes the [T, S] gradient. Rows are fetched
// at random, so a row read is only as wide as the row itself; and on the
// main path the scatter's rows repeat: they are the hit winners, and most
// of a bounce's lanes hit a few triangles (a floor) or miss and are clamped
// to row 0 with zero cotangents.
// Design:
// - the table is [T, S] with S = 4Q a multiple of 4 (ops/gather.stack_cols
//   pads the K columns with zeros), so a row is Q aligned 16-byte words;
// - the output is a [K, N] column block: column c of every lane is one
//   contiguous [N] array, as the JAX function returns K columns, so the
//   shading ops that follow read each column at unit stride;
// - ig_gather_rows: one lane per thread; the thread reads its index once,
//   clamps it, loads the row with Q float4 __ldg and writes its K values,
//   one per column, so a warp's store to a column is 128 contiguous bytes;
// - ig_scatter_add_rows: one lane per thread reads its K cotangents
//   coalesced from the [K, N] block. A lane whose cotangents are all
//   exactly zero adds nothing (the gradient starts at +0, and adding +-0
//   leaves every entry as it is; NaN and inf are not zero and still add).
//   The lanes of a warp that share a row (__match_any_sync) sum their
//   values by a tree of shuffles over their ranks within the group, and
//   only the group's first lane holds the row's sum. The warp stages those
//   sums in shared memory and adds them with float4 atomicAdds into the
//   [T, S] gradient, neighbouring lanes on neighbouring words of a row, so
//   that one instruction covers 2 words of each 32-byte sector it touches
//   (a lane adding its own row's Q words instead touched 2Q sectors per 32
//   rows, and ran slower than scalar atomics on random rows). Only the
//   sums' order changes, run to run as well;
// - an index outside [0, T) is clamped into it, so a bad index reads or
//   writes a wrong row rather than outside the table (the caller clamps
//   first, as the JAX caller does).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 256;
constexpr int MAX_Q = 8;      // rows of up to 32 floats
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int clamp_row(int r, int t)
{
    return r < 0 ? 0 : (r >= t ? t - 1 : r);
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

template <int Q>
__global__ void __launch_bounds__(BLOCK)
gather_rows_kernel(const int* __restrict__ idx, const float4* __restrict__ tab,
                   float* __restrict__ out, int n, int k, int t)
{
    const int i = blockIdx.x * BLOCK + threadIdx.x;
    if (i >= n)
        return;
    const float4* row =
        tab + static_cast<int64_t>(clamp_row(__ldg(idx + i), t)) * Q;
    float v[4 * Q];
#pragma unroll
    for (int q = 0; q < Q; ++q) {
        const float4 w = __ldg(row + q);
        v[4 * q] = w.x;
        v[4 * q + 1] = w.y;
        v[4 * q + 2] = w.z;
        v[4 * q + 3] = w.w;
    }
#pragma unroll
    for (int c = 0; c < 4 * Q; ++c)
        if (c < k)
            out[static_cast<int64_t>(c) * n + i] = v[c];
}

template <int Q>
__global__ void __launch_bounds__(BLOCK)
scatter_add_rows_kernel(const int* __restrict__ idx,
                        const float* __restrict__ g, float4* __restrict__ dtab,
                        int n, int k, int t)
{
    // Every lane of the warp stays to the shuffles; lanes past n or with
    // all-zero cotangents carry row -1 and add nothing.
    // The index is loaded beside the cotangents, not after them.
    const int i = blockIdx.x * BLOCK + threadIdx.x;
    const int row = i < n ? idx[i] : 0;
    float v[4 * Q];
    bool nonzero = false;
#pragma unroll
    for (int c = 0; c < 4 * Q; ++c) {
        v[c] = (i < n && c < k) ? g[static_cast<int64_t>(c) * n + i] : 0.f;
        nonzero |= v[c] != 0.f;
    }
    const int r = nonzero ? clamp_row(row, t) : -1;

    const int lane = threadIdx.x & 31;
    const unsigned group = __match_any_sync(FULL, r);
    const int size = __popc(group);
    const int rank = __popc(group & ((1u << lane) - 1u));
    const int widest = __reduce_max_sync(FULL, r >= 0 ? size : 1);

    // At step s the lane of rank r (r a multiple of 2s) adds the partial
    // sum of rank r + s; the group's rank-0 lane ends with the sum.
    for (int s = 1; s < widest; s <<= 1) {
        const bool has = rank + s < size;
        const bool take = has && (rank & (2 * s - 1)) == 0;
        const int src = has ? lane_of_rank(group, rank + s) : lane;
#pragma unroll
        for (int c = 0; c < 4 * Q; ++c) {
            if (c < k) {   // k is the same on every lane
                const float other = __shfl_sync(FULL, v[c], src);
                if (take)
                    v[c] += other;
            }
        }
    }

    // Each group's first lane stages its row's sum; then the warp adds the
    // staged rows word by word, neighbouring lanes on neighbouring words of
    // a row, so an atomic instruction covers whole 32-byte sectors of few
    // rows rather than one word in each of 32 rows.
    __shared__ float4 stage[BLOCK / 32][32][Q];
    __shared__ int stage_row[BLOCK / 32][32];
    const int warp = threadIdx.x >> 5;
    const bool lead = r >= 0 && rank == 0;
    const unsigned leads = __ballot_sync(FULL, lead);
    if (lead) {
        const int slot = __popc(leads & ((1u << lane) - 1u));
#pragma unroll
        for (int q = 0; q < Q; ++q)
            stage[warp][slot][q] = make_float4(v[4 * q], v[4 * q + 1],
                                               v[4 * q + 2], v[4 * q + 3]);
        stage_row[warp][slot] = r;
    }
    __syncwarp();
    const int words = __popc(leads) * Q;
    for (int j = lane; j < words; j += 32) {
        const int slot = j / Q, q = j - slot * Q;
        atomicAdd(dtab + static_cast<int64_t>(stage_row[warp][slot]) * Q + q,
                  stage[warp][slot][q]);
    }
}

// The kernel for rows of Q float4s, Q in [1, MAX_Q], by recursion on Q.
template <int Q, template <int> class Launch, class... Args>
int dispatch(int q, Args... args)
{
    if constexpr (Q > MAX_Q) {
        return static_cast<int>(cudaErrorInvalidValue);
    } else {
        if (q == Q)
            return Launch<Q>::run(args...);
        return dispatch<Q + 1, Launch>(q, args...);
    }
}

dim3 grid_for(int n)
{
    return dim3(static_cast<unsigned>((n + BLOCK - 1) / BLOCK));
}

template <int Q>
struct Gather {
    static int run(const int* idx, const float* tab, float* out, int n, int k,
                   int t, cudaStream_t stream)
    {
        gather_rows_kernel<Q><<<grid_for(n), BLOCK, 0, stream>>>(
            idx, reinterpret_cast<const float4*>(tab), out, n, k, t);
        return static_cast<int>(cudaGetLastError());
    }
};

template <int Q>
struct Scatter {
    static int run(const int* idx, const float* g, float* dtab, int n, int k,
                   int t, cudaStream_t stream)
    {
        scatter_add_rows_kernel<Q><<<grid_for(n), BLOCK, 0, stream>>>(
            idx, g, reinterpret_cast<float4*>(dtab), n, k, t);
        return static_cast<int>(cudaGetLastError());
    }
};

bool bad_shape(const float* tab, int k, int stride)
{
    return stride % 4 != 0 || stride < 4 || stride > 4 * MAX_Q || k < 1
        || k > stride || reinterpret_cast<uintptr_t>(tab) % 16 != 0;
}

}  // namespace

// tab: [t, stride] f32, 16-byte aligned, stride a multiple of 4 up to 32;
// out: [k, n] f32, column c of lane i at c * n + i.
extern "C" int ig_gather_rows(const int* idx, const float* tab, float* out,
                              int n, int k, int stride, int t, void* stream)
{
    if (n <= 0 || t <= 0)
        return 0;
    if (bad_shape(tab, k, stride))
        return static_cast<int>(cudaErrorInvalidValue);
    return dispatch<1, Gather>(stride / 4, idx, tab, out, n, k, t,
                               static_cast<cudaStream_t>(stream));
}

// g: [k, n] f32 as the gather's output; dtab: [t, stride] f32, zeroed by
// the caller, 16-byte aligned; its columns k and above receive zeros.
extern "C" int ig_scatter_add_rows(const int* idx, const float* g, float* dtab,
                                   int n, int k, int stride, int t,
                                   void* stream)
{
    if (n <= 0 || t <= 0)
        return 0;
    if (bad_shape(dtab, k, stride))
        return static_cast<int>(cudaErrorInvalidValue);
    return dispatch<1, Scatter>(stride / 4, idx, g, dtab, n, k, t,
                                static_cast<cudaStream_t>(stream));
}
