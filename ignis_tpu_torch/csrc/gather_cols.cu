// K3: row gather of a [T, K] f32 table at N indices, and its scatter-add
// adjoint, for Hopper (sm_90a).
//
// Replaces the TPU kernel ignis_tpu/ops/gather.py::_gather_kernel (called
// by _gather_cols_call, entry gather_cols) and its VJP _gather_cols_bwd.
// The TPU form fetched rows as one-hot x table products on the MXU, with the
// f32 table split into bf16 hi and lo halves; here a row is copied, so the
// result is the exact f32 value (the MXU form carries about 2^-18 relative
// error).
//
// What bounds it on the card: memory. It moves 4 bytes in and 4 bytes out
// per output element plus the index; the hit shader's 22 attribute columns
// (techniques/path.py) at 262,144 lanes are 23 MB of reads and writes. The
// table's rows are gathered at random, so reads are only as coalesced as
// the K consecutive floats of a row; writes are fully coalesced.
// Design:
// - ig_gather_rows: one output element per thread, element e = i*K + k
//   reading tab[idx[i]*K + k], so neighbouring threads write neighbouring
//   addresses and read along a row;
// - ig_scatter_add_rows: one gradient element per thread, atomicAdd into
//   the zeroed [T, K] table gradient; rows hit by many lanes collide, and
//   the order of the sums, so their last bits, varies from run to run;
// - an index outside [0, T) is clamped into it, so a bad index reads or
//   writes a wrong row rather than outside the table (the caller clamps
//   first, as the JAX caller does).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 256;

__device__ __forceinline__ int64_t row_of(const int* idx, int64_t i, int t)
{
    const int r = idx[i];
    return r < 0 ? 0 : (r >= t ? t - 1 : r);
}

__global__ void __launch_bounds__(BLOCK)
gather_rows_kernel(const int* __restrict__ idx, const float* __restrict__ tab,
                   float* __restrict__ out, int64_t total, int k, int t)
{
    const int64_t e = static_cast<int64_t>(blockIdx.x) * BLOCK + threadIdx.x;
    if (e >= total)
        return;
    const int64_t i = e / k;
    out[e] = tab[row_of(idx, i, t) * k + (e - i * k)];
}

__global__ void __launch_bounds__(BLOCK)
scatter_add_rows_kernel(const int* __restrict__ idx,
                        const float* __restrict__ g, float* __restrict__ dtab,
                        int64_t total, int k, int t)
{
    const int64_t e = static_cast<int64_t>(blockIdx.x) * BLOCK + threadIdx.x;
    if (e >= total)
        return;
    const int64_t i = e / k;
    atomicAdd(dtab + row_of(idx, i, t) * k + (e - i * k), g[e]);
}

dim3 grid_for(int64_t total)
{
    return dim3(static_cast<unsigned>((total + BLOCK - 1) / BLOCK));
}

}  // namespace

extern "C" int ig_gather_rows(const int* idx, const float* tab, float* out,
                              int n, int k, int t, void* stream)
{
    const int64_t total = static_cast<int64_t>(n) * k;
    if (total <= 0 || t <= 0)
        return 0;
    gather_rows_kernel<<<grid_for(total), BLOCK, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        idx, tab, out, total, k, t);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int ig_scatter_add_rows(const int* idx, const float* g, float* dtab,
                                   int n, int k, int t, void* stream)
{
    const int64_t total = static_cast<int64_t>(n) * k;
    if (total <= 0 || t <= 0)
        return 0;
    scatter_add_rows_kernel<<<grid_for(total), BLOCK, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        idx, g, dtab, total, k, t);
    return static_cast<int>(cudaGetLastError());
}
