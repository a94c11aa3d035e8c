// K5a: the ELL neighbour sum of spatial autocorrelation, over a gene block.
//
// Replaces the XLA code of squidpy_tpu/ops/autocorr.py `_grouped_neighbor_sum`
// as `spmv_genes` (line 95), `moran_scores` (line 113), `geary_scores`
// (line 241) and their degree-bucketed variants (lines 147-227) use it. Over
// the padded-ELL rows of a graph (or of one degree bucket, whose rows map to
// the graph's rows through `rows`; or of the whole graph walked in the order
// `rows`) and a gene block x (n, g) float32:
//   mode 0 (spmv):  u[row, g] = sum_k w[r, k] * x[idx[r, k], g]
//   mode 1 (moran): num[g]    = sum_r sum_k (w[r, k] * x[row, g]) * x[idx[r, k], g]
//   mode 2 (geary): num[g]    = sum_r sum_k w[r, k] * (x[row, g] - x[idx[r, k], g])^2
// Padded slots carry weight 0 and are summed like the JAX package sums them.
//
// Bound on the card: device-memory bytes. At 1M x 512 with k_max 8 the least
// traffic (x once, the ELL arrays once, u once) is 4.2 GB, about 1.25 ms at
// 3.35 TB/s, while the arithmetic is 8e9 flops, 0.12 ms at 67 TFLOP/s. What
// the kernel fetches beyond that is neighbour rows of x read again: each row
// is gathered by its ~6 reverse neighbours, and on cells in random order those
// reads are six trips to device memory.
//
// Design:
// - the caller walks the rows in a locality order (the Morton order of the
//   cells: the wrapper's `walk`, passed as `rows` with `ell_by_row` set and
//   the graph's own ELL arrays, whose slots are read through it: reordering 1M ELL rows in torch costs more than the
//   kernel), so rows close in the walk share most of their neighbours;
// - a work item is `rows_per_item` consecutive ELL rows of one gene slice
//   (32 lanes x 4 genes, one float4 a lane where every row starts on 16
//   bytes, four scalar loads of the same 512-byte run where not); items are
//   numbered slice-fastest, and the persistent warps take them with a fixed
//   stride (so a warp always sums the same genes), so the warps resident at
//   once cover one stretch of the walk over every slice. The wrapper sizes
//   the stretch to a part of the L2 (`ops/autocorr.py` `k5a_layout`): a row of
//   x fetched for one row is then found in the L2 by its other reverse
//   neighbours;
// - a warp loads the ELL row's slots once and shuffles them to its lanes;
//   every lane issues the gathers of kGather = 4 neighbour rows (64 bytes in
//   flight a lane) before it sums any; 8 held more registers, fewer resident
//   warps, and ran no faster;
//   the ELL arrays and the map are read with an evict-first hint and u is
//   stored with one, so neither pushes x out of the L2;
// - products and sums are rounded one by one in slot order (__fmul_rn /
//   __fadd_rn, and --fmad=false), so mode 0 equals the plain torch version's
//   slot-by-slot sum bitwise, in any row order;
// - modes 1 and 2 accumulate each lane's terms in double over the warp's
//   items; each warp writes one double partial per gene of its slice, and a
//   second pass sums the partials in a fixed order: no float atomics, so the
//   result is the same from run to run (the row order of a walk changes the
//   partials' grouping, within float rounding of the terms).

#include "common.cuh"

namespace {

constexpr int kWarps = 8;   // warps a block
constexpr int kVec = 4;     // genes a lane
constexpr int kGather = 4;  // neighbour rows a lane gathers before it sums any
constexpr unsigned kFull = 0xffffffffu;

// the lane's genes gene..gene+3 of the row at p (p = row start + gene): one
// float4, or (ALIGNED false) the ones below g one by one, the rest 0
template <bool ALIGNED>
__device__ __forceinline__ void load_genes(const float* p, int gene, int g, float (&v)[kVec]) {
    if constexpr (ALIGNED) {
        const float4 t = __ldg(reinterpret_cast<const float4*>(p));
        v[0] = t.x;
        v[1] = t.y;
        v[2] = t.z;
        v[3] = t.w;
    } else {
#pragma unroll
        for (int c = 0; c < kVec; ++c) v[c] = gene + c < g ? __ldg(p + c) : 0.f;
    }
}

template <bool ALIGNED>
__device__ __forceinline__ void store_genes(float* p, int gene, int g, const float (&v)[kVec]) {
    if constexpr (ALIGNED) {
        __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
    } else {
#pragma unroll
        for (int c = 0; c < kVec; ++c) {
            if (gene + c < g) __stcs(p + c, v[c]);
        }
    }
}

// at most 64 registers, so 4 blocks (32 warps) stay resident an SM; the
// fused modes spill a few words there and still run ~7% faster than at 3
template <int MODE, bool ALIGNED>
__global__ void __launch_bounds__(kWarps * 32, 4)
    ell_autocorr_kernel(const int32_t* __restrict__ rows, const int32_t* __restrict__ idx,
                        const float* __restrict__ w, int n_b, int k, const float* __restrict__ x, int g, int slices,
                        int rows_per_item, long long items, int ell_by_row, float* __restrict__ u,
                        double* __restrict__ partial) {
    const int lane = threadIdx.x & 31;
    const long long warp = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
    // a whole number of slice sets, so a strided warp keeps one slice
    const long long warps = static_cast<long long>(gridDim.x) * kWarps / slices * slices;
    if (warp >= warps) return;  // warp-uniform; the kernel has no block barrier
    const int gene = static_cast<int>(warp % slices) * 32 * kVec + lane * kVec;
    const bool live = gene < g;
    double acc[kVec] = {};
    for (long long item = warp; item < items; item += warps) {
        const long long r0 = item / slices * rows_per_item;
        const long long r1 = min(static_cast<long long>(n_b), r0 + rows_per_item);
        for (long long r = r0; r < r1; ++r) {
            const size_t row = rows ? static_cast<size_t>(__ldcs(rows + r)) : static_cast<size_t>(r);
            const size_t erow = ell_by_row ? row : static_cast<size_t>(r);
            const int32_t* ir = idx + erow * k;
            const float* wr = w + erow * k;
            float s[kVec] = {};
            float xi[kVec] = {};
            if (MODE != 0 && live) load_genes<ALIGNED>(x + row * g + gene, gene, g, xi);
            for (int q0 = 0; q0 < k; q0 += 32) {
                const int nq = min(32, k - q0);
                int my_j = 0;
                float my_w = 0.f;
                if (lane < nq) {
                    my_j = __ldcs(ir + q0 + lane);
                    my_w = __ldcs(wr + q0 + lane);
                }
                for (int q1 = 0; q1 < nq; q1 += kGather) {
                    float xj[kGather][kVec];
                    float wq[kGather];
#pragma unroll
                    for (int t = 0; t < kGather; ++t) {
                        const int j = __shfl_sync(kFull, my_j, (q1 + t) & 31);
                        wq[t] = __shfl_sync(kFull, my_w, (q1 + t) & 31);
                        if (live && q1 + t < nq) {
                            load_genes<ALIGNED>(x + static_cast<size_t>(j) * g + gene, gene, g, xj[t]);
                        }
                    }
                    if (!live) continue;
#pragma unroll
                    for (int t = 0; t < kGather; ++t) {
                        if (q1 + t >= nq) break;
#pragma unroll
                        for (int v = 0; v < kVec; ++v) {
                            if (MODE == 0) {
                                s[v] = __fadd_rn(s[v], __fmul_rn(wq[t], xj[t][v]));
                            } else if (MODE == 1) {
                                acc[v] += static_cast<double>(__fmul_rn(__fmul_rn(wq[t], xi[v]), xj[t][v]));
                            } else {
                                const float d = __fsub_rn(xi[v], xj[t][v]);
                                acc[v] += static_cast<double>(__fmul_rn(wq[t], __fmul_rn(d, d)));
                            }
                        }
                    }
                }
            }
            if (MODE == 0 && live) store_genes<ALIGNED>(u + row * g + gene, gene, g, s);
        }
    }
    if (MODE == 0) return;
#pragma unroll
    for (int v = 0; v < kVec; ++v) {
        if (gene + v < g) partial[static_cast<size_t>(warp / slices) * g + gene + v] = acc[v];
    }
}

__global__ void sum_partials_kernel(const double* __restrict__ partial, int groups, int g,
                                    float* __restrict__ out) {
    const int gene = blockIdx.x * blockDim.x + threadIdx.x;
    if (gene >= g) return;
    double s = 0.0;
    for (int b = 0; b < groups; ++b) s += partial[static_cast<size_t>(b) * g + gene];
    out[gene] = static_cast<float>(s);
}

template <int MODE, bool ALIGNED>
const void* kernel_ptr() {
    return reinterpret_cast<const void*>(ell_autocorr_kernel<MODE, ALIGNED>);
}

const void* kernel_for(int mode, int aligned) {
    if (aligned) return mode == 0 ? kernel_ptr<0, true>() : mode == 1 ? kernel_ptr<1, true>() : kernel_ptr<2, true>();
    return mode == 0 ? kernel_ptr<0, false>() : mode == 1 ? kernel_ptr<1, false>() : kernel_ptr<2, false>();
}

template <int MODE, bool ALIGNED>
void launch(int blocks, cudaStream_t s, const int32_t* rows, const int32_t* idx, const float* w, int n_b, int k,
            const float* x, int g, int slices, int rows_per_item, long long items, int ell_by_row, float* u,
            double* partial) {
    ell_autocorr_kernel<MODE, ALIGNED><<<blocks, kWarps * 32, 0, s>>>(rows, idx, w, n_b, k, x, g, slices,
                                                                      rows_per_item, items, ell_by_row, u, partial);
}

}  // namespace

// What the wrapper sizes a launch from, for mode 0-2, aligned (float4) or
// not: out[0] resident blocks an SM, out[1] registers a thread, out[2] SMs,
// out[3] L2 bytes of the current device.
SQT_EXPORT int sqt_ell_autocorr_layout(int mode, int aligned, int* out) {
    if (mode < 0 || mode > 2) return static_cast<int>(cudaErrorInvalidValue);
    const void* kernel = kernel_for(mode, aligned);
    cudaFuncAttributes attr;
    int dev = 0;
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], kernel, kWarps * 32, 0);
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
    if (err == cudaSuccess) out[1] = attr.numRegs;
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&out[2], cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&out[3], cudaDevAttrL2CacheSize, dev);
    return static_cast<int>(err);
}

// rows (n_b,) int32 or null (rows 0..n_b-1); idx (n_b, k) int32 and w (n_b, k)
// float32, row r for rows[r] (or, with ell_by_row, n_b = n rows, row i for
// graph row i, walked in the order rows); x (n, g) float32 (and u), every
// row starting on 16 bytes when `aligned`. `blocks` blocks of kWarps warps take `items` items of
// `rows_per_item` rows of one of `slices` 128-gene slices. Mode 0 writes u
// (n, g) at the mapped rows; modes 1 and 2 write partial (blocks * kWarps /
// slices, g) float64 scratch and result (g,).
SQT_EXPORT int sqt_ell_autocorr(int mode, int aligned, const int32_t* rows, const int32_t* idx, const float* w,
                                int n_b, int k, const float* x, int g, int slices, int blocks, int rows_per_item,
                                long long items, int ell_by_row, float* u, double* partial, float* result,
                                void* stream) {
    if (n_b <= 0 || k <= 0 || g <= 0 || mode < 0 || mode > 2 || (aligned && g % kVec) ||
        slices != (g + 32 * kVec - 1) / (32 * kVec) || blocks <= 0 ||
        static_cast<long long>(blocks) * kWarps < slices || rows_per_item <= 0 || items <= 0 ||
        (ell_by_row && !rows)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SQT_K5A_ARGS blocks, s, rows, idx, w, n_b, k, x, g, slices, rows_per_item, items, ell_by_row, u, partial
    if (aligned) {
        if (mode == 0) launch<0, true>(SQT_K5A_ARGS);
        else if (mode == 1) launch<1, true>(SQT_K5A_ARGS);
        else launch<2, true>(SQT_K5A_ARGS);
    } else {
        if (mode == 0) launch<0, false>(SQT_K5A_ARGS);
        else if (mode == 1) launch<1, false>(SQT_K5A_ARGS);
        else launch<2, false>(SQT_K5A_ARGS);
    }
#undef SQT_K5A_ARGS
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || mode == 0) return static_cast<int>(err);
    const int groups = static_cast<int>(static_cast<long long>(blocks) * kWarps / slices);
    sum_partials_kernel<<<(g + 255) / 256, 256, 0, s>>>(partial, groups, g, result);
    return static_cast<int>(cudaGetLastError());
}
