// K5a: the ELL neighbour sum of spatial autocorrelation, over a gene block.
//
// Replaces the XLA code of squidpy_tpu/ops/autocorr.py `_grouped_neighbor_sum`
// as `spmv_genes` (line 95), `moran_scores` (line 113), `geary_scores`
// (line 241) and their degree-bucketed variants (lines 147-227) use it. Over
// the padded-ELL rows of a graph (or of one degree bucket, whose rows map to
// the graph's rows through `rows`) and a gene block x (n, g) float32:
//   mode 0 (spmv):  u[row, g] = sum_k w[r, k] * x[idx[r, k], g]
//   mode 1 (moran): num[g]    = sum_r sum_k (w[r, k] * x[row, g]) * x[idx[r, k], g]
//   mode 2 (geary): num[g]    = sum_r sum_k w[r, k] * (x[row, g] - x[idx[r, k], g])^2
// Padded slots carry weight 0 and are summed like the JAX package sums them.
//
// Bound on the card: device-memory bytes. Each row reads k neighbour rows of
// x (a gather of k_max x g floats) against 2-3 floating-point operations per
// gathered float; at 1M x 512 with k_max 8 the least traffic (x once, the
// ELL arrays once, u once) is 4.2 GB, about 1.25 ms at 3.35 TB/s, while the
// arithmetic is 8e9 flops, 0.12 ms at 67 TFLOP/s.
//
// Design:
// - a block is 32 genes (one warp's lanes, so every gathered neighbour row
//   segment is one coalesced 128-byte read) by 8 rows in flight; the grid is
//   row groups x gene tiles, each row group walking its rows in order;
// - the neighbour axis is walked in-thread; products and sums are rounded
//   one by one (__fmul_rn/__fadd_rn, and --fmad=false), so mode 0 equals the
//   plain torch version's slot-by-slot sum bitwise;
// - modes 1 and 2 accumulate each thread's terms in double, reduce the 8 rows
//   in flight in a fixed order into one double partial per (row group,
//   gene), and a second pass sums the partials in row-group order: no float
//   atomics, so the result is the same from run to run.

#include "common.cuh"

namespace {

constexpr int kGenes = 32;
constexpr int kRows = 8;

__global__ void ell_autocorr_kernel(int mode, const int32_t* __restrict__ rows, const int32_t* __restrict__ idx,
                                    const float* __restrict__ w, int n_b, int k, const float* __restrict__ x,
                                    int g, int rows_per_group, float* __restrict__ u,
                                    double* __restrict__ partial) {
    __shared__ double red[kRows][kGenes];
    const int gene = blockIdx.y * kGenes + threadIdx.x;
    const int r0 = blockIdx.x * rows_per_group;
    const int r1 = min(n_b, r0 + rows_per_group);
    double acc = 0.0;
    if (gene < g) {
        for (int r = r0 + threadIdx.y; r < r1; r += kRows) {
            const size_t row = rows ? static_cast<size_t>(rows[r]) : static_cast<size_t>(r);
            const int32_t* ir = idx + static_cast<size_t>(r) * k;
            const float* wr = w + static_cast<size_t>(r) * k;
            if (mode == 0) {
                float s = 0.f;
                for (int q = 0; q < k; ++q) {
                    s = __fadd_rn(s, __fmul_rn(wr[q], x[static_cast<size_t>(ir[q]) * g + gene]));
                }
                u[row * g + gene] = s;
            } else {
                const float xi = x[row * g + gene];
                for (int q = 0; q < k; ++q) {
                    const float xj = x[static_cast<size_t>(ir[q]) * g + gene];
                    float t;
                    if (mode == 1) {
                        t = __fmul_rn(__fmul_rn(wr[q], xi), xj);
                    } else {
                        const float d = __fsub_rn(xi, xj);
                        t = __fmul_rn(wr[q], __fmul_rn(d, d));
                    }
                    acc += static_cast<double>(t);
                }
            }
        }
    }
    if (mode == 0) return;  // uniform over the block
    red[threadIdx.y][threadIdx.x] = acc;
    __syncthreads();
    if (threadIdx.y == 0 && gene < g) {
        double s = 0.0;
        for (int t = 0; t < kRows; ++t) s += red[t][threadIdx.x];
        partial[static_cast<size_t>(blockIdx.x) * g + gene] = s;
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

}  // namespace

// rows (n_b,) int32 or null (rows 0..n_b-1); idx (n_b, k) int32 and w (n_b, k)
// float32; x (n, g) float32. Mode 0 writes u (n, g) at the bucket's rows;
// modes 1 and 2 write partial (groups, g) float64 scratch and result (g,).
SQT_EXPORT int sqt_ell_autocorr(int mode, const int32_t* rows, const int32_t* idx, const float* w, int n_b, int k,
                                const float* x, int g, int groups, float* u, double* partial, float* result,
                                void* stream) {
    if (n_b <= 0 || g <= 0 || groups <= 0 || mode < 0 || mode > 2) return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int rows_per_group = (n_b + groups - 1) / groups;
    const dim3 grid(groups, (g + kGenes - 1) / kGenes);
    ell_autocorr_kernel<<<grid, dim3(kGenes, kRows), 0, s>>>(mode, rows, idx, w, n_b, k, x, g, rows_per_group, u,
                                                             partial);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || mode == 0) return static_cast<int>(err);
    sum_partials_kernel<<<(g + 255) / 256, 256, 0, s>>>(partial, groups, g, result);
    return static_cast<int>(cudaGetLastError());
}
