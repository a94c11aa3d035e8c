// K3: exact cluster-pair edge counts for a batch of label columns.
//
// Replaces the XLA code of squidpy_tpu/ops/nhood.py `_pair_counts_cols_kernel`
// (line 123): for every row i, slot s with mask[i, s] set and column p, count
// the pair (src[i, p], table[indices[i, s], p]) into counts[p] (C x C). The
// TPU form turns this into one-hot f32 contractions on the MXU and chunks rows
// so every f32 partial stays an exact integer; here the count is a plain
// integer histogram and int32 is exact per column (at most n * k_max edges).
//
// Bound on the card: shared-memory atomics (one per counted edge and column)
// and the gather of neighbour label rows. With the column axis fastest, the
// P_blk threads that share a row read P_blk contiguous bytes of the (n, P)
// label table, so each neighbour gather is one or two 32-byte sectors.
//
// Design: one block per (row block, column block) keeps a (P_blk, C, C) int32
// histogram in shared memory, so the atomics of different columns never
// collide, and flushes its non-zero bins to the global (P, C, C) output with
// one atomicAdd each. When a single column's C x C histogram does not fit in
// the shared-memory budget (large C), the kernel adds straight into the
// global output instead. Labels outside [0, C) count nothing, as the one-hot
// rows of the JAX code do.

#include "common.cuh"

namespace {

template <typename LabelT, bool kShared>
__global__ void pair_counts_kernel(const LabelT* __restrict__ src, const LabelT* __restrict__ table,
                                   const int32_t* __restrict__ indices, const bool* __restrict__ mask, int n, int k,
                                   int n_cols, int n_cls, int p_blk, int rows_per_block, int32_t* __restrict__ out) {
    extern __shared__ int32_t hist[];  // (p_blk, C, C) when kShared
    const int p0 = blockIdx.y * p_blk;
    const int pb = min(p_blk, n_cols - p0);
    const int r0 = blockIdx.x * rows_per_block;
    const int r1 = min(n, r0 + rows_per_block);
    const int cc = n_cls * n_cls;
    if (kShared) {
        for (int e = threadIdx.x; e < pb * cc; e += blockDim.x) hist[e] = 0;
        __syncthreads();
    }
    const int lane = threadIdx.x % p_blk;
    const int row_step = blockDim.x / p_blk;
    if (lane < pb) {
        const int p = p0 + lane;
        for (int i = r0 + static_cast<int>(threadIdx.x) / p_blk; i < r1; i += row_step) {
            const int a = static_cast<int>(src[static_cast<size_t>(i) * n_cols + p]);
            if (a < 0 || a >= n_cls) continue;
            for (int s = 0; s < k; ++s) {
                const size_t e = static_cast<size_t>(i) * k + s;
                if (!mask[e]) continue;
                const int j = __ldg(indices + e);
                const int b = static_cast<int>(table[static_cast<size_t>(j) * n_cols + p]);
                if (b < 0 || b >= n_cls) continue;
                if (kShared) {
                    atomicAdd(&hist[(lane * n_cls + a) * n_cls + b], 1);
                } else {
                    atomicAdd(&out[(static_cast<size_t>(p) * n_cls + a) * n_cls + b], 1);
                }
            }
        }
    }
    if (kShared) {
        __syncthreads();
        int32_t* dst = out + static_cast<size_t>(p0) * cc;
        for (int e = threadIdx.x; e < pb * cc; e += blockDim.x) {
            const int32_t v = hist[e];
            if (v) atomicAdd(dst + e, v);
        }
    }
}

template <typename LabelT>
int launch(const void* src, const void* table, const int32_t* indices, const bool* mask, int n, int k, int n_cols,
           int n_cls, int p_blk, int row_blocks, int shared, int32_t* out, cudaStream_t s) {
    const int threads = 256;
    const int rows_per_block = (n + row_blocks - 1) / row_blocks;
    const dim3 grid(row_blocks, (n_cols + p_blk - 1) / p_blk);
    const auto* sp = static_cast<const LabelT*>(src);
    const auto* tp = static_cast<const LabelT*>(table);
    if (shared) {
        const size_t smem = static_cast<size_t>(p_blk) * n_cls * n_cls * sizeof(int32_t);
        cudaError_t err = sqt_allow_smem(pair_counts_kernel<LabelT, true>, smem);
        if (err != cudaSuccess) return static_cast<int>(err);
        pair_counts_kernel<LabelT, true><<<grid, threads, smem, s>>>(sp, tp, indices, mask, n, k, n_cols, n_cls,
                                                                      p_blk, rows_per_block, out);
    } else {
        pair_counts_kernel<LabelT, false><<<grid, threads, 0, s>>>(sp, tp, indices, mask, n, k, n_cols, n_cls, p_blk,
                                                                    rows_per_block, out);
    }
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// `out` (n_cols, C, C) int32 must be zeroed by the caller. `p_blk` is a power
// of two <= 256; `label_bytes` is 1 (uint8 columns) or 4 (int32 columns).
SQT_EXPORT int sqt_pair_counts(const void* src, const void* table, int label_bytes, const int32_t* indices,
                               const bool* mask, int n, int k, int n_cols, int n_cls, int p_blk, int row_blocks,
                               int shared, int32_t* out, void* stream) {
    if (n == 0 || n_cols == 0) return 0;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (label_bytes == 1)
        return launch<uint8_t>(src, table, indices, mask, n, k, n_cols, n_cls, p_blk, row_blocks, shared, out, s);
    if (label_bytes == 4)
        return launch<int32_t>(src, table, indices, mask, n, k, n_cols, n_cls, p_blk, row_blocks, shared, out, s);
    return static_cast<int>(cudaErrorInvalidValue);
}
