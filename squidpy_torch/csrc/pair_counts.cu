// K3: exact cluster-pair edge counts for a batch of label columns.
//
// Replaces the XLA code of squidpy_tpu/ops/nhood.py `_pair_counts_cols_kernel`
// (line 123): for every row i, slot s with mask[i, s] set and column p, count
// the pair (src[i, p], table[indices[i, s], p]) into counts[p] (C x C). The
// TPU form turns this into one-hot f32 contractions on the MXU and chunks rows
// so every f32 partial stays an exact integer; here the count is a plain
// integer histogram and int32 is exact per column (at most n * k_max edges).
// Labels outside [0, C) count nothing, as the one-hot rows of the JAX code do.
//
// Bound on the card: the gathers of neighbour label rows (one per stored edge
// and column block, from an (n, P) table far larger than the L2) and the
// shared-memory adds, one per stored edge and column. On an H100 at the main
// path's shape (1M rows, k_max 8 with 6 stored, P = 500, C = 16), a kernel
// that walks each row's slots as a serial chain mask -> index -> gather takes
// ~19 ms whether it counts or only sums the labels in a register: the chain
// is the time. With the gathers of a row issued together and 128-byte rows a
// warp, the same shape takes ~3.4 ms, ~2.2 of it without the adds.
//
// Design: every branch loads a row's k_max indices and mask bytes first, then
// issues all of its gathers, then counts. The branches (chosen by
// `_k3_layout` in ops/nhood.py from the shapes alone):
// - packed (C <= 16, P >= 32): a lane counts 4 columns from one 4-byte (uint8)
//   or 16-byte (int32) gather, so a warp reads a full 128-byte line per edge.
//   A block of 512 threads keeps one (128 columns x 256 bins) histogram of
//   uint16 counters packed two to a word, bin-major and lane-minor, so a
//   warp's shared atomics hit 32 distinct banks whatever the labels. 64 KB
//   lets 3 blocks (48 warps) share an SM. A block counts at most
//   65,535 / k_max rows, so no counter passes 65,535, and flushes once, with
//   coalesced global atomics (bins of a column contiguous). The grid has
//   whole waves of resident blocks, with row blocks fastest.
// - shared: one block per (row block, P_blk columns) keeps a (P_blk, C, C)
//   int32 histogram in shared memory and flushes its non-zero bins.
// - global: when one column's C x C int32 histogram does not fit the
//   shared-memory budget, every count is a global atomic.

#include "common.cuh"

namespace {

constexpr int kPackedThreads = 512;
constexpr int kPackedWords = 128 * 4 * 32;  // 256 bins / 2 a word, x 4 columns, x 32 lanes
constexpr size_t kPackedSmem = kPackedWords * sizeof(uint32_t);

// The labels of 4 columns p..p+3 of one row as loaded: uint8 labels packed in
// one word (byte c is column p + c), int32 labels in four. All-ones, past the
// last column or for a masked slot, counts nothing (C <= 16). Keeping uint8
// labels packed until they are counted holds a row's 8 gathers in 8 registers.
template <typename LabelT>
struct Four;

template <>
struct Four<uint8_t> {
    uint32_t w = 0xFFFFFFFFu;
    __device__ __forceinline__ uint32_t get(int c) const { return (w >> (8 * c)) & 0xFFu; }
};

template <>
struct Four<int32_t> {
    uint4 w = make_uint4(0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu);
    __device__ __forceinline__ uint32_t get(int c) const { return c == 0 ? w.x : c == 1 ? w.y : c == 2 ? w.z : w.w; }
};

// Aligned: one 4- or 16-byte load (n_cols % 4 == 0 and an aligned table).
template <typename LabelT, bool kAligned>
__device__ __forceinline__ Four<LabelT> load4(const LabelT* __restrict__ row, int p, int n_cols) {
    Four<LabelT> f;
    if constexpr (sizeof(LabelT) == 1) {
        if constexpr (kAligned) {
            f.w = __ldg(reinterpret_cast<const unsigned int*>(row + p));
        } else {
#pragma unroll
            for (int c = 0; c < 4; ++c)
                if (p + c < n_cols)
                    f.w = (f.w & ~(0xFFu << (8 * c))) | (static_cast<uint32_t>(__ldg(row + p + c)) << (8 * c));
        }
    } else {
        if constexpr (kAligned) {
            const int4 v = __ldg(reinterpret_cast<const int4*>(row + p));
            f.w = make_uint4(v.x, v.y, v.z, v.w);
        } else {
            uint32_t t[4];
#pragma unroll
            for (int c = 0; c < 4; ++c) t[c] = p + c < n_cols ? static_cast<uint32_t>(__ldg(row + p + c)) : 0xFFFFFFFFu;
            f.w = make_uint4(t[0], t[1], t[2], t[3]);
        }
    }
    return f;
}

// Indices and mask of the slots s0..s0+7 of row i (mask false past k).
__device__ __forceinline__ void load_slots(const int32_t* __restrict__ indices, const uint8_t* __restrict__ mask,
                                           int i, int k, int s0, int (&idx)[8], bool (&m)[8]) {
#pragma unroll
    for (int s = 0; s < 8; ++s) {
        const bool in = s0 + s < k;
        const size_t e = static_cast<size_t>(i) * k + s0 + s;
        idx[s] = in ? __ldg(indices + e) : 0;
        m[s] = in && __ldg(mask + e);
    }
}

// kCount false: the adds become a register sum (a diagnostic: the gathers
// and the loop without the histogram; the output is not the counts).
template <typename LabelT, bool kAligned, bool kCount>
__global__ void __launch_bounds__(kPackedThreads, 3) packed_kernel(
    const LabelT* __restrict__ src, const LabelT* __restrict__ table, const int32_t* __restrict__ indices,
    const uint8_t* __restrict__ mask, int n, int k, int n_cols, int n_cls, int rows_per_block, int row_blocks,
    int32_t* __restrict__ out) {
    extern __shared__ uint32_t hist[];  // word ((bin >> 1) * 4 + c) * 32 + lane; bin = a * 16 + b
    for (int e = threadIdx.x; e < kPackedWords; e += kPackedThreads) hist[e] = 0;
    __syncthreads();
    const int rb = blockIdx.x % row_blocks, g = blockIdx.x / row_blocks;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int p = g * 128 + lane * 4;
    const bool col_ok = p < n_cols;
    const int r0 = rb * rows_per_block;
    const int r1 = min(n, r0 + rows_per_block);
    uint32_t* mine = hist + lane;
    uint32_t acc = 0;
    for (int i = r0 + warp; i < r1; i += kPackedThreads / 32) {
        Four<LabelT> a;
        if (col_ok) a = load4<LabelT, kAligned>(src + static_cast<size_t>(i) * n_cols, p, n_cols);
        for (int s0 = 0; s0 < k; s0 += 8) {
            int idx[8];
            bool m[8];
            load_slots(indices, mask, i, k, s0, idx, m);
            Four<LabelT> lab[8];
#pragma unroll
            for (int s = 0; s < 8; ++s)
                if (m[s] && col_ok)
                    lab[s] = load4<LabelT, kAligned>(table + static_cast<size_t>(idx[s]) * n_cols, p, n_cols);
#pragma unroll
            for (int s = 0; s < 8; ++s)
#pragma unroll
                for (int c = 0; c < 4; ++c) {
                    const uint32_t av = a.get(c), b = lab[s].get(c);
                    if (av < static_cast<uint32_t>(n_cls) && b < static_cast<uint32_t>(n_cls)) {
                        const uint32_t bin = av * 16 + b;
                        if (kCount) atomicAdd(mine + ((bin >> 1) * 4 + c) * 32, 1u << ((bin & 1) << 4));
                        else acc += bin;
                    }
                }
        }
    }
    if (!kCount && acc == 0xFFFFFFFFu) out[0] = 0;  // keeps the register sum alive
    __syncthreads();
    // bins of a column fastest, so a warp's global atomics are contiguous
    for (int e = threadIdx.x; e < 128 * 256; e += kPackedThreads) {
        const int bin = e & 255, cl = e >> 8;
        const int pp = g * 128 + cl;
        const int av = bin >> 4, b = bin & 15;
        if (pp >= n_cols || av >= n_cls || b >= n_cls) continue;
        const uint32_t v = (hist[((bin >> 1) * 4 + (cl & 3)) * 32 + (cl >> 2)] >> ((bin & 1) << 4)) & 0xFFFFu;
        if (v) atomicAdd(out + (static_cast<size_t>(pp) * n_cls + av) * n_cls + b, static_cast<int>(v));
    }
}

template <typename LabelT, bool kShared>
__global__ void shared_kernel(const LabelT* __restrict__ src, const LabelT* __restrict__ table,
                              const int32_t* __restrict__ indices, const uint8_t* __restrict__ mask, int n, int k,
                              int n_cols, int n_cls, int p_blk, int rows_per_block, int32_t* __restrict__ out) {
    extern __shared__ int32_t shist[];  // (p_blk, C, C) when kShared
    const int p0 = blockIdx.y * p_blk;
    const int pb = min(p_blk, n_cols - p0);
    const int r0 = blockIdx.x * rows_per_block;
    const int r1 = min(n, r0 + rows_per_block);
    const int cc = n_cls * n_cls;
    if (kShared) {
        for (int e = threadIdx.x; e < pb * cc; e += blockDim.x) shist[e] = 0;
        __syncthreads();
    }
    const int lane = threadIdx.x % p_blk;
    const bool col_ok = lane < pb;
    const int p = p0 + lane;
    for (int i = r0 + static_cast<int>(threadIdx.x) / p_blk; i < r1; i += blockDim.x / p_blk) {
        const int a = col_ok ? static_cast<int>(__ldg(src + static_cast<size_t>(i) * n_cols + p)) : -1;
        for (int s0 = 0; s0 < k; s0 += 8) {
            int idx[8];
            bool m[8];
            load_slots(indices, mask, i, k, s0, idx, m);
            int lab[8];
#pragma unroll
            for (int s = 0; s < 8; ++s)
                lab[s] = (m[s] && col_ok) ? static_cast<int>(__ldg(table + static_cast<size_t>(idx[s]) * n_cols + p))
                                          : -1;
#pragma unroll
            for (int s = 0; s < 8; ++s) {
                const int b = lab[s];
                if (static_cast<unsigned>(a) >= static_cast<unsigned>(n_cls) ||
                    static_cast<unsigned>(b) >= static_cast<unsigned>(n_cls))
                    continue;
                if (kShared) atomicAdd(&shist[(lane * n_cls + a) * n_cls + b], 1);
                else atomicAdd(&out[(static_cast<size_t>(p) * n_cls + a) * n_cls + b], 1);
            }
        }
    }
    if (kShared) {
        __syncthreads();
        int32_t* dst = out + static_cast<size_t>(p0) * cc;
        for (int e = threadIdx.x; e < pb * cc; e += blockDim.x) {
            const int32_t v = shist[e];
            if (v) atomicAdd(dst + e, v);
        }
    }
}

template <typename LabelT, bool kAligned, bool kCount>
int launch_packed(const void* src, const void* table, const int32_t* indices, const uint8_t* mask, int n, int k,
                  int n_cols, int n_cls, int row_blocks, int rows_per_block, int32_t* out, cudaStream_t s) {
    auto kernel = packed_kernel<LabelT, kAligned, kCount>;
    cudaError_t err = sqt_allow_smem(kernel, kPackedSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long blocks = static_cast<long long>(row_blocks) * ((n_cols + 127) / 128);
    if (blocks > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidConfiguration);
    kernel<<<static_cast<unsigned>(blocks), kPackedThreads, kPackedSmem, s>>>(
        static_cast<const LabelT*>(src), static_cast<const LabelT*>(table), indices, mask, n, k, n_cols, n_cls,
        rows_per_block, row_blocks, out);
    return static_cast<int>(cudaGetLastError());
}

template <typename LabelT>
int launch(const void* src, const void* table, const int32_t* indices, const uint8_t* mask, int n, int k, int n_cols,
           int n_cls, int branch, int p_blk, int row_blocks, int rows_per_block, int count, int32_t* out,
           cudaStream_t s) {
    if (branch == 0) {
        const uintptr_t align = sizeof(LabelT) == 1 ? 4 : 16;
        const bool aligned = n_cols % 4 == 0 && reinterpret_cast<uintptr_t>(src) % align == 0 &&
                             reinterpret_cast<uintptr_t>(table) % align == 0;
        if (aligned && count)
            return launch_packed<LabelT, true, true>(src, table, indices, mask, n, k, n_cols, n_cls, row_blocks,
                                                     rows_per_block, out, s);
        if (aligned)
            return launch_packed<LabelT, true, false>(src, table, indices, mask, n, k, n_cols, n_cls, row_blocks,
                                                      rows_per_block, out, s);
        if (count)
            return launch_packed<LabelT, false, true>(src, table, indices, mask, n, k, n_cols, n_cls, row_blocks,
                                                      rows_per_block, out, s);
        return launch_packed<LabelT, false, false>(src, table, indices, mask, n, k, n_cols, n_cls, row_blocks,
                                                   rows_per_block, out, s);
    }
    if (!count) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid(row_blocks, (n_cols + p_blk - 1) / p_blk);
    const auto* sp = static_cast<const LabelT*>(src);
    const auto* tp = static_cast<const LabelT*>(table);
    if (branch == 1) {
        const size_t smem = static_cast<size_t>(p_blk) * n_cls * n_cls * sizeof(int32_t);
        cudaError_t err = sqt_allow_smem(shared_kernel<LabelT, true>, smem);
        if (err != cudaSuccess) return static_cast<int>(err);
        shared_kernel<LabelT, true><<<grid, 256, smem, s>>>(sp, tp, indices, mask, n, k, n_cols, n_cls, p_blk,
                                                            rows_per_block, out);
    } else if (branch == 2) {
        shared_kernel<LabelT, false><<<grid, 256, 0, s>>>(sp, tp, indices, mask, n, k, n_cols, n_cls, p_blk,
                                                          rows_per_block, out);
    } else {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// `out` (n_cols, C, C) int32 must be zeroed by the caller. `branch` 0 packed
// (C <= 16; 128 columns a block), 1 shared, 2 global atomics (`p_blk` columns
// a block, a power of two <= 256). `label_bytes` is 1 (uint8 columns) or 4
// (int32). `count` 0 replaces the packed branch's adds with a register sum.
SQT_EXPORT int sqt_pair_counts(const void* src, const void* table, int label_bytes, const int32_t* indices,
                               const bool* mask, int n, int k, int n_cols, int n_cls, int branch, int p_blk,
                               int row_blocks, int rows_per_block, int count, int32_t* out, void* stream) {
    if (n == 0 || n_cols == 0) return 0;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const auto* m = reinterpret_cast<const uint8_t*>(mask);
    if (label_bytes == 1)
        return launch<uint8_t>(src, table, indices, m, n, k, n_cols, n_cls, branch, p_blk, row_blocks,
                               rows_per_block, count, out, s);
    if (label_bytes == 4)
        return launch<int32_t>(src, table, indices, m, n, k, n_cols, n_cls, branch, p_blk, row_blocks,
                               rows_per_block, count, out, s);
    return static_cast<int>(cudaErrorInvalidValue);
}

// Blocks of the packed branch (aligned uint8 or int32 labels, counting) that
// one SM keeps resident, registers and shared memory included.
SQT_EXPORT int sqt_pair_counts_resident(int label_bytes, int* per_sm) {
    cudaError_t err;
    if (label_bytes == 1) {
        err = sqt_allow_smem(packed_kernel<uint8_t, true, true>, kPackedSmem);
        if (err == cudaSuccess)
            err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, packed_kernel<uint8_t, true, true>,
                                                                kPackedThreads, kPackedSmem);
    } else {
        err = sqt_allow_smem(packed_kernel<int32_t, true, true>, kPackedSmem);
        if (err == cudaSuccess)
            err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, packed_kernel<int32_t, true, true>,
                                                                kPackedThreads, kPackedSmem);
    }
    return static_cast<int>(err);
}
