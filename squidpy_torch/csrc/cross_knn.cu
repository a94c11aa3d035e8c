// K8: the k nearest data points of each query, for one data set or a batch of them.
//
// Replaces squidpy_tpu/ops/knn.py `_cross_knn_device` (line 364) and
// squidpy_tpu/ops/ripley.py `_batched_nn_device` (line 121): XLA code that
// computes an expanded-form d2 block (MXU matmul) a query tile, selects with
// `top_k` or `argmin`, then recomputes the winners' exact distances. Here,
// for queries (m, d) float32 and S data sets (n, d) float32, it writes each
// query's k nearest points of each set, ascending: distances (S, m, k)
// float32 and indices (S, m, k) int32. Points are ranked by the
// difference-form d2 in axis order, d2 = (q_0 - x_0)^2, then d2 +=
// (q_a - x_a)^2, each operation rounded on its own (__fsub_rn, __fmul_rn,
// __fadd_rn, --fmad=false), ties going to the lowest index: the key of a
// point is (bits of d2) << 32 | index, a NaN d2 taking the bits 0x7fc00000,
// after +inf. A distance is sqrtf(d2), correctly rounded (no fast math).
// The plain torch version selects by the same keys, so both agree bit for
// bit.
//
// Bound on the card: operations. Each of the S m n (query, point) pairs
// takes 3d - 1 flops and a compare: Ripley's G mode on the main path
// (1M cells in 16 clusters) evaluates ~9e11 pairs, ~13 ms at 67 TFLOP/s,
// against (m + S n) d * 4 bytes of input.
//
// Design: brute force. One thread a query, 128 queries a block, the grid
// over (query blocks, sets). A block stages its set's points in shared
// memory, 1024 at a time (fewer for a wide runtime `dim`), and every thread
// reads each staged point as a broadcast. The k best keys sit in registers,
// sorted, in a list of the next power of two at most 32 (KC >= k): a key
// below the list's last enters by a branch-free sorted insertion, and the
// first k of the best KC are the best k. A k above 32 keeps its list in a
// global scratch row a query (the slower branch: a binary search, then a
// shift). 3D and 2D queries sit in registers; a runtime `dim` reads them
// through the cache.

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kStagePoints = 1024;
constexpr unsigned kNanBits = 0x7fc00000u;

__device__ __forceinline__ unsigned long long make_key(float d2, long long j) {
    const unsigned bits = isnan(d2) ? kNanBits : __float_as_uint(d2);
    return (static_cast<unsigned long long>(bits) << 32) | static_cast<unsigned long long>(j);
}

// KC > 0: a sorted register list of KC keys; KC = 0: `k` keys a query in `scratch`.
// D = 0: the dimension is the runtime `dim`.
template <int D, int KC>
__global__ void __launch_bounds__(kThreads) cross_knn_kernel(
    const float* __restrict__ queries, int m, const float* __restrict__ data, int n, int dim, int k, int stage,
    int q_blocks, unsigned long long* __restrict__ scratch, float* __restrict__ out_d, int* __restrict__ out_i) {
    const int d = D ? D : dim;
    extern __shared__ __align__(16) float tile[];  // (stage, d)
    const int qb = blockIdx.x % q_blocks;
    const int set = blockIdx.x / q_blocks;
    const int q = qb * kThreads + threadIdx.x;
    const bool valid = q < m;
    const float* qp = queries + static_cast<size_t>(valid ? q : 0) * d;
    const float* base = data + static_cast<size_t>(set) * n * d;
    float xq[D ? D : 1];
#pragma unroll
    for (int a = 0; a < (D ? D : 1); ++a) xq[a] = D ? qp[a] : 0.f;
    unsigned long long best[KC ? KC : 1];
#pragma unroll
    for (int r = 0; r < (KC ? KC : 1); ++r) best[r] = ~0ULL;
    unsigned long long* list = KC ? nullptr : scratch + (static_cast<size_t>(set) * m + (valid ? q : 0)) * k;
    unsigned long long worst = ~0ULL;  // the list's last key (KC = 0)

    for (int t0 = 0; t0 < n; t0 += stage) {
        const int cnt = n - t0 < stage ? n - t0 : stage;
        __syncthreads();  // every thread is done with the last staged points
        for (int e = threadIdx.x; e < cnt * d; e += kThreads) tile[e] = base[static_cast<size_t>(t0) * d + e];
        __syncthreads();
        if (!valid) continue;
        for (int j = 0; j < cnt; ++j) {
            const float* x = tile + j * d;
            float diff = __fsub_rn(D ? xq[0] : __ldg(qp), x[0]);
            float d2 = __fmul_rn(diff, diff);
            if (D) {
#pragma unroll
                for (int a = 1; a < (D ? D : 1); ++a) {
                    diff = __fsub_rn(xq[a], x[a]);
                    d2 = __fadd_rn(d2, __fmul_rn(diff, diff));
                }
            } else {
                for (int a = 1; a < d; ++a) {
                    diff = __fsub_rn(__ldg(qp + a), x[a]);
                    d2 = __fadd_rn(d2, __fmul_rn(diff, diff));
                }
            }
            const unsigned long long key = make_key(d2, t0 + j);
            if (KC) {
                if (key < best[(KC ? KC : 1) - 1]) {
                    // new[r] = max(old[r - 1], min(old[r], key)): the sorted list with key in, its last out
#pragma unroll
                    for (int r = (KC ? KC : 1) - 1; r > 0; --r) {
                        const unsigned long long lo = best[r] < key ? best[r] : key;
                        best[r] = best[r - 1] > lo ? best[r - 1] : lo;
                    }
                    best[0] = best[0] < key ? best[0] : key;
                }
            } else if (key < worst) {
                int lo = 0, hi = k - 1;  // the first slot whose key is above `key`
                while (lo < hi) {
                    const int mid = (lo + hi) >> 1;
                    if (list[mid] < key) lo = mid + 1; else hi = mid;
                }
                for (int r = k - 1; r > lo; --r) list[r] = list[r - 1];
                list[lo] = key;
                worst = list[k - 1];
            }
        }
    }
    if (!valid) return;
    const size_t o = (static_cast<size_t>(set) * m + q) * k;
    if (KC) {
#pragma unroll
        for (int r = 0; r < (KC ? KC : 1); ++r) {
            if (r < k) {
                out_d[o + r] = sqrtf(__uint_as_float(static_cast<unsigned>(best[r] >> 32)));
                out_i[o + r] = static_cast<int>(best[r] & 0xffffffffULL);
            }
        }
    } else {
        for (int r = 0; r < k; ++r) {
            const unsigned long long key = list[r];
            out_d[o + r] = sqrtf(__uint_as_float(static_cast<unsigned>(key >> 32)));
            out_i[o + r] = static_cast<int>(key & 0xffffffffULL);
        }
    }
}

template <int D, int KC>
cudaError_t launch(const float* queries, int m, const float* data, int n_sets, int n, int dim, int k,
                   unsigned long long* scratch, float* out_d, int* out_i, cudaStream_t s) {
    int stage = kStagePoints;
    while (stage > 1 && static_cast<size_t>(stage) * dim * 4 > 48 * 1024) stage >>= 1;
    if (static_cast<size_t>(stage) * dim * 4 > 48 * 1024) return cudaErrorInvalidValue;
    const size_t smem = static_cast<size_t>(stage) * dim * 4;
    const int q_blocks = (m + kThreads - 1) / kThreads;
    const long long blocks = static_cast<long long>(q_blocks) * n_sets;
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
    cross_knn_kernel<D, KC><<<static_cast<unsigned>(blocks), kThreads, smem, s>>>(
        queries, m, data, n, dim, k, stage, q_blocks, scratch, out_d, out_i);
    return cudaGetLastError();
}

template <int D>
cudaError_t launch_k(const float* queries, int m, const float* data, int n_sets, int n, int dim, int k,
                     unsigned long long* scratch, float* out_d, int* out_i, cudaStream_t s) {
    if (k <= 1) return launch<D, 1>(queries, m, data, n_sets, n, dim, k, scratch, out_d, out_i, s);
    if (k <= 2) return launch<D, 2>(queries, m, data, n_sets, n, dim, k, scratch, out_d, out_i, s);
    if (k <= 4) return launch<D, 4>(queries, m, data, n_sets, n, dim, k, scratch, out_d, out_i, s);
    if (k <= 8) return launch<D, 8>(queries, m, data, n_sets, n, dim, k, scratch, out_d, out_i, s);
    if (k <= 16) return launch<D, 16>(queries, m, data, n_sets, n, dim, k, scratch, out_d, out_i, s);
    if (k <= 32) return launch<D, 32>(queries, m, data, n_sets, n, dim, k, scratch, out_d, out_i, s);
    return launch<D, 0>(queries, m, data, n_sets, n, dim, k, scratch, out_d, out_i, s);
}

}  // namespace

// queries (m, dim) float32; data (n_sets, n, dim) float32; 1 <= k <= n;
// scratch (n_sets, m, k) uint64 filled with all ones when k > 32, else unused;
// out_d (n_sets, m, k) float32 and out_i (n_sets, m, k) int32.
SQT_EXPORT int sqt_cross_knn(const float* queries, int m, const float* data, int n_sets, int n, int dim, int k,
                             long long* scratch, float* out_d, int* out_i, void* stream) {
    if (m <= 0 || n_sets <= 0 || n <= 0 || dim <= 0 || k <= 0 || k > n || (k > 32 && scratch == nullptr)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    auto* sc = reinterpret_cast<unsigned long long*>(scratch);
    if (dim == 2) return static_cast<int>(launch_k<2>(queries, m, data, n_sets, n, dim, k, sc, out_d, out_i, s));
    if (dim == 3) return static_cast<int>(launch_k<3>(queries, m, data, n_sets, n, dim, k, sc, out_d, out_i, s));
    return static_cast<int>(launch_k<0>(queries, m, data, n_sets, n, dim, k, sc, out_d, out_i, s));
}
