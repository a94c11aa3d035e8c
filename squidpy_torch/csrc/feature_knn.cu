// K12: the exact k nearest other rows of a feature matrix.
//
// Replaces squidpy_tpu/ops/knn.py `_knn_device` (line 259) and
// `_knn_device_chunk` (line 92), the exact search behind `brute_force_knn`
// that squidpy_tpu/models/clustering.py `knn_graph` runs on the niche
// features (a z-scored neighbourhood profile of C categories, or a PCA
// embedding of 50 components, up to 200,000 rows): XLA code that ranks row
// tiles by the expanded-form d2 |a|^2 + |b|^2 - 2ab (an MXU product), keeps
// a running `top_k` over column tiles, then recomputes the winners' exact
// distances. Here, for X (n, dp) float32 (the d features padded with zero
// columns to dp; a zero column adds exactly +0 to every d2, so padding
// changes no d2 and no neighbour), it writes each row's k nearest other
// rows, ascending: distances (n, k) float32 and indices (n, k) int32. Rows
// are ranked by the difference-form d2 in axis order, d2 = 0 + (a_0 -
// b_0)^2, then d2 += (a_e - b_e)^2, each operation rounded on its own
// (__fsub_rn, __fmul_rn, __fadd_rn, --fmad=false), ties going to the lowest
// index: the key of row j is (bits of d2) << 32 | j, a NaN d2 taking the
// bits 0x7fc00000, after +inf. The row itself is excluded by index, so
// duplicate rows find each other. A distance is sqrtf(d2), correctly
// rounded; keys ascend, so the distances do too, which is the JAX
// package's final stable sort by distance. The plain torch version in
// squidpy_torch/ops/knn.py selects by the same keys, so both agree bit for
// bit. The JAX package ranks by the expanded form, whose error (a few ulps
// of max |x|^2 times d) can swap rows whose d2 lie closer than that at the
// k-th neighbour; the niche graph takes only the neighbour sets.
//
// Bound on the card: operations, 3 d n^2 (a subtraction, a multiply and an
// add a feature a pair) at 67e12/s: ~29 ms at 200,000 x 16, ~90 ms at
// 200,000 x 50. The input, n d floats, is read once from device memory;
// each block re-reads it from the L2.
//
// Design: one thread a query row, 128 a block, its row's features in
// registers when dp <= 64 (dp a multiple of 8). The block stages the rows
// in tiles of 32 KB in shared memory, in index order, and every thread
// reads each staged row as a broadcast (float4 loads); so a thread meets
// the rows in ascending index and a key enters its list only when its d2
// is below the list's last. The k best keys sit in registers, sorted, in a
// list of the next power of two at most 32 (KC >= k; the first k of the
// best KC are the best k), by a branch-free sorted insertion; a k above
// 32 keeps its list in a global scratch row a query (a binary search, then
// a shift), as K8 (csrc/cross_knn.cu) does. Above 64 features (dp a
// multiple of 32) a thread sums 32 staged rows at once, 32 of its features
// at a time read from the cache, each row's d2 carried across the chunks
// in axis order. Tensor cores would change the ranking's rounding; they
// are left for later.

#include <cmath>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kStageBytes = 32 * 1024;
constexpr int kGroup = 32;  // rows a thread sums at once above 64 features
constexpr int kChunk = 32;  // features a thread holds at once above 64 features
constexpr unsigned kNanBits = 0x7fc00000u;

__device__ __forceinline__ unsigned long long make_key(float d2, int j) {
    const unsigned bits = isnan(d2) ? kNanBits : __float_as_uint(d2);
    return (static_cast<unsigned long long>(bits) << 32) | static_cast<unsigned>(j);
}

// KC > 0: a sorted register list of KC keys; KC = 0: `k` keys in a global scratch row.
template <int KC>
struct TopK {
    unsigned long long best[KC ? KC : 1];
    unsigned long long* list;
    int k;
    unsigned long long worst;  // the list's last key (KC = 0)

    __device__ __forceinline__ void init(unsigned long long* row, int k_) {
#pragma unroll
        for (int r = 0; r < (KC ? KC : 1); ++r) best[r] = ~0ULL;
        list = KC ? nullptr : row;
        k = k_;
        worst = ~0ULL;
    }

    __device__ __forceinline__ void insert(unsigned long long key) {
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

    __device__ __forceinline__ void write(float* out_d, int* out_i, size_t o) const {
        for (int r = 0; r < k; ++r) {
            unsigned long long key = list ? list[r] : 0ULL;
            if (KC) {
#pragma unroll
                for (int s = 0; s < (KC ? KC : 1); ++s)
                    if (s == r) key = best[s];
            }
            out_d[o + r] = sqrtf(__uint_as_float(static_cast<unsigned>(key >> 32)));
            out_i[o + r] = static_cast<int>(key & 0xffffffffULL);
        }
    }
};

__device__ __forceinline__ float add_sq(float d2, float a, float b) {
    const float diff = __fsub_rn(a, b);
    return __fadd_rn(d2, __fmul_rn(diff, diff));
}

// dp = DP <= 64: the query row's features in registers.
template <int DP, int KC>
__global__ void __launch_bounds__(kThreads) knn_regs_kernel(const float* __restrict__ x, int n, int k, int stage,
                                                            unsigned long long* __restrict__ scratch,
                                                            float* __restrict__ out_d, int* __restrict__ out_i) {
    extern __shared__ float4 tile[];  // (stage, DP / 4)
    constexpr int kV = DP / 4;
    const int q = blockIdx.x * kThreads + threadIdx.x;
    const bool valid = q < n;
    const float4* x4 = reinterpret_cast<const float4*>(x);
    float xq[DP];
#pragma unroll
    for (int e = 0; e < kV; ++e) {
        const float4 v = valid ? __ldg(x4 + static_cast<size_t>(q) * kV + e) : make_float4(0.f, 0.f, 0.f, 0.f);
        xq[4 * e] = v.x;
        xq[4 * e + 1] = v.y;
        xq[4 * e + 2] = v.z;
        xq[4 * e + 3] = v.w;
    }
    TopK<KC> top;
    top.init(scratch + static_cast<size_t>(valid ? q : 0) * k, k);
    for (int t0 = 0; t0 < n; t0 += stage) {
        const int cnt = n - t0 < stage ? n - t0 : stage;
        __syncthreads();  // every thread is done with the last tile
        for (int e = threadIdx.x; e < cnt * kV; e += kThreads) tile[e] = __ldg(x4 + static_cast<size_t>(t0) * kV + e);
        __syncthreads();
        if (!valid) continue;
        for (int p = 0; p < cnt; ++p) {
            float d2 = 0.0f;
#pragma unroll
            for (int e = 0; e < kV; ++e) {
                const float4 v = tile[p * kV + e];
                d2 = add_sq(d2, xq[4 * e], v.x);
                d2 = add_sq(d2, xq[4 * e + 1], v.y);
                d2 = add_sq(d2, xq[4 * e + 2], v.z);
                d2 = add_sq(d2, xq[4 * e + 3], v.w);
            }
            const int j = t0 + p;
            if (j != q) top.insert(make_key(d2, j));
        }
    }
    if (valid) top.write(out_d, out_i, static_cast<size_t>(q) * k);
}

// dp a multiple of kChunk above 64: kGroup staged rows summed at once, the
// query's features kChunk at a time; `stage` a multiple of kGroup, and the
// tile's rows past the last real one are zeros (their keys are dropped).
template <int KC>
__global__ void __launch_bounds__(kThreads) knn_chunked_kernel(const float* __restrict__ x, int n, int dp, int k,
                                                               int stage, unsigned long long* __restrict__ scratch,
                                                               float* __restrict__ out_d, int* __restrict__ out_i) {
    extern __shared__ float4 tile[];  // (stage, dp / 4)
    const int kV = dp / 4;
    const int q = blockIdx.x * kThreads + threadIdx.x;
    const bool valid = q < n;
    const float4* x4 = reinterpret_cast<const float4*>(x);
    const float4* xrow = x4 + static_cast<size_t>(valid ? q : 0) * kV;
    TopK<KC> top;
    top.init(scratch + static_cast<size_t>(valid ? q : 0) * k, k);
    for (int t0 = 0; t0 < n; t0 += stage) {
        const int cnt = n - t0 < stage ? n - t0 : stage;
        const int staged = (cnt + kGroup - 1) / kGroup * kGroup;
        __syncthreads();
        for (int e = threadIdx.x; e < staged * kV; e += kThreads)
            tile[e] = e < cnt * kV ? __ldg(x4 + static_cast<size_t>(t0) * kV + e) : make_float4(0.f, 0.f, 0.f, 0.f);
        __syncthreads();
        if (!valid) continue;
        for (int g0 = 0; g0 < cnt; g0 += kGroup) {
            float acc[kGroup];
#pragma unroll
            for (int p = 0; p < kGroup; ++p) acc[p] = 0.0f;
            for (int c = 0; c < kV; c += kChunk / 4) {
                float xq[kChunk];
#pragma unroll
                for (int e = 0; e < kChunk / 4; ++e) {
                    const float4 v = __ldg(xrow + c + e);
                    xq[4 * e] = v.x;
                    xq[4 * e + 1] = v.y;
                    xq[4 * e + 2] = v.z;
                    xq[4 * e + 3] = v.w;
                }
#pragma unroll
                for (int p = 0; p < kGroup; ++p) {
#pragma unroll
                    for (int e = 0; e < kChunk / 4; ++e) {
                        const float4 v = tile[(g0 + p) * kV + c + e];
                        acc[p] = add_sq(acc[p], xq[4 * e], v.x);
                        acc[p] = add_sq(acc[p], xq[4 * e + 1], v.y);
                        acc[p] = add_sq(acc[p], xq[4 * e + 2], v.z);
                        acc[p] = add_sq(acc[p], xq[4 * e + 3], v.w);
                    }
                }
            }
#pragma unroll
            for (int p = 0; p < kGroup; ++p) {
                const int j = t0 + g0 + p;
                if (g0 + p < cnt && j != q) top.insert(make_key(acc[p], j));
            }
        }
    }
    if (valid) top.write(out_d, out_i, static_cast<size_t>(q) * k);
}

template <int DP, int KC>
cudaError_t launch_regs(const float* x, int n, int k, unsigned long long* scratch, float* out_d, int* out_i,
                        cudaStream_t s) {
    const int stage = kStageBytes / (4 * DP);
    const size_t smem = static_cast<size_t>(stage) * DP * 4;
    const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
    knn_regs_kernel<DP, KC><<<blocks, kThreads, smem, s>>>(x, n, k, stage, scratch, out_d, out_i);
    return cudaGetLastError();
}

template <int KC>
cudaError_t launch_k(const float* x, int n, int dp, int k, unsigned long long* scratch, float* out_d, int* out_i,
                     cudaStream_t s) {
    switch (dp) {
        case 8: return launch_regs<8, KC>(x, n, k, scratch, out_d, out_i, s);
        case 16: return launch_regs<16, KC>(x, n, k, scratch, out_d, out_i, s);
        case 24: return launch_regs<24, KC>(x, n, k, scratch, out_d, out_i, s);
        case 32: return launch_regs<32, KC>(x, n, k, scratch, out_d, out_i, s);
        case 40: return launch_regs<40, KC>(x, n, k, scratch, out_d, out_i, s);
        case 48: return launch_regs<48, KC>(x, n, k, scratch, out_d, out_i, s);
        case 56: return launch_regs<56, KC>(x, n, k, scratch, out_d, out_i, s);
        case 64: return launch_regs<64, KC>(x, n, k, scratch, out_d, out_i, s);
        default: break;
    }
    int stage = kStageBytes / (4 * dp) / kGroup * kGroup;
    if (stage < kGroup) stage = kGroup;
    const size_t smem = static_cast<size_t>(stage) * dp * 4;
    const cudaError_t err = sqt_allow_smem(knn_chunked_kernel<KC>, smem);
    if (err != cudaSuccess) return err;
    const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
    knn_chunked_kernel<KC><<<blocks, kThreads, smem, s>>>(x, n, dp, k, stage, scratch, out_d, out_i);
    return cudaGetLastError();
}

}  // namespace

// x (n, dp) float32, dp a multiple of 8 up to 64 or of 32 above (zero
// columns pad the features); 1 <= k <= n - 1; scratch (n, k) uint64 filled
// with all ones when k > 32, else unused; out_d (n, k) float32 and out_i
// (n, k) int32.
SQT_EXPORT int sqt_feature_knn(const float* x, int n, int dp, int k, long long* scratch, float* out_d, int* out_i,
                               void* stream) {
    if (n < 2 || k < 1 || k > n - 1 || dp < 8 || (dp <= 64 && dp % 8) || (dp > 64 && dp % kChunk) ||
        (k > 32 && scratch == nullptr) || static_cast<long long>(n) * dp >= (1LL << 40)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    auto* sc = reinterpret_cast<unsigned long long*>(scratch);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err;
    if (k <= 8) err = launch_k<8>(x, n, dp, k, sc, out_d, out_i, s);
    else if (k <= 16) err = launch_k<16>(x, n, dp, k, sc, out_d, out_i, s);
    else if (k <= 32) err = launch_k<32>(x, n, dp, k, sc, out_d, out_i, s);
    else err = launch_k<0>(x, n, dp, k, sc, out_d, out_i, s);
    return static_cast<int>(err);
}
