// K14: the nearest centroids of every row, and the centroids' update, of the
// IVF kNN's k-means (squidpy_torch/ops/ivf_knn.py).
//
// Replaces squidpy_tpu/ops/ivf_knn.py `_kmeans_iterations` (line 57): its
// `assign` (line 71), XLA code that ranks every row tile against all C
// centroids by the expanded-form d2 c2 - 2 x.c (an MXU product) and takes
// `argmin`, and its `update` (line 85), a one-hot (C, tile) x (tile, d)
// product of the rows rounded to bf16; and the probe ranking of
// `_build_replicas` (line 198, `top_k` at line 223), and the centroid
// ranking of the spilled rows in `_pack_members` (`cross_knn`, line 168).
//
// The nearest entry (`sqt_ivf_nearest`): for rows x (n, dp) and centroids
// (C, dp), float32, dp a multiple of 4 (zero columns pad the features; a
// zero column adds exactly +0 to every d2), each row's m nearest
// centroids, ascending, as indices (n, m) int32, and for m = 1 the d2 too
// (n,) float32. Centroids rank by the key (bits of d2) << 32 | c, d2 the
// difference form in axis order, d2 = 0 + (x_0 - c_0)^2, then d2 += (x_e -
// c_e)^2, each operation rounded on its own (__fsub_rn, __fmul_rn,
// __fadd_rn, --fmad=false), ties going to the lowest index, a NaN d2 taking
// the bits 0x7fc00000, after +inf. The JAX package ranks by the expanded
// form, whose rounding can swap two centroids whose d2 lie within a few ulps
// of max |x|^2 of each other (ROADMAP.md queue 3).
//
// Bound on the card of the nearest entry: operations. Any route must at
// least form the products of dp features of every (row, centroid) pair (2 dp
// a pair at the dense bf16 tensor rate, the filter's operand type: 0.03 ms at
// 1M x 1024 x 16, 0.10 ms at dp = 56) and compare one key a pair, above the
// rows and centroids read once. The exact keys of every pair alone (3 dp + 1
// unfused float32 operations a pair) would take ~1.5 / ~5.2 ms at one
// instruction a lane and clock.
//
// Design of the nearest entry: two routes. The filter route (dp a multiple of 8 up to 64; the entry
// `sqt_ivf_nearest_filter`, built as csrc/ivf_kmeans_filter.cu) is the
// tensor-core filter of csrc/knn_filter.cuh, whose proof keeps the exact m
// nearest: one set, the rows the query rows (centred in registers), the
// centroids the candidate columns, both centred on the centroids' mean (of
// their finite entries). A first kernel computes the centre and the
// centroids' bf16 terms and norms in the B fragments' order; the sweep's
// block takes 128 rows and asks for each tile of centroid terms by bulk
// asynchronous copies, double-buffered against the products of the tile
// before. It sweeps the centroids twice: the bounding pass gives each row a
// proven T_i from its m least upper bounds, so the second pass's candidates
// are about the m nearest and the near ties; one thread a row then computes
// their exact keys (of every centroid when they pass its buffer: exact ties,
// an unbounded norm) into a register list, as the exact route does.
//
// The exact route (`sqt_ivf_nearest`; above 64 features; the earlier design):
// one thread a row, 128 a block, its features in registers when dp <= 64.
// The block stages the centroids in shared memory in tiles of 32 KB (1024 x
// 16 float32 is two tiles, 1024 x 56 seven), and every thread reads each
// staged centroid as a broadcast (float4 loads). The m best keys sit in
// registers, sorted, in a list of MC keys (MC = 1, 8, 16 or 32 >= m: the
// first m of the best MC are the best m), by a branch-free sorted insertion
// (`Best`, csrc/knn_keys.cuh, shared with K15; K12's lists insert alike).
// Above 64 features a thread reads its own row from the cache for every
// centroid.
//
// The update entry (`sqt_ivf_update`): each centroid's mean of its rows,
// each value rounded to bf16 (round to nearest even) and summed in float32,
// the count a float32, the result sum / count, an empty cluster keeping its
// centroid (the JAX package's `jnp.where(counts > 0, sums / max(counts, 1),
// centroids)`). The sums follow one fixed order, never that of atomics: the
// wrapper lists each cluster's rows in index order (a stable sort of the
// codes, plain torch); each cluster's list is cut into runs of 32 rows, each
// run summed left to right from +0, and the runs' sums are added by a
// pairwise tree (level s adds run i + s into run i for i a multiple of 2 s),
// the same as a full binary tree over the runs padded with zeros to a power
// of two. The plain version in squidpy_torch/ops/ivf_knn.py sums in the same
// order, so both agree bit for bit. The JAX package's product rounds each
// 65,536-row tile's sums to bf16 (its output type; ROADMAP.md queue 3).
//
// Design of the update: one thread a (run, feature) sums its run (the run's
// cluster found by a binary search of the runs' offsets), then one block a
// cluster adds its runs by the tree in place, level by level, and divides.
// Bound on the card of the update: bytes, the rows read once (4 dp n bytes:
// ~64 MB, 20 us at 1M x 16).

#include <cmath>

#include <cuda_bf16.h>

#include "common.cuh"
#include "knn_filter.cuh"
#include "knn_keys.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kStageBytes = 32 * 1024;
constexpr int kRun = 32;          // rows a run of the update
constexpr int kTreeThreads = 256;

// DP > 0: the row's DP features in registers; DP = 0: dp of them read from the cache.
template <int DP, int MC>
__global__ void __launch_bounds__(kThreads) nearest_kernel(const float* __restrict__ x, int n, int dp,
                                                           const float* __restrict__ cents, int n_cents, int m,
                                                           int stage, int* __restrict__ out_i,
                                                           float* __restrict__ out_d2) {
    extern __shared__ float4 tile[];  // (stage, dp / 4)
    const int kV = (DP ? DP : dp) / 4;
    const int q = blockIdx.x * kThreads + threadIdx.x;
    const bool valid = q < n;
    const float4* x4 = reinterpret_cast<const float4*>(x);
    const float4* c4 = reinterpret_cast<const float4*>(cents);
    const float4* xrow = x4 + static_cast<size_t>(valid ? q : 0) * kV;
    float xq[DP ? DP : 1];
    load_row<DP>(xrow, valid, xq);
    Best<MC> best;
    best.init();
    for (int t0 = 0; t0 < n_cents; t0 += stage) {
        const int cnt = n_cents - t0 < stage ? n_cents - t0 : stage;
        __syncthreads();  // every thread is done with the last tile
        for (int e = threadIdx.x; e < cnt * kV; e += kThreads) tile[e] = __ldg(c4 + static_cast<size_t>(t0) * kV + e);
        __syncthreads();
        if (!valid) continue;
        for (int p = 0; p < cnt; ++p) {
            const float d2 = staged_d2<DP>(tile, p, kV, xq, xrow);
            best.insert(make_key(d2, t0 + p));
        }
    }
    if (!valid) return;
    for (int r = 0; r < m; ++r) out_i[static_cast<size_t>(q) * m + r] = static_cast<int>(best.get(r) & 0xffffffffULL);
    if (out_d2 != nullptr) out_d2[q] = __uint_as_float(static_cast<unsigned>(best.key[0] >> 32));
}

template <int DP, int MC>
cudaError_t launch_nearest(const float* x, int n, int dp, const float* cents, int n_cents, int m, int* out_i,
                           float* out_d2, cudaStream_t s) {
    const int stage = kStageBytes / (4 * dp) > 0 ? kStageBytes / (4 * dp) : 1;
    const size_t smem = static_cast<size_t>(stage) * dp * 4;
    const cudaError_t err = sqt_allow_smem(nearest_kernel<DP, MC>, smem);
    if (err != cudaSuccess) return err;
    const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
    nearest_kernel<DP, MC><<<blocks, kThreads, smem, s>>>(x, n, dp, cents, n_cents, m, stage, out_i, out_d2);
    return cudaGetLastError();
}

template <int MC>
cudaError_t nearest_dp(const float* x, int n, int dp, const float* cents, int n_cents, int m, int* out_i,
                       float* out_d2, cudaStream_t s) {
    switch (dp) {
        case 8: return launch_nearest<8, MC>(x, n, dp, cents, n_cents, m, out_i, out_d2, s);
        case 16: return launch_nearest<16, MC>(x, n, dp, cents, n_cents, m, out_i, out_d2, s);
        case 24: return launch_nearest<24, MC>(x, n, dp, cents, n_cents, m, out_i, out_d2, s);
        case 32: return launch_nearest<32, MC>(x, n, dp, cents, n_cents, m, out_i, out_d2, s);
        case 40: return launch_nearest<40, MC>(x, n, dp, cents, n_cents, m, out_i, out_d2, s);
        case 48: return launch_nearest<48, MC>(x, n, dp, cents, n_cents, m, out_i, out_d2, s);
        case 56: return launch_nearest<56, MC>(x, n, dp, cents, n_cents, m, out_i, out_d2, s);
        case 64: return launch_nearest<64, MC>(x, n, dp, cents, n_cents, m, out_i, out_d2, s);
        default: return launch_nearest<0, MC>(x, n, dp, cents, n_cents, m, out_i, out_d2, s);
    }
}

__device__ __forceinline__ float bf16_round(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }

// One thread a (run, feature): the run's rows, left to right from +0.
__global__ void update_runs_kernel(const float* __restrict__ x, int dp, const int* __restrict__ order,
                                   const int* __restrict__ starts, const int* __restrict__ run_off, int n_cents,
                                   long long max_runs, float* __restrict__ runs) {
    const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
    const long long g = t / dp;
    const int e = static_cast<int>(t - g * dp);
    if (g >= max_runs || g >= run_off[n_cents]) return;
    int lo = 0, hi = n_cents - 1;  // the last cluster whose runs start at or before g
    while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (run_off[mid] <= g) lo = mid; else hi = mid - 1;
    }
    const int r0 = starts[lo] + static_cast<int>(g - run_off[lo]) * kRun;
    const int r1 = r0 + kRun < starts[lo + 1] ? r0 + kRun : starts[lo + 1];
    float sum = 0.0f;
    for (int p = r0; p < r1; ++p) sum = __fadd_rn(sum, bf16_round(__ldg(x + static_cast<size_t>(order[p]) * dp + e)));
    runs[static_cast<size_t>(g) * dp + e] = sum;
}

// One block a cluster: its runs' sums by the pairwise tree, in place, then the mean.
__global__ void __launch_bounds__(kTreeThreads) update_tree_kernel(int dp, const int* __restrict__ starts,
                                                                   const int* __restrict__ run_off,
                                                                   float* runs, const float* __restrict__ old,
                                                                   float* __restrict__ out) {
    const int c = blockIdx.x;
    const int nr = run_off[c + 1] - run_off[c];
    float* r = runs + static_cast<size_t>(run_off[c]) * dp;
    for (int s = 1; s < nr; s <<= 1) {
        const int pairs = (nr - s + 2 * s - 1) / (2 * s);
        for (int t = threadIdx.x; t < pairs * dp; t += kTreeThreads) {
            const int i = (t / dp) * 2 * s;
            const int e = t % dp;
            r[static_cast<size_t>(i) * dp + e] =
                __fadd_rn(r[static_cast<size_t>(i) * dp + e], r[static_cast<size_t>(i + s) * dp + e]);
        }
        __syncthreads();
    }
    const int cnt = starts[c + 1] - starts[c];
    for (int e = threadIdx.x; e < dp; e += kTreeThreads) {
        out[static_cast<size_t>(c) * dp + e] =
            cnt > 0 ? __fdiv_rn(r[e], static_cast<float>(cnt)) : old[static_cast<size_t>(c) * dp + e];
    }
}

}  // namespace

#ifndef SQT_IVF_KMEANS_FILTER
// The exact route: each row's m nearest centroids. x (n, dp) and cents (n_cents, dp)
// float32, dp a positive multiple of 4; 1 <= m <= min(32, n_cents);
// out_i (n, m) int32, ascending; out_d2 (n,) float32, the nearest one's
// d2, when m = 1 (else null).
SQT_EXPORT int sqt_ivf_nearest(const float* x, int n, int dp, const float* cents, int n_cents, int m, int* out_i,
                               float* out_d2, void* stream) {
    if (n < 1 || dp < 4 || dp % 4 || n_cents < 1 || m < 1 || m > 32 || m > n_cents ||
        (out_d2 != nullptr && m != 1)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err;
    if (m == 1) err = nearest_dp<1>(x, n, dp, cents, n_cents, m, out_i, out_d2, s);
    else if (m <= 8) err = nearest_dp<8>(x, n, dp, cents, n_cents, m, out_i, out_d2, s);
    else if (m <= 16) err = nearest_dp<16>(x, n, dp, cents, n_cents, m, out_i, out_d2, s);
    else err = nearest_dp<32>(x, n, dp, cents, n_cents, m, out_i, out_d2, s);
    return static_cast<int>(err);
}

// The centroids' update. x (n, dp) float32; order (n,) int32, the rows
// that count, grouped by cluster in index order, starts (n_cents + 1,)
// int32 each cluster's first position in order, run_off (n_cents + 1,)
// int32 the offsets of each cluster's runs (ceil(size / 32) of them);
// runs (max_runs, dp) float32 scratch, max_runs >= run_off[n_cents];
// old (n_cents, dp) the centroids, out (n_cents, dp) the new ones.
SQT_EXPORT int sqt_ivf_update(const float* x, int n, int dp, const int* order, const int* starts,
                              const int* run_off, int n_cents, long long max_runs, float* runs, const float* old,
                              float* out, void* stream) {
    if (n < 1 || dp < 1 || n_cents < 1 || max_runs < 1) return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const long long threads = max_runs * dp;
    const unsigned blocks = static_cast<unsigned>((threads + 255) / 256);
    update_runs_kernel<<<blocks, 256, 0, s>>>(x, dp, order, starts, run_off, n_cents, max_runs, runs);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    update_tree_kernel<<<n_cents, kTreeThreads, 0, s>>>(dp, starts, run_off, runs, old, out);
    return static_cast<int>(cudaGetLastError());
}

#else
// The nearest entry's filter route: x (n, dp) and cents (n_cents, dp)
// float32, dp a multiple of 8 up to 64; 1 <= m <= min(32, n_cents); c and
// a the bound's constants (csrc/knn_filter.cuh); scratch: terms (cap8 *
// ceil(dp / 16) * 64 bytes, cap8 = n_cents rounded up to 8), hneg (cap8,)
// and mu (dp,) float32; stats null or (5,) int64 zeroed (csrc/knn_filter.cuh IvfFilter);
// out_i (n, m) int32, ascending; out_d2 (n,) float32, the nearest one's d2,
// when m = 1 (else null).
SQT_EXPORT int sqt_ivf_nearest_filter(const float* x, int n, int dp, const float* cents, int n_cents, int m, float c,
                                      float a, void* terms, float* hneg, float* mu, long long* stats,
                                      int* out_i, float* out_d2, void* stream) {
    if (n < 1 || dp < 8 || dp % 8 || dp > knn_filter::kMaxDp || n_cents < 1 || m < 1 || m > 32 || m > n_cents ||
        (out_d2 != nullptr && m != 1) || !(c > 0.0f) || !(a > 0.0f) ||
        terms == nullptr || hneg == nullptr || mu == nullptr) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    knn_filter::IvfFilter f{};
    f.x = x;
    f.nx = n;
    f.y = cents;
    f.ny = n_cents;
    f.cap = n_cents;
    f.cap8 = (n_cents + 7) / 8 * 8;
    f.terms = static_cast<uint4*>(terms);
    f.hneg = hneg;
    f.mu = mu;
    f.k = m;
    f.need = m;
    f.c = c;
    f.a = a;
    f.out_i = out_i;
    f.out_d2 = out_d2;
    f.stats = reinterpret_cast<unsigned long long*>(stats);
    const int slot_blocks = (n + knn_filter::kRows - 1) / knn_filter::kRows;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    // the bounding pass's lists a lane: 1 for Lloyd's assignment, 4 up to 16 centroids, 8 up to 32
    if (m == 1) return static_cast<int>(knn_filter::launch_ivf_filter_dp<1>(dp, f, 1, slot_blocks, s));
    return static_cast<int>(m <= 16 ? knn_filter::launch_ivf_filter_dp<4>(dp, f, 1, slot_blocks, s)
                                    : knn_filter::launch_ivf_filter_dp<8>(dp, f, 1, slot_blocks, s));
}
#endif
