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
// Bound on the card: operations. Any route must at least form the n^2
// products of d features (2 d n^2 at the dense bf16 tensor rate, 989e12/s,
// the filter's operand type) and compare one key a pair (67e12/s): ~1.3 ms
// at 200,000 x 16, ~4.0 ms at 200,000 x 50. The exact d2 alone, 3 d n^2
// float32 operations outside the tensor cores, would take ~57 / ~201 ms at
// dp = 16 / 56.
//
// Design: two routes. The filter route (dp <= 64) ranks nothing by the tensor
// cores: they only decide which pairs the exact keys are computed for. Its
// rule, the proof that it keeps the exact top k, and the block's sweep are
// csrc/knn_filter.cuh, shared with K14 and K15. Here is K12's problem: the
// wrapper centres the columns (xc = fl(x - mu), mu the column means of the
// finite entries) and sums each row's n_i = |xc_i|^2 in float32 (NaN where
// unbounded); a block's query rows are 128 consecutive rows, its candidate
// columns every row in index order, a tile staged by the block's threads
// (each splits a column's centred values into the B fragments' order), the
// row itself excluded by index. A row whose re-ranked candidates pass `cap`
// (many exact ties, duplicate rows, a common offset the centring cannot
// remove), or whose norm is unbounded, leaves the sweep: it is listed.
//
// The exact route (every row when dp > 64, and the listed rows after the
// filter; on every row it is the earlier single-route design): one thread a
// query row, 128 a block, its row's features in registers when dp <= 64 (dp a
// multiple of 8). The block stages the rows in tiles of 32 KB in shared memory,
// in index order, and every thread reads each staged row as a broadcast (float4
// loads); so a thread meets the rows in ascending index and a key enters its
// list only when its d2 is below the list's last. The k best keys sit in
// registers, sorted, in a list of the next power of two at most 32 (KC >= k;
// the first k of the best KC are the best k), by a branch-free sorted
// insertion; a k above 32 keeps its list in a global scratch row a query (a
// binary search, then a shift), as K8 (csrc/cross_knn.cu) does. Above 64
// features (dp a multiple of 32) a thread sums 32 staged rows at once, 32 of
// its features at a time read from the cache, each row's d2 carried across the
// chunks in axis order. On listed rows the grid covers n rows and the blocks
// past the device's count of listed rows return at once, so no count is read
// back.
//
// The file builds as two sources, each in its own nvcc process: here the
// exact route's entry point, and csrc/feature_knn_filter.cu (this file with
// SQT_FEATURE_KNN_FILTER defined) the filter's, whose instances would
// otherwise make this the build's longest source by far.

#include <cmath>
#include <type_traits>

#include "common.cuh"
#include "knn_filter.cuh"
#include "knn_keys.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kStageBytes = 32 * 1024;
constexpr int kGroup = 32;  // rows a thread sums at once above 64 features
constexpr int kChunk = 32;  // features a thread holds at once above 64 features
using knn_filter::kNoKey;

// KC > 0: a sorted register list of KC keys; KC = 0: `k` keys in a global scratch row.
template <int KC>
struct TopK {
    unsigned long long best[KC ? KC : 1];
    unsigned long long* list;
    int k;
    unsigned long long worst;  // the list's last key (KC = 0)

    __device__ __forceinline__ void init(unsigned long long* row, int k_) {
#pragma unroll
        for (int r = 0; r < (KC ? KC : 1); ++r) best[r] = kNoKey;
        list = KC ? nullptr : row;
        k = k_;
        worst = kNoKey;
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

// The exact route's query of thread slot `slot`: every row (rows null), or
// the slot-th listed row while slot < the listed count.
__device__ __forceinline__ int exact_query(const int* rows, int count, int slot) {
    return slot < count ? (rows ? rows[slot] : slot) : -1;
}

// dp = DP <= 64: the query row's features in registers.
template <int DP, int KC>
__global__ void __launch_bounds__(kThreads) knn_regs_kernel(const float* __restrict__ x, int n, int k, int stage,
                                                            const int* __restrict__ rows,
                                                            const int* __restrict__ n_rows,
                                                            unsigned long long* __restrict__ scratch,
                                                            float* __restrict__ out_d, int* __restrict__ out_i) {
    extern __shared__ float4 tile[];  // (stage, DP / 4)
    constexpr int kV = DP / 4;
    const int count = rows ? *n_rows : n;
    if (static_cast<int>(blockIdx.x) * kThreads >= count) return;  // the whole block: no listed row
    const int q = exact_query(rows, count, blockIdx.x * kThreads + threadIdx.x);
    const bool valid = q >= 0;
    const float4* x4 = reinterpret_cast<const float4*>(x);
    float xq[DP];
    load_row<DP>(x4 + static_cast<size_t>(valid ? q : 0) * kV, valid, xq);
    TopK<KC> top;
    top.init(scratch + static_cast<size_t>(valid ? q : 0) * k, k);
    for (int t0 = 0; t0 < n; t0 += stage) {
        const int cnt = n - t0 < stage ? n - t0 : stage;
        __syncthreads();  // every thread is done with the last tile
        for (int e = threadIdx.x; e < cnt * kV; e += kThreads) tile[e] = __ldg(x4 + static_cast<size_t>(t0) * kV + e);
        __syncthreads();
        if (!valid) continue;
        for (int p = 0; p < cnt; ++p) {
            const float d2 = staged_d2<DP>(tile, p, kV, xq, nullptr);
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
                                                               int stage, const int* __restrict__ rows,
                                                               const int* __restrict__ n_rows,
                                                               unsigned long long* __restrict__ scratch,
                                                               float* __restrict__ out_d, int* __restrict__ out_i) {
    extern __shared__ float4 tile[];  // (stage, dp / 4)
    const int kV = dp / 4;
    const int count = rows ? *n_rows : n;
    if (static_cast<int>(blockIdx.x) * kThreads >= count) return;
    const int q = exact_query(rows, count, blockIdx.x * kThreads + threadIdx.x);
    const bool valid = q >= 0;
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

// ---- the filter route -----------------------------------------------------

struct Filter {
    const float* x;       // (n, DP) the padded rows
    const float* xc;      // (n, DP) centred
    const float* norms;   // (n,) |xc|^2, NaN if unbounded
    int n;
    int k;
    float c;
    float a;
    int cap;
    unsigned long long* glists;  // (n, k) all ones, when k > kSharedK
    int* exact_rows;
    int* n_exact;
    int* cand_counts;
    float* out_d;
    int* out_i;
};

// K12's problem for knn_filter::sweep: the block's 128 rows against every row.
template <int DP>
struct K12Problem {
    static constexpr bool kAsync = false;
    static constexpr int KS = knn_filter::ksteps<DP>();
    static constexpr int kTileCols = knn_filter::tile_cols<DP>();
    Filter f;
    int row0;
    int k, cap, need, n_cols, list_unbounded;
    float c, a;

    __device__ int row_id(int r) const { return row0 + r < f.n ? row0 + r : -1; }

    __device__ unsigned long long* glist(int r) const {
        return row0 + r < f.n ? f.glists + static_cast<size_t>(row0 + r) * k : nullptr;
    }

    // the rows' centred values and norms, as the wrapper computed them
    __device__ void load_rows(const int*, int warp, int g, int t, unsigned (&ahi)[2][KS][4],
                              unsigned (&alo)[2][KS][4], float (&nrm)[2][2]) const {
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int row = row0 + warp * 32 + mt * 16 + g + 8 * h;
                nrm[mt][h] = row < f.n ? __ldg(f.norms + row) : 0.0f;
            }
#pragma unroll
            for (int s = 0; s < KS; ++s) {
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                    const int row = row0 + warp * 32 + mt * 16 + g + ((q & 1) ? 8 : 0);
                    const int e = 16 * s + 2 * t + ((q & 2) ? 8 : 0);
                    float2 v = make_float2(0.f, 0.f);
                    if (row < f.n && e < DP)
                        v = __ldg(reinterpret_cast<const float2*>(f.xc + static_cast<size_t>(row) * DP + e));
                    knn_filter::split2(v.x, v.y, ahi[mt][s][q], alo[mt][s][q]);
                }
            }
        }
    }

    // a tile of kTileCols columns from t0 (zeros past n): bf16 terms in the B fragments' order, -n_j / 2
    __device__ void stage(int t0, int, uint4* bfrag, float* hneg) const {
        const float4* xc4 = reinterpret_cast<const float4*>(f.xc);
        for (int i = threadIdx.x; i < kTileCols; i += knn_filter::kRows) {
            const int j = t0 + i;
            hneg[i] = j < f.n ? -0.5f * __ldg(f.norms + j) : 0.0f;
        }
        for (int i = threadIdx.x; i < kTileCols * KS; i += knn_filter::kRows) {
            const int cl = i / KS;
            const int s = i - cl * KS;
            const int j = t0 + cl;
            float v[16];
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                float4 w = make_float4(0.f, 0.f, 0.f, 0.f);
                if (j < f.n && 16 * s + 4 * q < DP) w = __ldg(xc4 + static_cast<size_t>(j) * (DP / 4) + 4 * s + q);
                v[4 * q] = w.x;
                v[4 * q + 1] = w.y;
                v[4 * q + 2] = w.z;
                v[4 * q + 3] = w.w;
            }
            knn_filter::store_b_column(v, bfrag + ((cl >> 3) * KS + s) * 32 + (cl & 7) * 4);
        }
    }

    __device__ void keys2(int, int id, int j, int mask, unsigned long long& k0, unsigned long long& k1) const {
        const float4* x4 = reinterpret_cast<const float4*>(f.x);
        const float4* xr = x4 + static_cast<size_t>(id) * (DP / 4);
#pragma unroll
        for (int c2 = 0; c2 < 2; ++c2) {
            const int jj = j + c2;
            unsigned long long key = kNoKey;
            if (((mask >> c2) & 1) && jj < f.n && jj != id) {
                const float4* xj = x4 + static_cast<size_t>(jj) * (DP / 4);
                float d2 = 0.0f;
#pragma unroll
                for (int e = 0; e < DP / 4; ++e) {
                    const float4 av = __ldg(xr + e);
                    const float4 bv = __ldg(xj + e);
                    d2 = add_sq(d2, av.x, bv.x);
                    d2 = add_sq(d2, av.y, bv.y);
                    d2 = add_sq(d2, av.z, bv.z);
                    d2 = add_sq(d2, av.w, bv.w);
                }
                key = make_key(d2, jj);
            }
            (c2 ? k1 : k0) = key;
        }
    }

    // outputs of the rows the filter finished; the others are listed
    __device__ void finish(int, int row, int st, int, const unsigned long long* list) const {
        if (st == knn_filter::kPad) return;
        f.cand_counts[row] = st;
        if (st == knn_filter::kExact) {
            f.exact_rows[atomicAdd(f.n_exact, 1)] = row;
            return;
        }
        for (int s = 0; s < k; ++s) {
            const unsigned long long key = list[s];
            f.out_d[static_cast<size_t>(row) * k + s] = sqrtf(__uint_as_float(static_cast<unsigned>(key >> 32)));
            f.out_i[static_cast<size_t>(row) * k + s] = static_cast<int>(key & 0xffffffffULL);
        }
    }
};

template <int DP>
__global__ void __launch_bounds__(knn_filter::kRows) knn_filter_kernel(Filter f) {
    extern __shared__ __align__(16) unsigned char smem[];
    K12Problem<DP> p{f, static_cast<int>(blockIdx.x) * knn_filter::kRows, f.k, f.cap, 0, f.n, 1, f.c, f.a};
    knn_filter::sweep<DP, 0>(p, smem);
}

template <int DP>
cudaError_t launch_filter(const Filter& f, cudaStream_t s) {
    const size_t smem = knn_filter::smem_bytes<DP>(f.k, 0);
    const cudaError_t err = sqt_allow_smem(knn_filter_kernel<DP>, smem);
    if (err != cudaSuccess) return err;
    const unsigned blocks = static_cast<unsigned>((f.n + knn_filter::kRows - 1) / knn_filter::kRows);
    knn_filter_kernel<DP><<<blocks, knn_filter::kRows, smem, s>>>(f);
    return cudaGetLastError();
}

// ---- the exact route's launches ------------------------------------------

template <int DP, int KC>
cudaError_t launch_regs(const float* x, int n, int k, const int* rows, const int* n_rows, unsigned long long* scratch,
                        float* out_d, int* out_i, cudaStream_t s) {
    const int stage = kStageBytes / (4 * DP);
    const size_t smem = static_cast<size_t>(stage) * DP * 4;
    const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
    knn_regs_kernel<DP, KC><<<blocks, kThreads, smem, s>>>(x, n, k, stage, rows, n_rows, scratch, out_d, out_i);
    return cudaGetLastError();
}

template <int KC>
cudaError_t launch_k(const float* x, int n, int dp, int k, const int* rows, const int* n_rows,
                     unsigned long long* scratch, float* out_d, int* out_i, cudaStream_t s) {
    switch (dp) {
        case 8: return launch_regs<8, KC>(x, n, k, rows, n_rows, scratch, out_d, out_i, s);
        case 16: return launch_regs<16, KC>(x, n, k, rows, n_rows, scratch, out_d, out_i, s);
        case 24: return launch_regs<24, KC>(x, n, k, rows, n_rows, scratch, out_d, out_i, s);
        case 32: return launch_regs<32, KC>(x, n, k, rows, n_rows, scratch, out_d, out_i, s);
        case 40: return launch_regs<40, KC>(x, n, k, rows, n_rows, scratch, out_d, out_i, s);
        case 48: return launch_regs<48, KC>(x, n, k, rows, n_rows, scratch, out_d, out_i, s);
        case 56: return launch_regs<56, KC>(x, n, k, rows, n_rows, scratch, out_d, out_i, s);
        case 64: return launch_regs<64, KC>(x, n, k, rows, n_rows, scratch, out_d, out_i, s);
        default: break;
    }
    int stage = kStageBytes / (4 * dp) / kGroup * kGroup;
    if (stage < kGroup) stage = kGroup;
    const size_t smem = static_cast<size_t>(stage) * dp * 4;
    const cudaError_t err = sqt_allow_smem(knn_chunked_kernel<KC>, smem);
    if (err != cudaSuccess) return err;
    const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
    knn_chunked_kernel<KC><<<blocks, kThreads, smem, s>>>(x, n, dp, k, stage, rows, n_rows, scratch, out_d, out_i);
    return cudaGetLastError();
}

bool valid_shape(int n, int dp, int k) {
    return n >= 2 && k >= 1 && k <= n - 1 && dp >= 8 && !(dp <= 64 && dp % 8) && !(dp > 64 && dp % kChunk) &&
           static_cast<long long>(n) * (dp > k ? dp : k) < (1LL << 40);
}

}  // namespace

#ifndef SQT_FEATURE_KNN_FILTER
// The exact route. x (n, dp) float32, dp a multiple of 8 up to 64 or of 32
// above (zero columns pad the features); 1 <= k <= n - 1; rows and n_rows
// null for every row, or rows (n,) int32 listing *n_rows rows (a count on
// the device); scratch (n, k) uint64 filled with all ones when k > 32,
// else unused; out_d (n, k) float32 and out_i (n, k) int32, written at
// the rows taken.
SQT_EXPORT int sqt_feature_knn(const float* x, int n, int dp, int k, const int* rows, const int* n_rows,
                               long long* scratch, float* out_d, int* out_i, void* stream) {
    if (!valid_shape(n, dp, k) || (k > 32 && scratch == nullptr) || ((rows == nullptr) != (n_rows == nullptr))) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    auto* sc = reinterpret_cast<unsigned long long*>(scratch);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err;
    if (k <= 8) err = launch_k<8>(x, n, dp, k, rows, n_rows, sc, out_d, out_i, s);
    else if (k <= 16) err = launch_k<16>(x, n, dp, k, rows, n_rows, sc, out_d, out_i, s);
    else if (k <= 32) err = launch_k<32>(x, n, dp, k, rows, n_rows, sc, out_d, out_i, s);
    else err = launch_k<0>(x, n, dp, k, rows, n_rows, sc, out_d, out_i, s);
    return static_cast<int>(err);
}

#else
// The filter route, dp a multiple of 8 up to 64. x (n, dp) the padded
// rows, xc (n, dp) the centred rows, norms (n,) their float32 |xc|^2 (NaN
// for an unbounded row), c and a the bound's constants (header), cap the
// candidates a row may re-rank before it is listed; lists (n, k) uint64
// all ones when k > 64, else unused; exact_rows (n,) int32 and n_exact
// (one int32, zeroed by the caller) receive the listed rows, cand_counts
// (n,) int32 each row's re-ranked candidates (-1 if listed); out_d/out_i
// (n, k) are written at the rows the filter finished.
SQT_EXPORT int sqt_feature_knn_filter(const float* x, const float* xc, const float* norms, int n, int dp, int k,
                                      float c, float a, int cap, long long* lists, int* exact_rows, int* n_exact,
                                      int* cand_counts, float* out_d, int* out_i, void* stream) {
    if (!valid_shape(n, dp, k) || dp > knn_filter::kMaxDp || cap < 1 || (k > knn_filter::kSharedK && lists == nullptr) ||
        exact_rows == nullptr || n_exact == nullptr || cand_counts == nullptr || !(c > 0.0f) || !(a > 0.0f)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const Filter f{x, xc, norms, n, k, c, a, cap, reinterpret_cast<unsigned long long*>(lists),
                   exact_rows, n_exact, cand_counts, out_d, out_i};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (dp) {
        case 8: return static_cast<int>(launch_filter<8>(f, s));
        case 16: return static_cast<int>(launch_filter<16>(f, s));
        case 24: return static_cast<int>(launch_filter<24>(f, s));
        case 32: return static_cast<int>(launch_filter<32>(f, s));
        case 40: return static_cast<int>(launch_filter<40>(f, s));
        case 48: return static_cast<int>(launch_filter<48>(f, s));
        case 56: return static_cast<int>(launch_filter<56>(f, s));
        default: return static_cast<int>(launch_filter<64>(f, s));
    }
}
#endif
