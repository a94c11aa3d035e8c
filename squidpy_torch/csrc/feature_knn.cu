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
// Two routes. The filter route (dp <= 64) ranks nothing by the tensor
// cores: they only decide which pairs the exact keys are computed for.
//
// The filter. The wrapper centres the columns (xc = fl(x - mu), mu any
// float32 vector; the column means of the finite entries) and sums each
// row's n_i = |xc_i|^2 in float32; a row whose n_i is not finite or not
// below 2^124 is unbounded (its norm is stored as NaN). The kernel splits
// each centred value v into bf16 terms hi = rn(v), lo = rn(v - hi) and
// sums, on mma.sync m16n8k16, A_ij = -n_j / 2 + sum_e (lo_ie hi_je + hi_ie
// lo_je + hi_ie hi_je), so e_ij = n_i - 2 A_ij approximates the centred d2.
// With u = 2^-24, N the exact norms and D_ij the plain version's d2:
//   - |n - N| <= gamma_dp N in any summation order (gamma_m = m u / (1 - m u));
//   - |v - hi - lo| <= 2^-18 |v| and |lo| <= 2^-9 (1 + 2^-9) |v|, so the
//     three products drop at most 3.01 * 2^-18 |v_i| |v_j| a feature, and a
//     product of bf16 terms is exact in float32: twice the dropped part is
//     at most 192.6 u (N_i + N_j);
//   - every addition in the tensor cores may be off by one ulp (2u relative
//     to the sum of the magnitudes) in any order and direction, over 3 dp16
//     + 1 terms (dp16: dp rounded up to 16; the padding adds exact zeros)
//     whose magnitudes sum to at most 1.003 (N_i + N_j): twice that error
//     is at most 4.012 (3 dp + 25) u (N_i + N_j);
//   - the centring moves each difference by at most u (|xc_ie| + |xc_je|)
//     (1 + u), so |d2 - |xc_i - xc_j|^2| <= 4.01 u (N_i + N_j) for the real
//     d2 = |x_i - x_j|^2;
//   - the plain d2 rounds each of dp + 2 steps of a sum of non-negative
//     terms: |D - d2| <= gamma_(dp+2) d2 <= 2.01 (dp + 2) u (N_i + N_j);
//   - in all, |e_ij - D_ij| <= (15.05 dp + 301) u (N_i + N_j), and
//     subnormal products flushed or rounded add at most (8 dp + 8) 2^-126.
// So delta_ij = c (n_i + n_j) + a with c = (dp + 20) 2^-19 (= (32 dp + 640)
// u, over twice the sum above over (1 - gamma_dp)) and a = (dp + 1) 2^-120
// bounds |e_ij - D_ij|, and so does delta_it = c (n_i + nmax_t) + a for
// every column of a staged tile t whose largest bounded norm is nmax_t.
// Bounded norms keep every product and sum finite. Row i keeps an exact
// list of the k least keys among the pairs re-ranked so far, and T_i, the
// d2 of its k-th key (+inf while the list holds fewer than k, or the k-th
// d2 is NaN or +inf). Pair (i, j) of tile t is a candidate unless
// A_ij < M_it, M_it = (n_i - delta_it - T_i) / 2, each step rounded
// towards a smaller M (__fadd_ru for delta, __fsub_rd, __fmul_rd); the
// kernel tests the two columns of a lane's accumulator pair at once, by
// their NaN-propagating maximum, so both are re-ranked when either passes.
// Proof: a list over a subset of the columns has its k-th key at or above
// the k-th key over all columns, so a member j of the row's exact top k has
// D_ij <= T_i at every tile; then, in real numbers, n_i - 2 A_ij - delta_it
// <= e_ij - delta_ij <= D_ij <= T_i, so A_ij >= (n_i - delta_it - T_i) / 2
// >= M_it, and j is a candidate. A NaN A_ij (an unbounded column) is one.
// Each candidate's exact key is computed as the exact route computes it
// (`add_sq` on the original rows), inserted into the row's list, and T_i
// follows; so the first k of the list at the end are the plain version's.
//
// Design of the filter route: a block takes 128 rows (4 warps of 32), their
// bf16 terms in registers as mma A fragments, and sweeps every column in index
// order, a tile at a time (128 columns up to 32 features, 64 above): the block
// stages the tile's bf16 terms in shared memory in the B fragments' order (one
// 16-byte load a lane a k-step gives a lane both terms of its four features)
// and -n_j / 2 as the mma's C operand, so A_ij leaves the tensor cores ready
// for one compare a column pair into a bit mask. A warp queues its (row, column
// pair) candidates in shared memory across tiles; once the queue holds 32
// entries (or is full) it computes their exact keys a lane each, and one lane a
// row inserts them into the row's sorted list (shared memory for k <= 64, a
// global scratch row above) and updates T_i (a stale T_i only admits more
// pairs). A row whose re-ranked candidates pass `cap` (many exact ties,
// duplicate rows, a common offset the centring cannot remove), or whose norm is
// unbounded, leaves the sweep: it is listed.
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
#include "knn_keys.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kStageBytes = 32 * 1024;
constexpr int kGroup = 32;  // rows a thread sums at once above 64 features
constexpr int kChunk = 32;  // features a thread holds at once above 64 features
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kNoKey = ~0ULL;

constexpr int kFilterRows = 128;   // rows a block of the filter route
// columns a staged tile: 128 up to 32 features (the tile's fixed costs, its
// barrier and bounds, weigh most there), 64 above (registers)
template <int DP>
__host__ __device__ constexpr int tile_cols() { return DP <= 32 ? 128 : 64; }
constexpr int kQueue = 128;        // a warp's queue of candidates
constexpr int kSharedK = 64;       // lists in shared memory up to this k
constexpr int kFilterMaxDp = 64;

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

// Two float32 values as bf16, rounded to nearest even, packed (the first in the low half).
__device__ __forceinline__ unsigned bf16x2(float lo_half, float hi_half) {
    unsigned r;
    asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi_half), "f"(lo_half));
    return r;
}

// The bf16 terms hi = rn(v), lo = rn(v - hi) of two values, packed as bf16x2.
__device__ __forceinline__ void split2(float v0, float v1, unsigned& hi, unsigned& lo) {
    hi = bf16x2(v0, v1);
    const float h0 = __uint_as_float(hi << 16), h1 = __uint_as_float(hi & 0xffff0000u);
    lo = bf16x2(__fsub_rn(v0, h0), __fsub_rn(v1, h1));
}

// D = A B + C on one m16n8k16 bf16 tile, float32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0, unsigned b1,
                                         const float (&c)[4]) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
        "{%10,%11,%12,%13};\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(c[0]), "f"(c[1]), "f"(c[2]),
          "f"(c[3]));
}

__device__ __forceinline__ int popcount(unsigned v) { return __popc(v); }
__device__ __forceinline__ int popcount(unsigned long long v) { return __popcll(v); }
__device__ __forceinline__ int lowest_bit(unsigned v) { return __ffs(static_cast<int>(v)) - 1; }
__device__ __forceinline__ int lowest_bit(unsigned long long v) { return __ffsll(static_cast<long long>(v)) - 1; }

// The larger of two values, NaN if either is.
__device__ __forceinline__ float max_nan(float a, float b) {
    float r;
    asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
    return r;
}

// The d2 of the k-th key of a sorted list, +inf while it is not full or that d2 is NaN.
__device__ __forceinline__ float list_threshold(unsigned long long last) {
    const unsigned bits = static_cast<unsigned>(last >> 32);
    return (last == kNoKey || bits == kNanBits) ? __int_as_float(0x7f800000) : __uint_as_float(bits);
}

// Insert `key` into the sorted list of k keys (its last drops out).
__device__ __forceinline__ void list_insert(unsigned long long* list, int k, unsigned long long key) {
    if (!(key < list[k - 1])) return;
    int lo = 0, hi = k - 1;  // the first slot whose key is above `key`
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (list[mid] < key) lo = mid + 1; else hi = mid;
    }
    for (int r = k - 1; r > lo; --r) list[r] = list[r - 1];
    list[lo] = key;
}

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

// Row states in shared memory: >= 0 the row's re-ranked candidates; on the exact route; a padding row.
constexpr int kExact = -1;
constexpr int kPad = -2;
constexpr int kFilterWarps = kFilterRows / 32;  // 32 rows a warp: two m16 tiles

template <int DP>
__host__ __device__ constexpr size_t filter_smem(int k) {
    return 2 * (static_cast<size_t>(tile_cols<DP>()) * ((DP + 15) / 16) * 16 * 4  // two tiles' bf16 terms
                + tile_cols<DP>() * 4)                                             // and -n_j / 2
           + kFilterRows * 8                                            // T_i, state
           + static_cast<size_t>(kFilterWarps) * kQueue * 24            // queues
           + (k <= kSharedK ? static_cast<size_t>(kFilterRows) * k * 8 : 0);
}

template <int DP>
__global__ void __launch_bounds__(kFilterRows) knn_filter_kernel(Filter f) {
    constexpr int KS = (DP + 15) / 16;  // k-steps of 16 features
    constexpr int kTileCols = tile_cols<DP>();
    constexpr int NF = kTileCols / 8;   // n-fragments a tile
    constexpr int MT = 2;               // m16 tiles a warp
    using Bits = std::conditional_t<(NF * MT * 2 > 32), unsigned long long, unsigned>;  // a bit a column pair and row
    extern __shared__ __align__(16) unsigned char smem[];
    uint4* bfrag_all = reinterpret_cast<uint4*>(smem);                 // (2, NF, KS, 32)
    float* hneg_all = reinterpret_cast<float*>(bfrag_all + 2 * NF * KS * 32);  // (2, kTileCols)
    float* thr = hneg_all + 2 * kTileCols;                             // (kFilterRows,)
    int* state = reinterpret_cast<int*>(thr + kFilterRows);            // (kFilterRows,)
    unsigned long long* qkey_all = reinterpret_cast<unsigned long long*>(state + kFilterRows);  // (W, kQueue, 2)
    int* qrow_all = reinterpret_cast<int*>(qkey_all + kFilterWarps * kQueue * 2);  // (W, kQueue)
    int* qcol_all = qrow_all + kFilterWarps * kQueue;                               // (W, kQueue)
    unsigned long long* slists = reinterpret_cast<unsigned long long*>(qcol_all + kFilterWarps * kQueue);

    const int tid = threadIdx.x;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int row0 = blockIdx.x * kFilterRows;
    const int n = f.n;
    const int k = f.k;
    const bool shared_lists = k <= kSharedK;
    unsigned long long* qkey = qkey_all + warp * kQueue * 2;
    int* qrow = qrow_all + warp * kQueue;
    int* qcol = qcol_all + warp * kQueue;

    // the block's rows' states, thresholds and lists
    const float4* x4 = reinterpret_cast<const float4*>(f.x);
    for (int r = tid; r < kFilterRows; r += kFilterRows) {
        const int row = row0 + r;
        thr[r] = __int_as_float(0x7f800000);
        state[r] = row >= n ? kPad : (isnan(__ldg(f.norms + row)) ? kExact : 0);
    }
    for (int e = tid; e < kFilterRows * k; e += kFilterRows) {
        const int r = e / k;
        if (shared_lists) slists[e] = kNoKey;
        else if (row0 + r < n) f.glists[static_cast<size_t>(row0) * k + e] = kNoKey;
    }

    // this warp's rows as A fragments (bf16 hi and lo terms), and their norms
    unsigned ahi[MT][KS][4], alo[MT][KS][4];
    float nrm[MT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int row = row0 + warp * 32 + mt * 16 + g + 8 * h;
            nrm[mt][h] = row < n ? __ldg(f.norms + row) : 0.0f;
        }
#pragma unroll
        for (int s = 0; s < KS; ++s) {
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                const int row = row0 + warp * 32 + mt * 16 + g + ((q & 1) ? 8 : 0);
                const int e = 16 * s + 2 * t + ((q & 2) ? 8 : 0);
                float2 v = make_float2(0.f, 0.f);
                if (row < n && e < DP)
                    v = __ldg(reinterpret_cast<const float2*>(f.xc + static_cast<size_t>(row) * DP + e));
                split2(v.x, v.y, ahi[mt][s][q], alo[mt][s][q]);
            }
        }
    }

    // the queued candidates re-ranked exactly, a lane an entry, and inserted
    // by one lane a row into its list, which then sets the row's T_i
    int queued = 0;  // warp-uniform
    auto flush = [&](int count) {
        __syncwarp();
        for (int q = lane; q < count; q += 32) {
            const int r = qrow[q];
            const float4* xr = x4 + static_cast<size_t>(row0 + r) * (DP / 4);
#pragma unroll
            for (int c2 = 0; c2 < 2; ++c2) {
                const int j = qcol[q] + c2;
                unsigned long long key = kNoKey;
                if (j < n && j != row0 + r) {
                    const float4* xj = x4 + static_cast<size_t>(j) * (DP / 4);
                    float d2 = 0.0f;
#pragma unroll
                    for (int e = 0; e < DP / 4; ++e) {
                        const float4 a = __ldg(xr + e);
                        const float4 b = __ldg(xj + e);
                        d2 = add_sq(d2, a.x, b.x);
                        d2 = add_sq(d2, a.y, b.y);
                        d2 = add_sq(d2, a.z, b.z);
                        d2 = add_sq(d2, a.w, b.w);
                    }
                    key = make_key(d2, j);
                }
                qkey[2 * q + c2] = key;
            }
        }
        __syncwarp();
        {
            const int r = warp * 32 + lane;
            int cnt = state[r];
            if (cnt >= 0) {
                unsigned long long* list = shared_lists ? slists + r * k
                                                        : f.glists + static_cast<size_t>(row0 + r) * k;
                for (int q = 0; q < count; ++q) {
                    if (qrow[q] != r) continue;
#pragma unroll
                    for (int c2 = 0; c2 < 2; ++c2) {
                        const unsigned long long key = qkey[2 * q + c2];
                        if (key == kNoKey) continue;
                        ++cnt;
                        list_insert(list, k, key);
                    }
                }
                if (cnt > f.cap) {
                    cnt = kExact;
                    if (!shared_lists)
                        for (int s = 0; s < k; ++s) list[s] = kNoKey;  // the exact route's list starts empty
                } else {
                    thr[r] = list_threshold(list[k - 1]);
                }
                state[r] = cnt;
            }
        }
        __syncwarp();
    };

    const float4* xc4 = reinterpret_cast<const float4*>(f.xc);
    int buf = 0;
    for (int t0 = 0; t0 < n; t0 += kTileCols, buf ^= 1) {
        // two shared buffers: a warp still on the last tile reads the other one, so one barrier a tile
        uint4* bfrag = bfrag_all + buf * NF * KS * 32;
        float* hneg = hneg_all + buf * kTileCols;
        for (int i = tid; i < kTileCols; i += kFilterRows) {
            const int j = t0 + i;
            hneg[i] = j < n ? -0.5f * __ldg(f.norms + j) : 0.0f;
        }
        for (int i = tid; i < kTileCols * KS; i += kFilterRows) {
            const int cl = i / KS;
            const int s = i - cl * KS;
            const int j = t0 + cl;
            float v[16];
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                float4 w = make_float4(0.f, 0.f, 0.f, 0.f);
                if (j < n && 16 * s + 4 * q < DP) w = __ldg(xc4 + static_cast<size_t>(j) * (DP / 4) + 4 * s + q);
                v[4 * q] = w.x;
                v[4 * q + 1] = w.y;
                v[4 * q + 2] = w.z;
                v[4 * q + 3] = w.w;
            }
            uint4* dst = bfrag + ((cl >> 3) * KS + s) * 32 + (cl & 7) * 4;
#pragma unroll
            for (int tt = 0; tt < 4; ++tt) {
                unsigned h0, l0, h1, l1;
                split2(v[2 * tt], v[2 * tt + 1], h0, l0);          // features 16s + 2tt, + 1: a lane's b0
                split2(v[2 * tt + 8], v[2 * tt + 9], h1, l1);      // features 16s + 8 + 2tt, + 1: its b1
                dst[tt] = make_uint4(h0, h1, l0, l1);
            }
        }
        __syncthreads();

        // this lane's rows: live, and their compare bounds M for this tile
        Bits live = 0;
        float M[MT][2];
        {
            float mn = hneg[lane];  // fminf drops NaN (unbounded columns)
#pragma unroll
            for (int c = lane + 32; c < kTileCols; c += 32) mn = fminf(mn, hneg[c]);
#pragma unroll
            for (int o = 16; o > 0; o >>= 1) mn = fminf(mn, __shfl_xor_sync(kFull, mn, o));
            const float nmax = isnan(mn) ? 0.0f : -2.0f * mn;
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const int r = warp * 32 + mt * 16 + g + 8 * h;
                    const float ni = nrm[mt][h];
                    const float delta = __fmaf_ru(f.c, __fadd_ru(ni, nmax), f.a);
                    M[mt][h] = __fmul_rd(0.5f, __fsub_rd(__fsub_rd(ni, delta), thr[r]));
                    if (state[r] >= 0) {
#pragma unroll
                        for (int nf = 0; nf < NF; ++nf) live |= Bits(1) << ((nf * MT + mt) * 2 + h);
                    }
                }
            }
        }
        if (!__any_sync(kFull, live != 0)) continue;  // every row of the warp is done

        Bits bits = 0;
#pragma unroll
        for (int nf = 0; nf < NF; ++nf) {
            const float2 hn = reinterpret_cast<const float2*>(hneg)[nf * 4 + t];
            const float cinit[4] = {hn.x, hn.y, hn.x, hn.y};
            float acc[MT][4];
#pragma unroll
            for (int s = 0; s < KS; ++s) {
                const uint4 b = bfrag[(nf * KS + s) * 32 + lane];
#pragma unroll
                for (int mt = 0; mt < MT; ++mt) {
                    if (s == 0) mma_bf16(acc[mt], alo[mt][s], b.x, b.y, cinit);
                    else mma_bf16(acc[mt], alo[mt][s], b.x, b.y, acc[mt]);
                    mma_bf16(acc[mt], ahi[mt][s], b.z, b.w, acc[mt]);
                    mma_bf16(acc[mt], ahi[mt][s], b.x, b.y, acc[mt]);
                }
            }
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
                if (!(max_nan(acc[mt][0], acc[mt][1]) < M[mt][0])) bits |= Bits(1) << ((nf * MT + mt) * 2);
                if (!(max_nan(acc[mt][2], acc[mt][3]) < M[mt][1])) bits |= Bits(1) << ((nf * MT + mt) * 2 + 1);
            }
        }
        bits &= live;

        // the candidates: column pairs queued across tiles, re-ranked once the
        // queue holds a lane's worth or is full (a stale T_i only admits more)
        while (__any_sync(kFull, bits != 0)) {
            const int have = popcount(bits);
            int off = have;
#pragma unroll
            for (int o = 1; o < 32; o <<= 1) {
                const int y = __shfl_up_sync(kFull, off, o);
                if (lane >= o) off += y;
            }
            const int total = __shfl_sync(kFull, off, 31);
            off -= have;
            const int room = kQueue - queued;
            const int take = off >= room ? 0 : min(have, room - off);
            for (int i = 0; i < take; ++i) {
                const int bit = lowest_bit(bits);
                bits &= bits - 1;
                const int nf = bit / (MT * 2);
                const int mt = (bit >> 1) & 1;
                const int h = bit & 1;
                qrow[queued + off + i] = warp * 32 + mt * 16 + g + 8 * h;
                qcol[queued + off + i] = t0 + nf * 8 + 2 * t;
            }
            queued += min(total, room);
            if (queued == kQueue) {
                flush(queued);
                queued = 0;
            }
        }
        if (queued >= 32) {
            flush(queued);
            queued = 0;
        }
    }
    if (queued) flush(queued);
    __syncthreads();

    // outputs of the rows the filter finished; the others are listed
    for (int r = tid; r < kFilterRows; r += kFilterRows) {
        const int row = row0 + r;
        const int st = state[r];
        if (st == kPad) continue;
        f.cand_counts[row] = st;
        if (st == kExact) {
            f.exact_rows[atomicAdd(f.n_exact, 1)] = row;
            continue;
        }
        const unsigned long long* list = shared_lists ? slists + r * k : f.glists + static_cast<size_t>(row) * k;
        for (int s = 0; s < k; ++s) {
            const unsigned long long key = list[s];
            f.out_d[static_cast<size_t>(row) * k + s] = sqrtf(__uint_as_float(static_cast<unsigned>(key >> 32)));
            f.out_i[static_cast<size_t>(row) * k + s] = static_cast<int>(key & 0xffffffffULL);
        }
    }
}

template <int DP>
cudaError_t launch_filter(const Filter& f, cudaStream_t s) {
    const size_t smem = filter_smem<DP>(f.k);
    const cudaError_t err = sqt_allow_smem(knn_filter_kernel<DP>, smem);
    if (err != cudaSuccess) return err;
    const unsigned blocks = static_cast<unsigned>((f.n + kFilterRows - 1) / kFilterRows);
    knn_filter_kernel<DP><<<blocks, kFilterRows, smem, s>>>(f);
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
    if (!valid_shape(n, dp, k) || dp > kFilterMaxDp || cap < 1 || (k > kSharedK && lists == nullptr) ||
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
