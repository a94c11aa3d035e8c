// K17: co-occurrence's dense class-pair counts, below the binned sweep's
// 100,000 points.
//
// Replaces squidpy_tpu/ops/cooccur.py `cooccur_block_pairs_device` (line
// 133). There XLA walks a list of upper-triangle (tile, tile) block pairs,
// computes each block's difference-form d2 and, once per threshold (`lax.map`
// over the L thresholds), multiplies the block's indicator by the labels'
// one-hots on the matrix unit, carrying the counts as two int32 digits. Here,
// for n points (d float32 coordinates each), int32 labels and L squared
// thresholds sorted ascending, it writes out[r, a, b] = #{i < j : label_i =
// a, label_j = b, d2(i, j) <= thr[r]}, int64, exact at any n (99k points of
// one class hold 4.9e9 pairs). A label outside [0, C) is counted nowhere
// (the -1 of a NaN cell), and so is a NaN d2. d2 is the difference form in
// axis order, each subtraction, multiply and add rounded on its own
// (__fsub_rn, __fmul_rn, __fadd_rn, and --fmad=false), as the plain torch
// version's elementwise ops round it, so the counts agree bit for bit.
//
// Bound on the card: operations. Each of the n (n - 1) / 2 pairs takes 3d - 1
// flops of d2 and one compare with the largest threshold, against d * 4 + 4
// bytes of input a point: at 99,000 points in 2-D, 4.9e9 pairs, ~3.4e10
// operations, ~0.5 ms at 67 TFLOP/s.
//
// Design (K7's sweep, csrc/ripley_pairs.cu, with a class-pair histogram):
// - work items are (column tile, row tile): a column tile of 1024 points (4
//   a thread, coordinates and labels in registers) against a row tile of
//   `row_tile` points staged with their labels in shared memory. Row tiles
//   run up to the column tile's end, so every pair i < j lies in one item.
//   Persistent blocks take `grab` consecutive items at a time from a global
//   counter. Only items that touch the diagonal or the last column tile
//   test indices (a failed test makes d2 NaN);
// - a row whose label lies outside [0, C) is skipped whole (the branch is
//   the same for the block); a column point's bad label makes its d2 NaN;
// - a pair's first bin comes from K7's bucket table (`_k7_table` in
//   ops/ripley.py): the bucket is the floor of float32(d2 * scale), taken by
//   adding 1.5 * 2^23 rounded toward zero, clamped to a top bucket that also
//   takes every d2 past the last threshold and NaN; the bucket's split picks
//   one of its two bins or none; a NaN split (two distinct thresholds in
//   one bucket) sends the pair to a walk of the thresholds from the
//   bucket's first bin. The wrapper packs each bucket's split and two bins
//   into 16 bytes (`_k17_table` in ops/cooccur.py), staged in shared
//   memory, so a pair's bin takes one 16-byte shared load and a select
//   (16 KB at L <= 256; 1024-4096 buckets);
// - the first bins are counted into an (L, C, C) histogram of uint32 in
//   shared memory, `copies` copies shared by the warps (one a warp for a
//   few classes, where every pair hits the same few counters), flushed into
//   the int64 global histogram after `flush_every` items (before any
//   counter could wrap) and at the end. Where one copy does not fit (C past
//   ~32 at L = 49), each pair adds to the global histogram with a 64-bit
//   atomic. A last kernel, one thread a class pair, makes the counts
//   cumulative over L. Integer sums: the result is the same every run.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kReg = 4;  // column points a thread holds, as in K7
constexpr int kCols = kThreads * kReg;
constexpr int kGrabWaves = 16;  // a grab leaves about this many grabs a block
constexpr unsigned int kFlushPairs = 0xffffffffu;  // a uint32 counter holds this many pairs
constexpr float kFloorBias = 12582912.f;  // 1.5 * 2^23: y + bias, rounded toward zero, holds floor(y) in its low bits
constexpr int kFloorBiasBits = 0x4b400000;

struct Args {
    const float* pts;
    const int* labels;
    int n, dim;
    const float* thr;
    int n_thr, n_cls;
    const int4* table;  // (n_buckets + 2): {split bits, first bin, second bin, 0} a bucket, then {scale bits, ...}
    int n_buckets, copies, row_tile, row_tiles_per_col;
    long long n_items;
    int grab, flush_every;
    unsigned long long* next;
    unsigned long long* hist;  // (n_thr, C, C) first-bin counts
};

template <int D>
__device__ __forceinline__ float pair_d2(const float* xi, const float* xj) {
    float diff = __fsub_rn(xi[0], xj[0]);
    float d2 = __fmul_rn(diff, diff);
#pragma unroll
    for (int a = 1; a < D; ++a) {
        diff = __fsub_rn(xi[a], xj[a]);
        d2 = __fadd_rn(d2, __fmul_rn(diff, diff));
    }
    return d2;
}

// What one block needs to count a pair's d2.
struct Tally {
    const int4* tab;      // (n_buckets + 1,) shared: split bits, the bins of d2 <= split and of d2 > split (-1: none)
    const float* thr;     // (n_thr,) global
    uint32_t* bins;       // SHARED: this warp's copy of the (L, C, C) counters
    unsigned long long* gbins;  // else the global (L, C, C) counts
    float thr_max, scale;
    int top, n_cls, cc;  // the top bucket; C; C * C
};

template <bool SHARED>
__device__ __forceinline__ void count_pair(const Tally& t, int k, int pair) {
    const int e = k * t.cc + pair;
    if (SHARED) atomicAdd(&t.bins[e], 1u);
    else atomicAdd(&t.gbins[e], 1ULL);
}

// Counts the R pairs of one row (d2 NaN for a masked pair) into their class
// pairs `pair[r]`, each step taken for all R before the next.
template <int R, bool SHARED>
__device__ __forceinline__ void tally(const Tally& t, const float (&d2)[R], const int (&pair)[R]) {
    int4 e[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {  // y >= 0, or NaN or inf: then the bits saturate past the top
        const int f = __float_as_int(__fadd_rz(__fmul_rn(d2[r], t.scale), kFloorBias)) - kFloorBiasBits;
        e[r] = t.tab[f < t.top ? f : t.top];
    }
    bool walk = false;
#pragma unroll
    for (int r = 0; r < R; ++r) {
        const float sp = __int_as_float(e[r].x);
        const int k = d2[r] <= sp ? e[r].y : e[r].z;  // a NaN split: the second bin, none
        if (k >= 0) count_pair<SHARED>(t, k, pair[r]);
        walk |= sp != sp;
    }
    if (walk) {
        for (int r = 0; r < R; ++r) {
            if (__int_as_float(e[r].x) == __int_as_float(e[r].x) || !(d2[r] <= t.thr_max)) continue;
            int k = e[r].y;
            while (__ldg(&t.thr[k]) < d2[r]) ++k;  // ends at thr_max
            count_pair<SHARED>(t, k, pair[r]);
        }
    }
}

// Pairs of rows [row0, i_end) (staged from `row0`) against the thread's R
// column points; MASK tests i < j (jlim 0: no column).
template <int D, int R, bool MASK, bool SHARED>
__device__ __forceinline__ void tile_pairs(const Tally& t, const float* rows, const int* rlab, const float* base,
                                           int dim, int row0, int i_end, const float (&xj)[R][D ? D : 1],
                                           const int (&lb)[R], const int (&jlim)[R], const int (&jg)[R]) {
    const float nan = __int_as_float(0x7fffffff);
    for (int i = row0; i < i_end; ++i) {
        const int la = rlab[i - row0];
        if (la < 0) continue;  // the same for every thread of the block
        float xi[D ? D : 1];
        if constexpr (D == 2) {
            const float2 v = reinterpret_cast<const float2*>(rows)[i - row0];  // one 8-byte broadcast read
            xi[0] = v.x;
            xi[1] = v.y;
        } else if constexpr (D > 0) {
#pragma unroll
            for (int a = 0; a < D; ++a) xi[a] = rows[(i - row0) * D + a];
        }
        float d2[R];
        int pair[R];
#pragma unroll
        for (int r = 0; r < R; ++r) {
            if constexpr (D > 0) {
                d2[r] = pair_d2<D>(xi, xj[r]);
            } else {  // a runtime dimension: both points read from global memory through the cache
                const float* pi = base + static_cast<long long>(i) * dim;
                const float* pj = base + static_cast<long long>(jg[r]) * dim;
                float diff = __fsub_rn(__ldg(pi), __ldg(pj));
                float v = __fmul_rn(diff, diff);
                for (int a = 1; a < dim; ++a) {
                    diff = __fsub_rn(__ldg(pi + a), __ldg(pj + a));
                    v = __fadd_rn(v, __fmul_rn(diff, diff));
                }
                d2[r] = v;
            }
            if (lb[r] < 0 || (MASK && i >= jlim[r])) d2[r] = nan;  // counted nowhere
            pair[r] = la * t.n_cls + lb[r];
        }
        tally<R, SHARED>(t, d2, pair);
    }
}


template <int D, bool SHARED>
__global__ void __launch_bounds__(kThreads) cooccur_pairs_kernel(const Args a) {
    constexpr int R = kReg;
    const int d = D ? D : a.dim;
    extern __shared__ __align__(16) int4 smem[];
    int4* tab = smem;                                                         // (n_buckets + 1,)
    float* rows = reinterpret_cast<float*>(tab + a.n_buckets + 1);            // (row_tile, D) when D > 0
    int* rlab = reinterpret_cast<int*>(rows + (D ? a.row_tile * D : 0));      // (row_tile,): a label, or -1
    uint32_t* counters = reinterpret_cast<uint32_t*>(rlab + a.row_tile);      // SHARED: copies x (L, C, C)
    __shared__ int s_ti, s_tj;
    const int cc = a.n_cls * a.n_cls;
    const int copy_words = a.n_thr * cc;
    const int n_counters = SHARED ? a.copies * copy_words : 0;
    for (int e = threadIdx.x; e < n_counters; e += kThreads) counters[e] = 0;
    for (int b = threadIdx.x; b <= a.n_buckets; b += kThreads) tab[b] = a.table[b];

    Tally t;
    t.tab = tab;
    t.thr = a.thr;
    t.bins = counters + (SHARED ? ((threadIdx.x >> 5) % a.copies) * copy_words : 0);
    t.gbins = a.hist;
    t.thr_max = a.thr[a.n_thr - 1];
    t.scale = __int_as_float(a.table[a.n_buckets + 1].x);
    t.top = a.n_buckets;
    t.n_cls = a.n_cls;
    t.cc = cc;

    // adds the block's counters to the global counts and zeroes them
    auto flush = [&]() {
        for (int e = threadIdx.x; e < copy_words; e += kThreads) {
            unsigned long long v = 0;
            for (int c = 0; c < a.copies; ++c) {
                v += counters[c * copy_words + e];
                counters[c * copy_words + e] = 0;
            }
            if (v) atomicAdd(&a.hist[e], v);
        }
    };

    int since_flush = 0;
    long long w = 0, w_end = 0;  // thread 0's grab
    for (;;) {
        if (threadIdx.x == 0) {
            if (w == w_end) {
                w = static_cast<long long>(atomicAdd(a.next, static_cast<unsigned long long>(a.grab)));
                w_end = w + a.grab < a.n_items ? w + a.grab : a.n_items;
            }
            int ti = -1, tj = 0;
            if (w < w_end) {  // w -> (tj, ti): column tile tj has (tj + 1) m row tiles
                const long long q = w / a.row_tiles_per_col;
                long long c = static_cast<long long>((sqrt(8.0 * static_cast<double>(q) + 1.0) - 1.0) * 0.5);
                while (c * (c + 1) / 2 > q) --c;
                while ((c + 1) * (c + 2) / 2 <= q) ++c;
                tj = static_cast<int>(c);
                ti = static_cast<int>(w - static_cast<long long>(a.row_tiles_per_col) * (c * (c + 1) / 2));
                ++w;
            }
            s_ti = ti;
            s_tj = tj;
        }
        __syncthreads();  // every thread is done with the last item's rows and counters
        if (s_ti < 0) break;  // uniform over the block
        if (SHARED && since_flush == a.flush_every) {
            flush();  // the __syncthreads below orders it before this item's adds
            since_flush = 0;
        }
        ++since_flush;
        const int row0 = s_ti * a.row_tile;
        const int col0 = s_tj * kCols;
        const int col_end = col0 + kCols < a.n ? col0 + kCols : a.n;
        // rows i < j <= col_end - 1; the last column tile may leave a row tile empty
        const int row_end = row0 + a.row_tile;
        const int i_end = row_end < col_end - 1 ? row_end : col_end - 1;
        const bool full = row_end <= col0 && col0 + kCols <= a.n;

        for (int e = threadIdx.x; e < a.row_tile; e += kThreads) {
            const int i = row0 + e;
            const int l = i < a.n ? a.labels[i] : -1;
            rlab[e] = l >= 0 && l < a.n_cls ? l : -1;
        }
        if (D) {
            for (int e = threadIdx.x; e < a.row_tile * (D ? D : 1); e += kThreads) {
                const long long g = static_cast<long long>(row0) * d + e;
                rows[e] = g < static_cast<long long>(a.n) * d ? a.pts[g] : 0.f;
            }
        }
        float xj[R][D ? D : 1];
        int lb[R], jlim[R], jg[R];
#pragma unroll
        for (int r = 0; r < R; ++r) {
            jg[r] = col0 + threadIdx.x + r * kThreads;
            const bool ok = jg[r] < a.n;
#pragma unroll
            for (int c = 0; c < (D ? D : 1); ++c) xj[r][c] = (D && ok) ? a.pts[static_cast<long long>(jg[r]) * d + c] : 0.f;
            const int l = ok ? a.labels[jg[r]] : -1;
            lb[r] = l >= 0 && l < a.n_cls ? l : -1;
            jlim[r] = ok ? jg[r] : 0;
            if (!ok) jg[r] = 0;  // a runtime dimension reads point 0; its d2 is masked
        }
        __syncthreads();

        if (i_end > row0) {
            if (full) tile_pairs<D, R, false, SHARED>(t, rows, rlab, a.pts, d, row0, i_end, xj, lb, jlim, jg);
            else tile_pairs<D, R, true, SHARED>(t, rows, rlab, a.pts, d, row0, i_end, xj, lb, jlim, jg);
        }
    }
    if (SHARED) flush();  // every thread passed the last barrier after its pairs
}

// one thread a class pair: its counts made cumulative over the L bins
__global__ void __launch_bounds__(kThreads) cumulate_kernel(const unsigned long long* __restrict__ hist, int n_thr,
                                                            int cc, long long* __restrict__ out) {
    const int e = blockIdx.x * kThreads + threadIdx.x;
    if (e >= cc) return;
    long long c = 0;
    for (int k = 0; k < n_thr; ++k) {
        c += static_cast<long long>(hist[static_cast<size_t>(k) * cc + e]);
        out[static_cast<size_t>(k) * cc + e] = c;
    }
}

template <int D, bool SHARED>
cudaError_t launch(Args a, cudaStream_t s) {
    if (kCols % a.row_tile != 0) return cudaErrorInvalidValue;
    const size_t copy_words = static_cast<size_t>(a.n_thr) * a.n_cls * a.n_cls;
    const size_t smem = (a.n_buckets + 1) * sizeof(int4) + ((D ? static_cast<size_t>(a.row_tile) * D : 0) +
                         a.row_tile + (SHARED ? a.copies * copy_words : 0)) * 4;
    cudaError_t err = sqt_allow_smem(cooccur_pairs_kernel<D, SHARED>, smem);
    if (err != cudaSuccess) return err;
    int per_sm = 0, dev = 0, n_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, cooccur_pairs_kernel<D, SHARED>, kThreads, smem);
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    const long long n_col_tiles = (a.n + kCols - 1) / kCols;
    a.row_tiles_per_col = kCols / a.row_tile;
    a.n_items = a.row_tiles_per_col * (n_col_tiles * (n_col_tiles + 1) / 2);
    const long long resident = static_cast<long long>(per_sm) * n_sm;
    const long long grab = a.n_items / (resident * kGrabWaves);
    a.grab = static_cast<int>(grab < 1 ? 1 : (grab > (1 << 20) ? (1 << 20) : grab));
    const long long grabs = (a.n_items + a.grab - 1) / a.grab;
    const int blocks = static_cast<int>(grabs < resident ? grabs : resident);
    // adds an item makes to one uint32 counter, at most: those of the threads sharing its copy
    if (SHARED) {
        const unsigned int sharing = kThreads / a.copies;
        const unsigned int item_pairs = static_cast<unsigned int>(a.row_tile) * kReg * sharing;
        a.flush_every = static_cast<int>(kFlushPairs / item_pairs);
    }
    cooccur_pairs_kernel<D, SHARED><<<blocks, kThreads, smem, s>>>(a);
    return cudaGetLastError();
}

template <bool SHARED>
cudaError_t dispatch(const Args& a, cudaStream_t s) {
    if (a.dim == 2) return launch<2, SHARED>(a, s);
    if (a.dim == 1) return launch<1, SHARED>(a, s);
    if (a.dim == 3) return launch<3, SHARED>(a, s);
    return launch<0, SHARED>(a, s);
}

}  // namespace

// pts (n, dim) float32; labels (n,) int32; thr (n_thr,) float32 ascending;
// table (n_buckets + 2, 4) int32 from `_k17_table`, 16-byte aligned; copies 1-8 shared
// copies of the (n_thr, n_cls, n_cls) uint32 counters, or 0 for 64-bit
// global atomics; row_tile a power of two dividing 1024; hist a zeroed
// (n_thr * n_cls * n_cls + 1) int64 scratch whose last element is the
// work-item counter; out (n_thr, n_cls, n_cls) int64, the cumulative counts
// of pairs i < j by (label_i, label_j).
SQT_EXPORT int sqt_cooccur_pairs(const float* pts, const int* labels, int n, int dim, const float* thr, int n_thr,
                                 int n_cls, const int* table, int n_buckets, int copies, int row_tile, long long* hist,
                                 long long* out, void* stream) {
    if (n < 2 || dim <= 0 || n_thr <= 0 || n_cls <= 0 || n_buckets <= 0 || n_buckets >= (1 << 22) || copies < 0 ||
        reinterpret_cast<uintptr_t>(table) % sizeof(int4) ||
        copies > kThreads / 32 || row_tile <= 0 || (row_tile & (row_tile - 1)) ||
        static_cast<long long>(n_thr) * n_cls * n_cls >= (1LL << 31)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int cc = n_cls * n_cls;
    auto* h = reinterpret_cast<unsigned long long*>(hist);
    Args a{};
    a.pts = pts;
    a.labels = labels;
    a.n = n;
    a.dim = dim;
    a.thr = thr;
    a.n_thr = n_thr;
    a.n_cls = n_cls;
    a.table = reinterpret_cast<const int4*>(table);
    a.n_buckets = n_buckets;
    a.copies = copies;
    a.row_tile = row_tile;
    a.next = h + static_cast<size_t>(n_thr) * cc;
    a.hist = h;
    const cudaError_t err = copies ? dispatch<true>(a, s) : dispatch<false>(a, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    cumulate_kernel<<<(cc + kThreads - 1) / kThreads, kThreads, 0, s>>>(h, n_thr, cc, out);
    return static_cast<int>(cudaGetLastError());
}
