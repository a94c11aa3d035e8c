// K7: Ripley's cumulative pair counts, for one point set or a batch of them.
//
// Replaces squidpy_tpu/ops/ripley.py `_pair_counts_device` (line 30) and
// `_batched_pairs_device` (line 150). There XLA computes a difference-form
// d2 block a tile pair (or a whole simulated cloud) and reduces it once per
// threshold (`lax.map` over the L thresholds), summing int32 a block and
// finishing in int64 on the host. Here, for S point sets of n points (d
// float32 coordinates each) and L squared thresholds sorted ascending, it
// writes out[s, l] = #{i < j : d2(i, j) <= thr[l]} in set s, int64, exact
// at any n (1M points have ~5e11 such pairs). d2 is the difference form in
// axis order, d2 = (x_i0 - x_j0)^2, then d2 += (x_ia - x_ja)^2, each
// subtraction, multiply and add rounded on its own (__fsub_rn, __fmul_rn,
// __fadd_rn, and --fmad=false), so the plain torch version's elementwise ops
// give the same d2 bit for bit. No tensor cores: an MMA gives the expanded
// form |x_i|^2 - 2 x_i.x_j + |x_j|^2, a different number near a threshold.
//
// Bound on the card: operations. Each of the S n (n - 1) / 2 pairs takes
// 3d - 1 flops and one compare with the largest threshold, against d * 4
// bytes of input a point: at Ripley's L mode on the main path (15 types
// of ~53k points) ~2.1e10 pairs, ~1.3e11 operations, ~1.9 ms at 67 TFLOP/s.
//
// Design (measured on the card: the pair loop is bound by the instructions
// it issues, ~10 a pair for d2 and the compare, ~10 more to find the bin):
// - work items are (set, column tile, row tile): a column tile of 1024
//   points (4 a thread, held in registers) against a row tile of
//   `row_tile` points staged in shared memory (a power of two up to 256,
//   chosen by the wrapper so that small batches still give every SM
//   several items). Row tiles run up to the column tile's end, so every
//   pair i < j lies in exactly one item. Persistent blocks take `grab`
//   consecutive items at a time from a global counter. Each staged row (one
//   broadcast read, a vector load for d = 2) serves 4 pairs. Only items
//   that touch the diagonal or the last column tile test indices (i < j,
//   j < n, a failed test makes d2 NaN); the others run without a mask;
// - a pair's bin comes from a table of equal d2 buckets over
//   [0, thr[L-1]] (`_k7_table` in ops/ripley.py, built once a support): the
//   bucket is the floor of float32(d2 * scale), taken by adding 1.5 * 2^23
//   rounded toward zero (a full-rate add, not a conversion), clamped to a
//   top bucket that also takes every d2 past the last threshold and NaN.
//   Each bucket holds a split: d2 <= split is its slot 2b, else 2b + 1, and
//   each slot maps to one bin or to none. The split is the bucket's
//   largest d2 when no threshold lies inside it, and that threshold when
//   one value does; with two or more (only where thresholds lie closer than
//   a bucket's width), it is NaN and the row walks the thresholds for that
//   pair, once, after its other pairs. The R pairs of a row take each step
//   together, without branches, so their shared loads overlap;
// - for L <= 256 the 1024 buckets' splits and the slot counters (uint32,
//   2 a bucket, a few copies each shared by two warps, with shared atomics)
//   sit in shared memory and map to the L bins only when they flush: per-
//   thread counters a bin (no atomics) and a table as bytes, one copy a
//   bank, were both measured slower, by the shared memory they took from
//   occupancy. For larger L each slot maps to its bin on the spot, through
//   the table in global memory, into shared L-bin copies (a warp's, or one)
//   or, where those do not fit, 64-bit global atomics. Shared counters
//   flush to the global int64 histogram when the block's set changes, at
//   the end, or after `flush_every` items; a last kernel (one block a set,
//   a scan) makes each set's histogram cumulative. Integer sums: the result
//   is the same every run;
// - `mode` 1 and 2 (d = 2, the slot layout) measure the parts: 1 computes
//   d2 and the compare with the largest threshold and counts in a
//   register; 2 adds the bucket, the split and the slot. Both add their
//   register sums to hist[0] and count nothing else.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kReg = 4;  // column points a thread holds: 8 took more registers and was slower on the card
constexpr int kCols = kThreads * kReg;
constexpr int kGrabWaves = 16;  // a grab leaves about this many grabs a block
constexpr unsigned int kFlushPairs = 0xffffffffu;  // a uint32 counter holds this many pairs
constexpr float kFloorBias = 12582912.f;  // 1.5 * 2^23: y + bias, rounded toward zero, holds floor(y) in its low bits
constexpr int kFloorBiasBits = 0x4b400000;

// kSlots: shared copies of the slot counters (2 a bucket) and of the bins for the walks;
// kShared: per-warp (or one) shared copies of the L bins; kGlobal: 64-bit global atomics
enum HistMode { kSlots = 0, kShared = 1, kGlobal = 2 };

struct Args {
    const float* pts;
    int n, dim;
    const float* thr;
    int n_thr;
    const int* table;  // 3 (n_buckets + 1) + 1 int32: splits, slot bins, the scale (`_k7_table`)
    int n_buckets, hmode, copies, thr_shared, row_tile, row_tiles_per_col;
    long long items_per_set, n_items;
    int grab, flush_every;
    unsigned long long* next;
    unsigned long long* hist_out;
};

// shared 32-bit words: the staged rows, thresholds, splits and counters
__host__ __device__ inline size_t slot_words(const Args& a) { return 2 * static_cast<size_t>(a.n_buckets + 1); }
__host__ __device__ inline size_t split_words(const Args& a) {
    return a.hmode == kSlots ? a.n_buckets + 1 + ((a.n_buckets + 1) & 1) : 0;  // even: the sums after are 8-byte
}
__host__ __device__ inline size_t counter_words(const Args& a) {
    if (a.hmode == kSlots) return a.copies * (slot_words(a) + a.n_thr) + 2 * static_cast<size_t>(a.n_thr);
    return a.hmode == kShared ? static_cast<size_t>(a.copies) * a.n_thr : 0;
}

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
    const float* split;   // (n_buckets + 1,): shared with kSlots, else global
    const int* slot_bin;  // (2 (n_buckets + 1),) global: a slot's bin, -1 for none
    const float* tt;      // the thresholds (shared or global)
    uint32_t* slots;      // kSlots: this warp's slot counters
    uint32_t* bins;       // kSlots: this warp's walk bins; kShared: this warp's L bins
    unsigned long long* gbins;  // kGlobal: the set's global bins
    float thr_max, scale;
    int top;              // the top bucket: y >= n_buckets, and every d2 past the last threshold
};

template <int HM>
__device__ __forceinline__ void count_bin(const Tally& t, int k) {
    if (HM == kGlobal) atomicAdd(&t.gbins[k], 1ULL);
    else atomicAdd(&t.bins[k], 1u);
}

// Counts the R pairs of one row (d2 NaN for a masked pair), each step taken
// for all R before the next, so that the R lookups overlap. A pair's bucket
// b = min(floor(d2 * scale), top); within it, d2 <= split[b] is slot 2b and
// d2 > split[b] (or NaN) slot 2b + 1. A NaN split (two distinct thresholds
// in the bucket, or none of its d2 in range) sends the pair to slot 2b + 1,
// whose bin is none, and the row, rarely, to a walk of the thresholds.
template <int R, int HM, int MODE>
__device__ __forceinline__ void tally(const Tally& t, const float (&d2)[R], unsigned int& acc) {
    if (MODE == 1) {
#pragma unroll
        for (int r = 0; r < R; ++r) acc += d2[r] <= t.thr_max;  // false for NaN
        return;
    }
    int b[R], slot[R];
    float sp[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {  // y >= 0, or NaN or inf: then the bits saturate past the top
        const int f = __float_as_int(__fadd_rz(__fmul_rn(d2[r], t.scale), kFloorBias)) - kFloorBiasBits;
        b[r] = f < t.top ? f : t.top;
        sp[r] = t.split[b[r]];
    }
    bool walk = false;
#pragma unroll
    for (int r = 0; r < R; ++r) {
        slot[r] = 2 * b[r] + !(d2[r] <= sp[r]);
        walk |= sp[r] != sp[r];
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
        if (MODE == 2) acc += static_cast<unsigned int>(slot[r]);
        else if (HM == kSlots) atomicAdd(&t.slots[slot[r]], 1u);
    }
    if (HM != kSlots && MODE == 0) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
            const int k = __ldg(&t.slot_bin[slot[r]]);
            if (k >= 0) count_bin<HM>(t, k);
        }
    }
    if (walk) {
        for (int r = 0; r < R; ++r) {
            if (sp[r] == sp[r] || !(d2[r] <= t.thr_max)) continue;
            int k = t.slot_bin[2 * b[r]];
            while (t.tt[k] < d2[r]) ++k;  // ends at thr_max
            if (MODE == 2) acc += static_cast<unsigned int>(k);
            else count_bin<HM == kSlots ? kShared : HM>(t, k);
        }
    }
}

// Pairs of rows [row0, i_end) (staged from `row0` in `rows` when D > 0)
// against the thread's R column points; MASK tests i < j (jlim 0: no column).
template <int D, int R, bool MASK, int HM, int MODE>
__device__ __forceinline__ void tile_pairs(const Tally& t, const float* rows, const float* base, int dim, int row0,
                                           int i_end, const float (&xj)[R][D ? D : 1], const int (&jlim)[R],
                                           const long long (&jg)[R], unsigned int& acc) {
    for (int i = row0; i < i_end; ++i) {
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
#pragma unroll
        for (int r = 0; r < R; ++r) {
            if constexpr (D > 0) {
                d2[r] = pair_d2<D>(xi, xj[r]);
            } else {  // a runtime dimension: both points read from global memory through the cache
                const float* pi = base + static_cast<long long>(i) * dim;
                const float* pj = base + jg[r] * dim;
                float diff = __fsub_rn(__ldg(pi), __ldg(pj));
                float v = __fmul_rn(diff, diff);
                for (int a = 1; a < dim; ++a) {
                    diff = __fsub_rn(__ldg(pi + a), __ldg(pj + a));
                    v = __fadd_rn(v, __fmul_rn(diff, diff));
                }
                d2[r] = v;
            }
            if (MASK && i >= jlim[r]) d2[r] = __int_as_float(0x7fffffff);  // NaN: counted nowhere
        }
        tally<R, HM, MODE>(t, d2, acc);
    }
}

template <int D, int MODE>
__global__ void __launch_bounds__(kThreads) ripley_pairs_kernel(const Args a) {
    constexpr int R = kReg;
    const int d = D ? D : a.dim;
    const int n_thr = a.n_thr, top = a.n_buckets;
    const int hmode = a.hmode;
    extern __shared__ __align__(16) float smem[];
    float* rows = smem;                                                   // (row_tile, D) when D > 0
    float* sthr = rows + (D ? a.row_tile * D : 0);                        // (n_thr,) when thr_shared
    float* ssplit = sthr + (a.thr_shared ? n_thr + (n_thr & 1) : 0);      // (n_buckets + 1,) with kSlots
    unsigned long long* sum = reinterpret_cast<unsigned long long*>(ssplit + split_words(a));  // kSlots: (n_thr,)
    uint32_t* counters = reinterpret_cast<uint32_t*>(sum + (hmode == kSlots ? n_thr : 0));
    __shared__ int s_set, s_ti, s_tj;
    const int warp = threadIdx.x >> 5;
    const int n_slots = static_cast<int>(slot_words(a));
    const int copy_words = hmode == kSlots ? n_slots + n_thr : n_thr;  // a copy: its slots, then its L bins
    const int n_counters = hmode == kGlobal ? 0 : a.copies * copy_words;

    if (a.thr_shared) {
        for (int k = threadIdx.x; k < n_thr; k += kThreads) sthr[k] = a.thr[k];
    }
    if (hmode == kSlots) {
        for (int b = threadIdx.x; b <= top; b += kThreads) ssplit[b] = __int_as_float(a.table[b]);
        for (int k = threadIdx.x; k < n_thr; k += kThreads) sum[k] = 0;
    }
    for (int e = threadIdx.x; e < n_counters; e += kThreads) counters[e] = 0;

    Tally t;
    t.split = hmode == kSlots ? ssplit : reinterpret_cast<const float*>(a.table);
    t.slot_bin = a.table + (top + 1);
    t.tt = a.thr_shared ? sthr : a.thr;
    uint32_t* mine = counters + (hmode == kGlobal ? 0 : (warp % a.copies) * copy_words);
    t.slots = mine;
    t.bins = hmode == kSlots ? mine + n_slots : mine;
    t.gbins = a.hist_out;
    t.thr_max = a.thr[n_thr - 1];
    t.scale = __int_as_float(a.table[3 * (top + 1)]);
    t.top = top;
    unsigned int acc = 0;  // the measuring modes' sink

    int cur_set = -1, since_flush = 0;
    long long w = 0, w_end = 0;  // thread 0's grab
    // adds the block's counters to set `cur_set`'s global bins and zeroes them
    auto flush = [&]() {
        unsigned long long* out = a.hist_out + static_cast<size_t>(cur_set) * n_thr;
        if (hmode == kSlots) {  // slots and walk bins to bins in shared 64-bit sums, then L global adds
            for (int e = threadIdx.x; e < copy_words; e += kThreads) {
                unsigned long long v = 0;
                for (int c = 0; c < a.copies; ++c) {
                    v += counters[c * copy_words + e];
                    counters[c * copy_words + e] = 0;
                }
                const int k = e < n_slots ? __ldg(&t.slot_bin[e]) : e - n_slots;
                if (v && k >= 0) atomicAdd(&sum[k], v);
            }
            __syncthreads();
            for (int k = threadIdx.x; k < n_thr; k += kThreads) {
                if (sum[k]) atomicAdd(&out[k], sum[k]);
                sum[k] = 0;
            }
        } else {
            for (int k = threadIdx.x; k < n_thr; k += kThreads) {
                unsigned long long v = 0;
                for (int c = 0; c < a.copies; ++c) {
                    v += counters[c * n_thr + k];
                    counters[c * n_thr + k] = 0;
                }
                if (v) atomicAdd(&out[k], v);
            }
        }
    };

    for (;;) {
        if (threadIdx.x == 0) {
            if (w == w_end) {
                w = static_cast<long long>(atomicAdd(a.next, static_cast<unsigned long long>(a.grab)));
                w_end = w + a.grab < a.n_items ? w + a.grab : a.n_items;
            }
            int set = -1, ti = 0, tj = 0;
            if (w < w_end) {  // w -> (set, p); p -> (tj, ti): column tile tj has (tj + 1) m row tiles
                set = static_cast<int>(w / a.items_per_set);
                const long long p = w - static_cast<long long>(set) * a.items_per_set;
                const long long q = p / a.row_tiles_per_col;
                long long c = static_cast<long long>((sqrt(8.0 * static_cast<double>(q) + 1.0) - 1.0) * 0.5);
                while (c * (c + 1) / 2 > q) --c;
                while ((c + 1) * (c + 2) / 2 <= q) ++c;
                tj = static_cast<int>(c);
                ti = static_cast<int>(p - static_cast<long long>(a.row_tiles_per_col) * (c * (c + 1) / 2));
                ++w;
            }
            s_set = set;
            s_ti = ti;
            s_tj = tj;
        }
        __syncthreads();  // every thread is done with the last item's rows and counters
        const int set = s_set;
        if (set < 0) break;  // uniform over the block
        if (!MODE && hmode != kGlobal && (set != cur_set || since_flush == a.flush_every)) {
            if (cur_set >= 0) flush();  // the __syncthreads below orders it before this item's adds
            since_flush = 0;
        }
        cur_set = set;
        ++since_flush;
        t.gbins = a.hist_out + static_cast<size_t>(set) * n_thr;
        const float* base = a.pts + static_cast<size_t>(set) * a.n * d;
        const int row0 = s_ti * a.row_tile;
        const long long col0 = static_cast<long long>(s_tj) * kCols;
        const long long col_end = col0 + kCols < a.n ? col0 + kCols : a.n;
        // rows i < j <= col_end - 1; the last column tile may leave a row tile empty
        const long long row_end = static_cast<long long>(row0) + a.row_tile;
        const int i_end = static_cast<int>(row_end < col_end - 1 ? row_end : col_end - 1);
        const bool full = row_end <= col0 && col0 + kCols <= a.n;

        if (D) {
            for (int e = threadIdx.x; e < a.row_tile * (D ? D : 1); e += kThreads) {
                const long long g = static_cast<long long>(row0) * d + e;
                rows[e] = g < static_cast<long long>(a.n) * d ? base[g] : 0.f;
            }
        }
        float xj[R][D ? D : 1];
        int jlim[R];
        long long jg[R];
#pragma unroll
        for (int r = 0; r < R; ++r) {
            jg[r] = col0 + threadIdx.x + r * kThreads;
            const bool ok = jg[r] < a.n;
#pragma unroll
            for (int c = 0; c < (D ? D : 1); ++c) xj[r][c] = (D && ok) ? base[jg[r] * d + c] : 0.f;
            jlim[r] = ok ? static_cast<int>(jg[r]) : 0;
        }
        __syncthreads();

        if (i_end > row0) {
#define SQT_K7_PAIRS(HM, MODE_)                                                                          \
    do {                                                                                                 \
        if (full) tile_pairs<D, R, false, HM, MODE_>(t, rows, base, d, row0, i_end, xj, jlim, jg, acc);  \
        else tile_pairs<D, R, true, HM, MODE_>(t, rows, base, d, row0, i_end, xj, jlim, jg, acc);        \
    } while (0)
            if (MODE) SQT_K7_PAIRS(kSlots, MODE);  // the measuring modes run on the slot layout only
            else if (hmode == kSlots) SQT_K7_PAIRS(kSlots, 0);
            else if (hmode == kShared) SQT_K7_PAIRS(kShared, 0);
            else SQT_K7_PAIRS(kGlobal, 0);
#undef SQT_K7_PAIRS
        }
    }
    if (!MODE && hmode != kGlobal && cur_set >= 0) flush();  // every thread passed the last barrier after its pairs
    if (MODE && acc) atomicAdd(a.hist_out, static_cast<unsigned long long>(acc));
}

// one block a set: each thread sums a run of bins, a scan of the runs in
// shared memory, then each thread writes its run's cumulative counts
__global__ void __launch_bounds__(kThreads) cumulate_kernel(const unsigned long long* __restrict__ hist, int n_thr,
                                                            long long* __restrict__ out) {
    __shared__ long long run[kThreads];
    const unsigned long long* h = hist + static_cast<size_t>(blockIdx.x) * n_thr;
    long long* o = out + static_cast<size_t>(blockIdx.x) * n_thr;
    const int per = (n_thr + kThreads - 1) / kThreads;
    const int k0 = threadIdx.x * per, k1 = k0 + per < n_thr ? k0 + per : n_thr;
    long long sum = 0;
    for (int k = k0; k < k1; ++k) sum += static_cast<long long>(h[k]);
    run[threadIdx.x] = sum;
    __syncthreads();
    for (int off = 1; off < kThreads; off <<= 1) {  // inclusive scan of the runs
        const long long v = threadIdx.x >= off ? run[threadIdx.x - off] : 0;
        __syncthreads();
        run[threadIdx.x] += v;
        __syncthreads();
    }
    long long c = run[threadIdx.x] - sum;
    for (int k = k0; k < k1; ++k) {
        c += static_cast<long long>(h[k]);
        o[k] = c;
    }
}

template <int D, int MODE>
cudaError_t launch(Args a, int n_sets, cudaStream_t s) {
    if (kCols % a.row_tile != 0) return cudaErrorInvalidValue;
    const size_t smem = ((D ? static_cast<size_t>(a.row_tile) * D : 0) + (a.thr_shared ? a.n_thr + (a.n_thr & 1) : 0) +
                         split_words(a) +
                         counter_words(a)) * 4;
    cudaError_t err = sqt_allow_smem(ripley_pairs_kernel<D, MODE>, smem);
    if (err != cudaSuccess) return err;
    int per_sm = 0, dev = 0, n_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ripley_pairs_kernel<D, MODE>, kThreads, smem);
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    const long long n_col_tiles = (a.n + kCols - 1) / kCols;
    a.row_tiles_per_col = kCols / a.row_tile;
    a.items_per_set = a.row_tiles_per_col * (n_col_tiles * (n_col_tiles + 1) / 2);
    a.n_items = a.items_per_set * n_sets;
    const long long resident = static_cast<long long>(per_sm) * n_sm;
    const long long grab = a.n_items / (resident * kGrabWaves);
    a.grab = static_cast<int>(grab < 1 ? 1 : (grab > (1 << 20) ? (1 << 20) : grab));
    const long long grabs = (a.n_items + a.grab - 1) / a.grab;
    const int blocks = static_cast<int>(grabs < resident ? grabs : resident);
    // adds an item makes to one uint32 counter, at most: those of the threads sharing it
    const unsigned int sharing = kThreads / (a.copies ? a.copies : 1);
    const unsigned int item_pairs = static_cast<unsigned int>(a.row_tile) * kReg * sharing;
    a.flush_every = static_cast<int>(kFlushPairs / item_pairs);
    ripley_pairs_kernel<D, MODE><<<blocks, kThreads, smem, s>>>(a);
    return cudaGetLastError();
}

template <int MODE>
cudaError_t dispatch(const Args& a, int n_sets, cudaStream_t s) {
    if (MODE && (a.dim != 2 || a.hmode != kSlots)) return cudaErrorInvalidValue;
    if (a.dim == 2) return launch<2, MODE>(a, n_sets, s);
    if (MODE) return cudaErrorInvalidValue;
    if (a.dim == 1) return launch<1, 0>(a, n_sets, s);
    if (a.dim == 3) return launch<3, 0>(a, n_sets, s);
    return launch<0, 0>(a, n_sets, s);
}

}  // namespace

// pts (n_sets, n, dim) float32; thr (n_thr,) float32 ascending; table
// (3 (n_buckets + 1) + 1,) int32 from `_k7_table`; hmode 0 (slot counters
// and the splits in shared memory), 1 or 2 (L bins: `copies` shared copies,
// or global atomics; the table read from global memory); copies 1-8 unless
// hmode is 2; thr_shared whether the thresholds fit in shared memory;
// row_tile a power of two dividing 1024; mode 0 counts, 1 and 2
// measure (d = 2, hmode 0); hist a zeroed (n_sets * n_thr + 1) int64
// scratch whose last element is the work-item counter; out (n_sets, n_thr)
// int64, the cumulative counts of pairs i < j.
SQT_EXPORT int sqt_ripley_pairs(const float* pts, int n_sets, int n, int dim, const float* thr, int n_thr,
                                const int* table, int n_buckets, int hmode, int copies, int thr_shared, int row_tile,
                                int mode, long long* hist, long long* out, void* stream) {
    if (n_sets <= 0 || n < 2 || dim <= 0 || n_thr <= 0 || n_buckets <= 0 || n_buckets >= (1 << 22) || hmode < 0 ||
        hmode > 2 || (hmode != kGlobal && (copies < 1 || copies > kThreads / 32)) ||
        (hmode == kSlots && !thr_shared) || row_tile <= 0 || (row_tile & (row_tile - 1)) ||
        mode < 0 || mode > 2) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    auto* h = reinterpret_cast<unsigned long long*>(hist);
    Args a{};
    a.pts = pts;
    a.n = n;
    a.dim = dim;
    a.thr = thr;
    a.n_thr = n_thr;
    a.table = table;
    a.n_buckets = n_buckets;
    a.hmode = hmode;
    a.copies = hmode == kGlobal ? 0 : copies;
    a.thr_shared = thr_shared;
    a.row_tile = row_tile;
    a.next = h + static_cast<size_t>(n_sets) * n_thr;
    a.hist_out = h;
    cudaError_t err = mode == 0 ? dispatch<0>(a, n_sets, s) : (mode == 1 ? dispatch<1>(a, n_sets, s) : dispatch<2>(a, n_sets, s));
    if (err != cudaSuccess) return static_cast<int>(err);
    if (mode) return static_cast<int>(cudaGetLastError());
    cumulate_kernel<<<n_sets, kThreads, 0, s>>>(h, n_thr, out);
    return static_cast<int>(cudaGetLastError());
}
