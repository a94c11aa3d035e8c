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
// one class hold 4.9e9 pairs), i < j by the caller's index. A label outside
// [0, C) is counted nowhere (the -1 of a NaN cell), and so is a NaN d2. d2 is
// the difference form in axis order, each subtraction, multiply and add
// rounded on its own (__fsub_rn, __fmul_rn, __fadd_rn, and --fmad=false), as
// the plain torch version's elementwise ops round it, so the counts agree bit
// for bit.
//
// Bound on the card: operations. Each of the n (n - 1) / 2 pairs takes 3d - 1
// flops of d2 and one compare with the largest threshold, against d * 4 + 4
// bytes of input a point: at 99,000 points in 2-D, 4.9e9 pairs, ~3.4e10
// operations, ~0.5 ms at 67 TFLOP/s. The class route's own floor is its
// instructions: 24 a pair in 2-D off the diagonal (the SASS of the loop
// over a row's 4 pairs, counted in the built library by chip_smoke.py
// `_k17_instructions_per_pair`), ~3.5 ms at four warp instructions a clock
// on each of 132 SMs at 1.98 GHz.
//
// Design: two routes, chosen by shape in ops/cooccur.py `_k17_layout`.
//
// The class route (`sqt_cooccur_pairs`; the lookup of a pair's bin and its
// count, not its d2, set the earlier design's time):
// - a one-block kernel puts the points in class order (a counting sort of
//   the labels: counts, their prefix, then each warp's points of a class
//   placed together by one shared atomic; points outside [0, C) drop out;
//   within a class any order), keeping each point's index in the caller's
//   order, then cuts each class into row tiles of `row_tile` points and
//   column tiles of 1024 (4 a thread, in registers) and lists, for each row
//   tile of class a, the column tiles it meets: those of class a from the
//   one holding its first row (the upper triangle), then every column tile
//   of the classes after a. A work item is (row tile, column tile), so its
//   pairs all belong to one class pair (a, b), a <= b. Persistent blocks
//   take `grab` consecutive items from a global counter; warp 0 finds an
//   item's row tile by a 32-way search of the item offsets. A column tile
//   shorter than 1024 runs 1, 2 or 4 points a thread;
// - every pair of an item adds to (., a, b) or, when b > a and the row's
//   index in the caller's order is the higher, to (., b, a), two rows of
//   counters apart. Each lane owns its 2 (L + 2) uint32 counters in shared
//   memory, shared by the block's 8 warps, laid out [bin][lane] (a warp's
//   32 adds hit 32 banks, as shared atomic increments, which unlike a
//   thread's own plain loads and stores do not wait on each other); they
//   are summed into the int64 global counts when the block's class pair
//   changes, every `flush_every` items (before one could wrap) and at the
//   end. The histogram does not grow with C;
// - a pair's bin, searchsorted's first threshold with d2 <= thr, over the
//   distinct thresholds (the wrapper repeats a repeated one's counts): the
//   bucket is the floor of float32(d2 * scale), taken by adding 1.5 * 2^23
//   rounded toward zero, clamped to a top bucket that also takes every d2
//   past the last threshold and NaN. A byte table gives each bucket the
//   count `e` of thresholds up to its largest d2, and the bin is e less the
//   thresholds thr[e - 1] (and thr[e - 2] where a bucket holds two) that
//   are >= d2: those inside the bucket may be, one below it never is. Both
//   tables are copied once a lane in shared memory, so each load hits the
//   lane's own bank. Where a bucket holds three or more thresholds, its
//   byte is the junk bin L + 1 and a variant of the kernel walks those
//   pairs' thresholds from the bucket's first after the row's other pairs
//   (the walk's code slows the loop even where no pair takes it). Bin L
//   takes the pairs counted nowhere.
//
// The index route (`sqt_cooccur_pairs_index`, the earlier design, for more
// thresholds than a bucket's byte holds): the points in the caller's order,
// column tiles of 1024 against row tiles up to the column tile's end, a
// pair's first bin from K7's bucket table (ops/ripley.py `_k7_table`: a
// split and two slot bins a bucket, or a walk), packed 16 bytes a bucket in
// shared memory, counted into `copies` shared copies of an (L, C, C) uint32
// histogram (or 64-bit global atomics where one copy does not fit).
//
// `mode` 1 and 2 (d = 2) measure the parts of a route: 1 computes d2 and the
// bin and sums the bins in a register, summed over the warp and written
// once; 2 adds each pair to one fixed counter a lane. Neither counts. A last kernel, one thread a class
// pair, makes the counts cumulative over L. Integer sums: the result is the
// same every run.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kReg = 4;  // column points a thread holds, as in K7
constexpr int kCols = kThreads * kReg;
constexpr int kGrabWaves = 16;  // a grab leaves about this many grabs a block
constexpr unsigned int kFlushPairs = 0xffffffffu;  // a uint32 counter holds this many pairs
constexpr float kFloorBias = 12582912.f;  // 1.5 * 2^23: y + bias, rounded toward zero, holds floor(y) in its low bits
constexpr int kFloorBiasBits = 0x4b400000;
constexpr int kScanThreads = 1024;

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

// d2 of rows i and j of a (., dim) array read through the cache: a runtime dimension
__device__ __forceinline__ float pair_d2_rt(const float* base, int dim, int i, int j) {
    const float* pi = base + static_cast<long long>(i) * dim;
    const float* pj = base + static_cast<long long>(j) * dim;
    float diff = __fsub_rn(__ldg(pi), __ldg(pj));
    float v = __fmul_rn(diff, diff);
    for (int a = 1; a < dim; ++a) {
        diff = __fsub_rn(__ldg(pi + a), __ldg(pj + a));
        v = __fadd_rn(v, __fmul_rn(diff, diff));
    }
    return v;
}

// the measuring modes' sink: each thread's register, summed over its warp
// and written once
__device__ __forceinline__ void sink(unsigned int acc, unsigned long long* out) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, o);
    if ((threadIdx.x & 31) == 0 && acc) atomicAdd(out, static_cast<unsigned long long>(acc));
}

// the bucket of d2 >= 0 (or NaN, or inf: then the bits saturate past the top)
__device__ __forceinline__ int bucket_of(float d2, float scale, int top) {
    const int f = __float_as_int(__fadd_rz(__fmul_rn(d2, scale), kFloorBias)) - kFloorBiasBits;
    return f < top ? f : top;
}

// ============================================================ the class route

struct ClassArgs {
    const float* src;    // (n, dim) the caller's points
    const int* labels;   // (n,) the caller's labels
    float* pts;          // (n, dim) scratch: the points of classes [0, C) in class order
    int* orig;           // (n,) scratch: each one's index in the caller's order
    int* starts;         // (C + 1,) scratch: class c's points are [starts[c], starts[c + 1])
    int n, dim, n_thr, n_cls;
    const unsigned* bins;  // (n_buckets / 4 + 1) * 32 words: bucket b's byte at [b / 4][lane][b % 4]
    const float* thr;      // (n_thr + 3) * 32: [r][lane] holds thr[r - 2]; rows 0, 1 and n_thr + 2 are -inf
    const int* first;      // (n_buckets + 1,): the thresholds below each bucket's least d2
    float scale;
    int n_buckets, row_tile;
    int max_row_tiles, max_col_tiles;
    long long* header;       // [0] the next item, [1] the items, [2] the row tiles
    long long* row_items;    // (max_row_tiles + 1,) the items before each row tile
    int4* row_tiles;         // {row0, row_end, class, first column tile}
    int4* col_tiles;         // {col0, col_end, class, 0}
    int flush_every;
    unsigned long long* hist;  // (n_thr, C, C) first-bin counts
};

// exclusive prefix of v over the kScanThreads threads of the block; total: the sum
template <typename T>
__device__ __forceinline__ T block_exclusive(T v, T* s_warp, T& total) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    T x = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const T y = __shfl_up_sync(0xffffffffu, x, o);
        if (lane >= o) x += y;
    }
    if (lane == 31) s_warp[warp] = x;
    __syncthreads();
    if (warp == 0) {
        T s = s_warp[lane];
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const T y = __shfl_up_sync(0xffffffffu, s, o);
            if (lane >= o) s += y;
        }
        s_warp[lane] = s;  // inclusive over warps
    }
    __syncthreads();
    const T before = (warp ? s_warp[warp - 1] : T(0)) + x - v;
    total = s_warp[31];
    __syncthreads();  // s_warp is reused by the next call
    return before;
}

constexpr int kOrderBatch = 4;  // chunks of 1024 points whose labels one pass loads at once

// The class order of kOrderBatch chunks of 1024 points from `base`, a
// point a thread a chunk: each warp's points of one class take consecutive
// places from that class's cursor, in lane order; the warps take the
// cursors in any order, so a class's points end in any order. WRITE copies
// each point and its index to its place; else only the counts are taken.
template <bool WRITE>
__device__ __forceinline__ void place_batch(const ClassArgs& a, int* cursor, int base) {
    const int lane = threadIdx.x & 31;
    int key[kOrderBatch];
#pragma unroll
    for (int c = 0; c < kOrderBatch; ++c) {  // the loads first, so their latencies overlap
        const int i = base + c * kScanThreads + static_cast<int>(threadIdx.x);
        const int l = i < a.n ? __ldg(&a.labels[i]) : -1;
        key[c] = l >= 0 && l < a.n_cls ? l : -1;  // -1: counted nowhere
    }
#pragma unroll
    for (int c = 0; c < kOrderBatch; ++c) {
        const unsigned int peers = __match_any_sync(0xffffffffu, key[c]);
        const int leader = __ffs(peers) - 1;
        int at = 0;
        if (lane == leader && key[c] >= 0) at = atomicAdd(&cursor[key[c]], __popc(peers));
        if (!WRITE) continue;
        at = __shfl_sync(0xffffffffu, at, leader) + __popc(peers & ((1u << lane) - 1));
        if (key[c] < 0) continue;
        const int i = base + c * kScanThreads + static_cast<int>(threadIdx.x);
        const float* __restrict__ src = a.src + static_cast<long long>(i) * a.dim;
        float* __restrict__ dst = a.pts + static_cast<long long>(at) * a.dim;
        a.orig[at] = i;
        for (int d = 0; d < a.dim; ++d) dst[d] = __ldg(src + d);
    }
}

// One block: the class order (a counting sort of the labels: counts, their
// prefix, the scatter), then the column tiles, the row tiles and each row
// tile's item offset, from the class segments. Column tiles are listed
// class by class; a row tile of class a meets the column tiles from the one
// of class a that holds its first row to the last of all.
__global__ void __launch_bounds__(kScanThreads) order_kernel(const ClassArgs a) {
    __shared__ long long s_warp[32];
    extern __shared__ int cursor[];  // (C,)
    for (int c = threadIdx.x; c < a.n_cls; c += kScanThreads) cursor[c] = 0;
    __syncthreads();
    for (int base = 0; base < a.n; base += kOrderBatch * kScanThreads) place_batch<false>(a, cursor, base);  // the counts
    __syncthreads();
    long long carry = 0, placed = 0;
    for (int c0 = 0; c0 <= a.n_cls; c0 += kScanThreads) {
        const int c = c0 + threadIdx.x;
        const long long v = c < a.n_cls ? cursor[c] : 0;
        const long long at = carry + block_exclusive(v, s_warp, placed);
        carry += placed;
        if (c < a.n_cls) cursor[c] = static_cast<int>(at);
        if (c <= a.n_cls) a.starts[c] = static_cast<int>(at);
    }
    __syncthreads();
    for (int base = 0; base < a.n; base += kOrderBatch * kScanThreads) place_batch<true>(a, cursor, base);
    __syncthreads();  // the block's writes of starts are seen below

    const int per_col = kCols / a.row_tile;  // row tiles a column tile spans
    long long ct_carry = 0, total = 0;
    // the column tiles
    for (int c0 = 0; c0 < a.n_cls; c0 += kScanThreads) {
        const int c = c0 + threadIdx.x;
        const int s = c < a.n_cls ? a.starts[c] : 0, e = c < a.n_cls ? a.starts[c + 1] : 0;
        const long long ct = (e - s + kCols - 1) / kCols;
        const long long cs = ct_carry + block_exclusive(ct, s_warp, total);
        ct_carry += total;
        for (long long t = 0; t < ct; ++t) {
            const int col0 = s + static_cast<int>(t) * kCols;
            a.col_tiles[cs + t] = make_int4(col0, min(col0 + kCols, e), c, 0);
        }
    }
    const long long n_ct = ct_carry;
    // the row tiles and their items: class a's tile t meets n_ct - (cs_a + t / per_col) column tiles
    long long cs_carry = 0, rt_carry = 0, item_carry = 0;
    for (int c0 = 0; c0 < a.n_cls; c0 += kScanThreads) {
        const int c = c0 + threadIdx.x;
        const int s = c < a.n_cls ? a.starts[c] : 0, e = c < a.n_cls ? a.starts[c + 1] : 0;
        const long long ct = (e - s + kCols - 1) / kCols;
        const long long rt = (e - s + a.row_tile - 1) / a.row_tile;
        const long long cs = cs_carry + block_exclusive(ct, s_warp, total);
        cs_carry += total;
        const long long q = rt / per_col, r = rt % per_col;  // sum over t < rt of t / per_col
        const long long items = rt * (n_ct - cs) - (per_col * q * (q - 1) / 2 + r * q);
        const long long rs = rt_carry + block_exclusive(rt, s_warp, total);
        rt_carry += total;
        long long io = item_carry + block_exclusive(items, s_warp, total);
        item_carry += total;
        for (long long t = 0; t < rt; ++t) {
            const int row0 = s + static_cast<int>(t) * a.row_tile;
            const long long lo = cs + t / per_col;
            a.row_tiles[rs + t] = make_int4(row0, min(row0 + a.row_tile, e), c, static_cast<int>(lo));
            a.row_items[rs + t] = io;
            io += n_ct - lo;
        }
    }
    if (threadIdx.x == 0) {
        a.row_items[rt_carry] = item_carry;
        a.header[1] = item_carry;
        a.header[2] = rt_carry;
    }
}

// What one block needs to count a pair's d2 on the class route: byte
// offsets into the block's shared memory, indexed there directly (so that
// every access is a shared load or a shared atomic), each with this lane's
// column added. Counters, thresholds and bucket bytes take 128 bytes a row
// (a word a lane), so bin k's counter lies at the offset of threshold row k.
struct Lane {
    int cnt[2];   // the counters of (a, b) and of (b, a): bin k at cnt + k * 128
    int thr;      // thr[e - 2] at thr + e * 128, thr[e - 1] a row on
    int bins;     // bucket b's byte at bins + (b / 4) * 128 + b % 4
    const int* first;  // global
    float scale;
    int top, n_thr, junk;
};

extern __shared__ __align__(16) uint32_t k17_smem[];

// Pairs of rows [row0, i_end) (staged from `row0`) against the thread's R
// column points; MASK makes a pair with i >= j NaN; DIR counts a pair whose
// row has the higher index in the caller's order as (b, a). TAB: the most
// thresholds a bucket holds, 1 or 2, compared with d2 (thr[e - 1], and
// thr[e - 2]); 3: more, in some bucket whose byte is then the junk bin
// L + 1, and those pairs walk the thresholds from the bucket's first after
// the row's other pairs.
template <int D, int R, bool MASK, bool DIR, int TAB, int MODE>
__device__ __forceinline__ void class_pairs(const Lane& t, const float* rows, const int* rorig, const float* base,
                                            int dim, int row0, int i_end, const float (&xj)[R][D ? D : 1],
                                            const int (&oj)[R], const int (&jg)[R], unsigned int& acc) {
    const float nan = __int_as_float(0x7fffffff);
    char* smem = reinterpret_cast<char*>(k17_smem);
    for (int i = row0; i < i_end; ++i) {
        float xi[D ? D : 1];
        if constexpr (D == 2) {
            const float2 v = reinterpret_cast<const float2*>(rows)[i - row0];  // one 8-byte broadcast read
            xi[0] = v.x;
            xi[1] = v.y;
        } else if constexpr (D > 0) {
#pragma unroll
            for (int c = 0; c < D; ++c) xi[c] = rows[(i - row0) * D + c];
        }
        const int oi = DIR ? rorig[i - row0] : 0;
        float d2[R];
        int b[R], e[R];
#pragma unroll
        for (int r = 0; r < R; ++r) {
            if constexpr (D > 0) d2[r] = pair_d2<D>(xi, xj[r]);
            else d2[r] = pair_d2_rt(base, dim, i, jg[r] < 0 ? 0 : jg[r]);
            if ((MASK || D == 0) && i >= jg[r]) d2[r] = nan;  // counted nowhere
            b[r] = bucket_of(d2[r], t.scale, t.top);
        }
#pragma unroll
        for (int r = 0; r < R; ++r)
            e[r] = static_cast<unsigned char>(smem[t.bins + (b[r] << 5) - 31 * (b[r] & 3)]);  // (b / 4) * 128 + b % 4
        bool walk = false;
#pragma unroll
        for (int r = 0; r < R; ++r) {
            const int row = e[r] << 7;
            // bin e less the thresholds inside the bucket at or above d2; one below it is below d2
            const bool one = *reinterpret_cast<const float*>(smem + t.thr + 128 + row) >= d2[r];
            const bool two = TAB >= 2 && *reinterpret_cast<const float*>(smem + t.thr + row) >= d2[r];
            const int at = (DIR && oi > oj[r] ? t.cnt[1] : t.cnt[0]) + row - (one ? 128 : 0) - (two ? 128 : 0);
            if (TAB == 3) walk |= e[r] == t.junk;
            if (MODE == 0) atomicAdd(reinterpret_cast<uint32_t*>(smem + at), 1u);
            else if (MODE == 1) acc += static_cast<unsigned int>(at);
            else atomicAdd(reinterpret_cast<uint32_t*>(smem + t.cnt[0] + (t.n_thr << 7)), static_cast<unsigned int>(at));
        }
        if (TAB == 3 && MODE == 0 && walk) {  // searchsorted from the bucket's first threshold
#pragma unroll
            for (int r = 0; r < R; ++r) {
                if (e[r] != t.junk) continue;
                int kk = __ldg(&t.first[b[r]]);
                while (kk < t.n_thr && !(*reinterpret_cast<const float*>(smem + t.thr + ((kk + 2) << 7)) >= d2[r])) ++kk;
                atomicAdd(reinterpret_cast<uint32_t*>(smem + (DIR && oi > oj[r] ? t.cnt[1] : t.cnt[0]) + (kk << 7)), 1u);
            }
        }
    }
}

template <int D, int TAB, int MODE>
__global__ void __launch_bounds__(kThreads, 2) class_sweep_kernel(const ClassArgs a) {
    const int d = D ? D : a.dim;
    const int n_thr = a.n_thr, rows_cnt = n_thr + 2;  // bins 0..L-1, L counted nowhere, L + 1 walks
    uint32_t* counters = k17_smem;                                          // (2, L + 2, 32)
    float* thr = reinterpret_cast<float*>(counters + 2 * rows_cnt * 32);    // (L + 3, 32)
    unsigned* bins = reinterpret_cast<unsigned*>(thr + (n_thr + 3) * 32);   // (n_buckets / 4 + 1, 32)
    float* rows = reinterpret_cast<float*>(bins + (a.n_buckets / 4 + 1) * 32);  // (row_tile, D) when D > 0
    int* rorig = reinterpret_cast<int*>(rows + (D ? a.row_tile * D : 0));   // (row_tile,)
    __shared__ int4 s_row, s_col;
    __shared__ int s_more;
    for (int e = threadIdx.x; e < 2 * rows_cnt * 32; e += kThreads) counters[e] = 0;
    for (int e = threadIdx.x; e < (n_thr + 3) * 32; e += kThreads) thr[e] = a.thr[e];
    for (int e = threadIdx.x; e < (a.n_buckets / 4 + 1) * 32; e += kThreads) bins[e] = a.bins[e];

    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    Lane t;
    t.cnt[0] = lane * 4;
    t.cnt[1] = (rows_cnt * 32 + lane) * 4;
    t.thr = static_cast<int>(reinterpret_cast<char*>(thr) - reinterpret_cast<char*>(k17_smem)) + lane * 4;
    t.bins = static_cast<int>(reinterpret_cast<char*>(bins) - reinterpret_cast<char*>(k17_smem)) + lane * 4;
    t.first = a.first;
    t.scale = a.scale;
    t.top = a.n_buckets;
    t.n_thr = n_thr;
    t.junk = n_thr + 1;

    // adds the block's counters of class pair (ca, cb) to the global counts and zeroes them
    auto flush = [&](int ca, int cb) {
        for (int k = warp; k < n_thr; k += kWarps) {
            unsigned int lo = counters[k * 32 + lane], hi = counters[(rows_cnt + k) * 32 + lane];
            counters[k * 32 + lane] = 0;
            counters[(rows_cnt + k) * 32 + lane] = 0;
#pragma unroll
            for (int o = 16; o > 0; o >>= 1) {
                lo += __shfl_down_sync(0xffffffffu, lo, o);
                hi += __shfl_down_sync(0xffffffffu, hi, o);
            }
            if (lane == 0) {
                const size_t cc = static_cast<size_t>(a.n_cls) * a.n_cls;
                if (lo) atomicAdd(&a.hist[k * cc + static_cast<size_t>(ca) * a.n_cls + cb], static_cast<unsigned long long>(lo));
                if (hi) atomicAdd(&a.hist[k * cc + static_cast<size_t>(cb) * a.n_cls + ca], static_cast<unsigned long long>(hi));
            }
        }
    };

    const long long n_items = a.header[1];
    const int n_rt = static_cast<int>(a.header[2]);
    long long w = 0, w_end = 0;  // warp 0's grab
    int r_tile = 0;              // warp 0: the row tile of the last item, P[r_tile] <= w
    long long grab = 1;
    {
        const long long g = n_items / (static_cast<long long>(gridDim.x) * kGrabWaves);
        grab = g < 1 ? 1 : g;
    }
    int cur_a = -1, cur_b = -1, since_flush = 0;
    unsigned int acc = 0;  // the measuring mode 1's sink
    for (;;) {
        if (warp == 0) {
            if (lane == 0 && w == w_end) {
                w = static_cast<long long>(atomicAdd(reinterpret_cast<unsigned long long*>(a.header), grab));
                w_end = w + grab < n_items ? w + grab : n_items;
            }
            w = __shfl_sync(0xffffffffu, w, 0);
            w_end = __shfl_sync(0xffffffffu, w_end, 0);
            const bool more = w < w_end;
            if (more) {  // the last row tile with P <= w, by 32-way steps from the last one
                int lo = r_tile, hi = n_rt;
                while (hi - lo > 1) {
                    const int step = (hi - lo + 31) >> 5;
                    const int pos = lo + lane * step;
                    const unsigned int le = __ballot_sync(0xffffffffu, pos < hi && a.row_items[pos] <= w);
                    lo += (31 - __clz(le)) * step;  // lane 0's probe, P[lo] <= w, always holds
                    hi = lo + step < hi ? lo + step : hi;
                }
                r_tile = lo;
                if (lane == 0) {
                    const int4 rt = a.row_tiles[lo];
                    s_row = rt;
                    s_col = a.col_tiles[rt.w + (w - a.row_items[lo])];
                }
                ++w;
            }
            if (lane == 0) s_more = more;
        }
        __syncthreads();  // every thread is done with the last item's rows and counters
        if (!s_more) break;  // uniform over the block
        const int4 rt = s_row, ct = s_col;
        if (MODE == 0 && (rt.z != cur_a || ct.z != cur_b || since_flush == a.flush_every)) {
            if (cur_a >= 0) flush(cur_a, cur_b);  // the __syncthreads below orders it before this item's adds
            cur_a = rt.z;
            cur_b = ct.z;
            since_flush = 0;
        }
        ++since_flush;
        const int row0 = rt.x, col0 = ct.x, col_end = ct.y;
        const bool diag = rt.z == ct.z;
        // rows i < j <= col_end - 1 on the diagonal; the whole row tile against another class
        const int i_end = diag && rt.y > col_end - 1 ? col_end - 1 : rt.y;
        const bool overlap = diag && rt.y > col0;
        for (int e = threadIdx.x; e < rt.y - row0; e += kThreads) rorig[e] = a.orig[row0 + e];
        if (D) {
            for (int e = threadIdx.x; e < (rt.y - row0) * (D ? D : 1); e += kThreads)
                rows[e] = a.pts[static_cast<long long>(row0) * d + e];
        }
        float xj[kReg][D ? D : 1];
        int oj[kReg], jg[kReg];
#pragma unroll
        for (int r = 0; r < kReg; ++r) {
            const int j = col0 + threadIdx.x + r * kThreads;
            const bool ok = j < col_end;
#pragma unroll
            for (int c = 0; c < (D ? D : 1); ++c)
                xj[r][c] = (D && ok) ? a.pts[static_cast<long long>(j) * d + c] : __int_as_float(0x7fffffff);
            oj[r] = ok ? a.orig[j] : 0;
            jg[r] = ok ? j : -1;  // a missing column: NaN coordinates, or masked with a runtime dimension
        }
        __syncthreads();

        if (i_end > row0) {
            const int reg = (col_end - col0 + kThreads - 1) / kThreads;  // the column points a thread holds
#define SQT_K17_CLASS(RR, MASK, DIR)                                                                             \
    {                                                                                                           \
        float x[RR][D ? D : 1];                                                                                 \
        int o[RR], g[RR];                                                                                       \
        _Pragma("unroll") for (int r = 0; r < RR; ++r) {                                                        \
            _Pragma("unroll") for (int c = 0; c < (D ? D : 1); ++c) x[r][c] = xj[r][c];                         \
            o[r] = oj[r];                                                                                       \
            g[r] = jg[r];                                                                                       \
        }                                                                                                       \
        class_pairs<D, RR, MASK, DIR, TAB, MODE>(t, rows, rorig, a.pts, d, row0, i_end, x, o, g, acc);          \
    }
#define SQT_K17_REG(MASK, DIR)                    \
    if (reg == 1) SQT_K17_CLASS(1, MASK, DIR)     \
    else if (reg == 2) SQT_K17_CLASS(2, MASK, DIR) \
    else SQT_K17_CLASS(4, MASK, DIR)
            if constexpr (D == 0) {
                SQT_K17_REG(true, true)  // masked always: i < j holds off the diagonal, and DIR counts (a, a) on it
            } else {
                if (overlap) SQT_K17_REG(true, false)
                else if (diag) SQT_K17_REG(false, false)
                else SQT_K17_REG(false, true)
            }
#undef SQT_K17_REG
#undef SQT_K17_CLASS
        }
    }
    if (MODE == 0) {
        __syncthreads();  // every thread passed its last pairs
        if (cur_a >= 0) flush(cur_a, cur_b);
    } else {
        sink(acc, a.hist);
    }
}

// ============================================================ the index route

struct IndexArgs {
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

// What one block needs to count a pair's d2 on the index route.
struct Tally {
    const int4* tab;      // (n_buckets + 1,) shared: split bits, the bins of d2 <= split and of d2 > split (-1: none)
    const float* thr;     // (n_thr,) global
    uint32_t* bins;       // SHARED: this warp's copy of the (L, C, C) counters
    unsigned long long* gbins;  // else the global (L, C, C) counts
    uint32_t* fixed;      // mode 2: this thread's fixed counter
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
template <int R, bool SHARED, int MODE>
__device__ __forceinline__ void tally(const Tally& t, const float (&d2)[R], const int (&pair)[R], unsigned int& acc) {
    int4 e[R];
#pragma unroll
    for (int r = 0; r < R; ++r) e[r] = t.tab[bucket_of(d2[r], t.scale, t.top)];
    bool walk = false;
#pragma unroll
    for (int r = 0; r < R; ++r) {
        const float sp = __int_as_float(e[r].x);
        const int k = d2[r] <= sp ? e[r].y : e[r].z;  // a NaN split: the second bin, none
        if (MODE == 1) acc += static_cast<unsigned int>(k);
        else if (MODE == 2) atomicAdd(t.fixed, static_cast<unsigned int>(k + pair[r]));
        else if (k >= 0) count_pair<SHARED>(t, k, pair[r]);
        walk |= sp != sp;
    }
    if (MODE == 0 && walk) {
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
template <int D, int R, bool MASK, bool SHARED, int MODE>
__device__ __forceinline__ void tile_pairs(const Tally& t, const float* rows, const int* rlab, const float* base,
                                           int dim, int row0, int i_end, const float (&xj)[R][D ? D : 1],
                                           const int (&lb)[R], const int (&jlim)[R], const int (&jg)[R],
                                           unsigned int& acc) {
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
            if constexpr (D > 0) d2[r] = pair_d2<D>(xi, xj[r]);
            else d2[r] = pair_d2_rt(base, dim, i, jg[r]);
            if (lb[r] < 0 || (MASK && i >= jlim[r])) d2[r] = nan;  // counted nowhere
            pair[r] = la * t.n_cls + lb[r];
        }
        tally<R, SHARED, MODE>(t, d2, pair, acc);
    }
}

template <int D, bool SHARED, int MODE>
__global__ void __launch_bounds__(kThreads) index_sweep_kernel(const IndexArgs a) {
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
    t.fixed = counters + threadIdx.x % (n_counters > 0 ? n_counters : 1);
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

    unsigned int acc = 0;  // the measuring mode 1's sink
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
        if (MODE == 0 && SHARED && since_flush == a.flush_every) {
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
            if (full) tile_pairs<D, R, false, SHARED, MODE>(t, rows, rlab, a.pts, d, row0, i_end, xj, lb, jlim, jg, acc);
            else tile_pairs<D, R, true, SHARED, MODE>(t, rows, rlab, a.pts, d, row0, i_end, xj, lb, jlim, jg, acc);
        }
    }
    if (MODE == 0) {
        if (SHARED) flush();  // every thread passed the last barrier after its pairs
    } else {
        sink(acc, a.hist);
    }
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

// blocks of `kernel` resident on the card at `smem` bytes each
template <typename Kernel>
cudaError_t resident_blocks(Kernel kernel, size_t smem, long long& resident) {
    cudaError_t err = sqt_allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    int per_sm = 0, dev = 0, n_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    resident = static_cast<long long>(per_sm) * n_sm;
    return cudaSuccess;
}

template <int D, int TAB, int MODE>
cudaError_t launch_class(const ClassArgs& a, cudaStream_t s) {
    const size_t smem = (static_cast<size_t>(3 * a.n_thr + 7) * 32 + (a.n_buckets / 4 + 1) * 32 +
                         static_cast<size_t>(a.row_tile) * ((D ? D : 0) + 1)) * 4;
    long long resident = 0;
    cudaError_t err = resident_blocks(class_sweep_kernel<D, TAB, MODE>, smem, resident);
    if (err != cudaSuccess) return err;
    // every item's rows could be in one class: an upper bound on the items, for the grid
    const long long bound = static_cast<long long>(a.max_row_tiles) * a.max_col_tiles;
    const int blocks = static_cast<int>(bound < resident ? bound : resident);
    class_sweep_kernel<D, TAB, MODE><<<blocks, kThreads, smem, s>>>(a);
    return cudaGetLastError();
}

template <int TAB>
cudaError_t dispatch_class(const ClassArgs& a, int mode, cudaStream_t s) {
    if constexpr (TAB == 1) {  // the measuring modes, on tables of one threshold a bucket
        if (mode == 1) return launch_class<2, 1, 1>(a, s);
        if (mode == 2) return launch_class<2, 1, 2>(a, s);
    }
    if (mode) return cudaErrorInvalidValue;
    if (a.dim == 2) return launch_class<2, TAB, 0>(a, s);
    if (a.dim == 1) return launch_class<1, TAB, 0>(a, s);
    if (a.dim == 3) return launch_class<3, TAB, 0>(a, s);
    return launch_class<0, TAB, 0>(a, s);
}

template <int D, bool SHARED, int MODE>
cudaError_t launch_index(IndexArgs a, cudaStream_t s) {
    if (kCols % a.row_tile != 0) return cudaErrorInvalidValue;
    const size_t copy_words = static_cast<size_t>(a.n_thr) * a.n_cls * a.n_cls;
    const size_t smem = (a.n_buckets + 1) * sizeof(int4) + ((D ? static_cast<size_t>(a.row_tile) * D : 0) +
                         a.row_tile + (SHARED ? a.copies * copy_words : 0)) * 4;
    long long resident = 0;
    cudaError_t err = resident_blocks(index_sweep_kernel<D, SHARED, MODE>, smem, resident);
    if (err != cudaSuccess) return err;
    const long long n_col_tiles = (a.n + kCols - 1) / kCols;
    a.row_tiles_per_col = kCols / a.row_tile;
    a.n_items = a.row_tiles_per_col * (n_col_tiles * (n_col_tiles + 1) / 2);
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
    index_sweep_kernel<D, SHARED, MODE><<<blocks, kThreads, smem, s>>>(a);
    return cudaGetLastError();
}

template <bool SHARED>
cudaError_t dispatch_index(const IndexArgs& a, int mode, cudaStream_t s) {
    if constexpr (SHARED) {  // the measuring modes, on shared copies
        if (mode == 1) return launch_index<2, true, 1>(a, s);
        if (mode == 2) return launch_index<2, true, 2>(a, s);
    }
    if (a.dim == 2) return launch_index<2, SHARED, 0>(a, s);
    if (a.dim == 1) return launch_index<1, SHARED, 0>(a, s);
    if (a.dim == 3) return launch_index<3, SHARED, 0>(a, s);
    return launch_index<0, SHARED, 0>(a, s);
}

}  // namespace

namespace {

// The 64-bit words of the class route's scratch: the row and column tile
// tables (16 bytes an entry), a header of 4, the row tiles' item offsets,
// the (n_thr, C, C) counts, the class starts, each point's index and the
// points in class order (ops/cooccur.py `_k17_scratch_words` gives the same).
long long scratch_words_needed(int n, int dim, int n_thr, int n_cls, int row_tile) {
    const long long max_rt = (static_cast<long long>(n) + row_tile - 1) / row_tile + n_cls;
    const long long max_ct = (static_cast<long long>(n) + kCols - 1) / kCols + n_cls;
    return 2 * max_rt + 2 * max_ct + 4 + (max_rt + 1) + static_cast<long long>(n_thr) * n_cls * n_cls +
           (n_cls + 2) / 2 + (static_cast<long long>(n) + 1) / 2 + (static_cast<long long>(n) * dim + 1) / 2;
}

}  // namespace

// The class route. pts (n, dim) float32; labels (n,) int32; bins, thr_rep
// and first the tables of `_k17_lane_tables` (ops/cooccur.py) for n_buckets
// buckets and the scale, for distinct thresholds; tab the most thresholds a
// bucket holds, 1 or 2, or 3 for more (a bucket's byte is then the junk bin
// L + 1); row_tile a power of two dividing 1024; mode 0 counts, 1 and 2
// measure (dim 2, tab 1); scratch a zeroed, 16-byte aligned int64
// array of `scratch_words` (at least `_k17_scratch_words`); out (n_thr,
// n_cls, n_cls) int64, the cumulative counts of pairs i < j by (label_i,
// label_j).
SQT_EXPORT int sqt_cooccur_pairs(const float* pts, const int* labels, int n, int dim, int n_thr, int n_cls,
                                 const unsigned char* bins, const float* thr_rep, const int* first, float scale,
                                 int n_buckets, int tab, int row_tile, int mode, long long* scratch,
                                 long long scratch_words,
                                 long long* out, void* stream) {
    if (n < 2 || dim <= 0 || n_thr <= 0 || n_cls <= 0 || n_buckets <= 0 || (n_buckets & 3) || n_thr > 254 ||
        tab < 1 || tab > 3 ||
        row_tile <= 0 || (row_tile & (row_tile - 1)) || kCols % row_tile || mode < 0 || mode > 2 ||
        (mode && dim != 2) || reinterpret_cast<uintptr_t>(bins) % 4 ||
        reinterpret_cast<uintptr_t>(scratch) % sizeof(int4) ||
        static_cast<long long>(n_thr) * n_cls * n_cls >= (1LL << 31) ||
        scratch_words < scratch_words_needed(n, dim, n_thr, n_cls, row_tile)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int cc = n_cls * n_cls;
    ClassArgs a{};
    a.src = pts;
    a.labels = labels;
    a.n = n;
    a.dim = dim;
    a.n_thr = n_thr;
    a.n_cls = n_cls;
    a.bins = reinterpret_cast<const unsigned*>(bins);
    a.thr = thr_rep;
    a.first = first;
    a.scale = scale;
    a.n_buckets = n_buckets;
    a.row_tile = row_tile;
    a.max_row_tiles = static_cast<int>((static_cast<long long>(n) + row_tile - 1) / row_tile + n_cls);
    a.max_col_tiles = static_cast<int>((static_cast<long long>(n) + kCols - 1) / kCols + n_cls);
    a.row_tiles = reinterpret_cast<int4*>(scratch);  // 16-byte entries first
    a.col_tiles = a.row_tiles + a.max_row_tiles;
    a.header = reinterpret_cast<long long*>(a.col_tiles + a.max_col_tiles);
    a.row_items = a.header + 4;
    a.hist = reinterpret_cast<unsigned long long*>(a.row_items + a.max_row_tiles + 1);
    long long* p = reinterpret_cast<long long*>(a.hist) + static_cast<size_t>(n_thr) * cc;
    a.starts = reinterpret_cast<int*>(p);
    p += (n_cls + 2) / 2;
    a.orig = reinterpret_cast<int*>(p);
    p += (static_cast<long long>(n) + 1) / 2;
    a.pts = reinterpret_cast<float*>(p);
    // adds an item makes to one counter, at most: a lane's of every warp
    a.flush_every = static_cast<int>(kFlushPairs / (static_cast<unsigned int>(kWarps * row_tile) * kReg));
    cudaError_t err = sqt_allow_smem(order_kernel, static_cast<size_t>(n_cls) * 4);
    if (err != cudaSuccess) return static_cast<int>(err);
    order_kernel<<<1, kScanThreads, static_cast<size_t>(n_cls) * 4, s>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    err = tab == 1 ? dispatch_class<1>(a, mode, s) : tab == 2 ? dispatch_class<2>(a, mode, s)
                                                   : dispatch_class<3>(a, mode, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    cumulate_kernel<<<(cc + kThreads - 1) / kThreads, kThreads, 0, s>>>(a.hist, n_thr, cc, out);
    return static_cast<int>(cudaGetLastError());
}

// The index route. pts (n, dim) float32; labels (n,) int32; thr (n_thr,)
// float32 ascending; table (n_buckets + 2, 4) int32 from `_k17_table`,
// 16-byte aligned; copies 1-8 shared copies of the (n_thr, n_cls, n_cls)
// uint32 counters, or 0 for 64-bit global atomics; row_tile a power of two
// dividing 1024; mode 0 counts, 1 and 2 measure (dim 2, copies > 0); hist a
// zeroed (n_thr * n_cls * n_cls + 1) int64 scratch whose last element is the
// work-item counter; out (n_thr, n_cls, n_cls) int64, the cumulative counts
// of pairs i < j by (label_i, label_j).
SQT_EXPORT int sqt_cooccur_pairs_index(const float* pts, const int* labels, int n, int dim, const float* thr,
                                       int n_thr, int n_cls, const int* table, int n_buckets, int copies,
                                       int row_tile, int mode, long long* hist, long long* out, void* stream) {
    if (n < 2 || dim <= 0 || n_thr <= 0 || n_cls <= 0 || n_buckets <= 0 || n_buckets >= (1 << 22) || copies < 0 ||
        reinterpret_cast<uintptr_t>(table) % sizeof(int4) ||
        copies > kThreads / 32 || row_tile <= 0 || (row_tile & (row_tile - 1)) || mode < 0 || mode > 2 ||
        (mode && (dim != 2 || copies == 0)) ||
        static_cast<long long>(n_thr) * n_cls * n_cls >= (1LL << 31)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int cc = n_cls * n_cls;
    auto* h = reinterpret_cast<unsigned long long*>(hist);
    IndexArgs a{};
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
    const cudaError_t err = copies ? dispatch_index<true>(a, mode, s) : dispatch_index<false>(a, mode, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    cumulate_kernel<<<(cc + kThreads - 1) / kThreads, kThreads, 0, s>>>(h, n_thr, cc, out);
    return static_cast<int>(cudaGetLastError());
}
