// The tensor-core filter with exact re-rank shared by K12 (csrc/feature_knn.cu:
// the rows against every other row), K14 (csrc/ivf_kmeans.cu: rows against
// the centroids) and K15 (csrc/ivf_search.cu: a cluster's query replicas
// against its members). Each query row keeps the k least exact keys (bits
// of d2) << 32 | index (csrc/knn_keys.cuh) over a set of candidate columns;
// the tensor cores rank nothing: they only decide which pairs the exact keys
// are computed for.
//
// The filter. Both sides are centred on one float32 vector mu (xc = fl(x -
// mu); any mu: K12 takes the column means, K14 the centroids' means, K15
// each cluster's own members' means) and each row has n_i = |xc_i|^2 summed
// in float32 in any order; a row whose n_i is not finite or not below 2^124
// is unbounded (its norm is NaN). Each centred value v is split into bf16
// terms hi = rn(v), lo = rn(v - hi), and mma.sync m16n8k16 sums A_ij = -n_j /
// 2 + sum_e (lo_ie hi_je + hi_ie lo_je + hi_ie hi_je), so e_ij = n_i - 2 A_ij
// approximates the centred d2. With u = 2^-24, N the exact norms and D_ij
// the plain version's d2:
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
// every column of a staged tile t whose largest bounded norm is nmax_t. The
// bound holds for any number of rows and any common centre mu. Bounded norms
// keep every product and sum finite. Row i keeps an exact list of the k
// least keys among the pairs re-ranked so far, and T_i, the d2 of its k-th
// key (+inf while the list holds fewer than k, or the k-th d2 is NaN or
// +inf). Pair (i, j) of tile t is a candidate unless A_ij < M_it, M_it =
// (n_i - delta_it - T_i) / 2, each step rounded towards a smaller M
// (__fadd_ru for delta, __fsub_rd, __fmul_rd), one compare a column. Proof:
// a list over a subset of the columns has its k-th key at or above the k-th
// key over all columns, so a member j of the row's exact top k has D_ij <=
// T_i at every tile; then, in real numbers, n_i - 2 A_ij - delta_it <=
// e_ij - delta_ij <= D_ij <= T_i, so A_ij >= (n_i - delta_it - T_i) / 2 >=
// M_it, and j is a candidate. A NaN A_ij (an unbounded column) is one; an unbounded row has
// a NaN M_it, so every pair of it is one. Each candidate's exact key is
// computed as the exact routes compute it (`add_sq` on the original rows),
// inserted into the row's list, and T_i follows; so the first k of the list
// at the end are the plain version's, in any order of the columns.
//
// The bounding pass. Where a sweep is short (K14: ~1000 centroids; K15:
// ~1000 members a cluster) a list that starts empty admits most of the first
// columns and many after them. So K14 and K15 sweep the columns twice. The
// first pass re-ranks nothing: for each column it rounds up U_ij = n_i + delta_it
// - 2 A_ij >= e_ij + delta_ij >= D_ij, and each lane keeps, for each of its
// rows, the S least U over its own columns (S = 1, 4 or 8, a sorted register
// list, NaN dropped). The four lanes of a row hold disjoint columns, so with
// need <= 4 S, at least `need` distinct columns have U at most the largest of
// the four lanes' S-th least (at most the least of their least when need =
// 1): T_i is that bound. need = k, or k + 1 where the row itself may be among
// the columns (K15), so at least k columns other than the row have D_ij <=
// T_i, the k-th exact key's d2 is at most T_i, and the proof above holds for
// the second pass, whose candidates are about the k nearest and the near ties.
//
// The sweep (`sweep`): a block takes 128 query rows (4 warps of 32, two m16
// tiles a warp), their bf16 terms in registers as mma A fragments, and
// sweeps the candidate columns a tile at a time (128 columns up to 32
// features, 64 above), from two shared buffers: the tile's bf16 terms in the
// B fragments' order (one 16-byte load a lane a k-step gives a lane both
// terms of its four features) and -n_j / 2 as the mma's C operand, so A_ij
// leaves the tensor cores ready for one compare a column into a bit mask. A
// problem stages a tile in one of two ways: its threads split the centred
// columns and a barrier follows (K12), or one thread asks for the tile's
// precomputed terms by two bulk asynchronous copies (`cp.async.bulk` on an
// mbarrier) while the block works on the other buffer (K14, K15, whose two
// passes are one pipeline of tiles). The candidates are then re-ranked in
// one of two ways.
//   - Without a bounding pass (K12, S = 0; T_i falls as the list fills): a
//     warp queues its (row, column pair, which of the two) candidates in
//     shared memory across tiles; once the queue holds 32 entries (or is
//     full), and at the end of the first tile, it computes their exact keys
//     a lane each, links each entry to its row's chain (a shared-memory
//     atomic exchange), and each row's lane inserts its chain into the row's
//     sorted list (shared memory for k <= 64, a global scratch row above)
//     and lowers T_i to the list's k-th d2 (a stale T_i only admits more
//     pairs). A row whose re-ranked candidates pass `cap`, or whose norm is
//     unbounded, leaves the sweep: the problem lists it for its exact route.
//   - After a bounding pass (K14, K15; T_i is fixed): each candidate column
//     goes into its row's buffer of 16 S columns (a shared-memory atomic
//     add); after the sweep one thread a row computes the exact keys of its
//     buffer into a sorted register list of 4 S keys (`Best`,
//     csrc/knn_keys.cuh). A row past its buffer (many exact ties, duplicate
//     rows, an unbounded norm, whose M_it is NaN) computes the exact key of
//     every column instead: no row leaves the kernel.
//
// A problem P gives: kAsync; k, cap, need, n_cols, list_unbounded, c, a;
// row_id(r) (-1 for a padding row); load_rows (the A fragments and norms of
// a lane's rows); stage (kAsync false) or prefetch (kAsync true). Without a
// bounding pass: glist(r) (k > 64); keys2(r, id, j, mask, &k0, &k1) (the
// exact keys of columns j and j + 1 where mask has bit 0 and bit 1, kNoKey
// elsewhere, past the columns or where excluded); finish(r, id, state,
// first-tile count, list), called by every thread. After one:
// rerank<4 S>(r, id, candidates, buffer, first-tile count), called by every
// thread.
#pragma once

#include <cmath>
#include <type_traits>

#include "common.cuh"
#include "knn_keys.cuh"

namespace {
namespace knn_filter {

constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kNoKey = ~0ULL;  // an empty list slot
constexpr int kRows = 128;                    // query rows a block
constexpr int kWarps = kRows / 32;            // 32 rows a warp: two m16 tiles
constexpr int kQueue = 128;                   // a warp's queue of candidates
constexpr int kSharedK = 64;                  // lists in shared memory up to this k
constexpr int kMaxDp = 64;                    // the filter's widest rows (their terms live in registers)
// row states: >= 0 the row's re-ranked candidates; on the exact route; a padding row
constexpr int kExact = -1;
constexpr int kPad = -2;

// columns a staged tile: 128 up to 32 features (the tile's fixed costs, its
// barrier and bounds, weigh most there), 64 above (registers)
template <int DP>
__host__ __device__ constexpr int tile_cols() { return DP <= 32 ? 128 : 64; }
template <int DP>
__host__ __device__ constexpr int ksteps() { return (DP + 15) / 16; }

// Shared memory of a block: two tiles' terms and -n_j / 2, the rows' T_i,
// states, first-tile counts, ids and chain heads (candidate counts after a
// bounding pass), then the warps' queues and links and the lists (k <= 64),
// or the rows' candidate buffers of `buffer` columns after a bounding pass,
// and two mbarriers.
template <int DP>
__host__ __device__ constexpr size_t smem_bytes(int k, int buffer) {
    return 2 * (static_cast<size_t>(tile_cols<DP>()) * ksteps<DP>() * 16 * 4 + tile_cols<DP>() * 4) +
           static_cast<size_t>(kRows) * 20 +
           (buffer > 0 ? static_cast<size_t>(kRows) * buffer * 4
                       : static_cast<size_t>(kWarps) * kQueue * 28 +
                             (k <= kSharedK ? static_cast<size_t>(kRows) * k * 8 : 0)) +
           16;
}

template <int DP>
struct Smem {
    static constexpr int KS = ksteps<DP>();
    static constexpr int NF = tile_cols<DP>() / 8;
    uint4* bfrag;               // (2, NF, KS, 32)
    float* hneg;                // (2, tile_cols)
    float* thr;                 // (kRows,)
    int* state;                 // (kRows,)
    int* first;                 // (kRows,) candidates after the re-rank's first tile
    int* rowid;                 // (kRows,)
    int* head;                  // (kRows,) each row's chain of queue entries, -1 when empty; or its candidates
    unsigned long long* qkey;   // (kWarps, kQueue, 2)
    int* qrow;                  // (kWarps, kQueue) the row, and at bit 8 and 9 which columns passed
    int* qcol;                  // (kWarps, kQueue)
    int* qnext;                 // (kWarps, kQueue) the next entry of the row's chain
    unsigned long long* slists; // (kRows, k) when k <= kSharedK
    int* cand;                  // (kRows, buffer) after a bounding pass
    unsigned long long* bars;   // (2,)

    __device__ Smem(unsigned char* base, int k, int buffer) {
        bfrag = reinterpret_cast<uint4*>(base);
        hneg = reinterpret_cast<float*>(bfrag + 2 * NF * KS * 32);
        thr = hneg + 2 * tile_cols<DP>();
        state = reinterpret_cast<int*>(thr + kRows);
        first = state + kRows;
        rowid = first + kRows;
        head = rowid + kRows;
        qkey = reinterpret_cast<unsigned long long*>(head + kRows);
        qrow = reinterpret_cast<int*>(qkey + kWarps * kQueue * 2);
        qcol = qrow + kWarps * kQueue;
        qnext = qcol + kWarps * kQueue;
        slists = reinterpret_cast<unsigned long long*>(qnext + kWarps * kQueue);
        cand = head + kRows;
        bars = buffer > 0 ? reinterpret_cast<unsigned long long*>(cand + kRows * buffer)
                          : slists + (k <= kSharedK ? kRows * k : 0);
    }
};

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

// One column's centred values of a k-step (its 16 features) as the four
// uint4 words of its B fragments, the word of lane (column % 8) * 4 + tt at
// dst[tt]: hi and lo of features 2 tt, + 1 (the lane's b0) and 8 + 2 tt, + 1
// (its b1), each pair packed as bf16x2.
__device__ __forceinline__ void store_b_column(const float (&v)[16], uint4* dst) {
#pragma unroll
    for (int tt = 0; tt < 4; ++tt) {
        unsigned h0, l0, h1, l1;
        split2(v[2 * tt], v[2 * tt + 1], h0, l0);
        split2(v[2 * tt + 8], v[2 * tt + 9], h1, l1);
        dst[tt] = make_uint4(h0, h1, l0, l1);
    }
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

// A norm as the filter takes it: NaN unless finite and below 2^124.
__device__ __forceinline__ float bounded_norm(float n) {
    return (isfinite(n) && n < __int_as_float(0x7d800000)) ? n : __int_as_float(0x7fc00000);
}

// ---- bulk asynchronous copies into shared memory, completed on an mbarrier ----

__device__ __forceinline__ unsigned smem_addr(const void* p) {
    return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(unsigned long long* bar) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void bar_init_fence() { asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory"); }

// One thread: the barrier's arrival, expecting `bytes`, then copies of `bytes` in all.
__device__ __forceinline__ void bar_expect(unsigned long long* bar, unsigned bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)), "r"(bytes)
                 : "memory");
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from global to shared memory.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes, unsigned long long* bar) {
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(bytes), "r"(smem_addr(bar))
                 : "memory");
}

// The generic proxy's reads of a buffer ordered before the async proxy's next write to it.
__device__ __forceinline__ void fence_proxy_async() { asm volatile("fence.proxy.async.shared::cta;" ::: "memory"); }

__device__ __forceinline__ void bar_wait(unsigned long long* bar, unsigned parity) {
    asm volatile(
        "{\n"
        ".reg .pred P1;\n"
        "LAB_WAIT:\n"
        "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
        "@P1 bra DONE;\n"
        "bra LAB_WAIT;\n"
        "DONE:\n"
        "}\n" ::"r"(smem_addr(bar)),
        "r"(parity)
        : "memory");
}

// ---- the sweep ---------------------------------------------------------------

// v into the sorted list l of the S least values (its largest drops out); NaN and +inf change nothing.
template <int S>
__device__ __forceinline__ void push_least(float (&l)[S], float v) {
#pragma unroll
    for (int r = S - 1; r > 0; --r) l[r] = fmaxf(l[r - 1], fminf(l[r], v));
    l[0] = fminf(l[0], v);
}

// A row's candidate buffer after a bounding pass with lists of S.
template <int S>
__host__ __device__ constexpr int buffer_cols() { return S > 0 ? 16 * S : 0; }

// S > 0: the bounding pass (lists of S a lane and row) where the problem's
// need is at most 4 S, and the re-rank from the rows' buffers; S = 0: one
// pass, the re-rank through the warps' queues.
template <int DP, int S, class P>
__device__ __forceinline__ void sweep(P& p, unsigned char* smem_raw) {
    constexpr int KS = ksteps<DP>();
    constexpr int kTileCols = tile_cols<DP>();
    constexpr int NF = kTileCols / 8;  // n-fragments a tile
    constexpr int MT = 2;              // m16 tiles a warp
    constexpr int SL = S > 0 ? S : 1;
    constexpr int kBuffer = buffer_cols<S>();
    using Bits = std::conditional_t<(NF * MT * 2 > 32), unsigned long long, unsigned>;  // a bit a column pair and row
    const float kInf = __int_as_float(0x7f800000);
    Smem<DP> sm(smem_raw, p.k, kBuffer);

    const int tid = threadIdx.x;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int k = p.k;
    const bool shared_lists = k <= kSharedK;
    unsigned long long* qkey = sm.qkey + warp * kQueue * 2;
    int* qrow = sm.qrow + warp * kQueue;
    int* qcol = sm.qcol + warp * kQueue;
    int* qnext = sm.qnext + warp * kQueue;

    // the block's rows: ids, states, thresholds, lists
    {
        const int id = p.row_id(tid);
        sm.rowid[tid] = id;
        sm.thr[tid] = kInf;
        sm.state[tid] = id < 0 ? kPad : 0;
        sm.first[tid] = 0;
        sm.head[tid] = S > 0 ? 0 : -1;
    }
    if constexpr (S == 0) {
        for (int e = tid; e < kRows * k; e += kRows) {
            const int r = e / k;
            if (shared_lists) {
                sm.slists[e] = kNoKey;
            } else if (unsigned long long* gl = p.glist(r)) {
                gl[e - r * k] = kNoKey;
            }
        }
    }
    if constexpr (P::kAsync) {
        if (tid == 0) {
            bar_init(sm.bars);
            bar_init(sm.bars + 1);
            bar_init_fence();
        }
    }
    __syncwarp();

    // this warp's rows as A fragments (bf16 hi and lo terms), and their norms
    unsigned ahi[MT][KS][4], alo[MT][KS][4];
    float nrm[MT][2];
    p.load_rows(sm.rowid, warp, g, t, ahi, alo, nrm);
    if (p.list_unbounded && t == 0) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int r = warp * 32 + mt * 16 + g + 8 * h;
                if (isnan(nrm[mt][h]) && sm.state[r] == 0) sm.state[r] = kExact;
            }
        }
    }

    // without a bounding pass: the queued candidates re-ranked exactly, a lane
    // an entry, linked into their rows' chains; each row's lane inserts its
    // chain into the row's list, which then lowers the row's T_i
    int queued = 0;  // warp-uniform
    auto flush = [&](auto& pq, int count) {  // generic in the problem: only the queue route instantiates it
        __syncwarp();
        for (int q = lane; q < count; q += 32) {
            const int rm = qrow[q];
            const int r = rm & 0xff;
            unsigned long long k0, k1;
            pq.keys2(r, sm.rowid[r], qcol[q], rm >> 8, k0, k1);
            qkey[2 * q] = k0;
            qkey[2 * q + 1] = k1;
            qnext[q] = atomicExch(sm.head + r, q);
        }
        __syncwarp();
        {
            const int r = warp * 32 + lane;
            int cnt = sm.state[r];
            int q = sm.head[r];
            sm.head[r] = -1;
            if (cnt >= 0) {
                unsigned long long* list = shared_lists ? sm.slists + r * k : pq.glist(r);
                for (; q >= 0; q = qnext[q]) {
#pragma unroll
                    for (int c2 = 0; c2 < 2; ++c2) {
                        const unsigned long long key = qkey[2 * q + c2];
                        if (key == kNoKey) continue;
                        ++cnt;
                        list_insert(list, k, key);
                    }
                }
                if (cnt > pq.cap) {
                    cnt = kExact;
                    if (!shared_lists)
                        for (int s = 0; s < k; ++s) list[s] = kNoKey;  // the exact route's list starts empty
                } else {
                    sm.thr[r] = fminf(sm.thr[r], list_threshold(list[k - 1]));
                }
                sm.state[r] = cnt;
            }
        }
        __syncwarp();
    };

    const int n_cols = p.n_cols;
    const int n_tiles = (n_cols + kTileCols - 1) / kTileCols;
    const int need = p.need;
    const bool bounding = S > 0 && need >= 1 && need <= 4 * S;
    const int bound_tiles = bounding ? n_tiles : 0;
    const int total = bound_tiles + n_tiles;  // the bounding pass's tiles, then the re-rank's
    float ub[MT][2][SL];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int i = 0; i < SL; ++i) ub[mt][h][i] = kInf;
    if constexpr (P::kAsync) {
        if (tid == 0 && total > 0) p.prefetch(0, min(kTileCols, n_cols), sm.bfrag, sm.hneg, sm.bars);
    }
    int buf = 0;
    for (int seq = 0; seq < total; ++seq, buf ^= 1) {
        const bool pass1 = seq < bound_tiles;
        const int tile = pass1 ? seq : seq - bound_tiles;
        const int t0 = tile * kTileCols;
        const int cols = min(kTileCols, n_cols - t0);
        // two shared buffers: a warp still on the last tile reads the other one, so one barrier a tile
        uint4* bfrag = sm.bfrag + buf * NF * KS * 32;
        float* hneg = sm.hneg + buf * kTileCols;
        if constexpr (P::kAsync) {
            __syncthreads();  // every thread is done with the other buffer's tile
            if (tid == 0 && seq + 1 < total) {
                const int n0 = (seq + 1 < bound_tiles ? seq + 1 : seq + 1 - bound_tiles) * kTileCols;
                fence_proxy_async();
                p.prefetch(n0, min(kTileCols, n_cols - n0), sm.bfrag + (buf ^ 1) * NF * KS * 32,
                           sm.hneg + (buf ^ 1) * kTileCols, sm.bars + (buf ^ 1));
            }
            bar_wait(sm.bars + buf, (seq >> 1) & 1);
        } else {
            p.stage(t0, cols, bfrag, hneg);
            __syncthreads();
        }

        if constexpr (S > 0) {
            if (bounding && seq == bound_tiles) {
                // T_i from the bounding pass: at least `need` columns of the quad's lists have U <= T_i
#pragma unroll
                for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
                    for (int h = 0; h < 2; ++h) {
                        float b;
                        if (need == 1) {
                            b = ub[mt][h][0];
                            b = fminf(b, __shfl_xor_sync(kFull, b, 1));
                            b = fminf(b, __shfl_xor_sync(kFull, b, 2));
                        } else {
                            b = ub[mt][h][SL - 1];
                            b = fmaxf(b, __shfl_xor_sync(kFull, b, 1));
                            b = fmaxf(b, __shfl_xor_sync(kFull, b, 2));
                        }
                        const int r = warp * 32 + mt * 16 + g + 8 * h;
                        if (t == 0 && sm.state[r] >= 0) sm.thr[r] = b;
                    }
                }
                __syncwarp();
            }
        }

        // this lane's rows: live, and their compare bounds M (the re-rank) or
        // n_i + delta_it (the bounding pass) for this tile
        Bits live = 0;
        float M[MT][2];
        {
            float mn = kInf;  // fminf drops NaN (unbounded columns)
            for (int c = lane; c < cols; c += 32) mn = fminf(mn, hneg[c]);
#pragma unroll
            for (int o = 16; o > 0; o >>= 1) mn = fminf(mn, __shfl_xor_sync(kFull, mn, o));
            const float nmax = mn < kInf ? -2.0f * mn : 0.0f;
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const int r = warp * 32 + mt * 16 + g + 8 * h;
                    const float ni = nrm[mt][h];
                    const float delta = __fmaf_ru(p.c, __fadd_ru(ni, nmax), p.a);
                    M[mt][h] = pass1 ? __fadd_ru(ni, delta)
                                     : __fmul_rd(0.5f, __fsub_rd(__fsub_rd(ni, delta), sm.thr[r]));
                    if (sm.state[r] >= 0) {
#pragma unroll
                        for (int nf = 0; nf < NF; ++nf) live |= Bits(1) << ((nf * MT + mt) * 2 + h);
                    }
                }
            }
        }
        if (!__any_sync(kFull, live != 0)) continue;  // every row of the warp is done

        Bits ba = 0, bb = 0;  // the pair's first / second column is a candidate
#pragma unroll
        for (int nf = 0; nf < NF; ++nf) {
            if (nf * 8 >= cols) break;  // past a short tile's columns
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
            const bool c0 = nf * 8 + 2 * t < cols, c1 = nf * 8 + 2 * t + 1 < cols;
            if constexpr (S > 0) {
                if (pass1) {  // U = n_i + delta_it - 2 A_ij, rounded up, into the lane's lists
#pragma unroll
                    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
                        for (int h = 0; h < 2; ++h) {
                            push_least(ub[mt][h], c0 ? __fmaf_ru(-2.0f, acc[mt][2 * h], M[mt][h]) : kInf);
                            push_least(ub[mt][h], c1 ? __fmaf_ru(-2.0f, acc[mt][2 * h + 1], M[mt][h]) : kInf);
                        }
                    }
                    continue;
                }
            }
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const int bit = (nf * MT + mt) * 2 + h;
                    if (c0 && !(acc[mt][2 * h] < M[mt][h])) ba |= Bits(1) << bit;
                    if (c1 && !(acc[mt][2 * h + 1] < M[mt][h])) bb |= Bits(1) << bit;
                }
            }
        }
        if (pass1) continue;
        Bits bits = (ba | bb) & live;

        if constexpr (S > 0) {
            // the candidates into their rows' buffers (counted past the buffer too)
            while (bits) {
                const int bit = lowest_bit(bits);
                bits &= bits - 1;
                const int nf = bit / (MT * 2);
                const int r = warp * 32 + ((bit >> 1) & 1) * 16 + g + 8 * (bit & 1);
                const int col = t0 + nf * 8 + 2 * t;
                const int a0 = static_cast<int>((ba >> bit) & 1), a1 = static_cast<int>((bb >> bit) & 1);
                const int pos = atomicAdd(sm.head + r, a0 + a1);
                if (a0 && pos < kBuffer) sm.cand[r * kBuffer + pos] = col;
                if (a1 && pos + a0 < kBuffer) sm.cand[r * kBuffer + pos + a0] = col + 1;
            }
            if (tile == 0) {
                __syncwarp();
                sm.first[warp * 32 + lane] = sm.head[warp * 32 + lane];
            }
        } else {
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
                const int total_q = __shfl_sync(kFull, off, 31);
                off -= have;
                const int room = kQueue - queued;
                const int take = off >= room ? 0 : min(have, room - off);
                for (int i = 0; i < take; ++i) {
                    const int bit = lowest_bit(bits);
                    bits &= bits - 1;
                    const int nf = bit / (MT * 2);
                    const int mt = (bit >> 1) & 1;
                    const int h = bit & 1;
                    const int mask = static_cast<int>((ba >> bit) & 1) | (static_cast<int>((bb >> bit) & 1) << 1);
                    qrow[queued + off + i] = (warp * 32 + mt * 16 + g + 8 * h) | (mask << 8);
                    qcol[queued + off + i] = t0 + nf * 8 + 2 * t;
                }
                queued += min(total_q, room);
                if (queued == kQueue) {
                    flush(p, queued);
                    queued = 0;
                }
            }
            if (queued >= 32 || (tile == 0 && queued)) {  // every row's list and T_i from the first tile
                flush(p, queued);
                queued = 0;
            }
            if (tile == 0) sm.first[warp * 32 + lane] = sm.state[warp * 32 + lane];
        }
    }
    if constexpr (S > 0) {
        __syncthreads();
        p.template rerank<4 * SL>(tid, sm.rowid[tid], sm.head[tid], sm.cand + tid * kBuffer, sm.first[tid]);
    } else {
        if (queued) flush(p, queued);
        __syncthreads();
        const int r = tid;
        const int st = sm.state[r];
        const unsigned long long* list = st >= 0 ? (shared_lists ? sm.slists + r * k : p.glist(r)) : nullptr;
        p.finish(r, sm.rowid[r], st, sm.first[r], list);
    }
}

// ---- K14's and K15's problem: query rows gathered through a table, candidate
// ---- columns precomputed in B-fragment order, both centred on a set's own mu

// A launch of K14's or K15's filter over `n_sets` sets (K15: its clusters;
// K14: one set). Set s: the queries qtable[s][0, qsize[s]) (rows of x; every
// row of x when qtable is null), the candidates members[s][0, msize[s])
// (rows of y; every row of y when members is null), both centred on mu[s].
struct IvfFilter {
    const float* x;          // (nx, DP) the queries' matrix
    const int* qtable;       // (n_sets, cap_q) query ids, front-packed, or null
    const int* qsize;        // (n_sets,)
    int nx;
    int cap_q;
    const float* y;          // (ny, DP) the candidates' matrix (x for K15, the centroids for K14)
    const int* members;      // (n_sets, cap) candidate ids, front-packed, or null
    const int* msize;        // (n_sets,)
    int ny;
    int cap;                 // the candidate table's width (ny without a table)
    int cap8;                // cap rounded up to 8
    uint4* terms;            // (n_sets, cap8 / 8, KS, 32) the centred candidates' bf16 terms, B-fragment order
    float* hneg;             // (n_sets, cap8) -n_j / 2 (NaN if unbounded), 0 past the set's candidates
    float* mu;               // (n_sets, DP) each set's centre: the mean of its candidates' finite entries
    int k;
    int need;                // columns the bounding pass must cover (k, or k + 1 when the query is a candidate)
    float c;
    float a;
    int exclude_self;
    unsigned long long* keys;  // K15: (n_sets * cap_q, k) the keys, kEmptyKey past the real ones
    int* out_i;                // K14: (nx, k) indices
    float* out_d2;             // K14: (nx,) the nearest one's d2 when k = 1, or null
    unsigned long long* stats; // null, or (5,) zeroed: the finished queries' candidates and first-tile
                               // candidates, the largest, the finished queries, those past their buffer
};

__device__ __forceinline__ int set_size(const int* sizes, int set, int all) { return sizes ? sizes[set] : all; }

// Set blockIdx.x's mean and, for the slots [blockIdx.y * per, + per), the
// centred candidates' terms and -n_j / 2. The mean: each feature's finite
// entries summed in float64 over a fixed split of the members (groups of
// threads, then in group order), over their count (0 if none); any common
// centre keeps the filter exact, this one keeps the norms small.
template <int DP>
__global__ void __launch_bounds__(kRows) terms_kernel(IvfFilter f, int per) {
    constexpr int KS = ksteps<DP>();
    constexpr int kGroups = kRows / DP;  // threads kGroups x DP sum the mean
    __shared__ double part[kGroups][DP];
    __shared__ int cnt[kGroups][DP];
    __shared__ float mu[DP];
    const int set = blockIdx.x;
    const int nm = set_size(f.msize, set, f.ny);
    const int* mrow = f.members ? f.members + static_cast<size_t>(set) * f.cap : nullptr;
    const int tid = threadIdx.x;
    if (tid < kGroups * DP) {
        const int grp = tid / DP, e = tid - grp * DP;
        double s = 0.0;
        int c = 0;
        for (int p = grp; p < nm; p += kGroups) {
            const int id = mrow ? __ldg(mrow + p) : p;
            const float v = __ldg(f.y + static_cast<size_t>(id) * DP + e);
            if (isfinite(v)) {
                s += static_cast<double>(v);
                ++c;
            }
        }
        part[grp][e] = s;
        cnt[grp][e] = c;
    }
    __syncthreads();
    if (tid < DP) {
        double s = 0.0;
        int c = 0;
        for (int grp = 0; grp < kGroups; ++grp) {
            s += part[grp][tid];
            c += cnt[grp][tid];
        }
        mu[tid] = c ? static_cast<float>(s / c) : 0.0f;
        if (blockIdx.y == 0) f.mu[static_cast<size_t>(set) * DP + tid] = mu[tid];
    }
    __syncthreads();
    const int p0 = static_cast<int>(blockIdx.y) * per;
    const int p1 = min(f.cap8, p0 + per);
    for (int p = p0 + tid; p < p1; p += kRows) {
        const bool real = p < nm;
        const float* row = real ? f.y + static_cast<size_t>(mrow ? __ldg(mrow + p) : p) * DP : nullptr;
        float norm = 0.0f;
        uint4* dst = f.terms + (static_cast<size_t>(set) * (f.cap8 / 8) + p / 8) * KS * 32 + (p & 7) * 4;
#pragma unroll
        for (int s = 0; s < KS; ++s) {
            float v[16];
#pragma unroll
            for (int e = 0; e < 16; ++e) {
                const int fe = 16 * s + e;
                v[e] = (real && fe < DP) ? __fsub_rn(__ldg(row + fe), mu[fe]) : 0.0f;
                norm = __fadd_rn(norm, __fmul_rn(v[e], v[e]));
            }
            store_b_column(v, dst + s * 32);
        }
        f.hneg[static_cast<size_t>(set) * f.cap8 + p] = real ? -0.5f * bounded_norm(norm) : 0.0f;
    }
}

template <int DP>
struct IvfProblem {
    static constexpr bool kAsync = true;
    static constexpr int KS = ksteps<DP>();
    static constexpr int list_unbounded = 0;  // an unbounded row's candidates pass its buffer
    IvfFilter f;
    int set, slot0, nq;
    int k, cap, need, n_cols;
    float c, a;

    __device__ int row_id(int r) const {
        const int slot = slot0 + r;
        if (slot >= nq) return -1;
        return f.qtable ? __ldg(f.qtable + static_cast<size_t>(set) * f.cap_q + slot) : slot;
    }

    // the rows gathered by id, centred on the set's mu, split; each norm summed by the row's quad
    __device__ void load_rows(const int* rowid, int warp, int g, int t, unsigned (&ahi)[2][KS][4],
                              unsigned (&alo)[2][KS][4], float (&nrm)[2][2]) const {
        const float* mu = f.mu + static_cast<size_t>(set) * DP;
        float part[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
            for (int s = 0; s < KS; ++s) {
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                    const int id = rowid[warp * 32 + mt * 16 + g + ((q & 1) ? 8 : 0)];
                    const int e = 16 * s + 2 * t + ((q & 2) ? 8 : 0);
                    float v0 = 0.0f, v1 = 0.0f;
                    if (id >= 0 && e < DP) {
                        const float2 xv =
                            __ldg(reinterpret_cast<const float2*>(f.x + static_cast<size_t>(id) * DP + e));
                        const float2 m = __ldg(reinterpret_cast<const float2*>(mu + e));
                        v0 = __fsub_rn(xv.x, m.x);
                        v1 = __fsub_rn(xv.y, m.y);
                    }
                    split2(v0, v1, ahi[mt][s][q], alo[mt][s][q]);
                    part[mt][q & 1] = __fadd_rn(part[mt][q & 1], __fadd_rn(__fmul_rn(v0, v0), __fmul_rn(v1, v1)));
                }
            }
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                float n = part[mt][h];
                n = __fadd_rn(n, __shfl_xor_sync(kFull, n, 1));
                n = __fadd_rn(n, __shfl_xor_sync(kFull, n, 2));
                nrm[mt][h] = bounded_norm(n);
            }
        }
    }

    __device__ void prefetch(int t0, int cols, uint4* bfrag, float* hneg, unsigned long long* bar) const {
        const int cols8 = (cols + 7) & ~7;
        const unsigned tbytes = static_cast<unsigned>(cols8 / 8 * KS * 512);
        const unsigned hbytes = static_cast<unsigned>(cols8 * 4);
        bar_expect(bar, tbytes + hbytes);
        bulk_copy(bfrag, f.terms + (static_cast<size_t>(set) * (f.cap8 / 8) + t0 / 8) * KS * 32, tbytes, bar);
        bulk_copy(hneg, f.hneg + static_cast<size_t>(set) * f.cap8 + t0, hbytes, bar);
    }

    // The exact keys of row r's candidates (of every column when they passed
    // its buffer) into a sorted register list of KC >= k keys, the query's
    // own id left out where the problem says so; then the outputs.
    template <int KC>
    __device__ void rerank(int r, int id, int cnt, const int* cand, int first_cnt) const {
        const bool all = cnt > cap;
        const int n = id < 0 ? 0 : (all ? n_cols : cnt);
        float xq[DP];
        load_row<DP>(reinterpret_cast<const float4*>(f.x) + static_cast<size_t>(id < 0 ? 0 : id) * (DP / 4), id >= 0,
                     xq);
        Best<KC> best;
        best.init();
        const int* mrow = f.members ? f.members + static_cast<size_t>(set) * f.cap : nullptr;
        for (int i = 0; i < n; ++i) {
            const int j = all ? i : cand[i];
            const int m = mrow ? __ldg(mrow + j) : j;
            if (f.exclude_self && m == id) continue;
            const float4* ym = reinterpret_cast<const float4*>(f.y) + static_cast<size_t>(m) * (DP / 4);
            float d2 = 0.0f;
#pragma unroll
            for (int e = 0; e < DP / 4; ++e) {
                const float4 v = __ldg(ym + e);
                d2 = add_sq(d2, xq[4 * e], v.x);
                d2 = add_sq(d2, xq[4 * e + 1], v.y);
                d2 = add_sq(d2, xq[4 * e + 2], v.z);
                d2 = add_sq(d2, xq[4 * e + 3], v.w);
            }
            best.insert(make_key(d2, m));
        }
        if (id >= 0) {
            if (f.keys) {
                unsigned long long* o = f.keys + (static_cast<size_t>(set) * f.cap_q + slot0 + r) * k;
#pragma unroll
                for (int s = 0; s < KC; ++s)
                    if (s < k) o[s] = best.key[s];
            } else {
#pragma unroll
                for (int s = 0; s < KC; ++s)
                    if (s < k) f.out_i[static_cast<size_t>(id) * k + s] = static_cast<int>(best.key[s] & 0xffffffffULL);
                if (f.out_d2) f.out_d2[id] = __uint_as_float(static_cast<unsigned>(best.key[0] >> 32));
            }
        }
        if (f.stats) {  // one atomic a warp and counter
            const unsigned done = id >= 0 && !all;
            const unsigned cands = done ? static_cast<unsigned>(cnt) : 0u;
            const unsigned firsts = done ? static_cast<unsigned>(first_cnt) : 0u;
            const unsigned s_cand = __reduce_add_sync(kFull, cands);
            const unsigned s_first = __reduce_add_sync(kFull, firsts);
            const unsigned s_max = __reduce_max_sync(kFull, cands);
            const unsigned s_done = __reduce_add_sync(kFull, done);
            const unsigned s_all = __reduce_add_sync(kFull, static_cast<unsigned>(id >= 0 && all));
            if ((threadIdx.x & 31) == 0) {
                atomicAdd(f.stats, static_cast<unsigned long long>(s_cand));
                atomicAdd(f.stats + 1, static_cast<unsigned long long>(s_first));
                atomicMax(f.stats + 2, static_cast<unsigned long long>(s_max));
                atomicAdd(f.stats + 3, static_cast<unsigned long long>(s_done));
                atomicAdd(f.stats + 4, static_cast<unsigned long long>(s_all));
            }
        }
    }
};

// blockIdx.y a set, blockIdx.x 128 of its queries; blocks past the set's queries return at once.
template <int DP, int S>
__global__ void __launch_bounds__(kRows) ivf_filter_kernel(IvfFilter f) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int set = blockIdx.y;
    const int nq = set_size(f.qsize, set, f.nx);
    const int slot0 = blockIdx.x * kRows;
    if (slot0 >= nq) return;
    IvfProblem<DP> p{f, set, slot0, nq, f.k, buffer_cols<S>(), f.need, set_size(f.msize, set, f.ny), f.c, f.a};
    sweep<DP, S>(p, smem);
}

template <int DP, int S>
cudaError_t launch_ivf_filter(const IvfFilter& f, int n_sets, int slot_blocks, cudaStream_t s) {
    // the terms: one block a set for K15 (its mean once), slots of 128 a block for K14's one set
    const int per = n_sets > 1 ? f.cap8 : kRows;
    terms_kernel<DP><<<dim3(static_cast<unsigned>(n_sets), static_cast<unsigned>((f.cap8 + per - 1) / per)), kRows,
                       0, s>>>(f, per);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const size_t smem = smem_bytes<DP>(f.k, buffer_cols<S>());
    err = sqt_allow_smem(ivf_filter_kernel<DP, S>, smem);
    if (err != cudaSuccess) return err;
    ivf_filter_kernel<DP, S><<<dim3(static_cast<unsigned>(slot_blocks), static_cast<unsigned>(n_sets)), kRows, smem,
                               s>>>(f);
    return cudaGetLastError();
}

// K14's and K15's filter route at dp padded features (a multiple of 8 up to
// 64), with lists of S for the bounding pass (S * 4 >= f.need): the terms,
// then the sweep.
template <int S>
cudaError_t launch_ivf_filter_dp(int dp, const IvfFilter& f, int n_sets, int slot_blocks, cudaStream_t s) {
    switch (dp) {
        case 8: return launch_ivf_filter<8, S>(f, n_sets, slot_blocks, s);
        case 16: return launch_ivf_filter<16, S>(f, n_sets, slot_blocks, s);
        case 24: return launch_ivf_filter<24, S>(f, n_sets, slot_blocks, s);
        case 32: return launch_ivf_filter<32, S>(f, n_sets, slot_blocks, s);
        case 40: return launch_ivf_filter<40, S>(f, n_sets, slot_blocks, s);
        case 48: return launch_ivf_filter<48, S>(f, n_sets, slot_blocks, s);
        case 56: return launch_ivf_filter<56, S>(f, n_sets, slot_blocks, s);
        case 64: return launch_ivf_filter<64, S>(f, n_sets, slot_blocks, s);
        default: return cudaErrorInvalidValue;
    }
}

}  // namespace knn_filter
}  // namespace
