// K15: the IVF kNN's cluster search (squidpy_torch/ops/ivf_knn.py).
//
// Replaces squidpy_tpu/ops/ivf_knn.py `_ivf_search_chunk` (line 251): XLA
// code that, for each cluster, gathers the cluster's query replicas (its
// row of the (C, cap_q) replica table) and its members (its row of the
// (C, cap) member table), forms the (cap_q, cap) expanded-form d2 block on
// the MXU, masks the sentinels and the query itself, and keeps each
// replica's k best by `approx_min_k` (the exact top k on the CPU), in chunks
// of clusters bounded by `_PAIRS_PER_DISPATCH`.
//
// Here, for x (n, dp) float32 (dp a multiple of 4; zero columns add exactly
// +0 to every d2), members (C, cap) and qtable (C, cap_q) int32, each row
// front-packed with msize[c] / qsize[c] real rows before its sentinels, it
// writes each real replica's k least keys (bits of d2) << 32 | member,
// ascending, into out (C * cap_q, k) uint64 at row c * cap_q + slot; the
// rows of empty slots are left as the caller filled them (all
// 0x7fffffffffffffff, the key above every real one, by the wrapper). d2 is
// the difference form in axis order (__fsub_rn, __fmul_rn, __fadd_rn,
// --fmad=false; a NaN d2 takes the bits 0x7fc00000), the query itself is
// excluded by index when exclude_self is set, ties go to the lowest index.
// A query with fewer than k members keeps the no-key above its real keys.
// The plain torch version (squidpy_torch/ops/ivf_knn.py `_search_plain`)
// selects by the same keys, so both agree bit for bit; the JAX package ranks
// by the expanded form (ROADMAP.md queue 3). One launch covers every
// cluster: the chunks guarded a TPU worker, not this card.
//
// Bound on the card: operations. Any route must at least form the products
// of dp features of every real (replica, member) pair (2 dp a pair at the
// dense bf16 tensor rate, the filter's operand type; 1.59e10 pairs at 1M
// rows of part g: 0.51 ms at dp = 16, 1.61 ms at dp = 56) and compare one
// key a pair; the rows and tables read once and the keys written once weigh
// less. The exact keys of every pair alone (3 dp + 1 unfused float32
// operations a pair) would take ~23 / ~81 ms at one instruction a lane and
// clock.
//
// Design: two routes. The filter route (dp a multiple of 8 up to 64; the entry
// `sqt_ivf_search_filter`, built as csrc/ivf_search_filter.cu) is the
// tensor-core filter of csrc/knn_filter.cuh, whose proof keeps the exact top
// k: each cluster a set, its replicas the query rows (gathered through the
// replica table and centred in registers), its members the candidate columns,
// both centred on the mean of the cluster's members' finite entries (members
// lie near it, so their norms, and with them the filter's error bound, are
// far smaller than about the column means of all rows). A first kernel computes each
// cluster's centre and its members' bf16 terms and norms once, in member-table
// order, padded to 8 columns, in the B fragments' order (each row is a member
// of one cluster: ~100 MB at g1's 1M x 16, ~400 MB at dp = 56); the sweep's
// block takes 128 replicas of one cluster and asks for each tile of member
// terms by bulk asynchronous copies, double-buffered against the products of
// the tile before. It sweeps the members twice: the bounding pass gives each
// replica a proven T_i from its k + 1 least upper bounds (the replica may be
// among the members), so the second pass's candidates are about the k
// nearest and the near ties, not most of a short cluster, as a list that
// starts empty admits. One thread a replica then computes its candidates'
// exact keys (of every member when they pass its buffer of 64: exact ties,
// duplicate rows, an unbounded norm) from the original rows, as the exact
// route does, into a register list; no replica leaves the kernel.
//
// The exact route (`sqt_ivf_search`; every replica above 64 features, or
// where k + 1 passes 32; the earlier design): a block takes 128 replica slots of
// one cluster (blockIdx.y), one thread a replica with its row's features in
// registers (dp <= 64; above, read from the cache), and returns at once when
// its first slot is past the cluster's replicas. It stages the cluster's
// members in shared memory in tiles of 48 KB (1536 x 16 float32 is two
// tiles, 1536 x 56 seven), their rows gathered through the member table,
// with their indices beside them; every thread reads each staged member as
// a broadcast. The k best keys sit in registers, sorted, in a list of KC =
// 8, 16 or 32 >= k keys (the first k of the best KC are the best k), as in
// K12 (csrc/feature_knn.cu).

#include <cmath>

#include "common.cuh"
#include "knn_filter.cuh"
#include "knn_keys.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kStageBytes = 48 * 1024;

template <int DP, int KC>
__global__ void __launch_bounds__(kThreads) search_kernel(const float* __restrict__ x, int dp,
                                                          const int* __restrict__ members, int cap,
                                                          const int* __restrict__ msize,
                                                          const int* __restrict__ qtable, int cap_q,
                                                          const int* __restrict__ qsize, int k, int exclude_self,
                                                          int stage, unsigned long long* __restrict__ out) {
    extern __shared__ float4 tile[];  // (stage, dp / 4) member rows, then stage member indices
    const int kV = (DP ? DP : dp) / 4;
    const int c = blockIdx.y;
    const int nq = qsize[c];
    if (static_cast<int>(blockIdx.x) * kThreads >= nq) return;  // the whole block: no replica
    int* ids = reinterpret_cast<int*>(tile + static_cast<size_t>(stage) * kV);
    const int slot = blockIdx.x * kThreads + threadIdx.x;
    const int q = slot < nq ? qtable[static_cast<size_t>(c) * cap_q + slot] : -1;
    const bool valid = q >= 0;
    const float4* x4 = reinterpret_cast<const float4*>(x);
    const float4* xrow = x4 + static_cast<size_t>(valid ? q : 0) * kV;
    float xq[DP ? DP : 1];
    load_row<DP>(xrow, valid, xq);
    Best<KC> best;
    best.init();
    const int nm = msize[c];
    const int* mrow = members + static_cast<size_t>(c) * cap;
    for (int t0 = 0; t0 < nm; t0 += stage) {
        const int cnt = nm - t0 < stage ? nm - t0 : stage;
        __syncthreads();  // every thread is done with the last tile
        for (int e = threadIdx.x; e < cnt * kV; e += kThreads) {
            const int p = e / kV;
            tile[e] = __ldg(x4 + static_cast<size_t>(__ldg(mrow + t0 + p)) * kV + (e - p * kV));
        }
        for (int p = threadIdx.x; p < cnt; p += kThreads) ids[p] = __ldg(mrow + t0 + p);
        __syncthreads();
        if (!valid) continue;
        for (int p = 0; p < cnt; ++p) {
            const float d2 = staged_d2<DP>(tile, p, kV, xq, xrow);
            const int j = ids[p];
            if (!(exclude_self && j == q)) best.insert(make_key(d2, j));
        }
    }
    if (!valid) return;
    unsigned long long* o = out + (static_cast<size_t>(c) * cap_q + slot) * k;
#pragma unroll
    for (int r = 0; r < KC; ++r)
        if (r < k) o[r] = best.key[r];
}

template <int DP, int KC>
cudaError_t launch_search(const float* x, int dp, const int* members, int cap, const int* msize, const int* qtable,
                          int cap_q, const int* qsize, int n_cents, int k, int exclude_self,
                          unsigned long long* out, cudaStream_t s) {
    int stage = kStageBytes / (4 * dp + 4);
    if (stage < 1) stage = 1;
    const size_t smem = static_cast<size_t>(stage) * (4 * dp + 4);
    const cudaError_t err = sqt_allow_smem(search_kernel<DP, KC>, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(static_cast<unsigned>((cap_q + kThreads - 1) / kThreads), static_cast<unsigned>(n_cents));
    search_kernel<DP, KC><<<grid, kThreads, smem, s>>>(x, dp, members, cap, msize, qtable, cap_q, qsize, k,
                                                       exclude_self, stage, out);
    return cudaGetLastError();
}

template <int KC>
cudaError_t search_dp(const float* x, int dp, const int* members, int cap, const int* msize, const int* qtable,
                      int cap_q, const int* qsize, int n_cents, int k, int exclude_self, unsigned long long* out,
                      cudaStream_t s) {
#define SQT_SEARCH(D) launch_search<D, KC>(x, dp, members, cap, msize, qtable, cap_q, qsize, n_cents, k, exclude_self, out, s)
    switch (dp) {
        case 8: return SQT_SEARCH(8);
        case 16: return SQT_SEARCH(16);
        case 24: return SQT_SEARCH(24);
        case 32: return SQT_SEARCH(32);
        case 40: return SQT_SEARCH(40);
        case 48: return SQT_SEARCH(48);
        case 56: return SQT_SEARCH(56);
        case 64: return SQT_SEARCH(64);
        default: return SQT_SEARCH(0);
    }
#undef SQT_SEARCH
}

}  // namespace

#ifndef SQT_IVF_SEARCH_FILTER
// The exact route. x (n, dp) float32, dp a positive multiple of 4; members
// (n_cents, cap) and qtable (n_cents, cap_q) int32 with msize / qsize
// (n_cents,) int32 real rows at the front of each row, every one below n;
// 1 <= k <= 32; out (n_cents * cap_q, k) uint64, filled by the caller.
SQT_EXPORT int sqt_ivf_search(const float* x, int n, int dp, const int* members, int cap, const int* msize,
                              const int* qtable, int cap_q, const int* qsize, int n_cents, int k, int exclude_self,
                              long long* out, void* stream) {
    if (n < 1 || dp < 4 || dp % 4 || cap < 1 || cap_q < 1 || n_cents < 1 || n_cents > 65535 || k < 1 || k > 32) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    auto* o = reinterpret_cast<unsigned long long*>(out);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err;
    if (k <= 8) err = search_dp<8>(x, dp, members, cap, msize, qtable, cap_q, qsize, n_cents, k, exclude_self, o, s);
    else if (k <= 16) err = search_dp<16>(x, dp, members, cap, msize, qtable, cap_q, qsize, n_cents, k, exclude_self, o, s);
    else err = search_dp<32>(x, dp, members, cap, msize, qtable, cap_q, qsize, n_cents, k, exclude_self, o, s);
    return static_cast<int>(err);
}

#else
// The filter route, dp a multiple of 8 up to 64, k + exclude_self <= 32;
// x, members, msize, qtable, qsize, k, exclude_self as for the exact route;
// c and a the bound's constants (csrc/knn_filter.cuh); scratch: terms
// (n_cents * cap8 * ceil(dp / 16) * 64 bytes, cap8 = cap rounded up to 8),
// hneg (n_cents, cap8) float32, mu (n_cents, dp) float32; stats null or (5,)
// int64 zeroed (csrc/knn_filter.cuh IvfFilter); out (n_cents * cap_q, k)
// uint64 filled by the caller, written at every real replica.
SQT_EXPORT int sqt_ivf_search_filter(const float* x, int n, int dp, const int* members, int cap, const int* msize,
                                     const int* qtable, int cap_q, const int* qsize, int n_cents, int k,
                                     int exclude_self, float c, float a, void* terms, float* hneg, float* mu,
                                     long long* stats, long long* out, void* stream) {
    const int need = k + (exclude_self ? 1 : 0);  // the replica itself may be among the members
    if (n < 1 || dp < 8 || dp % 8 || dp > knn_filter::kMaxDp || cap < 1 || cap_q < 1 || n_cents < 1 ||
        n_cents > 65535 || k < 1 || need > 32 || !(c > 0.0f) || !(a > 0.0f) || terms == nullptr ||
        hneg == nullptr || mu == nullptr) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    knn_filter::IvfFilter f{};
    f.x = x;
    f.qtable = qtable;
    f.qsize = qsize;
    f.nx = n;
    f.cap_q = cap_q;
    f.y = x;
    f.members = members;
    f.msize = msize;
    f.ny = n;
    f.cap = cap;
    f.cap8 = (cap + 7) / 8 * 8;
    f.terms = static_cast<uint4*>(terms);
    f.hneg = hneg;
    f.mu = mu;
    f.k = k;
    f.need = need;
    f.c = c;
    f.a = a;
    f.exclude_self = exclude_self;
    f.keys = reinterpret_cast<unsigned long long*>(out);
    f.stats = reinterpret_cast<unsigned long long*>(stats);
    const int slot_blocks = (cap_q + knn_filter::kRows - 1) / knn_filter::kRows;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    // the bounding pass's lists a lane: 4 bound up to 16 members, 8 up to 32
    return static_cast<int>(need <= 16 ? knn_filter::launch_ivf_filter_dp<4>(dp, f, n_cents, slot_blocks, s)
                                       : knn_filter::launch_ivf_filter_dp<8>(dp, f, n_cents, slot_blocks, s));
}
#endif
