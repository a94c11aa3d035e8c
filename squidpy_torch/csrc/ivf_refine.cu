// K16: the IVF kNN's refine pass, one NN-descent step (squidpy_torch/ops/ivf_knn.py).
//
// Replaces squidpy_tpu/ops/ivf_knn.py `_refine_pass` (line 312): XLA code
// that, for each row tile, gathers each row's k neighbours and their k^2
// neighbours (k + k^2 candidates), sorts the ids to mask repeats, computes
// the candidates' difference-form d2, masks repeats, sentinels and the row
// itself, and keeps the k best by `top_k` (ties to the lower sorted
// position, so to the lower id).
//
// Here, for x (n, dp) float32 (dp a multiple of 4; zero columns add exactly
// +0) and idx (n, k) int32 (-1, or any id outside [0, n), for none), it
// writes each row's k nearest distinct candidates, ascending: distances
// (n, k) float32, sqrtf(d2) correctly rounded, and indices (n, k) int32. A
// candidate's key is (bits of d2) << 32 | id, d2 the difference form in axis
// order (__fsub_rn, __fmul_rn, __fadd_rn, --fmad=false; a NaN d2 takes the
// bits 0x7fc00000), so ties go to the lowest id as in the JAX package; a row
// with fewer than k distinct valid candidates ends with distance +inf and
// index -1 (the JAX package leaves those slots undefined: ROADMAP.md queue
// 3). The plain torch version (squidpy_torch/ops/ivf_knn.py `_refine_plain`)
// selects by the same keys, so both agree bit for bit.
//
// Bound on the card: 3 dp + 1 operations a distinct candidate other than
// the row (the function needs one d2 each), or the rows and lists read once
// and the outputs written once, whichever takes longer: at 1M rows of part g,
// k = 15, 27% of the 240 entries a row are such candidates at 16 features
// (bytes) and 78% at 56 (operations on the card's 67e12/s). This design
// reads each row's 240 candidate ids and puts them through a hash set, and
// gathers each distinct candidate's row, from L2 where the rows of a wave
// share them: read once each from device memory, those rows would take 4.2
// GB at 16 features and 42 GB at 56.
//
// Design: a warp a row, rows taken in the order `order` gives (the IVF's
// cluster order, so the rows of a wave share their candidates' rows and
// lists in L2; null for index order), each row's results written at its
// own index.
// 1. The query row is copied into shared memory by 16-byte cp.async.
// 2. The row's k + k^2 candidate ids are loaded into registers, eight
//    windows of 32 at a time (one load each, all in flight together), and
//    repeats, ids outside [0, n) and, under exclude_self, the row itself are
//    dropped on these 4-byte ids before any row is gathered: a window at a
//    time, each lane puts its id into the warp's hash set in shared memory
//    (linear probing) by a plain store of (id, lane) into a free slot, and
//    reads the slot back after a __syncwarp: of the lanes that wrote one
//    slot, one entry stands; a lane whose entry stands appends its id to the
//    warp's list (a ballot), one that finds its id there drops it, one that
//    finds another id probes on (no atomics: atomicCAS on shared memory is
//    the slower way here). Which lane wins a repeat varies, the set does not.
// 3. The distinct candidates, 32 a batch (one a lane), are staged whole by
//    16-byte cp.async.ca (a row's pieces by neighbouring lanes) into two
//    buffers, so a batch's copies overlap the d2 of the one before. Rows
//    wider than the layout's chunk go in chunks of `feat` features, each
//    lane carrying its candidate's d2 on in axis order. A staged row is
//    `feat | 4` floats apart (4 mod 8), so the lanes' float4 reads meet no
//    bank conflict. The hash set overlays the buffers: it is dead by then.
// 4. The k least keys are kept in registers, lane i holding the i-th least
//    (k <= 32): the first batch's keys are sorted across the warp by a
//    bitonic network of shuffles, each later batch's keys below the k-th
//    inserted one at a time by a shuffle up the warp. Distinct candidates
//    have distinct keys, so the order in which they are met does not change
//    the result.
// The layout (warps a block, `feat`, the hash set's slots) comes from the
// wrapper (ops/ivf_knn.py `_k16_layout`), which sizes it from k and dp; the
// kernel keeps to 64 registers a thread, so 32 warps fit an SM.

#include <cmath>

#include "common.cuh"
#include "knn_keys.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxWarps = 8;
constexpr int kBatch = 32;    // candidates a batch: one a lane
constexpr int kWindows = 8;   // windows of 32 candidate ids loaded together
constexpr unsigned long long kEmptySlot = ~0ULL;  // a free slot of the hash set

struct Layout {
    int feat;      // features a staged chunk, a multiple of 4
    int stride;    // floats a staged candidate: feat | 4
    int chunks;    // ceil(dp / feat)
    int slots;     // the hash set's slots, a power of two above k + k^2
    int shift;     // 32 - log2(slots)
    int region;    // floats of the two buffers, overlaid by the hash set (8 bytes a slot)
    int list;      // ints of the candidate list: k + k^2, rounded up to 4
    int per_warp;  // floats a warp: region + list + dp
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
    return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 16;" ::"r"(smem_addr(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ unsigned long long min64(unsigned long long a, unsigned long long b) { return a < b ? a : b; }
__device__ __forceinline__ unsigned long long max64(unsigned long long a, unsigned long long b) { return a < b ? b : a; }

// The warp's 32 keys, one a lane, sorted ascending by a bitonic network of shuffles.
__device__ __forceinline__ unsigned long long warp_sort(unsigned long long v, int lane) {
#pragma unroll
    for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
        for (int stride = size >> 1; stride > 0; stride >>= 1) {
            const unsigned long long o = __shfl_xor_sync(kFull, v, stride);
            const bool up = size == 32 || (lane & size) == 0;
            v = ((lane & stride) == 0) == up ? min64(v, o) : max64(v, o);
        }
    }
    return v;
}

__global__ void __launch_bounds__(kMaxWarps * 32, 4) refine_kernel(const float* __restrict__ x, int n, int dp,
                                                                const int* __restrict__ idx, int k, int exclude_self,
                                                                const int* __restrict__ order, Layout lay,
                                                                float* __restrict__ out_d, int* __restrict__ out_i) {
    extern __shared__ __align__(16) float smem[];
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int pos = blockIdx.x * (blockDim.x >> 5) + warp;
    if (pos >= n) return;  // the whole warp; the kernel syncs warps only
    const int row = order != nullptr ? __ldg(order + pos) : pos;
    float* base = smem + static_cast<size_t>(warp) * lay.per_warp;
    unsigned long long* table = reinterpret_cast<unsigned long long*>(base);
    int* list = reinterpret_cast<int*>(base + lay.region);
    float* xq = base + lay.region + lay.list;

    // 1. the query row, asynchronously; the hash set cleared
    const float* xrow = x + static_cast<size_t>(row) * dp;
    for (int e = 4 * lane; e < dp; e += 4 * 32) cp_async16(xq + e, xrow + e);
    cp_async_commit();
    for (int s = lane; s < lay.slots / 2; s += 32) reinterpret_cast<int4*>(table)[s] = make_int4(-1, -1, -1, -1);
    __syncwarp();

    // 2. the candidates, kWindows windows of 32 loaded at a time: entry p =
    // 32 w + lane is own entry p (p < k), else entry t of own entry j's list
    // (p - k = j k + t; j as (s * magic_k) >> 16, exact for s < 2^16 / k);
    // then a window at a time through the hash set, the new ids appended
    const int mine = lane < k ? __ldg(idx + static_cast<size_t>(row) * k + lane) : -1;
    const int n_cand = k + k * k;
    const unsigned magic_k = (65536u + k - 1) / k;
    const unsigned mask = static_cast<unsigned>(lay.slots - 1);
    int nd = 0;
    for (int w0 = 0; 32 * w0 < n_cand; w0 += kWindows) {
        int cand[kWindows];
#pragma unroll
        for (int r = 0; r < kWindows; ++r) {
            const int s = 32 * (w0 + r) + lane - k;
            const int j = s < 0 ? 0 : static_cast<int>((static_cast<unsigned>(s) * magic_k) >> 16);
            const int nb = __shfl_sync(kFull, mine, j & 31);
            cand[r] = s < 0 ? mine
                      : s < k * k && nb >= 0 && nb < n ? __ldg(idx + static_cast<size_t>(nb) * k + (s - j * k))
                                                       : -1;
        }
#pragma unroll
        for (int r = 0; r < kWindows; ++r) {
            const int id = cand[r] >= 0 && cand[r] < n && !(exclude_self && cand[r] == row) ? cand[r] : -1;
            const unsigned long long entry = static_cast<unsigned long long>(static_cast<unsigned>(id)) << 32 | lane;
            unsigned slot = (static_cast<unsigned>(id) * 0x9E3779B1u) >> lay.shift;
            bool pending = id >= 0, fresh = false;
            while (__any_sync(kFull, pending)) {
                bool wrote = false;
                if (pending) {
                    const unsigned long long cur = table[slot];
                    if (cur == kEmptySlot) {
                        table[slot] = entry;
                        wrote = true;
                    } else if (static_cast<int>(cur >> 32) == id) {
                        pending = false;  // a repeat of an id already in
                    } else {
                        slot = (slot + 1) & mask;  // another id's slot: probe on
                    }
                }
                __syncwarp();
                if (wrote) {  // of the lanes that wrote one slot, one entry stands
                    const unsigned long long cur = table[slot];
                    if (cur == entry || static_cast<int>(cur >> 32) == id) {
                        fresh = cur == entry;
                        pending = false;
                    } else {
                        slot = (slot + 1) & mask;
                    }
                }
            }
            const unsigned m = __ballot_sync(kFull, fresh);
            if (fresh) list[nd + __popc(m & ((1u << lane) - 1u))] = id;
            nd += __popc(m);
        }
    }
    cp_async_wait<0>();
    __syncwarp();

    // 3-4. the batches' rows staged, their keys, the k least
    const int v_full = lay.feat >> 2;
    const int v_last = (dp - (lay.chunks - 1) * lay.feat) >> 2;
    // q / v as (q * magic) >> 16, exact for q < 32 v and v <= 32
    const unsigned magic_full = (65536u + v_full - 1) / v_full;
    const unsigned magic_last = (65536u + v_last - 1) / v_last;
    const int tiles = ((nd + kBatch - 1) / kBatch) * lay.chunks;
    auto issue = [&](int b, int f, float* buf) {
        const bool last = f == lay.chunks - 1;
        const int v = last ? v_last : v_full;
        const unsigned magic = last ? magic_last : magic_full;
        const int f0 = f * lay.feat;
        const int cnt = min(kBatch, nd - kBatch * b);
        const int* ids = list + kBatch * b;
        for (int q = lane; q < cnt * v; q += 32) {
            const int c = static_cast<int>((static_cast<unsigned>(q) * magic) >> 16);
            const int e = q - c * v;
            cp_async16(buf + c * lay.stride + 4 * e, x + static_cast<size_t>(ids[c]) * dp + f0 + 4 * e);
        }
        cp_async_commit();
    };
    unsigned long long best = kEmptyKey;  // lane i: the i-th least key so far
    unsigned long long kth = kEmptyKey;
    float d2 = 0.0f;
    int b = 0, f = 0;
    if (tiles > 0) issue(0, 0, base);
    for (int t = 0; t < tiles; ++t) {
        int nb = b, nf = f + 1;
        if (nf == lay.chunks) {
            nf = 0;
            ++nb;
        }
        if (t + 1 < tiles) {
            issue(nb, nf, base + ((t + 1) & 1) * kBatch * lay.stride);
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncwarp();
        const int c = kBatch * b + lane;
        if (f == 0) d2 = 0.0f;
        if (c < nd) {
            const int f0 = f * lay.feat;
            const int v = f == lay.chunks - 1 ? v_last : v_full;
            const float4* cv = reinterpret_cast<const float4*>(base + ((t & 1) * kBatch + lane) * lay.stride);
            const float4* qv = reinterpret_cast<const float4*>(xq + f0);
            for (int e = 0; e < v; ++e) {
                const float4 a = qv[e], w = cv[e];
                d2 = add_sq(d2, a.x, w.x);
                d2 = add_sq(d2, a.y, w.y);
                d2 = add_sq(d2, a.z, w.z);
                d2 = add_sq(d2, a.w, w.w);
            }
        }
        if (nf == 0) {  // the batch's last chunk: its keys below the k-th go in
            const unsigned long long key = c < nd ? make_key(d2, list[c]) : kEmptyKey;
            unsigned m = 0;
            if (b == 0)
                best = warp_sort(key, lane);  // the first batch: the list was empty
            else
                m = __ballot_sync(kFull, key < kth);
            while (m) {
                const int src = __ffs(m) - 1;
                m &= m - 1;
                const unsigned long long kk = __shfl_sync(kFull, key, src);
                const unsigned long long up = __shfl_up_sync(kFull, best, 1);
                if (best > kk) best = (lane == 0 || up < kk) ? kk : up;
            }
            kth = __shfl_sync(kFull, best, k - 1);
        }
        __syncwarp();  // the buffer is rewritten by the copies issued next
        b = nb;
        f = nf;
    }

    if (lane < k) {
        const size_t o = static_cast<size_t>(row) * k + lane;
        const bool have = best != kEmptyKey;
        out_d[o] = have ? sqrtf(__uint_as_float(static_cast<unsigned>(best >> 32))) : INFINITY;
        out_i[o] = have ? static_cast<int>(best & 0xffffffffULL) : -1;
    }
}

}  // namespace

// x (n, dp) float32, dp a positive multiple of 4; idx (n, k) int32, the
// current lists; 1 <= k <= 32; order (n,) int32, a permutation of 0..n-1
// (the rows' processing order), or null for index order; the layout: warps
// a block (1-8), feat (a multiple of 4, at most 128) and slots (a power of
// two above k + k^2); out_d (n, k) float32 and out_i (n, k) int32.
SQT_EXPORT int sqt_ivf_refine(const float* x, int n, int dp, const int* idx, int k, int exclude_self,
                              const int* order, int warps, int feat, int slots, float* out_d, int* out_i,
                              void* stream) {
    const int n_cand = k + k * k;
    if (n < 1 || dp < 4 || dp % 4 || k < 1 || k > 32 || warps < 1 || warps > kMaxWarps || feat < 4 || feat % 4 ||
        feat > 128 || slots <= n_cand || (slots & (slots - 1)) || slots < 32)
        return static_cast<int>(cudaErrorInvalidValue);
    Layout lay;
    lay.feat = feat < dp ? feat : dp;
    lay.stride = lay.feat | 4;
    lay.chunks = (dp + lay.feat - 1) / lay.feat;
    lay.slots = slots;
    lay.shift = 32 - __builtin_ctz(static_cast<unsigned>(slots));
    lay.region = 2 * kBatch * lay.stride > 2 * slots ? 2 * kBatch * lay.stride : 2 * slots;
    lay.list = (n_cand + 3) / 4 * 4;
    lay.per_warp = lay.region + lay.list + dp;
    const size_t smem = static_cast<size_t>(warps) * lay.per_warp * sizeof(float);
    cudaError_t err = sqt_allow_smem(refine_kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const unsigned blocks = static_cast<unsigned>((n + warps - 1) / warps);
    refine_kernel<<<blocks, warps * 32, smem, static_cast<cudaStream_t>(stream)>>>(x, n, dp, idx, k, exclude_self,
                                                                                  order, lay, out_d, out_i);
    return static_cast<int>(cudaGetLastError());
}
