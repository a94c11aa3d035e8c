// K13: one hop of the k-hop ring / reach expansion of a padded ELL graph.
//
// Replaces squidpy_tpu/ops/hops.py `_deg_pass` (line 145) and `_emit_pass`
// (line 162), with their `_merge`, `_run_tails` and `_compact`: XLA code
// that gathers each row's candidates `base[ring]`, sorts them with the
// row's visited entries by index (`lax.sort`), reads run sums off prefix
// sums and compacts the kept entries with a second sort. Here, per row of
// the graph (n rows; index n pads every ELL, with weight 0):
//
// - the candidates are base row `ring[r]`'s entries j for every ring slot
//   r, with path weight ring_w[r] * base_w[j] (__fmul_rn), where both
//   indices are below n; a hop with a visited ELL adds the row's visited
//   entries (index below n) with their values;
// - each element carries the key (index << 32) | position, position being
//   r * k1 + j for a candidate and R * k1 + v for visited entry v, so a sort
//   by key orders the row by index, and equal indices in the order of the
//   JAX package's concatenation (candidates by ring slot and base slot,
//   then the visited entry);
// - the lane or thread at a run's head sums the run left to right from 0:
//   run_w adds each candidate's weight and 0 for the visited entry, run_v
//   the visited value and 0 for each candidate (__fadd_rn, the order the
//   plain torch version in squidpy_torch/ops/hops.py shares);
// - an index enters the ring if run_w > run_v (run_v is 0 without a
//   visited ELL: the reach pattern of A^k), and the new visited ELL if
//   run_v > 0 or it entered the ring, with value run_v + (1 or 0);
// - mode 0 writes each row's two degrees; mode 1 writes the ring ELL
//   (n, w_out) and the visited ELL (n, v_out) in ascending index order,
//   padded with n (values with 0).
//
// Bound on the card: bytes. A row reads its ring row, the base rows its
// ring names (k1 entries and weights each) and its visited row, and writes
// its degrees and output rows; the operations (a sort of ~100-200 keys a
// row on the niche path) are few next to those gathers. The bytes are
// worked out from each run's inputs in chip_smoke.py.
//
// Design: the warp route takes one row a warp (4 warps a block). Its
// candidates and visited entries, found by a ballot in position order, are
// written to the warp's slice of shared memory (kCapMax keys and values),
// padded to a power of two with all-ones keys and sorted by a bitonic
// network under __syncwarp; then the lanes take 32 positions at a time,
// each lane at a run's head sums its run, and a ballot places the kept
// indices in order. A row with more elements than `cap` (at most kCapMax)
// is listed by the count pass (its degrees left 0); the wrapper reads the
// list back, gives each listed row a scratch span of the next power of two
// in device memory, and the block route takes one listed row a block of
// 256 threads: the same steps with the keys in that span, the network's
// stages under __syncthreads, and the kept entries placed by a block-wide
// count of 256 positions at a time. Both passes recompute a row from the
// graph, so no sort is kept between them.

#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kCapMax = 512;
constexpr int kBlockThreads = 256;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kPadKey = ~0ULL;

struct Hop {
    const int* base_idx;   // (n, k1)
    const float* base_w;   // (n, k1)
    int n;
    int k1;
    const int* ring_idx;   // (n, R)
    const float* ring_w;   // (n, R)
    int R;
    const int* vis_idx;    // (n, V), or null with V = 0
    const float* vis_val;  // (n, V)
    int V;
    int* r_deg;            // (n,)
    int* v_deg;            // (n,)
    int w_out;
    int v_out;
    int* r_out;            // (n, w_out)
    int* v_out_idx;        // (n, v_out)
    float* v_out_val;      // (n, v_out)
};

__device__ __forceinline__ unsigned long long elem_key(int idx, int pos) {
    return (static_cast<unsigned long long>(static_cast<unsigned>(idx)) << 32) | static_cast<unsigned>(pos);
}

__device__ __forceinline__ int key_index(unsigned long long key) { return static_cast<int>(key >> 32); }

// Element `t` of the row's slots (candidates first, then visited entries):
// whether it is an element, and its key and value.
__device__ __forceinline__ bool row_element(const Hop& h, int row, int t, unsigned long long& key, float& val) {
    const int slots = h.R * h.k1;
    if (t < slots) {
        const int r = t / h.k1;
        const int j = t - r * h.k1;
        const int rr = __ldg(h.ring_idx + static_cast<size_t>(row) * h.R + r);
        if (rr >= h.n) return false;
        const int b = __ldg(h.base_idx + static_cast<size_t>(rr) * h.k1 + j);
        if (b >= h.n) return false;
        key = elem_key(b, t);
        val = __fmul_rn(__ldg(h.ring_w + static_cast<size_t>(row) * h.R + r),
                        __ldg(h.base_w + static_cast<size_t>(rr) * h.k1 + j));
        return true;
    }
    const int v = t - slots;
    const int b = __ldg(h.vis_idx + static_cast<size_t>(row) * h.V + v);
    if (b >= h.n) return false;
    key = elem_key(b, t);
    val = __ldg(h.vis_val + static_cast<size_t>(row) * h.V + v);
    return true;
}

__device__ __forceinline__ int row_elements(const Hop& h, int row, int first, int stride) {
    int cnt = 0;
    unsigned long long key;
    float val;
    for (int t = first; t < h.R * h.k1 + h.V; t += stride) cnt += row_element(h, row, t, key, val) ? 1 : 0;
    return cnt;
}

__host__ __device__ __forceinline__ int pow2_at_least(int v) {
    int p = 1;
    while (p < v) p <<= 1;
    return p;
}

struct WarpSync {
    __device__ __forceinline__ void operator()() const { __syncwarp(); }
};
struct BlockSync {
    __device__ __forceinline__ void operator()() const { __syncthreads(); }
};

// A bitonic network over `len` (a power of two) keys with their values,
// ascending; `tid`/`threads` split each stage's pairs, `sync` ends a stage.
template <typename Sync>
__device__ __forceinline__ void bitonic(unsigned long long* keys, float* vals, int len, int tid, int threads,
                                        Sync sync) {
    for (int size = 2; size <= len; size <<= 1) {
        for (int stride = size >> 1; stride > 0; stride >>= 1) {
            for (int i = tid; i < (len >> 1); i += threads) {
                const int a = 2 * i - (i & (stride - 1));
                const int b = a + stride;
                const bool up = (a & size) == 0;
                const unsigned long long ka = keys[a], kb = keys[b];
                if ((ka > kb) == up) {
                    keys[a] = kb;
                    keys[b] = ka;
                    const float va = vals[a];
                    vals[a] = vals[b];
                    vals[b] = va;
                }
            }
            sync();
        }
    }
}

// The run starting at sorted position p (its head): its sums, left to right from 0.
struct Run {
    bool ring;
    bool vis;
    float value;  // the new visited value
};

__device__ __forceinline__ Run run_at(const unsigned long long* keys, const float* vals, int p, int cnt, int slots) {
    const int idx = key_index(keys[p]);
    float run_w = 0.0f, run_v = 0.0f;
    for (int q = p; q < cnt && key_index(keys[q]) == idx; ++q) {
        const bool visited = static_cast<int>(keys[q] & 0xffffffffULL) >= slots;
        run_w = __fadd_rn(run_w, visited ? 0.0f : vals[q]);
        run_v = __fadd_rn(run_v, visited ? vals[q] : 0.0f);
    }
    Run out;
    out.ring = run_w > run_v;
    out.vis = run_v > 0.0f || out.ring;
    out.value = __fadd_rn(run_v, out.ring ? 1.0f : 0.0f);
    return out;
}

__device__ __forceinline__ void fill_tail(const Hop& h, int row, int r_cnt, int v_cnt, int tid, int threads) {
    for (int s = r_cnt + tid; s < h.w_out; s += threads) h.r_out[static_cast<size_t>(row) * h.w_out + s] = h.n;
    if (h.V == 0) return;
    for (int s = v_cnt + tid; s < h.v_out; s += threads) {
        h.v_out_idx[static_cast<size_t>(row) * h.v_out + s] = h.n;
        h.v_out_val[static_cast<size_t>(row) * h.v_out + s] = 0.0f;
    }
}

__global__ void __launch_bounds__(kWarps * 32) hops_warp_kernel(Hop h, int emit, int cap, int* over_rows,
                                                                int* over_cnt, int* n_over) {
    __shared__ unsigned long long keys_s[kWarps][kCapMax];
    __shared__ float vals_s[kWarps][kCapMax];
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int row = blockIdx.x * kWarps + warp;
    if (row >= h.n) return;  // warp-uniform; no block barrier below
    unsigned long long* keys = keys_s[warp];
    float* vals = vals_s[warp];
    const int slots = h.R * h.k1;
    const int total = slots + h.V;

    int cnt = row_elements(h, row, lane, 32);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) cnt += __shfl_xor_sync(kFull, cnt, o);
    if (cnt > cap) {
        if (!emit && lane == 0) {
            h.r_deg[row] = 0;
            h.v_deg[row] = 0;
            const int slot = atomicAdd(n_over, 1);
            over_rows[slot] = row;
            over_cnt[slot] = cnt;
        }
        return;
    }
    const unsigned lt = (1u << lane) - 1u;
    int placed = 0;
    for (int t0 = 0; t0 < total; t0 += 32) {
        unsigned long long key = 0;
        float val = 0.0f;
        const bool ok = t0 + lane < total && row_element(h, row, t0 + lane, key, val);
        const unsigned mask = __ballot_sync(kFull, ok);
        if (ok) {
            const int p = placed + __popc(mask & lt);
            keys[p] = key;
            vals[p] = val;
        }
        placed += __popc(mask);
    }
    const int len = pow2_at_least(cnt > 0 ? cnt : 1);
    for (int p = cnt + lane; p < len; p += 32) keys[p] = kPadKey;
    __syncwarp();
    bitonic(keys, vals, len, lane, 32, WarpSync{});

    int r_cnt = 0, v_cnt = 0;
    for (int p0 = 0; p0 < cnt; p0 += 32) {
        const int p = p0 + lane;
        Run run{false, false, 0.0f};
        if (p < cnt && (p == 0 || key_index(keys[p - 1]) != key_index(keys[p]))) run = run_at(keys, vals, p, cnt, slots);
        const unsigned rm = __ballot_sync(kFull, run.ring);
        const unsigned vm = __ballot_sync(kFull, run.vis);
        if (emit) {
            if (run.ring) h.r_out[static_cast<size_t>(row) * h.w_out + r_cnt + __popc(rm & lt)] = key_index(keys[p]);
            if (run.vis && h.V) {
                const size_t o = static_cast<size_t>(row) * h.v_out + v_cnt + __popc(vm & lt);
                h.v_out_idx[o] = key_index(keys[p]);
                h.v_out_val[o] = run.value;
            }
        }
        r_cnt += __popc(rm);
        v_cnt += __popc(vm);
    }
    if (emit) {
        fill_tail(h, row, r_cnt, v_cnt, lane, 32);
    } else if (lane == 0) {
        h.r_deg[row] = r_cnt;
        h.v_deg[row] = h.V ? v_cnt : 0;
    }
}

// The exclusive count of `flag` over the block's threads, and the block's total.
__device__ __forceinline__ int block_rank(bool flag, int* warp_counts, int& total) {
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const unsigned mask = __ballot_sync(kFull, flag);
    if (lane == 0) warp_counts[warp] = __popc(mask);
    __syncthreads();
    int before = 0;
    total = 0;
    for (int w = 0; w < kBlockThreads / 32; ++w) {
        if (w < warp) before += warp_counts[w];
        total += warp_counts[w];
    }
    __syncthreads();  // the counts are read before the next call writes them
    return before + __popc(mask & ((1u << lane) - 1u));
}

__global__ void __launch_bounds__(kBlockThreads) hops_block_kernel(Hop h, int emit, const int* over_rows,
                                                                   const int* over_cnt, const long long* offsets,
                                                                   unsigned long long* scratch_keys,
                                                                   float* scratch_vals) {
    __shared__ int placed;
    __shared__ int warp_counts[kBlockThreads / 32];
    const int row = over_rows[blockIdx.x];
    const int cnt = over_cnt[blockIdx.x];
    const int len = pow2_at_least(cnt);
    unsigned long long* keys = scratch_keys + offsets[blockIdx.x];
    float* vals = scratch_vals + offsets[blockIdx.x];
    const int slots = h.R * h.k1;
    if (threadIdx.x == 0) placed = 0;
    __syncthreads();
    for (int t = threadIdx.x; t < slots + h.V; t += kBlockThreads) {
        unsigned long long key;
        float val;
        if (row_element(h, row, t, key, val)) {
            const int p = atomicAdd(&placed, 1);  // any order: the keys carry their positions
            keys[p] = key;
            vals[p] = val;
        }
    }
    for (int p = cnt + threadIdx.x; p < len; p += kBlockThreads) keys[p] = kPadKey;
    __syncthreads();
    bitonic(keys, vals, len, static_cast<int>(threadIdx.x), kBlockThreads, BlockSync{});

    int r_cnt = 0, v_cnt = 0;
    for (int p0 = 0; p0 < cnt; p0 += kBlockThreads) {
        const int p = p0 + threadIdx.x;
        Run run{false, false, 0.0f};
        if (p < cnt && (p == 0 || key_index(keys[p - 1]) != key_index(keys[p]))) run = run_at(keys, vals, p, cnt, slots);
        int r_total, v_total;
        const int r_rank = block_rank(run.ring, warp_counts, r_total);
        const int v_rank = block_rank(run.vis, warp_counts, v_total);
        if (emit) {
            if (run.ring) h.r_out[static_cast<size_t>(row) * h.w_out + r_cnt + r_rank] = key_index(keys[p]);
            if (run.vis && h.V) {
                const size_t o = static_cast<size_t>(row) * h.v_out + v_cnt + v_rank;
                h.v_out_idx[o] = key_index(keys[p]);
                h.v_out_val[o] = run.value;
            }
        }
        r_cnt += r_total;
        v_cnt += v_total;
    }
    if (emit) {
        fill_tail(h, row, r_cnt, v_cnt, threadIdx.x, kBlockThreads);
    } else if (threadIdx.x == 0) {
        h.r_deg[row] = r_cnt;
        h.v_deg[row] = h.V ? v_cnt : 0;
    }
}

bool valid_graph(int n, int k1, int R, int V, const void* vis_idx) {
    return n > 0 && k1 > 0 && R > 0 && V >= 0 && (V == 0 || vis_idx != nullptr) &&
           static_cast<long long>(R) * k1 + V < 0x7fffffffLL;
}

}  // namespace

// The warp route, one row a warp. The graph: base_idx/base_w (n, k1)
// int32/float32, ring_idx/ring_w (n, R), vis_idx/vis_val (n, V) or null
// with V = 0, index n padding each. mode 0 counts: r_deg/v_deg (n,) int32
// get each row's degrees, and a row with more than `cap` elements (1 <=
// cap <= 512) is appended to over_rows/over_cnt (n,) int32 (its row and
// element count) at the counter n_over (one int32, zeroed by the caller),
// its degrees left 0. mode 1 emits: r_out (n, w_out) int32 and, with V > 0,
// v_out_idx/v_out_val (n, v_out) int32/float32, skipping rows past `cap`.
SQT_EXPORT int sqt_hops_rows(int mode, const int* base_idx, const float* base_w, int n, int k1, const int* ring_idx,
                             const float* ring_w, int R, const int* vis_idx, const float* vis_val, int V, int cap,
                             int* r_deg, int* v_deg, int* over_rows, int* over_cnt, int* n_over, int w_out,
                             int v_out, int* r_out, int* v_out_idx, float* v_out_val, void* stream) {
    if (!valid_graph(n, k1, R, V, vis_idx) || cap < 1 || cap > kCapMax || (mode != 0 && mode != 1) ||
        (mode == 1 && (w_out < 1 || r_out == nullptr || (V > 0 && (v_out < 1 || v_out_idx == nullptr)))) ||
        (mode == 0 && (r_deg == nullptr || v_deg == nullptr || over_rows == nullptr || n_over == nullptr))) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const Hop h{base_idx, base_w, n, k1, ring_idx, ring_w, R, vis_idx, vis_val, V,
                r_deg, v_deg, w_out, v_out, r_out, v_out_idx, v_out_val};
    const unsigned blocks = static_cast<unsigned>((n + kWarps - 1) / kWarps);
    hops_warp_kernel<<<blocks, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(h, mode, cap, over_rows,
                                                                                    over_cnt, n_over);
    return static_cast<int>(cudaGetLastError());
}

// The block route, one listed row a block: over_rows/over_cnt (n_listed,)
// int32 as the count pass listed them; offsets (n_listed,) int64, each
// row's scratch span (the next power of two at or above its count) in
// scratch_keys (int64) and scratch_vals (float32). mode and the outputs as
// for sqt_hops_rows (mode 0 writes the listed rows' degrees).
SQT_EXPORT int sqt_hops_overflow(int mode, const int* base_idx, const float* base_w, int n, int k1,
                                 const int* ring_idx, const float* ring_w, int R, const int* vis_idx,
                                 const float* vis_val, int V, const int* over_rows, const int* over_cnt,
                                 const long long* offsets, int n_listed, long long* scratch_keys, float* scratch_vals,
                                 int* r_deg, int* v_deg, int w_out, int v_out, int* r_out, int* v_out_idx,
                                 float* v_out_val, void* stream) {
    if (!valid_graph(n, k1, R, V, vis_idx) || n_listed < 1 || (mode != 0 && mode != 1) || scratch_keys == nullptr ||
        scratch_vals == nullptr || (mode == 1 && (w_out < 1 || r_out == nullptr || (V > 0 && v_out < 1)))) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const Hop h{base_idx, base_w, n, k1, ring_idx, ring_w, R, vis_idx, vis_val, V,
                r_deg, v_deg, w_out, v_out, r_out, v_out_idx, v_out_val};
    hops_block_kernel<<<static_cast<unsigned>(n_listed), kBlockThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        h, mode, over_rows, over_cnt, offsets, reinterpret_cast<unsigned long long*>(scratch_keys), scratch_vals);
    return static_cast<int>(cudaGetLastError());
}
