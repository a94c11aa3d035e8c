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
// - each element carries its index and its position, r * k1 + j for a
//   candidate and R * k1 + v for visited entry v, and a sort by (index,
//   position) orders the row by index, equal indices in the order of the
//   JAX package's concatenation (candidates by ring slot and base slot,
//   then the visited entry);
// - the lane or thread at a run's head sums the run left to right from 0:
//   run_w adds each candidate's weight and 0 for the visited entry, run_v
//   the visited value and 0 for each candidate (__fadd_rn, the order the
//   plain torch version in squidpy_torch/ops/hops.py shares);
// - an index enters the ring if run_w > run_v (run_v is 0 without a
//   visited ELL: the reach pattern of A^k), and the new visited ELL if
//   run_v > 0 or it entered the ring, with value run_v + (1 or 0);
// - the ring ELL (n, w_out) and the visited ELL (n, v_out) list the kept
//   indices in ascending order, padded with n (values with 0), at widths
//   the maxima of the degrees rounded up to the wrapper's buckets.
//
// Bound on the card: bytes. A row reads its ring row, the base rows its
// ring names (k1 entries and weights each) and its visited row, and writes
// its degrees and output rows; the operations (a sort of ~100-200 keys a
// row on the niche path) are few next to those gathers. The bytes are
// worked out from each run's inputs in chip_smoke.py.
//
// Design: each row is gathered and sorted once a hop. The warp route takes one
// row a warp (4 warps a block). Its element count is read off the base rows'
// degrees (`base_deg`, one int a live ring slot) and its live visited entries;
// then the lanes take (ring slot, base quad) items, four at a time so their
// 16-byte loads of indices and weights (k1 a multiple of 4) fly together, and a
// warp scan places each item's live entries in the warp's slice of shared
// memory; the visited quads follow. Where (n + 1) << p fits in 32 bits, p the
// bits of the row's positions, an element is one 64-bit word, (index << p |
// position) << 32 | the bits of its weight, so 1024 of them fit a warp's 8 KB;
// otherwise the key is (index << 32) | position with the weight beside it (512
// a warp). A row of up to 256 elements is sorted in registers: padded to 32 E
// elements (E a power of two), E a lane, read from the slots the gather wrote
// them to, transposed so the reads are free of bank conflicts, by a bitonic
// network whose strides below E swap a lane's registers and whose longer
// strides shuffle; so shared memory sees one read and one write an element, not
// one of each a stage. A longer row is sorted by the same network in shared
// memory. The lanes then take 32 sorted positions at a time, each lane at a
// run's head sums its run, and a ballot places the kept indices in order into a
// staging ELL whose widths (w_stage for the ring, V + w_stage for the visited
// entries) the wrapper chose from the input widths without a read-back. A row
// past the staging widths is listed as late; a row with more elements than
// `cap` is listed for the block route, which a grid of a few hundred blocks
// takes at once through the device's count (no read-back): one listed row a
// block of 256 threads, its 64-bit keys and values in its block's scratch span
// of device memory, the network's stages under __syncthreads, the kept entries
// placed by a block-wide count of 256 positions at a time. The wrapper then
// reads back the maximum degrees and the count of late rows once, and
// `sqt_hops_place` copies the staging ELLs into the bucketed ELLs, padding each
// row; the block route writes the late rows straight into them.

#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kWarpBytes = 8192;   // a warp's slice of shared memory
constexpr int kCapPacked = 1024;   // elements a warp holds as one word each
constexpr int kCapWide = 512;      // elements a warp holds as a 64-bit key and a weight
constexpr int kBlockThreads = 256;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kPadWord = ~0ULL;
constexpr int kRegLogE = 3;        // rows of up to 32 << kRegLogE elements sort in registers

struct Hop {
    const int* base_idx;   // (n, k1), k1 a multiple of 4
    const float* base_w;   // (n, k1)
    const int* base_deg;   // (n,) live entries a base row
    int n;
    int k1;
    const int* ring_idx;   // (n, R)
    const float* ring_w;   // (n, R)
    int R;
    const int* vis_idx;    // (n, V), V a multiple of 4, or null with V = 0
    const float* vis_val;  // (n, V)
    int V;
    int pbits;             // position bits of a packed key
    int w_stage;
    int v_stage;
    int* r_stage;          // (n, w_stage)
    int* v_stage_idx;      // (n, v_stage)
    float* v_stage_val;    // (n, v_stage)
    int* r_deg;            // (n,)
    int* v_deg;            // (n,)
    int* over_rows;        // rows past the warp's capacity, for the block route
    int* n_over;
    int* late_rows;        // rows past the staging widths, placed by the block route after the read-back
    int* n_late;
};

__host__ __device__ __forceinline__ int pow2_at_least(int v) {
    int p = 1;
    while (p < v) p <<= 1;
    return p;
}

// An element of a warp's slice: PACKED, one word (index << p | position)
// << 32 | weight bits; else the word (index << 32) | position and the
// weight in `vals`.
template <bool PACKED>
struct Elem {
    static __device__ __forceinline__ unsigned long long word(int idx, int pos, int p) {
        if (PACKED) {
            return static_cast<unsigned long long>((static_cast<unsigned>(idx) << p) | static_cast<unsigned>(pos))
                   << 32;
        }
        return (static_cast<unsigned long long>(static_cast<unsigned>(idx)) << 32) | static_cast<unsigned>(pos);
    }
    static __device__ __forceinline__ int index(unsigned long long w, int p) {
        return PACKED ? static_cast<int>(static_cast<unsigned>(w >> 32) >> p) : static_cast<int>(w >> 32);
    }
    static __device__ __forceinline__ int position(unsigned long long w, int p) {
        return PACKED ? static_cast<int>(static_cast<unsigned>(w >> 32) & ((1u << p) - 1u))
                      : static_cast<int>(w & 0xffffffffULL);
    }
};

struct WarpSync {
    __device__ __forceinline__ void operator()() const { __syncwarp(); }
};
struct BlockSync {
    __device__ __forceinline__ void operator()() const { __syncthreads(); }
};

// A bitonic network over `len` (a power of two) words, ascending, with
// their weights when `vals` is given; `tid`/`threads` split each stage's
// pairs, `sync` ends a stage.
template <typename Sync>
__device__ __forceinline__ void bitonic(unsigned long long* words, float* vals, int len, int tid, int threads,
                                        Sync sync) {
    for (int size = 2; size <= len; size <<= 1) {
        for (int stride = size >> 1; stride > 0; stride >>= 1) {
            for (int i = tid; i < (len >> 1); i += threads) {
                const int a = 2 * i - (i & (stride - 1));
                const int b = a + stride;
                const bool up = (a & size) == 0;
                const unsigned long long wa = words[a], wb = words[b];
                if ((wa > wb) == up) {
                    words[a] = wb;
                    words[b] = wa;
                    if (vals) {
                        const float va = vals[a];
                        vals[a] = vals[b];
                        vals[b] = va;
                    }
                }
            }
            sync();
        }
    }
}

struct Run {
    bool ring;
    bool vis;
    float value;  // the new visited value
};

// The run starting at sorted position q (its head): its sums, left to right from 0.
template <bool PACKED>
__device__ __forceinline__ Run run_at(const unsigned long long* words, const float* vals, int q, int cnt, int slots,
                                      int p) {
    const int idx = Elem<PACKED>::index(words[q], p);
    float run_w = 0.0f, run_v = 0.0f;
    for (int s = q; s < cnt && Elem<PACKED>::index(words[s], p) == idx; ++s) {
        const bool visited = Elem<PACKED>::position(words[s], p) >= slots;
        const float v = PACKED ? __uint_as_float(static_cast<unsigned>(words[s])) : vals[s];
        run_w = __fadd_rn(run_w, visited ? 0.0f : v);
        run_v = __fadd_rn(run_v, visited ? v : 0.0f);
    }
    Run out;
    out.ring = run_w > run_v;
    out.vis = run_v > 0.0f || out.ring;
    out.value = __fadd_rn(run_v, out.ring ? 1.0f : 0.0f);
    return out;
}

// The row's element count: the degrees of the base rows its live ring
// slots name, and its live visited entries (a warp sum).
__device__ __forceinline__ int row_count(const Hop& h, int row, int lane) {
    int cnt = 0;
    for (int r = lane; r < h.R; r += 32) {
        const int rr = __ldg(h.ring_idx + static_cast<size_t>(row) * h.R + r);
        if (rr < h.n) cnt += __ldg(h.base_deg + rr);
    }
    for (int v = lane; v < h.V; v += 32) cnt += __ldg(h.vis_idx + static_cast<size_t>(row) * h.V + v) < h.n ? 1 : 0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) cnt += __shfl_xor_sync(kFull, cnt, o);
    return cnt;
}

// The exclusive count of `mine` over the warp's lanes below `lane`, and the warp's total.
__device__ __forceinline__ int warp_offset(int mine, int lane, int& total) {
    int at = mine;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kFull, at, o);
        if (lane >= o) at += y;
    }
    total = __shfl_sync(kFull, at, 31);
    return at - mine;
}

// One element at position q of the row's slice: slot (q % E) * 32 + q / E
// (E = 1 << log_e), where lane q / E finds it as its register q % E.
template <bool PACKED>
__device__ __forceinline__ void put(unsigned long long* words, float* vals, int q, int log_e, int idx, int pos,
                                    float v, int p) {
    const int slot = ((q & ((1 << log_e) - 1)) << 5) | (q >> log_e);
    if (PACKED) {
        words[slot] = Elem<true>::word(idx, pos, p) | __float_as_uint(v);
    } else {
        words[slot] = Elem<false>::word(idx, pos, p);
        vals[slot] = v;
    }
}

// The row's elements into the warp's slice: the (ring slot, base quad)
// items a lane at a time, four batched so their 16-byte loads fly
// together, each item's live entries placed by a warp scan; then the
// visited quads.
template <bool PACKED>
__device__ __forceinline__ void gather_row(const Hop& h, int row, int lane, unsigned long long* words, float* vals,
                                           int log_e) {
    const int q1 = h.k1 / 4;
    const int items = h.R * q1;
    const int4* base4 = reinterpret_cast<const int4*>(h.base_idx);
    const float4* basew4 = reinterpret_cast<const float4*>(h.base_w);
    int placed = 0;
    for (int t0 = 0; t0 < items; t0 += 4 * 32) {
        int4 b[4];
        float4 w[4];
        float rw[4];
        int r[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
            const int t = t0 + 32 * u + lane;
            r[u] = t / q1;
            const int c = t - r[u] * q1;
            const int rr = t < items ? __ldg(h.ring_idx + static_cast<size_t>(row) * h.R + r[u]) : h.n;
            b[u] = make_int4(h.n, h.n, h.n, h.n);
            w[u] = make_float4(0.f, 0.f, 0.f, 0.f);
            rw[u] = 0.0f;
            if (rr < h.n) {
                b[u] = __ldg(base4 + static_cast<size_t>(rr) * q1 + c);
                w[u] = __ldg(basew4 + static_cast<size_t>(rr) * q1 + c);
                rw[u] = __ldg(h.ring_w + static_cast<size_t>(row) * h.R + r[u]);
            }
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
            const int bi[4] = {b[u].x, b[u].y, b[u].z, b[u].w};
            const float bw[4] = {w[u].x, w[u].y, w[u].z, w[u].w};
            const int pos0 = (t0 + 32 * u + lane) * 4 - r[u] * (q1 * 4 - h.k1);  // r * k1 + 4 c
            int mine = 0;
#pragma unroll
            for (int e = 0; e < 4; ++e) mine += bi[e] < h.n ? 1 : 0;
            int total;
            int q = placed + warp_offset(mine, lane, total);
#pragma unroll
            for (int e = 0; e < 4; ++e)
                if (bi[e] < h.n)
                    put<PACKED>(words, vals, q++, log_e, bi[e], pos0 + e, __fmul_rn(rw[u], bw[e]), h.pbits);
            placed += total;
        }
    }
    const int4* vis4 = reinterpret_cast<const int4*>(h.vis_idx);
    const float4* visv4 = reinterpret_cast<const float4*>(h.vis_val);
    const int slots = h.R * h.k1;
    for (int c0 = 0; c0 < h.V / 4; c0 += 32) {
        const int c = c0 + lane;
        int4 b = make_int4(h.n, h.n, h.n, h.n);
        float4 w = make_float4(0.f, 0.f, 0.f, 0.f);
        if (c < h.V / 4) {
            b = __ldg(vis4 + static_cast<size_t>(row) * (h.V / 4) + c);
            w = __ldg(visv4 + static_cast<size_t>(row) * (h.V / 4) + c);
        }
        const int bi[4] = {b.x, b.y, b.z, b.w};
        const float bv[4] = {w.x, w.y, w.z, w.w};
        int mine = 0;
#pragma unroll
        for (int e = 0; e < 4; ++e) mine += bi[e] < h.n ? 1 : 0;
        int total;
        int q = placed + warp_offset(mine, lane, total);
#pragma unroll
        for (int e = 0; e < 4; ++e)
            if (bi[e] < h.n) put<PACKED>(words, vals, q++, log_e, bi[e], slots + 4 * c + e, bv[e], h.pbits);
        placed += total;
    }
}

// The row's degrees; a row past the staging widths is listed as late.
__device__ __forceinline__ void finish_row(const Hop& h, int row, int r_cnt, int v_cnt) {
    h.r_deg[row] = r_cnt;
    h.v_deg[row] = h.V ? v_cnt : 0;
    if (r_cnt > h.w_stage || (h.V && v_cnt > h.v_stage)) h.late_rows[atomicAdd(h.n_late, 1)] = row;
}

__device__ __forceinline__ unsigned long long shfl_xor64(unsigned long long w, int m) {
    const unsigned lo = __shfl_xor_sync(kFull, static_cast<unsigned>(w), m);
    const unsigned hi = __shfl_xor_sync(kFull, static_cast<unsigned>(w >> 32), m);
    return (static_cast<unsigned long long>(hi) << 32) | lo;
}

// A bitonic network over a warp's 32 E words in registers (E a power of
// two), element q = lane * E + e in register e, ascending; the weights `v`
// follow their words unless PACKED. Strides below E pair registers of one
// lane, longer ones the same register of lane ^ (stride / E) by shuffles.
template <int E, bool PACKED>
__device__ __forceinline__ void warp_bitonic(unsigned long long (&w)[E], float (&v)[E], int lane) {
#pragma unroll
    for (int size = 2; size <= 32 * E; size <<= 1) {
#pragma unroll
        for (int stride = size >> 1; stride > 0; stride >>= 1) {
            if (stride >= E) {
                const int m = stride / E;
                const bool lower = (lane & m) == 0;
#pragma unroll
                for (int e = 0; e < E; ++e) {
                    const bool up = ((lane * E + e) & size) == 0;
                    const unsigned long long o = shfl_xor64(w[e], m);
                    float ov = 0.0f;
                    if (!PACKED) ov = __shfl_xor_sync(kFull, v[e], m);
                    if (lower == up ? o < w[e] : o > w[e]) {  // the lower element keeps the smaller word when up
                        w[e] = o;
                        if (!PACKED) v[e] = ov;
                    }
                }
            } else {
#pragma unroll
                for (int e = 0; e < E; ++e) {
                    if (e & stride) continue;
                    const int q = e | stride;
                    const bool up = ((lane * E + e) & size) == 0;
                    if ((w[e] > w[q]) == up) {
                        const unsigned long long t = w[e];
                        w[e] = w[q];
                        w[q] = t;
                        if (!PACKED) {
                            const float tv = v[e];
                            v[e] = v[q];
                            v[q] = tv;
                        }
                    }
                }
            }
        }
    }
}

// The warp's slice sorted: the cnt elements read from their transposed
// slots into registers (pads above cnt), sorted, and written back in order.
template <bool PACKED, int E>
__device__ __forceinline__ void sort_slice(unsigned long long* words, float* vals, int cnt, int lane) {
    unsigned long long w[E];
    float v[E];
#pragma unroll
    for (int e = 0; e < E; ++e) {
        const bool live = lane * E + e < cnt;
        w[e] = live ? words[e * 32 + lane] : kPadWord;
        v[e] = (!PACKED && live) ? vals[e * 32 + lane] : 0.0f;
    }
    warp_bitonic<E, PACKED>(w, v, lane);
    __syncwarp();  // every lane has read its slots
#pragma unroll
    for (int e = 0; e < E; ++e) {
        words[lane * E + e] = w[e];
        if (!PACKED) vals[lane * E + e] = v[e];
    }
    __syncwarp();
}

template <bool PACKED>
__global__ void __launch_bounds__(kWarps * 32) hops_warp_kernel(Hop h, int cap) {
    __shared__ __align__(16) unsigned char slice_s[kWarps][kWarpBytes];
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int row = blockIdx.x * kWarps + warp;
    if (row >= h.n) return;  // warp-uniform; no block barrier below
    unsigned long long* words = reinterpret_cast<unsigned long long*>(slice_s[warp]);
    float* vals = PACKED ? nullptr : reinterpret_cast<float*>(words + kCapWide);
    const int slots = h.R * h.k1;
    const int p = h.pbits;

    const int cnt = row_count(h, row, lane);
    if (cnt > cap) {
        if (lane == 0) h.over_rows[atomicAdd(h.n_over, 1)] = row;
        return;
    }
    const int len = pow2_at_least(cnt > 32 ? cnt : 32);
    const int log_e = __ffs(len) - 6;  // E = len / 32 words a lane
    if (log_e <= kRegLogE) {  // sorted in registers
        gather_row<PACKED>(h, row, lane, words, vals, log_e);
        __syncwarp();
        switch (log_e) {
            case 0: sort_slice<PACKED, 1>(words, vals, cnt, lane); break;
            case 1: sort_slice<PACKED, 2>(words, vals, cnt, lane); break;
            case 2: sort_slice<PACKED, 4>(words, vals, cnt, lane); break;
            default: sort_slice<PACKED, 8>(words, vals, cnt, lane); break;
        }
    } else {  // longer rows: the network in shared memory
        gather_row<PACKED>(h, row, lane, words, vals, 0);
        for (int q = cnt + lane; q < len; q += 32) words[q] = kPadWord;
        __syncwarp();
        bitonic(words, vals, len, lane, 32, WarpSync{});
    }

    const unsigned lt = (1u << lane) - 1u;
    int r_cnt = 0, v_cnt = 0;
    for (int q0 = 0; q0 < cnt; q0 += 32) {
        const int q = q0 + lane;
        Run run{false, false, 0.0f};
        int idx = 0;
        if (q < cnt) {
            idx = Elem<PACKED>::index(words[q], p);
            if (q == 0 || Elem<PACKED>::index(words[q - 1], p) != idx)
                run = run_at<PACKED>(words, vals, q, cnt, slots, p);
        }
        const unsigned rm = __ballot_sync(kFull, run.ring);
        const unsigned vm = __ballot_sync(kFull, run.vis);
        if (run.ring) {
            const int s = r_cnt + __popc(rm & lt);
            if (s < h.w_stage) h.r_stage[static_cast<size_t>(row) * h.w_stage + s] = idx;
        }
        if (run.vis && h.V) {
            const int s = v_cnt + __popc(vm & lt);
            if (s < h.v_stage) {
                h.v_stage_idx[static_cast<size_t>(row) * h.v_stage + s] = idx;
                h.v_stage_val[static_cast<size_t>(row) * h.v_stage + s] = run.value;
            }
        }
        r_cnt += __popc(rm);
        v_cnt += __popc(vm);
    }
    if (lane == 0) finish_row(h, row, r_cnt, v_cnt);
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

// Element `t` of the row's slots (candidates first, then visited entries):
// whether it is an element, and its 64-bit key and weight.
__device__ __forceinline__ bool slot_element(const Hop& h, int row, int t, unsigned long long& key, float& val) {
    const int slots = h.R * h.k1;
    if (t < slots) {
        const int r = t / h.k1;
        const int j = t - r * h.k1;
        const int rr = __ldg(h.ring_idx + static_cast<size_t>(row) * h.R + r);
        if (rr >= h.n) return false;
        const int b = __ldg(h.base_idx + static_cast<size_t>(rr) * h.k1 + j);
        if (b >= h.n) return false;
        key = Elem<false>::word(b, t, 32);
        val = __fmul_rn(__ldg(h.ring_w + static_cast<size_t>(row) * h.R + r),
                        __ldg(h.base_w + static_cast<size_t>(rr) * h.k1 + j));
        return true;
    }
    const int v = t - slots;
    const int b = __ldg(h.vis_idx + static_cast<size_t>(row) * h.V + v);
    if (b >= h.n) return false;
    key = Elem<false>::word(b, t, 32);
    val = __ldg(h.vis_val + static_cast<size_t>(row) * h.V + v);
    return true;
}

struct Out {
    int w_out;
    int v_out;
    int* r_out;      // (n, w_out)
    int* v_out_idx;  // (n, v_out)
    float* v_out_val;
};

// The block route over the listed rows (*n_rows of them, a count on the
// device), one row a block at a time: mode 0 stages a row past the warp's
// capacity (and lists it as late if it passes the staging widths); mode 1
// writes a late row straight into the bucketed ELLs.
__global__ void __launch_bounds__(kBlockThreads) hops_block_kernel(Hop h, int mode, const int* rows,
                                                                   const int* n_rows, long long span,
                                                                   unsigned long long* scratch_keys,
                                                                   float* scratch_vals, Out o) {
    __shared__ int placed;
    __shared__ int warp_counts[kBlockThreads / 32];
    const int count = *n_rows;
    unsigned long long* keys = scratch_keys + static_cast<size_t>(blockIdx.x) * span;
    float* vals = scratch_vals + static_cast<size_t>(blockIdx.x) * span;
    const int slots = h.R * h.k1;
    for (int i = blockIdx.x; i < count; i += gridDim.x) {
        const int row = rows[i];
        if (threadIdx.x == 0) placed = 0;
        __syncthreads();
        for (int t = threadIdx.x; t < slots + h.V; t += kBlockThreads) {
            unsigned long long key;
            float val;
            if (slot_element(h, row, t, key, val)) {
                const int q = atomicAdd(&placed, 1);  // any order: the keys carry their positions
                keys[q] = key;
                vals[q] = val;
            }
        }
        __syncthreads();
        const int cnt = placed;
        const int len = pow2_at_least(cnt > 0 ? cnt : 1);
        for (int q = cnt + threadIdx.x; q < len; q += kBlockThreads) keys[q] = kPadWord;
        __syncthreads();
        bitonic(keys, vals, len, static_cast<int>(threadIdx.x), kBlockThreads, BlockSync{});

        const int w_lim = mode ? o.w_out : h.w_stage;
        const int v_lim = mode ? o.v_out : h.v_stage;
        int* r_dst = mode ? o.r_out + static_cast<size_t>(row) * o.w_out
                          : h.r_stage + static_cast<size_t>(row) * h.w_stage;
        int* vi_dst = mode ? o.v_out_idx + static_cast<size_t>(row) * o.v_out
                           : h.v_stage_idx + static_cast<size_t>(row) * h.v_stage;
        float* vv_dst = mode ? o.v_out_val + static_cast<size_t>(row) * o.v_out
                             : h.v_stage_val + static_cast<size_t>(row) * h.v_stage;
        int r_cnt = 0, v_cnt = 0;
        for (int q0 = 0; q0 < cnt; q0 += kBlockThreads) {
            const int q = q0 + threadIdx.x;
            Run run{false, false, 0.0f};
            if (q < cnt && (q == 0 || Elem<false>::index(keys[q - 1], 32) != Elem<false>::index(keys[q], 32)))
                run = run_at<false>(keys, vals, q, cnt, slots, 32);
            int r_total, v_total;
            const int r_rank = block_rank(run.ring, warp_counts, r_total);
            const int v_rank = block_rank(run.vis, warp_counts, v_total);
            if (run.ring && r_cnt + r_rank < w_lim) r_dst[r_cnt + r_rank] = Elem<false>::index(keys[q], 32);
            if (run.vis && h.V && v_cnt + v_rank < v_lim) {
                vi_dst[v_cnt + v_rank] = Elem<false>::index(keys[q], 32);
                vv_dst[v_cnt + v_rank] = run.value;
            }
            r_cnt += r_total;
            v_cnt += v_total;
        }
        if (mode) {
            for (int s = r_cnt + threadIdx.x; s < o.w_out; s += kBlockThreads) r_dst[s] = h.n;
            if (h.V) {
                for (int s = v_cnt + threadIdx.x; s < o.v_out; s += kBlockThreads) {
                    vi_dst[s] = h.n;
                    vv_dst[s] = 0.0f;
                }
            }
        } else if (threadIdx.x == 0) {
            finish_row(h, row, r_cnt, v_cnt);
        }
        __syncthreads();  // the scratch span and `placed` are free for the next row
    }
}

// Copies each row's staged entries into the bucketed ELLs and pads the
// rest (a late row's copy is cut at the staging width; the block route
// then writes the whole row).
__global__ void hops_place_kernel(int n, int V, int w_stage, int v_stage, const int* __restrict__ r_stage,
                                  const int* __restrict__ v_stage_idx, const float* __restrict__ v_stage_val,
                                  const int* __restrict__ r_deg, const int* __restrict__ v_deg, Out o) {
    const size_t r_total = static_cast<size_t>(n) * o.w_out;
    const size_t v_total = V ? static_cast<size_t>(n) * o.v_out : 0;
    for (size_t e = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; e < r_total + v_total;
         e += static_cast<size_t>(gridDim.x) * blockDim.x) {
        if (e < r_total) {
            const int row = static_cast<int>(e / o.w_out);
            const int s = static_cast<int>(e - static_cast<size_t>(row) * o.w_out);
            const int d = min(__ldg(r_deg + row), w_stage);
            o.r_out[e] = s < d ? __ldg(r_stage + static_cast<size_t>(row) * w_stage + s) : n;
        } else {
            const size_t f = e - r_total;
            const int row = static_cast<int>(f / o.v_out);
            const int s = static_cast<int>(f - static_cast<size_t>(row) * o.v_out);
            const int d = min(__ldg(v_deg + row), v_stage);
            const bool live = s < d;
            o.v_out_idx[f] = live ? __ldg(v_stage_idx + static_cast<size_t>(row) * v_stage + s) : n;
            o.v_out_val[f] = live ? __ldg(v_stage_val + static_cast<size_t>(row) * v_stage + s) : 0.0f;
        }
    }
}

bool valid_graph(int n, int k1, int R, int V, const void* vis_idx) {
    return n > 0 && k1 > 0 && k1 % 4 == 0 && R > 0 && V >= 0 && V % 4 == 0 && (V == 0 || vis_idx != nullptr) &&
           static_cast<long long>(R) * k1 + V < 0x7fffffffLL;
}

Hop make_hop(const int* base_idx, const float* base_w, const int* base_deg, int n, int k1, const int* ring_idx,
             const float* ring_w, int R,
             const int* vis_idx, const float* vis_val, int V, int pbits, int w_stage, int v_stage, int* r_stage,
             int* v_stage_idx, float* v_stage_val, int* r_deg, int* v_deg, int* over_rows, int* n_over,
             int* late_rows, int* n_late) {
    return Hop{base_idx, base_w, base_deg, n, k1, ring_idx, ring_w, R, vis_idx, vis_val, V, pbits, w_stage, v_stage,
               r_stage, v_stage_idx, v_stage_val, r_deg, v_deg, over_rows, n_over, late_rows, n_late};
}

}  // namespace

// The warp route of one hop. The graph: base_idx/base_w (n, k1) int32/
// float32, ring_idx/ring_w (n, R), vis_idx/vis_val (n, V) or null with
// V = 0, index n padding each, k1 and V multiples of 4. key_bits 32 packs
// (index << pbits | position) with the weight in one word (needs (n + 1)
// << pbits < 2^32 and every position below 2^pbits; cap <= 1024), 64
// keeps (index << 32 | position) keys (cap <= 512). Each row with at most
// `cap` elements gets its degrees r_deg/v_deg (n,) int32 and its kept
// entries in r_stage (n, w_stage) and, with V > 0, v_stage_idx/val (n,
// v_stage), and is appended to late_rows at the counter n_late when its
// degrees pass those widths; a row with more is appended to over_rows at
// the counter n_over (both counters zeroed by the caller).
SQT_EXPORT int sqt_hops_warp(const int* base_idx, const float* base_w, const int* base_deg, int n, int k1,
                             const int* ring_idx,
                             const float* ring_w, int R, const int* vis_idx, const float* vis_val, int V, int key_bits,
                             int pbits, int cap, int w_stage, int v_stage, int* r_stage, int* v_stage_idx,
                             float* v_stage_val, int* r_deg, int* v_deg, int* over_rows, int* n_over, int* late_rows,
                             int* n_late, void* stream) {
    const bool packed = key_bits == 32;
    const long long positions = static_cast<long long>(R) * k1 + V;
    if (!valid_graph(n, k1, R, V, vis_idx) || (key_bits != 32 && key_bits != 64) || cap < 1 ||
        cap > (packed ? kCapPacked : kCapWide) || w_stage < 1 || (V > 0 && (v_stage < 1 || v_stage_idx == nullptr)) ||
        base_deg == nullptr || r_stage == nullptr || r_deg == nullptr || v_deg == nullptr || over_rows == nullptr ||
        n_over == nullptr ||
        late_rows == nullptr || n_late == nullptr ||
        (packed && (pbits < 1 || pbits > 31 || positions > (1LL << pbits) ||
                    ((static_cast<long long>(n) + 1) << pbits) >= (1LL << 32)))) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const Hop h = make_hop(base_idx, base_w, base_deg, n, k1, ring_idx, ring_w, R, vis_idx, vis_val, V, pbits, w_stage,
                           v_stage, r_stage, v_stage_idx, v_stage_val, r_deg, v_deg, over_rows, n_over, late_rows,
                           n_late);
    const unsigned blocks = static_cast<unsigned>((n + kWarps - 1) / kWarps);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (packed) hops_warp_kernel<true><<<blocks, kWarps * 32, 0, s>>>(h, cap);
    else hops_warp_kernel<false><<<blocks, kWarps * 32, 0, s>>>(h, cap);
    return static_cast<int>(cudaGetLastError());
}

// The block route over rows (n,) int32, *n_rows of them (a count on the
// device), `blocks` blocks each with its scratch span of `span` (a power of
// two at or above R k1 + V) keys (int64) and values (float32) in
// scratch_keys/scratch_vals (blocks * span each). mode 0 stages the rows
// as sqt_hops_warp does (degrees, staging ELLs, late rows); mode 1 writes
// them into r_out (n, w_out) int32 and, with V > 0, v_out_idx/v_out_val (n,
// v_out), padded.
SQT_EXPORT int sqt_hops_block(int mode, const int* base_idx, const float* base_w, int n, int k1, const int* ring_idx,
                              const float* ring_w, int R, const int* vis_idx, const float* vis_val, int V,
                              const int* rows, const int* n_rows, int blocks, long long span, long long* scratch_keys,
                              float* scratch_vals, int w_stage, int v_stage, int* r_stage, int* v_stage_idx,
                              float* v_stage_val, int* r_deg, int* v_deg, int* late_rows, int* n_late, int w_out,
                              int v_out, int* r_out, int* v_out_idx, float* v_out_val, void* stream) {
    if (!valid_graph(n, k1, R, V, vis_idx) || (mode != 0 && mode != 1) || rows == nullptr || n_rows == nullptr ||
        blocks < 1 || span < static_cast<long long>(R) * k1 + V || scratch_keys == nullptr || scratch_vals == nullptr ||
        (mode == 0 && (w_stage < 1 || r_stage == nullptr || r_deg == nullptr || v_deg == nullptr ||
                       late_rows == nullptr || n_late == nullptr ||
                       (V > 0 && (v_stage < 1 || v_stage_idx == nullptr)))) ||
        (mode == 1 && (w_out < 1 || r_out == nullptr || (V > 0 && (v_out < 1 || v_out_idx == nullptr))))) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const Hop h = make_hop(base_idx, base_w, nullptr, n, k1, ring_idx, ring_w, R, vis_idx, vis_val, V, 32, w_stage,
                           v_stage,
                           r_stage, v_stage_idx, v_stage_val, r_deg, v_deg, nullptr, nullptr, late_rows, n_late);
    const Out o{w_out, v_out, r_out, v_out_idx, v_out_val};
    hops_block_kernel<<<static_cast<unsigned>(blocks), kBlockThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        h, mode, rows, n_rows, span, reinterpret_cast<unsigned long long*>(scratch_keys), scratch_vals, o);
    return static_cast<int>(cudaGetLastError());
}

// The staging ELLs r_stage (n, w_stage), v_stage_idx/val (n, v_stage) into
// the bucketed r_out (n, w_out) and, with V > 0, v_out_idx/val (n, v_out):
// each row's first min(degree, staging width) entries, then n (values 0).
SQT_EXPORT int sqt_hops_place(int n, int V, int w_stage, int v_stage, const int* r_stage, const int* v_stage_idx,
                              const float* v_stage_val, const int* r_deg, const int* v_deg, int w_out, int v_out,
                              int* r_out, int* v_out_idx, float* v_out_val, void* stream) {
    if (n < 1 || w_stage < 1 || w_out < 1 || r_stage == nullptr || r_out == nullptr || r_deg == nullptr ||
        (V > 0 && (v_stage < 1 || v_out < 1 || v_stage_idx == nullptr || v_out_idx == nullptr || v_deg == nullptr))) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const Out o{w_out, v_out, r_out, v_out_idx, v_out_val};
    const long long total = static_cast<long long>(n) * w_out + (V ? static_cast<long long>(n) * v_out : 0);
    const long long want = (total + 255) / 256;
    const unsigned blocks = static_cast<unsigned>(want < 65536 ? want : 65536);
    hops_place_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(n, V, w_stage, v_stage, r_stage,
                                                                            v_stage_idx, v_stage_val, r_deg, v_deg, o);
    return static_cast<int>(cudaGetLastError());
}
