// K11: sepal's diffusion, the explicit-Euler steps of every gene of a block
// until its entropy converges.
//
// Replaces squidpy_tpu/ops/sepal.py:35 `sepal_diffusion`, an XLA
// `while_loop` of up to n_iter steps over the (n, g) float32 state. One step:
// each saturated node (4 or 6 neighbours) gets d2 = lap(centre, sum of its
// neighbours) from the old state, an unsaturated node the d2 of its nearest
// saturated node; conc += d2 * dt, clamped at 0; converged (inactive) genes
// keep their state. Then each gene's Shannon entropy over the saturated rows
// (over n_sat), and a gene whose |entropy change| <= thresh is done at that
// step. The arithmetic is XLA's on the CPU as it compiles JAX's code (no FMA
// anywhere; a division by a constant becomes a product with its rounded
// reciprocal: the hex laplacian is (2 nh - 12 c) * f32(1/3), the entropy is
// multiplied by f32(1/n_sat); and a saturated node's hex update folds the two
// constants: (2 nh - 12 c) * f32(f32(1/3) * dt)); `logf`, not `__logf`. Both of a gene's column
// sums (the positive state, then the entropy terms x/sum log max(x/sum, eps))
// take one fixed order: saturated rows in runs of 8 added in order, then a
// pairwise tree over the runs, padded with zeros. The plain torch version
// (squidpy_torch/ops/sepal.py `_diffusion_plain`) sums in that order, so the
// kernels and it agree bit for bit.
//
// Bound on the card: bytes on the streaming route, the state read and written
// once a step (8 bytes a (node, gene); the neighbours' rows hit the same
// lines again, from L2); shared-memory traffic and operations on the resident
// route (PERF.md states the formula).
//
// Design: two routes, chosen on the host by shape (ops/sepal.py `_k11_route`).
//
// Streaming (`sqt_sepal_passes`), any section. One kernel a step, a "pass":
// pass p reads state p and, in that one read, computes
//   - the entropy terms of state p (step p - 1's entropy), with the sum of
//     state p that pass p - 1 finished;
//   - state p + 1, written into the other buffer;
//   - the partial sums of state p + 1's positive values.
// So a gene's convergence at step p - 1 is known only at the end of pass p,
// after pass p wrote state p + 1 for it: its final state (state p) stays in
// the buffer pass p read, and pass p + 1 copies it back over the other buffer
// (`it == done + 2`). The wrapper returns the buffer the last pass read; at
// the budget's end a last pass computes only the entropy. A block is 64 genes
// (two a lane: one 8-byte load covers a row's 256 bytes, and a row's index
// and address work serves two genes; the wrapper pads an odd gene count to an
// even leading dimension) by 256 saturated rows (8 warps, 4 runs of 8 rows a
// warp) or 256 unsaturated rows; it stages its rows' element offsets (node x
// ld / 2, 32 bits) and its neighbours' in shared memory with coalesced loads,
// then issues the k + 1 state loads of 4 rows before any arithmetic (several
// rows' lines in flight a warp). The block numbers run gene tile fastest, so
// the tiles of one row block share its index tables and neighbour rows in
// L2. Only the warp that writes a block's partial fences. The partials fold
// without a launch of their own: a block writes its (sum, entropy) partial,
// and the last block of each group of 32 (a ticket counter behind
// __threadfence) folds the group's partials by a pairwise tree, level after
// level; the last block of the top level finishes the gene: the test, done,
// the flags for the next pass. Every fold is a subtree of the one tree, so
// the order is fixed whichever block folds it.
//
// Resident (`sqt_sepal_resident`), sections whose two buffers of a gene
// column fit in a block's shared memory (a Visium section: 4,992 spots, 20 KB
// a column; up to 5 genes a block, fewer where that leaves fewer rounds of
// blocks on the card's SMs: 4 there). A block of 1024 threads loads the
// columns of its genes once, runs every step to convergence or the budget in
// one launch (the same late entropy: one sweep of the shared state a step, a
// warp taking 32 saturated positions of every live gene, the next 32's index
// loads issued before this one's arithmetic, each run of 8 summed in order
// through the warp's scratch in shared memory, not by shuffles, which issue
// at one warp a clock an SM; then a block barrier, one warp a gene folds its
// 32-position partials by a pairwise tree and tests, a barrier), and writes
// the final columns once. Measured on an H100 (Visium, 2000 genes):
// 512-thread blocks (two an SM) 10-30% slower; the genes of a unit as a
// template (their instructions interleaved) no faster; the scratch ~4%
// faster than the shuffles.

#include "common.cuh"

namespace {

constexpr int kLanes = 32;           // lanes a warp; a streaming tile holds two genes a lane
constexpr int kTileGenes = 2 * kLanes;
constexpr int kWarps = 8;            // row groups a streaming block
constexpr int kRun = 8;              // rows a run, added in order
constexpr int kBatch = 4;            // rows whose loads a warp issues at once
constexpr int kRuns = 32;            // runs a streaming block
constexpr int kRows = kRun * kRuns;  // saturated (or unsaturated) rows a streaming block
constexpr int kFan = 32;             // partials folded by one block, a group
constexpr int kResThreads = 1024;    // threads a resident block (512: 10-30% slower on Visium, H100)
constexpr int kResMaxGenes = 8;      // genes a resident block, at most
constexpr int kScratch = 36;         // float2 a resident warp's scratch: 32 values, 4 runs

struct Stencil {
    const int32_t* sat;    // (n_sat,) node of each saturated position
    const int32_t* nbr;    // (n_sat, k) neighbours of each saturated node
    const int32_t* unsat;  // (n_unsat,) node of each unsaturated position
    const int32_t* near;   // (n_unsat,) position in `sat` of its nearest saturated node
    int n_sat, n_unsat, k, hex;
    float dt, recip3, recip3dt;
};

struct Pass {
    float* in;  // written only by the copies of a gene frozen two passes ago
    float* out;
    int64_t ld;  // even
    int n_genes, tiles, sat_blocks, it, step;  // step: pass `it` computes state it + 1
    const uint8_t* active_in;                  // genes live at the pass's start
    uint8_t* active_out;                       // written by the finishing blocks
    float* done;
    float* prev;
    const float* sum_in;  // the sum of the positive values of state `it`
    float* sum_out;       // ... of state it + 1
    float4* part;         // (levels' partials, tiles, 32): a lane's two genes' (sum, entropy)
    int32_t* tickets;     // (levels' groups, tiles), zero between passes
    float eps, recip_sat, thresh;
};

__device__ __forceinline__ float clamp0(float v) { return v < 0.0f ? 0.0f : v; }  // NaN stays NaN

// d2 * dt of a saturated node: XLA folds the hex laplacian's (x * f32(1/3)) * dt
// into x * f32(f32(1/3) * dt) there ...
__device__ __forceinline__ float sat_update(float centre, float nh, const Stencil& st) {
    return st.hex ? (2.0f * nh - 12.0f * centre) * st.recip3dt : (nh - 4.0f * centre) * st.dt;
}

// ... but not through the gather of an unsaturated node's update.
__device__ __forceinline__ float unsat_update(float centre, float nh, const Stencil& st) {
    const float d2 = st.hex ? (2.0f * nh - 12.0f * centre) * st.recip3 : nh - 4.0f * centre;
    return d2 * st.dt;
}

// An entropy term of the old value x (0 unless x > 0), as the plain version.
__device__ __forceinline__ float entropy_term(float x, float safe, float eps) {
    if (!(x > 0.0f)) return 0.0f;
    const float xn = x / safe;
    return xn * logf(xn < eps ? eps : xn);  // NaN stays NaN, as XLA's max
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
    return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// Pairwise tree over s_run[0, 32)[lane], in place; the root to warp 0.
__device__ __forceinline__ float4 block_tree(float4 (*s_run)[kLanes], int lane, int warp) {
    for (int half = kRuns / 2; half >= 1; half >>= 1) {
        __syncthreads();
        float4 v[2];
        int cnt = 0;
        for (int i = warp; i < half; i += kWarps) v[cnt++] = add4(s_run[2 * i][lane], s_run[2 * i + 1][lane]);
        __syncthreads();
        cnt = 0;
        for (int i = warp; i < half; i += kWarps) s_run[i][lane] = v[cnt++];
    }
    __syncthreads();
    return s_run[0][lane];
}

// A lane's two genes of one tile.
struct Lane2 {
    bool live[2], copy[2], step[2], ent[2];
    float safe[2];
};

__device__ __forceinline__ void store_each(float* p, float2 v, const bool (&w)[2]) {
    if (w[0] && w[1]) {
        *reinterpret_cast<float2*>(p) = v;
    } else {
        if (w[0]) p[0] = v.x;
        if (w[1]) p[1] = v.y;
    }
}

// One pass over a saturated block's rows (element offsets staged in s_off
// and s_noff, in float2 units); each run's (sum, entropy) of both genes
// into s_run[run][lane].
template <int K>
__device__ __forceinline__ void sat_rows(const Pass& ps, const Stencil& st, int p0, int col2,
                                         const uint32_t* s_off, const uint32_t* s_noff,
                                         float4 (*s_run)[kLanes], const Lane2& ln, int lane, int warp) {
    const float2* in2 = reinterpret_cast<const float2*>(ps.in) + col2;
    const bool stepping = ln.step[0] || ln.step[1];
    const bool reading = stepping || ln.ent[0] || ln.ent[1];
    for (int r = warp; r < kRuns; r += kWarps) {
        float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (reading) {
#pragma unroll
            for (int b = 0; b < kRun / kBatch; ++b) {
                float2 c[kBatch], nb[kBatch][K];
#pragma unroll
                for (int t = 0; t < kBatch; ++t) {
                    const int q = r * kRun + b * kBatch + t;
                    const bool valid = p0 + q < st.n_sat;
                    c[t] = valid ? in2[s_off[q]] : make_float2(0.0f, 0.0f);
                    if (stepping) {
#pragma unroll
                        for (int j = 0; j < K; ++j) nb[t][j] = valid ? in2[s_noff[q * K + j]] : make_float2(0.0f, 0.0f);
                    }
                }
#pragma unroll
                for (int t = 0; t < kBatch; ++t) {
                    const int q = r * kRun + b * kBatch + t;
                    const bool valid = p0 + q < st.n_sat;
                    float x0 = 0.0f, x1 = 0.0f, h0 = 0.0f, h1 = 0.0f;
                    if (stepping && valid) {
                        float2 nh = nb[t][0];
#pragma unroll
                        for (int j = 1; j < K; ++j) nh = make_float2(nh.x + nb[t][j].x, nh.y + nb[t][j].y);
                        const float2 v = make_float2(clamp0(c[t].x + sat_update(c[t].x, nh.x, st)),
                                                     clamp0(c[t].y + sat_update(c[t].y, nh.y, st)));
                        store_each(ps.out + 2 * (static_cast<int64_t>(s_off[q]) + col2), v, ln.step);
                        if (ln.step[0]) x0 = v.x > 0.0f ? v.x : 0.0f;
                        if (ln.step[1]) x1 = v.y > 0.0f ? v.y : 0.0f;
                    }
                    if (ln.ent[0] && valid) h0 = entropy_term(c[t].x, ln.safe[0], ps.eps);
                    if (ln.ent[1] && valid) h1 = entropy_term(c[t].y, ln.safe[1], ps.eps);
                    const bool first = b == 0 && t == 0;
                    acc = first ? make_float4(x0, h0, x1, h1) : add4(acc, make_float4(x0, h0, x1, h1));
                }
            }
        }
        s_run[r][lane] = acc;
        if (ln.copy[0] || ln.copy[1]) {
            for (int t = 0; t < kRun; ++t) {
                const int q = r * kRun + t;
                if (p0 + q < st.n_sat) {
                    float* at = ps.in + 2 * (static_cast<int64_t>(s_off[q]) + col2);
                    const float* from = ps.out + 2 * (static_cast<int64_t>(s_off[q]) + col2);
                    if (ln.copy[0]) at[0] = from[0];
                    if (ln.copy[1]) at[1] = from[1];
                }
            }
        }
    }
}

// The unsaturated rows of a streaming block: each takes the update of its
// nearest saturated node (s_off its own offset, s_coff that node's, s_noff
// that node's neighbours'), 4 rows' loads a warp in flight at once.
template <int K>
__device__ __forceinline__ void unsat_rows(const Pass& ps, const Stencil& st, int u0, int col2, const uint32_t* s_off,
                                           const uint32_t* s_coff, const uint32_t* s_noff, const Lane2& ln,
                                           int warp) {
    const float2* in2 = reinterpret_cast<const float2*>(ps.in) + col2;
    if (ln.step[0] || ln.step[1]) {
        for (int r0 = warp; r0 < kRows; r0 += kWarps * kBatch) {
            float2 own[kBatch], c[kBatch], nb[kBatch][K];
#pragma unroll
            for (int t = 0; t < kBatch; ++t) {
                const int q = r0 + t * kWarps;
                const bool valid = u0 + q < st.n_unsat;
                own[t] = valid ? in2[s_off[q]] : make_float2(0.0f, 0.0f);
                c[t] = valid ? in2[s_coff[q]] : make_float2(0.0f, 0.0f);
#pragma unroll
                for (int j = 0; j < K; ++j) nb[t][j] = valid ? in2[s_noff[q * K + j]] : make_float2(0.0f, 0.0f);
            }
#pragma unroll
            for (int t = 0; t < kBatch; ++t) {
                const int q = r0 + t * kWarps;
                if (u0 + q >= st.n_unsat) continue;
                float2 nh = nb[t][0];
#pragma unroll
                for (int j = 1; j < K; ++j) nh = make_float2(nh.x + nb[t][j].x, nh.y + nb[t][j].y);
                const float2 v = make_float2(clamp0(own[t].x + unsat_update(c[t].x, nh.x, st)),
                                             clamp0(own[t].y + unsat_update(c[t].y, nh.y, st)));
                store_each(ps.out + 2 * (static_cast<int64_t>(s_off[q]) + col2), v, ln.step);
            }
        }
    }
    if (ln.copy[0] || ln.copy[1]) {
        for (int q = warp; q < kRows; q += kWarps) {
            if (u0 + q >= st.n_unsat) break;
            float* at = ps.in + 2 * (static_cast<int64_t>(s_off[q]) + col2);
            const float* from = ps.out + 2 * (static_cast<int64_t>(s_off[q]) + col2);
            if (ln.copy[0]) at[0] = from[0];
            if (ln.copy[1]) at[1] = from[1];
        }
    }
}

// The streaming route's pass: blocks [0, sat_blocks * tiles) take saturated
// rows, the rest unsaturated rows; block b is row block b / tiles of gene
// tile b % tiles.
template <int K>
__global__ void __launch_bounds__(kLanes * kWarps, 2) pass_kernel(Pass ps, Stencil st) {
    __shared__ uint32_t s_off[kRows];
    __shared__ uint32_t s_coff[kRows];
    __shared__ uint32_t s_noff[kRows * K];
    __shared__ float4 s_run[kRuns][kLanes];
    __shared__ int s_last;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int tile = static_cast<int>(blockIdx.x % ps.tiles);
    const int rb = static_cast<int>(blockIdx.x / ps.tiles);
    const int g0 = tile * kTileGenes + 2 * lane;
    const int col2 = tile * kLanes + lane;  // the lane's float2 column
    const uint32_t half_ld = static_cast<uint32_t>(ps.ld / 2);
    Lane2 ln;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
        const int g = g0 + e;
        const bool in_range = g < ps.n_genes;
        ln.live[e] = in_range && ps.active_in[g];
        ln.copy[e] = in_range && !ln.live[e] && static_cast<float>(ps.it) == ps.done[g] + 2.0f;
        ln.step[e] = ln.live[e] && ps.step;
        ln.ent[e] = ln.live[e] && ps.it >= 1;
        float safe = 1.0f;
        if (ln.ent[e]) {
            const float xs = ps.sum_in[g];
            safe = xs < ps.eps ? 1.0f : xs;
        }
        ln.safe[e] = safe;
    }
    if (rb >= ps.sat_blocks) {  // unsaturated rows: the step only
        const int u0 = (rb - ps.sat_blocks) * kRows;
        const int u = u0 + threadIdx.x;
        if (u < st.n_unsat) {
            const int32_t q = __ldg(st.near + u);
            s_off[threadIdx.x] = static_cast<uint32_t>(__ldg(st.unsat + u)) * half_ld;
            s_coff[threadIdx.x] = static_cast<uint32_t>(__ldg(st.sat + q)) * half_ld;
#pragma unroll
            for (int j = 0; j < K; ++j)
                s_noff[threadIdx.x * K + j] =
                    static_cast<uint32_t>(__ldg(st.nbr + static_cast<int64_t>(q) * K + j)) * half_ld;
        }
        __syncthreads();
        unsat_rows<K>(ps, st, u0, col2, s_off, s_coff, s_noff, ln, warp);
        return;
    }
    const int p0 = rb * kRows;
    if (p0 + static_cast<int>(threadIdx.x) < st.n_sat)
        s_off[threadIdx.x] = static_cast<uint32_t>(__ldg(st.sat + p0 + threadIdx.x)) * half_ld;
    const int64_t nb0 = static_cast<int64_t>(p0) * K, nb_end = static_cast<int64_t>(st.n_sat) * K;
    for (int j = threadIdx.x; j < kRows * K; j += kLanes * kWarps)
        if (nb0 + j < nb_end) s_noff[j] = static_cast<uint32_t>(__ldg(st.nbr + nb0 + j)) * half_ld;
    __syncthreads();
    sat_rows<K>(ps, st, p0, col2, s_off, s_noff, s_run, ln, lane, warp);
    float4 v = block_tree(s_run, lane, warp);

    // fold the partials up the levels: the last block of a group of 32 folds it
    int idx = rb, count = ps.sat_blocks;
    int64_t part_off = 0, ticket_off = 0;
    while (count > 1) {
        if (warp == 0) {  // only the partial's writers fence: the state's stores need no order
            ps.part[((part_off + idx) * ps.tiles + tile) * kLanes + lane] = v;
            __threadfence();
        }
        __syncthreads();
        const int grp = idx / kFan, groups = (count + kFan - 1) / kFan;
        const int members = count - grp * kFan < kFan ? count - grp * kFan : kFan;
        if (threadIdx.x == 0) {
            int32_t* t = ps.tickets + (ticket_off + grp) * ps.tiles + tile;
            const int arrived = atomicAdd(t, 1);
            s_last = arrived == members - 1;
            if (s_last) *t = 0;  // every member has arrived: ready for the next pass
        }
        __syncthreads();
        if (!s_last) return;
        __threadfence();
        for (int j = warp; j < kFan; j += kWarps) {
            const float4* at = ps.part + ((part_off + grp * kFan + j) * ps.tiles + tile) * kLanes + lane;
            s_run[j][lane] = j < members ? __ldcg(at) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        }
        v = block_tree(s_run, lane, warp);
        part_off += count;
        ticket_off += groups;
        idx = grp;
        count = groups;
    }
    // the root of the gene tile: the convergence test of step it - 1
    if (warp != 0) return;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
        const int g = g0 + e;
        if (g >= ps.n_genes) break;
        const float sum = e ? v.z : v.x, ent_sum = e ? v.w : v.y;
        bool conv = false;
        if (ln.live[e]) {
            if (ps.it >= 1) {
                float ent = -ent_sum;
                if (ps.sum_in[g] < ps.eps) ent = 0.0f;
                ent = ent * ps.recip_sat;
                if (fabsf(ent - ps.prev[g]) <= ps.thresh) {
                    ps.done[g] = static_cast<float>(ps.it - 1);
                    conv = true;
                }
                ps.prev[g] = ent;
            }
            if (ps.step) ps.sum_out[g] = sum;
        }
        ps.active_out[g] = ln.live[e] && !conv;
    }
}

// The resident route: a block of up to kResMaxGenes genes, both buffers of
// their columns in shared memory, every step in one launch.
struct Resident {
    float* conc;  // (n, ld): read at the start, the final state written at the end
    int64_t ld;
    int n_genes, n, genes, n_pad, span, n_iter;
    float* done;
    float eps, recip_sat, thresh;
};

// The pairwise tree of part[0, span) (a power of two >= 32; zeros past
// `count`) over a warp, in place: levels in shared memory down to 32 values
// (a round's pairs read before any is written), then by shuffles. Returns it
// to lane 0.
__device__ __forceinline__ float2 warp_tree(float2* part, int count, int span, int lane) {
    for (int j = count + lane; j < span; j += 32) part[j] = make_float2(0.0f, 0.0f);
    __syncwarp();
    for (int width = span; width > 32; width >>= 1) {
        for (int i = lane; i < width / 2; i += 32) {  // width / 2 is a multiple of 32
            const float2 a = part[2 * i], b = part[2 * i + 1];
            __syncwarp();
            part[i] = make_float2(a.x + b.x, a.y + b.y);
            __syncwarp();
        }
    }
    float2 v = part[lane];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
        const float x = __shfl_down_sync(0xFFFFFFFFu, v.x, off), y = __shfl_down_sync(0xFFFFFFFFu, v.y, off);
        v = make_float2(v.x + x, v.y + y);
    }
    return v;
}

template <int K>
__device__ __forceinline__ void load_sat(const Stencil& st, int q, int& node, int (&nbn)[K]) {
    if (q < st.n_sat) {
        node = __ldg(st.sat + q);
#pragma unroll
        for (int j = 0; j < K; ++j) nbn[j] = __ldg(st.nbr + static_cast<int64_t>(q) * K + j);
    } else {
        node = 0;
#pragma unroll
        for (int j = 0; j < K; ++j) nbn[j] = 0;
    }
}

template <int K>
__global__ void __launch_bounds__(kResThreads) resident_kernel(Resident rs, Stencil st) {
    extern __shared__ __align__(16) float s_buf[];  // [2][genes][n_pad], then part [genes][span]
    __shared__ float s_sum[kResMaxGenes], s_prev[kResMaxGenes], s_done[kResMaxGenes];
    __shared__ int s_live[kResMaxGenes], s_final[kResMaxGenes];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int threads = kResThreads, warps = kResThreads / 32;
    const int g0 = blockIdx.x * rs.genes;
    const int gn = rs.n_genes - g0 < rs.genes ? rs.n_genes - g0 : rs.genes;
    float2* part = reinterpret_cast<float2*>(s_buf + 2 * static_cast<int64_t>(rs.genes) * rs.n_pad);
    float2* scratch = part + rs.genes * rs.span + warp * kScratch;  // a warp's 32 values, then its 4 runs
    // state 0 in buffer 0; buffer 1 starts as state 0 clamped at 0, which a
    // node of neither table (a degree above k) keeps at every step
    for (int64_t i = threadIdx.x; i < static_cast<int64_t>(rs.n) * gn; i += threads) {
        const int node = static_cast<int>(i / gn), gi = static_cast<int>(i % gn);
        const float v = rs.conc[node * rs.ld + g0 + gi];
        s_buf[static_cast<int64_t>(gi) * rs.n_pad + node] = v;
        s_buf[static_cast<int64_t>(rs.genes + gi) * rs.n_pad + node] = clamp0(v);
    }
    if (threadIdx.x < kResMaxGenes) {
        s_live[threadIdx.x] = threadIdx.x < gn;
        s_prev[threadIdx.x] = 1.0f;
        s_done[threadIdx.x] = __int_as_float(0x7FC00000);
        s_final[threadIdx.x] = 0;
        s_sum[threadIdx.x] = 0.0f;
    }
    __syncthreads();
    const int sat_units = (st.n_sat + 31) / 32, unsat_units = (st.n_unsat + 31) / 32;
    for (int p = 0; p <= rs.n_iter; ++p) {
        int any = 0;
        for (int gi = 0; gi < gn; ++gi) any |= s_live[gi];
        if (!any) break;
        const int cur = p & 1;
        const bool step = p < rs.n_iter;
        int node, nbn[K];
        load_sat<K>(st, warp * 32 + lane, node, nbn);
        for (int unit = warp; unit < sat_units; unit += warps) {
            int node_next, nbn_next[K];  // the next unit's indices, in flight during this one's arithmetic
            load_sat<K>(st, (unit + warps) * 32 + lane, node_next, nbn_next);
            const bool valid = unit * 32 + lane < st.n_sat;
#pragma unroll
            for (int gi = 0; gi < kResMaxGenes; ++gi) {
                if (gi >= gn || !s_live[gi]) continue;
                const float* c = s_buf + static_cast<int64_t>(cur * rs.genes + gi) * rs.n_pad;
                float* nx = s_buf + static_cast<int64_t>((cur ^ 1) * rs.genes + gi) * rs.n_pad;
                float x = 0.0f, h = 0.0f;
                const float old = valid ? c[node] : 0.0f;
                if (step && valid) {
                    float nh = c[nbn[0]];
#pragma unroll
                    for (int j = 1; j < K; ++j) nh = nh + c[nbn[j]];
                    const float v = clamp0(old + sat_update(old, nh, st));
                    nx[node] = v;
                    x = v > 0.0f ? v : 0.0f;
                }
                if (p >= 1 && valid) {
                    const float xs = s_sum[gi];
                    h = entropy_term(old, xs < rs.eps ? 1.0f : xs, rs.eps);
                }
                // the runs of 8 in order, then the 4 runs' tree, through the
                // warp's scratch
                scratch[lane] = make_float2(x, h);
                __syncwarp();
                if (lane < 4) {
                    const float4* run = reinterpret_cast<const float4*>(scratch + lane * kRun);
                    float4 v = run[0];
                    float2 acc = make_float2(v.x + v.z, v.y + v.w);
#pragma unroll
                    for (int t = 1; t < kRun / 2; ++t) {
                        v = run[t];
                        acc = make_float2((acc.x + v.x) + v.z, (acc.y + v.y) + v.w);
                    }
                    scratch[32 + lane] = acc;
                }
                __syncwarp();
                if (lane == 0) {
                    const float2 r0 = scratch[32], r1 = scratch[33], r2 = scratch[34], r3 = scratch[35];
                    part[gi * rs.span + unit] = make_float2((r0.x + r1.x) + (r2.x + r3.x), (r0.y + r1.y) + (r2.y + r3.y));
                }
                __syncwarp();
            }
            node = node_next;
#pragma unroll
            for (int j = 0; j < K; ++j) nbn[j] = nbn_next[j];
        }
        for (int unit = warp; step && unit < unsat_units; unit += warps) {
            const int u = unit * 32 + lane;
            if (u >= st.n_unsat) continue;
            const int32_t q = __ldg(st.near + u);
            const int own = __ldg(st.unsat + u), cen = __ldg(st.sat + q);
            int nb[K];
#pragma unroll
            for (int j = 0; j < K; ++j) nb[j] = __ldg(st.nbr + static_cast<int64_t>(q) * K + j);
#pragma unroll
            for (int gi = 0; gi < kResMaxGenes; ++gi) {
                if (gi >= gn || !s_live[gi]) continue;
                const float* c = s_buf + static_cast<int64_t>(cur * rs.genes + gi) * rs.n_pad;
                float* nx = s_buf + static_cast<int64_t>((cur ^ 1) * rs.genes + gi) * rs.n_pad;
                float nh = c[nb[0]];
#pragma unroll
                for (int j = 1; j < K; ++j) nh = nh + c[nb[j]];
                nx[own] = clamp0(c[own] + unsat_update(c[cen], nh, st));
            }
        }
        __syncthreads();
        if (warp < gn && s_live[warp]) {
            const float2 v = warp_tree(part + warp * rs.span, sat_units, rs.span, lane);
            if (lane == 0) {
                bool on = true;
                if (p >= 1) {
                    float ent = -v.y;
                    if (s_sum[warp] < rs.eps) ent = 0.0f;
                    ent = ent * rs.recip_sat;
                    if (fabsf(ent - s_prev[warp]) <= rs.thresh) {
                        s_done[warp] = static_cast<float>(p - 1);
                        on = false;
                    }
                    s_prev[warp] = ent;
                }
                if (on && !step) on = false;  // the budget: state n_iter is final
                if (on) {
                    s_sum[warp] = v.x;
                } else {
                    s_live[warp] = 0;
                    s_final[warp] = cur;
                }
            }
        }
        __syncthreads();
        if (p == 0 && rs.n_iter > 0) {  // buffer 0 holds state 2 next: its other nodes clamped too
            for (int64_t i = threadIdx.x; i < static_cast<int64_t>(gn) * rs.n_pad; i += threads)
                s_buf[i] = clamp0(s_buf[i]);
            __syncthreads();
        }
    }
    for (int64_t i = threadIdx.x; i < static_cast<int64_t>(rs.n) * gn; i += threads) {
        const int node = static_cast<int>(i / gn), gi = static_cast<int>(i % gn);
        rs.conc[node * rs.ld + g0 + gi] = s_buf[static_cast<int64_t>(s_final[gi] * rs.genes + gi) * rs.n_pad + node];
    }
    if (threadIdx.x < gn) rs.done[g0 + threadIdx.x] = s_done[threadIdx.x];
}

template <int K>
cudaError_t launch_resident(const Resident& rs, const Stencil& st, unsigned blocks, size_t smem, cudaStream_t s) {
    const cudaError_t err = sqt_allow_smem(resident_kernel<K>, smem);
    if (err != cudaSuccess) return err;
    resident_kernel<K><<<blocks, kResThreads, smem, s>>>(rs, st);
    return cudaGetLastError();
}

bool valid_stencil(int n_sat, int n_unsat, int n_genes, int64_t ld, int k) {
    return n_sat >= 1 && n_unsat >= 0 && n_genes >= 1 && ld >= n_genes && (k == 4 || k == 6);
}

}  // namespace

// `passes` passes from pass `i0` of the streaming route: pass p reads
// conc[p % 2] and writes conc[(p + 1) % 2] (`conc_a`, `conc_b`: (n, ld)
// float32, ld even, n * ld / 2 below 2^32); pass `n_iter` takes no step.
// `sat` (n_sat,), `nbr` (n_sat, k), `unsat` (n_unsat,), `near` (n_unsat,)
// int32; `hex` picks the hexagonal laplacian; `recip3` = f32(1/3), `recip3dt`
// = f32(recip3 * dt), `recip_sat` = f32(1/n_sat), `eps` the float32 epsilon.
// State: `active` (2, n_genes) uint8 (pass p reads row p % 2 and writes the
// other), `sums` (2, n_genes) float32 likewise, `prev` the last entropies,
// `done` the convergence step (NaN while active). Scratch: `part` float4
// (parts, tiles, 32) and `tickets` int32 (groups, tiles), zero before the
// first pass, where tiles are the 64-gene tiles and parts and groups sum the
// fold's levels (ops/sepal.py `_k11_levels`).
SQT_EXPORT int sqt_sepal_passes(float* conc_a, float* conc_b, int64_t ld, int n_genes, const int32_t* sat,
                                const int32_t* nbr, int n_sat, int k, const int32_t* unsat, const int32_t* near,
                                int n_unsat, int hex, float dt, float recip3, float recip3dt, float recip_sat,
                                float eps, float thresh, int n_iter, int i0, int passes, void* part,
                                int32_t* tickets, uint8_t* active, float* sums, float* prev, float* done,
                                void* stream) {
    if (!valid_stencil(n_sat, n_unsat, n_genes, ld, k) || (ld & 1) || i0 < 0 || passes < 0 ||
        i0 + passes > n_iter + 1)
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const Stencil st{sat, nbr, unsat, near, n_sat, n_unsat, k, hex, dt, recip3, recip3dt};
    const int sat_blocks = (n_sat + kRows - 1) / kRows, unsat_blocks = (n_unsat + kRows - 1) / kRows;
    const int tiles = (n_genes + kTileGenes - 1) / kTileGenes;
    const int64_t blocks = static_cast<int64_t>(sat_blocks + unsat_blocks) * tiles;
    if (blocks > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
    for (int p = i0; p < i0 + passes; ++p) {
        const int a = p & 1;
        Pass ps{a ? conc_b : conc_a, a ? conc_a : conc_b, ld, n_genes, tiles, sat_blocks, p, p < n_iter,
                active + static_cast<int64_t>(a) * n_genes, active + static_cast<int64_t>(a ^ 1) * n_genes, done,
                prev, sums + static_cast<int64_t>(a) * n_genes, sums + static_cast<int64_t>(a ^ 1) * n_genes,
                static_cast<float4*>(part), tickets, eps, recip_sat, thresh};
        if (k == 4)
            pass_kernel<4><<<static_cast<unsigned>(blocks), kLanes * kWarps, 0, s>>>(ps, st);
        else
            pass_kernel<6><<<static_cast<unsigned>(blocks), kLanes * kWarps, 0, s>>>(ps, st);
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    return 0;
}

// The current device's opt-in shared memory a block, in bytes (out[0]), and
// its SMs (out[1]).
SQT_EXPORT int sqt_device_info(int* out) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(out, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(out + 1, cudaDevAttrMultiProcessorCount, dev);
    return static_cast<int>(err);
}

// The resident route: the whole diffusion of `conc` (n, ld) float32 in one
// launch, `genes` genes a block (1 to 8), the final state written back over
// `conc` and each gene's step into `done` (NaN where the budget ran out).
SQT_EXPORT int sqt_sepal_resident(float* conc, int64_t ld, int n_genes, int n, const int32_t* sat,
                                  const int32_t* nbr, int n_sat, int k, const int32_t* unsat, const int32_t* near,
                                  int n_unsat, int hex, float dt, float recip3, float recip3dt, float recip_sat,
                                  float eps, float thresh, int n_iter, int genes, float* done, void* stream) {
    if (!valid_stencil(n_sat, n_unsat, n_genes, ld, k) || n < 1 || n_iter < 0 || genes < 1 ||
        genes > kResMaxGenes)
        return static_cast<int>(cudaErrorInvalidValue);
    const int64_t n_pad = (static_cast<int64_t>(n) + 3) & ~static_cast<int64_t>(3);
    int span = 32;
    while (span < (n_sat + 31) / 32) span <<= 1;
    // both buffers of each gene's column, its 32-position partials and the
    // warps' scratch (ops/sepal.py `_k11_resident_smem`)
    const size_t smem = static_cast<size_t>((2 * genes * n_pad) * 4 + static_cast<int64_t>(genes) * span * 8 +
                                            (kResThreads / 32) * kScratch * 8);
    const Stencil st{sat, nbr, unsat, near, n_sat, n_unsat, k, hex, dt, recip3, recip3dt};
    const Resident rs{conc, ld, n_genes, n, genes, static_cast<int>(n_pad), span, n_iter, done, eps, recip_sat,
                      thresh};
    const unsigned blocks = static_cast<unsigned>((n_genes + genes - 1) / genes);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return static_cast<int>(k == 4 ? launch_resident<4>(rs, st, blocks, smem, s)
                                   : launch_resident<6>(rs, st, blocks, smem, s));
}
