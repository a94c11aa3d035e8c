// K11's earlier design, four kernels a step (`sqt_sepal_steps`), kept only so
// that chip_smoke.py can time it beside the current one (csrc/sepal.cu) on the
// same inputs; no wrapper of the package calls it.
//
// Sepal's diffusion, the explicit-Euler steps of every gene of a block
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
// multiplied by f32(1/n_sat)); `logf`, not `__logf`.
//
// Bound on the card: bytes. A step reads the state and writes it once
// (the gathers of the neighbours hit the same rows again, from L2): 8 bytes
// a (node, gene) a step, ~2.5 ms at 1M x 1024 on 3.35 TB/s. This design
// reads the saturated rows a second time for the entropy (its terms need the
// first sum), so ~12 bytes.
//
// Design, four kernels a step, launched by one C call for m steps (the
// wrapper reads the active genes back once a call, so the host waits once
// every m steps; steps after every gene is done change nothing):
// (a) `step_kernel`: a block is 32 genes (a lane each) by 256 saturated rows
//     (8 warps) or 256 unsaturated rows; it writes the new state into the
//     other buffer and, for the saturated rows, the block's partial sum of
//     the positive concentrations in a fixed order: rows in runs of 8 added
//     in order, then the block's 32 runs by a pairwise tree in shared
//     memory. An inactive gene is copied one step after it froze, then left
//     alone (both buffers hold its state).
// (b) `finish_sum`: a gene's sum, the pairwise tree continued over the
//     blocks' partials (padded with zeros to a power of two).
// (c) `entropy_kernel`: the same blocks over the saturated rows, the terms
//     xn log max(xn, eps) of xn = x / sum, in the same order.
// (d) `finish_entropy`: a gene's entropy from its tree, the convergence test,
//     `done` and `active`.
// The plain torch version (squidpy_torch/ops/sepal.py `_diffusion_plain`)
// sums in the same order (runs of 8, then the tree), so the kernel and it
// agree bit for bit.

#include "common.cuh"

namespace {

constexpr int kLanes = 32;                   // genes a block, one a lane
constexpr int kWarps = 8;                    // row groups a block
constexpr int kRun = 8;                      // rows a run, added in order
constexpr int kRuns = 32;                    // runs a block
constexpr int kRows = kRun * kRuns;          // saturated rows a block
constexpr int kFinishWarps = 32;

struct Stencil {
    const int32_t* sat;    // (n_sat,) node of each saturated position
    const int32_t* nbr;    // (n_sat, k) neighbours of each saturated node
    const int32_t* unsat;  // (n_unsat,) node of each unsaturated position
    const int32_t* near;   // (n_unsat,) position in `sat` of its nearest saturated node
    int n_sat, n_unsat, k, hex;
    float dt, recip3;
};

// d2 * dt of saturated position p for gene column g (lap from the old state).
__device__ __forceinline__ float update(const float* __restrict__ c, int64_t ld, int g, const Stencil& st, int p) {
    const float centre = c[static_cast<int64_t>(__ldg(st.sat + p)) * ld + g];
    const int32_t* nb = st.nbr + static_cast<int64_t>(p) * st.k;
    float nh = c[static_cast<int64_t>(__ldg(nb)) * ld + g];
    for (int j = 1; j < st.k; ++j) nh = nh + c[static_cast<int64_t>(__ldg(nb + j)) * ld + g];
    const float d2 = st.hex ? (2.0f * nh - 12.0f * centre) * st.recip3 : nh - 4.0f * centre;
    return d2 * st.dt;
}

__device__ __forceinline__ float clamp0(float v) { return v < 0.0f ? 0.0f : v; }  // NaN stays NaN

// Pairwise tree over the block's 32 run sums s_run[run][lane], in place;
// returns the root to every thread of warp 0.
__device__ __forceinline__ float block_tree(float (*s_run)[kLanes], int lane, int warp) {
    for (int half = kRuns / 2; half >= 1; half >>= 1) {
        __syncthreads();
        float v[2];
        int cnt = 0;
        for (int i = warp; i < half; i += kWarps) v[cnt++] = s_run[2 * i][lane] + s_run[2 * i + 1][lane];
        __syncthreads();
        cnt = 0;
        for (int i = warp; i < half; i += kWarps) s_run[i][lane] = v[cnt++];
    }
    __syncthreads();
    return s_run[0][lane];
}

// (a) one step: `in` -> `out`; `part` (n_sat_blocks, g) the saturated
// blocks' partial sums of max(x, 0) of the new state.
__global__ void __launch_bounds__(kLanes * kWarps) step_kernel(const float* __restrict__ in, float* __restrict__ out,
                                                             int64_t ld, int n_genes, Stencil st,
                                                             const uint8_t* __restrict__ active,
                                                             const float* __restrict__ done, float it,
                                                             int sat_blocks, float* __restrict__ part) {
    __shared__ float s_run[kRuns][kLanes];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int g = blockIdx.y * kLanes + lane;
    const bool in_range = g < n_genes;
    const bool live = in_range && active[g];
    const bool write = live || (in_range && it <= done[g] + 1.0f);  // copy a frozen gene once
    if (blockIdx.x < sat_blocks) {
        const int p0 = blockIdx.x * kRows;
        for (int r = warp; r < kRuns; r += kWarps) {
            float acc = 0.0f;
            for (int t = 0; t < kRun; ++t) {
                const int p = p0 + r * kRun + t;
                float x = 0.0f;
                if (p < st.n_sat && write) {
                    const int64_t at = static_cast<int64_t>(__ldg(st.sat + p)) * ld + g;
                    float v = in[at];
                    if (live) v = clamp0(v + update(in, ld, g, st, p));
                    out[at] = v;
                    x = v > 0.0f ? v : 0.0f;
                }
                acc = t == 0 ? x : acc + x;
            }
            s_run[r][lane] = acc;
        }
        const float root = block_tree(s_run, lane, warp);
        if (warp == 0 && in_range) part[static_cast<int64_t>(blockIdx.x) * n_genes + g] = root;
        return;
    }
    if (!write) return;
    const int u0 = (blockIdx.x - sat_blocks) * kRows;
    for (int r = warp; r < kRows; r += kWarps) {
        const int u = u0 + r;
        if (u >= st.n_unsat) break;
        const int64_t at = static_cast<int64_t>(__ldg(st.unsat + u)) * ld + g;
        float v = in[at];
        if (live) v = clamp0(v + update(in, ld, g, st, __ldg(st.near + u)));
        out[at] = v;
    }
}

// The pairwise tree sum of part[0..count) of gene column g, padded with
// zeros to `span` (a power of two, a multiple of 32): each warp folds an
// aligned chunk with a stack of subtree sums, then the warps' roots by a
// tree in shared memory. Returns the sum to warp 0.
__device__ __forceinline__ float tree_sum(const float* __restrict__ part, int count, int span, int n_genes, int g,
                                          bool in_range, float (*s_root)[kLanes], int lane, int warp) {
    const int chunk = span / kFinishWarps;
    float stk[32];
    int lvl[32];
    int top = 0;
    for (int j = warp * chunk; j < (warp + 1) * chunk; ++j) {
        float v = (in_range && j < count) ? part[static_cast<int64_t>(j) * n_genes + g] : 0.0f;
        int l = 0;
        while (top > 0 && lvl[top - 1] == l) {
            v = stk[top - 1] + v;
            --top;
            ++l;
        }
        stk[top] = v;
        lvl[top] = l;
        ++top;
    }
    s_root[warp][lane] = stk[0];
    for (int half = kFinishWarps / 2; half >= 1; half >>= 1) {
        __syncthreads();
        float v = 0.0f;
        if (warp < half) v = s_root[2 * warp][lane] + s_root[2 * warp + 1][lane];
        __syncthreads();
        if (warp < half) s_root[warp][lane] = v;
    }
    __syncthreads();
    return s_root[0][lane];
}

// (b) sum[g] of the positive concentrations of an active gene.
__global__ void __launch_bounds__(kLanes * kFinishWarps) finish_sum(const float* __restrict__ part, int count,
                                                                  int span, int n_genes,
                                                                  const uint8_t* __restrict__ active,
                                                                  float* __restrict__ sum) {
    __shared__ float s_root[kFinishWarps][kLanes];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int g = blockIdx.x * kLanes + lane;
    const bool in_range = g < n_genes && active[g];
    const float s = tree_sum(part, count, span, n_genes, g, in_range, s_root, lane, warp);
    if (warp == 0 && in_range) sum[g] = s;
}

// (c) the entropy terms of the new state's saturated rows, per block.
__global__ void __launch_bounds__(kLanes * kWarps) entropy_kernel(const float* __restrict__ c, int64_t ld,
                                                                int n_genes, const int32_t* __restrict__ sat,
                                                                int n_sat, const uint8_t* __restrict__ active,
                                                                const float* __restrict__ sum, float eps,
                                                                float* __restrict__ part) {
    __shared__ float s_run[kRuns][kLanes];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int g = blockIdx.y * kLanes + lane;
    const bool live = g < n_genes && active[g];
    const float xs = live ? sum[g] : 1.0f;
    const float safe = xs < eps ? 1.0f : xs;
    const int p0 = blockIdx.x * kRows;
    for (int r = warp; r < kRuns; r += kWarps) {
        float acc = 0.0f;
        for (int t = 0; t < kRun; ++t) {
            const int p = p0 + r * kRun + t;
            float term = 0.0f;
            if (live && p < n_sat) {
                const float x = c[static_cast<int64_t>(__ldg(sat + p)) * ld + g];
                if (x > 0.0f) {
                    const float xn = x / safe;
                    term = xn * logf(xn < eps ? eps : xn);  // NaN stays NaN, as XLA's max
                }
            }
            acc = t == 0 ? term : acc + term;
        }
        s_run[r][lane] = acc;
    }
    const float root = block_tree(s_run, lane, warp);
    if (warp == 0 && live) part[static_cast<int64_t>(blockIdx.x) * n_genes + g] = root;
}

// (d) entropy over n_sat, the test against thresh, done and active.
__global__ void __launch_bounds__(kLanes * kFinishWarps) finish_entropy(
    const float* __restrict__ part, int count, int span, int n_genes, const float* __restrict__ sum, float eps,
    float recip_sat, float thresh, float it, uint8_t* __restrict__ active, float* __restrict__ prev,
    float* __restrict__ done) {
    __shared__ float s_root[kFinishWarps][kLanes];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int g = blockIdx.x * kLanes + lane;
    const bool live = g < n_genes && active[g];
    const float s = tree_sum(part, count, span, n_genes, g, live, s_root, lane, warp);
    if (warp != 0 || !live) return;
    float ent = -s;
    if (sum[g] < eps) ent = 0.0f;
    ent = ent * recip_sat;
    if (fabsf(ent - prev[g]) <= thresh) {
        done[g] = it;
        active[g] = 0;
    }
    prev[g] = ent;
}

}  // namespace

// `steps` steps from step `i0`: step i reads conc[i % 2] and writes conc[(i +
// 1) % 2] (`conc_a`, `conc_b`: (n, ld) float32). `sat` (n_sat,), `nbr`
// (n_sat, k), `unsat` (n_unsat,), `near` (n_unsat,) int32; `hex` picks the
// hexagonal laplacian; `recip3` = f32(1/3), `recip_sat` = f32(1/n_sat),
// `eps` the float32 epsilon. Scratch: `part_x`, `part_h` (span, n_genes),
// span a power of two >= 32 and >= the saturated blocks; `sum` (n_genes,).
// State: `active` (n_genes,) uint8, `prev` the last entropies, `done` the
// convergence step (NaN while active).
SQT_EXPORT int sqt_sepal_steps(float* conc_a, float* conc_b, int64_t ld, int n_genes, const int32_t* sat,
                               const int32_t* nbr, int n_sat, int k, const int32_t* unsat, const int32_t* near,
                               int n_unsat, int hex, float dt, float recip3, float recip_sat, float eps,
                               float thresh, int i0, int steps, int span, float* part_x, float* part_h, float* sum,
                               uint8_t* active, float* prev, float* done, void* stream) {
    const int sat_blocks = (n_sat + kRows - 1) / kRows;
    const int unsat_blocks = (n_unsat + kRows - 1) / kRows;
    if (n_sat < 1 || n_unsat < 0 || n_genes < 1 || ld < n_genes || (k != 4 && k != 6) || span < kFinishWarps ||
        span < sat_blocks || (span & (span - 1)) || i0 < 0 || steps < 0)
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const Stencil st{sat, nbr, unsat, near, n_sat, n_unsat, k, hex, dt, recip3};
    const unsigned tiles = static_cast<unsigned>((n_genes + kLanes - 1) / kLanes);
    const dim3 step_grid(static_cast<unsigned>(sat_blocks + unsat_blocks), tiles);
    const dim3 ent_grid(static_cast<unsigned>(sat_blocks), tiles);
    for (int i = i0; i < i0 + steps; ++i) {
        const float* in = (i & 1) ? conc_b : conc_a;
        float* out = (i & 1) ? conc_a : conc_b;
        const float it = static_cast<float>(i);
        step_kernel<<<step_grid, kLanes * kWarps, 0, s>>>(in, out, ld, n_genes, st, active, done, it, sat_blocks,
                                                          part_x);
        finish_sum<<<tiles, kLanes * kFinishWarps, 0, s>>>(part_x, sat_blocks, span, n_genes, active, sum);
        entropy_kernel<<<ent_grid, kLanes * kWarps, 0, s>>>(out, ld, n_genes, sat, n_sat, active, sum, eps, part_h);
        finish_entropy<<<tiles, kLanes * kFinishWarps, 0, s>>>(part_h, sat_blocks, span, n_genes, sum, eps,
                                                               recip_sat, thresh, it, active, prev, done);
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    return 0;
}
