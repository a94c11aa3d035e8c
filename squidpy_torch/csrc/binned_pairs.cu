// K1: boundary-block pair counts of the binned co-occurrence sweep.
//
// Replaces the Pallas kernel squidpy_tpu/ops/pallas_binned.py `_kernel_body`
// (launched by `_pallas_call_chunked`, line 196). The host plan
// (ops/pairbins.py `plan_binned_pairs`) lists work items (ti, tj, gid, rempty,
// rfull): a pair of Morton-sorted tiles and one group of `gsize` consecutive
// thresholds. For each item this kernel counts, for every threshold r of the
// group inside the item's window [rempty, rfull), the class pairs (a, b) of
// points i < j (i in tile ti, j in tile tj) with d2(i, j) <= thr[r]. The host
// adds the analytic full-block counts and symmetrises.
//
// Bound on the card: ALU. An item is tile x tile candidate pairs (up to 1M at
// tile 1024) read from shared memory; the distance, the bin search over <=
// gsize thresholds and a shared-memory atomic cost ~20-30 instructions per
// pair, against 8 bytes per point of device-memory input per item.
//
// Design:
// - one block per item; both tiles' coordinates and labels are staged in
//   shared memory, each thread keeps one column point in registers and walks
//   the rows (a broadcast read);
// - d2 = dx*dx + dy*dy (+ dz*dz) with __fmul_rn/__fadd_rn, so no FMA
//   contraction: it rounds exactly as the plain torch version's separate
//   elementwise ops and as the JAX difference form. The dimension is a
//   template parameter (2 on the main path, or 3), so 3D coordinates run on
//   the card too;
// - thresholds ascend within a group, so each pair needs one bin search: the
//   first threshold k with d2 <= thr[k], raised to the window start. The
//   block histograms that first k into (gsize, C, C) int32 shared memory,
//   takes the prefix sum over k and flushes the window's cumulative counts
//   with 64-bit atomicAdd into the global (G * gsize, C, C) int64 output.
//   int64 totals need none of the TPU digit splits or item chunking;
// - when the (gsize, C, C) histogram does not fit the shared-memory budget
//   (large C), each pair adds 1 to every threshold of [first k, window end)
//   straight into the global output.

#include "common.cuh"

namespace {

template <int D>
__global__ void binned_pairs_kernel(const float* __restrict__ coords, const int32_t* __restrict__ labels, int n,
                                    const int32_t* __restrict__ ti, const int32_t* __restrict__ tj,
                                    const int32_t* __restrict__ rfull, const int32_t* __restrict__ rempty,
                                    const int32_t* __restrict__ gid, const float* __restrict__ thr, int n_thr,
                                    int tile, int gsize, int n_cls, int shared_hist,
                                    unsigned long long* __restrict__ out) {
    extern __shared__ float smem[];
    float* ci = smem;                                  // (tile, D)
    float* cj = ci + tile * D;                         // (tile, D)
    float* sthr = cj + tile * D;                       // (gsize,)
    int32_t* li = reinterpret_cast<int32_t*>(sthr + gsize);  // (tile,)
    int32_t* lj = li + tile;                           // (tile,)
    int32_t* hist = lj + tile;                         // (gsize, C, C) when shared_hist

    const int item = blockIdx.x;
    const int bi = ti[item];
    const int bj = tj[item];
    const int off = gid[item] * gsize;
    const int klo = max(rempty[item] - off, 0);
    const int khi = min(min(rfull[item] - off, gsize), n_thr - off);
    if (bi < 0 || khi <= klo) return;  // uniform over the block
    const int cc = n_cls * n_cls;

    for (int t = threadIdx.x; t < tile; t += blockDim.x) {
        const size_t gi = static_cast<size_t>(bi) * tile + t;
        const size_t gj = static_cast<size_t>(bj) * tile + t;
#pragma unroll
        for (int d = 0; d < D; ++d) {
            ci[t * D + d] = coords[gi * D + d];
            cj[t * D + d] = coords[gj * D + d];
        }
        li[t] = labels[gi];
        lj[t] = labels[gj];
    }
    for (int k = threadIdx.x; k < khi; k += blockDim.x) sthr[k] = thr[off + k];
    if (shared_hist) {
        for (int e = threadIdx.x; e < gsize * cc; e += blockDim.x) hist[e] = 0;
    }
    __syncthreads();

    const bool diag = bi == bj;
    const int j_end = min(tile, n - bj * tile);  // columns past n are padding
    for (int j = threadIdx.x; j < j_end; j += blockDim.x) {
        const int lb = lj[j];
        if (lb < 0 || lb >= n_cls) continue;
        float xj[D];
#pragma unroll
        for (int d = 0; d < D; ++d) xj[d] = cj[j * D + d];
        const int i_end = diag ? j : tile;  // strict upper triangle on diagonal tiles
        for (int i = 0; i < i_end; ++i) {
            const int la = li[i];
            if (la < 0 || la >= n_cls) continue;
            float dd = ci[i * D] - xj[0];
            float d2 = __fmul_rn(dd, dd);
#pragma unroll
            for (int d = 1; d < D; ++d) {
                dd = ci[i * D + d] - xj[d];
                d2 = __fadd_rn(d2, __fmul_rn(dd, dd));
            }
            int k = 0;
            while (k < khi && sthr[k] < d2) ++k;
            if (k < klo) k = klo;
            if (k >= khi) continue;
            const int e = la * n_cls + lb;
            if (shared_hist) {
                atomicAdd(&hist[k * cc + e], 1);
            } else {
                for (; k < khi; ++k) atomicAdd(&out[static_cast<size_t>(off + k) * cc + e], 1ULL);
            }
        }
    }

    if (shared_hist) {
        __syncthreads();
        for (int e = threadIdx.x; e < cc; e += blockDim.x) {
            long long run = 0;
            for (int k = klo; k < khi; ++k) {  // no pair has its first k below klo
                run += hist[k * cc + e];
                if (run) atomicAdd(&out[static_cast<size_t>(off + k) * cc + e], static_cast<unsigned long long>(run));
            }
        }
    }
}

template <int D>
int launch(const float* coords, const int32_t* labels, int n, const int32_t* ti, const int32_t* tj,
           const int32_t* rfull, const int32_t* rempty, const int32_t* gid, int n_items, const float* thr, int n_thr,
           int tile, int gsize, int n_cls, int shared_hist, unsigned long long* out, cudaStream_t s) {
    size_t smem = (2 * static_cast<size_t>(tile) * D + gsize) * sizeof(float) + 2 * static_cast<size_t>(tile) * 4;
    if (shared_hist) smem += static_cast<size_t>(gsize) * n_cls * n_cls * sizeof(int32_t);
    cudaError_t err = sqt_allow_smem(binned_pairs_kernel<D>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    binned_pairs_kernel<D><<<n_items, 256, smem, s>>>(coords, labels, n, ti, tj, rfull, rempty, gid, thr, n_thr, tile,
                                                      gsize, n_cls, shared_hist, out);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// coords (n_pad, dim) f32 and labels (n_pad,) int32 (-1 padding) are
// tile-padded; the five item arrays hold n_items entries; thr holds the
// G * gsize squared thresholds of which the first n_thr are real; out is a
// zeroed (G * gsize, C, C) int64 buffer.
SQT_EXPORT int sqt_binned_pairs(const float* coords, const int32_t* labels, int n, int dim, const int32_t* ti,
                                const int32_t* tj, const int32_t* rfull, const int32_t* rempty, const int32_t* gid,
                                int n_items, const float* thr, int n_thr, int tile, int gsize, int n_cls,
                                int shared_hist, long long* out, void* stream) {
    if (n_items == 0) return 0;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    auto* o = reinterpret_cast<unsigned long long*>(out);
    switch (dim) {
        case 2:
            return launch<2>(coords, labels, n, ti, tj, rfull, rempty, gid, n_items, thr, n_thr, tile, gsize, n_cls,
                             shared_hist, o, s);
        case 3:
            return launch<3>(coords, labels, n, ti, tj, rfull, rempty, gid, n_items, thr, n_thr, tile, gsize, n_cls,
                             shared_hist, o, s);
        default:
            return static_cast<int>(cudaErrorInvalidValue);
    }
}
