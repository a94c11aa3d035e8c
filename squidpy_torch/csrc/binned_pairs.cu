// K1: boundary-block pair counts of the binned co-occurrence sweep.
//
// Replaces the Pallas kernel squidpy_tpu/ops/pallas_binned.py `_kernel_body`
// (launched by `_pallas_call_chunked`, line 196). The host plan
// (ops/pairbins.py `plan_binned_pairs`) lists work items (ti, tj, gid, rempty,
// rfull): a pair of Morton-sorted tiles and one group of `gsize` consecutive
// thresholds. A pair's items are consecutive and share one window [rempty,
// min(rfull, L)); the wrapper folds them into one segment (ti, tj, lo, hi)
// per distinct tile pair. For each segment this kernel counts, for every
// threshold r of the window, the class pairs (a, b) of points i < j (i in
// tile ti, j in tile tj) with d2(i, j) <= thr[r]. The host adds the analytic
// full-block counts and symmetrises.
//
// Bound on the card: operations. Every pair of the chunk pairs that the exact
// culling below keeps needs its distance once (3d - 1 flops) and a compare
// with the window's last threshold, and every chunk pair one box test; at 1M
// points that is 4.0e8 of the 8.3e9 candidate pairs of 8,396 tile pairs,
// against a few MB of input.
//
// Design:
// - one block per segment (the TPU kernel's one item per threshold group
//   recomputed each d2 once per group, ~6.9 times at 1M points); both tiles'
//   coordinates and labels are staged in shared memory;
// - the tiles are cut into 32-point chunks whose bounding boxes (over the
//   real points) are computed after staging. A warp takes one 32 x 32 chunk
//   pair at a time (chunk a <= b on a diagonal tile) and skips it when the
//   boxes' least d2, with the planner's conservative margin (pairbins.py:
//   `dmin2 * (1 - 1e-5) - 1e-30`, in double), lies beyond the window's last
//   threshold: the device's float32 d2 of any pair in the boxes is then
//   larger, so the skip drops no pair. On short-range windows ~95% of chunk
//   pairs go;
// - in a chunk pair the lanes hold 32 column points and walk the 32 rows (a
//   broadcast read); d2 = dx*dx + dy*dy (+ dz*dz) with __fmul_rn/__fadd_rn,
//   so no FMA contraction: it rounds as the plain torch version's separate
//   elementwise ops and the JAX difference form. A pair beyond the last
//   threshold stops there; else a binary search of the window gives its first
//   threshold k (d2 <= thr[k]);
// - counts go into a global (L + 1, C, C) int64 difference array: +1 at a
//   pair's first threshold k, -1 at the window's end. A block keeps a shared
//   int32 histogram of first thresholds for as many rows as the shared budget
//   holds (`hist_rows`, all L when C is small), over the top rows of its
//   window [max(lo, hi - hist_rows), hi), where most pairs of a growing
//   radius land, plus one (C, C) row counting the pairs whose k lies below
//   those rows: such a pair adds 1 at k in the global array directly. The
//   block flushes its nonzero bins, and -total at the window's end, with
//   64-bit atomics. So no pair's d2 is computed twice and no pair takes more
//   than one global atomic. When not even two rows fit (very large C),
//   hist_rows is 0 and each pair adds +1 and -1 in the global array. A second
//   pass takes the cumulative sum over thresholds. int64 totals need none of
//   the TPU digit splits or item chunking.

#include "common.cuh"

#include <math_constants.h>

namespace {

constexpr int kChunk = 32;
constexpr int kWarps = 8;
constexpr unsigned kFull = 0xffffffffu;

template <int D>
__global__ void __launch_bounds__(kWarps * 32)
    binned_pairs_kernel(const float* __restrict__ coords, const int32_t* __restrict__ labels, int n,
                        const int32_t* __restrict__ seg, int n_seg, const float* __restrict__ thr, int n_thr,
                        int tile, int n_cls, int hist_rows, unsigned long long* __restrict__ delta) {
    extern __shared__ __align__(16) float smem[];
    const int nchunk = (tile + kChunk - 1) / kChunk;
    float* ci = smem;                                         // (tile, D)
    float* cj = ci + tile * D;                                // (tile, D)
    float* box = cj + tile * D;                               // (2 sides, nchunk, D, lo/hi)
    float* sthr = box + 2 * nchunk * D * 2;                   // (n_thr,)
    int32_t* li = reinterpret_cast<int32_t*>(sthr + n_thr);  // (tile,)
    int32_t* lj = li + tile;                                  // (tile,)
    int32_t* hist = lj + tile;                                // (hi - top, C, C), then the (C, C) overflow row

    const int s = blockIdx.x;
    const int bi = seg[s];
    const int bj = seg[n_seg + s];
    const int lo = seg[2 * n_seg + s];
    const int hi = seg[3 * n_seg + s];
    const int cc = n_cls * n_cls;
    const int top = max(lo, hi - hist_rows);  // thresholds [top, hi) have shared rows
    int32_t* over = hist + (hi - top) * cc;   // pairs whose first threshold lies below top
    const int tid = threadIdx.x;
    const int lane = tid % 32;
    const int warp = tid / 32;

    for (int t = tid; t < tile; t += blockDim.x) {
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
    for (int k = tid; k < n_thr; k += blockDim.x) sthr[k] = thr[k];
    if (hist_rows) {
        for (int e = tid; e < (hi - top + 1) * cc; e += blockDim.x) hist[e] = 0;
    }
    __syncthreads();

    // bounding box of each chunk's real points (empty chunk: +inf/-inf)
    for (int c = warp; c < 2 * nchunk; c += kWarps) {
        const int side = c / nchunk;
        const int t = (c % nchunk) * kChunk + lane;
        const int btile = side ? bj : bi;
        const bool real = t < tile && static_cast<long long>(btile) * tile + t < n;
        const float* cs = side ? cj : ci;
#pragma unroll
        for (int d = 0; d < D; ++d) {
            float vmin = real ? cs[t * D + d] : CUDART_INF_F;
            float vmax = real ? cs[t * D + d] : -CUDART_INF_F;
#pragma unroll
            for (int o = 16; o > 0; o >>= 1) {
                vmin = fminf(vmin, __shfl_xor_sync(kFull, vmin, o));
                vmax = fmaxf(vmax, __shfl_xor_sync(kFull, vmax, o));
            }
            if (lane == 0) {
                box[(c * D + d) * 2] = vmin;
                box[(c * D + d) * 2 + 1] = vmax;
            }
        }
    }
    __syncthreads();

    const bool diag = bi == bj;
    const float tmax = sthr[hi - 1];
    const double reach = static_cast<double>(tmax);
    const int n_cp = nchunk * nchunk;
    for (int q0 = warp * 32; q0 < n_cp; q0 += kWarps * 32) {
        // each lane tests one chunk pair; the warp then counts the survivors one by one
        const int q = q0 + lane;
        const int a = q / nchunk;
        const int b = q % nchunk;
        bool keep = q < n_cp && (!diag || a <= b);
        if (keep) {
            double dmin2 = 0.0;
#pragma unroll
            for (int d = 0; d < D; ++d) {
                const double alo = box[(a * D + d) * 2], ahi = box[(a * D + d) * 2 + 1];
                const double blo = box[((nchunk + b) * D + d) * 2], bhi = box[((nchunk + b) * D + d) * 2 + 1];
                const double gap = fmax(fmax(blo - ahi, alo - bhi), 0.0);
                dmin2 += gap * gap;
            }
            keep = !(reach < dmin2 * (1.0 - 1e-5) - 1e-30);
        }
        unsigned todo = __ballot_sync(kFull, keep);
        while (todo) {
            const int src = __ffs(todo) - 1;
            todo &= todo - 1;
            const int qa = __shfl_sync(kFull, a, src);
            const int qb = __shfl_sync(kFull, b, src);
            const int j = qb * kChunk + lane;
            const int lb = j < tile ? lj[j] : -1;  // padding points carry label -1
            const bool col_ok = lb >= 0 && lb < n_cls;
            float xj[D];
#pragma unroll
            for (int d = 0; d < D; ++d) xj[d] = col_ok ? cj[j * D + d] : 0.f;
            const int i_end = min(tile, qa * kChunk + kChunk);
            for (int i = qa * kChunk; i < i_end; ++i) {
                const int la = li[i];
                if (la < 0 || la >= n_cls) continue;  // uniform over the warp
                if (!col_ok || (diag && i >= j)) continue;
                float dd = ci[i * D] - xj[0];
                float d2 = __fmul_rn(dd, dd);
#pragma unroll
                for (int d = 1; d < D; ++d) {
                    dd = ci[i * D + d] - xj[d];
                    d2 = __fadd_rn(d2, __fmul_rn(dd, dd));
                }
                if (!(d2 <= tmax)) continue;  // beyond the window (or NaN)
                int k0 = lo;
                int k1 = hi - 1;  // thr[k1] >= d2
                while (k0 < k1) {
                    const int mid = (k0 + k1) >> 1;
                    if (sthr[mid] < d2) {
                        k0 = mid + 1;
                    } else {
                        k1 = mid;
                    }
                }
                const int e = la * n_cls + lb;
                if (hist_rows && k0 >= top) {
                    atomicAdd(&hist[(k0 - top) * cc + e], 1);
                } else if (hist_rows) {
                    atomicAdd(&delta[static_cast<size_t>(k0) * cc + e], 1ULL);
                    atomicAdd(&over[e], 1);
                } else {
                    atomicAdd(&delta[static_cast<size_t>(k0) * cc + e], 1ULL);
                    atomicAdd(&delta[static_cast<size_t>(hi) * cc + e], ~0ULL);  // -1
                }
            }
        }
    }

    if (hist_rows) {
        __syncthreads();
        for (int e = tid; e < cc; e += blockDim.x) {
            long long total = over[e];
            for (int k = 0; k < hi - top; ++k) {
                const int v = hist[k * cc + e];
                if (v) {
                    atomicAdd(&delta[static_cast<size_t>(top + k) * cc + e], static_cast<unsigned long long>(v));
                    total += v;
                }
            }
            if (total) atomicAdd(&delta[static_cast<size_t>(hi) * cc + e], static_cast<unsigned long long>(-total));
        }
    }
}

__global__ void cumulate_kernel(const long long* __restrict__ delta, int n_thr, int cc, long long* __restrict__ out) {
    const int e = blockIdx.x * blockDim.x + threadIdx.x;
    if (e >= cc) return;
    long long run = 0;
    for (int k = 0; k < n_thr; ++k) {
        run += delta[static_cast<size_t>(k) * cc + e];
        out[static_cast<size_t>(k) * cc + e] = run;
    }
}

template <int D>
int launch(const float* coords, const int32_t* labels, int n, const int32_t* seg, int n_seg, const float* thr,
           int n_thr, int tile, int n_cls, int hist_rows, unsigned long long* delta, cudaStream_t s) {
    const int nchunk = (tile + kChunk - 1) / kChunk;
    size_t smem = (2 * static_cast<size_t>(tile) * D + 4 * static_cast<size_t>(nchunk) * D + n_thr) * sizeof(float) +
                  2 * static_cast<size_t>(tile) * sizeof(int32_t);
    if (hist_rows) smem += static_cast<size_t>(hist_rows + 1) * n_cls * n_cls * sizeof(int32_t);
    cudaError_t err = sqt_allow_smem(binned_pairs_kernel<D>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    binned_pairs_kernel<D><<<n_seg, kWarps * 32, smem, s>>>(coords, labels, n, seg, n_seg, thr, n_thr, tile, n_cls,
                                                           hist_rows, delta);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// coords (n_pad, dim) f32 and labels (n_pad,) int32 (-1 padding) are
// tile-padded; seg is a (4, n_seg) int32 array of rows ti, tj, lo, hi with
// 0 <= lo < hi <= n_thr; thr holds the n_thr squared thresholds, ascending;
// hist_rows (0..n_thr) is the number of shared histogram rows a block keeps;
// delta is a zeroed (n_thr + 1, C, C) int64 buffer; out (n_thr, C, C) int64
// receives the cumulative counts.
SQT_EXPORT int sqt_binned_pairs(const float* coords, const int32_t* labels, int n, int dim, const int32_t* seg,
                                int n_seg, const float* thr, int n_thr, int tile, int n_cls, int hist_rows,
                                long long* delta, long long* out, void* stream) {
    if (n_thr <= 0 || n_cls <= 0 || tile <= 0 || hist_rows < 0 || hist_rows > n_thr) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    auto* d = reinterpret_cast<unsigned long long*>(delta);
    int code = 0;
    if (n_seg > 0) {
        switch (dim) {
            case 2:
                code = launch<2>(coords, labels, n, seg, n_seg, thr, n_thr, tile, n_cls, hist_rows, d, s);
                break;
            case 3:
                code = launch<3>(coords, labels, n, seg, n_seg, thr, n_thr, tile, n_cls, hist_rows, d, s);
                break;
            default:
                return static_cast<int>(cudaErrorInvalidValue);
        }
        if (code != 0) return code;
    }
    const int cc = n_cls * n_cls;
    cumulate_kernel<<<(cc + 255) / 256, 256, 0, s>>>(delta, n_thr, cc, out);
    return static_cast<int>(cudaGetLastError());
}
