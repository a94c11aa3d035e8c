// K2: dense all-pairs cumulative class-pair counts of co_occurrence(use_pallas=True).
//
// Replaces the Pallas kernel squidpy_tpu/ops/pallas_pairs.py `_make_kernel`
// (launched by `_launch`, line 75). For points (n, d) float32 with labels in
// [0, C) and L squared thresholds sorted ascending, it counts, per threshold
// l and class pair (a, b), the pairs i < j with d2(i, j) <= thr[l], where d2
// is the expanded form the Pallas kernel computes,
//   d2 = (|p_i|^2 + |p_j|^2) - 2 <p_i, p_j>,
// each norm and dot product summed over the dimensions in order, every
// product and sum rounded on its own (__fmul_rn/__fadd_rn, --fmad=false), so
// the plain torch version's elementwise ops give the same d2 bit for bit.
// A second pass turns the first-threshold histogram into the ordered
// cumulative counts out[l, a, b] = sum_{k<=l} (h[k, a, b] + h[k, b, a]):
// d2 is symmetric, so each unordered pair counts in both orders.
//
// Bound on the card: operations. Every one of the n(n-1)/2 pairs takes the
// dot product (2d - 1 flops), the norm sum, the doubled dot and the
// difference (3 flops) and a search over the thresholds (log2 L compares)
// against 4(d + 1) bytes of input per point: at 200k 2D points and L = 49,
// 2.0e10 pairs and ~2.6e11 operations, ~3.9 ms at 67 TFLOP/s, against a few
// MB of input.
//
// Design:
// - one block per tile pair (ti <= tj) of 256 points (64 when d > 16): both
//   tiles' coordinates, norms and labels are staged in shared memory; each
//   thread keeps a column point and walks the rows (a broadcast read); on a
//   diagonal tile only i < j;
// - self-pairs and padding are masked by index, never by d2 = 0;
// - each pair takes one binary search for its first threshold k with
//   d2 <= thr[k] (pairs beyond the largest threshold, or with NaN d2, are
//   skipped) and adds 1 to an integer histogram (k, a, b): in shared memory
//   when L*C*C int32 fits (flushed with 64-bit atomics), else straight into
//   the global int64 histogram. Integer counts are exact at any n, unlike the
//   TPU kernel's float32 slabs above 2^24.

#include "common.cuh"

namespace {

template <int D>  // D = 0: the dimension is the runtime `dim`
__global__ void dense_pairs_kernel(const float* __restrict__ pts, const int32_t* __restrict__ labels, int n, int dim,
                                   const float* __restrict__ thr, int n_thr, int n_cls, int tile, int shared_hist,
                                   unsigned long long* __restrict__ hist_out) {
    const int ti = blockIdx.y;
    const int tj = blockIdx.x;
    if (ti > tj) return;  // uniform over the block
    const int d = D ? D : dim;
    extern __shared__ float smem[];
    float* ci = smem;                                         // (tile, d)
    float* cj = ci + static_cast<size_t>(tile) * d;           // (tile, d)
    float* ni = cj + static_cast<size_t>(tile) * d;           // (tile,)
    float* nj = ni + tile;                                    // (tile,)
    float* sthr = nj + tile;                                  // (n_thr,)
    int32_t* li = reinterpret_cast<int32_t*>(sthr + n_thr);  // (tile,)
    int32_t* lj = li + tile;                                  // (tile,)
    int32_t* hist = lj + tile;                                // (n_thr, C, C) when shared_hist
    const int cc = n_cls * n_cls;

    for (int t = threadIdx.x; t < 2 * tile; t += blockDim.x) {
        const bool row_tile = t < tile;
        const int local = row_tile ? t : t - tile;
        const int gidx = (row_tile ? ti : tj) * tile + local;
        float* c = (row_tile ? ci : cj) + static_cast<size_t>(local) * d;
        int lab = -1;
        float norm = 0.f;
        if (gidx < n) {
            const float* p = pts + static_cast<size_t>(gidx) * d;
            for (int k = 0; k < d; ++k) c[k] = p[k];
            norm = __fmul_rn(c[0], c[0]);
            for (int k = 1; k < d; ++k) norm = __fadd_rn(norm, __fmul_rn(c[k], c[k]));
            lab = labels[gidx];
            if (lab < 0 || lab >= n_cls) lab = -1;
        }
        (row_tile ? ni : nj)[local] = norm;
        (row_tile ? li : lj)[local] = lab;
    }
    for (int k = threadIdx.x; k < n_thr; k += blockDim.x) sthr[k] = thr[k];
    if (shared_hist) {
        for (int e = threadIdx.x; e < n_thr * cc; e += blockDim.x) hist[e] = 0;
    }
    __syncthreads();

    const float thr_max = sthr[n_thr - 1];
    for (int j = threadIdx.x; j < tile; j += blockDim.x) {
        const int lb = lj[j];
        if (lb < 0) continue;
        const float* pj = cj + static_cast<size_t>(j) * d;
        float xj[D ? D : 1];
        if (D) {
#pragma unroll
            for (int k = 0; k < (D ? D : 1); ++k) xj[k] = pj[k];
        }
        const float nrm_j = nj[j];
        const int i_end = ti == tj ? j : tile;
        for (int i = 0; i < i_end; ++i) {
            const int la = li[i];
            if (la < 0) continue;
            const float* pi = ci + static_cast<size_t>(i) * d;
            float dot;
            if (D) {
                dot = __fmul_rn(pi[0], xj[0]);
#pragma unroll
                for (int k = 1; k < (D ? D : 1); ++k) dot = __fadd_rn(dot, __fmul_rn(pi[k], xj[k]));
            } else {
                dot = __fmul_rn(pi[0], pj[0]);
                for (int k = 1; k < d; ++k) dot = __fadd_rn(dot, __fmul_rn(pi[k], pj[k]));
            }
            const float d2 = __fsub_rn(__fadd_rn(ni[i], nrm_j), __fmul_rn(2.f, dot));
            if (!(d2 <= thr_max)) continue;
            int lo = 0, hi = n_thr - 1;  // first k with d2 <= thr[k]
            while (lo < hi) {
                const int mid = (lo + hi) >> 1;
                if (sthr[mid] < d2) lo = mid + 1; else hi = mid;
            }
            const int e = lo * cc + la * n_cls + lb;
            if (shared_hist) {
                atomicAdd(&hist[e], 1);
            } else {
                atomicAdd(&hist_out[e], 1ULL);
            }
        }
    }

    if (shared_hist) {
        __syncthreads();
        for (int e = threadIdx.x; e < n_thr * cc; e += blockDim.x) {
            const int v = hist[e];
            if (v) atomicAdd(&hist_out[e], static_cast<unsigned long long>(v));
        }
    }
}

__global__ void cumulate_kernel(const long long* __restrict__ hist, int n_thr, int n_cls, long long* __restrict__ out) {
    const int e = blockIdx.x * blockDim.x + threadIdx.x;
    const int cc = n_cls * n_cls;
    if (e >= cc) return;
    const int a = e / n_cls;
    const int b = e % n_cls;
    long long run = 0;
    for (int k = 0; k < n_thr; ++k) {
        run += hist[static_cast<size_t>(k) * cc + a * n_cls + b] + hist[static_cast<size_t>(k) * cc + b * n_cls + a];
        out[static_cast<size_t>(k) * cc + e] = run;
    }
}

template <int D>
cudaError_t launch(const float* pts, const int32_t* labels, int n, int dim, const float* thr, int n_thr, int n_cls,
                   int tile, int shared_hist, unsigned long long* hist, cudaStream_t s) {
    size_t smem = (2 * static_cast<size_t>(tile) * dim + 2 * tile + n_thr) * sizeof(float) + 2 * tile * sizeof(int32_t);
    if (shared_hist) smem += static_cast<size_t>(n_thr) * n_cls * n_cls * sizeof(int32_t);
    cudaError_t err = sqt_allow_smem(dense_pairs_kernel<D>, smem);
    if (err != cudaSuccess) return err;
    const int n_tiles = (n + tile - 1) / tile;
    dense_pairs_kernel<D><<<dim3(n_tiles, n_tiles), 256, smem, s>>>(pts, labels, n, dim, thr, n_thr, n_cls, tile,
                                                                    shared_hist, hist);
    return cudaGetLastError();
}

}  // namespace

// pts (n, dim) float32; labels (n,) int32; thr (n_thr,) float32 ascending;
// hist a zeroed (n_thr, C, C) int64 scratch; out (n_thr, C, C) int64.
SQT_EXPORT int sqt_dense_pairs(const float* pts, const int32_t* labels, int n, int dim, const float* thr, int n_thr,
                               int n_cls, int tile, int shared_hist, long long* hist, long long* out, void* stream) {
    if (n <= 0 || dim <= 0 || n_thr <= 0 || n_cls <= 0 || tile <= 0) return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    auto* h = reinterpret_cast<unsigned long long*>(hist);
    cudaError_t err;
    switch (dim) {
        case 2: err = launch<2>(pts, labels, n, dim, thr, n_thr, n_cls, tile, shared_hist, h, s); break;
        case 3: err = launch<3>(pts, labels, n, dim, thr, n_thr, n_cls, tile, shared_hist, h, s); break;
        default: err = launch<0>(pts, labels, n, dim, thr, n_thr, n_cls, tile, shared_hist, h, s); break;
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    const int cc = n_cls * n_cls;
    cumulate_kernel<<<(cc + 255) / 256, 256, 0, s>>>(hist, n_thr, n_cls, out);
    return static_cast<int>(cudaGetLastError());
}
