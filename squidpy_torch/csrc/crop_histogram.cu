// K20: per (crop, channel) histogram counts.
//
// Replaces the XLA code of squidpy_tpu/ops/features.py
// `_histogram_batch_kernel` (line 182) and `histogram_features` (line 140,
// `jnp.histogram` of one crop's channel). One block takes one crop, every
// channel: a shared histogram of n_ch x bins int32 counters takes atomic adds
// and is written once. Counts are exact integers.
//
// Bound on the card: the float32 crops read once (474.5 MB at the main path:
// 0.142 ms at 3.35 TB/s), about six flops a value: bytes bound it. With a
// per-crop range the block reads its crop twice (min and max, then the bins);
// the second read comes from L2. Measured by chip_smoke.py on one NVIDIA
// H100 80GB HBM3 at a 700 W power limit: 0.55-0.57 ms there, 3.9-4.0x the bound.
//
// Design: a block a crop and a shared n_ch x bins histogram, the range
// reduced in the block when it is the crop's own. Two routes the wrapper
// chooses by size (ops/features.py `_k20_layout`): a histogram past the
// shared budget counts with atomics straight into the zeroed output, and
// edges past 1024 live in a global scratch row a crop.
//
// Two rules, as the JAX package has them:
// - rule 0 (the batched kernel): over a fixed range [lo, hi] or, with
//   `per_crop_range`, over the crop's own min and max over all its channels
//   (a NaN anywhere makes both NaN, as jnp.min does, and the crop counts
//   nothing); span = hi > lo ? hi - lo : 1; a value in [lo, hi] goes to bin
//   trunc((v - lo) / span * bins), clipped to [0, bins - 1], each operation
//   rounded once in float32; values outside are dropped.
// - rule 1 (`jnp.histogram`): edges = jnp.linspace(lo, hi, bins + 1) (lo -
//   0.5 and hi + 0.5 when lo == hi), computed as XLA:CPU compiles it: step
//   c = 1 / bins, e_0 = lo, e_k = fma(k, hi * c, lo * (1 - k * c)), e_bins
//   = hi, except e_1 = fma(lo, 1 - c, hi * c) up to 33 bins, where XLA
//   unrolls the loop and folds k = 1 away
//   (tests/test_torch_image_features.py holds it against JAX); a value goes to
//   bin (#edges <= v) - 1, the top edge into the last bin, NaN and values
//   outside the edges dropped. #edges <= v is a binary search (the first
//   edge above v) when the crop's edges do not decrease, which rounding
//   could break only for a range a few ulps wide a bin; the block checks
//   that and counts the edges one by one otherwise.

#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kMaxEdges = 1024;
constexpr int kLinspaceUnrolledBins = 33;  // ops/features.py LINSPACE_UNROLLED_BINS

// #edges[0..n) <= v on non-decreasing edges: the first edge above v.
__device__ __forceinline__ int edges_at_or_below(const float* edges, int n, float v) {
    int lo = 0, hi = n;
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (edges[mid] <= v)
            lo = mid + 1;
        else
            hi = mid;
    }
    return lo;
}

// hist_global: count into `counts` (zero on entry) instead of shared bins;
// gedges: the crops' edges rows (bins + 1 floats a crop) instead of shared.
__global__ void __launch_bounds__(kThreads) histogram_kernel(
    const float* __restrict__ x, int p, int n_ch, int bins, int rule, const float* __restrict__ lo_in,
    const float* __restrict__ hi_in, int per_crop_range, int hist_global, float* __restrict__ gedges,
    int* __restrict__ counts) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int crop = blockIdx.x;
    int* dst = counts + static_cast<size_t>(crop) * n_ch * bins;
    int* hist = hist_global ? dst : reinterpret_cast<int*>(smem);
    float* edges = gedges ? gedges + static_cast<size_t>(crop) * (bins + 1)
                          : reinterpret_cast<float*>(smem + (hist_global ? 0 : static_cast<size_t>(n_ch) * bins * 4));
    __shared__ float s_min[kThreads / 32], s_max[kThreads / 32];
    __shared__ int s_nan, s_falls;
    __shared__ float s_lo, s_hi;
    const float* src = x + static_cast<size_t>(crop) * p * n_ch;
    const int total = p * n_ch;
    if (!hist_global)
        for (int k = threadIdx.x; k < n_ch * bins; k += blockDim.x) hist[k] = 0;
    if (threadIdx.x == 0) s_nan = s_falls = 0;
    __syncthreads();

    float lo = lo_in[crop], hi = hi_in[crop];
    if (rule == 0 && per_crop_range) {
        float mn = __int_as_float(0x7F800000), mx = __int_as_float(0xFF800000);
        bool nan = false;
        for (int k = threadIdx.x; k < total; k += blockDim.x) {
            const float v = __ldg(src + k);
            nan |= v != v;
            mn = fminf(mn, v);
            mx = fmaxf(mx, v);
        }
        if (nan) s_nan = 1;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
            mn = fminf(mn, __shfl_down_sync(0xFFFFFFFFu, mn, o));
            mx = fmaxf(mx, __shfl_down_sync(0xFFFFFFFFu, mx, o));
        }
        if ((threadIdx.x & 31) == 0) {
            s_min[threadIdx.x >> 5] = mn;
            s_max[threadIdx.x >> 5] = mx;
        }
        __syncthreads();
        if (threadIdx.x == 0) {
            for (int k = 1; k < kThreads / 32; ++k) {
                mn = fminf(mn, s_min[k]);
                mx = fmaxf(mx, s_max[k]);
            }
            s_lo = s_nan ? __int_as_float(0x7FC00000) : mn;
            s_hi = s_nan ? __int_as_float(0x7FC00000) : mx;
        }
        __syncthreads();
        lo = s_lo;
        hi = s_hi;
    }
    if (rule == 1) {
        if (lo == hi) {
            lo = __fsub_rn(lo, 0.5f);
            hi = __fadd_rn(hi, 0.5f);
        }
        const float c = __fdiv_rn(1.0f, static_cast<float>(bins));
        const float hc = __fmul_rn(hi, c);
        for (int k = threadIdx.x; k <= bins; k += blockDim.x) {
            const float kf = static_cast<float>(k);
            float e;
            if (k == 0) {
                e = lo;
            } else if (k == bins) {
                e = hi;
            } else if (k == 1 && bins <= kLinspaceUnrolledBins) {
                e = __fmaf_rn(lo, __fsub_rn(1.0f, c), hc);
            } else {
                e = __fmaf_rn(kf, hc, __fmul_rn(lo, __fsub_rn(1.0f, __fmul_rn(kf, c))));
            }
            edges[k] = e;
        }
        __syncthreads();
        bool falls = false;
        for (int k = threadIdx.x; k < bins; k += blockDim.x) falls |= edges[k + 1] < edges[k];
        if (falls) s_falls = 1;
        __syncthreads();
    }
    const float span = hi > lo ? __fsub_rn(hi, lo) : 1.0f;
    const float fb = static_cast<float>(bins);
    for (int k = threadIdx.x; k < total; k += blockDim.x) {
        const float v = __ldg(src + k);
        const int ch = k % n_ch;
        int b = -1;
        if (rule == 0) {
            if (v >= lo && v <= hi) {
                b = static_cast<int>(__fmul_rn(__fdiv_rn(__fsub_rn(v, lo), span), fb));
                b = min(max(b, 0), bins - 1);
            }
        } else if (v == v) {
            int idx = 0;
            if (s_falls) {
                for (int e = 0; e <= bins; ++e) idx += edges[e] <= v;
            } else {
                idx = edges_at_or_below(edges, bins + 1, v);
            }
            if (v == edges[bins]) idx = bins;
            if (idx >= 1 && idx <= bins) b = idx - 1;
        }
        if (b >= 0) atomicAdd(hist + ch * bins + b, 1);
    }
    if (hist_global) return;
    __syncthreads();
    for (int k = threadIdx.x; k < n_ch * bins; k += blockDim.x) dst[k] = hist[k];
}

}  // namespace

// x: (n_crops, p, n_ch) float32; lo, hi (n_crops,) float32 (ignored by rule 0
// with per_crop_range); counts (n_crops, n_ch, bins) int32, zero on entry
// when hist_global; gedges null (edges in shared memory, bins + 1 <= 1024)
// or n_crops * (bins + 1) float32 of scratch.
SQT_EXPORT int sqt_crop_histogram(const void* x, int n_crops, int p, int n_ch, int bins, int rule, const void* lo,
                                  const void* hi, int per_crop_range, int hist_global, void* gedges, void* counts,
                                  void* stream) {
    if (n_crops == 0) return 0;
    if (rule == 1 && !gedges && bins + 1 > kMaxEdges) return cudaErrorInvalidValue;
    const size_t smem = (hist_global ? 0 : static_cast<size_t>(n_ch) * bins * sizeof(int)) +
                        (rule == 1 && !gedges ? (bins + 1) * sizeof(float) : 0);
    cudaError_t err = sqt_allow_smem(histogram_kernel, smem);
    if (err != cudaSuccess) return err;
    histogram_kernel<<<n_crops, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), p, n_ch, bins, rule, static_cast<const float*>(lo),
        static_cast<const float*>(hi), per_crop_range, hist_global, static_cast<float*>(gedges),
        static_cast<int*>(counts));
    return cudaGetLastError();
}
