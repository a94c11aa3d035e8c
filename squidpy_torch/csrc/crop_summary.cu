// K19: per (crop, channel) quantiles, mean and standard deviation.
//
// Replaces the XLA code of squidpy_tpu/ops/features.py
// `_summary_batch_kernel` (line 149: one sort per (crop, channel), then the
// interpolated gathers) and `summary_features` (line 129, `jnp.quantile` of
// one crop's channel). One block takes one (crop, channel): it loads the
// channel's p values as order-preserving uint32 keys into shared memory
// (padded to a power of two with keys that sort last), sorts them with a
// bitonic network, and reads the two neighbours of each quantile.
//
// Bound on the card: the float32 crops read once (4,992 x 89 x 89 x 3 at the
// main path, 474.5 MB: 0.142 ms at 3.35 TB/s); the sums are a few flops a
// value, so bytes bound it. A sort does log2(p)^2 / 2 passes over the keys
// in shared memory, which a selection of the few order statistics would not.
//
// Design: a block an item, keys in shared memory, a bitonic sort; the
// global-scratch route below for channels past 32,768 values.
//
// Keys: -0 and +0 share a key and every NaN is the canonical quiet NaN, whose
// key sorts after +inf, as JAX's sort comparator orders floats.
//
// The interpolation rounds as XLA:CPU does (tests/test_torch_image_features.py
// holds it against JAX): the batched kernel's `v_lo * (1 - f) + v_hi * f`
// runs as fma(v_lo, w_lo, v_hi * w_hi), `jnp.quantile`'s as
// fma(v_hi, w_hi, v_lo * w_lo). The wrapper computes the positions and
// float32 weights by the two rules (`rule` 0 and 1); with rule 1 a channel
// holding a NaN gives NaN quantiles, as `jnp.quantile` sets the whole array to
// NaN. The library builds with --fmad=false, so only the __fmaf_rn written
// here fuses.
//
// Mean and std: sums of x and x^2 in double; mean = Sx / p and
// var = max(p * Sxx - Sx * Sx, 0) / (p * p) (NaN kept), rounded to float32 at the end.
// For integer-valued pixels (the uint8 images of a section) the sums are
// exact, so the kernel and the plain version agree bitwise.
//
// A channel of more than 32,768 values (a 181 x 181 crop and up) does not fit
// the shared-memory keys; it sorts in a global scratch row a block instead
// (`keys` non-null), the same network.

#include "common.cuh"

namespace {

constexpr int kThreads = 1024;

__device__ __forceinline__ uint32_t float_key(float v) {
    uint32_t u = __float_as_uint(v);
    if (v == 0.0f) u = 0u;
    if (v != v) u = 0x7FC00000u;
    return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_float(uint32_t k) {
    return __uint_as_float((k & 0x80000000u) ? (k & 0x7FFFFFFFu) : ~k);
}

__device__ __forceinline__ double block_sum(double v, double* red) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xFFFFFFFFu, v, o);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (lane == 0) red[warp] = v;
    __syncthreads();
    double s = 0.0;
    if (threadIdx.x == 0)
        for (int k = 0; k < static_cast<int>(blockDim.x >> 5); ++k) s += red[k];
    __syncthreads();
    return s;  // thread 0
}

__global__ void __launch_bounds__(kThreads) summary_kernel(
    const float* __restrict__ x, int n_items, int p, int n_ch, int p2, int nq, const int* __restrict__ qlo,
    const int* __restrict__ qhi, const float* __restrict__ wlo, const float* __restrict__ whi, int rule,
    uint32_t* __restrict__ gkeys, float* __restrict__ quant, float* __restrict__ mean, float* __restrict__ stdev) {
    extern __shared__ __align__(16) unsigned char smem[];
    double* red = reinterpret_cast<double*>(smem);
    __shared__ int any_nan;
    uint32_t* keys = gkeys ? gkeys + static_cast<size_t>(blockIdx.x) * p2
                           : reinterpret_cast<uint32_t*>(smem + (kThreads / 32) * sizeof(double));
    for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
        const int crop = item / n_ch, ch = item % n_ch;
        const float* src = x + static_cast<size_t>(crop) * p * n_ch + ch;
        if (threadIdx.x == 0) any_nan = 0;
        double sx = 0.0, sxx = 0.0;
        bool nan = false;
        for (int k = threadIdx.x; k < p2; k += blockDim.x) {
            if (k < p) {
                const float v = __ldg(src + static_cast<size_t>(k) * n_ch);
                keys[k] = float_key(v);
                sx += static_cast<double>(v);
                sxx += static_cast<double>(v) * static_cast<double>(v);
                nan |= v != v;
            } else {
                keys[k] = 0xFFFFFFFFu;
            }
        }
        __syncthreads();
        if (nan) any_nan = 1;
        sx = block_sum(sx, red);
        sxx = block_sum(sxx, red);
        // bitonic sort of p2 keys, ascending
        for (int size = 2; size <= p2; size <<= 1) {
            for (int stride = size >> 1; stride > 0; stride >>= 1) {
                for (int k = threadIdx.x; k < p2 / 2; k += blockDim.x) {
                    const int lo = 2 * k - (k & (stride - 1));
                    const int hi = lo + stride;
                    const bool up = (lo & size) == 0;
                    const uint32_t a = keys[lo], b = keys[hi];
                    if ((a > b) == up) {
                        keys[lo] = b;
                        keys[hi] = a;
                    }
                }
                __syncthreads();
            }
        }
        const size_t out = static_cast<size_t>(crop) * n_ch + ch;
        if (threadIdx.x < nq) {
            const int q = threadIdx.x;
            const float a = key_float(keys[qlo[q]]), b = key_float(keys[qhi[q]]);
            float r = rule == 0 ? __fmaf_rn(a, wlo[q], __fmul_rn(b, whi[q])) : __fmaf_rn(b, whi[q], __fmul_rn(a, wlo[q]));
            if (rule == 1 && any_nan) r = __int_as_float(0x7FC00000);
            quant[(static_cast<size_t>(crop) * nq + q) * n_ch + ch] = r;
        }
        if (threadIdx.x == 0) {
            const double pd = static_cast<double>(p);
            const double v = pd * sxx - sx * sx;
            const double var = (v < 0.0 ? 0.0 : v) / (pd * pd);  // NaN stays NaN
            mean[out] = static_cast<float>(sx / pd);
            stdev[out] = static_cast<float>(sqrt(var));
        }
        __syncthreads();
    }
}

}  // namespace

// x: (n_crops, p, n_ch) float32; qlo, qhi (nq,) int32 positions in the sorted
// channel, wlo, whi (nq,) float32 weights; quant (n_crops, nq, n_ch), mean and
// stdev (n_crops, n_ch) float32. p2 is the power of two at or above p. With
// gkeys null the keys live in shared memory (p2 <= 32768, one block an item);
// else gkeys holds max_blocks * p2 uint32 and a grid of max_blocks loops over
// the items.
SQT_EXPORT int sqt_crop_summary(const void* x, int n_crops, int p, int n_ch, int p2, int nq, const void* qlo,
                                const void* qhi, const void* wlo, const void* whi, int rule, int max_blocks,
                                void* gkeys, void* quant, void* mean, void* stdev, void* stream) {
    const int n_items = n_crops * n_ch;
    if (n_items == 0) return 0;
    size_t smem = (kThreads / 32) * sizeof(double);
    int grid = n_items;
    if (!gkeys) {
        smem += static_cast<size_t>(p2) * sizeof(uint32_t);
        cudaError_t err = sqt_allow_smem(summary_kernel, smem);
        if (err != cudaSuccess) return err;
    } else {
        grid = n_items < max_blocks ? n_items : max_blocks;
    }
    summary_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), n_items, p, n_ch, p2, nq, static_cast<const int*>(qlo),
        static_cast<const int*>(qhi), static_cast<const float*>(wlo), static_cast<const float*>(whi), rule,
        static_cast<uint32_t*>(gkeys), static_cast<float*>(quant), static_cast<float*>(mean),
        static_cast<float*>(stdev));
    return cudaGetLastError();
}
