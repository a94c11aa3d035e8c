// K20's earlier design (squidpy_torch/csrc/crop_histogram.cu before its
// uint8 entry: a block a crop, the float32 crop read twice, one shared
// histogram of n_ch x bins counters that every thread adds into), by the
// batched rule over each crop's own range, with a MODE that cuts it into
// its parts for `chip_smoke.py --k20-split`: 0 whole; 1 the bin pass
// without atomics (each thread's bins summed in a register, added once); 2
// each value added to one fixed counter a lane (no two lanes of a warp on
// one address); 3 the range pass alone. Modes 1-3 count nothing meaningful.

#include "common.cuh"

namespace {

constexpr int kThreads = 512;

template <int MODE>
__global__ void __launch_bounds__(kThreads) histogram_kernel(const float* __restrict__ x, int p, int n_ch, int bins,
                                                             int* __restrict__ counts) {
    extern __shared__ int hist[];
    __shared__ float s_min[kThreads / 32], s_max[kThreads / 32];
    __shared__ int s_nan;
    __shared__ float s_lo, s_hi;
    const int crop = blockIdx.x;
    int* dst = counts + static_cast<size_t>(crop) * n_ch * bins;
    const float* src = x + static_cast<size_t>(crop) * p * n_ch;
    const int total = p * n_ch;
    for (int k = threadIdx.x; k < n_ch * bins; k += blockDim.x) hist[k] = 0;
    if (threadIdx.x == 0) s_nan = 0;
    __syncthreads();

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
    const float lo = s_lo, hi = s_hi;
    if (MODE == 3) {  // the range pass alone
        if (threadIdx.x == 0) dst[0] = __float_as_int(lo) ^ __float_as_int(hi);
        return;
    }
    const float span = hi > lo ? __fsub_rn(hi, lo) : 1.0f;
    const float fb = static_cast<float>(bins);
    int sum = 0;
    for (int k = threadIdx.x; k < total; k += blockDim.x) {
        const float v = __ldg(src + k);
        const int ch = k % n_ch;
        int b = -1;
        if (v >= lo && v <= hi) {
            b = static_cast<int>(__fmul_rn(__fdiv_rn(__fsub_rn(v, lo), span), fb));
            b = min(max(b, 0), bins - 1);
        }
        if (MODE == 0) {
            if (b >= 0) atomicAdd(hist + ch * bins + b, 1);
        } else if (MODE == 1) {  // the bin pass without atomics: the bins summed in a register
            sum += b + ch;
        } else if (MODE == 2) {  // one fixed counter a lane
            if (b >= 0) atomicAdd(hist + (threadIdx.x & 31) % (n_ch * bins), 1);
        }
    }
    if (MODE == 1) atomicAdd(hist, sum);  // written once a thread
    __syncthreads();
    for (int k = threadIdx.x; k < n_ch * bins; k += blockDim.x) dst[k] = hist[k];
}

}  // namespace

// x: (n_crops, p, n_ch) float32; counts (n_crops, n_ch, bins) int32.
SQT_EXPORT int sqt_k20_split(const void* x, int n_crops, int p, int n_ch, int bins, void* counts, int mode,
                             void* stream) {
    if (n_crops == 0) return 0;
    const size_t smem = static_cast<size_t>(n_ch) * bins * sizeof(int);
    auto kernel = mode == 1   ? &histogram_kernel<1>
                  : mode == 2 ? &histogram_kernel<2>
                  : mode == 3 ? &histogram_kernel<3>
                              : &histogram_kernel<0>;
    cudaError_t err = sqt_allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<n_crops, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(static_cast<const float*>(x), p, n_ch, bins,
                                                                          static_cast<int*>(counts));
    return cudaGetLastError();
}
