// K20: per (crop, channel) histogram counts, two entries by the crops' type.
//
// Replaces the XLA code of squidpy_tpu/ops/features.py
// `_histogram_batch_kernel` (line 182) and `histogram_features` (line 140,
// `jnp.histogram` of one crop's channel). Counts are exact integers.
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
//   outside the edges dropped.
//
// The uint8 entry (`sqt_crop_histogram_u8`, the main path's: Visium H&E
// crops are bytes). A uint8 crop holds at most 256 values a channel, so its
// histogram is fixed by n_ch x 256 value counts and a fold of the 256 values
// into bins; uint8 -> float32 is exact, so the counts are those of the
// float32 crop, bitwise. Bound on the card: the bytes read once (118.6 MB
// at the main path's 4,992 x 89 x 89 x 3 crops: 0.0354 ms at 3.35 TB/s),
// one shared add a byte. Design: a block reads its crop's bytes once with
// 16-byte loads (a crop's start need not be 16-byte aligned: a head and a
// tail of single bytes), each byte's channel from its position (one modulo
// a thread, then a step a 16 bytes), and adds each byte into one copy a
// block of n_ch x 256 32-bit counters in shared memory, each channel's run
// `kChannelWords` long (11 words past its 256 counters, so that the channels
// of neighbouring bytes, whose values are close, take other banks). The
// per-crop range is the lowest and highest value counted in any channel;
// the fold maps each of the 256 values to its bin by the rule's own float32
// steps (rule 1: each edge adds one at the first byte value at or above it,
// and a prefix sum gives #edges <= v for every value, so no edge is stored
// and any number of bins folds the same way) and adds the counts there, a
// run of neighbouring values of one bin at once: at most 256 non-zero bins
// a channel, in a shared histogram while it fits and with atomics into the
// zeroed output past it. A crop too large for one block's 32-bit counters,
// or a call of few crops, splits a crop over blocks that add their counts
// into a global (n, n_ch, 256) table; a second kernel folds it.
//
// The float32 entry (`sqt_crop_histogram`): every other dtype, and
// `jnp.histogram`'s per-crop calls on float images. Bound on the card: the
// crops read once, about six flops a value: bytes. Design: a block a crop,
// 16-byte loads where aligned, each value's channel from a running position,
// one shared histogram (a call over each crop's own range reads the crop
// twice: staging it in shared memory, or private histograms a warp, timed no
// faster on the card). Past the shared budget the histogram counts with
// atomics straight into the zeroed output, and edges past 1024 live in a
// global scratch row a crop, searched there (a binary search while the
// crop's edges do not decrease, which rounding could break only for a range
// a few ulps wide a bin; the block checks that and counts the edges one by
// one otherwise). The division stays IEEE (`__fdiv_rn`): JAX's rounding.
//
// Every shared byte of these kernels is dynamic, so the launch's size is
// the whole of it (ops/features.py `_k20_layout` counts the same words).
//
// Measured by chip_smoke.py on one NVIDIA H100 80GB HBM3 at a 700 W power
// limit: PERF.md section 6.

#include "common.cuh"

namespace {

constexpr int kMaxEdges = 1024;
constexpr int kLinspaceUnrolledBins = 33;  // ops/features.py LINSPACE_UNROLLED_BINS
constexpr int kThreadsU8 = 256;            // the uint8 entry's threads a block
constexpr int kThreadsF32 = 512;           // the float32 entry's
constexpr int kChannelWords = 267;         // ops/features.py K20_CHANNEL_WORDS: 256 counters and 11 words of skew
constexpr int kFoldWords = 258;            // ops/features.py K20_FOLD_WORDS: the fold's bins of 256 values, lo, hi
constexpr int kF32Words = 2 * (kThreadsF32 / 32) + 4;  // the float32 entry's range reduction and flags

__device__ __forceinline__ float linspace_edge(int k, int bins, float lo, float hi, float c, float hc) {
    if (k == 0) return lo;
    if (k == bins) return hi;
    if (k == 1 && bins <= kLinspaceUnrolledBins) return __fmaf_rn(lo, __fsub_rn(1.0f, c), hc);
    const float kf = static_cast<float>(k);
    return __fmaf_rn(kf, hc, __fmul_rn(lo, __fsub_rn(1.0f, __fmul_rn(kf, c))));
}

// Rule 0's bin of v, or -1.
__device__ __forceinline__ int range_bin(float v, float lo, float hi, float span, float fb, int bins) {
    if (!(v >= lo && v <= hi)) return -1;
    const int b = static_cast<int>(__fmul_rn(__fdiv_rn(__fsub_rn(v, lo), span), fb));
    return min(max(b, 0), bins - 1);
}

// ------------------------------------------------------------ uint8 entry

// The fold: the value counts `tot` (shared or global; channel c's 256 at
// c * stride) into the crop's (n_ch, bins) counts. `scratch`: kFoldWords
// shared words. `hist` is the shared histogram (zeroed here, then written
// to `dst`) or null: atomics straight into `dst`, zero on entry.
__device__ void fold_values(const int* tot, int stride, int n_ch, int bins, int rule, float lo, float hi,
                            int per_crop_range, int* scratch, int* hist, int* dst) {
    int* s_bin = scratch;  // a value's bin, -1 dropped; rule 1 first counts the edges at each value here
    int* s_lo = scratch + 256;
    int* s_hi = scratch + 257;
    const int t = threadIdx.x, T = blockDim.x;
    if (rule == 0 && per_crop_range) {
        if (t == 0) {
            *s_lo = 256;
            *s_hi = -1;
        }
        __syncthreads();
        int vlo = 256, vhi = -1;
        for (int v = t; v < 256; v += T) {
            bool any = false;
            for (int c = 0; c < n_ch && !any; ++c) any = tot[c * stride + v] != 0;
            if (any) {
                vlo = min(vlo, v);
                vhi = max(vhi, v);
            }
        }
        vlo = __reduce_min_sync(0xFFFFFFFFu, vlo);
        vhi = __reduce_max_sync(0xFFFFFFFFu, vhi);
        if ((t & 31) == 0) {
            atomicMin(s_lo, vlo);
            atomicMax(s_hi, vhi);
        }
        __syncthreads();
        lo = *s_lo < 256 ? static_cast<float>(*s_lo) : __int_as_float(0x7F800000);
        hi = *s_hi >= 0 ? static_cast<float>(*s_hi) : __int_as_float(0xFF800000);
    }
    if (rule == 0) {
        const float span = hi > lo ? __fsub_rn(hi, lo) : 1.0f;
        for (int v = t; v < 256; v += T) s_bin[v] = range_bin(static_cast<float>(v), lo, hi, span, static_cast<float>(bins), bins);
    } else {
        if (lo == hi) {
            lo = __fsub_rn(lo, 0.5f);
            hi = __fadd_rn(hi, 0.5f);
        }
        for (int v = t; v < 256; v += T) s_bin[v] = 0;
        __syncthreads();
        const float c = __fdiv_rn(1.0f, static_cast<float>(bins));
        const float hc = __fmul_rn(hi, c);
        // each edge counts at the first byte value at or above it
        for (int k = t; k <= bins; k += T) {
            const float e = linspace_edge(k, bins, lo, hi, c, hc);
            if (e <= 255.0f) atomicAdd(&s_bin[e <= 0.0f ? 0 : static_cast<int>(ceilf(e))], 1);
        }
        __syncthreads();
        if (t < 32) {  // #edges <= v: a warp's prefix sum, eight values a lane, each lane's own read then written
            int run[8], sum = 0;
#pragma unroll
            for (int j = 0; j < 8; ++j) run[j] = sum += s_bin[8 * t + j];
            int incl = sum;
#pragma unroll
            for (int o = 1; o < 32; o <<= 1) {
                const int up = __shfl_up_sync(0xFFFFFFFFu, incl, o);
                if (t >= o) incl += up;
            }
            const int before = incl - sum;
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                const int v = 8 * t + j;
                const int idx = static_cast<float>(v) == hi ? bins : before + run[j];
                s_bin[v] = idx >= 1 && idx <= bins ? idx - 1 : -1;
            }
        }
    }
    int* out = hist ? hist : dst;
    if (hist)
        for (int k = t; k < n_ch * bins; k += T) hist[k] = 0;
    __syncthreads();
    // a thread walks eight neighbouring values of one channel, which mostly
    // share a bin, and adds each run of one bin once
    for (int g = t; g < n_ch * 32; g += T) {
        const int c = g >> 5, v0 = (g & 31) * 8;
        int run = 0, rb = -1;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const int b = s_bin[v0 + j];
            if (b != rb) {
                if (run != 0 && rb >= 0) atomicAdd(out + c * bins + rb, run);
                run = 0;
                rb = b;
            }
            run += tot[c * stride + v0 + j];
        }
        if (run != 0 && rb >= 0) atomicAdd(out + c * bins + rb, run);
    }
    if (!hist) return;
    __syncthreads();
    for (int k = t; k < n_ch * bins; k += T) dst[k] = hist[k];
}

// One more of byte value v in channel ch of the block's counters.
__device__ __forceinline__ void add_byte(int* counts, int ch, int v) { atomicAdd(counts + ch * kChannelWords + v, 1); }

// The 16 bytes of `q`, whose first byte is of channel ch.
__device__ __forceinline__ void count16(int* counts, const uint4 q, int ch, int n_ch) {
    const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int j = 0; j < 16; ++j) {
        add_byte(counts, ch, (w[j >> 2] >> ((j & 3) * 8)) & 0xFF);
        ch = ch + 1 == n_ch ? 0 : ch + 1;
    }
}

// grid (splits, n_crops): block (s, i) counts bytes [s * chunk, (s + 1) *
// chunk) of crop i. table == null: the block holds the whole crop and folds
// it (the fused route); else it adds its counts into table (zeroed, n_ch x
// 256 ints a crop) and the fold kernel follows. Shared: the counters, then
// (fused) the fold's scratch and the histogram unless hist_global.
__global__ void __launch_bounds__(kThreadsU8) count_u8_kernel(
    const uint8_t* __restrict__ x, int64_t p, int n_ch, int64_t chunk, int bins, int rule,
    const float* __restrict__ lo_in, const float* __restrict__ hi_in, int per_crop_range, int hist_global,
    int* __restrict__ table, int* __restrict__ out) {
    extern __shared__ __align__(16) int smem[];
    const int t = threadIdx.x, T = blockDim.x;
    const int crop = blockIdx.y;
    int* counts = smem;
    for (int k = t; k < n_ch * kChannelWords; k += T) counts[k] = 0;
    __syncthreads();

    const int64_t P = p * n_ch;
    const int64_t base = static_cast<int64_t>(crop) * P;
    const int64_t s0 = base + static_cast<int64_t>(blockIdx.x) * chunk;
    const int64_t s1 = s0 + chunk < base + P ? s0 + chunk : base + P;
    // byte k lies on a 16-byte boundary where (k + mis) % 16 == 0
    const int64_t mis = static_cast<int64_t>(reinterpret_cast<uintptr_t>(x) & 15);
    int64_t a0 = ((s0 + mis + 15) & ~static_cast<int64_t>(15)) - mis, b0 = ((s1 + mis) & ~static_cast<int64_t>(15)) - mis;
    if (a0 > b0) a0 = b0 = s1;  // no aligned 16 bytes: all single bytes
    for (int64_t k = s0 + t; k < a0; k += T) add_byte(counts, static_cast<int>((k - base) % n_ch), x[k]);
    for (int64_t k = b0 + t; k < s1; k += T) add_byte(counts, static_cast<int>((k - base) % n_ch), x[k]);
    const uint4* xq = reinterpret_cast<const uint4*>(x + a0);
    const int64_t nq = (b0 - a0) >> 4;
    int64_t q = t;
    int ch = static_cast<int>((a0 + 16 * q - base) % n_ch);
    const int step = static_cast<int>((16LL * T) % n_ch);
    constexpr int kUnroll = 4;
    for (; q < nq; q += kUnroll * static_cast<int64_t>(T)) {
        uint4 v[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
            if (q + u * static_cast<int64_t>(T) < nq) v[u] = __ldg(xq + q + u * static_cast<int64_t>(T));
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
            if (q + u * static_cast<int64_t>(T) < nq) count16(counts, v[u], ch, n_ch);
            ch += step;
            ch = ch >= n_ch ? ch - n_ch : ch;
        }
    }
    __syncthreads();

    if (table) {
        int* row = table + static_cast<int64_t>(crop) * n_ch * 256;
        for (int k = t; k < n_ch * 256; k += T) {
            const int c = counts[(k >> 8) * kChannelWords + (k & 255)];
            if (c) atomicAdd(row + k, c);
        }
        return;
    }
    int* scratch = counts + n_ch * kChannelWords;
    fold_values(counts, kChannelWords, n_ch, bins, rule, lo_in[crop], hi_in[crop], per_crop_range, scratch,
                hist_global ? nullptr : scratch + kFoldWords, out + static_cast<int64_t>(crop) * n_ch * bins);
}

// A block a crop: the table of value counts (n_ch x 256 a crop) folded.
// Shared: the fold's scratch, then the histogram unless hist_global.
__global__ void __launch_bounds__(256) fold_kernel(const int* __restrict__ table, int n_ch, int bins, int rule,
                                                   const float* __restrict__ lo_in, const float* __restrict__ hi_in,
                                                   int per_crop_range, int hist_global, int* __restrict__ out) {
    extern __shared__ __align__(16) int smem[];
    const int crop = blockIdx.x;
    fold_values(table + static_cast<int64_t>(crop) * n_ch * 256, 256, n_ch, bins, rule, lo_in[crop], hi_in[crop],
                per_crop_range, smem, hist_global ? nullptr : smem + kFoldWords,
                out + static_cast<int64_t>(crop) * n_ch * bins);
}

// ---------------------------------------------------------- float32 entry

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

// f(value, channel) over a crop's P values at `src`, whose element k is
// 16-byte aligned where (k + off) % 4 == 0: single values at the head and
// the tail, the rest as float4, each channel from a running position.
template <typename F>
__device__ __forceinline__ void for_each_value(const float* src, int64_t P, int off, int n_ch, F f) {
    const int t = threadIdx.x, T = blockDim.x;
    int64_t head = (4 - off) & 3;
    if (head > P) head = P;
    const int64_t n4 = (P - head) >> 2;
    const int64_t tail = head + 4 * n4;
    for (int64_t k = t; k < head; k += T) f(__ldg(src + k), static_cast<int>(k % n_ch));
    for (int64_t k = tail + t; k < P; k += T) f(__ldg(src + k), static_cast<int>(k % n_ch));
    const float4* s4 = reinterpret_cast<const float4*>(src + head);
    int ch = static_cast<int>((head + 4 * static_cast<int64_t>(t)) % n_ch);
    const int step = static_cast<int>((4LL * T) % n_ch);
    for (int64_t j = t; j < n4; j += T) {
        const float4 v = __ldg(s4 + j);
        int c = ch;
        f(v.x, c);
        c = c + 1 == n_ch ? 0 : c + 1;
        f(v.y, c);
        c = c + 1 == n_ch ? 0 : c + 1;
        f(v.z, c);
        c = c + 1 == n_ch ? 0 : c + 1;
        f(v.w, c);
        ch += step;
        ch = ch >= n_ch ? ch - n_ch : ch;
    }
}

// hist_global: count into `counts` (zero on entry) instead of a shared
// histogram; gedges: the crops' edges rows (bins + 1 floats a crop) instead
// of shared. Shared: kF32Words of scratch, the histogram unless hist_global,
// the edges unless gedges.
__global__ void __launch_bounds__(kThreadsF32) histogram_kernel(
    const float* __restrict__ x, int64_t p, int n_ch, int bins, int rule, const float* __restrict__ lo_in,
    const float* __restrict__ hi_in, int per_crop_range, int hist_global, float* __restrict__ gedges,
    int* __restrict__ counts) {
    extern __shared__ __align__(16) int smem[];
    const int t = threadIdx.x, T = blockDim.x;
    const int crop = blockIdx.x;
    const int64_t P = p * n_ch;
    const float* src = x + static_cast<int64_t>(crop) * P;
    const int off = static_cast<int>((reinterpret_cast<uintptr_t>(src) >> 2) & 3);  // src + k: 16-byte aligned where (k + off) % 4 == 0
    const int hb = n_ch * bins;
    int* dst = counts + static_cast<int64_t>(crop) * hb;
    float* s_min = reinterpret_cast<float*>(smem);
    float* s_max = s_min + kThreadsF32 / 32;
    int* s_nan = smem + 2 * (kThreadsF32 / 32);
    int* s_falls = s_nan + 1;
    float* s_lo = reinterpret_cast<float*>(s_nan + 2);
    float* s_hi = s_lo + 1;
    int* hist = hist_global ? dst : smem + kF32Words;
    float* edges = gedges ? gedges + static_cast<int64_t>(crop) * (bins + 1)
                          : reinterpret_cast<float*>(smem + kF32Words + (hist_global ? 0 : hb));
    if (!hist_global)
        for (int k = t; k < hb; k += T) hist[k] = 0;
    if (t == 0) *s_nan = *s_falls = 0;
    __syncthreads();

    float lo = lo_in[crop], hi = hi_in[crop];
    if (rule == 0 && per_crop_range) {
        float mn = __int_as_float(0x7F800000), mx = __int_as_float(0xFF800000);
        bool nan = false;
        for_each_value(src, P, off, n_ch, [&](float v, int) {
            nan |= v != v;
            mn = fminf(mn, v);
            mx = fmaxf(mx, v);
        });
        if (nan) *s_nan = 1;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
            mn = fminf(mn, __shfl_down_sync(0xFFFFFFFFu, mn, o));
            mx = fmaxf(mx, __shfl_down_sync(0xFFFFFFFFu, mx, o));
        }
        if ((t & 31) == 0) {
            s_min[t >> 5] = mn;
            s_max[t >> 5] = mx;
        }
        __syncthreads();
        if (t == 0) {
            for (int k = 1; k < T / 32; ++k) {
                mn = fminf(mn, s_min[k]);
                mx = fmaxf(mx, s_max[k]);
            }
            *s_lo = *s_nan ? __int_as_float(0x7FC00000) : mn;
            *s_hi = *s_nan ? __int_as_float(0x7FC00000) : mx;
        }
        __syncthreads();
        lo = *s_lo;
        hi = *s_hi;
    }
    if (rule == 1) {
        if (lo == hi) {
            lo = __fsub_rn(lo, 0.5f);
            hi = __fadd_rn(hi, 0.5f);
        }
        const float c = __fdiv_rn(1.0f, static_cast<float>(bins));
        const float hc = __fmul_rn(hi, c);
        for (int k = t; k <= bins; k += T) edges[k] = linspace_edge(k, bins, lo, hi, c, hc);
        __syncthreads();
        bool falls = false;
        for (int k = t; k < bins; k += T) falls |= edges[k + 1] < edges[k];
        if (falls) *s_falls = 1;
        __syncthreads();
    }
    const float span = hi > lo ? __fsub_rn(hi, lo) : 1.0f;
    const float fb = static_cast<float>(bins);
    if (rule == 0) {
        for_each_value(src, P, off, n_ch, [&](float v, int ch) {
            const int b = range_bin(v, lo, hi, span, fb, bins);
            if (b >= 0) atomicAdd(hist + ch * bins + b, 1);
        });
    } else {
        const bool falls = *s_falls;
        for_each_value(src, P, off, n_ch, [&](float v, int ch) {
            if (v != v) return;
            int idx = 0;
            if (falls) {
                for (int e = 0; e <= bins; ++e) idx += edges[e] <= v;
            } else {
                idx = edges_at_or_below(edges, bins + 1, v);
            }
            if (v == edges[bins]) idx = bins;
            if (idx >= 1 && idx <= bins) atomicAdd(hist + ch * bins + idx - 1, 1);
        });
    }
    if (hist_global) return;
    __syncthreads();
    for (int k = t; k < hb; k += T) dst[k] = hist[k];
}

}  // namespace

// x: (n_crops, p, n_ch) uint8; lo, hi (n_crops,) float32 (ignored by rule 0
// with per_crop_range); out (n_crops, n_ch, bins) int32, zero on entry when
// hist_global; `splits` blocks a crop of `chunk` bytes each (a multiple of
// 16, at most 2^31 - 1: a block's 32-bit counters). table null: one block a
// crop counts and folds (splits 1); else table is a zeroed (n_crops, n_ch,
// 256) int32 table the blocks add their counts into, and
// sqt_crop_histogram_fold follows.
SQT_EXPORT int sqt_crop_histogram_u8(const void* x, int n_crops, int64_t p, int n_ch, int bins, int rule,
                                     const void* lo, const void* hi, int per_crop_range, int splits, int64_t chunk,
                                     int hist_global, void* table, void* out, void* stream) {
    if (n_crops == 0 || p == 0) return 0;
    if (chunk % 16 || chunk > INT32_MAX || (!table && splits != 1) || static_cast<int64_t>(splits) * chunk < p * n_ch)
        return cudaErrorInvalidValue;
    size_t words = static_cast<size_t>(n_ch) * kChannelWords;
    if (!table) words += kFoldWords + (hist_global ? 0 : static_cast<size_t>(n_ch) * bins);
    const size_t smem = words * sizeof(int);
    cudaError_t err = sqt_allow_smem(count_u8_kernel, smem);
    if (err != cudaSuccess) return err;
    count_u8_kernel<<<dim3(splits, n_crops), kThreadsU8, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(x), p, n_ch, chunk, bins, rule, static_cast<const float*>(lo),
        static_cast<const float*>(hi), per_crop_range, hist_global, static_cast<int*>(table), static_cast<int*>(out));
    return cudaGetLastError();
}

// table (n_crops, n_ch, 256) int32 value counts -> out (n_crops, n_ch,
// bins) int32 (zero on entry when hist_global).
SQT_EXPORT int sqt_crop_histogram_fold(const void* table, int n_crops, int n_ch, int bins, int rule, const void* lo,
                                       const void* hi, int per_crop_range, int hist_global, void* out, void* stream) {
    if (n_crops == 0) return 0;
    const size_t smem = (kFoldWords + (hist_global ? 0 : static_cast<size_t>(n_ch) * bins)) * sizeof(int);
    cudaError_t err = sqt_allow_smem(fold_kernel, smem);
    if (err != cudaSuccess) return err;
    fold_kernel<<<n_crops, 256, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(table), n_ch, bins, rule, static_cast<const float*>(lo),
        static_cast<const float*>(hi), per_crop_range, hist_global, static_cast<int*>(out));
    return cudaGetLastError();
}

// x: (n_crops, p, n_ch) float32; lo, hi (n_crops,) float32 (ignored by rule 0
// with per_crop_range); counts (n_crops, n_ch, bins) int32, zero on entry
// when hist_global; gedges null (edges in shared memory, bins + 1 <= 1024)
// or n_crops * (bins + 1) float32 of scratch.
SQT_EXPORT int sqt_crop_histogram(const void* x, int n_crops, int64_t p, int n_ch, int bins, int rule, const void* lo,
                                  const void* hi, int per_crop_range, int hist_global, void* gedges, void* counts,
                                  void* stream) {
    if (n_crops == 0) return 0;
    if (rule == 1 && !gedges && bins + 1 > kMaxEdges) return cudaErrorInvalidValue;
    const size_t smem = (kF32Words + (hist_global ? 0 : static_cast<size_t>(n_ch) * bins) +
                         (rule == 1 && !gedges ? bins + 1 : 0)) * sizeof(int);
    cudaError_t err = sqt_allow_smem(histogram_kernel, smem);
    if (err != cudaSuccess) return err;
    histogram_kernel<<<n_crops, kThreadsF32, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), p, n_ch, bins, rule, static_cast<const float*>(lo),
        static_cast<const float*>(hi), per_crop_range, hist_global, static_cast<float*>(gedges),
        static_cast<int*>(counts));
    return cudaGetLastError();
}
