// K18: grey-level co-occurrence texture of a batch of uint8 crops.
//
// Replaces the XLA code of squidpy_tpu/ops/features.py `_glcm_batch_kernel`
// (line 218) with `_glcm_props_kernel` (line 299, `_graycoprops_device` at
// line 265) and `_glcm_one` (line 38, the per-crop `graycomatrix`). For a
// crop and a pixel offset (dr, dc) every in-bounds pair (img[y, x],
// img[y + dr, x + dc]) = (i, j) counts into cell (i, j) of a levels x levels
// matrix; the props are skimage's `graycoprops` of that matrix. The TPU code
// builds each matrix as a one-hot product on the MXU; here a block counts the
// pairs of one (crop, channel) with shared-memory atomics, one offset after
// the other.
//
// Bound on the card: each uint8 pixel read once (at the main path's 4,992
// crops of 89 x 89 x 3, 118.6 MB: 0.035 ms at 3.35 TB/s) against about a
// dozen integer operations a pair (the count, its square's increment and the
// seven moments), 4 offsets x 7,832 pairs a (crop, channel): 0.084 ms at
// 67 T/s, so the operations bound it. The shared-memory atomics on the few
// cells a smooth tissue crop fills are what a launch waits on.
//
// Design. Every prop but ASM is a sum over pairs of a function of (i, j), so the
// block keeps exact integer sums a thread (pairs, sum i, sum j, sum i^2,
// sum j^2, sum ij, sum |i - j|, sum (i - j)^2) and a levels-bin histogram of
// |i - j| for the homogeneity, which sums its 256 terms as a fixed pairwise
// tree. ASM needs sum c^2 over the cells: each count's
// atomic returns the cell's old value c, and the pair adds (c + 1)^2 - c^2 =
// 2c + 1. The props follow from those integers in double, by
// `glcm_props_from_sums` below, the same operations in the same order as the
// plain version (`_glcm_props_plain` in ops/features.py), so the two agree
// bitwise; the ratios of exact integers are closer to the true props than
// JAX's float32 sums of 65,536 terms.
//
// Counters. A levels^2 matrix of uint32 (256 KB at 256 levels) does not fit a
// block's shared memory, so the shared route keeps two 16-bit counts a word
// (128 KB), a pair adding 1 or 1 << 16. That is exact while no cell passes
// 65,535: the wrapper takes it when an offset's pairs (twice that with
// `symmetric`, whose diagonal cells count 2 a pair) stay at or below 65,535;
// a larger crop takes the global route, full uint32 counters in a global
// scratch matrix a block. After an offset the block stores 0 to the words its
// pairs touched (fewer than the matrix's), so the next offset starts clean.
//
// `symmetric` counts P + P^T: the pair goes to cell (min, max) of the upper
// triangle, adding 1 (or 2 on the diagonal), and sum c^2 over the full
// matrix grows by 2(2c + 1) (off the diagonal: two mirrored cells) or
// 4c + 4 (diagonal). `ignore_level` drops every pair that touches the level,
// as the JAX kernel's keep mask does. The count entry (`counts` non-null)
// writes each offset's plain counts instead of props, then clears the matrix.

#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kSums = 9;  // S, Si, Sj, Sii, Sjj, Sij, D1, D2, Q

struct Offset {
    int dr, dc;
};

// props[0..5] = contrast, dissimilarity, homogeneity, ASM, energy, correlation
// from the sums of one (crop, channel, offset) and `homog`, the sum over
// d of the pairs at |i - j| = d over 1 + d^2 (already doubled with
// `symmetric`). Shared with the plain version op for op.
__device__ void glcm_props_from_sums(const long long* s, double homog, int symmetric, double* props) {
    long long S = s[0], Si = s[1], Sj = s[2], Sii = s[3], Sjj = s[4], Sij = s[5], D1 = s[6], D2 = s[7], Q = s[8];
    if (symmetric) {
        S = 2 * S;
        const long long si = Si + Sj, sii = Sii + Sjj;
        Si = si;
        Sj = si;
        Sii = sii;
        Sjj = sii;
        Sij = 2 * Sij;
        D1 = 2 * D1;
        D2 = 2 * D2;
    }
    const double sd = static_cast<double>(S == 0 ? 1 : S);
    const double asm_ = static_cast<double>(Q) / (sd * sd);
    const long long vi = S * Sii - Si * Si, vj = S * Sjj - Sj * Sj, cov = S * Sij - Si * Sj;
    props[0] = static_cast<double>(D2) / sd;
    props[1] = static_cast<double>(D1) / sd;
    props[2] = homog / sd;
    props[3] = asm_;
    props[4] = sqrt(asm_);
    props[5] = (vi == 0 || vj == 0)
                   ? 1.0
                   : static_cast<double>(cov) / sqrt(static_cast<double>(vi) * static_cast<double>(vj));
}

// The homogeneity's numerator over 256 terms (zero past `levels`) as a fixed
// pairwise tree: t <- t[0::2] + t[1::2] until one is left. Lane l holds terms
// 8l..8l+7; the plain version sums the same tree.
__device__ double homogeneity_tree(const unsigned int* hist, int levels, int symmetric) {
    const int lane = threadIdx.x & 31;
    double t[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
        const int d = lane * 8 + k;
        const long long c = d < levels ? static_cast<long long>(hist[d]) * (symmetric ? 2 : 1) : 0;
        t[k] = static_cast<double>(c) / (1.0 + static_cast<double>(d * d));
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) t[k] = t[2 * k] + t[2 * k + 1];
    t[0] = t[0] + t[1];
    t[1] = t[2] + t[3];
    double v = t[0] + t[1];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const double other = __shfl_down_sync(0xFFFFFFFFu, v, o);
        if ((lane & (2 * o - 1)) == 0) v = v + other;
    }
    return v;  // lane 0
}

__device__ __forceinline__ unsigned long long warp_sum(unsigned long long v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xFFFFFFFFu, v, o);
    return v;
}

// One block per (crop, channel): blockIdx.x = crop * n_ch + channel index.
// kPacked: two 16-bit counters a shared word; else uint32 counters at
// `gcells + blockIdx.x % grid * levels^2` (a grid-stride loop over items).
template <bool kPacked>
__global__ void __launch_bounds__(kThreads) glcm_kernel(
    const uint8_t* __restrict__ img, int n_items, int n_ch, const int* __restrict__ channels, int h, int w,
    long long crop_stride, int pix_stride, const Offset* __restrict__ offsets, int n_off, int levels, int symmetric,
    int ignore_level, uint32_t* __restrict__ gcells, double* __restrict__ props, uint32_t* __restrict__ counts) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int cells = levels * levels;
    const int words = kPacked ? (cells + 1) / 2 : 0;
    uint32_t* cnt = kPacked ? reinterpret_cast<uint32_t*>(smem) : gcells + static_cast<size_t>(blockIdx.x) * cells;
    unsigned int* hist = reinterpret_cast<unsigned int*>(smem + static_cast<size_t>((words + 1) & ~1) * 4);
    unsigned long long* red = reinterpret_cast<unsigned long long*>(hist + ((levels + 1) & ~1));

    // clear once; each offset's undo pass leaves the matrix clean again
    for (int k = threadIdx.x; k < (kPacked ? words : cells); k += blockDim.x) cnt[k] = 0;
    for (int k = threadIdx.x; k < levels; k += blockDim.x) hist[k] = 0;
    __syncthreads();

    for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
        const int crop = item / n_ch, ch = channels[item % n_ch];
        const uint8_t* base = img + crop * crop_stride + ch;
        for (int o = 0; o < n_off; ++o) {
            const int dr = offsets[o].dr, dc = offsets[o].dc;
            const int y0 = max(0, -dr), y1 = min(h, h - dr), x0 = max(0, -dc), x1 = min(w, w - dc);
            const int ny = max(0, y1 - y0), nx = max(0, x1 - x0);
            const int npairs = ny * nx;
            unsigned long long acc[kSums] = {0, 0, 0, 0, 0, 0, 0, 0, 0};
            for (int t = threadIdx.x; t < npairs; t += blockDim.x) {
                const int y = y0 + t / nx, x = x0 + t % nx;
                const int i = __ldg(base + (static_cast<long long>(y) * w + x) * pix_stride);
                const int j = __ldg(base + (static_cast<long long>(y + dr) * w + x + dc) * pix_stride);
                if (i == ignore_level || j == ignore_level) continue;
                int cell, inc;
                if (symmetric) {
                    cell = min(i, j) * levels + max(i, j);
                    inc = i == j ? 2 : 1;
                } else {
                    cell = i * levels + j;
                    inc = 1;
                }
                unsigned int old;
                if (kPacked) {
                    const int shift = (cell & 1) * 16;
                    old = (atomicAdd(cnt + (cell >> 1), static_cast<uint32_t>(inc) << shift) >> shift) & 0xFFFFu;
                } else {
                    old = atomicAdd(cnt + cell, static_cast<uint32_t>(inc));
                }
                const unsigned long long c = old;
                acc[8] += !symmetric ? 2 * c + 1 : (i == j ? 4 * c + 4 : 2 * (2 * c + 1));
                const int d = abs(i - j);
                acc[0] += 1;
                acc[1] += i;
                acc[2] += j;
                acc[3] += i * i;
                acc[4] += j * j;
                acc[5] += i * j;
                acc[6] += d;
                acc[7] += d * d;
                if (!counts) atomicAdd(hist + d, 1u);
            }
            // block sums of the nine integers
            const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
            for (int k = 0; k < kSums; ++k) {
                const unsigned long long v = warp_sum(acc[k]);
                if (lane == 0) red[warp * kSums + k] = v;
            }
            __syncthreads();
            const size_t out = static_cast<size_t>(item) * n_off + o;
            if (counts) {
                // count entry: write the matrix, clearing it on the way
                uint32_t* dst = counts + out * cells;
                for (int k = threadIdx.x; k < cells; k += blockDim.x) {
                    if (kPacked) {
                        dst[k] = (cnt[k >> 1] >> ((k & 1) * 16)) & 0xFFFFu;
                    } else {
                        dst[k] = cnt[k];
                        cnt[k] = 0;
                    }
                }
                __syncthreads();
                if (kPacked)
                    for (int k = threadIdx.x; k < words; k += blockDim.x) cnt[k] = 0;
            } else {
                if (warp == 0) {
                    const double homog = homogeneity_tree(hist, levels, symmetric);
                    if (lane == 0) {
                        long long s[kSums];
                        for (int k = 0; k < kSums; ++k) {
                            unsigned long long v = 0;
                            for (int wi = 0; wi < kThreads / 32; ++wi) v += red[wi * kSums + k];
                            s[k] = static_cast<long long>(v);
                        }
                        glcm_props_from_sums(s, homog, symmetric, props + out * 6);
                    }
                }
                __syncthreads();
                // undo pass: zero the words this offset's pairs touched
                for (int t = threadIdx.x; t < npairs; t += blockDim.x) {
                    const int y = y0 + t / nx, x = x0 + t % nx;
                    const int i = __ldg(base + (static_cast<long long>(y) * w + x) * pix_stride);
                    const int j = __ldg(base + (static_cast<long long>(y + dr) * w + x + dc) * pix_stride);
                    const int cell = symmetric ? min(i, j) * levels + max(i, j) : i * levels + j;
                    if (kPacked)
                        cnt[cell >> 1] = 0;
                    else
                        cnt[cell] = 0;
                }
                for (int k = threadIdx.x; k < levels; k += blockDim.x) hist[k] = 0;
            }
            __syncthreads();
        }
    }
}

}  // namespace

// images: uint8, crop c's pixel (y, x) of channel ch at
// img[c * crop_stride + (y * w + x) * pix_stride + ch]; channels (n_ch,)
// int32; offsets (n_off, 2) int32 (dr, dc). packed selects the shared route;
// the global route needs gcells of grid * levels^2 uint32 (grid =
// min(n_items, max_blocks)). props (n_items, n_off, 6) float64, or counts
// (n_items, n_off, levels^2) uint32 when non-null.
SQT_EXPORT int sqt_glcm(const void* img, int n_crops, int n_ch, const void* channels, int h, int w,
                        long long crop_stride, int pix_stride, const void* offsets, int n_off, int levels,
                        int symmetric, int ignore_level, int packed, int max_blocks, void* gcells, void* props,
                        void* counts, void* stream) {
    const int n_items = n_crops * n_ch;
    if (n_items == 0 || n_off == 0) return 0;
    const int cells = levels * levels;
    const size_t hist_bytes = static_cast<size_t>((levels + 1) & ~1) * 4;
    const size_t red_bytes = (kThreads / 32) * kSums * sizeof(unsigned long long);
    const auto st = static_cast<cudaStream_t>(stream);
    const auto* im = static_cast<const uint8_t*>(img);
    const auto* chs = static_cast<const int*>(channels);
    const auto* offs = static_cast<const Offset*>(offsets);
    if (packed) {
        const size_t smem = static_cast<size_t>((((cells + 1) / 2) + 1) & ~1) * 4 + hist_bytes + red_bytes;
        cudaError_t err = sqt_allow_smem(glcm_kernel<true>, smem);
        if (err != cudaSuccess) return err;
        glcm_kernel<true><<<n_items, kThreads, smem, st>>>(
            im, n_items, n_ch, chs, h, w, crop_stride, pix_stride, offs, n_off, levels, symmetric, ignore_level,
            nullptr, static_cast<double*>(props), static_cast<uint32_t*>(counts));
    } else {
        const size_t smem = hist_bytes + red_bytes;
        const int grid = n_items < max_blocks ? n_items : max_blocks;
        glcm_kernel<false><<<grid, kThreads, smem, st>>>(
            im, n_items, n_ch, chs, h, w, crop_stride, pix_stride, offs, n_off, levels, symmetric, ignore_level,
            static_cast<uint32_t*>(gcells), static_cast<double*>(props), static_cast<uint32_t*>(counts));
    }
    return cudaGetLastError();
}
