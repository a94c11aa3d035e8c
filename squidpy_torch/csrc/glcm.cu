// K18: grey-level co-occurrence texture of a batch of crops.
//
// Replaces the XLA code of squidpy_tpu/ops/features.py `_glcm_batch_kernel`
// (line 218) with `_glcm_props_kernel` (line 299, `_graycoprops_device` at
// line 265) and `_glcm_one` (line 38, the per-crop `graycomatrix`). For a
// crop and a pixel offset (dr, dc) every in-bounds pair (img[y, x],
// img[y + dr, x + dc]) = (i, j) counts into cell (i, j) of a levels x levels
// matrix; the props are skimage's `graycoprops` of that matrix. The TPU code
// builds each matrix as a one-hot product on the MXU.
//
// Bound on the card: each uint8 pixel read once (at the main path's 4,992
// crops of 89 x 89 x 3, 118.6 MB: 0.035 ms at 3.35 TB/s) against about a
// dozen integer operations a pair (the count, its square's increment, the
// five moments, the |i - j| histogram), 4 offsets x 7,832 pairs a (crop,
// channel): 0.084 ms at 67 T/s, so the operations bound it. Measured by
// chip_smoke.py on one NVIDIA H100 80GB HBM3 at a 700 W power limit: 1.77 ms
// there (the previous design, a block a (crop, channel) and a pair a
// thread, 7.2-7.5 ms in `chip_smoke.py --turns`), 4.18 ms at 177 x 177
// crops (0.333 ms bound); the global route 102 ms for a 65,600^2 crop's
// counts (4.3e9 pairs, one cell past 2^32).
//
// Props from exact integers. Every prop but ASM is a sum over pairs of a
// function of (i, j): the kernel keeps exact sums (sum i, sum j, sum i^2,
// sum j^2, sum ij) and a levels-bin histogram of d = |i - j|, from which the
// pairs, sum d and sum d^2 follow, and the homogeneity sums its terms
// (count_d / (1 + d^2)) as a fixed pairwise tree of max(256, levels rounded
// up to a power of two) terms. ASM needs sum c^2 over the cells: each
// count's atomic returns the cell's old value c, and k pairs of one cell add
// (c + k)^2 - c^2 = 2ck + k^2. The sums past pairs x levels (sum i^2,
// sum j^2, sum ij, sum c^2, sum d^2) are 128-bit integers, as are the
// centred products (S sum i^2 - (sum i)^2, its j twin and S sum ij -
// sum i sum j); each is rounded to double once, and `glcm_props_from_sums`
// then runs the same double operations in the same order as the plain
// version (`_glcm_props_plain` in ops/features.py, Python integers where its
// int64 sums would not hold them), so the two agree bitwise.
//
// `symmetric` counts P + P^T: the pair goes to cell (min, max) of the upper
// triangle, adding 1 (2 on the diagonal), and sum c^2 over the full matrix
// grows by 2(2ck + k^2) off the diagonal (two mirrored cells) or 4ck + 4k^2
// on it. A pixel outside [0, levels) or equal to `ignore_level` drops its
// pair, as the JAX kernel's one-hot and keep mask do. The count entry
// (`counts` non-null) writes each offset's plain counts instead of props.
//
// Design: two routes, chosen by the wrapper (ops/features.py `k18_route`):
// - shared (uint8 crops, levels <= 256, at most 65,535 counts a cell): a
//   persistent block of 1024 threads takes one crop at a time, its selected
//   channels one after the other. Counts are two 16-bit counters a shared
//   word (128 KB at 256 levels), so one block fills an SM; what it waits on
//   is hidden or cut: the crop's raw bytes sit in shared memory while the
//   next crop's load into registers; each channel's plane is staged once
//   (rows padded to 4 bytes) and every offset walks it in 2-D with no
//   division a pair; at 256 levels with nothing ignored a thread takes four
//   neighbouring pairs from two 4-byte loads (`walk_pairs`); after an offset
//   the block writes the six moments and the d histogram out and clears the
//   matrix rows between the plane's least and greatest value, and a second
//   kernel takes the props, a warp an (item, offset), so no block waits on
//   one warp's double arithmetic. A thread's moments stay in 32 bits (an
//   offset's sums fit: at most 65,535 pairs of values below 256). Lanes on
//   one cell are not merged: __match_any_sync costs more than the conflicts.
// - global (more pairs, more levels, int32 pixels): the item's pair rows are
//   split over blocks (about four blocks an SM in all), counters in a global
//   matrix an item take atomics merged by __match_any_sync (a bright crop
//   puts millions of pairs on one cell); they are uint32, or 64-bit where a
//   cell may pass 2^32 - 1 (2^32 pairs an offset, 2^31 with `symmetric`).
//   Each block keeps its histogram of d below 4096 in shared memory and adds
//   it and its 128-bit moments (two 64-bit atomics and the carry) to the
//   item's global sums once; a warp an item then takes the props and clears
//   the sums, and the counters are cleared by a memset or, where the matrix
//   has more cells than the offset has pairs, by a pass over the pairs. Pair
//   indices are 64-bit. What remains a limit is memory: levels^2 counters an
//   item (and the count entry's output).

#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kSharedThreads = 1024;
constexpr int kGlobalThreads = 256;
constexpr int kWarps = kSharedThreads / 32;
constexpr int kMoments = 6;      // sum i, sum j, sum i^2, sum j^2, sum ij, sum c^2
constexpr int kTree = 256;       // the homogeneity's least number of terms
constexpr int kHistShared = 4096;  // global route: d below this counts in shared memory
constexpr unsigned kFull = 0xFFFFFFFFu;

struct Offset {
    int dr, dc;
};

struct U128 {
    unsigned long long hi, lo;
};

__device__ __forceinline__ U128 u128(unsigned long long v) { return {0ull, v}; }

__device__ __forceinline__ U128 mul64(unsigned long long a, unsigned long long b) {
    return {__umul64hi(a, b), a * b};
}

// a * b, exact while the product is below 2^128
__device__ __forceinline__ U128 mul128(unsigned long long a, U128 b) {
    U128 p = mul64(a, b.lo);
    p.hi += a * b.hi;
    return p;
}

__device__ __forceinline__ U128 add128(U128 a, U128 b) {
    const unsigned long long lo = a.lo + b.lo;
    return {a.hi + b.hi + (lo < a.lo ? 1ull : 0ull), lo};
}

__device__ __forceinline__ U128 shfl_down128(U128 v, int o) {
    return {__shfl_down_sync(0xFFFFFFFFu, v.hi, o), __shfl_down_sync(0xFFFFFFFFu, v.lo, o)};
}

// p[0] += v.lo, p[1] += v.hi and the carry: exact whatever the order of the adds
__device__ __forceinline__ void atomic_add128(unsigned long long* p, U128 v) {
    const unsigned long long old = atomicAdd(p, v.lo);
    const unsigned long long hi = v.hi + (old + v.lo < old ? 1ull : 0ull);
    if (hi) atomicAdd(p + 1, hi);
}

// moment k of an (item, offset): uint32 (the shared route) or two 64-bit words, low first (the global route)
__device__ __forceinline__ U128 moment(const uint32_t* m, int k) { return u128(m[k]); }
__device__ __forceinline__ U128 moment(const unsigned long long* m, int k) { return {m[2 * k + 1], m[2 * k]}; }

__device__ __forceinline__ bool less128(U128 a, U128 b) { return a.hi < b.hi || (a.hi == b.hi && a.lo < b.lo); }

__device__ __forceinline__ U128 sub128(U128 a, U128 b) {  // a >= b
    return {a.hi - b.hi - (a.lo < b.lo ? 1ull : 0ull), a.lo - b.lo};
}

// The 128-bit integer rounded to the nearest double (ties to even): its top
// 64 bits with the rest or-ed into bit 0 as a sticky bit, scaled exactly.
__device__ double u128_to_double(U128 v) {
    if (v.hi == 0) return __ull2double_rn(v.lo);
    const int s = __clzll(static_cast<long long>(v.hi));
    unsigned long long top = s ? (v.hi << s) | (v.lo >> (64 - s)) : v.hi;
    const unsigned long long rest = s ? v.lo << s : v.lo;
    top |= rest != 0 ? 1ull : 0ull;
    return ldexp(__ull2double_rn(top), 64 - s);
}

// a * b - c * d as a signed double, the exact value rounded once.
__device__ double centred(unsigned long long a, U128 b, unsigned long long c, unsigned long long d, bool* zero) {
    const U128 p = mul128(a, b), q = mul64(c, d);
    *zero = p.hi == q.hi && p.lo == q.lo;
    return less128(p, q) ? -u128_to_double(sub128(q, p)) : u128_to_double(sub128(p, q));
}

// props[0..5] = contrast, dissimilarity, homogeneity, ASM, energy, correlation
// from s = (S, Si, Sj, Sii, Sjj, Sij, D1, D2, Q) of one (crop, channel,
// offset) and `homog`, the homogeneity's numerator (already doubled with
// `symmetric`). S, Si and Sj stay below 2^64 (pairs x levels); the others
// are 128-bit. Shared with the plain version op for op.
__device__ void glcm_props_from_sums(const U128* s, double homog, int symmetric, double* props) {
    unsigned long long S = s[0].lo, Si = s[1].lo, Sj = s[2].lo;
    U128 Sii = s[3], Sjj = s[4], Sij = s[5], D1 = s[6], D2 = s[7];
    const U128 Q = s[8];
    if (symmetric) {
        S = 2 * S;
        const unsigned long long si = Si + Sj;
        const U128 sii = add128(Sii, Sjj);
        Si = si;
        Sj = si;
        Sii = sii;
        Sjj = sii;
        Sij = add128(Sij, Sij);
        D1 = add128(D1, D1);
        D2 = add128(D2, D2);
    }
    const double sd = static_cast<double>(S == 0 ? 1 : S);
    const double asm_ = u128_to_double(Q) / (sd * sd);
    bool zi, zj, zc;
    const double vi = centred(S, Sii, Si, Si, &zi), vj = centred(S, Sjj, Sj, Sj, &zj),
                 cov = centred(S, Sij, Si, Sj, &zc);
    props[0] = u128_to_double(D2) / sd;
    props[1] = u128_to_double(D1) / sd;
    props[2] = homog / sd;
    props[3] = asm_;
    props[4] = sqrt(asm_);
    props[5] = (zi || zj) ? 1.0 : cov / sqrt(vi * vj);
}

// Lane 0 of the calling warp gets the homogeneity's numerator over n_terms
// (a power of two, at least 256; zero past `levels`) as the pairwise tree
// t <- t[0::2] + t[1::2]: each lane sums its n_terms / 32 neighbouring
// terms as the same tree (a binary counter over a stack), then the lanes'
// sums pair up by shuffles. It also returns the pairs, sum d and sum d^2.
template <typename H>
__device__ double homogeneity_tree(const H* hist, int levels, int n_terms, int symmetric, U128* sums3) {
    const int lane = threadIdx.x & 31;
    const int per = n_terms / 32;
    double stack[32];
    int top = 0;
    U128 S = u128(0), D1 = u128(0), D2 = u128(0);
    for (int k = 0; k < per; ++k) {
        const long long d = static_cast<long long>(lane) * per + k;
        const unsigned long long c = d < levels ? static_cast<unsigned long long>(hist[d]) : 0ull;
        S = add128(S, u128(c));
        D1 = add128(D1, mul64(c, static_cast<unsigned long long>(d)));
        D2 = add128(D2, mul64(c, static_cast<unsigned long long>(d * d)));
        double v = static_cast<double>(static_cast<long long>(c * (symmetric ? 2 : 1))) /
                   (1.0 + static_cast<double>(d * d));
        for (int j = k; j & 1; j >>= 1) v = stack[--top] + v;
        stack[top++] = v;
    }
    double v = stack[0];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const double other = __shfl_down_sync(kFull, v, o);
        if ((lane & (2 * o - 1)) == 0) v = v + other;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
        S = add128(S, shfl_down128(S, o));
        D1 = add128(D1, shfl_down128(D1, o));
        D2 = add128(D2, shfl_down128(D2, o));
    }
    sums3[0] = S;
    sums3[1] = D1;
    sums3[2] = D2;
    return v;
}

// A warp's props of one (item, offset) from its moments (sum i, sum j,
// sum i^2, sum j^2, sum ij, sum c^2) and d histogram; lane 0 writes them.
template <typename H, typename M>
__device__ void warp_props(const H* hist, const M* mom, int levels, int n_terms, int symmetric, double* out) {
    U128 d3[3];
    const double homog = homogeneity_tree(hist, levels, n_terms, symmetric, d3);
    if ((threadIdx.x & 31) == 0) {
        const U128 sums[9] = {d3[0],         moment(mom, 0), moment(mom, 1), moment(mom, 2), moment(mom, 3),
                              moment(mom, 4), d3[1],         d3[2],         moment(mom, 5)};
        glcm_props_from_sums(sums, homog, symmetric, out);
    }
}

// The histogram of d: lanes with one d merge into one atomic of k.
__device__ __forceinline__ void merged_hist(unsigned* hist, unsigned d, bool valid) {
    const unsigned m = __match_any_sync(kFull, valid ? d : 0x80000000u | (threadIdx.x & 31));
    if (valid && (threadIdx.x & 31) == __ffs(m) - 1) atomicAdd(hist + d, static_cast<unsigned>(__popc(m)));
}

__device__ __forceinline__ unsigned warp_sum(unsigned v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFull, v, o);
    return v;
}

__device__ __forceinline__ U128 warp_sum(U128 v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = add128(v, shfl_down128(v, o));
    return v;
}

// Four bytes of the staged plane from any byte address (the plane's words
// are 4-aligned and padded by a word past its end).
__device__ __forceinline__ uint32_t load4(const uint8_t* plane, int a) {
    const uint32_t* wp = reinterpret_cast<const uint32_t*>(plane + (a & ~3));
    return __funnelshift_r(wp[0], wp[1], (a & 3) * 8);
}

// ---------------------------------------------------------------- shared

// One walk over an offset's pairs from the staged plane (row pitch `pitch`).
// kFast (256 levels, not symmetric, nothing ignored: every uint8 pair
// counts): a thread takes four neighbouring pairs of a row at a time from
// two 4-byte loads; the moments are __dp4a's byte dot products, the four
// cells' 16-bit codes two __byte_perm's and the four d one __vabsdiffu4.
// Otherwise a thread takes one pair at a time and drops pairs outside
// [0, levels) or touching `ignore_level`.
template <bool kFast>
__device__ __forceinline__ void walk_pairs(const uint8_t* plane, int pitch, int y0, int x0, int ny, int nx, int dr,
                                           int dc, int levels, int symmetric, int ignore_level, uint32_t* cnt,
                                           unsigned* hist, unsigned* m) {
    const int tid = threadIdx.x, nt = blockDim.x;
    const int doff = dr * pitch + dc;
    if (kFast) {
        const int groups = (nx + 3) >> 2, units = ny * groups;
        if (units == 0) return;
        const int sy = nt / groups, sg = nt % groups;
        int uy = tid / groups, ug = tid % groups;
        for (int t = tid; t < units; t += nt) {
            const int a = (y0 + uy) * pitch + x0 + 4 * ug;
            const uint32_t wi = load4(plane, a), wj = load4(plane, a + doff);
            const int nv = min(4, nx - 4 * ug);
            const uint32_t c01 = __byte_perm(wj, wi, 0x5140), c23 = __byte_perm(wj, wi, 0x7362);
            const uint32_t mask = nv == 4 ? kFull : (1u << (8 * nv)) - 1u;
            const uint32_t vi = wi & mask, vj = wj & mask;
            m[0] = __dp4a(vi, 0x01010101u, m[0]);
            m[1] = __dp4a(vj, 0x01010101u, m[1]);
            m[2] = __dp4a(vi, vi, m[2]);
            m[3] = __dp4a(vj, vj, m[3]);
            m[4] = __dp4a(vi, vj, m[4]);
            const uint32_t dd = __vabsdiffu4(wi, wj);
#pragma unroll
            for (int b = 0; b < 4; ++b) {
                if (b < nv) {
                    const uint32_t code = ((b < 2 ? c01 : c23) >> (16 * (b & 1))) & 0xFFFFu;
                    const int sh = (code & 1) << 4;
                    const uint32_t c = (atomicAdd(cnt + (code >> 1), 1u << sh) >> sh) & 0xFFFFu;
                    m[5] += 2 * c + 1;
                    if (hist) atomicAdd(hist + ((dd >> (8 * b)) & 0xFFu), 1u);
                }
            }
            ug += sg;
            uy += sy;
            if (ug >= groups) {
                ug -= groups;
                ++uy;
            }
        }
        return;
    }
    const int npairs = ny * nx;
    if (npairs == 0) return;
    const int sy = nt / nx, sx = nt % nx;
    int y = tid / nx, x = tid % nx;
    for (int t = tid; t < npairs; t += nt) {
        const int a = (y0 + y) * pitch + x0 + x;
        const int i = plane[a], j = plane[a + doff];
        x += sx;
        y += sy;
        if (x >= nx) {
            x -= nx;
            ++y;
        }
        if (i >= levels || j >= levels || i == ignore_level || j == ignore_level) continue;
        const int lo = symmetric ? min(i, j) : i, hi = symmetric ? max(i, j) : j;
        const int cell = lo * levels + hi, sh = (cell & 1) << 4;
        const uint32_t inc = symmetric && i == j ? 2u : 1u;
        const uint32_t c = (atomicAdd(cnt + (cell >> 1), inc << sh) >> sh) & 0xFFFFu;
        m[5] += !symmetric ? 2 * c + 1 : (i == j ? 4 * c + 4 : 2 * (2 * c + 1));
        if (hist) atomicAdd(hist + abs(i - j), 1u);
        m[0] += i;
        m[1] += j;
        m[2] += i * i;
        m[3] += j * j;
        m[4] += i * j;
    }
}

// The matrix words of rows [lo, hi] (zero past `levels`), cleared.
__device__ __forceinline__ void clear_rows(uint32_t* cnt, int levels, int lo, int hi) {
    if (hi < lo) return;
    const int w0 = (lo * levels) >> 1, w1 = ((hi + 1) * levels + 1) >> 1;
    for (int k = w0 + threadIdx.x; k < w1; k += blockDim.x) cnt[k] = 0;
}

// Persistent blocks, one crop at a time, its selected channels one after the
// other: item = crop * n_ch + k. With `prefetch` > 0 the block holds the
// crop's raw bytes in shared memory (16-byte vectors from a 16-aligned
// address) and loads the next crop's vectors into registers (`prefetch` a
// thread) while it counts this one; else each channel's plane is read from
// the card's memory. For the props each (item, offset) leaves its six
// moments (uint32: an offset's sums fit, at most 65,535 pairs of values
// below 256) and its d histogram (uint16) in `mom` and `dhist` for
// `glcm_props_kernel`; the count entry writes the matrix to `counts`
// instead. After an offset the block clears the matrix rows between the
// plane's least and greatest value.
template <bool kFast>
__global__ void __launch_bounds__(kSharedThreads) glcm_shared_kernel(
    const uint8_t* __restrict__ img, const uint8_t* __restrict__ img_end, int n_crops, int n_ch,
    const int* __restrict__ channels, int h, int w, long long crop_stride, int pix_stride,
    const Offset* __restrict__ offsets, int n_off, int levels, int symmetric, int ignore_level, int prefetch,
    uint32_t* __restrict__ mom, uint16_t* __restrict__ dhist, uint32_t* __restrict__ counts) {
    constexpr int kPrefetch = 4;
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ int range[2];
    const int cells = levels * levels;
    const int words = (cells + 1) / 2;
    const int words_pad = (words + 3) & ~3;
    const int pitch = (w + 3) & ~3;
    uint32_t* cnt = reinterpret_cast<uint32_t*>(smem);
    unsigned* hist = cnt + words_pad;                      // kTree bins
    unsigned* red = hist + kTree;                          // kWarps x kMoments
    uint8_t* plane = reinterpret_cast<uint8_t*>(red + kWarps * kMoments);
    uint8_t* raw = plane + ((h * pitch + 8 + 15) & ~15);
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const long long len = static_cast<long long>(h) * w * pix_stride;

    // the raw vectors of `crop`: v = tid + r * blockDim.x
    uint4 ahead[kPrefetch];
    auto fetch = [&](int crop) {
        const uint8_t* base = img + crop * crop_stride;
        const uint8_t* a0 = reinterpret_cast<const uint8_t*>(reinterpret_cast<uintptr_t>(base) & ~uintptr_t(15));
        const long long nvec = (base - a0 + len + 15) >> 4;
#pragma unroll
        for (int r = 0; r < kPrefetch; ++r) {
            const long long v = tid + static_cast<long long>(r) * blockDim.x;
            const uint8_t* at = a0 + 16 * v;
            if (r < prefetch && v < nvec) {
                if (at >= img && at + 16 <= img_end) {
                    ahead[r] = __ldg(reinterpret_cast<const uint4*>(at));
                } else {  // the batch's first or last vector: only the bytes inside it
                    uint32_t word[4] = {0, 0, 0, 0};
                    for (int k = 0; k < 16; ++k)
                        if (at + k >= img && at + k < img_end)
                            word[k >> 2] |= static_cast<uint32_t>(at[k]) << (8 * (k & 3));
                    ahead[r] = make_uint4(word[0], word[1], word[2], word[3]);
                }
            }
        }
    };
    if (prefetch && blockIdx.x < n_crops) fetch(blockIdx.x);

    for (int k = tid; k < words_pad; k += blockDim.x) cnt[k] = 0;
    for (int k = tid; k < kTree; k += blockDim.x) hist[k] = 0;
    for (int crop = blockIdx.x; crop < n_crops; crop += gridDim.x) {
        const uint8_t* base = img + crop * crop_stride;
        const int shift = static_cast<int>(reinterpret_cast<uintptr_t>(base) & 15);
        if (prefetch) {
            const long long nvec = (shift + len + 15) >> 4;
#pragma unroll
            for (int r = 0; r < kPrefetch; ++r) {
                const long long v = tid + static_cast<long long>(r) * blockDim.x;
                if (r < prefetch && v < nvec) reinterpret_cast<uint4*>(raw)[v] = ahead[r];
            }
            __syncthreads();
            if (crop + gridDim.x < n_crops) fetch(crop + gridDim.x);
        }
        for (int ci = 0; ci < n_ch; ++ci) {
            const int item = crop * n_ch + ci, ch = channels[ci];
            if (tid == 0) {
                range[0] = 255;
                range[1] = 0;
            }
            __syncthreads();
            int lo = 255, hi = 0;
            for (int y = warp; y < h; y += kWarps) {
                for (int x = lane; x < w; x += 32) {
                    const long long at = (static_cast<long long>(y) * w + x) * pix_stride + ch;
                    const int v = prefetch ? raw[shift + at] : __ldg(base + at);
                    plane[y * pitch + x] = static_cast<uint8_t>(v);
                    lo = min(lo, v);
                    hi = max(hi, v);
                }
            }
#pragma unroll
            for (int o = 16; o > 0; o >>= 1) {
                lo = min(lo, __shfl_down_sync(kFull, lo, o));
                hi = max(hi, __shfl_down_sync(kFull, hi, o));
            }
            if (lane == 0) {
                atomicMin(range, lo);
                atomicMax(range + 1, hi);
            }
            __syncthreads();
            const int row_lo = range[0], row_hi = min(range[1], levels - 1);
            for (int o = 0; o < n_off; ++o) {
                const int dr = offsets[o].dr, dc = offsets[o].dc;
                const int y0 = max(0, -dr), x0 = max(0, -dc);
                const int ny = max(0, min(h, h - dr) - y0), nx = max(0, min(w, w - dc) - x0);
                unsigned m[kMoments] = {0, 0, 0, 0, 0, 0};
                walk_pairs<kFast>(plane, pitch, y0, x0, ny, nx, dr, dc, levels, symmetric, ignore_level, cnt,
                                  counts ? nullptr : hist, m);
#pragma unroll
                for (int k = 0; k < kMoments; ++k) {
                    const unsigned v = warp_sum(m[k]);
                    if (lane == 0) red[warp * kMoments + k] = v;
                }
                __syncthreads();
                const size_t out = static_cast<size_t>(item) * n_off + o;
                if (counts) {
                    // each thread writes and clears its own words: no barrier between
                    uint32_t* dst = counts + out * cells;
                    for (int k = tid; k < words; k += blockDim.x) {
                        const uint32_t v = cnt[k];
                        dst[2 * k] = v & 0xFFFFu;
                        if (2 * k + 1 < cells) dst[2 * k + 1] = v >> 16;
                        cnt[k] = 0;
                    }
                } else {
                    if (warp == 0) {
#pragma unroll
                        for (int k = 0; k < kMoments; ++k) {
                            const unsigned v = warp_sum(red[lane * kMoments + k]);
                            if (lane == 0) mom[out * kMoments + k] = v;
                        }
                    }
                    for (int k = tid; k < kTree; k += blockDim.x) {
                        dhist[out * kTree + k] = static_cast<uint16_t>(hist[k]);
                        hist[k] = 0;
                    }
                    clear_rows(cnt, levels, row_lo, row_hi);
                }
                __syncthreads();
            }
        }
    }
}

// A warp an (item, offset) of the shared route: its props.
__global__ void glcm_props_kernel(long long n, int levels, int symmetric, const uint32_t* __restrict__ mom,
                                  const uint16_t* __restrict__ dhist, double* __restrict__ props) {
    const long long k = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
    if (k >= n) return;
    warp_props(dhist + k * kTree, mom + k * kMoments, levels, kTree, symmetric, props + k * 6);
}

// ---------------------------------------------------------------- global

// One offset of the items [item0, item0 + gridDim.y): block (chunk, slot)
// walks `rows` pair rows from chunk * rows. mode 0 counts for the props
// (counters at gcnt + slot * cells, sums and d histogram of the slot), mode
// 1 counts into `counts` (the count entry's output of this offset), mode 2
// clears the counters its pairs touched. Counter: uint32, or 64 bits where
// a cell may pass 2^32 - 1. A thread's sum of c^2 is 128-bit; its other
// moments stay below 2^64 in 64 bits on any card of less than 256 GB: it
// takes at most bytes / 256 pairs of uint8 values (below 2^16 squared), or
// bytes / 1024 of int32 values, whose square is below levels^2 <= bytes / 4
// (the levels^2 counters are allocated); the block adds them as 128-bit.
template <typename Pixel, typename Counter>
__global__ void __launch_bounds__(kGlobalThreads) glcm_global_kernel(
    const Pixel* __restrict__ img, int item0, int n_ch, const int* __restrict__ channels, int h, int w,
    long long crop_stride, int pix_stride, int dr, int dc, long long rows, int levels, int symmetric,
    int ignore_level, int mode, Counter* __restrict__ gcnt, long long cnt_stride,
    unsigned long long* __restrict__ gsums, unsigned long long* __restrict__ ghist) {
    __shared__ unsigned shist[kHistShared];
    __shared__ U128 sred[kGlobalThreads / 32][kMoments];
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int slot = blockIdx.y, item = item0 + slot;
    const Pixel* base = img + static_cast<long long>(item / n_ch) * crop_stride + channels[item % n_ch];
    Counter* cnt = gcnt + slot * cnt_stride;
    const int nh = min(levels, kHistShared);
    if (mode == 0)
        for (int k = tid; k < nh; k += blockDim.x) shist[k] = 0;
    __syncthreads();
    const long long y0 = max(0, -dr), x0 = max(0, -dc);
    const long long ny = max(0, min(h, h - dr) - max(0, -dr)), nx = max(0, min(w, w - dc) - max(0, -dc));
    const long long r0 = blockIdx.x * rows, r1 = min(ny, r0 + rows);
    const long long npairs = r1 > r0 ? (r1 - r0) * nx : 0;
    unsigned long long m[kMoments - 1] = {0, 0, 0, 0, 0};
    U128 sq = u128(0);
    const long long sy = nx ? blockDim.x / nx : 0, sx = nx ? blockDim.x % nx : 0;
    long long y = nx ? y0 + r0 + tid / nx : 0, x = nx ? tid % nx : 0;
    for (long long t0 = 0; t0 < npairs; t0 += blockDim.x) {
        bool valid = t0 + tid < npairs;
        long long i = 0, j = 0;
        if (valid) {
            i = base[(y * w + x0 + x) * pix_stride];
            j = base[((y + dr) * w + x0 + x + dc) * pix_stride];
            valid = i >= 0 && j >= 0 && i < levels && j < levels && i != ignore_level && j != ignore_level;
        }
        x += sx;
        y += sy;
        if (x >= nx) {
            x -= nx;
            ++y;
        }
        const long long lo = symmetric ? min(i, j) : i, hi = symmetric ? max(i, j) : j;
        const long long cell = lo * levels + hi;
        if (mode == 2) {
            if (valid) cnt[cell] = 0;
            continue;
        }
        const unsigned grp = __match_any_sync(
            kFull, valid ? static_cast<unsigned long long>(cell) : (1ull << 63) | static_cast<unsigned>(lane));
        if (valid && lane == __ffs(grp) - 1) {
            const unsigned long long k = __popc(grp);
            const unsigned inc = symmetric && i == j ? 2u : 1u;
            const unsigned long long c = atomicAdd(cnt + cell, static_cast<Counter>(k * inc));
            if (mode == 0)
                sq = add128(sq, u128(!symmetric ? 2 * c * k + k * k
                                                : (i == j ? 4 * c * k + 4 * k * k : 2 * (2 * c * k + k * k))));
        }
        if (mode == 0) {
            const long long d = i > j ? i - j : j - i;
            if (d < kHistShared) {
                merged_hist(shist, static_cast<unsigned>(d), valid);
            } else if (valid) {
                atomicAdd(ghist + slot * static_cast<long long>(levels) + d, 1ull);
            }
            if (valid) {
                m[0] += i;
                m[1] += j;
                m[2] += i * i;
                m[3] += j * j;
                m[4] += i * j;
            }
        }
    }
    if (mode != 0) return;
#pragma unroll
    for (int k = 0; k < kMoments; ++k) {
        const U128 v = warp_sum(k < kMoments - 1 ? u128(m[k]) : sq);
        if (lane == 0) sred[warp][k] = v;
    }
    __syncthreads();
    if (tid < kMoments) {
        U128 v = u128(0);
        for (int k = 0; k < kGlobalThreads / 32; ++k) v = add128(v, sred[k][tid]);
        if (v.hi | v.lo) atomic_add128(gsums + (slot * kMoments + tid) * 2, v);
    }
    for (int k = tid; k < nh; k += blockDim.x)
        if (shist[k])
            atomicAdd(ghist + slot * static_cast<long long>(levels) + k, static_cast<unsigned long long>(shist[k]));
}

// A warp a slot: the props of one offset from the slot's sums and
// histogram, which it then clears.
__global__ void glcm_finish_kernel(int item0, int n_off, int o, int levels, int n_terms, int symmetric,
                                   unsigned long long* __restrict__ gsums, unsigned long long* __restrict__ ghist,
                                   double* __restrict__ props) {
    const int slot = blockIdx.x, lane = threadIdx.x;
    unsigned long long* hs = ghist + slot * static_cast<long long>(levels);
    unsigned long long* ss = gsums + slot * 2 * kMoments;
    warp_props(hs, ss, levels, n_terms, symmetric, props + (static_cast<size_t>(item0 + slot) * n_off + o) * 6);
    __syncwarp();
    for (long long k = lane; k < levels; k += 32) hs[k] = 0;
    if (lane < 2 * kMoments) ss[lane] = 0;
}

template <typename Pixel, typename Counter>
int glcm_global(const Pixel* img, int n_items, int n_ch, const int* chs, int h, int w, long long crop_stride,
                int pix_stride, const int* host_offs, int n_off, int levels, int symmetric, int ignore_level,
                int group, int sms, Counter* gcnt, unsigned long long* gsums, unsigned long long* ghist,
                double* props, Counter* counts, cudaStream_t st) {
    const long long cells = static_cast<long long>(levels) * levels;
    int n_terms = kTree;
    while (n_terms < levels) n_terms <<= 1;
    for (int g0 = 0; g0 < n_items; g0 += group) {
        const int ng = std::min(group, n_items - g0);
        for (int o = 0; o < n_off; ++o) {
            const int dr = host_offs[2 * o], dc = host_offs[2 * o + 1];
            const long long ny = std::max(0, std::min(h, h - dr) - std::max(0, -dr));
            const long long nx = std::max(0, std::min(w, w - dc) - std::max(0, -dc));
            const long long rows_all = std::max(ny, 1LL);
            if (counts) {
                // the count entry: every item of the call in one launch, into its output
                if (ny == 0 || nx == 0) continue;
                const long long chunks = std::min<long long>(ny, std::max(1LL, (4LL * sms + ng - 1) / ng));
                const long long rows = (ny + chunks - 1) / chunks;
                const dim3 grid(static_cast<unsigned>((ny + rows - 1) / rows), static_cast<unsigned>(ng));
                glcm_global_kernel<Pixel, Counter><<<grid, kGlobalThreads, 0, st>>>(
                    img, g0, n_ch, chs, h, w, crop_stride, pix_stride, dr, dc, rows, levels, symmetric, ignore_level,
                    1, counts + (static_cast<long long>(g0) * n_off + o) * cells, n_off * cells, nullptr, nullptr);
                continue;
            }
            const long long chunks = std::min<long long>(rows_all, std::max(1LL, (4LL * sms + ng - 1) / ng));
            const long long rows = (rows_all + chunks - 1) / chunks;
            const dim3 grid(static_cast<unsigned>((rows_all + rows - 1) / rows), static_cast<unsigned>(ng));
            glcm_global_kernel<Pixel, Counter><<<grid, kGlobalThreads, 0, st>>>(
                img, g0, n_ch, chs, h, w, crop_stride, pix_stride, dr, dc, rows, levels, symmetric, ignore_level, 0,
                gcnt, cells, gsums, ghist);
            glcm_finish_kernel<<<ng, 32, 0, st>>>(g0, n_off, o, levels, n_terms, symmetric, gsums, ghist, props);
            if (cells <= ny * nx) {
                cudaError_t err = cudaMemsetAsync(gcnt, 0, static_cast<size_t>(ng) * cells * sizeof(Counter), st);
                if (err != cudaSuccess) return err;
            } else {
                glcm_global_kernel<Pixel, Counter><<<grid, kGlobalThreads, 0, st>>>(
                    img, g0, n_ch, chs, h, w, crop_stride, pix_stride, dr, dc, rows, levels, symmetric, ignore_level,
                    2, gcnt, cells, gsums, ghist);
            }
        }
    }
    return cudaGetLastError();
}

template <typename Pixel>
int glcm_global_any(const Pixel* img, int wide_counts, int n_items, int n_ch, const int* chs, int h, int w,
                    long long crop_stride, int pix_stride, const int* host_offs, int n_off, int levels, int symmetric,
                    int ignore_level, int group, int sms, void* gcnt, unsigned long long* gsums,
                    unsigned long long* ghist, double* props, void* counts, cudaStream_t st) {
    if (wide_counts)
        return glcm_global(img, n_items, n_ch, chs, h, w, crop_stride, pix_stride, host_offs, n_off, levels, symmetric,
                           ignore_level, group, sms, static_cast<unsigned long long*>(gcnt), gsums, ghist, props,
                           static_cast<unsigned long long*>(counts), st);
    return glcm_global(img, n_items, n_ch, chs, h, w, crop_stride, pix_stride, host_offs, n_off, levels, symmetric,
                       ignore_level, group, sms, static_cast<uint32_t*>(gcnt), gsums, ghist, props,
                       static_cast<uint32_t*>(counts), st);
}

}  // namespace

// img: crop c's pixel (y, x) of channel ch at img[c * crop_stride + (y * w
// + x) * pix_stride + ch], uint8 (wide 0) or int32 (wide 1); channels
// (n_ch,) int32 on the card; offsets (n_off, 2) int32 (dr, dc) on the card
// (`offsets`, the shared route) and on the host (`host_offsets`, the global
// route's launches). props (n_items, n_off, 6) float64, or counts (n_items,
// n_off, levels^2) uint32 when non-null (zero on entry on the global route).
// route 0 (shared) takes uint8 crops at up to 256 levels and 65,535 counts a
// cell; for the props it needs gsums of n_items * n_off * 6 uint32 and ghist
// of n_items * n_off * 256 uint16. route 1 (global) takes `group` items at a
// time and needs gcnt of group * levels^2 counters, gsums of group * 12
// (six 128-bit moments, low word first) and ghist of group * levels uint64,
// all zero (and left zero); its counters (gcnt and counts) are uint64 with
// wide_counts, else uint32. sms: the card's SMs.
SQT_EXPORT int sqt_glcm(const void* img, int wide, int n_crops, int n_ch, const void* channels, int h, int w,
                        long long crop_stride, int pix_stride, const void* offsets, const void* host_offsets,
                        int n_off, int levels, int symmetric, int ignore_level, int route, int wide_counts, int group,
                        int sms, void* gcnt, void* gsums, void* ghist, void* props, void* counts, void* stream) {
    const int n_items = n_crops * n_ch;
    if (n_items == 0 || n_off == 0) return 0;
    const auto st = static_cast<cudaStream_t>(stream);
    const auto* chs = static_cast<const int*>(channels);
    auto* pr = static_cast<double*>(props);
    auto* cn = static_cast<uint32_t*>(counts);
    if (route == 0) {
        if (wide || wide_counts || levels > kTree) return cudaErrorInvalidValue;
        const bool fast = levels == kTree && !symmetric && (ignore_level < 0 || ignore_level >= levels);
        const auto kernel = fast ? glcm_shared_kernel<true> : glcm_shared_kernel<false>;
        const int cells = levels * levels;
        size_t smem = static_cast<size_t>(((cells + 1) / 2 + 3) & ~3) * 4 + kTree * 4 + kWarps * kMoments * 4 +
                      ((static_cast<size_t>(h) * ((w + 3) & ~3) + 8 + 15) & ~static_cast<size_t>(15));
        // the crop's raw bytes in shared memory, the next crop's in registers, where they fit
        const long long nvec = (15 + static_cast<long long>(h) * w * pix_stride + 15) / 16;
        const int prefetch = static_cast<int>((nvec + kSharedThreads - 1) / kSharedThreads);
        int dev = 0, optin = 0;
        cudaError_t err = cudaGetDevice(&dev);
        if (err == cudaSuccess) err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
        if (err != cudaSuccess) return err;
        const bool ahead = prefetch <= 4 && smem + nvec * 16 + 1024 <= static_cast<size_t>(optin);
        if (ahead) smem += nvec * 16;
        err = sqt_allow_smem(kernel, smem);
        int per_sm = 0;
        if (err == cudaSuccess)
            err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kSharedThreads, smem);
        if (err != cudaSuccess) return err;
        const int grid = std::min(n_crops, std::max(1, per_sm) * sms);
        auto* mom = static_cast<uint32_t*>(gsums);
        auto* dh = static_cast<uint16_t*>(ghist);
        const auto* im = static_cast<const uint8_t*>(img);
        kernel<<<grid, kSharedThreads, smem, st>>>(im, im + static_cast<long long>(n_crops) * crop_stride, n_crops,
                                                   n_ch, chs, h, w, crop_stride, pix_stride,
                                                   static_cast<const Offset*>(offsets), n_off, levels, symmetric,
                                                   ignore_level, ahead ? prefetch : 0, mom, dh, cn);
        if (!cn) {
            const long long n = static_cast<long long>(n_items) * n_off;
            glcm_props_kernel<<<static_cast<unsigned>((n + 7) / 8), 256, 0, st>>>(n, levels, symmetric, mom, dh, pr);
        }
        return cudaGetLastError();
    }
    const auto* hoffs = static_cast<const int*>(host_offsets);
    auto* gs = static_cast<unsigned long long*>(gsums);
    auto* gh = static_cast<unsigned long long*>(ghist);
    if (wide)
        return glcm_global_any(static_cast<const int32_t*>(img), wide_counts, n_items, n_ch, chs, h, w, crop_stride,
                               pix_stride, hoffs, n_off, levels, symmetric, ignore_level, group, sms, gcnt, gs, gh, pr,
                               counts, st);
    return glcm_global_any(static_cast<const uint8_t*>(img), wide_counts, n_items, n_ch, chs, h, w, crop_stride,
                           pix_stride, hoffs, n_off, levels, symmetric, ignore_level, group, sms, gcnt, gs, gh, pr,
                           counts, st);
}
