// Keys, distances and sorted key lists shared by the kNN kernels: K8
// (csrc/cross_knn.cu), K12 (csrc/feature_knn.cu) and K14-K16
// (csrc/ivf_kmeans.cu, ivf_search.cu, ivf_refine.cu).
//
// A candidate's key is (bits of d2) << 32 | index. A d2 is >= 0 or NaN (NaN
// takes the bits 0x7fc00000, after +inf), so keys order by d2, then by
// index: ties go to the lowest index. The feature-space kernels compute d2
// in the difference form, summed in axis order from +0, each operation
// rounded on its own (__fsub_rn, __fmul_rn, __fadd_rn; the library builds
// with --fmad=false), as their plain torch versions do.
#pragma once

#include <cmath>
#include <cuda_runtime.h>

constexpr unsigned kNanBits = 0x7fc00000u;
// an empty slot of K14-K16: above every real key, its index bits read as -1
constexpr unsigned long long kEmptyKey = 0x7fffffffffffffffULL;

__device__ __forceinline__ unsigned long long make_key(float d2, int j) {
    const unsigned bits = isnan(d2) ? kNanBits : __float_as_uint(d2);
    return (static_cast<unsigned long long>(bits) << 32) | static_cast<unsigned>(j);
}

__device__ __forceinline__ float add_sq(float d2, float a, float b) {
    const float diff = __fsub_rn(a, b);
    return __fadd_rn(d2, __fmul_rn(diff, diff));
}

// A sorted register list of the KC least keys (the first m of the best KC
// are the best m for m <= KC), filled with kEmptyKey.
template <int KC>
struct Best {
    unsigned long long key[KC];

    __device__ __forceinline__ void init() {
#pragma unroll
        for (int r = 0; r < KC; ++r) key[r] = kEmptyKey;
    }

    __device__ __forceinline__ void insert(unsigned long long k) {
        if (k < key[KC - 1]) {
            // new[r] = max(old[r - 1], min(old[r], k)): the sorted list with k in, its last out
#pragma unroll
            for (int r = KC - 1; r > 0; --r) {
                const unsigned long long lo = key[r] < k ? key[r] : k;
                key[r] = key[r - 1] > lo ? key[r - 1] : lo;
            }
            key[0] = key[0] < k ? key[0] : k;
        }
    }

    // key[r] for a runtime r, without spilling the list to local memory
    __device__ __forceinline__ unsigned long long get(int r) const {
        unsigned long long out = kEmptyKey;
#pragma unroll
        for (int s = 0; s < KC; ++s)
            if (s == r) out = key[s];
        return out;
    }
};

// A query row of DP > 0 features (DP a multiple of 4) into registers, zeros
// where !valid; nothing for DP = 0 (the row is read from the cache).
template <int DP>
__device__ __forceinline__ void load_row(const float4* __restrict__ row, bool valid, float* xq) {
    if constexpr (DP > 0) {
#pragma unroll
        for (int e = 0; e < DP / 4; ++e) {
            const float4 v = valid ? __ldg(row + e) : make_float4(0.f, 0.f, 0.f, 0.f);
            xq[4 * e] = v.x;
            xq[4 * e + 1] = v.y;
            xq[4 * e + 2] = v.z;
            xq[4 * e + 3] = v.w;
        }
    }
}

// The d2 of a query row against row p of a tile staged in shared memory
// (kV float4 a row): the query in registers xq (DP > 0), else read from
// xrow in the cache (DP = 0).
template <int DP>
__device__ __forceinline__ float staged_d2(const float4* tile, int p, int kV, const float* xq,
                                           const float4* __restrict__ xrow) {
    float d2 = 0.0f;
    if constexpr (DP > 0) {
#pragma unroll
        for (int e = 0; e < DP / 4; ++e) {
            const float4 v = tile[p * (DP / 4) + e];
            d2 = add_sq(d2, xq[4 * e], v.x);
            d2 = add_sq(d2, xq[4 * e + 1], v.y);
            d2 = add_sq(d2, xq[4 * e + 2], v.z);
            d2 = add_sq(d2, xq[4 * e + 3], v.w);
        }
    } else {
        for (int e = 0; e < kV; ++e) {
            const float4 a = __ldg(xrow + e);
            const float4 v = tile[p * kV + e];
            d2 = add_sq(d2, a.x, v.x);
            d2 = add_sq(d2, a.y, v.y);
            d2 = add_sq(d2, a.z, v.z);
            d2 = add_sq(d2, a.w, v.w);
        }
    }
    return d2;
}
