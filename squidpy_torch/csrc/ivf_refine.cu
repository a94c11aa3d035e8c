// K16: the IVF kNN's refine pass, one NN-descent step (squidpy_torch/ops/ivf_knn.py).
//
// Replaces squidpy_tpu/ops/ivf_knn.py `_refine_pass` (line 312): XLA code
// that, for each row tile, gathers each row's k neighbours and their k^2
// neighbours (k + k^2 candidates), sorts the ids to mask repeats, computes
// the candidates' difference-form d2, masks repeats, sentinels and the row
// itself, and keeps the k best by `top_k` (ties to the lower sorted
// position, so to the lower id).
//
// Here, for x (n, dp) float32 (dp a multiple of 4; zero columns add exactly
// +0) and idx (n, k) int32 (-1, or any id outside [0, n), for none), it
// writes each row's k nearest distinct candidates, ascending: distances
// (n, k) float32, sqrtf(d2) correctly rounded, and indices (n, k) int32. A
// candidate's key is (bits of d2) << 32 | id, d2 the difference form in axis
// order (__fsub_rn, __fmul_rn, __fadd_rn, --fmad=false; a NaN d2 takes the
// bits 0x7fc00000), so ties go to the lowest id as in the JAX package; a row
// with fewer than k distinct valid candidates ends with distance +inf and
// index -1 (the JAX package leaves those slots undefined: ROADMAP.md queue
// 3). The plain torch version (squidpy_torch/ops/ivf_knn.py `_refine_plain`)
// selects by the same keys, so both agree bit for bit.
//
// Bound on the card: 3 dp + 1 operations a distinct candidate other than
// the row (the function needs one d2 each), or the rows and lists read once
// and the outputs written once, whichever takes longer: at 1M rows of part g,
// k = 15, 27% of the 240 entries a row are such candidates at 16 features
// (0.073 ms, bytes) and 78% at 56 (0.47 ms on the card's 67e12/s). This
// design computes a d2 for every valid entry, repeats included, and its
// gathers move 240 rows a row (15 GB at 1M x 16).
//
// Design: a warp a row, four a block. The lanes gather the row's k + k^2
// candidates (a lane every 32nd), compute each valid one's key at once and
// store it in the warp's list in shared memory, padded with the no-key
// 0x7fffffffffffffff to P, the next power of two (at least 32): a repeated
// id gives the same key. A bitonic network sorts the P keys in shared memory
// (P / 64 compare-exchanges a lane a stage), and the lanes then take 32
// sorted positions at a time, each keeping its key if it differs from the
// one before, and write the kept keys' ranks below k by a ballot.

#include <cmath>

#include "common.cuh"
#include "knn_keys.cuh"

namespace {

constexpr int kWarps = 4;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kWarps * 32) refine_kernel(const float* __restrict__ x, int n, int dp,
                                                             const int* __restrict__ idx, int k, int exclude_self,
                                                             int P, float* __restrict__ out_d,
                                                             int* __restrict__ out_i) {
    extern __shared__ unsigned long long smem[];  // kWarps lists of P keys, then kWarps rows of dp floats
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int row = blockIdx.x * kWarps + warp;
    if (row >= n) return;  // the whole warp; the kernel syncs warps only
    unsigned long long* list = smem + static_cast<size_t>(warp) * P;
    float* xq = reinterpret_cast<float*>(smem + static_cast<size_t>(kWarps) * P) + static_cast<size_t>(warp) * dp;
    for (int e = lane; e < dp; e += 32) xq[e] = __ldg(x + static_cast<size_t>(row) * dp + e);
    __syncwarp();
    const int n_cand = k + k * k;
    const int* own = idx + static_cast<size_t>(row) * k;
    for (int p = lane; p < P; p += 32) {
        unsigned long long key = kEmptyKey;
        if (p < n_cand) {
            int cand;
            if (p < k) {
                cand = __ldg(own + p);
            } else {
                const int j = (p - k) / k;
                const int nb = __ldg(own + j);
                cand = nb >= 0 && nb < n ? __ldg(idx + static_cast<size_t>(nb) * k + (p - k - j * k)) : -1;
            }
            if (cand >= 0 && cand < n && !(exclude_self && cand == row)) {
                const float4* c4 = reinterpret_cast<const float4*>(x + static_cast<size_t>(cand) * dp);
                float d2 = 0.0f;
                for (int e = 0; e < dp / 4; ++e) {
                    const float4 v = __ldg(c4 + e);
                    d2 = add_sq(d2, xq[4 * e], v.x);
                    d2 = add_sq(d2, xq[4 * e + 1], v.y);
                    d2 = add_sq(d2, xq[4 * e + 2], v.z);
                    d2 = add_sq(d2, xq[4 * e + 3], v.w);
                }
                key = make_key(d2, cand);
            }
        }
        list[p] = key;
    }
    __syncwarp();
    for (int size = 2; size <= P; size <<= 1) {
        for (int stride = size >> 1; stride > 0; stride >>= 1) {
            for (int t = lane; t < P / 2; t += 32) {
                const int i = 2 * t - (t & (stride - 1));
                const int j = i + stride;
                const bool up = (i & size) == 0;
                const unsigned long long a = list[i], b = list[j];
                if ((a > b) == up) {
                    list[i] = b;
                    list[j] = a;
                }
            }
            __syncwarp();
        }
    }
    float* od = out_d + static_cast<size_t>(row) * k;
    int* oi = out_i + static_cast<size_t>(row) * k;
    int filled = 0;
    for (int base = 0; base < P && filled < k; base += 32) {
        const int p = base + lane;
        const unsigned long long key = list[p];
        const bool keep = key != kEmptyKey && (p == 0 || key != list[p - 1]);
        const unsigned mask = __ballot_sync(kFull, keep);
        const int pos = filled + __popc(mask & ((1u << lane) - 1u));
        if (keep && pos < k) {
            od[pos] = sqrtf(__uint_as_float(static_cast<unsigned>(key >> 32)));
            oi[pos] = static_cast<int>(key & 0xffffffffULL);
        }
        filled += __popc(mask);
    }
    for (int pos = filled + lane; pos < k; pos += 32) {
        od[pos] = INFINITY;
        oi[pos] = -1;
    }
}

}  // namespace

// x (n, dp) float32, dp a positive multiple of 4; idx (n, k) int32, the
// current lists; 1 <= k <= 32; out_d (n, k) float32 and out_i (n, k) int32.
SQT_EXPORT int sqt_ivf_refine(const float* x, int n, int dp, const int* idx, int k, int exclude_self, float* out_d,
                              int* out_i, void* stream) {
    if (n < 1 || dp < 4 || dp % 4 || k < 1 || k > 32) return static_cast<int>(cudaErrorInvalidValue);
    int P = 32;
    while (P < k + k * k) P <<= 1;
    const size_t smem = static_cast<size_t>(kWarps) * (static_cast<size_t>(P) * 8 + static_cast<size_t>(dp) * 4);
    cudaError_t err = sqt_allow_smem(refine_kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const unsigned blocks = static_cast<unsigned>((n + kWarps - 1) / kWarps);
    refine_kernel<<<blocks, kWarps * 32, smem, static_cast<cudaStream_t>(stream)>>>(x, n, dp, idx, k, exclude_self,
                                                                                   P, out_d, out_i);
    return static_cast<int>(cudaGetLastError());
}
