// K4: keyed index-cipher shuffles, one thread per (position i, permutation p).
//
// Replaces the XLA code of squidpy_tpu/_core/index_cipher.py `_encrypt`,
// `_walked` and `_labels_from_positions` (lines 75-127): an 8-round
// alternating Feistel cipher on the mixed-radix domain Z_a x Z_b with a
// murmur3 finalizer as round function, cycle-walked into [0, n), then mapped
// to a class label by counting the class boundaries <= the position.
//
// Bound on the card: integer ALU. Each thread runs R rounds of two 32-bit
// modulo operations plus the mixer (~10 instructions each), an expected
// 1 + O(1/b) cycle-walk passes, and a binary search over the C-1 boundaries;
// it writes one byte (labels) or four (positions). There is no input traffic
// beyond the (R, P) round keys, which stay in L1/L2.
//
// Design: the JAX code walks the whole (n, P) slab until every lane is in
// range, but `where(t >= n, encrypt(t), t)` leaves finished lanes alone, so
// each lane's result equals a per-thread `while (y >= n) y = encrypt(y)`.
// All arithmetic is native uint32 with the same wrap-around as jnp.uint32,
// so the output is bitwise equal. Threads are laid out with p fastest, so the
// stores of a warp are contiguous in the (n, P) column layout K3 reads.

#include "common.cuh"

namespace {

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
    x ^= x >> 16;
    x *= 0x7FEB352Du;
    x ^= x >> 15;
    x *= 0x846CA68Bu;
    return x ^ (x >> 16);
}

__device__ __forceinline__ uint32_t encrypt(uint32_t y, const uint32_t* __restrict__ rk, int rounds, int n_cols,
                                            int p, uint32_t a, uint32_t b) {
    uint32_t u = y % a;
    uint32_t v = y / a;
    for (int r = 0; r < rounds; ++r) {
        const uint32_t k = __ldg(rk + static_cast<size_t>(r) * n_cols + p);
        if ((r & 1) == 0) {
            u = (u + mix32(v ^ k) % a) % a;
        } else {
            v = (v + mix32(u ^ k) % b) % b;
        }
    }
    return v * a + u;
}

// kind 0: uint8 labels, kind 1: int32 labels, kind 2: int32 positions.
template <typename OutT, bool kLabels>
__global__ void cipher_kernel(const uint32_t* __restrict__ rk, int rounds, int n_cols, uint32_t n, uint32_t a,
                              uint32_t b, const int32_t* __restrict__ edges, int n_edges, OutT* __restrict__ out) {
    const size_t t = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (t >= static_cast<size_t>(n) * n_cols) return;
    const uint32_t i = static_cast<uint32_t>(t / n_cols);
    const int p = static_cast<int>(t - static_cast<size_t>(i) * n_cols);
    uint32_t y = encrypt(i, rk, rounds, n_cols, p, a, b);
    while (y >= n) y = encrypt(y, rk, rounds, n_cols, p, a, b);
    if (kLabels) {
        // label = #{boundaries <= y}; boundaries ascend (cumulative counts)
        int lo = 0, hi = n_edges;
        while (lo < hi) {
            const int mid = (lo + hi) >> 1;
            if (static_cast<uint32_t>(__ldg(edges + mid)) <= y) lo = mid + 1; else hi = mid;
        }
        out[t] = static_cast<OutT>(lo);
    } else {
        out[t] = static_cast<OutT>(y);
    }
}

}  // namespace

SQT_EXPORT int sqt_index_cipher(const uint32_t* round_keys, int rounds, int n_cols, int64_t n, uint32_t a, uint32_t b,
                                const int32_t* edges, int n_edges, void* out, int kind, void* stream) {
    const size_t total = static_cast<size_t>(n) * n_cols;
    if (total == 0) return 0;
    const int threads = 256;
    const unsigned blocks = static_cast<unsigned>((total + threads - 1) / threads);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const uint32_t nu = static_cast<uint32_t>(n);
    if (kind == 0) {
        cipher_kernel<uint8_t, true><<<blocks, threads, 0, s>>>(round_keys, rounds, n_cols, nu, a, b, edges, n_edges,
                                                                static_cast<uint8_t*>(out));
    } else if (kind == 1) {
        cipher_kernel<int32_t, true><<<blocks, threads, 0, s>>>(round_keys, rounds, n_cols, nu, a, b, edges, n_edges,
                                                                static_cast<int32_t*>(out));
    } else if (kind == 2) {
        cipher_kernel<int32_t, false><<<blocks, threads, 0, s>>>(round_keys, rounds, n_cols, nu, a, b, edges,
                                                                 n_edges, static_cast<int32_t*>(out));
    } else {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
}

SQT_EXPORT const char* sqt_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
