// K10: threefry-2x32 words on the card, one row of n words a key.
//
// Replaces the device `jax.random.bits` that squidpy_tpu/_core/rng.py
// `permutation_batch` (lines 38-40, through `jax.random.permutation`) and
// `permutation_columns` (line 66) draw their sort words from: XLA's
// threefry2x32 with `jax_threefry_partitionable` on. Word i of key
// (k1, k2) is b1 ^ b2 of threefry2x32((k1, k2), (hi(i), lo(i))), the
// 64-bit iota split into two 32-bit counter words, exactly as the port's
// numpy `random_bits` computes it (squidpy_torch/_core/rng.py).
//
// Bound on the card: integer ALU. A word costs the key schedule's two
// adds, 20 rounds of (add, rotate, xor), five key injections of three adds,
// and the final xor: ~90 32-bit operations (a rotate is one funnel shift),
// against 4 bytes written. At the main path's 2 rounds x 1000 keys x 1M
// words that is ~1.8e11 operations, ~2.7 ms at the float32 issue rate, over
// the 8 GB written at ~2.4 ms.
//
// Design: one thread a word, the row's key read once into registers by
// every thread of the block (a block never straddles two rows: grid.y walks
// the keys, grid.x the words). The rounds are fully unrolled with constant
// rotations. With `flip` the thread writes w ^ 0x80000000 as an int32: a
// signed sort of those orders rows exactly as an unsigned sort of the words,
// ties included, so `torch.sort` reads 4-byte keys in place of the int64
// the words would need in torch.

#include "common.cuh"

namespace {

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) { return __funnelshift_l(x, x, r); }

template <int R0, int R1, int R2, int R3>
__device__ __forceinline__ void four_rounds(uint32_t& x0, uint32_t& x1) {
    x0 += x1; x1 = rotl(x1, R0) ^ x0;
    x0 += x1; x1 = rotl(x1, R1) ^ x0;
    x0 += x1; x1 = rotl(x1, R2) ^ x0;
    x0 += x1; x1 = rotl(x1, R3) ^ x0;
}

__device__ __forceinline__ uint32_t threefry_word(uint32_t k1, uint32_t k2, uint32_t hi, uint32_t lo) {
    const uint32_t k3 = k1 ^ k2 ^ 0x1BD11BDAu;
    uint32_t x0 = hi + k1, x1 = lo + k2;
    four_rounds<13, 15, 26, 6>(x0, x1);
    x0 += k2; x1 += k3 + 1u;
    four_rounds<17, 29, 16, 24>(x0, x1);
    x0 += k3; x1 += k1 + 2u;
    four_rounds<13, 15, 26, 6>(x0, x1);
    x0 += k1; x1 += k2 + 3u;
    four_rounds<17, 29, 16, 24>(x0, x1);
    x0 += k2; x1 += k3 + 4u;
    four_rounds<13, 15, 26, 6>(x0, x1);
    x0 += k3; x1 += k1 + 5u;
    return x0 ^ x1;
}

__global__ void __launch_bounds__(256) threefry_kernel(const uint32_t* __restrict__ keys, int64_t n_keys, int64_t n,
                                                      uint32_t flip, uint32_t* __restrict__ out) {
    const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const uint32_t hi = static_cast<uint32_t>(static_cast<uint64_t>(i) >> 32);
    const uint32_t lo = static_cast<uint32_t>(i);
    for (int64_t p = blockIdx.y; p < n_keys; p += gridDim.y) {
        const uint32_t k1 = __ldg(keys + 2 * p), k2 = __ldg(keys + 2 * p + 1);
        out[p * n + i] = threefry_word(k1, k2, hi, lo) ^ flip;
    }
}

}  // namespace

// `keys`: (n_keys, 2) uint32; `out`: (n_keys, n) 32-bit words, each
// xor-ed with 0x80000000 when `flip` is set.
SQT_EXPORT int sqt_threefry_bits(const uint32_t* keys, int64_t n_keys, int64_t n, int flip, void* out,
                                 void* stream) {
    if (n_keys == 0 || n == 0) return 0;
    const int64_t blocks = (n + 255) / 256;
    if (blocks > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(n_keys < 65535 ? n_keys : 65535));
    threefry_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(keys, n_keys, n, flip ? 0x80000000u : 0u,
                                                                         static_cast<uint32_t*>(out));
    return static_cast<int>(cudaGetLastError());
}
