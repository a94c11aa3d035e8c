// K4: keyed index-cipher shuffles of (n, P) positions i and permutations p.
//
// Replaces the XLA code of squidpy_tpu/_core/index_cipher.py `_encrypt`,
// `_walked` and `_labels_from_positions` (lines 75-127): an 8-round
// alternating Feistel cipher on the mixed-radix domain Z_a x Z_b with a
// murmur3 finalizer as round function, cycle-walked into [0, n), then mapped
// to a class label by counting the class boundaries <= the position.
//
// Bound on the card: integer ALU. Each thread runs R rounds of the mixer
// (~10 instructions) and one reduction, an expected 1 + O(1/b) cycle-walk
// passes, and a search over the C-1 boundaries; it writes one byte (labels)
// or four (positions). There is no input traffic beyond the (R, P) round keys
// and the boundaries.
//
// Design: the JAX code walks the whole (n, P) slab until every lane is in
// range, but `where(t >= n, encrypt(t), t)` leaves finished lanes alone, so
// each lane's result equals a per-thread `while (y >= n) y = encrypt(y)`.
// Hopper has no integer divide: a runtime `%` or `/` is a sequence of ~20
// instructions, and a pass has ~18 of them. Here none is left. `(u + t) % a`
// with u, t < a is one conditional subtraction (a, b <= 65,536, so the sum
// cannot wrap), and `x % d`, `x / d` of a 32-bit x take the exact
// multiply-high quotient of Lemire, Kaser and Kurz (2019), `q = (M * x) >> 64`
// with `M = ceil(2^64 / d)` from the host, in two 32 x 32 -> 64 multiplies
// (d = 1, whose M wraps to 0, gives q = x; only n <= 2 has a radix 1, and
// only its instance tests for it). Measured on an H100 at the
// main path's chunk (1M x 500 labels), that alone took 7.6 ms to 7.0: the
// division sequences run largely on the float pipe, beside the integer ALU
// that bounds the rest. So with the default 8 rounds the round loop is
// unrolled, each thread loads its 8 keys once and folds the mixer's first
// shift of the key into them (mix32(x ^ k) starts
// x ^ (x >> 16) ^ (k ^ (k >> 16))), and the keys serve every cycle-walk pass
// and every row the thread takes. A binary search over boundaries read
// through L1 cost ~0.9 ms of 5.4: the block stages them in shared memory,
// padded with all-ones to 2^m - 1 entries, and each thread takes m
// branch-free steps. All arithmetic is uint32 with jnp.uint32's
// wrap-around, so every output is bitwise equal. A block is pw columns x
// (256 / pw) rows (pw a power of two that leaves few lanes idle), so a warp's
// stores are contiguous in the (n, P) column layout K3 reads and no thread
// divides its flat index; about 4 waves of blocks stride over the rows. The
// main path's chunk then takes ~4.5 ms.

#include "common.cuh"

namespace {

struct FastDiv {
    uint32_t d, m_lo, m_hi;  // divisor and the two halves of ceil(2^64 / d) mod 2^64
};

template <bool kUnit>
__device__ __forceinline__ uint32_t quot(uint32_t x, FastDiv f) {
    // high 64 bits of the 96-bit M * x, in two wide multiplies
    const uint64_t lo = static_cast<uint64_t>(f.m_lo) * x;
    const uint64_t hi = static_cast<uint64_t>(f.m_hi) * x + (lo >> 32);
    const uint32_t q = static_cast<uint32_t>(hi >> 32);
    return (kUnit && f.d == 1u) ? x : q;
}

template <bool kUnit>
__device__ __forceinline__ uint32_t rem(uint32_t x, FastDiv f) { return x - quot<kUnit>(x, f) * f.d; }

// (u + t) mod d for u, t < d <= 2^16
__device__ __forceinline__ uint32_t add_mod(uint32_t u, uint32_t t, uint32_t d) {
    const uint32_t s = u + t;
    return s >= d ? s - d : s;
}

// mix32(x ^ k), the murmur3 finalizer, given kk = k ^ (k >> 16)
__device__ __forceinline__ uint32_t mix_keyed(uint32_t x, uint32_t kk) {
    x = x ^ (x >> 16) ^ kk;
    x *= 0x7FEB352Du;
    x ^= x >> 15;
    x *= 0x846CA68Bu;
    return x ^ (x >> 16);
}

__device__ __forceinline__ uint32_t key_fold(uint32_t k) { return k ^ (k >> 16); }

// kRounds > 0: that many rounds, unrolled, keys folded in registers;
// 0: `rounds` rounds, keys read each pass
template <int kRounds, bool kUnit>
__device__ __forceinline__ uint32_t encrypt(uint32_t y, const uint32_t (&kk)[kRounds > 0 ? kRounds : 1],
                                            const uint32_t* __restrict__ rk, int rounds, int n_cols, int p,
                                            FastDiv fa, FastDiv fb) {
    uint32_t v = quot<kUnit>(y, fa);
    uint32_t u = y - v * fa.d;
    if constexpr (kRounds > 0) {
#pragma unroll
        for (int r = 0; r < kRounds; ++r) {
            if ((r & 1) == 0) u = add_mod(u, rem<kUnit>(mix_keyed(v, kk[r]), fa), fa.d);
            else v = add_mod(v, rem<kUnit>(mix_keyed(u, kk[r]), fb), fb.d);
        }
    } else {
        for (int r = 0; r < rounds; ++r) {
            const uint32_t k = key_fold(__ldg(rk + static_cast<size_t>(r) * n_cols + p));
            if ((r & 1) == 0) u = add_mod(u, rem<kUnit>(mix_keyed(v, k), fa), fa.d);
            else v = add_mod(v, rem<kUnit>(mix_keyed(u, k), fb), fb.d);
        }
    }
    return v * fa.d + u;
}

// kLabels: uint8 or int32 class labels, else int32 positions. Dynamic shared
// memory: the `pad` - 1 boundaries (all-ones past n_edges), labels only. The
// grid strides over rows, so a block stages the boundaries once and a thread
// loads its column's keys once for many rows.
template <typename OutT, bool kLabels, int kRounds, bool kUnit>
__global__ void __launch_bounds__(256) cipher_kernel(const uint32_t* __restrict__ rk, int rounds, int n_cols,
                                                     uint32_t n, FastDiv fa, FastDiv fb,
                                                     const int32_t* __restrict__ edges, int n_edges, int pad,
                                                     OutT* __restrict__ out) {
    extern __shared__ uint32_t bounds[];
    if constexpr (kLabels) {
        const int tid = threadIdx.y * blockDim.x + threadIdx.x;
        for (int e = tid; e < pad; e += 256) bounds[e] = e < n_edges ? static_cast<uint32_t>(__ldg(edges + e)) : ~0u;
        __syncthreads();
    }
    const int p = blockIdx.y * blockDim.x + threadIdx.x;
    if (p >= n_cols) return;
    uint32_t kk[kRounds > 0 ? kRounds : 1];
    if constexpr (kRounds > 0) {
#pragma unroll
        for (int r = 0; r < kRounds; ++r) kk[r] = key_fold(__ldg(rk + static_cast<size_t>(r) * n_cols + p));
    }
    const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.y;
    for (size_t row = static_cast<size_t>(blockIdx.x) * blockDim.y + threadIdx.y; row < n; row += stride) {
        const uint32_t i = static_cast<uint32_t>(row);
        uint32_t y = encrypt<kRounds, kUnit>(i, kk, rk, rounds, n_cols, p, fa, fb);
        while (y >= n) y = encrypt<kRounds, kUnit>(y, kk, rk, rounds, n_cols, p, fa, fb);
        const size_t t = row * n_cols + p;
        if constexpr (kLabels) {
            // label = #{boundaries <= y}; boundaries ascend (cumulative
            // counts), and the all-ones padding is above every y < n < 2^32
            int lo = 0;
            for (int step = pad >> 1; step > 0; step >>= 1)
                if (bounds[lo + step - 1] <= y) lo += step;
            out[t] = static_cast<OutT>(lo);
        } else {
            out[t] = static_cast<OutT>(y);
        }
    }
}

FastDiv fast_div(uint32_t d, uint64_t m) {
    return FastDiv{d, static_cast<uint32_t>(m), static_cast<uint32_t>(m >> 32)};
}

template <typename OutT, bool kLabels, int kRounds, bool kUnit>
int launch(dim3 grid, dim3 block, size_t smem, cudaStream_t s, const uint32_t* rk, int rounds, int n_cols, uint32_t n,
           FastDiv fa, FastDiv fb, const int32_t* edges, int n_edges, int pad, void* out) {
    auto kernel = cipher_kernel<OutT, kLabels, kRounds, kUnit>;
    cudaError_t err = sqt_allow_smem(kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<grid, block, smem, s>>>(rk, rounds, n_cols, n, fa, fb, edges, n_edges, pad, static_cast<OutT*>(out));
    return static_cast<int>(cudaGetLastError());
}

template <typename OutT, bool kLabels>
int launch_rounds(dim3 grid, dim3 block, size_t smem, cudaStream_t s, const uint32_t* rk, int rounds, int n_cols,
                  uint32_t n, FastDiv fa, FastDiv fb, const int32_t* edges, int n_edges, int pad, void* out) {
    const bool unit = fa.d == 1u || fb.d == 1u;
    if (rounds == 8 && !unit)
        return launch<OutT, kLabels, 8, false>(grid, block, smem, s, rk, rounds, n_cols, n, fa, fb, edges, n_edges,
                                               pad, out);
    if (rounds == 8)
        return launch<OutT, kLabels, 8, true>(grid, block, smem, s, rk, rounds, n_cols, n, fa, fb, edges, n_edges,
                                              pad, out);
    if (!unit)
        return launch<OutT, kLabels, 0, false>(grid, block, smem, s, rk, rounds, n_cols, n, fa, fb, edges, n_edges,
                                               pad, out);
    return launch<OutT, kLabels, 0, true>(grid, block, smem, s, rk, rounds, n_cols, n, fa, fb, edges, n_edges, pad,
                                          out);
}

}  // namespace

// `ma`, `mb`: ceil(2^64 / a) and ceil(2^64 / b) mod 2^64; `pw`: columns a
// block (a power of two <= 32), so a block covers pw columns of 256 / pw
// rows at a time.
SQT_EXPORT int sqt_index_cipher(const uint32_t* round_keys, int rounds, int n_cols, int64_t n, uint32_t a, uint32_t b,
                                uint64_t ma, uint64_t mb, int pw, const int32_t* edges, int n_edges, void* out,
                                int kind, void* stream) {
    if (n == 0 || n_cols == 0) return 0;
    if (pw < 1 || pw > 32 || (pw & (pw - 1)) != 0) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 block(pw, 256 / pw);
    const unsigned col_blocks = static_cast<unsigned>((n_cols + pw - 1) / pw);
    if (col_blocks > 65535) return static_cast<int>(cudaErrorInvalidValue);
    // about 4 waves of 8 resident 256-thread blocks an SM, striding over rows
    int dev = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int64_t row_blocks = (n + block.y - 1) / block.y;
    const int64_t want = (32LL * sms + col_blocks - 1) / col_blocks;
    const dim3 grid(static_cast<unsigned>(row_blocks < want ? row_blocks : want), col_blocks);
    int pad = 1;  // a power of two > n_edges
    while (pad <= n_edges) pad <<= 1;
    const size_t smem = kind == 2 ? 0 : static_cast<size_t>(pad) * sizeof(uint32_t);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const uint32_t nu = static_cast<uint32_t>(n);
    const FastDiv fa = fast_div(a, ma), fb = fast_div(b, mb);
    if (kind == 0)
        return launch_rounds<uint8_t, true>(grid, block, smem, s, round_keys, rounds, n_cols, nu, fa, fb, edges,
                                            n_edges, pad, out);
    if (kind == 1)
        return launch_rounds<int32_t, true>(grid, block, smem, s, round_keys, rounds, n_cols, nu, fa, fb, edges,
                                            n_edges, pad, out);
    if (kind == 2)
        return launch_rounds<int32_t, false>(grid, block, smem, s, round_keys, rounds, n_cols, nu, fa, fb, edges,
                                             n_edges, pad, out);
    return static_cast<int>(cudaErrorInvalidValue);
}

SQT_EXPORT const char* sqt_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
