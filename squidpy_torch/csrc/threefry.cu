// K10: the keyed shuffles of the permutation tests on the card. threefry-2x32
// words, and the stable sort of each row by them, in one kernel family.
//
// Replaces `jax.random.permutation` under squidpy_tpu/_core/rng.py
// `permutation_batch` (lines 38-40) and the words plus `lax.sort_key_val` of
// `permutation_columns` (lines 66-67). JAX shuffles n items by
// ceil(3 ln n / ln(2^32 - 1)) rounds: each round splits the key, draws the
// subkey's words (XLA's threefry2x32 with `jax_threefry_partitionable` on:
// word i of key (k1, k2) is b1 ^ b2 of threefry2x32((k1, k2), (hi(i), lo(i))),
// the 64-bit iota split into two 32-bit counter words) and stably sorts the
// running array by them as uint32. A stable sort by word is a sort by the
// 64-bit key (word << 32) | i, where i is the item's position in THIS round's
// input (the cell for round 1, the round-1 output position for round 2), and
// those keys are all distinct: so the order in which atomics deliver items
// to a bucket changes nothing, and the result is JAX's, bit for bit. Inside
// a bucket the word's top `bits` bits are the bucket, so a key keeps only the
// rest: ((word << bits) << 32) | i, or, with a uint8 payload (the labels of
// ligrec) below 2^24 items, ((word << bits) << 32) | (i << 8) | value, the
// value riding through the sort in the key's low byte.
//
// Bound on the card: integer ALU. A word costs ~90 32-bit operations (the
// key schedule, 20 rounds of add, rotate, xor, five key injections of three
// adds, the final xor; a rotate is one funnel shift); a round draws one word
// an item. The shuffle writes its output once (int32 indices, or the payload:
// uint8 labels for ligrec). This design draws each word twice (histogram and
// scatter: storing the words in between measured no faster on the H100) and
// moves a key (8 bytes, written and read) an item a round through memory;
// chip_smoke.py's `[diag] shuffle` line states both floors.
//
// Design, one round = four entry points on the current stream, no host sync:
// (a) `sqt_shuffle_hist`: a block takes 4096 items of one row, computes their
//     words in registers and counts their top `bits` bits (2^bits buckets,
//     the wrapper picks bits so a bucket holds ~2048 items on average) in
//     shared memory, then adds its counts to the row's histogram (one
//     global atomic a bucket a block).
// (b) `sqt_shuffle_scan`: a block a row scans its buckets: offsets, cursors,
//     the list of buckets past the local sort's capacity, the largest bucket.
// (c) `sqt_shuffle_scatter`: the words again; each block counts its 4096
//     items a bucket in shared memory, places their keys there in bucket
//     order (reading the uint8 values, if any, in item order), claims one
//     slot range a bucket with one global atomic, and writes each bucket's
//     run as one coalesced store. Rows never share cursors.
// (d) `sqt_shuffle_sort`: a block a bucket (up to `cap` <= 4096 keys) counts
//     the keys into 2048 sub-buckets by the next 11 bits of the word in
//     shared memory (4096 measured 10% slower: more to clear and scan),
//     scans, places each key (the keys read twice from L2, so four
//     512-thread blocks fit an SM), and one thread insertion-sorts each run
//     of 4 sub-buckets (~4 keys); the epilogue writes out[off + j]: the
//     key's uint8 value, or prev[pos] (the previous round's output: one
//     gather a round, so a payload rides through the rounds) or, in the
//     first round, payload[pos] or pos.
//     (e) A bucket past `cap` is sorted by a second kernel of the same entry,
//     one block a bucket, by a bitonic network (the form that compares each
//     element with its mirror, so that the virtual +inf past the bucket never
//     moves) in global memory, correct at any size; its blocks read the
//     overflow list on the card and exit at once when it is empty.
// The grouped entry (K10g, `sqt_shuffle_g*`, kernels of its own below)
// sorts each group's segment of a row by word for the shuffles within groups
// (squidpy_tpu/_core/rng.py `shuffle_group_columns`, the (group, word)
// `lax.sort` of line 98), with 4-byte keys and a stable scatter; its design
// is set out above its kernels.
// The plain torch version (squidpy_torch/_core/rng.py) draws the words with
// `_threefry_plain` and sorts them with `torch.sort(stable=True)`.

#include <type_traits>

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

__device__ __forceinline__ uint32_t word_at(uint32_t k1, uint32_t k2, int64_t i) {
    return threefry_word(k1, k2, static_cast<uint32_t>(static_cast<uint64_t>(i) >> 32), static_cast<uint32_t>(i));
}

// The words alone (one thread a word), each xor-ed with `flip`: a signed
// sort of words xor-ed with 0x80000000 orders a row as an unsigned sort.
__global__ void __launch_bounds__(256) threefry_kernel(const uint32_t* __restrict__ keys, int64_t n_keys, int64_t n,
                                                      uint32_t flip, uint32_t* __restrict__ out) {
    const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (i >= n) return;
    for (int64_t p = blockIdx.y; p < n_keys; p += gridDim.y) {
        const uint32_t k1 = __ldg(keys + 2 * p), k2 = __ldg(keys + 2 * p + 1);
        out[p * n + i] = word_at(k1, k2, i) ^ flip;
    }
}

constexpr int kTileThreads = 512;
constexpr int kTileItems = 8;
constexpr int kTile = kTileThreads * kTileItems;  // items of one row a block in (a) and (c)
constexpr int kMaxBits = 13;
constexpr int kSortThreads = 512;
constexpr int kSortItems = 8;
constexpr int kCap = kSortThreads * kSortItems;  // keys of one bucket in shared memory
constexpr int kSubBits = 11;
constexpr int kSubs = 1 << kSubBits;
constexpr int kSubsPerThread = kSubs / kSortThreads;
constexpr int kOverflowThreads = 1024;
constexpr int kOverflowBlocks = 264;
constexpr int kRowsPerGrid = 65535;

__device__ __forceinline__ uint32_t bucket_of(uint32_t w, int bits) { return bits == 0 ? 0u : w >> (32 - bits); }

// (a) histogram of the top `bits` bits of each row's words, a block a
// tile of 4096 items of one row.
__global__ void __launch_bounds__(kTileThreads) hist_kernel(const uint32_t* __restrict__ keys, int64_t rows,
                                                           int64_t n, uint32_t mask, int bits,
                                                           int32_t* __restrict__ hist) {
    extern __shared__ int32_t s_cnt[];
    const int nb = 1 << bits;
    const int64_t i0 = static_cast<int64_t>(blockIdx.x) * kTile;
    for (int64_t row = blockIdx.y; row < rows; row += gridDim.y) {
        for (int b = threadIdx.x; b < nb; b += kTileThreads) s_cnt[b] = 0;
        __syncthreads();
        const uint32_t k1 = __ldg(keys + 2 * row), k2 = __ldg(keys + 2 * row + 1);
#pragma unroll 4
        for (int k = 0; k < kTileItems; ++k) {
            const int64_t i = i0 + k * kTileThreads + threadIdx.x;
            if (i < n) atomicAdd(&s_cnt[bucket_of(word_at(k1, k2, i) & mask, bits)], 1);
        }
        __syncthreads();
        int32_t* h = hist + row * nb;
        for (int b = threadIdx.x; b < nb; b += kTileThreads) {
            const int32_t c = s_cnt[b];
            if (c) atomicAdd(h + b, c);
        }
        __syncthreads();
    }
}

// Exclusive scan of `v` over the block (blockDim.x threads, a multiple of
// 32); `s_warp` holds 32 ints. Returns the sum of the lower threads' values.
__device__ __forceinline__ int32_t block_exclusive_scan(int32_t v, int32_t* s_warp) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
    int32_t incl = v;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const int32_t u = __shfl_up_sync(0xFFFFFFFFu, incl, d);
        if (lane >= d) incl += u;
    }
    if (lane == 31) s_warp[warp] = incl;
    __syncthreads();
    if (warp == 0) {
        int32_t w = lane < warps ? s_warp[lane] : 0;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            const int32_t u = __shfl_up_sync(0xFFFFFFFFu, w, d);
            if (lane >= d) w += u;
        }
        if (lane < warps) s_warp[lane] = w;
    }
    __syncthreads();
    const int32_t out = incl - v + (warp ? s_warp[warp - 1] : 0);
    __syncthreads();  // s_warp is free again
    return out;
}

// (b) a block a row: offsets (nb + 1 a row, the last n), the counts replaced
// by the cursors the scatter claims slots from, the overflow list (row * nb
// + bucket of every bucket past `cap`) and stats[0] its length, stats[1] the
// largest bucket.
__global__ void __launch_bounds__(1024) scan_kernel(int64_t rows, int64_t n, int nb, int cap,
                                                   int32_t* __restrict__ hist, int32_t* __restrict__ offs,
                                                   int32_t* __restrict__ overflow, int32_t* __restrict__ stats) {
    __shared__ int32_t s_warp[32];
    const int per = (nb + 1023) / 1024;
    const int b0 = threadIdx.x * per;
    for (int64_t row = blockIdx.x; row < rows; row += gridDim.x) {
        int32_t* h = hist + row * nb;
        int32_t* o = offs + row * (nb + 1);
        int32_t local = 0;
        for (int j = 0; j < per; ++j)
            if (b0 + j < nb) local += h[b0 + j];
        int32_t run = block_exclusive_scan(local, s_warp);
        int32_t largest = 0;
        for (int j = 0; j < per; ++j) {
            const int b = b0 + j;
            if (b >= nb) break;
            const int32_t c = h[b];
            o[b] = run;
            h[b] = run;
            if (c > cap) overflow[atomicAdd(stats, 1)] = static_cast<int32_t>(row * nb + b);
            largest = c > largest ? c : largest;
            run += c;
        }
        largest = __reduce_max_sync(0xFFFFFFFFu, largest);
        if ((threadIdx.x & 31) == 0 && largest) atomicMax(stats + 1, largest);
        if (threadIdx.x == 0) o[nb] = static_cast<int32_t>(n);
        __syncthreads();
    }
}

// (c) each item's key (word << 32) | i at a slot of its bucket: the tile's
// keys are first placed in shared memory in bucket order (a counting sort of
// the tile), each bucket claims one slot range with one global atomic, and
// consecutive threads then write consecutive keys, so a bucket's run of the
// tile (~8 keys at 512 buckets) leaves as one coalesced store.
__global__ void __launch_bounds__(kTileThreads) scatter_kernel(const uint32_t* __restrict__ keys, int64_t rows,
                                                              int64_t n, uint32_t mask, int bits,
                                                              const uint8_t* __restrict__ vals, int64_t vals_ld,
                                                              int32_t* __restrict__ cursor,
                                                              uint64_t* __restrict__ tmp) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int nb = 1 << bits;
    uint64_t* s_keys = reinterpret_cast<uint64_t*>(smem_raw);
    int32_t* s_cnt = reinterpret_cast<int32_t*>(s_keys + kTile);  // counts, then the tile's starts
    int32_t* s_base = s_cnt + nb;  // a bucket's slot in the row minus its start in the tile
    int32_t* s_warp = s_base + nb;
    uint16_t* s_bucket = reinterpret_cast<uint16_t*>(s_warp + 32);  // the bucket of each placed key
    const int64_t i0 = static_cast<int64_t>(blockIdx.x) * kTile;
    const int count = static_cast<int>(n - i0 < kTile ? n - i0 : kTile);
    const int per = (nb + kTileThreads - 1) / kTileThreads;
    const int b0 = threadIdx.x * per;
    for (int64_t row = blockIdx.y; row < rows; row += gridDim.y) {
        for (int b = threadIdx.x; b < nb; b += kTileThreads) s_cnt[b] = 0;
        __syncthreads();
        const uint32_t k1 = __ldg(keys + 2 * row), k2 = __ldg(keys + 2 * row + 1);
        const uint8_t* v = vals ? vals + row * vals_ld : nullptr;
        uint32_t w[kTileItems];
        int32_t rank[kTileItems];  // the rank in the bucket, and the value from bit 16
#pragma unroll
        for (int k = 0; k < kTileItems; ++k) {
            const int64_t i = i0 + k * kTileThreads + threadIdx.x;
            if (i < n) {
                const int32_t value = v ? static_cast<int32_t>(__ldg(v + i)) << 16 : 0;
                w[k] = word_at(k1, k2, i) & mask;
                rank[k] = value | atomicAdd(&s_cnt[bucket_of(w[k], bits)], 1);
            }
        }
        __syncthreads();
        int32_t local = 0;
        for (int j = 0; j < per; ++j)
            if (b0 + j < nb) local += s_cnt[b0 + j];
        int32_t run = block_exclusive_scan(local, s_warp);
        int32_t* cur = cursor + row * nb;
        for (int j = 0; j < per; ++j) {
            const int b = b0 + j;
            if (b >= nb) break;
            const int32_t c = s_cnt[b];
            s_cnt[b] = run;
            if (c) s_base[b] = atomicAdd(cur + b, c) - run;
            run += c;
        }
        __syncthreads();
#pragma unroll
        for (int k = 0; k < kTileItems; ++k) {
            const int64_t i = i0 + k * kTileThreads + threadIdx.x;
            if (i < n) {
                const uint32_t b = bucket_of(w[k], bits);
                const int at = s_cnt[b] + (rank[k] & 0xFFFF);
                const uint64_t low = v ? (static_cast<uint64_t>(i) << 8) | static_cast<uint32_t>(rank[k] >> 16)
                                       : static_cast<uint64_t>(i);
                s_keys[at] = (static_cast<uint64_t>(w[k] << bits) << 32) | low;
                s_bucket[at] = static_cast<uint16_t>(b);
            }
        }
        __syncthreads();
        uint64_t* t = tmp + row * n;
        for (int j = threadIdx.x; j < count; j += kTileThreads) t[s_base[s_bucket[j]] + j] = s_keys[j];
        __syncthreads();
    }
}

// The epilogue modes: the int32 position (or, in a later round, the
// previous round's output at it); a payload of P at the position (or the
// previous round's output at it); a uint8 value packed into the key's low
// byte by the scatter (no gather at all).
constexpr int kIndex = 0, kGather = 1, kPacked = 2;

// The epilogue of one sorted key: position pos of this round's input goes to
// out[at]. Its value is the previous round's output at pos (one gather a
// round, so a payload rides through the rounds), or in the first round the
// payload at pos, or pos itself; or the packed value.
template <typename P, int kMode>
__device__ __forceinline__ void emit(uint64_t key, int64_t row, const P* __restrict__ prev, int64_t prev_ld,
                                     const P* __restrict__ payload, P* __restrict__ out, int64_t at) {
    if constexpr (kMode == kPacked) {
        out[at] = static_cast<P>(key & 0xFFu);
    } else {
        const uint32_t pos = static_cast<uint32_t>(key);
        if (prev)
            out[at] = __ldg(prev + row * prev_ld + pos);
        else if constexpr (kMode == kGather)
            out[at] = __ldg(payload + pos);
        else
            out[at] = static_cast<P>(pos);
    }
}

// (d) a block a bucket of at most `cap` keys: a counting sort by the next
// 11 bits of the word into shared memory (the keys read twice from L2, so a
// thread holds no key and four blocks fit an SM), an insertion sort of each
// thread's run of 4 sub-buckets, the epilogue.
template <typename P, int kMode>
__global__ void __launch_bounds__(kSortThreads, 4) sort_kernel(const uint64_t* __restrict__ tmp,
                                                             const int32_t* __restrict__ offs, int64_t rows,
                                                             int64_t n, int nb, int cap,
                                                             const P* __restrict__ prev, int64_t prev_ld,
                                                             const P* __restrict__ payload, P* __restrict__ out,
                                                             int64_t out_ld) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    uint64_t* s_keys = reinterpret_cast<uint64_t*>(smem_raw);
    int32_t* s_sub = reinterpret_cast<int32_t*>(s_keys + kCap);
    int32_t* s_warp = s_sub + kSubs;
    const int b = blockIdx.x;
    const int tid = threadIdx.x;
    for (int64_t row = blockIdx.y; row < rows; row += gridDim.y) {
        const int32_t* o = offs + row * (nb + 1);
        const int32_t off = o[b], m = o[b + 1] - off;
        if (m == 0 || m > cap) continue;
#pragma unroll
        for (int q = 0; q < kSubsPerThread; ++q) s_sub[tid + q * kSortThreads] = 0;
        __syncthreads();
        const uint64_t* src = tmp + row * n + off;
        for (int j = tid; j < m; j += kSortThreads)
            atomicAdd(&s_sub[src[j] >> (64 - kSubBits)], 1);
        __syncthreads();
        int32_t local = 0;
#pragma unroll
        for (int q = 0; q < kSubsPerThread; ++q) local += s_sub[tid * kSubsPerThread + q];
        int32_t lo = block_exclusive_scan(local, s_warp);
        const int32_t first = lo;
#pragma unroll
        for (int q = 0; q < kSubsPerThread; ++q) {
            const int32_t c = s_sub[tid * kSubsPerThread + q];
            s_sub[tid * kSubsPerThread + q] = lo;
            lo += c;
        }
        __syncthreads();
        for (int j = tid; j < m; j += kSortThreads) {
            const uint64_t key = src[j];
            s_keys[atomicAdd(&s_sub[key >> (64 - kSubBits)], 1)] = key;
        }
        __syncthreads();
        // this thread's sub-buckets hold [first, lo), in sub-bucket order
        for (int a = first + 1; a < lo; ++a) {
            const uint64_t v = s_keys[a];
            int z = a - 1;
            while (z >= first && s_keys[z] > v) {
                s_keys[z + 1] = s_keys[z];
                --z;
            }
            s_keys[z + 1] = v;
        }
        __syncthreads();
        P* dst = out + row * out_ld;
        for (int j = tid; j < m; j += kSortThreads)
            emit<P, kMode>(s_keys[j], row, prev, prev_ld, payload, dst, off + j);
        __syncthreads();
    }
}

// (e) the buckets past `cap`, a block each: a bitonic network in global
// memory in which every compare puts the smaller key at the lower index, so
// the virtual +inf keys past the bucket's end are never touched; then the
// epilogue. Plain loads and stores: the block rereads what it wrote, made
// visible by __syncthreads.
template <typename P, int kMode>
__global__ void __launch_bounds__(kOverflowThreads) overflow_kernel(uint64_t* tmp, const int32_t* __restrict__ offs,
                                                                   int64_t n, int nb,
                                                                   const int32_t* __restrict__ overflow,
                                                                   const int32_t* __restrict__ stats,
                                                                   const P* __restrict__ prev, int64_t prev_ld,
                                                                   const P* __restrict__ payload,
                                                                   P* __restrict__ out, int64_t out_ld) {
    const int count = stats[0];
    for (int e = blockIdx.x; e < count; e += gridDim.x) {
        const int32_t code = overflow[e];
        const int64_t row = code / nb;
        const int b = code % nb;
        const int32_t* o = offs + row * (nb + 1);
        const int64_t off = o[b], m = o[b + 1] - off;
        uint64_t* a = tmp + row * n + off;
        int64_t span = 1;
        while (span < m) span <<= 1;
        for (int64_t k = 2; k <= span; k <<= 1) {
            for (int64_t j = k >> 1; j > 0; j >>= 1) {
                for (int64_t t = threadIdx.x; t < span / 2; t += blockDim.x) {
                    const int64_t i = 2 * t - (t & (j - 1));  // the lower element of pair t
                    const int64_t p = j == (k >> 1) ? (i ^ (k - 1)) : i + j;
                    if (p < m) {
                        const uint64_t x = a[i], y = a[p];
                        if (x > y) {
                            a[i] = y;
                            a[p] = x;
                        }
                    }
                }
                __syncthreads();
            }
        }
        P* dst = out + row * out_ld;
        for (int64_t j = threadIdx.x; j < m; j += blockDim.x)
            emit<P, kMode>(a[j], row, prev, prev_ld, payload, dst, off + j);
        __syncthreads();
    }
}

unsigned row_grid(int64_t rows) { return static_cast<unsigned>(rows < kRowsPerGrid ? rows : kRowsPerGrid); }

bool valid(int64_t rows, int64_t n, int bits) {
    return bits >= 0 && bits <= kMaxBits && rows > 0 && n > 0 && n < 0x7FFFFFFF && (rows << bits) < 0x7FFFFFFF;
}

template <typename P, int kMode>
int launch_sort(const uint64_t* tmp, const int32_t* offs, const int32_t* overflow, const int32_t* stats, int64_t rows,
                int64_t n, int nb, int cap, const void* prev_v, int64_t prev_ld, const void* payload, void* out,
                int64_t out_ld, cudaStream_t s) {
    const P* prev = static_cast<const P*>(prev_v);
    const size_t smem = kCap * sizeof(uint64_t) + kSubs * sizeof(int32_t) + 32 * sizeof(int32_t);
    cudaError_t err = sqt_allow_smem(sort_kernel<P, kMode>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid(static_cast<unsigned>(nb), row_grid(rows));
    sort_kernel<P, kMode><<<grid, kSortThreads, smem, s>>>(tmp, offs, rows, n, nb, cap, prev, prev_ld,
                                                              static_cast<const P*>(payload), static_cast<P*>(out),
                                                              out_ld);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    overflow_kernel<P, kMode><<<kOverflowBlocks, kOverflowThreads, 0, s>>>(
        const_cast<uint64_t*>(tmp), offs, n, nb, overflow, stats, prev, prev_ld, static_cast<const P*>(payload),
        static_cast<P*>(out), out_ld);
    return static_cast<int>(cudaGetLastError());
}

// The sort's epilogue by payload: packed uint8 values, or a gather of 1, 4
// or 8 bytes, or (payload_bytes 0) the int32 positions.
int sort_by_payload(const uint64_t* tmp, const int32_t* offs, const int32_t* overflow, const int32_t* stats,
                    int64_t rows, int64_t n, int nb, int cap, const void* prev, int64_t prev_ld, const void* payload,
                    int payload_bytes, int packed, void* out, int64_t out_ld, cudaStream_t s) {
    if (packed)
        return launch_sort<uint8_t, kPacked>(tmp, offs, overflow, stats, rows, n, nb, cap, nullptr, 0, nullptr, out,
                                             out_ld, s);
    switch (payload_bytes) {
        case 0:
            return launch_sort<int32_t, kIndex>(tmp, offs, overflow, stats, rows, n, nb, cap, prev, prev_ld, nullptr,
                                                out, out_ld, s);
        case 1:
            return launch_sort<uint8_t, kGather>(tmp, offs, overflow, stats, rows, n, nb, cap, prev, prev_ld, payload,
                                                 out, out_ld, s);
        case 4:
            return launch_sort<uint32_t, kGather>(tmp, offs, overflow, stats, rows, n, nb, cap, prev, prev_ld,
                                                  payload, out, out_ld, s);
        case 8:
            return launch_sort<unsigned long long, kGather>(tmp, offs, overflow, stats, rows, n, nb, cap, prev,
                                                            prev_ld, payload, out, out_ld, s);
        default:
            return static_cast<int>(cudaErrorInvalidValue);
    }
}

size_t scatter_smem(int bits) {
    return kTile * (sizeof(uint64_t) + sizeof(uint16_t)) + (2 * (static_cast<size_t>(1) << bits) + 32) * sizeof(int32_t);
}

}  // namespace

// `keys`: (n_keys, 2) uint32; `out`: (n_keys, n) 32-bit words, each
// xor-ed with 0x80000000 when `flip` is set.
SQT_EXPORT int sqt_threefry_bits(const uint32_t* keys, int64_t n_keys, int64_t n, int flip, void* out,
                                 void* stream) {
    if (n_keys == 0 || n == 0) return 0;
    const int64_t blocks = (n + 255) / 256;
    if (blocks > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid(static_cast<unsigned>(blocks), row_grid(n_keys));
    threefry_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(keys, n_keys, n, flip ? 0x80000000u : 0u,
                                                                         static_cast<uint32_t*>(out));
    return static_cast<int>(cudaGetLastError());
}

// One round of the shuffle for `rows` subkeys (`keys`: (rows, 2) uint32) of
// `n` items each; each word is and-ed with `mask` (0xFFFFFFFF but in tests of
// ties). Scratch, all (rows, ...) row-major: `hist` (rows, 2^bits) int32,
// `offs` (rows, 2^bits + 1) int32, `overflow` (rows * 2^bits) int32, `stats`
// 2 int32, `tmp` (rows, n) uint64.
// (a): zeroes `hist` and `stats`, then counts the buckets.
SQT_EXPORT int sqt_shuffle_hist(const uint32_t* keys, int64_t rows, int64_t n, uint32_t mask, int bits,
                                int32_t* hist, int32_t* stats, void* stream) {
    if (!valid(rows, n, bits)) return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int64_t nb = static_cast<int64_t>(1) << bits;
    cudaError_t err = cudaMemsetAsync(hist, 0, rows * nb * sizeof(int32_t), s);
    if (err == cudaSuccess) err = cudaMemsetAsync(stats, 0, 2 * sizeof(int32_t), s);
    if (err != cudaSuccess) return static_cast<int>(err);
    const size_t smem = nb * sizeof(int32_t);
    err = sqt_allow_smem(hist_kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid(static_cast<unsigned>((n + kTile - 1) / kTile), row_grid(rows));
    hist_kernel<<<grid, kTileThreads, smem, s>>>(keys, rows, n, mask, bits, hist);
    return static_cast<int>(cudaGetLastError());
}

// (b): `cap` is the local sort's capacity, 1 to 4096 keys.
SQT_EXPORT int sqt_shuffle_scan(int64_t rows, int64_t n, int bits, int cap, int32_t* hist, int32_t* offs,
                                int32_t* overflow, int32_t* stats, void* stream) {
    if (!valid(rows, n, bits) || cap < 1 || cap > kCap) return static_cast<int>(cudaErrorInvalidValue);
    scan_kernel<<<row_grid(rows), 1024, 0, static_cast<cudaStream_t>(stream)>>>(rows, n, 1 << bits, cap, hist, offs,
                                                                                overflow, stats);
    return static_cast<int>(cudaGetLastError());
}

// (c): `hist` holds the cursors (b) left. With `vals` (uint8, row r at
// vals + r * vals_ld; vals_ld 0 for one row shared by all), each key
// carries the item's value in its low byte, for the sort's packed epilogue
// (n below 2^24).
SQT_EXPORT int sqt_shuffle_scatter(const uint32_t* keys, int64_t rows, int64_t n, uint32_t mask, int bits,
                                   const uint8_t* vals, int64_t vals_ld, int32_t* hist, uint64_t* tmp,
                                   void* stream) {
    if (!valid(rows, n, bits) || (vals && n >= (1 << 24))) return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = scatter_smem(bits);
    cudaError_t err = sqt_allow_smem(scatter_kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid(static_cast<unsigned>((n + kTile - 1) / kTile), row_grid(rows));
    scatter_kernel<<<grid, kTileThreads, smem, static_cast<cudaStream_t>(stream)>>>(keys, rows, n, mask, bits, vals,
                                                                                    vals_ld, hist, tmp);
    return static_cast<int>(cudaGetLastError());
}

// (d) and (e): `payload_bytes` 0 writes int32 positions to `out` (rows,
// out_ld); 1, 4 or 8, items of that size: `payload` (n of them) at the
// positions. `prev` (rows, prev_ld), of the output's type, is the previous
// round's output, or null in the first round: a later round writes prev at
// its positions (so the payload rides through the rounds). `packed`: the
// keys carry uint8 values (the scatter's `vals`), written as they are.
SQT_EXPORT int sqt_shuffle_sort(const uint64_t* tmp, const int32_t* offs, const int32_t* overflow,
                                const int32_t* stats, int64_t rows, int64_t n, int bits, int cap, const void* prev,
                                int64_t prev_ld, const void* payload, int payload_bytes, int packed, void* out,
                                int64_t out_ld, void* stream) {
    if (!valid(rows, n, bits) || cap < 1 || cap > kCap || out_ld < n) return static_cast<int>(cudaErrorInvalidValue);
    return sort_by_payload(tmp, offs, overflow, stats, rows, n, 1 << bits, cap, prev, prev_ld, payload, payload_bytes,
                           packed, out, out_ld, static_cast<cudaStream_t>(stream));
}


// ---------------------------------------------------------------------------
// K10g, the grouped entry: one sort a row whose items are the positions of
// the group-sorted order, each segment [start, end) (a group) sorted stably
// by word on its own: squidpy_tpu/_core/rng.py `shuffle_group_columns`, the
// two-key (group, word) `lax.sort` of line 98. Word j is the word of
// position j, as there; the sorted values are written at their original rows.
//
// Bound on the card: integer ALU, one word an item (chip_smoke.py's
// `[diag] grouped` line states it and this design's floor: the words drawn
// once, the keys written once and read once, the output written once).
//
// Buckets. A segment of L items has 2^nat coarse buckets (the top `nat` bits
// of the word, ~3072 items a bucket at most on average) and 2^fb fine ones,
// fb = max(nat, 8): a coarse bucket is 2^(fb - nat) consecutive fine ones,
// and the fine buckets leave 8 free bits in a 32-bit key. Tiles. A block of
// the scatter takes one tile of at least 4096 << (fb - 8) items of one
// segment (sub-tiles of 4096), so a row holds about one bucket start a 16
// items and a segment at most 256 tiles. The host makes the layout once a
// call (`_core/rng.py` `_group_tiles`): `tiles` (n_tiles, 4) int32 (segment,
// first position, count, first bucket start of the tile in a row's
// `starts`), `segs` (S, 4) int32 (first tile, tiles, fb, nat), `coarse`
// (nbc, 2) int32 (segment, coarse bucket of the segment).
// (a) `sqt_shuffle_gscatter`: a block draws its tile's words in registers,
//     ranks each item in its fine bucket in item order (a round's peers in
//     a warp from a shared atomicOr of lane bits at 8 fine bits, which
//     measured cheaper on the H100 than the `__match_any_sync` that finer
//     buckets use; one count a (warp, bucket) in shared memory, scanned
//     bucket-major: the rank is the same in every run), places the keys in
//     shared memory in bucket order and writes the tile's keys, in bucket
//     order and in position order within each bucket, over the tile's own
//     positions of `tmp` (one coalesced run), and the tile's bucket starts
//     to `starts` (2^fb + 1 a tile). A key is 32 bits:
//     (word << fb) | value, the word's bits below the bucket and the uint8
//     value (the packed route); or (other payloads, a segment past 2^22
//     items, or n from 2^24 on) 64 bits: ((word << fb) << 32) | position,
//     ranked by shared atomics, since distinct keys need no stable rank. A
//     tile of several sub-tiles counts its buckets in a first pass (its
//     words drawn twice).
// (b) `sqt_shuffle_gsort`: a block a coarse bucket: its keys are one run a
//     tile of its segment, which it reads through the tiles' bucket starts;
//     it rebuilds each key's word (its fine bucket from those starts) and
//     sorts 64-bit keys (word << 32) | (rank << 8) | value, the rank being
//     the key's place among the bucket's keys in (tile, fine bucket, slot)
//     order, so equal words keep position order, or (word << 32) |
//     position: distinct keys, so the counting placement by the next 11 bits
//     of the word (shared atomics, in any order) and each key's count of the
//     smaller keys in its sub-bucket give one order, as JAX's stable two-key
//     sort gives. The epilogue writes each sorted slot at its original row
//     (`order`). A coarse bucket past `cap` keys is listed instead
//     (`overflow`, `stats`).
// (c) `sqt_shuffle_goverflow`: a listed bucket a block builds the same
//     64-bit keys in a scratch buffer (the wrapper sizes it from `stats`:
//     the one host read a chunk) and sorts them by the bitonic network of
//     (e) above.
// Kernels of their own: a template shared with K10's scatter once took that
// scatter from 40 registers to 78 (ptxas) and from ~2.4 to 3.9-4.8 ms a round
// of a 357-key chunk at 1M items (chip_smoke.py on the H100).
// ---------------------------------------------------------------------------

namespace {

constexpr int kMinFineBits = 8;
constexpr int kPackedMaxBits = 11;  // the packed route's counts: 16 warps x 2^fb uint16 in shared memory
constexpr int kWarps = kTileThreads / 32;
constexpr int kTilesMax = 256;    // tiles of a segment, at most
constexpr int kBoundsMax = 768;   // (fine buckets of a coarse one + 1) x tiles of its segment, at most

struct GLayout {
    const int4* tiles;   // segment, first position, count, first bucket start in a row's `starts`
    const int4* segs;    // first tile, tiles, fine bits, coarse bits
    const int2* coarse;  // segment, coarse bucket of the segment
    int64_t ld;          // a row of `starts`
    int64_t nbc;         // coarse buckets a row
};

// The sort key of a scattered key K of fine bucket F at rank j of its
// coarse bucket: (word << 32) | (j << 8) | value, or (word << 32) | position.
template <bool kPacked>
__device__ __forceinline__ uint64_t sort_key(std::conditional_t<kPacked, uint32_t, uint64_t> key, uint32_t j,
                                            uint32_t fine, int fb) {
    if constexpr (kPacked) {
        const uint32_t w = (fine << (32 - fb)) | (key >> fb);
        return (static_cast<uint64_t>(w) << 32) | (j << 8) | (key & 0xFFu);
    } else {
        const uint32_t w = (fine << (32 - fb)) | (static_cast<uint32_t>(key >> 32) >> fb);
        return (static_cast<uint64_t>(w) << 32) | static_cast<uint32_t>(key);
    }
}

template <typename P, bool kPacked>
__device__ __forceinline__ P sorted_value(uint64_t key, const P* __restrict__ payload) {
    if constexpr (kPacked)
        return static_cast<P>(key & 0xFFu);
    else
        return __ldg(payload + static_cast<uint32_t>(key));
}

// (a) the stable scatter of each tile's keys over its own positions, a
// sub-tile of 4096 at a time; a warp takes 256 consecutive items of the
// sub-tile, 32 a round, so the order (warp, round, lane) is item order.
template <bool kPacked>
__global__ void __launch_bounds__(kTileThreads, 3) gscatter_kernel(const uint32_t* __restrict__ keys, int64_t rows,
                                                                  int64_t n, uint32_t mask, GLayout g, int max_bits,
                                                                  const uint8_t* __restrict__ vals,
                                                                  int32_t* __restrict__ starts, void* tmp_v) {
    using Key = std::conditional_t<kPacked, uint32_t, uint64_t>;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int nb_max = 1 << max_bits;
    Key* s_keys = reinterpret_cast<Key*>(smem_raw);
    int32_t* s_run = reinterpret_cast<int32_t*>(s_keys + kTile);  // a bucket's next slot in the tile
    int32_t* s_delta = s_run + nb_max;                            // its slot minus its start in the sub-tile
    int32_t* s_warp = s_delta + nb_max;
    int32_t* s_cnt = s_warp + 32;  // the 64-bit route's counts, then starts
    uint16_t* s_bucket = reinterpret_cast<uint16_t*>(s_cnt + (kPacked ? 0 : nb_max));
    uint16_t* s_wc = s_bucket + kTile;  // the packed route's (warp, bucket) counts, then starts
    const int wc_ld = nb_max + 2;       // an odd number of words a warp's row
    // the packed route at 8 fine bits: a round's lanes of each (warp, bucket), zero between rounds
    unsigned* s_wm = reinterpret_cast<unsigned*>(s_wc + kWarps * wc_ld + 2 * kWarps);
    const int4 t = g.tiles[blockIdx.x];
    const int fb = g.segs[t.x].z, nb = 1 << fb;
    const bool whole = t.z <= kTile;  // one sub-tile: its bucket order is the tile's
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const unsigned lower = (1u << lane) - 1u;
    if (kPacked)
        for (int i = threadIdx.x; i < kWarps << kMinFineBits; i += kTileThreads) s_wm[i] = 0;
    for (int64_t row = blockIdx.y; row < rows; row += gridDim.y) {
        const uint32_t k1 = __ldg(keys + 2 * row), k2 = __ldg(keys + 2 * row + 1);
        int32_t* st = starts + row * g.ld + t.w;
        Key* dst = static_cast<Key*>(tmp_v) + row * n + t.y;
        if (!whole) {  // the tile's bucket starts first
            for (int b = threadIdx.x; b < nb; b += kTileThreads) s_run[b] = 0;
            __syncthreads();
            for (int j = threadIdx.x; j < t.z; j += kTileThreads)
                atomicAdd(&s_run[(word_at(k1, k2, static_cast<int64_t>(t.y) + j) & mask) >> (32 - fb)], 1);
            __syncthreads();
            const int per = (nb + kTileThreads - 1) / kTileThreads, b0 = threadIdx.x * per;
            int32_t local = 0;
            for (int q = 0; q < per && b0 + q < nb; ++q) local += s_run[b0 + q];
            int32_t run = block_exclusive_scan(local, s_warp);
            for (int q = 0; q < per && b0 + q < nb; ++q) {
                const int32_t c = s_run[b0 + q];
                s_run[b0 + q] = st[b0 + q] = run;
                run += c;
            }
        }
        if (threadIdx.x == 0) st[nb] = t.z;
        for (int sub = 0; sub < t.z; sub += kTile) {
            const int cnt = t.z - sub < kTile ? t.z - sub : kTile;
            const int64_t i0 = static_cast<int64_t>(t.y) + sub;
            uint32_t w[kTileItems];
            int32_t rank[kTileItems];  // in the bucket: among the warp's items, or the sub-tile's
            if constexpr (kPacked) {
                uint16_t* wc = s_wc + warp * wc_ld;
                unsigned* wm = s_wm + (warp << kMinFineBits);
                for (int b = lane; b < nb; b += 32) wc[b] = 0;
                __syncthreads();
#pragma unroll
                for (int k = 0; k < kTileItems; ++k) {
                    const int j = warp * (kTileItems * 32) + k * 32 + lane;
                    const bool ok = j < cnt;
                    unsigned peers = 0;  // the round's lanes with this item's bucket
                    int32_t before = 0;
                    uint32_t b = 0;
                    if (fb == kMinFineBits) {  // peers by a shared atomicOr of lane bits
                        if (ok) {
                            w[k] = word_at(k1, k2, i0 + j) & mask;
                            b = w[k] >> (32 - fb);
                            atomicOr(&wm[b], 1u << lane);
                        }
                        __syncwarp();
                        if (ok) {
                            peers = wm[b];
                            before = wc[b];
                        }
                        __syncwarp();
                        if (ok && (peers & lower) == 0) {
                            wc[b] = static_cast<uint16_t>(before + __popc(peers));
                            wm[b] = 0;
                        }
                    } else {
                        const unsigned active = __ballot_sync(0xFFFFFFFFu, ok);
                        if (ok) {
                            w[k] = word_at(k1, k2, i0 + j) & mask;
                            b = w[k] >> (32 - fb);
                            peers = __match_any_sync(active, b);
                            before = wc[b];
                        }
                        __syncwarp();
                        if (ok && (peers & lower) == 0) wc[b] = static_cast<uint16_t>(before + __popc(peers));
                    }
                    __syncwarp();
                    rank[k] = before + __popc(peers & lower);
                }
                __syncthreads();
                // scan the counts bucket-major, warps in order within a bucket
                const int per = nb >> 5;  // 16 nb entries over 512 threads
                const int e0 = threadIdx.x * per;
                int32_t local = 0;
                for (int q = 0; q < per; ++q) local += s_wc[((e0 + q) & 15) * wc_ld + ((e0 + q) >> 4)];
                int32_t run = block_exclusive_scan(local, s_warp);
                for (int q = 0; q < per; ++q) {
                    uint16_t* e = s_wc + ((e0 + q) & 15) * wc_ld + ((e0 + q) >> 4);
                    const int32_t c = *e;
                    *e = static_cast<uint16_t>(run);
                    run += c;
                }
                __syncthreads();
                for (int b = threadIdx.x; b < nb; b += kTileThreads) {
                    const int32_t first = s_wc[b];
                    if (whole) {
                        st[b] = first;
                    } else {
                        const int32_t last = b + 1 < nb ? s_wc[b + 1] : cnt;
                        s_delta[b] = s_run[b] - first;
                        s_run[b] += last - first;
                    }
                }
            } else {
                for (int b = threadIdx.x; b < nb; b += kTileThreads) s_cnt[b] = 0;
                __syncthreads();
#pragma unroll
                for (int k = 0; k < kTileItems; ++k) {
                    const int j = warp * (kTileItems * 32) + k * 32 + lane;
                    if (j < cnt) {
                        w[k] = word_at(k1, k2, i0 + j) & mask;
                        rank[k] = atomicAdd(&s_cnt[w[k] >> (32 - fb)], 1);
                    }
                }
                __syncthreads();
                const int per = (nb + kTileThreads - 1) / kTileThreads, b0 = threadIdx.x * per;
                int32_t local = 0;
                for (int q = 0; q < per && b0 + q < nb; ++q) local += s_cnt[b0 + q];
                int32_t run = block_exclusive_scan(local, s_warp);
                for (int q = 0; q < per && b0 + q < nb; ++q) {
                    const int b = b0 + q;
                    const int32_t c = s_cnt[b];
                    s_cnt[b] = run;
                    if (whole) {
                        st[b] = run;
                    } else {
                        s_delta[b] = s_run[b] - run;
                        s_run[b] += c;
                    }
                    run += c;
                }
            }
            __syncthreads();
#pragma unroll
            for (int k = 0; k < kTileItems; ++k) {
                const int j = warp * (kTileItems * 32) + k * 32 + lane;
                if (j < cnt) {
                    const uint32_t b = w[k] >> (32 - fb);
                    if constexpr (kPacked) {
                        const int at = s_wc[warp * wc_ld + b] + rank[k];
                        s_keys[at] = (w[k] << fb) | __ldg(vals + i0 + j);
                        if (!whole) s_bucket[at] = static_cast<uint16_t>(b);
                    } else {
                        const int at = s_cnt[b] + rank[k];
                        s_keys[at] = (static_cast<uint64_t>(w[k] << fb) << 32) | static_cast<uint32_t>(i0 + j);
                        if (!whole) s_bucket[at] = static_cast<uint16_t>(b);
                    }
                }
            }
            __syncthreads();
            if (whole) {
                for (int j = threadIdx.x; j < cnt; j += kTileThreads) dst[j] = s_keys[j];
            } else {
                for (int j = threadIdx.x; j < cnt; j += kTileThreads) dst[s_delta[s_bucket[j]] + j] = s_keys[j];
            }
            __syncthreads();
        }
    }
}

// A coarse bucket's runs in one row, in shared memory: for each tile of its
// segment, the fine buckets' starts in the tile (nf + 1 of them), and the
// run's first place among the bucket's keys.
struct Runs {
    int tiles, nf, d, fb, nat;
    uint32_t fine0;
    int32_t m;    // the bucket's keys
    int64_t off;  // its first slot in the group-sorted row
};

// Reads coarse bucket c's runs of `row`: s_bounds ((nf + 1) a tile), s_first
// (each tile's first position), s_run (each run's first place among the
// bucket's keys, then m, then the keys of the segment's earlier coarse
// buckets). Every thread of the block (at least kTilesMax of them) calls
// it; it ends with a barrier.
__device__ Runs load_runs(const GLayout& g, int64_t c, int64_t row, const int32_t* __restrict__ starts,
                          int32_t* s_first, int32_t* s_bounds, int32_t* s_run, int32_t* s_warp) {
    const int2 cs = g.coarse[c];
    const int4 sg = g.segs[cs.x];
    const int d = sg.z - sg.w, nf = 1 << d;
    const uint32_t fine0 = static_cast<uint32_t>(cs.y) << d;
    const int32_t* st = starts + row * g.ld;
    for (int i = threadIdx.x; i < sg.y * (nf + 1); i += blockDim.x) {
        const int tl = i / (nf + 1), q = i - tl * (nf + 1);
        const int4 t = g.tiles[sg.x + tl];
        s_bounds[i] = st[t.w + fine0 + q];
        if (q == 0) s_first[tl] = t.y;
    }
    __syncthreads();
    if (threadIdx.x == 0) s_run[kTilesMax + 1] = 0;
    const bool mine = threadIdx.x < sg.y;  // one thread a tile
    const int32_t before = mine ? s_bounds[threadIdx.x * (nf + 1)] : 0;
    const int32_t len = mine ? s_bounds[threadIdx.x * (nf + 1) + nf] - before : 0;
    const int32_t at = block_exclusive_scan(len, s_warp);
    const int32_t earlier = __reduce_add_sync(0xFFFFFFFFu, before);
    if ((threadIdx.x & 31) == 0 && earlier) atomicAdd(&s_run[kTilesMax + 1], earlier);
    if (mine) s_run[threadIdx.x] = at;
    if (threadIdx.x == blockDim.x - 1) s_run[sg.y] = at + len;
    __syncthreads();
    return {sg.y, nf, d, sg.z, sg.w, fine0, s_run[sg.y], static_cast<int64_t>(s_first[0]) + s_run[kTilesMax + 1]};
}

// Key j of a coarse bucket (0 <= j < m): its tile by a binary search of the
// runs, its fine bucket by one of the tile's bounds; the sort key.
template <bool kPacked>
__device__ __forceinline__ uint64_t run_key(const std::conditional_t<kPacked, uint32_t, uint64_t>* __restrict__ src,
                                            const Runs& r, int j, const int32_t* s_first, const int32_t* s_bounds,
                                            const int32_t* s_run) {
    int lo = 0, hi = r.tiles;  // s_run[lo] <= j < s_run[hi]
    while (hi - lo > 1) {
        const int mid = (lo + hi) >> 1;
        if (s_run[mid] <= j) lo = mid;
        else hi = mid;
    }
    const int32_t* bd = s_bounds + lo * (r.nf + 1);
    const int32_t slot = bd[0] + (j - s_run[lo]);  // in the tile
    int f = 0, fh = r.nf;  // bd[f] <= slot < bd[fh]
    while (fh - f > 1) {
        const int mid = (f + fh) >> 1;
        if (bd[mid] <= slot) f = mid;
        else fh = mid;
    }
    return sort_key<kPacked>(src[s_first[lo] + slot], static_cast<uint32_t>(j), r.fine0 + f, r.fb);
}

// (b) a block a coarse bucket of at most `cap` keys: the table of each key's
// (tile, fine bucket), the keys read once into registers (up to 8 a thread:
// 32 registers, so four blocks fit an SM), the counting placement of their
// sort keys by the next 11 bits of the word, each key's rank among the
// smaller keys of its sub-bucket, the epilogue at `order` (or, without it,
// the group-sorted slot). A bucket past `cap` is listed in `overflow` (code,
// scratch offset), stats[0] their number, stats[2] their keys; stats[1] the
// largest bucket.
template <typename P, bool kPacked>
__global__ void __launch_bounds__(kSortThreads, 4) gsort_kernel(const void* tmp_v,
                                                              const int32_t* __restrict__ starts, GLayout g,
                                                              int64_t rows, int64_t n, int cap,
                                                              const P* __restrict__ payload,
                                                              const int32_t* __restrict__ order, P* __restrict__ out,
                                                              int64_t out_ld, int64_t* __restrict__ overflow,
                                                              unsigned long long* __restrict__ stats) {
    using Key = std::conditional_t<kPacked, uint32_t, uint64_t>;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    uint64_t* s_keys = reinterpret_cast<uint64_t*>(smem_raw);
    int32_t* s_sub = reinterpret_cast<int32_t*>(s_keys + kCap);
    int32_t* s_warp = s_sub + kSubs;
    int32_t* s_first = s_warp + 32;
    int32_t* s_run = s_first + kTilesMax;
    int32_t* s_bounds = s_run + kTilesMax + 2;
    uint16_t* s_tab = reinterpret_cast<uint16_t*>(s_bounds + kBoundsMax);  // a key's (tile, fine bucket) run
    const int tid = threadIdx.x;
    for (int64_t row = blockIdx.y; row < rows; row += gridDim.y) {
        const Runs r = load_runs(g, blockIdx.x, row, starts, s_first, s_bounds, s_run, s_warp);
        const int32_t m = r.m;
        if (tid == 0 && m) {
            if (static_cast<unsigned long long>(m) > *reinterpret_cast<volatile unsigned long long*>(stats + 1))
                atomicMax(stats + 1, static_cast<unsigned long long>(m));
            if (m > cap) {
                const unsigned long long e = atomicAdd(stats, 1ull);
                overflow[2 * e] = row * g.nbc + blockIdx.x;
                overflow[2 * e + 1] = static_cast<int64_t>(atomicAdd(stats + 2, static_cast<unsigned long long>(m)));
            }
        }
        if (m == 0 || m > cap) continue;
        const Key* src = static_cast<const Key*>(tmp_v) + row * n;
        auto sub_of = [&](uint64_t key) { return (static_cast<uint32_t>(key >> 32) << r.nat) >> (32 - kSubBits); };
#pragma unroll
        for (int q = 0; q < kSubsPerThread; ++q) s_sub[tid + q * kSortThreads] = 0;
        for (int i = tid; i < r.tiles * r.nf; i += kSortThreads) {  // one thread a run i = tile * nf + fine
            const int tl = i >> r.d, q = i & (r.nf - 1);
            const int32_t* bd = s_bounds + tl * (r.nf + 1);
            for (int j = s_run[tl] + bd[q] - bd[0]; j < s_run[tl] + bd[q + 1] - bd[0]; ++j)
                s_tab[j] = static_cast<uint16_t>(i);
        }
        __syncthreads();
        Key raw[kCap / kSortThreads];
#pragma unroll
        for (int k = 0; k < kCap / kSortThreads; ++k) {
            const int j = tid + k * kSortThreads;
            if (j < m) {
                const int tl = s_tab[j] >> r.d;
                raw[k] = __ldg(src + s_first[tl] + s_bounds[tl * (r.nf + 1)] + (j - s_run[tl]));
            }
        }
        auto sort_key_at = [&](Key key, int j) {
            return sort_key<kPacked>(key, static_cast<uint32_t>(j), r.fine0 + (s_tab[j] & (r.nf - 1)), r.fb);
        };
#pragma unroll
        for (int k = 0; k < kCap / kSortThreads; ++k) {
            const int j = tid + k * kSortThreads;
            if (j < m) atomicAdd(&s_sub[sub_of(sort_key_at(raw[k], j))], 1);
        }
        __syncthreads();
        int32_t local = 0;
#pragma unroll
        for (int q = 0; q < kSubsPerThread; ++q) local += s_sub[tid * kSubsPerThread + q];
        int32_t lo = block_exclusive_scan(local, s_warp);
#pragma unroll
        for (int q = 0; q < kSubsPerThread; ++q) {
            const int32_t c = s_sub[tid * kSubsPerThread + q];
            s_sub[tid * kSubsPerThread + q] = lo;
            lo += c;
        }
        __syncthreads();
#pragma unroll
        for (int k = 0; k < kCap / kSortThreads; ++k) {
            const int j = tid + k * kSortThreads;
            if (j < m) {
                const uint64_t key = sort_key_at(raw[k], j);
                s_keys[atomicAdd(&s_sub[sub_of(key)], 1)] = key;
            }
        }
        __syncthreads();
        // s_sub[s] now ends sub-bucket s; a key's slot is the sub-bucket's
        // start and its count of the smaller keys there
        P* dst = out + row * out_ld;
        for (int j = tid; j < m; j += kSortThreads) {
            const uint64_t key = s_keys[j];
            const uint32_t sb = sub_of(key);
            const int32_t first = sb ? s_sub[sb - 1] : 0, last = s_sub[sb];
            int32_t at = first;
            for (int q = first; q < last; ++q) at += s_keys[q] < key;
            dst[order ? __ldg(order + r.off + at) : r.off + at] = sorted_value<P, kPacked>(key, payload);
        }
        __syncthreads();
    }
}

// (c) the coarse buckets (b) listed, a block each: their sort keys in
// `scratch` at the listed offset, the bitonic network, the epilogue.
template <typename P, bool kPacked>
__global__ void __launch_bounds__(kOverflowThreads) goverflow_kernel(const void* tmp_v,
                                                                    const int32_t* __restrict__ starts, GLayout g,
                                                                    int64_t n, const int64_t* __restrict__ overflow,
                                                                    int64_t n_over, uint64_t* scratch,
                                                                    const P* __restrict__ payload,
                                                                    const int32_t* __restrict__ order,
                                                                    P* __restrict__ out, int64_t out_ld) {
    using Key = std::conditional_t<kPacked, uint32_t, uint64_t>;
    __shared__ int32_t s_warp[32], s_first[kTilesMax], s_run[kTilesMax + 2], s_bounds[kBoundsMax];
    for (int64_t e = blockIdx.x; e < n_over; e += gridDim.x) {
        const int64_t row = overflow[2 * e] / g.nbc;
        const Runs r = load_runs(g, overflow[2 * e] % g.nbc, row, starts, s_first, s_bounds, s_run, s_warp);
        const Key* src = static_cast<const Key*>(tmp_v) + row * n;
        uint64_t* a = scratch + overflow[2 * e + 1];
        for (int j = threadIdx.x; j < r.m; j += blockDim.x)
            a[j] = run_key<kPacked>(src, r, j, s_first, s_bounds, s_run);
        __syncthreads();
        int64_t span = 1;
        while (span < r.m) span <<= 1;
        for (int64_t k = 2; k <= span; k <<= 1) {
            for (int64_t j = k >> 1; j > 0; j >>= 1) {
                for (int64_t t = threadIdx.x; t < span / 2; t += blockDim.x) {
                    const int64_t i = 2 * t - (t & (j - 1));
                    const int64_t p = j == (k >> 1) ? (i ^ (k - 1)) : i + j;
                    if (p < r.m) {
                        const uint64_t x = a[i], y = a[p];
                        if (x > y) {
                            a[i] = y;
                            a[p] = x;
                        }
                    }
                }
                __syncthreads();
            }
        }
        P* dst = out + row * out_ld;
        for (int j = threadIdx.x; j < r.m; j += blockDim.x)
            dst[order ? __ldg(order + r.off + j) : r.off + j] = sorted_value<P, kPacked>(a[j], payload);
        __syncthreads();
    }
}

size_t gscatter_smem(bool packed, int max_bits) {
    const size_t nb = static_cast<size_t>(1) << max_bits;
    const size_t common = kTile * sizeof(uint16_t) + (2 * nb + 32) * sizeof(int32_t);
    return packed ? common + kTile * sizeof(uint32_t) + kWarps * (nb + 4) * sizeof(uint16_t) +
                        (static_cast<size_t>(kWarps) << kMinFineBits) * sizeof(unsigned)
                  : common + kTile * sizeof(uint64_t) + nb * sizeof(int32_t);
}

constexpr size_t kGSortSmem = kCap * (sizeof(uint64_t) + sizeof(uint16_t)) +
                              (kSubs + 32 + kTilesMax + kTilesMax + 2 + kBoundsMax) * sizeof(int32_t);

bool gvalid(int64_t rows, int64_t n, int64_t n_tiles, int64_t nbc, int64_t n_starts, int max_bits) {
    return rows > 0 && n > 0 && n < 0x7FFFFFFF && n_tiles > 0 && n_tiles < 0x7FFFFFFF && nbc > 0 &&
           nbc < 0x7FFFFFFF && n_starts > 0 && n_starts < 0x7FFFFFFF && max_bits >= kMinFineBits &&
           max_bits <= kMaxBits;
}

GLayout glayout(const int32_t* tiles, const int32_t* segs, const int32_t* coarse, int64_t nbc, int64_t n_starts) {
    return {reinterpret_cast<const int4*>(tiles), reinterpret_cast<const int4*>(segs),
            reinterpret_cast<const int2*>(coarse), n_starts, nbc};
}

// The route by payload: packed uint8 values (32-bit keys), or a gather of 1,
// 4 or 8 bytes (64-bit keys); `launch` is called with a P and the route.
template <typename F>
int by_payload(int payload_bytes, int packed, F&& launch) {
    if (packed) return payload_bytes == 1 ? launch(uint8_t{}, std::true_type{}) : static_cast<int>(cudaErrorInvalidValue);
    switch (payload_bytes) {
        case 1:
            return launch(uint8_t{}, std::false_type{});
        case 4:
            return launch(uint32_t{}, std::false_type{});
        case 8:
            return launch(static_cast<unsigned long long>(0), std::false_type{});
        default:
            return static_cast<int>(cudaErrorInvalidValue);
    }
}

}  // namespace

// The grouped entry's layout arguments, the same in every call: `tiles`
// (n_tiles, 4), `segs` (S, 4), `coarse` (nbc, 2), all int32, as the header
// of this section says; `n_starts` the bucket starts of a row (2^fb + 1 a
// tile), `max_bits` the largest fine bits (8 to 13). Scratch: `starts`
// (rows, n_starts) int32; `tmp` (rows, n) of 32-bit keys (packed) or 64-bit
// keys; `overflow` (rows * nbc, 2) int64; `stats` 4 uint64.
// (a): `vals`, when given, holds the n uint8 values in group-sorted order
// (one row shared by all) and selects the packed route (n below 2^24,
// max_bits at most 11); without it the keys carry positions.
SQT_EXPORT int sqt_shuffle_gscatter(const uint32_t* keys, int64_t rows, int64_t n, uint32_t mask, const int32_t* tiles,
                                    int64_t n_tiles, const int32_t* segs, const int32_t* coarse, int64_t nbc,
                                    int64_t n_starts, int max_bits, const uint8_t* vals, int32_t* starts, void* tmp,
                                    void* stream) {
    if (!gvalid(rows, n, n_tiles, nbc, n_starts, max_bits) ||
        (vals && (n >= (1 << 24) || max_bits > kPackedMaxBits)))
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const GLayout g = glayout(tiles, segs, coarse, nbc, n_starts);
    const size_t smem = gscatter_smem(vals != nullptr, max_bits);
    const dim3 grid(static_cast<unsigned>(n_tiles), row_grid(rows));
    cudaError_t err;
    if (vals) {
        err = sqt_allow_smem(gscatter_kernel<true>, smem);
        if (err == cudaSuccess)
            gscatter_kernel<true><<<grid, kTileThreads, smem, s>>>(keys, rows, n, mask, g, max_bits, vals, starts, tmp);
    } else {
        err = sqt_allow_smem(gscatter_kernel<false>, smem);
        if (err == cudaSuccess)
            gscatter_kernel<false><<<grid, kTileThreads, smem, s>>>(keys, rows, n, mask, g, max_bits, nullptr, starts,
                                                                    tmp);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}

// (b): zeroes `stats`, then sorts every coarse bucket of at most `cap` keys
// (1 to 4096) and lists the others. `packed` (the scatter's `vals` given)
// writes the keys' uint8 values; else `payload` holds n items of 1, 4 or 8
// bytes in group-sorted order, gathered at the keys' positions. Sorted slot
// k is written at column `order[k]` of its row when `order` (n int32) is
// given (the original row of group-sorted position k), else at column k.
SQT_EXPORT int sqt_shuffle_gsort(const void* tmp, const int32_t* starts, const int32_t* tiles, int64_t n_tiles,
                                 const int32_t* segs, const int32_t* coarse, int64_t nbc, int64_t n_starts,
                                 int max_bits, int64_t rows, int64_t n, int cap, const int32_t* order,
                                 const void* payload, int payload_bytes, int packed, void* out, int64_t out_ld,
                                 int64_t* overflow, void* stats, void* stream) {
    if (!gvalid(rows, n, n_tiles, nbc, n_starts, max_bits) || cap < 1 || cap > kCap || out_ld < n)
        return static_cast<int>(cudaErrorInvalidValue);
    const GLayout g = glayout(tiles, segs, coarse, nbc, n_starts);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err = cudaMemsetAsync(stats, 0, 4 * sizeof(unsigned long long), s);
    if (err != cudaSuccess) return static_cast<int>(err);
    return by_payload(payload_bytes, packed, [&](auto p, auto route) {
        using P = decltype(p);
        constexpr bool kPacked = decltype(route)::value;
        cudaError_t e = sqt_allow_smem(gsort_kernel<P, kPacked>, kGSortSmem);
        if (e != cudaSuccess) return static_cast<int>(e);
        const dim3 grid(static_cast<unsigned>(nbc), row_grid(rows));
        gsort_kernel<P, kPacked><<<grid, kSortThreads, kGSortSmem, s>>>(
            tmp, starts, g, rows, n, cap, static_cast<const P*>(payload), order, static_cast<P*>(out), out_ld,
            overflow, static_cast<unsigned long long*>(stats));
        return static_cast<int>(cudaGetLastError());
    });
}

// (c): the `n_over` coarse buckets (b) listed, their keys in `scratch`
// (stats[2] uint64 items); the other arguments as (b)'s.
SQT_EXPORT int sqt_shuffle_goverflow(const void* tmp, const int32_t* starts, const int32_t* tiles, int64_t n_tiles,
                                     const int32_t* segs, const int32_t* coarse, int64_t nbc, int64_t n_starts,
                                     int max_bits, int64_t rows, int64_t n, const int64_t* overflow, int64_t n_over,
                                     uint64_t* scratch, const int32_t* order, const void* payload, int payload_bytes,
                                     int packed, void* out, int64_t out_ld, void* stream) {
    if (!gvalid(rows, n, n_tiles, nbc, n_starts, max_bits) || n_over < 1 || out_ld < n)
        return static_cast<int>(cudaErrorInvalidValue);
    const GLayout g = glayout(tiles, segs, coarse, nbc, n_starts);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const unsigned blocks = static_cast<unsigned>(n_over < kOverflowBlocks ? n_over : kOverflowBlocks);
    return by_payload(payload_bytes, packed, [&](auto p, auto route) {
        using P = decltype(p);
        goverflow_kernel<P, decltype(route)::value><<<blocks, kOverflowThreads, 0, s>>>(
            tmp, starts, g, n, overflow, n_over, scratch, static_cast<const P*>(payload), order,
            static_cast<P*>(out), out_ld);
        return static_cast<int>(cudaGetLastError());
    });
}
