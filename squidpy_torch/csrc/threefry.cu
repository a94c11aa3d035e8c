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
// The grouped entry (`sqt_shuffle_g*`) is the same round for a shuffle
// within groups (squidpy_tpu/_core/rng.py `shuffle_group_columns`, the
// (group, word) `lax.sort` of line 98): the positions of the group-sorted
// order fall into segments, each segment has its own buckets (a bucket is
// (segment, top bits of the word), as many a segment as its length asks),
// a block of (a) and (c) takes at most 4096 items of one segment (a tile
// table made on the host once a call), and the epilogue writes each sorted
// slot straight at its original row.
// The plain torch version (squidpy_torch/_core/rng.py) draws the words with
// `_threefry_plain` and sorts them with `torch.sort(stable=True)`.

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

// The items a block of (a) and (c) takes from each row: [i0, i0 + count),
// bucketed by the top `bits` bits of their words into the row's buckets
// [base, base + 2^bits). Without groups, block x takes the x-th 4096 items
// and the row's 2^bits buckets. The grouped entry's `tiles` give each block
// (segment, first item, count), at most 4096 items of one segment, and
// `segs` each segment's (first bucket, bits). A template parameter: one
// kernel for both took the ungrouped scatter from 40 registers to 78 and
// from ~2.4 to 3.9-4.8 ms a round of a 357-key chunk at 1M items (ptxas
// and chip_smoke.py on the H100).
struct Tile {
    int64_t i0;
    int count;
    int bits;
    int base;
};

template <bool kGrouped>
__device__ __forceinline__ Tile tile_of(const int32_t* __restrict__ tiles, const int32_t* __restrict__ segs,
                                        int64_t n, int bits) {
    if constexpr (kGrouped) {
        const int32_t* t = tiles + 3 * static_cast<int64_t>(blockIdx.x);
        return {t[1], t[2], segs[2 * t[0] + 1], segs[2 * t[0]]};
    } else {
        const int64_t i0 = static_cast<int64_t>(blockIdx.x) * kTile;
        return {i0, static_cast<int>(n - i0 < kTile ? n - i0 : kTile), bits, 0};
    }
}

// (a) histogram of the top bits of each row's words (`nb_row` buckets a row).
template <bool kGrouped>
__global__ void __launch_bounds__(kTileThreads) hist_kernel(const uint32_t* __restrict__ keys, int64_t rows,
                                                           int64_t n, uint32_t mask, int bits,
                                                           const int32_t* __restrict__ tiles,
                                                           const int32_t* __restrict__ segs, int64_t nb_row,
                                                           int32_t* __restrict__ hist) {
    extern __shared__ int32_t s_cnt[];
    const Tile tl = tile_of<kGrouped>(tiles, segs, n, bits);
    const int nb = 1 << tl.bits;
    const int64_t end = kGrouped ? tl.i0 + tl.count : n;
    for (int64_t row = blockIdx.y; row < rows; row += gridDim.y) {
        for (int b = threadIdx.x; b < nb; b += kTileThreads) s_cnt[b] = 0;
        __syncthreads();
        const uint32_t k1 = __ldg(keys + 2 * row), k2 = __ldg(keys + 2 * row + 1);
#pragma unroll 4
        for (int k = 0; k < kTileItems; ++k) {
            const int64_t i = tl.i0 + k * kTileThreads + threadIdx.x;
            if (i < end) atomicAdd(&s_cnt[bucket_of(word_at(k1, k2, i) & mask, tl.bits)], 1);
        }
        __syncthreads();
        int32_t* h = kGrouped ? hist + row * nb_row + tl.base : hist + row * nb;
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
template <bool kGrouped>
__global__ void __launch_bounds__(kTileThreads) scatter_kernel(const uint32_t* __restrict__ keys, int64_t rows,
                                                              int64_t n, uint32_t mask, int bits,
                                                              const int32_t* __restrict__ tiles,
                                                              const int32_t* __restrict__ segs, int64_t nb_row,
                                                              int max_bits, const uint8_t* __restrict__ vals,
                                                              int64_t vals_ld, int32_t* __restrict__ cursor,
                                                              uint64_t* __restrict__ tmp) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const Tile tl = tile_of<kGrouped>(tiles, segs, n, bits);
    const int nb = 1 << tl.bits;
    const int nb_max = kGrouped ? 1 << max_bits : nb;  // the shared arrays' length
    uint64_t* s_keys = reinterpret_cast<uint64_t*>(smem_raw);
    int32_t* s_cnt = reinterpret_cast<int32_t*>(s_keys + kTile);  // counts, then the tile's starts
    int32_t* s_base = s_cnt + nb_max;  // a bucket's slot in the row minus its start in the tile
    int32_t* s_warp = s_base + nb_max;
    uint16_t* s_bucket = reinterpret_cast<uint16_t*>(s_warp + 32);  // the bucket of each placed key
    const int64_t i0 = tl.i0;
    const int64_t end = kGrouped ? i0 + tl.count : n;
    const int count = tl.count;
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
            if (i < end) {
                const int32_t value = v ? static_cast<int32_t>(__ldg(v + i)) << 16 : 0;
                w[k] = word_at(k1, k2, i) & mask;
                rank[k] = value | atomicAdd(&s_cnt[bucket_of(w[k], tl.bits)], 1);
            }
        }
        __syncthreads();
        int32_t local = 0;
        for (int j = 0; j < per; ++j)
            if (b0 + j < nb) local += s_cnt[b0 + j];
        int32_t run = block_exclusive_scan(local, s_warp);
        int32_t* cur = kGrouped ? cursor + row * nb_row + tl.base : cursor + row * nb;
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
            if (i < end) {
                const uint32_t b = bucket_of(w[k], tl.bits);
                const int at = s_cnt[b] + (rank[k] & 0xFFFF);
                const uint64_t low = v ? (static_cast<uint64_t>(i) << 8) | static_cast<uint32_t>(rank[k] >> 16)
                                       : static_cast<uint64_t>(i);
                s_keys[at] = (static_cast<uint64_t>(w[k] << tl.bits) << 32) | low;
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
// `order`, when given, maps each sorted slot to the column it is written
// at (the grouped entry: group-sorted slot -> original row), else the slot
// is the column.
template <typename P, int kMode>
__global__ void __launch_bounds__(kSortThreads, 4) sort_kernel(const uint64_t* __restrict__ tmp,
                                                             const int32_t* __restrict__ offs, int64_t rows,
                                                             int64_t n, int nb, int cap,
                                                             const P* __restrict__ prev, int64_t prev_ld,
                                                             const P* __restrict__ payload,
                                                             const int32_t* __restrict__ order, P* __restrict__ out,
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
            emit<P, kMode>(s_keys[j], row, prev, prev_ld, payload, dst, order ? __ldg(order + off + j) : off + j);
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
                                                                   const int32_t* __restrict__ order,
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
            emit<P, kMode>(a[j], row, prev, prev_ld, payload, dst, order ? __ldg(order + off + j) : off + j);
        __syncthreads();
    }
}

unsigned row_grid(int64_t rows) { return static_cast<unsigned>(rows < kRowsPerGrid ? rows : kRowsPerGrid); }

bool valid_nb(int64_t rows, int64_t n, int64_t nb) {
    return rows > 0 && n > 0 && n < 0x7FFFFFFF && nb > 0 && rows * nb < 0x7FFFFFFF;
}

bool valid(int64_t rows, int64_t n, int bits) {
    return bits >= 0 && bits <= kMaxBits && valid_nb(rows, n, static_cast<int64_t>(1) << bits);
}

template <typename P, int kMode>
int launch_sort(const uint64_t* tmp, const int32_t* offs, const int32_t* overflow, const int32_t* stats, int64_t rows,
                int64_t n, int nb, int cap, const void* prev_v, int64_t prev_ld, const void* payload,
                const int32_t* order, void* out, int64_t out_ld, cudaStream_t s) {
    const P* prev = static_cast<const P*>(prev_v);
    const size_t smem = kCap * sizeof(uint64_t) + kSubs * sizeof(int32_t) + 32 * sizeof(int32_t);
    cudaError_t err = sqt_allow_smem(sort_kernel<P, kMode>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid(static_cast<unsigned>(nb), row_grid(rows));
    sort_kernel<P, kMode><<<grid, kSortThreads, smem, s>>>(tmp, offs, rows, n, nb, cap, prev, prev_ld,
                                                              static_cast<const P*>(payload), order,
                                                              static_cast<P*>(out), out_ld);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    overflow_kernel<P, kMode><<<kOverflowBlocks, kOverflowThreads, 0, s>>>(
        const_cast<uint64_t*>(tmp), offs, n, nb, overflow, stats, prev, prev_ld, static_cast<const P*>(payload),
        order, static_cast<P*>(out), out_ld);
    return static_cast<int>(cudaGetLastError());
}

// The sort's epilogue by payload: packed uint8 values, or a gather of 1, 4
// or 8 bytes, or (payload_bytes 0) the int32 positions.
int sort_by_payload(const uint64_t* tmp, const int32_t* offs, const int32_t* overflow, const int32_t* stats,
                    int64_t rows, int64_t n, int nb, int cap, const void* prev, int64_t prev_ld, const void* payload,
                    int payload_bytes, int packed, const int32_t* order, void* out, int64_t out_ld, cudaStream_t s) {
    if (packed)
        return launch_sort<uint8_t, kPacked>(tmp, offs, overflow, stats, rows, n, nb, cap, nullptr, 0, nullptr, order,
                                             out, out_ld, s);
    switch (payload_bytes) {
        case 0:
            return launch_sort<int32_t, kIndex>(tmp, offs, overflow, stats, rows, n, nb, cap, prev, prev_ld, nullptr,
                                                order, out, out_ld, s);
        case 1:
            return launch_sort<uint8_t, kGather>(tmp, offs, overflow, stats, rows, n, nb, cap, prev, prev_ld, payload,
                                                 order, out, out_ld, s);
        case 4:
            return launch_sort<uint32_t, kGather>(tmp, offs, overflow, stats, rows, n, nb, cap, prev, prev_ld,
                                                  payload, order, out, out_ld, s);
        case 8:
            return launch_sort<unsigned long long, kGather>(tmp, offs, overflow, stats, rows, n, nb, cap, prev,
                                                            prev_ld, payload, order, out, out_ld, s);
        default:
            return static_cast<int>(cudaErrorInvalidValue);
    }
}

size_t scatter_smem(int max_bits) {
    return kTile * (sizeof(uint64_t) + sizeof(uint16_t)) +
           (2 * (static_cast<size_t>(1) << max_bits) + 32) * sizeof(int32_t);
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
    err = sqt_allow_smem(hist_kernel<false>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid(static_cast<unsigned>((n + kTile - 1) / kTile), row_grid(rows));
    hist_kernel<false><<<grid, kTileThreads, smem, s>>>(keys, rows, n, mask, bits, nullptr, nullptr, nb, hist);
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
    cudaError_t err = sqt_allow_smem(scatter_kernel<false>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid(static_cast<unsigned>((n + kTile - 1) / kTile), row_grid(rows));
    scatter_kernel<false><<<grid, kTileThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        keys, rows, n, mask, bits, nullptr, nullptr, static_cast<int64_t>(1) << bits, bits, vals, vals_ld, hist, tmp);
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
                           packed, nullptr, out, out_ld, static_cast<cudaStream_t>(stream));
}

// The grouped entry: one round whose items are the positions of the
// group-sorted order, each row sorted stably by (segment, word), i.e. each
// segment [start, end) of the positions on its own (squidpy_tpu/_core/rng.py
// `shuffle_group_columns`, the two-key `lax.sort` of line 98). Word j is the
// word of position j, as there. A segment of L items has 2^bits buckets
// (bits from L, as a row's in the entries above); `segs` (S, 2) int32 holds
// each segment's first bucket in the row and its bits, `nb` the row's
// buckets in all, `max_bits` the largest bits; `tiles` (n_tiles, 3) int32
// each block's (segment, first position, count <= 4096). Keys hold the
// position j in the row, so (word, j) stays a distinct key and the result
// stays exact under atomics. Scratch as above, with nb buckets a row.
// (a): zeroes `hist` and `stats`, then counts the buckets.
SQT_EXPORT int sqt_shuffle_ghist(const uint32_t* keys, int64_t rows, int64_t n, uint32_t mask, const int32_t* tiles,
                                 int64_t n_tiles, const int32_t* segs, int max_bits, int64_t nb, int32_t* hist,
                                 int32_t* stats, void* stream) {
    if (!valid_nb(rows, n, nb) || max_bits < 0 || max_bits > kMaxBits || n_tiles < 1 || n_tiles > 0x7FFFFFFF)
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err = cudaMemsetAsync(hist, 0, rows * nb * sizeof(int32_t), s);
    if (err == cudaSuccess) err = cudaMemsetAsync(stats, 0, 2 * sizeof(int32_t), s);
    if (err != cudaSuccess) return static_cast<int>(err);
    const size_t smem = (static_cast<size_t>(1) << max_bits) * sizeof(int32_t);
    err = sqt_allow_smem(hist_kernel<true>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid(static_cast<unsigned>(n_tiles), row_grid(rows));
    hist_kernel<true><<<grid, kTileThreads, smem, s>>>(keys, rows, n, mask, 0, tiles, segs, nb, hist);
    return static_cast<int>(cudaGetLastError());
}

// (b): as `sqt_shuffle_scan`, over the row's nb buckets.
SQT_EXPORT int sqt_shuffle_gscan(int64_t rows, int64_t n, int64_t nb, int cap, int32_t* hist, int32_t* offs,
                                 int32_t* overflow, int32_t* stats, void* stream) {
    if (!valid_nb(rows, n, nb) || cap < 1 || cap > kCap) return static_cast<int>(cudaErrorInvalidValue);
    scan_kernel<<<row_grid(rows), 1024, 0, static_cast<cudaStream_t>(stream)>>>(rows, n, static_cast<int>(nb), cap,
                                                                                hist, offs, overflow, stats);
    return static_cast<int>(cudaGetLastError());
}

// (c): `vals`, when given, holds the n uint8 values in group-sorted order
// (one row shared by all), carried in the keys' low byte (n below 2^24).
SQT_EXPORT int sqt_shuffle_gscatter(const uint32_t* keys, int64_t rows, int64_t n, uint32_t mask,
                                    const int32_t* tiles, int64_t n_tiles, const int32_t* segs, int max_bits,
                                    int64_t nb, const uint8_t* vals, int32_t* hist, uint64_t* tmp, void* stream) {
    if (!valid_nb(rows, n, nb) || max_bits < 0 || max_bits > kMaxBits || n_tiles < 1 || n_tiles > 0x7FFFFFFF ||
        (vals && n >= (1 << 24)))
        return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = scatter_smem(max_bits);
    cudaError_t err = sqt_allow_smem(scatter_kernel<true>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid(static_cast<unsigned>(n_tiles), row_grid(rows));
    scatter_kernel<true><<<grid, kTileThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        keys, rows, n, mask, 0, tiles, segs, nb, max_bits, vals, 0, hist, tmp);
    return static_cast<int>(cudaGetLastError());
}

// (d) and (e): the epilogue of `sqt_shuffle_sort`'s first round (`payload`:
// n items of 1, 4 or 8 bytes in group-sorted order, gathered at the keys'
// positions, or the packed uint8 values), each sorted slot k written at
// column `order[k]` of its row when `order` (n int32) is given (the
// original row of group-sorted position k: increasing within a segment, so
// a bucket's stores are monotone), else at column k.
SQT_EXPORT int sqt_shuffle_gsort(const uint64_t* tmp, const int32_t* offs, const int32_t* overflow,
                                 const int32_t* stats, int64_t rows, int64_t n, int64_t nb, int cap,
                                 const int32_t* order, const void* payload, int payload_bytes, int packed, void* out,
                                 int64_t out_ld, void* stream) {
    if (!valid_nb(rows, n, nb) || cap < 1 || cap > kCap || out_ld < n || (!packed && payload_bytes == 0))
        return static_cast<int>(cudaErrorInvalidValue);
    return sort_by_payload(tmp, offs, overflow, stats, rows, n, static_cast<int>(nb), cap, nullptr, 0, payload,
                           payload_bytes, packed, order, out, out_ld, static_cast<cudaStream_t>(stream));
}
