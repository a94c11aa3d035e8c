// K19: per (crop, channel) quantiles, mean and standard deviation.
//
// Replaces the XLA code of squidpy_tpu/ops/features.py
// `_summary_batch_kernel` (line 149: one sort per (crop, channel), then the
// interpolated gathers) and `summary_features` (line 129, `jnp.quantile` of
// one crop's channel).
//
// Bound on the card: the float32 crops read once (4,992 x 89 x 89 x 3 at the
// main path, 474.5 MB: 0.142 ms at 3.35 TB/s); the sums are a few flops a
// value, so bytes bound it. Measured by chip_smoke.py on one NVIDIA H100
// 80GB HBM3 at a 700 W power limit: 1.24 ms there (a bitonic sort of every
// key, the previous design, 5.4-5.5 ms in `chip_smoke.py --turns`;
// torch.sort and its gathers 10.0 ms), 7.09 ms at 177 x 177 crops; what it
// waits on is the second digit's shared adds.
//
// Keys: each value becomes an order-preserving uint32 key; -0 and +0 share
// a key and every NaN is the canonical quiet NaN, whose key sorts after
// +inf, as JAX's sort comparator orders floats. A quantile reads the keys
// of two ranks (positions in the sorted channel), `ranks` lists the distinct
// ones in ascending order and `qlo` / `qhi` index into it.
//
// Design: a radix select of just those ranks, not a sort. Four passes over
// the keys, one an 8-bit digit from the most significant: a pass counts the
// digit of every key whose higher digits equal a live prefix (a prefix some
// rank still lies under) into that prefix's 256 bins, then one warp walks
// the bins of each live prefix and moves each rank into the bin that holds
// it (the digit joins its prefix, the keys before the bin leave its rank).
// After the fourth pass each rank's prefix is its key, exactly the key a
// sort would put there. All ranks resolve together, so the passes do not
// grow with the number of quantiles. Pixels taken from uint8 images fall
// into a handful of top-digit bins, so a thread counts its keys in runs
// (a bin held in a register while its keys repeat it) and adds a run to the
// shared bin once; the third and fourth digits of integer values are all 0,
// one run a thread.
//
// Routes (the wrapper's `_k19_layout`):
// - select: a block an item, its keys loaded once into shared memory (no
//   padding, up to 55,000 keys), the block sized to the keys (128 to 1024
//   threads) so that items of 89 x 89 crops share an SM several at a time;
// - split: items past the shared keys take `blocks` blocks each, more of
//   them the fewer the items, so one large crop spreads over SMs: a pass's
//   blocks count their slice of the item straight from the float32 values
//   into shared bins and add them to the item's global bins, and the last
//   block to finish (a ticket an item) resolves the ranks; the state of each
//   item's select lives in global memory between the four launches;
// - sort: more than 32 distinct ranks (more than 16 quantiles) sort the
//   keys instead (a bitonic network in shared memory, or in a global scratch
//   row for channels past 32,768 values).
//
// The interpolation rounds as XLA:CPU does (tests/test_torch_image_features.py
// holds it against JAX): the batched kernel's `v_lo * (1 - f) + v_hi * f`
// runs as fma(v_lo, w_lo, v_hi * w_hi), `jnp.quantile`'s as
// fma(v_hi, w_hi, v_lo * w_lo). The wrapper computes the positions and
// float32 weights by the two rules (`rule` 0 and 1); with rule 1 a channel
// holding a NaN gives NaN quantiles, as `jnp.quantile` sets the whole array to
// NaN. The library builds with --fmad=false, so only the __fmaf_rn written
// here fuses.
//
// Mean and std: sums of x and x^2 in double; mean = Sx / p and
// var = max(p * Sxx - Sx * Sx, 0) / (p * p) (NaN kept), rounded to float32 at the end.
// For integer-valued pixels (the uint8 images of a section) the sums are
// exact, so the kernel and the plain version agree bitwise.

#include "common.cuh"

namespace {

constexpr int kMaxRanks = 32;
constexpr int kBins = 256;
constexpr int kPasses = 4;
constexpr int kSortThreads = 1024;
constexpr int kSplitThreads = 256;
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ uint32_t float_key(float v) {
    uint32_t u = __float_as_uint(v);
    if (v == 0.0f) u = 0u;
    if (v != v) u = 0x7FC00000u;
    return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_float(uint32_t k) {
    return __uint_as_float((k & 0x80000000u) ? (k & 0x7FFFFFFFu) : ~k);
}

// One item's select: each distinct rank's prefix (the digits found so far)
// and its rank among the keys under that prefix; the distinct live
// prefixes, ascending, and each rank's index among them.
struct Select {
    uint32_t pref[kMaxRanks];
    uint32_t rank[kMaxRanks];
    uint32_t live[kMaxRanks];
    uint32_t count[kMaxRanks];  // keys under each rank's new prefix
    int idx[kMaxRanks];
    int n_live;
    int any_nan;
    int under;   // keys under the live prefixes
    int cursor;  // the compaction's next free slot
};
static_assert(sizeof(Select) == 656, "ops/features.py K19_STATE_BYTES");

// A pass's live prefixes, their ends held in registers.
struct Live {
    uint32_t first, last;
    int n, shift;
    const uint32_t* list;
    __device__ __forceinline__ Live(const Select& s, int pass)
        : first(s.live[0]), last(s.live[s.n_live - 1]), n(s.n_live), shift(24 - 8 * pass), list(s.live) {}
    // the bin of `key` in this pass (-1: its prefix is not live)
    __device__ __forceinline__ int bin(uint32_t key) const {
        const uint32_t v = key >> (shift + 8);
        const int digit = static_cast<int>((key >> shift) & 0xFFu);
        if (v == first) return digit;
        if (v < first || v > last) return -1;
        if (v == last) return (n - 1) * kBins + digit;
        int lo = 1, hi = n - 1;
        while (lo < hi) {
            const int mid = (lo + hi) >> 1;
            if (list[mid] < v)
                lo = mid + 1;
            else
                hi = mid;
        }
        return list[lo] == v ? lo * kBins + digit : -1;
    }
};

// A thread's run of one bin: added to the bins when the bin changes.
struct Run {
    int bin = -1;
    unsigned n = 0;
    __device__ __forceinline__ void add(int b, unsigned* hist) {
        if (b < 0) return;
        if (b == bin) {
            ++n;
            return;
        }
        if (n) atomicAdd(hist + bin, n);
        bin = b;
        n = 1;
    }
    __device__ __forceinline__ void flush(unsigned* hist) {
        if (n) atomicAdd(hist + bin, n);
    }
};

// One warp moves every rank into the bin that holds it, clears the bins it
// read and lists the new live prefixes. Pass 0 first sets the ranks.
__device__ void resolve(Select& s, unsigned* hist, int pass, int nr, const int* __restrict__ ranks) {
    const int lane = threadIdx.x & 31;
    if (pass == 0) {
        for (int k = lane; k < nr; k += 32) {
            s.rank[k] = static_cast<uint32_t>(ranks[k]);
            s.pref[k] = 0;
            s.idx[k] = 0;
        }
        if (lane == 0) s.n_live = 1;
        __syncwarp();
    }
    const int n_live = s.n_live;
    int k = 0;
    for (int li = 0; li < n_live; ++li) {
        unsigned c[8];
        unsigned total = 0;
#pragma unroll
        for (int b = 0; b < 8; ++b) {
            c[b] = hist[li * kBins + lane * 8 + b];
            total += c[b];
        }
        unsigned incl = total;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const unsigned v = __shfl_up_sync(kFull, incl, o);
            if (lane >= o) incl += v;
        }
        const unsigned excl = incl - total;
        for (; k < nr && s.idx[k] == li; ++k) {
            const unsigned r = s.rank[k];
            const unsigned owner = __ballot_sync(kFull, excl <= r && r < incl);
            const int src = __ffs(owner) - 1;
            unsigned digit = 0, left = 0;
            if (lane == src) {
                unsigned cum = excl;
#pragma unroll
                for (int b = 0; b < 8; ++b) {
                    if (r < cum + c[b]) {
                        digit = lane * 8 + b;
                        left = r - cum;
                        break;
                    }
                    cum += c[b];
                }
            }
            digit = __shfl_sync(kFull, digit, src);
            left = __shfl_sync(kFull, left, src);
            const unsigned in_bin = __shfl_sync(kFull, lane == src ? c[digit & 7] : 0u, src);
            if (lane == 0) {
                s.pref[k] = (s.pref[k] << 8) | digit;
                s.rank[k] = left;
                s.count[k] = in_bin;
            }
            __syncwarp();
        }
#pragma unroll
        for (int b = 0; b < 8; ++b) hist[li * kBins + lane * 8 + b] = 0;
    }
    __syncwarp();
    if (lane == 0) {
        int n = 0, under = 0;
        for (int r = 0; r < nr; ++r) {
            if (n == 0 || s.live[n - 1] != s.pref[r]) {
                s.live[n++] = s.pref[r];
                under += static_cast<int>(s.count[r]);
            }
            s.idx[r] = n - 1;
        }
        s.n_live = n;
        s.under = under;
        s.cursor = 0;
    }
    __syncwarp();
}

// The quantiles, mean and std of one item from the keys of its distinct
// ranks: rank_keys[k], or with `at` the sorted keys rank_keys[at[k]].
__device__ void write_out(const uint32_t* rank_keys, const int* at, double sx, double sxx, int any_nan, size_t crop,
                          int ch, int n_ch, int p, int nq, const int* __restrict__ qlo, const int* __restrict__ qhi,
                          const float* __restrict__ wlo, const float* __restrict__ whi, int rule, float* quant,
                          float* mean, float* stdev, int tid, int nthreads) {
    for (int q = tid; q < nq; q += nthreads) {
        const int lo = at ? at[qlo[q]] : qlo[q], hi = at ? at[qhi[q]] : qhi[q];
        const float a = key_float(rank_keys[lo]), b = key_float(rank_keys[hi]);
        float r = rule == 0 ? __fmaf_rn(a, wlo[q], __fmul_rn(b, whi[q])) : __fmaf_rn(b, whi[q], __fmul_rn(a, wlo[q]));
        if (rule == 1 && any_nan) r = __int_as_float(0x7FC00000);
        quant[(crop * nq + q) * n_ch + ch] = r;
    }
    if (tid == 0) {
        const double pd = static_cast<double>(p);
        const double v = pd * sxx - sx * sx;
        const double var = (v < 0.0 ? 0.0 : v) / (pd * pd);  // NaN stays NaN
        mean[crop * n_ch + ch] = static_cast<float>(sx / pd);
        stdev[crop * n_ch + ch] = static_cast<float>(sqrt(var));
    }
}

__device__ double block_sum(double v, double* red) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFull, v, o);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (lane == 0) red[warp] = v;
    __syncthreads();
    double s = 0.0;
    if (threadIdx.x == 0)
        for (int k = 0; k < static_cast<int>(blockDim.x >> 5); ++k) s += red[k];
    __syncthreads();
    return s;  // thread 0
}

// ---------------------------------------------------------------- select

// A block an item (crop * n_ch + channel); keys, bins and state in shared
// memory. The first digit counts as the keys load; after the second, when
// the keys under the live prefixes fit `cap`, they are copied to `cand` (a
// ballot and one atomic a warp) and the last two passes read only them.
__global__ void __launch_bounds__(1024) select_kernel(
    const float* __restrict__ x, int p, int n_ch, int nr, const int* __restrict__ ranks, int nq,
    const int* __restrict__ qlo, const int* __restrict__ qhi, const float* __restrict__ wlo,
    const float* __restrict__ whi, int rule, int cap, float* __restrict__ quant, float* __restrict__ mean,
    float* __restrict__ stdev) {
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ Select s;
    __shared__ double red[32];
    unsigned* hist = reinterpret_cast<unsigned*>(smem);
    uint32_t* keys = hist + nr * kBins;
    uint32_t* cand = keys + p;
    const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31;
    const int crop = blockIdx.x / n_ch, ch = blockIdx.x % n_ch;
    const float* src = x + static_cast<size_t>(crop) * p * n_ch + ch;
    for (int k = tid; k < nr * kBins; k += nt) hist[k] = 0;
    if (tid == 0) s.any_nan = 0;
    __syncthreads();
    double sx = 0.0, sxx = 0.0;
    bool nan = false;
    {
        // four loads in flight a thread before any of them is used
        Run run;
        for (int k0 = tid; k0 < p; k0 += 4 * nt) {
            float v[4];
#pragma unroll
            for (int u = 0; u < 4; ++u) {
                const int k = k0 + u * nt;
                v[u] = k < p ? __ldg(src + static_cast<size_t>(k) * n_ch) : 0.0f;
            }
#pragma unroll
            for (int u = 0; u < 4; ++u) {
                const int k = k0 + u * nt;
                if (k >= p) break;
                const uint32_t key = float_key(v[u]);
                keys[k] = key;
                run.add(static_cast<int>(key >> 24), hist);
                sx += static_cast<double>(v[u]);
                sxx += static_cast<double>(v[u]) * static_cast<double>(v[u]);
                nan |= v[u] != v[u];
            }
        }
        run.flush(hist);
    }
    if (nan) s.any_nan = 1;
    sx = block_sum(sx, red);
    sxx = block_sum(sxx, red);
    if (tid < 32) resolve(s, hist, 0, nr, ranks);
    __syncthreads();
    const uint32_t* from = keys;
    int n = p;
    for (int pass = 1; pass < kPasses; ++pass) {
        const Live live(s, pass);
        Run run;
        for (int k = tid; k < n; k += nt) run.add(live.bin(from[k]), hist);
        run.flush(hist);
        __syncthreads();
        if (tid < 32) resolve(s, hist, pass, nr, ranks);
        __syncthreads();
        if (pass == 1 && s.under <= cap) {
            const Live next(s, 2);
            for (int k0 = 0; k0 < p; k0 += nt) {
                const int k = k0 + tid;
                const uint32_t key = k < p ? keys[k] : 0u;
                const bool keep = k < p && next.bin(key) >= 0;
                const unsigned mask = __ballot_sync(kFull, keep);
                int base = 0;
                if (lane == 0 && mask) base = atomicAdd(&s.cursor, __popc(mask));
                base = __shfl_sync(kFull, base, 0);
                if (keep) cand[base + __popc(mask & ((1u << lane) - 1u))] = key;
            }
            from = cand;
            n = s.under;
            __syncthreads();
        }
    }
    write_out(s.pref, nullptr, sx, sxx, s.any_nan, crop, ch, n_ch, p, nq, qlo, qhi, wlo, whi, rule, quant, mean,
              stdev, tid, nt);
}

// ---------------------------------------------------------------- split

// Pass `pass` of block (item, b): its slice [b * chunk, (b + 1) * chunk) of
// the item's values into shared bins, added to the item's global bins.
// Pass 0 also writes the slice's sums (part) and marks a NaN. The pass's
// last block of the item (a ticket a pass) resolves its ranks from the
// global bins, clears them, and after the fourth pass writes the outputs.
__global__ void __launch_bounds__(kSplitThreads) split_kernel(
    const float* __restrict__ x, int p, int n_ch, int nr, const int* __restrict__ ranks, int pass, int chunk,
    Select* __restrict__ states, unsigned* __restrict__ ghist, double* __restrict__ part, int* __restrict__ tickets,
    int nq, const int* __restrict__ qlo, const int* __restrict__ qhi, const float* __restrict__ wlo,
    const float* __restrict__ whi, int rule, float* __restrict__ quant, float* __restrict__ mean,
    float* __restrict__ stdev) {
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ Select s;
    __shared__ double red[32];
    __shared__ int last;
    unsigned* hist = reinterpret_cast<unsigned*>(smem);
    const int tid = threadIdx.x, item = blockIdx.x, blocks = gridDim.y;
    const int crop = item / n_ch, ch = item % n_ch;
    const float* src = x + static_cast<size_t>(crop) * p * n_ch + ch;
    Select& g = states[item];
    const int n_live = pass == 0 ? 1 : g.n_live;
    for (int k = tid; k < n_live * kBins; k += blockDim.x) hist[k] = 0;
    for (int k = tid; k < n_live; k += blockDim.x) s.live[k] = pass == 0 ? 0u : g.live[k];
    if (tid == 0) s.n_live = n_live;
    __syncthreads();
    const long long k0 = static_cast<long long>(blockIdx.y) * chunk;
    const long long k1 = min(static_cast<long long>(p), k0 + chunk);
    Run run;
    double sx = 0.0, sxx = 0.0;
    bool nan = false;
    const Live live(s, pass);
    for (long long k = k0 + tid; k < k1; k += blockDim.x) {
        const float v = __ldg(src + static_cast<size_t>(k) * n_ch);
        const uint32_t key = float_key(v);
        run.add(pass == 0 ? static_cast<int>(key >> 24) : live.bin(key), hist);
        if (pass == 0) {
            sx += static_cast<double>(v);
            sxx += static_cast<double>(v) * static_cast<double>(v);
            nan |= v != v;
        }
    }
    run.flush(hist);
    if (pass == 0) {
        if (nan) atomicOr(&g.any_nan, 1);
        sx = block_sum(sx, red);
        sxx = block_sum(sxx, red);
        if (tid == 0) {
            part[(static_cast<size_t>(item) * blocks + blockIdx.y) * 2] = sx;
            part[(static_cast<size_t>(item) * blocks + blockIdx.y) * 2 + 1] = sxx;
        }
    }
    __syncthreads();
    unsigned* gh = ghist + static_cast<size_t>(item) * nr * kBins;
    for (int k = tid; k < n_live * kBins; k += blockDim.x)
        if (hist[k]) atomicAdd(gh + k, hist[k]);
    __threadfence();
    __syncthreads();
    if (tid == 0) last = atomicAdd(tickets + item, 1) == blocks - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
    for (int k = tid; k < n_live * kBins; k += blockDim.x) {
        hist[k] = __ldcg(gh + k);
        gh[k] = 0;
    }
    __syncthreads();
    if (tid < 32) resolve(g, hist, pass, nr, ranks);
    if (tid == 0) tickets[item] = 0;
    if (pass < kPasses - 1) return;
    __syncthreads();
    if (tid == 0) {
        sx = sxx = 0.0;
        for (int b = 0; b < blocks; ++b) {
            sx += __ldcg(part + (static_cast<size_t>(item) * blocks + b) * 2);
            sxx += __ldcg(part + (static_cast<size_t>(item) * blocks + b) * 2 + 1);
        }
        red[0] = sx;
        red[1] = sxx;
    }
    __syncthreads();
    write_out(g.pref, nullptr, red[0], red[1], __ldcg(&g.any_nan), crop, ch, n_ch, p, nq, qlo, qhi, wlo, whi, rule,
              quant, mean, stdev, tid, blockDim.x);
}

// ---------------------------------------------------------------- sort

// A block an item: a bitonic sort of the keys padded to p2 (a power of two)
// with keys that sort last, in shared memory or at gkeys + block * p2.
__global__ void __launch_bounds__(kSortThreads) sort_kernel(
    const float* __restrict__ x, int n_items, int p, int n_ch, int p2, const int* __restrict__ ranks, int nq,
    const int* __restrict__ qlo, const int* __restrict__ qhi, const float* __restrict__ wlo,
    const float* __restrict__ whi, int rule, uint32_t* __restrict__ gkeys, float* __restrict__ quant,
    float* __restrict__ mean, float* __restrict__ stdev) {
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ double red[32];
    __shared__ int any_nan;
    uint32_t* keys = gkeys ? gkeys + static_cast<size_t>(blockIdx.x) * p2 : reinterpret_cast<uint32_t*>(smem);
    for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
        const int crop = item / n_ch, ch = item % n_ch;
        const float* src = x + static_cast<size_t>(crop) * p * n_ch + ch;
        if (threadIdx.x == 0) any_nan = 0;
        double sx = 0.0, sxx = 0.0;
        bool nan = false;
        for (int k = threadIdx.x; k < p2; k += blockDim.x) {
            if (k < p) {
                const float v = __ldg(src + static_cast<size_t>(k) * n_ch);
                keys[k] = float_key(v);
                sx += static_cast<double>(v);
                sxx += static_cast<double>(v) * static_cast<double>(v);
                nan |= v != v;
            } else {
                keys[k] = 0xFFFFFFFFu;
            }
        }
        __syncthreads();
        if (nan) any_nan = 1;
        sx = block_sum(sx, red);
        sxx = block_sum(sxx, red);
        for (int size = 2; size <= p2; size <<= 1) {
            for (int stride = size >> 1; stride > 0; stride >>= 1) {
                for (int k = threadIdx.x; k < p2 / 2; k += blockDim.x) {
                    const int lo = 2 * k - (k & (stride - 1));
                    const int hi = lo + stride;
                    const bool up = (lo & size) == 0;
                    const uint32_t a = keys[lo], b = keys[hi];
                    if ((a > b) == up) {
                        keys[lo] = b;
                        keys[hi] = a;
                    }
                }
                __syncthreads();
            }
        }
        write_out(keys, ranks, sx, sxx, any_nan, crop, ch, n_ch, p, nq, qlo, qhi, wlo, whi, rule, quant, mean, stdev,
                  threadIdx.x, blockDim.x);
        __syncthreads();
    }
}

}  // namespace

// x: (n_crops, p, n_ch) float32; ranks (nr,) int32, the distinct positions
// the quantiles read in the sorted channel, ascending; qlo, qhi (nq,) int32
// indices into ranks, wlo, whi (nq,) float32 weights; quant (n_crops, nq,
// n_ch), mean and stdev (n_crops, n_ch) float32.
// route 0 (select): `threads` a block, one block an item, nr <= 32, room
// for `cap` keys under the live prefixes after the second digit.
// route 1 (split): `blocks` blocks an item of 256 threads, a launch a pass;
// `scratch` holds the states (n_items Select structs), ghist (n_items * nr *
// 256 uint32), part (n_items * blocks * 2 float64) and tickets (n_items
// int32), all zero on entry (ops/features.py `_k19_layout`).
// route 2 (sort): p2 the power of two at or above p; with gkeys null the
// keys live in shared memory (p2 <= 32768, one block an item), else gkeys
// holds max_blocks * p2 uint32 and a grid of max_blocks loops over the items.
SQT_EXPORT int sqt_crop_summary(const void* x, int n_crops, int p, int n_ch, int route, int threads, int blocks,
                                int cap, int nr, const void* ranks, int nq, const void* qlo, const void* qhi,
                                const void* wlo, const void* whi, int rule, int p2, int max_blocks, void* scratch,
                                void* quant, void* mean, void* stdev, void* stream) {
    const int n_items = n_crops * n_ch;
    if (n_items == 0 || p == 0) return 0;
    if ((route != 2 && (nr < 1 || nr > kMaxRanks)) || threads < 32 || threads > 1024) return cudaErrorInvalidValue;
    const auto st = static_cast<cudaStream_t>(stream);
    const auto* xf = static_cast<const float*>(x);
    const auto* rk = static_cast<const int*>(ranks);
    const auto* ql = static_cast<const int*>(qlo);
    const auto* qh = static_cast<const int*>(qhi);
    const auto* wl = static_cast<const float*>(wlo);
    const auto* wh = static_cast<const float*>(whi);
    auto* qo = static_cast<float*>(quant);
    auto* mo = static_cast<float*>(mean);
    auto* so = static_cast<float*>(stdev);
    if (route == 0) {
        const size_t smem = static_cast<size_t>(nr) * kBins * 4 + static_cast<size_t>(p + cap) * 4;
        cudaError_t err = sqt_allow_smem(select_kernel, smem);
        if (err != cudaSuccess) return err;
        select_kernel<<<n_items, threads, smem, st>>>(xf, p, n_ch, nr, rk, nq, ql, qh, wl, wh, rule, cap, qo, mo,
                                                      so);
        return cudaGetLastError();
    }
    if (route == 1) {
        auto* states = static_cast<Select*>(scratch);
        auto* ghist = reinterpret_cast<unsigned*>(states + n_items);
        auto* part = reinterpret_cast<double*>(ghist + static_cast<size_t>(n_items) * nr * kBins);
        auto* tickets = reinterpret_cast<int*>(part + static_cast<size_t>(n_items) * blocks * 2);
        const int chunk = (p + blocks - 1) / blocks;
        const size_t smem = static_cast<size_t>(nr) * kBins * 4;
        cudaError_t err = sqt_allow_smem(split_kernel, smem);
        if (err != cudaSuccess) return err;
        for (int pass = 0; pass < kPasses; ++pass)
            split_kernel<<<dim3(n_items, blocks), kSplitThreads, smem, st>>>(
                xf, p, n_ch, nr, rk, pass, chunk, states, ghist, part, tickets, nq, ql, qh, wl, wh, rule, qo, mo, so);
        return cudaGetLastError();
    }
    size_t smem = 0;
    int grid = n_items;
    if (!scratch) {
        smem = static_cast<size_t>(p2) * sizeof(uint32_t);
        cudaError_t err = sqt_allow_smem(sort_kernel, smem);
        if (err != cudaSuccess) return err;
    } else {
        grid = n_items < max_blocks ? n_items : max_blocks;
    }
    sort_kernel<<<grid, kSortThreads, smem, st>>>(xf, n_items, p, n_ch, p2, rk, nq, ql, qh, wl, wh, rule,
                                                  static_cast<uint32_t*>(scratch), qo, mo, so);
    return cudaGetLastError();
}
