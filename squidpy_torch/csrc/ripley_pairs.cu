// K7: Ripley's cumulative pair counts, for one point set or a batch of them.
//
// Replaces squidpy_tpu/ops/ripley.py `_pair_counts_device` (line 30) and
// `_batched_pairs_device` (line 150). There XLA computes a difference-form
// d2 block a tile pair (or a whole simulated cloud) and reduces it once per
// threshold (`lax.map` over the L thresholds), summing int32 a block and
// finishing in int64 on the host. Here, for S point sets of n points (d
// float32 coordinates each) and L squared thresholds sorted ascending, it
// writes out[s, l] = #{i < j : d2(i, j) <= thr[l]} in set s, int64, exact
// at any n (1M points have ~5e11 such pairs). d2 is the difference form in
// axis order, d2 = (x_i0 - x_j0)^2, then d2 += (x_ia - x_ja)^2, each
// subtraction, multiply and add rounded on its own (__fsub_rn, __fmul_rn,
// __fadd_rn, and --fmad=false), so the plain torch version's elementwise ops
// give the same d2 bit for bit.
//
// Bound on the card: operations. Each of the S n (n - 1) / 2 pairs takes
// 3d - 1 flops and one compare with the largest threshold, against d * 4
// bytes of input a point: at Ripley's L mode on the main path (15 clusters
// of ~53k points) ~2.1e10 pairs, ~1.3e11 operations, ~1.9 ms at 67 TFLOP/s.
//
// Design (K2's tile walk, without classes):
// - persistent blocks (as many as stay resident) take work items, a set and
//   a tile pair (ti <= tj) of its upper triangle, from a global counter. A
//   tile holds 512 points: the row tile is staged in shared memory, each of
//   the 256 threads keeps two column points in registers, and each staged
//   row (a broadcast read) meets both. On a diagonal tile only i < j counts,
//   by index; points past n are masked by index, never by d2. For a runtime
//   `dim` (other than 1-3) rows and columns are read from global memory
//   through the cache, any d;
// - a pair's first threshold k with d2 <= thr[k] comes from a table of equal
//   d2 buckets over [0, thr[L-1]] holding the first index any d2 of the
//   bucket can have, then a forward walk of exact compares (K2's table).
//   Pairs beyond the largest threshold, or with a NaN d2, count nowhere;
// - the L-bin histogram of first thresholds sits in shared memory as uint32,
//   one copy a warp (or one for the block, or none, as the wrapper finds
//   room), flushed to the global int64 histogram with 64-bit atomics when
//   the block's set changes, at the end, or after `flush_every` items (a
//   tile pair adds at most 512^2 to a bin); with no room, every pair adds
//   straight into the global histogram. The thresholds are staged too where
//   they fit, else read from global memory. A last kernel makes each set's
//   histogram cumulative. Integer atomics: the result is the same every run.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kReg = 2;  // column points a thread holds
constexpr int kTile = kThreads * kReg;
constexpr unsigned long long kFlushPairs = 0xffffffffULL;  // a uint32 bin holds this many pairs

template <int D>  // D = 0: the dimension is the runtime `dim`, rows and columns read from global memory
__global__ void __launch_bounds__(kThreads) ripley_pairs_kernel(
    const float* __restrict__ pts, int n, int dim, const float* __restrict__ thr, int n_thr, int n_buckets,
    int copies, int stage_thr, int n_tiles, long long n_tile_pairs, long long n_items, int flush_every,
    unsigned long long* __restrict__ next, unsigned long long* __restrict__ hist_out) {
    const int d = D ? D : dim;
    extern __shared__ __align__(16) float smem[];
    float* rows = smem;                                               // (kTile, D) when D > 0
    float* sthr = rows + (D ? static_cast<size_t>(kTile) * D : 0);    // (n_thr,) when stage_thr
    int* stab = reinterpret_cast<int*>(sthr + (stage_thr ? n_thr : 0));  // (n_buckets,)
    uint32_t* hist = reinterpret_cast<uint32_t*>(stab + n_buckets);  // (copies, n_thr)
    __shared__ int s_set, s_ti, s_tj;
    const float* tt = stage_thr ? sthr : thr;
    uint32_t* my_hist = hist + (copies > 1 ? (threadIdx.x >> 5) % copies : 0) * n_thr;

    if (stage_thr) {
        for (int k = threadIdx.x; k < n_thr; k += kThreads) sthr[k] = thr[k];
    }
    for (int e = threadIdx.x; e < copies * n_thr; e += kThreads) hist[e] = 0;
    const float thr_max = thr[n_thr - 1];
    float scale = __fdiv_rn(static_cast<float>(n_buckets), thr_max);  // buckets per unit of d2
    if (!(scale > 0.f) || scale == __int_as_float(0x7f800000)) scale = 0.f;  // then every d2 is in bucket 0
    __syncthreads();  // the thresholds are staged
    for (int b = threadIdx.x; b < n_buckets; b += kThreads) {
        int first = 0;  // bucket 0 holds every d2 below the first boundary
        if (b > 0 && scale > 0.f) {
            const float fb = static_cast<float>(b);
            float x = __fdiv_rn(fb, scale);  // a few ulps from the bucket's least x
            while (__fmul_rn(x, scale) >= fb) x = nextafterf(x, -__int_as_float(0x7f800000));
            while (__fmul_rn(x, scale) < fb) x = nextafterf(x, __int_as_float(0x7f800000));
            int hi = n_thr - 1;  // the first k with thr[k] >= x; d2 <= thr_max keeps it below n_thr
            while (first < hi) {
                const int mid = (first + hi) >> 1;
                if (tt[mid] < x) first = mid + 1; else hi = mid;
            }
        }
        stab[b] = first;
    }

    int cur_set = -1, since_flush = 0;
    // adds the copies of each bin to set `cur_set`'s global bins and zeroes them
    auto flush = [&]() {
        for (int k = threadIdx.x; k < n_thr; k += kThreads) {
            unsigned long long v = 0;
            for (int c = 0; c < copies; ++c) {
                v += hist[c * n_thr + k];
                hist[c * n_thr + k] = 0;
            }
            if (v) atomicAdd(&hist_out[static_cast<size_t>(cur_set) * n_thr + k], v);
        }
    };

    for (;;) {
        if (threadIdx.x == 0) {
            const long long w = static_cast<long long>(atomicAdd(next, 1ULL));
            int set = -1, ti = 0, tj = 0;
            if (w < n_items) {  // w -> (set, p), p -> (ti, tj), tj-major over the upper triangle
                set = static_cast<int>(w / n_tile_pairs);
                const long long p = w - static_cast<long long>(set) * n_tile_pairs;
                long long t = static_cast<long long>((sqrt(8.0 * static_cast<double>(p) + 1.0) - 1.0) * 0.5);
                while (t * (t + 1) / 2 > p) --t;
                while ((t + 1) * (t + 2) / 2 <= p) ++t;
                tj = static_cast<int>(t);
                ti = static_cast<int>(p - t * (t + 1) / 2);
            }
            s_set = set;
            s_ti = ti;
            s_tj = tj;
        }
        __syncthreads();  // every thread is done with the last item's rows and bins
        const int set = s_set, ti = s_ti, tj = s_tj;
        if (set < 0) break;  // uniform over the block
        if (copies && (set != cur_set || since_flush == flush_every)) {
            if (cur_set >= 0) flush();  // the __syncthreads below orders it before this item's adds
            cur_set = set;
            since_flush = 0;
        }
        ++since_flush;
        const float* base = pts + static_cast<size_t>(set) * n * d;

        if (D) {
            for (int t = threadIdx.x; t < kTile * (D ? D : 1); t += kThreads) {
                const long long g = static_cast<long long>(ti) * kTile * d + t;
                rows[t] = g < static_cast<long long>(n) * d ? base[g] : 0.f;
            }
        }
        // the thread's column points and the first row each must not pair with (0 masks it)
        float xj[kReg][D ? D : 1];
        int jlim[kReg];
        long long jg[kReg];
#pragma unroll
        for (int r = 0; r < kReg; ++r) {
            const int j = threadIdx.x + r * kThreads;
            jg[r] = static_cast<long long>(tj) * kTile + j;
            const bool ok = jg[r] < n;
#pragma unroll
            for (int a = 0; a < (D ? D : 1); ++a) xj[r][a] = (D && ok) ? base[jg[r] * d + a] : 0.f;
            jlim[r] = ok ? (ti == tj ? j : kTile) : 0;
        }
        __syncthreads();

        const long long row_left = static_cast<long long>(n) - static_cast<long long>(ti) * kTile;
        const int i_end = row_left < kTile ? static_cast<int>(row_left) : kTile;
        for (int i = 0; i < i_end; ++i) {
            float xi[D ? D : 1];
#pragma unroll
            for (int a = 0; a < (D ? D : 1); ++a) xi[a] = D ? rows[i * (D ? D : 1) + a] : 0.f;
#pragma unroll
            for (int r = 0; r < kReg; ++r) {
                if (i >= jlim[r]) continue;
                float d2;
                if (D) {
                    float diff = __fsub_rn(xi[0], xj[r][0]);
                    d2 = __fmul_rn(diff, diff);
#pragma unroll
                    for (int a = 1; a < (D ? D : 1); ++a) {
                        diff = __fsub_rn(xi[a], xj[r][a]);
                        d2 = __fadd_rn(d2, __fmul_rn(diff, diff));
                    }
                } else {
                    const float* pi = base + (static_cast<long long>(ti) * kTile + i) * d;
                    const float* pj = base + jg[r] * d;
                    float diff = __fsub_rn(__ldg(pi), __ldg(pj));
                    d2 = __fmul_rn(diff, diff);
                    for (int a = 1; a < d; ++a) {
                        diff = __fsub_rn(__ldg(pi + a), __ldg(pj + a));
                        d2 = __fadd_rn(d2, __fmul_rn(diff, diff));
                    }
                }
                if (!(d2 <= thr_max)) continue;
                int b = static_cast<int>(__fmul_rn(d2, scale));
                b = b < 0 ? 0 : (b >= n_buckets ? n_buckets - 1 : b);
                int k = stab[b];  // <= the first k with d2 <= thr[k]; the walk ends at thr_max
                while (tt[k] < d2) ++k;
                if (copies) {
                    atomicAdd(&my_hist[k], 1u);
                } else {
                    atomicAdd(&hist_out[static_cast<size_t>(set) * n_thr + k], 1ULL);
                }
            }
        }
    }
    if (copies && cur_set >= 0) flush();  // every thread passed the last __syncthreads after its last pair
}

__global__ void cumulate_kernel(const unsigned long long* __restrict__ hist, int n_sets, int n_thr,
                                long long* __restrict__ out) {
    const int s = blockIdx.x * blockDim.x + threadIdx.x;
    if (s >= n_sets) return;
    long long run = 0;
    for (int k = 0; k < n_thr; ++k) {
        run += static_cast<long long>(hist[static_cast<size_t>(s) * n_thr + k]);
        out[static_cast<size_t>(s) * n_thr + k] = run;
    }
}

template <int D>
cudaError_t launch(const float* pts, int n_sets, int n, int dim, const float* thr, int n_thr, int n_buckets,
                   int copies, int stage_thr, unsigned long long* next, unsigned long long* hist, cudaStream_t s) {
    const size_t smem = ((D ? static_cast<size_t>(kTile) * D : 0) + (stage_thr ? n_thr : 0) + n_buckets +
                         static_cast<size_t>(copies) * n_thr) * 4;
    cudaError_t err = sqt_allow_smem(ripley_pairs_kernel<D>, smem);
    if (err != cudaSuccess) return err;
    int per_sm = 0, dev = 0, n_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ripley_pairs_kernel<D>, kThreads, smem);
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    const int n_tiles = (n + kTile - 1) / kTile;
    const long long n_tile_pairs = static_cast<long long>(n_tiles) * (n_tiles + 1) / 2;
    const long long n_items = n_tile_pairs * n_sets;
    const long long resident = static_cast<long long>(per_sm) * n_sm;
    const int blocks = static_cast<int>(n_items < resident ? n_items : resident);
    const int flush_every = static_cast<int>(kFlushPairs / (static_cast<unsigned long long>(kTile) * kTile));
    ripley_pairs_kernel<D><<<blocks, kThreads, smem, s>>>(pts, n, dim, thr, n_thr, n_buckets, copies, stage_thr,
                                                          n_tiles, n_tile_pairs, n_items, flush_every, next, hist);
    return cudaGetLastError();
}

}  // namespace

// pts (n_sets, n, dim) float32; thr (n_thr,) float32 ascending; n_buckets
// buckets of the threshold table; `copies` shared histograms (0: global
// atomics only) and `stage_thr` as the wrapper sized them; hist a zeroed
// (n_sets * n_thr + 1) int64 scratch whose last element is the work-item
// counter; out (n_sets, n_thr) int64, the cumulative counts of pairs i < j.
SQT_EXPORT int sqt_ripley_pairs(const float* pts, int n_sets, int n, int dim, const float* thr, int n_thr,
                                int n_buckets, int copies, int stage_thr, long long* hist, long long* out,
                                void* stream) {
    if (n_sets <= 0 || n < 2 || dim <= 0 || n_thr <= 0 || n_buckets <= 0 || copies < 0 ||
        copies > kThreads / 32 || (copies && !stage_thr)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    auto* h = reinterpret_cast<unsigned long long*>(hist);
    unsigned long long* next = h + static_cast<size_t>(n_sets) * n_thr;
    cudaError_t err;
    if (dim == 1) err = launch<1>(pts, n_sets, n, dim, thr, n_thr, n_buckets, copies, stage_thr, next, h, s);
    else if (dim == 2) err = launch<2>(pts, n_sets, n, dim, thr, n_thr, n_buckets, copies, stage_thr, next, h, s);
    else if (dim == 3) err = launch<3>(pts, n_sets, n, dim, thr, n_thr, n_buckets, copies, stage_thr, next, h, s);
    else err = launch<0>(pts, n_sets, n, dim, thr, n_thr, n_buckets, copies, stage_thr, next, h, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    cumulate_kernel<<<(n_sets + 127) / 128, 128, 0, s>>>(h, n_sets, n_thr, out);
    return static_cast<int>(cudaGetLastError());
}
