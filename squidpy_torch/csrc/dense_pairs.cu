// K2: dense all-pairs cumulative class-pair counts of co_occurrence(use_pallas=True).
//
// Replaces the Pallas kernel squidpy_tpu/ops/pallas_pairs.py `_make_kernel`
// (launched by `_launch`, line 75). For points (n, d) float32 with labels in
// [0, C) and L squared thresholds sorted ascending, it counts, per threshold
// l and class pair (a, b), the pairs i < j with d2(i, j) <= thr[l], where d2
// is the expanded form the Pallas kernel computes,
//   d2 = (|p_i|^2 + |p_j|^2) - 2 <p_i, p_j>,
// each norm and dot product summed over the dimensions in order, every
// product and sum rounded on its own (__fmul_rn/__fadd_rn, --fmad=false), so
// the plain torch version's elementwise ops give the same d2 bit for bit.
// A second pass turns the first-threshold histogram into the ordered
// cumulative counts out[l, a, b] = sum_{k<=l} (h[k, a, b] + h[k, b, a]):
// d2 is symmetric, so each unordered pair counts in both orders.
//
// Bound on the card: operations. Every one of the n(n-1)/2 pairs takes the
// dot product (2d - 1 flops), the norm sum, the doubled dot and the
// difference (3 flops) and a search over the thresholds (log2 L compares)
// against 4(d + 1) bytes of input per point: at 200k 2D points and L = 49,
// 2.0e10 pairs and ~2.6e11 operations, ~3.9 ms at 67 TFLOP/s, against a few
// MB of input.
//
// Design:
// - persistent blocks (as many as stay resident on every SM) take tile
//   pairs (ti <= tj) of the upper triangle one at a time from a global
//   counter, so no block is empty. A tile holds threads x R points (512
//   threads, R = 1 or 2); the row tile is staged in shared memory as one
//   record per point (coordinates, norm, label bits), and each thread
//   keeps R column points in registers (for a runtime `dim`, R = 1 and the
//   column tile is staged too), so one broadcast read of a row serves R
//   pairs. On a diagonal tile only i < j counts, by index;
// - padding and labels outside [0, C) are masked by label, never by d2;
// - a pair's first threshold k with d2 <= thr[k] comes from a table of
//   equal d2 buckets over [0, thr[L-1]] that holds the first index any d2 of
//   the bucket can have, then a forward walk of exact compares (pairs beyond
//   the largest threshold, or with NaN d2, are skipped). Each block builds
//   the table in shared memory from the thresholds (no launch or copy on
//   the host): scale = fl(n_buckets / thr[L-1]) (0 unless positive and
//   finite), a d2 falls in bucket clip(int(fl(d2 * scale)), 0, n_buckets - 1),
//   and bucket b >= 1 starts at the least float x with fl(x * scale) >= b;
// - the (L, C, C) histogram sits in shared memory as uint32 when it fits: a
//   block zeroes it once and flushes it to the global int64 histogram with
//   64-bit atomics once at the end, or after `flush_every` tile pairs, so no
//   bin can pass 2^31 (a tile pair adds at most tile^2 to a bin). Otherwise
//   every pair adds straight into the global histogram. Integer counts are
//   exact at any n, unlike the TPU kernel's float32 slabs above 2^24.

#include "common.cuh"

namespace {

constexpr int kMaxThreads = 512;  // 2D and 3D run tile / R threads; a runtime `dim` runs `tile`

// floats per staged point record: coordinates, norm, label bits, padded to float4
__host__ __device__ constexpr int record_stride(int d) { return (d + 2 + 3) / 4 * 4; }

template <int D, int R>  // D = 0: the dimension is the runtime `dim` (then R = 1)
__global__ void __launch_bounds__(kMaxThreads) dense_pairs_kernel(
    const float* __restrict__ pts, const int32_t* __restrict__ labels, int n, int dim,
    const float* __restrict__ thr, int n_thr, int n_cls, int n_buckets,
    int tile, int n_tiles, long long n_tile_pairs, int flush_every, int shared_hist,
    unsigned long long* __restrict__ next, unsigned long long* __restrict__ stats,
    unsigned long long* __restrict__ hist_out) {
    const int d = D ? D : dim;
    const int stride = D ? record_stride(D) : d + 2;
    extern __shared__ __align__(16) float smem[];
    float* rows = smem;                                                 // (tile, stride)
    float* cols = rows + static_cast<size_t>(tile) * stride;            // (tile, stride) when D = 0
    float* sthr = cols + (D ? 0 : static_cast<size_t>(tile) * stride);  // (n_thr,)
    uint16_t* stab = reinterpret_cast<uint16_t*>(sthr + n_thr);         // (n_buckets,), n_buckets even
    uint32_t* hist = reinterpret_cast<uint32_t*>(stab + n_buckets);     // (n_thr, C * C + 1) when shared_hist
    __shared__ int s_ti, s_tj;
    const int cc = n_cls * n_cls;
    // a shared row of C * C + 1 bins: a warp's lanes share one row label, so
    // with rows of C * C (a multiple of 32 for even C) only the column label
    // would pick the bank; the extra bin lets the threshold index spread them
    const int hs = shared_hist ? cc + 1 : cc;
    const int n_bins = n_thr * hs;

    for (int k = threadIdx.x; k < n_thr; k += blockDim.x) sthr[k] = thr[k];
    if (shared_hist) {
        for (int e = threadIdx.x; e < n_bins; e += blockDim.x) hist[e] = 0;
    }
    const float thr_max = thr[n_thr - 1];
    float scale = __fdiv_rn(static_cast<float>(n_buckets), thr_max);  // buckets per unit of d2
    if (!(scale > 0.f) || scale == __int_as_float(0x7f800000)) scale = 0.f;  // then every d2 is in bucket 0
    __syncthreads();  // the thresholds are staged
    for (int b = threadIdx.x; b < n_buckets; b += blockDim.x) {
        int first = 0;  // bucket 0 holds every d2 below the first boundary, down to -inf
        if (b > 0 && scale > 0.f) {
            const float fb = static_cast<float>(b);
            float x = __fdiv_rn(fb, scale);  // a few ulps from the bucket's least x
            while (__fmul_rn(x, scale) >= fb) x = nextafterf(x, -__int_as_float(0x7f800000));
            while (__fmul_rn(x, scale) < fb) x = nextafterf(x, __int_as_float(0x7f800000));
            int hi = n_thr - 1;  // the first k with thr[k] >= x; d2 <= thr_max keeps it below n_thr
            while (first < hi) {
                const int mid = (first + hi) >> 1;
                if (sthr[mid] < x) first = mid + 1; else hi = mid;
            }
        }
        stab[b] = static_cast<uint16_t>(first);
    }
    int since_flush = 0, taken = 0, flushes = 0;  // the last two: thread 0's tallies for `stats`
    // adds bin e = k * (C * C + 1) + a * C + b of the shared histogram to the global one
    auto flush = [&]() {
        for (int e = threadIdx.x; e < n_bins; e += blockDim.x) {
            const uint32_t v = hist[e];
            if (v) {
                const int k = e / hs;
                atomicAdd(&hist_out[static_cast<size_t>(k) * cc + (e - k * hs)], static_cast<unsigned long long>(v));
                hist[e] = 0;
            }
        }
        ++flushes;
    };

    for (;;) {
        if (threadIdx.x == 0) {
            const long long p = static_cast<long long>(atomicAdd(next, 1ULL));
            int tj = -1, ti = 0;
            if (p < n_tile_pairs) {  // p -> (ti, tj), tj-major over the upper triangle
                long long t = static_cast<long long>((sqrt(8.0 * static_cast<double>(p) + 1.0) - 1.0) * 0.5);
                while (t * (t + 1) / 2 > p) --t;
                while ((t + 1) * (t + 2) / 2 <= p) ++t;
                tj = static_cast<int>(t);
                ti = static_cast<int>(p - t * (t + 1) / 2);
            }
            s_ti = ti;
            s_tj = tj;
            taken += tj >= 0;
        }
        __syncthreads();  // every thread is done with the last tile pair's staging and bins
        const int ti = s_ti, tj = s_tj;
        if (tj < 0) break;  // uniform over the block
        if (shared_hist && since_flush == flush_every) {
            flush();
            since_flush = 0;
        }
        ++since_flush;

        for (int t = threadIdx.x; t < (D ? 1 : 2) * tile; t += blockDim.x) {
            const bool row_tile = t < tile;
            const int local = row_tile ? t : t - tile;
            const long long gidx = static_cast<long long>(row_tile ? ti : tj) * tile + local;
            float* rec = (row_tile ? rows : cols) + static_cast<size_t>(local) * stride;
            int lab = -1;
            float norm = 0.f;
            if (gidx < n) {
                const float* p = pts + gidx * d;
                for (int k = 0; k < d; ++k) rec[k] = p[k];
                norm = __fmul_rn(rec[0], rec[0]);
                for (int k = 1; k < d; ++k) norm = __fadd_rn(norm, __fmul_rn(rec[k], rec[k]));
                lab = labels[gidx];
                if (lab < 0 || lab >= n_cls) lab = -1;
            }
            rec[d] = norm;
            rec[d + 1] = __int_as_float(lab);
        }

        // the thread's R column points: coordinates, norm, label, and the
        // first row it must not pair with (0 masks the column)
        float xj[R][D ? D : 1];
        float nj[R];
        int lbj[R], jlim[R];
#pragma unroll
        for (int r = 0; r < R; ++r) {
            const int j = threadIdx.x + r * blockDim.x;
            const long long gidx = static_cast<long long>(tj) * tile + j;
            int lab = -1;
            nj[r] = 0.f;
            if (D) {
#pragma unroll
                for (int k = 0; k < (D ? D : 1); ++k) xj[r][k] = 0.f;
            }
            if (gidx < n) {
                lab = labels[gidx];
                if (lab < 0 || lab >= n_cls) lab = -1;
                if (D) {
                    const float* p = pts + gidx * d;
#pragma unroll
                    for (int k = 0; k < (D ? D : 1); ++k) xj[r][k] = p[k];
                    float norm = __fmul_rn(xj[r][0], xj[r][0]);
#pragma unroll
                    for (int k = 1; k < (D ? D : 1); ++k) norm = __fadd_rn(norm, __fmul_rn(xj[r][k], xj[r][k]));
                    nj[r] = norm;
                }
            }
            lbj[r] = lab;
            jlim[r] = lab < 0 ? 0 : (ti == tj ? j : tile);
        }
        __syncthreads();
        if (!D) nj[0] = cols[static_cast<size_t>(threadIdx.x) * stride + d];

        const long long row_left = static_cast<long long>(n) - static_cast<long long>(ti) * tile;
        const int i_end = row_left < tile ? static_cast<int>(row_left) : tile;
        for (int i = 0; i < i_end; ++i) {
            const float* rec = rows + static_cast<size_t>(i) * stride;
            float xi[D ? record_stride(D) : 1];
            int la;
            float ni;
            if (D) {
#pragma unroll
                for (int q = 0; q < record_stride(D) / 4; ++q) {
                    const float4 v = reinterpret_cast<const float4*>(rec)[q];
                    xi[4 * q] = v.x;
                    xi[4 * q + 1] = v.y;
                    xi[4 * q + 2] = v.z;
                    xi[4 * q + 3] = v.w;
                }
                ni = xi[D ? D : 0];
                la = __float_as_int(xi[D ? D + 1 : 0]);
            } else {
                ni = rec[d];
                la = __float_as_int(rec[d + 1]);
            }
            if (la < 0) continue;  // uniform over the block
            const int row_bin = la * n_cls;
#pragma unroll
            for (int r = 0; r < R; ++r) {
                if (i >= jlim[r]) continue;
                float dot;
                if (D) {
                    dot = __fmul_rn(xi[0], xj[r][0]);
#pragma unroll
                    for (int k = 1; k < (D ? D : 1); ++k) dot = __fadd_rn(dot, __fmul_rn(xi[k], xj[r][k]));
                } else {
                    const float* pj = cols + static_cast<size_t>(threadIdx.x) * stride;
                    dot = __fmul_rn(rec[0], pj[0]);
                    for (int k = 1; k < d; ++k) dot = __fadd_rn(dot, __fmul_rn(rec[k], pj[k]));
                }
                const float d2 = __fsub_rn(__fadd_rn(ni, nj[r]), __fmul_rn(2.f, dot));
                if (!(d2 <= thr_max)) continue;
                int b = static_cast<int>(__fmul_rn(d2, scale));  // d2 < 0 truncates to 0
                b = b < 0 ? 0 : (b >= n_buckets ? n_buckets - 1 : b);
                int k = stab[b];  // <= the first k with d2 <= thr[k]; the walk ends at thr_max
                while (sthr[k] < d2) ++k;
                const int e = k * hs + row_bin + lbj[r];
                if (shared_hist) {
                    atomicAdd(&hist[e], 1u);
                } else {
                    atomicAdd(&hist_out[e], 1ULL);
                }
            }
        }
    }

    if (shared_hist) flush();  // every thread passed the last __syncthreads after its last pair
    if (threadIdx.x == 0) {
        atomicAdd(&stats[0], static_cast<unsigned long long>(flushes));
        atomicMax(&stats[1], static_cast<unsigned long long>(taken));
        if (blockIdx.x == 0) stats[2] = gridDim.x;
    }
}

__global__ void cumulate_kernel(const long long* __restrict__ hist, int n_thr, int n_cls, long long* __restrict__ out) {
    const int e = blockIdx.x * blockDim.x + threadIdx.x;
    const int cc = n_cls * n_cls;
    if (e >= cc) return;
    const int a = e / n_cls;
    const int b = e % n_cls;
    long long run = 0;
    for (int k = 0; k < n_thr; ++k) {
        run += hist[static_cast<size_t>(k) * cc + a * n_cls + b] + hist[static_cast<size_t>(k) * cc + b * n_cls + a];
        out[static_cast<size_t>(k) * cc + e] = run;
    }
}

template <int D, int R>
cudaError_t launch(const float* pts, const int32_t* labels, int n, int dim, const float* thr, int n_thr, int n_cls,
                   int n_buckets, int tile, int blocks, int flush_every, int shared_hist,
                   unsigned long long* next, unsigned long long* hist, cudaStream_t s) {
    unsigned long long* stats = next + 1;
    const int threads = tile / R;
    if (tile % R || threads % 32 || threads > kMaxThreads || (!D && R != 1)) return cudaErrorInvalidValue;
    const int stride = D ? record_stride(D) : dim + 2;
    size_t smem = ((D ? 1 : 2) * static_cast<size_t>(tile) * stride + n_thr) * sizeof(float) +
                  static_cast<size_t>(n_buckets) * sizeof(uint16_t);
    if (shared_hist) smem += static_cast<size_t>(n_thr) * (n_cls * n_cls + 1) * sizeof(uint32_t);
    cudaError_t err = sqt_allow_smem(dense_pairs_kernel<D, R>, smem);
    if (err != cudaSuccess) return err;
    // persistent blocks: no more than stay resident at once, registers included
    int per_sm = 0, dev = 0, n_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, dense_pairs_kernel<D, R>, threads, smem);
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    if (blocks > per_sm * n_sm) blocks = per_sm * n_sm;
    const int n_tiles = (n + tile - 1) / tile;
    const long long n_tile_pairs = static_cast<long long>(n_tiles) * (n_tiles + 1) / 2;
    dense_pairs_kernel<D, R><<<blocks, threads, smem, s>>>(pts, labels, n, dim, thr, n_thr, n_cls, n_buckets,
                                                            tile, n_tiles, n_tile_pairs, flush_every, shared_hist,
                                                            next, stats, hist);
    return cudaGetLastError();
}

}  // namespace

// pts (n, dim) float32; labels (n,) int32; thr (n_thr,) float32 ascending;
// n_buckets (even) buckets of the threshold table; tile = threads x reg; at
// most `blocks` persistent blocks (fewer if fewer stay resident); a shared
// histogram is flushed at least every `flush_every` tile pairs; hist a zeroed
// (n_thr * C * C + 4) int64 scratch whose last four elements are the
// tile-pair counter, the number of flushes, the most tile pairs one block
// took and the blocks launched; out (n_thr, C, C) int64.
SQT_EXPORT int sqt_dense_pairs(const float* pts, const int32_t* labels, int n, int dim, const float* thr, int n_thr,
                               int n_cls, int n_buckets, int tile, int reg, int blocks,
                               int flush_every, int shared_hist, long long* hist, long long* out, void* stream) {
    if (n <= 0 || dim <= 0 || n_thr <= 0 || n_cls <= 0 || tile <= 0 || blocks <= 0 || flush_every <= 0 ||
        n_buckets <= 0 || n_buckets % 2 || n_thr > 65535) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    auto* h = reinterpret_cast<unsigned long long*>(hist);
    unsigned long long* next = h + static_cast<size_t>(n_thr) * n_cls * n_cls;
    cudaError_t err = cudaErrorInvalidValue;
#define SQT_K2_ARGS pts, labels, n, dim, thr, n_thr, n_cls, n_buckets, tile, blocks, flush_every, shared_hist, \
                    next, h, s
    if (dim == 2 && reg == 1) err = launch<2, 1>(SQT_K2_ARGS);
    else if (dim == 2 && reg == 2) err = launch<2, 2>(SQT_K2_ARGS);
    else if (dim == 3 && reg == 1) err = launch<3, 1>(SQT_K2_ARGS);
    else if (dim == 3 && reg == 2) err = launch<3, 2>(SQT_K2_ARGS);
    else if (dim != 2 && dim != 3 && reg == 1) err = launch<0, 1>(SQT_K2_ARGS);
#undef SQT_K2_ARGS
    if (err != cudaSuccess) return static_cast<int>(err);
    const int cc = n_cls * n_cls;
    cumulate_kernel<<<(cc + 255) / 256, 256, 0, s>>>(hist, n_thr, n_cls, out);
    return static_cast<int>(cudaGetLastError());
}
