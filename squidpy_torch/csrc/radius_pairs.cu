// K6: every pair of points within a radius, as CSR rows with distances.
//
// Replaces squidpy_tpu/ops/knn.py `radius_neighbors` (line 408): there XLA
// computes a (2048, n) float32 block of difference-form squared distances a
// row tile, each block is copied to the host, and a Python loop over its rows
// keeps the columns with d2 <= r2. That is O(n^2) work and n^2 * 4 bytes of
// device-to-host copies: about 4 TB at 1M cells.
//
// Bound on the card: bytes. The output is (nnz + n) * 8 bytes when each row
// holds its diagonal (`with_self`), nnz * 8 without (an int32 column and a
// float32 distance an edge), plus the (n + 1) int64 row offsets, and the
// coordinates are read once. The tests are few: a point meets the points of
// the 3^min(d,3) grid cells around its own, about 56 at the main path's shape
// (1M cells, ~10 um apart, r = 25), each 3d float operations, so ~2e8
// operations in all, microseconds at the float32 rate.
//
// Design: everything runs on the card, and the host reads the card twice.
// 1. The grid. `bounds_kernel` reduces the finite-row count and each gridded
//    axis's min and max (order-preserving int keys, warp-reduced, one atomic
//    a warp); the wrapper reads these few scalars back (sync 1) and computes
//    the cell side and the cells along each axis on the host. `bin_kernel`
//    gives each point its cell in float64 (a point with a non-finite gridded
//    coordinate gets the extra cell nx * ny * nz, walked by no one) and
//    counts the cells with atomics; the wrapper scans the counts, and
//    `scatter_kernel` places each point at its cell's next free slot by an
//    atomic cursor: a counting sort. The order of points inside a cell does
//    not matter, since each row is put in order at the end.
// 2. The count and fill passes. One thread takes one sorted point. The count
//    pass writes each row's number of neighbours (plus its diagonal under
//    `with_self`, for a point with no cell too), appends the rows longer
//    than a warp's sort to one list (one atomic a warp) and keeps the
//    longest row. The wrapper scans the counts into the row offsets and
//    reads the edge count with the list's size and longest row (sync 2).
//    The fill pass computes the same tests again and writes each accepted
//    column and distance at its row's offset; where it meets its own point
//    (`s == t`) it writes the diagonal, column = row and distance 0.0, under
//    `with_self`. The three cells of one grid row along x are consecutive in
//    the sort, so a point reads 3^(G-1) contiguous ranges of candidates, and
//    the threads of a warp, which hold points of one or two cells, read the
//    same ranges: the candidates come from L1 as broadcasts. d2 is the
//    difference form in axis order, each subtraction, multiply and add
//    rounded on its own (`__fsub_rn`, `__fmul_rn`, `__fadd_rn`, which no
//    contraction can fuse), the test is `d2 <= r2` with the same float32 r2,
//    and a distance is `sqrtf(d2)`, correctly rounded (no fast math): every
//    output is bitwise equal to the plain torch version.
// 3. The row order, in each row's own slot range, by (column, distance)
//    pairs with distinct columns. Rows of up to 64 entries: one warp a row, a
//    bitonic sort in registers (two entries a lane, `__shfl_xor_sync`), which
//    holds nearly every row of the main path (mean 19.6, longest 48). The
//    listed longer rows: one block a chunk, a bitonic sort in shared memory,
//    the chunk the list's longest row rounded up to a power of two, at most
//    the block limit (16,384 entries, 128 KB), so a row up to that limit is
//    one chunk and is done. Longer rows then go through rounds of merges in
//    global memory (a merge path split a thread, 8 outputs each), ping-ponging
//    with a scratch copy; each row takes only the rounds its own length
//    needs, its chunks written where its last round ends in place. Once a row
//    passes the block limit, every listed row's block holds the full 128 KB
//    (fewer blocks an SM); no row of the main path is listed at all. A row of
//    any length ends in order at O(len log len) cost.

#include <climits>
#include <cmath>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarpRowMax = 64;       // the warp tier: two entries a lane
constexpr int kBlockRowMax = 16384;   // the block tier: int32 column + float32 distance = 128 KB of shared memory
constexpr int kSortThreads = 512;
constexpr int kMergePerThread = 8;
constexpr int kMergeTile = kThreads * kMergePerThread;
constexpr unsigned kFull = 0xffffffffu;

// an int that orders as the float does (for atomicMin/atomicMax), and back on the host
__device__ __forceinline__ int float_key(float f) {
    const int i = __float_as_int(f);
    return i >= 0 ? i : i ^ 0x7fffffff;
}

// bounds[0:3] min keys, bounds[3:6] max keys, bounds[6] the rows whose first g coordinates are finite
__global__ void bounds_init(int* __restrict__ bounds) {
    if (threadIdx.x < 3) {
        bounds[threadIdx.x] = INT_MAX;
        bounds[3 + threadIdx.x] = INT_MIN;
    }
    if (threadIdx.x == 0) bounds[6] = 0;
}

__global__ void __launch_bounds__(kThreads) bounds_kernel(const float* __restrict__ x, int64_t n, int d, int g,
                                                          int* __restrict__ bounds) {
    float lo[3] = {INFINITY, INFINITY, INFINITY}, hi[3] = {-INFINITY, -INFINITY, -INFINITY};
    int count = 0;
    const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
    for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; i < n; i += stride) {
        float v[3] = {0.0f, 0.0f, 0.0f};
        bool finite = true;
        for (int a = 0; a < g; ++a) {
            v[a] = __ldg(x + i * d + a);
            finite = finite && isfinite(v[a]);
        }
        if (finite) {
            for (int a = 0; a < g; ++a) {
                lo[a] = fminf(lo[a], v[a]);
                hi[a] = fmaxf(hi[a], v[a]);
            }
            ++count;
        }
    }
    for (int off = 16; off > 0; off >>= 1) {
        count += __shfl_xor_sync(kFull, count, off);
        for (int a = 0; a < 3; ++a) {
            lo[a] = fminf(lo[a], __shfl_xor_sync(kFull, lo[a], off));
            hi[a] = fmaxf(hi[a], __shfl_xor_sync(kFull, hi[a], off));
        }
    }
    if ((threadIdx.x & 31) == 0 && count > 0) {
        for (int a = 0; a < g; ++a) {
            atomicMin(bounds + a, float_key(lo[a]));
            atomicMax(bounds + 3 + a, float_key(hi[a]));
        }
        atomicAdd(bounds + 6, count);
    }
}

// Each point's cell, as the plain version bins it: floor((x - lo) / side) in
// float64, clamped to [0, dims - 1], on the first g axes; the extra cell
// nx * ny * nz for a point with a non-finite gridded coordinate; cell 0 for
// every point when `one_cell` (an infinite r2, or no gridded axis).
__global__ void __launch_bounds__(kThreads) bin_kernel(const float* __restrict__ x, int64_t n, int d, int g,
                                                       double lo0, double lo1, double lo2, double side, int nx,
                                                       int ny, int nz, int one_cell, int32_t* __restrict__ cell,
                                                       int32_t* __restrict__ cell_count) {
    const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
    if (i >= n) return;
    int32_t c = 0;
    if (!one_cell) {
        const double lo[3] = {lo0, lo1, lo2};
        const int dims[3] = {nx, ny, nz};
        int64_t q[3] = {0, 0, 0};
        bool finite = true;
        for (int a = 0; a < g; ++a) {
            const float v = __ldg(x + i * d + a);
            finite = finite && isfinite(v);
            if (finite) {
                const int64_t k = static_cast<int64_t>(floor(__ddiv_rn(__dsub_rn(static_cast<double>(v), lo[a]),
                                                                       side)));
                q[a] = k < 0 ? 0 : (k > dims[a] - 1 ? dims[a] - 1 : k);
            }
        }
        c = finite ? static_cast<int32_t>((q[2] * ny + q[1]) * nx + q[0]) : nx * ny * nz;
    }
    cell[i] = c;
    atomicAdd(cell_count + c, 1);
}

// The counting sort's scatter: each point to its cell's next free slot.
__global__ void __launch_bounds__(kThreads) scatter_kernel(const float* __restrict__ x, int64_t n, int d,
                                                           const int32_t* __restrict__ cell,
                                                           int32_t* __restrict__ cursor, float* __restrict__ pts,
                                                           int32_t* __restrict__ orig,
                                                           int32_t* __restrict__ cell_sorted) {
    const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
    if (i >= n) return;
    const int32_t c = __ldg(cell + i);
    const int64_t slot = atomicAdd(cursor + c, 1);
    orig[slot] = static_cast<int32_t>(i);
    cell_sorted[slot] = c;
    for (int a = 0; a < d; ++a) pts[slot * d + a] = __ldg(x + i * d + a);
}

// kD = d for d <= 3, the point's coordinates held in registers; 0 for any d,
// read from memory on every test
template <int kD>
__device__ __forceinline__ float sq_dist(const float* __restrict__ pts, int d, const float (&p)[kD > 0 ? kD : 1],
                                         const float* __restrict__ own, int64_t s) {
    float d2 = 0.0f;
    if constexpr (kD > 0) {
        const float* q = pts + s * kD;
#pragma unroll
        for (int a = 0; a < kD; ++a) {
            const float diff = __fsub_rn(p[a], __ldg(q + a));
            const float sq = __fmul_rn(diff, diff);
            d2 = a == 0 ? sq : __fadd_rn(d2, sq);
        }
    } else {
        const float* q = pts + s * d;
        for (int a = 0; a < d; ++a) {
            const float diff = __fsub_rn(__ldg(own + a), __ldg(q + a));
            d2 = __fadd_rn(d2, __fmul_rn(diff, diff));  // 0 + sq == sq: the same sum as the plain version
        }
    }
    return d2;
}

struct Tiers {
    int32_t* rows;   // the rows longer than warp_lim
    int32_t* sizes;  // [their number, the longest of them]
    int warp_lim;
};

// Append `row` to `list` where `take` holds, one atomic a warp.
__device__ __forceinline__ void append(bool take, int32_t row, int32_t* __restrict__ list, int32_t* __restrict__ size) {
    const unsigned mask = __ballot_sync(kFull, take);
    if (!mask) return;
    const int lane = threadIdx.x & 31, leader = __ffs(mask) - 1;
    int base = 0;
    if (lane == leader) base = atomicAdd(size, __popc(mask));
    base = __shfl_sync(kFull, base, leader);
    if (take) list[base + __popc(mask & ((1u << lane) - 1u))] = row;
}

// One thread a sorted point t: its row is orig[t], its cell cell[t] in a grid
// of nx x ny x nz cells whose points are pts[cell_start[c] : cell_start[c + 1]]
// (c = (z * ny + y) * nx + x; the extra cell nx * ny * nz holds the points
// with no cell, which meet no one). kFill = false writes counts[row] and the
// tiers; kFill = true writes the row's columns and distances from
// out_idx[indptr[row]] on.
template <int kD, bool kFill>
__global__ void __launch_bounds__(kThreads) pairs_kernel(const float* __restrict__ pts, int d,
                                                         const int32_t* __restrict__ orig,
                                                         const int32_t* __restrict__ cell,
                                                         const int32_t* __restrict__ cell_start, int64_t n, int nx,
                                                         int ny, int nz, float r2, int with_self,
                                                         int32_t* __restrict__ counts, Tiers tiers,
                                                         const int64_t* __restrict__ indptr,
                                                         int32_t* __restrict__ out_idx, float* __restrict__ out_dist) {
    const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
    const bool active = t < n;  // no early return: the count pass's warps vote
    int32_t row = 0, cnt = 0;
    if (active) {
        row = __ldg(orig + t);
        const int32_t c = __ldg(cell + t);
        int64_t out = 0;
        if constexpr (kFill) out = __ldg(indptr + row);
        if (c < static_cast<int64_t>(nx) * ny * nz) {
            const int cx = c % nx, cy = (c / nx) % ny, cz = c / (nx * ny);
            float p[kD > 0 ? kD : 1];
            if constexpr (kD > 0) {
#pragma unroll
                for (int a = 0; a < kD; ++a) p[a] = __ldg(pts + t * kD + a);
            }
            const float* own = pts + t * d;
            const int x0 = cx > 0 ? cx - 1 : 0, x1 = cx + 1 < nx ? cx + 1 : nx - 1;
            for (int z = cz > 0 ? cz - 1 : 0; z <= cz + 1 && z < nz; ++z) {
                for (int y = cy > 0 ? cy - 1 : 0; y <= cy + 1 && y < ny; ++y) {
                    const int64_t base = (static_cast<int64_t>(z) * ny + y) * nx;
                    const int64_t s1 = __ldg(cell_start + base + x1 + 1);
                    for (int64_t s = __ldg(cell_start + base + x0); s < s1; ++s) {
                        if (s == t) {
                            if (with_self) {
                                if constexpr (kFill) {
                                    out_idx[out + cnt] = row;
                                    out_dist[out + cnt] = 0.0f;
                                }
                                ++cnt;
                            }
                            continue;
                        }
                        const float d2 = sq_dist<kD>(pts, d, p, own, s);
                        if (d2 <= r2) {
                            if constexpr (kFill) {
                                out_idx[out + cnt] = __ldg(orig + s);
                                out_dist[out + cnt] = sqrtf(d2);
                            }
                            ++cnt;
                        }
                    }
                }
            }
        } else if (with_self) {
            if constexpr (kFill) {
                out_idx[out] = row;
                out_dist[out] = 0.0f;
            }
            cnt = 1;
        }
        if constexpr (!kFill) counts[row] = cnt;
    }
    if constexpr (!kFill) {
        append(active && cnt > tiers.warp_lim, row, tiers.rows, tiers.sizes);
        const int longest = __reduce_max_sync(kFull, active ? cnt : 0);
        if ((threadIdx.x & 31) == 0 && longest > tiers.warp_lim) atomicMax(tiers.sizes + 1, longest);
    }
}

// -- the row order ------------------------------------------------------------

// one compare-exchange step of a bitonic network held a lane an entry: the
// entry at e (partner e ^ j) ends as the min of the two where `keep_min`
__device__ __forceinline__ void exchange(int32_t& k, float& v, int j, bool keep_min) {
    const int32_t pk = __shfl_xor_sync(kFull, k, j);
    const float pv = __shfl_xor_sync(kFull, v, j);
    if (keep_min ? pk < k : pk > k) {
        k = pk;
        v = pv;
    }
}

// Rows of 2..warp_lim entries (warp_lim <= 64): one warp a row. Entry e of the
// row sits in lane e % 32, register e / 32; pads are INT_MAX. Columns are
// distinct in a row, so the order is unique.
__global__ void __launch_bounds__(kThreads) order_warp_kernel(const int64_t* __restrict__ indptr, int64_t n,
                                                              int32_t* __restrict__ idx, float* __restrict__ dist,
                                                              int warp_lim) {
    const int lane = threadIdx.x & 31;
    const int64_t warps = static_cast<int64_t>(gridDim.x) * (kThreads / 32);
    for (int64_t row = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) / 32; row < n; row += warps) {
        const int64_t beg = __ldg(indptr + row);
        const int64_t len = __ldg(indptr + row + 1) - beg;
        if (len < 2 || len > warp_lim) continue;
        int32_t k0 = lane < len ? idx[beg + lane] : INT_MAX, k1 = lane + 32 < len ? idx[beg + lane + 32] : INT_MAX;
        float v0 = lane < len ? dist[beg + lane] : 0.0f, v1 = lane + 32 < len ? dist[beg + lane + 32] : 0.0f;
        const int size = len <= 32 ? 32 : 64;
        for (int k = 2; k <= size; k <<= 1) {
            for (int j = k >> 1; j > 0; j >>= 1) {
                if (j == 32) {  // k == 64: the partner of entry lane is entry lane + 32, ascending
                    if (k1 < k0) {
                        const int32_t tk = k0;
                        k0 = k1;
                        k1 = tk;
                        const float tv = v0;
                        v0 = v1;
                        v1 = tv;
                    }
                    continue;
                }
                const bool lower = (lane & j) == 0;
                exchange(k0, v0, j, lower == ((lane & k) == 0));
                if (size == 64) exchange(k1, v1, j, lower == (((lane + 32) & k) == 0));
            }
        }
        if (lane < len) {
            idx[beg + lane] = k0;
            dist[beg + lane] = v0;
        }
        if (lane + 32 < len) {
            idx[beg + lane + 32] = k1;
            dist[beg + lane + 32] = v1;
        }
    }
}

// The merge rounds a row of `len` entries takes after its chunk sort: runs
// of chunk, 2 chunk, ... entries until one run holds the row.
__device__ __forceinline__ int merge_rounds(int64_t len, int64_t chunk) {
    int rounds = 0;
    for (int64_t w = chunk; w < len; w *= 2) ++rounds;
    return rounds;
}

// One block a (row, chunk): entries [chunk * blockIdx.y, + chunk) of row
// rows[blockIdx.x], read from idx/dist, sorted in shared memory by a bitonic
// network padded to a power of two, and written at the same positions: to
// idx/dist if the row's merge rounds are even in number (none: the row was
// one chunk and is done), else to tmp, so the last round ends in idx/dist.
__global__ void __launch_bounds__(kSortThreads) order_block_kernel(const int64_t* __restrict__ indptr,
                                                                   const int32_t* __restrict__ rows, int chunk,
                                                                   int32_t* idx, float* dist, int32_t* tmp_idx,
                                                                   float* tmp_dist) {
    extern __shared__ int32_t smem[];
    const int32_t row = __ldg(rows + blockIdx.x);
    const int64_t row_beg = __ldg(indptr + row), row_len = __ldg(indptr + row + 1) - row_beg;
    const int64_t off = static_cast<int64_t>(blockIdx.y) * chunk;
    if (off >= row_len) return;
    const int len = static_cast<int>(row_len - off < chunk ? row_len - off : chunk);
    const int64_t beg = row_beg + off;
    const bool to_tmp = merge_rounds(row_len, chunk) % 2 == 1;
    int32_t* dst_idx = to_tmp ? tmp_idx : idx;
    float* dst_dist = to_tmp ? tmp_dist : dist;
    int size = 1;
    while (size < len) size <<= 1;
    int32_t* keys = smem;
    float* vals = reinterpret_cast<float*>(smem + chunk);
    for (int i = threadIdx.x; i < size; i += kSortThreads) {
        keys[i] = i < len ? idx[beg + i] : INT_MAX;
        vals[i] = i < len ? dist[beg + i] : 0.0f;
    }
    __syncthreads();
    for (int k = 2; k <= size; k <<= 1) {
        for (int j = k >> 1; j > 0; j >>= 1) {
            for (int p = threadIdx.x; p < size / 2; p += kSortThreads) {
                const int i = ((p & ~(j - 1)) << 1) | (p & (j - 1)), l = i | j;  // i has bit j clear
                const bool up = (i & k) == 0;
                if ((keys[i] > keys[l]) == up) {
                    const int32_t tk = keys[i];
                    keys[i] = keys[l];
                    keys[l] = tk;
                    const float tv = vals[i];
                    vals[i] = vals[l];
                    vals[l] = tv;
                }
            }
            __syncthreads();
        }
    }
    for (int i = threadIdx.x; i < len; i += kSortThreads) {
        dst_idx[beg + i] = keys[i];
        dst_dist[beg + i] = vals[i];
    }
}

// One merge round at run width `width` (chunk * 2^k): each listed row longer
// than `width` has its sorted runs merged in pairs into runs of 2 * width (a
// run without a partner is copied), between idx/dist and tmp in the direction
// that ends its last round in idx/dist; a row no longer than `width` is done.
// Block (rows[blockIdx.x], blockIdx.y) writes kMergeTile outputs, each thread
// kMergePerThread of them after a merge-path search for its first. Columns
// are distinct in a row.
__global__ void __launch_bounds__(kThreads) merge_kernel(const int64_t* __restrict__ indptr,
                                                         const int32_t* __restrict__ rows, int64_t chunk,
                                                         int64_t width, int32_t* idx, float* dist, int32_t* tmp_idx,
                                                         float* tmp_dist) {
    const int32_t row = __ldg(rows + blockIdx.x);
    const int64_t beg = __ldg(indptr + row), len = __ldg(indptr + row + 1) - beg;
    const int64_t p0 = static_cast<int64_t>(blockIdx.y) * kMergeTile + threadIdx.x * kMergePerThread;
    if (len <= width || p0 >= len) return;
    // this is round merge_rounds(width) + 1 of the row's merge_rounds(len);
    // within a launch each address is only read or only written
    const bool to_idx = (merge_rounds(len, chunk) - merge_rounds(width, chunk)) % 2 == 1;
    const int32_t* src_idx = to_idx ? tmp_idx : idx;
    const float* src_dist = to_idx ? tmp_dist : dist;
    int32_t* dst_idx = to_idx ? idx : tmp_idx;
    float* dst_dist = to_idx ? dist : tmp_dist;
    const int64_t pair = p0 / (2 * width) * (2 * width);  // 2 * width is a multiple of kMergePerThread
    const int64_t na = (len - pair < width ? len - pair : width);
    const int64_t nb = (len - pair - na < width ? len - pair - na : width);
    const int32_t* a = src_idx + beg + pair;
    const int32_t* b = a + na;
    const int64_t q = p0 - pair;
    int64_t lo = q > nb ? q - nb : 0, hi = q < na ? q : na;
    while (lo < hi) {  // the first i with a[i] > b[q - i - 1]: a[:i] and b[:q - i] are the q smallest
        const int64_t mid = (lo + hi) / 2;
        if (__ldg(a + mid) < __ldg(b + q - mid - 1))
            lo = mid + 1;
        else
            hi = mid;
    }
    int64_t i = lo, j = q - lo;
    const int64_t end = p0 + kMergePerThread < pair + na + nb ? p0 + kMergePerThread : pair + na + nb;
    for (int64_t p = p0; p < end; ++p) {
        const bool from_a = i < na && (j >= nb || __ldg(a + i) < __ldg(b + j));
        const int64_t s = from_a ? pair + i++ : pair + na + j++;
        dst_idx[beg + p] = __ldg(src_idx + beg + s);
        dst_dist[beg + p] = __ldg(src_dist + beg + s);
    }
}

template <int kD>
int launch_pairs(bool fill, const float* pts, int d, const int32_t* orig, const int32_t* cell,
                 const int32_t* cell_start, int64_t n, int nx, int ny, int nz, float r2, int with_self,
                 int32_t* counts, Tiers tiers, const int64_t* indptr, int32_t* out_idx, float* out_dist,
                 cudaStream_t s) {
    const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
    if (fill)
        pairs_kernel<kD, true><<<blocks, kThreads, 0, s>>>(pts, d, orig, cell, cell_start, n, nx, ny, nz, r2,
                                                           with_self, counts, tiers, indptr, out_idx, out_dist);
    else
        pairs_kernel<kD, false><<<blocks, kThreads, 0, s>>>(pts, d, orig, cell, cell_start, n, nx, ny, nz, r2,
                                                            with_self, counts, tiers, indptr, out_idx, out_dist);
    return static_cast<int>(cudaGetLastError());
}

bool too_many_blocks(int64_t n) { return (n + kThreads - 1) / kThreads > 0x7FFFFFFF; }

}  // namespace

// `x`: (n, d) float32 points; `bounds`: int32[7] (see bounds_init). The host
// decodes the keys: k >= 0 ? k : k ^ 0x7fffffff is the float's bit pattern.
SQT_EXPORT int sqt_radius_bounds(const float* x, int64_t n, int d, int g, int32_t* bounds, void* stream) {
    if (d < 0 || g < 0 || g > 3 || g > d || too_many_blocks(n)) return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    bounds_init<<<1, 32, 0, s>>>(bounds);
    const int64_t need = (n + kThreads - 1) / kThreads;
    const unsigned blocks = static_cast<unsigned>(need < 132 * 8 ? (need > 0 ? need : 1) : 132 * 8);
    bounds_kernel<<<blocks, kThreads, 0, s>>>(x, n, d, g, bounds);
    return static_cast<int>(cudaGetLastError());
}

// Each point's cell into `cell` (n,) and the cells' counts into `cell_count`
// (nx * ny * nz + 1,), which the caller zeroed.
SQT_EXPORT int sqt_radius_bin(const float* x, int64_t n, int d, int g, double lo0, double lo1, double lo2,
                              double side, int nx, int ny, int nz, int one_cell, int32_t* cell, int32_t* cell_count,
                              void* stream) {
    if (n == 0) return 0;
    if (d < 0 || g < 0 || g > 3 || g > d || nx < 1 || ny < 1 || nz < 1 ||
        static_cast<int64_t>(nx) * ny * nz >= INT_MAX || too_many_blocks(n))
        return static_cast<int>(cudaErrorInvalidValue);
    const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
    bin_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(x, n, d, g, lo0, lo1, lo2, side, nx, ny,
                                                                          nz, one_cell, cell, cell_count);
    return static_cast<int>(cudaGetLastError());
}

// `cursor`: each cell's first slot (cell_start without its last entry), advanced here.
SQT_EXPORT int sqt_radius_scatter(const float* x, int64_t n, int d, const int32_t* cell, int32_t* cursor, float* pts,
                                  int32_t* orig, int32_t* cell_sorted, void* stream) {
    if (n == 0) return 0;
    if (d < 0 || too_many_blocks(n)) return static_cast<int>(cudaErrorInvalidValue);
    const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
    scatter_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(x, n, d, cell, cursor, pts, orig,
                                                                              cell_sorted);
    return static_cast<int>(cudaGetLastError());
}

// `pts`: (n, d) float32 points sorted by cell; `orig`: (n,) their rows;
// `cell`: (n,) their cells; `cell_start`: (nx * ny * nz + 2,) int32 offsets of
// each cell's points (the last cell: the points with no cell).
// fill = 0 writes `counts` (n,) int32, the (n,) int32 list `long_rows` of the
// rows longer than `warp_lim`, and `tier_sizes` int32[2] (zeroed by the
// caller): the list's length and its longest row. fill = 1 writes
// `out_idx`/`out_dist` from `indptr` (n + 1,) on, each row in no particular
// order.
SQT_EXPORT int sqt_radius_pairs(const float* pts, int d, const int32_t* orig, const int32_t* cell,
                                const int32_t* cell_start, int64_t n, int nx, int ny, int nz, float r2, int with_self,
                                int32_t* counts, int32_t* long_rows, int32_t* tier_sizes, int warp_lim,
                                const int64_t* indptr, int32_t* out_idx, float* out_dist, int fill, void* stream) {
    if (n == 0) return 0;
    if (d < 0 || nx < 1 || ny < 1 || nz < 1 || too_many_blocks(n)) return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const bool f = fill != 0;
    const Tiers tiers{long_rows, tier_sizes, warp_lim};
    switch (d) {
        case 1: return launch_pairs<1>(f, pts, d, orig, cell, cell_start, n, nx, ny, nz, r2, with_self, counts, tiers,
                                       indptr, out_idx, out_dist, s);
        case 2: return launch_pairs<2>(f, pts, d, orig, cell, cell_start, n, nx, ny, nz, r2, with_self, counts, tiers,
                                       indptr, out_idx, out_dist, s);
        case 3: return launch_pairs<3>(f, pts, d, orig, cell, cell_start, n, nx, ny, nz, r2, with_self, counts, tiers,
                                       indptr, out_idx, out_dist, s);
        default: return launch_pairs<0>(f, pts, d, orig, cell, cell_start, n, nx, ny, nz, r2, with_self, counts,
                                        tiers, indptr, out_idx, out_dist, s);
    }
}

// Each row's entries ascending by column, in place: the warp tier over every
// row, then the rows `long_rows[:n_long]` (longer than `warp_lim`, the
// longest of them `longest`) in chunks of min(the power of two >= longest,
// block_lim), then merge rounds through `tmp_idx`/`tmp_dist`, which must be
// as long as `idx` when longest > block_lim. warp_lim <= 64; block_lim a
// power of two, max(warp_lim, 4) <= block_lim <= 16384 (a merge pair's 2 *
// block_lim outputs are whole threads' shares).
SQT_EXPORT int sqt_radius_order(const int64_t* indptr, int64_t n, int32_t* idx, float* dist, int32_t* tmp_idx,
                                float* tmp_dist, const int32_t* long_rows, int64_t n_long, int64_t longest,
                                int warp_lim, int block_lim, void* stream) {
    if (warp_lim < 1 || warp_lim > kWarpRowMax || block_lim < warp_lim || block_lim < kMergePerThread / 2 ||
        block_lim > kBlockRowMax || (block_lim & (block_lim - 1)) != 0 || n_long > 0x7FFFFFFF)
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (n > 0) {
        const int64_t need = (n * 32 + kThreads - 1) / kThreads;
        const unsigned blocks = static_cast<unsigned>(need < 132 * 64 ? need : 132 * 64);
        order_warp_kernel<<<blocks, kThreads, 0, s>>>(indptr, n, idx, dist, warp_lim);
    }
    if (n_long > 0) {
        int chunk = 1;
        while (chunk < longest && chunk < block_lim) chunk <<= 1;
        const int64_t chunks = (longest + chunk - 1) / chunk;
        const int64_t tiles = (longest + kMergeTile - 1) / kMergeTile;
        if (chunks > 65535 || tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
        const size_t smem = static_cast<size_t>(chunk) * 8;
        cudaError_t err = sqt_allow_smem(order_block_kernel, smem);
        if (err != cudaSuccess) return static_cast<int>(err);
        const unsigned rows = static_cast<unsigned>(n_long);
        order_block_kernel<<<dim3(rows, static_cast<unsigned>(chunks)), kSortThreads, smem, s>>>(
            indptr, long_rows, chunk, idx, dist, tmp_idx, tmp_dist);
        for (int64_t w = chunk; w < longest; w *= 2)
            merge_kernel<<<dim3(rows, static_cast<unsigned>(tiles)), kThreads, 0, s>>>(indptr, long_rows, chunk, w,
                                                                                       idx, dist, tmp_idx, tmp_dist);
    }
    return static_cast<int>(cudaGetLastError());
}
